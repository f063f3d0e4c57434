"""The work counters against ``torch.utils.flop_counter.FlopCounterMode``
on the reference at the tiny widths, and each op's bytes against its
shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.kinds import text2img22 as t2i
from bench_h100.kinds import train_unclip21 as train
from bench_h100.reference.models import build21, build22
from bench_h100.reference.train21 import trainable
from bench_h100.reference.unet22 import AddedKVAttention
from bench_h100.work.counter import BF16, Work, counting

from .common import load


def flop_counter(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _inputs22(cfg, name, B=2):
    g = torch.Generator().manual_seed(0)
    te, D = cfg["text_encoder"], cfg["prior"]["embedding_dim"]
    L = te["max_position_embeddings"]
    return {
        "text_encoder": (torch.randint(1, 60, (B, L), generator=g),),
        "image_encoder": (torch.randn(B, 28, 28, 3, generator=g),),
        "prior": (torch.randn(B, D, generator=g), torch.full((B,), 7.0),
                  torch.randn(B, D, generator=g), torch.randn(B, L, te["hidden_size"], generator=g),
                  torch.ones(B, L, dtype=torch.bool)),
        "unet": (torch.randn(B, 8, 8, 4, generator=g), torch.full((B,), 7.0),
                 torch.randn(B, 32, generator=g)),
    }[name]


@pytest.mark.parametrize("name", ["text_encoder", "image_encoder", "prior", "unet",
                                  "movq.decode", "movq.encode"])
def test_forward_flops_22(name):
    cfg = load("tiny22.json")
    models = build22(cfg)
    model, _, method = name.partition(".")
    m = models[model]
    if method == "decode":
        args = (torch.randn(2, 8, 8, 4),)
    elif method == "encode":
        args = (torch.randn(2, 64, 64, 3),)
    else:
        args = _inputs22(cfg, model)
    fn = getattr(m, method) if method else m
    with torch.no_grad(), counting(m) as w:
        fn(*args)
    with torch.no_grad():
        assert w.flops == flop_counter(lambda: fn(*args))


@pytest.mark.parametrize("name", ["text_encoder", "clip_vision"])
def test_forward_flops_21_towers(name):
    cfg = load("tiny21.json")
    m = build21(cfg)[name]
    args = ((torch.randint(5, 100, (2, 8)), torch.ones(2, 8, dtype=torch.long))
            if name == "text_encoder" else (torch.randn(2, 28, 28, 3),))
    with torch.no_grad(), counting(m) as w:
        m(*args)
    with torch.no_grad():
        assert w.flops == flop_counter(lambda: m(*args))


def test_train_step_flops_21():
    """Forward and backward of the UNet21 with the decoder's freeze mask:
    input gradients through every layer past the first, weight gradients
    of the trainable tensors."""
    cfg = load("tiny21.json")
    unet = build21(cfg)["unet"]
    for n, p in unet.named_parameters():
        p.requires_grad_(trainable(n, **cfg["freeze"]))
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 4, 4, 4, generator=g), torch.full((2,), 5.0),
            torch.randn(2, 8, 32, generator=g), torch.randn(2, 16, generator=g),
            torch.randn(2, 16, generator=g))
    with counting(unet, grad=True) as w:
        unet(*args)
    assert w.flops == flop_counter(lambda: unet(*args).sum().backward())


def test_cell_work_adds_the_models_of_a_call():
    cfg, tr = load("tiny22.json"), load("tiny-t2i.json")
    w = t2i.Cell(cfg, tr, 0, "cpu").work_per_call()
    assert w.flops > 0 and {"attn", "gn"} <= set(w.ops)
    w21 = train.Cell(load("tiny21.json"), load("tiny-train.json"), 0,
                            "cpu").work_per_call()
    assert {"attn", "attn_bwd", "gn"} <= set(w21.ops)


def test_op_bytes_follow_the_shapes():
    """One added-KV attention: q and o over T tokens, k and v over T + the
    image tokens, 2 bytes each; 4·T·S·d flops a head; its GroupNorm reads x
    and writes y once."""
    blk = AddedKVAttention(64, 2, 32)
    B, H, W, n = 3, 4, 4, 5
    with torch.no_grad(), counting(blk) as w:
        blk(torch.randn(B, H, W, 64), torch.randn(B, n, 32))
    T, S, d = H * W, H * W + n, 32
    flops, nbytes, bound = w.ops["attn"]
    assert flops == 4 * B * 2 * T * S * d
    assert nbytes == BF16 * B * 2 * d * (2 * T + 2 * S)
    assert w.ops["gn"][1] == 2 * BF16 * B * H * W * 64
    assert bound == max(flops / 989e12, nbytes / 3.35e12)


def test_work_scales_and_adds():
    a = Work(10.0, {"x": [1.0, 2.0, 3.0]})
    b = a.scaled(2) + Work(1.0, {"y": [0.0, 4.0, 5.0]})
    assert b.flops == 21.0 and b.ops == {"x": [2.0, 4.0, 6.0], "y": [0.0, 4.0, 5.0]}
    assert a.ops == {"x": [1.0, 2.0, 3.0]}
