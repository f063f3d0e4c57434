"""The plain reference against kandinsky2_tpu_torch, fp32 on the CPU at the
tiny widths of ``data/``: each model on the same seeded weights and
inputs, the 2.1 decoder's loss and gradients, and Adafactor's update."""

from __future__ import annotations

import pytest
import torch

from bench_h100.kinds import text2img22 as t2i
from bench_h100.kinds import train_unclip21 as train
from bench_h100.reference.optim import Adafactor, ema_update
from bench_h100.reference.train21 import TrainStep21
from bench_h100.weights import load_words

from .common import load

SEED = 2**40 + 17


def rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def pair22():
    cfg = dict(load("tiny22.json"), dtype="float32")
    cell = t2i.Cell(cfg, load("tiny-t2i.json"), SEED, "cpu")
    cell.setup()
    return cell.pipe, t2i.reference_models(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def pair21():
    cfg = dict(load("tiny21.json"), dtype="float32")
    cell = train.Cell(cfg, load("tiny-train.json"), SEED, "cpu")
    cell.setup()
    cell.step(0)
    cell.free()
    return cell, train.reference_models(cfg, SEED, "cpu")


def test_text_and_image_towers_22(pair22):
    pipe, ref = pair22
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, 60, (3, 8), generator=g)
    toks[:, 5] = 63
    for a, b in zip(pipe.text_encoder(toks), ref["text_encoder"](toks)):
        assert rel(a, b) < 1e-5
    img = torch.randn(2, 28, 28, 3, generator=g)
    assert rel(pipe.image_encoder(img), ref["image_encoder"](img)) < 1e-5


def test_prior22(pair22):
    pipe, ref = pair22
    g = torch.Generator().manual_seed(1)
    x, proj = torch.randn(4, 32, generator=g), torch.randn(4, 32, generator=g)
    hidden = torch.randn(4, 8, 32, generator=g)
    mask = torch.arange(8)[None] < torch.tensor([[8], [5], [2], [3]])
    t = torch.tensor([999.0, 500.0, 40.0, 0.0])
    assert rel(pipe.prior(x, t, proj, hidden, mask), ref["prior"](x, t, proj, hidden, mask)) < 1e-5


def test_unet22(pair22):
    pipe, ref = pair22
    g = torch.Generator().manual_seed(2)
    x, emb = torch.randn(4, 8, 8, 4, generator=g), torch.randn(4, 32, generator=g)
    t = torch.tensor([999.0, 500.0, 40.0, 0.0])
    states = pipe.unet.encode_conditioning(emb)
    assert rel(pipe.unet.denoise(x, t, *states), ref["unet"](x, t, emb)) < 1e-5


@pytest.mark.parametrize("half", ["encode", "decode"])
def test_movq(pair22, half):
    pipe, ref = pair22
    g = torch.Generator().manual_seed(3)
    if half == "encode":
        x = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    else:
        x = torch.randn(2, 8, 8, 4, generator=g)
    assert rel(getattr(pipe.movq, half)(x), getattr(ref["movq"], half)(x)) < 1e-5


def test_text2img_chain(pair22):
    """The whole call: the port's float images against the reference's
    chain from the same prompts and injected draws."""
    pipe, ref = pair22
    cfg, tr = dict(load("tiny22.json"), dtype="float32"), load("tiny-t2i.json")
    words = load_words(tr)
    prompts = t2i.call_prompts(tr, words, SEED, 3)
    noise = t2i.call_noise(cfg, tr, SEED, 3, "cpu")
    out = pipe.generate_text2img(
        prompts, batch_size=tr["batch"], decoder_steps=tr["decoder_steps"],
        prior_steps=tr["prior_steps"], decoder_guidance_scale=tr["decoder_guidance"],
        prior_guidance_scale=tr["prior_guidance"], h=tr["h"], w=tr["w"], output="float",
        **noise)
    assert max(t2i.image_gaps(out, t2i.reference_images(cfg, tr, ref, prompts, noise))) < 1e-4


def test_unet21_loss_and_gradients(pair21):
    """Three steps of the port's train step and the window's first against
    the reference's: the losses, the first gradients, the change of every
    trainable tensor and of its EMA, the window step's gradients and
    change."""
    cell, ref = pair21
    ref_readings = cell.reference_readings(ref)
    readings = cell.compare(cell.readings, ref_readings)
    assert train.loss_gap(cell.readings, ref_readings) < 1e-6
    assert readings["grad_gap"] < 1e-5
    assert readings["change_gap"] < 1e-4 and readings["ema_gap"] < 1e-4
    assert readings["window_grad_gap"] < 1e-5 and readings["window_change_gap"] < 1e-4


def test_adafactor_update_against_the_port():
    """The reference's Adafactor and EMA against the port's optax
    counterpart over three steps, factored and unfactored tensors alike."""
    from kandinsky2_tpu_torch.train.ema import ema_update as port_ema
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config

    g = torch.Generator().manual_seed(4)
    shapes = [(256, 130), (3, 140, 200), (64,), (130, 8)]
    mine = [torch.randn(s, generator=g) for s in shapes]
    theirs = [p.clone().requires_grad_(True) for p in mine]
    opt_p = optimizer_from_config({"name": "optax.adafactor",
                                   "params": {"learning_rate": 5e-3}})(theirs)
    mine = [p.requires_grad_(True) for p in mine]
    opt_r = Adafactor(mine, 5e-3)
    ema_p = {i: p.detach().clone() for i, p in enumerate(theirs)}
    ema_r = {i: p.detach().clone() for i, p in enumerate(mine)}
    for step in range(3):
        grads = [torch.randn(s, generator=g) for s in shapes]
        for p, q, gr in zip(theirs, mine, grads):
            p.grad, q.grad = gr.clone(), gr.clone()
        opt_p.step()
        opt_r.step()
        port_ema(ema_p, dict(enumerate(theirs)), 0.9999, num_updates=step)
        ema_update(ema_r, dict(enumerate(mine)), 0.9999, step)
    for a, b in zip(theirs, mine):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
    for i in ema_p:
        assert torch.allclose(ema_p[i], ema_r[i], rtol=0, atol=1e-6)


def test_reference_rows_in_blocks_equal_the_whole_batch(pair21):
    """The reference's gradient from blocks of rows is the whole batch's."""
    cell, _ = pair21
    cfg = dict(load("tiny21.json"), dtype="float32")
    out = []
    for rows in (1, 4):
        step = TrainStep21(cfg, train.reference_models(cfg, SEED, "cpu"), "cpu", rows)
        t, noise = train.step_draws(cfg, cell.traffic, SEED, 0, cell.latent_shape, "cpu")
        out.append(step.step(cell.pool[0], t, noise))
    assert abs(out[0]["loss"] - out[1]["loss"]) < 1e-6 * abs(out[1]["loss"])
    whole = out[1]["grads"]
    floor = sorted(whole.values())[len(whole) // 2]
    for n in whole:
        assert abs(out[0]["grads"][n] - whole[n]) <= 1e-5 * max(whole[n], floor)
