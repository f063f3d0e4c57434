"""The work of a model call, counted from its shapes: every matmul,
convolution and attention product of the reference models, run on the
meta device, so no number depends on the program or on a device.

``counting(model, grad=...)`` yields a ``Work``: ``flops`` (2 per
multiply-add, forward, and with gradients the backward that autograd
needs: a weight gradient where the weight is trained, an input gradient
where the input needs one), and per op class the flops and bytes that
bound a kernel's roofline:

* ``attn``: the spatial attention the flash kernels serve (the UNets'
  and the MoVQ's): 4·T·S·d a head forward; q, k, v read once and o written
  once, 2 bytes an element (bf16);
* ``attn_bwd``: its backward, 10·T·S·d a head (the flash backward
  recomputes the logits) for the flash kernels' roofline; q, k, v, o, dO
  read once, dq, dk, dv written once;
* ``gn``: each GroupNorm's x read once and y written once, 2 bytes an
  element (bf16), no flops counted.

``flops`` counts the backward attention at 8·T·S·d, the products it
needs, as a model-flops utilisation does.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field

import torch

from ..reference import encoders, layers, movq, prior22, unet21, unet22

BF16 = 2
PEAKS = json.load(open(os.path.join(os.path.dirname(__file__), "peaks.json")))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the flops at the
    bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


@dataclass
class Work:
    """``flops`` of the calls counted; ``ops[op] = [flops, bytes, bound
    seconds]``, the bound summed over the op's invocations."""

    flops: float = 0.0
    ops: dict = field(default_factory=dict)

    def add(self, op: str, flops: float, nbytes: float) -> None:
        acc = self.ops.setdefault(op, [0.0, 0.0, 0.0])
        acc[0] += flops
        acc[1] += nbytes
        acc[2] += bound_s(flops, nbytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, {op: [v * k for v in acc] for op, acc in self.ops.items()})

    def __add__(self, other: "Work") -> "Work":
        out = self.scaled(1.0)
        out.flops += other.flops
        for op, acc in other.ops.items():
            mine = out.ops.setdefault(op, [0.0, 0.0, 0.0])
            for j in range(3):
                mine[j] += acc[j]
        return out


def _needs(t) -> bool:
    return torch.is_tensor(t) and t.requires_grad


def _hooks(work: Work, grad: bool):
    """(module class, forward hook) pairs that add each call's work."""

    def linear(mod, args, out):
        x = args[0]
        f = 2.0 * x.numel() // x.shape[-1] * mod.in_features * mod.out_features
        work.flops += f
        if grad:
            work.flops += f * (_needs(x) + mod.weight.requires_grad)

    def conv(mod, args, out):
        x = args[0]
        cin = x.shape[-1] // mod.groups
        f = 2.0 * out.numel() * cin * mod.kernel_size[0] * mod.kernel_size[1]
        work.flops += f
        if grad:
            work.flops += f * (_needs(x) + mod.weight.requires_grad)

    def attn(B, heads, T, S, d, flash, backward):
        fwd = 4.0 * B * heads * T * S * d
        work.flops += fwd + (2 * fwd if backward else 0)
        if flash:
            work.add("attn", fwd, BF16 * B * heads * d * (2 * T + 2 * S))
            if backward:
                work.add("attn_bwd", 2.5 * fwd, BF16 * B * heads * d * (4 * T + 4 * S))

    def seq_block(heads_of):
        def hook(mod, args, out):
            x = args[0]
            B, T, W = x.shape
            attn(B, heads_of(mod), T, T, W // heads_of(mod), False, grad and _needs(out))
        return hook

    def added_kv(mod, args, out):
        x, enc = args
        B, H, W, C = x.shape
        attn(B, mod.heads, H * W, H * W + enc.shape[1], C // mod.heads, True,
             grad and _needs(out))

    def unet21_attn(mod, args, out):
        x, enc = args
        B, H, W, C = x.shape
        attn(B, mod.num_heads, H * W, H * W + enc.shape[1], C // mod.num_heads, True,
             grad and _needs(out))

    def movq_attn(mod, args, out):
        B, H, W, C = args[0].shape
        attn(B, 1, H * W, H * W, C, True, grad and _needs(out))

    def group_norm(mod, args, out):
        work.add("gn", 0.0, 2 * BF16 * args[0].numel())

    def vit_proj(mod, args, out):
        work.flops += 2.0 * args[0].shape[0] * mod.proj.numel()

    return [
        (layers.Linear, linear), (layers.Conv2d, conv),
        (encoders.HFCLIPLayer, seq_block(lambda m: m.heads)),
        (encoders.BertLayer, seq_block(lambda m: m.heads)),
        (encoders.CLIPResBlock, seq_block(lambda m: m.heads)),
        (prior22.BasicSelfBlock, seq_block(lambda m: m.heads)),
        (unet22.AddedKVAttention, added_kv), (unet21.AttentionBlock, unet21_attn),
        (movq.AttnBlock, movq_attn), (layers.GroupNorm32, group_norm),
        (encoders.CLIPViT, vit_proj),
    ]


@contextlib.contextmanager
def counting(model: torch.nn.Module, grad: bool = False):
    """Count the work of every call of ``model`` inside the block."""
    work = Work()
    handles = []
    for cls, hook in _hooks(work, grad):
        for m in model.modules():
            if type(m) is cls:
                handles.append(m.register_forward_hook(hook))
    try:
        yield work
    finally:
        for h in handles:
            h.remove()
