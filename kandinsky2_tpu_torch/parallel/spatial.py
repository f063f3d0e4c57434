"""Spatial (row) parallelism for the UNet and the codecs, the counterpart of
``kandinsky2_tpu/parallel/spatial.py``.

Each rank holds a block of equal rows of the NHWC activations and keeps
every layer exact:

* 3x3 stride-1 convolutions (``sp_conv3x3``) take one halo row from each
  neighbour (``halo_exchange_rows``) and convolve with height padding 0;
  the ranks at the image's top and bottom edge receive zeros, which is the
  zero padding of the unsharded convolution.  The UNet's stride-2
  downsample needs a top halo only (``sp_conv3x3_down``), the codecs'
  asymmetric-pad downsample a bottom one (``halo_below_rows``).
* GroupNorm statistics span the whole image: K1 runs on each shard, its
  moments are combined over the axis, and K2 applies the combined
  coefficients (``ops.group_norm.sharded_group_norm``).
* Full-spatial attention runs the local query rows against all-gathered
  K/V, or, above ``RING_THRESHOLD_TOKENS`` tokens, passes the K/V blocks
  around a ring and merges the partial softmaxes (``sp_attention_rows``,
  ``sp_ring_attention_mh``).
* Nearest resizes map whole rows, so equal row shards stay aligned with
  no communication.

Every op is differentiable for sp training: the halo rows and the ring
hops through ``ppermute_many``'s reverse permutation, the gathered K/V
through ``all_gather``'s reduce-scatter, the norms through
``ShardedGroupNormFunction``, and the ring of K3 launches through
``RingFlashFunction`` (K5 and K4 once a ring step on the card).

The modules take ``sp_axis`` (a :class:`~.mesh.MeshAxis`, where JAX takes
an axis name inside ``shard_map``) and keep the same parameters either
way, so one state dict serves both layouts; ``using_sp_axis`` sets it on a
built model for the length of a call, as JAX's ``module.clone(sp_axis=)``.
Every rank passes the whole input to ``spatial_decode`` / ``spatial_encode``
and gets the whole output back, as ``np.asarray`` of JAX's row-sharded
result does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from ..ops.attention import qkv_attention, use_flash_kernel
from ..ops.flash_attention import flash_attention_bwd, flash_attention_fwd
from .collectives import all_gather, ppermute, ppermute_many
from .mesh import Mesh, MeshAxis

SPATIAL_AXIS = "sp"

# Above this many TOTAL spatial tokens the gathered-KV attention gives way
# to the ring, whose memory is bounded by a query chunk times T/n (the JAX
# package's threshold, so both packages take the same path at every size).
RING_THRESHOLD_TOKENS = 65536


@contextlib.contextmanager
def using_sp_axis(module: nn.Module, axis: Optional[MeshAxis]):
    """Set ``sp_axis`` on every submodule of ``module`` that has one for the
    length of the block, then restore each module's own."""
    mods = [m for m in module.modules() if hasattr(m, "sp_axis")]
    saved = [m.sp_axis for m in mods]
    for m in mods:
        m.sp_axis = axis
    try:
        yield module
    finally:
        for m, s in zip(mods, saved):
            m.sp_axis = s


def halo_exchange_rows(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """This rank's rows with one halo row from each neighbour: (B, Hl, W, C)
    -> (B, Hl + 2, W, C), zeros above the first rank and below the last;
    both rows cross in one batch of transfers."""
    n = axis.size
    down = [(i, i + 1) for i in range(n - 1)]  # my last row to the next rank
    up = [(i + 1, i) for i in range(n - 1)]  # my first row to the previous one
    top, bottom = ppermute_many([x[:, -1:], x[:, :1]], axis, [down, up])
    return torch.cat([top, x, bottom], dim=1)


def halo_below_rows(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The next rank's first row appended (zeros on the last rank), the
    codecs' bottom-only pad: (B, Hl, W, C) -> (B, Hl + 1, W, C)."""
    up = [(i + 1, i) for i in range(axis.size - 1)]
    return torch.cat([x, ppermute(x[:, :1], axis, up)], dim=1)


def sp_conv3x3(conv: nn.Module, x: torch.Tensor,
               axis: Optional[MeshAxis]) -> torch.Tensor:
    """A 3x3 stride-1 padding-1 ``layers.Conv2d`` over row-sharded NHWC
    activations: the halo rows, then the same convolution with height
    padding 0 and width padding 1 (``axis`` None: the convolution as it
    is, on the whole image)."""
    if axis is None:
        return conv(x)
    return conv(halo_exchange_rows(x, axis), padding=(0, 1))


def sp_conv3x3_down(conv: nn.Module, x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """A 3x3 stride-2 padding-1 ``layers.Conv2d`` over row-sharded
    activations.  With even local rows the bottom pad row is never read, so
    only a top halo row is needed (zeros on the first rank)."""
    down = [(i, i + 1) for i in range(axis.size - 1)]
    top = ppermute(x[:, -1:], axis, down)
    return conv(torch.cat([top, x], dim=1), padding=(0, 1))


def sp_rows_ok(h: int, sp_n: int, levels: int) -> bool:
    """True when ``h`` rows keep equal EVEN shards across ``levels`` dyadic
    resolutions when sharded ``sp_n``-way."""
    return h % (sp_n * 2 ** (levels - 1)) == 0


def check_sp_rows(h: int, sp_n: int, levels: int,
                  what: str = "latent height") -> None:
    """Raise with a uniform message unless ``sp_rows_ok`` — the shared
    guard for every row-sharded entry point."""
    if not sp_rows_ok(h, sp_n, levels):
        need = sp_n * 2 ** (levels - 1)
        raise ValueError(
            f"{what} {h} must be a multiple of sp_axis*2^(levels-1) = {need} "
            "so every resolution level keeps equal even row shards"
        )


def _ring(axis: MeshAxis):
    """Each rank receives the NEXT rank's block (after n hops the blocks
    are home again)."""
    return [(i, (i - 1) % axis.size) for i in range(axis.size)]


def _merge(acc, o, lse):
    """Fold one partial attention (o [B, T, H, d], lse [B*H, T] natural
    log) into the running (o fp32, lse [B, T, H, 1])."""
    B, T, H, _ = o.shape
    lse = lse.reshape(B, H, T).transpose(1, 2)[..., None]
    o = o.float()
    if acc is None:
        return o, lse
    o_acc, lse_acc = acc
    m = torch.maximum(lse_acc, lse)
    wa, wb = torch.exp(lse_acc - m), torch.exp(lse - m)
    s = wa + wb
    return (o_acc * wa + o * wb) / s, m + torch.log(s)


def _ring_flash_fwd(q, k, v, axis, extra_k=None, extra_v=None):
    """Ring attention through K3: one launch on the replicated prefix (if
    any) and one per ring step, their (O, LSE) pairs merged in fp32.
    q [B, Tl, H, d], k/v [B, Tl, H, d] local, extra [B, E, H, d].  Returns
    (O in v's dtype, the merged natural-log LSE [B*H, Tl] fp32)."""
    B, Tl, H, _ = q.shape
    acc = None
    if extra_k is not None:
        acc = _merge(acc, *flash_attention_fwd(q, extra_k, extra_v))
    kc, vc = k.contiguous(), v.contiguous()
    for step in range(axis.size):
        acc = _merge(acc, *flash_attention_fwd(q, kc, vc))
        if step + 1 < axis.size:
            kc, vc = ppermute_many([kc, vc], axis, [_ring(axis)] * 2)
    o, lse = acc
    return o.to(v.dtype), lse[..., 0].transpose(1, 2).reshape(B * H, Tl).contiguous()


class RingFlashFunction(torch.autograd.Function):
    """The ring of K3 launches with its backward on the card: K5 and K4
    (``flash_attention_bwd``; their plain versions for CPU tensors) once a
    ring step and once on the prefix, each against the visiting
    K/V block with the MERGED LSE and O, so exp(S − LSE) is the true
    probability and delta = rowsum(dO·O) the whole row's.  dQ is summed in
    fp32 over the steps; each block's dK/dV (fp32) travels the ring with
    the block and, after one more hop, is home: every rank ends with the
    gradient of its own K/V.  The prefix's dK/dV is this rank's share (the
    gradient all-reduce sums the shares)."""

    @staticmethod
    def forward(ctx, axis, q, k, v, extra_k, extra_v):
        o, lse = _ring_flash_fwd(q, k, v, axis, extra_k, extra_v)
        ctx.axis = axis
        ctx.save_for_backward(q, k, v, extra_k, extra_v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, ek, ev, o, lse = ctx.saved_tensors
        axis, n = ctx.axis, ctx.axis.size
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dek = dev = None
        if ek is not None:
            dq_e, dek, dev = flash_attention_bwd(q, ek, ev, o, lse, do)
            dq += dq_e.float()
        kc, vc = k.contiguous(), v.contiguous()
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros_like(dkc)
        ring = _ring(axis)
        for step in range(n):
            dq_s, dk_s, dv_s = flash_attention_bwd(q, kc, vc, o, lse, do)
            dq += dq_s.float()
            dkc += dk_s.float()
            dvc += dv_s.float()
            if step + 1 < n:
                kc, vc, dkc, dvc = ppermute_many([kc, vc, dkc, dvc], axis, [ring] * 4)
            elif n > 1:  # the last hop brings each block's gradient home
                dkc, dvc = ppermute_many([dkc, dvc], axis, [ring] * 2)
        return (None, dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), dek, dev)


def _ring_flash(q, k, v, axis, extra_k=None, extra_v=None):
    """Ring attention through K3, differentiable through K5 and K4
    (``RingFlashFunction``) where a gradient is wanted; output in v's
    dtype."""
    ins = [t for t in (q, k, v, extra_k, extra_v) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return RingFlashFunction.apply(axis, q, k, v, extra_k, extra_v)
    return _ring_flash_fwd(q, k, v, axis, extra_k, extra_v)[0]


class _PlainBackwardOnCard(torch.autograd.Function):
    """Identity whose backward counts one plain-route attention backward
    on the card (``qkv_attention.plain_on_card``), as the plain fold's
    forward is counted."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            qkv_attention.plain_on_card += 1
        return g


def _fold(state, qq, kc, vc):
    """One online-softmax fold of a K/V block into a query chunk's
    (max, sum, accumulator), fp32; logits "bthc,bshc->bths"."""
    m, s, acc = state
    logits = torch.einsum("bthc,bshc->bths", qq, kc)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    return (m_new, s * corr + p.sum(dim=-1),
            acc * corr[..., None] + torch.einsum("bths,bshc->bthc", p, vc))


def _ring_fold(q, k, v, axis, q_chunk, scale, extra_k=None, extra_v=None):
    """The plain ring (``spatial.py:196-260`` of the JAX package): fp32
    online softmax, queries ``q_chunk`` rows at a time, K/V blocks one ring
    hop a step, the replicated prefix folded first.  q, k pre-scaled by
    ``scale``; q/k/v [B, Tl, H, c].  Differentiable by autograd, through
    the permutations' transposes, as JAX's scan is; on the card its
    backward is counted as a plain-route attention too."""
    B, Tl, H, c = q.shape
    qf = q.float() * scale
    kc, vc = k.float() * scale, v.float()
    chunks = list(qf.split(min(q_chunk, Tl), dim=1))
    states = [(torch.full((B, qq.shape[1], H), -math.inf, device=q.device),
               torch.zeros((B, qq.shape[1], H), device=q.device),
               torch.zeros((B, qq.shape[1], H, c), device=q.device)) for qq in chunks]
    if extra_k is not None:
        ek, ev = extra_k.float() * scale, extra_v.float()
        states = [_fold(st, qq, ek, ev) for st, qq in zip(states, chunks)]
    for step in range(axis.size):
        states = [_fold(st, qq, kc, vc) for st, qq in zip(states, chunks)]
        if step + 1 < axis.size:
            kc, vc = ppermute_many([kc, vc], axis, [_ring(axis)] * 2)
    out = torch.cat([acc / s[..., None] for _, s, acc in states], dim=1).to(v.dtype)
    if q.is_cuda and out.requires_grad:
        out = _PlainBackwardOnCard.apply(out)
    return out


def _flash_route(q, k, v) -> bool:
    """K3 takes the ring where the one routing rule sends these tensors on
    the card; the plain fold runs on the CPU and in fp32 (on the card
    counted in ``qkv_attention.plain_on_card``, as the unsharded plain
    route is)."""
    if q.is_cuda and use_flash_kernel(q, k, v):
        return True
    if q.is_cuda:
        qkv_attention.plain_on_card += 1
    return False


def sp_attention_rows(q, k, v, axis: MeshAxis, impl: Optional[str] = None):
    """Exact full-spatial single-head attention over row-sharded maps, the
    MoVQ's ``AttnBlock``: q, k, v (B, Hl, W, C) local row blocks -> the
    softmax rows this rank owns.  ``"gathered"``: the local queries against
    all-gathered K/V through ``ops.attention.qkv_attention`` (K3 where the
    routing rule sends it); ``"ring"``: ``sp_ring_attention_rows``.
    ``impl=None`` picks the ring above ``RING_THRESHOLD_TOKENS`` total
    tokens."""
    B, Hl, W, C = q.shape
    if impl is None:
        impl = "ring" if Hl * W * axis.size > RING_THRESHOLD_TOKENS else "gathered"
    if impl == "ring":
        return sp_ring_attention_rows(q, k, v, axis)
    if impl != "gathered":
        raise ValueError(f"impl must be 'gathered' or 'ring', got {impl!r}")
    kf = all_gather(k.reshape(B, Hl * W, 1, C), axis, dim=1)
    vf = all_gather(v.reshape(B, Hl * W, 1, C), axis, dim=1)
    return qkv_attention(q.reshape(B, Hl * W, 1, C), kf, vf).reshape(B, Hl, W, C)


def sp_ring_attention_rows(q, k, v, axis: MeshAxis, q_chunk: int = 2048):
    """Ring attention over row-sharded feature maps (exact softmax): the
    K/V row blocks travel around the ring one hop a step.  On the card in
    bf16 at a head width K3 takes, each step is one K3 launch and the
    partial (O, LSE) pairs are merged; otherwise the plain fp32 fold over
    ``q_chunk`` query rows at a time.  Output in v's dtype."""
    B, Hl, W, C = q.shape
    q3, k3, v3 = (t.reshape(B, Hl * W, 1, C) for t in (q, k, v))
    if _flash_route(q3, k3, v3):
        out = _ring_flash(q3, k3, v3, axis)
    else:
        out = _ring_fold(q3, k3, v3, axis, q_chunk, C ** -0.25)
    return out.reshape(B, Hl, W, C)


def sp_ring_attention_mh(q, k, v, axis: MeshAxis, extra_k=None, extra_v=None,
                         q_chunk: int = 1024):
    """Multi-head ring attention over row-sharded token sequences, the
    UNet's: softmax over [extra; spatial] keys where ``extra_k``/``extra_v``
    [B, E, H, c] is a replicated prefix (the text tokens) and the spatial
    K/V [B, Tl, H, c] travel the ring.  ``qkv_attention``'s scaling (q and
    k each by c^-1/4); K3 per step on the card in bf16, the plain fp32
    fold otherwise; output in v's dtype."""
    if _flash_route(q, k, v):
        return _ring_flash(q, k, v, axis, extra_k, extra_v)
    return _ring_fold(q, k, v, axis, q_chunk, q.shape[-1] ** -0.25, extra_k, extra_v)


def shard_rows(x: Optional[torch.Tensor], axis: MeshAxis, dim: int = 1):
    """This rank's block of equal rows of ``x`` along ``dim`` (None stays
    None): how every rank cuts the same whole input."""
    if x is None:
        return None
    hl = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * hl, hl)


def spatial_decode(movq: nn.Module, codes_or_quant: torch.Tensor, mesh: Mesh,
                   axis: str = SPATIAL_AXIS, method: str = "decode_code"):
    """``movq.decode_code`` / ``movq.decode`` with rows sharded over
    ``mesh``'s ``axis``: (B, Hl, Wl) codes or (B, Hl, Wl, C) pre-quant
    latents, the same on every rank; latent rows must divide by the axis
    size.  Returns the whole decoded image on every rank."""
    n = mesh.shape[axis]
    h_latent = codes_or_quant.shape[1]
    if h_latent % n != 0:
        raise ValueError(
            f"latent height {h_latent} must be a multiple of the spatial "
            f"axis size {n} (equal row shards; 'divide' evenly)"
        )
    ax = mesh.axis(axis)
    with using_sp_axis(movq, ax):
        out = getattr(movq, method)(shard_rows(codes_or_quant, ax))
    return all_gather(out, ax, dim=1)


def spatial_encode(codec: nn.Module, image: torch.Tensor, mesh: Mesh,
                   axis: str = SPATIAL_AXIS, method: str = "encode"):
    """The codec's ``encode`` with image rows sharded over ``mesh``'s
    ``axis``: the stride-2 downsamples take a one-row bottom halo per
    level, so H must divide by the axis size times 2**(levels-1).  Returns
    the whole latent (or the KL codec's (mean, logvar)) on every rank."""
    n = mesh.shape[axis]
    check_sp_rows(image.shape[1], n, len(codec.ch_mult), what="image height")
    ax = mesh.axis(axis)
    with using_sp_axis(codec, ax):
        out = getattr(codec, method)(shard_rows(image, ax))
    if isinstance(out, tuple):
        return tuple(all_gather(t, ax, dim=1) for t in out)
    return all_gather(out, ax, dim=1)
