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
from ..ops.flash_attention import flash_attention_fwd
from .collectives import all_gather, exchange, ppermute
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
    -> (B, Hl + 2, W, C), zeros above the first rank and below the last."""
    n, i = axis.size, axis.index
    B, _, W, C = x.shape
    top, bottom = (torch.zeros((B, 1, W, C), dtype=x.dtype, device=x.device)
                   for _ in range(2))
    sends, recvs = [], []
    if i + 1 < n:  # my last row down, the next rank's first row up
        sends.append((x[:, -1:], i + 1))
        recvs.append((bottom, i + 1))
    if i > 0:
        sends.append((x[:, :1], i - 1))
        recvs.append((top, i - 1))
    exchange(axis, sends, recvs)
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


def _ring_flash(q, k, v, axis, extra_k=None, extra_v=None):
    """Ring attention through K3: one launch on the replicated prefix (if
    any) and one per ring step, their (O, LSE) pairs merged in fp32.
    q [B, Tl, H, d], k/v [B, Tl, H, d] local, extra [B, E, H, d]."""
    acc = None
    if extra_k is not None:
        acc = _merge(acc, *flash_attention_fwd(q, extra_k, extra_v))
    kc, vc = k.contiguous(), v.contiguous()
    for step in range(axis.size):
        acc = _merge(acc, *flash_attention_fwd(q, kc, vc))
        if step + 1 < axis.size:
            kc, vc = ppermute(kc, axis, _ring(axis)), ppermute(vc, axis, _ring(axis))
    return acc[0].to(v.dtype)


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
    ``scale``; q/k/v [B, Tl, H, c]."""
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
            kc, vc = ppermute(kc, axis, _ring(axis)), ppermute(vc, axis, _ring(axis))
    out = torch.cat([acc / s[..., None] for _, s, acc in states], dim=1)
    return out.to(v.dtype)


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
