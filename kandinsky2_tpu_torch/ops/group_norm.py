"""Fused GroupNorm(+FiLM)(+SiLU) over channels-last activations: two
kernels for Hopper, and the plain PyTorch version of each.

Replaces the Pallas TPU pair of ``kandinsky2_tpu/ops/group_norm.py``:

* K1 ``group_norm_stats`` replaces ``_moments`` (``_moments_kernel``) and
  the XLA glue ``_coefficients`` after it: one CUDA C++ launch reads x
  [B, N, C] once, sums x − p and (x − p)² in fp32 (p, the pivot, is each
  group's first element of the batch row), finishes the cross-block
  reduction itself, and writes per-(b, c) fp32 coefficients a, b with the
  group statistics (mean = p + m, var = max(E[(x − p)²] − m², 0) with
  m = E[x − p], then rsqrt(var + eps)), the affine scale/bias and the FiLM
  pair (1 + fs, fb) folded in.
* K2 ``group_norm_apply`` replaces ``_apply`` (``_apply_kernel``): one CUDA
  C++ launch computes y = x·a + b in fp32, then y·sigmoid(swish·y) where
  swish != 0, and rounds once to x's dtype.

Both are in ``csrc/group_norm.cu``, whose source note gives their designs
and bounds: both are bound by device-memory bytes (K1 reads x once, K2
reads x and writes y once: 2 reads + 1 write of the activation in all, the
floor for an exact normalisation that needs its statistics before it can
write).

A GroupNorm on the card is those two launches, made by one foreign call
(``k2_group_norm``).  The launch plan of each layout (K1's splits and rows,
K2's grid, the checks of the parameters' layout) is computed once and
cached, so a call does only the ``data_ptr()``s, the allocation of its
output and of its scratch (a, b and K1's partials), and that call.
``group_norm_stats`` and ``group_norm_apply`` launch one kernel each, for
the tests and the chip script.

K1's sums are taken in an order fixed by the shape, so its a and b are
bitwise repeatable; against the plain version they differ by fp32
summation order only, a relative error of about 1e-6·√N on the moments.

The shifted sums depart from the JAX package, whose ``_moments`` and
``_coefficients`` take the one-pass E[x²] − mean² in fp32: that form
cancels as (mean/std)² and loses about 5e-2 of the norm where a group's
mean lies 1000 standard deviations from zero, while the shifted form
cancels as ((mean − p)/std)², small for a pivot taken from the group.
It stays one pass over x, and every block of a batch row shares the
pivots, so its partial sums still add.  At ordinary activations the two
agree to fp32 rounding.

A row-sharded GroupNorm (``sharded_group_norm``, the counterpart of
``GroupNorm32(axis_name=...)``) runs K1 on its shard through the moments
entry ``k2_group_norm_moments`` (the same launch, whose finish writes each
group's pivot and shifted sums), gathers every shard's moments over the
axis, shifts them to one pivot (``combine_moments``: the shards' pivots
differ) and folds the coefficients, then runs K2.  Its gradient
(``ShardedGroupNormFunction``) is autograd of a plain sharded norm whose
per-group sums are ``psum``'d over the axis, so the ``psum``s' backward
carries the cross-shard terms.

Gradients: ``GroupNormFunction`` is the counterpart of the ``custom_vjp``
of ``pallas_group_norm``.  Its forward is K1 + K2 and saves only the
inputs.  The JAX package differentiates its XLA formulation
(``_xla_reference``), whose backward XLA fuses into a few passes; run
eagerly, autograd of the plain norm was some twenty-five full-size fp32
launches a norm.  So the port's backward is the gradient in closed form
(``group_norm_backward``): on the card K1's moments entry, then B1
``group_norm_bwd_reduce_kernel`` (x and gy read once: the per-channel sums
of the output gradient through the activation, and of it times the
normalised x; the FiLM and affine gradients and the per-group terms of dx)
and B2 ``group_norm_bwd_apply_kernel`` (x and gy read again, dx written
once), in one foreign call; on the CPU ``group_norm_backward_plain``, the
same closed form in plain PyTorch.  Each gradient is computed only where
its input needs one, and every sum is taken in an order fixed by the
shape, so the gradients are bitwise repeatable.  ``group_norm_plain``
stays the function they differentiate, and the tests hold the closed form
against its autograd.

Any C with C % groups == 0 is accepted (the TPU's C % 128 rule was a tiling
rule of the TPU), up to 1024 loads of a row.  The CUDA source is built at
first use.  K1 finishes its cross-block reduction with a per-b counter
that each launch leaves at zero; every stream has its own set of
counters (looked up by device and current stream, beside the stream
handle), so GroupNorms on different streams run at once without sharing
one, and a launch plan is cached per stream.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ._build import check, load_library

# K1's launch geometry (about two blocks per SM on the H100's 132);
# _STATS_UNROLL is UNROLL in csrc/group_norm.cu
_STATS_BLOCKS = 2 * 132
_STATS_UNROLL = 8
# both kernels' blocks are TY rows of a strip of chunks (C / vec of them in
# a row), about _BLOCK_THREADS, or one row of at most _MAX_CHUNKS
# (MAX_THREADS in the source); K1's strip is the whole row, K2's at most
# _APPLY_STRIP chunks; _APPLY_UNROLL is APPLY_UNROLL there
_BLOCK_THREADS = 256
_APPLY_STRIP = 64
_APPLY_UNROLL = 4
# K2 blocks an SM gets where a shape's rows allow: fewer, taller blocks
# read a and b fewer times than a full wave of occupancy
_APPLY_BLOCKS_PER_SM = 2
_MAX_CHUNKS = 1024
# the backward's B1 and B2 (BWD_UNROLL and BWD_THREADS in the source): blocks
# of TY rows of a strip of chunks, about _BWD_THREADS; about
# _BWD_BLOCKS_PER_SM blocks an SM over the batch rows, strips and row splits;
# B1 at most _BWD_MAX_SPLITS splits, since its finish reads every split's
# partials of a batch row
_BWD_THREADS = 256
_BWD_UNROLL = 4
_BWD_BLOCKS_PER_SM = 4
_BWD_MAX_SPLITS = 32
_MAX_BATCH = 4096
_MAX_ROWS = 2**31 - 1


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous [B, N, C] tensor")


def group_norm_moments_plain(x3: torch.Tensor, num_groups: int):
    """(pivots [B, G], Σ(x − p), Σ(x − p)² over N [B, C]) of x3 [B, N, C],
    in fp32: K1's pivot p is each group's first channel at row 0, detached,
    since the norm does not depend on it."""
    cs = x3.shape[2] // num_groups
    p = x3[:, 0, ::cs].detach().float()
    d = x3.float() - p.repeat_interleave(cs, dim=-1)[:, None]
    return p, d.sum(1), (d * d).sum(1)


def _coefficients(p, s1, s2, cnt, scale, bias, film, g, eps):
    """Group-combine the shifted moments (pivots ``p`` [B, G]) and fold
    everything affine into per-channel a, b ([B, C] fp32)."""
    B, C = s1.shape
    cs = C // g
    m_g = s1.reshape(B, g, cs).sum(-1) / cnt
    mean_g = p + m_g
    var_g = torch.clamp(s2.reshape(B, g, cs).sum(-1) / cnt - m_g * m_g, min=0.0)
    return _fold_affine(mean_g, var_g, scale, bias, film, eps)


def _fold_affine(mean_g, var_g, scale, bias, film, eps):
    """Per-channel a, b ([B, C] fp32) of the group statistics mean_g and
    var_g [B, G], with the affine scale and bias and the FiLM pair."""
    B, C = mean_g.shape[0], scale.shape[0]
    cs = C // mean_g.shape[1]
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(cs, dim=-1)
    mean_c = mean_g.repeat_interleave(cs, dim=-1)
    a = inv_c * scale.float()
    b = bias.float() - mean_c * a
    if film is not None:
        fs, fb = (f.reshape(B, C).float() for f in film)
        m = 1.0 + fs
        a = a * m
        b = b * m + fb
    return a, b


def group_norm_stats_plain(x3, scale, bias, film, num_groups: int, eps: float):
    """K1's function in plain PyTorch: the shifted moments, then
    ``_coefficients``.  Returns (a, b), each [B, C] fp32."""
    p, s1, s2 = group_norm_moments_plain(x3, num_groups)
    cnt = float(x3.shape[1] * (x3.shape[2] // num_groups))
    return _coefficients(p, s1, s2, cnt, scale, bias, film, num_groups, eps)


def group_norm_apply_plain(x3, a, b, swish: float):
    """y·sigmoid(swish·y) (y where swish is 0) of y = x·a + b in fp32, cast
    to x's dtype; a, b [B, C] fp32."""
    y = x3.float() * a[:, None, :] + b[:, None, :]
    if swish:
        y = y * torch.sigmoid(y * swish)
    return y.to(x3.dtype)


def vec_width(C: int, ptr: int, elem_size: int) -> int:
    """Elements per load: the widest of 16, 8, 4 or 2 bytes that C and the
    data pointer allow."""
    vec = 16 // elem_size
    while vec > 1 and (C % vec or ptr % (vec * elem_size)):
        vec //= 2
    return vec


def stats_threads(chunks: int) -> int:
    """Threads of a K1 block for rows of ``chunks`` loads: TY rows of them,
    about _BLOCK_THREADS, or one row of a wide C."""
    return chunks * max(1, _BLOCK_THREADS // chunks)


def apply_strip(chunks: int) -> int:
    """Chunks of a K2 block's channel strip: the widest divisor of
    ``chunks`` up to _APPLY_STRIP, so that a block reads a and b for its
    strip only; the whole row where that divisor is under 8."""
    cw = max(d for d in range(1, min(chunks, _APPLY_STRIP) + 1) if chunks % d == 0)
    return cw if cw >= 8 else chunks


def apply_threads(chunks: int) -> int:
    """Threads of a K2 block: TY rows of its strip, about _BLOCK_THREADS."""
    cw = apply_strip(chunks)
    return cw * max(1, _BLOCK_THREADS // cw)


def bwd_strip(chunks: int) -> int:
    """Chunks of a B1 and B2 block's strip: the narrowest divisor of
    ``chunks`` from 8 to _APPLY_STRIP (a warp then reads rows of 128
    bytes, and small batches still make many blocks), else its widest
    divisor up to _APPLY_STRIP."""
    divs = [d for d in range(1, min(chunks, _APPLY_STRIP) + 1) if chunks % d == 0]
    return min((d for d in divs if d >= 8), default=divs[-1])


class LaunchPlan(NamedTuple):
    """Both kernels' grids for one [B, N, C] shape at ``vec`` elements a
    load; each block is TY rows of a strip of chunks."""
    stats_threads: int
    stats_splits: int  # K1's grid is (stats_splits, B) ...
    stats_rows: int    # ... each block summing this many rows of C / vec chunks
    apply_threads: int
    apply_cw: int      # K2's strip, in chunks
    apply_splits: int  # K2's grid is (apply_splits * C / vec / apply_cw, B)
    bwd_threads: int
    bwd_cw: int            # B1's and B2's strip, in chunks
    bwd_splits: int        # B1's grid is (bwd_splits * C / vec / bwd_cw, B)
    bwd_apply_splits: int  # B2's, with bwd_apply_splits


def launch_plan(B: int, N: int, C: int, vec: int, sms: int = 132) -> LaunchPlan:
    """The launch geometry of the four kernels, from the shape and the
    card's number of SMs."""
    chunks = C // vec
    threads = stats_threads(chunks)
    ty = threads // chunks
    # K1: rows of a split, a multiple of the block's rows times the unroll
    gran = ty * _STATS_UNROLL
    splits = max(1, min(-(-N // gran), -(-_STATS_BLOCKS // B)))
    rows = -(-(-(-N // splits)) // gran) * gran
    # K2: at most _APPLY_UNROLL row groups a block, so that a thread has all
    # its loads in flight before its first store, and at least
    # _APPLY_BLOCKS_PER_SM blocks an SM where there are that many row groups
    athreads, cw = apply_threads(chunks), apply_strip(chunks)
    groups = -(-N // (athreads // cw))
    columns = B * (chunks // cw)
    apply_splits = max(-(-groups // _APPLY_UNROLL),
                       min(groups, -(-sms * _APPLY_BLOCKS_PER_SM // columns)))
    # B1 and B2: about _BWD_BLOCKS_PER_SM blocks an SM in all; B1 at least
    # one pass of its loads a thread and at most _BWD_MAX_SPLITS splits, B2
    # at least one row a thread
    bcw = bwd_strip(chunks)
    bthreads = bcw * max(1, _BWD_THREADS // bcw)
    bty = bthreads // bcw
    want = -(-sms * _BWD_BLOCKS_PER_SM // (B * (chunks // bcw)))
    bsplits = max(1, min(-(-N // (bty * _BWD_UNROLL)), _BWD_MAX_SPLITS, want))
    return LaunchPlan(threads, -(-N // rows), rows, athreads, cw, apply_splits,
                      bthreads, bcw, bsplits, max(1, min(-(-N // bty), want)))


class _Plan(ctypes.Structure):
    """``Plan`` of csrc/group_norm.cu: the same fields in the same order,
    checked against the library by ``_lib``."""
    _fields_ = (
        [(n, ctypes.c_longlong) for n in (
            "B", "N", "C", "G", "vec", "x_bf16",
            "stats_splits", "stats_rows", "stats_threads",
            "apply_splits", "apply_cw", "apply_threads", "swish_mode",
            "param_bf16", "film_bf16", "film_sb",
            "bwd_cw", "bwd_threads", "bwd_splits", "bwd_apply_splits")]
        + [(n, ctypes.c_double) for n in ("eps", "cnt", "swish")]
        + [("counter", ctypes.c_void_p)])


class _Launch(NamedTuple):
    ref: int      # the _Plan's address, passed to the C entries
    plan: _Plan
    part: int     # floats of K1's partials, B * splits * G * 2
    scratch: int  # floats of k2_group_norm's scratch: a, b, then the partials
    # floats of k2_group_norm_backward's scratch: B2's coefficients
    # [5, B, C], the affine partials [B, 2, C], the moments [B, G, 3], K1's
    # partials, B1's [B, bwd_splits, 2, C]
    bwd_scratch: int = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("group_norm.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, n in (("k2_group_norm_stats", 10), ("k2_group_norm_apply", 6),
                    ("k2_group_norm", 9), ("k2_group_norm_moments", 5),
                    ("k2_group_norm_backward", 13)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [P] * n, I
    lib.k2_group_norm_layout.argtypes, lib.k2_group_norm_layout.restype = [P, I], I
    want = [ctypes.sizeof(_Plan), _STATS_UNROLL, _APPLY_UNROLL, _MAX_CHUNKS,
            _BWD_UNROLL, _BWD_THREADS] + [
        getattr(_Plan, name).offset for name, _ in _Plan._fields_]
    got = (ctypes.c_longlong * len(want))()
    if lib.k2_group_norm_layout(got, len(want)) != len(want) or list(got) != want:
        raise RuntimeError("group_norm: _Plan or the kernels' constants differ "
                           "from csrc/group_norm.cu")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """K1's per-b counters for the launches on ``stream``: zero, and left
    at zero by every launch, so one set serves a stream's launches in
    turn; another stream gets its own."""
    return torch.zeros(_MAX_BATCH, dtype=torch.int32, device=device)


def _stream(x: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _layout(t: torch.Tensor):
    return t.dtype, t.device, t.shape, t.stride()


def _param_bf16(layout, name: str, device, B: int, C: int) -> int:
    """1 for a bf16 tensor, 0 for fp32, of C values ([C]) or B rows of C
    with a unit last stride (FiLM's [B, C] or [B, 1, 1, C]), on the card of
    x; raises for anything else."""
    dtype, dev, shape, stride = layout
    if dev != device or dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_stats: {name} must be bf16 or fp32 on {device}")
    if math.prod(shape) != B * C or shape[-1] != C or stride[-1] != 1 or (
            B > 1 and shape[0] != B):
        raise ValueError(f"group_norm_stats: {name} must hold {B} rows of {C}")
    return int(dtype == torch.bfloat16)


@functools.lru_cache(maxsize=256)
def _plan(dtype, device, shape, align, num_groups, eps, swish, params, film,
          stream=0):
    """The launch of one layout on one stream, built once: checks what the
    kernels take, then fills a _Plan with ``launch_plan``'s geometry and
    the stream's K1 counters.  x is contiguous, [B, ..., C], its data
    pointer ``align`` bytes past 16; ``params`` and ``film`` are the
    layouts of (scale, bias) and of (fs, fb) or None (``params`` None for
    K1's moments, which read neither).  ``num_groups`` None: a plan for K2
    alone, which needs no counters."""
    name = "group_norm_apply" if num_groups is None else "group_norm"
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the kernels take bf16 or fp32 x")
    B, C = shape[0], shape[-1]
    N = math.prod(shape[1:-1])
    es = 2 if dtype == torch.bfloat16 else 4
    vec = vec_width(C, align, es)
    if num_groups is not None and C % num_groups:
        raise ValueError(f"{name}: C={C} not divisible by {num_groups}")
    if not (0 < B <= _MAX_BATCH and 0 < N <= _MAX_ROWS and 0 < C // vec <= _MAX_CHUNKS):
        raise ValueError(f"{name}: shape {tuple(shape)} out of the kernels' range")
    mode = 0 if swish == 0 else 1 if swish == 1 else 2
    geo = launch_plan(B, N, C, vec, _sms(device))
    plan = _Plan(B=B, N=N, C=C, G=num_groups or 0, vec=vec, x_bf16=int(es == 2),
                 apply_splits=geo.apply_splits, apply_cw=geo.apply_cw,
                 apply_threads=geo.apply_threads,
                 bwd_cw=geo.bwd_cw, bwd_threads=geo.bwd_threads,
                 bwd_splits=geo.bwd_splits, bwd_apply_splits=geo.bwd_apply_splits,
                 swish_mode=mode, swish=swish)
    part = bwd = 0
    if num_groups is not None and params is not None:
        plan.param_bf16 = _param_bf16(params[0], "scale", device, 1, C)
        if _param_bf16(params[1], "bias", device, 1, C) != plan.param_bf16:
            raise TypeError("group_norm_stats: scale and bias must share a dtype")
        if film is not None:
            plan.film_bf16 = _param_bf16(film[0], "fs", device, B, C)
            plan.film_sb = film[0][3][0] if B > 1 else 0
            if _param_bf16(film[1], "fb", device, B, C) != plan.film_bf16 or (
                    B > 1 and film[1][3][0] != plan.film_sb):
                raise TypeError("group_norm_stats: fs and fb must share a dtype and strides")
    if num_groups is not None:
        plan.stats_splits, plan.stats_rows = geo.stats_splits, geo.stats_rows
        plan.stats_threads, plan.eps = geo.stats_threads, eps
        plan.cnt = float(N * (C // num_groups))
        plan.counter = _counters(device, stream).data_ptr()
        part = B * geo.stats_splits * num_groups * 2
        bwd = 7 * B * C + 3 * B * num_groups + part + 2 * B * geo.bwd_splits * C
    # k2_group_norm's scratch: a, b (b 16-byte aligned, since C % 4 == 0
    # where vec >= 4), then the per-block partials [B, splits, G, 2]
    return _Launch(ctypes.addressof(plan), plan, part, 2 * B * C + part, bwd)


def _norm_launch(x, scale, bias, film, num_groups, eps, swish, stream) -> _Launch:
    return _plan(x.dtype, x.device, x.shape, x.data_ptr() % 16, num_groups,
                 float(eps), float(swish), (_layout(scale), _layout(bias)),
                 None if film is None else (_layout(film[0]), _layout(film[1])),
                 stream)


def _film_ptrs(film):
    return (None, None) if film is None else (film[0].data_ptr(), film[1].data_ptr())


def group_norm_stats(x3, scale, bias, film, num_groups: int, eps: float):
    """K1: (a, b), each [B, C] fp32.  For a CPU tensor the plain version;
    for a CUDA tensor one launch of the CUDA kernel."""
    if x3.device.type == "cpu":
        return group_norm_stats_plain(x3, scale, bias, film, num_groups, eps)
    _check_cuda(x3, "group_norm_stats")
    stream = _stream(x3)
    launch = _norm_launch(x3, scale, bias, film, num_groups, eps, 0.0, stream)
    a, b = (torch.empty((x3.shape[0], x3.shape[2]), dtype=torch.float32,
                        device=x3.device) for _ in range(2))
    part = torch.empty(launch.part, dtype=torch.float32, device=x3.device)
    group_norm_stats.launches += 1
    err = _lib().k2_group_norm_stats(launch.ref, x3.data_ptr(), scale.data_ptr(),
                                     bias.data_ptr(), *_film_ptrs(film), a.data_ptr(),
                                     b.data_ptr(), part.data_ptr(), stream)
    check(err, "group_norm_stats kernel launch")
    return a, b


group_norm_stats.launches = 0


def _check_coef(t: torch.Tensor, x3: torch.Tensor, name: str) -> None:
    """a or b as K1 writes it and K2 reads it: [B, C] fp32, contiguous,
    16-byte aligned, on x's card."""
    if (t.device != x3.device or t.shape != (x3.shape[0], x3.shape[2])
            or t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"group_norm_apply: {name} must be a 16-byte aligned, "
                         f"contiguous [B, C] fp32 tensor on {x3.device}")


def group_norm_apply(x3, a, b, swish: float):
    """K2: y·sigmoid(swish·y) (y where swish is 0) of y = x·a + b, for any
    float swish.  For a CPU tensor the plain version; for a CUDA tensor one
    launch of the CUDA kernel."""
    if x3.device.type == "cpu":
        return group_norm_apply_plain(x3, a, b, swish)
    _check_cuda(x3, "group_norm_apply")
    launch = _plan(x3.dtype, x3.device, x3.shape, x3.data_ptr() % 16, None, None,
                   float(swish), None, None)
    _check_coef(a, x3, "a")
    _check_coef(b, x3, "b")
    y = torch.empty_like(x3)
    group_norm_apply.launches += 1
    err = _lib().k2_group_norm_apply(launch.ref, x3.data_ptr(), a.data_ptr(),
                                     b.data_ptr(), y.data_ptr(), _stream(x3))
    check(err, "group_norm_apply kernel launch")
    return y


group_norm_apply.launches = 0


def _norm_kernels(x, scale, bias, num_groups, eps, swish, film):
    """K1 then K2 in one foreign call, their coefficients in the call's
    own scratch; the plain versions for a CPU tensor.  Counts a launch of
    each."""
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, swish, film)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm: no kernel for device {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    stream = _stream(x)
    launch = _norm_launch(x, scale, bias, film, num_groups, eps, swish, stream)
    y = torch.empty_like(x)
    scratch = torch.empty(launch.scratch, dtype=torch.float32, device=x.device)
    group_norm_stats.launches += 1
    group_norm_apply.launches += 1
    err = _lib().k2_group_norm(launch.ref, x.data_ptr(), scale.data_ptr(),
                               bias.data_ptr(), *_film_ptrs(film), scratch.data_ptr(),
                               y.data_ptr(), stream)
    check(err, "group_norm kernel launch")
    return y


def group_norm_plain(x, scale, bias, num_groups: int, eps: float,
                     swish: float = 0.0, film=None):
    """The same function through the plain versions of K1 and K2, and
    differentiable by autograd: the backward target of ``GroupNormFunction``."""
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"group_norm: C={C} not divisible by {num_groups}")
    x3 = x.reshape(B, -1, C)
    a, b = group_norm_stats_plain(x3, scale, bias, film, num_groups, eps)
    return group_norm_apply_plain(x3, a, b, swish).reshape(x.shape)


_ALL_GRADS = (True,) * 5


def group_norm_backward_plain(gy, x, scale, bias, num_groups: int, eps: float,
                              swish: float = 0.0, film=None, needs=_ALL_GRADS):
    """The gradients of ``group_norm_plain`` in closed form, in plain
    PyTorch: (dx, dscale, dbias, dfs, dfb), each None where ``needs`` (x,
    scale, bias, fs, fb) asks for none or there is no FiLM, each in its
    input's dtype and shape.  Per batch row and group, with f = 1 + fs (1 without FiLM), w =
    scale·f, x̂ = (x − mean)·r and ĝ the output gradient through the
    activation: S = Σ ĝ and T = Σ ĝ·x̂ over the rows of each channel;
    dfb = S, dfs = scale·T + bias·S, dscale = Σ_b f·T, dbias = Σ_b f·S,
    dx = r·(w·ĝ − mean_g(w·S) − x̂·mean_g(w·T)) over the group's elements.
    x enters each product less its group's pivot, as in K1's sums, and
    the pre-activation too (a·(x − p) + b with b about the pivot), so that
    nothing cancels where a group's mean lies far from zero.  All in fp32;
    the function of B1 + B2."""
    needs = needs if film is not None else (*needs[:3], False, False)
    B, C = x.shape[0], x.shape[-1]
    G, cs = num_groups, C // num_groups
    x3 = x.reshape(B, -1, C)
    cnt = float(x3.shape[1] * cs)
    p, s1, s2 = group_norm_moments_plain(x3, G)
    m = s1.reshape(B, G, cs).sum(-1) / cnt  # each group's mean less its pivot
    var = torch.clamp(s2.reshape(B, G, cs).sum(-1) / cnt - m * m, min=0.0)
    r = torch.rsqrt(var + eps)
    a, b = _fold_affine(m, var, scale, bias, film, eps)  # y = a·(x − p) + b
    per_c = lambda t: t.repeat_interleave(cs, dim=-1)
    d = x3.float() - per_c(p)[:, None]
    g = gy.reshape(x3.shape).float()
    if swish:
        z = swish * (d * a[:, None] + b[:, None])
        sig = torch.sigmoid(z)
        g = g * sig * (1.0 + z * (1.0 - sig))
    S = g.sum(1)
    T = per_c(r) * ((g * d).sum(1) - per_c(m) * S)
    f = 1.0 if film is None else 1.0 + film[0].reshape(B, C).float()
    gamma, beta = scale.float(), bias.float()
    dx = dscale = dbias = dfs = dfb = None
    if needs[0]:
        A = (gamma * f * S).reshape(B, G, cs).sum(-1) / cnt
        Bg = (gamma * f * T).reshape(B, G, cs).sum(-1) / cnt
        kx, k0 = -r * r * Bg, r * (r * Bg * m - A)
        dx = a[:, None] * g + per_c(kx)[:, None] * d + per_c(k0)[:, None]
        dx = dx.to(x.dtype).reshape(x.shape)
    if needs[1]:
        dscale = (f * T).sum(0).to(scale.dtype).reshape(scale.shape)
    if needs[2]:
        dbias = (f * S).sum(0).to(bias.dtype).reshape(bias.shape)
    if needs[3]:
        dfs = (gamma * T + beta * S).to(film[0].dtype).reshape(film[0].shape)
    if needs[4]:
        dfb = S.to(film[1].dtype).reshape(film[1].shape)
    return dx, dscale, dbias, dfs, dfb


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def group_norm_backward(gy, x, scale, bias, num_groups: int, eps: float,
                        swish: float = 0.0, film=None, needs=_ALL_GRADS):
    """The gradients of ``group_norm`` (``group_norm_backward_plain``'s
    function and returns).  For a CPU tensor the plain version; for a CUDA
    tensor one foreign call (``k2_group_norm_backward``): K1's moments
    entry, counted as a K1 launch, then B1 and B2 (B2 only where dx is
    wanted), counted once here, and one sum over the batch of the affine
    pair's per-row partials where either is wanted.  x and gy: contiguous
    [B, ..., C] of one shape and dtype; raises for anything the kernels do
    not take."""
    if x.device.type == "cpu":
        return group_norm_backward_plain(gy, x, scale, bias, num_groups, eps, swish,
                                         film, needs)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_backward: no kernel for device {x.device}")
    if (gy.device != x.device or gy.shape != x.shape or gy.dtype != x.dtype
            or not x.is_contiguous() or not gy.is_contiguous()):
        raise ValueError("group_norm_backward: needs contiguous x and gy of one "
                         "shape and dtype on one card")
    stream = _stream(x)
    launch = _plan(x.dtype, x.device, x.shape, (x.data_ptr() | gy.data_ptr()) % 16,
                   num_groups, float(eps), float(swish), (_layout(scale), _layout(bias)),
                   None if film is None else (_layout(film[0]), _layout(film[1])),
                   stream)
    needs = needs if film is not None else (*needs[:3], False, False)
    B, C = x.shape[0], x.shape[-1]
    scratch = torch.empty(launch.bwd_scratch, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if needs[0] else None
    dfs, dfb = (None, None) if film is None else (
        torch.empty((B, C), dtype=f.dtype, device=x.device) if n else None
        for f, n in zip(film, needs[3:]))
    dgb = scratch[5 * B * C:7 * B * C] if needs[1] or needs[2] else None
    group_norm_stats.launches += 1
    group_norm_backward.launches += 1
    err = _lib().k2_group_norm_backward(
        launch.ref, x.data_ptr(), gy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        *_film_ptrs(film), scratch.data_ptr(), _ptr(dx), _ptr(dfs), _ptr(dfb), _ptr(dgb),
        stream)
    check(err, "group_norm_backward kernel launch")
    dscale = dbias = None
    if dgb is not None:
        sums = dgb.view(B, 2, C).sum(0)
        dscale = sums[0].to(scale.dtype).view(scale.shape) if needs[1] else None
        dbias = sums[1].to(bias.dtype).view(bias.shape) if needs[2] else None
    if film is not None:
        dfs, dfb = (None if t is None else t.view(f.shape) for t, f in zip((dfs, dfb), film))
    return dx, dscale, dbias, dfs, dfb


group_norm_backward.launches = 0


class GroupNormFunction(torch.autograd.Function):
    """K1 + K2 forward (their plain versions for CPU tensors), saving only
    the inputs; backward ``group_norm_backward`` on the saved inputs (K1's
    moments, B1 and B2 on the card; the plain closed form on the CPU).
    Gradients for x, scale, bias and the FiLM pair (fs, fb), each None
    where that input needs none."""

    @staticmethod
    def forward(ctx, x, scale, bias, fs, fb, num_groups, eps, swish):
        ctx.save_for_backward(x, scale, bias, fs, fb)
        ctx.config = (num_groups, eps, swish)
        film = None if fs is None else (fs, fb)
        return _norm_kernels(x, scale, bias, num_groups, eps, swish, film)

    @staticmethod
    def backward(ctx, gy):
        x, scale, bias, fs, fb = ctx.saved_tensors
        grads = group_norm_backward(gy.contiguous(), x.contiguous(), scale, bias,
                                    *ctx.config, film=None if fs is None else (fs, fb),
                                    needs=ctx.needs_input_grad[:5])
        return (*grads, None, None, None)


def group_norm(x, scale, bias, num_groups: int, eps: float, swish: float = 0.0,
               film=None):
    """GroupNorm over the last (channel) axis of x [B, ..., C], one-pass fp32
    moments shifted by each group's first element, optional FiLM ``film=(fs, fb)`` ([B, C] or [B, 1, 1, C]) and
    SiLU; output in x's dtype.  Routes to K1 + K2 through
    ``GroupNormFunction``, so it is differentiable on every device; with
    grad mode off (serving runs under ``inference_mode``) it calls them
    directly, since no graph is recorded there and ``Function.apply`` would
    only add host time to every call."""
    if not torch.is_grad_enabled():
        return _norm_kernels(x, scale, bias, num_groups, eps, swish, film)
    fs, fb = (None, None) if film is None else film
    return GroupNormFunction.apply(x, scale, bias, fs, fb, num_groups,
                                   float(eps), float(swish))


# --- row-sharded GroupNorm (parallel/spatial.py) -------------------------------


def group_moments_plain(x3: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1's moments in plain PyTorch: [B, G, 3] fp32, each group's pivot,
    Σ(x − p) and Σ(x − p)² over this tensor's rows."""
    p, s1, s2 = group_norm_moments_plain(x3, num_groups)
    B, C = s1.shape
    return torch.stack([p, s1.reshape(B, num_groups, -1).sum(-1),
                        s2.reshape(B, num_groups, -1).sum(-1)], dim=-1)


def group_norm_moments(x3: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1 on one shard: its groups' moments [B, G, 3] fp32 (pivot, Σ(x − p),
    Σ(x − p)²).  For a CPU tensor the plain version; for a CUDA tensor one
    launch of K1 (``k2_group_norm_moments``), counted as K1's."""
    if x3.device.type == "cpu":
        return group_moments_plain(x3, num_groups)
    _check_cuda(x3, "group_norm_moments")
    stream = _stream(x3)
    launch = _plan(x3.dtype, x3.device, x3.shape, x3.data_ptr() % 16, num_groups,
                   0.0, 0.0, None, None, stream)
    moments = torch.empty((x3.shape[0], num_groups, 3), dtype=torch.float32,
                          device=x3.device)
    part = torch.empty(launch.part, dtype=torch.float32, device=x3.device)
    group_norm_stats.launches += 1
    err = _lib().k2_group_norm_moments(launch.ref, x3.data_ptr(), moments.data_ptr(),
                                       part.data_ptr(), stream)
    check(err, "group_norm_moments kernel launch")
    return moments


def combine_moments(moments: torch.Tensor, cnt: float):
    """(mean, var), each [B, G] fp32, of the whole image from the shards'
    moments [n, B, G, 3], ``cnt`` elements a group on each shard.  The
    shards' pivots differ, so each shard's sums are first shifted to shard
    0's pivot (d = p_r − p_0, exact in fp32 for two values of one group
    within a factor 2 of each other):
    Σ(x − p_0) = S1 + cnt·d, Σ(x − p_0)² = S2 + 2·d·S1 + cnt·d²; then the
    single-device formula, in fp64."""
    m = moments.double()
    p, s1, s2 = m[..., 0], m[..., 1], m[..., 2]
    d = p - p[:1]
    total = cnt * m.shape[0]
    m1 = (s1 + cnt * d).sum(0) / total
    m2 = (s2 + 2.0 * d * s1 + cnt * d * d).sum(0) / total
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    return (p[0] + m1).float(), var.float()


def _sharded_forward(x, scale, bias, num_groups, eps, axis, swish, film):
    """K1's moments of the shard, gathered over the axis and combined, the
    folded coefficients, then K2.  Returns (y, each group's mean [B, G])."""
    from ..parallel.collectives import all_gather

    B, C = x.shape[0], x.shape[-1]
    x3 = x.reshape(B, -1, C).contiguous()
    moments = all_gather(group_norm_moments(x3, num_groups)[None], axis, dim=0)
    mean, var = combine_moments(moments, float(x3.shape[1] * (C // num_groups)))
    a, b = _fold_affine(mean, var, scale, bias, film, eps)
    y = group_norm_apply(x3, a.contiguous(), b.contiguous(), swish).reshape(x.shape)
    return y, mean


def sharded_group_norm_plain(x, scale, bias, num_groups: int, eps: float, axis,
                             swish: float, film, shift):
    """The row-sharded GroupNorm in plain PyTorch, differentiable by
    autograd: per-group sums of x − shift in fp32, ``psum``'d over the axis
    for the mean, then the centred second pass Σ(x − mean)², ``psum``'d for
    the variance, and the norm of the centred values times the affine and
    FiLM scales, plus their shifts, then SiLU.  ``shift`` [B, G] (detached)
    is any value near each group's mean: the forward's combined mean keeps
    the sums, and every product that the gradient takes, centred where the
    mean lies far from zero (folding the mean into a per-channel offset, as
    K2's x·a + b does, would cancel there).  The backward target of
    ``ShardedGroupNormFunction``: the ``psum``s' backward carries the
    cross-shard terms of the gradient."""
    from ..parallel.collectives import psum

    B, C = x.shape[0], x.shape[-1]
    G, cs = num_groups, C // num_groups
    xg = x.float().reshape(B, -1, G, cs) - shift.detach().float()[:, None, :, None]
    total = float(xg.shape[1] * cs * axis.size)
    m = psum(xg.sum(dim=(1, 3)), axis) / total
    xc = xg - m[:, None, :, None]
    var = psum((xc * xc).sum(dim=(1, 3)), axis) / total
    y = (xc * torch.rsqrt(var + eps)[:, None, :, None]).reshape(B, -1, C)
    y = y * scale.float() + bias.float()
    if film is not None:
        fs, fb = (f.reshape(B, 1, C).float() for f in film)
        y = y * (1.0 + fs) + fb
    if swish:
        y = y * torch.sigmoid(y * swish)
    return y.to(x.dtype).reshape(x.shape)


class ShardedGroupNormFunction(torch.autograd.Function):
    """The sharded GroupNorm: K1's moments entry on the shard, the gather
    and ``combine_moments``, then K2 (their plain versions for CPU
    tensors), saving the inputs and the combined means; backward through
    autograd of ``sharded_group_norm_plain`` on the saved inputs, as
    ``GroupNormFunction``'s.  Gradients for x, scale, bias and the FiLM
    pair, each None where that input needs none."""

    @staticmethod
    def forward(ctx, x, scale, bias, fs, fb, num_groups, eps, swish, axis):
        film = None if fs is None else (fs, fb)
        y, mean = _sharded_forward(x, scale, bias, num_groups, eps, axis, swish, film)
        ctx.save_for_backward(x, scale, bias, fs, fb, mean)
        ctx.config = (num_groups, eps, axis, swish)
        return y

    @staticmethod
    def backward(ctx, gy):
        *saved, mean = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        num_groups, eps, axis, swish = ctx.config
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, needs)]
            x, scale, bias, fs, fb = inputs
            y = sharded_group_norm_plain(x, scale, bias, num_groups, eps, axis, swish,
                                         None if fs is None else (fs, fb), shift=mean)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, gy) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None, None, None, None)


def sharded_group_norm(x, scale, bias, num_groups: int, eps: float, axis,
                       swish: float = 0.0, film=None):
    """GroupNorm of x [B, Hl, W, C], this rank's rows of an image sharded
    over ``axis`` (a ``parallel.mesh.MeshAxis``), with statistics over the
    whole image: K1's moments of the shard, all-gathered over the axis and
    combined (``combine_moments``), the coefficients folded in fp32, then
    K2.  The same function as ``group_norm`` of the unsharded image, and
    differentiable (``ShardedGroupNormFunction``); with grad mode off, or
    no input that needs a gradient, the kernels run directly."""
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"group_norm: C={C} not divisible by {num_groups}")
    fs, fb = (None, None) if film is None else film
    ins = [t for t in (x, scale, bias, fs, fb) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return ShardedGroupNormFunction.apply(x, scale, bias, fs, fb, num_groups,
                                              float(eps), float(swish), axis)
    return _sharded_forward(x, scale, bias, num_groups, eps, axis, swish, film)[0]
