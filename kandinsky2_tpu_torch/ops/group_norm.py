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

Gradients: ``GroupNormFunction`` is the counterpart of the ``custom_vjp``
of ``pallas_group_norm``.  Its forward is K1 + K2 and saves only the
inputs; its backward recomputes the norm in plain PyTorch
(``group_norm_plain``, the counterpart of ``_xla_reference``) and
differentiates that, as the JAX package differentiates its XLA
formulation.  The JAX package has no GroupNorm backward kernel, so neither
has the port.

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


class LaunchPlan(NamedTuple):
    """Both kernels' grids for one [B, N, C] shape at ``vec`` elements a
    load; each block is TY rows of a strip of chunks."""
    stats_threads: int
    stats_splits: int  # K1's grid is (stats_splits, B) ...
    stats_rows: int    # ... each block summing this many rows of C / vec chunks
    apply_threads: int
    apply_cw: int      # K2's strip, in chunks
    apply_splits: int  # K2's grid is (apply_splits * C / vec / apply_cw, B)


def launch_plan(B: int, N: int, C: int, vec: int, sms: int = 132) -> LaunchPlan:
    """The launch geometry of both kernels, from the shape and the card's
    number of SMs."""
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
    return LaunchPlan(threads, -(-N // rows), rows, athreads, cw, apply_splits)


class _Plan(ctypes.Structure):
    """``Plan`` of csrc/group_norm.cu: the same fields in the same order,
    checked against the library by ``_lib``."""
    _fields_ = (
        [(n, ctypes.c_longlong) for n in (
            "B", "N", "C", "G", "vec", "x_bf16",
            "stats_splits", "stats_rows", "stats_threads",
            "apply_splits", "apply_cw", "apply_threads", "swish_mode",
            "param_bf16", "film_bf16", "film_sb")]
        + [(n, ctypes.c_double) for n in ("eps", "cnt", "swish")]
        + [("counter", ctypes.c_void_p)])


class _Launch(NamedTuple):
    ref: int      # the _Plan's address, passed to the C entries
    plan: _Plan
    part: int     # floats of K1's partials, B * splits * G * 2
    scratch: int  # floats of k2_group_norm's scratch: a, b, then the partials


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("group_norm.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, n in (("k2_group_norm_stats", 10), ("k2_group_norm_apply", 6),
                    ("k2_group_norm", 9)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [P] * n, I
    lib.k2_group_norm_layout.argtypes, lib.k2_group_norm_layout.restype = [P, I], I
    want = [ctypes.sizeof(_Plan), _STATS_UNROLL, _APPLY_UNROLL, _MAX_CHUNKS] + [
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
    layouts of (scale, bias) and of (fs, fb) or None.  ``num_groups``
    None: a plan for K2 alone, which needs no counters."""
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
                 swish_mode=mode, swish=swish)
    part = 0
    if num_groups is not None:
        plan.param_bf16 = _param_bf16(params[0], "scale", device, 1, C)
        if _param_bf16(params[1], "bias", device, 1, C) != plan.param_bf16:
            raise TypeError("group_norm_stats: scale and bias must share a dtype")
        if film is not None:
            plan.film_bf16 = _param_bf16(film[0], "fs", device, B, C)
            plan.film_sb = film[0][3][0] if B > 1 else 0
            if _param_bf16(film[1], "fb", device, B, C) != plan.film_bf16 or (
                    B > 1 and film[1][3][0] != plan.film_sb):
                raise TypeError("group_norm_stats: fs and fb must share a dtype and strides")
        plan.stats_splits, plan.stats_rows = geo.stats_splits, geo.stats_rows
        plan.stats_threads, plan.eps = geo.stats_threads, eps
        plan.cnt = float(N * (C // num_groups))
        plan.counter = _counters(device, stream).data_ptr()
        part = B * geo.stats_splits * num_groups * 2
    # k2_group_norm's scratch: a, b (b 16-byte aligned, since C % 4 == 0
    # where vec >= 4), then the per-block partials [B, splits, G, 2]
    return _Launch(ctypes.addressof(plan), plan, part, 2 * B * C + part)


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


class GroupNormFunction(torch.autograd.Function):
    """K1 + K2 forward (their plain versions for CPU tensors), saving only
    the inputs; backward through autograd of ``group_norm_plain`` on the
    saved inputs.  Gradients for x, scale, bias and the FiLM pair (fs, fb),
    each None where that input needs none."""

    @staticmethod
    def forward(ctx, x, scale, bias, fs, fb, num_groups, eps, swish):
        ctx.save_for_backward(x, scale, bias, fs, fb)
        ctx.config = (num_groups, eps, swish)
        film = None if fs is None else (fs, fb)
        return _norm_kernels(x, scale, bias, num_groups, eps, swish, film)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, needs)]
            x, scale, bias, fs, fb = inputs
            y = group_norm_plain(x, scale, bias, *ctx.config,
                                 film=None if fs is None else (fs, fb))
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, gy) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None, None, None)


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
