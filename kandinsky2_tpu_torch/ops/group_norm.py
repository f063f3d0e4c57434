"""Fused GroupNorm(+FiLM)(+SiLU) over channels-last activations: two
kernels for Hopper, and the plain PyTorch version of each.

Replaces the Pallas TPU pair of ``kandinsky2_tpu/ops/group_norm.py``:

* K1 ``group_norm_stats`` replaces ``_moments`` (``_moments_kernel``) and
  the XLA glue ``_coefficients`` after it: one CUDA C++ launch
  (``csrc/group_norm.cu``) reads x [B, N, C] once, sums Σx and Σx² in fp32,
  finishes the cross-block reduction itself, and writes per-(b, c) fp32
  coefficients a, b with the group statistics (var = max(E[x²] − mean², 0),
  rsqrt(var + eps)), the affine scale/bias and the FiLM pair (1 + fs, fb)
  folded in.  Its source note gives the design and the bound.
* K2 ``group_norm_apply`` replaces ``_apply`` (``_apply_kernel``), a Triton
  kernel: y = silu?(x·a + b), cast back to x's dtype inside the kernel.

A GroupNorm on the card is those two launches.  Bound on the H100: both
kernels do a few flops per element, so they are bound by device-memory
bytes: K1 reads x once, K2 reads x and writes y once (2 reads + 1 write of
the activation in all, the floor for an exact normalisation that needs its
statistics before it can write).  K2 keeps every access a coalesced,
masked [BLOCK_N, BLOCK_C] tile along the contiguous channel axis.

K1's sums are taken in an order fixed by the shape, so its a and b are
bitwise repeatable; against the plain version they differ by fp32
summation order only, a relative error of about 1e-6·√N on the moments.

Gradients: ``GroupNormFunction`` is the counterpart of the ``custom_vjp``
of ``pallas_group_norm``.  Its forward is K1 + K2 and saves only the
inputs; its backward recomputes the norm in plain PyTorch
(``group_norm_plain``, the counterpart of ``_xla_reference``) and
differentiates that, as the JAX package differentiates its XLA
formulation.  The JAX package has no GroupNorm backward kernel, so neither
has the port.

Any C with C % groups == 0 is accepted (the TPU's C % 128 rule was a tiling
rule of the TPU), up to 1024 loads of a row for K1.  Triton is imported
only inside the launching function; the CUDA source is built at first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check, load_library

_APPLY_BLOCK_ELEMS = 8192
# K1's launch geometry (about two blocks per SM on the H100's 132);
# _STATS_UNROLL is UNROLL in csrc/group_norm.cu
_STATS_BLOCKS = 2 * 132
_STATS_UNROLL = 8
_STATS_MAX_CHUNKS = 1024
_MAX_BATCH = 4096
_counters: dict = {}


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def apply_kernel(x_ptr, a_ptr, b_ptr, y_ptr, N, C, SWISH: tl.constexpr,
                     BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        nb = tl.program_id(0)
        cb = tl.program_id(1)
        b = tl.program_id(2)
        rows = nb * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mask = (rows[:, None] < N) & cmask[None, :]
        offs = b.to(tl.int64) * N * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        xv = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        av = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        bv = tl.load(b_ptr + b * C + cols, mask=cmask, other=0.0)
        y = xv * av[None, :] + bv[None, :]
        if SWISH:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, apply_kernel


def _block_c(C: int) -> int:
    return min(128, 1 << max(4, (C - 1).bit_length()))


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous [B, N, C] tensor")


def group_norm_moments_plain(x3: torch.Tensor):
    """(Σx, Σx²) over N of x3 [B, N, C], each [B, C] fp32."""
    x32 = x3.float()
    return x32.sum(1), (x32 * x32).sum(1)


def _coefficients(s1, s2, cnt, scale, bias, film, g, eps):
    """Group-combine the moments and fold everything affine into per-channel
    a, b ([B, C] fp32)."""
    B, C = s1.shape
    cs = C // g
    mean_g = s1.reshape(B, g, cs).sum(-1) / cnt
    ex2_g = s2.reshape(B, g, cs).sum(-1) / cnt
    var_g = torch.clamp(ex2_g - mean_g * mean_g, min=0.0)
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
    """K1's function in plain PyTorch: the moments, then ``_coefficients``.
    Returns (a, b), each [B, C] fp32."""
    s1, s2 = group_norm_moments_plain(x3)
    cnt = float(x3.shape[1] * (x3.shape[2] // num_groups))
    return _coefficients(s1, s2, cnt, scale, bias, film, num_groups, eps)


def _vec(x3: torch.Tensor) -> int:
    """Elements per load: the widest of 16, 8, 4 or 2 bytes that C and the
    data pointer allow."""
    size = x3.element_size()
    vec = 16 // size
    while vec > 1 and (x3.shape[2] % vec or x3.data_ptr() % (vec * size)):
        vec //= 2
    return vec


def _param(t: torch.Tensor, name: str, B: int, C: int) -> int:
    """1 for a bf16 tensor, 0 for fp32, of C values ([C]) or B rows of C
    with a unit last stride (FiLM's [B, C] or [B, 1, 1, C]); raises for
    anything else."""
    if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_stats: {name} must be bf16 or fp32 on the card")
    if t.numel() != B * C or t.shape[-1] != C or t.stride(-1) != 1 or (
            B > 1 and t.shape[0] != B):
        raise ValueError(f"group_norm_stats: {name} must hold {B} rows of {C}")
    return int(t.dtype == torch.bfloat16)


def group_norm_stats(x3, scale, bias, film, num_groups: int, eps: float):
    """K1: (a, b), each [B, C] fp32.  For a CPU tensor the plain version;
    for a CUDA tensor one launch of the CUDA kernel."""
    if x3.device.type == "cpu":
        return group_norm_stats_plain(x3, scale, bias, film, num_groups, eps)
    _check_cuda(x3, "group_norm_stats")
    if x3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("group_norm_stats: the kernel takes bf16 or fp32 x")
    B, N, C = x3.shape
    if C % num_groups:
        raise ValueError(f"group_norm_stats: C={C} not divisible by {num_groups}")
    vec = _vec(x3)
    chunks = C // vec
    if chunks > _STATS_MAX_CHUNKS or B > _MAX_BATCH:
        raise ValueError(f"group_norm_stats: shape {tuple(x3.shape)} too wide")
    param_bf16 = _param(scale, "scale", 1, C)
    if _param(bias, "bias", 1, C) != param_bf16:
        raise TypeError("group_norm_stats: scale and bias must share a dtype")
    fs = fb = None
    film_sb, film_bf16 = 0, 0
    if film is not None:
        fs, fb = film
        film_bf16 = _param(fs, "fs", B, C)
        film_sb = fs.stride(0) if B > 1 else 0
        if _param(fb, "fb", B, C) != film_bf16 or (B > 1 and fb.stride(0) != film_sb):
            raise TypeError("group_norm_stats: fs and fb must share a dtype and strides")
    # rows of a split: a multiple of the block's rows times the unroll
    ty = 1 if chunks >= 256 else 256 // chunks
    gran = ty * _STATS_UNROLL
    splits = max(1, min(-(-N // gran), -(-_STATS_BLOCKS // B)))
    rows = -(-(-(-N // splits)) // gran) * gran
    splits = -(-N // rows)
    # one allocation: a, b, then the per-block partials (B * splits * G * 2)
    buf = torch.empty(2 * B * C + B * splits * num_groups * 2, dtype=torch.float32,
                      device=x3.device)
    a = buf[:B * C].view(B, C)
    b = buf[B * C:2 * B * C].view(B, C)
    counter = _counters.get(x3.device)
    if counter is None:
        counter = _counters[x3.device] = torch.zeros(
            _MAX_BATCH, dtype=torch.int32, device=x3.device)
    ptr = buf.data_ptr()
    group_norm_stats.launches += 1
    err = _stats_lib().k2_group_norm_stats(
        x3.data_ptr(), int(x3.dtype == torch.bfloat16), vec, B, N, C,
        num_groups, splits, rows, ptr + 8 * B * C, counter.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), param_bf16,
        None if fs is None else fs.data_ptr(), None if fb is None else fb.data_ptr(),
        film_sb, film_bf16, eps, float(N * (C // num_groups)),
        ptr, ptr + 4 * B * C, torch.cuda.current_stream(x3.device).cuda_stream,
    )
    check(err, "group_norm_stats kernel launch")
    return a, b


group_norm_stats.launches = 0


def _stats_lib():
    lib = load_library("group_norm.cu")
    fn = lib.k2_group_norm_stats
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, I, I, I, I, P, P, P, P, I, P, P,
                       ctypes.c_longlong, I, ctypes.c_float, ctypes.c_float,
                       P, P, P]
        fn.restype = I
    return lib


def group_norm_apply_plain(x3, a, b, swish: float):
    """silu?(x·a + b) in fp32, cast to x's dtype; a, b [B, C] fp32."""
    y = x3.float() * a[:, None, :] + b[:, None, :]
    if swish:
        y = y * torch.sigmoid(y * swish)
    return y.to(x3.dtype)


def group_norm_apply(x3, a, b, swish: float):
    """K2.  For a CPU tensor the plain version; for a CUDA tensor the Triton
    kernel."""
    if x3.device.type == "cpu":
        return group_norm_apply_plain(x3, a, b, swish)
    _check_cuda(x3, "group_norm_apply")
    if swish not in (0.0, 1.0):
        raise ValueError("group_norm_apply: the kernel takes swish 0 or 1")
    triton, apply_kernel = _triton_kernels()
    B, N, C = x3.shape
    block_c = _block_c(C)
    block_n = _APPLY_BLOCK_ELEMS // block_c
    a = a.float().contiguous()
    b = b.float().contiguous()
    y = torch.empty_like(x3)
    group_norm_apply.launches += 1
    apply_kernel[(triton.cdiv(N, block_n), triton.cdiv(C, block_c), B)](
        x3, a, b, y, N, C, SWISH=bool(swish),
        BLOCK_N=block_n, BLOCK_C=block_c, num_warps=4,
    )
    return y


group_norm_apply.launches = 0


def _norm(x, scale, bias, num_groups, eps, swish, film, stats, apply):
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"group_norm: C={C} not divisible by {num_groups}")
    x3 = x.reshape(B, -1, C)
    if not x3.is_contiguous():
        x3 = x3.contiguous()
    a, b = stats(x3, scale, bias, film, num_groups, eps)
    return apply(x3, a, b, swish).reshape(x.shape)


def group_norm_plain(x, scale, bias, num_groups: int, eps: float,
                     swish: float = 0.0, film=None):
    """The same function through the plain versions of K1 and K2, and
    differentiable by autograd: the backward target of ``GroupNormFunction``."""
    return _norm(x, scale, bias, num_groups, eps, swish, film,
                 group_norm_stats_plain, group_norm_apply_plain)


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
        return _norm(x, scale, bias, num_groups, eps, swish, film,
                     group_norm_stats, group_norm_apply)

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
    moments, optional FiLM ``film=(fs, fb)`` ([B, C] or [B, 1, 1, C]) and
    SiLU; output in x's dtype.  Routes to K1 + K2 through
    ``GroupNormFunction``, so it is differentiable on every device; with
    grad mode off (serving runs under ``inference_mode``) it calls them
    directly, since no graph is recorded there and ``Function.apply`` would
    only add host time to every call."""
    if not torch.is_grad_enabled():
        return _norm(x, scale, bias, num_groups, eps, swish, film,
                     group_norm_stats, group_norm_apply)
    fs, fb = (None, None) if film is None else film
    return GroupNormFunction.apply(x, scale, bias, fs, fb, num_groups,
                                   float(eps), float(swish))
