"""Fused GroupNorm(+FiLM)(+SiLU) over channels-last activations: two Triton
kernels for Hopper, and the plain PyTorch version of each.

Replaces the Pallas TPU pair of ``kandinsky2_tpu/ops/group_norm.py``:

* K1 ``group_norm_moments`` replaces ``_moments`` (``_moments_kernel``):
  one pass over x [B, N, C] giving per-(b, c) Σx and Σx² in fp32.
* K2 ``group_norm_apply`` replaces ``_apply`` (``_apply_kernel``):
  y = silu?(x·a + b) with per-(b, c) fp32 coefficients, cast back to x's
  dtype inside the kernel.

Between them, ``_coefficients`` is plain PyTorch on [B, C] tensors, as it is
XLA glue in the JAX package: group combine, var = max(E[x²] − mean², 0),
rsqrt(var + eps), and the fold of the affine scale/bias and of the FiLM
pair (1 + fs, fb) into a and b.

Bound on the H100: both kernels do a few flops per element, so they are
bound by device-memory bytes: K1 reads x once, K2 reads x and writes y once
(2 reads + 1 write of the activation in all, the floor for an exact
normalisation that needs its statistics before it can write).  The design
keeps every access a coalesced, masked [BLOCK_N, BLOCK_C] tile along the
contiguous channel axis, and launches enough programs to fill the 132 SMs:
K1 splits the N axis into up to ``_MOMENT_PROGRAMS`` / (B·C/BLOCK_C) row
ranges.

Cross-block reduction: K1 writes one fp32 partial sum per (b, row range, c)
and the partials are summed in the glue (a second pass over a [B, splits, C]
tensor), never with atomics.  The result is deterministic; against the
plain version it differs only by fp32 summation order, a relative error of
about 1e-6·√N on the moments, well inside the bf16 tolerance that the
comparisons on the card state.

Gradients: ``GroupNormFunction`` is the counterpart of the ``custom_vjp``
of ``pallas_group_norm``.  Its forward is K1 + ``_coefficients`` + K2 and
saves only the inputs; its backward recomputes the norm in plain PyTorch
(``group_norm_plain``, the counterpart of ``_xla_reference``) and
differentiates that, as the JAX package differentiates its XLA
formulation.  The JAX package has no GroupNorm backward kernel, so neither
has the port.

Any C with C % groups == 0 is accepted (the TPU's C % 128 rule was a tiling
rule of the TPU).  Triton is imported only inside the launching functions.
"""

from __future__ import annotations

import functools

import torch

_MOMENT_PROGRAMS = 1024
_MOMENT_BLOCK_N = 32
_APPLY_BLOCK_ELEMS = 8192


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def moments_kernel(x_ptr, s1_ptr, s2_ptr, N, C, rows_per_split,
                       BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        cb = tl.program_id(1)
        sp = tl.program_id(2)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        n_start = sp * rows_per_split
        n_end = tl.minimum(n_start + rows_per_split, N)
        base = x_ptr + b.to(tl.int64) * N * C
        acc1 = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
        for n0 in range(n_start, n_end, BLOCK_N):
            rows = n0 + tl.arange(0, BLOCK_N)
            mask = (rows[:, None] < n_end) & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * C + cols[None, :]
            xv = tl.load(base + offs, mask=mask, other=0.0).to(tl.float32)
            acc1 += xv
            acc2 += xv * xv
        out = (b * tl.num_programs(2) + sp).to(tl.int64) * C + cols
        tl.store(s1_ptr + out, tl.sum(acc1, axis=0), mask=cmask)
        tl.store(s2_ptr + out, tl.sum(acc2, axis=0), mask=cmask)

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

    return triton, moments_kernel, apply_kernel


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


def group_norm_moments(x3: torch.Tensor):
    """K1.  For a CPU tensor the plain version; for a CUDA tensor the Triton
    kernel, whose per-range partials are summed here."""
    if x3.device.type == "cpu":
        return group_norm_moments_plain(x3)
    _check_cuda(x3, "group_norm_moments")
    triton, moments_kernel, _ = _triton_kernels()
    B, N, C = x3.shape
    block_c = _block_c(C)
    ncb = triton.cdiv(C, block_c)
    max_splits = triton.cdiv(N, _MOMENT_BLOCK_N)
    splits = max(1, min(max_splits, triton.cdiv(_MOMENT_PROGRAMS, B * ncb)))
    rows = triton.cdiv(triton.cdiv(N, splits), _MOMENT_BLOCK_N) * _MOMENT_BLOCK_N
    splits = triton.cdiv(N, rows)
    s1 = torch.empty((B, splits, C), dtype=torch.float32, device=x3.device)
    s2 = torch.empty_like(s1)
    group_norm_moments.launches += 1
    moments_kernel[(B, ncb, splits)](
        x3, s1, s2, N, C, rows,
        BLOCK_N=_MOMENT_BLOCK_N, BLOCK_C=block_c, num_warps=4,
    )
    return s1.sum(1), s2.sum(1)


group_norm_moments.launches = 0


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
    triton, _, apply_kernel = _triton_kernels()
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


def _norm(x, scale, bias, num_groups, eps, swish, film, moments, apply):
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"group_norm: C={C} not divisible by {num_groups}")
    x3 = x.reshape(B, -1, C)
    if not x3.is_contiguous():
        x3 = x3.contiguous()
    s1, s2 = moments(x3)
    cnt = float(x3.shape[1] * (C // num_groups))
    a, b = _coefficients(s1, s2, cnt, scale, bias, film, num_groups, eps)
    return apply(x3, a, b, swish).reshape(x.shape)


def group_norm_plain(x, scale, bias, num_groups: int, eps: float,
                     swish: float = 0.0, film=None):
    """The same function through the plain versions of K1 and K2, and
    differentiable by autograd: the backward target of ``GroupNormFunction``."""
    return _norm(x, scale, bias, num_groups, eps, swish, film,
                 group_norm_moments_plain, group_norm_apply_plain)


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
                     group_norm_moments, group_norm_apply)

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
                     group_norm_moments, group_norm_apply)
    fs, fb = (None, None) if film is None else film
    return GroupNormFunction.apply(x, scale, bias, fs, fb, num_groups,
                                   float(eps), float(swish))
