"""Flash attention, forward and backward: the hand-written Hopper kernels,
their plain PyTorch versions, and the autograd Function that joins them.

Replaces ``kandinsky2_tpu/ops/flash_attention.py``:

* K3 ``flash_attention_fwd`` replaces ``_flash_bhd`` (``_flash_kernel``):
  O and the per-row log-sum-exp.  Source ``csrc/flash_attention.cu``.
* K5 ``flash_attention_bwd_dq`` and K4 ``flash_attention_bwd_dkv`` replace
  ``_flash_bwd_bhd`` (``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``): dQ from the saved LSE, with delta =
  rowsum(dO·O) computed in K5's prologue, then dK and dV from LSE and
  that delta.  Same source, ``wgmma`` + TMA as the forward.
* ``FlashAttentionFunction`` is the counterpart of the ``custom_vjp`` of
  the JAX ``flash_attention``: the forward saves q, k, v, O and LSE, the
  backward runs K5 and K4.

The CUDA source's header note says how each kernel is laid out, what
bounds it on the H100 and how it handles ragged T and S.  At d = 64 the
kernels read q, k, v and dO through TMA tensor maps built from their
strides, so the UNet's q (a strided view of the fused qkv projection) is
read in place; a tensor TMA cannot address is made contiguous first.

``flash_attention(q, k, v)`` takes q [B, T, H, d] and k, v [B, S, H, d]
(the JAX package's layout) and returns (o [B, T, H, d], lse [B*H, T] fp32),
differentiable in q, k and v.  For CPU tensors both directions run the
plain versions; for CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import check, load_library

SUPPORTED_HEAD_DIMS = (64, 512)
BACKWARD_HEAD_DIMS = (64,)


def flash_attention_plain(q, k, v):
    """softmax(q kᵀ/√d) v with fp32 logits, softmax and accumulation, as the
    Pallas kernel computes it.  Returns (o in q's dtype, lse [B*H, T])."""
    B, T, H, d = q.shape
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf * (1.0 / math.sqrt(d)), kf.transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    return o.permute(0, 2, 1, 3).to(q.dtype), lse.reshape(B * H, T)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """(dq, dk, dv) of ``flash_attention_plain`` from the saved O and LSE, in
    fp32 matmuls: P = exp(scale·q kᵀ − LSE), dS = P ⊙ (dO vᵀ − rowsum(dO·O))
    · scale, as ``_flash_bwd_bhd`` computes it.  Gradients in q's dtype."""
    B, T, H, d = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, dof = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    back = lambda x, L: x.permute(0, 2, 1, 3).to(q.dtype).reshape(B, L, H, d)
    return back(dq, T), back(dk, S), back(dv, S)


def _kernel_ok(x: torch.Tensor) -> bool:
    """Whether the kernels (and TMA, which needs 16-byte aligned rows and
    positive strides of whole 16-byte units) can read ``x`` in place."""
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        s > 0 and s % 8 == 0 for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n > 1
    )


def _bhl(x: torch.Tensor):
    """Element strides (batch, head, row) of a [B, L, H, d] tensor.  A dim of
    size 1 is never stepped over, so it gets its contiguous stride, whatever
    the view says."""
    B, L, H, d = x.shape
    dense = (L * H * d, H * d, d)
    st = [s if n > 1 else c for n, s, c in zip(x.shape, x.stride(), dense)]
    return st[0], st[2], st[1]


def _check_qkv(name: str, q, k, v, head_dims):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    B, T, H, d = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, d) or v.shape != (B, S, H, d):
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 q, k, v")
    if d not in head_dims:
        raise ValueError(f"{name}: head dim {d} not built (have {head_dims})")
    return B, T, S, H, d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K3: (o, lse) of non-causal, unmasked attention.  For a CPU tensor the
    plain version; for a CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    B, T, S, H, d = _check_qkv("flash_attention_fwd", q, k, v, SUPPORTED_HEAD_DIMS)
    q, k, v = (x if _kernel_ok(x) else x.contiguous() for x in (q, k, v))
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*_bhl(q), *_bhl(k), *_bhl(v), *_bhl(o))
    lib = _lib("k2_flash_fwd_bf16", 5)
    flash_attention_fwd.launches += 1
    err = lib.k2_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, T, S, d, strides, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "flash_attention_fwd kernel launch")
    return o, lse


flash_attention_fwd.launches = 0


def _launch_bwd(wrapper, entry: str, ins, lse, delta, outs, dims):
    """Launch K5 or K4 on the card and count the launch on ``wrapper``:
    ``ins`` and ``outs`` are the entry point's bf16 [B, L, H, d] tensors in
    its order, ``lse`` and ``delta`` its [B*H, T] fp32 ones (delta K5's
    output, K4's input)."""
    B, T, S, H, d = dims
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (B * H, T) or x.dtype != torch.float32 or x.device != ins[0].device:
            raise ValueError(f"{entry}: {name} must be fp32 [B*H, T] on q's device")
    strides = (ctypes.c_longlong * 18)(*(s for x in ins + outs for s in _bhl(x)))
    wrapper.launches += 1
    err = getattr(_lib(entry, 8), entry)(
        *(x.data_ptr() for x in ins + [lse, delta] + outs), B, H, T, S, d, strides,
        torch.cuda.current_stream(ins[0].device).cuda_stream,
    )
    check(err, f"{entry} kernel launch")


def _bwd_inputs(entry: str, q, k, v, *rest):
    """Check the backward's bf16 inputs (the rest shaped like q) and make
    any that TMA cannot read in place contiguous."""
    dims = _check_qkv(entry, q, k, v, BACKWARD_HEAD_DIMS)
    if any(x.shape != q.shape or x.dtype != torch.bfloat16 for x in rest):
        raise ValueError(f"{entry}: dO and O must be bfloat16 of q's shape")
    return dims, [x if _kernel_ok(x) else x.contiguous() for x in (q, k, v, *rest)]


def flash_attention_bwd_dq(q, k, v, o, do, lse):
    """K5 on the card: (dq [B, T, H, d], delta [B*H, T] fp32), delta =
    rowsum(dO·O) computed in the kernel for K4."""
    dims, (q, k, v, o, do) = _bwd_inputs("k2_flash_bwd_dq_bf16", q, k, v, o, do)
    B, T, S, H, d = dims
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch_bwd(flash_attention_bwd_dq, "k2_flash_bwd_dq_bf16", [q, k, v, o, do],
                lse.contiguous(), delta, [dq], dims)
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta):
    """K4 on the card: (dk, dv), each [B, S, H, d], from K5's delta."""
    dims, (q, k, v, do) = _bwd_inputs("k2_flash_bwd_dkv_bf16", q, k, v, do)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch_bwd(flash_attention_bwd_dkv, "k2_flash_bwd_dkv_bf16", [q, k, v, do],
                lse.contiguous(), delta.contiguous(), [dk, dv], dims)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of ``flash_attention_fwd``.  For CPU tensors the plain
    version; for CUDA tensors K5 (dq and delta = rowsum(dO·O)), then K4 on
    the same stream (``_flash_bwd`` of the JAX package)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd for flash attention: K3 forward saving (q, k, v, o, lse);
    K5 + K4 backward (plain versions for CPU tensors).  LSE is an output
    without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Non-causal, unmasked attention with gradients.  See the module
    docstring.  With grad mode off (serving runs under ``inference_mode``)
    it launches the forward directly: no graph is recorded there, and
    ``Function.apply`` would only add host time to every call."""
    if not torch.is_grad_enabled():
        return flash_attention_fwd(q, k, v)
    return FlashAttentionFunction.apply(q, k, v)


def _lib(entry: str, n_ptrs: int):
    """The kernels' library with ``entry`` bound: ``n_ptrs`` pointers, five
    ints (B, H, T, S, d), the strides and the stream."""
    lib = load_library("flash_attention.cu")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib
