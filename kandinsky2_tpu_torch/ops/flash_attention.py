"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces ``kandinsky2_tpu/ops/flash_attention.py`` (``_flash_kernel``, the
Pallas forward launched by ``_flash_bhd``).  The CUDA source is
``csrc/flash_attention.cu``; its header note says how the kernel is laid
out, what bounds it on the H100 and how it handles d = 512.

``flash_attention(q, k, v)`` takes q [B, T, H, d] and k, v [B, S, H, d]
(the JAX package's layout) and returns (o [B, T, H, d], lse [B*H, T] fp32).
For a CPU tensor it runs ``flash_attention_plain``; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import check, load_library

SUPPORTED_HEAD_DIMS = (64, 512)


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


def _kernel_ok(x: torch.Tensor) -> bool:
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in x.stride()[:-1]
    )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Non-causal, unmasked attention.  See the module docstring."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    B, T, H, d = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, d) or v.shape != (B, S, H, d):
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention: the CUDA kernel takes bfloat16 q, k, v")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {d} not built (have {SUPPORTED_HEAD_DIMS})"
        )
    q, k, v = (x if _kernel_ok(x) else x.contiguous() for x in (q, k, v))
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    # element strides as (batch, head, row) for each [B, L, H, d] tensor
    bhl = lambda x: (x.stride(0), x.stride(2), x.stride(1))
    strides = (ctypes.c_longlong * 12)(*bhl(q), *bhl(k), *bhl(v), *bhl(o))
    lib = _lib()
    flash_attention.launches += 1
    err = lib.k2_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, T, S, d, strides, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "flash_attention kernel launch")
    return o, lse


flash_attention.launches = 0


def _lib():
    lib = load_library("flash_attention.cu")
    fn = lib.k2_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib
