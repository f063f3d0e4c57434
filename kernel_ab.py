#!/usr/bin/env python3
"""Time this tree's flash backward (K5 + K4), flash forward (K3) and
GroupNorm kernels (K1, K2) against another commit's, in one process on one
NVIDIA GPU.

    python3 kernel_ab.py OTHER_DIR

OTHER_DIR is an unpacked ``git archive`` of the commit to compare against
(the parent of a change, or a variant of this tree).  Its
``kandinsky2_tpu_torch`` package is imported under another name, so both
versions live in one process, and its kernels are built from its own
sources.  Every pair is timed in turns (other, this, this, other):

* the whole flash backward, ``flash_attention_bwd`` (delta, K5 and K4), at
  the decoder training step's three UNet attention shapes: device ms, each
  version checked against ``flash_attention_bwd_plain`` first; then K5 and
  K4 alone, and host us per backward call at the smallest shape;
* the flash forward at the 768² text2img path's shapes: device ms, each
  version checked against the plain version first;
* GroupNorm at the path's shapes, under ``inference_mode``: device ms of
  the statistics (K1), of the apply kernel (K2, with SiLU; each version
  checked against ``group_norm_apply_plain`` first) and of the whole op
  with FiLM and SiLU, each call on the next of copies of x that together
  exceed four L2s (``chip_smoke.cold_copies``), so that x comes from
  device memory; K2 also on one x, which stays in L2 as after K1 on the
  path; beside K2, the floor of a kernel of its kind, timed in turns:
  PyTorch's ``copy_`` of the same bytes from the copies and an empty
  launch (``torch.cuda._sleep(0)``); and at the UNet's ds8 shape, where
  the device keeps up with the host, host us per call of the whole op, of
  K1 and of K2;
* host us per flash forward call;
* GroupNorm's backward at the decoder training step's batch-32 shapes (the
  UNet21's ds1 to ds8 and its fp32 output head), with FiLM, SiLU and every
  gradient: device ms of the whole autograd backward through each tree's
  ``group_norm`` (in turns), of this tree's ``group_norm_backward`` alone
  (K1's moments, B1, B2 and the affine sum; checked against
  ``group_norm_backward_plain`` first), of the plain closed form, and, as a
  yardstick only, of ``torch.ops.aten.native_group_norm_backward`` on an
  NCHW copy (no FiLM or SiLU), beside the bound: x and gy read once and dx
  written once over 3.35 TB/s.  x and gy come from copies that together
  exceed four L2s.

Prints one line per measurement, after the card's name and power limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

from chip_smoke import PEAK_BYTES, check, cold_copies, cuda_ms, host_us, smi_line


def turns(fns: dict, measure) -> dict:
    """Each measurement of the two functions in turns (a, b, b, a), averaged."""
    (na, fa), (nb, fb) = fns.items()
    a1, b1, b2, a2 = measure(fa), measure(fb), measure(fb), measure(fa)
    return {na: (a1 + a2) / 2, nb: (b1 + b2) / 2}


def main(argv) -> int:
    import torch

    from kandinsky2_tpu_torch.ops import flash_attention as fa
    from kandinsky2_tpu_torch.ops import group_norm as gn

    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve() / "kandinsky2_tpu_torch"
    print(f"card: {smi_line()}; other tree {argv[1]}")
    spec = importlib.util.spec_from_file_location(
        "other_k2", other / "__init__.py", submodule_search_locations=[str(other)])
    sys.modules["other_k2"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["other_k2"])
    ofa = importlib.import_module("other_k2.ops.flash_attention")
    ogn = importlib.import_module("other_k2.ops.group_norm")
    other_fwd = ofa.flash_attention_fwd

    g = torch.Generator(device="cuda").manual_seed(21)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def kernels_of(mod, q, k, v, o, lse, do):
        """(K5, K4) of a tree as functions of no arguments."""
        delta = mod.flash_attention_bwd_dq(q, k, v, o, do, lse)[1]
        return (lambda: mod.flash_attention_bwd_dq(q, k, v, o, do, lse),
                lambda: mod.flash_attention_bwd_dkv(q, k, v, do, lse, delta))

    trees = {"other": ofa, "this": fa}
    for label, (B, T, S, H) in [("unet ds2", (1, 2304, 2391, 12)),
                                ("unet ds4", (1, 576, 663, 18)),
                                ("unet ds8/middle", (1, 144, 231, 24))]:
        q, k, v, do = randn(B, T, H, 64), randn(B, S, H, 64), randn(B, S, H, 64), \
            randn(B, T, H, 64)
        o, lse = fa.flash_attention_fwd(q, k, v)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        for name, mod in trees.items():
            for grad, want in zip(mod.flash_attention_bwd(q, k, v, o, lse, do), ref):
                err = (grad.float() - want.float()).abs().max().item()
                check(err <= 2e-2 * want.float().abs().max().item(),
                      f"{name} backward wrong at {label}")
        tb = turns({n: (lambda m=m: m.flash_attention_bwd(q, k, v, o, lse, do))
                    for n, m in trees.items()}, lambda fn: cuda_ms(fn, 10))
        k5 = {n: kernels_of(m, q, k, v, o, lse, do) for n, m in trees.items()}
        t5 = turns({n: f[0] for n, f in k5.items()}, lambda fn: cuda_ms(fn, 10))
        t4 = turns({n: f[1] for n, f in k5.items()}, lambda fn: cuda_ms(fn, 10))
        print(f"backward {label} B={B} T={T} S={S} H={H} d=64: whole other "
              f"{tb['other']:.4f} ms, this {tb['this']:.4f} ms; K5 other "
              f"{t5['other']:.4f} ms, this {t5['this']:.4f} ms; K4 other "
              f"{t4['other']:.4f} ms, this {t4['this']:.4f} ms")
        if label == "unet ds8/middle":  # the device keeps up with the host here
            th = turns({n: (lambda m=m: m.flash_attention_bwd(q, k, v, o, lse, do))
                        for n, m in trees.items()}, host_us)
            print(f"backward host per call {label}: other {th['other']:.1f} us, "
                  f"this {th['this']:.1f} us")
        del q, k, v, do, o, lse, ref

    for label, (B, T, S, H, d) in [
        ("unet ds2", (2, 2304, 2391, 12, 64)), ("unet ds4", (2, 576, 663, 18, 64)),
        ("unet ds8/middle", (2, 144, 231, 24, 64)), ("movq attn", (1, 9216, 9216, 1, 512)),
    ]:
        q, k, v = randn(B, T, H, d), randn(B, S, H, d), randn(B, S, H, d)
        o_ref = fa.flash_attention_plain(q, k, v)[0].float()
        for name, fn in (("other", other_fwd), ("this", fa.flash_attention_fwd)):
            err = (fn(q, k, v)[0].float() - o_ref).abs().max().item()
            check(err <= 2e-2 * o_ref.abs().max().item(), f"{name} K3 wrong at {label}")
        t = turns({"other": lambda: other_fwd(q, k, v),
                   "this": lambda: fa.flash_attention_fwd(q, k, v)},
                  lambda fn: cuda_ms(fn, 10))
        print(f"K3 {label} B={B} T={T} S={S} H={H} d={d}: other {t['other']:.4f} ms, "
              f"this {t['this']:.4f} ms")
        del q, k, v, o_ref

    bf16, fp32 = torch.bfloat16, torch.float32
    norm_shapes = [
        ("unet ds1", (2, 96, 96, 384), bf16), ("unet ds2", (2, 48, 48, 768), bf16),
        ("unet ds4", (2, 24, 24, 1152), bf16), ("unet ds8", (2, 12, 12, 1536), bf16),
        ("unet ds8 skip-concat", (2, 12, 12, 3072), bf16),
        ("unet out.0 fp32", (2, 96, 96, 384), fp32), ("movq latent", (1, 96, 96, 512), bf16),
        ("movq 768^2", (1, 768, 768, 128), bf16),
    ]
    norms = {"other": ogn, "this": gn}
    with torch.inference_mode():
        for label, shape, dtype in norm_shapes:
            B, C = shape[0], shape[-1]
            x = randn(*shape).to(dtype)
            x3 = x.reshape(B, -1, C)
            scale, bias = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
            film = randn(B, 1, 1, 2 * C).chunk(2, dim=-1)
            a, b = gn.group_norm_stats(x3, scale, bias, film, 32, 1e-5)
            want = gn.group_norm_apply_plain(x3, a, b, 1.0).float()
            tol = (1e-5 if dtype == fp32 else 2 ** -7) * max(1.0, want.abs().max().item())
            for name, mod in norms.items():
                err = (mod.group_norm_apply(x3, a, b, 1.0).float() - want).abs().max().item()
                check(err <= tol, f"{name} K2 wrong at {label}")
            xs = cold_copies(x)
            x3s = lambda: xs().view(x3.shape)
            stats = {n: (lambda m=m: m.group_norm_stats(x3s(), scale, bias, film, 32, 1e-5))
                     for n, m in norms.items()}
            apply = {n: (lambda m=m: m.group_norm_apply(x3s(), a, b, 1.0))
                     for n, m in norms.items()}
            warm = {n: (lambda m=m: m.group_norm_apply(x3, a, b, 1.0))
                    for n, m in norms.items()}
            op = {n: (lambda m=m: m.group_norm(xs(), scale, bias, 32, 1e-5, 1.0, film))
                  for n, m in norms.items()}
            ts = turns(stats, lambda fn: cuda_ms(fn, 10))
            t2 = turns(apply, lambda fn: cuda_ms(fn, 20))
            t2w = turns(warm, lambda fn: cuda_ms(fn, 20))
            to = turns(op, lambda fn: cuda_ms(fn, 10))
            y = torch.empty_like(x3)
            tf = turns({"copy": lambda: y.copy_(x3s()),
                        "empty": lambda: torch.cuda._sleep(0)}, lambda fn: cuda_ms(fn, 20))
            print(f"GroupNorm {label} {list(shape)} {str(dtype)[6:]} FiLM SiLU: K1 other "
                  f"{ts['other']:.4f} ms, this {ts['this']:.4f} ms; K2 other "
                  f"{t2['other']:.4f} ms, this {t2['this']:.4f} ms (floor: copy_ "
                  f"{tf['copy']:.4f} ms, empty launch {tf['empty']:.4f} ms); K2 on x "
                  f"in L2 other {t2w['other']:.4f} ms, this {t2w['this']:.4f} ms; whole "
                  f"op other {to['other']:.4f} ms, this {to['this']:.4f} ms")
            if label == "unet ds8 skip-concat":  # the device keeps up with the host here
                # on one x: the copies' hand-out would add to the host's time
                th = turns({n: (lambda m=m: m.group_norm(x, scale, bias, 32, 1e-5, 1.0, film))
                            for n, m in norms.items()}, host_us)
                ths = turns({n: (lambda m=m: m.group_norm_stats(x3, scale, bias, film, 32,
                                                                1e-5))
                             for n, m in norms.items()}, host_us)
                th2 = turns(warm, host_us)
                print(f"GroupNorm {label} host per call: whole op other "
                      f"{th['other']:.1f} us, this {th['this']:.1f} us; K1 other "
                      f"{ths['other']:.1f} us, this {ths['this']:.1f} us; K2 other "
                      f"{th2['other']:.1f} us, this {th2['this']:.1f} us")

        q, k, v = randn(2, 144, 24, 64), randn(2, 231, 24, 64), randn(2, 231, 24, 64)
        th = turns({"other": lambda: other_fwd(q, k, v),
                    "this": lambda: fa.flash_attention_fwd(q, k, v)}, host_us)
        print(f"K3 host per call B 2 T 144 S 231 H 24: other {th['other']:.1f} us, "
              f"this {th['this']:.1f} us")
    torch.cuda.synchronize()
    group_norm_backward_rows(torch, gn, norms, randn)
    return 0


def group_norm_backward_rows(torch, gn, norms, randn) -> None:
    """The GroupNorm backward's rows at the decoder training step's batch-32
    shapes (see the module's docstring)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    for label, shape, dtype in [
        ("unet ds1", (32, 96, 96, 384), bf16), ("unet ds2", (32, 48, 48, 768), bf16),
        ("unet ds4", (32, 24, 24, 1152), bf16), ("unet ds8", (32, 12, 12, 1536), bf16),
        ("unet out.0 fp32", (32, 96, 96, 384), fp32),
    ]:
        B, C = shape[0], shape[-1]
        x, gy = randn(*shape).to(dtype), randn(*shape).to(dtype)
        scale = 1 + 0.1 * torch.randn(C, device="cuda")
        bias = 0.1 * torch.randn(C, device="cuda")
        emb = randn(B, 1, 1, 2 * C).to(dtype)
        film = emb.chunk(2, dim=-1)
        got = gn.group_norm_backward(gy, x, scale, bias, 32, 1e-5, 1.0, film)
        want = gn.group_norm_backward_plain(gy, x, scale, bias, 32, 1e-5, 1.0, film)
        for k, (g, w) in enumerate(zip(got, want)):
            tol = 2 ** -7 if g.dtype == bf16 else 1e-5 if k == 0 else 1e-4
            err = (g.float() - w.float()).abs().max().item()
            check(err <= tol * w.float().abs().max().item(), f"backward {k} wrong at {label}")
        del got, want
        xs = cold_copies(torch.stack([x, gy]))

        def through(mod):
            """The whole autograd backward through ``mod.group_norm``."""
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias, *film)]
            y = mod.group_norm(leaves[0], leaves[1], leaves[2], 32, 1e-5, 1.0,
                               tuple(leaves[3:]))
            return lambda: torch.autograd.grad(y, leaves, xs()[1], retain_graph=True)

        tw = turns({n: through(m) for n, m in norms.items()}, lambda fn: cuda_ms(fn, 5))
        tk = cuda_ms(lambda: gn.group_norm_backward(*xs().unbind(0)[::-1], scale, bias, 32,
                                                    1e-5, 1.0, film), 10)
        tp = cuda_ms(lambda: gn.group_norm_backward_plain(*xs().unbind(0)[::-1], scale, bias,
                                                          32, 1e-5, 1.0, film), 3)
        xn = x.reshape(B, -1, C).permute(0, 2, 1).contiguous()
        gyn = gy.reshape(B, -1, C).permute(0, 2, 1).contiguous()
        w = scale.to(dtype)
        _, mean, rstd = torch.ops.aten.native_group_norm(xn, w, bias.to(dtype), B, C,
                                                        xn.shape[-1], 32, 1e-5)
        tl = cuda_ms(lambda: torch.ops.aten.native_group_norm_backward(
            gyn, xn, mean, rstd, w, B, C, xn.shape[-1], 32, [True, True, True]), 10)
        bound_ms = 3 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        print(f"GroupNorm backward {label} {list(shape)} {str(dtype)[6:]} FiLM SiLU: "
              f"autograd backward other {tw['other']:.4f} ms, this {tw['this']:.4f} ms; "
              f"group_norm_backward {tk:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
              f"{100 * bound_ms / tk:.1f} %); plain closed form {tp:.4f} ms; library "
              f"native_group_norm_backward NCHW {tl:.4f} ms")
        del x, gy, xs, xn, gyn, mean, rstd
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv))
