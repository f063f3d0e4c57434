#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kandinsky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit.
2. build: compiles the hand-written kernels from the sources in the
   checkout (nvcc for the flash-attention CUDA C++, Triton for the
   GroupNorm pair) and prints the build seconds.
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of the 768² text2img path, bf16 (one fp32 GroupNorm, the
   UNet output head), with the stated tolerance and CUDA-event times.
4. reference: the whole path at a small width on the card (kernels, bf16)
   against the same weights and injected noise on the CPU (plain
   versions, fp32).
5. slice: Kandinsky 2.1 text2img at full CONFIG_2_1 width with random bf16
   weights from a seeded generator: 768², prior "25", DDIM 50, CFG 4,
   batch 1; one warm-up call and one timed call, during which every kernel
   must be launched.

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' results as JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PROMPT = "red sand dunes under a violet sky"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up.

    A spin kernel holds the stream while the host enqueues the launches, so
    the events time the device alone: at the UNet's small shapes a launch
    from Python costs more host time than the kernel runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(100_000_000)  # about 50 ms at the H100's clocks
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms > spin.elapsed_time(start):
        print(f"timing: the host enqueue ({host_ms:.1f} ms) outlasted the spin; "
              "the next time includes host time")
    return start.elapsed_time(end) / iters


def timed_pair(kernel, plain, iters):
    """Times in turns (plain, kernel, kernel, plain); returns the mean of
    each pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_kernels(torch, results):
    from kandinsky2_tpu_torch.ops import group_norm as gn
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # K1 + K2 at the path's GroupNorm shapes [B, N, C]
    norm_shapes = [
        ("unet ds1", (2, 96 * 96, 384), torch.bfloat16),
        ("unet ds8 skip-concat", (2, 12 * 12, 3072), torch.bfloat16),
        ("unet out.0 fp32", (2, 96 * 96, 384), torch.float32),
        ("movq latent", (1, 96 * 96, 512), torch.bfloat16),
        ("movq 768^2", (1, 768 * 768, 128), torch.bfloat16),
    ]
    for label, shape, dtype in norm_shapes:
        x = randn(shape, dtype)
        s1, s2 = gn.group_norm_moments(x)
        p1, p2 = gn.group_norm_moments_plain(x)
        torch.cuda.synchronize()
        # fp32 sums in another order: relative to the largest moment
        err1 = max((s1 - p1).abs().max().item(), (s2 - p2).abs().max().item())
        ref1 = max(p1.abs().max().item(), p2.abs().max().item())
        tol1 = 1e-5 * ref1
        B, _, C = shape
        a, b = randn((B, C), torch.float32), randn((B, C), torch.float32)
        y = gn.group_norm_apply(x, a, b, 1.0)
        yp = gn.group_norm_apply_plain(x, a, b, 1.0)
        torch.cuda.synchronize()
        # identical fp32 math, one rounding to the output dtype
        err2 = (y.float() - yp.float()).abs().max().item()
        ref2 = yp.float().abs().max().item()
        tol2 = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(1.0, ref2)
        k1_ms, p1_ms = timed_pair(lambda: gn.group_norm_moments(x),
                                  lambda: gn.group_norm_moments_plain(x), 20)
        k2_ms, p2_ms = timed_pair(lambda: gn.group_norm_apply(x, a, b, 1.0),
                                  lambda: gn.group_norm_apply_plain(x, a, b, 1.0),
                                  20)
        print(f"K1 moments {label} {shape} {str(dtype)[6:]}: max_abs_err "
              f"{err1:.3e} (tol {tol1:.3e}) max_rel_err {err1 / ref1:.3e} "
              f"kernel {k1_ms:.4f} ms plain {p1_ms:.4f} ms")
        print(f"K2 apply   {label} {shape} {str(dtype)[6:]}: max_abs_err "
              f"{err2:.3e} (tol {tol2:.3e}) max_rel_err {err2 / ref2:.3e} "
              f"kernel {k2_ms:.4f} ms plain {p2_ms:.4f} ms")
        check(err1 <= tol1, f"K1 disagrees at {label}")
        check(err2 <= tol2, f"K2 disagrees at {label}")
        results["group_norm_moments"].append((label, shape, err1, k1_ms, p1_ms))
        results["group_norm_apply"].append((label, shape, err2, k2_ms, p2_ms))

    # K3 at the path's attention shapes (B, T, S, H, d)
    attn_shapes = [
        ("unet ds2", (2, 2304, 2391, 12, 64)),
        ("unet ds4", (2, 576, 663, 18, 64)),
        ("unet ds8/middle", (2, 144, 231, 24, 64)),
        ("movq attn", (1, 9216, 9216, 1, 512)),
    ]
    for label, (B, T, S, H, d) in attn_shapes:
        q, k, v = randn((B, T, H, d)), randn((B, S, H, d)), randn((B, S, H, d))
        o, lse = flash_attention(q, k, v)
        o_ref, lse_ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        # P is rounded to bf16 before P·V (fp32 in the plain version), and O
        # to bf16 at the end: a few bf16 roundings of the largest output.
        # |o| shrinks as 1/sqrt(S), so the bound is relative to it.
        err = (o.float() - o_ref.float()).abs().max().item()
        o_max = o_ref.float().abs().max().item()
        tol = 2e-2 * o_max
        lse_err = (lse - lse_ref).abs().max().item()
        lse_tol = 1e-3 * lse_ref.abs().max().item()
        k_ms, p_ms = timed_pair(lambda: flash_attention(q, k, v),
                                lambda: flash_attention_plain(q, k, v), 10)
        print(f"K3 flash   {label} B={B} T={T} S={S} H={H} d={d}: max_abs_err "
              f"{err:.3e} (tol {tol:.3e} = 2e-2 of max|o| {o_max:.3e}) "
              f"max_rel_err {err / o_max:.3e} lse_err {lse_err:.3e} "
              f"(tol {lse_tol:.3e}) kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
        check(err <= tol, f"K3 output disagrees at {label}")
        check(lse_err <= lse_tol, f"K3 LSE disagrees at {label}")
        results["flash_attention_fwd"].append(
            (label, (B, T, S, H, d), err, k_ms, p_ms))
        del q, k, v, o, o_ref, lse, lse_ref
    torch.cuda.synchronize()


def phase_reference(torch, np):
    """The small-width path on the card (kernels, bf16) against the same
    weights on the CPU (plain versions, fp32): each model's forward on the
    same inputs, then the whole path with the same injected noise."""
    from kandinsky2_tpu_torch.configs import small_config
    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    cfg = small_config(head_channels=64)  # the head width the flash kernel takes
    gpu = Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                       dtype=torch.bfloat16, device="cuda")
    gpu.init_random_params(torch.Generator(device="cuda").manual_seed(3))
    cpu = Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                       dtype=torch.float32, device="cpu")
    for name, model in cpu.models().items():
        src = gpu.models()[name].state_dict()
        model.load_state_dict({k: v.float().cpu() for k, v in src.items()})

    g = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=g)
    mask = torch.ones(2, 12, dtype=torch.long)
    mask[1, 6:] = 0
    prior_mask = torch.ones(2, 8, dtype=torch.bool)
    prior_mask[1, 4:] = False
    cases = {
        "unet": (lambda p: p.unet, (r(2, 8, 8, 4), torch.tensor([981.0, 501.0]),
                                    r(2, 38, 48), r(2, 64), r(2, 64))),
        "movq.decode": (lambda p: p.movq.decode, (r(1, 8, 8, 4),)),
        "prior": (lambda p: p.prior, (r(2, 64), torch.tensor([3.0, 1.0]), r(2, 64),
                                      r(2, 8, 64), prior_mask)),
        "clip_text": (lambda p: p.clip_text, (torch.randint(1, 200, (2, 8), generator=g),)),
        "clip_vision": (lambda p: p.clip_vision, (r(1, 28, 28, 3),)),
        "text_encoder": (lambda p: p.text_encoder,
                         (torch.randint(2, 200, (2, 12), generator=g), mask)),
    }
    tol = 3e-2  # one forward in bf16 against fp32: 0.4-0.8 % measured on the CPU
    with torch.inference_mode():
        for name, (get, args) in cases.items():
            got = get(gpu)(*(a.cuda() for a in args))
            want = get(cpu)(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for k, (x, y) in enumerate(zip(got, want)):
                x, y = x.float().cpu(), y.float()
                rel = ((x - y).norm() / y.norm()).item()
                print(f"reference: {name}[{k}] cuda/bf16 vs cpu/fp32 rel_l2 "
                      f"{rel:.3e} (tol {tol})")
                check(bool(torch.isfinite(x).all()), f"{name} not finite")
                check(rel <= tol, f"{name} on the card disagrees with the CPU")

    rng = np.random.RandomState(4)
    kw = dict(num_steps=10, guidance_scale=4, prior_cf_scale=4, prior_steps="5",
              h=64, w=64, output="float",
              noise=rng.randn(1, 8, 8, 4).astype(np.float32),
              prior_noise=rng.randn(1, 64).astype(np.float32),
              prior_noise_seq=rng.randn(5, 1, 64).astype(np.float32))
    reset_launch_counts()
    got = gpu.generate_text2img(PROMPT, **kw)
    counts = launch_counts()
    want = cpu.generate_text2img(PROMPT, **kw)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    # 15 CFG-4 model calls compound the per-call bf16 rounding: the same
    # comparison with the plain versions in bf16 on the CPU gives 4e-2
    tol = 0.15
    print(f"reference: small path cuda/bf16 vs cpu/fp32 rel_l2 {rel:.3e} "
          f"(tol {tol}) launches {json.dumps(counts)}")
    check(bool(np.isfinite(got).all()), "small path on the card is not finite")
    check(rel <= tol, "small path on the card disagrees with the CPU")
    check(all(n > 0 for n in counts.values()), "small path skipped a kernel")


def phase_slice(torch, np, smi: str):
    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import process_images, stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    t0 = time.perf_counter()
    pipe = Kandinsky2_1(tokenizer1=tok1, tokenizer2=tok2, dtype=torch.bfloat16,
                        device="cuda")
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in pipe.models().items()}
    print(f"slice: built full-size pipeline in {time.perf_counter() - t0:.2f} s, "
          f"params {json.dumps(n_params)}")
    kw = dict(num_steps=50, batch_size=1, guidance_scale=4, h=768, w=768,
              sampler="ddim_sampler", prior_cf_scale=4, prior_steps="25",
              output="float")

    t0 = time.perf_counter()
    pipe.generate_text2img(PROMPT, generator=torch.Generator(device="cuda")
                           .manual_seed(1), **kw)
    torch.cuda.synchronize()
    print(f"slice: warm-up call {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(2)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pipe.generate_text2img(PROMPT, generator=gen, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"slice: launches during the timed call {json.dumps(counts)}")
    check(img.shape == (1, 768, 768, 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "image has non-finite values")
    check(float(img.std()) > 0, "image is constant")
    check(all(n > 0 for n in counts.values()), "a kernel was not launched")
    pil = process_images(img)
    check(len(pil) == 1 and pil[0].size == (768, 768), "process_images")
    print(f"slice: image min {img.min():.4f} max {img.max():.4f} "
          f"std {img.std():.4f}; peak device memory {peak:.2f} GiB")
    print(f"slice: {seconds:.4f} s/image at 768^2, 50 DDIM steps, prior 25, "
          f"CFG 4, batch 1, bf16 on {smi}")
    return counts, seconds


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    try:
        from kandinsky2_tpu_torch.ops import _build, group_norm
    except ImportError as e:
        print(f"chip_smoke: the kandinsky2_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    # 1. device
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library("flash_attention.cu")
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    group_norm._triton_kernels()
    x = torch.randn((1, 64, 64), device="cuda", dtype=torch.bfloat16)
    s1, _ = group_norm.group_norm_moments(x)
    group_norm.group_norm_apply(x, s1, s1, 1.0)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"build: nvcc flash_attention.cu {nvcc_s:.2f} s; "
          f"triton group_norm first launches {triton_s:.2f} s")

    # 3. kernels against their plain versions
    results = {"group_norm_moments": [], "group_norm_apply": [],
               "flash_attention_fwd": []}
    phase_kernels(torch, results)

    # 4. the small path against the CPU
    phase_reference(torch, np)
    torch.cuda.empty_cache()

    # 5. the full-size slice
    counts, seconds = phase_slice(torch, np, smi)

    meta = {
        "group_norm_moments": ("triton", "kandinsky2_tpu_torch/ops/group_norm.py",
                               "kandinsky2_tpu/ops/group_norm.py:86"),
        "group_norm_apply": ("triton", "kandinsky2_tpu_torch/ops/group_norm.py",
                             "kandinsky2_tpu/ops/group_norm.py:119"),
        "flash_attention_fwd": ("cuda", "kandinsky2_tpu_torch/csrc/flash_attention.cu",
                                "kandinsky2_tpu/ops/flash_attention.py:172"),
    }
    kernels = []
    for name, rows in results.items():
        route, source, replaces = meta[name]
        main_row = max(rows, key=lambda r: r[4])  # the heaviest path shape
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r[2] for r in rows),
            "ms": main_row[3], "plain_ms": main_row[4],
            "timed_shape": f"{main_row[0]} {list(main_row[1])}",
        })
    print(f"slice: {seconds:.4f} s/image")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
