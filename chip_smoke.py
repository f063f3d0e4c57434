#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kandinsky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit.
2. build: compiles the hand-written kernels from the sources in the
   checkout (one nvcc per CUDA C++ source, all started together: the flash
   forward and backward, and GroupNorm's statistics and apply kernels) and
   prints the build seconds and ptxas's registers, shared memory and
   spills per kernel.
3. kernels: each forward kernel against its plain PyTorch version on the
   card at the shapes of the 768² text2img paths of 2.1 and 2.2 (the 2.2
   UNet's GroupNorms, 2048 to 2816 channels wide where its up path
   concatenates skips, and its added-KV attention, S = T + 10) and of the
   512² 2.0 path (Text2ImUNet20's GroupNorms and attention, S = T + 154;
   the KL-VAE decoder's GroupNorms up to [262144, 256] and its d = 512
   mid attention), bf16 (one
   fp32 GroupNorm, the UNet output head), with the stated tolerance; K3's bf16 output and
   the reference's rounding (bf16 logits of d^-1/4 pre-scaled q and k)
   each against an fp32 truth, K3 no worse; and the path's own
   GroupNorm call (K1 then K2 in one foreign call, FiLM and SiLU) against
   the plain version at K2's tolerance; CUDA-event times of the kernel,
   the plain version and, in turns with them, the one PyTorch call that
   computes the same function where there is one
   (``scaled_dot_product_attention``; ``torch.addcmul`` beside the apply
   kernel without SiLU at the fp32 shape; ``group_norm`` beside the whole
   GroupNorm op without FiLM and SiLU), each beside its bound.  The
   GroupNorm timings take x from copies that together exceed four L2s, in
   turn, so that x comes from device memory as the bound assumes; K2 is
   also timed on one x, which stays in L2 as it does after K1 on the path.
   Then the GroupNorm (K1 + K2) and its plain version against fp64 where
   each group's mean lies up to 1000 standard deviations from zero: both
   within 1e-4 relative L2 (K1's shifted sums).  The "batch 2" and "batch
   4" rows are the served 2.1 path's shapes at those buckets (phase 15):
   K1 and K2 at the UNet's [2B, 9216, 384] and [2B, 144, 1536] and the
   MoVQ's [B, 589824, 128], K3 at B·H = 2B·12 (2304, 2391), 2B·24 (144,
   231) and B (9216, 9216, d 512); the kernels line keeps the batch-1
   rows.  Rows "dpt-hybrid bit" hold K1 and K2 at the BiT stem's
   layouts on a 384² image (Intel/dpt-hybrid-midas' widths, 32 groups),
   "dpt-large 384^2" K3 at DPT-Large's ViT attention (B·H 16, T = S =
   577, d 64).
4. reference: the whole path at a small width on the card (kernels, bf16)
   against the same weights and injected noise on the CPU (plain
   versions, fp32), beside the plain versions in bf16 on the CPU as the
   control of how far bf16 alone drifts.
4b. tasks, small: every other 2.1 entry point the same way, with phase
   4's limit: text2img through the p_sampler (injected per-step noise),
   PLMS, DPM++ 2M and its Karras grid, the "ddim5" and "dpmpp5" prior
   ladders, a negative decoder prompt, img2img, inpainting (its own
   9-channel UNet), mix_images of a text and an image, the two-stage hires
   path and turbo (the deep cache every 3 steps); the noise the entry
   points draw themselves is injected from a numpy seed on both sides.
5. slice: Kandinsky 2.1 text2img at full CONFIG_2_1 width with random bf16
   weights from a seeded generator: 768², prior "25", DDIM 50, CFG 4,
   batch 1; one warm-up call and one timed call, during which every
   forward kernel must be launched; then host microseconds per group_norm
   and flash_attention_fwd call under ``inference_mode``, the GroupNorm
   input shapes of one full-width UNet denoise call (forward pre-hooks on
   its ``GroupNorm32`` modules), that call and one slice call under
   ``torch.profiler`` (device ops, device time, wall time, idle share).
5b. tasks, full width: on the slice's pipeline, img2img of a seeded 768²
   image at strength 0.7 over the DDIM 50 ladder (the steps at or below
   t = 300 run); then, the slice's pipeline freed, a task_type="inpainting"
   pipeline (9 input channels) inpaints the right half of the image in 25
   DDIM steps (50 before: a depth cut for the script's time limit).
   Each: one warm-up and one timed call (host clock, ending
   in a synchronize), K1, K2 and K3 launched during it, peak memory, a
   finite, non-constant image; then one call under the profiler (device
   ops and time, idle share, the ``k21.*`` stages' device time).  The MoVQ
   encoder puts K1, K2 and K3 at d = 512 on these paths.
6. kernels, backward: the flash backward kernels (K5 dQ and delta, K4
   dK/dV) against the plain backward at the decoder training step's UNet
   attention shapes (S = T + 87), the 2.2 UNet22's added-KV attention of
   the LoRA and distillation steps (S = T + 10) and a ragged toy shape,
   bitwise repeatable, K5's delta
   against rowsum(dO·O); timed in turns with the plain backward, the whole
   backward (K5 + K4) and the backward of ``scaled_dot_product_attention``,
   each beside its bound; and
   GroupNormFunction's gradients against autograd of the plain
   formulation, with CUDA-event times.
7. train, small: the decoder fine-tuning CLI's ``run`` on a small config
   with seeded 64² PNGs and a CSV in a temporary directory: two steps and
   a save, then a fresh pipeline that resumes from the save for two more;
   and one train step on the card (kernels, bf16 compute, fp32
   parameters) against the same step on the CPU (plain, fp32).
8. train, full width: the serving pipeline freed, CONFIG_2_1's 1.22B UNet
   with fp32 parameters and bf16 compute, batch 1 at 768², the YAML's
   diffusion config, freeze rules and Adafactor (lr 5e-6), EMA 0.9999, no
   remat; prepare_batch (MoVQ encode, XLM-R, CLIP ViT) and train_step as
   train_unclip calls them: a first step in which every trainable
   parameter must get a finite, non-zero gradient, a warm-up step and five
   timed steps, during which the kernels launch exactly K1 = K2 = 119,
   K3 = 25 and K4 = K5 = 22 times a step with no attention call on the
   card by the plain route; then a profiled step.

9. 2.2 tasks, small: every Kandinsky 2.2 entry point at a small width
   with 64-wide UNet heads (so that K3 runs) on the card (kernels, bf16)
   against the same weights and injected noise on the CPU (plain
   versions, fp32), with phase 4's limit: text2img through the ddpm, dpmpp
   and dpmpp_karras decoders and the dpmpp prior, img2img, mix_images,
   inpainting (a 9-channel UNet), ControlNet with hint=, hires, turbo (the
   deep cache every 3 steps) and run_prior_emb2emb.
10. 2.2 text2img, full width: the 2.1 pipelines freed, Kandinsky2_2 at the
   vendored published configuration (weights/configs22.pipeline_overrides:
   UNet22 1.31B, the 2.2 prior, the ViT-bigG towers, the MoVQ) with random
   bf16 weights from a seeded generator and the 2.2 stand-in tokenizer:
   768², prior 25 DDPM steps, decoder 50 DDPM steps, CFG 4 and 4, batch 1;
   one warm-up and one timed call (host clock, ending in a synchronize),
   during which K1 and K2 must launch 50 × 95 + 33 and K3 50 × 22 + 4
   times with no attention call on the card by the plain route; peak
   memory; a finite, non-constant image; the GroupNorm input shapes of one
   UNet22 call and that call's device ops; then one call under the
   profiler (device ops and time, idle share, the ``k22.*`` spans).
11. 2.0 tasks, small: every Kandinsky 2.0 entry point at a small width
   (``configs.small_config20`` with 64-wide UNet heads, so that K3 runs)
   on the card (kernels, bf16) against the CPU (plain versions, fp32),
   with phase 4's limit and every noise injected (the KL posterior's
   too): text2img through DDIM at eta 0.05, the p_sampler, PLMS, DPM++ 2M
   and its Karras grid, img2img at strength 0.7 and inpainting (both
   512², as the reference's), and ``decode_latents``; each must launch K1,
   K2 and K3 and no attention call on the card may take the plain route.
12. 2.0 text2img, full width, this slice's main path: ``Kandinsky2`` at
   CONFIG_2_0 (2.01B parameters: XLM-R large, mT5-small, Text2ImUNet20,
   the KL-VAE) with random bf16 weights from a seeded generator and the
   stand-in tokenizers, as ``generate_text2img(prompt)`` is called with
   its own defaults (512², DDIM at eta 0.05, guidance 7, batch 1) but at
   DDIM 50 in place of its 100 steps (a depth cut for the script's time
   limit); one warm-up and one timed call, during which K1 and K2 must
   launch 50 × 95 + 30 (the UNet calls and the KL-VAE decoder) and K3
   50 × 22 + 1 times with no attention call on the card by the plain
   route; peak memory; the GroupNorm input shapes of one UNet call and
   its device ops; one call under the profiler (device ops and time, idle
   share, the ``k20.*`` spans).  Then img2img at strength 0.7 (15 of the
   50 steps, the KL encoder's 22 GroupNorms and 1 attention more) on that
   pipeline and, that pipeline freed, inpainting on a
   task_type="inpainting" one, each timed and pinned as in phase 5b
   (unprofiled: the text2img call shows where a 2.0 image's time goes).
13. training, small: one step of each trainer of this training slice on
   the card (kernels, bf16) against the CPU (plain versions, fp32) with the
   same weights and injected draws, phase 7's limits: LoRA and step
   distillation on the small UNet22 with 64-wide heads (a bf16 base; the
   student fp32), the prior step (no kernel may launch: its attention is
   masked) and the inpainting decoder step with seeded masks.
14. training, full width, batch 1, one warm-up and timed steps, each with
   s/step, peak memory, a profiled step's device idle share and its
   launches pinned: lora22-768 (UNet22 of
   weights.configs22.pipeline_overrides(task_type="text2img") with a bf16 base,
   rank-4 factors on default_target, Adam 1e-4, latents [1, 96, 96, 4], 5
   steps: K1 = K2 = 95, K3 = K4 = K5 = 22 a step; the base bitwise
   unchanged, the factors moved, merge then unmerge back to the base
   within bf16 rounding), distill22-768 (the same UNet as the bf16
   teacher, an fp32 student, Adam 1e-4, num_student_steps 500, 3 steps:
   K1 = K2 = 285, K3 = 66, K4 = K5 = 22), prior-train (the prior CLI's
   run on config_prior.yaml over five seeded pictures, then 5 steps on its
   model, batch and Adafactor: no kernel launched) and inpaint-train-768
   (phase 8 on a task_type="inpainting" pipeline, masks from
   train/masks.py).

15. serve21-768 (run after phase 5b's img2img, on phase 5's pipeline):
   ``serving.GenerationServer(pipe, max_batch=4)``; its warmup runs
   buckets 1, 2 and 4; each bucket's call, as the server makes it (768²,
   prior "25", DDIM 10: a depth cut for the script's time limit, from 50
   and then 25), with
   K1 = K2 = 10 x 95 + 33 and K3 = 10 x 22 + 4 pinned a call (batch lives
   in the grids) and no attention call on the card by the plain route, s/call,
   s/image, peak memory and one profiled call's device time and idle
   share; 9 requests queued before ``start()`` (buckets 4, 4, 1, no
   padding) with their requests/s and launches, then 3 more after a
   restart (one bucket 4, one padded row); rows 0 and 3 of a batch-4 call
   against those prompts alone with the same injected noise, at DDIM 10
   and prior "5" (``SERVE21_ROWS``, a depth cut for time): in an fp32
   copy of the pipeline (no rounding to hide a row that took another's
   work) latents and images within 5e-2 relative L2; in bf16 the latents
   within 5e-2 and the images within ROW_FACTOR times the row's own bf16
   drift from fp32 (the random MoVQ decoder magnifies latent drift about
   tenfold).
17. http-validate21-768 (run after phase 15, on its server and pipeline):
   ``serving_http.serve_http(server, port=0, start=False)`` on a thread:
   /healthz 200, a 768² text2img and a base64 PNG img2img 200 with
   768² PNGs back, an undecodable image 400, an unknown path 404; then
   the pipeline re-drawn at torch-default weight scales
   (``weights.realistic.torch_init_stats``) and ``validate.validate``
   twice at 768², 25 DDIM steps: the bootstrap and the seeded repeat
   against it (LPIPS weights from ``lpips.init_random_lpips`` written and
   read by the port's own file code), both ok with PSNR >= 30 dB; the bf16
   image finite and not constant; without a builder the report stops at
   fetch.
16. lora-swap22-768 (run after phase 10, on its pipeline): two rank-4
   adapters on the UNet22's 132 targeted weights (``up`` drawn non-zero),
   requests a, a, None, b, a served one at a time after one
   ``set_seed``: after each, every targeted weight equals ``merge_lora``
   of its pristine snapshot bitwise (the snapshot itself under None) and
   every other weight is unchanged; 4 swaps; a's two images agree, a's
   differs from None's; then each swap timed alone (synchronized) with
   its peak-memory rise, and the snapshot's bytes.
18. checkpoints (18a after phase 16 on phase 10's pipeline, 18b after
   phase 17 on phase 5's, 18c-d last), each version's files in a
   ``tempfile.mkdtemp()`` directory removed in ``finally``: 18a writes the
   2.2 pipeline as a diffusers snapshot cache (the vendored config.json
   files, BF16 safetensors by ``weights.safetensors_file``, the MoVQ under
   ``movq22_rename``'s names, a byte-level CLIP tokenizer directory) and
   loads it with ``get_kandinsky2(model_version="2.2", cache_dir=...)``;
   18b writes the 2.1 pipeline as the reference's files (``torch.save``d
   UNet, prior under ``model.``, MoVQ, XLM-R ``pytorch_model.bin``, a
   ``torch.jit.save``d CLIP archive with ``visual.`` and fused
   ``attn.in_proj_weight`` keys, the CLIP stats) and loads it with the
   stand-in tokenizers, then ``task_type="inpainting"`` from an
   ``inpainting_fp16.ckpt`` cache at ``small_config(64)``; 18c does the
   same for 2.0 at CONFIG_2_0.  Each: bytes, write s, load s (the
   ``get_kandinsky2`` call, synchronized) and GB/s; every tensor of the
   loaded pipeline on the card and bitwise equal to the source's; one image
   from each with the same seed bitwise equal (the 2.2 source given the
   loaded tokenizer), its launches pinned (2.2 and 2.1 K1 = K2 = 4,783, K3
   = 1,104; 2.0 4,780 and 1,101).  18d: DPT-Large at full width (the
   ``DPTDepth()`` defaults as config.json, F32 safetensors of a seeded
   model) through ``depth.dpt_estimator`` in bf16 and fp32 on a 768²
   image: a finite, non-constant depth, K3 24 launches in bf16 and none in
   fp32 (24 attention calls by the plain route), bf16 within 3 % relative
   L2 of fp32, ms an estimate; the small hybrid (``tests/test_dpt_parity.py``'s
   TINY_HYBRID with 64-wide heads) pinned at K1 = K2 = 16 and K3 = 4 and
   held to fp32 the same way; then a full-width 2.2 ControlNet pipeline's
   ``generate_controlnet`` on the hint ``depth.make_hint`` made with the
   DPT-Large estimator.
19. the optimizers and the examples (last): 19a every OPTIM_CASES option
   set of ``train.optim.optimizer_from_config`` (optax.adafactor, adam,
   adamw, sgd; tests/test_torch_optim.py's) through ``fp32_master_optimizer``
   for 3 steps on the card against the CPU in fp32 on a factored matrix, a
   conv kernel, a vector and a bf16 tensor: masters and fp32 state within
   1e-5 relative L2, bf16 within 2^-8, a state_dict round trip bitwise;
   19b train-adamw-768 (phase 8 with optax.adamw at 1e-4, its launches
   pinned at K1 = K2 = 119, K3 = 25, K4 = K5 = 22 a step, the optimizer
   state 8 B a trainable value) and prior-train-adamw (phase 14's prior
   CLI run with optax.adamw); phases 8, 14's inpaint-train-768 and 19b also
   profile one optimizer step alone; 19c every example of
   ``kandinsky2_tpu_torch.examples`` with --small --device cuda in-process
   (``examples.run_all``): finite images of the JAX script's size or its
   steps, seconds and launches of each.
20. spatial parallelism: 20a the primitives on 4 gloo ranks that
   share the card (``parallel.launch.RankPool``; what gloo cannot carry
   is staged through pinned host memory) and on 1 NCCL rank: halo rows
   against a zero pad, the sharded GroupNorm (K1's moments on every shard,
   combined over the ranks, then K2) against the unsharded op at the 768²
   path's shapes and against fp64 at mean/std 1000, K3 on local query rows
   against gathered K/V (T != S, d 64 and 512) and around the ring with its
   LSE merge, each against the plain version and the unsharded kernel;
   which gloo collectives take CUDA tensors; and, in this process, K1, K2
   and K3 timed at a rank's shard shapes (4 ranks at 768², and the 4096²
   ring block) beside the plain version, SDPA and the bound.  20b
   sp21-768: CONFIG_2_1 text2img at 768², prior 25, DDIM 10, CFG 4, bf16,
   on the 4 ranks with the noise injected, against the same pipeline
   unsharded on rank 0: the latents within 5e-2 relative L2, the image
   finite and not constant, each rank's launches pinned (10 UNet calls and
   the decoder, no attention by the plain route), s/image and peak memory
   per rank; the small width in fp32, sharded within 1e-4 of unsharded.
   20c highres-sp: ``examples.highres_sp_decode`` of the full MoVQ at
   4096² (262,144 latent tokens: the ring) with its launches, seconds and
   peak memory per rank, and at 2048² the gathered and the ring images
   agreeing.  Every rank group has a deadline.
21. row-sharded training (after 23, on the 4 gloo ranks and the NCCL rank
   of phase 20): 21a in bf16 at the 768² path's shard shapes
   the sharded GroupNorm's gradient (x, scale, bias, FiLM) against the
   unsharded op's, K5 + K4 on local query rows against gathered K/V
   against the plain backward, and the gradients through the gathered
   attention and through the ring (K3, K5 and K4 once a ring step) against
   the unsharded kernels' (each K/V gradient arriving at its owner); in
   this process K5 and K4 timed at a rank's shard shapes and at one ring
   step's block beside the plain backward, SDPA's backward and the bound.
   21c the small width: the example's tiny UNet in fp32 on a (data 2, sp 2)
   mesh, two steps within 1e-5 relative L2 of the same steps unsharded at
   batch 2; a bf16 step with the ring forced, its launches pinned, against
   the gathered step.  21b sp-train-768: CONFIG_2_1's UNet at 768² on a
   (data 1, sp 4) mesh, batch 1, fp32 parameters, bf16 compute, Adafactor
   at 5e-6, the loss-second-moment sampler, no EMA, remat: rank 0's
   unsharded step with the same injected t and noise first (loss within
   1e-2, named gradients within 5e-2), then a warm-up and three timed
   steps (one where the script would pass 810 s there), the parameters
   bitwise equal across the ranks after every step (digests) and every
   one moved, K1 = K2 = 190, K3 = 44 and K4 = K5 = 22 a step a rank,
   s/step, the all-reduce's seconds and the peak memory per rank.
22. row-sharded 2.2 and 2.0 inference and sharded LoRA tuning of the
   UNet22 (last, after 24, on phase 20's 4 gloo ranks, the pipelines of
   phases 1-21 freed): 22a in this process K3 at a rank's
   shard shapes of the 768² UNet22 (local query rows against the gathered
   K/V after its 10 image tokens), of the 512² UNet20 (after its 154 text
   tokens) and of the 512² KL-VAE's mid attention, and K5 and K4 at the
   UNet22's LoRA shard shapes, each beside its plain version, SDPA (or its
   backward) and the bound; on the ranks the published UNet22's
   ``AddedKVAttention`` at each level row-sharded against the unsharded
   module in bf16, and its gradients through the gather (K5 + K4 on the
   local rows).  22b sp22-768: phase 10's 2.2 text2img at 768², prior 25,
   decoder DDPM 10 (the cut), CFG 4 and 4, bf16, every draw injected, on
   the 4 ranks against the same call unsharded on rank 0: the latents
   within 5e-2 relative L2, the image finite and not constant, each rank's
   launches pinned (K1 = K2 = 10 x 95 + 33, K3 = 10 x 22 + 4, none by the
   plain route), s/image (the slowest rank's) and peak memory per rank;
   then the small width in fp32: text2img, img2img, inpainting,
   ControlNet with hint=, turbo, ``decode_latents`` and hires (on a UNet
   of four levels, so that its first stage runs whole on every rank), each
   sharded within 1e-4 relative L2 of unsharded.  22c sp20-512: phase 12's
   2.0 text2img at 512², DDIM 10 (the cut) at eta 0.05, guidance 7, bf16,
   x_T and the DDIM noise injected, checked as 22b (K1 = K2 = 10 x 95 +
   30, K3 = 10 x 22 + 1); the small width in fp32: the p_sampler (its
   dynamic threshold over the whole image) and inpainting.  22d
   sp-lora22-768: ``make_sp_lora_train_fn`` on a (data 1, sp 4) mesh with
   phase 14's lora22-768 settings (the published UNet22, a bf16 base,
   rank-4 factors on ``default_target`` with ``up`` drawn non-zero, Adam
   1e-4, latents [1, 96, 96, 4]): one step against the same step
   unsharded on rank 0 with the same injected t and noise (loss within
   1e-2, the factors' gradients within 5e-2 relative L2), then three timed
   steps, the factors bitwise equal across the ranks and the base
   unchanged after every step, K1 = K2 = 95 and K3 = K4 = K5 = 22 a step a
   rank, s/step, the factors' all-reduce's seconds and peak memory per
   rank; the small width: fp32 on (data 2, sp 2), two SGD steps within
   1e-5 of the unsharded steps at batch 2.  Past ``SP22_CUT_AT_S`` seconds
   of the script at its start, 22b and 22c run 5 decoder steps and 22d
   one timed step (depth only).
23. tensor-parallel inference (after phase 20, before 21, on phase 20's pool
   of 4 gloo ranks sharing the card): 23a the small 2.1, 2.2 and 2.0
   pipelines in fp32, text2img unsharded and after ``pipe.shard(
   min_size=64)`` on (data 1, model 4) and (data 2, model 2): within 1e-4
   relative L2, every rank's image bitwise equal.  23b tp21-768: phase 5's
   text2img (768², prior 25, CFG 4, bf16) at sp21-768's depth (DDIM 10)
   with the noise injected, unsharded on rank 0, then ``shard(
   model_parallel=4, min_size=1024)`` on every rank: the coverage report
   (no fallbacks, candidate_frac >= 0.9), the latents within 5e-2 relative
   L2 of the unsharded ones and bitwise equal across the ranks, the image
   finite and not constant, each rank's K1/K2/K3 launches pinned and equal
   to the unsharded call's, none by the plain route; s/image (the slowest
   rank's), the weights and peak memory per rank, the collectives by UNet
   call, prior call and image.
24. ZeRO-3 (FSDP) training of the 2.1 decoder (after phase 21, on its
   4 gloo ranks, before phase 22): 24a
   ``tests/test_fsdp_accum.py``'s tiny UNet in fp32, two steps of
   ``make_fsdp_train_fn`` against the same two steps unsharded on the whole
   batch of 8 (AdamW with EMA and the loss-aware sampler on (data 4);
   Adafactor with factored leaves, clipping, parameter scale and momentum
   on (data 4); ``tp`` on (data 2, model 2)): losses, parameters and EMA
   within 1e-5.  24b fsdp-train-768: CONFIG_2_1's UNet with
   train-adamw-768's settings and remat, latents [4, 96, 96, 4], one
   example a rank, ``fsdp=4``; rank 0 first runs the same step unsharded
   (``accum_steps=4``) with the same t and noise: the loss within 1e-2, the
   gathered trainable parameters and their update within 5e-2 relative L2,
   frozen slices bitwise unchanged, K1 = K2 = 190, K3 = 44, K4
   = K5 = 22 a rank (the unsharded step's per example), none by the plain
   route; the state's bytes at rest and peak memory per rank, s/step (the
   slowest rank's), the gathers' and reduce-scatters' seconds and counts.
Phases 20b and 23b run DDIM 5, 21b one timed step and 24b only its
checked step, past ``LATE_CUT_AT_S`` seconds of the script (20b with its
minute ahead); past ``TIGHT_AT_S``, 23b runs its prior at 5 steps, 21b
only its checked step and 22b and 22c 2 decoder steps.  Phases 20-24 run on one pool of 4 gloo ranks
(and 20a and 21a on one NCCL rank), started once.
Phases 15-17 time their stages with ``observability.StageReport``.

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' results as JSON, and the line before that the card's name and
power limit.  Bounds are the larger of the bytes a call must move over
3.35 TB/s and its operations over 989 TFLOP/s (bf16 tensor cores) or
67 TFLOP/s (fp32), the H100 SXM's data-sheet rates at 700 W.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

PROMPT = "red sand dunes under a violet sky"
# the kernels that text2img (phases 4 and 5) launches; the backward ones run
# in training only
FORWARD_KERNELS = ("group_norm_stats", "group_norm_apply", "flash_attention_fwd")
# the full-width 2.1 paths' forward launches: a UNet call runs 95 GroupNorms
# (K1 and K2 each) and 22 attentions (K3), the MoVQ decoder 33 and 4, its
# encoder 24 and 3
UNET_LAUNCHES, DECODER_LAUNCHES, ENCODER_LAUNCHES = (95, 22), (33, 4), (24, 3)
# the 2.0 KL-VAE's: its decoder 30 GroupNorms and 1 attention (the mid
# block's), its encoder 22 and 1; Text2ImUNet20's torso is 2.1's (95, 22)
KL_DECODER_LAUNCHES, KL_ENCODER_LAUNCHES = (30, 1), (22, 1)
# phase 12's full-width 2.0 text2img: generate_text2img's own defaults
# (512², DDIM at eta 0.05, guidance 7, batch 1) at 50 steps in place of 100,
# a depth cut that keeps the whole script within its time limit
T2I20_STEPS, T2I20_SIZE = 50, 512
T2I20 = dict(num_steps=T2I20_STEPS, output="float")
# phase 5b's full-width tasks: 768², DDIM 50, prior "25", CFG 4 and 4
# (inpainting at DDIM 25, ``INPAINT_TASK``)
FULL_TASK = dict(num_steps=50, guidance_scale=4, h=768, w=768, sampler="ddim_sampler",
                 prior_cf_scale=4, prior_steps="25", output="float")
# phase 5b's inpainting at DDIM 25 (50 before), a depth cut for the
# script's time limit: its profiled call took most of its 62.1 s at DDIM 50
# (an H100 80GB HBM3 at 700 W)
INPAINT_TASK = dict(FULL_TASK, num_steps=25)
# phase 10's full-width 2.2 text2img: 768², prior 25 and decoder 50 DDPM
# steps, CFG 4 and 4, batch 1
T2I22 = dict(decoder_steps=50, prior_steps=25, decoder_guidance_scale=4,
             prior_guidance_scale=4, h=768, w=768, output="float")
# train_configs/config_prior.yaml as a dict (the card's machine has no
# PyYAML; tests/test_torch_train_prior.py holds the two equal)
PRIOR_YAML = {
    "params_path": None, "clip_mean_std_path": None, "clip_name": "ViT-L/14",
    "num_epochs": 2, "save_every": 1000, "save_name": "model",
    "save_path": "checkpoints/prior",
    "model_config": {
        "model": {"type": "prior", "diffusion_sampler": "uniform", "hparams": {
            "text_ctx": 77, "xf_width": 2048, "xf_layers": 20, "xf_heads": 32,
            "xf_final_ln": True, "xf_padding": False, "text_drop": 0.2,
            "clip_dim": 768, "clip_xf_width": 768}},
        "diffusion": {"steps": 1000, "learn_sigma": False, "sigma_small": True,
                      "noise_schedule": "cosine", "use_kl": False,
                      "predict_xstart": True, "rescale_learned_sigmas": False,
                      "timestep_respacing": ""}},
    "optim_params": {"name": "optax.adafactor", "params": {"learning_rate": 5e-06}},
    "data": {"train": {"df_path": None, "clip_image_size": 224, "drop_text_prob": 0.1,
                       "batch_size": 1, "shuffle": True}},
}
# phase 19a: the option sets of tests/test_torch_optim.py, which holds the two
# equal; each a YAML's optim_params ("name", "params")
OPTIM_CASES = {
    "adafactor": ("optax.adafactor", {"learning_rate": 1e-2}),
    "adafactor-unfactored": ("optax.adafactor", {"learning_rate": 1e-2, "factored": False}),
    "adafactor-momentum": ("optax.adafactor", {"learning_rate": 1e-2, "momentum": 0.9}),
    "adafactor-momentum-bf16": ("optax.adafactor", {
        "learning_rate": 1e-2, "momentum": 0.9, "dtype_momentum": "bfloat16"}),
    "adafactor-weight-decay": ("optax.adafactor", {
        "learning_rate": 1e-2, "weight_decay_rate": 1e-2}),
    "adafactor-no-clipping": ("optax.adafactor", {
        "learning_rate": 1e-2, "clipping_threshold": None}),
    "adafactor-clipping-2": ("optax.adafactor", {
        "learning_rate": 1e-2, "clipping_threshold": 2.0}),
    "adafactor-absolute-step": ("optax.adafactor", {
        "learning_rate": 1e-2, "multiply_by_parameter_scale": False}),
    "adafactor-decay": ("optax.adafactor", {
        "learning_rate": 1e-2, "decay_rate": 0.7, "decay_offset": -3, "eps": 1e-20,
        "min_dim_size_to_factor": 140}),
    "adafactor-no-learning-rate": ("optax.adafactor", {}),
    "adam": ("optax.adam", {"learning_rate": 1e-3}),
    "adam-betas": ("optax.adam", {"learning_rate": 1e-3, "b1": 0.8, "b2": 0.99,
                                  "eps": 1e-6}),
    "adam-eps-root": ("optax.adam", {"learning_rate": 1e-3, "eps_root": 1e-4}),
    "adam-nesterov": ("optax.adam", {"learning_rate": 1e-3, "nesterov": True}),
    "adam-mu-bf16": ("optax.adam", {"learning_rate": 1e-3, "mu_dtype": "bfloat16"}),
    "adamw": ("optax.adamw", {"learning_rate": 1e-3}),
    "adamw-decay-nesterov": ("optax.adamw", {"learning_rate": 1e-3, "weight_decay": 0.1,
                                             "nesterov": True}),
    "sgd": ("optax.sgd", {"learning_rate": 1e-2}),
    "sgd-momentum": ("optax.sgd", {"learning_rate": 1e-2, "momentum": 0.9}),
    "sgd-nesterov": ("optax.sgd", {"learning_rate": 1e-2, "momentum": 0.9,
                                   "nesterov": True}),
    "sgd-momentum-bf16": ("optax.sgd", {"learning_rate": 1e-2, "momentum": 0.9,
                                        "accumulator_dtype": "bfloat16"}),
}
# phase 19b's optimizer: optax.adamw at 1e-4 (optax's decay 1e-4)
ADAMW = {"name": "optax.adamw", "params": {"learning_rate": 1e-4}}
CUDA_SOURCES = ("flash_attention.cu", "group_norm.cu")
PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12    # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # device-memory bytes/s
L2_BYTES = 50 * 2**20  # the H100's L2


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def smi_memory() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up.

    A spin kernel holds the stream while the host enqueues the launches, so
    the events time the device alone: at the UNet's small shapes a launch
    from Python costs more host time than the kernel runs.  The device queues
    about a thousand pending launches and the host blocks beyond that, so
    ``iters`` times the launches of one ``fn`` must stay well below it."""
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


def timed_turns(fns: dict, iters: int) -> dict:
    """Device ms of each function, timed in turns (a, b, c, c, b, a); the
    mean of each function's two runs."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(cuda_ms(fns[n], iters))
    return {n: sum(v) / len(v) for n, v in runs.items()}


def host_us(fn, calls: int = 2000, reps: int = 7) -> float:
    """Host microseconds per call: the fastest of ``reps`` runs of ``calls``
    calls, at a shape where the device keeps up with the host."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best * 1e6


def bound(ops: float, nbytes: float, peak: float):
    """(ms, "operations" or "bytes"): the least time the card could take,
    ``ops`` at the rate ``peak`` against ``nbytes`` at PEAK_BYTES."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_profile(torch, fn, cpu=True):
    """Run ``fn`` once under torch.profiler; returns (device ops, device
    ms, the device events by name).  record_function ranges also show on the device timeline,
    spanning kernels already counted: left out.  ``cpu=False`` traces the
    card alone, which a whole image's tens of thousands of host ops make
    far cheaper to summarise."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
              and not e.is_user_annotation]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3, events)


def cold_copies(t):
    """A function that hands out ``t`` and copies of it in turn, the copies
    together over four L2s: a call timed on the next copy reads it from
    device memory, as a bound in bytes assumes."""
    n = max(2, -(-4 * L2_BYTES // (t.numel() * t.element_size())))
    return itertools.cycle([t] + [t.clone() for _ in range(n - 1)]).__next__


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_path_counts() -> None:
    """Zero the kernels' launch counters and the count of attention calls
    on the card that took the plain route."""
    from kandinsky2_tpu_torch.ops import qkv_attention, reset_launch_counts

    reset_launch_counts()
    qkv_attention.plain_on_card = 0


def check_full_launches(name: str, counts: dict, unet_calls: int, encoded: bool,
                        decoder=DECODER_LAUNCHES, encoder=ENCODER_LAUNCHES):
    """A full-width path's forward launches are exactly what its UNet calls
    and codec passes need (the MoVQ's by default, ``decoder`` and
    ``encoder`` (GroupNorms, attentions) otherwise), and no attention call
    on the card took the plain route (every one went through K3)."""
    from kandinsky2_tpu_torch.ops import qkv_attention

    parts = [UNET_LAUNCHES] * unet_calls + [decoder] + [encoder] * encoded
    norms, attns = (sum(p[i] for p in parts) for i in (0, 1))
    want = {"group_norm_stats": norms, "group_norm_apply": norms,
            "flash_attention_fwd": attns}
    plain = qkv_attention.plain_on_card
    print(f"{name}: expected forward launches {json.dumps(want)}; attention "
          f"calls on the card by the plain route {plain}")
    check(all(counts[n] == want[n] for n in want), f"{name}: launches {counts} != {want}")
    check(plain == 0, f"{name}: {plain} attention calls on the card missed K3")


def _row(label, shape, err, times, bound_ms, bound_by):
    return {"label": label, "shape": list(shape), "err": err, "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": times.get("library"),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _print_times(name, label, times, bound_ms, bound_by):
    lib = times.get("library")
    print(f"{name} {label}: kernel {times['kernel']:.4f} ms plain "
          f"{times['plain']:.4f} ms library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}; bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / times['kernel']:.1%} of it")


def groupnorm_tally(name, unet, call) -> dict:
    """The GroupNorm input shapes of one ``call()`` of ``unet`` ([B, N, C],
    dtype, FiLM or not, SiLU or not) and how many calls each had, from
    forward pre-hooks on its ``GroupNorm32`` modules."""
    from kandinsky2_tpu_torch.models.layers import GroupNorm32

    tally = {}

    def count(mod, args, kwargs):
        x = args[0]
        key = (f"[{x.shape[0]}, {x[0, ..., 0].numel()}, {x.shape[-1]}] "
               f"{str(x.dtype)[6:]}{' FiLM' if kwargs.get('film') else ''}"
               f"{' SiLU' if mod.swish else ''}")
        tally[key] = tally.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(count, with_kwargs=True)
             for m in unet.modules() if isinstance(m, GroupNorm32)]
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    print(f"{name}: GroupNorm calls per {type(unet).__name__} denoise call, "
          f"{sum(tally.values())} in all, by input shape: " + "; ".join(
              f"{k}: {n}" for k, n in sorted(tally.items(), key=lambda kv: -kv[1])))
    return tally


def profiled_image(torch, name, call, seconds, spans):
    """One image (``call()``) under the profiler: the largest device
    kernels, device ops and time, the idle share against the unprofiled
    ``seconds`` and the device time of the ``spans`` ranges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kernels = [e for e in events if not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    stages = {e.key: e.device_time_total / 1e3 for e in events
              if e.is_user_annotation and e.key.startswith(spans)}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{name}: profiled call, device time by name (ms, calls): " + "; ".join(
        f"{e.key[:50]} {e.self_device_time_total / 1e3:.1f} ({e.count})" for e in top))
    print(f"{name}: profiled call {sum(e.count for e in kernels)} device ops, "
          f"{dev_ms:.1f} ms of device time, device idle share "
          f"{1 - dev_ms / 1e3 / seconds:.3f} of the unprofiled {seconds:.4f} s/image; "
          f"spans (device ms) " + "; ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    check(dev_ms > 0, f"{name}: the profiler saw no device time")


def phase_kernels(torch, results):
    import torch.nn.functional as F

    from kandinsky2_tpu_torch.ops import group_norm as gn
    from kandinsky2_tpu_torch.ops.attention import reference_attention
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # K1 + K2 at the path's GroupNorm shapes [B, N, C]
    norm_shapes = [
        ("unet ds1", (2, 96 * 96, 384), torch.bfloat16),
        ("unet ds2", (2, 48 * 48, 768), torch.bfloat16),
        ("unet ds4", (2, 24 * 24, 1152), torch.bfloat16),
        ("unet ds8", (2, 12 * 12, 1536), torch.bfloat16),
        ("unet ds8 skip-concat", (2, 12 * 12, 3072), torch.bfloat16),
        ("unet out.0 fp32", (2, 96 * 96, 384), torch.float32),
        ("movq latent", (1, 96 * 96, 512), torch.bfloat16),
        ("movq 768^2", (1, 768 * 768, 128), torch.bfloat16),
        # the 2.2 UNet's shapes that 2.1's lacks (its output head is 2.1's
        # fp32 [2, 9216, 384])
        *((f"unet22 [{n}, {c}]", (2, n, c), torch.bfloat16) for n, c in (
            (9216, 768), (9216, 1152), (2304, 384), (2304, 1152), (2304, 1280),
            (2304, 1536), (2304, 2048), (576, 768), (576, 1280), (576, 1536), (576, 2048),
            (576, 2560), (576, 2816), (144, 1280), (144, 2816))),
        # the 2.0 path at 512²: Text2ImUNet20 (2.1's torso, latent 64²,
        # CFG batch 2) and the KL-VAE decoder, which no MoVQ layout covers
        ("unet20 ds1", (2, 64 * 64, 384), torch.bfloat16),
        ("unet20 ds2", (2, 32 * 32, 768), torch.bfloat16),
        ("unet20 ds4", (2, 16 * 16, 1152), torch.bfloat16),
        ("unet20 ds8", (2, 8 * 8, 1536), torch.bfloat16),
        ("unet20 ds8 skip-concat", (2, 8 * 8, 3072), torch.bfloat16),
        ("unet20 out.0 fp32", (2, 64 * 64, 384), torch.float32),
        *((f"kl-vae [{n}, {c}]", (1, n, c), torch.bfloat16) for n, c in (
            (4096, 512), (16384, 512), (65536, 512), (65536, 256), (262144, 256),
            (262144, 128))),
        # the KL-VAE encoder's two layouts that its decoder lacks: the first
        # norm of the resblocks that widen 128 → 256 at 256² and 256 → 512 at
        # 128² (img2img and inpainting encode the 512² image)
        ("kl-vae enc [65536, 128]", (1, 65536, 128), torch.bfloat16),
        ("kl-vae enc [16384, 256]", (1, 16384, 256), torch.bfloat16),
        # the served 2.1 path at buckets 2 and 4 (phase 15): the UNet's
        # CFG-doubled rows and the MoVQ decoder's batch
        *((f"batch {b}: unet ds1", (2 * b, 96 * 96, 384), torch.bfloat16)
          for b in (2, 4)),
        *((f"batch {b}: unet ds8", (2 * b, 12 * 12, 1536), torch.bfloat16)
          for b in (2, 4)),
        *((f"batch {b}: movq 768^2", (b, 768 * 768, 128), torch.bfloat16)
          for b in (2, 4)),
        # the DPT hybrid's BiT stem (Intel/dpt-hybrid-midas: 64, then
        # 256/512/1024 wide, 32 groups) on a 384² image
        *((f"dpt-hybrid bit [{n}, {c}]", (1, n, c), torch.bfloat16) for n, c in (
            (36864, 64), (9216, 64), (9216, 256), (9216, 128), (2304, 128),
            (2304, 512), (2304, 256), (576, 256), (576, 1024))),
    ]
    for label, shape, dtype in norm_shapes:
        B, N, C = shape
        es = torch.finfo(dtype).bits // 8
        x = randn(shape, dtype)
        scale = 1 + 0.1 * randn((C,), torch.float32)
        bias = 0.1 * randn((C,), torch.float32)
        film = randn((B, 1, 1, 2 * C)).chunk(2, dim=-1)  # the UNet's FiLM views
        stats = lambda: gn.group_norm_stats(x, scale, bias, film, 32, 1e-5)
        stats_plain = lambda: gn.group_norm_stats_plain(x, scale, bias, film, 32, 1e-5)
        (a, b), (a2, b2), (pa, pb) = stats(), stats(), stats_plain()
        torch.cuda.synchronize()
        # fp32 sums in another order: relative to the largest coefficient
        err1 = max((a - pa).abs().max().item(), (b - pb).abs().max().item())
        ref1 = max(pa.abs().max().item(), pb.abs().max().item())
        tol1 = 1e-4 * ref1
        repeat = torch.equal(a, a2) and torch.equal(b, b2)
        y = gn.group_norm_apply(x, a, b, 1.0)
        yp = gn.group_norm_apply_plain(x, a, b, 1.0)
        torch.cuda.synchronize()
        # fp32 math up to the fast activation, one rounding to the output dtype
        err2 = (y.float() - yp.float()).abs().max().item()
        ref2 = yp.float().abs().max().item()
        tol2 = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(1.0, ref2)
        # the path's launcher: K1 then K2 in one foreign call on the plan's
        # geometry, the call's own scratch, FiLM views and SiLU
        with torch.inference_mode():
            yo = gn.group_norm(x, scale, bias, 32, 1e-5, 1.0, film)
        yop = gn.group_norm_plain(x, scale, bias, 32, 1e-5, 1.0, film).float()
        err_op = (yo.float() - yop).abs().max().item()
        tol_op = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(
            1.0, yop.abs().max().item())
        xs = cold_copies(x)
        t1 = timed_turns({
            "kernel": lambda: gn.group_norm_stats(xs(), scale, bias, film, 32, 1e-5),
            "plain": lambda: gn.group_norm_stats_plain(xs(), scale, bias, film, 32,
                                                       1e-5)}, 20)
        t2 = timed_turns({"kernel": lambda: gn.group_norm_apply(xs(), a, b, 1.0),
                          "plain": lambda: gn.group_norm_apply_plain(xs(), a, b, 1.0)}, 20)
        t2_warm = timed_turns({"kernel": lambda: gn.group_norm_apply(x, a, b, 1.0)},
                              20)["kernel"]
        # x read once; a, b written; scale, bias, fs, fb read: Σx, Σx² per element
        b1 = bound(3 * B * N * C, B * N * C * es + 2 * B * C * 4 + 2 * C * 4
                   + 2 * B * C * 2, PEAK_FP32)
        # x read, y written, a, b read: multiply-add and SiLU per element
        b2 = bound(6 * B * N * C, 2 * B * N * C * es + 2 * B * C * 4, PEAK_FP32)
        lib_note = "none: no one PyTorch call computes x·a + b and its cast to bf16"
        if dtype == torch.float32:
            # without SiLU and the cast, K2's function is one addcmul
            a3, b3 = a[:, None, :], b[:, None, :]
            lib_err = (gn.group_norm_apply(x, a, b, 0.0)
                       - torch.addcmul(b3, x, a3)).abs().max().item()
            t2lib = timed_turns({"kernel": lambda: gn.group_norm_apply(xs(), a, b, 0.0),
                                 "library": lambda: torch.addcmul(b3, xs(), a3)}, 20)
            t2["library"] = t2lib["library"]
            lib_note = (f"torch.addcmul(b, x, a) {t2lib['library']:.4f} ms against K2 "
                        f"without SiLU {t2lib['kernel']:.4f} ms in turns (max_abs_diff "
                        f"{lib_err:.3e})")
            check(lib_err <= 1e-5 * max(1.0, ref2), f"K2 without SiLU disagrees at {label}")
        # the whole op without FiLM and SiLU beside torch's group_norm on the
        # same memory (a [B, C, N] view of the channels-last activation)
        with torch.inference_mode():
            sl, bl = scale.to(dtype), bias.to(dtype)
            op = timed_turns({
                "op": lambda: gn.group_norm(xs(), scale, bias, 32, 1e-5),
                "library": lambda: F.group_norm(xs().permute(0, 2, 1), 32, sl, bl,
                                                1e-5)}, 20)
        print(f"K1 stats   {label} {shape} {str(dtype)[6:]}: max_abs_err {err1:.3e} "
              f"(tol {tol1:.3e}) max_rel_err {err1 / ref1:.3e}, bitwise repeatable "
              f"{repeat}")
        _print_times("K1 stats  ", label, t1, *b1)
        print(f"K2 apply   {label} {shape} {str(dtype)[6:]}: max_abs_err {err2:.3e} "
              f"(tol {tol2:.3e}) max_rel_err {err2 / ref2:.3e}")
        _print_times("K2 apply  ", label, t2, *b2)
        print(f"K2 apply   {label}: on one x, in L2 as after K1 on the path, "
              f"{t2_warm:.4f} ms")
        print(f"K2 apply   {label} library: {lib_note}")
        print(f"GroupNorm op (the path's K1 + K2 call, FiLM, SiLU) {label}: max_abs_err "
              f"{err_op:.3e} (tol {tol_op:.3e}) against group_norm_plain")
        print(f"GroupNorm op (K1 + K2, no FiLM, no SiLU) {label}: {op['op']:.4f} ms; "
              f"torch group_norm {op['library']:.4f} ms")
        check(err1 <= tol1, f"K1 disagrees at {label}")
        check(repeat, f"K1 is not bitwise repeatable at {label}")
        check(err2 <= tol2, f"K2 disagrees at {label}")
        check(err_op <= tol_op, f"the path's GroupNorm call disagrees at {label}")
        results["group_norm_stats"].append(_row(label, shape, err1, t1, *b1))
        results["group_norm_apply"].append(_row(label, shape, err2, t2, *b2))

    # K1's sums are shifted by each group's first element, where the
    # reference's _moments take the one-pass Σx²/n − mean², which loses
    # digits as a group's mean moves away from zero.  The GroupNorm (K1 +
    # K2) and its plain version against an fp64 truth at the fp32 norm's
    # shape, by that ratio: both within 1e-4 up to 1000
    B, N, C = 2, 96 * 96, 384
    z = torch.randn((B, N, C), generator=g, device="cuda", dtype=torch.float64)
    one, zero = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
    for offset in (0, 10, 30, 100, 300, 1000):
        x = (z + offset).float()
        xd = x.double().reshape(B, N, 32, C // 32)
        mean = xd.mean(dim=(1, 3), keepdim=True)
        var = xd.var(dim=(1, 3), unbiased=False, keepdim=True)
        truth = ((xd - mean) / torch.sqrt(var + 1e-5)).reshape(B, N, C)
        with torch.inference_mode():
            y = gn.group_norm(x, one, zero, 32, 1e-5)
        yp = gn.group_norm_plain(x, one, zero, 32, 1e-5)
        rel = [((t.double() - truth).norm() / truth.norm()).item() for t in (y, yp)]
        print(f"K1 shifted variance: group |mean|/std {offset}, [{B}, {N}, {C}] "
              f"fp32: K1 + K2 rel_l2 {rel[0]:.3e}, plain version {rel[1]:.3e} "
              f"against fp64 (tol 1e-4)")
        check(bool(torch.isfinite(y).all()), f"GroupNorm not finite at offset {offset}")
        check(max(rel) <= 1e-4, f"GroupNorm loses digits at mean/std {offset}")
    del z, x, xd, truth, y, yp

    # K3 at the path's attention shapes (B, T, S, H, d)
    attn_shapes = [
        ("unet ds2", (2, 2304, 2391, 12, 64)),
        ("unet ds4", (2, 576, 663, 18, 64)),
        ("unet ds8/middle", (2, 144, 231, 24, 64)),
        ("movq attn", (1, 9216, 9216, 1, 512)),
        # the 2.2 UNet's added-KV attention: 10 image tokens before the T
        # spatial rows
        ("unet22 ds2 added-KV", (2, 2304, 2314, 12, 64)),
        ("unet22 ds4 added-KV", (2, 576, 586, 20, 64)),
        ("unet22 ds8/middle added-KV", (2, 144, 154, 24, 64)),
        # the 2.0 UNet at 512²: 77 XLM-R and 77 mT5 tokens before the T
        # spatial rows; the KL-VAE's mid attention, one head of 512
        ("unet20 ds2", (2, 1024, 1178, 12, 64)),
        ("unet20 ds4", (2, 256, 410, 18, 64)),
        ("unet20 ds8/middle", (2, 64, 218, 24, 64)),
        ("kl-vae attn", (1, 4096, 4096, 1, 512)),
        # the served 2.1 path at buckets 2 and 4 (phase 15)
        *((f"batch {b}: unet ds2", (2 * b, 2304, 2391, 12, 64)) for b in (2, 4)),
        *((f"batch {b}: unet ds8/middle", (2 * b, 144, 231, 24, 64)) for b in (2, 4)),
        *((f"batch {b}: movq attn", (b, 9216, 9216, 1, 512)) for b in (2, 4)),
        # DPT-Large's ViT layer on a 384² image: 576 patches and the cls token
        ("dpt-large 384^2", (1, 577, 577, 16, 64)),
    ]
    for label, (B, T, S, H, d) in attn_shapes:
        q, k, v = randn((B, T, H, d)), randn((B, S, H, d)), randn((B, S, H, d))
        o, lse = flash_attention_fwd(q, k, v)
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
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        times = timed_turns({
            "kernel": lambda: flash_attention_fwd(q, k, v),
            "plain": lambda: flash_attention_plain(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt)}, 10)
        bnd = bound(4 * B * H * T * S * d, 2 * (2 * B * T + 2 * B * S) * H * d
                    + 4 * B * H * T, PEAK_BF16)
        print(f"K3 flash   {label} B={B} T={T} S={S} H={H} d={d}: max_abs_err "
              f"{err:.3e} (tol {tol:.3e} = 2e-2 of max|o| {o_max:.3e}) "
              f"max_rel_err {err / o_max:.3e} lse_err {lse_err:.3e} "
              f"(tol {lse_tol:.3e})")
        _print_times("K3 flash  ", label, times, *bnd)
        check(err <= tol, f"K3 output disagrees at {label}")
        check(lse_err <= lse_tol, f"K3 LSE disagrees at {label}")
        # K3's bf16 rounding (fp32 logits with one 1/sqrt(d) scale, P rounded
        # to bf16 before P·V) against the reference's (_xla_attention: q and
        # k pre-scaled by d^-1/4 in bf16, bf16 logits, fp32 softmax), both
        # against an fp32 truth on the same bf16 inputs
        truth = flash_attention_plain(q.float(), k.float(), v.float())[0]
        ref_round = reference_attention(q, k, v)
        k3_rel = ((o.float() - truth).norm() / truth.norm()).item()
        ref_rel = ((ref_round.float() - truth).norm() / truth.norm()).item()
        print(f"K3 flash   {label}: rel_l2 against fp32 truth: K3 bf16 {k3_rel:.3e}, "
              f"reference rounding (bf16 logits of d^-1/4 pre-scaled q, k) "
              f"{ref_rel:.3e}")
        check(k3_rel <= ref_rel, f"K3 rounds worse than the reference at {label}")
        results["flash_attention_fwd"].append(
            dict(_row(label, (B, T, S, H, d), err, times, *bnd),
                 rel_l2_vs_fp32=k3_rel, reference_rounding_rel_l2=ref_rel))
        del q, k, v, o, o_ref, lse, lse_ref, qt, kt, vt, truth, ref_round
    torch.cuda.synchronize()


def phase_reference(torch, np):
    """The small-width path on the card (kernels, bf16) against the same
    weights on the CPU (plain versions, fp32): each model's forward on the
    same inputs, then the whole path with the same injected noise, beside
    the plain versions in bf16 on the CPU."""
    from kandinsky2_tpu_torch.configs import small_config
    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    cfg = small_config(head_channels=64)  # the head width the flash kernel takes
    gpu = Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                       dtype=torch.bfloat16, device="cuda")
    gpu.init_random_params(torch.Generator(device="cuda").manual_seed(3))
    cpu, cpu_bf16 = (Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                                  dtype=dtype, device="cpu")
                     for dtype in (torch.float32, torch.bfloat16))
    for pipe in (cpu, cpu_bf16):
        for name, model in pipe.models().items():
            src = gpu.models()[name].state_dict()
            model.load_state_dict({k: v.cpu() for k, v in src.items()})

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
    control = cpu_bf16.generate_text2img(PROMPT, **kw)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    rel_bf16 = float(np.linalg.norm(control - want) / np.linalg.norm(want))
    # 15 CFG-4 model calls compound the per-call bf16 rounding; the control
    # (the plain versions in bf16 on the CPU, the same weights) shows how
    # much of the card's error bf16 alone gives: PERF.md keeps both readings
    tol = 0.15
    print(f"reference: small path cuda/bf16 vs cpu/fp32 rel_l2 {rel:.3e} "
          f"(tol {tol}; cpu/bf16 plain vs cpu/fp32 {rel_bf16:.3e}) "
          f"launches {json.dumps(counts)}")
    check(bool(np.isfinite(got).all()), "small path on the card is not finite")
    check(rel <= tol, "small path on the card disagrees with the CPU")
    check(all(counts[n] > 0 for n in FORWARD_KERNELS), "small path skipped a kernel")


def inject_noise(pipe, seed: int, clip_dim: int, np):
    """Draw, from a numpy seed, the noise that a pipeline's entry points
    would draw from their generator: the prior's x_T and per-step noise in
    every ``generate_clip_emb`` call and the decoder's x_T in every
    ``generate_img`` call that is given none.  Two pipelines injected with
    one seed then draw the same on the card and on the CPU; ``del
    pipe.generate_clip_emb, pipe.generate_img`` undoes it."""
    rng = np.random.RandomState(seed)
    clip_emb, gen_img = pipe.generate_clip_emb, pipe.generate_img

    def generate_clip_emb(prompt, batch_size=1, prior_steps="25", noise=None,
                          noise_seq=None, **kw):
        ps = str(prior_steps)
        x_T = rng.randn(batch_size, clip_dim).astype(np.float32)
        seq = (rng.randn(int(ps), batch_size, clip_dim).astype(np.float32)
               if ps.isdigit() else None)
        return clip_emb(prompt, batch_size=batch_size, prior_steps=prior_steps,
                        noise=x_T if noise is None else noise,
                        noise_seq=seq if noise_seq is None else noise_seq, **kw)

    def generate_img(*args, noise=None, h=512, w=512, batch_size=1, **kw):
        if noise is None:
            noise = rng.randn(batch_size, (h + 63) // 64 * 8, (w + 63) // 64 * 8,
                              4).astype(np.float32)
        return gen_img(*args, noise=noise, h=h, w=w, batch_size=batch_size, **kw)

    pipe.generate_clip_emb, pipe.generate_img = generate_clip_emb, generate_img


def seeded_image(np, seed: int, size: int):
    """A smooth seeded RGB PIL image: a low-resolution noise field upsampled."""
    from PIL import Image

    low = np.random.RandomState(seed).randint(0, 256, (8, 8, 3), np.uint8)
    return Image.fromarray(low).resize((size, size), Image.BICUBIC)


def _small_pair(torch, task_type, seed, unet_out_scale=1.0):
    """The small-width pipeline on the card (bf16) and on the CPU (fp32)
    with the same seeded weights.  The MoVQ's output conv is scaled by
    0.01, so that the random weights' image (|x| ~ 1e2) lies in [-1, 1]
    where the 8-bit images that hires upsamples keep their detail; the
    UNet's by ``unet_out_scale``, which only the hires pair sets (0.1, as
    the 2.1 hires parity test against JAX: at full scale its latents reach
    |z| ~ 1e2, where JAX's one-pass GroupNorm variance loses digits)."""
    from kandinsky2_tpu_torch.configs import small_config
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    kw = dict(config=small_config(head_channels=64), tokenizer1=tok1,
              tokenizer2=tok2, task_type=task_type)
    gpu = Kandinsky2_1(dtype=torch.bfloat16, device="cuda", **kw)
    gpu.init_random_params(torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        gpu.movq.decoder.conv_out.weight.mul_(0.01)
        gpu.movq.decoder.conv_out.bias.mul_(0.01)
        gpu.unet.out[2].weight.mul_(unet_out_scale)
    cpu = Kandinsky2_1(dtype=torch.float32, device="cpu", **kw)
    for name, model in cpu.models().items():
        model.load_state_dict({k: v.cpu() for k, v in
                               gpu.models()[name].state_dict().items()})
    return gpu, cpu


def phase_tasks_small(torch, np):
    """Every 2.1 entry point and sampler at a small width on the card
    (kernels, bf16) against the CPU (plain versions, fp32), with the same
    weights and injected noise; the limit is phase 4's."""
    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts

    pairs = {"text2img": _small_pair(torch, "text2img", 3),
             "inpainting": _small_pair(torch, "inpainting", 4),
             "hires": _small_pair(torch, "text2img", 3, unet_out_scale=0.1)}
    rng = np.random.RandomState(13)
    lat = lambda *shape: rng.randn(*shape).astype(np.float32)
    t2i = dict(num_steps=10, guidance_scale=4, prior_cf_scale=4, prior_steps="5",
               h=64, w=64, noise=lat(1, 8, 8, 4), prior_noise=lat(1, 64),
               prior_noise_seq=lat(5, 1, 64), output="float")
    nseq, hires_noise = lat(10, 1, 8, 8, 4), lat(1, 16, 16, 4)
    img, img2 = seeded_image(np, 14, 64), seeded_image(np, 15, 64)
    mask = np.ones((64, 64), np.float32)
    mask[:, 32:] = 0.0  # keep the left half
    no_seq = {k: v for k, v in t2i.items() if k != "prior_noise_seq"}
    small = dict(num_steps=10, guidance_scale=4, h=64, w=64, prior_steps="5",
                 output="float")
    cases = {
        "text2img p_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="p_sampler", noise_seq=nseq, **t2i)),
        "text2img plms_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="plms_sampler", **t2i)),
        "text2img dpmpp_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="dpmpp_sampler", **t2i)),
        "text2img dpmpp_karras_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="dpmpp_karras_sampler", **t2i)),
        "prior ddim5": ("text2img", lambda p: p.generate_text2img(
            PROMPT, **dict(no_seq, prior_steps="ddim5"))),
        "prior dpmpp5": ("text2img", lambda p: p.generate_text2img(
            PROMPT, **dict(no_seq, prior_steps="dpmpp5"))),
        "negative_decoder_prompt": ("text2img", lambda p: p.generate_text2img(
            PROMPT, negative_decoder_prompt="blurry, low quality", **t2i)),
        "img2img": ("text2img", lambda p: p.generate_img2img(
            PROMPT, img, strength=0.7, noise=t2i["noise"],
            **dict(small, num_steps=20))),
        "inpainting": ("inpainting", lambda p: p.generate_inpainting(
            PROMPT, img, mask, noise=t2i["noise"], **small)),
        "mix_images": ("text2img", lambda p: p.mix_images(
            [PROMPT, img2], [0.4, 0.6], noise=t2i["noise"], **small)),
        "hires": ("hires", lambda p: p.generate_text2img_hires(
            PROMPT, strength=0.65, noise=hires_noise,
            **dict(small, h=128, w=128))),
        "turbo_interval 3": ("text2img", lambda p: p.generate_text2img(
            PROMPT, turbo_interval=3, **t2i)),
    }
    tol = 0.15  # phase 4's limit for the small CFG path
    for name, (task, run) in cases.items():
        gpu, cpu = pairs[task]
        for pipe in (gpu, cpu):
            inject_noise(pipe, 16, 64, np)
        reset_launch_counts()
        got = run(gpu)
        counts = launch_counts()
        want = run(cpu)
        for pipe in (gpu, cpu):
            del pipe.generate_clip_emb, pipe.generate_img
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        print(f"tasks small: {name} cuda/bf16 vs cpu/fp32 rel_l2 {rel:.3e} (tol {tol}); "
              f"shape {got.shape}; launches {json.dumps(counts)}")
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"tasks small: {name} shape or values")
        check(float(got.std()) > 0, f"tasks small: {name} image is constant")
        check(rel <= tol, f"tasks small: {name} on the card disagrees with the CPU")
        check(all(counts[n] > 0 for n in FORWARD_KERNELS),
              f"tasks small: {name} skipped a kernel")
    del pairs


def _timed_task(torch, np, name, call, smi, unet_calls, size=768, spans="k21.",
                decoder=DECODER_LAUNCHES, encoder=ENCODER_LAUNCHES, profiled=True):
    """One warm-up call, then one timed call with the launch counters and
    the peak memory reset just before it; checks the size² image and that
    K1, K2 and K3 ran exactly as often as ``unet_calls`` UNet calls and a
    codec encode and decode need (the MoVQ's by default); then, if
    ``profiled``, one call under the profiler with the ``spans`` stages.
    Returns (launch counts, seconds)."""
    from kandinsky2_tpu_torch.ops import launch_counts

    t0 = time.perf_counter()
    call(1)
    torch.cuda.synchronize()
    print(f"tasks full: {name} warm-up call {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = call(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"tasks full: {name} launches during the timed call {json.dumps(counts)}")
    check(img.shape == (1, size, size, 3), f"{name}: image shape {img.shape}")
    check(bool(np.isfinite(img).all()), f"{name}: image has non-finite values")
    check(float(img.std()) > 0, f"{name}: image is constant")
    check(all(counts[n] > 0 for n in FORWARD_KERNELS), f"{name}: a kernel was not launched")
    check_full_launches(f"tasks full: {name}", counts, unet_calls, encoded=True,
                        decoder=decoder, encoder=encoder)
    print(f"tasks full: {name} image min {img.min():.4f} max {img.max():.4f} std "
          f"{img.std():.4f}; peak device memory {peak:.2f} GiB")
    print(f"tasks full: {name} {seconds:.4f} s/image at {size}^2, batch 1, bf16 on {smi}")
    if not profiled:
        return counts, seconds
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call(3)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kernels = [e for e in events if not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    stages = {e.key: e.device_time_total / 1e3 for e in events
              if e.is_user_annotation and e.key.startswith(spans)}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print(f"tasks full: {name} profiled call {sum(e.count for e in kernels)} device "
          f"ops, {dev_ms:.1f} ms of device time, device idle share "
          f"{1 - dev_ms / 1e3 / seconds:.3f} of the unprofiled {seconds:.4f} s; "
          f"stages (device ms) " + "; ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + "; largest (ms, calls): " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ({e.count})"
              for e in top))
    return counts, seconds


def phase_img2img_full(torch, np, smi: str, pipe):
    """img2img of a seeded 768² image on the slice's full-width pipeline,
    strength 0.7 over the DDIM 50 ladder, bf16, batch 1."""
    from kandinsky2_tpu_torch.diffusion import make_ddim_tables, make_schedule

    strength = 0.7
    # the reference re-noises to t = 1000 (1 - strength) and runs the ladder
    # entries at or below it
    base = make_schedule(steps=1000, linear_start=0.00085, linear_end=0.012)
    steps = len(make_ddim_tables(base.base_alphas_cumprod, 50,
                                 init_step=int(1000 * (1 - strength))).timesteps)
    print(f"tasks full: img2img strength {strength}: {steps} of the 50 DDIM steps run")
    img = seeded_image(np, 17, 768)
    return _timed_task(torch, np, "img2img", lambda seed: pipe.generate_img2img(
        PROMPT, img, strength=strength,
        generator=torch.Generator(device="cuda").manual_seed(seed), **FULL_TASK), smi,
        unet_calls=steps)


def phase_inpainting_full(torch, np, smi: str):
    """Inpainting of the right half of a seeded 768² image on a fresh
    task_type="inpainting" pipeline at full width, DDIM 25, bf16, batch 1."""
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    t0 = time.perf_counter()
    pipe = Kandinsky2_1(tokenizer1=tok1, tokenizer2=tok2, task_type="inpainting",
                        dtype=torch.bfloat16, device="cuda")
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"tasks full: built the inpainting pipeline in {time.perf_counter() - t0:.2f} "
          f"s; UNet input conv {tuple(pipe.unet.input_blocks[0][0].weight.shape)}")
    img = seeded_image(np, 17, 768)
    mask = np.ones((768, 768), np.float32)
    mask[:, 384:] = 0.0  # keep the left half, inpaint the right
    return _timed_task(torch, np, "inpainting", lambda seed: pipe.generate_inpainting(
        PROMPT, img, mask, generator=torch.Generator(device="cuda").manual_seed(seed),
        **INPAINT_TASK), smi, unet_calls=INPAINT_TASK["num_steps"])

def phase_slice(torch, np, smi: str):
    from kandinsky2_tpu_torch.ops import launch_counts
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
    reset_path_counts()
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
    check(all(counts[n] > 0 for n in FORWARD_KERNELS), "a kernel was not launched")
    check_full_launches("slice", counts, kw["num_steps"], encoded=False)
    pil = process_images(img)
    check(len(pil) == 1 and pil[0].size == (768, 768), "process_images")
    print(f"slice: image min {img.min():.4f} max {img.max():.4f} "
          f"std {img.std():.4f}; peak device memory {peak:.2f} GiB")
    print(f"slice: {seconds:.4f} s/image at 768^2, 50 DDIM steps, prior 25, "
          f"CFG 4, batch 1, bf16 on {smi}")
    phase_slice_profile(torch, pipe, kw, seconds, smi)
    return counts, seconds, pipe


def phase_slice_profile(torch, pipe, kw, seconds, smi):
    """Host time per norm and attention call, one full-width UNet denoise
    call and one slice call under the profiler."""
    from kandinsky2_tpu_torch.ops import group_norm as gn
    from kandinsky2_tpu_torch.ops.flash_attention import flash_attention_fwd

    g = torch.Generator(device="cuda").manual_seed(12)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    # small UNet shapes, where the device keeps up with the host
    x = randn(2, 12, 12, 3072)
    scale, bias = torch.ones(3072, device="cuda"), torch.zeros(3072, device="cuda")
    film = randn(2, 1, 1, 6144).chunk(2, dim=-1)
    q, k, v = randn(2, 144, 24, 64), randn(2, 231, 24, 64), randn(2, 231, 24, 64)
    with torch.inference_mode():
        gn_us = host_us(lambda: gn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0,
                                              film=film))
        fa_us = host_us(lambda: flash_attention_fwd(q, k, v))
    print(f"slice: host time per call under inference_mode: group_norm "
          f"[2, 12, 12, 3072] FiLM SiLU {gn_us:.1f} us; flash_attention_fwd "
          f"B 2 T 144 S 231 H 24 {fa_us:.1f} us")

    # one CFG-doubled UNet denoise call at 768² (latent 96²)
    mc = pipe.config["model_config"]
    unet = pipe.unet
    with torch.inference_mode():
        xf_proj, xf_out = unet.encode_conditioning(
            randn(2, 77, mc["text_encoder_in_dim1"]), randn(2, mc["text_encoder_in_dim2"]),
            randn(2, mc["image_encoder_in_dim"]))
        xt = randn(2, 96, 96, mc["in_channels"])
        t = torch.tensor([981.0, 981.0], device="cuda")
        call = lambda: unet.denoise(xt, t, xf_proj, xf_out)
        groupnorm_tally("slice", unet, call)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_ms = sorted(walls)[1] * 1e3
        ops, dev_ms, _ = device_profile(torch, call)
    print(f"slice: one UNet denoise call [2, 96, 96, 4]: {ops} device ops, "
          f"{dev_ms:.1f} ms of device time, {wall_ms:.1f} ms wall (median of 3), "
          f"idle share {1 - dev_ms / wall_ms:.3f}")

    gen = torch.Generator(device="cuda").manual_seed(2)
    ops, dev_ms, events = device_profile(
        torch, lambda: pipe.generate_text2img(PROMPT, generator=gen, **kw))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print("slice: profiled call, device time by name (ms, calls): " + "; ".join(
        f"{e.key[:50]} {e.self_device_time_total / 1e3:.1f} ({e.count})" for e in top))
    print(f"slice: profiled call {ops} device ops, {dev_ms:.1f} ms of device time; "
          f"device idle share {1 - dev_ms / 1e3 / seconds:.3f} of the unprofiled "
          f"{seconds:.4f} s/image on {smi}")


def inject_noise22(pipe, seed: int, np):
    """Draw, from a numpy seed, the noise that a 2.2 pipeline would draw
    from its generator: x_T and the per-step noise (ddpm) of every
    ``run_prior`` call, x_T and the per-step noise (ddpm) of every
    decoder loop that is given none.  ``del pipe.run_prior,
    pipe._decode_loop`` undoes it."""
    import torch

    rng = np.random.RandomState(seed)
    run_prior, decode = pipe.run_prior, pipe._decode_loop
    D = pipe.prior.embedding_dim

    def run_prior22(prompt, batch_size=1, prior_steps=25, guidance_scale=4,
                    negative_prompt="", sampler="ddpm", noise=None, noise_seq=None,
                    **kw):
        x_T = rng.randn(batch_size, D).astype(np.float32)
        seq = (rng.randn(prior_steps, batch_size, D).astype(np.float32)
               if sampler == "ddpm" else None)
        return run_prior(prompt, batch_size, prior_steps, guidance_scale,
                         negative_prompt, sampler=sampler,
                         noise=x_T if noise is None else noise,
                         noise_seq=seq if noise_seq is None else noise_seq, **kw)

    def decode_loop(image_embeds, batch_size, steps, guidance, h, w, x_T=None,
                    ladder=None, sampler="ddpm", noise_seq=None, **kw):
        if x_T is None:
            x_T = torch.as_tensor(rng.randn(batch_size, h // 8, w // 8, 4)
                                  .astype(np.float32), device=pipe.device)
        n = steps if ladder is None else len(ladder)
        if noise_seq is None and sampler == "ddpm":
            noise_seq = rng.randn(n, *x_T.shape).astype(np.float32)
        return decode(image_embeds, batch_size, steps, guidance, h, w, x_T=x_T,
                      ladder=ladder, sampler=sampler, noise_seq=noise_seq, **kw)

    pipe.run_prior, pipe._decode_loop = run_prior22, decode_loop


def _small_pair22(torch, task_type, seed):
    """The small 2.2 pipeline (``configs.small_overrides22``) on the card
    (bf16) and on the CPU (fp32) with the same seeded weights.  The MoVQ's output conv is
    scaled by 0.2, which puts the random weights' image at a standard
    deviation of about 0.3, where the 8-bit images that hires upsamples
    keep their detail."""
    from kandinsky2_tpu_torch.configs import small_overrides22
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22

    kw = dict(task_type=task_type, tokenizer=stub_tokenizer22(64),
              overrides=small_overrides22())
    gpu = Kandinsky2_2(dtype=torch.bfloat16, device="cuda", **kw)
    gpu.init_random_params(torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        gpu.movq.decoder.conv_out.weight.mul_(0.2)
        gpu.movq.decoder.conv_out.bias.mul_(0.2)
    cpu = Kandinsky2_2(dtype=torch.float32, device="cpu", **kw)
    for name, model in cpu.models().items():
        model.load_state_dict({k: v.cpu() for k, v in
                               gpu.models()[name].state_dict().items()})
    return gpu, cpu


def phase_tasks22_small(torch, np):
    """Every 2.2 entry point at a small width on the card (kernels, bf16)
    against the CPU (plain versions, fp32), with the same weights and
    injected noise; the limit is phase 4's."""
    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts

    pairs = {task: _small_pair22(torch, task, seed) for task, seed in
             (("text2img", 21), ("inpainting", 22), ("controlnet", 23))}
    rng = np.random.RandomState(24)
    lat = lambda *shape: rng.randn(*shape).astype(np.float32)
    small = dict(decoder_steps=10, prior_steps=5, h=64, w=64, output="float")
    img, img2 = seeded_image(np, 25, 64), seeded_image(np, 26, 64)
    mask = np.zeros((64, 64), np.float32)
    mask[:, 32:] = 1.0  # repaint the right half
    hint = rng.rand(64, 64, 3).astype(np.float32)
    emb = lat(32)
    # the re-noising draws, which the entry points take as noise=
    renoise, hires_noise = lat(1, 8, 8, 4), lat(1, 16, 16, 4)
    emb_noise, emb_seq = lat(1, 32), lat(3, 1, 32)
    cases = {
        "text2img ddpm": ("text2img", lambda p: p.generate_text2img(PROMPT, **small)),
        "text2img dpmpp": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="dpmpp", **small)),
        "text2img dpmpp_karras": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="dpmpp_karras", **small)),
        "text2img prior dpmpp": ("text2img", lambda p: p.generate_text2img(
            PROMPT, prior_sampler="dpmpp", **small)),
        "img2img": ("text2img", lambda p: p.generate_img2img(
            PROMPT, img, strength=0.5, noise=renoise,
            **dict(small, decoder_steps=20))),
        "mix_images": ("text2img", lambda p: p.mix_images(
            [PROMPT, img2], [0.4, 0.6], **small)),
        "inpainting": ("inpainting", lambda p: p.generate_inpainting(
            PROMPT, img, mask, **small)),
        "controlnet hint": ("controlnet", lambda p: p.generate_controlnet(
            PROMPT, hint, **small)),
        "turbo_interval 3": ("text2img", lambda p: p.generate_text2img(
            PROMPT, turbo_interval=3, **small)),
        "run_prior_emb2emb": ("text2img", lambda p: p.run_prior_emb2emb(
            emb, PROMPT, strength=0.6, prior_steps=5, noise=emb_noise,
            noise_seq=emb_seq).float().cpu().numpy()),
    }
    tol = 0.15  # phase 4's limit for the small CFG path
    for name, (task, run) in cases.items():
        gpu, cpu = pairs[task]
        for pipe in (gpu, cpu):
            inject_noise22(pipe, 27, np)
        reset_launch_counts()
        got = run(gpu)
        counts = launch_counts()
        want = run(cpu)
        for pipe in (gpu, cpu):
            del pipe.run_prior, pipe._decode_loop
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        print(f"tasks22 small: {name} cuda/bf16 vs cpu/fp32 rel_l2 {rel:.3e} "
              f"(tol {tol}); shape {got.shape}; launches {json.dumps(counts)}")
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"tasks22 small: {name} shape or values")
        check(float(got.std()) > 0, f"tasks22 small: {name} output is constant")
        check(rel <= tol, f"tasks22 small: {name} on the card disagrees with the CPU")
        if name != "run_prior_emb2emb":  # the prior has no GroupNorm or K3
            check(all(counts[n] > 0 for n in FORWARD_KERNELS),
                  f"tasks22 small: {name} skipped a kernel")
    _hires22_small(pairs["text2img"], hires_noise, dict(small, h=128, w=128), tol, np)
    del pairs


def _hires22_small(pair, noise, kw, tol, np):
    """Hires with the UNet as drawn, held to ``tol`` end to end and in its
    two parts: the first stage's 8-bit images against the CPU's, and the
    output against the CPU's second stage run from the card's first-stage
    images.  With random weights the second stage turns a small change of
    those images into a change of its output many times larger, in fp32
    alone, so the CPU's own response to the card's images is printed
    beside the end-to-end distance: it is the larger part of that."""
    from PIL import Image

    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts

    def run(pipe, ups=None):
        """``pipe``'s hires output and the first-stage images it refined
        (``ups`` replaces them)."""
        seen = []
        img2img = pipe.generate_img2img

        def refine(prompt, images, **kw2):
            seen.append([np.asarray(im, np.float32) for im in images])
            return img2img(prompt, images if ups is None else ups, **kw2)

        inject_noise22(pipe, 27, np)
        pipe.generate_img2img = refine
        try:
            out = pipe.generate_text2img_hires(PROMPT, strength=0.5, noise=noise, **kw)
        finally:
            del pipe.run_prior, pipe._decode_loop, pipe.generate_img2img
        return out, seen[0]

    gpu, cpu = pair
    reset_launch_counts()
    got, gpu_ups = run(gpu)
    counts = launch_counts()
    want_own, cpu_ups = run(cpu)
    want, _ = run(cpu, [Image.fromarray(u.astype(np.uint8)) for u in gpu_ups])
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    stage1, stage2 = rel(np.stack(gpu_ups), np.stack(cpu_ups)), rel(got, want)
    whole = rel(got, want_own)
    print(f"tasks22 small: hires cuda/bf16 vs cpu/fp32 rel_l2 {whole:.3e}; first "
          f"stage's 8-bit images {stage1:.3e}, output from the card's images "
          f"{stage2:.3e} (tol {tol} each); the CPU's own response to the card's "
          f"images {rel(want, want_own):.3e}; shape {got.shape}; "
          f"launches {json.dumps(counts)}")
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          "tasks22 small: hires shape or values")
    check(float(got.std()) > 0, "tasks22 small: hires output is constant")
    check(max(whole, stage1, stage2) <= tol,
          "tasks22 small: hires on the card disagrees with the CPU")
    check(all(counts[n] > 0 for n in FORWARD_KERNELS),
          "tasks22 small: hires skipped a kernel")


def phase_t2i22(torch, np, smi: str):
    """Kandinsky 2.2 text2img at the published configuration, 768²."""
    from kandinsky2_tpu_torch.ops import launch_counts
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22
    from kandinsky2_tpu_torch.weights.configs22 import pipeline_overrides

    t0 = time.perf_counter()
    pipe = Kandinsky2_2(tokenizer=stub_tokenizer22(), dtype=torch.bfloat16,
                        overrides=pipeline_overrides(task_type="text2img"),
                        device="cuda")
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in pipe.models().items()}
    print(f"t2i22: built the full-size 2.2 pipeline in {time.perf_counter() - t0:.2f} "
          f"s, params {json.dumps(n_params)} ({sum(n_params.values())} in all)")
    call = lambda seed: pipe.generate_text2img(
        PROMPT, generator=torch.Generator(device="cuda").manual_seed(seed), **T2I22)
    t0 = time.perf_counter()
    call(1)
    torch.cuda.synchronize()
    print(f"t2i22: warm-up call {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = call(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"t2i22: launches during the timed call {json.dumps(counts)}")
    check(img.shape == (1, 768, 768, 3), f"t2i22: image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "t2i22: image has non-finite values")
    check(float(img.std()) > 0, "t2i22: image is constant")
    # a UNet22 call runs 95 GroupNorms and 22 attentions, as 2.1's UNet
    check_full_launches("t2i22", counts, T2I22["decoder_steps"], encoded=False)
    print(f"t2i22: image min {img.min():.4f} max {img.max():.4f} std {img.std():.4f}; "
          f"peak device memory {peak:.2f} GiB")
    print(f"t2i22: {seconds:.4f} s/image at 768^2, prior 25 and decoder 50 DDPM "
          f"steps, CFG 4 and 4, batch 1, bf16 on {smi}")

    # one CFG-doubled UNet22 denoise call at 768² (latent 96²): its
    # GroupNorm input shapes, device ops and device time
    g = torch.Generator(device="cuda").manual_seed(12)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    unet = pipe.unet
    with torch.inference_mode():
        cond = unet.encode_conditioning(randn(2, unet.encoder_hid_dim))
        xt, t = randn(2, 96, 96, 4), torch.tensor([981.0, 981.0], device="cuda")
        denoise = lambda: unet.denoise(xt, t, *cond)
        tally = groupnorm_tally("t2i22", unet, denoise)
        ops, dev_ms, _ = device_profile(torch, denoise)
    print(f"t2i22: one UNet22 denoise call [2, 96, 96, 4]: {ops} device ops, "
          f"{dev_ms:.1f} ms of device time")
    check(sum(tally.values()) == UNET_LAUNCHES[0], "t2i22: GroupNorms per UNet22 call")
    profiled_image(torch, "t2i22", lambda: call(3), seconds, "k22.")
    return counts, seconds, pipe


def _small_pair20(torch, task_type, seed):
    """The small 2.0 pipeline (``configs.small_config20`` with 64-wide UNet
    heads, so that K3 takes the UNet's attention and the KL-VAE's 64-wide
    mid attention) on the card (bf16) and on the CPU (fp32) with the same
    seeded weights.  The KL-VAE's output conv is scaled by 0.1, as in the
    CPU tests: the random weights' image then lies at |x| ~ 2."""
    from kandinsky2_tpu_torch.configs import small_config20
    from kandinsky2_tpu_torch.pipelines import Kandinsky2
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok, _ = stub_tokenizers(64)
    kw = dict(config=small_config20(head_channels=64), tokenizer1=tok, tokenizer2=tok,
              task_type=task_type)
    gpu = Kandinsky2(dtype=torch.bfloat16, device="cuda", **kw)
    gpu.init_random_params(torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        gpu.image_encoder.decoder.conv_out.weight.mul_(0.1)
        gpu.image_encoder.decoder.conv_out.bias.mul_(0.1)
    cpu = Kandinsky2(dtype=torch.float32, device="cpu", **kw)
    for name, model in cpu.models().items():
        model.load_state_dict({k: v.cpu() for k, v in
                               gpu.models()[name].state_dict().items()})
    return gpu, cpu


def fix_posterior20(pipe, noise):
    """Make a 2.0 pipeline's KL posterior draw mean + exp(logvar / 2) ·
    ``noise`` (a seeded numpy array), so that the card and the CPU draw the
    same; ``del pipe._vae_encode_sample`` undoes it."""
    import torch

    def sample(image, generator=None):
        x = torch.as_tensor(image, device=pipe.device).to(pipe.dtype)
        mean, logvar = pipe.image_encoder.encode(x)
        n = torch.as_tensor(noise, device=pipe.device)
        return (mean.float() + torch.exp(0.5 * logvar.float()) * n).float()

    pipe._vae_encode_sample = sample


def phase_tasks20_small(torch, np):
    """Every 2.0 entry point and sampler at a small width on the card
    (kernels, bf16) against the CPU (plain versions, fp32), with the same
    weights and injected noise (x_T, the per-step noise of the p_sampler
    and of DDIM at eta 0.05, the re-noising draw and the KL posterior's);
    the limit is phase 4's.  img2img and inpainting work at 512², as the
    reference's."""
    from kandinsky2_tpu_torch.diffusion.schedules import ddim_ladder
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention

    pairs = {task: _small_pair20(torch, task, seed) for task, seed in
             (("text2img", 31), ("inpainting", 32))}
    rng = np.random.RandomState(33)
    lat = lambda *shape: rng.randn(*shape).astype(np.float32)
    t2i = dict(num_steps=10, guidance_scale=4, h=64, w=64, noise=lat(1, 8, 8, 4),
               output="float")
    nseq = lat(10, 1, 8, 8, 4)
    posterior, renoise, x_T512 = lat(1, 64, 64, 4), lat(1, 64, 64, 4), lat(1, 64, 64, 4)
    nseq512 = lat(10, 1, 64, 64, 4)
    n_i2i = len(ddim_ladder(10, init_step=300))  # strength 0.7: t <= 300
    latents = 0.05 * lat(1, 8, 8, 4)
    img = seeded_image(np, 34, 96)
    mask = np.ones((96, 96), np.float32)
    mask[:, 48:] = 0.0  # keep the left half
    small = dict(num_steps=10, guidance_scale=4, output="float")
    cases = {
        "text2img ddim_sampler eta 0.05": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="ddim_sampler", noise_seq=nseq, **t2i)),
        "text2img p_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="p_sampler", noise_seq=nseq, **t2i)),
        "text2img plms_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="plms_sampler", **t2i)),
        "text2img dpmpp_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="dpmpp_sampler", **t2i)),
        "text2img dpmpp_karras_sampler": ("text2img", lambda p: p.generate_text2img(
            PROMPT, sampler="dpmpp_karras_sampler", **t2i)),
        "img2img strength 0.7": ("text2img", lambda p: p.generate_img2img(
            PROMPT, img, strength=0.7, noise=renoise, noise_seq=nseq512[:n_i2i],
            **small)),
        "inpainting": ("inpainting", lambda p: p.generate_inpainting(
            PROMPT, img, mask, noise=x_T512, noise_seq=nseq512, **small)),
        "decode_latents": ("text2img", lambda p: p.decode_latents(latents,
                                                                  output="float")),
    }
    tol = 0.15  # phase 4's limit for the small CFG path
    for name, (task, run) in cases.items():
        gpu, cpu = pairs[task]
        for pipe in (gpu, cpu):
            fix_posterior20(pipe, posterior)
        reset_path_counts()
        got = run(gpu)
        counts, plain = launch_counts(), qkv_attention.plain_on_card
        want = run(cpu)
        for pipe in (gpu, cpu):
            del pipe._vae_encode_sample
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        print(f"tasks20 small: {name} cuda/bf16 vs cpu/fp32 rel_l2 {rel:.3e} "
              f"(tol {tol}); shape {got.shape}; launches {json.dumps(counts)}; "
              f"attention calls on the card by the plain route {plain}")
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"tasks20 small: {name} shape or values")
        check(float(got.std()) > 0, f"tasks20 small: {name} image is constant")
        check(rel <= tol, f"tasks20 small: {name} on the card disagrees with the CPU")
        check(all(counts[n] > 0 for n in FORWARD_KERNELS),
              f"tasks20 small: {name} skipped a kernel")
        check(plain == 0, f"tasks20 small: {name}: {plain} attention calls missed K3")
    del pairs


def phase_t2i20(torch, np, smi: str):
    """Kandinsky 2.0 at CONFIG_2_0 (2.01B parameters), as
    ``generate_text2img(prompt)`` is called with its own defaults (512²,
    DDIM at eta 0.05, guidance 7, batch 1) at T2I20_STEPS, bf16; then img2img at
    strength 0.7 on that pipeline, and inpainting on a
    task_type="inpainting" one.  Returns (text2img launch counts, s/image,
    {task: (launch counts, s/image)})."""
    from kandinsky2_tpu_torch.diffusion.schedules import ddim_ladder
    from kandinsky2_tpu_torch.ops import launch_counts
    from kandinsky2_tpu_torch.pipelines import Kandinsky2
    from kandinsky2_tpu_torch.utils import process_images, stub_tokenizers

    tok, _ = stub_tokenizers()
    t0 = time.perf_counter()
    pipe = Kandinsky2(tokenizer1=tok, tokenizer2=tok, dtype=torch.bfloat16,
                      device="cuda")
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in pipe.models().items()}
    print(f"t2i20: built the full-size 2.0 pipeline in {time.perf_counter() - t0:.2f} "
          f"s, params {json.dumps(n_params)} ({sum(n_params.values())} in all)")
    call = lambda seed: pipe.generate_text2img(
        PROMPT, generator=torch.Generator(device="cuda").manual_seed(seed), **T2I20)
    t0 = time.perf_counter()
    call(1)
    torch.cuda.synchronize()
    print(f"t2i20: warm-up call {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = call(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    S = T2I20_SIZE
    print(f"t2i20: launches during the timed call {json.dumps(counts)}")
    check(img.shape == (1, S, S, 3), f"t2i20: image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "t2i20: image has non-finite values")
    check(float(img.std()) > 0, "t2i20: image is constant")
    check(len(process_images(img)) == 1, "t2i20: process_images")
    # K1 = K2 = 100 × 95 + 30 and K3 = 100 × 22 + 1: the UNet calls of the
    # DDIM ladder and one KL-VAE decode, nothing else with a GroupNorm or an
    # unmasked attention (the text towers' attention is masked or pooled)
    check_full_launches("t2i20", counts, T2I20_STEPS, encoded=False,
                        decoder=KL_DECODER_LAUNCHES)
    print(f"t2i20: image min {img.min():.4f} max {img.max():.4f} std {img.std():.4f}; "
          f"peak device memory {peak:.2f} GiB")
    print(f"t2i20: {seconds:.4f} s/image at {S}^2, DDIM {T2I20_STEPS} at eta 0.05, "
          f"guidance 7, batch 1, bf16 on {smi}")

    # one CFG-doubled Text2ImUNet20 denoise call at 512² (latent 64²): its
    # GroupNorm input shapes, device ops and device time
    g = torch.Generator(device="cuda").manual_seed(12)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    unet, mc = pipe.unet, pipe.config["model_config"]
    with torch.inference_mode():
        cond = unet.encode_conditioning(randn(2, 77, mc["text_encoder_in_dim1"]),
                                        randn(2, mc["text_encoder_in_dim2"]),
                                        randn(2, 77, 512))
        xt, t = randn(2, S // 8, S // 8, 4), torch.tensor([981.0, 981.0], device="cuda")
        denoise = lambda: unet.denoise(xt, t, *cond)
        tally = groupnorm_tally("t2i20", unet, denoise)
        ops, dev_ms, _ = device_profile(torch, denoise)
    print(f"t2i20: one Text2ImUNet20 denoise call [2, {S // 8}, {S // 8}, 4]: {ops} "
          f"device ops, {dev_ms:.1f} ms of device time")
    check(sum(tally.values()) == UNET_LAUNCHES[0], "t2i20: GroupNorms per UNet call")
    profiled_image(torch, "t2i20", lambda: call(3), seconds, "k20.")

    # unprofiled: the text2img call above shows where a 2.0 image's time
    # goes, and a profiled call costs the script tens of seconds
    kl = dict(size=S, spans="k20.", decoder=KL_DECODER_LAUNCHES,
              encoder=KL_ENCODER_LAUNCHES, profiled=False)
    img_in = seeded_image(np, 17, S)
    steps = len(ddim_ladder(T2I20_STEPS, init_step=300))
    print(f"t2i20: img2img strength 0.7: {steps} of the {T2I20_STEPS} DDIM steps run")
    tasks = {"img2img20": _timed_task(
        torch, np, "2.0 img2img", lambda seed: pipe.generate_img2img(
            PROMPT, img_in, strength=0.7, num_steps=T2I20_STEPS, output="float",
            generator=torch.Generator(device="cuda").manual_seed(seed)),
        smi, unet_calls=steps, **kl)}
    del pipe, unet, cond, denoise, xt
    gc.collect()
    torch.cuda.empty_cache()
    pipe = Kandinsky2(tokenizer1=tok, tokenizer2=tok, task_type="inpainting",
                      dtype=torch.bfloat16, device="cuda")
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
    mask = np.ones((S, S), np.float32)
    mask[:, S // 2:] = 0.0  # keep the left half, inpaint the right
    tasks["inpainting20"] = _timed_task(
        torch, np, "2.0 inpainting", lambda seed: pipe.generate_inpainting(
            PROMPT, img_in, mask, num_steps=T2I20_STEPS, output="float",
            generator=torch.Generator(device="cuda").manual_seed(seed)),
        smi, unet_calls=T2I20_STEPS, **kl)
    return counts, seconds, tasks


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_kernels_backward(torch, results):
    import torch.nn.functional as F

    from kandinsky2_tpu_torch.ops import group_norm as gn
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    g = torch.Generator(device="cuda").manual_seed(6)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # the UNet attention of the decoder training step at 768², batch 1:
    # (B, T, S = T + 87 encoder tokens, H), d = 64; the 2.2 UNet22's added-KV
    # attention in the LoRA and distillation steps at 768², batch 1 (S = T +
    # 10 image tokens, H = 768/64, 1280/64 and 1536/64); and a ragged toy
    # shape (T and S below one tile), checked but not timed
    attn_shapes = [
        ("unet ds2", (1, 2304, 2391, 12)),
        ("unet ds4", (1, 576, 663, 18)),
        ("unet ds8/middle", (1, 144, 231, 24)),
        ("unet22 ds2", (1, 2304, 2314, 12)),
        ("unet22 ds4", (1, 576, 586, 20)),
        ("unet22 ds8/middle", (1, 144, 154, 24)),
        ("ragged toy", (2, 37, 50, 1)),
    ]
    for label, (B, T, S, H) in attn_shapes:
        d = 64
        q, k, v = randn((B, T, H, d)), randn((B, S, H, d)), randn((B, S, H, d))
        do = randn((B, T, H, d))
        o, lse = flash_attention_fwd(q, k, v)
        k5 = lambda: flash_attention_bwd_dq(q, k, v, o, do, lse)
        (dq, delta), (dq2, delta2) = k5(), k5()
        k4 = lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        (dk, dv), (dk2, dv2) = k4(), k4()
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
        delta_ref = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, T)
        torch.cuda.synchronize()
        # P and dS are rounded to bf16 before their MMAs (fp32 in the plain
        # version): 2e-2 of the largest reference gradient
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            errs[name] = ((got.float() - want.float()).abs().max().item(),
                          rel_err(got, want))
            check(errs[name][1] <= 2e-2, f"K4/K5 {name} disagrees at {label}")
        # one writer per element and no atomics: two calls are bitwise equal
        repeat = all(torch.equal(a, b) for a, b in
                     ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
        check(repeat, f"K4/K5 are not bitwise repeatable at {label}")
        # delta: the same fp32 products as rowsum(dO·O), summed in another order
        delta_err = rel_err(delta, delta_ref)
        check(delta_err <= 1e-5, f"K5's delta disagrees at {label}")
        print(f"K5 dQ      {label} B={B} T={T} S={S} H={H} d=64: max_abs_err "
              f"{errs['dq'][0]:.3e} max_rel_err {errs['dq'][1]:.3e} (tol 2e-2); delta "
              f"max_rel_err {delta_err:.3e} (tol 1e-5); bitwise repeatable {repeat}")
        print(f"K4 dK/dV   {label} B={B} T={T} S={S} H={H} d=64: max_abs_err "
              f"{max(errs['dk'][0], errs['dv'][0]):.3e} max_rel_err dk "
              f"{errs['dk'][1]:.3e} dv {errs['dv'][1]:.3e} (tol 2e-2)")
        if label == "ragged toy":
            continue
        # the library's backward: scaled_dot_product_attention's, for dq, dk
        # and dv together (delta included), from its own saved forward
        qg, kg, vg = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg)
        dot = do.permute(0, 2, 1, 3)
        times = timed_turns({
            "plain": lambda: flash_attention_bwd_plain(q, k, v, o, lse, do),
            "k5": k5, "k4": k4,
            "backward": lambda: flash_attention_bwd(q, k, v, o, lse, do),
            "library": lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                                   retain_graph=True)}, 10)
        qo_bytes, kv_bytes, row_bytes = 2 * B * T * H * d, 2 * B * S * H * d, 4 * B * H * T
        # K5 reads q, dO, O, k, v and LSE, writes dq and delta; K4 reads q,
        # dO, k, v, LSE and delta, writes dk and dv; the whole backward reads
        # q, dO, O, k, v and LSE and writes dq, dk and dv.  K5 and K4 each
        # recompute S and dP (6 and 8 T·S·d FLOP); the function itself needs
        # S, dP, dV, dK and dQ once each: 10 T·S·d
        b5 = bound(6 * B * H * T * S * d, 4 * qo_bytes + 2 * kv_bytes + 2 * row_bytes,
                   PEAK_BF16)
        b4 = bound(8 * B * H * T * S * d, 2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes,
                   PEAK_BF16)
        bb = bound(10 * B * H * T * S * d, 4 * qo_bytes + 4 * kv_bytes + row_bytes,
                   PEAK_BF16)
        t5 = {"kernel": times["k5"], "plain": times["plain"], "library": times["library"]}
        t4 = {"kernel": times["k4"], "plain": times["plain"], "library": times["library"]}
        tb = {"kernel": times["backward"], "plain": times["plain"],
              "library": times["library"]}
        _print_times("K5 dQ     ", label, t5, *b5)
        _print_times("K4 dK/dV  ", label, t4, *b4)
        _print_times("K5 + K4   ", label, tb, *bb)
        print(f"  (plain: the whole plain backward; library: the backward of "
              f"scaled_dot_product_attention, dq, dk and dv together; K5 + K4: "
              f"flash_attention_bwd, {times['backward'] / times['library']:.2f}x "
              f"the library's time)")
        results["flash_attention_bwd_dq"].append(
            _row(label, (B, T, S, H, d), errs["dq"][0], t5, *b5))
        results["flash_attention_bwd_dkv"].append(
            _row(label, (B, T, S, H, d), max(errs["dk"][0], errs["dv"][0]), t4, *b4))
        del qg, kg, vg, out, dot
    del q, k, v, do, o, lse, delta, dq, dk, dv, ref, dq2, dk2, dv2, delta2

    # GroupNormFunction at the UNet ds1 shape, with FiLM and SiLU
    x = randn((1, 96, 96, 384))
    scale = 1 + 0.1 * randn((384,), torch.float32)
    bias = 0.1 * randn((384,), torch.float32)
    fs, fb = 0.1 * randn((1, 1, 1, 384)), randn((1, 1, 1, 384))
    ins = [t.requires_grad_() for t in (x, scale, bias, fs, fb)]
    gy = randn((1, 96, 96, 384))
    y = gn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=(fs, fb))
    check(y.requires_grad and type(y.grad_fn).__name__ == "GroupNormFunctionBackward",
          "group_norm on the card carries no gradient")
    fn = lambda: torch.autograd.grad(
        gn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=(fs, fb)), ins, gy)
    plain = lambda: torch.autograd.grad(
        gn.group_norm_plain(x, scale, bias, 32, 1e-5, swish=1.0, film=(fs, fb)),
        ins, gy)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    # the backward is autograd of the same plain formulation: equal up to
    # bf16 rounding of the gradients of the bf16 inputs
    check(all(e <= 1e-2 for e in errs), "GroupNormFunction gradients disagree")
    # about a hundred launches per forward + backward: 4 of them fit the queue
    t = timed_turns({"function": fn, "plain": plain}, 4)
    f_ms, p_ms = t["function"], t["plain"]
    print(f"GroupNormFunction fwd+bwd [1, 9216, 384] FiLM SiLU: max_rel_err x "
          f"{errs[0]:.3e} scale {errs[1]:.3e} bias {errs[2]:.3e} fs {errs[3]:.3e} "
          f"fb {errs[4]:.3e} (tol 1e-2); Function {f_ms:.4f} ms, autograd of the "
          f"plain formulation {p_ms:.4f} ms")
    torch.cuda.synchronize()


def _small_batch(torch, np, mc, seed):
    rng = np.random.RandomState(seed)
    arr = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32))
    return {"image_latents": arr(2, 8, 8, 4),
            "full_emb": arr(2, 12, mc["text_encoder_in_dim1"]),
            "pooled_emb": arr(2, mc["text_encoder_in_dim2"]),
            "image_emb": arr(2, mc["image_encoder_in_dim"])}


def phase_train_small(torch, np):
    """The CLI's run with a save and a resume, then one train step on the
    card against the CPU."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts
    from kandinsky2_tpu_torch.train import train_2_1_unclip as cli
    from kandinsky2_tpu_torch.train.checkpoint import latest_train_state

    rng = np.random.RandomState(7)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "img").mkdir()
        rows = ["image_name,caption"]
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
                tmp / "img" / f"{i}.png")
            rows.append(f"{i}.png,a seeded picture {i}")
        (tmp / "data.csv").write_text("\n".join(rows) + "\n")
        cfg = cli.small_train_config(str(tmp / "data.csv"), str(tmp / "img"),
                                     str(tmp / "ckpt"), head_channels=64)
        reset_launch_counts()
        first = cli.run(cfg, device="cuda")  # one epoch: 2 steps, saved at 2
        counts = launch_counts()
        fname, step = latest_train_state(str(tmp / "ckpt"))
        check(first.step == 2 and step == 2, "the first run did not save step 2")
        saved = torch.load(fname, map_location="cpu", weights_only=True)
        for name, v in first.model.state_dict().items():
            check(torch.equal(saved["params"][name], v.cpu()), f"saved {name}")
        check(all(n > 0 for n in counts.values()), f"small run skipped a kernel: {counts}")
        del first, saved  # the "kill": the resumed run shares nothing with it
        second = cli.run(cfg, device="cuda")  # a fresh pipeline resumes at 2
        opt_steps = {s["step"] for s in second.optimizer.state.values()}
        check(second.step == 4 and opt_steps == {4},
              f"the resumed run did not continue from the save: {second.step} {opt_steps}")
        check(all(bool(torch.isfinite(p).all()) for p in second.model.parameters()),
              "resumed parameters not finite")
        print(f"train small: run 2 steps, save, kill, resume 2 steps: step "
              f"{second.step}; launches in the first run {json.dumps(counts)}")
        del second

    run = _small_unclip_step(torch, np, inpainting=False)
    # the same step in bf16 against fp32, both on the CPU with the plain
    # versions, gives 1.6e-4 on the loss and 9.9e-3 on the gradients
    card_against_cpu(torch, "train small: one step", run)


def _small_unclip_step(torch, np, inpainting: bool):
    """run(dev) -> (loss, flat gradient): one decoder loss and backward of
    the small 2.1 UNet (64-wide heads; the 9-channel one with seeded masks
    where ``inpainting``) with the same weights, batch, t and noise; fp32
    on the CPU, bf16 compute with fp32 parameters on the card."""
    from kandinsky2_tpu_torch.configs import CONFIG_2_1, create_model, schedule_kwargs
    from kandinsky2_tpu_torch.diffusion import make_schedule
    from kandinsky2_tpu_torch.pipelines.base import init_random_
    from kandinsky2_tpu_torch.train import train_2_1_unclip as cli
    from kandinsky2_tpu_torch.train.masks import get_image_mask
    from kandinsky2_tpu_torch.train.train_unclip import unclip_loss

    mc = dict(cli.small_train_config("", "", "", head_channels=64)["model_config"],
              inpainting=inpainting)
    cpu = create_model(**mc, dtype=torch.float32)
    init_random_(cpu, torch.Generator().manual_seed(8))
    gpu = create_model(**mc, dtype=torch.bfloat16, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    skw = schedule_kwargs(CONFIG_2_1["diffusion_config"], "")
    batch = _small_batch(torch, np, mc, 9)
    if inpainting:
        np.random.seed(14)
        mask = torch.tensor(get_image_mask(2, (8, 8))[..., None].astype(np.float32))
        batch.update(inpaint_mask=mask, inpaint_image=batch["image_latents"] * mask)
    t = torch.tensor([5, 700])
    noise = torch.tensor(np.random.RandomState(10).randn(2, 8, 8, 4).astype(np.float32))

    def run(dev):
        unet = gpu if dev == "cuda" else cpu
        loss, _ = unclip_loss(
            unet, make_schedule(**skw["make_schedule"], device=dev),
            {k: v.to(dev) for k, v in batch.items()}, t.to(dev), noise.to(dev),
            torch.ones(2, device=dev), mean_type=skw["mean_type"],
            var_type=skw["var_type"], loss_type=skw["loss_type"])
        loss.backward()
        return loss.item(), torch.cat([p.grad.float().cpu().flatten()
                                       for p in unet.parameters()])

    return run


def card_against_cpu(torch, name, run, kernels=True) -> dict:
    """One step on the card (kernels, bf16) against the same step on the
    CPU (plain versions, fp32): ``run(dev)`` -> (loss, flat gradient).  The
    loss within 1e-2 relative, the gradient within 5e-2 relative L2 and
    finite; every kernel launched on the card (none where ``kernels`` is
    false).  Returns the card's launches."""
    from kandinsky2_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    loss_gpu, g_gpu = run("cuda")
    counts = launch_counts()
    loss_cpu, g_cpu = run("cpu")
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_rel = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    print(f"{name} cuda/bf16 vs cpu/fp32: loss {loss_gpu:.6f} vs {loss_cpu:.6f} rel "
          f"{loss_rel:.3e} (tol 1e-2); gradient rel_l2 {grad_rel:.3e} (tol 5e-2) over "
          f"{g_cpu.numel()} values; launches {json.dumps(counts)}")
    check(bool(torch.isfinite(g_gpu).all()), f"{name}: card gradients not finite")
    check(loss_rel <= 1e-2, f"{name}: the loss on the card disagrees with the CPU")
    check(grad_rel <= 5e-2, f"{name}: the gradients on the card disagree with the CPU")
    if kernels:
        check(all(n > 0 for n in counts.values()), f"{name} skipped a kernel: {counts}")
    else:
        check(not any(counts.values()), f"{name} launched a kernel: {counts}")
    return counts


def phase_train_full(torch, np, smi: str, name="train full", task_type="text2img",
                     optim_params=None, state_bytes_per_param=None):
    """Decoder train steps at full width (``task_type`` "inpainting": the
    9-channel UNet on the CLI's masked batches) with the optimizer that
    ``optim_params`` names through ``optimizer_from_config`` (the YAML's
    Adafactor at 5e-6 by default): a warm-up step with every trainable
    gradient checked, then ``timed_steps``' warm-up, five timed steps and a
    profiled one; then one optimizer step alone, profiled on the same
    trainable tensors with seeded gradients, and the optimizer state's
    bytes (required to be ``state_bytes_per_param`` a trainable value
    where given)."""
    from kandinsky2_tpu_torch.configs import CONFIG_2_1
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.train import train_2_1_unclip as cli
    from kandinsky2_tpu_torch.train.optim import decoder_freeze_mask, optimizer_from_config
    from kandinsky2_tpu_torch.train.train_unclip import make_unclip_train_step
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    t0 = time.perf_counter()
    tok1 = stub_tokenizers()[0]
    pipe = Kandinsky2_1(tokenizer1=tok1, task_type=task_type, dtype=torch.bfloat16,
                        device="cuda")
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.float32)
    unet = pipe.unet
    # train_configs/config_unclip_2_1.yaml: freeze_resblocks, Adafactor at
    # 5e-6, EMA 0.9999, uniform sampler, no remat
    optim_params = optim_params or {"name": "optax.adafactor",
                                    "params": {"learning_rate": 5e-6}}
    init_state, train_step = make_unclip_train_step(
        unet, CONFIG_2_1["diffusion_config"], optimizer_from_config(optim_params),
        ema_decay=0.9999, remat=False)
    mask = decoder_freeze_mask(unet, freeze_resblocks=True, freeze_attention=False)
    state = init_state(mask, seed=0)
    prepare_batch = cli.make_prepare_batch(pipe)
    np.random.seed(12)  # the inpainting masks' draws (train/masks.py)
    rng = np.random.RandomState(11)
    enc = tok1(["red sand dunes under a violet sky"], max_length=77)
    raw = {"image": np.tanh(rng.randn(1, 768, 768, 3)).astype(np.float32),
           "clip_image": rng.randn(1, 224, 224, 3).astype(np.float32),
           "tokens": enc["input_ids"], "mask": enc["attention_mask"]}
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    torch.cuda.synchronize()
    n_train = sum(p.numel() for n, p in unet.named_parameters() if mask[n])
    n_all = sum(p.numel() for p in unet.parameters())
    in_ch = unet.input_blocks[0][0].in_channels
    print(f"{name}: built in {time.perf_counter() - t0:.2f} s; UNet {n_all} "
          f"parameters, {in_ch} input channels, {n_train} trainable in "
          f"{sum(mask.values())} tensors")
    if task_type == "inpainting":
        b = prepare_batch(raw)
        share = float(b["inpaint_mask"].mean())
        print(f"{name}: a batch's mask {list(b['inpaint_mask'].shape)}, {share:.3f} "
              "of it kept")
        check(0.0 < share < 1.0 and torch.equal(
            b["inpaint_image"], b["image_latents"] * b["inpaint_mask"]),
            f"{name}: the batch's mask or masked latents")
        del b

    # warm-up step, with every trainable gradient checked before the update
    report = {}

    def check_grads(opt, args, kwargs):
        bad = [n for n, p in unet.named_parameters() if mask[n] and (
            p.grad is None or not bool(torch.isfinite(p.grad).all())
            or not bool(p.grad.any()))]
        report.update(checked=sum(mask.values()), bad=bad)

    hook = state.optimizer.register_step_pre_hook(check_grads)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = train_step(state, prepare_batch(raw))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    hook.remove()
    print(f"{name}: warm-up step {warm_s:.3f} s, loss {float(metrics['loss']):.5f}; "
          f"{report['checked']} trainable tensors checked, {len(report['bad'])} "
          f"with a missing, non-finite or zero gradient {report['bad'][:5]}")
    check(not report["bad"], f"{name}: a trainable parameter got no finite, non-zero "
          "gradient")

    t0 = time.perf_counter()
    prepare_batch(raw)
    torch.cuda.synchronize()
    print(f"{name}: prepare_batch {time.perf_counter() - t0:.4f} s (in every step)")
    # a step: the UNet's 95 GroupNorms and 22 attentions forward, the MoVQ
    # encoder's 24 and 3 in prepare_batch, and 22 attention backwards (the
    # UNet attends at ds 2, 4 and 8 in 3 input and 4 output blocks a level,
    # and in the middle block)
    norms = UNET_LAUNCHES[0] + ENCODER_LAUNCHES[0]
    attns = UNET_LAUNCHES[1] + ENCODER_LAUNCHES[1]
    result = timed_steps(
        torch, np, name, lambda: train_step(state, prepare_batch(raw))["loss"], 5, smi,
        {"group_norm_stats": norms, "group_norm_apply": norms,
         "flash_attention_fwd": attns, "flash_attention_bwd_dq": 22,
         "flash_attention_bwd_dkv": 22}, reset_peak=False)
    frozen_same = all(torch.equal(p, before[n]) for n, p in unet.named_parameters()
                      if not mask[n])
    moved = [n for n, p in unet.named_parameters() if mask[n] and not torch.equal(p, before[n])]
    optimizer = f"{optim_params['name']} {json.dumps(optim_params['params'])}"
    print(f"{name}: trained tensors moved {len(moved)}, frozen unchanged {frozen_same}; "
          f"768², batch 1, fp32 parameters, bf16 compute, {optimizer}, EMA")
    check(frozen_same, f"{name}: a frozen parameter changed")
    check(len(moved) == sum(mask.values()), f"{name}: a trained parameter did not move")

    # the optimizer step alone, on seeded gradients of the trainable tensors
    opt = state.optimizer
    g = torch.Generator(device="cuda").manual_seed(13)
    for n, p in unet.named_parameters():
        if mask[n]:
            p.grad = torch.randn(p.shape, generator=g, device="cuda") * 1e-4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ops, dev_ms, _ = device_profile(torch, opt.step)
    opt.zero_grad(set_to_none=True)
    state_bytes = sum(t.numel() * t.element_size() for st in opt.state.values()
                      for t in st.values() if torch.is_tensor(t))
    print(f"{name}: the optimizer step alone ({optimizer}): {wall_ms:.2f} ms of wall "
          f"time, a profiled one {ops} device ops, {dev_ms:.2f} ms of device time; "
          f"its state {state_bytes} bytes over {n_train} trainable values, "
          f"{state_bytes / n_train:.4f} B per trainable parameter, on {smi}")
    if state_bytes_per_param is not None:
        check(state_bytes == state_bytes_per_param * n_train,
              f"{name}: optimizer state {state_bytes} bytes, not "
              f"{state_bytes_per_param} a trainable value")
    return result


def acp_decoder22(np):
    """The 2.2 decoder's base alphas_cumprod (linear betas 0.00085 to 0.012
    over 1000 steps) in fp32, as its pipeline keeps it."""
    from kandinsky2_tpu_torch.diffusion.schedules import named_betas

    return np.cumprod(1.0 - named_betas("linear", 1000, 0.00085, 0.012)).astype(np.float32)


COPY_FACTOR = 1.5


def phase_train_new_small(torch, np):
    """LoRA and distillation on the small UNet22 (64-wide heads), the prior
    step and the inpainting decoder step: one step each on the card against
    the CPU."""
    from kandinsky2_tpu_torch.configs import small_overrides22
    from kandinsky2_tpu_torch.models.lora import init_lora
    from kandinsky2_tpu_torch.models.prior import PriorTransformer
    from kandinsky2_tpu_torch.models.unet22 import UNet22
    from kandinsky2_tpu_torch.pipelines.base import init_random_
    from kandinsky2_tpu_torch.pipelines.kandinsky2_2 import Kandinsky2_2
    from kandinsky2_tpu_torch.train.distill import init_distill_state, make_distill_step
    from kandinsky2_tpu_torch.train.precision import cast_params
    from kandinsky2_tpu_torch.train.train_lora import (
        init_lora_train_state,
        make_lora_train_step,
        unet22_eps_fn,
    )
    from kandinsky2_tpu_torch.train.train_prior import make_prior_train_step

    rng = np.random.RandomState(13)
    arr = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32))
    small_unet = small_overrides22()["unet"]
    cpu_unet = UNet22(**small_unet)
    init_random_(cpu_unet, torch.Generator().manual_seed(14), Kandinsky2_2.residual_outputs)
    gpu_unet = UNet22(**small_unet, dtype=torch.bfloat16, device="cuda")
    gpu_unet.load_state_dict(cpu_unet.state_dict())
    gpu_unet.to(torch.bfloat16)  # the bf16 base of phase 14
    unets = {"cuda": gpu_unet, "cpu": cpu_unet}
    x0, cond = 0.5 * arr(2, 8, 8, 4), arr(2, small_unet["encoder_hid_dim"])
    noise = arr(2, 8, 8, 4)
    loras = init_lora(cpu_unet, torch.Generator().manual_seed(15), rank=4)
    for f in loras.values():  # non-zero up, so that down gets a gradient too
        f["up"] = 0.05 * arr(*f["up"].shape)

    def grads_of(opt, tensors):
        out = []
        opt.register_step_pre_hook(lambda o, a, kw: out.append(torch.cat(
            [t.grad.float().cpu().flatten() for t in tensors])))
        return out

    def lora(dev):
        state = init_lora_train_state(
            {n: {k: v.to(dev) for k, v in f.items()} for n, f in loras.items()},
            lambda ps: torch.optim.Adam(ps, lr=1e-3))
        g = grads_of(state.optimizer, list(state.params.values()))
        step = make_lora_train_step(unet22_eps_fn(unets[dev]), unets[dev],
                                    acp_decoder22(np))
        m = step(state, x0.to(dev), cond.to(dev), t=torch.tensor([30, 870]),
                 noise=noise.to(dev))
        return float(m["loss"]), g[0]

    # The student of a first round is the teacher's copy, and its loss is
    # the residual of one step against two, which bf16's rounding of three
    # UNet calls rivals: against the CPU in fp32 the plain versions in bf16
    # on the CPU miss by 3.535e-1 (loss) and 4.970e-1 (gradient), the card
    # by 3.340e-1 and 4.990e-1 (H100 80GB HBM3, 700 W).  So phase 7's
    # limits hold a student from another seed (as after training), and the
    # copy's distances on the card stay within COPY_FACTOR of that bf16
    # control's.
    other = UNet22(**small_unet)
    init_random_(other, torch.Generator().manual_seed(17), Kandinsky2_2.residual_outputs)
    cpu_bf16 = UNet22(**small_unet, dtype=torch.bfloat16)
    cpu_bf16.load_state_dict(cpu_unet.state_dict())
    cpu_bf16.to(torch.bfloat16)

    def distill(dev, unet, student=None):
        teacher = {n: p.detach() for n, p in unet.named_parameters()}
        src = teacher if student is None else {
            n: p.detach().to(dev) for n, p in student.named_parameters()}
        state = init_distill_state(cast_params(src, torch.float32),
                                   lambda ps: torch.optim.Adam(ps, lr=1e-4))
        g = grads_of(state.optimizer, list(state.params.values()))
        step = make_distill_step(unet22_eps_fn(unet), teacher, acp_decoder22(np),
                                 num_student_steps=500)
        m = step(state, x0.to(dev), cond.to(dev), i=torch.tensor([20, 430]),
                 noise=noise.to(dev))
        return float(m["loss"]), g[0]

    hp = dict(text_ctx=8, xf_width=64, xf_layers=2, xf_heads=2, xf_final_ln=True,
              clip_dim=32, clip_xf_width=32)
    cpu_prior = PriorTransformer(**hp)
    init_random_(cpu_prior, torch.Generator().manual_seed(16))
    pmask = torch.ones(2, hp["text_ctx"], dtype=torch.bool)
    pmask[1, 5:] = False
    pbatch = {"image_emb": arr(2, 32), "txt_feat": arr(2, 32),
              "txt_feat_seq": arr(2, hp["text_ctx"], 32), "mask": pmask}
    pnoise = arr(2, 32)

    def prior(dev):
        model = cpu_prior
        if dev == "cuda":
            model = PriorTransformer(**hp, dtype=torch.bfloat16, device=dev)
            model.load_state_dict(cpu_prior.state_dict())
        init_state, step = make_prior_train_step(
            model, PRIOR_YAML["model_config"]["diffusion"], ema_decay=0.9999)
        state = init_state()
        g = grads_of(state.optimizer, list(model.parameters()))
        m = step(state, {k: v.to(dev) for k, v in pbatch.items()},
                 t=torch.tensor([40, 910]), noise=pnoise.to(dev))
        return float(m["loss"]), g[0]

    card_against_cpu(torch, "train small: LoRA step (UNet22)", lora)
    card_against_cpu(torch, "train small: distillation step (UNet22, a student "
                     "from another seed)", lambda dev: distill(dev, unets[dev], other))
    copy = {"card": distill("cuda", gpu_unet), "cpu bf16": distill("cpu", cpu_bf16)}
    ref_loss, ref_g = distill("cpu", cpu_unet)
    dist = {k: (abs(loss - ref_loss) / ref_loss, ((g - ref_g).norm() / ref_g.norm()).item())
            for k, (loss, g) in copy.items()}
    ratio = [c / b for c, b in zip(dist["card"], dist["cpu bf16"])]
    print("train small: distillation step, the student the teacher's copy, against "
          f"cpu/fp32 (loss {ref_loss:.6f}): " + "; ".join(
              f"{k} loss {copy[k][0]:.6f} rel {dl:.3e}, gradient rel_l2 {dg:.3e}"
              for k, (dl, dg) in dist.items()) + f"; card over cpu bf16 loss "
          f"{ratio[0]:.3f}, gradient {ratio[1]:.3f} (tol {COPY_FACTOR})")
    check(bool(torch.isfinite(copy["card"][1]).all()),
          "distillation copy: card gradients not finite")
    check(max(ratio) <= COPY_FACTOR, "distillation copy: the card is further from the "
          "CPU than bf16 rounding on the CPU is")
    card_against_cpu(torch, "train small: prior step", prior, kernels=False)
    card_against_cpu(torch, "train small: inpainting decoder step",
                     _small_unclip_step(torch, np, inpainting=True))


def timed_steps(torch, np, name: str, step, n: int, smi: str, per_step: dict,
                reset_peak: bool = True):
    """One warm-up call of ``step`` (returning the loss), then ``n`` timed
    ones (host clock ending in a synchronize): every loss finite, the
    kernels launched exactly ``n`` times ``per_step`` and no attention call
    on the card by the plain route; then one call under the profiler.
    Prints s/step, the peak memory of every step before the profiled one
    (from the warm-up on, or from the caller's own reset where
    ``reset_peak`` is false: its first step is where the optimizer
    allocates its state) and the device idle share; returns the launches
    of the timed steps and s/step."""
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention

    if reset_peak:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = float(step())
    torch.cuda.synchronize()
    print(f"{name}: warm-up step {time.perf_counter() - t0:.3f} s, loss {first:.5f}")
    reset_path_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(n)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    counts = launch_counts()
    plain = qkv_attention.plain_on_card
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [first] + [float(x) for x in losses]
    want = {k: n * v for k, v in per_step.items()}
    ops, dev_ms, events = device_profile(torch, step)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{name}: profiled step, device time by name (ms, calls): " + "; ".join(
        f"{e.key[:50]} {e.self_device_time_total / 1e3:.2f} ({e.count})" for e in top))
    bwd = {k: [e for e in events if k in e.key] for k in ("flash_bwd_dq", "flash_bwd_dkv")}
    print(f"{name}: profiled step, flash backward kernels (ms, calls): " + "; ".join(
        f"{k} {sum(e.self_device_time_total for e in v) / 1e3:.3f} "
        f"({sum(e.count for e in v)})" for k, v in bwd.items()))
    print(f"{name}: losses {losses}; launches in the {n} timed steps {json.dumps(counts)}"
          f" (pinned at {json.dumps(per_step)} a step); attention calls on the card by "
          f"the plain route {plain}")
    print(f"{name}: {step_s:.4f} s/step, batch 1; a profiled step {ops} device ops, "
          f"{dev_ms:.1f} ms of device time, device idle share "
          f"{1 - dev_ms / 1e3 / step_s:.3f}; peak device memory {peak:.2f} GiB on {smi}")
    check(all(np.isfinite(losses)), f"{name}: loss not finite: {losses}")
    check(counts == want, f"{name}: launches {counts} != {want}")
    check(plain == 0, f"{name}: {plain} attention calls on the card missed K3")
    check(dev_ms > 0, f"{name}: the profiler saw no device time")
    return counts, step_s


def phase_train22_full(torch, np, smi: str) -> dict:
    """lora22-768 and distill22-768: the published 2.2 decoder UNet22 with a
    bf16 base, at 768² (latents [1, 96, 96, 4]), batch 1."""
    from kandinsky2_tpu_torch.models.lora import init_lora, merge_lora, unmerge_lora
    from kandinsky2_tpu_torch.models.unet22 import UNet22
    from kandinsky2_tpu_torch.pipelines.base import init_random_
    from kandinsky2_tpu_torch.pipelines.kandinsky2_2 import Kandinsky2_2
    from kandinsky2_tpu_torch.train.distill import init_distill_state, make_distill_step
    from kandinsky2_tpu_torch.train.precision import cast_params
    from kandinsky2_tpu_torch.train.train_lora import (
        init_lora_train_state,
        make_lora_train_step,
        nest_loras,
        unet22_eps_fn,
    )
    from kandinsky2_tpu_torch.weights.configs22 import pipeline_overrides

    t0 = time.perf_counter()
    unet = UNet22(**pipeline_overrides(task_type="text2img")["unet"],
                  dtype=torch.bfloat16,
                  device="cuda")
    init_random_(unet, torch.Generator(device="cuda").manual_seed(20),
                 Kandinsky2_2.residual_outputs)
    unet.to(torch.bfloat16)
    base = {n: p.detach().clone() for n, p in unet.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(21)
    x0 = torch.randn((1, 96, 96, 4), generator=g, device="cuda") * 0.5
    cond = torch.randn((1, unet.encoder_hid_dim), generator=g, device="cuda")
    eps_fn = unet22_eps_fn(unet)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"lora22-768: UNet22 {n_params} parameters in bf16, built in "
          f"{time.perf_counter() - t0:.2f} s")
    # a UNet22 call: 95 GroupNorms and 22 added-KV attentions
    norms, attns = UNET_LAUNCHES
    out = {}

    # LoRA: rank-4 factors on default_target, Adam 1e-4, 5 timed steps
    loras = init_lora(unet, torch.Generator(device="cuda").manual_seed(22), rank=4)
    state = init_lora_train_state(loras, lambda ps: torch.optim.Adam(ps, lr=1e-4))
    n_factors = sum(v.numel() for v in state.params.values())
    print(f"lora22-768: {len(loras)} factored weights, {n_factors} factor values")
    step = make_lora_train_step(eps_fn, unet, acp_decoder22(np))
    out["lora"] = timed_steps(
        torch, np, "lora22-768", lambda: step(state, x0, cond)["loss"], 5, smi,
        {"group_norm_stats": norms, "group_norm_apply": norms,
         "flash_attention_fwd": attns, "flash_attention_bwd_dq": attns,
         "flash_attention_bwd_dkv": attns})
    same = all(torch.equal(p, base[n]) for n, p in unet.named_parameters())
    trained = nest_loras(state.params)
    moved = all(bool(f["up"].any()) for f in trained.values())
    with torch.no_grad():
        merged = merge_lora(base, trained)
        back = unmerge_lora(merged, trained)
    # two roundings to bf16, each at most half an ulp (2^-8 of the value):
    # of W + ΔW, then of W + that first error, together at most
    # 2^-7 (1 + 2^-7) (|W| + |ΔW|)
    worst = 0.0
    for n, f in trained.items():
        delta = (f["down"].detach() @ f["up"].detach()).t()
        bound = 2.0 ** -7 * (1 + 2.0 ** -7) * (base[n].float().abs() + delta.abs()) + 1e-30
        worst = max(worst, float(((back[n].float() - base[n].float()).abs() / bound).max()))
    changed = sum(not torch.equal(merged[n], base[n]) for n in trained)
    print(f"lora22-768: base bitwise unchanged {same}; every up factor moved {moved}; "
          f"merged weights that differ from the base {changed} of {len(loras)}; "
          f"unmerge(merge(W)) - W at most {worst:.3f} of the bf16 rounding bound")
    check(same, "lora22-768: the base changed")
    check(moved, "lora22-768: an up factor did not move")
    check(changed > 0, "lora22-768: the trained factors change no merged weight")
    check(worst <= 1.0, "lora22-768: merge then unmerge does not return the base")
    del state, trained, merged, back, loras

    # distillation: the bf16 teacher is the base, the student fp32 copies
    # computing in bf16, Adam 1e-4, num_student_steps 500, 3 timed steps
    torch.cuda.empty_cache()
    teacher = {n: p.detach() for n, p in unet.named_parameters()}
    dstate = init_distill_state(cast_params(teacher, torch.float32),
                                lambda ps: torch.optim.Adam(ps, lr=1e-4))
    dstep = make_distill_step(eps_fn, teacher, acp_decoder22(np), num_student_steps=500)
    out["distill"] = timed_steps(
        torch, np, "distill22-768", lambda: dstep(dstate, x0, cond)["loss"], 3, smi,
        {"group_norm_stats": 3 * norms, "group_norm_apply": 3 * norms,
         "flash_attention_fwd": 3 * attns, "flash_attention_bwd_dq": attns,
         "flash_attention_bwd_dkv": attns})
    same = all(torch.equal(p, base[n]) for n, p in unet.named_parameters())
    moved = sum(not torch.equal(p.detach(), base[n].float())
                for n, p in dstate.params.items())
    print(f"distill22-768: teacher bitwise unchanged {same}; student tensors moved "
          f"{moved} of {len(dstate.params)}")
    check(same, "distill22-768: the teacher changed")
    check(moved > 0, "distill22-768: the student did not move")
    return out


def phase_prior_train_full(torch, np, smi: str, name="prior-train", optim_params=None):
    """prior-train: the prior CLI's run on config_prior.yaml (CONFIG_2_1's
    prior, 2048 wide, 20 layers; the CLIP text tower and ViT-L/14 frozen;
    the YAML's Adafactor 5e-6 unless ``optim_params`` names another
    optimizer; EMA) over a seeded CSV of five pictures, then five timed
    steps on the CLI's own model, batch and optimizer."""
    import copy
    import tempfile
    from pathlib import Path

    from PIL import Image

    from kandinsky2_tpu_torch.ops import launch_counts
    from kandinsky2_tpu_torch.train import train_prior_cli as cli
    from kandinsky2_tpu_torch.train.checkpoint import latest_checkpoint
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config
    from kandinsky2_tpu_torch.train.train_prior import make_prior_train_step

    cfg = copy.deepcopy(PRIOR_YAML)
    if optim_params is not None:
        cfg["optim_params"] = optim_params
    rng = np.random.RandomState(23)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rows = ["image_name,caption"]
        for i in range(5):
            Image.fromarray(rng.randint(0, 256, (256, 320, 3), np.uint8)).save(
                tmp / f"{i}.png")
            rows.append(f"{tmp / f'{i}.png'},a seeded picture number {i}")
        (tmp / "data.csv").write_text("\n".join(rows) + "\n")
        cfg.update(num_epochs=1, save_path=str(tmp / "ckpt"))
        cfg["data"]["train"]["df_path"] = str(tmp / "data.csv")
        reset_path_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = cli.run(cfg, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
        _, exported = latest_checkpoint(cfg["save_path"])
        finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters()) \
            and all(bool(torch.isfinite(e).all()) for e in state.ema_params.values())
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"{name}: the CLI's run, 5 steps with the build, the loader, the "
              f"whole-state save and the export, {run_s:.2f} s; prior {n_params} "
              f"parameters; step "
              f"{state.step}, exported at {exported}; parameters and EMA finite "
              f"{finite}; launches {json.dumps(counts)}")
        check(state.step == 5 and exported == 5,
              f"{name}: the run did not take 5 steps")
        check(finite, f"{name}: parameters or EMA not finite")
        check(not any(counts.values()), f"{name}: a kernel was launched: {counts}")
        del state
        gc.collect()
        torch.cuda.empty_cache()

        prior = cli.build_prior(cfg, "cuda")
        prepare_batch = cli.make_prepare_batch(cfg, "cuda")
        raw = next(iter(cli.make_loader(cfg)))
        init_state, step = make_prior_train_step(
            prior, cfg["model_config"]["diffusion"],
            optimizer_from_config(cfg["optim_params"]), ema_decay=0.9999)
        pstate = init_state()
        zero = {k: 0 for k in counts}
        return timed_steps(torch, np, name, lambda: step(
            pstate, prepare_batch(raw))["loss"], 5, smi, zero)


# phases 15 and 17's 2.1 serving set: phase 5b's full-width task without
# its output choice (the server hands back PIL images)
# phase 15's and 17's served calls: FULL_TASK at DDIM 10, a depth cut that
# keeps the whole script within its time limit (phase 15 took 115-173 s at
# DDIM 50 and 95.7 s at DDIM 25 on an H100 80GB HBM3 at 700 W, its
# profiled calls most of it)
SERVE21 = dict({k: v for k, v in FULL_TASK.items() if k != "output"}, num_steps=10)
# phase 15: a bf16 row of a batch-4 call may stand as far from the same
# prompt alone as bf16 stands from fp32 on that row, and half as far again
# (1.02 and 1.04 times on an H100 80GB HBM3 at 700 W; a row that took
# another's work reads about 1.26 against bf16 drifts of 0.09-0.11; both
# at DDIM 50)
ROW_FACTOR = 1.5
# phase 15's rows check at a cut depth, DDIM 10 and prior "5": a row that
# took another's work shows at any depth, and at full depth the fp32 copy's
# three calls took 49 s of the script's time limit (an H100 80GB HBM3 at 700 W)
SERVE21_ROWS = dict(SERVE21, num_steps=10, prior_steps="5")


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| of two numpy arrays."""
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_serve21(torch, np, smi: str, pipe):
    """serve21-768: ``GenerationServer(pipe, max_batch=4)`` on phase 5's
    pipeline.  The warmup runs buckets 1, 2 and 4; then each bucket's
    direct call (the call the server makes) with its launches pinned,
    s/call, s/image, peak memory and one profiled call; 9 requests
    submitted before ``start()`` (buckets 4, 4, 1), 3 more after a restart
    (one bucket 4 with a padded row); rows of a batch-4 call against the
    same prompts alone with the same injected noise, in bf16 and in an
    fp32 copy.  Returns (the server,
    the 9 requests' launches, their requests/s, s/image by bucket)."""
    from kandinsky2_tpu_torch.observability import StageReport
    from kandinsky2_tpu_torch.ops import launch_counts
    from kandinsky2_tpu_torch.serving import GenerationServer

    report = StageReport()
    steps = SERVE21["num_steps"]
    server = GenerationServer(pipe, max_batch=4)
    with report.stage("warmup 1, 2, 4"):
        server.warmup([SERVE21])
        torch.cuda.synchronize()
    per_image = {}
    for b in server._buckets():
        prompts = [f"{PROMPT}, view {i}" for i in range(b)]
        call = lambda: pipe.generate_text2img(
            prompts, batch_size=b, output="float",
            generator=torch.Generator(device="cuda").manual_seed(b), **SERVE21)
        torch.cuda.reset_peak_memory_stats()
        reset_path_counts()
        torch.cuda.synchronize()
        with report.stage(f"bucket {b} call"):
            t0 = time.perf_counter()
            img = call()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(img.shape == (b, 768, 768, 3), f"serve21: bucket {b} image shape {img.shape}")
        check(bool(np.isfinite(img).all()), f"serve21: bucket {b} image not finite")
        check(all(float(img[i].std()) > 0 for i in range(b)), f"serve21: bucket {b} "
              "has a constant image")
        check(all(not np.array_equal(img[0], img[i]) for i in range(1, b)),
              f"serve21: bucket {b} rows of distinct prompts are equal")
        check_full_launches(f"serve21 bucket {b}", counts, steps, encoded=False)
        per_image[b] = seconds / b
        print(f"serve21: bucket {b}: {seconds:.4f} s/call, {seconds / b:.4f} s/image; "
              f"peak device memory {peak:.2f} GiB; launches {json.dumps(counts)} on "
              f"{smi}")
        with report.stage(f"bucket {b} profiled call"):
            if b == server.max_batch:  # where the time goes: kernels and spans
                profiled_image(torch, f"serve21 bucket {b}", call, seconds, "k21.")
            else:
                ops, dev_ms, _ = device_profile(torch, call, cpu=False)
                print(f"serve21 bucket {b}: profiled call (the card alone) {ops} "
                      f"device ops, {dev_ms:.1f} ms of device time, device idle share "
                      f"{1 - dev_ms / 1e3 / seconds:.3f} of the unprofiled "
                      f"{seconds:.4f} s/call")
                check(dev_ms > 0, f"serve21 bucket {b}: the profiler saw no device time")

    # coalescing: every request queued before the worker starts
    kw = SERVE21
    futs = [server.submit(f"{PROMPT}, user {i}", **kw) for i in range(9)]
    reset_path_counts()
    try:
        with report.stage("9 requests"):
            t0 = time.perf_counter()
            server.start()
            served = [f.result(timeout=600) for f in futs]
            rps = 9 / (time.perf_counter() - t0)
        counts9 = launch_counts()
        stats = server.stats()
        print(f"serve21: 9 requests in buckets 4, 4, 1: {rps:.4f} requests/s; "
              f"stats {json.dumps(stats)}; launches {json.dumps(counts9)}")
        check((stats["requests"], stats["batches"], stats["padded"]) == (9, 3, 0),
              f"serve21: 9 requests coalesced as {stats}")
        check_full_launches("serve21 9 requests", counts9, 3 * steps, encoded=False,
                            decoder=tuple(3 * n for n in DECODER_LAUNCHES))
        check(all(len(r) == 1 and r[0].size == (768, 768) for r in served),
              "serve21: a request did not get one 768^2 image")
        server.stop()
        futs = [server.submit(f"{PROMPT}, late user {i}", **kw) for i in range(3)]
        with report.stage("3 requests"):
            server.start()
            late = [f.result(timeout=600) for f in futs]
        stats = server.stats()
        print(f"serve21: 3 more requests: stats {json.dumps(stats)}")
        check((stats["requests"], stats["batches"], stats["padded"]) == (12, 4, 1),
              f"serve21: 3 requests coalesced as {stats}")
        check(all(len(r) == 1 for r in late), "serve21: a late request lost its image")
    finally:
        server.stop()

    # rows do not mix: a batch-4 call against prompts 0 and 3 alone with the
    # matching rows of the same injected noise, in bf16 (the served
    # pipeline, kernels) and in fp32 (its weights in an fp32 copy, TF32
    # off: the rounding is gone, so a row that took another row's work
    # would show), at SERVE21_ROWS' depth.  The decoder's latents are
    # compared too: the random MoVQ decoder magnifies their bf16 drift about
    # tenfold (at DDIM 50: 1e-2 in the latents, 0.09-0.12 in the images on
    # an H100 80GB HBM3 at 700 W)
    rng = np.random.RandomState(15)
    clip_dim = pipe.clip_mean.shape[-1]
    noise = rng.randn(4, 96, 96, 4).astype(np.float32)
    prior_noise = rng.randn(4, clip_dim).astype(np.float32)
    prior_seq = rng.randn(int(SERVE21_ROWS["prior_steps"]), 4, clip_dim).astype(np.float32)
    prompts = [f"{PROMPT}, row {i}" for i in range(4)]

    def rows(p, sl):
        """(latents, images) of prompts[sl] with the rows sl of the noise."""
        latents = []
        decode = p._decode
        p._decode = lambda lat: (latents.append(lat.float().cpu().numpy()), decode(lat))[1]
        try:
            img = p.generate_text2img(prompts[sl], batch_size=sl.stop - sl.start,
                                      noise=noise[sl], prior_noise=prior_noise[sl],
                                      prior_noise_seq=prior_seq[:, sl], output="float",
                                      **SERVE21_ROWS)
        finally:
            del p._decode
        return latents[0], img

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1

    got = {}
    with report.stage("rows: bf16 batch 4 + 2 x batch 1"):
        got["bf16"] = {i: rows(pipe, sl) for i, sl in
                       ((4, slice(0, 4)), (0, slice(0, 1)), (3, slice(3, 4)))}
    with report.stage("rows: fp32 copy, batch 4 + 2 x batch 1"):
        p32 = Kandinsky2_1(config=pipe.config, tokenizer1=pipe.tokenizer1,
                           tokenizer2=pipe.tokenizer2, dtype=torch.float32,
                           device="cuda")
        for name, model in p32.models().items():
            model.load_state_dict(pipe.models()[name].state_dict())
        got["fp32"] = {i: rows(p32, sl) for i, sl in
                       ((4, slice(0, 4)), (0, slice(0, 1)), (3, slice(3, 4)))}
        del p32
        gc.collect()
        torch.cuda.empty_cache()
    for i in (0, 3):
        err = {dt: (rel_l2(got[dt][i][0][0], got[dt][4][0][i]),
                    rel_l2(got[dt][i][1][0], got[dt][4][1][i])) for dt in got}
        other = min(rel_l2(got["bf16"][i][1][0], got["bf16"][4][1][j])
                    for j in range(4) if j != i)
        drift = rel_l2(got["bf16"][i][1][0], got["fp32"][i][1][0])
        print(f"serve21: row {i} alone against its batch-4 row, rel_l2: fp32 latent "
              f"{err['fp32'][0]:.3e} image {err['fp32'][1]:.3e} (tol 5e-2); bf16 latent "
              f"{err['bf16'][0]:.3e} (tol 5e-2) image {err['bf16'][1]:.3e} (tol "
              f"{ROW_FACTOR} x the bf16 row's own drift from fp32, {drift:.3e}); bf16 "
              f"against the nearest other row {other:.3e}")
        check(max(err["fp32"]) <= 5e-2, f"serve21: fp32 row {i} differs from its batch row")
        check(err["bf16"][0] <= 5e-2, f"serve21: bf16 row {i}'s latents differ")
        check(err["bf16"][1] <= ROW_FACTOR * drift,
              f"serve21: bf16 row {i} drifts beyond bf16's own rounding")
    print("serve21: stages\n" + str(report))
    return server, counts9, rps, per_image


def phase_lora_swap22(torch, np, smi: str, pipe):
    """lora-swap22-768: two rank-4 adapters on the 132 targeted weights of
    phase 10's UNet22, ``up`` drawn non-zero; requests a, a, None, b, a
    served one at a time after the same ``set_seed``; after each, every
    targeted weight is ``merge_lora`` of its pristine snapshot bitwise (the
    base itself under None) and every other weight untouched; then the
    swaps timed alone.  Returns (the five requests' launches, the mean
    swap ms)."""
    from kandinsky2_tpu_torch.models.lora import init_lora, merge_lora
    from kandinsky2_tpu_torch.observability import StageReport
    from kandinsky2_tpu_torch.ops import launch_counts
    from kandinsky2_tpu_torch.serving import GenerationServer

    report = StageReport()
    g = torch.Generator(device="cuda").manual_seed(16)
    adapters = {}
    for name in ("a", "b"):
        loras = init_lora(pipe.unet, g, rank=4)
        for f in loras.values():
            f["up"] = 0.05 * torch.randn(f["up"].shape, generator=g, device="cuda")
        adapters[name] = loras
    check(len(adapters["a"]) == 132, f"lora22: {len(adapters['a'])} targeted weights")
    weights = dict(pipe.unet.named_parameters())
    others = {n: w.detach().clone() for n, w in weights.items() if n not in adapters["a"]}
    server = GenerationServer(pipe, max_batch=4)
    with report.stage("attach a, b"):
        for name, loras in adapters.items():
            server.attach_lora(name, loras)
        torch.cuda.synchronize()
    snap = sum(t.numel() * t.element_size() for t in server._pristine.values())
    print(f"lora22: pristine snapshot of {len(server._pristine)} weights, {snap} bytes "
          f"({snap / 2**20:.1f} MiB)")

    def check_weights(active):
        for n, w in weights.items():
            if n in adapters["a"]:
                base = server._pristine[("unet", n)]
                want = base if active is None else merge_lora(
                    {n: base}, {n: adapters[active][n]})[n]
                check(torch.equal(w, want), f"lora22: {n} is not the {active} fold")
            else:
                check(torch.equal(w, others[n]), f"lora22: untargeted {n} changed")

    kw = dict(T2I22)
    images = []
    reset_path_counts()
    server.start()
    try:
        for i, active in enumerate(["a", "a", None, "b", "a"]):
            pipe.set_seed(160)
            with report.stage(f"request {i} ({active})"):
                images.append(server.submit(PROMPT, lora=active, **kw)
                              .result(timeout=600)[0])
            check_weights(active)
    finally:
        server.stop()
    counts = launch_counts()
    stats = server.stats()
    check_full_launches("lora22 5 requests", counts, 5 * T2I22["decoder_steps"],
                        encoded=False, decoder=tuple(5 * n for n in DECODER_LAUNCHES))
    check(stats["lora_swaps"] == 4, f"lora22: {stats['lora_swaps']} swaps, not 4")
    same = rel_l2(images[1], images[0])
    moved = rel_l2(images[0], images[2])
    print(f"lora22: five requests, stats {json.dumps(stats)}; a's two images rel_l2 "
          f"{same:.3e} (tol 1e-2); a against None {moved:.3e} (must exceed 1e-2); "
          f"b against None {rel_l2(images[3], images[2]):.3e}")
    check(all(np.isfinite(im).all() and im.std() > 0 for im in images),
          "lora22: an image is not finite or constant")
    check(same <= 1e-2, "lora22: a's two images disagree")
    check(moved > 1e-2, "lora22: adapter a does not change the image")

    swap_ms = []
    for target in ("b", None, "a", None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        server._ensure_lora(target)
        torch.cuda.synchronize()
        swap_ms.append((time.perf_counter() - t0) * 1e3)
        rise = torch.cuda.max_memory_allocated() - before
        check_weights(target)
        print(f"lora22: swap to {target}: {swap_ms[-1]:.2f} ms (synchronized), peak "
              f"memory rise {rise} bytes ({rise / 2**20:.2f} MiB) on {smi}")
    print("lora22: stages\n" + str(report))
    return counts, sum(swap_ms) / len(swap_ms)


def http_call(port, method, path, body=None, timeout=600):
    """(status, JSON reply) of one request to the local front end."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_http_validate21(torch, np, smi: str, pipe, server):
    """http-validate21-768: phase 15's server behind ``serve_http`` (port
    0, ``serve_forever`` on a thread): /healthz, a 768² text2img, an
    img2img of a base64 PNG, an undecodable image (400), an unknown path
    (404).  Then the pipeline's weights re-drawn at torch-default scales
    (``torch_init_stats``), ``validate`` twice at 768² / 50 steps (the
    bootstrap, then the seeded repeat against it with LPIPS weights written
    and read by the port's own file code): both ok, PSNR >= 30 dB; the
    image finite and not constant in bf16; and, without a builder, the
    offline stop at fetch.  Returns the launches of the repeat."""
    import base64
    import io
    import tempfile
    import threading

    from PIL import Image

    from kandinsky2_tpu_torch.lpips import init_random_lpips, save_lpips_weights
    from kandinsky2_tpu_torch.observability import StageReport
    from kandinsky2_tpu_torch.ops import launch_counts
    from kandinsky2_tpu_torch.serving_http import serve_http
    from kandinsky2_tpu_torch.validate import VALIDATION_PROMPT, validate
    from kandinsky2_tpu_torch.weights.realistic import torch_init_stats

    report = StageReport()
    png = io.BytesIO()
    seeded_image(np, 17, 768).save(png, format="PNG")
    init_b64 = base64.b64encode(png.getvalue()).decode("ascii")
    httpd = serve_http(server, host="127.0.0.1", port=0, start=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        for name, method, path, body, want in [
            ("healthz", "GET", "/healthz", None, 200),
            ("text2img", "POST", "/generate", dict(prompt=PROMPT, **SERVE21), 200),
            ("img2img", "POST", "/generate", dict(prompt=PROMPT, task="img2img",
                                                 image=init_b64, strength=0.7,
                                                 **SERVE21), 200),
            ("undecodable image", "POST", "/generate",
             dict(prompt=PROMPT, task="img2img",
                  image=base64.b64encode(b"not an image").decode(), **SERVE21), 400),
            ("unknown path", "GET", "/nope", None, 404),
        ]:
            with report.stage(f"http {name}"):
                code, reply = http_call(port, method, path, body)
            shapes = [np.asarray(Image.open(io.BytesIO(base64.b64decode(b)))).shape
                      for b in reply.get("images", [])]
            print(f"http21: {method} {path} ({name}): {code} (want {want}); images "
                  f"{shapes}; {reply if not shapes else ''}")
            check(code == want, f"http21: {name} answered {code}")
            if path == "/generate" and want == 200:
                check(shapes == [(768, 768, 3)], f"http21: {name} images {shapes}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(timeout=60)
    check(not thread.is_alive(), "http21: the HTTP thread did not stop")

    g = torch.Generator(device="cuda").manual_seed(17)
    with report.stage("torch_init_stats"):
        for model in pipe.models().values():
            torch_init_stats(model, g)
        torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="k2_validate_")
    lpips_path = f"{tmp}/lpips.safetensors"
    save_lpips_weights(init_random_lpips(torch.Generator(device="cuda").manual_seed(17)),
                       lpips_path)
    kw = dict(version="2.1", pipe_builder=lambda: pipe, h=768, w=768,
              num_steps=SERVE21["num_steps"])
    with report.stage("validate bootstrap"):
        rep1 = validate(out_dir=f"{tmp}/first", **kw)
    reset_path_counts()
    with report.stage("validate repeat"):
        rep2 = validate(out_dir=f"{tmp}/second", reference_dir=f"{tmp}/first",
                        lpips_weights=lpips_path, **kw)
    counts = launch_counts()
    for rep in (rep1, rep2):
        check(rep["ok"], "validate21: report not ok: " + json.dumps(
            {k: v.get("error") for k, v in rep["stages"].items()}))
    m = rep2["metrics"][0]
    print(f"validate21: seeded repeat at 768^2, {SERVE21['num_steps']} DDIM steps, "
          f"torch-default weight "
          f"scales: psnr_db {m['psnr_db']} ssim {m['ssim']} ms_ssim {m['ms_ssim']} "
          f"lpips_alex {m['lpips_alex']} ({m['lpips_backend']}) clip_cosine_drift "
          f"{m['clip_cosine_drift']}; stages (s) " + json.dumps(
              {k: v["seconds"] for k, v in rep2["stages"].items()}))
    check(m["psnr_db"] >= 30, f"validate21: PSNR {m['psnr_db']} dB < 30")
    check(m["lpips_backend"] == "native-torch", "validate21: LPIPS not native")
    check_full_launches("validate21 repeat", counts, SERVE21["num_steps"], encoded=False)
    with report.stage("bf16 stress image"):
        pipe.set_seed(0)
        img = pipe.generate_text2img(VALIDATION_PROMPT, num_steps=SERVE21["num_steps"],
                                     h=768, w=768, output="float")
    print(f"validate21: torch-default scales in bf16: image min {img.min():.4f} max "
          f"{img.max():.4f} std {img.std():.4f}")
    check(bool(np.isfinite(img).all()), "validate21: non-finite image")
    check(float(img.std()) > 0, "validate21: constant image")
    offline = validate(version="2.1", cache_dir=f"{tmp}/empty_cache")
    print(f"validate21: without a builder: stopped_at {offline.get('stopped_at')}: "
          f"{offline['stages']['fetch'].get('error', '')[:160]}")
    check(offline.get("stopped_at") == "fetch", "validate21: offline run did not stop at fetch")
    print("http-validate21: stages\n" + str(report))
    return counts


# --- phase 18: checkpoints --------------------------------------------------

# the published DPT-Large config.json, as far as ``models.dpt.dpt_overrides``
# reads it: the ``DPTDepth()`` defaults
DPT_LARGE_CONFIG = {
    "model_type": "dpt", "hidden_size": 1024, "num_hidden_layers": 24,
    "num_attention_heads": 16, "intermediate_size": 4096, "patch_size": 16,
    "image_size": 384, "backbone_out_indices": [5, 11, 17, 23],
    "neck_hidden_sizes": [256, 512, 1024, 1024], "reassemble_factors": [4, 2, 1, 0.5],
    "fusion_hidden_size": 256, "layer_norm_eps": 1e-12, "readout_type": "project",
    "is_hybrid": False}
# tests/test_dpt_parity.py's TINY_HYBRID (its TINY_BIT stem) with 128-wide,
# 2-head ViT layers: 64-wide heads, the width K3 takes
DPT_HYBRID_SMALL = {
    "model_type": "dpt", "hidden_size": 128, "num_hidden_layers": 4,
    "num_attention_heads": 2, "intermediate_size": 256, "image_size": 64,
    "patch_size": 16, "is_hybrid": True, "backbone_out_indices": [0, 1, 2, 3],
    "neck_hidden_sizes": [16, 32, 24, 24], "reassemble_factors": [1, 1, 1, 0.5],
    "neck_ignore_stages": [0, 1], "fusion_hidden_size": 24, "num_channels": 3,
    "backbone_featmap_shape": [1, 64, 4, 4],
    "backbone_config": {
        "model_type": "bit", "embedding_size": 8, "hidden_sizes": [16, 32, 64],
        "depths": [1, 1, 2], "layer_type": "bottleneck", "global_padding": "same",
        "out_features": ["stage1", "stage2", "stage3"],
        "embedding_dynamic_padding": True, "num_groups": 4}}
DPT_HYBRID_NORMS = 16  # the stem's GroupNorm and 3 a bottleneck, 1 more a stage


def write_json(path, obj) -> None:
    import os

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs)


def write_tokenizer22(tok_dir) -> None:
    """An HF CLIPTokenizer directory over CLIP's byte alphabet: no merges,
    each byte and its end-of-word form, <|startoftext|> 49406 and
    <|endoftext|> 49407 (CLIP's ids, where the text tower pools)."""
    from kandinsky2_tpu_torch.tokenizers.clip_bpe import _bytes_to_unicode

    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    write_json(f"{tok_dir}/vocab.json", vocab)
    with open(f"{tok_dir}/merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    write_json(f"{tok_dir}/tokenizer_config.json", {"model_max_length": 77})
    write_json(f"{tok_dir}/special_tokens_map.json", {"eos_token": "<|endoftext|>"})


def save_jit_archive(torch, sd: dict, path) -> None:
    """A TorchScript archive whose state dict is ``sd``, as OpenAI's CLIP
    files are (``visual.`` keys, fused ``attn.in_proj_weight``)."""

    class Holder(torch.nn.Module):
        def forward(self):
            return 0

    root = Holder()
    for key, value in sd.items():
        *names, leaf = key.split(".")
        mod = root
        for name in names:
            if not hasattr(mod, name):
                mod.add_module(name, Holder())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, value)
    torch.jit.save(torch.jit.script(root), path)


def cpu_sd(model, prefix="", rename=None) -> dict:
    return {prefix + (rename(k) if rename else k): v.detach().cpu()
            for k, v in model.state_dict().items()}


def check_same_weights(torch, name, src, loaded) -> int:
    """Every tensor of ``loaded``'s models bitwise equal to ``src``'s, on the
    card; returns the parameter count."""
    n = 0
    for key, model in src.models().items():
        a, b = model.state_dict(), loaded.models()[key].state_dict()
        check(set(a) == set(b), f"{name}: {key} keys differ")
        for k, v in a.items():
            check(b[k].is_cuda and b[k].dtype == v.dtype and torch.equal(b[k], v),
                  f"{name}: {key}.{k} differs from the source")
            n += v.numel()
    return n


def timed_load(torch, name, write, load, cache, smi):
    """``write()`` then ``load()`` (synchronized), with the bytes, seconds
    and GB/s of each."""
    t0 = time.perf_counter()
    write()
    write_s = time.perf_counter() - t0
    nbytes = dir_bytes(cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f"{name}: wrote {nbytes} bytes in {write_s:.3f} s "
          f"({nbytes / write_s / 1e9:.3f} GB/s); get_kandinsky2 loaded them in "
          f"{load_s:.3f} s ({nbytes / load_s / 1e9:.3f} GB/s) on {smi}")
    return pipe, {"bytes": nbytes, "write_s": write_s, "load_s": load_s}


def same_image(torch, np, name, src, loaded, call, unet_calls):
    """One image from ``src`` and one from ``loaded`` with the same seed:
    bitwise equal, the loaded one's launches pinned."""
    want = call(src)
    reset_path_counts()
    got = call(loaded)
    torch.cuda.synchronize()
    from kandinsky2_tpu_torch.ops import launch_counts

    counts = launch_counts()
    check(got.shape == want.shape and bool(np.isfinite(got).all()), f"{name}: image")
    check(float(got.std()) > 0, f"{name}: image is constant")
    check(np.array_equal(got, want), f"{name}: image differs from the source's by "
          f"{float(np.abs(got - want).max()):.3e}")
    print(f"{name}: image {got.shape} bitwise equal to the source pipeline's; "
          f"launches {json.dumps(counts)}")
    if unet_calls:
        check_full_launches(name, counts, unet_calls, encoded=False)
    return counts


def phase_checkpoints22(torch, np, smi, src):
    """18a: phase 10's 2.2 pipeline as a diffusers snapshot cache (the
    vendored configs, BF16 safetensors, the MoVQ under diffusers names, a
    tokenizer directory), loaded by ``get_kandinsky2(model_version="2.2")``."""
    import os
    import shutil
    import tempfile

    from kandinsky2_tpu_torch import get_kandinsky2
    from kandinsky2_tpu_torch.weights.configs22 import load_fixture
    from kandinsky2_tpu_torch.weights.load_kandinsky22 import movq22_rename
    from kandinsky2_tpu_torch.weights.safetensors_file import save_file

    tmp = tempfile.mkdtemp()
    try:
        prior_dir, decoder_dir = f"{tmp}/2_2/prior", f"{tmp}/2_2/decoder"

        def write():
            for d, sub, fixture, model, stem, rename in [
                    (prior_dir, "prior", "prior__prior", src.prior,
                     "diffusion_pytorch_model", None),
                    (prior_dir, "text_encoder", "prior__text_encoder", src.text_encoder,
                     "model", None),
                    (prior_dir, "image_encoder", "prior__image_encoder",
                     src.image_encoder, "model", None),
                    (decoder_dir, "unet", "decoder__unet", src.unet,
                     "diffusion_pytorch_model", None),
                    (decoder_dir, "movq", "decoder__movq", src.movq,
                     "diffusion_pytorch_model", movq22_rename)]:
                write_json(f"{d}/{sub}/config.json", load_fixture(fixture))
                save_file(cpu_sd(model, rename=rename), f"{d}/{sub}/{stem}.safetensors")
            write_tokenizer22(f"{prior_dir}/tokenizer")

        loaded, io = timed_load(torch, "ckpt22", write, lambda: get_kandinsky2(
            model_version="2.2", cache_dir=tmp, task_type="text2img"), tmp, smi)
        n = check_same_weights(torch, "ckpt22", src, loaded)
        print(f"ckpt22: all {n} parameters bitwise equal to phase 10's pipeline "
              f"({io['bytes'] / n:.4f} bytes a parameter)")
        tok = src.tokenizer
        src.tokenizer = loaded.tokenizer  # the loaded BPE's ids on both
        try:
            counts = same_image(torch, np, "ckpt22", src, loaded, lambda p: p.generate_text2img(
                PROMPT, generator=torch.Generator(device="cuda").manual_seed(4), **T2I22),
                T2I22["decoder_steps"])
        finally:
            src.tokenizer = tok
        del loaded
    finally:
        shutil.rmtree(tmp)
    return counts, io


def write_cache21(torch, src, cd, decoder):
    """The files ``fetch_2_1`` looks for, from ``src``'s weights in the
    reference's key layout."""
    import os

    from kandinsky2_tpu_torch.weights.convert import clip_rename

    os.makedirs(f"{cd}/text_encoder", exist_ok=True)
    torch.save(cpu_sd(src.unet), f"{cd}/{decoder}")
    torch.save(cpu_sd(src.prior, prefix="model."), f"{cd}/prior_fp16.ckpt")
    torch.save(cpu_sd(src.movq), f"{cd}/movq_final.ckpt")
    torch.save({k[len("model."):]: v for k, v in cpu_sd(src.text_encoder).items()},
               f"{cd}/text_encoder/pytorch_model.bin")
    clip = cpu_sd(src.clip_text, rename=clip_rename)
    clip.update(cpu_sd(src.clip_vision, prefix="visual.", rename=clip_rename))
    save_jit_archive(torch, clip, f"{cd}/ViT-L-14.pt")
    torch.save((src.clip_mean[0].cpu(), src.clip_std[0].cpu()), f"{cd}/ViT-L-14_stats.th")


def phase_checkpoints21(torch, np, smi, src):
    """18b: phase 5's 2.1 pipeline as the reference's 2.1 files (torch.save,
    a TorchScript CLIP archive), loaded by ``get_kandinsky2(model_version=
    "2.1")``; then an inpainting cache at a small width, from which
    ``task_type="inpainting"`` reads ``inpainting_fp16.ckpt``."""
    import shutil
    import tempfile

    from kandinsky2_tpu_torch import get_kandinsky2
    from kandinsky2_tpu_torch.configs import small_config
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.pipelines import kandinsky2_1 as pipe21

    toks = (src.tokenizer1, src.tokenizer2)
    tmp = tempfile.mkdtemp()
    try:
        loaded, io = timed_load(
            torch, "ckpt21", lambda: write_cache21(torch, src, f"{tmp}/2_1",
                                                   "decoder_fp16.ckpt"),
            lambda: get_kandinsky2(model_version="2.1", cache_dir=tmp, tokenizers=toks),
            tmp, smi)
        n = check_same_weights(torch, "ckpt21", src, loaded)
        check(torch.equal(loaded.clip_mean, src.clip_mean)
              and torch.equal(loaded.clip_std, src.clip_std), "ckpt21: clip stats")
        print(f"ckpt21: all {n} parameters bitwise equal to phase 5's pipeline")
        counts = same_image(torch, np, "ckpt21", src, loaded, lambda p: p.generate_text2img(
            PROMPT, generator=torch.Generator(device="cuda").manual_seed(4), **FULL_TASK),
            FULL_TASK["num_steps"])
        del loaded
    finally:
        shutil.rmtree(tmp)

    tmp = tempfile.mkdtemp()
    default = pipe21.CONFIG_2_1
    pipe21.CONFIG_2_1 = small_config(64)  # build_kandinsky21's default config
    try:
        small = Kandinsky2_1(config=small_config(64), tokenizer1=toks[0],
                             tokenizer2=toks[1], task_type="inpainting")
        small.init_random_params(torch.Generator(device="cuda").manual_seed(18))
        write_cache21(torch, small, f"{tmp}/2_1", "inpainting_fp16.ckpt")
        loaded = get_kandinsky2(model_version="2.1", cache_dir=tmp, task_type="inpainting",
                                tokenizers=toks)
        check(loaded.unet.input_blocks[0][0].weight.shape[1] == 9, "ckpt21: inpainting UNet")
        check_same_weights(torch, "ckpt21 inpainting", small, loaded)
        print("ckpt21: task_type='inpainting' read inpainting_fp16.ckpt (a 9-channel "
              "UNet at small_config(64)), every tensor bitwise equal")
    finally:
        pipe21.CONFIG_2_1 = default
        shutil.rmtree(tmp)
    return counts, io


def phase_checkpoints20(torch, np, smi):
    """18c: a 2.0 pipeline at CONFIG_2_0 with seeded bf16 weights as the
    reference's 2.0 files, loaded by ``get_kandinsky2(model_version="2.0")``;
    one image at ``generate_text2img``'s own defaults from each."""
    import os
    import shutil
    import tempfile

    from kandinsky2_tpu_torch import get_kandinsky2
    from kandinsky2_tpu_torch.pipelines import Kandinsky2
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok, _ = stub_tokenizers()
    tmp = tempfile.mkdtemp()
    try:
        src = Kandinsky2(tokenizer1=tok, tokenizer2=tok)
        src.init_random_params(torch.Generator(device="cuda").manual_seed(19))
        cd = f"{tmp}/2_0"

        def write():
            for sub in ("text_encoder1", "text_encoder2"):
                os.makedirs(f"{cd}/{sub}")
            torch.save({"state_dict": cpu_sd(src.unet)}, f"{cd}/Kandinsky-2-0.pt")
            torch.save(cpu_sd(src.image_encoder), f"{cd}/vae.ckpt")
            torch.save({k[len("model."):]: v for k, v in cpu_sd(src.text_encoder1).items()},
                       f"{cd}/text_encoder1/pytorch_model.bin")
            torch.save(cpu_sd(src.text_encoder2), f"{cd}/text_encoder2/pytorch_model.bin")

        loaded, io = timed_load(torch, "ckpt20", write, lambda: get_kandinsky2(
            model_version="2.0", cache_dir=tmp, tokenizers=(tok, tok)), tmp, smi)
        n = check_same_weights(torch, "ckpt20", src, loaded)
        print(f"ckpt20: all {n} parameters bitwise equal to the source pipeline's")
        counts = same_image(torch, np, "ckpt20", src, loaded, lambda p: p.generate_text2img(
            PROMPT, generator=torch.Generator(device="cuda").manual_seed(4), **T2I20), 0)
        check_full_launches("ckpt20", counts, T2I20_STEPS, encoded=False,
                            decoder=KL_DECODER_LAUNCHES)
        del loaded, src
    finally:
        shutil.rmtree(tmp)
    return counts, io


def _dpt_snapshot(torch, repo, cfg, seed):
    """``repo`` with ``cfg`` as config.json and the F32 weights of a seeded
    ``DPTDepth`` of it; returns that model."""
    from kandinsky2_tpu_torch.models.dpt import DPTDepth, dpt_overrides
    from kandinsky2_tpu_torch.pipelines.base import init_random_
    from kandinsky2_tpu_torch.weights.safetensors_file import save_file

    src = DPTDepth(device="cuda", **dpt_overrides(cfg))
    init_random_(src, torch.Generator(device="cuda").manual_seed(seed))
    write_json(f"{repo}/config.json", cfg)
    save_file(cpu_sd(src), f"{repo}/model.safetensors")
    return src


def _dpt_run(torch, np, name, est, image):
    """One estimate with the launches of its forward, and its ms (host
    clock, synchronized, the mean of 5 after a warm-up)."""
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention

    est(image)
    torch.cuda.synchronize()
    reset_path_counts()
    depth = est(image)
    counts, plain = launch_counts(), qkv_attention.plain_on_card
    t0 = time.perf_counter()
    for _ in range(5):
        est(image)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    check(bool(np.isfinite(depth).all()) and float(depth.std()) > 0,
          f"{name}: depth not finite or constant")
    print(f"{name}: depth {depth.shape} min {depth.min():.4f} max {depth.max():.4f}; "
          f"{ms:.3f} ms an estimate; launches {json.dumps(counts)}, attention calls "
          f"on the card by the plain route {plain}")
    return depth, counts, plain, ms


def phase_dpt(torch, np, smi):
    """18d: DPT-Large at full width from a snapshot through ``dpt_estimator``
    in bf16 (K3) against fp32; the small hybrid (K1, K2, K3); one ControlNet
    call on a hint the DPT-Large estimator made."""
    import shutil
    import tempfile

    import inspect

    from kandinsky2_tpu_torch import depth
    from kandinsky2_tpu_torch.models.dpt import DPTDepth, dpt_overrides

    tmp = tempfile.mkdtemp()
    out = {}
    try:
        defaults = inspect.signature(DPTDepth).parameters
        check(all(tuple(v) == tuple(defaults[k].default) if isinstance(v, tuple)
                  else v == defaults[k].default
                  for k, v in dpt_overrides(DPT_LARGE_CONFIG).items()),
              "dpt-large: the config is not DPTDepth()'s defaults")
        src = _dpt_snapshot(torch, f"{tmp}/large", DPT_LARGE_CONFIG, 21)
        n = sum(p.numel() for p in src.parameters())
        t0 = time.perf_counter()
        est = depth.dpt_estimator(f"{tmp}/large", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        nbytes = dir_bytes(f"{tmp}/large")
        print(f"dpt-large: {n} parameters, {nbytes} bytes F32 loaded in {load_s:.3f} s "
              f"({nbytes / load_s / 1e9:.3f} GB/s) on {smi}")
        for k, v in src.state_dict().items():
            check(torch.equal(est.model.state_dict()[k], v), f"dpt-large: {k} differs")
        est32 = depth.dpt_estimator(f"{tmp}/large")
        image = seeded_image(np, 22, 768)
        d16, counts, plain, ms = _dpt_run(torch, np, "dpt-large bf16", est, image)
        check(counts["flash_attention_fwd"] == 24 and plain == 0,
              "dpt-large: bf16 must run K3 once a layer")
        d32, c32, plain32, ms32 = _dpt_run(torch, np, "dpt-large fp32", est32, image)
        check(c32["flash_attention_fwd"] == 0 and plain32 == 24,
              "dpt-large: fp32 must take the plain route")
        rel = float(np.linalg.norm(d16 - d32) / np.linalg.norm(d32))
        print(f"dpt-large: bf16 (K3) against fp32 on the card: rel_l2 {rel:.4e} "
              f"(limit 3e-2); {ms:.3f} against {ms32:.3f} ms an estimate")
        check(rel <= 3e-2, f"dpt-large: bf16 drifts {rel:.3e} from fp32")
        out["large"] = (counts, ms, rel)

        hint = depth.make_hint(image, h=768, w=768, estimator=est)
        del est, est32, src
        _dpt_snapshot(torch, f"{tmp}/hybrid", DPT_HYBRID_SMALL, 23)
        hyb = depth.dpt_estimator(f"{tmp}/hybrid", dtype=torch.bfloat16)
        h16, hc, hplain, hms = _dpt_run(torch, np, "dpt-hybrid small bf16", hyb,
                                        seeded_image(np, 24, 256))
        check(hc["group_norm_stats"] == hc["group_norm_apply"] == DPT_HYBRID_NORMS
              and hc["flash_attention_fwd"] == 4 and hplain == 0,
              f"dpt-hybrid: launches {hc}")
        h32 = depth.dpt_estimator(f"{tmp}/hybrid")(seeded_image(np, 24, 256))
        hrel = float(np.linalg.norm(h16 - h32) / np.linalg.norm(h32))
        print(f"dpt-hybrid small: bf16 against fp32 rel_l2 {hrel:.4e} (limit 3e-2)")
        check(hrel <= 3e-2, f"dpt-hybrid: bf16 drifts {hrel:.3e} from fp32")
        out["hybrid"] = (hc, hms, hrel)
    finally:
        shutil.rmtree(tmp)

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22
    from kandinsky2_tpu_torch.weights.configs22 import pipeline_overrides

    pipe = Kandinsky2_2(task_type="controlnet", tokenizer=stub_tokenizer22(),
                        overrides=pipeline_overrides(task_type="controlnet"))
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(25))
    reset_path_counts()
    img = pipe.generate_controlnet(PROMPT, hint=hint, generator=torch.Generator(
        device="cuda").manual_seed(26), **T2I22)
    torch.cuda.synchronize()
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention

    counts = launch_counts()
    check(img.shape == (1, 768, 768, 3) and bool(np.isfinite(img).all())
          and float(img.std()) > 0, "controlnet: image")
    plain = qkv_attention.plain_on_card
    check(all(counts[k] > 0 for k in FORWARD_KERNELS) and plain == 0,
          f"controlnet: launches {counts}, {plain} attention calls by the plain route")
    print(f"controlnet: 768² image from the DPT-Large hint (hint mean "
          f"{hint.mean():.4f}, std {hint.std():.4f}); launches {json.dumps(counts)}")
    out["controlnet"] = counts
    return out


# --- phase 19: the optimizers and the examples ---------------------------------

def phase_optimizers(torch, np):
    """19a: every OPTIM_CASES row through ``fp32_master_optimizer`` for 3
    steps on the card and on the CPU, fp32 (TF32 off), on one parameter
    set: a factored [160, 130] matrix, a [144, 128, 3, 3] conv kernel, a
    vector and a bf16 [256, 96] tensor.  The fp32 masters and every fp32
    state tensor within 1e-5 relative L2 of the CPU's, the bf16 tensor and
    a bf16 moment within one bf16 rounding (2^-8); then a state_dict round
    trip on the card, bitwise, and one more step on both copies, bitwise."""
    import io

    from kandinsky2_tpu_torch.train.optim import optimizer_from_config
    from kandinsky2_tpu_torch.train.precision import fp32_master_optimizer

    shapes = {"matrix": (160, 130), "conv": (144, 128, 3, 3), "vector": (64,),
              "bf16": (256, 96)}
    rng = np.random.RandomState(41)
    p0 = {k: rng.randn(*shape).astype(np.float32) for k, shape in shapes.items()}
    grads = [{k: (rng.randn(*shape) * scale).astype(np.float32)
              for k, shape in shapes.items()} for scale in (1.0, 30.0, 1e-3)]

    def build(dev, optim_params, start=None):
        live = {k: (torch.tensor(v, device=dev) if start is None
                    else start[k].detach().clone()) for k, v in p0.items()}
        live["bf16"] = live["bf16"].bfloat16()
        for t in live.values():
            t.requires_grad_()
        factory = fp32_master_optimizer(optimizer_from_config(optim_params))
        return live, factory(list(live.values()))

    def step(live, opt, g):
        for k, t in live.items():
            t.grad = torch.tensor(g[k], device=t.device).to(t.dtype)
        opt.step()

    def states(opt):
        """[(tensor name, state key, tensor)] of the inner optimizer."""
        out = []
        for k, m in zip(shapes, opt.inner.param_groups[0]["params"]):
            out += [(k, key, v) for key, v in opt.inner.state[m].items()
                    if torch.is_tensor(v)]
        return out

    def tensors(live, opt):
        return [v for _, _, v in states(opt)] + list(opt.masters) + list(live.values())

    worst = {"fp32": 0.0, "bf16": 0.0}
    t0 = time.perf_counter()
    for case, (name, params) in OPTIM_CASES.items():
        optim_params = {"name": name, "params": params}
        runs = {}
        for dev in ("cuda", "cpu"):
            live, opt = build(dev, optim_params)
            for g in grads:
                step(live, opt, g)
            runs[dev] = (live, opt)
        (gl, go), (cl, co) = runs["cuda"], runs["cpu"]
        pairs = [(f"master {k}", a, b) for k, a, b in zip(shapes, go.masters, co.masters)]
        pairs.append(("bf16 tensor", gl["bf16"], cl["bf16"]))
        pairs += [(f"{k} {key}", a, b)
                  for (k, key, a), (_, _, b) in zip(states(go), states(co))]
        for what, a, b in pairs:
            check(a.dtype == b.dtype, f"optimizers {case} {what}: {a.dtype} != {b.dtype}")
            kind = "bf16" if a.dtype == torch.bfloat16 else "fp32"
            err = rel_l2(a.detach().float().cpu().numpy(), b.detach().float().numpy())
            worst[kind] = max(worst[kind], err)
            check(err <= (2.0 ** -8 if kind == "bf16" else 1e-5),
                  f"optimizers {case} {what}: rel_l2 {err:.3e} from the CPU")
        # a state_dict round trip on the card, then one more step on both
        buf = io.BytesIO()
        torch.save(go.state_dict(), buf)
        buf.seek(0)
        rl, ro = build("cuda", optim_params, start=gl)
        ro.load_state_dict(torch.load(buf, weights_only=True))
        for g_copy in (None, grads[0]):
            if g_copy is not None:
                step(gl, go, g_copy)
                step(rl, ro, g_copy)
            same = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(tensors(gl, go), tensors(rl, ro)))
            check(same, f"optimizers {case}: the state_dict round trip is not "
                  "bitwise" + (" after a step" if g_copy is not None else ""))
    print(f"optimizers: {len(OPTIM_CASES)} option sets of optax.adafactor, adam, adamw "
          f"and sgd, 3 steps through fp32 masters on the card against the CPU: worst "
          f"rel_l2 {worst['fp32']:.3e} fp32 (tol 1e-5), {worst['bf16']:.3e} bf16 "
          f"(tol {2.0 ** -8:.3e}); every state_dict round trip and the step after it "
          f"bitwise; {time.perf_counter() - t0:.2f} s")


def phase_examples(torch):
    """19c: every example of ``kandinsky2_tpu_torch.examples`` with
    ``--small --device cuda``, in-process (``examples.run_all``), outputs in
    a temporary directory: the images finite and of the size the JAX script
    makes, or the steps it trains; seconds and launches of each."""
    import shutil
    import tempfile

    from kandinsky2_tpu_torch.examples import run_all
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention

    out_dir = tempfile.mkdtemp(prefix="k2_examples_")
    seconds = {}
    try:
        for name in run_all.EXAMPLES:
            reset_path_counts()
            result = run_all.run_example(name, "cuda", out_dir)
            counts, plain = launch_counts(), qkv_attention.plain_on_card
            print(f"example {run_all.check_example(result)}; launches "
                  f"{json.dumps(counts)}, attention calls on the card by the plain "
                  f"route {plain}")
            seconds[name] = result["seconds"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"examples: all {len(seconds)} with --small --device cuda in "
          f"{sum(seconds.values()):.2f} s")
    return seconds


# --- phase 20: spatial parallelism ---------------------------------------------

SP_WORLD = 4
# past this many seconds of the script, 20b and 23b run DDIM 5 (with 20b's
# minute ahead) and 21b one timed step; phase 22 cuts past SP22_CUT_AT_S.
# Phases 1-19 took 726.3 s on an H100 80GB HBM3 at 700 W, and about a
# tenth longer on a slower host, which therefore cuts
LATE_CUT_AT_S = 810
# past this many seconds at their start, tp21-768 runs its prior at 5 steps,
# sp-train-768 only its checked step and sp22-768 / sp20-512 2 decoder steps: phases 1-19 took 870.2 s on
# the slowest host seen (H100 80GB HBM3, 700 W), and the parallel phases
# about 440 s more there even at LATE_CUT_AT_S's depths
TIGHT_AT_S = 900
# K3 at a rank's shard shapes (B, T, S, H, d) of the 768² 2.1 path on 4
# ranks (the local query rows against the gathered K/V after the 87 text
# tokens), of its MoVQ's mid attention, and at the 4096² ring's block
SP_K3_SHAPES = (("sp4 unet ds2 shard", (2, 576, 2391, 12, 64)),
                ("sp4 unet ds4 shard", (2, 144, 663, 18, 64)),
                ("sp4 unet ds8/middle shard", (2, 36, 231, 24, 64)),
                ("sp4 movq mid shard", (1, 2304, 9216, 1, 512)),
                ("sp4 4096^2 ring block", (1, 65536, 65536, 1, 512)))
# phase 20b's sp21-768: 2.1 text2img at full width on 4 ranks of the card
SP21 = dict(num_steps=10, guidance_scale=4, h=768, w=768, sampler="ddim_sampler",
            prior_cf_scale=4, prior_steps="25", output="float")
# the sharded bf16 latents against the unsharded ones: phase 15's bf16 row
# limit; the small fp32 image: the port's per-module limit
SP21_LATENT_TOL, SP_FP32_TOL = 5e-2, 1e-4


def _sp_rel(torch, a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _sp_rank_setup(torch):
    """A rank's float32 matmuls and convolutions in full fp32, as phase 1
    sets them in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sp_gloo_probe(torch, dist, mesh):
    """Which gloo collectives take CUDA tensors on this machine: each tried
    once by every rank on the same tensors (an unsupported one raises on
    every rank alike)."""
    ax = mesh.axis()
    x = torch.ones(4, device="cuda")
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=ax.group),
        "broadcast": lambda: dist.broadcast(x.clone(), ax.ranks[0], group=ax.group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in ax.ranks],
                                              x, group=ax.group),
    }
    out = {}
    for name, call in tries.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:  # the probe's finding, printed by the parent
            out[name] = f"refuses: {str(e).splitlines()[0][:100]}"
        dist.barrier(group=ax.group)
    return out


def sp_rank_primitives(mesh):
    """20a on one rank: the halo rows, the sharded GroupNorm (K1 + K2 on
    every shard) and K3 gathered and ring against the unsharded op and the
    plain versions on the card, from the same seeded full tensors on every
    rank; launches counted; the gloo probe."""
    import torch
    import torch.distributed as dist

    from kandinsky2_tpu_torch.ops import group_norm as gn
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )
    from kandinsky2_tpu_torch.parallel import spatial as sp
    from kandinsky2_tpu_torch.parallel.collectives import all_gather

    _sp_rank_setup(torch)
    ax = mesh.axis()
    n = ax.size
    g = torch.Generator(device="cuda").manual_seed(20)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    rows = lambda t: sp.shard_rows(t, ax)
    out = {"checks": [], "rank": ax.index}

    def record(name, err, tol):
        out["checks"].append((name, err, tol))

    reset_path_counts()
    # halo rows: this rank's block of the zero-padded tensor, exactly
    x = randn(2, 96, 96, 384).bfloat16()
    top = ax.index * 96 // n
    for name, f, pad, extra in (("halo_exchange_rows", sp.halo_exchange_rows, 1, 2),
                                ("halo_below_rows", sp.halo_below_rows, 0, 1)):
        got = f(rows(x), ax)
        want = torch.nn.functional.pad(x, (0, 0, 0, 0, pad, 1))
        want = want[:, top:top + 96 // n + extra]
        record(f"{name} vs zero pad", (got.float() - want.float()).abs().max().item(), 0.0)

    # the sharded GroupNorm at the 768² path's shard shapes against the
    # unsharded op (K1 + K2 in one call) on the whole tensor
    with torch.inference_mode():
        for label, shape, swish, film in (
                ("unet ds1 FiLM SiLU", (2, 96, 96, 384), 1.0, True),
                ("unet ds8", (2, 12, 12, 1536), 1.0, False),
                ("movq 768^2", (1, 768, 768, 128), 0.0, False)):
            C = shape[-1]
            x = randn(*shape).bfloat16()
            scale, bias = 1 + 0.1 * randn(C), 0.1 * randn(C)
            f = tuple(0.1 * randn(shape[0], 1, 1, C).bfloat16() for _ in range(2)) \
                if film else None
            whole = gn.group_norm(x, scale, bias, 32, 1e-5, swish, f)
            got = all_gather(gn.sharded_group_norm(rows(x), scale, bias, 32, 1e-5, ax,
                                                   swish, f), ax, dim=1)
            tol = 2 ** -7 * max(1.0, whole.float().abs().max().item())
            record(f"sharded GroupNorm {label} {list(shape)} bf16 vs unsharded",
                   (got.float() - whole.float()).abs().max().item(), tol)
        # mean/std 1000, fp32: the shards' pivots differ
        z = torch.randn((2, 96, 96, 384), generator=g, device="cuda", dtype=torch.float64)
        x = (z + 1000).float()
        xd = x.double().reshape(2, -1, 32, 12)
        truth = ((xd - xd.mean(dim=(1, 3), keepdim=True))
                 / torch.sqrt(xd.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5)
                 ).reshape(x.shape)
        one, zero = torch.ones(384, device="cuda"), torch.zeros(384, device="cuda")
        got = all_gather(gn.sharded_group_norm(rows(x), one, zero, 32, 1e-5, ax), ax, dim=1)
        record("sharded GroupNorm mean/std 1000 fp32 rel_l2 vs fp64",
               ((got.double() - truth).norm() / truth.norm()).item(), 1e-4)
        del z, x, xd, truth, got

        # K3 gathered: local query rows against the gathered K/V (T != S)
        for label, (B, T, H, d, E) in (("unet ds2", (2, 2304, 12, 64, 87)),
                                       ("unet ds8", (2, 144, 24, 64, 87)),
                                       ("movq mid", (1, 9216, 1, 512, 0))):
            q, k, v = (randn(B, T, H, d).bfloat16() for _ in range(3))
            ek, ev = (randn(B, E, H, d).bfloat16() for _ in range(2))
            kf = torch.cat([ek, all_gather(rows(k).contiguous(), ax, dim=1)], dim=1)
            vf = torch.cat([ev, all_gather(rows(v).contiguous(), ax, dim=1)], dim=1)
            o = all_gather(qkv_attention(rows(q), kf, vf), ax, dim=1)
            kk, vv = torch.cat([ek, k], 1), torch.cat([ev, v], 1)
            ref, _ = flash_attention_plain(q, kk, vv)
            one_card, _ = flash_attention_fwd(q, kk, vv)
            tol = 2e-2 * ref.float().abs().max().item()
            record(f"K3 gathered {label} (T {T // n}, S {E + T}, d {d}) vs plain",
                   (o.float() - ref.float()).abs().max().item(), tol)
            record(f"K3 gathered {label} vs the unsharded kernel",
                   (o.float() - one_card.float()).abs().max().item(), tol)
            # K3 ring: one launch a ring step (and one on the text prefix),
            # the (O, LSE) pairs merged
            if E:
                o = sp.sp_ring_attention_mh(rows(q), rows(k), rows(v), ax,
                                            extra_k=ek, extra_v=ev)
            else:  # the MoVQ's 96 x 96 map, its rows sharded
                o = sp.sp_ring_attention_rows(
                    *(rows(t.reshape(B, 96, 96, d)) for t in (q, k, v)), ax
                ).reshape(B, T // n, H, d)
            o = all_gather(o, ax, dim=1)
            record(f"K3 ring {label} vs plain", (o.float() - ref.float()).abs().max().item(),
                   tol)
            record(f"K3 ring {label} vs the unsharded kernel",
                   (o.float() - one_card.float()).abs().max().item(), tol)
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    if ax.backend == "gloo":
        out["gloo_probe"] = _sp_gloo_probe(torch, dist, mesh)
    torch.cuda.empty_cache()
    return out


def _sp_pipe(torch, config=None, dtype=None):
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    kw = {} if config is None else {"config": config}
    pipe = Kandinsky2_1(tokenizer1=tok1, tokenizer2=tok2, dtype=dtype or torch.bfloat16,
                        device="cuda", **kw)
    pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
    return pipe


def _sp_latents(pipe):
    """Keep the latents of every decode of ``pipe`` (this rank's rows)."""
    seen = []
    inner = pipe._decode

    def decode(latents):
        seen.append(latents)
        return inner(latents)

    pipe._decode = decode
    return seen


def sp_rank_t2i(mesh, steps: int):
    """20b on one rank: the full-width 2.1 text2img, unsharded on rank 0
    and then row-sharded over every rank with the same injected noise (a
    warm-up call and a timed one); the launches of the timed call, its
    seconds and peak memory, the latents' distance from the unsharded
    ones.  Then the small width in fp32, sharded against unsharded."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.configs import small_config
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel.collectives import all_gather

    _sp_rank_setup(torch)
    ax = mesh.axis()
    rng = np.random.RandomState(20)
    noise = dict(noise=rng.randn(1, 96, 96, 4).astype(np.float32),
                 prior_noise=rng.randn(1, 768).astype(np.float32),
                 prior_noise_seq=rng.randn(25, 1, 768).astype(np.float32))
    kw = dict(SP21, num_steps=steps, **noise)
    t0 = time.perf_counter()
    pipe = _sp_pipe(torch)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    seen = _sp_latents(pipe)
    if ax.index == 0:
        ref_img = pipe.generate_text2img(PROMPT, **kw)
        ref_lat = seen[-1]
    pipe.generate_text2img(PROMPT, sp_mesh=mesh, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    t0 = time.perf_counter()
    img = pipe.generate_text2img(PROMPT, sp_mesh=mesh, **kw)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    lat = all_gather(seen[-1], ax, dim=1)
    if ax.index == 0:
        out["latent_rel_l2"] = _sp_rel(torch, lat, ref_lat)
        out["image"] = (img.shape, bool(np.isfinite(img).all()), float(img.std()),
                        float(np.abs(img - ref_img).max()))
    del pipe, seen
    gc.collect()  # the latents hook ties the pipeline in a reference cycle
    torch.cuda.empty_cache()

    # the small width in fp32: the sharded image against the unsharded one
    small = _sp_pipe(torch, small_config(head_channels=64), torch.float32)
    kw = dict(num_steps=4, guidance_scale=4, h=128, w=128, prior_steps="5",
              output="float", noise=rng.randn(1, 16, 16, 4).astype(np.float32))
    small.set_seed(3)
    whole = small.generate_text2img(PROMPT, **kw)
    small.set_seed(3)
    got = small.generate_text2img(PROMPT, sp_mesh=mesh, **kw)
    out["small_fp32_rel_l2"] = float(np.linalg.norm(got - whole) / np.linalg.norm(whole))
    del small
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_rank_highres(mesh):
    """20c on one rank: ``examples.highres_sp_decode`` of the full MoVQ at
    4096² (the ring: 262,144 tokens) with its launches, then 2048² with the
    gathered and with the ring attention, the two images compared."""
    import torch

    from kandinsky2_tpu_torch.examples.highres_sp_decode import decode_rank
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention

    _sp_rank_setup(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    reset_path_counts()
    r = decode_rank(mesh, 4096, True, "cuda", keep_image=False)
    img = r.pop("device_image")
    out["4096"] = dict(r, launches=launch_counts(), plain_on_card=qkv_attention.plain_on_card,
                       shape=tuple(img.shape), finite=bool(torch.isfinite(img).all()),
                       std=img.float().std().item())
    del img, r
    torch.cuda.empty_cache()
    imgs = {}
    for impl in ("gathered", "ring"):
        r = decode_rank(mesh, 2048, True, "cuda", impl=impl, keep_image=False)
        imgs[impl] = r.pop("device_image")
        out[f"2048 {impl}"] = r
    out["2048 ring vs gathered rel_l2"] = _sp_rel(torch, imgs["ring"], imgs["gathered"])
    out["2048 finite"] = all(bool(torch.isfinite(i).all()) for i in imgs.values())
    del imgs
    torch.cuda.empty_cache()
    return out


def _sp_kernel_rows(torch, F):
    """20a's timing, in this process: K1 (the moments entry of a sharded
    GroupNorm) and K2 at a rank's shard of the 768² path's GroupNorms, and
    K3 at its shard's attention shapes (4 ranks), each beside its plain
    version, the library call and the bound, as phase 3."""
    from kandinsky2_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(21)
    rows = {"group_norm_stats": [], "group_norm_apply": [], "flash_attention_fwd": []}
    for label, (B, N, C) in (("sp4 unet ds1 shard", (2, 2304, 384)),
                             ("sp4 movq 768^2 shard", (1, 147456, 128))):
        x = torch.randn((B, N, C), generator=g, device="cuda").bfloat16()
        m, mp = gn.group_norm_moments(x, 32), gn.group_moments_plain(x, 32)
        torch.cuda.synchronize()
        err1 = (m - mp).abs().max().item()
        tol1 = 1e-4 * mp.abs().max().item()
        a = torch.rand((B, C), generator=g, device="cuda") + 0.5
        b = 0.1 * torch.randn((B, C), generator=g, device="cuda")
        y, yp = gn.group_norm_apply(x, a, b, 1.0), gn.group_norm_apply_plain(x, a, b, 1.0)
        err2 = (y.float() - yp.float()).abs().max().item()
        tol2 = 2 ** -7 * max(1.0, yp.float().abs().max().item())
        xs = cold_copies(x)
        t1 = timed_turns({"kernel": lambda: gn.group_norm_moments(xs(), 32),
                          "plain": lambda: gn.group_moments_plain(xs(), 32)}, 20)
        t2 = timed_turns({"kernel": lambda: gn.group_norm_apply(xs(), a, b, 1.0),
                          "plain": lambda: gn.group_norm_apply_plain(xs(), a, b, 1.0)}, 20)
        b1 = bound(3 * B * N * C, B * N * C * 2 + B * 32 * 3 * 4, PEAK_FP32)
        b2 = bound(6 * B * N * C, 2 * B * N * C * 2 + 2 * B * C * 4, PEAK_FP32)
        for name, t, bnd, err, tol in (("group_norm_stats", t1, b1, err1, tol1),
                                       ("group_norm_apply", t2, b2, err2, tol2)):
            print(f"sp {name} {label} [{B}, {N}, {C}] bf16: max_abs_err {err:.3e} "
                  f"(tol {tol:.3e})")
            _print_times(f"sp {name}", label, t, *bnd)
            check(err <= tol, f"{name} disagrees at {label}")
            rows[name].append(_row(label, (B, N, C), err, t, *bnd))
    rows["flash_attention_fwd"] = _k3_rows(torch, F, g, SP_K3_SHAPES)
    torch.cuda.empty_cache()
    return rows


def _k3_rows(torch, F, g, shapes) -> list:
    """K3 at each (label, (B, T, S, H, d)) of ``shapes`` (a rank's shard:
    its query rows against the gathered K/V, or a ring step's block)
    against its plain version (SDPA where the plain version's fp32 logits
    would not fit), timed in turns with the plain version and SDPA, each
    beside the bound, as phase 3."""
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    out = []
    for label, (B, T, S, H, d) in shapes:
        q = torch.randn((B, T, H, d), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, H, d), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        o, _ = flash_attention_fwd(q, k, v)
        big = T * S > 2**30  # the plain version's fp32 logits would be 17 GB
        ref = (F.scaled_dot_product_attention(qt, kt, vt).permute(0, 2, 1, 3) if big
               else flash_attention_plain(q, k, v)[0])
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        tol = 2e-2 * ref.float().abs().max().item()
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v),
               "library": lambda: F.scaled_dot_product_attention(qt, kt, vt)}
        if not big:
            fns["plain"] = lambda: flash_attention_plain(q, k, v)
        times = timed_turns(fns, 2 if big else 10)
        times.setdefault("plain", None)
        bnd = bound(4 * B * H * T * S * d, 2 * (2 * B * T + 2 * B * S) * H * d
                    + 4 * B * H * T, PEAK_BF16)
        print(f"sp K3 {label} B={B} T={T} S={S} H={H} d={d}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}) against {'SDPA' if big else 'the plain version'}")
        plain = ("not measured (its fp32 logits would be 17 GB)" if big
                 else "%.4f ms" % times["plain"])
        print(f"sp K3 {label}: kernel {times['kernel']:.4f} ms plain {plain} library "
              f"{times['library']:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"{bnd[0] / times['kernel']:.1%} of it")
        check(err <= tol, f"K3 disagrees at {label}")
        out.append(_row(label, (B, T, S, H, d), err, times, *bnd))
        del q, k, v, qt, kt, vt, o, ref
    return out


def phase_spatial(torch, smi: str, sp_steps: int, gloo, nccl):
    """20: spatial parallelism on the card.  20a the primitives on
    ``gloo``, 4 gloo ranks sharing the card, and on ``nccl``, 1 NCCL rank,
    and the kernels' times at the shard shapes in this process; 20b
    sp21-768; 20c highres-sp.  Every rank group runs under a deadline
    (killed and failed if it hangs).  Returns (sp21 launches per rank,
    highres launches per rank, the timed rows)."""
    import torch.nn.functional as F

    t_phase = time.perf_counter()
    # 20a
    sp_rows = _sp_kernel_rows(torch, F)
    for name, pool in (("gloo x4", gloo), ("nccl x1", nccl)):
        res = pool.run(sp_rank_primitives, timeout=300)
        for r in res:
            for what, err, tol in r["checks"]:
                print(f"sp 20a {name} rank {r['rank']}: {what}: {err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"20a {name} rank {r['rank']}: {what}")
            print(f"sp 20a {name} rank {r['rank']}: launches {json.dumps(r['launches'])}, "
                  f"attention calls on the card by the plain route {r['plain_on_card']}")
            check(all(r["launches"][k] > 0 for k in FORWARD_KERNELS),
                  f"20a {name}: a kernel was not launched")
            check(r["plain_on_card"] == 0, f"20a {name}: attention missed K3")
        if "gloo_probe" in res[0]:
            print(f"sp 20a gloo with CUDA tensors: {json.dumps(res[0]['gloo_probe'])}")
    print(f"time: phase 20a {time.perf_counter() - t_phase:.1f} s")

    # 20b
    t0 = time.perf_counter()
    res = gloo.run(sp_rank_t2i, sp_steps, timeout=420)
    r0 = res[0]
    shape, finite, std, diff = r0["image"]
    print(f"sp21-768: built the full pipeline on each rank in "
          f"{max(r['build_s'] for r in res):.2f} s; image {shape} finite {finite} "
          f"std {std:.4f}, max |sharded - unsharded| {diff:.4e}; latents rel_l2 "
          f"{r0['latent_rel_l2']:.4e} (tol {SP21_LATENT_TOL}); small fp32 image "
          f"rel_l2 {r0['small_fp32_rel_l2']:.4e} (tol {SP_FP32_TOL})")
    check(finite and std > 0 and shape == (1, 768, 768, 3), "sp21-768 image")
    check(r0["latent_rel_l2"] <= SP21_LATENT_TOL, "sp21-768 latents")
    check(r0["small_fp32_rel_l2"] <= SP_FP32_TOL, "sp21 small fp32 image")
    for r in res:
        check_full_launches(f"sp21-768 rank {res.index(r)}", r["launches"], sp_steps,
                            encoded=False)
        check(r["plain_on_card"] == 0, "sp21-768: attention missed K3")
    sec = max(r["seconds"] for r in res)
    print(f"sp21-768: {sec:.4f} s/image on {SP_WORLD} ranks sharing the card "
          f"(768^2, DDIM {sp_steps}, prior 25, CFG 4, bf16); peak memory per rank "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in res)
          + f" GiB (phase 5, unsharded: 7.37 GiB); {smi}")
    sp21_launches = res[0]["launches"]
    print(f"time: phase 20b {time.perf_counter() - t0:.1f} s")

    # 20c
    t0 = time.perf_counter()
    print(f"highres-sp: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB; the card's memory in use: {smi_memory()}")
    res = gloo.run(sp_rank_highres, timeout=420)
    full = [r["4096"] for r in res]
    for i, r in enumerate(full):
        print(f"highres-sp rank {i}: 4096^2 {r['shape']} finite {r['finite']} "
              f"std {r['std']:.4f} in {r['seconds']:.3f} s, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; launches "
              f"{json.dumps(r['launches'])}, plain route {r['plain_on_card']}")
        check(r["finite"] and r["std"] > 0 and r["shape"] == (1, 4096, 4096, 3),
              "highres-sp 4096^2 image")
        check(all(r["launches"][k] > 0 for k in FORWARD_KERNELS),
              "highres-sp: a kernel was not launched")
        check(r["plain_on_card"] == 0, "highres-sp: attention missed K3")
    rel = res[0]["2048 ring vs gathered rel_l2"]
    print(f"highres-sp: 2048^2 gathered {res[0]['2048 gathered']['seconds']:.3f} s, "
          f"ring {res[0]['2048 ring']['seconds']:.3f} s, finite "
          f"{res[0]['2048 finite']}, ring against gathered rel_l2 {rel:.4e} "
          f"(tol {SP21_LATENT_TOL}); 4096^2 {max(r['seconds'] for r in full):.3f} s "
          f"on {SP_WORLD} ranks; {smi}")
    check(res[0]["2048 finite"] and rel <= SP21_LATENT_TOL,
          "highres-sp: 2048^2 ring and gathered disagree")
    highres_launches = full[0]["launches"]
    print(f"time: phase 20c {time.perf_counter() - t0:.1f} s")
    return sp21_launches, highres_launches, sp_rows


# --- phase 21: row-sharded training ---------------------------------------------

# sp-train-768: CONFIG_2_1's UNet at 768² on a (data 1, sp 4) mesh of the 4
# ranks sharing the card, batch 1, fp32 parameters and bf16 compute, the
# train_sp example's settings (Adafactor at 5e-6, the loss-second-moment
# sampler, no EMA, remat)
SP_TRAIN_OPTIM = {"name": "optax.adafactor", "params": {"learning_rate": 5e-6}}
# the tensors whose gradients rank 0 holds against the unsharded step: the
# input conv, a sharded ds2 attention's qkv, the middle attention's output,
# an output block's text K/V projection, the head's GroupNorm scale and conv
SP_TRAIN_GRADS = ("input_blocks.0.0.weight", "input_blocks.5.1.qkv.weight",
                  "middle_block.1.proj_out.weight", "output_blocks.11.1.encoder_kv.weight",
                  "out.0.weight", "out.2.weight")
# phase 7's and 13's card limits: bf16 on the card against another order of
# the same sums
SP_TRAIN_LOSS_TOL, SP_TRAIN_GRAD_TOL = 1e-2, 5e-2
# a step with remat runs the UNet forward twice (the step, then its
# recomputation in the backward) and the backward once: K1 (the sharded
# norms' moments entry) and K2 95 x 2, K3 22 x 2, K5 and K4 22 (the
# sharded GroupNorm's backward is autograd of its plain formulation)
SP_TRAIN_LAUNCHES = {"group_norm_stats": 2 * UNET_LAUNCHES[0],
                     "group_norm_apply": 2 * UNET_LAUNCHES[0],
                     "flash_attention_fwd": 2 * UNET_LAUNCHES[1],
                     "flash_attention_bwd_dq": UNET_LAUNCHES[1],
                     "flash_attention_bwd_dkv": UNET_LAUNCHES[1]}
# the shard shapes (B·H, T, S) of a rank at 768², batch 1, 4 ranks: local
# query rows against the gathered K/V after the 87 text tokens, and one
# ring step's block (the local rows against a visiting block at ds2)
SP_BWD_SHAPES = (("sp4 unet ds2 shard", (1, 576, 2391, 12)),
                 ("sp4 unet ds4 shard", (1, 144, 663, 18)),
                 ("sp4 unet ds8/middle shard", (1, 36, 231, 24)),
                 ("sp4 unet ds2 ring step", (1, 576, 576, 12)))


def _param_digests(torch, model) -> list:
    """``_tensor_digests`` of the model's parameters."""
    return _tensor_digests(torch, model.parameters())


def _tensor_digests(torch, tensors) -> list:
    """One int64 a tensor that any change of any bit changes: the tensor's
    words (2 bytes for bf16, 4 otherwise), each times an odd weight,
    summed with wrap-around."""
    out = []
    for p in tensors:
        flat = p.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
        bits = bits.to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) * 2 + 1
        out.append(int((bits * w).sum()))
    return out


def sp_rank_backward(mesh, device="cuda"):
    """21a on one rank, bf16 at the 768² path's shard shapes: the sharded
    GroupNorm's gradient (x, scale, bias, FiLM) against the unsharded op's;
    K5 + K4 on this rank's query rows against the gathered K/V against the
    plain backward; the gradients through the gathered attention and
    through the ring (K3, then K5 and K4 once a ring step) against the
    unsharded kernels' (each rank's K/V gradient arriving at its owner);
    launches counted."""
    import torch

    from kandinsky2_tpu_torch.ops import group_norm as gn
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )
    from kandinsky2_tpu_torch.parallel import spatial as sp
    from kandinsky2_tpu_torch.parallel.collectives import all_gather, psum

    _sp_rank_setup(torch)
    ax = mesh.axis()
    g = torch.Generator(device=device).manual_seed(21)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)
    rows = lambda t: sp.shard_rows(t, ax)
    out = {"checks": [], "rank": ax.index}
    record = lambda name, err, tol: out["checks"].append((name, err, tol))
    reset_path_counts()

    # the sharded GroupNorm's gradient at the UNet ds1 shape, FiLM and SiLU
    x = randn(1, 96, 96, 384).bfloat16()
    scale, bias = 1 + 0.1 * randn(384), 0.1 * randn(384)
    fs, fb = (0.1 * randn(1, 1, 1, 384).bfloat16() for _ in range(2))
    gy = randn(1, 96, 96, 384).bfloat16()
    leaves = lambda: [t.detach().clone().requires_grad_() for t in (x, scale, bias, fs, fb)]
    ins = leaves()
    whole = torch.autograd.grad(gn.group_norm(ins[0], *ins[1:3], 32, 1e-5, 1.0,
                                              (ins[3], ins[4])), ins, gy)
    ins = leaves()
    y = gn.sharded_group_norm(rows(ins[0]), ins[1], ins[2], 32, 1e-5, ax, 1.0,
                              (ins[3], ins[4]))
    got = [psum(t.float(), ax) for t in torch.autograd.grad(y, ins, rows(gy))]
    for name, a, b in zip(("x", "scale", "bias", "FiLM scale", "FiLM shift"), got, whole):
        # both are autograd of a plain formulation on the same bf16 inputs:
        # phase 6's GroupNorm gradient tolerance
        record(f"sharded GroupNorm d{name} [1, 96, 96, 384] vs unsharded", rel_err(a, b),
               1e-2)
    del x, gy, ins, y, got, whole

    for label, (B, T, S, H) in SP_BWD_SHAPES:
        if "ring" in label:
            continue
        # the whole image's tokens, the 87 text tokens before them
        d, E, Tw = 64, S - T * SP_WORLD, T * SP_WORLD
        q, k, v, do = (randn(B, Tw, H, d).bfloat16() for _ in range(4))
        ek, ev = (randn(B, E, H, d).bfloat16() for _ in range(2))
        kf, vf = torch.cat([ek, k], 1), torch.cat([ev, v], 1)
        # K5 + K4 on the local query rows against the gathered K/V
        o, lse = flash_attention_fwd(rows(q), kf, vf)
        got = flash_attention_bwd(rows(q), kf, vf, o, lse, rows(do))
        want = flash_attention_bwd_plain(rows(q), kf, vf, o, lse, rows(do))
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            record(f"K5 + K4 {label} (T {rows(q).shape[1]}, S {kf.shape[1]}) {name} vs "
                   "plain", rel_err(a, b), 2e-2)
        # the unsharded kernels' gradients of the whole attention
        lv = [t.detach().clone().requires_grad_() for t in (q, k, v, ek, ev)]
        ow = flash_attention(lv[0], torch.cat([lv[3], lv[1]], 1),
                             torch.cat([lv[4], lv[2]], 1))[0]
        ref = torch.autograd.grad(ow, lv, do)
        by_impl = {}
        for impl in ("gathered", "ring"):
            lv = [t.detach().clone().requires_grad_() for t in (q, k, v, ek, ev)]
            if impl == "gathered":
                o = qkv_attention(rows(lv[0]),
                                  torch.cat([lv[3], all_gather(rows(lv[1]), ax, dim=1)], 1),
                                  torch.cat([lv[4], all_gather(rows(lv[2]), ax, dim=1)], 1))
            else:
                o = sp.sp_ring_attention_mh(rows(lv[0]), rows(lv[1]), rows(lv[2]), ax,
                                            extra_k=lv[3], extra_v=lv[4])
            grads = by_impl[impl] = [psum(t.float(), ax)
                                     for t in torch.autograd.grad(o, lv, rows(do))]
            for name, a, b in zip(("dq", "dk", "dv", "d prefix k", "d prefix v"), grads,
                                  ref):
                record(f"{impl} backward {label} {name} vs the unsharded kernels",
                       rel_err(a, b), 2e-2)
        for name, a, b in zip(("dq", "dk", "dv", "d prefix k", "d prefix v"),
                              by_impl["ring"], by_impl["gathered"]):
            record(f"ring backward {label} {name} vs the gathered backward", rel_err(a, b),
                   2e-2)
        del q, k, v, do, ek, ev, kf, vf, o, lse, got, want, lv, ow, ref, grads, by_impl
    if device == "cuda":
        torch.cuda.synchronize()
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    return out


def _sp_backward_rows(torch, F, shapes=SP_BWD_SHAPES, seed=22):
    """21a's timing, in this process: K5 and K4 at a rank's shard shapes
    of the 768² train step (4 ranks, batch 1) and at one ring step's
    block (``shapes``: (label, (B, T, S, H)), d = 64), each beside the
    whole plain backward, SDPA's backward and the bound, as phase 6."""
    from kandinsky2_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    for label, (B, T, S, H) in shapes:
        d = 64
        randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").bfloat16()
        q, k, v, do = randn(B, T, H, d), randn(B, S, H, d), randn(B, S, H, d), \
            randn(B, T, H, d)
        o, lse = flash_attention_fwd(q, k, v)
        k5 = lambda: flash_attention_bwd_dq(q, k, v, o, do, lse)
        dq, delta = k5()
        k4 = lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        dk, dv = k4()
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        abs_errs = {n: (a.float() - b.float()).abs().max().item()
                    for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        for n, e in errs.items():
            check(e <= 2e-2, f"K4/K5 {n} disagrees at {label}")
        qg, kg, vg = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg)
        dot = do.permute(0, 2, 1, 3)
        times = timed_turns({
            "plain": lambda: flash_attention_bwd_plain(q, k, v, o, lse, do),
            "k5": k5, "k4": k4,
            "library": lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                                   retain_graph=True)}, 10)
        qo_bytes, kv_bytes, row_bytes = 2 * B * T * H * d, 2 * B * S * H * d, 4 * B * H * T
        b5 = bound(6 * B * H * T * S * d, 4 * qo_bytes + 2 * kv_bytes + 2 * row_bytes,
                   PEAK_BF16)
        b4 = bound(8 * B * H * T * S * d, 2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes,
                   PEAK_BF16)
        t5 = {"kernel": times["k5"], "plain": times["plain"], "library": times["library"]}
        t4 = {"kernel": times["k4"], "plain": times["plain"], "library": times["library"]}
        print(f"sp K5/K4 {label} B·H={B * H} T={T} S={S} d=64: max_rel_err dq "
              f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} (tol 2e-2)")
        _print_times("sp K5 dQ    ", label, t5, *b5)
        _print_times("sp K4 dK/dV ", label, t4, *b4)
        print(f"  (plain: the whole plain backward; library: SDPA's backward, dq, dk "
              f"and dv together; K5 + K4 {(times['k5'] + times['k4']) / times['library']:.2f}x"
              f" the library's time)")
        rows["flash_attention_bwd_dq"].append(_row(label, (B, T, S, H, d), abs_errs["dq"],
                                                   t5, *b5))
        rows["flash_attention_bwd_dkv"].append(
            _row(label, (B, T, S, H, d), max(abs_errs["dk"], abs_errs["dv"]), t4, *b4))
        del q, k, v, do, o, lse, dq, delta, dk, dv, ref, qg, kg, vg, out, dot
    torch.cuda.empty_cache()
    return rows


def _sp_train_model(torch, config, dtype, device, seed=0):
    from kandinsky2_tpu_torch.configs import create_model
    from kandinsky2_tpu_torch.pipelines.base import init_random_

    unet = create_model(**dict(config["model_config"], inpainting=False), dtype=dtype,
                        device=device)
    init_random_(unet, torch.Generator(device=device).manual_seed(seed))
    return unet


def _sp_train_batch(torch, mc, B, lat, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    return {"image_latents": randn(B, lat, lat, 4), "full_emb": randn(B, 77, mc[
        "text_encoder_in_dim1"]), "pooled_emb": randn(B, mc["text_encoder_in_dim2"]),
        "image_emb": randn(B, mc["image_encoder_in_dim"])}, randn(B, lat, lat, 4)


def _captured_grads(unet, names=None):
    """An optimizer pre-step hook that keeps the gradients of ``names``
    (all where None) on the host, and the dict they land in."""
    kept = {}

    def hook(opt, args, kwargs):
        kept.update({n: p.grad.float().cpu() for n, p in unet.named_parameters()
                     if p.grad is not None and (names is None or n in names)})

    return hook, kept


def sp_rank_train_small(mesh, device="cuda"):
    """21c on one rank: (1) the tiny UNet of examples.train_sp in fp32 on a
    (data 2, sp 2) mesh, two steps with injected draws and optax.sgd,
    against the same two steps unsharded on the whole batch of 2; (2) the
    small UNet with 64-wide heads in bf16 on a (data 1, sp 4) mesh, one
    step with the ring forced (RING_THRESHOLD_TOKENS 1: K3 once on the text
    prefix and once a ring step, K5 and K4 the same in the backward)
    against the same step through the gathered attention."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.configs import CONFIG_2_1, deep_copy_config, small_config
    from kandinsky2_tpu_torch.examples.train_sp import DEMO
    from kandinsky2_tpu_torch.models.layers import GroupNorm32
    from kandinsky2_tpu_torch.models.unet import AttentionBlock
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel import spatial as sp
    from kandinsky2_tpu_torch.parallel.mesh import Mesh
    from kandinsky2_tpu_torch.train import train_unclip as tu
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config

    _sp_rank_setup(torch)
    out = {}
    sgd = optimizer_from_config({"name": "optax.sgd", "params": {"learning_rate": 0.05}})
    cfg = deep_copy_config(CONFIG_2_1)
    cfg["model_config"].update(DEMO)
    dcfg = cfg["diffusion_config"]
    mc = cfg["model_config"]
    batch, _ = _sp_train_batch(torch, mc, 2, 16, device, 30)
    g = torch.Generator(device=device).manual_seed(31)
    draws = [(torch.randint(0, 1000, (2,), generator=g, device=device),
              torch.randn((2, 16, 16, 4), generator=g, device=device)) for _ in range(2)]
    grid = Mesh(None, ("data", "sp"), shape=(2, 2))
    unet = _sp_train_model(torch, cfg, torch.float32, device)
    p0 = [p.detach().clone() for p in unet.parameters()]
    init_state, train_fn = tu.make_spdp_train_fn(unet, dcfg, sgd, grid, ema_decay=None)
    state = init_state(seed=0)
    losses = [float(train_fn(state, batch, t, n)["loss"]) for t, n in draws]
    whole = _sp_train_model(torch, cfg, torch.float32, device)
    init_w, step_w = tu.make_unclip_train_step(whole, dcfg, sgd, ema_decay=None)
    state_w = init_w(seed=0)
    losses_w = [float(step_w(state_w, batch, t, n)["loss"]) for t, n in draws]
    cat = lambda ps: torch.cat([p.detach().reshape(-1).double() for p in ps])
    a, b, a0 = cat(unet.parameters()), cat(whole.parameters()), cat(p0)
    out["fp32 params rel_l2"] = ((a - b).norm() / b.norm()).item()
    out["fp32 update rel_l2"] = ((a - b).norm() / (b - a0).norm()).item()
    out["fp32 losses"] = (losses, losses_w)
    out["fp32 digests"] = _param_digests(torch, unet)
    del unet, whole, state, state_w

    # bf16, the ring forced, against the gathered attention
    grid = Mesh(None, ("data", "sp"), shape=(1, SP_WORLD))
    cfg = small_config(head_channels=64)
    mc = cfg["model_config"]
    batch, noise = _sp_train_batch(torch, mc, 1, 16, device, 32)
    t = torch.tensor([500], device=device)
    runs = {}
    for impl in ("ring", "gathered"):
        unet = _sp_train_model(torch, cfg, torch.bfloat16, device)
        init_state, train_fn = tu.make_spdp_train_fn(
            unet, cfg["diffusion_config"], sgd, grid, ema_decay=None)
        state = init_state(seed=0)
        hook, kept = _captured_grads(unet)
        state.optimizer.register_step_pre_hook(hook)
        saved = sp.RING_THRESHOLD_TOKENS
        sp.RING_THRESHOLD_TOKENS = 1 if impl == "ring" else 2**62
        reset_path_counts()
        try:
            loss = float(train_fn(state, batch, t, noise)["loss"])
        finally:
            sp.RING_THRESHOLD_TOKENS = saved
        if device == "cuda":
            torch.cuda.synchronize()
        runs[impl] = dict(loss=loss, grads=kept, launches=launch_counts(),
                          plain_on_card=qkv_attention.plain_on_card)
        out["n_attn"] = sum(isinstance(m, AttentionBlock) for m in unet.modules())
        out["n_norm"] = sum(isinstance(m, GroupNorm32) for m in unet.modules())
        del unet, state
    r, w = runs["ring"], runs["gathered"]
    num = sum(float((r["grads"][n] - w["grads"][n]).double().norm() ** 2) for n in w["grads"])
    den = sum(float(w["grads"][n].double().norm() ** 2) for n in w["grads"])
    out["bf16 ring"] = dict(loss=r["loss"], gathered_loss=w["loss"],
                            grads_rel_l2=float(np.sqrt(num / den)),
                            finite=all(bool(torch.isfinite(v).all())
                                       for v in r["grads"].values()),
                            launches=r["launches"], plain_on_card=r["plain_on_card"])
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def sp_rank_train768(mesh, steps: int, device="cuda", config=None, res=768):
    """21b sp-train-768 on one rank: CONFIG_2_1's UNet (``config`` for a
    rehearsal) at ``res``² on a (data 1, sp 4) mesh, batch 1, the
    example's settings.  Rank 0 first runs the same step unsharded with
    the same injected t and noise on the same seeded weights and keeps the
    loss and the gradients of SP_TRAIN_GRADS; then every rank takes the
    sharded step with those draws (the warm-up, its gradients kept on rank
    0) and ``steps`` timed ones, each ending in a synchronize: seconds,
    the gradient all-reduce's seconds, launches, parameter digests after
    every step, peak memory."""
    import torch

    from kandinsky2_tpu_torch.configs import CONFIG_2_1, schedule_kwargs
    from kandinsky2_tpu_torch.diffusion.gaussian import make_schedule
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel.mesh import Mesh
    from kandinsky2_tpu_torch.train import train_unclip as tu
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config

    _sp_rank_setup(torch)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    grid = Mesh(None, ("data", "sp"), shape=(1, SP_WORLD))
    rank = grid.axis("sp").index
    cfg = config or CONFIG_2_1
    t0 = time.perf_counter()
    unet = _sp_train_model(torch, cfg, torch.bfloat16, device)
    batch, noise = _sp_train_batch(torch, cfg["model_config"], 1, res // 8, device, 23)
    t_inj = torch.tensor([417], device=device)
    sync()
    out = {"rank": rank, "build_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in unet.parameters())}
    if rank == 0:
        skw = schedule_kwargs(cfg["diffusion_config"], "")
        sched = make_schedule(**skw["make_schedule"], device=device)
        loss, _ = tu.unclip_loss(unet, sched, batch, t_inj, noise,
                                 torch.ones((1,), device=device), mean_type=skw["mean_type"],
                                 var_type=skw["var_type"], loss_type=skw["loss_type"],
                                 remat=True)
        loss.backward()
        params = dict(unet.named_parameters())
        out["ref_loss"] = float(loss.detach())
        out["ref_grads"] = {n: params[n].grad.float().cpu() for n in SP_TRAIN_GRADS
                            if n in params}
        out["unsharded_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0
        unet.zero_grad(set_to_none=True)
        del loss, params
        if cuda:
            torch.cuda.empty_cache()
    init_state, train_fn = tu.make_spdp_train_fn(
        unet, cfg["diffusion_config"], optimizer_from_config(SP_TRAIN_OPTIM), grid,
        schedule_sampler="loss-second-moment", ema_decay=None, remat=True)
    state = init_state(seed=0)
    hook, kept = _captured_grads(unet, SP_TRAIN_GRADS)
    handle = state.optimizer.register_step_pre_hook(hook)
    inner, reduce_s = tu.pmean_grads, []

    def timed_pmean(params, axis, *args, **kwargs):
        sync()
        t = time.perf_counter()
        inner(params, axis, *args, **kwargs)
        sync()
        reduce_s.append(time.perf_counter() - t)

    tu.pmean_grads = timed_pmean
    digests = [_param_digests(torch, unet)]
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_path_counts()
        t0 = time.perf_counter()
        metrics = train_fn(state, batch, t_inj, noise)
        sync()
        out["warm_s"] = time.perf_counter() - t0
        out["warm_reduce_s"] = sum(reduce_s)
        out["warm_launches"] = launch_counts()
        out["loss"] = float(metrics["loss"])
        handle.remove()
        out["grads"] = kept
        digests.append(_param_digests(torch, unet))
        out["steps"] = []
        for _ in range(steps):
            reduce_s.clear()
            reset_path_counts()
            t0 = time.perf_counter()
            metrics = train_fn(state, batch)
            sync()
            out["steps"].append(dict(seconds=time.perf_counter() - t0,
                                     reduce_s=sum(reduce_s), loss=float(metrics["loss"]),
                                     launches=launch_counts(),
                                     plain_on_card=qkv_attention.plain_on_card))
            digests.append(_param_digests(torch, unet))
    finally:
        tu.pmean_grads = inner
    out["digests"] = digests
    out["finite"] = all(bool(torch.isfinite(p).all()) for p in unet.parameters())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0
    del unet, state, init_state, train_fn, batch, noise
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_sp_train(torch, smi: str, t_script: float, gloo, nccl):
    """21: row-sharded training on ``gloo``, 4 gloo ranks sharing the card,
    and the primitives on ``nccl``, 1 NCCL rank.  21a the backward
    primitives on the ranks and K5 and K4 timed at the shard shapes in this
    process; 21c the small width (fp32 (data 2, sp 2) against unsharded;
    bf16 with the ring forced); 21b sp-train-768.  Returns (a step's
    launches on rank 0 of sp-train-768, the timed rows)."""
    import torch.nn.functional as F

    t_phase = time.perf_counter()
    # 21a
    rows = _sp_backward_rows(torch, F)
    for name, pool in (("gloo x4", gloo), ("nccl x1", nccl)):
        for r in pool.run(sp_rank_backward, timeout=300):
            for what, err, tol in r["checks"]:
                print(f"sp 21a {name} rank {r['rank']}: {what}: {err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"21a {name} rank {r['rank']}: {what}")
            print(f"sp 21a {name} rank {r['rank']}: launches {json.dumps(r['launches'])}, "
                  f"attention calls on the card by the plain route {r['plain_on_card']}")
            check(all(v > 0 for v in r["launches"].values()),
                  f"21a {name}: a kernel was not launched")
            check(r["plain_on_card"] == 0, f"21a {name}: an attention missed the kernels")
    nccl.close()
    print(f"time: phase 21a {time.perf_counter() - t_phase:.1f} s")

    # 21c
    t0 = time.perf_counter()
    res = gloo.run(sp_rank_train_small, timeout=300)
    r0 = res[0]
    print(f"sp-train small fp32 (data 2, sp 2): losses {r0['fp32 losses'][0]} against "
          f"unsharded {r0['fp32 losses'][1]}; parameters rel_l2 "
          f"{r0['fp32 params rel_l2']:.3e} (tol 1e-5), the update's "
          f"{r0['fp32 update rel_l2']:.3e} (recorded)")
    check(r0["fp32 params rel_l2"] <= 1e-5, "sp-train small fp32: parameters")
    check(all(r["fp32 digests"] == r0["fp32 digests"] for r in res),
          "sp-train small fp32: parameters differ across the ranks")
    n_attn, n_norm = r0["n_attn"], r0["n_norm"]
    steps_ring = 1 + SP_WORLD  # the text prefix, then one a ring step
    want = {"group_norm_stats": n_norm, "group_norm_apply": n_norm,
            "flash_attention_fwd": n_attn * steps_ring,
            "flash_attention_bwd_dq": n_attn * steps_ring,
            "flash_attention_bwd_dkv": n_attn * steps_ring}
    for r in res:
        b = r["bf16 ring"]
        print(f"sp-train small bf16 ring rank {res.index(r)}: loss {b['loss']:.5f} "
              f"against gathered {b['gathered_loss']:.5f}; gradients rel_l2 "
              f"{b['grads_rel_l2']:.3e} (tol {SP_TRAIN_GRAD_TOL}); launches "
              f"{json.dumps(b['launches'])} (pinned at {json.dumps(want)}), plain "
              f"route {b['plain_on_card']}")
        check(b["finite"] and abs(b["loss"] - b["gathered_loss"])
              <= SP_TRAIN_LOSS_TOL * abs(b["gathered_loss"]), "sp-train bf16 ring loss")
        check(b["grads_rel_l2"] <= SP_TRAIN_GRAD_TOL, "sp-train bf16 ring gradients")
        check(b["launches"] == want, "sp-train bf16 ring: launches")
        check(b["plain_on_card"] == 0, "sp-train bf16 ring: the plain route ran")
    print(f"time: phase 21c {time.perf_counter() - t0:.1f} s")

    # 21b
    t0 = time.perf_counter()
    steps = (3 if t0 - t_script <= LATE_CUT_AT_S else 1 if t0 - t_script <= TIGHT_AT_S
             else 0)
    print(f"sp-train-768: {steps} timed step(s) (one where the script passes "
          f"{LATE_CUT_AT_S} s here, none past {TIGHT_AT_S} s; {t0 - t_script:.1f} s so "
          f"far); the card's memory in use: {smi_memory()}")
    res = gloo.run(sp_rank_train768, steps, timeout=900)
    r0 = res[0]
    loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    print(f"sp-train-768: UNet {r0['n_params']} parameters built in "
          f"{max(r['build_s'] for r in res):.2f} s a rank; unsharded step on rank 0 "
          f"(peak {r0['unsharded_peak_gib']:.2f} GiB): loss {r0['ref_loss']:.6f}; "
          f"sharded warm-up step {max(r['warm_s'] for r in res):.3f} s, loss "
          f"{r0['loss']:.6f}, rel err {loss_err:.3e} (tol {SP_TRAIN_LOSS_TOL})")
    check(loss_err <= SP_TRAIN_LOSS_TOL, "sp-train-768: the sharded loss")
    check(set(r0["ref_grads"]) == set(SP_TRAIN_GRADS), "sp-train-768: a named tensor")
    for n in SP_TRAIN_GRADS:
        a, b = r0["grads"][n], r0["ref_grads"][n]
        err = float((a - b).norm() / b.norm())
        print(f"sp-train-768: d {n} {list(b.shape)} rel_l2 {err:.3e} "
              f"(tol {SP_TRAIN_GRAD_TOL})")
        check(err <= SP_TRAIN_GRAD_TOL, f"sp-train-768: gradient of {n}")
    for i, r in enumerate(res):
        check(r["digests"] == r0["digests"],
              f"sp-train-768: rank {i}'s parameters differ from rank 0's")
        moved = sum(a != b for a, b in zip(r["digests"][0], r["digests"][-1]))
        check(moved == len(r["digests"][0]),
              f"sp-train-768 rank {i}: {len(r['digests'][0]) - moved} tensors unmoved")
        check(r["finite"], f"sp-train-768 rank {i}: parameters not finite")
        check(r["warm_launches"] == SP_TRAIN_LAUNCHES,
              f"sp-train-768 rank {i}: warm-up launches {r['warm_launches']}")
        for s in r["steps"]:
            check(s["launches"] == SP_TRAIN_LAUNCHES and s["plain_on_card"] == 0,
                  f"sp-train-768 rank {i}: launches {s['launches']}, plain route "
                  f"{s['plain_on_card']}")
            check(math.isfinite(s["loss"]), f"sp-train-768 rank {i}: loss not finite")
        print(f"sp-train-768 rank {i}: steps " + ", ".join(
            f"{s['seconds']:.3f} s (all-reduce {s['reduce_s']:.3f} s, loss "
            f"{s['loss']:.5f})" for s in r["steps"]) + f"; peak {r['peak_gib']:.2f} GiB;"
            f" launches a step {json.dumps(r['warm_launches'])}")
    n = len(r0["steps"])
    if n:
        step_s = sum(max(r["steps"][i]["seconds"] for r in res) for i in range(n)) / n
        reduce_s = sum(max(r["steps"][i]["reduce_s"] for r in res) for i in range(n)) / n
    else:
        step_s = max(r["warm_s"] for r in res)
        reduce_s = max(r["warm_reduce_s"] for r in res)
    print(f"sp-train-768: {step_s:.4f} s/step (the slowest rank, "
          + (f"mean of {n}" if n else "the warm-up step") + "), the "
          f"gradient all-reduce {reduce_s:.4f} s of it; 768², batch 1, mesh (data 1, "
          f"sp {SP_WORLD}) sharing the card over gloo, fp32 parameters, bf16 compute, "
          f"Adafactor 5e-6, remat, no EMA; every parameter bitwise equal across the "
          f"ranks after each step and every one moved; peak per rank " + ", ".join(
              f"{r['peak_gib']:.2f}" for r in res)
          + f" GiB (train-768 unsharded, EMA, no remat: 24.94 GiB); {smi}")
    print(f"time: phase 21b {time.perf_counter() - t0:.1f} s")
    return r0["warm_launches"], rows


# --- phase 24: ZeRO-3 (FSDP) training of the 2.1 decoder ------------------------

# 24a: tests/test_fsdp_accum.py's tiny CONFIG_2_1 UNet, 8 examples of 16^2
# latents, min_elems 1 << 10; Adam's and Adafactor's eps raised from
# rounding level so that the first update is a smooth function of the
# gradient (it is the gradient's sign otherwise, which the order of the sums
# decides where a gradient is at rounding level)
FSDP_TINY = dict(num_channels=32, num_res_blocks=1, channel_mult="1,2",
                 attention_resolutions="32", num_head_channels=16, model_dim=32,
                 text_encoder_in_dim1=16, text_encoder_in_dim2=32, image_encoder_in_dim=32,
                 num_image_embs=2, inpainting=False)
FSDP_SMALL_ADAMW = {"name": "optax.adamw", "params": {"learning_rate": 1e-3, "eps": 1e-3}}
FSDP_SMALL_CASES = {
    "adamw, EMA, loss-aware sampler (data 4)": (
        (SP_WORLD, 1), FSDP_SMALL_ADAMW,
        dict(schedule_sampler="loss-second-moment", ema_decay=0.999)),
    "adafactor factored, clip, parameter scale, momentum (data 4)": (
        (SP_WORLD, 1), {"name": "optax.adafactor", "params": {
            "learning_rate": 1e-2, "min_dim_size_to_factor": 8, "momentum": 0.9,
            "clipping_threshold": 1.0, "multiply_by_parameter_scale": True, "eps": 1e-6}},
        dict(ema_decay=None)),
    "tp (data 2, model 2), adamw, EMA": (
        (2, 2), FSDP_SMALL_ADAMW,
        dict(tp=True, tp_min_size=64, schedule_sampler="loss-second-moment",
             ema_decay=0.999)),
}
FSDP_SMALL_TOL = 1e-5
# 24b fsdp-train-768: the timesteps of the 4 examples (one a rank)
FSDP_T = (417, 52, 803, 250)


def fsdp_rank_small(mesh, device="cuda"):
    """24a on one rank: for each of FSDP_SMALL_CASES, two steps of
    ``make_fsdp_train_fn`` (fp32, the YAML's freeze rules, draws from the
    shared generator) on its mesh of the 4 ranks, then rank 0 runs the same
    two steps unsharded on the whole batch from the same weights and seed:
    the losses, and the largest difference of the gathered parameters and
    EMA from the unsharded ones; the launches and the unit collectives."""
    import torch
    import torch.distributed as dist

    from kandinsky2_tpu_torch.configs import CONFIG_2_1, deep_copy_config
    from kandinsky2_tpu_torch.parallel import fsdp
    from kandinsky2_tpu_torch.parallel.mesh import make_mesh
    from kandinsky2_tpu_torch.train import train_unclip as tu
    from kandinsky2_tpu_torch.train.optim import decoder_freeze_mask, optimizer_from_config

    _sp_rank_setup(torch)
    cfg = deep_copy_config(CONFIG_2_1)
    cfg["model_config"].update(FSDP_TINY)
    mc, dcfg = cfg["model_config"], cfg["diffusion_config"]
    batch, _ = _sp_train_batch(torch, mc, 8, 16, device, 40)
    out = {}
    for name, (shape, optim, kw) in FSDP_SMALL_CASES.items():
        grid = make_mesh(shape[0] * shape[1], model_parallel=shape[1])
        unet = _sp_train_model(torch, cfg, torch.float32, device, seed=41)
        mask = decoder_freeze_mask(unet, freeze_resblocks=True)
        init_fn, train_fn, _ = tu.make_fsdp_train_fn(
            unet, dcfg, optimizer_from_config(optim), grid, min_elems=1 << 10, **kw)
        state = init_fn(mask, seed=0)
        fsdp.reset_collective_counts()
        losses = [float(train_fn(state, batch)["loss"]) for _ in range(2)]
        r = {"losses": losses, "collectives": fsdp.collective_counts(),
             "cut": sum(bool(fsdp.cuts(p)) for p in unet.parameters()),
             "both": sum(len(fsdp.cuts(p)) == 2 for p in unet.parameters())}
        whole = state.state_dict()
        if dist.get_rank() == 0:
            ref = _sp_train_model(torch, cfg, torch.float32, device, seed=41)
            init_u, step_u = tu.make_unclip_train_step(
                ref, dcfg, optimizer_from_config(optim),
                **{k: v for k, v in kw.items() if k not in ("tp", "tp_min_size")})
            st = init_u(mask, seed=0)
            r["ref_losses"] = [float(step_u(st, batch)["loss"]) for _ in range(2)]
            want = st.state_dict()
            for key in ("params", "ema"):
                if want[key] is not None:
                    r[f"{key}_max_diff"] = max(
                        float((whole[key][n].to(device) - w).abs().max())
                        for n, w in want[key].items())
            del ref, st, want
        out[name] = r
        del unet, state, whole
        gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def fsdp_rank_train768(mesh, steps: int, device="cuda", config=None, res=768):
    """24b fsdp-train-768 on one rank: CONFIG_2_1's UNet (``config`` for a
    rehearsal) with train-adamw-768's settings (fp32 parameters, bf16
    compute, the YAML's freeze rules, ``optax.adamw`` 1e-4, EMA 0.9999) and
    remat, latents [4, res/8, res/8, 4], ``fsdp=4``.  Rank 0 first runs the
    same step unsharded (``accum_steps=4``, one example a microbatch) with
    the same t and noise, keeps its loss, launches and updated trainable
    parameters, and puts the trainable parameters back.  Then every rank
    takes the FSDP step (its gathers, reduce-scatters and uncut all-reduces
    timed, synchronized), rank 0 gathers the trainable parameters and
    compares, and ``steps`` timed steps follow: seconds, launches, the
    state's bytes at rest, peak memory, frozen slices' digests."""
    import torch
    import torch.distributed as dist

    from kandinsky2_tpu_torch.configs import CONFIG_2_1
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel import fsdp
    from kandinsky2_tpu_torch.parallel.mesh import make_mesh
    from kandinsky2_tpu_torch.train import train_unclip as tu
    from kandinsky2_tpu_torch.train.optim import decoder_freeze_mask, optimizer_from_config

    _sp_rank_setup(torch)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    grid = make_mesh(SP_WORLD, model_parallel=1)
    rank = grid.axis("data").index
    cfg = config or CONFIG_2_1
    dcfg = cfg["diffusion_config"]
    t0 = time.perf_counter()
    unet = _sp_train_model(torch, cfg, torch.bfloat16, device)
    batch, noise = _sp_train_batch(torch, cfg["model_config"], SP_WORLD, res // 8, device, 23)
    t_inj = torch.tensor(FSDP_T[:SP_WORLD], device=device)
    mask = decoder_freeze_mask(unet, freeze_resblocks=True, freeze_attention=False)
    sync()
    out = {"rank": rank, "build_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in unet.parameters()),
           "n_trainable": sum(p.numel() for n, p in unet.named_parameters() if mask[n])}
    if rank == 0:
        start = {n: p.detach().clone() for n, p in unet.named_parameters() if mask[n]}
        init_u, step_u = tu.make_unclip_train_step(
            unet, dcfg, optimizer_from_config(ADAMW), ema_decay=0.9999, remat=True,
            accum_steps=SP_WORLD)
        st = init_u(mask, seed=0)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_path_counts()
        t0 = time.perf_counter()
        out["ref_loss"] = float(step_u(st, batch, t_inj, noise)["loss"])
        sync()
        out["ref_s"] = time.perf_counter() - t0
        out["ref_launches"] = launch_counts()
        out["ref_state_bytes"] = fsdp.state_bytes(st)
        out["unsharded_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0
        ref = {n: p.detach().to("cpu", torch.float32, copy=True)
               for n, p in unet.named_parameters() if mask[n]}
        with torch.no_grad():
            for n, p in unet.named_parameters():
                if mask[n]:
                    p.copy_(start[n])
        start = {n: v.float().cpu() for n, v in start.items()}
        del st, init_u, step_u
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    init_fn, train_fn, _ = tu.make_fsdp_train_fn(
        unet, dcfg, optimizer_from_config(ADAMW), grid, ema_decay=0.9999, remat=True)
    state = init_fn(mask, seed=0)
    frozen = [p for n, p in unet.named_parameters() if not mask[n]]
    frozen0 = _tensor_digests(torch, frozen)
    secs = {"all_gather": 0.0, "reduce_scatter": 0.0, "uncut all-reduce": 0.0}
    inner = {"all_gather": fsdp._gather_flat, "reduce_scatter": fsdp._reduce_scatter_flat,
             "uncut all-reduce": fsdp.pmean_grads}

    def timed(key):
        def call(*args, **kwargs):
            sync()
            t = time.perf_counter()
            result = inner[key](*args, **kwargs)
            sync()
            secs[key] += time.perf_counter() - t
            return result
        return call

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fsdp._gather_flat, fsdp._reduce_scatter_flat = timed("all_gather"), timed("reduce_scatter")
    fsdp.pmean_grads = timed("uncut all-reduce")
    try:
        fsdp.reset_collective_counts()
        reset_path_counts()
        t0 = time.perf_counter()
        out["loss"] = float(train_fn(state, batch, t_inj, noise)["loss"])
        sync()
        out["checked_s"] = time.perf_counter() - t0
    finally:
        fsdp._gather_flat, fsdp._reduce_scatter_flat = inner["all_gather"], inner["reduce_scatter"]
        fsdp.pmean_grads = inner["uncut all-reduce"]
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    out["collectives"] = fsdp.collective_counts()
    out["collective_s"] = secs
    out["state_bytes"] = fsdp.state_bytes(state)
    out["frozen_same"] = _tensor_digests(torch, frozen) == frozen0
    trained = [(n, p) for n, p in unet.named_parameters() if mask[n]]
    got = fsdp._gather_whole([(p.detach(), fsdp.cuts(p)) for _, p in trained], rank == 0)
    if rank == 0:
        num = den = upd = upd_den = 0.0
        for (n, _), g in zip(trained, got):
            g = g.float()
            num += float((g - ref[n]).double().norm() ** 2)
            den += float(ref[n].double().norm() ** 2)
            upd_den += float((ref[n] - start[n]).double().norm() ** 2)
        out["params_rel_l2"] = math.sqrt(num / den)
        out["update_rel_l2"] = math.sqrt(num / upd_den)
        out["finite"] = all(bool(torch.isfinite(g).all()) for g in got)
        del ref, start
    del got
    out["steps"] = []
    for _ in range(steps):
        reset_path_counts()
        t0 = time.perf_counter()
        loss = float(train_fn(state, batch, t_inj, noise)["loss"])
        sync()
        out["steps"].append(dict(seconds=time.perf_counter() - t0, loss=loss,
                                 launches=launch_counts()))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0
    del unet, state, init_fn, train_fn, batch, noise, frozen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def phase_fsdp(torch, smi: str, t_script: float, gloo) -> dict:
    """24: ZeRO-3 (FSDP) training on phase 21's pool of 4 gloo ranks sharing
    the card: 24a the small width in fp32 against unsharded; 24b
    fsdp-train-768.  Returns 24b's launches on rank 0 (the checked step)."""
    t_phase = time.perf_counter()
    # 24a
    res = gloo.run(fsdp_rank_small, timeout=300)
    for name, r in res[0].items():
        diffs = {k: r[k] for k in ("params_max_diff", "ema_max_diff") if k in r}
        print(f"fsdp 24a {name}: losses {r['losses']} against unsharded "
              f"{r['ref_losses']}; max |sharded - unsharded| {json.dumps(diffs)} (tol "
              f"{FSDP_SMALL_TOL}); {r['cut']} tensors cut ({r['both']} on two axes); "
              f"unit collectives in the two steps {json.dumps(r['collectives'])}")
        check(all(abs(a - b) <= FSDP_SMALL_TOL * max(1.0, abs(b))
                  for a, b in zip(r["losses"], r["ref_losses"])), f"24a {name}: losses")
        check(diffs and all(v <= FSDP_SMALL_TOL for v in diffs.values()), f"24a {name}")
        check(r["cut"] > 0 and (r["both"] > 0) == ("tp" in name), f"24a {name}: cuts")
    print(f"time: phase 24a {time.perf_counter() - t_phase:.1f} s")

    # 24b
    t0 = time.perf_counter()
    steps = 1 if t0 - t_script <= LATE_CUT_AT_S else 0
    print(f"fsdp-train-768: {steps} timed step(s) after the checked one (none where the "
          f"script passes {LATE_CUT_AT_S} s here; {t0 - t_script:.1f} s so far); the card's "
          f"memory in use: {smi_memory()}")
    res = gloo.run(fsdp_rank_train768, steps, timeout=900)
    r0 = res[0]
    loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    ref_per_example = {k: v / SP_WORLD for k, v in r0["ref_launches"].items()}
    print(f"fsdp-train-768: UNet {r0['n_params']} parameters ({r0['n_trainable']} "
          f"trainable) built in {max(r['build_s'] for r in res):.2f} s a rank; unsharded "
          f"step on rank 0 (accum 4, remat) {r0['ref_s']:.3f} s, peak "
          f"{r0['unsharded_peak_gib']:.2f} GiB, loss {r0['ref_loss']:.6f}, launches "
          f"{json.dumps(r0['ref_launches'])}, state {json.dumps(r0['ref_state_bytes'])} B; "
          f"FSDP loss {r0['loss']:.6f}, rel err {loss_err:.3e} (tol {SP_TRAIN_LOSS_TOL}); "
          f"gathered trainable parameters rel_l2 {r0['params_rel_l2']:.3e} (tol "
          f"{SP_TRAIN_GRAD_TOL}), their update's rel_l2 {r0['update_rel_l2']:.3e} (tol "
          f"{SP_TRAIN_GRAD_TOL})")
    check(loss_err <= SP_TRAIN_LOSS_TOL, "fsdp-train-768: the sharded loss")
    check(r0["params_rel_l2"] <= SP_TRAIN_GRAD_TOL and r0["finite"],
          "fsdp-train-768: the gathered parameters")
    check(r0["update_rel_l2"] <= SP_TRAIN_GRAD_TOL, "fsdp-train-768: the update")
    check(ref_per_example == SP_TRAIN_LAUNCHES,
          f"fsdp-train-768: the unsharded step's launches {r0['ref_launches']}")
    for i, r in enumerate(res):
        check(r["frozen_same"], f"fsdp-train-768 rank {i}: a frozen slice changed")
        check(r["launches"] == SP_TRAIN_LAUNCHES and r["plain_on_card"] == 0,
              f"fsdp-train-768 rank {i}: launches {r['launches']}, plain route "
              f"{r['plain_on_card']}")
        for s in r["steps"]:
            check(s["launches"] == SP_TRAIN_LAUNCHES and math.isfinite(s["loss"]),
                  f"fsdp-train-768 rank {i}: a timed step's launches or loss")
        print(f"fsdp-train-768 rank {i}: checked step {r['checked_s']:.3f} s, of it "
              + ", ".join(f"{k} {v:.3f} s" for k, v in r["collective_s"].items())
              + f" ({json.dumps(r['collectives'])} unit collectives); timed steps "
              + ", ".join(f"{s['seconds']:.3f} s" for s in r["steps"])
              + f"; state at rest {json.dumps(r['state_bytes'])} B; peak "
              f"{r['peak_gib']:.2f} GiB; launches a step {json.dumps(r['launches'])}")
    timed = [max(r["steps"][i]["seconds"] for r in res) for i in range(len(r0["steps"]))]
    step_s = sum(timed) / len(timed) if timed else max(r["checked_s"] for r in res)
    print(f"fsdp-train-768: {step_s:.4f} s/step (the slowest rank, "
          + (f"mean of {len(timed)} timed" if timed else "the checked step, collectives "
             "synchronized") + f"); the checked step's gathers "
          f"{max(r['collective_s']['all_gather'] for r in res):.3f} s and reduce-scatters "
          f"{max(r['collective_s']['reduce_scatter'] for r in res):.3f} s (slowest rank), "
          f"{r0['collectives']['all_gather']} and {r0['collectives']['reduce_scatter']} a "
          f"step; 768², 4 examples, one a rank, fsdp {SP_WORLD} sharing the card over gloo, "
          f"fp32 parameters, bf16 compute, optax.adamw 1e-4, EMA 0.9999, remat; per rank "
          f"at rest parameters / EMA / optimizer " + ", ".join(
              f"{r['state_bytes']['params']} / {r['state_bytes']['ema']} / "
              f"{r['state_bytes']['optimizer']} B" for r in res)
          + f" (unsharded {json.dumps(r0['ref_state_bytes'])} B); peak per rank "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in res) + f" GiB; {smi}")
    print(f"time: phase 24b {time.perf_counter() - t0:.1f} s")
    return r0["launches"]


# --- phase 22: row-sharded 2.2 and 2.0 inference and sharded LoRA -------------

# sp22-768: phase 10's 2.2 text2img row-sharded 4-way with the decoder at 10
# DDPM steps; sp20-512: phase 12's 2.0 text2img at DDIM 10 (eta 0.05,
# guidance 7); the step counts are the only cuts (5 where the script's clock
# would otherwise pass SP22_CUT_AT_S at phase 22's start)
SP22 = dict(T2I22, decoder_steps=10)
SP20_STEPS = 10
SP22_CUT_AT_S = 820
# K3 at a rank's shard shapes (B, T, S, H, d), 4 ranks, batch 1 (CFG 2): the
# UNet22's local query rows against the gathered K/V after the 10 image
# tokens at 768², the UNet20's after the 154 text tokens at 512², the
# KL-VAE decoder's mid attention at 512²
SP22_K3_SHAPES = (("sp4 unet22 ds2 shard", (2, 576, 2314, 12, 64)),
                  ("sp4 unet22 ds4 shard", (2, 144, 586, 20, 64)),
                  ("sp4 unet22 ds8/middle shard", (2, 36, 154, 24, 64)),
                  ("sp4 unet20 512^2 ds2 shard", (2, 256, 1178, 12, 64)),
                  ("sp4 unet20 512^2 ds4 shard", (2, 64, 410, 18, 64)),
                  ("sp4 unet20 512^2 ds8/middle shard", (2, 16, 218, 24, 64)),
                  ("sp4 kl-vae 512^2 mid shard", (1, 1024, 4096, 1, 512)))
# K5 and K4 at a rank's shard of sp-lora22-768 (batch 1, no CFG)
SP22_BWD_SHAPES = (("sp4 unet22 ds2 shard", (1, 576, 2314, 12)),
                   ("sp4 unet22 ds4 shard", (1, 144, 586, 20)),
                   ("sp4 unet22 ds8/middle shard", (1, 36, 154, 24)))
# the published UNet22's added-KV attentions at 768²: (level, channels,
# heads, latent rows); cross_attention_dim 768 and 10 image tokens
SP22_ATTN = (("ds2", 768, 12, 48), ("ds4", 1280, 20, 24), ("ds8", 1536, 24, 12))
# sp-lora22-768 a step a rank: phase 14's lora22-768 (a UNet22 forward and
# its backward; the sharded GroupNorm's backward launches no kernel)
SP_LORA22_LAUNCHES = {"group_norm_stats": UNET_LAUNCHES[0],
                      "group_norm_apply": UNET_LAUNCHES[0],
                      "flash_attention_fwd": UNET_LAUNCHES[1],
                      "flash_attention_bwd_dq": UNET_LAUNCHES[1],
                      "flash_attention_bwd_dkv": UNET_LAUNCHES[1]}


def sp_rank_added_kv(mesh):
    """22a on one rank, bf16 on the card: the published UNet22's
    ``AddedKVAttention`` at each 768² level row-sharded (K3 on this rank's
    query rows against the gathered K/V after the 10 image tokens) against
    the unsharded module, CFG batch 2; then at batch 1 its gradients (x and
    every parameter) through the gather (K5 + K4 on the local rows, the
    gather's reduce-scatter) against the unsharded module's; launches
    counted."""
    import torch

    from kandinsky2_tpu_torch.models.unet22 import AddedKVAttention
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel import spatial as sp
    from kandinsky2_tpu_torch.parallel.collectives import all_gather, psum
    from kandinsky2_tpu_torch.pipelines.base import init_random_

    _sp_rank_setup(torch)
    ax = mesh.axis()
    n = ax.size
    g = torch.Generator(device="cuda").manual_seed(22)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").bfloat16()
    out = {"checks": [], "rank": ax.index}
    record = lambda name, err, tol: out["checks"].append((name, err, tol))
    reset_path_counts()
    for label, C, heads, rows in SP22_ATTN:
        attn = AddedKVAttention(C, heads, 768, dtype=torch.bfloat16, device="cuda")
        init_random_(attn, g)
        attn.to(torch.bfloat16)
        x, enc, gy = randn(2, rows, rows, C), randn(2, 10, 768), randn(1, rows, rows, C)
        shape = f"(T {rows * rows // n}, S {10 + rows * rows}, H {heads})"
        # the attention's own output (to_out's), before the residual
        seen = []
        hook = attn.to_out[0].register_forward_hook(lambda mod, a, y: seen.append(y))
        with torch.no_grad():
            attn(x, enc)
            with sp.using_sp_axis(attn, ax):
                attn(sp.shard_rows(x, ax), enc)
        hook.remove()
        whole, got = seen[0], all_gather(seen[1], ax, dim=1)
        record(f"AddedKVAttention {label} {shape} sharded vs unsharded, rel_l2",
               _sp_rel(torch, got, whole), 1e-2)

        def grads(sharded):
            attn.zero_grad(set_to_none=True)
            xi = (sp.shard_rows(x[:1], ax) if sharded else x[:1]).clone().requires_grad_()
            with sp.using_sp_axes(ax if sharded else None, attn):
                y = attn(xi, enc[:1])
            y.backward(sp.shard_rows(gy, ax) if sharded else gy)
            dx = all_gather(xi.grad, ax, dim=1) if sharded else xi.grad
            dp = torch.cat([p.grad.float().reshape(-1) for p in attn.parameters()])
            return dx, psum(dp, ax) if sharded else dp

        (dxw, dpw), (dxs, dps) = grads(False), grads(True)
        record(f"AddedKVAttention {label} {shape} dx sharded vs unsharded", rel_err(dxs, dxw),
               2e-2)
        record(f"AddedKVAttention {label} {shape} d parameters sharded vs unsharded",
               rel_err(dps, dpw), 2e-2)
        del attn, x, enc, gy, whole, got, dxw, dpw, dxs, dps
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    torch.cuda.empty_cache()
    return out


def _sp_build_in_turn(torch, mesh, build):
    """``build()`` on one rank at a time, a barrier after each: a pipeline
    is made with fp32 parameters before its cast to bf16 (the 2.2
    pipeline's 19.8 GB), so four ranks building at once would not fit on
    the card.  Returns (this rank's result, its own seconds)."""
    import torch.distributed as dist

    ax = mesh.axis()
    out, seconds = None, 0.0
    for i in range(ax.size):
        if ax.index == i:
            t0 = time.perf_counter()
            out = build()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            torch.cuda.empty_cache()
        dist.barrier(group=ax.group)
    return out, seconds


def _sp_compare(torch, np, mesh, pipe, call, inject=None):
    """``call(sp_mesh)`` of ``pipe`` unsharded (None) and row-sharded over
    ``mesh``, each after ``set_seed(3)`` and with ``inject(pipe)`` where
    given (undone after): the sharded float image's relative L2 distance
    from the unsharded one."""
    outs = []
    for m in (None, mesh):
        pipe.set_seed(3)
        if inject is not None:
            inject(pipe)
        try:
            outs.append(np.asarray(call(m), np.float64))
        finally:
            for name in ("run_prior", "_decode_loop"):
                pipe.__dict__.pop(name, None)
    whole, got = outs
    check(np.isfinite(got).all() and whole.std() > 1e-3, "sp small: image")
    return float(np.linalg.norm(got - whole) / np.linalg.norm(whole))


def _sp_small22(torch, np, mesh) -> dict:
    """22b's small width in fp32 on the card: every 2.2 entry point at a
    small width (``configs.small_overrides22``, the MoVQ's output conv
    scaled by 0.2 as in phase 9), sharded against unsharded with the same
    injected draws.  Hires runs on a UNet of four levels, so that its 128²
    first stage (16 latent rows) runs whole on every rank, as the row rule
    sends it, and only its 256² stage shards."""
    from PIL import Image

    from kandinsky2_tpu_torch.configs import small_overrides22
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22

    def build(task, levels=2):
        ov = small_overrides22()
        if levels == 4:
            ov["unet"] = dict(ov["unet"], block_out_channels=(64, 64, 64, 64))
        pipe = Kandinsky2_2(task_type=task, tokenizer=stub_tokenizer22(64), overrides=ov,
                            dtype=torch.float32, device="cuda")
        pipe.init_random_params(torch.Generator(device="cuda").manual_seed(7))
        with torch.no_grad():
            pipe.movq.decoder.conv_out.weight.mul_(0.2)
            pipe.movq.decoder.conv_out.bias.mul_(0.2)
        return pipe

    rng = np.random.RandomState(23)
    image = Image.fromarray(rng.randint(0, 256, (128, 128, 3), np.uint8))
    mask = np.zeros((128, 128), np.float32)
    mask[30:90, 20:100] = 1.0
    hint = rng.rand(128, 128, 3).astype(np.float32)
    lat = rng.randn(1, 16, 16, 4).astype(np.float32)
    kw = dict(decoder_steps=4, prior_steps=3, h=128, w=128, output="float")
    cases = {
        "text2img": ("text2img", 2, lambda p, m: p.generate_text2img(PROMPT, sp_mesh=m, **kw)),
        "img2img": ("text2img", 2, lambda p, m: p.generate_img2img(
            PROMPT, image, strength=0.7, sp_mesh=m, **kw)),
        "inpainting": ("inpainting", 2, lambda p, m: p.generate_inpainting(
            PROMPT, image, mask, sp_mesh=m, **kw)),
        "controlnet hint=": ("controlnet", 2, lambda p, m: p.generate_controlnet(
            PROMPT, hint=hint, sp_mesh=m, **kw)),
        "turbo": ("text2img", 2, lambda p, m: p.generate_text2img(
            PROMPT, turbo_interval=2, sp_mesh=m, **kw)),
        "decode_latents": ("text2img", 2, lambda p, m: p.decode_latents(
            lat, output="float", sp_mesh=m)),
        "hires 256^2": ("text2img", 4, lambda p, m: p.generate_text2img_hires(
            PROMPT, strength=0.5, sp_mesh=m, **dict(kw, h=256, w=256))),
    }
    out, pipes = {}, {}
    for name, (task, levels, call) in cases.items():
        if (task, levels) not in pipes:
            pipes[(task, levels)] = build(task, levels)
        pipe = pipes[(task, levels)]
        out[name] = _sp_compare(torch, np, mesh, pipe, lambda m: call(pipe, m),
                                lambda p: inject_noise22(p, 5, np))
    del pipes
    torch.cuda.empty_cache()
    return out


def _sp_full_run(torch, np, mesh, pipe, call, name):
    """The full-width sharded cell on one rank: ``call(None)`` unsharded on
    rank 0 first (its latents kept), then ``call(mesh)`` as a warm-up and a
    timed call (synchronized) with the launches counted; the seconds, peak
    memory, launches, the latents' distance from the unsharded ones and
    the image's checks."""
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel.collectives import all_gather

    ax = mesh.axis()
    seen = _sp_latents(pipe)
    out = {}
    if ax.index == 0:
        ref_img = call(None)
        ref_lat = seen[-1]
    call(mesh)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    t0 = time.perf_counter()
    img = call(mesh)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    lat = all_gather(seen[-1], ax, dim=1)
    if ax.index == 0:
        out["latent_rel_l2"] = _sp_rel(torch, lat, ref_lat)
        out["image"] = (img.shape, bool(np.isfinite(img).all()), float(img.std()),
                        float(np.abs(img - ref_img).max()))
    seen.clear()
    pipe.__dict__.pop("_decode", None)
    return out


def sp_rank_t2i22(mesh, steps: int):
    """22b on one rank: sp22-768, phase 10's full-width 2.2 text2img at
    ``steps`` decoder steps with every draw injected, unsharded on rank 0
    and row-sharded over the ranks (``_sp_full_run``); then the small width
    in fp32 (``_sp_small22``)."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22
    from kandinsky2_tpu_torch.weights.configs22 import pipeline_overrides

    _sp_rank_setup(torch)
    rng = np.random.RandomState(22)
    draw = lambda *shape: rng.randn(*shape).astype(np.float32)
    kw = dict(SP22, decoder_steps=steps, noise=draw(1, 96, 96, 4),
              noise_seq=draw(steps, 1, 96, 96, 4), prior_noise=draw(1, 1280),
              prior_noise_seq=draw(SP22["prior_steps"], 1, 1280))

    def build():
        pipe = Kandinsky2_2(tokenizer=stub_tokenizer22(), dtype=torch.bfloat16,
                            overrides=pipeline_overrides(task_type="text2img"),
                            device="cuda")
        pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
        return pipe

    pipe, build_s = _sp_build_in_turn(torch, mesh, build)
    out = _sp_full_run(torch, np, mesh, pipe,
                       lambda m: pipe.generate_text2img(PROMPT, sp_mesh=m, **kw), "sp22-768")
    out["build_s"] = build_s
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = _sp_small22(torch, np, mesh)
    return out


def _sp_small20(torch, np, mesh) -> dict:
    """22c's small width in fp32 on the card (``configs.small_config20``
    with 64-wide heads, the KL-VAE's output conv scaled by 0.1 as in phase
    11): the p_sampler (its dynamic threshold over the whole image) and
    inpainting at 512² (the p_sampler, ``denoised_type`` its dynamic
    threshold too), sharded against unsharded with every draw injected."""
    from PIL import Image

    from kandinsky2_tpu_torch.configs import small_config20
    from kandinsky2_tpu_torch.pipelines import Kandinsky2
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok, _ = stub_tokenizers(64)
    rng = np.random.RandomState(24)
    draw = lambda *shape: rng.randn(*shape).astype(np.float32)
    image = Image.fromarray(rng.randint(0, 256, (512, 512, 3), np.uint8))
    mask = np.ones((512, 512), np.float32)
    mask[128:384, 128:384] = 0.0
    out = {}
    for task, name, call in (
            ("text2img", "p_sampler", lambda p, m: p.generate_text2img(
                PROMPT, num_steps=4, h=128, w=128, sampler="p_sampler",
                noise=draw(1, 16, 16, 4), noise_seq=draw(4, 1, 16, 16, 4), output="float",
                sp_mesh=m)),
            ("inpainting", "inpainting", lambda p, m: p.generate_inpainting(
                PROMPT, image, mask, num_steps=4, sampler="p_sampler",
                noise=draw(1, 64, 64, 4), noise_seq=draw(4, 1, 64, 64, 4), output="float",
                sp_mesh=m))):
        pipe = Kandinsky2(config=small_config20(64), tokenizer1=tok, tokenizer2=tok,
                          task_type=task, dtype=torch.float32, device="cuda")
        pipe.init_random_params(torch.Generator(device="cuda").manual_seed(8))
        with torch.no_grad():
            pipe.image_encoder.decoder.conv_out.weight.mul_(0.1)
            pipe.image_encoder.decoder.conv_out.bias.mul_(0.1)
        state = rng.get_state()
        outs = []
        for m in (None, mesh):  # the same draws for both calls
            rng.set_state(state)
            pipe.set_seed(3)
            outs.append(np.asarray(call(pipe, m), np.float64))
        whole, got = outs
        check(np.isfinite(got).all() and whole.std() > 1e-3, f"sp20 small {name}: image")
        out[name] = float(np.linalg.norm(got - whole) / np.linalg.norm(whole))
        del pipe
    torch.cuda.empty_cache()
    return out


def sp_rank_t2i20(mesh, steps: int):
    """22c on one rank: sp20-512, phase 12's full-width 2.0 text2img
    (``generate_text2img``'s 512², eta 0.05, guidance 7) at DDIM ``steps``
    with x_T and the DDIM noise injected, unsharded on rank 0 and
    row-sharded over the ranks; then the small width in fp32."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.diffusion.schedules import ddim_ladder
    from kandinsky2_tpu_torch.pipelines import Kandinsky2
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    _sp_rank_setup(torch)
    rng = np.random.RandomState(20)
    lat = T2I20_SIZE // 8
    noise = rng.randn(1, lat, lat, 4).astype(np.float32)
    nseq = rng.randn(len(ddim_ladder(steps)), 1, lat, lat, 4).astype(np.float32)
    tok, _ = stub_tokenizers()

    def build():
        pipe = Kandinsky2(tokenizer1=tok, tokenizer2=tok, dtype=torch.bfloat16,
                          device="cuda")
        pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
        return pipe

    pipe, build_s = _sp_build_in_turn(torch, mesh, build)
    out = _sp_full_run(torch, np, mesh, pipe, lambda m: pipe.generate_text2img(
        PROMPT, noise=noise, noise_seq=nseq, sp_mesh=m, **dict(T2I20, num_steps=steps)),
        "sp20-512")
    out["build_s"] = build_s
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = _sp_small20(torch, np, mesh)
    return out


def _sp_lora_small(torch, np) -> dict:
    """22d's small width: the small UNet22 (``configs.small_overrides22``)
    in fp32 on a (data 2, sp 2) mesh, two ``torch.optim.SGD`` steps of
    ``make_sp_lora_train_fn`` at batch 2 with injected t and noise, against
    the same two steps of the unsharded ``make_lora_train_step``: the
    factors' relative L2 distance and their digests (for the ranks'
    bitwise agreement)."""
    from kandinsky2_tpu_torch.configs import small_overrides22
    from kandinsky2_tpu_torch.models.lora import init_lora
    from kandinsky2_tpu_torch.models.unet22 import UNet22
    from kandinsky2_tpu_torch.parallel.mesh import Mesh
    from kandinsky2_tpu_torch.pipelines.base import init_random_
    from kandinsky2_tpu_torch.train import train_lora as tl

    grid = Mesh(None, ("data", "sp"), shape=(2, 2))
    unet = UNet22(**small_overrides22()["unet"], device="cuda")
    init_random_(unet, torch.Generator(device="cuda").manual_seed(30))
    g = torch.Generator(device="cuda").manual_seed(31)
    loras = init_lora(unet, g, rank=4)
    for f in loras.values():
        f["up"] = 0.05 * torch.randn(f["up"].shape, generator=g, device="cuda")
    x0 = 0.5 * torch.randn((2, 16, 16, 4), generator=g, device="cuda")
    cond = torch.randn((2, unet.encoder_hid_dim), generator=g, device="cuda")
    draws = [(torch.randint(0, 1000, (2,), generator=g, device="cuda"),
              torch.randn((2, 16, 16, 4), generator=g, device="cuda")) for _ in range(2)]
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.05)
    acp = acp_decoder22(np)
    init_state, train_fn = tl.make_sp_lora_train_fn(tl.unet22_eps_fn(unet), unet, acp,
                                                    sgd, grid)
    state = init_state(loras)
    losses = [float(train_fn(state, x0, cond, t, n)["loss"]) for t, n in draws]
    whole = tl.init_lora_train_state(loras, sgd)
    step = tl.make_lora_train_step(tl.unet22_eps_fn(unet), unet, acp)
    losses_w = [float(step(whole, x0, cond, t, n)["loss"]) for t, n in draws]
    cat = lambda st: torch.cat([v.detach().reshape(-1).double() for v in st.params.values()])
    a, b = cat(state), cat(whole)
    return {"rel_l2": ((a - b).norm() / b.norm()).item(), "losses": (losses, losses_w),
            "digests": _tensor_digests(torch, state.params.values())}


def sp_rank_lora22(mesh, steps: int):
    """22d sp-lora22-768 on one rank: phase 14's lora22-768 (the published
    UNet22 with a bf16 base, rank-4 factors on ``default_target`` with
    ``up`` drawn non-zero so that every factor has a gradient, Adam 1e-4,
    latents [1, 96, 96, 4]) through ``make_sp_lora_train_fn`` on a (data 1,
    sp 4) mesh.  Rank 0 first takes the same step unsharded with the same
    injected t and noise (its loss and factor gradients kept); then every
    rank the sharded warm-up step with those draws (its gradients kept on
    rank 0) and ``steps`` timed ones drawing their own (synchronized):
    seconds, the gradient all-reduce's seconds, launches, the factors'
    digests after every step, the base's before and after, peak memory.
    Then the small width (``_sp_lora_small``)."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.models.lora import init_lora
    from kandinsky2_tpu_torch.models.unet22 import UNet22
    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel.mesh import Mesh
    from kandinsky2_tpu_torch.pipelines.base import init_random_
    from kandinsky2_tpu_torch.pipelines.kandinsky2_2 import Kandinsky2_2
    from kandinsky2_tpu_torch.train import train_lora as tl
    from kandinsky2_tpu_torch.weights.configs22 import pipeline_overrides

    _sp_rank_setup(torch)
    grid = Mesh(None, ("data", "sp"), shape=(1, SP_WORLD))
    rank = grid.axis("sp").index
    t0 = time.perf_counter()
    unet = UNet22(**pipeline_overrides(task_type="text2img")["unet"], dtype=torch.bfloat16,
                  device="cuda")
    init_random_(unet, torch.Generator(device="cuda").manual_seed(20),
                 Kandinsky2_2.residual_outputs)
    unet.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(21)
    x0 = torch.randn((1, 96, 96, 4), generator=g, device="cuda") * 0.5
    cond = torch.randn((1, unet.encoder_hid_dim), generator=g, device="cuda")
    t_inj = torch.tensor([417], device="cuda")
    noise = torch.randn((1, 96, 96, 4), generator=g, device="cuda")
    loras = init_lora(unet, torch.Generator(device="cuda").manual_seed(22), rank=4)
    for f in loras.values():
        f["up"] = 0.01 * torch.randn(f["up"].shape, generator=g, device="cuda")
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-4)
    acp = acp_decoder22(np)
    eps_fn = tl.unet22_eps_fn(unet)
    torch.cuda.synchronize()
    out = {"rank": rank, "build_s": time.perf_counter() - t0}
    base0 = _tensor_digests(torch, unet.parameters())

    def keep_grads(state):
        kept = {}
        hook = state.optimizer.register_step_pre_hook(lambda opt, a, kw: kept.update(
            {n: p.grad.float().cpu() for n, p in state.params.items()}))
        return hook, kept

    if rank == 0:
        ref = tl.init_lora_train_state(loras, adam)
        hook, kept = keep_grads(ref)
        out["ref_loss"] = float(tl.make_lora_train_step(eps_fn, unet, acp)(
            ref, x0, cond, t_inj, noise)["loss"])
        hook.remove()
        out["ref_grads"] = kept
        del ref
        torch.cuda.empty_cache()
    init_state, train_fn = tl.make_sp_lora_train_fn(eps_fn, unet, acp, adam, grid)
    state = init_state(loras)
    hook, kept = keep_grads(state)
    inner, reduce_s = tl.pmean_grads, []

    def timed_pmean(params, axis, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(params, axis, *args, **kwargs)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t)

    tl.pmean_grads = timed_pmean
    digests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_path_counts()
        t0 = time.perf_counter()
        out["loss"] = float(train_fn(state, x0, cond, t_inj, noise)["loss"])
        torch.cuda.synchronize()
        out["warm_s"] = time.perf_counter() - t0
        out["warm_launches"] = launch_counts()
        hook.remove()
        out["grads"] = kept if rank == 0 else None
        digests.append(_tensor_digests(torch, state.params.values()))
        out["steps"] = []
        for _ in range(steps):
            reduce_s.clear()
            reset_path_counts()
            t0 = time.perf_counter()
            loss = float(train_fn(state, x0, cond)["loss"])
            torch.cuda.synchronize()
            out["steps"].append(dict(seconds=time.perf_counter() - t0,
                                     reduce_s=sum(reduce_s), loss=loss,
                                     launches=launch_counts(),
                                     plain_on_card=qkv_attention.plain_on_card))
            digests.append(_tensor_digests(torch, state.params.values()))
    finally:
        tl.pmean_grads = inner
    out["digests"] = digests
    out["same_base"] = _tensor_digests(torch, unet.parameters()) == base0
    out["n_factors"] = sum(v.numel() for v in state.params.values())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del unet, state, init_state, train_fn, loras
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = _sp_lora_small(torch, np)
    return out


def _sp22_full_report(name, res, steps, decoder, smi, unsharded_note):
    """Print and check a full-width sharded cell's results (every rank's)."""
    r0 = res[0]
    shape, finite, std, diff = r0["image"]
    print(f"{name}: built the full pipeline on each rank in turn, "
          f"{max(r['build_s'] for r in res):.2f} s at most; image {shape} finite {finite} "
          f"std {std:.4f}, max |sharded - unsharded| {diff:.4e}; latents rel_l2 "
          f"{r0['latent_rel_l2']:.4e} (tol {SP21_LATENT_TOL})")
    check(finite and std > 0, f"{name} image")
    check(r0["latent_rel_l2"] <= SP21_LATENT_TOL, f"{name} latents")
    for i, r in enumerate(res):
        check_full_launches(f"{name} rank {i}", r["launches"], steps, encoded=False,
                            decoder=decoder)
        check(r["plain_on_card"] == 0, f"{name} rank {i}: attention missed K3")
    sec = max(r["seconds"] for r in res)
    print(f"{name}: {sec:.4f} s/image on {SP_WORLD} ranks sharing the card; peak memory "
          f"per rank " + ", ".join(f"{r['peak_gib']:.2f}" for r in res)
          + f" GiB ({unsharded_note}); {smi}")
    for case, rel in r0["small"].items():
        print(f"{name} small fp32 {case}: sharded vs unsharded rel_l2 {rel:.4e} "
              f"(tol {SP_FP32_TOL})")
        check(rel <= SP_FP32_TOL, f"{name} small fp32 {case}")
    return res[0]["launches"], sec


def phase_sp22(torch, smi: str, t_script: float, gloo):
    """22: row-sharded 2.2 and 2.0 inference and sharded LoRA tuning of the
    UNet22 on ``gloo``, 4 gloo ranks sharing the card (every run under a
    deadline).  22a K3, K5 and K4 timed at the new shard shapes in
    this process and the sharded ``AddedKVAttention`` and its gradient on
    the ranks; 22b sp22-768; 22c sp20-512; 22d sp-lora22-768.  Returns
    ({cell: launches of rank 0}, the timed rows)."""
    import torch.nn.functional as F

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cut = t_phase - t_script > SP22_CUT_AT_S
    tight = t_phase - t_script > TIGHT_AT_S
    steps = 2 if tight else 5 if cut else SP22["decoder_steps"]
    lora_steps = 1 if cut else 3
    print(f"phase 22: {t_phase - t_script:.1f} s into the script; sp22-768 and sp20-512 at "
          f"{steps} decoder steps, sp-lora22-768 {lora_steps} timed step(s) (5 and 1 past "
          f"{SP22_CUT_AT_S} s, 2 decoder steps past {TIGHT_AT_S} s); the card's memory in "
          f"use: {smi_memory()}")
    launches = {}
    # 22a
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = {"flash_attention_fwd": _k3_rows(torch, F, g, SP22_K3_SHAPES)}
    rows.update(_sp_backward_rows(torch, F, SP22_BWD_SHAPES, seed=24))
    torch.cuda.empty_cache()
    for r in gloo.run(sp_rank_added_kv, timeout=300):
        for what, err, tol in r["checks"]:
            print(f"sp 22a rank {r['rank']}: {what}: {err:.3e} (tol {tol:.3e})")
            check(err <= tol, f"22a rank {r['rank']}: {what}")
        print(f"sp 22a rank {r['rank']}: launches {json.dumps(r['launches'])}, "
              f"attention calls on the card by the plain route {r['plain_on_card']}")
        check(all(v > 0 for v in r["launches"].values()),
              "22a: a kernel was not launched")
        check(r["plain_on_card"] == 0, "22a: an attention missed the kernels")
    print(f"time: phase 22a {time.perf_counter() - t_phase:.1f} s")

    # 22b
    t0 = time.perf_counter()
    res = gloo.run(sp_rank_t2i22, steps, timeout=480)
    launches["sp22"], _ = _sp22_full_report(
        "sp22-768", res, steps, DECODER_LAUNCHES, smi,
        f"768^2, prior 25, decoder DDPM {steps}, CFG 4 and 4, bf16; phase 10, "
        "unsharded: 10.46 GiB")
    print(f"time: phase 22b {time.perf_counter() - t0:.1f} s")

    # 22c
    t0 = time.perf_counter()
    res = gloo.run(sp_rank_t2i20, steps, timeout=480)
    launches["sp20"], _ = _sp22_full_report(
        "sp20-512", res, steps, KL_DECODER_LAUNCHES, smi,
        f"512^2, DDIM {steps} at eta 0.05, guidance 7, bf16")
    print(f"time: phase 22c {time.perf_counter() - t0:.1f} s")

    # 22d
    t0 = time.perf_counter()
    res = gloo.run(sp_rank_lora22, lora_steps, timeout=480)
    r0 = res[0]
    loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    names = sorted(r0["ref_grads"])
    a = torch.cat([r0["grads"][n].reshape(-1).double() for n in names])
    b = torch.cat([r0["ref_grads"][n].reshape(-1).double() for n in names])
    grad_err = ((a - b).norm() / b.norm()).item()
    print(f"sp-lora22-768: UNet22 and {r0['n_factors']} factor values built in "
          f"{max(r['build_s'] for r in res):.2f} s a rank; the unsharded step on rank 0: "
          f"loss {r0['ref_loss']:.6f}; the sharded warm-up step "
          f"{max(r['warm_s'] for r in res):.3f} s, loss {r0['loss']:.6f}, rel err "
          f"{loss_err:.3e} (tol {SP_TRAIN_LOSS_TOL}); the factors' gradients rel_l2 "
          f"{grad_err:.3e} (tol {SP_TRAIN_GRAD_TOL})")
    check(loss_err <= SP_TRAIN_LOSS_TOL, "sp-lora22-768: the sharded loss")
    check(grad_err <= SP_TRAIN_GRAD_TOL, "sp-lora22-768: the factors' gradients")
    for i, r in enumerate(res):
        check(r["digests"] == r0["digests"],
              f"sp-lora22-768: rank {i}'s factors differ from rank 0's")
        check(r["same_base"], f"sp-lora22-768 rank {i}: the base changed")
        check(r["warm_launches"] == SP_LORA22_LAUNCHES,
              f"sp-lora22-768 rank {i}: warm-up launches {r['warm_launches']}")
        for s in r["steps"]:
            check(s["launches"] == SP_LORA22_LAUNCHES and s["plain_on_card"] == 0,
                  f"sp-lora22-768 rank {i}: launches {s['launches']}, plain route "
                  f"{s['plain_on_card']}")
            check(math.isfinite(s["loss"]), f"sp-lora22-768 rank {i}: loss not finite")
        print(f"sp-lora22-768 rank {i}: steps " + ", ".join(
            f"{s['seconds']:.3f} s (all-reduce {s['reduce_s']:.4f} s, loss "
            f"{s['loss']:.5f})" for s in r["steps"]) + f"; peak {r['peak_gib']:.2f} GiB;"
            f" launches a step {json.dumps(r['steps'][-1]['launches'])}")
    n = len(r0["steps"])
    step_s = sum(max(r["steps"][i]["seconds"] for r in res) for i in range(n)) / n
    red_s = sum(max(r["steps"][i]["reduce_s"] for r in res) for i in range(n)) / n
    print(f"sp-lora22-768: {step_s:.4f} s/step (the slowest rank, mean of {n}), the "
          f"factors' all-reduce {red_s:.4f} s of it; 768², batch 1, mesh (data 1, sp "
          f"{SP_WORLD}) sharing the card over gloo, bf16 base, rank-4 factors, Adam "
          f"1e-4; the factors bitwise equal across the ranks after every step, the "
          f"base unchanged; peak per rank " + ", ".join(
              f"{r['peak_gib']:.2f}" for r in res)
          + f" GiB (lora22-768 unsharded: 6.14 GiB); {smi}")
    small = r0["small"]
    print(f"sp-lora22 small fp32 (data 2, sp 2): losses {small['losses'][0]} against "
          f"unsharded {small['losses'][1]}; factors rel_l2 {small['rel_l2']:.3e} "
          f"(tol 1e-5)")
    check(small["rel_l2"] <= 1e-5, "sp-lora22 small fp32: factors")
    check(all(r["small"]["digests"] == small["digests"] for r in res),
          "sp-lora22 small fp32: factors differ across the ranks")
    launches["sp_lora22"] = r0["steps"][-1]["launches"]
    print(f"time: phase 22d {time.perf_counter() - t0:.1f} s")
    return launches, rows


# --- phase 23: tensor-parallel inference ----------------------------------------

# tp21-768: phase 5's 2.1 text2img (768², prior 25, CFG 4, bf16, batch 1) at
# DDIM 10, sp21-768's depth cut, with every weight that the rule takes
# (min_size 1024) sharded over the model axis of a (data 1, model 4) mesh of
# the 4 ranks; 23a the small width in fp32 at model-parallel 4 and on
# (data 2, model 2), min_size 64
TP_MESHES = ((1, 4), (2, 2))
TP_MIN_SIZE, TP_SMALL_MIN_SIZE = 1024, 64


def _tp_small_pipes(torch):
    """23a's small pipelines in fp32 on the card, each a fresh one from
    seed 0: (build(version), call(version, pipe)), ``call`` text2img at
    128² (DDIM 4, or 2.2's 2 decoder steps; 2 prior steps), after
    ``set_seed(3)`` (every draw from the pipeline's own generator)."""
    from kandinsky2_tpu_torch.configs import small_config, small_config20, small_overrides22
    from kandinsky2_tpu_torch.pipelines import Kandinsky2, Kandinsky2_1, Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22, stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    tok20, _ = stub_tokenizers(64)
    f32 = dict(dtype=torch.float32, device="cuda")
    builds = {
        "2.1": lambda: Kandinsky2_1(config=small_config(head_channels=64), tokenizer1=tok1,
                                    tokenizer2=tok2, **f32),
        "2.2": lambda: Kandinsky2_2(tokenizer=stub_tokenizer22(64),
                                    overrides=small_overrides22(), **f32),
        "2.0": lambda: Kandinsky2(config=small_config20(64), tokenizer1=tok20,
                                  tokenizer2=tok20, **f32),
    }
    calls = {
        "2.1": lambda p: p.generate_text2img(PROMPT, num_steps=4, guidance_scale=4, h=128,
                                             w=128, prior_steps="2", output="float"),
        "2.2": lambda p: p.generate_text2img(PROMPT, decoder_steps=2, prior_steps=2, h=128,
                                             w=128, output="float"),
        "2.0": lambda p: p.generate_text2img(PROMPT, num_steps=4, h=128, w=128,
                                             output="float"),
    }

    def build(version):
        pipe = builds[version]()
        pipe.init_random_params(torch.Generator(device="cuda").manual_seed(0))
        return pipe

    def call(version, pipe):
        pipe.set_seed(3)
        return calls[version](pipe)

    return build, call


def tp_rank_small(mesh):
    """23a on one rank: text2img of the small 2.1, 2.2 and 2.0 pipelines in
    fp32, unsharded and after ``shard(min_size=64)`` on each mesh of
    ``TP_MESHES`` (a fresh pipeline each): {case: sharded against
    unsharded relative L2, the sharded images' largest difference from
    rank 0's}."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.parallel.collectives import all_gather
    from kandinsky2_tpu_torch.parallel.mesh import make_mesh

    _sp_rank_setup(torch)
    build, call = _tp_small_pipes(torch)
    out = {}
    with torch.no_grad():
        for version in ("2.1", "2.2", "2.0"):
            whole = np.asarray(call(version, build(version)), np.float64)
            check(np.isfinite(whole).all() and whole.std() > 1e-3, f"23a {version} image")
            for data, model in TP_MESHES:
                pipe = build(version)
                grid = make_mesh(model_parallel=model)
                pipe.shard(grid, min_size=TP_SMALL_MIN_SIZE, verbose=False)
                got = np.asarray(call(version, pipe), np.float64)
                every = all_gather(torch.from_numpy(got).cuda()[None], mesh.axis(), dim=0)
                out[f"{version} (data {data}, model {model})"] = (
                    float(np.linalg.norm(got - whole) / np.linalg.norm(whole)),
                    float((every - every[:1]).abs().max()))
                del pipe
            torch.cuda.empty_cache()
    return out


def _tp_call_counts(pipe) -> dict:
    """The sharded layers' collectives in each UNet call and each prior
    call of ``pipe``, and each call's host seconds (the collectives wait
    for the card, so these are the call's own): {"unet": [...], "prior":
    [...], "unet_s": [...], "prior_s": [...]}, appended as the calls run."""
    from kandinsky2_tpu_torch.parallel import tensor_parallel as tp

    calls = {"unet": [], "prior": [], "unet_s": [], "prior_s": []}

    def total():
        return sum(tp.collective_counts().values())

    inner = pipe.unet.denoise

    def denoise(*args, **kw):
        n, t0 = total(), time.perf_counter()
        out = inner(*args, **kw)
        calls["unet_s"].append(time.perf_counter() - t0)
        calls["unet"].append(total() - n)
        return out

    pipe.unet.denoise = denoise
    start = []
    pipe.prior.register_forward_pre_hook(
        lambda mod, args: start.append((total(), time.perf_counter())))

    def after(mod, args, y):
        n, t0 = start.pop()
        calls["prior_s"].append(time.perf_counter() - t0)
        calls["prior"].append(total() - n)

    pipe.prior.register_forward_hook(after)
    return calls


def tp_rank_t2i21(mesh, steps: int, prior_steps: int = 25):
    """23b on one rank: tp21-768.  The full-width 2.1 pipeline (bf16, seed
    0, as 20b's), unsharded on rank 0 first with the noise injected (its
    latents and launches kept), then ``shard(model_parallel=4,
    min_size=1024)`` on every rank and the same call sharded, a warm-up and
    a timed call: seconds, peak memory, the weights this rank holds,
    launches, the collectives by UNet call, prior call and image, the
    coverage report, the latents against the unsharded ones and against
    every other rank's."""
    import numpy as np
    import torch

    from kandinsky2_tpu_torch.ops import launch_counts, qkv_attention
    from kandinsky2_tpu_torch.parallel import tensor_parallel as tp
    from kandinsky2_tpu_torch.parallel.collectives import all_gather
    from kandinsky2_tpu_torch.parallel.mesh import make_mesh

    _sp_rank_setup(torch)
    ax = mesh.axis()
    rng = np.random.RandomState(20)
    kw = dict(SP21, num_steps=steps, noise=rng.randn(1, 96, 96, 4).astype(np.float32),
              prior_noise=rng.randn(1, 768).astype(np.float32),
              prior_noise_seq=rng.randn(25, 1, 768).astype(np.float32)[:prior_steps],
              prior_steps=str(prior_steps))
    t0 = time.perf_counter()
    pipe = _sp_pipe(torch)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    seen = _sp_latents(pipe)
    nbytes = lambda: sum(p.numel() * p.element_size() for m in pipe.models().values()
                         for p in m.parameters())
    out["weights_gib_unsharded"] = nbytes() / 2**30
    # warm-ups at 2 decoder and 2 prior steps: the same shapes, a fifth of the
    # work (the sharded call is the collectives' to the last)
    warm = dict(kw, num_steps=2, prior_steps="2", prior_noise_seq=kw["prior_noise_seq"][:2])
    if ax.index == 0:
        pipe.generate_text2img(PROMPT, **warm)
        reset_path_counts()
        ref_img = pipe.generate_text2img(PROMPT, **kw)
        out["unsharded_launches"] = launch_counts()
        ref_lat = seen[-1]
    grid = make_mesh(model_parallel=ax.size)
    t0 = time.perf_counter()
    pipe.shard(grid, min_size=TP_MIN_SIZE, verbose=ax.index == 0)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    rep = pipe.sharding_report
    out["report"] = dict(summary=rep.summary(), fallbacks=list(rep.fallbacks),
                         candidate_frac=rep.candidate_frac, sharded_frac=rep.sharded_frac)
    out["weights_gib"] = nbytes() / 2**30
    calls = _tp_call_counts(pipe)
    pipe.generate_text2img(PROMPT, **warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    tp.reset_collective_counts()
    for v in calls.values():
        v.clear()
    t0 = time.perf_counter()
    img = pipe.generate_text2img(PROMPT, **kw)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["plain_on_card"] = qkv_attention.plain_on_card
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["collectives"] = tp.collective_counts()
    out["calls"] = {k: list(v) for k, v in calls.items()}
    every = all_gather(seen[-1][None].contiguous(), ax, dim=0)
    out["ranks_max_diff"] = float((every.float() - every[:1].float()).abs().max())
    if ax.index == 0:
        out["latent_rel_l2"] = _sp_rel(torch, seen[-1], ref_lat)
        out["image"] = (img.shape, bool(np.isfinite(img).all()), float(img.std()),
                        float(np.abs(img - ref_img).max()))
    del pipe, seen, every
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp(torch, smi: str, steps: int, prior_steps: int, gloo) -> dict:
    """23: tensor-parallel inference on ``gloo``, 4 gloo ranks sharing the
    card (every run under a deadline): 23a the small width in fp32, 23b
    tp21-768 at DDIM ``steps`` and ``prior_steps``.  Returns tp21-768's
    launches on rank 0."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 23: tp21-768 at DDIM {steps}, prior {prior_steps}; the card's memory in "
          f"use: {smi_memory()}")
    # 23a
    res = gloo.run(tp_rank_small, timeout=300)
    for case, (rel, spread) in res[0].items():
        print(f"tp 23a small fp32 {case}: sharded vs unsharded rel_l2 {rel:.4e} (tol "
              f"{SP_FP32_TOL}); the ranks' images differ by at most "
              f"{max(r[case][1] for r in res):.3e}")
        check(rel <= SP_FP32_TOL, f"23a {case}")
        check(all(r[case][1] == 0.0 for r in res), f"23a {case}: the ranks differ")
    print(f"time: phase 23a {time.perf_counter() - t_phase:.1f} s")

    # 23b
    t0 = time.perf_counter()
    res = gloo.run(tp_rank_t2i21, steps, prior_steps, timeout=600)
    r0 = res[0]
    rep = r0["report"]
    shape, finite, std, diff = r0["image"]
    print(f"tp21-768: built the full pipeline on each rank in "
          f"{max(r['build_s'] for r in res):.2f} s, sharded it in "
          f"{max(r['shard_s'] for r in res):.2f} s; shard(): {rep['summary']}; "
          f"fallbacks {rep['fallbacks'][:8]}")
    check(not rep["fallbacks"] and rep["candidate_frac"] >= 0.9, "tp21-768: coverage")
    print(f"tp21-768: image {shape} finite {finite} std {std:.4f}, max |sharded - "
          f"unsharded| {diff:.4e}; latents rel_l2 {r0['latent_rel_l2']:.4e} (tol "
          f"{SP21_LATENT_TOL}); the ranks' latents differ by at most "
          f"{max(r['ranks_max_diff'] for r in res):.3e}")
    check(finite and std > 0 and shape == (1, 768, 768, 3), "tp21-768 image")
    check(r0["latent_rel_l2"] <= SP21_LATENT_TOL, "tp21-768 latents")
    check_full_launches("tp21-768 rank 0 unsharded", r0["unsharded_launches"], steps,
                        encoded=False)
    for i, r in enumerate(res):
        check_full_launches(f"tp21-768 rank {i}", r["launches"], steps, encoded=False)
        check(r["launches"] == r0["unsharded_launches"],
              f"tp21-768 rank {i}: launches differ from the unsharded call's")
        check(r["plain_on_card"] == 0, f"tp21-768 rank {i}: attention missed K3")
        check(r["ranks_max_diff"] == 0.0, f"tp21-768 rank {i}: latents differ")
    unet, prior = r0["calls"]["unet"], r0["calls"]["prior"]
    print(f"tp21-768: collectives an image {json.dumps(r0['collectives'])}; "
          f"{sorted(set(unet))} a UNet call ({len(unet)} calls), "
          f"{sorted(set(prior))} a prior call ({len(prior)} calls), "
          f"{sum(r0['collectives'].values()) - sum(unet) - sum(prior)} in the text "
          f"encoders, the CLIP towers and the MoVQ; host seconds in the UNet calls "
          f"{sum(r0['calls']['unet_s']):.3f}, in the prior calls "
          f"{sum(r0['calls']['prior_s']):.3f}")
    sec = max(r["seconds"] for r in res)
    print(f"tp21-768: {sec:.4f} s/image on {SP_WORLD} ranks sharing the card (768^2, "
          f"DDIM {steps}, prior {prior_steps}, CFG 4, bf16, mesh (data 1, model "
          f"{SP_WORLD})); "
          f"weights per rank " + ", ".join(f"{r['weights_gib']:.2f}" for r in res)
          + f" GiB of {r0['weights_gib_unsharded']:.2f}; peak memory per rank "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in res)
          + f" GiB (phase 5, unsharded: 7.37 GiB); {smi}")
    print(f"time: phase 23b {time.perf_counter() - t0:.1f} s")
    return r0["launches"]


def phase_clock():
    """A function that prints the seconds since its last call (the phase
    just run) and since the first, under a label."""
    start = last = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"time: {label} {now - last:.1f} s ({now - start:.1f} s in all)")
        last = now

    return lap


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    try:
        from kandinsky2_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the kandinsky2_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    # 1. device
    t_script = time.perf_counter()
    lap = phase_clock()
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.build(*(_build.CSRC_DIR / src for src in CUDA_SOURCES))
    for src in CUDA_SOURCES:
        _build.load_library(src)
    nvcc_s = time.perf_counter() - t0
    for src in CUDA_SOURCES:
        report = _build.PTXAS_REPORTS.get(src, "(built before this run)")
        lines = [ln.strip() for ln in report.splitlines()
                 if any(w in ln for w in ("Compiling entry", "Used", "spill", "wgmma"))]
        print(f"build: ptxas {src}: " + " | ".join(lines))
    print(f"build: nvcc {' + '.join(CUDA_SOURCES)} in parallel {nvcc_s:.2f} s")
    lap("phases 1-2")

    # 3. forward kernels against their plain versions
    results = {name: [] for name in ("group_norm_stats", "group_norm_apply",
                                     "flash_attention_fwd", "flash_attention_bwd_dkv",
                                     "flash_attention_bwd_dq")}
    phase_kernels(torch, results)
    lap("phase 3")

    # 4. the small path against the CPU
    phase_reference(torch, np)
    torch.cuda.empty_cache()
    lap("phase 4")

    # 4b. every 2.1 entry point at a small width against the CPU
    phase_tasks_small(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 4b")

    # 5. the full-size slice
    counts, seconds, pipe = phase_slice(torch, np, smi)
    lap("phase 5")

    # 5b. full-width img2img on the slice's pipeline
    tasks = {"img2img": phase_img2img_full(torch, np, smi, pipe)}
    lap("phase 5b img2img")

    # 15. serve21-768 on the slice's pipeline
    server, serve_counts, serve_rps, serve_s = phase_serve21(torch, np, smi, pipe)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15")

    # 17. http-validate21-768: phase 15's server over HTTP, then validation
    # with the pipeline's weights re-drawn (so after every other use of it)
    validate_counts = phase_http_validate21(torch, np, smi, pipe, server)
    del server
    lap("phase 17")

    # 18b. phase 5's pipeline through the reference's 2.1 files
    ckpt21 = phase_checkpoints21(torch, np, smi, pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 18b")

    # 5b. inpainting on its own pipeline
    gc.collect()
    torch.cuda.empty_cache()
    tasks["inpainting"] = phase_inpainting_full(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 5b inpainting")

    # 6. backward kernels against their plain versions
    phase_kernels_backward(torch, results)
    lap("phase 6")

    # 7. small training runs
    phase_train_small(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 7")

    # 8. full-width decoder training steps
    train_counts, step_s = phase_train_full(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 8")

    # 9. every 2.2 entry point at a small width against the CPU
    phase_tasks22_small(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 9")

    # 10. full-width 2.2 text2img
    t2i22_counts, t2i22_s, pipe22 = phase_t2i22(torch, np, smi)
    lap("phase 10")

    # 16. lora-swap22-768 on phase 10's pipeline
    lora_counts, swap_ms = phase_lora_swap22(torch, np, smi, pipe22)
    lap("phase 16")

    # 18a. phase 10's pipeline through a diffusers snapshot cache
    ckpt = {"ckpt22": phase_checkpoints22(torch, np, smi, pipe22)}
    del pipe22
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 18a")

    # 11. every 2.0 entry point at a small width against the CPU
    phase_tasks20_small(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 11")

    # 12. full-width 2.0 text2img, this slice's main path, then img2img and
    # inpainting
    t2i20_counts, t2i20_s, tasks20 = phase_t2i20(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 12")

    # 13. LoRA, distillation, the prior step and the inpainting decoder step
    # at a small width against the CPU
    phase_train_new_small(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 13")

    # 14. the same trainers at full width: lora22-768 and distill22-768,
    # prior-train, inpaint-train-768
    new_train = phase_train22_full(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    new_train["prior_train"] = phase_prior_train_full(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    new_train["inpaint_train"] = phase_train_full(torch, np, smi, "inpaint-train-768",
                                                  "inpainting")
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 14")

    # 18c-d. the 2.0 files at a small width; DPT-Large, the small hybrid and
    # a ControlNet call on a DPT hint
    ckpt["ckpt21"] = ckpt21
    ckpt["ckpt20"] = phase_checkpoints20(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    dpt = phase_dpt(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 18c-d")

    # 19. the optimizers on the card against the CPU; decoder training at
    # full width with optax.adamw and the prior CLI with it; every example
    phase_optimizers(torch, np)
    lap("phase 19a")
    adamw_train = {"train_adamw_768": phase_train_full(
        torch, np, smi, "train-adamw-768", optim_params=ADAMW, state_bytes_per_param=8)}
    gc.collect()
    torch.cuda.empty_cache()
    adamw_train["prior_train_adamw"] = phase_prior_train_full(
        torch, np, smi, "prior-train-adamw", optim_params=ADAMW)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 19b")
    example_s = phase_examples(torch)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 19c")

    # 20-24: the parallel phases, every one on the same pool of 4 gloo
    # ranks sharing the card (started once: a start cost up to 25 s) and 20a and
    # 21a on 1 NCCL rank too.  The ranks' allocators grow their segments in
    # place (less fragmentation where four ranks fill the card at 4096²);
    # this process's is set already
    from kandinsky2_tpu_torch.parallel.launch import RankPool

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    gloo = RankPool(SP_WORLD, "gloo", device="cuda", init_timeout=300)
    nccl = RankPool(1, "nccl", device="cuda", init_timeout=300)
    gloo.start()
    nccl.start()
    try:
        # 20. spatial parallelism: the primitives, sp21-768 and highres-sp;
        # 20b at DDIM 5 where the script would otherwise pass LATE_CUT_AT_S
        # (phase 20 takes about a minute at DDIM 10)
        sp_steps = (SP21["num_steps"] if time.perf_counter() - t_script + 60 <= LATE_CUT_AT_S
                    else 5)
        sp21_counts, highres_counts, sp_rows = phase_spatial(torch, smi, sp_steps, gloo,
                                                             nccl)
        lap("phase 20")

        # 23. tensor-parallel inference: the small width and tp21-768 at
        # sp21-768's depth, its prior at 5 steps past TIGHT_AT_S (before 21
        # and 22, whose depth follows the script's clock)
        prior_steps = 25 if time.perf_counter() - t_script <= TIGHT_AT_S else 5
        tp21_counts = phase_tp(torch, smi, sp_steps, prior_steps, gloo)
        lap("phase 23")

        # 21. row-sharded training: the backward primitives, the small width
        # and sp-train-768; 24. ZeRO-3 (FSDP) training, the small width and
        # fsdp-train-768
        sp_train_counts, sp_bwd_rows = phase_sp_train(torch, smi, t_script, gloo, nccl)
        nccl.close()
        lap("phase 21")
        fsdp_counts = phase_fsdp(torch, smi, t_script, gloo)
        lap("phase 24")

        # 22. row-sharded 2.2 and 2.0 inference and sharded LoRA tuning of the
        # UNet22
        sp22_counts, sp22_rows = phase_sp22(torch, smi, t_script, gloo)
        lap("phase 22")
    finally:
        gloo.close()
        nccl.close()

    meta = {
        "group_norm_stats": ("cuda", "kandinsky2_tpu_torch/csrc/group_norm.cu",
                             "kandinsky2_tpu/ops/group_norm.py:86"),
        "group_norm_apply": ("cuda", "kandinsky2_tpu_torch/csrc/group_norm.cu",
                             "kandinsky2_tpu/ops/group_norm.py:119"),
        "flash_attention_fwd": ("cuda", "kandinsky2_tpu_torch/csrc/flash_attention.cu",
                                "kandinsky2_tpu/ops/flash_attention.py:172"),
        "flash_attention_bwd_dkv": ("cuda", "kandinsky2_tpu_torch/csrc/flash_attention.cu",
                                    "kandinsky2_tpu/ops/flash_attention.py:74"),
        "flash_attention_bwd_dq": ("cuda", "kandinsky2_tpu_torch/csrc/flash_attention.cu",
                                   "kandinsky2_tpu/ops/flash_attention.py:122"),
    }
    kernels = []
    for name, rows in results.items():
        route, source, replaces = meta[name]
        # the heaviest shape of the batch-1 paths
        main_row = max((r for r in rows if not r["label"].startswith("batch ")),
                       key=lambda r: r["plain_ms"])
        # the forward kernels' main path is the slice (phase 5), the backward
        # kernels' the full-width train steps (phase 8)
        launches = train_counts[name] if name.startswith("flash_attention_bwd") \
            else counts[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "train_launches": train_counts[name],
            **{f"{task}_launches": tasks[task][0][name] for task in tasks},
            "t2i22_launches": t2i22_counts[name],
            "t20_launches": t2i20_counts[name],
            **{f"{task}_launches": tasks20[task][0][name] for task in tasks20},
            **{f"{path}_launches": new_train[path][0][name] for path in new_train},
            **{f"{path}_launches": adamw_train[path][0][name] for path in adamw_train},
            "serve21_9_requests_launches": serve_counts[name],
            "lora_swap22_5_requests_launches": lora_counts[name],
            "validate21_launches": validate_counts[name],
            **{f"{path}_launches": ckpt[path][0][name] for path in ckpt},
            "dpt_large_launches": dpt["large"][0][name],
            "dpt_hybrid_small_launches": dpt["hybrid"][0][name],
            "controlnet_dpt_hint_launches": dpt["controlnet"][name],
            "sp21_launches": sp21_counts[name],
            "highres_sp_launches": highres_counts[name],
            "sp_train_launches": sp_train_counts[name],
            "fsdp_train_launches": fsdp_counts[name],
            **{f"{cell}_launches": sp22_counts[cell][name] for cell in sp22_counts},
            "tp21_launches": tp21_counts[name],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "timed_shape": f"{main_row['label']} {main_row['shape']}",
            "sp_timed": [{k: r[k] for k in ("label", "shape", "ms", "plain_ms",
                                            "library_ms", "bound_ms", "bound_by")}
                         for r in sp_rows.get(name, []) + sp_bwd_rows.get(name, [])
                         + sp22_rows.get(name, [])],
        })
    print(f"slice: {seconds:.4f} s/image; " + "; ".join(
        f"{task}: {sec:.4f} s/image" for task, (_, sec) in tasks.items())
        + f"; train: {step_s:.4f} s/step; 2.2 text2img: {t2i22_s:.4f} s/image"
        + f"; 2.0 text2img: {t2i20_s:.4f} s/image; " + "; ".join(
            f"{task}: {sec:.4f} s/image" for task, (_, sec) in tasks20.items())
        + "; " + "; ".join(f"{path}: {sec:.4f} s/step"
                           for path, (_, sec) in new_train.items())
        + "; serve21: " + ", ".join(f"bucket {b} {sec:.4f} s/image"
                                    for b, sec in serve_s.items())
        + f", {serve_rps:.4f} requests/s; lora22 swap {swap_ms:.2f} ms; " + "; ".join(
            f"{path}: {io['bytes']} bytes written in {io['write_s']:.3f} s, loaded in "
            f"{io['load_s']:.3f} s ({io['bytes'] / io['load_s'] / 1e9:.3f} GB/s)"
            for path, (_, io) in ckpt.items())
        + f"; dpt-large bf16 {dpt['large'][1]:.3f} ms an estimate (rel_l2 "
          f"{dpt['large'][2]:.4e} from fp32); " + "; ".join(
            f"{path}: {sec:.4f} s/step" for path, (_, sec) in adamw_train.items())
        + f"; examples --small: {sum(example_s.values()):.2f} s for {len(example_s)}")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
