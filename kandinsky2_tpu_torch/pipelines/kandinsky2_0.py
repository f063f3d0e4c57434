"""Kandinsky 2.0 inference in PyTorch, the counterpart of
``kandinsky2_tpu/pipelines/kandinsky2_0.py``: ``generate_text2img``,
``generate_img2img``, ``generate_inpainting`` (the reference's signatures,
with ``dynamic_threshold_v``, ``denoised_type`` and ``ddim_eta``),
``generate_img`` and ``decode_latents``.

The multilingual release: two text streams, mCLIP-XLMR (its pooled 640-d
projection and its 1024-d tokens) and an mT5 encoder (512-d tokens), a
GLIDE-style UNet whose cross-attention takes both token sets (77 + 77),
and a KL-VAE latent space (scale 0.0512).  Each call runs eagerly: both
text towers on [prompt] * B + [""] * B -> UNet conditioning -> the
sampler's loop over the CFG-doubled UNet (p_sampler, DDIM with ``eta``,
PLMS, DPM++ 2M and its Karras grid) -> KL-VAE decode.  Public arguments
and outputs keep the JAX package's layouts: ``noise`` [B, h/8, w/8, 4]
NHWC, ``noise_seq`` [S, B, h/8, w/8, 4] (the p_sampler, or DDIM with
eta > 0), images NHWC.  Whatever is not injected is drawn from
``generator``, or from the pipeline's own (``set_seed``).  Every image
entry point takes ``output="float"`` for the float NHWC images in [-1, 1]
(a numpy array) instead of PIL images.  Profiler ranges:
``k20.text_encoder1``, ``k20.text_encoder2``, ``k20.vae_encode``,
``k20.unet_<sampler>`` and ``k20.vae_decode``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..configs import CONFIG_2_0, create_model, deep_copy_config
from ..diffusion import dynamic_threshold, make_schedule, q_sample
from ..diffusion.schedules import ddim_ladder
from ..models.movq import AutoencoderKL
from ..models.t5 import T5Encoder
from ..models.text_encoders import TextEncoder
from ..utils import (
    as_prompt_list,
    check_noise,
    get_new_h_w,
    prepare_image,
    prepare_mask,
    resolve_batch,
)
from .base import Pipeline, cfg_mix, check_sampler, decoder_schedule, sample_latents


class Kandinsky2(Pipeline):
    """Dual text encoders (XLM-R + MultilingualCLIP, mT5) + KL-VAE +
    GLIDE-style UNet (kandinsky2_model.py:18-104), on ``device`` (the card
    by default)."""

    def __init__(self, config: Optional[dict] = None, tokenizer1=None,
                 tokenizer2=None, task_type: str = "text2img", dtype=torch.bfloat16,
                 seed: int = 0, device="cuda"):
        self.config = deep_copy_config(config or CONFIG_2_0)
        self.task_type = task_type
        self.dtype = dtype
        self.device = torch.device(device)
        mc = self.config["model_config"]
        mc["version"] = "2.0"
        if task_type in ("text2img", "img2img"):
            mc["inpainting"] = False
        elif task_type == "inpainting":
            mc["inpainting"] = True
        else:
            raise ValueError("Only text2img, img2img and inpainting is available")
        kw = dict(dtype=dtype, device=device)
        te1 = self.config["text_enc_params1"]
        te1_extra = {k: te1[k] for k in ("layers", "heads", "intermediate", "vocab_size",
                                         "max_positions", "in_features", "out_features")
                     if k in te1}
        te1_extra.setdefault("in_features", 1024)
        te1_extra.setdefault("out_features", 640)
        self.text_encoder1 = TextEncoder(model_name="multiclip", **te1_extra, **kw)
        self.text_encoder2 = T5Encoder(**self.config.get("t5_params", {}), **kw)
        self.unet = create_model(**mc, **kw)
        ie = self.config["image_enc_params"]
        dd = ie["params"]["ddconfig"]
        self.scale = ie["scale"]
        self.image_encoder = AutoencoderKL(
            z_channels=dd["z_channels"], embed_dim=ie["params"]["embed_dim"],
            ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
            num_res_blocks=dd["num_res_blocks"],
            attn_resolutions=tuple(dd["attn_resolutions"]), resolution=dd["resolution"],
            in_channels=dd.get("in_channels", 3), out_ch=dd.get("out_ch", 3), **kw)
        self.tokenizer1 = tokenizer1
        self.tokenizer2 = tokenizer2
        self._seed = seed
        self._diff_cfg = self.config["diffusion_config"]
        # img2img re-noises on the default linear(1e-4, 2e-2) schedule
        # (utils.py:42-47); 2.0's decoder schedule happens to be the same
        self._img2img_sched = make_schedule(steps=1000, noise_schedule="linear",
                                            device=device)

    def models(self) -> dict:
        """The four models under the names of the JAX pipeline's params."""
        return {"text_encoder1": self.text_encoder1, "text_encoder2": self.text_encoder2,
                "unet": self.unet, "image_encoder": self.image_encoder}

    def encode_text(self, prompt, batch_size: int):
        """(full1, pooled1, full2) of [prompt] * B + [""] * B
        (kandinsky2_model.py:86-102, 133-144): the XLM-R stream at
        min(77, max_positions - 2) tokens, the mT5 stream at 77."""
        prompts = as_prompt_list(prompt, batch_size) + [""] * batch_size
        enc1 = self.tokenizer1(
            prompts, max_length=min(77, self.text_encoder1.max_positions - 2),
            padding="max_length", truncation=True, return_attention_mask=True,
            add_special_tokens=True, return_tensors="np")
        enc2 = self.tokenizer2(
            prompts, max_length=77, padding="max_length", truncation=True,
            return_attention_mask=True, add_special_tokens=True, return_tensors="np")
        ids = lambda enc: (
            torch.as_tensor(enc["input_ids"], dtype=torch.long, device=self.device),
            torch.as_tensor(enc["attention_mask"], device=self.device))
        with record_function("k20.text_encoder1"):
            full1, pooled1 = self.text_encoder1(*ids(enc1))
        with record_function("k20.text_encoder2"):
            full2 = self.text_encoder2(*ids(enc2))
        return full1, pooled1, full2

    # ------------------------------------------------------------------
    # the decoder: sampler loop over the UNet, then KL-VAE decode
    # ------------------------------------------------------------------

    def _sample_images(self, full1, pooled1, full2, x_T, *, sampler, num_steps,
                       guidance_scale, init_step, inpaint_image, inpaint_mask,
                       ddim_eta, denoised_type, dynamic_threshold_v, noise_seq,
                       generator):
        """``_build_gen_fn`` of the JAX pipeline: UNet conditioning once, the
        sampler's loop over the CFG-doubled UNet, KL-VAE decode of
        latents / scale.  Returns the float images [B, H8, W8, 3] in fp32.
        The p_sampler clips x0 with the dynamic threshold; inpainting
        thresholds (``denoised_type``) and blends x0 with the known latent
        there first.  The other samplers use neither, as in the
        reference."""
        inpainting = self.task_type == "inpainting"
        with record_function("k20.unet_" + sampler.removesuffix("_sampler")):
            B = x_T.shape[0]
            unet = self.unet
            xf_proj, xf_out = unet.encode_conditioning(full1, pooled1, full2, None)
            extra = ()
            if inpainting:
                extra = (torch.cat([inpaint_image, inpaint_image]),
                         torch.cat([inpaint_mask, inpaint_mask]))

            def model_fn(x, t_model):
                out = unet.denoise(torch.cat([x, x]), torch.cat([t_model, t_model]),
                                   xf_proj, xf_out, *extra)
                return cfg_mix(out, B, 4, guidance_scale, sampler == "p_sampler")

            denoised_fn = None
            if inpainting:
                def denoised_fn(x0):
                    if denoised_type == "clip_denoised":
                        x0 = torch.clamp(x0, -1, 1)
                    elif denoised_type == "dynamic_threshold":
                        x0 = dynamic_threshold(x0, dynamic_threshold_v)
                    return x0 * (1 - inpaint_mask) + inpaint_image * inpaint_mask

            samples = sample_latents(
                model_fn, x_T, sampler=sampler, diff_cfg=self._diff_cfg,
                num_steps=num_steps, init_step=init_step, generator=generator,
                eta=ddim_eta, denoised_fn=denoised_fn, noise_seq=noise_seq)
        return self._decode(samples)

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        with record_function("k20.vae_decode"):
            return self.image_encoder.decode((latents / self.scale).to(self.dtype)).float()

    @torch.inference_mode()
    def generate_img(
        self, prompt, batch_size=1, num_steps=50, guidance_scale=7, progress=True,
        dynamic_threshold_v=99.5, denoised_type="dynamic_threshold", init_step=None,
        noise=None, init_img=None, img_mask=None, h=512, w=512,
        sampler="ddim_sampler", ddim_eta=0.8, noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """kandinsky2_model.py:104-250.  ``noise`` is the starting latent x_T
        [B, h/8, w/8, 4]; ``noise_seq`` the per-step noise of the stochastic
        samplers (the p_sampler, or DDIM with eta > 0): S = ``init_step``
        (or ``num_steps``) draws for the p_sampler, whose ``init_step`` is
        in respaced units, and one per entry of the (possibly truncated)
        DDIM ladder, whose ``init_step`` is in 1000-step units.
        ``init_img`` and ``img_mask`` are the inpainting latent and mask.
        ``progress`` is accepted for the reference's signature."""
        check_sampler(sampler)
        stochastic = sampler == "p_sampler" or (
            sampler == "ddim_sampler" and ddim_eta != 0.0)
        if noise_seq is not None and not stochastic:
            raise ValueError(
                "noise_seq only applies to the stochastic samplers (p_sampler, or "
                f"ddim_sampler with eta > 0); {sampler} here is deterministic given "
                "noise=")
        batch_size = resolve_batch(prompt, batch_size)
        dev = self.device
        generator = self._gen(generator)
        new_h, new_w = get_new_h_w(h, w)
        full1, pooled1, full2 = self.encode_text(prompt, batch_size)
        x_T = check_noise(noise, (batch_size, new_h, new_w, 4), "noise", dev)
        if x_T is None:
            x_T = torch.randn((batch_size, new_h, new_w, 4), generator=generator,
                              device=dev)
        if sampler == "p_sampler":
            n_anc = num_steps if init_step is None else init_step
        else:
            n_anc = len(ddim_ladder(num_steps, init_step=init_step))
        nseq = check_noise(noise_seq, (n_anc,) + tuple(x_T.shape), "noise_seq", dev)
        as_dev = lambda a, like: like if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=dev)
        images = self._sample_images(
            full1, pooled1, full2, x_T, sampler=sampler, num_steps=num_steps,
            guidance_scale=guidance_scale, init_step=init_step,
            inpaint_image=as_dev(init_img, torch.zeros_like(x_T)),
            inpaint_mask=as_dev(img_mask, torch.zeros_like(x_T[..., :1])),
            ddim_eta=ddim_eta, denoised_type=denoised_type,
            dynamic_threshold_v=dynamic_threshold_v, noise_seq=nseq,
            generator=generator)
        return self._output(images, output, h, w)

    @torch.inference_mode()
    def generate_text2img(
        self, prompt, num_steps=100, batch_size=1, guidance_scale=7, progress=True,
        dynamic_threshold_v=99.5, denoised_type="dynamic_threshold", h=512, w=512,
        sampler="ddim_sampler", ddim_eta=0.05, noise=None, noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """kandinsky2_model.py:252-285: ``generate_img`` with the reference's
        text2img defaults (100 steps, stochastic DDIM at eta 0.05)."""
        return self.generate_img(
            prompt=prompt, batch_size=batch_size, num_steps=num_steps,
            guidance_scale=guidance_scale, dynamic_threshold_v=dynamic_threshold_v,
            denoised_type=denoised_type, h=h, w=w, sampler=sampler, ddim_eta=ddim_eta,
            noise=noise, noise_seq=noise_seq, generator=generator, output=output)

    def _vae_encode_sample(self, image, generator=None) -> torch.Tensor:
        """A draw from the KL posterior of NHWC images in [-1, 1], fp32 (not
        yet scaled); the noise from ``generator``."""
        with record_function("k20.vae_encode"):
            x = torch.as_tensor(image, device=self.device).to(self.dtype)
            f = 2 ** (len(self.image_encoder.encoder.down) - 1)
            B, H, W, _ = x.shape
            noise = torch.randn(
                (B, H // f, W // f, self.image_encoder.post_quant_conv.in_features),
                generator=self._gen(generator), device=self.device)
            return self.image_encoder.sample_posterior(x, noise).float()

    @torch.inference_mode()
    def generate_img2img(
        self, prompt, pil_img, strength=0.7, num_steps=100, guidance_scale=7,
        progress=True, dynamic_threshold_v=99.5, denoised_type="dynamic_threshold",
        sampler="ddim_sampler", ddim_eta=0.05, noise=None, noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """kandinsky2_model.py:287-331 (batch 1, 512²): the init image's KL
        latent re-noised on the default linear schedule to the step
        ``strength`` gives, then the ladder from there.  For the p_sampler
        that step is in respaced units and the re-noising t its
        ``timestep_map`` entry; otherwise t = 1000 (1 - strength) - 1.
        ``noise`` replaces the re-noising draw."""
        generator = self._gen(generator)
        latent = self._vae_encode_sample(prepare_image(pil_img), generator) * self.scale
        if sampler == "p_sampler":
            sched = decoder_schedule(self._diff_cfg, sampler, num_steps)[1]
            start_step = int(sched.num_timesteps * (1 - strength))
            t_noise = int(sched.timestep_map[start_step - 1])
        else:
            start_step = int(1000 * (1 - strength))
            t_noise = start_step - 1
        renoise = check_noise(noise, tuple(latent.shape), "noise", self.device)
        if renoise is None:
            renoise = torch.randn(latent.shape, generator=generator, device=self.device)
        latent = q_sample(
            self._img2img_sched, latent,
            torch.full((latent.shape[0],), t_noise, dtype=torch.int64,
                       device=self.device), renoise)
        return self.generate_img(
            prompt=prompt, batch_size=1, num_steps=num_steps,
            guidance_scale=guidance_scale, dynamic_threshold_v=dynamic_threshold_v,
            denoised_type=denoised_type, noise=latent, init_step=start_step,
            sampler=sampler, ddim_eta=ddim_eta, noise_seq=noise_seq,
            generator=generator, output=output)

    @torch.inference_mode()
    def generate_inpainting(
        self, prompt, pil_img, img_mask, num_steps=100, guidance_scale=7,
        progress=True, dynamic_threshold_v=99.5, denoised_type="dynamic_threshold",
        sampler="ddim_sampler", ddim_eta=0.05, noise=None, noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """kandinsky2_model.py:333-381 (batch 1, 512²): the init image's KL
        latent and the mask (1 = keep, at any size) resized nearest to the
        latent grid by index arithmetic and eroded, as the inpainting
        UNet's extra inputs and the p_sampler's blend.  ``noise`` and
        ``noise_seq`` as in ``generate_img``."""
        generator = self._gen(generator)
        latent = self._vae_encode_sample(prepare_image(pil_img), generator) * self.scale
        lh, lw = latent.shape[1:3]
        mask = np.asarray(img_mask, np.float32)
        yi = (np.arange(lh) * (mask.shape[0] / lh)).astype(np.int32)
        xi = (np.arange(lw) * (mask.shape[1] / lw)).astype(np.int32)
        mask = prepare_mask(mask[yi][:, xi])[None, :, :, None]
        return self.generate_img(
            prompt=prompt, batch_size=1, num_steps=num_steps,
            guidance_scale=guidance_scale, dynamic_threshold_v=dynamic_threshold_v,
            denoised_type=denoised_type, init_img=latent, img_mask=mask,
            sampler=sampler, ddim_eta=ddim_eta, noise=noise, noise_seq=noise_seq,
            generator=generator, output=output)

    @torch.inference_mode()
    def decode_latents(self, latents, output="pil"):
        """KL-VAE-decode raw sampler latents [B, h/8, w/8, 4] to images."""
        images = self._decode(torch.as_tensor(latents, dtype=torch.float32,
                                              device=self.device))
        return self._output(images, output)


def get_kandinsky2_0(device="cuda", task_type="text2img", cache_dir="/tmp/kandinsky2",
                     use_auth_token=None, dtype=None, tokenizers=None):
    """The 2.0 pipeline from the cached checkpoints (kandinsky2/__init__.py:
    12-87); ``tokenizers`` is (XLM-R tokenizer, mT5 tokenizer)."""
    from ..weights.hub import fetch_2_0
    from ..weights.load_kandinsky import build_kandinsky20

    tok1, tok2 = tokenizers or (None, None)
    paths = fetch_2_0(cache_dir, task_type, use_auth_token)
    return build_kandinsky20(paths, task_type=task_type, dtype=dtype, tokenizer1=tok1,
                             tokenizer2=tok2, device=device)
