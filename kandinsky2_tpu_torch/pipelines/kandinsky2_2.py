"""Kandinsky 2.2 inference in PyTorch, the counterpart of
``kandinsky2_tpu/pipelines/kandinsky2_2.py``: ``generate_text2img``,
``generate_img2img``, ``generate_text2img_hires``, ``mix_images``,
``generate_inpainting``, ``generate_controlnet`` (its hint given, or
made from ``image`` by ``depth.make_hint``),
``run_prior`` and ``run_prior_emb2emb``, and ``decode_latents``.

Each call runs eagerly: CLIP-bigG text tower -> guided prior (the UnCLIP
scheduler's ancestral ladder: sample prediction, fixed_small_log variance,
clip ±10; or DPM-Solver++(2M)) -> ViT-bigG on the zero image for the
negative embedding (or a second prior run for a negative decoder prompt)
-> UNet22 conditioning -> the decoder's loop over the CFG-doubled UNet
(the DDPM scheduler: epsilon prediction, learned_range variance, clip ±2;
or DPM-Solver++(2M) on the uniform or Karras grid) -> MoVQ decode.  CFG
batches are [negative; positive], the variance taken from the positive
half.  Public arguments and outputs keep the JAX package's layouts:
``noise`` [B, h/8, w/8, 4] NHWC, ``noise_seq`` [S, B, h/8, w/8, 4], prior
noise [B, 1280] and [S, B, 1280], images NHWC.  Whatever is not injected
is drawn from ``generator``, or from the pipeline's own (``set_seed``),
never from torch's global one.  Every image entry point takes
``output="float"`` for the float NHWC images in [-1, 1] (a numpy array)
instead of PIL images.  Profiler ranges: ``k22.clip_text``, ``k22.prior``,
``k22.clip_vision``, ``k22.movq_encode``, ``k22.unet_<sampler>`` and
``k22.movq_decode``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..depth import make_hint
from ..diffusion import dpmpp_2m_loop, make_dpmpp_karras_tables, make_dpmpp_tables
from ..diffusion.paired import ddpm_ladder, paired_ancestral_loop, unclip_ladder
from ..diffusion.schedules import named_betas
from ..models.movq import MOVQ
from ..models.prior22 import HFCLIPText, PriorTransformer22
from ..models.text_encoders import HFCLIPVision
from ..models.unet22 import UNet22, deep_cache_spec22
from ..utils import (
    as_prompt_list,
    check_noise,
    prepare_image_batch,
    process_images,
    resolve_batch,
)
from .base import Pipeline
from .kandinsky2_1 import clip_preprocess

TASKS = ("text2img", "img2img", "inpainting", "controlnet")
DECODER_SAMPLERS = ("ddpm", "dpmpp", "dpmpp_karras")


def get_new_h_w_64(h: int, w: int) -> tuple[int, int]:
    """64-pixel alignment (kandinsky2_2_model.py:46-53)."""
    return ((h + 63) // 64) * 64, ((w + 63) // 64) * 64


def _acp(*betas_args) -> np.ndarray:
    """A base schedule's alphas_cumprod, rounded to fp32 as the JAX pipeline
    keeps it."""
    return np.cumprod(1.0 - named_betas(*betas_args)).astype(np.float32)


def _prior_check(sampler: str, noise_seq) -> None:
    if sampler == "dpmpp":
        if noise_seq is not None:
            raise ValueError("noise_seq only applies to the ancestral ddpm prior; "
                             "dpmpp is deterministic given noise=")
    elif sampler != "ddpm":
        raise ValueError("2.2 prior samplers: 'ddpm' (parity) or 'dpmpp'")


def _truncated_ladder(decoder_steps: int, strength: float) -> np.ndarray:
    """The img2img ladder: the last ``strength`` of the DDPM ladder."""
    full = ddpm_ladder(decoder_steps)
    ladder = full[max(len(full) - int(decoder_steps * strength), 0):]
    if len(ladder) == 0:
        raise ValueError(
            f"strength={strength} with decoder_steps={decoder_steps} leaves no "
            f"refine steps; use strength >= {1.0 / decoder_steps:.3f}")
    return ladder


class Kandinsky2_2(Pipeline):
    """Image encoder (ViT-bigG) + CLIP-bigG text tower + prior + decoder
    UNet + MoVQ, on ``device`` (the card by default).  ``overrides`` are
    the per-model constructor kwargs (``weights.configs22.
    pipeline_overrides`` gives the published configuration's)."""

    # the residual branches' last layers, drawn at a tenth of the usual scale
    residual_outputs = ("conv2", "to_out.0")

    def __init__(self, task_type: str = "text2img", tokenizer=None,
                 dtype=torch.bfloat16, overrides: Optional[dict] = None,
                 device="cuda"):
        if task_type not in TASKS:
            raise ValueError("Only text2img, img2img, inpainting and controlnet "
                             "are available")
        self.task_type = task_type
        self.dtype = dtype
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        ov = overrides or {}
        kw = dict(dtype=dtype, device=device)
        self.image_encoder = HFCLIPVision(**ov.get("image_encoder", {}), **kw)
        self.text_encoder = HFCLIPText(**ov.get("text_encoder", {}), **kw)
        self.prior = PriorTransformer22(**ov.get("prior", {}), **kw)
        unet_kw = dict(in_channels={"inpainting": 9, "controlnet": 8}.get(task_type, 4),
                       controlnet_hint=task_type == "controlnet")
        unet_kw.update(ov.get("unet", {}))
        self.unet = UNet22(**unet_kw, **kw)
        self.movq = MOVQ(**ov.get("movq", {}), **kw)
        self.movq_scale = 1.0
        # base schedules: the prior's cosine ("squaredcos_cap_v2"), the
        # decoder's linear
        self._prior_acp = _acp("cosine", 1000)
        self._decoder_acp = _acp("linear", 1000, 0.00085, 0.012)

    def models(self) -> dict:
        """The five models under the names of the JAX pipeline's params."""
        return {"image_encoder": self.image_encoder, "text_encoder": self.text_encoder,
                "prior": self.prior, "unet": self.unet, "movq": self.movq}

    def _draw_extra_(self, generator: torch.Generator) -> None:
        """The prior's clip_std, drawn around 1."""
        with torch.no_grad():
            std = self.prior.clip_std
            std.copy_(1.0 + 0.1 * torch.randn(std.shape, generator=generator,
                                              device=generator.device))

    def _randn(self, shape, generator):
        return torch.randn(shape, generator=self._gen(generator), device=self.device)

    # ------------------------------------------------------------------
    # prior
    # ------------------------------------------------------------------

    def _encode_text(self, prompts):
        """(last hidden state, projected embedding, mask) of the CLIP-bigG
        text tower."""
        toks, mask = self.tokenizer.padded_tokens_and_mask(
            prompts, self.text_encoder.context_length)
        with record_function("k22.clip_text"):
            hidden, proj = self.text_encoder(
                torch.as_tensor(toks, dtype=torch.long, device=self.device))
        return hidden, proj, torch.as_tensor(mask, device=self.device)

    def _encode_images(self, images) -> torch.Tensor:
        with record_function("k22.clip_vision"):
            return self.image_encoder(torch.as_tensor(images, device=self.device))

    def get_zero_embed(self, batch_size=1) -> torch.Tensor:
        """The image embedding of the all-zero image, [B, 1280]."""
        s = self.image_encoder.image_size
        emb = self._encode_images(torch.zeros((1, s, s, 3), device=self.device))
        return emb.expand(batch_size, -1)

    def encode_image(self, pil_image) -> torch.Tensor:
        """The ViT-bigG embedding of a PIL image, [1, 1280]."""
        return self._encode_images(clip_preprocess(pil_image,
                                                   self.image_encoder.image_size))

    def _prior_loop(self, prompt, batch_size, ladder, guidance_scale,
                    negative_prompt, sampler, x_T, noise_seq, generator):
        """The guided prior from the normalised x_T over ``ladder``; returns
        the de-normalised image embedding [B, D] fp32."""
        hidden, proj, mask = self._encode_text(
            as_prompt_list(negative_prompt, batch_size)
            + as_prompt_list(prompt, batch_size))
        B = batch_size

        def model_fn(x, t):
            out = self.prior(torch.cat([x, x]), torch.cat([t, t]), proj, hidden, mask)
            uncond, text = out[:B], out[B:]
            return uncond + guidance_scale * (text - uncond)

        with record_function("k22.prior"):
            if sampler == "dpmpp":
                tables = make_dpmpp_tables(self._prior_acp.astype(np.float64),
                                           ladder=ladder, device=self.device)
                lat = dpmpp_2m_loop(model_fn, tables, x_T, prediction="xstart",
                                    denoised_fn=lambda v: torch.clamp(v, -10.0, 10.0))
            else:
                lat = paired_ancestral_loop(
                    model_fn, self._prior_acp, ladder, x_T, self._gen(generator),
                    prediction="sample", variance="fixed_small_log", clip_range=10.0,
                    noise_seq=noise_seq)
            return lat * self.prior.clip_std.float() + self.prior.clip_mean.float()

    @torch.inference_mode()
    def run_prior(self, prompt, batch_size=1, prior_steps=25, guidance_scale=4,
                  negative_prompt="", sampler="ddpm", noise=None, noise_seq=None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Guided prior sampling -> de-normalised image embeddings [B, D]
        (diffusers KandinskyV22PriorPipeline).  ``sampler="dpmpp"`` runs
        the 2M solver on the x0-predicting prior.  ``noise``: the prior x_T
        [B, D]; ``noise_seq``: [S, B, D] per-step ancestral noise (ddpm)."""
        _prior_check(sampler, noise_seq)
        ladder = unclip_ladder(prior_steps)
        D = self.prior.embedding_dim
        x_T = check_noise(noise, (batch_size, D), "noise", self.device)
        nseq = check_noise(noise_seq, (len(ladder), batch_size, D), "noise_seq",
                           self.device)
        if x_T is None:
            x_T = self._randn((batch_size, D), generator)
        return self._prior_loop(prompt, batch_size, ladder, guidance_scale,
                                negative_prompt, sampler, x_T, nseq, generator)

    @torch.inference_mode()
    def run_prior_emb2emb(self, image, prompt, strength=0.3, batch_size=1,
                          prior_steps=25, guidance_scale=4, negative_prompt="",
                          sampler="ddpm", noise=None, noise_seq=None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prior img2img in embedding space (diffusers
        KandinskyV22PriorEmb2EmbPipeline): an existing image embedding (a
        PIL image through ViT-bigG, or a de-normalised embedding [D], [1, D]
        or [B, D]) normalised and re-noised to the step ``strength`` gives,
        then the guided prior over the rest of the ladder.  ``noise``
        replaces the re-noising draw [B, D]; ``noise_seq`` as in
        ``run_prior``.  Returns de-normalised embeddings [B, D]."""
        batch_size = resolve_batch(prompt, batch_size)
        full = unclip_ladder(prior_steps)
        ladder = full[max(prior_steps - min(int(prior_steps * strength), prior_steps), 0):]
        if len(ladder) == 0:
            raise ValueError(
                f"strength={strength} with prior_steps={prior_steps} leaves no prior "
                f"steps; use strength >= {1.0 / prior_steps:.3f} (or pass the "
                "embedding straight to the decoder)")
        _prior_check(sampler, noise_seq)
        emb = image if hasattr(image, "shape") else self.encode_image(image)
        emb = torch.as_tensor(emb, dtype=torch.float32, device=self.device)
        if emb.dim() == 1:
            emb = emb[None]
        if emb.shape[0] != batch_size:
            emb = emb.repeat(batch_size, 1)
        D = self.prior.embedding_dim
        renoise = check_noise(noise, (batch_size, D), "noise", self.device)
        nseq = check_noise(noise_seq, (len(ladder), batch_size, D), "noise_seq",
                           self.device)
        if renoise is None:
            renoise = self._randn((batch_size, D), generator)
        lat0 = (emb - self.prior.clip_mean.float()) / self.prior.clip_std.float()
        a = torch.sqrt(torch.tensor(self._prior_acp[int(ladder[0])], device=self.device))
        x_T = a * lat0 + torch.sqrt(1.0 - a**2) * renoise
        return self._prior_loop(prompt, batch_size, ladder, guidance_scale,
                                negative_prompt, sampler, x_T, nseq, generator)

    # ------------------------------------------------------------------
    # decoder
    # ------------------------------------------------------------------

    def _decode_loop(self, image_embeds, batch_size, steps, guidance, h, w,
                     x_T=None, extra_a=None, extra_b=None, task=None, ladder=None,
                     turbo_interval=1, sampler="ddpm", noise_seq=None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The decoder: UNet conditioning once on the CFG-doubled
        ``image_embeds``, the sampler's loop over ``ladder`` (the whole DDPM
        ladder of ``steps`` by default; the deep cache every
        ``turbo_interval`` steps where it is above 1), MoVQ decode.
        ``extra_a``/``extra_b``: (masked latent, keep mask) for inpainting,
        (hint, -) for ControlNet.  Returns float images [B, h, w, 3]."""
        task = task or self.task_type
        if sampler not in DECODER_SAMPLERS:
            raise ValueError("2.2 decoder samplers: 'ddpm' (parity), 'dpmpp' or "
                             "'dpmpp_karras'")
        if noise_seq is not None and sampler != "ddpm":
            raise ValueError("noise_seq only applies to the ancestral ddpm decoder; "
                             f"{sampler} is deterministic given noise=")
        dev, B = self.device, batch_size
        lat_h, lat_w = h // 8, w // 8
        ladder = ddpm_ladder(steps) if ladder is None else ladder
        if x_T is None:
            x_T = self._randn((B, lat_h, lat_w, 4), generator)
        nseq = check_noise(noise_seq, (len(ladder),) + tuple(x_T.shape), "noise_seq",
                           dev)
        unet = self.unet
        with record_function(f"k22.unet_{sampler}"):
            hint = None if task != "controlnet" else torch.cat([extra_a, extra_a])
            encoder_states, aug_emb, hint_latent = unet.encode_conditioning(
                image_embeds.to(self.dtype), hint)
            extra = ()
            if task == "inpainting":
                extra = (torch.cat([extra_a, extra_a]), torch.cat([extra_b, extra_b]))

            def unet_in(x, t):
                return torch.cat([torch.cat([x, x]), *extra], dim=-1), torch.cat([t, t])

            def mix(out):
                out = out.float()
                eps, var = out[..., :4], out[..., 4:]
                uncond, text = eps[:B], eps[B:]
                guided = uncond + guidance * (text - uncond)
                if sampler != "ddpm":  # the ODE solver takes eps only
                    return guided
                return torch.cat([guided, var[B:]], dim=-1)

            def model_fn(x, t):
                return mix(unet.denoise(*unet_in(x, t), encoder_states, aug_emb,
                                        hint_latent))

            def model_fn_turbo(x, t, cache, pos):
                out, cache = unet.denoise_cached(
                    *unet_in(x, t), encoder_states, aug_emb, hint_latent, cache,
                    pos % turbo_interval == 0)
                return mix(out), cache

            state, active_fn = None, model_fn
            if turbo_interval > 1:
                ds, ch = deep_cache_spec22(unet)
                state = torch.zeros((2 * B, lat_h // ds, lat_w // ds, ch),
                                    dtype=self.dtype, device=dev)
                active_fn = model_fn_turbo
            if sampler == "ddpm":
                lat = paired_ancestral_loop(
                    active_fn, self._decoder_acp, ladder, x_T, self._gen(generator),
                    prediction="epsilon", variance="learned_range", clip_range=2.0,
                    model_state=state, noise_seq=nseq)
            else:
                acp64 = self._decoder_acp.astype(np.float64)
                if sampler == "dpmpp_karras":
                    # sigma_max capped at the ladder's start, so a truncated
                    # img2img ladder keeps its init content
                    tables = make_dpmpp_karras_tables(acp64, len(ladder),
                                                      init_step=int(ladder[0]) + 1,
                                                      device=dev)
                else:
                    tables = make_dpmpp_tables(acp64, ladder=ladder, device=dev)
                lat = dpmpp_2m_loop(active_fn, tables, x_T, model_state=state,
                                    denoised_fn=lambda x0: torch.clamp(x0, -2.0, 2.0))
        return self._decode(lat)

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        with record_function("k22.movq_decode"):
            return self.movq.decode(latents.to(self.dtype)).float()

    def _embs_for(self, prompt, negative_prior_prompt, negative_decoder_prompt,
                  batch_size, prior_steps, prior_guidance_scale, prior_sampler="ddpm",
                  prior_noise=None, prior_noise_seq=None, generator=None):
        """[negative; positive] image embeddings: the positive from the
        prior, the negative the zero image's, or the prior's for
        ``negative_decoder_prompt``."""
        img_emb = self.run_prior(prompt, batch_size, prior_steps, prior_guidance_scale,
                                 negative_prior_prompt, sampler=prior_sampler,
                                 noise=prior_noise, noise_seq=prior_noise_seq,
                                 generator=generator)
        if negative_decoder_prompt == "":
            negative_emb = self.get_zero_embed(batch_size)
        else:
            negative_emb = self.run_prior(negative_decoder_prompt, batch_size,
                                          prior_steps, prior_guidance_scale,
                                          sampler=prior_sampler, generator=generator)
        return torch.cat([negative_emb, img_emb])

    def _movq_encode(self, image) -> torch.Tensor:
        """MoVQ latent (pre-quantisation) of NHWC images in [-1, 1], fp32."""
        with record_function("k22.movq_encode"):
            x = torch.as_tensor(image, device=self.device).to(self.dtype)
            return self.movq.encode(x).float()

    def _renoised(self, image, ladder, w, h, batch_size, noise, generator):
        """The MoVQ latent of the init image(s), re-noised to the ladder's
        first step."""
        lat = self._movq_encode(prepare_image_batch(image, w, h, batch_size))
        lat = lat * self.movq_scale
        if lat.shape[0] != batch_size:
            lat = lat.repeat(batch_size, 1, 1, 1)
        renoise = check_noise(noise, tuple(lat.shape), "noise", self.device)
        if renoise is None:
            renoise = self._randn(lat.shape, generator)
        a = torch.sqrt(torch.tensor(self._decoder_acp[int(ladder[0])], device=self.device))
        return a * lat + torch.sqrt(1.0 - a**2) * renoise

    # ------------------------------------------------------------------
    # public API (kandinsky2_2_model.py:55-173)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate_text2img(
        self, prompt, batch_size=1, decoder_steps=50, prior_steps=25,
        decoder_guidance_scale=4, prior_guidance_scale=4, h=512, w=512,
        negative_prior_prompt="", negative_decoder_prompt="", turbo_interval=1,
        sampler="ddpm", prior_sampler="ddpm", noise=None, noise_seq=None,
        prior_noise=None, prior_noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """``sampler``: "ddpm" (the diffusers scheduler), "dpmpp" or
        "dpmpp_karras" (DPM-Solver++(2M)); ``prior_sampler``: "ddpm" or
        "dpmpp".  ``noise`` is the decoder x_T [B, h/8, w/8, 4],
        ``noise_seq`` [decoder_steps, B, h/8, w/8, 4] its per-step noise
        (ddpm), ``prior_noise`` [B, D] and ``prior_noise_seq``
        [prior_steps, B, D] the positive prior run's."""
        batch_size = resolve_batch(prompt, batch_size)
        h, w = get_new_h_w_64(h, w)
        embs = self._embs_for(prompt, negative_prior_prompt, negative_decoder_prompt,
                              batch_size, prior_steps, prior_guidance_scale,
                              prior_sampler=prior_sampler, prior_noise=prior_noise,
                              prior_noise_seq=prior_noise_seq, generator=generator)
        x_T = check_noise(noise, (batch_size, h // 8, w // 8, 4), "noise", self.device)
        return self._output(self._decode_loop(
            embs, batch_size, decoder_steps, decoder_guidance_scale, h, w, x_T=x_T,
            turbo_interval=turbo_interval, sampler=sampler, noise_seq=noise_seq,
            generator=generator), output)

    @torch.inference_mode()
    def generate_img2img(
        self, prompt, image, strength=0.4, batch_size=1, decoder_steps=100,
        prior_steps=25, decoder_guidance_scale=4, prior_guidance_scale=4, h=512,
        w=512, negative_prior_prompt="", negative_decoder_prompt="", sampler="ddpm",
        image_embeds=None, turbo_interval=1, noise=None, noise_seq=None,
        prior_noise=None, prior_noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """``image``: one init image or a list of B; a CFG-doubled
        ``image_embeds`` skips the prior.  The last ``strength`` of the
        DDPM ladder runs from the MoVQ latent re-noised to its first step;
        ``noise`` replaces the re-noising draw [B, h/8, w/8, 4]."""
        batch_size = resolve_batch(prompt, batch_size)
        h, w = get_new_h_w_64(h, w)
        if image_embeds is None:
            image_embeds = self._embs_for(
                prompt, negative_prior_prompt, negative_decoder_prompt, batch_size,
                prior_steps, prior_guidance_scale, prior_noise=prior_noise,
                prior_noise_seq=prior_noise_seq, generator=generator)
        ladder = _truncated_ladder(decoder_steps, strength)
        x_T = self._renoised(image, ladder, w, h, batch_size, noise, generator)
        return self._output(self._decode_loop(
            image_embeds, batch_size, decoder_steps, decoder_guidance_scale, h, w,
            x_T=x_T, ladder=ladder, task="img2img", sampler=sampler,
            turbo_interval=turbo_interval, noise_seq=noise_seq, generator=generator),
            output)

    @torch.inference_mode()
    def generate_text2img_hires(
        self, prompt, batch_size=1, decoder_steps=25, prior_steps=25,
        decoder_guidance_scale=4, prior_guidance_scale=4, h=768, w=768,
        low_scale=0.5, low_steps=None, strength=0.35, negative_prior_prompt="",
        negative_decoder_prompt="", sampler="ddpm", turbo_interval=1, noise=None,
        prior_noise=None, generator: Optional[torch.Generator] = None, output="pil",
    ):
        """Two stages: the whole ladder at ``low_scale`` of the size, a
        LANCZOS upsample of its 8-bit images, then img2img on the last
        ``strength`` of the ladder at full size; the prior runs once.
        ``noise`` is the refine stage's re-noising draw, ``prior_noise`` the
        prior x_T."""
        from PIL import Image

        batch_size = resolve_batch(prompt, batch_size)
        h, w = get_new_h_w_64(h, w)
        embs = self._embs_for(prompt, negative_prior_prompt, negative_decoder_prompt,
                              batch_size, prior_steps, prior_guidance_scale,
                              prior_noise=prior_noise, generator=generator)
        lh, lw = get_new_h_w_64(max(64, int(h * low_scale)), max(64, int(w * low_scale)))
        low = process_images(self._decode_loop(
            embs, batch_size, low_steps or decoder_steps, decoder_guidance_scale, lh,
            lw, sampler=sampler, turbo_interval=turbo_interval,
            generator=generator).cpu().numpy())
        ups = [im.resize((w, h), Image.LANCZOS) for im in low]
        return self.generate_img2img(
            prompt, ups, strength=strength, batch_size=batch_size,
            decoder_steps=decoder_steps, decoder_guidance_scale=decoder_guidance_scale,
            h=h, w=w, sampler=sampler, image_embeds=embs, turbo_interval=turbo_interval,
            noise=noise, generator=generator, output=output)

    @torch.inference_mode()
    def mix_images(
        self, images_texts, weights, batch_size=1, decoder_steps=50, prior_steps=25,
        decoder_guidance_scale=4, prior_guidance_scale=4, h=512, w=512,
        negative_prior_prompt="", negative_decoder_prompt="", sampler="ddpm",
        noise=None, noise_seq=None, generator: Optional[torch.Generator] = None,
        output="pil",
    ):
        """The weighted sum of image embeddings (texts through the prior, PIL
        images through ViT-bigG) as the decoder's positive embedding
        (kandinsky2_2_model.py:114-142)."""
        if len(images_texts) != len(weights) or not images_texts:
            raise ValueError("mix_images needs as many weights as images and texts, "
                             "and at least one of each")
        h, w = get_new_h_w_64(h, w)
        emb = None
        for obj, wgt in zip(images_texts, weights):
            if isinstance(obj, str):
                e = self.run_prior(obj, 1, prior_steps, prior_guidance_scale,
                                   negative_prior_prompt, generator=generator)
            else:
                e = self.encode_image(obj)
            emb = wgt * e if emb is None else emb + wgt * e
        emb = emb.repeat(batch_size, 1)
        if negative_decoder_prompt == "":
            neg = self.get_zero_embed(batch_size)
        else:
            neg = self.run_prior(negative_decoder_prompt, batch_size, prior_steps,
                                 prior_guidance_scale, generator=generator)
        x_T = check_noise(noise, (batch_size, h // 8, w // 8, 4), "noise", self.device)
        return self._output(self._decode_loop(
            torch.cat([neg, emb]), batch_size, decoder_steps, decoder_guidance_scale,
            h, w, x_T=x_T, sampler=sampler, noise_seq=noise_seq, generator=generator),
            output)

    @torch.inference_mode()
    def generate_inpainting(
        self, prompt, pil_img, img_mask, batch_size=1, decoder_steps=50,
        prior_steps=25, decoder_guidance_scale=4, prior_guidance_scale=4, h=512,
        w=512, negative_prior_prompt="", negative_decoder_prompt="", sampler="ddpm",
        noise=None, noise_seq=None, prior_noise=None, prior_noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """``img_mask``: 1 = repaint (the diffusers >= 0.19 convention), one
        or a list of B at the image's size; ``pil_img`` one or a list of B.
        The 9-channel UNet takes x ⊕ the masked MoVQ latent ⊕ the keep mask
        (resized nearest to the latent grid)."""
        batch_size = resolve_batch(prompt, batch_size)
        h, w = get_new_h_w_64(h, w)
        embs = self._embs_for(prompt, negative_prior_prompt, negative_decoder_prompt,
                              batch_size, prior_steps, prior_guidance_scale,
                              prior_noise=prior_noise, prior_noise_seq=prior_noise_seq,
                              generator=generator)
        lat = self._movq_encode(prepare_image_batch(pil_img, w, h, batch_size))
        lat = lat * self.movq_scale
        lh, lw = lat.shape[1:3]
        masks = list(img_mask) if isinstance(img_mask, (list, tuple)) else [img_mask]
        if len(masks) not in (1, batch_size):
            raise ValueError(f"got {len(masks)} masks for batch {batch_size}; pass one "
                             "mask, or exactly batch_size masks (one per row)")
        keeps = []
        for m in masks:
            keep = 1.0 - np.asarray(m, np.float32)
            yi = (np.arange(lh) * (keep.shape[0] / lh)).astype(np.int32)
            xi = (np.arange(lw) * (keep.shape[1] / lw)).astype(np.int32)
            keeps.append(keep[yi][:, xi])
        keep = torch.as_tensor(np.stack(keeps), device=self.device)[..., None]
        if lat.shape[0] != batch_size:
            lat = lat.repeat(batch_size, 1, 1, 1)
        if keep.shape[0] != batch_size:
            keep = keep.repeat(batch_size, 1, 1, 1)
        x_T = check_noise(noise, (batch_size, lh, lw, 4), "noise", self.device)
        return self._output(self._decode_loop(
            embs, batch_size, decoder_steps, decoder_guidance_scale, h, w, x_T=x_T,
            extra_a=lat * keep, extra_b=keep, task="inpainting", sampler=sampler,
            noise_seq=noise_seq, generator=generator), output)

    @torch.inference_mode()
    def generate_controlnet(
        self, prompt, hint=None, batch_size=1, decoder_steps=50, prior_steps=25,
        decoder_guidance_scale=4, prior_guidance_scale=4, h=512, w=512,
        negative_prior_prompt="", negative_decoder_prompt="", sampler="ddpm",
        image=None, strength=0.5, image_embeds=None, noise=None, noise_seq=None,
        prior_noise=None, prior_noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """ControlNet-depth: ``hint`` is an [H, W, 3] (or [1 or B, H, W, 3])
        array in [0, 1], such as a depth map.  With ``image`` the init image
        is MoVQ-encoded and re-noised at the ``strength``-derived step (the
        ControlnetImg2Img flow).  A CFG-doubled ``image_embeds`` skips the
        prior.  ``noise`` is the decoder x_T, or the re-noising draw with
        ``image``.  Without ``hint`` the hint is ``depth.make_hint``
        of ``image`` (the heuristic estimator), as in the JAX package."""
        batch_size = resolve_batch(prompt, batch_size)
        h, w = get_new_h_w_64(h, w)
        if hint is None:
            if image is None:
                raise ValueError("generate_controlnet needs hint= or image=")
            hint = make_hint(image, h=h, w=w)
        if image_embeds is None:
            image_embeds = self._embs_for(
                prompt, negative_prior_prompt, negative_decoder_prompt, batch_size,
                prior_steps, prior_guidance_scale, prior_noise=prior_noise,
                prior_noise_seq=prior_noise_seq, generator=generator)
        hint = torch.as_tensor(np.asarray(hint, np.float32), device=self.device)
        if hint.dim() == 3:
            hint = hint[None]
        hint = hint.repeat(batch_size, 1, 1, 1)
        x_T, ladder = None, None
        if image is not None:
            ladder = _truncated_ladder(decoder_steps, strength)
            x_T = self._renoised(image, ladder, w, h, batch_size, noise, generator)
        elif noise is not None:
            x_T = check_noise(noise, (batch_size, h // 8, w // 8, 4), "noise",
                              self.device)
        return self._output(self._decode_loop(
            image_embeds, batch_size, decoder_steps, decoder_guidance_scale, h, w,
            extra_a=hint, task="controlnet", sampler=sampler, x_T=x_T, ladder=ladder,
            noise_seq=noise_seq, generator=generator), output)

    @torch.inference_mode()
    def decode_latents(self, latents, output="pil"):
        """MoVQ-decode raw decoder latents [B, h/8, w/8, 4] to images."""
        return self._output(self._decode(torch.as_tensor(
            latents, dtype=torch.float32, device=self.device)), output)
