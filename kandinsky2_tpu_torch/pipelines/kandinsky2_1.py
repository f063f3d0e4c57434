"""Kandinsky 2.1 inference in PyTorch, the counterpart of
``kandinsky2_tpu/pipelines/kandinsky2_1.py``: ``generate_text2img``
(with ``negative_decoder_prompt``), ``generate_clip_emb``,
``generate_img`` with the five decoder samplers and the turbo deep cache,
``generate_text2img_hires``, ``mix_images``, ``generate_img2img``,
``generate_inpainting`` and ``decode_latents``; and the frozen-encoder
helpers of decoder training (``clip_preprocess``, ``encode_images``,
``movq_encode``).

Each call runs eagerly: CLIP text tower -> guided prior (ancestral,
"ddim…" or "dpmpp…" ladder) -> CLIP ViT on the zero image (or a second
prior run for a negative decoder prompt) -> XLM-R + MultilingualCLIP ->
UNet conditioning -> the sampler's loop over the CFG-doubled UNet -> MoVQ
decode.  Public arguments and outputs keep the JAX package's layouts:
``noise`` [B, h/8, w/8, 4] NHWC, ``noise_seq`` [S, B, h/8, w/8, 4],
prior noise [B, clip_dim] and [S, B, clip_dim], images NHWC.  Whatever is
not injected is drawn from ``generator``, or from the pipeline's own
(``set_seed``), never from torch's global one.  Every image entry point takes
``output="float"`` for the float NHWC images in [-1, 1] (a numpy array)
instead of PIL images.

``sp_mesh=`` (a ``parallel.mesh.Mesh`` with an ``"sp"`` axis; one process
per shard, every rank calling with the same arguments) runs the denoise
and the MoVQ decode row-sharded over the mesh (``_build_latent_fn`` of the
JAX pipeline): each rank takes its rows of the same x_T, the conditioning
is computed on every rank, and every rank returns the whole image.  The
latent height must keep equal even row shards at every UNet level
(``parallel.spatial.check_sp_rows``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..configs import CONFIG_2_1, create_model, deep_copy_config, schedule_kwargs
from ..diffusion import make_schedule, q_sample
from ..models.movq import MOVQ
from ..models.prior import PriorTransformer, prior_sample_fn
from ..models.text_encoders import CLIPTextTower, CLIPViT, TextEncoder
from ..models.unet import deep_cache_spec
from ..parallel.collectives import all_gather
from ..parallel.spatial import (
    check_sp_rows,
    shard_rows,
    sp_rows_ok,
    spatial_decode,
    using_sp_axis,
)
from ..utils import (
    as_prompt_list,
    check_noise,
    get_new_h_w,
    prepare_image_batch,
    prepare_mask,
    resolve_batch,
)
from .base import (
    Pipeline,
    cfg_mix,
    check_sampler,
    decoder_schedule,
    rank_generator,
    sample_latents,
)

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
def clip_preprocess(pil_image, image_size: int = 224) -> np.ndarray:
    """CLIP preprocessing (resize + centre crop + normalise), NHWC
    [1, S, S, 3] float32; a copy of the JAX package's."""
    from PIL import Image

    w, h = pil_image.size
    scale = image_size / min(w, h)
    pil_image = pil_image.resize(
        (round(w * scale), round(h * scale)), resample=Image.BICUBIC
    )
    w, h = pil_image.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    pil_image = pil_image.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(pil_image.convert("RGB"), np.float32) / 255.0
    arr = (arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
    return arr[None]


class Kandinsky2_1(Pipeline):
    """Five-model pipeline: prior, CLIP text and vision towers, XLM-R text
    encoder, latent UNet, MoVQ decoder (kandinsky2_1_model.py:23-104)."""

    def __init__(self, config: Optional[dict] = None, tokenizer1=None,
                 tokenizer2=None, clip_mean=None, clip_std=None,
                 task_type: str = "text2img", dtype=torch.bfloat16,
                 device="cuda"):
        if task_type not in ("text2img", "inpainting"):
            raise ValueError("Only text2img and inpainting is available")
        self.config = deep_copy_config(config or CONFIG_2_1)
        self.task_type = task_type
        self.config["model_config"]["inpainting"] = task_type == "inpainting"
        self.dtype = dtype
        self.device = torch.device(device)
        self.tokenizer1 = tokenizer1
        self.tokenizer2 = tokenizer2
        kw = dict(dtype=dtype, device=device)
        hp = self.config["prior"]["params"]["model"]["hparams"]
        self.prior = PriorTransformer(
            text_ctx=hp["text_ctx"], xf_width=hp["xf_width"],
            xf_layers=hp["xf_layers"], xf_heads=hp["xf_heads"],
            xf_final_ln=hp["xf_final_ln"], clip_dim=hp["clip_dim"],
            clip_xf_width=hp["clip_xf_width"], **kw,
        )
        self.clip_text = CLIPTextTower(**self.config.get("clip_text_params", {}),
                                       **kw)
        self.clip_vision = CLIPViT(**self.config.get("clip_vision_params", {}),
                                   **kw)
        te = self.config["text_enc_params"]
        te_extra = {k: te[k] for k in ("layers", "heads", "intermediate",
                                       "vocab_size", "max_positions") if k in te}
        self.text_encoder = TextEncoder(
            model_name=te["model_name"], in_features=te["in_features"],
            out_features=te["out_features"], **te_extra, **kw,
        )
        self.unet = create_model(**self.config["model_config"], **kw)
        ie = self.config["image_enc_params"]
        dd = ie["params"]["ddconfig"]
        self.scale = ie["scale"]
        self.movq = MOVQ(
            z_channels=dd["z_channels"], embed_dim=ie["params"]["embed_dim"],
            n_embed=ie["params"]["n_embed"], ch=dd["ch"],
            ch_mult=tuple(dd["ch_mult"]), num_res_blocks=dd["num_res_blocks"],
            attn_resolutions=tuple(dd["attn_resolutions"]),
            resolution=dd["resolution"], in_channels=dd.get("in_channels", 3),
            out_ch=dd["out_ch"], **kw,
        )
        self.clip_image_size = self.config.get("clip_image_size", 224)
        clip_dim = hp["clip_dim"]
        self.clip_mean = torch.as_tensor(
            np.zeros(clip_dim, np.float32) if clip_mean is None else clip_mean,
            dtype=torch.float32, device=device).reshape(1, -1)
        self.clip_std = torch.as_tensor(
            np.ones(clip_dim, np.float32) if clip_std is None else clip_std,
            dtype=torch.float32, device=device).reshape(1, -1)
        self._prior_diff_cfg = self.config["prior"]["params"]["diffusion"]
        self._decoder_diff_cfg = self.config["diffusion_config"]
        # img2img re-noises on the default linear(1e-4, 2e-2) schedule, not
        # the decoder's (the reference's utils.py:42-47 ignores its
        # linear_start/end)
        self._img2img_sched = make_schedule(steps=1000, noise_schedule="linear",
                                            device=device)

    def models(self) -> dict:
        """The five models under the names of the JAX pipeline's params."""
        return {
            "prior": self.prior, "clip_text": self.clip_text,
            "clip_vision": self.clip_vision, "text_encoder": self.text_encoder,
            "unet": self.unet, "movq": self.movq,
        }

    # ------------------------------------------------------------------
    # conditioning encoders
    # ------------------------------------------------------------------

    def encode_text(self, prompt, batch_size: int):
        """XLM-R full and pooled embeddings of [prompt] * B + [""] * B
        (kandinsky2_1_model.py:115-131)."""
        enc = self.tokenizer1(
            as_prompt_list(prompt, batch_size) + [""] * batch_size,
            max_length=min(77, self.text_encoder.max_positions - 2),
            padding="max_length", truncation=True, return_attention_mask=True,
            add_special_tokens=True, return_tensors="np",
        )
        with record_function("k21.text_encoder"):
            return self.text_encoder(
                torch.as_tensor(enc["input_ids"], dtype=torch.long, device=self.device),
                torch.as_tensor(enc["attention_mask"], device=self.device),
            )

    @torch.inference_mode()
    def generate_clip_emb(self, prompt, batch_size=1, prior_cf_scale=4,
                          prior_steps="25", negative_prior_prompt="", noise=None,
                          noise_seq=None, generator: Optional[torch.Generator] = None):
        """CLIP text features -> guided prior sample [B, clip_dim]
        (kandinsky2_1_model.py:133-175).  ``prior_steps`` is a respacing
        ("25": ancestral), "ddimN" (DDIM over the respaced schedule) or
        "dpmppN" (DPM-Solver++(2M) over N respaced steps).  ``noise`` is
        the prior's x_T [B, clip_dim]; ``noise_seq`` [S, B, clip_dim] its
        per-step ancestral noise (the ancestral ladder only)."""
        ps = str(prior_steps)
        use_ddim, use_dpmpp = ps.startswith("ddim"), ps.startswith("dpmpp")
        if noise_seq is not None and (use_ddim or use_dpmpp):
            raise ValueError(
                "noise_seq only applies to the ancestral (p-sampler) prior "
                "ladder; ddim/dpmpp prior trajectories are deterministic "
                "given noise=")
        dev = self.device
        generator = self._gen(generator)
        ctx = self.prior.text_ctx
        clip_dim = self.clip_mean.shape[-1]
        tok, mask = self.tokenizer2.padded_tokens_and_mask(
            as_prompt_list(prompt, batch_size), ctx)
        cf_tok, cf_mask = self.tokenizer2.padded_tokens_and_mask(
            as_prompt_list(negative_prior_prompt, batch_size), ctx)
        sched = make_schedule(**schedule_kwargs(
            self._prior_diff_cfg, ps[5:] if use_dpmpp else ps)["make_schedule"],
            device=dev)
        x_T = check_noise(noise, (batch_size, clip_dim), "noise", dev)
        if x_T is None:
            x_T = torch.randn((batch_size, clip_dim), generator=generator, device=dev)
        nseq = check_noise(noise_seq, (sched.num_timesteps, batch_size, clip_dim),
                           "noise_seq", dev)
        with record_function("k21.clip_text_and_prior"):
            seq, feat = self.clip_text(torch.as_tensor(
                np.concatenate([tok, cf_tok]), dtype=torch.long, device=dev))
            return prior_sample_fn(
                self.prior, sched, feat, seq,
                torch.as_tensor(np.concatenate([mask, cf_mask]), device=dev),
                prior_cf_scale, self.clip_mean, self.clip_std, x_T,
                use_ddim=use_ddim, use_dpmpp=use_dpmpp, generator=generator,
                noise_seq=nseq)

    def encode_images(self, image, is_pil: bool = False) -> torch.Tensor:
        """CLIP image embedding (kandinsky2_1_model.py:177-181) of NHWC
        images already through ``clip_preprocess``, or of a PIL image
        (``is_pil``)."""
        if is_pil:
            image = clip_preprocess(image, self.clip_image_size)
        with record_function("k21.clip_vision"):
            return self.clip_vision(torch.as_tensor(image, device=self.device))

    def create_zero_img_emb(self, batch_size: int) -> torch.Tensor:
        """The negative image embedding: CLIP ViT on the all-zero image."""
        s = self.clip_image_size
        emb = self.encode_images(torch.zeros((1, s, s, 3), device=self.device))
        return emb.expand(batch_size, -1)

    def movq_encode(self, image) -> torch.Tensor:
        """MoVQ latent (pre-quantisation, not yet scaled) of NHWC images in
        [-1, 1], in fp32 (``_movq_encode`` of the JAX pipeline)."""
        with record_function("k21.movq_encode"):
            x = torch.as_tensor(image, device=self.device).to(self.dtype)
            return self.movq.encode(x).float()

    # ------------------------------------------------------------------
    # the decoder: sampler loop over the UNet, then MoVQ decode
    # ------------------------------------------------------------------

    def _sample_images(self, full_emb, pooled_emb, img_prompt, x_T, sp_axis=None,
                       **kw):
        """The JAX pipeline's latent program: UNet conditioning once, the
        sampler's loop over the CFG-doubled UNet (the deep cache every
        ``turbo_interval`` steps where it is above 1), MoVQ decode.
        Returns the float images [B, H8, W8, 3] in fp32.  The profiler range
        ``k21.unet_<sampler>`` (``k21.unet_ddim`` for DDIM) spans everything
        but the decode.  ``sp_axis``: the latents, init latent, mask and
        per-step noise are cut to this rank's rows, the UNet and the MoVQ
        run on the shards (the p_sampler from this rank's own noise
        stream), and the decoded rows are gathered."""
        if sp_axis is None:
            return self._sample_local(full_emb, pooled_emb, img_prompt, x_T, **kw)
        x_T = shard_rows(x_T, sp_axis)
        kw.update(inpaint_image=shard_rows(kw["inpaint_image"], sp_axis),
                  inpaint_mask=shard_rows(kw["inpaint_mask"], sp_axis),
                  noise_seq=shard_rows(kw["noise_seq"], sp_axis, dim=2))
        if kw["sampler"] == "p_sampler":
            kw["generator"] = rank_generator(kw["generator"], sp_axis)
        with using_sp_axis(self.unet, sp_axis), using_sp_axis(self.movq, sp_axis):
            images = self._sample_local(full_emb, pooled_emb, img_prompt, x_T,
                                        sp_axis=sp_axis, **kw)
        return all_gather(images, sp_axis, dim=1)

    def _sample_local(self, full_emb, pooled_emb, img_prompt, x_T, *, sampler,
                      num_steps, guidance_scale, init_step, inpaint_image,
                      inpaint_mask, turbo_interval, noise_seq, generator,
                      sp_axis=None):
        """``_sample_images`` on this rank's tensors: the whole latent, or
        its row shard with the UNet and the MoVQ set to ``sp_axis``."""
        with record_function("k21.unet_" + sampler.removesuffix("_sampler")):
            B = x_T.shape[0]
            C = self.config["model_config"]["in_channels"]
            inpainting = self.task_type == "inpainting"
            unet = self.unet
            xf_proj, xf_out = unet.encode_conditioning(full_emb, pooled_emb,
                                                       img_prompt)
            extra = ()
            if inpainting:
                extra = (torch.cat([inpaint_image, inpaint_image]),
                         torch.cat([inpaint_mask, inpaint_mask]))

            def mix(out):
                return cfg_mix(out, B, C, guidance_scale, sampler == "p_sampler")

            def model_fn(x, t_model):
                return mix(unet.denoise(torch.cat([x, x]),
                                        torch.cat([t_model, t_model]),
                                        xf_proj, xf_out, *extra))

            def model_fn_turbo(x, t_model, cache, pos):
                out, cache = unet.denoise_cached(
                    torch.cat([x, x]), torch.cat([t_model, t_model]), xf_proj, xf_out,
                    *extra, cache, pos % turbo_interval == 0)
                return mix(out), cache

            state, active_fn = None, model_fn
            if turbo_interval > 1:
                ds, ch = deep_cache_spec(unet)
                state = torch.zeros(
                    (2 * B, x_T.shape[1] // ds, x_T.shape[2] // ds, ch),
                    dtype=self.dtype, device=x_T.device)
                active_fn = model_fn_turbo

            def denoised_fn(x0):
                x0 = torch.clamp(x0, -2, 2)
                if inpainting:
                    x0 = x0 * (1 - inpaint_mask) + inpaint_image * inpaint_mask
                return x0

            samples = sample_latents(
                active_fn, x_T, sampler=sampler, diff_cfg=self._decoder_diff_cfg,
                num_steps=num_steps, init_step=init_step, generator=generator,
                denoised_fn=denoised_fn, model_state=state, noise_seq=noise_seq,
                sp_axis=sp_axis)
        return self._decode(samples)

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        with record_function("k21.movq_decode"):
            return self.movq.decode((latents / self.scale).to(self.dtype)).float()

    @torch.inference_mode()
    def generate_img(self, prompt, img_prompt, batch_size=1, guidance_scale=7,
                     init_step=None, noise=None, init_img=None, img_mask=None,
                     h=512, w=512, sampler="ddim_sampler", num_steps=50,
                     turbo_interval=1, noise_seq=None,
                     generator: Optional[torch.Generator] = None, output="pil",
                     sp_mesh=None):
        """The decoder loop and MoVQ decode (kandinsky2_1_model.py:183-292).
        ``img_prompt`` is the CFG-doubled [cond; uncond] image embedding;
        ``noise`` the starting latent x_T [B, h/8, w/8, C]; ``noise_seq``
        the p_sampler's per-step noise [S, B, h/8, w/8, C] (S = init_step
        where the ladder is truncated); ``init_img`` and ``img_mask`` the
        inpainting latent and mask.  ``turbo_interval`` > 1 recomputes the
        UNet's deep branch every that many steps and reuses it between
        (not the reference's trajectory; 1 is).  ``sp_mesh``: the denoise
        and decode row-sharded over the mesh's "sp" axis (see the module
        docstring)."""
        check_sampler(sampler)
        if noise_seq is not None and sampler != "p_sampler":
            raise ValueError("noise_seq only applies to the ancestral p_sampler; "
                             f"{sampler} is deterministic given noise=")
        dev = self.device
        generator = self._gen(generator)
        new_h, new_w = get_new_h_w(h, w)
        sp_axis = None
        if sp_mesh is not None:
            check_sp_rows(new_h, sp_mesh.shape["sp"], len(self.unet.channel_mult))
            sp_axis = sp_mesh.axis("sp")
        C = self.config["model_config"]["in_channels"]
        full_emb, pooled_emb = self.encode_text(prompt, batch_size)
        x_T = check_noise(noise, (batch_size, new_h, new_w, C), "noise", dev)
        if x_T is None:
            x_T = torch.randn((batch_size, new_h, new_w, C), generator=generator,
                              device=dev)
        n_anc = num_steps if init_step is None else init_step
        nseq = check_noise(noise_seq, (n_anc,) + tuple(x_T.shape), "noise_seq", dev)
        as_dev = lambda a, like: like if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=dev)
        images = self._sample_images(
            full_emb, pooled_emb, torch.as_tensor(img_prompt, device=dev), x_T,
            sampler=sampler, num_steps=num_steps, guidance_scale=guidance_scale,
            init_step=init_step, inpaint_image=as_dev(init_img, torch.zeros_like(x_T)),
            inpaint_mask=as_dev(img_mask, torch.zeros_like(x_T[..., :1])),
            turbo_interval=turbo_interval, noise_seq=nseq, generator=generator,
            sp_axis=sp_axis)
        return self._output(images, output, h, w)

    def _image_prompt(self, image_emb, negative_decoder_prompt, batch_size, **prior_kw):
        """[image_emb; negative] in the activation dtype: the negative is the
        zero image's embedding, or the prior's sample for
        ``negative_decoder_prompt``."""
        if negative_decoder_prompt == "":
            zero_emb = self.create_zero_img_emb(batch_size)
        else:
            zero_emb = self.generate_clip_emb(negative_decoder_prompt,
                                              batch_size=batch_size, **prior_kw)
        return torch.cat([image_emb, zero_emb]).to(self.dtype)

    @torch.inference_mode()
    def generate_text2img(
        self, prompt, num_steps=100, batch_size=1, guidance_scale=7,
        h=512, w=512, sampler="ddim_sampler", prior_cf_scale=4,
        prior_steps="25", negative_prior_prompt="", negative_decoder_prompt="",
        turbo_interval=1, noise=None, prior_noise=None, noise_seq=None,
        prior_noise_seq=None, generator: Optional[torch.Generator] = None,
        output="pil", sp_mesh=None,
    ):
        """kandinsky2_1_model.py:299-351: the prior's image embedding, then
        ``generate_img`` (row-sharded over ``sp_mesh`` where given; the JAX
        pipeline's staged path, as its fused program is single-device).
        ``noise`` is the decoder x_T [B, h/8, w/8, 4],
        ``prior_noise`` the prior x_T [B, clip_dim] (of the positive prior
        run), ``noise_seq`` and ``prior_noise_seq`` their per-step
        ancestral noise; ``prompt`` may be a list of B prompts."""
        check_sampler(sampler)
        batch_size = resolve_batch(prompt, batch_size)
        prior_kw = dict(prior_cf_scale=prior_cf_scale, prior_steps=prior_steps,
                        negative_prior_prompt=negative_prior_prompt,
                        generator=generator)
        image_emb = self.generate_clip_emb(prompt, batch_size=batch_size,
                                           noise=prior_noise,
                                           noise_seq=prior_noise_seq, **prior_kw)
        img_prompt = self._image_prompt(image_emb, negative_decoder_prompt,
                                        batch_size, **prior_kw)
        return self.generate_img(
            prompt=prompt, img_prompt=img_prompt, batch_size=batch_size,
            guidance_scale=guidance_scale, h=h, w=w, sampler=sampler,
            num_steps=num_steps, turbo_interval=turbo_interval, noise=noise,
            noise_seq=noise_seq, generator=generator, output=output, sp_mesh=sp_mesh)

    @torch.inference_mode()
    def generate_text2img_hires(
        self, prompt, num_steps=50, batch_size=1, guidance_scale=7, h=768, w=768,
        sampler="ddim_sampler", low_scale=0.5, low_steps=None, strength=0.65,
        prior_cf_scale=4, prior_steps="25", negative_prior_prompt="",
        turbo_interval=1, noise=None, prior_noise=None,
        generator: Optional[torch.Generator] = None, output="pil", sp_mesh=None,
    ):
        """Two stages (kandinsky2_1.py:786 of the JAX package): the whole
        ladder at ``low_scale`` of the size, a LANCZOS upsample of its
        8-bit images, then img2img at full size with ``strength``; the
        prior runs once and both stages use its embedding.  ``noise`` is
        the img2img re-noising draw.  With ``sp_mesh`` the full-size stage
        is row-sharded, and the low stage too where its own latent height
        keeps equal even shards."""
        from PIL import Image

        batch_size = resolve_batch(prompt, batch_size)
        image_emb = self.generate_clip_emb(
            prompt, batch_size=batch_size, prior_cf_scale=prior_cf_scale,
            prior_steps=prior_steps, negative_prior_prompt=negative_prior_prompt,
            noise=prior_noise, generator=generator)
        image_emb = self._image_prompt(image_emb, "", batch_size)
        lo_h, lo_w = max(64, int(h * low_scale)), max(64, int(w * low_scale))
        low_sp = sp_mesh
        if sp_mesh is not None and not sp_rows_ok(
                get_new_h_w(lo_h, lo_w)[0], sp_mesh.shape["sp"],
                len(self.unet.channel_mult)):
            low_sp = None
        low = self.generate_img(
            prompt=prompt, img_prompt=image_emb, batch_size=batch_size,
            guidance_scale=guidance_scale, h=lo_h, w=lo_w, sampler=sampler,
            num_steps=low_steps or num_steps, turbo_interval=turbo_interval,
            generator=generator, sp_mesh=low_sp)
        ups = [im.resize((w, h), Image.LANCZOS) for im in low]
        return self.generate_img2img(
            prompt, ups, strength=strength, num_steps=num_steps,
            batch_size=batch_size, guidance_scale=guidance_scale, h=h, w=w,
            sampler=sampler, prior_cf_scale=prior_cf_scale, prior_steps=prior_steps,
            image_emb=image_emb, turbo_interval=turbo_interval, noise=noise,
            generator=generator, output=output, sp_mesh=sp_mesh)

    @torch.inference_mode()
    def mix_images(
        self, images_texts, weights, num_steps=100, batch_size=1, guidance_scale=7,
        h=512, w=512, sampler="ddim_sampler", prior_cf_scale=4, prior_steps="25",
        negative_prior_prompt="", negative_decoder_prompt="", noise=None,
        noise_seq=None, generator: Optional[torch.Generator] = None, output="pil",
        sp_mesh=None,
    ):
        """The weighted sum of image embeddings, of texts through the prior
        and of PIL images through CLIP ViT (kandinsky2_1_model.py:353-425),
        as the image prompt of an unconditioned decoder."""
        if len(images_texts) != len(weights) or not images_texts:
            raise ValueError("mix_images needs as many weights as images and "
                             "texts, and at least one of each")
        prior_kw = dict(prior_cf_scale=prior_cf_scale, prior_steps=prior_steps,
                        negative_prior_prompt=negative_prior_prompt,
                        generator=generator)
        image_emb = None
        for obj, wgt in zip(images_texts, weights):
            if isinstance(obj, str):
                emb = wgt * self.generate_clip_emb(obj, batch_size=1, **prior_kw)
            else:
                emb = self.encode_images(obj, is_pil=True) * wgt
            image_emb = emb if image_emb is None else image_emb + emb
        img_prompt = self._image_prompt(image_emb.expand(batch_size, -1),
                                        negative_decoder_prompt, batch_size,
                                        **prior_kw)
        return self.generate_img(
            prompt="", img_prompt=img_prompt, batch_size=batch_size,
            guidance_scale=guidance_scale, h=h, w=w, sampler=sampler,
            num_steps=num_steps, noise=noise, noise_seq=noise_seq,
            generator=generator, output=output, sp_mesh=sp_mesh)

    @torch.inference_mode()
    def generate_img2img(
        self, prompt, pil_img, strength=0.7, num_steps=100, batch_size=1,
        guidance_scale=7, h=512, w=512, sampler="ddim_sampler", prior_cf_scale=4,
        prior_steps="25", image_emb=None, turbo_interval=1, noise=None,
        prior_noise=None, noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil", sp_mesh=None,
    ):
        """kandinsky2_1_model.py:427-484: MoVQ-encode the init image (one,
        or a list of B), re-noise it to the step ``strength`` gives and run
        the truncated ladder.  A CFG-doubled ``image_emb`` skips the prior.
        ``noise`` replaces the re-noising draw ([1 or B, h/8, w/8, C])."""
        if not 0.0 < strength < 1.0:
            raise ValueError(f"strength={strength} out of range: (0, 1) exclusive "
                             "(1 would fully re-noise, 0 runs no steps)")
        batch_size = resolve_batch(prompt, batch_size)
        dev = self.device
        generator = self._gen(generator)
        if image_emb is None:
            image_emb = self.generate_clip_emb(
                prompt, batch_size=batch_size, prior_cf_scale=prior_cf_scale,
                prior_steps=prior_steps, noise=prior_noise, generator=generator)
            image_emb = self._image_prompt(image_emb, "", batch_size)
        latent = self.movq_encode(prepare_image_batch(pil_img, w, h, batch_size)
                                  ) * self.scale
        if sampler == "p_sampler":
            sched = decoder_schedule(self._decoder_diff_cfg, sampler, num_steps,
                                     self.device)[1]
            start_step = int(sched.num_timesteps * (1 - strength))
            t_noise = int(sched.timestep_map[start_step - 1])
        else:
            start_step = int(1000 * (1 - strength))
            t_noise = start_step - 1
        renoise = check_noise(noise, tuple(latent.shape), "noise", dev)
        latent = q_sample(
            self._img2img_sched, latent,
            torch.full((latent.shape[0],), t_noise, dtype=torch.int64, device=dev),
            renoise if renoise is not None else torch.randn(
                latent.shape, generator=generator, device=dev))
        if latent.shape[0] != batch_size:
            latent = latent.repeat(batch_size, 1, 1, 1)
        return self.generate_img(
            prompt=prompt, img_prompt=image_emb, batch_size=batch_size,
            guidance_scale=guidance_scale, h=h, w=w, sampler=sampler,
            num_steps=num_steps, noise=latent, init_step=start_step,
            turbo_interval=turbo_interval, noise_seq=noise_seq, generator=generator,
            output=output, sp_mesh=sp_mesh)

    @torch.inference_mode()
    def generate_inpainting(
        self, prompt, pil_img, img_mask, num_steps=100, batch_size=1,
        guidance_scale=7, h=512, w=512, sampler="ddim_sampler", prior_cf_scale=4,
        prior_steps="25", negative_prior_prompt="", negative_decoder_prompt="",
        noise=None, prior_noise=None, noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil", sp_mesh=None,
    ):
        """kandinsky2_1_model.py:486-548: the init image's MoVQ latent and
        the mask (1 = keep, 0 = inpaint; one, or a list of B, at the
        image's size) resized nearest to the latent grid and eroded, as the
        inpainting UNet's extra inputs and the p_sampler's blend.  As in
        the reference, the negative image embedding is the zero image's
        whatever ``negative_decoder_prompt`` says."""
        batch_size = resolve_batch(prompt, batch_size)
        dev = self.device
        image_emb = self.generate_clip_emb(
            prompt, batch_size=batch_size, prior_cf_scale=prior_cf_scale,
            prior_steps=prior_steps, negative_prior_prompt=negative_prior_prompt,
            noise=prior_noise, generator=generator)
        image_emb = self._image_prompt(image_emb, "", batch_size)
        latent = self.movq_encode(prepare_image_batch(pil_img, w, h, batch_size)
                                  ) * self.scale
        lh, lw = latent.shape[1:3]
        masks = list(img_mask) if isinstance(img_mask, (list, tuple)) else [img_mask]
        if len(masks) not in (1, batch_size):
            raise ValueError(f"got {len(masks)} masks for batch {batch_size}; pass "
                             "one mask, or exactly batch_size masks (one per row)")
        prepped = []
        for m in masks:
            m = np.asarray(m, np.float32)
            yi = (np.arange(lh) * (m.shape[0] / lh)).astype(np.int32)
            xi = (np.arange(lw) * (m.shape[1] / lw)).astype(np.int32)
            prepped.append(prepare_mask(m[yi][:, xi]))
        mask = torch.as_tensor(np.stack(prepped), device=dev)[..., None]
        if latent.shape[0] != batch_size:
            latent = latent.repeat(batch_size, 1, 1, 1)
        if mask.shape[0] != batch_size:
            mask = mask.repeat(batch_size, 1, 1, 1)
        return self.generate_img(
            prompt=prompt, img_prompt=image_emb, batch_size=batch_size,
            guidance_scale=guidance_scale, h=h, w=w, sampler=sampler,
            num_steps=num_steps, init_img=latent, img_mask=mask, noise=noise,
            noise_seq=noise_seq, generator=generator, output=output, sp_mesh=sp_mesh)

    @torch.inference_mode()
    def decode_latents(self, latents, output="pil", sp_mesh=None, axis="sp"):
        """MoVQ-decode sampler latents [B, h/8, w/8, 4] to images.  With
        ``sp_mesh`` the decode runs row-sharded over the mesh's ``axis``
        (``parallel.spatial.spatial_decode``), for sizes whose decoder
        activations do not fit one card; every rank gets every image."""
        lat = torch.as_tensor(latents, dtype=torch.float32, device=self.device)
        if sp_mesh is None:
            return self._output(self._decode(lat), output)
        with record_function("k21.movq_decode"):
            images = spatial_decode(self.movq, (lat / self.scale).to(self.dtype),
                                    sp_mesh, axis=axis, method="decode").float()
        return self._output(images, output)
