"""Kandinsky 2.1 text2img in PyTorch, the counterpart of
``kandinsky2_tpu/pipelines/kandinsky2_1.py`` (its fused text2img program).

One eager path per call: CLIP text tower -> guided prior (ancestral ladder)
-> CLIP ViT on the zero image -> XLM-R + MultilingualCLIP -> UNet
conditioning -> DDIM loop of the CFG-doubled UNet -> MoVQ decode.
Public arguments and outputs keep the JAX package's layouts: ``noise``
[B, h/8, w/8, 4] NHWC, ``prior_noise`` [B, clip_dim], ``prior_noise_seq``
[S, B, clip_dim], images NHWC.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..configs import CONFIG_2_1, create_model, deep_copy_config, schedule_kwargs
from ..diffusion import ddim_loop, make_ddim_tables, make_schedule
from ..models.layers import Conv2d, GroupNorm32, LayerNormF32, Linear
from ..models.movq import MOVQ
from ..models.prior import PriorTransformer, prior_sample_fn
from ..models.text_encoders import CLIPTextTower, CLIPViT, TextEncoder
from ..utils import (
    as_prompt_list,
    check_noise,
    get_new_h_w,
    process_images,
    resolve_batch,
)
from ..weights.from_jax import load_jax_params

# submodules of the JAX MOVQ tree that the port does not have yet
MOVQ_UNPORTED = ("encoder.", "quant_conv.", "quantize.")


# last layers of residual branches: the reference initialises the UNet's to
# zero; drawn at a tenth of the usual scale they keep the random network
# well conditioned in bf16 without being zero
RESIDUAL_OUTPUTS = ("out_layers.3", "proj_out", "conv2")


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: weights of linear layers and
    convolutions ~ N(0, 1/fan_in), a tenth of that for the residual
    branches' last layers (``RESIDUAL_OUTPUTS``; the UNet's output conv is
    drawn in full, so its output is not identically zero), biases and
    embeddings ~ N(0, 0.02²), other free parameters ~ N(0, 0.01²) or
    N(0, 1/rows) for projection matrices; norms keep weight 1, bias 0."""

    def draw(p, std):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)

    for mod_name, mod in module.named_modules():
        if isinstance(mod, (GroupNorm32, LayerNormF32)):
            continue
        gain = 0.1 if mod_name.endswith(RESIDUAL_OUTPUTS) else 1.0
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                draw(p, 0.02)
            elif isinstance(mod, nn.Embedding):
                draw(p, 0.02)
            elif isinstance(mod, (Linear, Conv2d)):
                draw(p, gain * p[0].numel() ** -0.5)
            elif name in ("text_projection", "proj"):
                draw(p, p.shape[0] ** -0.5)
            else:
                draw(p, 0.01)


class Kandinsky2_1:
    """Five-model pipeline: prior, CLIP text and vision towers, XLM-R text
    encoder, latent UNet, MoVQ decoder (kandinsky2_1_model.py:23-104)."""

    def __init__(self, config: Optional[dict] = None, tokenizer1=None,
                 tokenizer2=None, clip_mean=None, clip_std=None,
                 task_type: str = "text2img", dtype=torch.bfloat16,
                 device="cpu"):
        if task_type != "text2img":
            raise NotImplementedError("the PyTorch port runs text2img only")
        self.config = deep_copy_config(config or CONFIG_2_1)
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
            ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
            num_res_blocks=dd["num_res_blocks"],
            attn_resolutions=tuple(dd["attn_resolutions"]),
            resolution=dd["resolution"], out_ch=dd["out_ch"], **kw,
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

    def models(self) -> dict:
        """The five models under the names of the JAX pipeline's params."""
        return {
            "prior": self.prior, "clip_text": self.clip_text,
            "clip_vision": self.clip_vision, "text_encoder": self.text_encoder,
            "unet": self.unet, "movq": self.movq,
        }

    def init_random_params(self, generator: Optional[torch.Generator] = None,
                           dtype=None):
        """Random parameters from ``generator`` (seed 0 by default), then cast
        to ``dtype`` (the activation dtype by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for model in self.models().values():
            init_random_(model, generator)
            model.to(dtype or self.dtype)

    def load_jax_params(self, params: dict):
        """Load the JAX pipeline's params (``Kandinsky2_1.params`` of the JAX
        package: one nested dict of arrays per model) through the bridge,
        keeping each parameter's device and dtype."""
        for name, model in self.models().items():
            skip = MOVQ_UNPORTED if name == "movq" else ()
            load_jax_params(model, params[name], skip_prefixes=skip)

    @torch.inference_mode()
    def generate_text2img(
        self, prompt, num_steps=100, batch_size=1, guidance_scale=7,
        h=512, w=512, sampler="ddim_sampler", prior_cf_scale=4,
        prior_steps="25", negative_prior_prompt="", noise=None,
        prior_noise=None, prior_noise_seq=None,
        generator: Optional[torch.Generator] = None, output="pil",
    ):
        """kandinsky2_1_model.py:299-351.  ``noise`` is the decoder x_T
        [B, h/8, w/8, 4], ``prior_noise`` the prior x_T [B, clip_dim] and
        ``prior_noise_seq`` [S, B, clip_dim] the prior's per-step ancestral
        noise; whatever is not injected is drawn from ``generator``.
        ``output="float"`` returns the float NHWC images in [-1, 1] (as a
        numpy array) instead of PIL images."""
        if sampler != "ddim_sampler":
            raise NotImplementedError("the PyTorch port has the ddim_sampler only")
        ps = str(prior_steps)
        if ps.startswith(("ddim", "dpmpp")):
            raise NotImplementedError("the PyTorch port has the ancestral prior only")
        dev = self.device
        B = resolve_batch(prompt, batch_size)
        new_h, new_w = get_new_h_w(h, w)
        prompts = as_prompt_list(prompt, B)
        hp = self.config["prior"]["params"]["model"]["hparams"]
        C = self.config["model_config"]["in_channels"]

        with record_function("k21.clip_text_and_prior"):
            # CLIP text features of [prompt; negative prompt] -> guided prior
            tok, mask = self.tokenizer2.padded_tokens_and_mask(prompts, hp["text_ctx"])
            cf_tok, cf_mask = self.tokenizer2.padded_tokens_and_mask(
                as_prompt_list(negative_prior_prompt, B), hp["text_ctx"])
            prior_tok = torch.as_tensor(np.concatenate([tok, cf_tok]),
                                        dtype=torch.long, device=dev)
            prior_mask = torch.as_tensor(np.concatenate([mask, cf_mask]), device=dev)
            seq, feat = self.clip_text(prior_tok)
            prior_sched = make_schedule(
                **schedule_kwargs(self._prior_diff_cfg, ps)["make_schedule"],
                device=dev)
            prior_x_T = check_noise(prior_noise, (B, hp["clip_dim"]),
                                    "prior_noise", dev)
            if prior_x_T is None:
                prior_x_T = torch.randn((B, hp["clip_dim"]), generator=generator,
                                        device=dev)
            prior_nseq = check_noise(
                prior_noise_seq, (prior_sched.num_timesteps, B, hp["clip_dim"]),
                "prior_noise_seq", dev)
            image_emb = prior_sample_fn(
                self.prior, prior_sched, feat, seq, prior_mask, prior_cf_scale,
                self.clip_mean, self.clip_std, prior_x_T, generator=generator,
                noise_seq=prior_nseq,
            )

        with record_function("k21.clip_vision_and_text_encoder"):
            # negative image embedding: CLIP ViT on the all-zero image
            s = self.clip_image_size
            zero_emb = self.clip_vision(torch.zeros((1, s, s, 3), device=dev))
            img_prompt = torch.cat([image_emb, zero_emb.expand(B, -1)]).to(self.dtype)
            # decoder text conditioning: XLM-R on [prompt; ""]
            enc = self.tokenizer1(
                prompts + [""] * B,
                max_length=min(77, self.text_encoder.max_positions - 2),
                padding="max_length", truncation=True, return_attention_mask=True,
                add_special_tokens=True, return_tensors="np",
            )
            full_emb, pooled_emb = self.text_encoder(
                torch.as_tensor(enc["input_ids"], dtype=torch.long, device=dev),
                torch.as_tensor(enc["attention_mask"], device=dev),
            )

        with record_function("k21.unet_ddim"):
            # DDIM over the CFG-doubled UNet
            dec_sched = make_schedule(
                **schedule_kwargs(self._decoder_diff_cfg, "")["make_schedule"])
            tables = make_ddim_tables(dec_sched.base_alphas_cumprod, num_steps,
                                      device=dev)
            xf_proj, xf_out = self.unet.encode_conditioning(full_emb, pooled_emb,
                                                            img_prompt)

            def model_fn(x, t_model):
                out = self.unet.denoise(torch.cat([x, x]),
                                        torch.cat([t_model, t_model]),
                                        xf_proj, xf_out)
                eps = out[..., :C]
                cond_eps, uncond_eps = eps[:B], eps[B:]
                return uncond_eps + guidance_scale * (cond_eps - uncond_eps)

            x_T = check_noise(noise, (B, new_h, new_w, C), "noise", dev)
            if x_T is None:
                x_T = torch.randn((B, new_h, new_w, C), generator=generator,
                                  device=dev)
            samples = ddim_loop(model_fn, tables, x_T)

        with record_function("k21.movq_decode"):
            img = self.movq.decode((samples / self.scale).to(self.dtype)).float()
            images = img[:, :h, :w, :].cpu().numpy()
        if output == "float":
            return images
        return process_images(images)
