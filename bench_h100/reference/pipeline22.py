"""The Kandinsky 2.2 text-to-image chain in plain fp32: the CLIP-bigG text
tower, the guided prior (UnCLIP scheduler: sample prediction,
fixed_small_log variance, clip ±10, cosine betas), the zero image's
ViT-bigG embedding as the negative, the guided decoder loop (DDPM
scheduler: epsilon prediction, learned_range variance, clip ±2, linear
betas 0.00085-0.012) over the UNet, and the MoVQ decode.  CFG batches are
[negative; positive]; every draw is injected."""

from __future__ import annotations

import numpy as np
import torch

from .diffusion import alphas_cumprod, ladder, paired_step
from .tokenizers import clip_tokens


class Text2Img22:
    def __init__(self, cfg: dict, models: dict):
        self.cfg, self.m = cfg, models

    def _walk(self, model_fn, acp, steps, x, noise_seq, **kw):
        lad = ladder(steps)
        prev = np.concatenate([lad[1:], [-1]])
        for pos, (t, tp) in enumerate(zip(lad, prev)):
            out = model_fn(x, torch.full((2 * x.shape[0],), float(t), device=x.device))
            x = paired_step(out, x, acp, int(t), int(tp),
                            None if tp < 0 else noise_seq[pos].float(), **kw)
        return x

    @torch.no_grad()
    def embeddings(self, prompts, prior_noise, prior_noise_seq, steps: int,
                   guidance: float) -> torch.Tensor:
        """[negative (the zero image's); positive (the prior's)] [2B, D]."""
        te, m = self.cfg["text_encoder"], self.m
        B, dev = len(prompts), prior_noise.device
        toks, mask = clip_tokens([""] * B + list(prompts), te["max_position_embeddings"],
                                 te["vocab_size"], te["eos_token_id"])
        hidden, proj = m["text_encoder"](torch.as_tensor(toks, device=dev))
        mask = torch.as_tensor(mask, device=dev)

        def prior_fn(x, t):
            out = m["prior"](torch.cat([x, x]), t, proj, hidden, mask)
            return out[:B] + guidance * (out[B:] - out[:B])

        lat = self._walk(prior_fn, alphas_cumprod("cosine"), steps, prior_noise.float(),
                         prior_noise_seq, prediction="sample", variance="fixed_small_log",
                         clip=10.0)
        pos = lat * m["prior"].clip_std.float() + m["prior"].clip_mean.float()
        s = self.cfg["image_encoder"]["image_size"]
        neg = m["image_encoder"](torch.zeros((1, s, s, 3), device=dev)).expand(B, -1)
        return torch.cat([neg, pos])

    @torch.no_grad()
    def latents(self, embs, noise, noise_seq, steps: int, guidance: float) -> torch.Tensor:
        B = noise.shape[0]

        def unet_fn(x, t):
            out = self.m["unet"](torch.cat([x, x]), t, embs)
            eps, var = out[..., :4], out[..., 4:]
            return torch.cat([eps[:B] + guidance * (eps[B:] - eps[:B]), var[B:]], dim=-1)

        return self._walk(unet_fn, alphas_cumprod("linear", 1000, 0.00085, 0.012), steps,
                          noise.float(), noise_seq, prediction="epsilon",
                          variance="learned_range", clip=2.0)

    @torch.no_grad()
    def decode(self, latents) -> torch.Tensor:
        return self.m["movq"].decode(latents)
