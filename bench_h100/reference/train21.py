"""The 2.1 decoder's fine-tuning step in plain fp32: the frozen encoders
make the batch (MoVQ latents times the scale, the XLM-R states and pooled
projection, the CLIP image embedding), then the UNet's hybrid loss at the
given timesteps and noise, its gradient on the trainable parameters (the
decoder freeze rule), Adafactor and the EMA.  The batch's rows run in
blocks whose gradients add up to the whole batch's."""

from __future__ import annotations

import torch

from .diffusion import Schedule, hybrid_loss
from .optim import Adafactor, ema_update

RES_MARKERS = ("in_layers", "h_upd", "x_upd", "emb_layers", "out_layers")
ATTN_MARKERS = ("proj_out", "qkv")


def trainable(name: str, freeze_resblocks: bool, freeze_attention: bool) -> bool:
    name = name.lower()
    if any(m in name for m in RES_MARKERS):
        return not freeze_resblocks
    if any(m in name for m in ATTN_MARKERS):
        return not freeze_attention
    return True


class TrainStep21:
    def __init__(self, cfg: dict, models: dict, device, rows: int = 2):
        self.cfg, self.m, self.rows = cfg, models, rows
        dc = cfg["diffusion_config"]
        self.sched = Schedule(dc["steps"], dc["linear_start"], dc["linear_end"], device)
        unet = models["unet"]
        self.names = []
        for name, p in unet.named_parameters():
            p.requires_grad_(trainable(name, **cfg["freeze"]))
            if p.requires_grad:
                self.names.append(name)
        for key in ("movq", "text_encoder", "clip_vision"):
            models[key].requires_grad_(False)
        params = dict(unet.named_parameters())
        self.params = [params[n] for n in self.names]
        self.opt = Adafactor(self.params, cfg["optim_params"]["params"]["learning_rate"])
        self.ema = {n: p.detach().clone() for n, p in zip(self.names, self.params)}
        self.step_count = 0

    @torch.no_grad()
    def prepare(self, raw: dict) -> dict:
        m, dev = self.m, self.params[0].device
        lat = m["movq"].encode(torch.as_tensor(raw["image"], device=dev))
        full, pooled = m["text_encoder"](torch.as_tensor(raw["tokens"], device=dev).long(),
                                         torch.as_tensor(raw["mask"], device=dev))
        return {"image_latents": lat * self.cfg["image_enc_params"]["scale"],
                "full_emb": full, "pooled_emb": pooled,
                "image_emb": m["clip_vision"](torch.as_tensor(raw["clip_image"], device=dev))}

    def step(self, raw: dict, t, noise, rows=None) -> dict:
        """One step; ``rows`` trains on those examples alone.  Returns the
        loss and the gradient norm of each trainable tensor."""
        b = self.prepare(raw)
        t, noise = torch.as_tensor(t, device=noise.device).long(), noise.float()
        if rows is not None:
            b, t, noise = {k: v[rows] for k, v in b.items()}, t[rows], noise[rows]
        B = t.shape[0]
        loss = 0.0
        for i in range(0, B, self.rows):
            sl = slice(i, i + self.rows)
            fn = lambda x, tm: self.m["unet"](x, tm, b["full_emb"][sl], b["pooled_emb"][sl],
                                              b["image_emb"][sl])
            part = hybrid_loss(self.sched, fn, b["image_latents"][sl].float(), t[sl],
                               noise[sl])[0].sum() / B
            part.backward()
            loss += float(part.detach())
        grads = {n: float(p.grad.norm()) for n, p in zip(self.names, self.params)}
        self.opt.step()
        for p in self.params:
            p.grad = None
        ema_update(self.ema, dict(zip(self.names, self.params)), self.cfg["ema_decay"],
                   self.step_count)
        self.step_count += 1
        return {"loss": loss, "grads": grads}
