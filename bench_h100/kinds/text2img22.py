"""Traffic kind ``text2img22``: a closed loop of one caller, each call
``Kandinsky2_2.generate_text2img`` on ``batch`` distinct prompts with every
draw injected from the seed and the call's index.

The check: a sample of the window's calls, drawn from the seed once the
window has closed, is run again by the plain fp32 reference from the same
prompts and draws, and each image is compared with the reference's
(``image_gap``: ‖program − reference‖ / ‖reference‖, the widest over the
sampled images)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.layers import exact_fp32, set_fp8
from ..reference.models import build22
from ..reference.pipeline22 import Text2Img22
from ..weights import NOISE, PROMPTS, draw, load_words, param_specs, stream_seed
from ..work.counter import Work, counting

CHECK = 5
WARMUP_CALL = 2**40  # a call index no window reaches


def call_prompts(traffic: dict, words: list, seed: int, call: int) -> list:
    rng = np.random.default_rng(stream_seed(seed, PROMPTS, call))
    lo, hi = traffic["prompt_words"]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi + 1))))
            for _ in range(traffic["batch"])]


def call_noise(cfg: dict, traffic: dict, seed: int, call: int, device, steps=None) -> dict:
    """The call's injected draws, in a fixed order from one generator."""
    ps, ds = steps or (traffic["prior_steps"], traffic["decoder_steps"])
    B, D = traffic["batch"], cfg["prior"]["embedding_dim"]
    lat = (B, traffic["h"] // 8, traffic["w"] // 8, cfg["unet"]["in_channels"])
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, NOISE, call))
    rand = lambda shape: torch.randn(shape, generator=g, device=device)
    return {"prior_noise": rand((B, D)), "prior_noise_seq": rand((ps, B, D)),
            "noise": rand(lat), "noise_seq": rand((ds,) + lat)}


def reference_models(cfg: dict, seed: int, device, fp8: bool = False) -> dict:
    models = build22(cfg, device="meta")
    weights = draw(param_specs(models, cfg["residual_outputs"]), seed,
                   getattr(torch, cfg["dtype"]), device)
    for name, model in models.items():
        model.load_state_dict({k: v.float() for k, v in weights.pop(name).items()},
                              assign=True)
        set_fp8(model, fp8)
    return models


def reference_images(cfg, traffic, models, prompts, noise) -> torch.Tensor:
    chain = Text2Img22(cfg, models)
    with exact_fp32():
        embs = chain.embeddings(prompts, noise["prior_noise"], noise["prior_noise_seq"],
                                traffic["prior_steps"], traffic["prior_guidance"])
        lat = chain.latents(embs, noise["noise"], noise["noise_seq"],
                            traffic["decoder_steps"], traffic["decoder_guidance"])
        return chain.decode(lat)


def image_gaps(images, ref: torch.Tensor) -> list:
    p = torch.as_tensor(images, device=ref.device).float()
    return [float((a - b).norm() / b.norm()) for a, b in zip(p, ref)]


class Cell:
    """One cell of the ``text2img22`` kind; see the module docstring."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.words = load_words(traffic)
        self.outputs = {}
        self.pipe = None

    def setup(self) -> None:
        from kandinsky2_tpu_torch.pipelines.kandinsky2_2 import Kandinsky2_2
        from kandinsky2_tpu_torch.utils import stub_tokenizer22
        from kandinsky2_tpu_torch.weights import configs22 as c22

        cfg = self.cfg
        overrides = {
            "unet": c22.unet22_overrides(cfg["unet"], cfg["num_image_tokens"]),
            "movq": c22.movq22_overrides(cfg["movq"]),
            "prior": c22.prior22_overrides(cfg["prior"]),
            "text_encoder": c22.clip_text_overrides(cfg["text_encoder"]),
            "image_encoder": c22.clip_vision_overrides(cfg["image_encoder"]),
        }
        te = cfg["text_encoder"]
        pipe = Kandinsky2_2("text2img", tokenizer=stub_tokenizer22(
            te["vocab_size"], te["eos_token_id"]), dtype=getattr(torch, cfg["dtype"]),
            overrides=overrides, device=self.device)
        pipe.cast_models_()
        weights = draw(param_specs(build22(cfg, device="meta"), cfg["residual_outputs"]),
                       self.seed, getattr(torch, cfg["dtype"]), self.device)
        for name, model in pipe.models().items():
            model.load_state_dict(weights.pop(name))
        del weights
        self.pipe = pipe
        warm = self.traffic["warmup"]
        self._generate(WARMUP_CALL, (warm["prior_steps"], warm["decoder_steps"]))

    def _generate(self, call: int, steps=None):
        tr = self.traffic
        ps, ds = steps or (tr["prior_steps"], tr["decoder_steps"])
        return self.pipe.generate_text2img(
            call_prompts(tr, self.words, self.seed, call), batch_size=tr["batch"],
            decoder_steps=ds, prior_steps=ps, decoder_guidance_scale=tr["decoder_guidance"],
            prior_guidance_scale=tr["prior_guidance"], h=tr["h"], w=tr["w"],
            output="float", **call_noise(self.cfg, tr, self.seed, call, self.device, steps))

    def step(self, call: int) -> int:
        self.outputs[call] = self._generate(call)
        return self.traffic["batch"]

    def free(self) -> None:
        self.pipe = None

    def sample(self, n_calls: int) -> list:
        rng = np.random.default_rng(stream_seed(self.seed, CHECK))
        k = min(self.traffic["check_calls"], n_calls)
        return sorted(int(i) for i in rng.choice(n_calls, size=k, replace=False))

    def check(self, n_calls: int, fp8: bool = False) -> dict:
        """{name: value} of the comparison with the reference over the
        sampled calls (with ``fp8``, the control in the program's place)."""
        models = reference_models(self.cfg, self.seed, self.device)
        control = reference_models(self.cfg, self.seed, self.device, fp8=True) if fp8 else None
        gaps = []
        for call in self.sample(n_calls):
            prompts = call_prompts(self.traffic, self.words, self.seed, call)
            noise = call_noise(self.cfg, self.traffic, self.seed, call, self.device)
            ref = reference_images(self.cfg, self.traffic, models, prompts, noise)
            out = (reference_images(self.cfg, self.traffic, control, prompts, noise)
                   if fp8 else self.outputs[call])
            gaps += image_gaps(out, ref)
        return {"image_gap": max(gaps)}

    def end_to_end(self, window_s: float, items: int) -> dict:
        return {"images_per_s": items / window_s}

    def counts(self, n_calls: int) -> dict:
        tr = self.traffic
        return {"calls": n_calls, "unet_calls": n_calls * tr["decoder_steps"],
                "prior_calls": n_calls * tr["prior_steps"]}

    def work_per_call(self) -> Work:
        """The work of one call, counted on the reference models' shapes."""
        cfg, tr = self.cfg, self.traffic
        m = build22(cfg, device="meta")
        B, meta = tr["batch"], torch.device("meta")
        te, ie, D = cfg["text_encoder"], cfg["image_encoder"], cfg["prior"]["embedding_dim"]
        L, Wt = te["max_position_embeddings"], te["hidden_size"]
        empty = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=meta)
        total = Work()
        with counting(m["text_encoder"]) as w:
            m["text_encoder"](empty(2 * B, L, dt=torch.long))
        total += w
        with counting(m["prior"]) as w:
            m["prior"](empty(2 * B, D), empty(2 * B), empty(2 * B, D), empty(2 * B, L, Wt),
                       empty(2 * B, L, dt=torch.bool))
        total += w.scaled(tr["prior_steps"])
        with counting(m["image_encoder"]) as w:
            m["image_encoder"](empty(1, ie["image_size"], ie["image_size"], 3))
        total += w
        lat = (tr["h"] // 8, tr["w"] // 8)
        with counting(m["unet"]) as w:
            m["unet"](empty(2 * B, *lat, cfg["unet"]["in_channels"]), empty(2 * B),
                      empty(2 * B, cfg["unet"]["encoder_hid_dim"]))
        total += w.scaled(tr["decoder_steps"])
        with counting(m["movq"]) as w:
            m["movq"].decode(empty(B, *lat, cfg["movq"]["vq_embed_dim"]))
        return total + w
