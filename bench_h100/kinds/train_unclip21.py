"""Traffic kind ``train_unclip21``: the 2.1 decoder's fine-tuning as the
CLI runs it, ``make_prepare_batch`` (the frozen encoders) then the
``make_unclip_train_step`` step, back to back on a pool of raw batches
made on the host from the seed (in pinned memory on a card, as a
loader's), with each step's timesteps and noise drawn from the seed and
the step's index.

Set-up builds the one train state and runs its first ``checked_steps``
steps through the window's own call, on rows that all differ; the window
goes on from there, and its first step keeps, on the device and with no
wait, each trainable tensor's gradient norm as the optimizer gets it and
the norm of that step's change.  The check: the plain fp32 reference
follows those steps and the window's first from the same weights,
batches, timesteps and noise, and compares the first step's gradient
norm of each trainable tensor (``grad_gap``), the norm of each tensor's
change over the set-up's steps, of the parameters (``change_gap``) and
of their EMA (``ema_gap``), and the window's first step's gradient and
change norms (``window_grad_gap``, ``window_change_gap``): the gap
between the two norms over the larger of the reference's norm of that
tensor and of the median tensor, the widest over the tensors.  Tensors
whose reference gradient is under a thousandth of the median tensor's
move under Adafactor by rounding alone, and are left out of the change
gaps."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..reference.layers import exact_fp32, set_fp8
from ..reference.models import build21
from ..reference.tokenizers import xlmr_tokens
from ..reference.train21 import TrainStep21, trainable
from ..weights import BATCHES, NOISE, draw, load_words, param_specs, stream_seed
from ..work.counter import Work, counting


def raw_batch(cfg: dict, traffic: dict, words: list, seed: int, k: int) -> dict:
    """Pool batch ``k``: smooth random images in [-1, 1], prompts (dropped
    to "" with the YAML's probability) as stand-in XLM-R ids, and the CLIP
    crops (zeroed with the YAML's probability)."""
    rng = np.random.default_rng(stream_seed(seed, BATCHES, k))
    B, S, C = traffic["batch"], traffic["image_size"], traffic["clip_image_size"]

    def smooth(size, scale):
        coarse = torch.from_numpy(rng.standard_normal((B, 3, 24, 24)).astype(np.float32))
        up = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
        return (scale * up).permute(0, 2, 3, 1).contiguous().numpy()

    lo, hi = traffic["prompt_words"]
    prompts = ["" if rng.random() < traffic["drop_text_prob"] else
               " ".join(rng.choice(words, int(rng.integers(lo, hi + 1)))) for _ in range(B)]
    te = cfg["text_enc_params"]
    tokens, mask = xlmr_tokens(prompts, traffic["seq_len"], te["vocab_size"])
    clip = smooth(C, 1.0)
    clip[rng.random(B) < traffic["drop_image_prob"]] = 0.0
    return {"image": np.clip(smooth(S, 0.5), -1.0, 1.0), "tokens": tokens.astype(np.int32),
            "mask": mask.astype(np.int32), "clip_image": clip}


def step_draws(cfg: dict, traffic: dict, seed: int, k: int, latent_shape, device):
    """(t [B], noise) of step ``k``."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, NOISE, k))
    t = torch.randint(0, cfg["diffusion_config"]["steps"], (traffic["batch"],), generator=g,
                      device=device)
    return t, torch.randn(latent_shape, generator=g, device=device)


def reference_models(cfg: dict, seed: int, device, fp8: bool = False) -> dict:
    models = build21(cfg, device="meta")
    weights = draw(param_specs(models, cfg["residual_outputs"]), seed,
                   getattr(torch, cfg["param_dtype"]), device)
    for name, model in models.items():
        model.load_state_dict(weights.pop(name), assign=True)
        set_fp8(model, fp8)
    return models


def loss_gap(prog: dict, ref: dict) -> float:
    """The widest |p − r| / |r| of the checked steps' losses."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))


def _gap(prog: dict, ref: dict, keep) -> float:
    """The widest |‖p‖ − ‖r‖| over max(‖r‖, the median tensor's ‖r‖); a
    tensor the program did not report reads infinite."""
    names = [n for n in ref if keep(n)]
    floor = float(np.median([ref[n] for n in names]))
    return max(abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], floor) for n in names)


def _moved(grads: dict):
    """The rule for the change gaps: a reference gradient at least a
    thousandth of the median tensor's."""
    floor = 1e-3 * float(np.median(list(grads.values())))
    return lambda n: grads[n] >= floor


def host_batch(raw: dict, device) -> dict:
    """A raw batch as host tensors, pinned where the batches go to a card."""
    out = {k: torch.from_numpy(v) for k, v in raw.items()}
    return {k: v.pin_memory() for k, v in out.items()} if device.type == "cuda" else out


class Cell:
    """One cell of the ``train_unclip21`` kind; see the module docstring."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        words = load_words(traffic)
        self.pool = [host_batch(raw_batch(cfg, traffic, words, seed, k), self.device)
                     for k in range(traffic["pool"])]
        S = traffic["image_size"] // 8
        self.latent_shape = (traffic["batch"], S, S,
                             cfg["image_enc_params"]["params"]["ddconfig"]["z_channels"])
        self.readings, self.window_norms = {}, {}

    def setup(self) -> None:
        from kandinsky2_tpu_torch.pipelines.kandinsky2_1 import Kandinsky2_1
        from kandinsky2_tpu_torch.train.optim import decoder_freeze_mask, optimizer_from_config
        from kandinsky2_tpu_torch.train.train_2_1_unclip import (
            make_prepare_batch,
            pipeline_config,
        )
        from kandinsky2_tpu_torch.train.train_unclip import make_unclip_train_step
        from kandinsky2_tpu_torch.utils import stub_tokenizers

        cfg = self.cfg
        pipe = Kandinsky2_1(config=pipeline_config(cfg),
                            tokenizer1=stub_tokenizers(cfg["text_enc_params"]["vocab_size"])[0],
                            dtype=getattr(torch, cfg["dtype"]), device=self.device)
        weights = draw(param_specs(build21(cfg, device="meta"), cfg["residual_outputs"]),
                       self.seed, getattr(torch, cfg["param_dtype"]), self.device)
        for name in ("unet", "movq", "text_encoder", "clip_vision"):
            getattr(pipe, name).load_state_dict(weights.pop(name))
        del weights
        self.prepare_batch = make_prepare_batch(pipe)
        init_state, self.train_step = make_unclip_train_step(
            pipe.unet, cfg["diffusion_config"], optimizer_from_config(cfg["optim_params"]),
            schedule_sampler=cfg["schedule_sampler"], ema_decay=cfg["ema_decay"],
            remat=cfg["remat"])
        self.state = init_state(decoder_freeze_mask(pipe.unet, **cfg["freeze"]))
        self.pipe = pipe
        self._first_steps()

    def _first_steps(self) -> None:
        """The checked steps: the losses, the first gradients as the
        optimizer gets them (a hook before its first step) and the change of
        each trainable tensor and its EMA over the steps."""
        unet, state = self.pipe.unet, self.state
        named = [(n, p) for n, p in unet.named_parameters() if p.requires_grad]
        theta0 = {n: p.detach().clone() for n, p in named}
        grads = {}

        def first_grads(opt, args, kwargs):
            if not grads:
                grads.update({n: float(p.grad.norm()) for n, p in named})

        hook = state.optimizer.register_step_pre_hook(first_grads)
        losses = []
        for k in range(self.traffic["checked_steps"]):
            losses.append(float(self._train(k)["loss"]))
        hook.remove()
        self.named = named
        self.theta = [p.detach().clone() for _, p in named]
        self.readings = {
            "losses": losses, "grads": grads,
            "change": {n: float((p.detach() - theta0[n]).norm()) for n, p in named},
            "ema": {n: float((state.ema_params[n] - theta0[n]).norm()) for n, _ in named}}

    def _train(self, k: int) -> dict:
        """Step ``k`` of the run: pool batch k mod the pool, its own draws."""
        with record_function("bench.prepare_batch"):
            batch = self.prepare_batch(self.pool[k % len(self.pool)])
        t, noise = step_draws(self.cfg, self.traffic, self.seed, k, self.latent_shape,
                              self.device)
        return self.train_step(self.state, batch, t=t, noise=noise)

    def step(self, i: int) -> int:
        """The window's step ``i``, after the checked steps; the first keeps
        its gradient and change norms on the device."""
        k = self.traffic["checked_steps"] + i
        if i:
            self._train(k)
            return self.traffic["batch"]
        params = [p for _, p in self.named]

        def grads(opt, args, kwargs):
            self.window_norms["grads"] = torch.stack(torch._foreach_norm([p.grad for p in params]))

        hook = self.state.optimizer.register_step_pre_hook(grads)
        try:
            self._train(k)
        finally:
            hook.remove()
        moved = torch._foreach_sub([p.detach() for p in params], self.theta)
        self.window_norms["change"] = torch.stack(torch._foreach_norm(moved))
        self.theta = moved = None
        return self.traffic["batch"]

    def free(self) -> None:
        """Read the window step's norms back, then drop the program."""
        names = [n for n, _ in self.named]
        for key, norms in self.window_norms.items():
            self.readings["window_" + key] = dict(zip(names, norms.tolist()))
        self.pipe = self.state = self.train_step = self.prepare_batch = None
        self.named = self.theta = self.window_norms = None

    def reference_readings(self, models, rows=None) -> dict:
        """The reference over the checked steps and the window's first."""
        ref = TrainStep21(self.cfg, models, self.device, self.traffic["ref_rows"])
        snapshot = lambda: {n: p.detach().clone() for n, p in zip(ref.names, ref.params)}
        change = lambda before, now: {n: float((now[n] - before[n]).norm()) for n in ref.names}
        n = self.traffic["checked_steps"]
        theta0, losses, grads = snapshot(), [], []
        with exact_fp32():
            for k in range(n + 1):
                if k == n:
                    theta_n, ema_n = snapshot(), {m: ref.ema[m].clone() for m in ref.names}
                t, noise = step_draws(self.cfg, self.traffic, self.seed, k, self.latent_shape,
                                      self.device)
                out = ref.step(self.pool[k % len(self.pool)], t, noise, rows)
                losses.append(out["loss"])
                grads.append(out["grads"])
        return {"losses": losses[:n], "grads": grads[0], "change": change(theta0, theta_n),
                "ema": change(theta0, ema_n),
                "window_grads": grads[n], "window_change": change(theta_n, snapshot())}

    def compare(self, prog: dict, ref: dict) -> dict:
        """The compared numbers.  The losses' gap is printed beside them and
        not compared: neither the control nor a fault reads it far enough
        above sound runs to hold a limit between (PERF.md §2)."""
        moved, moved_w = _moved(ref["grads"]), _moved(ref["window_grads"])
        print(f"trainable tensors {len(ref['grads'])}, left out of the change gaps "
              f"{sum(not moved(n) for n in ref['grads'])} (window step "
              f"{sum(not moved_w(n) for n in ref['grads'])}); loss gap (not compared) "
              f"{loss_gap(prog, ref)!r}", file=sys.stderr)
        return {
            "grad_gap": _gap(prog["grads"], ref["grads"], lambda n: True),
            "change_gap": _gap(prog["change"], ref["change"], moved),
            "ema_gap": _gap(prog["ema"], ref["ema"], moved),
            "window_grad_gap": _gap(prog.get("window_grads", {}), ref["window_grads"],
                                    lambda n: True),
            "window_change_gap": _gap(prog.get("window_change", {}), ref["window_change"],
                                      moved_w),
        }

    def check(self, n_steps: int, fp8: bool = False) -> dict:
        ref = self.reference_readings(reference_models(self.cfg, self.seed, self.device))
        prog = (self.reference_readings(reference_models(self.cfg, self.seed, self.device,
                                                         fp8=True))
                if fp8 else self.readings)
        return self.compare(prog, ref)

    def check_half_batch(self) -> dict:
        """The check with the reference in the program's place training on
        the first half of each batch, the mean taken over those rows."""
        ref = self.reference_readings(reference_models(self.cfg, self.seed, self.device))
        half = self.reference_readings(reference_models(self.cfg, self.seed, self.device),
                                       rows=slice(0, self.traffic["batch"] // 2))
        return self.compare(half, ref)

    def end_to_end(self, window_s: float, items: int) -> dict:
        return {"train_samples_per_s": items / window_s}

    def counts(self, n_steps: int) -> dict:
        return {"steps": n_steps}

    def work_per_call(self) -> Work:
        """The work of one step: the encoders forward, the UNet forward and
        backward on the trainable parameters."""
        cfg, tr = self.cfg, self.traffic
        m = build21(cfg, device="meta")
        for name, p in m["unet"].named_parameters():
            p.requires_grad_(trainable(name, **cfg["freeze"]))
        B, meta = tr["batch"], torch.device("meta")
        empty = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=meta)
        S, C = tr["image_size"], tr["clip_image_size"]
        total = Work()
        with torch.no_grad():
            with counting(m["movq"]) as w:
                m["movq"].encode(empty(B, S, S, 3))
            total += w
            with counting(m["text_encoder"]) as w:
                m["text_encoder"](empty(B, tr["seq_len"], dt=torch.long),
                                  empty(B, tr["seq_len"], dt=torch.long))
            total += w
            with counting(m["clip_vision"]) as w:
                m["clip_vision"](empty(B, C, C, 3))
            total += w
        mc, te = cfg["model_config"], cfg["text_enc_params"]
        with counting(m["unet"], grad=True) as w:
            m["unet"](empty(*self.latent_shape), empty(B),
                      empty(B, tr["seq_len"], te["in_features"]),
                      empty(B, te["out_features"]), empty(B, mc["image_encoder_in_dim"]))
        return total + w
