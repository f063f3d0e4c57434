"""The optimizers a training YAML's ``optim_params`` name, and the
decoder's freeze mask.

``optimizer_from_config(optim_params)`` reads ``{"name": ..., "params":
{...}}`` as the JAX CLIs do (``get_obj_from_str(name)(**params)``) and
returns ``params -> torch.optim.Optimizer``.  Four names build, each a
counterpart of optax 0.2.6 (``optax/_src/alias.py``) with optax's
arguments and defaults, step for step in optax's chain order:

* ``optax.adafactor`` -> ``Adafactor``: ``factorized.scale_by_factored_rms``
  (for a tensor whose two largest dims are both at least
  ``min_dim_size_to_factor``, row and column means of g² + eps decayed with
  1 − (step − decay_offset + 1)^−decay_rate, and the update
  g · (v_row / mean(v_row))^−½ · v_col^−½; other tensors keep a full v and
  get g · v^−½), then ``clip_by_block_rms`` (u / max(1, rms(u) /
  clipping_threshold)), the learning rate, ``scale_by_param_block_rms``
  (u · max(rms(p), 1e-3) on the parameter before the step), the momentum
  ``ema(momentum, debias=False)`` kept in ``dtype_momentum``, then
  ``add_decayed_weights`` (u + weight_decay_rate · p, after the learning
  rate and so not scaled by it) and p ← p − u.
* ``optax.adam`` and ``optax.adamw`` -> ``Adam``: ``scale_by_adam`` (the
  moments b·m + (1 − b)·g and b·v + (1 − b)·g², optax's bias correction,
  u = m̂ / (√(v̂ + eps_root) + eps), the first moment kept in ``mu_dtype``,
  and with ``nesterov`` optax's m̂ = b1·m / (1 − b1^(t+1)) + (1 − b1)·g /
  (1 − b1^t), which is not ``torch.optim.NAdam``), adamw's
  ``add_decayed_weights`` (u + weight_decay · p, default 1e-4, where
  ``torch.optim.AdamW`` decays by 1e-2) and p ← p − lr · u.
* ``optax.sgd`` -> ``SGD``: ``trace`` (t ← g + momentum · t, the update
  g + momentum · t with ``nesterov``, t kept in ``accumulator_dtype``) and
  p ← p − lr · u.

Dtype arguments are names (``"bfloat16"``, ``"float32"``) as a YAML gives
them to ``jnp.dtype``.  ``mask`` and ``weight_decay_mask`` take a tree of
booleans matched against the JAX parameter tree, which the port does not
have: they raise.  So do another name and an argument that optax does not
take (TypeError, as optax raises), before anything is built.

``Adam`` and ``SGD`` step all their tensors with ``torch._foreach_*``
ops; ``Adafactor``'s factored statistics are per tensor, one pass over
the tensors a step.  A parameter that holds a slice of a whole tensor
(``parallel/fsdp.py``'s ``mesh_cuts``) is stepped as its whole tensor
would be: the elementwise steps (Adam, SGD, the EMA) run on the slice as
they are, while Adafactor decides the factored dims on the whole shape and
takes each of its means over a cut dim (the row and column means of g²,
the row factor's normaliser, the RMS of the update and of the parameter)
as a ``psum`` of the slices' sums over the whole count, three flat
``psum``s a step for all the sliced tensors.  ``torch.optim.Adafactor``
follows another recipe (relative step sizes, its own decay and epsilons),
so it is not used.  The state of each tensor is ``step`` and its moments;
a moment kept in another dtype than its parameter's keeps it through
``load_state_dict`` (which would cast it to the parameter's).

Layouts differ (torch OI / OIHW against flax IO / HWIO), but the factored
pair is always the two largest dims, so a tensor factors over the same
axes in both; only where those two dims are equal can the row and column
roles swap, which changes nothing but rounding.

``decoder_freeze_mask`` is ``kandinsky2_tpu/train/train_unclip.py``'s, on
the port's parameter names (the reference's state_dict names): the
freeze applies as ``requires_grad_(False)``, and the optimizer holds only
the trainable parameters (the counterpart of ``masked_optimizer``).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.collectives import psum
from ..parallel.fsdp import cuts, full_shape

RES_MARKERS = ("in_layers", "h_upd", "x_upd", "emb_layers", "out_layers")
ATTN_MARKERS = ("proj_out", "qkv")


def decoder_freeze_mask(module: torch.nn.Module, freeze_resblocks: bool = False,
                        freeze_attention: bool = False) -> dict[str, bool]:
    """{parameter name: trainable} with freeze_decoder's name rules
    (train_utils/utils.py:212-229)."""

    def trainable(name: str) -> bool:
        name = name.lower()
        if any(m in name for m in RES_MARKERS):
            return not freeze_resblocks
        if any(m in name for m in ATTN_MARKERS):
            return not freeze_attention
        return True

    return {name: trainable(name) for name, _ in module.named_parameters()}


def apply_freeze_mask(module: torch.nn.Module, mask: dict[str, bool]) -> list:
    """Set ``requires_grad`` from ``mask``; returns the trainable
    parameters in ``named_parameters`` order."""
    params = []
    for name, p in module.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return params


# --- helpers ---------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16,
           # JAX without x64 canonicalizes float64 to float32
           "float64": torch.float32}


def dtype_name(dtype) -> Optional[str]:
    """A dtype argument (None, a name as a YAML gives it, or a torch dtype)
    as the name the optimizer keeps; TypeError for anything else, as
    ``jnp.dtype`` raises."""
    if dtype is None:
        return None
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"data type {dtype!r} not understood (one of {sorted(_DTYPES)})")
    return str(_DTYPES[name]).removeprefix("torch.")


def _dtype(name: Optional[str], like: torch.Tensor) -> torch.dtype:
    return like.dtype if name is None else _DTYPES[name]


def _bias_correction(decay: float, count: int) -> float:
    """optax's 1 − decay^count, computed in fp32 as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _factored_dims(shape, factored: bool = True,
                   min_dim_size_to_factor: int = 128) -> Optional[tuple[int, int]]:
    """(second largest, largest) dim if both are big enough, else None."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _weak(decay: float, dtype: torch.dtype) -> float:
    """``decay`` as JAX applies it to a moment kept in ``dtype``: a Python
    scalar takes the array's dtype (bf16's 0.9 is 0.8984375), and the jitted
    product is formed in fp32 beside the fp32 update."""
    return torch.tensor(decay, dtype=dtype).item()


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class _Mean:
    __slots__ = ("value",)


class _SlicedMeans:
    """Means of slices over dims of their whole tensors: a local mean where
    no reduced dim is cut, else the local sum, kept until :meth:`flush`
    ``psum``s every pending sum over the same axes in one flat call and
    divides each by its whole count."""

    def __init__(self):
        self.pending = []

    def mean(self, x, dim, cut: dict, whole, keepdim: bool = False) -> _Mean:
        """The mean of ``x`` over ``dim`` (None: every dim); ``cut`` {dim:
        axis} and ``whole`` (the whole shape) describe ``x``'s slice."""
        out = _Mean()
        dims = tuple(range(x.dim())) if dim is None else (dim,)
        axes = tuple(cut[d] for d in dims if d in cut)
        if not axes:
            out.value = x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
            return out
        part = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
        self.pending.append((out, part, axes, math.prod(whole[d] for d in dims)))
        return out

    def flush(self) -> None:
        groups = {}
        for item in self.pending:
            key = (tuple(ax.name for ax in item[2]), item[1].dtype)
            groups.setdefault(key, []).append(item)
        for items in groups.values():
            flat = torch.cat([part.reshape(-1) for _, part, _, _ in items])
            for ax in items[0][2]:
                flat = psum(flat, ax)
            for (out, part, _, count), s in zip(
                    items, flat.split([part.numel() for _, part, _, _ in items])):
                out.value = s.view_as(part) / count
        self.pending = []


class _OptaxOptimizer(torch.optim.Optimizer):
    """A torch optimizer whose moments may be kept in another dtype than
    their parameter's, and keep it through ``load_state_dict``."""

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        for p, i in zip(params, ids):
            for key, saved in state_dict["state"].get(i, {}).items():
                now = self.state[p].get(key)
                if torch.is_tensor(saved) and now.dtype != saved.dtype:
                    self.state[p][key] = now.to(saved.dtype)

    def _stepping(self, group) -> list:
        return [p for p in group["params"] if p.grad is not None]


# --- optax.adafactor ---------------------------------------------------------

class Adafactor(_OptaxOptimizer):
    """``optax.adafactor`` as a torch optimizer, with optax's arguments and
    defaults; the state per tensor is ``step``, either ``v_row`` and
    ``v_col`` or ``v`` (in the parameter's dtype) and, with ``momentum``,
    ``ema`` in ``dtype_momentum``."""

    def __init__(self, params, learning_rate: Optional[float] = None,
                 min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
                 decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0,
                 momentum: Optional[float] = None, dtype_momentum="float32",
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
                 factored: bool = True):
        super().__init__(params, dict(
            learning_rate=learning_rate, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            dtype_momentum=dtype_name(dtype_momentum),
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor takes no closure")
        for group in self.param_groups:
            params = self._stepping(group)
            for p in params:
                if not cuts(p):
                    p.sub_(self._update(p, p.grad, group))
            sliced = [p for p in params if cuts(p)]
            if sliced:
                self._step_sliced(sliced, group)

    def _begin(self, p, group):
        """(state, factored dims on the whole shape, keep, mix) of ``p``'s
        step, its state made on the first."""
        state = self.state[p]
        dims = _factored_dims(full_shape(p), group["factored"],
                              group["min_dim_size_to_factor"])
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(p).mean(d0)
                state["v_col"] = torch.zeros_like(p).mean(d1)
            if group["momentum"] is not None:
                state["ema"] = torch.zeros_like(p, dtype=_DTYPES[group["dtype_momentum"]])
        # optax's schedule 1 - (step - offset + 1)^-rate, in fp32 as optax
        # computes it (NaN where step - offset + 1 <= 0, as in optax)
        with np.errstate(all="ignore"):
            t = np.float32(state["step"] - group["decay_offset"] + 1)
            decay = np.float32(1) - t ** np.float32(-group["decay_rate"])
        return state, dims, float(decay), float(np.float32(1) - decay)

    def _update(self, p, grad, group) -> torch.Tensor:
        state, dims, keep, mix = self._begin(p, group)
        grad_sqr = grad * grad + group["eps"]
        if dims is None:
            v = state["v"].mul_(keep).add_(grad_sqr, alpha=mix)
            u = grad * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(keep).add_(grad_sqr.mean(d0), alpha=mix)
            v_col = state["v_col"].mul_(keep).add_(grad_sqr.mean(d1), alpha=mix)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
            u = grad * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        state["step"] += 1
        return self._finish(p, u, state, group,
                            _rms(u) if group["clipping_threshold"] is not None else None,
                            _rms(p) if group["multiply_by_parameter_scale"] else None)

    def _step_sliced(self, params, group) -> None:
        """The step of parameters that hold slices (``parallel/fsdp.py``):
        ``_update``'s arithmetic on the slice, each mean over a cut dim the
        sum over the slice, ``psum``'d over the cut's axes, over the whole
        count.  Three flat ``psum``s a step: the g² row and column sums with
        Σp², the row factor's normaliser, then Σu²."""
        means = _SlicedMeans()
        jobs = []
        for p in params:
            state, dims, keep, mix = self._begin(p, group)
            cut, whole = dict(cuts(p)), full_shape(p)
            grad_sqr = p.grad * p.grad + group["eps"]
            job = {"p": p, "state": state, "dims": dims, "keep": keep, "mix": mix,
                   "cut": cut, "whole": whole, "grad_sqr": grad_sqr}
            if dims is not None:
                d1, d0 = dims
                job["row"] = means.mean(grad_sqr, d0, cut, whole)
                job["col"] = means.mean(grad_sqr, d1, cut, whole)
            if group["multiply_by_parameter_scale"]:
                job["p_ms"] = means.mean(p * p, None, cut, whole)
            jobs.append(job)
        means.flush()
        for job in jobs:
            state, dims, grad = job["state"], job["dims"], job["p"].grad
            if dims is None:
                v = state["v"].mul_(job["keep"]).add_(job["grad_sqr"], alpha=job["mix"])
                job["u"] = grad * v.rsqrt()
                continue
            d1, d0 = dims
            state["v_row"].mul_(job["keep"]).add_(job["row"].value, alpha=job["mix"])
            state["v_col"].mul_(job["keep"]).add_(job["col"].value, alpha=job["mix"])
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_cut = {d - (d > d0): ax for d, ax in job["cut"].items() if d != d0}
            row_whole = job["whole"][:d0] + job["whole"][d0 + 1:]
            job["row_mean"] = means.mean(state["v_row"], reduced_d1, row_cut, row_whole,
                                         keepdim=True)
        means.flush()
        for job in jobs:
            state, dims, grad = job["state"], job["dims"], job["p"].grad
            if dims is not None:
                d1, d0 = dims
                row_factor = (state["v_row"] / job["row_mean"].value).rsqrt()
                col_factor = state["v_col"].rsqrt()
                job["u"] = grad * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            state["step"] += 1
            if group["clipping_threshold"] is not None:
                job["u_ms"] = means.mean(job["u"] * job["u"], None, job["cut"],
                                         job["whole"])
        means.flush()
        for job in jobs:
            rms = lambda key: torch.sqrt(job[key].value) if key in job else None
            job["p"].sub_(self._finish(job["p"], job["u"], job["state"], group,
                                       rms("u_ms"), rms("p_ms")))

    @staticmethod
    def _finish(p, u, state, group, rms_u, rms_p) -> torch.Tensor:
        """The update after the second-moment scaling: the clip (``rms_u``
        the RMS of ``u``), the learning rate, the parameter scale (``rms_p``
        that of ``p`` before the step), the momentum and the weight decay."""
        if group["clipping_threshold"] is not None:
            u = u / torch.clamp(rms_u / group["clipping_threshold"], min=1.0)
        if group["learning_rate"] is not None:
            u = u * group["learning_rate"]
        if group["multiply_by_parameter_scale"]:
            u = u * torch.clamp(rms_p, min=1e-3)
        if group["momentum"] is not None:
            m, ema = group["momentum"], state["ema"]
            wide = torch.promote_types(u.dtype, ema.dtype)
            u = u * (1 - m) + ema.to(wide) * _weak(m, ema.dtype)
            ema.copy_(u)
        if group["weight_decay_rate"] is not None:
            u = u + group["weight_decay_rate"] * p
        return u


# --- optax.adam / optax.adamw --------------------------------------------------

class Adam(_OptaxOptimizer):
    """``optax.adam`` (``weight_decay`` None) or ``optax.adamw`` as a torch
    optimizer; the state per tensor is ``step``, ``mu`` (in ``mu_dtype``)
    and ``nu``."""

    def __init__(self, params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype=None,
                 weight_decay: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, dict(
            learning_rate=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
            mu_dtype=dtype_name(mu_dtype), weight_decay=weight_decay,
            nesterov=bool(nesterov)))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam takes no closure")
        for group in self.param_groups:
            by_count = defaultdict(list)
            for p in self._stepping(group):
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=_dtype(group["mu_dtype"], p))
                    state["nu"] = torch.zeros_like(p)
                by_count[state["step"]].append(p)
            for count, params in by_count.items():
                self._step(params, count + 1, group)

    def _step(self, params: list, count: int, group) -> None:
        grads = [p.grad for p in params]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        b1, b2 = group["b1"], group["b2"]
        if all(m.dtype == g.dtype for m, g in zip(mus, grads)):
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            mu = mus
        else:  # the moment in mu_dtype: the step uses it, in the wider dtype, before the cast
            mu = torch._foreach_mul([g.to(torch.promote_types(g.dtype, m.dtype))
                                     for g, m in zip(grads, mus)], 1 - b1)
            torch._foreach_add_(mu, mus, alpha=_weak(b1, mus[0].dtype))
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        if group["nesterov"]:
            u = torch._foreach_div(mu, _bias_correction(b1, count + 1))
            torch._foreach_mul_(u, b1)
            g_hat = torch._foreach_div(grads, _bias_correction(b1, count))
            torch._foreach_mul_(g_hat, 1 - b1)
            torch._foreach_add_(u, g_hat)
            del g_hat
        else:
            u = torch._foreach_div(mu, _bias_correction(b1, count))
        denom = torch._foreach_div(nus, _bias_correction(b2, count))
        if group["eps_root"]:
            torch._foreach_add_(denom, group["eps_root"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(u, denom)
        del denom
        if mu is not mus:
            torch._foreach_copy_(mus, mu)
        if group["weight_decay"] is not None:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, u, alpha=-group["learning_rate"])
        for p in params:
            self.state[p]["step"] = count


# --- optax.sgd -----------------------------------------------------------------

class SGD(_OptaxOptimizer):
    """``optax.sgd`` as a torch optimizer; with ``momentum`` the state per
    tensor is ``trace`` (in ``accumulator_dtype``), without it none."""

    def __init__(self, params, learning_rate: float, momentum: Optional[float] = None,
                 nesterov: bool = False, accumulator_dtype=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, momentum=momentum, nesterov=bool(nesterov),
            accumulator_dtype=dtype_name(accumulator_dtype)))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD takes no closure")
        for group in self.param_groups:
            params = self._stepping(group)
            if not params:
                continue
            grads = [p.grad for p in params]
            m = group["momentum"]
            if m is None:
                torch._foreach_add_(params, grads, alpha=-group["learning_rate"])
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["trace"] = torch.zeros_like(
                        p, dtype=_dtype(group["accumulator_dtype"], p))
            traces = [self.state[p]["trace"] for p in params]
            if all(t.dtype == g.dtype for t, g in zip(traces, grads)):
                torch._foreach_mul_(traces, m)
                torch._foreach_add_(traces, grads)
                trace = traces
            else:  # the trace in accumulator_dtype: the step uses it before the cast
                trace = torch._foreach_add(grads, traces, alpha=_weak(m, traces[0].dtype))
            u = torch._foreach_add(grads, trace, alpha=m) if group["nesterov"] else trace
            if trace is not traces:
                torch._foreach_copy_(traces, trace)
            torch._foreach_add_(params, u, alpha=-group["learning_rate"])


# --- the YAML's optim_params -----------------------------------------------------

def _no_mask(name: str, mask) -> None:
    if mask is not None:
        raise NotImplementedError(
            f"{name}: a YAML gives it as a tree of booleans over the JAX parameter "
            "tree, which the port has no tree to match against")


def _adafactor(learning_rate=None, min_dim_size_to_factor=128, decay_rate=0.8,
               decay_offset=0, multiply_by_parameter_scale=True, clipping_threshold=1.0,
               momentum=None, dtype_momentum="float32", weight_decay_rate=None,
               eps=1e-30, factored=True, weight_decay_mask=None):
    _no_mask("weight_decay_mask", weight_decay_mask)
    kw = dict(locals())
    kw.pop("weight_decay_mask")
    kw["dtype_momentum"] = dtype_name(dtype_momentum)
    return Adafactor, kw


def _adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *,
          nesterov=False):
    return Adam, dict(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
                      eps_root=eps_root, mu_dtype=dtype_name(mu_dtype), nesterov=nesterov)


def _adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
           weight_decay=1e-4, mask=None, *, nesterov=False):
    _no_mask("mask", mask)
    cls, kw = _adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)
    return cls, dict(kw, weight_decay=weight_decay)


def _sgd(learning_rate, momentum=None, nesterov=False, accumulator_dtype=None):
    return SGD, dict(learning_rate=learning_rate, momentum=momentum, nesterov=nesterov,
                     accumulator_dtype=dtype_name(accumulator_dtype))


# each with optax 0.2.6's signature, so that an argument optax would refuse
# raises TypeError here too
OPTIMIZERS = {"optax.adafactor": _adafactor, "optax.adam": _adam,
              "optax.adamw": _adamw, "optax.sgd": _sgd}


def optimizer_from_config(optim_params: dict) -> Callable:
    """The optimizer factory (params -> optimizer) a training YAML's
    ``optim_params`` ({"name": ..., "params": {...}}) names.  Raises,
    before anything is built, NotImplementedError for another name or a
    ``mask`` / ``weight_decay_mask``, and TypeError for an argument that
    optax does not take."""
    name = optim_params["name"]
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name}: the port has {', '.join(OPTIMIZERS)}")
    cls, kw = OPTIMIZERS[name](**(optim_params.get("params") or {}))
    return lambda params: cls(params, **kw)
