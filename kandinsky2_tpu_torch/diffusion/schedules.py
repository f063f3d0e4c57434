"""Host-side diffusion schedule construction (pure numpy, float64).

Semantics match the OpenAI guided-diffusion schedule family used by the
reference (reference: kandinsky2/model/gaussian_diffusion.py:17-61 and
kandinsky2/model/respace.py:24-96), but everything here is a pure function
that returns numpy arrays: the arrays are handed to the device once per
(schedule, respacing) configuration and become traced constants inside the
jitted sampling loops.  No torch, no classes-with-state.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "linear_betas",
    "cosine_betas",
    "named_betas",
    "space_timesteps",
    "respace_betas",
    "ddim_ladder",
    "ddim_sampling_parameters",
    "truncate_ladder",
]


def linear_betas(
    num_steps: int, linear_start: float = 0.0001, linear_end: float = 0.02
) -> np.ndarray:
    """Linear beta schedule (Ho et al.), scaled so it is invariant to step count.

    Reference semantics: gaussian_diffusion.py:27-35.
    """
    scale = 1000.0 / num_steps
    return np.linspace(
        scale * linear_start, scale * linear_end, num_steps, dtype=np.float64
    )


def cosine_betas(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """Cosine schedule from Nichol & Dhariwal (gaussian_diffusion.py:36-61)."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def named_betas(
    schedule_name: str,
    num_steps: int,
    linear_start: float = 0.0001,
    linear_end: float = 0.02,
) -> np.ndarray:
    if schedule_name == "linear":
        return linear_betas(num_steps, linear_start, linear_end)
    if schedule_name == "cosine":
        return cosine_betas(num_steps)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def _ddim_uniform_steps(num_ddim_steps: int, num_ddpm_steps: int) -> np.ndarray:
    """DDIM-paper uniform striding, +1 offset (respace.py:7-21)."""
    c = num_ddpm_steps // num_ddim_steps
    return np.asarray(list(range(0, num_ddpm_steps, c))) + 1


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Pick a subset of timesteps from the original process.

    ``section_counts`` is a list of per-section retained-step counts, a
    comma-separated string of the same, or "ddimN" for DDIM striding.  The
    original ``num_timesteps``-step ladder is split into ``len(section_counts)``
    contiguous sections (remainder steps go to the leading sections) and each
    section contributes ``section_counts[i]`` evenly spaced timesteps.

    Semantics match the reference's respacing (kandinsky2/model/respace.py:24-72)
    — in particular the evenly spaced offsets are produced by *accumulating* the
    fractional stride and rounding half-to-even, which this vectorized form
    reproduces bit-exactly via ``np.cumsum`` + ``np.round``.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            return set(
                _ddim_uniform_steps(int(section_counts[len("ddim") :]), num_timesteps)
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    counts = np.asarray(section_counts, dtype=np.int64)
    n_sections = len(counts)
    lengths = np.full(n_sections, num_timesteps // n_sections, dtype=np.int64)
    lengths[: num_timesteps % n_sections] += 1
    if np.any(lengths < counts):
        bad = int(np.argmax(lengths < counts))
        raise ValueError(
            f"respacing section {bad} spans only {lengths[bad]} original "
            f"timesteps but was asked to retain {counts[bad]}"
        )
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    kept: list[int] = []
    for start, length, count in zip(starts, lengths, counts):
        # Evenly spaced fractional positions over [0, length-1].  cumsum of a
        # constant stride reproduces the sequential accumulation the retained
        # checkpoints were trained/sampled with; np.round is half-to-even like
        # python's round().
        stride = (length - 1) / (count - 1) if count > 1 else 1.0
        offsets = np.round(np.cumsum(np.concatenate(([0.0], np.full(count - 1, stride)))))
        kept.extend((start + offsets.astype(np.int64)).tolist())
    return set(kept)


def respace_betas(betas: np.ndarray, use_timesteps) -> tuple[np.ndarray, np.ndarray]:
    """Recompute betas for a retained subset of timesteps (respace.py:83-97).

    Returns ``(new_betas, timestep_map)`` where ``timestep_map[i]`` is the
    original-process timestep corresponding to compressed step ``i``.
    """
    use_timesteps = set(use_timesteps)
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64), axis=0)
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, alpha_cumprod in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int64)


def ddim_ladder(
    num_ddim_steps: int,
    num_ddpm_steps: int = 1000,
    method: str = "uniform",
    init_step: int | None = None,
) -> np.ndarray:
    """Timestep ladder used by the standalone DDIM/PLMS samplers
    (samplers.py:33-51 plus the init_step truncation of samplers.py:11-18)."""
    if method == "uniform":
        steps = _ddim_uniform_steps(num_ddim_steps, num_ddpm_steps)
        if steps[-1] >= num_ddpm_steps:
            raise ValueError(
                f"DDIM ladder for {num_ddim_steps} steps reaches t="
                f"{steps[-1]} >= {num_ddpm_steps}; the +1-offset uniform "
                "striding (reference samplers.py:33-51) only supports step "
                "counts where (T//S)*ceil wraps below T — pick a count like "
                "4, 5, 10, 25, 50, 100"
            )
    elif method == "quad":
        steps = (
            np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps) ** 2
        ).astype(int) + 1
    else:
        raise NotImplementedError(f"unknown ddim discretization: {method}")
    return truncate_ladder(steps, init_step)


def truncate_ladder(timesteps: np.ndarray, init_step: int | None) -> np.ndarray:
    """img2img: keep only ladder entries <= init_step (samplers.py:11-18)."""
    if init_step is None:
        return timesteps
    return np.asarray([t for t in timesteps if t <= init_step])


def ddim_sampling_parameters(
    alphas_cumprod: np.ndarray, ddim_timesteps: np.ndarray, eta: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sigma/alpha/alpha_prev tables for the DDIM ladder (samplers.py:21-30)."""
    alphas = alphas_cumprod[ddim_timesteps]
    alphas_prev = np.asarray(
        [alphas_cumprod[0]] + alphas_cumprod[ddim_timesteps[:-1]].tolist()
    )
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )
    return sigmas, alphas, alphas_prev
