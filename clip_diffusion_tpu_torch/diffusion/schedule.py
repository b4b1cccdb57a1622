"""Noise schedules and timestep respacing (numpy, float64 tables).

Own copy of `clip_diffusion_tpu.diffusion.schedule`: a linear beta schedule
over a base of `diffusion_steps` timesteps, respaced to `steps` sampler
steps by the `"ddim{N}"` rule, with `rescale_timesteps=True` mapping model
time into [0, 1000).
"""

from __future__ import annotations

import dataclasses
from typing import Set

import numpy as np


def linear_betas(num_timesteps: int) -> np.ndarray:
    """Linear beta schedule, scaled so any base length matches the 1000-step
    process."""
    scale = 1000.0 / num_timesteps
    return np.linspace(
        scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64
    )


def space_timesteps(num_timesteps: int, desired_count: int) -> Set[int]:
    """`"ddim{N}"` respacing: the stride whose range has exactly N elements."""
    for stride in range(1, num_timesteps):
        if len(range(0, num_timesteps, stride)) == desired_count:
            return set(range(0, num_timesteps, stride))
    raise ValueError(
        f"cannot create exactly {desired_count} steps with an integer stride"
    )


def base_diffusion_steps(steps: int) -> int:
    """Base process length rounded to a multiple of the sampler step count."""
    return (1000 // steps) * steps if steps < 1000 else steps


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Respaced Gaussian-diffusion tables, one row per sampler step."""

    num_steps: int
    base_steps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    timestep_map: np.ndarray
    scaled_timesteps: np.ndarray


def make_schedule(steps: int, base_steps: int | None = None) -> NoiseSchedule:
    """Build the respaced schedule for `steps` sampler steps (the kept
    process has the base process's marginals)."""
    if base_steps is None:
        base_steps = base_diffusion_steps(steps)
    base_betas = linear_betas(base_steps)
    base_alphas_cumprod = np.cumprod(1.0 - base_betas)

    use = sorted(space_timesteps(base_steps, steps))
    timestep_map = np.asarray(use, dtype=np.int32)

    last = 1.0
    new_betas = []
    for t in use:
        a = base_alphas_cumprod[t]
        new_betas.append(1.0 - a / last)
        last = a
    betas = np.asarray(new_betas, dtype=np.float64)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = (
        betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    )
    # log-variance clipped at t=0 because posterior variance is 0 there.
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    posterior_mean_coef1 = (
        betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    )
    posterior_mean_coef2 = (
        (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
    )

    scaled_timesteps = timestep_map.astype(np.float64) * (1000.0 / base_steps)

    return NoiseSchedule(
        num_steps=steps,
        base_steps=base_steps,
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=posterior_mean_coef1,
        posterior_mean_coef2=posterior_mean_coef2,
        timestep_map=timestep_map,
        scaled_timesteps=scaled_timesteps,
    )
