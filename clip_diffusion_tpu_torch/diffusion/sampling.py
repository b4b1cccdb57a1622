"""Diffusion sampling math (DDIM + PLMS helpers) on torch tensors.

Counterpart of `clip_diffusion_tpu.diffusion.sampling`: the
guided-diffusion `p_mean_variance` algebra, score conditioning, the DDIM
update with `eta`, the PLMS multistep helpers and Imagen dynamic
thresholding.  Images are NHWC in [-1, 1].  Per-step coefficients are 0-d
float32 tensors gathered from the schedule tables by a Python step index,
so the arithmetic happens in float32 as it does in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from clip_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule

# Maximum PLMS multistep order supported.
MAX_PLMS_ORDER = 4


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler knobs."""

    mode: str = "ddim"  # "ddim" | "plms"
    steps: int = 200
    eta: float = 0.8
    skip_timesteps: int = 0
    order: int = 2  # PLMS multistep order
    dynamic_thresholding_percentile: float = 0.995
    # "histogram": the JAX main path's two-level 4096-bin quantile
    # (ops/quantile.histogram_abs_quantile, a CUDA kernel on the GPU);
    # "sort": exact torch.quantile
    thresholding_method: str = "histogram"
    # guided_sample walks the schedule's cutout phases in chunks of
    # max_steps_per_dispatch steps, reading deadline and chunk_times between
    # them; the same result as the padded loop (pipeline/guided.py)
    phase_segmented: bool = False


def schedule_tables(sched: NoiseSchedule, device=None,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """NoiseSchedule -> dict of 1-D tensors (float tables cast to `dtype`)."""
    tables = {}
    for f in dataclasses.fields(sched):
        v = getattr(sched, f.name)
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if v.dtype.kind == "f":
                t = t.to(dtype)
            tables[f.name] = t.to(device)
    return tables


def _bcast(scalar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A gathered per-step scalar, shaped to broadcast over an NHWC batch."""
    return scalar.reshape((1,) * x.ndim).to(x.dtype)


def predict_xstart_from_eps(x, eps, tables, step: int):
    c1 = _bcast(tables["sqrt_recip_alphas_cumprod"][step], x)
    c2 = _bcast(tables["sqrt_recipm1_alphas_cumprod"][step], x)
    return c1 * x - c2 * eps


def predict_eps_from_xstart(x, pred_xstart, tables, step: int):
    c1 = _bcast(tables["sqrt_recip_alphas_cumprod"][step], x)
    c2 = _bcast(tables["sqrt_recipm1_alphas_cumprod"][step], x)
    return (c1 * x - pred_xstart) / c2


def learned_log_variance(var_raw, tables, step: int):
    """learn_sigma head: interpolate between the posterior (min) and beta
    (max) log-variance with the model's [-1, 1] output."""
    min_log = _bcast(tables["posterior_log_variance_clipped"][step], var_raw)
    max_log = _bcast(torch.log(tables["betas"][step]), var_raw)
    frac = (var_raw + 1.0) / 2.0
    return frac * max_log + (1.0 - frac) * min_log


def apply_threshold(x_start: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Clamp each batch element to its (B,) threshold, floored at 1, and
    rescale into [-1, 1]."""
    b = x_start.shape[0]
    thresh = torch.clamp_min(thresh, 1.0)
    thresh = thresh.reshape((b,) + (1,) * (x_start.ndim - 1)).to(x_start.dtype)
    return torch.clamp(x_start, -thresh, thresh) / thresh


def dynamic_threshold(x_start: torch.Tensor, percentile: float) -> torch.Tensor:
    """Imagen dynamic thresholding with the exact |x| quantile (linear
    interpolation, as `jnp.quantile`)."""
    b = x_start.shape[0]
    flat = torch.abs(x_start.reshape(b, -1)).to(torch.float32)
    return apply_threshold(x_start, torch.quantile(flat, percentile, dim=-1))


def condition_eps(eps, grad, tables, step: int):
    """Score conditioning: eps - sqrt(1 - alpha_bar_t) * grad."""
    return eps - _bcast(tables["sqrt_one_minus_alphas_cumprod"][step], eps) * grad


def q_sample(x_start, tables, step: int, noise):
    """Diffuse a clean image to respaced step `step`."""
    c1 = _bcast(tables["sqrt_alphas_cumprod"][step], x_start)
    c2 = _bcast(tables["sqrt_one_minus_alphas_cumprod"][step], x_start)
    return c1 * x_start + c2 * noise


def ddim_step(x, eps, pred_xstart, tables, step: int, eta: float,
              noise: Optional[torch.Tensor]):
    """One DDIM update x_t -> x_{t-1} at respaced index `step`.  Noise is
    suppressed at the final step (step == 0), where `noise` may be None."""
    acp = _bcast(tables["alphas_cumprod"][step], x)
    acp_prev = _bcast(tables["alphas_cumprod_prev"][step], x)
    sigma = (
        eta
        * torch.sqrt((1.0 - acp_prev) / (1.0 - acp))
        * torch.sqrt(1.0 - acp / acp_prev)
    )
    mean = (
        pred_xstart * torch.sqrt(acp_prev)
        + torch.sqrt(torch.clamp_min(1.0 - acp_prev - sigma**2, 0.0)) * eps
    )
    if step > 0:
        return mean + sigma * noise
    return mean


# Adams-Bashforth coefficient rows, padded to 4 taps; row k uses k+1 history
# entries (current eps first).
_PLMS_COEFS = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0],
        [23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0],
        [55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0],
    ],
    dtype=np.float32,
)


def plms_eps(eps, eps_history, history_count: int, order: int):
    """Combine the current eps with the history (newest first,
    (MAX_PLMS_ORDER-1, *eps.shape)) into the multistep eps'."""
    k = min(history_count, order - 1)
    coefs = torch.from_numpy(_PLMS_COEFS[k]).to(eps.device, eps.dtype)
    stacked = torch.cat([eps[None], eps_history], dim=0)
    return torch.sum(coefs.reshape((MAX_PLMS_ORDER,) + (1,) * eps.ndim) * stacked, dim=0)


def push_history(eps, eps_history):
    """Shift the newest eps into the history ring (newest first)."""
    return torch.cat([eps[None], eps_history[:-1]], dim=0)


def plms_step(x, eps_prime, tables, step: int):
    """Deterministic DDIM-form transfer with the multistep eps'."""
    acp_prev = _bcast(tables["alphas_cumprod_prev"][step], x)
    pred_xstart = predict_xstart_from_eps(x, eps_prime, tables, step)
    return pred_xstart * torch.sqrt(acp_prev) + torch.sqrt(1.0 - acp_prev) * eps_prime


def init_history(shape, device=None, dtype=torch.float32):
    return torch.zeros((MAX_PLMS_ORDER - 1,) + tuple(shape), device=device, dtype=dtype)
