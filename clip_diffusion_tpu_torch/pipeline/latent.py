"""Latent-diffusion text-to-image pipeline with classifier-free guidance,
eager PyTorch.

Counterpart of `clip_diffusion_tpu.pipeline.latent`: LDM txt2img-f8-large
sampled with DDIM or PLMS under CFG, with optional inpainting, decoded by
the VQ-f8 first stage.

* LDM's own schedule (betas = linspace(sqrt 8.5e-4, sqrt 1.2e-2, 1000)^2
  in float64) and the CompVis DDIM tables: uniform timesteps t = i *
  (1000 // S) + 1, `alphas_prev[0] = alphas_cumprod[0]`, cast to float32.
  The UNet takes t as float32, not rescaled.
* CFG runs one UNet forward per step at batch 2B, interleaved per image
  (uncond, cond, uncond, cond, ...): eps = eps_u + g * (eps_c - eps_u).
* Conditioning is a context (B, S, D), or for a UNet with a label
  embedding (SDXL) a pair (context, vector (B, V)); CFG interleaves both.
* PLMS forces eta 0 and feeds the multistep eps into the DDIM formula.
* Inpainting (mask 1 keeps the init latent): before every step the known
  region is re-noised from the init latent to the step's level and pasted.

Randomness comes from a `draws` object: `initial_noise(shape)`,
`step_noise(i, shape)` (drawn only where sigma is not 0) and
`inpaint_noise(i, shape)`, with i the table index.  `pipeline.guided.
TorchDraws` draws them from a `torch.Generator` seeded for each draw and
row from its key, purpose and i; tests replay the JAX package's key
chain.  Nothing here takes a gradient: the public functions run under
`torch.inference_mode()`.

Each CFG step of `latent_sample` is a `latent.step` span
(`utils.profiling.annotate`) while a profile collects.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from clip_diffusion_tpu_torch.diffusion.sampling import init_history, plms_eps, push_history
from clip_diffusion_tpu_torch.utils.profiling import annotate

LDM_NUM_TIMESTEPS = 1000
LDM_LINEAR_START = 0.00085
LDM_LINEAR_END = 0.012


def ldm_alphas_cumprod() -> np.ndarray:
    betas = np.linspace(np.sqrt(LDM_LINEAR_START), np.sqrt(LDM_LINEAR_END),
                        LDM_NUM_TIMESTEPS, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ldm_ddim_tables(steps: int, eta: float, device=None) -> Dict[str, torch.Tensor]:
    """CompVis DDIMSampler tables for S uniform steps: `timesteps` (int64)
    and float32 `alphas`, `alphas_prev`, `sqrt_one_minus_alphas`, `sigmas`."""
    c = LDM_NUM_TIMESTEPS // steps
    timesteps = np.arange(steps) * c + 1
    acp = ldm_alphas_cumprod()
    alphas = acp[timesteps]
    alphas_prev = np.concatenate([[acp[0]], alphas[:-1]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    tables = {
        "alphas": alphas,
        "alphas_prev": alphas_prev,
        "sqrt_one_minus_alphas": np.sqrt(1 - alphas),
        "sigmas": sigmas,
    }
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in tables.items()}
    out["timesteps"] = torch.from_numpy(timesteps.astype(np.int64)).to(device)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class LatentPipeline:
    """unet(x NHWC, t (B,) float32, context (B, S, D)[, vector (B, V)]) ->
    eps NHWC float32; decode(latents NHWC) -> pixels in [-1, 1];
    encode(pixels) -> latents."""

    unet: Callable
    decode: Optional[Callable] = None
    encode: Optional[Callable] = None
    latent_channels: int = 4
    downsample: int = 8  # f8


def _interleave(a, b):
    """(B, ...) and (B, ...) -> (2B, ...) as a0, b0, a1, b1, ..."""
    return torch.stack([a, b], dim=1).reshape((2 * a.shape[0],) + tuple(a.shape[1:]))


def _parts(cond) -> tuple:
    """Conditioning as the UNet's arguments after t: (context,) or
    (context, vector)."""
    return (cond,) if torch.is_tensor(cond) else tuple(cond)


def _model_eps(pipe: LatentPipeline, x, t_val, ctx_c, ctx_u, guidance_scale: float):
    b = x.shape[0]
    t = torch.full((b,), t_val, dtype=torch.float32, device=x.device)
    if ctx_u is None:
        return pipe.unet(x, t, *_parts(ctx_c))
    cond = (_interleave(u, c) for u, c in zip(_parts(ctx_u), _parts(ctx_c)))
    eps2 = pipe.unet(_interleave(x, x), _interleave(t, t), *cond)
    eps2 = eps2.reshape((b, 2) + tuple(eps2.shape[1:]))
    eps_uc, eps_c = eps2[:, 0], eps2[:, 1]
    return eps_uc + guidance_scale * (eps_c - eps_uc)


@torch.inference_mode()
def latent_sample(
    pipe: LatentPipeline,
    draws,
    context_cond,
    context_uncond=None,
    batch_size: int = 1,
    height: int = 256,
    width: int = 256,
    steps: int = 50,
    guidance_scale: float = 5.0,
    eta: float = 0.0,
    mode: str = "ddim",
    order: int = 2,
    x0_latent=None,
    mask=None,
):
    """Run the CFG latent diffusion loop -> final latents (B, h, w, C)
    float32.  `context_cond`/`context_uncond`: (B, 77, D) text
    conditioning, or (context, vector) pairs; CFG is off when `context_uncond` is None or
    `guidance_scale` <= 0 (one forward per step).  `x0_latent` (B, h, w, C)
    with `mask` (B, h, w, 1) inpaints."""
    if mode not in ("ddim", "plms"):
        raise ValueError(f"unknown sample mode {mode!r}")
    if mode == "plms":
        eta = 0.0
    device = _parts(context_cond)[0].device
    tables = ldm_ddim_tables(steps, eta, device)
    timesteps = tables["timesteps"].tolist()
    shape = (batch_size, height // pipe.downsample, width // pipe.downsample,
             pipe.latent_channels)
    ctx_u = context_uncond if context_uncond is not None and guidance_scale > 0 else None
    inpaint = mask is not None and x0_latent is not None
    if inpaint:
        x0_latent = x0_latent.to(device=device, dtype=torch.float32)
        mask = mask.to(device=device, dtype=torch.float32)

    x = draws.initial_noise(shape).to(device=device, dtype=torch.float32)
    hist, count = init_history(shape, device), 0
    for i in range(steps - 1, -1, -1):
        with annotate("latent.step"):
            a, a_prev = tables["alphas"][i], tables["alphas_prev"][i]
            sqrt_1ma, sigma = tables["sqrt_one_minus_alphas"][i], tables["sigmas"][i]
            if inpaint:
                noise = draws.inpaint_noise(i, shape).to(device)
                x_orig = torch.sqrt(a) * x0_latent + sqrt_1ma * noise
                x = x_orig * mask + (1.0 - mask) * x
            eps = _model_eps(pipe, x, float(timesteps[i]), context_cond, ctx_u, guidance_scale)
            if mode == "plms":
                eps_use = plms_eps(eps, hist, count, order)
                hist = push_history(eps, hist)
                count += 1
            else:
                eps_use = eps
            pred_x0 = (x - sqrt_1ma * eps_use) / torch.sqrt(a)
            dir_xt = torch.sqrt(torch.clamp_min(1.0 - a_prev - sigma ** 2, 0.0)) * eps_use
            x = torch.sqrt(a_prev) * pred_x0 + dir_xt
            if eta > 0:
                x = x + sigma * draws.step_noise(i, shape).to(device)
    return x


@torch.inference_mode()
def img2img_start(pipe: LatentPipeline, image):
    """Encode init images (NHWC in [-1, 1]) into latents."""
    if pipe.encode is None:
        raise ValueError("pipeline has no first-stage encoder")
    return pipe.encode(image)


@torch.inference_mode()
def decode_latents(pipe: LatentPipeline, latents):
    """Latents -> NHWC pixels in [0, 1]."""
    if pipe.decode is None:
        raise ValueError("pipeline has no first-stage decoder")
    return torch.clamp((pipe.decode(latents) + 1.0) / 2.0, 0.0, 1.0)
