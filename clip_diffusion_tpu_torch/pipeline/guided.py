"""The CLIP-guided diffusion pipeline, eager PyTorch.

Counterpart of `clip_diffusion_tpu.pipeline.guided`.  Each step:

1. one UNet forward at (x, t), shared by the sampler and the guidance loss;
2. the mixed prediction `denoised = pred_x0 * s + x * (1 - s)` with
   s = sqrt(1 - alpha_bar_t) is cut into overview/inner cutouts (shared by
   same-resolution perceptors), augmented and scored by every CLIP tower
   against the prompt embeddings (squared spherical distance) and, where a
   perceptor has one, by its aesthetic head; plus the TV and range losses
   on `denoised` and, with an init image, LPIPS and MS-SSIM against it;
3. the gradient of that loss with respect to x alone
   (`torch.autograd.grad`; every parameter has requires_grad=False), then
   the NaN guard and the RMS clamp;
4. dynamic thresholding of pred_x0 on the sampler path only (the loss saw
   the unthresholded mix), and the conditioned DDIM or PLMS update.

With an init image the trajectory starts from it diffused to the first
executed step (`skip_timesteps` steps are skipped).

The CLIP towers run in chunks of `clip_cut_chunk` cuts along the cut axis.
Each chunk's backward runs as soon as its loss is known, giving the
gradient with respect to the normalized cuts; one final backward carries
those gradients, with the image losses, through the cutouts and the UNet
to x.  The gradient is the one-backward gradient, and no tower holds more
than one chunk's activations.

Randomness comes from a `draws` object: `initial_noise`, `step_noise` and
`cutouts` (the per-slot crop, flip, noise, affine, gray and jitter values).
`TorchDraws` draws them, and the latent pipeline's `inpaint_noise`, from a
`torch.Generator` on the device; tests pass an object that replays the JAX
package's key chain.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.diffusion.sampling import (
    SamplerConfig,
    condition_eps,
    ddim_step,
    dynamic_threshold,
    init_history,
    plms_eps,
    plms_step,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    push_history,
    q_sample,
    schedule_tables,
)
from clip_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule
from clip_diffusion_tpu_torch.guidance.cutouts import (
    CutDraws,
    CutoutSpec,
    draw_cutouts,
    make_cutouts_batch,
)
from clip_diffusion_tpu_torch.guidance.losses import (
    l2_normalize,
    rgb_range_loss,
    square_spherical_distance_loss,
    structural_dissimilarity_loss,
    total_variational_loss,
)
from clip_diffusion_tpu_torch.models.clip.model import clip_normalize
from clip_diffusion_tpu_torch.models.unet import split_model_output
from clip_diffusion_tpu_torch.ops.quantile import dynamic_threshold_fast


@dataclasses.dataclass(frozen=True)
class Perceptor:
    """One CLIP model wired for guidance, with its prompt embeddings:
    (P, D) shared by the batch or (B, P, D) per image, and their weights
    (P,) or (B, P)."""

    name: str
    embed_image: Callable  # CLIP-normalized (N, S, S, 3) -> (N, D)
    input_resolution: int
    text_embeddings: torch.Tensor
    text_weights: torch.Tensor
    aesthetic_fn: Optional[Callable] = None  # L2-normalized (N, D) -> (N, 1)


@dataclasses.dataclass(frozen=True, eq=False)
class GuidedPipeline:
    unet: Callable  # (x NHWC, t (B,)) -> (B, H, W, 2C)
    perceptors: Tuple[Perceptor, ...]
    config: Config
    sampler: SamplerConfig
    schedule: NoiseSchedule
    device: torch.device
    lpips_fn: Optional[Callable] = None  # (x, y) NHWC in [-1, 1] -> (B,)
    use_init_losses: bool = False  # LPIPS/MS-SSIM terms against the init image

    def cutout_spec(self, resolution: int) -> CutoutSpec:
        cs = self.config.cutout_schedules
        return CutoutSpec(cut_size=resolution, max_overview=cs.max_overview_cuts,
                          max_inner=cs.max_inner_cuts)


class TorchDraws:
    """The pipeline's random draws from one `torch.Generator` on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device).manual_seed(int(seed))

    def initial_noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def step_noise(self, step: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def inpaint_noise(self, step: int, shape) -> torch.Tensor:
        """The latent pipeline's re-noise of the known region."""
        return torch.randn(shape, generator=self.gen, device=self.device)

    def cutouts(self, step: int, group: int, batch: int, repeats: int,
                spec: CutoutSpec, n_ov: int, n_in: int) -> CutDraws:
        return draw_cutouts(self.gen, batch, repeats, spec, n_ov, n_in, self.device)


def schedule_index(schedule: NoiseSchedule, step: int) -> int:
    """Respaced step -> dense 1000-basis schedule index: 999 - floor(t) of
    the float32 rescaled timestep."""
    t_scaled = np.float32(schedule.scaled_timesteps[step])
    return int(np.clip(999 - int(np.floor(t_scaled)), 0, 999))


def perceptor_groups(pipe: GuidedPipeline) -> List[Tuple[int, List[int]]]:
    """(resolution, perceptor indices) per cutout batch, in order."""
    if not pipe.config.share_cutouts_across_perceptors:
        return [(p.input_resolution, [i]) for i, p in enumerate(pipe.perceptors)]
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(pipe.perceptors):
        groups.setdefault(p.input_resolution, []).append(i)
    return list(groups.items())


def _prompt_distance(embs, perc: Perceptor):
    """(B, n, D) cut embeddings -> (B, n) prompt-weighted spherical distance."""
    te, tw = perc.text_embeddings, perc.text_weights
    if te.ndim == 3:
        d = square_spherical_distance_loss(embs[:, :, None, :], te[:, None, :, :])
        return torch.sum(d * tw[:, None, :], dim=-1)
    d = square_spherical_distance_loss(embs[:, :, None, :], te[None, None, :, :])
    return torch.sum(d * tw[None, None, :], dim=-1)


def _cut_gradient(pipe: GuidedPipeline, members, normed, weights):
    """Gradient of the members' CLIP and aesthetic losses with respect to
    the normalized cuts (B, N, S, S, 3), one tower chunk at a time."""
    cfg = pipe.config
    b, n = normed.shape[:2]
    tail = normed.shape[2:]
    chunk = cfg.clip_cut_chunk if cfg.clip_cut_chunk > 0 else n
    grad = torch.zeros(normed.shape, dtype=torch.float32, device=normed.device)
    for pi in members:
        perc = pipe.perceptors[pi]
        for i in range(0, n, chunk):
            leaf = normed[:, i:i + chunk].detach().requires_grad_(True)
            embs = perc.embed_image(leaf.reshape((-1,) + tail)).reshape(b, leaf.shape[1], -1)
            w = weights[:, i:i + chunk]
            loss = cfg.clip_guidance_scale * torch.sum(w * _prompt_distance(embs, perc))
            if perc.aesthetic_fn is not None and cfg.aesthetic_scale > 0:
                scores = perc.aesthetic_fn(l2_normalize(embs, dim=-1))[..., 0]
                loss = loss - cfg.aesthetic_scale * torch.sum(w * scores)
            (g,) = torch.autograd.grad(loss, leaf)
            grad[:, i:i + chunk] += g
    return grad.to(normed.dtype)


def guidance_gradient(pipe: GuidedPipeline, tables, x, step: int, draws,
                      init_image: Optional[torch.Tensor] = None):
    """d(loss)/dx at respaced step `step` -> (grad, pred_x0), both (B,H,W,3).
    `init_image` (1, H, W, 3) in [-1, 1] is the target of the LPIPS and
    MS-SSIM terms when `pipe.use_init_losses` is on."""
    cfg = pipe.config
    b = x.shape[0]
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        t = tables["scaled_timesteps"][step].expand(b)
        eps, _ = split_model_output(pipe.unet(x, t))
        pred_x0 = predict_xstart_from_eps(x, eps, tables, step)
        factor = tables["sqrt_one_minus_alphas_cumprod"][step].to(x.dtype)
        denoised = pred_x0 * factor + x * (1.0 - factor)

        outputs, out_grads = [], []
        image_loss = None
        if cfg.denoise_scale > 0:
            image_loss = cfg.denoise_scale * torch.sum(total_variational_loss(denoised))
        if cfg.range_scale > 0:
            term = cfg.range_scale * torch.sum(rgb_range_loss(denoised))
            image_loss = term if image_loss is None else image_loss + term
        if pipe.use_init_losses:
            if pipe.lpips_fn is not None and cfg.LPIPS_scale > 0:
                term = cfg.LPIPS_scale * torch.sum(pipe.lpips_fn(denoised, init_image))
                image_loss = term if image_loss is None else image_loss + term
            if cfg.MS_SSIM_scale > 0:
                term = cfg.MS_SSIM_scale * structural_dissimilarity_loss(denoised, init_image)
                image_loss = term if image_loss is None else image_loss + term
        if image_loss is not None:
            outputs.append(image_loss)
            out_grads.append(torch.ones_like(image_loss))

        if cfg.clip_guidance_scale > 0:
            idx = schedule_index(pipe.schedule, step)
            ov_t, in_t, power_t, gray_t = cfg.cutout_schedules.as_arrays()
            n_ov, n_in = int(ov_t[idx]), int(in_t[idx])
            gdtype = cfg.guidance_torch_dtype
            for gi, (resolution, members) in enumerate(perceptor_groups(pipe)):
                spec = pipe.cutout_spec(resolution)
                cd = draws.cutouts(step, gi, b, cfg.num_cutout_batches, spec, n_ov, n_in)
                cuts, w = make_cutouts_batch(
                    denoised.to(gdtype), cd, n_ov, n_in, float(power_t[idx]),
                    float(gray_t[idx]), spec, repeats=cfg.num_cutout_batches,
                )
                normed = clip_normalize(cuts)
                outputs.append(normed)
                out_grads.append(_cut_gradient(pipe, members, normed, w))

        if outputs:
            (grad,) = torch.autograd.grad(outputs, x, out_grads)
        else:
            grad = torch.zeros_like(x)
    return grad.detach(), pred_x0.detach()


def clamp_guidance_grad(grad, threshold: float):
    """Zero the gradient of any image holding a NaN/inf, then clamp its RMS
    magnitude to `threshold`."""
    finite = torch.isfinite(grad).flatten(1).all(dim=1).reshape(-1, 1, 1, 1)
    grad = torch.where(finite, grad, torch.zeros_like(grad))
    mag = torch.sqrt(torch.mean(grad**2, dim=(1, 2, 3), keepdim=True))
    return grad * torch.clamp(mag, max=threshold) / torch.clamp_min(mag, 1e-12)


@dataclasses.dataclass
class PLMSHistory:
    """The PLMS sampler's carry: earlier conditioned eps, newest first
    (MAX_PLMS_ORDER - 1, B, H, W, 3), and how many are valid."""

    eps: torch.Tensor
    count: int = 0


def apply_sampler_update(sampler: SamplerConfig, tables, x, step: int,
                         pred_x0_raw, guidance, noise: Optional[torch.Tensor],
                         history: Optional[PLMSHistory] = None):
    """Threshold pred_x0, re-derive eps, condition on the guidance gradient,
    then the DDIM step, or the PLMS step (which draws no noise and advances
    `history` in place) -> (x_next, pred_x0_final)."""
    pct = sampler.dynamic_thresholding_percentile
    if sampler.thresholding_method == "histogram":
        pred_x0_thr = dynamic_threshold_fast(pred_x0_raw, pct)
    elif sampler.thresholding_method == "sort":
        pred_x0_thr = dynamic_threshold(pred_x0_raw, pct)
    else:
        raise ValueError(f"unknown thresholding_method {sampler.thresholding_method!r}")
    eps_thr = predict_eps_from_xstart(x, pred_x0_thr, tables, step)
    eps_cond = condition_eps(eps_thr, guidance, tables, step)
    pred_x0_final = predict_xstart_from_eps(x, eps_cond, tables, step)
    if sampler.mode == "plms":
        eps_prime = plms_eps(eps_cond, history.eps, history.count, sampler.order)
        x_next = plms_step(x, eps_prime, tables, step)
        history.eps = push_history(eps_cond, history.eps)
        history.count += 1
    elif sampler.mode == "ddim":
        x_next = ddim_step(x, eps_cond, pred_x0_final, tables, step, sampler.eta, noise)
    else:
        raise ValueError(f"unknown sample mode {sampler.mode!r}")
    return x_next, pred_x0_final


def guided_step(pipe: GuidedPipeline, tables, x, step: int, draws,
                init_image: Optional[torch.Tensor] = None,
                history: Optional[PLMSHistory] = None):
    """One full guided step -> (x_next, pred_x0_final); PLMS needs
    `history`, which it advances."""
    grad, pred_x0_raw = guidance_gradient(pipe, tables, x, step, draws, init_image)
    guidance = clamp_guidance_grad(-grad, pipe.config.grad_threshold)
    ddim = pipe.sampler.mode == "ddim"
    noise = draws.step_noise(step, x.shape) if ddim and step > 0 else None
    return apply_sampler_update(pipe.sampler, tables, x, step, pred_x0_raw,
                                guidance, noise, history)


def frame_table(n_steps: int, num_frames: int):
    """Trajectory position -> frame slot (-1 for none): `num_frames` evenly
    spaced positions, the last step included."""
    frame_at = np.unique(np.linspace(0, n_steps - 1, num_frames).astype(np.int64))
    table = np.full(n_steps, -1, dtype=np.int64)
    table[frame_at] = np.arange(len(frame_at))
    return table, len(frame_at)


def guided_sample(
    pipe: GuidedPipeline,
    draws,
    batch_size: int = 1,
    init_image: Optional[torch.Tensor] = None,
    num_frames: int = 6,
    progress_callback: Optional[Callable] = None,
    progress_every: int = 5,
):
    """Run the full guided trajectory -> (final_images, frames): the final
    pred_x0 in [-1, 1] NHWC and `num_frames` evenly spaced pred_x0 frames
    (F, B, H, W, 3).  `init_image` (1, H, W, 3) in [-1, 1]: the trajectory
    starts from it diffused to the first executed step, with noise from
    `draws.initial_noise`.  `progress_callback(position, pred_x0)` fires
    every `progress_every` positions."""
    cfg, sampler = pipe.config, pipe.sampler
    shape = (batch_size, cfg.height, cfg.width, 3)
    tables = schedule_tables(pipe.schedule, pipe.device)
    start = pipe.schedule.num_steps - sampler.skip_timesteps - 1
    n_steps = start + 1
    table, n_frames = frame_table(n_steps, num_frames)
    history = PLMSHistory(init_history(shape, pipe.device)) if sampler.mode == "plms" else None
    with torch.no_grad():
        x = draws.initial_noise(shape).to(torch.float32)
        if init_image is not None:
            init_image = init_image.to(device=pipe.device, dtype=torch.float32)
            x = q_sample(init_image.expand(shape), tables, start, x)
        frames = torch.zeros((n_frames,) + shape, dtype=torch.float32, device=pipe.device)
        for pos, step in enumerate(range(start, -1, -1)):
            x, pred_x0 = guided_step(pipe, tables, x, step, draws, init_image, history)
            if table[pos] >= 0:
                frames[table[pos]] = pred_x0
            if progress_callback is not None and pos % progress_every == 0:
                progress_callback(pos, pred_x0)
    return frames[-1], frames
