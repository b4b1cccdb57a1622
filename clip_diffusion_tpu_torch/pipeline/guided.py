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
`torch.Generator` on the device seeded afresh from its key, the draw's
(purpose, step, group) and the row, as the JAX package folds the step
and group into its key; tests pass an object that replays the JAX
package's key chain.

`guided_sample` resumes a trajectory from a `utils.checkpoint.
SamplingState` (`resume_state`, `return_state`, `stop_after`): keyed draws
make the resumed steps draw what the uninterrupted run drew.

The dispatch layer is kept for parity with the JAX package, which needs
it for its static padded slot layouts and per-dispatch limits.  With
`SamplerConfig.phase_segmented` the trajectory walks the cutout
schedule's phases (`compute_phase_segments`) in chunks of at most
`max_steps_per_dispatch` steps; between chunks, and only there, a host
`deadline` is checked (`DeadlineExceeded`) and, when asked for, the device
is synchronized and each chunk's (caps, steps, seconds) recorded in
`chunk_times`.  The port runs every step eagerly and evaluates only the
active cutout slots, so none of this changes what it computes: under
`TorchDraws` the segmented trajectory equals the padded one bit for bit.
The caps reach one thing, the slot layout `cutout_spec(resolution,
slot_caps)` handed to `draws.cutouts`, which `TorchDraws` ignores and a
replay of the JAX package's draws (whose keys follow that layout) reads.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
from clip_diffusion_tpu_torch.ops.augment import AugmentDraws
from clip_diffusion_tpu_torch.ops.quantile import dynamic_threshold_fast
from clip_diffusion_tpu_torch.utils.checkpoint import SamplingState


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

    def cutout_spec(self, resolution: int,
                    slot_caps: Optional[Tuple[int, int]] = None) -> CutoutSpec:
        """The padded slot layout handed to `draws.cutouts`: the schedule
        maxima, or `slot_caps` (max_overview, max_inner) for a
        phase-segmented step (module docstring)."""
        cs = self.config.cutout_schedules
        max_ov, max_in = slot_caps or (cs.max_overview_cuts, cs.max_inner_cuts)
        return CutoutSpec(cut_size=resolution, max_overview=max_ov, max_inner=max_in)


class DeadlineExceeded(Exception):
    """Raised by `guided_sample` when its host `deadline` (a `time.time()`
    value) has passed between dispatch chunks; `chunk_times` keeps the
    chunks that completed.  Checked only between chunks."""


# the first word of each draw's key: what the draw is for
_INIT, _STEP, _INPAINT, _CUTOUTS, _FOLD = range(5)


def derive_seed(seed: int, *words: int) -> int:
    """A 64-bit generator seed for (seed, words...), derived on the host."""
    return int(np.random.SeedSequence([int(seed), *words]).generate_state(1, np.uint64)[0])


class TorchDraws:
    """The pipeline's random draws as a function of a key: each row of each
    call is drawn from the draws' `torch.Generator` on `device`, seeded
    afresh from (seed, purpose, step[, group], row), so a draw does not
    depend on what was drawn before it, on which steps and groups a process
    skips, or on how many rows are drawn with it.  A row view (`rows`)
    draws only its rows of a batch."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.span: Optional[Tuple[int, int]] = None  # the rows of a row view
        self._generator: Optional[torch.Generator] = None  # re-seeded per row

    def key_data(self) -> np.ndarray:
        """The seed as uint32 words, low word first (`SamplingState.key_data`)."""
        return np.asarray([self.seed & 0xFFFFFFFF, self.seed >> 32], np.uint32)

    @classmethod
    def from_key_data(cls, words, device) -> "TorchDraws":
        words = np.asarray(words, np.uint32)
        return cls(int(words[0]) | int(words[1]) << 32, device)

    def fold(self, sub: int) -> "TorchDraws":
        """Draws of their own for sub-batch `sub`, as JAX's fold_in(key, sub)."""
        other = copy.copy(self)
        other.seed, other._generator = derive_seed(self.seed, _FOLD, sub), None
        return other

    def rows(self, lo: int, hi: int) -> "TorchDraws":
        """The draws of rows [lo, hi) of a batch: the rows a single process
        draws for the whole batch, bit for bit on one device type."""
        if not 0 <= lo < hi:
            raise ValueError(f"rows [{lo}, {hi})")
        other = copy.copy(self)
        other.span, other._generator = (lo, hi), None
        return other

    def _gens(self, n: int, *words: int):
        """A generator seeded for each of the `n` rows asked for, in turn."""
        lo, hi = self.span or (0, n)
        if n != hi - lo:
            raise ValueError(f"draws for rows [{lo}, {hi}) asked for {n} rows")
        if self._generator is None:
            self._generator = torch.Generator(self.device)
        for row in range(lo, hi):
            yield self._generator.manual_seed(derive_seed(self.seed, *words, row))

    def _normal(self, shape, *words: int) -> torch.Tensor:
        row = (1,) + tuple(shape[1:])
        return torch.cat([torch.randn(row, generator=g, device=self.device)
                          for g in self._gens(shape[0], *words)])

    def initial_noise(self, shape) -> torch.Tensor:
        return self._normal(shape, _INIT)

    def step_noise(self, step: int, shape) -> torch.Tensor:
        return self._normal(shape, _STEP, step)

    def inpaint_noise(self, step: int, shape) -> torch.Tensor:
        """The latent pipeline's re-noise of the known region."""
        return self._normal(shape, _INPAINT, step)

    def cutouts(self, step: int, group: int, batch: int, repeats: int,
                spec: CutoutSpec, n_ov: int, n_in: int) -> CutDraws:
        parts = [draw_cutouts(g, 1, repeats, spec, n_ov, n_in, self.device)
                 for g in self._gens(batch, _CUTOUTS, step, group)]
        if len(parts) == 1:
            return parts[0]
        return CutDraws(torch.cat([d.crop for d in parts]), AugmentDraws(*(
            torch.cat([getattr(d.aug, f.name) for d in parts])
            for f in dataclasses.fields(AugmentDraws))))


def schedule_index(schedule: NoiseSchedule, step: int) -> int:
    """Respaced step -> dense 1000-basis schedule index: 999 - floor(t) of
    the float32 rescaled timestep."""
    t_scaled = np.float32(schedule.scaled_timesteps[step])
    return int(np.clip(999 - int(np.floor(t_scaled)), 0, 999))


def perceptor_groups(pipe: GuidedPipeline, subset: Optional[Sequence[int]] = None
                     ) -> List[Tuple[int, int, List[int]]]:
    """(draws key, resolution, perceptor indices) per cutout batch, in order.
    `subset`: one group per listed perceptor, keyed by its global index,
    which is its key in the run with `share_cutouts_across_perceptors`
    off."""
    if subset is not None:
        return [(i, pipe.perceptors[i].input_resolution, [i]) for i in subset]
    if not pipe.config.share_cutouts_across_perceptors:
        return [(i, p.input_resolution, [i]) for i, p in enumerate(pipe.perceptors)]
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(pipe.perceptors):
        groups.setdefault(p.input_resolution, []).append(i)
    return [(gi, res, members) for gi, (res, members) in enumerate(groups.items())]


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
                      init_image: Optional[torch.Tensor] = None,
                      perceptor_subset: Optional[Sequence[int]] = None,
                      include_image_terms: bool = True,
                      slot_caps: Optional[Tuple[int, int]] = None):
    """d(loss)/dx at respaced step `step` -> (grad, pred_x0), both (B,H,W,3).
    `init_image` (1, H, W, 3) in [-1, 1] is the target of the LPIPS and
    MS-SSIM terms when `pipe.use_init_losses` is on.

    `perceptor_subset` limits the CLIP terms to these perceptors, each with
    cutouts of its own keyed by its global index; `include_image_terms=
    False` drops the whole-image terms (TV, range, LPIPS, MS-SSIM).  The
    ensemble (`parallel/ensemble.py`) sums such gradients over ranks.
    `slot_caps` (max_overview, max_inner) sizes the slot layout handed to
    `draws.cutouts`, as the phase-segmented runner does, and changes
    nothing else; the step's scheduled counts must fit."""
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
        if include_image_terms and cfg.denoise_scale > 0:
            image_loss = cfg.denoise_scale * torch.sum(total_variational_loss(denoised))
        if include_image_terms and cfg.range_scale > 0:
            term = cfg.range_scale * torch.sum(rgb_range_loss(denoised))
            image_loss = term if image_loss is None else image_loss + term
        if include_image_terms and pipe.use_init_losses:
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
            if slot_caps is not None and (n_ov > slot_caps[0] or n_in > slot_caps[1]):
                raise ValueError(f"step {step} schedules ({n_ov}, {n_in}) cutouts, more than "
                                 f"slot_caps {tuple(slot_caps)}")
            gdtype = cfg.guidance_torch_dtype
            for key, resolution, members in perceptor_groups(pipe, perceptor_subset):
                spec = pipe.cutout_spec(resolution, slot_caps)
                cd = draws.cutouts(step, key, b, cfg.num_cutout_batches, spec, n_ov, n_in)
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


def step_from_gradient(pipe: GuidedPipeline, tables, x, step: int, draws, grad,
                       pred_x0_raw, history: Optional[PLMSHistory] = None):
    """The rest of a guided step once d(loss)/dx is known: clamp, step
    noise, threshold and update -> (x_next, pred_x0_final)."""
    guidance = clamp_guidance_grad(-grad, pipe.config.grad_threshold)
    ddim = pipe.sampler.mode == "ddim"
    noise = draws.step_noise(step, x.shape) if ddim and step > 0 else None
    return apply_sampler_update(pipe.sampler, tables, x, step, pred_x0_raw,
                                guidance, noise, history)


def guided_step(pipe: GuidedPipeline, tables, x, step: int, draws,
                init_image: Optional[torch.Tensor] = None,
                history: Optional[PLMSHistory] = None,
                slot_caps: Optional[Tuple[int, int]] = None):
    """One full guided step -> (x_next, pred_x0_final); PLMS needs
    `history`, which it advances.  `slot_caps`: as `guidance_gradient`."""
    grad, pred_x0_raw = guidance_gradient(pipe, tables, x, step, draws, init_image,
                                          slot_caps=slot_caps)
    return step_from_gradient(pipe, tables, x, step, draws, grad, pred_x0_raw, history)


def frame_table(n_steps: int, num_frames: int):
    """Trajectory position -> frame slot (-1 for none): `num_frames` evenly
    spaced positions, the last step included."""
    frame_at = np.unique(np.linspace(0, n_steps - 1, num_frames).astype(np.int64))
    table = np.full(n_steps, -1, dtype=np.int64)
    table[frame_at] = np.arange(len(frame_at))
    return table, len(frame_at)


def compute_phase_segments(pipe: GuidedPipeline, n_steps: int):
    """Host-side: split the descending step sequence into runs with constant
    scheduled cutout counts -> [(steps int32 array, (n_ov, n_in)), ...] in
    execution order.  Each step's counts are read at the index its guidance
    reads (`schedule_index`, the float32 timestep).  The JAX package floors
    the float64 timestep here; the two floors differ at some step counts
    (14 and 44 among them), never at 10, 50, 200 or 250."""
    cs = pipe.config.cutout_schedules
    ov = np.asarray(cs.num_overview_cuts, np.int64)
    inn = np.asarray(cs.num_inner_cuts, np.int64)
    segments = []
    for step in range(n_steps - 1, -1, -1):
        idx = schedule_index(pipe.schedule, step)
        caps = (int(ov[idx]), int(inn[idx]))
        if segments and segments[-1][1] == caps:
            segments[-1][0].append(step)
        else:
            segments.append(([step], caps))
    return [(np.asarray(s, np.int32), caps) for s, caps in segments]


def _phase_chunks(pipe: GuidedPipeline, n_steps: int, start_pos: int, end_pos: int,
                  chunk_size: int):
    """(slot caps, positions) per chunk of positions [start_pos, end_pos):
    each phase segment's positions cut into chunks of at most `chunk_size`."""
    if chunk_size < 1:
        raise ValueError(f"max_steps_per_dispatch must be at least 1, got {chunk_size}")
    offset = 0
    for steps, caps in compute_phase_segments(pipe, n_steps):
        positions = range(max(offset, start_pos), min(offset + len(steps), end_pos))
        offset += len(steps)
        for lo in range(0, len(positions), chunk_size):
            yield caps, positions[lo:lo + chunk_size]


def guided_sample(
    pipe: GuidedPipeline,
    draws,
    batch_size: int = 1,
    init_image: Optional[torch.Tensor] = None,
    num_frames: int = 6,
    progress_callback: Optional[Callable] = None,
    progress_every: int = 5,
    max_steps_per_dispatch: int = 50,
    resume_state: Optional[SamplingState] = None,
    return_state: bool = False,
    stop_after: Optional[int] = None,
    chunk_times: Optional[list] = None,
    deadline: Optional[float] = None,
):
    """Run the full guided trajectory -> (final_images, frames): the final
    pred_x0 in [-1, 1] NHWC and `num_frames` evenly spaced pred_x0 frames
    (F, B, H, W, 3).  `init_image` (1, H, W, 3) in [-1, 1]: the trajectory
    starts from it diffused to the first executed step, with noise from
    `draws.initial_noise`.  `progress_callback(position, pred_x0)` fires
    every `progress_every` positions.

    Resume: `resume_state` continues a trajectory where it stopped (its
    frames before that position stay zero); with `draws=None` the draws
    are rebuilt from its key on `pipe.device`, and draws under another key
    raise.  `stop_after` runs at most that many steps; `return_state=True`
    also returns the `SamplingState` after the last executed step.

    Phase-segmented only (`pipe.sampler.phase_segmented`), as in the JAX
    package: the steps run in chunks of at most `max_steps_per_dispatch`
    within each phase (the module docstring says why the result does not
    change); `chunk_times`, a list, receives `(slot_caps, n_steps,
    seconds)` per chunk, the device synchronized after each; `deadline`, a
    `time.time()` value, raises `DeadlineExceeded` when it has passed
    before a chunk.  The padded loop is one chunk: `deadline` raises
    ValueError there, and `chunk_times` and `max_steps_per_dispatch` are
    ignored."""
    cfg, sampler = pipe.config, pipe.sampler
    if not sampler.phase_segmented:
        if deadline is not None:
            raise ValueError("deadline requires phase_segmented sampling")
        chunk_times = None
    shape = (batch_size, cfg.height, cfg.width, 3)
    if resume_state is not None:
        saved = np.asarray(resume_state.key_data, np.uint32)
        if draws is None:
            draws = TorchDraws.from_key_data(saved, pipe.device)
        elif not np.array_equal(draws.key_data(), saved):
            raise ValueError("resume_state was checkpointed under a different draws key; "
                             "pass draws=None to resume with the saved key")
    elif draws is None:
        raise ValueError("guided_sample: draws are required unless resuming")
    tables = schedule_tables(pipe.schedule, pipe.device)
    start = pipe.schedule.num_steps - sampler.skip_timesteps - 1
    n_steps = start + 1
    table, n_frames = frame_table(n_steps, num_frames)
    with torch.no_grad():
        if resume_state is None:
            start_pos = 0
            x = draws.initial_noise(shape).to(torch.float32)
            if init_image is not None:
                x = q_sample(init_image.to(device=pipe.device, dtype=torch.float32).expand(shape),
                             tables, start, x)
            history = PLMSHistory(init_history(shape, pipe.device))
        else:
            start_pos = start - int(resume_state.step)  # the state's next step counts down
            x = resume_state.x.to(device=pipe.device, dtype=torch.float32)
            history = PLMSHistory(resume_state.eps_history.to(device=pipe.device,
                                                              dtype=torch.float32),
                                  int(resume_state.history_count))
        if init_image is not None:
            init_image = init_image.to(device=pipe.device, dtype=torch.float32)
        end_pos = n_steps if stop_after is None else min(n_steps, start_pos + stop_after)
        plms = history if sampler.mode == "plms" else None
        frames = torch.zeros((n_frames,) + shape, dtype=torch.float32, device=pipe.device)
        chunks = (_phase_chunks(pipe, n_steps, start_pos, end_pos, max_steps_per_dispatch)
                  if sampler.phase_segmented else [(None, range(start_pos, end_pos))])
        for caps, positions in chunks:
            if deadline is not None and time.time() > deadline:
                raise DeadlineExceeded(f"bench deadline passed before chunk at caps={caps}")
            t0 = time.perf_counter()
            for pos in positions:
                x, pred_x0 = guided_step(pipe, tables, x, start - pos, draws, init_image, plms,
                                         caps)
                if table[pos] >= 0:
                    frames[table[pos]] = pred_x0
                if progress_callback is not None and pos % progress_every == 0:
                    progress_callback(pos, pred_x0)
            if chunk_times is not None:
                if pipe.device.type == "cuda":
                    torch.cuda.synchronize(pipe.device)
                chunk_times.append((caps, len(positions), time.perf_counter() - t0))
    if return_state:
        state = SamplingState(x=x, step=start - end_pos, eps_history=history.eps,
                              history_count=history.count, key_data=draws.key_data())
        return frames[-1], frames, state
    return frames[-1], frames
