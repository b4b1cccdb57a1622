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

On CUDA a CLIP tower's chunk (its forward, the loss and the gradient to
the cuts) replays a CUDA graph: about a thousand small launches a chunk
cost the host more than the device's work.  A tower (`CLIPModel._graphs`)
keeps a graph per key (`tower_graph_key`), at most
`TOWER_GRAPHS_PER_MODEL`, the least recently used dropped first; moving
its weights (`.to()`, `load_state_dict`) drops them.  A key is captured on
its first call (two warm-up runs on a side stream, then the capture),
every graph of a device in one memory pool.  The graphs of one chunk shape
read one static leaf: the cuts are copied in before a replay and the
graph writes their gradient back into it; the prompt embeddings and
weights and the cut weights are copied in too, so a new prompt reuses the
graph.  A graph's scratch stays in the pool for the graph's life, where
the step's eager work cannot reuse it, so a key runs eagerly instead where
its warm-up made the allocator free cached blocks to find room, or where
the device's free memory no longer holds the warm-up's peak above what
was allocated (the key's scratch) once the warm-up is done; a capture
therefore resets the device's peak memory statistics.  The CPU, and
towers that are not `CLIPModel`s, run the eager body.  One caller at a
time per device: the replays read the device's static buffers.

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

Spans (`utils.profiling.annotate`, recorded while a profile collects):
`guided.sample` around a `guided_sample` call, `guided.step` per
position, inside it `guided.unet` (the forward and pred_x0),
`guided.cutouts` per perceptor group, `guided.tower` per perceptor (in
it `guided.tower.replay` around each graph replay), `guided.backward`
(the one backward to x) and `guided.update` (clamp, step noise,
threshold, update), and `guided.progress` around the progress callback.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import weakref
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
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, clip_normalize
from clip_diffusion_tpu_torch.models.unet import split_model_output
from clip_diffusion_tpu_torch.ops.augment import AugmentDraws
from clip_diffusion_tpu_torch.ops.quantile import dynamic_threshold_fast
from clip_diffusion_tpu_torch.utils.checkpoint import SamplingState
from clip_diffusion_tpu_torch.utils.profiling import annotate

TOWER_GRAPHS_PER_MODEL = 8  # captured chunk keys a CLIP tower keeps

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
        """The padded slot layout handed to `draws.cutouts`: the schedule
        maxima."""
        cs = self.config.cutout_schedules
        return CutoutSpec(cut_size=resolution, max_overview=cs.max_overview_cuts,
                          max_inner=cs.max_inner_cuts)


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


def _prompt_distance(embs, te, tw):
    """(B, n, D) cut embeddings -> (B, n) distance to the prompt embeddings
    `te` (P, D) or (B, P, D), weighted by `tw` (P,) or (B, P)."""
    if te.ndim == 3:
        d = square_spherical_distance_loss(embs[:, :, None, :], te[:, None, :, :])
        return torch.sum(d * tw[:, None, :], dim=-1)
    d = square_spherical_distance_loss(embs[:, :, None, :], te[None, None, :, :])
    return torch.sum(d * tw[None, None, :], dim=-1)


def _chunk_gradient(perc: Perceptor, cfg: Config, leaf, w, te, tw):
    """Gradient of one chunk's CLIP (and aesthetic) loss with respect to
    `leaf`, its (B, c, S, S, 3) normalized cuts: prompt embeddings `te`,
    weights `tw`, cut weights `w` (B, c)."""
    b, c = leaf.shape[:2]
    embs = perc.embed_image(leaf.reshape((-1,) + leaf.shape[2:])).reshape(b, c, -1)
    loss = cfg.clip_guidance_scale * torch.sum(w * _prompt_distance(embs, te, tw))
    if perc.aesthetic_fn is not None and cfg.aesthetic_scale > 0:
        scores = perc.aesthetic_fn(l2_normalize(embs, dim=-1))[..., 0]
        loss = loss - cfg.aesthetic_scale * torch.sum(w * scores)
    (g,) = torch.autograd.grad(loss, leaf)
    return g


def tower_graph_key(perc: Perceptor, cfg: Config, chunk, w) -> tuple:
    """What a tower's captured chunk graph holds fixed (the tower itself
    keys the store, `CLIPModel._graphs`): the chunk's and its weights'
    shapes, dtypes and device, the prompt embeddings' and weights' shapes
    and dtypes, and the loss's constants with the aesthetic head it reads."""
    te, tw = perc.text_embeddings, perc.text_weights
    head = perc.aesthetic_fn if cfg.aesthetic_scale > 0 else None
    return (tuple(chunk.shape), chunk.dtype, chunk.device, tuple(w.shape), w.dtype,
            tuple(te.shape), te.dtype, tuple(tw.shape), tw.dtype,
            float(cfg.clip_guidance_scale), float(cfg.aesthetic_scale), head)


@dataclasses.dataclass
class _ChunkGraph:
    """A captured chunk: its graph and the static buffers it reads; `leaf`
    holds the cuts before a replay and their gradient after it."""

    graph: "torch.cuda.CUDAGraph"
    leaf: torch.Tensor
    w: torch.Tensor
    te: torch.Tensor
    tw: torch.Tensor


class _DeviceGraphs:
    """What the chunk graphs of one device share: the memory pool and the
    side stream of every capture, and one static leaf (and cut weights)
    per chunk shape, which every tower's graph of that shape reads."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.graphs: weakref.WeakSet = weakref.WeakSet()  # the live graphs, holding the pool
        self.buffers: Dict[tuple, torch.Tensor] = {}

    def pool(self):
        """The live graphs' pool, or a new one once they are all gone (their
        pool then goes back to the allocator and takes no other capture)."""
        for graph in self.graphs:
            return graph.pool()
        return torch.cuda.graph_pool_handle()

    def buffer(self, like: torch.Tensor) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype)
        if key not in self.buffers:
            self.buffers[key] = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
        return self.buffers[key]


_DEVICE_GRAPHS: Dict[torch.device, _DeviceGraphs] = {}


def _write_back_gradient(perc: Perceptor, cfg: Config, leaf, w, te, tw) -> None:
    """What a chunk graph captures: the gradient of the chunk held in
    `leaf`, written back into `leaf`."""
    with torch.enable_grad():
        g = _chunk_gradient(perc, cfg, leaf.detach().requires_grad_(True), w, te, tw)
    with torch.no_grad():
        leaf.copy_(g)


def _capture_chunk(perc: Perceptor, cfg: Config, chunk, w) -> Optional[_ChunkGraph]:
    """A CUDA graph of `_chunk_gradient` on the device's static buffers
    that writes the gradient back into the leaf, or None where the device
    cannot hold the graph's scratch beside the step (module docstring).
    Resets the device's peak memory statistics."""
    device = chunk.device
    shared = _DEVICE_GRAPHS.get(device)
    if shared is None:
        shared = _DEVICE_GRAPHS[device] = _DeviceGraphs(device)
    with torch.cuda.device(device), torch.inference_mode(False), torch.no_grad():
        leaf, wbuf = shared.buffer(chunk), shared.buffer(w)
        te, tw = (t.clone(memory_format=torch.contiguous_format)
                  for t in (perc.text_embeddings, perc.text_weights))
        wbuf.copy_(w)
        run = functools.partial(_write_back_gradient, perc, cfg, leaf, wbuf, te, tw)
        # cuBLAS and cuDNN pick algorithms and workspaces before the capture;
        # the warm-up's peak above what was allocated is the graph's scratch
        current = torch.cuda.current_stream(device)
        base = torch.cuda.memory_allocated(device)
        retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
        torch.cuda.reset_peak_memory_stats(device)
        shared.stream.wait_stream(current)
        with torch.cuda.stream(shared.stream):
            for _ in range(2):
                leaf.copy_(chunk)
                run()
        current.wait_stream(shared.stream)
        scratch = torch.cuda.max_memory_allocated(device) - base
        if (torch.cuda.memory_stats(device).get("num_alloc_retries", 0) > retries
                or torch.cuda.mem_get_info(device)[0] < scratch):
            return None
        # not `torch.cuda.graph`, which empties the cache: the blocks the step
        # keeps cached are what the next key's check must see as taken
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(shared.stream):
            graph.capture_begin(pool=shared.pool())
            try:
                run()
            finally:
                graph.capture_end()
        shared.graphs.add(graph)
    return _ChunkGraph(graph, leaf, wbuf, te, tw)


def _replayed_gradient(tower, perc: Perceptor, cfg: Config, chunk, w):
    """The chunk's gradient from `tower`'s graph for its key, captured on
    the key's first call; None where the key runs eagerly."""
    graphs = tower._graphs
    key = tower_graph_key(perc, cfg, chunk, w)
    if key in graphs:
        graphs.move_to_end(key)
    else:
        graphs[key] = _capture_chunk(perc, cfg, chunk, w)
        if len(graphs) > TOWER_GRAPHS_PER_MODEL:
            graphs.popitem(last=False)
    entry = graphs[key]
    if entry is None:
        return None
    with torch.no_grad():
        entry.leaf.copy_(chunk)
        entry.w.copy_(w)
        entry.te.copy_(perc.text_embeddings)
        entry.tw.copy_(perc.text_weights)
    with annotate("guided.tower.replay"):
        entry.graph.replay()
    # the leaf is overwritten by the next replay of its shape
    return entry.leaf


def _cut_gradient(pipe: GuidedPipeline, members, normed, weights):
    """Gradient of the members' CLIP and aesthetic losses with respect to
    the normalized cuts (B, N, S, S, 3), one tower chunk at a time,
    accumulated in float32 tower by tower, chunk by chunk.  On CUDA a
    CLIP tower's chunk replays its CUDA graph (module docstring)."""
    cfg = pipe.config
    n = normed.shape[1]
    chunk = cfg.clip_cut_chunk if cfg.clip_cut_chunk > 0 else n
    grad = torch.zeros(normed.shape, dtype=torch.float32, device=normed.device)
    for pi in members:
        perc = pipe.perceptors[pi]
        tower = getattr(perc.embed_image, "__self__", None)
        graphed = normed.is_cuda and isinstance(tower, CLIPModel)
        with annotate("guided.tower"):
            for i in range(0, n, chunk):
                cuts = normed[:, i:i + chunk].detach()
                w = weights[:, i:i + chunk]
                g = _replayed_gradient(tower, perc, cfg, cuts, w) if graphed else None
                if g is None:
                    g = _chunk_gradient(perc, cfg, cuts.requires_grad_(True), w,
                                        perc.text_embeddings, perc.text_weights)
                grad[:, i:i + chunk] += g
    return grad.to(normed.dtype)


def guidance_gradient(pipe: GuidedPipeline, tables, x, step: int, draws,
                      init_image: Optional[torch.Tensor] = None,
                      perceptor_subset: Optional[Sequence[int]] = None,
                      include_image_terms: bool = True):
    """d(loss)/dx at respaced step `step` -> (grad, pred_x0), both (B,H,W,3).
    `init_image` (1, H, W, 3) in [-1, 1] is the target of the LPIPS and
    MS-SSIM terms when `pipe.use_init_losses` is on.

    `perceptor_subset` limits the CLIP terms to these perceptors, each with
    cutouts of its own keyed by its global index; `include_image_terms=
    False` drops the whole-image terms (TV, range, LPIPS, MS-SSIM).  The
    ensemble (`parallel/ensemble.py`) sums such gradients over ranks."""
    cfg = pipe.config
    b = x.shape[0]
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        t = tables["scaled_timesteps"][step].expand(b)
        with annotate("guided.unet"):
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
            gdtype = cfg.guidance_torch_dtype
            for key, resolution, members in perceptor_groups(pipe, perceptor_subset):
                with annotate("guided.cutouts"):
                    spec = pipe.cutout_spec(resolution)
                    cd = draws.cutouts(step, key, b, cfg.num_cutout_batches, spec, n_ov, n_in)
                    cuts, w = make_cutouts_batch(
                        denoised.to(gdtype), cd, n_ov, n_in, float(power_t[idx]),
                        float(gray_t[idx]), spec, repeats=cfg.num_cutout_batches,
                    )
                    normed = clip_normalize(cuts)
                outputs.append(normed)
                out_grads.append(_cut_gradient(pipe, members, normed, w))

        if outputs:
            with annotate("guided.backward"):
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
    with annotate("guided.update"):
        guidance = clamp_guidance_grad(-grad, pipe.config.grad_threshold)
        ddim = pipe.sampler.mode == "ddim"
        noise = draws.step_noise(step, x.shape) if ddim and step > 0 else None
        return apply_sampler_update(pipe.sampler, tables, x, step, pred_x0_raw,
                                    guidance, noise, history)


def guided_step(pipe: GuidedPipeline, tables, x, step: int, draws,
                init_image: Optional[torch.Tensor] = None,
                history: Optional[PLMSHistory] = None):
    """One full guided step -> (x_next, pred_x0_final); PLMS needs
    `history`, which it advances."""
    grad, pred_x0_raw = guidance_gradient(pipe, tables, x, step, draws, init_image)
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


def guided_sample(
    pipe: GuidedPipeline,
    draws,
    batch_size: int = 1,
    init_image: Optional[torch.Tensor] = None,
    num_frames: int = 6,
    progress_callback: Optional[Callable] = None,
    progress_every: int = 5,
    resume_state: Optional[SamplingState] = None,
    return_state: bool = False,
    stop_after: Optional[int] = None,
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
    also returns the `SamplingState` after the last executed step."""
    with annotate("guided.sample"):
        cfg, sampler = pipe.config, pipe.sampler
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
                    init = init_image.to(device=pipe.device, dtype=torch.float32)
                    x = q_sample(init.expand(shape), tables, start, x)
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
            for pos in range(start_pos, end_pos):
                with annotate("guided.step"):
                    x, pred_x0 = guided_step(pipe, tables, x, start - pos, draws, init_image, plms)
                    if table[pos] >= 0:
                        frames[table[pos]] = pred_x0
                    if progress_callback is not None and pos % progress_every == 0:
                        with annotate("guided.progress"):
                            progress_callback(pos, pred_x0)
        if return_state:
            state = SamplingState(x=x, step=start - end_pos, eps_history=history.eps,
                                  history_count=history.count, key_data=draws.key_data())
            return frames[-1], frames, state
        return frames[-1], frames
