"""Rank processes for the port's multi-process tests, without JAX.

Each `*_rank` function runs in a process started by `spawn` (gloo on
the CPU, one thread, a `file://` rendezvous in the test's
tmp_path so parallel test workers never share a port) and saves its
result with `torch.save`.  The module imports torch and the port only: the children
must not import JAX.  `tiny_port_models` is the tiny guided stack made
from seeds, so a new process rebuilds the same weights.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.diffusion.sampling import schedule_tables
from clip_diffusion_tpu_torch.guidance.cutouts import CutDraws
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.ops.augment import AugmentDraws
from clip_diffusion_tpu_torch.parallel import dist as tdist
from clip_diffusion_tpu_torch.parallel.ensemble import build_ensemble_guided_step
from clip_diffusion_tpu_torch.parallel.serving import serve_guided_batch, serve_latent_batch

AUG_FIELDS = ("flip", "noise", "affine", "gray", "jitter")
SPAWN_TIMEOUT_S = 600.0


def spawn(fn, world: int, args: tuple = ()) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes; raise if one
    fails or they outlast SPAWN_TIMEOUT_S, and stop them either way."""
    ctx = mp.start_processes(fn, args=(world,) + tuple(args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} outlasted "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)


def _join(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(1)
    tdist.init(device="cpu", init_method=f"file://{init_file}", rank=rank, world_size=world)


def tiny_port_models(device="cpu") -> tzoo.ZooModels:
    """The tiny float32 UNet (seed 1) and tiny ViT tower "tiny0" (seed 2),
    host-initialized."""
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(tzoo.host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clip = CLIPModel(tiny_clip_config("tiny0"))
    clip.load_state_dict(tzoo.host_init_state_dict(clip, from_jax.clip_rule, 2, torch.float32))
    return tzoo.ZooModels(unet.to(device).requires_grad_(False),
                          {"tiny0": clip.to(device).requires_grad_(False)})


class RecordedDraws:
    """Draws recorded elsewhere, as numpy arrays keyed by (kind, step,
    group): "step" (step, 0) and "cutouts" (step, group), the latter a
    tuple of the crop and the five augmentation fields.  Every array is of
    the whole batch; `rows` views rows of it."""

    def __init__(self, table: dict, view=None):
        self.table = table
        self.view = view  # (lo, hi)

    def rows(self, lo: int, hi: int) -> "RecordedDraws":
        return RecordedDraws(self.table, (lo, hi))

    def _rows(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(a))
        return t if self.view is None else t[self.view[0]:self.view[1]]

    def step_noise(self, step, shape):
        return self._rows(self.table[("step", step, 0)])

    def cutouts(self, step, group, batch, repeats, spec, n_ov, n_in):
        crop, *aug = self.table[("cutouts", step, group)]
        return CutDraws(crop=self._rows(crop),
                        aug=AugmentDraws(**{f: self._rows(a) for f, a in zip(AUG_FIELDS, aug)}))


def guided_rank(rank, world, init_file, pipe, prompts_count, seeds_per_prompt, base_seed, out):
    """serve_guided_batch on this rank's rows; each rank saves (final, frames)."""
    _join(rank, world, init_file)
    try:
        final, frames = serve_guided_batch(pipe, prompts_count, seeds_per_prompt, base_seed)
        torch.save((final, frames), f"{out}.{rank}")
        try:
            tdist.row_range(prompts_count * seeds_per_prompt + 1)
        except ValueError:
            pass
        else:
            raise AssertionError("a batch that does not divide over the ranks did not raise")
    finally:
        dist.destroy_process_group()


def latent_rank(rank, world, init_file, ctx_c, ctx_u, kwargs, out):
    """serve_latent_batch of the tiny float32 latent stack (rebuilt from its
    seed) on this rank's rows; each rank saves the result."""
    _join(rank, world, init_file)
    try:
        models = tzoo.build_latent_models(tiny=True, param_dtype=torch.float32, device="cpu")
        pipe, _ = tzoo.build_latent_pipeline(models)
        torch.save(serve_latent_batch(pipe, ctx_c, ctx_u, **kwargs), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def ensemble_rank(rank, world, init_file, pipe, draws, x, steps, out):
    """The ensemble step (perceptor `rank` here) over `steps` from `x`;
    each rank saves [(x_next, pred_x0), ...]."""
    _join(rank, world, init_file)
    try:
        step_fn = build_ensemble_guided_step(pipe)
        tables = schedule_tables(pipe.schedule, pipe.device)
        outs = []
        with torch.no_grad():
            for step in steps:
                x, pred = step_fn(tables, x, step, draws)
                outs.append((x, pred))
        torch.save(outs, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()
