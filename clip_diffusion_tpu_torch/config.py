"""Run configuration and dense per-timestep schedules (PyTorch port).

The port keeps its own copy of `clip_diffusion_tpu.config`: the same knob
names, defaults and the same force-to-multiple-of-64 canvas rule, so a user
of either package finds the same dials.  The cutout schedules are dense
1000-entry tuples indexed by the 1000-basis schedule index of each sampler
step (see `pipeline/guided.schedule_index`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Length of the schedule basis: every cutout schedule has one entry per
# base-process timestep of the 1000-step reference process.
SCHEDULE_BASIS = 1000


def create_schedule(values: Tuple, steps: Tuple) -> Tuple:
    """Piecewise-constant schedule: values[i] repeated steps[i] times."""
    if len(values) != len(steps):
        raise ValueError("length of values and steps must be the same")
    schedule: Tuple = ()
    for value, num_steps in zip(values, steps):
        schedule += (value,) * num_steps
    return schedule


def schedule_array(schedule: Tuple, dtype=np.float32) -> np.ndarray:
    """Dense schedule tuple -> numpy table indexed by schedule index."""
    arr = np.asarray(schedule, dtype=dtype)
    if arr.shape[0] != SCHEDULE_BASIS:
        raise ValueError(
            f"schedule must have {SCHEDULE_BASIS} entries, got {arr.shape[0]}"
        )
    return arr


@dataclasses.dataclass(frozen=True)
class CutoutSchedules:
    """The four Disco-style cutout schedules as dense tables."""

    num_overview_cuts: Tuple = create_schedule((14, 12, 4, 0), (200, 200, 400, 200))
    num_inner_cuts: Tuple = create_schedule((2, 4, 2, 12), (200, 200, 400, 200))
    inner_cut_size_power: Tuple = create_schedule((5,), (1000,))
    cut_gray_portion: Tuple = create_schedule(
        (0.7, 0.6, 0.45, 0.3, 0), (100, 100, 100, 100, 600)
    )

    def as_arrays(self):
        """Return (overview[i32], inner[i32], power[f32], gray[f32]) tables."""
        return (
            schedule_array(self.num_overview_cuts, np.int32),
            schedule_array(self.num_inner_cuts, np.int32),
            schedule_array(self.inner_cut_size_power, np.float32),
            schedule_array(self.cut_gray_portion, np.float32),
        )

    @property
    def max_overview_cuts(self) -> int:
        return int(max(self.num_overview_cuts))

    @property
    def max_inner_cuts(self) -> int:
        return int(max(self.num_inner_cuts))


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable generation configuration (same knobs and defaults as the
    JAX package's `Config`)."""

    # Canvas, forced to multiples of 64.
    width: int = 768
    height: int = 512

    num_cutout_batches: int = 4
    cutout_schedules: CutoutSchedules = dataclasses.field(
        default_factory=CutoutSchedules
    )

    chosen_clip_models: Tuple[str, ...] = ("ViT-B/32", "ViT-B/16", "ViT-L/14", "RN101")
    chosen_predictors: Tuple[str, ...] = ("ViT-B/32", "ViT-B/16", "ViT-L/14")

    # RMS clamp of the guidance gradient.
    grad_threshold: float = 0.05

    # Same-resolution perceptors score one shared cutout batch.
    share_cutouts_across_perceptors: bool = True

    # dtype of the cutout/augment/CLIP-input path.
    guidance_dtype: str = "bfloat16"

    # Max cut-images per CLIP tower pass inside the guidance gradient;
    # larger batches run as sequential chunks.  0 disables chunking.
    clip_cut_chunk: int = 16

    # Loss scales.
    clip_guidance_scale: float = 8000.0
    denoise_scale: float = 10000.0  # total-variation loss weight
    range_scale: float = 0.0
    LPIPS_scale: float = 1000.0
    aesthetic_scale: float = 0.0
    MS_SSIM_scale: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "width", max((self.width // 64) * 64, 64))
        object.__setattr__(self, "height", max((self.height // 64) * 64, 64))

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @property
    def guidance_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.guidance_dtype)
