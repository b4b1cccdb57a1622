"""Disco-style cutout engine on torch tensors.

Counterpart of `clip_diffusion_tpu.guidance.cutouts`.  Per image and
repeat the JAX package fills `max_overview + max_inner` fixed slots (the
schedule maxima) and weights the inactive ones by zero.  Eager PyTorch
evaluates only the active slots: overview slots [0, n_ov) and inner slots
[0, n_in).  Each slot keeps its position in the padded layout, so its
random draws and its weight, 1 / (n_ov + n_in) / repeats, are the padded
run's.  Kept behaviours:

* overview slots 0-3 are the identity/gray/hflip/gray-hflip variants when
  at most 4 overview cuts are scheduled, plain copies otherwise;
* inner cuts are random crops of size floor(u**power * (short - min) + min)
  at integer offsets, resized to the CLIP resolution by matmuls;
* inner slot i is grayscaled when i <= floor(gray_portion * n_in), so
  inner slot 0 is always gray (the reference's `<=`);
* the augmentation stack runs over all active slots (ops/augment.py).

Images are NHWC in [-1, 1]; cuts come back in [0, 1] space.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from clip_diffusion_tpu_torch.ops.augment import (
    AugmentConfig,
    AugmentDraws,
    augment_batch,
    draw_augment,
    rgb_to_grayscale,
)
from clip_diffusion_tpu_torch.ops.resize import crop_resize, pad_to_square_resize


@dataclasses.dataclass(frozen=True)
class CutoutSpec:
    """Static cutout geometry."""

    cut_size: int  # CLIP visual input resolution
    max_overview: int = 14  # schedule maxima; see CutoutSchedules
    max_inner: int = 12
    augment: bool = True
    augment_cfg: AugmentConfig = AugmentConfig()

    @property
    def max_total(self) -> int:
        return self.max_overview + self.max_inner


@dataclasses.dataclass
class CutDraws:
    """Random values for the active slots of a (B images x R repeats) cut
    batch: `crop` (B, R, n_in, 3) = u, uy, ux of each active inner slot;
    `aug` the augmentation draws with leading dims (B, R, n_ov + n_in),
    overview slots first."""

    crop: torch.Tensor
    aug: AugmentDraws


def active_slots(spec: CutoutSpec, n_ov: int, n_in: int) -> torch.Tensor:
    """Positions of the active slots in the padded (max_total) layout."""
    return torch.cat([torch.arange(n_ov), spec.max_overview + torch.arange(n_in)])


def draw_cutouts(gen: torch.Generator, batch: int, repeats: int,
                 spec: CutoutSpec, n_ov: int, n_in: int, device) -> CutDraws:
    """Fresh CutDraws from a torch.Generator (draws only the active slots)."""
    return CutDraws(
        crop=torch.rand((batch, repeats, n_in, 3), generator=gen, device=device),
        aug=draw_augment(gen, (batch, repeats, n_ov + n_in), spec.cut_size, 3,
                         spec.augment_cfg, device),
    )


def _overview_cuts(image01, n_ov: int, spec: CutoutSpec):
    """(n_ov, S, S, C) overview slots of one HWC image."""
    base = pad_to_square_resize(image01, spec.cut_size)
    if n_ov <= 4:
        flipped = base.flip(1)
        variants = [base, rgb_to_grayscale(base), flipped, rgb_to_grayscale(flipped)]
        return torch.stack(variants[:n_ov], dim=0)
    return base[None].expand((n_ov,) + base.shape)


def _inner_cuts(image01, crop, n_in: int, size_power: float,
                gray_portion: float, spec: CutoutSpec):
    """(R, n_in, S, S, C) random crop slots of one HWC image; crop (R, n_in, 3)."""
    h, w = image01.shape[0], image01.shape[1]
    shorter = float(min(h, w))
    min_size = float(min(h, w, spec.cut_size))
    u, uy, ux = crop[..., 0], crop[..., 1], crop[..., 2]
    size = torch.floor(u**size_power * (shorter - min_size) + min_size)
    # integer offsets in [0, dim - size]
    oy = torch.floor(uy * (h - size + 1.0))
    ox = torch.floor(ux * (w - size + 1.0))
    r = crop.shape[0]
    cuts = crop_resize(image01, oy.reshape(-1), ox.reshape(-1), size.reshape(-1),
                       size.reshape(-1), spec.cut_size)
    cuts = cuts.reshape((r, n_in) + cuts.shape[1:])
    n_gray = math.floor(float(torch.tensor(gray_portion, dtype=torch.float32)
                              * torch.tensor(float(n_in), dtype=torch.float32)))
    grayed = (torch.arange(n_in, device=image01.device) <= n_gray)[None, :, None, None, None]
    return torch.where(grayed, rgb_to_grayscale(cuts), cuts)


def make_cutouts_batch(images, draws: CutDraws, n_ov: int, n_in: int,
                       size_power: float, gray_portion: float,
                       spec: CutoutSpec, repeats: int = 1):
    """(B, H, W, C) in [-1, 1] -> (cuts (B, R*n, S, S, C), weights (B, R*n))
    with n = n_ov + n_in active slots per repeat.  The weights sum to 1 per
    image: the reference's mean over its `num_cutout_batches` batches of
    cuts."""
    b = images.shape[0]
    n = n_ov + n_in
    if n == 0:
        raise ValueError("make_cutouts_batch: no active cutout slots")
    per_image = []
    for i in range(b):
        image01 = (images[i] + 1.0) / 2.0  # denormalize
        parts = []
        if n_ov:
            ov = _overview_cuts(image01, n_ov, spec)
            parts.append(ov[None].expand((repeats,) + ov.shape))
        if n_in:
            parts.append(_inner_cuts(image01, draws.crop[i], n_in, size_power,
                                     gray_portion, spec))
        per_image.append(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])
    cuts = torch.stack(per_image, dim=0)  # (B, R, n, S, S, C)
    s = spec.cut_size
    cuts = cuts.reshape((b * repeats * n, s, s, cuts.shape[-1]))
    if spec.augment:
        aug = draws.aug.map(lambda t: t.reshape((b * repeats * n,) + t.shape[3:]))
        cuts = augment_batch(cuts, aug, spec.augment_cfg)
    cuts = cuts.reshape((b, repeats * n, s, s, cuts.shape[-1]))
    # float32 arithmetic, as the padded run computes its weights
    weights = torch.ones((b, repeats * n), dtype=torch.float32, device=images.device)
    weights = weights / float(n) / float(repeats)
    return cuts, weights
