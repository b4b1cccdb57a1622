"""Differentiable image augmentations for the cutout batch.

Counterpart of `clip_diffusion_tpu.ops.augment`, over an (N, S, S, C)
batch in [0, 1] space:

    RandomHorizontalFlip(0.5) -> +0.01*noise -> RandomAffine(10 deg, 5%
    translate, bilinear) -> +0.01*noise -> RandomGrayscale(0.1) ->
    +0.01*noise -> ColorJitter(0.1 x brightness/contrast/saturation/hue)

with ColorJitter's four sub-ops in a fixed order (brightness, contrast,
saturation, hue).  The random draws are separate from the transforms: an
`AugmentDraws` carries every value one slot needs, so tests can feed the
transforms the JAX package's draws.  Draw tensors keep their own dtype and
the transforms promote as the JAX code does (the jitter factors promote a
bfloat16 image to their float type).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

# ITU-R 601 luma weights (torchvision rgb_to_grayscale).
_LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip_p: float = 0.5
    noise_std: float = 0.01
    degrees: float = 10.0
    translate: float = 0.05
    grayscale_p: float = 0.1
    jitter: float = 0.1  # brightness/contrast/saturation/hue strength
    # "shear": 3-shear decomposition of the rotation+translation into 1-D
    # bilinear resamples, each a per-row banded matmul; "gather": direct
    # 2-D bilinear sampling of the inverse map (four taps, zero fill)
    affine_impl: str = "shear"


@dataclasses.dataclass
class AugmentDraws:
    """Random values for N augmented slots.

    flip, gray: (N,) bool; noise: (N, 3, S, S, C) standard normal fields for
    the three noise stages; affine: (N, 3) = angle (radians), ty, tx
    (pixels); jitter: (N, 4) = brightness, contrast and saturation factors
    and the hue draw in [-strength, strength]."""

    flip: torch.Tensor
    noise: torch.Tensor
    affine: torch.Tensor
    gray: torch.Tensor
    jitter: torch.Tensor

    def map(self, fn) -> "AugmentDraws":
        """Apply `fn` to every field (indexing, reshaping, moving)."""
        return AugmentDraws(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def draw_augment(gen: torch.Generator, shape, size: int, channels: int,
                 cfg: AugmentConfig, device) -> AugmentDraws:
    """Fresh draws for a `shape`-batch of slots from a torch.Generator."""
    shape = tuple(shape)

    def uniform(lo, hi, extra=()):
        u = torch.rand(shape + extra, generator=gen, device=device)
        return lo + (hi - lo) * u

    max_t = cfg.translate * size
    lo, hi = 1.0 - cfg.jitter, 1.0 + cfg.jitter
    return AugmentDraws(
        flip=uniform(0.0, 1.0) < cfg.flip_p,
        noise=torch.randn(shape + (3, size, size, channels), generator=gen, device=device),
        affine=torch.stack([
            uniform(-cfg.degrees, cfg.degrees) * (math.pi / 180.0),
            uniform(-max_t, max_t),
            uniform(-max_t, max_t),
        ], dim=-1),
        gray=uniform(0.0, 1.0) < cfg.grayscale_p,
        jitter=torch.stack([
            uniform(lo, hi), uniform(lo, hi), uniform(lo, hi),
            uniform(-cfg.jitter, cfg.jitter),
        ], dim=-1),
    )


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """RGB -> 3-channel grayscale, differentiable. img: (..., 3)."""
    y = _LUMA[0] * img[..., 0] + _LUMA[1] * img[..., 1] + _LUMA[2] * img[..., 2]
    return torch.stack([y, y, y], dim=-1)


def _shear_weights(size: int, shifts: torch.Tensor, dtype) -> torch.Tensor:
    """(N, rows, in, out) 2-tap triangle interpolation matrices for per-row
    fractional shifts: W[n, r, i, o] = max(0, 1 - |i - (o + shifts[n, r])|);
    out-of-range taps have zero weight, which is zero fill."""
    xo = torch.arange(size, dtype=torch.float32, device=shifts.device)
    d = xo[:, None] - (xo[None, :] + shifts[..., None, None])
    return torch.clamp_min(1.0 - torch.abs(d), 0.0).to(dtype)


def _shear_rows(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[n, y, x] = img[n, y, x + shifts[n, y]] (1-D bilinear, zero fill)."""
    w = _shear_weights(img.shape[2], shifts, img.dtype)  # (N, Y, Xin, Xout)
    return torch.einsum("nyic,nyio->nyoc", img, w)


def _shear_cols(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[n, y, x] = img[n, y + shifts[n, x], x], the column analog."""
    w = _shear_weights(img.shape[1], shifts, img.dtype)  # (N, X, Yin, Yout)
    return torch.einsum("nixc,nxio->noxc", img, w)


def _affine_shear(img, theta, ty, tx):
    """Rotation+translation about the center via shearX -> shearY -> shearX,
    the source map src = [[cos, sin], [-sin, cos]] @ (p - c - t) + c.
    img (N, S, S, C); theta, ty, tx (N,)."""
    s = img.shape[1]
    c = (s - 1) / 2.0
    A = torch.cos(theta)
    B = torch.sin(theta)
    # (A - 1) / B, as -tan(theta / 2): the difference cancels near theta = 0,
    # where one ulp of cos moves the shear by up to 1e-5 pixels per row
    alpha = -torch.tan(theta / 2.0)
    beta = B
    u2 = -(A * ty + B * tx)
    u1 = -(-B * ty + A * tx) - alpha * u2
    yy = torch.arange(s, dtype=torch.float32, device=img.device) - c

    out = _shear_rows(img, alpha[:, None] * yy + u1[:, None])  # x-shear first
    out = _shear_cols(out, beta[:, None] * yy + u2[:, None])  # y-shear
    return _shear_rows(out, alpha[:, None] * yy)  # final x-shear


def affine_shear(img, theta, ty, tx):
    """`_affine_shear` under activation checkpointing: the (N, S, S, S)
    interpolation matrices are rebuilt in the backward pass instead of
    being held across the CLIP forward and backward."""
    if torch.is_grad_enabled() and img.requires_grad:
        return checkpoint(_affine_shear, img, theta, ty, tx, use_reentrant=False)
    return _affine_shear(img, theta, ty, tx)


def _bilinear_sample(img, ys, xs):
    """Sample (N, S, S, C) images at fractional source coordinates ys, xs
    (N, S, S): four taps, zero fill outside.  Its backward is a scatter-add
    (index_put with accumulate), whose float sum order on a GPU is not
    fixed."""
    n, h, w = img.shape[0], img.shape[1], img.shape[2]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    batch = torch.arange(n, device=img.device).reshape(n, 1, 1)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = img[batch, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]  # (N, S, S, C)
        return torch.where(inside[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                                device=vals.device))

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def affine_gather(img, theta, ty, tx):
    """Rotation+translation about the center by direct bilinear sampling of
    the inverse map src = [[cos, sin], [-sin, cos]] @ (p - c - t) + c.
    img (N, S, S, C); theta, ty, tx (N,), the shear's draws."""
    s = img.shape[1]
    c = (s - 1) / 2.0
    ii = torch.arange(s, dtype=torch.float32, device=img.device)
    ys, xs = torch.meshgrid(ii, ii, indexing="ij")
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    yr = ys - c - ty[:, None, None]
    xr = xs - c - tx[:, None, None]
    return _bilinear_sample(img, cos * yr + sin * xr + c, -sin * yr + cos * xr + c)


def _hue_rotate(img, theta):
    """Rotate chroma in YIQ space by theta radians (hue shift)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    cos, sin = torch.cos(theta), torch.sin(theta)
    i2 = cos * i - sin * q
    q2 = sin * i + cos * q
    r2 = y + 0.956 * i2 + 0.621 * q2
    g2 = y - 0.272 * i2 - 0.647 * q2
    b2 = y - 1.106 * i2 + 1.703 * q2
    return torch.stack([r2, g2, b2], dim=-1)


def _color_jitter(img, factors):
    """Brightness/contrast/saturation multiplicative jitter + hue shift;
    factors (N, 4)."""
    f = factors[:, :, None, None, None]  # (N, 4, 1, 1, 1)
    img = img * f[:, 0]
    mean = torch.mean(rgb_to_grayscale(img), dim=(1, 2, 3), keepdim=True)
    img = f[:, 1] * img + (1.0 - f[:, 1]) * mean
    img = f[:, 2] * img + (1.0 - f[:, 2]) * rgb_to_grayscale(img)
    theta = factors[:, 3] * (2.0 * math.pi)
    return _hue_rotate(img, theta[:, None, None])


def augment_batch(images: torch.Tensor, draws: AugmentDraws,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Apply the stack to an (N, S, S, C) batch, slot i with draws[i]."""
    affine = {"shear": affine_shear, "gather": affine_gather}[cfg.affine_impl]
    bcast = (slice(None), None, None, None)
    img = torch.where(draws.flip[bcast], images.flip(2), images)
    img = img + cfg.noise_std * draws.noise[:, 0].to(img.dtype)
    img = affine(img, draws.affine[:, 0], draws.affine[:, 1], draws.affine[:, 2])
    img = img + cfg.noise_std * draws.noise[:, 1].to(img.dtype)
    img = torch.where(draws.gray[bcast], rgb_to_grayscale(img), img)
    img = img + cfg.noise_std * draws.noise[:, 2].to(img.dtype)
    return _color_jitter(img, draws.jitter)
