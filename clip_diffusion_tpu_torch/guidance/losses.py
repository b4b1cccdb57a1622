"""Guidance losses over NHWC tensors.

Counterpart of `clip_diffusion_tpu.guidance.losses`: squared spherical
distance (CLIP guidance), L2 total variation with replicate padding, the
RGB range loss, the aesthetic loss and MS-SSIM structural dissimilarity
(pytorch-msssim parity: 11-tap Gaussian window of sigma 1.5, 5 scales).
Each reduces as the JAX package does, so loss scales transfer unchanged.
LPIPS lives with its VGG16 tower in `models/lpips.py`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


def square_spherical_distance_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared great-circle chord distance between L2-normalized embeddings:
    asin(||xn - yn|| / 2)^2 * 2; broadcasts (cuts, 1, D) x (1, P, D) ->
    (cuts, P)."""
    xn = l2_normalize(x, dim=-1)
    yn = l2_normalize(y, dim=-1)
    chord = torch.linalg.vector_norm(xn - yn, dim=-1)
    return torch.asin(torch.clamp(chord / 2.0, -1.0, 1.0)) ** 2 * 2.0


def total_variational_loss(images: torch.Tensor) -> torch.Tensor:
    """L2 total variation with replicate edge padding, mean over pixels and
    channels, per batch element.  The padded diffs are exactly zero, so the
    unpadded neighbour diffs over the same H*W*C denominator are the same
    quantity."""
    dx = images[:, :, 1:, :] - images[:, :, :-1, :]
    dy = images[:, 1:, :, :] - images[:, :-1, :, :]
    n = images.shape[1] * images.shape[2] * images.shape[3]
    return (torch.sum(dx**2, dim=(1, 2, 3)) + torch.sum(dy**2, dim=(1, 2, 3))) / n


def rgb_range_loss(images: torch.Tensor) -> torch.Tensor:
    """Penalize values outside [-1, 1]."""
    excess = images - torch.clamp(images, -1.0, 1.0)
    return torch.mean(excess**2, dim=(1, 2, 3))


def aesthetic_loss(predictor_fn, embeddings: torch.Tensor) -> torch.Tensor:
    """Mean predictor score over L2-normalized embeddings; `predictor_fn`
    maps (N, D) -> (N, 1)."""
    return torch.mean(predictor_fn(l2_normalize(embeddings, dim=-1)))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter over H and W of NHWC, as two
    depthwise convolutions (H first)."""
    c, k = x.shape[-1], win.shape[0]
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, win.reshape(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    y = F.conv2d(y, win.reshape(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return y.permute(0, 2, 3, 1)


def _ssim_components(x, y, win, data_range=1.0, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    sigma_x = _blur(x * x, win) - mu_x**2
    sigma_y = _blur(y * y, win) - mu_y**2
    sigma_xy = _blur(x * y, win) - mu_x * mu_y
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)) * cs
    return ssim, cs


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM over NHWC in [0, 1] -> scalar mean.  y may have a
    batch of 1 against x's B.  Needs H, W >= 176 (the window at the fifth
    scale)."""
    win = torch.from_numpy(_gaussian_window(win_size, win_sigma)).to(x.device, x.dtype)
    levels = len(_MSSSIM_WEIGHTS)
    mcs = []
    ssim = None
    for i in range(levels):
        ssim, cs = _ssim_components(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(torch.mean(F.relu(cs)))
            x = _avg_pool2(x)
            y = _avg_pool2(y)
    weights = torch.tensor(_MSSSIM_WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.prod(torch.stack(mcs + [torch.mean(F.relu(ssim))]) ** weights)


def structural_dissimilarity_loss(images: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - MS-SSIM of [-1, 1] NHWC images mapped to [0, 1]."""
    return 1.0 - ms_ssim((images + 1.0) / 2.0, (target + 1.0) / 2.0)
