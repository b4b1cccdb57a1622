"""Guidance losses over NHWC tensors.

Counterpart of `clip_diffusion_tpu.guidance.losses` for the main path:
squared spherical distance (CLIP guidance), L2 total variation with
replicate padding, and the RGB range loss.  Each reduces as the JAX
package does, so loss scales transfer unchanged.  MS-SSIM is a later slice
of the port.
"""

from __future__ import annotations

import torch


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
