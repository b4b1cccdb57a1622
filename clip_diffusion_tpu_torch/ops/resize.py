"""Separable crop-and-resize as matrix multiplies.

Counterpart of `clip_diffusion_tpu.ops.resize`: a crop window of any
position and size, resized with an antialiased (resize-right/PIL
convention) cubic or linear kernel, is the linear map

    out = W_y(y0, size) @ image @ W_x(x0, size)^T

whose (out_size, in_size) weights are computed from the crop geometry.
Zero padding to a square (the overview cut) folds into the same weights.
Geometry may be a batch of crops: `start`/`size` of shape (N,) give N
weight matrices.  Images are HWC; weights are computed in float32 and the
products accumulate in float32, cast back to the image dtype at the end.
"""

from __future__ import annotations

from typing import Literal

import torch

Method = Literal["linear", "cubic"]


def _kernel_linear(x):
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


def _kernel_cubic(x, a: float = -0.5):
    """Catmull-Rom-family cubic (a=-0.5 matches PIL/resize-right bicubic)."""
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, inner, torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


_KERNELS = {"linear": _kernel_linear, "cubic": _kernel_cubic}


def axis_resize_weights(out_size: int, in_size: int, start, size,
                        method: Method = "cubic", pad: int = 0,
                        device=None) -> torch.Tensor:
    """Resampling matrix for one axis: window [start, start+size) of a
    length-`in_size` axis (plus `pad` virtual zero pixels on each side)
    resized to `out_size` samples.  `start`/`size` are scalars or (N,)
    tensors; returns (out_size, in_size) or (N, out_size, in_size)
    float32 weights."""
    kernel = _KERNELS[method]
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    size = torch.as_tensor(size, dtype=torch.float32, device=device)
    dev = start.device
    start = start[..., None, None]  # (..., 1, 1)
    size = size[..., None, None]

    i = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]  # (out, 1)
    scale = size / out_size
    centers = start + (i + 0.5) * scale - 0.5  # (..., out, 1)
    stretch = torch.clamp_min(scale, 1.0)  # antialias when downsampling

    j = torch.arange(-pad, in_size + pad, dtype=torch.float32, device=dev)[None, :]
    d = (j - centers) / stretch
    w = kernel(d)
    # zero outside the crop window (the window may reach into the pad)
    in_window = (j >= start - 0.5) & (j < start + size - 0.5)
    w = torch.where(in_window, w, torch.zeros_like(w))
    # normalize per output row over the valid support (edge handling)
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-8)
    if pad:
        w = w[..., pad : pad + in_size]  # virtual pad pixels contribute zero
    return w


def crop_resize(image: torch.Tensor, y0, x0, h_size, w_size, out_size: int,
                method: Method = "cubic") -> torch.Tensor:
    """Crop windows [y0:y0+h_size, x0:x0+w_size] of one HWC image and resize
    each to (out_size, out_size, C) as two matmuls.  Geometry arguments are
    scalars (one crop -> (S, S, C)) or (N,) tensors (N crops ->
    (N, S, S, C))."""
    h, w = image.shape[0], image.shape[1]
    wy = axis_resize_weights(out_size, h, y0, h_size, method, device=image.device)
    wx = axis_resize_weights(out_size, w, x0, w_size, method, device=image.device)
    img = image.to(torch.float32)
    tmp = torch.einsum("...oh,hwc->...owc", wy, img)
    out = torch.einsum("...pw,...owc->...opc", wx, tmp)
    return out.to(image.dtype)


def pad_to_square_resize(image: torch.Tensor, out_size: int,
                         method: Method = "cubic") -> torch.Tensor:
    """Zero-pad an HWC image to a centered square of its longer side, then
    resize to (out_size, out_size, C); the padding is folded into the
    weights, never materialized."""
    h, w = image.shape[0], image.shape[1]
    long_side = max(h, w)
    pad_y = (long_side - h) // 2
    pad_x = (long_side - w) // 2
    dev = image.device
    wy = axis_resize_weights(out_size, h, -pad_y, long_side, method, pad=pad_y, device=dev)
    wx = axis_resize_weights(out_size, w, -pad_x, long_side, method, pad=pad_x, device=dev)
    img = image.to(torch.float32)
    tmp = torch.einsum("oh,hwc->owc", wy, img)
    out = torch.einsum("pw,owc->opc", wx, tmp)
    return out.to(image.dtype)
