"""Fast |x|-quantile for dynamic thresholding.

`histogram_quantile` is the port of the Pallas TPU kernel
`clip_diffusion_tpu.ops.quantile.histogram_quantile_pallas`: a per-row
single-level histogram of |x| / max|x| (2048 bins), its cumulative sum, the
first bin reaching q*N and linear interpolation inside it; error <=
max|x| / bins.  On a CUDA tensor it launches the hand-written kernel in
`csrc/histogram_quantile.cu` (or raises); on a CPU tensor it runs
`histogram_quantile_plain`, the same arithmetic in plain PyTorch, which is
also what the kernel is held against on the card.

`histogram_abs_quantile` is the JAX package's XLA formulation (two-level
edge counting, 4096 effective bins), kept here in plain PyTorch off the
main path so tests can bound how far the two packages' `"histogram"`
thresholds may drift apart: both are within max|x| / bins of the exact
quantile, with different bin edges.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from clip_diffusion_tpu_torch.diffusion.sampling import apply_threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_BINS = 12288  # the kernel's block histogram fits 48 KB of shared memory
_HIST_BLOCK_ELEMS = 4096  # elements per block before a row is split further
_TARGET_BLOCKS = 4 * 132  # about four blocks per SM of an H100


def _target(q: float, n: int) -> float:
    """float32(q * N), the count the cumulative histogram must reach."""
    return float(np.float32(q * n))


def histogram_quantile_plain(x: torch.Tensor, q: float, bins: int = 2048) -> torch.Tensor:
    """(B, N) -> (B,) float32 approximate q-quantile of |x| per row, in
    plain PyTorch with the kernel's float32 expressions."""
    b, n = x.shape
    ax = torch.abs(x.to(torch.float32))
    hi = torch.clamp_min(torch.amax(ax, dim=1), 1e-12)  # (B,)
    idx = torch.clamp((ax / hi[:, None] * bins).to(torch.int32), 0, bins - 1)
    hist = torch.zeros((b, bins), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, idx.to(torch.int64), torch.ones_like(idx, dtype=torch.int64))
    cdf = torch.cumsum(hist, dim=1)
    target = _target(q, n)
    # first bin reaching the target; argmax of all-false is bin 0
    bin_idx = torch.argmax((cdf.to(torch.float32) >= target).to(torch.int8), dim=1)
    prev = torch.gather(cdf, 1, torch.clamp_min(bin_idx - 1, 0)[:, None])[:, 0]
    cdf_prev = torch.where(bin_idx > 0, prev, torch.zeros_like(prev)).to(torch.float32)
    count = torch.gather(hist, 1, bin_idx[:, None])[:, 0].to(torch.float32)
    frac = torch.clamp((target - cdf_prev) / torch.clamp_min(count, 1.0), 0.0, 1.0)
    return (bin_idx.to(torch.float32) + frac) / bins * hi


def _launch(x: torch.Tensor, q: float, bins: int) -> torch.Tensor:
    from clip_diffusion_tpu_torch.ops import kernels

    lib = kernels.load("histogram_quantile")
    fn = lib.histogram_quantile_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    rows, n = x.shape
    # max|x| outside the kernel, as the TPU kernel takes it (through SMEM)
    hi = torch.amax(torch.abs(x), dim=1).to(torch.float32).contiguous()
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    hist = torch.zeros((rows, bins), dtype=torch.int32, device=x.device)
    splits = max(1, min(math.ceil(n / _HIST_BLOCK_ELEMS),
                        math.ceil(_TARGET_BLOCKS / rows)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], hi.data_ptr(), out.data_ptr(),
             hist.data_ptr(), rows, n, bins, splits, _target(q, n), stream)
    if err != 0:
        raise RuntimeError(f"histogram_quantile kernel launch failed: cudaError {err}")
    histogram_quantile.launches += 1
    return out


def histogram_quantile(x: torch.Tensor, q: float, bins: int = 2048) -> torch.Tensor:
    """(B, N) values -> (B,) float32 approximate q-quantile of |x| per row.

    CUDA tensors (float32, bfloat16 or float16, contiguous) launch the
    hand-written kernel; CPU tensors take the plain version.  Nothing falls
    back: a CUDA tensor the kernel cannot take raises."""
    if x.ndim != 2:
        raise ValueError(f"histogram_quantile expects (B, N), got {tuple(x.shape)}")
    if not 1 <= bins <= _MAX_BINS:
        raise ValueError(f"bins must be in [1, {_MAX_BINS}], got {bins}")
    if x.device.type == "cpu":
        return histogram_quantile_plain(x, q, bins)
    if x.device.type != "cuda":
        raise ValueError(f"histogram_quantile: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"histogram_quantile: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("histogram_quantile: x must be contiguous")
    if not 1 <= x.shape[0] <= 65535 or x.shape[1] < 1:
        raise ValueError(f"histogram_quantile: unsupported shape {tuple(x.shape)}")
    return _launch(x, q, bins)


histogram_quantile.launches = 0  # kernel launches, for run reports


def histogram_abs_quantile(x: torch.Tensor, q: float, bins: int = 4096) -> torch.Tensor:
    """The JAX main path's quantile: two-level edge counting with
    lvl = ceil(sqrt(bins)) coarse and fine edges; error <= max|x| / bins."""
    lvl = max(int(math.ceil(math.sqrt(bins))), 2)
    ax = torch.abs(x.to(torch.float32))
    n = x.shape[1]
    target = _target(q, n)
    hi = torch.amax(ax, dim=1, keepdim=True)
    scale = torch.clamp_min(hi, 1e-12)
    steps = torch.arange(1, lvl + 1, dtype=torch.float32, device=x.device) / lvl

    cnt1 = torch.sum(ax[:, :, None] <= scale[:, :, None] * steps[None, None, :], dim=1)
    c_idx = torch.argmax((cnt1 >= target).to(torch.int8), dim=1)
    lo = c_idx.to(torch.float32)[:, None] / lvl * scale
    prev1 = torch.gather(cnt1, 1, torch.clamp_min(c_idx - 1, 0)[:, None])[:, 0]
    below_lo = torch.where(c_idx > 0, prev1, torch.zeros_like(prev1))

    width = scale / lvl
    edges2 = lo + width * steps[None, :]
    cnt2 = torch.sum(ax[:, :, None] <= edges2[:, None, :], dim=1)
    f_idx = torch.argmax((cnt2 >= target).to(torch.int8), dim=1)
    prev2 = torch.gather(cnt2, 1, torch.clamp_min(f_idx - 1, 0)[:, None])[:, 0]
    cdf_prev = torch.where(f_idx > 0, prev2, below_lo).to(torch.float32)
    count = torch.gather(cnt2, 1, f_idx[:, None])[:, 0].to(torch.float32) - cdf_prev
    frac = torch.clamp((target - cdf_prev) / torch.clamp_min(count, 1.0), 0.0, 1.0)
    return lo[:, 0] + (f_idx.to(torch.float32) + frac) * (width[:, 0] / lvl)


def dynamic_threshold_fast(x_start: torch.Tensor, percentile: float,
                           bins: int = 2048) -> torch.Tensor:
    """Histogram-quantile dynamic thresholding (drop-in for
    `diffusion.sampling.dynamic_threshold`); one `histogram_quantile` call."""
    b = x_start.shape[0]
    thresh = histogram_quantile(x_start.reshape(b, -1).contiguous(), percentile, bins)
    return apply_threshold(x_start, thresh)
