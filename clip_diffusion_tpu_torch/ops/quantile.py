"""Fast |x|-quantile for dynamic thresholding.

Two functions, each a mode of the one hand-written kernel in
`csrc/histogram_quantile.cu`, each with its plain PyTorch version beside it:

- `histogram_abs_quantile` (plain: `histogram_abs_quantile_plain`) is the
  JAX main path's threshold, `clip_diffusion_tpu.ops.quantile.
  histogram_abs_quantile`: two-level edge counting with lvl = ceil(sqrt(bins))
  coarse and fine edges, 4096 effective bins by default; error <= max|x| /
  bins.  `dynamic_threshold_fast`, the sampler's `"histogram"` threshold,
  calls it once per step.
- `histogram_quantile` (plain: `histogram_quantile_plain`) is the port of
  the Pallas TPU kernel `histogram_quantile_pallas`: a per-row single-level
  histogram of |x| / max|x| (2048 bins), its cumulative sum, the first bin
  reaching q*N and linear interpolation inside it; error <= max|x| / bins.
  Nothing on the main path calls it.

On a CUDA tensor each launches the kernel (one launch per call) or raises;
on a CPU tensor it runs its plain version, which is also what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch

from clip_diffusion_tpu_torch.diffusion.sampling import apply_threshold
from clip_diffusion_tpu_torch.utils.profiling import annotate

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_BINS = 12288  # the kernel's mode A totals fit 48 KB of shared memory


def _target(q: float, n: int) -> float:
    """float32(q * N), the count the cumulative histogram must reach."""
    return float(np.float32(q * n))


def _levels(bins: int) -> int:
    """lvl = ceil(sqrt(bins)), at least 2."""
    return max(math.isqrt(bins - 1) + 1, 2)


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


def histogram_abs_quantile_plain(x: torch.Tensor, q: float, bins: int = 4096) -> torch.Tensor:
    """The JAX main path's quantile in plain PyTorch: two-level edge counting
    with lvl = ceil(sqrt(bins)) coarse and fine edges; error <= max|x| / bins.
    Divisions by lvl divide by a device tensor, which CUDA rounds as IEEE
    division (a Python-scalar divisor becomes a reciprocal product there)."""
    lvl = _levels(bins)
    flvl = torch.tensor(float(lvl), device=x.device)
    ax = torch.abs(x.to(torch.float32))
    n = x.shape[1]
    target = _target(q, n)
    hi = torch.amax(ax, dim=1, keepdim=True)
    scale = torch.clamp_min(hi, 1e-12)
    steps = torch.arange(1, lvl + 1, dtype=torch.float32, device=x.device) / flvl

    cnt1 = torch.sum(ax[:, :, None] <= scale[:, :, None] * steps[None, None, :], dim=1)
    c_idx = torch.argmax((cnt1 >= target).to(torch.int8), dim=1)
    lo = c_idx.to(torch.float32)[:, None] / flvl * scale
    prev1 = torch.gather(cnt1, 1, torch.clamp_min(c_idx - 1, 0)[:, None])[:, 0]
    below_lo = torch.where(c_idx > 0, prev1, torch.zeros_like(prev1))

    width = scale / flvl
    edges2 = lo + width * steps[None, :]
    cnt2 = torch.sum(ax[:, :, None] <= edges2[:, None, :], dim=1)
    f_idx = torch.argmax((cnt2 >= target).to(torch.int8), dim=1)
    prev2 = torch.gather(cnt2, 1, torch.clamp_min(f_idx - 1, 0)[:, None])[:, 0]
    cdf_prev = torch.where(f_idx > 0, prev2, below_lo).to(torch.float32)
    count = torch.gather(cnt2, 1, f_idx[:, None])[:, 0].to(torch.float32) - cdf_prev
    frac = torch.clamp((target - cdf_prev) / torch.clamp_min(count, 1.0), 0.0, 1.0)
    return lo[:, 0] + (f_idx.to(torch.float32) + frac) * (width[:, 0] / flvl)


_LIB = None  # the kernel's library, argtypes bound once
_WS_INTS: Dict[Tuple[int, int, int, int], int] = {}  # (mode, bins, rows, device) -> ints
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}  # (device, stream) -> zeroed int32


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the kernel library's C functions."""
    lib.histogram_quantile_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.histogram_quantile_launch.restype = ctypes.c_int
    lib.histogram_quantile_workspace_ints.argtypes = [ctypes.c_int] * 4
    lib.histogram_quantile_workspace_ints.restype = ctypes.c_longlong
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from clip_diffusion_tpu_torch.ops import kernels

        _LIB = bind(kernels.load("histogram_quantile"))
    return _LIB


def _workspace_ints(lib, two_level: bool, bins: int, rows: int, device: torch.device) -> int:
    key = (int(two_level), bins, rows, device.index)
    ints = _WS_INTS.get(key)
    if ints is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        ints = _WS_INTS[key] = lib.histogram_quantile_workspace_ints(int(two_level), bins, rows, sms)
    return ints


def _workspace(device: torch.device, stream: int, ints: int) -> torch.Tensor:
    """The zeroed int32 workspace of (device, stream), at least `ints` long.
    The kernel leaves it zeroed, so it is allocated once and reused."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < ints:
        ws = torch.zeros((ints,), dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws


def _launch(x: torch.Tensor, q: float, bins: int, two_level: bool, grid=None) -> torch.Tensor:
    """One cooperative launch; `grid` (a ctypes.c_int) receives its block count.
    Each launch is an `ops.quantile` span while a profile collects; the
    functions' `.launches` count every launch."""
    with annotate("ops.quantile"):
        lib = _lib()
        rows, n = x.shape
        dev = x.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream, _workspace_ints(lib, two_level, bins, rows, dev))
        out = torch.empty((rows,), dtype=torch.float32, device=dev)
        err = lib.histogram_quantile_launch(
            x.data_ptr(), _DTYPE_CODES[x.dtype], int(two_level), out.data_ptr(), ws.data_ptr(),
            ws.numel(), rows, n, bins, _target(q, n), stream,
            None if grid is None else ctypes.byref(grid))
        if err != 0:
            raise RuntimeError(f"histogram quantile kernel launch failed: cudaError {err}")
        (histogram_abs_quantile if two_level else histogram_quantile).launches += 1
        return out


def _check(name: str, x: torch.Tensor, bins: int) -> bool:
    """Validate the arguments; True for a CUDA tensor the kernel takes,
    False for a CPU tensor.  Raises for anything else."""
    if x.ndim != 2:
        raise ValueError(f"{name} expects (B, N), got {tuple(x.shape)}")
    if not 1 <= bins <= _MAX_BINS:
        raise ValueError(f"bins must be in [1, {_MAX_BINS}], got {bins}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.shape[0] < 1 or not 1 <= x.shape[1] < 2**31:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    return True


def histogram_quantile(x: torch.Tensor, q: float, bins: int = 2048) -> torch.Tensor:
    """(B, N) values -> (B,) float32 approximate q-quantile of |x| per row,
    the Pallas kernel's single-level histogram (the kernel's mode A).

    CUDA tensors (float32, bfloat16 or float16, contiguous) launch the
    hand-written kernel; CPU tensors take the plain version.  Nothing falls
    back: a CUDA tensor the kernel cannot take raises."""
    if not _check("histogram_quantile", x, bins):
        return histogram_quantile_plain(x, q, bins)
    return _launch(x, q, bins, two_level=False)


histogram_quantile.launches = 0  # kernel launches, for run reports


def histogram_abs_quantile(x: torch.Tensor, q: float, bins: int = 4096) -> torch.Tensor:
    """(B, N) values -> (B,) float32 approximate q-quantile of |x| per row,
    the JAX main path's two-level count (the kernel's mode B).  Devices,
    types and errors as `histogram_quantile`."""
    if not _check("histogram_abs_quantile", x, bins):
        return histogram_abs_quantile_plain(x, q, bins)
    return _launch(x, q, bins, two_level=True)


histogram_abs_quantile.launches = 0  # kernel launches, for run reports


def dynamic_threshold_fast(x_start: torch.Tensor, percentile: float,
                           bins: int = 4096) -> torch.Tensor:
    """Histogram-quantile dynamic thresholding (drop-in for
    `diffusion.sampling.dynamic_threshold`), as the JAX package's
    `dynamic_threshold_fast`: one `histogram_abs_quantile` call."""
    b = x_start.shape[0]
    thresh = histogram_abs_quantile(x_start.reshape(b, -1).contiguous(), percentile, bins)
    return apply_threshold(x_start, thresh)
