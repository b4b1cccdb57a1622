"""Operations and bytes, counted from the frozen reference, never from the
program, so the count stays the same whatever implements the work.

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over the
reference modules on the `meta` device: matmuls and convolutions, forward
and, where asked, the input-gradient backward (the parameters take no
gradient, so only the input's is formed).  Element-wise work is not
counted.  Peaks are NVIDIA's published H100 SXM figures.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

H100_BF16_DENSE_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
H100_HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth


def count(fn, *args, backward: bool = False) -> int:
    """FLOPs of `fn(*args)` on meta tensors; with `backward`, plus the
    gradient of the output's sum with respect to the first argument."""
    with FlopCounterMode(display=False) as counter:
        with torch.enable_grad():
            x = args[0].requires_grad_(backward)
            out = fn(x, *args[1:])
            if backward:
                out.float().sum().backward()
    return int(counter.get_total_flops())


def on_meta(build):
    """A reference module built on the meta device, frozen."""
    with torch.device("meta"):
        module = build()
    return module.requires_grad_(False).eval()


def quantile_bytes(rows: int, n: int, itemsize: int) -> int:
    """The threshold kernel's least traffic: x read once, one float32
    threshold per row written."""
    return rows * n * itemsize + rows * 4
