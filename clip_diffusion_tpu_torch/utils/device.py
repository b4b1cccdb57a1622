"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
`device` argument they take `cuda` and raise when no GPU is present, so a
run never drops to the CPU without being asked to.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` -> `cuda`; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
