"""Loading model weights from public torch release files.

Counterpart of the parameter half of `clip_diffusion_tpu.utils.checkpoint`
(the sampling-state resume, `SamplingState`, comes with the segmented
runner).  `load_validated` is the one validated-load sequence that the zoo
(`zoo.load_or_init`) and the serving registry (`runtime/registry.py`)
share, so their strict-load policy cannot drift apart.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from clip_diffusion_tpu_torch.models.convert import load_torch_state_dict, validate_against


def load_validated(path: str, template_module: nn.Module, convert: Optional[Callable],
                   param_dtype: torch.dtype, what: str, device,
                   allow_torchscript: bool = False) -> Dict[str, torch.Tensor]:
    """Read the release file at `path` (`models/convert.load_torch_state_dict`)
    -> `convert` it to the port's keys -> check it against
    `template_module.state_dict()` (keys and shapes; the template may live
    on the `meta` device) -> cast floating tensors to `param_dtype`, leaving
    integer ones as they are -> one copy to `device`.  Raises RuntimeError
    naming the path and the first three problems when it does not match."""
    sd = load_torch_state_dict(path, allow_torchscript)
    if convert is not None:
        sd = convert(sd)
    problems = validate_against(template_module.state_dict(), sd)
    if problems:
        raise RuntimeError(f"checkpoint {path} does not match the {what} template: "
                           f"{problems[:3]}...")
    return {k: v.to(device=device, dtype=param_dtype if v.is_floating_point() else v.dtype)
            for k, v in sd.items()}
