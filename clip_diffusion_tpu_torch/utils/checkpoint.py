"""Loading model weights from public torch release files, and the sampler
state of a trajectory for preemption-safe resume.

Counterpart of `clip_diffusion_tpu.utils.checkpoint`.  `load_validated` is
the one validated-load sequence that the zoo (`zoo.load_or_init`) and the
serving registry (`runtime/registry.py`) share, so their strict-load policy
cannot drift apart.  `SamplingState` is what `pipeline.guided.guided_sample`
needs to continue a trajectory in a new process, in the JAX package's
`.npz` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
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


@dataclasses.dataclass
class SamplingState:
    """A guided trajectory between two steps.  `key_data` holds the draws'
    key (`TorchDraws.key_data`: its seed as uint32 words), so a resume in a
    new process needs this file and the models only; a resume under other
    draws raises rather than continue a different trajectory."""

    x: torch.Tensor  # (B, H, W, 3) x_t
    step: int  # the next respaced step to execute (counts down; -1 when done)
    eps_history: torch.Tensor  # (3, B, H, W, 3) the PLMS ring, zeros for DDIM
    history_count: int
    key_data: np.ndarray

    def save(self, path: str) -> None:
        np.savez(
            path,
            x=self.x.detach().cpu().numpy(),
            step=self.step,
            eps_history=self.eps_history.detach().cpu().numpy(),
            history_count=self.history_count,
            key_data=np.asarray(self.key_data, np.uint32),
        )

    @staticmethod
    def load(path: str) -> "SamplingState":
        """The state at `path`, its tensors on the CPU."""
        with np.load(path) as z:
            return SamplingState(
                x=torch.from_numpy(z["x"]),
                step=int(z["step"]),
                eps_history=torch.from_numpy(z["eps_history"]),
                history_count=int(z["history_count"]),
                key_data=np.asarray(z["key_data"], np.uint32),
            )
