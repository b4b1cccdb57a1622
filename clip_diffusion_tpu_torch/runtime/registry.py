"""Per-request finetuned-UNet registry for the serving surface.

Counterpart of `clip_diffusion_tpu.runtime.registry`.  A client picks a
model type per request (the reference UI's 通用 general, 景觀 landscape,
建築 building); the registry maps the name to a finetuned UNet's release
file and hands its state dict to `guided_diffusion_sample` as
`custom_model_params`:

* `register(name, path)` binds a name to a release file (the ADM layout,
  attention weights as Conv1d, as `zoo`'s `guided_unet_*` slots);
* `discover(root)` registers every `guided_unet_custom_<slug>.pt` under
  the port's weights root by its slug, and the reference UI aliases of the
  slugs found;
* `load(name)` loads a file once, on first use, under the lock, through
  `utils/checkpoint.load_validated` against a `meta` `UNetModel`, and keeps
  it on the registry's device, cached by path, so aliases share one dict.

The default names (通用, general, default) map to None: the zoo's own UNet.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import torch

from clip_diffusion_tpu_torch.models.convert import convert_unet
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.utils.checkpoint import load_validated
from clip_diffusion_tpu_torch.utils.device import resolve_device

# reference UI name -> checkpoint slug
REFERENCE_ALIASES = {
    "通用": None,
    "general": None,
    "default": None,
    "景觀": "landscape",
    "landscape": "landscape",
    "建築": "building",
    "building": "building",
}

CUSTOM_PREFIX = "guided_unet_custom_"


class UnknownModelType(KeyError):
    """A model_type with no registry entry: a client error (400), unlike a
    KeyError raised while reading a registered file (a server error, 500)."""


class UNetRegistry:
    """Thread-safe name -> finetuned-UNet state dict registry.

    `unet` is the zoo's UNet that a finetune stands in for (the server
    passes `models.unet`): a file must match its config, is cast to its
    dtype and loads onto its device.  Without one, the UNet that
    `guided_diffusion_sample` builds when given no zoo (512², bf16) on
    `device` (default `cuda`)."""

    def __init__(self, unet: Optional[UNetModel] = None,
                 entries: Optional[Dict[str, str]] = None, device=None):
        self._paths: Dict[str, str] = dict(entries or {})
        self._cache: Dict[str, Dict[str, torch.Tensor]] = {}
        self._lock = threading.Lock()
        if unet is None:
            self._config, self._dtype = UNetConfig.for_image_size(512), torch.bfloat16
            self._device = resolve_device(device)
        elif device is not None:
            raise ValueError("UNetRegistry: the device is the given UNet's")
        else:
            param = next(unet.parameters())
            self._config, self._dtype, self._device = unet.config, param.dtype, param.device

    def register(self, name: str, checkpoint_path: str) -> None:
        """Bind `name` to the release file at `checkpoint_path`."""
        if not os.path.isfile(checkpoint_path):
            raise FileNotFoundError(f"model registry: {checkpoint_path!r} is not a file")
        with self._lock:
            self._paths[name] = checkpoint_path
            self._cache.pop(checkpoint_path, None)

    def discover(self, root: Optional[str] = None) -> "UNetRegistry":
        """Register each `<root>/guided_unet_custom_<slug>.pt` under its slug
        (root: the zoo's, `$CLIP_DIFFUSION_TORCH`, default models/torch),
        and the reference UI aliases (景觀, 建築) of the slugs found."""
        from clip_diffusion_tpu_torch.zoo import torch_root

        root = torch_root(root)
        with self._lock:
            if os.path.isdir(root):
                for entry in sorted(os.listdir(root)):
                    full = os.path.join(root, entry)
                    if entry.startswith(CUSTOM_PREFIX) and entry.endswith(".pt") \
                            and os.path.isfile(full):
                        self._paths.setdefault(entry[len(CUSTOM_PREFIX):-len(".pt")], full)
            for alias, slug in REFERENCE_ALIASES.items():
                if slug is not None and slug in self._paths:
                    self._paths.setdefault(alias, self._paths[slug])
        return self

    def names(self):
        """Registered model-type names; the default names are always valid."""
        with self._lock:
            registered = set(self._paths)
        return sorted(registered | {a for a, s in REFERENCE_ALIASES.items() if s is None})

    def load(self, name: Optional[str]):
        """The state dict for `name`, cached after its first load; None for
        the default model type.  Raises UnknownModelType for a name that is
        not registered."""
        if name is None or (name in REFERENCE_ALIASES and REFERENCE_ALIASES[name] is None):
            return None
        with self._lock:
            if name not in self._paths:
                raise UnknownModelType(
                    f"unknown model_type {name!r}; registered: {sorted(self._paths)}")
            path = self._paths[name]
            # loaded under the lock: concurrent first requests for one
            # finetune must not each put a full UNet on the device
            if path not in self._cache:
                self._cache[path] = self._load_checkpoint(path)
            return self._cache[path]

    def _load_checkpoint(self, path: str) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            template = UNetModel(self._config)
        return load_validated(path, template, convert_unet, self._dtype,
                              "finetuned UNet", self._device)
