"""Public torch release files -> the port's state dicts.

Counterpart of `clip_diffusion_tpu.models.convert`.  The port's parameter
names follow the public releases (`models/from_jax.py`), so most of the
conversion is a key check: every key must be one that the family's rule in
`models/from_jax.py` maps, else `KeyError` (as the JAX converters raise),
and `validate_against` then holds the result to the module's own keys and
shapes.  The layout work is:

* ADM UNet: the attention `qkv` and `proj_out` weights are Conv1d
  (O, I, 1) in the release and Linear (O, I) in the port;
* CLIP: `logit_scale`, BatchNorm `num_batches_tracked` and the TorchScript
  archives' `input_resolution`, `context_length` and `vocab_size` are
  dropped.

The other families convert beside their models (`models/esrgan`,
`models/lpips`, `models/aesthetic`, `models/t5`, `models/marian`,
`models/ldm/convert`).
"""

from __future__ import annotations

import zipfile
from typing import Callable, Dict, List, Mapping

import torch

from clip_diffusion_tpu_torch.models.from_jax import clip_rule, unet_rule

StateDict = Dict[str, torch.Tensor]

# the wrappings releases put around their state dict: lightning
# ("state_dict"), basicsr ("params_ema" preferred over "params")
RELEASE_WRAPPINGS = ("state_dict", "params_ema", "params")


def load_torch_state_dict(path: str, allow_torchscript: bool = False) -> StateDict:
    """A release file -> its state dict of CPU tensors.

    Read with `torch.load(weights_only=True)`, memory-mapped when the file
    is in the zip format (a legacy pre-1.6 file is read whole), and
    unwrapped from `RELEASE_WRAPPINGS`.  With `allow_torchscript`, a
    TorchScript archive (how OpenAI ships CLIP) is read through
    `torch.jit.load(...).state_dict()`; otherwise it is refused."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            torchscript = any(n.endswith("constants.pkl") for n in zf.namelist())
        if torchscript:
            if not allow_torchscript:
                raise ValueError(f"{path} is a TorchScript archive, which only CLIP slots accept")
            sd = torch.jit.load(path, map_location="cpu").state_dict()
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, Mapping):
        for wrap in RELEASE_WRAPPINGS:
            if isinstance(sd.get(wrap), Mapping):
                sd = sd[wrap]
                break
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a state dict")
    bad = [k for k, v in sd.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise ValueError(f"{path}: entries that are not tensors: {bad[:3]}")
    return dict(sd)


def check_key(key: str, rule: Callable, family: str) -> None:
    """Raise KeyError when `rule` (a `from_jax` rule) cannot map `key`."""
    try:
        rule(key)
    except (KeyError, IndexError, ValueError) as e:
        raise KeyError(f"unmapped {family} key: {key}") from e


def validate_against(template: Mapping[str, torch.Tensor],
                     converted: Mapping[str, torch.Tensor]) -> List[str]:
    """The mismatches between a converted state dict and the module's own
    (`template`, e.g. built on the `meta` device): missing and unexpected
    keys, and shapes; empty when they match."""
    problems = [f"missing {k}" for k in sorted(template) if k not in converted]
    problems += [f"unexpected {k}" for k in sorted(converted) if k not in template]
    for k in sorted(set(template) & set(converted)):
        want, got = tuple(template[k].shape), tuple(converted[k].shape)
        if want != got:
            problems.append(f"shape {k}: expected {want} got {got}")
    return problems


def _is_adm_attention_weight(key: str) -> bool:
    return key.endswith((".qkv.weight", ".proj_out.weight"))


def convert_unet(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """ADM release state dict -> the port's `UNetModel` keys: the attention
    Conv1d (O, I, 1) weights become Linear (O, I)."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        check_key(key, unet_rule, "UNet")
        if _is_adm_attention_weight(key) and val.ndim == 3:
            val = val[..., 0]
        out[key] = val
    return out


def release_unet_state_dict(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The inverse of `convert_unet`: the port's UNet state dict in the
    release layout, attention weights as Conv1d (O, I, 1) (how a finetune
    is saved for the zoo or the serving registry)."""
    return {k: (v[..., None] if _is_adm_attention_weight(k) else v)
            for k, v in state_dict.items()}


# present in OpenAI's checkpoints, unused by the towers
_CLIP_DROPPED = ("logit_scale", "input_resolution", "context_length", "vocab_size")


def convert_clip(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """OpenAI CLIP state dict (ViT or ModifiedResNet; from a plain file or a
    TorchScript archive) -> the port's `CLIPModel` keys."""
    out = {}
    for key, val in state_dict.items():
        if key in _CLIP_DROPPED or key.endswith("num_batches_tracked"):
            continue
        check_key(key, clip_rule, "CLIP")
        out[key] = val
    return out
