"""Carry the JAX package's parameters into the port's modules.

The JAX package keeps parameters as flax trees (`{"params": {...}}`, here
nested dicts of numpy arrays).  These functions map every leaf onto the
port's `state_dict` keys, which follow the reference torch checkpoints:

* conv kernel (kh, kw, I, O)         -> weight (O, I, kh, kw)
* dense kernel (in, out)             -> weight (out, in)
* CLIP `PatchEmbed` kernel (p, p, c, w) -> conv weight (w, c, p, p)
* GroupNorm/LayerNorm scale, bias    -> weight, bias
* `Embed.embedding`                  -> weight
* CLIP `class_embedding`, `positional_embedding`, `proj`,
  `text_projection`                  -> the same array

It is the inverse of the JAX package's `models/convert.py`, written
independently of it.  Loading fails on any JAX leaf left unused and on any
port parameter left unset.  `jax_layout` runs the same mapping backwards
(port key -> JAX path and shape), which the zoo uses to draw random
weights in the JAX package's leaf order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]

# how a JAX leaf becomes a port tensor, and back
_TO_PORT: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "same": lambda a: a,
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(3, 2, 0, 1),
}
_TO_JAX_SHAPE: Dict[str, Callable[[tuple], tuple]] = {
    "same": lambda s: s,
    "dense": lambda s: (s[1], s[0]),
    "conv": lambda s: (s[2], s[3], s[1], s[0]),
}


def _leaf(leaf: str, layer: str) -> Tuple[str, str]:
    """weight/bias of a norm, dense or conv layer -> (JAX leaf, transform)."""
    if layer == "norm":
        return ("scale" if leaf == "weight" else "bias"), "same"
    if leaf == "bias":
        return "bias", "same"
    return "kernel", layer


def unet_rule(key: str) -> Tuple[Path, str]:
    """Port UNet key -> (JAX path under "params", transform)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "time_embed":
        name, kind = _leaf(leaf, "dense")
        return (f"time_embed_{parts[1]}", name), kind
    if parts[0] == "out":
        if parts[1] == "0":
            name, kind = _leaf(leaf, "norm")
            return ("out_0", "GroupNorm_0", name), kind
        name, kind = _leaf(leaf, "conv")
        return ("out_2", name), kind
    if parts[0] == "middle_block":
        block, rest = f"middle_block_{parts[1]}", parts[2:-1]
    else:
        block, rest = f"{parts[0]}_{parts[1]}_{parts[2]}", parts[3:-1]
    sub = "_".join(rest)
    if not rest:  # input_blocks.0.0, the stem conv
        name, kind = _leaf(leaf, "conv")
        return (block, name), kind
    if sub in ("in_layers_0", "out_layers_0", "norm"):
        name, kind = _leaf(leaf, "norm")
        return (block, sub, "GroupNorm_0", name), kind
    if sub in ("emb_layers_1", "qkv", "proj_out"):
        name, kind = _leaf(leaf, "dense")
        return (block, sub, name), kind
    if sub in ("in_layers_2", "out_layers_3", "skip_connection"):
        name, kind = _leaf(leaf, "conv")
        return (block, sub, name), kind
    raise KeyError(f"unmapped UNet key: {key}")


def _clip_block(parts: List[str], leaf: str, prefix: Path) -> Tuple[Path, str]:
    """`resblocks.N.<sub>` keys of a CLIP transformer."""
    block = prefix + (f"resblocks_{parts[1]}",)
    sub = parts[2]
    if sub in ("ln_1", "ln_2"):
        name, kind = _leaf(leaf, "norm")
        return block + (sub, "LayerNorm_0", name), kind
    if sub == "attn":
        if parts[3] == "in_proj_weight":
            return block + ("attn", "in_proj", "kernel"), "dense"
        if parts[3] == "in_proj_bias":
            return block + ("attn", "in_proj", "bias"), "same"
        name, kind = _leaf(leaf, "dense")
        return block + ("attn", "out_proj", name), kind
    if sub == "mlp":
        name, kind = _leaf(leaf, "dense")
        return block + (f"mlp_{parts[3]}", name), kind
    raise KeyError(f"unmapped CLIP transformer key: {'.'.join(parts)}")


def clip_rule(key: str) -> Tuple[Path, str]:
    """Port CLIP (ViT) key -> (JAX path under "params", transform)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "visual":
        v = parts[1:]
        if v[0] == "transformer":
            return _clip_block(v[1:], leaf, ("visual", "transformer"))
        if v[0] in ("class_embedding", "positional_embedding", "proj"):
            return ("visual", v[0]), "same"
        if v[0] in ("ln_pre", "ln_post"):
            name, kind = _leaf(leaf, "norm")
            return ("visual", v[0], "LayerNorm_0", name), kind
        if v[0] == "conv1":
            return ("visual", "conv1", "kernel"), "conv"
    elif parts[0] == "transformer":
        return _clip_block(parts[1:], leaf, ("transformer",))
    elif parts[0] == "token_embedding":
        return ("token_embedding", "embedding"), "same"
    elif parts[0] in ("positional_embedding", "text_projection"):
        return (parts[0],), "same"
    elif parts[0] == "ln_final":
        name, kind = _leaf(leaf, "norm")
        return ("ln_final", "LayerNorm_0", name), kind
    raise KeyError(f"unmapped CLIP key: {key}")


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            arr = np.asarray(v)
            if arr.dtype.name == "bfloat16":  # no torch.from_numpy for it; exact
                arr = arr.astype(np.float32)
            flat[prefix + (str(k),)] = arr
    return flat


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def jax_layout(module: nn.Module, rule) -> List[Tuple[Path, tuple, str, str]]:
    """[(JAX path, JAX shape, port key, transform)] for every port
    parameter, sorted by JAX path (the flax tree's leaf order)."""
    out = []
    for key, t in module.state_dict().items():
        path, kind = rule(key)
        out.append((path, _TO_JAX_SHAPE[kind](tuple(t.shape)), key, kind))
    return sorted(out)


def to_state_dict(tree: Mapping, module: nn.Module, rule) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> state_dict for `module` (float32 numpy leaves
    keep their dtype; the caller casts)."""
    flat = _flatten(_params(tree))
    sd = {}
    for path, shape, key, kind in jax_layout(module, rule):
        if path not in flat:
            raise KeyError(f"port parameter {key} has no JAX leaf {'/'.join(path)}")
        arr = flat.pop(path)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{'/'.join(path)}: JAX shape {tuple(arr.shape)}, expected {shape} for {key}"
            )
        sd[key] = torch.from_numpy(np.array(_TO_PORT[kind](arr), order="C"))
    if flat:
        raise KeyError(f"JAX leaves not used by the port: {sorted('/'.join(p) for p in flat)}")
    return sd


def load_into(module: nn.Module, tree: Mapping, rule) -> nn.Module:
    """Load a JAX parameter tree into `module` in place (each parameter
    keeps its dtype and device)."""
    sd = to_state_dict(tree, module, rule)
    module.load_state_dict(sd, strict=True)
    return module


def load_unet(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, unet_rule)


def load_clip(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, clip_rule)

