"""Carry the JAX package's parameters into the port's modules.

The JAX package keeps parameters as flax trees (`{"params": {...}}`, plus
`{"batch_stats": {...}}` for the ResNet towers' BatchNorm running
statistics; here nested dicts of numpy arrays).  A path under
`batch_stats` is written with that collection name first; every other path
is under `params`.  These functions map every leaf onto the
port's `state_dict` keys, which follow the reference torch checkpoints:

* conv kernel (kh, kw, I, O)         -> weight (O, I, kh, kw)
* dense kernel (in, out)             -> weight (out, in)
* CLIP `PatchEmbed` kernel (p, p, c, w) -> conv weight (w, c, p, p)
* GroupNorm/LayerNorm/BatchNorm scale, bias -> weight, bias
* BatchNorm `batch_stats` mean, var  -> running_mean, running_var
* `Embed.embedding`                  -> weight
* CLIP `class_embedding`, `positional_embedding`, `proj`,
  `text_projection`; BERT `pos_emb`; the VQ `codebook` -> the same array
* BERT fused `qkv` kernel (in, 3 * inner) -> to_q, to_k and to_v weights,
  one third each, transposed (several port keys read one JAX leaf)

It is the inverse of the JAX package's converters (`models/convert.py`,
`models/ldm/convert.py`), written independently of them.  Loading fails on any JAX leaf left unused and on any
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
    # one third of a fused (in, 3 * inner) dense kernel: q, k, v
    **{f"qkv{j}": (lambda a, j=j: np.split(a, 3, axis=-1)[j].T) for j in range(3)},
}
_TO_JAX_SHAPE: Dict[str, Callable[[tuple], tuple]] = {
    "same": lambda s: s,
    "dense": lambda s: (s[1], s[0]),
    "conv": lambda s: (s[2], s[3], s[1], s[0]),
    **{f"qkv{j}": (lambda s: (s[1], 3 * s[0])) for j in range(3)},
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


def _batchnorm(leaf: str, prefix: Path) -> Tuple[Path, str]:
    """BatchNorm weight/bias (params) and running statistics (batch_stats)."""
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats",) + prefix + (leaf[len("running_"):],), "same"
    name, kind = _leaf(leaf, "norm")
    return prefix + (name,), kind


def _resnet_rule(v: List[str], leaf: str) -> Tuple[Path, str]:
    """`visual.*` keys of a ModifiedResNet tower."""
    if v[0] == "attnpool":
        if v[1] == "positional_embedding":
            return ("visual", "attnpool", "positional_embedding"), "same"
        name, kind = _leaf(leaf, "dense")
        return ("visual", "attnpool", v[1], name), kind
    if v[0].startswith("layer"):  # layerN.i.<sub>[.k].leaf
        block = ("visual", f"{v[0]}_{v[1]}")
        sub = v[2]
        if sub == "downsample":
            if v[3] == "0":
                return block + ("downsample_conv", "kernel"), "conv"
            return _batchnorm(leaf, block + ("downsample_bn",))
        if sub.startswith("bn"):
            return _batchnorm(leaf, block + (sub,))
        return block + (sub, "kernel"), "conv"
    if v[0].startswith("bn"):
        return _batchnorm(leaf, ("visual", v[0]))
    return ("visual", v[0], "kernel"), "conv"  # stem conv1-3


def clip_rule(key: str) -> Tuple[Path, str]:
    """Port CLIP key (ViT or ModifiedResNet) -> (JAX path, transform)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "visual":
        v = parts[1:]
        if v[0] in ("attnpool", "bn1", "bn2", "bn3", "conv2", "conv3") or v[0].startswith("layer"):
            return _resnet_rule(v, leaf)
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


# aesthetic MLP: torch Sequential index -> flax layer name (Linear layers
# at 0, 2, 4, 6, 7 with Dropouts between)
_MLP_LAYER_MAP = {"0": "fc0", "2": "fc1", "4": "fc2", "6": "fc3", "7": "fc4"}


def aesthetic_rule(key: str) -> Tuple[Path, str]:
    """Port aesthetic head key (`linear.*` or `layers.N.*`) -> JAX path."""
    parts = key.split(".")
    layer = "linear" if parts[0] == "linear" else _MLP_LAYER_MAP[parts[1]]
    name, kind = _leaf(parts[-1], "dense")
    return (layer, name), kind


# torchvision VGG16 `features` indices of the 13 convs, in order
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips_rule(key: str) -> Tuple[Path, str]:
    """Port LPIPS key (`net.sliceS.I.*`, `linN.model.1.weight`) -> JAX path."""
    parts = key.split(".")
    if parts[0] == "net":
        conv = f"conv{VGG16_CONV_IDX.index(int(parts[2]))}"
        name, kind = _leaf(parts[-1], "conv")
        return ("vgg", conv, name), kind
    return (parts[0], "kernel"), "conv"


def _transformer_block(parts: List[str], leaf: str, prefix: Path) -> Tuple[Path, str]:
    """`transformer_blocks.D.<sub>` keys of an LDM SpatialTransformer."""
    block = prefix + (f"blocks_{parts[1]}",)
    sub = parts[2]
    if sub in ("norm1", "norm2", "norm3"):
        name, kind = _leaf(leaf, "norm")
        return block + (sub, name), kind
    if sub in ("attn1", "attn2"):  # to_q, to_k, to_v, to_out.0
        name, kind = _leaf(leaf, "dense")
        return block + (sub, parts[3], name), kind
    if parts[2:5] == ["ff", "net", "0"]:  # GEGLU projection
        name, kind = _leaf(leaf, "dense")
        return block + ("ff_geglu", "proj", name), kind
    if parts[2:5] == ["ff", "net", "2"]:
        name, kind = _leaf(leaf, "dense")
        return block + ("ff_out", name), kind
    raise KeyError(f"unmapped transformer block key: {'.'.join(parts)}")


def ldm_unet_rule(key: str) -> Tuple[Path, str]:
    """Port LDM UNet key (CompVis names) -> JAX path; the ResBlocks, the
    stem, the time embedding and the head share the ADM UNet's rule."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] in ("input_blocks", "output_blocks", "middle_block"):
        if parts[0] == "middle_block":
            block, rest = f"middle_block_{parts[1]}", parts[2:-1]
        else:
            block, rest = f"{parts[0]}_{parts[1]}_{parts[2]}", parts[3:-1]
        if rest and rest[0] == "transformer_blocks":
            return _transformer_block(rest, leaf, (block,))
        if rest in (["proj_in"], ["proj_out"], ["op"], ["conv"]):
            name, kind = _leaf(leaf, "conv")
            return (block, rest[0], name), kind
    return unet_rule(key)


def vq_rule(key: str) -> Tuple[Path, str]:
    """Port VQ key (taming names) -> JAX path."""
    parts = key.split(".")
    leaf = parts[-1]
    if key == "quantize.embedding.weight":
        return ("codebook",), "same"
    if parts[0] in ("quant_conv", "post_quant_conv"):
        name, kind = _leaf(leaf, "conv")
        return (parts[0], name), kind
    scope, p = parts[0], parts[1:-1]
    if p[0] == "mid":  # mid.block_1.<sub>, mid.attn_1.<sub>
        layer, sub = f"mid_{p[1]}", p[2]
    elif p[0] in ("down", "up") and p[2] in ("block", "attn"):  # down.L.block.I.<sub>
        layer, sub = f"{p[0]}_{p[1]}_{p[2]}_{p[3]}", p[4]
    elif p[0] in ("down", "up"):  # down.L.downsample.conv, up.L.upsample.conv
        name, kind = _leaf(leaf, "conv")
        return (scope, f"{p[0]}_{p[1]}_{p[2]}", name), kind
    elif p[0] == "norm_out":
        name, kind = _leaf(leaf, "norm")
        return (scope, "norm_out", "GroupNorm_0", name), kind
    else:  # conv_in, conv_out
        name, kind = _leaf(leaf, "conv")
        return (scope, p[0], name), kind
    if sub.startswith("norm"):
        name, kind = _leaf(leaf, "norm")
        return (scope, layer, sub, "GroupNorm_0", name), kind
    name, kind = _leaf(leaf, "conv")  # conv1, conv2, nin_shortcut, q, k, v, proj_out
    return (scope, layer, sub, name), kind


_QKV = {"to_q": "qkv0", "to_k": "qkv1", "to_v": "qkv2"}


def bert_rule(key: str) -> Tuple[Path, str]:
    """Port BERT key (x-transformers names) -> JAX path; to_q/to_k/to_v
    are the thirds of the fused `qkv` kernel."""
    parts = key.split(".")
    leaf = parts[-1]
    if key == "token_emb.weight":
        return ("token_emb", "embedding"), "same"
    if key == "pos_emb.emb.weight":
        return ("pos_emb",), "same"
    if parts[0] == "norm":  # the final LayerNorm
        name, kind = _leaf(leaf, "norm")
        return ("norm", name), kind
    pair, odd = divmod(int(parts[2]), 2)  # attn_layers.layers.I.<j>...
    block = (f"layers_{pair}",)
    if parts[3] == "0":  # the pre-norm LayerNorm
        name, kind = _leaf(leaf, "norm")
        return block + ("norm2" if odd else "norm1", name), kind
    if not odd and parts[4] in _QKV:
        return block + ("qkv", "kernel"), _QKV[parts[4]]
    if not odd and parts[4] == "to_out":
        layer = "attn_out"
    elif odd and parts[4:7] == ["net", "0", "0"]:
        layer = "ff_in"
    elif odd and parts[4:6] == ["net", "2"]:
        layer = "ff_out"
    else:
        raise KeyError(f"unmapped BERT key: {key}")
    name, kind = _leaf(leaf, "dense")
    return block + (layer, name), kind


def esrgan_rule(key: str) -> Tuple[Path, str]:
    """Port RRDBNet key (basicsr names: `body.N.rdbM.convK.*`, `conv_*`) ->
    JAX path."""
    parts = key.split(".")
    name, kind = _leaf(parts[-1], "conv")
    if parts[0] == "body":
        return (f"body_{parts[1]}", parts[2], parts[3], name), kind
    return (parts[0], name), kind


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


def _flat_collections(tree: Mapping) -> Dict[Path, np.ndarray]:
    """Leaves of `params` by path, and of `batch_stats` by ("batch_stats",
    path); a bare tree is taken as the params."""
    if "params" not in tree:
        return _flatten(tree)
    flat = _flatten(tree["params"])
    if "batch_stats" in tree:
        flat.update(_flatten(tree["batch_stats"], ("batch_stats",)))
    return flat


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
    flat = _flat_collections(tree)
    sd = {}
    used = set()
    for path, shape, key, kind in jax_layout(module, rule):
        if path not in flat:
            raise KeyError(f"port parameter {key} has no JAX leaf {'/'.join(path)}")
        arr = flat[path]
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{'/'.join(path)}: JAX shape {tuple(arr.shape)}, expected {shape} for {key}"
            )
        if path in used and not kind.startswith("qkv"):  # only a fused qkv feeds several keys
            raise KeyError(f"JAX leaf {'/'.join(path)} mapped twice (again for {key})")
        sd[key] = torch.from_numpy(np.array(_TO_PORT[kind](arr), order="C"))
        used.add(path)
    unused = set(flat) - used
    if unused:
        raise KeyError(f"JAX leaves not used by the port: {sorted('/'.join(p) for p in unused)}")
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


def load_aesthetic(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, aesthetic_rule)


def load_lpips(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, lpips_rule)


def load_ldm_unet(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, ldm_unet_rule)


def load_vq(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, vq_rule)


def load_bert(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, bert_rule)


def load_esrgan(module: nn.Module, tree: Mapping) -> nn.Module:
    return load_into(module, tree, esrgan_rule)
