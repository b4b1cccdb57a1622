"""Pipeline factory: build the guided pipeline from the model zoo.

Counterpart of `clip_diffusion_tpu.zoo` for the main path: pick the CLIP
perceptors by name, build the ADM UNet, embed the prompt per perceptor.
Real checkpoints are not in the repository yet, so every model is randomly
initialized host-side with numpy by the JAX zoo's rules (`_host_init`) for
the leaves these models have: `scale` -> ones, `bias` -> zeros, everything else
N(0, 1/fan_in) with fan_in the product of all but the last JAX dimension,
drawn from one `np.random.default_rng(seed)` in the flax tree's leaf order
and carried into the port's layout by `models/from_jax.py`.  The same seed
therefore gives the same weights as the JAX zoo.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.diffusion.schedule import make_schedule
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip.model import CLIP_PRESETS, CLIPConfig, CLIPModel
from clip_diffusion_tpu_torch.models.clip.tokenizer import tokenize
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline.guided import GuidedPipeline, Perceptor
from clip_diffusion_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ZooModels:
    """Initialized models, reusable across prompts and requests."""

    unet: UNetModel
    clips: Dict[str, CLIPModel]


def host_init_state_dict(module: nn.Module, rule, seed: int = 0,
                         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random parameters for `module` by the JAX zoo's host-init rules, in
    the JAX leaf order (see module docstring)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for path, shape, key, kind in from_jax.jax_layout(module, rule):
        name = path[-1]
        if name == "scale":
            arr = np.ones(shape)
        elif name == "bias":
            arr = np.zeros(shape)
        else:
            fan_in = int(np.prod(shape[:-1])) or 1
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        arr = np.ascontiguousarray(from_jax._TO_PORT[kind](arr))
        sd[key] = torch.from_numpy(arr).to(dtype)
    return sd


def _materialize(build, rule, seed: int, dtype, device) -> nn.Module:
    """Construct a module without initializing it, then fill it."""
    with torch.device("meta"):
        module = build().to(dtype)
    module = module.to_empty(device=device)
    module.load_state_dict(host_init_state_dict(module, rule, seed, dtype))
    module.requires_grad_(False)
    return module.eval()


def clip_seed(model_name: str, seed: int = 0) -> int:
    """Per-tower seed depending only on the model name (JAX zoo rule)."""
    return seed + (zlib.crc32(model_name.encode()) % 100000)


def _vit_config(model_name: str, dtype) -> CLIPConfig:
    if model_name not in CLIP_PRESETS:
        raise KeyError(f"unknown CLIP model {model_name!r}")
    ccfg = dataclasses.replace(CLIP_PRESETS[model_name], dtype=dtype)
    if not ccfg.is_vit:
        raise NotImplementedError(
            f"CLIP {model_name}: the ModifiedResNet towers (RN50, RN101) are a "
            "later slice of the PyTorch port; choose ViT perceptors"
        )
    return ccfg


def build_clip(model_name: str, param_dtype=torch.bfloat16, seed: int = 0,
               device=None) -> CLIPModel:
    ccfg = _vit_config(model_name, param_dtype)
    return _materialize(lambda: CLIPModel(ccfg), from_jax.clip_rule,
                        clip_seed(model_name, seed), param_dtype,
                        resolve_device(device))


def build_models(
    config: Config,
    image_size: int = 512,
    param_dtype=torch.bfloat16,
    seed: int = 0,
    unet_config: Optional[UNetConfig] = None,
    device=None,
) -> ZooModels:
    """Build the UNet and the chosen CLIP towers on `device` (default
    `cuda`), randomly initialized as the JAX zoo does when no checkpoint is
    provisioned."""
    device = resolve_device(device)
    for name in config.chosen_clip_models:  # fail before any large build
        _vit_config(name, param_dtype)
    ucfg = unet_config or UNetConfig.for_image_size(image_size)
    unet = _materialize(lambda: UNetModel(ucfg), from_jax.unet_rule, seed,
                        param_dtype, device)
    clips = {name: build_clip(name, param_dtype, seed, device)
             for name in config.chosen_clip_models}
    return ZooModels(unet, clips)


def build_pipeline(
    models: ZooModels,
    config: Config,
    prompts: Sequence[Tuple[str, float]],
    sampler: SamplerConfig,
) -> GuidedPipeline:
    """Embed the prompts per perceptor and wire the pipeline.

    `prompts`: (text, weight) pairs shared by every image, or a list of such
    lists, one per image (per-image text embeddings (B, Pmax, D) with
    zero-weight padding)."""
    device = next(models.unet.parameters()).device
    batched = bool(prompts) and not isinstance(prompts[0][0], str)
    if batched:
        pmax = max(len(p) for p in prompts)
        texts = [t for p in prompts for t, _ in p]
        weights = np.zeros((len(prompts), pmax), np.float32)
        for i, p in enumerate(prompts):
            weights[i, : len(p)] = [w for _, w in p]
            if abs(weights[i]).sum() < 1e-3:
                raise RuntimeError("The text_weights must not sum to 0.")
        offsets = np.cumsum([0] + [len(p) for p in prompts])
    else:
        texts = [t for t, _ in prompts]
        weights = np.asarray([w for _, w in prompts], np.float32)
        if abs(weights).sum() < 1e-3:
            raise RuntimeError("The text_weights must not sum to 0.")
    toks = torch.from_numpy(tokenize(texts)).to(device=device, dtype=torch.long)
    text_w = torch.from_numpy(weights).to(device)

    perceptors = []
    for name, model in models.clips.items():
        with torch.no_grad():
            text_emb = model.encode_text(toks)
        if batched:
            emb = torch.zeros((len(prompts), pmax, text_emb.shape[-1]),
                              dtype=torch.float32, device=device)
            for i in range(len(prompts)):
                emb[i, : offsets[i + 1] - offsets[i]] = text_emb[offsets[i]:offsets[i + 1]]
            text_emb = emb
        perceptors.append(Perceptor(
            name=name,
            embed_image=model.encode_image,
            input_resolution=model.cfg.image_resolution,
            text_embeddings=text_emb,
            text_weights=text_w,
        ))
    return GuidedPipeline(
        unet=models.unet,
        perceptors=tuple(perceptors),
        config=config,
        sampler=sampler,
        schedule=make_schedule(steps=sampler.steps),
        device=device,
    )
