"""Pipeline factory: build the guided pipeline from the model zoo.

Counterpart of `clip_diffusion_tpu.zoo` for the guided request: pick the
CLIP perceptors by name, build the ADM UNet, the aesthetic heads and LPIPS,
embed the prompt per perceptor.  Real checkpoints are not in the repository
yet, so every model is randomly initialized host-side with numpy by the JAX
zoo's rules (`_host_init`): `scale` and any leaf whose name holds `var` ->
ones, `bias` and `mean` -> zeros (these draw no random numbers), everything
else N(0, 1/fan_in) with fan_in the product of all but the last JAX
dimension, drawn from one `np.random.default_rng(seed)` in the flax tree's
leaf order and carried into the port's layout by `models/from_jax.py`.  The
same seed therefore gives the same weights as the JAX zoo.
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
from clip_diffusion_tpu_torch.models.aesthetic import CLIP_DIMS, make_aesthetic_predictor
from clip_diffusion_tpu_torch.models.clip.model import CLIP_PRESETS, CLIPModel
from clip_diffusion_tpu_torch.models.clip.tokenizer import tokenize
from clip_diffusion_tpu_torch.models.lpips import LPIPS
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline.guided import GuidedPipeline, Perceptor
from clip_diffusion_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ZooModels:
    """Initialized models, reusable across prompts and requests."""

    unet: UNetModel
    clips: Dict[str, CLIPModel]
    aesthetic: Dict[str, nn.Module] = dataclasses.field(default_factory=dict)
    lpips: Optional[LPIPS] = None  # only when the init-image losses need it


def host_init_state_dict(module: nn.Module, rule, seed: int = 0,
                         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random parameters for `module` by the JAX zoo's host-init rules, in
    the JAX leaf order (see module docstring)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for path, shape, key, kind in from_jax.jax_layout(module, rule):
        name = path[-1]
        if name == "scale" or "var" in name:
            arr = np.ones(shape)
        elif name in ("bias", "mean"):
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


def build_clip(model_name: str, param_dtype=torch.bfloat16, seed: int = 0,
               device=None) -> CLIPModel:
    ccfg = dataclasses.replace(CLIP_PRESETS[model_name], dtype=param_dtype)
    return _materialize(lambda: CLIPModel(ccfg), from_jax.clip_rule,
                        clip_seed(model_name, seed), param_dtype,
                        resolve_device(device))


def build_lpips(seed: int = 1000, device=None) -> LPIPS:
    """LPIPS (VGG16) in float32, the JAX zoo's seed."""
    return _materialize(LPIPS, from_jax.lpips_rule, seed, torch.float32,
                        resolve_device(device))


def build_models(
    config: Config,
    image_size: int = 512,
    param_dtype=torch.bfloat16,
    seed: int = 0,
    with_aesthetic: bool = False,
    with_lpips: bool = False,
    unet_config: Optional[UNetConfig] = None,
    device=None,
) -> ZooModels:
    """Build the UNet, the chosen CLIP towers and, when asked, their
    aesthetic heads (float32, seed + 100 + the tower's position, for the
    towers in `chosen_predictors` that have one) and LPIPS (float32, seed +
    1000) on `device` (default `cuda`), randomly initialized as the JAX zoo
    does when no checkpoint is provisioned."""
    device = resolve_device(device)
    unknown = [n for n in config.chosen_clip_models if n not in CLIP_PRESETS]
    if unknown:  # fail before any large build
        raise KeyError(f"unknown CLIP model(s) {unknown}")
    ucfg = unet_config or UNetConfig.for_image_size(image_size)
    unet = _materialize(lambda: UNetModel(ucfg), from_jax.unet_rule, seed,
                        param_dtype, device)
    clips, aesthetic = {}, {}
    for i, name in enumerate(config.chosen_clip_models):
        clips[name] = build_clip(name, param_dtype, seed, device)
        if with_aesthetic and name in config.chosen_predictors and name in CLIP_DIMS:
            aesthetic[name] = _materialize(
                lambda n=name: make_aesthetic_predictor(n), from_jax.aesthetic_rule,
                seed + 100 + i, torch.float32, device)
    lpips = build_lpips(seed + 1000, device) if with_lpips else None
    return ZooModels(unet, clips, aesthetic, lpips)


def build_pipeline(
    models: ZooModels,
    config: Config,
    prompts: Sequence[Tuple[str, float]],
    sampler: SamplerConfig,
    use_init_losses: bool = False,
) -> GuidedPipeline:
    """Embed the prompts per perceptor and wire the pipeline, with each
    perceptor's aesthetic head and the zoo's LPIPS where present.

    `prompts`: (text, weight) pairs shared by every image, or a list of such
    lists, one per image (per-image text embeddings (B, Pmax, D) with
    zero-weight padding).  `use_init_losses` turns on the LPIPS and MS-SSIM
    terms against the init image."""
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
            aesthetic_fn=models.aesthetic.get(name),
        ))
    return GuidedPipeline(
        unet=models.unet,
        perceptors=tuple(perceptors),
        config=config,
        sampler=sampler,
        schedule=make_schedule(steps=sampler.steps),
        device=device,
        lpips_fn=models.lpips,
        use_init_losses=use_init_losses,
    )
