"""Pipeline factory: build the guided and latent pipelines from the model
zoo.

Counterpart of `clip_diffusion_tpu.zoo`.  For the guided request: pick the
CLIP perceptors by name, build the ADM UNet, the aesthetic heads and LPIPS,
embed the prompt per perceptor.  For the latent request: the LDM UNet
(seed, `param_dtype`), the VQ-f8 first stage (seed + 1, float32) and the
BERT encoder (seed + 2, `param_dtype`), and Real-ESRGAN (seed 2000,
float32).  For the text front end: the sentence-T5 encoder (seed, float32)
and MarianMT (`init_marian`).  Real checkpoints are not in the repository
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
import os
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
from clip_diffusion_tpu_torch.models.clip.tokenizer import default_bpe_path, get_tokenizer, tokenize
from clip_diffusion_tpu_torch.models.esrgan import RRDBNet
from clip_diffusion_tpu_torch.models.ldm.autoencoder import VQConfig, VQModel
from clip_diffusion_tpu_torch.models.ldm.bert import BERTConfig, BERTEmbedder, bert_tokenize
from clip_diffusion_tpu_torch.models.ldm.unet import LDMUNet, LDMUNetConfig
from clip_diffusion_tpu_torch.models.lpips import LPIPS
from clip_diffusion_tpu_torch.models.marian import MarianConfig, MarianMT
from clip_diffusion_tpu_torch.models.t5 import SentenceT5, T5Config
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline.guided import GuidedPipeline, Perceptor
from clip_diffusion_tpu_torch.pipeline.latent import LatentPipeline
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
    drawn_path, drawn = None, None
    for path, shape, key, kind in from_jax.jax_layout(module, rule):
        if path != drawn_path:  # one draw per JAX leaf (a fused qkv feeds three keys)
            name = path[-1]
            if name == "scale" or "var" in name:
                drawn = np.ones(shape)
            elif name in ("bias", "mean"):
                drawn = np.zeros(shape)
            else:
                fan_in = int(np.prod(shape[:-1])) or 1
                drawn = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
            drawn_path = path
        # cast first, then lay out: a bf16 copy is cheaper than a float64 one
        sd[key] = torch.from_numpy(from_jax._TO_PORT[kind](drawn)).to(dtype).contiguous()
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


@dataclasses.dataclass
class LatentModels:
    """The LDM stack: cross-attention UNet, VQ-f8 first stage, BERT."""

    unet: LDMUNet
    vq: VQModel
    bert: BERTEmbedder


def build_latent_models(param_dtype=torch.bfloat16, seed: int = 0, tiny: bool = False,
                        device=None) -> LatentModels:
    """The LDM txt2img-f8-large stack on `device` (default `cuda`), randomly
    initialized as the JAX zoo does: the UNet at `seed` and the BERT at
    seed + 2 in `param_dtype`, the VQ at seed + 1 in float32.  `tiny`
    builds the test configs, the BERT as wide as the tiny UNet's context."""
    device = resolve_device(device)
    ucfg = LDMUNetConfig.tiny() if tiny else LDMUNetConfig()
    vcfg = VQConfig.tiny() if tiny else VQConfig()
    bcfg = BERTConfig.tiny() if tiny else BERTConfig()
    if tiny:
        bcfg = dataclasses.replace(bcfg, n_embed=ucfg.context_dim)
    unet = _materialize(lambda: LDMUNet(ucfg), from_jax.ldm_unet_rule, seed, param_dtype, device)
    vq = _materialize(lambda: VQModel(vcfg), from_jax.vq_rule, seed + 1, torch.float32, device)
    bert = _materialize(lambda: BERTEmbedder(bcfg), from_jax.bert_rule, seed + 2, param_dtype,
                        device)
    return LatentModels(unet, vq, bert)


class BertTextEncoder:
    """texts -> (N, 77, D) float32 context through the BERT on its device."""

    def __init__(self, bert: BERTEmbedder):
        self.bert = bert

    @torch.inference_mode()
    def __call__(self, texts):
        device = self.bert.token_emb.weight.device
        toks = torch.from_numpy(bert_tokenize(texts)).to(device=device, dtype=torch.long)
        return self.bert(toks)


def build_latent_pipeline(models: LatentModels) -> Tuple[LatentPipeline, BertTextEncoder]:
    """(LatentPipeline, text_encode) over the stack's modules."""
    pipe = LatentPipeline(
        unet=models.unet,
        decode=models.vq.decode,
        encode=models.vq.encode,
        latent_channels=models.vq.cfg.embed_dim,
        downsample=2 ** (len(models.vq.cfg.ch_mult) - 1),
    )
    return pipe, BertTextEncoder(models.bert)


def build_esrgan(scale: int = 4, seed: int = 2000, tiny: bool = False,
                 device=None) -> RRDBNet:
    """The Real-ESRGAN upsampler, RRDBNet(3, 3, 64, 23, 32, scale) in
    float32, on `device` (default `cuda`); `tiny`: 16 features, 2 blocks,
    growth 8."""
    if tiny:
        build = lambda: RRDBNet(scale=scale, num_feat=16, num_block=2, num_grow_ch=8)
    else:
        build = lambda: RRDBNet(scale=scale)
    return _materialize(build, from_jax.esrgan_rule, seed, torch.float32, resolve_device(device))


def load_or_init_sentence_t5(param_dtype=torch.float32, seed: int = 0,
                             device=None) -> SentenceT5:
    """The full-width sentence-T5 on `device` (default `cuda`), randomly
    initialized as the JAX package's `load_or_init_sentence_t5` does
    without converted weights: the one tower the query encoder and the
    committed modifier bank (data/banks/modifiers_t5.npy) share.  Converted
    weights at `T5_PARAMS_PATH` (default data/t5/params) cannot be loaded
    yet: a present directory raises rather than serving random weights."""
    path = os.environ.get("T5_PARAMS_PATH", "data/t5/params")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"sentence-T5 weights at {path}: checkpoint loading is not ported yet "
            "(ROADMAP Queue 1 item 13)"
        )
    return _materialize(lambda: SentenceT5(T5Config()), from_jax.t5_rule, seed, param_dtype,
                        resolve_device(device))


def init_marian(cfg: Optional[MarianConfig] = None, seed: int = 0, device=None) -> MarianMT:
    """MarianMT (default: the opus-mt-zh-en geometry) on `device` (default
    `cuda`), randomly initialized by the JAX zoo's rule with float32
    parameters (`cfg.dtype` sets the compute precision); stands in for the
    converted weights until checkpoint loading is ported."""
    cfg = cfg or MarianConfig.opus_zh_en()
    return _materialize(lambda: MarianMT(cfg), from_jax.marian_rule, seed, torch.float32,
                        resolve_device(device))


def weights_provenance() -> dict:
    """Whether scores from this process compare with the reference's: every
    tree the port serves is a random-init stand-in (checkpoint loading is
    not ported yet), and the CLIP tokenizer is the real BPE table only when
    that file is present."""
    if get_tokenizer.cache_info().currsize:
        real_bpe = type(get_tokenizer()).__name__ == "SimpleTokenizer"
    else:  # nothing tokenized yet: what would be used
        real_bpe = default_bpe_path() is not None
    return {
        "weights": "random-init stand-in (not reference-comparable)",
        "tokenizer": "real-bpe" if real_bpe else "hash-standin",
        "reference_comparable": False,
    }
