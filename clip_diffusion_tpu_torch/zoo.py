"""Pipeline factory: build the guided and latent pipelines from the model
zoo.

Counterpart of `clip_diffusion_tpu.zoo`.  For the guided request: pick the
CLIP perceptors by name, build the ADM UNet, the aesthetic heads and LPIPS,
embed the prompt per perceptor.  For the latent request: the LDM UNet
(seed, `param_dtype`), the VQ-f8 first stage (seed + 1, float32) and the
BERT encoder (seed + 2, `param_dtype`), and Real-ESRGAN (seed 2000,
float32).  For Stable Diffusion XL base 1.0 through the same latent
request: its UNet (seed), the CLIP ViT-L/14 (seed + 1) and OpenCLIP
ViT-bigG/14 (seed + 2) text towers in `param_dtype`, and the KL-f8 first
stage (seed + 3, float32), random init only (no reader of SDXL's release
file yet).  For the text front end: the sentence-T5 encoder (seed,
float32) and MarianMT (`init_marian`).

Every builder goes through one gate, `load_or_init`.  The weights are the
public torch release files themselves, one per slot under the JAX
package's slot names: `<root>/<slot>.pt`, the root `$CLIP_DIFFUSION_TORCH`
(default models/torch).  A present file is read, converted to the port's
keys, validated against the module and loaded; an absent one means a
random init; a present file that cannot be used raises, and so does an
absent one whose JAX orbax slot is present (the port cannot read orbax),
unless `CLIP_DIFFUSION_TPU_LENIENT_LOAD` is set, which turns both into a
warning and a random init.  `weights_provenance` reports which trees were
loaded.

The random init is host-side numpy by the JAX zoo's rules (`_host_init`):
`scale` and any leaf whose name holds `var` -> ones, `bias` and `mean` ->
zeros (these draw no random numbers), everything else N(0, 1/fan_in) with
fan_in the product of all but the last JAX dimension, drawn from one
`np.random.default_rng(seed)` in the flax tree's leaf order and carried
into the port's layout by `models/from_jax.py`.  The same seed therefore
gives the same weights as the JAX zoo.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import zlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.diffusion.schedule import make_schedule
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.aesthetic import (
    CLIP_DIMS,
    convert_aesthetic,
    make_aesthetic_predictor,
)
from clip_diffusion_tpu_torch.models.clip.model import (
    CLIP_PRESETS,
    CLIP_TEXT_PRESETS,
    CLIPModel,
    CLIPTextConfig,
    CLIPTextModel,
)
from clip_diffusion_tpu_torch.models.clip.tokenizer import (
    EOT,
    default_bpe_path,
    get_tokenizer,
    tokenize,
)
from clip_diffusion_tpu_torch.models.convert import convert_clip, convert_unet
from clip_diffusion_tpu_torch.models.esrgan import RRDBNet, convert_rrdbnet
from clip_diffusion_tpu_torch.models.ldm.autoencoder import KLConfig, KLModel, VQConfig, VQModel
from clip_diffusion_tpu_torch.models.ldm.bert import BERTConfig, BERTEmbedder, bert_tokenize
from clip_diffusion_tpu_torch.models.ldm.convert import (
    convert_bert,
    convert_ldm_unet,
    convert_vq,
    split_ldm_state_dict,
)
from clip_diffusion_tpu_torch.models.ldm.unet import LDMUNet, LDMUNetConfig
from clip_diffusion_tpu_torch.models.lpips import LPIPS, convert_lpips
from clip_diffusion_tpu_torch.models.marian import MarianConfig, MarianMT, convert_marian
from clip_diffusion_tpu_torch.models.t5 import SentenceT5, T5Config, convert_sentence_t5
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel, timestep_embedding
from clip_diffusion_tpu_torch.pipeline.guided import GuidedPipeline, Perceptor
from clip_diffusion_tpu_torch.pipeline.latent import LatentPipeline
from clip_diffusion_tpu_torch.utils.checkpoint import load_validated
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


# the port's weights root: public torch release files, <root>/<slot>.pt
TORCH_ROOT_ENV = "CLIP_DIFFUSION_TORCH"
DEFAULT_TORCH_ROOT = os.path.join("models", "torch")
# the JAX package's orbax root, which the port cannot read; and the JAX
# package's own paths of the two text models' orbax trees
FLAX_ROOT_ENV = "CLIP_DIFFUSION_FLAX"
DEFAULT_FLAX_ROOT = os.path.join("models", "flax")
_JAX_TEXT_SLOTS = {"sentence_t5": ("T5_PARAMS_PATH", os.path.join("data", "t5", "params")),
                   "marian_zh_en": ("MARIAN_PARAMS_PATH", os.path.join("data", "marian", "params"))}
LENIENT_ENV = "CLIP_DIFFUSION_TPU_LENIENT_LOAD"


def torch_root(root: Optional[str] = None) -> str:
    """The port's weights root: `root`, else `$CLIP_DIFFUSION_TORCH`, else
    models/torch."""
    return root or os.environ.get(TORCH_ROOT_ENV, DEFAULT_TORCH_ROOT)


def _slot_file(name: str, root: Optional[str]) -> str:
    return os.path.abspath(os.path.join(torch_root(root), f"{name}.pt"))


def checkpoint_path(name: str, root: Optional[str] = None) -> Optional[str]:
    """Path of the release file `<root>/<name>.pt` if present, else None."""
    path = _slot_file(name, root)
    return path if os.path.isfile(path) else None


def jax_checkpoint_dir(name: str) -> Optional[str]:
    """The JAX package's orbax directory for slot `name` if present
    (`$CLIP_DIFFUSION_FLAX/<name>`, default models/flax/<name>; for the two
    text models also `T5_PARAMS_PATH` / `MARIAN_PARAMS_PATH`), else None."""
    candidates = [os.path.join(os.environ.get(FLAX_ROOT_ENV, DEFAULT_FLAX_ROOT), name)]
    if name in _JAX_TEXT_SLOTS:
        env, default = _JAX_TEXT_SLOTS[name]
        candidates.append(os.environ.get(env, default))
    return next((os.path.abspath(p) for p in candidates if os.path.isdir(p)), None)


def _refuse(message: str, error: Optional[Exception] = None) -> None:
    """Raise RuntimeError, or only warn in lenient mode (the caller then
    initializes)."""
    if not os.environ.get(LENIENT_ENV):
        raise RuntimeError(f"{message}; refusing to serve random init: remove it to run from "
                           f"init, or set {LENIENT_ENV}=1") from error
    warnings.warn(f"{message}; falling back to random init (lenient mode)")


def provisioned_checkpoint(name: str, root: Optional[str] = None,
                           file_slot: Optional[str] = None) -> Optional[str]:
    """The release file of slot `name` (read from `file_slot`'s file when
    several slots share one), or None when the slot is unprovisioned.  An
    absent file whose JAX orbax slot is present raises (`_refuse`)."""
    path = _slot_file(file_slot or name, root)
    if os.path.isfile(path):
        return path
    jax_dir = jax_checkpoint_dir(name)
    if jax_dir is not None:
        _refuse(f"the JAX package's checkpoint {jax_dir} is present but the port's file {path} "
                "is absent (the port reads torch release files, not orbax trees)")
    return None


# which trees this process served: loaded from release files or random
# init.  Scores are reference-comparable only when every tree loaded and the
# real BPE table is present.
_PROVENANCE = {"loaded": set(), "random_init": set()}


def load_or_init(name: str, build: Callable[[], nn.Module], rule, convert: Callable,
                 seed: int = 0, dtype=torch.bfloat16, device=None, root: Optional[str] = None,
                 file_slot: Optional[str] = None, allow_torchscript: bool = False) -> nn.Module:
    """The single gate every zoo builder goes through (the JAX zoo's
    `load_or_init`): the module `build()` returns, on `device` in `dtype`,
    loaded from slot `name`'s release file through `convert` when present
    (`utils/checkpoint.load_validated`: no weight is initialized and then
    overwritten, the module is built on `meta` and takes the loaded
    tensors), else randomly initialized by `rule` from `seed`.  A present
    file that fails to read or validate raises RuntimeError naming it, as
    does a JAX-only slot (`provisioned_checkpoint`); lenient mode warns and
    initializes instead."""
    device = resolve_device(device)
    path = provisioned_checkpoint(name, root, file_slot)
    if path is not None:
        with torch.device("meta"):
            module = build()
        try:
            sd = load_validated(path, module, convert, dtype, name, device, allow_torchscript)
        except Exception as e:  # noqa: BLE001 - any read or format problem
            _refuse(f"checkpoint {path} is present but unusable ({e!r})", e)
        else:
            module.load_state_dict(sd, assign=True)
            _PROVENANCE["loaded"].add(name)
            return module.requires_grad_(False).eval()
    _PROVENANCE["random_init"].add(name)
    return _materialize(build, rule, seed, dtype, device)


def clip_seed(model_name: str, seed: int = 0) -> int:
    """Per-tower seed depending only on the model name (JAX zoo rule)."""
    return seed + (zlib.crc32(model_name.encode()) % 100000)


def clip_checkpoint_name(model_name: str) -> str:
    return f"clip_{model_name.replace('/', '_')}"


def build_clip(model_name: str, param_dtype=torch.bfloat16, seed: int = 0,
               device=None, checkpoint_root: Optional[str] = None) -> CLIPModel:
    """One CLIP tower: OpenAI's release (a state dict or the TorchScript
    archive) from slot `clip_<name with / as _>`, else a random init whose
    seed depends only on the model name."""
    ccfg = dataclasses.replace(CLIP_PRESETS[model_name], dtype=param_dtype)
    return load_or_init(clip_checkpoint_name(model_name), lambda: CLIPModel(ccfg),
                        from_jax.clip_rule, convert_clip, clip_seed(model_name, seed),
                        param_dtype, device, checkpoint_root, allow_torchscript=True)


def build_lpips(seed: int = 1000, device=None, checkpoint_root: Optional[str] = None) -> LPIPS:
    """LPIPS (VGG16) in float32 from slot `lpips_vgg`, else the JAX zoo's
    seed."""
    return load_or_init("lpips_vgg", LPIPS, from_jax.lpips_rule, convert_lpips, seed,
                        torch.float32, device, checkpoint_root)


def build_aesthetic(model_name: str, seed: int, device=None,
                    checkpoint_root: Optional[str] = None) -> nn.Module:
    """The aesthetic head paired with CLIP tower `model_name`, float32, from
    slot `aesthetic_<name with / as _>`."""
    return load_or_init(f"aesthetic_{model_name.replace('/', '_')}",
                        lambda: make_aesthetic_predictor(model_name), from_jax.aesthetic_rule,
                        convert_aesthetic, seed, torch.float32, device, checkpoint_root)


def build_models(
    config: Config,
    image_size: int = 512,
    param_dtype=torch.bfloat16,
    seed: int = 0,
    with_aesthetic: bool = False,
    with_lpips: bool = False,
    checkpoint_root: Optional[str] = None,
    unet_config: Optional[UNetConfig] = None,
    device=None,
) -> ZooModels:
    """Build the UNet (slot `guided_unet_{image_size}`), the chosen CLIP
    towers and, when asked, their aesthetic heads (float32, seed + 100 + the
    tower's position, for the towers in `chosen_predictors` that have one)
    and LPIPS (float32, seed + 1000) on `device` (default `cuda`), each
    through the gate (`load_or_init`).  `unet_config` overrides the ADM
    architecture and keeps the slot."""
    device = resolve_device(device)
    unknown = [n for n in config.chosen_clip_models if n not in CLIP_PRESETS]
    if unknown:  # fail before any large build
        raise KeyError(f"unknown CLIP model(s) {unknown}")
    ucfg = unet_config or UNetConfig.for_image_size(image_size)
    unet = load_or_init(f"guided_unet_{image_size}", lambda: UNetModel(ucfg),
                        from_jax.unet_rule, convert_unet, seed, param_dtype, device,
                        checkpoint_root)
    clips, aesthetic = {}, {}
    for i, name in enumerate(config.chosen_clip_models):
        clips[name] = build_clip(name, param_dtype, seed, device, checkpoint_root)
        if with_aesthetic and name in config.chosen_predictors and name in CLIP_DIMS:
            aesthetic[name] = build_aesthetic(name, seed + 100 + i, device, checkpoint_root)
    lpips = build_lpips(seed + 1000, device, checkpoint_root) if with_lpips else None
    return ZooModels(unet, clips, aesthetic, lpips)


def with_unet_state_dict(models: ZooModels, state_dict: Dict[str, torch.Tensor]) -> ZooModels:
    """A shallow copy of `models` whose UNet takes `state_dict` (the port's
    layout, on the zoo's device in the zoo's dtype, e.g. from
    `runtime/registry.py`): a second `UNetModel` of the zoo's config, built
    on `meta`, is assigned the dict's tensors, so no weight is copied and
    the shared zoo stays as it is."""
    ref = models.unet.state_dict()
    unlike = sorted(f"{k} ({v.dtype} on {v.device}, the zoo's {ref[k].dtype} on {ref[k].device})"
                    for k, v in state_dict.items()
                    if k in ref and (v.device != ref[k].device or v.dtype != ref[k].dtype))
    if unlike:
        raise ValueError(f"custom UNet parameters unlike the zoo's in device or dtype: "
                         f"{unlike[:3]}")
    with torch.device("meta"):
        unet = UNetModel(models.unet.config)
    unet.load_state_dict(state_dict, strict=True, assign=True)
    return dataclasses.replace(models, unet=unet.requires_grad_(False).eval())


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
                        device=None, checkpoint_root: Optional[str] = None) -> LatentModels:
    """The LDM txt2img-f8-large stack on `device` (default `cuda`): the UNet
    (slot `ldm_unet`, else init at `seed`) and the BERT (`ldm_bert`, seed +
    2) in `param_dtype`, the VQ (`ldm_vq`, seed + 1) in float32.  The three
    slots read the one LatentDiffusion release file, `ldm.pt`, split by
    prefix (the UNet's LitEma shadows preferred).  `tiny` builds the test
    configs, the BERT as wide as the tiny UNet's context, and skips the
    gate unless `checkpoint_root` is given."""
    device = resolve_device(device)
    ucfg = LDMUNetConfig.tiny() if tiny else LDMUNetConfig()
    vcfg = VQConfig.tiny() if tiny else VQConfig()
    bcfg = BERTConfig.tiny() if tiny else BERTConfig()
    if tiny:
        bcfg = dataclasses.replace(bcfg, n_embed=ucfg.context_dim)

    def gate(name, build, rule, part, convert, dtype, s):
        if tiny and checkpoint_root is None:
            return _materialize(build, rule, s, dtype, device)
        return load_or_init(name, build, rule,
                            lambda sd: convert(split_ldm_state_dict(sd)[part]), s, dtype,
                            device, checkpoint_root, file_slot="ldm")

    unet = gate("ldm_unet", lambda: LDMUNet(ucfg), from_jax.ldm_unet_rule, 0, convert_ldm_unet,
                param_dtype, seed)
    vq = gate("ldm_vq", lambda: VQModel(vcfg), from_jax.vq_rule, 1, convert_vq, torch.float32,
              seed + 1)
    bert = gate("ldm_bert", lambda: BERTEmbedder(bcfg), from_jax.bert_rule, 2, convert_bert,
                param_dtype, seed + 2)
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


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    """Stable Diffusion XL base 1.0 (sgm `configs/inference/sd_xl_base.yaml`):
    the UNet, the two text towers with the block whose hidden state the
    context takes (CLIP ViT-L/14 after 11 of 12 blocks, as Hugging Face's
    `hidden_states[11]`; bigG after 31 of 32, "penultimate"), the KL-f8
    first stage and the width of each size number's embedding."""

    unet: LDMUNetConfig = dataclasses.field(default_factory=LDMUNetConfig.sdxl)
    clip_l: CLIPTextConfig = dataclasses.replace(CLIP_TEXT_PRESETS["ViT-L/14"], embed_dim=0)
    clip_g: CLIPTextConfig = CLIP_TEXT_PRESETS["ViT-bigG/14"]
    vae: KLConfig = KLConfig()
    clip_l_layer: int = 11
    clip_g_layer: int = 31
    size_embed_dim: int = 256

    @staticmethod
    def tiny() -> "SDXLConfig":
        """Test widths: context 16 + 24, vector 24 + 6 x 8."""
        unet = LDMUNetConfig(model_channels=32, channel_mult=(1, 2, 4), attention_ds=(2, 4),
                             num_heads=-1, num_head_channels=16, transformer_depth=(0, 1, 2),
                             context_dim=40, use_linear_in_transformer=True,
                             adm_in_channels=72, dtype=torch.float32)
        return SDXLConfig(unet=unet, clip_l=CLIPTextConfig(16, 2, 3),
                          clip_g=CLIPTextConfig(24, 2, 3, 24, act="gelu"),
                          vae=KLConfig.tiny(), clip_l_layer=2, clip_g_layer=2,
                          size_embed_dim=8)


@dataclasses.dataclass
class SDXLModels:
    """The SDXL stack: UNet, the two text towers, the KL-f8 first stage."""

    config: SDXLConfig
    unet: LDMUNet
    clip_l: CLIPTextModel
    clip_g: CLIPTextModel
    vae: KLModel


def build_sdxl_models(param_dtype=torch.bfloat16, seed: int = 0,
                      config: Optional[SDXLConfig] = None, device=None) -> SDXLModels:
    """SDXL base 1.0 on `device` (default `cuda`): the UNet (seed) and both
    text towers (seed + 1, seed + 2) in `param_dtype`, the KL-f8 first
    stage (seed + 3) in float32, each randomly initialized by the zoo's
    rule (recorded as such in `weights_provenance`).  `config` defaults to
    the published widths."""
    device = resolve_device(device)
    c = config or SDXLConfig()

    def init(name, build, rule, s, dtype):
        _PROVENANCE["random_init"].add(name)
        return _materialize(build, rule, s, dtype, device)

    unet = init("sdxl_unet", lambda: LDMUNet(dataclasses.replace(c.unet, dtype=param_dtype)),
                from_jax.sdxl_unet_rule, seed, param_dtype)
    clip_l = init("sdxl_clip_l",
                  lambda: CLIPTextModel(dataclasses.replace(c.clip_l, dtype=param_dtype)),
                  from_jax.clip_rule, seed + 1, param_dtype)
    clip_g = init("sdxl_clip_g",
                  lambda: CLIPTextModel(dataclasses.replace(c.clip_g, dtype=param_dtype)),
                  from_jax.clip_rule, seed + 2, param_dtype)
    vae = init("sdxl_vae", lambda: KLModel(c.vae), from_jax.vq_rule, seed + 3, torch.float32)
    return SDXLModels(c, unet, clip_l, clip_g, vae)


class SDXLTextEncoder:
    """texts -> (context (N, 77, D_l + D_g), vector (N, D_g + 6 x e))
    float32, sgm's GeneralConditioner: the context is CLIP ViT-L/14's
    hidden state (EOT-padded tokens, as Hugging Face's tokenizer pads)
    beside bigG's (zero-padded, as OpenCLIP's), neither through
    `ln_final`; the vector is bigG's pooled projection, then the
    sinusoidal embeddings (cos, sin; width e) of original_size (h, w),
    crop_coords_top_left (top, left) and target_size (h, w)."""

    def __init__(self, models: SDXLModels, original_size=(1024, 1024), crop_coords=(0, 0),
                 target_size=(1024, 1024)):
        self.models = models
        self.sizes = tuple(original_size) + tuple(crop_coords) + tuple(target_size)

    @torch.inference_mode()
    def __call__(self, texts):
        m, c = self.models, self.models.config
        device = m.clip_g.token_embedding.weight.device

        def tokens(pad):
            return torch.from_numpy(tokenize(texts, pad=pad)).to(device=device, dtype=torch.long)

        h_l, _ = m.clip_l.encode(tokens(EOT), c.clip_l_layer)
        h_g, pooled = m.clip_g.encode(tokens(0), c.clip_g_layer)
        context = torch.cat([h_l.float(), h_g.float()], dim=-1)
        sizes = torch.tensor(self.sizes, dtype=torch.float32, device=device)
        emb = timestep_embedding(sizes, c.size_embed_dim).reshape(1, -1)
        return context, torch.cat([pooled, emb.expand(len(texts), -1)], dim=-1)


def build_sdxl_pipeline(models: SDXLModels, original_size=(1024, 1024), crop_coords=(0, 0),
                        target_size=(1024, 1024)) -> Tuple[LatentPipeline, SDXLTextEncoder]:
    """(LatentPipeline, text_encode) over the SDXL stack, for
    `sample.latent_diffusion_sample(pipe=, text_encode=)`; the size
    conditioning is sgm's for a 1024 x 1024 image by default."""
    pipe = LatentPipeline(
        unet=models.unet,
        decode=models.vae.decode,
        encode=models.vae.encode,
        latent_channels=models.vae.cfg.embed_dim,
        downsample=2 ** (len(models.vae.cfg.ch_mult) - 1),
    )
    return pipe, SDXLTextEncoder(models, original_size, crop_coords, target_size)


def build_esrgan(scale: int = 4, seed: int = 2000, tiny: bool = False,
                 device=None, checkpoint_root: Optional[str] = None) -> RRDBNet:
    """The Real-ESRGAN upsampler, RRDBNet(3, 3, 64, 23, 32, scale) in
    float32, on `device` (default `cuda`), from slot `esrgan_x{scale}`;
    `tiny`: 16 features, 2 blocks, growth 8, and no gate unless
    `checkpoint_root` is given."""
    if tiny:
        build = lambda: RRDBNet(scale=scale, num_feat=16, num_block=2, num_grow_ch=8)
        if checkpoint_root is None:
            return _materialize(build, from_jax.esrgan_rule, seed, torch.float32,
                                resolve_device(device))
    else:
        build = lambda: RRDBNet(scale=scale)
    return load_or_init(f"esrgan_x{scale}", build, from_jax.esrgan_rule, convert_rrdbnet, seed,
                        torch.float32, device, checkpoint_root)


def load_or_init_sentence_t5(param_dtype=torch.float32, seed: int = 0, device=None,
                             checkpoint_root: Optional[str] = None) -> SentenceT5:
    """The full-width sentence-T5 on `device` (default `cuda`), from slot
    `sentence_t5` (HF sentence-t5-base), else a random init: the one tower
    the query encoder and the committed modifier bank
    (data/banks/modifiers_t5.npy) share."""
    return load_or_init("sentence_t5", lambda: SentenceT5(T5Config()), from_jax.t5_rule,
                        convert_sentence_t5, seed, param_dtype, device, checkpoint_root)


def init_marian(cfg: Optional[MarianConfig] = None, seed: int = 0, device=None,
                checkpoint_root: Optional[str] = None) -> MarianMT:
    """MarianMT (default: the opus-mt-zh-en geometry) on `device` (default
    `cuda`) with float32 parameters (`cfg.dtype` sets the compute
    precision), from slot `marian_zh_en` (HF opus-mt-zh-en), else a random
    init by the JAX zoo's rule."""
    cfg = cfg or MarianConfig.opus_zh_en()
    return load_or_init("marian_zh_en", lambda: MarianMT(cfg), from_jax.marian_rule,
                        convert_marian, seed, torch.float32, device, checkpoint_root)


def weights_provenance() -> dict:
    """The trees this process served through the gate, loaded or random
    init, and the tokenizer in use, rolled into a verdict: scores compare
    with the reference's only when trees were loaded, none was a random-init
    stand-in, and the CLIP tokenizer is the real BPE table.  (The JAX
    package's rule, except that a process that served no tree through the
    gate, e.g. one whose modules were built directly, claims nothing.)"""
    if get_tokenizer.cache_info().currsize:
        real_bpe = type(get_tokenizer()).__name__ == "SimpleTokenizer"
    else:  # nothing tokenized yet: what would be used
        real_bpe = default_bpe_path() is not None
    loaded = sorted(_PROVENANCE["loaded"])
    random_init = sorted(_PROVENANCE["random_init"])
    converted = bool(loaded) and not random_init
    return {
        "weights": "converted" if converted else "random-init stand-in (not reference-comparable)",
        "tokenizer": "real-bpe" if real_bpe else "hash-standin",
        "random_init": random_init,
        "loaded": loaded,
        "reference_comparable": converted and real_bpe,
    }
