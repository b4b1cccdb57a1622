"""The port's checkpoint layer against the JAX package's converters.

For each model family, one tiny release-layout state dict goes two ways:
through the JAX package's converter and `from_jax.to_state_dict`, and from
a file through the port's loader (`utils/checkpoint.load_validated` with
the family's converter).  The two state dicts must be equal in float32
(rtol=0, atol=0).  The dicts come from the torch oracles of
tests/test_convert_full.py and tests/test_convert_ldm.py where they exist,
else from port modules emitting the release's keys.

Then the zoo's gate (`zoo.load_or_init`) for every builder: an absent file
initializes, a present one loads, an unusable one (corrupt, truncated,
mismatched) raises RuntimeError naming it, lenient mode warns and
initializes, a JAX-only orbax slot raises, tiny builds bypass the gate,
and the provenance lists what loaded.  Also: the ESRGAN x2 input
permutation against basicsr's `pixel_unshuffle` order, the bf16 cast, and
`custom_model_params` against a zoo built from the same file.
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from test_convert_full import TModifiedResNet, TorchADMUNet, TorchCLIP
from test_convert_ldm import TorchBERT, TorchLDMUNet, TorchVQ, _randomize

from clip_diffusion_tpu.models import aesthetic as jaes
from clip_diffusion_tpu.models import esrgan as jes
from clip_diffusion_tpu.models import lpips as jlpips
from clip_diffusion_tpu.models import marian as jmarian
from clip_diffusion_tpu.models import t5 as jt5
from clip_diffusion_tpu.models.clip.model import tiny_clip_config as jtiny_clip
from clip_diffusion_tpu.models.convert import convert_clip as jconvert_clip
from clip_diffusion_tpu.models.convert import convert_unet as jconvert_unet
from clip_diffusion_tpu.models.ldm import convert as jldm
from clip_diffusion_tpu.models.ldm.autoencoder import VQConfig as JVQConfig
from clip_diffusion_tpu.models.ldm.bert import BERTConfig as JBERTConfig
from clip_diffusion_tpu.models.ldm.unet import LDMUNetConfig as JLDMUNetConfig
from clip_diffusion_tpu.models.unet import UNetConfig as JUNetConfig
from clip_diffusion_tpu_torch import config as tconfig
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.aesthetic import (
    LinearAestheticPredictor,
    MLPAestheticPredictor,
    convert_aesthetic,
    make_aesthetic_predictor,
)
from clip_diffusion_tpu_torch.models.clip.model import CLIP_PRESETS, CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.convert import (
    convert_clip,
    convert_unet,
    load_torch_state_dict,
    release_unet_state_dict,
)
from clip_diffusion_tpu_torch.models.esrgan import RRDBNet, _space_to_depth, convert_rrdbnet
from clip_diffusion_tpu_torch.models.ldm.autoencoder import VQConfig, VQModel
from clip_diffusion_tpu_torch.models.ldm.bert import BERTConfig, BERTEmbedder
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
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.runtime.registry import UNetRegistry
from clip_diffusion_tpu_torch.utils.checkpoint import load_validated

TINY_CLIP = "tinyck"  # a tiny ViT tower registered under its own name
CLIP_PRESETS.setdefault(TINY_CLIP, tiny_clip_config(TINY_CLIP))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture
def fresh_provenance(monkeypatch):
    prov = {"loaded": set(), "random_init": set()}
    monkeypatch.setattr(zoo, "_PROVENANCE", prov)
    return prov


def _rand(module, seed):
    """Every parameter and floating buffer of `module` drawn from N(0,
    0.05^2) (BatchNorm variances from U(0.5, 1.5))."""
    _randomize(module, seed)
    g = torch.Generator().manual_seed(seed + 1000)
    with torch.no_grad():
        for name, b in module.named_buffers():
            if b.is_floating_point():
                b.copy_(torch.rand(b.shape, generator=g) + 0.5 if name.endswith("var")
                        else torch.randn(b.shape, generator=g) * 0.05)
    return module


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], want[k].to(torch.float32), rtol=0, atol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")


def _port_load(path, factory, convert, allow_torchscript=False):
    with torch.device("meta"):
        template = factory()
    return load_validated(str(path), template, convert, torch.float32, "test", "cpu",
                          allow_torchscript)


def _jax_side(tree, factory, rule):
    with torch.device("meta"):
        module = factory()
    return from_jax.to_state_dict(tree, module, rule)


# --------------------------------------------------------------------------
# release dicts emitted from port modules (families without a torch oracle)
# --------------------------------------------------------------------------

_T5_TO_HF = (
    ("attn.relative_attention_bias.weight", "layer.0.SelfAttention.relative_attention_bias.weight"),
    ("attn.q.weight", "layer.0.SelfAttention.q.weight"),
    ("attn.k.weight", "layer.0.SelfAttention.k.weight"),
    ("attn.v.weight", "layer.0.SelfAttention.v.weight"),
    ("attn.o.weight", "layer.0.SelfAttention.o.weight"),
    ("ln1.weight", "layer.0.layer_norm.weight"),
    ("wi.weight", "layer.1.DenseReluDense.wi.weight"),
    ("wo.weight", "layer.1.DenseReluDense.wo.weight"),
    ("ln2.weight", "layer.1.layer_norm.weight"),
)


def hf_sentence_t5(sd, sentence_transformers=False):
    """A SentenceT5 state dict under HF T5EncoderModel keys plus the 2_Dense
    projection; `sentence_transformers`: as that package saves it
    (`0.auto_model.` prefix, `2.linear.weight`, the tied embed_tokens)."""
    out = {}
    for key, val in sd.items():
        if key.startswith("block."):
            n, rest = key.split(".", 2)[1:]
            key = f"encoder.block.{n}." + dict(_T5_TO_HF)[rest]
        elif key == "final_layer_norm.weight":
            key = "encoder.final_layer_norm.weight"
        elif key == "projection.weight":
            key = "linear.weight"
        out[key] = val
    if sentence_transformers:
        out = {("2." if k == "linear.weight" else "0.auto_model.") + k: v for k, v in out.items()}
        out["0.auto_model.encoder.embed_tokens.weight"] = sd["shared.weight"]
    return out


def hf_marian(sd):
    """A MarianMT state dict under HF MarianMTModel keys, with the position
    tables, the tied embedding copies and lm_head the release also holds."""
    out = {("" if k == "final_logits_bias" else "model.") + k: v for k, v in sd.items()}
    out["final_logits_bias"] = sd["final_logits_bias"][None]
    d = sd["shared.weight"].shape[1]
    for side in ("encoder", "decoder"):
        out[f"model.{side}.embed_positions.weight"] = torch.randn(64, d)
        out[f"model.{side}.embed_tokens.weight"] = sd["shared.weight"]
    out["lm_head.weight"] = sd["shared.weight"]
    return out


def basicsr_x2(sd):
    """A port x2 RRDBNet state dict with `conv_first` in basicsr's input
    order (pixel_unshuffle: channel slowest), as the release holds it."""
    w = sd["conv_first.weight"]
    o, _, kh, kw = w.shape
    return {**sd, "conv_first.weight": w.reshape(o, 4, 3, kh, kw).transpose(1, 2).reshape(
        o, 12, kh, kw)}


def _resnet_clip_oracle():
    oracle = TorchCLIP(jtiny_clip())
    oracle.visual = TModifiedResNet(jtiny_clip(resnet=True))
    return oracle


def _torchscript(oracle, resolution, path):
    """Save `oracle` as OpenAI ships CLIP: a TorchScript archive whose state
    dict also holds `input_resolution`, `context_length` and `vocab_size`."""
    for name, value in (("input_resolution", resolution), ("context_length", 77),
                        ("vocab_size", 49408)):
        oracle.register_buffer(name, torch.tensor(value))
    traced = torch.jit.trace_module(
        oracle.eval(), {"encode_image": torch.randn(1, 3, resolution, resolution)})
    torch.jit.save(traced, str(path))


# --------------------------------------------------------------------------
# each family: the port's loader == the JAX converter + from_jax
# --------------------------------------------------------------------------

def _family(name, tmp_path):
    """(path of the saved release file, port module factory, port converter,
    allow_torchscript, the JAX side's state dict)."""
    path = tmp_path / f"{name}.pt"
    if name == "adm_unet":
        sd = _rand(TorchADMUNet(JUNetConfig.tiny(64)), 1).state_dict()
        torch.save(sd, path)
        factory = lambda: UNetModel(UNetConfig.tiny(64))
        return path, factory, convert_unet, False, _jax_side(
            jconvert_unet(sd), factory, from_jax.unet_rule)
    if name.startswith("clip"):
        resnet = "resnet" in name
        oracle = _rand(_resnet_clip_oracle() if resnet else TorchCLIP(jtiny_clip()), 2)
        sd = {k: v.clone() for k, v in oracle.state_dict().items()}
        if name.endswith("torchscript"):
            _torchscript(oracle, 64 if resnet else 32, path)
        else:
            torch.save(sd, path)
        factory = lambda: CLIPModel(tiny_clip_config("t", resnet=resnet))
        return path, factory, convert_clip, True, _jax_side(
            jconvert_clip(sd), factory, from_jax.clip_rule)
    if name.startswith("aesthetic"):
        mlp = name == "aesthetic_mlp"
        sd = _rand(MLPAestheticPredictor(768) if mlp else LinearAestheticPredictor(512),
                   3).state_dict()
        if name == "aesthetic_bare":  # a bare nn.Linear release
            sd = {k[len("linear."):]: v for k, v in sd.items()}
        torch.save(sd, path)
        factory = lambda: make_aesthetic_predictor("ViT-L/14" if mlp else "ViT-B/32")
        return path, factory, convert_aesthetic, False, _jax_side(
            jaes.convert_aesthetic(sd), factory, from_jax.aesthetic_rule)
    if name.startswith("lpips"):
        sd = _rand(LPIPS(), 4).state_dict()
        if name == "lpips":  # the lpips package's file, with its constant buffers
            torch.save({**sd, "scaling_layer.shift": torch.randn(1, 3, 1, 1),
                        "scaling_layer.scale": torch.randn(1, 3, 1, 1)}, path)
            tree = jlpips.convert_lpips(sd)
        else:  # torchvision's VGG16 and the lin heads, merged into one file
            vgg = {f"features.{k.split('.')[2]}.{k.split('.')[3]}": v
                   for k, v in sd.items() if k.startswith("net.")}
            vgg["classifier.0.weight"] = torch.randn(4, 8)
            lin = {k: v for k, v in sd.items() if k.startswith("lin")}
            torch.save({**vgg, **lin}, path)
            tree = jlpips.convert_lpips_parts(vgg, lin)
        return path, LPIPS, convert_lpips, False, _jax_side(tree, LPIPS, from_jax.lpips_rule)
    if name == "esrgan_x4":
        factory = lambda: RRDBNet(scale=4, num_feat=16, num_block=2, num_grow_ch=8)
        sd = _rand(factory(), 5).state_dict()
        # basicsr's wrapping: params_ema preferred over params
        torch.save({"params": {k: v * 0 for k, v in sd.items()}, "params_ema": sd}, path)
        return path, factory, convert_rrdbnet, False, _jax_side(
            jes.convert_rrdbnet(sd), factory, from_jax.esrgan_rule)
    if name.startswith("ldm_"):
        full, trees = _ldm_release()
        torch.save({"state_dict": full}, path)
        part = ("ldm_unet", "ldm_vq", "ldm_bert").index(name)
        factory = (lambda: LDMUNet(LDMUNetConfig.tiny()), lambda: VQModel(VQConfig.tiny()),
                   lambda: BERTEmbedder(BERTConfig.tiny()))[part]
        convert = (convert_ldm_unet, convert_vq, convert_bert)[part]
        rule = (from_jax.ldm_unet_rule, from_jax.vq_rule, from_jax.bert_rule)[part]
        tree = trees[("unet", "vq", "bert")[part]]
        return (path, factory, lambda sd: convert(split_ldm_state_dict(sd)[part]), False,
                _jax_side(tree, factory, rule))
    if name == "sentence_t5":
        factory = lambda: SentenceT5(T5Config.tiny())
        sd = _rand(factory(), 6).state_dict()
        torch.save(hf_sentence_t5(sd, sentence_transformers=True), path)
        return path, factory, convert_sentence_t5, False, _jax_side(
            jt5.convert_sentence_t5(hf_sentence_t5(sd)), factory, from_jax.t5_rule)
    if name == "marian":
        factory = lambda: MarianMT(MarianConfig.tiny())
        hf = hf_marian(_rand(factory(), 7).state_dict())
        torch.save(hf, path)
        return path, factory, convert_marian, False, _jax_side(
            jmarian.convert_marian(hf, jmarian.MarianConfig.tiny()), factory,
            from_jax.marian_rule)
    raise KeyError(name)


def _ldm_release():
    """One LatentDiffusion state dict from the three torch oracles, with
    LitEma shadows for every UNet weight (other values), the VQ's loss net,
    BERT's LM head and keys outside the three prefixes; and the JAX
    package's trees of it."""
    unet = _rand(TorchLDMUNet(JLDMUNetConfig.tiny()), 8).state_dict()
    vq = _rand(TorchVQ(JVQConfig.tiny()), 9).state_dict()
    bert = _rand(TorchBERT(JBERTConfig.tiny()), 10).state_dict()
    full = {"betas": torch.rand(10), "logvar": torch.zeros(10),
            "model_ema.decay": torch.tensor(0.9999), "model_ema.num_updates": torch.tensor(7),
            "cond_stage_model.tknz_fn.vocab_ids": torch.arange(4)}
    for k, v in unet.items():
        full["model.diffusion_model." + k] = v
        full["model_ema." + ("diffusion_model." + k).replace(".", "")] = v * -1.5 + 0.01
    full.update({"first_stage_model." + k: v for k, v in vq.items()})
    full.update({"cond_stage_model.transformer." + k: v for k, v in bert.items()})
    np_full = {k: v.numpy() for k, v in full.items()}
    return full, jldm.convert_ldm_checkpoint(np_full)


FAMILIES = ["adm_unet", "clip_vit", "clip_vit_torchscript", "clip_resnet",
            "clip_resnet_torchscript", "aesthetic_linear", "aesthetic_bare", "aesthetic_mlp",
            "lpips", "lpips_parts", "esrgan_x4", "ldm_unet", "ldm_vq", "ldm_bert",
            "sentence_t5", "marian"]


@pytest.mark.parametrize("family", FAMILIES)
def test_release_file_loads_as_the_jax_converter_gives(family, tmp_path):
    """load_validated(file) == from_jax.to_state_dict(JAX converter(dict)),
    bit for bit in float32."""
    path, factory, convert, allow_ts, want = _family(family, tmp_path)
    _assert_same(_port_load(path, factory, convert, allow_ts), want)


def test_ldm_unet_takes_the_ema_shadows(tmp_path):
    full, _ = _ldm_release()
    unet, vq, bert = split_ldm_state_dict(full)
    k = "input_blocks.0.0.weight"
    assert torch.equal(unet[k], full["model_ema.diffusion_modelinput_blocks00weight"])
    assert not torch.equal(unet[k], full["model.diffusion_model." + k])
    assert "loss.dummy.weight" in vq and "loss.dummy.weight" not in convert_vq(vq)
    assert "to_logits.weight" not in convert_bert(bert)


@pytest.mark.parametrize("convert,key", [
    (convert_unet, "input_blocks.0.0.bogus.weight"),
    (convert_clip, "visual.nonsense"),
    (convert_rrdbnet, "body.0"),
    (convert_lpips, "net.conv1.weight"),
    (convert_aesthetic, "layers.1.weight"),
    (convert_sentence_t5, "encoder.block.0.layer.2.weight"),
    (convert_marian, "model.encoder.layers.0.attn.weight"),
    (convert_ldm_unet, "input_blocks.1.1.transformer_blocks.0.attn3.to_q.weight"),
    (convert_vq, "encoder.mid.block_1"),
    (convert_bert, "attn_layers.layers.0.1.to_z.weight"),
])
def test_converters_raise_keyerror_on_unmapped_keys(convert, key):
    with pytest.raises(KeyError, match="unmapped"):
        convert({key: torch.zeros(2, 2)})


def test_torchscript_refused_outside_clip_slots(tmp_path):
    path = tmp_path / "ts.pt"
    _torchscript(_rand(TorchCLIP(jtiny_clip()), 2), 32, path)
    with pytest.raises(ValueError, match="TorchScript"):
        load_torch_state_dict(str(path))
    assert "input_resolution" in load_torch_state_dict(str(path), allow_torchscript=True)


def test_esrgan_x2_permutation_matches_pixel_unshuffle_order():
    """The converted x2 `conv_first` on the port's channel-fastest packing
    equals the release weight on basicsr's F.pixel_unshuffle packing (in
    float64, where the two packings' sum orders agree far below 1e-6); the
    weight is the release's, channels reordered: port (f * 3 + c) = release
    (c * 4 + f)."""
    g = torch.Generator().manual_seed(0)
    w_release = torch.randn(16, 12, 3, 3, generator=g, dtype=torch.float64)
    bias = torch.randn(16, generator=g, dtype=torch.float64)
    x = torch.rand(2, 3, 16, 16, generator=g, dtype=torch.float64)
    sd = convert_rrdbnet({"conv_first.weight": w_release, "conv_first.bias": bias})
    got = F.conv2d(_space_to_depth(x, 2), sd["conv_first.weight"], bias, padding=1)
    want = F.conv2d(F.pixel_unshuffle(x, 2), w_release, bias, padding=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for f in range(4):
        for c in range(3):
            assert torch.equal(sd["conv_first.weight"][:, f * 3 + c], w_release[:, c * 4 + f])
    # x4 takes RGB directly: nothing to permute
    w4 = torch.randn(16, 3, 3, 3, generator=g)
    assert torch.equal(convert_rrdbnet({"conv_first.weight": w4})["conv_first.weight"], w4)


class _WithCounter(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.register_buffer("count", torch.zeros(2, dtype=torch.int64))


def test_bf16_load_casts_floats_and_keeps_integers(tmp_path):
    src = _WithCounter()
    src.count += torch.tensor([3, 4])
    torch.save(src.state_dict(), tmp_path / "m.pt")
    with torch.device("meta"):
        template = _WithCounter()
    sd = load_validated(str(tmp_path / "m.pt"), template, None, torch.bfloat16, "m", "cpu")
    assert sd["lin.weight"].dtype == torch.bfloat16 and sd["lin.bias"].dtype == torch.bfloat16
    assert torch.equal(sd["lin.weight"], src.lin.weight.detach().to(torch.bfloat16))
    assert sd["count"].dtype == torch.int64 and sd["count"].tolist() == [3, 4]


def test_validation_names_the_path_and_first_problems(tmp_path):
    sd = _rand(TorchADMUNet(JUNetConfig.tiny(64)), 1).state_dict()
    del sd["out.2.bias"]
    sd["input_blocks.0.0.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "u.pt")
    with pytest.raises(RuntimeError) as e:
        _port_load(tmp_path / "u.pt", lambda: UNetModel(UNetConfig.tiny(64)), convert_unet)
    msg = str(e.value)
    assert str(tmp_path / "u.pt") in msg and "missing out.2.bias" in msg
    assert "shape input_blocks.0.0.weight" in msg


# --------------------------------------------------------------------------
# the zoo's gate, for every builder
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Slot:
    names: tuple  # provenance names
    file: str  # the release file's slot
    build: object  # root -> [modules]
    release: object  # [modules] -> flat release state dict
    wrap: str = ""  # the release's wrapping key, if any


def _sd(m):
    return {k: v.clone() for k, v in m.state_dict().items()}


def _tiny_sentence_t5(root):
    """load_or_init_sentence_t5 at the tiny width (it always builds the
    default T5Config)."""
    with mock.patch.object(zoo, "T5Config", T5Config.tiny):
        return zoo.load_or_init_sentence_t5(device="cpu", checkpoint_root=root)


SLOTS = {
    "build_models": Slot(
        ("guided_unet_512",), "guided_unet_512",
        lambda root: [zoo.build_models(tconfig.Config(chosen_clip_models=()), 512, torch.float32,
                                       unet_config=UNetConfig.tiny(64), device="cpu",
                                       checkpoint_root=root).unet],
        lambda ms: release_unet_state_dict(_sd(ms[0]))),
    "build_clip": Slot(
        (f"clip_{TINY_CLIP}",), f"clip_{TINY_CLIP}",
        lambda root: [zoo.build_clip(TINY_CLIP, torch.float32, 0, "cpu", root)],
        lambda ms: {**_sd(ms[0]), "logit_scale": torch.tensor(4.6)}),
    "build_aesthetic linear": Slot(
        ("aesthetic_ViT-B_32",), "aesthetic_ViT-B_32",
        lambda root: [zoo.build_aesthetic("ViT-B/32", 100, "cpu", root)],
        lambda ms: _sd(ms[0])),
    "build_aesthetic mlp": Slot(
        ("aesthetic_ViT-L_14",), "aesthetic_ViT-L_14",
        lambda root: [zoo.build_aesthetic("ViT-L/14", 102, "cpu", root)],
        lambda ms: _sd(ms[0])),
    "build_lpips": Slot(
        ("lpips_vgg",), "lpips_vgg", lambda root: [zoo.build_lpips(1000, "cpu", root)],
        lambda ms: _sd(ms[0])),
    "build_esrgan x4": Slot(
        ("esrgan_x4",), "esrgan_x4",
        lambda root: [zoo.build_esrgan(4, tiny=True, device="cpu", checkpoint_root=root)],
        lambda ms: _sd(ms[0]), "params_ema"),
    "build_esrgan x2": Slot(
        ("esrgan_x2",), "esrgan_x2",
        lambda root: [zoo.build_esrgan(2, tiny=True, device="cpu", checkpoint_root=root)],
        lambda ms: basicsr_x2(_sd(ms[0])), "params_ema"),
    "build_latent_models": Slot(
        ("ldm_unet", "ldm_vq", "ldm_bert"), "ldm",
        lambda root: list(dataclasses.astuple(zoo.build_latent_models(
            torch.float32, tiny=True, device="cpu", checkpoint_root=root))),
        lambda ms: {**{"model.diffusion_model." + k: v for k, v in _sd(ms[0]).items()},
                    **{"first_stage_model." + k: v for k, v in _sd(ms[1]).items()},
                    **{"cond_stage_model.transformer." + k: v for k, v in _sd(ms[2]).items()}},
        "state_dict"),
    "load_or_init_sentence_t5": Slot(
        ("sentence_t5",), "sentence_t5", lambda root: [_tiny_sentence_t5(root)],
        lambda ms: hf_sentence_t5(_sd(ms[0]))),
    "init_marian": Slot(
        ("marian_zh_en",), "marian_zh_en",
        lambda root: [zoo.init_marian(MarianConfig.tiny(), device="cpu", checkpoint_root=root)],
        lambda ms: hf_marian(_sd(ms[0]))),
}


def _save_release(slot, modules, root, edit=None):
    sd = slot.release(modules)
    if edit is not None:
        sd = edit(sd)
    path = os.path.join(root, f"{slot.file}.pt")
    torch.save({slot.wrap: sd} if slot.wrap else sd, path)
    return path


def _root(tmp_path):
    root = tmp_path / "weights"
    root.mkdir(exist_ok=True)
    return str(root)


@pytest.mark.parametrize("builder", sorted(SLOTS))
def test_gate_absent_file_means_init(builder, tmp_path, fresh_provenance):
    slot = SLOTS[builder]
    first = slot.build(_root(tmp_path))
    assert fresh_provenance == {"loaded": set(), "random_init": set(slot.names)}
    again = slot.build(_root(tmp_path))  # the seeded init, every time
    for a, b in zip(first, again):
        _assert_same(_sd(a), _sd(b))


@pytest.mark.parametrize("builder", sorted(SLOTS))
def test_gate_present_file_loads(builder, tmp_path, fresh_provenance):
    slot = SLOTS[builder]
    root = _root(tmp_path)
    modules = slot.build(root)
    with torch.no_grad():  # weights no init could give
        for m in modules:
            for p in m.parameters():
                p.mul_(-1.5).add_(0.01)
    _save_release(slot, modules, root)
    fresh_provenance["random_init"].clear()
    loaded = slot.build(root)
    assert fresh_provenance == {"loaded": set(slot.names), "random_init": set()}
    for want, got in zip(modules, loaded):
        _assert_same(_sd(got), _sd(want))
        assert not any(p.requires_grad for p in got.parameters()) and not got.training


def _corrupt(path):
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")


def _truncate(path):
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 2)


def _grow_first_float(sd):
    key = next(k for k in sorted(sd) if sd[k].is_floating_point() and sd[k].ndim)
    return {**sd, key: torch.cat([sd[key], sd[key]])}


@pytest.mark.parametrize("kind", ["corrupt", "truncated", "mismatched"])
@pytest.mark.parametrize("builder", sorted(SLOTS))
def test_gate_unusable_file_raises(builder, kind, tmp_path, fresh_provenance):
    slot = SLOTS[builder]
    root = _root(tmp_path)
    path = _save_release(slot, slot.build(root), root,
                         _grow_first_float if kind == "mismatched" else None)
    if kind == "corrupt":
        _corrupt(path)
    elif kind == "truncated":
        _truncate(path)
    with pytest.raises(RuntimeError, match="present but unusable") as e:
        slot.build(root)
    assert path in str(e.value)
    if kind == "mismatched":
        assert "does not match" in str(e.value)
    assert not set(slot.names) <= fresh_provenance["loaded"]


@pytest.mark.parametrize("builder", sorted(SLOTS))
def test_gate_lenient_mode_warns_and_inits(builder, tmp_path, fresh_provenance, monkeypatch):
    slot = SLOTS[builder]
    root = _root(tmp_path)
    _corrupt(_save_release(slot, slot.build(root), root))
    fresh_provenance["random_init"].clear()
    monkeypatch.setenv(zoo.LENIENT_ENV, "1")
    with pytest.warns(UserWarning, match="lenient"):
        slot.build(root)
    assert fresh_provenance == {"loaded": set(), "random_init": set(slot.names)}


@pytest.mark.parametrize("builder", sorted(SLOTS))
def test_gate_jax_only_slot_raises(builder, tmp_path, fresh_provenance, monkeypatch):
    """The JAX package's orbax directory without the port's file raises,
    naming both paths."""
    slot = SLOTS[builder]
    flax = tmp_path / "flax"
    (flax / slot.names[0]).mkdir(parents=True)
    monkeypatch.setenv(zoo.FLAX_ROOT_ENV, str(flax))
    root = _root(tmp_path)
    with pytest.raises(RuntimeError) as e:
        slot.build(root)
    msg = str(e.value)
    assert str(flax / slot.names[0]) in msg and os.path.join(root, f"{slot.file}.pt") in msg


@pytest.mark.parametrize("env,slot", [("T5_PARAMS_PATH", "sentence_t5"),
                                      ("MARIAN_PARAMS_PATH", "marian_zh_en")])
def test_text_models_jax_paths_raise(env, slot, tmp_path, monkeypatch):
    (tmp_path / "orbax").mkdir()
    monkeypatch.setenv(env, str(tmp_path / "orbax"))
    build = SLOTS["load_or_init_sentence_t5" if slot == "sentence_t5" else "init_marian"].build
    with pytest.raises(RuntimeError, match="orbax"):
        build(_root(tmp_path))


def test_tiny_builds_bypass_the_gate(tmp_path, fresh_provenance, monkeypatch):
    """tiny=True with no root never looks at the default root, as the JAX
    zoo's tiny test doubles."""
    root = _root(tmp_path)
    for name in ("esrgan_x4", "ldm"):
        _corrupt(os.path.join(root, f"{name}.pt"))
    monkeypatch.setenv(zoo.TORCH_ROOT_ENV, root)
    zoo.build_esrgan(4, tiny=True, device="cpu")
    zoo.build_latent_models(torch.float32, tiny=True, device="cpu")
    assert fresh_provenance == {"loaded": set(), "random_init": set()}
    with pytest.raises(RuntimeError):  # the same root through the gate
        zoo.build_esrgan(4, tiny=True, device="cpu", checkpoint_root=root)


def test_default_root_is_the_environment_variable(tmp_path, monkeypatch):
    monkeypatch.setenv(zoo.TORCH_ROOT_ENV, str(tmp_path))
    assert zoo.checkpoint_path("lpips_vgg") is None
    (tmp_path / "lpips_vgg.pt").write_bytes(b"")
    assert zoo.checkpoint_path("lpips_vgg") == str(tmp_path / "lpips_vgg.pt")
    monkeypatch.delenv(zoo.TORCH_ROOT_ENV)
    monkeypatch.chdir(tmp_path)
    assert zoo.checkpoint_path("lpips_vgg") is None  # models/torch/ under the cwd


def test_weights_provenance(tmp_path, fresh_provenance):
    slot = SLOTS["build_aesthetic linear"]
    root = _root(tmp_path)
    empty = zoo.weights_provenance()
    assert empty["loaded"] == [] and empty["reference_comparable"] is False
    _save_release(slot, slot.build(root), root)
    fresh_provenance["random_init"].clear()
    slot.build(root)
    prov = zoo.weights_provenance()
    assert prov["weights"] == "converted" and prov["loaded"] == ["aesthetic_ViT-B_32"]
    assert prov["reference_comparable"] is (prov["tokenizer"] == "real-bpe")
    SLOTS["build_lpips"].build(root)
    prov = zoo.weights_provenance()
    assert prov["random_init"] == ["lpips_vgg"] and prov["reference_comparable"] is False
    assert prov["weights"] == "random-init stand-in (not reference-comparable)"


# --------------------------------------------------------------------------
# custom_model_params
# --------------------------------------------------------------------------

def tiny_port_config():
    return tconfig.Config(
        width=64, height=64, num_cutout_batches=1, guidance_dtype="float32",
        clip_guidance_scale=1000.0, denoise_scale=100.0, range_scale=10.0,
        LPIPS_scale=0.0, MS_SSIM_scale=0.0, chosen_clip_models=(TINY_CLIP,),
        cutout_schedules=tconfig.CutoutSchedules(
            num_overview_cuts=tconfig.create_schedule((2,), (1000,)),
            num_inner_cuts=tconfig.create_schedule((2,), (1000,)),
            inner_cut_size_power=tconfig.create_schedule((5,), (1000,)),
            cut_gray_portion=tconfig.create_schedule((0.5,), (1000,)),
        ),
    )


def _unet_outputs(run):
    """The outputs of every UNetModel forward during `run()`."""
    outs = []
    hook = nn.modules.module.register_module_forward_hook(
        lambda m, i, o: outs.append(o.detach().clone()) if isinstance(m, UNetModel) else None)
    try:
        result = run()
    finally:
        hook.remove()
    return outs, result


def test_custom_model_params_equals_a_zoo_built_from_the_file(tmp_path, fresh_provenance):
    """A finetune passed as custom_model_params (loaded by the registry)
    samples bit for bit as a zoo whose UNet was built from the same file,
    and the shared zoo's UNet is untouched."""
    root = _root(tmp_path)
    config = tiny_port_config()
    build = lambda r: zoo.build_models(config, 512, torch.float32, unet_config=UNetConfig.tiny(64),
                                       device="cpu", checkpoint_root=r)
    shared = build(root)  # random init
    finetune = _rand(UNetModel(UNetConfig.tiny(64)), 11)
    torch.save(release_unet_state_dict(finetune.state_dict()),
               os.path.join(root, "guided_unet_custom_landscape.pt"))
    registry = UNetRegistry(shared.unet).discover(root)
    torch.save(release_unet_state_dict(finetune.state_dict()),
               os.path.join(root, "guided_unet_512.pt"))
    from_file = build(root)
    before = _sd(shared.unet)
    unet_object = shared.unet

    def sample(models, out, **kw):
        return lambda: tsample.guided_diffusion_sample(
            "a lighthouse", models=models, steps=3, seed=5, config=config, device="cpu",
            output_dir=str(tmp_path / out), **kw)

    got, res_a = _unet_outputs(sample(shared, "a", custom_model_params=registry.load("景觀")))
    want, res_b = _unet_outputs(sample(from_file, "b"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert np.array_equal(np.asarray(tsample.load_image(res_a["images"][0])),
                          np.asarray(tsample.load_image(res_b["images"][0])))
    assert shared.unet is unet_object
    _assert_same(_sd(shared.unet), before)
    default, _ = _unet_outputs(sample(shared, "c"))
    assert not torch.equal(default[0], got[0])


def test_custom_model_params_must_be_on_the_zoo_device():
    models = zoo.ZooModels(UNetModel(UNetConfig.tiny(64)), {})
    sd = {k: v.to("meta") for k, v in models.unet.state_dict().items()}
    with pytest.raises(ValueError, match="device"):
        zoo.with_unet_state_dict(models, sd)
