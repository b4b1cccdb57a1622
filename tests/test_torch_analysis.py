"""The port's image analysis and scoring against the JAX package on the
CPU: `resize_center_crop`, `analyze_image`/`make_analyzer` over tiny CLIP
towers, `clip_scores`/`score_suite`, the service API functions and the
`clip_score` tool.  Weights go across with `models/from_jax.py`; TF32 is
off."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_diffusion_tpu.guidance import score as jscore
from clip_diffusion_tpu.models.clip import model as jclip
from clip_diffusion_tpu.ops import resize as jresize
from clip_diffusion_tpu.parallel import serving as jserving
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.guidance import score as tscore
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip import model as tclip
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.ops import resize as tresize
from clip_diffusion_tpu_torch.parallel import serving as tserving
from clip_diffusion_tpu_torch.tools import clip_score as tool
from test_torch_unet import random_tree

TOWERS = ("ViT-B/16", "ViT-L/14")  # names the analyzer looks for, on tiny towers


@pytest.fixture(autouse=True)
def _cpu_float32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tower(seed, resnet=False):
    """(JAX model, params, port model) of a tiny CLIP on random weights."""
    jcfg = jclip.tiny_clip_config("tiny", resnet=resnet)
    jm = jclip.CLIPModel(jcfg)
    res = jcfg.image_resolution
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, res, res, 3)),
                                        jnp.ones((1, 77), jnp.int32)), seed)
    tm = tclip.CLIPModel(tclip.tiny_clip_config("tiny", resnet=resnet))
    from_jax.load_clip(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm.requires_grad_(False)


@pytest.fixture(scope="module")
def towers():
    return {name: _tower(seed) for seed, name in enumerate(TOWERS, start=1)}


def _jax_clips(towers):
    return {n: (jm, p) for n, (jm, p, _) in towers.items()}


def _port_clips(towers):
    return {n: tm for n, (_, _, tm) in towers.items()}


@pytest.mark.parametrize("hw", [(64, 48), (48, 64), (40, 40)])
def test_resize_center_crop_matches_jax(hw):
    img = np.random.default_rng(0).uniform(0, 1, hw + (3,)).astype(np.float32)
    ref = np.asarray(jresize.resize_center_crop(jnp.asarray(img), 32))
    got = tresize.resize_center_crop(torch.from_numpy(img), 32).numpy()
    assert got.shape == ref.shape == (32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _bank(rng, dim=64):
    def unit(n):
        x = rng.normal(size=(n, dim)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return tserving.AnalysisBank(
        styles={n: unit(20) for n in TOWERS}, media={TOWERS[0]: unit(10)},
        style_names=[f"style {i}" for i in range(20)], media_names=[f"medium {i}" for i in range(10)])


def test_analyzer_matches_jax(towers):
    """make_analyzer (and analyze_image under it) on two tiny towers: the
    same names in the same order, scores within 0.02 on the 100x scale;
    media only from the tower that has a media bank."""
    rng = np.random.default_rng(3)
    bank = _bank(rng)
    jbank = jserving.AnalysisBank(bank.styles, bank.media, bank.style_names, bank.media_names)
    img = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
    ref = jserving.make_analyzer(types.SimpleNamespace(clips=_jax_clips(towers)), jbank)(img, 4)
    got = tserving.make_analyzer(tzoo.ZooModels(None, _port_clips(towers)), bank)(img, 4)
    for kind in ("styles", "media"):
        assert len(got[kind]) == 4
        assert [n for _, n in got[kind]] == [n for _, n in ref[kind]], kind
        np.testing.assert_allclose([s for s, _ in got[kind]], [s for s, _ in ref[kind]], atol=0.02)
    embed = {n: tm.encode_image for n, tm in _port_clips(towers).items()}
    assert tserving.analyze_image(torch.from_numpy(img), embed, bank, 4, 32) == got


def test_analyzer_copies_banks_once(towers, monkeypatch):
    """make_analyzer puts each tower's style and media bank on the towers'
    device once; later calls search those indexes and copy nothing."""
    built = []

    class Counting(tserving.EmbeddingIndex):
        def __init__(self, embeddings, device=None):
            built.append(device)
            super().__init__(embeddings, device)

    monkeypatch.setattr(tserving, "EmbeddingIndex", Counting)
    bank = _bank(np.random.default_rng(8))
    analyze = tserving.make_analyzer(tzoo.ZooModels(None, _port_clips(towers)), bank)
    assert len(built) == 3  # styles of both towers, media of the first
    img = np.random.default_rng(9).uniform(0, 1, (40, 40, 3)).astype(np.float32)
    first = analyze(img)
    assert analyze(img) == first and len(built) == 3
    assert bank.index("media", TOWERS[0], "cpu") is bank.index("media", TOWERS[0], "cpu")


def test_make_analyzer_guards(towers):
    """Towers of two input resolutions are refused; no tower or no bank
    gives None."""
    bank = _bank(np.random.default_rng(4))
    rn = _tower(5, resnet=True)[2]
    mixed = tzoo.ZooModels(None, {TOWERS[0]: towers[TOWERS[0]][2], TOWERS[1]: rn})
    with pytest.raises(ValueError, match="resolution"):
        tserving.make_analyzer(mixed, bank)
    assert tserving.make_analyzer(tzoo.ZooModels(None, {"RN101": rn}), bank) is None
    empty = tserving.AnalysisBank({}, {}, [], [])
    assert tserving.make_analyzer(tzoo.ZooModels(None, {}), empty) is None


def test_clip_scores_and_suite_match_jax(towers):
    """Per-tower cosine and spherical scores and their means within 2e-4 of
    JAX's, on a non-square image; score_suite calls the sampler per prompt
    in order and agrees too."""
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    ref = jscore.clip_scores(_jax_clips(towers), img, "a test prompt")
    got = tscore.clip_scores(_port_clips(towers), torch.from_numpy(img), "a test prompt")
    assert got.keys() == ref.keys() and got["cosine"].keys() == ref["cosine"].keys()
    for kind in got:
        for name in got[kind]:
            assert got[kind][name] == pytest.approx(ref[kind][name], abs=2e-4), (kind, name)
    assert -1 <= got["cosine"]["mean"] <= 1 and got["spherical"]["mean"] >= 0

    images = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32) for _ in range(2)]
    calls = []

    def sample_fn(prompt):
        calls.append(prompt)
        return images[len(calls) - 1]

    rows, mean = tscore.score_suite(_port_clips(towers), sample_fn, tscore.PROMPT_SUITE[:2])
    assert calls == list(tscore.PROMPT_SUITE[:2]) == list(jscore.PROMPT_SUITE[:2])
    jcalls = iter(images)
    jrows, jmean = jscore.score_suite(_jax_clips(towers), lambda p: next(jcalls),
                                      jscore.PROMPT_SUITE[:2])
    assert mean == pytest.approx(jmean, abs=2e-4)
    for (p, s), (jp, js) in zip(rows, jrows):
        assert p == jp and s["spherical"]["mean"] == pytest.approx(js["spherical"]["mean"], abs=2e-4)
    assert tscore.PROMPT_SUITE == jscore.PROMPT_SUITE


def test_service_api_matches_jax(tmp_path):
    """get_seed, change_settings, the prompt types and local banks,
    get_random_prompt's fetcher arity rule, get_chosen_image's sr/
    preference and the shipped analysis banks."""
    seed = tserving.get_seed()
    assert isinstance(seed, str) and 0 <= int(seed) < 2**32
    base = Config()
    new = tserving.change_settings(base, clip_guidance_scale=7.0, width=256)
    assert (new.clip_guidance_scale, new.width, base.width) == (7.0, 256, Config().width)
    assert tserving.PROMPT_TYPES == jserving.PROMPT_TYPES
    assert tserving._LOCAL_PROMPTS == jserving._LOCAL_PROMPTS
    for kind in ("生物", "物件", "unknown"):
        assert tserving.get_random_prompt(kind) in sum(tserving._LOCAL_PROMPTS.values(), [])
    assert tserving.get_random_prompt("生物", lambda path: f"got {path}") == "got creature-prompts/"
    assert tserving.get_random_prompt("物件", lambda: "no-arg") == "no-arg"

    def broken(path):
        raise TypeError("inside the fetcher")

    with pytest.raises(TypeError, match="inside"):
        tserving.get_random_prompt("景觀", broken)

    os.makedirs(tmp_path / "latent" / "sr")
    (tmp_path / "latent" / "latent_0.png").write_bytes(b"plain0")
    (tmp_path / "latent" / "latent_1.png").write_bytes(b"plain1")
    (tmp_path / "latent" / "sr" / "latent_1.png").write_bytes(b"sr1")
    assert tserving.get_chosen_image(0, str(tmp_path)) == b"plain0"
    assert tserving.get_chosen_image(1, str(tmp_path)) == jserving.get_chosen_image(1, str(tmp_path))

    ours, ref = tserving.load_analysis_bank(), jserving.load_analysis_bank()
    assert (len(ours.style_names), len(ours.media_names)) == (397, 95)
    assert ours.style_names == ref.style_names and ours.media_names == ref.media_names
    for name in TOWERS:
        np.testing.assert_array_equal(ours.styles[name], ref.styles[name])
        np.testing.assert_array_equal(ours.media[name], ref.media[name])
    assert tserving.load_analysis_bank(str(tmp_path / "absent")) is None


def _tiny_zoo(*args, device=None, **kwargs):
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(tzoo.host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clip = tclip.CLIPModel(tclip.tiny_clip_config("tiny0"))
    clip.load_state_dict(tzoo.host_init_state_dict(clip, from_jax.clip_rule, 2, torch.float32))
    return tzoo.ZooModels(unet.requires_grad_(False), {"tiny0": clip.requires_grad_(False)})


def test_clip_score_tool(tmp_path, monkeypatch, capsys):
    """tools.clip_score.main on the tiny zoo: one image, then a one-prompt
    suite sampled at 64x64 for 2 steps; every JSON line carries the
    provenance verdict and stderr warns that it is not comparable."""
    monkeypatch.setattr(tool, "build_models", _tiny_zoo)
    monkeypatch.chdir(tmp_path)
    img = np.random.default_rng(7).integers(0, 255, (40, 48, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    assert tool.main(["--image", "in.png", "--prompt", "a red door", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["prompt"] == "a red door" and "tiny0" in line["cosine"]
    assert line["provenance"] == {"weights": "random-init stand-in (not reference-comparable)",
                                  "tokenizer": "hash-standin", "reference_comparable": False}
    assert "NOT reference-comparable" in out.err
    want = tscore.clip_scores(_tiny_zoo().clips, img.astype(np.float32) / 255.0, "a red door")
    assert line["cosine"] == want["cosine"]

    assert tool.main(["--prompts", "1", "--steps", "2", "--size", "64", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x.get("prompt") for x in lines] == [tscore.PROMPT_SUITE[0], None]
    assert lines[1]["prompts"] == 1 and lines[1]["suite_cosine_mean"] == lines[0]["cosine"]["mean"]
    assert all(x["provenance"]["reference_comparable"] is False for x in lines)
    assert os.path.exists(tmp_path / "output_images" / "guided" / "guided_0.png")
