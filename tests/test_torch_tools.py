"""The port's profiling hooks and tools against the JAX package's, on the
CPU: `utils.profiling`, `tools.profile_step`'s sections on a tiny pipeline,
`tools.eval_clip_score` (the score against the JAX function, `--certify`
on an empty root, `--selftest`), `tools.build_banks` against the JAX
tool's functions and the committed banks, and `tools.fetch_and_convert`
run against file:// URLs of tiny release files, after which the zoo's gate
loads every slot."""

import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.build_banks as jbanks
import tools.eval_clip_score as jeval
from clip_diffusion_tpu.models.clip.model import CLIPModel as JCLIPModel
from clip_diffusion_tpu.models.clip.model import tiny_clip_config as jtiny_clip_config
from clip_diffusion_tpu.zoo import _host_init
from clip_diffusion_tpu_torch import config as tconfig
from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.diffusion.schedule import make_schedule
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline.guided import GuidedPipeline, compute_phase_segments
from clip_diffusion_tpu_torch.tools import build_banks, eval_clip_score, fetch_and_convert
from clip_diffusion_tpu_torch.tools import profile_step
from clip_diffusion_tpu_torch.utils import clear_device_cache
from clip_diffusion_tpu_torch.utils import profiling
from clip_diffusion_tpu_torch.utils.profiling import annotate, trace
from test_torch_checkpoint import SLOTS, TINY_CLIP, _assert_same, _sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKS = os.path.join(REPO, "data", "banks")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _names(kind):
    with open(os.path.join(BANKS, f"{kind}_names.txt"), encoding="utf-8") as f:
        return f.read().split("\n")


# ---------------- utils.profiling ----------------

def test_stopwatch_trace_and_annotate(tmp_path, monkeypatch):
    """`trace` writes a Chrome trace holding the `annotate` names; inside it
    the spans are recorded, and `totals` (which replaced the section
    stopwatch) sums them by name; outside every profile nothing is."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    with trace(str(tmp_path / "tb")) as path:
        with annotate("outer_region"):
            for _ in range(2):
                with annotate("inner_region"):
                    time.sleep(0.01)
                    torch.ones(8).sum()
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert os.path.dirname(path) == str(tmp_path / "tb")
    assert "outer_region" in text and "inner_region" in text
    totals = profiling.totals()
    assert set(totals) == {"outer_region", "inner_region"}
    assert totals["inner_region"][0] == 2 and totals["inner_region"][1] >= 0.02
    assert totals["outer_region"][0] == 1 and totals["outer_region"][1] >= totals["inner_region"][1]
    with trace(None) as nothing:
        with annotate("untraced"):
            torch.ones(2).sum()
    assert nothing is None and glob.glob(str(tmp_path / "tb" / "*")) == [path]
    assert "untraced" not in profiling.totals()
    clear_device_cache()  # no CUDA here: garbage collection only


# ---------------- tools.profile_step ----------------

def _tiny_pipe():
    """The tiny float32 UNet and one tiny ViT tower, 10 DDIM steps, a
    two-phase cutout schedule."""
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(zoo.host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clip = CLIPModel(tiny_clip_config("tiny0"))
    clip.load_state_dict(zoo.host_init_state_dict(clip, from_jax.clip_rule, 2, torch.float32))
    models = zoo.ZooModels(unet.requires_grad_(False), {"tiny0": clip.requires_grad_(False)})
    config = tconfig.Config(
        width=64, height=64, num_cutout_batches=1, guidance_dtype="float32",
        cutout_schedules=tconfig.CutoutSchedules(
            num_overview_cuts=tconfig.create_schedule((4, 1), (500, 500)),
            num_inner_cuts=tconfig.create_schedule((1, 3), (500, 500)),
            inner_cut_size_power=tconfig.create_schedule((5,), (1000,)),
            cut_gray_portion=tconfig.create_schedule((0.5,), (1000,))))
    return zoo.build_pipeline(models, config, [("a prompt", 1.0)], SamplerConfig(steps=10))


def test_profile_step_sections():
    """Every section on the tiny pipeline with K=1: each timed entry has
    ms_per_iter and first_s (no device_ms on the CPU), the names the JAX
    tool gives, the phases' step counts and weighted sum, the UNet blocks'
    FLOPs, the parts' sum beside the whole step."""
    pipe = _tiny_pipe()
    res = profile_step.run_sections(pipe, profile_step.SECTIONS, k=1, repeats=1, caps=(1, 3))
    expected = {
        "step_phase_4ov_1in", "step_phase_1ov_3in", "phases_weighted",
        "unet_fwd", "unet_fwd_bwd",
        "L0_res_64px_32to32", "L1_res_32px_32to64", "L1_attn_32px_64to64",
        "unet_fwdbwd_remat_full", "unet_fwdbwd_remat_off",
        "whole_step_1ov_3in", "cutouts_4_fwd_bwd", "clip_tiny0_fwdbwd_4", "threshold_histogram",
        "sum_blocks_vs_whole", "cutouts_5_fwd_bwd", "clip_tiny0_fwdbwd_5", "device"}
    assert set(res) == expected
    for name, entry in res.items():
        if name not in ("phases_weighted", "sum_blocks_vs_whole", "device"):
            assert entry["ms_per_iter"] > 0 and entry["first_s"] > 0, name
            assert "device_ms_per_iter" not in entry, name
    assert (res["step_phase_4ov_1in"]["first_step"], res["step_phase_4ov_1in"]["steps"]) == (9, 5)
    assert (res["step_phase_1ov_3in"]["first_step"], res["step_phase_1ov_3in"]["steps"]) == (4, 5)
    assert res["phases_weighted"]["steps"] == 10 and "device_ms" not in res["phases_weighted"]
    assert res["L1_attn_32px_64to64"]["gflop_fwdbwd"] > 0
    assert set(res["sum_blocks_vs_whole"]) == {"measure", "sum_blocks_ms", "whole_step_ms",
                                               "overlap_pct"}
    assert res["device"]["name"] == "cpu" and res["device"]["timer"] == "host clock"
    with pytest.raises(ValueError, match="no phase with caps"):
        profile_step.run_sections(pipe, ["phase_blocks"], k=1, repeats=1, caps=(4, 2))


def test_profile_step_phases_hold_the_jax_table():
    """The default schedule's phases at 250 steps hold the JAX tool's
    hard-coded (caps, step) table; a table it does not hold raises."""
    pipe = GuidedPipeline(unet=None, perceptors=(), config=tconfig.Config(),
                          sampler=SamplerConfig(steps=250), schedule=make_schedule(steps=250),
                          device=torch.device("cpu"))
    segments = compute_phase_segments(pipe, 250)
    assert [(caps, int(s[0]), len(s)) for s, caps in segments] == [
        ((14, 2), 249, 50), ((12, 4), 199, 50), ((4, 2), 149, 100), ((0, 12), 49, 50)]
    profile_step.check_jax_phases(segments)
    with pytest.raises(RuntimeError, match="do not hold"):
        profile_step.check_jax_phases(segments[:3])


# ---------------- tools.eval_clip_score ----------------

def test_clip_score_matches_jax():
    """The score of three images (one not square) against three suite
    prompts, a tiny CLIP carried from JAX: within 1e-5 of the JAX tool's."""
    cfg = jtiny_clip_config()
    jm = JCLIPModel(cfg)
    params = _host_init(lambda: jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)),
                                        jnp.zeros((1, 77), jnp.int32)),
                        param_dtype=jnp.float32, seed=5)
    tm = CLIPModel(tiny_clip_config())
    from_jax.load_clip(tm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 1, shape) for shape in ((64, 64, 3), (48, 80, 3), (40, 40, 3))]
    prompts = jeval.PROMPT_SUITE[:3]
    ref = jeval.clip_score(
        lambda im: jm.apply(params, im, method=JCLIPModel.encode_image),
        lambda t: jm.apply(params, t, method=JCLIPModel.encode_text),
        images, prompts, resolution=cfg.image_resolution)
    got = eval_clip_score.clip_score(tm.encode_image, tm.encode_text, images, prompts,
                                     cfg.image_resolution, device="cpu")
    assert eval_clip_score.PROMPT_SUITE == jeval.PROMPT_SUITE
    assert len(got) == 3 and max(abs(g) for g in got) > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_selftest(capsys):
    assert eval_clip_score.main(["--selftest", "--cpu"]) == 0
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["selftest_scores"]
    assert len(scores) == 2 and all(-1 <= s <= 1 for s in scores)


@pytest.fixture
def no_model_builds(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("certify built a model")

    for name in ("build_models", "build_latent_models", "build_clip"):
        monkeypatch.setattr(zoo, name, refuse)


def test_certify_on_an_empty_root(tmp_path, capsys, no_model_builds):
    """Every slot MISSING, no model built, FAIL with exit code 1."""
    rc = eval_clip_score.main(["--certify", "--checkpoint-root", str(tmp_path / "weights"),
                               "--data-dir", str(tmp_path / "data"), "--cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and report["certify"] == "FAIL"
    slots = report["checks"]["checkpoint_slots"]
    assert set(slots) == set(jeval.CERTIFY_SLOTS) and set(slots.values()) == {"MISSING"}
    assert report["checks"]["forwards"] == {}
    assert report["checks"]["provenance"] == "skipped (slots missing)"
    assert len(report["failures"]) == len(slots) + 3  # and three required data assets


def test_certify_names_exactly_the_missing_slots(tmp_path, capsys, no_model_builds):
    """A root holding some slots' files (`ldm.pt` serving the three LDM
    slots): those present, the others MISSING, still no model built."""
    root = tmp_path / "weights"
    root.mkdir()
    for name in ("guided_unet_512", "clip_ViT-B_32", "ldm"):
        (root / f"{name}.pt").write_bytes(b"x")
    assert eval_clip_score.main(["--certify", "--checkpoint-root", str(root), "--cpu"]) == 1
    slots = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["checks"][
        "checkpoint_slots"]
    present = {"guided_unet_512", "clip_ViT-B_32", "ldm_unet", "ldm_vq", "ldm_bert"}
    assert {k for k, v in slots.items() if v == "present"} == present


# ---------------- tools.build_banks ----------------

@pytest.mark.parametrize("kind", ["modifiers", "styles", "media"])
def test_read_keywords_matches_jax(kind):
    path = os.path.join(REPO, "data", "csv", f"{kind}.csv")
    got = build_banks.read_keywords(path, build_banks.KIND_COLUMNS[kind])
    assert got == jbanks.read_keywords(path, jbanks.KIND_COLUMNS[kind]) == _names(kind)


def test_build_banks_match_jax_and_committed(tmp_path):
    """ViT-B/16 on 4 style names and sentence-T5 on 4 modifiers (seed 0,
    float32, no release files): within 1e-5 of the JAX tool's banks on the
    same names and of the committed rows; the names files byte-equal."""
    styles, modifiers = _names("styles")[:4], _names("modifiers")[:4]
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    got = build_banks.build_clip_bank(styles, "styles", ["ViT-B/16"], str(port), device="cpu")
    jbanks.build_clip_bank(styles, "styles", ["ViT-B/16"], str(jax_out))
    got_t5 = build_banks.build_modifier_bank(modifiers, str(port), device="cpu")
    jbanks.build_modifier_bank(modifiers, str(jax_out))
    for name, arr in (("styles_ViT-B_16.npy", got["ViT-B/16"]), ("modifiers_t5.npy", got_t5)):
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(np.load(port / name), arr)
        np.testing.assert_allclose(arr, np.load(jax_out / name), atol=1e-5)
        np.testing.assert_allclose(arr, np.load(os.path.join(BANKS, name))[:4], atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(arr, axis=-1), 1.0, atol=1e-5)
    for kind in ("styles", "modifiers"):
        name = f"{kind}_names.txt"
        assert (port / name).read_bytes() == (jax_out / name).read_bytes()


# ---------------- tools.fetch_and_convert ----------------

# the fetch tool's artifact for each zoo function of test_torch_checkpoint.SLOTS
ARTIFACT_OF = {
    "build_models": "unet", "build_latent_models": "ldm", "build_esrgan x4": "esrgan_x4",
    "build_esrgan x2": "esrgan_x2", "init_marian": "marian",
}


def _split_lpips(sd):
    """The port's LPIPS dict as the two published files: torchvision's VGG16
    (`features.N.*`) and the lin heads."""
    vgg = {f"features.{k.split('.')[2]}.{k.split('.')[3]}": v for k, v in sd.items()
           if k.startswith("net.")}
    return vgg, {k: v for k, v in sd.items() if k.startswith("lin")}


def test_fetch_places_each_release_where_the_gate_reads_it(tmp_path, monkeypatch):
    """Tiny release files published under file:// URLs; after the tool
    runs, every slot's zoo function loads its file through the gate (the
    provenance lists it) and equals the published weights; the LPIPS and
    sentence-T5 slots are merged from their two files; the tokenizer
    assets and the tw2sp table land under the data dir."""
    monkeypatch.setattr(zoo, "_PROVENANCE", {"loaded": set(), "random_init": set()})
    src, root, data = tmp_path / "published", tmp_path / "weights", tmp_path / "data"
    src.mkdir()
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    artifacts, aesthetic, expected = {}, {}, {}

    def publish(filename, obj):
        path = src / filename
        if isinstance(obj, bytes):
            path.write_bytes(obj)
        else:
            torch.save(obj, path)
        return path.as_uri()

    for family, slot in SLOTS.items():
        modules = slot.build(str(scratch))
        with torch.no_grad():
            for m in modules:
                for p in m.parameters():
                    p.mul_(-1.5).add_(0.01)
        expected[family] = modules
        sd = slot.release(modules)
        release = {slot.wrap: sd} if slot.wrap else sd
        if family in ARTIFACT_OF:
            name = ARTIFACT_OF[family]
            artifacts[name] = (publish(f"{name}.bin", release), fetch_and_convert.ARTIFACTS[name][1])
        elif family == "build_clip":
            monkeypatch.setattr(fetch_and_convert, "CLIP_JIT",
                                {TINY_CLIP: publish("tiny_clip.pt", release)})
        elif family.startswith("build_aesthetic"):
            tower = "ViT-B/32" if "linear" in family else "ViT-L/14"
            aesthetic[tower] = publish(f"aesthetic_{tower.replace('/', '_')}.pth", release)
        elif family == "build_lpips":
            vgg, lin = _split_lpips(sd)
            for name, part in (("vgg16", vgg), ("lpips_lin", lin)):
                artifacts[name] = (publish(f"{name}.pth", part),
                                   fetch_and_convert.ARTIFACTS[name][1])
        elif family == "load_or_init_sentence_t5":
            dense = {"linear.weight": sd["linear.weight"]}
            encoder = {k: v for k, v in sd.items() if k != "linear.weight"}
            for name, part in (("t5_encoder", encoder), ("t5_dense", dense)):
                artifacts[name] = (publish(f"{name}.bin", part),
                                   fetch_and_convert.ARTIFACTS[name][1])
    assert set(expected) == set(SLOTS)
    for name in ("bpe", "bert_vocab", "t5_spm", "marian_spm", "marian_vocab"):
        artifacts[name] = (publish(name, name.encode()), fetch_and_convert.ARTIFACTS[name][1])
    dicts = {"TWPhrasesIT.txt": "軟件\t軟體\n", "TWPhrasesName.txt": "", "TWPhrasesOther.txt": "",
             "TWVariants.txt": "", "TSPhrases.txt": "", "TSCharacters.txt": "軟\t软\n體\t体\n"}
    for name, text in dicts.items():
        publish(name, text.encode())
    monkeypatch.setattr(fetch_and_convert, "ARTIFACTS", artifacts)
    monkeypatch.setattr(fetch_and_convert, "AESTHETIC", aesthetic)
    monkeypatch.setattr(fetch_and_convert, "OPENCC_DICT_BASE", src.as_uri() + "/")

    argv = ["--unet", "--ldm", "--esrgan", "--aesthetic", "--lpips", "--vocab", "--marian",
            "--t5", "--opencc", "--clip", TINY_CLIP, "--root", str(root), "--data-dir", str(data)]
    assert fetch_and_convert.main(argv) == 0
    assert fetch_and_convert.main(argv) == 0  # a second run keeps what is in place

    for family, slot in SLOTS.items():
        for name in slot.names:
            assert zoo.provisioned_checkpoint(name, str(root), slot.file) == str(
                root / f"{slot.file}.pt")
        zoo._PROVENANCE["loaded"].clear()
        loaded = slot.build(str(root))
        assert zoo._PROVENANCE["loaded"] == set(slot.names), family
        for want, got in zip(expected[family], loaded):
            _assert_same(_sd(got), _sd(want))
    for rel in ("bpe_simple_vocab_16e6.txt.gz", "bert-base-uncased-vocab.txt", "t5-spiece.model",
                "marian/source.spm", "marian/vocab.json"):
        assert (data / rel).is_file(), rel
    with open(data / "opencc" / "tw2sp_phrases.tsv", encoding="utf-8") as f:
        assert f.read().splitlines()[1:] == ["軟體\t软件"]
