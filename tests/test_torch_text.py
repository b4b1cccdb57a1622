"""The port's text front end against the JAX package on the CPU: the
SentencePiece runtime, zh handling, retrieval, sentence-T5, MarianMT, the
zoo's init of both, the committed modifier bank at full width, `Prompt`,
and both sample entry points with Chinese prompts and auto-modifiers.
Weights go across with `models/from_jax.py`; TF32 is off."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu import zoo as jzoo
from clip_diffusion_tpu.models import marian as jmarian
from clip_diffusion_tpu.models import t5 as jt5
from clip_diffusion_tpu.text import prompt as jprompt
from clip_diffusion_tpu.text import retrieval as jretrieval
from clip_diffusion_tpu.text import spm as jspm
from clip_diffusion_tpu.text import zh as jzh
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models import marian as tmarian
from clip_diffusion_tpu_torch.models import t5 as tt5
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.text import prompt as tprompt
from clip_diffusion_tpu_torch.text import retrieval as tretrieval
from clip_diffusion_tpu_torch.text import spm as tspm
from clip_diffusion_tpu_torch.text import zh as tzh
from clip_diffusion_tpu_torch.utils.progress import get_task_state
from test_spm import STRINGS, _fixture_pieces
from test_torch_guided import tiny_port_config
from test_torch_unet import random_tree

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
ZH_PROMPTS = ["一隻可愛的貓在電腦旁", "滑鼠和鍵盤", "夕陽下的城市 油畫", "龍 飛過 雪山"]


@pytest.fixture(autouse=True)
def _cpu_float32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------- SentencePiece, zh, retrieval ----------------

def _byte_fallback_pieces():
    pieces = _fixture_pieces()[:12]
    return pieces + [(f"<0x{b:02X}>", 0.0, jspm.BYTE) for b in range(256)]


@pytest.mark.parametrize("pieces_fn", [_fixture_pieces, _byte_fallback_pieces])
def test_spm_matches_jax(pieces_fn, tmp_path):
    """A model written by `write_model` (the same bytes from both packages)
    gives the same ids, pieces and decoded text, byte fallback included."""
    pieces = pieces_fn()
    blob = tspm.write_model(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0)
    assert blob == jspm.write_model(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0)
    path = tmp_path / "fixture.model"
    path.write_bytes(blob)
    ours, ref = tspm.load_unigram(str(path)), jspm.load_unigram(str(path))
    assert (ours.unk_id, ours.eos_id, ours.pad_id, ours.byte_fallback) == (
        ref.unk_id, ref.eos_id, ref.pad_id, ref.byte_fallback)
    for s in STRINGS + ["a 中文 painting", "a🙂b", "line1\nline2"]:
        ids = ours.encode_as_ids(s)
        assert ids == ref.encode_as_ids(s), s
        assert ours.encode_as_pieces(s) == ref.encode_as_pieces(s), s
        assert ours.decode_ids(ids) == ref.decode_ids(ids), s


@pytest.mark.parametrize("which", ["t5", "marian"])
def test_tokenizers_with_spm_assets_match_jax(which, tmp_path, monkeypatch):
    """With real-format assets (a SentencePiece model, plus vocab.json for
    Marian) both packages tokenize through their SPM runtimes to the same
    ids, and Marian detokenizes alike."""
    pieces = _fixture_pieces()
    (tmp_path / "m.model").write_bytes(tspm.write_model(pieces, unk_id=2, eos_id=1, pad_id=0))
    texts = ["the oil painting of a landscape", "a beautiful naptic painting"]
    caches = ((tt5._spm, jt5._spm) if which == "t5" else (tmarian._assets, jmarian._assets))
    if which == "t5":
        monkeypatch.setenv("T5_SPM_PATH", str(tmp_path / "m.model"))
    else:
        vocab = {p: i + 3 for i, (p, _, _) in enumerate(pieces)}
        (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
        monkeypatch.setenv("MARIAN_SPM_PATH", str(tmp_path / "m.model"))
        monkeypatch.setenv("MARIAN_VOCAB_PATH", str(tmp_path / "vocab.json"))
    for c in caches:
        c.cache_clear()
    try:
        if which == "t5":
            got, ref = tt5.t5_tokenize(texts), jt5.t5_tokenize(texts)
        else:
            cfg, jcfg = tmarian.MarianConfig.tiny(64), jmarian.MarianConfig.tiny(64)
            got = tmarian.marian_tokenize(texts, 16, cfg)
            ref = jmarian.marian_tokenize(texts, 16, jcfg)
            assert tmarian.marian_detokenize(got[0], cfg) == jmarian.marian_detokenize(ref[0], jcfg)
        assert (got[0] > 2).sum() >= 4
        np.testing.assert_array_equal(got, ref)
    finally:
        for c in caches:
            c.cache_clear()


def test_zh_tables_and_tw2sp_match_jax():
    assert tzh._TW2SP_PHRASES == jzh._TW2SP_PHRASES
    assert tzh._T2S == jzh._T2S and tzh._T2S_EXTRA == jzh._T2S_EXTRA
    cases = ZH_PROMPTS + ["我的筆記型電腦當機了", "計算機概論 課本", "程式碼 與 軟體", "a cute cat"]
    for text in cases:
        assert tzh.contains_zh(text) == jzh.contains_zh(text)
        assert tzh.tw_to_simplified(text) == jzh.tw_to_simplified(text), text
    assert tzh.tw_to_simplified("滑鼠") == "鼠标"


def test_tw2sp_tsv_overlay_matches_jax(tmp_path, monkeypatch):
    """An OpenCC phrase TSV overlays the curated table (its rows win) in both
    packages alike."""
    tsv = tmp_path / "tw2sp.tsv"
    tsv.write_text("# comment\n滑鼠\t鼠標測試\n雷射印表機\t激光打印机\n\n壞行\n", encoding="utf-8")
    monkeypatch.setenv("OPENCC_TW2SP_TSV", str(tsv))
    for text in ("滑鼠與雷射印表機", "一隻滑鼠", "雷射"):
        got = tzh.tw_to_simplified(text)
        assert got == jzh.tw_to_simplified(text), text
    assert tzh.tw_to_simplified("滑鼠") != "鼠标"


def test_translate_zh_to_en(tmp_path, monkeypatch):
    """English passes through; Chinese goes through tw2sp, then the given
    translator, else (no Marian weights) through unchanged with a warning;
    the JAX package's Marian orbax directory without the port's release
    file raises rather than translating with random weights."""
    assert tzh.translate_zh_to_en("a cat", lambda t: "X") == "a cat"
    assert tzh.translate_zh_to_en("一隻貓", lambda t: f"[{t}]") == "[一只猫]"
    monkeypatch.setenv("MARIAN_PARAMS_PATH", str(tmp_path / "absent"))
    with pytest.warns(UserWarning, match="untranslated"):
        assert tzh.translate_zh_to_en("一隻貓") == jzh.tw_to_simplified("一隻貓")
    monkeypatch.setenv("MARIAN_PARAMS_PATH", str(tmp_path))
    monkeypatch.setenv("CLIP_DIFFUSION_TORCH", str(tmp_path / "no_port_files"))
    with pytest.raises(RuntimeError, match="marian_zh_en.pt is absent"):
        tzh.translate_zh_to_en("一隻貓")


def test_embedding_index_matches_jax(tmp_path):
    """Top-k indices equal and scores within 1e-6 of the JAX numpy index;
    k is clamped to the bank; a 1-D query is one row."""
    rng = np.random.default_rng(0)
    bank = rng.normal(size=(50, 16)).astype(np.float32)
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    ours = tretrieval.EmbeddingIndex(bank, "cpu")
    ref = jretrieval.EmbeddingIndex(bank, use_native=False)
    for k in (1, 7, 100):
        s, i = ours.search(queries, k)
        rs, ri = ref.search(queries, k)
        assert i.dtype == np.int64 and i.shape == (5, min(k, 50))
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(s, rs, atol=1e-6)
    s, i = ours.search(queries[0], 3)
    assert i.shape == (1, 3)
    path = tmp_path / "bank.npy"
    tretrieval.build_embedding_index(bank, str(path), device="cpu")
    np.testing.assert_array_equal(tretrieval.EmbeddingIndex.from_npy(str(path), "cpu")
                                  .embeddings.numpy(), bank)


# ---------------- sentence-T5 ----------------

def _jax_t5_shapes(cfg):
    return jax.eval_shape(jt5.SentenceT5(cfg).init, jax.random.PRNGKey(0),
                          jnp.ones((1, 64), jnp.int32))


@pytest.fixture(scope="module")
def tiny_t5():
    """(JAX model, params, port model): tiny T5 with a 768-d projection,
    random weights with no layer zero."""
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), projection_dim=768)
    params = random_tree(_jax_t5_shapes(jcfg), seed=1)
    tcfg = dataclasses.replace(tt5.T5Config.tiny(), projection_dim=768)
    tm = from_jax.load_t5(tt5.SentenceT5(tcfg), _np_tree(params))
    return jt5.SentenceT5(jcfg), params, tm.requires_grad_(False)


def test_t5_tokenize_matches_jax():
    texts = ["a cute dog", "by Thomas kinkade", "", "很 好"]
    np.testing.assert_array_equal(tt5.t5_tokenize(texts), jt5.t5_tokenize(texts))
    np.testing.assert_array_equal(tt5.t5_tokenize(texts, 8), jt5.t5_tokenize(texts, 8))


def test_tiny_t5_matches_jax(tiny_t5):
    """Embeddings within 1e-5 of JAX; unit norm; extra pad tokens change
    nothing (masked attention and masked mean)."""
    jm, params, tm = tiny_t5
    texts = ["a castle on a hill", "by Greg Rutkowski", "the same castle", "x"]
    toks = jt5.t5_tokenize(texts)
    ref = np.asarray(jm.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
        short = tm(torch.from_numpy(jt5.t5_tokenize(texts, 16)).long()).numpy()
    assert got.shape == ref.shape == (4, 768)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(short, got, atol=1e-5)


def test_relative_position_buckets_match_jax():
    """The bucket table for every |key - query| <= 63 (64-token inputs)
    equals the JAX package's, and pins its values."""
    rel = np.arange(-63, 64)
    got = tt5._relative_position_bucket(torch.from_numpy(rel)).numpy()
    ref = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel)))
    np.testing.assert_array_equal(got, ref)
    assert list(got[63:71]) == [0] + list(range(17, 24))  # rel 0..7
    assert list(got[62::-1][:8]) == list(range(1, 9))  # rel -1..-8
    # rows per bucket: exact 0-7 (16-23), then log-spaced 8-13 (24-29)
    assert np.bincount(got, minlength=32).tolist() == (
        [1] * 8 + [4, 4, 7, 9, 14, 18, 0, 0, 0] + [1] * 7 + [4, 4, 7, 9, 14, 18, 0, 0])


# ---------------- MarianMT ----------------

@pytest.fixture(scope="module")
def tiny_marian():
    cfg = jmarian.MarianConfig.tiny(vocab=64)
    jm = jmarian.MarianMT(cfg)
    src = jnp.ones((1, 8), jnp.int32)
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), src, src), seed=2)
    tm = from_jax.load_marian(tmarian.MarianMT(tmarian.MarianConfig.tiny(vocab=64)),
                              _np_tree(params))
    return jm, params, tm.requires_grad_(False)


def test_sinusoid_table_matches_jax():
    for n, d in ((64, 16), (512, 512), (10, 7)):
        np.testing.assert_array_equal(tmarian.sinusoidal_positions(n, d),
                                      jmarian.sinusoidal_positions(n, d))


def test_tiny_marian_logits_match_jax(tiny_marian):
    """Teacher-forced logits with source pads: within 1e-5."""
    jm, params, tm = tiny_marian
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    src = rng.integers(1, cfg.vocab_size - 2, (2, 9)).astype(np.int32)
    src[:, -2:] = [cfg.eos_token_id, cfg.pad_token_id]
    tgt = rng.integers(1, cfg.vocab_size - 2, (2, 7)).astype(np.int32)
    tgt[:, 0] = cfg.decoder_start_token_id
    ref = np.asarray(jm.apply(params, jnp.asarray(src), jnp.asarray(tgt)))
    with torch.no_grad():
        got = tm(torch.from_numpy(src).long(), torch.from_numpy(tgt).long()).numpy()
    assert got.shape == ref.shape == (2, 7, 64) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_tiny_marian_greedy_matches_jax(tiny_marian):
    """greedy_decode of 4 tokenized prompts: ids equal token for token, the
    same text, and max_len capped at max_positions - 1."""
    jm, params, tm = tiny_marian
    cfg = tm.cfg
    src = jmarian.marian_tokenize(ZH_PROMPTS, max_len=12, cfg=jm.cfg)
    np.testing.assert_array_equal(tmarian.marian_tokenize(ZH_PROMPTS, 12, cfg), src)
    ref = np.asarray(jmarian.greedy_decode(jm, params, jnp.asarray(src), max_len=20))
    got = tmarian.greedy_decode(tm, src, max_len=20)
    assert got.shape == (4, 20) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), ref)
    for row_t, row_j in zip(got, ref):
        assert tmarian.marian_detokenize(row_t, cfg) == jmarian.marian_detokenize(row_j, jm.cfg)
    assert tmarian.greedy_decode(tm, src[:1], max_len=500).shape == (1, cfg.max_positions - 1)


# ---------------- zoo ----------------

@pytest.mark.parametrize("name", ["t5", "marian"])
def test_tiny_zoo_init_equals_jax_host_init(name):
    """The zoo's host init of tiny T5 and Marian equals the JAX zoo's
    `_host_init` leaves bit for bit (same draws, same leaf order: block_10
    before block_2; RMSNorm `weight`, `rel_bias` and `final_logits_bias`
    drawn)."""
    if name == "t5":
        jmod = jt5.SentenceT5(dataclasses.replace(jt5.T5Config.tiny(), num_layers=11))
        init = lambda: jmod.init(jax.random.PRNGKey(0), jnp.ones((1, 64), jnp.int32))
        tcfg = dataclasses.replace(tt5.T5Config.tiny(), num_layers=11)
        tmod = tzoo._materialize(lambda: tt5.SentenceT5(tcfg), from_jax.t5_rule, 3,
                                 torch.float32, "cpu")
        rule = from_jax.t5_rule
    else:
        jmod = jmarian.MarianMT(jmarian.MarianConfig.tiny())
        src = jnp.ones((1, 8), jnp.int32)
        init = lambda: jmod.init(jax.random.PRNGKey(0), src, src)
        tmod = tzoo.init_marian(tmarian.MarianConfig.tiny(), seed=3, device="cpu")
        rule = from_jax.marian_rule
    want = from_jax.to_state_dict(_np_tree(jzoo._host_init(init, param_dtype=jnp.float32, seed=3)),
                                  tmod, rule)
    got = tmod.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k].float(), rtol=0, atol=0)
    if name == "t5":
        assert got["final_layer_norm.weight"].std() > 0.5  # drawn, not ones
    else:
        assert got["final_logits_bias"].std() > 0.5


@pytest.fixture(scope="module")
def cpu_bank():
    """The shipped modifier bank on the CPU, its encoder the full-width
    sentence-T5 (built once per process)."""
    return tprompt.load_modifier_bank(device="cpu")


def test_absent_assets_and_unloadable_weights(tmp_path, monkeypatch):
    """Without bank assets the default bank is None (with a warning) and
    auto-modifiers append nothing; the JAX package's sentence-T5 orbax
    directory without the port's release file raises, rather than serving
    random weights."""
    with pytest.warns(UserWarning, match="auto-modifiers disabled"):
        assert tprompt.load_modifier_bank(str(tmp_path), device="cpu") is None
    monkeypatch.setattr(tprompt, "DATA_ROOT", str(tmp_path / "empty"))
    with pytest.warns(UserWarning, match="auto-modifiers disabled"):
        assert tprompt.Prompt("a cat:2", True, 3, device="cpu").text == "a cat"
    monkeypatch.setenv("T5_PARAMS_PATH", str(tmp_path))
    monkeypatch.setenv("CLIP_DIFFUSION_TORCH", str(tmp_path / "no_port_files"))
    with pytest.raises(RuntimeError, match="sentence_t5.pt is absent"):
        tzoo.load_or_init_sentence_t5(device="cpu")


def test_full_width_t5_reproduces_committed_bank(cpu_bank):
    """load_or_init_sentence_t5 at full width embeds 8 shipped modifier
    names within 1e-5 of their rows in data/banks/modifiers_t5.npy, which
    the JAX package wrote; 110,218,368 parameters."""
    model = cpu_bank.encoder.model
    assert sum(p.numel() for p in model.parameters()) == 110_218_368
    with open(os.path.join(DATA, "banks", "modifiers_names.txt"), encoding="utf-8") as f:
        names = [line.strip() for line in f if line.strip()]
    rows = [0, 17, 33, 50, 71, 88, 104, 119]
    with torch.no_grad():
        got = model(torch.from_numpy(tt5.t5_tokenize([names[i] for i in rows])).long()).numpy()
    bank = np.load(os.path.join(DATA, "banks", "modifiers_t5.npy"))
    np.testing.assert_allclose(got, bank[rows], atol=1e-5)
    assert cpu_bank.keywords == names


# ---------------- Prompt and the entry points ----------------

def test_prompt_matches_jax(tiny_t5, tiny_marian):
    """`Prompt` with a tiny Marian translator and a bank over the shipped
    keywords and embeddings (tiny T5 query encoder) gives the JAX Prompt's
    `.text` and `.weight` on the same weights."""
    jt, t5_params, tt = tiny_t5
    jm, m_params, tm = tiny_marian
    keywords = tprompt.read_modifier_keywords(os.path.join(DATA, "csv", "modifiers.csv"))
    emb = np.load(os.path.join(DATA, "banks", "modifiers_t5.npy"))

    def jax_translate(text):
        ids = jmarian.marian_tokenize([text], cfg=jm.cfg)
        return jmarian.marian_detokenize(jmarian.greedy_decode(jm, m_params, jnp.asarray(ids))[0],
                                         jm.cfg)

    jbank = jprompt.ModifierBank(keywords, emb, lambda t: np.asarray(
        jt.apply(t5_params, jnp.asarray(jt5.t5_tokenize([t]))))[0])
    tbank = tprompt.ModifierBank.from_files(os.path.join(DATA, "banks", "modifiers_names.txt"),
                                            os.path.join(DATA, "banks", "modifiers_t5.npy"),
                                            tprompt.T5Encoder(tt), device="cpu")
    assert tbank.keywords == keywords
    translate = tmarian.marian_translator(tm)
    cases = [("一隻可愛的貓", True, 2), ("夕陽 城市:2", False, 1), ("a castle on a hill", True, 3),
             ("a lighthouse:0.5", False, 1), ("龍 飛過 雪山", True, 1)]
    for text, auto, k in cases:
        ref = jprompt.Prompt(text, auto, k, jbank, jax_translate)
        got = tprompt.Prompt(text, auto, k, tbank, translate, device="cpu")
        assert (got.text, got.weight) == (ref.text, ref.weight), text
    assert got.text.endswith(tprompt.ARTSTATION_SUFFIX)
    with pytest.raises(TypeError):
        tprompt.Prompt(3)


def _tiny_guided_models():
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(tzoo.host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clip = CLIPModel(tiny_clip_config("tiny0"))
    clip.load_state_dict(tzoo.host_init_state_dict(clip, from_jax.clip_rule, 2, torch.float32))
    return tzoo.ZooModels(unet.requires_grad_(False), {"tiny0": clip.requires_grad_(False)})


def test_guided_sample_auto_modifiers_cpu(cpu_bank, tmp_path):
    """guided_diffusion_sample on the tiny pipeline with a Traditional-Chinese
    prompt and use_auto_modifiers, once with the shipped default bank (its
    full-width T5 on the CPU) and once with an injected bank: `new_prompt`
    is the simplified text, the bank's top keywords of it, and the suffix."""
    models = _tiny_guided_models()
    prompt = ZH_PROMPTS[0]
    simplified = tzh.tw_to_simplified(prompt)
    emb = np.load(os.path.join(DATA, "banks", "modifiers_t5.npy"))
    injected = tprompt.ModifierBank(cpu_bank.keywords, emb[::-1].copy(), cpu_bank.encoder, "cpu")
    for bank, k in ((None, 2), (injected, 3)):
        _, kws = (bank or cpu_bank).topk(simplified, k)
        out = tsample.guided_diffusion_sample(
            prompt=prompt, use_auto_modifiers=True, num_modifiers=k, modifier_bank=bank,
            steps=2, seed=3, config=tiny_port_config(), models=models,
            output_dir=str(tmp_path), device="cpu")
        assert get_task_state("new_prompt") == (
            simplified + "".join(f", {kw}" for kw in kws) + tprompt.ARTSTATION_SUFFIX)
        assert os.path.exists(out["images"][0])
    assert kws != cpu_bank.topk(simplified, 3)[1]  # the injected bank ranks otherwise


def test_latent_sample_accepts_chinese(tmp_path):
    """latent_diffusion_sample encodes the tw2sp text of a Chinese prompt."""
    models = tzoo.build_latent_models(tiny=True, param_dtype=torch.float32, device="cpu")
    pipe, text_encode = tzoo.build_latent_pipeline(models)
    seen = []

    def recording_encode(texts):
        seen.extend(texts)
        return text_encode(texts)

    out = tsample.latent_diffusion_sample(
        prompt="夕陽下的城市", seed=2, diffusion_steps=2, num_iterations=1, num_batches=1,
        sample_width=32, sample_height=32, pipe=pipe, text_encode=recording_encode,
        output_dir=str(tmp_path), device="cpu")
    assert len(out["images"]) == 1
    assert seen == [jzh.tw_to_simplified("夕陽下的城市"), ""]
