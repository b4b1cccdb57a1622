"""The port's CLIP ViT towers and tokenizer against the JAX package."""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.models.clip import model as jm
from clip_diffusion_tpu.models.clip import tokenizer as jtok
from clip_diffusion_tpu.zoo import _host_init
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip import model as tm
from clip_diffusion_tpu_torch.models.clip import tokenizer as ttok

TEXTS = [
    "a test prompt",
    "A lighthouse on a cliff at golden hour, oil painting.",
    "  Mixed   CASE &amp; entities, numbers 1234 and it's fine  ",
    "",
    " ".join(["word"] * 100),  # longer than the 77-token context: truncated
]


def _pair(cfg_name="tiny"):
    jcfg = jm.tiny_clip_config(cfg_name)
    jmodel = jm.CLIPModel(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)),
                            jnp.ones((1, 77), jnp.int32))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tmodel = tm.CLIPModel(tm.tiny_clip_config(cfg_name))
    from_jax.load_clip(tmodel, params)
    return jmodel, params, tmodel.requires_grad_(False)


def test_encode_image_matches():
    """ViT encode_image (patch flatten, class token, pre-LN blocks,
    QuickGELU, f32 LayerNorm) on CLIP-normalized NHWC cuts: f32 atol 1e-4."""
    torch.set_num_threads(1)
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    jn = jm.clip_normalize(jnp.asarray(imgs))
    tn = tm.clip_normalize(torch.from_numpy(imgs))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    ref = np.asarray(jax.jit(lambda p, x: jmodel.apply(p, x, method=jm.CLIPModel.encode_image))(
        params, jn))
    got = tmodel.encode_image(tn).numpy()
    assert got.shape == ref.shape == (3, 64)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_encode_text_matches():
    """Causal text tower with EOT pooling at argmax(tokens): f32 atol 1e-4."""
    torch.set_num_threads(1)
    jmodel, params, tmodel = _pair()
    toks = jtok.tokenize(TEXTS)
    ref = np.asarray(jax.jit(lambda p, t: jmodel.apply(p, t, method=jm.CLIPModel.encode_text))(
        params, jnp.asarray(toks)))
    got = tmodel.encode_text(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_bf16_towers_track_f32():
    """bfloat16 compute (logits in bf16, f32 softmax and LayerNorm) stays
    within 5e-2 of the f32 tower's embedding scale."""
    torch.set_num_threads(1)
    _, params, t32 = _pair()
    cfg = tm.tiny_clip_config()
    t16 = tm.CLIPModel(tm.CLIPConfig(**{**cfg.__dict__, "dtype": torch.bfloat16}))
    from_jax.load_clip(t16, params)
    t16 = t16.to(torch.bfloat16).requires_grad_(False)
    rng = np.random.default_rng(2)
    imgs = tm.clip_normalize(torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)))
    a, b = t32.encode_image(imgs), t16.encode_image(imgs)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) <= 5e-2 * float(a.abs().max())


def test_hash_tokenizer_ids_match():
    """Token ids must be equal: every string, padding and truncation."""
    for text in TEXTS:
        assert jtok.HashTokenizer().encode(text) == ttok.HashTokenizer().encode(text)
    j = jtok.tokenize(TEXTS)
    t = ttok.tokenize(TEXTS)  # both packages find the same table, or none
    np.testing.assert_array_equal(t, j)
    assert t[-1, -1] == ttok.EOT and t.shape == (len(TEXTS), 77)


def test_bpe_tokenizer_ids_match(tmp_path):
    """The BPE path on a small merge table written here: equal ids."""
    merges = ["#version: 0.2", "w o", "wo r", "r d</w>", "wor d</w>", "t h", "th e</w>",
              "a </w>", "l i", "li g", "lig h", "ligh t"]
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    jt, tt = jtok.SimpleTokenizer(str(path)), ttok.SimpleTokenizer(str(path))
    for text in TEXTS[:3] + ["the world of light", "words, WORDS; wörds"]:
        assert jt.encode(text) == tt.encode(text)


def test_zoo_host_init_equals_jax_zoo():
    """The port zoo's random init gives the JAX zoo's weights for the same
    seed (same leaf order, same rules), carried across by from_jax."""
    torch.set_num_threads(1)
    jcfg = jm.tiny_clip_config()
    jmodel = jm.CLIPModel(jcfg)
    ref = _host_init(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)),
                                         jnp.ones((1, 77), jnp.int32)),
                     param_dtype=jnp.float32, seed=7)
    tmodel = tm.CLIPModel(tm.tiny_clip_config())
    sd = tzoo.host_init_state_dict(tmodel, from_jax.clip_rule, seed=7, dtype=torch.float32)
    want = from_jax.to_state_dict(jax.tree_util.tree_map(np.asarray, ref), tmodel,
                                  from_jax.clip_rule)
    assert sd.keys() == want.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)


def test_resnet_towers_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        tm.CLIPModel(tm.CLIP_PRESETS["RN101"])
