"""The port's latent-diffusion stack against the JAX package on the CPU:
the LDM UNet and its blocks, the VQ-f8 first stage, the BERT encoder and
its tokenizer, the DDIM tables, CFG trajectories with the JAX package's
draws replayed, the tiny zoo's random init, and the public entry point.
Weights go across with `models/from_jax.py`; TF32 is off."""

import contextlib
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_diffusion_tpu import zoo as jzoo
from clip_diffusion_tpu.models import unet as jbase
from clip_diffusion_tpu.models.ldm import autoencoder as jvq
from clip_diffusion_tpu.models.ldm import bert as jbert
from clip_diffusion_tpu.models.ldm import unet as junet
from clip_diffusion_tpu.pipeline import latent as jlat
from clip_diffusion_tpu.utils import image_io as jio
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models import unet as tbase
from clip_diffusion_tpu_torch.models.esrgan import upscale
from clip_diffusion_tpu_torch.models.ldm import autoencoder as tvq
from clip_diffusion_tpu_torch.models.ldm import bert as tbert
from clip_diffusion_tpu_torch.models.ldm import unet as tunet
from clip_diffusion_tpu_torch.pipeline import latent as tlat
from clip_diffusion_tpu_torch.utils import image_io as tio
from clip_diffusion_tpu_torch.utils.progress import get_task_state
from test_torch_unet import random_tree


@pytest.fixture(autouse=True)
def _cpu_float32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind", ["Downsample", "Upsample"])
def test_resample_blocks_match(kind):
    """Down/Upsample against the JAX blocks with use_conv ("op" and "conv"
    leaves): atol 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jm = getattr(jbase, kind)(16, use_conv=True, dtype=jnp.float32)
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = getattr(tbase, kind)(16, dtype=torch.float32)
    leaf = "op" if kind == "Downsample" else "conv"
    inner = params["params"][leaf]
    tm.load_state_dict({f"{leaf}.weight": torch.from_numpy(inner["kernel"].transpose(3, 2, 0, 1).copy()),
                        f"{leaf}.bias": torch.from_numpy(inner["bias"])})
    got = _nhwc(tm(_nchw(x)).detach())
    assert got.shape == ref.shape == ((2, 4, 4, 16) if kind == "Downsample" else (2, 16, 16, 16))
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ---------------- LDM UNet ----------------

def _jax_ldm_init(model, cfg, hw=8, ctx_len=5):
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.ones((1, hw, hw, 4)),
                          jnp.zeros((1,)), jnp.ones((1, ctx_len, cfg.context_dim)))


@pytest.fixture(scope="module")
def tiny_unet():
    """(JAX model, params, port model): the tiny f32 LDM UNet on random
    weights with every layer non-zero."""
    jcfg = junet.LDMUNetConfig.tiny()
    jm = junet.LDMUNet(jcfg)
    params = random_tree(_jax_ldm_init(jm, jcfg), seed=3)
    tm = from_jax.load_ldm_unet(tunet.LDMUNet(tunet.LDMUNetConfig.tiny()), params)
    return jm, params, tm.requires_grad_(False)


def test_tiny_ldm_unet_matches(tiny_unet):
    """LDMUNetConfig.tiny in float32 (attention at ds 1 and 2, context dim
    16): atol 1e-5."""
    jm, params, tm = tiny_unet
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([981.0, 21.0], np.float32)
    ctx = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, x, t, ctx))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert got.shape == ref.shape == (2, 8, 8, 4)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_ldm_unet_on_cpu_runs_eagerly(tiny_unet, mode):
    """CPU inputs take the eager forward in every grad mode: no CUDA graph
    is cached, the output equals `_forward`'s exactly, and a forward hook
    sees the caller's tensors and the returned output."""
    _, _, tm = tiny_unet
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32))
    t = torch.tensor([981.0, 21.0])
    ctx = torch.from_numpy(rng.normal(0, 1, (2, 5, 16)).astype(np.float32))
    seen = []
    hook = tm.register_forward_hook(lambda _m, args, out: seen.append((args, out)))
    grad = {"grad": contextlib.nullcontext, "no_grad": torch.no_grad,
            "inference_mode": torch.inference_mode}[mode]
    try:
        with grad():
            got = tm(x, t, ctx)
            want = tm._forward(x, t, ctx)
    finally:
        hook.remove()
    assert not tm._graphs
    assert torch.equal(got, want)
    (args, out), = seen
    assert all(a is b for a, b in zip(args, (x, t, ctx))) and out is got


def test_ldm_unet_drops_its_graphs_when_the_weights_move():
    """A captured graph reads the parameters' storage: `.to()`-style moves
    and `load_state_dict(assign=True)` replace it, so both empty the cache
    and drop its memory pool."""
    tm = tunet.LDMUNet(tunet.LDMUNetConfig.tiny())
    for move in (tm.float, lambda: tm.load_state_dict(tm.state_dict(), assign=True)):
        tm._graphs["key"], tm._graph_pool = "graph", "pool"
        move()
        assert not tm._graphs and tm._graph_pool is None


def _attention_rule(key):
    """CrossAttention alone: to_q/to_k/to_v/to_out.0 -> its JAX leaves."""
    parts = key.split(".")
    name, kind = from_jax._leaf(parts[-1], "dense")
    return (parts[0], name), kind


def _cross_attention_pair(dim_head):
    jm = junet.CrossAttention(dim_head, 1, dim_head, jnp.bfloat16)
    x = np.random.default_rng(2).normal(0, 6.0, (1, 32, dim_head)).astype(np.float32)
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    tm = tunet.CrossAttention(dim_head, dim_head, 1, dim_head, torch.bfloat16)
    from_jax.load_into(tm, params, _attention_rule)
    return jm, params, tm, x


def test_cross_attention_divides_by_bf16_scale():
    """bf16 CrossAttention with dim_head 160, whose sqrt rounds to 12.625 in
    bfloat16 (12.649 exactly).  Inputs of scale 6 give logits of a few
    hundred, where the 0.19% moves the softmax: the port matches JAX within
    4 bfloat16 ulps of the output's scale, and the same port dividing by
    the exact sqrt does not."""
    jm, params, tm, x = _cross_attention_pair(160)
    assert tm.scale == 12.625
    ref = np.asarray(jm.apply(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.inference_mode():
        got = tm(xt).float().numpy()
        tol = 4 * 2.0 ** -8 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)
        tm.scale = math.sqrt(160)
        exact = tm(xt).float().numpy()
    assert np.abs(exact - ref).max() > 4 * tol, (np.abs(exact - ref).max(), tol)


@pytest.mark.parametrize("name,jmodel,tmodel,rule", [
    ("unet", lambda: junet.LDMUNet(junet.LDMUNetConfig()),
     lambda: tunet.LDMUNet(tunet.LDMUNetConfig()), from_jax.ldm_unet_rule),
    ("vq", lambda: jvq.VQModel(jvq.VQConfig()), lambda: tvq.VQModel(tvq.VQConfig()),
     from_jax.vq_rule),
    ("bert", lambda: jbert.BERTEmbedder(jbert.BERTConfig()),
     lambda: tbert.BERTEmbedder(tbert.BERTConfig()), from_jax.bert_rule),
])
def test_full_width_layout_matches_jax(name, jmodel, tmodel, rule):
    """Each full-width module, built on the meta device: every JAX path and
    shape the port's keys map to equals `jax.eval_shape` of the JAX init,
    and the parameter counts are equal (872,300,484 / 67,717,295 /
    542,895,360)."""
    jm = jmodel()
    if name == "unet":
        shapes = _jax_ldm_init(jm, jm.config, hw=8, ctx_len=4)
    elif name == "vq":
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 16, 16, 3)))
    else:
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 77), jnp.int32))
    want = {tuple(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    with torch.device("meta"):
        tm = tmodel()
    got = {path: shape for path, shape, _, _ in from_jax.jax_layout(tm, rule)}
    assert got == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert sum(p.numel() for p in tm.parameters()) == n
    assert n == {"unet": 872300484, "vq": 67717295, "bert": 542895360}[name]


# ---------------- VQ ----------------

@pytest.fixture(scope="module")
def tiny_vq():
    jm = jvq.VQModel(jvq.VQConfig.tiny())
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.ones((1, 32, 32, 3))), seed=5)
    tm = from_jax.load_vq(tvq.VQModel(tvq.VQConfig.tiny()), params)
    return jm, params, tm.requires_grad_(False)


def test_tiny_vq_encode_decode_match(tiny_vq):
    """encode (pre-quantisation latent) at atol 1e-5; decode at atol 1e-5 on
    latents within 1e-3 of codebook rows, so both sides pick the same rows
    far from any tie (the indices are checked equal)."""
    jm, params, tm = tiny_vq
    rng = np.random.default_rng(6)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref_z = np.asarray(jm.apply(params, jnp.asarray(img), method=jvq.VQModel.encode))
    with torch.inference_mode():
        got_z = tm.encode(torch.from_numpy(img)).numpy()
    assert got_z.shape == ref_z.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got_z, ref_z, atol=1e-5)

    cb = params["params"]["codebook"]
    idx = rng.integers(0, cb.shape[0], (2, 16, 16))
    z = (cb[idx] + rng.normal(0, 1e-3, cb[idx].shape)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(z), method=jvq.VQModel.decode))
    with torch.inference_mode():
        np.testing.assert_array_equal(tm.nearest_codes(torch.from_numpy(z)).numpy(), idx.ravel())
        got = tm.decode(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_quantize_indices_match_away_from_ties(tiny_vq):
    """The nearest codebook row of random latents: equal indices wherever
    the best and second-best float64 distances differ by more than 1e-5
    (float32 rounding of |z|^2 - 2 z.cb + |cb|^2 at these scales is about
    1e-7); those rows are almost all of them."""
    jm, params, tm = tiny_vq
    z = np.random.default_rng(7).normal(0, 0.3, (4, 16, 16, 4)).astype(np.float32)
    zq_ref = np.asarray(jm.apply(params, jnp.asarray(z), method=jvq.VQModel.quantize))
    cb = params["params"]["codebook"].astype(np.float64)
    flat = z.reshape(-1, 4).astype(np.float64)
    d = ((flat[:, None, :] - cb[None]) ** 2).sum(-1)
    best2 = np.sort(d, axis=1)[:, :2]
    clear = best2[:, 1] - best2[:, 0] > 1e-5
    assert clear.mean() > 0.95
    ref_idx = np.argmin(((zq_ref.reshape(-1, 1, 4) - cb[None]) ** 2).sum(-1), axis=1)
    with torch.inference_mode():
        got_idx = tm.nearest_codes(torch.from_numpy(z)).numpy()
        zq = tm.quantize_latents(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got_idx[clear], ref_idx[clear])
    rows = clear.reshape(z.shape[:-1])
    np.testing.assert_allclose(zq[rows], zq_ref[rows], atol=1e-6)


# ---------------- BERT ----------------

@pytest.fixture
def vocab_caches():
    """Clear both packages' vocab caches before and after."""
    jbert._load_vocab.cache_clear()
    tbert._load_vocab.cache_clear()
    yield
    jbert._load_vocab.cache_clear()
    tbert._load_vocab.cache_clear()


@pytest.mark.parametrize("with_vocab", [False, True])
def test_bert_tokenize_matches(vocab_caches, tmp_path, monkeypatch, with_vocab):
    """Equal ids with the hash stand-in and with a WordPiece vocab file."""
    texts = ["A cute dogs hello xyz", "", "hello " * 90]
    if with_vocab:
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(["[PAD]", "a", "cute", "dog", "##s", "hel", "##lo"]) + "\n")
        monkeypatch.setenv("BERT_VOCAB_PATH", str(path))
    else:
        monkeypatch.delenv("BERT_VOCAB_PATH", raising=False)
    with contextlib.nullcontext() if with_vocab else pytest.warns(UserWarning):
        got = tbert.bert_tokenize(texts)
    with contextlib.nullcontext() if with_vocab else pytest.warns(UserWarning):
        ref = jbert.bert_tokenize(texts)
    assert got.dtype == np.int32 and got.shape == (3, 77)
    np.testing.assert_array_equal(got, ref)
    if with_vocab:
        assert list(got[0, :8]) == [101, 1, 2, 3, 4, 5, 6, 100]


def test_tiny_bert_matches():
    """BERTConfig.tiny (2 layers, 64 wide, 2 heads x 16) in float32 on the
    hash-tokenized prompts: atol 1e-5."""
    jm = jbert.BERTEmbedder(jbert.BERTConfig.tiny())
    toks = np.zeros((2, 77), np.int32)
    toks[0, :5] = [101, 2054, 15000, 3000, 102]
    toks[1, :2] = [101, 102]
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(toks)), 8)
    ref = np.asarray(jm.apply(params, jnp.asarray(toks)))
    tm = from_jax.load_bert(tbert.BERTEmbedder(tbert.BERTConfig.tiny()), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks).long()).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 77, 64)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    sd = tm.state_dict()
    q = np.asarray(params["params"]["layers_1"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["attn_layers.layers.2.1.to_k.weight"].numpy(), q[:, 32:64].T)


def test_from_jax_reuses_only_the_fused_qkv():
    """Two port keys on one ordinary JAX leaf fail to load; the BERT's three
    projections on its one `qkv` kernel load (above)."""
    module = torch.nn.Sequential(torch.nn.Linear(2, 2, bias=False),
                                 torch.nn.Linear(2, 2, bias=False))
    tree = {"dense": {"kernel": np.eye(2, dtype=np.float32)}}
    with pytest.raises(KeyError, match="mapped twice"):
        from_jax.to_state_dict(tree, module, lambda key: (("dense", "kernel"), "dense"))


def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)


@pytest.mark.parametrize("name", ["unet", "bert"])
def test_tiny_models_match_in_bf16(name, monkeypatch):
    """The tiny LDM UNet and BERT computing in bfloat16 on both sides (the
    full-width dtype), on the same bf16 weights: within 4.5 (UNet) and 3
    (BERT) bf16 ulps of the output's scale, ulp = 2^-7 * max|ref|.  Measured
    here: 3.77 and 1.53.  The UNet with its timesteps rounded to bf16 before
    the sinusoid (the cast before timestep_embedding where JAX casts after)
    reaches 5.4 and fails the bound.  XLA rounds fewer bf16 intermediates
    on the CPU than torch does, so the port's float32 forward lands nearer
    the JAX bf16 one than its bf16 forward: the bound holds the flow of
    casts as a whole and cannot single out one cast that changes only a
    last bit (a LayerNorm output left in float32 changes none, since the
    next Linear casts its input)."""
    rng = np.random.default_rng(1)
    if name == "unet":
        jm = junet.LDMUNet(dataclasses.replace(junet.LDMUNetConfig.tiny(), dtype=jnp.bfloat16))
        params = _bf16_tree(random_tree(_jax_ldm_init(jm, jm.config), seed=3))
        args = (rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32),
                np.asarray([981.0, 21.0], np.float32),
                rng.normal(0, 1, (2, 5, 16)).astype(np.float32))
        tm = from_jax.load_ldm_unet(tunet.LDMUNet(dataclasses.replace(
            tunet.LDMUNetConfig.tiny(), dtype=torch.bfloat16)), params)
        tol_ulps = 4.5
    else:
        jm = jbert.BERTEmbedder(dataclasses.replace(jbert.BERTConfig.tiny(), dtype=jnp.bfloat16))
        toks = np.zeros((2, 77), np.int32)
        toks[0, :5] = [101, 2054, 15000, 3000, 102]
        toks[1, :2] = [101, 102]
        params = _bf16_tree(random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                       jnp.asarray(toks)), 8))
        args = (toks,)
        tm = from_jax.load_bert(tbert.BERTEmbedder(dataclasses.replace(
            tbert.BERTConfig.tiny(), dtype=torch.bfloat16)), params)
        tol_ulps = 3.0
    ref = np.asarray(jax.jit(jm.apply)(params, *args))
    targs = [torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
             for a in args]

    def port_err():
        with torch.inference_mode():
            got = tm(*targs)
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        return np.abs(got.numpy() - ref).max()

    tol = tol_ulps * 2.0 ** -7 * np.abs(ref).max()
    assert ref.dtype == np.float32 and np.abs(ref).max() > 0.5
    assert port_err() <= tol, (port_err(), tol)
    if name == "unet":
        emb = tunet.timestep_embedding
        monkeypatch.setattr(tunet, "timestep_embedding",
                            lambda t, dim: emb(t.to(torch.bfloat16).to(t.dtype), dim))
        assert port_err() > tol, (port_err(), tol)


# ---------------- sampling ----------------

@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_tables_match(eta):
    """50 uniform steps: timesteps 1..981 exactly; the float32 tables equal
    the JAX package's bit for bit (both cast the same float64 values)."""
    ref = jlat.ldm_ddim_tables(50, eta)
    got = tlat.ldm_ddim_tables(50, eta)
    np.testing.assert_array_equal(got["timesteps"].numpy(), np.asarray(ref["timesteps"]))
    assert int(got["timesteps"][0]) == 1 and int(got["timesteps"][-1]) == 981
    for k in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k], np.float32))
    np.testing.assert_array_equal(tlat.ldm_alphas_cumprod(), jlat.ldm_alphas_cumprod())


class JaxLatentDraws:
    """The JAX package's draws for `latent_sample(..., key)`: split(key) ->
    (k_init, k_scan); step i: fold_in(k_scan, i); the inpainting re-noise:
    fold_in(step key, 1)."""

    def __init__(self, key):
        self.k_init, self.k_scan = jax.random.split(key)

    @staticmethod
    def _normal(key, shape):
        return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

    def initial_noise(self, shape):
        return self._normal(self.k_init, shape)

    def step_noise(self, i, shape):
        return self._normal(jax.random.fold_in(self.k_scan, i), shape)

    def inpaint_noise(self, i, shape):
        return self._normal(jax.random.fold_in(jax.random.fold_in(self.k_scan, i), 1), shape)


@pytest.mark.parametrize("case", ["ddim eta 0", "ddim eta 0.5", "plms inpainting"])
def test_cfg_trajectory_matches(tiny_unet, case):
    """CFG (guidance 5, batch 2, 8x8 latents) with the JAX draws replayed:
    5 DDIM steps at eta 0 and 0.5, and 6 PLMS steps inpainting the top
    half of a random init latent: atol 1e-4."""
    jm, params, tm = tiny_unet
    rng = np.random.default_rng(9)
    ctx_c = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    ctx_u = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    kw = dict(batch_size=2, height=8, width=8, guidance_scale=5.0)
    if case == "plms inpainting":
        x0 = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
        mask = np.zeros((2, 8, 8, 1), np.float32)
        mask[:, :4] = 1.0
        kw.update(steps=6, mode="plms")
    else:
        kw.update(steps=5, eta=float(case.split()[-1]))
    key = jax.random.PRNGKey(4)
    jpipe = jlat.LatentPipeline(unet_apply=lambda p, x, t, c: jm.apply(p, x, t, c), downsample=1)
    jextra = dict(x0_latent=x0, mask=mask) if case == "plms inpainting" else {}
    ref = np.asarray(jlat.latent_sample(jpipe, {"unet": params}, key, jnp.asarray(ctx_c),
                                        jnp.asarray(ctx_u), **kw, **jextra))
    tpipe = tlat.LatentPipeline(unet=tm, downsample=1)
    textra = {k: torch.from_numpy(v) for k, v in jextra.items()}
    got = tlat.latent_sample(tpipe, JaxLatentDraws(key), torch.from_numpy(ctx_c),
                             torch.from_numpy(ctx_u), **kw, **textra).numpy()
    assert got.shape == ref.shape == (2, 8, 8, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    if case == "plms inpainting":  # the kept half stays nearer the init latent
        assert np.abs(got[:, :4] - x0[:, :4]).mean() < np.abs(got[:, 4:] - x0[:, 4:]).mean()


# ---------------- zoo and entry point ----------------

def test_tiny_zoo_equals_jax_zoo():
    """build_latent_models(tiny=True) at its default dtypes (UNet and BERT
    bfloat16, VQ float32) equals the JAX zoo's leaves bit for bit: the same
    draws in the same leaf order, the fused BERT qkv drawn once and split."""
    jmodels = jzoo.build_latent_models(tiny=True)
    tmodels = tzoo.build_latent_models(tiny=True, device="cpu")
    for tmod, jparams, rule, dtype in (
            (tmodels.unet, jmodels.unet_params, from_jax.ldm_unet_rule, torch.bfloat16),
            (tmodels.vq, jmodels.vq_params, from_jax.vq_rule, torch.float32),
            (tmodels.bert, jmodels.bert_params, from_jax.bert_rule, torch.bfloat16)):
        want = from_jax.to_state_dict(jax.tree_util.tree_map(np.asarray, jparams), tmod, rule)
        got = tmod.state_dict()
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == dtype, k
            torch.testing.assert_close(got[k].float(), want[k].float(), rtol=0, atol=0)
    assert tmodels.bert.cfg.n_embed == tmodels.unet.config.context_dim == 16


@pytest.fixture(scope="module")
def tiny_stack():
    models = tzoo.build_latent_models(tiny=True, param_dtype=torch.float32, device="cpu")
    pipe, text_encode = tzoo.build_latent_pipeline(models)
    return pipe, text_encode, tzoo.build_esrgan(tiny=True, device="cpu")


def test_latent_diffusion_sample_cpu(tiny_stack, tmp_path):
    """The public entry point on the tiny stack on the CPU: 2 iterations x 2
    images, the grid, the x4 upscales under sr/, `current_iteration` 2; then
    an inpainting call from an init PNG and a mask PNG."""
    pipe, text_encode, esrgan = tiny_stack
    seen = []
    uploader = type("U", (), {"upload": lambda self, p, minutes=10: seen.append(p) or p})()
    out = tsample.latent_diffusion_sample(
        prompt="a tiny test:2", seed=7, diffusion_steps=4, num_iterations=2, num_batches=2,
        sample_width=32, sample_height=32, pipe=pipe, text_encode=text_encode,
        upscaler=functools.partial(upscale, esrgan), uploader=uploader,
        output_dir=str(tmp_path), device="cpu")
    assert sorted(out) == ["grid_url", "images", "seed"] and out["seed"] == 7
    assert [os.path.basename(p) for p in out["images"]] == [f"latent_{i}.png" for i in range(4)]
    assert out["grid_url"].endswith("latent_grid_image.png") and seen == [out["grid_url"]]
    with Image.open(out["grid_url"]) as grid:
        assert grid.size == (2 * 34 + 2, 2 * 34 + 2)
    for p in out["images"]:
        with Image.open(p) as im, Image.open(os.path.join(os.path.dirname(p), "sr",
                                                          os.path.basename(p))) as sr:
            assert im.size == (32, 32) and sr.size == (128, 128)
    assert get_task_state("current_iteration") == 2

    init = tmp_path / "init.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 255, (32, 32, 3), np.uint8)).save(init)
    mask = np.zeros((32, 32, 4), np.uint8)
    mask[:16, :, :] = 255  # opaque white top half: kept
    Image.fromarray(mask, "RGBA").save(tmp_path / "mask.png")
    out = tsample.latent_diffusion_sample(
        prompt="inpaint", seed=8, init_image=str(init), mask_image=str(tmp_path / "mask.png"),
        sample_mode="plms", diffusion_steps=3, num_iterations=1, num_batches=2,
        sample_width=32, sample_height=32, pipe=pipe, text_encode=text_encode,
        output_dir=str(tmp_path / "inpaint"), device="cpu")
    assert len(out["images"]) == 2 and get_task_state("current_iteration") == 1


def test_default_stack_built_once(tiny_stack, tmp_path, monkeypatch):
    """No model arguments: the default stack is built at the first call and
    reused by the next on the same device."""
    builds = []

    def tiny_build(*args, **kwargs):
        builds.append(kwargs.get("device"))
        return tzoo.build_latent_models(tiny=True, param_dtype=torch.float32, device="cpu")

    monkeypatch.setattr(tsample, "build_latent_models", tiny_build)
    monkeypatch.setattr(tsample, "_LATENT_STACK_CACHE", {})
    for seed in (3, 4):
        out = tsample.latent_diffusion_sample(
            prompt="lazy", seed=seed, diffusion_steps=2, num_iterations=1, num_batches=1,
            sample_width=32, sample_height=32, output_dir=str(tmp_path), device="cpu")
        assert len(out["images"]) == 1
    assert builds == [torch.device("cpu")]


def test_latent_entry_point_guards(tiny_stack):
    """A partial injection raises; without a GPU the entry point raises
    unless the caller asks for the CPU."""
    pipe, _, _ = tiny_stack
    with pytest.raises(ValueError, match="together"):
        tsample.latent_diffusion_sample(pipe=pipe, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsample.latent_diffusion_sample(diffusion_steps=1)


def test_image_io_helpers_match(tmp_path):
    """load_mask (RGBA through its alpha, resized), make_grid and
    denormalize equal the JAX package's."""
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (24, 40, 4)).astype(np.uint8)
    path = tmp_path / "mask.png"
    Image.fromarray(rgba, "RGBA").save(path)
    for size in (None, (5, 3)):
        np.testing.assert_array_equal(tio.load_mask(str(path), size),
                                      jio.load_mask(str(path), size))
    imgs = rng.uniform(0, 1, (5, 6, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tio.make_grid(imgs, 3), jio.make_grid(imgs, 3))
    np.testing.assert_array_equal(tio.denormalize_image_zero_to_one(imgs * 2 - 1),
                                  jio.denormalize_image_zero_to_one(imgs * 2 - 1))
    grid = tio.draw_index_on_grid_image(tio.array_to_image(tio.make_grid(imgs, 3)), 2, 3, 6, 4)
    assert grid.size == (3 * 6 + 2, 2 * 8 + 2)
