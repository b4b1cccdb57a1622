"""The port's ADM UNet against the JAX package's on weights carried across
by `models/from_jax.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.models import unet as ju
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models import unet as tu


def random_tree(shapes, seed=0):
    """float32 numpy parameters for a flax shape tree: N(0, 1/fan_in)
    kernels and perturbed norm scales/biases, so that no layer is zero (the
    zero-initialized output convs and projections then carry signal)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_params(model, canvas, seed=0):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.ones((1, canvas, canvas, 3)), jnp.zeros((1,)))
    return random_tree(shapes, seed)


def _pair(jcfg, tcfg, canvas, seed=0):
    jm = ju.UNetModel(jcfg)
    params = _jax_params(jm, canvas, seed)
    tm = tu.UNetModel(tcfg)
    from_jax.load_unet(tm, params)
    tm.requires_grad_(False)
    return jm, params, tm


def _inputs(canvas, b=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, canvas, canvas, 3)).astype(np.float32)
    t = np.asarray([999.0, 412.0][:b], np.float32)
    return x, t


def test_tiny_f32_matches():
    """UNetConfig.tiny in float32: conv/matmul sums in another order and
    F.group_norm's variance formula; atol 2e-4 on outputs of scale ~1."""
    torch.set_num_threads(1)
    jm, params, tm = _pair(ju.UNetConfig.tiny(32), tu.UNetConfig.tiny(32), 32)
    x, t = _inputs(32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 6)
    assert np.abs(ref).max() > 0.1  # residual branches carry signal
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_512_topology_narrow(dtype):
    """The for_image_size(512) topology (7 levels, attention at 3
    resolutions, ResBlock up/down) at a 64^2 canvas and width 64.
    float32: atol 5e-4.  bfloat16 compute (both GroupNorm paths differ
    only in where bf16 rounds): rtol 5e-2 of the output's scale."""
    torch.set_num_threads(1)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jcfg = dataclasses.replace(ju.UNetConfig.for_image_size(512), model_channels=64,
                               dtype=jd, remat=False)
    tcfg = dataclasses.replace(tu.UNetConfig.for_image_size(512), model_channels=64,
                               dtype=td, remat=False)
    jm, params, tm = _pair(jcfg, tcfg, 64)
    x, t = _inputs(64)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=5e-4)
    else:
        assert np.abs(got - ref).max() <= 5e-2 * scale
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_both_paths(dtype):
    """GroupNorm32 alone.  float32: flax's E[x^2]-m^2 against
    F.group_norm, atol 1e-5.  bfloat16: the same fused f32-stats core,
    equal up to one bf16 rounding of the output (rtol 1e-2)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(2)
    x = (rng.normal(0.3, 2.0, (2, 8, 8, 64))).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jm = ju.GroupNorm32()
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8, 8, 64), jd))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + rng.normal(0, 0.1, p.shape).astype(np.float32),
        params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x, jd)), np.float32)
    tm = tu.GroupNorm32(64).requires_grad_(False)
    inner = params["params"]["GroupNorm_0"]
    tm.load_state_dict({"weight": torch.from_numpy(inner["scale"]),
                        "bias": torch.from_numpy(inner["bias"])})
    xt = torch.from_numpy(x).to(td).permute(0, 3, 1, 2)
    got = tm(xt).permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=2e-2)


def test_timestep_embedding_matches():
    """cat(cos, sin); the port computes in float64 like the JAX package
    under the tests' x64 mode: atol 1e-6."""
    t = np.asarray([0.0, 1.5, 999.0])
    ref = np.asarray(ju.timestep_embedding(jnp.asarray(t, jnp.float32), 128))
    got = tu.timestep_embedding(torch.from_numpy(t.astype(np.float32)), 128).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_remat_same_output_and_input_grad():
    """torch.utils.checkpoint changes nothing: same forward and d/dx."""
    torch.set_num_threads(1)
    cfg = tu.UNetConfig.tiny(32)
    _, params, tm = _pair(ju.UNetConfig.tiny(32), cfg, 32)
    tr = tu.UNetModel(dataclasses.replace(cfg, remat=True))
    from_jax.load_unet(tr, params)
    tr.requires_grad_(False)
    x, t = _inputs(32, b=1)
    grads = []
    for m in (tm, tr):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = m(xt, torch.from_numpy(t))
        (g,) = torch.autograd.grad(out.square().sum(), xt)
        grads.append((out.detach(), g))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-6, atol=1e-6)


def test_from_jax_rejects_incomplete_trees():
    jm = ju.UNetModel(ju.UNetConfig.tiny(32))
    params = _jax_params(jm, 32)
    tm = tu.UNetModel(tu.UNetConfig.tiny(32))
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["params"]["out_2"]
    with pytest.raises(KeyError):
        from_jax.load_unet(tm, missing)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["params"]["stray"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError):
        from_jax.load_unet(tm, extra)
