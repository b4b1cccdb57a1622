"""The port's ModifiedResNet CLIP towers against the JAX package: the tiny
tower's encode_image in float32 and bfloat16, the zoo's host init with the
batch statistics, and the full-width RN101 layout on the meta device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.models.clip import model as jm
from clip_diffusion_tpu.zoo import _host_init
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip import model as tm


def _jax_init(jmodel, res):
    return lambda: jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, res, res, 3)),
                               jnp.ones((1, 77), jnp.int32))


def _jax_paths(tree):
    """{path: shape} of a flax variable tree, `batch_stats` paths written
    with that collection first as `from_jax` writes them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(p.key) for p in path)
        keys = keys[1:] if keys[0] == "params" else keys
        out[keys] = tuple(leaf.shape)
    return out


@pytest.fixture(scope="module")
def tiny_rn():
    """JAX tiny RN tower and a float32 tree with non-trivial BatchNorm
    statistics (running means around 0, variances around 1)."""
    jcfg = jm.tiny_clip_config("rn", resnet=True)
    jmodel = jm.CLIPModel(jcfg)
    shapes = jax.eval_shape(_jax_init(jmodel, 64))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jcfg, tree


@pytest.mark.parametrize("dtype,tol", [
    # float32 throughout: sum order only
    ("float32", 1e-4),
    # bf16 convs and projections with float32 BatchNorm outputs, pools,
    # residual sums and pool logits on both sides; XLA and torch round the
    # bf16 intermediates at different places: 3e-2 of the embedding scale
    ("bfloat16", 3e-2),
])
def test_resnet_encode_image_matches(tiny_rn, dtype, tol):
    torch.set_num_threads(1)
    jcfg, tree = tiny_rn
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmodel = jm.CLIPModel(jm.CLIPConfig(**{**jcfg.__dict__, "dtype": jdt}))
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    tcfg = tm.tiny_clip_config("rn", resnet=True)
    tmodel = tm.CLIPModel(tm.CLIPConfig(**{**tcfg.__dict__, "dtype": tdt}))
    from_jax.load_clip(tmodel, tree)
    tmodel = tmodel.to(tdt).requires_grad_(False)

    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    jn = jm.clip_normalize(jnp.asarray(imgs))
    ref = np.asarray(jax.jit(
        lambda p, x: jmodel.apply(p, x, method=jm.CLIPModel.encode_image))(jtree, jn))
    got = tmodel.encode_image(tm.clip_normalize(torch.from_numpy(imgs)))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (3, 64)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * max(scale, 1.0))


def test_resnet_text_tower_and_gradient(tiny_rn):
    """The RN tower's text side is the ViT towers' transformer, and the
    image gradient flows through BatchNorm, pools and the attention pool:
    f32 atol 1e-4 of the gradient's scale."""
    torch.set_num_threads(1)
    jcfg, tree = tiny_rn
    jmodel = jm.CLIPModel(jcfg)
    tmodel = from_jax.load_clip(tm.CLIPModel(tm.tiny_clip_config("rn", resnet=True)), tree)
    tmodel.requires_grad_(False)
    rng = np.random.default_rng(2)
    imgs = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    target = rng.normal(0, 1, (2, 64)).astype(np.float32)

    def jloss(x):
        e = jmodel.apply(tree, x, method=jm.CLIPModel.encode_image)
        return jnp.sum(e * target)

    jgrad = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(imgs)))
    x = torch.from_numpy(imgs).requires_grad_(True)
    (tgrad,) = torch.autograd.grad(torch.sum(tmodel.encode_image(x) * torch.from_numpy(target)), x)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-4 * float(np.abs(jgrad).max()))

    toks = np.zeros((2, 77), np.int64)
    toks[0, :4] = [49406, 320, 1125, 49407]
    toks[1, :3] = [49406, 4558, 49407]
    jtext = np.asarray(jmodel.apply(tree, jnp.asarray(toks), method=jm.CLIPModel.encode_text))
    np.testing.assert_allclose(tmodel.encode_text(torch.from_numpy(toks)).numpy(), jtext,
                               atol=1e-4)


def test_zoo_host_init_equals_jax_zoo_resnet():
    """The port zoo's random init of an RN tree equals the JAX zoo's for the
    same seed: batch statistics as ones (var) and zeros (mean), drawing no
    random numbers, so every later leaf's draw stays in step."""
    torch.set_num_threads(1)
    jmodel = jm.CLIPModel(jm.tiny_clip_config(resnet=True))
    ref = _host_init(_jax_init(jmodel, 64), param_dtype=jnp.float32, seed=7)
    assert set(ref) == {"params", "batch_stats"}
    tmodel = tm.CLIPModel(tm.tiny_clip_config(resnet=True))
    sd = tzoo.host_init_state_dict(tmodel, from_jax.clip_rule, seed=7, dtype=torch.float32)
    want = from_jax.to_state_dict(jax.tree_util.tree_map(np.asarray, ref), tmodel,
                                  from_jax.clip_rule)
    assert sd.keys() == want.keys()
    assert "visual.layer1.0.downsample.1.running_var" in sd
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    assert float(sd["visual.bn1.running_var"].min()) == 1.0
    assert float(sd["visual.bn1.running_mean"].abs().max()) == 0.0


def test_full_width_rn101_layout_matches_jax():
    """RN101 at its preset widths, built on the meta device (no weights):
    every port tensor's JAX path and shape equals `jax.eval_shape` of the
    JAX RN101 init, and the parameter counts are equal."""
    with torch.device("meta"):
        tmodel = tm.CLIPModel(tm.CLIP_PRESETS["RN101"])
    jmodel = jm.CLIPModel(jm.CLIP_PRESETS["RN101"])
    want = _jax_paths(jax.eval_shape(_jax_init(jmodel, 224)))
    got = {path: shape for path, shape, _, _ in from_jax.jax_layout(tmodel, from_jax.clip_rule)}
    assert got == want
    n_jax = sum(int(np.prod(s)) for p, s in want.items() if p[0] != "batch_stats")
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax
    assert "visual.attnpool.q_proj.weight" in tmodel.state_dict()
    assert "visual.layer3.22.conv3.weight" in tmodel.state_dict()
