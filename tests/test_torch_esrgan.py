"""The port's Real-ESRGAN (RRDBNet x4 and x2, tiled upscaling, the folder
upscaler, the zoo's random init) against the JAX package on the CPU, with
weights carried by `models/from_jax.py`; TF32 is off."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from clip_diffusion_tpu import zoo as jzoo
from clip_diffusion_tpu.models import esrgan as jes
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.models import esrgan as tes
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.utils.image_io import load_image
from test_torch_unet import random_tree


@pytest.fixture(autouse=True)
def _cpu_float32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(scale, seed=0):
    """(JAX model, params, port model): tiny RRDBNet (16 features, 2
    blocks, growth 8) on random weights."""
    jm = jes.RRDBNet(num_feat=16, num_block=2, num_grow_ch=8, scale=scale)
    params = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.ones((1, 8, 8, 3))), seed)
    tm = tes.RRDBNet(num_feat=16, num_block=2, num_grow_ch=8, scale=scale)
    return jm, params, from_jax.load_esrgan(tm, params).requires_grad_(False)


@pytest.mark.parametrize("scale", [4, 2])
def test_tiny_rrdbnet_matches(scale):
    """x4 and x2 (space-to-depth input) forward in float32: atol 1e-5."""
    jm, params, tm = _pair(scale)
    x = np.random.default_rng(1).uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 12 * scale, 16 * scale, 3)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_space_to_depth_follows_the_jax_order():
    """Channel fastest, (fy * 2 + fx) * C + c, as the JAX package packs;
    not F.pixel_unshuffle's channel-slowest order."""
    x = np.random.default_rng(2).normal(0, 1, (1, 4, 6, 3)).astype(np.float32)
    ref = np.asarray(jes._space_to_depth(jnp.asarray(x), 2))
    got = tes._space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    unshuffled = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not np.array_equal(unshuffled.numpy(), ref)


def test_upscale_tiled():
    """Tiled upscaling: on a 16x16 image every 8 px tile with its 16 px of
    context sees the whole image, so it equals the whole-image pass within
    1e-6; on 40x24 with 16 px tiles (edge tiles smaller, interior tiles
    with context cut at 16 px) the port's tiling equals the JAX package's
    within 1e-5."""
    jm, params, tm = _pair(4, seed=3)
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32))
    whole = tes.upscale(tm, img)
    tiled = tes.upscale(tm, img, tile=8)
    assert float(whole.min()) >= 0.0 and float(whole.max()) <= 1.0
    torch.testing.assert_close(tiled, whole, rtol=0, atol=1e-6)

    big = rng.uniform(0, 1, (1, 40, 24, 3)).astype(np.float32)
    ref = np.asarray(jes.upscale(jm, params, jnp.asarray(big), tile=16))
    got = tes.upscale(tm, torch.from_numpy(big), tile=16).numpy()
    assert got.shape == ref.shape == (1, 160, 96, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_super_resolution_folder(tmp_path):
    """Every PNG but the excepted one goes to sr/ under its name, equal to
    `upscale` of the loaded image."""
    _, _, tm = _pair(4)
    rng = np.random.default_rng(5)
    for name in ("a.png", "b.png", "skip.png"):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(tmp_path / name)
    written = tes.super_resolution_folder(tm, str(tmp_path),
                                          exception_paths=[str(tmp_path / "skip.png")])
    assert [os.path.basename(p) for p in written] == ["a.png", "b.png"]
    up = tes.upscale(tm, torch.from_numpy(load_image(str(tmp_path / "a.png")))[None])
    np.testing.assert_allclose(load_image(written[0]), up[0].numpy(), atol=1 / 255 + 1e-6)
    assert load_image(written[0]).shape == (32, 32, 3)


@pytest.mark.parametrize("scale", [4, 2])
def test_tiny_esrgan_zoo_equals_jax_zoo(scale):
    """build_esrgan(tiny=True) equals the JAX zoo's leaves bit for bit
    (seed 2000, float32)."""
    jmodel, jparams = jzoo.build_esrgan(scale=scale, tiny=True)
    tm = tzoo.build_esrgan(scale=scale, tiny=True, device="cpu")
    want = from_jax.to_state_dict(jax.tree_util.tree_map(np.asarray, jparams), tm,
                                  from_jax.esrgan_rule)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    assert "body.1.rdb3.conv5.weight" in got
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_full_width_rrdbnet_layout_matches_jax():
    """RRDBNet x4 at 64 features and 23 blocks on the meta device: the JAX
    paths and shapes equal `jax.eval_shape` of the JAX init; 16,697,987
    parameters."""
    jm = jes.RRDBNet(scale=4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    want = {tuple(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    with torch.device("meta"):
        tm = tes.RRDBNet(scale=4)
    got = {path: shape for path, shape, _, _ in from_jax.jax_layout(tm, from_jax.esrgan_rule)}
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == 16697987
