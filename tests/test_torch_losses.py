"""The port's guidance losses against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.guidance import losses as jl
from clip_diffusion_tpu_torch.guidance import losses as tl
from clip_diffusion_tpu_torch.models.aesthetic import CLIP_DIMS


def test_spherical_distance_matches():
    """(cuts, 1, D) x (1, P, D) broadcast, f32: atol 1e-6."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (5, 1, 16)).astype(np.float32)
    y = rng.normal(0, 1, (1, 3, 16)).astype(np.float32)
    ref = np.asarray(jl.square_spherical_distance_loss(jnp.asarray(x), jnp.asarray(y)))
    got = tl.square_spherical_distance_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    same = tl.square_spherical_distance_loss(torch.from_numpy(y), torch.from_numpy(y))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_l2_normalize_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (4, 8)).astype(np.float32)
    x[0] = 0.0  # eps floor
    np.testing.assert_allclose(tl.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.l2_normalize(jnp.asarray(x))), atol=1e-7)


def test_tv_and_range_losses_match():
    """Per-image TV (replicate padding) and range losses, f32: rtol 1e-6."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1.2, (2, 12, 10, 3)).astype(np.float32)
    for jf, tf in ((jl.total_variational_loss, tl.total_variational_loss),
                   (jl.rgb_range_loss, tl.rgb_range_loss)):
        ref = np.asarray(jf(jnp.asarray(x)))
        got = tf(torch.from_numpy(x)).numpy()
        assert got.shape == (2,)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert float(tl.rgb_range_loss(torch.zeros(1, 4, 4, 3))[0]) == 0.0


def _aesthetic_pair(name, seed):
    """JAX and port heads for CLIP tower `name`, on one float32 tree."""
    import jax

    from clip_diffusion_tpu.models import aesthetic as ja
    from clip_diffusion_tpu_torch.models import aesthetic as ta
    from clip_diffusion_tpu_torch.models import from_jax

    jhead = ja.make_aesthetic_predictor(name)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            jnp.ones((1, ja.CLIP_DIMS[name])))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32),
        shapes)
    thead = from_jax.load_aesthetic(ta.make_aesthetic_predictor(name), tree)
    assert ta.CLIP_DIMS == ja.CLIP_DIMS
    return jhead, tree, thead.eval().requires_grad_(False)


@pytest.mark.parametrize("name", ["ViT-B/32", "ViT-L/14"])
def test_aesthetic_heads_and_loss_match(name):
    """The linear head (512-d) and the 768-1024-128-64-16-1 MLP (dropout
    off) on the same weights, and aesthetic_loss with its gradient over
    L2-normalized embeddings: f32 atol 1e-5."""
    import jax

    torch.set_num_threads(1)
    jhead, tree, thead = _aesthetic_pair(name, 3)
    rng = np.random.default_rng(4)
    emb = rng.normal(0, 1, (6, CLIP_DIMS[name])).astype(np.float32)
    ref = np.asarray(jhead.apply(tree, jnp.asarray(emb)))
    got = thead(torch.from_numpy(emb))
    assert got.shape == ref.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)

    jval, jgrad = jax.value_and_grad(
        lambda e: jl.aesthetic_loss(lambda x: jhead.apply(tree, x), e))(jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_(True)
    tval = tl.aesthetic_loss(thead, x)
    (tgrad,) = torch.autograd.grad(tval, x)
    np.testing.assert_allclose(float(tval.detach()), float(jval), atol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-5)


def test_ms_ssim_and_dissimilarity_match():
    """MS-SSIM (11-tap window, sigma 1.5, 5 scales, relu of cs and ssim,
    valid separable blur) and 1 - MS-SSIM on [-1, 1] images at 192x192, a
    batch of 2 against a target of batch 1, with the gradient: f32 atol
    1e-5 on the values, 1e-4 of the gradient's scale."""
    import jax

    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    target = rng.uniform(-1, 1, (1, 192, 192, 3)).astype(np.float32)
    x = np.clip(target + rng.normal(0, 0.3, (2, 192, 192, 3)), -1.2, 1.2).astype(np.float32)
    x01, t01 = (x + 1) / 2, (target + 1) / 2
    np.testing.assert_allclose(
        float(tl.ms_ssim(torch.from_numpy(x01[:1]), torch.from_numpy(t01))),
        float(jl.ms_ssim(jnp.asarray(x01[:1]), jnp.asarray(t01))), atol=1e-5)

    jval, jgrad = jax.value_and_grad(
        lambda a: jl.structural_dissimilarity_loss(a, jnp.asarray(target)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tval = tl.structural_dissimilarity_loss(xt, torch.from_numpy(target))
    (tgrad,) = torch.autograd.grad(tval, xt)
    assert tval.shape == ()
    assert 0.0 < float(tval.detach()) < 1.0
    np.testing.assert_allclose(float(tval.detach()), float(jval), atol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-4 * float(np.abs(jgrad).max()))
    same = tl.structural_dissimilarity_loss(torch.from_numpy(target), torch.from_numpy(target))
    np.testing.assert_allclose(float(same), 0.0, atol=1e-6)
