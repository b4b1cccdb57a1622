"""The port's guidance losses against the JAX package."""

import jax.numpy as jnp
import numpy as np
import torch

from clip_diffusion_tpu.guidance import losses as jl
from clip_diffusion_tpu_torch.guidance import losses as tl


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
