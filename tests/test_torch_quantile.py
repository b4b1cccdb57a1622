"""The port's histogram quantile (plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode, `torch.quantile` and the
JAX thresholding.  The CUDA kernel's tests are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_diffusion_tpu.diffusion.sampling import dynamic_threshold as jax_dynamic_threshold
from clip_diffusion_tpu.ops.quantile import (
    histogram_abs_quantile as jax_histogram_abs_quantile,
    histogram_quantile_pallas,
)
from clip_diffusion_tpu_torch.ops.quantile import (
    dynamic_threshold_fast,
    histogram_abs_quantile,
    histogram_quantile,
    histogram_quantile_plain,
)


@pytest.mark.parametrize("shape,block", [((2, 16384), 8192), ((3, 12288), 4096)])
def test_plain_matches_pallas_interpret(shape, block):
    """Same algorithm and float32 expressions: equal within 1e-6 * max|x|
    (the interpolation's rounding)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(shape[0])
    x = rng.normal(0, 2, shape).astype(np.float32)
    for q in (0.5, 0.995, 1.0):
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(histogram_quantile_pallas(jnp.asarray(x), q, bins=2048,
                                                       block=block))
        got = histogram_quantile_plain(torch.from_numpy(x), q).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(x).max())


def test_plain_within_bound_of_exact():
    """Within max|x| / bins of torch.quantile(|x|)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    for scale in (0.3, 2.0, 40.0):
        x = torch.from_numpy(rng.normal(0, scale, (3, 20000)).astype(np.float32))
        for q in (0.5, 0.9, 0.995, 1.0):
            exact = torch.quantile(x.abs(), q, dim=1)
            got = histogram_quantile(x, q)
            bound = x.abs().amax(dim=1) / 2048
            assert torch.all((got - exact).abs() <= bound + 1e-6), (scale, q)


def test_edges_zero_constant_and_q1():
    torch.set_num_threads(1)
    z = torch.zeros((2, 4096))
    got = histogram_quantile(z, 0.995)
    assert torch.isfinite(got).all() and float(got.abs().max()) <= 1e-12 / 2048 + 1e-18
    c = torch.full((1, 4096), -0.7)
    for q in (0.5, 0.995, 1.0):
        assert abs(float(histogram_quantile(c, q)[0]) - 0.7) <= 0.7 / 2048
    rng = np.random.default_rng(8)
    v = torch.from_numpy(rng.standard_normal((2, 8192)).astype(np.float32))
    np.testing.assert_allclose(histogram_quantile(v, 1.0).numpy(),
                               v.abs().amax(dim=1).numpy(), rtol=1e-6)


def test_abs_quantile_matches_jax():
    """The JAX main path's two-level quantile, ported: atol 1e-6 * max."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1.5, (2, 6000)).astype(np.float32)
    for q in (0.5, 0.995):
        ref = np.asarray(jax_histogram_abs_quantile(jnp.asarray(x), q))
        got = histogram_abs_quantile(torch.from_numpy(x), q).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(x).max())
    # the two packages' "histogram" thresholds differ by at most the sum of
    # their bounds, max|x|/2048 + max|x|/4096
    got = histogram_quantile(torch.from_numpy(x), 0.995).numpy()
    ref = np.asarray(jax_histogram_abs_quantile(jnp.asarray(x), 0.995))
    assert np.all(np.abs(got - ref) <= np.abs(x).max(axis=1) * (1 / 2048 + 1 / 4096))


def test_dynamic_threshold_fast_matches_jax_exact():
    """Against JAX's sort-based dynamic_threshold: atol 5e-3, as the JAX
    package holds its own fast threshold."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.5, (2, 64, 64, 3)).astype(np.float32)
    fast = dynamic_threshold_fast(torch.from_numpy(x), 0.995).numpy()
    exact = np.asarray(jax_dynamic_threshold(jnp.asarray(x), 0.995))
    np.testing.assert_allclose(fast, exact, atol=5e-3)
    assert np.abs(fast).max() <= 1.0 + 1e-6
    inrange = torch.full((1, 8, 8, 3), 0.4)
    np.testing.assert_allclose(dynamic_threshold_fast(inrange, 0.995).numpy(), 0.4, atol=1e-6)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        histogram_quantile(torch.zeros(8), 0.5)
    with pytest.raises(ValueError):
        histogram_quantile(torch.zeros((1, 8)), 0.5, bins=0)
