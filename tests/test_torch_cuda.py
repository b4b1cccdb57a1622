"""The port's CUDA kernel on the card: it imports neither JAX nor the JAX
package, so a machine with a GPU and no JAX runs it with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from clip_diffusion_tpu_torch.ops.quantile import (
    dynamic_threshold_fast,
    histogram_quantile,
    histogram_quantile_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    """The CUDA kernel against the plain version on the same device inputs:
    within 1e-6 * max|x|, and one launch counted per call."""
    rng = np.random.default_rng(10)
    for rows in (1, 4):
        x = torch.from_numpy(rng.normal(0, 3, (rows, 786432)).astype(np.float32)).to(cuda)
        for q in (0.5, 0.995, 1.0):
            before = histogram_quantile.launches
            got = histogram_quantile(x, q)
            torch.cuda.synchronize()
            assert histogram_quantile.launches == before + 1
            ref = histogram_quantile_plain(x, q)
            tol = 1e-6 * float(x.abs().max())
            assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_threshold_launches_kernel_and_never_falls_back(cuda):
    """dynamic_threshold_fast on a 512^2 CUDA image launches the kernel once
    and equals the thresholding of the plain quantile; a CUDA tensor the
    kernel cannot take raises instead of running elsewhere."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1.5, (1, 512, 512, 3)).astype(np.float32)).to(cuda)
    before = histogram_quantile.launches
    got = dynamic_threshold_fast(x, 0.995)
    assert histogram_quantile.launches == before + 1
    thresh = torch.clamp_min(histogram_quantile_plain(x.reshape(1, -1), 0.995), 1.0)
    torch.testing.assert_close(got, torch.clamp(x, -thresh, thresh) / thresh, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        histogram_quantile(x.reshape(1, -1)[:, ::2], 0.5)
    with pytest.raises(TypeError, match="dtype"):
        histogram_quantile(x.reshape(1, -1).double(), 0.5)
