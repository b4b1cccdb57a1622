"""The port's CUDA kernel, and the ops whose GPU sums run in no fixed
order, on the card: it imports neither JAX nor the JAX package, so a
machine with a GPU and no JAX runs it with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  Both modes of the kernel are held
against their plain PyTorch versions on the same device inputs, bit for bit:
the kernel evaluates the plain versions' float32 expressions in their order
and counts with integers."""

import numpy as np
import pytest
import torch

from clip_diffusion_tpu_torch.ops.augment import affine_gather
from clip_diffusion_tpu_torch.ops.quantile import (
    dynamic_threshold_fast,
    histogram_abs_quantile,
    histogram_abs_quantile_plain,
    histogram_quantile,
    histogram_quantile_plain,
)

MODES = {
    "histogram_quantile": (histogram_quantile, histogram_quantile_plain),
    "histogram_abs_quantile": (histogram_abs_quantile, histogram_abs_quantile_plain),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, rows, n, dtype, device, edge=False):
    x = rng.normal(0, 3, (rows, n)).astype(np.float32)
    if edge:
        x[1] = 0.0  # all-zero row
        x[2] = -0.7  # constant row
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _check_one_launch(name, x, q):
    kernel, plain = MODES[name]
    before = kernel.launches
    got = kernel(x, q)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(x, q)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows", [1, 4])
def test_kernel_matches_plain_on_card(cuda, name, dtype, rows):
    """Each mode against its plain version at the main path's row length,
    with zero and constant rows among the four: equal, one launch per call."""
    rng = np.random.default_rng(rows)
    x = _rows(rng, rows, 786432, dtype, cuda, edge=rows == 4)
    for q in (0.5, 0.995, 1.0):
        _check_one_launch(name, x, q)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODES))
def test_tiled_path_matches_plain(cuda, name):
    """(16, 786432) float32 is 50 MB, more than the resident grid's shared
    memory stages at once: each block walks its segment in tiles."""
    x = _rows(np.random.default_rng(16), 16, 786432, torch.float32, cuda)
    _check_one_launch(name, x, 0.995)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODES))
def test_workspace_is_left_zeroed(cuda, name):
    """Two calls in a row on different data each equal a fresh plain
    result, also at a ragged row length (unaligned bulk-copy heads)."""
    rng = np.random.default_rng(12)
    for shape in ((1, 786432), (3, 100003), (1, 786432)):
        _check_one_launch(name, _rows(rng, *shape, torch.float32, cuda), 0.995)


@pytest.mark.cuda
def test_threshold_launches_kernel_and_never_falls_back(cuda):
    """dynamic_threshold_fast on a 512^2 CUDA image launches mode B once
    and equals the thresholding of the plain quantile; a CUDA tensor the
    kernel cannot take raises instead of running elsewhere."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1.5, (1, 512, 512, 3)).astype(np.float32)).to(cuda)
    before_b, before_a = histogram_abs_quantile.launches, histogram_quantile.launches
    got = dynamic_threshold_fast(x, 0.995)
    assert histogram_abs_quantile.launches == before_b + 1
    assert histogram_quantile.launches == before_a
    thresh = torch.clamp_min(histogram_abs_quantile_plain(x.reshape(1, -1), 0.995), 1.0)
    torch.testing.assert_close(got, torch.clamp(x, -thresh, thresh) / thresh, rtol=0, atol=0)
    for kernel in (histogram_quantile, histogram_abs_quantile):
        with pytest.raises(ValueError, match="contiguous"):
            kernel(x.reshape(1, -1)[:, ::2], 0.5)
        with pytest.raises(TypeError, match="dtype"):
            kernel(x.reshape(1, -1).double(), 0.5)


@pytest.mark.cuda
def test_default_canvas_row_matches_plain(cuda):
    """Mode B at the default 768x512 canvas's row, (1, 1179648) float32,
    the threshold of every step of the default request: bit for bit."""
    x = _rows(np.random.default_rng(7), 1, 1179648, torch.float32, cuda)
    for q in (0.5, 0.995, 1.0):
        _check_one_launch("histogram_abs_quantile", x, q)


@pytest.mark.cuda
def test_affine_gather_on_card_matches_cpu(cuda):
    """The "gather" warp and its gradient on the card against the CPU on the
    same inputs, at the cutouts' 224x224: the forward is the same four-tap
    arithmetic (atol 1e-6), the backward a scatter-add whose float sum order
    on the GPU is not fixed (atol 1e-5 on [0, 1] images)."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.uniform(0, 1, (8, 224, 224, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(0, 1, (8, 224, 224, 3)).astype(np.float32))
    theta = torch.from_numpy(rng.uniform(-0.17, 0.17, 8).astype(np.float32))
    ty, tx = (torch.from_numpy(rng.uniform(-11.2, 11.2, 8).astype(np.float32)) for _ in range(2))
    outs = {}
    for dev in ("cpu", cuda):
        x = img.to(dev).requires_grad_(True)
        out = affine_gather(x, theta.to(dev), ty.to(dev), tx.to(dev))
        (grad,) = torch.autograd.grad(out, x, cot.to(dev))
        outs[str(dev)] = (out.detach().cpu(), grad.cpu())
    (o_cpu, g_cpu), (o_gpu, g_gpu) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(o_gpu, o_cpu, rtol=0, atol=1e-6)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0, atol=1e-5)
