"""The port's CUDA kernel, the ops whose GPU sums run in no fixed order,
and the tiny latent stack, on the card: it imports neither JAX nor the JAX
package, so a machine with a GPU and no JAX runs it with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  Both modes of the kernel are held
against their plain PyTorch versions on the same device inputs, bit for bit:
the kernel evaluates the plain versions' float32 expressions in their order
and counts with integers."""

import numpy as np
import pytest
import torch

from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.models.esrgan import upscale
from clip_diffusion_tpu_torch.ops.augment import affine_gather
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws
from clip_diffusion_tpu_torch.pipeline.latent import decode_latents, latent_sample
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


class _CpuDraws(TorchDraws):
    """Draws from a CPU generator, handed over on `target`: the same
    numbers for the CPU run and the GPU run."""

    def __init__(self, seed, target):
        super().__init__(seed, "cpu")
        self.target = target

    def initial_noise(self, shape):
        return super().initial_noise(shape).to(self.target)

    def step_noise(self, step, shape):
        return super().step_noise(step, shape).to(self.target)

    def inpaint_noise(self, step, shape):
        return super().inpaint_noise(step, shape).to(self.target)


@pytest.mark.cuda
def test_tiny_latent_stack_on_card_matches_cpu(cuda):
    """The tiny float32 latent stack (LDM UNet, VQ, BERT, RRDBNet x4) on the
    card against the CPU on the same weights and draws: 4 CFG DDIM steps at
    eta 0.5 and 4 PLMS steps inpainting the top half, decoded and upscaled.
    Float32 sums in another order (cuDNN and cuBLAS): atol 1e-3 on [0, 1]
    images."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        models = zoo.build_latent_models(tiny=True, param_dtype=torch.float32, device=dev)
        pipe, text_encode = zoo.build_latent_pipeline(models)
        esrgan = zoo.build_esrgan(tiny=True, device=dev)
        ctx_c, ctx_u = text_encode(["a lighthouse"] * 2), text_encode([""] * 2)
        x0 = pipe.encode(torch.linspace(-1, 1, 2 * 32 * 32 * 3, device=dev).reshape(2, 32, 32, 3))
        mask = torch.zeros((2, 16, 16, 1), device=dev)
        mask[:, :8] = 1.0
        images = []
        for kw in (dict(mode="ddim", eta=0.5), dict(mode="plms", x0_latent=x0, mask=mask)):
            z = latent_sample(pipe, _CpuDraws(5, dev), ctx_c, ctx_u, batch_size=2, height=32,
                              width=32, steps=4, **kw)
            imgs = decode_latents(pipe, z)
            images += [imgs, upscale(esrgan, imgs)]
        outs[dev.type] = [t.float().cpu() for t in images]
    for cpu, gpu in zip(outs["cpu"], outs["cuda"]):
        assert torch.isfinite(gpu).all()
        torch.testing.assert_close(gpu, cpu, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_esrgan_tiled_equals_whole_on_card(cuda):
    """RRDBNet x4 (tiny) on the card: 8 px tiles of a 16x16 image each see
    the whole image with their 16 px of context, so the tiled pass equals
    the whole one within 1e-6; the whole pass equals the CPU's within 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    gpu_model = zoo.build_esrgan(tiny=True, device=cuda)
    whole = upscale(gpu_model, img.to(cuda))
    tiled = upscale(gpu_model, img.to(cuda), tile=8)
    torch.testing.assert_close(tiled, whole, rtol=0, atol=1e-6)
    cpu = upscale(zoo.build_esrgan(tiny=True, device="cpu"), img)
    torch.testing.assert_close(whole.cpu(), cpu, rtol=0, atol=1e-4)
