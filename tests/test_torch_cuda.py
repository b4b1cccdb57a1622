"""The port's CUDA kernel, the ops whose GPU sums run in no fixed order,
the tiny latent stack and the text front end (tiny sentence-T5 and
MarianMT, retrieval), on the card: it imports neither JAX nor the JAX
package, so a machine with a GPU and no JAX runs it with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  Both modes of the kernel are held
against their plain PyTorch versions on the same device inputs, bit for bit:
the kernel evaluates the plain versions' float32 expressions in their order
and counts with integers."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.esrgan import upscale
from clip_diffusion_tpu_torch.models.ldm.unet import (
    GRAPHS_PER_MODULE,
    LDMUNet,
    LDMUNetConfig,
    attention as ldm_attention,
    attention_plain,
)
from clip_diffusion_tpu_torch.ops.attention import (
    LDM_SHAPES,
    attention_float32,
    errors,
    fused_attention,
    projection_heads,
)
from clip_diffusion_tpu_torch.models.marian import MarianConfig, greedy_decode, marian_tokenize
from clip_diffusion_tpu_torch.models.t5 import SentenceT5, T5Config, t5_tokenize
from clip_diffusion_tpu_torch.text.retrieval import EmbeddingIndex
from clip_diffusion_tpu_torch.ops.augment import affine_gather
from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.models.aesthetic import LinearAestheticPredictor
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.pipeline import guided
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws
from clip_diffusion_tpu_torch.pipeline.latent import decode_latents, latent_sample
from clip_diffusion_tpu_torch.utils import profiling
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


def _random_ldm_unet(cfg, dev, seed):
    """An LDM UNet on `dev` with every parameter drawn from the seed (no
    zero layer): weights ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.01)."""
    with torch.device(dev):
        unet = LDMUNet(cfg).requires_grad_(False)
    g = torch.Generator(dev).manual_seed(seed)
    for name, p in unet.named_parameters():
        noise = torch.randn(p.shape, generator=g, device=dev)
        if p.dim() > 1:
            p.copy_(noise * p[0].numel() ** -0.5)
        else:
            p.copy_(noise * 0.1 + float(name.endswith("weight")))
    return unet


def _ldm_inputs(cfg, batch, hw, ctx_len, dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn((batch, hw, hw, cfg.in_channels), generator=g, device=dev),
            torch.randint(1, 1000, (batch,), generator=g, device=dev).float(),
            torch.randn((batch, ctx_len, cfg.context_dim), generator=g, device=dev))


def _device_kernels(prof) -> int:
    return sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ldm_unet_graph_replays_the_eager_forward(cuda, dtype, monkeypatch):
    """The tiny LDM UNet without grad on the card, replayed from its CUDA
    graphs: bit for bit `_forward` at two batch sizes, a graph captured
    under inference mode also taking calls under `no_grad`; every call
    with new inputs gets their answer, and the output it returned keeps
    its values through later calls; the forward hook fires once per call
    with the caller's tensors and the returned output; one
    `ldm.unet.replay` span per replayed call, whose kernels the
    profiler sees; at most GRAPHS_PER_MODULE graphs, the least recently
    used dropped.  Each call, the capturing one included, adds one
    forward's attention calls (22) to `attention.calls` and, in bfloat16,
    as many fused kernel launches to `attention.kernel_launches` (float32
    runs the plain body: none).  In bfloat16 the heads are 64 wide (the
    fused kernel's width; the tiny config's 16 has no instance)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LDMUNetConfig.tiny(), dtype=dtype)
    if dtype == torch.bfloat16:
        cfg = dataclasses.replace(cfg, model_channels=64, num_heads=-1, num_head_channels=64)
    unet = _random_ldm_unet(cfg, cuda, 0)
    seen = []
    hook = unet.register_forward_hook(lambda _m, args, out: seen.append((args, out)))
    calls = []
    launches = 22 if dtype == torch.bfloat16 else 0
    for k, batch in enumerate((2, 2, 6, 6, 2)):
        args = _ldm_inputs(cfg, batch, 8, 5, cuda, k)
        with torch.inference_mode() if k % 2 == 0 else torch.no_grad():
            before = ldm_attention.calls, ldm_attention.kernel_launches
            got = unet(*args)
            assert (ldm_attention.calls - before[0],
                    ldm_attention.kernel_launches - before[1]) == (22, launches), k
            want = unet._forward(*args)
        assert torch.equal(got, want), f"call {k}: {(got - want).abs().max().item()}"
        assert seen[-1][1] is got and all(a is b for a, b in zip(seen[-1][0], args))
        calls.append((got, got.clone()))
    assert len(seen) == 5 and len(unet._graphs) == 2
    assert not torch.equal(calls[0][0], calls[1][0])
    for got, copy in calls:
        assert torch.equal(got, copy)

    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    args = _ldm_inputs(cfg, 6, 8, 5, cuda, 9)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        with torch.profiler.profile(activities=activities) as eager:
            unet._forward(*args)
            torch.cuda.synchronize(cuda)
        with torch.profiler.profile(activities=activities) as replayed:
            unet(*args)
            unet(*args)
            torch.cuda.synchronize(cuda)
    names = [s.name for s in profiling.spans()]
    assert names.count("ldm.unet.replay") == 2
    print(f"{dtype}: {_device_kernels(eager)} kernels eager, "
          f"{_device_kernels(replayed)} in two replayed calls")
    assert _device_kernels(replayed) >= 2 * _device_kernels(eager)

    for batch in (1, 3, 4, 5):
        with torch.no_grad():
            unet(*_ldm_inputs(cfg, batch, 8, 5, cuda, batch))
    hook.remove()
    assert len(unet._graphs) == GRAPHS_PER_MODULE == 4
    assert [key[0][0][0] for key in unet._graphs] == [1, 3, 4, 5]


def _bf16_tower(dev, seed: int, resnet: bool = False) -> CLIPModel:
    cfg = dataclasses.replace(tiny_clip_config(f"tiny{seed}", resnet), dtype=torch.bfloat16)
    tower = CLIPModel(cfg)
    tower.load_state_dict(zoo.host_init_state_dict(tower, from_jax.clip_rule, seed,
                                                   torch.bfloat16))
    return tower.to(dev).requires_grad_(False)


def _tower_spans(fn) -> int:
    """`guided.tower.replay` spans recorded while `fn` runs under a profile."""
    before = len([s for s in profiling.spans() if s.name == "guided.tower.replay"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    return len([s for s in profiling.spans() if s.name == "guided.tower.replay"]) - before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["two_vits_one_head", "resnet_head"])
def test_tower_chunk_graphs_equal_the_eager_body(cuda, kind, monkeypatch):
    """`_cut_gradient` on the card with bf16 tiny towers, 24 cuts a row at
    batch 2 in chunks of 16 and 8: each tower's chunks replayed from their
    CUDA graphs give the eager body's gradient bit for bit (the eager
    reference: the same towers behind a lambda, which never capture), two
    towers of one resolution sharing the static leaf, with an aesthetic
    head on one; a second prompt's embeddings and weights through the same
    graphs; and again after `.to()` drops a tower's graphs.  One
    `guided.tower.replay` span a chunk."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    towers = ([_bf16_tower(cuda, 2), _bf16_tower(cuda, 3)] if kind == "two_vits_one_head"
              else [_bf16_tower(cuda, 4, resnet=True)])
    head = LinearAestheticPredictor(64).to(cuda).requires_grad_(False)
    cfg = Config(clip_cut_chunk=16, aesthetic_scale=3.0)
    res = towers[0].cfg.image_resolution
    g = torch.Generator(cuda).manual_seed(5)

    def perceptors(seed: int, eager: bool):
        out = []
        for i, tower in enumerate(towers):
            gen = torch.Generator(cuda).manual_seed(10 * seed + i)
            embed = (lambda x, t=tower: t.encode_image(x)) if eager else tower.encode_image
            out.append(guided.Perceptor(
                name=f"t{i}", embed_image=embed, input_resolution=res,
                text_embeddings=torch.randn((2, 64), generator=gen, device=cuda),
                text_weights=torch.rand((2,), generator=gen, device=cuda),
                aesthetic_fn=head if i == len(towers) - 1 else None))
        return tuple(out)

    def grads(seed: int, eager: bool, normed, weights):
        pipe = guided.GuidedPipeline(unet=None, perceptors=perceptors(seed, eager),
                                     config=cfg, sampler=None, schedule=None, device=cuda)
        with torch.enable_grad():
            return guided._cut_gradient(pipe, list(range(len(towers))), normed, weights)

    # (prompt seed, move the first tower first): a capture, a replay, a new
    # prompt through the same graphs, a recapture after the move
    for k, (seed, move) in enumerate([(0, False), (0, False), (1, False), (1, True)]):
        if move:
            towers[0].to(cuda)
            assert not towers[0]._graphs
        normed = torch.randn((2, 24, res, res, 3), generator=g, device=cuda).to(torch.bfloat16)
        weights = torch.rand((2, 24), generator=g, device=cuda)
        want = grads(seed, True, normed, weights)
        assert torch.equal(want, grads(seed, True, normed, weights)), "eager differs from itself"
        if k == 0 or move:  # capture outside the profile
            got = grads(seed, False, normed, weights)
            assert torch.equal(got, want), f"capturing call {k}: {(got - want).abs().max()}"
        out = []
        replays = _tower_spans(lambda: out.append(grads(seed, False, normed, weights)))
        assert replays == 2 * len(towers), (k, replays)
        assert torch.equal(out[0], want), f"call {k}: {(out[0] - want).abs().max().item()}"
        for tower in towers:
            assert [key[0][1] for key in tower._graphs] == [16, 8]
            assert all(entry is not None for entry in tower._graphs.values())
    leaves = {id(e.leaf) for t in towers for e in t._graphs.values()}
    assert len(leaves) == 2  # one static leaf a chunk shape, whatever the tower


@pytest.mark.cuda
def test_full_width_ldm_unet_graph_equals_eager(cuda):
    """txt2img-f8-large's UNet in bfloat16 at the latent request's CFG
    shape (6 x 32 x 32 x 4, context 6 x 77 x 1280): the replayed graph
    equals the eager forward bit for bit, twice; each replay adds a
    forward's 32 attention calls and 32 fused kernel launches (16
    transformer blocks, self and cross)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LDMUNetConfig()
    unet = _random_ldm_unet(cfg, cuda, 1)
    with torch.inference_mode():
        unet._forward(*_ldm_inputs(cfg, 6, 32, 77, cuda, 9))
        torch.cuda.synchronize(cuda)
        reserved = torch.cuda.memory_reserved(cuda)
        for k in range(2):
            args = _ldm_inputs(cfg, 6, 32, 77, cuda, 10 + k)
            before = ldm_attention.calls, ldm_attention.kernel_launches
            got = unet(*args)
            assert (ldm_attention.calls - before[0],
                    ldm_attention.kernel_launches - before[1]) == (32, 32)
            want = unet._forward(*args)
            gap = (got - want).abs().max().item()
            print(f"full width, call {k}: largest gap {gap}, |eps| max "
                  f"{want.abs().max().item():.4f}")
            assert torch.equal(got, want)
    print(f"memory reserved: {reserved / 2 ** 20:.1f} MiB after an eager forward, "
          f"{torch.cuda.memory_reserved(cuda) / 2 ** 20:.1f} MiB after the capture")
    del unet


@pytest.mark.cuda
def test_full_width_sdxl_unet_graph_equals_eager(cuda):
    """SDXL base 1.0's UNet in bfloat16 at the SDXL cell's CFG shape (6 x
    128 x 128 x 4, context 6 x 77 x 2048, vector 6 x 2816), its attention
    through the fused kernel: the replayed graph equals the eager forward
    bit for bit, twice; each replay adds a forward's 140 attention calls
    and 140 kernel launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LDMUNetConfig.sdxl()
    unet = _random_ldm_unet(cfg, cuda, 15)
    with torch.inference_mode():
        for k in range(2):
            g = torch.Generator(cuda).manual_seed(20 + k)
            args = _ldm_inputs(cfg, 6, 128, 77, cuda, 20 + k) + (
                torch.randn((6, cfg.adm_in_channels), generator=g, device=cuda),)
            before = ldm_attention.calls, ldm_attention.kernel_launches
            got = unet(*args)
            assert (ldm_attention.calls - before[0],
                    ldm_attention.kernel_launches - before[1]) == (140, 140)
            want = unet._forward(*args)
            assert torch.isfinite(got).all()
            assert torch.equal(got, want), f"call {k}: {(got - want).abs().max().item()}"
    del unet
    torch.cuda.empty_cache()


# Every (batch, heads, query tokens, key tokens, head dim) the LDM
# configurations send `attention`
ATTENTION_SHAPES = [shape[1:6] for shape in LDM_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_attention_against_plain_and_float32(cuda, shape):
    """The fused kernel and the plain body on the same bf16 inputs (logits
    spread about 2), each against the same attention evaluated in float32:
    the kernel's error is no larger than the plain body's, in the relative
    Frobenius norm and in the largest element.  Against the plain body
    the kernel stays within 2% (relative norm) and 0.1 (largest element
    of outputs up to about 3): the plain body rounds each logit to bf16
    before the softmax (2^-9 of a logit, up to a few percent of a
    probability at these logits), which the kernel does not, and both
    round P and the output to bf16.  The result is the (b, t, h, d)
    buffer seen as (b, h, t, d), and equal on a second call."""
    b, h, t_q, t_k, d = shape
    g = torch.Generator(cuda).manual_seed(t_q + t_k + d)
    q = projection_heads(g, b, h, t_q, d, 2.0)
    k = projection_heads(g, b, h, t_k, d)
    v = projection_heads(g, b, h, t_k, d)
    scale = torch.tensor(math.sqrt(d), dtype=torch.bfloat16).item()
    got = fused_attention(q, k, v, scale)
    plain = attention_plain(q, k, v, scale, torch.bfloat16)
    ref = attention_float32(q, k, v, scale)
    assert got.shape == plain.shape == (b, h, t_q, d) and got.dtype == torch.bfloat16
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, fused_attention(q, k, v, scale))
    k_rel, k_max = errors(got, ref)
    p_rel, p_max = errors(plain, ref)
    kp_rel, kp_max = errors(got, plain)
    print(f"{shape}: vs float32 kernel {k_rel:.3e} / {k_max:.3e}, plain {p_rel:.3e} / "
          f"{p_max:.3e}; kernel vs plain {kp_rel:.3e} / {kp_max:.3e}")
    assert k_rel <= p_rel and k_max <= p_max
    assert kp_rel <= 0.02 and kp_max <= 0.1


@pytest.mark.cuda
def test_fused_attention_refuses_grad_and_other_shapes(cuda):
    """On the card a bf16 input that requires grad under grad mode raises
    (forward only), as does a head width without an instance; without
    grad mode the same input runs; float32 takes the plain body."""
    g = torch.Generator(cuda).manual_seed(0)
    q = projection_heads(g, 2, 4, 64, 64)
    kv = projection_heads(g, 2, 4, 77, 64)
    with pytest.raises(RuntimeError, match="grad"):
        ldm_attention(q.detach().requires_grad_(True), kv, kv, 8.0, torch.bfloat16)
    with torch.no_grad():
        ldm_attention(q.detach().requires_grad_(True), kv, kv, 8.0, torch.bfloat16)
    bad = projection_heads(g, 2, 4, 64, 32)
    with pytest.raises(ValueError, match="head dim"):
        ldm_attention(bad, bad, bad, 5.65625, torch.bfloat16)
    launches = ldm_attention.kernel_launches
    got = ldm_attention(q.float(), kv.float(), kv.float(), 8.0, torch.float32)
    assert ldm_attention.kernel_launches == launches
    assert torch.equal(got, attention_plain(q.float(), kv.float(), kv.float(), 8.0,
                                            torch.float32))


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


@pytest.mark.cuda
def test_tiny_text_models_on_card_match_cpu(cuda):
    """Tiny sentence-T5 (random init by the zoo's rule) on the card against
    the CPU: embeddings within 1e-4; tiny MarianMT: teacher-forced logits
    within 1e-4 and greedy ids equal token for token."""
    torch.backends.cuda.matmul.allow_tf32 = False
    texts = ["a castle on a hill", "by Greg Rutkowski", "x", "一只 猫"]
    toks = torch.from_numpy(t5_tokenize(texts)).long()
    t5 = {dev: zoo._materialize(lambda: SentenceT5(T5Config.tiny()), from_jax.t5_rule, 4,
                                torch.float32, dev) for dev in ("cpu", cuda)}
    with torch.no_grad():
        emb_cpu, emb_gpu = t5["cpu"](toks), t5[cuda](toks.to(cuda)).cpu()
    torch.testing.assert_close(emb_gpu, emb_cpu, rtol=0, atol=1e-4)

    cfg = MarianConfig.tiny()
    src = torch.from_numpy(marian_tokenize(texts, 12, cfg)).long()
    marian = {dev: zoo.init_marian(cfg, seed=5, device=dev) for dev in ("cpu", cuda)}
    with torch.no_grad():
        logits_cpu = marian["cpu"](src, src[:, :6])
        logits_gpu = marian[cuda](src.to(cuda), src[:, :6].to(cuda)).cpu()
    torch.testing.assert_close(logits_gpu, logits_cpu, rtol=0, atol=1e-4)
    ids_cpu = greedy_decode(marian["cpu"], src, max_len=24)
    ids_gpu = greedy_decode(marian[cuda], src.to(cuda), max_len=24)
    assert ids_gpu.device.type == "cuda"
    torch.testing.assert_close(ids_gpu.cpu(), ids_cpu, rtol=0, atol=0)


@pytest.mark.cuda
def test_embedding_index_on_card_matches_cpu(cuda):
    """The retrieval product and top-k on the card over unit vectors, as the
    shipped banks hold: the CPU's indices (no near-ties in these draws) and
    scores within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    bank, queries = (x / np.linalg.norm(x, axis=-1, keepdims=True)
                     for x in (rng.normal(size=(397, 768)).astype(np.float32),
                               rng.normal(size=(6, 768)).astype(np.float32)))
    s_cpu, i_cpu = EmbeddingIndex(bank, "cpu").search(queries, 5)
    s_gpu, i_gpu = EmbeddingIndex(bank, cuda).search(queries, 5)
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, atol=1e-5)


@pytest.mark.cuda
def test_release_unet_file_loads_onto_the_card_in_bf16(cuda, tmp_path):
    """A tiny release-layout UNet file (attention weights as Conv1d) through
    the zoo's gate with device="cuda": every parameter lands on the card in
    bf16, equal to the same file loaded on the CPU."""
    from clip_diffusion_tpu_torch.config import Config
    from clip_diffusion_tpu_torch.models.convert import release_unet_state_dict
    from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel

    unet = UNetModel(UNetConfig.tiny(64))
    sd = zoo.host_init_state_dict(unet, from_jax.unet_rule, 3, torch.float32)
    torch.save(release_unet_state_dict(sd), tmp_path / "guided_unet_512.pt")
    loaded = {dev: zoo.build_models(Config(chosen_clip_models=()), unet_config=UNetConfig.tiny(64),
                                    device=dev, checkpoint_root=str(tmp_path)).unet
              for dev in ("cpu", cuda)}
    for (name, got), (_, ref) in zip(loaded[cuda].state_dict().items(),
                                     loaded["cpu"].state_dict().items()):
        assert got.device.type == "cuda" and got.dtype == torch.bfloat16, name
        assert torch.equal(got.cpu(), ref), name
        assert torch.equal(ref, sd[name].to(torch.bfloat16)), name
    assert "guided_unet_512" in zoo.weights_provenance()["loaded"]
