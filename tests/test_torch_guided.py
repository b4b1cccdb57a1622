"""The port's guided pipeline against the JAX package: one step (the
clamped guidance gradient and x_next), then 5-step trajectories of the
tiny pipeline with the JAX package's random draws replayed, then the
public entry point on the CPU."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.diffusion.sampling import init_history, schedule_tables_np
from clip_diffusion_tpu.pipeline import guided as jg
from clip_diffusion_tpu.tests_support import build_tiny_pipeline
from clip_diffusion_tpu_torch import config as tconfig
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig, schedule_tables
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip import model as tclip
from clip_diffusion_tpu_torch.models.clip.tokenizer import tokenize
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline import guided as tg
from clip_diffusion_tpu_torch.utils.progress import get_task_state
from test_torch_cutouts import jax_cut_draws


class JaxReplayDraws:
    """The JAX package's draws for `guided_sample(pipe, params, key)`:
    split(key) -> (k_init, k_scan); per step fold_in(k_scan, step) ->
    split -> (k_cut, k_noise); per cutout group fold_in(k_cut, group)."""

    def __init__(self, key):
        self.k_init, self.k_scan = jax.random.split(key)

    def _step_keys(self, step):
        return jax.random.split(jax.random.fold_in(self.k_scan, step))

    def initial_noise(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.k_init, shape, jnp.float32)))

    def step_noise(self, step, shape):
        k_noise = self._step_keys(step)[1]
        return torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32)))

    def cutouts(self, step, group, batch, repeats, spec, n_ov, n_in):
        gkey = jax.random.fold_in(self._step_keys(step)[0], group)
        return jax_cut_draws(gkey, batch, repeats, spec, n_ov, n_in)


def tiny_port_config():
    """The JAX package's tests_support.tiny_config, in the port."""
    return tconfig.Config(
        width=64, height=64, num_cutout_batches=1, guidance_dtype="float32",
        clip_guidance_scale=1000.0, denoise_scale=100.0, range_scale=10.0,
        LPIPS_scale=0.0, MS_SSIM_scale=0.0,
        cutout_schedules=tconfig.CutoutSchedules(
            num_overview_cuts=tconfig.create_schedule((2,), (1000,)),
            num_inner_cuts=tconfig.create_schedule((2,), (1000,)),
            inner_cut_size_power=tconfig.create_schedule((5,), (1000,)),
            cut_gray_portion=tconfig.create_schedule((0.5,), (1000,)),
        ),
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipe, JAX params, port models) on the same weights."""
    torch.set_num_threads(1)
    jpipe, jparams, _ = build_tiny_pipeline(steps=5)
    unet = UNetModel(UNetConfig.tiny(64))
    from_jax.load_unet(unet, _np_tree(jparams["unet"]))
    clip = tclip.CLIPModel(tclip.tiny_clip_config("tiny0"))
    from_jax.load_clip(clip, _np_tree(jparams["perceptors"][0]["clip"]))
    models = tzoo.ZooModels(unet.requires_grad_(False), {"tiny0": clip.requires_grad_(False)})
    return jpipe, jparams, models


def _port_pipe(models, thresholding="histogram"):
    sampler = SamplerConfig(steps=5, eta=0.8, thresholding_method=thresholding)
    return tzoo.build_pipeline(models, tiny_port_config(), [("a test prompt", 1.0)], sampler)


def test_text_embeddings_match(pipelines):
    """build_pipeline's prompt embedding equals the JAX tiny pipeline's."""
    jpipe, jparams, models = pipelines
    tpipe = _port_pipe(models)
    np.testing.assert_allclose(
        tpipe.perceptors[0].text_embeddings.numpy(),
        np.asarray(jparams["perceptors"][0]["text_embeddings"]), atol=1e-5)


def test_one_step_matches(pipelines):
    """First step (t=999 region): the raw gradient, the clamped guidance and
    x_next against build_guided_step.  f32 on both sides; the gradient runs
    through the UNet, cutouts and CLIP, so atol is 1e-4 of its scale."""
    torch.set_num_threads(1)
    jpipe, jparams, models = pipelines
    tpipe = _port_pipe(models)
    key = jax.random.PRNGKey(11)
    draws = JaxReplayDraws(key)
    step = 4
    x = draws.initial_noise((1, 64, 64, 3))

    loss_fn = jg.make_guidance_loss(jpipe, schedule_tables_np(jpipe.schedule),
                                    jpipe.config.cutout_schedules.as_arrays())
    k_cut, _ = jax.random.split(jax.random.fold_in(draws.k_scan, step))
    jgrad, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jnp.asarray(x.numpy()), jparams, jnp.int32(step), k_cut)
    jguid = jg._clamp_guidance_grad(-jgrad, jpipe.config.grad_threshold)
    step_fn, _ = jg.build_guided_step(jpipe)
    (jx_next, _, _), jpred = jax.jit(step_fn)(
        jparams, (jnp.asarray(x.numpy()), init_history(x.shape), jnp.int32(0)),
        jnp.int32(step), draws.k_scan)

    tables = schedule_tables(tpipe.schedule)
    tgrad, _ = tg.guidance_gradient(tpipe, tables, x, step, draws)
    tguid = tg.clamp_guidance_grad(-tgrad, tpipe.config.grad_threshold)
    tx_next, tpred = tg.guided_step(tpipe, tables, x, step, draws)

    gscale = float(np.abs(np.asarray(jgrad)).max())
    assert gscale > 0
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-4 * gscale)
    np.testing.assert_allclose(tguid.numpy(), np.asarray(jguid), atol=1e-5)
    np.testing.assert_allclose(tx_next.numpy(), np.asarray(jx_next), atol=1e-4)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-3)


@pytest.mark.parametrize("method,atol", [
    # exact quantile on both sides: only float32 summation order differs
    ("sort", 2e-4),
    # the two-level 4096-bin count on both sides: the same, and no more
    ("histogram", 2e-4),
])
def test_five_step_trajectory_matches(pipelines, method, atol):
    torch.set_num_threads(1)
    jpipe, jparams, models = pipelines
    jpipe = dataclasses.replace(
        jpipe, sampler=dataclasses.replace(jpipe.sampler, thresholding_method=method))
    key = jax.random.PRNGKey(3)
    jfinal, jframes = jg.guided_sample(jpipe, jparams, key, batch_size=1)
    tfinal, tframes = tg.guided_sample(_port_pipe(models, method), JaxReplayDraws(key),
                                       batch_size=1)
    assert tframes.shape == np.asarray(jframes).shape == (5, 1, 64, 64, 3)
    assert np.isfinite(tframes.numpy()).all()
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=atol)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=atol)


def test_guided_diffusion_sample_cpu(pipelines, tmp_path):
    """The public entry point at tiny size on the CPU: PNG and GIF written,
    the JAX entry point's return keys, progress every 5 steps."""
    torch.set_num_threads(1)
    _, _, models = pipelines
    seen = []
    out = tsample.guided_diffusion_sample(
        prompt="a test prompt:2", steps=6, seed=5, config=tiny_port_config(),
        models=models, output_dir=str(tmp_path), device="cpu",
        uploader=type("U", (), {"upload": lambda self, p, minutes=10: seen.append(p) or p})(),
    )
    assert sorted(out) == ["gif_urls", "images", "seed"]
    assert out["seed"] == 5
    assert os.path.exists(out["images"][0]) and out["gif_urls"][0].endswith(".gif")
    progress = [os.path.basename(p) for p in seen if "progress" in p]
    assert progress == ["guided_progress_0000.png", "guided_progress_0005.png"]
    assert get_task_state("current_step") == 6
    from PIL import Image

    with Image.open(out["gif_urls"][0]) as gif:
        assert gif.n_frames == 6


def test_entry_points_need_a_gpu_unless_asked(pipelines):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsample.guided_diffusion_sample(steps=2)
    # a finetuned UNet must be a whole state dict of the zoo's UNet
    # (tests/test_torch_checkpoint.py runs a real one)
    with pytest.raises(RuntimeError, match="Missing key"):
        tsample.guided_diffusion_sample(models=pipelines[2], custom_model_params={}, steps=2,
                                        device="cpu")


def test_batched_prompts_give_per_image_embeddings(pipelines):
    _, _, models = pipelines
    pipe = tzoo.build_pipeline(models, tiny_port_config(),
                               [[("a", 1.0)], [("b", 1.0), ("c", 0.5)]], SamplerConfig(steps=5))
    p = pipe.perceptors[0]
    assert p.text_embeddings.shape == (2, 2, 64)
    np.testing.assert_array_equal(p.text_weights.numpy(), [[1.0, 0.0], [1.0, 0.5]])
    emb = models.clips["tiny0"].encode_text(torch.from_numpy(tokenize(["b"])).long())
    torch.testing.assert_close(p.text_embeddings[1, 0], emb[0])
