"""The port's guided pipeline on the paths beyond the square DDIM loop,
against the JAX package with its random draws replayed: a non-square
canvas, the init image with `skip_timesteps`, PLMS, an aesthetic head,
LPIPS and MS-SSIM."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.diffusion.sampling import init_history, schedule_tables_np
from clip_diffusion_tpu.diffusion.schedule import make_schedule
from clip_diffusion_tpu.models.aesthetic import LinearAestheticPredictor as JLinearHead
from clip_diffusion_tpu.models.lpips import LPIPS as JLPIPS
from clip_diffusion_tpu.models.unet import UNetConfig as JUNetConfig
from clip_diffusion_tpu.models.unet import UNetModel as JUNetModel
from clip_diffusion_tpu.pipeline import guided as jg
from clip_diffusion_tpu.tests_support import build_tiny_pipeline
from clip_diffusion_tpu.zoo import _host_init
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig, schedule_tables
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.aesthetic import LinearAestheticPredictor
from clip_diffusion_tpu_torch.models.clip import model as tclip
from clip_diffusion_tpu_torch.models.lpips import LPIPS
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline import guided as tg
from test_torch_guided import JaxReplayDraws, tiny_port_config


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX pipe, JAX params, port UNet, port CLIP) on the same weights."""
    torch.set_num_threads(1)
    jpipe, jparams, _ = build_tiny_pipeline(steps=5)
    unet = UNetModel(UNetConfig.tiny(64))
    from_jax.load_unet(unet, _np_tree(jparams["unet"]))
    clip = tclip.CLIPModel(tclip.tiny_clip_config("tiny0"))
    from_jax.load_clip(clip, _np_tree(jparams["perceptors"][0]["clip"]))
    return jpipe, jparams, unet.requires_grad_(False), clip.requires_grad_(False)


def test_non_square_trajectory_matches(tiny):
    """A 5-step DDIM trajectory on a 128x64 (width x height) canvas: the
    same 2e-4 atol as the square trajectory (float32 sum order only)."""
    torch.set_num_threads(1)
    jpipe, jparams, unet, clip = tiny
    jpipe = dataclasses.replace(
        jpipe, config=dataclasses.replace(jpipe.config, width=128, height=64))
    key = jax.random.PRNGKey(8)
    jfinal, jframes = jg.guided_sample(jpipe, jparams, key, batch_size=1)
    models = tzoo.ZooModels(unet, {"tiny0": clip})
    config = dataclasses.replace(tiny_port_config(), width=128, height=64)
    tpipe = tzoo.build_pipeline(models, config, [("a test prompt", 1.0)],
                                SamplerConfig(steps=5, eta=0.8))
    tfinal, tframes = tg.guided_sample(tpipe, JaxReplayDraws(key), batch_size=1)
    assert tframes.shape == np.asarray(jframes).shape == (5, 1, 64, 128, 3)
    assert np.isfinite(tframes.numpy()).all()
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=2e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=2e-4)


def _init_image(rng, h, w):
    """A smooth [-1, 1] init image (a coarse random field, upsampled)."""
    coarse = rng.uniform(-1, 1, (1, h // 8, w // 8, 3))
    return np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(np.float32)


def test_init_image_plms_aesthetic_lpips_trajectory_matches(tiny):
    """Init image diffused to the first executed step, skip_timesteps 2 of
    7 (5 executed PLMS steps, no step noise), an aesthetic head on the tiny
    tower's 64-d embedding and LPIPS (full VGG16) against the init image:
    the JAX pipeline built by dataclasses.replace of the tiny one, the same
    weights and draws.  f32 sum order only: atol 2e-4."""
    torch.set_num_threads(1)
    jpipe0, jparams0, unet, clip = tiny
    rng = np.random.default_rng(21)
    head = JLinearHead()
    hparams = _host_init(lambda: head.init(jax.random.PRNGKey(0), jnp.ones((1, 64))),
                         param_dtype=jnp.float32, seed=121)
    jlpips = JLPIPS(dtype=jnp.float32)
    lparams = _host_init(lambda: jlpips.init(jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)),
                                             jnp.ones((1, 64, 64, 3))),
                         param_dtype=jnp.float32, seed=1000)
    sampler = dict(mode="plms", steps=7, eta=0.8, skip_timesteps=2)
    losses = dict(aesthetic_scale=300.0, LPIPS_scale=1000.0)
    jpipe = dataclasses.replace(
        jpipe0,
        perceptors=(dataclasses.replace(jpipe0.perceptors[0],
                                        aesthetic_fn=lambda p, e: head.apply(p, e)),),
        config=dataclasses.replace(jpipe0.config, **losses),
        sampler=dataclasses.replace(jpipe0.sampler, **sampler),
        schedule=make_schedule(steps=7),
        lpips_fn=lambda p, x, y: jlpips.apply(p, x, y),
        use_init_losses=True,
    )
    jparams = dict(jparams0, lpips=lparams,
                   perceptors=[dict(jparams0["perceptors"][0], aesthetic=hparams)])
    init = _init_image(rng, 64, 64)
    key = jax.random.PRNGKey(13)
    jfinal, jframes = jg.guided_sample(jpipe, jparams, key, batch_size=1,
                                       init_image=jnp.asarray(init))

    thead = from_jax.load_aesthetic(LinearAestheticPredictor(64), _np_tree(hparams))
    tlpips = from_jax.load_lpips(LPIPS(), _np_tree(lparams))
    models = tzoo.ZooModels(unet, {"tiny0": clip}, {"tiny0": thead.requires_grad_(False)},
                            tlpips.requires_grad_(False))
    config = dataclasses.replace(tiny_port_config(), **losses)
    tpipe = tzoo.build_pipeline(models, config, [("a test prompt", 1.0)],
                                SamplerConfig(**sampler), use_init_losses=True)
    assert tpipe.perceptors[0].aesthetic_fn is thead and tpipe.lpips_fn is tlpips
    tfinal, tframes = tg.guided_sample(tpipe, JaxReplayDraws(key), batch_size=1,
                                       init_image=torch.from_numpy(init))
    assert tframes.shape == np.asarray(jframes).shape == (5, 1, 64, 64, 3)
    assert np.isfinite(tframes.numpy()).all()
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=2e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=2e-4)


def test_ms_ssim_guided_step_matches(tiny):
    """One guided DDIM step on a 192x192 canvas (MS-SSIM needs 176) with
    the MS-SSIM term against an init image: the raw gradient and x_next
    against the JAX step's.  f32; atol 1e-4 of the gradient's scale."""
    torch.set_num_threads(1)
    jpipe0, jparams, _, clip = tiny
    # the tiny UNet without its ds-2 attention, which at 192x192 would
    # attend over 96x96 tokens and take minutes on the CPU; host-init
    # weights (the JAX zoo's rule) on both sides
    jcfg = dataclasses.replace(JUNetConfig.tiny(64), attention_ds=())
    junet = JUNetModel(jcfg)
    uparams = _host_init(lambda: junet.init(jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)),
                                            jnp.zeros((1,))), param_dtype=jnp.float32, seed=4)
    unet = from_jax.load_unet(
        UNetModel(dataclasses.replace(UNetConfig.tiny(64), attention_ds=())), _np_tree(uparams))
    losses = dict(width=192, height=192, MS_SSIM_scale=2000.0)
    jpipe = dataclasses.replace(jpipe0, config=dataclasses.replace(jpipe0.config, **losses),
                                unet_apply=lambda p, x, t: junet.apply(p, x, t),
                                use_init_losses=True)
    init = _init_image(np.random.default_rng(22), 192, 192)
    jparams = dict(jparams, unet=uparams, init_image=jnp.asarray(init))
    key = jax.random.PRNGKey(17)
    draws = JaxReplayDraws(key)
    step = 3
    x = draws.initial_noise((1, 192, 192, 3))
    loss_fn = jg.make_guidance_loss(jpipe, schedule_tables_np(jpipe.schedule),
                                    jpipe.config.cutout_schedules.as_arrays())
    k_cut, k_noise = jax.random.split(jax.random.fold_in(draws.k_scan, step))
    jx = jnp.asarray(x.numpy())
    jgrad, (_, _, jpred) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jx, jparams, jnp.int32(step), k_cut)
    # the rest of build_guided_step's body, outside jit (no UNet in it)
    jguid = jg._clamp_guidance_grad(-jgrad, jpipe.config.grad_threshold)
    jtables = {k: jnp.asarray(v) for k, v in schedule_tables_np(jpipe.schedule).items()}
    (jx_next, _, _), _ = jg.apply_sampler_update(
        jpipe.sampler, jtables, (jx, init_history(x.shape), jnp.int32(0)), jnp.int32(step),
        jpred, jguid, k_noise)

    models = tzoo.ZooModels(unet.requires_grad_(False), {"tiny0": clip})
    config = dataclasses.replace(tiny_port_config(), **losses)
    tpipe = tzoo.build_pipeline(models, config, [("a test prompt", 1.0)],
                                SamplerConfig(steps=5, eta=0.8), use_init_losses=True)
    tables = schedule_tables(tpipe.schedule)
    t_init = torch.from_numpy(init)
    tgrad, tpred = tg.guidance_gradient(tpipe, tables, x, step, draws, t_init)
    tguid = tg.clamp_guidance_grad(-tgrad, tpipe.config.grad_threshold)
    tx_next, _ = tg.apply_sampler_update(tpipe.sampler, tables, x, step, tpred, tguid,
                                         draws.step_noise(step, x.shape))
    jgrad = np.asarray(jgrad)
    gscale = float(np.abs(jgrad).max())
    assert gscale > 0
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-4 * gscale)
    np.testing.assert_allclose(tx_next.numpy(), np.asarray(jx_next), atol=1e-4)


def test_guided_diffusion_sample_init_image_cpu(tiny, tmp_path):
    """The public entry point on the CPU with an init image given as encoded
    bytes, PLMS and skip_timesteps: LPIPS is attached to a shallow copy of
    the caller's zoo (the caller's keeps none), the output is written."""
    import io

    from PIL import Image

    from clip_diffusion_tpu_torch import sample as tsample

    torch.set_num_threads(1)
    _, _, unet, clip = tiny
    rng = np.random.default_rng(23)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(buf, format="PNG")
    models = tzoo.ZooModels(unet, {"tiny0": clip})
    config = dataclasses.replace(tiny_port_config(), LPIPS_scale=1000.0)
    out = tsample.guided_diffusion_sample(
        prompt="a test prompt", init_image=buf.getvalue(), sample_mode="plms", steps=7,
        skip_timesteps=2, seed=3, config=config, models=models, output_dir=str(tmp_path),
        device="cpu")
    assert models.lpips is None
    with Image.open(out["images"][0]) as im:
        arr = np.asarray(im.convert("RGB"))
    assert arr.shape == (64, 64, 3) and arr.std() > 0
