"""The port's multi-process serving and perceptor-parallel ensemble against
the JAX package, on the CPU.

World size 1 runs in this process (no process group: the process is the
only rank) and is held against the JAX functions on a one-device mesh with
the JAX draws replayed (2e-4, the guided trajectory's tolerance). World
sizes 2 and 4 run as spawned processes over gloo (`tests/torch_ranks.py`,
no JAX there) and are held against world size 1 (1e-5: only the row count
of each CPU kernel call differs). The ensemble runs at world size 2 and
is held against JAX's `build_ensemble_guided_step` on a 2-device mesh and
against the port's own single-process step with unshared cutouts. About
165 s in one process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.diffusion.sampling import SamplerConfig as JSamplerConfig
from clip_diffusion_tpu.diffusion.sampling import init_history
from clip_diffusion_tpu.diffusion.schedule import make_schedule
from clip_diffusion_tpu.models.clip import CLIPModel as JCLIPModel
from clip_diffusion_tpu.models.clip import tiny_clip_config as jtiny_clip_config
from clip_diffusion_tpu.models.clip import tokenize as jtokenize
from clip_diffusion_tpu.models.unet import UNetConfig as JUNetConfig
from clip_diffusion_tpu.models.unet import UNetModel as JUNetModel
from clip_diffusion_tpu.parallel import serving as jserving
from clip_diffusion_tpu.parallel.ensemble import build_ensemble_guided_step, ensemble_mesh
from clip_diffusion_tpu.parallel.mesh import make_mesh
from clip_diffusion_tpu.pipeline import guided as jg
from clip_diffusion_tpu.tests_support import tiny_config
from clip_diffusion_tpu.zoo import _host_init
from clip_diffusion_tpu import zoo as jzoo
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig, schedule_tables
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip import model as tclip
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.parallel import dist as tdist
from clip_diffusion_tpu_torch.parallel import ensemble as tens
from clip_diffusion_tpu_torch.parallel import serving as tserving
from clip_diffusion_tpu_torch.pipeline import guided as tg
from test_torch_cutouts import jax_cut_draws
from test_torch_guided import JaxReplayDraws, tiny_port_config
from test_torch_latent import JaxLatentDraws
from torch_ranks import (
    AUG_FIELDS,
    RecordedDraws,
    ensemble_rank,
    guided_rank,
    latent_rank,
    spawn,
)

PROMPTS = [f"prompt variant {i}" for i in range(4)]
SEEDS_PER_PROMPT = 2
STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_tiny_pipeline(steps, num_perceptors=1, prompt_texts=None):
    """`tests_support.build_tiny_pipeline`'s pipeline (tiny config, UNet and
    ViT towers) with the JAX zoo's host init in place of flax's, which is
    seconds instead of a minute -> (JAX pipe, JAX params, port ZooModels on
    the same weights)."""
    unet = JUNetModel(JUNetConfig.tiny(64))
    uparams = _host_init(lambda: unet.init(jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)),
                                           jnp.zeros((1,))), param_dtype=jnp.float32, seed=1)
    texts = list(prompt_texts) if prompt_texts else ["a test prompt"]
    toks = jnp.asarray(jtokenize(texts))
    perceptors, perceptor_params, clips = [], [], {}
    for i in range(num_perceptors):
        clip = JCLIPModel(jtiny_clip_config(name=f"tiny{i}"))
        cparams = _host_init(lambda c=clip: c.init(jax.random.PRNGKey(i), jnp.ones((1, 32, 32, 3)),
                                                   toks[:1]), param_dtype=jnp.float32, seed=2 + i)
        text_emb = jax.jit(lambda p, t, c=clip: c.apply(p, t, method=JCLIPModel.encode_text))(
            cparams, toks)
        if prompt_texts:  # one prompt per image: (B, 1, D) and weights (B, 1)
            text_emb, text_w = text_emb[:, None, :], jnp.ones((len(texts), 1))
        else:
            text_w = jnp.ones((1,))
        perceptors.append(jg.Perceptor(
            name=f"tiny{i}", input_resolution=32,
            embed_image=lambda p, im, c=clip: c.apply(p, im, method=JCLIPModel.encode_image)))
        perceptor_params.append({"clip": cparams, "aesthetic": (), "text_embeddings": text_emb,
                                 "text_weights": text_w})
        port_clip = tclip.CLIPModel(tclip.tiny_clip_config(f"tiny{i}"))
        from_jax.load_clip(port_clip, _np_tree(cparams))
        clips[f"tiny{i}"] = port_clip.requires_grad_(False)
    jpipe = jg.GuidedPipeline(
        unet_apply=lambda p, x, t: unet.apply(p, x, t), perceptors=tuple(perceptors),
        config=tiny_config(), sampler=JSamplerConfig(steps=steps, eta=0.8),
        schedule=make_schedule(steps=steps))
    port_unet = UNetModel(UNetConfig.tiny(64))
    from_jax.load_unet(port_unet, _np_tree(uparams))
    models = tzoo.ZooModels(port_unet.requires_grad_(False), clips)
    return jpipe, {"unet": uparams, "perceptors": perceptor_params}, models


class RowsReplay(JaxReplayDraws):
    """The JAX draws of a whole batch; at world size 1 its only row view is
    the whole batch."""

    def rows(self, lo, hi):
        assert lo == 0  # world size 1: rows [0, batch)
        return self


class LatentRowsReplay(JaxLatentDraws):
    def rows(self, lo, hi):
        assert lo == 0  # world size 1: rows [0, batch)
        return self


@pytest.fixture(scope="module")
def guided():
    """(JAX pipe, JAX params, port pipe): two tiny towers, one prompt per
    prompt slot (4), 3 DDIM steps."""
    torch.set_num_threads(1)
    jpipe, jparams, models = jax_tiny_pipeline(STEPS, num_perceptors=2, prompt_texts=PROMPTS)
    tpipe = tzoo.build_pipeline(models, tiny_port_config(), [[(t, 1.0)] for t in PROMPTS],
                                SamplerConfig(steps=STEPS, eta=0.8))
    return jpipe, jparams, tpipe


@pytest.fixture(scope="module")
def guided_world1(guided):
    """The port's serve_guided_batch in this process with its own draws."""
    torch.set_num_threads(1)
    return tserving.serve_guided_batch(guided[2], len(PROMPTS), SEEDS_PER_PROMPT, base_seed=3)


def test_text_embeddings_match(guided):
    jpipe, jparams, tpipe = guided
    for pp, perc in zip(jparams["perceptors"], tpipe.perceptors):
        assert perc.text_embeddings.shape == (4, 1, 64)
        np.testing.assert_allclose(perc.text_embeddings.numpy(), np.asarray(pp["text_embeddings"]),
                                   atol=1e-5)
        np.testing.assert_array_equal(perc.text_weights.numpy(), np.asarray(pp["text_weights"]))


def test_serve_guided_batch_world_1_matches_jax(guided, monkeypatch):
    """4 prompts x 2 seeds, 3 steps, at world size 1 against JAX's
    serve_guided_batch on make_mesh(1), the JAX draws replayed: 2e-4."""
    torch.set_num_threads(1)
    jpipe, jparams, tpipe = guided
    jfinal, jframes = jserving.serve_guided_batch(jpipe, jparams, len(PROMPTS), SEEDS_PER_PROMPT,
                                                  base_seed=3, mesh=make_mesh(1))
    monkeypatch.setattr(tserving, "TorchDraws",
                        lambda seed, device: RowsReplay(jax.random.PRNGKey(seed)))
    tfinal, tframes = tserving.serve_guided_batch(tpipe, len(PROMPTS), SEEDS_PER_PROMPT,
                                                  base_seed=3)
    assert tframes.shape == np.asarray(jframes).shape == (3, 8, 64, 64, 3)
    assert np.isfinite(tframes.numpy()).all()
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=2e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=2e-4)
    # the two seeds of a prompt differ, and so do the prompts
    assert float((tfinal[0] - tfinal[1]).abs().max()) > 1e-3
    assert float((tfinal[0] - tfinal[2]).abs().max()) > 1e-3


def test_serve_guided_batch_prompt_count_raises(guided):
    jpipe, jparams, tpipe = guided
    with pytest.raises(ValueError) as jerr:
        jserving.serve_guided_batch(jpipe, jparams, 3, 2, mesh=make_mesh(1))
    with pytest.raises(ValueError) as terr:
        tserving.serve_guided_batch(tpipe, 3, 2)
    assert str(terr.value) == str(jerr.value) == "params carry 4 prompts, expected 3"


@pytest.mark.parametrize("world", [2, 4])
def test_serve_guided_batch_world_sizes_agree(guided, guided_world1, world, tmp_path):
    """Each rank samples its rows of the 8-image batch and gathers the
    whole: every rank's (final, frames) equal world size 1's within 1e-5."""
    out = str(tmp_path / "guided")
    spawn(guided_rank, world, (str(tmp_path / "pg"), guided[2], len(PROMPTS),
                                   SEEDS_PER_PROMPT, 3, out))
    ref_final, ref_frames = guided_world1
    for rank in range(world):
        final, frames = torch.load(f"{out}.{rank}")
        assert frames.shape == ref_frames.shape == (3, 8, 64, 64, 3)
        torch.testing.assert_close(frames, ref_frames, rtol=0, atol=1e-5)
        torch.testing.assert_close(final, ref_final, rtol=0, atol=1e-5)


# ---------------- latent serving ----------------

LATENT_KW = dict(seeds_per_prompt=2, base_seed=7, height=32, width=32, steps=3,
                 guidance_scale=5.0, eta=0.5)


@pytest.fixture(scope="module")
def latent():
    """(JAX pipe, JAX params, port pipe, contexts (2, T, D) cond and (1, T, D)
    uncond, from the JAX text encoder), the tiny float32 stacks on the same
    weights."""
    torch.set_num_threads(1)
    jpipe, jparams, jtext = jzoo.build_latent_pipeline(
        jzoo.build_latent_models(tiny=True, param_dtype=jnp.float32))
    tpipe, _ = tzoo.build_latent_pipeline(
        tzoo.build_latent_models(tiny=True, param_dtype=torch.float32, device="cpu"))
    ctx_c = np.array(jtext(["a cat painting", "a photo of a dog"]), np.float32)
    ctx_u = np.array(jtext([""]), np.float32)
    return jpipe, jparams, tpipe, ctx_c, ctx_u


@pytest.fixture(scope="module")
def latent_world1(latent):
    torch.set_num_threads(1)
    _, _, tpipe, ctx_c, ctx_u = latent
    return tserving.serve_latent_batch(tpipe, torch.from_numpy(ctx_c), torch.from_numpy(ctx_u),
                                       **LATENT_KW)


def test_serve_latent_batch_world_1_matches_jax(latent, monkeypatch):
    """2 prompts x 2 seeds, CFG DDIM at eta 0.5, 3 steps, decoded, against
    JAX's serve_latent_batch on make_mesh(1) with its draws replayed."""
    torch.set_num_threads(1)
    jpipe, jparams, tpipe, ctx_c, ctx_u = latent
    ref = np.asarray(jserving.serve_latent_batch(jpipe, jparams, jnp.asarray(ctx_c),
                                                 jnp.asarray(ctx_u), mesh=make_mesh(1),
                                                 **LATENT_KW))
    monkeypatch.setattr(tserving, "TorchDraws",
                        lambda seed, device: LatentRowsReplay(jax.random.PRNGKey(seed)))
    got = tserving.serve_latent_batch(tpipe, torch.from_numpy(ctx_c), torch.from_numpy(ctx_u),
                                      **LATENT_KW).numpy()
    assert got.shape == ref.shape == (4, 32, 32, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-4)
    flat = got.reshape(4, -1)
    assert min(np.abs(flat[i] - flat[j]).max() for i in range(4) for j in range(i)) > 1e-3


def test_serve_latent_batch_uncond_forms(latent, latent_world1):
    """context_uncond of 1 row, one per prompt or one per image give the
    same images; any other count raises JAX's ValueError; without CFG
    (None, or guidance 0) and with decode=False, the latents."""
    torch.set_num_threads(1)
    _, _, tpipe, ctx_c, ctx_u = latent
    c, u = torch.from_numpy(ctx_c), torch.from_numpy(ctx_u)
    for rows in (2, 4):
        got = tserving.serve_latent_batch(tpipe, c, u.expand(rows, -1, -1), **LATENT_KW)
        torch.testing.assert_close(got, latent_world1, rtol=0, atol=0)
    with pytest.raises(ValueError, match="context_uncond carries 3 rows; expected 1, 2 "
                                         r"\(per prompt\) or 4 \(per image\)"):
        tserving.serve_latent_batch(tpipe, c, u.expand(3, -1, -1), **LATENT_KW)
    kw = dict(LATENT_KW, decode=False)
    z_none = tserving.serve_latent_batch(tpipe, c, None, **kw)
    z_zero = tserving.serve_latent_batch(tpipe, c, u, **dict(kw, guidance_scale=0.0))
    assert z_none.shape == (4, 16, 16, 4)
    torch.testing.assert_close(z_none, z_zero, rtol=0, atol=0)
    # one prompt as (T, D)
    one = tserving.serve_latent_batch(tpipe, c[0], u, **kw)
    torch.testing.assert_close(one, tserving.serve_latent_batch(tpipe, c[:1], u, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_serve_latent_batch_world_sizes_agree(latent, latent_world1, world, tmp_path):
    _, _, _, ctx_c, ctx_u = latent
    out = str(tmp_path / "latent")
    spawn(latent_rank, world, (str(tmp_path / "pg"), torch.from_numpy(ctx_c),
                                   torch.from_numpy(ctx_u), LATENT_KW, out))
    for rank in range(world):
        got = torch.load(f"{out}.{rank}")
        assert got.shape == (4, 32, 32, 3)
        torch.testing.assert_close(got, latent_world1, rtol=0, atol=1e-5)


# ---------------- perceptor-parallel ensemble ----------------

@pytest.fixture(scope="module")
def ensemble(guided):
    """One shared prompt (the first), cutouts not shared across the two
    towers: (JAX pipe, JAX params, port pipe, x, the JAX ensemble's
    [(x_next, pred_x0)] over 3 steps, those steps' JAX draws recorded)."""
    torch.set_num_threads(1)
    jpipe, jparams, tpipe = guided
    jpipe = dataclasses.replace(
        jpipe, config=jpipe.config.replace(share_cutouts_across_perceptors=False))
    jparams = dict(jparams, perceptors=[
        dict(pp, text_embeddings=pp["text_embeddings"][0], text_weights=pp["text_weights"][0])
        for pp in jparams["perceptors"]])
    tpipe = dataclasses.replace(
        tpipe, config=dataclasses.replace(tpipe.config, share_cutouts_across_perceptors=False),
        perceptors=tuple(dataclasses.replace(p, text_embeddings=p.text_embeddings[0],
                                             text_weights=p.text_weights[0])
                         for p in tpipe.perceptors))
    replay = JaxReplayDraws(jax.random.PRNGKey(21))
    x = replay.initial_noise((1, 64, 64, 3))
    steps = list(range(STEPS - 1, -1, -1))
    table = {}
    for step in steps:
        table[("step", step, 0)] = replay.step_noise(step, x.shape).numpy()
        k_cut = jax.random.split(jax.random.fold_in(replay.k_scan, step))[0]
        for pi, perc in enumerate(tpipe.perceptors):
            cd = jax_cut_draws(jax.random.fold_in(k_cut, pi), 1, 1,
                               tpipe.cutout_spec(perc.input_resolution), 2, 2)
            table[("cutouts", step, pi)] = (cd.crop.numpy(),) + tuple(
                getattr(cd.aug, f).numpy() for f in AUG_FIELDS)
    step_fn = jax.jit(build_ensemble_guided_step(jpipe, ensemble_mesh(2)))
    carry = (jnp.asarray(x.numpy()), init_history(x.shape), jnp.int32(0))
    ref = []
    for step in steps:
        carry, pred = step_fn(jparams, carry, jnp.int32(step), replay.k_scan)
        ref.append((np.asarray(carry[0]), np.asarray(pred)))
    return tpipe, x, steps, RecordedDraws(table), ref


@pytest.fixture(scope="module")
def ensemble_world2(ensemble, tmp_path_factory):
    tpipe, x, steps, draws, _ = ensemble
    tmp = tmp_path_factory.mktemp("ensemble")
    spawn(ensemble_rank, 2, (str(tmp / "pg"), tpipe, draws, x, steps, str(tmp / "out")))
    outs = [torch.load(str(tmp / f"out.{rank}")) for rank in range(2)]
    for a, b in zip(*outs):  # every rank holds the same state
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    return outs[0]


def test_ensemble_world_2_matches_jax(ensemble, ensemble_world2):
    """Perceptor `rank` on rank `rank`, one all_reduce of the gradient: 3
    steps against JAX's build_ensemble_guided_step on ensemble_mesh(2),
    the same recorded draws: 2e-4."""
    *_, ref = ensemble
    assert len(ensemble_world2) == len(ref) == STEPS
    for (x, pred), (jx, jpred) in zip(ensemble_world2, ref):
        assert np.isfinite(x.numpy()).all()
        np.testing.assert_allclose(x.numpy(), jx, atol=2e-4)
        np.testing.assert_allclose(pred.numpy(), jpred, atol=2e-4)


def test_ensemble_world_2_matches_single_process(ensemble, ensemble_world2):
    """The ensemble equals the single-process steps with unshared cutouts
    up to the order of the gradient's sum: 1e-5."""
    torch.set_num_threads(1)
    tpipe, x, steps, draws, _ = ensemble
    tables = schedule_tables(tpipe.schedule)
    with torch.no_grad():
        for step, (ex, epred) in zip(steps, ensemble_world2):
            x, pred = tg.guided_step(tpipe, tables, x, step, draws)
            torch.testing.assert_close(ex, x, rtol=0, atol=1e-5)
            torch.testing.assert_close(epred, pred, rtol=0, atol=1e-5)


def test_ensemble_needs_one_perceptor_per_rank(ensemble):
    """Two perceptors in a one-rank process: JAX's ValueError."""
    with pytest.raises(ValueError, match="ensemble axis has 1 devices but the pipeline has 2 "
                                         r"perceptors \(one per device required\)"):
        tens.build_ensemble_guided_step(ensemble[0])


def test_init_refuses_a_missing_backend():
    """No silent switch: a CPU build of torch has no NCCL, and asking for it
    raises before any process group is made."""
    if torch.distributed.is_nccl_available():
        pytest.skip("this torch has NCCL")
    with pytest.raises(RuntimeError, match="backend 'nccl' is not available"):
        tdist.init(device="cpu", backend="nccl", init_method="file:///nonexistent")
    assert not torch.distributed.is_initialized()
