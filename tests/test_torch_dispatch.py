"""The guided step loop across the cutout schedule's phases, on the CPU:
the phase segments and the whole two-phase trajectory against the JAX
package (its draws replayed), the progress callback, frames and resume
across the phase boundary, the ensemble's step at world size 1, and the
UNet's remat.  The tiny pipeline's cutout schedule has two phases
(overview 4 then 1, inner 1 then 3), as tests/test_segmented.py's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.config import Config as JConfig
from clip_diffusion_tpu.config import CutoutSchedules as JCutoutSchedules
from clip_diffusion_tpu.config import create_schedule as jcreate_schedule
from clip_diffusion_tpu.diffusion.sampling import SamplerConfig as JSamplerConfig
from clip_diffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
from clip_diffusion_tpu.pipeline import guided as jg
from clip_diffusion_tpu.tests_support import tiny_config as jtiny_config
from clip_diffusion_tpu_torch import config as tconfig
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig, schedule_tables
from clip_diffusion_tpu_torch.diffusion.schedule import make_schedule
from clip_diffusion_tpu_torch.models import unet as tunet
from clip_diffusion_tpu_torch.parallel import ensemble as tens
from clip_diffusion_tpu_torch.pipeline import guided as tg
from test_torch_guided import JaxReplayDraws, tiny_port_config
from test_torch_parallel import jax_tiny_pipeline

STEPS = 10
PHASES = dict(overview=((4, 1), (500, 500)), inner=((1, 3), (500, 500)))
BOUNDARY = 5  # the first position of the second phase


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _jax_phases():
    return JCutoutSchedules(
        num_overview_cuts=jcreate_schedule(*PHASES["overview"]),
        num_inner_cuts=jcreate_schedule(*PHASES["inner"]),
        inner_cut_size_power=jcreate_schedule((5,), (1000,)),
        cut_gray_portion=jcreate_schedule((0.5,), (1000,)),
    )


def _port_phases():
    return tconfig.CutoutSchedules(
        num_overview_cuts=tconfig.create_schedule(*PHASES["overview"]),
        num_inner_cuts=tconfig.create_schedule(*PHASES["inner"]),
        inner_cut_size_power=tconfig.create_schedule((5,), (1000,)),
        cut_gray_portion=tconfig.create_schedule((0.5,), (1000,)),
    )


@pytest.fixture(scope="module")
def phase_pipelines():
    """(JAX pipe, JAX params, port ZooModels): the tiny UNet and one tiny
    ViT tower on the same weights, 10 DDIM steps, the two-phase schedule."""
    torch.set_num_threads(1)
    jpipe, jparams, models = jax_tiny_pipeline(STEPS)
    jpipe = dataclasses.replace(jpipe, config=jtiny_config(cutout_schedules=_jax_phases()))
    return jpipe, jparams, models


def _port_pipe(models, mode="ddim"):
    """The port's pipeline on `models` with the two-phase schedule."""
    cfg = dataclasses.replace(tiny_port_config(), cutout_schedules=_port_phases())
    sampler = SamplerConfig(mode=mode, steps=STEPS, eta=0.8)
    return tzoo.build_pipeline(models, cfg, [("a test prompt", 1.0)], sampler)


def _bare_pipes(config_kw, steps):
    """JAX and port pipelines holding only a schedule and a config (what
    compute_phase_segments reads)."""
    jpipe = jg.GuidedPipeline(unet_apply=None, perceptors=(), config=JConfig(**config_kw),
                              sampler=JSamplerConfig(steps=steps),
                              schedule=jmake_schedule(steps=steps))
    tpipe = tg.GuidedPipeline(unet=None, perceptors=(), config=tconfig.Config(**config_kw),
                              sampler=SamplerConfig(steps=steps), schedule=make_schedule(steps=steps),
                              device=torch.device("cpu"))
    return jpipe, tpipe


@pytest.mark.parametrize("case", ["two phases, 10 steps", "default, 250 steps",
                                  "default, 50 steps, 10 skipped"])
def test_compute_phase_segments_matches_jax(case):
    if case.startswith("two phases"):
        jpipe, tpipe = _bare_pipes({}, STEPS)
        jpipe = dataclasses.replace(jpipe, config=jtiny_config(cutout_schedules=_jax_phases()))
        tpipe = dataclasses.replace(tpipe, config=dataclasses.replace(
            tiny_port_config(), cutout_schedules=_port_phases()))
        n_steps = STEPS
    else:
        steps = 250 if "250" in case else 50
        jpipe, tpipe = _bare_pipes({}, steps)
        n_steps = steps - (10 if "skipped" in case else 0)
    want = jg.compute_phase_segments(jpipe, n_steps)
    got = tg.compute_phase_segments(tpipe, n_steps)
    assert [caps for _, caps in got] == [caps for _, caps in want]
    for (gs, _), (ws, _) in zip(got, want):
        assert gs.dtype == np.int32
        np.testing.assert_array_equal(gs, ws)
    assert np.concatenate([s for s, _ in got]).tolist() == list(range(n_steps - 1, -1, -1))
    if case.startswith("two phases"):
        assert [caps for _, caps in got] == [(4, 1), (1, 3)]
        assert [len(s) for s, _ in got] == [BOUNDARY, STEPS - BOUNDARY]


@pytest.mark.parametrize("mode", ["ddim", "plms"])
def test_trajectory_across_phases_matches_jax(phase_pipelines, mode):
    """The whole 10-step trajectory, both phases and the hand-over between
    them, against the JAX package's guided_sample with its draws replayed
    from the schedule maxima's slot layout: the trajectory tolerance of
    test_torch_guided (DDIM) and test_torch_init_plms (PLMS), 2e-4."""
    jpipe, jparams, models = phase_pipelines
    jpipe = dataclasses.replace(jpipe, sampler=JSamplerConfig(mode=mode, steps=STEPS, eta=0.8))
    key = jax.random.PRNGKey(3)
    jfinal, jframes = jg.guided_sample(jpipe, jparams, key)
    tfinal, tframes = tg.guided_sample(_port_pipe(models, mode), JaxReplayDraws(key))
    assert tframes.shape == np.asarray(jframes).shape == (6, 1, 64, 64, 3)
    assert np.isfinite(tframes.numpy()).all()
    assert tframes.abs().amin(dim=(1, 2, 3, 4)).lt(1).all()
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=2e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=2e-4)


def test_progress_and_frames_across_phases(phase_pipelines, monkeypatch):
    """The progress callback fires at every progress_every-th position and
    each frame holds the pred_x0 of its frame_table position, on both sides
    of the phase boundary."""
    _, _, models = phase_pipelines
    preds = []
    step = tg.guided_step

    def recorded(*args, **kwargs):
        out = step(*args, **kwargs)
        preds.append(out[1].clone())
        return out

    monkeypatch.setattr(tg, "guided_step", recorded)
    seen = []
    final, frames = tg.guided_sample(
        _port_pipe(models), tg.TorchDraws(5, "cpu"), progress_every=3,
        progress_callback=lambda pos, pred: seen.append((pos, pred.clone())))
    assert len(preds) == STEPS
    assert [pos for pos, _ in seen] == [0, 3, 6, 9]
    assert all(torch.equal(pred, preds[pos]) for pos, pred in seen)
    table, n_frames = tg.frame_table(STEPS, 6)
    positions = np.flatnonzero(table >= 0).tolist()
    assert positions == [0, 1, 3, 5, 7, 9] and n_frames == frames.shape[0] == 6
    assert min(positions) < BOUNDARY <= max(positions)
    assert all(torch.equal(frames[table[pos]], preds[pos]) for pos in positions)
    assert torch.equal(final, preds[-1])


@pytest.mark.parametrize("step", [7, 2], ids=["phase 1 step", "phase 2 step"])
def test_ensemble_at_world_size_1_equals_guided_step(phase_pipelines, step):
    """The ensemble's step in this process (world size 1, no process group)
    equals guided_step bit for bit in each phase, the JAX draws replayed."""
    _, _, models = phase_pipelines
    pipe = _port_pipe(models)
    tables = schedule_tables(pipe.schedule)
    draws = JaxReplayDraws(jax.random.PRNGKey(6))
    x = draws.initial_noise((1, 64, 64, 3))
    got = tens.build_ensemble_guided_step(pipe)(tables, x, step, draws)
    want = tg.guided_step(pipe, tables, x, step, draws)
    assert torch.isfinite(got[0]).all()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mode", ["ddim", "plms"])
def test_resume_across_a_phase_boundary(phase_pipelines, mode):
    """5 + 1 steps through a SamplingState (the phase boundary lies at
    position 5) equal the straight 6 bit for bit, PLMS's history carried."""
    pipe = _port_pipe(phase_pipelines[2], mode)
    stop = BOUNDARY + 1
    _, straight_frames, straight = tg.guided_sample(pipe, tg.TorchDraws(5, "cpu"),
                                                    stop_after=stop, return_state=True)
    _, _, state = tg.guided_sample(pipe, tg.TorchDraws(5, "cpu"), stop_after=BOUNDARY,
                                   return_state=True)
    assert state.step == STEPS - 1 - BOUNDARY
    _, frames, state = tg.guided_sample(pipe, None, resume_state=state, stop_after=1,
                                        return_state=True)
    assert state.step == straight.step == STEPS - 1 - stop
    assert torch.equal(state.x, straight.x)
    assert torch.equal(state.eps_history, straight.eps_history)
    assert state.history_count == straight.history_count == (stop if mode == "plms" else 0)
    assert torch.equal(frames[3], straight_frames[3])  # position 5, after the resume


# ---------------- the UNet's remat ----------------

def test_remat_equals_no_remat():
    """The tiny UNet (attention at ds 2) under remat gives the output and
    input gradient it gives without, bit for bit, on the same weights."""
    torch.manual_seed(0)
    base = tunet.UNetConfig.tiny(32)
    weights = tunet.UNetModel(base).state_dict()
    x0 = torch.randn(2, 32, 32, 3)
    t = torch.tensor([500.0, 20.0])
    runs = []
    for remat in (False, True):
        model = tunet.UNetModel(dataclasses.replace(base, remat=remat))
        model.load_state_dict(weights)
        x = x0.clone().requires_grad_(True)
        out = model(x, t)
        (grad,) = torch.autograd.grad((out ** 2).sum(), x)
        runs.append((out.detach(), grad))
    (want_out, want_grad), (out, grad) = runs
    assert float(want_grad.abs().max()) > 0
    assert torch.equal(out, want_out) and torch.equal(grad, want_grad)


@pytest.mark.parametrize("policy", ["dots", "offload"])
def test_unet_config_refuses_remat_policy(policy):
    with pytest.raises(ValueError, match=f"unknown remat_policy '{policy}'"):
        tunet.UNetConfig(remat_policy=policy)
