"""The port's dispatch layer against the JAX package, on the CPU: the
phase segments, the phase-segmented guided trajectory (JAX draws replayed
through the caps-sized cutout layout), the ensemble's slot caps and the UNet's remat policies
(tests/test_torch_dispatch_chunks.py holds the runner's chunks against
the port itself: segmented = padded under keyed draws, chunk times,
resume, the deadline, and the chunked latent loop).  The tiny pipeline's cutout schedule has two phases (overview
4 then 1, inner 1 then 3), as tests/test_segmented.py's."""

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
    jpipe = dataclasses.replace(
        jpipe, config=jtiny_config(cutout_schedules=_jax_phases()),
        sampler=JSamplerConfig(mode="ddim", steps=STEPS, eta=0.8, phase_segmented=True))
    return jpipe, jparams, models


def _port_pipe(models, segmented=True):
    """The port's pipeline on `models` with the two-phase schedule."""
    cfg = dataclasses.replace(tiny_port_config(), cutout_schedules=_port_phases())
    sampler = SamplerConfig(steps=STEPS, eta=0.8, phase_segmented=segmented)
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


def test_segmented_trajectory_matches_jax(phase_pipelines):
    """The whole 10-step segmented trajectory, both phases and the hand-over
    between them, against JAX guided_sample with phase_segmented=True, the
    JAX draws replayed from each step's caps-sized slot layout: the
    histogram threshold's trajectory tolerance, 2e-4 (test_torch_guided.
    test_five_step_trajectory_matches), and the same dispatch chunks."""
    jpipe, jparams, models = phase_pipelines
    key = jax.random.PRNGKey(3)
    jtimes, ttimes = [], []
    jfinal, jframes = jg.guided_sample(jpipe, jparams, key, chunk_times=jtimes)
    tfinal, tframes = tg.guided_sample(_port_pipe(models), JaxReplayDraws(key),
                                       chunk_times=ttimes)
    assert ([(c, n) for c, n, _ in ttimes] == [(c, n) for c, n, _ in jtimes]
            == [((4, 1), 5), ((1, 3), 5)])
    assert tframes.shape == np.asarray(jframes).shape == (6, 1, 64, 64, 3)
    assert np.isfinite(tframes.numpy()).all()
    assert tframes.abs().amin(dim=(1, 2, 3, 4)).lt(1).all()
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=2e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=2e-4)


def test_slot_caps_must_hold_the_scheduled_cuts(phase_pipelines):
    _, _, models = phase_pipelines
    pipe = _port_pipe(models)
    tables = schedule_tables(pipe.schedule)
    x = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match=r"schedules \(4, 1\) cutouts"):
        tg.guided_step(pipe, tables, x, 9, tg.TorchDraws(0, "cpu"), slot_caps=(1, 3))


def test_ensemble_slot_caps_at_world_size_1(phase_pipelines):
    """The ensemble's step with slot caps, in this process (world size 1),
    equals guided_step with the same caps bit for bit, the JAX draws
    replayed.  Those depend on the caps where the overview cap is below the
    schedule's maximum (the inner slots' keys follow the overview slots):
    at step 2, caps (1, 3), the padded layout's draws give another step."""
    _, _, models = phase_pipelines
    pipe = _port_pipe(models)
    tables = schedule_tables(pipe.schedule)
    draws = JaxReplayDraws(jax.random.PRNGKey(6))
    x = draws.initial_noise((1, 64, 64, 3))
    step_fn = tens.build_ensemble_guided_step(pipe, slot_caps=(1, 3))
    got = step_fn(tables, x, 2, draws)
    want = tg.guided_step(pipe, tables, x, 2, draws, slot_caps=(1, 3))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    padded = tg.guided_step(pipe, tables, x, 2, draws)
    assert float((got[0] - padded[0]).abs().max()) > 1e-4


# ---------------- the UNet's remat policies ----------------

@pytest.fixture(scope="module")
def remat_runs():
    """Output and input gradient of the tiny UNet (attention at ds 2) under
    each remat setting, on the same weights and inputs."""
    torch.manual_seed(0)
    base = tunet.UNetConfig.tiny(32)
    weights = tunet.UNetModel(base).state_dict()
    x0 = torch.randn(2, 32, 32, 3)
    t = torch.tensor([500.0, 20.0])
    runs = {}
    for label, kw in (("off", dict(remat=False)), ("full", dict(remat=True)),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        model = tunet.UNetModel(dataclasses.replace(base, **kw))
        model.load_state_dict(weights)
        x = x0.clone().requires_grad_(True)
        out = model(x, t)
        (grad,) = torch.autograd.grad((out ** 2).sum(), x)
        runs[label] = (out.detach(), grad)
    return runs


@pytest.mark.parametrize("label", ["full", "dots"])
def test_remat_policies_equal_no_remat(remat_runs, label):
    out, grad = remat_runs[label]
    want_out, want_grad = remat_runs["off"]
    assert float(want_grad.abs().max()) > 0
    assert torch.equal(out, want_out) and torch.equal(grad, want_grad)


def test_dots_policy_saves_matmuls_and_convolutions(monkeypatch):
    """Under "dots" the policy keeps mm/addmm/convolution outputs and
    recomputes the attention's bmm; an unknown policy raises."""
    seen = {}
    policy = tunet._dots_policy

    def spy(ctx, op, *args, **kwargs):
        seen[op] = decision = policy(ctx, op, *args, **kwargs)
        return decision

    monkeypatch.setattr(tunet, "_dots_policy", spy)
    model = tunet.UNetModel(dataclasses.replace(tunet.UNetConfig.tiny(32), remat=True,
                                                remat_policy="dots"))
    x = torch.randn(1, 32, 32, 3, requires_grad=True)
    torch.autograd.grad(model(x, torch.tensor([10.0])).sum(), x)
    aten = torch.ops.aten
    saved = {op for op, d in seen.items() if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert aten.convolution.default in saved
    assert saved & {aten.mm.default, aten.addmm.default}
    assert aten.bmm.default in seen and aten.bmm.default not in saved
    with pytest.raises(ValueError, match="unknown remat_policy 'offload'"):
        tunet.UNetConfig(remat_policy="offload")
