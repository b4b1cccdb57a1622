"""The port's dispatch chunks against the port itself, on the CPU: the
phase-segmented guided runner (tests/test_torch_dispatch.py's two-phase
tiny pipeline) equal to the padded loop bit for bit under keyed draws,
its chunk times, resume across a phase boundary and the deadline; and the
chunked latent loop (`latent_sample(max_steps_per_dispatch=,
chunk_times=)`), every chunking equal to one dispatch bit for bit and two
chunks matching the JAX package's chunked run with its draws replayed."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.pipeline import latent as jlat
from clip_diffusion_tpu_torch.models.ldm.unet import LDMUNet, LDMUNetConfig
from clip_diffusion_tpu_torch.pipeline import guided as tg
from clip_diffusion_tpu_torch.pipeline import latent as tlat
from test_torch_dispatch import STEPS, _port_pipe, phase_pipelines  # noqa: F401 (fixture)
from test_torch_latent import JaxLatentDraws, tiny_unet  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


# the port against itself: the first 6 of the 10 steps, 1 into the second phase
STOP = 6


@pytest.fixture(scope="module")
def torch_runs(phase_pipelines):
    """The segmented (chunks of 3, chunk times kept) and the padded DDIM
    trajectories' first STOP steps under the same TorchDraws: {segmented:
    (SamplingState, frames, progress calls, chunk times)}."""
    torch.set_num_threads(1)
    _, _, models = phase_pipelines
    runs = {}
    for segmented in (True, False):
        seen, times = [], []
        _, frames, state = tg.guided_sample(
            _port_pipe(models, segmented), tg.TorchDraws(5, "cpu"), max_steps_per_dispatch=3,
            progress_every=3, chunk_times=times, stop_after=STOP, return_state=True,
            progress_callback=lambda pos, pred, seen=seen: seen.append((pos, pred.clone())))
        runs[segmented] = (state, frames, seen, times)
    return runs


def test_segmented_equals_padded_under_torch_draws(torch_runs):
    """Keyed draws do not depend on the caps: the segmented and the padded
    trajectories are equal bit for bit across the phase boundary, frames
    and progress calls included."""
    (s_seg, fr_seg, p_seg, _), (s_pad, fr_pad, p_pad, _) = torch_runs[True], torch_runs[False]
    assert torch.equal(s_seg.x, s_pad.x) and torch.equal(fr_seg, fr_pad)
    assert [p for p, _ in p_seg] == [p for p, _ in p_pad] == [0, 3]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(p_seg, p_pad))


def test_chunk_times(phase_pipelines, torch_runs):
    """(caps, steps, seconds) per chunk: the phases' caps in order, at most
    max_steps_per_dispatch steps each, 10 in all; ignored when the sampler
    is not segmented."""
    times = torch_runs[True][3]
    segments = tg.compute_phase_segments(_port_pipe(phase_pipelines[2]), STEPS)
    want = [(caps, min(3, len(steps) - lo)) for steps, caps in segments
            for lo in range(0, len(steps), 3)]
    assert want == [((4, 1), 3), ((4, 1), 2), ((1, 3), 3), ((1, 3), 2)]
    assert [(caps, n) for caps, n, _ in times] == [((4, 1), 3), ((4, 1), 2), ((1, 3), 1)]
    assert all(isinstance(s, float) and s >= 0 for _, _, s in times)
    assert torch_runs[False][3] == []


def test_resume_across_a_phase_boundary(phase_pipelines, torch_runs):
    """Segmented, chunks of 3, run as 5 + 1 steps through a SamplingState
    (the phase boundary lies at position 5) equals the straight run bit for
    bit."""
    pipe = _port_pipe(phase_pipelines[2])
    assert [len(s) for s, _ in tg.compute_phase_segments(pipe, STEPS)] == [5, 5]
    state, done = None, 0
    for n in (5, STOP - 5):
        times = []
        _, frames, state = tg.guided_sample(
            pipe, tg.TorchDraws(5, "cpu") if state is None else None, max_steps_per_dispatch=3,
            resume_state=state, stop_after=n, return_state=True, chunk_times=times)
        done += n
        assert state.step == STEPS - 1 - done and sum(k for _, k, _ in times) == n
    straight_state, straight_frames = torch_runs[True][:2]
    assert torch.equal(state.x, straight_state.x) and state.step == straight_state.step
    assert torch.equal(frames[3], straight_frames[3])  # position 5, after the resume


def test_deadline(phase_pipelines, monkeypatch):
    """A deadline already past raises before the first chunk (no step, no
    chunk time); one that passes after the first chunk keeps that chunk's
    time; a deadline without phase_segmented raises ValueError."""
    _, _, models = phase_pipelines
    pipe = _port_pipe(models)
    calls = []
    step = tg.guided_step
    monkeypatch.setattr(tg, "guided_step", lambda *a, **k: calls.append(a[3]) or step(*a, **k))
    times = []
    with pytest.raises(tg.DeadlineExceeded, match=r"caps=\(4, 1\)"):
        tg.guided_sample(pipe, tg.TorchDraws(5, "cpu"), chunk_times=times, deadline=0.0)
    assert times == [] and calls == []

    clock = itertools.chain([100.0], itertools.repeat(200.0))
    monkeypatch.setattr(tg.time, "time", lambda: next(clock))
    with pytest.raises(tg.DeadlineExceeded, match=r"caps=\(4, 1\)"):
        tg.guided_sample(pipe, tg.TorchDraws(5, "cpu"), max_steps_per_dispatch=2,
                         chunk_times=times, deadline=150.0)
    assert [(caps, n) for caps, n, _ in times] == [((4, 1), 2)]
    assert calls == [9, 8]

    with pytest.raises(ValueError, match="deadline requires phase_segmented"):
        tg.guided_sample(_port_pipe(models, False), tg.TorchDraws(5, "cpu"), deadline=1e12)



# ---------------- the chunked latent loop ----------------

def _latent_case(case):
    rng = np.random.default_rng(9)
    ctx_c = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    ctx_u = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    kw = dict(batch_size=2, height=8, width=8, guidance_scale=5.0)
    extra = {}
    if case == "plms inpainting":
        extra = dict(x0_latent=rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32),
                     mask=np.zeros((2, 8, 8, 1), np.float32))
        extra["mask"][:, :4] = 1.0
        kw.update(steps=7, mode="plms")
    else:
        kw.update(steps=7, eta=0.5)
    return ctx_c, ctx_u, kw, extra


@pytest.mark.parametrize("case", ["ddim eta 0.5", "plms inpainting"])
def test_latent_chunks_equal_one_dispatch(case):
    """max_steps_per_dispatch 1, 3 and None give the same latents bit for
    bit (PLMS carries its history across chunks); chunk_times holds the
    chunks' step counts."""
    torch.manual_seed(0)
    pipe = tlat.LatentPipeline(unet=LDMUNet(LDMUNetConfig.tiny()).requires_grad_(False),
                               downsample=1)
    ctx_c, ctx_u, kw, extra = _latent_case(case)
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    runs, times = {}, {}
    for chunk in (None, 1, 3):
        times[chunk] = []
        runs[chunk] = tlat.latent_sample(pipe, tg.TorchDraws(4, "cpu"), torch.from_numpy(ctx_c),
                                         torch.from_numpy(ctx_u), **kw, **extra,
                                         max_steps_per_dispatch=chunk, chunk_times=times[chunk])
    assert torch.isfinite(runs[None]).all()
    assert torch.equal(runs[1], runs[None]) and torch.equal(runs[3], runs[None])
    assert times[None] == []
    assert [n for n, _ in times[1]] == [1] * 7
    assert [n for n, _ in times[3]] == [3, 3, 1]


def test_latent_chunks_match_jax(tiny_unet):  # noqa: F811 (the imported fixture)
    """Two chunks of 3 steps against JAX latent_sample(max_steps_per_dispatch
    =3), the JAX draws replayed: CFG DDIM at eta 0.5, atol 1e-4 (the one-dispatch
    trajectory's tolerance in test_torch_latent)."""
    jm, params, tm = tiny_unet
    ctx_c, ctx_u, kw, _ = _latent_case("ddim eta 0.5")
    kw["steps"] = 6  # two chunks of 3: one JAX program
    key = jax.random.PRNGKey(4)
    jpipe = jlat.LatentPipeline(unet_apply=lambda p, x, t, c: jm.apply(p, x, t, c), downsample=1)
    jtimes, ttimes = [], []
    ref = np.asarray(jlat.latent_sample(jpipe, {"unet": params}, key, jnp.asarray(ctx_c),
                                        jnp.asarray(ctx_u), **kw, max_steps_per_dispatch=3,
                                        chunk_times=jtimes))
    got = tlat.latent_sample(tlat.LatentPipeline(unet=tm, downsample=1), JaxLatentDraws(key),
                             torch.from_numpy(ctx_c), torch.from_numpy(ctx_u), **kw,
                             max_steps_per_dispatch=3, chunk_times=ttimes).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert [n for n, _ in ttimes] == [n for n, _ in jtimes] == [3, 3]
