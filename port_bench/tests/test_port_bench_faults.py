"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at tiny widths (the look
for a GPU is the only part skipped) with one fault planted in the
program: a step that returns its state unchanged, half of the batch left
out with the mean of the rest in its place, an answer altered where it is
produced.  The cells run on one chip, so there is no exchange between
chips to leave out.  The limits are the configurations' own."""

from __future__ import annotations

import pytest
import torch

import clip_diffusion_tpu_torch.pipeline.guided as pg
import clip_diffusion_tpu_torch.pipeline.latent as pl
import clip_diffusion_tpu_torch.sample as ps
from port_bench import run as bench_run
from port_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _half_rows(t):
    h = t.shape[0] // 2
    return torch.cat([t[:h], t[:h].mean(dim=0, keepdim=True).expand_as(t[h:])])


# ---- guided ------------------------------------------------------------------

def _guided_faults():
    real = pg.guided_step

    def stuck(pipe, tables, x, step, draws, *a, **k):
        _, pred = real(pipe, tables, x, step, draws, *a, **k)
        return x, pred

    def half_batch(pipe, tables, x, step, draws, *a, **k):
        h = x.shape[0] // 2
        x_next, pred = real(pipe, tables, x[:h], step, draws.rows(0, h), *a, **k)
        full = torch.cat([x_next, x_next]), torch.cat([pred, pred])
        return _half_rows(full[0]), _half_rows(full[1])

    def altered(pipe, tables, x, step, draws, *a, **k):
        x_next, pred = real(pipe, tables, x, step, draws, *a, **k)
        x_next = x_next.clone()
        x_next[0, 5, 7, 1] += 0.05
        return x_next, pred

    return {"stuck": stuck, "half_batch": half_batch, "altered": altered}


@pytest.mark.parametrize("fault", ["stuck", "half_batch", "altered"])
def test_guided_fault_is_not_correct(fault, monkeypatch):
    cell = tiny_cell("guided-default-b4")
    monkeypatch.setattr(pg, "guided_step", _guided_faults()[fault])
    outcome = bench_run.run_cell(cell, 2 ** 31 + 3, 0.1, False, CPU)
    assert not outcome.correct, outcome.checks


# ---- latent ------------------------------------------------------------------

def _latent_faults():
    real_sample, real_decode = ps.latent_sample, ps.decode_latents

    def stuck(pipe, draws, ctx_c, ctx_u=None, batch_size=1, height=256, width=256, steps=50,
              guidance_scale=5.0, eta=0.0, mode="ddim", **_):
        shape = (batch_size, height // pipe.downsample, width // pipe.downsample,
                 pipe.latent_channels)
        x = draws.initial_noise(shape).to(torch.float32)
        tables = pl.ldm_ddim_tables(steps, eta, x.device)
        with torch.inference_mode():
            for i in range(steps - 1, -1, -1):  # the UNet runs, the state stays
                pl._model_eps(pipe, x, float(tables["timesteps"][i]), ctx_c, ctx_u,
                              guidance_scale)
        return x

    def half_batch(pipe, draws, ctx_c, ctx_u=None, batch_size=1, **k):
        h = batch_size // 2
        z = real_sample(pipe, draws, ctx_c[:h], None if ctx_u is None else ctx_u[:h],
                        batch_size=h, **k)
        return _half_rows(torch.cat([z, z]))

    def altered(pipe, z):
        out = real_decode(pipe, z).clone()
        out[0, 3, 4, 0] = torch.clamp(out[0, 3, 4, 0] + 0.25, 0.0, 1.0)
        return out

    return {"stuck": ("latent_sample", stuck), "half_batch": ("latent_sample", half_batch),
            "altered": ("decode_latents", altered)}


@pytest.mark.parametrize("fault", ["stuck", "half_batch", "altered"])
def test_latent_fault_is_not_correct(fault, monkeypatch):
    cell = tiny_cell("latent-f8-txt2img")
    name, fn = _latent_faults()[fault]
    monkeypatch.setattr(ps, name, fn)
    outcome = bench_run.run_cell(cell, 2 ** 31 + 5, 0.1, False, CPU)
    assert not outcome.correct, outcome.checks
