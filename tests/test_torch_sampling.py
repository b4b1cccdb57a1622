"""The port's schedule and sampling math against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.config import Config as JConfig
from clip_diffusion_tpu.diffusion import sampling as js
from clip_diffusion_tpu.diffusion import schedule as jsched
from clip_diffusion_tpu_torch.config import Config as TConfig
from clip_diffusion_tpu_torch.diffusion import sampling as ts
from clip_diffusion_tpu_torch.diffusion import schedule as tsched


@pytest.mark.parametrize("steps", [5, 50, 250, 1000])
def test_schedule_tables_equal(steps):
    """float64 tables, same numpy code: bitwise equal."""
    a, b = jsched.make_schedule(steps), tsched.make_schedule(steps)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_config_defaults_and_canvas_rounding():
    for kw in ({}, {"width": 700, "height": 130}, {"width": 10, "height": 512}):
        j, t = JConfig(**kw), TConfig(**kw)
        assert (j.width, j.height) == (t.width, t.height)
    j, t = JConfig(), TConfig()
    for f in dataclasses.fields(j):
        if f.name != "cutout_schedules":
            assert getattr(j, f.name) == getattr(t, f.name), f.name
    for a, b in zip(j.cutout_schedules.as_arrays(), t.cutout_schedules.as_arrays()):
        np.testing.assert_array_equal(a, b)


def _tables(steps=20):
    sched = tsched.make_schedule(steps)
    return (js.schedule_tables(sched), ts.schedule_tables(sched))


def test_step_math_matches():
    """float32 elementwise algebra on the same inputs: rtol 1e-6."""
    torch.set_num_threads(1)
    jt, tt = _tables()
    rng = np.random.default_rng(0)
    x, eps, grad, noise = (rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(4))
    J = jnp.asarray
    T = torch.from_numpy
    for step in (0, 7, 19):
        pairs = [
            (js.predict_xstart_from_eps(J(x), J(eps), jt, step),
             ts.predict_xstart_from_eps(T(x), T(eps), tt, step)),
            (js.predict_eps_from_xstart(J(x), J(eps), jt, step),
             ts.predict_eps_from_xstart(T(x), T(eps), tt, step)),
            (js.condition_eps(J(eps), J(grad), jt, step),
             ts.condition_eps(T(eps), T(grad), tt, step)),
            (js.q_sample(J(x), jt, step, J(noise)), ts.q_sample(T(x), tt, step, T(noise))),
            (js.ddim_step(J(x), J(eps), J(grad), jt, jnp.int32(step), 0.8, J(noise)),
             ts.ddim_step(T(x), T(eps), T(grad), tt, step, 0.8, T(noise))),
            (js.learned_log_variance(J(eps), jt, step),
             ts.learned_log_variance(T(eps), tt, step)),
        ]
        for a, b in pairs:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_ddim_golden_trajectory():
    """The JAX package's closed-form DDIM golden: an oracle eps model
    (eps = (x - sqrt(acp) x0) / sqrt(1 - acp)) with eta=0 lands on x0."""
    torch.set_num_threads(1)
    sched = tsched.make_schedule(50)
    tables = ts.schedule_tables(sched, dtype=torch.float64)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 4, 3)))
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 4, 3)))
    for step in range(49, -1, -1):
        acp = tables["alphas_cumprod"][step]
        eps = (x - torch.sqrt(acp) * x0) / torch.sqrt(1 - acp)
        pred = ts.predict_xstart_from_eps(x, eps, tables, step)
        x = ts.ddim_step(x, eps, pred, tables, step, 0.0, torch.zeros_like(x))
    np.testing.assert_allclose(x.numpy(), x0.numpy(), atol=1e-8)


def test_plms_helpers_match():
    torch.set_num_threads(1)
    jt, tt = _tables()
    rng = np.random.default_rng(2)
    eps = rng.normal(0, 1, (1, 4, 4, 3)).astype(np.float32)
    hist = rng.normal(0, 1, (3, 1, 4, 4, 3)).astype(np.float32)
    for count in range(4):
        for order in (1, 2, 4):
            a = js.plms_eps(jnp.asarray(eps), jnp.asarray(hist), jnp.int32(count), order)
            b = ts.plms_eps(torch.from_numpy(eps), torch.from_numpy(hist), count, order)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    a = js.plms_step(jnp.asarray(eps), jnp.asarray(hist[0]), jt, 5)
    b = ts.plms_step(torch.from_numpy(eps), torch.from_numpy(hist[0]), tt, 5)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    a = js.push_history(jnp.asarray(eps), jnp.asarray(hist))
    b = ts.push_history(torch.from_numpy(eps), torch.from_numpy(hist))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_dynamic_threshold_sort_matches():
    """Exact quantile with linear interpolation on both sides; jnp.quantile
    interpolates in float64 under the tests' x64 mode, torch.quantile in
    float32: rtol 1e-5."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 16, 16, 3)).astype(np.float32)
    for pct in (0.9, 0.995):
        a = np.asarray(js.dynamic_threshold(jnp.asarray(x), pct))
        b = ts.dynamic_threshold(torch.from_numpy(x), pct).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
