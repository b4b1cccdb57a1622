"""`latent_unet_replays_per_step` on synthetic traces and spans: the LDM
UNet's `ldm.unet.replay` spans over the `latent.step` spans of the traced
latent request."""

from __future__ import annotations

import pytest

from port_bench import harness, spans
from port_bench.metrics import latent_unet_replays_per_step
from port_bench.trace import Op, Trace
from clip_diffusion_tpu_torch.utils.profiling import Span

METRIC = "latent_unet_replays_per_step"


def span(name, start, end, sid, parent=None, request=None):
    return Span(name, start, end, sid, parent, sid if request is None else request, 1)


def ops(*intervals):
    return [Op(f"k{i}", s, e) for i, (s, e) in enumerate(intervals)]


def _outcome(trace, facts=None):
    return harness.Outcome(attempted=1, failed=0, values={}, checks=[],
                           memory_peak_bytes=0, trace=trace, facts=facts or {})


@pytest.mark.parametrize("replayed", [True, False])
def test_one_replay_a_step_reads_one_and_none_reads_zero(replayed, monkeypatch):
    """1.0 with one `ldm.unet.replay` span inside each `latent.step`, 0
    where the UNet runs eagerly (no such span)."""
    trace = Trace(ops((0, 10), (30, 40), (60, 70), (90, 100)), window_s=1.0)
    recorded, sid = [span("latent.request", 0, 100, 1)], 1
    for k in range(3):
        sid += 1
        recorded.append(span("latent.step", 10 + 30 * k, 30 + 30 * k, sid, 1, 1))
        if replayed:
            sid += 1
            recorded.append(span("ldm.unet.replay", 12 + 30 * k, 14 + 30 * k, sid, sid - 1, 1))
    monkeypatch.setattr(spans, "recorded_spans", lambda: recorded)
    got = harness.read_metric(METRIC, _outcome(trace))
    assert got == (1.0 if replayed else 0.0)


def test_reads_nothing_without_a_trace_a_recorder_or_a_step(monkeypatch):
    """None without a trace (the CPU), where the program records no spans,
    and where no `latent.step` was traced (a guided cell)."""
    facts = {"steps_traced": 10}
    trace = Trace(ops((0, 10), (20, 30)), 1.0)
    assert latent_unet_replays_per_step.read(_outcome(None, facts)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: None)
    assert latent_unet_replays_per_step.read(_outcome(trace, facts)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: [])
    assert latent_unet_replays_per_step.read(_outcome(trace, facts)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: [span("guided.step", 0, 30, 1)])
    assert latent_unet_replays_per_step.read(_outcome(trace, facts)) is None
