"""`guided_tower_replays_per_step` on synthetic traces and spans: the CLIP
towers' `guided.tower.replay` spans over the traced guided steps."""

from __future__ import annotations

import pytest

from port_bench import harness, spans
from port_bench.metrics import guided_tower_replays_per_step
from port_bench.trace import Op, Trace
from clip_diffusion_tpu_torch.utils.profiling import Span

METRIC = "guided_tower_replays_per_step"


def span(name, start, end, sid, parent=None):
    return Span(name, start, end, sid, parent, 1, 1)


def _outcome(trace, steps):
    return harness.Outcome(attempted=1, failed=0, values={}, checks=[], memory_peak_bytes=0,
                           trace=trace, facts={"steps_traced": steps})


def _recorded(steps: int, towers: int, chunks: int, replayed: bool):
    """A `guided.sample` root holding `steps` steps, each with `towers`
    `guided.tower` spans of `chunks` chunks, each chunk a replay span when
    `replayed`."""
    recorded, sid = [span("guided.sample", 0, 1000 * steps, 1)], 1
    for k in range(steps):
        sid += 1
        step = sid
        recorded.append(span("guided.step", 1000 * k, 1000 * k + 900, step, 1))
        for t in range(towers):
            sid += 1
            tower, t0 = sid, 1000 * k + 100 * t
            recorded.append(span("guided.tower", t0, t0 + 90, tower, step))
            for c in range(chunks if replayed else 0):
                sid += 1
                recorded.append(span("guided.tower.replay", t0 + 10 * c, t0 + 10 * c + 5, sid,
                                     tower))
    return recorded


@pytest.mark.parametrize("replayed", [True, False])
def test_reads_the_replays_a_step_and_zero_when_eager(replayed, monkeypatch):
    """12.0 where 4 towers replay 3 chunks a step (the default request's
    cycle), 0 where the towers run eagerly (no replay span)."""
    steps = 10
    trace = Trace([Op(f"k{k}", 1000 * k, 1000 * k + 950) for k in range(steps)], window_s=1.0)
    monkeypatch.setattr(spans, "recorded_spans", lambda: _recorded(steps, 4, 3, replayed))
    assert harness.read_metric(METRIC, _outcome(trace, steps)) == (12.0 if replayed else 0.0)


def test_reads_nothing_without_a_trace_a_recorder_or_a_step(monkeypatch):
    """None without a trace (the CPU), where the program records no spans,
    without traced steps, and where no `guided.step` was traced (a latent
    cell)."""
    trace = Trace([Op("k0", 0, 10), Op("k1", 20, 30)], 1.0)
    read = guided_tower_replays_per_step.read
    assert read(_outcome(None, 10)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: None)
    assert read(_outcome(trace, 10)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: [])
    assert read(_outcome(trace, 10)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: _recorded(1, 4, 3, True))
    assert read(_outcome(trace, 0)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: [span("latent.step", 0, 30, 1)])
    assert read(_outcome(trace, 10)) is None
