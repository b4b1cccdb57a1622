"""`port_bench/spans.py`: the device's idle time given to the program's
spans, on synthetic traces and spans, and its readers; then, on the card
(`python -m pytest port_bench/tests/test_port_bench_spans.py -m cuda -s`),
that the recorder's spans and the profiler's device operations share one
clock."""

from __future__ import annotations

import importlib
import time

import pytest
import torch

from port_bench import harness, spans
from port_bench.trace import DeviceTrace, Op, Trace
from clip_diffusion_tpu_torch.utils import profiling
from clip_diffusion_tpu_torch.utils.profiling import Span

GUIDED = ["guided_idle_unet_ms_per_step", "guided_idle_cutouts_ms_per_step",
          "guided_idle_towers_ms_per_step", "guided_idle_backward_ms_per_step",
          "guided_idle_update_ms_per_step", "guided_idle_progress_ms_per_step",
          "guided_quantile_launches_per_step"]
LATENT = ["latent_idle_step_ms_per_step", "latent_idle_decode_ms_per_request",
          "latent_idle_png_ms_per_request", "latent_idle_upscale_ms_per_request"]


def span(name, start, end, sid, parent=None, request=None, thread=1):
    return Span(name, start, end, sid, parent, sid if request is None else request, thread)


def ops(*intervals):
    return [Op(f"k{i}", s, e) for i, (s, e) in enumerate(intervals)]


def test_a_gap_crossing_two_spans_is_split():
    # device busy [0, 10) and [50, 60): one gap [10, 50)
    got = spans.attribute(ops((0, 10), (50, 60)), [
        span("root", 0, 60, 1),
        span("a", 5, 30, 2, parent=1, request=1),
        span("b", 30, 55, 3, parent=1, request=1)])
    assert got.by_name == {"a": 20, "b": 20} and got.outside == 0 and got.total == 40


def test_the_innermost_span_wins_and_the_rest_is_the_roots_own():
    got = spans.attribute(ops((0, 10), (100, 110)), [
        span("root", 0, 110, 1),
        span("mid", 10, 80, 2, parent=1, request=1),
        span("leaf", 20, 40, 3, parent=2, request=1)])
    assert got.by_name == {"root": 20, "mid": 50, "leaf": 20}
    assert sum(got.by_name.values()) + got.outside == got.total == 90


def test_outside_the_window_and_other_threads_are_ignored():
    got = spans.attribute(ops((100, 110), (150, 160), (150, 200), (300, 310)), [
        span("before", 0, 90, 1),  # ends before the first operation
        span("root", 95, 305, 2),
        span("late", 320, 400, 3),  # starts after the last operation
        span("elsewhere", 110, 300, 4, thread=2),  # a shorter root on another thread
        span("step", 120, 140, 5, parent=2, request=2)])
    assert got.counts == {"root": 1, "elsewhere": 1, "step": 1}
    # the root opened 5 ns before the first operation: that idle is the root's
    assert got.by_name == {"root": 5 + 10 + 10 + 100, "step": 20} and got.outside == 0
    assert got.total == 145


def test_idle_before_the_first_and_after_the_last_operation_under_a_root():
    recorded = [span("root", 0, 100, 1), span("png", 60, 90, 2, parent=1, request=1)]
    got = spans.attribute(ops((10, 20), (30, 40)), recorded)
    assert got.by_name == {"root": 10 + 10 + 20 + 10, "png": 30} and got.total == 80
    # no longer than the window in all
    got = spans.attribute(ops((10, 20), (30, 40)), recorded, window_ns=50)
    assert got.total == 10 + 10 + 10 and got.by_name == {"root": 10 + 10 + 10}


def test_idle_under_no_span_is_kept_apart():
    got = spans.attribute(ops((0, 10), (40, 50), (90, 100)), [
        span("r", 20, 60, 1), span("r", 70, 80, 2)])
    assert got.by_name == {"r": 20 + 10 + 10} and got.outside == 10 + 10 + 10
    assert sum(got.by_name.values()) + got.outside == got.total == 70


def test_spans_meeting_at_one_instant():
    got = spans.attribute(ops((0, 10), (40, 50)), [
        span("root", 0, 50, 1),
        span("a", 10, 20, 2, parent=1, request=1),
        span("b", 20, 20, 3, parent=1, request=1),
        span("c", 20, 30, 4, parent=1, request=1)])
    assert got.by_name == {"a": 10, "c": 10, "root": 10}


def _outcome(trace, facts=None):
    return harness.Outcome(attempted=1, failed=0, values={}, checks=[],
                           memory_peak_bytes=0, trace=trace, facts=facts or {})


def _guided_spans(steps):
    out, sid = [], 1
    root = sid
    out.append(span("guided.sample", 0, steps * 100, root))
    for k in range(steps):
        base = k * 100
        sid += 1
        step = sid
        out.append(span("guided.step", base, base + 100, step, root, root))
        for name, a, b in (("guided.unet", 0, 10), ("guided.cutouts", 10, 20),
                           ("guided.tower", 20, 30), ("guided.tower", 30, 40),
                           ("guided.backward", 40, 50), ("guided.update", 50, 60),
                           ("ops.quantile", 55, 56), ("guided.progress", 60, 70)):
            sid += 1
            parent = sid - 1 if name == "ops.quantile" else step
            out.append(span(name, base + a, base + b, sid, parent, root))
    return out


def test_guided_readers(monkeypatch):
    """Each step's ops busy [0, 5) of every 10 ns: each span of 10 ns holds
    5 ns of idle, so the towers (two spans) 10 and the update 4 (its
    quantile span takes the idle of [55, 56))."""
    steps = 3
    busy = [(t, t + 5) for t in range(0, steps * 100, 10)] + [(steps * 100, steps * 100 + 1)]
    trace = Trace(ops(*busy), window_s=1.0)
    monkeypatch.setattr(spans, "recorded_spans", lambda: _guided_spans(steps))
    outcome = _outcome(trace, {"steps_traced": steps})
    got = {m: harness.read_metric(m, outcome) for m in GUIDED}
    assert got == pytest.approx({
        "guided_idle_unet_ms_per_step": 5e-6, "guided_idle_cutouts_ms_per_step": 5e-6,
        "guided_idle_towers_ms_per_step": 10e-6, "guided_idle_backward_ms_per_step": 5e-6,
        "guided_idle_update_ms_per_step": 4e-6, "guided_idle_progress_ms_per_step": 5e-6,
        "guided_quantile_launches_per_step": 1.0})
    idle = spans.idle_of(outcome)
    assert idle.by_name["guided.step"] == steps * 15 and idle.by_name["ops.quantile"] == steps
    assert sum(idle.by_name.values()) + idle.outside == idle.total == steps * 50


def test_latent_readers(monkeypatch):
    trace = Trace(ops((0, 10), (30, 40), (60, 70), (100, 110), (200, 210)), window_s=1.0)
    recorded = [span("latent.request", 0, 210, 1),
                span("latent.step", 10, 30, 2, 1, 1), span("latent.step", 40, 60, 3, 1, 1),
                span("latent.decode", 70, 100, 4, 1, 1), span("latent.png", 110, 150, 5, 1, 1),
                span("latent.upscale", 150, 190, 6, 1, 1), span("latent.png", 190, 200, 7, 1, 1)]
    monkeypatch.setattr(spans, "recorded_spans", lambda: recorded)
    outcome = _outcome(trace)
    got = {m: harness.read_metric(m, outcome) for m in LATENT}
    assert got == pytest.approx({
        "latent_idle_step_ms_per_step": 20e-6, "latent_idle_decode_ms_per_request": 30e-6,
        "latent_idle_png_ms_per_request": 50e-6, "latent_idle_upscale_ms_per_request": 40e-6})


@pytest.mark.parametrize("metric", GUIDED + LATENT)
def test_readers_read_nothing_without_a_trace_or_a_recorder(metric, monkeypatch):
    """None without a trace (the CPU), and None where the program records
    no spans, as a program without the recorder does."""
    reader = importlib.import_module(f"port_bench.metrics.{metric}")
    facts = {"steps_traced": 10}
    assert reader.read(_outcome(None, facts)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: None)
    assert reader.read(_outcome(Trace(ops((0, 10), (20, 30)), 1.0), facts)) is None
    monkeypatch.setattr(spans, "recorded_spans", lambda: [])
    assert reader.read(_outcome(Trace(ops((0, 10), (20, 30)), 1.0), facts)) is None


def test_the_recorder_is_read_from_the_program(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    assert spans.recorded_spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("x"):
            pass
    assert [s.name for s in spans.recorded_spans()] == ["x"]


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spans_share_the_device_trace_clock(cuda, monkeypatch):
    """In the benchmark's CUDA-only trace: a span that launches a long
    kernel and synchronises contains the kernel within 50 us; a 50 ms
    sleep inside a span between two kernels is idle given to that span
    within 0.5 ms; one `ops.quantile` span per launch of the kernel."""
    from clip_diffusion_tpu_torch.ops.quantile import dynamic_threshold_fast, histogram_abs_quantile

    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    a = torch.randn((8192, 8192), device=cuda)
    x = torch.randn((1, 1179648), device=cuda)
    dynamic_threshold_fast(x.reshape(1, 768, 512, 3), 0.95)  # builds the kernel
    torch.cuda.synchronize(cuda)
    tracer = DeviceTrace(cuda)
    tracer.warm_up()
    before = histogram_abs_quantile.launches
    with tracer:
        with profiling.annotate("probe.root"):
            for _ in range(3):
                with profiling.annotate("probe.kernel"):
                    a @ a
                    torch.cuda.synchronize(cuda)
            with profiling.annotate("probe.sleep"):
                time.sleep(0.05)
            a @ a
            for _ in range(4):
                dynamic_threshold_fast(x.reshape(1, 768, 512, 3), 0.95)
            torch.cuda.synchronize(cuda)
    launched = histogram_abs_quantile.launches - before
    t = tracer.trace
    recorded = profiling.spans()
    gemms = sorted((op for op in t.ops if op.end - op.start > 1_000_000), key=lambda o: o.start)
    kernel_spans = [s for s in recorded if s.name == "probe.kernel"]
    assert len(gemms) == 4 and len(kernel_spans) == 3
    for s, op in zip(kernel_spans, gemms):
        lead, lag = (op.start - s.start_ns) / 1e3, (s.end_ns - op.end) / 1e3
        print(f"kernel {(op.end - op.start) / 1e3:.1f} us: starts {lead:.1f} us after its "
              f"span opens, ends {lag:.1f} us before it closes")
        assert lead >= -50 and lag >= -50
    idle = spans.attribute(t.ops, recorded)
    (sleep,) = [s for s in recorded if s.name == "probe.sleep"]
    given = idle.by_name["probe.sleep"]
    print(f"sleep span {(sleep.end_ns - sleep.start_ns) / 1e6:.4f} ms, idle given to it "
          f"{given / 1e6:.4f} ms; idle {idle.total / 1e6:.4f} ms, outside {idle.outside / 1e6:.4f}")
    assert abs(given - (sleep.end_ns - sleep.start_ns)) <= 500_000 and given >= 50_000_000
    assert sum(idle.by_name.values()) + idle.outside == idle.total
    quantile_spans = [s for s in recorded if s.name == "ops.quantile"]
    assert len(quantile_spans) == launched == 4
    assert t.count("histogram_abs_quantile_kernel") == 4
