"""The program's spans laid over the device trace: where the device's idle
time falls, by the layer the host was in.

The program records spans (`clip_diffusion_tpu_torch.utils.profiling.
annotate`) while a profile collects, as the benchmark's traced window
does, on the clock of the profiler's events (Unix-epoch ns), so a span
and a device operation can be compared directly.  `attribute` gives each
nanosecond of the window's idle time to the innermost span then open on
the thread that opened the window's root spans; a gap that crosses span
boundaries is split between the spans.  The idle time is the gaps
between the union of device operations, and the time before the first
operation and after the last in which one of those root spans was open
(the host writing the last PNG of a request, say), no longer in all than
the window.  What no program span covers is kept apart (`outside`).

A program without the recorder gives no spans: every reader then returns
None and the result line leaves its metric out.

    python3 -m port_bench.spans --workload <name> --seed <n> --seconds <s>

runs a cell with `--trace 1` and prints the whole attribution: idle by
span name, outside every span, and the sums against the trace's idle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Idle:
    by_name: Dict[str, int]  # idle ns whose innermost open span had that name
    outside: int  # idle ns under no program span
    total: int  # idle ns in all (see the module docstring)
    counts: Dict[str, int]  # spans of each name in the interval, every thread


def idle_gaps(ops: Sequence) -> List[Tuple[int, int]]:
    """(start, end) ns of each gap between the union of `ops` (by start)."""
    gaps, last_end = [], None
    for op in ops:
        if last_end is not None and op.start > last_end:
            gaps.append((last_end, op.start))
        last_end = op.end if last_end is None else max(last_end, op.end)
    return gaps


def root_thread(spans: Sequence, lo: int, hi: int) -> Optional[int]:
    """The thread whose root spans cover most of [lo, hi]."""
    cover: Dict[int, int] = {}
    for s in spans:
        if s.parent is None:
            cover[s.thread] = cover.get(s.thread, 0) + min(s.end_ns, hi) - max(s.start_ns, lo)
    return max(cover, key=cover.get) if cover else None


def attribute(ops: Sequence, spans: Sequence, window_ns: Optional[int] = None) -> Idle:
    """The idle time of `ops` (device operations sorted by start) given to
    `spans` (the recorder's, any order), as the module docstring says;
    `window_ns` bounds the whole interval."""
    if not ops:
        return Idle({}, 0, 0, {})
    lo, hi = ops[0].start, max(op.end for op in ops)
    thread = root_thread([s for s in spans if s.start_ns < hi and s.end_ns > lo], lo, hi)
    roots = [s for s in spans if s.thread == thread and s.parent is None
             and s.start_ns < hi and s.end_ns > lo]
    first = min([lo] + [s.start_ns for s in roots])
    last = max([hi] + [s.end_ns for s in roots])
    if window_ns is not None:
        first = min(lo, max(first, hi - window_ns))
        last = max(hi, min(last, first + window_ns))
    inside = [s for s in spans if s.start_ns < last and s.end_ns > first]
    counts: Dict[str, int] = {}
    for s in inside:
        counts[s.name] = counts.get(s.name, 0) + 1
    gaps = ([(first, lo)] if first < lo else []) + idle_gaps(ops) + \
        ([(hi, last)] if last > hi else [])
    total = sum(e - s for s, e in gaps)
    # on one thread spans nest, and a span opened later has the larger id:
    # the innermost open span is the open one with the largest id; at one
    # instant spans close before others open, and an empty span holds nothing
    own = [s for s in inside if s.thread == thread and s.end_ns > s.start_ns]
    events = sorted([(s.start_ns, 1, s.id, s.name) for s in own]
                    + [(s.end_ns, 0, s.id, s.name) for s in own])
    by_name: Dict[str, int] = {}
    outside = 0
    open_spans: Dict[int, str] = {}
    g = 0

    def give(a: int, b: int) -> None:
        nonlocal g, outside
        if a >= b:
            return
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        got, j = 0, g
        while j < len(gaps) and gaps[j][0] < b:
            got += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
        if not got:
            return
        if open_spans:
            name = open_spans[max(open_spans)]
            by_name[name] = by_name.get(name, 0) + got
        else:
            outside += got

    t = first
    for when, kind, sid, name in events:
        if when > t:
            give(t, min(when, last))
            t = when
        if kind:
            open_spans[sid] = name
        else:
            open_spans.pop(sid, None)
    if t < last:
        give(t, last)
    return Idle(by_name, outside, total, counts)


def recorded_spans() -> Optional[list]:
    """The program's recorded spans, or None where the program has no
    recorder."""
    from clip_diffusion_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


_last: list = [None, None]  # (trace, Idle) of the last attribution


def idle_of(outcome) -> Optional[Idle]:
    """The attribution of `outcome`'s traced window, or None without a
    trace, operations or recorded spans."""
    t = outcome.trace
    if t is None or not t.ops:
        return None
    if _last[0] is not t:
        spans = recorded_spans()
        _last[:] = [t, attribute(t.ops, spans, int(t.window_s * 1e9)) if spans else None]
    return _last[1]


def idle_ms(outcome, name: str, per: float) -> Optional[float]:
    """Idle ms given to spans named `name`, over `per`; None where the
    window holds no such span or `per` is not positive."""
    idle = idle_of(outcome)
    if idle is None or not idle.counts.get(name) or per <= 0:
        return None
    return idle.by_name.get(name, 0) / 1e6 / per


def count(outcome, name: str) -> int:
    """Spans named `name` overlapping the traced window (0 without any)."""
    idle = idle_of(outcome)
    return 0 if idle is None else idle.counts.get(name, 0)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from port_bench import harness
    from port_bench.run import run_cell

    ap = argparse.ArgumentParser(description="A traced run of a cell and its idle by span.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    outcome = run_cell(cell, args.seed, args.seconds, True, device)
    line = harness.result_line(cell, outcome, device, True)
    idle = idle_of(outcome)
    t = outcome.trace
    out = {"workload": cell.name, "seed": args.seed, "correct": outcome.correct,
           "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
    if idle is not None:
        given = sum(idle.by_name.values()) + idle.outside
        out.update({
            "idle_ms_by_span": {k: v / 1e6 for k, v in sorted(idle.by_name.items())},
            "idle_ms_outside": idle.outside / 1e6, "idle_ms_total": idle.total / 1e6,
            "window_s": t.window_s, "busy_s": t.busy_s,
            "idle_ms_window": (t.window_s - t.busy_s) * 1e3,
            "given_over_total": given / idle.total if idle.total else None,
            "given_over_window_idle": given / 1e9 / (t.window_s - t.busy_s),
            "outside_share": idle.outside / idle.total if idle.total else None,
            "span_counts": dict(sorted(idle.counts.items())),
            "facts": outcome.facts})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
