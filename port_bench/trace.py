"""The benchmark's device trace: torch.profiler's CUDA activity, read
without building the profiler's Python event tree.

`DeviceTrace` records every kernel, copy and set on the device over a
window whose length the host clock gives (synchronised at both ends).
`Ranges` marks spans of the program from the benchmark's own hooks: each
`open`/`close` launches the one-block `spin_kernel` of
`torch.cuda._sleep`, which the program never launches, so the i-th such
kernel in the trace is the i-th mark, in stream order.  Markers are left
out of every device time.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"


@dataclass
class Op:
    name: str
    start: int  # ns
    end: int  # ns


@dataclass
class Trace:
    ops: List[Op]  # device operations without markers, by start
    window_s: float
    marks: List[Tuple[str, int]] = field(default_factory=list)  # (label, ns) per mark

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union)."""
        busy, cur_s, cur_e = 0, None, None
        for op in self.ops:
            if cur_e is None or op.start > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = op.start, op.end
            else:
                cur_e = max(cur_e, op.end)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def kernel_s(self, match: Optional[str] = None) -> float:
        """Summed device seconds of the operations whose name holds `match`."""
        return sum(op.end - op.start for op in self.ops
                   if match is None or match in op.name) / 1e9

    def count(self, match: str) -> int:
        return sum(1 for op in self.ops if match in op.name)

    def spans(self, label: str) -> List[Tuple[int, int]]:
        """(start, end) ns of each closed range named `label`."""
        out, open_at = [], {}
        for name, t in self.marks:
            kind, lab = name.split(":", 1)
            if lab != label:
                continue
            if kind == "open":
                open_at.setdefault(lab, []).append(t)
            elif open_at.get(lab):
                out.append((open_at[lab].pop(), t))
        return out

    def kernel_s_in(self, label: str) -> float:
        """Device seconds of operations that start inside a `label` range."""
        spans = self.spans(label)
        starts = [op.start for op in self.ops]
        total = 0
        for s, e in spans:
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)
            total += sum(self.ops[i].end - self.ops[i].start for i in range(lo, hi))
        return total / 1e9

    def label_at(self, t: int) -> str:
        """The innermost range open at device time `t`."""
        stack: List[str] = []
        for name, mt in self.marks:
            if mt > t:
                break
            kind, lab = name.split(":", 1)
            if kind == "open":
                stack.append(lab)
            elif lab in stack:
                stack.remove(lab)
        return stack[-1] if stack else "outside"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The `n` device operations with most time, by name, and the `n`
        longest idle gaps, named by the range open when each began."""
        by_name: Dict[str, int] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0) + op.end - op.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps, last_end = [], None
        for op in self.ops:
            if last_end is not None and op.start > last_end:
                gaps.append((op.start - last_end, last_end))
            last_end = op.end if last_end is None else max(last_end, op.end)
        gaps = sorted(gaps, reverse=True)[:n]
        return {"device_ops": [[name[:120], ns / 1e9] for name, ns in top],
                "idle_gaps": [[self.label_at(t), ns / 1e9] for ns, t in gaps]}


class Ranges:
    """Host-side labels of marker kernels, in launch order."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.labels: List[str] = []

    def mark(self, label: str) -> None:
        if self.on:
            torch.cuda._sleep(1)
            self.labels.append(label)

    def open(self, name: str) -> None:
        self.mark(f"open:{name}")

    def close(self, name: str) -> None:
        self.mark(f"close:{name}")

    def hook(self, module: torch.nn.Module, name: str) -> list:
        """Forward pre/post hooks that bracket every call of `module`."""
        return [module.register_forward_pre_hook(lambda *_: self.open(name)),
                module.register_forward_hook(lambda *_: self.close(name))]

    def wrap(self, fn, name: str):
        def wrapped(*args, **kwargs):
            self.open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.close(name)
        return wrapped


class DeviceTrace:
    """Context manager: the device's operations over the block, and its
    host-clock length.  On a CPU device it records nothing (`trace` None)."""

    def __init__(self, device: torch.device, ranges: Optional[Ranges] = None):
        self.device, self.ranges = device, ranges
        self.trace: Optional[Trace] = None

    def warm_up(self) -> None:
        """A profile of one small operation, so that the profiler's own
        start-up (CUPTI's) falls in set-up and not in a traced window."""
        if self.device.type != "cuda":
            return
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.device.type != "cuda":
            return self
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        self._first_mark = len(self.ranges.labels) if self.ranges else 0
        return self

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            return False
        torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        ops, marks = [], []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = ev.name()
            if MARKER in name:
                marks.append(ev.start_ns())
            else:
                ops.append(Op(name, ev.start_ns(), ev.end_ns()))
        ops.sort(key=lambda o: o.start)
        marks.sort()
        labels = self.ranges.labels[self._first_mark:] if self.ranges else []
        self.trace = Trace(ops, window, list(zip(labels, marks)))
        return False
