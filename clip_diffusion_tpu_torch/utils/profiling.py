"""Profiling and tracing hooks: the program's one tracer.

Counterpart of `clip_diffusion_tpu.utils.profiling`.  Usage:

    with trace("build/trace"):          # a Chrome trace (chrome://tracing,
        final, frames = guided_sample(...)   # Perfetto) under that dir

    with annotate("guided.step"):       # a span, and a named region in the trace
        ...

Tracing is on exactly while a `torch.profiler` profile is collecting
(`trace` above, or any other profile in the process): then `annotate`
records a `Span` in a bounded in-memory buffer and also enters
`record_function(name)`, so the Chrome trace shows the region.  When no
profile is collecting, `annotate` reads one flag and returns a shared
no-op context.  Span times are Unix-epoch nanoseconds (`time.time_ns`),
the clock of the profiler's events, CPU and CUDA alike, so a span can be
laid over the device's operations.  `spans()` reads the buffer out and
`totals()` sums it by name.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_CAPACITY = 1 << 16  # spans kept; older ones are dropped first


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span: `parent` is the id of the span open around it on
    its thread (None for a root), `request` the id of that thread's root."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: int
    thread: int


class Recorder:
    """The bounded buffer of closed spans, the count of those dropped from
    it, and each thread's stack of open spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.closed: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.closed) == self.closed.maxlen:
                self.dropped += 1
            self.closed.append(span)

    def new_id(self) -> int:
        return next(self._ids)


_RECORDER = Recorder()


class _SpanContext:
    """An open span: on the thread's stack and inside `record_function`."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "_region", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _RECORDER.stack()
        self.id = _RECORDER.new_id()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        self._stack = stack
        stack.append(self)
        self._region = record_function(self.name)
        self._region.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._region.__exit__(*exc)
        self._stack.pop()
        _RECORDER.add(Span(self.name, self.start_ns, end_ns, self.id, self.parent,
                           self.request, threading.get_ident()))
        return False


_NOOP = contextlib.nullcontext()


def annotate(name: str):
    """A span named `name` while a profile is collecting (see the module
    docstring); otherwise the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _SpanContext(name)


def spans() -> List[Span]:
    """The closed spans in the buffer, oldest first."""
    with _RECORDER._lock:
        return list(_RECORDER.closed)


def dropped() -> int:
    """How many closed spans the bounded buffer has dropped."""
    return _RECORDER.dropped


def totals() -> Dict[str, Tuple[int, float]]:
    """Per span name in the buffer: (count, summed seconds)."""
    out: Dict[str, Tuple[int, float]] = {}
    for s in spans():
        n, sec = out.get(s.name, (0, 0.0))
        out[s.name] = (n + 1, sec + (s.end_ns - s.start_ns) / 1e9)
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """`torch.profiler` over the CPU and, when CUDA is available, the GPU,
    exported as a Chrome trace `trace_<pid>_<ns>.json` into `log_dir`;
    nothing for a falsy `log_dir`.  Yields the trace file's path."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def clear_device_cache() -> None:
    """Release host and device memory that is no longer referenced: collect
    Python garbage, then return the CUDA caching allocator's free blocks
    to CUDA when it is initialised (the reference's
    `clear_gpu_cache`: gc + torch.cuda.empty_cache).  Live tensors are
    untouched."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
