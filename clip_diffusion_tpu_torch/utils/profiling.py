"""Profiling and tracing hooks.

Counterpart of `clip_diffusion_tpu.utils.profiling`: `torch.profiler`
traces around a trajectory and wall-clock section accounting.  Usage:

    with trace("build/trace"):          # a Chrome trace (chrome://tracing,
        final, frames = guided_sample(...)   # Perfetto) under that dir

    with annotate("guided_step"):       # a named region in the trace
        ...
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


def annotate(name: str):
    """A named region in the trace (`torch.profiler.record_function`)."""
    return record_function(name)


def clear_device_cache() -> None:
    """Release host and device memory that is no longer referenced: collect
    Python garbage, then return the CUDA caching allocator's free blocks
    to CUDA when it is initialised (the reference's
    `clear_gpu_cache`: gc + torch.cuda.empty_cache).  Live tensors are
    untouched."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class Stopwatch:
    """Wall-clock section accounting; `report()` returns a JSON string."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (time.time() - t0)

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.sections.items()})
