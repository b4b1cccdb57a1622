"""Time the histogram-quantile kernels of this checkout, and of an older one, on one GPU.

    python3 -m clip_diffusion_tpu_torch.tools.time_quantile [--parent DIR]

DIR is an unpacked older commit of the repository (`git archive` into a
directory that .gitignore lists).  Each checkout runs in a process of its
own, in turns parent, this, this, parent, so that both are measured on the
same card in the same call.  A process times every function of its
`clip_diffusion_tpu_torch.ops.quantile` that launches a kernel
(`histogram_quantile`, `histogram_abs_quantile`) at the main path's
(1, 786432) float32 row, q = 0.995:

- as called: CUDA events over 200 calls after 10 warm-up calls;
- on the device: torch.profiler over 50 calls, the device time of every
  device operation the call makes (kernels, memsets, copies) and their
  number per call.

Prints one JSON line per process, then the card's name and power limit.

    python3 -m clip_diffusion_tpu_torch.tools.time_quantile --trace

builds the kernel once more with -DHISTOGRAM_QUANTILE_TRACE and prints, for
each mode at the same row, the mean over 300 calls of the time from the
first block's start to the last block's passing of each phase
(%globaltimer; the marks themselves add to the times).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

MAIN_ROW = (1, 786432)
QUANTILE = 0.995
NAMES = ("histogram_quantile", "histogram_abs_quantile")
PHASES = ("start", "staged, max reduced", "past barrier 1", "counted (B: coarse)",
          "counts merged", "past barrier 2 (B)", "c_idx found (B)", "fine counted (B)",
          "fine merged (B)", "finalize begins", "finalize ends")


def _worker() -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_diffusion_tpu_torch.ops import quantile

    dev = torch.device("cuda")
    x = torch.randn(MAIN_ROW, generator=torch.Generator(dev).manual_seed(0), device=dev) * 3.0
    out = {}
    for name in NAMES:
        fn = getattr(quantile, name, None)
        if fn is None or not hasattr(fn, "launches"):
            continue  # no kernel behind this function in that checkout
        for _ in range(10):
            fn(x, QUANTILE)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fn(x, QUANTILE)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):  # the first session may drop events
            fn(x, QUANTILE)
            torch.cuda.synchronize()
        calls = 50
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(x, QUANTILE)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[name] = {
            "as_called_ms": start.elapsed_time(end) / 200,
            "device_us": sum(e.time_range.elapsed_us() for e in events) / calls,
            "device_ops_per_call": len(events) / calls,
        }
    return out


def _trace() -> dict:
    import ctypes

    import numpy as np
    import torch

    from clip_diffusion_tpu_torch.ops import kernels, quantile

    src = os.path.join(kernels.CSRC_DIR, "histogram_quantile.cu")
    path = os.path.join(kernels.BUILD_DIR, "libhistogram_quantile_trace.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DHISTOGRAM_QUANTILE_TRACE",
                    "-o", path, src], check=True, capture_output=True)
    lib = quantile.bind(ctypes.CDLL(path))
    quantile._LIB = lib
    dev = torch.device("cuda")
    x = torch.randn(MAIN_ROW, generator=torch.Generator(dev).manual_seed(0), device=dev) * 3.0
    out = {}
    for name in NAMES:
        fn = getattr(quantile, name)
        for _ in range(50):
            fn(x, QUANTILE)
        acc, calls = np.zeros(len(PHASES)), 300
        for _ in range(calls):
            lib.histogram_quantile_trace_reset()
            torch.cuda.synchronize()
            fn(x, QUANTILE)
            torch.cuda.synchronize()
            stamps = (ctypes.c_ulonglong * len(PHASES))()
            lib.histogram_quantile_trace_read(stamps)
            t = np.array(list(stamps), dtype=np.float64)
            acc += np.where(t > 0, t - t[0], 0.0)
        out[name] = {ph: acc[i] / calls / 1e3 for i, ph in enumerate(PHASES)
                     if acc[i] > 0 or i == 0}
    return out


def _run(checkout: str, label: str) -> dict:
    # this file runs as the worker; the package it times is the checkout's
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                          cwd=checkout, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} ({checkout}) failed:\n{proc.stderr[-4000:]}")
    result = {"checkout": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked older checkout to time in turns with this one")
    ap.add_argument("--trace", action="store_true", help="per-phase times of this checkout's kernel")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker()), flush=True)
        return 0
    if args.trace:
        for name, phases in _trace().items():
            print(f"{name} (us from the first block's start): "
                  + ", ".join(f"{ph} {us:.2f}" for ph, us in phases.items()), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    order = [(here, "this")] * 2
    if args.parent:
        order = [(args.parent, "parent"), *order, (args.parent, "parent")]
    for checkout, label in order:
        _run(checkout, label)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
