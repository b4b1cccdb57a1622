"""What every cell shares: finding a cell's files by its names in
`BENCHMARK.json`, the run's output directory, the import check, the
device record and the result line.

A cell names a configuration (`configs/<config>.json`, whose "runner"
names the module under `runners/` that runs it) and a traffic mix
(`traffic/<traffic>.json`, parameters that runner reads).  A per-layer
metric is `metrics/<name>.py`, whose `read(outcome)` returns its number
or None.  A new cell, configuration, mix or metric is new files and new
entries; no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "clip_diffusion_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


@dataclasses.dataclass
class Outcome:
    """What a runner hands back once its window has closed and its check
    has run."""

    attempted: int
    failed: int
    values: Dict[str, float]  # end-to-end metrics by name
    checks: List[Tuple[str, float, float]]  # (number compared, value, limit)
    memory_peak_bytes: int
    trace: Any = None  # trace.Trace of the traced window, or None
    facts: Dict[str, float] = dataclasses.field(default_factory=dict)  # for metric readers

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v == v and v <= lim for _, v, lim in self.checks)


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str) -> Cell:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in e2e_names]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(os.path.join(ROOT, config_file)),
        traffic=load_json(os.path.join(PKG_DIR, "traffic", f"{w['traffic']}.json")),
        end_to_end=e2e, per_layer=per_layer,
    )


def tuples(d: Dict[str, Any]) -> Dict[str, Any]:
    """A configuration group with its JSON lists as tuples, as the
    models' config dataclasses take them."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def runner_for(cell: Cell):
    return importlib.import_module(f"port_bench.runners.{cell.config['runner']}")


def read_metric(name: str, outcome: Outcome) -> Optional[float]:
    module = importlib.import_module(f"port_bench.metrics.{name}")
    return module.read(outcome)


def output_dir(cell: Cell) -> str:
    """Where the run's images go: under TMPDIR, one directory per cell."""
    return os.path.join(tempfile.gettempdir(), "port_bench", cell.name)


def set_cache_dirs() -> None:
    """Keep every compiler cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, "build", "cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: `clip_diffusion_tpu_torch` is not `clip_diffusion_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_record(device, peak_bytes: int, trace=None) -> Dict[str, Any]:
    import torch

    if device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": int(peak_bytes)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        rec["busy_s"] = trace.busy_s
        rec["window_s"] = trace.window_s
    return rec


def result_line(cell: Cell, outcome: Outcome, device, trace_on: bool) -> Dict[str, Any]:
    """The result object; the numbers compared come last."""
    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            value = read_metric(m["name"], outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.values[m["name"]], "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": device_record(device, outcome.memory_peak_bytes,
                                    outcome.trace if trace_on else None)}
    if trace_on and outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return line
