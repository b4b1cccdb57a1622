"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as new files and new entries alone: done here in a
temporary copy of the checkout, whose existing files stay byte for byte."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

from port_bench import harness
from port_bench.tests.tiny import tiny_guided_cell

METRIC = '''"""Cycles' steps run in the window (a throwaway reader for the test)."""


def read(outcome):
    return float(outcome.attempted)
'''

SCRIPT = """
import json, sys, torch
torch.set_num_threads(2)
from port_bench import harness, run
cell = harness.find_cell("extra-cell")
out = run.run_cell(cell, 7, 0.1, True, torch.device("cpu"))
print(json.dumps(harness.result_line(cell, out, torch.device("cpu"), True)))
"""


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.PKG_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(harness.ROOT, "clip_diffusion_tpu_torch"),
               root / "clip_diffusion_tpu_torch")

    tiny = tiny_guided_cell(batch=2)
    pkg = root / "port_bench"
    (pkg / "configs" / "tiny-extra.json").write_text(json.dumps(tiny.config))
    traffic = dict(tiny.traffic, why="throwaway")
    (pkg / "traffic" / "guided-extra-b2.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "extra_steps.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-extra", "source": "https://example.org/tiny",
                             "file": "port_bench/configs/tiny-extra.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "extra-cell", "config": "tiny-extra",
                               "traffic": "guided-extra-b2", "chips": 1, "why": "throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "guided_s_per_image":
            m["workloads"].append("extra-cell")
    bench["per_layer"].append({"name": "extra_steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "pipeline/guided step loop",
                               "moves": "guided_s_per_image", "workloads": ["extra-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["extra_steps"]["value"] == line["attempted"] >= 5

    # every file the benchmark had is unchanged
    cmp = filecmp.dircmp(harness.PKG_DIR, pkg, ignore=["__pycache__"])

    def changed(c):
        return c.diff_files + [f for sub in c.subdirs.values() for f in changed(sub)]
    assert changed(cmp) == []
