"""Readings that set a cell's limits: the program's numbers compared over
many seeds (the lower readings) and its control's (the upper readings).

    python3 -m port_bench.control --workload <name> --seeds 11 12 ... [--control 3]

For each seed: the cell's models from the seed, the slice of traffic that
the run checks (the guided check cycle; the latent check request), run
through the program as in a run but untimed, then the numbers compared
against the float32 reference.  For the first `--control` seeds also the
control: the reference put in the program's place in the precision one
step below what the configuration states (float8 operands for its
bfloat16 parts, TF32 for its float32 parts), against the same float32
reference.  One JSON line per seed on standard output, and under --out.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import harness  # noqa: E402


def readings(cell, seeds, n_control: int, device, out=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = harness.runner_for(cell)
    rows = []
    for i, seed in enumerate(seeds):
        got = runner.readings(cell, seed, device, i < n_control)
        row = {"workload": cell.name, "seed": seed, **got}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    readings(harness.find_cell(args.workload), args.seeds, args.control,
             torch.device("cuda", 0), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
