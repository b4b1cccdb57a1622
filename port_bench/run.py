"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Builds the cell's models and inputs from
the seed on one GPU, warms every shape the cell uses (set-up), measures
for --seconds, then checks what the timed path produced against the
plain reference.  The last line of standard output is the result object;
the numbers compared and their limits are also the last lines of
standard error.  Exits non-zero with no result when there is no GPU, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):  # run as a script: import the package from the checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402


def run_cell(cell: "harness.Cell", seed: int, seconds: float, trace: bool, device):
    """Set-up, window and check of `cell` -> `harness.Outcome`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed) % (1 << 63)  # any whole number; the keyed draws take non-negative ones
    return harness.runner_for(cell).run(cell, seed, seconds, trace, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    line = harness.result_line(cell, outcome, device, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, value, limit in outcome.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
