"""Every cell end to end on the CPU at tiny widths, through the harness
code a run uses: set-up, window, check and the result line."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import harness
from port_bench import run as bench_run
from port_bench.tests.tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(
    f"{harness.ROOT}/BENCHMARK.json")["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(name, trace, capsys):
    cell = tiny_cell(name)
    outcome = bench_run.run_cell(cell, 2 ** 31 + 11, 0.2, trace, torch.device("cpu"))
    line = json.loads(json.dumps(harness.result_line(cell, outcome, torch.device("cpu"), trace)))
    assert list(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(cell.config["limits"])
    if trace:
        assert line["metrics"] == {}  # the CPU records no device trace
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "peak_gib")
    assert line["device"]["platform"] == "cpu"


def test_seeds_give_the_same_inputs_and_other_seeds_others():
    from port_bench.runners import guided

    cell = tiny_cell("guided-default-b1")
    shape = (1, 64, 64, 3)
    req = cell.traffic["request"]
    a = guided.start_state(shape, req, 5, 0, 1, 3, torch.device("cpu"))
    b = guided.start_state(shape, req, 5, 0, 1, 3, torch.device("cpu"))
    c = guided.start_state(shape, req, 6, 0, 1, 3, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["guided-default-b1", "guided-default-b4"])
def test_every_guided_cycle_writes_one_progress_png_and_the_check_covers_it(name):
    from port_bench.runners import guided

    traffic = harness.find_cell(name).traffic
    every = traffic["request"]["progress_every"]
    for k in range(4 * every):
        positions = [p + i for p, n in guided.slices(traffic, k) for i in range(n)]
        assert sum(p % every == 0 for p in positions) == 1, (k, positions)
    for seed in (1, 2 ** 31 + 7, 2 ** 40):
        k, pairs = guided.check_unit(traffic, seed)
        assert 0 <= k < traffic["check_within_cycles"]
        assert sorted({r for _, r in pairs}) == list(range(traffic["batch"]))
        assert sorted({j for j, _ in pairs}) == list(range(len(traffic["cycle"])))
        assert len(set(pairs)) == traffic["batch"] * traffic["check_slices_per_row"]
