"""The control, at a size a test run holds: the reference put in the
program's place in the precision below the configuration's (float8
operands for its bfloat16 parts, TF32 for its float32 ones) fails one of
the cell's limits, where the program passes them all.  On the card the
same readings at the cells' own sizes set the limits
(`python3 -m port_bench.control`)."""

from __future__ import annotations

import pytest
import torch

from port_bench import control
from port_bench.tests.tiny import tiny_cell


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", ["guided-default-b1", "latent-f8-txt2img"])
def test_control_fails_a_limit_the_program_passes(name):
    cell = tiny_cell(name)
    limits = cell.config["limits"]
    (row,) = control.readings(cell, [2 ** 31 + 21], 1, torch.device("cpu"))
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row["program"]
    assert any(row["control"][k] > lim for k, lim in limits.items()), row["control"]
