"""The FLOP and byte counters against counts worked out by hand."""

from __future__ import annotations

import torch
from torch import nn

from port_bench import flops
from port_bench.reference.layers import Conv2d, Linear


def test_linear_forward_and_input_backward():
    lin = flops.on_meta(lambda: Linear(8, 16))
    x = torch.zeros((4, 8), device="meta")
    assert flops.count(lin, x) == 2 * 4 * 8 * 16
    # the input gradient is one more matmul of the same size; no weight gradient
    assert flops.count(lin, torch.zeros((4, 8), device="meta"), backward=True) == 2 * 2 * 4 * 8 * 16


def test_conv_forward_and_input_backward():
    conv = flops.on_meta(lambda: Conv2d(3, 5, 3, padding=1))
    x = torch.zeros((2, 3, 6, 6), device="meta")
    fwd = 2 * 2 * 5 * 6 * 6 * 3 * 3 * 3
    assert flops.count(conv, x) == fwd
    assert flops.count(conv, torch.zeros((2, 3, 6, 6), device="meta"), backward=True) == 2 * fwd


def test_elementwise_work_is_not_counted():
    assert flops.count(nn.SiLU(), torch.zeros((4, 8), device="meta")) == 0


def test_quantile_bytes():
    # the default canvas: 768 x 512 x 3 float32 values per row, one float32 out per row
    assert flops.quantile_bytes(1, 768 * 512 * 3, 4) == 4718592 + 4
    assert flops.quantile_bytes(4, 10, 2) == 4 * 10 * 2 + 4 * 4


def test_guided_cycle_flops_at_a_tiny_shape():
    """The cycle's count is batch x (steps x UNet + cuts x towers), each a
    forward and an input-gradient backward."""
    from port_bench.runners import guided
    from port_bench.tests.tiny import tiny_guided_cell

    cell = tiny_guided_cell(batch=2)
    total = guided.flops_per_cycle(cell)
    req = cell.traffic["request"]
    positions = [p + i for p, n in guided.slices(cell.traffic, 0) for i in range(n)]
    assert len(positions) == 5
    cuts = sum(guided.cuts_at(req, p) for p in positions)
    assert cuts == 64 + 64 + 24 + 24 + 48
    assert total > 0 and total % 2 == 0
