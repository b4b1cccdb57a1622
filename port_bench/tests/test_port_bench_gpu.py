"""The device trace on the card: kernels recorded, markers found and kept
out of the device time, ranges attributed.  Skips without a CUDA device
(run on the card: `python -m pytest port_bench/tests -m cuda`)."""

from __future__ import annotations

import pytest
import torch

from port_bench.trace import DeviceTrace, Ranges


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_trace_records_kernels_and_ranges(cuda):
    a = torch.randn((1024, 1024), device=cuda)
    ranges = Ranges(cuda)
    lin = torch.nn.Linear(1024, 1024, device=cuda)
    hooks = ranges.hook(lin, "lin")
    with DeviceTrace(cuda, ranges) as dt:
        for _ in range(3):
            lin(a)
        (a @ a).sum()
    for h in hooks:
        h.remove()
    t = dt.trace
    assert t is not None and t.ops and t.window_s > 0
    assert 0 < t.busy_s <= t.window_s
    assert all("spin_kernel" not in op.name for op in t.ops)
    assert len(t.spans("lin")) == 3
    assert 0 < t.kernel_s_in("lin") < t.kernel_s()
    bd = t.breakdown()
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
