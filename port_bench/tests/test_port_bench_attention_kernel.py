"""`attention_kernel_launches_per_step` on synthetic traces: the device
operations named like the fused attention kernel that start inside the
benchmark's `unet` ranges, over the UNet calls."""

from __future__ import annotations

import pytest

from port_bench import harness
from port_bench.metrics import attention_kernel_launches_per_step
from port_bench.trace import Op, Trace

METRIC = "attention_kernel_launches_per_step"
KERNEL = "void (anonymous namespace)::ldm_softmax_attention_fwd<64>((anonymous namespace)::Params)"


def _outcome(trace):
    return harness.Outcome(attempted=1, failed=0, values={}, checks=[], memory_peak_bytes=0,
                           trace=trace, facts={})


def _trace(per_call, calls=3, outside=2):
    """`calls` UNet ranges of 1000 ns, each holding `per_call` kernel
    launches beside a GEMM and a softmax of the plain body; `outside`
    launches after the last range (a decode, say)."""
    ops, marks = [], []
    for c in range(calls):
        start = 10000 * c
        marks += [("open:unet", start), ("close:unet", start + 1000)]
        ops.append(Op("nvjet_gemm", start + 1, start + 2))
        ops.append(Op("cunn_SoftMaxForwardReg", start + 2, start + 3))
        ops += [Op(KERNEL, start + 10 + i, start + 11 + i) for i in range(per_call)]
    ops += [Op(KERNEL, 10000 * calls + i, 10000 * calls + i + 1) for i in range(outside)]
    return Trace(ops, window_s=1.0, marks=marks)


@pytest.mark.parametrize("per_call", [140, 32, 0])
def test_launches_per_unet_call(per_call):
    """140 in SDXL's step, 32 in the latent cell's, 0 where the plain body
    runs (the parent); launches outside the UNet ranges are not counted."""
    got = harness.read_metric(METRIC, _outcome(_trace(per_call)))
    assert got == float(per_call)


def test_reads_nothing_without_a_trace_or_a_unet_range():
    assert attention_kernel_launches_per_step.read(_outcome(None)) is None
    assert attention_kernel_launches_per_step.read(
        _outcome(Trace([Op(KERNEL, 0, 1)], window_s=1.0))) is None


def test_entry_lists_the_cells_of_the_ldm_unet():
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    entry = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert entry == [{"name": METRIC, "unit": "launches", "better": "higher",
                      "source": "device_trace", "layer": "models/ldm/unet attention",
                      "moves": "latent_s_per_request",
                      "workloads": ["sdxl-base-1024-b3", "latent-f8-txt2img"]}]
