"""`csrc/histogram_quantile.cu` mode B against its memory bound: x read
once and one float32 per row written at 3.35 TB/s, over the kernel's mean
device time per launch in the traced cycles (%)."""

from port_bench.flops import H100_HBM_BYTES_PER_S

KERNEL = "histogram_abs_quantile_kernel"


def read(outcome):
    t = outcome.trace
    if t is None or "quantile_bytes" not in outcome.facts:
        return None
    launches = t.count(KERNEL)
    if not launches:
        return None
    bound_s = outcome.facts["quantile_bytes"] / H100_HBM_BYTES_PER_S
    return bound_s / (t.kernel_s(KERNEL) / launches) * 100.0
