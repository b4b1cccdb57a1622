"""The whole latent request's share of the H100's dense bf16 peak: the
reference's model FLOPs of the traced request over its wall seconds (%)."""

from port_bench.flops import H100_BF16_DENSE_FLOPS


def read(outcome):
    t = outcome.trace
    if t is None or not t.ops or "flops_per_request" not in outcome.facts:
        return None
    return outcome.facts["flops_per_request"] / t.window_s / H100_BF16_DENSE_FLOPS * 100.0
