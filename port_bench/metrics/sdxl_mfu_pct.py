"""The whole SDXL request's share of the H100's dense bf16 peak: the
reference's model FLOPs of the traced request (`flops_per_request`, from
`port_bench/reference/sdxl.py`) over its wall seconds (%), read as the
latent cell's `latent_mfu_pct`."""

from port_bench.metrics.latent_mfu_pct import read  # noqa: F401
