"""Share of the traced SDXL request's wall time in which no operation ran
on the device (%), read as the latent cell's `latent_idle_pct`."""

from port_bench.metrics.latent_idle_pct import read  # noqa: F401
