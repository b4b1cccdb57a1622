"""Device time of the SDXL UNet per CFG step (one forward at twice the
batch, 6 x 128 x 128 x 4): the operations that start inside the
benchmark's range around each UNet call of the traced request, over the
calls (ms).  The SDXL runner names its range as the latent runner does,
so the latent cell's reader reads it."""

from port_bench.metrics.latent_unet_device_ms_per_step import read  # noqa: F401
