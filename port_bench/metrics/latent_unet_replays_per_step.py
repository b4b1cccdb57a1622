"""CUDA graph replays of the LDM UNet per CFG step of the traced latent
request: the program's `ldm.unet.replay` spans over its `latent.step`
spans.  One UNet call a step, so this reads 1 where every call replays
its captured graph and 0 where the forward runs eagerly."""

from port_bench import spans


def read(outcome):
    steps = spans.count(outcome, "latent.step")
    if not steps:
        return None
    return spans.count(outcome, "ldm.unet.replay") / steps
