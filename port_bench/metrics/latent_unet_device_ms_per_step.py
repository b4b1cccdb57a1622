"""Device time of the LDM UNet per CFG step (one forward at twice the
batch): the operations that start inside the benchmark's range around
each UNet call of the traced request, over the calls (ms)."""


def read(outcome):
    t = outcome.trace
    if t is None:
        return None
    calls = len(t.spans("unet"))
    if not calls:
        return None
    return t.kernel_s_in("unet") / calls * 1e3
