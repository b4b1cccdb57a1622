"""Share of the traced latent request's wall time in which no operation ran
on the device (%)."""


def read(outcome):
    t = outcome.trace
    if t is None or not t.ops:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
