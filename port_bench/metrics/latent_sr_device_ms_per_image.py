"""Device time of one x4 Real-ESRGAN upscale: the operations that start
inside the benchmark's range around each upscaler call of the traced
request, over the calls (ms)."""


def read(outcome):
    t = outcome.trace
    if t is None:
        return None
    calls = len(t.spans("upscale"))
    if not calls:
        return None
    return t.kernel_s_in("upscale") / calls * 1e3
