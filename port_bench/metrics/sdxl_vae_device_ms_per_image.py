"""Device time of the SDXL KL-f8 decode per image (1024 x 1024, float32):
the operations that start inside the benchmark's range around each
first-stage decode of the traced request, over the images decoded (ms)."""


def read(outcome):
    t = outcome.trace
    if t is None or "images_per_decode" not in outcome.facts:
        return None
    calls = len(t.spans("vae"))
    if not calls:
        return None
    return t.kernel_s_in("vae") / (calls * outcome.facts["images_per_decode"]) * 1e3
