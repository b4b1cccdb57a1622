"""Device time of the softmax kernels of the SDXL UNet per CFG step: the
operations whose name holds "softmax" (any case) that start inside the
benchmark's range around each UNet call of the traced request, over the
calls (ms).  The UNet's only softmax is its attention's, over float32
logits: the plain attention's largest pass over memory."""

import bisect


def read(outcome):
    t = outcome.trace
    if t is None:
        return None
    spans = t.spans("unet")
    if not spans:
        return None
    starts = [op.start for op in t.ops]
    total = 0
    for s, e in spans:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)
        total += sum(op.end - op.start for op in t.ops[lo:hi] if "softmax" in op.name.lower())
    return total / 1e9 / len(spans) * 1e3
