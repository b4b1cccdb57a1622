"""Launches of the LDM UNet's fused attention kernel per CFG step of the
traced request: the device operations whose name holds
"ldm_softmax_attention" (`csrc/ldm_attention.cu`) that start inside the
benchmark's range around each UNet call, over the calls.  Each attention
call of the UNet is one launch where the kernel is on the path: 140 a step
in SDXL (70 transformer blocks, self and cross), 32 in txt2img-f8-large
(16 blocks); 0 where the plain attention runs."""

import bisect

KERNEL = "ldm_softmax_attention"


def read(outcome):
    t = outcome.trace
    if t is None:
        return None
    spans = t.spans("unet")
    if not spans:
        return None
    starts = [op.start for op in t.ops]
    launches = 0
    for s, e in spans:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)
        launches += sum(1 for op in t.ops[lo:hi] if KERNEL in op.name)
    return launches / len(spans)
