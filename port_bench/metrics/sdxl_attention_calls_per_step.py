"""Calls of the LDM UNet's one attention function per CFG step of the
traced SDXL request: the program's counter (`attention.calls`, which a
replayed CUDA graph advances by the calls its capture made) over the
request's steps.  SDXL's UNet has 70 transformer blocks, each a self- and
a cross-attention: 140 a step, one UNet call a step."""


def read(outcome):
    f = outcome.facts
    if not f.get("cfg_steps") or "attention_calls" not in f:
        return None
    return f["attention_calls"] / f["cfg_steps"]
