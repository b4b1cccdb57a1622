"""Device time per guided step: the summed time of every device operation
in the traced cycles, over their steps (ms)."""


def read(outcome):
    t = outcome.trace
    if t is None or not t.ops:
        return None
    return t.kernel_s() / outcome.facts["steps_traced"] * 1e3
