"""Launches of the quantile kernel per traced guided step: the program's
`ops.quantile` spans (one per launch) in the traced window over its
steps.  Mode B runs once a step, so this reads 1."""

from port_bench import spans


def read(outcome):
    steps = outcome.facts.get("steps_traced", 0)
    if spans.idle_of(outcome) is None or not steps:
        return None
    return spans.count(outcome, "ops.quantile") / steps
