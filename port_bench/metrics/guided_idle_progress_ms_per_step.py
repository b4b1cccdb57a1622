"""Device idle time of the traced guided cycles while the host was in the
progress callback: the copy of pred_x0 and the PNG every 5 steps
(`guided.progress`), the innermost span open, per step (ms);
`port_bench.spans` gives each idle ns to a span."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "guided.progress", outcome.facts.get("steps_traced", 0))
