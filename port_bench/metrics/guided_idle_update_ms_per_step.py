"""Device idle time of the traced guided cycles while the host was in the
clamp, step noise, threshold and DDIM update (`guided.update`), the
innermost span open, per step (ms); `port_bench.spans` gives each idle
ns to a span."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "guided.update", outcome.facts.get("steps_traced", 0))
