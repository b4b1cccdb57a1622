"""Device idle time of the traced guided cycles while the host was in the
one backward through the cutouts and the UNet to x (`guided.backward`),
the innermost span open, per step (ms); `port_bench.spans` gives each
idle ns to a span."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "guided.backward", outcome.facts.get("steps_traced", 0))
