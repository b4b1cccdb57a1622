"""Device idle time of the traced guided cycles while the host was in the
four towers' chunked forward and backward (`guided.tower`, one span per
tower), the innermost span open, per step (ms); `port_bench.spans` gives
each idle ns to a span."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "guided.tower", outcome.facts.get("steps_traced", 0))
