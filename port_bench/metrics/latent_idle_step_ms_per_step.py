"""Device idle time of the traced latent request while the host was in a
CFG step of the latent loop (`latent.step`), per step (ms);
`port_bench.spans` gives each idle ns to the innermost span open."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "latent.step", spans.count(outcome, "latent.step"))
