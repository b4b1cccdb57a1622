"""Device idle time of the traced latent request while the host was in the
VQ decode and its copy to the host (`latent.decode`), per request (ms);
`port_bench.spans` gives each idle ns to the innermost span open."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "latent.decode", spans.count(outcome, "latent.request"))
