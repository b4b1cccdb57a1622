"""Device idle time of the traced latent request while the host was in the
upscaler calls and their copies to the host (`latent.upscale`), per
request (ms); `port_bench.spans` gives each idle ns to the innermost
span open."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "latent.upscale", spans.count(outcome, "latent.request"))
