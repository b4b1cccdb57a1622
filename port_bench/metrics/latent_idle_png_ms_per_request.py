"""Device idle time of the traced latent request while the host was in the
PNG writes: the images, the grid and the x4 upscales (`latent.png`), per
request (ms); `port_bench.spans` gives each idle ns to the innermost
span open."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "latent.png", spans.count(outcome, "latent.request"))
