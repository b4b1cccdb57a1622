"""Device idle time of the traced SDXL request while the host was in a
text encoding (`latent.text`: the prompt's and the empty prompt's, both
towers and the vector), per request (ms); `port_bench.spans` gives each
idle ns to the innermost span open."""

from port_bench import spans


def read(outcome):
    return spans.idle_ms(outcome, "latent.text", spans.count(outcome, "latent.request"))
