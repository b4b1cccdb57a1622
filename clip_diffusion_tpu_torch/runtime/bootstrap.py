"""Service bootstrap: build the model zoo once, wire the sampling entry
points and the analyzer into the HTTP server, and serve.

Counterpart of `clip_diffusion_tpu.runtime.bootstrap`.  The zoo loads the
release files under the port's weights root (`$CLIP_DIFFUSION_TORCH`,
default models/torch) where present and random-initializes the rest
(`zoo.load_or_init`); finetuned UNets there (`guided_unet_custom_<slug>.pt`)
become model types.

    python -m clip_diffusion_tpu_torch.runtime.bootstrap --port 8080 [--with-latent]
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional

from clip_diffusion_tpu_torch import sample as sample_mod
from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.runtime.server import ClipDiffusionServer
from clip_diffusion_tpu_torch.utils.device import resolve_device
from clip_diffusion_tpu_torch.zoo import build_latent_models, build_latent_pipeline, build_models


def build_service(config: Optional[Config] = None, with_latent: bool = False,
                  tiny: bool = False, port: int = 8080, device=None) -> ClipDiffusionServer:
    """The server, not yet serving, on `device` (default `cuda`): the
    guided zoo and its analyzer, and with `with_latent` the latent stack,
    built once.  `tiny` builds no guided zoo (its requests build their own)
    and the latent stack's test configs."""
    device = resolve_device(device)
    config = config or Config()
    if tiny:
        config = config.replace(chosen_clip_models=())
    models = None if tiny else build_models(config, device=device)
    latent_fn = None
    if with_latent:
        pipe, text_encode = build_latent_pipeline(build_latent_models(tiny=tiny, device=device))
        latent_fn = functools.partial(sample_mod.latent_diffusion_sample, pipe=pipe,
                                      text_encode=text_encode)
    return ClipDiffusionServer(port=port, config=config, models=models, latent_fn=latent_fn,
                               device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve the port's HTTP API.")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--with-latent", action="store_true")
    p.add_argument("--tiny", action="store_true", help="test configs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    server = build_service(with_latent=args.with_latent, tiny=args.tiny, port=args.port,
                           device=args.device)
    print(f"clip-diffusion-tpu (PyTorch) serving on :{server.port} ({server.device})",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
