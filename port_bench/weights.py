"""Random weights from the run's seed, made on the device.

The scales are the model zoo's: a parameter named `scale` or holding
`var` is ones, `bias` and `mean` are zeros, everything else is drawn from
N(0, 1 / fan_in) with fan_in the product of all but the last dimension of
the parameter's JAX layout (the port's `models/from_jax.jax_layout` gives
that layout).  Unlike the zoo's host numpy init, every normal parameter
of a model comes out of one `torch.randn` call on the device, seeded from
(seed, model tag), then is cut, scaled and cast: a few large calls instead
of one per leaf.

`spec` is computed once from the port's module; `make_state_dict` can be
called again later with the same arguments to hand the reference exactly
the weights the program ran with.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def derive_seed(seed: int, *words: int) -> int:
    """A 63-bit generator seed for (seed, words...)."""
    return int(np.random.SeedSequence([int(seed), *words]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def spec_from_layout(module: torch.nn.Module, rule) -> Spec:
    """[(key, port shape, "ones" | "zeros" | "normal", std)] sorted by key."""
    from clip_diffusion_tpu_torch.models.from_jax import jax_layout

    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = []
    for path, jshape, key, _ in jax_layout(module, rule):
        name = path[-1]
        if name == "scale" or "var" in name:
            kind, std = "ones", 0.0
        elif name in ("bias", "mean"):
            kind, std = "zeros", 0.0
        else:
            kind, std = "normal", 1.0 / math.sqrt(max(int(np.prod(jshape[:-1])), 1))
        out.append((key, shapes[key], kind, std))
    return sorted(out)


def make_state_dict(spec: Spec, seed: int, tag: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The state dict of `spec` drawn from (seed, tag), each tensor in
    `dtype` on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(derive_seed(seed, tag))
    total = sum(math.prod(s) for _, s, kind, _ in spec if kind == "normal")
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd, off = {}, 0
    for key, shape, kind, std in spec:
        if kind == "normal":
            n = math.prod(shape)
            sd[key] = (buf[off:off + n].view(shape) * std).to(dtype)
            off += n
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            sd[key] = fill(shape, dtype=dtype, device=device)
    del buf
    return sd


def load(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """`module` (built on `meta`) takes the tensors of `state_dict` as its
    parameters and buffers, frozen and in eval mode."""
    module.load_state_dict(state_dict, strict=True, assign=True)
    return module.requires_grad_(False).eval()


def as_float32(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.to(torch.float32) for k, v in state_dict.items()}
