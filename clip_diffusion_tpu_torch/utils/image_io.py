"""Image output: array -> PIL and the trajectory GIF.

Counterpart of the parts of `clip_diffusion_tpu.utils.image_io` that
`sample.py` uses.  Arrays are HWC float in [0, 1] display space.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image


def array_to_image(arr) -> Image.Image:
    """(H, W, 3) float [0, 1] -> PIL RGB."""
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    return Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))


def create_gif(frames: Sequence[np.ndarray] | np.ndarray, path: str,
               duration_ms: int = 500) -> str:
    """Write a trajectory GIF from the sampler's evenly spaced frames."""
    images = [array_to_image(f) for f in np.asarray(frames)]
    images[0].save(
        path,
        save_all=True,
        append_images=images[1:],
        duration=max(duration_ms // max(len(images), 1), 20),
        loop=0,
    )
    return path
