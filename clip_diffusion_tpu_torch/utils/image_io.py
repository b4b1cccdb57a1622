"""Image I/O: array <-> PIL, the init-image loader and the trajectory GIF.

Counterpart of the parts of `clip_diffusion_tpu.utils.image_io` that
`sample.py` uses.  Arrays are HWC float in [0, 1] display space, or
[-1, 1] model space.
"""

from __future__ import annotations

import io
from typing import Sequence

import numpy as np
from PIL import Image


def normalize_image_neg_one_to_one(x):
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def load_image(path_or_bytes, size=None) -> np.ndarray:
    """Open a path or encoded bytes as RGB, LANCZOS-resize to `size` =
    (width, height) when given -> (H, W, 3) float32 in [0, 1]."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    img = Image.open(path_or_bytes).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


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
