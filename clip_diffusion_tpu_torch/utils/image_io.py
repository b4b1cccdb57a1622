"""Image I/O: array <-> PIL, the init-image and mask loaders, the
trajectory GIF, and the latent pipeline's grid with its drawn indices.

Counterpart of the parts of `clip_diffusion_tpu.utils.image_io` that
`sample.py` uses.  Arrays are HWC float in [0, 1] display space, or
[-1, 1] model space.
"""

from __future__ import annotations

import io
import os
from typing import Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def normalize_image_neg_one_to_one(x):
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def denormalize_image_zero_to_one(x):
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) / 2.0


def load_image(path_or_bytes, size=None) -> np.ndarray:
    """Open a path or encoded bytes as RGB, LANCZOS-resize to `size` =
    (width, height) when given -> (H, W, 3) float32 in [0, 1]."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    img = Image.open(path_or_bytes).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_mask(path_or_bytes, size=None) -> np.ndarray:
    """A mask pasted on a white background (through its alpha channel when
    it has one), binarized, LANCZOS-resized to `size` = (width, height)
    when given -> (H, W, 1) float32 in {0, 1}; 1 keeps the init image."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    mask = Image.open(path_or_bytes)
    background = Image.new("RGB", mask.size, "WHITE")
    if mask.mode in ("RGBA", "LA", "PA"):
        background.paste(mask, box=(0, 0), mask=mask)
    else:
        background.paste(mask, box=(0, 0))
    mask = background.convert("1")
    if size is not None:
        mask = mask.resize(size, Image.LANCZOS)
    return np.asarray(mask, dtype=np.float32)[..., None]


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


def make_grid(images: np.ndarray, nrow: int, padding: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one grid image, row-major with `nrow` images per row
    and `padding` zero pixels around each cell."""
    n, h, w, c = images.shape
    rows = int(np.ceil(n / nrow))
    grid = np.zeros((rows * (h + padding) + padding, nrow * (w + padding) + padding, c),
                    dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def _font(size: int):
    """The TrueType font at $CLIP_DIFFUSION_FONT, else Pillow's own."""
    path = os.environ.get("CLIP_DIFFUSION_FONT")
    if path and os.path.exists(path):
        return ImageFont.truetype(path, size)
    try:
        return ImageFont.load_default(size)
    except TypeError:  # Pillow < 10.1 has one bitmap size only
        return ImageFont.load_default()


def draw_index_on_grid_image(grid_image: Image.Image, num_rows: int, num_cols: int,
                             cell_height: int, cell_width: int,
                             padding: int = 2) -> Image.Image:
    """Draw each cell's row-major index in its top-left corner, in place."""
    draw = ImageDraw.Draw(grid_image)
    font = _font(max(cell_height // 8, 10))
    idx = 0
    for r in range(num_rows):
        for c in range(num_cols):
            x = c * (cell_width + padding) + padding + 4
            y = r * (cell_height + padding) + padding + 2
            draw.text((x, y), str(idx), fill=(255, 64, 64), font=font)
            idx += 1
    return grid_image
