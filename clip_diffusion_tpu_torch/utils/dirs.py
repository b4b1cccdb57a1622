"""Directory helpers: mkdir -p, and the sorted PNG list of a folder."""

from __future__ import annotations

import glob
import os


def make_dir(path: str) -> str:
    """mkdir -p; returns the path."""
    os.makedirs(path, exist_ok=True)
    return path


def list_images(folder: str):
    """Sorted paths of the PNG files directly under `folder`."""
    return sorted(glob.glob(os.path.join(folder, "*.png")))
