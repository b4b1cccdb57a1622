"""Directory helpers: mkdir -p (optionally clearing the old contents), and
the sorted image list of a folder."""

from __future__ import annotations

import glob
import os
import shutil


def make_dir(path: str, remove_old: bool = False) -> str:
    """mkdir -p, first removing the directory and its contents when
    `remove_old`; returns the path."""
    if remove_old and os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    return path


def list_images(folder: str, extension: str = "png"):
    """Sorted paths of the `*.<extension>` files directly under `folder`."""
    return sorted(glob.glob(os.path.join(folder, f"*.{extension}")))
