"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source `clip_diffusion_tpu_torch/csrc/<name>.cu` with a
plain C interface.  At first use it is compiled with `nvcc` for `sm_90a`
into `<repo>/build/kernels/lib<name>-<source hash>.so` and loaded with
`ctypes`; a library whose hash matches the source is reused.  Nothing here
runs at import: the CPU tests import every module without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # IEEE division and no FMA contraction: the kernels must round exactly
    # as their plain PyTorch versions do
    "-prec-div=true", "-fmad=false",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists; return
    the library path.  Safe to call from several threads for different
    kernels (each writes its own file, renamed into place when done)."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        with _LOCK:
            lib = _LIBS.setdefault(name, lib)
    return lib
