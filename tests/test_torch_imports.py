"""The port and chip_smoke.py import neither JAX nor the JAX package: every
module of the port, the checkpoint layer, the serving runtime and the
multi-process modules among them, is imported in a fresh interpreter."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import clip_diffusion_tpu_torch
names = [m.name for m in pkgutil.walk_packages(clip_diffusion_tpu_torch.__path__,
                                               "clip_diffusion_tpu_torch.")]
new = {"clip_diffusion_tpu_torch.runtime.bootstrap", "clip_diffusion_tpu_torch.runtime.registry",
       "clip_diffusion_tpu_torch.runtime.server", "clip_diffusion_tpu_torch.utils.checkpoint",
       "clip_diffusion_tpu_torch.models.convert", "clip_diffusion_tpu_torch.models.ldm.convert",
       "clip_diffusion_tpu_torch.parallel.dist", "clip_diffusion_tpu_torch.parallel.ensemble"}
assert new <= set(names), sorted(new - set(names))
for name in names:
    importlib.import_module(name)
import chip_smoke  # its imports only: the run is under __main__
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "clip_diffusion_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 58, proc.stdout
