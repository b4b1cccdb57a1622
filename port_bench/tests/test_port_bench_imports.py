"""No run may load JAX or the JAX package, and the reference loads
nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from port_bench import harness

REF_DIR = os.path.join(harness.PKG_DIR, "reference")


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("clip_diffusion_tpu", True), ("clip_diffusion_tpu.pipeline.guided", True),
    ("clip_diffusion_tpu_torch", False), ("clip_diffusion_tpu_torch.pipeline.guided", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False),
])
def test_forbidden_modules_compare_top_level_names_whole(name, bad):
    assert harness.forbidden_modules([name, "torch", "numpy"]) == ([name.split(".")[0]]
                                                                   if bad else [])


@pytest.mark.parametrize("path", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_sources_import_neither_the_program_nor_jax(path):
    with open(os.path.join(REF_DIR, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in harness.FORBIDDEN + ("clip_diffusion_tpu_torch",), n


def test_reference_loads_neither_the_program_nor_jax():
    code = ("import sys; import port_bench.reference.guided, port_bench.reference.latent, "
            "port_bench.reference.adm_unet, port_bench.reference.clip; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'clip_diffusion_tpu', 'clip_diffusion_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_run_loads_no_jax_and_exits_without_a_gpu():
    """Importing every module a run imports loads no JAX; without a CUDA
    device the run prints no result and exits non-zero."""
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "latent-f8-txt2img", "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
