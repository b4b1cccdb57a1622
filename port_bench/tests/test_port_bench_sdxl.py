"""The SDXL cell on the CPU at tiny widths, through the harness code a run
uses: a run comes out correct with the configuration's limits, each of
the three planted faults of `test_port_bench_faults.py` (a step that
keeps its state, half the batch replaced by the other half's mean, one
value of an answer altered) fails one of them, the check covers every
step and every image, the FLOP count grows with the work, and the cell's
files were added with every other benchmark file as it was."""

from __future__ import annotations

import copy
import json
import os
import subprocess

import pytest
import torch

import clip_diffusion_tpu_torch.pipeline.latent as pl
import clip_diffusion_tpu_torch.sample as ps
from port_bench import harness
from port_bench import run as bench_run

CPU = torch.device("cpu")
CELL = "sdxl-base-1024-b3"
NEW_FILES = {"BENCHMARK.json", "port_bench/configs/latent-sdxl-base-1024.json",
             "port_bench/traffic/sdxl-default-requests.json", "port_bench/runners/sdxl.py",
             "port_bench/reference/sdxl.py", "port_bench/tests/test_port_bench_sdxl.py"} | {
    f"port_bench/metrics/{m}.py" for m in (
        "sdxl_unet_device_ms_per_step", "sdxl_softmax_device_ms_per_step",
        "sdxl_vae_device_ms_per_image", "sdxl_idle_pct", "sdxl_mfu_pct",
        "sdxl_idle_text_ms_per_request", "sdxl_attention_calls_per_step")}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_sdxl_cell() -> harness.Cell:
    """The cell with the configuration's keys at small widths, float32,
    and a 32 x 32 request of 3 steps (f4 latents of 8 x 8)."""
    cell = harness.find_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["dtypes"] = {k: "float32" for k in cfg["dtypes"]}
    cfg["unet"].update(model_channels=32, channel_mult=[1, 2, 4], num_head_channels=16,
                       transformer_depth=[0, 1, 2], context_dim=40, adm_in_channels=72)
    cfg["clip_l"].update(width=16, heads=2, layers=3)
    cfg["clip_g"].update(width=24, heads=2, layers=3, embed_dim=24)
    cfg["conditioning"].update(clip_l_layer=2, clip_g_layer=2, size_embed_dim=8,
                               original_size=[32, 32], target_size=[32, 32])
    cfg["vae"].update(ch=16, ch_mult=[1, 2, 2], num_res_blocks=1)
    traffic = copy.deepcopy(cell.traffic)
    traffic["request"].update(diffusion_steps=3, num_batches=2, sample_width=32,
                              sample_height=32)
    return harness.Cell(cell.name, cell.chips, cfg, traffic, cell.end_to_end, cell.per_layer)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_is_correct(trace):
    cell = tiny_sdxl_cell()
    outcome = bench_run.run_cell(cell, 2 ** 31 + 13, 0.2, trace, CPU)
    line = json.loads(json.dumps(harness.result_line(cell, outcome, CPU, trace)))
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"context_rel", "vector_rel", "step_rel", "image_mean"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        # no device trace on the CPU: only the counter's reader has a number
        assert line["metrics"] == {"sdxl_attention_calls_per_step": {"value": 34.0,
                                                                     "unit": "calls"}}
    else:
        assert set(line["metrics"]) == {"latent_s_per_request", "peak_gib", "setup_s"}


def _half_rows(t):
    h = t.shape[0] // 2
    return torch.cat([t[:h], t[:h].mean(dim=0, keepdim=True).expand_as(t[h:])])


def _faults():
    real_sample, real_decode = ps.latent_sample, ps.decode_latents

    def stuck(pipe, draws, ctx_c, ctx_u=None, batch_size=1, height=256, width=256, steps=50,
              guidance_scale=5.0, eta=0.0, mode="ddim", **_):
        shape = (batch_size, height // pipe.downsample, width // pipe.downsample,
                 pipe.latent_channels)
        x = draws.initial_noise(shape).to(torch.float32)
        tables = pl.ldm_ddim_tables(steps, eta, x.device)
        with torch.inference_mode():
            for i in range(steps - 1, -1, -1):  # the UNet runs, the state stays
                pl._model_eps(pipe, x, float(tables["timesteps"][i]), ctx_c, ctx_u,
                              guidance_scale)
        return x

    def half_batch(pipe, draws, ctx_c, ctx_u=None, batch_size=1, **k):
        h = batch_size // 2
        z = real_sample(pipe, draws, tuple(a[:h] for a in ctx_c),
                        None if ctx_u is None else tuple(a[:h] for a in ctx_u),
                        batch_size=h, **k)
        return _half_rows(torch.cat([z, z]))

    def altered(pipe, z):
        out = real_decode(pipe, z).clone()
        out[0, 3, 4, 0] = torch.clamp(out[0, 3, 4, 0] + 0.25, 0.0, 1.0)
        return out

    return {"stuck": ("latent_sample", stuck), "half_batch": ("latent_sample", half_batch),
            "altered": ("decode_latents", altered)}


@pytest.mark.parametrize("fault", ["stuck", "half_batch", "altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    cell = tiny_sdxl_cell()
    name, fn = _faults()[fault]
    monkeypatch.setattr(ps, name, fn)
    outcome = bench_run.run_cell(cell, 2 ** 31 + 5, 0.1, False, CPU)
    assert not outcome.correct, outcome.checks


def test_check_covers_every_step_and_image():
    from port_bench.runners import sdxl

    full = harness.find_cell(CELL).traffic
    steps, n = full["request"]["diffusion_steps"], full["request"]["num_batches"]
    for seed in (1, 2 ** 31 + 7, 2 ** 40):
        k, pairs = sdxl.check_unit(full, seed)
        assert 0 <= k < full["check_within_requests"]
        assert [s for s, _ in pairs] == list(range(steps))
        assert sorted({j for _, j in pairs}) == list(range(n))
    assert sdxl.check_unit(full, 5) == sdxl.check_unit(full, 5)
    assert len({tuple(sdxl.check_unit(full, s)[1]) for s in range(8)}) > 1


def test_control_fails_a_limit_the_program_passes():
    """At tiny widths, as `test_port_bench_control.py` holds the other cells:
    the reference in the program's place with float8 operands in the text
    towers and the UNet and TF32 in the VAE fails one of the cell's limits,
    where the program passes them all."""
    from port_bench import control

    cell = tiny_sdxl_cell()
    limits = cell.config["limits"]
    (row,) = control.readings(cell, [2 ** 31 + 21], 1, CPU)
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row["program"]
    assert any(row["control"][k] > lim for k, lim in limits.items()), row["control"]


def test_flops_grow_with_the_request():
    from port_bench.runners import sdxl

    cell = tiny_sdxl_cell()
    base = sdxl.flops_per_request(cell)
    more = copy.deepcopy(cell)
    more.traffic["request"]["diffusion_steps"] = 6
    assert 0 < base < sdxl.flops_per_request(more)


SCRIPT = """
import json, sys, torch
torch.set_num_threads(2)
from port_bench import harness, run
cell = harness.find_cell("sdxl-base-1024-b3")
out = run.run_cell(cell, 2 ** 31 + 3, 0.1, True, torch.device("cpu"))
print(json.dumps(harness.result_line(cell, out, torch.device("cpu"), True)))
"""


def _without_the_cell(bench: dict) -> dict:
    """BENCHMARK.json as it was before the cell: its entries taken out."""
    out = copy.deepcopy(bench)
    out["configs"] = [c for c in out["configs"] if c["name"] != "latent-sdxl-base-1024"]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"] if not m["name"].startswith("sdxl_")]
    for m in out["end_to_end"]:
        if CELL in m.get("workloads", []):
            m["workloads"].remove(CELL)
    return out


def test_the_cell_is_new_files_and_entries_alone(tmp_path):
    """In a temporary checkout holding the benchmark without the cell, the
    cell's files are added and its entries appended (the one edit to an
    entry: the cell appended to `latent_s_per_request`'s list); the cell
    then runs there at tiny widths, traced, correct, and every file the
    benchmark had is byte for byte as it was."""
    import filecmp
    import shutil
    import sys

    root = tmp_path / "checkout"
    root.mkdir()
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    before = _without_the_cell(bench)
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(harness.PKG_DIR, root / "port_bench", ignore=ignore)
    for f in NEW_FILES - {"BENCHMARK.json"}:
        os.remove(root / f)
    (root / "BENCHMARK.json").write_text(json.dumps(before))
    snapshot = tmp_path / "snapshot"
    shutil.copytree(root / "port_bench", snapshot, ignore=ignore)
    os.symlink(os.path.join(harness.ROOT, "clip_diffusion_tpu_torch"),
               root / "clip_diffusion_tpu_torch")

    for f in NEW_FILES - {"BENCHMARK.json"}:
        shutil.copy(os.path.join(harness.ROOT, f), root / f)
    (root / "port_bench/configs/latent-sdxl-base-1024.json").write_text(
        json.dumps(tiny_sdxl_cell().config))
    (root / "port_bench/traffic/sdxl-default-requests.json").write_text(
        json.dumps(tiny_sdxl_cell().traffic))
    after = copy.deepcopy(before)
    for key in ("configs", "workloads", "per_layer"):
        after[key] += [e for e in bench[key] if e not in before[key]]
    for m in after["end_to_end"]:
        if m["name"] == "latent_s_per_request":
            m["workloads"].append(CELL)
    assert after == bench
    (root / "BENCHMARK.json").write_text(json.dumps(after))

    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["sdxl_attention_calls_per_step"]["value"] == 34.0

    cmp = filecmp.dircmp(snapshot, root / "port_bench", ignore=["__pycache__"])

    def changed(c):
        return c.diff_files + c.left_only + [f for sub in c.subdirs.values()
                                             for f in changed(sub)]
    assert changed(cmp) == []
