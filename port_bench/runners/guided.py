"""The guided request's cells: its steps in cycles, through the program's
`pipeline/guided.guided_sample`.

A 200-step request takes minutes, more than a window, so the window runs
the request's steps in cycles: each cycle is one slice per entry of the
traffic's `cycle` ([phase, steps, offset], phases in execution order of
the cutout schedule), each slice resumed (`resume_state`) from a state
the benchmark draws from the seed at the slice's noise level and stopped
after its steps (`stop_after`).  Slice positions advance through their
phase from cycle to cycle, starting at the entry's offset, so every
phase's steps come at a whole request's rates; the offsets put exactly
one position of every cycle on the every-`progress_every` progress write,
so every cycle writes one PNG, as a request does every 5 steps.  The
pipeline is built as `sample.guided_diffusion_sample` builds it for the
request, and the progress callback is that entry's: a PNG of pred_x0 and
the task state every 5 positions, under TMPDIR.  The window closes after
the last whole cycle that fits into its seconds.

The check: one cycle drawn from the seed among the first
`check_within_cycles`, and of it `check_slices_per_row` slices of every
row, drawn from the seed, against the float32 reference run from the same
start state with the same keyed draws: pred_x0 of every step and x after
each slice.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import flops, harness, weights
from port_bench.reference import guided as rg
from port_bench.reference import layers
from port_bench.trace import DeviceTrace

TAG_UNET, TAG_CLIP, TAG_DRAWS, TAG_STATE, TAG_CHECK = 1, 10, 2, 3, 4
WARMUP_CYCLE = 1_000_000


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


# ---- the program -------------------------------------------------------------

def build_models(cfg: dict, seed: int, device):
    """The port's UNet and towers with weights from the seed -> (ZooModels,
    weight specs)."""
    from clip_diffusion_tpu_torch.models import from_jax
    from clip_diffusion_tpu_torch.models.clip.model import CLIPConfig, CLIPModel
    from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
    from clip_diffusion_tpu_torch.zoo import ZooModels

    dt = _dtype(cfg)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig(**harness.tuples(cfg["unet"]), dtype=dt))
    specs = {"unet": weights.spec_from_layout(unet, from_jax.unet_rule)}
    weights.load(unet, weights.make_state_dict(specs["unet"], seed, TAG_UNET, dt, device))
    clips = {}
    for i, (name, c) in enumerate(cfg["clip"].items()):
        with torch.device("meta"):
            model = CLIPModel(CLIPConfig(name=name, **harness.tuples(c), dtype=dt))
        specs[name] = weights.spec_from_layout(model, from_jax.clip_rule)
        clips[name] = weights.load(model, weights.make_state_dict(specs[name], seed,
                                                                  TAG_CLIP + i, dt, device))
    return ZooModels(unet, clips), specs


def port_config(cfg: dict, req: dict):
    from clip_diffusion_tpu_torch.config import Config, CutoutSchedules, create_schedule

    sched = CutoutSchedules(**{k: create_schedule(tuple(v[0]), tuple(v[1]))
                               for k, v in req["cutout_schedules"].items()})
    return Config(width=req["width"], height=req["height"],
                  num_cutout_batches=req["num_cutout_batches"], cutout_schedules=sched,
                  chosen_clip_models=tuple(cfg["clip"]), grad_threshold=req["grad_threshold"],
                  clip_guidance_scale=req["clip_guidance_scale"],
                  denoise_scale=req["denoise_scale"], range_scale=req["range_scale"],
                  aesthetic_scale=0.0, MS_SSIM_scale=0.0, clip_cut_chunk=req["clip_cut_chunk"],
                  guidance_dtype=req["guidance_dtype"])


def build_pipeline(models, cfg: dict, req: dict, device):
    """The request's pipeline, as `sample.guided_diffusion_sample` builds
    it: the prompt through `Prompt`, then `zoo.build_pipeline`."""
    from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
    from clip_diffusion_tpu_torch.text.prompt import Prompt
    from clip_diffusion_tpu_torch.zoo import build_pipeline as zoo_pipeline

    p = Prompt(req["prompt"], False, 1, None, device=device)
    sampler = SamplerConfig(mode="ddim", steps=req["steps"], eta=req["eta"], skip_timesteps=0,
                            order=2,
                            dynamic_thresholding_percentile=req["dynamic_thresholding_percentile"])
    return zoo_pipeline(models, port_config(cfg, req), [(p.text, p.weight)], sampler)


def progress_writer(out_dir: str, every: int):
    """`sample.guided_diffusion_sample`'s progress callback (no per-step
    saves): a PNG of pred_x0 and the task state every `every` positions."""
    from clip_diffusion_tpu_torch.utils.image_io import array_to_image
    from clip_diffusion_tpu_torch.utils.progress import LocalUploader, store_task_state

    uploader = LocalUploader(out_dir)
    folder = os.path.join(out_dir, "guided")
    os.makedirs(folder, exist_ok=True)

    def progress_cb(pos, imgs):
        img = array_to_image((imgs[0].float().cpu().numpy() + 1) / 2)
        if pos % every == 0:
            path = os.path.join(folder, f"guided_progress_{pos:04}.png")
            img.save(path)
            store_task_state("current_step", pos + 1)
            store_task_state("current_result", uploader.upload(path, minutes=10))
    return progress_cb


def phases(req: dict):
    """[(first position, length)] of the cutout schedule's phases, in
    execution order."""
    tables = rg.ddim_tables(req["steps"], "cpu")
    cs = req["cutout_schedules"]
    ov = rg.dense_schedule(*cs["num_overview_cuts"])
    inn = rg.dense_schedule(*cs["num_inner_cuts"])
    out, last = [], None
    for pos in range(req["steps"]):
        idx = rg.schedule_index(tables, req["steps"] - 1 - pos)
        caps = (ov[idx], inn[idx])
        if caps != last:
            out.append([pos, 0])
            last = caps
        out[-1][1] += 1
    return [tuple(p) for p in out]


def cuts_at(req: dict, pos: int) -> int:
    tables = rg.ddim_tables(req["steps"], "cpu")
    cs = req["cutout_schedules"]
    idx = rg.schedule_index(tables, req["steps"] - 1 - pos)
    n = rg.dense_schedule(*cs["num_overview_cuts"])[idx] + \
        rg.dense_schedule(*cs["num_inner_cuts"])[idx]
    return int(n) * req["num_cutout_batches"]


def slices(traffic: dict, k: int):
    """[(position, steps)] of cycle `k`."""
    req = traffic["request"]
    ph = phases(req)
    out = []
    for phase, n, offset in traffic["cycle"]:
        start, length = ph[phase]
        out.append((start + (offset + k * n) % length, n))
    return out


def start_state(shape, req: dict, seed: int, k: int, j: int, pos: int, device):
    """x at position `pos`: a smooth random image diffused to the step's
    noise level, drawn from (seed, cycle, slice)."""
    g = torch.Generator(device).manual_seed(weights.derive_seed(seed, TAG_STATE, k, j))
    b, h, w, _ = shape
    field = torch.randn((b, 3, max(h // 64, 1), max(w // 64, 1)), generator=g, device=device)
    x0 = F.interpolate(field, size=(h, w), mode="bilinear", align_corners=False)
    x0 = torch.clamp(0.5 * x0, -1.0, 1.0).permute(0, 2, 3, 1)
    noise = torch.randn(shape, generator=g, device=device)
    acp = float(rg.ddim_tables(req["steps"], "cpu")["acp"][req["steps"] - 1 - pos])
    return math.sqrt(acp) * x0 + math.sqrt(1.0 - acp) * noise


class Program:
    """The cell's program side: models, pipeline, draws and the slice
    runner."""

    def __init__(self, cell: "harness.Cell", seed: int, device, out_dir: str):
        from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws

        cfg, self.traffic = cell.config, cell.traffic
        self.req = req = cell.traffic["request"]
        self.seed, self.device = seed, device
        self.models, self.specs = build_models(cfg, seed, device)
        t0 = time.perf_counter()
        self.pipe = build_pipeline(self.models, cfg, req, device)
        self.build_s = time.perf_counter() - t0
        self.draws = TorchDraws(weights.derive_seed(seed, TAG_DRAWS), device)
        self.batch = int(cell.traffic["batch"])
        self.shape = (self.batch, self.pipe.config.height, self.pipe.config.width, 3)
        self.history = torch.zeros((3,) + self.shape, device=device)
        self.progress = progress_writer(out_dir, req["progress_every"])
        self.preds: Optional[List[torch.Tensor]] = None

    def _callback(self, pos, pred_x0):
        if self.preds is not None:
            self.preds.append(pred_x0.clone())
        if pos % self.req["progress_every"] == 0:
            self.progress(pos, pred_x0)

    def run_slice(self, k: int, j: int, pos: int, n: int, record: bool = False):
        """Slice j of cycle k: `n` steps from position `pos` -> (x_start,
        x after, [pred_x0 per step]) when `record`, else None."""
        from clip_diffusion_tpu_torch.pipeline.guided import guided_sample
        from clip_diffusion_tpu_torch.utils.checkpoint import SamplingState

        steps = self.req["steps"]
        x0 = start_state(self.shape, self.req, self.seed, k, j, pos, self.device)
        state = SamplingState(x=x0, step=steps - 1 - pos, eps_history=self.history,
                              history_count=0, key_data=self.draws.key_data())
        self.preds = [] if record else None
        _, _, out = guided_sample(self.pipe, self.draws, batch_size=self.batch,
                                  progress_callback=self._callback, progress_every=1,
                                  resume_state=state, return_state=True, stop_after=n)
        preds, self.preds = self.preds, None
        return (x0, out.x.clone(), preds) if record else None

    def run_cycle(self, k: int, record: bool = False):
        return [(pos, n, self.run_slice(k, j, pos, n, record))
                for j, (pos, n) in enumerate(slices(self.traffic, k))]

    def final_outputs_s(self, out_dir: str) -> float:
        """Seconds of the request's work after its step loop: the final PNG
        and the GIF of its frames (set-up only; not in any metric)."""
        from clip_diffusion_tpu_torch.utils.image_io import array_to_image, create_gif

        t0 = time.perf_counter()
        frames = (torch.zeros((6,) + self.shape, device=self.device).cpu().numpy() + 1) / 2
        folder = os.path.join(out_dir, "guided")
        for b in range(self.batch):
            array_to_image(frames[-1, b]).save(os.path.join(folder, f"guided_{b}.png"))
            create_gif(frames[:, b], os.path.join(folder, f"guided_{b}.gif"), 500)
        return time.perf_counter() - t0

    def close(self):
        del self.pipe, self.models, self.history
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---- the reference and the numbers compared ------------------------------------

def adm_config(cfg: dict):
    """The reference UNet's sizes from the configuration's "unet" group."""
    from port_bench.reference.adm_unet import ADMConfig

    u = harness.tuples(cfg["unet"])
    return ADMConfig(**{k: u[k] for k in (
        "image_size", "in_channels", "model_channels", "out_channels", "num_res_blocks",
        "attention_ds", "channel_mult", "num_head_channels")})


def reference_step(cell: "harness.Cell", seed: int, specs: Dict, device) -> rg.GuidedStep:
    from port_bench.reference import adm_unet, clip as rclip

    cfg, req = cell.config, cell.traffic["request"]
    dt = _dtype(cfg)
    with torch.device("meta"):
        unet = adm_unet.ADMUNet(adm_config(cfg))
    weights.load(unet, weights.as_float32(
        weights.make_state_dict(specs["unet"], seed, TAG_UNET, dt, device)))
    towers = []
    for i, (name, c) in enumerate(cfg["clip"].items()):
        with torch.device("meta"):
            model = rclip.CLIP(rclip.CLIPConfig(**harness.tuples(c)))
        weights.load(model, weights.as_float32(
            weights.make_state_dict(specs[name], seed, TAG_CLIP + i, dt, device)))
        towers.append((name, model))
    return rg.GuidedStep(unet, rg.embed_prompt(towers, req["prompt"], device), req, device)


def compare(step: rg.GuidedStep, records, pairs, draws_seed: int, steps: int, device,
            control: bool = False) -> Dict[str, float]:
    """The numbers compared, over the (slice, row) `pairs` of `records`:
    pred_x0_rel, the largest ||pred_x0 - reference|| / ||reference|| of a
    step; x_rel, the largest ||x - reference|| / ||reference - x_start||
    after a slice (the gap against what the slice changed); and the largest
    absolute gaps of each, pred_x0_max and x_max.  `control` puts the
    reference computed in float8 in the program's place."""
    out = {"pred_x0_rel": 0.0, "pred_x0_max": 0.0, "x_rel": 0.0, "x_max": 0.0}
    for j, r in pairs:
        pos, n, (x_start, x_prog, preds) = records[j]
        draws = rg.Draws(draws_seed, device, lo=r)
        x = x_ref_ctl = x_start[r:r + 1]
        for i in range(n):
            s = steps - 1 - pos - i
            x, pred = step(x, s, draws)
            if control:
                with layers.fp8():
                    x_ref_ctl, got = step(x_ref_ctl, s, draws)
            else:
                got = preds[i][r:r + 1]
            d = (got - pred).float()
            out["pred_x0_rel"] = max(out["pred_x0_rel"], float(d.norm() / pred.norm()))
            out["pred_x0_max"] = max(out["pred_x0_max"], float(d.abs().max()))
        got_x = x_ref_ctl if control else x_prog[r:r + 1]
        dx = (got_x - x).float()
        out["x_rel"] = max(out["x_rel"], float(dx.norm() / (x - x_start[r:r + 1]).norm()))
        out["x_max"] = max(out["x_max"], float(dx.abs().max()))
    return out


def check_unit(traffic: dict, seed: int):
    """The cycle the check follows and its (slice, row) pairs, drawn from
    the seed: row r takes the next `check_slices_per_row` slices of a
    permutation of the cycle's slices, round the cycle, so the pairs hold
    every row and, where there are rows enough, every slice."""
    rng = np.random.default_rng(weights.derive_seed(seed, TAG_CHECK))
    k = int(rng.integers(traffic["check_within_cycles"]))
    n_slices = len(traffic["cycle"])
    order = rng.permutation(n_slices)
    per_row = traffic["check_slices_per_row"]
    pairs = [(int(order[(r * per_row + i) % n_slices]), r)
             for r in range(int(traffic["batch"])) for i in range(per_row)]
    return k, pairs


def judge(cell, seed: int, specs, draws_seed: int, records, pairs, device,
          control: bool = False) -> Dict[str, Dict[str, float]]:
    """Once the program is freed: the reference from the seed, then the
    numbers compared of the program ("program") and, with `control`, of
    the control ("control")."""
    step = reference_step(cell, seed, specs, device)
    steps = cell.traffic["request"]["steps"]
    got = {"program": compare(step, records, pairs, draws_seed, steps, device)}
    if control:
        got["control"] = compare(step, records, pairs, draws_seed, steps, device, control=True)
    return got


def readings(cell, seed: int, device, control: bool = False):
    """The check of a run, untimed: the check cycle through the program,
    then `judge` (for `port_bench.control`)."""
    out_dir = harness.output_dir(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    prog = Program(cell, seed, device, out_dir)
    k, pairs = check_unit(cell.traffic, seed)
    records = prog.run_cycle(k, record=True)
    specs, draws_seed = prog.specs, prog.draws.seed
    prog.close()
    del prog
    got = judge(cell, seed, specs, draws_seed, records, pairs, device, control)
    shutil.rmtree(out_dir, ignore_errors=True)
    return got


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]):
    return [(k, numbers[k], float(limits[k])) for k in limits]


# ---- FLOPs -------------------------------------------------------------------

def flops_per_cycle(cell: "harness.Cell") -> int:
    """Model FLOPs of one cycle from the reference at the cell's shapes: per
    step the UNet's forward and input-gradient backward at the batch, and
    each tower's over the step's cuts of every image."""
    from port_bench.reference import adm_unet, clip as rclip

    cfg, traffic = cell.config, cell.traffic
    req, b = traffic["request"], int(traffic["batch"])
    unet = flops.on_meta(lambda: adm_unet.ADMUNet(adm_config(cfg)))
    x = torch.zeros((1, req["height"], req["width"], 3), device="meta")
    t = torch.zeros((1,), device="meta")
    unet_fb = flops.count(unet, x, t, backward=True)
    tower_fb = 0
    for c in cfg["clip"].values():
        model = flops.on_meta(lambda c=c: rclip.CLIP(rclip.CLIPConfig(**harness.tuples(c))))
        s = c["image_resolution"]
        tower_fb += flops.count(model.encode_image, torch.zeros((1, s, s, 3), device="meta"),
                                backward=True)
    total = 0
    for pos, n in slices(traffic, 0):
        for i in range(n):
            total += b * (unet_fb + cuts_at(req, pos + i) * tower_fb)
    return total


# ---- the run -----------------------------------------------------------------

def run(cell, seed, seconds, trace_on, device) -> "harness.Outcome":
    out_dir = harness.output_dir(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    traffic, req = cell.traffic, cell.traffic["request"]

    t_setup = time.perf_counter()
    prog = Program(cell, seed, device, out_dir)
    t_models = time.perf_counter() - t_setup
    for j, (start, _) in enumerate(phases(req)):  # one step of every phase
        prog.run_slice(WARMUP_CYCLE, j, start, 1)
    sync()
    final_s = prog.final_outputs_s(out_dir)
    setup_s = time.perf_counter() - t_setup
    print(f"setup: {setup_s:.3f} s (imports, models and pipeline {t_models:.3f} s, of which "
          f"prompt and pipeline {prog.build_s:.3f} s; final PNG and GIF {final_s:.3f} s)",
          flush=True, file=sys.stderr)

    check_k, pairs = check_unit(traffic, seed)
    tracer = DeviceTrace(device)
    # the traced cycles come after those the check may follow
    first_traced = traffic["check_within_cycles"]
    traced = traffic["traced_cycles"] if trace_on else 0
    if traced:
        tracer.warm_up()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records, cycles = None, 0
    sync()
    t0 = time.perf_counter()
    # whole cycles, while the mean cycle so far still ends inside the window
    while cycles <= check_k or cycles < first_traced + traced or \
            (time.perf_counter() - t0) * (cycles + 1) / cycles <= seconds:
        if traced and cycles == first_traced:
            tracer.__enter__()
        rec = prog.run_cycle(cycles, record=cycles == check_k)
        sync()
        if cycles == check_k:
            records = rec
        cycles += 1
        if traced and cycles == first_traced + traced:
            tracer.__exit__(None, None, None)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    steps_per_cycle = sum(n for _, n, _ in traffic["cycle"])
    steps_run = cycles * steps_per_cycle
    batch = prog.batch
    values = {"guided_s_per_image": elapsed / steps_run * req["steps"] / batch,
              "peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    print(f"window: {elapsed:.3f} s, {cycles} cycles", flush=True, file=sys.stderr)
    specs, draws_seed = prog.specs, prog.draws.seed
    prog.close()
    del prog

    t_check = time.perf_counter()
    numbers = judge(cell, seed, specs, draws_seed, records, pairs, device)["program"]
    print(f"check: {time.perf_counter() - t_check:.3f} s over {len(pairs)} (slice, row) pairs; "
          + " ".join(f"{k}={v!r}" for k, v in numbers.items()), file=sys.stderr)
    trace = tracer.trace
    facts = {"steps_traced": steps_per_cycle * traced}
    if trace is not None:
        facts["flops_traced"] = flops_per_cycle(cell) * traced
        facts["quantile_bytes"] = flops.quantile_bytes(batch, req["height"] * req["width"] * 3, 4)
    shutil.rmtree(out_dir, ignore_errors=True)
    return harness.Outcome(attempted=steps_run, failed=0, values=values,
                           checks=checks_of(numbers, cell.config["limits"]),
                           memory_peak_bytes=peak, trace=trace, facts=facts)
