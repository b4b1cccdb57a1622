"""Per-component breakdown of the guided step.

    python3 -m clip_diffusion_tpu_torch.tools.profile_step [--only SECTION] [--k 4] \\
        [--repeats 2] [--clips ViT-B/32,ViT-B/16,ViT-L/14,RN101] [--caps 4,2] [--cpu]

Counterpart of the JAX package's tools/profile_step.py, with its sections
and names: `phases` (one full step at each cutout phase's caps, at the
phase's first step, with each phase's step count: on the 250-step default
schedule (14, 2) x 50 steps, (12, 4) x 50, (4, 2) x 100, (0, 12) x 50), `unet` (forward; forward + backward), `unet_blocks` (each
resolution level's ResBlock and AttentionBlock alone at its shape, forward
+ backward, with FLOPs counted by `torch.utils.flop_counter` and the
achieved rate against the card's dense bf16 peak), `unet_remat` (the whole
UNet's forward + backward under remat ("full") and without, with each
one's peak memory; an out-of-memory error is a data point),
`phase_blocks` (one phase's step beside its parts: cutouts, each tower,
UNet, threshold), `cutouts`, `sampler` (mode B's threshold) and `clip`
(each tower's embed + prompt loss, forward + backward).

Each entry times K chained iterations in one call: on a CUDA device with
CUDA events, on the CPU with the host clock; `ms_per_iter` is the minimum
over `repeats` calls, after a first, untimed call (`first_s`).  On a CUDA
device each entry is also run once under torch.profiler for its device
milliseconds per iteration (`device_ms_per_iter`).  The last line is
`BREAKDOWN {json}`; its "device" entry names the device (and, on a card,
nvidia-smi's name and power limit).

The section functions take a built pipeline, so `chip_smoke.py` runs them
on the zoo it holds and the tests on a tiny pipeline; `main` builds the
full-width zoo at 512x512 (random-init stand-ins unless release files are
provisioned) on `cuda` unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from clip_diffusion_tpu_torch.config import Config, CutoutSchedules
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig, init_history, schedule_tables
from clip_diffusion_tpu_torch.guidance.cutouts import make_cutouts_batch
from clip_diffusion_tpu_torch.guidance.losses import square_spherical_distance_loss
from clip_diffusion_tpu_torch.models.clip.model import clip_normalize
from clip_diffusion_tpu_torch.models.unet import AttentionBlock, ResBlock, UNetModel
from clip_diffusion_tpu_torch.ops.quantile import dynamic_threshold_fast
from clip_diffusion_tpu_torch.pipeline.guided import (
    GuidedPipeline,
    PLMSHistory,
    TorchDraws,
    compute_phase_segments,
    guided_step,
    schedule_index,
)
from clip_diffusion_tpu_torch.utils.device import resolve_device

SECTIONS = ("phases", "unet", "unet_blocks", "unet_remat", "phase_blocks", "cutouts",
            "sampler", "clip")
# The JAX tool's phases of the default schedule at 250 steps (caps -> the
# step it times); `phases` derives the phases and checks that these are
# theirs: the same caps, each step inside its phase.
JAX_PHASE_STEPS = {(14, 2): 249, (12, 4): 199, (4, 2): 120, (0, 12): 20}
# One H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, 700 W).
H100_BF16_DENSE_TFLOPS = 989.0
PROMPT = "a beautiful landscape painting"
T_PROBE = 500.0  # the UNet sections' timestep


class Timer:
    """Times a section's `run()`, which does K chained iterations and
    returns a tensor, into `result[name]`."""

    def __init__(self, device: torch.device, k: int, repeats: int):
        self.device, self.k, self.repeats = device, k, repeats
        self.result: Dict[str, dict] = {}

    def _call_ms(self, run: Callable) -> float:
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(self.device)
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3

    def _device_ms(self, run: Callable) -> Optional[float]:
        """Device milliseconds of one `run()` under torch.profiler, or None
        when the profiler recorded no device event (not measured)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        # the device alone: host events cost more to collect than the run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(self.device)
        us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA]
        return sum(us) / 1e3 if us else None

    def __call__(self, name: str, run: Callable, **extra) -> dict:
        t0 = time.perf_counter()
        run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        first_s = time.perf_counter() - t0
        best = min(self._call_ms(run) for _ in range(self.repeats))
        entry = {"ms_per_iter": best / self.k, "first_s": first_s, **extra}
        if self.device.type == "cuda":
            device_ms = self._device_ms(run)
            entry["device_ms_per_iter"] = None if device_ms is None else device_ms / self.k
        self.result[name] = entry
        print(name, entry, flush=True)
        return entry


def _grad_chain(loss_fn: Callable, z: torch.Tensor, k: int) -> torch.Tensor:
    """K chained steps z <- z + 1e-6 * d loss / dz."""
    for _ in range(k):
        leaf = z.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
        z = (leaf + 1e-6 * g).detach()
    return z


def _steps(pipe: GuidedPipeline) -> int:
    return pipe.schedule.num_steps - pipe.sampler.skip_timesteps


def _probe(pipe: GuidedPipeline, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(pipe.device).manual_seed(seed)
    return torch.randn((1, pipe.config.height, pipe.config.width, 3), generator=gen,
                       device=pipe.device)


def _counts(pipe: GuidedPipeline, step: int):
    """(n_ov, n_in, power, gray) scheduled at respaced step `step`."""
    ov, inn, power, gray = pipe.config.cutout_schedules.as_arrays()
    idx = schedule_index(pipe.schedule, step)
    return int(ov[idx]), int(inn[idx]), float(power[idx]), float(gray[idx])


def _step_run(pipe: GuidedPipeline, step: int, k: int) -> Callable:
    """K chained guided steps at respaced step `step` from the probe
    image."""
    tables = schedule_tables(pipe.schedule, pipe.device)
    draws = TorchDraws(0, pipe.device)
    x0 = _probe(pipe)

    def run():
        x = x0
        history = (PLMSHistory(init_history(x.shape, pipe.device))
                   if pipe.sampler.mode == "plms" else None)
        for _ in range(k):
            x, _ = guided_step(pipe, tables, x, step, draws, None, history)
        return x

    return run


def check_jax_phases(segments) -> None:
    """The JAX tool's phase table holds the caps of `segments` (the default
    schedule's at 250 steps), each of its steps inside its phase."""
    phases = {caps: set(steps.tolist()) for steps, caps in segments}
    if set(phases) != set(JAX_PHASE_STEPS) or any(
            step not in phases[caps] for caps, step in JAX_PHASE_STEPS.items()):
        raise RuntimeError(f"phases {[(c, int(s[0]), len(s)) for s, c in segments]} do not "
                           f"hold the JAX tool's {JAX_PHASE_STEPS}")


def section_phases(pipe: GuidedPipeline, timer: Timer) -> None:
    """One step at each phase's caps, at the phase's first step, with the
    phase's step count; then the trajectory's time weighted by the counts."""
    segments = compute_phase_segments(pipe, _steps(pipe))
    if pipe.config.cutout_schedules == CutoutSchedules() and _steps(pipe) == 250:
        check_jax_phases(segments)
    counted = [(timer(f"step_phase_{caps[0]}ov_{caps[1]}in",
                      _step_run(pipe, int(steps[0]), timer.k),
                      first_step=int(steps[0]), steps=len(steps)), len(steps))
               for steps, caps in segments]
    weighted = {"ms": sum(e["ms_per_iter"] * n for e, n in counted),
                "steps": sum(n for _, n in counted)}
    if timer.device.type == "cuda":
        device = [e["device_ms_per_iter"] for e, _ in counted]
        weighted["device_ms"] = (None if None in device
                                 else sum(d * n for d, (_, n) in zip(device, counted)))
    timer.result["phases_weighted"] = weighted
    print("phases_weighted", weighted, flush=True)


def _unet_runs(unet: Callable, x: torch.Tensor, k: int):
    t = torch.full((x.shape[0],), T_PROBE, device=x.device)

    def fwd():
        c = x
        with torch.no_grad():
            for _ in range(k):
                c = c + 1e-6 * unet(c, t)[..., :3]
        return c

    def fwd_bwd():
        return _grad_chain(lambda z: torch.sum(unet(z, t).float() ** 2), x, k)

    return fwd, fwd_bwd


def section_unet(pipe: GuidedPipeline, timer: Timer) -> None:
    fwd, fwd_bwd = _unet_runs(pipe.unet, _probe(pipe), timer.k)
    timer("unet_fwd", fwd)
    timer("unet_fwd_bwd", fwd_bwd)


def _card_line() -> Optional[str]:
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def section_unet_blocks(pipe: GuidedPipeline, timer: Timer) -> None:
    """Each resolution level's first ResBlock (and its AttentionBlock where
    the level has attention) alone at its real shape on the pipeline's
    canvas, forward + backward, in the UNet's compute and parameter dtypes;
    FLOPs from `FlopCounterMode` over one forward + backward."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = pipe.unet.config
    dev = pipe.device
    param_dtype = next(pipe.unet.parameters()).dtype
    mc = cfg.model_channels
    time_dim = 4 * mc
    gen = torch.Generator(dev).manual_seed(0)
    emb = torch.randn((1, time_dim), generator=gen, device=dev).to(cfg.dtype)
    side = pipe.config.height
    blocks = []
    prev, ds = int(cfg.channel_mult[0] * mc), 1
    for level, mult in enumerate(cfg.channel_mult):
        ch = int(mult * mc)
        blocks.append(("res", level, side // ds, prev, ch))
        if ds in cfg.attention_ds:
            blocks.append(("attn", level, side // ds, ch, ch))
        prev, ds = ch, 2 * ds
    for kind, level, size, cin, cout in blocks:
        with torch.device(dev):
            if kind == "res":
                mod = ResBlock(cin, time_dim, cout, cfg.use_scale_shift_norm, dtype=cfg.dtype)
            else:
                mod = AttentionBlock(cin, cfg.num_head_channels, dtype=cfg.dtype)
        mod = mod.to(param_dtype).requires_grad_(False)
        z0 = torch.randn((1, cin, size, size), generator=gen, device=dev).to(cfg.dtype)
        if kind == "res":
            loss = lambda z, mod=mod: torch.sum(mod(z, emb).float() ** 2)  # noqa: E731
        else:
            loss = lambda z, mod=mod: torch.sum(mod(z).float() ** 2)  # noqa: E731
        leaf = z0.detach().requires_grad_(True)
        with torch.enable_grad(), FlopCounterMode(display=False) as counter:
            loss(leaf).backward()  # the counter's module hooks refuse autograd.grad
        flops = counter.get_total_flops()
        entry = timer(f"L{level}_{kind}_{size}px_{cin}to{cout}",
                      lambda loss=loss, z0=z0: _grad_chain(loss, z0, timer.k),
                      gflop_fwdbwd=flops / 1e9)
        if entry.get("device_ms_per_iter"):
            entry["tflops"] = flops / (entry["device_ms_per_iter"] / 1e3) / 1e12
            entry["pct_peak"] = 100 * entry["tflops"] / H100_BF16_DENSE_TFLOPS
            print("   ->", {k: entry[k] for k in ("tflops", "pct_peak")}, flush=True)


def section_unet_remat(pipe: GuidedPipeline, timer: Timer) -> None:
    """The whole UNet's forward + backward under remat ("full") and
    without, each a UNetModel built on `meta` that takes the pipeline UNet's
    own tensors (no copy); on a card, each one's peak memory above what was
    allocated before it."""
    x = _probe(pipe)
    weights = pipe.unet.state_dict()
    for label, kw in (("remat_full", dict(remat=True)),
                      ("remat_off", dict(remat=False))):
        with torch.device("meta"):
            model = UNetModel(dataclasses.replace(pipe.unet.config, **kw))
        model.load_state_dict(weights, assign=True)
        _, fwd_bwd = _unet_runs(model, x, timer.k)
        name = f"unet_fwdbwd_{label}"
        cuda = timer.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(timer.device)
            base = torch.cuda.memory_allocated(timer.device)
            torch.cuda.reset_peak_memory_stats(timer.device)
        try:
            entry = timer(name, fwd_bwd)
        except torch.cuda.OutOfMemoryError as e:  # out of memory is a data point
            timer.result[name] = {"error": str(e)[:200]}
            print(f"{name} FAILED: {str(e)[:200]}", flush=True)
            torch.cuda.empty_cache()
            continue
        if cuda:
            peak = torch.cuda.max_memory_allocated(timer.device)
            entry["peak_gib"] = peak / 2**30
            entry["activation_peak_gib"] = (peak - base) / 2**30
            print("   ->", {k: entry[k] for k in ("peak_gib", "activation_peak_gib")}, flush=True)


def _cuts_run(pipe: GuidedPipeline, step: int, caps, k: int, resolution: int):
    """K chained forward + backward passes of the cutout engine at `caps`
    (counts, power and gray of `step`), d sum(cuts) / d image."""
    n_ov, n_in, power, gray = _counts(pipe, step)
    if (n_ov, n_in) != tuple(caps):
        raise ValueError(f"step {step} schedules ({n_ov}, {n_in}) cutouts, not {tuple(caps)}")
    cfg = pipe.config
    spec = pipe.cutout_spec(resolution)
    draws = TorchDraws(0, pipe.device).cutouts(step, 0, 1, cfg.num_cutout_batches, spec,
                                               n_ov, n_in)
    x = _probe(pipe)

    def loss(z):
        cuts, _ = make_cutouts_batch(z.to(cfg.guidance_torch_dtype), draws, n_ov, n_in, power,
                                     gray, spec, repeats=cfg.num_cutout_batches)
        return torch.sum(cuts.float())

    return cfg.num_cutout_batches * (n_ov + n_in), lambda: _grad_chain(loss, x, k)


def _tower_runs(pipe: GuidedPipeline, n_cuts: int, k: int):
    """(tag, run) per perceptor: K chained forward + backward passes of its
    embed and prompt loss over `n_cuts` uniform cuts at its resolution."""
    gen = torch.Generator(pipe.device).manual_seed(1)
    for perc in pipe.perceptors:
        res = perc.input_resolution
        cuts = torch.rand((n_cuts, res, res, 3), generator=gen, device=pipe.device).to(
            pipe.config.guidance_torch_dtype)

        def loss(c, perc=perc):
            e = perc.embed_image(clip_normalize(c))
            te = perc.text_embeddings
            return torch.sum(square_spherical_distance_loss(e[:, None, :], te[None, :, :]))

        yield perc.name.replace("/", "_"), lambda loss=loss, cuts=cuts: _grad_chain(loss, cuts, k)


def _threshold_run(pipe: GuidedPipeline, k: int) -> Callable:
    x = _probe(pipe)
    pct = pipe.sampler.dynamic_thresholding_percentile

    def run():
        c = x
        for _ in range(k):
            c = dynamic_threshold_fast(c * 1.001, pct)
        return c

    return run


def _first_phase(pipe: GuidedPipeline) -> Tuple[int, Tuple[int, int]]:
    steps, caps = compute_phase_segments(pipe, _steps(pipe))[0]
    return int(steps[0]), caps


def section_cutouts(pipe: GuidedPipeline, timer: Timer) -> None:
    """The cutout engine at the first phase's caps (the most cuts)."""
    step, caps = _first_phase(pipe)
    n, run = _cuts_run(pipe, step, caps, timer.k, pipe.perceptors[0].input_resolution)
    timer(f"cutouts_{n}_fwd_bwd", run)


def section_sampler(pipe: GuidedPipeline, timer: Timer) -> None:
    timer("threshold_histogram", _threshold_run(pipe, timer.k))


def section_clip(pipe: GuidedPipeline, timer: Timer) -> None:
    """Each tower over the first phase's cut count."""
    step, caps = _first_phase(pipe)
    n = pipe.config.num_cutout_batches * sum(caps)
    for tag, run in _tower_runs(pipe, n, timer.k):
        timer(f"clip_{tag}_fwdbwd_{n}", run)


def section_phase_blocks(pipe: GuidedPipeline, timer: Timer,
                         caps: Tuple[int, int] = (4, 2)) -> None:
    """One phase's whole step beside its parts at the same caps: the
    cutout engine, each tower over the phase's cuts, the UNet forward +
    backward and the threshold; then the parts' sum against the whole."""
    caps = tuple(caps)
    phase = [int(s[0]) for s, c in compute_phase_segments(pipe, _steps(pipe)) if c == caps]
    if not phase:
        raise ValueError(f"the schedule has no phase with caps {caps}")
    step = phase[0]
    whole = timer(f"whole_step_{caps[0]}ov_{caps[1]}in", _step_run(pipe, step, timer.k))
    parts = []
    n, run = _cuts_run(pipe, step, caps, timer.k, pipe.perceptors[0].input_resolution)
    parts.append(timer(f"cutouts_{n}_fwd_bwd", run))
    for tag, run in _tower_runs(pipe, n, timer.k):
        parts.append(timer(f"clip_{tag}_fwdbwd_{n}", run))
    parts.append(timer("unet_fwd_bwd", _unet_runs(pipe.unet, _probe(pipe), timer.k)[1]))
    parts.append(timer("threshold_histogram", _threshold_run(pipe, timer.k)))
    key = "device_ms_per_iter" if timer.device.type == "cuda" else "ms_per_iter"
    total = sum(p[key] or 0.0 for p in parts)
    timer.result["sum_blocks_vs_whole"] = summary = {
        "measure": key, "sum_blocks_ms": total, "whole_step_ms": whole[key],
        "overlap_pct": 100 * (total - whole[key]) / total}
    print("sum_blocks_vs_whole", summary, flush=True)


def run_sections(pipe: GuidedPipeline, sections: Sequence[str] = SECTIONS, k: int = 4,
                 repeats: int = 2, caps: Tuple[int, int] = (4, 2)) -> Dict[str, dict]:
    """The named sections on `pipe`, in SECTIONS' order -> the breakdown
    (one entry per timed item, plus "device")."""
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; expected some of {SECTIONS}")
    timer = Timer(pipe.device, k, repeats)
    funcs = {"phases": section_phases, "unet": section_unet, "unet_blocks": section_unet_blocks,
             "unet_remat": section_unet_remat,
             "phase_blocks": lambda p, t: section_phase_blocks(p, t, caps),
             "cutouts": section_cutouts, "sampler": section_sampler, "clip": section_clip}
    for name in SECTIONS:
        if name in sections:
            funcs[name](pipe, timer)
    cuda = pipe.device.type == "cuda"
    timer.result["device"] = {
        "name": torch.cuda.get_device_name(pipe.device) if cuda else "cpu",
        "nvidia_smi": _card_line() if cuda else None,
        "timer": "CUDA events" if cuda else "host clock",
        "peak_bf16_dense_tflops": H100_BF16_DENSE_TFLOPS if cuda else None,
    }
    return timer.result


def build_profile_pipeline(clips: Sequence[str], device) -> GuidedPipeline:
    """The 512x512 pipeline the JAX tool profiles: the UNet and `clips` in
    bfloat16, DDIM, 250 steps, eta 0.8, the default cutout schedule."""
    from clip_diffusion_tpu_torch.zoo import build_models, build_pipeline

    config = Config(width=512, height=512, chosen_clip_models=tuple(clips))
    models = build_models(config, image_size=512, param_dtype=torch.bfloat16, device=device)
    return build_pipeline(models, config, [(PROMPT, 1.0)],
                          SamplerConfig(mode="ddim", steps=250, eta=0.8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=SECTIONS, default=None)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--clips", default="ViT-B/32,ViT-B/16,ViT-L/14,RN101")
    ap.add_argument("--caps", default="4,2",
                    help="(phase_blocks) 'n_overview,n_inner' cutout caps of the phase to decompose")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    print("building models...", flush=True)
    pipe = build_profile_pipeline(args.clips.split(","), device)
    result = run_sections(pipe, [args.only] if args.only else SECTIONS, args.k, args.repeats,
                          tuple(int(v) for v in args.caps.split(",")))
    print("BREAKDOWN " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
