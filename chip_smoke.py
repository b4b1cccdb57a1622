#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`clip_diffusion_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--steps 10] [--out build/chip_smoke]

Phases, each announced on its own line; any failure exits non-zero:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: every CUDA kernel under clip_diffusion_tpu_torch/csrc, one nvcc
   per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (and against the library call where one exists),
   with CUDA-event timings and the bound the card could reach;
4. reference: a tiny pipeline on the card against the same pipeline on the
   CPU, same weights and same draws;
5. main path: `guided_diffusion_sample` at 512x512, DDIM, the full-width
   512 ADM UNet (bfloat16, random init) and the ViT-B/32, ViT-B/16 and
   ViT-L/14 perceptors at preset widths, 4 cutout batches.  Kernel launch
   counts are zeroed just before and read just after;
6. profile: two main-path steps timed, then run under torch.profiler:
   device time by kernel class and by direction, and the device's idle
   share.

Then one JSON line {"kernels": [...]}, the nvidia-smi line again, and as
the last line {"ok": true, "device": {...}}.  TF32 is off throughout, so
float32 comparisons run in full float32.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from clip_diffusion_tpu_torch.config import Config, CutoutSchedules, create_schedule
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.ops import kernels
from clip_diffusion_tpu_torch.ops.quantile import histogram_quantile, histogram_quantile_plain
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws, guided_sample
from clip_diffusion_tpu_torch.sample import guided_diffusion_sample
from clip_diffusion_tpu_torch.zoo import ZooModels, build_models, build_pipeline, host_init_state_dict

# Published H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

MAIN_ROW = (1, 786432)  # pred_x0 of one 512x512 RGB image, flattened
QUANTILE = 0.995  # the main path's dynamic_thresholding_percentile
PERCEPTORS = ("ViT-B/32", "ViT-B/16", "ViT-L/14")
PROMPT = "A lighthouse on a cliff at golden hour, oil painting."


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_all() -> list:
    """Compile every kernel source in parallel; returns the kernel names."""
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for name, path in zip(names, pool.map(kernels.build, names)):
            print(f"built {name}: {os.path.relpath(path)}", flush=True)
    print(f"build wall time {time.perf_counter() - t0:.2f} s", flush=True)
    return names


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_histogram_quantile(dev) -> dict:
    """The kernel against the plain version (within 1e-6 * max|x|: the
    same float32 expressions, rounding only in the interpolation) and
    torch.quantile (within max|x| / 2048, the histogram's bound, plus
    1e-6 * max|x| of rounding) on (1, N) and (4, N) rows."""
    gen = torch.Generator(dev).manual_seed(0)
    n = MAIN_ROW[1]
    cases = []
    for rows in (1, 4):
        for scale in (0.5, 3.0, 40.0):
            cases.append(torch.randn((rows, n), generator=gen, device=dev) * scale)
    edge = torch.randn((4, n), generator=gen, device=dev)
    edge[1] = 0.0  # all-zero row
    edge[2] = -0.7  # constant row
    cases.append(edge)
    max_err = 0.0
    for x in cases:
        for q in (0.5, 0.995, 1.0):
            got = histogram_quantile(x, q)
            plain = histogram_quantile_plain(x, q)
            exact = torch.quantile(x.abs(), q, dim=1)
            torch.cuda.synchronize()
            hi = x.abs().amax(dim=1).clamp_min(1e-12)
            err = (got - plain).abs()
            if not bool(torch.all(err <= 1e-6 * hi)):
                raise AssertionError(f"histogram_quantile vs plain: err {err.tolist()} q={q}")
            if not bool(torch.all((got - exact).abs() <= hi / 2048 + 1e-6 * hi)):
                raise AssertionError(f"histogram_quantile vs torch.quantile: q={q}")
            max_err = max(max_err, float(err.max()))
    print(f"histogram_quantile: {len(cases) * 3} cases agree; max |kernel - plain| = {max_err:.3e}",
          flush=True)

    x = torch.randn(MAIN_ROW, generator=gen, device=dev) * 3.0
    ms = cuda_ms(lambda: histogram_quantile(x, QUANTILE))
    plain_ms = cuda_ms(lambda: histogram_quantile_plain(x, QUANTILE))
    library_ms = cuda_ms(lambda: torch.quantile(x.abs(), QUANTILE, dim=1))
    rows, n = MAIN_ROW
    bytes_moved = 4 * rows * n + 4 * rows  # x read once, (B,) written once
    ops = 5 * rows * n  # abs, divide, multiply, truncate/clip, count per element
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    print(f"histogram_quantile {MAIN_ROW} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.quantile {library_ms:.4f} ms, bound {max(bound_bytes, bound_ops):.5f} ms",
          flush=True)
    return {
        "name": "histogram_quantile", "route": "cuda",
        "source": "clip_diffusion_tpu_torch/csrc/histogram_quantile.cu",
        "replaces": "clip_diffusion_tpu/ops/quantile.py:79",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": library_ms,
    }


class _MovedDraws(TorchDraws):
    """Draws made on the CPU generator, handed over on `device`: the same
    numbers for a CPU run and a GPU run."""

    def __init__(self, seed, device):
        super().__init__(seed, "cpu")
        self.target = torch.device(device)

    def initial_noise(self, shape):
        return super().initial_noise(shape).to(self.target)

    def step_noise(self, step, shape):
        return super().step_noise(step, shape).to(self.target)

    def cutouts(self, *args):
        d = super().cutouts(*args)
        d.crop = d.crop.to(self.target)
        d.aug = d.aug.map(lambda t: t.to(self.target))
        return d


def tiny_config() -> Config:
    return Config(
        width=64, height=64, num_cutout_batches=2, guidance_dtype="float32",
        clip_guidance_scale=1000.0, denoise_scale=100.0, range_scale=10.0,
        cutout_schedules=CutoutSchedules(
            num_overview_cuts=create_schedule((4, 2), (500, 500)),
            num_inner_cuts=create_schedule((2, 3), (500, 500)),
            inner_cut_size_power=create_schedule((5,), (1000,)),
            cut_gray_portion=create_schedule((0.5,), (1000,)),
        ),
    )


def tiny_models(device) -> ZooModels:
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clip = CLIPModel(tiny_clip_config("tiny"))
    clip.load_state_dict(host_init_state_dict(clip, from_jax.clip_rule, 2, torch.float32))
    return ZooModels(unet.to(device).requires_grad_(False),
                     {"tiny": clip.to(device).requires_grad_(False)})


def check_reference(dev) -> None:
    """A tiny float32 pipeline on the card against the CPU run on the same
    weights and draws.  Differences come from float32 sum order (cuDNN and
    cuBLAS against the CPU kernels) carried through 5 guided steps: atol
    1e-3 on [-1, 1] images."""
    sampler = SamplerConfig(steps=5, eta=0.8)
    outs = {}
    for device in ("cpu", dev):
        pipe = build_pipeline(tiny_models(device), tiny_config(),
                              [("a lighthouse on a cliff", 1.0)], sampler)
        final, frames = guided_sample(pipe, _MovedDraws(7, device))
        outs[str(device)] = frames.float().cpu()
    cpu, gpu = outs["cpu"], outs[str(dev)]
    err = float((cpu - gpu).abs().max())
    if not (torch.isfinite(gpu).all() and err <= 1e-3):
        raise AssertionError(f"tiny pipeline: GPU vs CPU max |diff| {err:.3e}")
    print(f"tiny pipeline GPU vs CPU: frames {tuple(gpu.shape)}, max |diff| {err:.3e}", flush=True)


class _TimingUploader:
    """Records when each progress image is published (every 5 steps)."""

    def __init__(self):
        self.times = []

    def upload(self, path, minutes=10):
        if "progress" in os.path.basename(path):
            self.times.append(time.perf_counter())
        return "file://" + os.path.abspath(path)


def run_main_path(dev, steps: int, out_dir: str) -> dict:
    config = Config(width=512, height=512, num_cutout_batches=4,
                    chosen_clip_models=PERCEPTORS)
    t0 = time.perf_counter()
    models = build_models(config, image_size=512, device=dev)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in models.unet.parameters())
    n_clip = {k: sum(p.numel() for p in m.parameters()) for k, m in models.clips.items()}
    print(f"models built in {time.perf_counter() - t0:.1f} s: UNet {n_unet / 1e6:.1f}M "
          f"(bf16, channel_mult {models.unet.config.channel_mult}), "
          + ", ".join(f"{k} {v / 1e6:.1f}M" for k, v in n_clip.items()), flush=True)

    finite = []  # device booleans, read after the run so the hook adds no sync
    hook = models.unet.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    uploader = _TimingUploader()
    torch.cuda.reset_peak_memory_stats()
    histogram_quantile.launches = 0
    t0 = time.perf_counter()
    result = guided_diffusion_sample(
        prompt=PROMPT,
        steps=steps, seed=1234, config=config, models=models, uploader=uploader,
        output_dir=out_dir,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = histogram_quantile.launches
    peak = torch.cuda.max_memory_allocated()
    hook.remove()

    if launches != steps:
        raise AssertionError(f"histogram_quantile launched {launches} times in {steps} steps")
    if len(finite) != steps or not all(bool(f) for f in finite):
        raise AssertionError(f"UNet outputs finite per step: {[bool(f) for f in finite]}")
    with Image.open(result["images"][0]) as im:
        arr = np.asarray(im.convert("RGB"), np.float32)
    if arr.shape != (512, 512, 3) or arr.std() == 0:
        raise AssertionError(f"final image shape {arr.shape}, std {arr.std()}")
    with Image.open(result["gif_urls"][0].replace("file://", "")) as gif:
        n_frames = gif.n_frames
    if n_frames != 6:
        raise AssertionError(f"GIF has {n_frames} frames")
    step_ms = (uploader.times[1] - uploader.times[0]) / 5 * 1e3 if len(uploader.times) > 1 else None
    print(f"main path: {steps} steps in {wall:.2f} s; steady step {step_ms:.1f} ms "
          f"(positions 1-5); peak memory {peak / 2**30:.2f} GiB; "
          f"histogram_quantile launches {launches}; image {result['images'][0]}", flush=True)
    return {"steps": steps, "wall_s": wall, "step_ms": step_ms, "peak_bytes": peak,
            "launches": {"histogram_quantile": launches}, "models": models, "config": config}


# kernel-name fragments -> class, first match wins (cuDNN, cuBLAS and the
# port's own kernels as the profiler names them)
_KERNEL_CLASSES = (
    ("histogram", "histogram_quantile"),
    ("conv", "convolution"), ("cudnn", "convolution"), ("dgrad", "convolution"),
    ("wgrad", "convolution"), ("fprop", "convolution"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
    ("softmax", "softmax"), ("norm", "normalization"), ("reduce", "reduction"),
)


def _kernel_class(name: str) -> str:
    low = name.lower()
    return next((cls for frag, cls in _KERNEL_CLASSES if frag in low), "elementwise/other")


def profile_steps(dev, models, config, n_steps: int, out_dir: str) -> None:
    """The first `n_steps` guided steps of a 10-step trajectory (the schedule
    phase with the most cutouts), run three times from the same draws: a
    warm-up, a timed run and a run under torch.profiler.  Prints the wall
    time per step without the profiler, the device time per step, the
    device's idle share, device time by kernel class and by direction
    (kernels launched under the autograd engine are the backward, UNet
    recompute included; the port's own kernels, launched through ctypes,
    sit under no PyTorch op and count in neither) and the top kernels.  The
    op table goes to <out_dir>/profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_diffusion_tpu_torch.diffusion.sampling import schedule_tables
    from clip_diffusion_tpu_torch.pipeline.guided import guided_step

    pipe = build_pipeline(models, config, [(PROMPT, 1.0)], SamplerConfig(steps=10))
    tables = schedule_tables(pipe.schedule, dev)
    top = pipe.schedule.num_steps - 1

    def run():
        draws = TorchDraws(99, dev)
        x = draws.initial_noise((1, config.height, config.width, 3))
        for step in range(top, top - n_steps, -1):
            x, _ = guided_step(pipe, tables, x, step, draws)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()

    by_class, by_name = {}, {}
    by_dir = {"forward": 0.0, "backward": 0.0}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms = evt.time_range.elapsed_us() / 1e3 / n_steps
            by_class[_kernel_class(evt.name)] = by_class.get(_kernel_class(evt.name), 0.0) + ms
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        elif evt.kernels:
            parent, backward = evt, False
            while parent is not None and not backward:
                backward = parent.name.startswith("autograd::engine::evaluate_function")
                parent = parent.cpu_parent
            by_dir["backward" if backward else "forward"] += sum(
                k.duration for k in evt.kernels) / 1e3 / n_steps
    device_ms = sum(by_class.values())
    print(f"profile: {n_steps} steps, wall {wall_ms:.1f} ms/step, device {device_ms:.1f} ms/step, "
          f"idle share {1 - device_ms / wall_ms:.3f}", flush=True)
    print("device ms/step by direction: "
          + ", ".join(f"{k} {v:.3f}" for k, v in by_dir.items()), flush=True)
    print("device ms/step by kernel class: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.2f} ms/step  {name[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("card")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN",
          flush=True)

    phase("build")
    build_all()

    phase("kernels")
    records = [check_histogram_quantile(dev)]

    phase("reference")
    check_reference(dev)

    phase("main path")
    main_run = run_main_path(dev, args.steps, args.out)
    for rec in records:
        rec["launches"] = main_run["launches"][rec["name"]]
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was not launched on the main path")
    phase("profile")
    profile_steps(dev, main_run["models"], main_run["config"], 2, args.out)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
