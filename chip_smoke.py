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
4. reference: two tiny pipelines on the card against the same pipelines on
   the CPU, same weights and same draws: the DDIM one with a ViT tower, and
   one with a ResNet tower, an aesthetic head, LPIPS, an init image and
   PLMS;
5. zoo: the full-width models, built once: the 512 ADM UNet (bfloat16,
   random init), the ViT-B/32, ViT-B/16, ViT-L/14 and RN101 perceptors at
   preset widths, the aesthetic heads of the three ViTs and LPIPS.  Each
   path below takes its models from it;
6. main path: `guided_diffusion_sample` at 512x512, DDIM, 10 steps, the
   three ViT perceptors, 4 cutout batches;
7. default request: `guided_diffusion_sample` with the default `Config`:
   768x512, the four perceptors, 4 cutout batches, DDIM, eta 0.8, 10 steps;
8. init-image path: an init PNG made here from a seeded array, PLMS, 20
   steps with 10 skipped, the aesthetic and MS-SSIM terms on and LPIPS at
   its default scale, at 768x512;
9. profile: two steps of each of the three paths timed, then run under
   torch.profiler: device time by kernel class and by direction, the
   device's idle share, and each tower's device time over the step's cuts;
10. latent reference: the tiny float32 latent stack (LDM UNet, VQ, BERT,
    RRDBNet x4) on the card against the same stack on the CPU, same weights
    and draws: a 5-step CFG DDIM txt2img and a 6-step PLMS inpainting, each
    decoded and upscaled x4;
11. latent zoo: the full-width LDM UNet (bfloat16), VQ-f8 (float32) and
    BERT (bfloat16) as `sample.default_latent_stack` builds them, and
    Real-ESRGAN x4 (float32), built once, with their parameter counts;
12. latent request: `latent_diffusion_sample()` with no model arguments
    (256x256, CFG DDIM, 50 steps, eta 0, guidance 5, 3 iterations x 3
    images) and the ESRGAN x4 upscaler: 150 finite UNet forwards at batch
    6, 9 PNGs, the grid and 9 upscales at 1024x1024;
13. inpainting path: an init PNG and a mask PNG made here from seeded
    arrays, PLMS, 20 steps, 1 iteration x 2 images: the kept region's final
    latent must stay nearer the init latent than the free region's;
14. latent profile: two CFG steps of the request timed, then run under
    torch.profiler (device ms per step, idle share, device time by kernel
    class, achieved FLOP/s), the VQ decode's device time, and one ESRGAN x4
    call per image, whole and tiled.

On every path the kernel launch counts are zeroed just before it runs and
read just after: on the guided paths mode B of the quantile kernel once per
executed step, mode A never; on the latent paths neither mode.

Then one JSON line {"kernels": [...]}, the nvidia-smi line again, and as
the last line {"ok": true, "device": {...}}.  TF32 is off throughout, so
float32 comparisons run in full float32.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
from clip_diffusion_tpu_torch.models.aesthetic import LinearAestheticPredictor
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.esrgan import upscale
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.ops import kernels
from clip_diffusion_tpu_torch.ops import quantile as quantile_ops
from clip_diffusion_tpu_torch.ops.quantile import (
    histogram_abs_quantile,
    histogram_abs_quantile_plain,
    histogram_quantile,
    histogram_quantile_plain,
)
from clip_diffusion_tpu_torch.pipeline import guided as guided_mod
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws, guided_sample
from clip_diffusion_tpu_torch.pipeline.latent import decode_latents, img2img_start, latent_sample
from clip_diffusion_tpu_torch.sample import (
    default_latent_stack,
    guided_diffusion_sample,
    latent_diffusion_sample,
)
from clip_diffusion_tpu_torch.utils.image_io import (
    load_image,
    load_mask,
    normalize_image_neg_one_to_one,
)
from clip_diffusion_tpu_torch.zoo import (
    ZooModels,
    build_esrgan,
    build_latent_models,
    build_latent_pipeline,
    build_lpips,
    build_models,
    build_pipeline,
    host_init_state_dict,
)

# Published H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

MAIN_ROW = (1, 786432)  # pred_x0 of one 512x512 RGB image, flattened
DEFAULT_ROW = (1, 1179648)  # ... and of the default 768x512 canvas
QUANTILE = 0.995  # the main path's dynamic_thresholding_percentile
PERCEPTORS = ("ViT-B/32", "ViT-B/16", "ViT-L/14")  # the 512x512 main path's
PROMPT = "A lighthouse on a cliff at golden hour, oil painting."
# parameter counts of the full-width latent stack (the JAX package's eval_shape)
LATENT_PARAMS = {"LDM UNet": 872300484, "VQ-f8": 67717295, "BERT": 542895360,
                 "RRDBNet x4": 16697987}


def phase(name: str, t_start: float) -> None:
    print(f"== {name} (at {time.perf_counter() - t_start:.1f} s)", flush=True)


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


# Both modes of csrc/histogram_quantile.cu: wrapper, plain version, the TPU
# kernel or JAX function it stands for, its bins and the operations per
# element counted for its bound.
QUANTILE_KERNELS = {
    "histogram_quantile": dict(
        fn=histogram_quantile, plain=histogram_quantile_plain, bins=2048, on_path=False,
        replaces="clip_diffusion_tpu/ops/quantile.py:79",
        ops_per_elem=6),  # abs, max, divide, multiply, truncate/clip, count
    "histogram_abs_quantile": dict(
        fn=histogram_abs_quantile, plain=histogram_abs_quantile_plain, bins=4096, on_path=True,
        replaces="clip_diffusion_tpu/ops/quantile.py:29",
        # abs, max; coarse: range test, guess (multiply, convert), about 2
        # edge comparisons, count; fine: 2 range tests, count
        ops_per_elem=11),
}


def quantile_cases(gen, dev):
    """(label, x) pairs: 1 and 4 rows at the main row's length in float32,
    bfloat16 and float16 at three scales, a 4-row case with an all-zero and
    a constant row, the default canvas's (1, 1179648) row in float32, and
    the (16, 786432) float32 case whose 50 MB exceed what the resident grid
    stages in shared memory (the tiled path)."""
    n = MAIN_ROW[1]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for rows in (1, 4):
            for scale in (0.5, 3.0, 40.0):
                x = torch.randn((rows, n), generator=gen, device=dev) * scale
                yield f"({rows}, {n}) {dtype} scale {scale}", x.to(dtype)
        edge = torch.randn((4, n), generator=gen, device=dev)
        edge[1] = 0.0  # all-zero row
        edge[2] = -0.7  # constant row
        yield f"(4, {n}) {dtype} zero/constant rows", edge.to(dtype)
    for scale in (0.5, 3.0):
        yield (f"{DEFAULT_ROW} float32 scale {scale}",
               torch.randn(DEFAULT_ROW, generator=gen, device=dev) * scale)
    yield f"(16, {n}) float32 tiled", torch.randn((16, n), generator=gen, device=dev) * 3.0


def device_us_per_call(fn, name: str, calls: int = 20):
    """torch.profiler over `calls` calls: device microseconds per call of the
    kernels whose name holds `name`, and device operations per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # the first session may drop events
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in dev_events if name in e.name) / calls
    return us, len(dev_events) / calls


def check_quantile_kernel(dev, name: str) -> dict:
    """One mode of the kernel against its plain version on the same device
    inputs, bit for bit (tolerance 0: the same float32 expressions in the
    same order, integer counts), and against torch.quantile within its
    bound max|x| / bins plus 1e-6 * max|x| of rounding.  Then its times at
    the main row (1, 786432) f32, q = 0.995."""
    spec = QUANTILE_KERNELS[name]
    fn, plain, bins = spec["fn"], spec["plain"], spec["bins"]
    gen = torch.Generator(dev).manual_seed(0)
    max_err, n_cases = 0.0, 0
    for label, x in quantile_cases(gen, dev):
        for q in (0.5, 0.995, 1.0):
            got = fn(x, q)
            ref = plain(x, q)
            exact = torch.quantile(x.float().abs(), q, dim=1)
            torch.cuda.synchronize()
            hi = x.float().abs().amax(dim=1).clamp_min(1e-12)
            err = float((got - ref).abs().max())
            if err != 0.0:
                raise AssertionError(f"{name} vs plain: {label} q={q} err {err:.3e}")
            if not bool(torch.all((got - exact).abs() <= hi / bins + 1e-6 * hi)):
                raise AssertionError(f"{name} vs torch.quantile: {label} q={q}")
            max_err = max(max_err, err)
            n_cases += 1
    print(f"{name}: {n_cases} cases equal the plain version bit for bit "
          f"(max |kernel - plain| = {max_err:.3e}), within max|x|/{bins} of torch.quantile",
          flush=True)

    x = torch.randn(MAIN_ROW, generator=gen, device=dev) * 3.0
    grid = ctypes.c_int()
    quantile_ops._launch(x, QUANTILE, bins, name == "histogram_abs_quantile", grid)
    ms = cuda_ms(lambda: fn(x, QUANTILE))
    plain_ms = cuda_ms(lambda: plain(x, QUANTILE))
    library_ms = cuda_ms(lambda: torch.quantile(x.abs(), QUANTILE, dim=1))
    device_us, ops_per_call = device_us_per_call(lambda: fn(x, QUANTILE), name + "_kernel")
    if spec["on_path"]:  # the default canvas's row too
        xd = torch.randn(DEFAULT_ROW, generator=gen, device=dev) * 3.0
        d_us, _ = device_us_per_call(lambda: fn(xd, QUANTILE), name + "_kernel")
        print(f"{name} {DEFAULT_ROW} f32 q={QUANTILE}: as called "
              f"{cuda_ms(lambda: fn(xd, QUANTILE)):.4f} ms, device {d_us:.2f} us/call, "
              f"bound {(4 * DEFAULT_ROW[1] + 4) / HBM_BYTES_PER_S * 1e3:.5f} ms", flush=True)
    rows, n = MAIN_ROW
    bytes_moved = 4 * rows * n + 4 * rows  # x read once, (B,) written once
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = spec["ops_per_elem"] * rows * n / F32_OPS_PER_S * 1e3
    print(f"{name} {MAIN_ROW} f32 q={QUANTILE}: as called {ms:.4f} ms, device "
          f"{device_us:.2f} us/call in {ops_per_call:.2f} device ops/call, grid {grid.value} "
          f"blocks; plain {plain_ms:.4f} ms, torch.quantile {library_ms:.4f} ms, bound "
          f"{max(bound_bytes, bound_ops):.5f} ms", flush=True)
    return {
        "name": name, "route": "cuda",
        "source": "clip_diffusion_tpu_torch/csrc/histogram_quantile.cu",
        "replaces": spec["replaces"],
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": library_ms, "device_ms": device_us / 1e3,
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

    def inpaint_noise(self, step, shape):
        return super().inpaint_noise(step, shape).to(self.target)

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


def tiny_init_models(device) -> ZooModels:
    """The tiny UNet, a tiny ResNet tower with a linear aesthetic head on
    its 64-d embedding, and LPIPS at its full VGG16 widths."""
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clip = CLIPModel(tiny_clip_config("tinyrn", resnet=True))
    clip.load_state_dict(host_init_state_dict(clip, from_jax.clip_rule, 3, torch.float32))
    head = LinearAestheticPredictor(64)
    head.load_state_dict(host_init_state_dict(head, from_jax.aesthetic_rule, 4, torch.float32))
    return ZooModels(unet.to(device).requires_grad_(False),
                     {"tinyrn": clip.to(device).requires_grad_(False)},
                     {"tinyrn": head.to(device).requires_grad_(False)},
                     build_lpips(device=device))


def check_reference(dev) -> None:
    """Two tiny float32 pipelines on the card against the CPU runs on the
    same weights and draws: 5 DDIM steps with a ViT tower, and 5 PLMS steps
    (7 with 2 skipped) from an init image with a ResNet tower, its aesthetic
    head and LPIPS.  Differences come from float32 sum order (cuDNN and
    cuBLAS against the CPU kernels) carried through 5 guided steps: atol
    1e-3 on [-1, 1] images."""
    init = np.random.default_rng(5).uniform(-1, 1, (1, 8, 8, 3))
    init = torch.from_numpy(np.repeat(np.repeat(init, 8, 1), 8, 2).astype(np.float32))
    cases = (
        ("tiny DDIM pipeline", tiny_models, tiny_config(), SamplerConfig(steps=5, eta=0.8),
         None),
        ("tiny init-image PLMS pipeline (ResNet tower, aesthetic head, LPIPS)",
         tiny_init_models, dataclasses.replace(tiny_config(), aesthetic_scale=300.0),
         SamplerConfig(mode="plms", steps=7, skip_timesteps=2), init),
    )
    for label, models_fn, config, sampler, init_image in cases:
        outs = {}
        for device in ("cpu", dev):
            pipe = build_pipeline(models_fn(device), config,
                                  [("a lighthouse on a cliff", 1.0)], sampler,
                                  use_init_losses=init_image is not None)
            final, frames = guided_sample(pipe, _MovedDraws(7, device), init_image=init_image)
            outs[str(device)] = frames.float().cpu()
        cpu, gpu = outs["cpu"], outs[str(dev)]
        err = float((cpu - gpu).abs().max())
        if not (torch.isfinite(gpu).all() and err <= 1e-3):
            raise AssertionError(f"{label}: GPU vs CPU max |diff| {err:.3e}")
        print(f"{label} GPU vs CPU: frames {tuple(gpu.shape)}, max |diff| {err:.3e}",
              flush=True)


class _TimingUploader:
    """Records when each progress image is published (every 5 steps)."""

    def __init__(self):
        self.times = []

    def upload(self, path, minutes=10):
        if "progress" in os.path.basename(path):
            self.times.append(time.perf_counter())
        return "file://" + os.path.abspath(path)


def _param_count(module) -> int:
    return sum(p.numel() for p in module.parameters())


def _zero_launches() -> None:
    histogram_quantile.launches = 0
    histogram_abs_quantile.launches = 0


def build_zoo(dev) -> ZooModels:
    """Every full-width model the paths use, built once."""
    t0 = time.perf_counter()
    zoo = build_models(Config(), image_size=512, with_aesthetic=True, with_lpips=True,
                       device=dev)
    torch.cuda.synchronize()
    count = _param_count
    print(f"models built in {time.perf_counter() - t0:.1f} s: UNet {count(zoo.unet) / 1e6:.1f}M "
          f"(bf16, channel_mult {zoo.unet.config.channel_mult}), "
          + ", ".join(f"{k} {count(v) / 1e6:.1f}M" for k, v in zoo.clips.items())
          + "; aesthetic heads " + ", ".join(f"{k} {count(v)}" for k, v in zoo.aesthetic.items())
          + f" (f32); LPIPS {count(zoo.lpips) / 1e6:.2f}M (f32)", flush=True)
    return zoo


def zoo_subset(zoo: ZooModels, names, with_extras: bool = False) -> ZooModels:
    """The zoo's UNet and the named towers; their aesthetic heads and LPIPS
    only `with_extras`."""
    return ZooModels(zoo.unet, {n: zoo.clips[n] for n in names},
                     {n: h for n, h in zoo.aesthetic.items() if n in names} if with_extras else {},
                     zoo.lpips if with_extras else None)


def run_path(label: str, models: ZooModels, executed: int, shape, out_dir: str,
             **kwargs) -> dict:
    """`guided_diffusion_sample(**kwargs)` on `models`, with the kernel
    counts zeroed just before and read just after; checks mode B once per
    executed step and mode A never, finite UNet outputs every step, a final
    PNG of `shape` that is not flat and a 6-frame GIF."""
    finite = []  # device booleans, read after the run so the hook adds no sync
    hook = models.unet.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    uploader = _TimingUploader()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        result = guided_diffusion_sample(prompt=PROMPT, seed=1234, models=models,
                                         uploader=uploader, output_dir=out_dir, **kwargs)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = {"histogram_quantile": histogram_quantile.launches,
                "histogram_abs_quantile": histogram_abs_quantile.launches}
    peak = torch.cuda.max_memory_allocated()

    if launches != {"histogram_quantile": 0, "histogram_abs_quantile": executed}:
        raise AssertionError(f"{label}: quantile kernel launches in {executed} steps: {launches}")
    if len(finite) != executed or not all(bool(f) for f in finite):
        raise AssertionError(f"{label}: UNet outputs finite per step: {[bool(f) for f in finite]}")
    with Image.open(result["images"][0]) as im:
        arr = np.asarray(im.convert("RGB"), np.float32)
    if arr.shape != shape or arr.std() == 0:
        raise AssertionError(f"{label}: final image shape {arr.shape}, std {arr.std()}")
    with Image.open(result["gif_urls"][0].replace("file://", "")) as gif:
        n_frames = gif.n_frames
    if n_frames != 6:
        raise AssertionError(f"{label}: GIF has {n_frames} frames")
    step_ms = (uploader.times[1] - uploader.times[0]) / 5 * 1e3 if len(uploader.times) > 1 else None
    print(f"{label}: {executed} steps in {wall:.2f} s; steady step {step_ms:.1f} ms "
          f"(positions 1-5); peak memory {peak / 2**30:.2f} GiB; "
          f"quantile kernel launches {launches}; image {result['images'][0]}", flush=True)
    return {"steps": executed, "wall_s": wall, "step_ms": step_ms, "peak_bytes": peak,
            "launches": launches}


def run_init_path(zoo: ZooModels, out_dir: str) -> dict:
    """The init-image path at 768x512: PLMS, 20 steps with 10 skipped, the
    aesthetic heads of the three ViTs, MS-SSIM and LPIPS.  Hooks count, per
    executed step, the LPIPS, MS-SSIM and aesthetic-head evaluations."""
    config = Config(aesthetic_scale=500.0, MS_SSIM_scale=1000.0)  # LPIPS_scale: default 1000
    rng = np.random.default_rng(11)
    coarse = rng.uniform(0, 255, (config.height // 32, config.width // 32, 3))
    init_png = os.path.join(out_dir, "init.png")
    os.makedirs(out_dir, exist_ok=True)
    Image.fromarray(np.repeat(np.repeat(coarse, 32, 0), 32, 1).astype(np.uint8)).save(init_png)

    models = zoo_subset(zoo, Config().chosen_clip_models, with_extras=True)
    step_of = []  # the UNet's forward marks each step
    seen = {"lpips": set(), "ms_ssim": set(), **{f"aesthetic {n}": set() for n in models.aesthetic}}
    hooks = [models.unet.register_forward_hook(lambda *a: step_of.append(len(step_of)))]
    hooks.append(models.lpips.register_forward_hook(
        lambda *a: seen["lpips"].add(len(step_of))))
    for name, head in models.aesthetic.items():
        hooks.append(head.register_forward_hook(
            lambda *a, key=f"aesthetic {name}": seen[key].add(len(step_of))))
    ms_ssim = guided_mod.structural_dissimilarity_loss

    def counted_ms_ssim(*args):
        seen["ms_ssim"].add(len(step_of))
        return ms_ssim(*args)

    guided_mod.structural_dissimilarity_loss = counted_ms_ssim
    sampler = SamplerConfig(mode="plms", steps=20, skip_timesteps=10)
    try:
        run = run_path("init-image path", models, 10, (config.height, config.width, 3), out_dir,
                       init_image=init_png, sample_mode=sampler.mode, steps=sampler.steps,
                       skip_timesteps=sampler.skip_timesteps, config=config)
    finally:
        guided_mod.structural_dissimilarity_loss = ms_ssim
        for h in hooks:
            h.remove()
    every = set(range(1, 11))
    missing = {k: sorted(every - v) for k, v in seen.items() if v != every}
    if missing:
        raise AssertionError(f"init-image path: terms not computed at steps {missing}")
    print("init-image path: LPIPS, MS-SSIM and the aesthetic heads of "
          + ", ".join(models.aesthetic) + " computed at each of the 10 steps", flush=True)
    return dict(run, models=models, config=config, init_png=init_png, sampler=sampler)


# kernel-name fragments -> class, first match wins (cuDNN, cuBLAS and the
# port's own kernels as the profiler names them)
_KERNEL_CLASSES = (
    ("histogram_abs_quantile", "histogram_abs_quantile"),
    ("histogram_quantile", "histogram_quantile"),
    ("conv", "convolution"), ("cudnn", "convolution"), ("dgrad", "convolution"),
    ("wgrad", "convolution"), ("fprop", "convolution"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
    ("softmax", "softmax"), ("norm", "normalization"), ("reduce", "reduction"),
)


def _kernel_class(name: str) -> str:
    low = name.lower()
    return next((cls for frag, cls in _KERNEL_CLASSES if frag in low), "elementwise/other")


def profile_steps(dev, label: str, models, config, n_steps: int, out_dir: str,
                  sampler: SamplerConfig = SamplerConfig(steps=10), init_png=None) -> None:
    """The first `n_steps` executed guided steps of `sampler`'s trajectory
    (by default a 10-step DDIM one, whose first steps are the schedule phase
    with the most cutouts; with `init_png`, from that init image with its
    LPIPS and MS-SSIM terms), run three times from the same draws: a
    warm-up, a timed run and a run under torch.profiler.  Prints the wall
    time per step without the profiler, the device time per step, the
    device's idle share, device time by kernel class and by direction
    (kernels launched under the autograd engine are the backward, UNet
    recompute included; the port's own kernels, launched through ctypes,
    sit under no PyTorch op and count in neither) and the top kernels; then
    each tower's forward and backward over the first step's cut count, in
    chunks of `clip_cut_chunk`, run alone under the profiler, and its
    device time's share of the step's.  The op table goes to
    <out_dir>/profile_<label>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_diffusion_tpu_torch.diffusion.sampling import init_history, q_sample, schedule_tables
    from clip_diffusion_tpu_torch.pipeline.guided import PLMSHistory, guided_step, schedule_index
    from clip_diffusion_tpu_torch.utils.image_io import load_image, normalize_image_neg_one_to_one

    init = None
    if init_png is not None:
        init = torch.from_numpy(normalize_image_neg_one_to_one(
            load_image(init_png, (config.width, config.height))))[None].to(dev)
    pipe = build_pipeline(models, config, [(PROMPT, 1.0)], sampler,
                          use_init_losses=init is not None)
    tables = schedule_tables(pipe.schedule, dev)
    top = pipe.schedule.num_steps - sampler.skip_timesteps - 1
    shape = (1, config.height, config.width, 3)

    def run():
        draws = TorchDraws(99, dev)
        x = draws.initial_noise(shape)
        if init is not None:
            x = q_sample(init.expand(shape), tables, top, x)
        history = PLMSHistory(init_history(shape, dev)) if sampler.mode == "plms" else None
        for step in range(top, top - n_steps, -1):
            x, _ = guided_step(pipe, tables, x, step, draws, init, history)
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
    print(f"profile [{label}] {config.width}x{config.height}: {n_steps} steps, wall "
          f"{wall_ms:.1f} ms/step, device {device_ms:.1f} ms/step, "
          f"idle share {1 - device_ms / wall_ms:.3f}", flush=True)
    print(f"[{label}] device ms/step by direction: "
          + ", ".join(f"{k} {v:.3f}" for k, v in by_dir.items()), flush=True)
    print(f"[{label}] device ms/step by kernel class: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.2f} ms/step  {name[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))

    ov_t, in_t, _, _ = config.cutout_schedules.as_arrays()
    idx = schedule_index(pipe.schedule, top)
    n_cuts = (int(ov_t[idx]) + int(in_t[idx])) * config.num_cutout_batches
    chunk = config.clip_cut_chunk or n_cuts
    gen = torch.Generator(dev).manual_seed(3)
    for name, model in models.clips.items():
        res = model.cfg.image_resolution
        cuts = torch.randn((n_cuts, res, res, 3), generator=gen, device=dev).to(
            config.guidance_torch_dtype)

        def tower_pass(model=model, cuts=cuts):
            for i in range(0, n_cuts, chunk):
                leaf = cuts[i:i + chunk].detach().requires_grad_(True)
                with torch.enable_grad():
                    torch.autograd.grad(model.encode_image(leaf).sum(), leaf)

        us, _ = device_us_per_call(tower_pass, "", calls=3)
        print(f"[{label}] tower {name}: forward+backward of {n_cuts} cuts at {res}^2 in chunks "
              f"of {chunk}: device {us / 1e3:.1f} ms, {us / 1e3 / device_ms:.3f} of the "
              f"profiled device ms/step", flush=True)


def _check_no_launches(label: str) -> None:
    """The latent paths reach no port kernel: both quantile modes at 0."""
    launches = {"histogram_quantile": histogram_quantile.launches,
                "histogram_abs_quantile": histogram_abs_quantile.launches}
    if any(launches.values()):
        raise AssertionError(f"{label}: quantile kernel launched {launches}")
    print(f"{label}: quantile kernel launches {launches}", flush=True)


def check_latent_reference(dev) -> None:
    """The tiny float32 latent stack (f2 VQ, 32x32 images, 16x16 latents)
    on the card against the CPU on the same weights and draws: a 5-step CFG
    DDIM txt2img and a 6-step PLMS inpainting of the top half of an
    encoded init image, each decoded and upscaled x4.  Differences come from
    float32 sum order (cuDNN and cuBLAS against the CPU kernels): atol 1e-3
    on [0, 1] images."""
    coarse = np.random.default_rng(6).uniform(-1, 1, (1, 4, 4, 3))
    init = torch.from_numpy(np.repeat(np.repeat(coarse, 8, 1), 8, 2).astype(np.float32))
    runs = []
    for device in (torch.device("cpu"), dev):
        pipe, text_encode = build_latent_pipeline(
            build_latent_models(tiny=True, param_dtype=torch.float32, device=device))
        esrgan = build_esrgan(tiny=True, device=device)
        ctx_c, ctx_u = text_encode([PROMPT] * 2), text_encode([""] * 2)
        x0 = img2img_start(pipe, init.to(device)).repeat(2, 1, 1, 1)
        mask = torch.zeros((2, 16, 16, 1), device=device)
        mask[:, :8] = 1.0
        txt = decode_latents(pipe, latent_sample(
            pipe, _MovedDraws(7, device), ctx_c, ctx_u, batch_size=2, height=32, width=32,
            steps=5))
        inp = decode_latents(pipe, latent_sample(
            pipe, _MovedDraws(8, device), ctx_c, ctx_u, batch_size=2, height=32, width=32,
            steps=6, mode="plms", x0_latent=x0, mask=mask))
        runs.append({"txt2img": txt, "txt2img x4": upscale(esrgan, txt),
                     "inpainting": inp, "inpainting x4": upscale(esrgan, inp)})
    for name, cpu in runs[0].items():
        gpu = runs[1][name].float().cpu()
        err = float((cpu - gpu).abs().max())
        if not (torch.isfinite(gpu).all() and err <= 1e-3):
            raise AssertionError(f"tiny latent {name}: GPU vs CPU max |diff| {err:.3e}")
        print(f"tiny latent {name} GPU vs CPU: {tuple(gpu.shape)}, max |diff| {err:.3e}",
              flush=True)


def build_latent_zoo(dev):
    """The default latent stack, as `latent_diffusion_sample` builds it with
    no model arguments, and ESRGAN x4; checks the parameter counts."""
    t0 = time.perf_counter()
    pipe, text_encode = default_latent_stack(dev)
    esrgan = build_esrgan(4, device=dev)
    torch.cuda.synchronize()
    counts = {"LDM UNet": _param_count(pipe.unet), "VQ-f8": _param_count(pipe.decode.__self__),
              "BERT": _param_count(text_encode.bert), "RRDBNet x4": _param_count(esrgan)}
    if counts != LATENT_PARAMS:
        raise AssertionError(f"latent parameter counts {counts}, expected {LATENT_PARAMS}")
    print(f"latent models built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:,}" for k, v in counts.items())
          + " parameters (UNet and BERT bf16, VQ and RRDBNet f32)", flush=True)
    return pipe, text_encode, esrgan


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32)


def run_latent_request(dev, pipe, esrgan, out_dir: str) -> dict:
    """`latent_diffusion_sample()` at its defaults, with no model arguments
    (the stack cached by `build_latent_zoo`) and the ESRGAN x4 upscaler.
    Hooks (no sync on the UNet) record every UNet forward's batch and
    finiteness and its host time; the VQ decoder's `post_quant_conv` and
    `decoder` and the upscaler synchronize around themselves, so each
    iteration's sampling time runs from its first UNet forward to its
    decode, which waits for the device."""
    vq = pipe.decode.__self__
    forwards, finite, batches = [], [], []
    dec = {"start": [], "end": []}
    up_s = []

    def on_unet(mod, inp, out):
        finite.append(torch.isfinite(out).all())
        batches.append(out.shape[0])

    def mark(key):
        def hook(*args):
            torch.cuda.synchronize()
            dec[key].append(time.perf_counter())
        return hook

    def timed_upscale(images01):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = upscale(esrgan, images01)
        torch.cuda.synchronize()
        up_s.append(time.perf_counter() - t0)
        return out

    hooks = [pipe.unet.register_forward_pre_hook(lambda *a: forwards.append(time.perf_counter())),
             pipe.unet.register_forward_hook(on_unet),
             vq.post_quant_conv.register_forward_pre_hook(mark("start")),
             vq.decoder.register_forward_hook(mark("end"))]
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        result = latent_diffusion_sample(seed=1234, upscaler=timed_upscale, output_dir=out_dir,
                                         device=dev)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check_no_launches("latent request")

    steps, iters, images = 50, 3, 9
    if len(finite) != steps * iters or set(batches) != {6} or not all(bool(f) for f in finite):
        raise AssertionError(f"latent request: {len(finite)} UNet forwards at batches "
                             f"{set(batches)}, finite {sum(bool(f) for f in finite)}")
    paths = result["images"]
    stds = [float(_png(p).std()) for p in paths]
    shapes = {_png(p).shape for p in paths}
    if len(paths) != images or shapes != {(256, 256, 3)} or min(stds) == 0:
        raise AssertionError(f"latent request: {len(paths)} images, shapes {shapes}, stds {stds}")
    grid = _png(result["grid_url"].replace("file://", ""))
    sr = [os.path.join(os.path.dirname(p), "sr", os.path.basename(p)) for p in paths]
    sr_shapes = {_png(p).shape for p in sr}
    if sr_shapes != {(1024, 1024, 3)}:
        raise AssertionError(f"latent request: SR shapes {sr_shapes}")
    sample_s = [dec["start"][k] - forwards[k * steps] for k in range(iters)]
    decode_s = [e - b for b, e in zip(dec["start"], dec["end"])]
    step_ms = min(sample_s) / steps * 1e3
    print(f"latent request: {iters} iterations x 3 images, {len(finite)} UNet forwards at batch "
          f"6, all finite; wall {wall:.2f} s; sampling per iteration "
          + ", ".join(f"{x:.3f}" for x in sample_s) + f" s (steady {step_ms:.2f} ms/step); "
          f"VQ decode of 3 images " + ", ".join(f"{x * 1e3:.1f}" for x in decode_s)
          + f" ms; ESRGAN x4 per image min {min(up_s) * 1e3:.1f} ms, mean "
          f"{np.mean(up_s) * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB; grid "
          f"{grid.shape}; {len(sr)} SR PNGs at 1024x1024; image stds "
          + ", ".join(f"{x:.1f}" for x in stds), flush=True)
    return {"wall_s": wall, "step_ms": step_ms, "peak_bytes": peak}


def run_inpainting_path(dev, pipe, text_encode, out_dir: str) -> None:
    """`latent_diffusion_sample` inpainting: an init PNG (seeded 8x8 blocks)
    and a mask PNG (white top half: keep), PLMS, 20 steps, 1 iteration x 2
    images, on the zoo's stack with its decode wrapped to keep the final
    latents.  The kept region must end nearer the init latent than the free
    region (mean |z - z_init|)."""
    os.makedirs(out_dir, exist_ok=True)
    coarse = np.random.default_rng(12).uniform(0, 255, (8, 8, 3))
    init_png = os.path.join(out_dir, "init.png")
    Image.fromarray(np.repeat(np.repeat(coarse, 32, 0), 32, 1).astype(np.uint8)).save(init_png)
    mask_png = os.path.join(out_dir, "mask.png")
    mask_arr = np.zeros((256, 256), np.uint8)
    mask_arr[:128] = 255
    Image.fromarray(mask_arr, "L").save(mask_png)

    finals = []

    def keep_latents(z):
        finals.append(z.clone())
        return pipe.decode(z)

    finite = []
    hook = pipe.unet.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    _zero_launches()
    t0 = time.perf_counter()
    try:
        result = latent_diffusion_sample(
            prompt=PROMPT, seed=77, init_image=init_png, mask_image=mask_png,
            sample_mode="plms", diffusion_steps=20, num_iterations=1, num_batches=2,
            pipe=dataclasses.replace(pipe, decode=keep_latents), text_encode=text_encode,
            output_dir=out_dir, device=dev)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    _check_no_launches("inpainting path")
    if len(finite) != 20 or not all(bool(f) for f in finite) or len(result["images"]) != 2:
        raise AssertionError(f"inpainting path: {len(finite)} forwards, "
                             f"{len(result['images'])} images")
    init = normalize_image_neg_one_to_one(load_image(init_png, (256, 256)))
    z_init = img2img_start(pipe, torch.from_numpy(init)[None].to(dev))[0]
    mask = torch.from_numpy(load_mask(mask_png, (32, 32))).to(dev)
    dist = (finals[0] - z_init).abs().mean(dim=-1, keepdim=True)  # (2, 32, 32, 1)
    kept = float((dist * mask).sum() / (mask.sum() * 2))
    free = float((dist * (1 - mask)).sum() / ((1 - mask).sum() * 2))
    if not kept < free:
        raise AssertionError(f"inpainting path: kept region {kept:.4f} not nearer the init "
                             f"latent than the free region {free:.4f}")
    print(f"inpainting path: PLMS 20 steps x 2 images in {wall:.2f} s; mean |z - z_init| "
          f"kept {kept:.4f}, free {free:.4f} (mask keeps {int(mask.sum())} of 1024 latent "
          f"pixels); images {result['images']}", flush=True)


def profile_latent(dev, pipe, text_encode, esrgan, out_dir: str) -> None:
    """Two CFG DDIM steps of the latent request (3 images, UNet batch 6)
    timed after a warm-up, then under torch.profiler: device ms per step,
    idle share, device time by kernel class, top kernels, and the UNet
    forward's FLOPs (torch's FlopCounterMode: matmuls and convs) over its
    device time.  Then the VQ decode of the 3 latents, the BERT at batch 3
    and one ESRGAN x4 call on one 256x256 image (whole and in 128 px
    tiles), each alone under the profiler, with their FLOPs counted the
    same way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    ctx_c, ctx_u = text_encode([PROMPT] * 3), text_encode([""] * 3)

    def two_steps():
        z = latent_sample(pipe, TorchDraws(5, dev), ctx_c, ctx_u, batch_size=3, steps=2)
        torch.cuda.synchronize()
        return z

    z = two_steps()
    t0 = time.perf_counter()
    two_steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        two_steps()
    by_class, by_name = {}, {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms = evt.time_range.elapsed_us() / 1e3 / 2
            cls = _kernel_class(evt.name)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
    device_ms = sum(by_class.values())

    def count_flops(fn) -> int:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops()

    flops = count_flops(lambda: pipe.unet(torch.zeros((6, 32, 32, 4), device=dev),
                                          torch.full((6,), 981.0, device=dev),
                                          torch.cat([ctx_u, ctx_c])))
    print(f"latent profile 256x256 (3 images, UNet batch 6): wall {wall_ms:.2f} ms/step, device "
          f"{device_ms:.2f} ms/step, idle share {1 - device_ms / wall_ms:.3f}; UNet forward "
          f"{flops / 1e12:.3f} TFLOP (matmuls and convs), {flops / device_ms / 1e9:.1f} "
          f"TFLOP/s over the step's device time", flush=True)
    print("[latent] device ms/step by kernel class: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms/step  {name[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_latent.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))

    dec_us, dec_ops = device_us_per_call(lambda: decode_latents(pipe, z), "", calls=3)
    bert_us, _ = device_us_per_call(lambda: text_encode([PROMPT] * 3), "", calls=3)
    img = decode_latents(pipe, z)[:1].contiguous()
    whole_us, _ = device_us_per_call(lambda: upscale(esrgan, img), "", calls=3)
    tiled_us, _ = device_us_per_call(lambda: upscale(esrgan, img, tile=128), "", calls=3)
    dec_flops = count_flops(lambda: decode_latents(pipe, z))
    bert_flops = count_flops(lambda: text_encode([PROMPT] * 3))
    sr_flops = count_flops(lambda: upscale(esrgan, img))

    def rate(n, us):
        return f"{n / 1e12:.3f} TFLOP, {n / us / 1e6:.1f} TFLOP/s"

    print(f"latent profile: VQ decode of 3 latents (32x32x4 -> 256x256) device "
          f"{dec_us / 1e3:.2f} ms in {dec_ops:.0f} device ops ({rate(dec_flops, dec_us)}); "
          f"BERT at batch 3 device {bert_us / 1e3:.2f} ms ({rate(bert_flops, bert_us)}); "
          f"ESRGAN x4 of one 256x256 image device {whole_us / 1e3:.2f} ms whole "
          f"({rate(sr_flops, whole_us)}), {tiled_us / 1e3:.2f} ms in 128 px tiles", flush=True)


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

    phase("card", t_start)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN",
          flush=True)

    phase("build", t_start)
    build_all()

    phase("kernels", t_start)
    records = [check_quantile_kernel(dev, name) for name in QUANTILE_KERNELS]

    phase("reference", t_start)
    check_reference(dev)

    phase("latent reference", t_start)
    check_latent_reference(dev)

    phase("zoo", t_start)
    zoo = build_zoo(dev)

    phase("main path", t_start)
    main_config = Config(width=512, height=512, num_cutout_batches=4,
                         chosen_clip_models=PERCEPTORS)
    main_models = zoo_subset(zoo, PERCEPTORS)
    main_run = run_path("main path", main_models, args.steps, (512, 512, 3),
                        os.path.join(args.out, "main"), steps=args.steps, config=main_config)
    for rec in records:
        rec["launches"] = main_run["launches"][rec["name"]]
        if QUANTILE_KERNELS[rec["name"]]["on_path"] and rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was not launched on the main path")

    phase("default request", t_start)
    default = Config()
    default_models = zoo_subset(zoo, default.chosen_clip_models)
    run_path("default request", default_models, args.steps, (default.height, default.width, 3),
             os.path.join(args.out, "default"), steps=args.steps)  # no config: Config()

    phase("init-image path", t_start)
    init_run = run_init_path(zoo, os.path.join(args.out, "init"))

    phase("profile", t_start)
    profile_steps(dev, "main", main_models, main_config, 2, args.out)
    profile_steps(dev, "default", default_models, default, 2, args.out)
    profile_steps(dev, "init", init_run["models"], init_run["config"], 2, args.out,
                  init_run["sampler"], init_run["init_png"])

    phase("latent zoo", t_start)
    latent_pipe, text_encode, esrgan = build_latent_zoo(dev)

    phase("latent request", t_start)
    run_latent_request(dev, latent_pipe, esrgan, os.path.join(args.out, "latent"))

    phase("inpainting path", t_start)
    run_inpainting_path(dev, latent_pipe, text_encode, os.path.join(args.out, "inpaint"))

    phase("latent profile", t_start)
    profile_latent(dev, latent_pipe, text_encode, esrgan, args.out)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
