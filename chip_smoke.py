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
   with CUDA-event timings and the bound the card could reach; the LDM
   UNet's fused attention (csrc/ldm_attention.cu) at every shape the SDXL
   and txt2img-f8-large UNets send it, it and the plain body each against
   a float32 evaluation (the kernel's error no larger), its time as called
   and on the device, its bound (FLOPs at 989 TFLOP/s, exponentials at the
   MUFU rate), the plain body's time and scaled_dot_product_attention's as
   the library yardstick (the port never calls it);
4. reference: two tiny pipelines on the card against the same pipelines on
   the CPU, same weights and same draws: the DDIM one with a ViT tower, and
   one with a ResNet tower, an aesthetic head, LPIPS, an init image and
   PLMS; whole trajectories with the exact threshold, and with mode B's
   (the kernel) at batch 2 one step at a time from the card's state, each
   within 1e-3;
5. zoo: the full-width models, built once: the 512 ADM UNet (bfloat16,
   random init), the ViT-B/32, ViT-B/16, ViT-L/14 and RN101 perceptors at
   preset widths, the aesthetic heads of the three ViTs and LPIPS.  Each
   path below takes its models from it;
6. checkpoints: the main path's UNet (557,973,638 parameters, attention
   weights re-shaped to the release's Conv1d) and its three ViT towers
   written in bf16 as public-release files (1,286,488,198 parameters), then
   `build_models(checkpoint_root=...)` from them: every parameter equal to
   the in-memory zoo's, the four slots in `weights_provenance()["loaded"]`,
   a truncated file and a JAX orbax slot without the port's file raising;
   the bytes, load seconds and GB/s;
7. main path: `guided_diffusion_sample` at 512x512, DDIM, 10 steps, the
   three ViT perceptors, 4 cutout batches;
8. default request: `guided_diffusion_sample` with the default `Config`:
   768x512, the four perceptors, 4 cutout batches, DDIM, eta 0.8, 10 steps;
   then the four bf16 towers' chunks replayed from their CUDA graphs
   against the eager body bit for bit (24 cuts: chunks of 16 and 8), and
   the replays of one traced guided step at each step's cut count;
9. init-image path: an init PNG made here from a seeded array, PLMS, 20
   steps with 10 skipped, the aesthetic and MS-SSIM terms on and LPIPS at
   its default scale, at 768x512;
10. text front end: the shipped modifier bank's full-width sentence-T5
   (float32) on the card embeds the 120 modifier names within 1e-4 of
   data/banks/modifiers_t5.npy, each retrieving its own row; the zoo's
   bf16 ViT-B/16 and ViT-L/14 text towers embed the style and media names
   at cosine >= 0.999 to their banks, each retrieving its own row; a
   full-width MarianMT (opus-mt-zh-en, seeded random init, float32) on the
   card against the same model on the CPU: teacher-forced logits of 3
   Chinese prompts within 1e-3 of their scale, greedy ids to 64 tokens
   equal (a difference must be a printed near-tie); `guided_diffusion_
   sample` with a Traditional-Chinese prompt and 2 auto-modifiers on the
   main path's towers and canvas, its `new_prompt` predicted apart; the
   analyzer (ViT-B/16 + ViT-L/14) on the main path's image; CLIP scores of
   that image and of a 2-prompt suite sampled at 256x256 for 5 steps;
11. server: `ClipDiffusionServer` on the main path's zoo and config with a
   registry that discovers a custom finetune (the UNet file with one
   weight scaled) as `guided_unet_custom_landscape.pt`, driven over HTTP:
   /seed, /model_types (landscape and 景觀 listed), two 10-step
   /guided_sample requests (the default UNet, then model_type 景觀; a
   second POST while busy answers 409), /task_state polled to the end, the
   progress PNG fetched through /files/, the images differing and the zoo's
   UNet bit-identical afterwards, 400 for an unknown model_type, and
   /analyze_image on the first image; each request's wall seconds, the
   analyze latency over HTTP and mode B's launches per request;
12. profile: two steps of the main path timed, then run under
   torch.profiler: device time by kernel class and by direction, the
   device's idle share, and each tower's device time over the step's cuts
   (the tools phase's profile_step gives each cutout phase's step cost on the
   main path and the default request);
13. latent reference: the tiny float32 latent stack (LDM UNet, VQ, BERT,
    RRDBNet x4) on the card against the same stack on the CPU, same weights
    and draws: a 5-step CFG DDIM txt2img and a 6-step PLMS inpainting, each
    decoded and upscaled x4;
14. latent zoo: the full-width LDM UNet (bfloat16), VQ-f8 (float32) and
    BERT (bfloat16) as `sample.default_latent_stack` builds them, and
    Real-ESRGAN x4 (float32), built once, with their parameter counts;
15. latent request: `latent_diffusion_sample()` with no model arguments
    (256x256, CFG DDIM, 50 steps, eta 0, guidance 5, 3 iterations x 3
    images) and the ESRGAN x4 upscaler: 150 finite UNet forwards at batch
    6, 9 PNGs, the grid and 9 upscales at 1024x1024;
16. inpainting path: an init PNG and a mask PNG made here from seeded
    arrays, PLMS, 20 steps, 1 iteration x 2 images: the kept region's final
    latent must stay nearer the init latent than the free region's;
17. latent profile: two CFG steps of the request timed, then run under
    torch.profiler (device ms per step, idle share, device time by kernel
    class, achieved FLOP/s), the VQ decode's device time, and one ESRGAN x4
    call per image, whole and tiled;
18. batch serving, in a process group of one rank on NCCL:
    `serve_guided_batch` on the main path's towers and config, 2 prompts x
    2 seeds, 5 DDIM steps (4 finite images, the two seeds of a prompt
    different, peak memory), and `serve_latent_batch` on the default latent
    stack, 3 prompts x 3 seeds, CFG DDIM, 10 steps, decoded (9 finite
    images in [0, 1]); each call's wall time, then its device ms per step
    from a second call under torch.profiler;
19. ensemble: (a) `parallel.ensemble.build_ensemble_guided_step` with
    ViT-L/14 alone, on the NCCL group of one rank, against `guided_step`
    with unshared cutouts from the same x_t at each of 5 steps at 512x512,
    within 1e-5 of the image scale; (b) two processes sharing the card
    over gloo with CUDA tensors, each rebuilding the tiny float32 pipeline
    with two ViT towers: the ensemble (one tower per rank, 3 steps) against
    the single-process steps with unshared cutouts, and `serve_guided_batch`
    (2 prompts x 2 seeds, 3 steps) at world size 2 against world size 1,
    each within 1e-5;
20. resume: the main path's trajectory run as 5 steps with
    `return_state=True`, the `SamplingState` through an .npz file, then the
    other 5 with `draws=None`, against the straight 10-step run (max |diff|
    at most 1e-3 on [-1, 1]);
21. tools: `tools.profile_step`'s sections on the main path's zoo (the
    250-step default schedule, K=2, repeats=2), its BREAKDOWN line printed;
    `tools.build_banks --all` into a temporary directory, each bank within
    1e-4 of data/banks with every name retrieving its own row and the names
    files byte-equal; `tools.eval_clip_score --selftest`, and `--certify`
    on phase 6's release-file root, which names as MISSING exactly the slots
    phase 6 did not write and fails with exit code 1; `utils.profiling.
    trace` around one guided step, its Chrome trace holding the
    `annotate` name;
22. sdxl: Stable Diffusion XL base 1.0's UNet (bfloat16, 2,567,463,684
    parameters drawn from a seed) at the SDXL cell's CFG shape (6 x 128 x
    128 x 4, context 6 x 77 x 2048, vector 6 x 2816): the replayed CUDA
    graph equals the eager forward bit for bit, twice; one replayed and
    one eager forward's device ms under torch.profiler, the attention
    calls and fused kernel launches of a replayed forward (140 each: 70
    transformer blocks, self and cross) and the memory the capture
    reserved.

On every path the kernel launch counts are zeroed just before it runs and
read just after: on the guided paths (the auto-modifier request, the
score suite's samples, the server's requests, batch serving, the ensemble,
the resumed trajectory, profile_step and the traced step included) mode B
of the quantile kernel once per executed step (per rank), mode A never,
the fused attention never; on the latent paths (the latent request,
inpainting, the latent profile and serve_latent_batch) neither quantile
mode and the fused attention 32 times each UNet forward they make (16
transformer blocks, self and cross).

Then one JSON line {"kernels": [...]} (each kernel's launches on the main
path, and on every path under "launches_by_path"; the fused attention's
on every path and in the sdxl phase), the nvidia-smi line again, and as the
last line {"ok": true, "device": {...}}.  TF32 is off throughout, so
float32 comparisons run in full float32.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import glob
import io
import json
import math
import os
import base64
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as torch_dist
import torch.multiprocessing as torch_mp
from PIL import Image

from clip_diffusion_tpu_torch.config import Config, CutoutSchedules, create_schedule
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig, schedule_tables
from clip_diffusion_tpu_torch.guidance.losses import l2_normalize
from clip_diffusion_tpu_torch.guidance.score import PROMPT_SUITE, clip_scores, score_suite
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.aesthetic import LinearAestheticPredictor
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.clip.tokenizer import tokenize
from clip_diffusion_tpu_torch.models.convert import release_unet_state_dict
from clip_diffusion_tpu_torch.models.esrgan import upscale
from clip_diffusion_tpu_torch.models.ldm import unet as ldm_unet
from clip_diffusion_tpu_torch.models.marian import (
    MarianConfig,
    greedy_decode,
    marian_tokenize,
    marian_translator,
)
from clip_diffusion_tpu_torch.models.t5 import t5_tokenize
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.ops import kernels
from clip_diffusion_tpu_torch.ops import quantile as quantile_ops
from clip_diffusion_tpu_torch.ops.quantile import (
    histogram_abs_quantile,
    histogram_abs_quantile_plain,
    histogram_quantile,
    histogram_quantile_plain,
)
from clip_diffusion_tpu_torch.parallel import dist as port_dist
from clip_diffusion_tpu_torch.parallel.ensemble import build_ensemble_guided_step
from clip_diffusion_tpu_torch.parallel.serving import (
    load_analysis_bank,
    make_analyzer,
    serve_guided_batch,
    serve_latent_batch,
)
from clip_diffusion_tpu_torch.pipeline import guided as guided_mod
from clip_diffusion_tpu_torch.pipeline.guided import (
    TorchDraws,
    compute_phase_segments,
    guided_sample,
    guided_step,
)
from clip_diffusion_tpu_torch.pipeline.latent import decode_latents, img2img_start, latent_sample
from clip_diffusion_tpu_torch.runtime.registry import UNetRegistry
from clip_diffusion_tpu_torch.runtime.server import ClipDiffusionServer
from clip_diffusion_tpu_torch.sample import (
    default_latent_stack,
    guided_diffusion_sample,
    latent_diffusion_sample,
)
from clip_diffusion_tpu_torch.text.prompt import ARTSTATION_SUFFIX, Prompt, load_modifier_bank
from clip_diffusion_tpu_torch.text.retrieval import EmbeddingIndex
from clip_diffusion_tpu_torch.text.zh import tw_to_simplified
from clip_diffusion_tpu_torch.tools import build_banks, eval_clip_score, profile_step
from clip_diffusion_tpu_torch.tools.clip_score import provenance_summary, suite_sampler
from clip_diffusion_tpu_torch.utils.checkpoint import SamplingState
from clip_diffusion_tpu_torch.utils.image_io import (
    array_to_image,
    load_image,
    load_mask,
    normalize_image_neg_one_to_one,
)
from clip_diffusion_tpu_torch.utils.profiling import annotate, trace
from clip_diffusion_tpu_torch.utils.progress import get_task_state
from clip_diffusion_tpu_torch.zoo import (
    ZooModels,
    build_esrgan,
    build_latent_models,
    build_latent_pipeline,
    build_lpips,
    build_models,
    build_clip,
    build_pipeline,
    clip_checkpoint_name,
    host_init_state_dict,
    init_marian,
    weights_provenance,
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
# fused attention launches of one txt2img-f8-large UNet forward: 16
# transformer blocks, self and cross
LDM_ATTENTION_PER_FORWARD = 32
# ... and of the text front end's towers at full width
T5_PARAMS, MARIAN_PARAMS = 110218368, 77484009
# the main path's UNet and three ViT towers, as release files
GUIDED_RELEASE_PARAMS = 1286488198
BANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "banks")
ZH_PROMPTS = ("一隻可愛的貓坐在筆記型電腦旁", "夕陽下的燈塔 油畫", "龍 飛過 雪山")
MARIAN_SEED = 7  # the stand-in MarianMT's host-init seed


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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


BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores
EXP_PER_S = 132 * 16 * 1.98e9  # MUFU ex2: 16 a clock on each of 132 SMs at 1.98 GHz


def check_attention_kernel(dev) -> dict:
    """The fused attention kernel (`ops.attention.fused_attention`, the
    card's path of `models/ldm/unet.attention`) at every shape the LDM
    configurations send: it and the plain body against a float32
    evaluation of the same attention from the same bf16 inputs, the
    kernel's error no larger than the plain body's (relative Frobenius
    norm and largest element); the kernel within 2% (relative norm) and
    0.1 (largest element) of the plain body, which rounds each logit to
    bf16 before the softmax where the kernel does not.  Then
    its times: as called (CUDA events), device us (torch.profiler), the
    bound (FLOPs at 989 TFLOP/s, exps at the MUFU rate), the plain body
    and `scaled_dot_product_attention` as the library yardstick (the port
    never calls it)."""
    import torch.nn.functional as F

    from clip_diffusion_tpu_torch.ops.attention import (
        LDM_SHAPES,
        attention_float32,
        errors,
        fused_attention,
        projection_heads,
    )

    gen = torch.Generator(dev).manual_seed(16)
    rows, step_us = [], {"sdxl": 0.0, "latent": 0.0}
    for label, b, h, t_q, t_k, d, per_step in LDM_SHAPES:
        # q scaled so the logits spread about 2
        q = projection_heads(gen, b, h, t_q, d, 2.0)
        k, v = projection_heads(gen, b, h, t_k, d), projection_heads(gen, b, h, t_k, d)
        scale = torch.tensor(math.sqrt(d), dtype=torch.bfloat16).item()
        got = fused_attention(q, k, v, scale)
        plain = ldm_unet.attention_plain(q, k, v, scale, torch.bfloat16)
        ref = attention_float32(q, k, v, scale)
        torch.cuda.synchronize()
        if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"attention {label}: shape {tuple(got.shape)} or not finite")
        k_rel, k_max = errors(got, ref)
        p_rel, p_max = errors(plain, ref)
        kp_rel, kp_max = errors(got, plain)
        del ref
        fn = lambda: fused_attention(q, k, v, scale)  # noqa: E731
        iters = 20 if t_q * t_k > 2 ** 20 else 100
        kernel_ms = cuda_ms(fn, iters=iters)
        device_us, _ = device_us_per_call(fn, "ldm_softmax_attention")
        plain_ms = cuda_ms(lambda: ldm_unet.attention_plain(q, k, v, scale, torch.bfloat16),
                           iters=iters)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1 / scale),
                             iters=iters)
        flops = 4 * b * h * t_q * t_k * d
        exps = b * h * t_q * t_k
        nbytes = 2 * b * h * d * (2 * t_q + 2 * t_k)
        bound_ms = max(flops / BF16_OPS_PER_S, exps / EXP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        step_us[label.split()[0]] += device_us * per_step
        row = dict(label=label, shape=[b, h, t_q, t_k, d], kernel_rel=k_rel, kernel_max=k_max,
                   plain_rel=p_rel, plain_max=p_max, vs_plain_rel=kp_rel, vs_plain_max=kp_max,
                   kernel_ms=kernel_ms, device_us=device_us, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   tflops=flops / (device_us * 1e-6) / 1e12 if device_us else 0.0)
        rows.append(row)
        print(f"attention {label} {b}x{h}x{t_q}x{t_k}x{d}: vs float32 kernel rel {k_rel:.3e} "
              f"max {k_max:.3e}, plain rel {p_rel:.3e} max {p_max:.3e}; kernel vs plain rel "
              f"{kp_rel:.3e} max {kp_max:.3e}; as called {kernel_ms:.4f} ms, device "
              f"{device_us:.1f} us ({row['tflops']:.1f} TFLOP/s), bound {bound_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms", flush=True)
        del q, k, v, got, plain
    print(f"attention: device ms a UNet step from these shapes: SDXL {step_us['sdxl'] / 1e3:.3f} "
          f"(140 calls), latent {step_us['latent'] / 1e3:.3f} (32 calls)", flush=True)
    worse = [r["label"] for r in rows
             if r["kernel_rel"] > r["plain_rel"] or r["kernel_max"] > r["plain_max"]
             or r["vs_plain_rel"] > 0.02 or r["vs_plain_max"] > 0.1]
    if worse:
        raise AssertionError(f"attention: kernel less precise than the plain body, or off it, "
                             f"at {worse}")
    torch.cuda.empty_cache()
    return {"name": "ldm_softmax_attention", "route": "cuda",
            "source": "clip_diffusion_tpu_torch/csrc/ldm_attention.cu", "replaces": None,
            "shapes": rows, "step_ms": {k: v / 1e3 for k, v in step_us.items()}}


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


def tiny_models(device, n_towers: int = 1) -> ZooModels:
    """The tiny float32 UNet (seed 1) and `n_towers` tiny ViT towers tiny0,
    tiny1, ... (seeds 2, 3, ...)."""
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clips = {}
    for i in range(n_towers):
        clip = CLIPModel(tiny_clip_config(f"tiny{i}"))
        clip.load_state_dict(host_init_state_dict(clip, from_jax.clip_rule, 2 + i, torch.float32))
        clips[f"tiny{i}"] = clip.to(device).requires_grad_(False)
    return ZooModels(unet.to(device).requires_grad_(False), clips)


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


def check_reference(dev, seed: int = 7) -> None:
    """Two tiny float32 pipelines on the card against the CPU runs on the
    same weights and draws: 5 DDIM steps with a ViT tower, and 5 PLMS steps
    (7 with 2 skipped) from an init image with a ResNet tower, its aesthetic
    head and LPIPS.  Differences come from float32 sum order (cuDNN and
    cuBLAS against the CPU kernels): atol 1e-3 on [-1, 1] images, held two
    ways.  With the exact ("sort") threshold the whole trajectories are
    compared.  With mode B's, the kernel inside the pipeline, at batch 2
    (two rows, so a row mix-up shows), each step runs on the card and on
    the CPU from the card's state (`resume_state`, `stop_after=1`) and its
    x_t and pred_x0 are compared: a sum-order difference can carry a value
    across one of mode B's 4096 bin edges and move a threshold by a bin, a
    step of up to max|x|/4096 that a free-running pair carries into every
    later step, while the step-wise pair starts each step from the same
    state."""
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
        pipes = {}
        for device in ("cpu", dev):
            models = models_fn(device)
            pipes[str(device)] = {
                method: build_pipeline(models, config, [("a lighthouse on a cliff", 1.0)],
                                       dataclasses.replace(sampler, thresholding_method=method),
                                       use_init_losses=init_image is not None)
                for method in ("sort", "histogram")}
        cpu, gpu = (guided_sample(pipes[d]["sort"], _MovedDraws(seed, d), init_image=init_image)[1]
                    .float().cpu() for d in ("cpu", str(dev)))
        if not torch.isfinite(gpu).all():
            raise AssertionError(f"{label}: GPU frames not finite (exact threshold)")
        sort_err = float((cpu - gpu).abs().max())

        n_steps = sampler.steps - sampler.skip_timesteps
        table, _ = guided_mod.frame_table(n_steps, 6)  # guided_sample's num_frames
        state, step_errs = None, []
        for pos in range(n_steps):
            outs, states = {}, {}
            for d in ("cpu", str(dev)):
                _, frames, states[d] = guided_sample(
                    pipes[d]["histogram"], _MovedDraws(seed, d), batch_size=2,
                    init_image=init_image, resume_state=state, stop_after=1,
                    return_state=True)
                outs[d] = torch.stack([states[d].x, frames[table[pos]]]).float().cpu()
            if not torch.isfinite(outs[str(dev)]).all():
                raise AssertionError(f"{label}: GPU step {pos} not finite (mode B)")
            step_errs.append(float((outs["cpu"] - outs[str(dev)]).abs().max()))
            state = states[str(dev)]
        print(f"{label} GPU vs CPU: frames {tuple(gpu.shape)}, max |diff| {sort_err:.3e} with "
              f"the exact threshold; with mode B's at batch 2, step by step from the card's "
              f"state (x_t and pred_x0): " + ", ".join(f"{e:.3e}" for e in step_errs),
              flush=True)
        if not (sort_err <= 1e-3 and max(step_errs) <= 1e-3):
            raise AssertionError(f"{label}: GPU vs CPU max |diff| {sort_err:.3e} with the exact "
                                 f"threshold, {max(step_errs):.3e} in a step with mode B's")


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
    ldm_unet.attention.kernel_launches = 0


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


def write_release_files(models: ZooModels, root: str) -> dict:
    """The zoo's UNet and towers as public-release files under `root`, in
    bf16: the UNet with its attention weights as Conv1d (O, I, 1), each
    tower with OpenAI's `logit_scale`.  Returns {slot: path}."""
    sds = {"guided_unet_512": release_unet_state_dict(models.unet.state_dict())}
    for name, tower in models.clips.items():
        sds[clip_checkpoint_name(name)] = {**tower.state_dict(),
                                           "logit_scale": torch.tensor(4.6052)}
    paths = {}
    for slot, sd in sds.items():
        paths[slot] = os.path.join(root, f"{slot}.pt")
        torch.save({k: v.detach().to("cpu", torch.bfloat16) for k, v in sd.items()}, paths[slot])
    return paths


def _expect_refusal(label: str, build, *needles) -> str:
    """`build()` must raise RuntimeError whose message holds every needle."""
    try:
        build()
    except RuntimeError as e:
        if not all(n in str(e) for n in needles):
            raise AssertionError(f"{label}: message lacks {needles}: {e}") from e
        return str(e).split(";")[0][:160]
    raise AssertionError(f"{label}: no error")


def check_checkpoints(dev, models: ZooModels, config: Config, root: str,
                      expected_params: int = GUIDED_RELEASE_PARAMS) -> dict:
    """The checkpoints phase (module docstring, phase 6).  `models` holds
    the UNet and the towers of `config`; `root` is kept for the server
    phase.  Returns the figures it prints."""
    t0 = time.perf_counter()
    paths = write_release_files(models, root)
    save_s = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(p) for p in paths.values())
    n_params = sum(v.numel() for m in (models.unet, *models.clips.values())
                   for v in m.state_dict().values())
    if n_params != expected_params:
        raise AssertionError(f"release parameters {n_params:,}, expected {expected_params:,}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = build_models(config, unet_config=models.unet.config, checkpoint_root=root,
                          device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = [(models.unet, loaded.unet)] + [(models.clips[n], loaded.clips[n])
                                            for n in config.chosen_clip_models]
    for want, got in pairs:
        got_sd = got.state_dict()
        for k, v in want.state_dict().items():
            if not (got_sd[k].device == v.device and torch.equal(got_sd[k], v)):
                raise AssertionError(f"loaded {k} differs from the zoo's")
    del loaded, pairs, got_sd  # at most one extra copy of the UNet on the card
    torch.cuda.empty_cache()
    provenance = weights_provenance()
    if not set(paths) <= set(provenance["loaded"]):
        raise AssertionError(f"provenance loaded {provenance['loaded']}, expected {sorted(paths)}")

    name = config.chosen_clip_models[0]
    slot = clip_checkpoint_name(name)
    with tempfile.TemporaryDirectory() as scratch:
        bad_root = os.path.join(scratch, "truncated")
        os.makedirs(bad_root)
        with open(paths[slot], "rb") as src, open(os.path.join(bad_root, f"{slot}.pt"), "wb") as dst:
            dst.write(src.read(os.path.getsize(paths[slot]) // 2))
        truncated = _expect_refusal("truncated file", lambda: build_clip(
            name, device=dev, checkpoint_root=bad_root), "present but unusable", bad_root)
        flax_root = os.path.join(scratch, "models", "flax")
        os.makedirs(os.path.join(flax_root, slot))
        before = os.environ.get("CLIP_DIFFUSION_FLAX")
        os.environ["CLIP_DIFFUSION_FLAX"] = flax_root
        try:
            orbax = _expect_refusal("orbax slot without the port's file", lambda: build_clip(
                name, device=dev, checkpoint_root=os.path.join(scratch, "empty")),
                os.path.join(flax_root, slot), os.path.join(scratch, "empty", f"{slot}.pt"))
        finally:
            if before is None:
                del os.environ["CLIP_DIFFUSION_FLAX"]
            else:
                os.environ["CLIP_DIFFUSION_FLAX"] = before
    print(f"checkpoints: wrote {len(paths)} release files ({', '.join(paths)}), {n_params:,} "
          f"parameters, {n_bytes:,} bytes (bf16) in {save_s:.2f} s; build_models from them in "
          f"{load_s:.2f} s = {n_bytes / load_s / 1e9:.2f} GB/s; every parameter equal to the "
          f"in-memory zoo's; provenance loaded {provenance['loaded']}", flush=True)
    print(f"checkpoints: truncated {slot}.pt raises ({truncated!r}); an orbax slot without the "
          f"port's file raises ({orbax!r})", flush=True)
    return {"bytes": n_bytes, "params": n_params, "save_s": save_s, "load_s": load_s,
            "paths": paths}


def run_path(label: str, models: ZooModels, executed: int, shape, out_dir: str,
             **kwargs) -> dict:
    """`guided_diffusion_sample(**kwargs)` on `models` (by default with
    `PROMPT` and seed 1234), with the kernel counts zeroed just before and
    read just after; checks mode B once per executed step and mode A never,
    finite UNet outputs every step, a final PNG of `shape` that is not flat
    and a 6-frame GIF."""
    kwargs = {"prompt": PROMPT, "seed": 1234, **kwargs}
    finite = []  # device booleans, read after the run so the hook adds no sync
    hook = models.unet.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    uploader = _TimingUploader()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        result = guided_diffusion_sample(models=models, uploader=uploader, output_dir=out_dir,
                                         **kwargs)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()

    if launches != _expected(executed):
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
            "launches": launches, "image": result["images"][0]}


def check_tower_graphs(dev, models: ZooModels, config: Config) -> dict:
    """The towers of `models` at `config`'s widths through
    `pipeline/guided._cut_gradient`: each tower's chunks replayed from its
    CUDA graphs give the eager body's gradient bit for bit (the eager
    reference: the same towers behind lambdas, which never capture), at 24
    cuts, so in chunks of 16 and 8; then one step at the top of a 10-step
    schedule, captured once and replayed under a profile, holds one
    `guided.tower.replay` span per tower chunk."""
    from torch.profiler import ProfilerActivity, profile

    from clip_diffusion_tpu_torch.utils import profiling

    pipe = build_pipeline(models, config, [(PROMPT, 1.0)], SamplerConfig(steps=10))
    eager = dataclasses.replace(pipe, perceptors=tuple(
        dataclasses.replace(p, embed_image=lambda x, f=p.embed_image: f(x))
        for p in pipe.perceptors))
    members = list(range(len(pipe.perceptors)))
    gen = torch.Generator(dev).manual_seed(18)
    res = pipe.perceptors[0].input_resolution
    normed = torch.randn((1, 24, res, res, 3), generator=gen, device=dev).to(
        config.guidance_torch_dtype)
    weights = torch.rand((1, 24), generator=gen, device=dev)
    with torch.enable_grad():
        want = guided_mod._cut_gradient(eager, members, normed, weights)
        gaps = []
        for _ in range(2):  # the capturing call (if any key is new) and a replay
            got = guided_mod._cut_gradient(pipe, members, normed, weights)
            gaps.append((got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"tower graphs: graphed gradient differs by {gaps}")

    tables = schedule_tables(pipe.schedule, dev)
    top = pipe.schedule.num_steps - 1
    draws = TorchDraws(18, dev)
    x = draws.initial_noise((1, config.height, config.width, 3))
    guided_step(pipe, tables, x, top, draws)  # captures the step's chunk shapes
    recorder, profiling._RECORDER = profiling._RECORDER, profiling.Recorder()
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            guided_step(pipe, tables, x, top, draws)
            torch.cuda.synchronize()
        replays = sum(1 for sp in profiling.spans() if sp.name == "guided.tower.replay")
    finally:
        profiling._RECORDER = recorder
    ov_t, in_t, _, _ = config.cutout_schedules.as_arrays()
    idx = guided_mod.schedule_index(pipe.schedule, top)
    n_cuts = (int(ov_t[idx]) + int(in_t[idx])) * config.num_cutout_batches
    expected = len(members) * -(-n_cuts // config.clip_cut_chunk)
    graphs = {name: sum(e is not None for e in m._graphs.values())
              for name, m in models.clips.items()}
    print(f"tower graphs: {len(members)} towers graphed = eager bit for bit at 24 cuts (chunks "
          f"16 and 8; largest gaps {gaps}); {replays} replays in a step of {n_cuts} cuts "
          f"(expected {expected}); captured keys {graphs}", flush=True)
    if replays != expected:
        raise AssertionError(f"tower graphs: {replays} replays a step, expected {expected}")
    return {"replays_per_step": replays, "graphs": graphs}


def run_init_path(zoo: ZooModels, out_dir: str) -> dict:
    """The init-image path at 768x512: PLMS, 20 steps with 10 skipped, the
    aesthetic heads of the three ViTs, MS-SSIM and LPIPS.  Hooks count, per
    executed step, the LPIPS, MS-SSIM and aesthetic-head evaluations; a
    head inside a replayed tower graph runs no hook, so a replay of a
    chunk whose loss reads a head counts for that head."""
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

    replayed = guided_mod._replayed_gradient

    def counted_replay(tower, perc, cfg, chunk, w):
        g = replayed(tower, perc, cfg, chunk, w)
        if g is not None and perc.aesthetic_fn is not None and cfg.aesthetic_scale > 0:
            seen[f"aesthetic {perc.name}"].add(len(step_of))
        return g

    guided_mod.structural_dissimilarity_loss = counted_ms_ssim
    guided_mod._replayed_gradient = counted_replay
    sampler = SamplerConfig(mode="plms", steps=20, skip_timesteps=10)
    try:
        run = run_path("init-image path", models, 10, (config.height, config.width, 3), out_dir,
                       init_image=init_png, sample_mode=sampler.mode, steps=sampler.steps,
                       skip_timesteps=sampler.skip_timesteps, config=config)
    finally:
        guided_mod.structural_dissimilarity_loss = ms_ssim
        guided_mod._replayed_gradient = replayed
        for h in hooks:
            h.remove()
    every = set(range(1, 11))
    missing = {k: sorted(every - v) for k, v in seen.items() if v != every}
    if missing:
        raise AssertionError(f"init-image path: terms not computed at steps {missing}")
    print("init-image path: LPIPS, MS-SSIM and the aesthetic heads of "
          + ", ".join(models.aesthetic) + " computed at each of the 10 steps", flush=True)
    return run


def _read_names(kind: str) -> list:
    with open(os.path.join(BANKS, f"{kind}_names.txt"), encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def device_ms_by_class(fn, calls: int = 2):
    """torch.profiler over `calls` calls of `fn` (after a warm-up session):
    device ms per call by kernel class, and device operations per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # the first session may drop events
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_class, ops = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            cls = _kernel_class(evt.name)
            by_class[cls] = by_class.get(cls, 0.0) + evt.time_range.elapsed_us() / 1e3 / calls
            ops += 1
    return by_class, ops / calls


def _classes(by_class: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]))


def check_t5_bank(dev, bank) -> None:
    """The shipped modifier bank's query encoder, the full-width sentence-T5
    (float32, seed 0) on the card, embeds the 120 modifier names in one
    batch: within 1e-4 (max abs) of data/banks/modifiers_t5.npy, which the
    JAX package's tower wrote, and each name retrieves its own row first."""
    model = bank.encoder.model
    names = _read_names("modifiers")
    ref = np.load(os.path.join(BANKS, "modifiers_t5.npy"))
    toks = torch.from_numpy(t5_tokenize(names)).to(dev, torch.long)
    with torch.no_grad():
        emb = model(toks)
        ms = cuda_ms(lambda: model(toks), iters=10, warmup=2)
        classes, ops = device_ms_by_class(lambda: model(toks), calls=3)
    err = float(np.abs(emb.cpu().numpy() - ref).max())
    _, idx = bank.index.search(emb, 1)
    own = int((idx[:, 0] == np.arange(len(names))).sum())
    n_params = _param_count(model)
    if (n_params, own, bank.keywords) != (T5_PARAMS, len(names), names) or not err <= 1e-4:
        raise AssertionError(f"sentence-T5 vs modifiers_t5.npy: {n_params} parameters, max |diff| "
                             f"{err:.3e}, {own}/{len(names)} names retrieve their own row")
    print(f"sentence-T5 ({n_params:,} parameters, f32): {len(names)} modifier names "
          f"{tuple(toks.shape)} in {ms:.2f} ms as called, device {sum(classes.values()):.2f} ms "
          f"in {ops:.0f} device ops ({_classes(classes)}); max |diff| to modifiers_t5.npy "
          f"{err:.3e}; {own}/{len(names)} retrieve their own row", flush=True)


def check_clip_text_banks(dev, zoo: ZooModels) -> None:
    """The zoo's bf16 ViT-B/16 and ViT-L/14 text towers embed the style and
    media names; L2-normalized, each row's cosine to its row of
    {styles,media}_<tower>.npy (written by the JAX package's float32
    towers) is >= 0.999 and each name retrieves its own row first."""
    for tower in ("ViT-B/16", "ViT-L/14"):
        model = zoo.clips[tower]
        for kind in ("styles", "media"):
            names = _read_names(kind)
            ref = np.load(os.path.join(BANKS, f"{kind}_{tower.replace('/', '_')}.npy"))
            toks = torch.from_numpy(tokenize(names)).to(dev, torch.long)
            with torch.no_grad():
                emb = l2_normalize(model.encode_text(toks))
            cos = (emb * torch.from_numpy(ref).to(dev)).sum(dim=-1)
            _, idx = EmbeddingIndex(ref, dev).search(emb, 1)
            own = int((idx[:, 0] == np.arange(len(names))).sum())
            worst = float(cos.min())
            if not worst >= 0.999 or own != len(names):
                raise AssertionError(f"{tower} {kind}: min cosine {worst:.6f}, "
                                     f"{own}/{len(names)} retrieve their own row")
            print(f"{tower} (bf16) {kind}: {len(names)} names, cosine to the bank min {worst:.6f} "
                  f"mean {float(cos.mean()):.6f}; {own}/{len(names)} retrieve their own row",
                  flush=True)


def check_marian(dev) -> None:
    """MarianMT (opus-mt-zh-en at full width), host-initialized with
    MARIAN_SEED in float32, on the card against a copy of it on the CPU:
    teacher-forced logits of ZH_PROMPTS (tw2sp, then tokenized) within
    1e-3 of their max |value|; greedy ids to 64 tokens equal, or else the
    first difference must be a near-tie (the CPU's top-2 logit gap there
    within twice the logits' tolerance), printed as such; then a Prompt
    through this model's translator gives non-empty text."""
    cfg = MarianConfig.opus_zh_en()
    t0 = time.perf_counter()
    cpu_model = init_marian(cfg, seed=MARIAN_SEED, device="cpu")
    init_s = time.perf_counter() - t0
    model = copy.deepcopy(cpu_model).to(dev)
    n_params = _param_count(model)
    if n_params != MARIAN_PARAMS:
        raise AssertionError(f"MarianMT has {n_params} parameters, expected {MARIAN_PARAMS}")
    src = torch.from_numpy(marian_tokenize([tw_to_simplified(p) for p in ZH_PROMPTS], cfg=cfg)).long()
    tgt = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size - 2, (len(ZH_PROMPTS), 16))).long()
    tgt[:, 0] = cfg.decoder_start_token_id
    with torch.no_grad():
        ref = cpu_model(src, tgt)
        got = model(src.to(dev), tgt.to(dev)).cpu()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not err <= 1e-3 * scale:
        raise AssertionError(f"MarianMT logits card vs CPU: max |diff| {err:.3e}, scale {scale:.3e}")

    ids_cpu = greedy_decode(cpu_model, src, max_len=64)
    ids = greedy_decode(model, src, max_len=64)
    wall_ms = cuda_ms(lambda: greedy_decode(model, src, max_len=64), iters=3, warmup=1)
    classes, ops = device_ms_by_class(lambda: greedy_decode(model, src, max_len=64))
    diff = (ids.cpu() != ids_cpu).nonzero()
    if len(diff):
        b, i = (int(v) for v in diff[0])
        buf = torch.full((len(ZH_PROMPTS), 65), cfg.pad_token_id, dtype=torch.long)
        buf[:, 0] = cfg.decoder_start_token_id
        buf[:, 1:i + 1] = ids_cpu[:, :i]
        with torch.no_grad():
            row = cpu_model.decode(buf, cpu_model.encode(src), src)[b, i]
        row[cfg.pad_token_id] = -torch.inf
        top2 = torch.topk(row, 2).values
        gap = float(top2[0] - top2[1])
        print(f"MarianMT greedy ids differ first at prompt {b}, token {i}: a near-tie, the "
              f"CPU's top-2 logit gap there is {gap:.3e} (logits agree within {err:.3e})",
              flush=True)
        if gap > 2 * 1e-3 * scale:
            raise AssertionError(f"MarianMT greedy ids differ at ({b}, {i}) with a top-2 gap "
                                 f"{gap:.3e}: not a near-tie")
    text = Prompt(ZH_PROMPTS[0], translator=marian_translator(model), device=dev).text
    if not text.strip():
        raise AssertionError("Prompt through the MarianMT translator gave empty text")
    print(f"MarianMT ({n_params:,} parameters, f32, host init {init_s:.1f} s): teacher-forced "
          f"logits {tuple(got.shape)} card vs CPU max |diff| {err:.3e} (scale {scale:.3e}); greedy "
          f"ids to 64 tokens {'equal' if not len(diff) else 'differ at a near-tie'} "
          f"({tuple(ids.shape)}); decode of {len(ZH_PROMPTS)} prompts {wall_ms:.1f} ms as called, "
          f"device {sum(classes.values()):.2f} ms in {ops:.0f} device ops ({_classes(classes)}); "
          f"Prompt via its translator: {text[:60]!r}", flush=True)


def run_auto_modifier_request(dev, bank, models: ZooModels, config: Config, steps: int,
                              out_dir: str) -> dict:
    """`guided_diffusion_sample` with a Traditional-Chinese prompt,
    use_auto_modifiers and num_modifiers=2 (seed 0) on `models` at `config`:
    `new_prompt` must equal tw_to_simplified(prompt) + ", kw1, kw2" + the
    suffix, kw1 and kw2 the bank's top 2 for that text computed here apart;
    mode B once per step (run_path's checks)."""
    prompt = ZH_PROMPTS[0]
    simplified = tw_to_simplified(prompt)
    _, kws = bank.topk(simplified, 2)
    expected = simplified + "".join(f", {kw}" for kw in kws) + ARTSTATION_SUFFIX
    run = run_path("auto-modifier request", models, steps, (config.height, config.width, 3),
                   out_dir, prompt=prompt, seed=0, use_auto_modifiers=True, num_modifiers=2,
                   steps=steps, config=config, device=dev)
    got = get_task_state("new_prompt")
    if got != expected:
        raise AssertionError(f"new_prompt {got!r}, expected {expected!r}")
    print(f"auto-modifier request: new_prompt {got!r}", flush=True)
    return run


def check_analysis(dev, zoo: ZooModels, image_path: str, out_dir: str) -> dict:
    """The analyzer over the zoo's ViT-B/16 and ViT-L/14 and the shipped
    banks on `image_path`: 3 styles and 3 media from the name lists, finite
    scores; then CLIP scores of that image on the zoo's four towers and a
    score suite of PROMPT_SUITE[:2] sampled at 256x256 for 5 steps on the
    zoo (the tool's sampler, no rebuild), its mode B launches counted."""
    bank = load_analysis_bank()
    analyzer = make_analyzer(zoo)
    with Image.open(image_path) as im:
        img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    out = analyzer(img)
    t0 = time.perf_counter()
    for _ in range(5):
        out = analyzer(img)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    for kind, names in (("styles", bank.style_names), ("media", bank.media_names)):
        if len(out[kind]) != 3 or not all(n in names and np.isfinite(s) for s, n in out[kind]):
            raise AssertionError(f"analyzer {kind}: {out[kind]}")
    print(f"analyzer (ViT-B/16 + ViT-L/14, bf16) on {os.path.basename(image_path)}: {ms:.1f} ms "
          f"per call; styles {out['styles']}; media {out['media']}", flush=True)

    towers = zoo_subset(zoo, Config().chosen_clip_models)
    scores = clip_scores(towers.clips, img, PROMPT)
    print(f"CLIP scores of that image: {json.dumps(scores)}", flush=True)
    config = Config(width=256, height=256)
    _zero_launches()
    t0 = time.perf_counter()
    rows, mean = score_suite(towers.clips, suite_sampler(towers, config, 5, 0, dev, out_dir),
                             PROMPT_SUITE[:2])
    wall = time.perf_counter() - t0
    launches = _launches()
    if launches != _expected(10):
        raise AssertionError(f"score suite: quantile kernel launches in 2 x 5 steps: {launches}")
    values = [v for _, r in rows for kind in r.values() for v in kind.values()]
    if not np.isfinite(values).all():
        raise AssertionError(f"score suite: {rows}")
    for p, r in rows:
        print(f"suite {p!r}: cosine {r['cosine']}, spherical {r['spherical']}", flush=True)
    print(f"score suite: 2 prompts x 5 steps at 256x256 in {wall:.2f} s, suite cosine mean {mean}; "
          f"quantile kernel launches {launches}; provenance {json.dumps(provenance_summary())}",
          flush=True)
    return launches


def run_text_front_end(dev, zoo: ZooModels, main_models: ZooModels, main_config: Config,
                       steps: int, main_image: str, out_dir: str) -> dict:
    """The text front end phase (module docstring, phase 9); returns the
    launch counts of its two guided paths."""
    t0 = time.perf_counter()
    bank = load_modifier_bank(device=dev)
    print(f"modifier bank loaded in {time.perf_counter() - t0:.1f} s "
          f"({len(bank.keywords)} keywords, sentence-T5 on {dev})", flush=True)
    check_t5_bank(dev, bank)
    check_clip_text_banks(dev, zoo)
    check_marian(dev)
    auto = run_auto_modifier_request(dev, bank, main_models, main_config, steps,
                                     os.path.join(out_dir, "auto"))
    suite = check_analysis(dev, zoo, main_image, os.path.join(out_dir, "suite"))
    print(f"text front end: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"auto-modifier request": auto["launches"], "clip-score suite": suite}


def _http(port: int, path: str, body=None):
    """(status, bytes, content type) of one request to the local server."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _http_json(port: int, path: str, body=None, expect: int = 200):
    status, data, _ = _http(port, path, body)
    if status != expect:
        raise AssertionError(f"{path}: HTTP {status}, expected {expect}: {data[:300]!r}")
    return json.loads(data)


def run_server(models: ZooModels, config: Config, root: str, steps: int,
               out_dir: str) -> dict:
    """The server phase (module docstring, phase 11) on `models` (the main
    path's zoo) and `config`, with `root` holding the UNet's release file
    from the checkpoints phase.  Returns each request's launch counts."""
    unet_file = os.path.join(root, "guided_unet_512.pt")
    custom = dict(torch.load(unet_file, map_location="cpu", weights_only=True, mmap=True))
    custom["out.2.weight"] = custom["out.2.weight"] * 2  # a finetune of one weight
    torch.save(custom, os.path.join(root, "guided_unet_custom_landscape.pt"))
    del custom
    before = {k: (v.data_ptr(), v.detach().cpu().clone())
              for k, v in models.unet.state_dict().items()}

    server = ClipDiffusionServer(port=0, config=config, models=models,
                                 registry=UNetRegistry(models.unet).discover(root),
                                 output_dir=out_dir)
    server.start_background()
    port, by_request, images = server.port, {}, {}
    try:
        seed = _http_json(port, "/seed")["seed"]
        model_types = _http_json(port, "/model_types")["model_types"]
        if not {"landscape", "景觀"} <= set(model_types):
            raise AssertionError(f"/model_types {model_types}")
        for label, extra in (("server default request", {}),
                             ("server 景觀 request", {"model_type": "景觀"})):
            body = {"prompt": PROMPT, "steps": steps, "seed": 1234, **extra}
            _zero_launches()
            t0 = time.perf_counter()
            if not _http_json(port, "/guided_sample", body)["started"]:
                raise AssertionError(f"{label}: not started")
            post_s = time.perf_counter() - t0
            busy = ""
            if not extra:
                _http_json(port, "/guided_sample", body, expect=409)
                busy = "; a second POST while busy: 409"
            polls = 0
            while True:
                state = _http_json(port, "/task_state")
                polls += 1
                if not state["busy"]:
                    break
                time.sleep(0.1)
            wall = time.perf_counter() - t0
            launches = _launches()
            if state["error"] is not None:
                raise AssertionError(f"{label}: {state['error']}")
            if launches != _expected(steps):
                raise AssertionError(f"{label}: quantile kernel launches in {steps} steps: "
                                     f"{launches}")
            status, png, ctype = _http(port, urllib.parse.urlparse(
                state["current_result"]).path)
            if status != 200 or ctype != "image/png" or png[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{label}: /files/ progress image: {status} {ctype}")
            image_path = state["result"]["images"][0]
            with Image.open(image_path) as im:
                images[label] = np.asarray(im.convert("RGB"))
            if images[label].shape != (config.height, config.width, 3):
                raise AssertionError(f"{label}: image {images[label].shape}")
            by_request[label] = launches
            print(f"{label}: {steps} steps, wall {wall:.2f} s from POST to done (POST answered "
                  f"in {post_s * 1e3:.1f} ms{busy}; {polls} polls); quantile kernel launches "
                  f"{launches}; progress PNG via /files/ ({len(png):,} bytes); image "
                  f"{image_path}", flush=True)
        default, custom = images.values()
        if np.array_equal(default, custom):
            raise AssertionError("the 景觀 finetune gave the default request's image")
        for k, v in models.unet.state_dict().items():
            ptr, value = before[k]
            if v.data_ptr() != ptr or not torch.equal(v.cpu(), value):
                raise AssertionError(f"the zoo's UNet changed at {k}")
        err = _http_json(port, "/guided_sample", {"prompt": PROMPT, "model_type": "nope"},
                         expect=400)["error"]

        # both requests wrote guided_0.png: the default request's image, saved again
        Image.fromarray(default).save(os.path.join(out_dir, "default.png"))
        with open(os.path.join(out_dir, "default.png"), "rb") as f:
            payload = {"image_b64": base64.b64encode(f.read()).decode()}
        out = _http_json(port, "/analyze_image", payload)
        t0 = time.perf_counter()
        for _ in range(5):
            out = _http_json(port, "/analyze_image", payload)
        analyze_ms = (time.perf_counter() - t0) / 5 * 1e3
        bank = load_analysis_bank()
        for kind, names in (("styles", bank.style_names), ("media", bank.media_names)):
            if len(out[kind]) != 3 or not all(n in names and np.isfinite(s) for s, n in out[kind]):
                raise AssertionError(f"/analyze_image {kind}: {out[kind]}")
    finally:
        server.shutdown()
    print(f"server: /seed {seed}; /model_types {model_types}; the two images differ (mean |diff| "
          f"{np.abs(default.astype(float) - custom.astype(float)).mean():.2f} of 255) and the "
          f"zoo's UNet is bit-identical afterwards; model_type 'nope': 400 ({err[:60]!r}); "
          f"/analyze_image over HTTP {analyze_ms:.1f} ms a call: styles {out['styles']}, media "
          f"{out['media']}", flush=True)
    return by_request


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


def profile_steps(dev, label: str, models, config, n_steps: int, out_dir: str) -> None:
    """The first `n_steps` guided steps of a 10-step DDIM trajectory (the
    schedule phase with the most cutouts), run three times from the same
    draws: a warm-up, a timed run and a run under torch.profiler.  Prints
    the wall time per step without the profiler, the device time per
    step, the device's idle share, device time by kernel class and by
    direction (kernels launched under the autograd engine are the
    backward, UNet recompute included; the port's own kernels, launched
    through ctypes, sit under no PyTorch op and count in neither) and the
    top kernels; then each tower's forward and backward over the first
    step's cut count, in chunks of `clip_cut_chunk`, run alone under the
    profiler, and its device time's share of the step's.  The op table
    goes to <out_dir>/profile_<label>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_diffusion_tpu_torch.pipeline.guided import schedule_index

    pipe = build_pipeline(models, config, [(PROMPT, 1.0)], SamplerConfig(steps=10))
    tables = schedule_tables(pipe.schedule, dev)
    top = pipe.schedule.num_steps - 1
    shape = (1, config.height, config.width, 3)

    def run():
        draws = TorchDraws(99, dev)
        x = draws.initial_noise(shape)
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


def _launches() -> dict:
    return {"histogram_quantile": histogram_quantile.launches,
            "histogram_abs_quantile": histogram_abs_quantile.launches,
            "ldm_softmax_attention": ldm_unet.attention.kernel_launches}


def _expected(abs_quantile: int = 0, attention: int = 0) -> dict:
    """Launch counts as `_launches` reads them: mode A of the quantile
    kernel never, mode B `abs_quantile` times, the fused attention
    `attention` times."""
    return {"histogram_quantile": 0, "histogram_abs_quantile": abs_quantile,
            "ldm_softmax_attention": attention}


def _check_latent_launches(label: str, forwards: int) -> dict:
    """A latent path launches no quantile kernel and the fused attention
    once per attention call of each of its `forwards` UNet forwards (32 in
    txt2img-f8-large: 16 transformer blocks, self and cross)."""
    launches = _launches()
    if forwards <= 0 or launches != _expected(attention=LDM_ATTENTION_PER_FORWARD * forwards):
        raise AssertionError(f"{label}: kernel launches {launches} in {forwards} UNet forwards")
    print(f"{label}: kernel launches {launches} in {forwards} UNet forwards", flush=True)
    return launches


@contextlib.contextmanager
def _counting_forwards(unet):
    """A list that gains one entry per forward of `unet` (replays of its
    CUDA graph included) while the block runs."""
    forwards = []
    hook = unet.register_forward_hook(lambda *_a: forwards.append(1))
    try:
        yield forwards
    finally:
        hook.remove()


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
    decode, which waits for the device.  Returns the kernel launch counts:
    no quantile kernel, the fused attention 32 times a UNet forward."""
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
    launches = _check_latent_launches("latent request", len(finite))

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
    return launches


def run_inpainting_path(dev, pipe, text_encode, out_dir: str) -> dict:
    """`latent_diffusion_sample` inpainting: an init PNG (seeded 8x8 blocks)
    and a mask PNG (white top half: keep), PLMS, 20 steps, 1 iteration x 2
    images, on the zoo's stack with its decode wrapped to keep the final
    latents.  The kept region must end nearer the init latent than the free
    region (mean |z - z_init|).  Returns the kernel launch counts (no
    quantile kernel, the fused attention 32 times a UNet forward)."""
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
    launches = _check_latent_launches("inpainting path", len(finite))
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
    return launches


def profile_latent(dev, pipe, text_encode, esrgan, out_dir: str) -> dict:
    """Two CFG DDIM steps of the latent request (3 images, UNet batch 6)
    timed after a warm-up, then under torch.profiler: device ms per step,
    idle share, device time by kernel class, top kernels, and the UNet
    forward's FLOPs (torch's FlopCounterMode: matmuls and convs; the fused
    attention kernel's products are not counted) over its device time.
    Then the VQ decode of the 3 latents, the BERT at batch 3 and one ESRGAN
    x4 call on one 256x256 image (whole and in 128 px tiles), each alone
    under the profiler, with their FLOPs counted the same way.  Returns
    the kernel launch counts of the UNet forwards (no quantile kernel, the
    fused attention 32 times a forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    ctx_c, ctx_u = text_encode([PROMPT] * 3), text_encode([""] * 3)

    def two_steps():
        z = latent_sample(pipe, TorchDraws(5, dev), ctx_c, ctx_u, batch_size=3, steps=2)
        torch.cuda.synchronize()
        return z

    _zero_launches()
    with _counting_forwards(pipe.unet) as forwards:
        z = two_steps()
        t0 = time.perf_counter()
        two_steps()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
        # CUDA activity only: with CPU activity too, the records of a replayed
        # CUDA graph's kernels (the LDM UNet's) overlap, and their sum reads
        # about 3x
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    # the eager forward: a replay of the UNet's CUDA graph hides its ops from
    # the counter, which does not see inside the fused attention kernel either
    flops = count_flops(lambda: pipe.unet._forward(torch.zeros((6, 32, 32, 4), device=dev),
                                                   torch.full((6,), 981.0, device=dev),
                                                   torch.cat([ctx_u, ctx_c])))
    launches = _check_latent_launches("latent profile", len(forwards) + 1)
    print(f"latent profile 256x256 (3 images, UNet batch 6): wall {wall_ms:.2f} ms/step, device "
          f"{device_ms:.2f} ms/step, idle share {1 - device_ms / wall_ms:.3f}; UNet forward "
          f"{flops / 1e12:.3f} TFLOP (matmuls and convs outside the fused attention), "
          f"{flops / device_ms / 1e9:.1f} TFLOP/s over the step's device time", flush=True)
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
    return launches


# batch serving's requests (phase 18)
SERVE_PROMPTS = (PROMPT, "A dragon curled around a ruined tower, matte painting.")
LATENT_SERVE_PROMPTS = ("a lighthouse on a cliff at golden hour", "a red fox in deep snow",
                        "an astronaut riding a horse on the moon")


def profiled_device_ms(fn) -> float:
    """Device milliseconds of one call of `fn`, from torch.profiler tracing
    the device alone (no host ops: their events cost more to collect than
    the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA) / 1e3
    if ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return ms


def run_batch_serving(models: ZooModels, config: Config, latent_pipe, text_encode,
                      out_dir: str) -> dict:
    """Phase 18 on the process group's one rank: `serve_guided_batch` (2
    prompts x 2 seeds, 5 DDIM steps at the main path's width) and
    `serve_latent_batch` (3 prompts x 3 seeds, CFG DDIM, 10 steps, decoded).
    Each call is timed with its launch counts, checked, then called again
    under torch.profiler for its device time.  Returns the launch counts
    by path."""
    steps, seeds = 5, 2
    pipe = build_pipeline(models, config, [[(p, 1.0)] for p in SERVE_PROMPTS],
                          SamplerConfig(steps=steps, eta=0.8))
    serve = lambda: serve_guided_batch(pipe, len(SERVE_PROMPTS), seeds, base_seed=1234)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    final, frames = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    guided_launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    batch = len(SERVE_PROMPTS) * seeds
    if guided_launches != _expected(steps):
        raise AssertionError(f"serve_guided_batch: quantile launches in {steps} steps: "
                             f"{guided_launches}")
    if tuple(final.shape) != (batch, config.height, config.width, 3) or not bool(
            torch.isfinite(frames).all()):
        raise AssertionError(f"serve_guided_batch: final {tuple(final.shape)}, finite "
                             f"{bool(torch.isfinite(frames).all())}")
    seed_diff = float((final[0] - final[1]).abs().max())
    prompt_diff = float((final[0] - final[seeds]).abs().max())
    if seed_diff < 1e-3 or prompt_diff < 1e-3:
        raise AssertionError(f"serve_guided_batch: seeds differ by {seed_diff}, prompts by "
                             f"{prompt_diff}")
    os.makedirs(out_dir, exist_ok=True)
    for i, img in enumerate(((final + 1) / 2).float().cpu().numpy()):
        array_to_image(img).save(os.path.join(out_dir, f"serve_guided_{i}.png"))
    dev_ms = profiled_device_ms(serve) / steps
    print(f"serve_guided_batch: {len(SERVE_PROMPTS)} prompts x {seeds} seeds at "
          f"{config.width}x{config.height}, {steps} steps in {wall:.2f} s wall "
          f"({wall / steps * 1e3:.1f} ms/step, {wall / batch:.2f} s/image); device "
          f"{dev_ms:.1f} ms/step (profiled call); peak memory {peak / 2**30:.2f} GiB; "
          f"max |diff| between the seeds of a prompt {seed_diff:.3f}, between prompts "
          f"{prompt_diff:.3f}; quantile kernel launches {guided_launches}", flush=True)

    steps, seeds = 10, 3
    ctx_c, ctx_u = text_encode(list(LATENT_SERVE_PROMPTS)), text_encode([""])
    serve = lambda: serve_latent_batch(latent_pipe, ctx_c, ctx_u, seeds_per_prompt=seeds,
                                       base_seed=5, steps=steps)
    _zero_launches()
    t0 = time.perf_counter()
    with _counting_forwards(latent_pipe.unet) as forwards:
        images = serve()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    latent_launches = _check_latent_launches("serve_latent_batch", len(forwards))
    batch = len(LATENT_SERVE_PROMPTS) * seeds
    ok = bool(torch.isfinite(images).all()) and float(images.min()) >= 0 and float(
        images.max()) <= 1
    if tuple(images.shape) != (batch, 256, 256, 3) or not ok:
        raise AssertionError(f"serve_latent_batch: images {tuple(images.shape)}, finite and "
                             f"in [0, 1]: {ok}")
    seed_diff = float((images[0] - images[1]).abs().max())
    if seed_diff < 1e-3:
        raise AssertionError(f"serve_latent_batch: the seeds of a prompt differ by {seed_diff}")
    for i, img in enumerate(images.float().cpu().numpy()):
        array_to_image(img).save(os.path.join(out_dir, f"serve_latent_{i}.png"))
    dev_ms = profiled_device_ms(serve) / steps
    print(f"serve_latent_batch: {len(LATENT_SERVE_PROMPTS)} prompts x {seeds} seeds at 256x256, "
          f"CFG DDIM, {steps} steps, decoded, in {wall:.2f} s wall ({wall / steps * 1e3:.1f} "
          f"ms/step with the decode); device {dev_ms:.2f} ms/step with the decode (profiled "
          f"call); max |diff| between the seeds of a prompt {seed_diff:.3f}", flush=True)
    return {"serve_guided_batch": guided_launches, "serve_latent_batch": latent_launches}


def run_full_width_ensemble(dev, zoo: ZooModels, config: Config, steps: int = 5) -> dict:
    """Phase 19 (a): the ensemble step with ViT-L/14 alone on the process
    group's one rank against `guided_step` with unshared cutouts, from the
    reference trajectory's x_t at each step: within 1e-5 of the image
    scale (0 expected: no op with atomics is on the path); the steps' peak
    memory, and the first step's device time from a profiled rerun.
    Returns the ensemble steps' launch counts."""
    config = dataclasses.replace(config, share_cutouts_across_perceptors=False)
    pipe = build_pipeline(zoo_subset(zoo, ("ViT-L/14",)), config, [(PROMPT, 1.0)],
                          SamplerConfig(steps=steps, eta=0.8))
    tables = schedule_tables(pipe.schedule, dev)
    draws = TorchDraws(4321, dev)
    x = draws.initial_noise((1, config.height, config.width, 3))
    ref = []
    with torch.no_grad():
        for step in range(steps - 1, -1, -1):
            x_next, pred = guided_step(pipe, tables, x, step, draws)
            ref.append((step, x, x_next, pred))
            x = x_next
        step_fn = build_ensemble_guided_step(pipe)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        err, scale = 0.0, 0.0
        for step, x_in, x_ref, pred_ref in ref:
            x_ens, pred_ens = step_fn(tables, x_in, step, draws)
            err = max(err, float((x_ens - x_ref).abs().max()),
                      float((pred_ens - pred_ref).abs().max()))
            scale = max(scale, float(x_ref.abs().max()))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
        dev_ms = profiled_device_ms(lambda: step_fn(tables, ref[0][1], ref[0][0], draws))
    if launches != _expected(steps):
        raise AssertionError(f"ensemble: quantile launches in {steps} steps: {launches}")
    if not err <= 1e-5 * scale:
        raise AssertionError(f"ensemble vs guided_step: max |diff| {err:.3e}, scale {scale:.3f}")
    print(f"ensemble (ViT-L/14 on 1 rank, {torch_dist.get_backend()}) vs guided_step with "
          f"unshared cutouts: {steps} steps at {config.width}x{config.height}, max |diff| "
          f"{err:.3e} (x_t scale {scale:.3f}), {wall / steps * 1e3:.1f} ms/step; device "
          f"{dev_ms:.1f} ms in the first step (profiled); peak memory {peak / 2**30:.2f} GiB; "
          f"quantile kernel launches {launches}", flush=True)
    return launches


TINY_SERVE_PROMPTS = ("a lighthouse on a cliff", "a dragon over snowy mountains")


def _tiny_paths(models: ZooModels, device, ensemble: bool):
    """Phase 19 (b)'s two tiny runs on this process's rank(s): 3 steps at
    batch 2, of the ensemble (one tower per rank) or, for the reference,
    of `guided_step` with unshared cutouts; and serve_guided_batch (2
    prompts x 2 seeds, 3 steps); each with its launch counts."""
    config = tiny_config()
    sampler = SamplerConfig(steps=3, eta=0.8)
    ens_pipe = build_pipeline(models, dataclasses.replace(
        config, share_cutouts_across_perceptors=False), [(TINY_SERVE_PROMPTS[0], 1.0)], sampler)
    tables = schedule_tables(ens_pipe.schedule, device)
    draws = TorchDraws(22, device)
    x = draws.initial_noise((2, config.height, config.width, 3))
    step_fn = (build_ensemble_guided_step(ens_pipe) if ensemble
               else lambda *args: guided_step(ens_pipe, *args))
    _zero_launches()
    steps = []
    with torch.no_grad():
        for step in range(2, -1, -1):
            x, pred = step_fn(tables, x, step, draws)
            steps.append((x.cpu(), pred.cpu()))
    ens_launches = _launches()
    serve_pipe = build_pipeline(models, config, [[(p, 1.0)] for p in TINY_SERVE_PROMPTS], sampler)
    _zero_launches()
    final, frames = serve_guided_batch(serve_pipe, len(TINY_SERVE_PROMPTS), 2, base_seed=21)
    return {"ensemble": steps, "serve": frames.cpu(), "launches": (ens_launches, _launches())}


def _tiny_rank(rank: int, world: int, init_file: str, out: str, device: str) -> None:
    """One of phase 19 (b)'s processes: gloo, every rank on `device`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = port_dist.init(device=device, backend="gloo", init_method=f"file://{init_file}",
                         rank=rank, world_size=world)
    try:
        torch.save(_tiny_paths(tiny_models(dev, 2), dev, True), f"{out}.{rank}")
    finally:
        torch_dist.destroy_process_group()


def run_two_rank_gloo(dev) -> None:
    """Phase 19 (b): the tiny two-tower runs as 2 processes sharing the card
    over gloo (NCCL refuses two ranks on one GPU) against this process
    alone (no process group): within 1e-5 each; mode B once per step on
    every rank."""
    ref = _tiny_paths(tiny_models(dev, 2), dev, False)
    card = "cuda:0" if dev.type == "cuda" else "cpu"  # both ranks share the one card
    with tempfile.TemporaryDirectory(prefix="gloo_ranks_") as tmp:
        t0 = time.perf_counter()
        ctx = torch_mp.start_processes(
            _tiny_rank, args=(2, os.path.join(tmp, "pg"), os.path.join(tmp, "out"), card),
            nprocs=2, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > 300:
                    raise TimeoutError("the two gloo ranks outlasted 300 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"out.{r}")) for r in range(2)]
    ens_err = max(float((a - b).abs().max()) for rank in ranks
                  for got, want in zip(rank["ensemble"], ref["ensemble"])
                  for a, b in zip(got, want))
    serve_err = max(float((rank["serve"] - ref["serve"]).abs().max()) for rank in ranks)
    per_step = _expected(3)
    launches = [rank["launches"] for rank in ranks]
    if not (ens_err <= 1e-5 and serve_err <= 1e-5):
        raise AssertionError(f"two ranks over gloo vs one process: ensemble {ens_err:.3e}, "
                             f"serve_guided_batch {serve_err:.3e}")
    if any(lc != (per_step, per_step) for lc in launches):
        raise AssertionError(f"two ranks over gloo: quantile launches per rank {launches}")
    print(f"two ranks over gloo on one card (tiny f32, two ViT towers; {wall:.1f} s with "
          f"start-up): ensemble vs single-process steps max |diff| {ens_err:.3e}, "
          f"serve_guided_batch world 2 vs world 1 max |diff| {serve_err:.3e}; quantile "
          f"kernel launches per rank (ensemble, serve) {launches[0]}", flush=True)


def run_resume(dev, models: ZooModels, config: Config, steps: int) -> dict:
    """Phase 20: the main path's trajectory straight, then as `steps // 2`
    steps with `return_state=True`, the state through an .npz file, and
    the rest with `draws=None`; the pair's peak memory, and the device time
    per step of the resumed half from a profiled rerun.  Returns the
    resumed pair's launch counts."""
    pipe = build_pipeline(models, config, [(PROMPT, 1.0)], SamplerConfig(steps=steps, eta=0.8))
    straight, _ = guided_sample(pipe, TorchDraws(1234, dev))
    half = steps // 2
    with tempfile.TemporaryDirectory(prefix="resume_") as tmp:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        _, _, state = guided_sample(pipe, TorchDraws(1234, dev), stop_after=half, return_state=True)
        path = os.path.join(tmp, "state.npz")
        state.save(path)
        loaded = SamplingState.load(path)
        resumed, _ = guided_sample(pipe, None, resume_state=loaded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        size = os.path.getsize(path)
    peak = torch.cuda.max_memory_allocated()
    launches = _launches()
    dev_ms = profiled_device_ms(lambda: guided_sample(pipe, None, resume_state=loaded))
    dev_ms /= steps - half
    err = float((resumed - straight).abs().max())
    if launches != _expected(steps):
        raise AssertionError(f"resume: quantile launches in {steps} steps: {launches}")
    if loaded.step != steps - 1 - half or not err <= 1e-3:
        raise AssertionError(f"resume: state step {loaded.step}, max |diff| {err:.3e}")
    print(f"resume: {half} + {steps - half} steps through a {size / 2**20:.1f} MiB .npz "
          f"(state step {loaded.step}) in {wall:.2f} s vs the straight {steps}-step run: "
          f"max |diff| {err:.3e}; device {dev_ms:.1f} ms/step over the resumed steps "
          f"(profiled); peak memory {peak / 2**30:.2f} GiB; quantile kernel launches "
          f"{launches}", flush=True)
    return launches


def _check_banks(out_dir: str) -> None:
    """Each rebuilt bank within 1e-4 of the committed one, every name
    retrieving its own row, the names files byte-equal."""
    for path in sorted(glob.glob(os.path.join(BANKS, "*"))):
        name = os.path.basename(path)
        with open(path, "rb") as a, open(os.path.join(out_dir, name), "rb") as b:
            if name.endswith(".txt") and a.read() != b.read():
                raise AssertionError(f"build_banks: {name} differs from the committed one")
        if not name.endswith(".npy"):
            continue
        ref, got = np.load(path), np.load(os.path.join(out_dir, name))
        err = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
        own = int((np.argmax(got @ ref.T, axis=1) == np.arange(len(ref))).sum())
        if not (got.dtype == np.float32 and err <= 1e-4 and own == len(ref)):
            raise AssertionError(f"build_banks {name}: {got.dtype} {got.shape}, max |diff| "
                                 f"{err:.3e}, {own}/{len(ref)} retrieve their own row")
        print(f"build_banks {name}: {got.shape}, max |diff| to the committed bank {err:.3e}, "
              f"{own}/{len(ref)} retrieve their own row", flush=True)


def run_tools(dev, models: ZooModels, config: Config, default_models: ZooModels,
              weights_root: str, k: int = 2, repeats: int = 2) -> dict:
    """Phase 21: profile_step's sections on the main path's zoo (250-step
    default schedule, K=2, repeats=2) with its BREAKDOWN line, and its
    `phases` section on the default request's (768x512, four towers,
    repeats=1) with a second BREAKDOWN line; build_banks
    --all against data/banks; eval_clip_score --selftest, and --certify on
    phase 6's release-file root, which must name exactly the slots phase 6
    did not write as MISSING and fail with exit code 1; utils.profiling.
    trace around one guided step, its file holding the annotate names.
    Returns the launch counts by path."""
    launches = {}
    pipe = build_pipeline(models, config, [(PROMPT, 1.0)],
                          SamplerConfig(mode="ddim", steps=250, eta=0.8))
    _zero_launches()
    t0 = time.perf_counter()
    breakdown = profile_step.run_sections(pipe, profile_step.SECTIONS, k, repeats, (4, 2))
    launches["profile_step"] = _launches()
    if launches["profile_step"]["histogram_quantile"] or not launches["profile_step"][
            "histogram_abs_quantile"]:
        raise AssertionError(f"profile_step: quantile launches {launches['profile_step']}")
    print(f"profile_step: {len(breakdown)} entries in {time.perf_counter() - t0:.1f} s; quantile "
          f"kernel launches {launches['profile_step']}", flush=True)
    print("BREAKDOWN " + json.dumps(breakdown), flush=True)
    default_pipe = build_pipeline(default_models, Config(), [(PROMPT, 1.0)],
                                  SamplerConfig(mode="ddim", steps=250, eta=0.8))
    _zero_launches()
    default_breakdown = profile_step.run_sections(default_pipe, ["phases"], k, 1)
    launches["profile_step default"] = _launches()
    print("BREAKDOWN default request " + json.dumps(default_breakdown), flush=True)

    on_cpu = ["--cpu"] if dev.type == "cpu" else []  # a CPU rehearsal
    with tempfile.TemporaryDirectory(prefix="banks_") as out:
        t0 = time.perf_counter()
        build_banks.main(["--all", "--out", out, "--csv-dir",
                          os.path.join(os.path.dirname(BANKS), "csv")] + on_cpu)
        print(f"build_banks --all in {time.perf_counter() - t0:.1f} s", flush=True)
        _check_banks(out)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        selftest_rc = eval_clip_score.main(["--selftest"] + on_cpu)
        certify_rc = eval_clip_score.main(["--certify", "--checkpoint-root", weights_root]
                                          + on_cpu)
    selftest, report = (json.loads(line) for line in buf.getvalue().strip().splitlines()[-2:])
    scores = selftest["selftest_scores"]
    if selftest_rc != 0 or len(scores) != 2 or not all(np.isfinite(scores)):
        raise AssertionError(f"eval_clip_score --selftest: rc {selftest_rc}, {selftest}")
    written = {"guided_unet_512"} | {clip_checkpoint_name(n) for n in config.chosen_clip_models}
    slots = report["checks"]["checkpoint_slots"]
    missing = {k for k, v in slots.items() if v == "MISSING"}
    if certify_rc != 1 or report["certify"] != "FAIL" or missing != set(slots) - written:
        raise AssertionError(f"eval_clip_score --certify: rc {certify_rc}, {report}")
    print(f"eval_clip_score --selftest: {scores}; --certify on the checkpoints phase's root: "
          f"{report['certify']} (exit code {certify_rc}), present {sorted(set(slots) - missing)}, "
          f"MISSING {sorted(missing)}", flush=True)

    pipe = build_pipeline(models, config, [(PROMPT, 1.0)], SamplerConfig(steps=10, eta=0.8))
    steps, caps = compute_phase_segments(pipe, 10)[0]
    tables = schedule_tables(pipe.schedule, dev)
    draws = TorchDraws(5, dev)
    x = draws.initial_noise((1, config.height, config.width, 3))
    with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
        _zero_launches()
        with trace(tmp) as path:
            with annotate("traced_guided_step"):
                guided_step(pipe, tables, x, int(steps[0]), draws)
            torch.cuda.synchronize()
        launches["trace"] = _launches()
        with open(path, encoding="utf-8") as f:
            text = f.read()
        size = os.path.getsize(path)
    if "traced_guided_step" not in text or launches["trace"] != _expected(1):
        raise AssertionError(f"trace: annotate name found {'traced_guided_step' in text}, "
                             f"launches {launches['trace']}")
    print(f"trace: one guided step at caps {caps} written as a {size / 2**20:.1f} MiB Chrome "
          f"trace holding its annotate name; quantile kernel launches {launches['trace']}",
          flush=True)
    return launches


def run_sdxl_graph(dev) -> dict:
    """Phase 22: SDXL base 1.0's UNet replayed from its CUDA graph at the
    SDXL cell's CFG shape against its eager forward (see the module
    docstring)."""
    cfg = ldm_unet.LDMUNetConfig.sdxl()
    with torch.device(dev):
        unet = ldm_unet.LDMUNet(cfg).requires_grad_(False)
    g = torch.Generator(dev).manual_seed(15)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            noise = torch.randn(p.shape, generator=g, device=dev)
            if p.dim() > 1:
                p.copy_(noise * p[0].numel() ** -0.5)
            else:
                p.copy_(noise * 0.1 + float(name.endswith("weight")))
    params = _param_count(unet)

    def inputs(seed):
        gi = torch.Generator(dev).manual_seed(seed)
        return (torch.randn((6, 128, 128, 4), generator=gi, device=dev),
                torch.randint(1, 1000, (6,), generator=gi, device=dev).float(),
                torch.randn((6, 77, cfg.context_dim), generator=gi, device=dev),
                torch.randn((6, cfg.adm_in_channels), generator=gi, device=dev))

    with torch.inference_mode():
        # the capture empties the cache on entry: blocks cached by earlier
        # phases must not count against it, the eager forward's own do
        torch.cuda.empty_cache()
        unet._forward(*inputs(0))
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        gaps = []
        for k in range(2):
            args = inputs(1 + k)
            got = unet(*args)
            want = unet._forward(*args)
            gaps.append((got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"sdxl: graphed forward differs from eager by {gaps[-1]}")
        before = ldm_unet.attention.calls, ldm_unet.attention.kernel_launches
        unet(*args)
        calls = ldm_unet.attention.calls - before[0]
        launches = ldm_unet.attention.kernel_launches - before[1]
        replay_ms = profiled_device_ms(lambda: unet(*args))
        eager_ms = profiled_device_ms(lambda: unet._forward(*args))
    captured = torch.cuda.memory_reserved(dev) - reserved
    print(f"sdxl: UNet {params:,} parameters, graphed = eager bit for bit at 6 x 128 x 128 x 4 "
          f"(largest gaps {gaps}, |eps| max {want.abs().max().item():.4f}); device "
          f"{replay_ms:.2f} ms a replayed forward, {eager_ms:.2f} ms eager; {calls} attention "
          f"calls and {launches} fused kernel launches a forward; the capture reserved "
          f"{captured / 2 ** 20:.1f} MiB", flush=True)
    if calls != 140 or launches != 140 or params != 2567463684:
        raise AssertionError(f"sdxl: {calls} attention calls, {launches} launches, "
                             f"{params} parameters")
    del unet, got, want
    torch.cuda.empty_cache()
    return {"replay_ms": replay_ms, "eager_ms": eager_ms, "attention_calls": calls,
            "attention_kernel_launches": launches}


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
    attention_record = check_attention_kernel(dev)

    phase("reference", t_start)
    check_reference(dev)

    phase("latent reference", t_start)
    check_latent_reference(dev)

    phase("zoo", t_start)
    zoo = build_zoo(dev)
    main_config = Config(width=512, height=512, num_cutout_batches=4,
                         chosen_clip_models=PERCEPTORS)
    main_models = zoo_subset(zoo, PERCEPTORS)

    phase("checkpoints", t_start)
    # release files of the main path's zoo, kept for the server and tools
    # phases (a TemporaryDirectory is removed at exit, also when a phase
    # fails)
    weights = tempfile.TemporaryDirectory(prefix="release_weights_")
    check_checkpoints(dev, main_models, main_config, weights.name)

    phase("main path", t_start)
    main_run = run_path("main path", main_models, args.steps, (512, 512, 3),
                        os.path.join(args.out, "main"), steps=args.steps, config=main_config)
    for rec in records:
        rec["launches"] = main_run["launches"][rec["name"]]
        if QUANTILE_KERNELS[rec["name"]]["on_path"] and rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was not launched on the main path")
    by_path = {"main path": main_run["launches"]}

    phase("default request", t_start)
    default = Config()
    default_models = zoo_subset(zoo, default.chosen_clip_models)
    by_path["default request"] = run_path(
        "default request", default_models, args.steps, (default.height, default.width, 3),
        os.path.join(args.out, "default"), steps=args.steps)["launches"]  # no config: Config()
    check_tower_graphs(dev, default_models, default)

    phase("init-image path", t_start)
    by_path["init-image path"] = run_init_path(zoo, os.path.join(args.out, "init"))["launches"]

    phase("text front end", t_start)
    by_path.update(run_text_front_end(dev, zoo, main_models, main_config, args.steps,
                                      main_run["image"], os.path.join(args.out, "text")))

    phase("server", t_start)
    by_path.update(run_server(main_models, main_config, weights.name, args.steps,
                              os.path.join(args.out, "server")))

    phase("profile", t_start)
    # the main path alone: the tools phase's profile_step gives each cutout
    # phase's step cost on the main path's and the default request's zoos
    profile_steps(dev, "main", main_models, main_config, 2, args.out)

    phase("latent zoo", t_start)
    latent_pipe, text_encode, esrgan = build_latent_zoo(dev)

    phase("latent request", t_start)
    by_path["latent request"] = run_latent_request(dev, latent_pipe, esrgan,
                                                   os.path.join(args.out, "latent"))

    phase("inpainting path", t_start)
    by_path["inpainting path"] = run_inpainting_path(dev, latent_pipe, text_encode,
                                                     os.path.join(args.out, "inpaint"))

    phase("latent profile", t_start)
    by_path["latent profile"] = profile_latent(dev, latent_pipe, text_encode, esrgan, args.out)

    phase("batch serving", t_start)
    port_dist.init(dev, init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        print(f"process group: {torch_dist.get_backend()}, world size "
              f"{torch_dist.get_world_size()}", flush=True)
        by_path.update(run_batch_serving(main_models, main_config, latent_pipe, text_encode,
                                         os.path.join(args.out, "serving")))
        phase("ensemble", t_start)
        by_path["ensemble"] = run_full_width_ensemble(dev, zoo, main_config)
    finally:
        torch_dist.destroy_process_group()
    run_two_rank_gloo(dev)

    phase("resume", t_start)
    by_path["resume"] = run_resume(dev, main_models, main_config, args.steps)

    phase("tools", t_start)
    by_path.update(run_tools(dev, main_models, main_config, default_models, weights.name))
    weights.cleanup()

    phase("sdxl", t_start)
    sdxl = run_sdxl_graph(dev)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in by_path.items()}
    attention_record["launches_by_path"] = {
        **{path: counts["ldm_softmax_attention"] for path, counts in by_path.items()},
        "sdxl": sdxl["attention_kernel_launches"]}
    print(json.dumps({"kernels": records + [attention_record]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
