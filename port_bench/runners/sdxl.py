"""The SDXL base 1.0 cell: whole requests back to back through the
program's `sample.latent_diffusion_sample` with the SDXL stack
(`zoo.build_sdxl_pipeline` over the UNet, the CLIP ViT-L/14 and OpenCLIP
ViT-bigG/14 text towers and the KL-f8 first stage), no upscaler.

The stack is built by the benchmark with weights from the seed; every
request writes its images under TMPDIR through a `LocalUploader`.
Set-up runs one request of one CFG step at the request's shapes, which
captures the UNet's CUDA graph and runs the decode at full size.

The check: one request drawn from the seed among the first
`check_within_requests`, followed step by step from the program's own
state.  The float32 reference encodes the prompt and the empty prompt
(`context_rel`, `vector_rel` against what the program fed its UNet); each
checked CFG step runs at batch 2, one image's unconditional and
conditional pair, from the latents the program fed its UNet (step 0 from
the reference's own keyed noise), against the latents the program fed its
next call (`step_rel`), the image of each step taken from permutations of
the images drawn from the seed, so that every image is covered; the
reference decodes the program's final latents of each image against the
PNG the program wrote (`image_mean`, with `image_max` printed beside it).
Every step is checked: all 50 take about 23 s on an H100.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench import flops, harness, weights
from port_bench.reference import sdxl as rs
from port_bench.runners.latent import _gap, _lower, _rel, read_png, to_u8
from port_bench.trace import DeviceTrace, Ranges

TAG_UNET, TAG_CLIP_L, TAG_CLIP_G, TAG_VAE, TAG_REQ, TAG_CHECK = 31, 32, 33, 34, 35, 36
WARMUP_REQUEST = 1_000_000
PARTS = ("unet", "clip_l", "clip_g", "vae")


def _dt(cfg, part) -> torch.dtype:
    return getattr(torch, cfg["dtypes"][part])


def build_models(cfg: dict, seed: int, device):
    """The port's SDXL UNet, text towers and KL-f8 stage with weights from
    the seed -> (zoo.SDXLModels, weight specs)."""
    from clip_diffusion_tpu_torch.models import from_jax
    from clip_diffusion_tpu_torch.models.clip.model import CLIPTextConfig, CLIPTextModel
    from clip_diffusion_tpu_torch.models.ldm.autoencoder import KLConfig, KLModel
    from clip_diffusion_tpu_torch.models.ldm.unet import LDMUNet, LDMUNetConfig
    from clip_diffusion_tpu_torch.zoo import SDXLConfig, SDXLModels

    configs = {
        "unet": LDMUNetConfig(**harness.tuples(cfg["unet"]), dtype=_dt(cfg, "unet")),
        "clip_l": CLIPTextConfig(**cfg["clip_l"], dtype=_dt(cfg, "clip_l")),
        "clip_g": CLIPTextConfig(**cfg["clip_g"], dtype=_dt(cfg, "clip_g")),
        "vae": KLConfig(**harness.tuples(cfg["vae"]), dtype=_dt(cfg, "vae")),
    }
    parts = {"unet": (LDMUNet, from_jax.sdxl_unet_rule, TAG_UNET),
             "clip_l": (CLIPTextModel, from_jax.clip_rule, TAG_CLIP_L),
             "clip_g": (CLIPTextModel, from_jax.clip_rule, TAG_CLIP_G),
             "vae": (KLModel, from_jax.vq_rule, TAG_VAE)}
    built, specs = {}, {}
    for part, (cls, rule, tag) in parts.items():
        with torch.device("meta"):
            module = cls(configs[part])
        specs[part] = weights.spec_from_layout(module, rule)
        built[part] = weights.load(module, weights.make_state_dict(
            specs[part], seed, tag, _dt(cfg, part), device))
    c = cfg["conditioning"]
    sdxl = SDXLConfig(unet=configs["unet"], clip_l=configs["clip_l"], clip_g=configs["clip_g"],
                      vae=configs["vae"], clip_l_layer=c["clip_l_layer"],
                      clip_g_layer=c["clip_g_layer"], size_embed_dim=c["size_embed_dim"])
    return SDXLModels(sdxl, *(built[p] for p in PARTS)), specs


def request_seed(seed: int, k: int) -> int:
    """Request k's seed (never 0, which the entry reads as "draw one")."""
    return weights.derive_seed(seed, TAG_REQ, k) % (2 ** 31 - 1) + 1


class Program:
    def __init__(self, cell, seed: int, device, out_dir: str):
        from clip_diffusion_tpu_torch.zoo import build_sdxl_pipeline

        self.req, self.seed, self.device, self.out_dir = cell.traffic["request"], seed, device, \
            out_dir
        self.models, self.specs = build_models(cell.config, seed, device)
        c = cell.config["conditioning"]
        self.pipe, self.text_encode = build_sdxl_pipeline(
            self.models, c["original_size"], c["crop_coords_top_left"], c["target_size"])

    def request(self, k: int, **changes):
        """Request k, whole, into <out>/req<k> -> its output directory."""
        from clip_diffusion_tpu_torch.sample import latent_diffusion_sample
        from clip_diffusion_tpu_torch.utils.progress import LocalUploader

        out = os.path.join(self.out_dir, f"req{k}")
        r = dict(self.req, **changes)
        latent_diffusion_sample(
            r["prompt"], seed=request_seed(self.seed, k), sample_mode=r["sample_mode"],
            diffusion_steps=r["diffusion_steps"], eta=r["eta"],
            latent_diffusion_guidance_scale=r["latent_diffusion_guidance_scale"],
            num_iterations=r["num_iterations"], num_batches=r["num_batches"],
            sample_width=r["sample_width"], sample_height=r["sample_height"],
            pipe=self.pipe, text_encode=self.text_encode, upscaler=None,
            uploader=LocalUploader(out), output_dir=out, device=self.device)
        return out

    def close(self):
        del self.pipe, self.text_encode, self.models
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---- the reference and the numbers compared ------------------------------------

def reference_models(cfg: dict, seed: int, specs: Dict, device):
    def load(part, build, tag):
        with torch.device("meta"):
            module = build()
        return weights.load(module, weights.as_float32(
            weights.make_state_dict(specs[part], seed, tag, _dt(cfg, part), device)))

    u = harness.tuples(cfg["unet"])
    return {
        "unet": load("unet", lambda: rs.SDXLUNet(**u), TAG_UNET),
        "clip_l": load("clip_l", lambda: rs.TextTower(**cfg["clip_l"]), TAG_CLIP_L),
        "clip_g": load("clip_g", lambda: rs.TextTower(**cfg["clip_g"]), TAG_CLIP_G),
        "vae": load("vae", lambda: rs.KLModel(cfg["vae"]), TAG_VAE),
    }


class Recorder:
    """What the check follows the program's sampler by, while registered:
    a forward hook on the program's UNet keeps every call's input latents,
    and the context and vector of the first call; a wrapper put in the
    program's pipeline around the first-stage decode keeps the latents
    each decode takes (the sampler's result)."""

    def __init__(self, prog: Program):
        self.calls: List[torch.Tensor] = []
        self.context = self.vector = None
        self.latents: List[torch.Tensor] = []
        self._prog, self._pipe = prog, prog.pipe
        self._hook = prog.models.unet.register_forward_hook(self._record)
        decode = prog.pipe.decode

        def recording_decode(z):
            self.latents.append(z.detach().float().clone())
            return decode(z)
        prog.pipe = dataclasses.replace(prog.pipe, decode=recording_decode)

    def _record(self, module, args, out):
        x, _, ctx, vec = args
        if not self.calls:
            self.context, self.vector = ctx.detach().float().clone(), vec.detach().float().clone()
        self.calls.append(x.detach().float().clone())

    def remove(self):
        self._hook.remove()
        self._prog.pipe = self._pipe


def compare(models, cfg: dict, req: dict, request_dir: str, req_seed: int, rec: Recorder,
            pairs: List[Tuple[int, int]], device, control: bool = False) -> Dict[str, float]:
    """The numbers compared over the check request's first iteration.

    context_rel, vector_rel: ||got - reference|| / ||reference|| of the
    UNet's context and vector (prompt and empty prompt, interleaved).
    step_rel: the largest ||x_next - reference|| / ||reference - x|| of a
    checked (step, image) pair in `pairs`: the reference's CFG DDIM step at
    batch 2 from the image's x with its own conditioning, against what the
    program fed its next UNet call for that image (the latents it decoded,
    after the last step).  image_mean, image_max: the largest mean and
    largest |PNG - reference| of an image in PNG levels, the reference
    decoding the program's final latents.  `control` puts the reference's
    lower-precision twin in the program's place: float8 operands in the
    text towers and the UNet, TF32 in the VAE."""
    r, c = req, cfg["conditioning"]
    n, steps = r["num_batches"], r["diffusion_steps"]
    f, ch = 2 ** (len(cfg["vae"]["ch_mult"]) - 1), cfg["vae"]["embed_dim"]
    h, w = r["sample_height"] // f, r["sample_width"] // f
    scale = r["latent_diffusion_guidance_scale"]
    folder = os.path.join(request_dir, "latent")
    tables = rs.ddim_tables(steps)
    out = {k: 0.0 for k in ("context_rel", "vector_rel", "step_rel", "image_mean", "image_max")}
    unet, vae = models["unet"], models["vae"]

    def encode():
        cc, vc = rs.conditioning(models["clip_l"], models["clip_g"], [r["prompt"]] * n, c, device)
        cu, vu = rs.conditioning(models["clip_l"], models["clip_g"], [""] * n, c, device)
        return rs.interleave(cu, cc), rs.interleave(vu, vc)

    def decode01(z):
        return torch.clamp((vae.decode(z) + 1.0) / 2.0, 0.0, 1.0)

    with torch.no_grad():
        ctx, vec = encode()
        got_ctx, got_vec = _lower(encode, tf32=False) if control else (rec.context, rec.vector)
        out["context_rel"] = _rel(got_ctx, ctx, 0 * ctx)
        out["vector_rel"] = _rel(got_vec, vec, 0 * vec)
        x0 = rs.initial_noise(req_seed, 0, (n, h, w, ch), device)
        final = rec.latents[0] if rec.latents else torch.empty(0, device=device)
        for k, j in pairs:
            i = steps - 1 - k
            x = x0[j:j + 1] if k == 0 else rec.calls[k][2 * j:2 * j + 1]
            nxt = rec.calls[k + 1][2 * j:2 * j + 1] if k + 1 < steps else final[j:j + 1]
            pair = slice(2 * j, 2 * j + 2)
            if x.shape != (1, h, w, ch):  # a batch that is not the request's
                out["step_rel"] = float("inf")
                continue
            want = rs.cfg_step(unet, x, i, tables, ctx[pair], vec[pair], scale)
            got = (_lower(lambda: rs.cfg_step(unet, x, i, tables, got_ctx[pair], got_vec[pair],
                                              scale), tf32=False) if control else nxt)
            out["step_rel"] = max(out["step_rel"], _rel(got, want, x))
        for j in range(n):
            z = final[j:j + 1]
            if z.shape != (1, h, w, ch):
                out["image_mean"] = out["image_max"] = float("inf")
                continue
            ref_img = to_u8(decode01(z))[0]
            got_img = (to_u8(_lower(lambda: decode01(z), tf32=True))[0] if control else
                       read_png(os.path.join(folder, f"latent_{j}.png")))
            mean, mx = _gap(got_img, ref_img)
            out["image_mean"] = max(out["image_mean"], mean)
            out["image_max"] = max(out["image_max"], mx)
    return out


def check_unit(traffic: dict, seed: int) -> Tuple[int, List[Tuple[int, int]]]:
    """The request the check follows and its (step, image) pairs, drawn
    from the seed: every step, their images from consecutive permutations
    of the images."""
    rng = np.random.default_rng(weights.derive_seed(seed, TAG_CHECK))
    k = int(rng.integers(traffic["check_within_requests"]))
    r = traffic["request"]
    steps, n = r["diffusion_steps"], r["num_batches"]
    images = np.concatenate([rng.permutation(n) for _ in range(-(-steps // n))])[:steps]
    return k, [(s, int(j)) for s, j in enumerate(images)]


def judge(cell, seed: int, specs, k: int, pairs, request_dir: str, rec: Recorder, device,
          control: bool = False) -> Dict[str, Dict[str, float]]:
    """Once the program is freed: the reference from the seed, then the
    numbers compared of the program's request `k` ("program") and, with
    `control`, of the control ("control")."""
    models = reference_models(cell.config, seed, specs, device)
    req, rseed = cell.traffic["request"], request_seed(seed, k)
    got = {"program": compare(models, cell.config, req, request_dir, rseed, rec, pairs, device)}
    if control:
        got["control"] = compare(models, cell.config, req, request_dir, rseed, rec, pairs,
                                 device, control=True)
    return got


def readings(cell, seed: int, device, control: bool = False):
    """The check of a run, untimed: the check request through the program,
    then `judge` (for `port_bench.control`)."""
    out_dir = harness.output_dir(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    prog = Program(cell, seed, device, out_dir)
    k, pairs = check_unit(cell.traffic, seed)
    rec = Recorder(prog)
    folder = prog.request(k)
    rec.remove()
    specs = prog.specs
    prog.close()
    del prog
    got = judge(cell, seed, specs, k, pairs, folder, rec, device, control)
    shutil.rmtree(out_dir, ignore_errors=True)
    return got


# ---- FLOPs -------------------------------------------------------------------

def flops_per_request(cell) -> int:
    """Model FLOPs of one request from the reference at the cell's shapes:
    both text towers over the prompt and the empty prompt, steps x
    iterations UNet forwards at twice the batch, a KL decode per
    iteration."""
    cfg, r = cell.config, cell.traffic["request"]
    c = cfg["conditioning"]
    n, its, steps = r["num_batches"], r["num_iterations"], r["diffusion_steps"]
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    h, w = r["sample_height"] // f, r["sample_width"] // f
    m = "meta"
    unet = flops.on_meta(lambda: rs.SDXLUNet(**harness.tuples(cfg["unet"])))
    towers = {p: flops.on_meta(lambda p=p: rs.TextTower(**cfg[p])) for p in ("clip_l", "clip_g")}
    vae = flops.on_meta(lambda: rs.KLModel(cfg["vae"]))
    toks = torch.zeros((n, 77), dtype=torch.long, device=m)
    f_text = sum(flops.count(lambda t, p=p: towers[p](t, c[f"{p}_layer"]), toks)
                 for p in towers)
    u = cfg["unet"]
    f_unet = flops.count(unet, torch.zeros((2 * n, h, w, u["in_channels"]), device=m),
                         torch.zeros((2 * n,), device=m),
                         torch.zeros((2 * n, 77, u["context_dim"]), device=m),
                         torch.zeros((2 * n, u["adm_in_channels"]), device=m))
    f_vae = flops.count(vae.decode, torch.zeros((n, h, w, cfg["vae"]["embed_dim"]), device=m))
    return 2 * f_text + its * (steps * f_unet + f_vae)


# ---- the run -----------------------------------------------------------------

def run(cell, seed, seconds, trace_on, device) -> "harness.Outcome":
    from clip_diffusion_tpu_torch.models.ldm import unet as ldm_unet

    out_dir = harness.output_dir(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    traffic, req = cell.traffic, cell.traffic["request"]

    t_setup = time.perf_counter()
    prog = Program(cell, seed, device, out_dir)
    t_models = time.perf_counter() - t_setup
    # one CFG step at the request's batch and size (the graph's capture), the decode, the PNGs
    warm = prog.request(WARMUP_REQUEST, num_iterations=1, diffusion_steps=1)
    shutil.rmtree(warm, ignore_errors=True)
    sync()
    setup_s = time.perf_counter() - t_setup
    print(f"setup: {setup_s:.3f} s (imports and models {t_models:.3f} s; warm-up request "
          f"{setup_s - t_models:.3f} s)", flush=True, file=sys.stderr)

    check_k, pairs = check_unit(traffic, seed)
    ranges = Ranges(device) if trace_on else None
    # the traced request comes after those the check may follow
    traced_k = traffic["check_within_requests"] if trace_on else -1
    hooks = []
    if trace_on:
        DeviceTrace(device).warm_up()
        hooks += ranges.hook(prog.models.unet, "unet")
        prog.pipe = dataclasses.replace(prog.pipe, decode=ranges.wrap(prog.pipe.decode, "vae"))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trace, done, calls = None, 0, 0
    sync()
    t0 = time.perf_counter()
    rec = None
    while done <= max(check_k, traced_k) or time.perf_counter() - t0 < seconds:
        if done == check_k:
            rec = Recorder(prog)
        if done == traced_k:
            before = ldm_unet.attention.calls
            with DeviceTrace(device, ranges) as dt:
                prog.request(done)
            trace, calls = dt.trace, ldm_unet.attention.calls - before
        else:
            prog.request(done)
        if done == check_k:
            rec.remove()
        sync()
        done += 1
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    for h in hooks:
        h.remove()

    values = {"latent_s_per_request": elapsed / done, "peak_gib": peak / 2 ** 30,
              "setup_s": setup_s}
    specs = prog.specs
    prog.close()
    del prog

    print(f"window: {elapsed:.3f} s, {done} requests", flush=True, file=sys.stderr)
    t_check = time.perf_counter()
    numbers = judge(cell, seed, specs, check_k, pairs, os.path.join(out_dir, f"req{check_k}"),
                    rec, device)["program"]
    print(f"check: {time.perf_counter() - t_check:.3f} s, {len(pairs)} steps; "
          + " ".join(f"{k}={v!r}" for k, v in numbers.items()), file=sys.stderr)
    facts: Dict[str, float] = {}
    if trace_on:
        facts.update(attention_calls=calls,
                     cfg_steps=req["num_iterations"] * req["diffusion_steps"],
                     images_per_decode=req["num_batches"])
        if trace is not None:
            facts["flops_per_request"] = flops_per_request(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    return harness.Outcome(attempted=done, failed=0, values=values,
                           checks=[(k, numbers[k], float(lim))
                                   for k, lim in cell.config["limits"].items()],
                           memory_peak_bytes=peak, trace=trace, facts=facts)
