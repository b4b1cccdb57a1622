"""The latent request's cells: whole requests back to back through the
program's `sample.latent_diffusion_sample`, each image x4 upscaled.

The stack (`zoo.build_latent_pipeline` over the LDM UNet, VQ-f8 and BERT)
and the upscaler (`functools.partial(models.esrgan.upscale, model)`) are
built by the benchmark with weights from the seed; every request writes
its images and their upscales under TMPDIR through a `LocalUploader`.

The check: one request drawn from the seed among the first
`check_within_requests`, all its iterations.  The float32 reference runs
each iteration's text encoding, CFG DDIM loop and VQ decode from the same
keyed noise and is held against the 256x256 PNGs the program wrote; it
upscales each PNG the program wrote (the program's own input to its
upscaler) and is held against the upscaled PNG.
"""

from __future__ import annotations

import functools
import gc
import os
import shutil
import sys
import time
from typing import Dict

import numpy as np
import torch

from port_bench import flops, harness, weights
from port_bench.reference import latent as rl
from port_bench.reference import layers
from port_bench.trace import DeviceTrace, Ranges

TAG_UNET, TAG_VQ, TAG_BERT, TAG_SR, TAG_REQ, TAG_CHECK = 21, 22, 23, 24, 25, 26
WARMUP_REQUEST = 1_000_000


def _dt(cfg, part) -> torch.dtype:
    return getattr(torch, cfg["dtypes"][part])


def build_models(cfg: dict, seed: int, device):
    """The port's LDM UNet, VQ, BERT and RRDBNet with weights from the seed
    -> (LatentModels, RRDBNet, weight specs)."""
    from clip_diffusion_tpu_torch.models import from_jax
    from clip_diffusion_tpu_torch.models.esrgan import RRDBNet
    from clip_diffusion_tpu_torch.models.ldm.autoencoder import VQConfig, VQModel
    from clip_diffusion_tpu_torch.models.ldm.bert import BERTConfig, BERTEmbedder
    from clip_diffusion_tpu_torch.models.ldm.unet import LDMUNet, LDMUNetConfig
    from clip_diffusion_tpu_torch.zoo import LatentModels

    parts = {
        "unet": (lambda: LDMUNet(LDMUNetConfig(**harness.tuples(cfg["unet"]), dtype=_dt(cfg, "unet"))),
                 from_jax.ldm_unet_rule, TAG_UNET),
        "vq": (lambda: VQModel(VQConfig(**harness.tuples(cfg["vq"]), dtype=_dt(cfg, "vq"))),
               from_jax.vq_rule, TAG_VQ),
        "bert": (lambda: BERTEmbedder(BERTConfig(**cfg["bert"], dtype=_dt(cfg, "bert"))),
                 from_jax.bert_rule, TAG_BERT),
        "esrgan": (lambda: RRDBNet(**cfg["esrgan"]), from_jax.esrgan_rule, TAG_SR),
    }
    built, specs = {}, {}
    for part, (build, rule, tag) in parts.items():
        with torch.device("meta"):
            module = build()
        specs[part] = weights.spec_from_layout(module, rule)
        built[part] = weights.load(module, weights.make_state_dict(
            specs[part], seed, tag, _dt(cfg, part), device))
    return LatentModels(built["unet"], built["vq"], built["bert"]), built["esrgan"], specs


def request_seed(seed: int, k: int) -> int:
    """Request k's seed (never 0, which the entry reads as "draw one")."""
    return weights.derive_seed(seed, TAG_REQ, k) % (2 ** 31 - 1) + 1


class Program:
    def __init__(self, cell, seed: int, device, out_dir: str):
        from clip_diffusion_tpu_torch.models.esrgan import upscale
        from clip_diffusion_tpu_torch.zoo import build_latent_pipeline

        self.req, self.seed, self.device, self.out_dir = cell.traffic["request"], seed, device, \
            out_dir
        self.models, self.esrgan, self.specs = build_models(cell.config, seed, device)
        self.pipe, self.text_encode = build_latent_pipeline(self.models)
        self.upscaler = functools.partial(upscale, self.esrgan, tile=self.req["upscale_tile"])

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
            pipe=self.pipe, text_encode=self.text_encode, upscaler=self.upscaler,
            uploader=LocalUploader(out), output_dir=out, device=self.device)
        return out

    def close(self):
        del self.pipe, self.text_encode, self.models, self.esrgan, self.upscaler
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

    u, v, b, e = harness.tuples(cfg["unet"]), harness.tuples(cfg["vq"]), cfg["bert"], cfg["esrgan"]
    return {
        "unet": load("unet", lambda: rl.LDMUNet(**u), TAG_UNET),
        "vq": load("vq", lambda: rl.VQModel(v), TAG_VQ),
        "bert": load("bert", lambda: rl.BERTEmbedder(**b), TAG_BERT),
        "esrgan": load("esrgan", lambda: rl.RRDBNet(e["num_feat"], e["num_block"],
                                                    e["num_grow_ch"]), TAG_SR),
    }


def to_u8(images01: torch.Tensor) -> np.ndarray:
    """[0, 1] float -> the uint8 a PNG holds (round half up, clipped)."""
    return (np.clip(images01.float().cpu().numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def _gap(got: np.ndarray, want: np.ndarray):
    if got.shape != want.shape:
        return float("inf"), float("inf")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return float(d.mean()), float(d.max())


def _rel(got, want, base) -> float:
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).float().norm() / torch.clamp_min((want - base).float().norm(),
                                                                1e-30))


class Recorder:
    """What the check follows the program's sampler by, while registered:
    a forward hook on the program's UNet keeps every call's input latents
    and output, and the context of each iteration's first call; a wrapper
    put on the VQ instance's `nearest_codes` keeps the latents each decode
    quantises (the sampler's result)."""

    def __init__(self, models, steps: int):
        self.steps, self.calls, self.contexts, self.latents = steps, [], [], []
        self._vq = models.vq
        self._hook = models.unet.register_forward_hook(self._record)
        nearest = models.vq.nearest_codes

        def recording_nearest_codes(z):
            self.latents.append(z.detach().float().clone())
            return nearest(z)
        models.vq.nearest_codes = recording_nearest_codes

    def _record(self, module, args, out):
        x, t, ctx = args
        if len(self.calls) % self.steps == 0:
            self.contexts.append(ctx.detach().float().clone())
        self.calls.append((x.detach().float().clone(), out.detach().float().clone()))

    def remove(self):
        self._hook.remove()
        del self._vq.nearest_codes  # the class's method again


def _lower(fn, tf32: bool):
    """`fn()` in the control's precision: TF32 for the float32 parts,
    float8 operands for the bfloat16 ones."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        if tf32:
            return fn()
        with layers.fp8():
            return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def compare(models, cfg: dict, req: dict, request_dir: str, req_seed: int, rec: Recorder,
            device, control: bool = False) -> Dict[str, float]:
    """The numbers compared over a whole request.

    The sampler is followed step by step from the program's own state
    (`rec`): step 0 from the reference's own keyed noise, each later step
    from the latents the program fed its UNet, each decode from the
    latents the program's sampler returned.
    context_rel: the largest ||context - reference|| / ||reference|| of an
    iteration's BERT context (conditional and empty prompt, interleaved).
    step_rel: the largest ||x_next - reference|| / ||reference - x|| of a
    step: the reference's CFG DDIM step from the same x with its own
    context, against what the program fed its next UNet call (the latents
    it decoded, after the last step).
    image_mean, image_max: the largest mean and largest |PNG - reference|
    of a 256x256 image in PNG levels, the reference decoding the program's
    latents.  sr_mean, sr_max: the same of each x4 upscale against the
    reference's upscale of the program's own PNG.  `control` puts the
    reference's lower-precision twin in the program's place at every
    stage: float8 operands in BERT and the UNet, TF32 in the VQ and
    RRDBNet."""
    r = req
    n, its, steps = r["num_batches"], r["num_iterations"], r["diffusion_steps"]
    f, c = 2 ** (len(cfg["vq"]["ch_mult"]) - 1), cfg["vq"]["embed_dim"]
    h, w = r["sample_height"] // f, r["sample_width"] // f
    scale = r["latent_diffusion_guidance_scale"]
    folder = os.path.join(request_dir, "latent")
    tables = rl.ddim_tables(steps)
    out = {k: 0.0 for k in ("context_rel", "step_rel", "image_mean", "image_max", "sr_mean",
                            "sr_max")}
    bert, unet, vq, sr = models["bert"], models["unet"], models["vq"], models["esrgan"]

    def decode01(z):
        return torch.clamp((vq.decode(z) + 1.0) / 2.0, 0.0, 1.0)

    with torch.no_grad():
        tok_c = torch.from_numpy(rl.bert_tokenize([r["prompt"]] * n)).to(device)
        tok_u = torch.from_numpy(rl.bert_tokenize([""] * n)).to(device)
        ctx = rl.interleave(bert(tok_u), bert(tok_c))
        if control:
            got_ctx = _lower(lambda: rl.interleave(bert(tok_u), bert(tok_c)), tf32=False)
        for it in range(its):
            if not control:
                got_ctx = rec.contexts[it]
            out["context_rel"] = max(out["context_rel"], _rel(got_ctx, ctx, 0 * ctx))
            calls = rec.calls[it * steps:(it + 1) * steps]
            x = rl.initial_noise(req_seed, it, (n, h, w, c), device)
            for k in range(steps):
                i = steps - 1 - k
                nxt = calls[k + 1][0][0::2] if k + 1 < steps else rec.latents[it]
                want = rl.cfg_step(unet, x, i, tables, ctx, scale)
                got = (_lower(lambda: rl.cfg_step(unet, x, i, tables, got_ctx, scale),
                              tf32=False) if control else nxt)
                out["step_rel"] = max(out["step_rel"], _rel(got, want, x))
                if nxt.shape != want.shape:  # a batch that is not the request's
                    break
                x = nxt
            z = rec.latents[it]
            ref_img = to_u8(decode01(z))
            got_img = (to_u8(_lower(lambda: decode01(z), tf32=True)) if control else
                       np.stack([read_png(os.path.join(folder, f"latent_{it * n + j}.png"))
                                 for j in range(n)]))
            for j in range(n):
                mean, mx = _gap(got_img[j], ref_img[j])
                out["image_mean"] = max(out["image_mean"], mean)
                out["image_max"] = max(out["image_max"], mx)
                png = read_png(os.path.join(folder, f"latent_{it * n + j}.png"))
                x01 = torch.from_numpy(png.astype(np.float32) / 255.0)[None].to(device)
                sr_ref = to_u8(sr(x01))[0]
                sr_got = (to_u8(_lower(lambda: sr(x01), tf32=True))[0] if control else
                          read_png(os.path.join(folder, "sr", f"latent_{it * n + j}.png")))
                mean, mx = _gap(sr_got, sr_ref)
                out["sr_mean"] = max(out["sr_mean"], mean)
                out["sr_max"] = max(out["sr_max"], mx)
    return out


def check_unit(traffic: dict, seed: int) -> int:
    """The request the check follows, drawn from the seed."""
    rng = np.random.default_rng(weights.derive_seed(seed, TAG_CHECK))
    return int(rng.integers(traffic["check_within_requests"]))


def judge(cell, seed: int, specs, k: int, request_dir: str, rec: Recorder, device,
          control: bool = False) -> Dict[str, Dict[str, float]]:
    """Once the program is freed: the reference from the seed, then the
    numbers compared of the program's request `k` ("program") and, with
    `control`, of the control ("control")."""
    models = reference_models(cell.config, seed, specs, device)
    req, rs = cell.traffic["request"], request_seed(seed, k)
    got = {"program": compare(models, cell.config, req, request_dir, rs, rec, device)}
    if control:
        got["control"] = compare(models, cell.config, req, request_dir, rs, rec, device,
                                 control=True)
    return got


def readings(cell, seed: int, device, control: bool = False):
    """The check of a run, untimed: the check request through the program,
    then `judge` (for `port_bench.control`)."""
    out_dir = harness.output_dir(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    prog = Program(cell, seed, device, out_dir)
    k = check_unit(cell.traffic, seed)
    rec = Recorder(prog.models, cell.traffic["request"]["diffusion_steps"])
    folder = prog.request(k)
    rec.remove()
    specs = prog.specs
    prog.close()
    del prog
    got = judge(cell, seed, specs, k, folder, rec, device, control)
    shutil.rmtree(out_dir, ignore_errors=True)
    return got


# ---- FLOPs -------------------------------------------------------------------

def flops_per_request(cell) -> int:
    """Model FLOPs of one request from the reference at the cell's shapes:
    BERT over the prompt and the empty prompt, 2 x steps x iterations UNet
    forwards at twice the batch, a VQ decode per iteration and an RRDBNet
    x4 forward per image."""
    cfg, r = cell.config, cell.traffic["request"]
    u, v, b, e = harness.tuples(cfg["unet"]), harness.tuples(cfg["vq"]), cfg["bert"], cfg["esrgan"]
    n, its, steps = r["num_batches"], r["num_iterations"], r["diffusion_steps"]
    f = 2 ** (len(v["ch_mult"]) - 1)
    h, w = r["sample_height"] // f, r["sample_width"] // f
    m = "meta"
    bert = flops.on_meta(lambda: rl.BERTEmbedder(**b))
    unet = flops.on_meta(lambda: rl.LDMUNet(**u))
    vq = flops.on_meta(lambda: rl.VQModel(v))
    sr = flops.on_meta(lambda: rl.RRDBNet(e["num_feat"], e["num_block"], e["num_grow_ch"]))
    toks = torch.zeros((n, b["max_seq_len"]), dtype=torch.long, device=m)
    f_bert = flops.count(bert, toks)
    ctx = torch.zeros((2 * n, b["max_seq_len"], b["n_embed"]), device=m)
    f_unet = flops.count(unet, torch.zeros((2 * n, h, w, u["in_channels"]), device=m),
                         torch.zeros((2 * n,), device=m), ctx)
    f_vq = flops.count(vq.decode, torch.zeros((n, h, w, v["embed_dim"]), device=m))
    f_sr = flops.count(sr, torch.zeros((1, r["sample_height"], r["sample_width"], 3), device=m))
    return 2 * f_bert + its * (steps * f_unet + f_vq) + its * n * f_sr


# ---- the run -----------------------------------------------------------------

def run(cell, seed, seconds, trace_on, device) -> "harness.Outcome":
    out_dir = harness.output_dir(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    traffic, req = cell.traffic, cell.traffic["request"]

    t_setup = time.perf_counter()
    prog = Program(cell, seed, device, out_dir)
    t_models = time.perf_counter() - t_setup
    # one CFG step at the request's batch, one decode, the upscales, the PNGs
    warm = prog.request(WARMUP_REQUEST, num_iterations=1, diffusion_steps=1)
    shutil.rmtree(warm, ignore_errors=True)
    sync()
    setup_s = time.perf_counter() - t_setup
    print(f"setup: {setup_s:.3f} s (imports and models {t_models:.3f} s; warm-up request "
          f"{setup_s - t_models:.3f} s)", flush=True, file=sys.stderr)

    check_k = check_unit(traffic, seed)
    ranges = Ranges(device) if trace_on else None
    # the traced request comes after those the check may follow
    traced_k = traffic["check_within_requests"] if trace_on else -1
    hooks = []
    if trace_on:
        DeviceTrace(device).warm_up()
        hooks += ranges.hook(prog.models.unet, "unet")
        prog.upscaler = ranges.wrap(prog.upscaler, "upscale")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trace, done = None, 0
    sync()
    t0 = time.perf_counter()
    rec = None
    while done <= max(check_k, traced_k) or time.perf_counter() - t0 < seconds:
        if done == check_k:
            rec = Recorder(prog.models, req["diffusion_steps"])
        if done == traced_k:
            with DeviceTrace(device, ranges) as dt:
                prog.request(done)
            trace = dt.trace
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
    numbers = judge(cell, seed, specs, check_k, os.path.join(out_dir, f"req{check_k}"), rec,
                    device)["program"]
    print(f"check: {time.perf_counter() - t_check:.3f} s; "
          + " ".join(f"{k}={v!r}" for k, v in numbers.items()), file=sys.stderr)
    facts: Dict[str, float] = {}
    if trace_on and trace is not None:
        facts["flops_per_request"] = flops_per_request(cell)
    shutil.rmtree(out_dir, ignore_errors=True)
    return harness.Outcome(attempted=done, failed=0, values=values,
                           checks=[(k, numbers[k], float(lim))
                                   for k, lim in cell.config["limits"].items()],
                           memory_peak_bytes=peak, trace=trace, facts=facts)
