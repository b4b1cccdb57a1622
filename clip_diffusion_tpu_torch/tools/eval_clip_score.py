"""CLIP-score parity harness and the deployment's acceptance gate.

    python3 -m clip_diffusion_tpu_torch.tools.eval_clip_score --images 'out/*.png' \\
        [--prompts prompts.txt] [--clip ViT-B/32] [--cpu]
    python3 -m clip_diffusion_tpu_torch.tools.eval_clip_score --selftest [--cpu]
    python3 -m clip_diffusion_tpu_torch.tools.eval_clip_score --certify \\
        [--generated DIR --reference-outputs DIR] [--score-tolerance 0.02] \\
        [--checkpoint-root DIR] [--cpu]

Counterpart of the JAX package's tools/eval_clip_score.py.  The score is
the cosine between the CLIP embeddings of an image (resize shorter side,
center crop, CLIP normalize) and of its prompt, over a fixed prompt suite
(`PROMPT_SUITE`, the JAX tool's) paired with the images in sorted order.

`--certify` is the acceptance gate of a provisioned deployment (after
`fetch_and_convert --all`): it reports each release-file slot the zoo's
gate reads under `$CLIP_DIFFUSION_TORCH` (default models/torch) as present
or MISSING (the three LDM slots share `ldm.pt`) and the tokenizer assets
under data/.  When every slot is present it builds the guided and latent
models through the gate (`zoo.build_models`, `zoo.build_latent_models`),
runs one forward per family that must be finite, and requires
`weights_provenance()` to be reference-comparable.  With `--generated` and
`--reference-outputs` it also scores both image sets on the suite and
requires |mean(ours) - mean(reference)| <= `--score-tolerance`.  It prints
one JSON line and exits 0 only on PASS.

Everything runs on `cuda` unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Callable, List, Sequence

import numpy as np
import torch

from clip_diffusion_tpu_torch.guidance.score import image_text_embeddings
from clip_diffusion_tpu_torch.tools.clip_score import read_image01
from clip_diffusion_tpu_torch.utils.device import resolve_device

# The fixed evaluation suite (stable across rounds for comparability).
PROMPT_SUITE = [
    "a cute golden retriever",
    "a lighthouse on a cliff at sunset, oil painting",
    "a futuristic city skyline at night, neon lights",
    "a bowl of fresh fruit on a wooden table",
    "an ancient castle in the mist, fantasy art",
    "a portrait of an astronaut, studio lighting",
    "a sailboat on a calm sea at dawn",
    "a snowy mountain landscape with pine trees",
]

# The release-file slots `fetch_and_convert --all` provisions (slot ->
# what it holds), and the file each is read from where slots share one.
CERTIFY_SLOTS = {
    "guided_unet_512": "ADM 552M UNet (reference models.py:95-116)",
    "clip_ViT-B_32": "CLIP ViT-B/32", "clip_ViT-B_16": "CLIP ViT-B/16",
    "clip_ViT-L_14": "CLIP ViT-L/14", "clip_RN50": "CLIP RN50",
    "clip_RN101": "CLIP RN101",
    "ldm_unet": "latent-diffusion UNet (1.45B stack)",
    "ldm_vq": "VQ-f8 autoencoder", "ldm_bert": "LDM BERT text encoder",
    "esrgan_x4": "Real-ESRGAN x4", "esrgan_x2": "Real-ESRGAN x2",
    "lpips_vgg": "LPIPS VGG16+lin",
}
SLOT_FILES = {"ldm_unet": "ldm", "ldm_vq": "ldm", "ldm_bert": "ldm"}
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")
CERTIFY_DATA_ASSETS = {
    "bpe_simple_vocab_16e6.txt.gz": "CLIP BPE vocabulary",
    "bert-base-uncased-vocab.txt": "BERT WordPiece vocab (LDM)",
    "t5-spiece.model": "sentence-T5 SentencePiece model",
    os.path.join("opencc", "tw2sp_phrases.tsv"): "OpenCC tw2sp phrase table",
}
OPTIONAL_ASSETS = {os.path.join("opencc", "tw2sp_phrases.tsv")}


def clip_score(embed_image: Callable, embed_text: Callable, images01: Sequence,
               prompts: Sequence[str], resolution: int = 224, *, device) -> List[float]:
    """Cosine similarity of each (image, prompt) pair, images HWC in [0, 1]:
    `guidance.score.image_text_embeddings` through `embed_image` and
    `embed_text` on `device`."""
    return [float(torch.dot(*image_text_embeddings(embed_image, embed_text, img, prompt,
                                                    resolution, device)))
            for img, prompt in zip(images01, prompts)]


def _image_paths(pattern: str) -> List[str]:
    return sorted(glob.glob(os.path.join(pattern, "*.png"))
                  + glob.glob(os.path.join(pattern, "*.jpg"))) or sorted(glob.glob(pattern))


def _score_images(paths: Sequence[str], prompts: Sequence[str], clip_name: str,
                  device) -> List[float]:
    from clip_diffusion_tpu_torch.zoo import build_clip

    model = build_clip(clip_name, device=device)
    return clip_score(model.encode_image, model.encode_text, [read_image01(p) for p in paths],
                      prompts[: len(paths)], model.cfg.image_resolution, device=device)


def _finite(out: torch.Tensor) -> str:
    return "finite" if bool(torch.isfinite(out.float()).all()) else "NON-FINITE"


def _forwards(device, root: str) -> dict:
    """One forward per family, built through the gate from `root`."""
    from clip_diffusion_tpu_torch.config import Config
    from clip_diffusion_tpu_torch.zoo import build_latent_models, build_models

    with torch.no_grad():
        models = build_models(Config(), image_size=512, with_lpips=True, device=device,
                              checkpoint_root=root)
        forwards = {"guided_unet_512": _finite(models.unet(
            torch.zeros((1, 64, 64, 3), device=device), torch.zeros((1,), device=device)))}
        for name, model in models.clips.items():
            res = model.cfg.image_resolution
            forwards[f"clip_{name.replace('/', '_')}"] = _finite(
                model.encode_image(torch.zeros((1, res, res, 3), device=device)))
        del models
        latent = build_latent_models(device=device, checkpoint_root=root)
        cfg = latent.unet.config
        forwards["ldm_unet"] = _finite(latent.unet(
            torch.zeros((1, 8, 8, cfg.in_channels), device=device),
            torch.zeros((1,), device=device),
            torch.zeros((1, 4, cfg.context_dim), device=device)))
    return forwards


def certify(args) -> int:
    from clip_diffusion_tpu_torch.zoo import checkpoint_path, torch_root, weights_provenance

    failures, checks = [], {}
    root = torch_root(args.checkpoint_root)
    slots = {}
    for slot, desc in CERTIFY_SLOTS.items():
        present = checkpoint_path(SLOT_FILES.get(slot, slot), root) is not None
        slots[slot] = "present" if present else "MISSING"
        if not present:
            failures.append(f"checkpoint slot {slot} ({desc})")
    checks["checkpoint_root"] = os.path.abspath(root)
    checks["checkpoint_slots"] = slots

    assets = {}
    for rel, desc in CERTIFY_DATA_ASSETS.items():
        ok = os.path.isfile(os.path.join(args.data_dir, rel))
        assets[f"data/{rel}"] = "present" if ok else "MISSING"
        if not ok and rel not in OPTIONAL_ASSETS:
            failures.append(f"data asset data/{rel} ({desc})")
    checks["data_assets"] = assets

    forwards = {}
    if all(v == "present" for v in slots.values()):
        try:
            forwards = _forwards(resolve_device("cpu" if args.cpu else None), root)
        except (RuntimeError, KeyError, ValueError) as e:  # a refused or failed load
            forwards["error"] = str(e)[:300]
            failures.append(f"validated load/forward: {e}")
        failures.extend(f"non-finite forward: {k}" for k, v in forwards.items()
                        if v == "NON-FINITE")
        prov = weights_provenance()
        checks["provenance"] = prov
        if not prov["reference_comparable"]:
            failures.append("provenance not reference-comparable "
                            f"(weights={prov['weights']}, tokenizer={prov['tokenizer']})")
    else:
        checks["provenance"] = "skipped (slots missing)"
    checks["forwards"] = forwards

    if args.generated and args.reference_outputs:
        device = resolve_device("cpu" if args.cpu else None)
        ours = _score_images(_image_paths(args.generated), PROMPT_SUITE, args.clip, device)
        ref = _score_images(_image_paths(args.reference_outputs), PROMPT_SUITE, args.clip, device)
        delta = abs(float(np.mean(ours)) - float(np.mean(ref)))
        checks["clip_score_parity"] = {
            "ours_mean": round(float(np.mean(ours)), 4),
            "reference_mean": round(float(np.mean(ref)), 4),
            "abs_delta": round(delta, 4), "tolerance": args.score_tolerance}
        if delta > args.score_tolerance:
            failures.append(f"clip-score delta {delta:.4f} > {args.score_tolerance}")
    else:
        checks["clip_score_parity"] = "skipped (pass --generated and --reference-outputs)"

    verdict = "PASS" if not failures else "FAIL"
    print(json.dumps({"certify": verdict, "failures": failures, "checks": checks}))
    return 0 if verdict == "PASS" else 1


def selftest(device) -> List[float]:
    """The wiring at tiny size: a seeded tiny CLIP scores two random images
    against the suite's first two prompts."""
    from clip_diffusion_tpu_torch.models import from_jax
    from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
    from clip_diffusion_tpu_torch.zoo import host_init_state_dict

    cfg = tiny_clip_config()
    model = CLIPModel(cfg)
    model.load_state_dict(host_init_state_dict(model, from_jax.clip_rule, 0, torch.float32))
    model = model.to(device).requires_grad_(False)
    imgs = [np.random.default_rng(i).uniform(0, 1, (64, 64, 3)) for i in range(2)]
    return clip_score(model.encode_image, model.encode_text, imgs, PROMPT_SUITE[:2],
                      cfg.image_resolution, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", nargs="*", default=[])
    p.add_argument("--prompts", default=None, help="a file of prompts, one per line")
    p.add_argument("--clip", default="ViT-B/32")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--certify", action="store_true",
                   help="deploy acceptance gate: one pass/fail JSON line (module docstring)")
    p.add_argument("--generated", default=None,
                   help="(certify) dir/glob of images generated here on the fixed prompt suite")
    p.add_argument("--reference-outputs", default=None,
                   help="(certify) dir/glob of the reference's outputs on the same suite")
    p.add_argument("--score-tolerance", type=float, default=0.02)
    p.add_argument("--checkpoint-root", default=None,
                   help="(certify) release-file root (default: $CLIP_DIFFUSION_TORCH or "
                        "models/torch)")
    p.add_argument("--data-dir", default=_DATA, help="(certify) the tokenizer assets' directory")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    args = p.parse_args(argv)

    if args.certify:
        return certify(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.selftest:
        print(json.dumps({"selftest_scores": selftest(device)}))
        return 0
    if args.prompts:
        with open(args.prompts, encoding="utf-8") as f:
            prompts = f.read().splitlines()
    else:
        prompts = PROMPT_SUITE
    paths = sorted(sum([glob.glob(g) for g in args.images], []))
    scores = _score_images(paths, prompts, args.clip, device)
    print(json.dumps({"metric": "clip_score", "value": float(np.mean(scores)),
                      "per_image": dict(zip(paths, scores)), "clip_model": args.clip}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
