"""CLIP scores of the fixed prompt suite, or of one image.

    python3 -m clip_diffusion_tpu_torch.tools.clip_score [--prompts N] [--steps 50] \\
        [--size 256] [--seed 0] [--device cuda]
    python3 -m clip_diffusion_tpu_torch.tools.clip_score --image path.png --prompt "..."

The first form samples each suite prompt with `guided_diffusion_sample`
(the zoo's default towers, the 512 UNet, a `size` x `size` canvas) and
prints one JSON line per prompt, then the suite's mean; the second scores
one image file.  Every line carries the provenance verdict
(`zoo.weights_provenance`): on random-init stand-ins or the hash tokenizer
the scores are internally consistent but do not compare with the
reference's, and the tool says so on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
from PIL import Image

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.guidance.score import PROMPT_SUITE, clip_scores, score_suite
from clip_diffusion_tpu_torch.sample import guided_diffusion_sample
from clip_diffusion_tpu_torch.utils.device import resolve_device
from clip_diffusion_tpu_torch.zoo import build_models, weights_provenance


def read_image01(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def suite_sampler(models, config: Config, steps: int, seed: int, device,
                  output_dir: str = "output_images"):
    """`sample_fn(prompt) -> [0, 1] HWC image` for `score_suite`: one guided
    image per prompt on the given zoo, no auto-modifiers."""

    def sample_fn(prompt: str) -> np.ndarray:
        out = guided_diffusion_sample(prompt=prompt, config=config, models=models, steps=steps,
                                      seed=seed, use_auto_modifiers=False,
                                      output_dir=output_dir, device=device)
        return read_image01(out["images"][0])

    return sample_fn


def provenance_summary() -> dict:
    prov = weights_provenance()
    return {k: prov[k] for k in ("weights", "tokenizer", "reference_comparable")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image", help="score one image file instead of sampling")
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--prompts", type=int, default=None, help="first N suite prompts (default: all)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    config = Config(width=args.size, height=args.size)
    models = build_models(config, image_size=512, device=device)
    provenance = provenance_summary()
    if not provenance["reference_comparable"]:
        print("WARNING: scores below are NOT reference-comparable "
              f"(weights: {provenance['weights']}; tokenizer: {provenance['tokenizer']}).",
              file=sys.stderr)

    if args.image:
        prompt = args.prompt or PROMPT_SUITE[0]
        print(json.dumps({"prompt": prompt, **clip_scores(models.clips, read_image01(args.image), prompt),
                          "provenance": provenance}))
        return 0

    prompts = PROMPT_SUITE[: args.prompts] if args.prompts else PROMPT_SUITE
    rows, mean = score_suite(models.clips, suite_sampler(models, config, args.steps, args.seed, device),
                             prompts)
    for prompt, s in rows:
        print(json.dumps({"prompt": prompt, **s, "provenance": provenance}))
    print(json.dumps({"suite_cosine_mean": mean, "prompts": len(rows), "steps": args.steps,
                      "seed": args.seed, "provenance": provenance}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
