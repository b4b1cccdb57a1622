"""CLIP score: the fixed-prompt quality metric of a final image.

Counterpart of `clip_diffusion_tpu.guidance.score`.  Per CLIP tower, the
image (resize shorter side + center crop + CLIP normalize, not the cutout
engine) and the prompt are embedded and L2-normalized; the scores are the
cosine (clipped to [-1, 1], higher is better) and the squared spherical
distance (2 asin(min(1, |u - v| / 2)))^2, the quantity guidance descends,
lower is better.  Each is rounded to 4 decimals and averaged over towers
into "mean".  Scores compare across implementations only when the prompt
suite and the tower weights match (`zoo.weights_provenance`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from clip_diffusion_tpu_torch.guidance.losses import l2_normalize
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, clip_normalize
from clip_diffusion_tpu_torch.models.clip.tokenizer import tokenize
from clip_diffusion_tpu_torch.ops.resize import resize_center_crop

# The fixed suite: the bench prompt first, then subjects and styles
# (portrait, architecture, nature, object, abstract, modifier-style).
PROMPT_SUITE: Tuple[str, ...] = (
    "a beautiful landscape painting",
    "a portrait of an old fisherman, oil on canvas",
    "a futuristic city skyline at dusk, concept art",
    "a watercolor painting of a fox in a snowy forest",
    "an ornate brass astrolabe on velvet, studio photograph",
    "abstract geometric shapes in warm colors, bauhaus style",
    "a lighthouse on a cliff at golden hour",
    "a steampunk airship above snowy mountains, trending on artstation",
)


@torch.no_grad()
def clip_scores(clips: Dict[str, CLIPModel], image01, prompt: str) -> Dict[str, Dict[str, float]]:
    """Per-tower scores of one [0, 1] HWC image (array or tensor) against
    `prompt`, each tower on its own device: {"cosine": {name: v, ...,
    "mean": v}, "spherical": {name: v, ..., "mean": v}}."""
    cos: Dict[str, float] = {}
    sph: Dict[str, float] = {}
    toks = torch.from_numpy(tokenize([prompt])).long()
    for name, model in clips.items():
        device = next(model.parameters()).device
        img = torch.as_tensor(image01, dtype=torch.float32, device=device)
        square = resize_center_crop(img, model.cfg.image_resolution)
        ie = l2_normalize(model.encode_image(clip_normalize(square[None])))[0]
        te = l2_normalize(model.encode_text(toks.to(device)))[0]
        cos[name] = round(float(torch.clamp(torch.dot(ie, te), -1.0, 1.0)), 4)
        chord = float(torch.linalg.vector_norm(ie - te))
        sph[name] = round((2.0 * math.asin(min(1.0, chord / 2.0))) ** 2, 4)
    cos["mean"] = round(float(np.mean(list(cos.values()))), 4)
    sph["mean"] = round(float(np.mean(list(sph.values()))), 4)
    return {"cosine": cos, "spherical": sph}


def score_suite(clips: Dict[str, CLIPModel], sample_fn: Callable[[str], object],
                prompts: Sequence[str] = PROMPT_SUITE):
    """`sample_fn(prompt) -> [0, 1] HWC image` for each prompt, scored on
    `clips` (on their devices): ([(prompt, scores), ...], the suite's mean
    cosine)."""
    rows = [(p, clip_scores(clips, sample_fn(p), p)) for p in prompts]
    mean = round(float(np.mean([r[1]["cosine"]["mean"] for r in rows])), 4)
    return rows, mean
