"""The service API surface: seed issuance, settings updates, random prompts,
result retrieval and CLIP image analysis; and batch serving over GPUs.

Counterpart of `clip_diffusion_tpu.parallel.serving`.  `serve_guided_batch`
and `serve_latent_batch` run one request of (prompt x seed) images as one
batch split by rows over the ranks of a process group (`parallel/dist.py`,
one process per GPU; launched with `torchrun --nproc_per_node=N`): each
rank samples its rows with its row view of the batch's draws, and every
rank gets the whole batch back.  The draws are keyed, so the result does
not depend on the number of ranks.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.guidance.losses import l2_normalize
from clip_diffusion_tpu_torch.models.clip.model import clip_normalize
from clip_diffusion_tpu_torch.ops.resize import resize_center_crop
from clip_diffusion_tpu_torch.parallel.dist import gather_rows, row_range
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws, guided_sample
from clip_diffusion_tpu_torch.pipeline.latent import decode_latents, latent_sample
from clip_diffusion_tpu_torch.text.prompt import DATA_ROOT
from clip_diffusion_tpu_torch.text.retrieval import EmbeddingIndex
from clip_diffusion_tpu_torch.utils.seeds import seed_as_string


def get_seed() -> str:
    """A random seed as a string (client integers overflow above 2^53)."""
    return seed_as_string()


def change_settings(config: Config, **kwargs) -> Config:
    """A new Config with `kwargs` replaced; the old one is unchanged."""
    return config.replace(**kwargs)


# artprompts.org category page per UI prompt type (生物 creature, 景觀
# environment, 物件 object)
PROMPT_TYPES = {
    "生物": "creature-prompts/",
    "景觀": "environment-prompts/",
    "物件": "object-prompt/",
}

# local prompt banks, one per prompt type, for deployments without network
_LOCAL_PROMPTS = {
    "生物": [
        "A luminous deep-sea creature with trailing fins.",
        "A moss-covered forest spirit with antlers.",
        "A clockwork dragon curled around a tower.",
    ],
    "景觀": [
        "A lighthouse on a cliff at golden hour, oil painting.",
        "An ancient forest with rays of light, matte painting.",
        "A steampunk airship above snowy mountains.",
    ],
    "物件": [
        "An ornate brass astrolabe on velvet.",
        "A crystal lantern glowing with blue fire.",
        "A weathered leather journal with golden clasps.",
    ],
}


def get_random_prompt(prompt_type: str = "景觀", fetcher=None) -> str:
    """A random prompt of a UI category: `fetcher(category_path)` (or a
    zero-argument `fetcher()`) when given, else one of the local bank's."""
    path = PROMPT_TYPES.get(prompt_type, PROMPT_TYPES["景觀"])
    if fetcher is not None:
        # the arity comes from the signature: catching TypeError around the
        # call would hide a TypeError raised inside a one-argument fetcher
        try:
            inspect.signature(fetcher).bind(path)
        except TypeError:
            return fetcher()
        except ValueError:
            pass  # no introspectable signature: the documented one-argument form
        return fetcher(path)
    return random.choice(_LOCAL_PROMPTS.get(prompt_type, _LOCAL_PROMPTS["景觀"]))


def get_chosen_image(choice: int, output_dir: str = "output_images") -> bytes:
    """PNG bytes of latent output `choice`: its upscale under latent/sr/
    when present, else the latent image itself."""
    path = os.path.join(output_dir, "latent", "sr", f"latent_{choice}.png")
    if not os.path.exists(path):
        path = os.path.join(output_dir, "latent", f"latent_{choice}.png")
    with open(path, "rb") as f:
        return f.read()


@dataclasses.dataclass
class AnalysisBank:
    """Per-CLIP-tower style and media text embeddings (model name -> (N, D)
    array) and their names; each bank is copied to a device once, at its
    first search there."""

    styles: Dict[str, np.ndarray]
    media: Dict[str, np.ndarray]
    style_names: List[str]
    media_names: List[str]
    _indexes: Dict[tuple, EmbeddingIndex] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def index(self, kind: str, model_name: str, device) -> EmbeddingIndex:
        """The `kind` ("styles" or "media") bank of `model_name` as an
        EmbeddingIndex on `device`."""
        key = (kind, model_name, torch.device(device))
        if key not in self._indexes:
            self._indexes[key] = EmbeddingIndex(getattr(self, kind)[model_name], device)
        return self._indexes[key]


def analyze_image(image01, clip_embed_fns: Dict[str, Callable], bank: AnalysisBank,
                  top_k: int = 3, resolution: int = 224) -> Dict[str, List[Tuple[float, str]]]:
    """Top-`top_k` styles and media of a [0, 1] HWC image (array, or tensor
    on the towers' device): each tower's L2-normalized image embedding is
    searched in its banks, each name's scores are averaged over the towers
    that ranked it, and the best are returned as (round(100 * score, 2),
    name).  The image is resized (shorter side) and center-cropped to
    `resolution` once for all towers."""
    img = torch.as_tensor(image01, dtype=torch.float32)
    square = resize_center_crop(img, resolution)
    agg = {"styles": {}, "media": {}}
    for name, embed in clip_embed_fns.items():
        emb = l2_normalize(embed(clip_normalize(square[None])).to(torch.float32))
        for kind, banks, names in (("styles", bank.styles, bank.style_names),
                                   ("media", bank.media, bank.media_names)):
            if name not in banks:
                continue
            scores, idx = bank.index(kind, name, emb.device).search(emb, top_k)
            for s, i in zip(scores[0], idx[0]):
                agg[kind].setdefault(names[i], []).append(float(s))
    results = {}
    for kind, by_name in agg.items():
        ranked = sorted(((float(np.mean(v)), k) for k, v in by_name.items()), reverse=True)
        results[kind] = [(round(100 * s, 2), n) for s, n in ranked[:top_k]]
    return results


def load_analysis_bank(data_dir: Optional[str] = None,
                       models: Sequence[str] = ("ViT-B/16", "ViT-L/14")) -> Optional[AnalysisBank]:
    """The banks `tools/build_banks.py` writes: <dir>/{styles,media}_
    <model>.npy and {styles,media}_names.txt, by default the shipped
    data/banks.  None when the directory holds no names file."""
    data_dir = data_dir or os.path.join(DATA_ROOT, "banks")

    def read_names(kind):
        path = os.path.join(data_dir, f"{kind}_names.txt")
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]

    style_names, media_names = read_names("styles"), read_names("media")
    if style_names is None and media_names is None:
        return None
    styles, media = {}, {}
    for name in models:
        tag = name.replace("/", "_")
        for kind, target in (("styles", styles), ("media", media)):
            path = os.path.join(data_dir, f"{kind}_{tag}.npy")
            if os.path.exists(path):
                target[name] = np.load(path)
    return AnalysisBank(styles, media, style_names or [], media_names or [])


def make_analyzer(models, bank: Optional[AnalysisBank] = None,
                  model_names: Sequence[str] = ("ViT-B/16", "ViT-L/14")):
    """`analyze(image01, top_k=3)` over the zoo's towers in `model_names`
    (`models.clips`, a `zoo.ZooModels`) and `bank` (default: the shipped
    banks), on the towers' device.  The towers must share one input
    resolution.  None when there is no bank or none of the towers."""
    bank = bank or load_analysis_bank()
    if bank is None:
        return None
    towers = {n: models.clips[n] for n in model_names if n in models.clips}
    if not towers:
        return None
    resolutions = {m.cfg.image_resolution for m in towers.values()}
    if len(resolutions) != 1:
        raise ValueError(f"analysis towers disagree on input resolution {sorted(resolutions)}; "
                         "pass same-size towers")
    resolution = resolutions.pop()
    device = next(next(iter(towers.values())).parameters()).device
    for name in towers:  # the banks go to the towers' device here, not per call
        for kind in ("styles", "media"):
            if name in getattr(bank, kind):
                bank.index(kind, name, device)
    embed_fns = {n: torch.no_grad()(m.encode_image) for n, m in towers.items()}

    def analyze(image01, top_k: int = 3):
        img = torch.as_tensor(image01, dtype=torch.float32, device=device)
        return analyze_image(img, embed_fns, bank, top_k, resolution)

    return analyze


# --------------------------------------------------------------------------
# Batch serving over the ranks of a process group
# --------------------------------------------------------------------------

def serve_guided_batch(pipe, prompts_count: int, seeds_per_prompt: int, base_seed: int = 0,
                       group=None):
    """`prompts_count x seeds_per_prompt` guided images as one batch over the
    ranks of `group` -> (final, frames) of the whole batch on every rank.

    Per-prompt embeddings, (prompts_count, P, D) and weights (prompts_count,
    P) in each perceptor (`zoo.build_pipeline` with one prompt list per
    prompt), are repeated `seeds_per_prompt` times, so row i has prompt
    i // seeds_per_prompt; 2-D embeddings are one prompt shared by all
    rows.  Each rank runs `guided_sample` on its rows with
    `TorchDraws(base_seed).rows(lo, hi)` on `pipe.device`."""
    batch = prompts_count * seeds_per_prompt
    lo, hi = row_range(batch, group)
    perceptors = []
    for perc in pipe.perceptors:
        te, tw = perc.text_embeddings, perc.text_weights
        if te.ndim == 3:
            if te.shape[0] != prompts_count:
                raise ValueError(f"params carry {te.shape[0]} prompts, expected {prompts_count}")
            te = te.repeat_interleave(seeds_per_prompt, dim=0)[lo:hi]
            tw = tw.repeat_interleave(seeds_per_prompt, dim=0)[lo:hi]
        perceptors.append(dataclasses.replace(perc, text_embeddings=te, text_weights=tw))
    rank_pipe = dataclasses.replace(pipe, perceptors=tuple(perceptors))
    draws = TorchDraws(base_seed, pipe.device).rows(lo, hi)
    _, frames = guided_sample(rank_pipe, draws, batch_size=hi - lo)
    frames = gather_rows(frames, dim=1, group=group)
    return frames[-1], frames


def serve_latent_batch(pipe, context_cond, context_uncond=None, seeds_per_prompt: int = 1,
                       base_seed: int = 0, group=None, height: int = 256, width: int = 256,
                       steps: int = 50, guidance_scale: float = 5.0, eta: float = 0.0,
                       mode: str = "ddim", decode: bool = True):
    """N prompts x `seeds_per_prompt` latent images as one CFG batch over
    the ranks of `group` -> decoded [0, 1] pixels (B, H, W, 3) when
    `decode`, else latents (B, h, w, C), the whole batch on every rank.

    `context_cond`: (N, T, D) per-prompt conditioning ((T, D) is one
    prompt), repeated `seeds_per_prompt` times.  `context_uncond`: (1 | N |
    B, T, D) unconditional rows for CFG; CFG is off when it is None or
    `guidance_scale` is 0.  Each rank samples its rows with
    `TorchDraws(base_seed).rows(lo, hi)` on the contexts' device."""
    ctx_c = context_cond if context_cond.ndim == 3 else context_cond[None]
    n_prompts = ctx_c.shape[0]
    batch = n_prompts * seeds_per_prompt
    ctx_c = ctx_c.repeat_interleave(seeds_per_prompt, dim=0)
    ctx_u = None
    if context_uncond is not None and guidance_scale > 0:
        ctx_u = context_uncond if context_uncond.ndim == 3 else context_uncond[None]
        if ctx_u.shape[0] == 1:
            ctx_u = ctx_u.expand((batch,) + tuple(ctx_u.shape[1:]))
        elif ctx_u.shape[0] == n_prompts:
            ctx_u = ctx_u.repeat_interleave(seeds_per_prompt, dim=0)
        elif ctx_u.shape[0] != batch:
            raise ValueError(f"context_uncond carries {ctx_u.shape[0]} rows; expected "
                             f"1, {n_prompts} (per prompt) or {batch} (per image)")
    lo, hi = row_range(batch, group)
    draws = TorchDraws(base_seed, ctx_c.device).rows(lo, hi)
    z = latent_sample(pipe, draws, ctx_c[lo:hi], None if ctx_u is None else ctx_u[lo:hi],
                      batch_size=hi - lo, height=height, width=width, steps=steps,
                      guidance_scale=guidance_scale, eta=eta, mode=mode)
    return gather_rows(decode_latents(pipe, z) if decode else z, group=group)
