"""Build the embedding banks for modifier retrieval and image analysis.

    python3 -m clip_diffusion_tpu_torch.tools.build_banks --all [--out data/banks] [--cpu]
    python3 -m clip_diffusion_tpu_torch.tools.build_banks --keywords data/csv/styles.csv \\
        --kind styles --models ViT-B/16 ViT-L/14 --out data/banks

Counterpart of the JAX package's tools/build_banks.py.  From the keyword
CSVs under data/csv it writes `<kind>_names.txt` and, per tower, the
float32 L2-normalized text embeddings as `.npy` under the JAX tool's file
names: `modifiers_t5.npy` from the sentence-T5 encoder
(`zoo.load_or_init_sentence_t5`, the query encoder's constructor) and
`{styles,media}_<tower>.npy` from the CLIP text towers (`zoo.build_clip`
in float32, the serving towers' constructor).  Both come from release
files when provisioned, else from the zoo's seeded init, so banks and
queries always share a tower.  Runs on `cuda` unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from clip_diffusion_tpu_torch.guidance.losses import l2_normalize
from clip_diffusion_tpu_torch.models.clip.tokenizer import tokenize
from clip_diffusion_tpu_torch.models.t5 import t5_tokenize
from clip_diffusion_tpu_torch.utils.device import resolve_device

# CSV column holding the keyword, per kind
KIND_COLUMNS = {"modifiers": "Keyword", "styles": "style", "media": "medium"}


def read_keywords(path: str, column: Optional[str] = None) -> List[str]:
    """Keyword list from a one-per-line text file or a CSV (by header name,
    falling back to the first column)."""
    if path.endswith(".csv"):
        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        col = header.index(column) if column and column in header else 0
        return [r[col] for r in body if r]
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def write_names(out_dir: str, kind: str, keywords: Sequence[str]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{kind}_names.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(keywords))


def _save(out_dir: str, name: str, emb: torch.Tensor) -> np.ndarray:
    arr = emb.detach().to("cpu", torch.float32).numpy()
    path = os.path.join(out_dir, name)
    np.save(path, arr)
    print(f"{path}: {arr.shape}", flush=True)
    return arr


@torch.no_grad()
def build_clip_bank(keywords: Sequence[str], kind: str, model_names: Sequence[str], out_dir: str,
                    seed: int = 0, device=None) -> dict:
    """Per-tower L2-normalized CLIP text embeddings of the keywords ->
    {tower: (N, D) float32}, saved as `<kind>_<tower>.npy`."""
    from clip_diffusion_tpu_torch.zoo import build_clip, checkpoint_path, clip_checkpoint_name

    device = resolve_device(device)
    write_names(out_dir, kind, keywords)
    toks = torch.from_numpy(tokenize(list(keywords))).to(device=device, dtype=torch.long)
    banks = {}
    for name in model_names:
        if checkpoint_path(clip_checkpoint_name(name)) is None:
            print(f"WARNING: no release file for {name}: bank embeddings come from the zoo's "
                  "seeded random tower (consistent with the serving towers, but semantically "
                  "meaningless; run fetch_and_convert first in a networked deployment)",
                  flush=True)
        model = build_clip(name, torch.float32, seed, device)
        banks[name] = _save(out_dir, f"{kind}_{name.replace('/', '_')}.npy",
                            l2_normalize(model.encode_text(toks)))
    return banks


@torch.no_grad()
def build_modifier_bank(keywords: Sequence[str], out_dir: str, seed: int = 0,
                        device=None) -> np.ndarray:
    """Sentence-T5 embeddings of the modifier keywords (unit norm: the
    encoder normalizes its pooled projection) -> (N, 768) float32, saved as
    `modifiers_t5.npy`."""
    from clip_diffusion_tpu_torch.zoo import load_or_init_sentence_t5

    device = resolve_device(device)
    write_names(out_dir, "modifiers", keywords)
    model = load_or_init_sentence_t5(seed=seed, device=device)
    toks = torch.from_numpy(t5_tokenize(list(keywords))).to(device=device, dtype=torch.long)
    return _save(out_dir, "modifiers_t5.npy", model(toks))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--all", action="store_true", help="build modifiers, styles and media from "
                                                      "--csv-dir")
    p.add_argument("--keywords")
    p.add_argument("--kind", default="styles", choices=tuple(KIND_COLUMNS))
    p.add_argument("--models", nargs="+", default=["ViT-B/16", "ViT-L/14"])
    p.add_argument("--out", default=os.path.join("data", "banks"))
    p.add_argument("--csv-dir", default=os.path.join("data", "csv"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    if args.all:
        jobs = [(kind, read_keywords(os.path.join(args.csv_dir, f"{kind}.csv"),
                                     KIND_COLUMNS[kind])) for kind in KIND_COLUMNS]
    elif args.keywords:
        jobs = [(args.kind, read_keywords(args.keywords, KIND_COLUMNS[args.kind]))]
    else:
        p.error("--keywords required unless --all")
    for kind, keywords in jobs:
        if kind == "modifiers":
            build_modifier_bank(keywords, args.out, args.seed, device)
        else:
            build_clip_bank(keywords, kind, args.models, args.out, args.seed, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
