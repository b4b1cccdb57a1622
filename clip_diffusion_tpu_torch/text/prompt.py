"""Prompt front end.

Counterpart of `clip_diffusion_tpu.text.prompt`: translate a Chinese
prompt to English (`text/zh.py`), optionally append the nearest
artist/style modifier keywords (sentence-T5 embedding -> inner-product
top-k over the 120 shipped modifiers) and ", trending on artstation.",
then split "text:weight".
"""

from __future__ import annotations

import csv
import functools
import os
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clip_diffusion_tpu_torch.models.t5 import t5_tokenize
from clip_diffusion_tpu_torch.text.retrieval import EmbeddingIndex
from clip_diffusion_tpu_torch.text.zh import translate_zh_to_en
from clip_diffusion_tpu_torch.utils.device import resolve_device
from clip_diffusion_tpu_torch.zoo import load_or_init_sentence_t5

ARTSTATION_SUFFIX = ", trending on artstation."

# the data root: keyword CSVs under <root>/csv, embedding banks under
# <root>/banks (data/README.md)
DATA_ROOT = os.environ.get(
    "CLIP_DIFFUSION_DATA",
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
)


class ModifierBank:
    """Modifier keywords, their sentence embeddings (an `EmbeddingIndex` on
    `device`) and the query encoder, `encoder(text) -> (D,)` array or
    tensor."""

    def __init__(self, keywords: Sequence[str], embeddings,
                 encoder: Callable[[str], object], device=None):
        if len(keywords) != len(embeddings):
            raise ValueError(f"{len(keywords)} keywords for {len(embeddings)} embeddings")
        self.keywords = list(keywords)
        self.index = EmbeddingIndex(embeddings, device)
        self.encoder = encoder

    @staticmethod
    def from_files(keywords_path: str, embeddings_path: str,
                   encoder: Callable[[str], object], device=None) -> "ModifierBank":
        with open(keywords_path, encoding="utf-8") as f:
            keywords = [line.strip() for line in f if line.strip()]
        return ModifierBank(keywords, np.load(embeddings_path), encoder, device)

    def topk(self, prompt: str, k: int) -> Tuple[np.ndarray, List[str]]:
        emb = torch.as_tensor(self.encoder(prompt), dtype=torch.float32).reshape(1, -1)
        scores, idx = self.index.search(emb, k)
        return scores[0], [self.keywords[i] for i in idx[0]]


def read_modifier_keywords(csv_path: str) -> List[str]:
    """The `Keyword` column of modifiers.csv (else the first column)."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    col = rows[0].index("Keyword") if "Keyword" in rows[0] else 0
    return [r[col] for r in rows[1:] if r]


class T5Encoder:
    """text -> (projection_dim,) float32 sentence embedding through a
    `SentenceT5` on its device."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def __call__(self, text: str) -> torch.Tensor:
        device = self.model.shared.weight.device
        return self.model(torch.from_numpy(t5_tokenize([text])).to(device, torch.long))[0]


def load_modifier_bank(data_root: Optional[str] = None, device=None) -> Optional[ModifierBank]:
    """The shipped ModifierBank on `device` (default `cuda`): keywords from
    <root>/csv/modifiers.csv, embeddings from <root>/banks/modifiers_t5.npy,
    the zoo's sentence-T5 as query encoder (the tower the bank was built
    with).  Built once per (root, device).  None, with a warning, when the
    assets are absent."""
    return _load_modifier_bank(data_root or DATA_ROOT, str(resolve_device(device)))


@functools.lru_cache(maxsize=4)
def _load_modifier_bank(root: str, device: str) -> Optional[ModifierBank]:
    csv_path = os.path.join(root, "csv", "modifiers.csv")
    emb_path = os.path.join(root, "banks", "modifiers_t5.npy")
    if not (os.path.exists(csv_path) and os.path.exists(emb_path)):
        warnings.warn(
            f"modifier bank assets not found under {root} (need csv/modifiers.csv "
            "and banks/modifiers_t5.npy) - auto-modifiers disabled"
        )
        return None
    encoder = T5Encoder(load_or_init_sentence_t5(device=device))
    return ModifierBank(read_modifier_keywords(csv_path), np.load(emb_path), encoder, device)


class Prompt:
    """`.text` and `.weight` of a prompt after preprocessing, in this order:
    zh -> en translation (`translator`, else the default chain), then with
    `use_auto_modifiers` the top `num_modifiers` keywords of
    `modifier_bank` (else the shipped bank on `device`) and the artstation
    suffix, then a trailing ":weight" parsed as a float (default 1.0)."""

    def __init__(
        self,
        prompt: str,
        use_auto_modifiers: bool = False,
        num_modifiers: int = 1,
        modifier_bank: Optional[ModifierBank] = None,
        translator: Optional[Callable[[str], str]] = None,
        device=None,
    ):
        if not isinstance(prompt, str):
            raise TypeError("prompt has to be 'str' type")
        self.prompt = self._preprocess(prompt, use_auto_modifiers, num_modifiers,
                                       modifier_bank, translator, device)
        self.text, self.weight = self._parse_weight(self.prompt)

    @staticmethod
    def _preprocess(prompt, use_auto_modifiers, num_modifiers, bank, translator, device):
        prompt = translate_zh_to_en(prompt, translator, device)
        if use_auto_modifiers and bank is None:
            bank = load_modifier_bank(device=device)
        if use_auto_modifiers and bank is not None:
            _, keywords = bank.topk(prompt, num_modifiers)
            for kw in keywords:
                prompt += f", {kw}"
            prompt += ARTSTATION_SUFFIX
        return prompt

    @staticmethod
    def _parse_weight(prompt: str) -> Tuple[str, float]:
        parsed = prompt.split(":", 1)
        if len(parsed) == 1:
            return parsed[0], 1.0
        return parsed[0], float(parsed[1])
