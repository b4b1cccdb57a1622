"""CLIP BPE tokenizer (49,408-token vocab, 77-token context).

Own copy of `clip_diffusion_tpu.models.clip.tokenizer`, so token ids match
the JAX package exactly: lower-cased, whitespace-collapsed text split with
the CLIP regex, byte-level BPE with end-of-word markers, bracketed by
<|startoftext|>/<|endoftext|>, zero-padded or truncated to 77 (the last
kept id becomes EOT).  The merge table (`bpe_simple_vocab_16e6.txt.gz`) is
looked up at $CLIP_BPE_PATH, then <repo>/data/; without it `get_tokenizer`
falls back to the deterministic `HashTokenizer` stand-in with a warning.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import warnings
from typing import List, Sequence

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406  # <|startoftext|>
EOT = 49407  # <|endoftext|>

try:
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""\w+|[^\s\w]+""",
        _re.IGNORECASE,
    )


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 byte <-> printable-unicode table (BPE runs on unicode text)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def default_bpe_path() -> str | None:
    cands = [
        os.environ.get("CLIP_BPE_PATH"),
        os.path.join(
            os.path.dirname(__file__), "..", "..", "..", "data",
            "bpe_simple_vocab_16e6.txt.gz",
        ),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


class SimpleTokenizer:
    """Byte-level BPE with end-of-word markers (OpenAI CLIP vocabulary)."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _PAT.findall(_clean_text(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


class HashTokenizer:
    """Deterministic stand-in when the BPE table is unavailable: hashes each
    regex token into the merge-token id range.  Valid shapes and ids for
    pipeline tests; NOT the real CLIP vocabulary."""

    def encode(self, text: str) -> List[int]:
        ids = []
        for token in _PAT.findall(_clean_text(text)):
            h = 0
            for ch in token.encode("utf-8"):
                h = (h * 131 + ch) % (VOCAB_SIZE - 2 - 512)
            ids.append(512 + h)
        return ids


@functools.lru_cache()
def get_tokenizer():
    path = default_bpe_path()
    if path is not None:
        return SimpleTokenizer(path)
    warnings.warn(
        "CLIP BPE table not found (set CLIP_BPE_PATH or place "
        "bpe_simple_vocab_16e6.txt.gz under data/); using the deterministic "
        "HashTokenizer stand-in: fine for tests, wrong for real checkpoints."
    )
    return HashTokenizer()


def tokenize(
    texts: Sequence[str] | str,
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = True,
    tokenizer=None,
    pad: int = 0,
) -> np.ndarray:
    """Texts -> (N, context_length) int32 ids, SOT/EOT-bracketed and
    padded with `pad` (0; Hugging Face's CLIP tokenizer pads with EOT);
    `tokenizer` defaults to `get_tokenizer()`."""
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()
    out = np.full((len(texts), context_length), pad, dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + tok.encode(text) + [EOT]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"text too long for context {context_length}")
            ids = ids[:context_length]
            ids[-1] = EOT
        out[i, : len(ids)] = ids
    return out
