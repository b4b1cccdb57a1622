"""LDM text conditioning: the BERTEmbedder transformer encoder, and its
tokenizer.

Counterpart of `clip_diffusion_tpu.models.ldm.bert`: CompVis's
BERTEmbedder, an x-transformers TransformerWrapper over BERT-uncased ids
(vocab 30522, 77 tokens): a 32-layer, 1280-wide pre-LN encoder whose
attention keeps x-transformers' defaults of 8 heads x 64 (a 512-wide inner
projection whatever the width), returning (B, 77, 1280) float32 context.
No padding mask (PAD tokens attend like any other), exact GELU, a float32
final LayerNorm.  Keys follow x-transformers (`token_emb.weight`,
`pos_emb.emb.weight`, `attn_layers.layers.{2i}.1.to_q.weight`,
`attn_layers.layers.{2i+1}.1.net.0.0.weight`, `norm.weight`); the JAX tree
fuses to_q/to_k/to_v into one `qkv` kernel, which `models/from_jax.py`
splits.

Tokenization: WordPiece when a vocab file is found ($BERT_VOCAB_PATH, else
data/bert-base-uncased-vocab.txt in the repository), else a deterministic
hash stand-in; both as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import warnings
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.clip.model import LayerNormF32
from clip_diffusion_tpu_torch.models.unet import Linear

BERT_VOCAB_SIZE = 30522
MAX_SEQ_LEN = 77
CLS, SEP, PAD, UNK = 101, 102, 0, 100


@dataclasses.dataclass(frozen=True)
class BERTConfig:
    n_embed: int = 1280
    n_layer: int = 32
    n_heads: int = 8
    dim_head: int = 64
    vocab_size: int = BERT_VOCAB_SIZE
    max_seq_len: int = MAX_SEQ_LEN
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "BERTConfig":
        return BERTConfig(n_embed=64, n_layer=2, n_heads=2, dim_head=16, dtype=torch.float32)


class Attention(nn.Module):
    """Self-attention with float32 logits divided by sqrt(dim_head) and a
    float32 softmax cast back to the compute dtype."""

    def __init__(self, dim: int, heads: int, dim_head: int, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.to_q = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_out = Linear(inner, dim, dtype=dtype)

    def forward(self, x):
        b, t, _ = x.shape
        h, d = self.heads, self.dim_head
        q, k, v = (proj(x).reshape(b, t, h, d).transpose(1, 2)
                   for proj in (self.to_q, self.to_k, self.to_v))
        logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
        attn = torch.softmax(logits / float(np.sqrt(d)), dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, h * d)
        return self.to_out(out)


class FeedForward(nn.Module):
    """`net.0.0` to 4x width, exact GELU in float32, `net.2` back."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.net = nn.ModuleList([nn.ModuleList([Linear(dim, dim * 4, dtype=dtype)]),
                                  nn.Identity(), Linear(dim * 4, dim, dtype=dtype)])

    def forward(self, x):
        y = self.net[0][0](x)
        return self.net[2](F.gelu(y.to(torch.float32)).to(y.dtype))


class BERTEmbedder(nn.Module):
    """(B, T) token ids -> (B, T, n_embed) float32 context."""

    def __init__(self, cfg: BERTConfig):
        super().__init__()
        self.cfg = cfg
        self.token_emb = nn.Embedding(cfg.vocab_size, cfg.n_embed)
        self.pos_emb = nn.Module()
        self.pos_emb.emb = nn.Embedding(cfg.max_seq_len, cfg.n_embed)
        self.attn_layers = nn.Module()
        layers = []
        for _ in range(cfg.n_layer):
            layers.append(nn.ModuleList([
                LayerNormF32(cfg.n_embed),
                Attention(cfg.n_embed, cfg.n_heads, cfg.dim_head, cfg.dtype)]))
            layers.append(nn.ModuleList([LayerNormF32(cfg.n_embed),
                                         FeedForward(cfg.n_embed, cfg.dtype)]))
        self.attn_layers.layers = nn.ModuleList(layers)
        self.norm = LayerNormF32(cfg.n_embed)

    def forward(self, tokens):
        dt = self.cfg.dtype
        x = F.embedding(tokens, self.token_emb.weight).to(dt)
        x = x + self.pos_emb.emb.weight[: tokens.shape[1]].to(dt)[None]
        for norm, block in self.attn_layers.layers:
            x = x + block(norm(x))
        return self.norm(x.to(torch.float32))


# --------------------------------------------------------------------------
# BERT WordPiece tokenizer (with the hash stand-in)
# --------------------------------------------------------------------------

def _vocab_path():
    cands = [
        os.environ.get("BERT_VOCAB_PATH"),
        os.path.join(os.path.dirname(__file__), "..", "..", "..", "data",
                     "bert-base-uncased-vocab.txt"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


@functools.lru_cache()
def _load_vocab():
    path = _vocab_path()
    if path is None:
        return None
    with open(path, encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _wordpiece(word: str, vocab) -> List[int]:
    ids = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            piece = word[start:end]
            if start > 0:
                piece = "##" + piece
            if piece in vocab:
                cur = vocab[piece]
                break
            end -= 1
        if cur is None:
            return [UNK]
        ids.append(cur)
        start = end
    return ids


def bert_tokenize(texts: Sequence[str] | str, max_len: int = MAX_SEQ_LEN) -> np.ndarray:
    """Texts -> (N, max_len) int32 BERT-uncased ids, CLS/SEP-bracketed,
    zero-padded."""
    if isinstance(texts, str):
        texts = [texts]
    vocab = _load_vocab()
    if vocab is None:
        warnings.warn(
            "BERT vocab not found (set BERT_VOCAB_PATH or place "
            "bert-base-uncased-vocab.txt under data/); using a deterministic "
            "hash tokenizer stand-in."
        )
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    for i, text in enumerate(texts):
        ids: List[int] = [CLS]
        for wd in text.lower().split():
            if vocab is not None:
                ids.extend(_wordpiece(wd, vocab))
            else:
                h = 0
                for ch in wd.encode("utf-8"):
                    h = (h * 131 + ch) % (BERT_VOCAB_SIZE - 1000)
                ids.append(1000 + h)
        ids = ids[: max_len - 1] + [SEP]
        out[i, : len(ids)] = ids
    return out
