"""Sentence-T5 text encoder in PyTorch.

Counterpart of `clip_diffusion_tpu.models.t5`: the T5 encoder stack, mean
pooling over non-pad tokens, a linear projection and an L2 normalization
(sentence-t5-base), which embeds prompts for modifier retrieval.  As in
the JAX package:

* pre-norm RMSNorm (eps 1e-6, computed in float32, cast back), no biases;
* no 1/sqrt(d) scaling of the attention logits, which are float32 and
  masked with `where(mask, logits, -1e9)` over pad keys (pad id 0);
* the relative-position bias is computed in block 0 from the bucketed
  key - query offsets and shared by every later block; the bucket of a
  large offset is a float32 log truncated to int32;
* ReLU feed-forward;
* pooled = sum of non-pad rows / max(count, 1), then the projection and
  division by max(norm, 1e-12).

Parameters are `shared.weight`, `block.N.{ln1,ln2}.weight`,
`block.N.attn.{q,k,v,o}.weight`, `block.0.attn.relative_attention_bias.
weight` (buckets x heads), `block.N.{wi,wo}.weight`,
`final_layer_norm.weight` and `projection.weight`.

`convert_sentence_t5` maps the HF release (T5EncoderModel plus the
sentence-transformers `2_Dense` projection) onto these names.

Tokenizer: T5's SentencePiece model (`T5_SPM_PATH`, default
data/t5-spiece.model) through the port's `text/spm.py` when the file
exists, else the JAX package's deterministic hash stand-in.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import re
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.convert import StateDict
from clip_diffusion_tpu_torch.models.unet import Linear
from clip_diffusion_tpu_torch.text.spm import load_unigram

T5_VOCAB = 32128


@dataclasses.dataclass(frozen=True)
class T5Config:
    d_model: int = 768
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    d_kv: int = 64
    vocab_size: int = T5_VOCAB
    rel_buckets: int = 32
    rel_max_distance: int = 128
    projection_dim: int = 768  # sentence-t5 output dim
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(d_model=32, d_ff=64, num_layers=2, num_heads=2,
                        d_kv=16, projection_dim=16)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-6) * weight in float32, in x's dtype."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width))

    def forward(self, x):
        h = x.to(torch.float32)
        h = h * torch.rsqrt(h.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (h * self.weight.to(torch.float32)).to(x.dtype)


def _relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                              max_distance: int = 128) -> torch.Tensor:
    """T5 bidirectional relative-position bucketing of int offsets."""
    num_buckets //= 2
    ret = (rel > 0).to(torch.int32) * num_buckets
    n = rel.abs().to(torch.int32)
    max_exact = num_buckets // 2
    val_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp_max(val_large, num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool = False):
        super().__init__()
        self.cfg, self.has_rel_bias = cfg, has_rel_bias
        inner = cfg.num_heads * cfg.d_kv
        self.q = Linear(cfg.d_model, inner, bias=False, dtype=cfg.dtype)
        self.k = Linear(cfg.d_model, inner, bias=False, dtype=cfg.dtype)
        self.v = Linear(cfg.d_model, inner, bias=False, dtype=cfg.dtype)
        self.o = Linear(inner, cfg.d_model, bias=False, dtype=cfg.dtype)
        if has_rel_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.num_heads)

    def forward(self, x, mask, rel_bias=None):
        """x (B, T, D), mask (B, T) bool of real tokens; returns the output
        and the (1, H, T, T) relative bias for the next blocks."""
        c = self.cfg
        b, t, _ = x.shape

        def heads(u):
            return u.reshape(b, t, c.num_heads, c.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)  # no 1/sqrt(d)
        if self.has_rel_bias:
            pos = torch.arange(t, device=x.device)
            buckets = _relative_position_bucket(pos[None, :] - pos[:, None],  # key - query
                                                c.rel_buckets, c.rel_max_distance)
            table = self.relative_attention_bias.weight.to(torch.float32)
            rel_bias = table[buckets].permute(2, 0, 1)[None]
        if rel_bias is not None:
            logits = logits + rel_bias
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        attn = torch.softmax(logits, dim=-1).to(c.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c.num_heads * c.d_kv)
        return self.o(out), rel_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model)
        self.attn = T5Attention(cfg, has_rel_bias)
        self.ln2 = RMSNorm(cfg.d_model)
        self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=cfg.dtype)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False, dtype=cfg.dtype)

    def forward(self, x, mask, rel_bias):
        y, rel_bias = self.attn(self.ln1(x), mask, rel_bias)
        x = x + y
        return x + self.wo(F.relu(self.wi(self.ln2(x)))), rel_bias


class SentenceT5(nn.Module):
    """tokens (B, T) -> L2-normalized float32 sentence embeddings
    (B, projection_dim)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model)
        self.projection = Linear(cfg.d_model, cfg.projection_dim, bias=False, dtype=cfg.dtype)

    def forward(self, tokens):
        mask = tokens != 0  # T5 pad id 0
        x = self.shared(tokens).to(self.cfg.dtype)
        rel_bias = None
        for block in self.block:
            x, rel_bias = block(x, mask, rel_bias)
        x = self.final_layer_norm(x)
        denom = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1)
        pooled = (x * mask[..., None]).sum(dim=1) / denom
        proj = self.projection(pooled)
        norm = torch.clamp_min(torch.linalg.vector_norm(proj, dim=-1, keepdim=True), 1e-12)
        return (proj / norm).to(torch.float32)


@functools.lru_cache()
def _spm():
    path = os.environ.get("T5_SPM_PATH") or os.path.join(
        os.path.dirname(__file__), "..", "..", "data", "t5-spiece.model"
    )
    return load_unigram(path) if os.path.exists(path) else None


def t5_tokenize(texts: Sequence[str] | str, max_len: int = 64) -> np.ndarray:
    """Texts -> (N, max_len) int32 ids, each ending in </s> (1) and padded
    with 0."""
    if isinstance(texts, str):
        texts = [texts]
    proc = _spm()
    if proc is None:
        warnings.warn(
            "T5 SentencePiece model unavailable; using a deterministic hash "
            "tokenizer stand-in (set T5_SPM_PATH for the real vocabulary)."
        )
    out = np.zeros((len(texts), max_len), np.int32)
    for i, text in enumerate(texts):
        if proc is not None:
            ids = proc.encode_as_ids(text)[: max_len - 1]
        else:
            ids = []
            for wd in text.lower().split():
                h = 0
                for ch in wd.encode():
                    h = (h * 131 + ch) % (T5_VOCAB - 1000)
                ids.append(1000 + h)
            ids = ids[: max_len - 1]
        ids = ids + [1]  # </s>
        out[i, : len(ids)] = ids
    return out


_T5_BLOCK_KEYS = (
    (re.compile(r"encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.([qkvo])\.weight"),
     r"block.\1.attn.\2.weight"),
    (re.compile(r"encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.relative_attention_bias\.weight"),
     r"block.\1.attn.relative_attention_bias.weight"),
    (re.compile(r"encoder\.block\.(\d+)\.layer\.0\.layer_norm\.weight"), r"block.\1.ln1.weight"),
    (re.compile(r"encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.(wi|wo)\.weight"),
     r"block.\1.\2.weight"),
    (re.compile(r"encoder\.block\.(\d+)\.layer\.1\.layer_norm\.weight"), r"block.\1.ln2.weight"),
)


def convert_sentence_t5(state_dict) -> StateDict:
    """HF sentence-t5-base (T5EncoderModel keys, optionally under the
    sentence-transformers prefix `0.auto_model.`, plus the `2_Dense`
    projection's `linear.weight`) -> `SentenceT5` keys:
    `encoder.block.N.layer.0.SelfAttention.q` -> `block.N.attn.q`, the two
    sublayer norms -> `ln1`/`ln2`, `DenseReluDense.wi` -> `wi`,
    `encoder.final_layer_norm` -> `final_layer_norm`, `*linear.weight` ->
    `projection.weight`.  `encoder.embed_tokens.weight`, HF's tied copy of
    `shared.weight`, is dropped."""
    out = {}
    for key, val in state_dict.items():
        name = key[len("0.auto_model."):] if key.startswith("0.auto_model.") else key
        if name == "encoder.embed_tokens.weight":
            continue
        if name == "shared.weight":
            out[name] = val
        elif name == "encoder.final_layer_norm.weight":
            out["final_layer_norm.weight"] = val
        elif name.endswith("linear.weight") or name == "projection.weight":
            out["projection.weight"] = val
        else:
            for pattern, repl in _T5_BLOCK_KEYS:
                if pattern.fullmatch(name):
                    out[pattern.sub(repl, name)] = val
                    break
            else:
                raise KeyError(f"unmapped sentence-t5 key: {key}")
    return out
