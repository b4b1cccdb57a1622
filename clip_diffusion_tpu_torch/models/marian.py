"""MarianMT zh -> en translation model in PyTorch.

Counterpart of `clip_diffusion_tpu.models.marian` (Helsinki-NLP/
opus-mt-zh-en geometry).  As in the JAX package:

* post-norm transformer layers (residual, add, LayerNorm eps 1e-5);
* a sinusoid position table with sin in the first half of the features
  and cos in the second, computed in float64 and cast to float32,
  regenerated and never loaded;
* token embeddings scaled by sqrt(d_model), shared by source and target;
* q scaled by head_dim**-0.5 before the score matmul, softmax in float32,
  additive -1e9 biases for source pads and for the causal mask;
* SiLU feed-forward;
* the output projection tied to the shared embedding,
  `F.linear(x, shared.weight) + final_logits_bias`.

Parameter names follow the HF `MarianMTModel` checkpoint without its
`model.` prefix: `shared.weight`, `encoder.layers.N.self_attn.
{q,k,v,out}_proj.{weight,bias}`, `...self_attn_layer_norm`, `...fc1`,
`...fc2`, `...final_layer_norm`, the decoder's `encoder_attn` and
`encoder_attn_layer_norm` besides, and `final_logits_bias`, of shape
(vocab,) here and (1, vocab) in HF; `convert_marian` maps an HF state
dict onto these names.

`greedy_decode` keeps the JAX package's semantics: a fixed (B, max_len + 1)
buffer, the whole decoder recomputed for every emitted token, the pad
logit floored to -inf, finished rows emitting pad.  The tokenizer is the
SentencePiece source model plus vocab.json (`MARIAN_SPM_PATH`,
`MARIAN_VOCAB_PATH`, default data/marian/) through the port's
`text/spm.py`, else the JAX package's hash stand-in.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.clip.model import LayerNormF32
from clip_diffusion_tpu_torch.models.convert import StateDict
from clip_diffusion_tpu_torch.models.unet import Linear
from clip_diffusion_tpu_torch.text.spm import load_unigram


@dataclasses.dataclass(frozen=True)
class MarianConfig:
    vocab_size: int = 65001
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_positions: int = 512
    activation: str = "silu"  # opus-mt "swish"
    scale_embedding: bool = True
    pad_token_id: int = 65000
    eos_token_id: int = 0
    decoder_start_token_id: int = 65000
    dtype: torch.dtype = torch.float32

    @staticmethod
    def opus_zh_en() -> "MarianConfig":
        """Helsinki-NLP/opus-mt-zh-en geometry."""
        return MarianConfig()

    @staticmethod
    def tiny(vocab: int = 64) -> "MarianConfig":
        return MarianConfig(
            vocab_size=vocab, d_model=16, encoder_layers=2, decoder_layers=2,
            num_heads=2, ffn_dim=32, max_positions=64,
            pad_token_id=vocab - 1, decoder_start_token_id=vocab - 1,
            eos_token_id=0,
        )


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """[sin(angles) | cos(angles)] with angle_k = pos / 10000^(2k/dim), in
    float64, returned as float32 (max_len, dim)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    k = np.arange(dim // 2, dtype=np.float64)[None, :]
    angles = pos / np.power(10000.0, 2.0 * k / dim)
    table = np.concatenate([np.sin(angles), np.cos(angles)], axis=-1)
    if dim % 2:  # an odd width gets one zero column
        table = np.pad(table, ((0, 0), (0, 1)))
    return table.astype(np.float32)


_ACT = {"silu": F.silu, "swish": F.silu, "relu": F.relu,
        "gelu": functools.partial(F.gelu, approximate="tanh")}


class MarianAttention(nn.Module):
    def __init__(self, cfg: MarianConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.q_proj = Linear(d, d, dtype=cfg.dtype)
        self.k_proj = Linear(d, d, dtype=cfg.dtype)
        self.v_proj = Linear(d, d, dtype=cfg.dtype)
        self.out_proj = Linear(d, d, dtype=cfg.dtype)

    def forward(self, x, kv, bias):
        """bias: additive, broadcastable to (B, H, Lq, Lk)."""
        c = self.cfg
        h, hd = c.num_heads, c.d_model // c.num_heads

        def split(t):
            return t.reshape(t.shape[:-1] + (h, hd)).transpose(1, 2)

        q = self.q_proj(x) * (hd ** -0.5)  # scaled before the score matmul
        scores = torch.matmul(split(q), split(self.k_proj(kv)).transpose(-1, -2)) + bias
        attn = torch.softmax(scores.to(torch.float32), dim=-1).to(c.dtype)
        out = torch.matmul(attn, split(self.v_proj(kv))).transpose(1, 2)
        return self.out_proj(out.reshape(x.shape[:-1] + (c.d_model,)))


class MarianEncoderLayer(nn.Module):
    def __init__(self, cfg: MarianConfig):
        super().__init__()
        self.act = _ACT[cfg.activation]
        self.self_attn = MarianAttention(cfg)
        self.self_attn_layer_norm = LayerNormF32(cfg.d_model)
        self.fc1 = Linear(cfg.d_model, cfg.ffn_dim, dtype=cfg.dtype)
        self.fc2 = Linear(cfg.ffn_dim, cfg.d_model, dtype=cfg.dtype)
        self.final_layer_norm = LayerNormF32(cfg.d_model)

    def forward(self, x, bias):
        x = self.self_attn_layer_norm(x + self.self_attn(x, x, bias))
        return self.final_layer_norm(x + self.fc2(self.act(self.fc1(x))))


class MarianDecoderLayer(MarianEncoderLayer):
    def __init__(self, cfg: MarianConfig):
        super().__init__(cfg)
        self.encoder_attn = MarianAttention(cfg)
        self.encoder_attn_layer_norm = LayerNormF32(cfg.d_model)

    def forward(self, x, enc, self_bias, cross_bias):
        x = self.self_attn_layer_norm(x + self.self_attn(x, x, self_bias))
        x = self.encoder_attn_layer_norm(x + self.encoder_attn(x, enc, cross_bias))
        return self.final_layer_norm(x + self.fc2(self.act(self.fc1(x))))


class _Layers(nn.Module):
    def __init__(self, layer, n: int, cfg: MarianConfig):
        super().__init__()
        self.layers = nn.ModuleList(layer(cfg) for _ in range(n))


def _bias(valid: torch.Tensor, dtype) -> torch.Tensor:
    """Additive attention bias: 0 where `valid`, -1e9 elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, -1e9).to(dtype)


class MarianMT(nn.Module):
    """Encoder-decoder: `forward(src, tgt)` gives teacher-forced logits;
    `encode` and `decode` are the halves generation uses."""

    def __init__(self, cfg: MarianConfig):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Layers(MarianEncoderLayer, cfg.encoder_layers, cfg)
        self.decoder = _Layers(MarianDecoderLayer, cfg.decoder_layers, cfg)
        self.final_logits_bias = nn.Parameter(torch.empty(cfg.vocab_size))
        # a numpy table, not a buffer: regenerated, never part of a state dict
        self._positions = sinusoidal_positions(cfg.max_positions, cfg.d_model)

    def _embed(self, ids):
        c = self.cfg
        scale = float(np.sqrt(c.d_model)) if c.scale_embedding else 1.0
        x = self.shared(ids).to(c.dtype) * scale
        pos = torch.from_numpy(self._positions[: ids.shape[1]]).to(x.device, c.dtype)
        return x + pos

    def encode(self, src_ids):
        """(B, Ls) -> (B, Ls, D).  Pad rows are junk, masked out of every
        attention that reads them."""
        bias = _bias(src_ids != self.cfg.pad_token_id, self.cfg.dtype)[:, None, None, :]
        x = self._embed(src_ids)
        for layer in self.encoder.layers:
            x = layer(x, bias)
        return x

    def decode(self, tgt_ids, enc_out, src_ids):
        """Teacher-forced decoder: (B, Lt) prefix -> (B, Lt, V) logits, causal
        self-attention, source pads masked in cross-attention."""
        c = self.cfg
        lt = tgt_ids.shape[1]
        tril = torch.tril(torch.ones((lt, lt), dtype=torch.bool, device=tgt_ids.device))
        causal = _bias(tril, c.dtype)[None, None]
        cross = _bias(src_ids != c.pad_token_id, c.dtype)[:, None, None, :]
        x = self._embed(tgt_ids)
        for layer in self.decoder.layers:
            x = layer(x, enc_out, causal, cross)
        return F.linear(x, self.shared.weight.to(x.dtype)) + self.final_logits_bias.to(x.dtype)

    def forward(self, src_ids, tgt_ids):
        return self.decode(tgt_ids, self.encode(src_ids), src_ids)


@torch.no_grad()
def greedy_decode(model: MarianMT, src_ids, max_len: int = 64,
                  suppress_pad: bool = True) -> torch.Tensor:
    """Batch greedy generation: (B, Ls) ids -> (B, max_len) int64 ids on the
    model's device, eos-terminated and pad-filled.  `max_len` is capped at
    max_positions - 1 (the buffer holds the start token too).
    `suppress_pad` floors the pad logit so argmax cannot emit it (the opus
    generation config's bad_words_ids [[pad]])."""
    c = model.cfg
    max_len = min(max_len, c.max_positions - 1)
    device = model.shared.weight.device
    src = torch.as_tensor(src_ids, dtype=torch.long, device=device)
    enc = model.encode(src)
    buf = torch.full((src.shape[0], max_len + 1), c.pad_token_id, dtype=torch.long, device=device)
    buf[:, 0] = c.decoder_start_token_id
    done = torch.zeros(src.shape[0], dtype=torch.bool, device=device)
    for i in range(max_len):
        row = model.decode(buf, enc, src)[:, i]
        if suppress_pad:
            row[:, c.pad_token_id] = -torch.inf
        nxt = torch.where(done, c.pad_token_id, torch.argmax(row, dim=-1))
        buf[:, i + 1] = nxt
        done |= nxt == c.eos_token_id
    return buf[:, 1:]


@functools.lru_cache()
def _assets():
    """(SentencePiece source model, vocab dict) when both asset files exist:
    HF's MarianTokenizer maps the source pieces through the shared
    vocab.json, so raw SentencePiece ids are not model ids."""
    spm_path = os.environ.get("MARIAN_SPM_PATH", "data/marian/source.spm")
    vocab_path = os.environ.get("MARIAN_VOCAB_PATH", "data/marian/vocab.json")
    if not (os.path.exists(spm_path) and os.path.exists(vocab_path)):
        return None, None
    with open(vocab_path, encoding="utf-8") as f:
        return load_unigram(spm_path), json.load(f)


def marian_tokenize(texts: Sequence[str] | str, max_len: int = 64,
                    cfg: Optional[MarianConfig] = None) -> np.ndarray:
    """Source tokenization: pieces through vocab.json, then eos, right-padded
    with pad to (N, max_len) int32.  Without the assets, a deterministic
    hash of each whitespace word stands in (wrong for real checkpoints)."""
    cfg = cfg or MarianConfig.opus_zh_en()
    if isinstance(texts, str):
        texts = [texts]
    out = np.full((len(texts), max_len), cfg.pad_token_id, np.int32)
    proc, vocab = _assets()
    if proc is None:
        warnings.warn("Marian tokenizer assets not found (set MARIAN_SPM_PATH + "
                      "MARIAN_VOCAB_PATH); using a deterministic hash stand-in.")
    unk = (vocab or {}).get("<unk>", 1)
    for i, text in enumerate(texts):
        if proc is not None:
            ids = [vocab.get(p, unk) for p in proc.encode_as_pieces(text)]
        else:
            ids = []
            for tok in text.lower().split():
                h = 0
                for ch in tok.encode("utf-8"):
                    h = (h * 131 + ch) % (cfg.vocab_size - 2)
                ids.append(h + 1)
        ids = ids[: max_len - 1] + [cfg.eos_token_id]
        out[i, : len(ids)] = ids
    return out


def marian_detokenize(ids, cfg: Optional[MarianConfig] = None) -> str:
    """One generated id row -> text: stops at eos, skips pad, `▁` marks a
    word start.  Without the vocabulary, each id prints as <id>."""
    cfg = cfg or MarianConfig.opus_zh_en()
    ids = [int(i) for i in (ids.tolist() if torch.is_tensor(ids) else np.asarray(ids))]
    _, vocab = _assets()
    if vocab is None:
        return " ".join(f"<{i}>" for i in ids if i not in (cfg.pad_token_id, cfg.eos_token_id))
    inv = {v: k for k, v in vocab.items()}
    pieces = []
    for i in ids:
        if i == cfg.eos_token_id:
            break
        if i != cfg.pad_token_id:
            pieces.append(inv.get(i, "<unk>"))
    return "".join(pieces).replace("▁", " ").strip()


def marian_translator(model: MarianMT, max_len: int = 64) -> Callable[[str], str]:
    """text -> greedy translation through `model` on its device."""

    def translate(text: str) -> str:
        ids = marian_tokenize([text], cfg=model.cfg)
        return marian_detokenize(greedy_decode(model, ids, max_len)[0], model.cfg)

    return translate


_MARIAN_LAYER_KEY = re.compile(
    r"(encoder|decoder)\.layers\.\d+\.("
    r"(self_attn|encoder_attn)\.(q|k|v|out)_proj|self_attn_layer_norm|encoder_attn_layer_norm"
    r"|final_layer_norm|fc1|fc2)\.(weight|bias)")
# HF keys the port recomputes (the sinusoids) or ties to `shared.weight`
_MARIAN_DROPPED = ("encoder.embed_positions.weight", "decoder.embed_positions.weight",
                   "encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
                   "lm_head.weight")


def convert_marian(state_dict) -> StateDict:
    """HF `MarianMTModel` state dict -> `MarianMT` keys: `model.` stripped,
    `final_logits_bias` (1, V) -> (V,); the position tables (regenerated as
    sinusoids) and the tied embedding copies and `lm_head` dropped."""
    out = {}
    for key, val in state_dict.items():
        name = key[len("model."):] if key.startswith("model.") else key
        if name in _MARIAN_DROPPED:
            continue
        if name == "final_logits_bias":
            val = val.reshape(-1)
        elif name != "shared.weight" and not _MARIAN_LAYER_KEY.fullmatch(name):
            raise KeyError(f"unmapped Marian key: {key}")
        out[name] = val
    return out
