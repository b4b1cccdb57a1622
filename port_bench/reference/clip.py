"""OpenAI CLIP towers in plain float32 PyTorch, and the hash tokenizer.

openai/CLIP `model.py`: the VisionTransformer (pre-LN blocks, packed
in_proj, QuickGELU, class token, ln_post on it, `proj`), the
ModifiedResNet (3-conv stem, avg-pool bottlenecks, attention pool with the
mean token prepended) and the causal text transformer, EOT-pooled.  Images
are CLIP-normalized NHWC.  BatchNorm is the eval form on running
statistics.

No BPE table ships with the repository, so prompts are tokenized by the
deterministic hash stand-in that the program also falls back to: each
regex token of the cleaned text hashed into the merge-token id range,
bracketed by SOT/EOT and zero-padded to 77.
"""

from __future__ import annotations

import dataclasses
import html
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import LayerNorm, Linear, attention, conv2d, linear, matmul

try:
    import regex as _re

    _PAT = _re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                       r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", _re.IGNORECASE)
except ImportError:
    import re as _re

    _PAT = _re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                       r"""\w+|[^\s\w]+""", _re.IGNORECASE)

CONTEXT_LENGTH, VOCAB_SIZE, SOT, EOT = 77, 49408, 49406, 49407
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def tokenize(texts) -> np.ndarray:
    out = np.zeros((len(texts), CONTEXT_LENGTH), dtype=np.int64)
    for i, text in enumerate(texts):
        clean = " ".join(html.unescape(html.unescape(text)).split()).strip().lower()
        ids = [SOT]
        for token in _PAT.findall(clean):
            h = 0
            for ch in token.encode("utf-8"):
                h = (h * 131 + ch) % (VOCAB_SIZE - 2 - 512)
            ids.append(512 + h)
        ids = (ids + [EOT])[:CONTEXT_LENGTH]
        ids[-1] = EOT
        out[i, : len(ids)] = ids
    return out


def clip_normalize(images01):
    mean = torch.tensor(MEAN, dtype=images01.dtype, device=images01.device)
    std = torch.tensor(STD, dtype=images01.dtype, device=images01.device)
    return (images01 - mean) / std


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: Tuple[int, ...] | int
    vision_width: int
    vision_patch_size: Optional[int]
    vision_heads: int
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    context_length: int = CONTEXT_LENGTH
    vocab_size: int = VOCAB_SIZE


class MultiheadAttention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        d = self.width // self.heads
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (u.reshape(b, t, self.heads, d).transpose(1, 2) for u in qkv.chunk(3, -1))
        out = attention(q, k, v, d ** -0.5, mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, self.width))


class MLP(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.attn = MultiheadAttention(width, heads)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNorm(width)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        w, p = c.vision_width, c.vision_patch_size
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty((c.image_resolution // p) ** 2 + 1,
                                                             w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, c.vision_layers, c.vision_heads)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, c.embed_dim))

    def forward(self, images):
        x = conv2d(images.permute(0, 3, 1, 2), self.conv1.weight, stride=self.conv1.stride)
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.float().expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.float()
        x = self.transformer(self.ln_pre(x))
        return matmul(self.ln_post(x[:, 0, :]), self.proj)


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x):
        s = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return (x - self.running_mean.float().reshape(s)) * mul.reshape(s) + \
            self.bias.float().reshape(s)


def _conv(x, conv: nn.Conv2d):
    return conv2d(x, conv.weight, stride=conv.stride, padding=conv.padding)


def _pool(x, stride):
    return x if stride == 1 else F.avg_pool2d(x, stride, stride)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.ModuleDict({"0": nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                                             "1": FrozenBatchNorm2d(planes * 4)})

    def forward(self, x):
        out = F.relu(self.bn1(_conv(x, self.conv1)))
        out = F.relu(self.bn2(_conv(out, self.conv2)))
        out = self.bn3(_conv(_pool(out, self.stride), self.conv3))
        identity = x
        if self.downsample is not None:
            identity = self.downsample["1"](_conv(_pool(x, self.stride), self.downsample["0"]))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim, embed_dim, heads, output_dim):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def forward(self, x):
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding.float()
        d = c // self.heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, self.heads, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, -1, self.heads, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, -1, self.heads, d).transpose(1, 2)
        out = attention(q, k, v, d ** -0.5).transpose(1, 2).reshape(b, 1, c)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        self.layers = c.vision_layers
        width = c.vision_width
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width)
        inplanes = width
        for li, blocks in enumerate(c.vision_layers):
            planes = width * 2 ** li
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if li > 0 and bi == 0 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(c.image_resolution // 32, width * 32, width * 32 // 64,
                                        c.embed_dim)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(_conv(x, self.conv1)))
        x = F.relu(self.bn2(_conv(x, self.conv2)))
        x = F.avg_pool2d(F.relu(self.bn3(_conv(x, self.conv3))), 2)
        for li in range(len(self.layers)):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.attnpool(x)


class CLIP(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        self.cfg = c
        self.visual = VisionTransformer(c) if c.vision_patch_size else ModifiedResNet(c)
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(c.context_length, c.text_width))
        self.transformer = Transformer(c.text_width, c.text_layers, c.text_heads)
        self.ln_final = LayerNorm(c.text_width)
        self.text_projection = nn.Parameter(torch.empty(c.text_width, c.embed_dim))

    def encode_image(self, images):
        return self.visual(images)

    def encode_text(self, tokens):
        x = self.token_embedding(tokens).float() + self.positional_embedding.float()
        t = tokens.shape[1]
        mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
        x = self.ln_final(self.transformer(x, mask))
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return matmul(pooled, self.text_projection)
