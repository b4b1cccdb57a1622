"""OpenAI-CLIP ViT towers in PyTorch.

Counterpart of `clip_diffusion_tpu.models.clip.model` for the ViT
perceptors (ViT-B/32, ViT-B/16, ViT-L/14) and the text tower: packed
[q; k; v] `in_proj`, QuickGELU MLPs, pre-LN blocks, float32 LayerNorm
(eps 1e-5), attention logits in the compute dtype scaled by multiplying
with 1/sqrt(d), float32 softmax, and EOT pooling at argmax(tokens).
Parameter names follow the OpenAI checkpoints (`visual.conv1.weight`,
`transformer.resblocks.0.attn.in_proj_weight`, ...); the patch embedding is
a stride-p conv whose (width, c, p, p) weight is the JAX (p, p, c, width)
kernel transposed.  Image inputs are CLIP-normalized NHWC; apply
`clip_normalize` to [0, 1] images first.  The ModifiedResNet towers (RN50,
RN101) are a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.clip.tokenizer import CONTEXT_LENGTH, VOCAB_SIZE
from clip_diffusion_tpu_torch.models.unet import Linear

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC -> CLIP-normalized."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images01.dtype, device=images01.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images01.dtype, device=images01.device)
    return (images01 - mean) / std


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    image_resolution: int
    # vision: ViT if vision_patch_size is set, else ModifiedResNet
    vision_layers: Tuple[int, ...] | int
    vision_width: int
    vision_patch_size: Optional[int]
    vision_heads: int
    context_length: int = CONTEXT_LENGTH
    vocab_size: int = VOCAB_SIZE
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    dtype: torch.dtype = torch.float32

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size is not None


CLIP_PRESETS = {
    "ViT-B/32": CLIPConfig("ViT-B/32", 512, 224, 12, 768, 32, 12),
    "ViT-B/16": CLIPConfig("ViT-B/16", 512, 224, 12, 768, 16, 12),
    "ViT-L/14": CLIPConfig(
        "ViT-L/14", 768, 224, 24, 1024, 14, 16,
        text_width=768, text_heads=12, text_layers=12,
    ),
    "RN50": CLIPConfig("RN50", 1024, 224, (3, 4, 6, 3), 64, None, 32),
    "RN101": CLIPConfig("RN101", 512, 224, (3, 4, 23, 3), 64, None, 32),
}


def tiny_clip_config(name: str = "tiny") -> CLIPConfig:
    """Small ViT config with the same topology, for tests."""
    return CLIPConfig(
        name, 64, 32, 2, 64, 16, 4, text_width=32, text_heads=2, text_layers=2
    )


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in float32, returned in the input dtype."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-5)

    def forward(self, x):
        out = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                           self.weight.to(torch.float32),
                           self.bias.to(torch.float32), self.eps)
        return out.to(x.dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention layout: packed in_proj + out_proj."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        d = width // heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width, dtype=dtype)
        # 1/sqrt(d) rounded to the compute dtype; logits are multiplied by it
        self.scale = torch.tensor(d ** -0.5, dtype=dtype, device="cpu").item()

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        d = self.width // self.heads
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (u.reshape(b, t, self.heads, d).transpose(1, 2)
                   for u in torch.chunk(qkv, 3, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        attn = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, self.width)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, dtype=dtype)
        self.c_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, dtype)
        self.ln_1 = LayerNormF32(width)
        self.mlp = MLP(width, dtype)
        self.ln_2 = LayerNormF32(width)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype) for _ in range(layers)
        )

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.vision_patch_size
        n_patches = (cfg.image_resolution // p) ** 2
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(n_patches + 1, w))
        self.ln_pre = LayerNormF32(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads, cfg.dtype)
        self.ln_post = LayerNormF32(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images):
        dt = self.cfg.dtype
        x = images.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.conv2d(x, self.conv1.weight.to(dt), stride=self.conv1.stride)
        x = x.flatten(2).transpose(1, 2)  # (b, gh*gw, w), row-major patches
        b = x.shape[0]
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(dt)


class CLIPModel(nn.Module):
    """Both towers: `encode_image` and `encode_text`."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        if not cfg.is_vit:
            raise NotImplementedError(
                f"CLIP {cfg.name}: the ModifiedResNet towers (RN50, RN101) are "
                "a later slice of the PyTorch port"
            )
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads, cfg.dtype)
        self.ln_final = LayerNormF32(cfg.text_width)
        self.text_projection = nn.Parameter(torch.empty(cfg.text_width, cfg.embed_dim))

    def encode_image(self, images):
        """CLIP-normalized NHWC images -> (B, embed_dim) float32."""
        return self.visual(images).to(torch.float32)

    def encode_text(self, tokens):
        """(B, 77) int token ids -> (B, embed_dim) float32, EOT-pooled."""
        dt = self.cfg.dtype
        x = self.token_embedding(tokens).to(dt)
        x = x + self.positional_embedding.to(dt)
        t = tokens.shape[1]
        mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
        x = self.transformer(x, mask)
        x = self.ln_final(x)
        eot = torch.argmax(tokens, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return (pooled @ self.text_projection.to(pooled.dtype)).to(torch.float32)
