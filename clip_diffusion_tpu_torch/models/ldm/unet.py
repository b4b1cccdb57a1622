"""Latent-diffusion UNet (cross-attention conditioned) in PyTorch.

Counterpart of `clip_diffusion_tpu.models.ldm.unet`: CompVis LDM
txt2img-f8-large's UNet (model_channels 320, channel mult (1,2,4,4), 2 res
blocks, a SpatialTransformer of depth 1 with 8 heads and context dim 1280
at downsample factors {1,2,4}) over 4-channel f8 latents, about 872M
parameters.

The ADM building blocks (`ResBlock` without scale-shift norm, `Downsample`
and `Upsample` with convs, `GroupNorm32`, `timestep_embedding`) come from
`models/unet.py`.  The boundary keeps the JAX layout: `LDMUNet(x, t,
context)` takes NHWC latents, (B,) timesteps and (B, S, D) context and
returns NHWC float32.  State-dict keys follow the CompVis checkpoint
(`input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight`, ...).
Numerics kept from the JAX package:

* convs and linears compute in `config.dtype` (bfloat16 at full width);
* GroupNorm eps 1e-5 in the ResBlocks and the output head, 1e-6 in the
  SpatialTransformer's `norm`; LayerNorms in float32, cast back;
* cross-attention logits in the compute dtype, divided by sqrt(dim_head)
  rounded to that dtype (6.3125, 8.9375 and 12.625 in bfloat16 for the
  full model's 40, 80 and 160), softmax in float32 cast back;
* GEGLU's gate through the exact (erf) GELU in float32.

Nothing on the latent path takes a gradient, so there is no remat.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.clip.model import LayerNormF32
from clip_diffusion_tpu_torch.models.unet import (
    Conv2d,
    Downsample,
    GroupNorm32,
    Linear,
    ResBlock,
    Upsample,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (1, 2, 4)  # attention_resolutions [4,2,1]
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 1280
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "LDMUNetConfig":
        return LDMUNetConfig(model_channels=32, channel_mult=(1, 2), attention_ds=(1, 2),
                             num_heads=2, context_dim=16, dtype=torch.float32)


class CrossAttention(nn.Module):
    """Queries from the image tokens, keys and values from `context` (or
    from the image tokens for self-attention)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        # sqrt(dim_head) rounded to the compute dtype; logits are divided by it
        self.scale = torch.tensor(math.sqrt(dim_head), dtype=dtype, device="cpu").item()
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype=dtype)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, t, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(b, t, h, d).transpose(1, 2)
        k = self.to_k(context).reshape(b, -1, h, d).transpose(1, 2)
        v = self.to_v(context).reshape(b, -1, h, d).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / self.scale  # (b, h, t, s)
        attn = torch.softmax(logits.to(torch.float32), dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, h * d)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x):
        h, gate = torch.chunk(self.proj(x), 2, dim=-1)
        return h * F.gelu(gate.to(torch.float32)).to(h.dtype)


class FeedForward(nn.Module):
    """`net.0` GEGLU to 4x width, `net.1` CompVis's dropout slot, `net.2`
    the output projection."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, dtype), nn.Identity(),
                                  Linear(dim * 4, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dtype)
        self.ff = FeedForward(dim, dtype)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype)
        self.norm1, self.norm2, self.norm3 = (LayerNormF32(dim) for _ in range(3))

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 conv in, transformer blocks over the (h, w) tokens in
    row-major order, 1x1 conv out, residual."""

    def __init__(self, channels: int, heads: int, depth: int, context_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads, context_dim, dtype)
            for _ in range(depth)
        ])
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)  # (b, hw, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(y)


class LDMUNet(nn.Module):
    """eps-model over latents: (x NHWC, t (B,), context (B, S, D)) -> NHWC
    float32."""

    def __init__(self, config: LDMUNetConfig):
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed = nn.ModuleList([
            Linear(mc, time_dim, dtype=dt), nn.SiLU(), Linear(time_dim, time_dim, dtype=dt),
        ])

        def res(ch_in, ch_out):
            return ResBlock(ch_in, time_dim, ch_out, use_scale_shift_norm=False, dtype=dt)

        def attn(ch):
            return SpatialTransformer(ch, cfg.num_heads, cfg.transformer_depth,
                                      cfg.context_dim, dt)

        self.input_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(cfg.in_channels, mc, 3, padding=1, dtype=dt)])
        ])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, dt)]))
                ds *= 2
                chans.append(ch)

        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_ds:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, dt))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.ModuleList([
            GroupNorm32(ch), nn.SiLU(), Conv2d(ch, cfg.out_channels, 3, padding=1, dtype=dt),
        ])

    @staticmethod
    def _run(layer, h, emb, context):
        if isinstance(layer, ResBlock):
            return layer(h, emb)
        if isinstance(layer, SpatialTransformer):
            return layer(h, context)
        return layer(h)

    def forward(self, x, timesteps, context):
        cfg = self.config
        emb = timestep_embedding(timesteps, cfg.model_channels)
        emb = self.time_embed[0](emb.to(cfg.dtype))
        emb = self.time_embed[2](F.silu(emb))
        context = context.to(cfg.dtype)

        h = x.to(cfg.dtype).permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        skips = []
        for block in self.input_blocks:
            for layer in block:
                h = self._run(layer, h, emb, context)
            skips.append(h)
        for layer in self.middle_block:
            h = self._run(layer, h, emb, context)
        for block in self.output_blocks:
            h = torch.cat([h, skips.pop()], dim=1)
            for layer in block:
                h = self._run(layer, h, emb, context)
        h = self.out[2](F.silu(self.out[0](h)))
        return h.to(torch.float32).permute(0, 2, 3, 1)
