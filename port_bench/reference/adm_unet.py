"""The ADM ("guided diffusion") UNet in plain float32 PyTorch.

openai/guided-diffusion `unet.py` as the 512x512 unconditional model runs
it: scale-shift GroupNorm time conditioning, ResBlock up/downsampling,
attention at the given downsample factors with `num_head_channels` per
head and the per-head [q; k; v] layout, learn_sigma output.  NHWC in and
out, no activation checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import (
    Conv2d,
    GroupNorm32,
    Linear,
    attention,
    nearest_up2,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class ADMConfig:
    image_size: int = 512
    in_channels: int = 3
    model_channels: int = 256
    out_channels: int = 6
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (16, 32, 64)
    channel_mult: Tuple[float, ...] = (0.5, 1, 1, 2, 2, 4, 4)
    num_head_channels: int = 64


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels, scale_shift=True, up=False,
                 down=False):
        super().__init__()
        self.up, self.down, self.scale_shift = up, down, scale_shift
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.SiLU(),
                                        Conv2d(channels, out_channels, 3, padding=1)])
        width = 2 * out_channels if scale_shift else out_channels
        self.emb_layers = nn.ModuleList([nn.SiLU(), Linear(emb_channels, width)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels), nn.SiLU(), nn.Identity(),
                                         Conv2d(out_channels, out_channels, 3, padding=1)])
        self.skip_connection = (Conv2d(channels, out_channels, 1)
                                if channels != out_channels else nn.Identity())

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h, x = nearest_up2(h), nearest_up2(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        e = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        if self.scale_shift:
            scale, shift = torch.chunk(e, 2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = F.silu(self.out_layers[0](h + e))
        return self.skip_connection(x) + self.out_layers[3](h)


class AttentionBlock(nn.Module):
    def __init__(self, channels, num_head_channels):
        super().__init__()
        self.d = num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels)
        self.proj_out = Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        heads = c // self.d
        y = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
        qkv = self.qkv(y).reshape(b, h * w, heads, 3 * self.d)
        q, k, v = (t.transpose(1, 2) for t in torch.split(qkv, self.d, dim=-1))
        out = attention(q, k, v, self.d ** -0.5).transpose(1, 2).reshape(b, h * w, c)
        return x + self.proj_out(out).transpose(1, 2).reshape(b, c, h, w)


class ADMUNet(nn.Module):
    """(x NHWC, t (B,)) -> NHWC float32 with `out_channels` channels."""

    def __init__(self, cfg: ADMConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = int(cfg.channel_mult[0] * cfg.model_channels)
        tdim = cfg.model_channels * 4
        self.time_embed = nn.ModuleList([Linear(cfg.model_channels, tdim), nn.SiLU(),
                                         Linear(tdim, tdim)])
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(cfg.in_channels, ch0, 3,
                                                                 padding=1)])])
        chans, ch, ds = [ch0], ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            out = int(mult * cfg.model_channels)
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, tdim, out)]
                ch = out
                if ds in cfg.attention_ds:
                    layers.append(AttentionBlock(ch, cfg.num_head_channels))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([ResBlock(ch, tdim, ch, down=True)]))
                ds *= 2
                chans.append(ch)
        self.middle_block = nn.ModuleList([ResBlock(ch, tdim, ch),
                                           AttentionBlock(ch, cfg.num_head_channels),
                                           ResBlock(ch, tdim, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out = int(mult * cfg.model_channels)
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), tdim, out)]
                ch = out
                if ds in cfg.attention_ds:
                    layers.append(AttentionBlock(ch, cfg.num_head_channels))
                if level and i == cfg.num_res_blocks:
                    layers.append(ResBlock(ch, tdim, ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([GroupNorm32(ch), nn.SiLU(),
                                  Conv2d(ch, cfg.out_channels, 3, padding=1)])

    @staticmethod
    def _run(layer, h, emb):
        return layer(h, emb) if isinstance(layer, ResBlock) else layer(h)

    def forward(self, x, t):
        emb = timestep_embedding(t, self.cfg.model_channels)
        emb = self.time_embed[2](F.silu(self.time_embed[0](emb)))
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        skips = []
        for block in self.input_blocks:
            for layer in block:
                h = self._run(layer, h, emb)
            skips.append(h)
        for layer in self.middle_block:
            h = self._run(layer, h, emb)
        for block in self.output_blocks:
            h = torch.cat([h, skips.pop()], dim=1)
            for layer in block:
                h = self._run(layer, h, emb)
        return self.out[2](F.silu(self.out[0](h))).permute(0, 2, 3, 1)
