"""VQ-f8 first-stage autoencoder (CompVis/taming) in PyTorch.

Counterpart of `clip_diffusion_tpu.models.ldm.autoencoder`: z_channels 4,
ch 128, ch_mult (1,2,2,4), 2 res blocks, attention at 32 px, a 16384 x 4
codebook.  `encode` returns the pre-quantisation latent after
`quant_conv`; `decode` quantises to the nearest codebook row, then runs
`post_quant_conv` and the decoder.  The boundary keeps the JAX layout
(NHWC pixels in [-1, 1], NHWC latents); inside, tensors are NCHW.  Keys
follow taming's (`encoder.down.L.block.I.conv1.weight`,
`quantize.embedding.weight`).

Taming's downsample pads (0, 1) on H and W before a VALID stride-2 conv;
the attention flattens (h, w) row-major and divides float32 logits by
sqrt(c) in float32, as the JAX package does.

`KLModel` is Stable Diffusion XL's first stage (sgm `AutoencoderKL`, the
JAX package has none): the same `Encoder` and `Decoder` (`KLConfig`: ch
128, ch_mult (1,2,4,4), attention only in the mid block), the encoder
giving mean and log-variance (`double_z`), `quant_conv` 8 -> 8 and
`post_quant_conv` 4 -> 4, no codebook.  `encode` returns the posterior
mean times `scale_factor` (0.13025); `decode` divides by it first.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.unet import Conv2d, GroupNorm32, _nearest_up2


@dataclasses.dataclass(frozen=True)
class VQConfig:
    z_channels: int = 4
    embed_dim: int = 4
    n_embed: int = 16384
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 256
    out_ch: int = 3
    dtype: torch.dtype = torch.float32
    double_z: bool = False  # the encoder's conv_out gives 2 x z_channels (mean, log-variance)

    @staticmethod
    def tiny() -> "VQConfig":
        return VQConfig(z_channels=4, embed_dim=4, n_embed=64, ch=16, ch_mult=(1, 2),
                        num_res_blocks=1, attn_resolutions=(), resolution=32)


class AEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AEAttnBlock(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = float(np.sqrt(np.float32(channels)))
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (
            Conv2d(channels, channels, 1, dtype=dtype) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (conv(y).flatten(2).transpose(1, 2) for conv in (self.q, self.k, self.v))
        logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(1, 2)) / self.scale
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Resample(nn.Module):
    """Taming's Downsample (pad (0, 1), VALID stride-2 conv) or Upsample
    (nearest x2, 3x3 conv), each holding one `conv`."""

    def __init__(self, channels: int, down: bool, dtype=torch.float32):
        super().__init__()
        self.down = down
        self.conv = Conv2d(channels, channels, 3, stride=2 if down else 1,
                           padding=0 if down else 1, dtype=dtype)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(_nearest_up2(x))


def _level(blocks, attns, resample=None) -> nn.Module:
    level = nn.Module()
    level.block = nn.ModuleList(blocks)
    level.attn = nn.ModuleList(attns)
    if resample is not None:
        level.add_module("downsample" if resample.down else "upsample", resample)
    return level


def _mid(ch: int, dtype) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = AEResnetBlock(ch, ch, dtype)
    mid.attn_1 = AEAttnBlock(ch, dtype)
    mid.block_2 = AEResnetBlock(ch, ch, dtype)
    return mid


def _run_mid(mid, h):
    return mid.block_2(mid.attn_1(mid.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, c: VQConfig):
        super().__init__()
        dt = c.dtype
        self.conv_in = Conv2d(3, c.ch, 3, padding=1, dtype=dt)
        self.down = nn.ModuleList()
        res, ch = c.resolution, c.ch
        for level, mult in enumerate(c.ch_mult):
            blocks, attns = [], []
            for _ in range(c.num_res_blocks):
                blocks.append(AEResnetBlock(ch, c.ch * mult, dt))
                ch = c.ch * mult
                if res in c.attn_resolutions:
                    attns.append(AEAttnBlock(ch, dt))
            resample = None
            if level != len(c.ch_mult) - 1:
                resample = _Resample(ch, True, dt)
                res //= 2
            self.down.append(_level(blocks, attns, resample))
        self.mid = _mid(ch, dt)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        z_out = 2 * c.z_channels if c.double_z else c.z_channels
        self.conv_out = Conv2d(ch, z_out, 3, padding=1, dtype=dt)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, c: VQConfig):
        super().__init__()
        dt = c.dtype
        ch = c.ch * c.ch_mult[-1]
        self.conv_in = Conv2d(c.z_channels, ch, 3, padding=1, dtype=dt)
        self.mid = _mid(ch, dt)
        res = c.resolution // 2 ** (len(c.ch_mult) - 1)
        levels = []
        for level in reversed(range(len(c.ch_mult))):
            blocks, attns = [], []
            for _ in range(c.num_res_blocks + 1):
                blocks.append(AEResnetBlock(ch, c.ch * c.ch_mult[level], dt))
                ch = c.ch * c.ch_mult[level]
                if res in c.attn_resolutions:
                    attns.append(AEAttnBlock(ch, dt))
            resample = None
            if level != 0:
                resample = _Resample(ch, False, dt)
                res *= 2
            levels.insert(0, _level(blocks, attns, resample))
        self.up = nn.ModuleList(levels)  # indexed by level, run from the last
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv2d(ch, c.out_ch, 3, padding=1, dtype=dt)

    def forward(self, z):
        h = _run_mid(self.mid, self.conv_in(z))
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VQModel(nn.Module):
    """encode: NHWC pixels in [-1, 1] -> NHWC latents (pre-quantisation);
    decode: NHWC latents -> NHWC pixels, quantising first."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(cfg.z_channels, cfg.embed_dim, 1, dtype=cfg.dtype)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1, dtype=cfg.dtype)
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Embedding(cfg.n_embed, cfg.embed_dim)

    def encode(self, x):
        z = self.quant_conv(self.encoder(x.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous()))
        return z.permute(0, 2, 3, 1)

    def nearest_codes(self, z):
        """(..., embed_dim) latents -> the index of the nearest codebook row
        by |z|^2 - 2 z.cb + |cb|^2 in float32."""
        flat = z.reshape(-1, z.shape[-1]).to(torch.float32)
        cb = self.quantize.embedding.weight.to(torch.float32)
        d = (torch.sum(flat ** 2, dim=1, keepdim=True) - (2 * flat) @ cb.T
             + torch.sum(cb ** 2, dim=1)[None, :])
        return torch.argmin(d, dim=1)

    def quantize_latents(self, z):
        """Nearest codebook rows, returned as z + (zq - z) as the JAX
        package's straight-through form evaluates."""
        cb = self.quantize.embedding.weight.to(torch.float32)
        zq = cb[self.nearest_codes(z)].reshape(z.shape)
        return z + (zq - z)

    def decode(self, z):
        h = self.post_quant_conv(self.quantize_latents(z).permute(0, 3, 1, 2).contiguous())
        return self.decoder(h).permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class KLConfig:
    """SDXL's KL-f8 first stage (sgm `sd_xl_base.yaml` first_stage_config)."""

    z_channels: int = 4
    embed_dim: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256
    out_ch: int = 3
    dtype: torch.dtype = torch.float32
    double_z: bool = True
    scale_factor: float = 0.13025

    @staticmethod
    def tiny() -> "KLConfig":
        return KLConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32)


class KLModel(nn.Module):
    """encode: NHWC pixels in [-1, 1] -> NHWC latents, the posterior mean
    times `scale_factor`; decode: NHWC latents -> NHWC pixels, divided by
    `scale_factor` first."""

    def __init__(self, cfg: KLConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, dtype=cfg.dtype)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1, dtype=cfg.dtype)

    def encode(self, x):
        moments = self.quant_conv(self.encoder(x.to(self.cfg.dtype).permute(0, 3, 1, 2)
                                               .contiguous()))
        mean = moments[:, : self.cfg.embed_dim]
        return (mean * self.cfg.scale_factor).permute(0, 2, 3, 1)

    def decode(self, z):
        z = (z.to(self.cfg.dtype) / self.cfg.scale_factor).permute(0, 3, 1, 2).contiguous()
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
