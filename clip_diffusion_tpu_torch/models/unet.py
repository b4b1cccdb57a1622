"""ADM ("guided diffusion") UNet in PyTorch.

Counterpart of `clip_diffusion_tpu.models.unet`: the 512^2 unconditional
ImageNet UNet (256 base channels, channel mult (0.5,1,1,2,2,4,4), 2 res
blocks per level, attention at downsample factors {16,32,64}, 64 head
channels, ResBlock up/downsampling, scale-shift GroupNorm conditioning,
learn_sigma output), about 552M parameters.

The public boundary keeps the JAX layout: `UNetModel(x, t)` takes NHWC
images and returns NHWC float32.  Inside, tensors are NCHW.  Module and
parameter names follow the reference torch checkpoints (`input_blocks.3.0.
in_layers.0.weight`, ...); `models/from_jax.py` carries the JAX package's
parameters across.  Numerics kept from the JAX package:

* every conv and linear computes in `config.dtype` (bfloat16 on the main
  path), casting its weight and input to it as flax's `dtype=` does;
* GroupNorm statistics in float32: for bfloat16 inputs E[x^2] - m^2 in
  float32, the per-(batch, channel) affine built in float32 and cast to
  bfloat16, one bfloat16 multiply-add; float32 inputs take `F.group_norm`;
* attention logits in the compute dtype, scaled by *division* by sqrt(d)
  rounded to that dtype, softmax in float32 cast back; qkv is laid out per
  head as [q; k; v] (the ADM layout, not torch's packed [Q; K; V]);
* `remat=True` runs each ResBlock/AttentionBlock under
  `torch.utils.checkpoint`, which recomputes the whole block in the
  backward (`remat_policy` "full", its only value).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("full",)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 512
    in_channels: int = 3
    model_channels: int = 256
    out_channels: int = 6  # learn_sigma -> eps + variance interpolation
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (16, 32, 64)  # 512/(32,16,8)
    channel_mult: Tuple[float, ...] = (0.5, 1, 1, 2, 2, 4, 4)
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # what the backward recomputes under remat: "full", everything
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"expected one of {REMAT_POLICIES}")

    @staticmethod
    def for_image_size(image_size: int, **kw) -> "UNetConfig":
        """channel_mult / attention defaults per canvas size."""
        mults = {
            512: (0.5, 1, 1, 2, 2, 4, 4),
            256: (1, 1, 2, 2, 4, 4),
            128: (1, 1, 2, 3, 4),
            64: (1, 2, 3, 4),
        }[image_size]
        attn = tuple(image_size // r for r in (32, 16, 8))
        return UNetConfig(image_size=image_size, channel_mult=mults,
                          attention_ds=attn, **kw)

    @staticmethod
    def tiny(image_size: int = 32) -> "UNetConfig":
        """Small config with the same topology knobs, for tests."""
        return UNetConfig(
            image_size=image_size,
            model_channels=32,
            channel_mult=(1, 2),
            attention_ds=(2,),
            num_head_channels=16,
            dtype=torch.float32,
            remat=False,
        )


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, guided-diffusion convention: cat(cos, sin).
    Computed in float64 and returned as float32: the arguments reach 1000,
    where float32 phases are off by up to 6e-5."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float64, device=t.device) / half
    )
    args = t.to(torch.float64)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(torch.float32)


class Conv2d(nn.Conv2d):
    """Conv computing in `dtype` (input and weight cast to it)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class Linear(nn.Linear):
    """Linear computing in `dtype` (input and weight cast to it)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(min(32, C)) with float32 statistics whatever the input
    dtype; returns the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        groups = min(32, channels)
        if channels % groups:
            raise ValueError(
                f"GroupNorm32: channel count {channels} is not divisible by "
                f"num_groups={groups}"
            )
        super().__init__(groups, channels, eps=eps)

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return self._fast_bf16(x)
        out = F.group_norm(x.to(torch.float32), self.num_groups,
                           self.weight.to(torch.float32),
                           self.bias.to(torch.float32), self.eps)
        return out.to(x.dtype)

    def _fast_bf16(self, x):
        """f32 statistics, f32 affine a = w*rsqrt(var+eps), b = bias - m*a,
        cast to bf16, then one bf16 multiply-add over the tensor."""
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.reshape(b, g, -1)
        m = torch.mean(xg, dim=2, dtype=torch.float32)
        m2 = torch.mean(torch.square(xg.to(torch.float32)), dim=2)
        inv = torch.rsqrt(torch.clamp_min(m2 - m * m, 0.0) + self.eps)
        a = self.weight.to(torch.float32).reshape(g, c // g)[None] * inv[:, :, None]
        bb = self.bias.to(torch.float32).reshape(g, c // g)[None] - m[:, :, None] * a
        expand = (slice(None), slice(None)) + (None,) * (x.ndim - 2)
        a = a.reshape(b, c).to(x.dtype)[expand]
        bb = bb.reshape(b, c).to(x.dtype)[expand]
        return x * a + bb


def _avg_pool2(x):
    return F.avg_pool2d(x, 2)


def _nearest_up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Downsample(nn.Module):
    """Stride-2 downsampling: a 3x3 conv with symmetric padding 1."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest x2 upsampling, then a 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(_nearest_up2(x))


class ResBlock(nn.Module):
    """ADM residual block with scale-shift-norm time conditioning and
    optional up/downsampling."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels), nn.SiLU(),
            Conv2d(channels, out_channels, 3, padding=1, dtype=dtype),
        ])
        emb_width = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_layers = nn.ModuleList([nn.SiLU(), Linear(emb_channels, emb_width, dtype=dtype)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_channels), nn.SiLU(), nn.Identity(),
            Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype),
        ])
        self.skip_connection = (
            Conv2d(channels, out_channels, 1, dtype=dtype)
            if channels != out_channels else nn.Identity()
        )

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = F.silu(self.out_layers[0](h + emb_out))
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Self-attention over the flattened spatial positions (row-major over
    (h, w)), float32 softmax."""

    def __init__(self, channels: int, num_head_channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.num_head_channels = num_head_channels
        self.dtype = dtype
        # sqrt(d) rounded to the compute dtype; logits are divided by it
        self.scale = torch.tensor(math.sqrt(num_head_channels), dtype=dtype, device="cpu").item()
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels, dtype=dtype)
        self.proj_out = Linear(channels, channels, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        d = self.num_head_channels
        heads = c // d
        y = self.norm(x).reshape(b, c, h * w).transpose(1, 2)  # (b, hw, c)
        qkv = self.qkv(y).reshape(b, h * w, heads, 3 * d)
        q, k, v = (t.transpose(1, 2) for t in torch.split(qkv, d, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) / self.scale  # (b, heads, t, s)
        attn = torch.softmax(logits.to(torch.float32), dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, h * w, c)
        out = self.proj_out(out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class UNetModel(nn.Module):
    """The full ADM UNet: NHWC in [-1, 1] -> NHWC float32 with
    `out_channels` (eps + raw variance when learn_sigma)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        ch0 = int(cfg.channel_mult[0] * cfg.model_channels)
        time_dim = cfg.model_channels * 4
        self.time_embed = nn.ModuleList([
            Linear(cfg.model_channels, time_dim, dtype=dt), nn.SiLU(),
            Linear(time_dim, time_dim, dtype=dt),
        ])

        def res(ch_in, ch_out, **kw):
            return ResBlock(ch_in, time_dim, ch_out, cfg.use_scale_shift_norm,
                            dtype=dt, **kw)

        def attn(ch):
            return AttentionBlock(ch, cfg.num_head_channels, dtype=dt)

        self.input_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(cfg.in_channels, ch0, 3, padding=1, dtype=dt)])
        ])
        chans = [ch0]
        ch, ds = ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = int(mult * cfg.model_channels)
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, out_ch)]
                ch = out_ch
                if ds in cfg.attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                if not cfg.resblock_updown:
                    raise NotImplementedError("resblock_updown=False is not ported")
                self.input_blocks.append(nn.ModuleList([res(ch, ch, down=True)]))
                ds *= 2
                chans.append(ch)

        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out_ch = int(mult * cfg.model_channels)
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), out_ch)]
                ch = out_ch
                if ds in cfg.attention_ds:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(res(ch, ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.ModuleList([
            GroupNorm32(ch), nn.SiLU(),
            Conv2d(ch, cfg.out_channels, 3, padding=1, dtype=dt),
        ])

    def _run(self, layer, h, emb):
        fn = (lambda a, e: layer(a, e)) if isinstance(layer, ResBlock) else (lambda a, e: layer(a))
        if self.config.remat and torch.is_grad_enabled() and not isinstance(layer, Conv2d):
            return checkpoint(fn, h, emb, use_reentrant=False)
        return fn(h, emb)

    def forward(self, x, timesteps):
        cfg = self.config
        emb = timestep_embedding(timesteps, cfg.model_channels)
        emb = self.time_embed[0](emb.to(cfg.dtype))
        emb = self.time_embed[2](F.silu(emb))

        h = x.to(cfg.dtype).permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
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
        h = F.silu(self.out[0](h))
        h = self.out[2](h)
        return h.to(torch.float32).permute(0, 2, 3, 1)


def split_model_output(out):
    """learn_sigma head: (B, H, W, 2C) -> (eps, raw_variance)."""
    c = out.shape[-1] // 2
    return out[..., :c], out[..., c:]
