"""Plain float32 building blocks of the reference models, and the one
switch that turns the reference into its lower-precision control.

Every matmul and convolution of the reference models takes its operands
through `q`.  By default `q` is the identity and everything computes in
float32 (the caller turns TF32 off).  Inside `fp8()` each operand is
rounded to float8 e4m3 with a per-tensor scale (amax / 448) and back, so
the reference computes in the precision one step below the bfloat16 that
the configurations state: the control that a later change must not pass.

Parameter names follow the published checkpoints (and the port), so one
state dict fits both.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

_FP8_MAX = 448.0
_MODE = {"fp8": False}


@contextlib.contextmanager
def fp8():
    """Round every matmul and convolution operand to float8 e4m3 inside."""
    old = _MODE["fp8"]
    _MODE["fp8"] = True
    try:
        yield
    finally:
        _MODE["fp8"] = old


def q(t: torch.Tensor) -> torch.Tensor:
    """An operand as the reference computes with it: float32, or float32
    rounded through float8 e4m3 under `fp8()`."""
    t = t.to(torch.float32)
    if not _MODE["fp8"]:
        return t
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a, b):
    return torch.matmul(q(a), q(b))


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    b = None if bias is None else bias.to(torch.float32)
    return F.conv2d(q(x), q(weight), b, stride, padding, 1, groups)


def linear(x, weight, bias=None):
    b = None if bias is None else bias.to(torch.float32)
    return F.linear(q(x), q(weight), b)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(min(32, C)) in float32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(min(32, channels), channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) in float32."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding cat(cos, sin), phases in float64."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t.to(torch.float64)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(torch.float32)


def nearest_up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def attention(q_, k, v, scale: float, mask=None):
    """softmax(q k^T * scale + mask) v over (..., T, d) heads."""
    logits = matmul(q_, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    return matmul(torch.softmax(logits, dim=-1), v)
