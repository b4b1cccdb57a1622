"""LPIPS perceptual distance with the VGG16 backbone.

Counterpart of `clip_diffusion_tpu.models.lpips`: the shift/scale layer on
[-1, 1] NHWC inputs, VGG16 features at relu{1_2,2_2,3_3,4_3,5_3}, per
location unit-normalisation over channels (norm floored at 1e-10), squared
differences, 1x1 `lin` heads without bias, a spatial mean, summed over the
five stages.  Names follow the torch `lpips` checkpoints
(`net.slice{s}.{i}.weight` with torchvision's VGG16 feature indices,
`lin{i}.model.1.weight`); `convert_lpips` also takes torchvision's VGG16
file (`features.N.*`) merged with the lpips repository's lin heads.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.convert import StateDict
from clip_diffusion_tpu_torch.models.from_jax import VGG16_CONV_IDX

# channels per VGG16 stage, and the stage each torchvision conv index is in
_STAGES = (64, 128, 256, 512, 512)
_CONVS_PER_STAGE = (2, 2, 3, 3, 3)

# the "scaling layer" constants applied to [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The conv tower; forward returns the five stage outputs (post-ReLU),
    NCHW."""

    def __init__(self):
        super().__init__()
        idx = iter(VGG16_CONV_IDX)
        c_in = 3
        for s, (ch, n) in enumerate(zip(_STAGES, _CONVS_PER_STAGE)):
            convs = {}
            for _ in range(n):
                convs[str(next(idx))] = nn.Conv2d(c_in, ch, 3, padding=1)
                c_in = ch
            setattr(self, f"slice{s + 1}", nn.ModuleDict(convs))

    def forward(self, x):
        feats = []
        for s in range(len(_STAGES)):
            if s:
                x = F.max_pool2d(x, 2, 2)
            for conv in getattr(self, f"slice{s + 1}").values():
                x = F.relu(conv(x))
            feats.append(x)
        return feats


class _LinHead(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """lpips.LPIPS(net='vgg'): (x, y) NHWC in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, ch in enumerate(_STAGES):
            setattr(self, f"lin{i}", _LinHead(ch))

    def features(self, x):
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        return self.net(((x - shift) / scale).permute(0, 3, 1, 2))

    def forward(self, x, y):
        fx, fy = self.features(x), self.features(y)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=1, keepdim=True), 1e-10)
            b = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=1, keepdim=True), 1e-10)
            w = getattr(self, f"lin{i}")((a - b) ** 2)
            total = total + torch.mean(w, dim=(1, 2, 3))
        return total


_LPIPS_KEY = re.compile(r"net\.slice[1-5]\.\d+\.(weight|bias)|lin[0-4]\.model\.1\.weight")
_LIN_KEY = re.compile(r"lin[0-4]\.model\.1\.weight")


def convert_lpips(state_dict) -> StateDict:
    """The `lpips` package's VGG state dict (`net.slice{s}.{i}.*`,
    `lin{i}.model.1.weight`, and the constant `scaling_layer.*` buffers,
    dropped) -> the port's keys.  A dict holding torchvision's `features.N.*`
    keys instead is taken as the two files `convert_lpips_parts` reads,
    merged into one."""
    if any(k.startswith("features.") for k in state_dict):
        vgg = {k: v for k, v in state_dict.items() if k.startswith(("features.", "classifier."))}
        lin = {k: v for k, v in state_dict.items() if k not in vgg}
        return convert_lpips_parts(vgg, lin)
    out = {}
    for key, val in state_dict.items():
        if key.startswith("scaling_layer."):
            continue
        if not _LPIPS_KEY.fullmatch(key):
            raise KeyError(f"unmapped LPIPS key: {key}")
        out[key] = val
    return out


def convert_lpips_parts(vgg_state_dict, lin_state_dict) -> StateDict:
    """torchvision's VGG16 (`features.N.*`, vgg16-397923af.pth; its
    `classifier.*` dropped) and the lpips repository's lin heads
    (`lin{i}.model.1.weight`, weights/v0.1/vgg.pth), the two files the
    `lpips` package assembles -> the port's keys: `features.N` becomes
    `net.slice{s}.N`, the slice holding torchvision's conv N."""
    slice_of, n = {}, 0
    for s, count in enumerate(_CONVS_PER_STAGE):
        for idx in VGG16_CONV_IDX[n:n + count]:
            slice_of[idx] = s + 1
        n += count
    out = {}
    for key, val in vgg_state_dict.items():
        if key.startswith("classifier."):
            continue
        parts = key.split(".")
        if len(parts) != 3 or parts[0] != "features" or not parts[1].isdigit() \
                or int(parts[1]) not in slice_of:
            raise KeyError(f"unmapped VGG16 key: {key}")
        out[f"net.slice{slice_of[int(parts[1])]}.{parts[1]}.{parts[2]}"] = val
    for key, val in lin_state_dict.items():
        if not _LIN_KEY.fullmatch(key):
            raise KeyError(f"unmapped LPIPS lin key: {key}")
        out[key] = val
    return out
