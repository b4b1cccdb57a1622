"""LPIPS perceptual distance with the VGG16 backbone.

Counterpart of `clip_diffusion_tpu.models.lpips`: the shift/scale layer on
[-1, 1] NHWC inputs, VGG16 features at relu{1_2,2_2,3_3,4_3,5_3}, per
location unit-normalisation over channels (norm floored at 1e-10), squared
differences, 1x1 `lin` heads without bias, a spatial mean, summed over the
five stages.  Names follow the torch `lpips` checkpoints
(`net.slice{s}.{i}.weight` with torchvision's VGG16 feature indices,
`lin{i}.model.1.weight`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
