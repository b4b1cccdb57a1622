"""Real-ESRGAN super-resolution (RRDBNet) in PyTorch.

Counterpart of `clip_diffusion_tpu.models.esrgan`: `RRDBNet(3, 3, 64, 23,
32, scale)` with 23 residual-in-residual dense blocks (3 dense blocks of 5
convs each, LeakyReLU 0.2, residual scaling 0.2), two nearest x2 stages,
and for x2 a space-to-depth packing of the input.  The packing follows the
JAX package, channel fastest: input channel (fy * 2 + fx) * C + c, not
`F.pixel_unshuffle`'s c * 4 + fy * 2 + fx.  Keys follow basicsr's
(`body.N.rdbM.convK.weight`).  Images are NHWC in [0, 1] at the boundary.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.unet import Conv2d, _nearest_up2
from clip_diffusion_tpu_torch.utils.dirs import list_images, make_dir
from clip_diffusion_tpu_torch.utils.image_io import array_to_image, load_image


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _space_to_depth(x, factor: int):
    """NCHW -> (B, factor^2 * C, H/factor, W/factor), channel index
    (fy * factor + fx) * C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, c * factor * factor, h // factor, w // factor)


def _conv(cin, cout):
    return Conv2d(cin, cout, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        g = num_grow_ch
        self.conv1 = _conv(num_feat, g)
        self.conv2 = _conv(num_feat + g, g)
        self.conv3 = _conv(num_feat + 2 * g, g)
        self.conv4 = _conv(num_feat + 3 * g, g)
        self.conv5 = _conv(num_feat + 4 * g, num_feat)

    def forward(self, x):
        c1 = _lrelu(self.conv1(x))
        c2 = _lrelu(self.conv2(torch.cat([x, c1], 1)))
        c3 = _lrelu(self.conv3(torch.cat([x, c1, c2], 1)))
        c4 = _lrelu(self.conv4(torch.cat([x, c1, c2, c3], 1)))
        c5 = self.conv5(torch.cat([x, c1, c2, c3, c4], 1))
        return x + 0.2 * c5


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = (
            ResidualDenseBlock(num_feat, num_grow_ch) for _ in range(3))

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """NHWC [0, 1] -> NHWC at `scale` (2 or 4) times the size, unclipped;
    float32 throughout."""

    def __init__(self, num_out_ch: int = 3, num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, scale: int = 4):
        super().__init__()
        if scale not in (2, 4):
            raise ValueError(f"RRDBNet scale must be 2 or 4, got {scale}")
        self.scale, self.num_out_ch = scale, num_out_ch
        self.conv_first = _conv(3 * 4 if scale == 2 else 3, num_feat)  # RGB input
        self.body = nn.ModuleList([RRDB(num_feat, num_grow_ch) for _ in range(num_block)])
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1 = _conv(num_feat, num_feat)
        self.conv_up2 = _conv(num_feat, num_feat)
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        if self.scale == 2:
            x = _space_to_depth(x, 2)
        feat = self.conv_first(x)
        body = feat
        for block in self.body:
            body = block(body)
        feat = feat + self.conv_body(body)
        feat = _lrelu(self.conv_up1(_nearest_up2(feat)))
        feat = _lrelu(self.conv_up2(_nearest_up2(feat)))
        out = self.conv_last(_lrelu(self.conv_hr(feat)))
        return out.permute(0, 2, 3, 1)


@torch.inference_mode()
def upscale(model: RRDBNet, images01, tile: int = 0):
    """NHWC [0, 1] images on the model's device -> upscaled [0, 1].

    `tile` > 0 runs tiles of that size, each with up to 16 px of context on
    every side, and keeps each tile's centre (0: the whole image at once)."""
    if tile <= 0:
        return torch.clamp(model(images01), 0.0, 1.0)
    pad = 16
    b, h, w, _ = images01.shape
    s = model.scale
    out = torch.zeros((b, h * s, w * s, model.num_out_ch), dtype=images01.dtype,
                      device=images01.device)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            ys, xs = max(y0 - pad, 0), max(x0 - pad, 0)
            ye, xe = min(y1 + pad, h), min(x1 + pad, w)
            up = torch.clamp(model(images01[:, ys:ye, xs:xe]), 0.0, 1.0)
            out[:, y0 * s:y1 * s, x0 * s:x1 * s] = up[
                :, (y0 - ys) * s:(y1 - ys) * s, (x0 - xs) * s:(x1 - xs) * s]
    return torch.clamp(out, 0.0, 1.0)


def super_resolution_folder(model: RRDBNet, folder: str, exception_paths=(), tile: int = 0):
    """Upscale every PNG in `folder` except `exception_paths` into
    <folder>/sr/ under the same names; returns the written paths."""
    out_dir = make_dir(os.path.join(folder, "sr"))
    skip = {os.path.abspath(p) for p in exception_paths}
    device = next(model.parameters()).device
    written = []
    for path in list_images(folder):
        if os.path.abspath(path) in skip:
            continue
        img = torch.from_numpy(load_image(path))[None].to(device)
        up = upscale(model, img, tile=tile)[0].float().cpu().numpy()
        dest = os.path.join(out_dir, os.path.basename(path))
        array_to_image(up).save(dest)
        written.append(dest)
    return written
