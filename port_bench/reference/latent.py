"""The latent-diffusion request in plain float32 PyTorch.

CompVis latent-diffusion txt2img-f8-large (`configs/latent-diffusion/
txt2img-1p4B-eval.yaml`): the BERTEmbedder (x-transformers encoder,
pre-LN, 8 heads x 64, exact GELU, no padding mask), the cross-attention
UNet (SpatialTransformer with GEGLU feed-forward), the VQ-f8 decoder
(nearest-codebook quantisation first) and the DDIMSampler with classifier-
free guidance; then Real-ESRGAN's RRDBNet x4 (basicsr `rrdbnet_arch.py`).
NHWC at the boundaries.  BERT ids come from the hash stand-in the program
uses when no WordPiece vocabulary ships: CLS, one hashed id per
whitespace word, SEP, zero padding to 77.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import (
    Conv2d,
    GroupNorm32,
    LayerNorm,
    Linear,
    attention,
    nearest_up2,
    timestep_embedding,
)
from port_bench.reference.adm_unet import ResBlock
from port_bench.reference.guided import _INIT, Draws


# ---- BERT -------------------------------------------------------------------

def bert_tokenize(texts, max_len: int = 77, vocab_size: int = 30522) -> np.ndarray:
    out = np.zeros((len(texts), max_len), dtype=np.int64)
    for i, text in enumerate(texts):
        ids = [101]
        for wd in text.lower().split():
            h = 0
            for ch in wd.encode("utf-8"):
                h = (h * 131 + ch) % (vocab_size - 1000)
            ids.append(1000 + h)
        ids = ids[: max_len - 1] + [102]
        out[i, : len(ids)] = ids
    return out


class BertAttention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.d = heads, dim_head
        self.to_q = Linear(dim, heads * dim_head, bias=False)
        self.to_k = Linear(dim, heads * dim_head, bias=False)
        self.to_v = Linear(dim, heads * dim_head, bias=False)
        self.to_out = Linear(heads * dim_head, dim)

    def forward(self, x):
        b, t, _ = x.shape
        q, k, v = (p(x).reshape(b, t, self.heads, self.d).transpose(1, 2)
                   for p in (self.to_q, self.to_k, self.to_v))
        out = attention(q, k, v, self.d ** -0.5).transpose(1, 2).reshape(b, t, -1)
        return self.to_out(out)


class BertFF(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([nn.ModuleList([Linear(dim, dim * 4)]), nn.Identity(),
                                  Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0][0](x)))


class BERTEmbedder(nn.Module):
    def __init__(self, n_embed, n_layer, n_heads, dim_head, vocab_size, max_seq_len):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, n_embed)
        self.pos_emb = nn.Module()
        self.pos_emb.emb = nn.Embedding(max_seq_len, n_embed)
        self.attn_layers = nn.Module()
        layers = []
        for _ in range(n_layer):
            layers.append(nn.ModuleList([LayerNorm(n_embed),
                                         BertAttention(n_embed, n_heads, dim_head)]))
            layers.append(nn.ModuleList([LayerNorm(n_embed), BertFF(n_embed)]))
        self.attn_layers.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(n_embed)

    def forward(self, tokens):
        x = self.token_emb.weight.float()[tokens] + \
            self.pos_emb.emb.weight.float()[: tokens.shape[1]][None]
        for norm, block in self.attn_layers.layers:
            x = x + block(norm(x))
        return self.norm(x)


# ---- LDM UNet -----------------------------------------------------------------

class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, dim_head):
        super().__init__()
        self.heads, self.d = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, t, _ = x.shape
        q = self.to_q(x).reshape(b, t, self.heads, self.d).transpose(1, 2)
        k = self.to_k(context).reshape(b, -1, self.heads, self.d).transpose(1, 2)
        v = self.to_v(context).reshape(b, -1, self.heads, self.d).transpose(1, 2)
        out = attention(q, k, v, self.d ** -0.5).transpose(1, 2).reshape(b, t, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim) for _ in range(3))

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels, heads, depth, context_dim):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, channels // heads, context_dim)
            for _ in range(depth))
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_up2(x))


class LDMUNet(nn.Module):
    def __init__(self, in_channels, out_channels, model_channels, num_res_blocks,
                 attention_ds, channel_mult, num_heads, transformer_depth, context_dim):
        super().__init__()
        mc = self.mc = model_channels
        tdim = mc * 4
        self.time_embed = nn.ModuleList([Linear(mc, tdim), nn.SiLU(), Linear(tdim, tdim)])

        def res(a, b):
            return ResBlock(a, tdim, b, scale_shift=False)

        def attn(ch):
            return SpatialTransformer(ch, num_heads, transformer_depth, context_dim)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, 3,
                                                                 padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                ds *= 2
                chans.append(ch)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attention_ds:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([GroupNorm32(ch), nn.SiLU(),
                                  Conv2d(ch, out_channels, 3, padding=1)])

    @staticmethod
    def _run(layer, h, emb, ctx):
        if isinstance(layer, ResBlock):
            return layer(h, emb)
        if isinstance(layer, SpatialTransformer):
            return layer(h, ctx)
        return layer(h)

    def forward(self, x, t, context):
        emb = self.time_embed[2](F.silu(self.time_embed[0](timestep_embedding(t, self.mc))))
        h = x.float().permute(0, 3, 1, 2)
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
        return self.out[2](F.silu(self.out[0](h))).permute(0, 2, 3, 1)


# ---- VQ-f8 decoder ------------------------------------------------------------

class AEResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm32(cin, eps=1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm32(cout, eps=1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AEAttnBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = attention(q, k, v, c ** -0.5).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Resample(nn.Module):
    def __init__(self, ch, down):
        super().__init__()
        self.down = down
        self.conv = Conv2d(ch, ch, 3, stride=2 if down else 1, padding=0 if down else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1))) if self.down else self.conv(nearest_up2(x))


def _level(blocks, attns, resample=None):
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(blocks), nn.ModuleList(attns)
    if resample is not None:
        level.add_module("downsample" if resample.down else "upsample", resample)
    return level


def _mid(ch):
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = AEResnetBlock(ch, ch), AEAttnBlock(ch), \
        AEResnetBlock(ch, ch)
    return mid


def _run_level(level, h):
    for i, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[i](h)
    return h


class Encoder(nn.Module):
    """Present for the checkpoint's layout; the txt2img request never runs it."""

    def __init__(self, c):
        super().__init__()
        self.conv_in = Conv2d(3, c["ch"], 3, padding=1)
        self.down = nn.ModuleList()
        res, ch = c["resolution"], c["ch"]
        for level, mult in enumerate(c["ch_mult"]):
            blocks, attns = [], []
            for _ in range(c["num_res_blocks"]):
                blocks.append(AEResnetBlock(ch, c["ch"] * mult))
                ch = c["ch"] * mult
                if res in c["attn_resolutions"]:
                    attns.append(AEAttnBlock(ch))
            resample = None
            if level != len(c["ch_mult"]) - 1:
                resample, res = _Resample(ch, True), res // 2
            self.down.append(_level(blocks, attns, resample))
        self.mid = _mid(ch)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv2d(ch, c["z_channels"], 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        ch = c["ch"] * c["ch_mult"][-1]
        self.conv_in = Conv2d(c["z_channels"], ch, 3, padding=1)
        self.mid = _mid(ch)
        res = c["resolution"] // 2 ** (len(c["ch_mult"]) - 1)
        levels = []
        for level in reversed(range(len(c["ch_mult"]))):
            blocks, attns = [], []
            for _ in range(c["num_res_blocks"] + 1):
                blocks.append(AEResnetBlock(ch, c["ch"] * c["ch_mult"][level]))
                ch = c["ch"] * c["ch_mult"][level]
                if res in c["attn_resolutions"]:
                    attns.append(AEAttnBlock(ch))
            resample = None
            if level != 0:
                resample, res = _Resample(ch, False), res * 2
            levels.insert(0, _level(blocks, attns, resample))
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv2d(ch, c["out_ch"], 3, padding=1)

    def forward(self, z):
        mid = self.mid
        h = mid.block_2(mid.attn_1(mid.block_1(self.conv_in(z))))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VQModel(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.encoder, self.decoder = Encoder(c), Decoder(c)
        self.quant_conv = Conv2d(c["z_channels"], c["embed_dim"], 1)
        self.post_quant_conv = Conv2d(c["embed_dim"], c["z_channels"], 1)
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Embedding(c["n_embed"], c["embed_dim"])

    def decode(self, z):
        """NHWC latents -> NHWC pixels in [-1, 1], quantised to the
        nearest codebook row first."""
        flat = z.reshape(-1, z.shape[-1]).float()
        cb = self.quantize.embedding.weight.float()
        d = flat.pow(2).sum(1, keepdim=True) - 2 * flat @ cb.T + cb.pow(2).sum(1)[None]
        zq = cb[d.argmin(1)].reshape(z.shape)
        return self.decoder(self.post_quant_conv(zq.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


# ---- RRDBNet ------------------------------------------------------------------

def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, nf, gc):
        super().__init__()
        self.conv1 = Conv2d(nf, gc, 3, padding=1)
        self.conv2 = Conv2d(nf + gc, gc, 3, padding=1)
        self.conv3 = Conv2d(nf + 2 * gc, gc, 3, padding=1)
        self.conv4 = Conv2d(nf + 3 * gc, gc, 3, padding=1)
        self.conv5 = Conv2d(nf + 4 * gc, nf, 3, padding=1)

    def forward(self, x):
        c1 = _lrelu(self.conv1(x))
        c2 = _lrelu(self.conv2(torch.cat([x, c1], 1)))
        c3 = _lrelu(self.conv3(torch.cat([x, c1, c2], 1)))
        c4 = _lrelu(self.conv4(torch.cat([x, c1, c2, c3], 1)))
        return x + 0.2 * self.conv5(torch.cat([x, c1, c2, c3, c4], 1))


class RRDB(nn.Module):
    def __init__(self, nf, gc):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = (ResidualDenseBlock(nf, gc) for _ in range(3))

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """x4: NHWC [0, 1] -> NHWC at four times the size, clamped to [0, 1]."""

    def __init__(self, num_feat=64, num_block=23, num_grow_ch=32, num_out_ch=3):
        super().__init__()
        self.conv_first = Conv2d(3, num_feat, 3, padding=1)
        self.body = nn.ModuleList(RRDB(num_feat, num_grow_ch) for _ in range(num_block))
        self.conv_body = Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up1 = Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up2 = Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_hr = Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_last = Conv2d(num_feat, num_out_ch, 3, padding=1)

    def forward(self, x):
        feat = self.conv_first(x.float().permute(0, 3, 1, 2))
        body = feat
        for block in self.body:
            body = block(body)
        feat = feat + self.conv_body(body)
        feat = _lrelu(self.conv_up1(nearest_up2(feat)))
        feat = _lrelu(self.conv_up2(nearest_up2(feat)))
        out = self.conv_last(_lrelu(self.conv_hr(feat)))
        return torch.clamp(out.permute(0, 2, 3, 1), 0.0, 1.0)


# ---- the sampler -------------------------------------------------------------

def iteration_seed(seed: int, iteration: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1)[0])


def ddim_tables(steps: int):
    """CompVis DDIMSampler's uniform schedule: (timesteps, alphas,
    alphas_prev) per sampler index, from the linear-in-sqrt betas."""
    ts = np.arange(steps) * (1000 // steps) + 1
    betas = np.linspace(math.sqrt(0.00085), math.sqrt(0.012), 1000, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    return ts, acp[ts], np.concatenate([[acp[0]], acp[ts][:-1]])


def cfg_step(unet, x, i: int, tables, ctx, scale: float):
    """One eta-0 DDIM step at sampler index i with classifier-free guidance.
    `ctx` is (2B, S, D), unconditional and conditional rows interleaved
    (u0, c0, u1, c1, ...), and the UNet sees x likewise twice."""
    ts, alphas, alphas_prev = tables
    b = x.shape[0]
    a = torch.tensor(np.float32(alphas[i]), device=x.device)
    a_prev = torch.tensor(np.float32(alphas_prev[i]), device=x.device)
    x2 = torch.stack([x, x], dim=1).reshape((2 * b,) + tuple(x.shape[1:]))
    t = torch.full((2 * b,), float(ts[i]), device=x.device)
    eps2 = unet(x2, t, ctx).reshape((b, 2) + tuple(x.shape[1:]))
    eps = eps2[:, 0] + scale * (eps2[:, 1] - eps2[:, 0])
    pred = (x - torch.sqrt(1 - a) * eps) / torch.sqrt(a)
    return torch.sqrt(a_prev) * pred + torch.sqrt(1.0 - a_prev) * eps


def interleave(u, c):
    return torch.stack([u, c], dim=1).reshape((2 * u.shape[0],) + tuple(u.shape[1:]))


def initial_noise(seed: int, iteration: int, shape, device):
    """The iteration's starting latents, per row from the keyed draws."""
    return Draws(iteration_seed(seed, iteration), device).normal(shape, _INIT)


__all__ = ["BERTEmbedder", "LDMUNet", "VQModel", "RRDBNet", "bert_tokenize", "ddim_tables",
           "cfg_step", "interleave", "initial_noise"]
