"""Stable Diffusion XL base 1.0 in plain float32 PyTorch.

Stability-AI generative-models (sgm), `configs/inference/sd_xl_base.yaml`:

* the conditioner: OpenAI CLIP ViT-L/14's text tower (QuickGELU), its
  hidden state after 11 of 12 blocks without `ln_final` (Hugging Face's
  `hidden_states[11]`, tokens padded with EOT as its tokenizer pads), and
  OpenCLIP ViT-bigG/14's (width 1280, 20 heads, 32 blocks, exact GELU,
  zero-padded tokens), its hidden state after 31 of 32 blocks without
  `ln_final` ("penultimate", `legacy: False`) and its pooled output,
  `ln_final` of the last block at the EOT token times `text_projection`;
  the context [CLIP-L 768 | bigG 1280], the vector [pooled 1280 |
  original_size | crop_coords_top_left | target_size], each size number a
  256-wide sinusoidal embedding (cos, sin; sgm's
  `ConcatTimestepEmbedderND`);
* the UNet (`openaimodel.UNetModel`): ResBlocks without scale-shift norm,
  SpatialTransformers with linear `proj_in`/`proj_out`, a depth per level
  (the middle block takes the last level's), 64-wide heads, GEGLU
  feed-forward, the label embedding Linear, SiLU, Linear of the vector
  added to the time embedding; eps prediction;
* the first stage (`AutoencoderKL`): taming's encoder and decoder with
  attention in the mid blocks only, `double_z`, `quant_conv` 8 -> 8,
  `post_quant_conv` 4 -> 4, latents divided by `scale_factor` 0.13025
  before the decode;
* DDIM at eta 0 on the LDM schedule (uniform timesteps i * (1000 // S) + 1)
  with classifier-free guidance, unconditional and conditional rows
  interleaved.

NHWC at the boundaries.  Attention is computed a block of queries at a
time (`QUERY_BLOCK`), so that the UNet's 4,096-token and the decoder's
16,384-token self-attentions fit: the same numbers as one softmax over
all keys.

Departures from sgm, each deliberate:
* tokens come from the deterministic hash stand-in the program uses when
  no BPE table ships (`reference/clip.tokenize`), not from the BPE;
* the unconditional branch encodes "" through both towers with the same
  size conditioning; sgm's demo sampling and diffusers zero the text parts
  of the unconditional conditioning instead;
* the size embeddings' phases are computed in float64 (sgm: float32),
  as this reference's time embedding is;
* CLIP ViT-L/14 runs only the 11 blocks its hidden state needs (Hugging
  Face runs the twelfth and drops it);
* under the control's float8 (`layers.fp8`) a blocked attention scales
  each block's operands by that block's own maximum.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference import clip as rc
from port_bench.reference import latent as rl
from port_bench.reference.adm_unet import ResBlock
from port_bench.reference.layers import (
    Conv2d,
    GroupNorm32,
    LayerNorm,
    Linear,
    attention,
    matmul,
    timestep_embedding,
)

QUERY_BLOCK = 1024  # queries whose logits are formed at once


def blocked_attention(q_, k, v, scale: float):
    """softmax(q k^T * scale) v over (..., T, d) heads, `QUERY_BLOCK`
    queries at a time."""
    n = q_.shape[-2]
    return torch.cat([attention(q_[..., i:i + QUERY_BLOCK, :], k, v, scale)
                      for i in range(0, n, QUERY_BLOCK)], dim=-2)


# ---- the text towers and the conditioner ------------------------------------

class TextMLP(nn.Module):
    def __init__(self, width, act):
        super().__init__()
        self.act = act
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        h = self.c_fc(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.c_proj(h)


class TextBlock(nn.Module):
    def __init__(self, width, heads, act):
        super().__init__()
        self.attn = rc.MultiheadAttention(width, heads)
        self.ln_1 = LayerNorm(width)
        self.mlp = TextMLP(width, act)
        self.ln_2 = LayerNorm(width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class TextTower(nn.Module):
    """A CLIP text tower alone; `embed_dim` 0 builds no `text_projection`."""

    def __init__(self, width, heads, layers, embed_dim=0, act="quick_gelu",
                 context_length=rc.CONTEXT_LENGTH, vocab_size=rc.VOCAB_SIZE):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(TextBlock(width, heads, act)
                                                   for _ in range(layers))
        self.ln_final = LayerNorm(width)
        self.text_projection = (nn.Parameter(torch.empty(width, embed_dim)) if embed_dim
                                else None)

    def forward(self, tokens, hidden_layer: int):
        """-> (hidden state after `hidden_layer` blocks, pooled projection
        or None)."""
        x = self.token_embedding.weight.float()[tokens] + self.positional_embedding.float()
        t = tokens.shape[1]
        mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
        blocks = self.transformer.resblocks
        run = blocks if self.text_projection is not None else blocks[:hidden_layer]
        hidden = None
        for i, block in enumerate(run):
            if i == hidden_layer:
                hidden = x
            x = block(x, mask)
        hidden = x if hidden is None else hidden
        if self.text_projection is None:
            return hidden, None
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return hidden, matmul(pooled, self.text_projection)


def tokens_l(texts) -> np.ndarray:
    """CLIP ViT-L/14's ids: after the EOT the padding is EOT."""
    ids = rc.tokenize(texts)
    after = np.cumsum(ids == rc.EOT, axis=1) - (ids == rc.EOT) > 0
    return np.where(after, rc.EOT, ids)


def tokens_g(texts) -> np.ndarray:
    """OpenCLIP ViT-bigG/14's ids: zero padding."""
    return rc.tokenize(texts)


def conditioning(clip_l, clip_g, texts, cond: dict, device):
    """-> (context (N, 77, D_l + D_g), vector (N, D_g + 6 e)) of `texts`;
    `cond` is the configuration's "conditioning" group."""
    tl = torch.from_numpy(tokens_l(texts)).to(device)
    tg = torch.from_numpy(tokens_g(texts)).to(device)
    h_l, _ = clip_l(tl, cond["clip_l_layer"])
    h_g, pooled = clip_g(tg, cond["clip_g_layer"])
    sizes = torch.tensor([*cond["original_size"], *cond["crop_coords_top_left"],
                          *cond["target_size"]], dtype=torch.float32, device=device)
    emb = timestep_embedding(sizes, cond["size_embed_dim"]).reshape(1, -1)
    return torch.cat([h_l, h_g], -1), torch.cat([pooled, emb.expand(len(texts), -1)], -1)


# ---- the UNet ---------------------------------------------------------------

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
        out = blocked_attention(q, k, v, self.d ** -0.5).transpose(1, 2).reshape(b, t, -1)
        return self.to_out[0](out)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = rl.FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim) for _ in range(3))

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, Linear in over the (h, w) tokens, blocks, Linear out,
    residual (sgm's `use_linear`)."""

    def __init__(self, channels, heads, depth, context_dim):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, channels // heads, context_dim)
            for _ in range(depth))
        self.proj_out = Linear(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + self.proj_out(y).transpose(1, 2).reshape(b, c, h, w)


class SDXLUNet(nn.Module):
    """(x NHWC, t (B,), context (B, S, D), y (B, V)) -> eps NHWC.  Takes the
    configuration's "unet" group, whose `use_linear_in_transformer` is
    true: the projections are Linear (a program with 1x1 convs there
    would not load into this module)."""

    def __init__(self, in_channels, out_channels, model_channels, num_res_blocks, attention_ds,
                 channel_mult, num_head_channels, transformer_depth, context_dim,
                 adm_in_channels, use_linear_in_transformer=True):
        super().__init__()
        mc = self.mc = model_channels
        tdim = mc * 4
        self.time_embed = nn.ModuleList([Linear(mc, tdim), nn.SiLU(), Linear(tdim, tdim)])
        self.label_emb = nn.ModuleList([nn.ModuleList([Linear(adm_in_channels, tdim), nn.SiLU(),
                                                       Linear(tdim, tdim)])])

        def res(a, b):
            return ResBlock(a, tdim, b, scale_shift=False)

        def attn(ch, level):
            return SpatialTransformer(ch, ch // num_head_channels, transformer_depth[level],
                                      context_dim)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, 3,
                                                                 padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_ds:
                    layers.append(attn(ch, level))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([rl.Downsample(ch)]))
                ds *= 2
                chans.append(ch)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch, len(channel_mult) - 1),
                                           res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attention_ds:
                    layers.append(attn(ch, level))
                if level and i == num_res_blocks:
                    layers.append(rl.Upsample(ch))
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

    def forward(self, x, t, context, y):
        emb = self.time_embed[2](F.silu(self.time_embed[0](timestep_embedding(t, self.mc))))
        label = self.label_emb[0]
        emb = emb + label[2](F.silu(label[0](y)))
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


# ---- the KL-f8 first stage --------------------------------------------------

class AttnBlock(rl.AEAttnBlock):
    """The mid block's single-head attention, blocked over the queries."""

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = blocked_attention(q, k, v, c ** -0.5).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


def _blocked_mid(mid):
    ch = mid.attn_1.q.in_channels
    mid.attn_1 = AttnBlock(ch)


class KLModel(nn.Module):
    """Takes the configuration's "vae" group.  The txt2img request runs
    only `decode`; `encode` (the posterior mean times `scale_factor`) is
    for the tests."""

    def __init__(self, c):
        super().__init__()
        c = dict(c)
        self.scale_factor = c["scale_factor"]
        self.encoder = rl.Encoder(dict(c, z_channels=2 * c["z_channels"]))
        self.decoder = rl.Decoder(c)
        for part in (self.encoder, self.decoder):
            _blocked_mid(part.mid)
        self.quant_conv = Conv2d(2 * c["z_channels"], 2 * c["embed_dim"], 1)
        self.post_quant_conv = Conv2d(c["embed_dim"], c["z_channels"], 1)

    def encode(self, x):
        """NHWC pixels in [-1, 1] -> NHWC latents."""
        e = self.encoder
        h = e.conv_in(x.float().permute(0, 3, 1, 2))
        for level in e.down:
            h = rl._run_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = e.mid.block_2(e.mid.attn_1(e.mid.block_1(h)))
        moments = self.quant_conv(e.conv_out(F.silu(e.norm_out(h))))
        mean = moments[:, : moments.shape[1] // 2]
        return (mean * self.scale_factor).permute(0, 2, 3, 1)

    def decode(self, z):
        """NHWC latents -> NHWC pixels in [-1, 1]."""
        h = self.post_quant_conv((z.float() / self.scale_factor).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)


# ---- the sampler ------------------------------------------------------------

def cfg_step(unet, x, i: int, tables, ctx, vec, scale: float):
    """One eta-0 DDIM step at sampler index i with classifier-free guidance;
    `ctx` (2B, S, D) and `vec` (2B, V) hold unconditional and conditional
    rows interleaved (u0, c0, u1, c1, ...), and the UNet sees x likewise
    twice."""
    ts, alphas, alphas_prev = tables
    b = x.shape[0]
    a = torch.tensor(np.float32(alphas[i]), device=x.device)
    a_prev = torch.tensor(np.float32(alphas_prev[i]), device=x.device)
    t = torch.full((2 * b,), float(ts[i]), device=x.device)
    eps2 = unet(rl.interleave(x, x), t, ctx, vec).reshape((b, 2) + tuple(x.shape[1:]))
    eps = eps2[:, 0] + scale * (eps2[:, 1] - eps2[:, 0])
    pred = (x - torch.sqrt(1 - a) * eps) / torch.sqrt(a)
    return torch.sqrt(a_prev) * pred + torch.sqrt(1.0 - a_prev) * eps


ddim_tables = rl.ddim_tables
initial_noise = rl.initial_noise
interleave = rl.interleave

__all__ = ["TextTower", "SDXLUNet", "KLModel", "conditioning", "cfg_step", "ddim_tables",
           "initial_noise", "interleave", "tokens_l", "tokens_g", "blocked_attention"]
