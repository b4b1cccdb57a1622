"""Latent-diffusion UNet (cross-attention conditioned) in PyTorch.

Counterpart of `clip_diffusion_tpu.models.ldm.unet`: CompVis LDM
txt2img-f8-large's UNet (model_channels 320, channel mult (1,2,4,4), 2 res
blocks, a SpatialTransformer of depth 1 with 8 heads and context dim 1280
at downsample factors {1,2,4}) over 4-channel f8 latents, about 872M
parameters.  The same module builds Stable Diffusion XL base 1.0's UNet
(`LDMUNetConfig.sdxl()`, sgm's `sd_xl_base.yaml`, about 2.57B
parameters; the JAX package has no counterpart): a transformer depth per
level (the middle block takes the last level's), heads of a fixed width
(`num_head_channels`), linear `proj_in`/`proj_out` over the tokens, and a
label embedding of a conditioning vector `y` added to the time embedding
(`label_emb.0.0`, SiLU, `label_emb.0.2`).

The ADM building blocks (`ResBlock` without scale-shift norm, `Downsample`
and `Upsample` with convs, `GroupNorm32`, `timestep_embedding`) come from
`models/unet.py`.  The boundary keeps the JAX layout: `LDMUNet(x, t,
context)` takes NHWC latents, (B,) timesteps and (B, S, D) context and
returns NHWC float32 (SDXL also takes the (B, adm_in_channels) vector
`y`).  State-dict keys follow the CompVis checkpoint
(`input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight`, ...).
Numerics kept from the JAX package:

* convs and linears compute in `config.dtype` (bfloat16 at full width);
* GroupNorm eps 1e-5 in the ResBlocks and the output head, 1e-6 in the
  SpatialTransformer's `norm`; LayerNorms in float32, cast back;
* cross-attention logits in the compute dtype, divided by sqrt(dim_head)
  rounded to that dtype (6.3125, 8.9375 and 12.625 in bfloat16 for the
  full model's 40, 80 and 160; 8 for SDXL's 64), softmax in float32 cast
  back, all in the one function `attention`, whose `attention.calls`
  counts its calls (a replayed graph adds the calls its capture made).
  That body is the plain version: on bfloat16 CUDA tensors `attention`
  launches the fused kernel of `csrc/ldm_attention.cu` instead, which
  keeps the logits in float32 and divides by the same bf16 scale
  (`attention.kernel_launches` counts its launches);
* GEGLU's gate through the exact (erf) GELU in float32.

Nothing on the latent path takes a gradient, so there is no remat.

On CUDA inputs with grad mode off (`torch.no_grad`, `torch.inference_mode`)
`LDMUNet.forward` replays the forward from a captured CUDA graph: about a
thousand small launches at the latent shapes cost the host more than the
device's work, and the graph enqueues them in one call.  Hooks still run
once per call around the replay.  A graph is captured per input shapes,
dtypes and device on its first call (two warm-up forwards on a side
stream, then the capture); at most `GRAPHS_PER_MODULE` are kept, the
least recently used dropped first, all in one memory pool of the module.
One caller at a time per module: the replay reads the module's static
input buffers.  The capture's own forwards leave `attention.calls` and
`attention.kernel_launches` as they were; each replay adds those of one
forward.  The forward must stay capturable: no host syncs and no
host-to-device copies in `_forward`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional, Tuple, Union

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
from clip_diffusion_tpu_torch.ops.attention import fused_attention
from clip_diffusion_tpu_torch.utils.profiling import annotate

GRAPHS_PER_MODULE = 4  # captured input shapes an LDMUNet keeps


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (1, 2, 4)  # attention_resolutions [4,2,1]
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: Union[int, Tuple[int, ...]] = 1  # one for all levels, or one a level
    context_dim: int = 1280
    dtype: torch.dtype = torch.bfloat16
    num_head_channels: int = -1  # > 0: heads = channels // this, in place of num_heads
    use_linear_in_transformer: bool = False  # proj_in/proj_out as Linear over the tokens
    adm_in_channels: Optional[int] = None  # width of the vector y; None: no label embedding

    @staticmethod
    def tiny() -> "LDMUNetConfig":
        return LDMUNetConfig(model_channels=32, channel_mult=(1, 2), attention_ds=(1, 2),
                             num_heads=2, context_dim=16, dtype=torch.float32)

    @staticmethod
    def sdxl() -> "LDMUNetConfig":
        """SDXL base 1.0 (sgm `sd_xl_base.yaml`): attention_resolutions
        [4, 2], transformer_depth [1, 2, 10], 64-wide heads, context 2048
        (CLIP ViT-L/14 768 + OpenCLIP ViT-bigG/14 1280), vector 2816."""
        return LDMUNetConfig(model_channels=320, channel_mult=(1, 2, 4), attention_ds=(2, 4),
                             num_heads=-1, num_head_channels=64, transformer_depth=(1, 2, 10),
                             context_dim=2048, use_linear_in_transformer=True,
                             adm_in_channels=2816)

    def depth(self, level: int) -> int:
        """Transformer blocks of a SpatialTransformer at `level`; the middle
        block takes the last level's."""
        d = self.transformer_depth
        return d if isinstance(d, int) else d[level]

    def heads(self, channels: int) -> int:
        return channels // self.num_head_channels if self.num_head_channels > 0 else self.num_heads


def attention(q, k, v, scale: float, dtype):
    """softmax(q k^T / scale) v over (b, h, t, d) heads, `scale` sqrt(d)
    rounded to the compute dtype.  On bfloat16 CUDA tensors one launch of
    the fused kernel (`ops.attention.fused_attention`: float32 logits,
    softmax and sums, bf16 output; a shape it does not take raises);
    otherwise `attention_plain`.  Every call adds one to `attention.calls`,
    every launch one to `attention.kernel_launches`."""
    attention.calls += 1
    if q.is_cuda and q.dtype == torch.bfloat16:
        out = fused_attention(q, k, v, scale)
        attention.kernel_launches += 1
        return out
    return attention_plain(q, k, v, scale, dtype)


def attention_plain(q, k, v, scale: float, dtype):
    """`attention`'s plain version, on any device: the logits in the
    compute dtype divided by `scale`, the softmax in float32 cast back to
    `dtype`, then the product with v."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / scale  # (b, h, t, s)
    attn = torch.softmax(logits.to(torch.float32), dim=-1).to(dtype)
    return torch.matmul(attn, v)


attention.calls = 0  # calls of every LDM UNet, replays included, for run reports
attention.kernel_launches = 0  # fused kernel launches, replays included


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
        out = attention(q, k, v, self.scale, self.dtype).transpose(1, 2).reshape(b, t, h * d)
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
    """GroupNorm, projection in, transformer blocks over the (h, w) tokens
    in row-major order, projection out, residual.  The projections are 1x1
    convs, or with `linear` Linear layers over the tokens (sgm's
    `use_linear`)."""

    def __init__(self, channels: int, heads: int, depth: int, context_dim: int,
                 dtype=torch.float32, linear: bool = False):
        super().__init__()
        self.linear = linear
        proj = ((lambda: Linear(channels, channels, dtype=dtype)) if linear else
                (lambda: Conv2d(channels, channels, 1, dtype=dtype)))
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads, context_dim, dtype)
            for _ in range(depth)
        ])
        self.proj_out = proj()

    def forward(self, x, context):
        b, c, h, w = x.shape
        if self.linear:
            y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))  # (b, hw, c)
        else:
            y = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.linear:
            return x + self.proj_out(y).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))


def _drop_graphs(unet, _incompatible_keys=None):
    unet._graphs.clear()
    unet._graph_pool = None


class LDMUNet(nn.Module):
    """eps-model over latents: (x NHWC, t (B,), context (B, S, D)[, y (B,
    adm_in_channels)]) -> NHWC float32, replayed from a CUDA graph on the
    card without grad (see the module docstring); `_forward` is the eager
    forward."""

    def __init__(self, config: LDMUNetConfig):
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed = nn.ModuleList([
            Linear(mc, time_dim, dtype=dt), nn.SiLU(), Linear(time_dim, time_dim, dtype=dt),
        ])
        if cfg.adm_in_channels is not None:  # sgm's nn.Sequential(nn.Sequential(...))
            self.label_emb = nn.ModuleList([nn.ModuleList([
                Linear(cfg.adm_in_channels, time_dim, dtype=dt), nn.SiLU(),
                Linear(time_dim, time_dim, dtype=dt),
            ])])

        def res(ch_in, ch_out):
            return ResBlock(ch_in, time_dim, ch_out, use_scale_shift_norm=False, dtype=dt)

        def attn(ch, level):
            return SpatialTransformer(ch, cfg.heads(ch), cfg.depth(level), cfg.context_dim, dt,
                                      cfg.use_linear_in_transformer)

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
                    layers.append(attn(ch, level))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, dt)]))
                ds *= 2
                chans.append(ch)

        last = len(cfg.channel_mult) - 1
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch, last), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_ds:
                    layers.append(attn(ch, level))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, dt))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.ModuleList([
            GroupNorm32(ch), nn.SiLU(), Conv2d(ch, cfg.out_channels, 3, padding=1, dtype=dt),
        ])

        # input key -> (graph, static inputs, static output), least recently used first
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._graph_pool = None  # (memory pool, side stream) that every capture shares
        # a graph reads the parameters' storage as captured: loading with
        # assign=True or `.to()` moves it, so both drop the graphs and their pool
        self.register_load_state_dict_post_hook(_drop_graphs)

    def _apply(self, fn, *args, **kwargs):
        _drop_graphs(self)
        return super()._apply(fn, *args, **kwargs)

    @staticmethod
    def _run(layer, h, emb, context):
        if isinstance(layer, ResBlock):
            return layer(h, emb)
        if isinstance(layer, SpatialTransformer):
            return layer(h, context)
        return layer(h)

    def forward(self, x, timesteps, context, y=None):
        args = (x, timesteps, context) if y is None else (x, timesteps, context, y)
        if torch.is_grad_enabled() or not all(a.is_cuda for a in args):
            return self._forward(*args)
        key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        if key in self._graphs:
            self._graphs.move_to_end(key)
        else:
            self._graphs[key] = self._capture(args)
            if len(self._graphs) > GRAPHS_PER_MODULE:
                self._graphs.popitem(last=False)
        graph, inputs, out, (calls, launches) = self._graphs[key]
        for buf, a in zip(inputs, args):
            buf.copy_(a)
        with annotate("ldm.unet.replay"):
            graph.replay()
        attention.calls += calls
        attention.kernel_launches += launches
        # the static output is overwritten by the next replay
        return out.clone()

    def _capture(self, args):
        """A CUDA graph of `_forward` on static copies of `args` -> (graph,
        static inputs, static output, (attention calls, kernel launches) of
        one forward).  Outside inference mode, so that the buffers also take
        inputs under plain `no_grad`.  `attention.calls` and
        `attention.kernel_launches` read after as before."""
        device = args[0].device
        counts_before = attention.calls, attention.kernel_launches
        with torch.cuda.device(device), torch.inference_mode(False), torch.no_grad():
            inputs = tuple(torch.empty_like(a, memory_format=torch.contiguous_format).copy_(a)
                           for a in args)
            if self._graph_pool is None:
                self._graph_pool = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
            pool, stream = self._graph_pool
            # cuDNN and cuBLAS pick algorithms and workspaces before the capture
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(2):
                    self._forward(*inputs)
            torch.cuda.current_stream(device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            calls, launches = attention.calls, attention.kernel_launches
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = self._forward(*inputs)
        counts = attention.calls - calls, attention.kernel_launches - launches
        attention.calls, attention.kernel_launches = counts_before
        return graph, inputs, out, counts

    def _forward(self, x, timesteps, context, y=None):
        cfg = self.config
        emb = timestep_embedding(timesteps, cfg.model_channels)
        emb = self.time_embed[0](emb.to(cfg.dtype))
        emb = self.time_embed[2](F.silu(emb))
        if cfg.adm_in_channels is not None:
            label = self.label_emb[0]
            emb = emb + label[2](F.silu(label[0](y.to(cfg.dtype))))
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
