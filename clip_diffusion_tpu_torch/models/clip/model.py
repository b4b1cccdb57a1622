"""OpenAI-CLIP towers in PyTorch.

Counterpart of `clip_diffusion_tpu.models.clip.model`: the ViT perceptors
(ViT-B/32, ViT-B/16, ViT-L/14), the ModifiedResNet perceptors (RN50,
RN101) and the text tower.  ViT and text: packed
[q; k; v] `in_proj`, QuickGELU MLPs, pre-LN blocks, float32 LayerNorm
(eps 1e-5), attention logits in the compute dtype scaled by multiplying
with 1/sqrt(d), float32 softmax, and EOT pooling at argmax(tokens).
Parameter names follow the OpenAI checkpoints (`visual.conv1.weight`,
`transformer.resblocks.0.attn.in_proj_weight`, ...); the patch embedding is
a stride-p conv whose (width, c, p, p) weight is the JAX (p, p, c, width)
kernel transposed.  Image inputs are CLIP-normalized NHWC; apply
`clip_normalize` to [0, 1] images first.

Text towers alone (`CLIPTextModel`, no vision tower built), as Stable
Diffusion XL conditions on them: OpenAI CLIP ViT-L/14's (QuickGELU) and
OpenCLIP ViT-bigG/14's (exact GELU, `CLIP_TEXT_PRESETS`), each giving the
hidden state after a chosen number of blocks without `ln_final`, and
beside it the pooled output (`ln_final` of the last block at the EOT
token, times `text_projection`).  The keys are the OpenAI checkpoints' text
keys; OpenCLIP's are the same.

ModifiedResNet: the 3-conv stem with a 2x2 average pool, bottlenecks whose
downsampling is an average pool before a stride-1 conv, and an attention
pool (mean token prepended, separate q/k/v projections, query from token 0
only).  As in the JAX package, each conv runs in the compute dtype while
every BatchNorm output, ReLU, average pool and residual sum is float32 (the
next conv casts back), and the attention pool takes its logits in float32.
BatchNorm is the eval form on running statistics (eps 1e-5), holding
`weight`, `bias`, `running_mean` and `running_var` and nothing else.
Names follow the OpenAI checkpoints (`visual.layer1.0.downsample.0.weight`,
`visual.attnpool.q_proj.weight`, ...).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_diffusion_tpu_torch.models.clip.tokenizer import CONTEXT_LENGTH, VOCAB_SIZE
from clip_diffusion_tpu_torch.models.unet import Linear

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC -> CLIP-normalized."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images01.dtype, device=images01.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images01.dtype, device=images01.device)
    return (images01 - mean) / std


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    image_resolution: int
    # vision: ViT if vision_patch_size is set, else ModifiedResNet
    vision_layers: Tuple[int, ...] | int
    vision_width: int
    vision_patch_size: Optional[int]
    vision_heads: int
    context_length: int = CONTEXT_LENGTH
    vocab_size: int = VOCAB_SIZE
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    dtype: torch.dtype = torch.float32

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size is not None


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """A text tower alone.  `act` is "quick_gelu" (OpenAI CLIP) or "gelu"
    (OpenCLIP, exact); `embed_dim` is the width of `text_projection`, 0
    for a tower built without it (SDXL's CLIP ViT-L/14, whose pooled
    output nothing reads)."""

    width: int
    heads: int
    layers: int
    embed_dim: int = 0
    act: str = "quick_gelu"
    context_length: int = CONTEXT_LENGTH
    vocab_size: int = VOCAB_SIZE
    dtype: torch.dtype = torch.float32


CLIP_PRESETS = {
    "ViT-B/32": CLIPConfig("ViT-B/32", 512, 224, 12, 768, 32, 12),
    "ViT-B/16": CLIPConfig("ViT-B/16", 512, 224, 12, 768, 16, 12),
    "ViT-L/14": CLIPConfig(
        "ViT-L/14", 768, 224, 24, 1024, 14, 16,
        text_width=768, text_heads=12, text_layers=12,
    ),
    "RN50": CLIPConfig("RN50", 1024, 224, (3, 4, 6, 3), 64, None, 32),
    "RN101": CLIPConfig("RN101", 512, 224, (3, 4, 23, 3), 64, None, 32),
}


CLIP_TEXT_PRESETS = {
    "ViT-L/14": CLIPTextConfig(768, 12, 12, 768),
    # OpenCLIP ViT-bigG-14 (laion2b_s39b_b160k): width 1280, 20 heads, 32 layers
    "ViT-bigG/14": CLIPTextConfig(1280, 20, 32, 1280, act="gelu"),
}


def tiny_clip_config(name: str = "tiny", resnet: bool = False) -> CLIPConfig:
    """Small config with the same topology, for tests."""
    if resnet:
        return CLIPConfig(
            name, 64, 64, (1, 1, 1, 1), 8, None, 4,
            text_width=32, text_heads=2, text_layers=2,
        )
    return CLIPConfig(
        name, 64, 32, 2, 64, 16, 4, text_width=32, text_heads=2, text_layers=2
    )


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in float32, returned in the input dtype."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-5)

    def forward(self, x):
        out = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                           self.weight.to(torch.float32),
                           self.bias.to(torch.float32), self.eps)
        return out.to(x.dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention layout: packed in_proj + out_proj."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        d = width // heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width, dtype=dtype)
        # 1/sqrt(d) rounded to the compute dtype; logits are multiplied by it
        self.scale = torch.tensor(d ** -0.5, dtype=dtype, device="cpu").item()

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        d = self.width // self.heads
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (u.reshape(b, t, self.heads, d).transpose(1, 2)
                   for u in torch.chunk(qkv, 3, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        attn = torch.softmax(logits.to(torch.float32), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, self.width)
        return self.out_proj(out)


# the MLP's activation: OpenAI CLIP's QuickGELU, or OpenCLIP's exact (erf) GELU
ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class MLP(nn.Module):
    def __init__(self, width: int, dtype=torch.float32, act: str = "quick_gelu"):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.c_fc = Linear(width, 4 * width, dtype=dtype)
        self.c_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32, act: str = "quick_gelu"):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, dtype)
        self.ln_1 = LayerNormF32(width)
        self.mlp = MLP(width, dtype, act)
        self.ln_2 = LayerNormF32(width)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32,
                 act: str = "quick_gelu"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, act) for _ in range(layers)
        )

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.vision_patch_size
        n_patches = (cfg.image_resolution // p) ** 2
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(n_patches + 1, w))
        self.ln_pre = LayerNormF32(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads, cfg.dtype)
        self.ln_post = LayerNormF32(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images):
        dt = self.cfg.dtype
        x = images.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.conv2d(x, self.conv1.weight.to(dt), stride=self.conv1.stride)
        x = x.flatten(2).transpose(1, 2)  # (b, gh*gw, w), row-major patches
        b = x.shape[0]
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(dt)


class FrozenBatchNorm2d(nn.Module):
    """Eval-mode BatchNorm over NCHW on running statistics, returned in
    float32: (x - mean) * (rsqrt(var + eps) * weight) + bias, evaluated in
    the promoted dtype of x and the statistics, as flax's BatchNorm does."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        mean = self.running_mean.reshape(shape)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x - mean) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(torch.float32)


def _conv(x, conv: nn.Conv2d, dt):
    return F.conv2d(x.to(dt), conv.weight.to(dt), stride=conv.stride, padding=conv.padding)


def _avg_pool(x, stride: int):
    return x if stride == 1 else F.avg_pool2d(x, stride, stride)


class Bottleneck(nn.Module):
    """Expansion-4 bottleneck; downsampling is an average pool before the
    stride-1 conv3, and before the 1x1 downsample conv of the identity."""

    def __init__(self, inplanes: int, planes: int, stride: int, dtype):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.ModuleDict({
                "0": nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                "1": FrozenBatchNorm2d(planes * 4),
            })

    def forward(self, x):
        dt = self.dtype
        out = F.relu(self.bn1(_conv(x, self.conv1, dt)))
        out = F.relu(self.bn2(_conv(out, self.conv2, dt)))
        out = self.bn3(_conv(_avg_pool(out, self.stride), self.conv3, dt))
        identity = x
        if self.downsample is not None:
            identity = _conv(_avg_pool(x, self.stride), self.downsample["0"], dt)
            identity = self.downsample["1"](identity)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Attention pooling of the final feature map: the mean token is
    prepended, the query comes from token 0 only, float32 logits."""

    def __init__(self, spacial_dim: int, embed_dim: int, heads: int,
                 output_dim: int, dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim**2 + 1, embed_dim))
        self.q_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.c_proj = Linear(embed_dim, output_dim, dtype=dtype)

    def forward(self, x):
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # NCHW -> (b, h*w, c), row-major
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        d = c // self.heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, self.heads, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, -1, self.heads, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, -1, self.heads, d).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d**0.5)
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, 1, c)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.vision_width
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width)
        inplanes = width
        for li, blocks in enumerate(cfg.vision_layers):
            planes = width * 2**li
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if li > 0 and bi == 0 else 1,
                                        cfg.dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, width * 32,
                                        width * 32 // 64, cfg.embed_dim, cfg.dtype)

    def forward(self, images):
        dt = self.cfg.dtype
        x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.bn1(_conv(x, self.conv1, dt)))
        x = F.relu(self.bn2(_conv(x, self.conv2, dt)))
        x = F.relu(self.bn3(_conv(x, self.conv3, dt)))
        x = _avg_pool(x, 2)
        for li in range(len(self.cfg.vision_layers)):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.attnpool(x)


def _drop_graphs(model, _incompatible_keys=None):
    model._graphs.clear()


class CLIPModel(nn.Module):
    """Both towers: `encode_image` and `encode_text`.  `_graphs` holds the
    guided pipeline's CUDA graphs of this tower's chunks
    (`pipeline/guided._cut_gradient`)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg) if cfg.is_vit else ModifiedResNet(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads, cfg.dtype)
        self.ln_final = LayerNormF32(cfg.text_width)
        self.text_projection = nn.Parameter(torch.empty(cfg.text_width, cfg.embed_dim))
        # chunk key -> captured graph (or None: that key runs eagerly), least
        # recently used first; a graph reads the parameters' storage as
        # captured: loading with assign=True or `.to()` moves it, so both drop them
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.register_load_state_dict_post_hook(_drop_graphs)

    def _apply(self, fn, *args, **kwargs):
        _drop_graphs(self)
        return super()._apply(fn, *args, **kwargs)

    def encode_image(self, images):
        """CLIP-normalized NHWC images -> (B, embed_dim) float32."""
        return self.visual(images).to(torch.float32)

    def encode_text(self, tokens):
        """(B, 77) int token ids -> (B, embed_dim) float32, EOT-pooled."""
        _, pooled = _text_forward(self, self.cfg.dtype, tokens, None)
        return pooled


def _text_forward(tower, dt, tokens, hidden_layer: Optional[int]):
    """The causal text transformer of `tower` (a `CLIPModel` or a
    `CLIPTextModel`) -> (hidden state after `hidden_layer` blocks without
    `ln_final`, in `dt`; the pooled projection (B, embed_dim) float32).
    `hidden_layer` None: no hidden state, every block runs.  Without a
    `text_projection` the pooled output is None and only the blocks the
    hidden state needs run."""
    x = tower.token_embedding(tokens).to(dt)
    x = x + tower.positional_embedding.to(dt)
    t = tokens.shape[1]
    mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    pool = tower.text_projection is not None
    blocks = tower.transformer.resblocks
    hidden = None
    for i, block in enumerate(blocks if pool else blocks[:hidden_layer]):
        if i == hidden_layer:
            hidden = x
        x = block(x, mask)
    if hidden_layer is not None and hidden is None:  # after the last block run
        hidden = x
    if not pool:
        return hidden, None
    x = tower.ln_final(x)
    eot = torch.argmax(tokens, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return hidden, (pooled @ tower.text_projection.to(pooled.dtype)).to(torch.float32)


class CLIPTextModel(nn.Module):
    """The text tower alone: `encode(tokens, hidden_layer)` -> (hidden
    state after `hidden_layer` blocks, without `ln_final`, in the compute
    dtype; the pooled projection (B, embed_dim) float32, or None without
    `text_projection`)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads, cfg.dtype, cfg.act)
        self.ln_final = LayerNormF32(cfg.width)
        self.text_projection = (nn.Parameter(torch.empty(cfg.width, cfg.embed_dim))
                                if cfg.embed_dim else None)

    def encode(self, tokens, hidden_layer: int):
        return _text_forward(self, self.cfg.dtype, tokens, hidden_layer)
