"""The LDM UNet's fused softmax attention on the card.

`fused_attention(q, k, v, scale)` launches the hand-written kernel in
`csrc/ldm_attention.cu` (FlashAttention-2's forward: the logits, the
softmax and the second product in registers, only the output written).
Its plain version is `models/ldm/unet.attention_plain`; `attention` there
takes this path for bfloat16 CUDA tensors and the plain one for everything
else.

The kernel reads q, k and v through their strides, as the (b, h, t, d)
views of the projections' (b, t, h, d) buffers that `CrossAttention`
hands over, and writes a (b, t, h, d) buffer returned as its (b, h, t, d)
view, so the caller's transpose and reshape to (b, t, h * d) are views.
It takes every shape the LDM configurations send (heads of 40, 64, 80 and
160) and raises on any other; nothing falls back.  Forward only.

`LDM_SHAPES`, `projection_heads`, `attention_float32` and `errors` are
what the kernel's checks on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`) hold it to: every shape it serves, inputs laid out as
the UNet hands them over, and the float32 evaluation both paths are
measured against.
"""

from __future__ import annotations

import ctypes
import math
from typing import Set

import torch

HEAD_DIMS = (40, 64, 80, 160)  # the kernel's instances
_MAX_BLOCK_ROWS = 65535  # batch x heads: the grid's second dimension
_LIB = None  # the kernel's library, argtypes bound once
_READY: Set[int] = set()  # devices whose shared-memory limits are raised

# Every shape the two LDM configurations send `models/ldm/unet.attention`,
# at the latent requests' CFG batch of 6: (label, batch, heads, query
# tokens, key tokens, head dim, calls a UNet step).  SDXL's two levels and
# txt2img-f8-large's four, each self-attention and cross-attention over the
# 77-token context.
LDM_SHAPES = (
    ("sdxl level 1 self", 6, 10, 4096, 4096, 64, 10),
    ("sdxl level 1 cross", 6, 10, 4096, 77, 64, 10),
    ("sdxl level 2 self", 6, 20, 1024, 1024, 64, 60),
    ("sdxl level 2 cross", 6, 20, 1024, 77, 64, 60),
    ("latent ds1 self", 6, 8, 1024, 1024, 40, 5),
    ("latent ds1 cross", 6, 8, 1024, 77, 40, 5),
    ("latent ds2 self", 6, 8, 256, 256, 80, 5),
    ("latent ds2 cross", 6, 8, 256, 77, 80, 5),
    ("latent ds4 self", 6, 8, 64, 64, 160, 5),
    ("latent ds4 cross", 6, 8, 64, 77, 160, 5),
    ("latent middle self", 6, 8, 16, 16, 160, 1),
    ("latent middle cross", 6, 8, 16, 77, 160, 1),
)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes (q, k, v): bfloat16 (b, h, t, d) on
    one device, k and v of one shape, the batch and heads of q, a head dim
    with an instance (a multiple of 8 up to 256 could have one), the last
    dimension dense, every other stride a multiple of 8 elements and every
    pointer 16-byte aligned (the copies move 16 bytes)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused attention: {name} must be bfloat16, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"fused attention: {name} must be (b, h, t, d), got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"fused attention: {name} on {t.device}, q on {q.device}")
    b, h, t_q, d = q.shape
    if tuple(k.shape[:2]) != (b, h) or tuple(v.shape[:2]) != (b, h):
        raise ValueError(f"fused attention: batch and heads differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape != v.shape or k.shape[3] != d:
        raise ValueError(f"fused attention: k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match, with q's head dim {d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"fused attention: no kernel instance for head dim {d} "
                         f"(instances: {HEAD_DIMS})")
    if not (1 <= t_q < 2 ** 31 and 1 <= k.shape[2] < 2 ** 31 and 1 <= b * h <= _MAX_BLOCK_ROWS):
        raise ValueError(f"fused attention: unsupported sizes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"fused attention: {name} strides {t.stride()} must be dense in d "
                             f"and multiples of 8 elsewhere")
        if t.data_ptr() % 16:
            raise ValueError(f"fused attention: {name} must be 16-byte aligned")


def _lib(device: torch.device) -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from clip_diffusion_tpu_torch.ops import kernels

        lib = kernels.load("ldm_attention")
        lib.ldm_attention_init.argtypes = []
        lib.ldm_attention_init.restype = ctypes.c_int
        lib.ldm_attention_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
        ]
        lib.ldm_attention_launch.restype = ctypes.c_int
        _LIB = lib
    if device.index not in _READY:
        with torch.cuda.device(device):
            err = _LIB.ldm_attention_init()
        if err != 0:
            raise RuntimeError(f"fused attention: raising the shared memory limit failed: "
                               f"cudaError {err}")
        _READY.add(device.index)
    return _LIB


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T / scale) v for bfloat16 CUDA (b, h, t, d) tensors in one
    kernel launch on the current stream: the logits in float32, the
    softmax statistics in float32, P in bf16, the output in bf16.  Returns
    (b, h, t_q, d), the view of a (b, t_q, h, d) buffer."""
    check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused attention: needs CUDA tensors, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("fused attention: forward only, but an input requires grad")
    b, h, t_q, d = q.shape
    lib = _lib(q.device)
    out = torch.empty((b, t_q, h, d), dtype=torch.bfloat16, device=q.device)
    view = out.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, view) for s in t.stride()[:3]))
    err = lib.ldm_attention_launch(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t_q, k.shape[2],
        strides, math.log2(math.e) / scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused attention: kernel launch failed: cudaError {err}")
    return view


def projection_heads(gen: torch.Generator, b: int, h: int, t: int, d: int, mult: float = 1.0,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal draws times `mult` on `gen`'s device, as the (b, h, t, d)
    view of a (b, t, h * d) projection in `dtype`: q, k or v as
    `CrossAttention` hands them over."""
    x = torch.randn((b, t, h * d), generator=gen, device=gen.device) * mult
    return x.to(dtype).reshape(b, t, h, d).transpose(1, 2)


def attention_float32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """softmax(q k^T / scale) v evaluated in float32 from the given inputs,
    one batch row at a time: the yardstick both attention paths are held
    to."""
    return torch.stack([torch.softmax(qb.float() @ kb.float().transpose(-1, -2) / scale, -1)
                        @ vb.float() for qb, kb, vb in zip(q, k, v)])


def errors(x: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(relative Frobenius norm, largest element) of x - ref, in float32."""
    diff = (x.float() - ref.float()).flatten()
    return (diff.norm() / ref.float().flatten().norm()).item(), diff.abs().max().item()
