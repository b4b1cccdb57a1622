"""The LDM UNet's attention dispatch and the fused kernel's argument check,
without a card: CPU tensors (float32 and bfloat16) take the plain body and
launch nothing; the check refuses what the kernel does not take and passes
every shape the LDM configurations send; the kernel's source builds through
`ops.kernels` with the shared flags and its own hash.  The kernel itself is
held against the plain body on the card (`tests/test_torch_cuda.py`)."""

import hashlib
import math
import os
import subprocess

import pytest
import torch

from clip_diffusion_tpu_torch.models.ldm import unet as ldm_unet
from clip_diffusion_tpu_torch.ops import attention as attention_ops
from clip_diffusion_tpu_torch.ops import kernels

# every (heads, query tokens, key tokens, head dim) the two LDM configurations send
LDM_SHAPES = [shape[2:6] for shape in attention_ops.LDM_SHAPES]


def _heads(b, h, t, d, dtype=torch.bfloat16, seed=0):
    """(b, h, t, d) view of a (b, t, h * d) projection, as `CrossAttention`
    hands it over."""
    return attention_ops.projection_heads(torch.Generator().manual_seed(seed), b, h, t, d,
                                          dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_inputs_take_the_plain_body(dtype, monkeypatch):
    """On the CPU `attention` is the plain body, bit for bit, in either
    dtype; it counts the call and launches nothing."""
    def refuse(*_args):
        raise AssertionError("the fused kernel was called for CPU tensors")

    monkeypatch.setattr(ldm_unet, "fused_attention", refuse)
    q, k, v = (_heads(2, 3, t, 40, dtype, seed) for seed, t in ((1, 16), (2, 77), (3, 77)))
    scale = torch.tensor(math.sqrt(40), dtype=dtype).item()
    calls, launches = ldm_unet.attention.calls, ldm_unet.attention.kernel_launches
    got = ldm_unet.attention(q, k, v, scale, dtype)
    logits = torch.matmul(q, k.transpose(-1, -2)) / scale
    want = torch.matmul(torch.softmax(logits.to(torch.float32), dim=-1).to(dtype), v)
    assert torch.equal(got, want) and got.dtype == dtype
    assert torch.equal(ldm_unet.attention_plain(q, k, v, scale, dtype), want)
    assert ldm_unet.attention.calls == calls + 1
    assert ldm_unet.attention.kernel_launches == launches


@pytest.mark.parametrize("shape", LDM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_check_takes_every_ldm_shape(shape):
    h, t_q, t_k, d = shape
    attention_ops.check(_heads(1, h, t_q, d), _heads(1, h, t_k, d), _heads(1, h, t_k, d))


def _bad_cases():
    q, kv = _heads(2, 4, 16, 64), _heads(2, 4, 77, 64)
    return {
        "head dim 36, no multiple of 8": (_heads(2, 4, 16, 36),) + (_heads(2, 4, 77, 36),) * 2,
        "head dim 264, over 256": (_heads(1, 1, 16, 264),) + (_heads(1, 1, 77, 264),) * 2,
        "head dim 48, no instance": (_heads(2, 4, 16, 48),) + (_heads(2, 4, 77, 48),) * 2,
        "batch of k differs": (q, _heads(3, 4, 77, 64), _heads(3, 4, 77, 64)),
        "heads of k differ": (q, _heads(2, 5, 77, 64), _heads(2, 5, 77, 64)),
        "heads of v differ": (q, kv, _heads(2, 5, 77, 64)),
        "k and v lengths differ": (q, kv, _heads(2, 4, 76, 64)),
        "head dim of k differs": (q, _heads(2, 4, 77, 80), _heads(2, 4, 77, 80)),
        "float32 q": (q.float(), kv, kv),
        "three dimensions": (q[0], kv[0], kv[0]),
        "no query": (q[:, :, :0], kv, kv),
        "d not dense": (torch.zeros((2, 4, 16, 128), dtype=torch.bfloat16)[..., ::2], kv, kv),
        "token stride no multiple of 8": (
            torch.zeros((2, 16, 4 * 64 + 4), dtype=torch.bfloat16)[..., :256]
            .reshape(2, 16, 4, 64).transpose(1, 2), kv, kv),
        "misaligned pointer": (
            torch.zeros(2 * 16 * 256 + 4, dtype=torch.bfloat16)[4:].reshape(2, 16, 4, 64)
            .transpose(1, 2), kv, kv),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_check_refuses_what_the_kernel_does_not_take(case):
    q, k, v = _bad_cases()[case]
    with pytest.raises((ValueError, TypeError)):
        attention_ops.check(q, k, v)


def test_fused_attention_needs_the_card():
    """Arguments the kernel takes, but on the CPU: refused, not run plain."""
    q, kv = _heads(1, 2, 16, 64), _heads(1, 2, 77, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attention_ops.fused_attention(q, kv, kv, 8.0)


def test_source_builds_through_the_kernels_hash(monkeypatch, tmp_path):
    """`csrc/ldm_attention.cu` names the kernel and its C entry points; its
    library path is the hash of the source and the shared flags, which are
    as the other kernel's build has them; a build runs nvcc once with those
    flags on that source and is then reused."""
    src = os.path.join(kernels.CSRC_DIR, "ldm_attention.cu")
    text = open(src).read()
    for name in ("ldm_softmax_attention_fwd", 'extern "C" int ldm_attention_launch',
                 'extern "C" int ldm_attention_init'):
        assert name in text
    assert kernels.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-prec-div=true", "-fmad=false")
    digest = hashlib.sha256(open(src, "rb").read() + " ".join(kernels.NVCC_FLAGS).encode())
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    path = kernels.library_path("ldm_attention")
    assert path == os.path.join(str(tmp_path), f"libldm_attention-{digest.hexdigest()[:12]}.so")

    commands = []

    def fake_nvcc(cmd, **_kw):
        commands.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_nvcc)
    assert kernels.build("ldm_attention") == path and os.path.exists(path)
    assert kernels.build("ldm_attention") == path
    assert len(commands) == 1
    assert commands[0][1:1 + len(kernels.NVCC_FLAGS)] == list(kernels.NVCC_FLAGS)
    assert commands[0][-1] == src
