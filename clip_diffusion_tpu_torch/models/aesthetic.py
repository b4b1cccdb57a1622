"""Aesthetic predictor heads over CLIP image embeddings.

Counterpart of `clip_diffusion_tpu.models.aesthetic`: one linear layer for
the 512-d ViT-B/32 and ViT-B/16 embeddings, and the 768->1024->128->64->16->1
MLP for ViT-L/14.  Dropout exists only for training; at inference the heads
are deterministic.  Names follow the torch checkpoints (`linear.weight`,
`layers.{0,2,4,6,7}.weight`).
"""

from __future__ import annotations

from torch import nn

from clip_diffusion_tpu_torch.models.convert import StateDict

# CLIP embedding widths of the towers that have a head.
CLIP_DIMS = {"ViT-B/32": 512, "ViT-B/16": 512, "ViT-L/14": 768}


class LinearAestheticPredictor(nn.Module):
    def __init__(self, dim: int = 512):
        super().__init__()
        self.linear = nn.Linear(dim, 1)

    def forward(self, x):
        return self.linear(x)


class MLPAestheticPredictor(nn.Module):
    def __init__(self, dim: int = 768):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(dim, 1024), nn.Dropout(0.2),
            nn.Linear(1024, 128), nn.Dropout(0.2),
            nn.Linear(128, 64), nn.Dropout(0.1),
            nn.Linear(64, 16), nn.Linear(16, 1),
        )

    def forward(self, x):
        return self.layers(x)


# Linear layers of the MLP head's Sequential (Dropouts between)
_MLP_LINEARS = ("0", "2", "4", "6", "7")


def convert_aesthetic(state_dict) -> StateDict:
    """Either head's release state dict -> the port's keys: the simulacra
    linear probes (`linear.*`, or a bare nn.Linear's `weight`/`bias`, which
    become `linear.*`) and the improved-aesthetic-predictor MLP
    (`layers.{0,2,4,6,7}.*`)."""
    out = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if key in ("weight", "bias"):
            key = "linear." + key
        elif not (len(parts) == 2 and parts[0] == "linear" and parts[1] in ("weight", "bias")
                  or len(parts) == 3 and parts[0] == "layers" and parts[1] in _MLP_LINEARS
                  and parts[2] in ("weight", "bias")):
            raise KeyError(f"unmapped aesthetic key: {key}")
        out[key] = val
    return out


def make_aesthetic_predictor(clip_model_name: str) -> nn.Module:
    """The head paired with each CLIP model: 768-d -> MLP, else linear."""
    dim = CLIP_DIMS[clip_model_name]
    return MLPAestheticPredictor(dim) if dim == 768 else LinearAestheticPredictor(dim)
