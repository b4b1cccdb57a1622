"""A CompVis LatentDiffusion release file -> the LDM stack's state dicts.

Counterpart of `clip_diffusion_tpu.models.ldm.convert`.  The one release
file (txt2img-f8-large, the jack000 fp16 finetune) holds the three
submodels under fixed prefixes: `model.diffusion_model.*` (the UNet),
`first_stage_model.*` (the taming VQ) and `cond_stage_model.transformer.*`
(the x-transformers BERT).  The port's keys are the release's without the
prefix, so conversion is a split and a key check.  The UNet takes the
LitEma shadows (`model_ema.<path without dots>`) when the file has them,
since the reference samples inside `ema_scope`.  Dropped: the VQ's
`loss.*` (training only), the BERT's `to_logits` head and `project_emb`,
and everything outside the three prefixes (schedule tables, `logvar`,
`model_ema.decay`, the tokenizer's buffers).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from clip_diffusion_tpu_torch.models.convert import StateDict, check_key
from clip_diffusion_tpu_torch.models.from_jax import bert_rule, ldm_unet_rule, vq_rule

UNET_PREFIX = "model.diffusion_model."
VQ_PREFIX = "first_stage_model."
BERT_PREFIX = "cond_stage_model.transformer."
EMA_PREFIX = "model_ema."


def split_ldm_state_dict(sd: Mapping[str, torch.Tensor]) -> Tuple[StateDict, StateDict, StateDict]:
    """One LatentDiffusion state dict -> (unet, vq, bert) without their
    prefixes, the UNet weights replaced by their LitEma shadows when
    present."""
    ema = {k[len(EMA_PREFIX):]: v for k, v in sd.items() if k.startswith(EMA_PREFIX)}
    unet, vq, bert = {}, {}, {}
    for key, val in sd.items():
        if key.startswith(UNET_PREFIX):
            sub = key[len(UNET_PREFIX):]
            if ema:
                # LitEma names a shadow by the parameter's path with the dots removed
                val = ema.get(("diffusion_model." + sub).replace(".", ""), val)
            unet[sub] = val
        elif key.startswith(VQ_PREFIX):
            vq[key[len(VQ_PREFIX):]] = val
        elif key.startswith(BERT_PREFIX):
            bert[key[len(BERT_PREFIX):]] = val
    return unet, vq, bert


def convert_ldm_unet(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The UNet part (keys without `model.diffusion_model.`) -> `LDMUNet`
    keys, checked."""
    for key in state_dict:
        check_key(key, ldm_unet_rule, "LDM UNet")
    return dict(state_dict)


def convert_vq(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The VQ part (keys without `first_stage_model.`) -> `VQModel` keys,
    without the training-only `loss.*`."""
    out = {}
    for key, val in state_dict.items():
        if key.startswith("loss."):
            continue
        check_key(key, vq_rule, "VQ")
        out[key] = val
    return out


def convert_bert(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """The BERT part (keys without `cond_stage_model.transformer.`) ->
    `BERTEmbedder` keys: the final LayerNorm as `norm.*` (x-transformers
    also names it `attn_layers.norm.*`), without the unused LM head
    `to_logits` and the identity `project_emb`."""
    out = {}
    for key, val in state_dict.items():
        if key.startswith(("to_logits.", "project_emb.")):
            continue
        if key.startswith("attn_layers.norm."):
            key = key[len("attn_layers."):]
        check_key(key, bert_rule, "BERT")
        out[key] = val
    return out

