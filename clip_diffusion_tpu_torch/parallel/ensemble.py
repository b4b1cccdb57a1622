"""Perceptor-parallel guidance: one CLIP perceptor per rank.

Counterpart of `clip_diffusion_tpu.parallel.ensemble`.  Each rank of a
process group runs the UNet forward (replicated) and then only its own
perceptor's cutouts, tower and aesthetic loss; the whole-image terms (TV,
range, LPIPS, MS-SSIM) run on rank 0 only.  One `all_reduce(SUM)` of the
gradient with respect to x combines them, and the clamp, the threshold and
the DDIM or PLMS update, identical on every rank, follow.

Cutout draws are keyed by the global perceptor index, so the step equals
the single-process step with `share_cutouts_across_perceptors=False` up
to the order of the gradient's sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

from clip_diffusion_tpu_torch.parallel.dist import rank_and_size
from clip_diffusion_tpu_torch.pipeline.guided import (
    GuidedPipeline,
    guidance_gradient,
    step_from_gradient,
)


def build_ensemble_guided_step(pipe: GuidedPipeline, group=None,
                               slot_caps: Optional[Tuple[int, int]] = None):
    """-> step_fn(tables, x, step, draws, init_image=None, history=None) ->
    (x_next, pred_x0), `guided_step`'s signature, with perceptor `rank`
    of `pipe` on rank `rank` of `group`.  Needs one perceptor per rank.
    `slot_caps`: as `guided_step`'s, the slot layout handed to the draws."""
    rank, size = rank_and_size(group)
    if size != len(pipe.perceptors):
        raise ValueError(
            f"ensemble axis has {size} devices but the pipeline has {len(pipe.perceptors)} "
            "perceptors (one per device required)")

    def step_fn(tables, x, step: int, draws, init_image=None, history=None):
        grad, pred_x0_raw = guidance_gradient(pipe, tables, x, step, draws, init_image,
                                              perceptor_subset=(rank,),
                                              include_image_terms=rank == 0,
                                              slot_caps=slot_caps)
        if dist.is_initialized():
            dist.all_reduce(grad, group=group)
        # pred_x0_raw comes from the replicated UNet forward: the same on
        # every rank, as are the threshold and the update
        return step_from_gradient(pipe, tables, x, step, draws, grad, pred_x0_raw, history)

    return step_fn
