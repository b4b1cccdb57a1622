"""Tiny stand-ins of the benchmark's configurations and mixes, for CPU
tests of the harness: the same keys, small widths, float32."""

from __future__ import annotations

import copy

from port_bench import harness

TINY_CLIP = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
             "vision_patch_size": 16, "vision_heads": 4, "text_width": 32, "text_heads": 2,
             "text_layers": 2}
TINY_RN = {"embed_dim": 64, "image_resolution": 32, "vision_layers": [1, 1, 1, 1],
           "vision_width": 8, "vision_patch_size": None, "vision_heads": 4, "text_width": 32,
           "text_heads": 2, "text_layers": 2}


def tiny_guided_cell(name: str = "guided-default-b1", batch: int = 1) -> harness.Cell:
    cell = harness.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = "float32"
    cfg["unet"].update(image_size=32, model_channels=32, channel_mult=[1, 2], attention_ds=[2],
                       num_head_channels=16, num_res_blocks=1)
    cfg["clip"] = {"tiny-vit": TINY_CLIP, "tiny-rn": TINY_RN}
    traffic = copy.deepcopy(cell.traffic)
    traffic["batch"] = batch
    req = traffic["request"]
    req.update(width=64, height=64, steps=20, guidance_dtype="float32")
    return harness.Cell(cell.name, cell.chips, cfg, traffic, cell.end_to_end, cell.per_layer)


def tiny_latent_cell(name: str = "latent-f8-txt2img") -> harness.Cell:
    cell = harness.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["dtypes"] = {k: "float32" for k in cfg["dtypes"]}
    cfg["unet"].update(model_channels=32, channel_mult=[1, 2], attention_ds=[1, 2], num_heads=2,
                       context_dim=16)
    cfg["bert"].update(n_embed=16, n_layer=2, n_heads=2, dim_head=16)
    cfg["vq"].update(ch=16, n_embed=64, num_res_blocks=1, attn_resolutions=[], resolution=32)
    cfg["esrgan"].update(num_feat=16, num_block=2, num_grow_ch=8)
    traffic = copy.deepcopy(cell.traffic)
    traffic["request"].update(diffusion_steps=3, num_iterations=2, num_batches=2,
                              sample_width=64, sample_height=64)
    return harness.Cell(cell.name, cell.chips, cfg, traffic, cell.end_to_end, cell.per_layer)


def tiny_cell(name: str) -> harness.Cell:
    """The tiny stand-in of any cell of the benchmark, at its batch."""
    cell = harness.find_cell(name)
    if cell.config["runner"] == "guided":
        return tiny_guided_cell(name, batch=int(cell.traffic["batch"]))
    return tiny_latent_cell(name)
