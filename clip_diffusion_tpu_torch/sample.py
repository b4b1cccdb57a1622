"""Public sampling API of the PyTorch port.

`guided_diffusion_sample` and `latent_diffusion_sample` keep the JAX
package's keyword arguments and return dicts, plus `device=` (default
`cuda`; the CPU only when asked).  Chinese prompts are translated and
`use_auto_modifiers` appends retrieved keywords (`text/prompt.py`).
`custom_model_params` is a UNet state dict in the port's layout on the
request's device (what `runtime/registry.py` loads), applied to a shallow
copy of the zoo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws
from clip_diffusion_tpu_torch.pipeline.guided import guided_sample as _run_guided
from clip_diffusion_tpu_torch.pipeline.latent import decode_latents, img2img_start, latent_sample
from clip_diffusion_tpu_torch.text.prompt import Prompt
from clip_diffusion_tpu_torch.utils.device import resolve_device
from clip_diffusion_tpu_torch.utils.image_io import (
    array_to_image,
    create_gif,
    draw_index_on_grid_image,
    load_image,
    load_mask,
    make_grid,
    normalize_image_neg_one_to_one,
)
from clip_diffusion_tpu_torch.utils.profiling import annotate
from clip_diffusion_tpu_torch.utils.progress import LocalUploader, store_task_state
from clip_diffusion_tpu_torch.utils.seeds import random_seed
from clip_diffusion_tpu_torch.zoo import (
    build_latent_models,
    build_latent_pipeline,
    build_lpips,
    build_models,
    build_pipeline,
    with_unet_state_dict,
)

OUTPUT_PATH = "output_images"


def guided_diffusion_sample(
    prompt: str = "A cute golden retriever.",
    use_auto_modifiers: bool = False,
    num_modifiers: int = 1,
    custom_model_params=None,
    dynamic_thresholding_percentile: float = 0.995,
    seed: Optional[int] = None,
    init_image=None,
    sample_mode: str = "ddim",
    steps: int = 200,
    skip_timesteps: int = 0,
    eta: float = 0.8,
    num_batches: int = 1,
    gif_duration: int = 500,
    config: Optional[Config] = None,
    models=None,
    modifier_bank=None,
    uploader=None,
    output_dir: str = OUTPUT_PATH,
    images_per_dispatch: Optional[int] = None,
    save_every_step: bool = False,
    device=None,
):
    """CLIP-guided generation.  Returns {"images": [paths], "gif_urls":
    [urls], "seed": int}.

    `models`: a `zoo.ZooModels` built on `device` (built here when None).
    `custom_model_params`: a finetuned UNet's state dict on `device`, used
    in place of the zoo's UNet for this request only.
    With `use_auto_modifiers`, the prompt gains the top `num_modifiers`
    keywords of `modifier_bank` (default: the shipped bank, its sentence-T5
    on `device`), stored as the task state's `new_prompt`.
    `init_image` (a path or encoded bytes) is resized to the canvas; with it
    the LPIPS (when `LPIPS_scale > 0`) and MS-SSIM (when `MS_SSIM_scale >
    0`) terms pull the trajectory towards it.
    `images_per_dispatch` caps the batch per trajectory; larger
    `num_batches` run as sequential sub-batches, sub-batch k > 0 with the
    draws `fold(k)` of its own, as the JAX package folds k into its key.
    `save_every_step` writes a PNG of pred_x0 for every step under
    <output_dir>/guided/steps/; the every-5-step progress upload keeps its
    contract either way."""
    device = resolve_device(device)
    config = config or Config()
    uploader = uploader or LocalUploader(output_dir)
    batch_folder = os.path.join(output_dir, "guided")
    os.makedirs(batch_folder, exist_ok=True)

    p = Prompt(prompt, use_auto_modifiers, num_modifiers, modifier_bank, device=device)
    if use_auto_modifiers:
        store_task_state("new_prompt", p.text)

    init = None
    if init_image is not None:
        arr = normalize_image_neg_one_to_one(
            load_image(init_image, (config.width, config.height)))
        init = torch.from_numpy(arr)[None].to(device)
    # LPIPS and MS-SSIM apply whenever an init image is present and their
    # scale is on
    need_lpips = init is not None and config.LPIPS_scale > 0
    use_init_losses = init is not None and (config.LPIPS_scale > 0 or config.MS_SSIM_scale > 0)

    if models is None:
        models = build_models(config, image_size=512,
                              with_aesthetic=config.aesthetic_scale > 0,
                              with_lpips=need_lpips, device=device)
    elif need_lpips and models.lpips is None:
        # a shallow copy: the caller's (possibly shared) zoo keeps no LPIPS
        # tower it did not ask for
        models = dataclasses.replace(models, lpips=build_lpips(device=device))
    if custom_model_params is not None:
        # a shallow copy too: later default requests keep the zoo's UNet
        models = with_unet_state_dict(models, custom_model_params)

    if not seed:
        seed = random_seed()
    draws = TorchDraws(int(seed), device)

    sampler = SamplerConfig(
        mode=sample_mode,
        steps=steps,
        eta=eta,
        skip_timesteps=skip_timesteps,
        order=2,
        dynamic_thresholding_percentile=dynamic_thresholding_percentile,
    )
    pipe = build_pipeline(models, config, [(p.text, p.weight)], sampler,
                          use_init_losses=use_init_losses)

    progress_every = 1 if save_every_step else 5
    steps_folder = os.path.join(batch_folder, "steps")
    if save_every_step:
        os.makedirs(steps_folder, exist_ok=True)

    def progress_cb(pos, imgs):
        img = array_to_image((imgs[0].float().cpu().numpy() + 1) / 2)
        if save_every_step:
            img.save(os.path.join(steps_folder, f"guided_step_{pos:04}.png"))
        if pos % 5 == 0:  # the every-5-step upload contract
            path = os.path.join(batch_folder, f"guided_progress_{pos:04}.png")
            img.save(path)
            store_task_state("current_step", pos + 1)
            store_task_state("current_result", uploader.upload(path, minutes=10))

    store_task_state("current_result", None)
    chunk = images_per_dispatch or num_batches
    finals, frame_stacks = [], []
    done = 0
    sub = 0
    while done < num_batches:
        b = min(chunk, num_batches - done)
        store_task_state("current_batch", sub)
        final, frames = _run_guided(
            pipe, draws if sub == 0 else draws.fold(sub), batch_size=b, init_image=init,
            progress_callback=progress_cb, progress_every=progress_every,
        )
        finals.append(final.cpu().numpy())
        frame_stacks.append(frames.cpu().numpy())
        done += b
        sub += 1

    image_paths = []
    gif_urls = []
    final_np = (np.concatenate(finals, axis=0) + 1) / 2
    frames_np = (np.concatenate(frame_stacks, axis=1) + 1) / 2
    for b in range(num_batches):
        img_path = os.path.join(batch_folder, f"guided_{b}.png")
        array_to_image(final_np[b]).save(img_path)
        image_paths.append(img_path)
        gif_path = os.path.join(batch_folder, f"guided_{b}.gif")
        create_gif(frames_np[:, b], gif_path, gif_duration)
        gif_urls.append(uploader.upload(gif_path, minutes=10))
    store_task_state("current_step", pipe.schedule.num_steps)
    return {"images": image_paths, "gif_urls": gif_urls, "seed": int(seed)}


# the default LDM stack, built at the first request that needs it, per device
_LATENT_STACK_CACHE: dict = {}


def default_latent_stack(device=None):
    """(LatentPipeline, text_encode) of the full-width LDM stack on `device`
    (default `cuda`), built once per device and kept for later requests."""
    device = resolve_device(device)
    if str(device) not in _LATENT_STACK_CACHE:
        _LATENT_STACK_CACHE[str(device)] = build_latent_pipeline(
            build_latent_models(device=device))
    return _LATENT_STACK_CACHE[str(device)]


def iteration_seed(seed: int, iteration: int) -> int:
    """The seed of one iteration's draws: a stream of its own per (seed,
    iteration), as the JAX package folds the iteration into its key."""
    return int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1)[0])


def latent_diffusion_sample(
    prompt: str = "A cute golden retriever.",
    seed: Optional[int] = None,
    init_image=None,
    mask_image=None,
    sample_mode: str = "ddim",
    diffusion_steps: int = 50,
    eta: float = 0.0,
    latent_diffusion_guidance_scale: float = 5,
    num_iterations: int = 3,
    num_batches: int = 3,
    sample_width: int = 256,
    sample_height: int = 256,
    pipe=None,
    text_encode=None,
    upscaler=None,
    uploader=None,
    output_dir: str = OUTPUT_PATH,
    device=None,
):
    """Latent-diffusion txt2img, or inpainting when both `init_image` and
    `mask_image` are given (mask white = keep), then optional upscaling.
    Returns {"grid_url", "images", "seed"}.

    Each of `num_iterations` iterations samples `num_batches` images with
    its own draws and writes them as <output_dir>/latent/latent_{n}.png;
    the indexed grid of all of them is latent_grid_image.png.
    `upscaler(images01)` takes a (1, H, W, 3) tensor in [0, 1] on `device`
    and returns the upscaled one (e.g. `functools.partial(models.esrgan.
    upscale, zoo.build_esrgan())`); its outputs go to latent/sr/.
    `pipe` and `text_encode` (from `zoo.build_latent_pipeline`, or
    `zoo.build_sdxl_pipeline` for SDXL base 1.0, on `device`) are given
    together or not at all: without them the default stack is built once
    per device (`default_latent_stack`).  The modules
    carry their weights, so there is no `latent_params` argument.

    While a profile collects (`utils.profiling`), the request is a
    `latent.request` span; inside it `latent.text` (each text encoding:
    the prompt's, the empty prompt's), `latent.decode` (the VQ decode and
    its copy to the host), `latent.png` (each PNG write: the images, the
    grid, the upscales) and `latent.upscale` (each upscaler call and its
    copy to the host)."""
    with annotate("latent.request"):
        device = resolve_device(device)
        if pipe is None and text_encode is None:
            pipe, text_encode = default_latent_stack(device)
        elif pipe is None or text_encode is None:
            raise ValueError(
                "latent_diffusion_sample: pass pipe and text_encode together, or "
                "neither for the default stack"
            )
        uploader = uploader or LocalUploader(output_dir)
        batch_folder = os.path.join(output_dir, "latent")
        os.makedirs(batch_folder, exist_ok=True)

        p = Prompt(prompt, False, 0, device=device)
        if not seed:
            seed = random_seed()

        with annotate("latent.text"):
            ctx_cond = text_encode([p.text] * num_batches)
        ctx_uncond = None
        if latent_diffusion_guidance_scale > 0:
            with annotate("latent.text"):
                ctx_uncond = text_encode([""] * num_batches)

        x0_latent = None
        mask = None
        if init_image is not None and mask_image is not None:
            init = normalize_image_neg_one_to_one(
                load_image(init_image, (sample_width, sample_height)))
            z = img2img_start(pipe, torch.from_numpy(init)[None].to(device))
            x0_latent = z.repeat(num_batches, 1, 1, 1)
            m = load_mask(mask_image, (sample_width // pipe.downsample,
                                       sample_height // pipe.downsample))
            mask = torch.from_numpy(m)[None].to(device).repeat(num_batches, 1, 1, 1)

        all_images = []
        count = 0
        for iteration in range(num_iterations):
            z = latent_sample(
                pipe, TorchDraws(iteration_seed(seed, iteration), device), ctx_cond, ctx_uncond,
                batch_size=num_batches, height=sample_height, width=sample_width,
                steps=diffusion_steps, guidance_scale=latent_diffusion_guidance_scale,
                eta=eta, mode=sample_mode, x0_latent=x0_latent, mask=mask,
            )
            with annotate("latent.decode"):
                images01 = decode_latents(pipe, z).float().cpu().numpy()
            with annotate("latent.png"):
                for img in images01:
                    array_to_image(img).save(os.path.join(batch_folder, f"latent_{count}.png"))
                    count += 1
            store_task_state("current_iteration", iteration + 1)
            all_images.append(images01)

        grid_path = os.path.join(batch_folder, "latent_grid_image.png")
        with annotate("latent.png"):
            grid = make_grid(np.concatenate(all_images, axis=0), nrow=num_batches)
            grid_img = draw_index_on_grid_image(array_to_image(grid), num_iterations, num_batches,
                                                sample_height, sample_width)
            grid_img.save(grid_path)
        grid_url = uploader.upload(grid_path)

        if upscaler is not None:
            os.makedirs(os.path.join(batch_folder, "sr"), exist_ok=True)
            for i in range(count):
                img = load_image(os.path.join(batch_folder, f"latent_{i}.png"))
                with annotate("latent.upscale"):
                    up = upscaler(torch.from_numpy(img)[None].to(device))[0].float().cpu().numpy()
                with annotate("latent.png"):
                    array_to_image(up).save(os.path.join(batch_folder, "sr", f"latent_{i}.png"))

        return {
            "grid_url": grid_url,
            "images": [os.path.join(batch_folder, f"latent_{i}.png") for i in range(count)],
            "seed": int(seed),
        }
