"""Public sampling API of the PyTorch port.

`guided_diffusion_sample` keeps the JAX package's keyword arguments and
return dict, plus `device=` (default `cuda`; the CPU only when asked).
Not yet ported, and raising `NotImplementedError`: the init-image path
(`init_image`), auto modifiers, `custom_model_params`, the aesthetic heads
(`aesthetic_scale > 0`) and PLMS.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws
from clip_diffusion_tpu_torch.pipeline.guided import guided_sample as _run_guided
from clip_diffusion_tpu_torch.text.prompt import Prompt
from clip_diffusion_tpu_torch.utils.device import resolve_device
from clip_diffusion_tpu_torch.utils.image_io import array_to_image, create_gif
from clip_diffusion_tpu_torch.utils.progress import LocalUploader, store_task_state
from clip_diffusion_tpu_torch.utils.seeds import random_seed
from clip_diffusion_tpu_torch.zoo import build_models, build_pipeline

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
    `images_per_dispatch` caps the batch per trajectory; larger
    `num_batches` run as sequential sub-batches drawing from the same
    generator.  `save_every_step` writes a PNG of pred_x0 for every step
    under <output_dir>/guided/steps/; the every-5-step progress upload keeps
    its contract either way."""
    device = resolve_device(device)
    if init_image is not None:
        raise NotImplementedError("init_image: the init-image path is a later slice of the port")
    if custom_model_params is not None:
        raise NotImplementedError(
            "custom_model_params: checkpoint loading is a later slice of the port"
        )
    config = config or Config()
    if config.aesthetic_scale > 0:
        raise NotImplementedError("aesthetic_scale: the aesthetic heads are a later slice of the port")
    uploader = uploader or LocalUploader(output_dir)
    batch_folder = os.path.join(output_dir, "guided")
    os.makedirs(batch_folder, exist_ok=True)

    p = Prompt(prompt, use_auto_modifiers, num_modifiers, modifier_bank)

    if models is None:
        models = build_models(config, image_size=512, device=device)

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
    pipe = build_pipeline(models, config, [(p.text, p.weight)], sampler)

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
            pipe, draws, batch_size=b,
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
