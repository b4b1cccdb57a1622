from clip_diffusion_tpu_torch.utils.profiling import clear_device_cache  # noqa: F401
