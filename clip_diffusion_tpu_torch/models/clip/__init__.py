from clip_diffusion_tpu_torch.models.clip.model import (  # noqa: F401
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIP_PRESETS,
    CLIPConfig,
    CLIPModel,
    clip_normalize,
    tiny_clip_config,
)
from clip_diffusion_tpu_torch.models.clip.tokenizer import (  # noqa: F401
    CONTEXT_LENGTH,
    HashTokenizer,
    SimpleTokenizer,
    get_tokenizer,
    tokenize,
)
