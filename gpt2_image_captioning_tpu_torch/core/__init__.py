from gpt2_image_captioning_tpu_torch.core.precision import (  # noqa: F401
    BF16,
    F32,
    Policy,
    cast_floating,
)
