"""gpt2_image_captioning_tpu_torch — the PyTorch + CUDA port of
``gpt2_image_captioning_tpu`` for an NVIDIA H100.

It mirrors the JAX package's module paths and public names.  Captioning
from pixels or embeddings (the vision towers, the GPT-2 prefill and every
decode mode, the services) and the train step
(``train/loop.py::make_train_step``) run on hand-written CUDA kernels for
Hopper (``csrc/*.cu``, built by ``nvcc`` at first use — see
``ops/_build.py``); on the CPU the same code runs their plain PyTorch twins.
The package imports torch and never jax; PIL only where an image is decoded.
"""

__version__ = "0.1.0"

from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32, Policy  # noqa: F401
from gpt2_image_captioning_tpu_torch.models.captioner import (  # noqa: F401
    CaptionerConfig,
    ImageCaptioningModel,
)
from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config  # noqa: F401
from gpt2_image_captioning_tpu_torch.models.mapping import (  # noqa: F401
    MLPMappingConfig,
    TransformerMappingConfig,
    make_mapping_config,
)
