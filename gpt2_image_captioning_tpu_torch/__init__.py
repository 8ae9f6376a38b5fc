"""gpt2_image_captioning_tpu_torch — the PyTorch + CUDA port of
``gpt2_image_captioning_tpu`` for an NVIDIA H100.

It mirrors the JAX package's module paths and public names.  Captioning
from pixels or embeddings (the vision towers, the GPT-2 prefill and every
decode mode, the services and their HTTP endpoints), the train step and the
epoch loop with COCO evaluation (``train/loop.py``, ``evaluation/``) run on
hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by ``nvcc`` at
first use — see ``ops/_build.py``); on the CPU the same code runs their
plain PyTorch twins.  The entry points: ``python -m
gpt2_image_captioning_tpu_torch`` (the environment check),
``.training_pipeline`` (training from ``config.yml``), ``.sweep``,
``.embeddings.extract`` (image embeddings) and ``.viz`` (the results
viewer).  Data parallelism runs one process a rank over a
``torch.distributed`` group (``core/mesh.py``, ``parallel/``; ``torchrun``).
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
