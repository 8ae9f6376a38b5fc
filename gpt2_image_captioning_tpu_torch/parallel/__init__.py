"""Explicit collectives and model parallelism over the port's meshes — the
counterpart of ``gpt2_image_captioning_tpu/parallel/``: the ``(dp, tp)``
mesh's collectives (``collectives.py``), the GPipe pipeline over a
``(dp, pp)`` mesh (``pipeline.py``) and sequence parallelism over a
``(dp, sp)`` mesh with its ring attention (``sequence.py``, ``ring.py``).
The pipeline's and the sequence-parallel names load on first use: those
modules import the models, which import the collectives."""

from gpt2_image_captioning_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    create_mesh,
    shard_batch,
)
from gpt2_image_captioning_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_batch,
    pmean_scalar,
    psum_scalar,
    psum_tensors,
)

_LAZY = {
    **dict.fromkeys(("PIPE_AXIS", "create_pipeline_mesh", "make_pipeline_loss_and_grad",
                     "make_pipeline_train_step", "pipeline_param_specs"), "pipeline"),
    **dict.fromkeys(("SEQ_AXIS", "create_sp_mesh", "make_sp_loss_and_grad", "pad_batch_for_sp"),
                    "sequence"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
