"""Explicit collectives and model parallelism over the port's meshes — the
counterpart of ``gpt2_image_captioning_tpu/parallel/``: the ``(dp, tp)``
mesh's collectives (``collectives.py``) and the GPipe pipeline over a
``(dp, pp)`` mesh (``pipeline.py``, whose names load on first use: it
imports the models, which import the collectives).  The JAX package's
sequence-parallel names (``SEQ_AXIS``, ``create_sp_mesh``,
``make_sp_loss_and_grad``, ``pad_batch_for_sp``) come with the next slice
(ROADMAP.md, queue 1)."""

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

_PIPELINE_NAMES = ("PIPE_AXIS", "create_pipeline_mesh", "make_pipeline_loss_and_grad",
                   "make_pipeline_train_step", "pipeline_param_specs")


def __getattr__(name):
    if name in _PIPELINE_NAMES:
        from gpt2_image_captioning_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
