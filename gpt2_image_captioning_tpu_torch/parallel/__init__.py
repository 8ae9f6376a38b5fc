"""Explicit collectives over the port's ``(dp, tp)`` mesh — the counterpart
of ``gpt2_image_captioning_tpu/parallel/``.  This package holds what data
parallelism needs; the JAX package's pipeline (``PIPE_AXIS``,
``create_pipeline_mesh``, ``make_pipeline_*``, ``pipeline_param_specs``)
and sequence-parallel names (``SEQ_AXIS``, ``create_sp_mesh``,
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
