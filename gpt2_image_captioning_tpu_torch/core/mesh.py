"""The device mesh as ``torch.distributed`` process groups — the counterpart
of ``gpt2_image_captioning_tpu/core/mesh.py``.

The JAX package's mesh is one controller over a ``(dp, tp)`` grid of
devices.  The port's is PyTorch's form of a multi-process mesh: one process
a rank, every rank running the same host program on the same inputs (SPMD),
each working on its contiguous shard of the batch on its own device, and
the only communication explicit collectives (``parallel/collectives.py``)
over the mesh's process group.

- axis ``"dp"`` — data parallel: the batch is split over the ranks in rank
  order; gradients and counts are summed over the group.
- axis ``"tp"`` — tensor parallel: not ported yet (ROADMAP.md, queue 1:
  tensor parallelism); a mesh with ``tp > 1`` refuses.

:func:`init_distributed` joins the default group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or an explicit ``init_method``; :func:`create_mesh`
resolves a :class:`MeshSpec` against that group's world size (1 without a
group).  A rank's device is ``cuda:{LOCAL_RANK % device_count}``, so two
ranks may share one card, or the CPU when the caller asks for it.  The
backend follows the layout the ranks report (each card's UUID): ``nccl``
when every rank has a card of its own, ``gloo`` when ranks share a card or
run on the CPU (NCCL refuses two ranks on one device).

The JAX module's ``batch_sharding`` and ``replicated`` name GSPMD
shardings; nothing in the port uses them, and they are left out, as are
the DCN-aware device ordering and ``local_mesh_for_testing``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.tree import tree_map

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
TP_REFUSAL = "tensor parallelism is not ported yet (ROADMAP.md, queue 1: tensor parallelism)"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``dp=-1`` means "all remaining devices"."""

    dp: int = -1
    tp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        tp = self.tp if self.tp > 0 else 1
        if n_devices % tp != 0:
            raise ValueError(f"tp={tp} does not divide device count {n_devices}")
        dp = self.dp if self.dp > 0 else n_devices // tp
        if dp * tp != n_devices:
            raise ValueError(f"mesh {dp}x{tp} != {n_devices} devices")
        return dp, tp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``(dp, tp)`` mesh: the shape, its index
    ``rank`` among ``world_size`` ranks, the process ``group`` (None for a
    one-rank mesh without one: its collectives are the identity), the
    group's ``backend`` and the rank's ``device``."""

    dp: int
    tp: int
    rank: int
    world_size: int
    group: object
    backend: str | None
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def is_main(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.rank == 0


def refuse_tp(mesh) -> None:
    """Raise ``NotImplementedError`` for a mesh with a tensor-parallel axis."""
    if mesh is not None and mesh.tp > 1:
        raise NotImplementedError(TP_REFUSAL)


def rank_device(device=DEFAULT_DEVICE) -> torch.device:
    """The device of this rank: ``cuda`` without an index is the card
    ``LOCAL_RANK % device_count`` (raising without one); anything else as
    :func:`core.device.resolve_device` gives it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def device_identity(device: torch.device) -> str:
    """What names the hardware behind ``device`` across processes: the card's
    UUID, or ``cpu``."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_properties(device).uuid}"
    return "cpu"


def layout_backend(identities: list[str]) -> str:
    """``nccl`` when every rank has a card of its own (``identities``: each
    rank's :func:`device_identity`), ``gloo`` when ranks share a card or run
    on the CPU."""
    cards = [i for i in identities if i.startswith("cuda:")]
    if len(cards) == len(identities) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_distributed(init_method: str | None = None, *, rank: int | None = None,
                     world_size: int | None = None, device=DEFAULT_DEVICE) -> torch.device:
    """Join the default process group (once; a second call only returns the
    device) and return this rank's device (:func:`rank_device`).

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` / ``WORLD_SIZE``;
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``),
    and may name a ``file://`` or ``tcp://`` rendezvous.  The ranks first
    trade their devices' identities over the rendezvous's store, and the
    layout they show fixes the backend (:func:`layout_backend`): a launcher
    that hands each rank one card through ``CUDA_VISIBLE_DEVICES`` gives
    nccl, two ranks on one card gloo."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store, rank, world_size = next(dist.rendezvous(init_method or "env://", rank, world_size))
    store.set(f"gic_mesh_device/{rank}", device_identity(dev))
    backend = layout_backend([store.get(f"gic_mesh_device/{r}").decode()
                              for r in range(world_size)])
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, **kw)
    return dev


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as one of several
    ranks."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def create_mesh(spec: MeshSpec | None = None, device=None) -> Mesh:
    """The ``(dp, tp)`` mesh of this rank, resolved against the world size of
    the initialised default group, or against 1 without one: ``MeshSpec(dp=-1)``
    alone is a one-rank mesh, and ``dp=2`` without a group raises
    :meth:`MeshSpec.resolve`'s error.  ``tp > 1`` raises
    ``NotImplementedError``.  ``device``: the rank's device
    (:func:`rank_device`, the card by default)."""
    spec = spec or MeshSpec()
    if spec.tp > 1:
        raise NotImplementedError(TP_REFUSAL)
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    dp, tp = spec.resolve(n)
    return Mesh(dp=dp, tp=tp, rank=dist.get_rank() if grouped else 0, world_size=n,
                group=dist.group.WORLD if grouped else None,
                backend=dist.get_backend() if grouped else None,
                device=rank_device(DEFAULT_DEVICE if device is None else device))


def shard_bounds(mesh: Mesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous rows of a batch of ``n``, which
    ``dp`` must divide."""
    if n % mesh.dp != 0:
        raise ValueError(f"batch {n} must divide over dp={mesh.dp}")
    per = n // mesh.dp
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous slice of every leaf (numpy arrays or tensors,
    batch axis first) as tensors on the mesh's device."""
    def leaf(x):
        lo, hi = shard_bounds(mesh, len(x))
        return torch.as_tensor(x[lo:hi]).to(mesh.device)

    return tree_map(leaf, batch)


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the mesh's group (nothing without one)."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)
