"""The device mesh as ``torch.distributed`` process groups — the counterpart
of ``gpt2_image_captioning_tpu/core/mesh.py``.

The JAX package's mesh is one controller over a ``(dp, tp)`` grid of
devices.  The port's is PyTorch's form of a multi-process mesh: one process
a rank, every rank running the same host program on the same inputs (SPMD),
each working on its shard of the batch and of the weights on its own
device, and the only communication explicit collectives
(``parallel/collectives.py``) over the mesh's process groups.

Ranks lie on the ``(dp, tp)`` grid as ``rank = d · tp + t``, tp contiguous
(the JAX ``reshape(dp, tp)`` of the device list):

- axis ``"dp"`` — data parallel: the batch is split over the dp index in
  order; gradients and counts are summed over ``dp_group`` (the ranks of one
  tp index).
- axis ``"tp"`` — tensor parallel (Megatron): the ranks of one dp index
  (``tp_group``) hold slices of GPT-2's heads, MLP columns and vocabulary
  rows (``models/gpt2.py::partition_specs``) and run the same rows; the
  conjugate collectives of ``parallel/collectives.py`` join them.

Every rank creates every subgroup (``dist.new_group`` is collective), in the
same order, and keeps its own.  An axis of size 1 has no group: its
collectives are the identity, and a one-rank mesh has no group at all.

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
from typing import ClassVar

import torch
import torch.distributed as dist

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.tree import tree_map

DATA_AXIS = "dp"
MODEL_AXIS = "tp"


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


@dataclasses.dataclass(frozen=True, kw_only=True)
class GridMesh:
    """This rank's view of a ``(dp, X)`` grid of ranks, ``rank = dp_rank · X +
    x`` with X contiguous (the JAX ``reshape(dp, X)``): its ``rank`` among
    ``world_size`` ranks, the world's process ``group`` (None for a one-rank
    mesh without one), the group's ``backend``, the rank's ``device``, its
    ``dp_rank`` and ``dp_group`` (the ranks of its X index; None where dp is
    1).  A subclass names the second axis by ``AXIS`` = (the field of its
    size, the field of this rank's index on it); the axis's group is the
    field ``{size}_group`` (the ranks of this dp index)."""

    AXIS: ClassVar[tuple[str, str]]
    dp: int
    rank: int
    world_size: int
    group: object
    backend: str | None
    device: torch.device
    dp_rank: int = 0
    dp_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.dp, self.AXIS[0]: getattr(self, self.AXIS[0])}

    @property
    def is_main(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.rank == 0


@dataclasses.dataclass(frozen=True, kw_only=True)
class Mesh(GridMesh):
    """The ``(dp, tp)`` mesh: ``tp_rank`` on the tp axis and ``tp_group``
    (the ranks of its dp index)."""

    AXIS = (MODEL_AXIS, "tp_rank")
    tp: int
    tp_rank: int = 0
    tp_group: object = None


def grid_mesh(cls: type[GridMesh], dp: int, inner: int, device=None,
              unit: str = "ranks") -> GridMesh:
    """This rank's ``cls`` mesh on the ``(dp, inner)`` grid over the
    initialised process group (one rank without one), whose world size must
    be ``dp · inner`` (else "mesh {dp}x{inner} needs {dp · inner} {unit},
    have {n}"); every rank must call (the subgroups are created
    collectively).  ``device``: the rank's device (:func:`rank_device`, the
    card by default)."""
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if n != dp * inner:
        raise ValueError(f"mesh {dp}x{inner} needs {dp * inner} {unit}, have {n}")
    rank = dist.get_rank() if grouped else 0
    dp_rank, index = divmod(rank, inner)
    size, index_field = cls.AXIS
    inner_group = axis_groups([[d * inner + i for i in range(inner)] for d in range(dp)], rank)
    return cls(dp=dp, rank=rank, world_size=n, group=dist.group.WORLD if grouped else None,
               backend=dist.get_backend() if grouped else None,
               device=rank_device(DEFAULT_DEVICE if device is None else device),
               dp_rank=dp_rank,
               dp_group=axis_groups([[d * inner + i for d in range(dp)] for i in range(inner)],
                                    rank),
               **{size: inner, index_field: index, f"{size}_group": inner_group})


def tp_active(mesh) -> bool:
    """Whether ``mesh`` splits the model over a tp axis of more than one rank
    (False without a mesh).  A tp axis without its process group (a mesh
    built by hand rather than by :func:`create_mesh`) raises, rather than
    running one rank's slice of the model as if it were the whole."""
    if mesh is None or mesh.tp == 1:
        return False
    if mesh.tp_group is None:
        raise ValueError(f"mesh {mesh.dp}x{mesh.tp} has no tp group: build it with create_mesh "
                         "over an initialised process group")
    return True


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
    :meth:`MeshSpec.resolve`'s error, as does ``tp=2``.  Every rank of the
    group must make the call (the subgroups are created collectively).
    ``device``: the rank's device (:func:`rank_device`, the card by
    default)."""
    grouped = dist.is_initialized()
    dp, tp = (spec or MeshSpec()).resolve(dist.get_world_size() if grouped else 1)
    return grid_mesh(Mesh, dp, tp, device)


def axis_groups(members: list[list[int]], rank: int):
    """The process group of the list in ``members`` that holds ``rank``, after
    creating one group per list in order on every rank (``dist.new_group``
    is collective); the world's group when one list holds every rank, None
    for lists of one rank (an axis of size 1)."""
    if len(members[0]) == 1:
        return None
    if len(members) == 1:
        return dist.group.WORLD
    mine = None
    for ranks in members:
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def shard_bounds(mesh: Mesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous rows of a batch of ``n``, which
    ``dp`` must divide (the rows of its dp index: the ranks of one tp group
    hold the same)."""
    if n % mesh.dp != 0:
        raise ValueError(f"batch {n} must divide over dp={mesh.dp}")
    per = n // mesh.dp
    return mesh.dp_rank * per, (mesh.dp_rank + 1) * per


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
