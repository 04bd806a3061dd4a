"""Device meshes and batch placements, counterpart of
``visuelle2_tpu/parallel/mesh.py``.

PyTorch runs one process per device, so a mesh is laid over the ranks of
the default process group: ``make_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names,
``("data", "model")``.

* ``data`` — batch (items) parallelism: every rank takes a contiguous row
  block of each global batch; the loss, the gradient, the BatchNorm
  statistics, the dropout masks and the eval sums stay global quantities
  (``parallel/collectives.py``, ``train/loop.py``).
* ``model`` — tensor parallelism, innermost: the ranks of one data index
  hold the same rows and each keeps a 1/``model`` column block of every
  parameter the rule of ``parallel/sharding.py`` shards.

A rank's place in the mesh gives its two groups: the data group
(``batch_group``: the ranks that share its model index, across which the
gradients, the loss's denominator, the BatchNorm statistics and the eval
sums are reduced) and the model group (``model_group``: the ranks that share
its data index, across which sharded parameters are gathered).  Both are
made for every rank at once, in one order, when the mesh is made
(``torch.distributed.new_group`` is collective), and kept until
``parallel.distributed.shutdown``.  With ``model = 1`` over the whole world
in rank order the data group is the default group.

With no process group ``make_mesh`` returns a ``LocalMesh``: a one-rank
stand-in with the same axes (a ``DeviceMesh`` needs a process group), so a
single-device ``Trainer`` needs no ``initialize``.

``batch_sharding``, ``stacked_batch_sharding`` and ``replicated_sharding``
return the ``torch.distributed.tensor`` placements, one a mesh axis: the
batch axis (axis 0, or axis 1 of a ``[accum_steps, batch, ...]`` stack)
sharded over every non-``model`` axis, replicated over ``model``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

AXES = ("data", "model")
BATCH_EXCLUDED = "model"  # the one axis the batch is not split over
# (ranks of the mesh in order, model size) -> (data groups, model groups),
# each a list indexed by the model index and the data index.
_GROUPS = {}


class LocalMesh:
    """One rank, no process group: the mesh of a single-device run.  It has
    the ``DeviceMesh`` attributes the port reads (``mesh``,
    ``mesh_dim_names``, ``shape``, ``ndim``, ``size``, ``device_type``)."""

    def __init__(self, names=AXES, device_type: str = "cpu"):
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.mesh_dim_names)
        self.shape = (1,) * self.ndim
        self.mesh = torch.zeros(self.shape, dtype=torch.int64)
        self.device_type = device_type

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1


def _default_device_type() -> str:
    from visuelle2_tpu_torch.parallel import distributed

    device = distributed.current_device()
    if device is not None:
        return device.type
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: Optional[int] = None, model: int = 1, world: Optional[int] = None,
              device_type: Optional[str] = None):
    """A ``(data, model)`` mesh over the ``world`` ranks of the default
    process group (all of them by default); a ``LocalMesh`` when there is no
    process group.  ``data * model`` must equal the ranks."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        n = 1 if world is None else int(world)
        if n != 1 or data not in (None, 1) or model != 1:
            raise ValueError(f"mesh {data}x{model} over {n} ranks, but no process group "
                             f"is initialized (parallel.distributed.initialize)")
        return LocalMesh(device_type=device_type or "cpu")
    size = dist.get_world_size()
    n = size if world is None else int(world)
    if n != size:
        raise ValueError(f"world={n}, but the process group has {size} ranks")
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    data = n // model if data is None else data
    if data * model != n:  # a real raise: python -O strips asserts
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(device_type or _default_device_type(),
                      torch.arange(n).reshape(data, model), mesh_dim_names=AXES)
    make_groups(mesh)
    return mesh


def is_distributed(mesh) -> bool:
    """Whether ``mesh`` is over a process group (a ``DeviceMesh``), so the
    collectives run, at one rank as at many."""
    return mesh is not None and not isinstance(mesh, LocalMesh)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}``, as ``dict(jax_mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def model_size(mesh) -> int:
    """The ``model`` axis's size (1 for no mesh)."""
    return 1 if mesh is None else mesh_shape(mesh).get(BATCH_EXCLUDED, 1)


def _position(mesh) -> Tuple[list, int, int]:
    """The mesh's ranks in order, this rank's place among them, and the
    model axis's size."""
    import torch.distributed as dist

    ranks = mesh.mesh.flatten().tolist()
    return ranks, ranks.index(dist.get_rank()), model_size(mesh)


def batch_rank_world(mesh) -> Tuple[int, int]:
    """This rank's index along the batch axis (every non-``model`` axis,
    outermost first) and the axis's size: the ``model`` ranks of one data
    index share it, so they take the same row block.  ``(0, 1)`` for a
    ``LocalMesh`` or no mesh."""
    if not is_distributed(mesh):
        return 0, 1
    ranks, pos, m = _position(mesh)
    return pos // m, len(ranks) // m


def model_rank_world(mesh) -> Tuple[int, int]:
    """This rank's index along the ``model`` axis and the axis's size;
    ``(0, 1)`` for a ``LocalMesh`` or no mesh."""
    if not is_distributed(mesh):
        return 0, 1
    _, pos, m = _position(mesh)
    return pos % m, m


def make_groups(mesh):
    """The data groups and the model groups of ``mesh``, made once for every
    rank in one order (every rank must call this at the same point, as
    ``make_mesh`` and ``make_hybrid_mesh`` do)."""
    import torch.distributed as dist

    ranks, _, m = _position(mesh)
    key = (tuple(ranks), m)
    if key not in _GROUPS:
        if m == 1 and ranks == list(range(dist.get_world_size())):
            data_groups = [dist.group.WORLD]
        else:
            data_groups = [dist.new_group(ranks[i::m]) for i in range(m)]
        model_groups = [dist.new_group(ranks[j * m:(j + 1) * m])
                        for j in range(len(ranks) // m)] if m > 1 else None
        _GROUPS[key] = (data_groups, model_groups)
    return _GROUPS[key]


def forget_groups() -> None:
    """Drop the groups made for meshes (the process group is gone)."""
    _GROUPS.clear()


def batch_group(mesh):
    """The process group of the batch axis: the data group, the ranks that
    share this rank's model index (the default group when ``model`` is 1
    and the mesh is the whole world in rank order)."""
    _, pos, m = _position(mesh)
    return make_groups(mesh)[0][pos % m]


def model_group(mesh):
    """The process group of the ``model`` axis: the ranks that share this
    rank's data index; None when the axis is 1."""
    _, pos, m = _position(mesh)
    groups = make_groups(mesh)[1]
    return None if groups is None else groups[pos // m]


def _placements(mesh, batch_dim: Optional[int]):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if (batch_dim is None or name == BATCH_EXCLUDED)
                 else Shard(batch_dim) for name in mesh.mesh_dim_names)


def batch_sharding(mesh):
    """Axis 0 (batch / items) sharded over every non-``model`` axis: on a
    ``(data, model)`` mesh ``(Shard(0), Replicate())``; on a hybrid
    ``(dcn, data, model)`` mesh (``parallel/distributed.py``) the batch axis
    spans nodes x local ranks."""
    return _placements(mesh, 0)


def stacked_batch_sharding(mesh):
    """A ``[accum_steps, batch, ...]`` microbatch stack: axis 1 is the batch
    axis, the accumulation axis replicates."""
    return _placements(mesh, 1)


def replicated_sharding(mesh):
    return _placements(mesh, None)
