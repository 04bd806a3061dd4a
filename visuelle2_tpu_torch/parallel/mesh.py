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
* ``model`` — tensor parallelism, not ported yet: ``model > 1`` raises
  ``NotImplementedError`` naming ROADMAP Queue 1 item 12b, never running
  replicated in silence.

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
TENSOR_PARALLEL_ITEM = "ROADMAP Queue 1 item 12b (tensor parallelism)"


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


def refuse_tensor_parallel(model: int) -> None:
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism over the 'model' axis is not ported "
            f"yet ({TENSOR_PARALLEL_ITEM}); the port refuses rather than run "
            f"replicated")


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

    refuse_tensor_parallel(model)
    if not (dist.is_available() and dist.is_initialized()):
        n = 1 if world is None else int(world)
        if n != 1 or data not in (None, 1):
            raise ValueError(f"mesh {data}x{model} over {n} ranks, but no process group "
                             f"is initialized (parallel.distributed.initialize)")
        return LocalMesh(device_type=device_type or "cpu")
    size = dist.get_world_size()
    n = size if world is None else int(world)
    if n != size:
        raise ValueError(f"world={n}, but the process group has {size} ranks")
    data = n // model if data is None else data
    if data * model != n:  # a real raise: python -O strips asserts
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type or _default_device_type(),
                      torch.arange(n).reshape(data, model), mesh_dim_names=AXES)


def is_distributed(mesh) -> bool:
    """Whether ``mesh`` is over a process group (a ``DeviceMesh``), so the
    collectives run, at one rank as at many."""
    return mesh is not None and not isinstance(mesh, LocalMesh)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}``, as ``dict(jax_mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def batch_rank_world(mesh) -> Tuple[int, int]:
    """This rank's index along the batch axis (every non-``model`` axis,
    outermost first) and the axis's size; ``(0, 1)`` for a ``LocalMesh`` or
    no mesh."""
    if not is_distributed(mesh):
        return 0, 1
    refuse_tensor_parallel(mesh_shape(mesh).get(BATCH_EXCLUDED, 1))
    import torch.distributed as dist

    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def batch_group(mesh):
    """The process group of the batch axis: the default group, which the
    mesh must span (the ``model`` axis is 1)."""
    import torch.distributed as dist

    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh's ranks {ranks} are not the whole world in order")
    return dist.group.WORLD


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
