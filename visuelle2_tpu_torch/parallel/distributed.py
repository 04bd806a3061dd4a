"""Multi-process initialization and hybrid meshes, counterpart of
``visuelle2_tpu/parallel/distributed.py``.

PyTorch's idiom is one process per device, so a rank is a process and a
device at once.  Topology model, as in the JAX package:

* ``dcn``   — the node axis; the gradient's all-reduce crosses it.
* ``data``  — the ranks within a node (batch parallelism).
* ``model`` — tensor parallelism, innermost: the ranks of one data index
  share its rows, each holding a column block of the sharded parameters
  (``parallel/sharding.py``), so the gathers stay within a node.

Batches are fed rank-locally: each rank assembles only its own rows of the
global batch (the ``model`` ranks of one data index the same rows) (``data/loader.py``'s ``rank``/``world``, or ``global_batch`` /
``shard_batch`` over a host batch), so no process holds the whole batch,
and the trainer keeps every batch-wide quantity global
(``parallel/collectives.py``, ``train/loop.py``).

``initialize()`` with no address reads a launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``: what
``torchrun`` sets), the counterpart of ``jax.distributed.initialize()``'s
autodiscovery; with an address it joins ``tcp://address``.  The backend is
NCCL for ``cuda`` and gloo for ``cpu``; gloo also runs over CUDA tensors
(``broadcast`` and ``all_reduce`` only, each waiting on the host), which
lets two ranks share one card in a check, where NCCL refuses.  The JAX
``cpu_devices_per_process`` has no counterpart: a process here owns one
device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_DEVICE: Optional[torch.device] = None  # this rank's device, set by initialize
_LAUNCHER_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def current_device() -> Optional[torch.device]:
    """The device ``initialize`` bound this rank to (None before it)."""
    return _DEVICE


def is_main_process() -> bool:
    """Rank 0 of the process group, or the only process: the one that
    writes files and prints result lines."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def launched_world_size() -> int:
    """``WORLD_SIZE`` from a launcher's environment, 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _bind_device(device: str, backend: str, local_rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    from visuelle2_tpu_torch._device import resolve_device

    resolve_device()  # raises without a card
    count = torch.cuda.device_count()
    if local_rank >= count and backend != "gloo":
        raise ValueError(f"LOCAL_RANK={local_rank} but this node has {count} CUDA "
                         f"device(s); NCCL needs one device a rank")
    # gloo: ranks past the node's cards share them (a check on one card).
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[str] = None,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group and bind this rank's device; returns it.

    ``device``: ``cuda`` (the default; raises without a card) or ``cpu``.
    ``backend``: ``nccl`` for ``cuda`` and ``gloo`` for ``cpu`` unless given.
    With no ``coordinator_address`` the launcher's environment gives the
    coordinates, and explicit ``num_processes`` / ``process_id`` must agree
    with it; with one, ``num_processes`` and ``process_id`` are required,
    and a launcher's ``WORLD_SIZE``, where set, must agree.  Each rank binds
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the rank)."""
    global _DEVICE
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    device = device or "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: cuda or cpu")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    env_world = os.environ.get("WORLD_SIZE")
    if coordinator_address is None:
        missing = [k for k in _LAUNCHER_KEYS if k not in os.environ]
        if missing:
            raise ValueError(f"no coordinator_address and no launcher environment "
                             f"(missing {', '.join(missing)})")
        world, rank = int(env_world), int(os.environ["RANK"])
        if num_processes is not None and num_processes != world:
            raise ValueError(f"num_processes={num_processes} but WORLD_SIZE={world}")
        if process_id is not None and process_id != rank:
            raise ValueError(f"process_id={process_id} but RANK={rank}")
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
        if env_world is not None and int(env_world) != world:
            raise ValueError(f"num_processes={world} but the environment's "
                             f"WORLD_SIZE={env_world}")
        init_method = f"tcp://{coordinator_address}"
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = _bind_device(device, backend, int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _DEVICE = dev
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE
    import torch.distributed as dist

    from visuelle2_tpu_torch.parallel.mesh import forget_groups

    if dist.is_initialized():
        forget_groups()
        dist.destroy_process_group()
    _DEVICE = None


def make_hybrid_mesh(model: int = 1, nodes: Optional[int] = None):
    """``(dcn, data, model)`` mesh over every rank, node-major, ``dcn`` the
    nodes; ``nodes`` defaults to ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (one node
    without ``LOCAL_WORLD_SIZE``).

    The ranks must divide into the nodes and each node's ranks by ``model``,
    and each node's ranks must be contiguous (rank = node · per + local
    rank), since rank-local feeding relies on each rank owning a contiguous
    row block in node-major order; checked on every rank together (one
    all-reduce of the local ranks), so every rank raises alike."""
    import torch.distributed as dist

    from visuelle2_tpu_torch.parallel import mesh as mesh_lib

    if not dist.is_initialized():
        if model != 1 or nodes not in (None, 1):
            raise ValueError(f"model={model}, nodes={nodes}, but no process group is "
                             f"initialized: one process holds one device")
        return mesh_lib.LocalMesh(("dcn",) + mesh_lib.AXES)
    world, rank = dist.get_world_size(), dist.get_rank()
    if nodes is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world <= 0 or world % local_world:
            raise ValueError(f"{world} ranks not divisible into nodes of "
                             f"LOCAL_WORLD_SIZE={local_world}")
        nodes = world // local_world
    # Real raises, not asserts (python -O strips them).
    if model < 1 or nodes <= 0 or world % nodes or (world // nodes) % model:
        raise ValueError(f"{world} ranks / {nodes} nodes not divisible by model={model}")
    per = world // nodes
    dev = _DEVICE or torch.device("cpu")
    layout = torch.zeros(world, dtype=torch.float64, device=dev)
    layout[rank] = float(os.environ.get("LOCAL_RANK", rank % per))
    dist.all_reduce(layout)
    local = [int(v) for v in layout.tolist()]
    if local != [r % per for r in range(world)]:
        raise ValueError(f"ranks not node-major: local ranks {local} over {nodes} nodes "
                         f"of {per}; the dcn axis would cross node boundaries")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(dev.type, torch.arange(world).reshape(nodes, per // model, model),
                      mesh_dim_names=("dcn",) + mesh_lib.AXES)
    mesh_lib.make_groups(mesh)
    return mesh


def global_batch(batch, mesh):
    """This rank's rows of the host batch ``batch`` (logically global), on
    its device: ``data/loader.py::shard_batch``.  At one rank it is the
    whole batch, moved as ``train.loop.to_device`` moves it."""
    from visuelle2_tpu_torch.data.loader import shard_batch

    return shard_batch(batch, mesh, device=_DEVICE)
