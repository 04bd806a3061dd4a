"""Data and tensor parallelism over ``torch.distributed``, counterpart of
``visuelle2_tpu/parallel/``: meshes and placements (``mesh.py``),
initialization and hybrid meshes (``distributed.py``), the collectives of
the batch and model axes (``collectives.py``), the sharding rule of the
``model`` axis (``sharding.py``: ``infer_param_sharding``, ``shard_module``;
imported from there, since it reads the model bridge) and the
multi-process demo (``demo_multihost.py``)."""

from visuelle2_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicated_sharding

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding"]
