"""Data parallelism over ``torch.distributed``, counterpart of
``visuelle2_tpu/parallel/``: meshes and placements (``mesh.py``),
initialization and hybrid meshes (``distributed.py``), the batch axis's
collectives (``collectives.py``) and the two-process demo
(``demo_multihost.py``).  Tensor parallelism (the JAX ``sharding.py``:
``infer_param_sharding``, ``shard_variables``) is ROADMAP Queue 1 item 12b."""

from visuelle2_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicated_sharding

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding"]
