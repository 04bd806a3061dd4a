"""The batch axis's collectives, and the data-parallel context the model
code reads.

In the JAX package a data-parallel step is the single-device program run
on a batch that is logically global, so every batch-wide quantity is
global.  With one process per device each rank holds a row block, and the
code that reduces over the batch has to say so:

* ``batch_statistics``-style moments (``models/resnet.py``): each rank's
  float32 ``(mean, n·var)`` combined across ranks by Chan's formula, in
  rank order, from one all-reduce (``combine_moments``);
* the dropout masks (``ops/dropout.py``): drawn for the global leading
  dimension from the step's generator, this rank's rows kept;
* the dedup image gather (``models/encoders.py``): each rank encodes its
  slot block, ``gather_rows`` assembles the global slot axis.

``data_parallel(mesh)`` sets the context for the model code inside it;
outside it, or at one rank, that code takes its single-device path, bit for
bit.  The context is process-wide, not thread-local: the CUDA autograd
engine runs a backward (and a ``--remat`` recomputation, which re-issues
the BatchNorm collectives) on its own thread, inside the trainer's
``data_parallel`` block.

``all_reduce_sum`` is an autograd function of the port's own: its backward
all-reduces the gradient, since every rank's loss reads the sum
(``torch.distributed.nn.functional.all_reduce`` is deprecated).

``gather_model_shards`` is the ``model`` axis's: the whole parameter from
each model rank's column block, for the sharded parameters of
``parallel/sharding.py``.  Its backward is this rank's block of the
incoming gradient, with no reduction: the model ranks of one data index
hold the same rows and compute the same whole gradient, so the
``all_reduce_sum`` backward would give ``model`` times it.

Every collective here is an ``all_reduce``, which gloo also runs over CUDA
tensors; a gather is one ``all_reduce`` of a zero-filled buffer holding
this rank's block (x + 0 is x, so it is exact).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch


class Shard(NamedTuple):
    group: object
    rank: int
    world: int


_ACTIVE: Optional[Shard] = None


@contextlib.contextmanager
def data_parallel(mesh):
    """Model code inside this block treats its batch as this rank's row
    block of a global batch over ``mesh``'s batch axis; a no-op at one rank."""
    global _ACTIVE
    from visuelle2_tpu_torch.parallel.mesh import batch_group, batch_rank_world

    rank, world = batch_rank_world(mesh)
    if world == 1:
        yield
        return
    previous, _ACTIVE = _ACTIVE, Shard(batch_group(mesh), rank, world)
    try:
        yield
    finally:
        _ACTIVE = previous


def active() -> Optional[Shard]:
    """The batch axis's group, rank and size inside ``data_parallel`` over
    more than one rank; None otherwise."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its backward is the
    all-reduce of the gradient."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``[world · n, ...]``: every rank's ``[n, ...]`` block in rank order,
    from one all-reduce of a zero-filled global buffer; the gradient reaches
    each rank's own block."""
    n = x.shape[0]
    before = x.new_zeros((shard.rank * n,) + x.shape[1:])
    after = x.new_zeros(((shard.world - shard.rank - 1) * n,) + x.shape[1:])
    return all_reduce_sum(torch.cat([before, x, after]), shard.group)


def combine_moments(mean: torch.Tensor, var: torch.Tensor, n: int, shard: Shard):
    """The global mean, biased variance and count from each rank's ``mean``
    and biased ``var`` over ``n`` elements (every rank's ``n`` equal: its
    batch has the same shape).  One all-reduce of a ``[world, 2, C]``
    float64 buffer holding each rank's ``(mean, n·var)`` in its row, then
    Chan's pairwise combine in rank order, the same on every rank;
    differentiable, float32 out."""
    local = torch.stack([mean.double(), var.double() * n])
    rows = gather_rows(local[None], shard)
    m, m2, count = rows[0, 0], rows[0, 1], n
    for r in range(1, shard.world):
        total = count + n
        delta = rows[r, 0] - m
        m = m + delta * (n / total)
        m2 = m2 + rows[r, 1] + delta * delta * (count * n / total)
        count = total
    return m.to(mean.dtype), (m2 / count).to(var.dtype), count


def select_global_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, idx)`` where ``idx`` indexes the global row axis
    of which ``x`` is this rank's block (a dedup batch's ``img_idx`` over
    the image slots): the blocks are gathered first inside
    ``data_parallel``."""
    if _ACTIVE is not None:
        x = gather_rows(x, _ACTIVE)
    return x.index_select(0, idx)


class _GatherModelShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, rank, world, group, stride):
        import torch.distributed as dist

        n = shard.shape[dim]
        ctx.dim, ctx.start, ctx.n = dim, rank * n, n
        shape = list(shard.shape)
        shape[dim] = n * world
        if stride is None:
            full = shard.new_zeros(shape)
        else:  # the whole tensor's own layout (a channels_last conv weight)
            full = torch.empty_strided(shape, stride, dtype=shard.dtype,
                                       device=shard.device).zero_()
        full.narrow(dim, rank * n, n).copy_(shard)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.n).clone(), None, None, None, None, None


def gather_model_shards(shard: torch.Tensor, dim: int, rank: int, world: int, group,
                        stride=None) -> torch.Tensor:
    """The whole tensor of which ``shard`` is block ``rank`` of ``world``
    along ``dim``, from the ranks of ``group`` (the model group), laid out
    with ``stride`` when given; its backward is this rank's block of the
    gradient (see the module docstring)."""
    return _GatherModelShards.apply(shard, dim, rank, world, group, stride)
