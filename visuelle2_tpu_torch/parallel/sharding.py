"""Tensor parallelism over the ``model`` axis, counterpart of
``visuelle2_tpu/parallel/sharding.py``.

The rule is the JAX one, decided on the JAX layout: a parameter (never a
BatchNorm statistic) whose flax leaf has rank at least 2 and a trailing dim
at least ``min_shard_dim`` wide and divisible by the ``model`` axis is split
along that dim over the axis; everything else replicates.  GRU recurrence
kernels (``w_i``, ``w_h``) always replicate: a split of their fused 3H gate
stack would cut across the gates (the JAX module says why).  The flax
layout of each port parameter comes from ``convert.py``'s bridge rules,
never from a name pattern, so the flax trailing dim is torch dim 0 of an
``nn.Linear`` weight (``[out, in]``) and of an ``nn.Conv2d`` weight (OIHW),
and the last dim of an ``nn.Embedding`` table and of an
``attention._Weights`` kernel (kept as flax's ``[in, out]``).

``infer_param_sharding`` gives ``{parameter name: torch dim or None}``;
``shard_module`` keeps this rank's block of each sharded parameter (the JAX
``shard_variables``).  A sharded parameter is read through a
``torch.nn.utils.parametrize`` parametrization, ``ModelShard``: the module
attribute (``conv.weight``, ``fusion.gate.kernel``) is the whole tensor,
gathered over the model group at each read
(``parallel/collectives.py::gather_model_shards``), and the trainable
tensor is the block, ``<module>.parametrizations.<name>.original``.  So no
model module changes: the CUDA kernels and cuDNN see whole local tensors,
``kernel[C:]`` cuts the gathered kernel, the bf16 backbone casts after the
gather.  The compute within a data group is replicated: what the model axis
divides is the parameters and the optimizer state at rest, not the
activations or the FLOPs.

``plain_state_dict`` gathers the model's state into the plain model's keys
and shapes (every rank of the model group calls it); ``load_plain_state_dict``
loads such a state, cutting each sharded parameter's block, so checkpoints
and artifacts are the unsharded model's whatever the mesh.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from visuelle2_tpu_torch import convert
from visuelle2_tpu_torch.parallel import mesh as mesh_lib
from visuelle2_tpu_torch.parallel.collectives import gather_model_shards

# Flax leaf names of ops/gru.py's GRUParams (the fused gate stacks).
RECURRENCE_LEAVES = frozenset({"w_i", "w_h"})
_PROBE_SIZES = (2, 3, 5, 7, 11, 13)  # distinct sizes: a dim is known by its size
_SHARDED_KEY = re.compile(r"^(.*?)parametrizations\.([^.]+)\.original$")


class ShardSpec(NamedTuple):
    """A sharded parameter: split along torch dim ``dim`` of
    ``global_shape`` into ``world`` blocks, this rank holding block
    ``rank``, gathered over ``group`` into the whole parameter's layout,
    ``global_stride`` (a channels_last convolution weight stays one, so the
    convolutions see the plain model's tensors)."""
    dim: int
    global_shape: tuple
    rank: int
    world: int
    group: object
    global_stride: tuple


class ModelShard(nn.Module):
    """The parametrization of a sharded parameter: it stores this rank's
    block (``right_inverse``) and reads as the gathered whole
    (``forward``)."""

    def __init__(self, spec: ShardSpec):
        super().__init__()
        self.spec = spec

    def forward(self, block):
        s = self.spec
        return gather_model_shards(block, s.dim, s.rank, s.world, s.group, s.global_stride)

    def right_inverse(self, whole):
        s = self.spec
        n = s.global_shape[s.dim] // s.world
        return whole.detach().narrow(s.dim, s.rank * n, n).clone()


def jax_trailing_dim(transform, ndim: int) -> int:
    """The torch dim that a bridge ``transform`` (``convert._RULES``) maps
    to the flax leaf's trailing dim, for a parameter of rank ``ndim``."""
    probe = np.empty(_PROBE_SIZES[:ndim], np.int8)
    return _PROBE_SIZES.index(convert._INVERSE[transform](probe).shape[-1])


def _shard_of(mod: nn.Module, attr: str) -> Optional[ModelShard]:
    if not parametrize.is_parametrized(mod, attr):
        return None
    return next((p for p in mod.parametrizations[attr] if isinstance(p, ModelShard)), None)


def _bridged_params(model: nn.Module):
    """``(name, module, attribute, flax leaf, transform, whole shape)`` of
    every parameter the bridge maps to a flax ``params`` leaf."""
    for mod_name, mod in model.named_modules():
        rules = convert._rules_for(mod)
        if rules is None:
            continue
        for col, leaf, attr, transform in rules:
            if col != "params":
                continue
            shard = _shard_of(mod, attr)
            if shard is not None:
                shape = shard.spec.global_shape
            elif mod._parameters.get(attr) is not None:
                shape = tuple(mod._parameters[attr].shape)
            else:
                continue  # a bias-free layer
            yield (f"{mod_name}.{attr}" if mod_name else attr), mod, attr, leaf, transform, shape


def infer_param_sharding(model: nn.Module, mesh, min_shard_dim: int = 64
                         ) -> Dict[str, Optional[int]]:
    """``{parameter name: the torch dim split over the model axis, or None
    (replicated)}`` for every parameter of ``model`` (plain names, sharded
    or not), by the JAX rule (see the module docstring)."""
    m = mesh_lib.model_size(mesh)
    out = {}
    for name, _, _, leaf, transform, shape in _bridged_params(model):
        dim = None
        if m > 1 and len(shape) >= 2 and leaf not in RECURRENCE_LEAVES:
            d = jax_trailing_dim(transform, len(shape))
            if shape[d] >= min_shard_dim and shape[d] % m == 0:
                dim = d
        out[name] = dim
    return out


def shard_module(model: nn.Module, mesh, min_shard_dim: int = 64) -> Dict[str, int]:
    """Keep this rank's block of every parameter ``infer_param_sharding``
    splits (in place; the parameter objects stay, holding the block);
    returns ``{name: dim}`` of the sharded ones.  A no-op at ``model`` 1."""
    dims = infer_param_sharding(model, mesh, min_shard_dim)
    sharded = {n: d for n, d in dims.items() if d is not None}
    if not sharded:
        return {}
    if is_sharded(model):
        raise ValueError("the model is sharded already")
    rank, world = mesh_lib.model_rank_world(mesh)
    group = mesh_lib.model_group(mesh)
    order = list(model.parameters())
    for name, _, mod, attr in _named(model, sharded):
        whole = mod._parameters[attr]
        spec = ShardSpec(sharded[name], tuple(whole.shape), rank, world, group,
                         tuple(whole.stride()))
        # unsafe: no trial read, which would be a collective.
        parametrize.register_parametrization(mod, attr, ModelShard(spec), unsafe=True)
    model._plain_parameter_order = order
    return sharded


def _named(model, names):
    for name in names:
        mod_name, _, attr = name.rpartition(".")
        yield name, mod_name, model.get_submodule(mod_name), attr


def is_sharded(model: nn.Module) -> bool:
    return any(isinstance(m, ModelShard) for m in model.modules())


def plain_parameter_order(model: nn.Module) -> list:
    """``model``'s parameters in the plain model's order (a sharded block
    where the plain model has the whole parameter)."""
    return list(getattr(model, "_plain_parameter_order", None) or model.parameters())


def parameter_shards(model: nn.Module) -> Dict[nn.Parameter, ShardSpec]:
    """Each sharded parameter (the block) with its spec: what
    ``train/optim.py::Adafactor`` takes as ``shards``."""
    out = {}
    for mod in model.modules():
        if parametrize.is_parametrized(mod):
            for attr, plist in mod.parametrizations.items():
                shard = _shard_of(mod, attr)
                if shard is not None:
                    out[plist.original] = shard.spec
    return out


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Inside this block each sharded parameter of ``model`` is gathered
    once, on entry (every rank of the model group enters it), and read from
    that copy: for passes that do not change the weights (scoring).  A no-op
    for an unsharded model."""
    if not is_sharded(model):
        yield
        return
    with parametrize.cached():
        for mod in model.modules():
            if isinstance(mod, ModelShard):
                continue
            if parametrize.is_parametrized(mod):
                for attr in mod.parametrizations:
                    getattr(mod, attr)
        yield


def plain_name(name: str) -> str:
    """A parameter's or state key's plain name (``a.parametrizations.w.original``
    -> ``a.w``)."""
    m = _SHARDED_KEY.match(name)
    return name if m is None else m.group(1) + m.group(2)


def plain_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with the plain model's keys and the whole
    tensors, gathered over the model group: every rank of it calls this."""
    sd = model.state_dict()
    if not is_sharded(model):
        return sd
    out = {}
    with torch.no_grad():
        for key, value in sd.items():
            m = _SHARDED_KEY.match(key)
            if m is None:
                out[key] = value
                continue
            mod = model.get_submodule(m.group(1).rstrip("."))
            out[m.group(1) + m.group(2)] = getattr(mod, m.group(2)).detach()
    return out


def load_plain_state_dict(model: nn.Module, sd: dict) -> None:
    """``model.load_state_dict`` of a plain model's state (strict): each
    sharded parameter takes this rank's block."""
    if not is_sharded(model):
        model.load_state_dict(sd)
        return
    target = {}
    for key, value in sd.items():
        mod_name, _, attr = key.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        shard = _shard_of(mod, attr)
        if shard is None:
            target[key] = value
        else:
            prefix = f"{mod_name}." if mod_name else ""
            target[f"{prefix}parametrizations.{attr}.original"] = shard.right_inverse(value)
    model.load_state_dict(target)


def resident_bytes(model: nn.Module, optimizer=None) -> int:
    """The bytes this rank holds of the parameters (blocks where sharded)
    and, with ``optimizer``, of its state tensors."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    if optimizer is not None:
        total += sum(t.numel() * t.element_size() for st in optimizer.state.values()
                     for t in st.values() if torch.is_tensor(t))
    return total
