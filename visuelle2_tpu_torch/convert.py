"""Weight bridge: a flax ``variables`` tree into a port module.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (copy them out of JAX with ``np.array``).  Port modules carry
the JAX module names, so a torch module at ``a.b`` reads the flax subtree
``a/b``; what it reads is fixed by its type:

==========================  =================================  ===========================
torch module                flax leaves                        transform
==========================  =================================  ===========================
``nn.Linear``               ``kernel [in, out]``, ``bias``     weight = kernel.T
``nn.Conv2d``               ``kernel`` HWIO, ``bias``          weight = OIHW
``nn.Embedding``            ``embedding``                      as is
``nn.LayerNorm``            ``scale``, ``bias``                weight, bias
``resnet.BatchNorm``,       ``scale``, ``bias`` + batch_stats  weight, bias,
``norms.BatchNorm1d``       ``mean``, ``var``                  running_mean, running_var
``gru.GRU``,                ``w_i``, ``w_h``, ``b_i``, ``b_h``  as is (JAX layout)
``gru.GRUCellModule``
``attention._Weights``      ``kernel [in, out]``, ``bias``     as is (JAX layout)
==========================  =================================  ===========================

The bridge is strict: every torch parameter and persistent buffer is assigned
exactly once and every JAX leaf is consumed; a leftover on either side, or a
shape mismatch, raises.  Every parameter is float32, as the JAX package's
``param_dtype``: the bf16 backbone keeps float32 masters and casts them on
each call (``models/resnet.py::Conv2d``), so a copy rounds nothing.

``to_jax_variables`` is the way back: the port's parameters and statistics as
a flax-layout numpy tree, for comparing the two frameworks leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch.models.norms import BatchNorm1d
from visuelle2_tpu_torch.models.resnet import BatchNorm
from visuelle2_tpu_torch.ops.attention import _Weights
from visuelle2_tpu_torch.ops.gru import GRUParams


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _t(a):
    return a.T


def _hwio_to_oihw(a):
    return np.transpose(a, (3, 2, 0, 1))


def _same(a):
    return a


def _oihw_to_hwio(a):
    return np.transpose(a, (2, 3, 1, 0))


# Each forward transform's inverse.
_INVERSE = {_t: _t, _hwio_to_oihw: _oihw_to_hwio, _same: _same}


# torch module type -> [(collection, flax leaf, torch attribute, transform)]
_RULES = (
    (nn.Linear, [("params", "kernel", "weight", _t), ("params", "bias", "bias", _same)]),
    (nn.Conv2d, [("params", "kernel", "weight", _hwio_to_oihw),
                 ("params", "bias", "bias", _same)]),
    (nn.Embedding, [("params", "embedding", "weight", _same)]),
    (nn.LayerNorm, [("params", "scale", "weight", _same), ("params", "bias", "bias", _same)]),
    ((BatchNorm, BatchNorm1d), [("params", "scale", "weight", _same),
                                ("params", "bias", "bias", _same),
                                ("batch_stats", "mean", "running_mean", _same),
                                ("batch_stats", "var", "running_var", _same)]),
    (GRUParams, [("params", n, n, _same) for n in ("w_i", "w_h", "b_i", "b_h")]),
    (_Weights, [("params", "kernel", "kernel", _same), ("params", "bias", "bias", _same)]),
)


def _rules_for(mod: nn.Module):
    for cls, rules in _RULES:
        if isinstance(mod, cls):
            return rules
    return None


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy a flax variables tree into ``model`` (in place); returns it."""
    leaves = {col: _flatten(variables.get(col, {})) for col in ("params", "batch_stats")}
    extra_cols = set(variables) - set(leaves)
    if extra_cols:
        raise ValueError(f"unexpected variable collections: {sorted(extra_cols)}")
    consumed = set()
    state = {}
    for mod_name, mod in model.named_modules():
        own = [n for n, _ in mod.named_parameters(recurse=False)]
        own += [n for n, _ in mod.named_buffers(recurse=False)
                if n not in mod._non_persistent_buffers_set]
        rules = _rules_for(mod)
        if rules is None:
            if own:
                raise TypeError(f"no bridge rule for {type(mod).__name__} at "
                                f"{mod_name!r} (holds {own})")
            continue
        path = tuple(mod_name.split(".")) if mod_name else ()
        for col, leaf, attr, transform in rules:
            if getattr(mod, attr, None) is None:
                continue  # e.g. a bias-free conv or Dense
            key = (col, path + (leaf,))
            if key[1] not in leaves[col]:
                raise KeyError(f"JAX variables lack {col}/{'/'.join(key[1])} "
                               f"for {mod_name}.{attr}")
            consumed.add(key)
            target = f"{mod_name}.{attr}" if mod_name else attr
            value = transform(leaves[col][key[1]])
            want = tuple(getattr(mod, attr).shape)
            if value.shape != want:
                raise ValueError(f"{col}/{'/'.join(key[1])}: JAX shape {value.shape} "
                                 f"-> {target} wants {want}")
            state[target] = torch.from_numpy(np.ascontiguousarray(value))
    leftover = sorted("/".join((col,) + p) for col in leaves for p in leaves[col]
                      if (col, p) not in consumed)
    if leftover:
        raise ValueError(f"JAX leaves not consumed by the port: {leftover}")
    model.load_state_dict(state, strict=True)
    return model


def to_jax_variables(model: nn.Module) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of ``model`` as nested dicts
    of float32 numpy arrays in the flax layout: ``load_jax_variables``'s
    inverse."""
    out = {"params": {}, "batch_stats": {}}
    for mod_name, mod in model.named_modules():
        rules = _rules_for(mod)
        if rules is None:
            continue
        path = tuple(mod_name.split(".")) if mod_name else ()
        for col, leaf, attr, transform in rules:
            value = getattr(mod, attr, None)
            if value is None:
                continue
            node = out[col]
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = np.ascontiguousarray(
                _INVERSE[transform](value.detach().float().cpu().numpy()))
    return {col: tree for col, tree in out.items() if tree}
