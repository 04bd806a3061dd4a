"""Pretrained-backbone splicing, counterpart of
``visuelle2_tpu/models/pretrained.py``.

The reference's accuracy depends on torchvision-pretrained CNN weights.  They
are converted once, elsewhere, into an ``.npz`` of the flax layout
(``scripts/convert_pretrained.py``); one file serves both packages.
``splice_backbone`` loads such a tree into every submodule of a port model
named ``backbone`` (every image encoder names its CNN so: ``models/
encoders.py``, ``models/gtm_v1.py``, ``models/legacy.py``) through
``convert.load_jax_variables``, which is strict: every leaf is used once and
every shape must match.

The npz codec is the JAX module's: one flat npz whose keys are ``/``-joined
paths with the collection (``params`` / ``batch_stats``) as the first part.
The serving artifact (``eval/export.py``) writes its weights with it too.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
from torch import nn

from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables

BACKBONE = "backbone"


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten_variables(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``{collection: tree}`` -> the npz's flat ``collection/...`` keys."""
    flat: Dict[str, np.ndarray] = {}
    for coll, sub in variables.items():
        flat.update(flatten_tree(sub, coll))
    return flat


def unflatten_variables(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The flat ``collection/...`` keys -> ``{collection: tree}``."""
    grouped: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        coll, rest = key.split("/", 1)
        grouped.setdefault(coll, {})[rest] = v
    return {coll: unflatten_tree(sub) for coll, sub in grouped.items()}


def save_backbone_npz(variables: Dict[str, Any], path: str) -> None:
    """Write ``{collection: tree}`` as the npz.  Uncompressed (the JAX writer
    compresses: random-looking float32 weights shrink little and a
    ResNet-101 takes seconds); ``np.load`` reads either."""
    np.savez(path, **flatten_variables(variables))


def load_backbone_npz(file) -> Dict[str, Any]:
    """Load a converted-backbone .npz (a path or a file object) back into
    {'params', 'batch_stats'}; no pickle is read."""
    with np.load(file, allow_pickle=False) as z:
        return unflatten_variables({k: z[k] for k in z.files})


def _shapes(variables) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in flatten_variables(variables).items()}


def splice_backbone(model: nn.Module, backbone_variables: Dict[str, Any]) -> nn.Module:
    """Load ``backbone_variables`` into every ``backbone`` submodule of
    ``model`` (in place); returns ``model``.

    Raises ``ValueError`` when the model has no backbone (the image branch
    ablated) or when the tree does not match the backbone, naming a few of
    the missing, extra and mismatched leaves.  A tree without
    ``batch_stats`` keeps the model's own statistics, as the JAX splice does.
    """
    backbones = [mod for name, mod in model.named_modules()
                 if name.rsplit(".", 1)[-1] == BACKBONE]
    if not backbones:
        raise ValueError("model has no 'backbone' subtree to splice into "
                         "(image branch ablated?)")
    for mod in backbones:
        own = to_jax_variables(mod)
        stats = backbone_variables.get("batch_stats") or own.get("batch_stats")
        tree = {"params": backbone_variables["params"],
                **({"batch_stats": stats} if stats else {})}
        want, got = _shapes(own), _shapes(tree)
        if want != got:
            missing = set(want) ^ set(got)
            mismatched = {k for k in set(want) & set(got) if want[k] != got[k]}
            raise ValueError(
                "pretrained backbone does not match the model's backbone "
                f"(arch/dims differ?): missing/extra={sorted(missing)[:5]} "
                f"shape-mismatched={sorted(mismatched)[:5]}")
        load_jax_variables(mod, tree)
    return model
