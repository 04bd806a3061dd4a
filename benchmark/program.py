"""The system under test: the port's model built through its normal entry
point (``models.registry.build``) from a configuration file, with the
benchmark's weights copied in, then the configuration's preparation steps.
The only file of the harness, with the drivers and the steps, that imports
the port.

A configuration names its steps after the weights are in (a quantisation
and its calibration, say) as ``"prepare": [{"step": <name>, ...}]``, each
a file ``prepare/<name>.py`` whose ``apply(model, step, ctx)`` runs in
order; ``ctx`` holds the ``device``, the ``seed`` and the cell's
``products``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import weights as W


def build_model(config: dict, device, *, train: bool = False, overrides: dict = None):
    """The registry model of ``config`` on ``device``, in eval mode; with
    ``train`` the training build arguments of ``config["train"]["build"]``
    (teacher forcing, say) are added.  ``overrides`` replace build
    arguments (the CPU rehearsal's tiny backbone)."""
    from visuelle2_tpu_torch.models.base import VocabSizes
    from visuelle2_tpu_torch.models.registry import build

    kw = {k: v for k, v in config["model"].items() if k != "registry"}
    if train:
        kw.update(config.get("train", {}).get("build", {}))
    kw["vocab"] = VocabSizes(**config["vocab"])
    kw["image_dtype"] = getattr(torch, config["image_dtype"])
    kw.update(overrides or {})
    return build(config["model"]["registry"], device=device, **kw)


def reference_model(config: dict, *, train: bool = False, overrides: dict = None) -> dict:
    """The ``model`` block the reference reads, as the program was built."""
    m = dict(config["model"])
    if train:
        m.update(config.get("train", {}).get("build", {}))
    m.update(overrides or {})
    return m


def load_weights(model, config: dict, seed: int, device) -> None:
    W.load_into(model, W.draw(W.layout_of(model), seed, config.get("init", []), device))


def module(model, path: str):
    mod = model
    for part in path.split("."):
        mod = getattr(mod, part)
    return mod


PREPARE = Path(__file__).resolve().parent / "prepare"


def prepare(model, config: dict, ctx: dict):
    """Run the configuration's preparation steps on ``model`` in order;
    returns the model a step hands back (or the same one)."""
    from benchmark import core

    for step in config.get("prepare", []):
        path = PREPARE / f"{step['step']}.py"
        if not path.is_file():
            raise KeyError(f"no preparation step {step['step']!r}: add {path}")
        mod = core.load_file(path, "benchmark_prepare_" + step["step"])
        model = mod.apply(model, step, ctx) or model
    return model
