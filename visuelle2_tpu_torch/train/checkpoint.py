"""Checkpoints keyed on the lowest ``val_wWAPE``, counterpart of
``visuelle2_tpu/train/checkpoint.py`` (orbax there, ``torch.save`` here).

The directory layout is the JAX manager's: ``<dir>/<epoch>/`` for each kept
epoch (the ``save_top_k`` best by the monitor; the rest are deleted) and
``<dir>/last/`` for the most recent state, which also records the epoch the
next ``fit`` starts at (``fit_epoch``) and how many of its updates the state
already holds (``fit_skip``, non-zero after a mid-epoch save on SIGTERM or
autosave).  The top-k retention may delete every epoch after the best one;
the ``last`` slot is what a resume reads.

A slot holds ``state.pt``: the plain model's state dict (parameters and
BatchNorm statistics), the optimizer's state dict in the whole parameters'
layout and the global step (``plain_payload``: a model sharded over a
``model`` axis is gathered, and a restore cuts each rank's block back out,
so a checkpoint moves between mesh shapes), plus
``fit_epoch`` / ``fit_skip`` in ``last``; an epoch slot also holds its
metrics (``metrics.json``).  Each file is written under a temporary name and
renamed into place, the state last, so a save cut by a signal or a crash
never leaves a slot that ``restore_latest`` would pick, and the previous
``last`` stays until the new one is in place.  Saves are synchronous
(``wait_until_finished`` is a no-op kept for the JAX API).  A directory
written by the JAX package (orbax) raises a ``ValueError`` naming the
format.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

MONITOR = "val_wWAPE"  # the lowest is the best
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
LAST = "last"
# Files orbax writes into a step directory.
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "default")


def resolve_ckpt_path(path: str):
    """A manager root or a step directory (what ``best_model_path`` returns)
    -> ``(root, step or None)``."""
    path = os.path.abspath(path)
    base = os.path.basename(path)
    if base.isdigit():
        return os.path.dirname(path), int(base)
    return path, None


def _check_not_orbax(slot: str) -> None:
    if os.path.isdir(slot) and not os.path.isfile(os.path.join(slot, STATE_FILE)):
        entries = set(os.listdir(slot))
        if entries & set(_ORBAX_MARKERS) or any(e.isdigit() for e in entries):
            raise ValueError(
                f"{slot} is an orbax checkpoint written by the JAX package "
                f"(visuelle2_tpu); the port reads only its own torch.save checkpoints "
                f"({STATE_FILE}) — train with the port, or convert the weights with "
                f"convert.load_jax_variables")


def _replace_file(path: str, write) -> None:
    """``write(tmp)`` then rename ``tmp`` over ``path``: a reader sees the
    old file or the new one, never a part."""
    tmp = f"{path}.tmp-{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def _atomic_save(payload, slot: str, metrics: Optional[Dict] = None) -> None:
    """Write ``payload`` (and ``metrics``) into the slot directory ``slot``;
    the state file goes in last, so a cut save leaves no slot that counts."""
    os.makedirs(slot, exist_ok=True)
    if metrics is not None:
        def write_metrics(tmp):
            with open(tmp, "w") as f:
                json.dump(metrics, f, indent=1, sort_keys=True)

        _replace_file(os.path.join(slot, METRICS_FILE), write_metrics)
    _replace_file(os.path.join(slot, STATE_FILE), lambda tmp: torch.save(payload, tmp))


def plain_payload(state) -> dict:
    """What a slot holds of ``state``: the plain model's state dict, the
    optimizer's in the whole parameters' layout and the step.  Under tensor
    parallelism the sharded tensors are gathered, so every rank of the
    model group calls this for each save (``train/loop.py``)."""
    from visuelle2_tpu_torch.parallel import sharding

    optimizer = state.optimizer
    return {"model": sharding.plain_state_dict(state.model),
            "optimizer": (optimizer.plain_state_dict() if hasattr(optimizer, "plain_state_dict")
                          else optimizer.state_dict()),
            "step": int(state.step)}


class CheckpointManager:
    def __init__(self, directory: str, *, save_top_k: int = 2, save_last: bool = True,
                 read_only: bool = False):
        """``read_only=True`` for restore-only use (forecast CLIs, resume
        sources): nothing is created or changed, and a missing directory
        raises ``FileNotFoundError``."""
        directory = os.path.abspath(directory)
        self.read_only = bool(read_only)
        if read_only:
            if not os.path.isdir(directory):
                raise FileNotFoundError(f"{directory}: no such checkpoint directory")
        else:
            os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.save_top_k = save_top_k
        self.save_last = save_last
        for name in os.listdir(directory):
            if name.isdigit() or name == LAST:
                _check_not_orbax(os.path.join(directory, name))

    # -------------------------------------------------------------- layout
    def _slot(self, epoch) -> str:
        return os.path.join(self.directory, str(epoch))

    @property
    def _last_slot(self) -> str:
        return os.path.join(self.directory, LAST)

    def _epochs(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self._slot(n), STATE_FILE)))

    def metrics(self, epoch: int) -> Optional[Dict]:
        path = os.path.join(self._slot(epoch), METRICS_FILE)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _rank_key(self, epoch):
        value = float((self.metrics(epoch) or {}).get(MONITOR, math.nan))
        return (math.inf if math.isnan(value) else value), epoch

    def _writable(self):
        if self.read_only:
            raise ValueError("CheckpointManager is read_only")

    # --------------------------------------------------------------- saves
    def save(self, epoch: int, state, metrics: Dict[str, float]):
        """The epoch's slot (kept while among the top k) and the ``last``
        slot pointing at ``epoch + 1``."""
        self._writable()
        payload = plain_payload(state)
        _atomic_save(payload, self._slot(epoch),
                     {k: float(v) for k, v in metrics.items() if k != "epoch"})
        ranked = sorted(self._epochs(), key=self._rank_key)
        for stale in ranked[self.save_top_k:]:
            shutil.rmtree(self._slot(stale), ignore_errors=True)
        if self.save_last:
            self._save_last(payload, fit_epoch=epoch + 1)

    def _save_last(self, payload, fit_epoch: int, fit_skip: int = 0):
        _atomic_save(dict(payload, fit_epoch=int(fit_epoch), fit_skip=int(fit_skip)),
                     self._last_slot)

    def save_preempted(self, epoch: int, state, steps_into_epoch: int = 0):
        """A save at a step boundary inside ``epoch`` (SIGTERM or autosave):
        the ``last`` slot only, resuming at this epoch after
        ``steps_into_epoch`` updates."""
        if not self.save_last:
            raise ValueError("save_preempted requires save_last=True")
        self._writable()
        self._save_last(plain_payload(state), fit_epoch=epoch, fit_skip=steps_into_epoch)

    def wait_until_finished(self):
        """Saves are synchronous: nothing to wait for."""

    # ------------------------------------------------------------- queries
    def best_step(self) -> Optional[int]:
        epochs = self._epochs()
        return min(epochs, key=self._rank_key) if epochs else None

    def best_metric(self) -> Optional[Tuple[int, float]]:
        """(best epoch, its monitor value), or None when nothing is saved."""
        step = self.best_step()
        if step is None:
            return None
        metrics = self.metrics(step)
        if metrics is None or MONITOR not in metrics:
            return None
        return step, float(metrics[MONITOR])

    def latest_step(self) -> Optional[int]:
        """The newest kept epoch."""
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    @property
    def best_model_path(self) -> Optional[str]:
        step = self.best_step()
        return None if step is None else self._slot(step)

    # ------------------------------------------------------------ restores
    def _load(self, slot: str) -> dict:
        _check_not_orbax(slot)
        path = os.path.join(slot, STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{slot}: no checkpoint")
        return torch.load(path, map_location="cpu", weights_only=True)

    @staticmethod
    def _apply(state, payload):
        from visuelle2_tpu_torch.parallel import sharding

        sharding.load_plain_state_dict(state.model, payload["model"])
        optimizer = state.optimizer
        if hasattr(optimizer, "load_plain_state_dict"):
            optimizer.load_plain_state_dict(payload["optimizer"])
        else:
            optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def restore_latest(self, state) -> Tuple[object, int, int]:
        """The most recent state for a resume: ``(state, start_epoch,
        skip_steps)``, from the ``last`` slot, else the newest kept epoch."""
        if os.path.isfile(os.path.join(self._last_slot, STATE_FILE)):
            payload = self._load(self._last_slot)
            return (self._apply(state, payload), int(payload["fit_epoch"]),
                    int(payload["fit_skip"]))
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"{self.directory}: no checkpoints to resume from")
        return self._apply(state, self._load(self._slot(step))), step + 1, 0

    def restore_for_eval(self, model, step: Optional[int] = None):
        """Parameters and buffers only (no optimizer), into ``model``, from
        epoch ``step`` (the best by default); returns ``model``."""
        step = self.best_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"{self.directory}: no checkpoints")
        from visuelle2_tpu_torch.parallel import sharding

        sharding.load_plain_state_dict(model, self._load(self._slot(step))["model"])
        return model
