"""Training and evaluation loops, counterpart of ``visuelle2_tpu/train/loop.py``.

* ``Trainer.train_step``: one forward, backward and update on the model's
  device — the train-mode forward (dropout masks from a generator derived
  from ``(seed + 1000, step)``, BatchNorm batch statistics), the masked MSE,
  ``loss.backward()``, then ``Adafactor`` (global-norm clip first, the
  backbone freeze split).  No host sync: the loss stays a device tensor
  until ``fit`` averages an epoch's.
* ``Trainer.accum_train_step``: the gradients of ``accum_steps``
  microbatches at the same parameters, averaged, one update; BatchNorm
  statistics move microbatch by microbatch.
* ``Trainer.evaluate``: masked partial metric sums on the device, in
  float64 as ``eval/forecast.py::score_split`` keeps them; one host sync.
* ``Trainer.fit``: epochs with ``set_epoch``, a mid-epoch skip for a resume,
  autosave, a save at a step boundary on SIGTERM, a halt on a non-finite
  epoch loss, early stopping on ``val_wWAPE``, the per-epoch ``lr``, and a
  ``torch.profiler`` trace of the second step behind ``trace_dir``.

A ``TrainState`` holds the model (parameters and BatchNorm statistics), the
optimizer and the global step; the step functions update it in place and
return it, as the JAX ones return a new one.  The parity runs turn dropout
off everywhere by calling the steps inside ``ops.dropout.disabled()``.  The
data-parallel and tensor-parallel options of the JAX config arrive with
ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch.ops.metrics import eval_metrics, finalize_metrics
from visuelle2_tpu_torch.train import optim as optim_lib

SUM_KEYS = ("abs_err", "abs_gt", "count", "rows")  # eval_metrics' partial sums
DROPOUT_SEED_OFFSET = 1000  # the JAX fit's rng = key(seed + 1000)


def target_and_pred(batch, forecast: torch.Tensor):
    """Align the target with a model forecast, both as ``[N, H]``.

    stfore: ``y [B, W, H]`` -> ``[B·W, H]``; demand: ``ts [B, 12]``; a
    forecast's trailing singleton dim is squeezed (Demand returns
    ``[N, 12, 1]``).
    """
    if "y" in batch and batch.get("X") is not None:
        y = batch["y"]
        target = y.reshape(-1, y.shape[-1])
    else:
        target = batch["ts"]
    f = forecast
    if f.dim() == 3 and f.shape[-1] == 1 and target.dim() == 2:
        f = f[..., 0]
    return target, f.reshape(target.shape)


def expand_mask(batch, target: torch.Tensor) -> torch.Tensor:
    """Per-item mask -> per-row mask over the flattened window axis."""
    mask = batch.get("mask")
    if mask is None:
        return torch.ones(target.shape[0], dtype=target.dtype, device=target.device)
    reps = target.shape[0] // mask.shape[0]
    return torch.repeat_interleave(mask, reps, dim=0) if reps > 1 else mask


def mse_loss(target, pred, row_mask):
    """MSE over the real rows: Σ mask·(target − pred)² / max(Σ mask · H, 1)."""
    err = (target - pred) ** 2
    denom = torch.clamp_min(row_mask.sum() * target.shape[-1], 1.0)
    return torch.sum(err * row_mask[:, None]) / denom


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    # Asynchronous from pinned host memory (the loader pins for a CUDA target).
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def step_generator(seed: int, step: int, device, micro: Optional[int] = None):
    """The dropout generator of global step ``step`` (and microbatch
    ``micro``): seeded from ``(seed, step[, micro])`` alone, so a resumed run
    draws the uninterrupted run's masks (the JAX ``fold_in(rng, step)``)."""
    words = [seed, step] if micro is None else [seed, step, micro]
    value = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(value)


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 50
    seed: int = 21
    grad_clip: Optional[float] = None  # 0.5 for the transformer family
    learning_rate: Optional[float] = None  # None = fairseq relative-step schedule
    norm_scalar: float = 53.0
    # A torch.profiler trace of the run's second train step into this
    # directory (utils/tracing.py).
    trace_dir: Optional[str] = None
    # Average the gradients of this many consecutive loader batches per
    # update; a trailing group that does not fill up is dropped.
    accum_steps: int = 1
    # Save into the checkpointer's ``last`` slot every so many minutes at a
    # step boundary (0 = off): bounds what a hard failure loses.
    autosave_minutes: float = 0.0
    # Stop after this many epochs without val_wWAPE improving by more than
    # ``early_stop_min_delta`` (0 = off).
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: optim_lib.Adafactor
    step: int = 0


class PreemptionWatch:
    """While entered, SIGTERM sets ``requested``; ``Trainer.fit`` reads it at
    the next step boundary, saves the ``last`` slot and returns.  Installed
    from the main thread only (CPython's rule); the previous handler comes
    back on exit."""

    def __init__(self):
        self.requested = False
        self._previous = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._previous[signal.SIGTERM] = signal.signal(signal.SIGTERM, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            # None: the displaced handler was installed from C.
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._previous.clear()
        return False


class Trainer:
    """Train and evaluate one registry model on its own device."""

    def __init__(self, model: nn.Module, config: TrainConfig):
        self.model = model
        self.config = config
        self.device = next(model.parameters()).device
        self.history = []

    # ------------------------------------------------------------------ init
    def init_state(self) -> TrainState:
        """The state of a fresh run from the model's current weights: the
        backbone freeze split applied and a new optimizer.  (The JAX
        ``init_state`` draws the weights here; the port's ``build`` draws
        them from its generator.)"""
        optimizer = optim_lib.make_optimizer(self.model, self.config.grad_clip,
                                             self.config.learning_rate)
        return TrainState(self.model, optimizer, 0)

    # ----------------------------------------------------------------- steps
    def _train_loss(self, batch, generator):
        model = self.model
        if not model.training:
            model.train()
        forecast, _ = model(batch, generator=generator)
        target, pred = target_and_pred(batch, forecast)
        return mse_loss(target, pred, expand_mask(batch, target))

    def train_step(self, state: TrainState, batch):
        """One update from ``batch``; returns ``(state, {"loss": tensor})``."""
        batch = to_device(batch, self.device)
        generator = step_generator(self.config.seed + DROPOUT_SEED_OFFSET, state.step,
                                   self.device)
        loss = self._train_loss(batch, generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    def accum_train_step(self, state: TrainState, batches):
        """One update from a list of microbatches: their gradients at the
        same parameters, summed in order and divided by their number."""
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = 0.0
        for i, batch in enumerate(batches):
            generator = step_generator(self.config.seed + DROPOUT_SEED_OFFSET, state.step,
                                       self.device, micro=i)
            loss = self._train_loss(to_device(batch, self.device), generator)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        torch._foreach_div_(grads, float(len(batches)))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss_sum / len(batches)}

    def _dispatch_step(self, state, item):
        if self.config.accum_steps > 1:
            return self.accum_train_step(state, item)
        return self.train_step(state, item)

    def _train_inputs(self, loader, skip_groups: int = 0):
        """Loader batches, in groups of ``accum_steps`` when accumulating;
        the first ``skip_groups`` groups are skipped, unassembled where the
        loader has ``iter_from``."""
        A = max(1, self.config.accum_steps)
        skip = skip_groups * A
        if skip and hasattr(loader, "iter_from"):
            it = loader.iter_from(skip)
        else:
            it = iter(loader)
            for _ in range(skip):
                next(it, None)
        if A <= 1:
            yield from it
            return
        group = []
        for b in it:
            group.append(b)
            if len(group) == A:
                yield group
                group = []

    # ------------------------------------------------------------------ eval
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """The masked partial sums of one batch, on the device."""
        model = self.model
        if model.training:
            model.eval()
        batch = to_device(batch, self.device)
        with torch.inference_mode():
            forecast, _ = model(batch)
            target, pred = target_and_pred(batch, forecast)
            return eval_metrics(target, pred, expand_mask(batch, target),
                                norm_scalar=self.config.norm_scalar)

    def evaluate(self, state: TrainState, loader) -> Dict[str, float]:
        sums = None
        for batch in loader:
            part = self.eval_step(state, batch)
            part = torch.stack([part[k] for k in SUM_KEYS]).double()
            sums = part if sums is None else sums + part
        if sums is None:
            raise ValueError(
                "evaluate() got a loader with zero batches — the validation split is "
                "empty (or smaller than batch_size with drop_remainder)")
        out = finalize_metrics(dict(zip(SUM_KEYS, sums.tolist())))
        return {"val_mae": out["mae"], "val_wWAPE": out["wape"]}

    # ------------------------------------------------------------------- fit
    def fit(self, train_loader, val_loader, state: Optional[TrainState] = None,
            checkpointer=None, log_fn: Callable[[Dict], None] = None,
            start_epoch: int = 0, skip_steps: int = 0) -> TrainState:
        """Train from ``start_epoch``, skipping the first ``skip_steps``
        updates of it (already inside a mid-epoch save).  With the loader's
        order pinned by ``set_epoch`` and the dropout generators derived from
        the global step, a resumed run reproduces the uninterrupted one."""
        A = self.config.accum_steps
        if A > 1 and A > len(train_loader):
            raise ValueError(
                f"accum_steps={A} exceeds the {len(train_loader)} train batches per "
                f"epoch — every epoch would drop its only (partial) group and train on "
                f"nothing")
        if state is None:
            state = self.init_state()
        steps_per_epoch = len(train_loader) // max(1, A)
        with PreemptionWatch() as watch:
            return self._fit_epochs(train_loader, val_loader, state, time.time(),
                                    self.config.trace_dir is not None, steps_per_epoch,
                                    start_epoch, skip_steps, checkpointer, log_fn, watch)

    def _log(self, metrics, log_fn):
        self.history.append(metrics)
        if log_fn:
            log_fn(metrics)

    def _fit_epochs(self, train_loader, val_loader, state, t0, want_trace,
                    steps_per_epoch, start_epoch, skip_steps, checkpointer, log_fn, watch):
        can_save_last = checkpointer is not None and hasattr(checkpointer, "save_preempted")
        autosave_s = self.config.autosave_minutes * 60.0
        next_autosave = time.time() + autosave_s
        best_monitor, stale_epochs = np.inf, 0
        if self.config.early_stop_patience and start_epoch > 0 and \
                hasattr(checkpointer, "best_metric"):
            # A resume picks up the early-stop count from the best saved epoch.
            bm = checkpointer.best_metric()
            if bm is not None:
                best_epoch, best_monitor = bm
                stale_epochs = max(0, start_epoch - 1 - best_epoch)
        for epoch in range(start_epoch, self.config.epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            skip = skip_steps if epoch == start_epoch else 0
            losses = []
            for batch in self._train_inputs(train_loader, skip_groups=skip):
                if watch.requested:
                    break
                if want_trace and epoch == start_epoch and (
                        len(losses) == 1 or steps_per_epoch == 1):
                    # The run's second step (its first when an epoch has one).
                    from visuelle2_tpu_torch.utils.tracing import trace

                    with trace(self.config.trace_dir):
                        state, m = self._dispatch_step(state, batch)
                    want_trace = False
                else:
                    state, m = self._dispatch_step(state, batch)
                losses.append(m["loss"])
                done = skip + len(losses)
                if autosave_s and can_save_last and not watch.requested \
                        and time.time() >= next_autosave:
                    checkpointer.save_preempted(epoch, state, steps_into_epoch=done)
                    next_autosave = time.time() + autosave_s
                if watch.requested:
                    break
            if watch.requested:
                # SIGTERM: save this step boundary into the ``last`` slot and
                # stop, with no validation in the grace window.
                done = skip + len(losses)
                if can_save_last:
                    checkpointer.save_preempted(epoch, state, steps_into_epoch=done)
                self._log({"epoch": epoch, "preempted": True, "steps_into_epoch": done,
                           "wall_s": time.time() - t0}, log_fn)
                return state
            # A resume that skipped the whole epoch has no loss to report.
            if losses:
                train_loss = float(torch.stack(losses).float().mean())
                # A non-finite epoch loss halts the run: the best checkpoint
                # so far stays, and the history records the event.
                if not np.isfinite(train_loss):
                    self._log({"epoch": epoch, "train_loss": train_loss,
                               "halted": "non-finite train loss",
                               "wall_s": time.time() - t0}, log_fn)
                    return state
            metrics = self.evaluate(state, val_loader)
            metrics.update(epoch=epoch, wall_s=time.time() - t0,
                           lr=optim_lib.current_lr(state.step, self.config.learning_rate))
            if losses:
                metrics["train_loss"] = train_loss
            patience = self.config.early_stop_patience
            if patience:
                if metrics["val_wWAPE"] < best_monitor - self.config.early_stop_min_delta:
                    best_monitor, stale_epochs = metrics["val_wWAPE"], 0
                else:
                    stale_epochs += 1
                    if stale_epochs >= patience:
                        metrics["early_stopped"] = stale_epochs
            self._log(metrics, log_fn)
            if checkpointer is not None:
                checkpointer.save(epoch, state, metrics)
            if metrics.get("early_stopped"):
                return state
        return state
