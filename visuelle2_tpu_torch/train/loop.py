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

Both step functions record host spans (``utils/tracing.py``): ``train.step``
around the step, and inside it ``train.upload`` (the batch to the device),
``train.forward`` (forward and loss), ``train.backward`` (the gradients
zeroed, ``backward``) a microbatch and ``train.optimizer`` (the update).

A ``TrainState`` holds the model (parameters and BatchNorm statistics), the
optimizer and the global step; the step functions update it in place and
return it, as the JAX ones return a new one.  The parity runs turn dropout
off everywhere by calling the steps inside ``ops.dropout.disabled()``.

``Trainer(model, config, mesh)`` takes the JAX signature.  With no mesh it
is ``parallel.mesh.make_mesh()``: the stand-in one-rank mesh without a
process group, so the steps above run as written.  Over a process group
(one rank a device, ``parallel/distributed.py::initialize``) it trains over
the mesh's ``(data, model)`` (or ``(dcn, data, model)``) axes, each data
index on its row block of every global batch, and gives the
single-device step's numbers on the global batch whatever the mesh:

* ``init_state`` broadcasts the parameters and buffers from rank 0; with a
  ``model`` axis it then keeps this rank's block of every parameter the
  JAX rule shards at ``config.tp_min_dim`` (``parallel/sharding.py``), and
  the optimizer, built over the parameters in the plain model's order,
  shards its state the same way (``train/optim.py``);
* the masked MSE is this rank's numerator over the global denominator
  (an all-reduce over the data group, outside autograd), so the data
  ranks' losses sum to the global loss, wherever they hold different
  counts of real rows;
* BatchNorm statistics, dropout masks and the dedup gather are global
  inside the step (``parallel/collectives.py``), over the data group;
* after ``backward`` one flat all-reduce over the data group sums the
  gradients (a sharded parameter's: its block), the loss and the stop
  flags: one collective a step, over exactly the gradients that exist,
  with no hook in autograd (``DistributedDataParallel`` would average, not
  sum, and re-send BatchNorm buffers at every forward); the Adafactor
  update and its global-norm clip then run alike on every rank;
* with a ``model`` axis, one more all-reduce over the model group makes
  the replicated parameters' gradients, the BatchNorm buffers and the loss
  model rank 0's (the others add zeros), so a nondeterministic kernel on
  the card cannot move the model ranks' replicas apart, and sums the stop
  flags, which so reach every rank;
* ``evaluate`` and ``eval_step`` all-reduce the float64 partial sums over
  the data group;
* ``fit``: rank 0 alone logs, writes checkpoints and traces; a SIGTERM on
  any rank sets its stop flag, which reaches every rank through the next
  step's all-reduces; each rank reads the agreed flag ``STOP_LAG`` steps
  later from a copy to pinned host memory, or at the epoch's end, so every
  rank stops at the same step boundary and no step waits on the device.
  Rank 0's autosave deadline travels in the same flags and every rank
  saves at the boundary that reads it: with a ``model`` axis a checkpoint
  is gathered on every rank (rank 0 writes the plain state,
  ``train/checkpoint.py``).

At one rank every collective is the identity and the steps give the plain
``Trainer``'s bits.  The JAX ``TrainConfig.data_parallel`` is never read by
the JAX package, so the port has no such option (data parallelism follows
the mesh).
"""

from __future__ import annotations

import collections
import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch.ops.metrics import eval_metrics, finalize_metrics
from visuelle2_tpu_torch.parallel import collectives
from visuelle2_tpu_torch.parallel import mesh as mesh_lib
from visuelle2_tpu_torch.parallel import sharding
from visuelle2_tpu_torch.train import optim as optim_lib
from visuelle2_tpu_torch.utils import tracing

SUM_KEYS = ("abs_err", "abs_gt", "count", "rows")  # eval_metrics' partial sums
DROPOUT_SEED_OFFSET = 1000  # the JAX fit's rng = key(seed + 1000)
# Steps between a stop flag's all-reduce and the step boundary that reads it
# (data parallel fit): the host waits only on a step that is long done.
STOP_LAG = 2


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


def mse_loss(target, pred, row_mask, group=None):
    """MSE over the real rows: Σ mask·(target − pred)² / max(Σ mask · H, 1).
    With a process ``group`` the denominator is the global batch's (summed
    over the ranks, outside autograd) and the result this rank's share of
    the global loss."""
    err = (target - pred) ** 2
    denom = row_mask.sum() * target.shape[-1]
    if group is not None:
        import torch.distributed as dist

        denom = denom.detach()
        dist.all_reduce(denom, group=group)
    return torch.sum(err * row_mask[:, None]) / torch.clamp_min(denom, 1.0)


def sum_eval_sums(sums: torch.Tensor, mesh) -> torch.Tensor:
    """In place: the float64 partial sums summed over ``mesh``'s data group,
    then, with a ``model`` axis, model rank 0's taken by every model rank
    (the others add zeros to one all-reduce): every rank then reads the same
    metrics, whatever a nondeterministic kernel did to its own forward."""
    import torch.distributed as dist

    dist.all_reduce(sums, group=mesh_lib.batch_group(mesh))
    group = mesh_lib.model_group(mesh)
    if group is not None:
        if mesh_lib.model_rank_world(mesh)[0] != 0:
            sums.zero_()
        dist.all_reduce(sums, group=group)
    return sums


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
    # Tensor parallelism: parameters whose flax trailing dim is at least
    # this wide (and divisible by the model axis) shard over ``model``.
    tp_min_dim: int = 64


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


class _StopAgreement:
    """Whether ``fit`` stops at this step boundary after a SIGTERM.  One
    process: the watch's flag.  Data parallel: the flags every rank put into
    a step's all-reduce, read ``STOP_LAG`` steps later (every pending one
    with ``lag=0``, at an epoch's end) from a copy to pinned host memory, so
    every rank reads the same flags at the same boundaries and the host
    waits only on a step that is long done.  The second flag is rank 0's
    autosave request, counted in ``autosaves``."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.pending = collections.deque()
        self.agreed = False
        self.autosaves = 0

    def take_autosave(self) -> bool:
        """Whether an agreed autosave request was read since the last call."""
        due, self.autosaves = self.autosaves > 0, 0
        return due

    def after_step(self):
        if not self.trainer.distributed:
            return
        flag = self.trainer._stop_flag
        if flag.device.type == "cuda":
            host = torch.empty(flag.shape, dtype=flag.dtype, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = flag.clone(), None
        self.pending.append((host, event))

    def requested(self, lag: int = STOP_LAG) -> bool:
        if not self.trainer.distributed:
            return self.trainer._watch.requested
        while len(self.pending) > lag:
            host, event = self.pending.popleft()
            if event is not None:
                event.synchronize()
            self.agreed = self.agreed or float(host[0]) > 0.0
            self.autosaves += int(float(host[1]) > 0.0)
        return self.agreed


class _GatherOnly:
    """A rank other than 0 under tensor parallelism: its side of each of
    rank 0's saves, the gathers of the plain state, with nothing written."""

    def save(self, epoch, state, metrics):
        from visuelle2_tpu_torch.train.checkpoint import plain_payload

        plain_payload(state)

    def save_preempted(self, epoch, state, steps_into_epoch: int = 0):
        self.save(epoch, state, None)


class Trainer:
    """Train and evaluate one registry model on its own device; data
    parallel over ``mesh``'s batch axis (see the module docstring)."""

    def __init__(self, model: nn.Module, config: TrainConfig, mesh=None):
        self.model = model
        self.config = config
        self.device = next(model.parameters()).device
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(
            device_type=self.device.type)
        self.rank, self.world = mesh_lib.batch_rank_world(self.mesh)
        self.distributed = mesh_lib.is_distributed(self.mesh)
        self._group = mesh_lib.batch_group(self.mesh) if self.distributed else None
        self._model_group = mesh_lib.model_group(self.mesh) if self.distributed else None
        self.model_rank = mesh_lib.model_rank_world(self.mesh)[0]
        if self.distributed:
            import torch.distributed as dist

            self.is_main = dist.get_rank() == 0
        else:
            self.is_main = True
        self.history = []
        self._watch = None  # fit's PreemptionWatch, read into the stop flag
        # The last step's all-reduced (stop, autosave) flags (device).
        self._stop_flag = None
        self._autosave_request = False  # rank 0's, sent with the next step

    @property
    def tensor_parallel(self) -> bool:
        return self._model_group is not None

    # ------------------------------------------------------------------ init
    def init_state(self) -> TrainState:
        """The state of a fresh run from the model's current weights: the
        backbone freeze split applied and a new optimizer.  (The JAX
        ``init_state`` draws the weights here; the port's ``build`` draws
        them from its generator.)  Over a process group: rank 0's
        parameters and buffers, broadcast; then, with a ``model`` axis, this
        rank's blocks of the sharded parameters (the model is sharded once;
        a second ``init_state`` broadcasts each block over its data group)."""
        model = self.model
        if self.distributed:
            if sharding.is_sharded(model):
                self._broadcast_from_first_rank(
                    list(model.parameters()) + list(model.buffers()), self._group)
            else:
                import torch.distributed as dist

                self._broadcast_from_first_rank(
                    list(model.parameters()) + list(model.buffers()), dist.group.WORLD)
        if self.tensor_parallel and not sharding.is_sharded(model):
            sharding.shard_module(model, self.mesh, self.config.tp_min_dim)
        # Over the parameters in the plain model's order, so that its
        # state_dict indexes them as an unsharded optimizer's does.
        optimizer = optim_lib.make_optimizer(
            model, self.config.grad_clip, self.config.learning_rate,
            params=sharding.plain_parameter_order(model),
            shards=sharding.parameter_shards(model))
        return TrainState(model, optimizer, 0)

    def _broadcast_from_first_rank(self, tensors, group):
        import torch.distributed as dist

        by_dtype = collections.defaultdict(list)
        for t in tensors:
            by_dtype[t.dtype].append(t)
        with torch.no_grad():
            for group_tensors in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in group_tensors])
                dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
                torch._foreach_copy_(group_tensors, [v.view_as(t) for v, t in zip(
                    flat.split([t.numel() for t in group_tensors]), group_tensors)])

    # ----------------------------------------------------------------- steps
    def _parallel(self):
        """The data-parallel context of the model code: global BatchNorm
        statistics, dropout masks and dedup gather (a no-op at one rank)."""
        return collectives.data_parallel(self.mesh)

    def _upload(self, batch):
        with tracing.span("train.upload"):
            return to_device(batch, self.device)

    def _train_loss(self, batch, generator):
        with tracing.span("train.forward"):
            model = self.model
            if not model.training:
                model.train()
            forecast, _ = model(batch, generator=generator)
            target, pred = target_and_pred(batch, forecast)
            return mse_loss(target, pred, expand_mask(batch, target), group=self._group)

    @staticmethod
    def _backward(loss, optimizer=None):
        """``loss.backward()``, the gradients zeroed first when given the
        ``optimizer``."""
        with tracing.span("train.backward"):
            if optimizer is not None:
                optimizer.zero_grad(set_to_none=True)
            loss.backward()

    @staticmethod
    def _update(state: TrainState):
        with tracing.span("train.optimizer"):
            state.optimizer.step()
        state.step += 1

    def _reduce_gradients(self, loss):
        """Over a process group: one all-reduce over the data group sums
        the gradients, the loss and this rank's (stop, autosave) flags; with
        a ``model`` axis ``_sync_model_ranks`` follows.  Returns the global
        loss."""
        import torch.distributed as dist

        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if any(g.dtype != loss.dtype for g in grads):
            raise TypeError("data parallel training needs float32 gradients (the masters)")
        requested = self._watch is not None and self._watch.requested
        autosave, self._autosave_request = self._autosave_request, False
        flat = torch.cat([g.reshape(-1) for g in grads] + [
            loss.detach().reshape(1),
            torch.full((1,), float(requested), dtype=loss.dtype, device=loss.device),
            torch.full((1,), float(autosave), dtype=loss.dtype, device=loss.device)])
        dist.all_reduce(flat, group=self._group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat[:-3].split([g.numel() for g in grads]), grads)])
        if self.tensor_parallel:
            return self._sync_model_ranks(flat[-3], flat[-2:])
        self._stop_flag = flat[-2:]
        return flat[-3]

    def _sync_model_ranks(self, loss, flags):
        """Tensor parallel: one all-reduce over the model group, to which
        model rank 0 adds the replicated parameters' gradients, the float
        buffers (BatchNorm statistics) and the loss, and the others zeros,
        so every model rank takes rank 0's bits; the flags are summed, so
        each reaches every rank.  Returns the loss."""
        import torch.distributed as dist

        shards = sharding.parameter_shards(self.model)
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None and p not in shards]
        buffers = [b for b in self.model.buffers() if b.dtype == loss.dtype]
        values = [t.reshape(-1) for t in grads + buffers] + [loss.reshape(1)]
        flat = torch.cat(values)
        if self.model_rank != 0:
            flat.zero_()
        flat = torch.cat([flat, flags])
        dist.all_reduce(flat, group=self._model_group)
        with torch.no_grad():
            torch._foreach_copy_(grads + buffers, [v.view_as(t) for v, t in zip(
                flat[:-3].split([t.numel() for t in grads + buffers]), grads + buffers)])
        self._stop_flag = flat[-2:]
        return flat[-3]

    def train_step(self, state: TrainState, batch):
        """One update from ``batch``; returns ``(state, {"loss": tensor})``.
        Data parallel: ``batch`` is this rank's rows, the loss the global
        batch's."""
        with tracing.span("train.step"):
            batch = self._upload(batch)
            generator = step_generator(self.config.seed + DROPOUT_SEED_OFFSET, state.step,
                                       self.device)
            with self._parallel():
                loss = self._train_loss(batch, generator)
                self._backward(loss, state.optimizer)
            if self.distributed:
                loss = self._reduce_gradients(loss)
            self._update(state)
        return state, {"loss": loss.detach()}

    def accum_train_step(self, state: TrainState, batches):
        """One update from a list of microbatches: their gradients at the
        same parameters, summed in order (and over the ranks) and divided by
        their number."""
        with tracing.span("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            loss_sum = 0.0
            with self._parallel():
                for i, batch in enumerate(batches):
                    generator = step_generator(self.config.seed + DROPOUT_SEED_OFFSET,
                                               state.step, self.device, micro=i)
                    loss = self._train_loss(self._upload(batch), generator)
                    self._backward(loss)
                    loss_sum = loss_sum + loss.detach()
            if self.distributed:
                loss_sum = self._reduce_gradients(loss_sum)
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, float(len(batches)))
            self._update(state)
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
    def _eval_sums(self, batch) -> torch.Tensor:
        """This rank's masked partial sums of one batch, float64 in
        ``SUM_KEYS`` order, on the device."""
        model = self.model
        if model.training:
            model.eval()
        batch = to_device(batch, self.device)
        with torch.inference_mode(), self._parallel():
            forecast, _ = model(batch)
            target, pred = target_and_pred(batch, forecast)
            part = eval_metrics(target, pred, expand_mask(batch, target),
                                norm_scalar=self.config.norm_scalar)
            return torch.stack([part[k] for k in SUM_KEYS]).double()

    def _sum_over_ranks(self, sums: torch.Tensor) -> torch.Tensor:
        """The data group's sum of the partial sums; with a ``model`` axis,
        model rank 0's on every rank (``sum_eval_sums``)."""
        if self.distributed:
            with torch.inference_mode():
                sum_eval_sums(sums, self.mesh)
        return sums

    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """The masked partial sums of one (global) batch, on the device."""
        sums = self._sum_over_ranks(self._eval_sums(batch))
        return dict(zip(SUM_KEYS, sums.unbind()))

    def evaluate(self, state: TrainState, loader) -> Dict[str, float]:
        sums = None
        for batch in loader:
            part = self._eval_sums(batch)
            sums = part if sums is None else sums + part
        if sums is None:
            raise ValueError(
                "evaluate() got a loader with zero batches — the validation split is "
                "empty (or smaller than batch_size with drop_remainder)")
        out = finalize_metrics(dict(zip(SUM_KEYS, self._sum_over_ranks(sums).tolist())))
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
        if not self.is_main:
            log_fn = None  # rank 0 alone logs and writes
        with PreemptionWatch() as watch:
            self._watch = watch
            try:
                state = self._fit_epochs(
                    train_loader, val_loader, state, time.time(),
                    self.config.trace_dir is not None and self.is_main, steps_per_epoch,
                    start_epoch, skip_steps, checkpointer, log_fn, _StopAgreement(self))
            finally:
                self._watch = None
        if self.distributed:
            import torch.distributed as dist

            dist.barrier()  # rank 0's saves are on disk for every rank
        return state

    def _agree_on_saver(self, saver, can_save_last):
        """Rank 0's (has a checkpointer, it saves the ``last`` slot), on
        every rank: one all-reduce at the start of ``fit``."""
        import torch.distributed as dist

        mine = [float(saver is not None), float(can_save_last)] if self.is_main else [0.0, 0.0]
        flags = torch.tensor(mine, dtype=torch.float32, device=self.device)
        dist.all_reduce(flags)
        return bool(flags[0] > 0), bool(flags[1] > 0)

    def _log(self, metrics, log_fn):
        self.history.append(metrics)
        if log_fn:
            log_fn(metrics)

    def _fit_epochs(self, train_loader, val_loader, state, t0, want_trace,
                    steps_per_epoch, start_epoch, skip_steps, checkpointer, log_fn, stop):
        watch = self._watch
        # Every rank reads the checkpointer (a resume's early-stop count);
        # rank 0 alone saves.
        saver = checkpointer if self.is_main else None
        can_save_last = saver is not None and hasattr(saver, "save_preempted")
        if self.tensor_parallel:
            # A save gathers the state on every rank: the others take part
            # in each of rank 0's.
            saves, can_save_last = self._agree_on_saver(saver, can_save_last)
            if saves and not self.is_main:
                saver = _GatherOnly()
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
                if stop.requested():
                    break
                if want_trace and epoch == start_epoch and (
                        len(losses) == 1 or steps_per_epoch == 1):
                    # The run's second step (its first when an epoch has one).
                    with tracing.trace(self.config.trace_dir):
                        state, m = self._dispatch_step(state, batch)
                    want_trace = False
                else:
                    state, m = self._dispatch_step(state, batch)
                stop.after_step()
                losses.append(m["loss"])
                done = skip + len(losses)
                if not self.distributed:
                    if autosave_s and can_save_last and not watch.requested \
                            and time.time() >= next_autosave:
                        saver.save_preempted(epoch, state, steps_into_epoch=done)
                        next_autosave = time.time() + autosave_s
                # Over a process group rank 0's deadline travels in the
                # step's flags; every rank saves at the boundary that reads it.
                elif not stop.requested() and stop.take_autosave() and can_save_last:
                    saver.save_preempted(epoch, state, steps_into_epoch=done)
                    next_autosave = time.time() + autosave_s
                elif autosave_s and can_save_last and self.is_main \
                        and not watch.requested and time.time() >= next_autosave:
                    self._autosave_request, next_autosave = True, np.inf
                if stop.requested():
                    break
            if stop.requested(lag=0):
                # SIGTERM: save this step boundary into the ``last`` slot and
                # stop, with no validation in the grace window.
                done = skip + len(losses)
                if can_save_last:
                    saver.save_preempted(epoch, state, steps_into_epoch=done)
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
            if saver is not None:
                saver.save(epoch, state, metrics)
            if metrics.get("early_stopped"):
                return state
        return state
