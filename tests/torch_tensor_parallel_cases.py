"""Tensor-parallel cases of the port, run by
``tests/test_torch_tensor_parallel.py`` as four gloo ranks of a
``(data=2, model=2)`` mesh on the CPU and as one process alone.

    python tests/torch_tensor_parallel_cases.py --out DIR --dataset D \\
        [--coordinator H:P --world 4 --rank R]

Each rank computes every case on its data index's row block of the same
global inputs (made from seeds with numpy) and writes its results to
``DIR/rank<R>.npz``, whole tensors gathered from the shards; the process
alone (``--world 1``, no process group, nothing sharded) writes the
single-device results on the whole global batch to ``DIR/rank0.npz``.  It
prints one JSON line of scalars: the test compares the files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from visuelle2_tpu_torch.data.images import ImageStore  # noqa: E402
from visuelle2_tpu_torch.data.loader import BatchLoader, shard_batch  # noqa: E402
from visuelle2_tpu_torch.data.pipeline import load_label_dicts, load_visuelle2  # noqa: E402
from visuelle2_tpu_torch.eval.export import export_forecaster  # noqa: E402
from visuelle2_tpu_torch.eval.forecast import score_split  # noqa: E402
from visuelle2_tpu_torch.models import VocabSizes, build  # noqa: E402
from visuelle2_tpu_torch.ops import dropout  # noqa: E402
from visuelle2_tpu_torch.parallel import distributed, sharding  # noqa: E402
from visuelle2_tpu_torch.parallel.collectives import gather_model_shards  # noqa: E402
from visuelle2_tpu_torch.parallel.demo_multihost import synthetic_global_batch  # noqa: E402
from visuelle2_tpu_torch.parallel.mesh import (  # noqa: E402
    LocalMesh,
    batch_rank_world,
    make_mesh,
    model_rank_world,
)
from visuelle2_tpu_torch.train import loop, optim  # noqa: E402
from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, plain_payload  # noqa: E402

GLOBAL = 8  # rows of each case's global batch
IMAGE = 32
VOCAB = VocabSizes(5, 6, 5, 126)
TP_MIN_DIM = 8  # tests/test_train_loop.py's tensor-parallel tests
LR = 1e-3
STEPS = 2
# The trajectory models: registry overrides and batch kind.
MODELS = {
    "m4ft": (dict(output_len=12, image_arch="tiny", embedding_dim=16, hidden_dim=16),
             "demand"),
    "gated_v4": (dict(output_len=12, image_arch="tiny", embedding_dim=16, hidden_dim=16),
                 "demand"),
    # Without the image: no backbone ReLU input near zero can take the other
    # sign in the two frameworks (tests/test_torch_parallel.py's Demand case);
    # gated_v4 and m4ft shard the backbone.
    "cross_attn_rnn_210": (dict(out_len=4, attention_dim=16, embedding_dim=16, hidden_dim=16,
                                image_arch="tiny", use_img=False, use_teacher_forcing=True,
                                teacher_forcing_ratio=1.0), "stfore"),
}
# Sharded Adafactor: the shapes that flip or lose factoring when halved
# ([256, 200] -> [128, 200]; [200, 256] -> [100, 256]), a conv kernel and two
# tables (sharded along their factored d0 and d1), with the clip active at
# the steps whose gradient norm is above 0.5.
OPT_NORMS = (3.0, 0.2, 1.0)


def global_batch(kind, seed):
    """The demo's demand batch (8 rows at 32²), or an stfore batch with a
    horizon of 4 made from it."""
    b = synthetic_global_batch(GLOBAL, IMAGE, seed=seed)
    if kind == "stfore":
        rng = np.random.default_rng(seed + 500)
        del b["ts"]
        b["X"] = rng.random((GLOBAL, 2, 2)).astype(np.float32)
        b["y"] = rng.random((GLOBAL, 2, 4)).astype(np.float32)
    return b


def _gathered_grads(model, prefix):
    """The step's gradients, whole: a sharded block's gathered over the
    model group (every rank calls this in the same order)."""
    shards = sharding.parameter_shards(model)
    out = {}
    with torch.no_grad():
        for n, p in model.named_parameters():
            if p.grad is None:
                continue
            s = shards.get(p)
            g = p.grad if s is None else gather_model_shards(
                p.grad, s.dim, s.rank, s.world, s.group, s.global_stride)
            out[f"{prefix}_grad/{sharding.plain_name(n)}"] = g.clone()
    return out


def _state(model, prefix):
    """The plain model's state dict, gathered, and the local values of the
    replicated parameters (to compare the model ranks' bits)."""
    out = {f"{prefix}_state/{k}": v.clone() for k, v in
           sharding.plain_state_dict(model).items()}
    shards = sharding.parameter_shards(model)
    out.update({f"{prefix}_replicated/{n}": p.detach().clone()
                for n, p in model.named_parameters() if p not in shards})
    return out


def _trainer(name, mesh, seed=3, build_kw=None, **config):
    kw, _ = MODELS[name]
    model = build(name, device="cpu", generator=torch.Generator().manual_seed(seed),
                  vocab=VOCAB, **kw, **(build_kw or {}))
    cfg = dict(grad_clip=0.5, learning_rate=LR, tp_min_dim=TP_MIN_DIM)
    cfg.update(config)
    return loop.Trainer(model, loop.TrainConfig(**cfg), mesh=mesh)


def case_adafactor(mesh, out):
    """Sharded Adafactor against the whole one: ``STEPS`` updates of a
    module of the factoring-flip shapes from seeded gradients; each step's
    update and the final state, gathered."""
    torch.manual_seed(0)
    mod = torch.nn.Module()
    mod.a = torch.nn.Linear(200, 256)            # [256, 200]: halved -> [128, 200]
    mod.b = torch.nn.Linear(256, 200)            # [200, 256]: halved -> [100, 256]
    mod.conv = torch.nn.Conv2d(128, 256, 3)      # OIHW, sharded along O (d0)
    mod.emb = torch.nn.Embedding(130, 256)       # sharded along 256 (d0)
    mod.emb2 = torch.nn.Embedding(256, 130)      # sharded along 130 (d1)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    names = [n for n, _ in mod.named_parameters()]
    grads = []
    for norm in OPT_NORMS:
        g = {n: rng.normal(size=p.shape) for n, p in mod.named_parameters()}
        scale = norm / np.sqrt(sum(np.sum(v ** 2) for v in g.values()))
        grads.append({n: torch.from_numpy((v * scale).astype(np.float32)) for n, v in g.items()})
    if mesh is not None:
        dims = sharding.shard_module(mod, mesh, TP_MIN_DIM)
        out["adafactor_sharded"] = torch.tensor(sorted(dims.values()))
    order = sharding.plain_parameter_order(mod)
    opt = optim.Adafactor(order, lr=None, grad_clip=0.5,
                          shards=sharding.parameter_shards(mod))
    by_name = dict(zip(names, order))
    shards = sharding.parameter_shards(mod)
    updates = []
    compute = opt.compute_updates

    def spy(group, params):  # the amounts step subtracts, as it computes them
        u = compute(group, params)
        updates.append(u)
        return u

    opt.compute_updates = spy
    for i, g in enumerate(grads):
        for n, p in by_name.items():
            s = shards.get(p)
            p.grad = g[n] if s is None else g[n].narrow(
                s.dim, s.rank * p.shape[s.dim], p.shape[s.dim]).clone()
        opt.step()
        for n, p, u in zip(names, order, updates[-1]):
            s = shards.get(p)
            out[f"adafactor_update{i}/{n}"] = u if s is None else gather_model_shards(
                u, s.dim, s.rank, s.world, s.group, s.global_stride)
    out.update({f"adafactor_param/{k}": v for k, v in sharding.plain_state_dict(mod).items()})
    state = opt.plain_state_dict()["state"]
    for idx, n in enumerate(names):
        for key, v in state.get(idx, {}).items():
            out[f"adafactor_state/{n}/{key}"] = v.clone()


def case_trajectory(mesh, out, name):
    """``STEPS`` Trainer steps of ``name`` (dropout off) on seeded global
    batches: the losses, each step's whole gradient, the state after, the
    eval sums of a one-pass ``score_split``."""
    _, kind = MODELS[name]
    trainer = _trainer(name, mesh)
    state = trainer.init_state()
    losses = []
    with dropout.disabled():
        for i in range(STEPS):
            state, m = trainer.train_step(state, shard_batch(global_batch(kind, 10 + i), mesh))
            losses.append(m["loss"])
            out.update(_gathered_grads(trainer.model, f"{name}_{i}"))
    out[f"{name}_losses"] = torch.stack(losses)
    out.update(_state(trainer.model, name))
    evals = [shard_batch(global_batch(kind, 20 + i), mesh) for i in range(2)]
    r = score_split(trainer.model.eval(), evals, mesh=mesh, one_pass=True,
                    measure_throughput=False)
    out[f"{name}_score"] = torch.tensor([r.wape, r.mae, r.num_forecasts], dtype=torch.float64)
    return trainer, state


def case_remat_and_accum(mesh, out):
    """gated_v4 with ``--remat`` (the recomputation re-issues the gathers and
    the BatchNorm collectives inside the backward), then an accumulated step
    of two microbatches."""
    batches = [shard_batch(global_batch("demand", s), mesh) for s in (30, 31)]
    trainer = _trainer("gated_v4", mesh, seed=4, build_kw=dict(image_remat=True))
    with dropout.disabled():
        _, m = trainer.train_step(trainer.init_state(), batches[0])
    out["remat_loss"] = m["loss"]
    out.update(_gathered_grads(trainer.model, "remat"))
    trainer = _trainer("gated_v4", mesh, seed=4, accum_steps=2)
    with dropout.disabled():
        _, m = trainer.accum_train_step(trainer.init_state(), batches)
    out["accum_loss"] = m["loss"]
    out.update(_gathered_grads(trainer.model, "accum"))
    out.update(_state(trainer.model, "accum"))


def case_checkpoints(mesh, out, trainer, state, root, rank):
    """TP to plain: the trained gated_v4 saved under the mesh and exported
    as an artifact (rank 0 writes each; the test restores the checkpoint
    into a plain Trainer and exports that).  Plain to TP: a
    plain Trainer's checkpoint, written by this process alone, restored
    into a sharded one: the gathered state equal to the plain one, bit for
    bit, and a step after it from both."""
    if trainer.is_main:
        CheckpointManager(os.path.join(root, "ck_tp")).save(0, state, {"val_wWAPE": 1.0})
    else:
        plain_payload(state)
    # The trained model exported through the gather: every rank calls it,
    # rank 0 writes.
    export_forecaster(trainer.model, global_batch("demand", 50),
                      os.path.join(root, "tp_export.v2torch"))
    out["tp_saved_optimizer_count"] = torch.tensor(
        state.optimizer.param_groups[0]["count"])
    out.update({f"tp_saved_opt/{k}": v for k, v in _optimizer_state(state.optimizer).items()})

    plain = _trainer("gated_v4", LocalMesh(), seed=5)
    plain_state = plain.init_state()
    batch = global_batch("demand", 40)
    with dropout.disabled():
        plain.train_step(plain_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    slot = os.path.join(root, f"ck_plain_rank{rank}")
    CheckpointManager(slot).save(0, plain_state, {"val_wWAPE": 1.0})
    tp = _trainer("gated_v4", mesh, seed=6)
    tp_state, _, _ = CheckpointManager(slot, read_only=True).restore_latest(tp.init_state())
    same_model = all(torch.equal(v, plain_state.model.state_dict()[k])
                     for k, v in sharding.plain_state_dict(tp.model).items())
    want = _optimizer_state(plain_state.optimizer)
    got = _optimizer_state(tp_state.optimizer)
    same_opt = want.keys() == got.keys() and all(torch.equal(got[k], want[k]) for k in want)
    out["plain_to_tp_same_model"] = torch.tensor(same_model)
    out["plain_to_tp_same_optimizer"] = torch.tensor(same_opt and tp_state.step == 1)
    next_batch = global_batch("demand", 41)
    with dropout.disabled():
        _, mt = tp.train_step(tp_state, shard_batch(next_batch, mesh))
        _, mp = plain.train_step(plain_state, {k: torch.from_numpy(v)
                                               for k, v in next_batch.items()})
    out["plain_to_tp_losses"] = torch.stack([mt["loss"], mp["loss"]])


class _Saves:
    """A checkpointer that records its saves and takes the plain payload
    as a real one does (under a model axis a gather every rank joins)."""

    def __init__(self):
        self.calls = []

    def save(self, epoch, state, metrics):
        plain_payload(state)
        self.calls.append(["save", epoch])

    def save_preempted(self, epoch, state, steps_into_epoch=0):
        plain_payload(state)
        self.calls.append(["save_preempted", epoch, steps_into_epoch])


def case_fit_autosave(mesh, summary):
    """``fit`` over 4 global batches with an autosave due at every step:
    under a model axis rank 0's deadline rides in the step's flags, read two
    steps later, and every rank joins the save's gathers."""
    batches = [shard_batch(global_batch("demand", 60 + i), mesh) for i in range(4)]
    trainer = _trainer("gated_v4", mesh, epochs=1, autosave_minutes=1e-9)
    saves = _Saves() if trainer.is_main else None
    with dropout.disabled():
        trainer.fit(batches, batches[:1], checkpointer=saves)
    summary["fit_history"] = [{k: v for k, v in h.items() if k != "wall_s"}
                              for h in trainer.history]
    summary["fit_saves"] = saves.calls if saves is not None else None


def case_replica_rule(mesh, out):
    """Model rank 1 moves its replicated gradients and float buffers one ulp
    before each step's model-group sync, as a nondeterministic kernel would:
    2 steps of gated_v4 with the sync's rule (rank 0's values) and, as the
    control, with the rule skipped; the replicated parameters and buffers
    after each."""
    batches = [shard_batch(global_batch("demand", 70 + i), mesh) for i in range(2)]
    for rule in ("rule_on", "rule_off"):
        trainer = _trainer("gated_v4", mesh)
        state = trainer.init_state()
        model, sync = trainer.model, trainer._sync_model_ranks
        shards = sharding.parameter_shards(model)

        def perturbed(loss, flags, sync=sync, model=model, shards=shards, rule=rule):
            if trainer.model_rank == 1:
                with torch.no_grad():
                    for t in [p.grad for p in model.parameters()
                              if p.grad is not None and p not in shards] + [
                            b for b in model.buffers() if b.dtype == loss.dtype]:
                        t.copy_(torch.nextafter(t, torch.full_like(t, float("inf"))))
            if rule == "rule_on":
                return sync(loss, flags)
            trainer._stop_flag = flags
            return loss

        trainer._sync_model_ranks = perturbed
        with dropout.disabled():
            for b in batches:
                state, _ = trainer.train_step(state, b)
        out.update({f"{rule}/{n}": t.detach().clone() for n, t in
                    list(model.named_parameters()) + list(model.named_buffers())
                    if t not in shards and t.is_floating_point()})


def _optimizer_state(optimizer):
    state = optimizer.plain_state_dict()["state"]
    return {f"{i}/{k}": v.clone() for i, st in state.items() for k, v in st.items()}


def case_score_split(mesh, out, dataset):
    """``score_split`` of a sharded gated_v4 over the rank's loader of a
    dedup eval split (slots spread over the data ranks)."""
    rank, world = batch_rank_world(mesh) if mesh is not None else (0, 1)
    arrays = load_visuelle2(dataset, "test", demand=True, output_len=12)
    store = ImageStore.build(os.path.join(dataset, "images"), arrays.image_paths,
                             cache_file=ImageStore.cache_path(dataset, "test", 32), size=32)
    loader = BatchLoader(arrays, store, GLOBAL, dedup_images=True,
                         image_slots_multiple=world, rank=rank, world=world)
    model = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(12),
                  image_arch="tiny", embedding_dim=16, hidden_dim=16,
                  vocab=VocabSizes.from_dicts(*load_label_dicts(dataset)))
    if mesh is not None:
        sharding.shard_module(model, mesh, TP_MIN_DIM)
    r = score_split(model, loader, mesh=mesh, measure_throughput=False)
    out["score"] = torch.tensor([r.wape, r.mae, r.num_forecasts], dtype=torch.float64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    mesh = None
    if args.world > 1:
        distributed.initialize(args.coordinator, args.world, args.rank, device="cpu")
        mesh = make_mesh(data=args.world // 2, model=2)
    try:
        out = {}
        summary = {"rank": args.rank, "world": args.world,
                   "batch_rank": batch_rank_world(mesh) if mesh is not None else [0, 1],
                   "model_rank": model_rank_world(mesh) if mesh is not None else [0, 1]}
        case_adafactor(mesh, out)
        for name in ("m4ft", "cross_attn_rnn_210"):
            case_trajectory(mesh, out, name)
        trainer, state = case_trajectory(mesh, out, "gated_v4")
        summary["sharded"] = {name: sum(d is not None for d in sharding.infer_param_sharding(
            _trainer(name, mesh).model, mesh, TP_MIN_DIM).values()) if mesh is not None else 0
            for name in MODELS}
        case_remat_and_accum(mesh, out)
        if mesh is not None:
            case_checkpoints(mesh, out, trainer, state, args.out, args.rank)
        case_score_split(mesh, out, args.dataset)
        case_fit_autosave(mesh, summary)
        if mesh is not None:
            case_replica_rule(mesh, out)
        summary["resident_bytes"] = sharding.resident_bytes(trainer.model, state.optimizer)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                 **{k: v.detach().numpy() for k, v in out.items()})
        print(json.dumps(summary), flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
