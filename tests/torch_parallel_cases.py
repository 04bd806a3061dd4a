"""Data-parallel cases of the port, run by ``tests/test_torch_parallel.py``
in one process per rank (gloo on the CPU) and in one process alone.

    python tests/torch_parallel_cases.py --out DIR --dataset D [--coordinator H:P \\
        --world 2 --rank R]

Each rank computes every case on its row block of the same global inputs
(made from seeds with numpy) and writes its results to ``DIR/rank<R>.npz``;
the process alone (``--world 1``, no process group) writes the
single-device results on the whole global batch to ``DIR/rank0.npz``.  It
prints one JSON line of scalars: the test compares the files.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from visuelle2_tpu_torch.data.images import ImageStore  # noqa: E402
from visuelle2_tpu_torch.data.loader import BatchLoader, shard_batch  # noqa: E402
from visuelle2_tpu_torch.data.pipeline import load_label_dicts, load_visuelle2  # noqa: E402
from visuelle2_tpu_torch.eval.forecast import score_split  # noqa: E402
from visuelle2_tpu_torch.models import VocabSizes, build  # noqa: E402
from visuelle2_tpu_torch.models import norms, resnet  # noqa: E402
from visuelle2_tpu_torch.ops import dropout  # noqa: E402
from visuelle2_tpu_torch.parallel import collectives, distributed  # noqa: E402
from visuelle2_tpu_torch.parallel.demo_multihost import synthetic_global_batch  # noqa: E402
from visuelle2_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from visuelle2_tpu_torch.train import loop  # noqa: E402

GLOBAL = 8  # rows of each case's global batch
SMALL = dict(vocab=VocabSizes(5, 6, 5, 126), image_arch="tiny", embedding_dim=16,
             hidden_dim=16)
LR = 1e-3


def _grads(model, prefix):
    """The step's gradients (data parallel: summed over the ranks)."""
    return {f"{prefix}_grad/{n}": p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _trainer(name, mesh, seed=3, config=None, **kw):
    model = build(name, device="cpu", generator=torch.Generator().manual_seed(seed),
                  **SMALL, **kw)
    return loop.Trainer(model, config or loop.TrainConfig(grad_clip=0.5, learning_rate=LR),
                        mesh=mesh)


def case_batchnorm(mesh, out):
    """Train-mode BatchNorm (2-d and 1-d) on this rank's rows: the output,
    the input's gradient of a global loss and the running statistics."""
    rng = np.random.default_rng(1)
    x2 = rng.normal(1.0, 2.0, (GLOBAL, 6, 5, 5)).astype(np.float32)
    w2 = rng.normal(size=x2.shape).astype(np.float32)
    x1 = rng.normal(-1.0, 3.0, (GLOBAL, 10)).astype(np.float32)
    w1 = rng.normal(size=x1.shape).astype(np.float32)
    for key, bn, x, w in (("bn2d", resnet.BatchNorm(6), x2, w2),
                          ("bn1d", norms.BatchNorm1d(10), x1, w1)):
        with torch.no_grad():
            bn.weight.normal_(1.0, 0.3, generator=torch.Generator().manual_seed(2))
            bn.bias.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(3))
        local = shard_batch({"x": x, "w": w}, mesh)
        xt = local["x"].requires_grad_()
        with collectives.data_parallel(mesh):
            y = bn.train()(xt)
            (y * local["w"]).sum().backward()
        out[f"{key}_y"] = y.detach()
        out[f"{key}_xgrad"] = xt.grad
        out[f"{key}_running_mean"] = bn.running_mean
        out[f"{key}_running_var"] = bn.running_var


def case_masked_mse(mesh, out):
    """The masked MSE with the last rank holding padded rows: this rank's
    share of the global loss, summed over the ranks, and its gradient."""
    rng = np.random.default_rng(4)
    target = rng.normal(size=(GLOBAL, 12)).astype(np.float32)
    pred = rng.normal(size=(GLOBAL, 12)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    local = shard_batch({"t": target, "p": pred, "m": mask}, mesh)
    p = local["p"].requires_grad_()
    trainer = _trainer("gated_v4", mesh)
    loss = loop.mse_loss(local["t"], p, local["m"], group=trainer._group)
    loss.backward()
    total = loss.detach().clone()
    trainer._sum_over_ranks(total)
    out["mse_loss"] = total
    out["mse_pred_grad"] = p.grad


def case_padded_step(mesh, out):
    """One Trainer step of gated_v4 on a global batch whose last three rows
    are padding (the last rank's real rows fewer than the others')."""
    batch = synthetic_global_batch(GLOBAL, 64, seed=5)
    batch["mask"][5:] = 0.0
    trainer = _trainer("gated_v4", mesh)
    state, m = trainer.train_step(trainer.init_state(), shard_batch(batch, mesh))
    out["padded_loss"] = m["loss"]
    out.update(_grads(trainer.model, "padded"))


def case_dropout(mesh, out):
    """Masks drawn under ``data_parallel`` from one generator: this rank's
    rows of the global batch's masks."""
    rank_rows = GLOBAL // _world(mesh)
    gen = torch.Generator().manual_seed(6)
    with collectives.data_parallel(mesh), dropout.use_generator(gen):
        out["dropout_3d"] = dropout.dropout(torch.ones(rank_rows, 3, 5), 0.5, True)
        out["dropout_2d"] = dropout.dropout(torch.ones(rank_rows, 7), 0.3, True)


def _dedup_batch():
    """Demand rows over 4 image slots; the first rank's rows read slots of
    the last rank (slots 2 and 3 at two ranks)."""
    b = synthetic_global_batch(GLOBAL, 64, seed=7)
    b["images"] = b["images"][:4]
    b["img_idx"] = np.array([3, 3, 2, 0, 1, 0, 2, 3], np.int32)
    return b


def case_dedup(mesh, out):
    """A dedup batch through Demand (patch tokens, dropout on their slots)
    and gated_v4 (pooled): a train step, the eval sums, eval forecasts."""
    batch = shard_batch(_dedup_batch(), mesh)
    for name, kw in (("cross_attn_rnn_demand", dict(attention_dim=16,
                                                    use_teacher_forcing=True)),
                     ("gated_v4", {})):
        trainer = _trainer(name, mesh, **kw)
        state, m = trainer.train_step(trainer.init_state(), batch)
        out[f"dedup_{name}_loss"] = m["loss"]
        out.update(_grads(trainer.model, f"dedup_{name}"))
        sums = trainer.eval_step(state, batch)
        out[f"dedup_{name}_eval_sums"] = torch.stack([sums[k] for k in loop.SUM_KEYS])
        with torch.inference_mode(), collectives.data_parallel(mesh):
            out[f"dedup_{name}_forecast"] = trainer.model.eval()(batch)[0].clone()


def case_demand_teacher_forcing(mesh, out):
    """Demand with teacher forcing at ratio 0.5 and dropout on, through the
    additive attention's plain version: two Trainer steps.  Without the
    image (``use_img=False``): no backbone ReLU input near zero can take
    the other sign at the other world size, which ``case_dedup`` leaves to
    its four photos."""
    trainer = _trainer("cross_attn_rnn_demand", mesh, attention_dim=16, use_img=False,
                       use_teacher_forcing=True, teacher_forcing_ratio=0.5)
    state = trainer.init_state()
    losses = []
    for seed in (8, 9):
        state, m = trainer.train_step(state, shard_batch(
            synthetic_global_batch(GLOBAL, 64, seed=seed), mesh))
        losses.append(m["loss"])
        if seed == 8:
            out.update(_grads(trainer.model, "tf"))
    out["tf_losses"] = torch.stack(losses)


def case_remat_and_accum(mesh, out):
    """gated_v4 with ``--remat`` (the recomputation re-issues the
    BatchNorm collectives), then an accumulated step of two microbatches."""
    batches = [shard_batch(synthetic_global_batch(GLOBAL, 64, seed=s), mesh) for s in (10, 11)]
    trainer = _trainer("gated_v4", mesh, image_remat=True)
    state, m = trainer.train_step(trainer.init_state(), batches[0])
    out["remat_loss"] = m["loss"]
    out.update(_grads(trainer.model, "remat"))
    trainer = _trainer("gated_v4", mesh, config=loop.TrainConfig(
        grad_clip=0.5, learning_rate=LR, accum_steps=2))
    state, m = trainer.accum_train_step(trainer.init_state(), batches)
    out["accum_loss"] = m["loss"]
    out.update(_grads(trainer.model, "accum"))


def case_score_split(mesh, out, dataset):
    """``score_split`` over the rank's loader of a dedup eval split (slots
    spread over the ranks)."""
    rank, world = _rank(mesh), _world(mesh)
    arrays = load_visuelle2(dataset, "test", demand=True, output_len=12)
    store = ImageStore.build(os.path.join(dataset, "images"), arrays.image_paths,
                             cache_file=ImageStore.cache_path(dataset, "test", 32), size=32)
    loader = BatchLoader(arrays, store, GLOBAL, dedup_images=True,
                         image_slots_multiple=world, rank=rank, world=world)
    model = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(12),
                  **dict(SMALL, vocab=VocabSizes.from_dicts(*load_label_dicts(dataset))))
    r = score_split(model, loader, mesh=mesh, measure_throughput=False)
    out["score"] = torch.tensor([r.wape, r.mae, r.num_forecasts], dtype=torch.float64)


class _Saves:
    """A checkpointer that records its saves."""

    def __init__(self):
        self.calls = []

    def save(self, epoch, state, metrics):
        self.calls.append(("save", epoch))

    def save_preempted(self, epoch, state, steps_into_epoch=0):
        self.calls.append(("save_preempted", epoch, steps_into_epoch))


def case_fit_sigterm(mesh, out, summary):
    """``fit`` over 8 global batches where the last rank (or the process
    alone) gets a SIGTERM while its second batch is assembled: every rank
    stops at the same step boundary, rank 0 alone saves."""
    rank, world = _rank(mesh), _world(mesh)
    batches = [shard_batch(synthetic_global_batch(GLOBAL, 64, seed=20 + i), mesh)
               for i in range(8)]

    class Loader(list):
        def __iter__(self):
            for i, b in enumerate(list.__iter__(self)):
                if i == 1 and rank == world - 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

    trainer = _trainer("gated_v4", mesh, config=loop.TrainConfig(
        epochs=1, grad_clip=0.5, learning_rate=LR))
    saves = _Saves()
    with dropout.disabled():
        trainer.fit(Loader(batches), batches[:1], checkpointer=saves)
    summary["fit_last"] = trainer.history[-1]
    summary["fit_saves"] = saves.calls


def case_fit_autosave(mesh, summary):
    """``fit`` over 4 global batches with an autosave due at every step:
    over a process group rank 0's deadline rides in the step's flags, read
    two steps later, and rank 0 alone saves."""
    batches = [shard_batch(synthetic_global_batch(GLOBAL, 64, seed=40 + i), mesh)
               for i in range(4)]
    trainer = _trainer("gated_v4", mesh, config=loop.TrainConfig(
        epochs=1, grad_clip=0.5, learning_rate=LR, autosave_minutes=1e-9))
    saves = _Saves()
    with dropout.disabled():
        trainer.fit(batches, batches[:1], checkpointer=saves)
    summary["autosave_saves"] = saves.calls


def _rank(mesh):
    from visuelle2_tpu_torch.parallel.mesh import batch_rank_world

    return batch_rank_world(mesh)[0]


def _world(mesh):
    from visuelle2_tpu_torch.parallel.mesh import batch_rank_world

    return batch_rank_world(mesh)[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.world > 1:
        distributed.initialize(args.coordinator, args.world, args.rank, device="cpu")
    try:
        mesh = make_mesh()
        out, summary = {}, {"rank": args.rank, "world": args.world}
        for case in (case_batchnorm, case_masked_mse, case_padded_step, case_dropout,
                     case_dedup, case_demand_teacher_forcing, case_remat_and_accum):
            case(mesh, out)
        case_score_split(mesh, out, args.dataset)
        case_fit_sigterm(mesh, out, summary)
        case_fit_autosave(mesh, summary)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                 **{k: v.detach().numpy() for k, v in out.items()})
        print(json.dumps(summary), flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
