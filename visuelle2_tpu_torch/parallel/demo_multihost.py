"""Multi-process training demo, counterpart of ``scripts/demo_multihost.py``:
tensor parallel over a ``model`` axis of 2 by default, as the JAX demo.

Launch one process a rank (the same global batch and seeds in each):

    python -m visuelle2_tpu_torch.parallel.demo_multihost --coordinator 127.0.0.1:9911 \\
        --num_processes 2 --process_id 0 --device cpu &
    python -m visuelle2_tpu_torch.parallel.demo_multihost --coordinator 127.0.0.1:9911 \\
        --num_processes 2 --process_id 1 --device cpu

(a ``(dcn 1, data 1, model 2)`` mesh; four ranks give ``data`` 2), or one
with no ``--coordinator`` and ``--model_axis 1`` (the control: no process
group; a process owns one device, so a model axis needs as many ranks).
Each data index feeds only its own rows of every batch
(``distributed.global_batch``; the ``model`` ranks of one data index the
same rows); parameters whose flax trailing dim is at least 32 wide (the JAX
demo's ``tp_min_dim``) are split over the ``model`` axis
(``parallel/sharding.py``); the gradients, the loss's denominator, the
BatchNorm statistics and the eval sums are reduced over the data ranks, the
dropout masks drawn for the global batch (``train/loop.py``).  It trains
gated_v4 (E=32, H=64, the tiny backbone at 64² unless told otherwise)
``--steps`` steps on one synthetic global batch and prints one JSON line
with the JAX demo's keys, ``process``, ``processes``, ``mesh``, ``losses``
and ``eval_sums`` (unrounded): equal across ranks, and against one process
on the same global batch within float tolerance.

The JAX demo's flags, plus ``--device {cpu,cuda}`` and ``--backend
{gloo,nccl}`` (gloo over CUDA tensors lets two ranks share one card);
``--devices_per_process`` must be 1 (a process owns one device).
``--no_dropout``, ``--learning_rate``, ``--image_arch``,
``--image_size``, ``--bf16_backbone``, ``--batch_seed`` and
``--params_out`` (an ``.npz`` of the trained parameters, ``param/<name>``,
gathered into the plain model's, and each step's gradient, summed over the
data ranks, ``grad<step>/<name>``, with ``--model_axis 1`` only; written by
rank 0) serve the checks.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

WEIGHTS_SEED = 0  # the model's weights are drawn from this seed in every process
TP_MIN_DIM = 32  # the JAX demo's tensor-parallel width


def synthetic_global_batch(n, image_size=64, seed=0):
    """The JAX demo's global batch (``scripts/demo_multihost.py``)."""
    rng = np.random.default_rng(seed)
    return {
        "ts": rng.random((n, 12)).astype(np.float32),
        "cat": rng.integers(0, 5, n).astype(np.int32),
        "col": rng.integers(0, 6, n).astype(np.int32),
        "fab": rng.integers(0, 5, n).astype(np.int32),
        "store": rng.integers(0, 126, n).astype(np.int32),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "images": rng.integers(0, 255, (n, image_size, image_size, 3)).astype(np.uint8),
        "mask": np.ones((n,), np.float32),
    }


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None, help="host:port; omit for one process")
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--devices_per_process", type=int, default=1)
    ap.add_argument("--model_axis", type=int, default=2)
    ap.add_argument("--global_batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--no_dropout", action="store_true")
    ap.add_argument("--learning_rate", type=float, default=0.0,
                    help="fixed Adafactor rate; 0 = the relative-step schedule")
    ap.add_argument("--image_arch", default="tiny")
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--bf16_backbone", action="store_true")
    ap.add_argument("--batch_seed", type=int, default=0, help="the global batch's seed")
    ap.add_argument("--params_out", default="", help="rank 0 writes the trained parameters")
    return ap


def run(args) -> dict:
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops import dropout
    from visuelle2_tpu_torch.parallel import distributed, sharding
    from visuelle2_tpu_torch.parallel.mesh import mesh_shape
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    if args.devices_per_process != 1:
        raise SystemExit("--devices_per_process: a process owns one device here")
    # Float32 is float32: the runs compared differ in batch size, and TF32's
    # 10-bit products would set how far apart they may be.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.num_processes > 1:
        device = distributed.initialize(args.coordinator, args.num_processes,
                                        args.process_id, device=args.device,
                                        backend=args.backend)
    else:
        device = torch.device(args.device)
    try:
        mesh = distributed.make_hybrid_mesh(model=args.model_axis)
        local = distributed.global_batch(
            synthetic_global_batch(args.global_batch, args.image_size, seed=args.batch_seed),
            mesh)
        model = build("gated_v4", device=device, generator=torch.Generator().manual_seed(
            WEIGHTS_SEED), vocab=VocabSizes(5, 6, 5, 126), output_len=12, embedding_dim=32,
            hidden_dim=64, image_arch=args.image_arch,
            image_dtype=torch.bfloat16 if args.bf16_backbone else torch.float32)
        trainer = Trainer(model, TrainConfig(grad_clip=0.5,
                                             learning_rate=args.learning_rate or None,
                                             tp_min_dim=TP_MIN_DIM),
                          mesh=mesh)
        state = trainer.init_state()
        losses, saved = [], {}
        sharded = sharding.is_sharded(model)
        with dropout.disabled() if args.no_dropout else contextlib.nullcontext():
            for i in range(args.steps):
                state, m = trainer.train_step(state, local)
                losses.append(float(m["loss"]))
                if not sharded:
                    saved.update({f"grad{i}/{n}": p.grad.detach().cpu().numpy()
                                  for n, p in model.named_parameters() if p.grad is not None})
            sums = {k: float(v) for k, v in trainer.eval_step(state, local).items()}
        if args.params_out:
            names = {sharding.plain_name(n) for n, _ in model.named_parameters()}
            params = {n: t for n, t in sharding.plain_state_dict(model).items() if n in names}
            if trainer.is_main:
                saved.update({f"param/{n}": t.detach().cpu().numpy()
                              for n, t in params.items()})
                np.savez(args.params_out, **saved)
        return {"process": args.process_id, "processes": args.num_processes,
                "mesh": mesh_shape(mesh), "losses": losses, "eval_sums": sums}
    finally:
        distributed.shutdown()


def main(argv=None):
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
