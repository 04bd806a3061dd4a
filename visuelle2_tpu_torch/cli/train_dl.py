"""Train a CrossAttnRNN model (2-1, 2-10, Demand), counterpart of
``visuelle2_tpu/cli/train_dl.py``.

    python3 -m visuelle2_tpu_torch.cli.train_dl --dataset_path D \\
        --demand 1 --bf16_backbone --ckpt_dir ckpt_demand/

``--task_mode 0`` trains 2-1, ``--task_mode 1`` 2-10 and ``--demand 1``
(also spelled ``--new_product``) Demand.  The flags and defaults are the JAX
CLI's (unclipped Adafactor, the two best epochs kept by ``val_wWAPE``,
``--use_teacher_forcing`` / ``--teacher_forcing_ratio``, ``--resume_from
DIR|auto``, ``--accum_steps``, ``--remat``, ``--trace_dir``,
``--autosave_minutes``, early stopping, ``--learning_rate`` 0 = the fairseq
relative-step schedule) plus ``--device`` (``cuda`` unless given).  It
writes ``<ckpt_dir>/<epoch>/``, ``<ckpt_dir>/last/``, ``hparams.json`` (the
JAX trainer's keys: ``forecast_dl --ckpt_path`` reads them) and
``metrics.jsonl``, and prints the best checkpoint's path.  After a SIGTERM
it saves at the next step boundary and exits 143; the same command with
``--resume_from auto`` continues at the next step.

``--pretrained_backbone X.npz`` splices a converted backbone
(``models/pretrained.py``) into the model before the first step.
``--dedup_images 1`` trains on unique-image batches (the grouped sampler,
``data/loader.py``): each photo of a batch is encoded once.  Under a
launcher (``torchrun --nproc_per_node N -m visuelle2_tpu_torch.cli.train_dl
...``) it trains data parallel, ``--batch_size`` the global batch
(``cli/common.py``).
"""

from __future__ import annotations

import argparse

from visuelle2_tpu_torch.cli.common import (
    add_common_args,
    add_train_args,
    build_loaders,
    is_main_process,
    launcher_mesh,
    run_training,
)
from visuelle2_tpu_torch.cli.forecast_dl import make_model, model_name
from visuelle2_tpu_torch.utils.seeding import seed_everything

SAVE_TOP_K = 2


def hparams_of(args, vocab, norm_scalar) -> dict:
    """The manifest the JAX trainer writes, key for key."""
    demand = bool(args.demand)
    return {
        "cli": "train_dl", "model": model_name(demand, args.task_mode),
        "demand": int(demand), "task_mode": int(args.task_mode),
        "output_len": int(12 if demand else args.output_len),
        "embedding_dim": int(args.embedding_dim), "attention_dim": int(args.attention_dim),
        "hidden_dim": int(args.hidden_dim), "use_img": int(args.use_img),
        "image_arch": args.image_arch,
        "use_teacher_forcing": int(args.use_teacher_forcing),
        "teacher_forcing_ratio": float(args.teacher_forcing_ratio),
        "vocab": {"num_cat": vocab.num_cat, "num_col": vocab.num_col,
                  "num_fab": vocab.num_fab, "num_store": vocab.num_store},
        "norm_scalar": float(norm_scalar),
    }


def run(args):
    print(args)
    demand = bool(args.demand)
    output_len = 12 if demand else args.output_len
    with launcher_mesh(args) as (mesh, device):
        loaders, vocab, norm_scalar = build_loaders(
            args, demand=demand, output_len=output_len,
            dedup_train_images=bool(args.dedup_images),
            dedup_eval_images=True,  # the same outputs; faster per-epoch validation
            pin_memory=device.type == "cuda", mesh=mesh)
        print(f"Completed dataset loading procedure. Train batches: "
              f"{len(loaders['train'])}, test batches: {len(loaders['test'])}")
        model = make_model(args, vocab, output_len, demand=demand, device=device,
                           generator=seed_everything(args.seed), training=True)
        # Unclipped: the train_dl family's Adafactor.
        best = run_training(args, model, loaders, hparams_of(args, vocab, norm_scalar),
                            norm_scalar=norm_scalar, grad_clip=None, save_top_k=SAVE_TOP_K,
                            mesh=mesh)
        if is_main_process():
            print(best)
    return best


def build_parser():
    p = argparse.ArgumentParser(description="CrossAttnRNN trainer on Visuelle 2.0")
    add_common_args(p)
    # The reference spells this --new_product on the train CLI too.
    p.add_argument("--demand", "--new_product", type=int, default=0)
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--attention_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--output_len", type=int, default=10)
    p.add_argument("--use_img", type=int, default=1)
    p.add_argument("--task_mode", type=int, default=0, help="0->2-1, 1->2-10")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--use_teacher_forcing", action="store_true")
    p.add_argument("--teacher_forcing_ratio", type=float, default=0.5)
    p.add_argument("--dedup_images", type=int, default=0,
                   help="unique-image training batches (the grouped sampler)")
    p.add_argument("--ckpt_dir", type=str, default="ckpt_CrossAttnRNN210/")
    add_train_args(p)
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
