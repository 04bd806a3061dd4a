"""Score a CrossAttnRNN model on a dataset's test split, counterpart of
``visuelle2_tpu/cli/forecast_dl.py``.

    python3 -m visuelle2_tpu_torch.cli.forecast_dl --dataset_path D \\
        --new_product 1 --bf16_backbone

prints WAPE / MAE / forecasts/s / GFLOPs per sample.  The horizon: Demand
(``--new_product 1``) forecasts 12 weeks, task 1 (2-10) 10, task 0 (2-1)
``--output_len``.  Without ``--ckpt_path`` it scores a model drawn from
``--seed``; ``--ckpt_path`` (CrossAttnRNN training is ROADMAP item 8b),
``--export`` and a ``--quantize`` mode raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse

import torch

from visuelle2_tpu_torch.cli.common import (
    DL_LATER_FLAGS,
    add_common_args,
    add_forecast_args,
    build_loaders,
    check_later_flags,
    resolve_cli_device,
    score_test_split,
)
from visuelle2_tpu_torch.models import build
from visuelle2_tpu_torch.utils.seeding import seed_everything


def output_len_of(args) -> int:
    if args.new_product:
        return 12
    if args.task_mode == 1 and args.output_len == 1:
        return 10
    return args.output_len


def make_model(args, vocab, output_len, *, device=None, generator=None):
    dims = dict(attention_dim=args.attention_dim, embedding_dim=args.embedding_dim,
                hidden_dim=args.hidden_dim, vocab=vocab, use_img=bool(args.use_img),
                image_arch=args.image_arch,
                image_dtype=torch.bfloat16 if args.bf16_backbone else torch.float32)
    name = ("cross_attn_rnn_demand" if args.new_product
            else "cross_attn_rnn_21" if args.task_mode == 0 else "cross_attn_rnn_210")
    return build(name, device=device, generator=generator, out_len=output_len, **dims)


def run(args):
    print(args)
    check_later_flags(args, DL_LATER_FLAGS)
    demand = bool(args.new_product)
    output_len = output_len_of(args)
    device = resolve_cli_device(args)
    loaders, vocab, norm_scalar = build_loaders(
        args, demand=demand, output_len=output_len, splits=("test",),
        dedup_eval_images=bool(args.dedup_images), pin_memory=device.type == "cuda")
    model = make_model(args, vocab, output_len, device=device,
                       generator=seed_everything(args.seed))
    result = score_test_split(args, model, loaders["test"], norm_scalar)
    print(f"GFLOPS: {result.gflops_per_sample}")
    return result


def build_parser():
    p = argparse.ArgumentParser(description="Score a CrossAttnRNN model on Visuelle 2.0")
    add_common_args(p)
    p.add_argument("--new_product", type=int, default=0)
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--attention_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--use_img", type=int, default=1)
    p.add_argument("--task_mode", type=int, default=0, help="0->2-1, 1->2-10")
    p.add_argument("--output_len", type=int, default=1,
                   help="forecast horizon; Demand forecasts 12, task 1 10 when "
                        "this is left at 1")
    # Accepted for reference CLI parity; inference never teacher-forces.
    p.add_argument("--use_teacher_forcing", action="store_true")
    p.add_argument("--teacher_forcing_ratio", type=float, default=0.3)
    add_forecast_args(p, dump_help="save the first test batch's attention weights "
                                   "(.npz): Demand's per-step img/trend/multimodal alphas")
    p.add_argument("--dedup_images", type=int, default=1,
                   help="encode each unique product photo once per batch (same outputs)")
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
