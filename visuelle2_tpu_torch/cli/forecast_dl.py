"""Score a CrossAttnRNN model on a dataset's test split, counterpart of
``visuelle2_tpu/cli/forecast_dl.py``.

    python3 -m visuelle2_tpu_torch.cli.forecast_dl --dataset_path D \\
        --new_product 1 --bf16_backbone

prints WAPE / MAE / forecasts/s / GFLOPs per sample.  The horizon: Demand
(``--new_product 1``) forecasts 12 weeks; otherwise ``--output_len``, and
when that is left at 1, the checkpoint manifest's horizon or, without one,
10 for task 1 (2-10).  ``--ckpt_path`` (a ``train_dl`` directory or one of
its epoch directories; the best epoch by default) restores the parameters
and BatchNorm statistics; the structural flags not passed are filled from
its ``hparams.json``, a conflicting one is an error, and the dataset is
checked against the manifest.  Without it the CLI scores a model drawn from
``--seed``.  ``--export PATH`` then writes the model as a serving artifact
(``eval/export.py``; ``--quantize int8`` stores int8 weights) with
``provenance`` ``{"model": <class name>}``; ``cli/serve.py`` scores or serves
it.  ``--quantize w8a8`` scores (and exports) the model with its ResNet
backbone on the int8 engine (``models/quantized_resnet.py``), calibrated on
``--calib_batches`` batches of ``--calib_split``; ``--quantize auto`` picks
w8a8 or float by the image duplication (``cli/common.py::resolve_quantize``).
Under a launcher it scores data parallel (``cli/common.py``).
"""

from __future__ import annotations

import argparse

import torch

from visuelle2_tpu_torch.cli.common import (
    add_common_args,
    add_forecast_args,
    build_loaders,
    calib_splits,
    is_main_process,
    launcher_mesh,
    score_and_export,
)
from visuelle2_tpu_torch.models import build
from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_path
from visuelle2_tpu_torch.train.hparams import (
    DL_STRUCTURAL,
    apply_ckpt_hparams,
    check_dataset_compat,
)
from visuelle2_tpu_torch.utils.seeding import seed_everything


def output_len_of(args, hp=None) -> int:
    """The horizon: 12 for Demand; ``--output_len`` when set; when left at
    1, the manifest ``hp``'s, else 10 for task 1 (2-10)."""
    if args.new_product:
        return 12
    if args.output_len == 1:
        if hp and "output_len" in hp:
            return int(hp["output_len"])
        if args.task_mode == 1:
            return 10
    return args.output_len


def model_name(demand: bool, task_mode: int) -> str:
    if demand:
        return "cross_attn_rnn_demand"
    return "cross_attn_rnn_21" if task_mode == 0 else "cross_attn_rnn_210"


def make_model(args, vocab, output_len, *, demand: bool, device=None, generator=None,
               training: bool = False):
    """The CrossAttnRNN model the flags name.  ``training``: the train CLI's
    model, with ``--remat`` and (2-10, Demand) ``--use_teacher_forcing`` /
    ``--teacher_forcing_ratio``; a forecast never teacher-forces."""
    name = model_name(demand, args.task_mode)
    kw = dict(attention_dim=args.attention_dim, embedding_dim=args.embedding_dim,
              hidden_dim=args.hidden_dim, vocab=vocab, use_img=bool(args.use_img),
              image_arch=args.image_arch,
              image_dtype=torch.bfloat16 if args.bf16_backbone else torch.float32,
              image_remat=training and bool(args.remat))
    if name != "cross_attn_rnn_21":
        kw.update(use_teacher_forcing=training and bool(args.use_teacher_forcing),
                  teacher_forcing_ratio=args.teacher_forcing_ratio)
    return build(name, device=device, generator=generator, out_len=output_len, **kw)


def run(args, parser=None, argv=None):
    """Score the test split; ``parser`` and ``argv`` tell ``--ckpt_path``
    which flags were passed (the command line's when not given)."""
    hp = None
    if args.ckpt_path:
        ckpt_root, ckpt_step = resolve_ckpt_path(args.ckpt_path)
        # Read-only: raises for a directory that does not exist.
        ckpt = CheckpointManager(ckpt_root, read_only=True)
        hp = apply_ckpt_hparams(args, parser or build_parser(), DL_STRUCTURAL, argv)
    print(args)
    demand = bool(args.new_product)
    output_len = output_len_of(args, hp)
    with launcher_mesh(args) as (mesh, device):
        loaders, vocab, norm_scalar = build_loaders(
            args, demand=demand, output_len=output_len, splits=calib_splits(args),
            dedup_eval_images=bool(args.dedup_images), pin_memory=device.type == "cuda",
            mesh=mesh)
        check_dataset_compat(hp, vocab, norm_scalar)
        model = make_model(args, vocab, output_len, demand=demand, device=device,
                           generator=seed_everything(args.seed))
        if args.ckpt_path:
            ckpt.restore_for_eval(model, ckpt_step)
            if is_main_process():
                print(f"restored {ckpt_root} epoch "
                      f"{ckpt.best_step() if ckpt_step is None else ckpt_step}")
        result = score_and_export(args, model, loaders, norm_scalar,
                                  {"model": type(model).__name__}, mesh=mesh)
        if is_main_process():
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
    parser = build_parser()
    return run(parser.parse_args(argv), parser, argv)


if __name__ == "__main__":
    main()
