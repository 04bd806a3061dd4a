"""Score a GTM-family model (GTM / M4FT / Gated v1–v4, ``gtm_v1``) on a
dataset's test split, counterpart of
``visuelle2_tpu/cli/forecast_transformer.py``.

    python3 -m visuelle2_tpu_torch.cli.forecast_transformer --dataset_path D \\
        --model gated_v4 --demand 1 --output_len 12 --bf16_backbone

prints WAPE / MAE / forecasts/s / GFLOPs per sample / peak device memory.
The flags are the JAX CLI's (its train parser's and its own, with the
``--num_layers`` alias) plus ``--device`` (``cuda`` unless given).
``--ckpt_path`` (a ``train_transformer`` directory or one of its epoch
directories; the best epoch by default) restores the parameters and
BatchNorm statistics; the structural flags not passed are filled from its
``hparams.json``, a conflicting one is an error, and the dataset is checked
against the manifest; for ``gtm_v1`` (Demand only, on the ingest-time text
features) a ``text_fingerprint`` other than this host's featurizer's is an
error.  Without it the CLI scores a model drawn from ``--seed``, as the JAX
CLI does.  ``--dump_attention`` writes gtm_v1's decoder attention weights.
``--export PATH`` then writes the model as a serving artifact
(``eval/export.py``; ``--quantize int8`` stores int8 weights) with
``provenance`` ``{"model", "text_fingerprint" (gtm_v1)}``; ``cli/serve.py``
scores or serves it.  ``--quantize w8a8`` scores (and exports) the model
with its ResNet backbone on the int8 engine (``models/quantized_resnet.py``),
calibrated on ``--calib_batches`` batches of ``--calib_split`` (``train``
loads the train split too); ``--quantize auto`` picks w8a8 or float by the
image duplication (``cli/common.py::resolve_quantize``).  Under a launcher
it scores data parallel (``cli/common.py``).
"""

from __future__ import annotations

import argparse

import torch

from visuelle2_tpu_torch.cli.common import (
    add_common_args,
    add_forecast_args,
    add_train_args,
    build_loaders,
    calib_splits,
    is_main_process,
    launcher_mesh,
    score_and_export,
)
from visuelle2_tpu_torch.models import build
from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_path
from visuelle2_tpu_torch.train.hparams import (
    TRANSFORMER_STRUCTURAL,
    apply_ckpt_hparams,
    check_dataset_compat,
    check_text_fingerprint,
)
from visuelle2_tpu_torch.utils.seeding import seed_everything

TRANSFORMER_MODELS = ["gtm", "m4ft", "gated_v1", "gated_v2", "gated_v3", "gated_v4",
                      "gtm_v1"]


def make_model(args, vocab, *, device=None, generator=None):
    kw = dict(
        embedding_dim=args.embedding_dim,
        hidden_dim=args.hidden_dim,
        output_len=args.output_len,
        num_heads=args.num_attn_heads,
        num_layers=args.num_hidden_layers,
        use_encoder_mask=bool(args.use_encoder_mask),
        autoregressive=bool(args.autoregressive),
        use_text=bool(args.use_text),
        use_img=bool(args.use_img),
        image_arch=args.image_arch,
        image_dtype=torch.bfloat16 if args.bf16_backbone else torch.float32,
        image_remat=bool(getattr(args, "remat", False)),
    )
    if args.model == "gtm_v1":
        return build("gtm_v1", device=device, generator=generator, **kw)
    return build(args.model, device=device, generator=generator, vocab=vocab,
                 query_modality=args.query_modality, **kw)


def run(args, parser=None, argv=None):
    """Score the test split; ``parser`` and ``argv`` tell ``--ckpt_path``
    which flags were passed (the command line's when not given)."""
    hp = None
    if args.ckpt_path:
        ckpt_root, ckpt_step = resolve_ckpt_path(args.ckpt_path)
        # Read-only: raises for a directory that does not exist.
        ckpt = CheckpointManager(ckpt_root, read_only=True)
        hp = apply_ckpt_hparams(args, parser or build_parser(), TRANSFORMER_STRUCTURAL,
                                argv)
    print(args)
    demand = bool(args.demand)
    if args.model == "gtm_v1" and not demand:
        raise SystemExit("gtm_v1 is demand-only; use --demand 1")
    with launcher_mesh(args) as (mesh, device):
        loaders, vocab, norm_scalar = build_loaders(
            args, demand=demand, output_len=args.output_len, splits=calib_splits(args),
            text_features=args.model == "gtm_v1", dedup_eval_images=bool(args.dedup_images),
            pin_memory=device.type == "cuda", mesh=mesh)
        check_dataset_compat(hp, vocab, norm_scalar)
        if args.model == "gtm_v1":
            check_text_fingerprint(hp, getattr(loaders["test"], "text_fingerprint", None))
        model = make_model(args, vocab, device=device, generator=seed_everything(args.seed))
        if args.ckpt_path:
            ckpt.restore_for_eval(model, ckpt_step)
            if is_main_process():
                print(f"restored {ckpt_root} epoch "
                      f"{ckpt.best_step() if ckpt_step is None else ckpt_step}")
        fingerprint = getattr(loaders["test"], "text_fingerprint", None)
        return score_and_export(args, model, loaders, norm_scalar, {
            "model": args.model,
            **({"text_fingerprint": fingerprint} if args.model == "gtm_v1" else {})},
            mesh=mesh)


def add_model_args(p, default_model="gtm"):
    """The JAX train parser's flags (``visuelle2_tpu/cli/train_transformer.py``);
    the training ones are accepted and not read when forecasting."""
    p.add_argument("--model", type=str, default=default_model, choices=TRANSFORMER_MODELS)
    p.add_argument("--ckpt_dir", type=str, default="ckpt_gtm/")
    p.add_argument("--demand", type=int, default=1)
    p.add_argument("--output_len", type=int, default=12)
    p.add_argument("--embedding_dim", type=int, default=32)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--num_attn_heads", type=int, default=4)
    p.add_argument("--num_hidden_layers", type=int, default=1)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--use_img", type=int, default=1)
    p.add_argument("--use_text", type=int, default=1)
    p.add_argument("--use_encoder_mask", type=int, default=1)
    p.add_argument("--autoregressive", type=int, default=0)
    p.add_argument("--query_modality", type=str, default="text",
                   choices=["text", "image", "temporal"])
    p.add_argument("--dedup_images", type=int, default=0,
                   help="encode each unique product photo once per batch")
    return add_train_args(p)


def build_parser(default_model="gtm"):
    p = argparse.ArgumentParser(description="Score a GTM-family model on Visuelle 2.0")
    add_common_args(p)
    add_model_args(p, default_model)
    # The reference forecasters say --num_layers where its trainers say
    # --num_hidden_layers; both are accepted.
    p.add_argument("--num_layers", dest="num_hidden_layers", type=int,
                   default=argparse.SUPPRESS, help="alias of --num_hidden_layers")
    add_forecast_args(p, dump_help="save the first test batch's attention weights (.npz); "
                                   "gtm_v1's memory-only decoder returns them")
    # Eval dedup gives the same outputs, so it is on by default here.
    p.set_defaults(dedup_images=1)
    return p


def main(argv=None):
    parser = build_parser()
    return run(parser.parse_args(argv), parser, argv)


if __name__ == "__main__":
    main()
