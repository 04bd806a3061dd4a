"""Train a GTM-family model (GTM / M4FT / Gated v1–v4, and the VISUELLE-1
GTM ``gtm_v1``), counterpart of ``visuelle2_tpu/cli/train_transformer.py``.

    python3 -m visuelle2_tpu_torch.cli.train_transformer --dataset_path D \\
        --model gated_v4 --bf16_backbone --ckpt_dir ckpt_gtm/

The flags and defaults are the JAX CLI's (global-norm clip 0.5, the best
epoch kept by ``val_wWAPE``, ``--resume_from DIR|auto``, ``--accum_steps``,
``--remat``, ``--trace_dir``, ``--autosave_minutes``, early stopping,
``--learning_rate`` 0 = the fairseq relative-step schedule) plus
``--device`` (``cuda`` unless given).  It writes ``<ckpt_dir>/<epoch>/``,
``<ckpt_dir>/last/``, ``hparams.json`` (the structural flags, the
vocabulary sizes and the norm scalar: ``forecast_transformer --ckpt_path``
reads them) and ``metrics.jsonl``, and prints the best checkpoint's path.
After a SIGTERM it saves at the next step boundary and exits 143; the same
command with ``--resume_from auto`` continues at the next step.

``gtm_v1`` trains on Demand only (``--demand 1``), on the ingest-time text
features (``cli/common.py::build_loaders``), and its manifest records their
featurizer's ``text_fingerprint``.  ``--pretrained_backbone X.npz`` splices
a converted backbone (``models/pretrained.py``) into the model before the
first step.  ``--dedup_images 1`` (the grouped sampler, ROADMAP Queue 1 item
11) raises.
"""

from __future__ import annotations

import argparse

from visuelle2_tpu_torch.cli.common import (
    add_common_args,
    build_loaders,
    resolve_cli_device,
    run_training,
)
from visuelle2_tpu_torch.cli.forecast_transformer import add_model_args, make_model
from visuelle2_tpu_torch.utils.seeding import seed_everything

GRAD_CLIP = 0.5  # the transformer family's global-norm clip
SAVE_TOP_K = 1


def hparams_of(args, vocab, norm_scalar, text_fingerprint=None) -> dict:
    """The manifest the JAX trainer writes, key for key; gtm_v1's also
    records ``text_fingerprint``."""
    extra = {"text_fingerprint": text_fingerprint} if args.model == "gtm_v1" else {}
    return {
        "cli": "train_transformer", "model": args.model,
        "demand": int(args.demand), "output_len": int(args.output_len),
        "embedding_dim": int(args.embedding_dim), "hidden_dim": int(args.hidden_dim),
        "num_attn_heads": int(args.num_attn_heads),
        "num_hidden_layers": int(args.num_hidden_layers),
        "use_img": int(args.use_img), "use_text": int(args.use_text),
        "use_encoder_mask": int(args.use_encoder_mask),
        "autoregressive": int(args.autoregressive),
        "query_modality": args.query_modality, "image_arch": args.image_arch,
        "vocab": {"num_cat": vocab.num_cat, "num_col": vocab.num_col,
                  "num_fab": vocab.num_fab, "num_store": vocab.num_store},
        "norm_scalar": float(norm_scalar),
        **extra,
    }


def run(args):
    print(args)
    if args.model == "gtm_v1" and not args.demand:
        raise SystemExit("gtm_v1 is demand-only (the original VISUELLE-1 GTM has no "
                         "windowed stfore path); use --demand 1")
    device = resolve_cli_device(args)
    loaders, vocab, norm_scalar = build_loaders(
        args, demand=bool(args.demand), output_len=args.output_len,
        text_features=args.model == "gtm_v1", dedup_train_images=bool(args.dedup_images),
        dedup_eval_images=True,  # the same outputs; faster per-epoch validation
        pin_memory=device.type == "cuda")
    model = make_model(args, vocab, device=device, generator=seed_everything(args.seed))
    hparams = hparams_of(args, vocab, norm_scalar,
                         getattr(loaders["train"], "text_fingerprint", None))
    best = run_training(args, model, loaders, hparams,
                        norm_scalar=norm_scalar, grad_clip=GRAD_CLIP, save_top_k=SAVE_TOP_K)
    print(f"Best Model Path: {best}")
    return best


def build_parser(default_model="gtm"):
    p = argparse.ArgumentParser(description="GTM-family trainer on Visuelle 2.0")
    add_common_args(p)
    add_model_args(p, default_model)
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
