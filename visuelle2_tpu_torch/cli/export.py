"""Dataset-free checkpoint -> serving artifact, counterpart of
``visuelle2_tpu/cli/export.py``.

``forecast_*.py --export`` takes its example batch from the dataset; the
machine that exports often has only the checkpoint.  This CLI makes the
example batch from shape flags (the artifact's signature depends on shapes
and dtypes, not values), restores the checkpoint and writes the artifact
(``eval/export.py``):

    python3 -m visuelle2_tpu_torch.cli.export --model gated_v4 \\
        --ckpt_path ckpt_gated_v4 --out gated_v4.v2torch \\
        --vocab 28,42,19 --batch_size 128 --image_size 299 --bf16_backbone

The vocabulary sizes must match training (the embedding shapes): pass
``--vocab cat,col,fab[,store]`` or ``--dataset_path`` to read the label
dicts.  ``--quantize int8`` stores weight-only per-channel int8 weights.
``--device`` (``cuda`` unless given) is where the model is built and
restored.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from visuelle2_tpu_torch.cli.common import add_common_args, resolve_cli_device
from visuelle2_tpu_torch.eval.export import export_forecaster
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_path
from visuelle2_tpu_torch.utils.seeding import seed_everything

RNN_MODELS = {"cross_attn_rnn_21": 1, "cross_attn_rnn_210": 10,
              "cross_attn_rnn_demand": 12}


def synth_batch(n, image_size, vocab, *, demand, output_len,
                text_features=False, image_slots=0, seed=0):
    """A batch with the loader's exact shape/dtype contract, random values."""
    rng = np.random.default_rng(seed)
    b = {
        "cat": rng.integers(0, vocab.num_cat, n).astype(np.int32),
        "col": rng.integers(0, vocab.num_col, n).astype(np.int32),
        "fab": rng.integers(0, vocab.num_fab, n).astype(np.int32),
        "store": rng.integers(0, vocab.num_store, n).astype(np.int32),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "mask": np.ones((n,), np.float32),
    }
    if demand:
        b["ts"] = rng.random((n, 12)).astype(np.float32)
    else:
        w = 12 - 2 - output_len + 1
        b["X"] = rng.random((n, w, 2)).astype(np.float32)
        b["y"] = rng.random((n, w, output_len)).astype(np.float32)
    slots = image_slots or n
    b["images"] = rng.integers(
        0, 255, (slots, image_size, image_size, 3)).astype(np.uint8)
    if image_slots:
        b["img_idx"] = (np.arange(n) % image_slots).astype(np.int32)
    if text_features:
        b["text_features"] = rng.random((n, 768)).astype(np.float32)
    return b


def run(args):
    print(args)
    if args.vocab:
        parts = [int(x) for x in args.vocab.split(",")]
        if len(parts) not in (3, 4):
            raise SystemExit("--vocab cat,col,fab[,store]")
        vocab = VocabSizes(*parts)
    else:
        from visuelle2_tpu_torch.data.pipeline import load_label_dicts

        vocab = VocabSizes.from_dicts(*load_label_dicts(args.dataset_path))

    if args.model in RNN_MODELS:
        demand = args.model == "cross_attn_rnn_demand"
        output_len = RNN_MODELS[args.model]
    else:
        demand = bool(args.demand)
        output_len = args.output_len
    device = resolve_cli_device(args)
    generator = seed_everything(args.seed)
    image_dtype = torch.bfloat16 if args.bf16_backbone else torch.float32

    if args.model in RNN_MODELS:
        model = build(args.model, device=device, generator=generator, vocab=vocab,
                      out_len=output_len, attention_dim=args.attention_dim,
                      embedding_dim=args.embedding_dim, hidden_dim=args.hidden_dim,
                      use_img=bool(args.use_img), image_arch=args.image_arch,
                      image_dtype=image_dtype,
                      **({"use_teacher_forcing": False}
                         if args.model != "cross_attn_rnn_21" else {}))
    else:
        from visuelle2_tpu_torch.cli.forecast_transformer import make_model

        model = make_model(args, vocab, device=device, generator=generator)

    batch = synth_batch(args.batch_size, args.image_size, vocab,
                        demand=demand, output_len=output_len,
                        text_features=(args.model == "gtm_v1"),
                        image_slots=args.image_slots)

    root, step = resolve_ckpt_path(args.ckpt_path)
    CheckpointManager(root, read_only=True).restore_for_eval(model, step)
    size = export_forecaster(model, batch, args.out, quantize=args.quantize or None,
                             extra_header={"model": args.model})
    print(f"Exported serving artifact: {args.out} ({size / 1e6:.1f} MB)")
    return args.out


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--model", type=str, required=True,
                   help="registry name: cross_attn_rnn_{21,210,demand}, "
                        "gtm, m4ft, gated_v1..v4, gtm_v1")
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--vocab", type=str, default="",
                   help="cat,col,fab[,store] sizes from training; falls "
                        "back to --dataset_path label dicts")
    p.add_argument("--demand", type=int, default=1,
                   help="transformer family: demand (1) or stfore (0)")
    p.add_argument("--output_len", type=int, default=12)
    p.add_argument("--attention_dim", type=int, default=512)
    p.add_argument("--embedding_dim", type=int, default=32)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--num_attn_heads", type=int, default=4)
    p.add_argument("--num_hidden_layers", type=int, default=1)
    p.add_argument("--use_encoder_mask", type=int, default=1)
    p.add_argument("--autoregressive", type=int, default=0)
    p.add_argument("--use_img", type=int, default=1)
    p.add_argument("--use_text", type=int, default=1)
    p.add_argument("--query_modality", type=str, default="text")
    p.add_argument("--image_slots", type=int, default=0,
                   help="export a unique-image (dedup) signature with this "
                        "many image slots + an img_idx map")
    p.add_argument("--quantize", type=str, default="",
                   choices=["", "none", "int8"],
                   help="weight-only int8 artifact (~4x smaller; "
                        "eval/export.py)")
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
