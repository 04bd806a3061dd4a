"""The w8a8 engine's accuracy on trained weights, on the card; counterpart of
``scripts/w8a8_trained_r5.py``.

Trains CrossAttnRNN 2-1 (``cross_attn_rnn_21``: ResNet-50 at 299², E = A = H
= 512, B = 128) for 3 epochs at lr 5e-3 on 512 synthetic train rows through
the port's ``train_dl``, then scores the best epoch on 256 synthetic test
rows with ``forecast_dl``, in float and with ``--quantize w8a8``, and
computes the forecast rel-L2 between the two paths over the whole test split
(mask-weighted, the same restored weights, the w8a8 copy calibrated on two
test batches as the CLI does).  The JAX engine's bar on a TPU
(``docs/w8a8_r5.json``): rel-L2 <= 0.0201 and WAPE within +1.28% of float.

    python3 -m visuelle2_tpu_torch.perf.w8a8_trained [--out FILE] [--workdir DIR]
    python3 -m visuelle2_tpu_torch.perf.w8a8_trained --smoke   # tiny, on the CPU

The synthetic photos are written to the image store's cache from seeded
numpy pixels (no JPEG, no PIL).  It prints one JSON object with the card's
name and power limit; a file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess

import numpy as np
import torch

JAX_BAR = {"forecast_rel_l2": 0.0201, "wape_delta_share": 0.0128}


def _write_dataset(path: str, n_train: int, n_test: int, image: int) -> str:
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.pipeline import load_visuelle2
    from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(path, num_train=n_train, num_test=n_test, seed=0,
                           write_images=False)
    for i, split in enumerate(("train", "test")):
        paths = load_visuelle2(path, split, demand=False, output_len=1).image_paths
        unique, row_to_img = ImageStore.unique_paths(paths)
        pixels = np.random.default_rng(i).integers(0, 256, (len(unique), image, image, 3),
                                                   dtype=np.uint8)
        ImageStore(pixels, row_to_img).write_cache(
            ImageStore.cache_path(path, split, image), paths)
    return path


def _card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _rel_l2(common, ck, device):
    """(rel-L2, max |diff|) between the float and w8a8 forecasts of the
    checkpoint over the whole test split, masked rows only."""
    from visuelle2_tpu_torch.cli import common as cli_common
    from visuelle2_tpu_torch.cli import forecast_dl
    from visuelle2_tpu_torch.models import quantized_resnet as qr
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_path
    from visuelle2_tpu_torch.train.loop import to_device

    parser = forecast_dl.build_parser()
    args = parser.parse_args(common + ["--ckpt_path", ck])
    loaders, vocab, _norm = cli_common.build_loaders(
        args, demand=False, output_len=1, splits=("test",),
        dedup_eval_images=bool(args.dedup_images), pin_memory=device.type == "cuda")
    model = forecast_dl.make_model(args, vocab, 1, demand=False, device=device)
    root, step = resolve_ckpt_path(ck)
    CheckpointManager(root, read_only=True).restore_for_eval(model, step)
    model.eval()
    batches = [to_device(b, device) for b in loaders["test"]]
    qmodel, _ = qr.build_serving_path(model, batches[:2])
    num = den = max_abs = 0.0
    with torch.inference_mode():
        for b in batches:
            ref = model(b)[0].float()
            got = qmodel(b)[0].float()
            w = b["mask"].reshape((-1,) + (1,) * (ref.dim() - 1))
            ref, got = ref * w, got * w
            num += float(((got - ref) ** 2).sum())
            den += float((ref ** 2).sum())
            max_abs = max(max_abs, float((got - ref).abs().max()))
    return float(np.sqrt(num / max(den, 1e-30))), max_abs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the JSON result here")
    ap.add_argument("--workdir", default=os.path.join("build", "w8a8_trained"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dims on the CPU: checks the tool, measures nothing")
    opts = ap.parse_args(argv)
    if opts.smoke:
        arch, image, dims, batch, epochs, n_train, n_test, dev = (
            "tiny", 32, 16, 16, 1, 64, 32, "cpu")
    else:
        arch, image, dims, batch, epochs, n_train, n_test, dev = (
            "resnet50", 299, 512, 128, 3, 512, 256, "cuda")
    from visuelle2_tpu_torch.cli import forecast_dl, train_dl
    from visuelle2_tpu_torch.cli.common import resolve_cli_device

    data = _write_dataset(os.path.join(opts.workdir, "data"), n_train, n_test, image)
    ck = os.path.join(opts.workdir, "ck")
    common = ["--dataset_path", data, "--batch_size", str(batch), "--image_size", str(image),
              "--image_arch", arch, "--task_mode", "0", "--output_len", "1",
              "--embedding_dim", str(dims), "--attention_dim", str(dims),
              "--hidden_dim", str(dims), "--device", dev]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train_dl.main(common + ["--epochs", str(epochs), "--learning_rate", "5e-3",
                                "--ckpt_dir", ck])
        r_f = forecast_dl.main(common + ["--ckpt_path", ck])
        r_q = forecast_dl.main(common + ["--ckpt_path", ck, "--quantize", "w8a8"])
        device = resolve_cli_device(forecast_dl.build_parser().parse_args(common))
        rel_l2, max_abs = _rel_l2(common, ck, device)
    wape_delta = r_q.wape - r_f.wape
    res = {
        "tool": "visuelle2_tpu_torch.perf.w8a8_trained", "card": _card(),
        "model": "cross_attn_rnn_21", "arch": arch, "image": image, "dims": dims,
        "batch": batch, "train_rows": n_train, "test_rows": n_test, "train_epochs": epochs,
        "learning_rate": 5e-3,
        "float": {"wape": r_f.wape, "mae": r_f.mae,
                  "forecasts_per_s": r_f.forecasts_per_sec},
        "w8a8": {"wape": r_q.wape, "mae": r_q.mae, "forecasts_per_s": r_q.forecasts_per_sec},
        "wape_delta": wape_delta, "wape_delta_share": wape_delta / r_f.wape,
        "mae_delta": r_q.mae - r_f.mae,
        "forecast_rel_l2": rel_l2, "forecast_max_abs_diff": max_abs,
        "jax_bar_tpu": JAX_BAR,
        "meets_jax_bar": bool(rel_l2 <= JAX_BAR["forecast_rel_l2"]
                              and wape_delta / r_f.wape <= JAX_BAR["wape_delta_share"]),
        "log_tail": [x for x in log.getvalue().splitlines()
                     if x.startswith(("[w8a8]", "WAPE", "MAE", "epoch"))][-8:]}
    print(json.dumps(res), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
