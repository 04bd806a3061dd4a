"""The statistical baselines over a dataset's stfore test split, counterpart
of ``visuelle2_tpu/cli/forecast_stat.py`` (the reference's
``forecast_stat.py``).

    python3 -m visuelle2_tpu_torch.cli.forecast_stat --dataset_path D --method holt

prints ``Results for <method>`` and then ``wape,mae`` with the reference's
``calc_error_metrics`` (``sum(gt)`` denominator, 3 decimals).  The flags are
the JAX CLI's plus ``--device`` (``cuda`` unless given): every window of a
batch is forecast at once on the device (``ops/stats.py``).
"""

from __future__ import annotations

import argparse

import numpy as np

from visuelle2_tpu_torch.cli.common import add_common_args, build_loaders, resolve_cli_device
from visuelle2_tpu_torch.models import build
from visuelle2_tpu_torch.ops.metrics import calc_error_metrics

HOLT_NOTE = ("[forecast_stat] note: holt with window length {} > 2 minimizes SSE over "
             "(alpha,beta) and the free initial state — statsmodels' least-squares "
             "objective (within 1% of series max of a free-init SSE oracle; ops/stats.py). "
             "The production 2-step windows are exact.")


def forecasts(args):
    """The test split's targets and forecasts as the CLI scores them (each
    batch's real rows, squeezed and concatenated, times the norm scalar):
    ``(gt, forecasts)``, float32 numpy arrays."""
    device = resolve_cli_device(args)
    loaders, _vocab, norm_scalar = build_loaders(
        args, demand=False, output_len=args.output_len, splits=("test",),
        pin_memory=device.type == "cuda")
    model = build("oracle", device=device, method=args.method,
                  use_teacher_forcing=bool(args.use_teacher_forcing))
    gt, out = [], []
    warned_holt = False
    for batch in loaders["test"]:
        if args.method == "holt" and not warned_holt:
            T = batch["X"].shape[-1]
            if T > 2:
                print(HOLT_NOTE.format(T))
            warned_holt = True
        n = int(batch["mask"].sum())
        out.append(model(batch["X"]).cpu().numpy()[:n].squeeze())
        gt.append(batch["y"][:n].numpy().squeeze())
    return np.concatenate(gt) * norm_scalar, np.concatenate(out) * norm_scalar


def run(args):
    """Score the split; returns ``(wape, mae)``."""
    print(args)
    gt, out = forecasts(args)
    mae, wape = calc_error_metrics(gt, out)
    print(f"Results for {args.method}")
    print(f"{wape},{mae}")
    return wape, mae


def build_parser():
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--method", type=str, default="naive", choices=["naive", "ses", "holt"],
                   help="holt is exact for the production 2-week windows (closed-form "
                        "linear extrapolation); for longer windows it minimizes SSE over "
                        "(alpha,beta) and the free initial state (ops/stats.py)")
    p.add_argument("--use_teacher_forcing", type=int, default=1)
    p.add_argument("--trend_len", type=int, default=52)
    p.add_argument("--output_len", type=int, default=1)
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
