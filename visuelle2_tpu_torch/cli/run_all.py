"""The reference's whole pipeline in one process, counterpart of
``visuelle2_tpu/cli/run_all.py`` (the reference's ``run_all.sh``).

    python3 -m visuelle2_tpu_torch.cli.run_all --dataset_path D --ckpt_root ckpts

trains and then scores the three CrossAttnRNN tasks (SO-fore 2-1, SO-fore
2-10, Demand) with ``train_dl`` and ``forecast_dl``, each forecast from the
checkpoint its training returned (the reference greps stdout for it), then
runs the statistical baselines (``forecast_stat`` naive, SES, Holt), and
prints the six results.  The flags are the JAX CLI's plus ``--device``
(``cuda`` unless given), handed on to every CLI.  Each CLI gets its argument
list, as from a command line: a forecast CLI fills the structural flags not
in it from the checkpoint's ``hparams.json``.  ``--dedup_images 1`` reaches
``train_dl``: unique-image training batches (the grouped sampler).
"""

from __future__ import annotations

import argparse

from visuelle2_tpu_torch.cli import forecast_dl, forecast_stat, train_dl


def _base(args):
    out = ["--dataset_path", args.dataset_path,
           "--batch_size", str(args.batch_size),
           "--image_arch", args.image_arch,
           "--image_size", str(args.image_size),
           "--device", args.device]
    if args.quick_debug:
        out.append("--quick_debug")
    return out


def _train_extras(args):
    out = []
    if args.dedup_images:
        out += ["--dedup_images", "1"]
    if args.accum_steps > 1:
        out += ["--accum_steps", str(args.accum_steps)]
    if args.remat:
        out.append("--remat")
    return out


def run(args):
    results = {}
    base = _base(args)
    train_base = base + ["--epochs", str(args.epochs)] + _train_extras(args)

    # Task 1: SO-fore 2-1 (run_all.sh:3-12)
    best = train_dl.main(train_base + ["--task_mode", "0", "--output_len", "1",
                                       "--ckpt_dir", f"{args.ckpt_root}/ckpt_21"])
    results["so_fore_2_1"] = forecast_dl.main(base + ["--task_mode", "0",
                                                      "--ckpt_path", best or ""])

    # Task 2: SO-fore 2-10 (run_all.sh:16-25)
    best = train_dl.main(train_base + ["--task_mode", "1", "--output_len", "10",
                                       "--use_teacher_forcing",
                                       "--ckpt_dir", f"{args.ckpt_root}/ckpt_210"])
    results["so_fore_2_10"] = forecast_dl.main(base + ["--task_mode", "1",
                                                       "--ckpt_path", best or ""])

    # Task 3: Demand (run_all.sh:29-38)
    best = train_dl.main(train_base + ["--demand", "1",
                                       "--ckpt_dir", f"{args.ckpt_root}/ckpt_demand"])
    results["demand"] = forecast_dl.main(base + ["--new_product", "1",
                                                 "--ckpt_path", best or ""])

    # The statistical baselines for context (forecast_stat.py)
    for method in ("naive", "ses", "holt"):
        results[f"stat_{method}"] = forecast_stat.main(base + ["--method", method])

    print(results)
    return results


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_path", type=str, default="../visuelle2/")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--ckpt_root", type=str, default="ckpts")
    p.add_argument("--image_arch", type=str, default="resnet101")
    p.add_argument("--image_size", type=int, default=299)
    p.add_argument("--quick_debug", action="store_true")
    p.add_argument("--dedup_images", type=int, default=0,
                   help="unique-image training batches (the grouped sampler)")
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
