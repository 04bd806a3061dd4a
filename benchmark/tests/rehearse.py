"""A cell's run on the CPU at a tiny size, for the rehearsal tests.

    python benchmark/tests/rehearse.py --workload <cell> [--trace 1] [--fault F]

The same driver and reference as ``run.py``, with the tiny backbone
(``image_arch`` "tiny"), 64 x 64 photos, export batches of 8 and a
3-second window; it prints the result line as ``run.py`` does and, on
standard error, any JAX package the process loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import core  # noqa: E402

TINY = dict(device="cpu", overrides={"image_arch": "tiny"}, image_size=64, export_batch=8,
            pool=32, clients=3, size_table=64, rows=64, batch_size=8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    core.set_environment()
    import torch

    torch.set_num_threads(2)
    cell = core.cell_spec(args.workload)
    opts = dict(TINY, fault=args.fault or None, control=bool(args.control))
    driver = core.load_driver(cell["traffic"]["driver"])
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS, opts)
    found = core.forbidden_modules()
    if found:
        print(f"rehearse: JAX packages loaded: {found}", file=sys.stderr)
        return 3
    if "_control" in result:
        print("control " + " ".join(f"{k}={result['_control'][k]!r}" for k in checks),
              file=sys.stderr)
    core.emit({k: v for k, v in result.items() if not k.startswith("_")}, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
