"""The benchmark of visuelle2_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` in this process: builds the cell's
configuration through the port's entry points, draws the weights and the
traffic from ``--seed`` on the card, warms the cell's shapes, measures for
``--seconds``, checks the answers against the plain reference
(``reference/``) and prints one JSON line last on standard output: the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics read
from a profiled stretch of the window.  The numbers compared with their
limits are the last lines of standard error and the line's last key.  It
exits 1 with no result when no card (or too few) is there, and 3 when a JAX
package is loaded in the process at the end.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(_ROOT))

from benchmark import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    core.set_environment()
    cell = core.cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 1
    driver = core.load_driver(cell["traffic"]["driver"])
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: JAX packages loaded in the process: {found}", file=sys.stderr)
        return 3
    if "_readings" in result:  # the look: what is read beside the compared numbers
        print("look " + json.dumps(result["_readings"]), file=sys.stderr)
    core.emit({k: v for k, v in result.items() if not k.startswith("_")}, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
