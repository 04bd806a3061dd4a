"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 benchmark/control.py --workload <cell> --seeds 12 --control-seeds 3 \\
        [--fault-seeds 3] [--seconds 3] [--out FILE]

For each of ``--seeds`` seeds it runs the cell as ``run.py`` does (a short
window at the cell's own load) and records the numbers compared: the
program's readings.  On the first ``--control-seeds`` of them it also
records the control's: the reference computed one precision below the
configuration's (``reference/precisions/``), in the program's place,
against the reference.  A training cell also records, on ``--fault-seeds``
seeds, the readings of a step that leaves half of the batch out (the mean
over the rest) and of an update applied with the wrong sign.  One process, one JSON line a run, and a summary: each
number's largest program reading and smallest control and fault readings.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(_ROOT))

from benchmark import core  # noqa: E402

FIRST_SEED = 2 ** 31 + 7919  # beyond 32 signed bits: seeds may be that large


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    core.set_environment()
    cell = core.cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    driver = core.load_driver(cell["traffic"]["driver"])
    runs = []
    faults = ("half_batch", "update_sign") if cell["traffic"]["driver"] == "train" else ()
    for i in range(args.seeds):
        seed = args.first_seed + 7 * i
        kinds = [("program", {"control": i < args.control_seeds})]
        kinds += [(f, {"fault": f}) for f in faults if i < args.fault_seeds]
        for kind, opts in kinds:
            t = time.perf_counter()
            result, checks = driver.run(cell, seed, args.seconds, False, T_PROCESS, opts)
            rec = {"kind": kind, "seed": seed, "correct": result["correct"],
                   "faults": result["faults"], "attempted": result["attempted"],
                   "readings": {k: c["value"] for k, c in checks.items()},
                   "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                   "run_s": time.perf_counter() - t}
            if "_readings" in result:
                rec["detail"] = result["_readings"]
            if "_control" in result:
                rec["control"] = {k: result["_control"][k] for k in checks}
                rec["control_detail"] = result["_control"]
            runs.append(rec)
            print(json.dumps(rec), flush=True)
            del result
            gc.collect()
            torch.cuda.empty_cache()
    summary = {"workload": cell["name"], "device": torch.cuda.get_device_name(0),
               "power_limit_w": core.power_limit(), "numbers": {}}
    for name in cell["limits"]:
        prog = [r["readings"][name] for r in runs if r["kind"] == "program"]
        ctrl = [r["control"][name] for r in runs if "control" in r]
        entry = {"program_max": max(prog), "program": prog, "control_min": min(ctrl or [None]),
                 "control": ctrl}
        for f in faults:
            vals = [r["readings"][name] for r in runs if r["kind"] == f]
            entry[f"{f}_min"], entry[f] = min(vals or [None]), vals
        summary["numbers"][name] = entry
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
