"""What one of the port's spans (``utils/tracing.py``) costs the host.

Times ``n`` empty blocks under ``with span("x")`` with recording on and
with it off, and under an empty context manager of the same shape (the
cost of the ``with`` statement itself), best of ``repeats`` runs, in ns a
block.  A private ``Recorder`` takes the records, so the process's own is
left as it was.  No device is used: the number is the host's, and only a
run on the host of interest says what that host pays.

    python -m visuelle2_tpu_torch.perf.span_cost [--n 200000] [--repeats 7]

Prints one JSON line: ``on_ns``, ``off_ns``, ``with_ns`` and the host's
Python and processor count.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import time

from visuelle2_tpu_torch.utils import tracing


class _Empty:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _best_ns(make, n: int, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter_ns()
        for _ in range(n):
            with make("x"):
                pass
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def measure(n: int = 200_000, repeats: int = 7) -> dict:
    rec = tracing.Recorder(capacity=n)
    empty = _Empty()
    out = {"with_ns": _best_ns(lambda name: empty, n, repeats),
           "on_ns": _best_ns(rec.span, n, repeats)}
    rec.enabled = False
    out["off_ns"] = _best_ns(rec.span, n, repeats)
    out.update(n=n, repeats=repeats, python=platform.python_version(), cpus=os.cpu_count())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    result = measure(args.n, args.repeats)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
