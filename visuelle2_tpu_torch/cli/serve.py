"""Score a split with a serving artifact — no model flags, weights or
checkpoint needed — or serve the artifact over HTTP; counterpart of
``visuelle2_tpu/cli/serve.py``.

Where the forecast CLIs rebuild a model and restore a checkpoint, this loads
the one file ``--export`` or ``cli/export.py`` wrote (``eval/export.py``)
and runs it over the dataset's test split, printing the same WAPE / MAE
lines.  It is the serving entry point and the check that the shipped
artifact reproduces the checkpoint's numbers:

    python3 -m visuelle2_tpu_torch.cli.serve --dataset_path D --artifact m.v2torch
    python3 -m visuelle2_tpu_torch.cli.serve --artifact m.v2torch --http 8080

The task, horizon, batch size and, for a dedup artifact (``img_idx``), the
image-slot count come from the artifact's signature (``--demand`` and
``--output_len`` are accepted as the JAX CLI's and not read).  ``--http
PORT`` (0: a free port, printed) serves ``POST /forecast`` (npz in, npz out)
and ``GET /health`` until SIGTERM, then drains in-flight requests for
``--drain_grace_s`` seconds and exits 143 (``eval/server.py::
serve_forever``).  ``--device`` (``cuda`` unless given)
is where the artifact runs.  A w8a8 artifact (``--quantize w8a8`` at export)
runs its backbone on the int8 engine; scored at an image duplication where
the card measured w8a8 slower than float, the CLI prints a note
(``w8a8_dedup_advisory``).
"""

from __future__ import annotations

import argparse
import time

import torch

from visuelle2_tpu_torch.cli.common import add_common_args, build_loaders, resolve_cli_device
from visuelle2_tpu_torch.eval.export import load_forecaster
from visuelle2_tpu_torch.ops.metrics import eval_metrics, finalize_metrics
from visuelle2_tpu_torch.train.loop import SUM_KEYS, expand_mask, target_and_pred


def w8a8_dedup_advisory(header: dict, batch_size: int, slots: int):
    """A note when a w8a8 artifact is served at an image duplication (batch
    rows / unique images) above the largest at which the card measured the
    w8a8 forward faster than the float one
    (``models/quantized_resnet.py::W8A8_AUTO_MAX_DUPLICATION``), where
    ``--quantize auto`` would have exported float; None when there is nothing
    to say."""
    if header.get("quantize") != "w8a8" or not slots:
        return None
    from visuelle2_tpu_torch.models.quantized_resnet import W8A8_AUTO_MAX_DUPLICATION

    duplication = batch_size / slots
    if duplication <= W8A8_AUTO_MAX_DUPLICATION:
        return None
    return (f"[serve] note: w8a8 artifact at image duplication {duplication:.1f} (batch "
            f"{batch_size} / {slots} unique images): the card measured w8a8 faster than "
            f"the float path only up to d={W8A8_AUTO_MAX_DUPLICATION:g} "
            f"(models/quantized_resnet.py), and --quantize auto exports float above it; "
            f"consider a float or --quantize auto export for this duplication factor")


def run(args):
    print(args)
    device = resolve_cli_device(args)
    t0 = time.perf_counter()
    fn, header = load_forecaster(args.artifact, device=device)
    print(f"loaded {args.artifact} on {device} in {time.perf_counter() - t0:.2f} s")
    if args.http is not None:
        # Artifact-only inference server: no dataset, no model flags.
        from visuelle2_tpu_torch.eval.server import serve_forever

        return serve_forever(fn, header, args.http, grace_s=args.drain_grace_s)
    # The task and horizon are the artifact's: Demand takes ``ts``, the
    # window models ``y [B, W, horizon]``.
    demand = "ts" in header["keys"]
    output_len = 12 if demand else int(header["shapes"]["y"][-1])
    dedup = "img_idx" in header["keys"]
    # The artifact's signature fixed the batch size and (dedup) the image
    # slots at export: any other shapes fail its call's checks.
    if "mask" in header.get("shapes", {}):
        args.batch_size = int(header["shapes"]["mask"][0])
    slots = int(header["shapes"]["images"][0]) if dedup else 0
    # gtm_v1 artifacts take ingest-time text features: build them here and
    # refuse a featurizer other than the one the artifact was exported with.
    text_features = "text_features" in header["keys"]
    loaders, _vocab, norm_scalar = build_loaders(
        args, demand=demand, output_len=output_len, splits=("test",),
        text_features=text_features, dedup_eval_images=dedup, dedup_image_slots=slots)
    loader = loaders["test"]
    # On the true duplication: the artifact's slot count may be padded.
    note = w8a8_dedup_advisory(header, loader.batch_size,
                               loader.unique_image_slots or loader.image_slots)
    if note:
        print(note)
    if text_features:
        want = (header.get("provenance") or {}).get("text_fingerprint")
        have = getattr(loader, "text_fingerprint", None)
        if want and have and want != have:
            raise SystemExit(
                f"gtm_v1 text featurizer mismatch: the artifact was exported "
                f"with '{want}' features but this host produces '{have}'. "
                f"Provide the same featurizer or re-export.")

    # The metrics as score_split sums them (float32 partial sums a batch,
    # added in float64 on the device), so the artifact's numbers are the
    # model path's.
    sums = torch.zeros(len(SUM_KEYS), dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    for batch in loader:
        forecast = torch.from_numpy(fn({k: v.numpy() for k, v in batch.items()})).to(device)
        batch = {k: v.to(device) for k, v in batch.items()}
        target, pred = target_and_pred(batch, forecast)
        part = eval_metrics(target, pred, expand_mask(batch, target), norm_scalar=norm_scalar)
        sums = sums + torch.stack([part[k] for k in SUM_KEYS]).double()
    totals = dict(zip(SUM_KEYS, sums.tolist()))
    dt = time.perf_counter() - t0
    if totals["rows"] == 0:
        raise SystemExit("the test split has no batches")
    fin = finalize_metrics(totals)
    wape, mae = fin["wape"], fin["mae"]
    print(f"WAPE: {wape:.3f}, MAE: {mae:.3f}, "
          f"{totals['rows'] / dt:,.0f} forecasts/s (artifact, host-synced per batch)")
    print(f"WAPE: {wape}")
    print(f"MAE: {mae}")
    return {"wape": wape, "mae": mae, "rows": int(totals["rows"]), "seconds": dt}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--artifact", type=str, required=True,
                   help="serving artifact from forecast_*.py --export or cli.export")
    p.add_argument("--demand", "--new_product", type=int, default=0,
                   help="not read: the artifact's keys say")
    p.add_argument("--output_len", type=int, default=1,
                   help="not read: the artifact's signature says")
    p.add_argument("--http", type=int, default=None,
                   help="serve the artifact over HTTP on this port (0: a free one) "
                        "instead of scoring a split (POST /forecast npz -> npz, "
                        "GET /health)")
    p.add_argument("--drain_grace_s", type=float, default=10.0,
                   help="--http only: on SIGTERM stop accepting at once and give "
                        "in-flight requests this many seconds before exiting 143")
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
