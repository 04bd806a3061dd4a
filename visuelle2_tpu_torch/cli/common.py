"""Shared CLI plumbing, counterpart of ``visuelle2_tpu/cli/common.py``: the
common flags, dataset and loader construction, the ``--quantize`` gate and
the forecast CLIs' ``--export``, the train CLIs' flags (``add_train_args``)
and body (``run_training``: ``--pretrained_backbone``, ``--resume_from``,
the checkpoints, the manifest, the exit after a SIGTERM) and the JSONL
metrics log.

The flags are the JAX CLIs' own, plus ``--device`` (default ``cuda``; the
tests pass ``cpu``): the CLI form of the port's ``device=`` rule.
``--gpu_num N`` selects ``cuda:N``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.loader import BatchLoader
from visuelle2_tpu_torch.data.pipeline import (
    load_label_dicts,
    load_norm_scalar,
    load_visuelle2,
)
from visuelle2_tpu_torch.eval.export import export_forecaster
from visuelle2_tpu_torch.eval.forecast import dump_attention, score_split
from visuelle2_tpu_torch.models.base import VocabSizes
from visuelle2_tpu_torch.models.gtm_v1 import TextFeaturizer
from visuelle2_tpu_torch.models.pretrained import load_backbone_npz, splice_backbone


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset_path", type=str, default="../visuelle2/")
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--quick_debug", action="store_true")
    p.add_argument("--image_arch", type=str, default="resnet101",
                   choices=["resnet50", "resnet101", "tiny"])
    p.add_argument("--image_size", type=int, default=299)
    p.add_argument("--bf16_backbone", action="store_true",
                   help="run the image backbone in bfloat16")
    p.add_argument("--pretrained_backbone", type=str, default="",
                   help=".npz of a converted pretrained backbone "
                        "(scripts/convert_pretrained.py), spliced into every image "
                        "encoder's backbone before training (not read when forecasting)")
    p.add_argument("--gpu_num", type=int, default=0,
                   help="the CUDA device index: --device cuda runs on cuda:N")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--trace_dir", type=str, default="",
                   help="training-time device trace directory (not read when "
                        "forecasting)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone blocks on backward (training)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="average gradients over N batches per update (training)")
    # wandb-compatible flags (kept for CLI parity; logging is JSONL locally)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_entity", type=str, default="")
    p.add_argument("--wandb_project", type=str, default="")
    p.add_argument("--wandb_run", type=str, default="")
    return p


def add_forecast_args(p, *, dump_help: str):
    """The flags both forecast CLIs add to their model flags."""
    p.add_argument("--ckpt_path", type=str, default="",
                   help="checkpoint to score: a trainer's directory or one of its "
                        "epoch directories")
    p.add_argument("--export", type=str, default="",
                   help="after scoring, write a serving artifact of the model "
                        "(eval/export.py) with the first test batch's signature")
    # w8a8 calibration (read once --quantize w8a8 is ported)
    p.add_argument("--calib_batches", type=int, default=2,
                   help="batches used to calibrate w8a8 activation scales")
    p.add_argument("--calib_split", type=str, default="test", choices=["test", "train"],
                   help="split the calibration batches come from")
    p.add_argument("--quantize", type=str, default="",
                   choices=["", "none", "int8", "w8a8", "auto"],
                   help="'' or none: float weights; int8: the --export "
                        "artifact stores weight-only per-channel int8 (~4x smaller); "
                        "w8a8 and auto are ported with the int8 backbone")
    p.add_argument("--dump_attention", type=str, default="", help=dump_help)
    p.add_argument("--metrics_out", type=str, default="",
                   help="also write WAPE/MAE/throughput/GFLOPs as JSON")
    p.add_argument("--one_pass", choices=["auto", "0", "1"], default="auto",
                   help="1: copy the whole split to the device, then score it; "
                        "0: one batch at a time; auto: one-pass when the split "
                        "fits a quarter of the device's memory")
    return p


def resolve_cli_device(args) -> torch.device:
    """``--device``: ``cuda`` is ``cuda:<--gpu_num>`` and raises without a
    CUDA device; anything else is taken as given."""
    if args.device != "cuda":
        return resolve_device(args.device)
    resolve_device()
    return torch.device(f"cuda:{args.gpu_num}")


def resolve_quantize(args) -> str:
    """The ``--quantize`` mode: ``""`` (also for ``none``) or ``int8`` (the
    artifact's weight storage); ``w8a8`` and ``auto`` raise until the int8
    backbone lands."""
    mode = getattr(args, "quantize", "") or ""
    if mode in ("", "none"):
        return ""
    if mode == "int8":
        return mode
    raise NotImplementedError(
        f"--quantize {mode} is ported in ROADMAP Queue 1 item 14 (the w8a8 backbone, "
        "and auto's crossover measured again on the card)")


def export_scored_model(args, model, loader, provenance: dict) -> None:
    """``--export``: write ``model`` as a serving artifact with the first
    batch of ``loader`` as its signature, int8 weights under ``--quantize
    int8``."""
    if not getattr(args, "export", ""):
        return
    example = {k: v.numpy() for k, v in next(iter(loader)).items()}
    size = export_forecaster(model, example, args.export, quantize=resolve_quantize(args),
                             extra_header=provenance)
    print(f"Exported serving artifact: {args.export} ({size / 1e6:.1f} MB)")


def build_loaders(args, *, demand: bool, output_len: int, splits=("train", "test"),
                  text_features: bool = False, dedup_eval_images: bool = False,
                  dedup_train_images: bool = False, dedup_image_slots: int = 0,
                  pin_memory: bool = False) -> Tuple[dict, VocabSizes, float]:
    """Returns ``({split: BatchLoader}, vocab, norm_scalar)``.

    ``text_features`` runs gtm_v1's ingest-time text featurizer
    (``models/gtm_v1.py::TextFeaturizer``) over each split, attaches the
    [N, 768] float32 array as the batch extra ``text_features`` and sets each
    loader's ``text_fingerprint`` (written into ``hparams.json`` at training,
    checked when a checkpoint is scored).  ``dedup_eval_images`` makes
    non-train loaders ship unique-image batches (identical outputs, backbone
    FLOPs divided by the photo duplication factor); ``dedup_train_images``
    asks the train loader for the grouped sampler, which raises until
    ROADMAP Queue 1 item 11 (``--dedup_images 1`` on a train CLI).
    ``dedup_image_slots`` forces the slot count (an artifact's signature
    fixed it at export).  ``pin_memory`` pins every batch (a CUDA target).
    """
    cat_dict, col_dict, fab_dict = load_label_dicts(args.dataset_path)
    vocab = VocabSizes.from_dicts(cat_dict, col_dict, fab_dict)
    norm_scalar = load_norm_scalar(args.dataset_path)
    featurizer = TextFeaturizer(cat_dict, col_dict, fab_dict) if text_features else None

    loaders = {}
    for split in splits:
        arrays = load_visuelle2(args.dataset_path, split, demand=demand, output_len=output_len)
        if args.quick_debug:
            arrays = arrays.subset(1000)
        store = ImageStore.build(
            os.path.join(args.dataset_path, "images"), arrays.image_paths,
            cache_file=ImageStore.cache_path(args.dataset_path, split, args.image_size),
            size=args.image_size)
        extras = None
        if featurizer is not None:
            extras = {"text_features": featurizer(arrays.cat, arrays.col, arrays.fab)}
        dedup = dedup_train_images if split == "train" else dedup_eval_images
        loaders[split] = BatchLoader(
            arrays, store, args.batch_size, shuffle=(split == "train"), seed=args.seed,
            drop_remainder=(split == "train"), extras=extras, dedup_images=dedup,
            image_slots=dedup_image_slots if dedup else 0, pin_memory=pin_memory)
        if featurizer is not None:
            loaders[split].text_fingerprint = featurizer.fingerprint
    return loaders, vocab, norm_scalar


def score_test_split(args, model, loader, norm_scalar: float):
    """What both forecast CLIs do once the model and loader exist:
    ``--dump_attention``, ``score_split`` (``--one_pass``), ``--metrics_out``
    (the JAX CLIs' JSON keys) and the printed summary."""
    if args.dump_attention:
        keys = dump_attention(model, next(iter(loader)), args.dump_attention)
        print(f"Attention weights -> {args.dump_attention}: "
              f"{keys if keys else 'model returns no attention aux'}")
    result = score_split(model, loader, norm_scalar=norm_scalar,
                         one_pass=None if args.one_pass == "auto" else bool(int(args.one_pass)))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"wape": result.wape, "mae": result.mae,
                       "num_forecasts": result.num_forecasts,
                       "forecasts_per_sec_per_chip": result.forecasts_per_sec_per_chip,
                       "gflops_per_sample": result.gflops_per_sample,
                       "peak_hbm_bytes": result.peak_hbm_bytes}, f)
    print(result.summary())
    print(f"WAPE: {result.wape}")
    print(f"MAE: {result.mae}")
    return result


def add_train_args(p: argparse.ArgumentParser):
    """The train CLIs' own flags; the forecast CLIs that share a train
    parser accept them and do not read them."""
    p.add_argument("--resume_from", type=str, default="",
                   help="checkpoint directory to resume from; 'auto' resumes from "
                        "--ckpt_dir when it holds a checkpoint")
    p.add_argument("--autosave_minutes", type=float, default=0.0,
                   help="save the last slot every so many minutes (0 = off)")
    p.add_argument("--early_stop_patience", type=int, default=0,
                   help="stop after N epochs without val_wWAPE improving (0 = off)")
    p.add_argument("--early_stop_min_delta", type=float, default=0.0)
    p.add_argument("--learning_rate", type=float, default=0.0,
                   help="fixed Adafactor learning rate; 0 = the relative-step schedule")
    return p


def run_training(args, model, loaders, hparams: dict, *, norm_scalar: float,
                 grad_clip: Optional[float], save_top_k: int) -> Optional[str]:
    """The train CLIs' body: ``Trainer`` with the flags' config,
    ``CheckpointManager(save_top_k)`` in ``--ckpt_dir``, ``hparams`` as
    ``hparams.json``, ``metrics.jsonl``, the state ``--resume_from`` gives,
    then ``fit``.  After a SIGTERM it exits 143 (128 + SIGTERM: a pipeline
    stops in the grace window); else it returns the best checkpoint's
    path."""
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager
    from visuelle2_tpu_torch.train.hparams import save_hparams
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    trainer = Trainer(model, TrainConfig(
        epochs=args.epochs, seed=args.seed, grad_clip=grad_clip, norm_scalar=norm_scalar,
        trace_dir=args.trace_dir or None, accum_steps=args.accum_steps,
        autosave_minutes=args.autosave_minutes,
        early_stop_patience=args.early_stop_patience,
        early_stop_min_delta=args.early_stop_min_delta,
        learning_rate=args.learning_rate or None))
    ckpt = CheckpointManager(args.ckpt_dir, save_top_k=save_top_k)
    save_hparams(args.ckpt_dir, hparams)
    log = JsonlLogger(os.path.join(args.ckpt_dir, "metrics.jsonl"), wandb_args=args)
    state, start_epoch, skip_steps = prepare_initial_state(trainer, loaders, args)

    t0 = time.time()
    try:
        trainer.fit(loaders["train"], loaders["test"], state=state, checkpointer=ckpt,
                    log_fn=log, start_epoch=start_epoch, skip_steps=skip_steps)
    finally:
        log.close()
    elapsed = time.time() - t0
    if trainer.history and trainer.history[-1].get("preempted"):
        print(f"[Training Preempted] state saved at epoch {trainer.history[-1]['epoch']}; "
              f"continue with --resume_from {args.ckpt_dir}")
        raise SystemExit(143)
    print(f"[Training Completed] Time: {elapsed / 60:.2f} minutes ({elapsed:.2f} seconds)")
    return ckpt.best_model_path


def apply_pretrained_backbone(model, args):
    """``--pretrained_backbone``: splice the converted backbone ``.npz`` into
    every image encoder's ``backbone`` of ``model`` (in place; the float32
    masters take its values); no-op without the flag.  Returns ``model``."""
    path = getattr(args, "pretrained_backbone", "")
    if not path:
        return model
    splice_backbone(model, load_backbone_npz(path))
    print(f"loaded pretrained backbone from {path}")
    return model


def prepare_initial_state(trainer, loaders, args):
    """The train CLIs' prologue: ``--pretrained_backbone`` spliced into the
    model, then a fresh state, or the one ``--resume_from DIR|auto``
    restores.  Returns ``(state, start_epoch, skip_steps)``; ``skip_steps``
    > 0 means the state already holds that many updates of ``start_epoch``
    (a mid-epoch save).  ``auto`` resumes from ``--ckpt_dir`` when it holds a
    checkpoint and starts fresh when it does not, so the same command can be
    rerun after a preemption."""
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager

    apply_pretrained_backbone(trainer.model, args)
    state = trainer.init_state()
    if not getattr(args, "resume_from", ""):
        return state, 0, 0
    auto = args.resume_from == "auto"
    resume_dir = args.ckpt_dir if auto else args.resume_from
    try:
        src = CheckpointManager(resume_dir, read_only=True)
        state, start_epoch, skip_steps = src.restore_latest(state)
    except FileNotFoundError as e:
        if not auto:
            raise SystemExit(f"--resume_from: {e}")
        print(f"--resume_from auto: {resume_dir} empty, starting fresh")
        return state, 0, 0
    skipping = f" skipping {skip_steps} done steps" if skip_steps else ""
    print(f"resumed from {resume_dir} -> epoch {start_epoch} (step {state.step}){skipping}")
    return state, start_epoch, skip_steps


class JsonlLogger:
    """Local metrics log; mirrors to wandb when ``--use_wandb`` asks and the
    package is importable."""

    def __init__(self, path: Optional[str], wandb_args=None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None
        self._wandb = None
        if wandb_args is not None and getattr(wandb_args, "use_wandb", False):
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_args.wandb_project or None,
                    entity=wandb_args.wandb_entity or None,
                    name=wandb_args.wandb_run or None)
            except Exception as e:
                print(f"[logger] wandb unavailable ({type(e).__name__}); "
                      "metrics go to stdout/JSONL only")

    def __call__(self, metrics: dict):
        line = {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                for k, v in metrics.items()}
        print("  ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in line.items()))
        if self._f:
            self._f.write(json.dumps(line) + "\n")
            self._f.flush()
        if self._wandb is not None:
            self._wandb.log(line)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
