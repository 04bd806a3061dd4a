"""Shared CLI plumbing, counterpart of ``visuelle2_tpu/cli/common.py``: the
common flags, dataset and loader construction, ``--quantize`` (the w8a8
calibration and ``auto``'s policy) and the forecast CLIs' scoring and
``--export``, the train CLIs' flags (``add_train_args``)
and body (``run_training``: ``--pretrained_backbone``, ``--resume_from``,
the checkpoints, the manifest, the exit after a SIGTERM) and the JSONL
metrics log.

The flags are the JAX CLIs' own, plus ``--device`` (default ``cuda``; the
tests pass ``cpu``): the CLI form of the port's ``device=`` rule.
``--gpu_num N`` selects ``cuda:N``.

Under a launcher (``WORLD_SIZE`` > 1 in the environment, as ``torchrun``
sets it) the train and forecast CLIs join the process group
(``parallel.distributed.initialize``: each rank binds ``cuda:LOCAL_RANK``,
or the CPU over gloo with ``--device cpu``) and train or score data
parallel over ``make_mesh()``, each rank on its row block of every global
``--batch_size`` batch; rank 0 alone writes files and prints the result
lines.  This is the counterpart of the JAX CLIs' mesh over every device.
With one process they run as before.  The forecast options give one
process's files under a launcher too: ``--quantize w8a8|auto`` calibrates
on every rank on the batches one process would (``one_process_loader``),
so the codes are one process's, and then scores over the mesh;
``--dump_attention`` and ``--export`` are written by rank 0 from the first
batch one process would see (its rows and its image slots), so the dump and
the artifact are one process's bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
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
from visuelle2_tpu_torch.parallel import distributed
from visuelle2_tpu_torch.parallel.distributed import is_main_process
from visuelle2_tpu_torch.parallel.mesh import batch_rank_world, make_mesh


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
    add_quantize_calib_args(p)
    p.add_argument("--quantize", type=str, default="",
                   choices=["", "none", "int8", "w8a8", "auto"],
                   help="'' or none: float; int8: the --export artifact stores "
                        "weight-only per-channel int8 (~4x smaller); w8a8: score (and "
                        "export) with the int8 ResNet backbone, calibrated on "
                        "--calib_batches of --calib_split; auto: w8a8 where the card "
                        "measured it faster at this image duplication, else float")
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


@contextlib.contextmanager
def launcher_mesh(args):
    """``(mesh, device)`` of a CLI run.  Under a launcher (``WORLD_SIZE`` >
    1) it joins the process group on ``--device``'s kind and leaves it on
    exit; the mesh is ``make_mesh()`` over every rank.  One process: no
    mesh, ``--device``'s device."""
    device = resolve_cli_device(args)
    if distributed.launched_world_size() <= 1:
        yield None, device
        return
    device = distributed.initialize(device=device.type)
    try:
        yield make_mesh(), device
    finally:
        distributed.shutdown()


def one_process_loader(loader: BatchLoader) -> BatchLoader:
    """The split's loader as one process builds it: every row of each
    batch, image slots not rounded to the ranks; ``loader`` itself at one
    rank."""
    if loader.world == 1:
        return loader
    return BatchLoader(loader.arrays, loader.images, loader.batch_size,
                       shuffle=loader.shuffle, seed=loader.seed,
                       drop_remainder=loader.drop_remainder, extras=loader.extras,
                       dedup_images=loader.dedup_images, pin_memory=loader.pin_memory)


def add_quantize_calib_args(p):
    """The w8a8 calibration flags of the forecast CLIs."""
    p.add_argument("--calib_batches", type=int, default=2,
                   help="batches used to calibrate w8a8 activation scales")
    p.add_argument("--calib_split", type=str, default="test", choices=["test", "train"],
                   help="split the calibration batches come from; test (the default) "
                        "reuses the scored split's statistics, train is leakage-free")


def calib_splits(args) -> tuple:
    """The splits a forecast CLI loads: the train split too when w8a8 (or
    auto) calibrates on it."""
    if (getattr(args, "quantize", "") in ("w8a8", "auto")
            and getattr(args, "calib_split", "test") == "train"):
        return ("train", "test")
    return ("test",)


def resolve_quantize(args, loader=None) -> str:
    """The concrete ``--quantize`` mode of a forecast run: "", "int8" or
    "w8a8".  ``auto`` picks w8a8 for a production ResNet (resnet50/101,
    ``use_img``) at an image duplication (batch rows / the loader's true
    unique-image slots; 1 without dedup) of at most
    ``models/quantized_resnet.py::W8A8_AUTO_MAX_DUPLICATION``, the crossover
    measured on the card, and says what it picked."""
    mode = getattr(args, "quantize", "") or ""
    if mode == "none":
        return ""
    if mode != "auto":
        return mode
    from visuelle2_tpu_torch.models import quantized_resnet as qr
    from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS

    slots = (getattr(loader, "unique_image_slots", 0)
             or getattr(loader, "image_slots", 0)) if loader is not None else 0
    duplication = loader.batch_size / slots if slots else 1.0
    has_resnet = bool(getattr(args, "use_img", 1)) and getattr(
        args, "image_arch", "") in (set(STAGE_BLOCKS) - {"tiny"})
    mode = qr.resolve_auto_mode(duplication=duplication, has_resnet_backbone=has_resnet)
    why = (f"duplication={duplication:.1f} (batch {loader.batch_size} / {slots} unique "
           f"images)" if slots else "no image dedup")
    limit = qr.W8A8_AUTO_MAX_DUPLICATION
    region = (f"w8a8 measured faster at d <= {limit:g}" if limit > 0
              else "w8a8 measured faster at no duplication")
    print(f"[quantize auto] {why}, resnet={int(has_resnet)} -> {mode or 'float path'} "
          f"({region}; models/quantized_resnet.py)")
    return mode


def build_w8a8_serving_path(model, loaders, args):
    """The forecast CLIs' w8a8 prologue: calibrate on ``--calib_batches``
    batches of ``--calib_split`` (on the model's device; one process's
    batches, on every rank under a launcher) and return
    ``(the w8a8 copy of model, calib)`` (``models/quantized_resnet.py``)."""
    from visuelle2_tpu_torch.models import quantized_resnet as qr
    from visuelle2_tpu_torch.train.loop import to_device

    split = getattr(args, "calib_split", "test") or "test"  # loaded by calib_splits
    n = max(1, int(getattr(args, "calib_batches", 2)))
    device = next(model.parameters()).device
    batches = [to_device(b, device) for b, _ in zip(one_process_loader(loaders[split]),
                                                    range(n))]
    qmodel, calib = qr.build_serving_path(model, batches)
    print(f"[w8a8] int8 backbone: {len(calib)} activation scales calibrated on "
          f"{len(batches)} {split} batches")
    return qmodel, calib


def score_and_export(args, model, loaders, norm_scalar: float, provenance: dict,
                     mesh=None):
    """What both forecast CLIs do once the model is restored: resolve
    ``--quantize``, calibrate the w8a8 copy when it says so, score the test
    split with the model it picked (data parallel over ``mesh``), then
    ``--export`` (rank 0, from one process's first batch)."""
    quantize = resolve_quantize(args, loaders["test"])
    scored, calib = model, None
    if quantize == "w8a8":
        scored, calib = build_w8a8_serving_path(model, loaders, args)
    result = score_test_split(args, scored, loaders["test"], norm_scalar, mesh=mesh)
    if getattr(args, "export", "") and is_main_process():
        first = next(iter(one_process_loader(loaders["test"])))
        example = {k: v.numpy() for k, v in first.items()}
        size = export_forecaster(model, example, args.export, quantize=quantize,
                                 extra_header=provenance, calib=calib)
        print(f"Exported serving artifact: {args.export} ({size / 1e6:.1f} MB)")
    return result


def build_loaders(args, *, demand: bool, output_len: int, splits=("train", "test"),
                  text_features: bool = False, dedup_eval_images: bool = False,
                  dedup_train_images: bool = False, dedup_image_slots: int = 0,
                  pin_memory: bool = False, mesh=None) -> Tuple[dict, VocabSizes, float]:
    """Returns ``({split: BatchLoader}, vocab, norm_scalar)``.

    ``text_features`` runs gtm_v1's ingest-time text featurizer
    (``models/gtm_v1.py::TextFeaturizer``) over each split, attaches the
    [N, 768] float32 array as the batch extra ``text_features`` and sets each
    loader's ``text_fingerprint`` (written into ``hparams.json`` at training,
    checked when a checkpoint is scored).  ``dedup_eval_images`` makes
    non-train loaders ship unique-image batches (identical outputs, backbone
    FLOPs divided by the photo duplication factor); ``dedup_train_images``
    gives the train loader the grouped sampler (``--dedup_images 1`` on a
    train CLI; ``data/loader.py``).
    ``dedup_image_slots`` forces the slot count (an artifact's signature
    fixed it at export).  ``pin_memory`` pins every batch (a CUDA target).
    ``mesh``: each loader yields this rank's row block of every batch, and
    dedup slot counts round up to a multiple of the ranks.  Non-dedup
    batches gather their images through the native prefetch engine
    (``native/``), built at first use.
    """
    cat_dict, col_dict, fab_dict = load_label_dicts(args.dataset_path)
    vocab = VocabSizes.from_dicts(cat_dict, col_dict, fab_dict)
    norm_scalar = load_norm_scalar(args.dataset_path)
    featurizer = TextFeaturizer(cat_dict, col_dict, fab_dict) if text_features else None
    rank, world = batch_rank_world(mesh)

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
            image_slots=dedup_image_slots if dedup else 0, image_slots_multiple=world,
            pin_memory=pin_memory, rank=rank, world=world)
        if featurizer is not None:
            loaders[split].text_fingerprint = featurizer.fingerprint
    return loaders, vocab, norm_scalar


def score_test_split(args, model, loader, norm_scalar: float, mesh=None):
    """What both forecast CLIs do once the model and loader exist:
    ``--dump_attention`` (rank 0, on one process's first batch),
    ``score_split`` (``--one_pass``; data parallel over ``mesh``),
    ``--metrics_out`` (the JAX CLIs' JSON keys) and the printed summary;
    rank 0 alone writes and prints."""
    if args.dump_attention and is_main_process():
        keys = dump_attention(model, next(iter(one_process_loader(loader))),
                              args.dump_attention)
        print(f"Attention weights -> {args.dump_attention}: "
              f"{keys if keys else 'model returns no attention aux'}")
    result = score_split(model, loader, mesh=mesh, norm_scalar=norm_scalar,
                         one_pass=None if args.one_pass == "auto" else bool(int(args.one_pass)))
    if not is_main_process():
        return result
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
                 grad_clip: Optional[float], save_top_k: int, mesh=None) -> Optional[str]:
    """The train CLIs' body: ``Trainer`` with the flags' config (data
    parallel over ``mesh``), ``CheckpointManager(save_top_k)`` in
    ``--ckpt_dir``, ``hparams`` as ``hparams.json``, ``metrics.jsonl``, the
    state ``--resume_from`` gives, then ``fit``; rank 0 alone writes them
    and prints, every rank restores.  After a SIGTERM it exits 143 (128 +
    SIGTERM: a pipeline stops in the grace window); else it returns the best
    checkpoint's path."""
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager
    from visuelle2_tpu_torch.train.hparams import save_hparams
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    trainer = Trainer(model, TrainConfig(
        epochs=args.epochs, seed=args.seed, grad_clip=grad_clip, norm_scalar=norm_scalar,
        trace_dir=args.trace_dir or None, accum_steps=args.accum_steps,
        autosave_minutes=args.autosave_minutes,
        early_stop_patience=args.early_stop_patience,
        early_stop_min_delta=args.early_stop_min_delta,
        learning_rate=args.learning_rate or None), mesh=mesh)
    main = is_main_process()
    if main:
        ckpt = CheckpointManager(args.ckpt_dir, save_top_k=save_top_k)
        save_hparams(args.ckpt_dir, hparams)
        log = JsonlLogger(os.path.join(args.ckpt_dir, "metrics.jsonl"), wandb_args=args)
    else:
        # Read only: a resume's early-stop count; fit saves on rank 0 alone.
        ckpt = (CheckpointManager(args.ckpt_dir, read_only=True)
                if os.path.isdir(args.ckpt_dir) else None)
        log = JsonlLogger(None)
    state, start_epoch, skip_steps = prepare_initial_state(trainer, loaders, args)

    t0 = time.time()
    try:
        trainer.fit(loaders["train"], loaders["test"], state=state, checkpointer=ckpt,
                    log_fn=log, start_epoch=start_epoch, skip_steps=skip_steps)
    finally:
        log.close()
    elapsed = time.time() - t0
    if trainer.history and trainer.history[-1].get("preempted"):
        if main:
            print(f"[Training Preempted] state saved at epoch "
                  f"{trainer.history[-1]['epoch']}; continue with --resume_from "
                  f"{args.ckpt_dir}")
        raise SystemExit(143)
    if not main:
        return (CheckpointManager(args.ckpt_dir, read_only=True).best_model_path
                if os.path.isdir(args.ckpt_dir) else None)
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
