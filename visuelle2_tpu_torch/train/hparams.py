"""The checkpoint's hyperparameter manifest, ``hparams.json``: the port's
copy of ``visuelle2_tpu/train/hparams.py``, writing and reading the same
JSON keys, so either package reads the other's manifest.

The trainers write every structural flag (and the dataset's vocabulary sizes
and norm scalar) next to the checkpoints; the forecast CLIs read it back:

* a structural flag not passed on the command line is filled from the
  manifest (``forecast_transformer --ckpt_path <dir>`` needs no dim flags);
* a structural flag passed that conflicts with the manifest is an error;
* a checkpoint with no manifest leaves the flags as given;
* ``check_dataset_compat``: another dataset's vocabulary sizes are an error,
  another norm scalar a warning;
* ``check_text_fingerprint``: gtm_v1's ``text_fingerprint`` (the text
  featurizer of its training features) against this host's; a mismatch is
  an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

from visuelle2_tpu_torch.train.checkpoint import resolve_ckpt_path

HPARAMS_FILE = "hparams.json"

# Forecast-CLI dest -> manifest key, per family.  Only STRUCTURAL knobs are
# filled/checked — anything that changes the parameter tree or the forward
# semantics.  Runtime knobs (batch_size, dataset_path, dedup_images, ...)
# stay with the caller.
DL_STRUCTURAL = {
    "new_product": "demand",  # forecast_dl spells the train CLI's --demand
    "task_mode": "task_mode",
    "output_len": "output_len",
    "embedding_dim": "embedding_dim",
    "attention_dim": "attention_dim",
    "hidden_dim": "hidden_dim",
    "use_img": "use_img",
    "image_arch": "image_arch",
}

TRANSFORMER_STRUCTURAL = {
    "model": "model",
    "demand": "demand",
    "output_len": "output_len",
    "embedding_dim": "embedding_dim",
    "hidden_dim": "hidden_dim",
    "num_attn_heads": "num_attn_heads",
    "num_hidden_layers": "num_hidden_layers",
    "use_img": "use_img",
    "use_text": "use_text",
    "use_encoder_mask": "use_encoder_mask",
    "autoregressive": "autoregressive",
    "query_modality": "query_modality",
    "image_arch": "image_arch",
}


def save_hparams(ckpt_dir: str, hparams: Dict) -> str:
    """Write ``<ckpt_dir>/hparams.json`` (atomic: rename over)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, HPARAMS_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(hparams, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_hparams(ckpt_path: str) -> Optional[Dict]:
    """Manifest for a checkpoint path (manager root OR a step directory —
    the same inputs ``resolve_ckpt_path`` accepts).  None when absent."""
    root, _step = resolve_ckpt_path(ckpt_path)
    path = os.path.join(root, HPARAMS_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_dataset_compat(hp: Optional[Dict], vocab, norm_scalar) -> None:
    """Manifest vs the forecast-time dataset — the half of silent-wrongness
    the structural-flag fill can't catch, because these come from the
    dataset, not from flags.

    * vocab-size mismatch is an ERROR: the embedding tables were sized by
      the training dicts, so a different dataset either fails the state
      dict load opaquely or (same sizes by luck elsewhere) silently
      looks up garbage rows;
    * norm-scalar mismatch is a WARNING: metrics still compute, but the
      model was trained against targets normalized by the training scalar,
      so absolute (denormalized) forecasts are in the wrong units —
      legitimate only for deliberate cross-dataset evaluation.
    """
    if hp is None:
        return
    want_v = hp.get("vocab")
    if want_v:
        got_v = {"num_cat": vocab.num_cat, "num_col": vocab.num_col,
                 "num_fab": vocab.num_fab, "num_store": vocab.num_store}
        bad = {k: (got_v[k], want_v[k]) for k in got_v
               if k in want_v and got_v[k] != want_v[k]}
        if bad:
            raise SystemExit(
                "checkpoint/dataset vocabulary mismatch — the checkpoint's "
                "embedding tables were sized by a different dataset's label "
                "dicts:\n  " + "\n  ".join(
                    f"{k}: dataset {g} vs checkpoint {w}"
                    for k, (g, w) in sorted(bad.items()))
                + "\nPoint --dataset_path at the dataset the checkpoint was "
                "trained on (hparams.json records its vocab sizes).")
    want_ns = hp.get("norm_scalar")
    if want_ns is not None and norm_scalar is not None:
        if abs(float(want_ns) - float(norm_scalar)) > 1e-6 * max(
                1.0, abs(float(want_ns))):
            print(f"[hparams] WARNING: dataset norm scalar {norm_scalar} != "
                  f"the checkpoint's training value {want_ns} — denormalized "
                  f"forecasts are in the training dataset's units; expected "
                  f"only for deliberate cross-dataset evaluation.")


def check_text_fingerprint(hp: Optional[Dict], have: Optional[str]) -> None:
    """gtm_v1: the text featurizer that made the checkpoint's training
    features (``text_fingerprint``) against this host's.  Features of two
    featurizers are garbage to each other's checkpoints, so a mismatch is an
    error, not a silently wrong WAPE."""
    want = (hp or {}).get("text_fingerprint")
    if want and have and want != have:
        raise SystemExit(
            f"gtm_v1 text featurizer mismatch: the checkpoint was trained on "
            f"'{want}' features but this host produces '{have}'. Score it where "
            f"the same featurizer runs, or retrain.")


def explicit_cli_dests(parser: argparse.ArgumentParser,
                       argv: Optional[Sequence[str]] = None) -> set:
    """Dests the user explicitly passed on the command line.

    Re-parses ``argv`` with every default suppressed, so only provided flags
    land in the namespace (argparse has no first-class way to ask).  The
    parser's actions/defaults are restored afterwards."""
    argv = sys.argv[1:] if argv is None else list(argv)
    saved = [(a, a.default) for a in parser._actions]
    saved_defaults = dict(parser._defaults)
    try:
        for a, _ in saved:
            a.default = argparse.SUPPRESS
        parser._defaults.clear()
        ns, _unknown = parser.parse_known_args(argv)
        return set(vars(ns))
    finally:
        for a, d in saved:
            a.default = d
        parser._defaults.update(saved_defaults)


def apply_ckpt_hparams(args: argparse.Namespace,
                       parser: argparse.ArgumentParser,
                       structural: Dict[str, str],
                       argv: Optional[Sequence[str]] = None,
                       ckpt_attr: str = "ckpt_path") -> Optional[Dict]:
    """Fill/verify ``args`` structural flags against the checkpoint manifest.

    Mutates ``args`` in place; returns the loaded manifest (or None when the
    checkpoint has none / no checkpoint was given).  Raises ``SystemExit``
    with a precise message on an explicit-flag conflict."""
    ckpt = getattr(args, ckpt_attr, "")
    if not ckpt:
        return None
    hp = load_hparams(ckpt)
    if hp is None:
        return None
    explicit = explicit_cli_dests(parser, argv)
    filled, conflicts = [], []
    for dest, key in structural.items():
        if key not in hp:
            continue
        want = hp[key]
        if dest in explicit:
            have = getattr(args, dest)
            if have != want:
                conflicts.append(f"--{dest}={have} vs checkpoint {key}={want}")
        else:
            setattr(args, dest, want)
            filled.append(f"{dest}={want}")
    if conflicts:
        raise SystemExit(
            "hparams.json conflict — the checkpoint was trained with a "
            "different model configuration than the flags you passed:\n  "
            + "\n  ".join(conflicts)
            + "\nDrop the conflicting flags to use the checkpoint's own "
            "configuration, or point --ckpt_path at a matching checkpoint.")
    if filled:
        print(f"[hparams] model config from {ckpt}: " + " ".join(filled))
    return hp
