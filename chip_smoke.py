#!/usr/bin/env python3
"""Card check of the PyTorch port (``visuelle2_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``visuelle2_tpu_torch/csrc`` (one nvcc
per source, all started together, sm_90a, into ``build/visuelle2_tpu_torch/``),
then, each phase printing one JSON line and any failure exiting non-zero:

1. device       — the card, its power limit, the kernel library's build time;
2. kernel       — ``fused_gated_residual`` against its plain PyTorch version
   (TF32 off, atol 1e-5) at the main-path shape, ragged ones, B = 1 and
   4,096, D = 1,024, no context (C = 0), 515 KB of weights (4 x 256 x 256)
   and D not a multiple of 4; one launch a call and the same bits twice;
3. mha_kernel   — ``fused_gated_mha`` (one thread-block cluster a batch
   row) against its plain version (TF32 off, atol 2e-5, rtol 1e-5), both
   variants, gcd-masked and unmasked, at the gated_v2 shapes (B=128, D=64,
   4 heads; 52/52 head, 1/52 and 12/52 pure), ragged ones (B=37, D=48),
   1, 2, 8 and 16 heads at D = 64, d = 12, Lk = 100, key and value two
   tensors, equal data in three tensors, the unstaged layout (D = 4,096)
   and a query row with every key masked (NaN where plain gives NaN); one
   launch a call and the same bits twice at every shape;
4. forward      — the full-width gated_v4 demand forecaster (ResNet-101 at
   299², bf16 backbone, E=32, H=64, B=128, random weights from a seeded
   generator) through ``make_forecaster``: finite [128, 12] forecasts, two
   ``fused_gated_residual`` launches per forward, the kernel held to its
   plain version on the fusion inputs of the real forward, and the port on
   the card held to the port on the CPU in f32 at a small width;
5. serve        — the port's HTTP server answers concurrent requests,
   coalesces them, and each answer matches a direct forward of the same rows;
6. times        — gated_v4's forward time per batch by CUDA events over
   distinct batches (the median of five windows, each window reported), its
   device busy time, its split by operator and its top kernels from
   ``torch.profiler``, its FLOPs and the convolutions' rate, the serving
   callable's latency, peak device memory;
7. kernel_times — ``fused_gated_residual``'s and its plain version's device
   time per call (profiler), time per call as seen from Python (CUDA
   events), and the kernel's bound from its shapes;
8. forward_v2   — the full-width gated_v2 forecaster, as in 4: exactly three
   ``fused_gated_mha`` launches per forward (two trend-encoder layers, one
   decoder cross-attention), the kernel held to its plain version on the
   attention inputs of the real forward, and a small gated_v2 on the card
   held to the same model on the CPU in f32;
9. times_v2     — gated_v2's forward times as in 6;
10. mha_kernel_times — per variant at the main-path shape, the kernel's and
   the plain version's device time per launch and time per call over
   ``PROFILE_CALLS`` calls each, and the bound;
11. additive_kernel — ``fused_additive_attention`` (a 3xTF32 tensor-core
   GEMM launch and an energy/softmax/scaling launch per call) against its
   plain version (TF32 off, atol 2e-5, rtol 1e-5 on the output and α), both
   ``weight_on``, at the three CrossAttnRNN Demand shapes (B=128,
   De=Dd=A=512, L = 100 image patches, 52 trend steps, 4 fused tokens), a
   ragged one (B=37, L=13, De=48, Dd=40, A=24) and L=2; at each, the kernels
   a call launches (at most 2) and, at the Demand shapes, each launch's
   device µs and their sum;
12. gru_kernel — ``fused_gru_sequence`` (one persistent launch per call)
   against its plain step loop and cuDNN's ``torch.nn.GRU`` at the trend
   GRU's shape (B=128, T=52, I=3, H=512; atol 1e-4), at ragged small ones
   (B and H not multiples of the 32-row tile and the 16-unit slice; atol
   2e-5) and at ten row tiles on four row groups (B=300, H=512; atol 1e-4);
   at each, a second call on the same inputs gives the same bits (the sums
   take no atomics: a difference is a race in the step barrier);
12b. gru_wide — the GRU kernel's streamed layout (W_h and h through
   shared memory in k-chunks, past the resident layout's H = 724) at H =
   725, 1,024, 1,664 and 2,112 (the limit on an H100: a unit slice on each
   of its 132 SMs; B=128, T=8, I=64) against its plain version (atol
   1e-4), one launch a call, the same bits twice; the recurrence's device µs
   at H = 1,024 beside ``torch.nn.GRU``'s and the bound;
13. forward_demand — the full-width CrossAttnRNN Demand forecaster
   (ResNet-101 at 299², bf16 backbone, E=A=H=512, B=128, random weights from
   a seeded generator) through ``make_forecaster``: finite [128, 12, 1]
   forecasts, exactly 36 ``fused_additive_attention`` launches per forward
   (3 per decode step), the kernel within half its tolerance of its plain
   version on the attention inputs of the real forward, and of a second
   forward with weights and batch from another seed, and a small Demand on
   the card held to the same model on the CPU in f32;
14. forward_demand_gru — the same forecaster with its trend GRU on the
   kernel path (``GRU.use_kernel``, the port of the JAX ``use_pallas``):
   one ``fused_gru_sequence`` launch per forward, forecasts against the
   step-loop path's, and the forward time of both paths in turns;
15. forward_rnn_21_210 — CrossAttnRNN 2-1 and 2-10 (``out_len`` 10) at a
   small width on the card (tiny backbone) against the CPU in f32: 3 and 30
   launches per forward;
16. times_demand — Demand's forward times as in 6;
16b. forecast_cli — a full-width synthetic split (1,000 rows, 4 rows a
   photo, seed 0; the image store's cache written from seeded numpy pixels,
   no JPEG) in a temporary directory under ``build/``, scored through the
   port's ``forecast_transformer.main`` (gated_v4, bf16 backbone, B=128) and
   ``forecast_dl.main`` (Demand, E=A=H=512): 1,000 finite forecasts, WAPE
   and MAE within 1e-4 relative of a float64 host recomputation over the
   same loader, exactly 2 ``fused_gated_residual`` and 36
   ``fused_additive_attention`` launches a forward and no other kernel,
   ``--one_pass 0`` within 1e-3 WAPE and 1e-4 MAE of the default, and
   ``--dedup_images 0`` too in float32 (and within one bf16 ulp, relative,
   with the bf16 backbone, which rounds differently at 32 photos a forward
   than at 128: the phase prints 32 photos' pooled features encoded alone
   against among 128, in bf16 and f32); forecasts/s beside phase 6 and
   16's forward-only rate, the scored forward's device busy time,
   the scoring pass's own rate on the host clock, GFLOPs per sample and
   peak device memory; the ``--dedup_images 0`` runs gather every batch's
   images through the native prefetch engine, the dedup runs through none;
16c. train_kernel — ``fused_gated_residual`` (B=128, D=32, C=128 and a
   ragged shape, both gate forms) and ``fused_gated_mha`` (gated_v2's
   shapes, dropout 0) under their autograd functions on the card (f32, TF32
   off) against autograd of their plain versions: the output, and every
   input's gradient within atol 1e-5; one kernel launch a forward and none
   in the backward; the residual's forward and backward device µs beside
   plain autograd's;
16d. train_parity — a small gated_v4 (tiny backbone at 64², E=H=16, B=8)
   trained 3 steps on the card and on the CPU from the same weights and
   batches, f32, dropout off: losses within 1e-5 relative, the first step's
   gradients within 1e-4 (atol + rtol), each parameter's movement with
   cosine ≥ 0.9999 and norms within 1e-3 (elements whose CPU gradient at
   some step is float noise, below 1e-8 of its global norm, only within the
   noise steps' size), BatchNorm running statistics within 1e-5, frozen
   stages unmoved, 2 launches a step;
16e. train — the full-width gated_v4 (bf16 backbone, B=128): the train step
   through ``Trainer`` (CUDA events over 8 distinct batches, the median of
   two windows, each printed; samples/s; the optimizer step's device and
   host ms; device busy and idle share, top operators and kernels from the
   profiler; peak memory; the same with ``--remat``), then
   ``train_transformer.main`` on a synthetic split under ``build/`` (512
   train rows, 4 steps an epoch, the forecast_cli phase's 1,000 test rows,
   2 epochs, ``--learning_rate 1e-3``, ``--trace_dir``): finite losses,
   exactly 2 ``fused_gated_residual`` launches a train step and an eval
   forward, no host sync inside a step, the checkpoint slots,
   ``hparams.json`` and one trace; the same command cut by a SIGTERM
   after 3 steps of epoch 0 (exit 143), then rerun with ``--resume_from
   auto``, trains only the remaining steps and ends at the same step count
   and epochs; ``forecast_transformer.main --ckpt_path`` on the best epoch
   prints a WAPE within 1e-4 relative of that epoch's logged
   ``val_wWAPE``;
16e''. data_parallel (after train) — the data-parallel ``Trainer``
   (``parallel/``) at full width (gated_v4, ResNet-101 at 299², bf16
   backbone, E=32, H=64, global B=128): (a) one NCCL rank on ``make_mesh()``
   against the plain ``Trainer`` built from the same seed, over the same 4
   distinct batches (cuDNN's deterministic algorithms in both): the losses,
   parameters and buffers bit for bit, no host sync in a step, 2
   ``fused_gated_residual`` launches a step and no other kernel, ms a step
   of both in turns (plain, data parallel, data parallel, plain) by CUDA
   events; the process group destroyed after; (b) ``parallel.demo_multihost``
   spawned as two gloo ranks on the one card (64 rows each of one 128-row
   global batch, 2 steps, dropout on, ``--learning_rate`` 1e-3) and as one
   process, each with its own time limit: both ranks' losses and eval sums
   equal, the losses within ``DP_RTOL`` of one process, the frozen stages
   unmoved, the float noise elements within their noise steps, each
   parameter's movement against one process by ``_compare_training``'s
   rules reported by group (the backbone's BatchNorms, its convolutions,
   the rest), and the kernel library not rebuilt by the children;
16l. tensor_parallel (after data_parallel) — tensor parallelism
   (``parallel/sharding.py``) at full width: (a) ``model = 1`` is
   data_parallel's (a), one NCCL rank bit for bit the plain ``Trainer``;
   (b) gated_v4 (ResNet-101 at 299², bf16 backbone, E=32, H=64,
   ``tp_min_dim`` 64, global B=64, 3 steps, dropout on) as two gloo ranks
   of a data=1 x model=2 mesh on this card, beside one process alone, each
   a worker process (``chip_smoke.py --tensor-parallel-rank SPEC``) with
   its own time limit: the sharded parameters' count equal on the ranks
   and to the rule on the CPU; each rank's resident bytes of parameters and
   Adafactor state equal to the prediction from the sharded set (sharded
   parameters and their state halved, the rest whole), one process's too;
   peak memory a process; the ranks' losses equal and within ``DP_RTOL`` of
   one process at every step; the replicated parameters and the buffers
   the same bits on both ranks (digests), with cuDNN free to pick
   nondeterministic algorithms and rank 1 moving its replicated gradients
   and buffers an ulp before each sync, so that only the sync's rule keeps
   them equal; 2 ``fused_gated_residual`` launches a step a rank;
   a one-pass ``score_split`` over the mesh equal on the ranks; a
   checkpoint saved under the mesh (rank 0 writes the gathered state)
   restored into a plain model scoring the same WAPE and MAE bit for bit,
   within the JAX dry run's 1e-3 WAPE and 1e-4 MAE; one process's own
   trained eval reported beside; (c) cross_attn_rnn_210 (tiny backbone at
   64², E=A=H=32, ``out_len`` 10, teacher forcing at 0.5, ``tp_min_dim``
   16) on the same mesh: one step, 30 additive launches a forward, no
   ``w_i`` / ``w_h`` sharded, decoder kernels among the sharded ones, the
   rule's count, eval WAPE within 1e-3 of one process.  ``python3
   chip_smoke.py --tensor-parallel-cards 4`` runs, alone, gated_v4 at the
   main path's B=128 on a (data=2, model=2) and then a (data=4, model=1)
   NCCL mesh over four cards: ms a step, host syncs in a step, a profiled
   step's non-NCCL device ms as a share of the event-timed step, peak
   memory and resident bytes a rank; then the witnesses, held at every
   step within ``DP_RTOL``: (2, 2) against (2, 1), the same 64 rows a rank,
   deterministic cuDNN, whose first update's parameters agree within
   ``TP_CARDS_PARAM_RTOL``, and (2, 2) against (4, 1) with a float32
   backbone (in bf16 the data axis's rounding at 64 against 32 rows a rank
   moves the two meshes apart by more than 2^-8: reported);
16e'. artifact_serve — the serving path from a full-width gated_v4
   checkpoint (seeded weights saved as ``train_transformer`` saves them,
   with its ``hparams.json``; bf16 backbone, B=128): ``cli.export`` (no
   dataset but its label dicts) writes a float and an ``--quantize int8``
   artifact (MB, ``quantized_arrays``); ``load_forecaster`` loads each on
   the card (seconds): the float artifact's forecasts within 1e-5 x
   max|forecast| of ``make_forecaster``'s on the checkpoint's model, the
   int8 one's within 0.05 x (``tests/test_export.py``'s bound), its weights
   on the card the same bits as a numpy dequantization on the CPU, exactly 2
   ``fused_gated_residual`` launches a forward and none of another kernel;
   a small Demand artifact (tiny backbone at 64², E=A=H=16, B=128): 36
   ``fused_additive_attention`` launches a forward through its ``fn``;
   forecasts/s through each callable (CUDA events over distinct batches, in
   turns); ``forecast_transformer --ckpt_path --export`` and ``cli.serve
   --artifact`` on the forecast CLIs' split, WAPE and MAE within 1e-6
   relative; ``cli.serve --artifact --http 0`` as a subprocess on the card,
   six concurrent requests of 1–3 rows through the port's client, each
   within ``SERVE_RTOL`` of a direct forward, ``/health``'s requests and
   dispatches; a SIGTERM while a request is in flight (half its body sent):
   no new connection is taken, the request is answered, the process exits
   143; then a seeded ResNet-101 npz, written by the port's codec, spliced
   into the checkpoint's model on the card: the backbone equal to the npz,
   the forecasts finite and changed;
16f. train_additive — ``fused_additive_attention`` (the three Demand shapes,
   B=128, De=Dd=A=512, L = 100, 52, 4, and a ragged one, both ``weight_on``)
   and ``fused_gru_sequence`` (the trend GRU's shape, B=128, T=52, I=3,
   H=512, with h0) under their autograd functions on the card (f32, TF32
   off) against autograd of their plain versions: the outputs and every
   input's gradient within the forward's tolerance (additive atol 2e-5 +
   rtol 1e-5, GRU atol 1e-4), the measured maximum printed beside it; one
   wrapper call a forward and none in the backward, the additive kernels a
   forward and backward by the profiler (2); each kernel's forward and
   backward device µs beside plain autograd's;
16g. train_demand_parity — small CrossAttnRNN Demand, 2-1 and 2-10
   (``out_len`` 10; tiny backbone at 64², E=A=H=16, two images a batch)
   trained 3 steps on the card and on the CPU from the same weights and
   batches, f32, dropout off, unclipped, teacher forcing at ratio 1 (all
   coins true): train_parity's bounds, and 36, 3 and 30 additive launches a
   step.  The batches are the first candidates whose CPU run, before the
   card runs, keeps every ReLU input of the trainable backbone blocks more
   than 1e-5 from zero at every step (40 candidates at most): nearer zero
   the card may give it the other sign, and the two devices then take the
   loss's two one-sided derivatives;
16h. train_demand — the full-width Demand (bf16 backbone, E=A=H=512,
   B=128, teacher forcing at ratio 0.5): the train step through ``Trainer``
   as in 16e, its device ms in the additive kernels, exactly 36 additive
   launches a step's forward and none in its backward, no host sync in a
   step, the trend GRU's kernel path (1 launch a step's forward, none in
   its backward; the step time of both paths in turns), then ``train_dl.main``
   (``--demand 1 --use_teacher_forcing``) on the split of 16e, whole and cut
   by a SIGTERM after 3 steps and resumed with ``--resume_from auto``, and
   ``forecast_dl.main --ckpt_path`` on the best epoch with no dim flags,
   within 1e-4 relative of that epoch's logged ``val_wWAPE``;
17. additive_kernel_times — per Demand call (L = 100, 52, 4), the kernel's
   and the plain version's device time per call, the kernel's per launch,
   launches per call and per forward, and the bounds (float32-accurate:
   the lesser of float32 FMAs and 3xTF32 products; and float32 FMAs alone);
18. gru_kernel_times — at the trend GRU's shape, the device time per call
   and time per call (over ``GRU_TIMED_CALLS`` calls) of the kernel path
   (input GEMM and the one recurrence launch), the recurrence kernel's own
   device time, of its plain version and of ``torch.nn.GRU``, and the
   bound;
19. probe_kernels — the conv-floor probe's three kernels (``matmul_bf16``,
   ``matmul_int8``, ``read_reduce``) against their plain versions: the JAX
   parity check's size and seed (``perf.convfloor.parity_check``), both
   full probe shapes (A = 720896 x 256 -> 64, B = 184320 x 512 -> 128) and
   a ragged one; int8 bit for bit equal to plain and ``torch._int_mm``,
   bf16 within one bf16 ulp beyond the f32 sums' reordering bound, the
   read probe's full-K partials within atol 1e-4 + rtol 1e-5 (every column
   of x read) and its bias reaching every partial; one launch per call;
20. convfloor_times — the roofline harness's probe (``perf.convfloor.
   measure_shape``, the path that runs these kernels) at both shapes: the
   five measurements and ``torch.sum``'s as µs, TFLOP/s and GB/s (replays
   of a CUDA graph of calls), the plain versions' µs (CUDA events), the
   profiler's device µs per kernel record, and the bounds;
21. conv_roofline — the harness's square bf16 GEMM controls, the 24
   ResNet-101 conv shapes at B=128 in bf16 with their FLOP-weighted sum
   beside the ``aten::cudnn_convolution`` ms of phase 6's gated_v4 forward,
   the artifact check, and the epilogue and chain ratios.

The phases of the last two registry models and of the reference's task
list, each run at the place its number gives among those above:

11b. legacy_inception — the port's InceptionV3 backbone (seeded weights at
   the registry's initializers) at 299², B=128, in f32 and bf16 (forward ms,
   peak memory; finite [128, 2048, 8, 8]), the backbone at B=2 on the card
   against the CPU in f32 (atol 1e-4), then ``LegacyImageEncoder`` (E=512)
   -> [128, 64, 512] and ``LegacyAdditiveAttention`` through
   ``fused_additive_attention`` at B=128, L=64, De=Dd=A=512: one wrapper call,
   within atol 2e-5 + rtol 1e-5 of the plain version on those inputs, at
   most 2 kernels a call; the call's device µs beside plain's and the bound;
16a. forward_gtm_v1 — the full-width gtm_v1 (frozen ResNet-50 at 299²,
   E=32, H=64, 4 heads, 1 layer, 12 weeks, B=128, the hashed featurizer's
   768-wide text features, seeded weights) through ``make_forecaster``,
   non-AR and AR, with an f32 and a bf16 tower: finite [128, 12] forecasts,
   no model kernel launched; the non-AR forward's times as in 6; a small
   gtm_v1 (non-AR and AR) on the card within 1e-4 of the CPU in f32;
16b'. stats — ``forecast_stat.main`` on the forecast CLIs' 1,000-row split
   taken as an stfore split (2-week windows; photos cached at 32², which
   the baselines do not read), naive, SES and Holt with teacher forcing on
   and off: the CLI's forecasts' WAPE and MAE within 1e-5 relative of a
   float64 numpy recomputation of the closed forms over the same windows,
   the printed line their reference rounding, no model kernel launched, the
   pass's host seconds; Holt at T > 2 on the series
   ``tests/test_stats_and_metrics.py`` pins: the card's fit (forecasts,
   level, trend and grid picks) equal to the CPU's bit for bit, and the
   recorded constants within rtol 1e-4;
16i. train_gtm_v1 — the full-width gtm_v1 (bf16 tower) trained through
   ``Trainer`` as in 16e (no ``--remat`` effect: the tower has no backward),
   the tower's parameters and BatchNorm statistics bit-unchanged, no host
   sync in a step, no kernel launched; then ``train_transformer.main --model
   gtm_v1 --demand 1 --image_arch resnet50`` on the split of 16e for 2
   epochs (``hparams.json`` says ``text_fingerprint: hashed-crc32-v1``) and
   ``forecast_transformer.main --ckpt_path`` on the best epoch within 1e-4
   relative of its logged ``val_wWAPE``;
16j. data_plane (after train) — on the train phases' split (512 train
   and 1,000 test rows, 4 rows a photo): the full-width gated_v4 (bf16)
   scoring the test split through ``score_split`` and training an epoch
   through ``Trainer.train_step`` on the train loader's batches, each with
   the native prefetch engine and with the numpy gather in turns (numpy,
   engine, engine, numpy): the pass's forecasts/s and the step's ms on the
   host clock, the same WAPE and MAE either way, the step's device busy ms
   and idle share by the profiler; then the grouped sampler
   (``--dedup_images 1``): its ``unique_image_slots``, an epoch's step ms,
   and ``train_transformer.main --dedup_images 1`` for one epoch (a finite
   loss, a best checkpoint);
16k. w8a8 (after artifact_serve) — ``int8_conv`` (``csrc/int8_conv.cu``:
   ``wgmma`` s8, TMA, the identity shortcut read as int8 in its epilogue,
   the stem on 4 padded channels) against its plain version at the main
   path's B=128 on each of ResNet-101's 28 distinct conv launches at 299²
   (the codes and the "float" epilogue's values exact), and each shape's µs
   beside its plain version's, its bound and ``torch._int_mm`` on the 1x1
   stride-1 GEMMs; the forward's bound also as the float32-addend design
   before this one counted it (3-channel stem, 4-byte shortcut);
   the full-width gated_v4 (bf16 backbone) calibrated on 2 batches
   (``quantized_resnet.build_serving_path``) and served through
   ``make_forecaster``: finite [128, 12] forecasts, exactly 104
   ``int8_conv`` and 2 ``fused_gated_residual`` launches a forward, its
   device split by operator and kernel with no shortcut pass (``copy_`` and
   ``mul`` under ``W8A8_SHORTCUT_PASS_MS`` together); its
   backbone on the card at 128 photos equal, on the first two, to the CPU
   plain path prepared from the same calibration; the w8a8 and bf16
   forwards in turns with CUDA events at image duplication 1, 4, 10, 32
   and 128 (128 rows over 128, 32, 13, 4 and 1 photos), each with the
   host's time to issue one forward onto an idle card: forecasts/s and the
   largest duplication at which w8a8 was faster
   (``W8A8_AUTO_MAX_DUPLICATION``'s source); then on the forecast CLIs'
   split ``forecast_transformer --quantize w8a8 --export``, the artifact
   through ``load_forecaster`` (104 launches a forward) and ``cli.serve
   --artifact`` (the CLI's WAPE and MAE bits), and ``--quantize auto``'s
   line;
22. run_all — ``run_all.main`` on a small split under ``build/`` (64 train
   and 32 test rows, photos cached at 32², tiny backbone, 1 epoch, B=16):
   six results printed, each forecast from the checkpoint its training
   returned (spies on ``train_dl.run`` and ``forecast_dl.run``), each stat
   result equal to ``forecast_stat`` run alone.

Then a ``phase_seconds`` line (each phase's ``phase_s``), the ``kernels``
line (the seven TPU kernels' ports and ``int8_conv``,
which replaces the JAX engine's XLA convolution; ``launches`` counts each
row's own path, ``launches_forecast_cli`` the forecast CLIs' runs,
``launches_run_all`` run_all's, ``launches_artifact_serve``
artifact_serve's in-process forwards, ``launches_w8a8_cli`` the w8a8
phase's ``forecast_transformer --quantize w8a8`` run, rows 1, 3 and 4's ``launches_train`` a
train step's forward and backward and an eval forward's, row 3's
``launches_legacy`` the legacy attention's, ``launches_data_parallel`` the
data_parallel phase's one-rank steps, ``launches_tensor_parallel`` rank 0's
a tensor-parallel step (row 1) and a 2-10 forward (row 3)), the
``nvidia-smi`` line and,
last, the ``ok`` line.  Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

B = 128          # export batch of the main path
IMAGE = 299
KERNEL_ATOL = 1e-5   # gated residual vs plain: both f32, sums in another order
# Gated MHA vs plain: the tolerance tests/test_pallas_kernels.py holds the
# Pallas kernel to (softmax and five chained products, sums in another order).
MHA_ATOL, MHA_RTOL = 2e-5, 1e-5
F32_ATOL = 1e-4      # port on the card vs on the CPU in f32, as the CPU tests
# Served rows vs a direct forward of just those rows: the bf16 backbone runs
# at another batch size there, where cuDNN may pick other algorithms that
# round differently; bf16 keeps about 3 significant digits.
SERVE_RTOL = 5e-2
N_FWD = 3                   # forwards of each main-path run
# GRU kernel vs plain and cuDNN at the trend GRU's full width: 52 serial steps,
# each a 512-long f32 sum in another order, carry the rounding of every step
# into the next; 1e-4 is the whole-model f32 tolerance of the CPU tests, and
# the measured maximum is printed beside it.
GRU_ATOL_FULL, GRU_ATOL_SMALL = 1e-4, 2e-5
# The read probe's partials: 256 bf16 values summed in f32 in another order.
READ_ATOL, READ_RTOL = 1e-4, 1e-5
GRU_KERNEL_NAME = "gru_persistent_f32_kernel"  # csrc/gru_seq.cu, as the profiler names it
# csrc/additive_attention.cu: the grouped 3xTF32 GEMM, then the energies,
# softmax and scaling.
ADDITIVE_KERNEL_NAMES = ("gemm_3xtf32_kernel", "attend_kernel")
ADDITIVE_MAX_LAUNCHES = 2
# The streamed layout's widths (B=128, T=8, I=64), up to the limit on an H100
# SXM: one 16-unit slice on each of its 132 SMs.
GRU_WIDE = (725, 1024, 1664, 2112)
# The additive attention kernel's tensor-core sums lose more than float32
# FMAs: on a Demand forward's own inputs it must stay within half its
# tolerance, at two seeds of weights and batches.
DEMAND_ATTN_MAX_SHARE = 0.5
BF16_GEMM_TOL = "one bf16 ulp (rtol 2^-7) + 2*K*2^-24*(|x|.|w|), the f32 reordering bound"
HARNESS_TARGET_S = 0.2   # device seconds per harness measurement
# Calls in a profiled window.  A torch.profiler window loses a count of its
# kernel records that is the same whatever the window's length and grows as
# the process ages (none at its start): with the train phases before it, a
# window of 20 one-kernel calls kept none.
PROFILE_CALLS = 100
# Calls of the trend GRU's paths (gru_kernel_times) timed and profiled: the
# plain step loop launches ~500 kernels a call.
GRU_TIMED_CALLS = 10
CROSS_ATTN_DIMS = dict(attention_dim=512, embedding_dim=512, hidden_dim=512)
# The forecast CLIs' split: 1,000 rows, 4 rows a photo (250 photos at 299²),
# so 8 batches of 128, the last with 104 real rows.
CLI_ROWS, CLI_ROWS_PER_IMAGE = 1000, 4
METRIC_RTOL = 1e-4          # score_split's device sums vs a float64 host recomputation
# Dedup on and off, one-pass and per batch: the JAX CLI test's bounds, where
# both runs do the same float32 arithmetic up to its order.
SAME_WAPE_ATOL, SAME_MAE_ATOL = 1e-3, 1e-4
# Dedup on and off with the bf16 backbone: it encodes 32 photos a forward
# against 128, and cuDNN's bf16 convolutions round differently at the two
# batch sizes (the pooled features of the same photo differ by one bf16 ulp,
# where float32 differs by 6e-6), so the metrics are held to one bf16 ulp,
# relative.
BF16_SAME_RTOL = 2.0 ** -8
# Training.  The kernels under autograd against autograd of their plain
# versions: the gradients are f32 sums in another order (train_kernel).  The
# small gated_v4 trained on the card and on the CPU (train_parity): losses,
# first-step gradients, parameter movement over the steps (cosine and norm,
# per parameter: Adafactor's first update is close to sign(g), so only the
# direction of a whole parameter is meaningful), BatchNorm statistics.
TRAIN_KERNEL_ATOL = 1e-5
TRAIN_PARITY_STEPS = 3
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STATS_TOL = 1e-5, 1e-4, 1e-5
TRAIN_COS_FLOOR, TRAIN_NORM_RTOL = 0.9999, 1e-3
TRAIN_LR = 1e-3
TRAIN_NOISE_SHARE = 1e-8  # of a step's global gradient norm: float noise
# A ReLU input of a trainable backbone block may take either sign on the card
# and on the CPU within this of zero (the forward's f32 tolerance between
# devices); train_demand_parity screens candidate batches, this many at most,
# for one whose CPU run keeps every such input further from zero.
KINK_ATOL, KINK_CANDIDATES = 1e-5, 40
# Images a batch of train_demand_parity (Demand rows, or 2-1/2-10 products of
# two windows each): at 8 images of 64² the trainable blocks hold 442,368 ReLU
# inputs, and nearly every step has one within KINK_ATOL of zero.
PARITY_IMAGES = 2
# Full width (train): 512 train rows (4 steps an epoch), 2 epochs; the
# SIGTERM lands after this many steps of epoch 0; forecast --ckpt_path scores
# the best epoch within this of its logged val_wWAPE.
TRAIN_ROWS, TRAIN_EPOCHS, TRAIN_PREEMPT_AFTER = 512, 2, 3
TRAIN_WINDOWS = 2
TRAIN_ARCH = "resnet101"
TRAIN_WAPE_RTOL = 1e-4
# The statistical baselines (stats): the forecast CLIs' 1,000-row split as an
# stfore split (2-week windows); the baselines read no pixel, so its photos
# are cached at 32².  WAPE and MAE within this of a float64 recomputation;
# Holt at T > 2 on the series tests/test_stats_and_metrics.py pins.
STATS_IMAGE = 32
STATS_RTOL = 1e-5
HOLT_PINNED = {(3., 5., 4., 7., 8., 6., 9., 11.): (11.071446, 12.059547, 13.047647),
               (10., 8., 9., 5., 6., 3.): (2.33339, 1.047698, -0.237995)}
HOLT_PINNED_RTOL = 1e-4
# gtm_v1 at the registry's dims: a frozen ResNet-50 tower at 299², 768-wide
# hashed text features.
GTM_V1_DIMS = dict(embedding_dim=32, hidden_dim=64, num_heads=4, num_layers=1,
                   output_len=12, image_arch="resnet50")
# The legacy InceptionV3 encoder (E = 512) and its additive attention over
# 64 patch tokens.
LEGACY_DIM = 512
# run_all on a small split: tiny backbone at 32², 1 epoch, batches of 16.
RUN_ALL_ROWS, RUN_ALL_IMAGE, RUN_ALL_BATCH = (64, 32), 32, 16
# Serving from an artifact (artifact_serve): float artifacts to the model
# path's forecasts within this share of their largest magnitude (the same
# weights and code: a float32 reordering at most); int8 weights within
# tests/test_export.py's bound; cli.serve's WAPE and MAE within this of the
# forecast CLI's on the same checkpoint and split.
ARTIFACT_FLOAT_TOL, ARTIFACT_INT8_TOL = 1e-5, 0.05
ARTIFACT_METRIC_RTOL = 1e-6
ARTIFACT_ARCH = "resnet101"
# A Demand artifact at a small width: its 36 additive-attention launches a
# forward through load_forecaster's fn.
ARTIFACT_DEMAND_DIMS = dict(attention_dim=16, embedding_dim=16, hidden_dim=16,
                            image_arch="tiny")
ARTIFACT_DEMAND_IMAGE = 64
ARTIFACT_TIMED_BATCHES = 4    # distinct batches a timed window, four windows in turns
SERVE_START_S = 300           # the serving subprocess's time to print its port

W8A8_DUPLICATIONS = (1, 4, 10, 32, 128)   # 128 rows over 128, 32, 13, 4 and 1 photos
W8A8_CHECK_BATCH = 2     # photos of the backbone's card-vs-CPU check (the CPU's float64)
W8A8_TIMED_CALLS = 20    # per conv shape at B=128
W8A8_TIMED_BATCHES = 4   # distinct batches a window, four windows in turns
W8A8_CALIB_BATCHES = 2
# The w8a8 forward's copy_ and mul, device ms: the input's quantization and
# the output's scale.  The identity shortcuts' float32 addend took 10.8 ms.
W8A8_SHORTCUT_PASS_MS = 1.5
DATA_PLANE_TURNS = (False, True, True, False)  # native_prefetch, in turns
# Data parallel (data_parallel): one NCCL rank against the plain Trainer on
# this many distinct batches; two gloo ranks of the demo (seeded weights)
# against one process, this many steps, each process with this time limit.
DP_BATCHES, DP_DEMO_STEPS, DP_CHILD_TIMEOUT_S = 4, 2, 300
DP_DEMO_LR = TRAIN_LR
# Two ranks at B = 64 against one process at B = 128 with the bf16
# backbone: cuDNN may pick other algorithms at the two batch sizes, and a
# bf16 convolution then rounds a feature differently by up to one bf16 ulp,
# relative (BF16_SAME_RTOL, measured in forecast_cli); the loss is a mean
# over those features, so it is held to the same share.
DP_RTOL = BF16_SAME_RTOL
DATA_PLANE_PROFILED_STEPS = 3  # a profiler window's train steps (its post-processing is slow)
# Tensor parallel (tensor_parallel): the full-width gated_v4 on a data=1 x
# model=2 mesh of two gloo ranks on this card against one process, this
# global batch and steps, parameters sharded at this width (the JAX
# Trainer's default); the losses within DP_RTOL, the one-pass eval within
# the JAX dry run's bounds; then cross_attn_rnn_210 at a small width
# (__graft_entry__.py's dry run: tp_min_dim 16, teacher forcing at 0.5).
TP_BATCH, TP_STEPS, TP_MIN_DIM, TP_EVAL_BATCHES = 64, 3, 64, 2
TP_WAPE_ATOL, TP_MAE_ATOL = 1e-3, 1e-4
TP_210_DIMS = dict(attention_dim=32, embedding_dim=32, hidden_dim=32, image_arch="tiny",
                   out_len=10, use_teacher_forcing=True, teacher_forcing_ratio=0.5)
TP_210_MIN_DIM, TP_210_BATCH, TP_210_IMAGE, TP_210_LAUNCHES = 16, 16, 64, 30
TP_CHILD_TIMEOUT_S = 420
TP_WORKER_FLAG = "--tensor-parallel-rank"  # a rank of the phase, spawned by it
# The four-card check (tensor_parallel_cards, run alone): (data=2, model=2)
# and (data=4, model=1) NCCL meshes at the main path's global batch, timed;
# then the witnesses: (2, 2) against (2, 1), the same 64 rows a rank, with
# deterministic cuDNN, whose first update may differ only by the order of
# the model group's sums (each tensor within TP_CARDS_PARAM_RTOL of its
# largest element); and (2, 2) against (4, 1) with a float32 backbone.
TP_CARDS_STEPS, TP_CARDS_TIMED, TP_CARDS_PARAM_RTOL = 3, 4, 1e-6


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_PHASE_MARK = [time.perf_counter()]  # when the last phase line was printed
_PHASE_SECONDS = {}  # phase -> its phase_s, for the summary line


def _emit(obj):
    """Print one JSON line; a phase line gets its ``phase_s`` (the time
    since the previous phase line) unless it measured its own."""
    if "phase" in obj:
        now = time.perf_counter()
        obj.setdefault("phase_s", now - _PHASE_MARK[0])
        _PHASE_MARK[0] = now
        # data_plane's phase_s holds its parts' seconds.
        ps = obj["phase_s"]
        _PHASE_SECONDS[obj["phase"]] = sum(ps.values()) if isinstance(ps, dict) else ps
    print(json.dumps(obj), flush=True)


def _synthetic_batch(n, image_size, seed):
    rng = np.random.default_rng(seed)
    return {
        "ts": rng.random((n, 12)).astype(np.float32),
        "cat": rng.integers(0, 5, n).astype(np.int32),
        "col": rng.integers(0, 6, n).astype(np.int32),
        "fab": rng.integers(0, 5, n).astype(np.int32),
        "store": rng.integers(0, 126, n).astype(np.int32),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "images": rng.integers(0, 255, (n, image_size, image_size, 3)).astype(np.uint8),
        "mask": np.ones((n,), np.float32),
    }


def _to_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _cuda_ms(fn, iters):
    """Mean time per call of ``fn()`` over ``iters`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_us(prof):
    """Kernel time (µs) in a profile, summed as its key_averages table does."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)


def _gate_inputs(model, img, text, dummy):
    """The two fused-gated-residual calls of a TG-Fusion forward, as
    (x, ctx, Wx, Wc, b) tuples in the order the forward makes them."""
    fusion = model.fusion
    ctx = text.reshape(text.shape[0], -1)
    C = ctx.shape[1]
    calls = []
    for x, gate in ((dummy, fusion.dummy_gate_fc), (img, fusion.img_gate_fc)):
        calls.append((x, ctx, gate.kernel[C:], gate.kernel[:C], gate.bias))
    return calls


def _gated_mha_modules(model):
    """gated_v2's three gated-MHA modules, in the order a forward calls them."""
    enc = model.gtrend_encoder.encoder
    return [enc.layer0.self_attn, enc.layer1.self_attn, model.decoder.layer0.cross_attn]


def _call_times(fns, n_calls):
    """Device ms per call (profiler) and ms per call from Python (CUDA
    events) of each zero-argument callable in ``fns``.  The profiler can drop
    records in a window, so a call's device time is, over the kernels it
    launches, each kernel's µs per record times its records per call; a
    window whose record counts are not whole multiples of ``n_calls`` is
    taken again, up to three times."""
    for f in fns.values():
        f()
    call_ms = {name: _cuda_ms(f, n_calls) for name, f in fns.items()}
    device_ms = {}
    for name, f in fns.items():
        for _ in range(3):
            with _profile() as prof:
                for _ in range(n_calls):
                    f()
                torch.cuda.synchronize()
            records = [(e.count, e.self_device_time_total) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                       and e.count]
            device_ms[name] = sum(max(1, round(n / n_calls)) * us / n
                                  for n, us in records) / 1e3
            if records and all(n % n_calls == 0 for n, _ in records):
                break
    _require(min(device_ms.values()) > 0, f"profiler saw no device time: {device_ms}")
    return device_ms, call_ms


def _profiled_kernels_us(fn):
    """The profiler's device µs per record of each kernel ``fn`` launches
    (name -> [records, µs per record]) over ``PROFILE_CALLS`` calls; a
    window in which the profiler kept no kernel record is taken again, up
    to three times."""
    fn()
    for _ in range(3):
        with _profile() as prof:
            for _ in range(PROFILE_CALLS):
                fn()
            torch.cuda.synchronize()
        records = {e.key[:60]: [e.count, e.self_device_time_total / e.count]
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.count}
        if records:
            return records
    raise RuntimeError("chip_smoke: the profiler kept no kernel record in three windows")


def _kernels_per_call(per_kernel, n_calls=PROFILE_CALLS):
    """Kernel launches a call from ``_profiled_kernels_us``: the kernel names
    seen, or the records a call where the profiler kept more."""
    return max(len(per_kernel), round(sum(n for n, _ in per_kernel.values()) / n_calls))


def _launch_split_us(per_kernel):
    """Each kernel's device µs per record, and their sum: a call's device µs
    where each kernel launches once a call."""
    split = {name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]: us
             for name, (_, us) in per_kernel.items()}
    return {**split, "total": sum(split.values())}


def _kernel_vs_plain_times(kernel, plain, args, kwargs, n_calls=500):
    """``_call_times`` of a kernel and its plain version on the same inputs."""
    return _call_times({"kernel": lambda: kernel(*args, **kwargs),
                        "plain": lambda: plain(*args, **kwargs)}, n_calls)


def _forward_times(model, fn, host_batches, dev, seed, kernel_groups=None,
                   make_batch=None):
    """Forward time at B=128 (median of five CUDA-event windows over eight
    distinct batches), device busy time and idle share, the split by
    operator and the top kernels, FLOPs, serving-callable latency and peak
    device memory; ``kernel_groups`` (name -> kernel-name substrings) adds
    the device ms per forward of each group of kernels; ``make_batch(n,
    image, seed)`` makes the batches (``_synthetic_batch`` by default)."""
    make_batch = make_batch or _synthetic_batch
    fn_s = []
    for hb in host_batches:  # warm: the callable already ran
        t0 = time.perf_counter()
        fn(hb)
        fn_s.append(time.perf_counter() - t0)
    dev_batches = [_to_device(make_batch(B, IMAGE, seed=seed + i), dev) for i in range(8)]
    with torch.inference_mode():
        for b in dev_batches[:2]:
            model(b)
        cycle = itertools.cycle(dev_batches)
        # Five windows of eight distinct batches each: their spread says how
        # far one run's forward time can be trusted.
        fwd_windows = [_cuda_ms(lambda: model(next(cycle)), len(dev_batches))
                       for _ in range(5)]
        fwd_ms = float(np.median(fwd_windows))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model(dev_batches[0])
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        with _profile() as prof:
            for b in dev_batches[:2]:
                model(b)
            torch.cuda.synchronize()
        fwd_device_ms = _device_us(prof) / 2e3
        with FlopCounterMode(display=False) as flops:
            model(dev_batches[1])
    by_aten = {str(op): n for op, n in flops.get_flop_counts()["Global"].items()}
    conv_flops = sum(n for op, n in by_aten.items() if "convolution" in op)
    all_ops = {e.key: e.self_device_time_total / 2e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.self_device_time_total > 0}
    by_op = sorted(all_ops.items(), key=lambda kv: -kv[1])[:10]
    by_kernel = sorted(([e.key[:100], e.self_device_time_total / 2e3, e.count // 2]
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                       key=lambda kv: -kv[1])[:8]
    groups = {name: [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and any(k in e.key for k in keys)]
              for name, keys in (kernel_groups or {}).items()}
    by_group = {name: sum(e.self_device_time_total for e in es) / 2e3
                for name, es in groups.items()}
    return {"batch": B, "forward_ms": fwd_ms, "forward_ms_windows": fwd_windows,
            "forward_device_ms_by_kernel_group": by_group,
            # Records the window kept a forward: below the launches a forward
            # makes, the window lost some, and its ms read low.
            "forward_kernel_records_by_group": {name: sum(e.count for e in es) / 2
                                                for name, es in groups.items()},
            "forecasts_per_s": B / (fwd_ms / 1e3),
            "forward_device_busy_ms": fwd_device_ms,
            "device_idle_share": max(0.0, 1.0 - fwd_device_ms / fwd_ms),
            "forward_device_ms_by_op": dict(by_op),
            "forward_top_kernels_ms_launches": by_kernel,
            "forward_flops": flops.get_total_flops(), "conv_flops": conv_flops,
            "conv_tflops_per_s": (conv_flops / 1e9 / all_ops["aten::cudnn_convolution"]
                                  if "aten::cudnn_convolution" in all_ops else None),
            "serving_fn_ms_incl_copies": sorted(1e3 * t for t in fn_s),
            "max_memory_allocated_bytes": peak_bytes}


def _card_vs_cpu(name, dev, batch=None, **dims):
    """A small f32 model (tiny backbone) on the card vs the same weights on
    the CPU: max abs difference of the forecasts."""
    from visuelle2_tpu_torch.models import VocabSizes, build

    if name != "gtm_v1":  # gtm_v1's text arrives featurized: no vocabulary
        dims["vocab"] = VocabSizes(5, 6, 5, 126)
    small = build(name, device=dev, generator=torch.Generator().manual_seed(2),
                  image_arch="tiny", **dims)
    small_cpu = build(name, device="cpu", image_arch="tiny", **dims)
    small_cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    sb = _synthetic_batch(8, 64, seed=3) if batch is None else batch
    with torch.inference_mode():
        on_card = small(_to_device(sb, dev))[0].cpu()
        on_cpu = small_cpu(_to_device(sb, "cpu"))[0]
    return (on_card - on_cpu).abs().max().item()


def _mha_err(got, want):
    """Max abs error, and whether every element is within atol + rtol·|want|."""
    diff = (got - want).abs()
    ok = bool((diff <= MHA_ATOL + MHA_RTOL * want.abs()).all().item())
    return diff.max().item(), ok


def _additive_err(got, want):
    """``_mha_err`` over the (output, α) pair."""
    (e_out, ok_out), (e_alpha, ok_alpha) = (_mha_err(g, w) for g, w in zip(got, want))
    return max(e_out, e_alpha), ok_out and ok_alpha


def _tolerance_share(got, want):
    """The most of |got - want| / (atol + rtol·|want|) over the (output, α)
    pair: the worst element's share of its tolerance (over 1: outside)."""
    return max(((g - w).abs() / (MHA_ATOL + MHA_RTOL * w.abs())).max().item()
               for g, w in zip(got, want))


def _demand_attention_check(mods, calls, additive, additive_plain):
    """The additive attention kernel against its plain version on a Demand
    forward's own attention inputs, one entry per call length L: max abs
    error, the worst element's share of the tolerance, and |enc| and |out|
    at most.  Fails past ``DEMAND_ATTN_MAX_SHARE`` of the tolerance."""
    errs, shares, absmax = {}, {}, {}
    with torch.inference_mode():
        for mod, args in zip(mods, calls):
            got = additive(*args, weight_on=mod.weight_on)
            want = additive_plain(*args, weight_on=mod.weight_on)
            key = f"L={args[0].shape[1]}"
            errs[key], _ = _additive_err(got, want)
            shares[key] = _tolerance_share(got, want)
            absmax[key] = {"enc": args[0].abs().max().item(), "out": want[0].abs().max().item()}
    _require(max(shares.values()) <= DEMAND_ATTN_MAX_SHARE,
             f"additive attention vs plain on Demand forward inputs: {errs}, share of the "
             f"tolerance {shares} (at most {DEMAND_ATTN_MAX_SHARE}), |x| max {absmax}")
    return {"max_abs_err": errs, "tolerance_share": shares, "abs_max": absmax}


def _stfore_batch(n, image_size, seed, windows=2, horizon=None):
    """A windowed SO-fore batch: sales lags ``X [n, windows, 2]`` and, with a
    ``horizon``, targets ``y [n, windows, horizon]``."""
    b = _synthetic_batch(n, image_size, seed)
    del b["ts"]
    rng = np.random.default_rng(seed)
    b["X"] = rng.random((n, windows, 2)).astype(np.float32)
    if horizon:
        b["y"] = rng.random((n, windows, horizon)).astype(np.float32)
    return b


def _attention_modules(model):
    """The CrossAttnRNN decoder's additive attentions, in call order."""
    fusion = model.decoder.fusion
    return [m for m in (fusion.img_attention, fusion.ts_attention,
                        fusion.multimodal_attention) if m is not None]


def _probe_kernel_checks(dev):
    """Phase 19: the probe kernels against their plain versions (and the
    int8 one against ``torch._int_mm``), one launch per call."""
    from visuelle2_tpu_torch.ops.cuda.probe_gemm import (
        bf16_tolerance,
        matmul_bf16,
        matmul_bf16_plain,
        matmul_int8,
        matmul_int8_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.read_reduce import read_reduce, read_reduce_plain
    from visuelle2_tpu_torch.perf import convfloor

    parity = convfloor.parity_check(dev)
    errs = {"bf16": parity["bf16_max_abs_err"], "int8": 0, "read": parity["read_max_abs_err"]}
    by_shape = {"jax_parity_4096x256x64": parity}
    gemm_shapes = dict(convfloor.SHAPES, ragged_10000x128x256=dict(m=10000, k=128, n=256))
    read_shapes = dict(convfloor.SHAPES, other_6144x384=dict(m=6144, k=384, n=64))
    for name, s in gemm_shapes.items():
        xb, wb, xi, wi, _ = convfloor.probe_inputs(device=dev, **s)
        counts = matmul_bf16.launches, matmul_int8.launches
        got, got_i = matmul_bf16(xb, wb), matmul_int8(xi, wi)
        torch.cuda.synchronize()
        _require((matmul_bf16.launches, matmul_int8.launches) == (counts[0] + 1, counts[1] + 1),
                 f"{name}: launch counts did not move by one")
        want = matmul_bf16_plain(xb, wb)
        diff = (got.float() - want.float()).abs()
        _require(bool((diff <= bf16_tolerance(xb, wb, want)).all()),
                 f"{name}: bf16 probe GEMM off by {diff.max().item()}")
        int8_plain = torch.equal(got_i, matmul_int8_plain(xi, wi))
        int8_int_mm = torch.equal(got_i, torch._int_mm(xi, wi))
        _require(int8_plain and int8_int_mm,
                 f"{name}: int8 probe GEMM not exact (plain {int8_plain}, _int_mm {int8_int_mm})")
        errs["bf16"] = max(errs["bf16"], diff.max().item())
        by_shape[name] = {"bf16_max_abs_err": diff.max().item(),
                          "int8_equal_plain": int8_plain, "int8_equal_int_mm": int8_int_mm}
        del xb, wb, xi, wi, got, got_i, want, diff
    for name, s in read_shapes.items():
        xb, _, _, _, _ = convfloor.probe_inputs(device=dev, **s)
        bias = torch.randn(8, 128, device=dev)
        before = read_reduce.launches
        full = read_reduce(xb, bias, full_k=True)
        torch.cuda.synchronize()
        _require(read_reduce.launches == before + 1, f"{name}: read launch count")
        want = read_reduce_plain(xb, bias, full_k=True)
        diff = (full - want).abs()
        _require(bool((diff <= READ_ATOL + READ_RTOL * want.abs()).all()),
                 f"{name}: read partials off by {diff.max().item()}")
        past_128 = diff[:, 128:].max().item()
        shift = (read_reduce(xb, bias) - read_reduce(xb, torch.zeros_like(bias))
                 - bias.repeat(s["m"] // convfloor.TILE_M, 1)).abs().max().item()
        _require(shift <= 1e-5, f"{name}: bias shift off by {shift}")
        errs["read"] = max(errs["read"], diff.max().item())
        by_shape.setdefault(name, {}).update({
            "read_max_abs_err": diff.max().item(), "read_cols_past_128_max_abs_err": past_128,
            "read_cols": s["k"], "bias_shift_max_abs_err": shift})
        del xb, full, want, diff
    return {"max_abs_err": errs, "by_shape": by_shape}


def _host_metrics(model, loader, dev, norm_scalar):
    """WAPE and MAE of ``model`` over ``loader`` recomputed in float64 numpy:
    each batch's forecasts copied to the host, only the masked rows kept."""
    from visuelle2_tpu_torch.eval.forecast import to_device
    from visuelle2_tpu_torch.train.loop import target_and_pred

    gts, preds = [], []
    with torch.inference_mode():
        for batch in loader:
            batch = to_device(batch, dev)
            target, pred = target_and_pred(batch, model(batch)[0])
            keep = batch["mask"].cpu().numpy() > 0
            gts.append(target.double().cpu().numpy()[keep])
            preds.append(pred.double().cpu().numpy()[keep])
    gt, pred = np.concatenate(gts) * norm_scalar, np.concatenate(preds) * norm_scalar
    err = np.abs(gt - pred).sum()
    return {"wape": 100.0 * err / np.abs(gt).sum(), "mae": err / gt.size, "rows": len(gt)}


def _forecast_cli_phase(dev, card, zero_counts, counted, forward_rates, forward_busy_ms):
    """Phase forecast_cli: a full-width synthetic split scored through the
    port's two forecast CLIs on the card (see the module docstring).
    ``counted`` names every kernel wrapper; ``forward_rates`` and
    ``forward_busy_ms`` are phases 6 and 16's forward-only forecasts/s and
    device busy ms a forward, by model."""
    from visuelle2_tpu_torch import native
    from visuelle2_tpu_torch.cli import common, forecast_dl, forecast_transformer
    from visuelle2_tpu_torch.data.pipeline import load_label_dicts
    from visuelle2_tpu_torch.eval.forecast import to_device
    from visuelle2_tpu_torch.models import VocabSizes
    from visuelle2_tpu_torch.utils.seeding import seed_everything

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    runs, checks, launches, rounding = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        path, pixels = _write_cli_split(tmp)
        setup_s = time.perf_counter() - t0
        split = ["--dataset_path", path, "--batch_size", str(B), "--image_size", str(IMAGE)]
        v4_f32 = ["--model", "gated_v4", "--demand", "1", "--output_len", "12", *split]
        v4_argv = v4_f32 + ["--bf16_backbone"]
        dl_argv = ["--new_product", "1", "--bf16_backbone", *split]

        engine = native.shared_engine()

        def run(label, cli, argv, model, per_forward):
            zero_counts()
            out = io.StringIO()
            gathers = []
            submit = engine.submit
            engine.submit = lambda *a: gathers.append(1) or submit(*a)
            t = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    r = cli.main(argv)
            finally:
                del engine.submit
            wall = time.perf_counter() - t
            # Without dedup every batch's images come through the engine;
            # unique-image batches gather in numpy.
            checks[f"{label}: prefetch engine"] = (len(gathers) > 0) == (
                "--dedup_images" in argv)
            counts = {name: w.launches for name, w in counted.items()}
            launches[label] = counts
            expected = {name: per_forward.get(name, 0) * r.forwards for name in counted}
            checks[f"{label}: launches"] = counts == expected
            checks[f"{label}: {CLI_ROWS} forecasts"] = r.num_forecasts == CLI_ROWS
            checks[f"{label}: finite"] = bool(np.isfinite([r.wape, r.mae]).all())
            runs[label] = {
                "argv": [a for a in argv if a != path],
                "wape": r.wape, "mae": r.mae, "num_forecasts": r.num_forecasts,
                "forecasts_per_s": r.forecasts_per_sec,
                "forecasts_per_s_windows": r.forecasts_per_sec_windows,
                "forward_only_forecasts_per_s": forward_rates[model],
                "split_s": r.split_seconds,
                "split_forecasts_per_s": r.num_forecasts / r.split_seconds,
                "gflops_per_sample": r.gflops_per_sample, "peak_device_bytes": r.peak_hbm_bytes,
                "one_pass": r.one_pass, "forwards": r.forwards,
                "launches": counts, "launches_per_forward": {
                    k: v / r.forwards for k, v in counts.items() if v},
                "prefetch_engine_gathers": len(gathers),
                "cli_s": wall, "cli_tail": out.getvalue().strip().splitlines()[-3:]}
            if "--dedup_images" in argv and "--bf16_backbone" in argv:
                # 128 photos a forward in bf16, as phase 6 runs: the share of
                # the scoring pass the device spent idle, from its busy time
                # a forward.
                batches = -(-CLI_ROWS // B)
                runs[label]["device_idle_share_est"] = max(
                    0.0, 1.0 - batches * forward_busy_ms[model] / 1e3 / r.split_seconds)
            return r

        def host_check(label, r, cli, argv, make):
            args = cli.build_parser().parse_args(argv)
            loaders, vocab, norm = common.build_loaders(
                args, demand=True, output_len=12, splits=("test",),
                dedup_eval_images=bool(args.dedup_images), pin_memory=True)
            model = make(args, vocab, device=dev, generator=seed_everything(args.seed))
            host = _host_metrics(model, loaders["test"], dev, norm)
            runs[label]["host_float64"] = host
            # The device's busy time a forward of these batches (profiler),
            # against the forward time score_split measured.
            batches = [to_device(b, dev) for _, b in zip(range(2), loaders["test"])]
            with torch.inference_mode():
                model(batches[0])
                torch.cuda.synchronize()
                with _profile() as prof:
                    for b in batches:
                        model(b)
                    torch.cuda.synchronize()
            busy_ms = _device_us(prof) / 1e3 / len(batches)
            runs[label]["forward_device_busy_ms"] = busy_ms
            runs[label]["forward_idle_share"] = max(
                0.0, 1.0 - busy_ms * r.forecasts_per_sec / (1e3 * B))
            for k in ("wape", "mae"):
                checks[f"{label}: {k} vs host"] = abs(getattr(r, k) - host[k]) <= \
                    METRIC_RTOL * abs(host[k])
            checks[f"{label}: host rows"] = host["rows"] == CLI_ROWS

        residual = {"fused_gated_residual": 2}
        v4 = run("gated_v4", forecast_transformer, v4_argv, "gated_v4", residual)
        host_check("gated_v4", v4, forecast_transformer, v4_argv, forecast_transformer.make_model)
        v4_full = run("gated_v4 --dedup_images 0", forecast_transformer,
                      v4_argv + ["--dedup_images", "0"], "gated_v4", residual)
        v4_batch = run("gated_v4 --one_pass 0", forecast_transformer,
                       v4_argv + ["--one_pass", "0"], "gated_v4", residual)
        f32 = run("gated_v4 f32", forecast_transformer, v4_f32, "gated_v4", residual)
        f32_full = run("gated_v4 f32 --dedup_images 0", forecast_transformer,
                       v4_f32 + ["--dedup_images", "0"], "gated_v4", residual)
        checks["gated_v4: auto took one-pass"] = v4.one_pass and not v4_batch.one_pass
        for label, a, b in (("one_pass 1 vs 0", v4, v4_batch),
                            ("f32 dedup 1 vs 0", f32, f32_full)):
            checks[f"{label}: wape"] = abs(a.wape - b.wape) < SAME_WAPE_ATOL
            checks[f"{label}: mae"] = abs(a.mae - b.mae) < SAME_MAE_ATOL
        for k in ("wape", "mae"):
            checks[f"bf16 dedup 1 vs 0: {k}"] = abs(getattr(v4, k) - getattr(v4_full, k)) <= \
                BF16_SAME_RTOL * abs(getattr(v4_full, k))
        # Why bf16 dedup is held to one bf16 ulp: the pooled features of the
        # same photos alone (as dedup encodes them) and among 128 (as the
        # full batch does).
        vocab = VocabSizes.from_dicts(*load_label_dicts(path))
        photos = torch.from_numpy(pixels[:B // CLI_ROWS_PER_IMAGE]).to(dev)
        for label, argv in (("bf16", v4_argv), ("f32", v4_f32)):
            args = forecast_transformer.build_parser().parse_args(argv)
            encoder = forecast_transformer.make_model(
                args, vocab, device=dev, generator=seed_everything(args.seed)).image_encoder
            with torch.inference_mode():
                alone = encoder(photos)
                among = encoder(photos.repeat(CLI_ROWS_PER_IMAGE, 1, 1, 1))[:len(photos)]
            rounding[label] = {"max_abs_diff": (alone - among).abs().max().item(),
                               "absmax": alone.abs().max().item()}
        demand = run("cross_attn_rnn_demand", forecast_dl, dl_argv, "cross_attn_rnn_demand",
                     {"fused_additive_attention": 36})
        host_check("cross_attn_rnn_demand", demand, forecast_dl, dl_argv,
                   lambda args, vocab, **kw: forecast_dl.make_model(args, vocab, 12, demand=True,
                                                                     **kw))
    _emit({"phase": "forecast_cli", **card, "rows": CLI_ROWS,
           "rows_per_image": CLI_ROWS_PER_IMAGE, "image": IMAGE, "batch": B,
           "dataset_setup_s": setup_s,
           "timing": "forecasts_per_s: score_split's forward rate, CUDA events over "
                     "10 distinct (rolled) device batches after a warm-up, the median of "
                     "3 windows; split_forecasts_per_s: rows over the host-clock seconds "
                     "of the scoring pass (batch assembly, copies, forwards, one sync); "
                     "forward_only_forecasts_per_s: phase 6 / 16 (128 photos a forward)",
           "peak_device_bytes": "torch.cuda.max_memory_allocated over one batch's forward",
           "metric_rtol": METRIC_RTOL, "same_wape_atol": SAME_WAPE_ATOL,
           "same_mae_atol": SAME_MAE_ATOL, "bf16_same_rtol": BF16_SAME_RTOL,
           "pooled_features_32_alone_vs_among_128": rounding, "runs": runs,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"forecast_cli: {name}: {json.dumps(runs)}")
    return {name: sum(c[name] for c in launches.values()) for name in counted}


def _train_kernel_phase(dev, card, kernel, plain, mha, mha_plain, gcd_block_mask):
    """Phase train_kernel: ``fused_gated_residual`` and ``fused_gated_mha``
    under autograd on the card (see the module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).requires_grad_()

    errs, launches, checks = {}, {}, {}

    def compare(key, wrapper, fn, plain_fn, inputs, out_tol):
        before = wrapper.launches
        out = fn()
        forward = wrapper.launches - before
        cot = torch.randn(out.shape, device=dev, generator=gen)
        grads = torch.autograd.grad(out, inputs, cot)
        torch.cuda.synchronize()
        backward = wrapper.launches - before - forward
        out_p = plain_fn()
        grads_p = torch.autograd.grad(out_p, inputs, cot)
        e = {"out": (out - out_p).abs().max().item()}
        e.update({f"d{i}": (g - w).abs().max().item()
                  for i, (g, w) in enumerate(zip(grads, grads_p))})
        errs[key], launches[key] = e, {"forward": forward, "backward": backward}
        checks[f"{key}: out"] = out_tol(out, out_p)
        checks[f"{key}: grads"] = max(v for k, v in e.items() if k != "out") <= TRAIN_KERNEL_ATOL
        checks[f"{key}: one launch a forward, none in the backward"] = (forward, backward) == (1, 0)
        checks[f"{key}: autograd function"] = out.grad_fn is not None and \
            type(out.grad_fn).__name__.startswith("_Gated")
        return max(e.values())

    worst = {"fused_gated_residual": 0.0, "fused_gated_mha": 0.0}
    for Bk, D, C in ((B, 32, 128), (37, 48, 96)):
        for residual in (True, False):
            ins = [randn(Bk, D), randn(Bk, C), randn(D, D, scale=0.1), randn(C, D, scale=0.1),
                   randn(D)]
            worst["fused_gated_residual"] = max(worst["fused_gated_residual"], compare(f"gated_residual {Bk}x{D}x{C}/residual={residual}", kernel,
                    lambda: kernel(*ins, residual=residual),
                    lambda: plain(*ins, residual=residual), ins,
                    lambda a, b: (a - b).abs().max().item() <= KERNEL_ATOL))
    for variant, (Bk, Lq, Lk, D, heads), masked in (
            ("head", (B, 52, 52, 64, 4), True), ("pure", (B, 1, 52, 64, 4), False),
            ("head", (37, 52, 52, 48, 4), True)):
        G = D // heads if variant == "head" else D
        query = randn(Bk, Lq, D)
        # The trend encoder attends to itself; the decoder to the memory.
        key = query if variant == "head" else randn(Bk, Lk, D)
        mask = (gcd_block_mask(Lk, 12, device=dev) if masked
                else torch.zeros(Lq, Lk, device=dev))
        weights = [t for w in ((D, D),) * 3 + ((G, G), (D, D))
                   for t in (randn(*w, scale=0.1), randn(w[1], scale=0.1))]
        args = [query, key, key, mask, *weights]
        inputs = [query] + ([] if key is query else [key]) + weights
        worst["fused_gated_mha"] = max(worst["fused_gated_mha"], compare(
            f"gated_mha {variant} {Bk}x{Lq}x{Lk}x{D}/{heads}", mha,
            lambda: mha(*args, num_heads=heads, variant=variant),
            lambda: mha_plain(*args, num_heads=heads, variant=variant), inputs,
            lambda a, b: _mha_err(a, b)[1]))
    # Forward and backward device µs at the main-path shape: the kernel
    # under its autograd function against autograd of the plain version.
    ins = [randn(B, 32), randn(B, 128), randn(32, 32, scale=0.1), randn(128, 32, scale=0.1),
           randn(32)]
    cot = torch.randn(B, 32, device=dev, generator=gen)
    device_ms, call_ms = _call_times({
        "kernel": lambda: torch.autograd.grad(kernel(*ins), ins, cot),
        "plain": lambda: torch.autograd.grad(plain(*ins), ins, cot),
        "kernel_forward_only": lambda: kernel(*(t.detach() for t in ins))}, n_calls=200)
    times = {f"{k}_device_us": 1e3 * v for k, v in device_ms.items()}
    times.update({f"{k}_call_us": 1e3 * v for k, v in call_ms.items()})
    _emit({"phase": "train_kernel", **card, "max_abs_err": errs, "launches": launches,
           "gated_residual_forward_backward_main_path": times,
           "grad_atol": TRAIN_KERNEL_ATOL, "residual_out_atol": KERNEL_ATOL,
           "mha_out_atol": MHA_ATOL, "mha_out_rtol": MHA_RTOL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"train_kernel: {name}: {json.dumps(errs)}")
    return worst


def _noise_elements(grads):
    """Per parameter, the elements whose gradient at some step is float
    noise (a key bias under softmax, whose true gradient is zero):
    Adafactor's sign-like steps move them in directions set by rounding."""
    mask = {}
    for g in grads:
        total = torch.sqrt(sum(v.double().square().sum() for v in g.values()))
        for n, v in g.items():
            quiet = v.abs().ravel() <= TRAIN_NOISE_SHARE * total
            mask[n] = mask[n] | quiet if n in mask else quiet
    return mask


@contextlib.contextmanager
def _relu_inputs(model):
    """Collects, in forward order, the ReLU inputs of the backbone's
    trainable blocks (bn1's and bn2's outputs, and each block's out + sc) on
    the CPU; a list of tensors per forward, appended to the yielded list."""
    backbone = next(m for n, m in model.named_modules() if n.endswith("backbone"))
    seen, hooks = [], []
    keep = lambda t: seen.append(t.detach().float().cpu())
    for name in backbone.block_names:
        block = getattr(backbone, name)
        if not any(p.requires_grad for p in block.parameters()):
            continue
        parts = {}
        for bn in (block.bn1, block.bn2):
            hooks.append(bn.register_forward_hook(lambda m, a, o: keep(o)))
        hooks.append(block.bn3.register_forward_hook(
            lambda m, a, o, parts=parts: parts.__setitem__("out", o.detach())))
        if block.ds_bn is not None:
            hooks.append(block.ds_bn.register_forward_hook(
                lambda m, a, o, parts=parts: parts.__setitem__("sc", o.detach())))
        hooks.append(block.register_forward_hook(
            lambda m, a, o, parts=parts: keep(parts["out"] + parts.get("sc", a[0].detach()))))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def _train_run(model, batches, wrapper, grad_clip, relus=False):
    """``model`` trained on ``batches`` through ``Trainer``, f32, dropout
    off: the losses, gradients, final parameters and buffers, the wrapper's
    launches and, with ``relus``, the ReLU inputs of the trainable backbone
    blocks at each step."""
    from visuelle2_tpu_torch.ops import dropout
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    trainer = Trainer(model, TrainConfig(grad_clip=grad_clip, learning_rate=TRAIN_LR))
    state = trainer.init_state()
    before, losses, grads, seen = wrapper.launches, [], [], []
    with dropout.disabled():
        for b in batches:
            with _relu_inputs(model) if relus else contextlib.nullcontext([]) as step_relus:
                state, m = trainer.train_step(
                    state, {k: torch.from_numpy(v) for k, v in b.items()})
            seen.append(step_relus)
            losses.append(float(m["loss"]))
            grads.append({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters() if p.grad is not None})
    return {"losses": losses, "first_grads": grads[0], "grads": grads, "relus": seen,
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()},
            "launches": wrapper.launches - before}


def _card_and_cpu_models(dev, name, small):
    """``name`` built from one seed on the card, a loader of CPU copies of
    it, and its initial parameters."""
    from visuelle2_tpu_torch.models import build

    on_card = build(name, device=dev, generator=torch.Generator().manual_seed(5), **small)
    weights = {k: v.detach().cpu().clone() for k, v in on_card.state_dict().items()}

    def cpu_copy():
        model = build(name, device="cpu", **small)
        model.load_state_dict(weights)
        return model

    init = {n: p.detach().clone() for n, p in cpu_copy().named_parameters()}
    return on_card, cpu_copy, init


def _card_vs_cpu_training(dev, name, small, batches, wrapper, per_step, grad_clip):
    """A small model of ``name`` trained on ``batches`` on the card and on
    the CPU from the same weights, f32, dropout off: the comparison's
    numbers, and its checks by name.  ``wrapper`` must launch ``per_step``
    times a step on the card and never on the CPU."""
    on_card, cpu_copy, init = _card_and_cpu_models(dev, name, small)
    runs = {"card": _train_run(on_card, batches, wrapper, grad_clip),
            "cpu": _train_run(cpu_copy(), batches, wrapper, grad_clip)}
    return _compare_training(runs, init, len(batches), per_step)


def _screened_card_vs_cpu_training(dev, name, small, make_batches, wrapper, per_step):
    """``_card_vs_cpu_training`` (unclipped) on the first candidate batches
    (``make_batches(k)``, k = 0, 1, ...) that pass the ReLU screen, decided
    on the CPU run alone before the card runs: every ReLU input of the
    trainable backbone blocks at least ``KINK_ATOL`` from zero at every
    step.  Nearer zero, the card's rounding can give it the other sign: the
    devices then take the loss's two one-sided derivatives, and Adafactor's
    early, sign-like updates carry the difference into every later step.
    The screen's readings (each candidate's least |ReLU input| a step) go
    into the result."""
    on_card, cpu_copy, init = _card_and_cpu_models(dev, name, small)
    readings = []
    for k in range(KINK_CANDIDATES):
        batches = make_batches(k)
        cpu_run = _train_run(cpu_copy(), batches, wrapper, None, relus=True)
        least = [min(x.abs().min().item() for x in step) for step in cpu_run["relus"]]
        readings.append(least)
        if min(least) > KINK_ATOL:
            break
    else:
        raise RuntimeError(f"chip_smoke: {name}: no candidate batches passed the ReLU "
                           f"screen: {readings}")
    runs = {"card": _train_run(on_card, batches, wrapper, None), "cpu": cpu_run}
    result, checks = _compare_training(runs, init, len(batches), per_step)
    result.update(batch_candidate=k, relu_screen_least_abs_by_candidate=readings)
    return result, checks


def _movement(init, params, reference, quiet_elements, lr_sum):
    """Each trainable parameter's movement from ``init`` in ``params``
    against ``reference``: the least cosine and the largest relative norm
    difference over the parameters, per parameter and never elementwise
    (Adafactor's first update is close to sign(g)); the frozen stages that
    moved; and the noise elements (``quiet_elements``) held apart, each
    parameter's to its noise steps' size (``lr_sum`` · max(rms(p), 1e-3),
    an update of RMS at most 1): ``{name: [noise elements, elements, norm,
    reference norm]}`` and the largest share of that bound."""
    from visuelle2_tpu_torch.train.optim import is_frozen

    worst_cos, worst_norm, frozen_moved, noise, noise_share = 1.0, 0.0, [], {}, 0.0
    for n, p0 in init.items():
        dc, dp = (params[n] - p0).ravel(), (reference[n] - p0).ravel()
        if is_frozen(n):
            if dc.any() or dp.any():
                frozen_moved.append(n)
            continue
        quiet = quiet_elements.get(n)
        if quiet is not None and quiet.any():
            bound = lr_sum * max(1e-3, p0.square().mean().sqrt().item()) * dc.numel() ** 0.5
            norms = [dc[quiet].norm().item(), dp[quiet].norm().item()]
            noise[n] = [int(quiet.sum()), quiet.numel(), *norms]
            noise_share = max(noise_share, max(norms) / bound)
            dc, dp = dc[~quiet], dp[~quiet]
        nc, np_ = dc.norm().item(), dp.norm().item()
        if nc == 0.0 and np_ == 0.0:
            continue
        if not (nc and np_):  # one side moved, the other did not
            worst_cos, worst_norm = 0.0, float("inf")
            continue
        worst_cos = min(worst_cos, float(torch.dot(dc, dp) / (nc * np_)))
        worst_norm = max(worst_norm, abs(nc - np_) / np_)
    return worst_cos, worst_norm, frozen_moved, noise, noise_share


def _compare_training(runs, init, n_steps, per_step):
    """``_card_vs_cpu_training``'s numbers and checks for one pair of runs."""
    card_run, cpu_run = runs["card"], runs["cpu"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(card_run["losses"], cpu_run["losses"])]
    grad_share = max(((card_run["first_grads"][n] - g).abs()
                      / (TRAIN_GRAD_TOL + TRAIN_GRAD_TOL * g.abs())).max().item()
                     for n, g in cpu_run["first_grads"].items())
    grad_err = max((card_run["first_grads"][n] - g).abs().max().item()
                   for n, g in cpu_run["first_grads"].items())
    # The three parameters furthest from their first-step tolerance:
    # [share, max |error|, max |CPU gradient|].
    grad_worst = sorted(([((card_run["first_grads"][n] - g).abs()
                           / (TRAIN_GRAD_TOL + TRAIN_GRAD_TOL * g.abs())).max().item(),
                          (card_run["first_grads"][n] - g).abs().max().item(),
                          g.abs().max().item(), n]
                         for n, g in cpu_run["first_grads"].items()), reverse=True)[:3]
    stats_share = max([((card_run["buffers"][n] - b).abs()
                        / (TRAIN_STATS_TOL + TRAIN_STATS_TOL * b.abs())).max().item()
                       for n, b in cpu_run["buffers"].items() if b.is_floating_point()],
                      default=0.0)
    worst_cos, worst_norm, frozen_moved, noise, noise_share = _movement(
        init, card_run["params"], cpu_run["params"], _noise_elements(cpu_run["grads"]),
        n_steps * TRAIN_LR)
    checks = {
        "losses": max(loss_rel) <= TRAIN_LOSS_RTOL,
        "first-step gradients": grad_share <= 1.0,
        "movement cosine": worst_cos >= TRAIN_COS_FLOOR,
        "movement norm": worst_norm <= TRAIN_NORM_RTOL,
        "BatchNorm statistics": stats_share <= 1.0,
        "frozen stages unmoved": not frozen_moved,
        "noise elements": noise_share <= 1.01,
        "launches": (card_run["launches"], cpu_run["launches"]) == (per_step * n_steps, 0)}
    result = {"steps": n_steps, "losses": {k: v["losses"] for k, v in runs.items()},
              "loss_rel_diff": loss_rel, "first_grad_max_abs_err": grad_err,
              "first_grad_tolerance_share": grad_share, "first_grad_worst": grad_worst,
              "movement_min_cos": worst_cos,
              "movement_max_norm_rel_diff": worst_norm, "stats_tolerance_share": stats_share,
              # parameter: [noise elements, elements, card norm, CPU norm]
              "noise_elements": noise, "noise_bound_share": noise_share,
              "launches": {k: v["launches"] for k, v in runs.items()},
              "launches_per_step_on_card": per_step}
    return result, checks


TRAIN_PARITY_TOL = {"loss_rtol": TRAIN_LOSS_RTOL, "grad_atol_rtol": TRAIN_GRAD_TOL,
                    "cos_floor": TRAIN_COS_FLOOR, "norm_rtol": TRAIN_NORM_RTOL,
                    "noise_share": TRAIN_NOISE_SHARE, "stats_atol_rtol": TRAIN_STATS_TOL}


def _train_parity_phase(dev, card, kernel):
    """Phase train_parity: a small gated_v4 trained on the card against the
    same model on the CPU (see the module docstring)."""
    from visuelle2_tpu_torch.models import VocabSizes

    small = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126), embedding_dim=16,
                 hidden_dim=16, output_len=12)
    batches = [_synthetic_batch(8, 64, seed=60 + i) for i in range(TRAIN_PARITY_STEPS)]
    result, checks = _card_vs_cpu_training(dev, "gated_v4", small, batches, kernel, 2, 0.5)
    _emit({"phase": "train_parity", **card, "model": "gated_v4", "batch": 8, "image": 64,
           "embedding_dim": 16, "hidden_dim": 16, "learning_rate": TRAIN_LR, **result,
           "tol": TRAIN_PARITY_TOL, "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"train_parity: {name}")


def _train_additive_phase(dev, card, additive, additive_plain, gru_kernel, gru_plain):
    """Phase train_additive: ``fused_additive_attention`` and
    ``fused_gru_sequence`` under their autograd functions on the card against
    autograd of their plain versions (see the module docstring).  Returns
    each kernel's worst error and its forward-and-backward times."""
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).requires_grad_()

    errs, launches, checks, kernels_seen = {}, {}, {}, {}

    def compare(key, wrapper, fn, plain_fn, inputs, atol, rtol, names):
        before = wrapper.launches
        outs = fn()
        forward = wrapper.launches - before
        cots = [torch.randn(o.shape, device=dev, generator=gen) for o in outs]
        grads = torch.autograd.grad(outs, inputs, cots)
        torch.cuda.synchronize()
        backward = wrapper.launches - before - forward
        outs_p = plain_fn()
        grads_p = torch.autograd.grad(outs_p, inputs, cots)
        e = {f"out{i}": (o - w).abs().max().item() for i, (o, w) in enumerate(zip(outs, outs_p))}
        e.update({f"d_{n}": (g - w).abs().max().item()
                  for n, g, w in zip(names, grads, grads_p)})
        errs[key], launches[key] = e, {"forward": forward, "backward": backward}
        pairs = list(zip(outs, outs_p)) + list(zip(grads, grads_p))
        checks[f"{key}: within atol {atol} + rtol {rtol}"] = all(
            bool(((a - b).abs() <= atol + rtol * b.abs()).all()) for a, b in pairs)
        checks[f"{key}: one call a forward, none in the backward"] = (forward, backward) == (1, 0)
        checks[f"{key}: autograd function"] = type(outs[0].grad_fn).__name__ in (
            "_AdditiveAttentionBackward", "_GRUSequenceBackward")
        return max(e.values())

    worst = {"fused_additive_attention": 0.0, "fused_gru_sequence": 0.0}
    additive_names = ("enc", "dec", "we", "wd", "v", "vb")
    demand_inputs = {}
    for Bk, L, De, Dd, A in ((B, 100, 512, 512, 512), (B, 52, 512, 512, 512),
                             (B, 4, 512, 512, 512), (37, 13, 48, 40, 24)):
        ins = [randn(Bk, L, De), randn(Bk, Dd), randn(De, A, scale=De ** -0.5),
               randn(Dd, A, scale=Dd ** -0.5), randn(A, 1, scale=A ** -0.5), randn(1)]
        for weight_on in ("inputs", "projected"):
            key = f"additive {Bk}x{L}x{De}x{Dd}x{A}/{weight_on}"
            worst["fused_additive_attention"] = max(worst["fused_additive_attention"], compare(
                key, additive, lambda: additive(*ins, weight_on=weight_on),
                lambda: additive_plain(*ins, weight_on=weight_on), ins, MHA_ATOL, MHA_RTOL,
                additive_names))
            if Bk == B and weight_on == "projected":  # Demand's attentions
                demand_inputs[f"L={L}"] = ins
                # The kernels a forward and backward launch, by the profiler.
                cot = [torch.randn(Bk, L, A, device=dev, generator=gen),
                       torch.randn(Bk, L, device=dev, generator=gen)]
                per_kernel = _profiled_kernels_us(lambda: torch.autograd.grad(
                    additive(*ins, weight_on="projected"), ins, cot))
                kernels_seen[f"L={L}"] = _kernels_per_call(
                    {name: v for name, v in per_kernel.items()
                     if any(k in name for k in ADDITIVE_KERNEL_NAMES)})
                checks[f"{key}: 2 additive kernels a forward and backward"] = \
                    kernels_seen[f"L={L}"] == ADDITIVE_MAX_LAUNCHES
    Bg, Tg, Ig, Hg = B, 52, 3, 512
    bound = Hg ** -0.5
    x = torch.rand(Bg, Tg, Ig, device=dev, generator=gen).requires_grad_()
    w = [((torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * bound).requires_grad_()
         for shape in ((Ig, 3 * Hg), (Hg, 3 * Hg), (3 * Hg,), (3 * Hg,))]
    h0 = randn(Bg, Hg, scale=0.5)
    gru_ins = [x, *w, h0]
    worst["fused_gru_sequence"] = compare(
        f"gru {Bg}x{Tg}x{Ig}x{Hg}", gru_kernel, lambda: gru_kernel(*gru_ins),
        lambda: gru_plain(*gru_ins), gru_ins, GRU_ATOL_FULL, 0.0,
        ("x", "w_i", "w_h", "b_i", "b_h", "h0"))
    # Forward and backward device µs: each kernel under its autograd function
    # against autograd of its plain version, at the Demand shapes.
    times = {}
    for label, ins in demand_inputs.items():
        cot = [torch.randn(t.shape, device=dev, generator=gen)
               for t in additive_plain(*ins, weight_on="projected")]
        device_ms, call_ms = _call_times({
            "kernel": lambda: torch.autograd.grad(additive(*ins, weight_on="projected"), ins,
                                                  cot),
            "plain": lambda: torch.autograd.grad(additive_plain(*ins, weight_on="projected"),
                                                 ins, cot)}, n_calls=20)
        times[f"additive {label}"] = {
            **{f"{k}_device_us": 1e3 * v for k, v in device_ms.items()},
            **{f"{k}_call_us": 1e3 * v for k, v in call_ms.items()}}
    trend_ins = [x.detach(), *w]  # the trend GRU: no h0, x needs no gradient
    cot = [torch.randn(t.shape, device=dev, generator=gen) for t in gru_plain(*trend_ins)]
    device_ms, call_ms = _call_times({
        "kernel": lambda: torch.autograd.grad(gru_kernel(*trend_ins), w, cot),
        "plain": lambda: torch.autograd.grad(gru_plain(*trend_ins), w, cot)}, n_calls=5)
    times["gru trend"] = {**{f"{k}_device_us": 1e3 * v for k, v in device_ms.items()},
                          **{f"{k}_call_us": 1e3 * v for k, v in call_ms.items()}}
    _emit({"phase": "train_additive", **card, "max_abs_err": errs, "launches": launches,
           "additive_kernels_a_forward_and_backward": kernels_seen,
           "forward_backward_times": times,
           "additive_atol": MHA_ATOL, "additive_rtol": MHA_RTOL, "gru_atol": GRU_ATOL_FULL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"train_additive: {name}: {json.dumps(errs)}")
    return worst, times


def _train_demand_parity_phase(dev, card, additive):
    """Phase train_demand_parity: small CrossAttnRNN models trained on the
    card against the same models on the CPU (see the module docstring)."""
    from visuelle2_tpu_torch.models import VocabSizes

    small = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126), attention_dim=16,
                 embedding_dim=16, hidden_dim=16, use_teacher_forcing=True,
                 teacher_forcing_ratio=1.0)
    out, failed = {}, []
    for name, extra, per_step in (
            ("cross_attn_rnn_demand", {}, 36),
            ("cross_attn_rnn_21", {"use_teacher_forcing": None, "teacher_forcing_ratio": None},
             3),
            ("cross_attn_rnn_210", {"out_len": 10}, 30)):
        horizon = extra.get("out_len", 1)
        if name == "cross_attn_rnn_demand":
            batches = lambda k: [_synthetic_batch(PARITY_IMAGES, 64, seed=70 + 10 * k + i)
                                 for i in range(TRAIN_PARITY_STEPS)]
        else:
            batches = lambda k, horizon=horizon: [
                _stfore_batch(PARITY_IMAGES, 64, seed=70 + 10 * k + i, horizon=horizon)
                for i in range(TRAIN_PARITY_STEPS)]
        dims = {k: v for k, v in {**small, **extra}.items() if v is not None}
        out[name], checks = _screened_card_vs_cpu_training(dev, name, dims, batches,
                                                           additive, per_step)
        out[name]["teacher_forcing_ratio"] = dims.get("teacher_forcing_ratio")
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    _emit({"phase": "train_demand_parity", **card, "image": 64, "image_arch": "tiny",
           "embedding_dim": 16, "attention_dim": 16, "hidden_dim": 16,
           "images_a_batch": PARITY_IMAGES, "learning_rate": TRAIN_LR, "grad_clip": None,
           "relu_screen_atol": KINK_ATOL, "models": out, "tol": TRAIN_PARITY_TOL,
           "failed": failed})
    _require(not failed, f"train_demand_parity: {failed}")
    return {name: r["launches"]["card"] / r["steps"] for name, r in out.items()}


def _train_step_times(trainer, state, batches, n_windows):
    """ms per train step: CUDA events over the distinct ``batches``, the
    median of ``n_windows`` windows after two warm-up steps; and the peak
    device memory of one step."""
    cycle = itertools.cycle(batches)
    for _ in range(2):
        trainer.train_step(state, next(cycle))
    windows = [_cuda_ms(lambda: trainer.train_step(state, next(cycle)), len(batches))
               for _ in range(n_windows)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    return float(np.median(windows)), windows, torch.cuda.max_memory_allocated()


def _write_cli_split(tmp):
    """The forecast CLIs' split in ``tmp``: ``CLI_ROWS`` test rows, no train
    rows, ``CLI_ROWS_PER_IMAGE`` rows a photo, the image store's cache
    written from seeded numpy pixels (no JPEG, no PIL).  Returns its path
    and the photos' pixels."""
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.pipeline import load_visuelle2
    from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset

    path = make_synthetic_dataset(tmp, num_train=0, num_test=CLI_ROWS, seed=0,
                                  write_images=False, rows_per_image=CLI_ROWS_PER_IMAGE)
    paths = load_visuelle2(path, "test", demand=True, output_len=12).image_paths
    unique, row_to_img = ImageStore.unique_paths(paths)
    pixels = np.random.default_rng(0).integers(0, 256, (len(unique), IMAGE, IMAGE, 3),
                                               dtype=np.uint8)
    ImageStore(pixels, row_to_img).write_cache(
        ImageStore.cache_path(path, "test", IMAGE), paths)
    return path, pixels


def _write_train_split(tmp):
    """The train phases' synthetic split in ``tmp``: 512 train rows and the
    forecast CLIs' 1,000 test rows, 4 rows a photo, the image store's cache
    written from seeded numpy pixels (no JPEG).  Returns its path."""
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.pipeline import load_visuelle2
    from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset

    path = make_synthetic_dataset(os.path.join(tmp, "d"), num_train=TRAIN_ROWS,
                                  num_test=CLI_ROWS, seed=0, write_images=False,
                                  rows_per_image=CLI_ROWS_PER_IMAGE)
    for split in ("train", "test"):
        paths = load_visuelle2(path, split, demand=True, output_len=12).image_paths
        unique, row_to_img = ImageStore.unique_paths(paths)
        pixels = np.random.default_rng(1 if split == "train" else 0).integers(
            0, 256, (len(unique), IMAGE, IMAGE, 3), dtype=np.uint8)
        ImageStore(pixels, row_to_img).write_cache(
            ImageStore.cache_path(path, split, IMAGE), paths)
    return path


def _measure_trainer(trainer, state, batches, backbone, zero_counts, kernel):
    """A full-width train step through ``Trainer`` on the distinct device
    ``batches``: ms a step (the median of ``TRAIN_WINDOWS`` windows), peak
    memory, ``kernel``'s launches a step and an eval forward, host syncs in
    a step, the optimizer's device and host ms, device busy ms and idle
    share, top operators and kernels, and the same step with ``backbone``
    rematerialized.  Returns the numbers and the profile."""
    zero_counts()
    step_ms, windows, peak = _train_step_times(trainer, state, batches, TRAIN_WINDOWS)
    steps = 2 + TRAIN_WINDOWS * len(batches) + 1
    launches_per_step = kernel.launches / steps
    # The step must not wait on the device: no host sync in forward,
    # backward or update (fit reads the losses once an epoch).
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step(state, batches[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sorted({str(w.message)[:200] for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message)})
    zero_counts()
    trainer.eval_step(state, batches[0])
    launches_per_eval = kernel.launches
    losses = [float(trainer.train_step(state, b)[1]["loss"]) for b in batches[:2]]
    opt_ms = _cuda_ms(state.optimizer.step, 5)
    host_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.optimizer.step()
        host_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with _profile() as prof:
        for b in batches[:2]:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
    busy_ms = _device_us(prof) / 2e3
    by_op = sorted(((e.key, e.self_device_time_total / 2e3) for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                   key=lambda kv: -kv[1])[:12]
    by_kernel = sorted(([e.key[:100], e.self_device_time_total / 2e3, e.count // 2]
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                       key=lambda kv: -kv[1])[:10]
    backbone.remat = True
    remat_ms, remat_windows, remat_peak = _train_step_times(trainer, state, batches, 1)
    backbone.remat = False
    return {
        "batch": B, "image": IMAGE, "learning_rate": TRAIN_LR, "losses": losses,
        "train_step_ms": step_ms, "train_step_ms_windows": windows,
        "samples_per_s": B / (step_ms / 1e3), "peak_device_bytes": peak,
        "optimizer_step_ms": opt_ms, "optimizer_step_host_ms": 1e3 * float(np.median(host_s)),
        "trainable_tensors": sum(1 for p in trainer.model.parameters() if p.requires_grad),
        "host_syncs_in_a_step": syncs, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "device_ms_by_op_per_step": dict(by_op), "top_kernels_ms_launches_per_step": by_kernel,
        "remat": {"train_step_ms": remat_ms, "windows": remat_windows,
                  "peak_device_bytes": remat_peak},
        "launches": {"per_train_step": launches_per_step,
                     "per_eval_forward": launches_per_eval}}, prof


def _cli_round_trip(out, tmp, train_main, forecast_main, argv, forecast_argv, name,
                    per_forward, zero_counts, counted, trace_dir=None):
    """A train CLI on the train phases' split (``argv`` without
    ``--ckpt_dir``; its checkpoints under ``tmp``): whole, and cut by a
    SIGTERM after
    ``TRAIN_PREEMPT_AFTER`` steps and rerun with ``--resume_from auto``; then
    the forecast CLI (``forecast_argv`` plus ``--ckpt_path``) on the best
    epoch.  The counted kernel ``name`` must launch ``per_forward`` times a
    train step and an eval forward, every other counted kernel never.  Fills ``out`` and
    returns the checks by name."""
    import signal

    from visuelle2_tpu_torch.train import loop
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager

    kernel = counted[name]
    steps_per_epoch = TRAIN_ROWS // B
    evals_per_epoch = -(-CLI_ROWS // B)

    def train(label, ckpt_dir, *extra):
        zero_counts()
        text = io.StringIO()
        t = time.perf_counter()
        code = 0
        with contextlib.redirect_stdout(text):
            try:
                train_main(argv + ["--ckpt_dir", ckpt_dir, *extra])
            except SystemExit as e:
                code = e.code
        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
            log = [json.loads(line) for line in f]
        out[label] = {"exit": code, "wall_s": time.perf_counter() - t,
                      "launches": {n: w.launches for n, w in counted.items()},
                      "tail": text.getvalue().strip().splitlines()[-2:]}
        return code, log

    full_dir, cut_dir = os.path.join(tmp, "full"), os.path.join(tmp, "cut")
    code, full_log = train("uninterrupted", full_dir,
                           *(["--trace_dir", trace_dir] if trace_dir else []))
    epochs = [r for r in full_log if "val_wWAPE" in r]
    ck = CheckpointManager(full_dir, read_only=True)
    last = torch.load(os.path.join(full_dir, "last", "state.pt"), map_location="cpu",
                      weights_only=True)
    want_steps = TRAIN_EPOCHS * steps_per_epoch
    want_launches = per_forward * (want_steps + TRAIN_EPOCHS * evals_per_epoch)
    checks = {
        "uninterrupted: exit 0": code == 0,
        "uninterrupted: epochs logged": [r["epoch"] for r in epochs] == list(
            range(TRAIN_EPOCHS)),
        "uninterrupted: finite losses": all(np.isfinite(r["train_loss"]) for r in epochs),
        "uninterrupted: steps": last["step"] == want_steps and last["fit_epoch"] ==
        TRAIN_EPOCHS,
        "uninterrupted: slots": os.path.isfile(os.path.join(full_dir, "hparams.json"))
        and ck.best_model_path is not None and os.path.isdir(os.path.join(full_dir, "last")),
        "uninterrupted: launches": out["uninterrupted"]["launches"] == {
            n: (want_launches if n == name else 0) for n in counted}}
    if trace_dir:
        checks["uninterrupted: one trace of step 2"] = [
            f.endswith(".json") for f in os.listdir(trace_dir)] == [True]

    # The same command cut by a SIGTERM at a step boundary of epoch 0.
    original = loop.Trainer.train_step
    done = []

    def train_step(self, state, batch):
        result = original(self, state, batch)
        done.append(1)
        if len(done) == TRAIN_PREEMPT_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)
        return result

    loop.Trainer.train_step = train_step
    try:
        code, cut_log = train("preempted", cut_dir)
    finally:
        loop.Trainer.train_step = original
    checks["preempted: exit 143"] = code == 143
    # metrics.jsonl holds numbers: the flag is logged as 1.0.
    checks["preempted: saved at the step boundary"] = bool(cut_log[-1].get("preempted")) \
        and cut_log[-1]["steps_into_epoch"] == TRAIN_PREEMPT_AFTER
    code, resumed_log = train("resumed", cut_dir, "--resume_from", "auto")
    resumed_epochs = [r for r in resumed_log if "val_wWAPE" in r]
    resumed_last = torch.load(os.path.join(cut_dir, "last", "state.pt"),
                              map_location="cpu", weights_only=True)
    resumed_steps = want_steps - TRAIN_PREEMPT_AFTER
    checks.update({
        "resumed: exit 0": code == 0,
        "resumed: epochs": [r["epoch"] for r in resumed_epochs] == list(range(TRAIN_EPOCHS)),
        "resumed: same step count": resumed_last["step"] == want_steps,
        "resumed: only the remaining steps": out["resumed"]["launches"][name]
        == per_forward * (resumed_steps + TRAIN_EPOCHS * evals_per_epoch)})
    out["resumed"]["gap_final_val_wWAPE"] = resumed_epochs[-1]["val_wWAPE"] - \
        epochs[-1]["val_wWAPE"]

    # The best epoch scored through the forecast CLI's --ckpt_path, no dim flags.
    best = ck.best_model_path
    best_epoch = int(os.path.basename(best))
    logged = next(r["val_wWAPE"] for r in epochs if r["epoch"] == best_epoch)
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        r = forecast_main(forecast_argv + ["--ckpt_path", best])
    out["forecast"] = {"best_epoch": best_epoch, "wape": r.wape, "logged_val_wWAPE": logged,
                       "rel_diff": abs(r.wape - logged) / abs(logged),
                       "forwards": r.forwards, "launches": kernel.launches}
    checks["forecast --ckpt_path: WAPE"] = out["forecast"]["rel_diff"] <= TRAIN_WAPE_RTOL
    checks["forecast --ckpt_path: launches"] = kernel.launches == per_forward * r.forwards
    out["epochs"] = epochs
    with open(os.path.join(full_dir, "hparams.json")) as f:
        out["hparams"] = json.load(f)
    return checks


TRAIN_TIMING = ("train_step_ms: CUDA events over 8 distinct device batches after 2 warm-up "
                "steps, the median of the windows; optimizer_step_ms: CUDA events over 5 "
                "calls, optimizer_step_host_ms: host clock of one call; device busy: profiler "
                "over 2 steps")


def _train_phase(dev, card, zero_counts, counted):
    """Phase train: full-width gated_v4 training on the card, timed through
    ``Trainer`` and run end to end through ``train_transformer.main`` (see
    the module docstring).  Returns the gated residual's launches a train
    step and an eval forward."""
    from visuelle2_tpu_torch.cli import forecast_transformer, train_transformer
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.train import loop

    kernel = counted["fused_gated_residual"]
    out = {}
    # The step itself, through Trainer, on eight distinct device batches.
    model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(9),
                  vocab=VocabSizes(5, 6, 5, 126), image_dtype=torch.bfloat16,
                  image_arch=TRAIN_ARCH)
    trainer = loop.Trainer(model, loop.TrainConfig(grad_clip=0.5, learning_rate=TRAIN_LR))
    state = trainer.init_state()
    batches = [_to_device(_synthetic_batch(B, IMAGE, seed=500 + i), dev) for i in range(8)]
    out["trainer"], prof = _measure_trainer(trainer, state, batches,
                                            model.image_encoder.backbone, zero_counts, kernel)
    launches = out["trainer"]["launches"]
    checks = {"finite losses (Trainer)": bool(np.isfinite(out["trainer"]["losses"]).all()),
              "no host sync in a train step": not out["trainer"]["host_syncs_in_a_step"],
              "2 launches a train step": launches["per_train_step"] == 2,
              "2 launches an eval forward": launches["per_eval_forward"] == 2}
    del model, trainer, state, batches, prof
    torch.cuda.empty_cache()

    # End to end: train_transformer.main on a synthetic split, twice (once cut
    # by a SIGTERM and resumed), then forecast_transformer on the best epoch.
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        path = _write_train_split(tmp)
        out["dataset_setup_s"] = time.perf_counter() - t0
        argv = ["--dataset_path", path, "--model", "gated_v4", "--demand", "1",
                "--device", dev.type, "--image_arch", TRAIN_ARCH,
                "--bf16_backbone", "--batch_size", str(B), "--image_size", str(IMAGE),
                "--epochs", str(TRAIN_EPOCHS), "--learning_rate", str(TRAIN_LR)]
        checks.update(_cli_round_trip(
            out, tmp, train_transformer.main, forecast_transformer.main, argv,
            ["--dataset_path", path, "--device", dev.type, "--bf16_backbone",
             "--batch_size", str(B), "--image_size", str(IMAGE)],
            "fused_gated_residual", 2, zero_counts, counted,
            trace_dir=os.path.join(tmp, "trace")))
    _emit({"phase": "train", **card, "model": "gated_v4", "batch": B, "image": IMAGE,
           "embedding_dim": 32, "hidden_dim": 64, "bf16_backbone": True,
           "train_rows": TRAIN_ROWS, "test_rows": CLI_ROWS, "epochs": TRAIN_EPOCHS,
           "timing": TRAIN_TIMING, **out, "wape_rtol": TRAIN_WAPE_RTOL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"train: {name}")
    return launches


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_trainer_steps(trainer, batches):
    """``trainer`` from a fresh state over ``batches``: the losses (device
    tensors), then the parameters and buffers."""
    state = trainer.init_state()
    losses = [trainer.train_step(state, b)[1]["loss"] for b in batches]
    torch.cuda.synchronize()
    return state, losses


def _dp_parameter_groups(params):
    """Parameter names by where they sit: the backbone's BatchNorms, the
    backbone's convolutions, everything else."""
    groups = {"backbone_batchnorm": [], "backbone_conv": [], "rest": []}
    for n in params:
        if ".backbone." not in n:
            groups["rest"].append(n)
        elif ".bn" in n or ".ds_bn" in n:
            groups["backbone_batchnorm"].append(n)
        else:
            groups["backbone_conv"].append(n)
    return groups


def _dp_demo_runs(demo, root, tmp, port):
    """``demo`` (the demo's command) as two gloo ranks on this card and as
    one process alone, side by side, each with its own time limit: their
    JSON lines by name; rank 0 and the lone process write their parameters
    into ``tmp``.  A process that fails or outlives its limit fails the
    phase."""
    runs = {"rank0": ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                      "--process_id", "0", "--backend", "gloo",
                      "--params_out", os.path.join(tmp, "two_ranks.npz")],
            "rank1": ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                      "--process_id", "1", "--backend", "gloo"],
            "one_process": ["--params_out", os.path.join(tmp, "one_process.npz")]}
    procs = {k: subprocess.Popen(demo + extra, cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, extra in runs.items()}
    results, failed = {}, []
    try:
        for k, p in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=DP_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                failed.append(f"{k} exit {p.returncode}: {stderr[-2000:]}")
                continue
            results[k] = json.loads(lines[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    _require(not failed, f"data_parallel: a demo process failed: {failed}")
    return results


def _data_parallel_phase(dev, card, zero_counts, counted):
    """Phase data_parallel: the data-parallel ``Trainer`` at full width,
    one NCCL rank against the plain ``Trainer`` bit for bit, then two gloo
    ranks of ``parallel.demo_multihost`` on the one card against one
    process (see the module docstring).  Returns the counted kernels'
    launches in the one-rank run's data-parallel steps."""
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops.cuda import _build
    from visuelle2_tpu_torch.parallel import demo_multihost, distributed
    from visuelle2_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from visuelle2_tpu_torch.train import loop

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    lib = _build.library_path()
    lib_mtime = lib.stat().st_mtime_ns
    out = {"model": "gated_v4", "batch": B, "image": IMAGE, "bf16_backbone": True,
           "embedding_dim": 32, "hidden_dim": 64}

    # (a) one NCCL rank against the plain Trainer, bit for bit.
    config = loop.TrainConfig(grad_clip=0.5, learning_rate=TRAIN_LR)

    def model():
        return build("gated_v4", device=dev, generator=torch.Generator().manual_seed(11),
                     vocab=VocabSizes(5, 6, 5, 126), image_dtype=torch.bfloat16,
                     image_arch=TRAIN_ARCH)

    plain = loop.Trainer(model(), config)  # no process group: the plain steps
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_mesh()
        dp = loop.Trainer(model(), config, mesh=mesh)
        batches = [_to_device(_synthetic_batch(B, IMAGE, seed=700 + i), dev)
                   for i in range(DP_BATCHES)]
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # the same algorithms in both runs
        try:
            plain_state, plain_losses = _dp_trainer_steps(plain, batches)
            zero_counts()
            dp_state, dp_losses = _dp_trainer_steps(dp, batches)
            launches = {n: w.launches for n, w in counted.items()}
        finally:
            torch.backends.cudnn.deterministic = deterministic
        same = {
            "losses": all(torch.equal(a, b) for a, b in zip(plain_losses, dp_losses)),
            "parameters": all(torch.equal(a, b) for a, b in zip(
                plain.model.parameters(), dp.model.parameters())),
            "buffers": all(torch.equal(a, b) for a, b in zip(
                plain.model.buffers(), dp.model.buffers()))}
        # The step must not wait on the device (NCCL's all-reduce does not).
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                dp.train_step(dp_state, batches[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sorted({str(w.message)[:200] for w in caught
                        if "called a synchronizing CUDA operation" in str(w.message)})
        # ms a step in turns: plain, data parallel, data parallel, plain.
        cycle = itertools.cycle(batches)
        turns = []
        for name, trainer, state in (("plain", plain, plain_state),
                                     ("data_parallel", dp, dp_state),
                                     ("data_parallel", dp, dp_state),
                                     ("plain", plain, plain_state)):
            trainer.train_step(state, next(cycle))
            turns.append([name, _cuda_ms(lambda: trainer.train_step(state, next(cycle)),
                                         len(batches))])
        out["one_rank_nccl"] = {
            "mesh": mesh_shape(mesh), "batches": DP_BATCHES,
            "losses": [float(v) for v in dp_losses],
            "bit_identical_to_plain": same, "host_syncs_in_a_step": syncs,
            "launches_per_step": launches["fused_gated_residual"] / DP_BATCHES,
            "train_step_ms_turns": turns,
            "train_step_ms": {k: float(np.mean([t for n, t in turns if n == k]))
                              for k in ("plain", "data_parallel")},
            "timing": "CUDA events over the distinct batches, one warm-up step a turn"}
        del plain_state, dp_state
    finally:
        distributed.shutdown()
    del plain, dp, batches
    torch.cuda.empty_cache()

    # (b) two gloo ranks of the demo on this card, and one process alone.
    port = _free_port()
    demo = [sys.executable, "-m", "visuelle2_tpu_torch.parallel.demo_multihost",
            "--device", "cuda", "--image_arch", TRAIN_ARCH, "--image_size", str(IMAGE),
            "--bf16_backbone", "--global_batch", str(B), "--steps", str(DP_DEMO_STEPS),
            "--learning_rate", str(DP_DEMO_LR), "--model_axis", "1"]
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t_spawn = time.perf_counter()
        results = _dp_demo_runs(demo, root, tmp, port)
        spawn_s = time.perf_counter() - t_spawn
        saved = [dict(np.load(os.path.join(tmp, f)))
                 for f in ("two_ranks.npz", "one_process.npz")]
    r0, r1, one = results["rank0"], results["rank1"], results["one_process"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"])]
    sums_rel = {k: abs(r0["eval_sums"][k] - v) / abs(v) for k, v in one["eval_sums"].items()}
    init_model = build("gated_v4", device=dev,
                       generator=torch.Generator().manual_seed(demo_multihost.WEIGHTS_SEED),
                       vocab=VocabSizes(5, 6, 5, 126), output_len=12, embedding_dim=32,
                       hidden_dim=64, image_arch=TRAIN_ARCH, image_dtype=torch.bfloat16)
    init = {n: p.detach().float().cpu() for n, p in init_model.named_parameters()}
    del init_model
    # The parameters after the steps, and each step's gradient (summed over
    # the ranks) of the process alone, whose float noise is held apart.
    moved = [{n[len("param/"):]: torch.from_numpy(v) for n, v in run.items()
              if n.startswith("param/")} for run in saved]
    grads = [{n[len(f"grad{i}/"):]: torch.from_numpy(v) for n, v in saved[1].items()
              if n.startswith(f"grad{i}/")} for i in range(DP_DEMO_STEPS)]
    quiet = _noise_elements(grads)
    movement = {}
    for group, names in _dp_parameter_groups(init).items():
        cos, norm, frozen, noise, share = _movement(
            {n: init[n] for n in names}, moved[0], moved[1], quiet, DP_DEMO_STEPS * DP_DEMO_LR)
        movement[group] = {"min_cos": cos, "max_norm_rel_diff": norm, "frozen_moved": frozen,
                           "noise_elements": sum(v[0] for v in noise.values()),
                           "noise_bound_share": share}
    out["two_ranks_gloo"] = {
        "mesh": r0["mesh"], "steps": DP_DEMO_STEPS, "dropout": True,
        "losses": {"rank0": r0["losses"], "rank1": r1["losses"],
                   "one_process": one["losses"]},
        "eval_sums": {"rank0": r0["eval_sums"], "one_process": one["eval_sums"]},
        "loss_rel_diff": loss_rel, "eval_sums_rel_diff": sums_rel,
        "movement": movement, "wall_s": spawn_s,
        "library_rebuilt": lib.stat().st_mtime_ns != lib_mtime,
        "tol": {"loss_rtol": DP_RTOL}}
    a, b2 = out["one_rank_nccl"], out["two_ranks_gloo"]
    checks = {
        "one rank = plain, bit for bit": all(a["bit_identical_to_plain"].values()),
        "one rank: no host sync in a step": not a["host_syncs_in_a_step"],
        "one rank: 2 launches a step": a["launches_per_step"] == 2,
        "one rank: no other kernel": all(v == 0 for n, v in launches.items()
                                         if n != "fused_gated_residual"),
        "two ranks: the mesh": r0["mesh"] == {"dcn": 1, "data": 2, "model": 1},
        "two ranks: equal losses": r0["losses"] == r1["losses"],
        "two ranks: equal eval sums": r0["eval_sums"] == r1["eval_sums"],
        "two ranks: finite losses": bool(np.isfinite(r0["losses"]).all()),
        "two ranks vs one: losses": max(loss_rel) <= DP_RTOL,
        "two ranks vs one: noise elements": all(
            m["noise_bound_share"] <= 1.01 for m in movement.values()),
        "two ranks vs one: frozen stages unmoved": not any(
            m["frozen_moved"] for m in movement.values()),
        "no rebuild in the children": not b2["library_rebuilt"]}
    _emit({"phase": "data_parallel", **card, **out,
           "failed": sorted(k for k, ok in checks.items() if not ok),
           "phase_s": time.perf_counter() - t_phase})
    for name, ok in checks.items():
        _require(ok, f"data_parallel: {name}")
    return launches


def _tp_predicted_bytes(model, dims, m):
    """A rank's resident bytes of parameters and Adafactor state, predicted
    from the sharded set ``dims`` at a model axis of ``m``: a sharded
    parameter and each of its states that keeps the sharded dim divided by
    ``m``; frozen parameters hold no state."""
    from visuelle2_tpu_torch.train import optim

    total = 0
    for name, p in model.named_parameters():
        dim, shape, size = dims.get(name), tuple(p.shape), p.element_size()
        total += p.numel() * size // (m if dim is not None else 1)
        if optim.is_frozen(name):
            continue
        if optim.factored_dims(shape) is None:
            states = [("v", int(np.prod(shape)))]
        else:
            d1, d0 = optim.factored_dims(shape)
            states = [("v_row", int(np.prod(shape)) // shape[d0]),
                      ("v_col", int(np.prod(shape)) // shape[d1])]
        for key, n in states:
            split = dim is not None and optim.state_shard_dim(key, shape, dim) is not None
            total += n * size // (m if split else 1)
    return total


def _tp_digest(t):
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _tp_worker(spec):
    """One rank of the tensor_parallel phase (or the process alone, at
    ``world`` 1; or a rank of ``tensor_parallel_cards``): prints one JSON
    line."""
    from visuelle2_tpu_torch.data.loader import shard_batch
    from visuelle2_tpu_torch.eval.forecast import score_split
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops.cuda.gated_fusion import fused_gated_residual
    from visuelle2_tpu_torch.parallel import distributed, sharding
    from visuelle2_tpu_torch.parallel.mesh import LocalMesh, make_mesh, mesh_shape
    from visuelle2_tpu_torch.train import loop
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, plain_payload

    # The main path's settings (``main``): TF32 off, cuDNN free to pick
    # nondeterministic algorithms; a witness asks for deterministic ones.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = bool(spec.get("deterministic"))
    world, rank, m = spec["world"], spec["rank"], spec["model_axis"]
    gb, image, arch = spec["batch"], spec["image"], spec["arch"]
    if world > 1:
        dev = distributed.initialize(f"127.0.0.1:{spec['port']}", world, rank,
                                     device=spec["device"], backend=spec["backend"])
        mesh = make_mesh(model=m)
    else:
        dev, mesh = torch.device(spec["device"]), None
    cuda = dev.type == "cuda"
    out = {"rank": rank, "world": world, "mesh": mesh_shape(mesh) if mesh else None}
    vocab = VocabSizes(5, 6, 5, 126)
    try:
        def v4():
            return build("gated_v4", device=dev, generator=torch.Generator().manual_seed(23),
                         vocab=vocab, image_dtype=torch.bfloat16 if cuda and not spec.get(
                             "f32_backbone") else torch.float32,
                         image_arch=arch)

        model = v4()
        dims = (sharding.infer_param_sharding(model, mesh, TP_MIN_DIM) if mesh is not None
                else {})
        out["sharded"] = sum(d is not None for d in dims.values())
        out["predicted_resident_bytes"] = _tp_predicted_bytes(model, dims, m)
        trainer = loop.Trainer(model, loop.TrainConfig(
            grad_clip=0.5, learning_rate=TRAIN_LR, tp_min_dim=TP_MIN_DIM), mesh=mesh)
        state = trainer.init_state()
        moved = ([0] if not spec.get("perturb_replicas") or trainer.model_rank != 1
                 else _tp_perturb_replicas(trainer))
        batches = [shard_batch(_synthetic_batch(gb, image, seed=900 + i), mesh, device=dev)
                   for i in range(spec["steps"])]
        fused_gated_residual.launches = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for b in batches:
            state, metrics = trainer.train_step(state, b)
            losses.append(metrics["loss"])
            if spec.get("state_after_first_step") and len(losses) == 1:
                plain = sharding.plain_state_dict(model)  # every rank gathers
                if rank == 0:
                    torch.save({k: v.detach().cpu() for k, v in plain.items()},
                               spec["state_after_first_step"])
                del plain
        out["losses"] = [float(v) for v in losses]
        out["perturbed_tensors"] = moved[0]
        out["steps_wall_s"] = time.perf_counter() - t0
        out["launches_per_step"] = {"fused_gated_residual":
                                    fused_gated_residual.launches / len(batches)}
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
        out["resident_bytes"] = sharding.resident_bytes(model, state.optimizer)
        shards = sharding.parameter_shards(model)
        out["replicated_digests"] = {
            **{sharding.plain_name(n): _tp_digest(p) for n, p in model.named_parameters()
               if p not in shards},
            **{n: _tp_digest(b) for n, b in model.named_buffers()}}
        if spec.get("timed"):
            out.update(_tp_timed_steps(trainer, state, batches))
        evals = [_synthetic_batch(gb, image, seed=950 + i) for i in range(TP_EVAL_BATCHES)]
        r = score_split(model.eval(), [shard_batch(b, mesh, device=dev) for b in evals], mesh=mesh,
                        one_pass=True, measure_throughput=False)
        out["eval"] = {"wape": r.wape, "mae": r.mae, "rows": r.num_forecasts}
        if spec.get("ckpt_dir"):
            if trainer.is_main:
                CheckpointManager(spec["ckpt_dir"]).save(0, state, {"val_wWAPE": r.wape})
            else:
                plain_payload(state)
            if world > 1:
                import torch.distributed as dist

                dist.barrier()
            if trainer.is_main:
                plain = CheckpointManager(spec["ckpt_dir"], read_only=True).restore_for_eval(
                    v4(), 0)
                rp = score_split(plain, [shard_batch(b, None, device=dev) for b in evals],
                                 mesh=LocalMesh(device_type=dev.type), one_pass=True,
                                 measure_throughput=False)
                out["restored_plain_eval"] = {"wape": rp.wape, "mae": rp.mae}
                del plain
        del trainer, state, model, batches
        if spec.get("with_210"):
            out["rnn_210"] = _tp_worker_210(mesh, dev, vocab)
    finally:
        if world > 1:
            distributed.shutdown()
    print(json.dumps(out), flush=True)


def _tp_perturb_replicas(trainer):
    """Model rank 1 moves its replicated gradients and float buffers one
    ulp before each step's model-group sync, as a nondeterministic kernel
    would: the ranks' replicas then stay bit-equal only through the sync's
    rule (rank 0's values).  Returns a one-element list, how many tensors
    the last step moved."""
    from visuelle2_tpu_torch.parallel import sharding

    model, sync = trainer.model, trainer._sync_model_ranks
    shards = sharding.parameter_shards(model)
    moved = [0]

    def perturbed(loss, flags):
        with torch.no_grad():
            tensors = [p.grad for p in model.parameters()
                       if p.grad is not None and p not in shards]
            tensors += [b for b in model.buffers() if b.dtype == loss.dtype]
            for t in tensors:
                t.copy_(torch.nextafter(t, torch.full_like(t, float("inf"))))
            moved[0] = len(tensors)
        return sync(loss, flags)

    trainer._sync_model_ranks = perturbed
    return moved


def _tp_worker_210(mesh, dev, vocab):
    """The tensor_parallel phase's part (c): cross_attn_rnn_210 at a small
    width, one teacher-forced step and a one-pass eval over ``mesh``."""
    from visuelle2_tpu_torch.data.loader import shard_batch
    from visuelle2_tpu_torch.eval.forecast import score_split
    from visuelle2_tpu_torch.models import build
    from visuelle2_tpu_torch.ops.cuda.additive_attention import fused_additive_attention
    from visuelle2_tpu_torch.parallel import sharding
    from visuelle2_tpu_torch.train import loop

    model = build("cross_attn_rnn_210", device=dev, generator=torch.Generator().manual_seed(29),
                  vocab=vocab, **TP_210_DIMS)
    names = ([n for n, d in sharding.infer_param_sharding(model, mesh, TP_210_MIN_DIM).items()
              if d is not None] if mesh is not None else [])
    trainer = loop.Trainer(model, loop.TrainConfig(learning_rate=TRAIN_LR,
                                                   tp_min_dim=TP_210_MIN_DIM), mesh=mesh)
    state = trainer.init_state()
    horizon = TP_210_DIMS["out_len"]
    batch = _stfore_batch(TP_210_BATCH, TP_210_IMAGE, seed=960, horizon=horizon)
    state, metrics = trainer.train_step(state, shard_batch(batch, mesh, device=dev))
    fused_additive_attention.launches = 0
    evals = [shard_batch(_stfore_batch(TP_210_BATCH, TP_210_IMAGE, seed=970 + i,
                                       horizon=horizon), mesh, device=dev) for i in range(2)]
    r = score_split(model.eval(), evals, mesh=mesh, one_pass=True, measure_throughput=False)
    return {"loss": float(metrics["loss"]), "sharded": len(names),
            "recurrence_sharded": [n for n in names if n.rsplit(".", 1)[-1] in ("w_i", "w_h")],
            "decoder_sharded": [n for n in names if "decoder" in n],
            "additive_launches_per_forward": fused_additive_attention.launches / r.forwards,
            "eval": {"wape": r.wape, "mae": r.mae}}


def _tp_timed_steps(trainer, state, batches):
    """ms a step (CUDA events over ``TP_CARDS_TIMED`` steps), host syncs in
    a step, and a profiled step's device ms with and without NCCL's kernels,
    their share taken of the event-timed step (the profiler stretches its
    own step's wall time)."""
    cycle = itertools.cycle(batches)
    trainer.train_step(state, next(cycle))
    ms = _cuda_ms(lambda: trainer.train_step(state, next(cycle)), TP_CARDS_TIMED)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step(state, next(cycle))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sorted({str(w.message)[:200] for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message)})
    torch.cuda.synchronize()
    with _profile() as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, next(cycle))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = _device_us(prof) / 1e3
    # NCCL's kernels spin while a peer is late: busy without them too.
    comm_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and "nccl" in e.key.lower()) / 1e3
    by_op = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                   key=lambda kv: -kv[1])[:8]
    return {"train_step_ms": ms, "host_syncs_in_a_step": syncs,
            "profiled_step_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
            "nccl_kernel_ms_per_step": comm_ms,
            "device_ms_without_nccl": busy_ms - comm_ms,
            "device_busy_share_without_nccl": (busy_ms - comm_ms) / ms,
            "device_ms_by_op": dict(by_op)}


def _tp_spawn(runs, root, timeout_s):
    """Each ``{name: spec}`` as a worker process (``TP_WORKER_FLAG``), side by
    side, each with its own time limit: their JSON lines by name.  A process
    that fails or outlives its limit fails the phase."""
    procs = {k: subprocess.Popen([sys.executable, os.path.join(root, "chip_smoke.py"),
                                  TP_WORKER_FLAG, json.dumps(spec)], cwd=root,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, spec in runs.items()}
    results, failed = {}, []
    try:
        for k, p in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                failed.append(f"{k} exit {p.returncode}: {stderr[-3000:]}")
                continue
            results[k] = json.loads(lines[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    _require(not failed, f"tensor_parallel: a worker failed: {failed}")
    return results


def _tp_rule_count(name, min_dim, **kw):
    """The sharded parameters the rule gives at model=2, on the CPU."""
    import types

    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.parallel import sharding

    model = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **kw)
    two = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    return sum(d is not None for d in sharding.infer_param_sharding(model, two, min_dim).values())


def _tensor_parallel_phase(dev, card, counted):
    """Phase tensor_parallel: the full-width gated_v4 on a data=1 x model=2
    mesh of two gloo ranks on this card against one process, then
    cross_attn_rnn_210 at a small width on the same mesh (see the module
    docstring).  Returns the counted kernels' launches: a TP step's and a
    210 forward's, rank 0."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    base = {"device": "cuda", "batch": TP_BATCH, "image": IMAGE, "arch": TRAIN_ARCH,
            "steps": TP_STEPS, "model_axis": 2, "backend": "gloo", "with_210": True,
            "perturb_replicas": True}
    port = _free_port()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        runs = {f"rank{r}": dict(base, world=2, rank=r, port=port,
                                 ckpt_dir=os.path.join(tmp, "ck")) for r in (0, 1)}
        runs["one_process"] = dict(base, world=1, rank=0, model_axis=1)
        t0 = time.perf_counter()
        res = _tp_spawn(runs, root, TP_CHILD_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
    r0, r1, one = res["rank0"], res["rank1"], res["one_process"]
    rule = _tp_rule_count("gated_v4", TP_MIN_DIM, image_arch=TRAIN_ARCH)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"])]
    c0, c1 = r0["rnn_210"], one["rnn_210"]
    out = {
        "model": "gated_v4", "global_batch": TP_BATCH, "image": IMAGE, "bf16_backbone": True,
        "embedding_dim": 32, "hidden_dim": 64, "tp_min_dim": TP_MIN_DIM, "steps": TP_STEPS,
        "mesh": r0["mesh"], "backend": "gloo (two ranks on one card)",
        "sharded_params": {"rank0": r0["sharded"], "rank1": r1["sharded"], "cpu_rule": rule},
        "resident_param_and_state_bytes": {
            "rank0": r0["resident_bytes"], "rank1": r1["resident_bytes"],
            "predicted_per_rank": r0["predicted_resident_bytes"],
            "one_process": one["resident_bytes"],
            "predicted_one_process": one["predicted_resident_bytes"]},
        "peak_device_bytes": {"rank0": r0["peak_device_bytes"],
                              "rank1": r1["peak_device_bytes"],
                              "one_process": one["peak_device_bytes"]},
        "losses": {"rank0": r0["losses"], "rank1": r1["losses"],
                   "one_process": one["losses"]},
        "loss_rel_diff": loss_rel,
        "eval_rel_diff_vs_one_process_trained_alone": {
            k: abs(r0["eval"][k] - one["eval"][k]) / abs(one["eval"][k]) for k in ("wape", "mae")},
        "tol": {"loss_rtol": DP_RTOL, "wape_atol": TP_WAPE_ATOL,
                                           "mae_atol": TP_MAE_ATOL},
        "steps_wall_s": {"rank0": r0["steps_wall_s"], "one_process": one["steps_wall_s"]},
        "launches_per_step": {"rank0": r0["launches_per_step"],
                              "rank1": r1["launches_per_step"]},
        "replicated_tensors": len(r0["replicated_digests"]),
        "rank1_tensors_moved_an_ulp_before_each_sync": r1["perturbed_tensors"],
        "eval": {"rank0": r0["eval"], "rank1": r1["eval"], "one_process": one["eval"],
                 "restored_plain": r0["restored_plain_eval"]},
        "rnn_210": {"rank0": c0, "rank1": r1["rnn_210"], "one_process": c1,
                    "cpu_rule_sharded": _tp_rule_count("cross_attn_rnn_210", TP_210_MIN_DIM,
                                                       **TP_210_DIMS)},
        "model_1_mesh": "data_parallel (a): one NCCL rank = the plain Trainer, bit for bit",
        "spawn_s": spawn_s}
    checks = {
        "sharded: the ranks and the CPU rule agree": r0["sharded"] == r1["sharded"] == rule > 0,
        "resident bytes: as predicted": r0["resident_bytes"] == r1["resident_bytes"]
        == r0["predicted_resident_bytes"],
        "resident bytes: one process as predicted":
            one["resident_bytes"] == one["predicted_resident_bytes"],
        "ranks: equal losses": r0["losses"] == r1["losses"],
        "ranks: finite losses": bool(np.isfinite(r0["losses"]).all()),
        "ranks vs one: losses": max(loss_rel) <= DP_RTOL,
        # Rank 1 moves its replicated gradients and buffers an ulp before
        # each sync, so only the sync's rule keeps the replicas equal.
        "rank 1 moved its replicas before each sync": r1["perturbed_tensors"] > 0
        and r0["perturbed_tensors"] == 0,
        "replicated parameters and buffers bit-equal across ranks":
            r0["replicated_digests"] == r1["replicated_digests"],
        "2 gated-residual launches a step a rank": all(
            r["launches_per_step"]["fused_gated_residual"] == 2 for r in (r0, r1)),
        "ranks: equal eval": r0["eval"] == r1["eval"],
        # The dry run's comparison: one process scoring the same parameters
        # (the ranks' checkpoint restored into a plain model).
        "eval vs one process, same parameters: WAPE": abs(
            r0["eval"]["wape"] - r0["restored_plain_eval"]["wape"]) <= TP_WAPE_ATOL,
        "eval vs one process, same parameters: MAE": abs(
            r0["eval"]["mae"] - r0["restored_plain_eval"]["mae"]) <= TP_MAE_ATOL,
        "checkpoint restored into a plain model: the same metrics bit for bit":
            r0["restored_plain_eval"] == {k: r0["eval"][k] for k in ("wape", "mae")},
        "210: 30 additive launches a forward": c0["additive_launches_per_forward"]
        == TP_210_LAUNCHES == r1["rnn_210"]["additive_launches_per_forward"],
        "210: w_i / w_h not sharded": not c0["recurrence_sharded"],
        "210: a decoder kernel sharded": bool(c0["decoder_sharded"]),
        "210: the CPU rule's count": c0["sharded"] == out["rnn_210"]["cpu_rule_sharded"],
        "210: eval WAPE vs one": abs(c0["eval"]["wape"] - c1["eval"]["wape"]) <= TP_WAPE_ATOL}
    _emit({"phase": "tensor_parallel", **card, **out,
           "failed": sorted(k for k, ok in checks.items() if not ok),
           "phase_s": time.perf_counter() - t_phase})
    for name, ok in checks.items():
        _require(ok, f"tensor_parallel: {name}")
    launches = {n: 0 for n in counted}
    launches["fused_gated_residual"] = r0["launches_per_step"]["fused_gated_residual"]
    launches["fused_additive_attention"] = c0["additive_launches_per_forward"]
    return launches


def _tp_state_gap(path_a, path_b):
    """Two saved plain states: how many tensors differ, and the largest
    difference of a tensor relative to its largest element."""
    a, b = torch.load(path_a), torch.load(path_b)
    rel = {k: ((a[k].double() - b[k].double()).abs().max()
               / b[k].double().abs().max().clamp_min(1e-30)).item() for k in b}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    return {"tensors": len(rel), "tensors_differing": sum(v > 0 for v in rel.values()),
            "max_rel": max(rel.values()), "worst": worst}


def tensor_parallel_cards(cards=4):
    """The four-card check, run alone (``python3 chip_smoke.py
    --tensor-parallel-cards 4``): gated_v4 at full width (global B=128) on a
    (data=2, model=2) NCCL mesh over ``cards`` cards, then on (data=4,
    model=1), timed with the main path's settings: ms a step, host syncs,
    busy share, peak memory and resident bytes a rank.  Then the witnesses
    (``TP_CARDS_PARAM_RTOL``'s comment), whose losses are held to each
    other within 2^-8 at every step."""
    from visuelle2_tpu_torch.ops.cuda import _build

    _require(torch.cuda.device_count() >= cards,
             f"tensor_parallel_cards: {torch.cuda.device_count()} cards, need {cards}")
    root = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    _build.load_library()  # once, before the workers load it
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    base = {"device": "cuda", "batch": B, "image": IMAGE, "arch": TRAIN_ARCH,
            "steps": TP_CARDS_STEPS, "backend": "nccl"}
    timed_keys = ("train_step_ms", "profiled_step_ms", "device_busy_ms_per_step",
                  "nccl_kernel_ms_per_step", "device_ms_without_nccl",
                  "device_busy_share_without_nccl", "peak_device_bytes", "resident_bytes",
                  "predicted_resident_bytes", "sharded", "host_syncs_in_a_step")
    meshes = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        first = {m: os.path.join(tmp, f"model{m}.pt") for m in (2, 1)}
        for name, world, m, extra in (
                ("data2_model2", cards, 2, {"timed": True}),
                ("data4_model1", cards, 1, {"timed": True}),
                ("data2_model2_deterministic", cards, 2,
                 {"deterministic": True, "state_after_first_step": first[2]}),
                ("data2_model1_deterministic", cards // 2, 1,
                 {"deterministic": True, "state_after_first_step": first[1]}),
                ("data2_model2_f32", cards, 2, {"f32_backbone": True}),
                ("data4_model1_f32", cards, 1, {"f32_backbone": True})):
            port = _free_port()
            t0 = time.perf_counter()
            res = _tp_spawn({f"rank{r}": dict(base, world=world, rank=r, port=port,
                                              model_axis=m, **extra)
                             for r in range(world)}, root, TP_CHILD_TIMEOUT_S)
            keys = ("losses", "eval") + (timed_keys if extra.get("timed") else ())
            meshes[name] = {"mesh": res["rank0"]["mesh"], "wall_s": time.perf_counter() - t0,
                            **{k: {r: v[k] for r, v in res.items()} for k in keys}}
            if extra.get("timed"):
                meshes[name]["device_ms_by_op_rank0"] = res["rank0"]["device_ms_by_op"]
        first_update = _tp_state_gap(first[2], first[1])

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(meshes[a]["losses"]["rank0"],
                                                    meshes[b]["losses"]["rank0"])]

    gaps = {"bf16 (2,2) vs (2,1), 64 rows a rank, deterministic":
            rel("data2_model2_deterministic", "data2_model1_deterministic"),
            "f32 (2,2) vs (4,1)": rel("data2_model2_f32", "data4_model1_f32"),
            "bf16 (2,2) vs (4,1)": rel("data2_model2", "data4_model1"),
            "bf16 (2,1) deterministic vs (4,1)": rel("data2_model1_deterministic",
                                                      "data4_model1"),
            "bf16 (2,2) vs (2,2) deterministic": rel("data2_model2",
                                                     "data2_model2_deterministic")}
    tp, dp = meshes["data2_model2"], meshes["data4_model1"]
    checks = {
        "(2,2) vs (2,1): losses within 2^-8 at every step": max(gaps[
            "bf16 (2,2) vs (2,1), 64 rows a rank, deterministic"]) <= DP_RTOL,
        "(2,2) vs (2,1): the first update's parameters within TP_CARDS_PARAM_RTOL":
            first_update["max_rel"] <= TP_CARDS_PARAM_RTOL,
        "f32 (2,2) vs (4,1): losses within 2^-8 at every step":
            max(gaps["f32 (2,2) vs (4,1)"]) <= DP_RTOL,
        "ranks' losses equal": all(len({tuple(v) for v in x["losses"].values()}) == 1
                                   for x in meshes.values()),
        "no host sync in a step": not any(s for x in (tp, dp)
                                          for s in x["host_syncs_in_a_step"].values()),
        "resident bytes as predicted": all(
            x["resident_bytes"][r] == x["predicted_resident_bytes"][r]
            for x in (tp, dp) for r in x["resident_bytes"])}
    _emit({"tensor_parallel_cards": cards, "card": smi, "meshes": meshes,
           "loss_rel_diff": gaps, "first_update_param_gap": first_update,
           "tol": {"loss_rtol": DP_RTOL, "param_rtol": TP_CARDS_PARAM_RTOL},
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"tensor_parallel_cards: {name}")


def _train_demand_phase(dev, card, zero_counts, counted):
    """Phase train_demand: full-width CrossAttnRNN Demand training on the
    card, timed through ``Trainer`` and run end to end through
    ``train_dl.main`` (see the module docstring).  Returns the additive
    attention's and the GRU kernel path's launches in a train step."""
    from visuelle2_tpu_torch.cli import forecast_dl, train_dl
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.train import loop

    additive = counted["fused_additive_attention"]
    out = {}
    # The step itself, through Trainer, on eight distinct device batches,
    # teacher forcing on at ratio 0.5 (a coin a decode step).
    model = build("cross_attn_rnn_demand", device=dev, generator=torch.Generator().manual_seed(9),
                  vocab=VocabSizes(5, 6, 5, 126), image_dtype=torch.bfloat16,
                  image_arch=TRAIN_ARCH, use_teacher_forcing=True, teacher_forcing_ratio=0.5,
                  **CROSS_ATTN_DIMS)
    trainer = loop.Trainer(model, loop.TrainConfig(learning_rate=TRAIN_LR))
    state = trainer.init_state()
    batches = [_to_device(_synthetic_batch(B, IMAGE, seed=600 + i), dev) for i in range(8)]
    out["trainer"], prof = _measure_trainer(trainer, state, batches,
                                            model.static.image_encoder.backbone, zero_counts,
                                            additive)
    out["trainer"]["teacher_forcing_ratio"] = 0.5
    out["trainer"]["additive_kernels_device_ms_per_step"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and any(k in e.key for k in ADDITIVE_KERNEL_NAMES)) / 2e3

    def forward_backward(batch):
        """Each counted kernel's launches in one step's forward and in its
        backward; the update is not applied."""
        zero_counts()
        generator = loop.step_generator(trainer.config.seed + loop.DROPOUT_SEED_OFFSET,
                                        state.step, dev)
        loss = trainer._train_loss(batch, generator)
        forward = {n: w.launches for n, w in counted.items()}
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        torch.cuda.synchronize()
        state.optimizer.zero_grad(set_to_none=True)
        return forward, {n: w.launches - forward[n] for n, w in counted.items()}

    step_forward, step_backward = forward_backward(batches[0])
    # The trend GRU on the kernel path: its launches in a step, and the step
    # time of both paths in turns.
    trend_gru = model.static.trend_encoder.gru
    trend_gru.use_kernel = True
    gru_forward, gru_backward = forward_backward(batches[2])
    cycle = itertools.cycle(batches)
    path_ms = {"step_loop": [], "kernel": []}
    for use_kernel in (False, True, True, False):
        trend_gru.use_kernel = use_kernel
        trainer.train_step(state, next(cycle))
        path_ms["kernel" if use_kernel else "step_loop"].append(
            _cuda_ms(lambda: trainer.train_step(state, next(cycle)), 4))
    trend_gru.use_kernel = False
    out["trainer"].update(
        launches_forward=step_forward, launches_backward=step_backward,
        trend_gru_kernel_path={"train_step_ms_in_turns": path_ms,
                               "launches_forward": gru_forward,
                               "launches_backward": gru_backward})
    launches = out["trainer"]["launches"]
    others = [n for n in counted if n != "fused_additive_attention"]
    checks = {"finite losses (Trainer)": bool(np.isfinite(out["trainer"]["losses"]).all()),
              "no host sync in a train step": not out["trainer"]["host_syncs_in_a_step"],
              "36 launches a train step": launches["per_train_step"] == 36,
              "36 launches a step's forward, none in its backward": (
                  step_forward["fused_additive_attention"],
                  step_backward["fused_additive_attention"]) == (36, 0),
              "no other kernel": not any(step_forward[n] or step_backward[n] for n in others),
              "36 launches an eval forward": launches["per_eval_forward"] == 36,
              "GRU kernel path: 1 launch a step's forward, none in its backward": (
                  gru_forward["fused_gru_sequence"], gru_backward["fused_gru_sequence"],
                  gru_forward["fused_additive_attention"]) == (1, 0, 36)}
    del model, trainer, state, batches, prof, cycle
    torch.cuda.empty_cache()

    # End to end: train_dl.main on the train phases' split, twice (once cut
    # by a SIGTERM and resumed), then forecast_dl on the best epoch.
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        path = _write_train_split(tmp)
        out["dataset_setup_s"] = time.perf_counter() - t0
        argv = ["--dataset_path", path, "--demand", "1", "--device", dev.type,
                "--image_arch", TRAIN_ARCH, "--bf16_backbone", "--batch_size", str(B),
                "--image_size", str(IMAGE), "--epochs", str(TRAIN_EPOCHS),
                "--learning_rate", str(TRAIN_LR), "--use_teacher_forcing"]
        checks.update(_cli_round_trip(
            out, tmp, train_dl.main, forecast_dl.main, argv,
            ["--dataset_path", path, "--device", dev.type, "--bf16_backbone",
             "--batch_size", str(B), "--image_size", str(IMAGE)],
            "fused_additive_attention", 36, zero_counts, counted))
    checks["hparams.json"] = out["hparams"]["model"] == "cross_attn_rnn_demand" \
        and out["hparams"]["attention_dim"] == 512 and out["hparams"]["use_teacher_forcing"] == 1
    _emit({"phase": "train_demand", **card, "model": "cross_attn_rnn_demand", "batch": B,
           "image": IMAGE, **CROSS_ATTN_DIMS, "bf16_backbone": True,
           "train_rows": TRAIN_ROWS, "test_rows": CLI_ROWS, "epochs": TRAIN_EPOCHS,
           "timing": TRAIN_TIMING + "; the GRU paths: CUDA events over 4 steps each, in turns",
           **out, "wape_rtol": TRAIN_WAPE_RTOL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"train_demand: {name}")
    return {"fused_additive_attention": {
                "per_train_step_forward": step_forward["fused_additive_attention"],
                "per_train_step_backward": step_backward["fused_additive_attention"],
                "per_eval_forward": launches["per_eval_forward"]},
            "fused_gru_sequence": {
                "per_train_step_forward_on_kernel_path": gru_forward["fused_gru_sequence"],
                "per_train_step_backward": gru_backward["fused_gru_sequence"]}}


def _stats_reference(X, method, teacher_forcing):
    """float64 numpy forecasts of 2-week windows X [B, W, 2] in the layouts
    of ``ops/stats.py``: the closed forms (naive; SES with the least-squares
    initial level; Holt's exact extrapolation x1 + h·(x1 − x0))."""
    X = X.astype(np.float64)
    B, W, T = X.shape
    if method == "naive":
        f = X[:, :, -1] if teacher_forcing else np.repeat(X[:, :1, -1], W, axis=1)
        return f[..., None]
    if method == "ses":
        def level(x, a=0.3):
            c, d, cs, ds = np.zeros(len(x)), np.ones(len(x)), [], []
            for t in range(x.shape[1]):
                cs.append(c)
                ds.append(d)
                c, d = a * x[:, t] + (1 - a) * c, (1 - a) * d
            cs, ds = np.stack(cs, 1), np.stack(ds, 1)
            return c + d * (ds * (x - cs)).sum(1) / (ds * ds).sum(1)
        if teacher_forcing:
            return level(X.reshape(B * W, T)).reshape(B, W, 1)
        return np.repeat(level(X[:, 0])[:, None, None], W, axis=2)
    if teacher_forcing:
        return (2 * X[:, :, 1] - X[:, :, 0])[..., None]
    h = np.arange(1, W + 1)
    return (X[:, 0, 1:2] + h * (X[:, 0, 1:2] - X[:, 0, 0:1]))[:, None, :]


def _stats_phase(dev, card, zero_counts, counted):
    """Phase stats: ``forecast_stat.main`` on the card (see the module
    docstring)."""
    from visuelle2_tpu_torch.cli import common, forecast_stat
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.pipeline import load_visuelle2
    from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
    from visuelle2_tpu_torch.ops import stats
    from visuelle2_tpu_torch.ops.metrics import calc_error_metrics

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    runs, checks = {}, {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = make_synthetic_dataset(tmp, num_train=0, num_test=CLI_ROWS, seed=0,
                                      write_images=False, rows_per_image=CLI_ROWS_PER_IMAGE)
        paths = load_visuelle2(path, "test", demand=False, output_len=1).image_paths
        unique, row_to_img = ImageStore.unique_paths(paths)
        pixels = np.random.default_rng(0).integers(
            0, 256, (len(unique), STATS_IMAGE, STATS_IMAGE, 3), dtype=np.uint8)
        ImageStore(pixels, row_to_img).write_cache(
            ImageStore.cache_path(path, "test", STATS_IMAGE), paths)
        for method in ("naive", "ses", "holt"):
            for tf in (1, 0):
                label = f"{method} teacher_forcing={tf}"
                argv = ["--dataset_path", path, "--device", dev.type, "--batch_size", str(B),
                        "--image_size", str(STATS_IMAGE), "--method", method,
                        "--use_teacher_forcing", str(tf)]
                zero_counts()
                text = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    wape, mae = forecast_stat.main(argv)
                pass_s = time.perf_counter() - t
                launches = {n: w.launches for n, w in counted.items()}
                # The CLI's own forecasts, unrounded, against a float64
                # recomputation over the same loader's windows.
                args = forecast_stat.build_parser().parse_args(argv)
                with contextlib.redirect_stdout(io.StringIO()):
                    gt, got = forecast_stat.forecasts(args)
                loaders, _, norm = common.build_loaders(args, demand=False, output_len=1,
                                                        splits=("test",))
                want, want_gt = [], []
                for batch in loaders["test"]:
                    n = int(batch["mask"].sum())
                    want.append(_stats_reference(batch["X"].numpy()[:n], method, tf).squeeze())
                    want_gt.append(batch["y"].numpy()[:n].astype(np.float64).squeeze())
                want, want_gt = np.concatenate(want) * norm, np.concatenate(want_gt) * norm
                err32 = np.abs(gt.astype(np.float64) - got.astype(np.float64))
                err64 = np.abs(want_gt - want)
                got_m = {"wape": 100 * err32.sum() / gt.astype(np.float64).sum(),
                         "mae": err32.mean()}
                want_m = {"wape": 100 * err64.sum() / want_gt.sum(), "mae": err64.mean()}
                runs[label] = {"printed": [wape, mae], "wape": got_m["wape"], "mae": got_m["mae"],
                               "float64": want_m, "forecasts": int(got.size),
                               "pass_s": pass_s, "launches": launches,
                               "tail": text.getvalue().strip().splitlines()[-2:]}
                for k in ("wape", "mae"):
                    checks[f"{label}: {k} vs float64"] = abs(got_m[k] - want_m[k]) <= \
                        STATS_RTOL * abs(want_m[k])
                checks[f"{label}: printed"] = (mae, wape) == calc_error_metrics(gt, got) and \
                    runs[label]["tail"] == [f"Results for {method}", f"{wape},{mae}"]
                checks[f"{label}: {CLI_ROWS} rows, finite"] = got.shape == gt.shape and \
                    len(got) == CLI_ROWS and bool(np.isfinite(got).all())
                checks[f"{label}: no kernel launch"] = not any(launches.values())
    holt = {}
    for series, recorded in HOLT_PINNED.items():
        x = torch.tensor([series])
        on_card = [t.cpu() for t in stats.holt_fit(x.to(dev))]
        on_cpu = stats.holt_fit(x)
        forecast = stats.holt_fit_forecast(x.to(dev), 3).cpu()[0]
        key = f"T={len(series)}"
        holt[key] = {"forecast": forecast.tolist(), "recorded": list(recorded),
                     "picks": on_card[2][0].tolist()}
        checks[f"holt {key}: card = CPU, bit for bit"] = all(
            torch.equal(a, b) for a, b in zip(on_card, on_cpu)) and torch.equal(
            forecast, stats.holt_fit_forecast(x, 3)[0])
        checks[f"holt {key}: recorded constants"] = bool(np.allclose(
            forecast.numpy(), recorded, rtol=HOLT_PINNED_RTOL, atol=0))
    _emit({"phase": "stats", **card, "rows": CLI_ROWS, "image": STATS_IMAGE, "batch": B,
           "rtol": STATS_RTOL, "timing": "pass_s: host clock of forecast_stat.main "
           "(loader, copies, forecasts, metrics)", "runs": runs, "holt_pinned": holt,
           "holt_pinned_rtol": HOLT_PINNED_RTOL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"stats: {name}: {json.dumps(runs)}")


def _gtm_v1_batches():
    """``make(n, image, seed)``: ``_synthetic_batch`` plus gtm_v1's
    ``text_features``, the hashed featurizer's vectors of the rows'
    category, color and fabric (the synthetic dataset's label names)."""
    from visuelle2_tpu_torch.data.synthetic import CATEGORIES, COLORS, FABRICS
    from visuelle2_tpu_torch.models.gtm_v1 import TextFeaturizer

    names = (CATEGORIES, COLORS, FABRICS)
    with contextlib.redirect_stdout(io.StringIO()):
        featurizer = TextFeaturizer(*({v: i for i, v in enumerate(n)} for n in names))

    def make(n, image_size, seed):
        b = _synthetic_batch(n, image_size, seed)
        b["text_features"] = featurizer(*(b[k] % len(v) for k, v in zip(("cat", "col", "fab"),
                                                                        names)))
        return b
    return make


def _forward_gtm_v1_phase(dev, card, zero_counts, counted):
    """Phase forward_gtm_v1: the full-width gtm_v1 through ``make_forecaster``
    (see the module docstring)."""
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.models import build

    make = _gtm_v1_batches()
    example = make(B, IMAGE, seed=1)
    host_batches = [make(B, IMAGE, seed=10 + i) for i in range(N_FWD)]
    runs, checks = {}, {}
    for tower, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for ar in (False, True):
            label = f"{tower} tower, {'AR' if ar else 'non-AR'}"
            model = build("gtm_v1", device=dev, generator=torch.Generator().manual_seed(0),
                          image_dtype=dtype, autoregressive=ar, **GTM_V1_DIMS)
            fn, _ = make_forecaster(model, example, device=dev)
            zero_counts()
            outs = [fn(hb) for hb in host_batches]
            launches = {n: w.launches for n, w in counted.items()}
            checks[f"{label}: finite [{B}, 12]"] = all(
                o.shape == (B, 12) and np.isfinite(o).all() for o in outs)
            checks[f"{label}: distinct batches differ"] = not np.array_equal(outs[0], outs[1])
            checks[f"{label}: no kernel launch"] = not any(launches.values())
            runs[label] = {"forecast_absmax": float(np.abs(outs[0]).max())}
            if not ar:
                runs[label]["times"] = _forward_times(model, fn, host_batches, dev, seed=700,
                                                      make_batch=make)
            del model, fn
            torch.cuda.empty_cache()
    small = {"non-AR": _card_vs_cpu("gtm_v1", dev, batch=make(8, 64, seed=3),
                                    embedding_dim=16, hidden_dim=16),
             "AR": _card_vs_cpu("gtm_v1", dev, batch=make(8, 64, seed=3), embedding_dim=16,
                                hidden_dim=16, autoregressive=True)}
    for k, err in small.items():
        checks[f"small {k}: card vs CPU in f32"] = err <= F32_ATOL
    _emit({"phase": "forward_gtm_v1", **card, "model": "gtm_v1", "batch": B, "image": IMAGE,
           **GTM_V1_DIMS, "text_features": 768, "forwards": N_FWD, "runs": runs,
           "f32_card_vs_cpu_max_abs_err": small, "f32_tol": F32_ATOL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"forward_gtm_v1: {name}")


def _train_gtm_v1_phase(dev, card, zero_counts, counted):
    """Phase train_gtm_v1: the full-width gtm_v1's train step through
    ``Trainer``, then ``train_transformer.main`` and ``forecast_transformer
    --ckpt_path`` (see the module docstring)."""
    from visuelle2_tpu_torch.cli import forecast_transformer, train_transformer
    from visuelle2_tpu_torch.models import build
    from visuelle2_tpu_torch.train import loop

    make = _gtm_v1_batches()
    out = {}
    model = build("gtm_v1", device=dev, generator=torch.Generator().manual_seed(9),
                  image_dtype=torch.bfloat16, **GTM_V1_DIMS)
    trainer = loop.Trainer(model, loop.TrainConfig(grad_clip=0.5, learning_rate=TRAIN_LR))
    state = trainer.init_state()
    tower = {k: v.clone() for k, v in model.image_encoder.state_dict().items()}
    batches = [_to_device(make(B, IMAGE, seed=800 + i), dev) for i in range(8)]
    out["trainer"], prof = _measure_trainer(trainer, state, batches,
                                            model.image_encoder.backbone, zero_counts,
                                            counted["fused_gated_residual"])
    trainer_launches = {n: w.launches for n, w in counted.items()}
    after = model.image_encoder.state_dict()
    checks = {"finite losses (Trainer)": bool(np.isfinite(out["trainer"]["losses"]).all()),
              "no host sync in a train step": not out["trainer"]["host_syncs_in_a_step"],
              "no kernel launch (Trainer)": not any(trainer_launches.values()),
              "tower parameters and statistics bit-unchanged": all(
                  torch.equal(after[k], v) for k, v in tower.items()),
              "tower BatchNorm in eval mode": model.training
              and not model.image_encoder.backbone.training}
    out["trainer"]["tower_tensors"] = len(tower)
    del model, trainer, state, batches, prof, tower, after
    torch.cuda.empty_cache()

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        path = _write_train_split(tmp)
        out["dataset_setup_s"] = time.perf_counter() - t0
        ck = os.path.join(tmp, "ck")
        split = ["--dataset_path", path, "--device", dev.type, "--bf16_backbone",
                 "--batch_size", str(B), "--image_size", str(IMAGE)]
        zero_counts()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            best = train_transformer.main(split + [
                "--model", "gtm_v1", "--demand", "1", "--image_arch", "resnet50",
                "--epochs", str(TRAIN_EPOCHS), "--learning_rate", str(TRAIN_LR),
                "--ckpt_dir", ck])
        out["train_transformer"] = {"wall_s": time.perf_counter() - t0, "best": best,
                                    "launches": {n: w.launches for n, w in counted.items()},
                                    "tail": text.getvalue().strip().splitlines()[-2:]}
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "val_wWAPE" in r]
        with open(os.path.join(ck, "hparams.json")) as f:
            out["hparams"] = json.load(f)
        best_epoch = int(os.path.basename(best))
        logged = next(r["val_wWAPE"] for r in epochs if r["epoch"] == best_epoch)
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            r = forecast_transformer.main(split + ["--ckpt_path", best])
        out["forecast"] = {"best_epoch": best_epoch, "wape": r.wape, "logged_val_wWAPE": logged,
                           "rel_diff": abs(r.wape - logged) / abs(logged),
                           "num_forecasts": r.num_forecasts,
                           "launches": {n: w.launches for n, w in counted.items()}}
        out["epochs"] = epochs
    checks.update({
        "train_transformer: epochs logged": [r["epoch"] for r in epochs] == list(
            range(TRAIN_EPOCHS)),
        "train_transformer: finite losses": all(np.isfinite(r["train_loss"]) for r in epochs),
        "train_transformer: no kernel launch": not any(
            out["train_transformer"]["launches"].values()),
        "hparams.json: gtm_v1, hashed-crc32-v1": out["hparams"]["model"] == "gtm_v1" and
        out["hparams"]["text_fingerprint"] == "hashed-crc32-v1",
        "forecast --ckpt_path: WAPE": out["forecast"]["rel_diff"] <= TRAIN_WAPE_RTOL,
        "forecast --ckpt_path: no kernel launch": not any(out["forecast"]["launches"].values())})
    _emit({"phase": "train_gtm_v1", **card, "model": "gtm_v1", "batch": B, "image": IMAGE,
           **GTM_V1_DIMS, "bf16_backbone": True, "train_rows": TRAIN_ROWS,
           "test_rows": CLI_ROWS, "epochs": TRAIN_EPOCHS, "timing": TRAIN_TIMING, **out,
           "wape_rtol": TRAIN_WAPE_RTOL,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"train_gtm_v1: {name}")


def _legacy_inception_phase(dev, card, zero_counts, additive, additive_plain):
    """Phase legacy_inception: the InceptionV3 backbone, the legacy patch
    encoder and its additive attention through ``fused_additive_attention``
    at full width (see the module docstring).  Returns the numbers the
    kernels line gives row 3."""
    from visuelle2_tpu_torch.data.images import normalize_images
    from visuelle2_tpu_torch.models import legacy
    from visuelle2_tpu_torch.models.inception import InceptionV3Backbone
    from visuelle2_tpu_torch.models.registry import init_parameters
    from visuelle2_tpu_torch.ops.cuda import roofline

    def drawn(module, seed):
        init_parameters(module, torch.Generator().manual_seed(seed))
        return module.eval()

    out, checks = {}, {}
    images = torch.from_numpy(_synthetic_batch(B, IMAGE, seed=900)["images"]).to(dev)
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        net = drawn(InceptionV3Backbone(dtype=dtype), 0).to(dev)
        x = normalize_images(images, dtype).permute(0, 3, 1, 2)
        with torch.inference_mode():
            y = net(x)
            windows = [_cuda_ms(lambda: net(x), 4) for _ in range(3)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            net(x)
            torch.cuda.synchronize()
        out[label] = {"forward_ms": float(np.median(windows)), "forward_ms_windows": windows,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
        checks[f"{label}: [{B}, 2048, 8, 8], finite"] = tuple(y.shape) == (B, 2048, 8, 8) and \
            bool(torch.isfinite(y).all())
        del net, x, y
    # The backbone at a small batch on the card against the CPU, f32, no TF32.
    cpu_net = drawn(InceptionV3Backbone(), 1)
    card_net = drawn(InceptionV3Backbone(), 1).to(dev)
    small = images[:2].cpu()
    with torch.inference_mode():
        on_cpu = cpu_net(normalize_images(small).permute(0, 3, 1, 2))
        on_card = card_net(normalize_images(small.to(dev)).permute(0, 3, 1, 2)).cpu()
    out["f32_card_vs_cpu_max_abs_err"] = (on_card - on_cpu).abs().max().item()
    checks["backbone: card vs CPU in f32"] = out["f32_card_vs_cpu_max_abs_err"] <= F32_ATOL
    del cpu_net, card_net

    encoder = drawn(legacy.LegacyImageEncoder(LEGACY_DIM), 2).to(dev)
    attention = drawn(legacy.LegacyAdditiveAttention(LEGACY_DIM, LEGACY_DIM, LEGACY_DIM),
                      3).to(dev)
    hidden = torch.randn(B, LEGACY_DIM, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4)) * 0.5
    zero_counts()
    with torch.inference_mode():
        tokens = encoder(images)
        got = attention(tokens, hidden)
        torch.cuda.synchronize()
    launches = additive.launches
    args = attention.kernel_inputs(tokens, hidden)
    kw = {"weight_on": attention.weight_on}
    with torch.inference_mode():
        want = additive_plain(*args, **kw)
    err, ok = _additive_err(got, want)
    checks[f"encoder: [{B}, 64, {LEGACY_DIM}], finite"] = tuple(tokens.shape) == (
        B, 64, LEGACY_DIM) and bool(torch.isfinite(tokens).all())
    checks["attention: one wrapper call"] = launches == 1
    checks["attention: kernel vs plain within tolerance"] = ok
    with torch.inference_mode():
        per_kernel = _profiled_kernels_us(lambda: additive(*args, **kw))
        device_ms, call_ms = _kernel_vs_plain_times(additive, additive_plain, args, kw,
                                                    n_calls=50)
    n_bytes, flops = roofline.additive_attention_cost(B, 64, LEGACY_DIM, LEGACY_DIM,
                                                      LEGACY_DIM, attention.weight_on)
    bound_ms, bound_by = roofline.f32_accurate_bound_ms(n_bytes, flops)
    call = {"shape": {"B": B, "L": 64, "De": LEGACY_DIM, "Dd": LEGACY_DIM, "A": LEGACY_DIM,
                      "weight_on": attention.weight_on},
            "kernel_launches_per_call": _kernels_per_call(per_kernel),
            "kernel_device_us": 1e3 * device_ms["kernel"],
            "kernel_device_us_per_launch": _launch_split_us(per_kernel),
            "plain_device_us": 1e3 * device_ms["plain"],
            "kernel_call_us": 1e3 * call_ms["kernel"], "plain_call_us": 1e3 * call_ms["plain"],
            "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
            "bound_simt_f32_us": 1e3 * roofline.bound_ms(n_bytes, flops)[0]}
    checks["attention: at most 2 kernels a call"] = \
        call["kernel_launches_per_call"] <= ADDITIVE_MAX_LAUNCHES
    _emit({"phase": "legacy_inception", **card, "batch": B, "image": IMAGE,
           "embedding_dim": LEGACY_DIM, "backbone": out, "f32_tol": F32_ATOL,
           "attention": {"launches": launches, "max_abs_err": err, "atol": MHA_ATOL,
                         "rtol": MHA_RTOL, "call": call},
           "timing": "forward_ms: CUDA events over 4 calls on one batch, the median of 3 "
                     "windows; the attention's µs as additive_kernel_times",
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"legacy_inception: {name}: {err}")
    return {"launches": launches, "max_abs_err": err, "call": call}


def _run_all_phase(dev, card, zero_counts, counted):
    """Phase run_all: ``run_all.main`` on a small split (see the module
    docstring).  Returns each counted kernel's launches in the run."""
    from visuelle2_tpu_torch.cli import forecast_dl, forecast_stat, run_all, train_dl
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.pipeline import load_visuelle2
    from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    checks = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = make_synthetic_dataset(os.path.join(tmp, "d"), num_train=RUN_ALL_ROWS[0],
                                      num_test=RUN_ALL_ROWS[1], seed=0, write_images=False,
                                      rows_per_image=2)
        for split in ("train", "test"):
            paths = load_visuelle2(path, split, demand=True, output_len=12).image_paths
            unique, row_to_img = ImageStore.unique_paths(paths)
            pixels = np.random.default_rng(5).integers(
                0, 256, (len(unique), RUN_ALL_IMAGE, RUN_ALL_IMAGE, 3), dtype=np.uint8)
            ImageStore(pixels, row_to_img).write_cache(
                ImageStore.cache_path(path, split, RUN_ALL_IMAGE), paths)
        base = ["--dataset_path", path, "--batch_size", str(RUN_ALL_BATCH), "--image_arch",
                "tiny", "--image_size", str(RUN_ALL_IMAGE), "--device", dev.type]
        # Spies on the CLIs run_all chains: each training's returned
        # checkpoint and each forecast's --ckpt_path.
        trained, scored = [], []
        train_run, forecast_run = train_dl.run, forecast_dl.run

        def train_spy(args):
            best = train_run(args)
            trained.append(best)
            return best

        def forecast_spy(args, parser=None, argv=None):
            scored.append(args.ckpt_path)
            return forecast_run(args, parser, argv)

        train_dl.run, forecast_dl.run = train_spy, forecast_spy
        zero_counts()
        text = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(text):
                results = run_all.main(base + ["--epochs", "1", "--ckpt_root",
                                               os.path.join(tmp, "cks")])
        finally:
            train_dl.run, forecast_dl.run = train_run, forecast_run
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in counted.items()}
        alone = {}
        with contextlib.redirect_stdout(io.StringIO()):
            for method in ("naive", "ses", "holt"):
                alone[method] = forecast_stat.main(base + ["--method", method])
    printed = text.getvalue().strip().splitlines()[-1]
    tasks = ("so_fore_2_1", "so_fore_2_10", "demand")
    summary = {k: ({"wape": r.wape, "mae": r.mae, "num_forecasts": r.num_forecasts}
                   if k in tasks else list(r)) for k, r in results.items()}
    checks.update({
        "six results, printed": list(results) == [*tasks, "stat_naive", "stat_ses",
                                                  "stat_holt"]
        and printed.startswith("{'so_fore_2_1'"),
        "forecasts finite": all(np.isfinite([results[k].wape, results[k].mae]).all()
                                for k in tasks),
        "each forecast scored its training's checkpoint": len(trained) == 3
        and all(trained) and scored == trained,
        "stat results equal forecast_stat alone": all(
            tuple(results[f"stat_{m}"]) == tuple(v) for m, v in alone.items())})
    _emit({"phase": "run_all", **card, "rows": RUN_ALL_ROWS, "image": RUN_ALL_IMAGE,
           "batch": RUN_ALL_BATCH, "image_arch": "tiny", "epochs": 1, "results": summary,
           "stat_alone": alone, "checkpoints": trained, "wall_s": wall, "launches": launches,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"run_all: {name}: {summary}")
    return launches


def _serving_rates(fns, batches):
    """forecasts/s of each serving callable over ``batches`` (numpy in and
    out, copies included) by CUDA events, in turns (a, b, c, c, b, a).
    Returns ``{name: [rate, rate]}``."""
    names = list(fns)
    rates = {n: [] for n in names}
    for name in names + names[::-1]:
        fns[name](batches[0])  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for hb in batches:
            fns[name](hb)
        end.record()
        torch.cuda.synchronize()
        rows = len(batches) * len(batches[0]["mask"])
        rates[name].append(rows / (start.elapsed_time(end) / 1e3))
    return rates


def _spawn_server(root, artifact, dev, grace_s):
    """``cli.serve --artifact ... --http 0`` as a subprocess on the card;
    returns ``(process, queue of its output lines, None at the end)``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "visuelle2_tpu_torch.cli.serve", "--artifact", artifact,
         "--http", "0", "--device", dev.type, "--drain_grace_s", str(grace_s)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, lines


def _server_port(lines, seen):
    """The port the subprocess serves on, from its ``serving on :PORT``
    line; every line read goes into ``seen``."""
    deadline = time.monotonic() + SERVE_START_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        if line.startswith("serving on :"):
            return int(line.split(":")[1].split()[0])
    raise RuntimeError(f"artifact_serve: the server did not start: {seen[-20:]}")


def _artifact_serve_phase(dev, card, zero_counts, counted):
    """Phase artifact_serve: a full-width gated_v4 checkpoint exported into
    artifacts, loaded without it, scored, served over HTTP by a subprocess
    that drains on SIGTERM, and a pretrained backbone spliced in (see the
    module docstring).  Returns the launches of the served path's run."""
    import http.client
    import signal

    from visuelle2_tpu_torch.cli import export as export_cli
    from visuelle2_tpu_torch.cli import forecast_transformer, serve, train_transformer
    from visuelle2_tpu_torch.convert import to_jax_variables
    from visuelle2_tpu_torch.data.pipeline import load_label_dicts, load_norm_scalar
    from visuelle2_tpu_torch.eval.client import ForecastClient
    from visuelle2_tpu_torch.eval.export import (
        export_forecaster,
        load_forecaster,
        make_forecaster,
        quantize_int8,
    )
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.models.pretrained import (
        flatten_variables,
        load_backbone_npz,
        save_backbone_npz,
        splice_backbone,
    )
    from visuelle2_tpu_torch.models.registry import init_parameters
    from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS, ResNetBackbone
    from visuelle2_tpu_torch.train.checkpoint import CheckpointManager
    from visuelle2_tpu_torch.train.hparams import save_hparams
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    kernel = counted["fused_gated_residual"]
    root = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    out, checks, t_phase = {}, {}, time.perf_counter()
    proc = None
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path, _ = _write_cli_split(os.path.join(tmp, "d"))
        vocab = VocabSizes.from_dicts(*load_label_dicts(path))
        # The checkpoint: seeded full-width weights saved as train_transformer
        # saves them, with its manifest.
        model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(21),
                      vocab=vocab, image_arch=ARTIFACT_ARCH, image_dtype=torch.bfloat16)
        ck = os.path.join(tmp, "ck")
        CheckpointManager(ck, save_top_k=1).save(
            0, Trainer(model, TrainConfig()).init_state(), {"val_wWAPE": 0.0})
        targs = train_transformer.build_parser().parse_args(
            ["--model", "gated_v4", "--image_arch", ARTIFACT_ARCH])
        save_hparams(ck, train_transformer.hparams_of(targs, vocab, load_norm_scalar(path)))
        model.eval()

        # cli.export, float and int8, with no dataset but its label dicts.
        arts = {q: os.path.join(tmp, f"gated_v4_{q}.v2torch") for q in ("float", "int8")}
        for q, art in arts.items():
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                export_cli.main(["--model", "gated_v4", "--ckpt_path", ck, "--out", art,
                                 "--dataset_path", path, "--bf16_backbone",
                                 "--device", dev.type, "--image_arch", ARTIFACT_ARCH,
                                 "--batch_size", str(B), "--image_size", str(IMAGE),
                                 *(["--quantize", "int8"] if q == "int8" else [])])
            out[f"export_{q}_s"] = time.perf_counter() - t
            out[f"artifact_{q}_mb"] = os.path.getsize(art) / 1e6
        # The serving subprocess loads the float artifact meanwhile.
        proc, lines = _spawn_server(root, arts["float"], dev, grace_s=60)
        started = []
        try:
            # forecast_transformer --ckpt_path --export on the split (the model
            # path, dedup on: the artifact takes img_idx).
            art_cli = os.path.join(tmp, "gated_v4_cli.v2torch")
            split = ["--dataset_path", path, "--device", dev.type, "--image_size", str(IMAGE)]
            with contextlib.redirect_stdout(io.StringIO()):
                ft = forecast_transformer.main(split + [
                    "--ckpt_path", ck, "--bf16_backbone", "--batch_size", str(B),
                    "--export", art_cli])

            # load_forecaster on the card: the served path of this phase.
            zero_counts()
            forwards = 0
            loaded, headers = {}, {}
            for q, art in arts.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                loaded[q], headers[q] = load_forecaster(art, device=dev)
                torch.cuda.synchronize()
                out[f"load_{q}_s"] = time.perf_counter() - t
            out["quantized_arrays"] = headers["int8"]["quantized_arrays"]
            batches = [export_cli.synth_batch(B, IMAGE, vocab, demand=True, output_len=12,
                                              seed=700 + i) for i in range(ARTIFACT_TIMED_BATCHES)]
            direct, _ = make_forecaster(model, batches[0], device=dev)
            before = kernel.launches
            got = {q: fn(batches[0]) for q, fn in loaded.items()}
            forwards += 2
            checks["2 fused_gated_residual launches a forward through load_forecaster's fn"] = \
                kernel.launches - before == 4
            want = direct(batches[0])
            forwards += 1
            scale = float(np.abs(want).max())
            errs = {q: float(np.abs(got[q] - want).max()) / scale for q in got}
            out["forecast_absmax"] = scale
            out["max_err_share_of_absmax"] = errs
            checks["float artifact = make_forecaster"] = errs["float"] <= ARTIFACT_FLOAT_TOL
            checks["int8 artifact within 0.05 of max|forecast|"] = errs["int8"] <= ARTIFACT_INT8_TOL
            checks["finite [128, 12]"] = all(g.shape == (B, 12) and np.isfinite(g).all()
                                             for g in got.values())
            # The int8 artifact's weights on the card against a CPU (numpy)
            # dequantization of the checkpoint's int8 tree.
            stored, scales = quantize_int8(flatten_variables(to_jax_variables(model)))
            on_card = flatten_variables(to_jax_variables(loaded["int8"].model))
            same = [np.array_equal((stored[k].astype(np.float32) * scales[k]).view(np.uint32),
                                   on_card[k].view(np.uint32)) for k in scales]
            checks["int8 weights on the card = a CPU dequantization, bit for bit"] = \
                all(same) and len(same) == out["quantized_arrays"]
            rates = _serving_rates({"make_forecaster": direct, "load_forecaster": loaded["float"],
                                    "load_forecaster_int8": loaded["int8"]}, batches)
            forwards += 2 * 3 * (ARTIFACT_TIMED_BATCHES + 1)
            out["forecasts_per_s"] = rates
            out["timing"] = (f"CUDA events over {ARTIFACT_TIMED_BATCHES} distinct batches of "
                             f"{B} through each callable (numpy in and out, copies included), "
                             "after one warm-up call; in turns a, b, c, c, b, a")
            # cli.serve --artifact on the split: the forecast CLI's metrics.
            with contextlib.redirect_stdout(io.StringIO()):
                sv = serve.main(split + ["--artifact", art_cli])
            forwards += -(-CLI_ROWS // B)
            launches = {n: w.launches for n, w in counted.items()}
            checks["2 launches a forward on the served path"] = launches == {
                n: (2 * forwards if n == "fused_gated_residual" else 0) for n in counted}
            rel = {m: abs(sv[m] - getattr(ft, m)) / abs(getattr(ft, m)) for m in ("wape", "mae")}
            out["cli"] = {"forecast_transformer": {"wape": ft.wape, "mae": ft.mae},
                          "serve": {"wape": sv["wape"], "mae": sv["mae"],
                                    "forecasts_per_s": sv["rows"] / sv["seconds"]},
                          "rel_diff": rel}
            checks["cli.serve = forecast_transformer --ckpt_path"] = \
                max(rel.values()) <= ARTIFACT_METRIC_RTOL

            # A small Demand artifact: fused_additive_attention through
            # load_forecaster's fn, 3 launches a decode step.
            small = build("cross_attn_rnn_demand", device=dev,
                          generator=torch.Generator().manual_seed(22), vocab=vocab,
                          **ARTIFACT_DEMAND_DIMS)
            demand_batch = export_cli.synth_batch(B, ARTIFACT_DEMAND_IMAGE, vocab, demand=True,
                                                  output_len=12, seed=720)
            demand_art = os.path.join(tmp, "demand.v2torch")
            export_forecaster(small, demand_batch, demand_art)
            demand_fn, _ = load_forecaster(demand_art, device=dev)
            zero_counts()
            got_demand = demand_fn(demand_batch)
            demand_launches = {n: w.launches for n, w in counted.items()}
            want_demand, _ = make_forecaster(small, demand_batch, device=dev)
            want_demand = want_demand(demand_batch)
            out["demand"] = {"dims": ARTIFACT_DEMAND_DIMS, "image": ARTIFACT_DEMAND_IMAGE,
                             "launches": demand_launches,
                             "max_err_share_of_absmax": float(
                                 np.abs(got_demand - want_demand).max()
                                 / np.abs(want_demand).max())}
            checks["Demand artifact: 36 additive launches a forward"] = demand_launches == {
                n: (36 if n == "fused_additive_attention" else 0) for n in counted}
            checks["Demand artifact = make_forecaster"] = \
                out["demand"]["max_err_share_of_absmax"] <= ARTIFACT_FLOAT_TOL
            launches = {n: launches[n] + demand_launches[n] for n in counted}

            # HTTP: six concurrent requests through the port's client.
            port = _server_port(lines, started)
            client = ForecastClient(f"http://127.0.0.1:{port}", timeout=300)
            sizes = (1, 2, 3, 1, 2, 3)
            requests = [export_cli.synth_batch(n, IMAGE, vocab, demand=True, output_len=12,
                                               seed=800 + i) for i, n in enumerate(sizes)]
            replies = [None] * len(sizes)
            go = threading.Barrier(len(sizes))

            def post(i):
                go.wait(timeout=60)
                replies[i] = client.forecast(requests[i])

            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(sizes))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            health = client.health()
            def rel_err(req, reply):
                if reply is None or reply.shape != (len(req["mask"]), 12):
                    return float("inf")
                with torch.inference_mode():
                    d = model(_to_device(req, dev))[0].float().cpu().numpy()
                return float(np.abs(reply - d).max() / max(1.0, np.abs(d).max()))

            serve_errs = [rel_err(req, reply) for req, reply in zip(requests, replies)]
            out["http"] = {"requests": health["requests"], "dispatches": health["dispatches"],
                           "max_rel_err_vs_direct": max(serve_errs), "rtol": SERVE_RTOL,
                           "server_start": started[-2:]}
            checks["HTTP answers within SERVE_RTOL"] = max(serve_errs) <= SERVE_RTOL
            checks["HTTP requests counted"] = health["requests"] == len(sizes)
            checks["HTTP coalesced"] = health["dispatches"] < health["requests"]

            # A SIGTERM while a request is in flight: half its body sent, the
            # handler waiting for the rest.
            buf = io.BytesIO()
            np.savez(buf, **requests[2])
            body = buf.getvalue()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.putrequest("POST", "/forecast")
            conn.putheader("Content-Length", str(len(body)))
            conn.endheaders()
            conn.send(body[: len(body) // 2])
            deadline = time.monotonic() + 60
            while client.health()["inflight"] < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            time.sleep(1.0)
            try:
                client.health()
                refused = False
            except OSError:
                refused = True
            conn.send(body[len(body) // 2:])
            resp = conn.getresponse()
            drained = np.load(io.BytesIO(resp.read()))["forecast"] if resp.status == 200 else None
            code = proc.wait(timeout=120)
            tail = []
            while not lines.empty():
                line = lines.get()
                if line is not None:
                    tail.append(line)
            out["sigterm"] = {"in_flight_status": resp.status, "exit": code,
                              "new_connection_refused": refused, "tail": tail[-2:]}
            out["sigterm"]["in_flight_rel_err_vs_direct"] = rel_err(requests[2], drained)
            checks["SIGTERM: the in-flight request answered"] = \
                out["sigterm"]["in_flight_rel_err_vs_direct"] <= SERVE_RTOL
            checks["SIGTERM: no new connection"] = refused
            checks["SIGTERM: exit 143"] = code == 143
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)

        # The pretrained splice: a seeded ResNet-101 written by the port's
        # codec, spliced into the checkpoint's model on the card.
        bb = ResNetBackbone(STAGE_BLOCKS[ARTIFACT_ARCH])
        init_parameters(bb, torch.Generator().manual_seed(77))
        npz = os.path.join(tmp, "resnet101.npz")
        t = time.perf_counter()
        save_backbone_npz(to_jax_variables(bb), npz)
        out["npz_write_s"] = time.perf_counter() - t
        t = time.perf_counter()
        splice_backbone(model, load_backbone_npz(npz))
        torch.cuda.synchronize()
        out["splice_s"] = time.perf_counter() - t
        want_bb = flatten_variables(load_backbone_npz(npz))
        have_bb = flatten_variables(to_jax_variables(model.image_encoder.backbone))
        checks["spliced backbone = the npz"] = want_bb.keys() == have_bb.keys() and all(
            np.array_equal(want_bb[k], have_bb[k]) for k in want_bb)
        after = direct(batches[0])
        checks["spliced forecasts finite and changed"] = bool(np.isfinite(after).all()) and \
            not np.allclose(after, want)
    out["phase_s"] = time.perf_counter() - t_phase
    _emit({"phase": "artifact_serve", **card, "model": "gated_v4", "batch": B, "image": IMAGE,
           "bf16_backbone": True, "float_tol": ARTIFACT_FLOAT_TOL,
           "int8_tol": ARTIFACT_INT8_TOL, "metric_rtol": ARTIFACT_METRIC_RTOL,
           "launches": launches, "forwards": forwards, **out,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"artifact_serve: {name}")
    return launches


def _int8_conv_inputs(shape, n, gen, dev):
    """Seeded int8 conv inputs of a ``conv_launches`` shape at batch ``n``:
    codes (signed for the stem, its fourth channel zero as the engine pads
    it; else post-ReLU), weights, per-channel m and z that keep most
    outputs inside (0, 127), and the epilogue's operands: an addend for
    "requant_add", the block input's codes and a ratio for
    "requant_add_identity"."""
    from visuelle2_tpu_torch.models.quantized_resnet import STEM_CIN
    from visuelle2_tpu_torch.ops.cuda import int8_conv as ic

    h, w, cin, cout, k, stride, pad, epilogue = shape
    x = torch.randint(-127 if cin == STEM_CIN else 0, 128, (n, h, w, cin), generator=gen,
                      dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8)
    if cin == STEM_CIN:
        x[..., 3:] = 0
        wt[:, 3:] = 0
    m = (torch.rand(cout, generator=gen) + 0.5) * (60.0 / ((k * k * cin) ** 0.5 * 70 * 73))
    z = torch.rand(cout, generator=gen) * 40 - 10
    ho = ic.out_size(h, k, stride, pad)
    kw = dict(kernel=k, stride=stride, pad=pad, epilogue=epilogue)
    if epilogue == "requant_add":
        kw["addend"] = (torch.rand(n, ho, ho, cout, generator=gen) * 60 - 30).to(dev)
    elif epilogue == "requant_add_identity":
        kw["shortcut"] = torch.randint(0, 128, (n, ho, ho, cout), generator=gen,
                                       dtype=torch.int8).to(dev)
        kw["ratio"] = (torch.rand((), generator=gen) * 0.5 + 0.2).to(dev)
    return [t.to(dev) for t in (x, ic.pack_weight(wt), m, z)], kw


def _host_issue_ms(fn, batches):
    """The median over ``batches`` of the host's time to issue ``fn(b)`` onto
    an idle card (synchronized before each call, not after): near the call's
    CUDA-event time when the host's launches, not the card, bound it."""
    times = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(b)
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(times))


def _dedup_batch(d, seed):
    """A B-row gated_v4 batch over ceil(B / d) photos (d = 1: no img_idx)."""
    batch = _synthetic_batch(B, IMAGE, seed)
    if d > 1:
        n_img = -(-B // d)
        batch["images"] = batch["images"][:n_img]
        batch["img_idx"] = (np.arange(B) % n_img).astype(np.int32)
    return batch


def _w8a8_phase(dev, card, zero_counts, counted):
    """Phase w8a8: the int8 backbone on the card (see the module docstring).
    Returns the ``int8_conv`` row's numbers for the kernels line."""
    import collections
    import copy

    from visuelle2_tpu_torch.cli import forecast_transformer, serve
    from visuelle2_tpu_torch.data.images import normalize_images
    from visuelle2_tpu_torch.eval.export import load_forecaster, make_forecaster
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.models import quantized_resnet as qr
    from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS
    from visuelle2_tpu_torch.ops.cuda import int8_conv as ic
    from visuelle2_tpu_torch.ops.cuda import roofline

    conv, residual = counted["int8_conv"], counted["fused_gated_residual"]
    t_phase = time.perf_counter()
    out, checks = {}, {}
    launches = qr.conv_launches(STAGE_BLOCKS["resnet101"], IMAGE)
    per_forward = collections.Counter(c[1:] for c in launches)
    checks["104 conv launches a ResNet-101 forward"] = len(launches) == 104

    # The kernel against its plain version at the main path's batch (B=128)
    # on every distinct shape: the same int8 codes (float sums in the
    # downsample's epilogue); then each shape's times.
    gen = torch.Generator().manual_seed(13)
    errs, shapes = {}, {}
    with torch.inference_mode():
        for shape in sorted(per_forward):
            h, w, cin, cout, k, stride, pad, epilogue = shape
            args, kw = _int8_conv_inputs(shape, B, gen, dev)
            got = ic.int8_conv(*args, **kw)
            kernel_ms = _cuda_ms(lambda: ic.int8_conv(*args, **kw), W8A8_TIMED_CALLS)
            want = ic.int8_conv_plain(*args, **kw)
            plain_ms = _cuda_ms(lambda: ic.int8_conv_plain(*args, **kw), 1)
            errs[str(shape)] = (got.float() - want.float()).abs().max().item()
            checks[f"int8_conv {list(shape)} at B={B}: the plain version's values"] = \
                got.dtype == want.dtype and torch.equal(got, want)
            del got, want
            # The work on the image's 3 channels: the stem's fourth is zeros
            # that the engine adds for the kernel.
            work_cin = qr.IMAGE_CIN if cin == qr.STEM_CIN else cin
            n_bytes, ops = roofline.int8_conv_cost(B, h, w, work_cin, cout, k, stride, pad,
                                                   epilogue)
            b_ms, b_by = roofline.bound_ms(n_bytes, ops, "int8")
            row = {"launches_per_forward": per_forward[shape], "kernel_us": 1e3 * kernel_ms,
                   "plain_us": 1e3 * plain_ms, "bound_us": 1e3 * b_ms, "bound_by": b_by,
                   "bytes": n_bytes, "ops": ops, "int_mm_us": None}
            if k == 1 and stride == 1:
                x2d = args[0].reshape(-1, cin)
                wt = args[1][:, :cin].t().contiguous()
                torch._int_mm(x2d, wt)
                row["int_mm_us"] = 1e3 * _cuda_ms(lambda: torch._int_mm(x2d, wt),
                                                  W8A8_TIMED_CALLS)
            shapes[str(list(shape))] = row
            del args, kw
    max_err = max(errs.values())
    torch.cuda.empty_cache()

    def total(key, rows=None):
        return sum(r[key] * r["launches_per_forward"] for r in (rows or shapes.values()))

    one_by_one = [r for r in shapes.values() if r["int_mm_us"] is not None]
    fwd_bytes, fwd_ops = total("bytes"), total("ops")
    fwd_bound_ms, fwd_bound_by = roofline.bound_ms(fwd_bytes, fwd_ops, "int8")
    # The same forward's bound as the float32-addend design counted its work:
    # each identity shortcut a float32 addend.
    earlier_cost = []
    for _name, h, w, cin, cout, k, stride, pad, epilogue in launches:
        earlier_cost.append(roofline.int8_conv_cost(
            B, h, w, qr.IMAGE_CIN if cin == qr.STEM_CIN else cin, cout, k, stride, pad,
            "requant_add" if epilogue == "requant_add_identity" else epilogue))
    out["per_forward"] = {
        "kernel_ms": total("kernel_us") / 1e3, "plain_ms": total("plain_us") / 1e3,
        "bound_ms": fwd_bound_ms, "bound_by": fwd_bound_by,
        "bound_ms_float_addend_design": roofline.bound_ms(
            sum(b for b, _ in earlier_cost), sum(o for _, o in earlier_cost), "int8")[0],
        "sum_of_shape_bounds_ms": total("bound_us") / 1e3,
        "kernel_ms_on_1x1_stride1": total("kernel_us", one_by_one) / 1e3,
        "int_mm_ms_on_1x1_stride1": total("int_mm_us", one_by_one) / 1e3}

    # The full-width gated_v4, calibrated on 2 batches, through the serving
    # callable: the main path.
    model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(31),
                  vocab=VocabSizes(5, 6, 5, 126), image_dtype=torch.bfloat16,
                  image_arch="resnet101").eval()
    calib_batches = [_to_device(_synthetic_batch(B, IMAGE, seed=700 + i), dev)
                     for i in range(W8A8_CALIB_BATCHES)]
    t0 = time.perf_counter()
    qmodel, calib = qr.build_serving_path(model, calib_batches)
    out["calibrate_and_prepare_s"] = time.perf_counter() - t0
    checks["calibration covers every scale"] = len(calib) == 2 + 3 * 33
    host_batches = [_synthetic_batch(B, IMAGE, seed=710 + i) for i in range(N_FWD)]
    fn, _ = make_forecaster(qmodel, host_batches[0], device=dev)
    fn(host_batches[0])
    zero_counts()
    forecasts = [fn(b) for b in host_batches]
    main_counts = {name: w.launches for name, w in counted.items()}
    checks["104 int8_conv and 2 gated residual launches a forward"] = main_counts == {
        name: {"int8_conv": 104, "fused_gated_residual": 2}.get(name, 0) * N_FWD
        for name in counted}
    checks["finite [128, 12] forecasts"] = all(
        f.shape == (B, 12) and np.isfinite(f).all() for f in forecasts)
    with torch.inference_mode():
        ref = model(_to_device(host_batches[0], dev))[0].float().cpu().numpy()
    out["forecast_rel_l2_vs_bf16"] = float(np.linalg.norm(forecasts[0] - ref)
                                           / np.linalg.norm(ref))
    # Where the w8a8 forward's time goes (128 photos, as phase 6 for bf16).
    out["times"] = _forward_times(qmodel, fn, host_batches, dev, seed=730, kernel_groups={
        "int8_conv": ("int8_conv_kernel",)})
    by_op = out["times"]["forward_device_ms_by_op"]
    out["copy_and_mul_ms"] = by_op.get("aten::copy_", 0.0) + by_op.get("aten::mul", 0.0)
    checks[f"no shortcut pass: copy_ and mul under {W8A8_SHORTCUT_PASS_MS} ms a forward"] = \
        out["copy_and_mul_ms"] < W8A8_SHORTCUT_PASS_MS

    # The backbone on the card, at the main path's 128 photos, against the
    # CPU plain path from the same calibration on the first two of them: the
    # same codes (every op after calibration works photo by photo).
    photos = torch.from_numpy(host_batches[0]["images"])
    x = normalize_images(photos, torch.bfloat16).permute(0, 3, 1, 2)
    cpu_backbone = qr.W8A8Backbone(copy.deepcopy(model.image_encoder.backbone).cpu(), calib)
    with torch.inference_mode():
        on_card = qmodel.image_encoder.backbone(x.to(dev))[:W8A8_CHECK_BATCH].cpu()
        on_cpu = cpu_backbone(x[:W8A8_CHECK_BATCH])
    checks["backbone codes: card equal CPU"] = torch.equal(on_card, on_cpu)
    out["backbone_card_vs_cpu_max_abs_diff"] = (on_card.float() - on_cpu.float()).abs().max() \
        .item()
    del cpu_backbone

    # Forecasts/s: the w8a8 forward against the bf16 one, in turns, at each
    # image duplication of W8A8_DUPLICATIONS.
    rates = {}
    with torch.inference_mode():
        for d in W8A8_DUPLICATIONS:
            batches = [_to_device(_dedup_batch(d, seed=720 + i), dev)
                       for i in range(W8A8_TIMED_BATCHES)]
            ms, host_ms = {"bf16": [], "w8a8": []}, {"bf16": [], "w8a8": []}
            for name in ("bf16", "w8a8", "w8a8", "bf16"):
                m = model if name == "bf16" else qmodel
                host_ms[name].append(_host_issue_ms(m, batches))  # and the warm-up
                cycle = itertools.cycle(batches)
                ms[name].append(_cuda_ms(lambda: m(next(cycle)), 2 * len(batches)))
            rates[f"d={d}"] = {
                "photos": int(batches[0]["images"].shape[0]), "forward_ms": ms,
                "host_issue_ms": host_ms,
                "forecasts_per_s": {k: B / (np.mean(v) / 1e3) for k, v in ms.items()},
                "w8a8_over_bf16_speed": np.mean(ms["bf16"]) / np.mean(ms["w8a8"]),
                "w8a8_faster": max(ms["w8a8"]) < min(ms["bf16"])}
            del batches
    faster = [d for d in W8A8_DUPLICATIONS if rates[f"d={d}"]["w8a8_faster"]]
    out["forecasts_per_s"] = rates
    out["auto_max_duplication"] = {
        "measured": float(max(faster)) if faster else 0.0,
        "constant": qr.W8A8_AUTO_MAX_DUPLICATION,
        "rule": "the largest duplication at which every w8a8 window beat every bf16 one"}

    # The CLI: forecast_transformer --quantize w8a8 --export, the artifact
    # loaded and served, then --quantize auto.
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path, _ = _write_cli_split(tmp)
        art = os.path.join(tmp, "w8a8.v2torch")
        argv = ["--dataset_path", path, "--model", "gated_v4", "--demand", "1",
                "--output_len", "12", "--batch_size", str(B), "--image_size", str(IMAGE),
                "--bf16_backbone", "--device", dev.type]
        cli_out = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(cli_out):
            r = forecast_transformer.main(argv + ["--quantize", "w8a8",
                                                  "--calib_batches", "2", "--export", art])
        cli_counts = {name: w.launches for name, w in counted.items()}
        lines = cli_out.getvalue().splitlines()
        checks["cli: 104 int8_conv and 2 gated residual launches a forward"] = \
            conv.launches == 104 * r.forwards and \
            residual.launches == 2 * (r.forwards + W8A8_CALIB_BATCHES)  # and calibration's
        checks["cli: finite"] = bool(np.isfinite([r.wape, r.mae]).all()) and \
            r.num_forecasts == CLI_ROWS
        fn_art, header = load_forecaster(art, device=dev)
        zero_counts()
        example = {k: v.numpy() for k, v in next(iter(_cli_loader(path))).items()}
        fn_art(example)
        checks["artifact: 104 int8_conv launches a forward"] = conv.launches == 104 and \
            residual.launches == 2
        serve_out = io.StringIO()
        with contextlib.redirect_stdout(serve_out):
            s = serve.main(["--artifact", art, "--dataset_path", path, "--device", dev.type,
                            "--image_size", str(IMAGE)])
        checks["served artifact: the CLI's WAPE and MAE bits"] = (s["wape"], s["mae"]) == (
            r.wape, r.mae)
        auto_out = io.StringIO()
        with contextlib.redirect_stdout(auto_out):
            auto = forecast_transformer.main(argv + ["--quantize", "auto"])
        auto_line = [x for x in auto_out.getvalue().splitlines() if "[quantize auto]" in x]
        out["cli"] = {
            "wape": r.wape, "mae": r.mae, "num_forecasts": r.num_forecasts,
            "forwards": r.forwards, "launches": cli_counts,
            "split_forecasts_per_s": r.num_forecasts / r.split_seconds,
            "forecasts_per_s": r.forecasts_per_sec, "gflops_per_sample": r.gflops_per_sample,
            "lines": [x for x in lines if x.startswith("[w8a8]") or "Exported" in x],
            "artifact": {k: header.get(k) for k in ("quantize", "quantized_arrays")},
            "artifact_mb": os.path.getsize(art) / 1e6,
            "served": {"wape": s["wape"], "mae": s["mae"]},
            "auto": {"line": auto_line, "wape": auto.wape, "mae": auto.mae}}
    _emit({"phase": "w8a8", **card, "model": "gated_v4", "batch": B, "image": IMAGE,
           "backbone": "resnet101, bf16 model, w8a8 engine", "check_batch": W8A8_CHECK_BATCH,
           "kernel_vs_plain_max_abs_err": errs, "shapes_b128": shapes, **out,
           "timing": "kernel_us: CUDA events over 20 calls at B=128; plain_us: one call; "
                     "int_mm_us: torch._int_mm on the 1x1 stride-1 shapes' GEMM; "
                     "forward_ms: CUDA events over 8 forwards of 4 distinct device "
                     "batches, bf16 and w8a8 in turns",
           "launches_main_path": main_counts, "phase_s": time.perf_counter() - t_phase,
           "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"w8a8: {name}")
    del model, qmodel, fn, fn_art
    torch.cuda.empty_cache()
    return {"launches": main_counts["int8_conv"], "max_abs_err": max_err,
            "per_forward": out["per_forward"], "shapes": shapes,
            "launches_cli": cli_counts}


def _cli_loader(path):
    """The forecast CLI's test loader on ``path`` (eval dedup, B=128)."""
    from visuelle2_tpu_torch.cli import common, forecast_transformer

    args = forecast_transformer.build_parser().parse_args(
        ["--dataset_path", path, "--batch_size", str(B), "--image_size", str(IMAGE)])
    return common.build_loaders(args, demand=True, output_len=12, splits=("test",),
                                dedup_eval_images=True)[0]["test"]


def _data_plane_phase(dev, card, zero_counts, counted):
    """Phase data_plane: the native prefetch engine's effect on the scoring
    pass and on the train step, in turns with the numpy gather, and
    ``train_transformer --dedup_images 1`` (see the module docstring)."""
    from visuelle2_tpu_torch.cli import common, train_transformer
    from visuelle2_tpu_torch.cli.train_transformer import build_parser
    from visuelle2_tpu_torch.data.loader import BatchLoader
    from visuelle2_tpu_torch.eval.forecast import score_split
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.train import loop

    out, checks, seconds = {}, {}, {}
    t_phase = time.perf_counter()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = _write_train_split(tmp)
        seconds["dataset_setup"] = time.perf_counter() - t_phase
        argv = ["--dataset_path", path, "--model", "gated_v4", "--demand", "1",
                "--batch_size", str(B), "--image_size", str(IMAGE), "--bf16_backbone",
                "--device", dev.type, "--dedup_images", "0"]
        args = build_parser().parse_args(argv)
        loaders, vocab, norm = common.build_loaders(args, demand=True, output_len=12,
                                                    pin_memory=dev.type == "cuda")
        checks["loaders take the engine"] = all(
            ld._engine is not None for ld in loaders.values())

        def loader(split, native_prefetch):
            ld = loaders[split]
            return BatchLoader(ld.arrays, ld.images, B, shuffle=ld.shuffle,
                               drop_remainder=ld.drop_remainder,
                               pin_memory=dev.type == "cuda", native_prefetch=native_prefetch)

        model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(41),
                      vocab=vocab, image_dtype=torch.bfloat16, image_arch="resnet101")
        model.eval()
        scoring = {"numpy": [], "engine": []}
        wape = {}
        for native in DATA_PLANE_TURNS:
            r = score_split(model, loader("test", native), norm_scalar=norm,
                            measure_throughput=False)
            key = "engine" if native else "numpy"
            scoring[key].append(r.num_forecasts / r.split_seconds)
            wape[key] = (r.wape, r.mae)
        checks["scoring: the same metrics either way"] = wape["engine"] == wape["numpy"]
        out["scoring_split_forecasts_per_s"] = scoring
        seconds["scoring"] = time.perf_counter() - t_phase - sum(seconds.values())

        trainer = loop.Trainer(model, loop.TrainConfig(grad_clip=0.5, learning_rate=TRAIN_LR))
        state = trainer.init_state()
        steps = {"numpy": [], "engine": []}

        def epoch(ld, steps=None):
            n = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in ld:
                trainer.train_step(state, batch)
                n += 1
                if n == steps:
                    break
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        epoch(loader("train", True))  # warm-up
        for native in DATA_PLANE_TURNS:
            steps["engine" if native else "numpy"].append(epoch(loader("train", native)))
        idle = {}
        for native in (True, False):
            ld = loader("train", native)
            epoch(ld, DATA_PLANE_PROFILED_STEPS)  # the window starts in a steady state
            with _profile() as prof:
                ms = epoch(ld, DATA_PLANE_PROFILED_STEPS)
            busy = _device_us(prof) / 1e3 / DATA_PLANE_PROFILED_STEPS
            idle["engine" if native else "numpy"] = {
                "step_ms_profiled": ms, "device_busy_ms_per_step": busy,
                "device_idle_share": max(0.0, 1.0 - busy / ms)}
        out["train_step_ms_through_the_loader"] = steps
        out["train_idle"] = idle
        seconds["train"] = time.perf_counter() - t_phase - sum(seconds.values())

        # Unique-image training batches: the grouped sampler.
        dedup_args = build_parser().parse_args(argv[:-1] + ["1"])
        dedup_loader = common.build_loaders(dedup_args, demand=True, output_len=12,
                                            splits=("train",), dedup_train_images=True,
                                            pin_memory=dev.type == "cuda")[0]["train"]
        dedup_ms = [epoch(dedup_loader)]
        out["dedup_train"] = {
            "unique_image_slots": dedup_loader.unique_image_slots,
            "image_slots": dedup_loader.image_slots,
            "duplication": B / dedup_loader.unique_image_slots,
            "train_step_ms_through_the_loader": dedup_ms}
        del trainer, state, model
        torch.cuda.empty_cache()
        cli_out = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(cli_out):
            best = train_transformer.main(argv[:-1] + [
                "1", "--epochs", "1", "--learning_rate", str(TRAIN_LR), "--ckpt_dir",
                os.path.join(tmp, "ck")])
        out["dedup_train"]["cli_s"] = time.perf_counter() - t0
        metrics = [json.loads(x) for x in open(os.path.join(tmp, "ck", "metrics.jsonl"))]
        losses = [x["train_loss"] for x in metrics if "train_loss" in x]
        checks["dedup train_transformer: one finite epoch"] = bool(best) and len(losses) == 1 \
            and np.isfinite(losses[0])
        out["dedup_train"]["cli_metrics"] = metrics
    seconds["dedup"] = time.perf_counter() - t_phase - sum(seconds.values())
    out["phase_s"] = seconds
    _emit({"phase": "data_plane", **card, "model": "gated_v4", "batch": B, "image": IMAGE,
           "train_rows": TRAIN_ROWS, "test_rows": CLI_ROWS, "rows_per_image": 4,
           "timing": "scoring: rows over the host-clock seconds of score_split's pass "
                     "(one-pass, as the CLI picks); train: host clock over an epoch of "
                     "Trainer.train_step on the loader's batches, ended by a sync; each "
                     "mode in turns (numpy, engine, engine, numpy)",
           **out, "failed": sorted(k for k, ok in checks.items() if not ok)})
    for name, ok in checks.items():
        _require(ok, f"data_plane: {name}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == [TP_WORKER_FLAG]:
        return _tp_worker(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--tensor-parallel-cards"]:
        return tensor_parallel_cards(int(sys.argv[2]))
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.eval.server import drain_and_close, make_server
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops.cuda import _build, gru_seq, roofline
    from visuelle2_tpu_torch.ops.cuda.additive_attention import (
        fused_additive_attention as additive,
        fused_additive_attention_plain as additive_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.gated_fusion import (
        fused_gated_residual as kernel,
        fused_gated_residual_plain as plain,
    )
    from visuelle2_tpu_torch.ops.cuda.gated_fusion import launch_plan as kernel_plan
    from visuelle2_tpu_torch.ops.cuda.gated_mha import (
        fused_gated_mha as mha,
        fused_gated_mha_plain as mha_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.gated_mha import launch_plan as mha_plan
    from visuelle2_tpu_torch.ops.cuda.gru_seq import (
        cudnn_gru,
        fused_gru_sequence as gru_kernel,
        fused_gru_sequence_plain as gru_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.int8_conv import int8_conv
    from visuelle2_tpu_torch.ops.cuda.probe_gemm import (
        matmul_bf16,
        matmul_bf16_plain,
        matmul_int8,
        matmul_int8_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.read_reduce import read_reduce, read_reduce_plain
    from visuelle2_tpu_torch.ops.masks import gcd_block_mask
    from visuelle2_tpu_torch.perf import convfloor, convfloor_v2
    from visuelle2_tpu_torch.perf import roofline as harness_roofline

    counted = {"fused_gated_residual": kernel, "fused_gated_mha": mha,
               "fused_additive_attention": additive, "fused_gru_sequence": gru_kernel,
               "probe_matmul_bf16": matmul_bf16, "probe_matmul_int8": matmul_int8,
               "read_reduce": read_reduce, "int8_conv": int8_conv}

    def zero_counts():
        for wrapper in counted.values():
            wrapper.launches = 0

    dev = torch.device("cuda")
    _PHASE_MARK[0] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    card = {"card": smi}

    # 1. device ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    _emit({"phase": "device", **card, "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kernel_build_s": time.perf_counter() - t0,
           "library": os.path.relpath(_build.library_path())})

    # 2. gated residual vs plain ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    errs, same_bits = {}, {}
    for Bk, D, C in ((B, 32, 128), (37, 48, 96), (3, 64, 512), (1, 32, 128), (4096, 32, 128),
                     (8, 1024, 64), (B, 32, 0), (4, 256, 256), (5, 33, 7)):
        x, ctx = (torch.randn(Bk, n, device=dev, generator=gen) for n in (D, C))
        wx = torch.randn(D, D, device=dev, generator=gen) * 0.1
        wc = torch.randn(C, D, device=dev, generator=gen) * 0.1
        b = torch.randn(D, device=dev, generator=gen)
        key = f"{Bk}x{D}x{C}"
        for residual in (True, False):
            before = kernel.launches
            got = kernel(x, ctx, wx, wc, b, residual=residual)
            again = kernel(x, ctx, wx, wc, b, residual=residual)
            want = plain(x, ctx, wx, wc, b, residual=residual)
            torch.cuda.synchronize()
            _require(kernel.launches == before + 2, f"gated residual launch count at {key}")
            errs[f"{key}/residual={residual}"] = (got - want).abs().max().item()
            same_bits[key] = same_bits.get(key, True) and torch.equal(got, again)
    _emit({"phase": "kernel", "max_abs_err": errs, "tol": KERNEL_ATOL,
           "second_call_bit_identical": same_bits,
           "plan_main_path": kernel_plan(B, 32, 128, vec=4)})
    _require(max(errs.values()) <= KERNEL_ATOL, f"kernel disagrees with plain: {errs}")
    _require(all(same_bits.values()), f"gated residual: two calls differ: {same_bits}")

    # 3. gated MHA vs plain --------------------------------------------------------
    mha_errs, mha_bad, mha_same_bits = {}, [], {}
    for variant, (Bk, Lq, Lk, D, heads), masked, kv in (
            ("head", (B, 52, 52, 64, 4), True, "same"), ("head", (B, 52, 52, 64, 4), False, "same"),
            ("pure", (B, 1, 52, 64, 4), False, "same"), ("pure", (B, 12, 52, 64, 4), False, "same"),
            ("pure", (B, 52, 52, 64, 4), True, "same"),
            ("head", (37, 52, 52, 48, 4), True, "same"),
            ("pure", (37, 12, 52, 48, 4), False, "same"),
            ("pure", (37, 52, 52, 48, 4), True, "same"),
            # one CTA a row; 2, 8 and 16 heads (two a CTA) at D = 64; d = 12
            ("head", (B, 52, 52, 64, 1), True, "same"), ("head", (B, 52, 52, 64, 2), True, "same"),
            ("head", (B, 52, 52, 64, 8), True, "same"), ("head", (B, 52, 52, 64, 16), True, "same"),
            ("head", (16, 52, 52, 48, 4), True, "same"),
            ("head", (16, 100, 100, 64, 4), True, "same"),
            ("pure", (16, 12, 100, 64, 4), False, "same"),
            ("pure", (B, 1, 52, 64, 4), False, "distinct"),  # key and value two tensors
            ("head", (16, 52, 52, 64, 4), True, "equal"),   # equal data, three tensors
            ("pure", (2, 1, 1, 4096, 1), False, "distinct"),  # the unstaged layout
            ("pure", (16, 12, 52, 64, 4), False, "masked_row")):
        G = D // heads if variant == "head" else D
        query = torch.randn(Bk, Lq, D, device=dev, generator=gen)
        if kv == "same":
            key = value = query if Lq == Lk else torch.randn(Bk, Lk, D, device=dev, generator=gen)
        elif kv == "equal":
            key, value = query.clone(), query.clone()
        else:
            key, value = (torch.randn(Bk, Lk, D, device=dev, generator=gen) for _ in range(2))
        mask = gcd_block_mask(Lq, 12, device=dev) if masked else torch.zeros(Lq, Lk, device=dev)
        if kv == "masked_row":  # a query row with every key masked: NaN, as plain gives
            mask[5] = float("-inf")
        weights = []
        for n in (D, D, D, G, D):
            weights += [torch.randn(n, n, device=dev, generator=gen) * n ** -0.5,
                        torch.randn(n, device=dev, generator=gen) * 0.1]
        args = (query, key, value, mask, *weights)
        before = mha.launches
        got = mha(*args, num_heads=heads, variant=variant)
        again = mha(*args, num_heads=heads, variant=variant)
        want = mha_plain(*args, num_heads=heads, variant=variant)
        torch.cuda.synchronize()
        name = f"{variant}/{Bk}x{Lq}x{Lk}x{D}/{heads}h/{'gcd' if masked else 'unmasked'}/{kv}"
        _require(mha.launches == before + 2, f"gated MHA launch count at {name}")
        nan = torch.isnan(want)
        _require(torch.equal(torch.isnan(got), nan) and (kv == "masked_row") == bool(nan.any()),
                 f"gated MHA NaNs at {name}")
        mha_errs[name], ok = _mha_err(got[~nan], want[~nan])
        mha_same_bits[name] = torch.equal(got.nan_to_num(), again.nan_to_num())
        if not ok:
            mha_bad.append(name)
    _emit({"phase": "mha_kernel", "max_abs_err": mha_errs, "atol": MHA_ATOL,
           "rtol": MHA_RTOL, "second_call_bit_identical": mha_same_bits,
           "plans_main_path": {v: {k: p for k, p in mha_plan(B, Lq, 52, 64, 4, v, stage_k=Lq != 52,
                                                              stage_v=False).items()
                                   if k != "fields"}
                               for v, Lq in (("head", 52), ("pure", 1))}})
    _require(not mha_bad, f"gated MHA kernel disagrees with plain at {mha_bad}: {mha_errs}")
    _require(all(mha_same_bits.values()), f"gated MHA: two calls differ: {mha_same_bits}")

    # 4. full-width gated_v4 forward through the serving callable ------------------
    model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12,
                  image_arch="resnet101", image_dtype=torch.bfloat16)
    example = _synthetic_batch(B, IMAGE, seed=1)
    fn, header = make_forecaster(model, example, device=dev)
    captured = []
    hook = model.fusion.register_forward_pre_hook(
        lambda mod, args: captured.append(args) if not captured else None)
    host_batches = [_synthetic_batch(B, IMAGE, seed=10 + i) for i in range(N_FWD)]
    zero_counts()
    outs = [fn(hb) for hb in host_batches]
    launches, v4_mha_launches = kernel.launches, mha.launches
    hook.remove()
    for out in outs:
        _require(out.shape == (B, 12) and np.isfinite(out).all(),
                 f"forecast not finite [{B}, 12]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(launches == 2 * N_FWD, f"{launches} kernel launches in {N_FWD} forwards")
    _require(v4_mha_launches == 0, f"gated_v4 launched the gated MHA {v4_mha_launches}×")

    with torch.inference_mode():
        main_calls = _gate_inputs(model, *captured[0])
        fusion_err = 0.0
        for residual in (True, False):
            for call in main_calls:
                got, want = kernel(*call, residual=residual), plain(*call, residual=residual)
                fusion_err = max(fusion_err, (got - want).abs().max().item())
    _require(fusion_err <= KERNEL_ATOL, f"kernel vs plain on forward inputs: {fusion_err}")

    card_vs_cpu = _card_vs_cpu("gated_v4", dev)
    _emit({"phase": "forward", **card, "model": "gated_v4", "batch": B, "image": IMAGE,
           "forwards": N_FWD, "launches": launches, "launches_per_forward": launches / N_FWD,
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "fusion_inputs_max_abs_err": fusion_err,
           "f32_card_vs_cpu_max_abs_err": card_vs_cpu, "f32_tol": F32_ATOL})
    _require(card_vs_cpu <= F32_ATOL, f"port on card vs CPU in f32: {card_vs_cpu}")

    # 5. serving -----------------------------------------------------------------
    srv = make_server(fn, header, port=0)
    serve_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    serve_thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sizes = (1, 2, 3, 1, 2, 3)
    requests = [_synthetic_batch(n, IMAGE, seed=100 + i) for i, n in enumerate(sizes)]
    replies = [None] * len(sizes)
    go = threading.Barrier(len(sizes))

    def post(i):
        buf = io.BytesIO()
        np.savez(buf, **requests[i])
        req = urllib.request.Request(url + "/forecast", data=buf.getvalue(), method="POST")
        go.wait(timeout=60)
        with urllib.request.urlopen(req, timeout=300) as resp:
            with np.load(io.BytesIO(resp.read())) as z:
                replies[i] = z["forecast"]

    zero_counts()
    try:
        clients = [threading.Thread(target=post, args=(i,)) for i in range(len(sizes))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        _require(not any(c.is_alive() for c in clients), "a request did not finish")
        with urllib.request.urlopen(url + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        srv.shutdown()
        drain_and_close(srv)
        serve_thread.join(timeout=30)
    serve_launches = kernel.launches
    serve_errs = []
    with torch.inference_mode():
        for req, reply in zip(requests, replies):
            _require(reply is not None and reply.shape == (len(req["ts"]), 12),
                     "missing or misshapen reply")
            direct = model(_to_device(req, dev))[0].float().cpu().numpy()
            serve_errs.append(float(np.abs(reply - direct).max()
                                    / max(1.0, np.abs(direct).max())))
    _emit({"phase": "serve", **card, "requests": health["requests"],
           "dispatches": health["dispatches"], "launches": serve_launches,
           "max_rel_err_vs_direct": max(serve_errs), "rtol": SERVE_RTOL})
    _require(health["requests"] == len(sizes), f"health: {health}")
    _require(health["dispatches"] < health["requests"], f"no coalescing: {health}")
    _require(serve_launches == 2 * health["dispatches"],
             f"{serve_launches} launches in {health['dispatches']} dispatches")
    _require(max(serve_errs) <= SERVE_RTOL, f"served vs direct: {serve_errs}")

    # 6.–7. gated_v4 times, fused_gated_residual times ----------------------------
    v4_times = _forward_times(model, fn, host_batches, dev, seed=200)
    _emit({"phase": "times", **card, "model": "gated_v4", **v4_times})
    x, ctx, wx, wc, b = main_calls[1]
    with torch.inference_mode():
        device_ms, call_ms = _kernel_vs_plain_times(kernel, plain, (x, ctx, wx, wc, b), {})
    k_ms, p_ms = device_ms["kernel"], device_ms["plain"]
    Bm, D = x.shape
    C = ctx.shape[1]
    k_bytes, k_flops = roofline.gated_residual_cost(Bm, D, C)
    bound_ms, bound_by = roofline.f32_accurate_bound_ms(k_bytes, k_flops)
    bound_simt_ms = roofline.bound_ms(k_bytes, k_flops)[0]
    _emit({"phase": "kernel_times", **card,
           "kernel_shape": {"B": Bm, "D": D, "C": C},
           "kernel_device_us": 1e3 * k_ms, "plain_device_us": 1e3 * p_ms,
           "kernel_call_us": 1e3 * call_ms["kernel"], "plain_call_us": 1e3 * call_ms["plain"],
           "kernel_bytes": k_bytes, "kernel_flops": k_flops, "bound_us": 1e3 * bound_ms,
           "bound_simt_f32_us": 1e3 * bound_simt_ms,
           "library_ms": "none: no single PyTorch call computes this function"})
    del model, fn

    # 8. full-width gated_v2 forward through the serving callable ------------------
    model = build("gated_v2", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12,
                  image_arch="resnet101", image_dtype=torch.bfloat16)
    fn, _ = make_forecaster(model, example, device=dev)
    attn_mods = _gated_mha_modules(model)
    attn_calls = [None] * len(attn_mods)

    def capture(i):
        def hook(mod, args, kwargs):
            if attn_calls[i] is None:
                attn_calls[i] = mod.kernel_inputs(*args, mask=kwargs.get("mask"))
        return hook

    hooks = [m.register_forward_pre_hook(capture(i), with_kwargs=True)
             for i, m in enumerate(attn_mods)]
    zero_counts()
    outs = [fn(hb) for hb in host_batches]
    mha_launches, v2_residual_launches = mha.launches, kernel.launches
    for h in hooks:
        h.remove()
    for out in outs:
        _require(out.shape == (B, 12) and np.isfinite(out).all(),
                 f"gated_v2 forecast not finite [{B}, 12]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(mha_launches == 3 * N_FWD,
             f"{mha_launches} gated MHA launches in {N_FWD} gated_v2 forwards")
    _require(v2_residual_launches == 0,
             f"gated_v2 launched the gated residual {v2_residual_launches}×")
    variants = [m.variant for m in attn_mods]
    with torch.inference_mode():
        attn_errs = {}
        for i, (args, variant) in enumerate(zip(attn_calls, variants)):
            got = mha(*args, num_heads=attn_mods[i].num_heads, variant=variant)
            want = mha_plain(*args, num_heads=attn_mods[i].num_heads, variant=variant)
            attn_errs[f"call{i}/{variant}"], ok = _mha_err(got, want)
            _require(ok, f"gated MHA vs plain on forward inputs: {attn_errs}")
    v2_card_vs_cpu = _card_vs_cpu("gated_v2", dev)
    _emit({"phase": "forward_v2", **card, "model": "gated_v2", "batch": B, "image": IMAGE,
           "forwards": N_FWD, "launches": mha_launches,
           "launches_per_forward": mha_launches / N_FWD,
           "attention_shapes": [list(a[0].shape) + [a[1].shape[1]] for a in attn_calls],
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "attention_inputs_max_abs_err": attn_errs,
           "f32_card_vs_cpu_max_abs_err": v2_card_vs_cpu, "f32_tol": F32_ATOL})
    _require(v2_card_vs_cpu <= F32_ATOL, f"gated_v2 on card vs CPU in f32: {v2_card_vs_cpu}")

    # 9.–10. gated_v2 times, fused_gated_mha times per variant ---------------------
    _emit({"phase": "times_v2", **card, "model": "gated_v2",
           **_forward_times(model, fn, host_batches, dev, seed=300)})
    per_variant = {}
    with torch.inference_mode():
        for i in (0, 2):  # trend-encoder layer 0 ("head"), decoder ("pure")
            args, variant = attn_calls[i], variants[i]
            kw = dict(num_heads=attn_mods[i].num_heads, variant=variant)
            device_ms, call_ms = _kernel_vs_plain_times(mha, mha_plain, args, kw,
                                                        n_calls=PROFILE_CALLS)
            (Bm, Lq, D), Lk = args[0].shape, args[1].shape[1]
            _require(args[1] is args[2], "key and value are one tensor on the main path")
            n_bytes, flops = roofline.gated_mha_cost(
                Bm, Lq, Lk, D, **kw, self_attention=args[0] is args[1])
            v_bound_ms, v_bound_by = roofline.f32_accurate_bound_ms(n_bytes, flops)
            per_variant[variant] = {
                "shape": {"B": args[0].shape[0], "Lq": args[0].shape[1],
                          "Lk": args[1].shape[1], "D": args[0].shape[2], "heads": kw["num_heads"]},
                "launches_per_forward": variants.count(variant),
                "kernel_device_us": 1e3 * device_ms["kernel"],
                "plain_device_us": 1e3 * device_ms["plain"],
                "kernel_call_us": 1e3 * call_ms["kernel"],
                "plain_call_us": 1e3 * call_ms["plain"],
                "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * v_bound_ms,
                "bound_by": v_bound_by,
                "bound_simt_f32_us": 1e3 * roofline.bound_ms(n_bytes, flops)[0]}
    _emit({"phase": "mha_kernel_times", **card, "variants": per_variant,
           "library_ms": "none: no single PyTorch call computes the gated epilogue"})
    # The kernels line gives one launch's numbers averaged over a forward's
    # mix of launches (two "head", one "pure").
    mix = lambda key: sum(v["launches_per_forward"] * v[key] for v in per_variant.values()) \
        / sum(v["launches_per_forward"] for v in per_variant.values()) / 1e3
    mix_bytes = sum(v["launches_per_forward"] * v["bytes"] for v in per_variant.values())
    mix_flops = sum(v["launches_per_forward"] * v["flops"] for v in per_variant.values())

    del model, fn

    # 11. additive attention vs plain -----------------------------------------------
    add_errs, add_bad, add_launch_us, add_kernels_per_call = {}, [], {}, {}
    for shape in ((B, 100, 512, 512, 512), (B, 52, 512, 512, 512), (B, 4, 512, 512, 512),
                  (37, 13, 48, 40, 24), (5, 2, 16, 20, 16)):
        Bk, L, De, Dd, A = shape
        args = (torch.randn(Bk, L, De, device=dev, generator=gen),
                torch.randn(Bk, Dd, device=dev, generator=gen),
                torch.randn(De, A, device=dev, generator=gen) * De ** -0.5,
                torch.randn(Dd, A, device=dev, generator=gen) * Dd ** -0.5,
                torch.randn(A, 1, device=dev, generator=gen) * A ** -0.5,
                torch.randn(1, device=dev, generator=gen))
        for weight_on in ("inputs", "projected"):
            got = additive(*args, weight_on=weight_on)
            want = additive_plain(*args, weight_on=weight_on)
            torch.cuda.synchronize()
            key = f"{Bk}x{L}x{De}x{Dd}x{A}/{weight_on}"
            add_errs[key], ok = _additive_err(got, want)
            if not ok:
                add_bad.append(key)
            per_kernel = _profiled_kernels_us(lambda: additive(*args, weight_on=weight_on))
            add_kernels_per_call[key] = _kernels_per_call(per_kernel)
            if Bk == B:
                add_launch_us[key] = _launch_split_us(per_kernel)
    _emit({"phase": "additive_kernel", **card, "max_abs_err": add_errs, "atol": MHA_ATOL,
           "rtol": MHA_RTOL, "kernels_per_call": add_kernels_per_call,
           "device_us_per_launch": add_launch_us})
    _require(not add_bad, f"additive attention disagrees with plain at {add_bad}: {add_errs}")
    _require(max(add_kernels_per_call.values()) <= ADDITIVE_MAX_LAUNCHES,
             f"additive attention launched more than {ADDITIVE_MAX_LAUNCHES} kernels a call: "
             f"{add_kernels_per_call}")

    # 11b. the legacy InceptionV3 encoder and its additive attention (L = 64) --
    legacy_attn = _legacy_inception_phase(dev, card, zero_counts, additive, additive_plain)

    # 12. GRU sequence vs plain and cuDNN ---------------------------------------------
    gru_errs = {}
    for (Bk, T, I, H), atol in (((B, 52, 3, 512), GRU_ATOL_FULL), ((37, 9, 5, 24), GRU_ATOL_SMALL),
                                ((150, 6, 4, 200), GRU_ATOL_SMALL),
                                ((300, 4, 3, 512), GRU_ATOL_FULL)):
        bound = H ** -0.5
        x = torch.rand(Bk, T, I, device=dev, generator=gen)
        w = [(torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * bound
             for shape in ((I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
        h0 = torch.randn(Bk, H, device=dev, generator=gen) * 0.5
        outs, h_last = gru_kernel(x, *w, h0)
        again, again_h = gru_kernel(x, *w, h0)
        want, want_h = gru_plain(x, *w, h0)
        library = cudnn_gru(*w)
        with torch.inference_mode():
            lib, lib_h = library(x, h0[None])
        torch.cuda.synchronize()
        key = f"{Bk}x{T}x{I}x{H}"
        gru_errs[key] = {
            "vs_plain": max((outs - want).abs().max().item(),
                            (h_last - want_h).abs().max().item()),
            "vs_cudnn": max((outs - lib).abs().max().item(),
                            (h_last - lib_h[0]).abs().max().item()),
            "atol": atol,
            "second_call_bit_identical": torch.equal(outs, again) and torch.equal(h_last, again_h)}
        _require(max(gru_errs[key]["vs_plain"], gru_errs[key]["vs_cudnn"]) <= atol,
                 f"GRU kernel disagrees at {key}: {gru_errs[key]}")
        _require(gru_errs[key]["second_call_bit_identical"],
                 f"GRU kernel: two calls on the same inputs differ at {key}")
    _emit({"phase": "gru_kernel", "max_abs_err": gru_errs})

    # 12b. the GRU kernel's streamed layout, past H = 724 ---------------------------
    wide_errs, wide_us = {}, {}
    for H in GRU_WIDE:
        Bk, T, I = B, 8, 64
        x = torch.rand(Bk, T, I, device=dev, generator=gen)
        w = [(torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * H ** -0.5
             for shape in ((I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
        h0 = torch.randn(Bk, H, device=dev, generator=gen) * 0.5
        before = gru_kernel.launches
        outs, h_last = gru_kernel(x, *w, h0)
        again, again_h = gru_kernel(x, *w, h0)
        want, want_h = gru_plain(x, *w, h0)
        torch.cuda.synchronize()
        key = f"{Bk}x{T}x{I}x{H}"
        wide_errs[key] = {
            "vs_plain": max((outs - want).abs().max().item(),
                            (h_last - want_h).abs().max().item()),
            "launches_per_call": (gru_kernel.launches - before) / 2,
            "second_call_bit_identical": torch.equal(outs, again) and torch.equal(h_last, again_h)}
        _require(wide_errs[key]["vs_plain"] <= GRU_ATOL_FULL and
                 wide_errs[key]["second_call_bit_identical"] and
                 wide_errs[key]["launches_per_call"] == 1,
                 f"GRU kernel's streamed layout at {key}: {wide_errs[key]}")
        if H == 1024:
            library = cudnn_gru(*w)
            with torch.inference_mode():
                per_kernel = _profiled_kernels_us(lambda: gru_kernel(x, *w, h0))
                lib_device_ms, _ = _call_times({"library": lambda: library(x, h0[None])},
                                               n_calls=50)
            recurrence = [us for name, (_, us) in per_kernel.items() if GRU_KERNEL_NAME in name]
            _require(recurrence, f"the profiler saw no {GRU_KERNEL_NAME} kernel at {key}")
            cost = roofline.gru_sequence_cost(Bk, T, H)
            wide_us = {"shape": key, "recurrence_device_us": recurrence[0],
                       "library_device_us": 1e3 * lib_device_ms["library"],
                       "bound_us": 1e3 * roofline.f32_accurate_bound_ms(*cost)[0],
                       "bound_simt_f32_us": 1e3 * roofline.bound_ms(*cost)[0]}
    _emit({"phase": "gru_wide", **card, "max_abs_err": wide_errs, "atol": GRU_ATOL_FULL,
           "times": wide_us})

    # 13. full-width CrossAttnRNN Demand through the serving callable --------------
    model = build("cross_attn_rnn_demand", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), out_len=12, image_arch="resnet101",
                  image_dtype=torch.bfloat16, **CROSS_ATTN_DIMS)
    fn, _ = make_forecaster(model, example, device=dev)
    add_mods = _attention_modules(model)
    add_calls = [None] * len(add_mods)

    def capture_last(i):
        def hook(mod, args):
            add_calls[i] = mod.kernel_inputs(*args)  # the last decode step's inputs
        return hook

    hooks = [m.register_forward_pre_hook(capture_last(i)) for i, m in enumerate(add_mods)]
    zero_counts()
    outs = [fn(hb) for hb in host_batches]
    add_launches, demand_gru_launches = additive.launches, gru_kernel.launches
    other_launches = kernel.launches + mha.launches
    for h in hooks:
        h.remove()
    for out in outs:
        _require(out.shape == (B, 12, 1) and np.isfinite(out).all(),
                 f"Demand forecast not finite [{B}, 12, 1]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(add_launches == 36 * N_FWD,
             f"{add_launches} additive attention launches in {N_FWD} Demand forwards")
    _require(demand_gru_launches == 0 and other_launches == 0,
             f"Demand launched other kernels: GRU {demand_gru_launches}, {other_launches}")
    demand_attn = {"seed 0": _demand_attention_check(add_mods, add_calls, additive,
                                                     additive_plain)}
    # The same check on a second Demand, its weights and batch from another seed.
    other = build("cross_attn_rnn_demand", device=dev,
                  generator=torch.Generator().manual_seed(1), vocab=VocabSizes(5, 6, 5, 126),
                  out_len=12, image_arch="resnet101", image_dtype=torch.bfloat16,
                  **CROSS_ATTN_DIMS)
    other_mods = _attention_modules(other)
    other_calls = [None] * len(other_mods)

    def capture_other(i):
        def hook(mod, args):
            other_calls[i] = mod.kernel_inputs(*args)
        return hook

    hooks = [m.register_forward_pre_hook(capture_other(i)) for i, m in enumerate(other_mods)]
    with torch.inference_mode():
        other(_to_device(_synthetic_batch(B, IMAGE, seed=21), dev))
    for h in hooks:
        h.remove()
    demand_attn["seed 1"] = _demand_attention_check(other_mods, other_calls, additive,
                                                    additive_plain)
    del other, other_mods, other_calls
    demand_card_vs_cpu = _card_vs_cpu("cross_attn_rnn_demand", dev, attention_dim=64,
                                      embedding_dim=64, hidden_dim=64)
    _emit({"phase": "forward_demand", **card, "model": "cross_attn_rnn_demand", "batch": B,
           "image": IMAGE, **CROSS_ATTN_DIMS, "forwards": N_FWD, "launches": add_launches,
           "launches_per_forward": add_launches / N_FWD,
           "attention_shapes": [list(a[0].shape) + [a[1].shape[1]] for a in add_calls],
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "attention_inputs": demand_attn, "attention_max_tolerance_share": DEMAND_ATTN_MAX_SHARE,
           "f32_card_vs_cpu_max_abs_err": demand_card_vs_cpu, "f32_tol": F32_ATOL})
    _require(demand_card_vs_cpu <= F32_ATOL, f"Demand on card vs CPU in f32: {demand_card_vs_cpu}")

    # 14. the same forecaster with the trend GRU on its kernel path ----------------
    trend_gru = model.static.trend_encoder.gru
    trend_gru.use_kernel = True
    zero_counts()
    gru_outs = [fn(hb) for hb in host_batches]
    gru_path_launches, gru_path_additive = gru_kernel.launches, additive.launches
    gru_vs_loop = max(float(np.abs(a - b).max()) for a, b in zip(gru_outs, outs))
    _require(gru_path_launches == N_FWD and gru_path_additive == 36 * N_FWD,
             f"GRU kernel path: {gru_path_launches} GRU and {gru_path_additive} additive "
             f"launches in {N_FWD} forwards")
    dev_batch = _to_device(host_batches[0], dev)
    path_ms = {"step_loop": [], "kernel": []}
    with torch.inference_mode():
        for use_kernel in (False, True, True, False):  # in turns
            trend_gru.use_kernel = use_kernel
            model(dev_batch)
            path_ms["kernel" if use_kernel else "step_loop"].append(
                _cuda_ms(lambda: model(dev_batch), 5))
    trend_gru.use_kernel = False
    _emit({"phase": "forward_demand_gru", **card, "launches": gru_path_launches,
           "launches_per_forward": gru_path_launches / N_FWD,
           "forecast_max_abs_diff_vs_step_loop": gru_vs_loop, "forward_ms": path_ms})
    # The forecasts go through a bf16 backbone either way; the GRU's two paths
    # differ by f32 rounding only.
    _require(gru_vs_loop <= F32_ATOL, f"GRU kernel path vs step loop: {gru_vs_loop}")

    # 15. CrossAttnRNN 2-1 and 2-10 on the card vs the CPU -------------------------
    window_errs, window_launches = {}, {}
    for name, extra, per_forward in (("cross_attn_rnn_21", {}, 3),
                                     ("cross_attn_rnn_210", {"out_len": 10}, 30)):
        zero_counts()
        window_errs[name] = _card_vs_cpu(name, dev, batch=_stfore_batch(8, 64, seed=4),
                                         attention_dim=48, embedding_dim=64, hidden_dim=64,
                                         **extra)
        window_launches[name] = additive.launches
        _require(additive.launches == per_forward,
                 f"{name}: {additive.launches} additive launches in one forward")
        _require(window_errs[name] <= F32_ATOL, f"{name} on card vs CPU: {window_errs[name]}")
    _emit({"phase": "forward_rnn_21_210", **card, "launches_per_forward": window_launches,
           "f32_card_vs_cpu_max_abs_err": window_errs, "f32_tol": F32_ATOL})

    # 16.–18. Demand times, additive attention times, GRU times ---------------------
    demand_times = _forward_times(model, fn, host_batches, dev, seed=400, kernel_groups={
        "fused_additive_attention": ADDITIVE_KERNEL_NAMES})
    _emit({"phase": "times_demand", **card, "model": "cross_attn_rnn_demand", **demand_times})

    # 16a. the full-width gtm_v1 through the serving callable ---------------------
    _forward_gtm_v1_phase(dev, card, zero_counts, counted)

    # 16b. the forecast CLIs on a full-width split --------------------------------
    cli_launches = _forecast_cli_phase(
        dev, card, zero_counts, counted,
        forward_rates={"gated_v4": v4_times["forecasts_per_s"],
                       "cross_attn_rnn_demand": demand_times["forecasts_per_s"]},
        forward_busy_ms={"gated_v4": v4_times["forward_device_busy_ms"],
                         "cross_attn_rnn_demand": demand_times["forward_device_busy_ms"]})
    # 16b'. the statistical baselines through forecast_stat -----------------------
    _stats_phase(dev, card, zero_counts, counted)

    # 16c.–16e. training: the kernels under autograd, card vs CPU, full width ------
    train_kernel_err = _train_kernel_phase(dev, card, kernel, plain, mha, mha_plain,
                                           gcd_block_mask)
    _train_parity_phase(dev, card, kernel)
    train_launches = _train_phase(dev, card, zero_counts, counted)
    # 16e''. data parallelism: one NCCL rank against the plain Trainer, two
    # gloo ranks of the demo against one process --------------------------------
    dp_launches = _data_parallel_phase(dev, card, zero_counts, counted)
    # 16l. tensor parallelism: two gloo ranks of a data=1 x model=2 mesh on
    # this card against one process, gated_v4 at full width and 2-10 ---------
    tp_launches = _tensor_parallel_phase(dev, card, counted)
    # 16j. the data plane: the prefetch engine in turns, dedup training ----------
    _data_plane_phase(dev, card, zero_counts, counted)
    # 16e'. serving from an artifact: export, load, score, HTTP, SIGTERM, splice
    artifact_launches = _artifact_serve_phase(dev, card, zero_counts, counted)
    # 16k. the w8a8 int8 backbone: the kernel, the serving path, the CLI ---------
    w8a8 = _w8a8_phase(dev, card, zero_counts, counted)

    # 16f.–16h. CrossAttnRNN training: the two kernels under autograd, card vs
    # CPU, full-width Demand -------------------------------------------------------
    train_add_err, train_add_times = _train_additive_phase(
        dev, card, additive, additive_plain, gru_kernel, gru_plain)
    parity_launches = _train_demand_parity_phase(dev, card, additive)
    demand_train_launches = _train_demand_phase(dev, card, zero_counts, counted)
    # 16i. gtm_v1 training: Trainer, train_transformer, forecast --ckpt_path -----
    _train_gtm_v1_phase(dev, card, zero_counts, counted)

    per_call = {}
    with torch.inference_mode():
        for mod, args in zip(add_mods, add_calls):
            kw = dict(weight_on=mod.weight_on)
            # 50 calls: the profiler dropped kernels over 200 calls (800 launches).
            device_ms, call_ms = _kernel_vs_plain_times(additive, additive_plain, args, kw,
                                                        n_calls=50)
            per_kernel = _profiled_kernels_us(lambda: additive(*args, **kw))
            (Bm, L, De), (Dd, A) = args[0].shape, args[3].shape
            n_bytes, flops = roofline.additive_attention_cost(Bm, L, De, Dd, A, mod.weight_on)
            c_bound_ms, c_bound_by = roofline.f32_accurate_bound_ms(n_bytes, flops)
            per_call[f"L={L}"] = {
                "shape": {"B": Bm, "L": L, "De": De, "Dd": Dd, "A": A,
                          "weight_on": mod.weight_on},
                "launches_per_forward": model.out_len,
                "kernel_launches_per_call": _kernels_per_call(per_kernel),
                "kernel_device_us": 1e3 * device_ms["kernel"],
                "kernel_device_us_per_launch": _launch_split_us(per_kernel),
                "plain_device_us": 1e3 * device_ms["plain"],
                "kernel_call_us": 1e3 * call_ms["kernel"],
                "plain_call_us": 1e3 * call_ms["plain"],
                "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * c_bound_ms,
                "bound_by": c_bound_by,
                "bound_simt_f32_us": 1e3 * roofline.bound_ms(n_bytes, flops)[0]}
            _require(per_call[f"L={L}"]["kernel_launches_per_call"] <= ADDITIVE_MAX_LAUNCHES,
                     f"additive attention at L={L}: {per_call[f'L={L}']}")
    _emit({"phase": "additive_kernel_times", **card, "calls": per_call,
           "library_ms": "none: no single PyTorch call computes additive attention"})
    add_mix = lambda key: sum(v[key] for v in per_call.values()) / len(per_call) / 1e3
    add_mix_bound = roofline.f32_accurate_bound_ms(sum(v["bytes"] for v in per_call.values()),
                                                   sum(v["flops"] for v in per_call.values()))

    # The trend GRU's own weights and input, as the kernel path runs them.
    gru_x = dev_batch["gtrends"].transpose(1, 2).contiguous()
    gru_w = (trend_gru.w_i, trend_gru.w_h, trend_gru.b_i, trend_gru.b_h)
    library = cudnn_gru(*gru_w)
    with torch.inference_mode():
        gru_device_ms, gru_call_ms = _call_times(
            {"kernel": lambda: gru_kernel(gru_x, *gru_w),
             "plain": lambda: gru_plain(gru_x, *gru_w),
             "library": lambda: library(gru_x)}, n_calls=GRU_TIMED_CALLS)
        with _profile() as prof:
            for _ in range(PROFILE_CALLS):
                gru_kernel(gru_x, *gru_w)
            torch.cuda.synchronize()
    recurrence = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and GRU_KERNEL_NAME in e.key and e.count]
    _require(recurrence, f"the profiler saw no {GRU_KERNEL_NAME} kernel")
    # Per kernel record: the profiler can drop records in a short window.
    steps_us = (sum(e.self_device_time_total for e in recurrence)
                / sum(e.count for e in recurrence))
    Bg, Tg, _ = gru_x.shape
    Hg = trend_gru.hidden_dim
    gru_bytes, gru_flops = roofline.gru_sequence_cost(Bg, Tg, Hg)
    gru_bound_ms, gru_bound_by = roofline.f32_accurate_bound_ms(gru_bytes, gru_flops)
    gru_bound_simt_ms = roofline.bound_ms(gru_bytes, gru_flops)[0]
    _emit({"phase": "gru_kernel_times", **card,
           "shape": {"B": Bg, "T": Tg, "I": gru_x.shape[2], "H": Hg},
           "kernel_device_us": 1e3 * gru_device_ms["kernel"],
           "kernel_recurrence_device_us": steps_us,
           "kernel_recurrence_records": sum(e.count for e in recurrence),
           "plain_device_us": 1e3 * gru_device_ms["plain"],
           "library_device_us": 1e3 * gru_device_ms["library"],
           "kernel_call_us": 1e3 * gru_call_ms["kernel"],
           "plain_call_us": 1e3 * gru_call_ms["plain"],
           "library_call_us": 1e3 * gru_call_ms["library"],
           "launches_per_forward_on_kernel_path": 1,
           "bytes": gru_bytes, "flops": gru_flops, "bound_us": 1e3 * gru_bound_ms,
           "bound_by": gru_bound_by, "bound_simt_f32_us": 1e3 * gru_bound_simt_ms})

    del model, fn, dev_batch, add_calls

    # 19. the conv-floor probe's kernels vs their plain versions -------------------
    probe = _probe_kernel_checks(dev)
    _emit({"phase": "probe_kernels", **probe, "bf16_tol": BF16_GEMM_TOL,
           "read_atol": READ_ATOL, "read_rtol": READ_RTOL})

    # 20. the roofline harness's probe at both shapes: the slice's main path -------
    zero_counts()
    harness = {name: convfloor.measure_shape(name, target_s=HARNESS_TARGET_S, device=dev, **s)
               for name, s in convfloor.SHAPES.items()}
    probe_launches = {"bf16": matmul_bf16.launches, "int8": matmul_int8.launches,
                      "read": read_reduce.launches}
    _require(min(probe_launches.values()) > 0, f"the harness skipped a kernel: {probe_launches}")
    _require(kernel.launches + mha.launches + additive.launches + gru_kernel.launches == 0,
             "the harness launched a model kernel")
    # Kernel and library times are the harness's (CUDA events around replays
    # of a CUDA graph of calls); the plain versions' are CUDA events over 10
    # eager calls.
    # The profiler's device time per kernel record is printed beside them:
    # it can drop records in a short window, so it is averaged per record.
    probe_us, profiled_us = {}, {}
    with torch.inference_mode():
        for name, s in convfloor.SHAPES.items():
            xb, wb, xi, wi, bias = convfloor.probe_inputs(device=dev, **s)
            h = harness[name]
            probe_us[name] = {
                "bf16_kernel": 1e6 * h["cuda_bf16"]["secs"],
                "bf16_library": 1e6 * h["cublas_bf16"]["secs"],
                "int8_kernel": 1e6 * h["cuda_int8"]["secs"],
                "int8_library": 1e6 * h["cublas_int8"]["secs"],
                "read_kernel": 1e6 * h["read_bw"]["secs"],
                "read_library": 1e6 * h["torch_sum_bw"]["secs"]}
            for kind, plain_fn in (("bf16", lambda: matmul_bf16_plain(xb, wb)),
                                   ("int8", lambda: matmul_int8_plain(xi, wi)),
                                   ("read", lambda: read_reduce_plain(xb, bias))):
                plain_fn()
                probe_us[name][f"{kind}_plain"] = 1e3 * _cuda_ms(plain_fn, 10)
            profiled_us[name] = {key: _profiled_kernels_us(fn) for key, fn in (
                ("bf16_kernel", lambda: matmul_bf16(xb, wb)),
                ("bf16_library", lambda: torch.matmul(xb, wb)),
                ("int8_kernel", lambda: matmul_int8(xi, wi)),
                ("int8_library", lambda: torch._int_mm(xi, wi)),
                ("read_kernel", lambda: read_reduce(xb, bias)),
                ("read_library", lambda: convfloor.torch_sum_partials(xb)))}
            m, k, n = s["m"], s["k"], s["n"]
            for kind, cost in (("bf16", roofline.probe_gemm_cost(m, k, n, "bf16")),
                               ("int8", roofline.probe_gemm_cost(m, k, n, "int8")),
                               ("read", roofline.read_reduce_cost(m, k))):
                b_ms, b_by = roofline.bound_ms(*cost, "f32" if kind == "read" else kind)
                probe_us[name][f"{kind}_bound"] = 1e3 * b_ms
                probe_us[name][f"{kind}_bound_by"] = b_by
            del xb, wb, xi, wi
    _emit({"phase": "convfloor_times", **card, "launches": probe_launches,
           "harness": harness, "us_per_call": probe_us,
           "profiler_device_us_per_kernel_record": profiled_us})

    # 21. the conv roofline: GEMM controls, 24 conv shapes, epilogue and chain -----
    gemms = {n: harness_roofline.measure_gemm(n, device=dev, target_s=HARNESS_TARGET_S)
             for n in (2048, 4096, 8192)}
    convs = convfloor_v2.measure_convs((), ("bf16",), HARNESS_TARGET_S, device=dev)
    weighted = convs["conv_weighted_bf16"]
    forward_conv_ms = v4_times["forward_device_ms_by_op"]["aten::cudnn_convolution"]
    _require(weighted["shapes_measured"] == 24, f"conv shapes measured: {weighted}")
    _emit({"phase": "conv_roofline", **card, "batch": harness_roofline.BATCH,
           "gemm_bf16": gemms, **convs,
           "forward_cudnn_convolution_ms": forward_conv_ms,
           "harness_over_forward_conv_x": weighted["sum_secs_per_batch_ms"] / forward_conv_ms,
           "artifact_check": convfloor_v2.measure_artifact_check(HARNESS_TARGET_S, device=dev),
           "epilogue_chain": convfloor_v2.measure_epilogue_and_chain(HARNESS_TARGET_S,
                                                                     device=dev),
           "method": convfloor.timing.METHOD})

    # 22. the reference's whole task list through run_all --------------------------
    run_all_launches = _run_all_phase(dev, card, zero_counts, counted)

    # kernels line, card line, result ---------------------------------------------
    big = max(convfloor.SHAPES, key=lambda nm: probe_us[nm]["bf16_kernel"])

    def probe_row(name, kind, source, replaces, err, tol):
        us = probe_us[big]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"scripts/perf_pallas_convfloor.py:{replaces}",
                "launches": probe_launches[kind], "max_abs_err": err, **tol,
                "shape": big, "timed_by": "CUDA events around replays of a CUDA graph of calls",
                "ms": us[f"{kind}_kernel"] / 1e3,
                "plain_ms": us[f"{kind}_plain"] / 1e3, "bound_ms": us[f"{kind}_bound"] / 1e3,
                "bound_by": us[f"{kind}_bound_by"], "library_ms": us[f"{kind}_library"] / 1e3,
                "by_shape_us": {nm: {f: v[f"{kind}_{f}"] for f in
                                     ("kernel", "plain", "library", "bound")}
                                for nm, v in probe_us.items()}}

    kernel_rows = [{
        "name": "fused_gated_residual", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_fusion.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_fusion.py:59",
        "launches": launches,
        "max_abs_err": max(max(errs.values()), fusion_err), "tol": KERNEL_ATOL,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_simt_f32_ms": bound_simt_ms, "library_ms": None,
        "launches_train": train_launches,
        "train_max_abs_err": train_kernel_err["fused_gated_residual"],
        "backward": "torch ops (the formula, g recomputed from the saved inputs); "
                    "no backward kernel"}, {
        "name": "fused_gated_mha", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_mha.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_mha.py:107",
        "launches": mha_launches,
        "max_abs_err": max(max(mha_errs.values()), max(attn_errs.values())),
        "atol": MHA_ATOL, "rtol": MHA_RTOL,
        "ms": mix("kernel_device_us"), "plain_ms": mix("plain_device_us"),
        "bound_ms": mix("bound_us"),
        "bound_by": roofline.f32_accurate_bound_ms(mix_bytes, mix_flops)[1],
        "bound_simt_f32_ms": mix("bound_simt_f32_us"), "library_ms": None,
        "train_max_abs_err": train_kernel_err["fused_gated_mha"],
        "by_variant_us": {v: {k: per_variant[v][k] for k in
                              ("kernel_device_us", "plain_device_us", "bound_us")}
                          for v in per_variant}}, {
        "name": "fused_additive_attention", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/additive_attention.cu",
        "replaces": "visuelle2_tpu/ops/pallas/additive_attention.py:74",
        "launches": add_launches,
        "max_abs_err": max(max(add_errs.values()), *(e for check in demand_attn.values()
                                                       for e in check["max_abs_err"].values())),
        "atol": MHA_ATOL, "rtol": MHA_RTOL,
        "ms": add_mix("kernel_device_us"), "plain_ms": add_mix("plain_device_us"),
        "bound_ms": add_mix("bound_us"), "bound_by": add_mix_bound[1],
        "bound_simt_f32_ms": add_mix("bound_simt_f32_us"), "library_ms": None,
        "launches_per_call": max(v["kernel_launches_per_call"] for v in per_call.values()),
        "launches_train": {**demand_train_launches["fused_additive_attention"],
                           "per_step_small_width": parity_launches},
        "launches_legacy": legacy_attn["launches"],
        "legacy_max_abs_err": legacy_attn["max_abs_err"],
        "legacy_L64_us": {f: legacy_attn["call"][f] for f in (
            "kernel_device_us", "plain_device_us", "bound_us", "bound_simt_f32_us")},
        "train_max_abs_err": train_add_err["fused_additive_attention"],
        "train_forward_backward_us": {k: v for k, v in train_add_times.items()
                                      if k.startswith("additive")},
        "backward": "torch ops (autograd of the plain version, recomputed from the saved "
                    "inputs); no backward kernel",
        "by_call_us": {k: {f: v[f] for f in ("kernel_device_us", "plain_device_us",
                                             "bound_us", "bound_simt_f32_us")}
                       for k, v in per_call.items()}}, {
        "name": "fused_gru_sequence", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gru_seq.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gru_seq.py:62",
        "launches": gru_path_launches,
        "launches_note": "the trend GRU's kernel path (GRU.use_kernel); the default "
                         "Demand path, like every JAX model, runs the step loop",
        "max_abs_err": max(max(e["vs_plain"], e["vs_cudnn"]) for e in gru_errs.values()),
        "atol": GRU_ATOL_FULL,
        "ms": gru_device_ms["kernel"], "plain_ms": gru_device_ms["plain"],
        "bound_ms": gru_bound_ms, "bound_by": gru_bound_by,
        "bound_simt_f32_ms": gru_bound_simt_ms, "library_ms": gru_device_ms["library"],
        "launches_train": demand_train_launches["fused_gru_sequence"],
        "train_max_abs_err": train_add_err["fused_gru_sequence"],
        "train_forward_backward_us": train_add_times["gru trend"],
        "backward": "torch ops (autograd of the step loop, recomputed from the saved "
                    "inputs); no backward kernel",
        "hidden_range_on_cuda": "H <= {} (resident layout up to {}, streamed above)".format(
            gru_seq.max_hidden(torch.cuda.get_device_properties(dev).multi_processor_count),
            gru_seq.RESIDENT_MAX_HIDDEN),
        "wide_us": wide_us},
        probe_row("probe_matmul_bf16", "bf16", "visuelle2_tpu_torch/csrc/probe_gemm_bf16.cu", 176,
                  probe["max_abs_err"]["bf16"], {"tol": BF16_GEMM_TOL}),
        probe_row("probe_matmul_int8", "int8", "visuelle2_tpu_torch/csrc/probe_gemm.cu", 209,
                  probe["max_abs_err"]["int8"], {"tol": 0}),
        probe_row("read_reduce", "read", "visuelle2_tpu_torch/csrc/read_reduce.cu", 249,
                  probe["max_abs_err"]["read"], {"atol": READ_ATOL, "rtol": READ_RTOL}), {
        "name": "int8_conv", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/int8_conv.cu",
        "replaces": "visuelle2_tpu/models/quantized_resnet.py:86",
        "replaces_note": "the JAX engine's XLA convolution (int32 sums, its epilogue fused "
                         "by XLA); no pl.pallas_call",
        "status": "redesigned for Hopper: wgmma s8 fed by TMA, the identity shortcut "
                  "read as int8, the stem's 4-byte gather",
        "launches": w8a8["launches"], "launches_per_forward": w8a8["launches"] / N_FWD,
        "max_abs_err": w8a8["max_abs_err"], "tol": 0,
        "timed_by": "per forward at B=128: each distinct shape's CUDA-event time "
                    "times its launches a forward, summed",
        "ms": w8a8["per_forward"]["kernel_ms"], "plain_ms": w8a8["per_forward"]["plain_ms"],
        "bound_ms": w8a8["per_forward"]["bound_ms"],
        "bound_by": w8a8["per_forward"]["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call computes an int8 convolution with this epilogue; "
                        "torch._int_mm on the 1x1 stride-1 shapes' GEMMs is in "
                        "int_mm_ms_on_1x1_stride1",
        "per_forward": w8a8["per_forward"],
        "by_shape_us": {k: {f: v[f] for f in ("launches_per_forward", "kernel_us",
                                              "plain_us", "bound_us", "int_mm_us")}
                        for k, v in w8a8["shapes"].items()}}]
    for row in kernel_rows:
        # Each path's own count, zeroed just before it: "launches" is the
        # path the row has always named; the forecast CLIs' scoring runs too.
        row["launches_forecast_cli"] = cli_launches[row["name"]]
        row["launches_run_all"] = run_all_launches[row["name"]]
        row["launches_artifact_serve"] = artifact_launches[row["name"]]
        row["launches_w8a8_cli"] = w8a8["launches_cli"][row["name"]]
        row["launches_data_parallel"] = dp_launches[row["name"]]
        row["launches_tensor_parallel"] = tp_launches[row["name"]]
    _emit({"phase_seconds": _PHASE_SECONDS, "sum_s": sum(_PHASE_SECONDS.values())})
    _emit({"kernels": kernel_rows})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
