#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure raises and the script
exits non-zero without its last line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the hand-written kernels (``ceigm_unet_tpu_torch/csrc``);
3. kernels: each kernel against its plain PyTorch version at every shape
   the 224x224 forward gives it (in the layout the model passes: K1's u and dt
   as strided (B, L, K, D) GEMM outputs, Bs and Cs as x_dbl slices; K1 also on
   contiguous operands and on a long-memory input whose state carries across
   every chunk of a 56x56 walk), at batch 2 in fp32 (TF32 off; rtol 1e-4, atol
   1e-4 * max|plain|) and bf16 (rtol 3e-2, atol 5e-2 * max|plain|), at
   batch 32 and batch 48 in fp32 (the fp32 tolerance; the batches and dtype
   of phase 21's test-set path and of phase 22's training, the CLIs' fp32
   route: ``cffn_gemm``'s fp32-weight kernel at every shape and launch plan
   it takes there) and
   batch 128 in bf16 (same bf16 tolerance; the batch of phase 6, large enough
   that every grid-stride loop repeats), where kernel and plain version are
   also timed with CUDA events; each kernel and its library call are also
   timed at b32 fp32 (the test-set path's batch and dtype: fp32 ``addmm``
   with TF32 off beside ``cffn_gemm``) beside the bound at the fp32 peak;
   ``cffn_gemm`` is held tighter: its fp32 output
   (fc1) at the fp32 tolerance and its bf16 output (fc2) at rtol 1e-2, atol
   1e-2 * max|plain| (two bf16 ulps), and ``cffn_dw3_inception7`` (an fp32
   hidden in every regime) at the fp32 tolerance throughout; K4 (``dysample_grid_sample``) also on a
   grid far outside [-1, 1] (the border clamp on all four edges) at C 348,
   where channel vectors straddle two groups; each kernel and the library call
   beside it are also timed as the device's work alone (``device_ms``,
   ``library_device_ms``: the calls queue behind a spin kernel, so the host's
   time per call does not enter); K1 also at the four shapes of phase 27's
   64x64 input (16x16 D16 to 2x2 D112: L 256 to 4);
4. model: MSVM-UNet gm_tiny (9 classes, seeded random weights) at 224x224,
   batch 2, fp32 on the card against the same model on the CPU (rtol 1e-3,
   atol 1e-3 * max|CPU logits|), and the kernel launches of one forward;
   then the bf16 forward on the card against the fp32 CPU logits (max abs
   error <= 0.05 * max|CPU logits|, tests/test_torch_model.py's bound);
5. serving (the main path): ``predict_volume`` in bf16, batch 32, on two
   seeded synthetic CT volumes of 40 x 512 x 512; launch counters are reset
   just before and read just after;
6. throughput: the batch-128 bf16 224x224 forward, slices/s; its logits
   are then held against the fp32 forward of the same batch on the card
   (max abs error <= 0.05 * max|fp32 logits|);
7. scan2d: the quad scan's backward recurrence (``csrc/scan2d.cu``), scan
   and adjoint modes, against its plain version at every batch-48 224x224
   training shape, fp32 (TF32 off; rtol 1e-4, atol 1e-4 * max|plain|), on
   contiguous operands and in the model's (B, L, K, D) layout, and on a
   long-memory case (decays within 1e-4 of 1 over 3136 pixels); timed
   through the wrapper in the model's layout, host in the loop and device
   time, beside the plain version; then at b2 at the four shapes of phase
   27's 64x64 input (L 256 to 4);
8. train step vs CPU: one unfrozen gm_tiny train step, batch 2, fp32, on
   the card and on the CPU from the same weights, batch and drop-path
   masks: the loss, every parameter's gradient (rtol 2e-3, atol 1e-8 +
   2e-3 * max|CPU grad| per tensor, or, for a tensor that fp32 rounding
   alone moves further when the CPU runs on fewer threads, twice that
   tensor's own move), the BN running statistics and the launches of the
   step;
9. trainer (the training main path): ``entry.train_entry`` at batch 48,
   224x224, bf16 compute with fp32 parameters, AdamW and DiceCE on a seeded
   synthetic batch with blob-shaped labels; 2 frozen-encoder steps then 8
   unfrozen ones (launch counters reset just before, read just after):
   finite losses that fall, the encoder unchanged while frozen and changed
   after (all but the weights behind a ReLU off for every sample), a
   non-zero gradient in the first unfrozen step for every
   parameter whose true gradient is not 0 (a bias feeding a train-mode
   BatchNorm, or weights behind a ReLU off for every sample, have 0), finite
   ones in the last; ms/step and peak memory; 3 fp32
   steps; the bf16-vs-fp32 gradient cosine of one batch-2 step;
10. legacy kernels: the VMamba scans against their plain versions, timed
   beside them: K10 (``csrc/sscan_dir.cu``) at each of the four 224x224
   tiny_0230s SS2D shapes at b2 fp32, b2 bf16 and b128 bf16 (phase 3's
   tolerances), and at the four of phase 27's 64x64 input (L 256 to 4); K12
   and K11 (``csrc/scan_rows.cu``) at the reference selective-scan speed
   test's shape (B 128, D 96, N 1, L 4096, bf16 in; K12 with fp32 out at
   the fp32 tolerance and with bf16 out at the bf16 one) and K11 also at B
   8, D 96, N 16, L 3136 (fp32 tolerance), each also timed as device time;
11. legacy model: the legacy MSVM-UNet (VSSM tiny_0230s + the published
   decoder, 9 classes, seeded random weights) at 224x224, b2 fp32, on the
   card against the CPU (phase 4's tolerance), the launches of one forward
   (K10 20 times, nothing else), and the bf16 logits against fp32; then
   ``entry.legacy_entry``'s model called once with grad mode on;
12. legacy serving (K10's main path): ``predict_volume`` over phase 5's
   volumes in bf16 at batch 32 (counters reset just before, read just
   after), then the b128 bf16 throughput as in phase 6;
13. selective_scan (K11's and K12's main path): the public op at phase
   10's shapes (counters reset just before, read just after: K12 once, K11
   twice), the first two batch rows of each result against the op on the
   CPU, and each call timed;
14. route kernels: the single-grid grid-sample (``csrc/grid_sample.cu``
   ``grid_sample_bilinear``; K6/K7) at DySample's three per-group 224x224
   shapes, one non-2x size, a grid far outside [-1, 1] and a C 348 image,
   K13 (``csrc/dwconv3.cu``) forward and flip
   mode and K14 (``csrc/quad_scan_ln.cu`` ``quad_scan_ln_q8``, in the
   model's layout, and once on a long-memory input) at every
   gm_tiny quad-block shape, each at b2 fp32, b2 bf16 and b128 bf16
   against its plain version (phase 3's tolerances; K14's bf16 output at
   the bf16 one), timed beside it, the library call and the bound; then
   DySample's per-group route against the grouped K4 at b128 bf16;
15. kernel-depthwise and per-group-DySample model: gm_tiny built with
   ``dwconv="kernel", dysample_grouped=False``: b2 fp32 card vs CPU
   (phase 4's tolerance) with the launches of one forward (K13 26, the
   single-grid grid-sample 3, the grouped one 0); b128 bf16 throughput;
   one b2 fp32 train step card vs CPU (phase 8's check; K13's flip mode 26
   times in the backward); the route's trainer (its training main path),
   2 frozen + 3 unfrozen b48 bf16 steps, ms/step;
16. int8 serving (K14's main path): gm_tiny built with
   ``quant_scan=True``: b2 card vs CPU at the bf16 tolerance with the
   launches of one forward (K14 26, K1 0); its bf16 logits within 0.05 *
   max|logit| of the same weights' bf16 logits without int8 storage;
   ``predict_volume`` over phase 5's volumes and the b128 throughput; the
   int8 op with inputs that require grad raises the inference-only error,
   and ``entry.entry(quant_scan=True)``'s model runs with grad mode on;
17. legacy scan backward kernels: K8 (``csrc/scan2d.cu``), scan and
   adjoint modes, at the four tiny_0230s 224x224 SS2D shapes (D 96 to
   768, past one 128-channel tile) at b2 and b48 fp32 against its plain
   version (phase 7's tolerance and cases, in the layouts the legacy
   backward passes: the decay in (K, B, L, D), the adjoint's drive in
   (B, L, K, D)), timed at b48 beside it with the bound; then at b2 at the
   four shapes of phase 27's 64x64 input (L 256 to 4);
18. legacy train step vs CPU: phase 8's check on one unfrozen tiny_0230s
   b2 fp32 step (loss, every gradient against its tolerance or twice its
   own reorder floor, the BN running statistics of the 3 LKPE and the
   FLKPE, K10 20 and K8 40 launches);
19. legacy trainer (this slice's main path): ``entry.legacy_train_entry``
   at b48 224x224 bf16 (fp32 parameters), 2 frozen-encoder steps then 4
   unfrozen (counters reset just before, read just after: K10 20 per step,
   K8 12 per frozen step and 40 per unfrozen one): finite losses that
   fall, the encoder unchanged while frozen, ms/step and peak memory; the
   bf16-vs-fp32 gradient cosine of one b2 step;
20. selective_scan backward: the op's seven gradients at phase 13's shapes
   on a batch of 2, card against CPU (fp32 gradients at phase 8's
   tolerance, those of bf16 inputs at the bf16 one), K11 launched exactly
   twice per backward on both routes; then the backward at phase 13's full
   batch timed beside K11's two calls;
21. test-set inference (this slice's main path), fp32 with TF32 off:
   (a) a seeded 9-class gm_tiny saved as a Lightning file and read back
   by ``convert.checkpoint.load_model`` on the card, every tensor bitwise
   equal; (b) ``cli.inference.run_inference`` with an exact predictor
   (one-hot logits of the rounded raw voxel) on two 8 x 512 x 512 cases
   whose voxels are class ids, at patch 512 x 512 (the zoom is the
   identity): dice 1, jaccard 1, hd95 0, asd 0 for every class (exact at
   any depth; the host metrics' time grows with it); (c) the loaded gm_tiny
   on two Synapse-like 40 x 512 x 512 cases (blob labels with every organ
   present; real cases hold 85-198 slices), both served, the first through
   ``run_inference`` and scored: every value finite, or NaN where the
   prediction holds no voxel of the class, K1/K3/K4/K5 launched forwards x
   ``PER_FORWARD`` (counters reset just before, read just after), ms per
   case of ``predict_volume`` and of the first case's host metrics, fp32
   slices/s; the b32 fp32 logits of case 0's first batch
   against the same model on the CPU (phase 4's tolerance), and that
   forward's wall time, the host's time to issue it, its device kernel time
   (torch.profiler), idle share and the card's clocks and power; (d) ``cli.inference.main`` on two ACDC-format
   ``test`` cases of 10 x 256 x 216 with a 4-class checkpoint: it returns,
   its log ends with the ``global:`` line, launches forwards x
   ``PER_FORWARD``;
22. training from the command line (this slice's main path), gm_tiny fp32
   (TF32 off) on synthetic Synapse-like slices written to a temporary
   directory (the card machine has no ``h5py``: validation volumes go to
   ``run_training`` in memory): (a) the native warp library built, one
   worker's host augmentation + zoom of 512x512 slices to 224x224 in ms
   per slice, and the 6-worker loader's slices/s over an epoch of 10
   batches of 48; (b) ``train.loop.run_training`` with the Synapse preset
   at b48 on 96 raw 512x512 slices listed 5 times (10 steps per epoch, so
   that an epoch reaches a steady state: the workers build batches while
   the loop issues steps), 3 epochs, the encoder frozen in
   epoch 0, validation on one 8x512x512 volume every epoch (counters reset
   just before, read just after: K1/K3/K4/K8 per train step, a frozen step
   with the decoder's 14 K8 scans, K1-K5 per validation forward): finite
   losses, the encoder's parameters bitwise unchanged in epoch 0,
   ``-best`` and ``-last`` written; ms/step in epoch 1 (the loop's epoch
   time less its waits for batches; the first unfrozen steps) and in epoch
   2 (its traced wall less its waits) beside the loader's slices/s, the
   loop's wait for each epoch's first batch and for the others, the first
   step, peak memory, and epoch 2's training (its waits and steps) traced
   by torch.profiler on the card's activity alone (device work and idle
   share, which fails if the device work exceeds the wall); then
   ``resume_from`` the ``-last`` file for one
   epoch: the model at the first resumed step bitwise equal to the file,
   the step count and the LR continuing; (c) ``device_augment`` on a b48
   raw batch, card against CPU on the same sampled parameters (image at
   the fp32 tolerance, labels exactly), timed, then one epoch of
   ``run_training`` with ``device_aug``; (d) ``cli.train_acdc.main
   --max-steps 2 --device cuda`` on 64 ACDC-format slices: its history
   row, ``acdc-last.ckpt`` and the launches of 2 frozen steps;
23. parallel (data parallelism and the ring scan; the card machine holds
   one card, so the group has one rank: the multi-rank cases run on the CPU
   over gloo in tests/test_torch_parallel.py): (a) ``init_data_parallel(1)``
   over NCCL through a ``FileStore`` in a temporary directory; (b) three
   gm_tiny b48 fp32 steps (TF32 off; frozen, unfrozen, unfrozen; SGD with
   momentum, as the JAX package's equivalence check steps, since Adam's first
   step blows rounding noise up to a full step) with the group active
   against the same steps without it from the same weights, batch and
   drop-path masks: losses (1e-4 relative), parameter moves and BN
   statistics within phase 8's gradient tolerance (moves plus 2 ulps of the
   parameter), the collectives of each step non-zero, K1/K3/K4/K8 launches
   per step as phase 22 (b)'s, ms/step of both; then unfrozen steps each
   timed alone, in the order without the group (5), with it (10), without
   it again (5, a fresh model after one untimed step), and the medians
   with their spread; (c) the ring scan
   (``parallel/ring_scan.py``) on a (2, 32, 1, 16384) fp32 input (stage 1 of
   a 512x512 image) in the group of one and as 4 shards stacked on the card
   (``stacked_ring_scan``), forward and reverse, against ``scan_rows`` over
   the whole L and against the CPU (phase 3's fp32 tolerance), with its a/b
   gradients against the CPU's; K11 launched exactly 16 times (2 per
   forward, 2 per backward) and the group's ring all-gathering 4 times (one
   per forward and per backward), its forward and backward timed as device time;
   (d) ``predict_volume`` on phase 5's volumes with the group active: no
   collective, every forward's logits and the label maps bitwise equal to
   the run without it; (e) the debug guards: built with them off, gm_tiny's
   b2 forward launches what it launches without them; on, a NaN planted in
   the first quad block's input raises ``FloatingPointError`` naming
   ``quad_pergroup.y``; (f) a tiny_0230s encoder saved with a classifier's
   keys under ``"model"``, loaded by ``convert.vssm_import`` into a fresh
   model: b2 logits bitwise equal to the source model's; (g) ``torchrun
   --standalone --nproc_per_node=1 -m ceigm_unet_tpu_torch.cli.train_acdc
   --distributed --max-steps 2`` on phase 22 (d)'s data (NCCL over
   ``env://``): exit 0, its history row and ``acdc-last.ckpt``; (h)
   ``entry.dryrun_multichip(1, "cuda")`` (a spawned NCCL rank) passes and
   ``dryrun_multichip(2, "cuda")`` raises.
24. sp block (the H-sharded QuadGroupSS2D, ``parallel/sp_ss2d.py``; the
   multi-rank group form runs on the CPU over gloo in
   tests/test_torch_sp.py): (a) at gm_tiny's four QuadGroupSS2D shapes of a
   512x512 b8 forward, (H = W, C) = (128, 64), (64, 128), (32, 348), (16,
   448), fp32 (TF32 off), the block on 4 H-shards stacked on the card
   (``quad_group_ss2d_stacked``) against the unsharded block on the card (K1
   forward, K8 backward): the output at rtol 2e-4, atol 2e-4 * max|out|,
   the input and every parameter gradient of sum(out * ct) at phase 8's
   gradient tolerance; the 128x128 shape also with ``dwconv="kernel"``
   (K13 and its flip mode on the haloed rows); K11 launched exactly 16
   times per block (2 per direction forward, 2 backward), no K1 or K8
   launch and no collective; (b) in a group of one over NCCL, the block
   under ``sp_scan_island`` equals the 1-shard stacked block bitwise, with
   its collectives per forward and backward counted; (c) the 128x128 block
   in bf16 within 0.05 * max|fp32 out| of fp32; (d) ms per block forward
   and per forward + backward, stacked against unsharded, per shape: the
   device's time with the calls queued behind ``kernel_ab.device_time``'s
   spin kernel, the device work summed by torch.profiler, and the host's
   time to issue one call.
25. sp model (the H-sharded MSVM-UNet, ``parallel/sp_model.py`` and the
   exchanges of ``parallel/sp_ops.py``; the multi-rank group form runs on
   the CPU over gloo in tests/test_torch_sp_model.py): gm_tiny (9 classes,
   seeded init with DySample's two offset convs scaled 600x, as
   tests/test_torch_sp_model.py scales them, eval) at 512x512, fp32 (TF32
   off), on 4 H-shards stacked on the card (``sp_forward_stacked``)
   against the unsharded model on the card: (a) the b8 forward's logits at
   phase 4's tolerance, with its launches (K11 8 per quad block, K3's GEMM
   and stencil per CustomFfn per shard, K4 and K5 once each per upsampler,
   no K1 or K8) and no collective; at each DySample some samples of that
   forward land two or more rows inside a shard other than their output
   row's, so K4 reads the gathered source across shards; (b)
   ``sp_value_and_grad_stacked``'s b2 DiceCE loss within 1e-4 relative and every parameter gradient at phase 8's gradient
   tolerance, with the launches of that forward and backward (K11 twice
   as many); (c) the b8 bf16 logits within 0.05 * max|fp32 logit|; (d) in
   a group of one over NCCL, ``sp_forward`` equals the 1-shard stacked
   form bitwise, with its collectives per forward counted; (e) ms per b8
   forward and per b2 forward + backward, sharded against unsharded, as
   phase 24 (d) times them, with the peak device memory of each.
26. sp legacy (the H-sharded legacy MSVM-UNet: its SS2D's four directions
   on the ring scan, ``parallel/sp_ss2d.py`` ``ss2d_scan``; the multi-rank
   group form runs on the CPU over gloo in tests/test_torch_sp_legacy.py):
   tiny_0230s (9 classes, seeded init, eval) at 512x512, fp32, phase 25's
   (a) to (e) on 4 stacked shards against the unsharded model on the card
   (K10): launches per sharded forward K11 8 per SS2D (160: 14 encoder and
   6 decoder SS2Ds) and no K10, the unsharded forward's K10 once per SS2D;
   320 K11 per forward + backward; in the group of one, per forward 4
   all-gathers and 2 all-to-alls per SS2D and no all-reduce.
27. training trajectories: gm_tiny and tiny_0230s (9 classes, seeded init)
   at 64x64, batch 2. (a) Phase 8's one-step check on each at 64x64, with a
   float64 CPU step as the exact reference (``float64_compute``, in a
   process of its own) in place of the runs on fewer threads: a gradient's
   floor is how far the CPU's fp32 gradient lies from the exact one. (b) 20
   steps of the training CLI's AdamW and schedule (``_trainer``; gm_tiny
   from the CLIs' LR 5e-4, tiny_0230s from 2e-6, where its trajectory is
   not chaotic in fp32: see TRAJ_MODELS), the encoder frozen for the first
   2, on two synthetic batches used alternately, each step's drop-path
   masks from a CPU generator seeded per step; run (i) on the card in fp32
   (TF32 off) and (iv) in bf16, each step's launches checked (K1/K3/K4/K8
   or K10/K8 as phases 8 and 18 count them, K8's frozen count while
   frozen), then one eval forward of the first batch (its launches too: K5
   for gm_tiny); and on the CPU, (ii) in fp32 on 2 threads, (iii) in fp32
   on 1 thread (its reorder floor), and for gm_tiny (v) in bf16, each run
   (and each float64 step of (a)) in one of 3 spawned processes at the
   lowest priority, started after phase 3: beside phases 4-26 (phase
   28's CPU references queue behind them in the same processes). Fails
   unless: every loss is finite; the encoder is bitwise unchanged through
   the frozen steps; card fp32 vs CPU fp32: each step's loss within 2e-4 *
   (1 + step) relative and the final eval logits at rtol 5e-3, atol 5e-3 *
   max|logit| (PARITY.md's trajectory tolerances); card bf16 vs card fp32:
   each loss within 5e-2 relative and the final logits within 0.05 *
   max|logit|. Each bound is read at its own step against max(1, 2 x the
   share of it the CPU's own drift uses at that step ((iii) against (ii);
   (v) against (ii)), never past 2x. Prints every run's 20 losses and each
   bound's largest share used.
28. gm_small and gm_base (the JAX package's two other GroupMamba
   configurations, at upstream GroupMamba-S's and -B's widths; 9 classes,
   seeded random weights at full width and depth; launch counts from
   ``GROUPMAMBA_CONFIGS``' depths, K1 once per encoder block and 7 decoder
   blocks: 33 and 40): (a) every kernel against its plain version at
   gm_base's 224x224 shapes (K1 at D 24/48/106/128, with a long-memory and a
   contiguous case and its 64x64 maps; K3's GEMMs at (K, N) (424, 1696),
   (192, 768), (96, 384) and back, the stencil at HID 1696/768/384; K4 at
   C 512/424/192 and a grid far outside [-1, 1]; K5 at C 424/192/96; the
   route kernels K6/K7, K13 (both modes) and K14 at its per-group and
   quad-block widths) at phase 3's batches, dtypes and tolerances, timed
   per b128 bf16 and per b32 fp32 forward beside the bound and the library
   call; K8 in both modes at gm_base's four shapes at b2 and b48 and its
   64x64 maps (phase 7's check); (b) for each configuration phases 4-6: b2
   fp32 card vs CPU (phase 4's tolerance) with the launches of one forward,
   b2 bf16 vs the fp32 CPU logits, the b128 bf16 throughput, and
   ``predict_volume`` over phase 5's volumes with its launches; (c)
   gm_base's training: phase 27 (a)'s one-step check at 64x64 b2 (a float64
   CPU step as the exact reference; K8 80 launches), then
   ``entry.train_entry(enc_name="gm_base")``, 2 frozen + 3 unfrozen steps
   in fp32 (TF32 off; at b32, since b48 needs more than the card's memory)
   and in bf16 at b48: finite losses that fall, the encoder bitwise
   unchanged while frozen, each step's launches (K8 14 per frozen step, 80
   per unfrozen one), ms/step and peak memory. The CPU references (both
   b2 fp32 forwards, gm_base's fp32 and float64 64x64 steps) run in phase
   27's processes.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
entry point with its launches on its own main path (those of phases 3,
10 and 14 also with ``device_ms`` and ``library_device_ms``, the same
calls timed as the device's work alone; K1-K5 also with
``launches_test_set``, their launches on phase 21's path,
``max_abs_err_b32_fp32`` / ``max_abs_err_b48_fp32``, phase 3's checks at
the batch and dtype of phase 21's and phase 22's paths, and
``ms_b32_fp32``, ``device_ms_b32_fp32``, ``library_ms_b32_fp32``,
``library_device_ms_b32_fp32`` and ``bound_ms_b32_fp32``, phase 3's times
per b32 fp32 forward;
K1-K5 and K8 also with ``launches_training_cli``, their launches on phase
22 (b)'s path; K11 also with ``launches_ring_scan``, its launches on phase
23 (c)'s path; K11 and K13 (both modes) also with ``launches_sp_block``,
their launches on phase 24 (a)'s path; K11, K3 (both kernels), K4 and K5
also with ``launches_sp_model``, their launches on phase 25 (b)'s path;
K11 also with ``launches_sp_legacy``, its launches on phase 26 (b)'s path,
and K10 with ``launches_sp_legacy_reference``, its launches in phase 26
(a)'s unsharded forward; K1-K5, K8 and K10 also with
``launches_trajectory``, their launches over phase 27's card runs;
K1-K5 also with ``launches_gm_small`` and ``launches_gm_base``, and K8 with
``launches_gm_base``, their launches on phase 28's paths (each
configuration's serving, and gm_base's two trainers), and every kernel
phase 28 (a) checks with ``at_gm_base``, its errors and times there);
the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
IMG = 224
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 5e-2)}
DTAG = {torch.float32: "fp32", torch.bfloat16: "bf16"}
# cffn_gemm: kernel and plain version round the same inputs to bf16 and sum
# in fp32, so its fp32 output holds the fp32 tolerance and its bf16 output
# two bf16 ulps; either fails a kernel that drops K = 348's last 28 columns
GEMM_TOL = {torch.float32: TOL[torch.float32], torch.bfloat16: (1e-2, 1e-2)}
MODEL_TOL = (1e-3, 1e-3)
BF16_MODEL_TOL = 0.05          # max abs error / max|fp32 logits|


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(*parts):
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, tol) -> float:
    """Max abs error; fails past ``tol``: a dtype's tolerance (``TOL``) or
    an (rtol, atol) pair."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail("non-finite kernel output")
    rtol, atol = TOL[tol] if tol in TOL else tol
    scale = want.abs().max().item()
    err = (got - want).abs()
    bad = err > atol * max(scale, 1e-6) + rtol * want.abs()
    if bool(bad.any()):
        fail(f"kernel differs from its plain version: max abs err "
             f"{err.max().item():.3e} (max|plain| {scale:.3e}, {tol})")
    return err.max().item()


# --- phase 3: kernels at the main-path shapes -------------------------------

# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s; fp32 outside the
# tensor cores and bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
PEAK = {"fp32": 67e12, "bf16": 989e12}


class Case:
    """One kernel call: the kernel, its plain version, the one PyTorch
    call computing the same function (or None), and the least work the
    function needs: bytes (inputs read once, outputs written once) and
    operations, with the peak rate of their type."""

    def __init__(self, kern, plain, library, nbytes, ops, peak, tol=None):
        self.kern, self.plain, self.library = kern, plain, library
        self.nbytes, self.ops, self.peak = nbytes, ops, peak
        # what holds the result, as compare() takes it (default: the
        # inputs' dtype)
        self.tol = tol

    def bound_ms(self):
        return max(self.nbytes / HBM_BPS, self.ops / PEAK[self.peak]) * 1e3

    def bound_by(self):
        return ("bytes" if self.nbytes / HBM_BPS >= self.ops / PEAK[self.peak]
                else "operations")


def quad_params(rnd, dev, K, D, long_memory=False):
    """A, dt bias, D, LN scale, LN bias of the quad scan. Long memory: A =
    -exp(-8) and a dt bias near -2 keep each step's decay exp(d*A) within
    2e-4 of 1, so the state carries over every chunk of a 56x56 walk and a
    wrong carry-in shows far above the tolerance."""
    A = (torch.full((K, D), -np.exp(-8.0), device=dev) if long_memory
         else -torch.exp(rnd((K, D), 0.5)))
    return [A, rnd((K, D), 0.3) - (2.0 if long_memory else 0.0), rnd((K, D)),
            1 + rnd((K, D), 0.1), rnd((K, D), 0.1)]


def kernel_cases(dev, enc_name="gm_tiny", phase64=27):
    """name -> (route, source, replaces, [(shape tag, calls per forward,
    make(batch, dtype) -> Case)]) at the shapes of a 224x224 forward of
    ``enc_name``, and K1 at those of the 64x64 input of phase ``phase64``."""
    import torch.nn.functional as F
    from ceigm_unet_tpu_torch.models.emcad import EMCAD
    from ceigm_unet_tpu_torch.ops import ffn, grid_sample, quad_scan, tapconv
    gen = torch.Generator().manual_seed(SEED)

    def rnd(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def size(dt):
        return torch.tensor([], dtype=dt).element_size()

    def quad(H, W, D, model_layout=True, long_memory=False):
        # model_layout: u and dt (B, L, K, D) GEMM outputs and Bs, Cs the
        # x_dbl (B, L, K, R + 2) slices, viewed as (B, K, L[, D]), as
        # models/ss2d.py passes them; else contiguous (B, K, L[, D])
        def make(B, dt):
            K, L = 4, H * W
            if model_layout:
                R = -(-D // 16)
                u, dtv = [rnd((B, L, K, D), s, dt).permute(0, 2, 1, 3)
                          for s in (1.0, 0.5)]
                x_dbl = rnd((B, L, K, R + 2), 1.0, dt)
                BC = [x_dbl[..., R + i].permute(0, 2, 1) for i in (0, 1)]
            else:
                u, dtv = rnd((B, K, L, D), 1.0, dt), rnd((B, K, L, D), 0.5,
                                                         dt)
                BC = [rnd((B, K, L), 1.0, dt) for _ in (0, 1)]
            args = [u, dtv, *BC, *quad_params(rnd, dev, K, D, long_memory),
                    H, W, (1, 2, 3, 4)]
            n = B * K * L * D
            # ~22 elementwise operations per element: softplus, decay,
            # drive, the scan FMA, C*h + D*u, LN statistics and affine
            return Case(lambda: quad_scan.quad_scan_ln_cat(*args),
                        lambda: quad_scan.quad_scan_ln_cat_ref(*args), None,
                        size(dt) * (3 * n + 2 * B * K * L) + 20 * K * D,
                        22 * n, "fp32")
        return make

    def gemm(L, K, N, hidden_in):
        def make(B, dt):
            M = B * L
            a = rnd((M, K), 1.0, torch.float32 if hidden_in else dt)
            # the (K, N) view of nn.Linear's (N, K) weight, as CustomFfn
            # passes it
            w, b = rnd((N, K), 0.05, dt).t(), rnd((N,), 0.1)
            od = dt if hidden_in else torch.float32
            a_w, b_w = a.to(dt), b.to(dt)
            # fc1's library call writes fp32, as the kernel must
            lib = (lambda: torch.addmm(b, a, w, out_dtype=od)) \
                if od != dt else (lambda: torch.addmm(b_w, a_w, w))
            return Case(lambda: ffn.ffn_gemm(a, w, b, od),
                        lambda: ffn.ffn_gemm_ref(a, w, b, od), lib,
                        M * K * a.element_size() + K * N * size(dt) + 4 * N
                        + M * N * size(od), 2 * M * N * K,
                        "bf16" if dt == torch.bfloat16 else "fp32",
                        tol=GEMM_TOL[od])
        return make

    def stencil(H, W, HID):
        def make(B, dt):
            # fp32 hidden whatever the model's dtype: held at the fp32
            # tolerance (TF32 off)
            g = HID // 8
            k, b = ffn.inception_composite(
                HID, g, rnd((3, 3, 1, g), 0.2), rnd((5, 5, 1, g), 0.1),
                rnd((7, 7, 1, g), 0.05), rnd((g,), .1), rnd((g,), .1),
                rnd((g,), .1), torch.float32)
            args = [rnd((B * H * W, HID)), rnd((3, 3, 1, HID), 0.2),
                    rnd((HID,), 0.1), k, b, H, W, HID - 3 * g]
            M = B * H * W
            # h read and the result written once, the taps and biases; per
            # element the 9 dw3 taps (18), the bias, the erf-GELU (~10) and
            # the residual, plus the 9/25/49 taps of the tapped channels
            return Case(lambda: ffn.dw3_gelu_inception7(*args),
                        lambda: ffn.dw3_gelu_inception7_ref(*args), None,
                        8 * M * HID + 240 * HID,
                        M * (31 * HID + 2 * g * (9 + 25 + 49)), "fp32",
                        tol=torch.float32)
        return make

    def gsample(H, W, C, spread=None):
        # spread: the offsets' scale in normalised units (default 0.1
        # pixel)
        def make(B, dt):
            x = rnd((B, H, W, C), 1.0, dt)
            ys = (torch.arange(2 * H) + 0.5) / H - 1
            xs = (torch.arange(2 * W) + 0.5) / W - 1
            base = torch.stack(torch.meshgrid(ys, xs, indexing="ij")[::-1],
                               dim=-1)
            grid = base[None, :, :, None, :].to(dev) + rnd(
                (B, 2 * H, 2 * W, 4, 2), spread or 0.1 / H)
            g, cg, P = 4, C // 4, 4 * H * W
            # the regrouped batch F.grid_sample takes, built outside the
            # timing
            xg = x.reshape(B, H, W, g, cg).permute(0, 3, 4, 1, 2).reshape(
                B * g, cg, H, W)
            gg = grid.permute(0, 3, 1, 2, 4).reshape(
                B * g, 2 * H, 2 * W, 2).to(dt)
            return Case(lambda: grid_sample.dysample_grid_sample(x, grid),
                        lambda: grid_sample.dysample_grid_sample_ref(x, grid),
                        lambda: F.grid_sample(xg, gg, mode="bilinear",
                                              padding_mode="border",
                                              align_corners=False),
                        size(dt) * B * (H * W + P) * C + 8 * B * P * g,
                        8 * B * P * C + 20 * B * P * g, "fp32")
        return make

    def lgag(H, W, C):
        def make(B, dt):
            C2 = C // 2
            args = [rnd((B, H, W, C), 1.0, dt), rnd((B, H, W, C), 1.0, dt),
                    rnd((5, 5, 2, C2), 0.2), 1 + rnd((C2,), 0.1),
                    rnd((C2,), 0.1), rnd((C2,), 0.3), rnd((3,), 0.5)]
            n = B * H * W
            # 50 taps (100), BN affine, ReLU, the psi dot product per C2
            # channel; sigmoid per pixel; x * psi per channel
            return Case(lambda: tapconv.lgag_gate(*args),
                        lambda: tapconv.lgag_gate_ref(*args), None,
                        3 * size(dt) * n * C + 4 * 53 * C2,
                        n * (105 * C2 + 10 + C), "fp32")
        return make

    stages = model_stages(enc_name)
    # the decoder's CustomFfn blocks, coarse to fine: (side, C, hidden 4C,
    # blocks); gm_tiny (14, 348, 1392, 3), (28, 128, 512, 2), (56, 64, 256, 2)
    ffn_blocks = [(S, C, 4 * C, n) for (S, C, _), n in zip(
        stages[2::-1], EMCAD.FRONT_DEPTHS)]
    S1, D1 = stages[0][0], stages[0][1] // 4
    S3, C3 = stages[2][:2]
    src = "ceigm_unet_tpu_torch/csrc/"
    return {
        "quad_scan_ln": ("cuda", src + "quad_scan_ln.cu",
                         "ceigm_unet_tpu/ops/quad_scan.py:542",
                         [(tag, n, quad(S, S, D))
                          for tag, n, S, D in scan_shapes(enc_name)]
                         + [(f"{S1}x{S1} D{D1}, contiguous (B, K, L, D) "
                             "operands (not on the path)", 0,
                             quad(S1, S1, D1, model_layout=False)),
                            (f"{S1}x{S1} D{D1}, long memory (not on the "
                             "path)", 0, quad(S1, S1, D1, long_memory=True))]
                         # the 64x64 maps: L 256 down to 4
                         + [(f"{S}x{S} D{D} (64x64, phase {phase64})", 0,
                             quad(S, S, D))
                            for _, _, S, D in traj_shapes(
                                scan_shapes(enc_name))]),
        "cffn_gemm": ("cuda", src + "cffn_gemm.cu",
                      "ceigm_unet_tpu/ops/ffn_pallas.py:114",
                      [(f"fc1 {s}x{s} {c}->{h}", n, gemm(s * s, c, h, False))
                       for s, c, h, n in ffn_blocks]
                      + [(f"fc2 {s}x{s} {h}->{c}", n, gemm(s * s, h, c, True))
                         for s, c, h, n in ffn_blocks]),
        "cffn_dw3_inception7": ("cuda", src + "cffn.cu",
                                "ceigm_unet_tpu/ops/ffn_pallas.py:114",
                                [(f"{s}x{s} HID{h}", n, stencil(s, s, h))
                                 for s, c, h, n in ffn_blocks]),
        "dysample_grid_sample": ("cuda", src + "grid_sample.cu",
                                 "ceigm_unet_tpu/ops/grid_sample.py:432",
                                 # each DySample's input: stages 4, 3, 2
                                 [(f"{S}->{2 * S} C{C}", 1, gsample(S, S, C))
                                  for S, C, _ in stages[:0:-1]]
                                 + [(f"{S3}->{2 * S3} C{C3}, grid far outside"
                                     " [-1, 1] (not on the path)", 0,
                                     gsample(S3, S3, C3, 4.0))]),
        "lgag_gate": ("cuda", src + "lgag.cu",
                      "ceigm_unet_tpu/ops/tapconv.py:117",
                      [(f"{S}x{S} C{C}", 1, lgag(S, S, C))
                       for S, C, _ in stages[2::-1]]),
    }


def phase_kernels(dev, gpu, kernels, per="forward", extra=(), timed=()):
    """Each kernel of ``kernels`` (as :func:`kernel_cases` gives them)
    against its plain version at b2 fp32, b2 bf16, each (batch, dtype) of
    ``extra`` and b128 bf16, and timed at b128 bf16 per ``per`` (the
    forward, or the backward of one): with the host in the loop (``ms``,
    ``library_ms``) and as the device's work alone, the calls queued behind
    a spin kernel (``device_ms``, ``library_device_ms``). Each (batch,
    dtype) of ``timed`` (one of ``extra``) is timed the same way, beside its
    bound (``ms_b32_fp32``, ``device_ms_b32_fp32``, ``library_ms_b32_fp32``,
    ``library_device_ms_b32_fp32``, ``bound_ms_b32_fp32`` for b32 fp32)."""
    from ceigm_unet_tpu_torch.kernel_ab import device_time
    results = {}
    bf16 = torch.bfloat16
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")
    for name, (route, source, replaces, cases) in kernels.items():
        errs = dict.fromkeys([(2, torch.float32), (2, bf16), *extra,
                              (128, bf16)], 0.0)
        at = {bd: {} for bd in timed}
        ms = plain_ms = bound = bytes_ms = ops_ms = dev_ms = 0.0
        library_ms = library_dev_ms = None
        for tag, calls, make in cases:
            for batch, dt in errs:
                case = make(batch, dt)
                err = compare(case.kern(), case.plain(), case.tol or dt)
                errs[batch, dt] = max(errs[batch, dt], err)
                if (batch, dt) not in at:
                    continue
                t = {"ms": time_ms(case.kern, 10),
                     "device_ms": device_time(case.kern, 10),
                     "bound_ms": case.bound_ms()}
                if case.library is not None:
                    t["library_ms"] = time_ms(case.library, 10)
                    t["library_device_ms"] = device_time(case.library, 10)
                for k, v in t.items():
                    at[batch, dt][k] = at[batch, dt].get(k, 0.0) + calls * v
                log(f"kernel {name} [{tag}] x{calls}/{per}: b{batch} "
                    f"{DTAG[dt]} {t['ms']:.4f} ms (device "
                    f"{t['device_ms']:.4f} ms), library "
                    + (f"{t['library_ms']:.4f} ms (device "
                       f"{t['library_device_ms']:.4f} ms)"
                       if "library_ms" in t else "none")
                    + f", bound {t['bound_ms']:.4f} ms ({case.bound_by()}) "
                    f"| {gpu}")
            # case: the batch-128 bf16 call, already checked
            k_ms, p_ms = time_ms(case.kern, 10), time_ms(case.plain, 3)
            kd_ms = device_time(case.kern, 10)
            ms += calls * k_ms
            dev_ms += calls * kd_ms
            plain_ms += calls * p_ms
            bound += calls * case.bound_ms()
            bytes_ms += calls * case.nbytes / HBM_BPS * 1e3
            ops_ms += calls * case.ops / PEAK[case.peak] * 1e3
            lib = "none"
            if case.library is not None:
                lib_ms = time_ms(case.library, 10)
                libd_ms = device_time(case.library, 10)
                library_ms = (library_ms or 0.0) + calls * lib_ms
                library_dev_ms = (library_dev_ms or 0.0) + calls * libd_ms
                lib = f"{lib_ms:.4f} ms (device {libd_ms:.4f} ms)"
            log(f"kernel {name} [{tag}] x{calls}/{per}: b128 bf16 "
                f"{k_ms:.4f} ms (device {kd_ms:.4f} ms), plain "
                f"{p_ms:.4f} ms, library {lib}, bound "
                f"{case.bound_ms():.4f} ms ({case.bound_by()}), max abs err "
                f"{err:.3e} | {gpu}")
            del case
        timed_keys = {}
        for (b, d), t in at.items():
            timed_keys.update({f"{k}_b{b}_{DTAG[d]}": t.get(k) for k in keys})
            log(f"kernel {name}: per b{b} {DTAG[d]} {per} {t['ms']:.3f} ms "
                f"(device {t['device_ms']:.3f} ms), library "
                + (f"{t['library_ms']:.3f} ms (device "
                   f"{t['library_device_ms']:.3f} ms)" if "library_ms" in t
                   else "none")
                + f", bound {t['bound_ms']:.4f} ms | {gpu}")
        log(f"kernel {name}: max abs err " + ", ".join(
            f"b{b} {DTAG[d]} {e:.3e}" for (b, d), e in errs.items())
            + f"; per b128 bf16 {per} "
            f"{ms:.3f} ms (device {dev_ms:.3f} ms) vs plain "
            f"{plain_ms:.3f} ms, library {library_ms} (device "
            f"{library_dev_ms}), bound {bound:.4f} ms")
        results[name] = dict(
            name=name, route=route, source=source, replaces=replaces,
            max_abs_err=errs[2, torch.float32],
            max_abs_err_bf16=errs[2, bf16],
            max_abs_err_bf16_b128=errs[128, bf16],
            **{f"max_abs_err_b{b}_{DTAG[d]}": errs[b, d] for b, d in extra},
            ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, device_ms=dev_ms,
            library_device_ms=library_dev_ms, **timed_keys)
    torch.cuda.empty_cache()
    return results


# --- phases 4-6 -------------------------------------------------------------

def model_stages(enc_name="gm_tiny"):
    """(side, channels, quad blocks) of each stage of a 224x224 forward of
    the GroupMamba configuration ``enc_name``: its encoder blocks there and
    EMCAD's Front blocks (3 at 14x14, 2 at 28x28, 2 at 56x56). gm_tiny:
    (56, 64, 5), (28, 128, 6), (14, 348, 12), (7, 448, 3)."""
    from ceigm_unet_tpu_torch.models.emcad import EMCAD
    from ceigm_unet_tpu_torch.models.groupmamba import GROUPMAMBA_CONFIGS
    cfg = GROUPMAMBA_CONFIGS[enc_name]
    front = (*EMCAD.FRONT_DEPTHS[::-1], 0)
    return [(IMG // 4 >> i, c, d + f) for i, (c, d, f) in enumerate(
        zip(cfg["embed_dims"], cfg["depths"], front))]


def per_forward(enc_name="gm_tiny"):
    """Launches of one 224x224 forward: a quad block per encoder block and
    7 decoder ones (gm_tiny 19 + 7); 7 CustomFfn (2 GEMMs + the stencil
    between them each); 3 DySample; 3 LGAG."""
    return {"quad_scan_ln": sum(n for *_, n in model_stages(enc_name)),
            "cffn_gemm": 14, "cffn_dw3_inception7": 7,
            "dysample_grid_sample": 3, "lgag_gate": 3}


PER_FORWARD = per_forward()


def check_counts(counts, forwards: int, what: str, per_forward=PER_FORWARD):
    want = {k: v * forwards for k, v in per_forward.items()}
    if dict(counts) != want:
        fail(f"{what}: kernel launches {dict(counts)}, expected {want}")


def model_input():
    """Phase 4's b2 224x224 input."""
    return torch.randn((2, IMG, IMG, 1),
                       generator=torch.Generator().manual_seed(SEED + 1))


def _cpu_logits(enc_name, threads=2):
    """Phase 4's CPU reference for ``enc_name`` (no routes): the fp32
    logits of :func:`model_input` on ``threads`` threads, in a process of
    its own (phase 27's pool), and the forward's seconds."""
    from ceigm_unet_tpu_torch.models import build_model
    torch.set_num_threads(threads)
    model = build_model(num_classes=9, enc_name=enc_name, seed=SEED,
                        device="cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model(model_input())
    return want, time.perf_counter() - t0


def phase_model(dev, routes=None, per_forward=PER_FORWARD, what="gm_tiny",
                fp32_tol=None, enc_name="gm_tiny", cpu=None):
    """``enc_name`` built with ``routes`` (build_model's route arguments)
    at b2 fp32 on the card against the CPU (phase 4's tolerance, or
    ``fp32_tol`` * max|logit| alone; with ``cpu``, the pending result of
    :func:`_cpu_logits`, the CPU's logits come from there), the launches of
    one forward, then the bf16 forward against the fp32 CPU logits. Returns
    the model in bf16 on the card, and the input and CPU logits."""
    from ceigm_unet_tpu_torch.models import build_model
    from ceigm_unet_tpu_torch.ops import _build
    model = build_model(num_classes=9, enc_name=enc_name, seed=SEED,
                        device="cpu", **(routes or {}))
    x = model_input()
    if cpu is None:
        t0 = time.perf_counter()
        with torch.no_grad():
            want = model(x)
        cpu_s = time.perf_counter() - t0
    else:
        want, cpu_s = cpu.get(timeout=900)
    model.to(dev)
    _build.reset_launch_counts()
    with torch.no_grad():
        got = model(x.to(dev))
    torch.cuda.synchronize()
    check_counts(_build.launch_counts, 1, f"one {what} forward", per_forward)
    got = got.cpu()
    if got.shape != (2, IMG, IMG, 9) or not bool(torch.isfinite(got).all()):
        fail(f"logits {tuple(got.shape)} not finite or wrong shape")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rtol, atol = (0.0, fp32_tol) if fp32_tol else MODEL_TOL
    if bool(((got - want).abs() > atol * scale + rtol * want.abs()).any()):
        fail(f"{what} logits on the card differ from the CPU: max abs err "
             f"{err:.3e}, max|logit| {scale:.3e}")
    log(f"model {what} 224x224 b2 fp32: card vs CPU max abs err {err:.3e} "
        f"(max|logit| {scale:.3e}, tol rtol {rtol} atol {atol}*max); "
        f"launches {dict(_build.launch_counts)}; CPU forward {cpu_s:.1f} s"
        + (" (in phase 27's pool)" if cpu is not None else ""))
    model.dtype = torch.bfloat16
    with torch.no_grad():
        got = model(x.to(dev))
    if got.dtype != torch.bfloat16:
        fail(f"bf16 forward returned {got.dtype} logits")
    bf_err = check_bf16(got, want, f"{what} b2 bf16 logits on the card vs "
                        "fp32 on the CPU")
    log(f"model {what} 224x224 b2 bf16: card vs fp32 CPU max abs err "
        f"{bf_err:.3e} (max|logit| {scale:.3e}, tol {BF16_MODEL_TOL}*max)")
    return model, x, want


def check_bf16(got, want, what: str) -> float:
    """Max abs error of bf16 logits against fp32 ones; fails past
    BF16_MODEL_TOL * max|want|."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: {tuple(got.shape)} not finite or wrong shape")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > BF16_MODEL_TOL * scale:
        fail(f"{what}: max abs err {err:.3e} > {BF16_MODEL_TOL} * "
             f"max|fp32| {scale:.3e}")
    return err


def synthetic_volumes():
    """Two seeded synthetic CT volumes of 40 x 512 x 512: smooth CT-like
    intensities in [0, 1] (low-frequency noise)."""
    rng = np.random.default_rng(SEED)
    volumes = []
    for _ in range(2):
        coarse = rng.random((40, 16, 16)).astype(np.float32)
        vol = np.kron(coarse, np.ones((1, 32, 32), np.float32))
        volumes.append(np.clip(vol + 0.05 * rng.standard_normal(
            vol.shape).astype(np.float32), 0, 1))
    return volumes


def phase_serving(model, dev, gpu, per_forward=PER_FORWARD,
                  what="gm_tiny"):
    from ceigm_unet_tpu_torch.eval.volume import predict_volume
    from ceigm_unet_tpu_torch.ops import _build
    volumes = synthetic_volumes()
    _build.reset_launch_counts()
    times = []
    for vol in volumes:
        t0 = time.perf_counter()
        pred = predict_volume(model, vol, (IMG, IMG), batch_size=32)
        times.append((time.perf_counter() - t0) * 1e3)
        if pred.shape != vol.shape or pred.min() < 0 or pred.max() >= 9:
            fail(f"label map {pred.shape} or labels outside [0, 9)")
    counts = dict(_build.launch_counts)
    check_counts(counts, 4, f"{what}: serving two 40-slice volumes at batch "
                 f"32", per_forward)
    log(f"serving {what}: 2 volumes (40, 512, 512) bf16 batch 32: "
        f"{times[0]:.1f} ms, {times[1]:.1f} ms per volume "
        f"(first includes warm-up) | {gpu}")
    return counts


def phase_throughput(model, dev, gpu, what="gm_tiny"):
    """The b128 bf16 forward, timed; returns (slices/s, peak GiB)."""
    x = torch.randn((128, IMG, IMG, 1), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 2))
    ts = []
    with torch.no_grad():
        for i in range(13):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if i == 3:
                torch.cuda.reset_peak_memory_stats()
            start.record()
            logits = model(x)
            end.record()
            end.synchronize()
            if i >= 3:
                ts.append(start.elapsed_time(end))
        mem = torch.cuda.max_memory_allocated() / 2**30
        model.dtype = torch.float32
        want = model(x)
        model.dtype = torch.bfloat16
    err = check_bf16(logits, want, f"{what} b128 bf16 logits vs the fp32 "
                     f"forward")
    med = statistics.median(ts)
    spread = (max(ts) - min(ts)) / (2 * med)
    log(f"throughput {what} b128 224x224 bf16: {128e3 / med:.2f} slices/s, "
        f"median {med:.3f} ms over {len(ts)} runs, spread "
        f"+-{100 * spread:.2f}%, "
        f"max memory {mem:.2f} GiB; logits vs fp32 on the card max abs err "
        f"{err:.3e} (max|logit| {want.abs().max().item():.3e}, tol "
        f"{BF16_MODEL_TOL}*max) | {gpu}")
    return 128e3 / med, mem


# --- phases 7-9: training ---------------------------------------------------

TRAIN_BATCH = 48


def scan_shapes(enc_name="gm_tiny"):
    """(tag, quad blocks at that shape in a 224x224 forward, side, D per
    group) of ``enc_name``: each block's backward runs K8 twice (h again,
    then the adjoint)."""
    return [(f"{S}x{S} D{C // 4}", n, S, C // 4)
            for S, C, n in model_stages(enc_name)]


def per_train_step(enc_name="gm_tiny"):
    """Launches of one unfrozen train step: the forward's but LGAG (its
    train-mode BatchNorm runs in PyTorch), and K8 twice per quad block."""
    per = per_forward(enc_name)
    del per["lgag_gate"]
    return dict(per, scan2d=2 * per["quad_scan_ln"])


TRAIN_SCAN_SHAPES = scan_shapes()
PER_TRAIN_STEP = per_train_step()
# a frozen step runs no encoder backward, so only the 7 decoder blocks' 14
# scans
FROZEN_SCANS = 14
PHASE8_IMG = 224
# biases that feed a train-mode BatchNorm (LGAG's six branch convs and its
# psi conv): the batch mean removes them, so their true gradient is 0
BN_CANCELLED = re.compile(r"\.lgag\d\.(W_[gx]_\d|psi\.0)\.bias$")
GRAD_FLOOR = 2e-3              # gradient rtol, and atol / max|CPU grad|
# a card gradient may use up to this multiple of the share of its
# tolerance that the same tensor uses when the CPU runs on fewer threads
NOISE_MARGIN = 2.0
BF16_GRAD_COSINE = 0.9


def phase_scan2d(dev, gpu, shapes=TRAIN_SCAN_SHAPES, batches=(TRAIN_BATCH,),
                 what="gm_tiny", layout=None):
    """K8 against its plain version at each of ``shapes`` ((tag, calls per
    unfrozen step, side, D)) at each of ``batches``, both modes, fp32
    (TF32 off), on contiguous operands and in the layout the backward hands
    it (``kernel_ab.MODEL_LAYOUT[layout or what]``), and on a long-memory
    case; timed at the last batch through the wrapper in the model's layout
    (what the path runs) with the host in the loop (``ms``) and as device
    time (``device_ms``), beside the plain version. Returns the kernel's
    entry for the kernels line, and the per-step sums."""
    from ceigm_unet_tpu_torch.kernel_ab import MODEL_LAYOUT, device_time
    from ceigm_unet_tpu_torch.ops import quad_scan
    gen = torch.Generator().manual_seed(SEED)
    err = ms = dev_ms = plain_ms = bound = 0.0
    modes = (("scan", quad_scan.scan2d, quad_scan.scan2d_ref, False),
             ("adjoint", quad_scan.scan2d_adjoint,
              quad_scan.scan2d_adjoint_ref, True))

    def check(a, b, S, kern, plain, adjoint):
        am, bm = [t.permute(o).contiguous().permute(o) for t, o in
                  zip((a, b), MODEL_LAYOUT[layout or what][adjoint])]
        e = 0.0
        for dirs in ((1, 2, 3, 4), (4, 3, 2, 1)):
            want = plain(a, b, S, S, dirs)
            e = max(e, compare(kern(a, b, S, S, dirs), want, torch.float32),
                    compare(kern(am, bm, S, S, dirs), want, torch.float32))
        return e, am, bm

    # long memory (not on the path): decays within 1e-4 of 1, so the state
    # carries across every run of the 56x56 walk
    S, D = shapes[0][2], shapes[0][3]
    shape = (2, 4, S * S, D)
    a = 1 - 1e-4 * torch.rand(shape, generator=gen).to(dev)
    b = torch.randn(shape, generator=gen).to(dev)
    for mode, kern, plain, adjoint in modes:
        e, *_ = check(a, b, S, kern, plain, adjoint)
        err = max(err, e)
        log(f"kernel scan2d [{what} {S}x{S} D{D} long memory {mode}] b2 "
            f"fp32: max abs err {e:.3e} (contiguous and model layout)")
    for tag, calls, S, D in shapes:
        for batch in batches:
            shape = (batch, 4, S * S, D)
            # decays in (0, 1), mostly near 1: long memories, as the
            # model's
            a = torch.sigmoid(torch.randn(shape, generator=gen) * 2 + 2).to(
                dev)
            b = torch.randn(shape, generator=gen).to(dev)
            n = a.numel()
            for mode, kern, plain, adjoint in modes:
                e, am, bm = check(a, b, S, kern, plain, adjoint)
                err = max(err, e)
                if batch != batches[-1]:
                    continue
                dirs = (1, 2, 3, 4)
                k_ms = time_ms(lambda: kern(am, bm, S, S, dirs), 10)
                kd_ms = device_time(lambda: kern(am, bm, S, S, dirs), 10)
                p_ms = time_ms(lambda: plain(a, b, S, S, dirs), 3)
                # a and b read, the result written, fp32; one FMA per
                # element
                b_ms = max(12 * n / HBM_BPS, 2 * n / PEAK["fp32"]) * 1e3
                ms += calls * k_ms
                dev_ms += calls * kd_ms
                plain_ms += calls * p_ms
                bound += calls * b_ms
                log(f"kernel scan2d [{what} {tag} {mode}] x{calls}/train "
                    f"step: b{batch} fp32, model layout {k_ms:.4f} ms "
                    f"(device {kd_ms:.4f} ms), plain {p_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms (bytes), max abs err {e:.3e} | {gpu}")
                del am, bm
            del a, b
    log(f"kernel scan2d {what}: max abs err fp32 {err:.3e} at b{batches}; "
        f"per b{batches[-1]} train step {ms:.3f} ms (device {dev_ms:.3f} "
        f"ms) vs plain {plain_ms:.3f} ms, bound {bound:.4f} ms")
    torch.cuda.empty_cache()
    return dict(name="scan2d", route="cuda",
                source="ceigm_unet_tpu_torch/csrc/scan2d.cu",
                replaces="ceigm_unet_tpu/ops/quad_scan.py:176 _scan2d_kernel",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=None, device_ms=dev_ms)


def _trainer(model, dev, base_lr=5e-4):
    """The training CLIs' step: AdamW (weight decay 1e-3) on the per-epoch
    cosine from ``base_lr`` (the CLIs' 5e-4)."""
    from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr,
                                                      make_optimizer,
                                                      make_train_step,
                                                      param_groups)
    from ceigm_unet_tpu_torch.entry import SYNAPSE_STEPS_PER_EPOCH
    return make_train_step(
        model, make_optimizer(param_groups(model), 1e-3),
        cosine_lr(base_lr, 1e-6, 300, SYNAPSE_STEPS_PER_EPOCH))


def grad_tolerance_used(got, want) -> float:
    """The largest share of the gradient tolerance an element uses: rtol
    GRAD_FLOOR and atol 1e-8 + GRAD_FLOOR * max|want|, as
    tests/test_torch_grad_parity.py compares gradients (1e-8: a bias ahead
    of a train-mode BatchNorm has a true gradient of 0 and holds only
    rounding noise). Above 1 fails."""
    tol = 1e-8 + GRAD_FLOOR * (want.abs().max() + want.abs())
    return ((got - want).abs() / tol).max().item()


def _step_model(legacy, routes, device, img, enc_name="gm_tiny"):
    """Phase 8's model (``enc_name`` built with ``routes``; with ``legacy``
    tiny_0230s) and batch, at ``img``."""
    from ceigm_unet_tpu_torch.entry import synthetic_batch
    from ceigm_unet_tpu_torch.models import build_legacy_model, build_model
    if legacy:
        model = build_legacy_model(num_classes=9, enc_name="tiny_0230s",
                                   seed=SEED, device=device)
    else:
        model = build_model(num_classes=9, enc_name=enc_name, seed=SEED,
                            device=device, **(routes or {}))
    return model, synthetic_batch(2, img, 9, SEED, "cpu")


def _float64_step(legacy, routes, img, threads=2, enc_name="gm_tiny"):
    """The exact reference of :func:`phase_train_vs_cpu`: its step on the
    CPU in float64 (:func:`float64_compute`) on ``threads`` threads, in a
    process of its own (phase 27's pool), from the same fp32 weights cast.
    Returns the loss and every gradient."""
    torch.set_num_threads(threads)
    model, batch = _step_model(legacy, routes, "cpu", img, enc_name)
    model = model.double()
    model.dtype = torch.float64
    step = _trainer(model, "cpu")
    with float64_compute():
        loss = step({"image": batch["image"].double(),
                     "label": batch["label"]},
                    generator=torch.Generator().manual_seed(SEED))["loss"]
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _step(legacy, routes, device, img, enc_name="gm_tiny"):
    """One unfrozen step of :func:`_step_model`'s model with its
    ``_trainer`` on ``device``, launch counters reset just before and read
    just after: (loss, {parameter: gradient}, {BN running statistic:
    value}, launches, seconds)."""
    from ceigm_unet_tpu_torch.ops import _build
    model, batch = _step_model(legacy, routes, device, img, enc_name)
    step = _trainer(model, device)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    loss = step({k: v.to(device) for k, v in batch.items()},
                generator=torch.Generator().manual_seed(SEED))["loss"]
    return (loss.item(), {n: p.grad for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers() if "running" in n},
            dict(_build.launch_counts), time.perf_counter() - t0)


def _cpu_step(enc_name, img, threads=2):
    """:func:`phase_train_vs_cpu`'s CPU fp32 step of ``enc_name`` on
    ``threads`` threads, in a process of its own (phase 27's pool)."""
    torch.set_num_threads(threads)
    return _step(False, None, "cpu", img, enc_name)


def phase_train_vs_cpu(dev, gpu, routes=None, per_step=PER_TRAIN_STEP,
                       legacy=False, img=PHASE8_IMG, exact=None,
                       enc_name="gm_tiny", cpu=None):
    """One unfrozen train step of ``enc_name`` (fp32, TF32 off, b2 at
    ``img``; the model built with ``routes``, launching ``per_step``; with
    ``legacy`` the legacy tiny_0230s model instead) on the card
    and on the CPU from the same weights, batch and drop-path masks (one
    seeded CPU generator on each side): loss, every gradient, the BN
    running statistics, and the card's launches. The CPU step runs again
    on fewer threads, which only reorders its sums: how far that moves a
    tensor's gradient is that tensor's noise floor, which the card's
    gradient of it is read against. With ``exact`` (the pending result of
    :func:`_float64_step` for the same model and size), the float64 step
    takes the place of the runs on fewer threads, and the floor is how far
    the CPU's fp32 gradient lies from that exact one: the CPU's reordered
    runs may round alike, and then measure nothing. With ``cpu`` (the
    pending result of :func:`_cpu_step`), the CPU's fp32 step comes from
    there."""
    what = "tiny_0230s" if legacy else f"{enc_name} {routes or ''}"
    threads = torch.get_num_threads()
    reorders = [] if exact else sorted(
        {max(1, threads // 2), max(1, threads // 4), 1} - {threads},
        reverse=True)
    runs, truth = {}, {}
    for tag, device, n_threads in (
            ([] if cpu else [("cpu", "cpu", threads)])
            + [(f"cpu on {n}", "cpu", n) for n in reorders]
            + [("card", dev, threads)]):
        torch.set_num_threads(n_threads)
        runs[tag] = _step(legacy, routes, device, img, enc_name)
    torch.set_num_threads(threads)
    if cpu:
        runs["cpu"] = cpu.get(timeout=900)
    if exact:
        l_exact, truth = exact.get(timeout=900)
    (l_cpu, cpu_g, cpu_b, _, cpu_s), (l_dev, dev_g, dev_b, counts, dev_s) = \
        runs["cpu"], runs["card"]
    if counts != per_step:
        fail(f"one train step: kernel launches {counts}, expected "
             f"{per_step}")
    if not abs(l_dev - l_cpu) <= 1e-4 * abs(l_cpu):
        fail(f"train-step loss on the card {l_dev} vs the CPU {l_cpu}")
    reorder_g = [runs[f"cpu on {n}"][1] for n in reorders]
    # per tensor: (card's share / its limit, card's share, own floor, the
    # card's and the CPU's shares against the exact gradient)
    rows = {}
    for name, grad in dev_g.items():
        want = cpu_g[name]
        got = grad.cpu()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite gradient on the card")
        used = grad_tolerance_used(got, want)
        # a share the CPU reaches against itself by reordering its sums, or
        # against the exact gradient, is fp32 noise of this tensor in this
        # step, not a fault of the card
        floors = [grad_tolerance_used(r[name], want) for r in reorder_g]
        vs_exact = ()
        if exact:
            e = truth[name]
            vs_exact = (grad_tolerance_used(got.double(), e),
                        grad_tolerance_used(want.double(), e))
            floors.append(vs_exact[1])
        floor = max(floors, default=0.0)
        rows[name] = (used / max(1.0, NOISE_MARGIN * floor), used, floor,
                      *vs_exact)
    fmt = lambda names: [(n, *(round(v, 3) for v in rows[n][1:]))
                         for n in names]
    worst = sorted(rows, key=lambda n: rows[n][0], reverse=True)
    noisy = sorted((n for n in rows if NOISE_MARGIN * rows[n][2] > 1.0),
                   key=lambda n: rows[n][2], reverse=True)
    log(f"train step {what} {img}x{img} gradients, share of the tolerance "
        f"used (rtol {GRAD_FLOOR}, atol 1e-8 + {GRAD_FLOOR}*max|CPU grad|) "
        f"as (tensor, card vs CPU, its floor: "
        + ("the CPU vs float64; card vs float64, CPU vs float64" if exact
           else f"the largest of the CPU on {reorders} threads vs {threads}")
        + f"): card above 1 {fmt(n for n in worst if rows[n][1] > 1.0)}; "
        f"nearest their limit {fmt(worst[:5])}; {len(noisy)} tensors whose "
        f"floor lifts their limit above 1, noisiest {fmt(noisy[:5])}")
    if rows[worst[0]][0] > 1.0:
        fail(f"{worst[0]}: gradient uses {rows[worst[0]][1]:.3f} of its "
             f"tolerance, past max(1, {NOISE_MARGIN} x its CPU floor "
             f"{rows[worst[0]][2]:.3f})")
    stat_err = 0.0
    for name, b in dev_b.items():
        e = (b.cpu() - cpu_b[name]).abs()
        if bool((e > 1e-5 + 1e-4 * cpu_b[name].abs()).any()):
            fail(f"{name}: running statistic differs from the CPU by "
                 f"{e.max().item():.3e}")
        stat_err = max(stat_err, e.max().item())
    n = len(dev_g)
    log(f"train step {what} {img}x{img} b2 "
        f"fp32 card vs CPU:"
        f" loss {l_dev:.6f} vs {l_cpu:.6f}"
        + (f" (float64 {l_exact:.6f})" if exact else "")
        + f"; {n} gradients within their "
        f"tolerance or {NOISE_MARGIN}x their own floor (nearest: "
        f"{worst[0]} at {rows[worst[0]][0]:.3f} of its limit); BN running "
        f"stats max abs err {stat_err:.3e}; launches {counts}; CPU step "
        f"{cpu_s:.1f} s" + (" (in phase 27's pool)" if cpu else "")
        + f", card step {dev_s:.1f} s (first, with warm-up) | {gpu}")
    del runs


def watch_dead_relus(model, dead: set) -> list:
    """Forward hooks on every GroupMambaLayer's SE bottleneck (fc1 -> ReLU
    -> fc2; 4 units in gm_tiny's first stage): where the ReLU is off for
    every sample, fc1's weight and bias and fc2's weight have a true
    gradient of 0, and their names go into ``dead``."""
    from ceigm_unet_tpu_torch.models.groupmamba import GroupMambaLayer

    def hook(name):
        def record(module, inputs, out):
            if not bool((out > 0).any()):
                dead.update(f"{name}.{p}" for p in ("fc1.weight", "fc1.bias",
                                                    "fc2.weight"))
        return record
    return [m.fc1.register_forward_hook(hook(name))
            for name, m in model.named_modules()
            if isinstance(m, GroupMambaLayer)]


def _flat_grad(model):
    return torch.cat([p.grad.float().reshape(-1) for p in model.parameters()])


def _train_run(dev, dtype, frozen_flags, routes=None, legacy=False,
               enc_name="gm_tiny", batch_size=TRAIN_BATCH):
    """``entry.train_entry`` of ``enc_name`` at ``batch_size`` built with
    ``routes`` (with ``legacy``, ``entry.legacy_train_entry``), stepped once
    per flag (True: encoder frozen), launch counters reset just before and
    read just after (also each step's apart, the last of the returns);
    fails if a frozen step moves the encoder."""
    from ceigm_unet_tpu_torch.entry import legacy_train_entry, train_entry
    from ceigm_unet_tpu_torch.ops import _build
    if legacy:
        model, step, batch = legacy_train_entry(dev, dtype, batch_size,
                                                SEED)
    else:
        model, step, batch = train_entry(dev, dtype, batch_size, SEED,
                                         enc_name=enc_name, **(routes or {}))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    enc0 = [p.detach().clone() for p in model.encoder.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times, zero, dead, steps = [], [], None, set(), []
    first = frozen_flags.index(False)
    for i, frozen in enumerate(frozen_flags):
        hooks = watch_dead_relus(model, dead) if i == first else []
        before = dict(_build.launch_counts)
        t0 = time.perf_counter()
        losses.append(step(batch, freeze_encoder=frozen,
                           generator=gen)["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append({k: v - before.get(k, 0)
                      for k, v in _build.launch_counts.items()
                      if v != before.get(k, 0)})
        for h in hooks:
            h.remove()
        if frozen and not all(torch.equal(p, q) for p, q in zip(
                model.encoder.parameters(), enc0)):
            fail(f"step {i}: an encoder parameter moved while frozen")
        if i == first:
            # the first step through the whole graph
            zero = [n for n, p in model.named_parameters()
                    if not BN_CANCELLED.search(n) and n not in dead
                    and not bool(p.grad.abs().max() > 0)]
    counts = dict(_build.launch_counts)
    mem = torch.cuda.max_memory_allocated() / 2**30
    return (model, enc0, losses, times, counts, mem, zero, sorted(dead),
            batch, gen, steps)


def phase_trainer(dev, gpu):
    """The trainer at full width (the training main path): gm_tiny b48
    224x224 bf16 (fp32 parameters), 2 frozen-encoder steps then 8 unfrozen
    ones; then 3 fp32 steps, and the bf16-vs-fp32 gradient cosine of one b2
    step. Returns the launch counts of the 10 bf16 steps and the median
    unfrozen bf16 ms/step."""
    from ceigm_unet_tpu_torch.entry import train_entry
    from ceigm_unet_tpu_torch.losses import dice_ce_loss

    flags = [True] * 2 + [False] * 8
    model, enc0, losses, times, counts, mem, zero, dead, batch, gen, _ = \
        _train_run(dev, torch.bfloat16, flags)
    want = {k: v * 10 for k, v in PER_TRAIN_STEP.items()}
    want["scan2d"] = 2 * FROZEN_SCANS + 8 * PER_TRAIN_STEP["scan2d"]
    if counts != want:
        fail(f"10 train steps: kernel launches {counts}, expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses}")
    if zero:
        fail(f"all-zero gradients in the first unfrozen step: {zero}")
    for name, p in model.named_parameters():
        if not bool(torch.isfinite(p.grad).all()):
            fail(f"{name}: non-finite gradient in the last step")
    # a zero bias behind a dead ReLU has no gradient and nothing to decay
    still = [n for (n, p), q in zip(model.encoder.named_parameters(
        prefix="encoder"), enc0) if torch.equal(p, q)]
    n_enc = len(enc0)
    if not set(still) <= set(dead):
        fail(f"encoder tensors unchanged after the unfreeze: {still}")
    unfrozen = times[2:]
    med = statistics.median(unfrozen)
    # the forward and the loss alone (graph recorded, no backward): the
    # rest of a step is the backward and the optimizer
    fwd = []
    for _ in range(3):
        t0 = time.perf_counter()
        dice_ce_loss(model(batch["image"], generator=gen), batch["label"],
                     0.4, 0.6).item()
        fwd.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(fwd)
    log(f"trainer gm_tiny b{TRAIN_BATCH} 224x224 bf16: losses "
        f"{[round(v, 5) for v in losses]}; frozen steps "
        f"{[round(t, 1) for t in times[:2]]} ms; unfrozen median {med:.3f} "
        f"ms/step over {len(unfrozen)} (min {min(unfrozen):.3f}, max "
        f"{max(unfrozen):.3f}), {TRAIN_BATCH * 1e3 / med:.2f} slices/s, of "
        f"which the forward and loss {fwd_ms:.3f} ms; peak memory "
        f"{mem:.2f} GiB; encoder unchanged over the frozen steps, "
        f"{n_enc - len(still)} of {n_enc} tensors changed after (unchanged: "
        f"{still}); all-zero gradients in the first "
        f"unfrozen step only behind a ReLU that is off for every sample: "
        f"{dead} | {gpu}")
    del model, enc0, batch
    torch.cuda.empty_cache()

    model, _, losses32, times32, _, mem32, *_ = _train_run(
        dev, torch.float32, [False] * 3)
    med32 = statistics.median(times32)
    log(f"trainer gm_tiny b{TRAIN_BATCH} 224x224 fp32 (TF32 off): losses "
        f"{[round(v, 5) for v in losses32]}; median {med32:.3f} ms/step "
        f"over 3 ({[round(t, 1) for t in times32]}), peak memory "
        f"{mem32:.2f} GiB | {gpu}")
    del model
    torch.cuda.empty_cache()

    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        model, step, batch = train_entry(dev, dtype, 2, SEED)
        step(batch, generator=torch.Generator().manual_seed(SEED))
        grads.append(_flat_grad(model))
        del model, step
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1],
                                                dim=0).item()
    if not cos >= BF16_GRAD_COSINE:
        fail(f"bf16 vs fp32 gradient cosine {cos:.6f} < {BF16_GRAD_COSINE}")
    log(f"trainer b2 bf16 vs fp32 gradients: cosine {cos:.6f} (fails below "
        f"{BF16_GRAD_COSINE})")
    return counts, med


# --- phases 10-13: the legacy MSVM-UNet (VMamba) ----------------------------

# tiny_0230s at 224x224: (side, D, SS2D blocks at that shape per forward,
# encoder + decoder); every one runs K10 once
LEGACY_SS2D_SHAPES = [(56, 96, 2 + 2), (28, 192, 2 + 2), (14, 384, 8 + 2),
                      (7, 768, 2)]
LEGACY_PER_FORWARD = {"sscan_dir": 20}
# the selective-scan op's shapes: the reference speed test's
# (tools/bench_scan.py:25; B 128, D 96, N 1, L 4096, bf16 in, fp32 out)
# with and without softplus, and d_state 16 over a 56x56 map at B 8
SCAN_CALLS = [("B128 D96 N1 L4096 softplus", (128, 96, 1, 4096), True),
              ("B128 D96 N1 L4096 no softplus", (128, 96, 1, 4096), False),
              ("B8 D96 N16 L3136 softplus", (8, 96, 16, 3136), True)]
# the kernels each call of SCAN_CALLS launches
SCAN_PATH = {"selective_scan_n1": 1, "scan_rows": 2}


def legacy_kernel_cases(dev):
    """K10 at each tiny_0230s 224x224 SS2D shape, in the form of
    :func:`kernel_cases`."""
    from ceigm_unet_tpu_torch.ops import quad_scan
    gen = torch.Generator().manual_seed(SEED)

    def rnd(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def sscan(S, D):
        def make(B, dt):
            K, L = 4, S * S
            # u: the model's stride-0 view of one activation per direction
            u = rnd((B, L, D), 1.0, dt)[:, None].expand(B, K, L, D)
            args = [u, rnd((B, K, L, D), 0.5, dt), rnd((B, K, L), 1.0, dt),
                    rnd((B, K, L), 1.0, dt), -torch.exp(rnd((K, D), 0.5)),
                    rnd((K, D), 0.3), rnd((K, D)), S, S, (1, 2, 3, 4)]
            n, size = B * K * L * D, u.element_size()
            # read once: u (one activation), dt, Bs, Cs and the (K, D)
            # constants; y written in fp32. ~12 operations per element:
            # softplus (5), the decay's exp and product, the drive (2),
            # the scan FMA, C*h + D*u (2)
            return Case(lambda: quad_scan.sscan_dir(*args),
                        lambda: quad_scan.sscan_dir_ref(*args), None,
                        size * (B * L * D + n + 2 * B * K * L) + 12 * K * D
                        + 4 * n, 12 * n, "fp32")
        return make

    return {"sscan_dir": (
        "cuda", "ceigm_unet_tpu_torch/csrc/sscan_dir.cu",
        "ceigm_unet_tpu/ops/quad_scan.py:315",
        [(f"{S}x{S} D{D}", calls, sscan(S, D))
         for S, D, calls in LEGACY_SS2D_SHAPES]
        # phase 27's 64x64 maps: L 256 down to 4
        + [(f"{S}x{S} D{D} (64x64, phase 27)", 0, sscan(S, D))
           for _, _, S, D in traj_shapes(LEGACY_SCAN_SHAPES)])}


def scan_inputs(dev, batch, dim, N, L, softplus=True):
    """Seeded selective-scan inputs after the reference speed test: u,
    delta, B, C in bf16 (B and C as (batch, 1, N, L)); A, D, delta_bias
    fp32. Without the softplus, delta + delta_bias is the step size as
    given, so both are drawn positive (a negative step makes exp(delta*A)
    > 1, and h overflows fp32 within a few thousand steps)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + N)
    sign = (lambda t: t) if softplus else torch.abs
    rnd = lambda shape, scale=1.0, dt=torch.bfloat16: (torch.randn(
        shape, generator=gen, device=dev) * scale).to(dt)
    return [rnd((batch, dim, L)), sign(rnd((batch, dim, L), 0.1)),
            -torch.exp(rnd((dim, N), 0.5, torch.float32)),
            rnd((batch, 1, N, L)), rnd((batch, 1, N, L)),
            rnd((dim,), 1.0, torch.float32),
            sign(rnd((dim,), 0.3, torch.float32))]


def phase_scan_kernels(dev, gpu):
    """K12 and K11 against their plain versions at the selective-scan
    shapes: K12 with fp32 out (the op's call) at the fp32 tolerance, since
    both compute in fp32 from the same inputs, and with bf16 out (not on
    the path) at the bf16 one; K11 at the fp32 one. Each timed beside its
    plain version, with the host in the loop and as the device's work alone
    (``device_ms``); the numbers of one pass over SCAN_CALLS (K12 once, K11
    twice)."""
    from ceigm_unet_tpu_torch.kernel_ab import device_time
    from ceigm_unet_tpu_torch.ops import selective_scan as ss
    results = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    (tag, shape, _), *k11_calls = SCAN_CALLS
    u, delta, A, B, C, D, bias = scan_inputs(dev, *shape)
    n = u.numel()
    rows["selective_scan_n1"] = [(
        f"{tag}, bf16 -> {str(od).split('.')[-1]}{note}", calls,
        lambda od=od: ss.selective_scan_n1(u, delta, A, B, C, D, bias, od),
        lambda od=od: ss.selective_scan_n1_ref(u, delta, A, B, C, D, bias,
                                               od),
        # u, delta bf16 and B, C read, y written; ~12 operations per
        # element (softplus, decay, drive, FMA, C*h + D*u)
        2 * 2 * n + 2 * 2 * B.numel() + 3 * 4 * D.numel()
        + od.itemsize * n, 12 * n, od)
        for od, calls, note in ((torch.float32, 1, ""),
                                (torch.bfloat16, 0, " (not on the path)"))]
    rows["scan_rows"] = []
    for tag, (batch, dim, N, L), _ in k11_calls:
        M = batch * dim * N
        tag = f"M {M} L {L} ({tag})"
        a = torch.sigmoid(torch.randn((M, L), generator=g, device=dev) * 2
                          + 2)
        b = torch.randn((M, L), generator=g, device=dev)
        # a and b read, h written, fp32; one FMA per element
        rows["scan_rows"].append((tag, 1,
                                  lambda a=a, b=b: ss.scan_rows(a, b),
                                  lambda a=a, b=b: ss.scan_rows_ref(a, b),
                                  12 * M * L, 2 * M * L, torch.float32))
    replaces = {"selective_scan_n1": "ceigm_unet_tpu/ops/scan_pallas.py:189",
                "scan_rows": "ceigm_unet_tpu/ops/scan_pallas.py:83"}
    for name, cases in rows.items():
        err = ms = dev_ms = plain_ms = bound = 0.0
        for tag, calls, kern, plain, nbytes, ops, tol in cases:
            e = compare(kern(), plain(), tol)
            err = max(err, e) if calls else err
            k_ms, p_ms = time_ms(kern, 10), time_ms(plain, 3)
            kd_ms = device_time(kern, 10)
            b_ms = max(nbytes / HBM_BPS, ops / PEAK["fp32"]) * 1e3
            ms, dev_ms = ms + calls * k_ms, dev_ms + calls * kd_ms
            plain_ms, bound = plain_ms + calls * p_ms, bound + calls * b_ms
            log(f"kernel {name} [{tag}] x{calls}: {k_ms:.4f} ms (device "
                f"{kd_ms:.4f} ms), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"(bytes), max abs err {e:.3e} | {gpu}")
        results[name] = dict(
            name=name, route="cuda",
            source="ceigm_unet_tpu_torch/csrc/scan_rows.cu",
            replaces=replaces[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
            library_ms=None, device_ms=dev_ms, library_device_ms=None)
    torch.cuda.empty_cache()
    return results


def phase_legacy_kernels(dev, gpu):
    """Phase 10: K10 at every tiny_0230s 224x224 shape (b2 fp32, b2 bf16,
    b128 bf16), K12 and K11 at the selective-scan shapes."""
    results = phase_kernels(dev, gpu, legacy_kernel_cases(dev))
    results.update(phase_scan_kernels(dev, gpu))
    return results


def phase_legacy_model(dev):
    """Phase 11: tiny_0230s b2 fp32 on the card against the CPU from the
    same weights, the launches of one forward (K10 only), then the bf16
    forward against the fp32 CPU logits."""
    from ceigm_unet_tpu_torch.models import build_legacy_model
    from ceigm_unet_tpu_torch.ops import _build
    model = build_legacy_model(num_classes=9, enc_name="tiny_0230s",
                               seed=SEED, device="cpu")
    x = torch.randn((2, IMG, IMG, 1),
                    generator=torch.Generator().manual_seed(SEED + 3))
    with torch.no_grad():
        want = model(x)
        model.to(dev)
        _build.reset_launch_counts()
        got = model(x.to(dev))
        torch.cuda.synchronize()
        check_counts(_build.launch_counts, 1, "one tiny_0230s forward",
                     LEGACY_PER_FORWARD)
        got = got.cpu()
        if got.shape != (2, IMG, IMG, 9) or not bool(
                torch.isfinite(got).all()):
            fail(f"legacy logits {tuple(got.shape)} not finite or wrong "
                 f"shape")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        rtol, atol = MODEL_TOL
        if bool(((got - want).abs() > atol * scale
                 + rtol * want.abs()).any()):
            fail(f"tiny_0230s logits on the card differ from the CPU: max "
                 f"abs err {err:.3e}, max|logit| {scale:.3e}")
        model.dtype = torch.bfloat16
        bf = model(x.to(dev))
    if bf.dtype != torch.bfloat16:
        fail(f"legacy bf16 forward returned {bf.dtype} logits")
    bf_err = check_bf16(bf, want, "tiny_0230s b2 bf16 logits on the card vs "
                        "fp32 on the CPU")
    log(f"model tiny_0230s {IMG}x{IMG} b2 fp32: card vs CPU max abs err "
        f"{err:.3e} (max|logit| {scale:.3e}, tol rtol {rtol} atol "
        f"{atol}*max); launches {LEGACY_PER_FORWARD}; bf16 vs fp32 CPU max "
        f"abs err {bf_err:.3e} (tol {BF16_MODEL_TOL}*max)")
    from ceigm_unet_tpu_torch.entry import legacy_entry
    entry_model, x1 = legacy_entry(dev)
    out = entry_model(x1)
    if out.grad_fn is None or not bool(torch.isfinite(out).all()):
        fail("legacy_entry's model with grad mode on: no graph or non-finite")
    log(f"legacy_entry's model called as returned, grad mode on: logits "
        f"{tuple(out.shape)} with a graph")
    del entry_model, out
    return model


def phase_legacy_serving(model, dev, gpu):
    """Phase 12: ``predict_volume`` over phase 5's volumes (the K10 main
    path: launch counts reset just before, read just after), then the b128
    bf16 throughput."""
    counts = phase_serving(model, dev, gpu, LEGACY_PER_FORWARD,
                           "tiny_0230s")
    phase_throughput(model, dev, gpu, "tiny_0230s")
    return counts


def phase_selective_scan(dev, gpu):
    """Phase 13: the public ``selective_scan`` at SCAN_CALLS (the K11/K12
    main path: counts reset just before, read just after), each result's
    first two batch rows against the op on the CPU; then each call
    timed."""
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.ops.selective_scan import selective_scan
    inputs = [(tag, scan_inputs(dev, *shape, sp), sp)
              for tag, shape, sp in SCAN_CALLS]
    _build.reset_launch_counts()
    outs = [selective_scan(*args, delta_softplus=sp, out_dtype=torch.float32)
            for _, args, sp in inputs]
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    if counts != SCAN_PATH:
        fail(f"selective_scan path: kernel launches {counts}, expected "
             f"{SCAN_PATH}")
    for (tag, args, sp), y in zip(inputs, outs):
        # rows of different batch entries are independent: the first two
        # on the CPU check the full-size launch
        head = [t[:2].cpu() if t.dim() > 2 else t.cpu() for t in args]
        want = selective_scan(*head, delta_softplus=sp,
                              out_dtype=torch.float32)
        e = compare(y[:2].cpu(), want, torch.float32)
        t_ms = time_ms(lambda: selective_scan(
            *args, delta_softplus=sp, out_dtype=torch.float32), 10)
        log(f"selective_scan [{tag}]: {t_ms:.4f} ms per call, first two "
            f"batch rows vs the CPU max abs err {e:.3e} | {gpu}")
    del inputs, outs
    torch.cuda.empty_cache()
    return counts


# --- phases 14-16: the kernel routes (K6/K7, K13, K14) ----------------------

# gm_tiny 224x224 quad blocks per shape: (side, channels Din, blocks); each
# runs K13 once forward (and its flip mode once backward) on the kernel
# route, and K14 once on the int8 route (D per group = Din / 4)
QUAD_SHAPES = model_stages()


def pergroup_shapes(enc_name="gm_tiny"):
    """DySample's per-group images at 224x224 (4 groups): (H, W, C / 4) of
    stages 4, 3, 2; gm_tiny (7, 7, 112), (14, 14, 87), (28, 28, 32)."""
    return [(S, S, C // 4) for S, C, _ in model_stages(enc_name)[:0:-1]]


PERGROUP_SHAPES = pergroup_shapes()
KERNEL_ROUTE = dict(dwconv="kernel", dysample_grouped=False)
# launches of one forward on each route, and of one unfrozen train step
PER_FORWARD_KERNEL_ROUTE = {
    **{k: v for k, v in PER_FORWARD.items() if k != "dysample_grid_sample"},
    "dwconv3x3": 26, "grid_sample_bilinear": 3}
PER_STEP_KERNEL_ROUTE = {
    **{k: v for k, v in PER_TRAIN_STEP.items()
       if k != "dysample_grid_sample"},
    "dwconv3x3": 26, "dwconv3x3_flip": 26, "grid_sample_bilinear": 3}
PER_FORWARD_INT8 = {**{k: v for k, v in PER_FORWARD.items()
                       if k != "quad_scan_ln"}, "quad_scan_ln_q8": 26}


def route_kernel_cases(dev, enc_name="gm_tiny"):
    """The route kernels, in the form of :func:`kernel_cases`, at the
    shapes of ``enc_name``: the single-grid grid-sample at DySample's
    per-group shapes and one non-2x size; K13 forward and K14 at every
    quad-block shape. K13's flip mode is returned apart (its time is per
    backward)."""
    import torch.nn.functional as F
    from ceigm_unet_tpu_torch.models.ss2d import q8
    from ceigm_unet_tpu_torch.ops import dwconv, grid_sample, quad_scan
    gen = torch.Generator().manual_seed(SEED)

    def rnd(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def gs1(H, W, C, Ho, Wo, groups, spread=None):
        # spread: as gsample's in phase 3
        def make(B, dt):
            n = groups * B
            x = rnd((n, H, W, C), 1.0, dt)
            ys = (torch.arange(Ho) + 0.5) * 2 / Ho - 1
            xs = (torch.arange(Wo) + 0.5) * 2 / Wo - 1
            base = torch.stack(torch.meshgrid(ys, xs, indexing="ij")[::-1],
                               dim=-1)
            grid = base[None].to(dev) + rnd((n, Ho, Wo, 2), spread or 0.1 / H)
            # F.grid_sample on the channels-last NCHW view of x, with the
            # grid in x's dtype (it requires one dtype)
            xv, gv = x.permute(0, 3, 1, 2), grid.to(dt)
            P = n * Ho * Wo
            return Case(lambda: grid_sample.grid_sample_bilinear_fused(
                            x, grid),
                        lambda: grid_sample.grid_sample_bilinear(x, grid),
                        lambda: F.grid_sample(xv, gv, mode="bilinear",
                                              padding_mode="border",
                                              align_corners=False),
                        x.element_size() * (n * H * W * C + P * C) + 8 * P,
                        8 * P * C + 20 * P, "fp32")
        return make

    def dw(S, C, flip):
        def make(B, dt):
            w, b = rnd((C, 1, 3, 3), 0.3), rnd((C,), 0.1)
            if flip:
                # the backward's cotangent: a contiguous (B, H, W, C)
                x = rnd((B, S, S, C), 1.0, dt)
                kern = lambda: dwconv.dwconv3x3_flip(x, w)
                plain = lambda: dwconv.dwconv3x3_ref(x, w, flip=True)
            else:
                # the channel slice of the in-projection output, in place
                x = rnd((B * S * S, 2 * C), 1.0, dt)[:, :C].view(B, S, S, C)
                kern = lambda: dwconv.dwconv3x3(x, w, b)
                plain = lambda: dwconv.dwconv3x3_ref(x, w, b)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            wd, bd = w.to(dt), b.to(dt)
            library = ((lambda: F.conv_transpose2d(x_nchw, wd, padding=1,
                                                   groups=C)) if flip
                       else (lambda: F.conv2d(x_nchw, wd, bd, padding=1,
                                              groups=C)))
            n = B * S * S * C
            # x read once, the result written, the 9 taps (and bias);
            # 9 FMAs per element
            return Case(kern, plain, library, 2 * n * x.element_size()
                        + 40 * C, 18 * n, "fp32")
        return make

    def quad8(S, D, long_memory=False):
        # the model's layout (phase 3's quad): u and dt (B, L, K, D), Bs and
        # Cs x_dbl slices
        def make(B, dt):
            K, L, R = 4, S * S, -(-D // 16)
            (uq, su), (dq, sdt) = [q8(rnd((B, L, K, D), s)) for s in (1.0,
                                                                    0.5)]
            x_dbl = rnd((B, L, K, R + 2), 1.0, dt)
            args = [uq.permute(0, 2, 1, 3), dq.permute(0, 2, 1, 3), su, sdt,
                    *[x_dbl[..., R + i].permute(0, 2, 1) for i in (0, 1)],
                    *quad_params(rnd, dev, K, D, long_memory), S, S,
                    (1, 2, 3, 4)]
            n = B * K * L * D
            size = torch.tensor([], dtype=dt).element_size()
            # int8 u and dt read, bf16 out written, Bs and Cs; K1's ~22
            # operations per element and the two dequantizing products
            return Case(lambda: quad_scan.quad_scan_ln_cat_q8(*args),
                        lambda: quad_scan.quad_scan_ln_cat_q8_ref(*args),
                        None, 4 * n + 2 * size * B * K * L + 28 * K * D,
                        24 * n, "fp32", tol=torch.bfloat16)
        return make

    src = "ceigm_unet_tpu_torch/csrc/"
    stages = model_stages(enc_name)
    S1, D1 = stages[0][0], stages[0][1] // 4
    S3, C3 = stages[2][:2]
    forward = {
        "grid_sample_bilinear": (
            "cuda", src + "grid_sample.cu",
            "ceigm_unet_tpu/ops/grid_sample.py:527 (K6), :259 (K7)",
            [(f"{H}->{2 * H} C{C} x4 groups", 1, gs1(H, W, C, 2 * H, 2 * W,
                                                     4))
             for H, W, C in pergroup_shapes(enc_name)]
            + [(f"{S3}x{S3}->20x24 C{C3 // 4} (not on the path)", 0,
                gs1(S3, S3, C3 // 4, 20, 24, 1)),
               (f"{S3}->{2 * S3} C{C3 // 4} x4 groups, grid far outside "
                "[-1, 1] (not on the path)", 0,
                gs1(S3, S3, C3 // 4, 2 * S3, 2 * S3, 4, 4.0)),
               (f"{S3}->{2 * S3} C{C3} (not on the path)", 0,
                gs1(S3, S3, C3, 2 * S3, 2 * S3, 1))]),
        "dwconv3x3": ("cuda", src + "dwconv3.cu",
                      "ceigm_unet_tpu/ops/quad_scan_bl.py:574",
                      [(f"{S}x{S} C{C}", n, dw(S, C, False))
                       for S, C, n in stages]),
        "quad_scan_ln_q8": ("cuda", src + "quad_scan_ln.cu",
                            "ceigm_unet_tpu/ops/quad_scan.py:542 quant=True",
                            [(f"{S}x{S} D{C // 4}", n, quad8(S, C // 4))
                             for S, C, n in stages]
                            + [(f"{S1}x{S1} D{D1}, long memory (not on the "
                                "path)", 0, quad8(S1, D1, long_memory=True))]),
    }
    backward = {"dwconv3x3_flip": (
        "cuda", src + "dwconv3.cu",
        "ceigm_unet_tpu/ops/quad_scan_bl.py:574 flip=True",
        [(f"{S}x{S} C{C}", n, dw(S, C, True)) for S, C, n in stages])}
    return forward, backward


def phase_route_kernels(dev, gpu):
    """Phase 14: each route kernel against its plain version at b2 fp32, b2
    bf16 and b128 bf16 (K14's bf16 output at the bf16 tolerance), timed
    per b128 bf16 forward (K13's flip mode per backward); then DySample's
    two routes at b128 bf16, the per-group route (regroup copies and the
    single-grid kernel) beside the grouped kernel K4."""
    from ceigm_unet_tpu_torch.ops import grid_sample
    forward, backward = route_kernel_cases(dev)
    results = phase_kernels(dev, gpu, forward)
    results.update(phase_kernels(dev, gpu, backward, per="backward"))
    gen = torch.Generator().manual_seed(SEED)
    total = {"per-group route": 0.0, "grouped K4": 0.0}
    for H, W, cg in PERGROUP_SHAPES:
        x = torch.randn((128, H, W, 4 * cg), generator=gen).to(
            dev, torch.bfloat16)
        grid = (torch.rand((128, 2 * H, 2 * W, 4, 2), generator=gen) * 2
                - 1).to(dev)
        ms = {"per-group route": time_ms(
                  lambda: grid_sample.dysample_grid_sample_pergroup(x, grid),
                  10),
              "grouped K4": time_ms(
                  lambda: grid_sample.dysample_grid_sample(x, grid), 10)}
        for k, v in ms.items():
            total[k] += v
        log(f"DySample {H}->{2 * H} C{4 * cg} b128 bf16: per-group route "
            f"{ms['per-group route']:.4f} ms, grouped K4 "
            f"{ms['grouped K4']:.4f} ms | {gpu}")
    log(f"DySample per b128 bf16 forward: per-group route "
        f"{total['per-group route']:.3f} ms, grouped K4 "
        f"{total['grouped K4']:.3f} ms")
    torch.cuda.empty_cache()
    return results


def compare_base(route, base) -> str:
    """The route's (slices/s, GiB) beside phase 6's."""
    return (f"{route[0]:.2f} slices/s, {route[1]:.2f} GiB against phase 6's "
            f"{base[0]:.2f} slices/s, {base[1]:.2f} GiB")


def phase_kernel_route(dev, gpu, base, base_step_ms):
    """Phase 15: gm_tiny built with dwconv="kernel", dysample_grouped=False:
    b2 fp32 card vs CPU and the launches of one forward (K13 26 times, the
    single-grid grid-sample 3, the grouped one never); b128 bf16
    throughput; one b2 fp32 train step card vs CPU (phase 8's check; K13's
    flip mode 26 times in the backward); then ``entry.train_entry`` on the
    route, 2 frozen and 3 unfrozen b48 bf16 steps (the route's training
    main path: counters reset just before, read just after). Returns those
    counts. ``base``: phase 6's (slices/s, GiB); ``base_step_ms``: phase
    9's median unfrozen ms/step, each printed beside the route's."""
    what = "gm_tiny dwconv=kernel per-group DySample"
    model, *_ = phase_model(dev, KERNEL_ROUTE, PER_FORWARD_KERNEL_ROUTE, what)
    log(f"throughput {what}: "
        f"{compare_base(phase_throughput(model, dev, gpu, what), base)}")
    del model
    torch.cuda.empty_cache()
    phase_train_vs_cpu(dev, gpu, KERNEL_ROUTE, PER_STEP_KERNEL_ROUTE)
    flags = [True] * 2 + [False] * 3
    model, _, losses, times, counts, mem, *_ = _train_run(
        dev, torch.bfloat16, flags, KERNEL_ROUTE)
    want = {k: v * len(flags) for k, v in PER_STEP_KERNEL_ROUTE.items()}
    want["scan2d"] = 2 * FROZEN_SCANS + 3 * PER_STEP_KERNEL_ROUTE["scan2d"]
    # a frozen step differentiates the 7 decoder blocks only
    want["dwconv3x3_flip"] = 2 * 7 + 3 * 26
    if counts != want:
        fail(f"{what} trainer: kernel launches {counts}, expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"{what} trainer: non-finite loss {losses}")
    med = statistics.median(times[2:])
    log(f"trainer {what} b{TRAIN_BATCH} 224x224 bf16: losses "
        f"{[round(v, 5) for v in losses]}; frozen steps "
        f"{[round(t, 1) for t in times[:2]]} ms; unfrozen median {med:.3f} "
        f"ms/step over 3 ({[round(t, 1) for t in times[2:]]}; phase 9: "
        f"{base_step_ms:.3f}); peak memory {mem:.2f} GiB; launches {counts} "
        f"| {gpu}")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_int8_serving(dev, gpu, base):
    """Phase 16: gm_tiny built with quant_scan=True: b2 card vs CPU at the
    bf16 tolerance and the launches of one forward (K14 26 times, K1
    never); its bf16 logits against the same weights' bf16 logits without
    int8 storage; ``predict_volume`` over phase 5's volumes (the route's
    main path: counters reset just before, read just after) and b128
    throughput; a forward that requires grad raises the inference-only
    error. Returns the serving counts. ``base``: phase 6's (slices/s,
    GiB), printed beside the route's."""
    from ceigm_unet_tpu_torch.models import build_model
    what = "gm_tiny int8 scan"
    model, x, _ = phase_model(dev, dict(quant_scan=True), PER_FORWARD_INT8,
                              what, fp32_tol=BF16_MODEL_TOL)
    plain = build_model(num_classes=9, enc_name="gm_tiny", seed=SEED,
                        device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        got, want = model(x.to(dev)), plain(x.to(dev))
    del plain
    err = check_bf16(got, want, f"{what} b2 bf16 logits vs the bf16 logits "
                     f"without int8 storage")
    log(f"model {what} b2 bf16 vs bf16 without int8: max abs err {err:.3e} "
        f"(max|logit| {want.float().abs().max().item():.3e}, tol "
        f"{BF16_MODEL_TOL}*max)")
    counts = phase_serving(model, dev, gpu, PER_FORWARD_INT8, what)
    log(f"throughput {what}: "
        f"{compare_base(phase_throughput(model, dev, gpu, what), base)}")
    from ceigm_unet_tpu_torch.entry import entry
    from ceigm_unet_tpu_torch.ops.quad_scan import quad_scan_ln_cat_q8
    q = torch.zeros((1, 4, 6, 8), dtype=torch.int8, device=dev)
    bc = torch.zeros((1, 4, 6), device=dev)
    kd = [torch.ones((4, 8), device=dev) for _ in range(7)]
    kd[0].requires_grad_()
    try:
        quad_scan_ln_cat_q8(q, q, *kd[:2], bc, bc, *kd[2:], 2, 3,
                            (1, 2, 3, 4))
    except NotImplementedError as e:
        if "inference-only" not in str(e):
            raise
        log(f"{what}: the int8 op with inputs that require grad raises: {e}")
    else:
        fail(f"{what}: the int8 op with inputs that require grad did not "
             f"raise")
    entry_model, x1 = entry(dev, quant_scan=True)
    out = entry_model(x1)
    if not bool(torch.isfinite(out).all()):
        fail("entry(quant_scan=True)'s model: non-finite logits")
    log(f"{what}: entry(quant_scan=True)'s model runs with grad mode on")
    del model, entry_model, out
    torch.cuda.empty_cache()
    return counts


# --- phases 17-20: the legacy training slice --------------------------------

# (tag, SS2D blocks at that shape, side, D): tiny_0230s 224x224, each
# block's backward runs K8 once in each mode
LEGACY_SCAN_SHAPES = [(f"{S}x{S} D{D}", n, S, D)
                      for S, D, n in LEGACY_SS2D_SHAPES]
# launches of one unfrozen legacy train step: 20 SS2D forwards (K10), 2
# K8 calls in each backward; a frozen step runs the 6 decoder SS2Ds' only
LEGACY_PER_STEP = {"sscan_dir": 20, "scan2d": 40}
LEGACY_FROZEN_SCANS = 12
LEGACY_STEPS = [True] * 2 + [False] * 4


def phase_legacy_scan2d(dev, gpu):
    """Phase 17: K8 at the tiny_0230s shapes, b2 and b48 fp32, both modes;
    timed per unfrozen b48 legacy step; then at phase 27's b2 64x64
    shapes."""
    r = phase_scan2d(dev, gpu, LEGACY_SCAN_SHAPES, (2, TRAIN_BATCH),
                     "tiny_0230s")
    out = {f"{k}_legacy_step": r[k] for k in ("max_abs_err", "ms",
                                               "device_ms", "plain_ms",
                                               "bound_ms")}
    # and at phase 27's b2 64x64 shapes (checked; their times not kept)
    out["max_abs_err_trajectory_legacy"] = phase_scan2d(
        dev, gpu, traj_shapes(LEGACY_SCAN_SHAPES), (TRAJ_BATCH,),
        "tiny_0230s")["max_abs_err"]
    return out


def phase_legacy_trainer(dev, gpu):
    """Phase 19, the slice's main path: ``entry.legacy_train_entry`` at b48
    bf16 (fp32 parameters), 2 frozen steps then 4 unfrozen (counters reset
    just before, read just after); then the bf16-vs-fp32 gradient cosine
    of one b2 step. Returns the launch counts of the b48 steps."""
    from ceigm_unet_tpu_torch.entry import legacy_train_entry
    model, enc0, losses, times, counts, mem, *_ = _train_run(
        dev, torch.bfloat16, LEGACY_STEPS, legacy=True)
    n_frozen = LEGACY_STEPS.count(True)
    n_open = len(LEGACY_STEPS) - n_frozen
    want = {"sscan_dir": LEGACY_PER_STEP["sscan_dir"] * len(LEGACY_STEPS),
            "scan2d": n_frozen * LEGACY_FROZEN_SCANS
            + n_open * LEGACY_PER_STEP["scan2d"]}
    if counts != want:
        fail(f"legacy trainer: kernel launches {counts}, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"legacy trainer: losses {losses} not finite or not falling")
    for name, p in model.named_parameters():
        if not bool(torch.isfinite(p.grad).all()):
            fail(f"{name}: non-finite gradient in the last legacy step")
    moved = sum(not torch.equal(p, q) for p, q in zip(
        model.encoder.parameters(), enc0))
    med = statistics.median(times[n_frozen:])
    log(f"trainer tiny_0230s b{TRAIN_BATCH} 224x224 bf16: losses "
        f"{[round(v, 5) for v in losses]}; frozen steps "
        f"{[round(t, 1) for t in times[:n_frozen]]} ms; unfrozen median "
        f"{med:.3f} ms/step over {n_open} "
        f"({[round(t, 1) for t in times[n_frozen:]]}), "
        f"{TRAIN_BATCH * 1e3 / med:.2f} slices/s; peak memory {mem:.2f} GiB; "
        f"encoder unchanged over the frozen steps, {moved} of {len(enc0)} "
        f"tensors changed after; launches {counts} | {gpu}")
    del model, enc0
    torch.cuda.empty_cache()
    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        model, step, batch = legacy_train_entry(dev, dtype, 2, SEED)
        step(batch, generator=torch.Generator().manual_seed(SEED))
        grads.append(_flat_grad(model))
        del model, step
    cos = torch.nn.functional.cosine_similarity(
        grads[0].double(), grads[1].double(), dim=0).item()
    if not cos >= BF16_GRAD_COSINE:
        fail(f"legacy bf16 vs fp32 gradient cosine {cos:.6f} < "
             f"{BF16_GRAD_COSINE}")
    log(f"trainer tiny_0230s b2 bf16 vs fp32 gradients: cosine {cos:.6f} "
        f"(fails below {BF16_GRAD_COSINE})")
    torch.cuda.empty_cache()
    return counts


SS_NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def phase_selective_scan_backward(dev, gpu):
    """Phase 20: the selective_scan op's seven gradients at each of
    SCAN_CALLS on a batch of 2, card against CPU, with K11 launched exactly
    twice per backward (counters reset just before the backward, read just
    after); then each backward at the full batch, timed beside K11's two
    calls at its row shape. Returns the launches of the batch-2
    backwards."""
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.ops import selective_scan as ss
    total = {}
    for tag, (batch, dim, N, L), sp in SCAN_CALLS:
        args = scan_inputs(dev, 2, dim, N, L, sp)
        gy = torch.randn((2, dim, L), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED + 5))
        grads = []
        for device in (dev, "cpu"):
            leaves = [t.detach().to(device).requires_grad_() for t in args]
            y = ss.selective_scan(*leaves, delta_softplus=sp,
                                  out_dtype=torch.float32)
            if device == dev:
                torch.cuda.synchronize()
                _build.reset_launch_counts()
            y.backward(gy.to(device))
            if device == dev:
                torch.cuda.synchronize()
                counts = dict(_build.launch_counts)
                if counts != {"scan_rows": 2}:
                    fail(f"selective_scan backward [{tag}]: launches "
                         f"{counts}, expected K11 twice")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            grads.append([t.grad for t in leaves])
        used = {}
        for name, got, want in zip(SS_NAMES, *grads):
            if not bool(torch.isfinite(got).all()):
                fail(f"selective_scan [{tag}] d{name}: non-finite on the card")
            if got.dtype == torch.float32:
                used[name] = round(grad_tolerance_used(got.cpu(), want), 3)
                if used[name] > 1.0:
                    fail(f"selective_scan [{tag}] d{name}: card vs CPU uses "
                         f"{used[name]} of the gradient tolerance")
            else:
                compare(got.cpu(), want, torch.bfloat16)
        # the backward at the full batch, and K11 at its row shape
        full = [t.detach().requires_grad_() for t in
                scan_inputs(dev, batch, dim, N, L, sp)]
        y = ss.selective_scan(*full, delta_softplus=sp,
                              out_dtype=torch.float32)
        gfull = torch.ones_like(y)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            y, full, gfull, retain_graph=True), 5)
        a = torch.rand((batch * dim * N, L), device=dev) * 0.5 + 0.5
        k11_ms = time_ms(lambda: ss.scan_rows(a, a), 10)
        log(f"selective_scan backward [{tag}]: b2 card vs CPU, share of "
            f"the gradient tolerance used by the fp32 grads {used}, bf16 "
            f"grads within the bf16 tolerance; launches {counts}; b{batch} "
            f"backward {bwd_ms:.4f} ms, of which K11 2 x {k11_ms:.4f} ms "
            f"| {gpu}")
        del full, y, gfull, a
    torch.cuda.empty_cache()
    return total


# --- phase 21: test-set inference ------------------------------------------

TEST_DEPTH = 40                 # slices per case; real Synapse cases: 85-198
EXACT_DEPTH = 8                 # slices per case of the exact-predictor check
TEST_BATCH = 32                 # predict_volume's batch
ACDC_SHAPE = (10, 256, 216)


class ExactPredictor(torch.nn.Module):
    """One-hot logits of round(raw): undoes ``predict_volume``'s
    (x - 0.5) / 0.5, so a volume whose voxels are class ids comes back as
    its own label map. Its one parameter fixes its device."""

    def __init__(self, num_classes, dev):
        super().__init__()
        self.onehot = torch.nn.Parameter(
            torch.eye(num_classes, device=dev) * 10.0, requires_grad=False)

    def forward(self, x):
        raw = x[..., 0] * 0.5 + 0.5
        n = self.onehot.shape[0]
        return self.onehot[torch.round(raw).clamp(0, n - 1).long()]


def blob_cases(n, shape, num_classes, seed):
    """``n`` cases of ``shape`` (D, H, W): ``entry.synthetic_batch``'s blob
    labels (every foreground class drawn in every slice) and its raw image
    (the label's intensity plus noise, before (x - 0.5) / 0.5), cut to W."""
    from ceigm_unet_tpu_torch.entry import synthetic_batch
    D, H, W = shape
    cases = []
    for i in range(n):
        b = synthetic_batch(D, H, num_classes, seed=seed + i, device="cpu")
        label = b["label"].numpy()[..., :W]
        if len(np.unique(label)) != num_classes:
            fail(f"synthetic case {i}: classes {np.unique(label)}")
        cases.append({"image": (b["image"][..., 0].numpy()[..., :W] * 0.5
                                + 0.5).astype(np.float32),
                      "label": label, "case_name": f"case{i:04d}"})
    return cases


def lightning_save(model, num_classes, path):
    """The model's state_dict as a Lightning checkpoint stores it, beside
    its hyperparameters."""
    torch.save({"state_dict": {"_model." + k: v.cpu() for k, v in
                               model.state_dict().items()},
                "hyper_parameters": {"num_classes": num_classes}}, path)


def fmt_ms(times) -> str:
    return ", ".join(f"{t:.1f}" for t in times)


def timed_inference(cases, model, logger, patch):
    """``cli.inference.run_inference`` over ``cases`` with each case's
    ``predict_volume`` timed (it returns host arrays, so each call ends
    synchronised). Returns (summary, global means, predict ms per case, host
    metrics ms per case, the class maps)."""
    from ceigm_unet_tpu_torch.cli import inference
    predict = inference.predict_volume
    pred_ms, maps, case_ms = [], [], []

    def timed_predict(*args, **kw):
        t = time.perf_counter()
        maps.append(predict(*args, **kw))
        pred_ms.append((time.perf_counter() - t) * 1e3)
        return maps[-1]

    class Marks(list):              # run_inference reads cases in order
        def __getitem__(self, i):
            case_ms.append(time.perf_counter() * 1e3)
            return list.__getitem__(self, i)

    inference.predict_volume = timed_predict
    try:
        summary, glob = inference.run_inference(Marks(cases), model, 9,
                                                logger, patch_size=patch)
    finally:
        inference.predict_volume = predict
    case_ms.append(time.perf_counter() * 1e3)
    metric_ms = [b - a - p for a, b, p in zip(case_ms, case_ms[1:], pred_ms)]
    return summary, glob, pred_ms, metric_ms, maps


def forward_breakdown(model, x, reps: int = 3) -> str:
    """Where one forward's time goes, in this process: wall time by CUDA
    events, the host's time to issue it (the call returns before the card
    is done unless the launch queue fills), the card's kernel time summed
    by torch.profiler, and the card's clocks, power and temperature."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        wall = time_ms(lambda: model(x), 5)
        issue = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
    kernel = sum(getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 ) / 1e3 / reps
    if kernel <= 0:
        fail("forward profile: the profiler saw no device time")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    return (f"wall {wall:.3f} ms (CUDA events, mean of 5), host issue "
            f"{statistics.median(issue):.3f} ms (median of {reps}), device "
            f"kernels {kernel:.3f} ms (torch.profiler, mean of {reps}), idle "
            f"share {max(0.0, 1 - kernel / wall):.3f}; SM clock, max SM "
            f"clock, power, temperature: {clocks}")


def phase_test_set(dev, gpu):
    """Phase 21 (see the module docstring). Returns the launches of (c)
    and (d) together."""
    import tempfile
    from ceigm_unet_tpu_torch.cli import inference
    from ceigm_unet_tpu_torch.convert.checkpoint import load_model
    from ceigm_unet_tpu_torch.eval.volume import predict_volume
    from ceigm_unet_tpu_torch.models import build_model
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.ops.resize import zoom_slices
    from ceigm_unet_tpu_torch.train.loop import setup_logger
    with tempfile.TemporaryDirectory() as tmp:
        logger = setup_logger(os.path.join(tmp, "logs"), "inference_synapse")
        # (a) the Lightning checkpoint round trip
        saved = build_model(num_classes=9, enc_name="gm_tiny", seed=SEED,
                            device="cpu")
        ckpt = os.path.join(tmp, "gm_tiny_synapse.ckpt")
        lightning_save(saved, 9, ckpt)
        model = load_model(ckpt, 9, device=dev)
        want, got = saved.state_dict(), model.state_dict()
        if list(got) != list(want):
            fail("loaded checkpoint: keys differ")
        for k, v in want.items():
            if (got[k].device.type != torch.device(dev).type
                    or not torch.equal(got[k].cpu(), v)):
                fail(f"loaded checkpoint: {k} differs from the saved tensor")
        log(f"test set (a): Lightning checkpoint of gm_tiny ({len(want)} "
            f"tensors) loaded on the card bitwise equal")

        # (b) the exact predictor: zoom, argmax, zoom-back and metrics; exact
        # at any depth, so on short cases (the host metrics scale with it)
        exact = [dict(c, image=c["label"].astype(np.float32)) for c in
                 blob_cases(2, (EXACT_DEPTH, 512, 512), 9, SEED + 20)]
        summary, glob, pred_ms, metric_ms, _ = timed_inference(
            exact, ExactPredictor(9, dev), logger, (512, 512))
        perfect = {"dice": 1.0, "jaccard": 1.0, "hd95": 0.0, "asd": 0.0}
        for name, m in list(summary.items()) + [("global", glob)]:
            if m != perfect:
                fail(f"exact predictor: {name} scores {m}, expected "
                     f"{perfect}")
        log(f"test set (b): exact predictor, 2 cases {exact[0]['label'].shape}"
            f", patch 512: all 8 classes and global dice 1 jaccard 1 hd95 0 "
            f"asd 0; predict_volume {fmt_ms(pred_ms)} ms, host metrics (every "
            f"class on both sides) {fmt_ms(metric_ms)} ms per case")

        # (c) the loaded gm_tiny on two Synapse-like cases, fp32: both served
        # and timed, the first also scored (the host metrics, ~1 min a case,
        # read the same on either)
        cases = blob_cases(2, (TEST_DEPTH, 512, 512), 9, SEED + 20)
        predict_volume(model, cases[0]["image"][:32])          # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        summary, glob, pred_ms, metric_ms, maps = timed_inference(
            cases[:1], model, logger, (IMG, IMG))
        t0 = time.perf_counter()
        served = predict_volume(model, cases[1]["image"], (IMG, IMG))
        pred_ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(_build.launch_counts)
        forwards = -(-TEST_DEPTH // TEST_BATCH)
        check_counts(counts, 2 * forwards, "test set: gm_tiny on 2 cases")
        if served.shape != cases[1]["label"].shape:
            fail(f"test set: case 1 served as {served.shape}")
        for name, (idx, _) in inference.CLASS_COLOR_MAPS[9].items():
            # the label holds every class; hd95 and asd are NaN exactly
            # where no case's prediction holds it
            predicted = any(bool((p == idx).any()) for p in maps)
            for k, v in summary[name].items():
                if math.isfinite(v) != (predicted or k in ("dice",
                                                           "jaccard")):
                    fail(f"test set: {name} {k} = {v} (predicted: "
                         f"{predicted})")
        if not (math.isfinite(glob["dice"]) and math.isfinite(glob["jaccard"])
                and math.isfinite(glob["hd95"]) == any(map(np.any, maps))):
            fail(f"test set: global {glob}")
        card = pred_ms[0] / (pred_ms[0] + metric_ms[0])
        log(f"test set (c): gm_tiny fp32 on 2 Synapse-like cases "
            f"{cases[0]['label'].shape}, batch {TEST_BATCH} ({forwards} "
            f"forward(s) per case, the last padded): predict_volume "
            f"{fmt_ms(pred_ms)} ms per case "
            f"({TEST_DEPTH * 1e3 / statistics.mean(pred_ms):.2f} slices/s "
            f"fp32), host metrics of case 0 {fmt_ms(metric_ms)} ms "
            f"(predict_volume's share of its run_inference {card:.4f}); "
            f"global {glob}; launches {counts} | {gpu}")
        # the first batch of case 0 as predict_volume hands it to the model
        # (launches already read): card against CPU, then the forward timed
        x = (zoom_slices(torch.from_numpy(
            cases[0]["image"][:TEST_BATCH]), (IMG, IMG)) - 0.5) / 0.5
        x = x[..., None]
        t0 = time.perf_counter()
        with torch.no_grad():
            want = saved(x)
        cpu_s = time.perf_counter() - t0
        x = x.to(dev)
        with torch.no_grad():
            got = model(x).cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        rtol, atol = MODEL_TOL
        if (got.shape != want.shape or not bool(torch.isfinite(got).all())
                or bool(((got - want).abs() > atol * scale
                         + rtol * want.abs()).any())):
            fail(f"test set: b{TEST_BATCH} fp32 logits of the loaded gm_tiny"
                 f" differ from the CPU: max abs err {err:.3e}, max|logit| "
                 f"{scale:.3e}")
        log(f"test set (c): b{TEST_BATCH} fp32 logits of case 0's first "
            f"batch, card vs CPU max abs err {err:.3e} (max|logit| "
            f"{scale:.3e}, tol rtol {rtol} atol {atol}*max); CPU forward "
            f"{cpu_s:.1f} s")
        del saved
        log(f"test set (c): b{TEST_BATCH} fp32 forward: "
            + forward_breakdown(model, x) + f" | {gpu}")
        del model

        # (d) the ACDC command line on .npz files
        data, lists = os.path.join(tmp, "ACDC"), os.path.join(tmp, "lists")
        os.makedirs(os.path.join(data, "test"))
        os.makedirs(lists)
        names = []
        for c in blob_cases(2, ACDC_SHAPE, 4, SEED + 30):
            names.append(c["case_name"] + "_volume_ED.npz")
            np.savez(os.path.join(data, "test", names[-1]), img=c["image"],
                     label=c["label"].astype(np.float32))
        with open(os.path.join(lists, "test.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        acdc_ckpt = os.path.join(tmp, "gm_tiny_acdc.pth")
        lightning_save(build_model(num_classes=4, enc_name="gm_tiny",
                                   seed=SEED, device="cpu"), 4, acdc_ckpt)
        log_dir = os.path.join(tmp, "logs")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = inference.main(["acdc", "--ckpt", acdc_ckpt, "--data-dir", data,
                              "--list-dir", lists, "--log-dir", log_dir])
        acdc_s = time.perf_counter() - t0
        acdc_counts = dict(_build.launch_counts)
        check_counts(acdc_counts, 2, "test set: the ACDC command line")
        with open(os.path.join(log_dir, "inference_acdc.log")) as f:
            last = f.read().splitlines()[-1]
        if out is None or "| global: dice " not in last:
            fail(f"ACDC command line: last log line {last!r}")
        log(f"test set (d): ACDC command line, 2 cases {ACDC_SHAPE} (one "
            f"forward of 32 each): {acdc_s:.1f} s; {last.split('| ')[-1]}; "
            f"launches {acdc_counts}")
    return {k: counts.get(k, 0) + acdc_counts.get(k, 0)
            for k in set(counts) | set(acdc_counts)}


# --- phase 22: training from the command line -------------------------------

CLI_RAW = 512                   # raw Synapse slice side
CLI_SLICES = 96                 # raw slices written
CLI_REPEAT = 5                  # listed 5 times: 10 steps of 48 per epoch
CLI_WORKERS = 6                 # the reference's loader workers
CLI_VAL_DEPTH = 8               # slices of the one validation volume
ACDC_TRAIN_SLICES = 64          # 2 steps of ACDC's batch 32
# launches of one frozen gm_tiny train step: 26 quad blocks forward, the
# decoder's 7 blocks' backward (K8 twice each)
PER_FROZEN_STEP = dict(PER_TRAIN_STEP, scan2d=FROZEN_SCANS)


def write_synapse_train(root, slices, seed, repeat=1):
    """``blob_cases``' slices (512x512, every organ in each) as Synapse
    ``train_npz`` files under ``root``, listed ``repeat`` times in
    ``root/lists/train.txt``. Returns (data dir, list dir)."""
    data, lists = os.path.join(root, "train_npz"), os.path.join(root,
                                                                "lists")
    os.makedirs(data)
    os.makedirs(lists)
    (case,) = blob_cases(1, (slices, CLI_RAW, CLI_RAW), 9, seed)
    names = [f"case0005_slice{i:03d}" for i in range(slices)]
    for i, name in enumerate(names):
        np.savez(os.path.join(data, name + ".npz"), image=case["image"][i],
                 label=case["label"][i].astype(np.float32))
    with open(os.path.join(lists, "train.txt"), "w") as f:
        f.write("\n".join(names * repeat) + "\n")
    return data, lists


def spied_training(cfg, train_ds, val, dev, steps_per_epoch,
                   resume_from=None, profile_epoch=None):
    """``train.loop.run_training`` on the card, with its loader, step and
    checkpoint writer watched: the seconds the loop waited for each batch,
    each step's host time (the first synchronised), the model's state, step
    count and LR at its first step, the encoder's parameters at each
    ``-last`` save, and a torch.profiler trace of epoch ``profile_epoch``'s
    training (its loader waits and steps) with the wall time it spans.
    Launch counters are reset just before and read just after."""
    from torch.profiler import ProfilerActivity, profile
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.train import loop
    rec = dict(waits=[], steps=[], saves={}, first=None, trace=None)
    base_loader, base_make = loop.DataLoader, loop.make_train_step
    base_save, window = loop.save_checkpoint, {}

    class Loader(base_loader):
        def set_epoch(self, epoch):
            super().set_epoch(epoch)
            if epoch == profile_epoch:
                torch.cuda.synchronize()
                # the card's activity alone: tracing the host's ops too
                # would slow the host that issues the steps
                window["prof"] = profile(activities=[ProfilerActivity.CUDA])
                window["prof"].start()
                window["t0"] = time.perf_counter()

        def __iter__(self):
            batches = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                rec["waits"].append((self.epoch, time.perf_counter() - t0))
                yield batch

    class Step:
        def __init__(self, model, optimizer, inner):
            self.model, self.optimizer, self.inner = model, optimizer, inner

        @property
        def count(self):
            return self.inner.count

        @count.setter
        def count(self, value):
            self.inner.count = value

        def __call__(self, batch, **kw):
            first = rec["first"] is None
            if first:
                rec["first"] = dict(count=self.inner.count, state={
                    k: v.detach().cpu().clone()
                    for k, v in self.model.state_dict().items()})
            t0 = time.perf_counter()
            out = self.inner(batch, **kw)
            if first:
                torch.cuda.synchronize()
                rec["first"]["lr"] = self.optimizer.param_groups[0]["lr"]
            rec["steps"].append(time.perf_counter() - t0)
            if ("prof" in window and self.inner.count
                    == (profile_epoch + 1) * steps_per_epoch):
                torch.cuda.synchronize()
                wall = time.perf_counter() - window["t0"]
                prof = window.pop("prof")
                prof.stop()
                rec["trace"] = (wall, device_seconds(prof))
            return out

    def make(model, optimizer, *args, **kw):
        return Step(model, optimizer, base_make(model, optimizer, *args,
                                                **kw))

    def save(ckpt_dir, name, model, step, epoch, extra=None):
        if name.endswith("-last"):
            rec["saves"][epoch] = {
                k: v.detach().cpu().clone()
                for k, v in model.encoder.named_parameters()}
        return base_save(ckpt_dir, name, model, step, epoch, extra)

    loop.DataLoader, loop.make_train_step = Loader, make
    loop.save_checkpoint = save
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        model, step = loop.run_training(cfg, train_ds, val,
                                        resume_from=resume_from, device=dev)
        torch.cuda.synchronize()
        rec["wall"] = time.perf_counter() - t0
        rec["counts"] = dict(_build.launch_counts)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        loop.DataLoader, loop.make_train_step = base_loader, base_make
        loop.save_checkpoint = base_save
    with open(os.path.join(cfg.log_dir, f"{cfg.name}.metrics.jsonl")) as f:
        rec["rows"] = [json.loads(ln) for ln in f]
    return model, step, rec


def device_seconds(prof) -> float:
    """Seconds of device work (kernels, copies, sets) in a stopped
    torch.profiler trace."""
    return sum(getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6


def expected_counts(frozen, unfrozen, eval_forwards):
    """Launches of ``frozen`` and ``unfrozen`` gm_tiny train steps and
    ``eval_forwards`` eval forwards (K5 runs only in those)."""
    want = {}
    for per, n in ((PER_FROZEN_STEP, frozen), (PER_TRAIN_STEP, unfrozen),
                   (PER_FORWARD, eval_forwards)):
        for k, v in per.items():
            want[k] = want.get(k, 0) + v * n
    return {k: v for k, v in want.items() if v}


def check_training_rows(rec, what, epochs, val=True):
    rows = rec["rows"]
    if [r["epoch"] for r in rows] != list(epochs):
        fail(f"{what}: history epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        if not math.isfinite(r["mean_train_loss"]) or (
                val and not 0.0 <= r.get("val_mean_dice", -1.0) <= 1.0):
            fail(f"{what}: history row {r}")


def step_ms(rec, epochs, steps_per_epoch) -> float:
    """ms per step over ``epochs``: each epoch's training time (its history
    row, synchronised at its end) less the loop's waits for batches."""
    rows = {r["epoch"]: r for r in rec["rows"]}
    busy = sum(rows[e]["epoch_time_s"] for e in epochs) - sum(
        w for e, w in rec["waits"] if e in epochs)
    return busy * 1e3 / (len(epochs) * steps_per_epoch)


def write_acdc(tmp):
    """ACDC-format data under ``tmp``: ACDC_TRAIN_SLICES train slices of
    ACDC_SHAPE[1:] (2 steps of batch 32) and one ACDC_SHAPE test volume,
    with their lists. Returns (data dir, list dir)."""
    acdc, alists = os.path.join(tmp, "ACDC"), os.path.join(tmp, "alists")
    for d in ("train", "test"):
        os.makedirs(os.path.join(acdc, d))
    os.makedirs(alists)
    (case,) = blob_cases(1, (ACDC_TRAIN_SLICES,) + ACDC_SHAPE[1:], 4,
                         SEED + 42)
    names = [f"patient{i:03d}_frame01_slice_0.npz"
             for i in range(ACDC_TRAIN_SLICES)]
    for i, name in enumerate(names):
        np.savez(os.path.join(acdc, "train", name), img=case["image"][i],
                 label=case["label"][i].astype(np.float32))
    (test,) = blob_cases(1, ACDC_SHAPE, 4, SEED + 43)
    np.savez(os.path.join(acdc, "test", "patient101_frame01.npz"),
             img=test["image"], label=test["label"].astype(np.float32))
    with open(os.path.join(alists, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(alists, "test.txt"), "w") as f:
        f.write("patient101_frame01.npz\n")
    return acdc, alists


def phase_training_cli(dev, gpu):
    """Phase 22 (see the module docstring). Returns the launches of (b)."""
    import dataclasses
    import tempfile
    from ceigm_unet_tpu_torch import native
    from ceigm_unet_tpu_torch.cli import train_acdc
    from ceigm_unet_tpu_torch.convert.checkpoint import (
        load_checkpoint, strip_lightning_prefix)
    from ceigm_unet_tpu_torch.data import device_aug
    from ceigm_unet_tpu_torch.data.datasets import SynapseDataset
    from ceigm_unet_tpu_torch.data.loader import DataLoader, collate
    from ceigm_unet_tpu_torch.kernel_ab import device_time
    from ceigm_unet_tpu_torch.models import build_model
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.train.config import SYNAPSE_CONFIG
    from ceigm_unet_tpu_torch.train.trainstep import cosine_lr
    spe = CLI_SLICES * CLI_REPEAT // TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        # (a) host data: the native library, one worker's augmentation, and
        # the 6-worker loader's throughput
        built = native.library_path().exists()   # by an earlier phase
        t0 = time.perf_counter()
        lib = native.build()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data, lists = write_synapse_train(os.path.join(tmp, "syn"),
                                          CLI_SLICES, SEED + 40, CLI_REPEAT)
        write_s = time.perf_counter() - t0
        ds = SynapseDataset(data, "train", lists, IMG, seed=SEED)
        t0 = time.perf_counter()
        one = [ds.get(i, np.random.default_rng([SEED, i]))
               for i in range(TRAIN_BATCH)]
        one_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_BATCH
        batch = collate(one)
        if batch["image"].shape != (TRAIN_BATCH, IMG, IMG, 1) or not bool(
                torch.isfinite(batch["image"]).all()):
            fail(f"host batch {tuple(batch['image'].shape)}")
        loader = DataLoader(ds, TRAIN_BATCH, num_workers=CLI_WORKERS,
                            seed=SEED)
        t0 = time.perf_counter()
        n0 = sum(b["image"].shape[0] for b in loader)      # starts workers
        warm_s = time.perf_counter() - t0
        loader.set_epoch(1)
        t0 = time.perf_counter()
        n1 = sum(b["image"].shape[0] for b in loader)
        epoch_s = time.perf_counter() - t0
        del loader
        host_sps = n1 / epoch_s
        log(f"training CLI (a): native library {lib.name} "
            f"{'found built' if built else 'built'} in {build_s:.2f} s;"
            f" {CLI_SLICES} raw {CLI_RAW}x{CLI_RAW} slices written (listed "
            f"{CLI_REPEAT} times) in "
            f"{write_s:.1f} s; host augmentation + zoom to {IMG}x{IMG} "
            f"{one_ms:.2f} ms per slice on one core (b{TRAIN_BATCH} in "
            f"process); {CLI_WORKERS}-worker loader: {n0} slices in "
            f"{warm_s:.2f} s with the workers' start, then {n1} in "
            f"{epoch_s:.3f} s = {host_sps:.1f} slices/s")

        # (b) run_training, the Synapse preset at b48 fp32, on the same
        # list
        val = blob_cases(1, (CLI_VAL_DEPTH, CLI_RAW, CLI_RAW), 9,
                         SEED + 41)
        cfg = dataclasses.replace(
            SYNAPSE_CONFIG, data_dir=data, list_dir=lists, max_epochs=4,
            stop_epoch=3, freeze_encoder_epochs=1, val_every_early=1,
            num_workers=CLI_WORKERS, log_dir=os.path.join(tmp, "b", "logs"),
            ckpt_dir=os.path.join(tmp, "b", "ckpt"))
        train_ds = SynapseDataset(data, "train", lists, IMG, seed=cfg.seed)
        model, step, rec = spied_training(cfg, train_ds, val, dev, spe,
                                          profile_epoch=2)
        check_training_rows(rec, "run_training", range(3))
        want = expected_counts(spe, 2 * spe, 3)
        if rec["counts"] != want:
            fail(f"run_training: launches {rec['counts']}, expected {want}")
        init = dict(build_model(num_classes=9, enc_name=cfg.enc_name,
                                seed=cfg.seed, device="cpu")
                    .encoder.named_parameters())
        if not all(torch.equal(rec["saves"][0][k], v)
                   for k, v in init.items()):
            fail("run_training: an encoder parameter moved in the frozen "
                 "epoch 0")
        moved = sum(not torch.equal(rec["saves"][2][k], v)
                    for k, v in init.items())
        last = os.path.join(cfg.ckpt_dir, "synapse-last.ckpt")
        for name in ("synapse-best", "synapse-last"):
            if not os.path.isfile(os.path.join(cfg.ckpt_dir, name + ".ckpt")):
                fail(f"run_training: {name}.ckpt not written")
        # epoch 1: after the first step and before the trace (stopping
        # the profiler inside epoch 2 takes seconds of its time)
        ms = step_ms(rec, (1,), spe)
        # each epoch's first batch, then the batches the workers built
        # while the loop issued steps (epochs 1-2)
        firsts, rest = [], []
        for e in (1, 2):
            waits = [w for we, w in rec["waits"] if we == e]
            firsts.append(waits[0])
            rest += waits[1:]
        if rec["trace"] is None or rec["trace"][1] <= 0:
            fail(f"run_training: no device time traced in epoch 2 "
                 f"({rec['trace']})")
        wall, busy = rec["trace"]
        # epoch 2's steps: its traced wall less the loop's waits in it
        steps_s = wall - sum(w for e, w in rec["waits"] if e == 2)
        if busy > steps_s * 1.001:
            fail(f"run_training: {busy:.4f} s of device work traced in "
                 f"epoch 2's {steps_s:.4f} s of steps (its wall {wall:.4f}"
                 " s): the trace counts some work twice")
        host_ms = [s * 1e3 for s in rec["steps"]]
        wait_ms = 1e3 * (sum(firsts) + sum(rest)) / (2 * spe)
        log(f"training CLI (b): run_training gm_tiny b{TRAIN_BATCH} "
            f"{IMG}x{IMG} fp32 (TF32 off), {CLI_SLICES} raw slices listed "
            f"{CLI_REPEAT} times ({spe} steps per epoch), 3 epochs "
            f"(encoder frozen in epoch 0, validation on {CLI_VAL_DEPTH}x"
            f"{CLI_RAW}x{CLI_RAW} every epoch): rows "
            f"{[(r['epoch'], round(r['mean_train_loss'], 5), round(r['val_mean_dice'], 4), r['epoch_time_s']) for r in rec['rows']]}; "
            f"{ms:.1f} ms/step in epoch 1 (the first unfrozen one), "
            f"{steps_s * 1e3 / spe:.1f} in epoch 2 "
            f"({TRAIN_BATCH / steps_s * spe:.1f} slices/s over its steps, "
            f"{TRAIN_BATCH / wall * spe:.1f} over its wall, against the "
            f"loader's {host_sps:.1f}); host time per step: the first "
            f"{host_ms[0]:.1f} ms (synchronised), the other {len(host_ms) - 1}"
            f" median {statistics.median(host_ms[1:]):.1f} (min "
            f"{min(host_ms[1:]):.1f}, max {max(host_ms[1:]):.1f}); loader "
            f"wait, epochs 1-2: each epoch's first batch "
            f"{[round(w * 1e3, 1) for w in firsts]} ms, the other "
            f"{len(rest)} mean {1e3 * sum(rest) / len(rest):.2f} ms (max "
            f"{1e3 * max(rest):.2f}), {wait_ms:.1f} ms per step in all; "
            f"peak memory "
            f"{rec['peak_gib']:.2f} GiB; epoch 2's training: {wall:.3f} s "
            f"wall, {busy:.3f} s of device work (torch.profiler), idle share "
            f"{1 - busy / wall:.3f} ({1 - busy / steps_s:.3f} over its "
            f"steps alone); run {rec['wall']:.1f} s; "
            f"encoder bitwise unchanged in epoch 0, {moved} of {len(init)} "
            f"tensors moved by epoch 2; launches {rec['counts']} | {gpu}")
        saved = load_checkpoint(last)
        sched = cosine_lr(cfg.lr, cfg.eta_min, cfg.max_epochs, spe)
        del model, step, saved["state_dict"]
        torch.cuda.empty_cache()

        # resume from -last for one epoch
        rcfg = dataclasses.replace(
            cfg, stop_epoch=4, log_dir=os.path.join(tmp, "r", "logs"),
            ckpt_dir=os.path.join(tmp, "r", "ckpt"))
        model, step, rrec = spied_training(rcfg, train_ds, val, dev, spe,
                                           resume_from=last)
        check_training_rows(rrec, "resumed run_training", [3])
        want_sd = strip_lightning_prefix(load_checkpoint(last)["state_dict"])
        first = rrec["first"]
        if list(first["state"]) != list(want_sd) or not all(
                torch.equal(first["state"][k], v) for k, v in want_sd.items()):
            fail("resume: the model at the first resumed step differs from "
                 "the saved -last checkpoint")
        if not (first["count"] == saved["global_step"] == 3 * spe
                and first["lr"] == sched(3 * spe) and step.count == 4 * spe):
            fail(f"resume: step count {first['count']} (saved "
                 f"{saved['global_step']}), LR {first['lr']} (schedule "
                 f"{sched(3 * spe)}), final count {step.count}")
        want = expected_counts(0, spe, 1)
        if rrec["counts"] != want:
            fail(f"resume: launches {rrec['counts']}, expected {want}")
        log(f"training CLI (b): resumed from -last (epoch {saved['epoch']}, "
            f"global_step {saved['global_step']}): {len(want_sd)} tensors "
            f"bitwise equal at the first step, step count {first['count']} "
            f"-> {step.count}, LR {first['lr']:.6e} (the schedule's at "
            f"{3 * spe}); epoch 3 row {rrec['rows'][0]}; run "
            f"{rrec['wall']:.1f} s")
        del model, step
        torch.cuda.empty_cache()

        # (c) on-device augmentation: raw slices to the card
        raw_ds = SynapseDataset(data, "train", lists, IMG, seed=cfg.seed,
                                augment=False, keep_raw_size=True)
        raw = collate([raw_ds.get(i) for i in range(TRAIN_BATCH)],
                      normalize=False)
        images = raw["image"][..., 0].to(dev)
        labels = raw["label"].to(dev)
        params = device_aug.sample_params(
            device_aug.step_generator(cfg.seed, 0, dev), TRAIN_BATCH,
            CLI_RAW, CLI_RAW, IMG, dev)
        got_i, got_l = device_aug.apply_params(params, images, labels, IMG)
        want_i, want_l = device_aug.apply_params(
            {k: v.cpu() for k, v in params.items()}, raw["image"][..., 0],
            raw["label"], IMG)
        err = compare(got_i.cpu(), want_i, torch.float32)
        flips = int((got_l.cpu() != want_l).sum())
        if flips:
            fail(f"device_augment: {flips} labels differ between the card "
                 "and the CPU")
        gen = torch.Generator(device=dev)

        def aug():
            gen.manual_seed(SEED)
            device_aug.device_augment(gen, images, labels, IMG)
        aug_ms, aug_dev_ms = time_ms(aug, 10), device_time(aug, 10)
        del images, labels, got_i, got_l
        dcfg = dataclasses.replace(
            cfg, device_aug=True, stop_epoch=1,
            log_dir=os.path.join(tmp, "c", "logs"),
            ckpt_dir=os.path.join(tmp, "c", "ckpt"))
        model, step, drec = spied_training(dcfg, raw_ds, val, dev, spe)
        check_training_rows(drec, "run_training with device_aug", [0])
        want = expected_counts(spe, 0, 1)
        if drec["counts"] != want:
            fail(f"device_aug: launches {drec['counts']}, expected {want}")
        dwaits = [w for _, w in drec["waits"]]
        dhost = [s * 1e3 for s in drec["steps"]]
        log(f"training CLI (c): device_augment b{TRAIN_BATCH} {CLI_RAW}x"
            f"{CLI_RAW} -> {IMG}x{IMG}, card vs CPU on the same parameters "
            f"(ops fired per slice {params['active'].sum(1).tolist()}): "
            f"image max abs err {err:.3e} (fp32 tolerance), labels equal; "
            f"{aug_ms:.3f} ms per batch (device {aug_dev_ms:.3f} ms); "
            f"run_training with device_aug, 1 epoch of {spe} steps: host "
            f"time per step, the first {dhost[0]:.1f} ms (synchronised), the "
            f"other median {statistics.median(dhost[1:]):.1f}; "
            f"{step_ms(drec, (0,), spe):.1f} ms/step over the epoch less its "
            f"waits; loader wait, the first batch {1e3 * dwaits[0]:.1f} ms, "
            f"the other mean {1e3 * sum(dwaits[1:]) / (len(dwaits) - 1):.2f}"
            f"; epoch {drec['rows'][0]['epoch_time_s']} s, peak memory "
            f"{drec['peak_gib']:.2f} GiB, run {drec['wall']:.1f} s; launches "
            f"{drec['counts']} | {gpu}")
        del model, step
        torch.cuda.empty_cache()

        # (d) the ACDC command line
        acdc, alists = write_acdc(tmp)
        logs, ckpts = os.path.join(tmp, "d", "logs"), os.path.join(tmp, "d",
                                                                   "ckpt")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        model, step = train_acdc.main(
            ["--data-dir", acdc, "--list-dir", alists, "--log-dir", logs,
             "--ckpt-dir", ckpts, "--max-steps", "2", "--device", "cuda"])
        acdc_s = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        want = expected_counts(2, 0, 0)
        if counts != want:
            fail(f"ACDC training CLI: launches {counts}, expected {want}")
        with open(os.path.join(logs, "acdc.metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        if (step.count != 2 or len(rows) != 1 or rows[0]["step"] != 2
                or not math.isfinite(rows[0]["mean_train_loss"])
                or not os.path.isfile(os.path.join(ckpts, "acdc-last.ckpt"))):
            fail(f"ACDC training CLI: step count {step.count}, rows {rows}")
        log(f"training CLI (d): cli.train_acdc.main --max-steps 2 on "
            f"{ACDC_TRAIN_SLICES} slices {ACDC_SHAPE[1:]} (batch 32, frozen "
            f"encoder): {acdc_s:.1f} s; row {rows[0]}; acdc-last.ckpt "
            f"written; launches {counts}")
        del model, step
        torch.cuda.empty_cache()
    return rec["counts"]


# --- phase 23: data parallelism and the ring scan ---------------------------

DP_STEPS = (True, False, False)         # 1 frozen, 2 unfrozen
DP_TIMED = 5                            # unfrozen steps timed after them
RING_SHAPE = (2, 32, 1, 16384)          # stage 1 of a 512x512 image: L 128^2
RING_SHARDS = 4


def _dp_run(dev, frozen_flags, timed):
    """``train_entry``'s gm_tiny and b48 batch, fp32, stepped once per flag
    by SGD (lr 1e-2, momentum 0.9; Adam's first step would blow rounding
    noise up to a full step) with the drop-path masks of one seeded
    generator; the launches and ``torch.distributed`` calls of each step
    counted; then ``timed`` more unfrozen steps, each timed alone. Returns
    (losses, ms per step of the flags' steps, ms of each timed step,
    launches and collectives per step, the parameters and BN statistics
    after the flags' steps, the initial parameters)."""
    from ceigm_unet_tpu_torch.entry import train_entry
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.parallel import mesh
    from ceigm_unet_tpu_torch.train.trainstep import (make_sgd,
                                                      make_train_step,
                                                      param_groups)
    model, _, batch = train_entry(dev, torch.float32, TRAIN_BATCH, SEED)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, make_sgd(param_groups(model),
                                           momentum=0.9), lambda s: 1e-2)
    batch = mesh.shard_batch(batch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses, ms, counts = [], [], []
    for frozen in frozen_flags:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with mesh.watch_collectives() as calls:
            losses.append(step(batch, freeze_encoder=frozen,
                               generator=gen)["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append((dict(_build.launch_counts), calls))
    state = {n: t.detach().clone() for n, t in (
        *model.named_parameters(),
        *((n, b) for n, b in model.named_buffers() if "running" in n))}
    steady = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, generator=gen)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    del model
    return losses, ms, steady, counts, state, p0


def move_tolerance_used(got, want, start) -> float:
    """The largest share of its tolerance a parameter's move from ``start``
    uses: the gradient tolerance on the move (rtol GRAD_FLOOR, atol 1e-8 +
    GRAD_FLOOR * max|move|), plus the 2 ulps of the parameter that
    rounding the moved value may cost (a move of 1e-5 on a weight near 1
    holds only ~2 significant digits)."""
    move = want - start
    tol = 1e-8 + GRAD_FLOOR * (move.abs().max() + move.abs()) \
        + 2 * torch.finfo(torch.float32).eps * want.abs()
    return ((got - want).abs() / tol).max().item()


def _logits_of(model, fn):
    """``fn()``'s result and the logits of every forward of ``model`` in
    it, on the host."""
    logits = []
    hook = model.register_forward_hook(
        lambda m, i, out: logits.append(out.detach().cpu()))
    try:
        return fn(), logits
    finally:
        hook.remove()


def phase_parallel(dev, gpu):
    """Phase 23 (see the module docstring). Returns {"scan_rows": K11's
    launches on the ring scan's path, "dp_ms": the grouped steady steps}."""
    import tempfile

    import torch.distributed as dist

    from ceigm_unet_tpu_torch.convert.vssm_import import (
        load_vssm_encoder)
    from ceigm_unet_tpu_torch.eval.volume import predict_volume
    from ceigm_unet_tpu_torch.models import build_legacy_model, build_model
    from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.parallel import init_data_parallel, mesh
    from ceigm_unet_tpu_torch.utils.debug import DebugGuards
    if mesh.active_group() is not None:
        fail("a process group is active before phase 23")
    # without the group: the plain steps and the served volumes
    plain = _dp_run(dev, DP_STEPS, DP_TIMED)
    serve = build_model(num_classes=9, dtype=torch.bfloat16, device=dev,
                        seed=SEED)
    volumes = synthetic_volumes()
    want_pred, want_logits = _logits_of(serve, lambda: [
        predict_volume(serve, v, (IMG, IMG), 32) for v in volumes])

    # (a) a group of one over NCCL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    init_data_parallel(1, device="cuda", store_path=os.path.join(tmp, "s"),
                       timeout_s=120.0)
    log(f"parallel (a): init_data_parallel(1) over "
        f"{dist.get_backend()} in {time.perf_counter() - t0:.2f} s, rank "
        f"{dist.get_rank()} of {dist.get_world_size()}")
    try:
        grouped = _phase_parallel_group(
            dev, gpu, plain, serve, volumes, want_pred, want_logits)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if mesh.active_group() is not None:
        fail("the process group outlived phase 23")

    # (b) the steady step's time: without the group before it, with it,
    # without it again (A B A), each step timed alone
    after = _dp_run(dev, (False,), DP_TIMED)[2]
    blocks = (("without", plain[2]), ("with", grouped["dp_ms"]),
              ("without", after))
    without = plain[2] + after
    med = lambda t: float(np.median(t))
    spread = lambda t: f"{med(t):.2f} ({min(t):.2f}-{max(t):.2f})"
    log(f"parallel (b): steady b{TRAIN_BATCH} fp32 unfrozen SGD steps, "
        f"each timed alone, in order "
        + "; ".join(f"{k} the group {' '.join(f'{v:.2f}' for v in t)}"
                    for k, t in blocks)
        + f" ms; median (min-max) with the group "
        f"{spread(grouped['dp_ms'])}, without "
        f"{spread(without)}; difference "
        f"{med(grouped['dp_ms']) - med(without):+.2f} ms | {gpu}")

    # (e) the debug guards: off, the same launches; on, a planted NaN
    x = torch.randn((2, IMG, IMG, 1), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    counts = []
    for debug in (None, DebugGuards()):
        model = build_model(num_classes=9, device=dev, seed=SEED,
                            debug=debug)
        _build.reset_launch_counts()
        with torch.no_grad():
            model(x)
        counts.append(dict(_build.launch_counts))
    if counts[0] != counts[1] or counts[0] != PER_FORWARD:
        fail(f"debug guards off: launches {counts[1]}, without them "
             f"{counts[0]}")
    model = build_model(num_classes=9, device=dev, seed=SEED,
                        debug=DebugGuards(nancheck=True))
    quad = next(m for m in model.modules() if isinstance(m, QuadGroupSS2D))

    def plant(module, args):
        y = args[0].clone()
        y[0, 3, 3, 0] = float("nan")
        return (y,)
    hook = quad.register_forward_pre_hook(plant)
    try:
        with torch.no_grad():
            model(x)
        fail("debug guards on: a NaN in a quad block's input did not raise")
    except FloatingPointError as e:
        msg = str(e)
    finally:
        hook.remove()
    if "check_nan_inf[quad_pergroup.y]" not in msg:
        fail(f"debug guards on: raised {msg!r}")
    with torch.no_grad():
        model(x)
    log(f"parallel (e): debug guards off, gm_tiny b2 forward launches "
        f"{counts[1]} (without guards {counts[0]}); on, a NaN planted in "
        f"the first quad block's input raised {msg!r}")

    # (f) the legacy encoder's pretrained loader
    src = build_legacy_model(num_classes=9, device=dev, seed=SEED)
    ckpt = {"model": {**src.encoder.state_dict(),
                      "classifier.norm.weight": torch.ones(768),
                      "classifier.norm.bias": torch.zeros(768),
                      "classifier.head.weight": torch.zeros(1000, 768),
                      "classifier.head.bias": torch.zeros(1000)}}
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_vssm_"),
                        "vssm1_tiny_0230s.pth")
    torch.save(ckpt, path)
    fresh = build_legacy_model(num_classes=9, device=dev, seed=SEED + 1)
    load_vssm_encoder(fresh, path)
    fresh.decoder.load_state_dict(src.decoder.state_dict())
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    with torch.no_grad():
        want, got = src(x), fresh(x)
    if not torch.equal(got, want):
        fail(f"vssm loader: logits differ by "
             f"{(got - want).abs().max().item():.3e}")
    log(f"parallel (f): a tiny_0230s encoder saved with classifier keys "
        f"loaded into a fresh model: b2 logits bitwise equal "
        f"{tuple(got.shape)}")
    del src, fresh, model, serve
    torch.cuda.empty_cache()

    # (g) the training command line under torchrun, one rank over NCCL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_torchrun_")
    try:
        acdc, alists = write_acdc(tmp)
        logs, ckpts = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=1", "-m",
               "ceigm_unet_tpu_torch.cli.train_acdc", "--distributed",
               "--data-dir", acdc, "--list-dir", alists, "--log-dir", logs,
               "--ckpt-dir", ckpts, "--max-steps", "2", "--device", "cuda"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ,
                                                   PYTHONPATH=REPO))
        run_s = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"torchrun train_acdc --distributed: exit "
                 f"{run.returncode}: {run.stderr[-2000:]}")
        with open(os.path.join(logs, "acdc.metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        if (len(rows) != 1 or rows[0]["step"] != 2
                or not math.isfinite(rows[0]["mean_train_loss"])
                or not os.path.isfile(os.path.join(ckpts, "acdc-last.ckpt"))):
            fail(f"torchrun train_acdc --distributed: rows {rows}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"parallel (g): torchrun --standalone --nproc_per_node=1 -m "
        f"ceigm_unet_tpu_torch.cli.train_acdc --distributed --max-steps 2 "
        f"(NCCL, {ACDC_TRAIN_SLICES} slices, batch 32): {run_s:.1f} s, row "
        f"{rows[0]}, acdc-last.ckpt written")

    # (h) the multi-process dry run: one rank on the card; two refused
    from ceigm_unet_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(1, "cuda")
    dry_s = time.perf_counter() - t0
    try:
        dryrun_multichip(2, "cuda")
        fail("dryrun_multichip(2) ran on one card")
    except RuntimeError as e:
        refused = str(e)
    log(f"parallel (h): entry.dryrun_multichip(1, 'cuda') passed in "
        f"{dry_s:.1f} s (a spawned NCCL rank: gm_tiny steps, the sequence-"
        f"parallel check, one process vs the rank); dryrun_multichip(2) "
        f"refused: {refused!r}")
    return grouped


def _phase_parallel_group(dev, gpu, plain, serve, volumes, want_pred,
                          want_logits):
    """Phase 23 (b)-(d), with the group of one active."""
    from ceigm_unet_tpu_torch.eval.volume import predict_volume
    from ceigm_unet_tpu_torch.kernel_ab import device_time
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.ops.selective_scan import scan_rows
    from ceigm_unet_tpu_torch.parallel import mesh, ring_scan

    # (b) the data-parallel steps against the plain ones
    losses, ms, dp_ms, counts, state, p0 = _dp_run(dev, DP_STEPS,
                                                   2 * DP_TIMED)
    p_losses, p_ms, _, p_counts, p_state, _ = plain
    for i, (frozen, (kern, coll)) in enumerate(zip(DP_STEPS, counts)):
        want = expected_counts(int(frozen), int(not frozen), 0)
        if kern != want or kern != p_counts[i][0]:
            fail(f"data-parallel step {i}: launches {kern}, expected {want}")
        if not coll.get("all_reduce"):
            fail(f"data-parallel step {i}: collectives {coll}")
        if p_counts[i][1]:
            fail(f"plain step {i} issued collectives {p_counts[i][1]}")
        if not abs(losses[i] - p_losses[i]) <= 1e-4 * abs(p_losses[i]):
            fail(f"data-parallel step {i}: loss {losses[i]} vs plain "
                 f"{p_losses[i]}")
    used = {n: move_tolerance_used(t, p_state[n], p0[n]) if n in p0
            else grad_tolerance_used(t, p_state[n])
            for n, t in state.items()}
    worst = max(used, key=used.get)
    if used[worst] > 1.0:
        fail(f"data-parallel steps: {worst} uses {used[worst]:.3f} of its "
             f"tolerance")
    del state, p0, plain
    torch.cuda.empty_cache()
    fmt = lambda t: "/".join(f"{v:.1f}" for v in t)
    log(f"parallel (b): gm_tiny b{TRAIN_BATCH} fp32 SGD steps (frozen, "
        f"unfrozen, unfrozen) in a group of one vs without: losses "
        f"{[round(v, 6) for v in losses]} vs {[round(v, 6) for v in p_losses]}"
        f"; parameter moves (plus 2 ulps) and BN statistics within the "
        f"gradient tolerance "
        f"(nearest: {worst} at {used[worst]:.3f}); per step launches "
        f"{[c[0] for c in counts]}, collectives {[c[1] for c in counts]}; "
        f"ms/step {fmt(ms)} vs {fmt(p_ms)} without the group | {gpu}")

    # (c) the ring scan: a group of one, and 4 shards stacked on the card
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.sigmoid(torch.randn(RING_SHAPE, generator=g, device=dev) * 2
                      + 2)
    b = torch.randn(RING_SHAPE, generator=g, device=dev)
    ct = torch.randn(RING_SHAPE, generator=g, device=dev)
    _build.reset_launch_counts()
    results = {}
    with mesh.watch_collectives() as coll:
        for reverse in (False, True):
            ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
            h1 = ring_scan.sequence_parallel_scan(ag, bg, reverse=reverse)
            (h1 * ct).sum().backward()
            ash = ring_scan.to_shards(a, RING_SHARDS).requires_grad_()
            bsh = ring_scan.to_shards(b, RING_SHARDS).requires_grad_()
            h4 = ring_scan.from_shards(ring_scan.stacked_ring_scan(
                ash, bsh, reverse))
            (h4 * ct).sum().backward()
            results[reverse] = (h1.detach(), ag.grad, bg.grad, h4.detach(),
                                ring_scan.from_shards(ash.grad),
                                ring_scan.from_shards(bsh.grad))
    ring_counts = dict(_build.launch_counts)
    # 2 rings x 2 directions x (2 scans forward + 2 backward)
    if ring_counts != {"scan_rows": 16}:
        fail(f"ring scan: launches {ring_counts}, expected scan_rows 16")
    # the group's ring: one all-gather of the summaries per direction in
    # the forward and in the backward (a group of one has no neighbours)
    if coll != {"all_gather": 4}:
        fail(f"ring scan: collectives {coll}, expected all_gather 4")
    errs = []
    for reverse, (h1, da1, db1, h4, da4, db4) in results.items():
        flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
        with torch.no_grad():
            whole = flip(scan_rows(flip(a), flip(b)))
        cpu = [t.cpu() for t in (a, b, ct)]
        ac, bc = (ring_scan.to_shards(t, RING_SHARDS).requires_grad_()
                  for t in cpu[:2])
        hc = ring_scan.from_shards(ring_scan.stacked_ring_scan(ac, bc,
                                                               reverse))
        (hc * cpu[2]).sum().backward()
        for got, want in ((h1, whole), (h4, whole), (h4.cpu(), hc.detach()),
                          (da4.cpu(), ring_scan.from_shards(ac.grad)),
                          (db4.cpu(), ring_scan.from_shards(bc.grad)),
                          (da1.cpu(), ring_scan.from_shards(ac.grad)),
                          (db1.cpu(), ring_scan.from_shards(bc.grad))):
            errs.append(compare(got, want, torch.float32))
    del results
    L = RING_SHAPE[-1]
    ash, bsh = (ring_scan.to_shards(t, RING_SHARDS) for t in (a, b))
    with torch.no_grad():
        fwd_ms = device_time(lambda: ring_scan.stacked_ring_scan(ash, bsh),
                             10)
        whole_ms = device_time(lambda: scan_rows(a, b), 10)
    ag = ash.clone().requires_grad_()
    h = ring_scan.stacked_ring_scan(ag, bsh)

    def backward():
        ag.grad = None
        h.backward(torch.ones_like(h), retain_graph=True)
    bwd_ms = device_time(backward, 10)
    # one local scan's least traffic: a and b read, h written, fp32
    bound = 3 * 4 * a.numel() / HBM_BPS * 1e3
    log(f"parallel (c): ring scan {RING_SHAPE} fp32, a group of one and "
        f"{RING_SHARDS} stacked shards, forward and reverse, vs scan_rows "
        f"over the whole L and the CPU (values and a/b gradients) max abs "
        f"err {max(errs):.3e}; launches {ring_counts}, collectives {coll}; "
        f"{RING_SHARDS}-shard forward {fwd_ms:.4f} ms device, backward "
        f"{bwd_ms:.4f} ms, one scan_rows over L {L} {whole_ms:.4f} ms, "
        f"bound of one pass {bound:.4f} ms | {gpu}")

    # (d) serving with the group active: no collective, the same logits
    with mesh.watch_collectives() as calls:
        pred, logits = _logits_of(serve, lambda: [
            predict_volume(serve, v, (IMG, IMG), 32) for v in volumes])
    if calls:
        fail(f"serving with a group issued collectives {calls}")
    if len(logits) != len(want_logits) or not all(
            torch.equal(x, y) for x, y in zip(logits, want_logits)) \
            or not all(np.array_equal(x, y) for x, y in zip(pred,
                                                            want_pred)):
        fail("serving with a group: logits or labels differ from the run "
             "without it")
    log(f"parallel (d): predict_volume on 2 volumes (40, 512, 512) bf16 "
        f"with the group active: 0 collectives, {len(logits)} forwards' "
        f"logits and the label maps bitwise equal to the run without it")
    return dict(scan_rows=ring_counts["scan_rows"], dp_ms=dp_ms)


# --- phase 24: the H-sharded QuadGroupSS2D (the scan island) ---------------

SP_BATCH = 8
# gm_tiny's QuadGroupSS2D (H = W, C) in a 512x512 forward; the decoder's
# fronts repeat the first three
SP_SHAPES = ((128, 64), (64, 128), (32, 348), (16, 448))
SP_SHARDS = 4
SP_TOL = (2e-4, 2e-4)                   # tests/test_sp_ss2d.py's forward
SP_TIMED = 5


def _sp_block(C, dev, dwconv="library"):
    """A gm_tiny QuadGroupSS2D of width C with the model's seeded init."""
    from ceigm_unet_tpu_torch.models.msvm_unet import init_weights
    from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
    block = QuadGroupSS2D(C, dwconv=dwconv)
    init_weights(block, torch.Generator().manual_seed(SEED))
    return block.to(dev)


def _sp_shards(t):
    """(B, H, W, C) -> (SP_SHARDS, B, H/SP_SHARDS, W, C)."""
    return t.unflatten(1, (SP_SHARDS, t.shape[1] // SP_SHARDS)).movedim(1, 0)


def _sp_image(t):
    return t.movedim(0, 1).flatten(1, 2)


def _fwd_bwd(fn, x, ct):
    """fn(x)'s output and the gradient of sum(fn(x) * ct) in x; the
    parameters fn reads accumulate theirs in ``.grad``."""
    x = x.detach().requires_grad_()
    y = fn(x)
    (y * ct).sum().backward()
    return y.detach(), x.grad


def _sp_times(fn, reps=SP_TIMED):
    """ms per call of ``fn``: the device's time with the calls queued
    behind ``kernel_ab.device_time``'s spin kernel, the device work summed
    by a CUDA-only torch.profiler, and the host's time to issue one call
    (the spin covers the issue of its ``reps`` calls only when they take
    less than it)."""
    from torch.profiler import ProfilerActivity, profile

    from ceigm_unet_tpu_torch.kernel_ab import device_time
    spin = device_time(fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return spin, device_seconds(prof) * 1e3 / reps, issue


def phase_sp_block(dev, gpu):
    """Phase 24 (see the module docstring). Returns the launches of each
    kernel on (a)'s path."""
    import tempfile

    import torch.distributed as dist

    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.parallel import init_data_parallel, mesh
    from ceigm_unet_tpu_torch.parallel.sp_context import sp_scan_island
    from ceigm_unet_tpu_torch.parallel.sp_ss2d import quad_group_ss2d_stacked
    stacked = lambda blk: lambda x: _sp_image(quad_group_ss2d_stacked(
        blk, _sp_shards(x)))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    path = {}
    fp32_128 = None
    for H, C in SP_SHAPES:
        first = H == SP_SHAPES[0][0]
        for dwconv in ("library", "kernel") if first else ("library",):
            block = _sp_block(C, dev, dwconv)
            x = torch.randn((SP_BATCH, H, H, C), generator=gen,
                            device=dev) * 0.5
            ct = torch.randn(x.shape, generator=gen, device=dev)
            # (a) the island's path: 4 stacked shards, forward + backward
            block.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with mesh.watch_collectives() as coll:
                y, gx = _fwd_bwd(stacked(block), x, ct)
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            want_counts = {"scan_rows": 16}
            if dwconv == "kernel":
                want_counts.update(dwconv3x3=1, dwconv3x3_flip=1)
            if counts != want_counts or coll:
                fail(f"sp block {H}x{H} C{C} {dwconv}: launches {counts}, "
                     f"expected {want_counts}; collectives {coll}")
            for k, v in counts.items():
                path[k] = path.get(k, 0) + v
            gp = {k: p.grad for k, p in block.named_parameters()}
            # against the unsharded block on the card (K1, K8)
            block.zero_grad(set_to_none=True)
            _build.reset_launch_counts()
            want, want_gx = _fwd_bwd(block, x, ct)
            ref_counts = dict(_build.launch_counts)
            if ref_counts.get("quad_scan_ln") != 1 \
                    or ref_counts.get("scan2d") != 2:
                fail(f"sp block {H}x{H} C{C}: the unsharded block launched "
                     f"{ref_counts}")
            err = compare(y, want, SP_TOL)
            used = {"x": grad_tolerance_used(gx, want_gx)}
            used.update({k: grad_tolerance_used(gp[k], p.grad)
                         for k, p in block.named_parameters()})
            worst = max(used, key=used.get)
            if used[worst] > 1.0:
                fail(f"sp block {H}x{H} C{C} {dwconv}: gradient {worst} "
                     f"uses {used[worst]:.3f} of its tolerance")
            if first and dwconv == "library":
                fp32_128 = (block, x, y)
            # (d) times, stacked against unsharded
            with torch.no_grad():
                fwd = [_sp_times(lambda: f(x))
                       for f in (stacked(block), block)]
            both = [_sp_times(lambda: _fwd_bwd(f, x, ct))
                    for f in (stacked(block), block)]
            fmt = lambda t: (f"{t[0][0]:.4f} vs {t[1][0]:.4f} behind the "
                             f"spin, {t[0][1]:.4f} vs {t[1][1]:.4f} of "
                             f"device work, {t[0][2]:.3f} vs {t[1][2]:.3f} "
                             f"to issue")
            log(f"sp block (a, d): {H}x{H} C{C} b{SP_BATCH} fp32 "
                f"{dwconv} conv, {SP_SHARDS} stacked shards vs unsharded: "
                f"out max abs err {err:.3e} (max|out| "
                f"{want.abs().max().item():.3e}); gradients within phase "
                f"8's tolerance (nearest {worst} at {used[worst]:.2e}); "
                f"launches per block fwd+bwd {counts} (unsharded "
                f"{ref_counts}), collectives 0; ms per block forward "
                f"{fmt(fwd)}; forward+backward {fmt(both)} | {gpu}")
            del block, x, ct, y, gx, gp, want, want_gx

    # (b) a group of one over NCCL: the module under the context
    block, x, y32 = fp32_128
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    init_data_parallel(1, device="cuda", store_path=os.path.join(tmp, "s"),
                       timeout_s=120.0)
    try:
        with torch.no_grad():
            with sp_scan_island():
                got = block(x)
            want = quad_group_ss2d_stacked(block, x[None])[0]
        with sp_scan_island(), mesh.watch_collectives() as coll:
            _fwd_bwd(block, x, torch.ones_like(x))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if not torch.equal(got, want):
        fail(f"sp block (b): the module in a group of one differs from one "
             f"stacked shard by {(got - want).abs().max().item():.3e}")
    if coll != {"all_gather": 8, "all_to_all_single": 8}:
        fail(f"sp block (b): collectives per block {coll}")
    shape = f"{x.shape[1]}x{x.shape[2]} C{x.shape[3]} b{x.shape[0]}"
    log(f"sp block (b): {shape} under sp_scan_island in a "
        f"group of one over NCCL: bitwise the 1-shard stacked block; "
        f"collectives per block forward+backward {coll}")

    # (c) bf16 against fp32
    with torch.no_grad():
        y16 = _sp_image(quad_group_ss2d_stacked(
            block, _sp_shards(x.bfloat16())))
    err = check_bf16(y16, y32, "sp block (c) bf16")
    log(f"sp block (c): {shape} bf16 on {SP_SHARDS} stacked "
        f"shards vs fp32: max abs err {err:.3e}, max|fp32 out| "
        f"{y32.abs().max().item():.3e}")
    del block, x, y32, y16, got, want
    torch.cuda.empty_cache()
    return path


# --- phase 25: the H-sharded model -----------------------------------------

SPM_SIZE = 512                  # the 512x512 images H-sharding is for
SPM_BATCH = 8                   # the forward's batch; the gradients at b2
SPM_GRAD_BATCH = 2
SPM_TIMED = 1                   # profiling a sharded step takes s
OFFSET_SCALE = 600.0            # DySample's offset convs, phase 25


def _spm_expected(model):
    """Launches per stacked forward of ``model`` on SP_SHARDS shards (K11:
    8 per quad block; K3 per CustomFfn once per shard, run per shard; K4
    and K5 once per DySample and LGAG on all shards) and the collectives
    of one forward in a group of one (each block's 4 ring-summary
    all-gathers and 4 all-to-alls; each MultiScaleCAB's max and min
    all-gathers and mean all-reduce; each DySample's source all-gather;
    each SE pool's all-reduce; a group of one sends no halo)."""
    from ceigm_unet_tpu_torch.models.emcad import DySample, MultiScaleCAB
    from ceigm_unet_tpu_torch.models.groupmamba import GroupMambaLayer
    from ceigm_unet_tpu_torch.models.layers import CustomFfn
    from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
    count = lambda cls: sum(isinstance(m, cls) for m in model.modules())
    blocks, cabs, dys = (count(QuadGroupSS2D), count(MultiScaleCAB),
                         count(DySample))
    ffns = count(CustomFfn)
    launches = {"scan_rows": 8 * blocks,
                "cffn_gemm": 2 * ffns * SP_SHARDS,
                "cffn_dw3_inception7": ffns * SP_SHARDS,
                "dysample_grid_sample": dys, "lgag_gate": dys}
    calls = {"all_gather": 4 * blocks + 2 * cabs + dys,
             "all_reduce": count(GroupMambaLayer) + cabs,
             "all_to_all_single": 4 * blocks}
    return launches, calls


@contextlib.contextmanager
def _seen_grids():
    """The (source H, grid) of every ``dysample_grid_sample`` call the
    model makes inside the block, in the yielded list."""
    from ceigm_unet_tpu_torch.models import emcad
    seen, sample = [], emcad.dysample_grid_sample

    def spy(x, grid):
        seen.append((x.shape[1], grid.detach()))
        return sample(x, grid)
    emcad.dysample_grid_sample = spy
    try:
        yield seen
    finally:
        emcad.dysample_grid_sample = sample


def _cross_shard_rows(seen) -> str:
    """Fails unless at each DySample some samples land two or more rows
    inside a shard other than their output row's (the stacked form samples
    the whole image's grid in one call)."""
    shares = []
    for H, grid in seen:
        rows = (grid[..., 1] + 1.0) * H / 2.0 - 0.5     # source rows
        hl, Ho = H // SP_SHARDS, grid.shape[1]
        own = (torch.arange(Ho, device=grid.device) // (Ho // SP_SHARDS)
               ).view(1, -1, 1, 1) * hl
        inside = (rows <= own - 2) | (rows >= own + hl + 1)
        shares.append(inside.float().mean().item())
    if len(seen) != 3 or min(shares) < 1e-3:
        fail(f"sp model (a): DySample's samples two or more rows inside "
             f"another shard: shares {shares} of {len(seen)} calls")
    return ", ".join(f"{x:.4f}" for x in shares)


def phase_sp_model(dev, gpu):
    """Phase 25 (see the module docstring). Returns the launches of each
    kernel on (b)'s path, one forward and backward."""
    from ceigm_unet_tpu_torch.models import build_model
    model = build_model(num_classes=9, enc_name="gm_tiny", seed=SEED,
                        device=dev)
    # DySample's two offset convs 600x (tests/test_torch_sp_model.py's
    # scale): samples land rows inside other shards and past the border
    with torch.no_grad():
        for k, p in model.named_parameters():
            if ".offset." in k:
                p.mul_(OFFSET_SCALE)
    launches, calls = _spm_expected(model)
    return _sp_whole(dev, gpu, model, "sp model", "gm_tiny", launches,
                     calls, {"quad_scan_ln": launches["scan_rows"] // 8},
                     _seen_grids)


def _spl_expected(model):
    """Launches per stacked forward of the legacy model on SP_SHARDS shards
    (K11: 8 per SS2D, two per direction; no K10) and the collectives of
    one forward in a group of one (each SS2D's 4 ring-summary all-gathers
    and its 2 all-to-alls: the map to W-shards, the column-major sum
    back); and the unsharded forward's launches (K10 once per SS2D)."""
    from ceigm_unet_tpu_torch.models.ss2d import SS2D
    ops = sum(isinstance(m, SS2D) for m in model.modules())
    return ({"scan_rows": 8 * ops},
            {"all_gather": 4 * ops, "all_to_all_single": 2 * ops},
            {"sscan_dir": ops})


def phase_sp_legacy(dev, gpu):
    """Phase 26 (see the module docstring). Returns the launches of each
    kernel on (b)'s path, one forward and backward, and the unsharded
    reference forward's."""
    from ceigm_unet_tpu_torch.models import build_legacy_model
    model = build_legacy_model(num_classes=9, enc_name="tiny_0230s",
                               seed=SEED, device=dev)
    launches, calls, ref = _spl_expected(model)
    path = _sp_whole(dev, gpu, model, "sp legacy", "tiny_0230s", launches,
                     calls, ref)
    return path, ref


def _sp_whole(dev, gpu, model, tag, name, want_launches, want_calls,
              ref_launches, watch=contextlib.nullcontext):
    """Phases 25 and 26 on ``model``: (a) to (e) of the module docstring.
    ``want_launches`` / ``want_calls``: the launches per stacked forward
    and the collectives per forward in a group of one; ``ref_launches``
    those the unsharded forward must make (it may make others); ``watch``
    a context whose value, if any, holds DySample's grids of (a)'s sharded
    forward. Returns the launches of each kernel on (b)'s path."""
    import tempfile

    import torch.distributed as dist

    from ceigm_unet_tpu_torch import losses
    from ceigm_unet_tpu_torch.ops import _build
    from ceigm_unet_tpu_torch.parallel import (init_data_parallel, mesh,
                                               sp_forward,
                                               sp_forward_stacked,
                                               sp_value_and_grad_stacked)
    t0 = time.perf_counter()
    at = lambda: f"at {time.perf_counter() - t0:.1f} s"
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    x = torch.randn((SPM_BATCH, SPM_SIZE, SPM_SIZE, 1), generator=gen,
                    device=dev)
    sharded = lambda t: _sp_image(sp_forward_stacked(model, _sp_shards(t)))
    shape = f"{name} {SPM_SIZE}x{SPM_SIZE}"

    # (a) the forward, b8 fp32, 4 stacked shards against unsharded
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with torch.no_grad(), mesh.watch_collectives() as coll, \
            watch() as seen:
        got = sharded(x)
    torch.cuda.synchronize()
    fwd_counts = dict(_build.launch_counts)
    if fwd_counts != want_launches or coll:
        fail(f"{tag} (a): launches per forward {fwd_counts}, expected "
             f"{want_launches}; collectives {coll}")
    crossing = ("" if seen is None else f"; shares of DySample's samples "
                f"2+ rows inside another shard {_cross_shard_rows(seen)}")
    _build.reset_launch_counts()
    with torch.no_grad():
        want = model(x)
    ref_counts = dict(_build.launch_counts)
    if any(ref_counts.get(k) != v for k, v in ref_launches.items()):
        fail(f"{tag} (a): the unsharded forward launched {ref_counts}, "
             f"expected {ref_launches} among them")
    if got.shape != (SPM_BATCH, SPM_SIZE, SPM_SIZE, 9) \
            or not bool(torch.isfinite(got).all()):
        fail(f"{tag} (a): logits {tuple(got.shape)} not finite or wrong "
             f"shape")
    err = (got - want).abs()
    scale = want.abs().max().item()
    rtol, atol = MODEL_TOL
    if bool((err > atol * scale + rtol * want.abs()).any()):
        fail(f"{tag} (a): sharded logits differ from the unsharded "
             f"model's by {err.max().item():.3e} (max|logit| {scale:.3e})")
    log(f"{tag} (a): {shape} b{SPM_BATCH} fp32, {SP_SHARDS} stacked "
        f"H-shards vs the unsharded model on the card: max abs err "
        f"{err.max().item():.3e} (max|logit| {scale:.3e}, rtol {rtol} atol "
        f"{atol}*max); launches per forward {fwd_counts} (unsharded "
        f"{ref_counts}), collectives 0{crossing} {at()}")

    # (c) bf16 against fp32
    model.dtype = torch.bfloat16
    with torch.no_grad():
        got16 = sharded(x)
    model.dtype = torch.float32
    if got16.dtype != torch.bfloat16:
        fail(f"{tag} (c): bf16 forward returned {got16.dtype} logits")
    bf_err = check_bf16(got16, want, f"{tag} (c) bf16 logits")
    log(f"{tag} (c): {shape} b{SPM_BATCH} bf16 on {SP_SHARDS} stacked "
        f"shards vs fp32 unsharded: max abs err {bf_err:.3e} (tol "
        f"{BF16_MODEL_TOL}*max) {at()}")
    del got, got16, want, err, seen

    # (b) the DiceCE loss and every parameter gradient, b2
    xb = x[:SPM_GRAD_BATCH]
    labels = torch.randint(0, 9, xb.shape[:3], generator=gen, device=dev)
    stacked_grad = lambda: sp_value_and_grad_stacked(
        model, _sp_shards(xb), _sp_shards(labels))

    def plain_grad():
        loss = losses.dice_ce_loss(model(xb), labels, ce_weight=0.4,
                                   dc_weight=0.6)
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        return loss.detach(), {k: g for k, g in zip(names, grads)}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    loss, grads = stacked_grad()
    torch.cuda.synchronize()
    path = dict(_build.launch_counts)
    want_path = dict(want_launches, scan_rows=2 * want_launches["scan_rows"])
    if path != want_path:
        fail(f"{tag} (b): launches per forward + backward {path}, "
             f"expected {want_path}")
    want_loss, want_grads = plain_grad()
    if abs(loss.item() - want_loss.item()) > 1e-4 * abs(want_loss.item()):
        fail(f"{tag} (b): loss {loss.item()} vs unsharded "
             f"{want_loss.item()}")
    used = {k: grad_tolerance_used(
        g, torch.zeros_like(g) if want_grads[k] is None else want_grads[k])
        for k, g in grads.items()}
    worst = max(used, key=used.get)
    if used[worst] > 1.0:
        fail(f"{tag} (b): gradient {worst} uses {used[worst]:.3f} of "
             f"its tolerance")
    log(f"{tag} (b): {shape} b{SPM_GRAD_BATCH} fp32 DiceCE on "
        f"{SP_SHARDS} stacked shards vs unsharded: loss {loss.item():.6f} "
        f"vs {want_loss.item():.6f}; {len(grads)} gradients within phase "
        f"8's tolerance (nearest {worst} at {used[worst]:.2e}); launches "
        f"per forward + backward {path} {at()}")
    del grads, want_grads

    # (d) a group of one over NCCL: sp_forward against one stacked shard
    xd = x[:SPM_GRAD_BATCH]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spm_")
    init_data_parallel(1, device="cuda", store_path=os.path.join(tmp, "s"),
                       timeout_s=120.0)
    try:
        with torch.no_grad():
            with mesh.watch_collectives() as coll:
                got = sp_forward(model, xd)
            want = sp_forward_stacked(model, xd[None])[0]
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if not torch.equal(got, want):
        fail(f"{tag} (d): sp_forward in a group of one differs from one "
             f"stacked shard by {(got - want).abs().max().item():.3e}")
    if coll != want_calls:
        fail(f"{tag} (d): collectives per forward {coll}, expected "
             f"{want_calls}")
    log(f"{tag} (d): {shape} b{SPM_GRAD_BATCH} sp_forward in a group "
        f"of one over NCCL: bitwise the 1-shard stacked form; collectives "
        f"per forward {coll} {at()}")
    del got, want

    # (e) times and peak memory, sharded against unsharded
    def timed_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return (*_sp_times(fn, SPM_TIMED), peak)
    with torch.no_grad():
        fwd = [timed_peak(lambda: f(x)) for f in (sharded, model)]
    both = [timed_peak(f) for f in (stacked_grad, plain_grad)]
    fmt = lambda t: (f"{t[0][0]:.3f} vs {t[1][0]:.3f} behind the spin, "
                     f"{t[0][1]:.3f} vs {t[1][1]:.3f} of device work, "
                     f"{t[0][2]:.3f} vs {t[1][2]:.3f} to issue, peak "
                     f"{t[0][3]:.2f} vs {t[1][3]:.2f} GiB")
    log(f"{tag} (e): {shape} fp32, {SP_SHARDS} stacked shards vs "
        f"unsharded, ms per b{SPM_BATCH} forward {fmt(fwd)}; per "
        f"b{SPM_GRAD_BATCH} forward + backward {fmt(both)} {at()} | {gpu}")
    del model, x
    torch.cuda.empty_cache()
    return path



# --- phase 27: training trajectories ----------------------------------------

TRAJ_IMG, TRAJ_BATCH = 64, 2
TRAJ_STEPS, TRAJ_FROZEN = 20, 2
TRAJ_SEEDS = (SEED, SEED + 1)           # the two batches, used alternately
TRAJ_LOSS_RTOL = 2e-4                   # per step, times 1 + step (PARITY.md)
TRAJ_LOGITS_TOL = 5e-3                  # rtol, and atol / max|logit|
TRAJ_BF16_LOSS, TRAJ_BF16_LOGITS = 5e-2, 0.05
# (name, legacy, base LR, launches per unfrozen step, K8 scans per frozen
# step, launches per eval forward, whether the CPU also runs in bf16).
# gm_tiny steps from the CLIs' 5e-4. tiny_0230s steps from 2e-6: at 64x64
# b2 its AdamW trajectory is chaotic in fp32 from 1e-5 up (two fp32 runs on
# the CPU, or fp32 against float64, part by up to 3x the loss bound and
# 6x-40x the logits bound; tools/trajectory_drift.py), so no bound could
# tell the card's rounding from a fault there.
TRAJ_MODELS = (
    ("gm_tiny", False, 5e-4, PER_TRAIN_STEP, FROZEN_SCANS, PER_FORWARD,
     True),
    ("tiny_0230s", True, 2e-6, LEGACY_PER_STEP, LEGACY_FROZEN_SCANS,
     LEGACY_PER_FORWARD, False))
# the CPU runs of each model: (tag, dtype, threads); the second is the
# first on fewer threads, its own reorder floor
TRAJ_CPU_RUNS = (("cpu fp32", torch.float32, 2),
                 ("cpu fp32 on 1 thread", torch.float32, 1),
                 ("cpu bf16", torch.bfloat16, 2))
# processes for phase 27's CPU work: at most 6 of the host's 8 cores, so
# that the phases it runs beside keep 2
TRAJ_POOL = 3


def traj_shapes(shapes):
    """``shapes`` ((tag, calls, side, D) of a 224x224 input) at TRAJ_IMG."""
    return [(f"{S * TRAJ_IMG // IMG}x{S * TRAJ_IMG // IMG} D{D}", n,
             S * TRAJ_IMG // IMG, D) for _, n, S, D in shapes]


@contextlib.contextmanager
def float64_compute():
    """In this process, rebinds the port's casts to fp32 (``torch.float32``,
    ``torch.float``, ``Tensor.float``) to float64, so that a model cast to
    float64 computes every op in float64 (the drop-path masks come from
    ``torch.rand`` in the default dtype, the same as fp32's). For the CPU
    references run in processes of their own."""
    f32, to_f32 = torch.float32, torch.Tensor.float
    torch.float32 = torch.float = torch.float64
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.float32 = torch.float = f32
        torch.Tensor.float = to_f32


def _trajectory(device, legacy, dtype, base_lr, per_step=None):
    """TRAJ_STEPS steps of the training CLI's optimizer and schedule
    (``_trainer`` from ``base_lr``) on gm_tiny (with ``legacy``,
    tiny_0230s) built from SEED, computing in ``dtype`` with fp32
    parameters (float64, on the CPU only: parameters cast and every op in
    float64, :func:`float64_compute`), at TRAJ_IMG, batch TRAJ_BATCH, on the
    synthetic batches of TRAJ_SEEDS used alternately; the encoder frozen
    for the first TRAJ_FROZEN steps; each step's drop-path masks from a CPU
    generator seeded with SEED + step, so every device draws the same.
    ``per_step`` (frozen, unfrozen) launch counts are checked step by step,
    counters reset just before and read just after. Returns the losses, the
    final eval logits of the first batch (float64, on the CPU), the launches
    of the steps and of that forward summed, that forward's launches, and
    the time taken."""
    from ceigm_unet_tpu_torch.entry import synthetic_batch
    from ceigm_unet_tpu_torch.models import build_legacy_model, build_model
    from ceigm_unet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    exact = dtype == torch.float64
    build = build_legacy_model if legacy else build_model
    model = build(num_classes=9, enc_name="tiny_0230s" if legacy
                  else "gm_tiny", dtype=torch.float32 if exact else dtype,
                  seed=SEED, device=device)
    if exact:
        model = model.double()
        model.dtype = dtype
    step = _trainer(model, device, base_lr)
    batches = [synthetic_batch(TRAJ_BATCH, TRAJ_IMG, 9, s, device)
               for s in TRAJ_SEEDS]
    if exact:
        batches = [dict(b, image=b["image"].double()) for b in batches]
    enc0 = [p.detach().clone() for p in model.encoder.parameters()]
    built = time.perf_counter() - t0
    losses, total, times = [], {}, []
    with float64_compute() if exact else contextlib.nullcontext():
        for i in range(TRAJ_STEPS):
            frozen = i < TRAJ_FROZEN
            _build.reset_launch_counts()
            t1 = time.perf_counter()
            loss = step(batches[i % 2], freeze_encoder=frozen,
                        generator=torch.Generator().manual_seed(SEED + i))
            losses.append(loss["loss"].item())
            times.append((time.perf_counter() - t1) * 1e3)
            counts = dict(_build.launch_counts)
            if per_step is not None and counts != per_step[not frozen]:
                fail(f"trajectory step {i}: kernel launches {counts}, "
                     f"expected {per_step[not frozen]}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            if frozen and not all(torch.equal(p, q) for p, q in zip(
                    model.encoder.parameters(), enc0)):
                fail(f"trajectory step {i}: the encoder moved while frozen")
        if not all(np.isfinite(losses)):
            fail(f"trajectory: non-finite loss in {losses}")
        _build.reset_launch_counts()
        with torch.no_grad():
            logits = model.eval()(batches[0]["image"])
    logits = logits.to(torch.float64).cpu()
    for k, v in _build.launch_counts.items():
        total[k] = total.get(k, 0) + v
    eval_counts = dict(_build.launch_counts)
    del model, step, enc0
    if device != "cpu":
        torch.cuda.empty_cache()
    took = (f"{time.perf_counter() - t0:.1f} s: build {built:.1f} s, first "
            f"step {times[0]:.0f} ms, then median "
            f"{statistics.median(times[1:]):.0f} ms/step")
    return losses, logits, total, eval_counts, took


def _loss_shares(got, want, bound):
    """Per step, the share of ``bound(i, want_i)`` that |got_i - want_i|
    uses."""
    return [abs(g - w) / bound(i, w)
            for i, (g, w) in enumerate(zip(got, want))]


def _logit_share(got, want, rtol, atol_frac):
    """The share of rtol * |want| + atol_frac * max|want| that |got - want|
    uses, at its largest element."""
    tol = rtol * want.abs() + atol_frac * want.abs().max()
    return ((got - want).abs() / tol).max().item()


def _within_limits(what, checks, gpu):
    """``checks``: {quantity: (the card's shares of its bound, the CPU's own
    shares of it or None)}, one share per step (one for the final logits).
    At each step the card's share must stay within max(1, NOISE_MARGIN x
    the CPU's share at that step), and never past NOISE_MARGIN: the CPU's
    own rounding lifts a bound at most to twice it; without CPU shares the
    limit is the bound. Logs each quantity's largest share of its bound and
    of its limit."""
    parts, worst = [], 0.0
    for quantity, (used, floor) in checks.items():
        own = floor or [0.0] * len(used)
        limits = [min(NOISE_MARGIN, max(1.0, NOISE_MARGIN * f)) for f in own]
        ratio = [u / lim for u, lim in zip(used, limits)]
        at = int(np.argmax(ratio))
        worst = max(worst, ratio[at])
        step = f" at step {at}" if len(used) > 1 else ""
        cpu = (f"the CPU's own {own[at]:.3f} (largest {max(own):.3f}), "
               f"limit {limits[at]:.3f}" if floor else "limit the bound")
        parts.append(f"{quantity} use at most {max(used):.3f} of the bound "
                     f"and {ratio[at]:.3f} of the limit{step} "
                     f"({used[at]:.3f}; {cpu})")
    log(f"trajectory {what}: {'; '.join(parts)} | {gpu}")
    if worst > 1.0:
        fail(f"trajectory {what}: {worst:.3f} of the limit")


def _cpu_trajectory(legacy, dtype, base_lr, threads):
    """:func:`_trajectory` on the CPU on ``threads`` threads, in a process
    of its own (phase 27's pool)."""
    torch.set_num_threads(threads)
    return _trajectory("cpu", legacy, dtype, base_lr)


@contextlib.contextmanager
def trajectory_cpu_runs():
    """The CPU work of phases 27 and 28: yields a dict whose ``"start"``
    starts it (``start((28,))`` phase 28's alone), in TRAJ_POOL spawned
    processes at the lowest priority (``os.nice(19)``), so that it takes
    what the phases before leave of the host: phase 27's float64 steps of
    (a) on 2 threads and trajectories of (b) on the threads TRAJ_CPU_RUNS
    gives them; then ``"exact"`` is {name: pending} and ``"runs"`` {(name,
    tag): pending}; then phase 28's b2 224x224 fp32 logits of each of
    CONFIGS and the fp32 and float64 64x64 steps of TRAIN_CONFIG, on 2
    threads each, in ``"configs"`` {("logits", name) / ("step", name) /
    ("exact", name): pending}. The processes are stopped on exit."""
    import multiprocessing
    jobs = {(name, tag): (legacy, dtype, lr, threads)
            for name, legacy, lr, *_, cpu_bf16 in TRAJ_MODELS
            for tag, dtype, threads in TRAJ_CPU_RUNS
            if cpu_bf16 or dtype != torch.bfloat16}
    with contextlib.ExitStack() as stack:
        runs = {}

        def start(phases=(27, 28)):
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(TRAJ_POOL, initializer=os.nice,
                              initargs=(19,)))
            if 27 in phases:
                runs["exact"] = {name: pool.apply_async(
                    _float64_step, (legacy, None, TRAJ_IMG))
                    for name, legacy, *_ in TRAJ_MODELS}
                runs["runs"] = {key: pool.apply_async(_cpu_trajectory, args)
                                for key, args in jobs.items()}
            if 28 in phases:
                runs["configs"] = {
                    **{("logits", name): pool.apply_async(_cpu_logits,
                                                          (name,))
                       for name in CONFIGS},
                    ("step", TRAIN_CONFIG): pool.apply_async(
                        _cpu_step, (TRAIN_CONFIG, TRAJ_IMG)),
                    ("exact", TRAIN_CONFIG): pool.apply_async(
                        _float64_step, (False, None, TRAJ_IMG, 2,
                                        TRAIN_CONFIG))}
        runs["start"] = start
        yield runs


def phase_trajectory(dev, gpu, cpu_runs):
    """Phase 27 (see the module docstring), on the CPU work of
    :func:`trajectory_cpu_runs` (started here if it was not yet). Returns
    the launches of every kernel over the card's runs."""
    if "runs" not in cpu_runs:
        cpu_runs["start"]((27,))
    for name, legacy, *_ in TRAJ_MODELS:
        phase_train_vs_cpu(dev, gpu, None, LEGACY_PER_STEP if legacy
                           else PER_TRAIN_STEP, legacy, TRAJ_IMG,
                           cpu_runs["exact"][name])
    card = {}
    for name, legacy, lr, per_step, frozen_scans, *_ in TRAJ_MODELS:
        expect = (dict(per_step, scan2d=frozen_scans), per_step)
        for tag, dtype in (("card fp32", torch.float32),
                           ("card bf16", torch.bfloat16)):
            card[name, tag] = _trajectory(dev, legacy, dtype, lr, expect)
    cpu = {key: r.get(timeout=900)
           for key, r in cpu_runs["runs"].items()}
    launches = {}
    for name, _, lr, _, _, per_eval, cpu_bf16 in TRAJ_MODELS:
        runs = {tag: run for (n, tag), run in [*card.items(), *cpu.items()]
                if n == name}
        for tag in ("card fp32", "card bf16"):
            if runs[tag][3] != per_eval:
                fail(f"trajectory {name} {tag}: eval forward launches "
                     f"{runs[tag][3]}, expected {per_eval}")
            for k, v in runs[tag][2].items():
                launches[k] = launches.get(k, 0) + v
        for tag, (losses, _, _, _, took) in runs.items():
            log(f"trajectory {name} {tag} from LR {lr}: {TRAJ_STEPS} losses "
                f"{[round(v, 6) for v in losses]} ({took})")

        # card fp32 against the CPU, card bf16 against card fp32, each step
        # read against the CPU's own drift at that step: for fp32 its run on
        # fewer threads against its run, for bf16 its bf16 run against its
        # fp32 one
        (lc, gc, *_), (lw, gw, *_), (lr1, gr1, *_), (lb, gb, *_) = (
            runs[t] for t in ("card fp32", "cpu fp32", "cpu fp32 on 1 thread",
                              "card bf16"))
        fp32 = lambda i, w: TRAJ_LOSS_RTOL * (1 + i) * max(1.0, abs(w))
        bf16 = lambda i, w: TRAJ_BF16_LOSS * abs(w)
        _within_limits(f"{name} card fp32 vs CPU fp32", {
            "losses": (_loss_shares(lc, lw, fp32),
                       _loss_shares(lr1, lw, fp32)),
            "final logits": (
                [_logit_share(gc, gw, TRAJ_LOGITS_TOL, TRAJ_LOGITS_TOL)],
                [_logit_share(gr1, gw, TRAJ_LOGITS_TOL, TRAJ_LOGITS_TOL)])},
            gpu)
        bf16_logits = lambda got, want: ((got - want).abs().max()
                                         / want.abs().max()).item()
        floors = (None, None)
        if cpu_bf16:
            lv, gv, *_ = runs["cpu bf16"]
            floors = (_loss_shares(lv, lw, bf16),
                      [bf16_logits(gv, gw) / TRAJ_BF16_LOGITS])
        _within_limits(f"{name} card bf16 vs card fp32", {
            "losses": (_loss_shares(lb, lc, bf16), floors[0]),
            "final logits": ([bf16_logits(gb, gc) / TRAJ_BF16_LOGITS],
                             floors[1])}, gpu)
    log(f"trajectory launches over the card's runs: {launches}")
    return launches


# --- phase 28: gm_small and gm_base -----------------------------------------

# the JAX package's other two GroupMamba configurations (upstream
# GroupMamba-S and -B widths), each served; TRAIN_CONFIG also trains
CONFIGS = ("gm_small", "gm_base")
TRAIN_CONFIG = "gm_base"
CONFIG_STEPS = [True] * 2 + [False] * 3         # frozen, then unfrozen
# TRAIN_CONFIG's trainer batches: b48 in fp32 needs more than the card's
# 79.18 GiB (an H100 80GB HBM3 at 700.00 W: b16 peaks at 31.58 GiB, b32 at
# 60.12, b48 runs out), so fp32 steps at b32; bf16 at b48 peaks at 50.52
CONFIG_BATCH = {torch.float32: 32, torch.bfloat16: TRAIN_BATCH}


def phase_config_kernels(dev, gpu):
    """Phase 28 (a): every kernel against its plain version at the shapes
    of TRAIN_CONFIG (phase 3's K1-K5 and phase 14's route kernels at b2
    fp32, b2 bf16, b32 and b48 fp32 and b128 bf16, each timed beside its
    bound and library call per b128 bf16 and per b32 fp32 forward; phase
    7's K8 in both modes at b2 and b48 and at b2 on the 64x64 maps).
    Returns {name: its phase_kernels entry}."""
    f32 = torch.float32
    extra, timed = [(TEST_BATCH, f32), (TRAIN_BATCH, f32)], [(TEST_BATCH,
                                                              f32)]
    results = phase_kernels(dev, gpu, kernel_cases(dev, TRAIN_CONFIG, 28),
                            "forward", extra, timed)
    forward, backward = route_kernel_cases(dev, TRAIN_CONFIG)
    results.update(phase_kernels(dev, gpu, forward, "forward", extra, timed))
    results.update(phase_kernels(dev, gpu, backward, "backward", extra,
                                 timed))
    # K8's operands in the quad scan's backward layout, as gm_tiny's
    shapes = scan_shapes(TRAIN_CONFIG)
    results["scan2d"] = phase_scan2d(dev, gpu, shapes, (2, TRAIN_BATCH),
                                     TRAIN_CONFIG, "gm_tiny")
    results["scan2d"]["max_abs_err_64x64"] = phase_scan2d(
        dev, gpu, traj_shapes(shapes), (TRAJ_BATCH,), TRAIN_CONFIG,
        "gm_tiny")["max_abs_err"]
    return results


def phase_config_trainer(dev, gpu):
    """Phase 28 (c), after the one-step check: ``entry.train_entry`` of
    TRAIN_CONFIG at 224x224, 2 frozen-encoder then 3 unfrozen steps, in
    fp32 (TF32 off, the training CLIs' default) and in bf16, at the batch
    CONFIG_BATCH gives each: finite losses that fall, the encoder bitwise
    unchanged while frozen, each step's launches (K8 FROZEN_SCANS per
    frozen step, twice per quad block per unfrozen one), ms/step and peak
    memory. Returns the launches summed."""
    per_step = per_train_step(TRAIN_CONFIG)
    want = [dict(per_step, scan2d=FROZEN_SCANS) if frozen else per_step
            for frozen in CONFIG_STEPS]
    total = {}
    for dtype, batch in CONFIG_BATCH.items():
        what = f"{TRAIN_CONFIG} b{batch} 224x224 {DTAG[dtype]}"
        model, _, losses, times, counts, mem, *_, steps = _train_run(
            dev, dtype, CONFIG_STEPS, enc_name=TRAIN_CONFIG,
            batch_size=batch)
        del model
        torch.cuda.empty_cache()
        if steps != want:
            fail(f"trainer {what}: launches per step {steps}, expected "
                 f"{want}")
        if not all(np.isfinite(losses)):
            fail(f"trainer {what}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"trainer {what}: the loss did not fall: {losses}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        n = CONFIG_STEPS.count(True)
        log(f"trainer {what}"
            + (" (TF32 off)" if dtype == torch.float32 else "")
            + f": losses {[round(v, 5) for v in losses]}; frozen steps "
            f"{[round(t, 1) for t in times[:n]]} ms, unfrozen "
            f"{[round(t, 1) for t in times[n:]]} ms (median "
            f"{statistics.median(times[n:]):.3f} ms/step); peak memory "
            f"{mem:.2f} GiB; encoder unchanged over the frozen steps; K8 "
            f"{steps[0]['scan2d']} per frozen step, {steps[-1]['scan2d']} "
            f"per unfrozen step; launches {counts} | {gpu}")
    return total


def phase_configs(dev, gpu, cpu_runs):
    """Phase 28 (see the module docstring), on the CPU work of
    :func:`trajectory_cpu_runs` (phase 28's alone started here if it was
    not yet). Returns the kernel entries of (a) and the launches on each
    configuration's path: its serving, and for TRAIN_CONFIG also its two
    trainers."""
    if "configs" not in cpu_runs:
        cpu_runs["start"]((28,))
    cpu = cpu_runs["configs"]
    kernels = phase_config_kernels(dev, gpu)
    launches = {}
    for name in CONFIGS:
        per = per_forward(name)
        model, *_ = phase_model(dev, None, per, name, enc_name=name,
                                cpu=cpu["logits", name])
        phase_throughput(model, dev, gpu, name)
        launches[name] = phase_serving(model, dev, gpu, per, name)
        del model
        torch.cuda.empty_cache()
    phase_train_vs_cpu(dev, gpu, None, per_train_step(TRAIN_CONFIG), False,
                       TRAJ_IMG, cpu["exact", TRAIN_CONFIG], TRAIN_CONFIG,
                       cpu["step", TRAIN_CONFIG])
    for k, v in phase_config_trainer(dev, gpu).items():
        launches[TRAIN_CONFIG][k] = launches[TRAIN_CONFIG].get(k, 0) + v
    log(f"configs: launches on each path {launches}")
    return kernels, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    with trajectory_cpu_runs() as cpu_runs:
        return _phases(dev, gpu, cpu_runs)


def _phases(dev, gpu, cpu_runs) -> int:
    """Phases 2-28 and the last two lines (see the module docstring);
    ``cpu_runs``: the CPU work of phases 27 and 28, started after phase
    3."""
    from ceigm_unet_tpu_torch.ops import _build

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("2 build", _build.library)
    log(f"build: {_build.build().name}")
    # b32 / b48 fp32: the batches and dtype of the test-set path (phase
    # 21) and of training from the command line (phase 22)
    kernels = timed("3 kernels", phase_kernels, dev, gpu, kernel_cases(dev),
                    "forward", [(TEST_BATCH, torch.float32),
                                (TRAIN_BATCH, torch.float32)],
                    [(TEST_BATCH, torch.float32)])
    # the CPU runs of phases 27 and 28 start once phase 3 has timed the
    # kernels, TRAJ_POOL at a time beside phases 4-26
    cpu_runs["start"]()
    model, *_ = timed("4 model", phase_model, dev)
    serving = timed("5 serving", phase_serving, model, dev, gpu)
    base = timed("6 throughput", phase_throughput, model, dev, gpu)
    del model
    torch.cuda.empty_cache()
    kernels["scan2d"] = timed("7 scan2d", phase_scan2d, dev, gpu)
    # and at phase 27's b2 64x64 shapes (checked; their times not kept)
    kernels["scan2d"]["max_abs_err_trajectory"] = timed(
        "7 scan2d at 64x64", phase_scan2d, dev, gpu,
        traj_shapes(TRAIN_SCAN_SHAPES), (TRAJ_BATCH,))["max_abs_err"]
    timed("8 train step vs CPU", phase_train_vs_cpu, dev, gpu)
    training, base_step_ms = timed("9 trainer", phase_trainer, dev, gpu)
    kernels.update(timed("10 legacy kernels", phase_legacy_kernels, dev,
                         gpu))
    model = timed("11 legacy model", phase_legacy_model, dev)
    legacy = timed("12 legacy serving", phase_legacy_serving, model, dev,
                   gpu)
    del model
    torch.cuda.empty_cache()
    scan = timed("13 selective_scan", phase_selective_scan, dev, gpu)
    kernels.update(timed("14 route kernels", phase_route_kernels, dev, gpu))
    kernel_route = timed("15 kernel-depthwise and per-group-DySample model",
                         phase_kernel_route, dev, gpu, base, base_step_ms)
    int8 = timed("16 int8 serving", phase_int8_serving, dev, gpu, base)
    kernels["scan2d"].update(timed("17 legacy scan backward kernels",
                                   phase_legacy_scan2d, dev, gpu))
    timed("18 legacy train step vs CPU", phase_train_vs_cpu, dev, gpu, None,
          LEGACY_PER_STEP, True)
    legacy_training = timed("19 legacy trainer", phase_legacy_trainer, dev,
                            gpu)
    scan_bwd = timed("20 selective_scan backward",
                     phase_selective_scan_backward, dev, gpu)
    test_set = timed("21 test-set inference", phase_test_set, dev, gpu)
    training_cli = timed("22 training from the command line",
                         phase_training_cli, dev, gpu)
    parallel = timed("23 parallel", phase_parallel, dev, gpu)
    sp_block = timed("24 sp block", phase_sp_block, dev, gpu)
    sp_model = timed("25 sp model", phase_sp_model, dev, gpu)
    sp_legacy, sp_legacy_ref = timed("26 sp legacy", phase_sp_legacy, dev,
                                     gpu)
    trajectory = timed("27 training trajectories", phase_trajectory, dev,
                       gpu, cpu_runs)
    at_config, configs = timed("28 gm_small and gm_base", phase_configs,
                               dev, gpu, cpu_runs)
    kernels["scan2d"]["launches_legacy_trainer"] = legacy_training["scan2d"]
    kernels["sscan_dir"]["launches_legacy_trainer"] = \
        legacy_training["sscan_dir"]
    kernels["scan_rows"]["launches_backward"] = scan_bwd["scan_rows"]
    kernels["scan_rows"]["launches_ring_scan"] = parallel["scan_rows"]
    for name in ("scan_rows", "dwconv3x3", "dwconv3x3_flip"):
        kernels[name]["launches_sp_block"] = sp_block.get(name, 0)
    for name in ("scan_rows", "cffn_gemm", "cffn_dw3_inception7",
                 "dysample_grid_sample", "lgag_gate"):
        kernels[name]["launches_sp_model"] = sp_model.get(name, 0)
    kernels["scan_rows"]["launches_sp_legacy"] = sp_legacy["scan_rows"]
    # the kernels the two training paths and their eval forwards run
    for name in [*PER_FORWARD, "scan2d", "sscan_dir"]:
        kernels[name]["launches_trajectory"] = trajectory.get(name, 0)
    kernels["sscan_dir"]["launches_sp_legacy_reference"] = \
        sp_legacy_ref["sscan_dir"]
    # each kernel's launches on its own main path: gm_tiny serving for
    # K1-K5, training for K8, legacy serving for K10, the selective_scan
    # op for K11 and K12, the kernel route's trainer for K13 (both modes)
    # and the single-grid grid-sample, int8 serving for K14
    paths = {"scan2d": training, "sscan_dir": legacy, "scan_rows": scan,
             "selective_scan_n1": scan, "dwconv3x3": kernel_route,
             "dwconv3x3_flip": kernel_route,
             "grid_sample_bilinear": kernel_route, "quad_scan_ln_q8": int8}
    for name in kernels:
        kernels[name]["launches"] = paths.get(name, serving).get(name, 0)
    # and on the test-set path (phase 21), K1-K5; on the training CLI's
    # path (phase 22 (b)), K1-K5 and K8
    for name in PER_FORWARD:
        kernels[name]["launches_test_set"] = test_set.get(name, 0)
    for name in [*PER_FORWARD, "scan2d"]:
        kernels[name]["launches_training_cli"] = training_cli.get(name, 0)
    # on phase 28's paths: each configuration's serving, and TRAIN_CONFIG's
    # trainers; and phase 28 (a)'s checks and times at TRAIN_CONFIG's shapes
    for name in CONFIGS:
        for k in (*PER_FORWARD, *(("scan2d",) if name == TRAIN_CONFIG
                                  else ())):
            kernels[k][f"launches_{name}"] = configs[name].get(k, 0)
    for name, entry in at_config.items():
        kernels[name][f"at_{TRAIN_CONFIG}"] = {
            k: v for k, v in entry.items()
            if k not in ("name", "route", "source", "replaces")}
    if any(k["launches"] == 0 or k.get("launches_test_set") == 0
           or k.get("launches_training_cli") == 0
           or k.get("launches_ring_scan") == 0
           or k.get("launches_sp_block") == 0
           or k.get("launches_sp_model") == 0
           or k.get("launches_sp_legacy") == 0
           or k.get("launches_trajectory") == 0
           or any(k.get(f"launches_{name}") == 0 for name in CONFIGS)
           for k in kernels.values()):
        fail("a kernel was not launched on its path")
    log(gpu)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
