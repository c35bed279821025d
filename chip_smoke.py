#!/usr/bin/env python3
"""Proof that the PyTorch port serves and trains on one NVIDIA GPU, from
dataset files on disk too, with every step option of the model DSL.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of curvecloudnet_tpu_torch/csrc (nvcc, sm_90a);
  3. one capture eval forward of the nuScenes flagship at n_pad 36864, B=1,
     recording every eval kernel call (K1, K2, K3, K6, K4); each recorded
     call is re-run through the kernel and through its plain PyTorch
     version and the outputs compared (tolerances below), both timed with
     CUDA events (a line per call; K1's name the step and give the 3xTF32
     floor: 3x the FP32 operations at the TF32 tensor-core peak); one line
     per K2 call (step, M, K, widths, aggregation,
     live rows, kernel / plain / bound ms and the 3xTF32 floor); one line
     per K3 call (row table or query set, Q, N, k, radius, valid counts,
     kernel / plain / bound ms, the share of tiles visited) and per K6
     call (row, valid points, picks, launch shape, kernel / plain / bound
     ms, us a pick, the fixed cost of a round on a 1024-point row and the
     serial floor: that cost x the picks up to the last valid point);
  4. launch counters set to 0, two synthetic scans (seeds 0, 1) served
     through ``predict``; each kernel's count must equal the spec-derived
     count per scan;
  5. the same first scan through the plain versions on the card: logits
     within 2e-3;
  6. one capture train step (n_pad 36864, B=1, synthetic sweep 0 and its
     labels, NLL + Lovász) recording K8's three passes (forward, reduce,
     t: a chain's inner layers take their reduce sums from the next
     layer's t pass, held against the plain reduce on that pass's own
     d_u_prev at the reduce's 1e-3 of max(1, |plain|), a line each, and
     that t pass timed again without them), K7's forward and backward and
     K4/K4b; each recorded call re-run
     through the kernel and its plain version, compared and timed (the
     backward under the call's own cotangents; K7's plain backward takes
     the plain forward's residuals; backward outputs compared in relative
     L2 norm against a perturbation yardstick, see TRAIN_KERNELS; K8's
     forward statistics within 1e-5; K8's lines name the step and layer,
     its forward and t lines give the 3xTF32 floor, each time the median
     of 21 runs); one line per K7 site (step, M, K,
     widths, aggregation, live rows, queries with no live slot, whose
     ``dout`` must be exactly 0; forward and backward kernel / plain /
     bound / 3xTF32-floor ms and the kernel's ms per pass); the step's K3
     and K6 calls held and timed as in phase 3, with their lines;
  7. launch counters set to 0, five train steps through ``train_step``:
     losses finite and falling, K8/K7/K4/K4b/K3/K6 launches equal to five
     times the spec-derived counts;
  8. one train step from the same weights through the kernels and through
     the plain versions (K8's: the plain chain under torch autograd): loss
     within 1e-4 relative, running statistics
     within 1e-5 (relative to max(1, |stat|)), every parameter gradient
     within 2e-3 of that parameter's largest -- or, for a gradient the
     model's own conditioning cannot hold to that, within 3x the plain
     path's change under a 1e-5 relative weight perturbation plus 2e-3
     (plus 1e-5 of the largest gradient, for gradients that are zero in
     exact arithmetic; each parameter's verdict is printed);
  9. one capture eval forward of the KITTI model (configs/kitti.yaml) at
     n_pad 131072, B=1, on a 64-beam synthetic sweep (seed 0), recording
     every K1, K2, K3, K4, K5 and K6 call and every grid search; each call
     compared with its plain version and timed (K5: indices and distances
     equal), a line per K2, K3 and K6 call as in phase 3; K10 held
     against its plain version (equal) on each K5 call's
     candidate planes, and against K5's answer, timed beside torch.topk,
     its bound all of d and idx at the k chosen columns;
 10. launch counters set to 0, two KITTI scans (seeds 0, 1) through
     ``predict``: logits finite of shape (1, 131072, 20), launches equal to
     the spec-derived counts (two K5 launches a scan), latency and peak
     memory printed;
 11. recall of each grid table of scan 0 against the exact K3 table of the
     same row, radius and k: mean exact-set recall >= 0.95 on the
     curve-sampled row; on the voxel row, whose cap its voxel spacing
     proves, every missing neighbor a tie at the k-th distance; each
     table's drop count printed;
 12. scan 0 through the plain versions of every kernel on the card
     (logits within 2e-3 of the kernel path), then through the grid's
     ``planes`` tail (K10; launch counters set to 0 before it): neighbor
     tables and logits identical to the ``records`` tail's;
 13. the nuScenes flagship on the fused edge route (``edge_kernel="fused"``,
     same weights): launch counters set to 0, scan 0 served through
     ``predict`` with launches equal to the spec-derived counts (K9 on the
     five sgcnn steps the gate admits) and logits within 2e-3 of the
     ``group`` route's; then a capture forward holding each K9 call
     against its plain version (1e-4 of max(1, |plain|); its line gives
     the 3xTF32 floor), each timed beside the group route's cost of the
     same step: K4 + K2 from phase 3 and the layer-0 matmuls (the group
     route's own ``EdgeConvStep.layer0`` on the call's x),
     and each of the route's ten K2 calls against its plain version (as in
     phase 3); then KITTI scan 0 (n_pad 131072, grid rows included) on the
     fused route: launch counters set to 0, launches equal to the spec's,
     logits within 2e-3 of phase 10's group-route logits, each K9 call
     held against its plain version at 1e-4 (the largest error printed);
 14. the A2D2 model (configs/audi.yaml, version 1.0: conv1d-fast-v1 in
     plain torch, ball-grouped sa steps, slow-order sgcnn with attention)
     at n_pad 36864, B=1, on 80-beam synthetic sweeps: a capture forward of
     scan 0 holding every K2, K3, K4 and K6 call against its plain version
     as phase 3 does (K3's ball queries, k = 128, with indices and
     distances equal; a line per K3 call gives its device ms and the
     ``cdist`` + ``topk`` time of the same search), launch counters set to
     0 and scans 0-1 through ``predict`` with launches equal to the
     spec-derived counts, a line per scan (wall ms, device-busy ms from
     ``torch.profiler``, peak memory), then scan 0 through the plain
     versions: logits within 2e-3;
 15. the same for the object configs (shapenet-seg and kortx-testsplit
     with each sample's category, shapenet-class with one logit row per
     sample) at n_pad 2048, B=24, object-scan batches 0-1; then
     shapenet-seg on the fused edge route (K9 with the slow message order
     folded in on its max sgcnn steps): launch counters set to 0, batch 0
     with launches equal to the spec's, logits within 1e-5 of the group
     route's, each K9 call held against its plain version at 1e-4;
 16. the eval entry (``curvecloudnet_tpu_torch.main``) on the card:
     launch counters set to 0, ``main.main`` with ``only_val`` on
     configs/nuscenes.yaml (n_pad 36864, 2 synthetic val scans, 12-view
     TTA in view-batched chunks of 2: B=2 forwards), launches equal to
     the spec's count x 6 chunks x 2 scans (path ``eval_tta``), its logged
     miou / mean_forward_s / points_per_sec / peak memory printed; on scan
     0: the batched mean logits within 1e-4 (of max(1, |ref|)) of the mean
     of 12 sequential B=1 ``predict`` forwards and of the per-view path's,
     every kernel call of one B=2 chunk held against its plain version
     (phase 3's tolerances), the overflow telemetry of each view (zero
     ``*overflow*`` / ``*truncated*`` on the identity view; the worst of
     each key over the 12 views printed); 2 scans' TTA queued back to
     back per view and at 2 and 6 views a call (a line each: ms a
     view, the scan's TTA wall, points/s, peak memory), beside
     ``evaluate_segmentation``'s own figures per view and at 2 (and the
     result dict's keys), and the host waits of one TTA scan by line
     (``torch.cuda.set_sync_debug_mode``); KITTI's TTA (n_pad 131072, 2
     views a call) timed the same way, with its host waits and the device
     busy ms of a B=2 chunk; ``main`` with ``only_val`` on shapenet-seg
     and shapenet-class (16 val scans in batches of 8; launches equal to
     the spec's x 2, paths ``eval_loop_shapenet_seg`` /
     ``eval_loop_shapenet_class``;
     logged metrics finite; the loop's ms a batch), and with ``only_test``
     on a nuScenes scan given a submission meta by a wrapper here: one
     ``.bin`` of the valid points' length under
     ``build/phase16/nuscenes_test/results/lidarseg/test``;
 17. the train paths of the other shipped configs and ``main``'s epoch
     loop.  A2D2 (configs/audi.yaml, n_pad 36864, B=1, an 80-beam sweep
     and its labels, the task's loss) and the object configs
     (shapenet-seg with categories, kortx-testsplit, shapenet-class with
     the classification loss; n_pad 2048, B=24, ``object_batch`` seed 0),
     each through ``train.__main__.train_batch``: one capture step
     recording every K7 forward and backward, K4/K4b, K3 and K6 call, each
     held against its plain version as phase 6 holds it (A2D2 and
     shapenet-seg also timed, a line per call and per K7 site as phase 6's,
     its stored chain's size included; on A2D2 the rows of each K7
     attend site whose activation input takes another slope in the
     kernel than in float64 counted at every BN, each under 0.1% of the
     live rows, and its
     K7 calls captured again on sweep 1, held and counted so, a second
     witness); launch counters set
     to 0 and three steps through ``train_step`` (losses finite, launches
     equal to three times ``kernel_launches(train=True)``; paths
     ``train_audi``, ``train_shapenet_seg``, ``train_kortx``,
     ``train_shapenet_class``), a line with the step walls, the device
     busy ms of one more step (``torch.profiler``), its host waits by line
     and the peak memory; one step from the same weights through the
     kernels and through the plain versions, held as phase 8 holds it.
     KITTI (n_pad 131072, B=1, a 64-beam sweep): the capture step with
     K8, K7, K4/K4b, K3, K5 (equal) and K6 held, three steps with
     launches equal to the spec's (``train_kitti``), walls, busy ms, host
     waits, peak memory.  ``main``'s epoch loop: shapenet-class (48 train
     and 16 val scans, batches of 24, 2 epochs; launches equal to the
     spec's train count x its steps plus its eval count x its val
     batches, path ``train_loop_shapenet_class``; ``best_epoch*``,
     ``latest`` and ``latest_state.json`` written, the score finite), then
     the same outdir to 3 epochs (it resumes at epoch 2: one epoch's
     steps); nuScenes (6 train sweeps, the config's batch of 6, 2 val
     scans under 12-view TTA in chunks of 2, 1 epoch; path
     ``train_loop_nuscenes``; the B=6 step's wall and peak memory);
 18. the data layer: nuScenes, KITTI, A2D2 and shapenet-seg from files
     on disk, written by ``tools/fake_datasets.py`` in each dataset's own
     format at real frame sizes under ``build/phase18/data`` (nuScenes
     31-37k points a frame, KITTI 111-131k, A2D2 33-37k over 5 sensors,
     objects 2048 points).  Per config: each reader's host ms a sample
     (``get`` + ``collate``; KITTI and nuScenes with and without
     PolarMix); ``main`` training one epoch of three steps at the
     config's ``batch_size`` (PolarMix on for KITTI and nuScenes) and
     validating (TTA as the task has it) with a line of step walls, peak
     memory, points a sample and ``n_pad_dropped`` a batch and the
     train loop's share of waits for the loader, launches equal to the
     spec's (paths ``disk_nuscenes``, ``disk_kitti``, ``disk_audi``,
     ``disk_shapenet_seg``); every telemetry channel's maximum over two
     val scans on the trained weights (``tools/calibrate.collect``);
     KITTI and nuScenes ``--only_test`` (paths ``disk_kitti_test``,
     ``disk_nuscenes_test``), each submission file one prediction a
     point of its frame, in the frame's order, equal to the argmax of
     the mean logits the loop dumped; one batch read from disk (lidar
     B=1, objects the config's 24) through a capture train step and a
     val batch through an eval forward, every kernel call held against
     its plain version at phase 6's and phase 3's tolerances;
 19. the step options no shipped config uses, at published widths:
     ``shapenet-class-options`` (``options_model``: shapenet-class with a
     dgcnn-rad step prepended, sa-geo on FPS, curve-fps with a one-layer
     MLP, random and mean sa steps, a dgcnn step, weighted-sum,
     fast-order attend, head dropout 0.5; n_pad 2048, seed 0's batch of
     24 object scans): the dgcnn-rad search's kind and ball counts, the
     curve-fps share kept, a capture eval forward with every K2 / K3 /
     K6 / K4 call held and timed (K2 site lines), one counted forward
     (launches equal to ``kernel_launches``; wall, device busy ms, peak
     memory), logits against the plain path (2e-3); a capture train step
     with every K7 / K4 / K4b call held and timed (K7 site lines, slope
     flips) and K3 / K6 held, one counted step (launches equal to
     ``kernel_launches(train=True)``; wall, peak), the step against the
     plain path as phase 8 holds it.  The plain runs take the kernel
     run's dgcnn graph (``GraphReplay``: its own graph, on features that
     differ by rounding, must differ only at distance ties).
     ``nuscenes_k1`` (nuScenes with step 0's ``kernel_size`` 1): one scan,
     launches equal to the spec's (one K1 fewer), logits against the
     plain path (2e-3); its fp step 18 on a cloud with no ``parent_idx``,
     that K3 call held against its plain version;
 20. bfloat16 serving (``compute_dtype: bfloat16``, ``run_bf16``):
     ``bf16_eval``, the flagship at n_pad 36864 on the group route,
     seeds 0-2: the per-step output dtypes equal the CPU path's (step 0's
     conv float32 from the sweep's float32 features, bfloat16 after),
     every K1-bf16 (one bfloat16 ulp at the output's scale, under 1% of
     the elements differing), K2-bf16 (2^-8 of its scale) and K4-bf16
     (equal) call of scan 0 held against its plain version and timed
     (bounds at the bfloat16 tensor rate), launches of both dtypes equal
     the float32 scan's, each scan's logits within the plain path's own
     bf16-vs-f32 gap of the plain path's (twice it: two draws of the
     forward's bfloat16 noise; ``hold_bf16_logits``) and as accurate
     against float32 on average; the scan walls (median and
     quartiles of 12 scans of each dtype, in turns), busy ms by group and
     peak memory of each dtype; ``bf16_fused``, the fused route (K9
     reading bfloat16 rows, each call held and timed) against the group
     route's logits at those bounds; ``bf16_tta``, ``main --only_val
     --model.compute_dtype bfloat16`` on 2 val scans at 2 views a call,
     its launches and TTA scan wall; ``bf16_objects``, shapenet-seg at its
     batch (24) in bfloat16, every bfloat16 call held (K2 over 128 ball
     planes), the logits at those bounds;
 21. bfloat16 training (``run_bf16_train``): the flagship's step at full
     width on a ``compute_dtype: bfloat16`` config, every K7-, K8- and
     K4b-bf16 call held against its plain bfloat16 version and timed
     beside its float32 twin, the step against the plain bf16 and f32
     paths, launches, shapenet-seg at B=24, ``main`` in bfloat16;
 22. data parallelism over processes (``run_dp``): two rank processes
     (``dp_rank``, gloo on the one card) each take the flagship's
     full-width float32 train step on its own sweep (seeds 0 and 1), and
     then the bfloat16 one; every rank's loss, gradients, running
     statistics and parameters after the step bit-identical, rank 0's
     against this process's single step on the B=2 batch of both sweeps
     (loss 1e-5 relative, gradients the JAX package's DP bar or phase
     8's yardstick, statistics 1e-5, the parameters after the Adam step;
     bfloat16: the loss within 2x the single steps' bf16-vs-f32 gap),
     each rank's launches equal to the B=1 spec; a rank's step wall, its
     collectives' own time, the single step's wall and every peak
     memory; then ``main`` in two processes (``distributed.num_processes
     2``, ``CCN_PROCESS_ID``) on nuScenes files: an epoch of 2 steps a
     process, a TTA val scan, process 0's checkpoint, resumed for a
     second epoch (under ``build/phase22``).

Every captured train step (phases 6, 17, 18, 19) counts K7's slope flips
at every site (``k7_flips``, a float64 chain a level at a time): each
flipped element's float64 activation input within ``FLIP_MULT`` 3xTF32
roundings of its BN's scale, the largest such input logged; each BN's
flipped rows under ``FLIP_CAP`` of its live rows up to ``FLIP_CAP_WIDTH``
channels (at every width on a call the float64 fallback holds), a wider
BN's flipped elements under ``FLIP_CAP / FLIP_CAP_WIDTH`` of its live
elements (``check_flips``).  At a BN wider than ``FLIP_CAP_WIDTH`` the
plain float32 version's own flips against float64 are counted beside the
kernel's (``plain_y``), a line each, and listed again before the kernels'
line; no check reads them.

Prints per-phase lines, then a JSON line of the kernels (each with its
launches on every path: nuScenes eval and train, KITTI, the fused routes,
A2D2 and the object configs, the loops, the paths from disk, the options
bfloat16 serving and training, and the data-parallel ranks (summed);
the bfloat16 variants as entries of their own), the
card's name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import copy
import functools
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "nuscenes.yaml")
N_PAD = 36864
SCANS = 2
TRAIN_STEPS = 5
KITTI_CONFIG = os.path.join(REPO, "configs", "kitti.yaml")
KITTI_N_PAD = 131072
# phases 14-15: the version-1.0 configs (their n_pad: 36864 for A2D2, the
# JAX entry's 2048 for the object configs; object batches of their
# batch_size, 24), under their names in launches_by_path
V1_CONFIGS = [("a2d2", "audi"), ("shapenet_seg", "shapenet-seg"),
              ("kortx", "kortx-testsplit"), ("shapenet_class", "shapenet-class")]
V1_SCANS = 2
# phase 16: the eval entry (val scans through main, views a chunk, the
# views-a-call sweep (a warm-up scan and two timed), KITTI's val scans,
# object val scans in batches of 8)
EVAL_N_VAL = 2
EVAL_VIEWS_PER_CALL = 2
SWEEP_SCANS = 3
KITTI_N_VAL = 2
SWEEP_VIEWS = (1, 2, 6)   # 1: the per-view path (tools/tta_walls.py: more)
OBJECT_N_VAL = 16
OBJECT_BATCH = 8
TTA_TOL = 1e-4
OUT16 = os.path.join(REPO, "build", "phase16")
# phase 17: the train paths (label, config, timed with per-site lines)
TRAIN17 = [("train_audi", "audi", True),
           ("train_shapenet_seg", "shapenet-seg", True),
           ("train_kortx", "kortx-testsplit", False),
           ("train_shapenet_class", "shapenet-class", False)]
TRAIN17_STEPS = 3
# the path whose K7 calls are captured again on a second input (seed 1),
# held and their slope flips counted (every path's capture step is)
WITNESS17 = "train_audi"
OUT17 = os.path.join(REPO, "build", "phase17")
# phase 18: the data layer.  Fixture files at real frame sizes in each
# dataset's format (tools/fake_datasets.py) under build/phase18: (path,
# config, frames by split: three train steps at the config's batch_size,
# two val scans (objects: two eval batches of 8), two test frames)
DISK18 = [("disk_nuscenes", "nuscenes", {"train": 18, "val": 2, "test": 2}),
          ("disk_kitti", "kitti", {"train": 6, "val": 2, "test": 2}),
          ("disk_audi", "audi", {"train": 24, "val": 2}),
          ("disk_shapenet_seg", "shapenet-seg", {"train": 72, "val": 16})]
OUT18 = os.path.join(REPO, "build", "phase18")
HOST18_SAMPLES = 4   # samples a reader is timed on, after one warm-up
TELEMETRY18_SCANS = 2
# phase 19: the step options on shapenet-class's model (options_model)
OPTIONS_CONFIG = os.path.join(REPO, "configs", "shapenet-class.yaml")
# step 4's arclength spacing, curve-fps over its 1024-slot row (the FPS
# half of a 2048-point object scan): 0.22 keeps ~25% of the row on seed
# 0's batch (0.2 keeps 27%, 0.3 19%; a CPU count, logged on the card)
OPTIONS_ARCLEN = 0.22
NUSCENES_K1 = "nuscenes_k1"   # nuScenes with step 0's kernel_size 1
# phase 20: bfloat16 serving (the model block's compute_dtype: bfloat16,
# written under build/phase20): the flagship's scans (seeds), the walls
# (scans of each dtype, in turns), the TTA entry's val scans, the object
# config and its batch
OUT20 = os.path.join(REPO, "build", "phase20")
BF16_SEEDS = (0, 1, 2)
BF16_WALL_SCANS = 12
BF16_N_VAL = 2
BF16_OBJECTS = "shapenet-seg"
# bfloat16 logits against the plain path (hold_bf16_logits).  One rounding
# changed anywhere (the float32 K1 of step 0 alone, or K2 alone, in an
# otherwise plain forward) moves ~75% of the flagship's bfloat16 logits by
# an ulp or more (tools/bf16_noise.py, NVIDIA H100): the kernel and plain
# paths are
# two draws of the forward's bfloat16 noise, each within the plain path's
# own bf16-vs-f32 gap of float32, so they differ by up to twice it (the
# triangle bound, the CPU yardstick's factor); the kernel path's mean
# error against the float32 plain path must match the plain bfloat16
# path's (equal to 3 digits on those scans)
BF16_MAX_FACTOR = 2.0
BF16_MEAN_FACTOR = 1.1
# phase 21: bfloat16 training (configs written under build/phase20; main's
# loop under build/phase21): the flagship's train step at full width on
# seeds 0 (held and timed) and 1 (held), the steps that must lower the
# loss, the walls (steps of each dtype, in turns), the object config at its
# batch, main's loop (steps, val scans)
OUT21 = os.path.join(REPO, "build", "phase21")
BF16_TRAIN_SEEDS = (0, 1)
BF16_TRAIN_STEPS = 3
BF16_WALL_STEPS = 3
BF16_LOOP_TRAIN = 2
BF16_LOOP_VAL = 1
# phase 22: data parallelism over processes (build/phase22): ranks on the
# one card (gloo), each rank's deadline a spawn, the timed steps a rank,
# main's run from nuScenes files (train files: 2 steps a rank; val scans)
OUT22 = os.path.join(REPO, "build", "phase22")
DP_WORLD = 2
DP_TIMEOUT = 420.0
DP_WALL_STEPS = 3
DP_LOOP_FILES = {"train": 4, "val": 1}
# the JAX package's own DP bar on gradients (tests/test_train_e2e.py)
DP_GRAD_RTOL, DP_GRAD_ATOL = 5e-2, 1e-5
RESULT_KEYS = {"miou", "per_class_iou", "class_names", "mean_forward_s",
               "points_per_sec", "peak_device_memory_gb", "overflow",
               "scan_wall_s"}
FUSED_V1_TOL = 1e-5   # shapenet-seg's fused route against its group route
RECALL_FLOOR = 0.95  # tests/test_grid_recall.py's floor on curve-sampled rows
LR = 5e-4
LOGIT_TOL = 2e-3  # the full-model bar of the JAX package's parity tests
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# FP32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12   # dense TF32 tensor-core FLOP/s (K2's 3xTF32 floor)
PEAK_BF16 = 989e12   # dense bfloat16 tensor-core FLOP/s

# (name, module, wrapper, plain version, source, Pallas call it replaces,
#  tolerance: max |kernel - plain| / max(1, max |plain|) on float outputs)
EVAL_KERNELS = [
    ("conv1d_chain", "conv1d_chain", "conv1d_chain_eval",
     "conv1d_chain_eval_ref", "curvecloudnet_tpu_torch/csrc/conv1d_chain.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:128", 1e-4),
    ("group_reduce", "group_reduce", "group_reduce", "group_reduce_ref",
     "curvecloudnet_tpu_torch/csrc/group_reduce.cu",
     "curvecloudnet_tpu/ops/pallas_group.py:264", 1e-4),
    ("knn", "knn", "knn_search", "knn_search_ref",
     "curvecloudnet_tpu_torch/csrc/knn.cu",
     "curvecloudnet_tpu/ops/pallas_knn.py:232", 0.0),
    ("fps", "fps", "fps_picks", "fps_picks_ref",
     "curvecloudnet_tpu_torch/csrc/fps.cu",
     "curvecloudnet_tpu/ops/pallas_fps.py:78", 0.0),
    ("gather", "gather", "gather_km", "gather_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:213", 0.0),
]
# the KITTI path adds K5; K10 serves the grid's planes tail
KITTI_KERNELS = EVAL_KERNELS + [
    ("grid_topk", "grid_topk", "grid_topk_records", "grid_topk_records_ref",
     "curvecloudnet_tpu_torch/csrc/grid_topk.cu",
     "curvecloudnet_tpu/ops/pallas_topk.py:254", 0.0)]
TOPK_KERNELS = [
    ("topk_smallest", "grid_topk", "topk_smallest", "topk_smallest_ref",
     "curvecloudnet_tpu_torch/csrc/grid_topk.cu",
     "curvecloudnet_tpu/ops/pallas_topk.py:300", 0.0)]
# K7's tolerances: forward 1e-4 (max abs); backward, in relative L2 norm
# per output, 1e-3 plus 3x the plain version's own change when h1 is
# perturbed by 1e-5 relative (an accumulated rounding of a 1024-long dot
# product is ~2e-6, so the yardstick must move more): act' jumps at 0 and a max picks one of two
# near-equal slots, so rare rows within rounding of such a point take
# another branch in the kernel than in the plain version, moving single
# elements by up to their own size (measured up to 3.9e-3 in L2 at the
# flagship's 519- and 1728-query sites); a K7 output past that bound is
# held against float64 with the kernel's own slopes (see _yardstick and
# _bn_branches: the gradients sum terms that nearly cancel, so the few rows
# whose BN output is within the kernel's rounding of 0 move them: 15 of
# A2D2's ~47k sa-geo rows by ~3e-3 at its attention BN, 45 of 340616 on a
# KITTI sa-geo site by up to 8.9e-3), whose flips from float64's must stay
# under FLIP_CAP of the live rows at every BN.  Each flipped element's
# float64 activation input must lie within FLIP_MULT 3xTF32 roundings
# (TF32X3_EPS, the relative rounding of a 3xTF32 product: the dropped
# lo x lo term is ~2^-22 of it, doubled) of its BN's scale (the largest
# |input| of the BN's live rows): a fault that flipped rows far from 0
# fails this where a count alone would pass (every train capture of
# the smoke measured 4.43 at most, NVIDIA H100)
FLIP_CAP = 1e-3
TF32X3_EPS = 2.0 ** -21
FLIP_MULT = 32
# the row cap was set on BNs up to 512 wide (A2D2's attention BN); a row
# flips where any of its elements does, and the wider BNs of the train
# steps (1024: nuScenes' step-12 site, shapenet-seg's sa-geo attention
# BN) are held on every capture to the share of flipped elements the row
# cap allows a 512-wide BN, FLIP_CAP / FLIP_CAP_WIDTH, and to the row cap
# where the float64 fallback holds a call (_bn_branches), as before
FLIP_CAP_WIDTH = 512


TRAIN_KERNELS = [
    # K8: forward z 1e-4 and its statistics 1e-5 (of max(1, |plain|));
    # reduce and t passes K7's backward yardstick, z perturbed
    ("conv1d_train_fwd", "conv1d_train", "conv1d_train_fwd_layer",
     "conv1d_train_fwd_layer_ref",
     "curvecloudnet_tpu_torch/csrc/conv1d_train.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:407", 1e-4),
    ("conv1d_train_reduce", "conv1d_train", "conv1d_train_bwd_reduce",
     "conv1d_train_bwd_reduce_ref",
     "curvecloudnet_tpu_torch/csrc/conv1d_train.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:431", 1e-3),
    ("conv1d_train_t", "conv1d_train", "conv1d_train_bwd_t",
     "conv1d_train_bwd_t_ref", "curvecloudnet_tpu_torch/csrc/conv1d_train.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:477", 1e-3),
    ("group_train_fwd", "group_train", "group_train_fwd",
     "group_train_fwd_ref", "curvecloudnet_tpu_torch/csrc/group_train.cu",
     "curvecloudnet_tpu/ops/pallas_group_train.py:591", 1e-4),
    ("group_train_bwd", "group_train", "group_train_bwd",
     "group_train_bwd_ref", "curvecloudnet_tpu_torch/csrc/group_train.cu",
     "curvecloudnet_tpu/ops/pallas_group_train.py:591", 1e-3),
    ("gather", "gather", "gather_km", "gather_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:213", 0.0),
    ("scatter", "gather", "scatter_km", "scatter_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:237", 1e-5),
]
# K3 and K6 in the train capture (phase 6), held as in phase 3
TRAIN_HELD = [k for k in EVAL_KERNELS if k[0] in ("knn", "fps")]
# the plain chain that phase 8's plain path takes for K8 (torch autograd)
PLAIN_CHAINS = [("conv1d_chain_train", "conv1d_train", "conv1d_chain_train",
                 "conv1d_chain_train_ref")]
# the kernels of the train path counted in phase 7 (the seven above, K3, K6)
TRAIN_COUNTED = [("conv1d_train_fwd", "conv1d_train", "conv1d_train_fwd_layer"),
                 ("conv1d_train_reduce", "conv1d_train",
                  "conv1d_train_bwd_reduce"),
                 ("conv1d_train_t", "conv1d_train", "conv1d_train_bwd_t"),
                 ("group_train_fwd", "group_train", "group_train_fwd"),
                 ("group_train_bwd", "group_train", "group_train_bwd"),
                 ("gather", "gather", "gather_km"),
                 ("scatter", "gather", "scatter_km"),
                 ("knn", "knn", "knn_search"), ("fps", "fps", "fps_picks")]
# phase 17: KITTI's train capture adds K5; main's epoch loops count the
# train and the eval wrappers (each wrapper once)
GRID_HELD = [k for k in KITTI_KERNELS if k[0] == "grid_topk"]
LOOP_COUNTED = TRAIN_COUNTED + [
    ("conv1d_chain", "conv1d_chain", "conv1d_chain_eval"),
    ("group_reduce", "group_reduce", "group_reduce"),
    ("grid_topk", "grid_topk", "grid_topk_records")]
# phases 14-15: no K1 (conv1d-fast-v1 is plain torch in both packages)
V1_KERNELS = [k for k in EVAL_KERNELS if k[0] != "conv1d_chain"]
# phase 13: K9 on the fused edge route
EDGE_KERNELS = [
    ("edge_mlp", "edge_mlp", "fused_edge_mlp_max", "fused_edge_mlp_max_ref",
     "curvecloudnet_tpu_torch/csrc/edge_mlp.cu",
     "curvecloudnet_tpu/ops/pallas_edge.py:85", 1e-4)]
# phase 20: the bfloat16 variants (compute_dtype: bfloat16).  K1's output
# is bfloat16, where a sum-order difference flips a rounding now and then:
# its tolerance is in bfloat16 ulps at max(1, max |plain|), under
# BF16_FLIP_SHARE of the elements differing at all (compare); K2's output
# is float32, its inter-layer roundings bounded by 2^-8 of that scale; K4
# copies; K9 computes in float32 on the widened rows, as in float32
BF16_FLIP_SHARE = 0.01
BF16_KERNELS = [
    ("conv1d_chain_bf16", "conv1d_chain", "conv1d_chain_eval_bf16",
     "conv1d_chain_eval_ref", "curvecloudnet_tpu_torch/csrc/conv1d_chain.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:128", 1.0),
    ("group_reduce_bf16", "group_reduce", "group_reduce_bf16",
     "group_reduce_ref", "curvecloudnet_tpu_torch/csrc/group_reduce.cu",
     "curvecloudnet_tpu/ops/pallas_group.py:264", 2.0 ** -8),
    ("gather_bf16", "gather", "gather_km_bf16", "gather_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:213", 0.0)]
EDGE_BF16_KERNELS = [
    ("edge_mlp_bf16", "edge_mlp", "fused_edge_mlp_max_bf16",
     "fused_edge_mlp_max_ref", "curvecloudnet_tpu_torch/csrc/edge_mlp.cu",
     "curvecloudnet_tpu/ops/pallas_edge.py:85", 1e-4)]
# phase 21: the bfloat16 train kernels.  Kernel and plain version round at
# the same points (bfloat16 operands, f32 products and sums), so they
# differ by the order of the f32 sums, which now and then flips a
# bfloat16 rounding of an operand (T between K7's backward levels, a
# layer input u, a pair sum) and, rarely, an activation's slope: the
# forward outputs and statistics within 2^-8 (one bfloat16 rounding) of
# the output's largest value; the backward outputs within 2^-7 in
# relative L2 norm plus twice the plain version's own bf16-vs-f32 change
# (norms floored at 2^-8 of the call's largest): a gradient that is 0 in
# exact arithmetic (a bias feeding a BatchNorm) is the sum of K7's
# bfloat16 roundings of T, so one flipped rounding moves it by a share of
# its size (3.3% on a card test of an sa-geo-like site); K4b's sums
# within 2^-8 of the largest (f32 sums, one rounding, atomics in any
# order)
BF16_TRAIN_KERNELS = [
    ("conv1d_train_fwd_bf16", "conv1d_train", "conv1d_train_fwd_layer_bf16",
     "conv1d_train_fwd_layer_ref",
     "curvecloudnet_tpu_torch/csrc/conv1d_train.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:407", 2.0 ** -8),
    ("conv1d_train_t_bf16", "conv1d_train", "conv1d_train_bwd_t_bf16",
     "conv1d_train_bwd_t_ref", "curvecloudnet_tpu_torch/csrc/conv1d_train.cu",
     "curvecloudnet_tpu/ops/pallas_conv1d.py:477", 2.0 ** -7),
    ("group_train_fwd_bf16", "group_train", "group_train_fwd_bf16",
     "group_train_fwd_ref", "curvecloudnet_tpu_torch/csrc/group_train.cu",
     "curvecloudnet_tpu/ops/pallas_group_train.py:591", 2.0 ** -8),
    ("group_train_bwd_bf16", "group_train", "group_train_bwd_bf16",
     "group_train_bwd_ref", "curvecloudnet_tpu_torch/csrc/group_train.cu",
     "curvecloudnet_tpu/ops/pallas_group_train.py:591", 2.0 ** -7),
    ("scatter_bf16", "gather", "scatter_km_bf16", "scatter_km_ref",
     "curvecloudnet_tpu_torch/csrc/gather.cu",
     "curvecloudnet_tpu/ops/pallas_gather.py:237", 2.0 ** -8)]
# the bfloat16 wrappers a train step or main's loop counts beside the
# float32 ones (check_bf16_launches adds each to its twin)
BF16_COUNTED = [(name, mod, wrapper) for name, mod, wrapper, *_ in
                BF16_TRAIN_KERNELS] + [
    ("gather_bf16", "gather", "gather_km_bf16"),
    ("conv1d_chain_bf16", "conv1d_chain", "conv1d_chain_eval_bf16"),
    ("group_reduce_bf16", "group_reduce", "group_reduce_bf16")]
# the operations' peak rate of each kernel's bound (FP32 where not listed)
OPS_PEAK = {"conv1d_chain_bf16": PEAK_BF16, "group_reduce_bf16": PEAK_BF16,
            "conv1d_train_fwd_bf16": PEAK_BF16,
            "conv1d_train_t_bf16": PEAK_BF16,
            "group_train_fwd_bf16": PEAK_BF16,
            "group_train_bwd_bf16": PEAK_BF16}


def options_model(model_cfg, arclen=OPTIONS_ARCLEN):
    """shapenet-class's ``model`` block with phase 19's substitutions (its
    steps counted in the shipped list): a dgcnn-rad step prepended (the
    JAX package admits it only as step 0; radius sa-geo's), step 0 sa-geo
    on FPS (ratio 0.5), step 4 sa on curve-fps with a one-layer MLP, step
    7 sa random, step 10 sa mean, step 5 sgcnn a dgcnn (k 30, in the skip
    store as the sgcnn was), step 8 weighted-sum, step 11 sgcnn in the
    fast order with attend, head dropout 0.5."""
    mc = copy.deepcopy(model_cfg)
    steps = mc["steps"]
    steps[0].update(use_curve_fps=False, ratio=0.5)
    steps[4].update(downsample_type="curve-fps", curve_fps_arclen=arclen,
                    feat_dims=steps[4]["feat_dims"][:1])
    steps[5].update(step_name="dgcnn", knn=30)
    steps[7]["downsample_type"] = "random"
    steps[8]["aggr_type"] = "weighted-sum"
    steps[10]["aggr_type"] = "mean"
    steps[11].update(use_sparse_feat_agg=False, aggr_type="attend")
    mc["steps"] = [dict(step_name="dgcnn-rad", with_xyz=True,
                        radius=steps[0]["radius"], feat_dims=[64, 64])] + steps
    mc["skip_connect_state_store"] = (list(mc["skip_connect_state_store"])
                                      + ["dgcnn"])
    mc["out_mlp"]["dropout"] = 0.5
    return mc


def log(*parts):
    print(*parts, flush=True)


def stamp(t_start, phases):
    """The smoke's elapsed seconds at the end of ``phases``."""
    log(f"chip_smoke: phases {phases} done at "
        f"{time.perf_counter() - t_start:.1f} s")


@contextlib.contextmanager
def replaced(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


# a timed run longer than this ends the timing of its call (a plain FPS
# on a 23040-point row takes ~1.3 s: its spread between runs is far below
# what comparing it with its kernel needs)
ONE_RUN_MS = 200.0


def cuda_ms(fn, reps=3):
    """Median milliseconds of ``fn()`` on the current stream over ``reps``
    runs after a warm-up run, or the first run's past ``ONE_RUN_MS``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        if times[0] > ONE_RUN_MS:
            break
    return sorted(times)[len(times) // 2]


def bf16_ulp(scale):
    """One bfloat16 ulp (8 significant bits) at ``scale``."""
    import math

    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _err(name, out, ref, tol, rows=None):
    """Max abs error of a float output, raising past ``tol`` relative to
    max(1, max |ref|)."""
    import torch

    if rows is not None:
        out, ref = out[rows], ref[rows]
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    if not bool(torch.isfinite(out).all()) or err / scale > tol:
        raise AssertionError(f"{name}: max abs err {err} (scale {scale})")
    return err


def compare(name, out, ref, tol):
    """Max abs error of kernel vs plain, raising past the tolerance.
    knn: indices equal except between slots of equal distance; fps, gather,
    grid_topk, topk_smallest: equal."""
    import torch

    if name == "knn":
        (i_k, d_k), (i_r, d_r) = out, ref
        err = float((d_k - d_r).abs().max())
        swap = (i_k != i_r) & (d_k != d_r)
        if i_k.shape[-1] > 32:   # ball queries: indices equal, ties too
            swap = i_k != i_r
        if err > tol or bool(swap.any()):
            raise AssertionError(f"knn: dist err {err}, "
                                 f"{int(swap.sum())} index mismatches")
        return err
    if name in ("grid_topk", "topk_smallest"):
        (d_k, i_k), (d_r, i_r) = out, ref
        if not (torch.equal(d_k, d_r) and torch.equal(i_k, i_r)):
            raise AssertionError(f"{name}: differs from its plain version "
                                 f"({int((i_k != i_r).sum())} indices)")
        return 0.0
    if name in ("edge_mlp", "edge_mlp_bf16"):
        # MAX_FILL (-100) is exact in both; scale by the other values
        rest = ref[ref != -100.0]
        err = float((out - ref).abs().max())
        scale = max(1.0, float(rest.abs().max())) if rest.numel() else 1.0
        if not bool(torch.isfinite(out).all()) or err / scale > tol:
            raise AssertionError(f"{name}: max abs err {err} (scale {scale})")
        return err
    if name == "conv1d_chain_bf16":
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        scale = max(1.0, float(ref.float().abs().max()))
        share = float((diff > 0).float().mean())
        if (not bool(torch.isfinite(out).all())
                or err > tol * bf16_ulp(scale) or share > BF16_FLIP_SHARE):
            raise AssertionError(
                f"{name}: max abs err {err} ({err / bf16_ulp(scale):.3g} "
                f"bfloat16 ulps at scale {scale}), {share:.3g} of the "
                f"elements differ")
        return err
    if name == "fps":
        err = float((out.long() - ref.long()).abs().max())
        if err > tol:
            raise AssertionError(f"fps: picks differ (max |diff| {err})")
        return err
    return _err(name, out, ref, tol)


def _rows(mask):
    """Query rows with at least one neighbor (fully masked rows carry junk
    by contract)."""
    return mask.any(-1)


def _shaken(t, seed=7):
    """t perturbed by 1e-5 relative noise."""
    import torch

    g = torch.Generator(device=t.device).manual_seed(seed)
    return t * (1 + 1e-5 * torch.randn(t.shape, generator=g, device=t.device))


def _yardstick(name, outs, tol, what, exact=None):
    """Backward outputs [(kernel, plain, plain under a 1e-5 perturbation of
    an input)]: each within ``tol`` in relative L2 norm plus 3x the plain
    version's own change; norms floored at 1e-3 of the call's largest (for
    outputs that are zero in exact arithmetic).  ``exact``: (indices, fn)
    for a K7 call's outputs, which sum terms that nearly cancel (each BN
    re-centres what flows back through it; a softmax's weights sum to
    one), so the rare rows that take another leaky-ReLU slope in the kernel
    than in the plain version can move them past a perturbation's change;
    where one of them is past its bound, ``fn()`` gives the outputs in
    float64 (with the kernel's slopes and with float64's own,
    :func:`_bn_branches`, which holds the rows that flip) and it is held
    against float64 with the kernel's slopes instead, within ``tol`` plus
    3x the larger of the float32 plain version's own error against
    float64 and its perturbation change.  Returns the max abs err."""
    import torch

    floor = 1e-3 * max(float(want.norm()) for _, want, _ in outs)
    err = worst = 0.0
    indices, exact_fn = exact or ((), None)
    exact_outs = None
    for i, (got, want, shaken) in enumerate(outs):
        scale = max(float(want.norm()), floor)
        rel = float((got - want).norm()) / scale
        moved = float((shaken - want).norm()) / scale
        bound = tol + 3 * moved
        if bool(torch.isfinite(got).all()) and rel > bound and i in indices:
            if exact_outs is None:
                exact_outs = exact_fn()
            j = indices.index(i)
            ex, own_ex = exact_outs[0][j], exact_outs[1][j]
            rel = float((got.double() - ex).norm()) / scale
            own = float((want.double() - own_ex).norm()) / scale
            bound = tol + 3 * max(own, moved)
            log(f"  {name}: output {i} against float64: kernel err {rel:.3g},"
                f" float32 plain err {own:.3g}, bound {bound:.3g}")
        if not bool(torch.isfinite(got).all()) or rel > bound:
            raise AssertionError(f"{name}: output {i} ({what}) relative L2 "
                                 f"err {rel} > {bound}")
        err = max(err, float((got - want).abs().max()))
        worst = max(worst, rel / bound)
    log(f"  {name}: relative L2 errors within {worst:.3g} of their bounds")
    return err


def compare_train(name, args, kwargs, kern_out, ref_fn, tol):
    """Kernel outputs of a recorded train call against its plain version
    (a K8 t pass's fused reduce sums are held by :func:`k8_sums`).
    Returns (max abs err, plain callable for timing)."""
    import torch

    from curvecloudnet_tpu_torch.ops import group_train as G

    if name.endswith("_bf16"):
        return compare_bf16_train(name, args, kwargs, kern_out, ref_fn, tol)
    if name == "conv1d_train_fwd":
        ref = ref_fn(*args)
        errs = (_err(name, kern_out[0], ref[0], tol),
                _err(name + " mean", kern_out[1], ref[1], 1e-5),
                _err(name + " var", kern_out[2], ref[2], 1e-5))
        log(f"  {name}: z err {errs[0]:.3g}, mean err {errs[1]:.3g}, "
            f"var err {errs[2]:.3g}")
        return max(errs), lambda: ref_fn(*args)
    if name in ("conv1d_train_reduce", "conv1d_train_t"):
        # the reduce pass's four sums; the t pass's d_u_prev, dW, db
        shaken = ref_fn(args[0], _shaken(args[1]), *args[2:])
        err = _yardstick(name, list(zip(kern_out, ref_fn(*args), shaken)),
                         tol, "in the pass's output order")
        return err, lambda: ref_fn(*args, **kwargs)
    if name == "group_train_fwd":
        h1, mask, cfg, params = args
        ref = ref_fn(*args)
        rows = _rows(mask)
        err = _err(name, kern_out[0], ref[0], tol, rows)
        for (mu, var), (r_mu, r_var) in zip(kern_out[1], ref[1]):
            err = max(err, _err(name + " mean", mu, r_mu, tol),
                      _err(name + " var", var, r_var, tol))
        return err, lambda: ref_fn(*args)
    if name == "group_train_bwd":
        h1, mask, cfg, params, stats, n, extras, dout = args
        # the plain backward with the plain forward's own residuals (a max
        # aggregation's ties are exact equalities of recomputed values)
        _, r_stats, r_n, r_extras = G.group_train_fwd_ref(h1, mask, cfg,
                                                         params)
        r_args = (h1, mask, cfg, params, r_stats, r_n, r_extras, dout)
        d_h1, grads = ref_fn(*r_args)
        h1_s = _shaken(h1)
        _, s_stats, s_n, s_extras = G.group_train_fwd_ref(h1_s, mask, cfg,
                                                         params)
        s_h1, s_grads = ref_fn(h1_s, mask, cfg, params, s_stats, s_n,
                               s_extras, dout)
        outs = list(zip((kern_out[0],) + tuple(kern_out[1]),
                        (d_h1,) + tuple(grads), (s_h1,) + tuple(s_grads)))
        exact = None
        if extras[0].dtype == torch.int32:
            # the kernel's residuals: every output may be held against
            # float64 with the kernel's slopes
            exact = (tuple(range(len(outs))),
                     lambda: _bn_branches(*args))
        err = _yardstick(name, outs, tol, "0: d_h1, then the params' "
                         "gradients", exact)
        return err, lambda: ref_fn(*r_args)
    ref = ref_fn(*args)
    return _err(name, kern_out, ref, tol), lambda: ref_fn(*args)


def _bf16_max(name, got, want, tol):
    """Max abs error of a float output within ``tol`` of max |want|."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    return err


def _bf16_l2(name, outs, tol):
    """Backward outputs [(kernel, plain bf16, plain f32)] each within
    ``tol`` plus twice the plain versions' own bf16-vs-f32 change, in
    relative L2 norm, norms floored at 2^-8 of the call's largest -> max
    abs err."""
    import torch

    outs = [(g.float(), w.float(), w32.float()) for g, w, w32 in outs]
    floor = 2.0 ** -8 * max(float(w.norm()) for _, w, _ in outs)
    err = worst = 0.0
    for i, (got, want, w32) in enumerate(outs):
        scale = max(float(want.norm()), floor)
        rel = float((got - want).norm()) / scale
        bound = tol + 2 * float((want - w32).norm()) / scale
        if not bool(torch.isfinite(got).all()) or rel > bound:
            raise AssertionError(f"{name}: output {i} relative L2 err {rel} "
                                 f"> {bound}")
        worst = max(worst, rel / bound)
        err = max(err, float((got - want).abs().max()))
    log(f"  {name}: relative L2 errors within {worst:.3g} of their bounds")
    return err


def compare_bf16_train(name, args, kwargs, out, ref_fn, tol):
    """A bfloat16 train kernel's recorded call against its plain version
    under the bfloat16 contract -> (max abs err, plain callable)."""
    from curvecloudnet_tpu_torch.ops import group_train as G

    base = name.removesuffix("_bf16")
    kw = dict(kwargs, bf16=True) if base.startswith("conv1d") else kwargs
    if base == "group_train_bwd":
        # the plain backward with the plain forward's own residuals
        h1, mask, cfg, params, _, _, _, dout = args
        _, r_stats, r_n, r_extras = G.group_train_fwd_ref(h1, mask, cfg,
                                                         params)
        r_args = (h1, mask, cfg, params, r_stats, r_n, r_extras, dout)
        d_h1, grads = ref_fn(*r_args)
        h32 = h1.float()
        _, s32, n32, e32 = G.group_train_fwd_ref(h32, mask, cfg, params)
        f_h1, f_grads = ref_fn(h32, mask, cfg, params, s32, n32, e32, dout)
        err = _bf16_l2(name, list(zip((out[0],) + tuple(out[1]),
                                      (d_h1,) + tuple(grads),
                                      (f_h1,) + tuple(f_grads))), tol)
        return err, lambda: ref_fn(*r_args)
    want = ref_fn(*args, **kw)
    if base == "conv1d_train_fwd":
        err = max(_bf16_max(name, out[0], want[0], tol),
                  _bf16_max(name + " mean", out[1], want[1], tol),
                  _bf16_max(name + " var", out[2], want[2], tol))
    elif base == "conv1d_train_t":
        w32 = ref_fn(*args[:2], args[2].float(), *args[3:], **kwargs)
        pairs = list(zip(out[:3], want[:3], w32[:3]))
        if len(out) == 4:   # the previous layer's reduce sums
            pairs += list(zip(out[3], want[3], w32[3]))
        err = _bf16_l2(name, pairs, tol)
    elif base == "group_train_fwd":
        rows = _rows(args[1])
        err = _bf16_max(name, out[0][rows], want[0][rows], tol)
        for (mu, var), (r_mu, r_var) in zip(out[1], want[1]):
            err = max(err, _bf16_max(name + " mean", mu, r_mu, tol),
                      _bf16_max(name + " var", var, r_var, tol))
    else:   # scatter: f32 sums rounded once
        err = _bf16_max(name, out, want, tol)
    return err, lambda: ref_fn(*args, **kw)


def _kernel_y(h1, cfg, params, stats, extras, i, lo=0, hi=None):
    """A K7 call's activation input at BN ``i`` on its live rows
    ``lo:hi``, from the kernel's stored values, statistics and inverse
    deviations, in float64; BN ``cfg.n_loc`` is the attention BN."""
    from curvecloudnet_tpu_torch.ops import group_train as G

    L = cfg.n_loc
    if i == 0:
        v = h1.reshape(-1, h1.shape[-1])[extras[0].long()[lo:hi]]
    else:
        v = extras[5 + (i - 1 if i < L else L)][lo:hi]
    g, bt = params[4 * i:4 * i + 2] if i < L else G._att(cfg, params)[2:4]
    inv = extras[5 + L + 2 * cfg.attend + i]
    return ((v.double() - stats[i][0].double()) * inv.double()
            * g.double() + bt.double())


def _bn_branches(h1, mask, cfg, params, stats, n, extras, dout):
    """A K7 call's backward (its recorded arguments) in float64, once with
    every BN's act' taken at the kernel's activation inputs on the live
    rows (:func:`_kernel_y`) and once at float64's own -> (kernel-branch
    outputs, float64 outputs: d_h1, then the parameters' gradients).  A
    row whose activation input lies within the kernel's rounding of 0
    takes the other slope of the leaky ReLU there, and the gradients sum
    terms that nearly cancel (each BN re-centres what flows back through
    it, a softmax's weights sum to one), so a few such rows move them by
    ~5e-3 of their norm; a call held this way keeps its flipped rows under
    ``FLIP_CAP`` of the live rows at every BN, whatever its width
    (:func:`check_flips`)."""
    import torch

    from curvecloudnet_tpu_torch.ops import group_train as G

    L = cfg.n_loc
    d = [h1.double()] + [p.double() for p in params]
    _, e_stats, e_n, e_extras = G.group_train_fwd_ref(d[0], mask, cfg, d[1:])
    rows = extras[0].long()
    # the backward asks for act' at the attention BN, then levels L-1..0
    levels = iter(([L] if cfg.attend else []) + list(reversed(range(L))))
    own = G._dact

    def kernel_slopes(y, kind):
        i = next(levels)
        k = own(y, kind)
        if kind != "identity":       # one slope: nothing flips
            # a fresh tensor: set in place
            k.view(-1, y.shape[-1])[rows] = own(
                _kernel_y(h1, cfg, params, stats, extras, i), kind)
        return k

    bwd = (d[0], mask, cfg, d[1:], e_stats, e_n, e_extras, dout.double())
    # each float64 backward of a wide site takes ~30 GB: hand the cached
    # blocks the recorded step left free back before each
    torch.cuda.empty_cache()
    e_h1, e_grads = G.group_train_bwd_ref(*bwd)
    torch.cuda.empty_cache()
    with replaced(G, "_dact", kernel_slopes):
        k_h1, k_grads = G.group_train_bwd_ref(*bwd)
    scan = _flip_scan(h1, mask, cfg, params, stats, n, extras)
    log(f"  group_train_bwd: live rows that take another slope in the "
        f"kernel than in float64, by BN: "
        f"{ {i: f[0] for i, f in scan.items()} } of {rows.numel()}")
    check_flips("group_train_bwd", cfg, scan, rows.numel(), every_width=True)
    return [k_h1, *k_grads], [e_h1, *e_grads]


# rows a chunk of the float64 slope scan (its temporaries ~2^28 bytes)
FLIP_CHUNK_BYTES = 2 ** 28


def _flip_scan(h1, mask, cfg, params, stats, n, extras, dout=None,
               against=None):
    """A K7 call's slope flips, chunked over its live rows in float64: the
    chain's activation inputs at every BN in float64 (its own batch
    statistics: E[x^2] - mean^2 over the live rows, as the kernel's)
    against the kernel's (:func:`_kernel_y`; ``against(i, lo, hi)``: other
    activation inputs of BN i's live rows lo:hi) -> {BN: (flipped rows,
    flipped elements, largest flipped |input|, it in 3xTF32 roundings of
    the BN's scale)}, BN ``cfg.n_loc`` the attention BN.  One level a
    time: the widest sites (shapenet-seg's sa-geo, 1024 wide) fit the card
    where the whole float64 slab would not."""
    import torch

    from curvecloudnet_tpu_torch.ops import group_train as G

    L = cfg.n_loc
    rows = extras[0].long()
    v = h1.reshape(-1, h1.shape[-1])[rows].double()
    nrow = rows.numel()
    out = {}
    for i in range(L + int(cfg.attend)):
        if i < L:
            g, bt, w, b = (t.double() for t in params[4 * i:4 * i + 4])
            kind = cfg.act
        else:
            wa0, ba0, g, bt = (t.double() for t in G._att(cfg, params)[:4])
            kind = cfg.attend_act
            v = v @ wa0 + ba0
        mu = v.mean(0)
        inv = torch.rsqrt(torch.clamp((v * v).mean(0) - mu * mu, min=0.0)
                          + cfg.eps)
        chunk = max(1, FLIP_CHUNK_BYTES // (8 * max(v.shape[1], 1) * 4))
        flips, elems, scale, worst = 0, 0, 0.0, 0.0
        nxt = v.new_empty((nrow, w.shape[1])) if i < L else None
        for lo in range(0, nrow, chunk):
            y = (v[lo:lo + chunk] - mu) * inv * g + bt
            yk = (against(i, lo, lo + chunk) if against is not None else
                  _kernel_y(h1, cfg, params, stats, extras, i, lo,
                            lo + chunk))
            flipped = (y > 0) != (yk > 0)
            flips += int(flipped.any(-1).sum())
            elems += int(flipped.sum())
            scale = max(scale, float(y.abs().max()))
            if bool(flipped.any()):
                worst = max(worst, float(y[flipped].abs().max()))
            if i < L:
                nxt[lo:lo + chunk] = G._act(y, kind) @ w + b
            del y, yk, flipped
        out[i] = (flips, elems, worst,
                  worst / (TF32X3_EPS * scale) if scale else 0.0)
        if i < L:
            v, nxt = nxt, None
    return out


def check_flips(what, cfg, scan, n_rows, every_width=False):
    """Hold a K7 call's slope flips (:func:`_flip_scan`) over its
    ``n_rows`` live rows, at every BN: each flipped element's float64
    input within ``FLIP_MULT`` 3xTF32 roundings of its BN's scale; the
    flipped rows under ``FLIP_CAP`` of the live rows at a BN up to
    ``FLIP_CAP_WIDTH`` channels wide (at every width with
    ``every_width``); a wider BN's flipped elements under
    ``FLIP_CAP / FLIP_CAP_WIDTH`` of its live elements."""
    for i, (rows, elems, _, mult) in scan.items():
        width = cfg.dims[i] if i < cfg.n_loc else cfg.att_dim
        if mult > FLIP_MULT:
            raise AssertionError(
                f"{what} BN {i}: a flipped element's float64 input is "
                f"{mult:.3g} 3xTF32 roundings of the BN's scale (bound "
                f"{FLIP_MULT})")
        if (every_width or width <= FLIP_CAP_WIDTH) and (
                rows > FLIP_CAP * n_rows):
            raise AssertionError(
                f"{what} BN {i} ({width} wide): {rows} of {n_rows} live "
                f"rows flip slope (cap {FLIP_CAP:g})")
        if width > FLIP_CAP_WIDTH and (
                elems > FLIP_CAP / FLIP_CAP_WIDTH * n_rows * width):
            raise AssertionError(
                f"{what} BN {i} ({width} wide): {elems} of {n_rows} x "
                f"{width} live elements flip slope (cap "
                f"{FLIP_CAP / FLIP_CAP_WIDTH:.3g})")


def plain_y(args):
    """The plain float32 version's activation inputs at every BN of a K7
    call (``group_train._chain_ref``, its own float32 batch statistics) on
    the call's live rows -> {BN: (live rows, width)}, BN ``cfg.n_loc`` the
    attention BN."""
    import torch

    from curvecloudnet_tpu_torch.ops import group_train as G

    h1, mask, cfg, params = args[:4]
    rows = args[6][0].long()
    ys = {}
    bn = G._bn

    def record(v, mu, var, g, b, eps):
        xhat, y = bn(v, mu, var, g, b, eps)
        ys[len(ys)] = y.reshape(-1, y.shape[-1])[rows]
        return xhat, y

    n = torch.clamp(mask.sum().to(h1.dtype), min=1.0)
    with replaced(G, "_bn", record):
        G._chain_ref(h1, G._plane_mask(mask, h1.dtype), n, cfg, params)
    return ys


# the plain float32 version's own slope flips at BNs wider than
# FLIP_CAP_WIDTH, one entry a BN: (label, site, BN, width, live rows,
# plain rows, plain elements, kernel rows, kernel elements)
PLAIN_FLIPS = []


def k7_flips(label, calls):
    """The slope flips of every K7 site of a captured step
    (:func:`_flip_scan`), a line for each BN that has any, each site held
    by :func:`check_flips` once all are logged.  At a BN wider than
    ``FLIP_CAP_WIDTH`` the plain float32 version's own flips against
    float64 (:func:`plain_y`) are counted too, a line each (kept in
    ``PLAIN_FLIPS``; no check reads them)."""
    import torch

    total = att = live = sites = 0
    worst = (0.0, 0.0)
    scans = []
    with torch.no_grad():
        for site, (args, _, _) in enumerate(calls["group_train_bwd"]):
            cfg, extras = args[2], args[6]
            if extras[0].dtype != torch.int32:   # not the kernel's residuals
                continue
            n_rows = extras[0].numel()
            scan = _flip_scan(*args)
            for i, (f, e, big, mult) in scan.items():
                width = cfg.dims[i] if i < cfg.n_loc else cfg.att_dim
                if f:
                    log(f"  {label} K7 call {site} BN {i} ({width} wide): {f} "
                        f"of {n_rows} live rows flip ({e} elements), largest "
                        f"flipped input {big:.3g}, {mult:.3g} 3xTF32 "
                        f"roundings of its scale")
                total += f
                att += f if (cfg.attend and i == cfg.n_loc) else 0
                worst = max(worst, (mult, big))
            scans.append((site, cfg, scan, n_rows))
            live, sites = live + n_rows, sites + 1
            wide = [i for i in scan if (cfg.dims[i] if i < cfg.n_loc
                                        else cfg.att_dim) > FLIP_CAP_WIDTH]
            if wide:
                ys = plain_y(args)
                torch.cuda.empty_cache()
                plain = _flip_scan(*args, against=lambda i, lo, hi:
                                   ys[i][lo:hi].double())
                del ys
                for i in wide:
                    width = cfg.dims[i] if i < cfg.n_loc else cfg.att_dim
                    entry = (label, site, i, width, n_rows, *plain[i][:2],
                             *scan[i][:2])
                    PLAIN_FLIPS.append(entry)
                    log(f"  {label} K7 call {site} BN {i} ({width} wide): "
                        f"the plain float32 version flips {plain[i][0]} of "
                        f"{n_rows} live rows ({plain[i][1]} elements) "
                        f"against float64; the kernel {scan[i][0]} "
                        f"({scan[i][1]})")
            torch.cuda.empty_cache()
    log(f"{label} K7 slope flips at {sites} sites: {total} rows at all BNs "
        f"({att} at the attention BNs) of {live} live rows; largest flipped "
        f"float64 input {worst[1]:.3g}, {worst[0]:.3g} 3xTF32 roundings of "
        f"its BN's scale (bound {FLIP_MULT})")
    for site, cfg, scan, n_rows in scans:
        check_flips(f"{label} K7 call {site}", cfg, scan, n_rows)


def work(name, args, out):
    """(bytes, flops) the function must move and do on this call's
    inputs: each input read once, each output written once; data-dependent
    work (masked rows, valid points) counted for this call's data.  A
    bfloat16 variant does its float32 twin's operations on its own bytes."""
    import torch

    name = name.removesuffix("_bf16")

    def nbytes(*ts):
        total = 0
        for t in ts:
            if torch.is_tensor(t):
                total += t.numel() * t.element_size()
            elif isinstance(t, (tuple, list)):
                total += nbytes(*t)
        return total

    if name == "conv1d_chain":
        xe, weights, used, h = args
        rows = int(used.sum())
        flops = sum(2 * rows * w.shape[0] * w.shape[1] for w, _ in weights)
        return nbytes(xe, weights, used, out), flops
    if name == "group_reduce":
        h1, mask, aff, local, att = args[:5]
        rows = int(mask.sum())
        macs = sum(w.shape[0] * w.shape[1] for w, _ in tuple(local) +
                   tuple(att or ()))
        return nbytes(h1, mask, aff, local, att, out), 2 * rows * macs
    if name == "knn":
        # 8 FP32 operations (3 sub, 3 mul, 2 add) a pair of a valid query
        # and a valid point in a tile any exact search must open
        return nbytes(*args[:4], out), 8 * knn_needed_pairs(*args, out[0])
    if name == "fps":
        # 9 FP32 operations a valid point a round (3 sub, 3 mul, 2 add, one
        # min); a round a pick until every valid point of the row is picked
        pos, valid, start, budget = args
        v = valid.sum(-1)
        return (nbytes(pos, valid, start, out),
                9 * int((v.clamp(max=budget) * v).sum()))
    if name in ("gather", "scatter"):
        return nbytes(*args[:2], out), 0
    if name == "grid_topk":
        # the table's live records only (each row's prefix of ``counts``
        # 16-byte records; the padding past it is never read); 8 FP32
        # operations (3 sub, 3 mul, 2 add) per live candidate of a valid
        # query
        table, counts, nbr, query, q_valid = args[:5]
        records = int(counts.sum()) * table.shape[2] * table.element_size()
        live = int(counts[nbr.long()].sum(1)[q_valid].sum())
        return (records + nbytes(counts, nbr, query, q_valid, out),
                8 * live)
    if name == "topk_smallest":
        # all of d; idx only at the k chosen columns a row (no other idx
        # is needed); one compare per value
        d, idx, k = args[:3]
        return (nbytes(d, out) + d.shape[0] * k * idx.element_size(),
                d.numel())
    if name == "conv1d_train_fwd":
        # the window product at every slot (z is written past ``used`` too)
        z_prev, w = args[0], args[2]
        rows = z_prev.shape[0] * z_prev.shape[1]
        return nbytes(args[:5], out), 2 * rows * w.shape[0] * w.shape[1]
    if name == "conv1d_train_reduce":
        # ~10 FP32 operations per element (affine, kink, four sums)
        return nbytes(args[:4], out), 10 * args[1].numel()
    if name == "conv1d_train_t":
        # the transposed window product and the weight gradient (and, with
        # the previous layer's reduce sums as a fourth output, ~10 FP32
        # operations per element of d_u_prev)
        z_prev, w = args[2], args[5]
        rows = z_prev.shape[0] * z_prev.shape[1]
        sums = 10 * z_prev.numel() if len(out) == 4 else 0
        return (nbytes(args[:9], out),
                4 * rows * w.shape[0] * w.shape[1] + sums)
    if name == "edge_mlp":
        # layer 0 is linear in [x_j, x_i - x_j] = x_j (W_top - W_bot) +
        # x_i W_bot: one C-wide product a point for each of the two (valid
        # queries, live neighbour rows), then one h1-wide add per live
        # edge; the later layers on every live edge
        nbr_idx, weights = args[1:3]
        b, n, _ = nbr_idx.shape
        live = nbr_idx >= 0
        c, h1 = weights[0].shape[0] // 2, weights[0].shape[1]
        rows = (nbr_idx.long() +
                n * torch.arange(b, device=nbr_idx.device).view(b, 1, 1))
        seen = torch.zeros(b * n, dtype=torch.bool, device=nbr_idx.device)
        seen[rows[live]] = True
        points = int(live.any(-1).sum()) + int(seen.sum())
        later = sum(w.shape[0] * w.shape[1] for w in weights[1:])
        edges = int(live.sum())
        return (nbytes(args[:4], out),
                2 * points * c * h1 + edges * (h1 + 2 * later))
    cfg = args[2]
    rows = int(args[1].sum())
    macs = sum(a * b for a, b in zip(cfg.dims[:-1], cfg.dims[1:]))
    if cfg.attend:
        macs += 2 * cfg.dims[-1] * cfg.att_dim
    if name == "group_train_fwd":
        # out, stats and n: the kernel's residuals (its extras) are a
        # design's choice, not the function's output
        return nbytes(args, out[:3]), 2 * rows * macs
    # two products per dense (data and weight gradient) from the chain
    # that K7's forward stored in its extras (int32 row list first); a
    # backward whose inputs hold no activation (the plain version's
    # extras) recomputes the chain too: 3x the forward's multiply-adds
    stored = args[6][0].dtype == torch.int32
    return nbytes(args, out), (4 if stored else 6) * rows * macs


def knn_needed_pairs(query, points, q_valid, p_valid, k, radius, idx,
                     tile=32):
    """(valid query, valid point) pairs in the ``tile``-point tiles of the
    row whose box of valid points lies within the query's final k-th d2
    (r2 where fewer than k were found): those no exact search can skip."""
    import numpy as np
    import torch
    from curvecloudnet_tpu_torch.ops.segments import sq_norm3

    b, n, _ = points.shape
    nt = -(-n // tile)
    pts = torch.nn.functional.pad(points, (0, 0, 0, nt * tile - n))
    pv = torch.nn.functional.pad(p_valid, (0, nt * tile - n))
    pts, pv = pts.view(b, nt, tile, 3), pv.view(b, nt, tile, 1)
    lo = torch.where(pv, pts, float("inf")).amin(2)       # (B, NT, 3)
    hi = torch.where(pv, pts, float("-inf")).amax(2)
    count = pv[..., 0].sum(-1)                             # (B, NT)
    r2 = (float("inf") if radius is None
          else float(np.float32(radius * radius)))
    kth = idx[..., k - 1].long()
    near = torch.gather(points, 1, kth.clamp(min=0)[..., None].expand(
        -1, -1, 3))
    thr = torch.where(kth >= 0, sq_norm3(query - near),
                      torch.full_like(query[..., 0], r2))
    total = 0
    for row in range(b):
        for c in range(0, query.shape[1], 4096):
            q = query[row, c:c + 4096, None, :]
            gap = torch.maximum(torch.maximum(lo[row] - q, q - hi[row]),
                                torch.zeros_like(q))
            need = ((sq_norm3(gap) <= thr[row, c:c + 4096, None]) &
                    q_valid[row, c:c + 4096, None])
            total += int((need * count[row]).sum())
    return total


def library_call(name, args):
    """One PyTorch call computing the same function, where one exists:
    K4 ``index_select`` of the clamped rows, K4b ``index_add_`` (both the
    fill=False function: a filled gather needs a second call), K10
    ``torch.topk`` (its values and columns: the carried indices need a
    second call)."""
    import torch

    name = name.removesuffix("_bf16")
    if name == "topk_smallest":
        d, _, k = args
        return lambda: torch.topk(d, k, dim=1, largest=False)
    if name == "gather":
        src, idx = args[:2]
        flat = idx.clamp(min=0).long().reshape(idx.shape[0], -1)
        return lambda: [torch.index_select(src[b], 0, flat[b])
                        for b in range(src.shape[0])]
    if name == "scatter":
        d, idx, n = args[:3]
        flat = idx.clamp(min=0).long().reshape(idx.shape[0], -1)
        dd = d.reshape(d.shape[0], -1, d.shape[-1])
        out = torch.zeros((d.shape[0], n, d.shape[-1]), dtype=d.dtype,
                          device=d.device)
        return lambda: [out[b].index_add_(0, flat[b], dd[b])
                        for b in range(d.shape[0])]
    return None


def capture(kernels, mods, run):
    """Run ``run()`` with a recorder on every listed wrapper -> {name: [(args,
    kwargs, output)]}."""
    import torch

    calls = {name: [] for name, *_ in kernels}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append((args, kwargs, out))
            return out
        # the wrapper counts through its module-level name, i.e. on this
        # stand-in while it is installed; those counts are not the main path's
        wrapped.launches = 0
        return wrapped

    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, *_ in kernels:
            m = mods[mod]
            stack.enter_context(replaced(
                m, wrapper, recorder(name, getattr(m, wrapper))))
        result = run()
        torch.cuda.synchronize()
    return calls, result


# kernels on tensor cores whose per-call lines give the 3xTF32 floor (3x
# the FP32 operations at the TF32 tensor-core peak; K2's and K7's come
# with their site lines)
TC_LINES = ("conv1d_chain", "conv1d_train_fwd", "conv1d_train_t", "edge_mlp",
            "edge_mlp_bf16")


def conv_labels(spec, calls):
    """{name: a label per recorded K1 / K8 call}: the conv step, and K8's
    layer (the forward's calls in order; the reduce and t passes by the z
    they take, the forward's output)."""
    steps = [(i, len(st.feat_dims)) for i, st in enumerate(spec.steps)
             if st.name == "conv1d-fast-v2"]
    labels = {"conv1d_chain": [f"step_{i}" for i, _ in steps]}
    if "conv1d_train_fwd" in calls:
        layers = [f"step_{i} layer {li + 1}" for i, n in steps
                  for li in range(n)]
        by_z = {out[0].data_ptr(): lab for (_, _, out), lab in
                zip(calls["conv1d_train_fwd"], layers)}
        labels["conv1d_train_fwd"] = layers
        for name in ("conv1d_train_reduce", "conv1d_train_t"):
            labels[name] = [by_z.get(args[1].data_ptr(), "?")
                            for args, _, _ in calls[name]]
    return labels


def measure(kernels, mods, calls, train, per_call=None, labels=None):
    """Compare and time every recorded call -> report rows; ``per_call``
    (a dict) collects each call's kernel ms by name; ``labels`` (a dict of
    lists) names each call on its line."""
    import torch

    report = {}
    for name, mod, wrapper, ref_name, source, replaces, tol in kernels:
        kern = getattr(mods[mod], wrapper)
        ref = getattr(mods[mod], ref_name)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": None}
        flops_total = bytes_total = 0
        peak = OPS_PEAK.get(name, PEAK_FP32)
        names = (labels or {}).get(name, [])
        for i, (args, kwargs, out) in enumerate(calls[name]):
            with torch.no_grad():
                if train:
                    e, plain = compare_train(name, args, kwargs, out, ref,
                                             tol)
                else:
                    e = compare(name, kern(*args, **kwargs),
                                ref(*args, **kwargs), tol)
                    plain = lambda: ref(*args, **kwargs)  # noqa: E731
                # K8's passes take a millisecond or less, most of it the
                # host's on the narrow layers: the median of 21 runs a call
                reps = (21 if name.startswith("conv1d") else 1) if train else 3
                k_ms = cuda_ms(lambda: kern(*args, **kwargs), reps)
                r_ms = cuda_ms(plain, reps)
                lib = library_call(name, args)
                if lib is not None:
                    row["library_ms"] = (row["library_ms"] or 0.0) + cuda_ms(
                        lib, reps)
            nb, fl = work(name, args, out)
            bytes_total, flops_total = bytes_total + nb, flops_total + fl
            bound = max(nb / PEAK_BYTES, fl / peak) * 1e3
            row["bound_ms"] += bound
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            label = f" {names[i]}" if i < len(names) else ""
            extra = (f", bound {bound:.3f} ms, 3xTF32 floor "
                     f"{3 * fl / PEAK_TF32 * 1e3:.3f} ms"
                     if name in TC_LINES else
                     f", bound {bound:.3f} ms (bfloat16 tensor rate)"
                     if peak == PEAK_BF16 else "")
            log(f"  {name}{label} {shapes}: err {e:.3g}, kernel {k_ms:.3f} "
                f"ms, plain {r_ms:.3f} ms{extra}")
            row["max_abs_err"] = max(row["max_abs_err"], e)
            row["ms"] += k_ms
            if per_call is not None:
                per_call.setdefault(name, []).append(
                    {"ms": k_ms, "plain_ms": r_ms, "bound_ms": bound,
                     "flops": fl})
            row["plain_ms"] += r_ms
        row["bound_by"] = ("operations" if flops_total / peak
                           > bytes_total / PEAK_BYTES else "bytes")
        log(f"compare {name}: {len(calls[name])} calls, max abs err "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), library {row['library_ms']}")
        report[name] = row
    return report


def grouped_steps(spec, train=False):
    """The steps that run K2 (eval) or K7 (train): the grouping steps that
    ``modules.kernel_grouped`` admits and the edge route does not fuse."""
    from curvecloudnet_tpu_torch.models.modules import (EDGE_STEPS,
                                                        kernel_grouped)

    return [i for i, st in enumerate(spec.steps)
            if (st.name in ("sa", "sa-geo") or st.name in EDGE_STEPS)
            and kernel_grouped(st.aggr_type, len(spec.input_dim(i)) - 1,
                               train)]


def k2_sites(label, spec, calls, per_call, floor_of=None):
    """Phases 3, 9 and 20: one line per K2 call of the captured forward
    (the grouping steps, in order; batch row 0's queries with no live
    slot, and how many of those have K equal h1 planes), and their sums
    with the 3xTF32 floor (3x the FP32 operations at the TF32 tensor-core
    peak; ``floor_of``: (name, seconds a FLOP) of another floor)."""
    floor_name, per_flop = floor_of or ("3xTF32 floor", 3 / PEAK_TF32)
    steps = grouped_steps(spec)
    sums = dict.fromkeys(("ms", "plain_ms", "bound_ms", "floor_ms"), 0.0)
    for i, ((args, kwargs, _), t) in enumerate(zip(calls, per_call)):
        h1, mask, _, local, att = args[:5]
        aggr = kwargs["aggr"]
        widths = [h1.shape[-1]] + [w.shape[1] for w, _ in local]
        att_w = [w.shape[1] for w, _ in att] if aggr == "attend" else []
        floor = t["flops"] * per_flop * 1e3
        dead = ~mask[0].any(-1)
        equal = (h1[0][:, dead] == h1[0][:1, dead]).all(-1).all(0)
        log(f"K2 site {label} step_{steps[i]}: M {h1.shape[2]}, K "
            f"{h1.shape[1]}, widths {widths}, attend {att_w}, {aggr}, live "
            f"rows {int(mask.sum())} of {mask.numel()}, {int(dead.sum())} "
            f"queries with no live slot ({int(equal.sum())} with K equal "
            f"planes), kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.3f} ms, {floor_name} {floor:.3f} ms")
        for key in ("ms", "plain_ms", "bound_ms"):
            sums[key] += t[key]
        sums["floor_ms"] += floor
    log(f"K2 {label}, {len(calls)} calls: kernel {sums['ms']:.3f} ms, plain "
        f"{sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms, "
        f"{floor_name} {sums['floor_ms']:.3f} ms")


def device_ms(fn, reps=3):
    """Device busy milliseconds of one ``fn()`` (``torch.profiler``: the
    self device time of its CUDA-side entries, over ``reps`` runs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def cdist_topk(query, points, q_valid, p_valid, k, radius):
    """The same search in PyTorch calls (no single call computes it):
    ``torch.cdist``, the invalid points and those past the radius masked,
    ``torch.topk`` of the k smallest."""
    import torch

    d = torch.cdist(query, points).masked_fill(~p_valid[:, None, :],
                                               float("inf"))
    if radius is not None:
        d = d.masked_fill(d > radius, float("inf"))
    return torch.topk(d, k, dim=-1, largest=False)


def k3_calls(label, calls, per_call, knn):
    """Phases 3, 6, 9 and 14-15: one line per K3 call (a row's shared
    table, a query set against a row: the fp sweeps, or a ball query, k >
    32), with the share of (query, tile) pairs the kernel visited
    (``knn.tile_visits``), and their sums; a ball query's line also gives
    its device ms and the ``cdist`` + ``topk`` time (:func:`cdist_topk`)."""
    sums = dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0)
    seen = tested = 0
    balls = dict.fromkeys(("n", "ms", "device_ms", "bound_ms", "lib_ms"), 0)
    for i, ((args, kwargs, _), t) in enumerate(zip(calls, per_call)):
        query, points, q_valid, p_valid, k, radius = args
        site = ("ball query" if k > 32 else "row table" if query is points
                else "query set")
        v, n = knn.tile_visits(*args, **kwargs)
        seen, tested = seen + v, tested + n
        share = f"{v / max(n, 1):.4f} ({v} of {n})"
        extra = ""
        if k > 32:
            dev_ms = device_ms(lambda: knn.knn_search(*args, **kwargs))
            lib = cuda_ms(lambda: cdist_topk(*args))
            filled = (knn.knn_search_ref(*args)[0] >= 0).sum(-1)[q_valid]
            extra = (f", device {dev_ms:.3f} ms, cdist + topk {lib:.3f} ms, "
                     f"ball sizes median {int(filled.median())}, "
                     f"{float((filled == k).float().mean()):.3f} full")
            for key, val in zip(balls, (1, t["ms"], dev_ms, t["bound_ms"],
                                        lib)):
                balls[key] += val
        log(f"K3 call {label} {i} {site}: B {query.shape[0]}, Q "
            f"{query.shape[1]}, N {points.shape[1]}, k {k}, radius {radius}, "
            f"valid queries {int(q_valid.sum())}, valid points "
            f"{int(p_valid.sum())}, kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms, tiles "
            f"visited {share}{extra}")
        for key in sums:
            sums[key] += t[key]
    log(f"K3 {label}, {len(calls)} calls: kernel {sums['ms']:.3f} ms, plain "
        f"{sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.4f} ms, tiles "
        f"visited {seen / max(tested, 1):.4f}")
    if balls["n"]:
        log(f"K3 {label}, {balls['n']} ball queries (k > 32): kernel "
            f"{balls['ms']:.3f} ms, device {balls['device_ms']:.3f} ms, bound "
            f"{balls['bound_ms']:.4f} ms, cdist + topk {balls['lib_ms']:.3f} "
            f"ms")


def k6_calls(label, calls, per_call, fps):
    """Phases 3, 6, 9 and 14-15: one line per K6 call: the row, its valid
    count, the picks, kernel and plain ms, us a pick, and the per-pick
    fixed cost: the same kernel (the same launch shape,
    ``fps.launch_config``) on a row of 1024 (or the call's row size, if
    smaller) random points, all valid, with the same number of picks up
    to that size (past them every later pick would repeat one point,
    which the kernel does without a round); the serial floor is that cost
    x the rounds the call needs: its picks up to the last valid point of
    its fullest row."""
    import torch

    sums = dict.fromkeys(("ms", "plain_ms", "bound_ms", "fixed_ms"), 0.0)
    picks = 0
    for i, ((args, kwargs, _), t) in enumerate(zip(calls, per_call)):
        pos, valid, start, budget = args
        n = pos.shape[1]
        m = min(n, 1024)
        g = torch.Generator(device=pos.device).manual_seed(i)
        small = (torch.randn((pos.shape[0], m, 3), generator=g,
                             device=pos.device),
                 torch.ones_like(valid[:, :m]), torch.zeros_like(start))
        few = min(budget, m)
        cfg = fps.launch_config(n)
        shape = f"{cfg[0]} threads, {cfg[1]} points a thread"
        fixed = cuda_ms(lambda: fps.fps_picks_config(*small, few, cfg))
        rounds = min(budget, int(valid.sum(-1).max()))
        floor = fixed * rounds / few
        log(f"K6 call {label} {i}: N {n}, valid {int(valid.sum())}, picks "
            f"{budget} x {pos.shape[0]} rows ({shape}), kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms, "
            f"{t['ms'] * 1e3 / budget:.3f} us a pick, fixed cost "
            f"{fixed * 1e3 / few:.3f} us a pick ({few} picks of a "
            f"{m}-point row: {fixed:.3f} ms), serial floor {floor:.3f} ms "
            f"({rounds} rounds)")
        for key in ("ms", "plain_ms", "bound_ms"):
            sums[key] += t[key]
        sums["fixed_ms"] += floor
        picks += budget
    log(f"K6 {label}, {len(calls)} calls, {picks} picks: kernel "
        f"{sums['ms']:.3f} ms, plain {sums['plain_ms']:.3f} ms, bound "
        f"{sums['bound_ms']:.4f} ms, serial floor (rounds x fixed cost) "
        f"{sums['fixed_ms']:.3f} ms")


def k8_sums(calls, per_call, labels, T, tol):
    """Phase 6: the K8 t passes that take the previous layer's reduce sums:
    the sums against the plain reduce on the pass's own d_u_prev (within
    ``tol`` of max(1, |plain|)), a line each; each pass timed with and
    without them in turns (with, without, without, with; each the median
    of 21), beside the standalone reduce calls: what the fused sums cost
    the t pass, and what the standalone reduce still costs.  Returns the
    sums' max abs err."""
    import torch

    with_ms = without_ms = worst = 0.0
    fused = 0
    for (args, kwargs, out), label in zip(calls["conv1d_train_t"],
                                          labels["conv1d_train_t"]):
        if not kwargs.get("prev_sums"):
            continue
        d_u_prev, z_prev, bn_prev, used = out[0], args[2], args[4], args[8]
        with torch.no_grad():
            want = T.conv1d_train_bwd_reduce_ref(d_u_prev, z_prev, bn_prev,
                                                 used)
        err = max(_err("conv1d_train_reduce (fused)", got, ref, tol)
                  for got, ref in zip(out[3], want))
        scale = max(max(1.0, float(t.abs().max())) for t in want)
        log(f"  conv1d_train_reduce fused into the t pass of {label}: "
            f"{z_prev.shape[-1]} channels, max abs err {err:.3g} (scale "
            f"{scale:.3g}, tolerance {tol:g} of it)")
        worst = max(worst, err)
        runs = {True: [], False: []}
        with torch.no_grad():
            for sums in (True, False, False, True):
                runs[sums].append(cuda_ms(functools.partial(
                    T.conv1d_train_bwd_t, *args, prev_sums=sums), 21))
        w, wo = (sum(runs[x]) / 2 for x in (True, False))
        log(f"  conv1d_train_t {label}: kernel {w:.3f} ms with the "
            f"previous layer's reduce sums, {wo:.3f} ms without")
        with_ms, without_ms = with_ms + w, without_ms + wo
        fused += 1
    red = per_call["conv1d_train_reduce"]
    log(f"K8 reduce: {len(red)} standalone calls, kernel "
        f"{sum(t['ms'] for t in red):.3f} ms, bound "
        f"{sum(t['bound_ms'] for t in red):.4f} ms; {fused} fused into t "
        f"passes: those t passes {with_ms:.3f} ms with the sums, "
        f"{without_ms:.3f} ms without")
    return worst


def pass_times(G, fn):
    """Run ``fn()`` once to warm up, then once with every K7 launch timed
    (``G.launch_times``) -> {pass: ms}; the time outside the launches
    (torch glue) is ``"glue"``."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with G.launch_times() as times:
        a.record()
        fn()
        b.record()
    out = {}
    for (pass_, _), ms in times.items():
        out[pass_] = out.get(pass_, 0.0) + ms
    out["glue"] = a.elapsed_time(b) - sum(out.values())
    return out


def k7_sites(spec, calls, per_call, G, label="nuScenes",
             names=("group_train_fwd", "group_train_bwd"),
             floor_of=("3xTF32 floor", 3 / PEAK_TF32)):
    """Phases 6 and 17: one line per K7 call of the captured train step
    (the grouping steps, in order), forward and backward: live rows,
    queries with no live slot and the check that the call's ``dout`` is
    exactly 0 at every one of them (the contract that lets K7 drop their
    rows), the size of the chain the forward stores for the backward,
    kernel / plain / bound / 3xTF32-floor ms and the kernel's ms per pass;
    then their sums.  ``names``: the wrappers' (the bfloat16 variant's),
    ``floor_of``: the floor's name and seconds an operation."""
    import torch

    steps = grouped_steps(spec, train=True)
    fwd, bwd = calls[names[0]], calls[names[1]]
    t_fwd, t_bwd = per_call[names[0]], per_call[names[1]]
    # autograd runs the backward calls in reverse; pair them by h1
    by_h1 = {(a[0].data_ptr(), tuple(a[0].shape)): (a, t)
             for (a, _, _), t in zip(bwd, t_bwd)}
    if len(fwd) != len(steps) or len(by_h1) != len(fwd):
        raise AssertionError(f"K7: {len(fwd)} forward and {len(bwd)} "
                             f"backward calls for {len(steps)} steps")
    keys = ("ms", "plain_ms", "bound_ms", "floor_ms")
    sums = {d: dict.fromkeys(keys, 0.0) for d in ("fwd", "bwd")}
    passes = {"fwd": {}, "bwd": {}}
    for step, (args, _, f_out), tf in zip(steps, fwd, t_fwd):
        h1, mask, cfg, params = args
        stored = sum(t.numel() * t.element_size() for t in f_out[3][5:])
        b_args, tb = by_h1[(h1.data_ptr(), tuple(h1.shape))]
        dout = b_args[7]
        dead = ~mask.any(-1)
        nonzero = int((dout[dead] != 0).any(-1).sum())
        if nonzero:
            raise AssertionError(f"K7 step_{step}: dout is not 0 at "
                                 f"{nonzero} queries with no live slot")
        with torch.no_grad():
            pf = pass_times(G, lambda: G.group_train_fwd(*args))
            pb = pass_times(G, lambda: G.group_train_bwd(*b_args))
        line = []
        for d, t, pt in (("fwd", tf, pf), ("bwd", tb, pb)):
            floor = t["flops"] * floor_of[1] * 1e3
            for key, v in zip(keys, (t["ms"], t["plain_ms"], t["bound_ms"],
                                     floor)):
                sums[d][key] += v
            for k, v in pt.items():
                passes[d][k] = passes[d].get(k, 0.0) + v
            per = ", ".join(f"{k} {v:.3f}" for k, v in pt.items())
            line.append(f"{d} kernel {t['ms']:.3f} ms, plain "
                        f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f}"
                        f" ms, {floor_of[0]} {floor:.3f} ms ({per})")
        log(f"K7 site {label} step_{step}: B {h1.shape[0]}, M {h1.shape[2]},"
            f" K {h1.shape[1]}, widths {list(cfg.dims)}, attend "
            f"{cfg.att_dim}, {cfg.aggr}, live rows {int(mask.sum())} of "
            f"{mask.numel()}, {int(dead.sum())} queries with no live slot "
            f"(dout 0 at all), stored chain {stored / 2**30:.3f} GiB; "
            + "; ".join(line))
    for d in ("fwd", "bwd"):
        s = sums[d]
        per = ", ".join(f"{k} {v:.3f}" for k, v in passes[d].items())
        log(f"K7 {label} {d}, {len(fwd)} calls: kernel {s['ms']:.3f} ms, plain "
            f"{s['plain_ms']:.3f} ms, bound {s['bound_ms']:.3f} ms, "
            f"{floor_of[0]} {s['floor_ms']:.3f} ms; by pass: {per}")


def recording(calls, fn):
    """``fn`` that appends (args, kwargs, output) of every call to
    ``calls``."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    return wrapped


def grid_recall(args, kwargs, out):
    """Phase 11 for one recorded grid search: its table against the exact
    K3 table of the same row, radius and k."""
    import torch

    from curvecloudnet_tpu_torch.ops import knn

    query, points, q_valid, p_valid, k, radius = args
    g_idx, _, n_dropped = out
    e_idx, e_dist = knn.knn_search(query, points, q_valid, p_valid, k, radius)
    exact = e_idx >= 0
    found = ((e_idx[..., :, None] == g_idx[..., None, :]).any(-1)) & exact
    n_exact = exact.sum(-1)
    rows = n_exact > 0
    recall = float((found.sum(-1)[rows] / n_exact[rows]).mean())
    missing = exact & ~found
    kth = torch.where(exact, e_dist, torch.zeros_like(e_dist)).amax(-1)
    inside = missing & (e_dist < kth[..., None])
    proven = kwargs["hash_bits"] is not None
    log(f"grid table n={points.shape[1]} r={radius} cap={kwargs['cap']} "
        f"({'voxel-proven' if proven else 'curve-sampled'}): recall "
        f"{recall:.6f}, {int(missing.sum())} exact neighbors missing "
        f"({int(inside.sum())} inside the k-th distance), "
        f"{int(n_dropped.sum())} points dropped past the cap and the "
        f"overflow rows")
    if proven and bool(inside.any()):
        raise AssertionError("voxel-proven grid table lost a neighbor "
                             "inside the k-th distance")
    if not proven and recall < RECALL_FLOOR:
        raise AssertionError(f"grid recall {recall} < {RECALL_FLOOR}")
    return recall


def run_kitti(P, mods, dev, kernel_launches):
    """Phases 9-12 -> (report rows, launches by path)."""
    import torch

    from curvecloudnet_tpu_torch.ops import grid_knn, grid_topk

    # 9. capture one KITTI forward, compare and time every recorded call
    model = P.build_model(KITTI_CONFIG, KITTI_N_PAD, dev)
    n_beams = P.N_BEAMS[P.dataset_of(KITTI_CONFIG)]
    scan0 = P.synthetic_scan(0, KITTI_N_PAD, dev, n_beams)
    searches = []
    with replaced(grid_knn, "grid_knn", recording(searches,
                                                  grid_knn.grid_knn)):
        calls, _ = capture(KITTI_KERNELS, mods,
                           lambda: P.predict(model, *scan0))
    per_call = {}
    report = measure(KITTI_KERNELS, mods, calls, train=False,
                     per_call=per_call, labels=conv_labels(model.spec, calls))
    k2_sites("KITTI", model.spec, calls["group_reduce"],
             per_call["group_reduce"])
    k3_calls("KITTI", calls["knn"], per_call["knn"], mods["knn"])
    k6_calls("KITTI", calls["fps"], per_call["fps"], mods["fps"])
    topk_calls = []
    for args, _, out in calls["grid_topk"]:
        table, counts, nbr, query, q_valid, k, r2 = args
        planes = grid_topk.planes(table, nbr, query, q_valid, r2)
        got = grid_topk.topk_smallest(*planes, k)
        if not (torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])):
            raise AssertionError("K10 on the candidate planes differs from K5")
        topk_calls.append(((*planes, k), {}, got))
    del calls
    report.update(measure(TOPK_KERNELS, mods, {"topk_smallest": topk_calls},
                          train=False))
    del topk_calls

    # 10. two scans through predict, launches counted
    want = kernel_launches(model.spec, KITTI_N_PAD)
    for name, mod, wrapper, *_ in KITTI_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    scan_ms, peaks = [], []
    for seed in range(SCANS):
        inputs = (scan0 if seed == 0 else
                  P.synthetic_scan(seed, KITTI_N_PAD, dev, n_beams))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, valid, _ = P.predict(model, *inputs)
        torch.cuda.synchronize()
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        if logits.shape != (1, KITTI_N_PAD, model.spec.n_out) or not bool(
                torch.isfinite(logits[valid]).all()):
            raise AssertionError(f"KITTI scan {seed}: bad logits "
                                 f"{tuple(logits.shape)}")
        if seed == 0:
            logits0, valid0 = logits, valid
        log(f"KITTI scan {seed}: {scan_ms[-1]:.1f} ms, peak memory "
            f"{peaks[-1]:.2f} GiB, {int(valid.sum())} valid points")
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in KITTI_KERNELS}
    log("KITTI launches:", launched, "spec per scan:", want)
    for name, got in launched.items():
        if got != SCANS * want.get(name, 0) or not got:
            raise AssertionError(f"{name}: {got} KITTI launches, "
                                 f"want {SCANS} x {want.get(name, 0)}")
    log(f"KITTI per-scan latency ms: {scan_ms}; peak memory GiB: {peaks}")

    # 11. recall of each grid table of scan 0
    for args, kwargs, out in searches:
        grid_recall(args, kwargs, out)

    # 12. the plain path on the card, then the planes tail
    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, ref_name, *_ in KITTI_KERNELS + TOPK_KERNELS:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        t0 = time.perf_counter()
        plain = P.predict(model, *scan0)[0]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((logits0 - plain)[valid0].abs().max())
    log(f"KITTI logits kernel path vs plain path on the card: max abs err "
        f"{err:.3g}; plain forward {plain_ms:.1f} ms")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"KITTI logits differ from the plain path by {err}")
    for name, mod, wrapper, *_ in KITTI_KERNELS + TOPK_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    planes_searches = []
    planes_tail = functools.partial(grid_knn.grid_knn, tail="planes")
    with replaced(grid_knn, "grid_knn", recording(planes_searches,
                                                  planes_tail)):
        t0 = time.perf_counter()
        p_logits = P.predict(model, *scan0)[0]
        torch.cuda.synchronize()
        planes_ms = (time.perf_counter() - t0) * 1e3
    planes_launched = {name: getattr(mods[mod], w).launches
                       for name, mod, w, *_ in KITTI_KERNELS + TOPK_KERNELS}
    log(f"KITTI planes tail: {planes_ms:.1f} ms, launches {planes_launched}")
    if planes_launched["topk_smallest"] != want["grid_topk"] or \
            planes_launched["grid_topk"]:
        raise AssertionError("planes tail: K10 launches "
                             f"{planes_launched['topk_smallest']}, want "
                             f"{want['grid_topk']} (and no K5)")
    if len(planes_searches) != len(searches):
        raise AssertionError("planes tail ran another set of grid searches")
    for (_, _, a), (_, _, b) in zip(searches, planes_searches):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("planes tail: neighbor tables differ from "
                                 "the records tail's")
    if not torch.equal(p_logits[valid0], logits0[valid0]):
        raise AssertionError("planes tail: logits differ from the records "
                             "tail's")
    log("KITTI planes tail: neighbor tables and logits identical to the "
        "records tail's")
    by_path = {"kitti": launched, "kitti_planes": {
        "topk_smallest": planes_launched["topk_smallest"]}}
    return report, by_path, (scan0, logits0, valid0)


def run_fused(P, mods, dev, kernel_launches, scan0, group_logits, valid0,
              group_call_ms):
    """Phase 13 -> (K9's report row, launches of the fused route's scan,
    the worst error of its K2 calls)."""
    import torch

    model = P.build_model(CONFIG, N_PAD, dev, edge_kernel="fused")
    want = kernel_launches(model.spec, N_PAD, edge_kernel="fused")
    kernels = EVAL_KERNELS + EDGE_KERNELS
    for name, mod, wrapper, *_ in kernels:
        getattr(mods[mod], wrapper).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, valid, _ = P.predict(model, *scan0)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in kernels}
    log("fused edge route launches:", launched, "spec per scan:", want)
    for name, got in launched.items():
        if got != want.get(name, 0) or not got:
            raise AssertionError(f"{name}: {got} launches on the fused edge "
                                 f"route, want {want.get(name, 0)}")
    err = float((logits - group_logits)[valid0].abs().max())
    log(f"fused edge route: scan 0 {scan_ms:.1f} ms; logits vs the group "
        f"route: max abs err {err:.3g}")
    if not (torch.equal(valid, valid0) and err <= LOGIT_TOL):
        raise AssertionError(f"fused edge route logits differ by {err}")
    # K9's calls and the route's K2 calls (same tolerance as phase 3)
    held = EDGE_KERNELS + [k for k in EVAL_KERNELS if k[0] == "group_reduce"]
    calls, _ = capture(held, mods, lambda: P.predict(model, *scan0))
    k9_ms = {}
    report = measure(held, mods, calls, train=False, per_call=k9_ms)
    k2_err = report.pop("group_reduce")["max_abs_err"]
    # each admitted step's K9 call beside the same step's K4 and K2 calls
    # of the group route (phase 3), matched by order of the steps
    steps = model.spec.steps
    sgcnn = [i for i, st in enumerate(steps) if st.name == "sgcnn"]
    grouping = [i for i, st in enumerate(steps)
                if st.name in ("sa", "sa-geo", "sgcnn")]
    admitted = [i for i, m in enumerate(model.steps)
                if getattr(m, "fused", False)]
    if len(admitted) != len(k9_ms["edge_mlp"]):
        raise AssertionError(f"{len(k9_ms['edge_mlp'])} K9 calls for the "
                             f"admitted steps {admitted}")
    total = dict.fromkeys(("k9", "floor", "k4", "k2", "mm"), 0.0)
    for i, (args, _, _), t in zip(admitted, calls["edge_mlp"],
                                  k9_ms["edge_mlp"]):
        k4 = group_call_ms["gather"][sgcnn.index(i)]["ms"]
        k2 = group_call_ms["group_reduce"][grouping.index(i)]["ms"]
        with torch.no_grad():
            mm = cuda_ms(functools.partial(model.steps[i].layer0, args[0]))
        floor = 3 * t["flops"] / PEAK_TF32 * 1e3
        for key, v in zip(total, (t["ms"], floor, k4, k2, mm)):
            total[key] += v
        log(f"  step_{i} sgcnn: x {tuple(args[0].shape)}, K9 (projection + "
            f"edge) {t['ms']:.3f} ms (bound {t['bound_ms']:.3f}, 3xTF32 "
            f"floor {floor:.3f}); group route: K4 {k4:.3f} + K2 {k2:.3f} + "
            f"layer-0 matmuls {mm:.3f} = {k4 + k2 + mm:.3f} ms")
    log(f"K9 on the fused route, {len(admitted)} steps: {total['k9']:.3f} ms "
        f"(3xTF32 floor {total['floor']:.3f}); the group route on the same steps: K4 {total['k4']:.3f} + K2 "
        f"{total['k2']:.3f} + layer-0 matmuls {total['mm']:.3f} = "
        f"{total['k4'] + total['k2'] + total['mm']:.3f} ms")
    return report, launched, k2_err


def run_kitti_fused(P, mods, dev, kernel_launches, scan0, group_logits,
                    valid0):
    """Phase 13, KITTI: scan 0 of phases 9-12 on the fused edge route ->
    (launches of the scan, the worst error of its K9 calls)."""
    import torch

    model = P.build_model(KITTI_CONFIG, KITTI_N_PAD, dev, edge_kernel="fused")
    want = kernel_launches(model.spec, KITTI_N_PAD, edge_kernel="fused")
    kernels = KITTI_KERNELS + EDGE_KERNELS
    for name, mod, wrapper, *_ in kernels:
        getattr(mods[mod], wrapper).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, valid, _ = P.predict(model, *scan0)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in kernels}
    log("KITTI fused edge route launches:", launched, "spec per scan:", want)
    for name, got in launched.items():
        if got != want.get(name, 0) or not got:
            raise AssertionError(f"{name}: {got} launches on the KITTI fused "
                                 f"edge route, want {want.get(name, 0)}")
    err = float((logits - group_logits)[valid0].abs().max())
    log(f"KITTI fused edge route: scan 0 {scan_ms:.1f} ms, "
        f"{sum(getattr(m, 'fused', False) for m in model.steps)} steps on "
        f"K9; logits vs the group route (phase 10): max abs err {err:.3g}")
    if not (torch.equal(valid, valid0) and err <= LOGIT_TOL):
        raise AssertionError(f"KITTI fused edge route logits differ by {err}")
    # each K9 call against its plain version at phase 13's tolerance
    name, mod, wrapper, ref_name, _, _, tol = EDGE_KERNELS[0]
    calls, _ = capture(EDGE_KERNELS, mods, lambda: P.predict(model, *scan0))
    worst = 0.0
    with torch.no_grad():
        for args, kwargs, out in calls[name]:
            e = compare(name, out, getattr(mods[mod], ref_name)(*args,
                                                                 **kwargs),
                        tol)
            log(f"  {name} KITTI x {tuple(args[0].shape)}, live edges "
                f"{int((args[1] >= 0).sum())}: err {e:.3g}")
            worst = max(worst, e)
    log(f"K9 on the KITTI fused route, {len(calls[name])} calls: max abs err "
        f"{worst:.3g} (tolerance {tol:g} of max(1, |plain|))")
    return launched, worst


def run_v1(P, mods, dev, kernel_launches, label, config):
    """Phase 14 (A2D2) or 15 (an object config) on the group route ->
    (report rows, launches of its scans, (scan 0's inputs, logits, valid))."""
    import torch

    n_pad = P.n_pad_of(config)
    model = P.build_model(config, n_pad, dev)
    inputs0 = P.synthetic_inputs(config, 0, n_pad, dev)
    calls, _ = capture(V1_KERNELS, mods, lambda: P.predict(model, *inputs0))
    per_call = {}
    report = measure(V1_KERNELS, mods, calls, train=False, per_call=per_call)
    k2_sites(label, model.spec, calls["group_reduce"],
             per_call["group_reduce"])
    k3_calls(label, calls["knn"], per_call["knn"], mods["knn"])
    k6_calls(label, calls["fps"], per_call["fps"], mods["fps"])
    del calls

    # scans through predict, launches counted; then each scan's device
    # busy time under the profiler (its launches not counted)
    want = kernel_launches(model.spec, n_pad)
    for name, mod, wrapper, *_ in EVAL_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    scans, walls, peaks = [], [], []
    for seed in range(V1_SCANS):
        inputs = (inputs0 if seed == 0 else
                  P.synthetic_inputs(config, seed, n_pad, dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, valid, _ = P.predict(model, *inputs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        rows = 1 if P.dataset_of(config) == "shapenet-class" else n_pad
        if logits.shape != (inputs[0].shape[0], rows, model.spec.n_out) or \
                not bool(torch.isfinite(logits[valid]).all()):
            raise AssertionError(f"{label} scan {seed}: bad logits "
                                 f"{tuple(logits.shape)}")
        if seed == 0:
            logits0, valid0 = logits, valid
        scans.append(inputs)
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in EVAL_KERNELS}
    log(f"{label} launches:", launched, "spec per scan:", want)
    for name, got in launched.items():
        if got != V1_SCANS * want.get(name, 0):
            raise AssertionError(f"{name}: {got} {label} launches, want "
                                 f"{V1_SCANS} x {want.get(name, 0)}")
    for seed, inputs in enumerate(scans):
        busy = device_ms(lambda: P.predict(model, *inputs), reps=1)
        log(f"{label} scan {seed}: B {inputs[0].shape[0]}, n_pad {n_pad}, "
            f"{int(inputs[3].sum())} valid points, {walls[seed]:.1f} ms "
            f"wall, {busy:.2f} ms device busy, peak memory "
            f"{peaks[seed]:.2f} GiB")
    del scans

    # scan 0 through the plain versions
    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, ref_name, *_ in EVAL_KERNELS:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        plain = P.predict(model, *inputs0)[0]
    err = float((logits0 - plain)[valid0].abs().max())
    log(f"{label} logits kernel path vs plain path on the card: max abs err "
        f"{err:.3g}")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{label} logits differ from the plain path by "
                             f"{err}")
    return report, launched, (inputs0, logits0, valid0)


def run_v1_fused(P, mods, dev, kernel_launches, label, config, scan0,
                 group_logits, valid0):
    """Phase 15, the fused route of an object config -> (launches of its
    batch, K9's report row)."""
    import torch

    n_pad = P.n_pad_of(config)
    model = P.build_model(config, n_pad, dev, edge_kernel="fused")
    want = kernel_launches(model.spec, n_pad, edge_kernel="fused")
    kernels = EVAL_KERNELS + EDGE_KERNELS
    for name, mod, wrapper, *_ in kernels:
        getattr(mods[mod], wrapper).launches = 0
    logits, valid, _ = P.predict(model, *scan0)
    torch.cuda.synchronize()
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in kernels}
    log(f"{label} fused edge route launches:", launched, "spec:", want)
    for name, got in launched.items():
        if got != want.get(name, 0):
            raise AssertionError(f"{name}: {got} launches on the {label} "
                                 f"fused route, want {want.get(name, 0)}")
    err = _err(f"{label} fused-route logits", logits[valid0],
               group_logits[valid0], FUSED_V1_TOL)
    log(f"{label} fused edge route, {want['edge_mlp']} steps on K9 (the slow "
        f"order folded into W_0): logits vs the group route max abs err "
        f"{err:.3g} (tolerance {FUSED_V1_TOL:g} of max(1, |group|))")
    if not torch.equal(valid, valid0):
        raise AssertionError(f"{label} fused route: valid rows differ")
    calls, _ = capture(EDGE_KERNELS, mods, lambda: P.predict(model, *scan0))
    report = measure(EDGE_KERNELS, mods, calls, train=False)
    return launched, report["edge_mlp"]


def hold(label, kernels, mods, calls):
    """Each recorded call re-run through the kernel and its plain version,
    compared at the kernel's tolerance (no timing) -> {name: max err}."""
    import torch

    worst = {}
    for name, mod, wrapper, ref_name, *_, tol in kernels:
        kern, ref = getattr(mods[mod], wrapper), getattr(mods[mod], ref_name)
        errs = [0.0]
        with torch.no_grad():
            for args, kwargs, _ in calls[name]:
                errs.append(compare(name, kern(*args, **kwargs),
                                    ref(*args, **kwargs), tol))
        worst[name] = max(errs)
        log(f"  {label} {name}: {len(calls[name])} calls, max abs err "
            f"{worst[name]:.3g}")
    return worst


class WithMeta:
    """A val set whose samples carry a nuScenes submission meta (file
    name, identity reorder), as the real test split's do."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def get(self, idx, rng=None, augment=False):
        import numpy as np

        sample = self.dataset.get(idx, rng, augment)
        sample.meta = {"format": "nuscenes", "fname": f"scan{idx}.bin",
                       "reorder": np.arange(len(sample.pos))}
        return sample


def run_eval_entry(P, mods, dev, kernel_launches):
    """Phase 16 -> ({kernel: worst error of the B=2 chunk's calls},
    launches by path)."""
    import numpy as np
    import torch

    from curvecloudnet_tpu_torch import main as M
    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.data import datasets as D
    from curvecloudnet_tpu_torch.run import tasks as T
    from curvecloudnet_tpu_torch.ops import grid_topk
    from curvecloudnet_tpu_torch.tools.tta_walls import host_syncs, tta_scan

    t_phase = time.perf_counter()
    quiet = dict(log=lambda *a: None)

    def cfg_of(name, label, **extra):
        cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
        cfg.update(device=str(dev), only_val=True,
                   outdir=os.path.join(OUT16, label))
        cfg.update(extra)
        # a fresh outdir: no resume from an earlier run's checkpoint
        shutil.rmtree(cfg["outdir"], ignore_errors=True)
        return cfg

    def counted_main(cfg, kernels=EVAL_KERNELS):
        for name, mod, wrapper, *_ in kernels:
            getattr(mods[mod], wrapper).launches = 0
        t0 = time.perf_counter()
        score = M.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {name: getattr(mods[mod], w).launches
                    for name, mod, w, *_ in kernels}
        with open(os.path.join(cfg["outdir"], "metrics.jsonl")) as f:
            logged = json.loads(f.readlines()[-1])
        return score, launched, wall, logged

    def check_launches(label, launched, want, times):
        log(f"{label} launches:", launched, f"spec x {times}:", want)
        for name, got in launched.items():
            if got != times * want.get(name, 0):
                raise AssertionError(f"{name}: {got} launches on {label}, "
                                     f"want {times} x {want.get(name, 0)}")

    def logged_line(logged):
        keys = ("miou", "mean_forward_s", "scan_wall_s", "points_per_sec",
                "peak_device_memory_gb")
        for key in keys:
            if key not in logged or not np.isfinite(logged[key]):
                raise AssertionError(f"main's logged {key}: "
                                     f"{logged.get(key)}")
        return ", ".join(f"{k} {logged[k]!r}" for k in keys)

    # the nuScenes val split through main: 12-view TTA, chunks of 2 views
    by_path = {}
    cfg = cfg_of("nuscenes", "nuscenes", n_val=EVAL_N_VAL)
    score, by_path["eval_tta"], wall, logged = counted_main(cfg)
    info, val_ds, model = M.build(cfg)
    chunks = T.N_VIEWS // EVAL_VIEWS_PER_CALL
    check_launches("eval_tta", by_path["eval_tta"],
                   kernel_launches(model.spec, val_ds.n_pad),
                   chunks * EVAL_N_VAL)
    log(f"main --only_val nuScenes ({EVAL_N_VAL} scans, n_pad "
        f"{val_ds.n_pad}, 12 views in chunks of {EVAL_VIEWS_PER_CALL}): "
        f"{wall:.2f} s; " + logged_line(logged))
    if score != logged["miou"]:
        raise AssertionError(f"main's score {score} is not its miou")

    # scan 0: batched TTA against 12 sequential B=1 forwards and the
    # per-view path
    np_batch = next(D.batch_iterator(val_ds, 1))
    batch = D.to_device_batch(np_batch, info.task, dev)
    cloud, valid0 = batch.cloud, batch.cloud.valid
    mean_b, valid_b, _, _ = T.make_batched_tta_eval(
        model, EVAL_VIEWS_PER_CALL, n_cls=info.n_out,
        metric_ignore=info.metric_ignore)(cloud, batch.labels)
    views = [(torch.from_numpy(f).to(dev), torch.tensor(s, device=dev))
             for f in T.TTA_FLIPS for s in T.TTA_SCALES]
    total = None
    for f, s in views:
        pos = torch.cat([cloud.pos[..., :2] * f * s, cloud.pos[..., 2:]], -1)
        lg = P.predict(model, pos, cloud.x, cloud.curve_id, cloud.valid)[0]
        total = lg if total is None else total + lg
    per_view = T.make_tta_eval(model, with_stats=True)
    outs = [per_view(cloud, f, s) for f, s in views]
    mean_p, _ = T.make_eval_post(info.n_out, info.metric_ignore)(
        [o[0] for o in outs], batch.labels, outs[0][1])
    if not torch.equal(valid_b, valid0):
        raise AssertionError("batched TTA: valid rows differ")
    e_seq = _err("batched TTA vs sequential predict", mean_b[valid0],
                 (total / T.N_VIEWS)[valid0], TTA_TOL)
    e_pv = _err("batched TTA vs the per-view path", mean_b[valid0],
                mean_p[valid0], TTA_TOL)
    log(f"scan 0 mean logits, batched (B={EVAL_VIEWS_PER_CALL} chunks) vs "
        f"12 sequential B=1 predict forwards: max abs err {e_seq:.3g}; vs "
        f"the per-view path: {e_pv:.3g} (tolerance {TTA_TOL:g})")

    # the overflow telemetry of each view; zero on the identity view
    worst = {}
    for vi, out in enumerate(outs):
        stats = {k: float(v) for k, v in out[2].items()}
        if vi == 0:
            bad = {k: v for k, v in stats.items()
                   if ("overflow" in k or "truncated" in k) and v > 0}
            if bad:
                raise AssertionError(f"identity view overflows: {bad}")
        for k, v in stats.items():
            worst[k] = max(worst.get(k, v), v)
    log(f"overflow telemetry, identity view zero; worst of 12 views: {worst}")
    del outs, total, mean_p

    # every kernel call of one B=2 chunk against its plain version
    fs = torch.from_numpy(T.tta_views()[:EVAL_VIEWS_PER_CALL]).to(dev)
    chunk = T.view_batch(cloud, fs)
    calls, _ = capture(EVAL_KERNELS, mods, lambda: P.predict(
        model, chunk.pos, chunk.x, chunk.curve_id, chunk.valid))
    errs = hold("nuScenes B=2 chunk", EVAL_KERNELS, mods, calls)
    del calls
    busy = device_ms(lambda: P.predict(model, chunk.pos, chunk.x,
                                       chunk.curve_id, chunk.valid), reps=2)
    log(f"device busy (torch.profiler): a B={EVAL_VIEWS_PER_CALL} chunk "
        f"{busy:.2f} ms ({busy / EVAL_VIEWS_PER_CALL:.2f} ms a view)")
    del chunk

    # per view and at 2 and 6 views a call: the loop's TTA scan wall over
    # the scans after its warm-up scan
    sweep = D.SyntheticLidarSeg(n_samples=SWEEP_SCANS, n_pad=val_ds.n_pad,
                                n_classes=info.n_out, seed=2)
    for v in SWEEP_VIEWS:
        res = T.evaluate_segmentation(model, sweep, info, batched_tta=v > 1,
                                      tta_views_per_call=v, **quiet)
        if set(res) != RESULT_KEYS or not np.isfinite(res["scan_wall_s"]):
            raise AssertionError(f"evaluate_segmentation: {sorted(res)}, "
                                 f"scan_wall_s {res['scan_wall_s']}")
        log(f"TTA {'per view' if v == 1 else f'{v} views a call'}, "
            f"{SWEEP_SCANS - 1} scans after a warm-up: scan TTA wall "
            f"{res['scan_wall_s'] * 1e3:.1f} ms, "
            f"{res['scan_wall_s'] * 1e3 / T.N_VIEWS:.3f} ms a view, "
            f"{res['points_per_sec']:.0f} points/s, peak memory "
            f"{res['peak_device_memory_gb']:.3f} GB, miou {res['miou']:.4g}")
    staged = D.to_device_batch(next(D.batch_iterator(sweep, 1)), info.task,
                               dev)
    tta = tta_scan(model, info, SWEEP_VIEWS[-1])
    tta(staged)   # its first call stages the chunks' view parameters
    waits = host_syncs(lambda: tta(staged))
    log(f"nuScenes TTA scan ({T.N_VIEWS // SWEEP_VIEWS[-1]} chunks of "
        f"{SWEEP_VIEWS[-1]} views and the histogram): "
        f"{sum(waits.values())} host waits (sync debug mode), by line: "
        f"{waits}")
    del staged, tta, model, sweep

    # KITTI's val split through main (n_pad 131072, grid rows: K5 on the
    # records tail), launches counted; then one B=2 chunk's kernel calls
    # against their plain versions, K10 on the planes of each K5 call
    kernels = KITTI_KERNELS + TOPK_KERNELS
    kcfg = cfg_of("kitti", "kitti", n_val=KITTI_N_VAL)
    _, by_path["eval_tta_kitti"], wall, logged = counted_main(kcfg, kernels)
    kinfo, kval, kmodel = M.build(kcfg)
    check_launches("eval_tta_kitti", by_path["eval_tta_kitti"],
                   kernel_launches(kmodel.spec, kval.n_pad),
                   chunks * KITTI_N_VAL)
    log(f"main --only_val KITTI ({KITTI_N_VAL} scans, n_pad {kval.n_pad}, "
        f"chunks of {EVAL_VIEWS_PER_CALL} views): {wall:.2f} s; "
        + logged_line(logged))
    kstaged = D.to_device_batch(next(D.batch_iterator(kval, 1)), kinfo.task,
                                dev)
    ktta = tta_scan(kmodel, kinfo, EVAL_VIEWS_PER_CALL)
    ktta(kstaged)
    waits = host_syncs(lambda: ktta(kstaged))
    kchunk = T.view_batch(kstaged.cloud, fs)
    calls, _ = capture(KITTI_KERNELS, mods, lambda: P.predict(
        kmodel, kchunk.pos, kchunk.x, kchunk.curve_id, kchunk.valid))
    kerrs = hold("KITTI B=2 chunk", KITTI_KERNELS, mods, calls)
    topk_calls = []
    for args, _, out in calls["grid_topk"]:
        table, counts, nbr, query, q_valid, k, r2 = args
        planes = grid_topk.planes(table, nbr, query, q_valid, r2)
        got = grid_topk.topk_smallest(*planes, k)
        if not (torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])):
            raise AssertionError("KITTI B=2 chunk: K10 on the candidate "
                                 "planes differs from K5")
        topk_calls.append(((*planes, k), {}, got))
    del calls
    kerrs.update(hold("KITTI B=2 chunk", TOPK_KERNELS, mods,
                      {"topk_smallest": topk_calls}))
    del topk_calls
    busy = device_ms(lambda: P.predict(kmodel, kchunk.pos, kchunk.x,
                                       kchunk.curve_id, kchunk.valid), reps=1)
    log(f"KITTI: device busy {busy:.2f} ms a B=2 chunk; "
        f"{sum(waits.values())} host waits a TTA scan, by line: {waits}")
    del kstaged, ktta, kmodel, kchunk
    errs = {k: max(errs.get(k, 0.0), kerrs.get(k, 0.0))
            for k in set(errs) | set(kerrs)}

    # the object loops through main
    for label, name, keys in [
            ("eval_loop_shapenet_seg", "shapenet-seg",
             ("instance_miou", "category_miou")),
            ("eval_loop_shapenet_class", "shapenet-class",
             ("accuracy", "balanced_accuracy"))]:
        cfg = cfg_of(name, label, n_val=OBJECT_N_VAL,
                     eval_batch_size=OBJECT_BATCH)
        score, by_path[label], wall, logged = counted_main(cfg)
        info, val_ds, model = M.build(cfg)
        batches = -(-OBJECT_N_VAL // OBJECT_BATCH)
        check_launches(label, by_path[label],
                       kernel_launches(model.spec, val_ds.n_pad), batches)
        if not all(np.isfinite(logged.get(k, np.nan)) for k in keys):
            raise AssertionError(f"{label}: logged {logged}")
        # the kernel calls of one batch of the loop's forward
        batch = D.to_device_batch(next(D.batch_iterator(val_ds,
                                                        OBJECT_BATCH)),
                                  info.task, dev)
        fwd = T.make_tta_eval(model)
        calls, _ = capture(V1_KERNELS, mods, lambda: fwd(
            batch.cloud, views[0][0], views[0][1], batch.categories))
        for k, e in hold(f"{name} batch of {OBJECT_BATCH}", V1_KERNELS,
                         mods, calls).items():
            errs[k] = max(errs.get(k, 0.0), e)
        del calls, batch
        t0 = time.perf_counter()
        M.run_eval(model, val_ds, info, cfg, **quiet)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / batches
        log(f"main --only_val {name} ({OBJECT_N_VAL} scans, batches of "
            f"{OBJECT_BATCH}, n_pad {val_ds.n_pad}): {wall:.2f} s; "
            + ", ".join(f"{k} {logged[k]:.4g}" for k in keys)
            + f"; the loop again: {ms:.1f} ms a batch")
        del model

    # only_test: the submission file of a scan with a nuScenes meta
    cfg = cfg_of("nuscenes", "nuscenes_test", n_val=1, only_val=False,
                 only_test=True)
    load = M.load_datasets
    with replaced(M, "load_datasets",
                  lambda c: (lambda tr, va: (tr, WithMeta(va)))(*load(c))):
        M.main(cfg)
    path = os.path.join(cfg["outdir"], "results", "lidarseg", "test",
                        "scan0.bin")
    pred = np.fromfile(path, np.uint8)
    n_valid = len(load(cfg)[1].get(0).pos)
    if len(pred) != n_valid or pred.min() < 1 or pred.max() > 16:
        raise AssertionError(f"{path}: {len(pred)} predictions in "
                             f"[{pred.min()}, {pred.max()}], want {n_valid} "
                             "in [1, 16]")
    log(f"main --only_test nuScenes: {path} holds {len(pred)} predictions "
        f"(the scan's valid points), classes {pred.min()}-{pred.max()}")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return errs, by_path


def step_runner(model, state0, batch, loss_cfg, mods, dev):
    """fn(plain_path=False, shaken=False, lr=LR) -> (loss, ms, peak bytes):
    one train step of ``model`` from a fresh copy of the weights
    ``state0``, through the kernels or (``plain_path``) every kernel's
    plain version, the weights x (1 + 1e-5 noise) with ``shaken``."""
    import torch

    from curvecloudnet_tpu_torch.train import train_step
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    def one_step(plain_path=False, shaken=False, lr=LR):
        model.load_state_dict(state0)
        if shaken:
            g = torch.Generator(device=dev).manual_seed(5)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-5 * torch.randn(p.shape, generator=g,
                                                  device=dev))
        opt = create_optimizer(model)
        gen = torch.Generator(device=dev).manual_seed(0)
        with contextlib.ExitStack() as stack:
            if plain_path:
                for name, mod, wrapper, ref_name, *_ in (
                        EVAL_KERNELS + TRAIN_KERNELS + PLAIN_CHAINS):
                    m = mods[mod]
                    stack.enter_context(replaced(m, wrapper,
                                                 getattr(m, ref_name)))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(model, opt, lr, batch, gen, 0.1, loss_cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return float(out["loss"]), ms, torch.cuda.max_memory_allocated()

    return one_step


def hold_step(label, one_step, model):
    """Phases 8 and 17: one step from the same weights through the kernels
    and through the plain versions (and the plain versions on perturbed
    weights, the yardstick); raises past the tolerances -> {path: (loss,
    ms, peak bytes, grads, buffers)}."""
    results = {}
    for what, plain_path, shaken in [("kernel", False, False),
                                     ("plain", True, False),
                                     ("plain, weights x (1 + 1e-5 noise)",
                                      True, True)]:
        loss, ms, peak = one_step(plain_path, shaken)
        results[what] = (loss, ms, peak, *grads_and_stats(model))
        log(f"{label} one step, {what} path: loss {loss:.8g}, {ms:.1f} ms, "
            f"peak memory {peak / 2**30:.2f} GiB")
    k_loss, _, _, k_grads, k_bufs = results["kernel"]
    p_loss, _, _, p_grads, p_bufs = results["plain"]
    _, _, _, s_grads, s_bufs = results["plain, weights x (1 + 1e-5 noise)"]
    if abs(k_loss - p_loss) > 1e-4 * abs(p_loss):
        raise AssertionError(f"{label} loss: kernel {k_loss} vs plain "
                             f"{p_loss}")
    stat_bar = stat_yard = 0
    for name, v in p_bufs.items():
        scale = max(1.0, float(v.abs().max()))
        err = float((k_bufs[name] - v).abs().max())
        if err <= 1e-5 * scale:
            stat_bar += 1
            continue
        noise = float((s_bufs[name] - v).abs().max())
        log(f"  running statistic {name}: err {err:.3g} > 1e-5 x {scale:.3g};"
            f" plain path's 1e-5-perturbation change {noise:.3g}")
        if err > 3 * noise + 1e-5 * scale:
            raise AssertionError(f"{label} running statistic {name} differs "
                                 f"by {err}")
        stat_yard += 1
    log(f"{label} running statistics: {stat_bar} within 1e-5, {stat_yard} "
        f"within the perturbation yardstick")
    if k_grads.keys() != p_grads.keys():
        raise AssertionError(f"{label} gradients: different parameter sets")
    bar = yardstick = 0
    worst = (0.0, "")
    # gradients that are zero in exact arithmetic (a bias before a BN) are
    # rounding noise on both paths: floored at 1e-5 of the largest gradient
    floor = 1e-5 * max(float(g.abs().max()) for g in p_grads.values())
    for name, g in p_grads.items():
        scale = float(g.abs().max())
        err = float((k_grads[name] - g).abs().max())
        if err <= 2e-3 * scale:
            bar += 1
            continue
        noise = float((s_grads[name] - g).abs().max())
        ratio = err / (3 * noise + 2e-3 * scale + floor)
        worst = max(worst, (ratio, name))
        log(f"  gradient {name}: err {err:.3g} of max {scale:.3g} > 2e-3; "
            f"plain path's 1e-5-perturbation change {noise:.3g}")
        if ratio > 1:
            raise AssertionError(f"{label} gradient {name}: err {err} beyond "
                                 f"3 x {noise} + 2e-3 x {scale} + {floor}")
        yardstick += 1
    log(f"{label} gradients: {bar} within 2e-3 of their max, {yardstick} "
        f"within the perturbation yardstick (worst {worst[0]:.3g} of its "
        f"bound, {worst[1]})")
    return results


def hold_train(label, kernels, mods, calls):
    """Each recorded call of a train step held against its plain version
    as phase 6 holds it (no timing): the train kernels through
    :func:`compare_train`, K3 / K5 / K6 through :func:`compare` on the
    call's own output -> {name: max err}."""
    import torch

    train_names = {k[0] for k in TRAIN_KERNELS + BF16_TRAIN_KERNELS}
    worst = {}
    for name, mod, wrapper, ref_name, *_, tol in kernels:
        ref = getattr(mods[mod], ref_name)
        errs = [0.0]
        with torch.no_grad():
            for args, kwargs, out in calls[name]:
                if name in train_names:
                    errs.append(compare_train(name, args, kwargs, out, ref,
                                              tol)[0])
                else:
                    errs.append(compare(name, out, ref(*args, **kwargs),
                                        tol))
        worst[name] = max(errs)
        log(f"  {label} {name}: {len(calls[name])} calls, max abs err "
            f"{worst[name]:.3g}")
    return worst


def k7_dead_dout(label, spec, calls):
    """The K7 contract at every site of a captured step: ``dout`` exactly 0
    at each query with no live slot (a query slot past the sampling budget
    among them), whose rows the kernels drop."""
    by_h1 = {(a[0].data_ptr(), tuple(a[0].shape)): a[7]
             for a, _, _ in calls["group_train_bwd"]}
    dead_total = 0
    for args, _, _ in calls["group_train_fwd"]:
        mask = args[1]
        dout = by_h1[(args[0].data_ptr(), tuple(args[0].shape))]
        dead = ~mask.any(-1)
        dead_total += int(dead.sum())
        if bool((dout[dead] != 0).any()):
            raise AssertionError(f"{label} K7: dout is not 0 at a query "
                                 "with no live slot")
    log(f"{label} K7: {len(calls['group_train_fwd'])} sites, "
        f"{dead_total} queries with no live slot, dout 0 at all")


def run_train17(P, mods, dev, kernel_launches, label, config, timed):
    """Phase 17, one config's train path -> (launches of its steps, {kernel:
    worst error of its capture step})."""
    import torch

    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.run.tasks import loss_for
    from curvecloudnet_tpu_torch.tools.tta_walls import host_syncs
    from curvecloudnet_tpu_torch.train import train_step
    from curvecloudnet_tpu_torch.train.__main__ import train_batch
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    t_path = time.perf_counter()
    kitti = config == KITTI_CONFIG
    n_pad = P.n_pad_of(config)
    loss_cfg = loss_for(load_config(config))
    model = P.build_model(config, n_pad, dev).train()
    batch = train_batch(config, 0, n_pad, dev)
    state0 = copy.deepcopy(model.state_dict())
    one_step = step_runner(model, state0, batch, loss_cfg, mods, dev)
    held = TRAIN_KERNELS + TRAIN_HELD + (GRID_HELD if kitti else [])
    calls, (cap_loss, cap_ms, cap_peak) = capture(
        held, mods, lambda: one_step(lr=0.0))
    log(f"{label} capture step: B {batch.cloud.valid.shape[0]}, n_pad "
        f"{n_pad}, {int(batch.cloud.valid.sum())} valid points, loss "
        f"{cap_loss:.6g}, {cap_ms:.1f} ms, peak {cap_peak / 2**30:.2f} GiB")
    k7_dead_dout(label, model.spec, calls)
    if timed:
        per_call = {}
        live = [k for k in TRAIN_KERNELS if calls[k[0]]]
        worst = {name: row["max_abs_err"] for name, row in measure(
            live, mods, calls, train=True, per_call=per_call).items()}
        k7_sites(model.spec, calls, per_call, mods["group_train"], label)
        worst.update(hold_train(label, TRAIN_HELD, mods, calls))
    else:
        worst = hold_train(label, held, mods, calls)
    k7_flips(f"{label} seed 0", calls)
    del calls
    if label == WITNESS17:
        k7 = [k for k in TRAIN_KERNELS if k[1] == "group_train"]
        step1 = step_runner(model, state0, train_batch(config, 1, n_pad, dev),
                            loss_cfg, mods, dev)
        calls, _ = capture(k7, mods, lambda: step1(lr=0.0))
        for name, e in hold_train(f"{label} seed 1", k7, mods,
                                  calls).items():
            worst[name] = max(worst[name], e)
        k7_flips(f"{label} seed 1", calls)
        del calls, step1

    # three steps, launches counted; a step's device busy ms and host waits
    want = kernel_launches(model.spec, n_pad, train=True)
    counted = TRAIN_COUNTED + (
        [("grid_topk", "grid_topk", "grid_topk_records")] if kitti else [])
    for name, mod, wrapper in counted:
        getattr(mods[mod], wrapper).launches = 0
    model.load_state_dict(state0)
    opt = create_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []

    def step():
        return train_step(model, opt, LR, batch, gen, 0.1, loss_cfg)

    for _ in range(TRAIN17_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w in counted}
    log(f"{label} launches:", launched, "spec per step:", want)
    for name, got in launched.items():
        if got != TRAIN17_STEPS * want.get(name, 0):
            raise AssertionError(f"{name}: {got} {label} launches, want "
                                 f"{TRAIN17_STEPS} x {want.get(name, 0)}")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"{label} losses not finite: {losses}")
    busy = device_ms(step, reps=1)
    waits = host_syncs(step)
    log(f"{label} steps: losses {losses}, walls {[round(w, 1) for w in walls]}"
        f" ms, device busy {busy:.2f} ms a step, host waits a step {waits}, "
        f"peak memory {peak / 2**30:.2f} GiB")
    if not kitti:
        hold_step(label, one_step, model)
    log(f"{label}: {time.perf_counter() - t_path:.1f} s")
    return launched, worst


def run_loops(P, mods, dev, kernel_launches):
    """Phase 17, ``main``'s epoch loop on shapenet-class (then resumed) and
    nuScenes -> launches by path."""
    import torch

    from curvecloudnet_tpu_torch import main as M
    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.models import parse_model_config
    from curvecloudnet_tpu_torch.run import tasks as T

    def loop(label, name, overrides, val_forwards):
        """``main.main`` training ``name`` with ``overrides``; launches
        checked against the spec's train count x steps + eval count x
        val forwards -> (launches, step (ms, peak bytes) list, cfg)."""
        cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
        cfg.update(device=str(dev), outdir=os.path.join(OUT17, label),
                   **overrides)
        train_ds, _ = M.load_datasets(cfg)
        info = T.task_for(cfg["dataset_source"], cfg["task"])
        spec = parse_model_config(cfg["model"], in_dim=train_ds.in_dim,
                                  n_out=info.n_out)
        resumed = M.ckpt.read_latest_state(cfg["outdir"])
        epochs = cfg["epochs"] - (0 if resumed is None
                                  else resumed["epoch"] + 1)
        steps = len(train_ds) // int(cfg["batch_size"])
        want = {}
        for counts, times in ((kernel_launches(spec, train_ds.n_pad,
                                               train=True), steps),
                              (kernel_launches(spec, train_ds.n_pad),
                               val_forwards)):
            for k, v in counts.items():
                want[k] = want.get(k, 0) + epochs * times * v
        for _, mod, wrapper in LOOP_COUNTED:
            getattr(mods[mod], wrapper).launches = 0
        timed, inner = [], M.train_step

        def train_step(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            timed.append(((time.perf_counter() - t0) * 1e3,
                          torch.cuda.max_memory_allocated()))
            return out

        t0 = time.perf_counter()
        with replaced(M, "train_step", train_step):
            score = M.main(cfg)
        wall = time.perf_counter() - t0
        launched = {name_: getattr(mods[mod], w).launches
                    for name_, mod, w in LOOP_COUNTED}
        log(f"{label}: {len(timed)} steps in {epochs} epochs, score "
            f"{score}, {wall:.1f} s; launches {launched}")
        for k, got in launched.items():
            if got != want.get(k, 0):
                raise AssertionError(f"{label} {k}: {got} launches, want "
                                     f"{want.get(k, 0)}")
        if len(timed) != epochs * steps or not score == score:
            raise AssertionError(f"{label}: {len(timed)} steps, score "
                                 f"{score}")
        return launched, timed, cfg

    shutil.rmtree(OUT17, ignore_errors=True)
    by_path = {}
    common = dict(n_train=48, n_val=16, num_workers=2)
    launched, timed, cfg = loop("train_loop_shapenet_class",
                                "shapenet-class", dict(common, epochs=2), 2)
    outdir = cfg["outdir"]
    files = sorted(os.listdir(outdir))
    state = M.ckpt.read_latest_state(outdir)
    log(f"shapenet-class loop: steps (ms, GiB) "
        f"{[(round(ms, 1), round(b / 2**30, 2)) for ms, b in timed]}; "
        f"outdir {files}; latest_state {state}")
    if not (any(f.startswith("best_epoch") for f in files) and "latest"
            in files and state["epoch"] == 1):
        raise AssertionError(f"shapenet-class loop: outdir {files}, {state}")
    again, timed, _ = loop("train_loop_shapenet_class", "shapenet-class",
                           dict(common, epochs=3), 2)
    state = M.ckpt.read_latest_state(outdir)
    log(f"shapenet-class loop resumed to 3 epochs: {len(timed)} steps "
        f"(epoch 2 only), latest_state {state}")
    if state["epoch"] != 2:
        raise AssertionError(f"shapenet-class resume: {state}")
    by_path["train_loop_shapenet_class"] = {
        k: launched[k] + again[k] for k in launched}
    # 2 val scans, each 12 TTA views in chunks of 2: 12 eval forwards
    launched, timed, cfg = loop(
        "train_loop_nuscenes", "nuscenes",
        dict(n_train=6, n_val=2, epochs=1, num_workers=2),
        2 * (T.N_VIEWS // 2))
    ms, peak = timed[0]
    log(f"nuScenes loop: a B=6 step at n_pad {cfg['n_pad']} {ms:.1f} ms, peak "
        f"{peak / 2**30:.2f} GiB")
    by_path["train_loop_nuscenes"] = launched
    return by_path


def loader_waits(record):
    """A ``PrefetchLoader.epoch`` that, for shuffled (train) loaders,
    records each batch's ``n_pad_dropped`` and points a sample (after
    augmentation, before padding), the consumer's waits for the next
    batch and the loop's wall from its first request to its end."""
    from curvecloudnet_tpu_torch.data.loader import PrefetchLoader

    inner = PrefetchLoader.epoch

    def epoch(loader, epoch_=0):
        batches = inner(loader, epoch_)
        if not loader.shuffle:
            yield from batches
            return
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                break
            record["wait_s"] += time.perf_counter() - t0
            dropped = batch["n_pad_dropped"]
            record["dropped"].append(dropped.tolist())
            record["points"].append(
                (batch["valid"].sum(-1) + dropped).tolist())
            yield batch
        record["loop_s"] += time.perf_counter() - t_start

    return epoch


def reader_ms(ds, augment, n=HOST18_SAMPLES):
    """Host ms a sample of ``ds.get`` + ``collate`` (one warm-up first)."""
    import numpy as np

    from curvecloudnet_tpu_torch.data.datasets import collate

    rng = np.random.default_rng(0)
    collate(ds, [ds.get(0, rng, augment)])
    t0 = time.perf_counter()
    for i in range(n):
        collate(ds, [ds.get(i % len(ds), rng, augment)])
    return (time.perf_counter() - t0) * 1e3 / n


def check_submission(name, val_ds, dumped, outdir):
    """Each submission file: one prediction a point of its frame, in the
    frame's original order, equal to the argmax of the mean logits the
    loop dumped, mapped as the benchmark reads it -> files checked."""
    import numpy as np

    from curvecloudnet_tpu_torch.run.globals import KITTI_LEARNING_MAP_INV

    lidar_of = {os.path.basename(seg or ""): lp
                for lp, seg, _ in getattr(val_ds, "pairs", [])}
    lut = np.zeros(max(KITTI_LEARNING_MAP_INV) + 1, np.uint32)
    for a, b in KITTI_LEARNING_MAP_INV.items():
        lut[a] = b
    checked = 0
    for mean_logits, valid, metas in dumped:
        for k, meta in enumerate(metas):
            logits = mean_logits[k].numpy()[valid[k].numpy()]
            if name == "kitti":
                n = len(np.fromfile(meta["fpath"], np.float32)) // 4
                want = lut[np.argmax(logits, -1)]   # KITTI keeps its order
                parts = meta["fpath"].split(os.sep)
                path = os.path.join(outdir, "method_predictions", "sequences",
                                    parts[-3], "predictions",
                                    parts[-1][:-4] + ".label")
                got = np.fromfile(path, np.uint32)
            else:
                raw = np.fromfile(lidar_of[meta["fname"]],
                                  np.float32).reshape(-1, 5)
                n = len(raw)
                # the reader's order is the stable ring sort of the file's
                order = np.argsort(raw[:, 4].astype(np.int64), kind="stable")
                want = np.empty(n, np.uint8)
                want[order] = np.argmax(logits[:, 1:], -1) + 1
                got = np.fromfile(os.path.join(
                    outdir, "results", "lidarseg", "test", meta["fname"]),
                    np.uint8)
            if len(got) != n or len(logits) != n or \
                    not np.array_equal(got, want):
                raise AssertionError(
                    f"{name} submission for {meta}: {len(got)} predictions "
                    f"for {n} points, equal to the dumped argmax: "
                    f"{np.array_equal(got[:len(want)], want[:len(got)])}")
            checked += 1
    return checked


def run_disk(P, mods, dev, kernel_launches, label, name, frames):
    """Phase 18, one config from files on disk -> (launches by path,
    {kernel: worst error of its held calls})."""
    import torch

    from curvecloudnet_tpu_torch import main as M
    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.data import datasets as D
    from curvecloudnet_tpu_torch.data.loader import PrefetchLoader
    from curvecloudnet_tpu_torch.models import parse_model_config
    from curvecloudnet_tpu_torch.run import tasks as T
    from curvecloudnet_tpu_torch.tools import calibrate
    from curvecloudnet_tpu_torch.tools import fake_datasets as F

    t_path = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    t0 = time.perf_counter()
    root = F.write_for_config(cfg, os.path.join(OUT18, "data", name), frames,
                              seed=18)
    write_s = time.perf_counter() - t0
    outdir = os.path.join(OUT18, label)
    cfg.update(device=str(dev), data_path=root, outdir=outdir, epochs=1,
               val_every=1, save_every=100)
    train_ds, val_ds = M.load_datasets(cfg)
    info = T.task_for(cfg["dataset_source"], cfg["task"])
    lidar = info.task == "segmentation" and not info.part_iou
    sizes = [len(train_ds.get(i).pos) for i in range(len(train_ds))]
    log(f"{label}: wrote {sum(frames.values())} files in {write_s:.1f} s "
        f"under {root}; {type(train_ds).__name__} train {len(train_ds)} / "
        f"val {len(val_ds)}, points a sample {min(sizes)}-{max(sizes)}, "
        f"n_pad {train_ds.n_pad}")

    # the readers' host ms a sample (get + collate), with and without
    # PolarMix where the config mixes
    host = {"augment": reader_ms(train_ds, True),
            "val": reader_ms(val_ds, False)}
    if getattr(train_ds, "polarmix_aug", False):
        train_ds.polarmix_aug = False
        host["augment, no PolarMix"] = reader_ms(train_ds, True)
        train_ds.polarmix_aug = True
    log(f"{label} reader host ms a sample (get + collate): "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))

    # main trains one epoch from the files and validates (nuScenes and
    # KITTI under 12-view TTA in chunks of 2, A2D2 without TTA, as the
    # task has it; objects in batches of 8)
    spec = parse_model_config(cfg["model"], in_dim=train_ds.in_dim,
                              n_out=info.n_out)
    steps = len(train_ds) // int(cfg["batch_size"])
    tta = info.tta if cfg.get("use_tta") is None else bool(cfg["use_tta"])
    val_forwards = (len(val_ds) * (T.N_VIEWS // 2 if tta else 1) if lidar
                    else -(-len(val_ds) // 8))
    want = {}
    for counts, times in ((kernel_launches(spec, train_ds.n_pad, train=True),
                           steps),
                          (kernel_launches(spec, train_ds.n_pad),
                           val_forwards)):
        for k, v in counts.items():
            want[k] = want.get(k, 0) + times * v
    for _, mod, wrapper in LOOP_COUNTED:
        getattr(mods[mod], wrapper).launches = 0
    timed, inner = [], M.train_step
    record = {"wait_s": 0.0, "loop_s": 0.0, "dropped": [], "points": []}

    def train_step(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        timed.append(((time.perf_counter() - t0) * 1e3,
                      torch.cuda.max_memory_allocated()))
        return out

    shutil.rmtree(outdir, ignore_errors=True)
    t0 = time.perf_counter()
    with replaced(M, "train_step", train_step), \
            replaced(PrefetchLoader, "epoch", loader_waits(record)):
        score = M.main(cfg)
    wall = time.perf_counter() - t0
    launched = {k: getattr(mods[mod], w).launches
                for k, mod, w in LOOP_COUNTED}
    log(f"{label}: main trained {len(timed)} steps at B "
        f"{cfg['batch_size']} and validated {len(val_ds)} scans in "
        f"{wall:.1f} s, score {score}; step (ms, GiB) "
        f"{[(round(ms, 1), round(b / 2**30, 2)) for ms, b in timed]}; "
        f"points a sample {record['points']}, n_pad_dropped "
        f"{record['dropped']} a batch; loader waits "
        f"{record['wait_s'] * 1e3:.1f} ms of the train loop's "
        f"{record['loop_s'] * 1e3:.1f} ms "
        f"({record['wait_s'] / max(record['loop_s'], 1e-9):.3f})")
    log(f"{label} launches {launched}")
    for k, got in launched.items():
        if got != want.get(k, 0):
            raise AssertionError(f"{label} {k}: {got} launches, want "
                                 f"{want.get(k, 0)}")
    if len(timed) != steps or not score == score:
        raise AssertionError(f"{label}: {len(timed)} steps, score {score}")
    by_path = {label: launched}

    # every telemetry channel's maximum over val scans, the trained weights
    trained = dict(cfg, weights=os.path.join(outdir, "latest"))
    _, _, model = M.build(trained)
    totals = calibrate.collect(model, val_ds, TELEMETRY18_SCANS, info.task)
    log(f"{label} telemetry max over {TELEMETRY18_SCANS} val scans: "
        + str({k: max(v) for k, v in sorted(totals.items())}))
    del model

    # --only_test: the submission files of the val frames
    if name in ("kitti", "nuscenes"):
        test_out = os.path.join(OUT18, label + "_test")
        shutil.rmtree(test_out, ignore_errors=True)
        for _, mod, wrapper, *_ in EVAL_KERNELS + GRID_HELD:
            getattr(mods[mod], wrapper).launches = 0
        dumped, dump = [], T.dump_submission

        def spy(mean_logits, valid, metas, out):
            dumped.append((mean_logits, valid, metas))
            return dump(mean_logits, valid, metas, out)

        t0 = time.perf_counter()
        with replaced(T, "dump_submission", spy):
            M.main(dict(trained, only_test=True, outdir=test_out))
        test_s = time.perf_counter() - t0
        got = {k: getattr(mods[mod], w).launches
               for k, mod, w, *_ in EVAL_KERNELS + GRID_HELD}
        per = kernel_launches(spec, val_ds.n_pad)
        for k, n in got.items():
            if n != len(val_ds) * (T.N_VIEWS // 2) * per.get(k, 0):
                raise AssertionError(f"{label} --only_test {k}: {n} "
                                     "launches")
        files = check_submission(name, val_ds, dumped, test_out)
        by_path[label + "_test"] = got
        log(f"{label} --only_test: {files} submission files in "
            f"{test_s:.1f} s, one prediction a point in each frame's "
            f"order; launches {got}")

    # one batch read from disk through the kernels and the plain versions:
    # a train step (phase 6's holds) and an eval forward (phase 3's)
    kitti = name == "kitti"
    _, train_ds, val_ds, model, _, _ = M._setup(
        dict(cfg, outdir=os.path.join(OUT18, label + "_hold")))
    b_train = int(cfg["batch_size"]) if not lidar else 1
    np_batch = next(PrefetchLoader(train_ds, b_train, shuffle=True, seed=1,
                                   augment=True, num_workers=1).epoch(0))
    batch = D.to_device_batch(np_batch, info.task, dev)
    state0 = copy.deepcopy(model.state_dict())
    one_step = step_runner(model, state0, batch, T.loss_for(cfg), mods, dev)
    held = TRAIN_KERNELS + TRAIN_HELD + (GRID_HELD if kitti else [])
    calls, (loss, ms, peak) = capture(held, mods, lambda: one_step(lr=0.0))
    log(f"{label} capture step on a disk batch: B {b_train}, "
        f"{int(batch.cloud.valid.sum())} valid points, loss {loss:.6g}, "
        f"{ms:.1f} ms, peak {peak / 2**30:.2f} GiB")
    worst = hold_train(f"{label} train", held, mods, calls)
    k7_flips(f"{label} train", calls)
    del calls, one_step
    eval_kernels = (KITTI_KERNELS if kitti else EVAL_KERNELS
                    if name == "nuscenes" else V1_KERNELS)
    np_val = next(D.batch_iterator(val_ds, 1 if lidar else 8))
    vb = D.to_device_batch(np_val, info.task, dev)
    model.eval()
    with torch.inference_mode():
        calls, _ = capture(eval_kernels, mods, lambda: T._forward(
            model, vb.cloud, vb.categories, None, None))
    for k, e in hold(f"{label} eval", eval_kernels, mods, calls).items():
        worst[k] = max(worst.get(k, 0.0), e)
    del calls, model
    log(f"{label}: {time.perf_counter() - t_path:.1f} s")
    return by_path, worst


class GraphReplay:
    """dgcnn's feature-space graph, held fixed across the runs of one
    comparison: the first run of the kernel path records each
    ``neighbors.feature_knn`` table; the plain path's runs take them, and
    each of its own tables (on its own features, which differ from the
    kernel path's by rounding) is compared with the recorded one: a query
    whose neighbor set differs must differ only at a distance tie (a
    swapped point within 1e-4 of the cut's squared distance, relative).
    A 3-D search (positions: the same in every run) is not replayed."""

    TIE = 1e-4

    def __init__(self):
        self.tables, self.at, self.recording, self.check = [], 0, True, True
        self.differ = self.queries = 0

    def patch(self, neighbors):
        real = neighbors.feature_knn

        def feature_knn(x, valid, k, radius=None):
            if x.shape[-1] == 3:
                return real(x, valid, k, radius)
            if self.recording:
                self.tables.append((None, real(x, valid, k, radius)))
                return self.tables[-1][1]
            _, table = self.tables[self.at % len(self.tables)]
            self.at += 1
            if self.check:
                self._check(x, valid, real(x, valid, k, radius)[0], table[0])
            return table
        return replaced(neighbors, "feature_knn", feature_knn)

    def _check(self, x, valid, own, rec):
        import torch

        o = torch.sort(own, -1).values
        r = torch.sort(rec, -1).values
        bad = ((o != r).any(-1) & valid)
        self.queries += int(valid.sum())
        self.differ += int(bad.sum())
        for b, q in bad.nonzero().tolist():
            xs = x[b].double()
            d2 = ((xs - xs[q]) ** 2).sum(-1)
            a, c = set(own[b, q].tolist()) - {-1}, set(rec[b, q].tolist()) - {-1}
            cut = float(d2[list(a | c)].max()) if a | c else 0.0
            for j in a ^ c:
                if abs(float(d2[j]) - cut) > self.TIE * max(cut, 1e-30):
                    raise AssertionError(
                        f"dgcnn graph: query ({b}, {q}) takes point {j} at "
                        f"d2 {float(d2[j]):.6g} in one path only, cut "
                        f"{cut:.6g}: not a distance tie")


def run_options(P, mods, dev, kernel_launches):
    """Phase 19 -> (report rows of the options path, launches by path,
    {kernel: worst error})."""
    import torch

    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.models import (CurveCloudNet,
                                                parse_model_config)
    from curvecloudnet_tpu_torch.ops import neighbors
    from curvecloudnet_tpu_torch.run.tasks import loss_for
    from curvecloudnet_tpu_torch.train import train_step
    from curvecloudnet_tpu_torch.train.__main__ import train_batch
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    t_phase = time.perf_counter()
    label = "options"
    cfg = load_config(OPTIONS_CONFIG)
    spec = parse_model_config(options_model(cfg["model"]),
                              in_dim=P.OBJECT_IN_DIM,
                              n_out=P.N_OUT["shapenet-class"])
    n_pad = P.n_pad_of(OPTIONS_CONFIG)
    model = CurveCloudNet(spec, n_pad)
    P.init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    inputs = P.synthetic_inputs(OPTIONS_CONFIG, 0, n_pad, dev)
    pos, _, _, valid, _ = inputs
    by_path, worst = {}, {}

    # step 0's dgcnn-rad search, and step 5's curve-fps share
    st0 = spec.steps[0]
    if model.in_widths[0] is None and st0.with_xyz:
        kind = "a 3-D ball query on K3 (positions only)"
    else:
        kind = "a feature-space ball (plain torch)"
    with torch.no_grad():
        idx, _ = neighbors.ball_query(pos, pos, valid, valid, st0.radius,
                                      model.steps[0].BALL_K)
    cnt = (idx >= 0).sum(-1)[valid].float()
    log(f"{label} step_0 dgcnn-rad: {kind}, radius {st0.radius}, k 128: "
        f"ball counts mean {float(cnt.mean()):.1f}, max {int(cnt.max())}, "
        f"{int((cnt == 128).sum())} of {cnt.numel()} queries at the cap")
    seen = {}
    hook = model.steps[5].register_forward_hook(
        lambda m, a, out: seen.update(n_in=int(a[0].valid.sum()),
                                      n_out=int(out.valid.sum()),
                                      slots=out.valid.shape[1]))

    # eval: capture, hold and time every call; launches; kernel vs plain
    replay = GraphReplay()
    with replay.patch(neighbors):
        calls, (logits0, valid0, _) = capture(
            V1_KERNELS, mods, lambda: P.predict(model, *inputs))
    hook.remove()
    log(f"{label} step_5 sa curve-fps at arclength {OPTIONS_ARCLEN}: kept "
        f"{seen['n_out']} of {seen['n_in']} valid points "
        f"({seen['n_out'] / seen['n_in']:.3f}) in {seen['slots']} slots")
    per_call = {}
    report = measure(V1_KERNELS, mods, calls, train=False, per_call=per_call)
    k2_sites(label, spec, calls["group_reduce"], per_call["group_reduce"])
    k3_calls(label, calls["knn"], per_call["knn"], mods["knn"])
    k6_calls(label, calls["fps"], per_call["fps"], mods["fps"])
    del calls
    want = kernel_launches(spec, n_pad)
    for name, mod, wrapper, *_ in EVAL_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, valid1, _ = P.predict(model, *inputs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in EVAL_KERNELS}
    log(f"{label} eval launches:", launched, "spec:", want)
    for name, got in launched.items():
        if got != want.get(name, 0):
            raise AssertionError(f"{name}: {got} {label} eval launches, want "
                                 f"{want.get(name, 0)}")
    by_path["options_eval"] = launched
    if logits.shape != (inputs[0].shape[0], 1, spec.n_out) or not bool(
            torch.isfinite(logits[valid1]).all()):
        raise AssertionError(f"{label}: bad logits {tuple(logits.shape)}")
    busy = device_ms(lambda: P.predict(model, *inputs), reps=1)
    replay.recording = False
    with contextlib.ExitStack() as stack:
        stack.enter_context(replay.patch(neighbors))
        for name, mod, wrapper, ref_name, *_ in EVAL_KERNELS:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        plain = P.predict(model, *inputs)[0]
    err = float((logits0 - plain)[valid0].abs().max())
    log(f"{label} eval: B {inputs[0].shape[0]}, n_pad {n_pad}, wall "
        f"{wall:.1f} ms, {busy:.2f} ms device busy, peak memory {peak:.2f} "
        f"GiB; logits kernel vs plain path max abs err {err:.3g}; dgcnn "
        f"graph of the plain path's own features: {replay.differ} of "
        f"{replay.queries} queries differ, at distance ties")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{label} logits differ from the plain path by "
                             f"{err}")

    # train: a capture step held and timed, K7's sites and slope flips,
    # one counted step, the kernel step against the plain step
    loss_cfg = loss_for(cfg)
    batch = train_batch(OPTIONS_CONFIG, 0, n_pad, dev)
    model.train()
    state0 = copy.deepcopy(model.state_dict())
    one_step = step_runner(model, state0, batch, loss_cfg, mods, dev)
    calls, (cap_loss, cap_ms, cap_peak) = capture(
        TRAIN_KERNELS + TRAIN_HELD, mods, lambda: one_step(lr=0.0))
    log(f"{label} capture step: B {batch.cloud.valid.shape[0]}, loss "
        f"{cap_loss:.6g}, {cap_ms:.1f} ms, peak {cap_peak / 2**30:.2f} GiB")
    k7_dead_dout(label, spec, calls)
    per_call = {}
    live = [k for k in TRAIN_KERNELS if calls[k[0]]]
    t_report = measure(live, mods, calls, train=True, per_call=per_call)
    k7_sites(spec, calls, per_call, mods["group_train"], label)
    for name, e in hold_train(label, TRAIN_HELD, mods, calls).items():
        worst[name] = max(worst.get(name, 0.0), e)
    k7_flips(label, calls)
    del calls
    want_t = kernel_launches(spec, n_pad, train=True)
    for name, mod, wrapper in TRAIN_COUNTED:
        getattr(mods[mod], wrapper).launches = 0
    model.load_state_dict(state0)
    opt = create_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(train_step(model, opt, LR, batch, gen, 0.1,
                            loss_cfg)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w in TRAIN_COUNTED}
    log(f"{label} train launches:", launched, "spec:", want_t)
    for name, got in launched.items():
        if got != want_t.get(name, 0):
            raise AssertionError(f"{name}: {got} {label} train launches, "
                                 f"want {want_t.get(name, 0)}")
    if not loss == loss or abs(loss) == float("inf"):
        raise AssertionError(f"{label} train loss not finite: {loss}")
    by_path["options_train"] = launched
    log(f"{label} train step: loss {loss:.6g}, wall {step_ms:.1f} ms, peak "
        f"memory {step_peak:.2f} GiB")
    replay = GraphReplay()
    with replay.patch(neighbors):
        hold_step(label, _recording_first(one_step, replay), model)
    log(f"{label} train: dgcnn graph of the plain paths' own features: "
        f"{replay.differ} of {replay.queries} queries differ, at distance "
        f"ties")
    del model, opt, one_step

    # nuScenes with a one-tap first conv; its fp step 18 without parent_idx
    by_path[NUSCENES_K1], fp_err = run_nuscenes_k1(P, mods, dev,
                                                   kernel_launches)
    worst["knn"] = max(worst.get("knn", 0.0), fp_err)
    report.update(t_report)
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return report, by_path, worst


def _recording_first(one_step, replay):
    """``one_step`` whose first call (hold_step's kernel path) records the
    dgcnn graph and whose later calls (the plain paths) replay it, the
    second (the plain path on the same weights) checking its own graph."""
    def step(*args, **kwargs):
        try:
            return one_step(*args, **kwargs)
        finally:
            if replay.recording:
                replay.recording = False
            else:
                replay.check = False
    return step


def run_nuscenes_k1(P, mods, dev, kernel_launches):
    """Phase 19's nuScenes path with step 0's ``kernel_size`` 1 (the
    per-curve route, plain torch in both packages): one scan, launches
    against the spec (one K1 fewer than the shipped model's), logits
    kernel vs plain; then its fp step 18 on a cloud with no ``parent_idx``
    (``interpolate.knn_interpolate``: K3 over the whole row), that K3 call
    held -> (launches, K3 err)."""
    import dataclasses

    import torch

    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.models import (CurveCloudNet,
                                                parse_model_config)

    cfg = load_config(CONFIG)
    cfg["model"]["steps"][0]["kernel_size"] = 1
    spec = parse_model_config(cfg["model"], in_dim=P.IN_DIM,
                              n_out=P.N_OUT["nuscenes"])
    model = CurveCloudNet(spec, N_PAD, feat_channels=P.FEAT_CHANNELS)
    P.init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    scan0 = P.synthetic_scan(0, N_PAD, dev)
    want = kernel_launches(spec, N_PAD)
    shipped = kernel_launches(parse_model_config(
        load_config(CONFIG)["model"], in_dim=P.IN_DIM,
        n_out=P.N_OUT["nuscenes"]), N_PAD)
    for name, mod, wrapper, *_ in EVAL_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    fp_in = {}
    hook = model.steps[18].register_forward_pre_hook(
        lambda m, a: fp_in.update(cloud=a[0], skip=a[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, valid, _ = P.predict(model, *scan0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    hook.remove()
    launched = {name: getattr(mods[mod], w).launches
                for name, mod, w, *_ in EVAL_KERNELS}
    log(f"{NUSCENES_K1} launches:", launched, "spec:", want, "shipped "
        f"model's:", shipped)
    for name, got in launched.items():
        if got != want.get(name, 0):
            raise AssertionError(f"{name}: {got} {NUSCENES_K1} launches, "
                                 f"want {want.get(name, 0)}")
    if want["conv1d_chain"] != shipped["conv1d_chain"] - 1:
        raise AssertionError(f"{NUSCENES_K1}: K1 {want['conv1d_chain']}, "
                             f"shipped {shipped['conv1d_chain']}")
    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, ref_name, *_ in EVAL_KERNELS:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        plain = P.predict(model, *scan0)[0]
    err = float((logits - plain)[valid].abs().max())
    log(f"{NUSCENES_K1} scan 0: {wall:.1f} ms wall, logits kernel vs plain "
        f"path max abs err {err:.3g}")
    if not err <= LOGIT_TOL or not bool(torch.isfinite(logits[valid]).all()):
        raise AssertionError(f"{NUSCENES_K1} logits differ from the plain "
                             f"path by {err}")
    fp = model.steps[18]
    cloud = dataclasses.replace(fp_in["cloud"], parent_idx=None)
    knn_k = [k for k in EVAL_KERNELS if k[0] == "knn"]
    with torch.inference_mode():
        calls, up = capture(knn_k, mods, lambda: fp._upsample(
            cloud, fp_in["skip"], fp.step.knn or 3))
        subset = fp._upsample(fp_in["cloud"], fp_in["skip"],
                              fp.step.knn or 3)
    fp_err = hold("fp step_18 without parent_idx", knn_k, mods,
                  calls)["knn"]
    (q, p_, *_), _, _ = calls["knn"][0]
    rows = fp_in["skip"].valid
    log(f"fp step_18 without parent_idx: K3 over {p_.shape[1]} source "
        f"points for {q.shape[1]} queries, kernel vs plain err {fp_err:.3g};"
        f" features vs the parent_idx route max abs diff "
        f"{float((up - subset)[rows].abs().max()):.3g}")
    return launched, fp_err


def bf16_config(name):
    """configs/<name>.yaml with its model block set to bfloat16, written
    under ``OUT20`` -> the file's path."""
    import yaml

    from curvecloudnet_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    cfg["model"]["compute_dtype"] = "bfloat16"
    os.makedirs(OUT20, exist_ok=True)
    path = os.path.join(OUT20, f"{name}_bf16.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def step_dtypes(model, run):
    """The dtype of each step's output features in one forward ``run()``."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda _m, _a, out, i=i: seen.__setitem__(
            i, str(out.x.dtype).replace("torch.", "")))
        for i, m in enumerate(model.steps)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return [seen[i] for i in range(len(model.steps))]


@contextlib.contextmanager
def plain_path(mods, kernels):
    """Every listed wrapper replaced by its plain version (a bfloat16
    variant is reached through its float32 twin, so the twin's plain
    version takes its calls too)."""
    with contextlib.ExitStack() as stack:
        for _, mod, wrapper, ref_name, *_ in kernels:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        yield


def counted(mods, kernels, run):
    """``run()`` with every listed wrapper's count set to 0 just before ->
    (its result, {name: launches})."""
    import torch

    for _, mod, wrapper, *_ in kernels:
        getattr(mods[mod], wrapper).launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: getattr(mods[mod], w).launches
                 for name, mod, w, *_ in kernels}


def check_bf16_launches(label, launched, want, times):
    """A bfloat16 path's launches: each kernel's float32 and bfloat16
    variants together ``times`` x the spec's count (``kernel_launches``,
    which counts kernels, not variants)."""
    log(f"{label} launches:", launched, f"spec x {times}:", want)
    for name in want:
        got = launched.get(name, 0) + launched.get(name + "_bf16", 0)
        if got != times * want[name]:
            raise AssertionError(f"{name}: {got} launches on {label} (both "
                                 f"dtypes), want {times} x {want[name]}")


def hold_bf16_logits(label, got, ref, p16, p32, valid):
    """bfloat16 logits ``got`` against ``ref`` (the plain path's, or the
    group route's) within ``BF16_MAX_FACTOR`` x the plain path's own
    bf16-vs-f32 gap (``p16``, ``p32``: the bfloat16 and float32 plain
    logits; max abs over live rows), and as accurate against float32 as
    the plain path on average (``BF16_MEAN_FACTOR``)."""
    err = (got.float() - ref.float())[valid].abs()
    gap = (p16 - p32)[valid].abs()
    acc = (got.float() - p32)[valid].abs()
    log(f"{label}: logits max abs err {float(err.max()):.4g}"
        f" (mean {float(err.mean()):.3g}); the plain path's own bf16 vs f32 "
        f"gap {float(gap.max()):.4g} (mean {float(gap.mean()):.3g}); vs the "
        f"f32 plain path max {float(acc.max()):.4g} (mean "
        f"{float(acc.mean()):.3g}); {int(valid.sum())} valid points")
    if not (0 < float(gap.max())
            and float(err.max()) <= BF16_MAX_FACTOR * float(gap.max())
            and float(acc.mean()) <= BF16_MEAN_FACTOR * float(gap.mean())):
        raise AssertionError(f"{label}: bf16 logits {float(err.max())} off "
                             f"(gap {float(gap.max())}), mean error vs f32 "
                             f"{float(acc.mean())} (plain bf16 "
                             f"{float(gap.mean())})")


def busy_by_group(fn, groups_of=None):
    """Device busy ms of one ``fn()`` by ``tools/profile_scan``'s groups
    (or ``groups_of``'s: ``tools/profile_train``'s for a train step;
    ``torch.profiler``, after a warm-up run) -> (busy, {group: ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from curvecloudnet_tpu_torch.tools.profile_scan import GROUPS

    groups_of = groups_of or GROUPS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            g = next((g for g, key in groups_of if key in e.key), "other")
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    return sum(groups.values()), {g: round(v, 3) for g, v in
                                  sorted(groups.items(), key=lambda x: -x[1])}


def run_bf16(P, mods, dev, kernel_launches):
    """Phase 20: bfloat16 serving -> (report rows of the bfloat16 kernels,
    launches by path).

    ``bf16_eval``: the flagship in bfloat16 at full width on the group
    route, seeds ``BF16_SEEDS``: the per-step output dtypes equal the CPU
    path's (step 0's conv float32, the rest bfloat16); every K1-bf16,
    K2-bf16 and K4-bf16 call of scan 0 held against its plain version and
    timed; launches of both dtypes equal the float32 scan's; each scan's
    logits within the plain path's own bfloat16-vs-float32 gap of the
    plain path's (max abs over live rows); then scan walls (median and
    quartiles of ``BF16_WALL_SCANS`` scans of each dtype, in turns), busy
    ms by group and peak memory of each dtype.  ``bf16_fused``: the fused
    route (K9 on bfloat16 rows) against the group route's logits at the
    same bound, each K9 call held and timed.  ``bf16_tta``: ``main
    --only_val --model.compute_dtype bfloat16`` (``config.parse_args``) on
    ``BF16_N_VAL`` val scans, 2 views a call, launches, the TTA scan
    wall.  ``bf16_objects``: shapenet-seg at its batch (24) in bfloat16,
    every bfloat16 call held, logits at the same bound."""
    import numpy as np
    import torch

    from curvecloudnet_tpu_torch import config as C
    from curvecloudnet_tpu_torch import main as M

    t_phase = time.perf_counter()
    eval_all = EVAL_KERNELS + BF16_KERNELS
    route_all = eval_all + EDGE_KERNELS + EDGE_BF16_KERNELS
    config = bf16_config("nuscenes")
    model = P.build_model(config, N_PAD, dev)
    f32 = P.build_model(CONFIG, N_PAD, dev)
    cpu = P.build_model(config, 1024, "cpu")
    cpu_scan = P.synthetic_scan(0, 1024, "cpu")
    want_dt = step_dtypes(cpu, lambda: P.predict(cpu, *cpu_scan))
    del cpu, cpu_scan
    scans = [P.synthetic_scan(s, N_PAD, dev) for s in BF16_SEEDS]
    got_dt = step_dtypes(model, lambda: P.predict(model, *scans[0]))
    log(f"bf16_eval per-step output dtypes: {got_dt}")
    if got_dt != want_dt:
        raise AssertionError(f"bf16 step dtypes {got_dt}, on the CPU "
                             f"{want_dt}")

    # scan 0's bfloat16 calls held against their plain versions, timed
    calls, _ = capture(BF16_KERNELS, mods,
                       lambda: P.predict(model, *scans[0]))
    per_call = {}
    convs = conv_labels(model.spec, {})["conv1d_chain"]
    report = measure(BF16_KERNELS, mods, calls, train=False,
                     per_call=per_call,
                     labels={"conv1d_chain_bf16": convs[1:]})
    k2_sites("nuScenes bf16", model.spec, calls["group_reduce_bf16"],
             per_call.get("group_reduce_bf16", []),
             floor_of=("bfloat16 floor", 1 / PEAK_BF16))
    del calls

    # the scans through predict, launches counted
    want = kernel_launches(model.spec, N_PAD)
    outs, launched = counted(mods, eval_all, lambda: [
        P.predict(model, *scan)[:2] for scan in scans])
    by_path = {"bf16_eval": launched}
    check_bf16_launches("bf16_eval", launched, want, len(scans))
    for name in ("conv1d_chain_bf16", "group_reduce_bf16", "gather_bf16"):
        if not launched[name]:
            raise AssertionError(f"{name}: not launched on bf16_eval")

    # the logits against the plain path, at its own bf16-vs-f32 gap
    for seed, (scan, (logits, valid)) in enumerate(zip(scans, outs)):
        if logits.dtype != torch.bfloat16 or not bool(
                torch.isfinite(logits[valid]).all()):
            raise AssertionError(f"bf16 scan {seed}: logits {logits.dtype}")
        with plain_path(mods, EVAL_KERNELS):
            p16 = P.predict(model, *scan)[0].float()
            p32 = P.predict(f32, *scan)[0]
        hold_bf16_logits(f"bf16_eval scan {seed}, kernel vs plain path",
                         logits, p16, p16, p32, valid)
        if seed == 0:
            plain0 = (p16, p32)
    logits0 = outs[0][0]
    del outs

    # walls, busy ms by group and peak memory of each dtype, in turns
    walls = {"float32": [], "bfloat16": []}
    nets = {"float32": f32, "bfloat16": model}
    for _ in range(BF16_WALL_SCANS):
        for dt, net in nets.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P.predict(net, *scans[0])
            torch.cuda.synchronize()
            walls[dt].append((time.perf_counter() - t0) * 1e3)
    for dt, net in nets.items():
        q1, med, q3 = np.percentile(walls[dt], [25, 50, 75])
        busy, groups = busy_by_group(lambda: P.predict(net, *scans[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        P.predict(net, *scans[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"nuScenes scan {dt}, {BF16_WALL_SCANS} scans: wall median "
            f"{med:.2f} ms (quartiles {q1:.2f}, {q3:.2f}; min "
            f"{min(walls[dt]):.2f}); device busy {busy:.2f} ms, by group "
            f"{groups}; peak memory {peak:.2f} GiB")
    del f32

    # bf16_fused: K9 reading bfloat16 rows
    fused = P.build_model(config, N_PAD, dev, edge_kernel="fused")
    (lf, vf), by_path["bf16_fused"] = counted(
        mods, route_all, lambda: P.predict(fused, *scans[0])[:2])
    check_bf16_launches("bf16_fused", by_path["bf16_fused"],
                        kernel_launches(fused.spec, N_PAD,
                                        edge_kernel="fused"), 1)
    if not by_path["bf16_fused"]["edge_mlp_bf16"]:
        raise AssertionError("edge_mlp_bf16: not launched on bf16_fused")
    # against the group route's kernel logits, at scan 0's plain gap
    hold_bf16_logits("bf16_fused vs the group route", lf, logits0, *plain0,
                     vf)
    held = EDGE_BF16_KERNELS + [k for k in BF16_KERNELS
                                if k[0] == "group_reduce_bf16"]
    calls, _ = capture(held, mods, lambda: P.predict(fused, *scans[0]))
    report.update(measure(EDGE_BF16_KERNELS, mods, calls, train=False))
    errs = hold("bf16_fused", held[1:], mods, calls)
    del calls, fused, model, scans

    # bf16_tta: the eval entry with the CLI override
    outdir = os.path.join(OUT20, "tta")
    shutil.rmtree(outdir, ignore_errors=True)
    cfg = C.parse_args(["--config", CONFIG, "--only_val=true",
                        "--model.compute_dtype", "bfloat16",
                        f"--device={dev}", f"--n_val={BF16_N_VAL}",
                        f"--outdir={outdir}"])
    t0 = time.perf_counter()
    score, by_path["bf16_tta"] = counted(mods, eval_all,
                                         lambda: M.main(cfg))
    wall = time.perf_counter() - t0
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        logged = json.loads(f.readlines()[-1])
    info, val_ds, tta_model = M.build(cfg)
    if tta_model.spec.compute_dtype != "bfloat16":
        raise AssertionError("main did not take --model.compute_dtype")
    check_bf16_launches("bf16_tta", by_path["bf16_tta"],
                        kernel_launches(tta_model.spec, val_ds.n_pad),
                        BF16_N_VAL * 6)
    if not (np.isfinite(logged["scan_wall_s"]) and score == logged["miou"]):
        raise AssertionError(f"bf16_tta: logged {logged}")
    log(f"bf16_tta: main --only_val --model.compute_dtype bfloat16, "
        f"{BF16_N_VAL} val scans, 2 views a call: {wall:.2f} s; TTA scan "
        f"wall (scan_wall_s) {logged['scan_wall_s'] * 1e3:.1f} ms, miou "
        f"{logged['miou']:.4g}, peak memory "
        f"{logged['peak_device_memory_gb']:.3f} GB")
    del tta_model

    # bf16_objects: shapenet-seg at its batch, K2-bf16 over 128 planes
    seg = bf16_config(BF16_OBJECTS)
    seg32 = os.path.join(REPO, "configs", f"{BF16_OBJECTS}.yaml")
    n_pad = P.n_pad_of(seg)
    obj = P.build_model(seg, n_pad, dev)
    inputs = P.synthetic_inputs(seg, 0, n_pad, dev)
    (lo, vo), by_path["bf16_objects"] = counted(
        mods, eval_all, lambda: P.predict(obj, *inputs)[:2])
    check_bf16_launches("bf16_objects", by_path["bf16_objects"],
                        kernel_launches(obj.spec, n_pad), 1)
    with plain_path(mods, EVAL_KERNELS):
        p16 = P.predict(obj, *inputs)[0].float()
        p32 = P.predict(P.build_model(seg32, n_pad, dev), *inputs)[0]
    hold_bf16_logits(f"bf16_objects ({BF16_OBJECTS}, B "
                     f"{inputs[0].shape[0]}, n_pad {n_pad}), kernel vs plain "
                     "path", lo, p16, p16, p32, vo)
    calls, _ = capture(BF16_KERNELS, mods, lambda: P.predict(obj, *inputs))
    for name, e in hold("bf16_objects", BF16_KERNELS, mods, calls).items():
        errs[name] = max(errs.get(name, 0.0), e)
    for name, e in errs.items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return report, by_path


def f32_twin(name, args, kwargs, mods):
    """The float32 variant's call on a recorded bfloat16 call's inputs
    widened to float32 (its counterpart on the float32 path)."""
    C, G, K = mods["conv1d_train"], mods["group_train"], mods["gather"]
    if name == "conv1d_train_fwd_bf16":
        return lambda: C.conv1d_train_fwd_layer(args[0].float(), *args[1:])
    if name == "conv1d_train_t_bf16":
        a = (*args[:2], args[2].float(), *args[3:])
        return lambda: C.conv1d_train_bwd_t(*a, **kwargs)
    if name == "group_train_fwd_bf16":
        return lambda: G.group_train_fwd(args[0].float(), *args[1:])
    if name == "group_train_bwd_bf16":
        h1, mask, cfg, params, *_, dout = args
        _, st, n, ex = G.group_train_fwd(h1.float(), mask, cfg, params)
        return lambda: G.group_train_bwd(h1.float(), mask, cfg, params, st,
                                         n, ex, dout)
    return lambda: K.scatter_km(args[0].float(), *args[1:], **kwargs)


def bf16_train_runner(model, state0, batch, loss_cfg, mods, dev):
    """fn(plain=False, lr=LR) -> (loss, logits, valid, ms, peak bytes,
    grads, buffers): one ``train_step`` of ``model`` from the weights
    ``state0``, through the kernels or every kernel's plain version (K8's
    passes included: their plain versions take the bfloat16 contract)."""
    import torch

    from curvecloudnet_tpu_torch.train import train_step
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    def one_step(plain=False, lr=LR):
        model.load_state_dict(state0)
        opt = create_optimizer(model)
        gen = torch.Generator(device=dev).manual_seed(0)
        seen = []
        hook = model.register_forward_hook(
            lambda _m, _a, out: seen.append(out))
        try:
            with plain_path(mods, EVAL_KERNELS + TRAIN_KERNELS
                            if plain else []):
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = train_step(model, opt, lr, batch, gen, 0.1, loss_cfg)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            hook.remove()
        logits, valid = seen[0]
        return (float(out["loss"]), logits.detach().float(), valid, ms,
                torch.cuda.max_memory_allocated(), *grads_and_stats(model))

    return one_step


def check_state_f32(label, model):
    """Parameters, their gradients and the BatchNorm buffers float32."""
    import torch

    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        if t.dtype != torch.float32 or (t.grad is not None
                                        and t.grad.dtype != t.dtype):
            raise AssertionError(f"{label}: {name} {t.dtype}")


def float32_calls(kernels, calls):
    """The float32 kernels' recorded calls that ran their float32 variant
    (a wrapper given bfloat16 inputs, or K8's ``bf16``, dispatches to its
    bfloat16 twin, recorded apart) -> (kernels with such calls, calls)."""
    import torch

    def bf16(name, args, kwargs):
        if name == "conv1d_train_fwd":
            return len(args) > 6 and bool(args[6])
        if name == "conv1d_train_t":
            return bool(kwargs.get("bf16"))
        return torch.is_tensor(args[0]) and args[0].dtype == torch.bfloat16

    kept = {k[0]: [c for c in calls[k[0]] if not bf16(k[0], *c[:2])]
            for k in kernels}
    return [k for k in kernels if kept[k[0]]], kept


def run_bf16_train(P, mods, dev, kernel_launches):
    """Phase 21: bfloat16 training -> (report rows of the bfloat16 train
    kernels, launches by path).

    ``bf16_train``: the flagship at full width through
    ``train.__main__.setup`` on a ``compute_dtype: bfloat16`` config
    (and one step of its ``fused`` edge route's model: launches, the
    loss within 1e-6 of the group route's)
    (K8 float32 at step 0, bfloat16 at step 31; K7-bf16 at every grouping
    site; K4b-bf16): every K7-bf16, K8-bf16 and K4b-bf16 call of a step
    held against its plain bfloat16 version (seed 0 timed, with the float32
    variant's time on the same inputs and a line per K7 site; seed 1 held),
    the step's float32 calls held as phase 6 holds them; one step kernel
    path vs plain bfloat16 path vs plain float32 path from the same
    weights: the loss within 2x the plain path's own bf16-vs-f32 gap, the
    logits as ``hold_bf16_logits``, parameters, gradients and buffers
    float32; ``BF16_TRAIN_STEPS`` steps lower the loss, launches of both
    dtypes = the spec's; the step's wall, busy ms by group and peak memory
    against the float32 step's, in turns.  ``bf16_objects_train``:
    shapenet-seg at its batch (24) in bfloat16 (K7-bf16 over 128 planes, a
    1024-wide sa-geo attention BN): a step's bfloat16 calls held,
    launches.  ``bf16_loop``: ``main`` with ``--model.compute_dtype
    bfloat16`` (``config.parse_args``): ``BF16_LOOP_TRAIN`` steps, a val
    scan under TTA, checkpoints, then resumed for a second epoch."""
    import numpy as np
    import torch

    from curvecloudnet_tpu_torch import config as C
    from curvecloudnet_tpu_torch import main as M
    from curvecloudnet_tpu_torch.train import train_step
    from curvecloudnet_tpu_torch.train.__main__ import setup, train_batch
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    t_phase = time.perf_counter()
    counted_all = TRAIN_COUNTED + BF16_COUNTED
    config = bf16_config("nuscenes")
    model, _, _, loss_cfg, batch, _ = setup(config, dev, 0)
    f32, _, _, _, _, _ = setup(CONFIG, dev, 0)
    n_pad = P.n_pad_of(config)
    state0 = copy.deepcopy(model.state_dict())
    for k, v in f32.state_dict().items():
        if not torch.equal(v, state0[k]):
            raise AssertionError(f"setup: {k} differs between the dtypes")
    check_state_f32("bf16 setup", model)
    one16 = bf16_train_runner(model.train(), state0, batch, loss_cfg, mods,
                              dev)
    one32 = bf16_train_runner(f32.train(), state0, batch, loss_cfg, mods,
                              dev)

    # seed 0's calls: the bfloat16 ones held and timed, the float32 ones
    # (K8 at step 0, K8's reduce, K3, K6) and K4-bf16 held
    g16 = [k for k in BF16_KERNELS if k[0] == "gather_bf16"]
    calls, (cap_loss, *_, cap_ms, cap_peak, _, _) = capture(
        BF16_TRAIN_KERNELS + TRAIN_KERNELS + TRAIN_HELD + g16, mods,
        lambda: one16(lr=0.0))
    log(f"bf16_train capture step: loss {cap_loss:.6g}, {cap_ms:.1f} ms, "
        f"peak {cap_peak / 2**30:.2f} GiB; calls "
        + str({k: len(v) for k, v in calls.items()}))
    for name, *_ in BF16_TRAIN_KERNELS:
        if not calls[name]:
            raise AssertionError(f"{name}: no call in the bf16 train step")
    per_call = {}
    last = conv_labels(model.spec, {})["conv1d_chain"][-1]
    report = measure(BF16_TRAIN_KERNELS, mods, calls, train=True,
                     per_call=per_call, labels={
                         "conv1d_train_fwd_bf16": [
                             f"{last} layer {i + 1}" for i in
                             range(len(calls["conv1d_train_fwd_bf16"]))]})
    k7_sites(model.spec, calls, per_call, mods["group_train"],
             "nuScenes bf16", names=("group_train_fwd_bf16",
                                     "group_train_bwd_bf16"),
             floor_of=("bfloat16 floor", 1 / PEAK_BF16))
    for name, *_ in BF16_TRAIN_KERNELS:
        ms32 = 0.0
        with torch.no_grad():
            for args, kwargs, _ in calls[name]:
                reps = 21 if name.startswith("conv1d") else 1
                ms32 += cuda_ms(f32_twin(name, args, kwargs, mods), reps)
        log(f"{name} vs float32 on the same inputs: {len(calls[name])} "
            f"calls, bfloat16 {report[name]['ms']:.3f} ms, float32 "
            f"{ms32:.3f} ms; bound at the bfloat16 rate "
            f"{report[name]['bound_ms']:.3f} ms")
    f32_held, f32_calls = float32_calls(TRAIN_KERNELS + TRAIN_HELD, calls)
    log("bf16_train float32 calls: "
        + str({k[0]: len(f32_calls[k[0]]) for k in f32_held}))
    hold_train("bf16_train float32 calls", f32_held, mods, f32_calls)
    hold("bf16_train", g16, mods, calls)
    del calls, f32_calls
    batch1 = train_batch(config, 1, n_pad, dev)
    one16_1 = bf16_train_runner(model, state0, batch1, loss_cfg, mods, dev)
    calls, _ = capture(BF16_TRAIN_KERNELS, mods, lambda: one16_1(lr=0.0))
    for name, e in hold_train("bf16_train seed 1", BF16_TRAIN_KERNELS, mods,
                              calls).items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
    del calls, one16_1, batch1

    # one step: kernel path vs plain bfloat16 path vs plain float32 path
    k = one16()
    check_state_f32("bf16_train kernel step", model)
    p16, p32 = one16(plain=True), one32(plain=True)
    for what, r in (("kernel", k), ("plain bf16", p16), ("plain f32", p32)):
        log(f"bf16_train one step, {what} path: loss {r[0]:.8g}, "
            f"{r[3]:.1f} ms, peak {r[4] / 2**30:.2f} GiB")
    gap = abs(p16[0] - p32[0])
    if not (0 < gap and abs(k[0] - p16[0]) <= BF16_MAX_FACTOR * gap):
        raise AssertionError(f"bf16_train loss: kernel {k[0]}, plain bf16 "
                             f"{p16[0]}, plain f32 {p32[0]}")
    hold_bf16_logits("bf16_train step, kernel vs plain path", k[1], p16[1],
                     p16[1], p32[1], k[2])
    for name, g in k[5].items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"bf16_train gradient {name} not finite")

    # the steps: launches of both dtypes, the loss falls
    model.load_state_dict(state0)
    opt = create_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses, launched = counted(mods, counted_all, lambda: [
        float(train_step(model, opt, LR, batch, gen, 0.1, loss_cfg)["loss"])
        for _ in range(BF16_TRAIN_STEPS)])
    by_path = {"bf16_train": launched}
    check_bf16_launches("bf16_train", launched,
                        kernel_launches(model.spec, n_pad, train=True),
                        BF16_TRAIN_STEPS)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16_train losses {losses}")
    log(f"bf16_train {BF16_TRAIN_STEPS} steps: losses {losses}")
    check_state_f32("bf16_train steps", model)
    # the fused edge route's model trains through the same kernels (train
    # takes K4 / K4b + K7 on both routes): its first step's loss is the
    # group route's (up to f32 rounding, 1e-6 relative)
    fused = P.build_model(config, n_pad, dev, edge_kernel="fused").train()
    fused.load_state_dict(state0)
    o = create_optimizer(fused)
    g = torch.Generator(device=dev).manual_seed(0)
    loss_f, by_path["bf16_train_fused"] = counted(
        mods, counted_all, lambda: float(train_step(
            fused, o, LR, batch, g, 0.1, loss_cfg)["loss"]))
    check_bf16_launches("bf16_train_fused", by_path["bf16_train_fused"],
                        kernel_launches(fused.spec, n_pad, train=True,
                                        edge_kernel="fused"), 1)
    if not abs(loss_f - losses[0]) <= 1e-6 * abs(losses[0]):
        raise AssertionError(f"bf16_train_fused: loss {loss_f}, the group "
                             f"route's {losses[0]}")
    log(f"bf16_train_fused: one step, loss {loss_f} (the group route's "
        f"{losses[0]})")
    del fused

    # walls, busy ms by group and peak memory of each dtype, in turns
    walls = {"float32": [], "bfloat16": []}
    nets = {"float32": f32, "bfloat16": model}
    steps = {}
    for dt, net in nets.items():
        net.load_state_dict(state0)
        o = create_optimizer(net)
        g = torch.Generator(device=dev).manual_seed(0)
        steps[dt] = (lambda net=net, o=o, g=g: train_step(
            net, o, LR, batch, g, 0.1, loss_cfg))
    for _ in range(BF16_WALL_STEPS):
        for dt in nets:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[dt]()
            torch.cuda.synchronize()
            walls[dt].append((time.perf_counter() - t0) * 1e3)
    from curvecloudnet_tpu_torch.tools.profile_train import GROUPS

    for dt in nets:
        busy, groups = busy_by_group(steps[dt], GROUPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps[dt]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"nuScenes train step {dt}, {BF16_WALL_STEPS} steps: wall median "
            f"{float(np.median(walls[dt])):.2f} ms (all "
            f"{[round(w, 2) for w in walls[dt]]}); device busy {busy:.2f} ms,"
            f" by group {groups}; peak memory {peak:.2f} GiB")
    del f32, nets, steps, one16, one32, k, p16, p32

    # bf16_objects_train: shapenet-seg at its batch
    seg = bf16_config(BF16_OBJECTS)
    obj, _, _, seg_loss, seg_batch, _ = setup(seg, dev, 0)
    seg_pad = P.n_pad_of(seg)
    seg0 = copy.deepcopy(obj.state_dict())
    one_seg = bf16_train_runner(obj.train(), seg0, seg_batch, seg_loss, mods,
                                dev)
    calls, (seg_l, *_) = capture(BF16_TRAIN_KERNELS, mods,
                                 lambda: one_seg(lr=0.0))
    widths = sorted({max(a[2].dims + (a[2].att_dim,))
                     for a, _, _ in calls["group_train_fwd_bf16"]})
    log(f"bf16_objects_train ({BF16_OBJECTS}, B "
        f"{seg_batch.cloud.valid.shape[0]}, n_pad {seg_pad}): loss "
        f"{seg_l:.6g}; K7-bf16 sites' widest layers {widths}")
    for name, e in hold_train("bf16_objects_train", BF16_TRAIN_KERNELS, mods,
                              calls).items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
    del calls
    obj.load_state_dict(seg0)
    o = create_optimizer(obj)
    g = torch.Generator(device=dev).manual_seed(0)
    _, by_path["bf16_objects_train"] = counted(
        mods, counted_all, lambda: train_step(obj, o, LR, seg_batch, g, 0.1,
                                              seg_loss))
    check_bf16_launches("bf16_objects_train", by_path["bf16_objects_train"],
                        kernel_launches(obj.spec, seg_pad, train=True), 1)
    check_state_f32("bf16_objects_train", obj)
    del obj, one_seg, seg_batch

    # bf16_loop: main's epoch loop with the CLI override, then resumed
    from curvecloudnet_tpu_torch.run import tasks as T

    shutil.rmtree(OUT21, ignore_errors=True)
    outdir = os.path.join(OUT21, "loop")
    loop_launched = {}
    for epochs in (1, 2):
        cfg = C.parse_args(["--config", CONFIG, "--model.compute_dtype",
                            "bfloat16", f"--device={dev}",
                            f"--n_train={BF16_LOOP_TRAIN}",
                            f"--n_val={BF16_LOOP_VAL}", "--batch_size=1",
                            f"--epochs={epochs}", "--num_workers=1",
                            f"--outdir={outdir}"])
        t0 = time.perf_counter()
        score, launched = counted(mods, counted_all + LOOP_COUNTED[
            len(TRAIN_COUNTED):], lambda: M.main(cfg))
        wall = time.perf_counter() - t0
        state = M.ckpt.read_latest_state(outdir)
        info, val_ds, loop_model = M.build(cfg)
        if loop_model.spec.compute_dtype != "bfloat16":
            raise AssertionError("main did not take --model.compute_dtype")
        want = {}
        for counts, times in ((kernel_launches(loop_model.spec,
                                               val_ds.n_pad, train=True),
                               BF16_LOOP_TRAIN),
                              (kernel_launches(loop_model.spec, val_ds.n_pad),
                               BF16_LOOP_VAL * (T.N_VIEWS // 2))):
            for key, v in counts.items():
                want[key] = want.get(key, 0) + times * v
        check_bf16_launches(f"bf16_loop epochs {epochs}", launched, want, 1)
        if state is None or state["epoch"] != epochs - 1 or score != score:
            raise AssertionError(f"bf16_loop: score {score}, state {state}")
        files = sorted(os.listdir(outdir))
        log(f"bf16_loop epochs {epochs}: {wall:.1f} s, score {score:.4g}, "
            f"latest_state {state}, outdir {files}")
        for key, v in launched.items():
            loop_launched[key] = loop_launched.get(key, 0) + v
        del loop_model
    by_path["bf16_loop"] = loop_launched
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return report, by_path



def cat_batches(batches):
    """Batches -> one batch of their samples in order (a dataclass of
    tensors with the batch leading, nested dataclasses included)."""
    import dataclasses

    import torch

    def cat(vals):
        if dataclasses.is_dataclass(vals[0]):
            return dataclasses.replace(vals[0], **{
                f.name: cat([getattr(v, f.name) for v in vals])
                for f in dataclasses.fields(vals[0])})
        return torch.cat(vals) if torch.is_tensor(vals[0]) else vals[0]

    return cat(batches)


def dp_models(bf16_cfg):
    """Phase 22's models: (label, config, counted kernels)."""
    return (("dp", CONFIG, TRAIN_COUNTED),
            ("dp_bf16", bf16_cfg, TRAIN_COUNTED + BF16_COUNTED))


def step_state(model):
    """(gradients, buffers, parameters) of ``model`` after a step, on the
    host."""
    grads, bufs = grads_and_stats(model)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return [{k: v.cpu() for k, v in d.items()}
            for d in (grads, bufs, params)]


def with_logits(model, run):
    """``run()`` (a step of ``model``) -> (its result, the logits and the
    validity of the model's forward in it, on the host)."""
    seen = []
    hook = model.register_forward_hook(lambda _m, _a, out: seen.append(out))
    try:
        out = run()
    finally:
        hook.remove()
    logits, valid = seen[0]
    return out, logits.detach().float().cpu(), valid.cpu()


def dp_rank(rank, port, out, bf16_cfg, device):
    """Phase 22's rank process (``chip_smoke.py --dp-rank RANK PORT OUT
    BF16_CONFIG DEVICE``): joins the ``DP_WORLD``-process group on
    ``device`` (cuda:0: gloo, the processes share the card) and, for the
    float32 and the bfloat16
    flagship at n_pad 36864, takes one train step from seed 0's weights on
    its own sweep (seed = its rank) with its launches counted, then
    (float32) ``DP_WALL_STEPS`` timed steps, and one with its
    collectives timed;
    writes the results to ``out``."""
    import torch

    sys.path.insert(0, REPO)
    from curvecloudnet_tpu_torch import parallel
    from curvecloudnet_tpu_torch import predict as P
    from curvecloudnet_tpu_torch.ops import (conv1d_chain, conv1d_train,
                                             edge_mlp, fps, gather,
                                             grid_topk, group_reduce,
                                             group_train, knn)
    from curvecloudnet_tpu_torch.train import LossConfig
    from curvecloudnet_tpu_torch.train.__main__ import synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"conv1d_chain": conv1d_chain, "group_reduce": group_reduce,
            "knn": knn, "fps": fps, "gather": gather,
            "group_train": group_train, "grid_topk": grid_topk,
            "conv1d_train": conv1d_train, "edge_mlp": edge_mlp}
    dev = torch.device(device)
    parallel.initialize_distributed(f"127.0.0.1:{port}", DP_WORLD, rank, dev)
    loss_cfg = LossConfig(ignore_index=0, use_lovasz=True)
    result = {"backend": torch.distributed.get_backend()}
    try:
        for label, config, kernels in dp_models(bf16_cfg):
            model = P.build_model(config, N_PAD, dev).train()
            one_step = step_runner(model, copy.deepcopy(model.state_dict()),
                                   synthetic_batch(rank, N_PAD, dev),
                                   loss_cfg, mods, dev)
            ((loss, first_ms, peak), logits, valid), launched = counted(
                mods, kernels, lambda: with_logits(model, one_step))
            grads, bufs, params = step_state(model)
            walls = [one_step()[1] for _ in range(
                DP_WALL_STEPS if label == "dp" else 0)]
            with parallel.collective_timer() as coll:
                timed_ms = one_step()[1]
            result[label] = dict(loss=loss, first_ms=first_ms, peak=peak,
                                 launched=launched, walls=walls,
                                 timed_ms=timed_ms, coll=dict(coll),
                                 grads=grads, bufs=bufs, params=params,
                                 logits=logits, valid=valid)
            del model, one_step
            torch.cuda.empty_cache()
    finally:
        parallel.shutdown()
    reference = [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "flax", "curvecloudnet_tpu")]
    if reference:
        raise AssertionError(f"a rank process loaded {reference}")
    torch.save(result, out)


def ranks_alike(label, ranks):
    """Every rank's loss, gradients, buffers and parameters after the
    step bit for bit rank 0's (the global step on every process)."""
    import torch

    for r, got in enumerate(ranks[1:], 1):
        if got["loss"] != ranks[0]["loss"]:
            raise AssertionError(f"{label}: rank {r}'s loss {got['loss']} "
                                 f"vs rank 0's {ranks[0]['loss']}")
        for part in ("grads", "bufs", "params"):
            for k, v in ranks[0][part].items():
                if not torch.equal(got[part][k], v):
                    raise AssertionError(f"{label}: rank {r}'s {part} {k} "
                                         "differs from rank 0's")


def hold_dp(label, got, want, shaken):
    """The data-parallel step (rank 0's ``got``) against the single-process
    step on the global batch (``want``; ``shaken`` the same on weights x
    (1 + 1e-5 noise)): loss within 1e-5 relative; running statistics
    within 1e-5 of max(1, |stat|) or 3x the perturbation's change; each
    gradient within the JAX package's DP bar (rtol 5e-2, atol 1e-5) or
    phase 8's yardstick (3x the perturbation's change + 2e-3 of its
    largest + 1e-5 of the largest gradient); each parameter after the
    Adam step within 1e-6 (+ 1e-6 relative) where the gradient is above
    1e-3 of the largest and twice the two steps' gradient difference
    (there the first step is -lr sign(g) on both), elsewhere within 2 lr."""
    import torch

    if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
        raise AssertionError(f"{label} loss: {got['loss']} vs the single "
                             f"step's {want['loss']}")
    stat_yard = 0
    for name, v in want["bufs"].items():
        scale = max(1.0, float(v.abs().max()))
        err = float((got["bufs"][name] - v).abs().max())
        if err <= 1e-5 * scale:
            continue
        noise = float((shaken["bufs"][name] - v).abs().max())
        log(f"  {label} running statistic {name}: err {err:.3g} > 1e-5 x "
            f"{scale:.3g}; the perturbation's change {noise:.3g}")
        if err > 3 * noise + 1e-5 * scale:
            raise AssertionError(f"{label} running statistic {name}: {err}")
        stat_yard += 1
    if got["grads"].keys() != want["grads"].keys():
        raise AssertionError(f"{label}: different parameter sets")
    top = max(float(g.abs().max()) for g in want["grads"].values())
    bar = yard = 0
    worst = (0.0, "")
    for name, g in want["grads"].items():
        d = got["grads"][name]
        if torch.allclose(d, g, rtol=DP_GRAD_RTOL, atol=DP_GRAD_ATOL):
            bar += 1
            continue
        err = float((d - g).abs().max())
        noise = float((shaken["grads"][name] - g).abs().max())
        ratio = err / (3 * noise + 2e-3 * float(g.abs().max()) + 1e-5 * top)
        worst = max(worst, (ratio, name))
        if ratio > 1:
            raise AssertionError(f"{label} gradient {name}: err {err}, the "
                                 f"perturbation's change {noise}")
        yard += 1
    params_sure = 0
    for name, p in want["params"].items():
        g = want["grads"][name]
        sure = g.abs() > torch.clamp(2 * (got["grads"][name] - g).abs(),
                                     min=1e-3 * top)
        err = (got["params"][name] - p).abs()
        if bool(sure.any()) and bool((err[sure] > 1e-6 + 1e-6 * p[
                sure].abs()).any()):
            raise AssertionError(f"{label} parameter {name} after the step: "
                                 f"{float(err[sure].max())}")
        if float(err.max()) > 2 * LR + 1e-6:
            raise AssertionError(f"{label} parameter {name} after the step: "
                                 f"{float(err.max())} > 2 lr")
        params_sure += int(sure.sum())
    log(f"{label} vs the single B={DP_WORLD} step: loss {got['loss']:.8g} / "
        f"{want['loss']:.8g}; running statistics {len(want['bufs'])} "
        f"({stat_yard} by the yardstick); gradients {bar} within the DP "
        f"bar, {yard} by the yardstick (worst {worst[0]:.3g} of its bound, "
        f"{worst[1]}); parameters after the step: {params_sure} entries at "
        f"1e-6, the rest within 2 lr")


def hold_dp_bf16(label, got, logits, want, shaken, f32):
    """The bfloat16 data-parallel step (rank 0's ``got``; ``logits``: both
    ranks' in rank order) against the single-process bfloat16 step on the
    global batch (``want``).  bfloat16 steps are draws of its rounding
    noise (one changed rounding moves most of the logits), so each
    quantity is held within ``BF16_MAX_FACTOR`` x the noise of the single
    step: the loss and the logits (``hold_bf16_logits``, the single steps'
    logits as the plain paths') against its bf16-vs-f32 gap (``f32``: the
    float32 single step), each running statistic against the larger of
    that gap and the bf16 single step's change on weights x (1 + 1e-5
    noise) (``shaken``; the yardstick of ``hold_dp``), or within 1e-5 of
    max(1, |stat|), the float32 bar; the gradients float32 and finite."""
    import torch

    gap = abs(want["loss"] - f32["loss"])
    if not (0 < gap and abs(got["loss"] - want["loss"])
            <= BF16_MAX_FACTOR * gap):
        raise AssertionError(f"{label} loss {got['loss']}: the single "
                             f"bf16 step's {want['loss']}, its "
                             f"bf16-vs-f32 gap {gap}")
    hold_bf16_logits(f"{label} logits (both ranks) vs the single bf16 step",
                     logits, want["logits"], want["logits"], f32["logits"],
                     want["valid"])
    if want["bufs"].keys() != f32["bufs"].keys():
        raise AssertionError(f"{label}: buffers differ from float32's")
    rows, bad, by_noise = [], [], 0
    for name, v in want["bufs"].items():
        err = float((got["bufs"][name] - v).abs().max())
        g = float((v - f32["bufs"][name]).abs().max())
        noise = float((shaken["bufs"][name] - v).abs().max())
        floor = 1e-5 * max(1.0, float(v.abs().max()))
        bound = max(floor, BF16_MAX_FACTOR * max(g, noise))
        rows.append((err / bound, name, err, g, noise))
        by_noise += err > max(floor, BF16_MAX_FACTOR * g)
        if err > bound:
            bad.append(name)
    rows.sort(reverse=True)
    log(f"{label} running statistics vs the single bf16 step: "
        f"{len(rows)}, {by_noise} past {BF16_MAX_FACTOR} x the bf16-vs-f32 "
        "gap and within the perturbation's change; the worst (err / bound, "
        "name, err, bf16-vs-f32 gap, perturbation's change): "
        + "; ".join(f"{r:.3g} {n} {e:.3g} {g:.3g} {z:.3g}"
                    for r, n, e, g, z in rows[:6]))
    if bad:
        raise AssertionError(f"{label} running statistics {bad}")
    for name, g in got["grads"].items():
        if g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} gradient {name}: {g.dtype}")
    log(f"{label} vs the single B={DP_WORLD} bf16 step: loss "
        f"{got['loss']:.8g} / {want['loss']:.8g}, within "
        f"{abs(got['loss'] - want['loss']) / gap:.3g} of the bf16-vs-f32 "
        f"gap; the perturbation moves the single bf16 step's loss "
        f"{abs(shaken['loss'] - want['loss']):.3g}")


def run_dp(P, mods, dev, kernel_launches, smi):
    """Phase 22: data parallelism over processes on the one card -> the
    launches by path (the ranks' summed).

    ``dp`` / ``dp_bf16``: ``DP_WORLD`` rank processes (``dp_rank``, gloo
    on cuda:0) each take the flagship's full-width train step on its own
    sweep (seeds 0 and 1) from seed 0's weights; this process takes the
    single-process step on the B=2 batch of both sweeps (and on
    perturbed weights, the yardstick).  Held: every rank alike bit for
    bit, rank 0 against the single step (``hold_dp``; bfloat16:
    ``hold_dp_bf16``, the loss, running statistics and logits within
    ``BF16_MAX_FACTOR`` x the single steps' bf16-vs-f32 gap, the
    gradients finite), each rank's launches equal to
    ``kernel_launches(train=True)``.  Printed: a rank's step walls, its
    collectives' time and share of a step, the single step's walls, and
    each one's peak memory.  ``dp_loop``: ``main`` in ``DP_WORLD``
    processes (``distributed.num_processes``, ``CCN_PROCESS_ID``) on
    nuScenes files (``tools/fake_datasets.py``): an epoch of 2 steps a
    process, a TTA val scan, process 0's checkpoint, then resumed for a
    second epoch."""
    import numpy as np
    import torch

    from curvecloudnet_tpu_torch.config import load_config
    from curvecloudnet_tpu_torch.parallel import dryrun
    from curvecloudnet_tpu_torch.tools import fake_datasets as F
    from curvecloudnet_tpu_torch.train import LossConfig
    from curvecloudnet_tpu_torch.train.__main__ import synthetic_batch

    t_phase = time.perf_counter()
    shutil.rmtree(OUT22, ignore_errors=True)
    os.makedirs(OUT22)
    loss_cfg = LossConfig(ignore_index=0, use_lovasz=True)
    bf16_cfg = bf16_config("nuscenes")
    batch = cat_batches([synthetic_batch(r, N_PAD, dev)
                         for r in range(DP_WORLD)])
    single, specs = {}, {}
    for label, config, _ in dp_models(bf16_cfg):
        model = P.build_model(config, N_PAD, dev).train()
        specs[label] = model.spec
        one_step = step_runner(model, copy.deepcopy(model.state_dict()),
                               batch, loss_cfg, mods, dev)
        runs = {}
        for what, shaken in [("single", False), ("shaken", True)]:
            (loss, ms, peak), logits, valid = with_logits(
                model, lambda: one_step(shaken=shaken))
            grads, bufs, params = step_state(model)
            runs[what] = dict(loss=loss, ms=ms, peak=peak, grads=grads,
                              bufs=bufs, params=params, logits=logits,
                              valid=valid)
        runs["walls"] = [one_step()[1] for _ in range(DP_WALL_STEPS)]
        single[label] = runs
        del model, one_step
        torch.cuda.empty_cache()

    paths = [os.path.join(OUT22, f"rank{i}.pt") for i in range(DP_WORLD)]
    port = dryrun.free_port()
    t0 = time.perf_counter()
    dryrun.spawn(lambda i: [sys.executable, os.path.abspath(__file__),
                            "--dp-rank", str(i), str(port), paths[i],
                            bf16_cfg, str(dev)], DP_WORLD, DP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(p, weights_only=False) for p in paths]
    by_path = {}
    for label, _, kernels in dp_models(bf16_cfg):
        got = [r[label] for r in ranks]
        one = single[label]
        for i, r in enumerate(got):
            coll = r["coll"]
            log(f"{label} rank {i}/{DP_WORLD} ({ranks[i]['backend']}, "
                f"{dev}, B=1): loss {r['loss']:.8g}; first step "
                f"{r['first_ms']:.1f} ms, steps "
                f"{[round(w, 1) for w in r['walls']]} ms; a step with its "
                f"collectives timed (a barrier before each) "
                f"{r['timed_ms']:.1f} ms, in {coll['calls']} collectives "
                f"{coll['seconds'] * 1e3:.1f} ms; peak memory "
                f"{r['peak'] / 2**30:.2f} GiB; {smi}")
        if label == "dp":
            dp_ms = float(np.median(got[0]["walls"]))
            own = got[0]["coll"]["seconds"] * 1e3
            log(f"{label}: a rank's step {dp_ms:.1f} ms (median) against the "
                f"single B={DP_WORLD} step's "
                f"{float(np.median(one['walls'])):.1f} ms; rank 0's "
                f"collectives' own time {own:.1f} ms, {own / dp_ms:.3f} of "
                f"its step; {smi}")
        log(f"{label} single process, B={DP_WORLD}: loss "
            f"{one['single']['loss']:.8g}; steps "
            f"{[round(w, 1) for w in one['walls']]} ms (median "
            f"{float(np.median(one['walls'])):.1f}); peak memory "
            f"{one['single']['peak'] / 2**30:.2f} GiB; {smi}")
        ranks_alike(label, got)
        want = kernel_launches(specs[label], N_PAD, train=True)
        for i, r in enumerate(got):
            if label == "dp":
                log(f"{label} rank {i} launches:", r["launched"], "spec:",
                    want)
                for name, n in r["launched"].items():
                    if n != want[name] or not n:
                        raise AssertionError(f"{label} rank {i} {name}: {n}"
                                             f" launches, want {want[name]}")
            else:
                check_bf16_launches(f"{label} rank {i}", r["launched"], want,
                                    1)
        launched = {}
        for r in got:
            for name, n in r["launched"].items():
                launched[name] = launched.get(name, 0) + n
        by_path[label] = launched
        # the ranks' logits, in rank order, are the global batch's
        logits = torch.cat([r["logits"] for r in got])
        valid = torch.cat([r["valid"] for r in got])
        if not torch.equal(valid, one["single"]["valid"]):
            raise AssertionError(f"{label}: the ranks' valid points differ "
                                 "from the single step's")
        if label == "dp":
            hold_dp(label, got[0], one["single"], one["shaken"])
            err = (logits - one["single"]["logits"])[valid].abs()
            log(f"{label} logits (both ranks) vs the single step's: max abs "
                f"err {float(err.max()):.4g} (mean {float(err.mean()):.3g})")
            continue
        hold_dp_bf16(label, got[0], logits, one["single"], one["shaken"],
                     single["dp"]["single"])
    log(f"{DP_WORLD} rank processes: {spawn_s:.1f} s")

    # main in DP_WORLD processes from nuScenes files, then resumed
    cfg = load_config(CONFIG)
    root = F.write_for_config(cfg, os.path.join(OUT22, "data"),
                              DP_LOOP_FILES, seed=22)
    outdir = os.path.join(OUT22, "loop")
    steps = DP_LOOP_FILES["train"] // DP_WORLD
    for epochs in (1, 2):
        port = dryrun.free_port()
        t0 = time.perf_counter()
        outs = dryrun.spawn(
            lambda i: [sys.executable, "-m", "curvecloudnet_tpu_torch.main",
                       "--config", CONFIG, f"--data_path={root}",
                       "--batch_size=1", f"--epochs={epochs}",
                       f"--device={dev}",
                       "--num_workers=1", f"--outdir={outdir}",
                       "--distributed.num_processes", str(DP_WORLD),
                       "--distributed.coordinator_address",
                       f"127.0.0.1:{port}"],
            DP_WORLD, DP_TIMEOUT, env_of=lambda i: {"CCN_PROCESS_ID": str(i)})
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT22, f"loop_epochs{epochs}.log"), "w") as f:
            f.write("\n".join(f"--- process {i}\n{o}"
                              for i, o in enumerate(outs)))
        if "backend gloo" not in outs[0]:
            raise AssertionError(f"dp_loop: no gloo backend line: {outs[0]}")
        for i, o in enumerate(outs):
            if f"epoch {epochs - 1}: loss" not in o or (
                    "resumed from" in o) != (epochs == 2):
                raise AssertionError(f"dp_loop process {i}: {o[-3000:]}")
        with open(os.path.join(outdir, "latest_state.json")) as f:
            state = json.load(f)
        with open(os.path.join(outdir, "metrics.jsonl")) as f:
            scores = [r for r in map(json.loads, f) if "score" in r]
        blob = torch.load(os.path.join(outdir, "latest", "checkpoint.pt"),
                          map_location="cpu", weights_only=True)
        if (state["epoch"] != epochs - 1 or blob["step"] != steps * epochs
                or [r["epoch"] for r in scores] != list(range(epochs))):
            raise AssertionError(f"dp_loop epochs {epochs}: state {state}, "
                                 f"step {blob['step']}, scores {scores}")
        log(f"dp_loop epochs {epochs}: {DP_WORLD} processes of main, "
            f"{wall:.1f} s; {steps} steps a process an epoch, latest_state "
            f"{state}, checkpoint step {blob['step']}, scores "
            f"{[round(r['score'], 4) for r in scores]}")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def grads_and_stats(model):
    return ({k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    from curvecloudnet_tpu_torch import predict as P
    from curvecloudnet_tpu_torch.models import kernel_launches
    from curvecloudnet_tpu_torch.ops import _build
    from curvecloudnet_tpu_torch.ops import (conv1d_chain, conv1d_train,
                                             edge_mlp, fps, gather,
                                             grid_topk, group_reduce,
                                             group_train, knn)
    from curvecloudnet_tpu_torch.train import LossConfig, train_step
    from curvecloudnet_tpu_torch.train.__main__ import synthetic_batch
    from curvecloudnet_tpu_torch.train.trainer import create_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"conv1d_chain": conv1d_chain, "group_reduce": group_reduce,
            "knn": knn, "fps": fps, "gather": gather,
            "group_train": group_train, "grid_topk": grid_topk,
            "conv1d_train": conv1d_train, "edge_mlp": edge_mlp}
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log("card:", smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR / _build.LIB_NAME})")

    stamp(t_start, "1-2")
    # 3. capture one eval forward, compare and time every recorded call
    model = P.build_model(CONFIG, N_PAD, dev)
    scan0 = P.synthetic_scan(0, N_PAD, dev)
    calls, (logits0, valid0, _) = capture(
        EVAL_KERNELS, mods, lambda: P.predict(model, *scan0))
    group_call_ms = {}
    eval_report = measure(EVAL_KERNELS, mods, calls, train=False,
                          per_call=group_call_ms,
                          labels=conv_labels(model.spec, calls))
    k2_sites("nuScenes", model.spec, calls["group_reduce"],
             group_call_ms["group_reduce"])
    k3_calls("nuScenes", calls["knn"], group_call_ms["knn"], knn)
    k6_calls("nuScenes", calls["fps"], group_call_ms["fps"], fps)
    del calls

    # 4. the eval path: two scans through predict, launches counted
    want = kernel_launches(model.spec, N_PAD)
    for name, mod, wrapper, *_ in EVAL_KERNELS:
        getattr(mods[mod], wrapper).launches = 0
    scan_ms = []
    for seed in range(SCANS):
        inputs = scan0 if seed == 0 else P.synthetic_scan(seed, N_PAD, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, valid, pred = P.predict(model, *inputs)
        torch.cuda.synchronize()
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        live = logits[valid]
        if logits.shape != (1, N_PAD, model.spec.n_out) or not bool(
                torch.isfinite(live).all()):
            raise AssertionError(f"scan {seed}: bad logits {tuple(logits.shape)}")
        log(f"scan {seed}: {scan_ms[-1]:.1f} ms, {int(valid.sum())} valid points")
    eval_launched = {name: getattr(mods[mod], w).launches
                     for name, mod, w, *_ in EVAL_KERNELS}
    log("eval launches:", eval_launched, "spec per scan:", want)
    for name, got in eval_launched.items():
        if got != SCANS * want[name] or not got:
            raise AssertionError(f"{name}: {got} launches, "
                                 f"want {SCANS} x {want[name]}")

    # 5. the plain eval path on the card
    with contextlib.ExitStack() as stack:
        for name, mod, wrapper, ref_name, *_ in EVAL_KERNELS:
            m = mods[mod]
            stack.enter_context(replaced(m, wrapper, getattr(m, ref_name)))
        plain, _, _ = P.predict(model, *scan0)
        plain_ms = cuda_ms(lambda: P.predict(model, *scan0), reps=1)
    err = float((logits0 - plain)[valid0].abs().max())
    log(f"logits kernel path vs plain path on the card: max abs err {err:.3g}; "
        f"plain forward {plain_ms:.1f} ms")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"logits differ from the plain path by {err}")
    log(f"per-scan latency ms: {scan_ms}")
    del model, plain

    stamp(t_start, "3-5")
    # 6. capture one train step, compare and time every recorded call
    loss_cfg = LossConfig(ignore_index=0, use_lovasz=True)
    batch = synthetic_batch(0, N_PAD, dev)
    init = P.build_model(CONFIG, N_PAD, dev).train()
    state0 = copy.deepcopy(init.state_dict())

    one_step = step_runner(init, state0, batch, loss_cfg, mods, dev)

    # learning rate 0: the recorded calls hold views of the weights
    calls, (cap_loss, cap_ms, _) = capture(
        TRAIN_KERNELS + TRAIN_HELD, mods, lambda: one_step(lr=0.0))
    log(f"train capture step: loss {cap_loss:.6g}, {cap_ms:.1f} ms")
    train_call_ms = {}
    train_report = measure(TRAIN_KERNELS, mods, calls, train=True,
                           per_call=train_call_ms,
                           labels=conv_labels(init.spec, calls))
    k7_sites(init.spec, calls, train_call_ms, group_train)
    k7_flips("train", calls)
    reduce_row = train_report["conv1d_train_reduce"]
    reduce_row["max_abs_err"] = max(reduce_row["max_abs_err"], k8_sums(
        calls, train_call_ms, conv_labels(init.spec, calls), conv1d_train,
        next(k[-1] for k in TRAIN_KERNELS if k[0] == "conv1d_train_reduce")))
    held_report = measure(TRAIN_HELD, mods, calls, train=False,
                          per_call=train_call_ms)
    k3_calls("train", calls["knn"], train_call_ms["knn"], knn)
    k6_calls("train", calls["fps"], train_call_ms["fps"], fps)
    del calls

    # 7. the train path: five steps through train_step, launches counted
    want_t = kernel_launches(init.spec, N_PAD, train=True)
    for name, mod, wrapper in TRAIN_COUNTED:
        getattr(mods[mod], wrapper).launches = 0
    init.load_state_dict(state0)
    opt = create_optimizer(init)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(train_step(init, opt, LR, batch, gen, 0.1,
                                loss_cfg)["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"train step {step}: loss {loss:.6g}, {step_ms[-1]:.1f} ms")
    kernel_peak = torch.cuda.max_memory_allocated()
    train_launched = {name: getattr(mods[mod], w).launches
                      for name, mod, w in TRAIN_COUNTED}
    log("train launches:", train_launched, "spec per step:", want_t)
    for name, got in train_launched.items():
        if got != TRAIN_STEPS * want_t[name] or not got:
            raise AssertionError(f"{name}: {got} launches in train, "
                                 f"want {TRAIN_STEPS} x {want_t[name]}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")

    # 8. one step from the same weights: kernel path against plain path
    results = hold_step("train", one_step, init)
    log(f"train: capture step {cap_ms:.1f} ms; steps {step_ms} ms; kernel "
        f"path peak memory {kernel_peak / 2**30:.2f} GiB; plain step "
        f"{results['plain'][1]:.1f} ms, peak "
        f"{results['plain'][2] / 2**30:.2f} GiB; losses {losses}")

    stamp(t_start, "6-8")
    del init, opt, batch
    kitti_report, kitti_launched, kitti_scan = run_kitti(P, mods, dev,
                                                         kernel_launches)
    fused_report, fused_launched, fused_k2_err = run_fused(
        P, mods, dev, kernel_launches, scan0, logits0, valid0, group_call_ms)
    stamp(t_start, "9-13 (nuScenes' fused route)")
    kitti_launched["kitti_fused"], kitti_k9_err = run_kitti_fused(
        P, mods, dev, kernel_launches, *kitti_scan)
    fused_report["edge_mlp"]["max_abs_err"] = max(
        fused_report["edge_mlp"]["max_abs_err"], kitti_k9_err)

    stamp(t_start, "13 (KITTI's fused route)")
    # 14-15. the version-1.0 configs
    v1_reports, v1_launched = [], {}
    for label, name in V1_CONFIGS:
        config = os.path.join(REPO, "configs", f"{name}.yaml")
        rep_, v1_launched[label], scan = run_v1(P, mods, dev,
                                                kernel_launches, label,
                                                config)
        v1_reports.append(rep_)
        if label == "shapenet_seg":
            v1_launched[label + "_fused"], k9_row = run_v1_fused(
                P, mods, dev, kernel_launches, label, config, *scan)
            v1_reports.append({"edge_mlp": k9_row})

    stamp(t_start, "14-15")
    # 16. the eval entry
    eval16_errs, eval16_launched = run_eval_entry(P, mods, dev,
                                                  kernel_launches)

    # 17. the train paths of the other configs, main's epoch loop
    t_phase = time.perf_counter()
    train17_launched, train17_errs = {}, {}
    for label, name, timed in TRAIN17 + [("train_kitti", "kitti", False)]:
        config = os.path.join(REPO, "configs", f"{name}.yaml")
        train17_launched[label], errs = run_train17(
            P, mods, dev, kernel_launches, label, config, timed)
        for k, e in errs.items():
            train17_errs[k] = max(train17_errs.get(k, 0.0), e)
    train17_launched.update(run_loops(P, mods, dev, kernel_launches))
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")

    # 18. the data layer: main trains, validates and writes submissions
    # from files on disk; a disk batch of each config held kernel vs plain
    t_phase = time.perf_counter()
    shutil.rmtree(OUT18, ignore_errors=True)
    disk_launched, disk_errs = {}, {}
    for label, name, frames in DISK18:
        launched, errs = run_disk(P, mods, dev, kernel_launches, label, name,
                                  frames)
        disk_launched.update(launched)
        for k, e in errs.items():
            disk_errs[k] = max(disk_errs.get(k, 0.0), e)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    stamp(t_start, "16-18")
    # 19. the step options: shapenet-class with every option substituted,
    # nuScenes with a one-tap first conv, fp without parent_idx
    opt_report, opt_launched, opt_errs = run_options(P, mods, dev,
                                                     kernel_launches)

    stamp(t_start, "19")
    # 20. bfloat16 serving
    bf16_report, bf16_launched = run_bf16(P, mods, dev, kernel_launches)

    stamp(t_start, "20")
    # 21. bfloat16 training
    bf16t_report, bf16t_launched = run_bf16_train(P, mods, dev,
                                                  kernel_launches)

    stamp(t_start, "21")
    # 22. data parallelism over processes
    dp_launched = run_dp(P, mods, dev, kernel_launches, smi)

    reference = [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "flax", "curvecloudnet_tpu")]
    if reference:
        raise AssertionError(f"the port loaded the JAX package: {reference}")

    report = dict(eval_report)
    for name, row in train_report.items():
        if name in report:   # gather: both paths; the train capture's times
            row["max_abs_err"] = max(row["max_abs_err"],
                                     report[name]["max_abs_err"])
        report[name] = row
    for name, row in list(held_report.items()) + list(kitti_report.items()):
        if name in report:   # the nuScenes capture's times; the worst error
            report[name]["max_abs_err"] = max(row["max_abs_err"],
                                              report[name]["max_abs_err"])
        else:                # K5, K10
            report[name] = row
    report.update(fused_report)  # K9
    report["group_reduce"]["max_abs_err"] = max(
        report["group_reduce"]["max_abs_err"], fused_k2_err)
    for rows in v1_reports:      # the nuScenes capture's times; worst error
        for name, row in rows.items():
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              row["max_abs_err"])
    for name, err in (list(eval16_errs.items()) + list(train17_errs.items())
                      + list(disk_errs.items()) + list(opt_errs.items())
                      + [(k, r["max_abs_err"]) for k, r in opt_report.items()]):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    report.update(bf16_report)   # K1, K2, K4 and K9 in bfloat16
    report.update(bf16t_report)  # K7, K8 and K4b in bfloat16
    for name, row in report.items():
        by_path = {"eval": eval_launched.get(name, 0),
                   "train": train_launched.get(name, 0),
                   "eval_fused": fused_launched.get(name, 0)}
        for path, counts in (list(kitti_launched.items())
                             + list(v1_launched.items())
                             + list(eval16_launched.items())
                             + list(train17_launched.items())
                             + list(disk_launched.items())
                             + list(opt_launched.items())
                             + list(bf16_launched.items())
                             + list(bf16t_launched.items())
                             + list(dp_launched.items())):
            by_path[path] = counts.get(name, 0)
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    log(f"chip_smoke: phases 1-22 in {time.perf_counter() - t_start:.1f} s")
    for entry in PLAIN_FLIPS:
        log("K7 flips at a BN wider than {4}: {0} call {1} BN {2} ({3} "
            "wide), {5} live rows: plain float32 {6} rows ({7} elements), "
            "kernel {8} rows ({9} elements)".format(*entry[:3], entry[3],
                                                    FLIP_CAP_WIDTH,
                                                    *entry[4:]))
    log(json.dumps({"kernels": list(report.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        main()
