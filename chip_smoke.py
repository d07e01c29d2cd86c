#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the fourteen Hopper kernels from ``icp_rust_tpu_torch/csrc`` (one
``nvcc`` per source, started together; prints the ptxas register and
spill lines, nn_list's and nn_pruned's work-item sizes and irls_loop's
and p2l_loop's cluster sizes), then runs these phases; any failure exits
non-zero:

1. nn_list (survivor-list exact 1-NN) vs its plain version at the main
   path's shapes (frames 0 and 1 of the synthetic sequence, 28,800
   points, xy payload, Morton-sorted): the cold bound, the warm bound of
   one real outer step, every chunk listed, a forced full sweep (cnt >
   cap at the TPU kernel's cap of 48), a masked db and exact ties.
   Indices, distances and payload must be bitwise equal, and equal to a
   brute-force sweep.  Each case prints its walk: chunk-walks, work
   items, the longest block's chunks.  Timed at the warm shape by its
   launcher alone and by its wrapper, and at work items of 4, 8 and 16
   chunks (each bitwise equal to the wrapper's result).
2. irls_loop vs its plain version on frame 1's correspondences at its
   first outer iteration (cold) and at its second (warm, the main path's
   usual 2-iteration call), N = 28,800: rot and t within IRLS_TOL with
   equal iterations; the first iteration's medians bitwise equal to the
   exact masked median and its sigmas to gn_stats' at the identity.
   Timed by its launcher alone at clusters of 8 and 16 blocks and by its
   wrapper.
3. icp2d_frame vs its plain version on a 640-point synthetic 2D pair
   padded to 768 and on 1,536 points: rot and t within FRAME_TOL, equal
   outer iterations.  Timed by its launcher alone on its cluster and on
   clusters of 1, 2, 4, 8 and 16 blocks (each bitwise equal), and by its
   wrapper.
4. The main path: ``run_odometry_fused`` over 96 synthetic 28,800-point
   frames, run twice (bitwise equal, path and stats; the second run is
   the timed one); ATE against ground truth < 0.05 m, and the plain path
   on the card over the first 8 frames within 1 mm of the kernel path.
5. A 2D sequence of 640-point scans padded to 768 through ``icp2d``,
   whose whole-frame kernel serves every frame; ATE < 0.05 m and within
   1 mm of the plain path.

The batched multi-pair path runs on 209 consecutive pairs of 210 synthetic
2D scans the size of the reference's scans/2d (the xy of synthetic
frames, each subsampled to a seeded count in 411-670 points, padded to
768):

6. nn_pairs and nn_pairs_list (pair-grid exact 1-NN) vs their plain
   versions at the batched path's shapes (xy payload, Morton-sorted): cold
   +inf bounds (every chunk listed), the warm bounds of one real outer
   step, a masked db, exact ties, and 4 pairs at the 4096-point db limit.
   Indices, distances and payload must be bitwise equal, and equal to a
   brute-force sweep; both also to their schedules' emulations, and at
   work items of 1, 2, 3, 6 and all of the db's chunks (nn_pairs) or of 1
   to all list entries (nn_pairs_list) with 1, 2 and 4 queries a thread
   (each printed with its launcher-alone time).  nn_pairs_list
   timed by its launcher alone and by its wrapper on the warm call,
   nn_pairs by its launcher alone and by its wrapper on the cold call,
   beside nn_pairs_list's launcher alone on the same cold case.
7. irls_loop_batched vs its plain version on the 209 pairs' first-iteration
   correspondences, plus an all-masked pair and a one-point pair, and on
   every call of phase 17's ``run_slam2d`` over 12 full xy frames
   (captured; 11 pairs of 28,160 points): rot and t within IRLS_TOL per
   pair with equal iteration counts, the degenerate pairs at the identity
   after 1 iteration.  Timed by its launcher alone on the wrapper's route,
   on one block a pair and at clusters of 1, 2, 4, 8 and 16 blocks a pair,
   and by its wrapper; prints the clusters the card holds at once.
8. icp2d_frame_pairs vs its plain version on the 209 unsorted pairs: rot
   and t within FRAME_TOL per pair, equal outer iteration counts (their
   spread printed); timed by its launcher alone on its setting and on
   every (blocks a pair, threads a block) of which the card holds all 209
   clusters at once (each within FRAME_TOL, bitwise equal at one thread
   count), and by its wrapper.
9. The batched path: ``parallel.sharded.batched_icp2d`` with
   ``frame_backend="auto"`` run twice (the second run is timed): pairs/s,
   per-pair error against the ground-truth relative transforms (gate: max
   translation error < 0.05 m), launch counts (1 nn_pairs, K - 1
   nn_pairs_list, K irls_loop_batched for K outer iterations); the plain
   path on the card within 1 mm per pair with no launch; then
   ``frame_backend="pairs"``: one icp2d_frame_pairs launch, within 1 mm
   per pair of the lockstep path.

The SE(3) point-to-plane path runs on the main path's frames (the
workload of benchmarks/bench_p2l.py), with voxel normals at 0.3 m:

10. nn_list at the p2l payload (D = 3, F = 4: [n, c = n . q]) on frames 0
    and 1, Morton-sorted: the cold bound, the warm bound of one real p2l
    outer step, and a masked db whose invalid normals carry the sentinel
    c.  Bitwise equal to the plain version and to brute force.
11. p2l_loop vs its plain version on frame 1's first-iteration
    correspondences (N = 28,800): rot and t within IRLS_TOL, equal
    iteration counts; one plane, five points, sigma = 0 and an all-masked
    input each stop at iteration 1 with the identity, in both; the first
    iteration's median and MAD bitwise equal to the exact median
    (torch.kthvalue), its sigma to p2l_stats'.  Timed by its launcher
    alone at clusters of 4, 8 and 16 blocks, one iteration and the
    call's, at 28,800, 28,160 (SLAM 3D), 14,400, 7,200 and 3,072 points
    (SLAM small), each within IRLS_TOL of the plain loop with equal
    iterations, and by its wrapper.
12. p2l_stats vs its plain version at the identity and at one warm
    transform, through ``align3d.weighted_gn_update_p2l_cuda``: the 27
    sums and the error within P2L_STATS_TOL relative, the count exact,
    sigma within P2L_SIGMA_TOL relative.  Timed by its launcher alone on
    clusters of 1, 2, 4, 8 and 16 blocks at 28,800 points and at their
    first 3,072 and 1,000 (each held to the same gates), and by its
    wrapper.
13. The p2l path: ``run_odometry_p2l_fused`` over the 96 frames, run
    twice (bitwise equal; the second run is timed): frames/s, ATE-xy < 0.05
    m and max |z| < 0.05 m against ground truth, outer iterations, and
    nn_list and p2l_loop launches each equal to the total outer
    iterations; the plain path on the card (torch NN and the LU loop of
    ``align_backend="torch"``) over the first 8 frames within 1 mm, with
    no launch.

The full-sequence SLAM paths:

14. nn_sweep, nn_matched and nn_pruned (kernels 5, 4 and 6: exact 1-NN
    sweeps without survivor lists) vs their plain versions and a
    brute-force sweep, bitwise (dist, idx, payload): nn_pruned at
    run_slam3d's full width (frames 0 and 1 as it pads them, 28,160
    points, unsorted and Morton-sorted), with exact ties, a masked db,
    the p2l payload unseeded and a fully masked db, each also bitwise
    equal to its schedule's emulation, whose sweeps per work item it
    prints; nn_sweep and nn_matched (p2l payload) on 3072-point frames,
    fully masked dbs, and 8 pairs of full xy scans with a batch axis (xy
    payload).  nn_pruned timed at full width by its launcher alone at
    work items of 1, 2 and 4 tiles and 2, 4 and 8 queries a thread (each
    bitwise equal), beside its instruction floor (the time its counted
    instructions take at the card's float32 instruction rate); nn_matched
    and nn_sweep bitwise equal to their schedule's emulation too, and
    timed likewise at work items of 1 chunk to the whole db and 2, 4 and
    8 queries a thread.
15. ``run_slam3d`` over the 96 frames with its defaults (loop radius 1 m,
    gap 8, at most 16 candidates, voxel normals at 0.3 m), twice (the
    second run timed): frames/s, candidates, closures (gate >= 1), graph
    error (gate: after <= before), ATE-xy of the optimized path (gate <
    0.05 m), launches (nn_pruned once per consecutive pair and verified
    candidate); the kernel and the plain path on the first 12 frames
    within 1 mm, the plain one with no launch.
16. ``run_slam3d`` on the room-and-ramp loop of the JAX package's
    tests/test_slam3d.py (28 poses of 3072 points): nn_matched and
    nn_sweep launch, nn_pruned and nn_list do not; >= 1 closure; the end
    error of the optimized path <= max(0.8 x odometry's, 0.02 m).
17. ``run_slam2d`` on the batched path's 210 scans (pair-grid and batched
    IRLS kernels; the mean NN distance on the plain sweep): gate error
    after <= before; then on the xy of 12 full frames (28,080 points),
    three runs (the second timed): the cold search of each batched
    ``icp2d`` call on nn_matched, every warm one on nn_pairs' seed prune
    (the third run's launches gated against its searches' warm flags),
    nn_sweep with a batch axis; each warm nn_pairs call of the third run,
    captured, bitwise nn_matched on the same packed inputs (the first its
    plain version too), with its chunk-walk share and launcher-alone time.

The last two kernels and the scan-to-submap path:

18. gn_stats and gn_stats_batched (kernels 12 and 13: one GN update's
    packed statistics) vs their plain versions through
    ``align2d.weighted_gn_update_cuda``, their only caller: kernel 12 on
    frame 1's first-iteration correspondences (N = 28,800) at the
    identity and at a warm transform, kernel 13 on the batched path's 209
    pairs (each at a seeded small transform) plus an all-masked pair and
    one with an odd count.  The ten sums and the error within
    GN_STATS_TOL of their Cauchy-Schwarz bounds, the count exact, sigma
    within GN_SIGMA_TOL relative, and the update's delta within
    GN_DELTA_TOL of ``weighted_gauss_newton_update``'s with equal ``ok``.
    Timed by their launchers alone (gn_stats as p2l_stats in phase 12, on
    every cluster size at 28,800, 3,072 and 1,000 points; gn_stats_batched
    on every route: one block a pair at each thread count of
    GN_BLOCK_THREADS that holds the pair, clusters of 1-16 blocks a pair,
    each held to the same gates) and by their wrappers.
19. ``run_submap_odometry`` at ``benchmarks/bench_submap.py``'s width (the
    96 frames padded to 28,800; voxel 0.05 m, capacity 2^17, a 65,536-row
    map view), twice (bitwise equal; the second run timed): frames/s, ATE
    < 0.05 m, no hidden cells, the dropped points printed, nn_list and
    irls_loop launches each equal to the total outer iterations; the plain
    path on the card over the first 8 frames within 1 mm, with no launch.
    Then nn_list on the inputs of the first run's 16th warm call (at the
    65,536-row view): bitwise equal to its plain version and to a
    brute-force sweep of the view, its walk, and its times and bound as in
    phase 1.
20. ``run_submap_odometry`` on the JAX package's tests/test_submap.py
    wall world (8 frames of 400 points, voxel 0.03 m, capacity 4096),
    fused and re-voxelize: max error < SUBMAP_2D_GATE_M; nn_matched and
    irls_loop launch.  Then nn_matched on the inputs of the fused run's
    last call (captured): bitwise equal to its plain version and its
    schedule's emulation, timed as in phase 14.

The modules users drive the paths through:

21. The per-frame runners on the main path's 96 frames:
    ``run_odometry_device`` with a ``MetricsLogger``: its path bitwise
    phase 4's fused path, its 95 rows' outer iterations, Huber errors
    and mean NN distances equal to the fused run's stats, nn_list and
    irls_loop launches each equal to the total outer iterations; killed
    after frame 40 with checkpoints every 10 frames and resumed over all
    96: bitwise the uninterrupted path.  The same for
    ``run_odometry_p2l`` against phase 13's fused run (nn_list and
    p2l_loop launches).  Frames/s of a second run with metrics, printed
    beside phases 4 and 13's fused runners'.
22. The batched path's 210 synthetic 2D scans written as ``NNN.txt``
    files: the native loader (``native/loader``, built by g++) bitwise
    the python loader padded and cast to float32; then ``cli.main``
    in-process on its default device: ``odometry2d`` without ``--f32``
    refused with guidance, ``odometry2d --f32 --compare-oracle`` (one
    icp2d_frame launch per frame, the native C++ oracle, ATE vs oracle <
    0.05 m),
    ``odometry2d --f32 --metrics --checkpoint --every 50`` (one JSONL row
    per frame, the NN + IRLS route, path end within 1 mm of the kernel-3
    run's) and ``slam --f32`` (nn_pairs, nn_pairs_list and
    irls_loop_batched launch; graph error after <= before).
    ``odometry3d`` and ``slam3d`` read HDF5 through h5py and are reported
    as not run where it is absent.
23. ``utils/profiling.trace`` around ``annotate("odometry")`` and the
    main path's first 4 frames: the trace names the range and the nn_list
    and irls_loop kernels; ``utils/debug.checked(run_odometry_fused)``
    passes; ``debug_mode()`` raises on 0 / 0.  Then
    ``graph_schur.optimize_schur`` on phase 15's float64 pose graph (96
    poses, its closures) within 1e-8 of ``pose_graph.optimize(solve=
    "dense")``, both timed by the host clock beside the residual and
    Jacobian evaluations they share.

``parallel/`` on torch.distributed:

24. Four gloo ranks share the card (NCCL refuses two ranks on one card;
    gloo reduces and gathers card tensors itself, the ring's send/recv go
    through host buffers), each passing the global arrays: pairs (frame
    0, frame k), k = 1-4, of the 96 frames, warm-started from the main
    path's estimate for frame k - 1, through ``dp_sp_icp3d_planar`` and
    ``dp_sp_icp_p2l`` on a (2, 2) mesh (kernel 4 in the ring), and
    ``dp_sp_icp_p2l`` on (4, 1), a pair a rank; the xy of
    frames 0 and 1 through ``sharded_icp2d`` on (1, 4) (kernel 6); the
    ring alone, frame 1 against frame 0 and with a batch axis (kernels 6,
    5 and 4); ``batched_icp2d`` on dp = 4 over the batched path's first
    208 pairs, 52 a rank, lockstep (kernels 8, 9, 7) and on the
    pair-frame route (kernel 10); ``optimize_distributed`` and the
    segment-sharded ``optimize_schur`` on phase 15's float64 graph.
    Gates: the drivers' xy and rotation within 1 mm of the single-device
    ``icp3d_planar`` / ``icp2d`` (2e-3 of ``icp_point_to_plane``, and
    in z too on (4, 1); on (2, 2) its z, weakly constrained here and
    moved by per-shard normals, to a max |z| at most 0.015 m beyond the
    single-device driver's) and the ATE gate; the
    ring bitwise the search over the whole cloud; each rank's batched
    slice bitwise its single-device call and the whole within 1e-5 of
    the full call; the graph solves within 1e-5 / 1e-6 of the local CG
    and 1e-10 of the local Schur solve.  Then one NCCL rank on the card
    (``dp_sp_icp3d_planar`` on pair 1, within 1 mm of the four ranks')
    and ``dryrun_multichip(4, "cuda")``.  Each sub-run prints its host
    seconds and the collectives it issued a rank; four processes
    time-sharing one card give no scaling figure.  Its paths' launches
    are summed over the ranks.

The last of the JAX package (batched point-to-plane ICP, nn_method="mxu",
the grid hash):

25. Batched ``icp_point_to_plane``, twice each (the second call timed,
    pairs/s by the host clock, synchronised): (a) the 95 consecutive pairs
    (k, k + 1) of the 96 frames at full width from identity, voxel normals
    at 0.3 m (kernel 4 at D 3 / P 4 on the cold iteration, kernel 8's seed
    prune on every warm one, and the plain batched inner loop, the JAX
    package's route for a batch); (b)
    the 27 consecutive pairs of phase 16's room frames (3,072 points,
    voxel 0.4 m) from their true relative poses perturbed by a seeded
    twist of 2 cm and 0.5 degrees (kernel 8 on the cold iteration, kernel
    9 on every warm one).  Gates for both: each pair's translation error
    against ground truth < 0.05 m; each pair within 1 mm of the
    single-pair call on it (in (a) 1 cm in z, P2L_BATCH_Z_M) and, for the
    first 8, within 1 mm in every DoF of the batched plain route (no
    launch); the launches.  Prints outer iterations and max |t_z|.  (a)'s
    cold kernel 4 call, captured, is held bitwise against its plain
    version and brute force on all 95 pairs, and timed by its launcher
    alone at every schedule; each of its warm kernel 8 calls, captured,
    bitwise against kernel 4 on the same inputs (the first also against
    its plain version), with its chunk-walk share and its launcher-alone
    time, the first at work items of WIDE_ITEMS chunks and 1, 2 and 4
    queries a thread.  Every kernel 8 and 9 call of (b)'s first
    run, captured, is held bitwise against its plain version, its
    schedule's emulation, brute force and at every schedule, and the cold
    call and the first warm call are timed by their launchers alone (the
    4-lane payload; the results whose winner carries the invalid-plane
    sentinel c are counted).
26. ``run_odometry_fused`` with nn_method="mxu" (the cross term a float32
    matmul on the plain sweep; the IRLS loop stays on kernel 2) over the
    first 16 of the 96 frames at full width, twice: ATE < 0.05 m,
    frames/s, outer iterations; then one captured NN call against the
    direct kernel route: the share of equal indices, the largest distance
    gap.
27. ``ops/gridhash`` on frames 0 (db) and 1 (queries) at full width, r
    0.25 m, cap 32, 2^16 slots (one of ``benchmarks/profile_gridhash.py``'s
    settings): overflow_frac printed; the found set equal to brute force's
    in-radius set (kernel 5 with a batch axis); every result that differs
    from brute force's explained by a dropped point; fields and results
    bitwise the same call's on the CPU; build and query ms.

The launch counts of each path are zeroed just before it and read just
after.  Prints one ``{"kernels": [...]}`` line, one entry per kernel (the
fourteen): the contract's keys for its first timed shape and path
(``ms`` by the launcher alone for every kernel, beside
``wrapper_ms``), its launches on every path driven
(``launches_by_path``) and the other shapes it was timed at
(``other_shapes``); then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Bounds:
the larger of (bytes read once + written once) / 3.35 TB/s and counted
operations / 67 TFLOP/s (H100 SXM float32 without tensor cores).

    python3 chip_smoke.py --times

builds the kernels and only times kernels 12, 14, 13, 3, 8, 9 and 10 by
their launchers alone at every shape their paths give them (kernels 12
and 14 at 28,800, 3,072 and 1,000 points, kernel 13 at 211 x 768 and at
SLAM 2D wide's 11 x 28,160 and its first 1,536-4,096 points, kernel 8 at
the batched path's cold call and phase 25(b)'s (D 3 / P 4), kernel 9 on
every call of the batched path, of SLAM 2D and of phase 25(b), kernel 10
at 209 x 768, 64 x 1,536 and B = 1), at every
cluster size, route, schedule or setting the tree has, each call held
against its plain version, with the two frame kernels' splits of an
outer iteration into its sweep, IRLS loop and tail per pair
(``kernel_times``, ``frame_split``): one JSON line, to compare two trees
in one run on one card.  Then it holds kernel 10 at every shape to
``frame_gate`` (within FRAME_TOL of its plain version with equal outer
iteration counts; a pair outside FRAME_TOL passes only with an equal
count at an exact fixed point of the plain outer step that lies within
FRAME_TOL of the plain loop with one float32 nearest-neighbour near tie
taken the other way, and is printed with its tie), and on a failure
traces the worst failing pair through kernels 10 and 3
(``frame_trace``: per outer iteration the kernel's matches against the
plain and the exact nearest neighbours of its own rows, its IRLS result
against the plain loop on its own inputs) and exits non-zero.

    python3 chip_smoke.py --profile

adds torch.profiler traces of the main path's first 16 frames, of the
batched path, of the p2l path's first 16 frames (with the voxel normals'
share), of run_slam3d over the 96 frames (with a host-clock split into
its ICP calls, its mean-NN-distance calls and its graph solve), of the
submap path over the 96 frames (with a host-clock split into its ICP
calls, hash inserts and Morton resorts) and of phase 25(a)'s batched p2l
call: device time by kernel and the device's idle share, and the
profiler's tables.

The phases take ``device`` and sizes, so a CPU test rehearses them at a
tiny size with the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import glob
import importlib.util
import io as io_std
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from icp_rust_tpu_torch import cli, convert
from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import icp2d as m_icp
from icp_rust_tpu_torch.models import icp_p2l as m_p2l
from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.models import slam as m_slam
from icp_rust_tpu_torch.models import submap as m_submap
from icp_rust_tpu_torch.models.driver import is_identity, spatial_sort
from icp_rust_tpu_torch.models.graph_schur import optimize_schur
from icp_rust_tpu_torch.models.odometry import ate_rmse, \
    run_odometry_device, run_odometry_fused, run_odometry_p2l, \
    run_odometry_p2l_fused
from icp_rust_tpu_torch.models.slam import run_slam2d, run_slam3d
from icp_rust_tpu_torch.models.submap import run_submap_odometry
from icp_rust_tpu_torch.native import loader as native_loader
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, align3d, \
    align3d_cuda, cuda_build, gridhash, nn_cuda, nn_pairs_cuda, \
    nn_sweep_cuda, robust
from icp_rust_tpu_torch.ops import nn as m_nn
from icp_rust_tpu_torch.ops.nn import nearest_neighbor_matched, nn_torch
from icp_rust_tpu_torch.ops.normals import estimate_normals_voxel
from icp_rust_tpu_torch.parallel.sharded import batched_icp2d
from icp_rust_tpu_torch.utils import debug, io, profiling
from icp_rust_tpu_torch.utils.checkpoint import SequenceCheckpointer
from icp_rust_tpu_torch.utils.metrics import MetricsLogger

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PAD_TO = 28800
ATE_GATE_M = 0.05
PLAIN_GATE_M = 1e-3
# Solver kernels vs their plain versions, rot and t (metre-scale data):
# the kernels take their sums over the points in another order (a block
# tree against torch's reductions), a difference of f32 roundoff that the
# loops carry on.  A stop decision of the IRLS loop that flipped on it
# would move the result by up to 1e-3 (sqrt of the step tolerance) and
# fail the check, as it should.
IRLS_TOL = 1e-5
FRAME_TOL = 1e-5
# Operations per valid point and IRLS iteration, counted from
# csrc/irls.cuh: residuals 10; median and MAD, each 4 radix passes of ~7
# (key, prefix test, digit, histogram add) on 2 dims plus a count/max
# pass of 3 on 2 dims, the MAD's passes 2 more for |r - med|: 62 + 78;
# normal-equation sums and Huber error 44.
IRLS_OPS_PER_POINT = 194
# Per (query, db point) pair: nn_list 3 sub + 3 mul + 3 add + 1 compare;
# icp2d_frame's 2D sweep 2 + 2 + 1 + 1.
NN_OPS_PER_PAIR_3D = 10
NN_OPS_PER_PAIR_2D = 6
# Instructions a pair issues in nn_pruned's inner loop (csrc/nn_pruned.cu,
# no fused multiply-add): D sub, D mul, D - 1 add, a compare, two selects.
NN_INSTR_PER_PAIR = {2: 8, 3: 11}
# The H100 SXM's float32 instruction rate: 132 SMs x 128 lanes at its 1.98 GHz
# boost clock, one instruction a lane a cycle.  PEAK_F32_PER_S counts a
# fused multiply-add as two operations; a kernel that may not fuse issues
# at most this many.
PEAK_F32_INSTR_PER_S = 132 * 128 * 1.98e9
# Operations per valid point and p2l IRLS iteration, counted from
# csrc/p2l.cuh: residual 26 (p = R s + t 18, n . (p - d) 8); median 4
# radix passes of ~7 plus a count/max pass of 3, the MAD's 5 passes 2 more
# each for |r - med|: 31 + 41; the sums pass 117 (p again 18, J 9, weight
# 5, 21 JtJ sums of 3, 6 Jtr sums of 3, error 4).
P2L_OPS_PER_POINT = 215
# The p2l workload (benchmarks/bench_p2l.py): voxel normals at 0.3 m; the
# z gate of its planar-motion data (bench_p2l.py:53-61).
P2L_VOXEL_M = 0.3
P2L_Z_GATE_M = 0.05
# p2l_stats vs its plain version: the 27 sums and the error relative to
# the Cauchy-Schwarz bound of each sum's absolute terms (f32 roundoff of
# 28,800-term sums in two orders); the count exact; sigma, an exact order
# statistic of residuals computed by the same float32 ops, relative.
P2L_STATS_TOL = 1e-5
P2L_SIGMA_TOL = 1e-6
# The batched workload: 210 scans, the size of the reference's scans/2d
# sequence (411-670 points per scan, padded to 768).
BATCH_SCANS = 210
BATCH_PAD = 768
BATCH_COUNTS = (411, 670)
# gn_stats(_batched) vs their plain versions, as p2l_stats: the ten sums
# and the error against the Cauchy-Schwarz bound of each sum's absolute
# terms, sigma relative; the update's delta (solver units, metres here)
# against weighted_gauss_newton_update's, whose sums run in another order.
GN_STATS_TOL = 1e-5
GN_SIGMA_TOL = 1e-6
GN_DELTA_TOL = 1e-5
# The submap workload (benchmarks/bench_submap.py:47): ~54k occupied cells
# at 96 frames, a 2^17-slot table (load ~0.41) and a 2^16-row view.
SUBMAP_KW = dict(voxel_size=0.05, capacity=1 << 17, view_rows=1 << 16)
# The warm nn_list call of the submap path that kernel 1 is timed on: the
# 16th, in frame 2 or 3, where the map view is full width.
SUBMAP_NN_CALL = 16
# The wall world of the JAX package's tests/test_submap.py and its gate.
SUBMAP_2D_KW = dict(voxel_size=0.03, capacity=4096)
SUBMAP_2D_GATE_M = 0.02
# Batched p2l (phase 25): the batched plain route's pairs (nn_torch holds
# a (B, Q, tile) distance block, ~22 GB at B = 95 and 28,800 points), and
# the room pairs' warm starts: true poses perturbed by a seeded twist of
# these translation and rotation norms.
P2L_BATCH_PLAIN = 8
# Phase 25(a)'s z against the single-pair calls (the plain route keeps
# PLAIN_GATE_M in z).  The synthetic world is vertical walls: every normal
# is horizontal, so the data barely constrain z.  On an H100 one pair and
# the batch differed by 2.4e-3 m in z at 2 of 95 pairs, by 1.5e-4 m in xy
# and 1.1e-4 in rotation.  Float64 runs on the CPU (pair 45, from
# identity, voxel 0.3 m) show the cause (ROADMAP.md section 1, F1):
# batching adds nothing (batched and single calls agree within 2e-17 m in
# z); the single pair's float32 kernel route takes another path.  It
# splits from the plain route at outer iteration 2 (3.0e-4 m in that
# step's z) and exits two iterations early at z 0.00444 m, where the
# float32 batch, JAX's float32 call and float64 land at 0.00202.  Each of
# its NN results is bitwise nn_torch and each p2l_loop call within
# 2.3e-7 m of JAX's kernel; the CPU reproduces the card's gap (2.418e-3
# against 2.423e-3 m in z), and either float32 route can take such a
# path.  xy and rotation keep PLAIN_GATE_M; z keeps this, and the
# ground-truth gate.
P2L_BATCH_Z_M = 1e-2
ROOM_TWIST_M = 0.02
ROOM_TWIST_RAD = float(np.deg2rad(0.5))
# Phase 25(a)'s warm kernel 8 calls: the work items (in 128-point chunks)
# its first warm call is timed at, beside the wrapper's.
WIDE_ITEMS = (1, 4, 16, 64, 225)
# nn_method="mxu" (phase 26): the main path's first frames.
MXU_FRAMES = 16


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` in ms: CUDA events on the card (after warm-up),
    the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def launcher_ms(name: str, args, device, reps: int = 50, fn=None):
    """Mean time of a kernel's launcher alone on prepared arguments: CUDA
    events over ``reps`` launches with no wrapper work between them (events
    over back-to-back wrapper calls time the slower of host and device).
    ``fn``: another C entry point of the kernel's library.  None on the
    CPU, where there is no kernel."""
    if torch.device(device).type != "cuda":
        return None
    fn = fn or cuda_build.launcher(name)

    def call():
        status = fn(*args)
        if status != 0:
            raise RuntimeError(f"{name} launch failed: {status}")
    return time_ms(call, device, reps=reps)


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_F32_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _config(**kw):
    base = dict(compute_dtype=torch.float32, point_scale=1.0,
                det_rel_eps=1e-9, nn_dst_tile=2048, nn_query_tile=256)
    base.update(kw)
    return ICPConfig(**base)


def frames3d(n_frames: int, stride: int = 1, seed: int = 0):
    """Synthetic 28,800-point frames (every ``stride``-th point) padded to
    PAD_TO (or a multiple of 128 when subsampled), and the ground-truth
    trajectory in frame 0's coordinates."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=seed)
    frames = [f[::stride] for f in frames]
    pts, mask = io.pad_points(frames, pad_to=PAD_TO if stride == 1 else None)
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[1:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    return pts, mask, gt


def _first_pair(device, stride):
    """Frames 0 (src) and 1 (dst), Morton-sorted as icp3d_planar sorts
    them."""
    pts, mask, _ = frames3d(2, stride)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    src, smask, _ = spatial_sort(p[0], k[0])
    dst, dmask, _ = spatial_sort(p[1], k[1])
    return src, smask, dst, dmask


def _nn_list_case(name, query, db, dmask_c, payload, qb_fn, device,
                  tile: int, q_tile: int, cap=None):
    """One nn_list check: the kernel vs its plain version (bitwise dist,
    idx, payload) and vs a brute-force sweep (idx, dist, and the winner's
    payload where a valid point exists).  ``cap`` defaults to every chunk,
    as ``nn_seeded`` lists them; a smaller one forces full sweeps."""
    n = query.shape[0]
    qp = -(-n // q_tile) * q_tile
    d_dim = query.shape[1]
    pack = nn_cuda.pack_db(db, dmask_c, payload, db_tile=tile)
    query_p = torch.zeros((qp, d_dim), dtype=torch.float32, device=device)
    query_p[:n] = query
    return _nn_list_check(name, query_p, pack, qb_fn(query_p, pack), d_dim,
                          q_tile, cap, brute=(query, db, dmask_c, payload,
                                              tile))


def _nn_list_check(name, query_p, pack, qb, d_dim, q_tile, cap=None,
                   brute=None):
    """Kernel 1 at one call's inputs (a packed db and the bounds): bitwise
    against its plain version (and against a brute-force sweep when
    ``brute`` gives the unpacked inputs); prints the walk."""
    device = query_p.device
    n_chunks = pack.dbf_cm.shape[1] // 128
    cap = n_chunks if cap is None else cap
    lists, cnt = nn_cuda._survivor_lists(query_p, pack.cbox, qb, d_dim,
                                         q_tile, cap)
    args = (query_p, pack.dbf_cm, lists, cnt, d_dim, q_tile, cap)
    got = nn_cuda.nn_list(*args)
    want = nn_cuda.nn_list_plain(*args)
    _sync(device)
    for a, b, what in zip(got, want, ("dist", "idx", "payload")):
        if not torch.equal(a, b):
            raise RuntimeError(f"nn_list {name}: {what} differs from the "
                               "plain version")
    checked = "plain"
    if brute is not None:
        query, db, dmask_c, payload, tile = brute
        n = query.shape[0]
        ref = nn_torch(query, db, dmask_c, tile=tile)
        hit = torch.isfinite(ref.dist_sq)
        want_pay = payload[ref.index.long()]
        if not (torch.equal(got[1][:n], ref.index)
                and torch.equal(nn_cuda._trim_sentinel(got[0][:n]),
                                ref.dist_sq)
                and torch.equal(got[2][:n][hit], want_pay[hit])):
            raise RuntimeError(f"nn_list {name}: differs from brute force")
        checked = "plain and brute force"
    walk = nn_cuda.walk_stats(cnt, cap, n_chunks)
    fin = torch.isfinite(got[0])
    err = float(torch.max(torch.abs(got[0][fin] - want[0][fin]))) \
        if bool(fin.any()) else 0.0
    case_ms = time_ms(lambda: nn_cuda.nn_list(*args), device, reps=5)
    print(f"# nn_list {name}: bitwise equal to {checked}; "
          f"{walk['chunk_walks']} chunk-walks in {walk['items']} work items "
          f"of <= {nn_cuda.ITEM_CHUNKS} (longest block {walk['longest']} "
          f"chunks; full sweeps {walk['full_sweeps']}; {walk['blocks']} "
          f"blocks) over {cnt.shape[0]} tiles of {n_chunks} chunks, cap "
          f"{cap}; {case_ms:.4f} ms")
    n = brute[0].shape[0] if brute is not None else query_p.shape[0]
    return dict(args=args, walk=walk, err=err, dist=got[0][:n],
                pay=got[2][:n], out=got)


def _nn_list_record(case, q_tile: int, device, path: str):
    """Kernel 1's timing (its launcher alone, and its wrapper), plain
    timing and bound at one case's shapes; on the card also the launcher
    at work items of 4, 8 and 16 chunks, each bitwise equal to the
    wrapper's result."""
    args = case["args"]
    query_p, dbf_cm = args[0], args[1]
    d_dim = args[4]
    wrapper_ms = time_ms(lambda: nn_cuda.nn_list(*args), device, reps=50)
    plain_ms = time_ms(lambda: nn_cuda.nn_list_plain(*args), device, reps=3)
    item_ms, empty_ms = {}, None
    if torch.device(device).type == "cuda":
        for item in (4, 8, 16):
            largs, out, part = nn_cuda._nn_list_args(*args, item=item)
            item_ms[item] = launcher_ms("nn_list", largs, device)
            _sync(device)
            if not all(torch.equal(a, b) for a, b in zip(out, case["out"])):
                raise RuntimeError(f"nn_list {path}: work items of {item} "
                                   "chunks change the result")
            del part
        # The same grid with every walk empty: launch and exiting blocks.
        empty = (*args[:3], torch.zeros_like(args[3]), *args[4:])
        largs, _, part = nn_cuda._nn_list_args(*empty)
        empty_ms = launcher_ms("nn_list", largs, device)
        del part
    ms = item_ms.get(nn_cuda.ITEM_CHUNKS, wrapper_ms)
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    pairs = float(case["walk"]["chunk_walks"]) * 128 * q_tile
    n_bytes = (qp * d_dim * 4 + dbf_cm.numel() * 4 + args[2].numel() * 4
               + args[3].numel() * 4 + qp * (4 + 4 + 4 * f_dim))
    b, by = bound_ms(n_bytes, pairs * NN_OPS_PER_PAIR_3D)
    print(f"# nn_list {path}: launcher alone {ms} ms (work items of 4, 8, "
          f"16 chunks: {item_ms}; every walk empty: {empty_ms}), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms "
          f"({by})")
    return dict(name="nn_list", route="cuda",
                source="icp_rust_tpu_torch/csrc/nn_list.cu",
                replaces="icp_rust_tpu/ops/nn_pallas.py:873", ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                path=path, extra=dict(wrapper_ms=wrapper_ms, walk=case["walk"],
                                      item_ms=item_ms, empty_ms=empty_ms))


def phase_nn_list(device="cuda", stride: int = 1, tile: int = 2048,
                  q_tile: int = 256):
    """Kernel 1 vs its plain version and a brute-force sweep (xy
    payload, the main path's)."""
    cfg = _config(nn_dst_tile=tile, nn_query_tile=q_tile)
    src, smask, dst, dmask = _first_pair(device, stride)
    n = src.shape[0]
    qp = -(-n // q_tile) * q_tile
    eps = torch.finfo(torch.float32).eps

    def run_case(name, query, db, dmask_c, qb_fn):
        return _nn_list_case(name, query, db, dmask_c, db[:, :2], qb_fn,
                             device, tile, q_tile)

    def cold(query_p, pack):
        return nn_cuda._center_bound(query_p, pack.cbox, 3)

    errs = []
    c = run_case("cold", src, dst, dmask, cold)
    errs.append(c["err"])
    # One real outer step: the solve on the cold correspondences, then
    # the warm bound of the next iteration.
    dt = align2d.estimate_transform(src[:, :2], c["pay"], smask, cfg)
    xy = dt.apply_points(src[:, :2])
    src1 = torch.cat([xy, src[:, 2:]], dim=-1)
    move = torch.linalg.norm(xy - src[:, :2], dim=-1)
    qb_w = (torch.sqrt(c["dist"]) + move) ** 2 * (1.0 + 32.0 * eps)

    def warm_bound(query_p, pack):
        qb = torch.full((qp,), float("-inf"), device=device)
        qb[:n] = qb_w
        return qb

    warm = run_case("warm", src1, dst, dmask, warm_bound)
    errs.append(warm["err"])
    # Every chunk listed; then the cnt > cap path, at the TPU kernel's cap.
    every = lambda q, p: torch.full((qp,), 1e30, device=device)  # noqa
    errs.append(run_case("every-chunk", src1, dst, dmask, every)["err"])
    n_chunks = -(-dst.shape[0] // tile) * tile // 128
    errs.append(_nn_list_case("full-sweep", src1, dst, dmask, dst[:, :2],
                              every, device, tile, q_tile,
                              cap=min(48, n_chunks - 1))["err"])
    gen = torch.Generator(device="cpu").manual_seed(5)
    drop = torch.rand(dst.shape[0], generator=gen).to(device) < 0.5
    errs.append(run_case("masked-db", src, dst, dmask & ~drop, cold)["err"])
    # Exact ties: every db point twice, queries on db points.
    half = int(dmask.sum()) // 2
    dup = torch.cat([dst[:half], dst[:half]])
    dup_mask = torch.ones(dup.shape[0], dtype=torch.bool, device=device)
    tie = run_case("ties", dst[:n], dup, dup_mask, cold)
    errs.append(tie["err"])

    # Timing at the main path's warm shape.
    rec = _nn_list_record(warm, q_tile, device, "main")
    rec.update(max_abs_err=max(errs))
    return rec


def phase_irls(device="cuda", stride: int = 1):
    """Kernel 2 vs its plain version on frame 1's correspondences at its
    first outer iteration (cold) and at its second (warm: the main path's
    usual call, one step and the stopping iteration)."""
    cfg = _config()
    src, smask, dst, dmask = _first_pair(device, stride)
    xy = src[:, :2].contiguous()
    recs = []
    for name in ("cold", "warm"):
        query = torch.cat([xy, src[:, 2:]], dim=-1)
        _, matched = nearest_neighbor_matched(
            query, dst, dmask, payload=dst[:, :2], backend="torch",
            tile=cfg.nn_dst_tile)
        args = (xy, matched, smask, cfg.huber_k, cfg.det_rel_eps,
                cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
        recs.append(_irls_record(name, args, device))
        step = align2d.estimate_transform(
            xy, matched, smask, cfg.with_(align_backend="torch"))
        xy = step.apply_points(xy)
    return recs


def _irls_record(name, args, device):
    """Kernel 2 at one call's inputs: rot and t within IRLS_TOL of the
    plain loop with equal iterations; on the card its first iteration's
    medians bitwise equal to the exact masked median, its sigmas to
    gn_stats' at the identity (irls.cuh's one-block medians), the launcher
    alone at clusters of 8 and 16 blocks; times and bound."""
    rot, t, it = align2d_cuda.irls_loop(*args)
    rot_p, t_p, it_p = align2d_cuda.irls_loop_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    print(f"# irls_loop {name}: iterations kernel {int(it)} plain "
          f"{int(it_p)}; max |diff| rot/t {err:.3e} (tol {IRLS_TOL})")
    if not (err <= IRLS_TOL and int(it) == int(it_p)):
        raise RuntimeError(f"irls_loop {name} differs from its plain "
                           f"version: {err}, iterations {int(it)} vs "
                           f"{int(it_p)}")
    src, dst, mask = args[:3]
    cluster_ms, one_iter_ms = {}, None
    if torch.device(device).type == "cuda":
        out = align2d_cuda.irls_loop_out(*args)
        r = (src - dst).T
        med, _ = robust.masked_median(r, mask[None].expand(r.shape))
        ident = torch.eye(2, device=src.device)
        sig = align2d_cuda.gn_stats(src, dst, mask, ident,
                                    torch.zeros(2, device=src.device),
                                    args[3])[12:14]
        if not (torch.equal(out[8:10], med) and torch.equal(out[10:12], sig)):
            raise RuntimeError(f"irls_loop {name}: first medians/sigmas "
                               f"{out[8:12].tolist()} vs {med.tolist()} "
                               f"{sig.tolist()}")
        print(f"# irls_loop {name}: first iteration's medians bitwise equal "
              "to the exact median, sigmas to gn_stats'")
        # One iteration alone (max_iter 1): with the 2-iteration time it
        # splits a call into set-up and iterations.
        largs, _, keep = align2d_cuda._irls_loop_args(*args[:6], 1,
                                                     args[7])
        one_iter_ms = launcher_ms("irls_loop", largs, device)
        del keep
        for c in (8, 16):
            largs, o, _ = align2d_cuda._irls_loop_args(*args, cluster=c)
            cluster_ms[c] = launcher_ms("irls_loop", largs, device)
            _sync(device)
            d = float(torch.max(torch.abs(o[:6] - out[:6])))
            if not (d <= IRLS_TOL and bool(o[6] == out[6])
                    and torch.equal(o[8:12], out[8:12])):
                raise RuntimeError(f"irls_loop {name}: a cluster of {c} "
                                   f"moves the result by {d}")
    wrapper_ms = time_ms(lambda: align2d_cuda.irls_loop(*args), device,
                         reps=50)
    ms = cluster_ms.get(align2d_cuda.IRLS_CLUSTER, wrapper_ms)
    plain_ms = time_ms(lambda: align2d_cuda.irls_loop_plain(*args), device,
                       reps=2)
    n = src.shape[0]
    ops = float(int(it)) * float(mask.sum()) * IRLS_OPS_PER_POINT
    b, by = bound_ms(4 * n * 4 + n + 12 * 4, ops)
    print(f"# irls_loop {name}: launcher alone {ms} ms (clusters of 8, 16: "
          f"{cluster_ms}; one iteration: {one_iter_ms}), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.7f} ms "
          f"({by})")
    return dict(name="irls_loop", route="cuda",
                path="main" if name == "cold" else "main-" + name,
                source="icp_rust_tpu_torch/csrc/irls_loop.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:714",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None,
                extra=dict(wrapper_ms=wrapper_ms, cluster_ms=cluster_ms,
                           one_iteration_ms=one_iter_ms,
                           iterations=int(it)))


def pair2d(device, n: int = 640, pad: int = 768, seed: int = 1):
    """A synthetic 2D scan pair: xy of ``n`` seeded points of frames 0 and
    1 of the synthetic sequence, each padded to ``pad``."""
    frames, _ = io.synthesize_frames3d(2, seed=0)
    rng = np.random.default_rng(seed)
    out = []
    for f in frames:
        xy = f[rng.choice(len(f), n, replace=False), :2]
        p, m = io.pad_points([xy], pad_to=pad)
        out += [torch.as_tensor(p[0], dtype=torch.float32, device=device),
                torch.as_tensor(m[0], device=device)]
    return out


def phase_frame(device="cuda", n: int = 640, pad: int = 768,
                n_max: int = align2d_cuda.FRAME_MAX_POINTS):
    """Kernel 3 vs its plain version on ``frame_inputs``' pairs (``n``
    points padded to ``pad``, and ``n_max`` points), equal outer
    iterations; timed by its launcher alone on its cluster and on every
    cluster size, and by its wrapper: one record per pair."""
    cfg = _config()
    t0 = RigidTransform2.identity(dtype=torch.float32, device=device)
    on_card = torch.device(device).type == "cuda"
    records = []
    for shape, (sp, sm, dp, dm) in frame_inputs(device, n, pad,
                                                 n_max).items():
        rot, t, it = m_icp.icp2d_frame(sp, dp, sm, dm, t0, cfg)
        rot_p, t_p, it_p = m_icp.icp2d_frame_plain(sp, dp, sm, dm, t0,
                                                   cfg)
        err = max(float(torch.max(torch.abs(rot - rot_p))),
                  float(torch.max(torch.abs(t - t_p))))
        print(f"# icp2d_frame {shape}: outer iterations kernel {int(it)} "
              f"plain {int(it_p)}; max |diff| rot/t {err:.3e} (tol "
              f"{FRAME_TOL})")
        if not err <= FRAME_TOL:
            raise RuntimeError(f"icp2d_frame differs from its plain "
                               f"version: {err}")
        if int(it) != int(it_p):
            raise RuntimeError("icp2d_frame: outer iterations differ from "
                               "the plain version's")
        wrapper_ms = time_ms(lambda: m_icp.icp2d_frame(
            sp, dp, sm, dm, t0, cfg), device, reps=20 if on_card else 1)
        extra = dict(shape=shape, wrapper_ms=wrapper_ms)
        if on_card:
            times = _frame_times((sp, sm, dp, dm), device)
            outer, inner, ms = times["outer"], times["inner"], times["ms"]
            cluster = cuda_build.query("icp2d_frame_cluster")(sp.shape[0])
            extra.update(cluster=cluster, cluster_ms=times["cluster_ms"])
            print(f"# icp2d_frame {shape}: launcher alone {ms} ms on a "
                  f"cluster of {cluster} (by cluster size "
                  f"{times['cluster_ms']}), wrapper {wrapper_ms:.4f} ms")
        else:
            outer, inner, ms = int(it), 0, wrapper_ms
        plain_ms = time_ms(lambda: m_icp.icp2d_frame_plain(
            sp, dp, sm, dm, t0, cfg), device, reps=2)
        n_src, n_dst = float(sm.sum()), float(dm.sum())
        ops = (outer * n_src * (n_dst * NN_OPS_PER_PAIR_2D + 6)
               + inner * n_src * IRLS_OPS_PER_POINT)
        n, m = sp.shape[0], dp.shape[0]
        # src (N, 2) and mask, dst (M, 2), warm start 6 floats, output 8.
        b, by = bound_ms(n * 4 * 3 + m * 4 * 2 + 14 * 4, ops)
        records.append(dict(
            name="icp2d_frame", route="cuda", path="2d",
            source="icp_rust_tpu_torch/csrc/icp2d_frame.cu",
            replaces="icp_rust_tpu/ops/align2d_pallas.py:888",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None, extra=extra))
    return records


def _run_path(pts, mask, cfg, device, with_metrics: bool):
    """One timed run of the port's entry point with the launch counts
    zeroed just before it; returns (path, stats or None, seconds,
    launches)."""
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    out = run_odometry_fused(pts, mask, cfg, with_metrics=with_metrics,
                             device=device)
    _sync(device)
    sec = time.perf_counter() - t0
    stats = out[2] if with_metrics else None
    return out[1], stats, sec, dict(cuda_build.LAUNCHES)


def phase_main(device="cuda", n_frames: int = 96, stride: int = 1,
               plain_frames: int = 8, tile: int = 2048):
    """The main path: 3D odometry over the synthetic sequence, once to warm
    up and once timed."""
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    path1, stats1, first_sec, _ = _run_path(pts, mask, cfg, device, True)
    path, stats, sec, launches = _run_path(pts, mask, cfg, device, True)
    if not (np.array_equal(path, path1) and all(
            torch.equal(a, b) for a, b in zip(stats, stats1))):
        raise RuntimeError("main path: two runs differ")
    ate = ate_rmse(path, gt)
    outer = stats.outer_iters.cpu().numpy()
    fps = (n_frames - 1) / sec
    print(f"# main path: {n_frames} frames of {pts.shape[1]} points, "
          f"{sec:.4f} s, {fps:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s), bitwise equal to the first run; ATE vs "
          f"ground truth {ate:.6f} m; outer iterations per frame mean "
          f"{outer.mean():.3f} min {outer.min()} max {outer.max()}; "
          f"launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"main path ATE {ate} >= {ATE_GATE_M}")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    p_path, _, p_sec, p_launch = _run_path(pts[:plain_frames],
                                           mask[:plain_frames], plain_cfg,
                                           device, True)
    d = ate_rmse(p_path, path[:plain_frames - 1])
    print(f"# plain path on the first {plain_frames} frames: {p_sec:.3f} s; "
          f"trajectory vs kernel path {d:.3e} m (gate {PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"plain path launched kernels: {p_launch}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate, fps=fps, seconds=sec,
                outer_mean=float(outer.mean()), path=path, stats=stats)


def phase_2d(device="cuda", n_frames: int = 8, n_points: int = 640,
             pad: int = 768):
    """A 2D sequence (xy of the synthetic frames) through icp2d, whose
    whole-frame kernel serves every frame."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=2)
    rng = np.random.default_rng(3)
    xy = [f[rng.choice(len(f), n_points, replace=False), :2] for f in frames]
    pts, mask = io.pad_points(xy, pad_to=pad)
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[1:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    cfg = _config()
    # No per-frame stats: the whole-frame kernel returns the transform only
    # (the JAX package's icp2d gates it the same way).
    path, _, sec, launches = _run_path(pts, mask, cfg, device, False)
    ate = ate_rmse(path, gt)
    p_path, _, _, _ = _run_path(pts, mask, cfg.with_(
        frame_backend="off", nn_backend="torch", align_backend="torch"),
        device, False)
    d = ate_rmse(p_path, path)
    print(f"# 2D path: {n_frames} frames of {n_points} points, {sec:.3f} s, "
          f"ATE vs ground truth {ate:.6f} m, vs plain path {d:.3e} m; "
          f"launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"2D path ATE {ate} >= {ATE_GATE_M}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"2D kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate)


def profile_main(device="cuda", n_frames: int = 16):
    """torch.profiler over the main path's first ``n_frames`` frames (after
    a warm-up run): device time by kernel and the device's idle share
    against an unprofiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, mask, _ = frames3d(n_frames)
    cfg = _config()
    _run_path(pts, mask, cfg, device, False)
    _, _, wall, _ = _run_path(pts, mask, cfg, device, False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_path(pts, mask, cfg, device, False)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    frames = n_frames - 1
    print(f"# profile: {frames} frames, unprofiled wall {wall * 1e3:.3f} ms "
          f"({wall * 1e3 / frames:.3f} ms/frame); device busy "
          f"{busy_ms:.3f} ms ({busy_ms / frames:.3f} ms/frame), idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=30))


@functools.lru_cache(maxsize=4)
def scans2d(n_scans: int = BATCH_SCANS, pad: int = BATCH_PAD, seed: int = 6):
    """Synthetic 2D scans the size of the reference's scans/2d: the xy of
    ``n_scans`` synthetic frames, each subsampled to a seeded count in
    BATCH_COUNTS and padded to ``pad``, and the ground-truth transform of
    each consecutive pair (scan k onto scan k + 1) as (angle, t)."""
    frames, traj = io.synthesize_frames3d(n_scans, seed=seed)
    rng = np.random.default_rng(seed + 1)
    xy = []
    for f in frames:
        k = int(rng.integers(BATCH_COUNTS[0], BATCH_COUNTS[1] + 1))
        xy.append(f[rng.choice(len(f), min(k, pad), replace=False), :2])
    pts, mask = io.pad_points(xy, pad_to=pad)
    return (pts, mask, *_pair_truth(traj))


def _pair_truth(traj):
    """The ground-truth planar transform of each consecutive pair of an
    (x, y, theta) trajectory, frame k onto frame k + 1: (angle, t xy)."""
    th = traj[:, 2]
    c, s = np.cos(th[1:]), np.sin(th[1:])
    d = traj[:-1, :2] - traj[1:, :2]
    gt_t = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]],
                    axis=-1)
    return th[:-1] - th[1:], gt_t


def _batch(device, n_scans: int = BATCH_SCANS, pad: int = BATCH_PAD,
           sort: bool = False, scans=None):
    """Pairs (scan k, scan k + 1) on ``device``: src, src_mask, dst,
    dst_mask, each Morton-sorted per pair when ``sort``; of ``scans``
    (``scans2d``'s output) when given."""
    pts, mask, _, _ = scans if scans is not None else scans2d(n_scans, pad)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    src, smask, dst, dmask = p[:-1], k[:-1], p[1:], k[1:]
    if sort:
        src, smask, _ = spatial_sort(src, smask)
        dst, dmask, _ = spatial_sort(dst, dmask)
    return src, smask, dst, dmask


def _equal_or_raise(got, want, what):
    for a, b, name in zip(got, want, ("dist", "idx", "payload")):
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: {name} differs from the plain "
                               "version")


def _list_schedules(args, out, device, reps: int = 20):
    """Kernel 9 by its launcher alone at the wrapper's schedule and at
    work items of 1, 2, 3, 4, half and all of the list's entries with 1,
    2 and 4 queries a thread (at least a warp a block), each bitwise equal
    to the wrapper's result ``out``: ({"I=..,Q=..": ms}, the wrapper's
    key).  Empty on the CPU."""
    res = {}
    if torch.device(device).type != "cuda":
        return res, None
    q_sub, cap = args[5], args[2].shape[-1]
    item0, q0 = nn_pairs_cuda.list_schedule(q_sub, cap)
    items = sorted({1, 2, 3, 4, -(-cap // 2), cap} & set(range(1, cap + 1)))
    shapes = [(item0, q0)] + [(i, q) for q in (1, 2, 4) for i in items
                              if q_sub // q >= 32 and (i, q) != (item0, q0)]
    for item, q in shapes:
        largs, got, keep = nn_pairs_cuda._nn_pairs_list_args(
            *args, item=item, q_per_thread=q)
        res[f"I={item},Q={q}"] = launcher_ms("nn_pairs_list", largs, device,
                                             reps=reps)
        _sync(device)
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise RuntimeError(f"nn_pairs_list: items of {item} entries and "
                               f"{q} queries a thread change the result")
        del keep
    return res, f"I={item0},Q={q0}"


def _pairs_schedules(args, out, device, reps: int = 20):
    """Kernel 8 by its launcher alone at the wrapper's schedule and at
    work items of 1, 2, 3, 6 and all of the db's chunks with 1, 2 and 4
    queries a thread, each bitwise equal to the wrapper's result ``out``:
    ({"T=..,Q=..": ms}, the wrapper's key).  Empty on the CPU and in a
    tree whose kernel 8 has no work items."""
    res = {}
    if (torch.device(device).type != "cuda"
            or not hasattr(nn_pairs_cuda, "pairs_item_chunks")):
        return res, None
    b, qp = args[0].shape[:2]
    m_pad = args[1].shape[2]
    n_ch = m_pad // 128
    q0 = nn_pairs_cuda.PAIRS_Q
    t0 = nn_pairs_cuda.pairs_item_chunks(b, qp, m_pad, q0)
    items = sorted({1, 2, 3, 6, n_ch} & set(range(1, n_ch + 1)))
    shapes = [(t0, q0)] + [(i, q) for q in (1, 2, 4) for i in items
                           if (i, q) != (t0, q0)]
    for item, q in shapes:
        largs, got, keep = nn_pairs_cuda._nn_pairs_args(
            *args, item=item, q_per_thread=q)
        res[f"T={item},Q={q}"] = launcher_ms("nn_pairs", largs, device,
                                             reps=reps)
        _sync(device)
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise RuntimeError(f"nn_pairs: items of {item} chunks and {q} "
                               "queries a thread change the result")
        del keep
    return res, f"T={t0},Q={q0}"


def _list_walk(cnt, item: int) -> str:
    """What one kernel 9 call walks at items of ``item`` entries (a host
    read, for reports): chunk-walks, work items, the longest block's
    chunks."""
    c = cnt.to(torch.int64).cpu()
    n_items = -(-c // item)
    longest = int(torch.clamp(c, max=item).max()) if c.numel() else 0
    return (f"{int(c.sum())} chunk-walks in {int(n_items.sum())} work items "
            f"of {item} entries (longest block {longest} chunks, longest "
            f"list {int(c.max())})")


def phase_nn_pairs(device="cuda", n_scans: int = BATCH_SCANS,
                   pad: int = BATCH_PAD, big_pairs: int = 4,
                   big_db: int = 4096, q_sub: int = nn_pairs_cuda.Q_SUB):
    """Kernels 8 and 9 vs their plain versions and a brute-force sweep;
    kernel 9 also vs its schedule's emulation, and at every schedule of
    ``_list_schedules``."""
    src, smask, dst, dmask = _batch(device, n_scans, pad, sort=True)
    eps = torch.finfo(torch.float32).eps
    grp = min(nn_pairs_cuda.LIST_GRP, q_sub)
    timed = {}
    errs = {"static": 0.0, "list": 0.0}

    def run_case(name, query, db, dm, bounds):
        """bounds: {"static" | "list": (B, Nq) bound or None (+inf)}."""
        n_q = query.shape[1]
        brute = nn_torch(query, db, dm, tile=db.shape[1])
        want_pay = torch.take_along_dim(db, brute.index[..., None].long(),
                                        dim=1)
        for kind, qb in bounds.items():
            query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(
                query, db, dm, db, qb, q_sub)
            walk = ""
            if kind == "static":
                qbox = nn_pairs_cuda._query_boxes(query_p, q_sub)
                gb = nn_pairs_cuda._group_bounds(qb_p, q_sub)
                args = (query_p, dbf, qbox, cbox, gb, 2, q_sub)
                fn = nn_pairs_cuda.nn_pairs
                plain = nn_pairs_cuda.nn_pairs_plain
                walked = int((nn_pairs_cuda._box_lower_bound(qbox, cbox, 2)
                              <= gb[..., None]).sum())
            else:
                lists, cnt = nn_pairs_cuda._survivor_lists(
                    query_p, cbox, qb_p, 2, q_sub, grp)
                args = (query_p, dbf, lists, cnt, 2, q_sub, qb_p, cbox)
                fn = nn_pairs_cuda.nn_pairs_list
                plain = nn_pairs_cuda.nn_pairs_list_plain
                walked = int(cnt.sum())
                item = nn_pairs_cuda.list_schedule(q_sub, lists.shape[-1])[0]
                pairs = nn_pairs_cuda.group_walks(*args)
                walk = (f"; {_list_walk(cnt, item)}; after the per-group "
                        f"test {pairs} (query, point) pairs of "
                        f"{walked * q_sub * 128}")
            got = fn(*args)
            want = plain(*args)
            _sync(device)
            what = f"nn_pairs {kind} {name}"
            _equal_or_raise(got, want, what)
            fin = torch.isfinite(got[0])
            errs[kind] = max(errs[kind], float(torch.max(torch.abs(
                got[0][fin] - want[0][fin]))) if bool(fin.any()) else 0.0)
            dist = nn_cuda._trim_sentinel(got[0][:, :n_q])
            hit = torch.isfinite(brute.dist_sq)
            if not (torch.equal(got[1][:, :n_q], brute.index)
                    and torch.equal(dist, brute.dist_sq)
                    and torch.equal(got[2][:, :n_q][hit], want_pay[hit])):
                raise RuntimeError(f"{what}: differs from brute force")
            schedules = {}
            if kind == "static" and hasattr(nn_pairs_cuda, "pairs_items"):
                emul = nn_pairs_cuda.pairs_items(*args)
                _equal_or_raise(got, emul[:3],
                                f"{what} (the items' emulation)")
                item8 = nn_pairs_cuda.pairs_item_chunks(
                    *query_p.shape[:2], dbf.shape[2])
                walk = (f"; {emul[3]} work items of {item8} chunks, "
                        "bitwise equal to the items' emulation")
                schedules = _pairs_schedules(args, got, device)[0]
                if schedules:
                    walk += f"; by schedule {schedules} ms"
            if kind == "list":
                emul = nn_pairs_cuda.pairs_list_items(*args, item=item)
                _equal_or_raise(got, emul[:3],
                                f"{what} (the items' emulation)")
                walk += ", bitwise equal to the items' emulation"
                schedules = _list_schedules(args, got, device)[0]
                if schedules:
                    walk += f"; by schedule {schedules} ms"
            n_slots = query_p.shape[0] * (query_p.shape[1] // q_sub) \
                * (dbf.shape[2] // 128)
            case_ms = time_ms(lambda: fn(*args), device, reps=10)
            print(f"# {what}: bitwise equal to plain and brute force; "
                  f"{query.shape[0]} pairs x {n_q} queries x {db.shape[1]} "
                  f"db points; chunks walked {walked} of {n_slots}; "
                  f"{case_ms:.4f} ms{walk}")
            timed[(kind, name)] = dict(
                fn=fn, plain=plain, args=args, ms=case_ms,
                schedules=schedules,
                pairs=pairs if kind == "list" else walked * q_sub * 128)
        return brute, want_pay

    brute, matched = run_case("cold", src, dst, dmask,
                              {"static": None, "list": None})
    # One real outer step: the batched solve on the cold correspondences,
    # then the warm bounds of the next iteration.
    cfg = _config()
    rot, t, _ = align2d_cuda.irls_loop_batched_plain(
        src, matched, smask, cfg.huber_k, cfg.det_rel_eps,
        cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
    xy = RigidTransform2(rot, t).apply_points(src)
    move = torch.linalg.norm(xy - src, dim=-1)
    qb_w = (torch.sqrt(brute.dist_sq) + move) ** 2 * (1.0 + 32.0 * eps)
    run_case("warm", xy, dst, dmask, {"static": qb_w, "list": qb_w})

    def tight(query, db, dm):
        return nn_torch(query, db, dm, tile=db.shape[1]).dist_sq \
            * (1.0 + 32.0 * eps)

    gen = torch.Generator(device="cpu").manual_seed(9)
    drop = (torch.rand(dmask.shape, generator=gen) < 0.5).to(device)
    dm2 = dmask & ~drop
    run_case("masked-db", src, dst, dm2,
             {"static": None, "list": tight(src, dst, dm2)})
    # Exact ties: the first half of every db twice, queries on db points.
    half = pad // 2
    dup = torch.cat([dst[:, :half], dst[:, :half]], dim=1)
    dup_m = torch.cat([dmask[:, :half], dmask[:, :half]], dim=1)
    run_case("ties", dup, dup, dup_m,
             {"static": None, "list": tight(dup, dup, dup_m)})
    q_b, db_b, dm_b = _big_db_case(device, big_pairs, big_db, pad)
    run_case(f"db-{big_db}", q_b, db_b, dm_b,
             {"static": None, "list": tight(q_b, db_b, dm_b)})

    records = []
    for kind, name, rec_name, src_file, line in (
            ("static", "cold", "nn_pairs", "nn_pairs.cu", 1234),
            ("list", "warm", "nn_pairs_list", "nn_pairs_list.cu", 1432)):
        c = timed[(kind, name)]
        args = c["args"]
        ms = time_ms(lambda: c["fn"](*args), device, reps=50)
        extra = {}
        if kind == "list" and torch.device(device).type == "cuda":
            # Kernel 9 by its launcher alone: its wrapper's time is the
            # host's.
            largs, _out, keep = nn_pairs_cuda._nn_pairs_list_args(*args)
            extra = dict(wrapper_ms=ms, schedules_ms=c["schedules"])
            ms = launcher_ms("nn_pairs_list", largs, device)
            del keep
            print(f"# nn_pairs_list warm: launcher alone {ms} ms, wrapper "
                  f"{extra['wrapper_ms']:.4f} ms")
        elif torch.device(device).type == "cuda":
            # Kernel 8 by its launcher alone, beside kernel 9 on the same
            # cold case (+inf bounds, every chunk listed).
            res = nn_pairs_cuda._nn_pairs_args(*args)
            cold = timed[("list", "cold")]["args"]
            cargs, _cout, keep = nn_pairs_cuda._nn_pairs_list_args(*cold)
            extra = dict(wrapper_ms=ms, list_cold_ms=launcher_ms(
                "nn_pairs_list", cargs, device), schedules_ms=c["schedules"])
            ms = launcher_ms("nn_pairs", res[0], device)
            del keep, res
            print(f"# nn_pairs cold: launcher alone {ms} ms, wrapper "
                  f"{extra['wrapper_ms']:.4f} ms; nn_pairs_list on the "
                  f"cold case, launcher alone {extra['list_cold_ms']} ms")
        plain_ms = time_ms(lambda: c["plain"](*args), device, reps=3)
        query_p, dbf = args[0], args[1]
        tables = sum(x.numel() * 4 for x in args[2:] if torch.is_tensor(x))
        n_bytes = (query_p.numel() * 4 + dbf.numel() * 4 + tables
                   + query_p.shape[0] * query_p.shape[1]
                   * (4 + 4 + 4 * (dbf.shape[1] - 2)))
        pairs = float(c["pairs"])
        b, by = bound_ms(n_bytes, pairs * NN_OPS_PER_PAIR_2D)
        extra["issue_floor_ms"] = \
            pairs * NN_INSTR_PER_PAIR[2] / PEAK_F32_INSTR_PER_S * 1e3
        records.append(dict(
            name=rec_name, route="cuda", path="batched",
            source=f"icp_rust_tpu_torch/csrc/{src_file}",
            replaces=f"icp_rust_tpu/ops/nn_pallas.py:{line}",
            max_abs_err=errs[kind], ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None, extra=extra))
    return records


def _big_db_case(device, big_pairs: int = 4, big_db: int = 4096,
                 pad: int = BATCH_PAD):
    """The db-size limit of the pair-grid route: ``big_pairs`` pairs of
    ``pad`` queries against ``big_db``-point dbs, Morton-sorted."""
    frames, _ = io.synthesize_frames3d(big_pairs + 1, seed=8)
    rng = np.random.default_rng(8)
    xy_b = [f[rng.choice(len(f), big_db, replace=False), :2] for f in frames]
    pts_b = torch.as_tensor(np.stack(xy_b), dtype=torch.float32,
                            device=device)
    ones = torch.ones(pts_b.shape[:2], dtype=torch.bool, device=device)
    q_b, _, _ = spatial_sort(pts_b[:-1, :pad], ones[:-1, :pad])
    db_b, dm_b, _ = spatial_sort(pts_b[1:], ones[1:])
    return q_b, db_b, dm_b


def _irls_batched_inputs(device, n_scans: int = BATCH_SCANS,
                         pad: int = BATCH_PAD):
    """Kernel 7's arguments on the batched pairs' first-iteration
    correspondences, plus an all-masked and a one-point pair."""
    cfg = _config()
    src, smask, dst, dmask = _batch(device, n_scans, pad, sort=True)
    _, matched = nearest_neighbor_matched(src, dst, dmask, backend="torch",
                                          tile=pad)
    extra = torch.zeros_like(smask[:2])
    extra[1, 0] = True
    s = torch.cat([src, src[:2]])
    mt = torch.cat([matched, matched[:2]])
    mk = torch.cat([smask, extra])
    return (s, mt, mk, cfg.huber_k, cfg.det_rel_eps, cfg.inner_delta_sq_tol,
            cfg.inner_max_iter, cfg.point_scale)


def _irls_batched_check(name, args, device, degenerate: int = 0):
    """Kernel 7 at one call's inputs against its plain version: rot and t
    within IRLS_TOL and equal iterations for every pair; the last
    ``degenerate`` pairs at the identity after 1 iteration.  Returns (max
    |diff|, the kernel's iterations per pair)."""
    s = args[0]
    rot, t, its = align2d_cuda.irls_loop_batched(*args)
    rot_p, t_p, its_p = align2d_cuda.irls_loop_batched_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    its_k = its.to(torch.int64).cpu()
    its_pl = its_p.to(torch.int64).cpu()
    differ = int((its_k != its_pl).sum())
    print(f"# irls_loop_batched {name}: {s.shape[0]} pairs of {s.shape[1]} "
          f"points; iterations per pair kernel min {int(its_k.min())} median "
          f"{float(its_k.double().median()):.1f} max {int(its_k.max())}, "
          f"sum {int(its_k.sum())}; pairs whose count differs from the "
          f"plain version's {differ}; max |diff| rot/t {err:.3e} (tol "
          f"{IRLS_TOL})")
    if not (err <= IRLS_TOL and differ == 0):
        raise RuntimeError(f"irls_loop_batched {name} differs from its "
                           f"plain version: {err}, {differ} iteration "
                           "counts")
    if degenerate:
        eye = torch.eye(2, device=rot.device).expand(degenerate, 2, 2)
        if not (torch.equal(rot[-degenerate:], eye)
                and bool(torch.all(t[-degenerate:] == 0))
                and its_k[-degenerate:].tolist() == [1] * degenerate):
            raise RuntimeError(f"irls_loop_batched {name}: a degenerate "
                               f"pair moved ({its_k[-degenerate:].tolist()})")
    return err, its_k


def _irls_batched_times(name, args, device):
    """Kernel 7 by its launcher alone on the wrapper's route and on every
    route the card can place: one block a pair (0) and clusters of 1, 2,
    4, 8 and 16 blocks a pair, each within IRLS_TOL of the wrapper's
    result (its iterations printed where they differ): (ms on the
    wrapper's route, {route: ms}, the wrapper's route)."""
    if torch.device(device).type != "cuda":
        return None, {}, None
    largs, out, keep = align2d_cuda._irls_loop_batched_args(*args)
    chosen, threads = largs[-3], largs[-2]
    ms = launcher_ms("irls_loop_batched", largs, device)
    _sync(device)
    ref = out.clone()
    del keep
    n = args[0].shape[1]
    by_c = {}
    routes = [c for c in align2d_cuda.BATCHED_CLUSTERS[::-1]
              if align2d_cuda._resident(n, c) >= 1]
    if n <= align2d_cuda._BLOCK_ROUTE_MAX_POINTS:
        routes.insert(0, 0)
    for c in routes:
        largs, o, keep = align2d_cuda._irls_loop_batched_args(*args,
                                                             cluster=c)
        by_c[c] = launcher_ms("irls_loop_batched", largs, device)
        _sync(device)
        d = float(torch.max(torch.abs(o[:, :6] - ref[:, :6])))
        moved = int((o[:, 6] != ref[:, 6]).sum())
        del keep
        if not d <= IRLS_TOL:
            raise RuntimeError(f"irls_loop_batched {name}: route {c} "
                               f"moves the result by {d}")
        if moved:
            print(f"# irls_loop_batched {name}: route {c} changes "
                  f"{moved} pairs' iteration counts")
    resident = {c: align2d_cuda._resident(n, c)
                for c in align2d_cuda.BATCHED_CLUSTERS}
    print(f"# irls_loop_batched {name}: launcher alone {ms} ms on route "
          f"{chosen} (blocks a pair's cluster; 0: one block a pair) of "
          f"{threads} threads (by route: {by_c}; clusters resident at once "
          f"{resident})")
    return ms, by_c, chosen


def _irls_batched_record(path, args, its_k, err, device, **extra):
    s, mk = args[0], args[2]
    ms, by_c, chosen = _irls_batched_times(path, args, device)
    wrapper_ms = time_ms(lambda: align2d_cuda.irls_loop_batched(*args),
                         device, reps=20)
    plain_ms = time_ms(lambda: align2d_cuda.irls_loop_batched_plain(*args),
                       device, reps=2)
    ops = float((its_k.double() * mk.sum(dim=1).double().cpu()).sum()) \
        * IRLS_OPS_PER_POINT
    b, by = bound_ms(s.shape[0] * s.shape[1] * (4 * 4 + 1)
                     + s.shape[0] * 12 * 4, ops)
    return dict(name="irls_loop_batched", route="cuda", path=path,
                source="icp_rust_tpu_torch/csrc/irls_loop_batched.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:1127",
                max_abs_err=err, ms=wrapper_ms if ms is None else ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                extra=dict(wrapper_ms=wrapper_ms, pair_route=chosen,
                           route_ms=by_c, **extra))


def phase_irls_batched(device="cuda", n_scans: int = BATCH_SCANS,
                       pad: int = BATCH_PAD):
    """Kernel 7 vs its plain version on the pairs' first-iteration
    correspondences, plus an all-masked and a one-point pair."""
    args = _irls_batched_inputs(device, n_scans, pad)
    err, its_k = _irls_batched_check("batched", args, device, degenerate=2)
    return _irls_batched_record("batched", args, its_k, err, device)


def phase_irls_batched_wide(device="cuda", wide_frames: int = 12,
                            wide_stride: int = 1):
    """Kernel 7 on every call of run_slam2d on the xy of ``wide_frames``
    full frames (phase 17's wide scans), captured: each against its plain
    version as phase 7; the first call (every consecutive pair, cold)
    timed as phase 7, and every call by its launcher alone."""
    calls = _slam2d_wide_irls_calls(device, wide_frames, wide_stride)
    errs, per_call = [], []
    for k, args in enumerate(calls):
        err, its_k = _irls_batched_check(f"slam2d-wide call {k}", args,
                                         device)
        errs.append(err)
        if torch.device(device).type == "cuda":
            largs, _, keep = align2d_cuda._irls_loop_batched_args(*args)
            per_call.append(launcher_ms("irls_loop_batched", largs, device,
                                        reps=10))
            del keep
        if k == 0:
            first_its = its_k
    total = sum(per_call) if per_call else None
    print(f"# irls_loop_batched slam2d-wide: {len(calls)} calls, launcher "
          f"alone {per_call} ms, sum {total} ms")
    return _irls_batched_record("slam2d-wide", calls[0], first_its,
                                max(errs), device, calls=len(calls),
                                calls_ms=per_call, calls_sum_ms=total,
                                iterations=first_its.tolist())


def plain_fixed_point(args, rot, t) -> torch.Tensor:
    """Per pair of kernel 10's (or 3's) arguments ``args``: is (rot, t) an
    exact fixed point of the plain outer step?  ``icp2d_frame_plain``
    warm-started there takes its fixed-point exit at the first outer
    iteration: its dT is the identity bitwise (``models/driver.
    fixed_point``'s test)."""
    sp, dp, sm, dm, _, cfg = args
    _, _, lane_it = m_icp.icp2d_frame_plain(
        sp, dp, sm, dm, RigidTransform2(rot, t), cfg)
    return lane_it.reshape(-1).cpu() == 1


def near_tie_replay(src, dst, smask, dmask, t0, cfg, flip=None):
    """The plain outer loop of one pair (src (N, 2), dst (M, 2) in solver
    units, warm start t0) on the exact nearest neighbours: float64 squared
    distances of the float32 rows, the lowest index on a tie.  ``flip``
    (outer iteration, row) takes that row's second-nearest point at that
    iteration instead.  Also lists the loop's near ties: (outer iteration
    from 0, row, squared-distance gap, margin) where a valid row's two
    nearest points lie closer in squared distance than a move of the row
    by eps (1 + its largest |coordinate|), about one float32 ulp, can
    reorder (margin 2 eps (1 + max |xy|) |p1 - p2|).  The frame kernels'
    rows are that far from the plain loop's.  Returns (rot and t as 6
    float64, outer iterations, near ties)."""
    cfg = cfg.with_(align_backend="torch")
    eps = torch.finfo(torch.float32).eps
    t, ties = t0, []
    d64 = dst.double()
    for k in range(cfg.outer_iters):
        xy = t.apply_points(src)
        d2 = torch.sum((xy.double()[:, None] - d64[None]) ** 2, dim=-1)
        d2 = torch.where(dmask[None], d2, torch.inf)
        near, nidx = torch.topk(d2, min(2, d2.shape[1]), dim=-1,
                                largest=False, sorted=True)
        # topk does not promise the lowest index among equal distances.
        idx = torch.argmin(d2, dim=-1)
        if near.shape[1] == 2:
            gap = near[:, 1] - near[:, 0]
            two = torch.where(nidx[:, 0] == idx, nidx[:, 1], nidx[:, 0])
            margin = (2 * eps * (1 + float(xy.abs().max()))
                      * torch.linalg.norm(d64[idx] - d64[two], dim=-1))
            for q in torch.nonzero(smask & (gap <= margin)).reshape(-1):
                ties.append((k, int(q), float(gap[q]), float(margin[q])))
            if flip is not None and flip[0] == k:
                idx = idx.clone()
                idx[flip[1]] = two[flip[1]]
        dt = align2d.estimate_transform(xy, dst[idx], smask, cfg)
        if bool(is_identity(dt)):
            return _six(t), k + 1, ties
        t = dt.compose(t)
    return _six(t), cfg.outer_iters, ties


def _six(t: RigidTransform2) -> torch.Tensor:
    return torch.cat([t.rot.reshape(4), t.t.reshape(2)]).double()


def near_tie_match(src, dst, smask, dmask, t0, cfg, got, its: int):
    """Is ``got`` (rot and t as 6 floats, ``its`` outer iterations) within
    FRAME_TOL, with the same outer count, of the plain loop on the exact
    nearest neighbours, or of that loop with one of its near ties taken
    the other way (``near_tie_replay``)?  Returns a description of the
    match, or None."""
    got = got.double().reshape(6)
    base, n, ties = near_tie_replay(src, dst, smask, dmask, t0, cfg)
    err = float((base - got).abs().max())
    if n == its and err <= FRAME_TOL:
        return f"{err:.3e} from the plain loop on the exact nearest neighbours"
    for k, q, gap, margin in ties:
        six, n, _ = near_tie_replay(src, dst, smask, dmask, t0, cfg, (k, q))
        err = float((six - got).abs().max())
        if n == its and err <= FRAME_TOL:
            return (f"{err:.3e} from the plain loop with row {q}'s nearest "
                    f"neighbour at outer iteration {k + 1} taken as its "
                    f"second (squared distances {gap:.3e} apart, under the "
                    f"one-ulp margin {margin:.3e})")
    return None


def frame_gate(args, rot, t, its, plain, what: str):
    """Kernel 10's (or 3's) gate on one batch: every pair within FRAME_TOL
    of the plain version ``plain`` (rot, t, outer iterations) in rot and
    t, with equal outer iteration counts.  A pair outside FRAME_TOL passes
    only with an equal count, a result that is an exact fixed point of
    the plain outer step (``plain_fixed_point``), and a result within
    FRAME_TOL of the plain loop with one float32 nearest-neighbour near
    tie taken the other way, at the same count (``near_tie_match``): such
    a tie ends the loop at another fixed point of the same step (ROADMAP.md
    section 3).  Each such pair is printed with its index, its distance
    and its tie.  Returns (max |diff|, the pairs that fail)."""
    rot_p, t_p, its_p = plain
    d = torch.maximum(
        torch.amax(torch.abs(rot - rot_p).reshape(-1, 4), dim=-1),
        torch.amax(torch.abs(t - t_p).reshape(-1, 2), dim=-1)).cpu()
    its_k = its.reshape(-1).to(torch.int64).cpu()
    its_pl = its_p.reshape(-1).to(torch.int64).cpu()
    bad = its_k != its_pl
    miss = torch.nonzero((d > FRAME_TOL) & ~bad).reshape(-1)
    if len(miss):
        # Kernel 3's arguments are one pair: give them kernel 10's axis.
        one = args[0].ndim == 2
        sp, dp, sm, dm = ((x[None] if one else x) for x in args[:4])
        t0, cfg = args[4], args[5]
        rot0, tr0 = t0.rot.reshape(-1, 2, 2), t0.t.reshape(-1, 2)
        got = torch.cat([rot.reshape(-1, 4), t.reshape(-1, 2)], dim=-1)
        sel = miss.to(sp.device)
        fixed = plain_fixed_point(
            (sp[sel], dp[sel], sm[sel], dm[sel], None, cfg),
            rot.reshape(-1, 2, 2)[miss.to(rot.device)],
            t.reshape(-1, 2)[miss.to(t.device)])
        for i, ok in zip(miss.tolist(), fixed.tolist()):
            why = ok and near_tie_match(
                sp[i], dp[i], sm[i], dm[i],
                RigidTransform2(rot0[i], tr0[i]), cfg, got[i],
                int(its_k[i]))
            if why:
                print(f"# {what}: pair {i} outside FRAME_TOL by "
                      f"{float(d[i]):.3e} passes the near-tie gate: equal "
                      f"outer iterations ({int(its_k[i])}), an exact fixed "
                      f"point of the plain outer step, {why}")
            else:
                bad[i] = True
    return float(d.max()), torch.nonzero(bad).reshape(-1).tolist()


def _frame_pairs_check(args, what: str):
    """Kernel 10 through its wrapper against its plain version on one
    batch, held to ``frame_gate``.  On a failure on the card, the worst
    failing pair is traced through kernel 10 and, alone, through kernel 3
    (``frame_trace``) before the check raises.  Returns (max |diff|, outer
    iterations per pair, the plain version's (rot, t, outer
    iterations))."""
    rot, t, its = m_icp.icp2d_frame(*args)
    plain = m_icp.icp2d_frame_pairs_plain(*args)
    err, failed = frame_gate(args, rot, t, its, plain, f"icp2d_frame_pairs "
                             f"{what}")
    its_k = its.to(torch.int64).cpu()
    its_pl = plain[2].to(torch.int64).cpu()
    spread = torch.bincount(its_k).tolist()
    print(f"# icp2d_frame_pairs {what}: {its_k.shape[0]} pairs; outer "
          f"iterations per pair kernel min {int(its_k.min())} median "
          f"{float(its_k.double().median()):.1f} max {int(its_k.max())} sum "
          f"{int(its_k.sum())} (pairs by count {spread}), plain sum "
          f"{int(its_pl.sum())}; max |diff| rot/t {err:.3e} (tol "
          f"{FRAME_TOL})")
    if failed:
        d = torch.maximum(
            torch.amax(torch.abs(rot - plain[0]), dim=(-2, -1)),
            torch.amax(torch.abs(t - plain[1]), dim=-1)).cpu()
        worst = max(failed, key=lambda i: float(d[i]))
        print(f"# icp2d_frame_pairs {what}: FAILS THE GATE at pairs "
              f"{failed}: worst {worst} by {float(d[worst]):.3e} (outer "
              f"iterations {its_k[worst]}, plain {its_pl[worst]})")
        if rot.device.type == "cuda":
            frame_trace(rot.device, "icp2d_frame_pairs", args, worst)
            sp, dp, sm, dm, t0, cfg = args
            alone = (sp[worst], dp[worst], sm[worst], dm[worst],
                     RigidTransform2(t0.rot[worst], t0.t[worst]), cfg)
            frame_trace(rot.device, "icp2d_frame", alone, 0)
        raise RuntimeError(f"icp2d_frame_pairs {what} differs from its "
                           f"plain version at pairs {failed}")
    return err, its_k, plain


def _frame_pairs_settings(args, device, reps: int = 10):
    """Kernel 10 by its launcher alone on the wrapper's (blocks a pair,
    threads a block) and, where the tree has them, on every setting of
    PAIRS_SHAPES of which the card holds all B clusters at once and that
    leaves 32 query rows a block.  Returns (ms on the wrapper's setting,
    {"C=..,T=..": ms}, the wrapper's setting, its output, {(blocks,
    threads): output}); ``_frame_pairs_hold`` checks the outputs."""
    _, largs, out, keep = align2d_cuda._icp2d_frame_args(*args)
    ms = launcher_ms("icp2d_frame_pairs", largs, device, reps=reps)
    _sync(device)
    ref = out.clone()
    del keep
    shapes = getattr(align2d_cuda, "PAIRS_SHAPES", ())
    if not shapes:
        return ms, {}, None, ref, {}
    b, n, m = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    chosen = align2d_cuda.frame_pairs_shape(
        b, n, lambda c, t: align2d_cuda._frame_resident(n, m, c, t))
    by_shape, outs = {}, {}
    for c, t in shapes:
        if not ((c == 1 or n >= 32 * c)
                and align2d_cuda._frame_resident(n, m, c, t) >= b):
            continue
        _, largs, o, keep = align2d_cuda._icp2d_frame_args(*args,
                                                           shape=(c, t))
        by_shape[f"C={c},T={t}"] = launcher_ms("icp2d_frame_pairs", largs,
                                               device, reps=reps)
        _sync(device)
        outs[(c, t)] = o.clone()
        del keep
    return ms, by_shape, chosen, ref, outs


def _frame_pairs_hold(args, plain, ref, outs):
    """Kernel 10's outputs on every setting (``_frame_pairs_settings``):
    each held to ``frame_gate`` against the plain version ``plain`` (rot,
    t, outer iterations) with the wrapper's outer iteration counts
    ``ref``, and bitwise equal to the other settings of its thread
    count."""
    by_threads = {}
    for (c, t), o in outs.items():
        _, failed = frame_gate(args, o[:, :4].reshape(-1, 2, 2), o[:, 4:6],
                               o[:, 6], plain, f"icp2d_frame_pairs clusters "
                               f"of {c} blocks of {t} threads")
        if failed and o.device.type == "cuda":
            frame_trace(o.device, "icp2d_frame_pairs", args, failed[0],
                        shape=(c, t))
        if failed or not torch.equal(o[:, 6], ref[:, 6]):
            raise RuntimeError(f"icp2d_frame_pairs: clusters of {c} blocks "
                               f"of {t} threads fail the gate at pairs "
                               f"{failed} or give other outer iteration "
                               "counts")
        first = by_threads.setdefault(t, o)
        if not torch.equal(o[:, :7], first[:, :7]):
            raise RuntimeError(f"icp2d_frame_pairs: clusters of {c} blocks "
                               f"of {t} threads change the result")


def phase_frame_pairs(device="cuda", n_scans: int = BATCH_SCANS,
                      pad: int = BATCH_PAD):
    """Kernel 10 vs its plain version on the unsorted pairs; timed by its
    launcher alone on its setting and on every setting the card holds at
    once, and by its wrapper."""
    cfg = _config()
    src, smask, dst, dmask = _batch(device, n_scans, pad)
    b = src.shape[0]
    t0 = RigidTransform2.identity((b,), dtype=torch.float32, device=device)
    args = (src, dst, smask, dmask, t0, cfg)
    err, its_k, plain = _frame_pairs_check(args, f"{b}x{pad}")
    extra = {}
    if torch.device(device).type == "cuda":
        inner = align2d_cuda.icp2d_frame_raw(*args)[:, 7].double().cpu()
        wrapper_ms = time_ms(lambda: m_icp.icp2d_frame(*args), device,
                             reps=10)
        ms, by_shape, chosen, ref, outs = _frame_pairs_settings(args,
                                                                device)
        _frame_pairs_hold(args, plain, ref, outs)
        extra = dict(wrapper_ms=wrapper_ms, shape=chosen,
                     shape_ms=by_shape)
        print(f"# icp2d_frame_pairs: launcher alone {ms} ms on clusters of "
              f"{chosen[0]} blocks of {chosen[1]} threads (by setting "
              f"{by_shape}), wrapper {wrapper_ms:.4f} ms")
    else:
        inner = torch.zeros(b, dtype=torch.float64)
        ms = time_ms(lambda: m_icp.icp2d_frame(*args), device, reps=1)
    plain_ms = time_ms(lambda: m_icp.icp2d_frame_pairs_plain(*args),
                       device, reps=1)
    n_src = smask.sum(dim=1).double().cpu()
    n_dst = dmask.sum(dim=1).double().cpu()
    ops = float((its_k.double() * n_src * (n_dst * NN_OPS_PER_PAIR_2D + 6)
                 + inner * n_src * IRLS_OPS_PER_POINT).sum())
    b_ms, by = bound_ms(b * (pad * 4 * 3 + pad * 4 * 2 + 14 * 4), ops)
    # The sweep's instructions (NN_INSTR_PER_PAIR a valid pair) at the
    # card's instruction rate, beside the IRLS loop's counted operations.
    extra["issue_floor_ms"] = float(
        (its_k.double() * n_src * n_dst).sum()) * NN_INSTR_PER_PAIR[2] \
        / PEAK_F32_INSTR_PER_S * 1e3 \
        + float((inner * n_src).sum()) * IRLS_OPS_PER_POINT \
        / PEAK_F32_PER_S * 1e3
    return dict(name="icp2d_frame_pairs", route="cuda", path="batched",
                source="icp_rust_tpu_torch/csrc/icp2d_frame_pairs.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:979",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None, extra=extra)


def _run_batched(batch, cfg, device):
    """One timed ``batched_icp2d`` call with the launch counts zeroed just
    before it; returns (transforms, seconds, launches)."""
    src, smask, dst, dmask = batch
    t0 = RigidTransform2.identity((src.shape[0],), dtype=torch.float32,
                                  device=device)
    _sync(device)
    cuda_build.reset_launches()
    start = time.perf_counter()
    out = batched_icp2d(src, dst, smask, dmask, t0, cfg, device=device)
    _sync(device)
    return out, time.perf_counter() - start, dict(cuda_build.LAUNCHES)


def _pair_diff(a: RigidTransform2, b: RigidTransform2) -> torch.Tensor:
    """Per pair: the larger of |t_a - t_b| and |R_a - R_b| (max entry)."""
    dt = torch.linalg.norm(a.t - b.t, dim=-1)
    dr = torch.amax(torch.abs(a.rot - b.rot), dim=(-2, -1))
    return torch.maximum(dt, dr)


def phase_batched(device="cuda", n_scans: int = BATCH_SCANS,
                  pad: int = BATCH_PAD):
    """The batched path: all consecutive pairs in one batched_icp2d call,
    once to warm up and once timed; then the plain path and the
    pair-frame route."""
    pts, mask, gt_th, gt_t = scans2d(n_scans, pad)
    batch = _batch(device, n_scans, pad)
    n_pairs = n_scans - 1
    cfg = _config()
    _, first_sec, _ = _run_batched(batch, cfg, device)
    out, sec, launches = _run_batched(batch, cfg, device)
    pps = n_pairs / sec
    ang = torch.atan2(out.rot[:, 1, 0], out.rot[:, 0, 0]).double().cpu()
    e_rot = np.abs(ang.numpy() - gt_th)
    e_t = np.linalg.norm(out.t.double().cpu().numpy() - gt_t, axis=-1)
    k = launches["irls_loop_batched"]
    print(f"# batched path: {n_pairs} pairs of {pad} points "
          f"({int(mask.sum(1).min())}-{int(mask.sum(1).max())} valid), "
          f"{sec:.4f} s, {pps:.2f} pairs/s (host clock; first run "
          f"{first_sec:.4f} s); error vs ground truth per pair: t max "
          f"{e_t.max():.6f} m median {np.median(e_t):.6f} m, rot max "
          f"{e_rot.max():.3e} rad median {np.median(e_rot):.3e} rad; "
          f"outer iterations {k}; launches {launches}")
    on_card = torch.device(device).type == "cuda"
    want = {name: 0 for name in launches}
    want.update(nn_pairs=1, nn_pairs_list=k - 1, irls_loop_batched=k)
    if on_card and (k < 1 or launches != want):
        raise RuntimeError(f"batched path launches {launches}, expected "
                           f"{want}")
    if not e_t.max() < ATE_GATE_M:
        raise RuntimeError(f"batched path translation error {e_t.max()} "
                           f">= {ATE_GATE_M}")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    p_out, p_sec, p_launch = _run_batched(batch, plain_cfg, device)
    d_plain = float(torch.max(_pair_diff(out, p_out)))
    print(f"# batched plain path: {p_sec:.3f} s; max per-pair difference "
          f"from the kernel path {d_plain:.3e} (gate {PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"batched plain path launched kernels: {p_launch}")
    if not d_plain < PLAIN_GATE_M:
        raise RuntimeError(f"batched kernel vs plain path {d_plain}")
    pairs_cfg = cfg.with_(frame_backend="pairs")
    _run_batched(batch, pairs_cfg, device)
    f_out, f_sec, f_launch = _run_batched(batch, pairs_cfg, device)
    d_frame = float(torch.max(_pair_diff(out, f_out)))
    print(f"# batched pair-frame route: {f_sec:.4f} s, "
          f"{n_pairs / f_sec:.2f} pairs/s; max per-pair difference from "
          f"the lockstep path {d_frame:.3e} (gate {PLAIN_GATE_M}); "
          f"launches {f_launch}")
    want_f = {name: 0 for name in f_launch}
    want_f["icp2d_frame_pairs"] = 1
    if on_card and f_launch != want_f:
        raise RuntimeError(f"pair-frame route launches {f_launch}")
    if not d_frame < PLAIN_GATE_M:
        raise RuntimeError(f"pair-frame vs lockstep path {d_frame}")
    return dict(launches=launches, frame_launches=f_launch, pairs_per_s=pps,
                seconds=sec, max_t_err=float(e_t.max()))


def profile_batched(device="cuda", n_scans: int = BATCH_SCANS,
                    pad: int = BATCH_PAD):
    """torch.profiler over one batched_icp2d call (after a warm-up run):
    device time by kernel and the device's idle share against an
    unprofiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = _batch(device, n_scans, pad)
    cfg = _config()
    _run_batched(batch, cfg, device)
    _, wall, _ = _run_batched(batch, cfg, device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_batched(batch, cfg, device)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile batched: {n_scans - 1} pairs, unprofiled wall "
          f"{wall * 1e3:.3f} ms; device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile batched kernel {e.self_device_time_total / 1e3:9.3f}"
              f" ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _p2l_pair(device, stride: int, voxel: float = P2L_VOXEL_M):
    """Frames 0 (src) and 1 (dst), Morton-sorted as icp_point_to_plane
    sorts them, with dst's voxel normals and the [n, c] payload."""
    src, smask, dst, dmask = _first_pair(device, stride)
    normals, n_valid = estimate_normals_voxel(dst, dmask, voxel)
    payload = m_p2l.build_p2l_payload(dst, normals, n_valid, dmask)
    return src, smask, dst, dmask, payload


def phase_nn_list_p2l(device="cuda", stride: int = 1, tile: int = 2048,
                      q_tile: int = 256):
    """Kernel 1 at the p2l payload (D = 3, F = 4): the cold bound, the warm
    bound of one real p2l outer step, and a masked db whose normals are
    partly invalid (sentinel c)."""
    cfg = _config(nn_dst_tile=tile, nn_query_tile=q_tile)
    src, smask, dst, dmask, payload = _p2l_pair(device, stride)
    n = src.shape[0]
    qp = -(-n // q_tile) * q_tile
    eps = torch.finfo(torch.float32).eps

    def cold(query_p, pack):
        return nn_cuda._center_bound(query_p, pack.cbox, 3)

    c = _nn_list_case("p2l cold", src, dst, dmask, payload, cold, device,
                      tile, q_tile)
    # One real p2l outer step: the solve on the cold correspondences, then
    # the warm bound of the next iteration (3D move).
    dist = nn_cuda._trim_sentinel(c["dist"])
    m_n, matched, ok = m_p2l.decode_p2l_payload(c["pay"], dist)
    dt = align3d.estimate_transform_p2l(src, matched, m_n, smask & ok, cfg)
    src1 = dt.apply_points(src)
    move = torch.linalg.norm(src1 - src, dim=-1)
    qb_w = (torch.sqrt(dist) + move) ** 2 * (1.0 + 32.0 * eps)

    def warm_bound(query_p, pack):
        qb = torch.full((qp,), float("-inf"), device=device)
        qb[:n] = qb_w
        return qb

    warm = _nn_list_case("p2l warm", src1, dst, dmask, payload, warm_bound,
                         device, tile, q_tile)
    gen = torch.Generator(device="cpu").manual_seed(7)
    drop = torch.rand(dst.shape[0], generator=gen).to(device) < 0.5
    dm2 = dmask & ~drop
    normals2, valid2 = estimate_normals_voxel(dst, dm2, P2L_VOXEL_M)
    pay2 = m_p2l.build_p2l_payload(dst, normals2, valid2, dm2)
    masked = _nn_list_case("p2l masked-db", src, dst, dm2, pay2, cold,
                           device, tile, q_tile)
    sentinel = int((pay2[:, 3] >= m_p2l._C_VALID_MAX).sum())
    print(f"# nn_list p2l masked-db: {sentinel} db rows carry the sentinel "
          "plane offset")
    rec = _nn_list_record(warm, q_tile, device, "p2l")
    rec.update(max_abs_err=max(c["err"], warm["err"], masked["err"]))
    return rec


def _first_p2l_correspondences(device, stride: int):
    """Frame 1's first-iteration p2l correspondences (cold exact NN of the
    sorted frame 0 against the sorted frame 1): (src, matched plane
    points, matched normals, pair mask)."""
    src, smask, dst, dmask, payload = _p2l_pair(device, stride)
    res, pay = nearest_neighbor_matched(src, dst, dmask, payload=payload,
                                        backend="torch")
    m_n, matched, ok = m_p2l.decode_p2l_payload(pay, res.dist_sq)
    return src, matched, m_n, smask & ok


def _degenerate_p2l(src, matched, m_n, mask):
    """The systems that must stop at iteration 1 with the identity: one
    plane (a Cholesky pivot fails), 5 valid points, sigma = 0 (every
    residual 0) and an all-masked input."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    noise = (torch.rand(src.shape[0], generator=gen) * 0.01).to(src.device)
    z = torch.zeros_like(m_n)
    z[:, 2] = 1.0
    plane = src.clone()
    plane[:, 2] = plane[:, 2] + 0.01 + noise
    five = torch.zeros_like(mask)
    five[torch.nonzero(mask)[:5, 0]] = True
    return {"one-plane": (src, plane, z, mask),
            "five-points": (src, matched, m_n, five),
            "sigma-0": (src, src, m_n, mask),
            "all-masked": (src, matched, m_n, torch.zeros_like(mask))}


def exact_median(v: torch.Tensor) -> torch.Tensor:
    """The median of the 1-D float32 ``v`` by torch.kthvalue: the middle
    order statistic, or the mean of the two middle ones (0 when empty)."""
    n = v.shape[0]
    if n == 0:
        return torch.zeros((), dtype=v.dtype, device=v.device)
    hi = torch.kthvalue(v, n // 2 + 1).values
    if n % 2:
        return hi
    return 0.5 * (torch.kthvalue(v, n // 2).values + hi)


def p2l_first_stats(src, dst, nrm, mask, huber_k: float):
    """Kernel 11's first-iteration median, MAD and sigma, held against the
    exact median (torch.kthvalue of the residuals at the identity) and
    against kernel 14's sigma there: True when bitwise equal."""
    out = align3d_cuda.p2l_loop_out(src, dst, nrm, mask, huber_k, 1e-6, 1,
                                    1.0)
    r = align3d_cuda.identity_residuals(src, dst, nrm, mask)[mask > 0.5]
    med = exact_median(r)
    mad = exact_median(torch.abs(r - med))
    sig = align3d_cuda.p2l_stats(src, dst, nrm, mask,
                                 torch.eye(3, device=src.device),
                                 torch.zeros(3, device=src.device),
                                 huber_k)[29]
    return bool(torch.equal(out[13], med) and torch.equal(out[14], mad)
                and torch.equal(out[15], sig))


def _p2l_cluster_times(args, device):
    """Kernel 11 by its launcher alone at clusters of 4, 8 and 16 blocks,
    one iteration (max_iter 1) and the call's own: {C: (one, call)} in
    ms.  Each cluster's result within IRLS_TOL of the plain loop with
    equal iterations."""
    rot_p, t_p, it_p = align3d_cuda.p2l_loop_plain(*args)
    times = {}
    for c in (4, 8, 16):
        largs, out, keep = align3d_cuda._p2l_loop_args(*args, cluster=c)
        call_ms = launcher_ms("p2l_loop", largs, device)
        _sync(device)
        d = max(float(torch.max(torch.abs(out[:9].reshape(3, 3) - rot_p))),
                float(torch.max(torch.abs(out[9:12] - t_p))))
        if not (d <= IRLS_TOL and int(out[12]) == int(it_p)):
            raise RuntimeError(f"p2l_loop: a cluster of {c} gives {d}, "
                               f"{int(out[12])} iterations vs {int(it_p)}")
        one_args, _, keep1 = align3d_cuda._p2l_loop_args(*args[:6], 1,
                                                         args[7], cluster=c)
        times[c] = (launcher_ms("p2l_loop", one_args, device), call_ms)
        del keep, keep1
    return times


def phase_p2l_loop(device="cuda", stride: int = 1):
    """Kernel 11 vs its plain version on frame 1's first-iteration
    correspondences, and the degenerate systems; on the card its first
    medians and sigma bitwise, and its launcher alone at clusters of 4, 8
    and 16 blocks, one iteration and the call's, at the p2l path's
    28,800 points, SLAM 3D's 28,160, half and a quarter of the p2l
    path's, and SLAM small's 3,072 (where the cluster-size rule
    changes)."""
    cfg = _config()
    src, matched, m_n, mask = _first_p2l_correspondences(device, stride)
    solver = (cfg.huber_k, cfg.inner_delta_sq_tol, cfg.inner_max_iter,
              cfg.point_scale)
    args = (src, matched, m_n, mask, *solver)
    rot, t, it = align3d_cuda.p2l_loop(*args)
    rot_p, t_p, it_p = align3d_cuda.p2l_loop_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    print(f"# p2l_loop: {int(mask.sum())} valid of {src.shape[0]} points; "
          f"iterations kernel {int(it)} plain {int(it_p)}; max |diff| rot/t "
          f"{err:.3e} (tol {IRLS_TOL})")
    if not err <= IRLS_TOL:
        raise RuntimeError(f"p2l_loop differs from its plain version: {err}")
    if int(it) != int(it_p):
        raise RuntimeError("p2l_loop: iteration count differs from the "
                           "plain version's")
    eye = torch.eye(3, device=src.device)
    for name, case in _degenerate_p2l(src, matched, m_n, mask).items():
        for fn in (align3d_cuda.p2l_loop, align3d_cuda.p2l_loop_plain):
            r_d, t_d, it_d = fn(*case, *solver)
            if not (torch.equal(r_d, eye) and bool(torch.all(t_d == 0))
                    and int(it_d) == 1):
                raise RuntimeError(f"{fn.__name__} {name}: moved or ran "
                                   f"{int(it_d)} iterations")
        print(f"# p2l_loop {name}: kernel and plain stop at iteration 1 "
              "with the identity")
    cluster_ms = {}
    if torch.device(device).type == "cuda":
        if not p2l_first_stats(src, matched, m_n, mask, cfg.huber_k):
            raise RuntimeError("p2l_loop: first median, MAD or sigma not "
                               "bitwise the exact ones")
        print("# p2l_loop: first median and MAD bitwise equal to the exact "
              "median, sigma to p2l_stats'")
        n = src.shape[0]
        for name, sl in (("p2l", slice(None)), ("slam3d", slice(0, 28160)),
                         ("half", slice(0, n, 2)), ("quarter", slice(0, n, 4)),
                         ("slam3d-small", slice(0, n, 9))):
            sub = tuple(x[sl][:3072] if name == "slam3d-small" else x[sl]
                        for x in args[:4]) + solver
            cluster_ms[name] = _p2l_cluster_times(sub, device)
            one, call = zip(*cluster_ms[name].values())
            print(f"# p2l_loop {name} ({sub[0].shape[0]} points): launcher "
                  f"alone at clusters of 4, 8, 16: one iteration "
                  f"{list(one)} ms, the call {list(call)} ms")
    wrapper_ms = time_ms(lambda: align3d_cuda.p2l_loop(*args), device,
                         reps=20)
    cluster = align3d_cuda.p2l_cluster(src.shape[0])
    ms = cluster_ms["p2l"][cluster][1] if cluster_ms else wrapper_ms
    plain_ms = time_ms(lambda: align3d_cuda.p2l_loop_plain(*args), device,
                       reps=1)
    ops = float(int(it)) * float(mask.sum()) * P2L_OPS_PER_POINT
    n_pts = src.shape[0]
    b, by = bound_ms(9 * 4 * n_pts + mask.element_size() * n_pts + 16 * 4,
                     ops)
    print(f"# p2l_loop: launcher alone {ms} ms ({int(it)} iterations, a "
          f"cluster of {cluster}), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.7f} ms "
          f"({by})")
    return dict(name="p2l_loop", route="cuda", path="p2l",
                source="icp_rust_tpu_torch/csrc/p2l_loop.cu",
                replaces="icp_rust_tpu/ops/align3d_pallas.py:252",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None,
                extra=dict(wrapper_ms=wrapper_ms, iterations=int(it),
                           cluster_ms={k: {str(c): v for c, v in d.items()}
                                       for k, d in cluster_ms.items()}))


def _p2l_stats_inputs(device, stride: int = 1):
    """Kernel 14's path shapes: frame 1's first-iteration p2l
    correspondences (N = 28,800) and the transform their plain loop
    reaches: (src, matched, normals, mask, identity, warm)."""
    src, matched, m_n, mask = _first_p2l_correspondences(device, stride)
    ident = RigidTransform3.identity(device=src.device)
    warm = align3d.estimate_transform_p2l(
        src, matched, m_n, mask, _config(align_backend="torch"))
    return src, matched, m_n, mask, ident, warm


def phase_p2l_stats(device="cuda", stride: int = 1):
    """Kernel 14 vs its plain version at the identity and at one warm
    transform, through align3d.weighted_gn_update_p2l_cuda (kernel 14's
    path: its launches are counted there); on the card timed by its
    launcher alone on every cluster size (``_stats_times``) and by its
    wrapper."""
    k = _config().huber_k
    src, matched, m_n, mask, ident, warm = _p2l_stats_inputs(device, stride)
    _sync(device)
    cuda_build.reset_launches()
    updates = [align3d.weighted_gn_update_p2l_cuda(t, src, matched, m_n,
                                                    mask, k)
               for t in (ident, warm)]
    _sync(device)
    launches = dict(cuda_build.LAUNCHES)
    worst, abs_err = 0.0, 0.0
    for name, t, upd in zip(("identity", "warm"), (ident, warm), updates):
        args = (src, matched, m_n, mask, t.rot, t.t, k)
        rel, err = _stats_gate("p2l_stats", align3d_cuda.p2l_stats(*args),
                               args, f"p2l_stats {name}")
        print(f"# p2l_stats {name}: update ok {bool(upd.ok)}")
        worst, abs_err = max(worst, rel), max(abs_err, err)
    args = (src, matched, m_n, mask, warm.rot, warm.t, k)
    wrapper_ms = time_ms(lambda: align3d_cuda.p2l_stats(*args), device,
                         reps=20)
    ms, extra = wrapper_ms, dict(wrapper_ms=wrapper_ms)
    if torch.device(device).type == "cuda":
        extra["cluster_ms"] = _stats_times("p2l_stats", args, device)
        n = src.shape[0]
        ms = extra["cluster_ms"][n][align3d_cuda.p2l_cluster(n)]
        print(f"# p2l_stats: launcher alone {ms} ms (a cluster of "
              f"{align3d_cuda.p2l_cluster(n)}), wrapper {wrapper_ms:.4f} ms")
    plain_ms = time_ms(lambda: align3d_cuda.p2l_stats_plain(*args), device,
                       reps=3)
    ops = float(mask.sum()) * P2L_OPS_PER_POINT
    n_pts = src.shape[0]
    b, by = bound_ms(9 * 4 * n_pts + mask.element_size() * n_pts + 12 * 4
                     + 32 * 4, ops)
    return dict(name="p2l_stats", route="cuda", path="p2l_stats",
                source="icp_rust_tpu_torch/csrc/p2l_stats.cu",
                replaces="icp_rust_tpu/ops/align3d_pallas.py:120",
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, launches=launches["p2l_stats"],
                max_rel_err=worst, extra=extra)


def _run_p2l(pts, mask, cfg, device, voxel: float = P2L_VOXEL_M):
    """One timed ``run_odometry_p2l_fused`` call with the launch counts
    zeroed just before it; returns (transforms, path, stats, seconds,
    launches)."""
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    tf, path, stats = run_odometry_p2l_fused(pts, mask, cfg, voxel,
                                             with_metrics=True,
                                             device=device)
    _sync(device)
    return tf, path, stats, time.perf_counter() - t0, \
        dict(cuda_build.LAUNCHES)


def phase_p2l(device="cuda", n_frames: int = 96, stride: int = 1,
              plain_frames: int = 8, tile: int = 2048,
              voxel: float = P2L_VOXEL_M):
    """The p2l path: SE(3) point-to-plane odometry over the synthetic
    sequence, twice (bitwise equal; the second run timed), then the plain
    path on the first frames.  ``voxel``: the normals' voxel size, for
    subsampled frames."""
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    tf1, path1, _, first_sec, _ = _run_p2l(pts, mask, cfg, device, voxel)
    tf, path, stats, sec, launches = _run_p2l(pts, mask, cfg, device, voxel)
    if not (np.array_equal(path, path1) and torch.equal(tf.rot, tf1.rot)
            and torch.equal(tf.t, tf1.t)):
        raise RuntimeError("p2l path: two runs differ")
    ate = ate_rmse(path[:, :2], gt)
    z_max = float(np.abs(path[:, 2]).max())
    outer = stats.outer_iters.cpu().numpy()
    total = int(outer.sum())
    fps = (n_frames - 1) / sec
    print(f"# p2l path: {n_frames} frames of {pts.shape[1]} points, "
          f"{sec:.4f} s, {fps:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s), bitwise equal to the first run; ATE-xy vs "
          f"ground truth {ate:.6f} m, max |z| {z_max:.6f} m; outer "
          f"iterations per frame mean {outer.mean():.3f} min {outer.min()} "
          f"max {outer.max()} total {total}; launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"p2l path ATE-xy {ate} >= {ATE_GATE_M}")
    if not z_max < P2L_Z_GATE_M:
        raise RuntimeError(f"p2l path max |z| {z_max} >= {P2L_Z_GATE_M}")
    on_card = torch.device(device).type == "cuda"
    if on_card and not (launches["nn_list"] == launches["p2l_loop"] == total
                        and total > 0):
        raise RuntimeError(f"p2l path launches {launches}, expected "
                           f"{total} nn_list and p2l_loop")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    _, p_path, _, p_sec, p_launch = _run_p2l(pts[:plain_frames],
                                             mask[:plain_frames], plain_cfg,
                                             device, voxel)
    d = ate_rmse(p_path, path[:plain_frames - 1])
    print(f"# p2l plain path on the first {plain_frames} frames: "
          f"{p_sec:.3f} s; trajectory vs kernel path {d:.3e} m (gate "
          f"{PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"p2l plain path launched kernels: {p_launch}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"p2l kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate, z_max=z_max, fps=fps,
                seconds=sec, outer_mean=float(outer.mean()), path=path,
                stats=stats)


def profile_p2l(device="cuda", n_frames: int = 16):
    """torch.profiler over the p2l path's first ``n_frames`` frames (after
    a warm-up run): device time by kernel, the device's idle share against
    an unprofiled run's wall time, and the voxel normals' share (their
    device time over the same dst frames, profiled on their own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, mask, _ = frames3d(n_frames)
    cfg = _config()
    _run_p2l(pts, mask, cfg, device)
    _, _, _, wall, _ = _run_p2l(pts, mask, cfg, device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_p2l(pts, mask, cfg, device)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    frames = n_frames - 1
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    dsts = [spatial_sort(p[i], k[i]) for i in range(1, n_frames)]
    with profile(activities=[ProfilerActivity.CUDA]) as nprof:
        for dst, dmask, _ in dsts:
            estimate_normals_voxel(dst, dmask, P2L_VOXEL_M)
        _sync(device)
    normals_ms = sum(e.self_device_time_total for e in nprof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3
    print(f"# profile p2l: {frames} frames, unprofiled wall "
          f"{wall * 1e3:.3f} ms ({wall * 1e3 / frames:.3f} ms/frame); "
          f"device busy {busy_ms:.3f} ms ({busy_ms / frames:.3f} ms/frame),"
          f" idle share {1.0 - busy_ms / (wall * 1e3):.4f}; voxel normals "
          f"{normals_ms:.3f} ms device ({normals_ms / busy_ms:.4f} of busy)")
    for e in kern[:12]:
        print(f"# profile p2l kernel {e.self_device_time_total / 1e3:9.3f} "
              f"ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _frames_as_run(frames, device):
    """Frames stacked as the SLAM entry points stack them (padded to a
    multiple of 128, unsorted): (points, masks) on ``device``."""
    pts, mask = io.pad_points(frames)
    return (torch.as_tensor(pts, dtype=torch.float32, device=device),
            torch.as_tensor(mask, device=device))


def _sweep_packed(query, db, dmask, payload, q_tile: int, db_tile: int):
    """Kernels 4 and 5's inputs as ``nn_sweep_cuda.search`` packs them:
    (query_p (..., Qp, D), dbf_cm (..., D + F, m_pad), D)."""
    n, d_dim = query.shape[-2:]
    q_pad = -(-n // q_tile) * q_tile
    query_p = torch.zeros((*query.shape[:-2], q_pad, d_dim),
                          dtype=torch.float32, device=query.device)
    query_p[..., :n, :] = query
    m_pad = -(-db.shape[-2] // db_tile) * db_tile
    pay = db[..., :0] if payload is None else payload
    return query_p, nn_cuda._dbf_cm_matched(db, dmask, pay, m_pad), d_dim


def _sweep_check(kind, name, query, db, dmask, payload, device,
                 q_tile: int, db_tile: int):
    """One kernel 4/5/6 check: the kernel vs its plain version (bitwise
    dist, idx, payload) and vs a brute-force sweep (idx, trimmed dist, the
    winner's payload where a valid point exists, zeros where none does).
    query (..., Q, D); db (..., M, D).  Returns the timing record's
    inputs."""
    d_dim = query.shape[-1]
    n = query.shape[-2]
    if kind == "nn_pruned":
        args = nn_sweep_cuda.prepare_pruned(query, db, dmask, payload, q_tile,
                                            db_tile) + (d_dim, q_tile,
                                                        db_tile)
        fn, plain = nn_sweep_cuda.nn_pruned, nn_sweep_cuda.nn_pruned_plain
    else:
        query_p, dbf_cm, _ = _sweep_packed(query, db, dmask, payload, q_tile,
                                           db_tile)
        if kind == "nn_sweep":
            args = (query_p, dbf_cm)
            fn, plain = nn_sweep_cuda.nn_sweep, nn_sweep_cuda.nn_sweep_plain
        else:
            args = (query_p, dbf_cm, d_dim)
            fn, plain = nn_sweep_cuda.nn_matched, \
                nn_sweep_cuda.nn_matched_plain
    got = fn(*args)
    want = plain(*args)
    _sync(device)
    what = f"{kind} {name}"
    _equal_or_raise(got, want, what)
    brute = nn_torch(query, db, dmask, tile=db_tile)
    hit = torch.isfinite(brute.dist_sq)
    dist = nn_cuda._trim_sentinel(got[0][..., :n])
    ok = (torch.equal(got[1][..., :n], brute.index)
          and torch.equal(dist, brute.dist_sq))
    if payload is not None:
        pay_n = got[2][..., :n, :]
        want_pay = torch.take_along_dim(
            payload.expand(*brute.index.shape[:-1], *payload.shape[-2:]),
            brute.index[..., None].long(), dim=-2)
        ok = (ok and torch.equal(pay_n[hit], want_pay[hit])
              and bool(torch.all(pay_n[~hit] == 0)))
    if not ok:
        raise RuntimeError(f"{what}: differs from brute force")
    fin = torch.isfinite(got[0])
    err = float(torch.max(torch.abs(got[0][fin] - want[0][fin]))) \
        if bool(fin.any()) else 0.0
    sweeps = None
    tiles = ""
    if kind in ("nn_matched", "nn_sweep"):
        tiles = _matched_emulation(got, args[0], args[1], d_dim, what)
    if kind == "nn_pruned":
        # The kernel's schedule emulated: its result bitwise, its sweeps
        # per work item.
        *emul, sweeps = nn_sweep_cuda.pruned_items(*args)
        _equal_or_raise(got, emul, f"{what} (the items' emulation)")
        threads, q = nn_sweep_cuda._block_shape(
            q_tile, nn_sweep_cuda.QUERIES_PER_THREAD)
        slots = (args[0].shape[0] // (threads * q)
                 * (args[1].shape[1] // db_tile))
        tiles = (f"; (group of {threads * q} queries, db tile) sweeps "
                 f"{sum(sweeps)} of {slots}, by work item of "
                 f"{nn_sweep_cuda.ITEM_TILES} tiles {sweeps}")
    on_card = torch.device(device).type == "cuda"
    case_ms = time_ms(lambda: fn(*args), device, reps=3 if on_card else 1)
    batch = f"{query.shape[0]} x " if query.ndim == 3 else ""
    print(f"# {what}: bitwise equal to plain and brute force; {batch}{n} "
          f"queries x {db.shape[-2]} db points ({int(dmask.sum())} valid), "
          f"F = {0 if payload is None else payload.shape[-1]}{tiles}; "
          f"{case_ms:.4f} ms")
    return dict(kind=kind, fn=fn, plain=plain, args=args, err=err,
                sweeps=sweeps, n=n, valid=float(dmask.sum()), db_tile=db_tile,
                out=got)


_SWEEP_SOURCES = {"nn_sweep": 55, "nn_matched": 177, "nn_pruned": 385}


def _matched_emulation(got, query_p, dbf_cm, d_dim: int, what: str) -> str:
    """Kernel 4 or 5's result against its schedule's emulation at the
    wrapper's work items, bitwise; returns the schedule for the case's
    line."""
    b = query_p.shape[0] if query_p.ndim == 3 else 1
    item = nn_sweep_cuda.matched_item_chunks(b, query_p.shape[-2],
                                             dbf_cm.shape[-1])
    *emul, n_items = nn_sweep_cuda.matched_items(query_p, dbf_cm, d_dim,
                                                 item)
    _equal_or_raise(got, emul[:len(got)], f"{what} (the items' emulation)")
    return (f"; {n_items} work items of {item} chunks a query group, "
            "bitwise equal to the items' emulation")


def _item_schedules(kind: str, args, out, device):
    """Kernel 4 (``kind`` "nn_matched") or 5 ("nn_sweep") by its launcher
    alone at the wrapper's work items and at items of 1 to all chunks with
    2 and 4 queries a thread, then at 8 queries a thread (the wrapper's
    items), each bitwise equal to the wrapper's result: ({"T=..,Q=..":
    ms}, the wrapper's key)."""
    res = {}
    if torch.device(device).type != "cuda":
        return res, None
    make = (nn_sweep_cuda._nn_matched_args if kind == "nn_matched"
            else nn_sweep_cuda._nn_sweep_args)
    query_p, dbf_cm = args[0], args[1]
    b = query_p.shape[0] if query_p.ndim == 3 else 1
    n_ch = dbf_cm.shape[-1] // 128
    q0 = nn_sweep_cuda.MATCHED_Q
    item0 = nn_sweep_cuda.matched_item_chunks(b, query_p.shape[-2],
                                              dbf_cm.shape[-1])
    items = sorted({1, 2, 4, 8, 16, 32, 64, -(-n_ch // 2), n_ch})
    shapes = [(item0, q0)] + [(t, q) for q in (2, 4) for t in items
                              if t <= n_ch and (t, q) != (item0, q0)]
    shapes.append((item0, 8))
    for t, q in shapes:
        largs, got, keep = make(*args, item_chunks=t, q_per_thread=q)
        res[f"T={t},Q={q}"] = launcher_ms(kind, largs, device, reps=20)
        _sync(device)
        if not all(torch.equal(a, c) for a, c in zip(got, out)):
            raise RuntimeError(f"{kind}: items of {t} chunks and {q} "
                               "queries a thread change the result")
        del keep
    return res, f"T={item0},Q={q0}"


def _pruned_schedules(case, device):
    """Kernel 6 by its launcher alone at work items of 1, 2 and 4 tiles (4
    queries a thread) and at 2 and 8 queries a thread (items of 2 tiles),
    each bitwise equal to the wrapper's result: {"T=..,Q=..": ms}."""
    out = {}
    if torch.device(device).type != "cuda":
        return out
    for t_items, q in ((1, 4), (2, 4), (4, 4), (2, 2), (2, 8)):
        largs, res, part = nn_sweep_cuda._nn_pruned_args(
            *case["args"], item_tiles=t_items, q_per_thread=q)
        out[f"T={t_items},Q={q}"] = launcher_ms("nn_pruned", largs, device,
                                                reps=20)
        _sync(device)
        if not all(torch.equal(a, b) for a, b in zip(res, case["out"])):
            raise RuntimeError(f"nn_pruned: items of {t_items} tiles and "
                               f"{q} queries a thread change the result")
        del part
    return out


def _sweep_record(case, path: str, device, max_abs_err: float):
    """Kernel 4, 5 or 6's timing, plain timing and bound at one case's
    shapes.  Operations: every (query, valid db point) pair of the plain
    sweeps; for kernel 6 the pairs of the (group, db tile) sweeps it
    makes on these inputs.  Timed by their launchers alone at their
    schedules, beside their instruction floors: NN_INSTR_PER_PAIR
    instructions a pair swept (kernels 4 and 5: every padded query against
    every db point) at PEAK_F32_INSTR_PER_S."""
    kind, args = case["kind"], case["args"]
    query_p, dbf_cm = args[0], args[1]
    d_dim = query_p.shape[-1]
    reps = 20 if torch.device(device).type == "cuda" else 1
    wrapper_ms = time_ms(lambda: case["fn"](*args), device, reps=reps)
    plain_ms = time_ms(lambda: case["plain"](*args), device, reps=2)
    b = query_p.shape[0] if query_p.ndim == 3 else 1
    qp = query_p.shape[-2]
    f_dim = dbf_cm.shape[-2] - d_dim
    per_pair = NN_OPS_PER_PAIR_3D if d_dim == 3 else NN_OPS_PER_PAIR_2D
    extra, ms = {}, wrapper_ms
    if kind == "nn_pruned":
        threads, q = nn_sweep_cuda._block_shape(
            args[6], nn_sweep_cuda.QUERIES_PER_THREAD)
        pairs = float(sum(case["sweeps"])) * threads * q * case["db_tile"]
        tables = sum(x.numel() * 4 for x in args[2:5])
        schedules = _pruned_schedules(case, device)
        ms = schedules.get(f"T={nn_sweep_cuda.ITEM_TILES},"
                           f"Q={nn_sweep_cuda.QUERIES_PER_THREAD}", ms)
        floor = pairs * NN_INSTR_PER_PAIR[d_dim] / PEAK_F32_INSTR_PER_S * 1e3
        extra = dict(wrapper_ms=wrapper_ms, schedules_ms=schedules,
                     sweeps_by_item=case["sweeps"], instruction_floor_ms=floor)
        print(f"# nn_pruned {path}: launcher alone {ms} ms (items of T "
              f"tiles, Q queries a thread: {schedules}), wrapper "
              f"{wrapper_ms:.4f} ms; instruction floor {floor:.4f} ms")
    else:
        pairs = float(case["n"]) * case["valid"]
        tables = 0
        schedules, key = _item_schedules(kind, args, case["out"], device)
        ms = schedules.get(key, ms)
        swept = float(b * qp * dbf_cm.shape[-1])
        floor = swept * NN_INSTR_PER_PAIR[d_dim] / PEAK_F32_INSTR_PER_S * 1e3
        extra = dict(wrapper_ms=wrapper_ms, schedules_ms=schedules,
                     instruction_floor_ms=floor)
        print(f"# {kind} {path}: launcher alone {ms} ms (items of T "
              f"chunks, Q queries a thread: {schedules}), wrapper "
              f"{wrapper_ms:.4f} ms; instruction floor {floor:.4f} ms "
              f"({swept:.4g} pairs swept)")
    n_bytes = (query_p.numel() * 4 + dbf_cm.numel() * 4 + tables
               + b * qp * (4 + 4 + 4 * f_dim))
    bound, by = bound_ms(n_bytes, pairs * per_pair)
    return dict(name=kind, route="cuda", path=path,
                source=f"icp_rust_tpu_torch/csrc/{kind}.cu",
                replaces=f"icp_rust_tpu/ops/nn_pallas.py:{_SWEEP_SOURCES[kind]}",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None, extra=extra)


def phase_nn_sweeps(device="cuda", stride: int = 1, small: int = 3072,
                    n_wide: int = 8, q_tile: int = 512, db_tile: int = 2048):
    """Kernels 4, 5 and 6 vs their plain versions and a brute-force sweep,
    at the shapes the SLAM paths give them: kernel 6 at run_slam3d's full
    width (frames 0 and 1 as it pads them, unsorted and Morton-sorted,
    with exact ties, a masked db, the p2l payload unseeded and a fully
    masked db); kernels 5 and 4 on 3072-point frames (2 db tiles; the p2l
    payload for kernel 4) and on ``n_wide`` pairs of full xy scans (the
    batched 2D path off the pair-grid route)."""
    frames, _ = io.synthesize_frames3d(max(n_wide + 1, 2), seed=0)
    frames = [f[::stride] for f in frames]
    pts, mask = _frames_as_run(frames, device)
    src, smask, dst, dmask = pts[0], mask[0], pts[1], mask[1]
    cases, errs = {}, {"nn_sweep": 0.0, "nn_matched": 0.0, "nn_pruned": 0.0}

    def run(kind, name, query, db, dm, payload=None, qt=q_tile):
        c = _sweep_check(kind, name, query, db, dm, payload, device, qt,
                         db_tile)
        errs[kind] = max(errs[kind], c["err"])
        cases[(kind, name)] = c

    run("nn_pruned", "full-width", src, dst, dmask)
    s_src, s_smask, _ = spatial_sort(src, smask)
    s_dst, s_dmask, _ = spatial_sort(dst, dmask)
    run("nn_pruned", "morton-sorted", s_src, s_dst, s_dmask)
    half = int(dmask.sum()) // 2
    dup = torch.cat([dst[:half], dst[:half]])
    run("nn_pruned", "ties", dst[:half], dup,
        torch.ones(dup.shape[0], dtype=torch.bool, device=device))
    gen = torch.Generator(device="cpu").manual_seed(11)
    drop = torch.rand(dst.shape[0], generator=gen).to(device) < 0.5
    run("nn_pruned", "masked-db", src, dst, dmask & ~drop)
    normals, n_valid = estimate_normals_voxel(s_dst, s_dmask, P2L_VOXEL_M)
    payload = m_p2l.build_p2l_payload(s_dst, normals, n_valid, s_dmask)
    run("nn_pruned", "p2l-payload", s_src, s_dst, s_dmask, payload, qt=256)
    none = torch.zeros_like(dmask)
    run("nn_pruned", "all-masked", src, dst, none, payload, qt=256)

    # Small frames (2 db tiles): kernel 5 as _mean_nn_dist, kernel 4 with
    # the p2l payload as the point-to-plane ICP sorts and packs them.
    f_src, f_sm, _ = spatial_sort(src[:small], smask[:small])
    f_dst, f_dm, _ = spatial_sort(dst[:small], dmask[:small])
    run("nn_sweep", "small", src[:small], dst[:small], dmask[:small])
    nrm, nv = estimate_normals_voxel(f_dst, f_dm, P2L_VOXEL_M)
    run("nn_matched", "small-p2l", f_src, f_dst, f_dm,
        m_p2l.build_p2l_payload(f_dst, nrm, nv, f_dm), qt=256)
    run("nn_sweep", "small-all-masked", src[:small], dst[:small],
        none[:small])
    run("nn_matched", "small-all-masked", f_src, f_dst, none[:small],
        f_dst[:, :2], qt=256)
    # n_wide pairs of full xy scans, a batch grid axis.
    xy = pts[:, :, :2]
    run("nn_sweep", "wide-batched", xy[:-1], xy[1:], mask[1:])
    run("nn_matched", "wide-batched-xy", xy[:-1], xy[1:], mask[1:], xy[1:],
        qt=256)

    return [
        _sweep_record(cases[("nn_pruned", "full-width")], "slam3d", device,
                      errs["nn_pruned"]),
        _sweep_record(cases[("nn_sweep", "small")], "slam3d-small", device,
                      errs["nn_sweep"]),
        _sweep_record(cases[("nn_matched", "small-p2l")], "slam3d-small",
                      device, errs["nn_matched"]),
        _sweep_record(cases[("nn_sweep", "wide-batched")], "slam2d-wide",
                      device, errs["nn_sweep"]),
        _sweep_record(cases[("nn_matched", "wide-batched-xy")],
                      "slam2d-wide", device, errs["nn_matched"]),
    ]


def _run_slam(fn, frames, cfg, device, **kw):
    """One timed SLAM run with the launch counts zeroed just before it;
    returns (result, seconds, launches)."""
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    res = fn(frames, cfg, device=device, **kw)
    _sync(device)
    return res, time.perf_counter() - t0, dict(cuda_build.LAUNCHES)


def phase_slam3d(device="cuda", n_frames: int = 96, stride: int = 1,
                 plain_frames: int = 12, voxel: float = P2L_VOXEL_M):
    """run_slam3d over the p2l path's synthetic frames with its defaults
    (loop radius 1 m, gap 8, at most 16 candidates), twice (the second run
    timed); then the kernel and the plain path on the first
    ``plain_frames`` frames."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=0)
    frames = [f[::stride] for f in frames]
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    cfg = _config()
    kw = dict(normals_voxel_size=voxel)
    graphs, unpatch = _capture_calls(m_slam.pg, "optimize")
    try:
        first, first_sec, _ = _run_slam(run_slam3d, frames, cfg, device,
                                        **kw)
    finally:
        unpatch()
    res, sec, launches = _run_slam(run_slam3d, frames, cfg, device, **kw)
    picked = m_slam._candidates(res.odometry_path, 1.0, 8, 16)
    ate = ate_rmse(res.optimized_path[:, :2], gt)
    ate_odo = ate_rmse(res.odometry_path[:, :2], gt)
    rerun = float(np.abs(res.optimized_path - first.optimized_path).max())
    print(f"# slam3d: {n_frames} frames of {frames[0].shape[0]}-"
          f"{max(len(f) for f in frames)} points, {sec:.4f} s per sequence, "
          f"{n_frames / sec:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s); candidates {len(picked)}, loop closures "
          f"{res.n_loop_closures}; graph error before {res.error_before:.6e} "
          f"after {res.error_after:.6e}; ATE-xy vs ground truth optimized "
          f"{ate:.6f} m, odometry {ate_odo:.6f} m; optimized path vs the "
          f"first run {rerun:.3e} m; launches {launches}")
    if res.n_loop_closures < 1:
        raise RuntimeError("slam3d: no loop closure")
    if not res.error_after <= res.error_before:
        raise RuntimeError("slam3d: the graph error grew")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"slam3d ATE-xy {ate} >= {ATE_GATE_M}")
    want = n_frames - 1 + len(picked)
    if torch.device(device).type == "cuda" and not (
            launches["nn_pruned"] == want and launches["nn_list"] > 0
            and launches["p2l_loop"] > 0 and launches["nn_sweep"] == 0
            and launches["nn_matched"] == 0):
        raise RuntimeError(f"slam3d launches {launches}, expected {want} "
                           "nn_pruned")
    head = frames[:plain_frames]
    k_res, _, _ = _run_slam(run_slam3d, head, cfg, device, **kw)
    p_res, p_sec, p_launch = _run_slam(
        run_slam3d, head, cfg.with_(nn_backend="torch",
                                    align_backend="torch"), device, **kw)
    d = float(np.abs(p_res.optimized_path - k_res.optimized_path).max())
    print(f"# slam3d plain path on the first {plain_frames} frames: "
          f"{p_sec:.3f} s, loop closures {p_res.n_loop_closures} (kernel "
          f"path {k_res.n_loop_closures}); optimized path vs kernel path "
          f"{d:.3e} m (gate {PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"slam3d plain path launched kernels: {p_launch}")
    if not (d < PLAIN_GATE_M
            and p_res.n_loop_closures == k_res.n_loop_closures):
        raise RuntimeError(f"slam3d kernel vs plain path {d} m")
    return dict(launches=launches, ate=ate, seconds=sec,
                closures=res.n_loop_closures, candidates=len(picked),
                graph=graphs[0][0])


def room_poses(n_poses: int = 28):
    """The sensor poses of ``room_sequence``: a closing loop with full
    6-DoF motion."""
    poses = []
    for k in range(n_poses):
        a = 2 * np.pi * k / (n_poses - 1)
        poses.append(RigidTransform3.from_twist(torch.tensor(
            [np.cos(a), np.sin(a), 0.05 * np.sin(2 * a), 0.02 * np.sin(a),
             0.02 * np.cos(a), a], dtype=torch.float32)))
    return poses


def room_sequence(n_poses: int = 28, n_points: int = 3072,
                  scene_n: int = 6000, seed: int = 0):
    """A planar room (floor, two walls, a ramp) seen from a closing loop
    with full 6-DoF motion, ``n_points`` points per frame (the scene of
    the JAX package's tests/test_slam3d.py, made here with numpy and the
    port's geometry): (frames, ground-truth positions in pose 0's frame);
    frame k is the scene seen from ``room_poses(n_poses)[k]``."""
    rng = np.random.default_rng(seed)
    lo_hi = (([-3, -3, 0], [3, 3, 0], scene_n // 2),
             ([-3, -3, 0], [3, -3, 2], scene_n // 4),
             ([-3, 3, 0], [-3, 3, 2], scene_n // 4),
             ([1, 1, 0], [3, 3, 1], scene_n // 4))
    parts = [rng.uniform(lo, hi, (k, 3)) for lo, hi, k in lo_hi]
    parts[3][:, 2] = 0.5 * (parts[3][:, 0] - 1.0)
    scene = np.concatenate(parts).astype(np.float32)
    poses = room_poses(n_poses)
    frames = []
    for p in poses:
        pts = p.inverse().apply_points(torch.as_tensor(scene)).numpy() \
            + rng.normal(0, 0.004, scene.shape).astype(np.float32)
        frames.append(pts[rng.permutation(len(pts))[:n_points]])
    p0_inv = poses[0].inverse()
    gt = np.stack([p0_inv.compose(p).t.numpy() for p in poses])
    return frames, gt.astype(np.float64)


def phase_slam3d_small(device="cuda", n_poses: int = 28,
                       n_points: int = 3072, scene_n: int = 6000):
    """run_slam3d on small frames (2 db tiles): kernels 4 and 5 serve its
    NN searches, and the loop closure pulls the end pose in."""
    frames, gt = room_sequence(n_poses, n_points, scene_n)
    kw = dict(loop_radius=0.8, min_gap=8, max_loop_candidates=8,
              normals_voxel_size=0.4)
    cfg = ICPConfig(compute_dtype=torch.float32)
    _, first_sec, _ = _run_slam(run_slam3d, frames, cfg, device, **kw)
    res, sec, launches = _run_slam(run_slam3d, frames, cfg, device, **kw)
    end_odo = float(np.linalg.norm(res.odometry_path[-1] - gt[-1]))
    end_opt = float(np.linalg.norm(res.optimized_path[-1] - gt[-1]))
    print(f"# slam3d small frames: {n_poses} frames of {n_points} points, "
          f"{sec:.4f} s (first run {first_sec:.4f} s); loop closures {res.n_loop_closures}; graph error "
          f"before {res.error_before:.6e} after {res.error_after:.6e}; end "
          f"error odometry {end_odo:.6f} m optimized {end_opt:.6f} m; "
          f"launches {launches}")
    if res.n_loop_closures < 1:
        raise RuntimeError("slam3d small frames: no loop closure")
    if not end_opt <= max(0.8 * end_odo, 0.02):
        raise RuntimeError(f"slam3d small frames: end error {end_opt} m")
    if torch.device(device).type == "cuda" and not (
            launches["nn_matched"] > 0 and launches["nn_sweep"] > 0
            and launches["nn_pruned"] == 0 and launches["nn_list"] == 0):
        raise RuntimeError(f"slam3d small frames launches {launches}")
    return dict(launches=launches, seconds=sec)


def phase_slam2d(device="cuda", n_scans: int = BATCH_SCANS,
                 pad: int = BATCH_PAD, wide_frames: int = 12,
                 wide_stride: int = 1, tile: int = 2048):
    """run_slam2d on the batched path's scans (pair-grid and batched IRLS
    kernels; the batched mean NN distance on the plain sweep), then
    ``phase_slam2d_wide`` on the xy of ``wide_frames`` full frames.  The
    synthetic scans are in metres: loop radius 1.5 m and 1 m."""
    pts, mask, _, _ = scans2d(n_scans, pad)
    scans = [p[m] for p, m in zip(pts, mask)]
    cfg = _config()
    res, sec, launches = _run_slam(run_slam2d, scans, cfg, device,
                                   loop_radius=1.5, min_gap=20)
    print(f"# slam2d: {n_scans} scans padded to {pad}, {sec:.4f} s; loop "
          f"closures {res.n_loop_closures}; graph error before "
          f"{res.error_before:.6e} after {res.error_after:.6e}; launches "
          f"{launches}")
    if not res.error_after <= res.error_before:
        raise RuntimeError("slam2d: the graph error grew")
    on_card = torch.device(device).type == "cuda"
    if on_card and not (launches["nn_pairs"] > 0
                        and launches["irls_loop_batched"] > 0
                        and launches["nn_sweep"] == 0
                        and launches["nn_matched"] == 0):
        raise RuntimeError(f"slam2d launches {launches}")
    wide = phase_slam2d_wide(device, wide_frames, wide_stride, tile)
    return dict(launches=launches, wide_launches=wide["launches"],
                wide_seconds=wide["seconds"], seconds=sec,
                records=[wide["record"]])


def phase_slam2d_wide(device="cuda", n_frames: int = 12, stride: int = 1,
                      tile: int = 2048):
    """run_slam2d on the xy of ``n_frames`` full frames (every
    ``stride``-th point; ``tile`` the config's db tile), three runs, the
    second timed.  The third counts its batched searches' warm flags and
    captures its nn_pairs calls: on the card nn_matched launches once a
    cold search, nn_pairs once a warm one (dbs above PAIRS_MAX_DB points
    over 3 tiles, ``ops/nn.route``'s pruned_warm), nn_sweep with a batch
    axis; every captured call is held by ``_pairs_wide_hold``.  Returns
    the timed run's launches and seconds, and kernel 8's record at path
    slam2d-wide."""
    frames, _ = io.synthesize_frames3d(n_frames, seed=4)
    wide = [f[::stride, :2] for f in frames]
    cfg = _config().with_(nn_dst_tile=tile)
    kw = dict(loop_radius=1.0, min_gap=8)
    _, first_sec, _ = _run_slam(run_slam2d, wide, cfg, device, **kw)
    res, sec, launches = _run_slam(run_slam2d, wide, cfg, device, **kw)
    print(f"# slam2d wide scans: {n_frames} scans of {len(wide[0])} "
          f"points, {sec:.4f} s (first run {first_sec:.4f} s); loop "
          f"closures {res.n_loop_closures}; graph error before "
          f"{res.error_before:.6e} after {res.error_after:.6e}; launches "
          f"{_nonzero(launches)}")
    if not res.error_after <= res.error_before:
        raise RuntimeError("slam2d wide scans: the graph error grew")
    warm, real = [], m_nn.NNIndex.search

    def spy(index, query, q_bound=None, is_warm=None):
        warm.append(is_warm)
        return real(index, query, q_bound, is_warm)

    calls, undo = _capture_calls(nn_pairs_cuda, "nn_pairs")
    m_nn.NNIndex.search = spy
    try:
        _, _, held = _run_slam(run_slam2d, wide, cfg, device, **kw)
    finally:
        m_nn.NNIndex.search = real
        undo()
    n_warm = warm.count(True)
    if not n_warm or len(calls) != n_warm:
        raise RuntimeError(f"slam2d wide scans: {len(calls)} nn_pairs calls "
                           f"for {n_warm} warm searches")
    if torch.device(device).type == "cuda":
        want = {n: 0 for n in held}
        want.update(nn_matched=warm.count(False), nn_pairs=n_warm,
                    nn_sweep=held["nn_sweep"],
                    irls_loop_batched=held["irls_loop_batched"])
        if not (held == want == launches and held["nn_sweep"] > 0):
            raise RuntimeError(f"slam2d wide scans launches {held} (timed "
                               f"run {launches}), expected {_nonzero(want)}")
    record = _pairs_wide_hold(calls, device, "slam2d-wide")
    return dict(launches=launches, seconds=sec, record=record)


def profile_slam3d(device="cuda", n_frames: int = 96):
    """Where run_slam3d's time goes at full width: host-clock time (with a
    synchronise around each call) in its point-to-plane ICP calls, its
    mean-NN-distance calls (kernel 6) and its graph solve, against the
    run's wall time; then torch.profiler over a second run: device time by
    kernel and the device's idle share against an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames, _ = io.synthesize_frames3d(n_frames, seed=0)
    cfg = _config()
    spent = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    names = ("icp_point_to_plane", "_mean_nn_dist", "_solve_graph")
    saved = {n: getattr(m_slam, n) for n in names}
    _run_slam(run_slam3d, frames, cfg, device)
    _, wall, _ = _run_slam(run_slam3d, frames, cfg, device)
    try:
        for n in names:
            setattr(m_slam, n, timed(n, saved[n]))
        _, split_wall, _ = _run_slam(run_slam3d, frames, cfg, device)
    finally:
        for n in names:
            setattr(m_slam, n, saved[n])
    rest = split_wall - sum(spent.values())
    print(f"# profile slam3d: {n_frames} frames, unprofiled wall "
          f"{wall * 1e3:.3f} ms; with a synchronise around each call "
          f"{split_wall * 1e3:.3f} ms: " + ", ".join(
              f"{n} {spent[n] * 1e3:.3f} ms ({spent[n] / split_wall:.4f})"
              for n in names)
          + f", the rest {rest * 1e3:.3f} ms ({rest / split_wall:.4f})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_slam(run_slam3d, frames, cfg, device)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile slam3d: device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile slam3d kernel {e.self_device_time_total / 1e3:9.3f}"
              f" ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


# Kernels 12 and 14: the cluster sizes timed, and the smaller point counts
# timed beside the paths' 28,800 (the first points of the same inputs),
# for the cluster-size rule.
STATS_CLUSTERS = (1, 2, 4, 8, 16)
STATS_POINTS = (3072, 1000)


def _stats_args(name: str, args, cluster=None):
    """Kernel 12's (gn_stats) or 14's (p2l_stats) launcher arguments on
    ``args``, its wrapper's, in the tree at hand: (the arguments, out, the
    tensors they point into).  ``cluster``: blocks in its cluster, by
    default its rule's; a tree whose kernel is one block takes none."""
    if name == "gn_stats":
        if hasattr(align2d_cuda, "_gn_stats_args"):
            return align2d_cuda._gn_stats_args(*args, cluster=cluster)
        return align2d_cuda._gn_args("gn_stats", *args)
    if hasattr(align3d_cuda, "_p2l_stats_args"):
        return align3d_cuda._p2l_stats_args(*args, cluster=cluster)
    # The one-block kernel's columns, as its wrapper built them.
    src, dst, nrm, mask, rot, t, k = args
    cols = align3d_cuda._columns(src, dst, nrm, mask)
    rt = torch.cat([rot.reshape(9), t]).float().contiguous()
    scratch = torch.empty(src.shape[0], dtype=torch.float32,
                          device=src.device)
    out = torch.empty(32, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    largs = (*[c.data_ptr() for c in cols], src.shape[0], rt.data_ptr(),
             scratch.data_ptr(), out.data_ptr(), k, k * k, 2.0 * k, stream)
    return largs, out, (cols, rt, scratch)


def _stats_gate(name: str, got, args, what: str):
    """Kernel 12's or 14's packed stats ``got`` held to PERF.md's stats
    gates against its plain version on ``args``: each sum and the error
    within the tolerance of its Cauchy-Schwarz bound, the count exact,
    sigma within the relative tolerance.  Returns (max relative error, max
    |diff|); raises on a miss."""
    if name == "gn_stats":
        want = align2d_cuda.gn_stats_plain(*args)
        rel, dn, sig_rel = align2d_cuda.gn_stats_errors(got, want)
        tol, sig_tol = GN_STATS_TOL, GN_SIGMA_TOL
    else:
        want = align3d_cuda.p2l_stats_plain(*args)
        rel, dn, sig_rel = align3d_cuda.stats_errors(got, want)
        tol, sig_tol = P2L_STATS_TOL, P2L_SIGMA_TOL
    print(f"# {what}: sums and error max rel {rel:.3e} (tol {tol}), count "
          f"diff {dn:g}, sigma rel {sig_rel:.3e} (tol {sig_tol})")
    if not (rel <= tol and dn == 0.0 and sig_rel <= sig_tol):
        raise RuntimeError(f"{what} differs from its plain version")
    return rel, float(torch.max(torch.abs(got.cpu() - want.cpu())))


def _stats_times(name: str, args, device, reps: int = 50):
    """Kernel 12 or 14 (``name``) by its launcher alone on ``args`` (its
    path's shape) and on their first STATS_POINTS points, on every
    cluster size of STATS_CLUSTERS where the tree's kernel takes one,
    each result held to the stats gates (``_stats_gate``): {points:
    {blocks: ms}} ({points: {"one block": ms}} in a tree whose kernel is
    one block)."""
    clustered = hasattr(align2d_cuda if name == "gn_stats"
                        else align3d_cuda,
                        "_gn_stats_args" if name == "gn_stats"
                        else "_p2l_stats_args")
    res = {}
    for m in (args[0].shape[0], *STATS_POINTS):
        sub = tuple(x[:m] for x in args[:-3]) + tuple(args[-3:])
        times = {}
        for c in STATS_CLUSTERS if clustered else (None,):
            largs, got, keep = _stats_args(name, sub, c)
            times["one block" if c is None else c] = launcher_ms(
                name, largs, device, reps=reps)
            _sync(device)
            _stats_gate(name, got, sub, f"{name} {m} points, cluster {c}")
            del keep
        res[m] = times
        print(f"# times {name} {m} points: launcher alone by cluster size "
              f"{times} ms")
    return res


# Kernel 13's one-block route is timed at these threads a block (where
# they hold the pair: at most 8 points a thread, 4 above 512 threads), its
# cluster route at these blocks a pair; its route rule is timed at the
# SLAM 2D wide call's first GN_LIMIT_POINTS points.
GN_BLOCK_THREADS = (128, 192, 256, 384, 512, 768, 1024)
GN_LIMIT_POINTS = (1536, 2048, 3072, 4096)


def _gn_batched_routes(args, device, reps: int = 50):
    """Kernel 13 by its launcher alone on ``args`` on its wrapper's route
    and, where the tree has routes, on one block a pair at every thread
    count of GN_BLOCK_THREADS that holds the pair and on clusters of
    STATS_CLUSTERS blocks a pair, each result held to the stats gates
    (``_stats_gate``): ({route: ms}, the wrapper's route).  Routes are
    "parent" (a tree without routes), "T=<threads>" and "C=<blocks>"."""
    res = {}
    if torch.device(device).type != "cuda":
        return res, None
    n = args[0].shape[1]
    if not hasattr(align2d_cuda, "gn_batched_route"):
        routes, chosen = [(None, None)], "parent"
    else:
        c0 = align2d_cuda.gn_batched_route(
            args[0].shape[0], n, lambda c: align2d_cuda._gn_resident(n, c))
        t0 = align2d_cuda.gn_batched_threads(n)
        chosen = f"T={t0}" if c0 == 0 else f"C={c0}"
        routes = [(c0, t0 if c0 == 0 else None)]
        for t in GN_BLOCK_THREADS:
            per = -(-n // t)
            if per <= 8 and (per <= 4 or t <= 512) and (0, t) != routes[0]:
                routes.append((0, t))
        routes += [(c, None) for c in STATS_CLUSTERS
                   if c != c0 and align2d_cuda._gn_resident(n, c) >= 1]
    for c, t in routes:
        key = "parent" if c is None else (f"T={t}" if c == 0 else f"C={c}")
        extra = {} if c is None else dict(cluster=c, threads=t)
        largs, got, keep = align2d_cuda._gn_batched_args(*args, **extra)
        res[key] = launcher_ms("gn_stats_batched", largs, device, reps=reps)
        _sync(device)
        _stats_gate("gn_stats", got, args,
                    f"gn_stats_batched {args[0].shape[0]}x{n} {key}")
        del keep
    return res, chosen


def _gn_batched_inputs(device, n_scans: int = BATCH_SCANS,
                       pad: int = BATCH_PAD):
    """Kernel 13's phase-18 arguments: the batched path's pairs' first
    correspondences, each pair at a seeded small transform, plus an
    all-masked pair and one with an odd count: (src, matched, mask,
    transform)."""
    b_src, b_smask, b_dst, b_dmask = _batch(device, n_scans, pad, sort=True)
    _, b_matched = nearest_neighbor_matched(b_src, b_dst, b_dmask,
                                            backend="torch", tile=pad)
    odd = torch.zeros_like(b_smask[:2])
    odd[1, :101] = True  # an odd count; row 0 all masked
    bs = torch.cat([b_src, b_src[:2]])
    bd = torch.cat([b_matched, b_matched[:2]])
    bk = torch.cat([b_smask, odd])
    rng = np.random.default_rng(8)
    tw = rng.normal(0, 1, (bs.shape[0], 3)) * [0.05, 0.05, 0.02]
    tw[-2:] = 0.0
    bt = RigidTransform2.from_twist(torch.as_tensor(
        tw, dtype=torch.float32, device=bs.device))
    return bs, bd, bk, bt


def gn_batched_inputs(device, scans=None):
    """Kernel 13's arguments at the shapes ``--times`` gives it: {shape:
    (src, dst, mask, rot, t, huber_k)} at phase 18's 211 pairs of 768 and
    at the first correspondences of SLAM 2D wide's first batched call (11
    pairs of 28,160 points, ``_slam2d_wide_irls_calls``) at the plain
    loop's transforms, and at that call's first GN_LIMIT_POINTS points."""
    k = _config().huber_k
    bs, bd, bk, bt = _gn_batched_inputs(device)
    out = {f"{bs.shape[0]}x{bs.shape[1]}": (bs, bd, bk, bt.rot, bt.t, k)}
    call = _slam2d_wide_irls_calls(device)[0]
    src, dst, mask = call[:3]
    rot, t, _ = align2d_cuda.irls_loop_batched_plain(*call)
    for n in (src.shape[1], *GN_LIMIT_POINTS):
        out[f"{src.shape[0]}x{n}"] = (src[:, :n], dst[:, :n], mask[:, :n],
                                      rot, t, k)
    return out


def _gn_check(name, got, want, upd, ref):
    """Gate one gn_stats case: stats against the plain version's, and the
    update against weighted_gauss_newton_update's.  Returns (max relative
    error, max absolute error of the packed stats)."""
    rel, dn, sig_rel = align2d_cuda.gn_stats_errors(got, want)
    d = float(torch.max(torch.abs(upd.delta - ref.delta)))
    same_ok = torch.equal(upd.ok, ref.ok)
    print(f"# {name}: sums and error max rel {rel:.3e} (tol {GN_STATS_TOL}),"
          f" count diff {dn:g}, sigma rel {sig_rel:.3e} (tol "
          f"{GN_SIGMA_TOL}); update delta vs the einsum update {d:.3e} "
          f"(tol {GN_DELTA_TOL}), ok equal {same_ok} "
          f"({int(upd.ok.sum())} of {upd.ok.numel()} ok)")
    if not (rel <= GN_STATS_TOL and dn == 0.0 and sig_rel <= GN_SIGMA_TOL
            and d <= GN_DELTA_TOL and same_ok):
        raise RuntimeError(f"{name} differs from its plain version or the "
                           "einsum update")
    return rel, float(torch.max(torch.abs(got - want)))


def _gn_stats_inputs(device, stride: int = 1):
    """Kernel 12's path shapes: frame 1's first-iteration correspondences
    (N = 28,800, xy) and the transform their plain loop reaches: (src,
    matched, mask, identity, warm)."""
    cfg = _config()
    src, smask, dst, dmask = _first_pair(device, stride)
    _, matched = nearest_neighbor_matched(
        src, dst, dmask, payload=dst[:, :2], backend="torch",
        tile=cfg.nn_dst_tile)
    s_xy = src[:, :2].contiguous()
    ident = RigidTransform2.identity(device=src.device)
    warm = align2d.estimate_transform(s_xy, matched, smask,
                                      cfg.with_(align_backend="torch"))
    return s_xy, matched, smask, ident, warm


def phase_gn_stats(device="cuda", stride: int = 1,
                   n_scans: int = BATCH_SCANS, pad: int = BATCH_PAD):
    """Kernels 12 and 13 vs their plain versions through
    align2d.weighted_gn_update_cuda (their only caller: their launches are
    counted there), at the main path's and the batched path's shapes; on
    the card timed by their launchers alone (kernel 12 on every cluster
    size, ``_stats_times``) and by their wrappers."""
    cfg = _config()
    k, eps = cfg.huber_k, cfg.det_rel_eps
    s_xy, matched, smask, ident, warm = _gn_stats_inputs(device, stride)
    bs, bd, bk, bt = _gn_batched_inputs(device, n_scans, pad)
    cases = [("gn_stats identity", ident, s_xy, matched, smask),
             ("gn_stats warm", warm, s_xy, matched, smask),
             ("gn_stats_batched", bt, bs, bd, bk)]
    _sync(device)
    cuda_build.reset_launches()
    updates = [align2d.weighted_gn_update_cuda(t, a, b, m, k, eps)
               for _, t, a, b, m in cases]
    _sync(device)
    launches = dict(cuda_build.LAUNCHES)
    worst = {"gn_stats": (0.0, 0.0), "gn_stats_batched": (0.0, 0.0)}
    for (name, t, a, b, m), upd in zip(cases, updates):
        kern = name.split()[0]
        fn = getattr(align2d_cuda, kern)
        plain = getattr(align2d_cuda, kern + "_plain")
        ref = align2d.weighted_gauss_newton_update(t, a, b, m, k, eps)
        rel, err = _gn_check(name, fn(a, b, m, t.rot, t.t, k),
                             plain(a, b, m, t.rot, t.t, k), upd, ref)
        worst[kern] = tuple(map(max, worst[kern], (rel, err)))
    if not (updates[2].ok[-1] and not updates[2].ok[-2]):
        raise RuntimeError("gn_stats_batched: the odd-count pair is not ok "
                           "or the all-masked pair is")
    recs = []
    # Bytes read once a point: both read src and dst in place and a bool
    # mask.
    for kern, line, args, point_bytes in (
            ("gn_stats", 188, (s_xy, matched, smask, warm.rot, warm.t, k),
             4 * 4 + 1),
            ("gn_stats_batched", 467, (bs, bd, bk, bt.rot, bt.t, k),
             4 * 4 + 1)):
        fn = getattr(align2d_cuda, kern)
        plain = getattr(align2d_cuda, kern + "_plain")
        wrapper_ms = time_ms(lambda: fn(*args), device, reps=50)
        ms, extra = wrapper_ms, dict(wrapper_ms=wrapper_ms)
        if torch.device(device).type == "cuda" and kern == "gn_stats":
            extra["cluster_ms"] = _stats_times(kern, args, device)
            n = args[0].shape[0]
            ms = extra["cluster_ms"][n][align2d_cuda.gn_cluster(n)]
        elif torch.device(device).type == "cuda":
            extra["routes_ms"], route = _gn_batched_routes(args, device)
            extra["route"] = route
            ms = extra["routes_ms"][route]
        plain_ms = time_ms(lambda: plain(*args), device, reps=3)
        n_pts, n_pairs = args[0].shape[-2], args[0][..., 0, 0].numel()
        b, by = bound_ms(point_bytes * n_pairs * n_pts
                         + n_pairs * (6 + 16) * 4,
                         float(args[2].sum()) * IRLS_OPS_PER_POINT)
        recs.append(dict(name=kern, route="cuda", path=kern,
                         source=f"icp_rust_tpu_torch/csrc/{kern}.cu",
                         replaces=f"icp_rust_tpu/ops/align2d_pallas.py:{line}",
                         max_abs_err=worst[kern][1], ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=None,
                         launches=launches[kern], max_rel_err=worst[kern][0],
                         extra=extra))
        print(f"# {kern}: launcher alone {ms:.4f} ms, wrapper "
              f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return recs




def _run_submap(pts, mask, cfg, device, with_metrics: bool = True, **kw):
    """One timed ``run_submap_odometry`` call with the launch counts zeroed
    just before it; returns (transforms, path, stats or None, seconds,
    launches, dropped points, hidden-cells warnings), the last two read
    from the runner's warnings."""
    _sync(device)
    cuda_build.reset_launches()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        out = run_submap_odometry(pts, mask, cfg, with_metrics=with_metrics,
                                  device=device, **kw)
        _sync(device)
        sec = time.perf_counter() - t0
    msgs = [str(w.message) for w in wl]
    dropped = sum(int(re.search(r"dropped (\d+) points", m).group(1))
                  for m in msgs if "hash map dropped" in m)
    hidden = [m for m in msgs if "view_rows hid" in m]
    stats = out[2] if with_metrics else None
    return (out[0], out[1], stats, sec, dict(cuda_build.LAUNCHES), dropped,
            hidden)


def _capture_warm_nn(call: int):
    """Patch ``nn_cuda.nn_seeded`` to keep a copy of the inputs of its
    ``call``-th warm call (or of the last, if there are fewer).  Returns
    (the dict that receives them, a function that undoes the patch)."""
    real = nn_cuda.nn_seeded
    seen = {"warm_calls": 0}

    def spy(query_p, pack, q_bound, d_dim, q_tile, warm=None):
        if warm and seen["warm_calls"] < call:
            seen["warm_calls"] += 1
            seen["inputs"] = (query_p.clone(), nn_cuda.PackedDB(
                pack.dbf_cm.clone(), pack.cbox.clone()), q_bound.clone(),
                d_dim, q_tile)
        return real(query_p, pack, q_bound, d_dim, q_tile, warm=warm)

    nn_cuda.nn_seeded = spy
    return seen, lambda: setattr(nn_cuda, "nn_seeded", real)


def phase_submap(device="cuda", n_frames: int = 96, stride: int = 1,
                 plain_frames: int = 8, tile: int = 2048, kw=None):
    """The scan-to-submap path at bench_submap.py's width, twice (bitwise
    equal; the second run timed), then the plain path on the first
    frames.  The first run keeps the inputs of its 16th warm nn_list call
    (frame 2 or 3, at the map view), which kernel 1 is then checked and
    timed on.  ``kw``: the map settings, for subsampled frames."""
    kw = SUBMAP_KW if kw is None else kw
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    seen, unpatch = _capture_warm_nn(SUBMAP_NN_CALL)
    try:
        tf1, path1, _, first_sec, _, _, _ = _run_submap(pts, mask, cfg,
                                                        device, **kw)
    finally:
        unpatch()
    tf, path, stats, sec, launches, dropped, hidden = _run_submap(
        pts, mask, cfg, device, **kw)
    if not (np.array_equal(path, path1) and torch.equal(tf.rot, tf1.rot)
            and torch.equal(tf.t, tf1.t)):
        raise RuntimeError("submap path: two runs differ")
    ate = ate_rmse(path, gt)
    outer = stats.outer_iters.cpu().numpy()
    total = int(outer.sum())
    fps = (n_frames - 1) / sec
    print(f"# submap path: {n_frames} frames of {pts.shape[1]} points, "
          f"{kw}, {sec:.4f} s, {fps:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s), bitwise equal to the first run; ATE vs "
          f"ground truth {ate:.6f} m; outer iterations per frame mean "
          f"{outer.mean():.3f} min {outer.min()} max {outer.max()} total "
          f"{total}; dropped points {dropped}; hidden-cells warnings "
          f"{len(hidden)}; launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"submap path ATE {ate} >= {ATE_GATE_M}")
    if hidden:
        raise RuntimeError(f"submap path hid occupied cells: {hidden}")
    on_card = torch.device(device).type == "cuda"
    if on_card and not (launches["nn_list"] == launches["irls_loop"] == total
                        and total > 0):
        raise RuntimeError(f"submap path launches {launches}, expected "
                           f"{total} nn_list and irls_loop")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    _, p_path, _, p_sec, p_launch, _, _ = _run_submap(
        pts[:plain_frames], mask[:plain_frames], plain_cfg, device, **kw)
    d = ate_rmse(p_path, path[:plain_frames - 1])
    print(f"# submap plain path on the first {plain_frames} frames: "
          f"{p_sec:.3f} s; trajectory vs kernel path {d:.3e} m (gate "
          f"{PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"submap plain path launched kernels: {p_launch}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"submap kernel vs plain trajectory {d} m")
    query_p, pack, qb, d_dim, q_tile = seen["inputs"]
    # Brute force over the view as packed: its valid rows, their payload,
    # for the real queries (padding rows carry -inf bounds, ops/nn.py).
    n = int(torch.sum(qb > float("-inf")))
    db = pack.dbf_cm[:d_dim].T.contiguous()
    brute = (query_p[:n], db, db[:, 0] < nn_cuda._SENTINEL / 2,
             pack.dbf_cm[d_dim:].T.contiguous(), tile)
    case = _nn_list_check(f"submap view (warm call {seen['warm_calls']}, "
                          f"{pack.dbf_cm.shape[1]} rows)", query_p, pack, qb,
                          d_dim, q_tile, brute=brute)
    rec = _nn_list_record(case, q_tile, device, "submap")
    rec.update(max_abs_err=case["err"], launches=launches["nn_list"])
    return dict(launches=launches, ate=ate, fps=fps, seconds=sec,
                outer_total=total, dropped=dropped, nn_list=rec)


def walls_sequence(n_frames: int = 8, n_pts: int = 400, seed: int = 0):
    """The JAX package's tests/test_submap.py wall world, scanned from a
    slowly moving pose: frames (F, n_pts, 2) in sensor coordinates and the
    ground-truth sensor positions in frame 0's coordinates."""
    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(8):
        a = rng.uniform(-8, 8, 2)
        ang = rng.uniform(0, np.pi)
        walls.append((a, np.array([np.cos(ang), np.sin(ang)]),
                      rng.uniform(3, 8)))
    poses = np.column_stack([0.06 * np.arange(n_frames),
                             0.04 * np.arange(n_frames),
                             0.015 * np.arange(n_frames)])
    frames = []
    for x, y, th in poses:
        widx = rng.integers(0, len(walls), n_pts)
        ts = rng.uniform(0, 1, n_pts)
        pw = np.stack([walls[i][0] + walls[i][1] * t * walls[i][2]
                       for i, t in zip(widx, ts)])
        c, s = np.cos(th), np.sin(th)
        local = (pw - [x, y]) @ np.array([[c, -s], [s, c]])
        frames.append(local + rng.normal(0, 0.003, local.shape))
    c, s = np.cos(poses[0, 2]), np.sin(poses[0, 2])
    gt = (poses[1:, :2] - poses[0, :2]) @ np.array([[c, -s], [s, c]])
    return np.stack(frames), gt


def phase_submap_2d(device="cuda", n_frames: int = 8, n_pts: int = 400):
    """The small 2D runs, fused and re-voxelize, on the wall world."""
    pts, gt = walls_sequence(n_frames, n_pts)
    mask = np.ones(pts.shape[:2], bool)
    cfg = _config()
    out = {}
    for fused in (True, False):
        _, path, _, sec, launches, dropped, _ = _run_submap(
            pts, mask, cfg, device, with_metrics=False, fused=fused,
            **SUBMAP_2D_KW)
        err = float(np.linalg.norm(path - gt, axis=1).max())
        name = "fused" if fused else "re-voxelize"
        print(f"# submap 2D {name}: {n_frames} frames of {n_pts} points, "
              f"{sec:.4f} s; max error vs ground truth {err:.6f} m (gate "
              f"{SUBMAP_2D_GATE_M}); dropped points {dropped}; launches "
              f"{launches}")
        if not err < SUBMAP_2D_GATE_M:
            raise RuntimeError(f"submap 2D {name}: max error {err} m")
        if torch.device(device).type == "cuda" and not (
                launches["nn_matched"] > 0 and launches["irls_loop"] > 0
                and launches["nn_list"] == 0):
            raise RuntimeError(f"submap 2D {name} launches {launches}")
        out[name] = dict(launches=launches, err=err)
    return out


def profile_submap(device="cuda", n_frames: int = 96):
    """Where the submap path's time goes at full width: host-clock time
    (with a synchronise around each call) in its ICP calls, its hash
    inserts and its Morton resorts, against the run's wall time; then
    torch.profiler over a second run: device time by kernel and the
    device's idle share against an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, mask, _ = frames3d(n_frames)
    cfg = _config()
    spent = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    patches = ((m_submap, "icp3d_planar"), (m_submap.vh, "insert"),
               (m_submap, "morton_order"))
    saved = [getattr(mod, n) for mod, n in patches]
    _run_submap(pts, mask, cfg, device, with_metrics=False, **SUBMAP_KW)
    wall = _run_submap(pts, mask, cfg, device, with_metrics=False,
                       **SUBMAP_KW)[3]
    try:
        for (mod, n), fn in zip(patches, saved):
            setattr(mod, n, timed(n, fn))
        split_wall = _run_submap(pts, mask, cfg, device, with_metrics=False,
                                 **SUBMAP_KW)[3]
    finally:
        for (mod, n), fn in zip(patches, saved):
            setattr(mod, n, fn)
    rest = split_wall - sum(spent.values())
    print(f"# profile submap: {n_frames} frames, unprofiled wall "
          f"{wall * 1e3:.3f} ms ({wall * 1e3 / (n_frames - 1):.3f} ms/frame);"
          f" with a synchronise around each call {split_wall * 1e3:.3f} ms: "
          + ", ".join(f"{n} {spent[n] * 1e3:.3f} ms "
                      f"({spent[n] / split_wall:.4f})" for _, n in patches)
          + f", the rest {rest * 1e3:.3f} ms ({rest / split_wall:.4f})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_submap(pts, mask, cfg, device, with_metrics=False, **SUBMAP_KW)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile submap: device busy {busy_ms:.3f} ms "
          f"({busy_ms / (n_frames - 1):.3f} ms/frame), idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile submap kernel {e.self_device_time_total / 1e3:9.3f}"
              f" ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _run_runner(fn, pts, mask, cfg, device, **kw):
    """One per-frame runner call with a MetricsLogger and the launch counts
    zeroed just before it; returns (path, the logger's records, seconds,
    launches)."""
    log = MetricsLogger(None)
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    _, path = fn(pts, mask, cfg, metrics=log, device=device, **kw)
    _sync(device)
    return path, log.records, time.perf_counter() - t0, \
        dict(cuda_build.LAUNCHES)


def _runner_check(name, fn, pts, mask, cfg, device, fused, kernels,
                  cut: int, every: int, **kw):
    """A per-frame runner against its fused runner's run (``fused``: its
    path and stats, from phase 4 or 13): with a MetricsLogger, its path
    bitwise the fused one's, its rows' outer iterations, Huber errors and
    mean NN distances equal to the fused stats, each of ``kernels``
    launched once per outer iteration; then killed after frame ``cut`` -
    1 with checkpoints every ``every`` frames and resumed over the whole
    sequence: bitwise the uninterrupted path.  Frames/s from a second run
    with metrics (host clock)."""
    path, rows, _, launches = _run_runner(fn, pts, mask, cfg, device, **kw)
    st = fused["stats"]
    outer = st.outer_iters.cpu().numpy()
    total = int(outer.sum())
    same_rows = (len(rows) == len(outer) and all(
        r.extra["outer_iters"] == int(outer[i])
        and r.huber_error == float(st.huber_error[i])
        and r.mean_nn_dist == float(st.mean_nn_dist[i])
        for i, r in enumerate(rows)))
    path2, _, sec, _ = _run_runner(fn, pts, mask, cfg, device, **kw)
    fps = (pts.shape[0] - 1) / sec
    with tempfile.TemporaryDirectory() as tmp:
        ck = SequenceCheckpointer(os.path.join(tmp, "ck.npz"), every)
        fn(pts[:cut], mask[:cut], cfg, checkpoint=ck, device=device, **kw)
        cursor = int(ck.restore()["frame_cursor"])
        res_path, res_rows, _, _ = _run_runner(
            fn, pts, mask, cfg, device, checkpoint=ck, resume=True, **kw)
    print(f"# {name}: {pts.shape[0]} frames of {pts.shape[1]} points; "
          f"second run with metrics {sec:.4f} s, {fps:.2f} frames/s (host "
          f"clock), bitwise the first: {np.array_equal(path2, path)}; path "
          f"bitwise the fused runner's: "
          f"{np.array_equal(path, fused['path'])}; {len(rows)} rows equal "
          f"to the fused stats: {same_rows}; {total} outer iterations; "
          f"launches {launches}; killed after frame {cut - 1} (checkpoint "
          f"at frame {cursor}), resumed over {len(res_rows)} frames: "
          f"bitwise {np.array_equal(res_path, path)}")
    if not np.array_equal(path, fused["path"]):
        raise RuntimeError(f"{name}: path differs from the fused runner's")
    if not np.array_equal(path2, path):
        raise RuntimeError(f"{name}: two runs differ")
    if not same_rows:
        raise RuntimeError(f"{name}: metrics rows differ from the fused "
                           "runner's stats")
    if not (np.array_equal(res_path, path)
            and len(res_rows) == pts.shape[0] - 1 - cursor):
        raise RuntimeError(f"{name}: resumed path differs")
    if torch.device(device).type == "cuda" and not (
            total > 0 and all(launches[k] == total for k in kernels)):
        raise RuntimeError(f"{name} launches {launches}, expected {total} "
                           f"of {kernels}")
    return dict(launches=launches, fps=fps)


def phase_runners(device="cuda", main=None, p2l=None, n_frames: int = 96,
                  stride: int = 1, tile: int = 2048, cut: int = 41,
                  every: int = 10, voxel: float = P2L_VOXEL_M):
    """The per-frame runners on the main path's frames:
    ``run_odometry_device`` against phase 4's fused run and
    ``run_odometry_p2l`` against phase 13's (``main``, ``p2l``: those
    phases' results), with kill and resume."""
    pts, mask, _ = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    device_run = _runner_check("odometry-device runner", run_odometry_device,
                               pts, mask, cfg, device, main,
                               ("nn_list", "irls_loop"), cut, every)
    p2l_run = _runner_check("odometry-p2l runner", run_odometry_p2l, pts,
                            mask, cfg, device, p2l, ("nn_list", "p2l_loop"),
                            cut, every, normals_voxel_size=voxel)
    return {"odometry-device": device_run, "odometry-p2l": p2l_run}


def _cli(argv, device):
    """``cli.main(argv)`` in-process with the launch counts zeroed just
    before it; returns (its JSON summary, seconds, launches)."""
    out = io_std.StringIO()
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    _sync(device)
    sec = time.perf_counter() - t0
    return json.loads(out.getvalue().strip().splitlines()[-1]), sec, \
        dict(cuda_build.LAUNCHES)


def phase_cli(device="cuda", n_scans: int = BATCH_SCANS,
              pad: int = BATCH_PAD):
    """The batched path's synthetic 2D scans written as NNN.txt files: the
    native loader against the python one, then the CLI's odometry2d (the
    whole-frame kernel, the native oracle), its metrics route and slam."""
    pts, mask, _, _ = scans2d(n_scans, pad)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        scans = os.path.join(tmp, "scans")
        os.makedirs(scans)
        for k, (p, m) in enumerate(zip(pts, mask)):
            np.savetxt(os.path.join(scans, f"{k:03d}.txt"), p[m])
        t0 = time.perf_counter()
        got_pts, got_mask = native_loader.load_scan2d_padded(scans)
        load_sec = time.perf_counter() - t0
        want_pts, want_mask = io.pad_points(io.load_scan2d_sequence(scans))
        same = (np.array_equal(got_pts, want_pts.astype(np.float32))
                and np.array_equal(got_mask, want_mask))
        print(f"# native loader: {got_pts.shape[0]} scans padded to "
              f"{got_pts.shape[1]} in {load_sec:.4f} s (host clock, "
              f"library build included), bitwise the python loader's: "
              f"{same}")
        if not same:
            raise RuntimeError("native loader differs from the python one")
        try:
            cli.main(["odometry2d", "--scans", scans])
            refused = ""
        except SystemExit as e:
            refused = str(e)
        print(f"# cli odometry2d without --f32 on the default device: "
              f"{refused or 'ran'}")
        if "--f32" not in refused:
            raise RuntimeError("cli: the float64 config was not refused on "
                               "the card")
        # On the card as a user calls it: --device left at its default.
        base = ["--scans", scans, "--f32", "--point-scale", "1"] + (
            [] if torch.device(device).type == "cuda"
            else ["--device", device])
        summary, sec, launches = _cli(["odometry2d", *base,
                                       "--compare-oracle"], device)
        n = summary["frames"]
        print(f"# cli odometry2d: {n} frames, {sec:.4f} s with the oracle "
              f"({summary['frames_per_s']:.2f} frames/s by its summary); "
              f"oracle {summary['oracle']}, ATE vs oracle "
              f"{summary['ate_rmse_vs_oracle']:.6e} m (gate {ATE_GATE_M}); "
              f"launches {launches}")
        if summary["oracle"] != "native_cpp":
            raise RuntimeError("cli odometry2d: the native oracle did not "
                               "run")
        if not summary["ate_rmse_vs_oracle"] < ATE_GATE_M:
            raise RuntimeError("cli odometry2d: ATE vs oracle "
                               f"{summary['ate_rmse_vs_oracle']}")
        on_card = torch.device(device).type == "cuda"
        if on_card and launches["icp2d_frame"] != n:
            raise RuntimeError(f"cli odometry2d launches {launches}, "
                               f"expected {n} icp2d_frame")
        runs["cli-odometry2d"] = dict(launches=launches, summary=summary)
        rows = os.path.join(tmp, "run.jsonl")
        m_summary, m_sec, m_launch = _cli(
            ["odometry2d", *base, "--metrics", rows, "--checkpoint",
             os.path.join(tmp, "ck.npz"), "--every", "50"], device)
        with open(rows) as f:
            n_rows = len(f.readlines())
        d = float(np.linalg.norm(np.subtract(m_summary["path_end"],
                                             summary["path_end"])))
        print(f"# cli odometry2d --metrics: {n_rows} rows, {m_sec:.4f} s "
              f"({m_summary['frames_per_s']:.2f} frames/s); path end vs "
              f"the whole-frame kernel's {d:.3e} m (gate {PLAIN_GATE_M}); "
              f"launches {m_launch}")
        if n_rows != n or not d < PLAIN_GATE_M:
            raise RuntimeError("cli odometry2d --metrics: rows or path end")
        if on_card and m_launch["icp2d_frame"] != 0:
            raise RuntimeError("cli odometry2d --metrics took kernel 3")
        runs["cli-odometry2d-metrics"] = dict(launches=m_launch,
                                              summary=m_summary)
        s_summary, s_sec, s_launch = _cli(
            ["slam", *base, "--loop-radius", "1.5", "--loop-gap", "20"],
            device)
    print(f"# cli slam: {s_summary['frames']} frames, {s_sec:.4f} s, "
          f"{s_summary['loop_closures']} loop closures, graph error before "
          f"{s_summary['graph_error_before']:.6e} after "
          f"{s_summary['graph_error_after']:.6e}; launches {s_launch}")
    if not s_summary["graph_error_after"] <= s_summary["graph_error_before"]:
        raise RuntimeError("cli slam: the graph error grew")
    if on_card and not all(s_launch[k] > 0 for k in (
            "nn_pairs", "nn_pairs_list", "irls_loop_batched")):
        raise RuntimeError(f"cli slam launches {s_launch}")
    runs["cli-slam"] = dict(launches=s_launch, summary=s_summary)
    h5 = importlib.util.find_spec("h5py") is not None
    print(f"# cli odometry3d, slam3d: not run (they read HDF5 through "
          f"h5py, {'present' if h5 else 'absent'} here; phases 4, 13, 15 "
          f"and 21 drive their runners on the same frames)")
    return runs


def _trace_names(log_dir: str) -> set:
    """Event names of the Chrome trace ``profiling.trace`` wrote."""
    names = set()
    for fname in glob.glob(os.path.join(log_dir, "*.pt.trace.json")):
        with open(fname) as f:
            names |= {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return names


def phase_hooks(device="cuda", graph=None, n_frames: int = 4,
                stride: int = 1, tile: int = 2048, iters: int = 15):
    """The profiling and debug hooks on the main path's first frames, and
    the Schur graph solve against the dense one on ``graph`` (phase 15's
    float64 pose graph)."""
    pts, mask, _ = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            with profiling.annotate("odometry"):
                run_odometry_fused(pts, mask, cfg, device=device)
                _sync(device)
        names = _trace_names(tmp)
    want = ["odometry"] + (["nn_list", "irls"] if on_card else [])
    found = {w: sorted(n for n in names if w in n)[:2] for w in want}
    print(f"# trace: {len(names)} event names; {found}")
    if not all(found.values()):
        raise RuntimeError(f"trace lacks {[w for w in want if not found[w]]}")
    checked = debug.checked(run_odometry_fused)(pts, mask, cfg,
                                                device=device)
    try:
        with profiling.debug_mode():
            torch.tensor(0.0, device=device) / 0
    except FloatingPointError as err:
        print(f"# debug: checked(run_odometry_fused) passed on "
              f"{checked[1].shape[0]} frames; debug_mode raised: {err}")
    else:
        raise RuntimeError("debug_mode did not raise on 0 / 0")
    kw = dict(iters=iters, huber_k=1.345, kernel="cauchy")
    times = {}
    for name, solve in (("dense", functools.partial(
            pg.optimize, solve="dense", **kw)),
                        ("schur", functools.partial(optimize_schur, **kw))):
        for _ in range(2):   # the second timed
            _sync(device)
            t0 = time.perf_counter()
            out = solve(graph)
            _sync(device)
            times[name] = (time.perf_counter() - t0, out)
    # The residuals and Jacobians both solvers evaluate each iteration.
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        pg.edge_residuals_and_jacobians(graph)
    _sync(device)
    jac_s = time.perf_counter() - t0
    dense, schur = times["dense"][1], times["schur"][1]
    err = max(float((schur.poses.t - dense.poses.t).abs().max()),
              float((schur.poses.rot - dense.poses.rot).abs().max()))
    print(f"# graph solve ({graph.poses.t.shape[0]} poses, "
          f"{graph.edge_i.shape[0]} edges, {iters} GN iterations, float64 "
          f"on {device}): dense {times['dense'][0]:.4f} s, schur "
          f"{times['schur'][0]:.4f} s (host clock, second run), of which "
          f"{iters} residual and Jacobian evaluations {jac_s:.4f} s; poses "
          f"{err:.3e} apart (gate 1e-8)")
    if not err <= 1e-8:
        raise RuntimeError(f"schur vs dense poses {err}")
    return dict(dense_s=times["dense"][0], schur_s=times["schur"][0],
                jac_s=jac_s, err=err)


SHARDED_RANKS = 4
SHARDED_PAIRS = 4
SHARDED_BATCH = 208
# Gates of phase 24: the JAX package's test_pose_graph tolerances of the
# edge-sharded graph solve against the local CG (t, rot); the sharded
# Schur solve against the local one; the sharded p2l driver's xy and
# rotation against the single-device one (boundary-voxel normals differ,
# tests/test_parallel3d), and its z too with the point axis unsharded.
# Sharded over points its z, which these scenes constrain weakly, moves
# with the per-shard normals: its max |z| against the planar truth may
# exceed the single-device driver's by at most the margin (on the H100,
# 0.028320 m against 0.017541 m: 0.0108 m beyond it; PERF.md §6).
DIST_GRAPH_TOL = (1e-5, 1e-6)
SCHUR_SHARDED_TOL = 1e-10
P2L_SHARDED_GATE = 2e-3
P2L_SHARDED_Z_MARGIN_M = 0.015
SHARDED_GRAPH_KW = dict(iters=15, huber_k=1.345, kernel="cauchy")
SHARDED_CG_ITERS = 100
# The kernels each sharded path must launch (summed over the ranks).
SHARDED_KERNELS = {
    "sharded-3d": ("nn_matched",), "sharded-p2l": ("nn_matched",),
    "sharded-p2l-sp1": ("nn_matched",),
    "sharded-2d": ("nn_pruned",),
    "sharded-ring": ("nn_pruned", "nn_sweep", "nn_matched"),
    "sharded-batched": ("nn_pairs", "nn_pairs_list", "irls_loop_batched"),
    "sharded-batched-pairs": ("icp2d_frame_pairs",)}


def _graph_arrays(graph) -> tuple:
    return tuple(x.detach().cpu().numpy() for x in (
        graph.poses.rot, graph.poses.t, graph.edge_i, graph.edge_j,
        graph.meas.rot, graph.meas.t, graph.info, graph.edge_mask))


def _lift3(t: RigidTransform2) -> RigidTransform3:
    """SE(2) transforms (B,) as SE(3) ones about z."""
    rot = torch.zeros((*t.rot.shape[:-2], 3, 3), dtype=t.rot.dtype)
    rot[..., :2, :2], rot[..., 2, 2] = t.rot, 1.0
    return RigidTransform3(rot, torch.cat(
        [t.t, torch.zeros_like(t.t[..., :1])], dim=-1))


def _positions(t) -> np.ndarray:
    """Where each transform puts its frame: the xy of its inverse's
    translation (the odometry path's convention)."""
    rot, tt = t.rot.detach().cpu().double(), t.t.detach().cpu().double()
    return (-torch.einsum("...ji,...j->...i", rot, tt))[..., :2].numpy()


def _z_error(t) -> float:
    """The largest |z| of where the SE(3) transforms put their frames
    (the z of their inverses' translations)."""
    rot, tt = t.rot.detach().cpu().double(), t.t.detach().cpu().double()
    return float((torch.einsum("...ji,...j->...i", rot, tt))[..., 2]
                 .abs().max())


def _max_diff(a, b) -> float:
    """The larger of the translations' and the rotations' largest
    difference over the pairs."""
    return max(float((a.t.cpu().double() - b.t.cpu().double()).abs().max()),
               float((a.rot.cpu().double()
                      - b.rot.cpu().double()).abs().max()))


def _sharded_rank(inp: dict, device_type: str, tile: int,
                  voxel: float) -> dict:
    """Phase 24's sub-runs on one rank of its gloo world; every rank
    passes the global arrays of ``inp``.  Each sub-run is timed by the
    host clock from a barrier, with the launch counts zeroed just before
    it and read just after; the checks against single-device calls on
    this rank's own slice run after that."""
    import torch.distributed as dist

    from icp_rust_tpu_torch.parallel import collectives, dist_graph, mesh, \
        ring_nn, sharded
    from icp_rust_tpu_torch.parallel.dryrun import _to_host

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    cfg = _config(nn_dst_tile=tile)
    grid = mesh.make_mesh(("dp", "sp"), (2, 2), device_type)
    row = mesh.make_mesh(("dp", "sp"), (1, SHARDED_RANKS), device_type)
    col = mesh.make_mesh(("dp", "sp"), (SHARDED_RANKS, 1), device_type)
    out = {"transport": collectives.transport(grid.get_group("sp"))}

    def timed(path, fn):
        _sync(dev)
        dist.barrier()
        cuda_build.reset_launches()
        collectives.CALLS.clear()
        t0 = time.perf_counter()
        value = fn()
        _sync(dev)
        out[path] = dict(seconds=time.perf_counter() - t0,
                         launches=dict(cuda_build.LAUNCHES),
                         collectives=dict(collectives.CALLS),
                         value=_to_host(value))
        return value

    src, dst, sm, dm = (torch.as_tensor(inp[k])
                        for k in ("src", "dst", "src_mask", "dst_mask"))
    warm = RigidTransform2(torch.as_tensor(inp["warm_rot"]),
                           torch.as_tensor(inp["warm_t"]))
    timed("sharded-3d", lambda: sharded.dp_sp_icp3d_planar(
        src, dst, sm, dm, warm, cfg, grid))
    timed("sharded-p2l", lambda: sharded.dp_sp_icp_p2l(
        src, dst, sm, dm, _lift3(warm), cfg, grid,
        normals_voxel_size=voxel))
    # The same pairs with the point axis unsharded (a pair a rank): each
    # destination's normals on one grid, as the single-device driver's.
    timed("sharded-p2l-sp1", lambda: sharded.dp_sp_icp_p2l(
        src, dst, sm, dm, _lift3(warm), cfg, col,
        normals_voxel_size=voxel))
    timed("sharded-2d", lambda: sharded.sharded_icp2d(
        src[0, :, :2], dst[0, :, :2], sm[0], dm[0],
        RigidTransform2.identity(), cfg, row))

    # The ring alone on the point axis of ``row``: frame 1's queries
    # (this rank's block) against frame 0 (sharded), and, with a batch
    # axis, frames 1 and 2 against frames 0 and 1.
    sp = mesh.axis(row, "sp")
    q = dst[:2].to(dev)
    db = torch.cat([src[:1], dst[:1]]).to(dev)
    dbm = torch.cat([sm[:1], dm[:1]]).to(dev)
    q_l, db_l, dbm_l = (mesh.block(x, sp, 1) for x in (q, db, dbm))

    def ring():
        res = []
        for b in (0, slice(0, 2)):
            res.append(ring_nn.ring_nearest_neighbor(
                q_l[b], db_l[b], dbm_l[b], sp.group, tile=tile))
            res.append(ring_nn.ring_nearest_neighbor_matched(
                q_l[b], db_l[b], dbm_l[b], sp.group, tile=tile))
        return res
    got = timed("sharded-ring", ring)
    bitwise = True
    for k, b in enumerate((0, slice(0, 2))):
        want = nn_sweep_cuda.search(q_l[b], db[b], dbm[b], db[b],
                                    db_tile=tile)
        plain, (matched, pay) = got[2 * k], got[2 * k + 1]
        bitwise &= all(torch.equal(x, y) for x, y in (
            (plain.index, want[0]), (plain.dist_sq, want[1]),
            (matched.index, want[0]), (matched.dist_sq, want[1]),
            (pay, want[2])))
    out["sharded-ring"]["bitwise"] = bitwise

    bsrc, bdst, bsm, bdm = (torch.as_tensor(inp[k]) for k in (
        "bsrc", "bdst", "bsm", "bdm"))
    t0 = RigidTransform2.identity((bsrc.shape[0],))
    dp = mesh.axis(col, "dp")
    for path, c in (("sharded-batched", cfg),
                    ("sharded-batched-pairs", cfg.with_(
                        frame_backend="pairs"))):
        full = timed(path, lambda c=c: sharded.batched_icp2d(
            bsrc, bdst, bsm, bdm, t0, c, mesh=col))
        mine = [mesh.block(x, dp, 0).to(dev) for x in (bsrc, bdst, bsm,
                                                       bdm)]
        own = sharded.batched_icp2d(
            mine[0], mine[1], mine[2], mine[3],
            RigidTransform2.identity((mine[0].shape[0],), device=dev), c,
            device=dev)
        out[path]["bitwise"] = (
            torch.equal(mesh.block(full.rot, dp, 0), own.rot)
            and torch.equal(mesh.block(full.t, dp, 0), own.t))

    graph = pg.graph_to(convert.pose_graph_from_numpy(*inp["graph"]), dev)
    timed("sharded-graph", lambda: (
        dist_graph.optimize_distributed(
            graph, col, cg_iters=SHARDED_CG_ITERS, **SHARDED_GRAPH_KW).poses,
        optimize_schur(graph, mesh=col, **SHARDED_GRAPH_KW).poses))
    return out


def _nccl_rank(inp: dict, tile: int) -> dict:
    """Phase 24 (b): ``dp_sp_icp3d_planar`` on pair 1 in a one-rank NCCL
    world on the card."""
    from icp_rust_tpu_torch.parallel import collectives, mesh, sharded

    m = mesh.make_mesh(("dp", "sp"), (1, 1), "cuda")
    src, dst, sm, dm = (torch.as_tensor(inp[k][:1])
                        for k in ("src", "dst", "src_mask", "dst_mask"))
    t0 = time.perf_counter()
    t = sharded.dp_sp_icp3d_planar(src, dst, sm, dm,
                                   RigidTransform2.identity((1,)),
                                   _config(nn_dst_tile=tile), m)
    torch.cuda.synchronize()
    return dict(transport=collectives.transport(m.get_group("sp")),
                device=str(t.t.device), seconds=time.perf_counter() - t0,
                value=t)


def sharded_inputs(graph, n_frames: int = SHARDED_PAIRS + 1,
                   stride: int = 1, tile: int = 2048,
                   n_scans: int = BATCH_SCANS, pad: int = BATCH_PAD,
                   n_batch: int = SHARDED_BATCH, device="cuda"):
    """Phase 24's global arrays (numpy): pairs (frame 0, frame k), k = 1..
    n_frames - 1, warm-started from the main path's estimate for frame
    k - 1 (a ``run_odometry_fused`` over the first n_frames - 1 frames,
    bitwise phase 4's first estimates: each frame's call sees only the
    frames before it); the first ``n_batch`` batched pairs; ``graph``'s
    arrays.  Also the ground-truth positions of frames 1.. ."""
    pts, mask, gt = frames3d(n_frames, stride)
    pts = pts.astype(np.float32)
    est, _ = run_odometry_fused(pts[:-1], mask[:-1], _config(
        nn_dst_tile=tile), device=device)
    k = n_frames - 1
    warm_rot = np.concatenate([np.eye(2, dtype=np.float32)[None],
                               est.rot[:k - 1].cpu().numpy()])
    warm_t = np.concatenate([np.zeros((1, 2), np.float32),
                             est.t[:k - 1].cpu().numpy()])
    scans = scans2d(n_scans, pad)
    bpts, bmask = scans[0].astype(np.float32), scans[1]
    return dict(src=np.repeat(pts[:1], k, 0), dst=pts[1:],
                src_mask=np.repeat(mask[:1], k, 0), dst_mask=mask[1:],
                warm_rot=warm_rot, warm_t=warm_t,
                bsrc=bpts[:n_batch], bdst=bpts[1:n_batch + 1],
                bsm=bmask[:n_batch], bdm=bmask[1:n_batch + 1],
                graph=_graph_arrays(graph), gt=gt[:k])


def phase_sharded(device="cuda", smi: str = "", inputs=None,
                  tile: int = 2048, voxel: float = P2L_VOXEL_M,
                  p2l_gate: float = P2L_SHARDED_GATE,
                  p2l_z_margin: float = P2L_SHARDED_Z_MARGIN_M,
                  timeout_s: float = 600.0):
    """Phase 24: ``parallel/`` on torch.distributed.  (a) Four gloo ranks
    on one device (NCCL refuses two ranks on one card): the sharded
    drivers, the ring NN, ``batched_icp2d`` with a mesh and the sharded
    graph solves, each against its single-device counterpart here; (b) on
    the card, a one-rank NCCL world; (c) ``dryrun_multichip``.  ``inputs``: ``sharded_inputs``' arrays.
    Returns each path's launches summed over the ranks."""
    from icp_rust_tpu_torch.parallel import dryrun

    dev = torch.device(device)
    kind = "cuda" if dev.type == "cuda" else "cpu"
    cfg = _config(nn_dst_tile=tile)
    inp = inputs
    t0 = time.perf_counter()
    ranks = dryrun.spawn(_sharded_rank, SHARDED_RANKS, "gloo", kind,
                         timeout_s, (inp, kind, tile, voxel),
                         threads=1 if kind == "cpu" else None)
    world_s = time.perf_counter() - t0
    res = [r.value for r in ranks]
    paths = [p for p in res[0] if p.startswith("sharded-")]
    runs = {p: {name: sum(r[p]["launches"][name] for r in res)
                for name in cuda_build.SOURCES} for p in paths}
    secs = {p: max(r[p]["seconds"] for r in res) for p in paths}
    colls = {p: res[0][p]["collectives"] for p in paths}
    for p in paths:
        for r in res[1:]:
            if p != "sharded-ring" and not _same_value(r[p]["value"],
                                                       res[0][p]["value"]):
                raise RuntimeError(f"{p}: ranks disagree")
    val = {p: res[0][p]["value"] for p in paths}

    # Single-device counterparts, on this device.
    src, dst, sm, dm = (torch.as_tensor(inp[k]) for k in (
        "src", "dst", "src_mask", "dst_mask"))
    warm = RigidTransform2(torch.as_tensor(inp["warm_rot"]),
                           torch.as_tensor(inp["warm_t"]))
    pairs = src.shape[0]
    single = {}
    single["sharded-3d"] = [m_icp.icp3d_planar(
        src[k], dst[k], sm[k], dm[k], RigidTransform2(warm.rot[k],
                                                      warm.t[k]),
        cfg, device=device) for k in range(pairs)]
    lifted = _lift3(warm)
    single["sharded-p2l"] = [m_p2l.icp_point_to_plane(
        src[k], dst[k], sm[k], dm[k], RigidTransform3(lifted.rot[k],
                                                      lifted.t[k]),
        cfg, normals_voxel_size=voxel, device=device)
        for k in range(pairs)]
    single["sharded-2d"] = [m_icp.icp2d(
        src[0, :, :2], dst[0, :, :2], sm[0], dm[0],
        RigidTransform2.identity(), cfg, device=device)]
    for p, gate in (("sharded-3d", PLAIN_GATE_M),
                    ("sharded-p2l", p2l_gate),
                    ("sharded-p2l-sp1", p2l_gate),
                    ("sharded-2d", PLAIN_GATE_M)):
        one = single[p.removesuffix("-sp1")]
        both = type(one[0])(torch.stack([o.rot.cpu() for o in one]),
                            torch.stack([o.t.cpu() for o in one]))
        got = val[p]
        if got.t.ndim == 1:
            got = type(got)(got.rot[None], got.t[None])
        d = _max_diff(type(got)(got.rot, got.t[..., :2]),
                      type(both)(both.rot, both.t[..., :2]))
        err = np.linalg.norm(_positions(got) - inp["gt"][:len(one)],
                             axis=-1)
        ate = float(np.sqrt(np.mean(err ** 2)))
        ok = d < gate and ate < ATE_GATE_M
        z_note = ""
        if got.t.shape[-1] == 3:
            # z: the truth is planar (z 0), so each driver's largest |z|
            # is its z error.  Unsharded points (sp1) share the
            # single-device driver's normals and are held to ``gate`` in
            # z too; per-shard normals (sp 2) to ``p2l_z_margin`` beyond
            # the single-device driver's |z|.
            dz = float((got.t[..., 2] - both.t[..., 2]).abs().max())
            z_got, z_one = _z_error(got), _z_error(both)
            z_gate = (gate if p.endswith("-sp1") else z_one + p2l_z_margin)
            z_val = dz if p.endswith("-sp1") else z_got
            z_note = (f", z {dz:.3e}; max |z| vs the planar truth: sharded "
                      f"{z_got:.6f} m, single-device {z_one:.6f} m (gate: "
                      + ("z within the xy gate" if p.endswith("-sp1") else
                         f"sharded |z| < {z_gate:.6f} m") + ")")
            ok = ok and z_val < z_gate
        print(f"# {p}: {len(one)} pair(s), {secs[p]:.3f} s (host clock, "
              f"slowest rank), collectives a rank {colls[p]}; vs the "
              f"single-device driver: xy and rotation {d:.3e} (gate "
              f"{gate:g}){z_note}; ATE(-xy) vs ground truth {ate:.6f} m "
              f"(gate {ATE_GATE_M}); launches over the ranks "
              f"{_nonzero(runs[p])}; {smi}")
        if not ok:
            raise RuntimeError(f"{p}: xy/rotation {d} from the "
                               f"single-device driver, ATE {ate}{z_note}")
    ring_ok = all(r["sharded-ring"]["bitwise"] for r in res)
    print(f"# sharded-ring: frame 1 against frame 0 (and frames 1-2 "
          f"against 0-1 with a batch axis) on {SHARDED_RANKS} ranks, plain "
          f"and matched, {secs['sharded-ring']:.3f} s, collectives a rank "
          f"{colls['sharded-ring']}; bitwise equal to "
          f"search over the whole cloud on every rank: {ring_ok}; launches "
          f"{_nonzero(runs['sharded-ring'])}; {smi}")
    if not ring_ok:
        raise RuntimeError("sharded-ring: not bitwise the whole-cloud search")
    bsrc, bdst, bsm, bdm = (torch.as_tensor(inp[k]) for k in (
        "bsrc", "bdst", "bsm", "bdm"))
    for p, c in (("sharded-batched", cfg),
                 ("sharded-batched-pairs", cfg.with_(frame_backend="pairs"))):
        full = batched_icp2d(bsrc, bdst, bsm, bdm, RigidTransform2.identity(
            (bsrc.shape[0],)), c, device=device)
        d = _max_diff(val[p], full)
        own = all(r[p]["bitwise"] for r in res)
        print(f"# {p}: {bsrc.shape[0]} pairs, {bsrc.shape[0] // SHARDED_RANKS}"
              f" a rank, {secs[p]:.3f} s, collectives a rank {colls[p]}; "
              f"each rank bitwise its slice's "
              f"single-device call: {own}; vs the full single-device call "
              f"{d:.3e} (gate {IRLS_TOL}); launches {_nonzero(runs[p])}; "
              f"{smi}")
        if not (own and d <= IRLS_TOL):
            raise RuntimeError(f"{p}: slices bitwise {own}, {d} from the "
                               "full call")
    graph = pg.graph_to(convert.pose_graph_from_numpy(*inp["graph"]), dev)
    cg = pg.optimize(graph, solve="cg", cg_iters=SHARDED_CG_ITERS,
                     **SHARDED_GRAPH_KW).poses
    local = optimize_schur(graph, **SHARDED_GRAPH_KW).poses
    dist_p, schur_p = val["sharded-graph"]
    per_coll = 1e3 * secs["sharded-graph"] / max(
        1, sum(colls["sharded-graph"].values()))
    d_t = float((dist_p.t - cg.t.cpu()).abs().max())
    d_r = float((dist_p.rot - cg.rot.cpu()).abs().max())
    d_s = max(float((schur_p.t - local.t.cpu()).abs().max()),
              float((schur_p.rot - local.rot.cpu()).abs().max()))
    print(f"# sharded-graph: {graph.poses.t.shape[0]} poses, "
          f"{graph.edge_i.shape[0]} edges, float64, {SHARDED_RANKS} edge / "
          f"segment shards, {secs['sharded-graph']:.3f} s for both solves, "
          f"collectives a rank {colls['sharded-graph']} ({per_coll:.3f} ms "
          f"a collective, derived: the seconds over their count); "
          f"optimize_distributed vs optimize(solve='cg') t {d_t:.3e} rot "
          f"{d_r:.3e} (gates {DIST_GRAPH_TOL}); sharded vs local Schur "
          f"{d_s:.3e} (gate {SCHUR_SHARDED_TOL}); {smi}")
    if not (d_t <= DIST_GRAPH_TOL[0] and d_r <= DIST_GRAPH_TOL[1]
            and d_s <= SCHUR_SHARDED_TOL):
        raise RuntimeError(f"sharded-graph: {d_t}, {d_r}, {d_s}")
    for p, names in SHARDED_KERNELS.items():
        if dev.type == "cuda" and not all(runs[p][n] > 0 for n in names):
            raise RuntimeError(f"{p} launches {runs[p]}, expected {names}")

    # (b) One NCCL rank on the card (gloo on the CPU).
    t0 = time.perf_counter()
    if dev.type == "cuda":
        one = dryrun.spawn(_nccl_rank, 1, "nccl", "cuda", timeout_s,
                           (inp, tile))[0].value
        d = _max_diff(one["value"], type(val["sharded-3d"])(
            val["sharded-3d"].rot[:1], val["sharded-3d"].t[:1]))
        print(f"# sharded-nccl: one NCCL rank, mesh (1, 1), pair 1 on "
              f"{one['device']}: {one['seconds']:.3f} s ({one['transport']}"
              f"); vs (a)'s pair 1 {d:.3e} (gate {PLAIN_GATE_M}); the world "
              f"{time.perf_counter() - t0:.1f} s; {smi}")
        if not (d < PLAIN_GATE_M and one["device"].startswith("cuda")):
            raise RuntimeError(f"sharded-nccl: {d} from (a), on "
                               f"{one['device']}")

    # (c) The dry run.
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(SHARDED_RANKS, kind, timeout_s)
    worst = max(max(r.value.values()) for r in dry)
    print(f"# dryrun_multichip({SHARDED_RANKS}, {kind!r}): "
          f"{len(dry[0].value)} checks passed on every rank (largest "
          f"difference {worst:.3e}), {time.perf_counter() - t0:.1f} s; "
          f"{smi}")
    print(f"# phase 24: the {SHARDED_RANKS}-rank world {world_s:.1f} s "
          f"({res[0]['transport']}); four processes time-share one card "
          f"through host-staged gloo, so no scaling figure")
    return runs


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def _same_value(a, b) -> bool:
    """Two ranks' results (transforms, tuples of them, or lists) equal."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y)
                                        for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return torch.equal(a.rot, b.rot) and torch.equal(a.t, b.t)


def _capture_calls(module, name: str, limit: int | None = None):
    """Patch ``module.name`` to keep a copy of every call's positional
    arguments (tensors cloned), or of the first ``limit`` calls'.  Returns
    (the list that receives them, a function that undoes the patch)."""
    real = getattr(module, name)
    calls = []

    def spy(*args, **kw):
        if limit is None or len(calls) < limit:
            calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args))
        return real(*args, **kw)

    setattr(module, name, spy)
    return calls, lambda: setattr(module, name, real)


def frame_inputs(device, n: int = 640, pad: int = 768,
                 n_max: int = align2d_cuda.FRAME_MAX_POINTS):
    """Kernel 3's pairs: the 2D path's ``n`` points padded to ``pad``, and
    ``n_max`` points (FRAME_MAX_POINTS) unpadded: {shape: (src, src mask,
    dst, dst mask)}."""
    return {f"{n}x{pad}": pair2d(device, n, pad),
            f"{n_max}x{n_max}": pair2d(device, n_max, n_max)}


def _frame_times(pair, device, reps: int = 20):
    """Kernel 3 on one pair by its launcher alone, on the wrapper's
    cluster and, where the tree has them, on every cluster size (each
    bitwise equal to the wrapper's result), against its plain version
    (max |diff| of rot/t, outer iterations)."""
    sp, sm, dp, dm = pair
    cfg = _config()
    t0 = RigidTransform2.identity(dtype=torch.float32, device=device)
    _, largs, out, keep = align2d_cuda._icp2d_frame_args(sp, dp, sm, dm, t0,
                                                         cfg)
    ms = launcher_ms("icp2d_frame", largs, device, reps=reps)
    _sync(device)
    ref = out.clone()
    rot_p, t_p, it_p = m_icp.icp2d_frame_plain(sp, dp, sm, dm, t0, cfg)
    err = max(float(torch.max(torch.abs(ref[:4] - rot_p.reshape(4)))),
              float(torch.max(torch.abs(ref[4:6] - t_p))))
    clusters = {}
    for c in getattr(align2d_cuda, "FRAME_CLUSTERS", ()):
        clusters[c] = launcher_ms(
            "icp2d_frame", largs[:-1] + (c, largs[-1]), device, reps=reps,
            fn=cuda_build.query("icp2d_frame_launch_cluster"))
        _sync(device)
        if not torch.equal(out, ref):
            raise RuntimeError(f"icp2d_frame: a cluster of {c} blocks "
                               "changes the result")
    del keep
    return dict(ms=ms, max_abs_err=err, outer=int(ref[6]),
                outer_plain=int(it_p), inner=int(ref[7]),
                cluster_ms=clusters)


# The frame kernels' split of their outer iterations (``frame_split``):
# a copy of a kernel's sources, built into _build/split, with clock64()
# stamps that thread 0 of each pair's leader block adds up over the outer
# iterations into the device array icp_split (4 int64 a pair): the NN
# sweep up to the barrier after the matches, the IRLS loop, the scalar
# tail up to its barrier, and the whole call.  Per design of the kernels:
# (the stamped file, the stamping thread, its pair, (anchor, code
# inserted after it), ...); every anchor occurs once.
_SPLIT_PRELUDE = """#include <cuda_runtime.h>
__device__ long long icp_split[4 * 8192];
extern "C" int icp_split_copy(long long* to, int n) {
  return (int)cudaMemcpyFromSymbol(to, icp_split, n * sizeof(long long), 0,
                                   cudaMemcpyDeviceToDevice);
}
extern "C" int icp_split_zero(int n) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, icp_split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, n * sizeof(long long));
}
"""
_SPLIT_PAIRS_MAX = 8192


def _split_add(who: str, pair: str) -> str:
    return (f"    if ({who}) {{\n"
            f"      long long* acc = icp_split + 4 * ({pair});\n"
            "      acc[0] += t_nn - t_top;\n"
            "      acc[1] += t_irls - t_nn;\n"
            "      acc[2] += clock64() - t_irls;\n"
            "    }\n")


def _split_total(pair: str) -> str:
    return f"    icp_split[4 * ({pair}) + 3] = clock64() - t_start;\n"


_SPLIT_STAMPS = {
    # One block a pair (frame.cuh, the earlier body of kernels 3 and 10).
    "one-block": ("frame.cuh", "threadIdx.x == 0", "blockIdx.x", (
        ("  const int tid = threadIdx.x;\n",
         "  const long long t_start = clock64();\n"),
        ("  while (fs.it < outer_iters && fs.done == 0) {\n",
         "    const long long t_top = clock64();\n"),
        ("      mdy[i] = ddy[bi];\n    }\n    __syncthreads();\n",
         "    const long long t_nn = clock64();\n"),
        ("    irls_loop(stx, sty, mdx, mdy, mk, n, rx, ry, P, fs.sh, d);\n",
         "    const long long t_irls = clock64();\n"),
        ("      fs.done = isid ? 1 : 0;\n    }\n    __syncthreads();\n",
         "ADD"),
        ("    out[7] = (float)fs.inner;\n", "TOTAL"))),
    # Kernel 3 on a cluster, its own body (icp2d_frame.cu before
    # frame_cluster.cuh).
    "cluster": ("icp2d_frame.cu", "threadIdx.x == 0 && rank == 0", "0", (
        ("  const int tid = threadIdx.x;\n",
         "  const long long t_start = clock64();\n"),
        ("  while (fs.it < outer_iters && fs.done == 0) {\n",
         "    const long long t_top = clock64();\n"
         "    long long t_irls = 0;\n"),
        ("    cluster.sync();  // the matches are in the leader\n",
         "    const long long t_nn = clock64();\n"),
        ("      irls_loop(stx, sty, mdx, mdy, mk, n, rx, ry, P, fs.sh, d);\n",
         "      t_irls = clock64();\n"),
        ("    cluster.sync();  // T and the exit are in every block\n",
         "ADD"),
        ("    out[7] = (float)fs.inner;\n", "TOTAL"))),
    # Kernels 3 and 10 on frame_cluster.cuh's body, a cluster a pair.
    "shared": ("frame_cluster.cuh", "threadIdx.x == 0 && rank == 0", "pair", (
        ("  const int tid = threadIdx.x;\n",
         "  const long long t_start = clock64();\n"),
        ("  while (fs.it < outer_iters && fs.done == 0) {\n",
         "    const long long t_top = clock64();\n"
         "    long long t_irls = 0;\n"),
        ("    cluster.sync();  // the matches are in the leader\n",
         "    const long long t_nn = clock64();\n"),
        ("      irls_loop(stx, sty, mdx, mdy, mk, fs.n_eff, rx, ry, P, fs.sh,"
         " d);\n",
         "      t_irls = clock64();\n"),
        ("    cluster.sync();  // T and the exit are in every block\n",
         "ADD"),
        ("    o[7] = (float)fs.inner;\n", "TOTAL"))),
}


def _split_design(kernel: str) -> str:
    """Which body of ``_SPLIT_STAMPS`` the tree's ``kernel`` (icp2d_frame
    or icp2d_frame_pairs) runs."""
    src = (cuda_build.CSRC / f"{kernel}.cu").read_text()
    if '"frame_cluster.cuh"' in src:
        return "shared"
    if '"frame.cuh"' in src or "icp2d_frame_block(" in src:
        return "one-block"
    return "cluster"


def _stamped_library(kernel: str, tag: str, fname: str, stamps,
                     prelude: str, entries):
    """A copy of ``kernel``'s library with ``stamps`` ((anchor, code
    inserted after it), each anchor once) in its source ``fname`` and
    ``prelude`` before its main file, built once per process under
    _build/<tag>/<kernel>: (its launch entry, {name: the C entry point of
    ``entries``, {name: argument types}})."""
    out_dir = cuda_build.BUILD_DIR / tag / kernel
    lib = out_dir / f"lib{kernel}_{tag}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        main = f"{kernel}.cu"
        files = {main: (cuda_build.CSRC / main).read_text()}
        # The headers that the stamped file includes come from out_dir.
        for name in (*cuda_build.HEADERS, fname):
            if (cuda_build.CSRC / name).exists():
                files.setdefault(name, (cuda_build.CSRC / name).read_text())
        text = files[fname]
        for anchor, code in stamps:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{tag}: {anchor!r} is not in {fname} "
                                   "once")
            text = text.replace(anchor, anchor + code)
        files[fname] = text
        files[main] = prelude + files[main]
        for name, body in files.items():
            (out_dir / name).write_text(body)
        subprocess.run([cuda_build._nvcc(), *cuda_build.FLAGS, "-I",
                        str(out_dir), "-I", str(cuda_build.CSRC), "-o",
                        str(lib), str(out_dir / main)],
                       check=True, capture_output=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    entry, argtypes = cuda_build._SIGNATURES[kernel]
    fn = getattr(dll, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    got = {}
    for name, types in entries.items():
        got[name] = getattr(dll, name)
        got[name].argtypes, got[name].restype = types, ctypes.c_int
    return fn, got


def _split_library(kernel: str):
    """The stamped copy of ``kernel``'s library, built once per process:
    (its launch entry, icp_split_zero, icp_split_copy, the design)."""
    design = _split_design(kernel)
    fname, who, pair, stamps = _SPLIT_STAMPS[design]
    stamps = [(anchor, {"ADD": _split_add(who, pair),
                        "TOTAL": _split_total(pair)}.get(code, code))
              for anchor, code in stamps]
    fn, got = _stamped_library(
        kernel, "split", fname, stamps, _SPLIT_PRELUDE,
        {"icp_split_zero": [ctypes.c_int],
         "icp_split_copy": [ctypes.c_void_p, ctypes.c_int]})
    return fn, got["icp_split_zero"], got["icp_split_copy"], design


# A frame kernel's record of one pair's outer iterations (``frame_trace``):
# a copy of frame_cluster.cuh into whose leader block of the traced pair
# every thread writes, each outer iteration, the IRLS loop's inputs (the
# transformed src rows and their matched dst points) and thread 0 the
# transform they were swept at and the loop's result.
_TRACE_ITERS = 32
_TRACE_PRELUDE = f"""#include <cuda_runtime.h>
__device__ int icp_trace_pair = -1;
__device__ float icp_trace_pts[{_TRACE_ITERS}][4][1536];
__device__ float icp_trace_t[{_TRACE_ITERS}][16];
extern "C" int icp_trace_set(int pair) {{
  return (int)cudaMemcpyToSymbol(icp_trace_pair, &pair, sizeof(int));
}}
extern "C" int icp_trace_copy(float* pts, float* t) {{
  cudaError_t e = cudaMemcpyFromSymbol(pts, icp_trace_pts,
                                       sizeof(icp_trace_pts), 0,
                                       cudaMemcpyDeviceToDevice);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(t, icp_trace_t, sizeof(icp_trace_t), 0,
                                   cudaMemcpyDeviceToDevice);
}}
"""
_TRACE_STAMPS = (
    ("    cluster.sync();  // the matches are in the leader\n",
     f"    if (rank == 0 && (int)pair == icp_trace_pair\n"
     f"        && fs.it < {_TRACE_ITERS}) {{\n"
     "      for (int i = tid; i < fs.n_eff; i += T) {\n"
     "        icp_trace_pts[fs.it][0][i] = stx[i];\n"
     "        icp_trace_pts[fs.it][1][i] = sty[i];\n"
     "        icp_trace_pts[fs.it][2][i] = mdx[i];\n"
     "        icp_trace_pts[fs.it][3][i] = mdy[i];\n"
     "      }\n"
     "      if (tid == 0) {\n"
     "        for (int k = 0; k < 6; ++k) icp_trace_t[fs.it][k] = Tm[k];\n"
     "        icp_trace_t[fs.it][15] = (float)fs.n_eff;\n"
     "      }\n"
     "    }\n"),
    ("      irls_loop(stx, sty, mdx, mdy, mk, fs.n_eff, rx, ry, P, fs.sh, d);"
     "\n",
     f"      if ((int)pair == icp_trace_pair && tid == 0\n"
     f"          && fs.it < {_TRACE_ITERS}) {{\n"
     "        for (int k = 0; k < 7; ++k) icp_trace_t[fs.it][6 + k] = d[k];\n"
     "      }\n"))


def frame_trace(device, kernel: str, args, pair: int, shape=None):
    """Kernel 3 or 10 (on frame_cluster.cuh) on ``args`` (the wrapper's;
    ``shape``: kernel 10's (blocks a pair, threads a block), by default
    the wrapper's), with the outer iterations of pair ``pair`` recorded,
    held against its plain version layer by layer: at each outer
    iteration the kernel's own transform T, its matches against the plain
    NN of its own transformed rows (float32) and against the exact NN
    (float64 at T), and its IRLS result against the plain loop, float32
    and float64, on its own inputs; and T against the plain outer loop's,
    float32 and float64.  Returns a list of per-outer-iteration dicts."""
    fn, got = _stamped_library(
        kernel, "trace", "frame_cluster.cuh", _TRACE_STAMPS, _TRACE_PRELUDE,
        {"icp_trace_set": [ctypes.c_int],
         "icp_trace_copy": [ctypes.c_void_p, ctypes.c_void_p]})
    sp, dp, sm, dm, t0, cfg = args
    one = (slice(None),) if sp.ndim == 2 else (pair,)
    src, dst, smask, dmask = sp[one], dp[one], sm[one], dm[one]
    _, largs, out, keep = align2d_cuda._icp2d_frame_args(*args, shape=shape)
    pts = torch.zeros((_TRACE_ITERS, 4, 1536), dtype=torch.float32,
                      device=device)
    rec = torch.zeros((_TRACE_ITERS, 16), dtype=torch.float32,
                      device=device)
    cuda_build.check(got["icp_trace_set"](pair if sp.ndim == 3 else 0),
                     "frame_trace set")
    cuda_build.check(fn(*largs), f"{kernel} (traced)")
    _sync(device)
    cuda_build.check(got["icp_trace_copy"](pts.data_ptr(), rec.data_ptr()),
                     "frame_trace copy")
    _sync(device)
    o = out.reshape(-1, 8)[pair if sp.ndim == 3 else 0]
    del keep
    # The plain outer loop's transforms, float32 and float64.
    plain_t = {}
    for dt in (torch.float32, torch.float64):
        calls, undo = _capture_calls(align2d, "estimate_transform")
        try:
            tu = RigidTransform2(t0.rot[one].to(dt), t0.t[one].to(dt))
            m_icp.icp2d_frame_plain(src.to(dt), dst.to(dt), smask,
                                    dmask, tu, cfg)
        finally:
            undo()
        plain_t[dt] = calls
    s = cfg.point_scale
    solver = (cfg.huber_k / s, cfg.det_rel_eps, cfg.inner_delta_sq_tol,
              cfg.inner_max_iter, s)
    rows = []
    for it in range(int(o[6])):
        n = int(rec[it, 15])
        tk = rec[it, :6].double()
        stx = pts[it, :2, :n].T.contiguous()
        mk = pts[it, 2:, :n].T.contiguous()
        mask = smask[:n]
        valid = mask.nonzero().flatten()
        # The plain NN of the kernel's own rows, float32.
        nn32 = nn_torch(stx, dst, dmask, tile=dst.shape[0])
        m32 = dst[nn32.index]
        # The exact NN at the kernel's T.
        rot64 = tk[:4].reshape(2, 2)
        q64 = src[:n].double() @ rot64.T + tk[4:6]
        nn64 = nn_torch(q64, dst.double(), dmask, tile=dst.shape[0])
        m64 = dst.double()[nn64.index]
        d32 = torch.any(m32[valid] != mk[valid], dim=-1)
        d64 = torch.any(m64[valid] != mk[valid].double(), dim=-1)
        # Each row whose match is not the exact one: its query's squared
        # distance to the kernel's match above that to the exact match, in
        # float64 at T, and in float32 ulps of the latter.
        ties = []
        for r in valid[d64].tolist()[:8]:
            dk = float(((q64[r] - mk[r].double()) ** 2).sum())
            de = float(((q64[r] - m64[r]) ** 2).sum())
            ulp = float(np.spacing(np.float32(de)))
            ties.append(dict(row=r, exact_d2=de, excess=dk - de,
                             excess_ulps=(dk - de) / ulp))
        # The plain loop on the kernel's own inputs.
        loop = {}
        for dt in (torch.float32, torch.float64):
            r_p, t_p, i_p = align2d_cuda.irls_loop_plain(
                stx.to(dt), mk.to(dt), mask, *solver)
            loop[dt] = (torch.cat([r_p.reshape(4), t_p]).double(), int(i_p))
        dk = rec[it, 6:12].double()
        row = dict(outer=it, inner=int(rec[it, 12]),
                   matches_differ_plain32=int(d32.sum()),
                   matches_differ_exact=int(d64.sum()),
                   near_ties=ties,
                   loop_vs_plain32=float((dk - loop[torch.float32][0]).abs()
                                         .max()),
                   inner_plain32=loop[torch.float32][1],
                   loop_vs_plain64=float((dk - loop[torch.float64][0]).abs()
                                         .max()),
                   inner_plain64=loop[torch.float64][1])
        for dt, name in ((torch.float32, "32"), (torch.float64, "64")):
            if it < len(plain_t[dt]):
                # The plain loop's transformed rows at this outer iteration
                # against the kernel's.
                row[f"rows_vs_plain{name}"] = float(
                    (plain_t[dt][it][0].double() - stx.double()).abs().max())
        rows.append(row)
        print(f"# frame trace {kernel} pair {pair} outer {it}: {row}")
    return rows


def frame_split(device, kernel: str = "icp2d_frame", inputs=None,
                reps: int = 20):
    """A frame kernel's split of an outer iteration on the tree's design,
    at ``inputs`` ({shape: the wrapper's arguments}; kernel 3 by default
    at ``frame_inputs``' pairs): per pair the cycles of the NN sweep, the
    IRLS loop and the scalar tail (``_SPLIT_STAMPS``) over its outer
    iterations.  Reports the slowest pair's (the most cycles in all) per
    outer iteration, in cycles and in us as their share of the stamped
    kernel's launcher-alone time (the slowest pair's chain taken as the
    launch), the mean over pairs per outer iteration in cycles, and the
    spread of outer iterations.  Empty on the CPU."""
    if torch.device(device).type != "cuda":
        return {}
    fn, zero, copy, design = _split_library(kernel)
    if inputs is None:
        cfg = _config()
        t0 = RigidTransform2.identity(dtype=torch.float32, device=device)
        inputs = {shape: (sp, dp, sm, dm, t0, cfg) for shape, (sp, sm, dp, dm)
                  in frame_inputs(device).items()}
    res = {"design": design}
    for shape, args in inputs.items():
        _, largs, out, keep = align2d_cuda._icp2d_frame_args(*args)
        b = out.shape[0] if out.ndim == 2 else 1
        if b > _SPLIT_PAIRS_MAX:
            raise RuntimeError(f"frame_split: more than {_SPLIT_PAIRS_MAX} "
                               "pairs")
        ms = launcher_ms(kernel, largs, device, reps=reps, fn=fn)
        cuda_build.check(zero(4 * b), "frame_split zero")
        cuda_build.check(fn(*largs), f"{kernel} (stamped)")
        _sync(device)
        acc = torch.empty((b, 4), dtype=torch.int64, device=device)
        cuda_build.check(copy(acc.data_ptr(), 4 * b), "frame_split copy")
        _sync(device)
        acc = acc.cpu().double()
        outer = out.reshape(b, 8)[:, 6].double().cpu()
        slow = int(torch.argmax(acc[:, 3]))
        parts = ("nn", "irls", "tail")
        cyc = {k: float(acc[slow, i] / outer[slow])
               for i, k in enumerate(parts)}
        us = {k: float(acc[slow, i] / acc[slow, 3]) * ms * 1e3
              / float(outer[slow]) for i, k in enumerate(parts)}
        mean = {k: float((acc[:, i] / outer.clamp(min=1)).mean())
                for i, k in enumerate(parts)}
        spread = torch.bincount(outer.long()).tolist()
        res[shape] = dict(pairs=b, stamped_ms=ms,
                          slowest_outer=int(outer[slow]),
                          slowest_call_cycles=float(acc[slow, 3]),
                          cycles_per_iteration=cyc, us_per_iteration=us,
                          mean_cycles_per_iteration=mean,
                          pairs_by_outer=spread)
        del keep
        print(f"# frame split {kernel} {design} {shape}: {b} pairs, stamped "
              f"call {ms} ms; slowest pair {int(outer[slow])} outer "
              f"iterations, {float(acc[slow, 3]):.0f} cycles; its per outer "
              f"iteration: cycles {cyc}, us {us}; mean cycles per outer "
              f"iteration over pairs {mean}; pairs by outer iterations "
              f"{spread}")
    return res


def _submap_2d_matched_call(device):
    """Kernel 4's arguments of the last call of the fused wall-world run
    (phase 20), captured."""
    walls, _ = walls_sequence()
    calls, undo = _capture_calls(nn_sweep_cuda, "nn_matched")
    try:
        _run_submap(walls, np.ones(walls.shape[:2], bool), _config(), device,
                    with_metrics=False, fused=True, **SUBMAP_2D_KW)
    finally:
        undo()
    return calls[-1]


def phase_matched_submap_2d(device="cuda"):
    """Kernel 4 on the last call of the fused wall-world run (phase 20),
    captured: bitwise equal to its plain version and to its schedule's
    emulation; timed and bounded as in phase 14."""
    args = _submap_2d_matched_call(device)
    got = nn_sweep_cuda.nn_matched(*args)
    want = nn_sweep_cuda.nn_matched_plain(*args)
    _sync(device)
    what = "nn_matched submap-2d"
    _equal_or_raise(got, want, what)
    items = _matched_emulation(got, *args, what)
    query_p, dbf_cm, d_dim = args
    n = int(torch.any(query_p != 0, dim=-1).sum())
    valid = float((dbf_cm[..., 0, :] < nn_cuda._SENTINEL / 2).sum())
    print(f"# {what}: bitwise equal to its plain version; {n} of "
          f"{query_p.shape[-2]} query rows x {dbf_cm.shape[-1]} db rows "
          f"({int(valid)} valid){items}")
    case = dict(kind="nn_matched", fn=nn_sweep_cuda.nn_matched,
                plain=nn_sweep_cuda.nn_matched_plain, args=args, n=n,
                valid=valid, out=got)
    return _sweep_record(case, "submap-2d", device, 0.0)


def _slam2d_wide_irls_calls(device, wide_frames: int = 12,
                            wide_stride: int = 1):
    """Kernel 7's arguments of every call of run_slam2d on the xy of
    ``wide_frames`` full frames (phase 17's wide scans), captured."""
    frames, _ = io.synthesize_frames3d(wide_frames, seed=4)
    wide = [f[::wide_stride, :2] for f in frames]
    calls, undo = _capture_calls(align2d_cuda, "irls_loop_batched")
    try:
        _run_slam(run_slam2d, wide, _config(), device, loop_radius=1.0,
                  min_gap=8)
    finally:
        undo()
    return calls


def pairs_list_inputs(device, scans):
    """Kernel 9's arguments at every shape its paths give it: {path: list
    of calls}.  Every call of one run of the batched path (phase 9) and of
    run_slam2d on the same scans (phase 17), captured, and phase 6's
    db-4096 case with tight bounds."""
    out = {}
    pts, mask = scans[:2]
    for path, run in (
            ("batched", lambda: _run_batched(
                _batch(device, scans=scans), _config(), device)),
            ("slam2d", lambda: _run_slam(
                run_slam2d, [p[m] for p, m in zip(pts, mask)], _config(),
                device, loop_radius=1.5, min_gap=20))):
        calls, undo = _capture_calls(nn_pairs_cuda, "nn_pairs_list")
        try:
            run()
        finally:
            undo()
        out[path] = calls
    q_b, db_b, dm_b = _big_db_case(device)
    eps = torch.finfo(torch.float32).eps
    qb = nn_torch(q_b, db_b, dm_b, tile=db_b.shape[1]).dist_sq \
        * (1.0 + 32.0 * eps)
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(q_b, db_b, dm_b, db_b,
                                                     qb)
    lists, cnt = nn_pairs_cuda._survivor_lists(
        query_p, cbox, qb_p, 2, nn_pairs_cuda.Q_SUB, nn_pairs_cuda.LIST_GRP)
    args = (query_p, dbf, lists, cnt, 2, nn_pairs_cuda.Q_SUB)
    if hasattr(nn_pairs_cuda, "group_walks"):
        args += (qb_p, cbox)
    out["db-4096"] = [args]
    return out


def _pairs_list_times(calls, device, reps: int = 20):
    """Kernel 9 on every call of one path by its launcher alone, each
    bitwise equal to its plain version, and, where the tree has them, at
    every schedule of ``_list_schedules`` summed over the calls."""
    per_call, by_sched, walks, pairs = [], {}, 0, 0
    for args in calls:
        res = nn_pairs_cuda._nn_pairs_list_args(*args)
        largs, out = res[0], res[1]
        per_call.append(launcher_ms("nn_pairs_list", largs, device,
                                    reps=reps))
        _sync(device)
        want = nn_pairs_cuda.nn_pairs_list_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise RuntimeError("nn_pairs_list differs from its plain version")
        if hasattr(nn_pairs_cuda, "list_schedule"):
            for key, ms in _list_schedules(args, out, device, reps)[0].items():
                by_sched[key] = by_sched.get(key, 0.0) + ms
        walks += int(args[3].sum())
        if hasattr(nn_pairs_cuda, "group_walks"):
            pairs += nn_pairs_cuda.group_walks(*args)
        del res
    return dict(calls=len(calls), sum_ms=sum(per_call), ms=per_call,
                chunk_walks=walks, pairs=pairs, schedules_sum_ms=by_sched)


def big_frame_pairs(device, big: int = 64,
                    n_max: int = align2d_cuda.FRAME_MAX_POINTS):
    """``big`` consecutive pairs of synthetic frames (``synthesize_frames3d
    (big + 1, seed=7)``), the xy of each subsampled to ``n_max`` seeded
    points (FRAME_MAX_POINTS): (src, dst, src mask, dst mask), (big, n_max,
    ...) each."""
    frames, _ = io.synthesize_frames3d(big + 1, seed=7)
    rng = np.random.default_rng(7)
    xy = np.stack([f[rng.choice(len(f), n_max, replace=False), :2]
                   for f in frames])
    p = torch.as_tensor(xy, dtype=torch.float32, device=device)
    ones = torch.ones(p.shape[:2], dtype=torch.bool, device=device)
    return p[:-1], p[1:], ones[:-1], ones[1:]


def frame_pairs_inputs(device, scans, big: int = 64,
                       n_max: int = align2d_cuda.FRAME_MAX_POINTS):
    """Kernel 10's arguments: {shape: (src, dst, src mask, dst mask, t0,
    config)} at the batched path's 209 unsorted pairs of 768, at
    ``big_frame_pairs``' ``big`` pairs of ``n_max`` points, and at one pair
    of each (B = 1)."""
    cfg = _config()
    src, smask, dst, dmask = _batch(device, scans=scans)
    sp, dp, sm, dm = big_frame_pairs(device, big, n_max)
    out = {}
    for shape, (sp, sm, dp, dm) in (
            (f"{src.shape[0]}x{src.shape[1]}", (src, smask, dst, dmask)),
            (f"{big}x{n_max}", (sp, sm, dp, dm))):
        for b in (sp.shape[0], 1):
            t0 = RigidTransform2.identity((b,), dtype=torch.float32,
                                          device=device)
            out[f"{b}x{sp.shape[1]}"] = (sp[:b], dp[:b], sm[:b], dm[:b], t0,
                                         cfg)
    return out


def pairs_cold_inputs(device, scans):
    """Kernel 8's arguments at the batched path's cold call (phase 6's
    cold case: +inf bounds, Morton-sorted pairs), and kernel 9's on the
    same case (every chunk listed)."""
    src, _, dst, dmask = _batch(device, scans=scans, sort=True)
    q_sub = nn_pairs_cuda.Q_SUB
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(src, dst, dmask, dst,
                                                     None, q_sub)
    args8 = (query_p, dbf, nn_pairs_cuda._query_boxes(query_p, q_sub), cbox,
             nn_pairs_cuda._group_bounds(qb_p, q_sub), 2, q_sub)
    lists, cnt = nn_pairs_cuda._survivor_lists(
        query_p, cbox, qb_p, 2, q_sub, nn_pairs_cuda.LIST_GRP)
    args9 = (query_p, dbf, lists, cnt, 2, q_sub)
    if hasattr(nn_pairs_cuda, "group_walks"):
        args9 += (qb_p, cbox)
    return args8, args9


def _pairs_cold_times(device, args8, args9=None, reps: int = 20):
    """Kernel 8 on a cold call ``args8`` by its launcher alone, bitwise
    equal to its plain version, at its wrapper's schedule and, where the
    tree has them, at every schedule of ``_pairs_schedules``; beside
    kernel 9 on the same case (``args9``, when given) and kernel 8's issue
    floor (its (query, point) pairs at NN_INSTR_PER_PAIR instructions and
    the card's float32 instruction rate)."""
    res = nn_pairs_cuda._nn_pairs_args(*args8)
    ms = launcher_ms("nn_pairs", res[0], device, reps=reps)
    _sync(device)
    out = res[1]
    _equal_or_raise(out, nn_pairs_cuda.nn_pairs_plain(*args8),
                    "nn_pairs cold")
    schedules, key = _pairs_schedules(args8, out, device, reps)
    ms9 = None
    if args9 is not None:
        largs9, _out9, keep9 = nn_pairs_cuda._nn_pairs_list_args(*args9)[:3]
        ms9 = launcher_ms("nn_pairs_list", largs9, device, reps=reps)
        del keep9
    del res
    query_p, _, qbox, cbox, gb, d_dim, q_sub = args8
    walked = int((nn_pairs_cuda._box_lower_bound(qbox, cbox, d_dim)
                  <= gb[..., None]).sum())
    pairs = walked * q_sub * 128
    return dict(ms=ms, schedule=key, schedules_ms=schedules,
                list_cold_ms=ms9, pairs=pairs,
                issue_floor_ms=pairs * NN_INSTR_PER_PAIR[d_dim]
                / PEAK_F32_INSTR_PER_S * 1e3)


def kernel_times(device="cuda", reps: int = 20):
    """Kernels 12, 14, 13, 3, 8, 9 and 10 by their launchers alone at every
    shape their paths give them, each call held against its plain version:
    kernels 12 and 14 at their phases' 28,800 points and at 3,072 and
    1,000 on every cluster size where the tree has them (the stats gates,
    ``_stats_times``); kernel 13 at ``gn_batched_inputs`` on every route
    where the tree has them (the stats gates, ``_gn_batched_routes``);
    kernel 8 at the cold batched call at every schedule where the tree has
    them (bitwise, ``_pairs_cold_times``); kernel 3 at ``frame_inputs``'
    pairs and at 128-1,024 points on every cluster size (max |diff| of
    rot/t, outer
    iterations); kernel 9 on every call of the batched path and of SLAM 2D
    and at the db-4096 case (``pairs_list_inputs``), at every schedule
    where the tree has them (bitwise); kernel 10 at ``frame_pairs_inputs``
    on every setting the card holds at once where the tree has them; and
    the two frame kernels' splits (``frame_split``).  Prints the times as
    one JSON line, then holds kernel 10 at every shape to ``frame_gate``
    (``_frame_pairs_check``, ``_frame_pairs_hold``), raising at the first
    pair that fails it."""
    card = torch.device(device).type == "cuda"
    times = {"icp2d_frame": {}, "nn_pairs_list": {}, "icp2d_frame_pairs": {}}
    src, matched, smask, _, warm = _gn_stats_inputs(device)
    times["gn_stats"] = _stats_times(
        "gn_stats", (src, matched, smask, warm.rot, warm.t,
                     _config().huber_k), device)
    src, matched, m_n, mask, _, warm = _p2l_stats_inputs(device)
    times["p2l_stats"] = _stats_times(
        "p2l_stats", (src, matched, m_n, mask, warm.rot, warm.t,
                      _config().huber_k), device)
    times["gn_stats_batched"] = {}
    for shape, args in gn_batched_inputs(device).items():
        by_route, chosen = _gn_batched_routes(args, device)
        times["gn_stats_batched"][shape] = dict(route=chosen,
                                                routes_ms=by_route)
        print(f"# times gn_stats_batched {shape}: launcher alone on route "
              f"{chosen} {by_route[chosen]} ms (by route {by_route})")
    for shape, pair in frame_inputs(device).items():
        rec = times["icp2d_frame"][shape] = _frame_times(pair, device, reps)
        print(f"# times icp2d_frame {shape}: launcher alone {rec['ms']} ms "
              f"(clusters {rec['cluster_ms']}); vs plain max |diff| "
              f"{rec['max_abs_err']:.3e}, outer iterations {rec['outer']} "
              f"(plain {rec['outer_plain']}), inner {rec['inner']}")
    # Smaller pairs, for the cluster rule.
    for n in (128, 256, 384, 512, 1024):
        rec = _frame_times(pair2d(device, n, n), device, reps)
        times["icp2d_frame"][f"{n}x{n}"] = rec
        print(f"# times icp2d_frame {n}x{n}: launcher alone {rec['ms']} ms "
              f"(clusters {rec['cluster_ms']})")
    times["icp2d_frame_split"] = frame_split(device, reps=reps)
    scans = scans2d()
    rec = times["nn_pairs"] = _pairs_cold_times(
        device, *pairs_cold_inputs(device, scans), reps=reps)
    print(f"# times nn_pairs cold: launcher alone {rec['ms']} ms at "
          f"schedule {rec['schedule']} (by schedule {rec['schedules_ms']}), "
          f"bitwise equal to plain; nn_pairs_list on the same case "
          f"{rec['list_cold_ms']} ms; issue floor {rec['issue_floor_ms']} "
          f"ms for {rec['pairs']} (query, point) pairs")
    list_inputs = pairs_list_inputs(device, scans)
    if 4 in getattr(nn_pairs_cuda, "_PAYLOADS", ()):
        # The batched p2l room pairs (phase 25(b)): D 3, the 4-lane payload.
        p2l_calls = p2l_pairs_inputs(device)
        rec = times["nn_pairs_p2l"] = _pairs_cold_times(
            device, p2l_calls["nn_pairs"][0], reps=reps)
        print(f"# times nn_pairs batched-p2l-room cold (D 3, P 4): launcher "
              f"alone {rec['ms']} ms at schedule {rec['schedule']} (by "
              f"schedule {rec['schedules_ms']}), bitwise equal to plain; "
              f"issue floor {rec['issue_floor_ms']} ms for {rec['pairs']} "
              f"(query, point) pairs")
        list_inputs["batched-p2l-room"] = p2l_calls["nn_pairs_list"]
    for path, calls in list_inputs.items():
        rec = times["nn_pairs_list"][path] = _pairs_list_times(calls, device,
                                                                reps)
        print(f"# times nn_pairs_list {path}: {rec['calls']} calls, "
              f"{rec['chunk_walks']} chunk-walks ({rec['pairs']} (query, "
              f"point) pairs swept), launcher alone sum "
              f"{rec['sum_ms']} ms, bitwise equal to plain (calls "
              f"{rec['ms']}); by schedule, summed {rec['schedules_sum_ms']}")
    inputs = frame_pairs_inputs(device, scans)
    held = {}
    for shape, args in inputs.items():
        ms, by_shape, chosen, ref, outs = _frame_pairs_settings(args, device)
        held[shape] = (ref, outs)
        its = ref[:, 6].to(torch.int64).cpu()
        times["icp2d_frame_pairs"][shape] = dict(
            ms=ms, outer=its.tolist() if len(its) <= 16
            else torch.bincount(its).tolist(), setting=chosen,
            setting_ms=by_shape)
        print(f"# times icp2d_frame_pairs {shape}: launcher alone {ms} ms "
              f"on setting {chosen} (by setting {by_shape})")
    times["icp2d_frame_pairs_split"] = frame_split(
        device, "icp2d_frame_pairs", {k: v for k, v in inputs.items()
                                      if not k.startswith("1x")}, reps=reps)
    print(json.dumps({"kernel_times": times, "card": _card() if card
                      else None}))
    for shape, args in inputs.items():
        _, _, plain = _frame_pairs_check(args, shape)
        _frame_pairs_hold(args, plain, *held[shape])
        print(f"# times icp2d_frame_pairs {shape}: every setting held to "
              "the gate (within FRAME_TOL of plain, or of plain with one "
              "near tie taken the other way at an exact fixed point of its "
              "outer step), equal outer iterations")
    return times


# ----------------------------------------------------------------------
# Phases 25-27: batched point-to-plane ICP, nn_method="mxu", the grid hash.


def _pair_diff3(a: RigidTransform3, b: RigidTransform3):
    """Per pair: (the larger of |t_a - t_b| in xy and |R_a - R_b| (max
    entry), |t_a - t_b| in z)."""
    dxy = torch.linalg.norm(a.t[..., :2] - b.t[..., :2], dim=-1)
    dr = torch.amax(torch.abs(a.rot - b.rot), dim=(-2, -1))
    return torch.maximum(dxy, dr), torch.abs(a.t[..., 2] - b.t[..., 2])


def _pick(t: RigidTransform3, k) -> RigidTransform3:
    return RigidTransform3(t.rot[k], t.t[k])


def _run_p2l_batched(src, smask, dst, dmask, t0, cfg, device, voxel):
    """One timed batched ``icp_point_to_plane`` call with stats, the launch
    counts zeroed just before it; returns (transforms, stats, seconds,
    launches)."""
    _sync(device)
    cuda_build.reset_launches()
    start = time.perf_counter()
    t, stats = m_p2l.icp_point_to_plane(src, dst, smask, dmask, t0, cfg,
                                        normals_voxel_size=voxel,
                                        return_stats=True, device=device)
    _sync(device)
    return t, stats, time.perf_counter() - start, dict(cuda_build.LAUNCHES)


def _p2l_batched_case(name, batch, t0, gt, cfg, device, voxel,
                      plain_pairs: int, routes: dict, capture=(),
                      z_tol: float = PLAIN_GATE_M):
    """The batched p2l gates on pairs ``batch`` = (src, smask, dst, dmask)
    (B, N, 3) from warm starts ``t0`` against ground truth ``gt``
    (RigidTransform3, (B,)): a warm-up call (capturing the calls named in
    ``capture`` = ((module, name, limit), ...) as ``_capture_calls``
    does), a timed one; each pair's translation error < ATE_GATE_M; each
    within PLAIN_GATE_M in xy and rotation, and ``z_tol`` in z, of the
    single-pair call on it; the first ``plain_pairs`` within PLAIN_GATE_M
    in every DoF of the batched plain route (no launch); on the card the
    launches of ``routes`` = {kernel: "K" | "K-1" | 1}, K the outer
    iterations, and none of any other kernel.  Returns the run's
    record."""
    src, smask, dst, dmask = batch
    n_pairs = src.shape[0]
    captured, undo = {}, []
    for module, fn, limit in capture:
        captured[fn], u = _capture_calls(module, fn, limit)
        undo.append(u)
    try:
        _, _, first_sec, _ = _run_p2l_batched(src, smask, dst, dmask, t0,
                                              cfg, device, voxel)
    finally:
        for u in undo:
            u()
    out, stats, sec, launches = _run_p2l_batched(src, smask, dst, dmask, t0,
                                                 cfg, device, voxel)
    k = int(stats.outer_iters[0])
    e_t = torch.linalg.norm(out.t - gt.t, dim=-1).double().cpu().numpy()
    e_r = torch.amax(torch.abs(out.rot - gt.rot), dim=(-2, -1)).cpu().numpy()
    z_max = float(torch.max(torch.abs(out.t[:, 2])))
    pps = n_pairs / sec
    print(f"# {name}: {n_pairs} pairs of {src.shape[1]} points "
          f"({int(smask.sum(1).min())}-{int(smask.sum(1).max())} valid), "
          f"{sec:.4f} s, {pps:.2f} pairs/s (host clock, synchronised; "
          f"first run {first_sec:.4f} s); error vs ground truth per pair: "
          f"t max {e_t.max():.6f} m median {np.median(e_t):.6f} m, rot max "
          f"{e_r.max():.3e}; max |t_z| {z_max:.6f} m; outer iterations {k}; "
          f"launches {_nonzero(launches)}")
    if not e_t.max() < ATE_GATE_M:
        raise RuntimeError(f"{name}: translation error {e_t.max()} >= "
                           f"{ATE_GATE_M}")
    if torch.device(device).type == "cuda":
        want = {n: 0 for n in launches}
        want.update({n: {"K": k, "K-1": k - 1}.get(c, c)
                     for n, c in routes.items()})
        if launches != want:
            raise RuntimeError(f"{name}: launches {launches}, expected "
                               f"{_nonzero(want)}")
    single = []
    for i in range(n_pairs):
        single.append(m_p2l.icp_point_to_plane(
            src[i], dst[i], smask[i], dmask[i], _pick(t0, i), cfg,
            normals_voxel_size=voxel, device=device))
    single = RigidTransform3(torch.stack([t.rot for t in single]),
                             torch.stack([t.t for t in single]))
    d_single = [float(torch.max(d)) for d in _pair_diff3(out, single)]
    p = plain_pairs
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    p_out, _, p_sec, p_launch = _run_p2l_batched(
        src[:p], smask[:p], dst[:p], dmask[:p], _pick(t0, slice(0, p)),
        plain_cfg, device, voxel)
    d_plain = [float(torch.max(d))
               for d in _pair_diff3(_pick(out, slice(0, p)), p_out)]
    print(f"# {name}: max per-pair difference (xy and rotation; z) from "
          f"{n_pairs} single-pair calls {d_single[0]:.3e}; {d_single[1]:.3e} "
          f"m (gates {PLAIN_GATE_M}; {z_tol} m), from the batched plain "
          f"route on the first {p} pairs ({p_sec:.3f} s) {d_plain[0]:.3e}; "
          f"{d_plain[1]:.3e} m (gates {PLAIN_GATE_M}; {PLAIN_GATE_M} m)")
    if any(p_launch.values()):
        raise RuntimeError(f"{name}: the plain route launched {p_launch}")
    for (d, dz), what, gate_z in ((d_single, "single-pair calls", z_tol),
                                  (d_plain, "the plain route", PLAIN_GATE_M)):
        if not (d < PLAIN_GATE_M and dz < gate_z):
            raise RuntimeError(f"{name}: batched vs {what} {d}, z {dz}")
    return dict(launches=launches, pairs_per_s=pps, seconds=sec, outer=k,
                max_t_err=float(e_t.max()), z_max=z_max, captured=captured)


def p2l_batched_inputs(device, n_frames: int = 96, stride: int = 1):
    """Phase 25(a)'s pairs: (frame k, frame k + 1) of the synthetic
    sequence, padded as the main path pads them, and their ground truth
    (RigidTransform3, (B,))."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=0)
    frames = [f[::stride] for f in frames]
    pts, mask = io.pad_points(frames, pad_to=PAD_TO if stride == 1 else None)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    th, t_xy = _pair_truth(traj)
    c, s = torch.tensor(np.cos(th)), torch.tensor(np.sin(th))
    rot = torch.zeros((len(th), 3, 3), dtype=torch.float64)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
    rot[:, 2, 2] = 1.0
    t = torch.zeros((len(th), 3), dtype=torch.float64)
    t[:, :2] = torch.as_tensor(t_xy)
    gt = RigidTransform3(rot.float().to(device), t.float().to(device))
    return (p[:-1], k[:-1], p[1:], k[1:]), gt


def p2l_room_inputs(device, n_poses: int = 28, n_points: int = 3072,
                    scene_n: int = 6000, seed: int = 5):
    """Phase 25(b)'s pairs: (frame k, frame k + 1) of ``room_sequence``
    (SLAM 3D small's frames), their true relative poses, and warm starts:
    each true pose perturbed by a seeded twist of ROOM_TWIST_M and
    ROOM_TWIST_RAD (norms of its translation and rotation parts)."""
    frames, _ = room_sequence(n_poses, n_points, scene_n)
    poses = room_poses(n_poses)
    p = torch.as_tensor(np.stack(frames), dtype=torch.float32, device=device)
    k = torch.ones(p.shape[:2], dtype=torch.bool, device=device)
    rel = [poses[i + 1].inverse().compose(poses[i])
           for i in range(n_poses - 1)]
    gt = RigidTransform3(torch.stack([r.rot for r in rel]).to(device),
                         torch.stack([r.t for r in rel]).to(device))
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_poses - 1, 3))
    w = rng.normal(size=(n_poses - 1, 3))
    v *= ROOM_TWIST_M / np.linalg.norm(v, axis=1, keepdims=True)
    w *= ROOM_TWIST_RAD / np.linalg.norm(w, axis=1, keepdims=True)
    twist = torch.as_tensor(np.concatenate([v, w], axis=1),
                            dtype=torch.float32, device=device)
    t0 = RigidTransform3.from_twist(twist).compose(gt)
    return (p[:-1], k[:-1], p[1:], k[1:]), gt, t0


def _pairs_p2l_hold(kind: str, args, device):
    """One captured kernel 8 ("static") or 9 ("list") call at D 3 / P 4:
    bitwise equal to its plain version, to its schedule's emulation, at
    every schedule, and to a brute-force sweep of the packed db on every
    query its subtile walks.  Returns (the call's result, its schedules'
    launcher-alone ms, the (query, point) pairs it sweeps, the queries
    whose winner carries the invalid-plane sentinel c)."""
    query_p, dbf = args[0], args[1]
    d_dim = args[4] if kind == "list" else args[5]
    q_sub = args[5] if kind == "list" else args[6]
    if kind == "static":
        fn, plain = nn_pairs_cuda.nn_pairs, nn_pairs_cuda.nn_pairs_plain
        emul = nn_pairs_cuda.pairs_items(*args)
        rows = (args[4] > float("-inf")).repeat_interleave(q_sub, dim=1)
        walked = int((nn_pairs_cuda._box_lower_bound(args[2], args[3], d_dim)
                      <= args[4][..., None]).sum())
        pairs = walked * q_sub * 128
    else:
        fn = nn_pairs_cuda.nn_pairs_list
        plain = nn_pairs_cuda.nn_pairs_list_plain
        item = nn_pairs_cuda.list_schedule(q_sub, args[2].shape[-1])[0]
        emul = nn_pairs_cuda.pairs_list_items(*args, item=item)
        rows = args[6] > float("-inf")
        pairs = nn_pairs_cuda.group_walks(*args)
    got = fn(*args)
    _sync(device)
    what = f"nn_pairs {kind} (D {d_dim}, P {dbf.shape[1] - d_dim})"
    _equal_or_raise(got, plain(*args), what)
    _equal_or_raise(got, emul[:3], f"{what} (the items' emulation)")
    schedules = (_pairs_schedules if kind == "static"
                 else _list_schedules)(args, got, device)[0]
    db = dbf[:, :d_dim].transpose(1, 2)
    valid = db[..., 0] < nn_cuda._SENTINEL / 2
    brute = nn_torch(query_p, db, valid, tile=db.shape[1])
    pay = torch.take_along_dim(dbf[:, d_dim:].transpose(1, 2),
                               brute.index[..., None].long(), dim=1)
    dist = nn_cuda._trim_sentinel(got[0])
    hit = rows & torch.isfinite(brute.dist_sq)
    if not (torch.equal(got[1][rows], brute.index[rows])
            and torch.equal(dist[rows], brute.dist_sq[rows])
            and torch.equal(got[2][hit], pay[hit])):
        raise RuntimeError(f"{what}: differs from brute force")
    sentinel = int((got[2][..., -1][hit] == m_p2l._C_INVALID).sum())
    return got, schedules, pairs, sentinel


def _matched_p2l_hold(args, n_query: int, device):
    """Phase 25(a)'s cold kernel 4 call (captured; D 3 / P 4, every pair
    at full width): bitwise equal to its plain version and to a
    brute-force sweep of the packed db (idx, trimmed dist, the winner's
    payload) on every pair.  ``n_query``: each pair's query rows before
    padding.  Returns its kernels-line record at path batched-p2l
    (``_sweep_record``)."""
    query_p, dbf_cm, d_dim = args
    what = f"nn_matched batched-p2l (D {d_dim}, P {dbf_cm.shape[-2] - d_dim})"
    got = nn_sweep_cuda.nn_matched(*args)
    _sync(device)
    _equal_or_raise(got, nn_sweep_cuda.nn_matched_plain(*args), what)
    db = dbf_cm[..., :d_dim, :].transpose(-1, -2)
    valid = db[..., 0] < nn_cuda._SENTINEL / 2
    # A narrow tile: one (B, Q, tile) block of the 95 pairs is ~2.8 GB.
    brute = nn_torch(query_p, db, valid, tile=256)
    pay = torch.take_along_dim(dbf_cm[..., d_dim:, :].transpose(-1, -2),
                               brute.index[..., None].long(), dim=-2)
    hit = torch.isfinite(brute.dist_sq)
    if not (torch.equal(got[1], brute.index)
            and torch.equal(nn_cuda._trim_sentinel(got[0]), brute.dist_sq)
            and torch.equal(got[2][hit], pay[hit])):
        raise RuntimeError(f"{what}: differs from brute force")
    sentinel = int((got[2][..., -1][hit] == m_p2l._C_INVALID).sum())
    del brute, pay, hit
    print(f"# {what}: the cold call, {query_p.shape[0]} pairs x "
          f"{query_p.shape[-2]} query rows x {dbf_cm.shape[-1]} db rows "
          f"({int(valid.sum())} valid), bitwise equal to plain and brute "
          f"force on every pair; {sentinel} results carry the invalid-plane "
          f"sentinel c, unchanged")
    case = dict(kind="nn_matched", fn=nn_sweep_cuda.nn_matched,
                plain=nn_sweep_cuda.nn_matched_plain, args=args, n=n_query,
                valid=float(valid.sum()), out=got)
    return _sweep_record(case, "batched-p2l", device, 0.0)


def _pairs_wide_hold(calls, device, path: str):
    """Warm kernel 8 calls over dbs above PAIRS_MAX_DB points, captured
    (phase 25(a)'s at D 3 / P 4, path batched-p2l; phase 17's at D 2 /
    P 2, slam2d-wide): each bitwise kernel 4 on the same packed inputs,
    the first bitwise its own plain version too; each call's chunk-walk
    share (the (subtile, chunk) prune tests passed, over all) and
    launcher-alone time at the wrapper's schedule.  At batched-p2l the
    first call also at work items of WIDE_ITEMS chunks (2 queries a
    thread) and at 1 and 4 queries a thread (the wrapper's items), and
    unseeded (+inf bounds, every chunk walked: the cold search's work on
    kernel 8) beside kernel 4 on the same inputs, each bitwise.  Returns
    the first call's kernels-line record at ``path``."""
    shares, times, pairs = [], [], []
    on_card = torch.device(device).type == "cuda"
    d_dim = calls[0][5]
    what = f"nn_pairs {path} (D {d_dim}, P {calls[0][1].shape[1] - d_dim})"
    for k, args in enumerate(calls):
        query_p, dbf_cm, qbox, cbox, qbound, d_dim, q_sub = args
        got = nn_pairs_cuda.nn_pairs(*args)
        _sync(device)
        _equal_or_raise(got, nn_sweep_cuda.nn_matched(query_p, dbf_cm, d_dim),
                        f"{what} warm call {k} against nn_matched")
        if k == 0:
            _equal_or_raise(got, nn_pairs_cuda.nn_pairs_plain(*args),
                            f"{what} warm call 0")
        walk = (nn_pairs_cuda._box_lower_bound(qbox, cbox, d_dim)
                <= qbound[..., None])
        shares.append(float(walk.double().mean()))
        pairs.append(int(walk.sum()) * q_sub * 128)
        if on_card:
            largs, _, keep = nn_pairs_cuda._nn_pairs_args(*args)
            times.append(launcher_ms("nn_pairs", largs, device, reps=20))
            del keep
    b, qp = calls[0][0].shape[:2]
    n_ch = calls[0][1].shape[2] // 128
    item0 = nn_pairs_cuda.pairs_item_chunks(b, qp, n_ch * 128)
    sched = {}
    if on_card and path == "batched-p2l":
        query_p, dbf_cm, qbox, cbox, qbound, d_dim, q_sub = calls[0]
        out = nn_pairs_cuda.nn_pairs(*calls[0])
        q0 = nn_pairs_cuda.PAIRS_Q
        shapes = [(min(i, n_ch), q0) for i in WIDE_ITEMS]
        shapes += [(item0, q) for q in (1, 4)]
        for item, q in dict.fromkeys(shapes):
            largs, res, keep = nn_pairs_cuda._nn_pairs_args(
                *calls[0], item=item, q_per_thread=q)
            sched[f"T={item},Q={q}"] = launcher_ms("nn_pairs", largs, device,
                                                   reps=10)
            _sync(device)
            if not all(torch.equal(a, c) for a, c in zip(res, out)):
                raise RuntimeError(f"{what}: items of {item} chunks and {q} "
                                   "queries a thread change the result")
            del keep, res
        # Padded subtiles keep their -inf; every other bound is +inf.
        unseeded = torch.where(torch.isneginf(qbound), qbound,
                               torch.full_like(qbound, float("inf")))
        largs, res, keep = nn_pairs_cuda._nn_pairs_args(
            query_p, dbf_cm, qbox, cbox, unseeded, d_dim, q_sub)
        sched["unseeded"] = launcher_ms("nn_pairs", largs, device, reps=5)
        largs4, res4, keep4 = nn_sweep_cuda._nn_matched_args(query_p, dbf_cm,
                                                             d_dim)
        sched["nn_matched"] = launcher_ms("nn_matched", largs4, device,
                                          reps=5)
        _sync(device)
        _equal_or_raise(res, res4, f"{what} unseeded against nn_matched")
        del keep, res, keep4, res4
    print(f"# {what}: {len(calls)} warm calls of {b} pairs x {qp} query rows "
          f"x {n_ch * 128} db rows, each bitwise equal to nn_matched on its "
          f"inputs (the first to its plain version); chunk-walk share per "
          f"call {[round(x, 5) for x in shares]} (mean "
          f"{sum(shares) / len(shares):.5f}); launcher alone per call (ms, "
          f"items of {item0} chunks, {nn_pairs_cuda.PAIRS_Q} queries a "
          f"thread) {[round(x, 4) for x in times]}"
          + (f"; the first call at items of T chunks, Q queries a thread, "
             f"unseeded, and nn_matched on its inputs: {sched}" if sched
             else ""))
    rec = _pairs_p2l_record("static", calls[0], pairs[0], 0.0, device,
                            path=path)
    rec["extra"].update(walk_share=shares, calls_ms=times,
                        schedules_ms=sched, calls=len(calls))
    return rec


def _pairs_p2l_record(kind, args, pairs, errs, device,
                      path: str = "batched-p2l-room"):
    """Kernel 8 or 9's kernels-line record at a captured call (D 3 / P 4,
    or D 2 / P 2 at slam2d-wide): the launcher alone, the wrapper, the
    plain version, the bound."""
    name = "nn_pairs" if kind == "static" else "nn_pairs_list"
    fn = nn_pairs_cuda.nn_pairs if kind == "static" \
        else nn_pairs_cuda.nn_pairs_list
    plain = nn_pairs_cuda.nn_pairs_plain if kind == "static" \
        else nn_pairs_cuda.nn_pairs_list_plain
    on_card = torch.device(device).type == "cuda"
    # The CPU's times are the plain versions' and prove nothing: one rep.
    wrapper = time_ms(lambda: fn(*args), device, reps=20 if on_card else 1)
    ms, extra = wrapper, {}
    if on_card:
        res = (nn_pairs_cuda._nn_pairs_args if kind == "static"
               else nn_pairs_cuda._nn_pairs_list_args)(*args)
        ms = launcher_ms(name, res[0], device)
        extra = dict(wrapper_ms=wrapper)
        del res
    plain_ms = time_ms(lambda: plain(*args), device, reps=3 if on_card else 1)
    query_p, dbf = args[0], args[1]
    d_dim = query_p.shape[-1]
    f_dim = dbf.shape[1] - d_dim
    tables = sum(x.numel() * 4 for x in args[2:] if torch.is_tensor(x))
    n_bytes = (query_p.numel() * 4 + dbf.numel() * 4 + tables
               + query_p.shape[0] * query_p.shape[1] * (4 + 4 + 4 * f_dim))
    per_pair = NN_OPS_PER_PAIR_3D if d_dim == 3 else NN_OPS_PER_PAIR_2D
    b, by = bound_ms(n_bytes, pairs * per_pair)
    extra["issue_floor_ms"] = \
        pairs * NN_INSTR_PER_PAIR[d_dim] / PEAK_F32_INSTR_PER_S * 1e3
    extra["payload"] = f_dim
    line = 1234 if kind == "static" else 1432
    return dict(name=name, route="cuda", path=path,
                source=f"icp_rust_tpu_torch/csrc/{name}.cu",
                replaces=f"icp_rust_tpu/ops/nn_pallas.py:{line}",
                launches=0, max_abs_err=errs, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None, extra=extra)


def phase_p2l_batched(device="cuda", n_frames: int = 96, stride: int = 1,
                      plain_pairs: int = P2L_BATCH_PLAIN,
                      voxel: float = P2L_VOXEL_M, n_poses: int = 28,
                      n_points: int = 3072, scene_n: int = 6000,
                      room_voxel: float = 0.4, tile: int = 2048):
    """Phase 25: batched ``icp_point_to_plane``.  (a) the 95 consecutive
    pairs of the 96 frames at full width from identity (kernel 4 at D 3 /
    P 4 cold, kernel 8's seed prune warm); (b) the 27 consecutive pairs of
    SLAM 3D small's room frames (3,072 points, voxel 0.4 m) from perturbed
    true poses (kernels 8 and 9), whose captured kernel calls are held
    bitwise at every schedule.  (a)'s cold kernel 4 call is held bitwise
    on every pair, its warm kernel 8 calls against kernel 4.  ``tile``:
    (a)'s db tile (a smaller one lets a reduced width take kernel 8).
    Returns (the two runs, kernel 4 and 8's records at (a)'s shapes and
    kernel 8 and 9's at (b)'s, all at D 3 / P 4)."""
    cfg = _config()
    batch, gt = p2l_batched_inputs(device, n_frames, stride)
    ident = RigidTransform3.identity((batch[0].shape[0],),
                                     dtype=torch.float32, device=device)
    wide = _p2l_batched_case("batched p2l", batch, ident, gt,
                             cfg.with_(nn_dst_tile=tile), device, voxel,
                             plain_pairs, {"nn_matched": 1, "nn_pairs": "K-1"},
                             capture=((nn_sweep_cuda, "nn_matched", 1),
                                      (nn_pairs_cuda, "nn_pairs", None)),
                             z_tol=P2L_BATCH_Z_M)
    captured = wide.pop("captured")
    calls = captured["nn_matched"]
    if not calls or not captured["nn_pairs"]:
        raise RuntimeError("batched p2l: no nn_matched or nn_pairs call")
    records = [_matched_p2l_hold(calls[0], batch[0].shape[1], device),
               _pairs_wide_hold(captured["nn_pairs"], device,
                                "batched-p2l")]
    del calls, captured
    batch, gt, t0 = p2l_room_inputs(device, n_poses, n_points, scene_n)
    room = _p2l_batched_case(
        "batched p2l room", batch, t0, gt, cfg, device, room_voxel,
        plain_pairs, {"nn_pairs": 1, "nn_pairs_list": "K-1"},
        capture=((nn_pairs_cuda, "nn_pairs", None),
                 (nn_pairs_cuda, "nn_pairs_list", None)))
    for kind, fn in (("static", "nn_pairs"), ("list", "nn_pairs_list")):
        calls = room["captured"][fn]
        if not calls:
            raise RuntimeError(f"batched p2l room: no {fn} call")
        pairs, sent, sched = [], 0, {}
        for args in calls:
            _, by_sched, n_pairs, n_sent = _pairs_p2l_hold(kind, args, device)
            pairs.append(n_pairs)
            sent += n_sent
            for key, ms in by_sched.items():
                sched[key] = sched.get(key, 0.0) + ms
        print(f"# batched p2l room {fn} (D 3, P 4): {len(calls)} captured "
              f"calls bitwise equal to plain, the items' emulation and "
              f"brute force, at every schedule (launcher-alone ms summed "
              f"over the calls {sched}); {sum(pairs)} (query, point) "
              f"pairs; {sent} results carry the invalid-plane sentinel c, "
              f"unchanged")
        # The cold call, and the first warm one (phase 6's shapes).
        rec = _pairs_p2l_record(kind, calls[0], pairs[0], 0.0, device)
        rec["extra"]["schedules_sum_ms"] = sched
        rec["extra"]["calls"] = len(calls)
        records.append(rec)
    del room["captured"]
    return dict(wide=wide, room=room), records


def profile_p2l_batched(device="cuda", n_frames: int = 96):
    """torch.profiler over one batched p2l call on phase 25(a)'s pairs
    (after a warm-up run): device time by kernel and the device's idle
    share against an unprofiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, _ = p2l_batched_inputs(device, n_frames)
    t0 = RigidTransform3.identity((batch[0].shape[0],), dtype=torch.float32,
                                  device=device)
    cfg = _config()
    _run_p2l_batched(*batch, t0, cfg, device, P2L_VOXEL_M)
    _, _, wall, _ = _run_p2l_batched(*batch, t0, cfg, device, P2L_VOXEL_M)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_p2l_batched(*batch, t0, cfg, device, P2L_VOXEL_M)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile batched p2l: {n_frames - 1} pairs, unprofiled wall "
          f"{wall * 1e3:.3f} ms; device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile batched p2l kernel "
              f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls "
              f" {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def phase_mxu(device="cuda", n_frames: int = MXU_FRAMES, stride: int = 1,
              call: int = 8):
    """Phase 26: ``run_odometry_fused`` with nn_method="mxu" over the first
    ``n_frames`` frames at full width, twice (the second run timed): ATE <
    ATE_GATE_M; then the ``call``-th captured NN call against the direct
    kernel route: the share of equal indices, the largest distance gap."""
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_method="mxu")
    calls, undo = _capture_calls(m_nn, "nn_torch")
    try:
        _run_path(pts, mask, cfg, device, True)
    finally:
        undo()
    path, stats, sec, launches = _run_path(pts, mask, cfg, device, True)
    ate = ate_rmse(path, gt[:n_frames - 1])
    outer = stats.outer_iters.cpu().numpy()
    fps = (n_frames - 1) / sec
    query, db, dmask = calls[min(call, len(calls) - 1)][:3]
    mxu = nn_torch(query, db, dmask, tile=cfg.nn_dst_tile, method="mxu")
    direct = m_nn.nearest_neighbor(query, db, dmask, backend="cuda",
                                   tile=cfg.nn_dst_tile)
    _sync(device)
    same = float(torch.mean((mxu.index == direct.index).double()))
    fin = torch.isfinite(direct.dist_sq)
    gap = float(torch.max(torch.abs(mxu.dist_sq[fin] - direct.dist_sq[fin])))
    print(f"# mxu: {n_frames} frames of {pts.shape[1]} points, {sec:.4f} s, "
          f"{fps:.2f} frames/s (host clock); ATE vs ground truth {ate:.6f} "
          f"m; outer iterations per frame mean {outer.mean():.3f} total "
          f"{int(outer.sum())}; launches {_nonzero(launches)}; NN call "
          f"{min(call, len(calls) - 1)} of {len(calls)} against the direct "
          f"kernel route: indices equal {same:.6f}, max distance gap "
          f"{gap:.3e} m^2")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"mxu ATE {ate} >= {ATE_GATE_M}")
    return dict(launches=launches, ate=ate, fps=fps, seconds=sec,
                outer=int(outer.sum()), index_share=same, dist_gap=gap)


def _grid_fields(grid):
    return [getattr(grid, f.name) for f in dataclasses.fields(grid)]


def phase_gridhash(device="cuda", stride: int = 1, radius: float = 0.25,
                   bucket_cap: int = 32, table_size: int = 1 << 16,
                   reps: int = 20):
    """Phase 27: ``ops/gridhash`` on frames 0 (db) and 1 (queries) at full
    width, one of ``benchmarks/profile_gridhash.py``'s settings: the
    overflow fraction printed; the found set equal to brute force's
    in-radius set (kernel 5); every result that differs from brute
    force's explained by a dropped point (its true nearest neighbour lies
    past ``bucket_cap`` in its bucket), none where the overflow is 0; the
    grid's fields and results bitwise the same call's on the CPU; build
    and query timed."""
    pts, mask, _ = frames3d(2, stride)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    db, dmask, query = p[0], k[0], p[1][k[1]]
    kw = dict(table_size=table_size, bucket_cap=bucket_cap)
    grid = gridhash.build_grid(db, dmask, radius, **kw)
    res = gridhash.nn_gridhash(query, grid)
    build_ms = time_ms(lambda: gridhash.build_grid(db, dmask, radius, **kw),
                       device, reps=reps)
    query_ms = time_ms(lambda: gridhash.nn_gridhash(query, grid), device,
                       reps=reps)
    cuda_build.reset_launches()
    b_idx, b_dist, _ = nn_sweep_cuda.search(query[None], db[None],
                                            dmask[None])
    _sync(device)
    launches = dict(cuda_build.LAUNCHES)
    b_idx, b_dist = b_idx[0], b_dist[0]
    overflow = float(grid.overflow_frac)
    r2 = grid.cell_size * grid.cell_size
    found = torch.isfinite(res.dist_sq)
    if not torch.equal(found, b_dist < r2):
        raise RuntimeError("gridhash: the found set differs from brute "
                           "force's in-radius set")
    differs = found & ((res.index != b_idx) | (res.dist_sq != b_dist))
    # A differing result must have lost its true neighbour to the cap:
    # that point's row lies at or past bucket_cap in its slot.
    row_of = torch.empty_like(grid.index)
    row_of[grid.index.long()] = torch.arange(len(grid.index),
                                             dtype=torch.int32,
                                             device=db.device)
    true_nn = b_idx[differs].long()
    slot = gridhash._hash_cells(gridhash._cells(db[true_nn],
                                                grid.cell_size),
                                grid.table_size).long()
    pos = row_of[true_nn] - grid.starts[slot]
    closer = res.dist_sq[differs] >= b_dist[differs]
    n_diff = int(differs.sum())
    if not (bool(torch.all(pos >= bucket_cap)) and bool(torch.all(closer))
            and (overflow > 0 or n_diff == 0)):
        raise RuntimeError("gridhash: a result differs from brute force "
                           "without a dropped point")
    cpu_grid = gridhash.build_grid(db.cpu(), dmask.cpu(), radius, **kw)
    cpu_res = gridhash.nn_gridhash(query.cpu(), cpu_grid)
    same_cpu = all(torch.equal(a.cpu(), b) if torch.is_tensor(a) else a == b
                   for a, b in zip(_grid_fields(grid),
                                   _grid_fields(cpu_grid)))
    same_cpu &= torch.equal(res.index.cpu(), cpu_res.index) and torch.equal(
        res.dist_sq.cpu(), cpu_res.dist_sq)
    print(f"# gridhash: {db.shape[0]} db points ({int(dmask.sum())} valid), "
          f"{query.shape[0]} queries, r {radius} m, cap {bucket_cap}, table "
          f"{table_size}: overflow_frac {overflow:.6f} (max bucket "
          f"{int(grid.counts.max())}); found {int(found.sum())}, equal to "
          f"brute force's in-radius set (kernel 5, launches "
          f"{_nonzero(launches)}); {n_diff} results differ from brute force, "
          f"each past the cap in its bucket; fields and results bitwise the "
          f"CPU's: {same_cpu}; build {build_ms:.4f} ms, query "
          f"{query_ms:.4f} ms")
    if not same_cpu:
        raise RuntimeError("gridhash: the card's grid differs from the CPU's")
    return dict(launches=launches, overflow=overflow, build_ms=build_ms,
                query_ms=query_ms, differs=n_diff, found=int(found.sum()))


def p2l_pairs_inputs(device):
    """Kernels 8 and 9's arguments at D 3 / P 4: every call of one
    batched p2l run on the room pairs (phase 25(b)), captured:
    {"nn_pairs": [...], "nn_pairs_list": [...]}."""
    batch, _, t0 = p2l_room_inputs(device)
    out, undo = {}, []
    for fn in ("nn_pairs", "nn_pairs_list"):
        out[fn], u = _capture_calls(nn_pairs_cuda, fn)
        undo.append(u)
    try:
        _run_p2l_batched(*batch, t0, _config(), device, 0.4)
    finally:
        for u in undo:
            u()
    return out


def _kernel_instance(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    nn_pruned_kernelILi3ELi4EE (D = 3, Q = 4)."""
    i, name = mangled.find("N") + 1, mangled
    while 0 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I(?:L\w+?E)+E", mangled[i:])
    return name + (args.group(0) if args else "")


def _ptxas_lines(report: dict):
    """ptxas' register, spill and shared-memory lines of each kernel
    instance."""
    for name, log in sorted(report.items()):
        entry = ""
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = " " + _kernel_instance(m.group(1))
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}{entry}: {line.strip()}")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    profile_run = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("allow_tf32 must be False for the geometry")
    device = "cuda"
    t0 = time.perf_counter()
    _ptxas_lines(cuda_build.build())
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s")

    smi = _card()
    print(f"# card: {smi}")
    if "--times" in sys.argv[1:]:
        kernel_times(device)
        return 0
    print(f"# nn_list: work items of {nn_cuda.ITEM_CHUNKS} chunks; "
          f"irls_loop: a thread-block cluster of {align2d_cuda.IRLS_CLUSTER}"
          f" blocks; p2l_loop and p2l_stats: a cluster of 16 blocks above "
          f"{align3d_cuda.P2L_CLUSTER_16_ABOVE} points, else 8; gn_stats: "
          f"a cluster of 16 blocks above {align2d_cuda.GN_CLUSTER_16_ABOVE} "
          f"points, else 8; nn_pruned: "
          f"work items of {nn_sweep_cuda.ITEM_TILES} "
          f"tiles, {nn_sweep_cuda.QUERIES_PER_THREAD} queries a thread; "
          f"nn_matched and nn_sweep: {nn_sweep_cuda.MATCHED_Q} queries a "
          f"thread, work items for >= {nn_sweep_cuda.MATCHED_BLOCKS} "
          f"blocks; icp2d_frame: a cluster of "
          f"{cuda_build.query('icp2d_frame_cluster')(640)} blocks at 640 "
          f"points, {cuda_build.query('icp2d_frame_cluster')(128)} at "
          f"128; "
          f"irls_loop_batched: clusters of up to 16 blocks a pair, >= "
          f"{align2d_cuda.BATCHED_MIN_POINTS} points a block, all pairs "
          f"resident; gn_stats_batched: one block a pair up to "
          f"{align2d_cuda.GN_BATCHED_BLOCK_MAX_POINTS} points, "
          f"~{align2d_cuda.GN_BATCHED_POINTS} points a thread, else as "
          f"irls_loop_batched; nn_pairs: work items for >= "
          f"{nn_pairs_cuda.PAIRS_BLOCKS} blocks, {nn_pairs_cuda.PAIRS_Q} "
          f"queries a thread; nn_pairs_list: work items of "
          f"{nn_pairs_cuda.LIST_ITEM} list entries, {nn_pairs_cuda.LIST_Q} "
          f"queries a thread; icp2d_frame_pairs: the first of "
          f"{align2d_cuda.PAIRS_SHAPES} (blocks a pair, threads a block) "
          f"with all pairs resident")
    records = [phase_nn_list(device), *phase_irls(device),
               *phase_frame(device)]
    main_run = phase_main(device)
    run_2d = phase_2d(device)
    records += phase_nn_pairs(device)
    records += [phase_irls_batched(device), phase_irls_batched_wide(device),
                phase_frame_pairs(device)]
    batched = phase_batched(device)
    records += [phase_nn_list_p2l(device), phase_p2l_loop(device),
                phase_p2l_stats(device)]
    p2l = phase_p2l(device)
    records += phase_nn_sweeps(device)
    slam3 = phase_slam3d(device)
    slam3_small = phase_slam3d_small(device)
    slam2 = phase_slam2d(device)
    records += slam2["records"]
    records += phase_gn_stats(device)
    sub = phase_submap(device)
    records.append(sub["nn_list"])
    sub_2d = phase_submap_2d(device)
    records.append(phase_matched_submap_2d(device))
    runners = phase_runners(device, main_run, p2l)
    cli_runs = phase_cli(device)
    hooks = phase_hooks(device, slam3["graph"])
    sharded_runs = phase_sharded(device, smi=smi, inputs=sharded_inputs(
        slam3["graph"], device=device))
    p2l_b, p2l_b_records = phase_p2l_batched(device)
    records += p2l_b_records
    mxu = phase_mxu(device)
    grid = phase_gridhash(device)
    if profile_run:
        profile_main(device)
        profile_batched(device)
        profile_p2l(device)
        profile_slam3d(device)
        profile_submap(device)
        profile_p2l_batched(device)
    launches = {
        ("nn_list", "main"): main_run["launches"]["nn_list"],
        ("irls_loop", "main"): main_run["launches"]["irls_loop"],
        ("irls_loop", "main-warm"): main_run["launches"]["irls_loop"],
        ("icp2d_frame", "2d"): run_2d["launches"]["icp2d_frame"],
        ("nn_pairs", "batched"): batched["launches"]["nn_pairs"],
        ("nn_pairs_list", "batched"): batched["launches"]["nn_pairs_list"],
        ("irls_loop_batched", "batched"):
            batched["launches"]["irls_loop_batched"],
        ("irls_loop_batched", "slam2d-wide"):
            slam2["wide_launches"]["irls_loop_batched"],
        ("icp2d_frame_pairs", "batched"):
            batched["frame_launches"]["icp2d_frame_pairs"],
        ("nn_list", "p2l"): p2l["launches"]["nn_list"],
        ("p2l_loop", "p2l"): p2l["launches"]["p2l_loop"],
        ("nn_pruned", "slam3d"): slam3["launches"]["nn_pruned"],
        ("nn_sweep", "slam3d-small"): slam3_small["launches"]["nn_sweep"],
        ("nn_matched", "slam3d-small"):
            slam3_small["launches"]["nn_matched"],
        ("nn_sweep", "slam2d-wide"): slam2["wide_launches"]["nn_sweep"],
        ("nn_matched", "slam2d-wide"): slam2["wide_launches"]["nn_matched"],
        ("nn_pairs", "slam2d-wide"): slam2["wide_launches"]["nn_pairs"],
        ("nn_matched", "submap-2d"): sub_2d["fused"]["launches"]["nn_matched"],
        ("nn_matched", "batched-p2l"):
            p2l_b["wide"]["launches"]["nn_matched"],
        ("nn_pairs", "batched-p2l"): p2l_b["wide"]["launches"]["nn_pairs"],
        ("nn_pairs", "batched-p2l-room"):
            p2l_b["room"]["launches"]["nn_pairs"],
        ("nn_pairs_list", "batched-p2l-room"):
            p2l_b["room"]["launches"]["nn_pairs_list"],
    }
    runs = {"main": main_run["launches"], "2d": run_2d["launches"],
            "batched": batched["launches"],
            "batched-pairs": batched["frame_launches"],
            "p2l": p2l["launches"], "slam3d": slam3["launches"],
            "slam3d-small": slam3_small["launches"],
            "slam2d": slam2["launches"],
            "slam2d-wide": slam2["wide_launches"],
            "submap": sub["launches"],
            "submap-2d": sub_2d["fused"]["launches"],
            "submap-2d-revoxelize": sub_2d["re-voxelize"]["launches"],
            **{path: run["launches"]
               for path, run in {**runners, **cli_runs}.items()},
            **sharded_runs,
            "batched-p2l": p2l_b["wide"]["launches"],
            "batched-p2l-room": p2l_b["room"]["launches"],
            "mxu": mxu["launches"], "gridhash-reference": grid["launches"]}
    for rec in records:
        if (rec["name"], rec["path"]) in launches:
            rec["launches"] = launches[(rec["name"], rec["path"])]
        if rec["launches"] <= 0:
            raise RuntimeError(f"{rec['name']} never launched on its path "
                               f"({rec['path']})")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    # One entry per kernel: its first record's path and shapes; the other
    # shapes it was timed at, and its launches on every path driven.
    entries = {}
    for rec in records:
        entry = entries.get(rec["name"])
        if entry is None:
            entry = entries[rec["name"]] = {k: rec[k] for k in keys}
            entry.update(rec.get("extra", {}))
            entry["launches_by_path"] = {rec["path"]: rec["launches"]}
            entry["launches_by_path"].update(
                (p, n[rec["name"]]) for p, n in runs.items()
                if n[rec["name"]])
            entry["other_shapes"] = []
        else:
            entry["other_shapes"].append({k: rec[k] for k in (
                "path", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by")} | rec.get("extra", {}))
    if sorted(entries) != sorted(cuda_build.SOURCES):
        raise RuntimeError(f"kernels line has {sorted(entries)}")
    print(f"# submap: {sub['fps']:.2f} frames/s, ATE {sub['ate']:.6f} m, "
          f"{sub['outer_total']} outer iterations, dropped points "
          f"{sub['dropped']}; 2D max errors "
          f"{sub_2d['fused']['err']:.6f} / {sub_2d['re-voxelize']['err']:.6f}"
          f" m")
    dev_run, p2l_run = runners["odometry-device"], runners["odometry-p2l"]
    print(f"# per-frame runners with metrics beside the fused ones (host "
          f"clock, second runs): odometry-device {dev_run['fps']:.2f} "
          f"frames/s (fused, phase 4: {main_run['fps']:.2f}), odometry-p2l "
          f"{p2l_run['fps']:.2f} (fused, phase 13: {p2l['fps']:.2f}); "
          f"cli odometry2d "
          f"{cli_runs['cli-odometry2d']['summary']['frames_per_s']:.2f} "
          f"frames/s, --metrics "
          f"{cli_runs['cli-odometry2d-metrics']['summary']['frames_per_s']:.2f}"
          f"; graph solve dense {hooks['dense_s']:.4f} s, schur "
          f"{hooks['schur_s']:.4f} s (Jacobians {hooks['jac_s']:.4f} s)")
    wide, room = p2l_b["wide"], p2l_b["room"]
    print(f"# batched p2l: {wide['pairs_per_s']:.2f} pairs/s, "
          f"{wide['outer']} outer iterations, max |t_z| "
          f"{wide['z_max']:.6f} m; room pairs {room['pairs_per_s']:.2f} "
          f"pairs/s, {room['outer']} outer iterations; mxu {mxu['fps']:.2f} "
          f"frames/s, ATE {mxu['ate']:.6f} m, indices equal to the direct "
          f"route {mxu['index_share']:.6f}; gridhash build "
          f"{grid['build_ms']:.4f} ms, query {grid['query_ms']:.4f} ms, "
          f"overflow_frac {grid['overflow']:.6f} ({smi})")
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
