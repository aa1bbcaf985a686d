#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port `ba_tpu_torch` on one NVIDIA GPU.

    python3 chip_smoke.py [--parent TREE]

With `--parent TREE` (an earlier commit unpacked with `git archive` under
`_archive/`), phases 11, 14, 20 and 28 also time that tree's kernel 1,
kernels 7 and 9, K8a, kernel 6 and K5b on the same inputs, loaded beside
this tree's package, and kernel 1's timing at the self-calibration (a rig
of FOV cameras with the rig's intrinsics) times the parent's beside it.

Phases, each of which exits non-zero when a check fails:

  1. build the hand-written CUDA kernels from ba_tpu_torch/kernels/csrc/
     (one nvcc per source, started together) and print what ptxas reports;
  2. build the flagship problem of bench.py with the port alone:
     simulate(128 poses, 512 landmarks, seed 0), build_problem(perturb 0.01,
     seed 1), band width from the problem, cast to f32, prepare_landmarks;
  3. kernel 1 (reprojection) against its plain version, f64 and f32 (the
     f32 kernel against the plain version in f64 on the same inputs), with
     and without Jacobians, at the flagship rows and at a row count that is
     not a multiple of the kernel's 32-row blocks; k2: K2 (imu_preint, the
     IMU preintegration with its whitening) against the plain evaluation
     (`evaluate_plain`) at the flagship's spans, f32 and f64: (a) with
     Jacobians, (b) without from a given C9, and (a) then (b) without one,
     the whitened r, j1, j2, err_sq and the C9 used, bit-identical between
     launches; again under imu_rotation_only with conditioning edges and
     robust weights below 1, and with a cached covariance
     (calculate_inertial_covariance_once) and invalid spans (also at a
     stream slide's, the long trajectory's, the PCG's, the fleet's, the
     self-calibration's 15-dim and the calibration service's spans,
     below);
  4. segsum (grouped segmented block sum) against its plain version on
     the seven sums of one flagship build, all in one launch over the
     build's segment plans, plus out-of-range ids and a segment of 2,100
     rows through one-group plans; two launches must give bit-identical
     output;
  5. the port on the card against the port on the CPU (whose plain path the
     CPU tests hold against ba_tpu) on a small f64 problem;
  6. GN `solve_fixed(..., 25)` and 7. the default dogleg `solve`, at the
     flagship size in f32: the cost and the ATE against the simulator's
     ground truth fall, everything is finite, and both kernels' launch
     counters moved by exactly the expected counts (segsum: one per
     build); host syncs per iteration, and those of the one-off plan;
  8. general_small: the general assembly path (band_width 0) on a small
     f64 problem, one `assemble` (S, rhs, cost) and one `marginalize`
     (H, g), on the card against the same code on the CPU;
  9. ring_small: four slides of `run_ring` in f64, card against CPU;
 10. stream: the serving path at full width in f32, apps/vins_stream.py's
     configuration at a VIO window's density (simulate(128 poses, 2,048
     landmarks, seed 7), build_problem(perturb 0.02, seed 8), W = 10, 2 GN
     iterations per slide), every keyframe through
     `StreamingRing.push(block=False)`: keyframes retired per second after
     the first push, ms per slide, host syncs per push (none: K11 has
     replaced the `eigh` that made one), kernel launches per slide, the
     retired trajectory's ATE (at most twice the JAX package's f64 CPU ATE
     at the same configuration) and finite costs; kernel 1 and segsum
     against their plain versions at a slide's shapes; stream_many: the
     multi-stream server (`vins_stream.stream_many`, the app's --streams)
     with 4 streams of that configuration (build seeds 8-11, capacities
     from the 128-keyframe schedule), each pushing its first 40 keyframes
     (reduced from 128 for the script's time): aggregate and per-stream
     keyframes retired per second, ms per round, no host sync in a steady
     push, exact launches, each stream's ATE under the same bound and its
     outputs bit-identical to the same stream pushed alone;
 11. timings from CUDA events, at the flagship's shapes and at a slide's:
     each kernel per call (host launch cost included) and on the device
     (CUDA-graph replay), beside the launch floor (a one-element add,
     replayed the same way), its bound and its plain version; index_add_,
     segsum's library yardstick, both ways; the segment plans' one-off
     build; kf/s of both drivers and of the stream;
 12. banded_small: the
     banded solvers on the card against the CPU in f64 (simulate(80 poses,
     200 landmarks), four chunks): solve_reduced_banded with cyclic
     reduction and with the scan (exact K8 launches, no torch.linalg factor
     or triangular solve), band_S and the step through the grouped Schur
     form (forced), `schur_on_band` with an active marginalization prior,
     and one dogleg `solve` on the banded solver;
 13. the long trajectory of bench_roofline.py --what band --poses 2048:
     simulate(2,048 poses, 8,192 landmarks, seed 0), build_problem(perturb
     0.01, seed 1, no marginalization prior), f32, band width from the
     problem, use_banded_solver; k7: kernel 7 (grouped band Schur
     correction) against its plain version at full width in f32 and on an
     f64 copy, with padding W blocks, and on a 48-pose build with XYZ
     landmarks (lm_size 3), bit-identical relaunch, and bit-identical with
     its staging forced into pieces; k9: kernel 9 (band matvec) against its
     plain version on the scaled band and at 2,047 poses (not a multiple of
     its 16-pose tiles); k8: K8a (the chunk
     layout) bit-identical to its plain version, K8b and K8c (factor and
     solve, cyclic reduction with explicit inverses against its plain
     versions and x = S^-1 b against the torch.linalg route; the scan
     crossed both ways), f32 and f64, with the backward error, and on a
     damped copy;
 14. long: GN solve_fixed(..., 10) of that trajectory: cost and ATE fall,
     everything finite, solver_ok at every iteration, exact launch counts
     of kernels 1, 7, 9, segsum, K2 and K8 (173 per iteration), no
     torch.linalg factor or triangular solve, no host sync per iteration
     (the one-off plans
     counted apart), kf/s, ms per iteration and peak device memory; the
     first iteration's step against the dense solve of the same build
     (banded grid + dense Cholesky), within a multiple of the same gap on
     an f32 CPU run of both at 256 poses; K7 and K9 timed as in 11, with
     torch.mv on the densified band as K9's library yardstick, their bounds
     counted as the function needs its bytes (the route's beside) and,
     with `--parent`, the parent's kernels on the same inputs; K8a, K8b
     and one K8c solve timed apart, with the host and on the device
     (CUDA-graph replay), beside their bounds (flops and bytes counted level
     by level over the chunks that are not padding; PR 8's count beside)
     and the old torch.linalg route (`library_ms`), the device ms of each
     level's eliminate, products, down and up steps (`k8_level_split`),
     and the device operations of one iteration's K8 work both ways;
 15. cg_small: the matrix-free PCG solver (use_cg_solver) on the card
     against the CPU in f64 (simulate(24 poses, 72 landmarks)): one
     solve_reduced_cg step, one GN iteration with an active marginalization
     prior, one dogleg `solve`;
 16. the PCG configuration of bench_scaling.py's `cg` solver at P = 1,024:
     simulate(1,024 poses, 4,096 landmarks, seed 0), build_problem(perturb
     0.01, seed 1, no marginalization prior), f32, band width 0,
     cg_max_iterations 100, cg_tolerance 1e-5; k6: kernel 6 (the projection
     rows of the Schur product, in the landmark-sorted order) and its pack
     (the build's row blocks in that order) against their plain versions at
     those shapes in f32 and on an f64 copy, again with 8 landmarks merged
     into one of more rows than a warp, and on the same problem with XYZ
     landmarks (lm_size 3), bit-identical relaunch, the rows summed by pose
     against the row-order route; the packed route whole (`s_matvec` on
     the card) against the row-order route's S x at both landmark sizes;
 17. cg: GN solve_fixed(..., 10) of that problem: cost and ATE fall,
     solver_ok at every iteration, PCG iterations per build, host syncs per
     build (at most ceil(100 / 8)), exact launch counts of kernel 1,
     segsum, kernel 6 and its pack (one per build), kf/s, ms per
     iteration, peak memory; the first step against the dense solve of
     the same build (banded grid + dense Cholesky) within a multiple of
     the same gap on an f32 CPU run at 256 poses;
 18. fleet_small: both fleet branches on the card against the CPU in f64 (2
     windows of 12 poses: the dense fleet solve, and the banded solver with
     a fleet axis when the landmark count is odd);
 19. the fused fleet of bench_fleet.py --mode concat at B = 4 flagship
     windows (apps/fleet_serve.py's route): 4 x build_problem(perturb 0.01,
     seeds 1-4) of simulate(128, 512, seed 0), f32, concat_problems, band
     width from the fused problem, use_banded_solver, fleet_size 4; k10:
     kernel 10 (the scaled per-window Schur system from the W blocks)
     against its plain version (`fleet_schur_plain`), f32 and f64, with
     padding W blocks, and with lm 3 on the fleet's table, Ss exactly
     symmetric, bit-identical relaunch; fleet: GN solve_fixed(...,
     25) on solve_reduced_fleet_dense, 0 host syncs per iteration, exact
     launch counts of kernel 1, segsum and kernel 10, every window's cost
     and ATE
     fall, one iteration against fleet_size 1 (the chunked banded path),
     kf/s and ms per iteration;
 20. kernels 6 and 10 timed as in 11: torch.mv on the dense S of the same
     CG build is K6's library yardstick, torch.bmm of the dense W operands
     (the product kernel 10 replaces) K10's, with K10's bound counted from
     the products over shared landmarks and its device memory beside the
     plain route's; the dense fleet solve's cholesky_ex and triangular
     solves timed apart; kernel 6's pack (per build), segsum's launch in a
     Schur product and the whole product timed apart;
 21. the full-width self-calibration (the flagship sequence under the
     reference's fullest template configuration <R,1,15,5,true>: pose_dim
     15, inverse depth, the 5 FOV intrinsics and the 6 T_vs tangents,
     intrinsics and T_vs moved as tests/test_selfcal.py moves them, f32):
     K2 at its 15-dim spans; k1_calib: kernel 1 with the 11 calibration
     columns against its plain version, and with XYZ landmarks (lm_size 3,
     linear camera) at the calibration service's 43,200 rows, f32 and f64,
     and the calibration variant timed;
 22. selfcal_small: a GN iteration, the dogleg `solve` and its calibration
     marginals on the card against the CPU in f64 (10 poses);
 23. selfcal: the dogleg `solve(..., max_iter=40)` at full width: the final
     cost at most 1e-4 of the first build's, the intrinsics' error falls,
     everything finite; the intrinsics and T_vs errors against the
     simulator beside the JAX package's test bound of 5e-2, kf/s, ms per
     iteration, host syncs per iteration, exact launches of kernel 1,
     segsum and K2, peak memory;
 24. vicalib: `ViCalibrator.solve_once` through its three stages (T_vs
     rotation only, then its translation, then the biases) on a synthetic
     camera-IMU capture made from a seed (a 6 x 6 tag grid of 144 corners,
     300 frames at 20 Hz, IMU at 200 Hz, the linear camera), f32: the
     stages advance, the calibration improves, the mse per stage and the
     seconds per solve_once;
 25. k5: K5 (schur_finish, the Schur step) against its plain version at
     a flagship build's, a stream slide's build and marginalization's and
     the self-calibration's shapes, and on block-banded W whose tile pairs
     are partly empty (the flagship's shape, and lm 3 at the slide's
     cluster split), f32 and f64, S exactly symmetric, bit-identical
     between launches, each line with its tiles, its empty tile pairs and
     its cluster split; k11: K11 (marginalize, the departing dims' Schur
     complement, the PSD certificate, and the clip by Jacobi where it
     fails) against its plain version at the stream slide's
     marginalization (n = 90), vins_window's (apps/vins_window.py --poses
     40: n = 360), an indefinite n = 90 system, a PSD prior with a
     singular kept block and masked dims, one eigenvalue at -0.1 tau and
     at -10 tau (either side of the certificate), a PSD n = 360 prior and
     indefinite systems at n = 168, 169 (either side of the shared-memory
     limit of the Jacobi's A and V) and 360, f32 and f64: the branch each
     takes (held where the case fixes it), its info flag (converged,
     finite), the smallest eigenvalue of its f32 output, bit-identical
     between launches; both timed as in 11 beside their bounds (K5's from
     W's structurally nonzero products, the dense count beside it; K11's
     with the certificate's na^3 / 3 and the rotations only where the
     Jacobi ran), plain versions and library yardsticks (torch.matmul of
     W V^-1 by W^T; `eigh` and the clip product); `stream` and
     `stream_many` count the marginalizations the certificate settled;
 26. gps_small: the GPS + IMU smoother (apps/unary_binary_imu_test.py) on
     the card against the CPU in f64: a 16-fix log's batch solve and its
     stream with the app's W = 10, both at 1e-8; K2 at its spans of 101
     slots;
 27. gps_batch: `generate_log(600)` parsed by the native parser, built,
     `solve(max_iter=25, gn_damping=0.2)` in f32 on the banded grid: cost
     falls, the track within 3 GPS sigma of the fixes, exact launches of
     K1 (lm_size 0), K2, segsum, K5b and K5, kf/s, ms per iteration, host
     syncs per iteration; K2 timed at its spans; gps_stream: its first 120
     fixes through `run_streaming` (W = 10, 6 GN iterations per slide,
     f64): poses retired per second, ms per push, no host sync per steady
     push, exact launches per slide, K11's branches, the retired track
     within GPS_STREAM_RMSE of the f64 batch;
 28. k5b: K5b (band_to_dense) on a flagship build's band, a GPS batch
     build's and K5B_SHAPES, f32 and f64, equal to its plain version
     element for element, bit-identical relaunch; the flagship and GPS
     bands timed beside the bound, the plain version and, with `--parent`,
     the parent's kernel;
 29. cg_selfcal_small: self-calibration on the matrix-free PCG
     (use_cg_solver with a calibration block) on the card against the CPU
     in f64 (simulate(12 poses, 36 landmarks, seed 13), calibration moved),
     at K = 11 (pose_dim 15, intrinsics and T_vs) and K = 5 (pose_dim 9,
     intrinsics): the build's rhs_sc, minv_cal and dscale, one
     solve_reduced_cg step at tolerance 1e-12 and one GN iteration;
 30. k6_calib: the PCG configuration's problem (16) under <R,1,15,5,true>,
     calibration moved as in 21, f32: kernel 6 and its pack with the 11
     calibration columns (records with J_c; the rows and each tile's
     partial of J_c^T w) against their plain versions in f32 and on an f64
     copy, bit-identical relaunch, and the packed route whole against the
     CPU path's S x;
 31. cg_selfcal: GN solve_fixed(..., 10) of that problem on the PCG (cap
     100, tol 1e-5) in f32: the cost, the intrinsics and the T_vs rotation
     errors fall, solver_ok at every iteration, PCG iterations and host
     syncs per build (the stop-test reads only), exact launches of kernel
     1, segsum, K2, kernel 6 and its pack (one per build); the dense GN
     self-calibration of the same problem in f64 on the card and the
     calibration gap between the two (recorded, not bounded); kernel 6 and
     its pack with the calibration columns timed as in 11, torch.mv on the
     dense S (15,371 rows, 945 MB in f32) as kernel 6's yardstick;
 32. vins_csv: apps/vins_csv.py at the flagship's size (its sequence of
     simulate(128 poses, 512 landmarks, seed 3) written and read in the
     reference's CSV format, triangulated, perturb 0.02, GN solve(max_iter
     25) in f32 on the banded grid): the cost falls, the ATE within twice
     the JAX app's f64 ATE on the same sequence, exact launches of kernel
     1, K2, segsum, K5b and K5;
 33. math_test: apps/math_test.py --f32 on the card (the Lie Jacobians
     against finite differences, the FOV round trip, the assembly against
     a dense jacrev oracle, a flagship GN iteration timed);
 34. k1_cameras: the flagship sequence (simulate(128, 512, seed 0),
     pose_dim 9, IMU, perturb 0.01, seed 1) re-measured through each
     camera kernel 1 covers besides the FOV camera (`camera_scene`):
     poly3 (the lens of tests/test_camera_models.py, REF_POLY3),
     equidistant, the FOV camera with per-pose intrinsics, and a rig of
     the FOV camera and that poly3 lens 0.11 m apart (landmarks
     referenced to either camera, same-pose cross-camera rows), each
     keeping the rows whose pixel lands in 640 x 480; kernel 1 against its plain version on each, as built, with the
     11 calibration columns and with XYZ landmarks, f64 and f32, with and
     without Jacobians, at a ragged last block;
 35. GN solve_fixed(..., 25) and the dogleg `solve` of each of those
     scenes in f32, with the checks of 6 and 7 (cost and ATE fall, finite,
     exact launches of every kernel), and GN-25 of each in f64 on the
     card (its cost and ATE fall, its ATE at most the f32 GN's); kernel 1
     timed at each scene as in
     11 (with `--parent`, the parent's kernel 1 also at the flagship);
 36. camera_reference: the scenes of ba_tpu's tests/test_camera_models.py
     (poly3, equidistant, per-pose) and tests/test_stereo.py at their own
     sizes, rebuilt with the port alone, f64 `solve(max_iter=15 / 20)`,
     the card against the CPU at TOL_SMALL with the same iterations and
     result code;
 37. vicalib poly3: the calibration service's capture re-projected through
     a poly3 lens: kernel 1's calibration columns (lm_size 3, K = 11,
     poly3) against their plain version and timed at its last stage's
     problem, then the checks of 24 from a lens moved in fx, fy, cx, cy
     and k1 (24 also holds the final mse below the start's).

K2 launches are counted on every path (one (a) per build, one (b) per
trial cost; phase 11 counts one device operation per IMU evaluation, its
whitening included); K5 on every dense path (one per build, and one per
marginalization), K11 once per marginalization, both none on the banded,
PCG and fused-fleet solvers; K5b once per dense build on the banded grid
(gn, dogleg, gps_batch, vins_csv), none on the banded solver.  The last
lines are the `kernels` JSON line, the card's name and power limit, and
{"ok": true, "device": {...}}.  Without a CUDA device, or when
`ba_tpu_torch` is not next to this script, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_POSES, N_LMS, N_ITERS = 128, 512, 25
# the sizes of bench.py's flagship problem
EXPECTED = dict(P=128, L=497, Nr=9696, Ni=127, B=24)

# Kernel tolerances, relative to max(1, max |plain|).  f64: the closed form
# and autodiff differ only in roundoff.  f32: two f32 evaluations through
# ~10^3 operations each.  Segment sums: the same values added in another
# order.
TOL_K1 = {"float64": 1e-10, "float32": 1e-4}
TOL_SEG = {"float64": 1e-12, "float32": 1e-5}
# card vs CPU on the small f64 problem: roundoff amplified by a few solves
# (the CPU tests hold the port to ba_tpu at the same 1e-8)
TOL_SMALL = 1e-8

# the serving path: apps/vins_stream.py at VINS-Mono's EuRoC window and
# density (WINDOW_SIZE 10, max_cnt 150); the table capacities its schedule
# gives, and the slides of 128 keyframes
STREAM = dict(poses=128, lms=2048, window=10, iters=2)
STREAM_EXPECTED = dict(L_w=448, n_proj=2787, n_imu=9, imu_span=11,
                       n_wb=3208, slides=119)
# retired-trajectory ATE of the JAX package at the same configuration in
# f64 on a CPU (`python apps/vins_stream.py --poses 128 --lms 2048
# --window 10 --iters 2 --f64`); the f32 stream on the card may be at most
# twice it
JAX_F64_ATE_M = 0.00126      # printed as 0.126 cm
# kernel launches per slide: 2 GN builds + the marginalization's build
# with Jacobians, 2 trial costs without (kernel 1); one grouped sum per
# build (segsum); K2 (a) per build, (b) per trial
K1_PER_SLIDE, SEG_PER_SLIDE = 5, 3
IMU_A_PER_SLIDE, IMU_B_PER_SLIDE = 3, 2
# K5 per slide: the two GN builds and the marginalization's; K11 once
K5_PER_SLIDE, K11_PER_SLIDE = 3, 1
# the multi-stream server (apps/vins_stream.py --streams): M streams of the
# serving configuration, build seeds 8 + m, capacities from the
# 128-keyframe schedule; reduced: each stream pushes its first 40
# keyframes (31 slides each, 124 in all) for the script's time
STREAM_MANY = dict(streams=4, keyframes=40)
# K5 against its plain version, relative to max(1, max |S|): the same
# products summed in another order; K11 relative to ||H||_F: f64 the same
# function by another algorithm, f32 a Jacobi solve and `eigh` rounding
# differently (~n eps ||H||); K11's f32 output may have no eigenvalue below
# -1e-6 ||H||_F
TOL_K5 = {"float64": 1e-10, "float32": 1e-5}
TOL_K11 = {"float64": 1e-10, "float32": 1e-4}
K11_PSD_F32 = 1e-6
# K11's certificate shift tau / ||H||_F (csrc/marginalize.cu): the clip
# may move a certified H by at most sqrt(#neg) tau, an order of magnitude
# under the tolerances above
K11_TAU = {"float32": 1e-8, "float64": 1e-12}
# vins_window's marginalization (apps/vins_window.py --poses 40 --window
# 10): the whole 40-pose problem, n = 360
K11_WINDOW = dict(poses=40, lms=120)

# the long trajectory (bench_roofline.py:26-44, --what band --poses 2048;
# bench_scaling.py's bandsolve at P = 2048, 10 GN iterations)
LONG = dict(poses=2048, lms=8192, iters=10)
LONG_EXPECTED = dict(P=2048, L=8174, Nr=173603, Nw=181771, Ni=2047, B=24,
                     n_sp=2123334)
# kernel launches per build of the banded solver: segsum twice in
# assemble_blocks (gradient, V, rhs_l and W blocks; then W V^-1 rhs_l), once
# in band_S, once for the Cauchy factor and once for the landmark
# back-substitution; kernel 7 once (band_S, grouped form); kernel 9 once per
# PCG iteration (4)
K2_PER_BANDED_BUILD, K7_PER_BUILD, K9_PER_BUILD = 5, 1, 4
# kernel 7 and kernel 9 against their plain versions, relative to
# max(1, max |plain|): the same products summed in another order
TOL_K7 = {"float64": 1e-12, "float32": 1e-5}
TOL_K9 = {"float64": 1e-12, "float32": 1e-5}
# K8b and K8c against their plain versions on the long band, relative to
# max(1, max |plain|): the kernels' factor (every level's Li, W, V) and
# solve against `bcr_factor_plain` / `bcr_solve_plain`, the kernels' solve
# on the plain factor against the plain solve, the solution x = S^-1 b
# against the solver's plain `_bcr_solve` (torch.linalg), and the scan's
# kernels and both crossed pairings (the kernels' factor with the plain
# solve and the reverse) against `_factor` / `_solve_factored`.  The
# long system is ill-conditioned along its gauge directions, so two exact
# orderings of one factorization differ there by far more than roundoff:
# f64 1.7e-10 (factor) and 1.1e-9 (solve), f32 4.4e-5 and 2.9e-4, while
# the plain factor with the kernels' solve read 5.3e-14 and 1.8e-6 (an
# H100, PR 8's kernels).  The limits sit ~20x above those readings and far
# below the O(1) of a broken kernel: TOL_K8_LONG_F64 for every f64
# difference, TOL_K8_LONG_F32 per kind in f32.  The normwise backward
# error of the kernels' solves may be at most K8_RES_FACTOR times the
# plain solve's in both dtypes: it is not dominated by the gauge.  And on
# a damped copy of the long system (K8_DAMP added to the diagonal of every
# real chunk, which bounds its condition number by the band's largest
# eigenvalue + 1) every difference is held to TOL_K8_DAMPED, the card
# tests' limits
TOL_K8_LONG_F64 = 1e-8
TOL_K8_LONG_F32 = {"factor": 1e-3, "solve": 5e-3, "plain factor": 5e-5}
K8_RES_FACTOR, K8_DAMP = 4.0, 1.0
TOL_K8_DAMPED = {"float64": 1e-12, "float32": 1e-4}
# the long step may differ from the dense solve's by this multiple of the
# same gap on an f32 CPU run of both at 256 poses: the gap lies along the
# near-null gauge directions that the 4-iteration PCG does not converge
STEP_GAP_POSES, STEP_GAP_FACTOR = 256, 3.0

# the matrix-free PCG solver: bench_scaling.py's `cg` solver at its largest
# default size (:18-62; band width left at 0), 10 GN iterations
CG = dict(poses=1024, lms=4096, iters=10, max_it=100, tol=1e-5)
CG_EXPECTED = dict(P=1024, L=4076, Nr=85823, Nw=89896, Ni=1023)
CG_XYZ_ROWS = dict(Nr=89899, Nw=89899)     # the same problem at lm_size 3
# kernel launches per CG build besides the PCG's Schur products (one kernel 6
# and one segsum each): segsum twice in assemble_blocks, once for the
# Cauchy factor, once for the landmark back-substitution
K2_PER_CG_BUILD = 4
# kernels 6 and 10 against their plain versions, relative to
# max(1, max |plain|): the same products summed in another order
TOL_K6 = {"float64": 1e-12, "float32": 1e-5}
TOL_K10 = {"float64": 1e-12, "float32": 1e-5}
# the first PCG step may differ from the dense solve's by this multiple of
# the same gap on an f32 CPU run of both at 256 poses: the PCG stops at a
# relative residual of 1e-5 or 100 iterations
CG_GAP_POSES, CG_GAP_FACTOR = 256, 3.0

# the fused fleet: bench_fleet.py --mode concat at B = 4 flagship windows
# (:50-61, :89-96), apps/fleet_serve.py's fused route, 25 GN iterations
FLEET = dict(vehicles=4, poses=128, lms=512, iters=25)
FLEET_EXPECTED = dict(P=512, L=1988, Nr=38784, Nw=40752, B=24, H=(1, 1))
# segsum launches per dense fleet build: twice in assemble_blocks, once
# for the families' band, once for the Cauchy factor, once for the
# back-substitution; kernel 10 (a) and (b) once each
K2_PER_FLEET_BUILD = 5
# one f32 GN iteration of the fused fleet on the dense fleet solve against
# the chunked banded path (fleet_size 1), as tests/test_fleet.py:120-146:
# the same build (pre_cost relative), two solvers of the same system whose
# steps differ along the near-null gauge directions that the banded
# solver's 4 PCG iterations leave unconverged (post_cost relative, poses.t
# max abs in m)
FLEET_VS_BANDED = dict(pre_cost=1e-6, post_cost=1e-3, poses_t=1e-3)

# K2 (imu_preint) against its plain version: the residuals and integrated
# states relative to the states' scale max(1, max |t|, max |v|) (a residual
# is a difference of two states of that size), the Jacobians and C9 to
# their own max |plain| (C9 is ~1e-6); f64 the same operations in another
# order, f32 through ~10 dependent RK4 steps and the 10 x 10 products.
# Tightened from 1e-11 (f64) and 1e-5 / 2e-4 (f32) to ~20x what the H100
# showed (f32 r <= 5.3e-8, J and C9 <= 3.9e-7; f64 <= 5.4e-16)
TOL_IMU = {"float64": dict(r=1e-13, j=1e-13),
           "float32": dict(r=1e-6, j=1e-5)}

# the full-width self-calibration: the flagship sequence under the
# reference's fullest template configuration <R,1,15,5,true>
# (tests/test_selfcal.py:126-152), intrinsics and T_vs moved as that test
# moves them, the dogleg `solve` with max_iter 40
CALIB_ERR = [2.0, -2.0, 3.0, -2.0, 0.01]
TVS_ROT, TVS_T = [0.01, -0.008, 0.012], [0.01, -0.02, 0.015]
SELFCAL = dict(max_iter=40)
SELFCAL_EXPECTED = dict(P=128, K=11, N=1931, Nr=9696, Ni=127, M=11)

# the calibration service: a synthetic camera-IMU capture (a real one runs
# a minute or more; cut to 15 s): a 6 x 6 tag grid, 300 frames at 20 Hz,
# IMU at 200 Hz, the linear camera TRUE_CAM (tests/test_calibrator.py)
VICALIB = dict(seed=0, tags=6, tag=0.088, gap=0.0264, frames=300,
               imu_hz=200.0, imu_per_frame=10, mse_bound=1e-2)
VICALIB_EXPECTED = dict(rows=43200)
TRUE_CAM = (250.0, 245.0, 320.0, 240.0)

# the GPS + IMU pose-graph smoother (ba_tpu_torch/apps/
# unary_binary_imu_test.py, the reference's applications/
# unary_binary_imu_test): generate_log(600), ten minutes of the app's drive
# (100 Hz IMU, 1 Hz GPS with 0.5 m noise, wheel odometry); the batch
# `solve(max_iter=25, gn_damping=0.2)` in f32 on the banded grid, as the
# reference app runs it; the stream with W = 10 and 6 GN iterations per
# slide (the app's) in f64, reduced to the log's first 120 fixes for the
# script's time.  pose_dim 9, lm_size 0, the reference's covariances: not
# cut
GPS = dict(fixes=600, noise=0.5, stream_fixes=120, window=10, iters=6)
GPS_EXPECTED = dict(P=600, Ni=599, M=101, B=2, Nr=0)
# card against CPU in f64, both at TOL_SMALL: the batch of a 16-fix log
# and its stream with the app's window (GPS["window"]), 7 slides.  Each
# marginalization carries the rounding of one slide into the next through
# priors of condition ~1e10-1e15, so the stream is held on the window the
# app runs, where the card stays within 3e-9 of the CPU over 111 slides
# (profile_port.py --gps-drift); on a W = 4 window the CPU's own stream
# moves by 5e-9 and more between one thread and two, and no other
# rounding order meets 1e-8 there.  The CPU's priors have no negative
# eigenvalue, so K11's certificate (the prior returned unclipped) and the
# CPU's `eigh` clip agree on them
GPS_SMALL = dict(fixes=16, stream_fixes=16, window=GPS["window"])
# the stream's retired track against the f64 batch of the same fixes, RMSE
# in m (tests/test_gps_app.py:88)
GPS_STREAM_RMSE = 0.5

# self-calibration on the matrix-free PCG: the PCG configuration's problem
# (CG) under the reference's fullest template <R,1,15,5,true>, intrinsics
# and T_vs moved as `selfcal` moves them, f32, use_cg_solver (cap 100, tol
# 1e-5), GN solve_fixed(..., 10): the dense S of 15,371 rows (945 MB in f32)
# that the PCG never forms.  Its calibration is compared with a dense GN
# self-calibration of the same problem in f64 on the card (recorded, not
# bounded)
CG_SELFCAL = dict(iters=10, max_it=100, tol=1e-5)
CG_SELFCAL_EXPECTED = dict(P=1024, K=11, N=15371, Nr=85823, Ni=1023)
# cg_selfcal_small: card against CPU in f64 (TOL_SMALL) on simulate(12
# poses, 36 landmarks, seed 13), the CPU tests' scene, at K = 11 (pose_dim
# 15) and K = 5 (pose_dim 9, intrinsics only)
CG_SELFCAL_SMALL = dict(poses=12, lms=36, max_it=400, tol=1e-12)

# the CSV VINS app (apps/vins_csv.py) at the flagship's size: its own
# sequence (simulate(128 poses, 512 landmarks, seed 3)) written and read in
# the reference's CSV format, triangulated, perturb 0.02, GN solve(max_iter
# 25) in f32 on the banded grid; limit: the ATE at most twice the JAX app's
# f64 ATE on the same sequence (1.323 cm: `python apps/vins_csv.py seq
# --generate --poses 128 --lms 512` with JAX_ENABLE_X64=1 on a CPU)
VINS_CSV = dict(poses=128, lms=512, perturb=0.02, max_iter=25)
VINS_CSV_JAX_ATE = 0.01323

# the lenses of ba_tpu's tests/test_camera_models.py (:19-20)
REF_POLY3 = [420.0, 420.0, 320.0, 240.0, -0.28, 0.07, -0.004]
REF_EQUI = [380.0, 380.0, 320.0, 240.0]
POLY3_K = REF_POLY3[4:]
# Kernel 1 for every camera model of ba_tpu's core/camera.py: the flagship
# sequence re-measured four times, through the poly3 lens REF_POLY3 whole
# (in 640 x 480 its r_u stays below 1.4; with the flagship's fx of ~199
# it reaches 2.2, where the r^6 term cancels and f64 GN from the
# perturbed start stalls at a metre of ATE, in ba_tpu as in the port),
# through the equidistant fisheye (the flagship's fx, fy, cx, cy), through
# the FOV camera with per-pose intrinsics (fx, fy scaled by 1 +
# PER_POSE_STEP (i mod 8) at pose i) and as a rig of the FOV camera and
# that poly3 lens RIG_BASELINE m to its right, each keeping the rows whose
# pixel lands in IMG_WH; GN-25 and the dogleg solve of each in f32, and
# GN-25 in f64, its ATE at most the f32 GN's
CAMERA_SCENES = ("poly3", "equidistant", "per_pose", "rig")
RIG_BASELINE, PER_POSE_STEP, IMG_WH = 0.11, 0.02, (640, 480)
# the scenes of ba_tpu's tests/test_camera_models.py and
# tests/test_stereo.py (:24-25), held card against CPU in f64
STEREO_FOV = [198.969, 198.1284, 329.9368, 240.1017, 0.9640582]
STEREO_BASELINE = 0.5
# the calibration service's start: fx, fy, cx, cy (and a poly3 lens's k1)
# moved by this much
VICALIB_MOVE = [15.0, -12.0, 6.0, -5.0, 0.02]

# an earlier tree (`--parent TREE`) whose K5b, kernels 1, 6, 7 and 9 and K8a
# the timings run beside this tree's
PARENT = None

# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# floating-point operations of one reprojection row with Jacobians, counted
# from csrc/reprojection.cu (transfer chain ~185, projection ~70, the 13
# Jacobian columns ~800), and of one calibration column by the chain rule on
# the primal's intermediates (the ray, the transfer rotation, the 2 x 3
# projection Jacobian): an intrinsic moves the projection directly (~8) and
# the reference ray (~20, rotated ~15 and projected ~10); a T_vs tangent
# moves the point at the measuring camera (~10) and the reference point
# through the transfer rotation (~20), projected (~10).  This counts the
# function, not the kernel's dual numbers (which re-run the residual)
K1_FLOPS_PER_ROW = 1055
K1_CAL_FLOPS_INTRINSIC, K1_CAL_FLOPS_TVS = 55, 40
# floating-point operations of K2 (a) by the chain rule, not the kernel's
# forward mode: per RK4 step the primal (~440), the step Jacobian [A | B]
# (10 x 16) from the four stages' sparse Jacobians (the quaternion rows
# 4 x 7, the velocity rows 3 x 4 plus R: ~110 to form, ~250 to apply, ~320
# per stage input, ~800 for the combination, ~150 through the
# normalization: ~3,300) and the products Phi <- A Phi (~2,000), Bsum <- A
# Bsum + B (~1,260) and the symmetric C <- A C A^T + B R B^T / dt (~3,900);
# per span the residual map and its Jacobians (~600) and J1s = Jy Phi J_y0,
# J1b = Jy Bsum and the symmetric C9 = Jy C10 Jy^T (~7,200); (b) the primal
# step and the residual
K2A_FLOPS_PER_STEP, K2A_FLOPS_PER_SPAN = 11000, 7800
K2B_FLOPS_PER_STEP, K2B_FLOPS_PER_SPAN = 440, 100


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        raise SystemExit(1)


def say(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    """(max |got - want|, that over max(1, max |want|))."""
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(1.0, float(want.double().abs().max()))


def event_ms(fn, n):
    """Per-call time of `fn` over n back-to-back calls, CUDA events around
    the loop (host launch cost included, as the solve pays it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, n, reps=5):
    """Device time per call of `fn`: n calls captured in one CUDA graph and
    replayed, so host launch cost drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def parent_package(tree):
    """The package `ba_tpu_torch` of an earlier tree (a `git archive` of
    a commit unpacked under `_archive/`), loaded beside this tree's as
    `ba_tpu_torch_parent` (its kernels build into its own `_build/`), so
    that both trees' kernels are timed in one process."""
    import importlib.util

    name = "ba_tpu_torch_parent"
    if name not in sys.modules:
        root = Path(tree).resolve() / "ba_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


# ---------------------------------------------------------------------------


def phase_build():
    from ba_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    for name, (secs, log) in report.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"build {name}.cu: {secs:.2f} s; ptxas: " + " | ".join(regs))
    say(f"PHASE build ok ({time.perf_counter() - t0:.2f} s)")


def flagship():
    """(f64 problem, f32 problem, config, SimData), both prepared."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver.assemble import band_width_of
    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = BAConfig(pose_dim=9, lm_size=1)
    sim = sv.simulate(n_poses=N_POSES, n_lms=N_LMS, seed=0)
    p64, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p64))
    p32 = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a,
                   p64)
    sizes = dict(P=p32.poses.q.shape[0], L=p32.lms.x.shape[0],
                 Nr=p32.proj.z.shape[0], Ni=int(p32.imu.valid.sum()),
                 B=cfg.band_width)
    say(f"flagship problem {sizes} on {p32.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(sizes == EXPECTED, f"flagship sizes {sizes} != {EXPECTED}")
    return (prepare_landmarks(p64, cfg), prepare_landmarks(p32, cfg), cfg,
            sim)


def cut_rows(p, n):
    """The problem with its first n projection rows."""
    proj = dataclasses.replace(p.proj, **{
        f.name: getattr(p.proj, f.name)[:n].contiguous()
        for f in dataclasses.fields(p.proj)})
    return dataclasses.replace(p, proj=proj)


def k1_against_plain(p, cfg, label):
    """Kernel 1 against its plain version on one problem, with and without
    Jacobians, every output within TOL_K1; returns its max abs error in
    f32 (0 in f64).  An f32 kernel is held to the plain version in f64 on
    the same inputs (cast up, which is exact): the plain version's own f32
    rounding reaches 1e-4 of the largest residual on world points far
    from a pose (its SE(3) chain), the kernel's stays near 1e-5, so the
    f32 plain version is not the yardstick; its distance is printed."""
    import torch

    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.utils.tree import tree_map

    dt = str(p.proj.z.dtype).replace("torch.", "")
    p_ref = p if dt == "float64" else tree_map(
        lambda a: a.double() if a.dtype == torch.float32 else a, p)
    worst = 0.0
    for jac in (True, False):
        got = rp.evaluate(p, cfg, jac)
        want = rp.evaluate_plain(p_ref, cfg, jac)
        plain = None if dt == "float64" else rp.evaluate_plain(p, cfg, jac)
        torch.cuda.synchronize()
        errs, plain_errs = [], []
        for name in want._fields:
            err, rel = rel_err(getattr(got, name), getattr(want, name))
            check(rel <= TOL_K1[dt], f"kernel 1 {label} {dt} jac={jac} "
                  f"{name}: rel err {rel:.3g} > {TOL_K1[dt]:g}")
            worst = max(worst, err) if dt == "float32" else 0.0
            errs.append(f"{name} {rel:.2e}")
            if plain is not None:
                plain_errs.append(rel_err(getattr(plain, name),
                                          getattr(want, name))[1])
        if jac:
            say(f"kernel 1 {label} {dt} Nr={p.proj.z.shape[0]} rel err "
                + ", ".join(errs) + f" (tol {TOL_K1[dt]:g}; without "
                f"Jacobians too"
                + ("" if plain is None else
                   f"; against the plain version in f64 on the same inputs,"
                   f" which the plain version in f32 misses by "
                   f"{max(plain_errs):.2e}")
                + f"); f32 max abs err so far {worst:.3e}")
    return worst


def ragged(p):
    """`p` cut to a row count that leaves kernel 1's last 32-row block
    partly empty."""
    nr = p.proj.z.shape[0] - 5
    return cut_rows(p, nr - (0 if nr % 32 else 1))


def phase_k1(p64, p32, cfg, label="flagship"):
    """Kernel 1 against the plain version, at the problem's rows and at a
    ragged last block; returns the f32 max abs error."""
    worst = max(k1_against_plain(p, cfg, label)
                for p in (p64, p32, ragged(p64), ragged(p32)))
    say(f"PHASE kernel1 ({label}) ok")
    return worst


def capture_build_sums(p, cfg):
    """The grouped segment sum of one build: [(name, vals (n, k), plan,
    ids, nseg)] in launch order, from the build's `AssemblyPlan`."""
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step

    plan = asm.assembly_plan(p, cfg)
    ids = asm.sum_ids(p, cfg)
    names = {id(sp): name for name, sp in plan._asdict().items()
             if name != "band_width"}
    calls = []
    orig = asm.seg_sum_groups

    def record(groups):
        calls.append([(v.reshape(v.shape[0], -1).clone(), sp)
                      for v, sp in groups])
        return orig(groups)

    asm.seg_sum_groups = record
    try:
        asm.assemble(p, cfg, imu_eval=step._imu_eval(p, cfg, True, True),
                     plan=plan)
    finally:
        asm.seg_sum_groups = orig
    check(len(calls) == 1 and len(calls[0]) == 7,
          f"a build made {len(calls)} grouped sums "
          f"({[len(c) for c in calls]} groups), not one of 7")
    return [(names[id(sp)], v, sp, *ids[names[id(sp)]])
            for v, sp in calls[0]]


def _seg_check(dt, what, got, again, vals, ids, nseg):
    """One sum of segsum against `_seg_sum_plain` in f64 and against a
    second launch; returns the max abs error."""
    import torch

    from ba_tpu_torch.solver.assemble import _seg_sum_plain

    want = _seg_sum_plain(vals.double(), ids, nseg)
    err, rel = rel_err(got, want)
    same = bool(torch.equal(got, again))
    say(f"segsum {dt} {what} n={vals.shape[0]} k={vals.shape[1]} "
        f"nseg={nseg}: max abs err {err:.3e} rel {rel:.3e} "
        f"(tol {TOL_SEG[dt]:g}); bit-identical relaunch {same}")
    check(rel <= TOL_SEG[dt], f"segsum {what}: rel err {rel:.3g}")
    check(same, f"segsum {what}: two launches differ")
    return err


def phase_segsum(sums, label="flagship", extras=True):
    """segsum against the plain version + determinism: the seven sums of
    a build in one grouped launch (f32 and f64); with `extras`,
    out-of-range ids and a 2,100-row segment through one-group plans.
    Returns the f32 max abs error."""
    import numpy as np
    import torch

    from ba_tpu_torch.kernels import segsum

    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        groups = [(v.to(dtype), sp) for _, v, sp, _, _ in sums]
        a = segsum.seg_sum_grouped(groups)
        b = segsum.seg_sum_grouped(groups)
        torch.cuda.synchronize()
        for (name, v, _, ids, nseg), x, y in zip(sums, a, b):
            err = _seg_check(dt, f"{label} grouped launch, {name}", x, y, v,
                            ids, nseg)
            if dt == "float32":
                worst = max(worst, err)
    if not extras:
        say(f"PHASE segsum ({label}) ok")
        return worst

    # out-of-range ids drop their rows (the flagship build has none)
    _, v, _, ids, nseg = sums[0]
    bad = ids.clone()
    bad[::5] = -1
    bad[1::7] = nseg + 3
    # one segment of ~2,140 rows: ~67 chunks, combined by the last to finish
    rng = np.random.default_rng(0)
    long_ids = rng.integers(0, 700, 30000)
    long_ids[rng.choice(30000, 2100, replace=False)] = 350
    long_ids = torch.as_tensor(long_ids, device=v.device)
    long_v = torch.as_tensor(rng.standard_normal((30000, 9)),
                             dtype=torch.float32, device=v.device)
    check(int((long_ids == 350).sum()) >= 2000, "long segment too short")
    for vals, ids_, nseg_, what in ((v, bad, nseg, "out-of-range ids"),
                                    (long_v, long_ids, 700,
                                     "2,100-row segment")):
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            x = segsum.seg_sum(vals.to(dtype), ids_, nseg_)
            y = segsum.seg_sum(vals.to(dtype), ids_, nseg_)
            torch.cuda.synchronize()
            err = _seg_check(dt, what, x, y, vals, ids_, nseg_)
            if dt == "float32":
                worst = max(worst, err)
    say(f"PHASE segsum ({label}) ok")
    return worst


def phase_small_reference():
    """The port on the card against the port on the CPU, f64, small."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import band_width_of

    sim = sv.simulate(n_poses=12, n_lms=48, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                   device=dev)
        cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
        pg, costs, dns = step.solve_fixed(prepare_landmarks(p, cfg), cfg,
                                          True, 5)
        pd, summ = step.solve(p, dataclasses.replace(cfg, use_dogleg=True),
                              max_iter=10)
        out[dev] = (pg, costs, dns, pd, summ)
    g, c = out["cuda"], out["cpu"]
    pairs = [("GN costs", g[1], c[1]), ("GN delta norms", g[2], c[2]),
             ("GN poses.t", g[0].poses.t, c[0].poses.t),
             ("GN lms.x", g[0].lms.x, c[0].lms.x),
             ("dogleg poses.t", g[3].poses.t, c[3].poses.t),
             ("dogleg lms.x_w", g[3].lms.x_w, c[3].lms.x_w),
             ("dogleg final cost", torch.tensor(g[4].final_cost),
              torch.tensor(c[4].final_cost))]
    for name, a, b in pairs:
        _, rel = rel_err(a.cpu(), b)
        say(f"card vs CPU, 12 poses f64: {name} rel err {rel:.3e} "
            f"(tol {TOL_SMALL:g})")
        check(rel <= TOL_SMALL, f"card vs CPU {name}: {rel:.3g}")
    same_path = (g[4].iterations, g[4].result, g[4].inner_iterations) == (
        c[4].iterations, c[4].result, c[4].inner_iterations)
    say(f"card vs CPU dogleg path: {g[4].iterations} iterations, "
        f"{g[4].result} (CPU {c[4].iterations}, {c[4].result})")
    check(same_path, "dogleg took another accept/reject path on the card")
    say("PHASE small-reference ok")


def _counters_zero():
    from ba_tpu_torch.kernels import (band_matvec, band_schur, band_to_dense,
                                      chunk_tridiag, fleet_schur,
                                      imu_preint, marginalize, reprojection,
                                      schur_finish, schur_matvec, segsum)
    from ba_tpu_torch.utils.sync import item

    reprojection.reprojection.launches = 0
    imu_preint.imu_full.launches = 0
    imu_preint.imu_residual.launches = 0
    segsum.seg_sum_grouped.launches = 0
    band_schur.band_schur.launches = 0
    band_matvec.band_matvec.launches = 0
    schur_matvec.schur_matvec.launches = 0
    schur_matvec.schur_pack.launches = 0
    fleet_schur.fleet_schur.launches = 0
    schur_finish.schur_finish.launches = 0
    marginalize.marginalize_prior.launches = 0
    band_to_dense.band_to_dense.launches = 0
    for fn in K8_WRAPPERS:
        getattr(chunk_tridiag, fn).launches = 0
    item.count = 0


# K8's wrappers, each counting its own kernel launches
K8_WRAPPERS = ("chunk_layout", "bcr_factor", "scan_factor", "bcr_solve",
               "scan_solve")


def _k8_counters():
    """{wrapper: launches} of K8 since `_counters_zero`."""
    from ba_tpu_torch.kernels import chunk_tridiag

    return {fn: getattr(chunk_tridiag, fn).launches for fn in K8_WRAPPERS}


def _k8_want(cfg, P, builds, solves_per_build=5):
    """K8's launches for `builds` builds of the banded solver on a P-pose
    problem: one layout, the factor's (three per cyclic-reduction level and
    one for the base, or one scan) and the solves' (four per level and two
    for the base, or two for the scan) per build."""
    from ba_tpu_torch.kernels import chunk_tridiag
    from ba_tpu_torch.solver import banded

    _, _, _, n_c = banded.chunk_geometry(cfg, P, cfg.band_width)
    want = dict.fromkeys(K8_WRAPPERS, 0)
    want["chunk_layout"] = builds
    if cfg.banded_cyclic_reduction and n_c >= 4:
        lv = chunk_tridiag.next_pow2(n_c).bit_length() - 1
        want["bcr_factor"] = builds * (3 * lv + 1)
        want["bcr_solve"] = builds * solves_per_build * (4 * lv + 2)
    else:
        want["scan_factor"] = builds
        want["scan_solve"] = builds * solves_per_build * 2
    return want


def _k5b_count():
    """K5b launches since `_counters_zero`."""
    from ba_tpu_torch.kernels import band_to_dense

    return band_to_dense.band_to_dense.launches


def _linalg_calls(run):
    """(run(), calls of a torch.linalg factor or triangular solve made
    during it): cholesky, cholesky_ex, solve_triangular, cholesky_solve."""
    import torch

    calls = [0]
    saved = [(torch.linalg, n) for n in ("cholesky", "cholesky_ex",
                                          "solve_triangular")]
    saved.append((torch, "cholesky_solve"))
    orig = [getattr(m, n) for m, n in saved]

    def counting(fn):
        def wrapped(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapped

    for (m, n), fn in zip(saved, orig):
        setattr(m, n, counting(fn))
    try:
        out = run()
    finally:
        for (m, n), fn in zip(saved, orig):
            setattr(m, n, fn)
    return out, calls[0]


def _imu_counters():
    """(K2 (a), K2 (b)) launches since `_counters_zero`."""
    from ba_tpu_torch.kernels import imu_preint

    return imu_preint.imu_full.launches, imu_preint.imu_residual.launches


def _band_counters():
    """(kernel 7, kernel 9) launches since `_counters_zero`."""
    from ba_tpu_torch.kernels import band_matvec, band_schur

    return band_schur.band_schur.launches, band_matvec.band_matvec.launches


def _counters():
    from ba_tpu_torch.kernels import reprojection, segsum
    from ba_tpu_torch.utils.sync import item

    return (reprojection.reprojection.launches,
            segsum.seg_sum_grouped.launches, item.count)


def _sync_count(run):
    """Run `run()` with PyTorch's sync debug mode on; returns (result,
    number of synchronizing operations it reported)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing" in str(w.message) for w in caught)
    return out, n


def _ate(p, sim):
    from ba_tpu_torch.io import simulate_vins as sv

    return sv.ate(None, p.poses.t.double().cpu().numpy(), None, sim.t_wv)


def _finite(p):
    import torch

    return all(bool(torch.isfinite(t).all())
               for t in (p.poses.q, p.poses.t, p.poses.v, p.lms.x))


def plan_syncs(p32, cfg, smi):
    """Host syncs of building the segment plans of a solve (once per
    solve): the first build in the process, then a later one, which is
    what each solve of the drivers below pays."""
    import torch

    from ba_tpu_torch.solver.assemble import assembly_plan

    def run():
        out = assembly_plan(p32, cfg)
        torch.cuda.synchronize()
        return out

    first, again = _sync_count(run)[1], _sync_count(run)[1]
    say(f"[{smi}] segment plans of a solve: {first} host syncs at the "
        f"process's first build, {again} at a later one")
    return again


def phase_gn(p32, cfg, sim, smi, n_plan_syncs, label=""):
    """GN solve_fixed(..., 25) in f32 (of the flagship, or of the problem
    `label` names)."""
    import torch

    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    cfg = dataclasses.replace(cfg, use_dogleg=False)
    cost0 = float(evaluate_cost(p32, cfg, step._imu_eval(p32, cfg, True,
                                                         False)))
    ate0 = _ate(p32, sim)

    def run():
        out = step.solve_fixed(p32, cfg, True, N_ITERS)
        torch.cuda.synchronize()
        return out

    warm, syncs = _sync_count(run)                    # warm-up
    _counters_zero()
    t0 = time.perf_counter()
    p, costs, dns = run()
    secs = time.perf_counter() - t0
    k1, k2, reads = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    k5b = _k5b_count()

    costs_h = costs.double().cpu()
    ate1 = _ate(p, sim)
    ok0 = bool(step._build_and_solve(p32, cfg, True).step.ok)
    ok1 = bool(step._build_and_solve(p, cfg, True).step.ok)
    say(f"{label}GN solve_fixed({N_ITERS}) f32: cost {cost0:.6g} -> "
        f"{float(costs_h[-1]):.6g}, ATE {ate0:.6g} -> {ate1:.6g} m, "
        f"solver_ok at start/end {ok0}/{ok1}, kernel launches "
        f"reprojection {k1} segsum {k2} imu_preint (a) {ia} (b) {ib} "
        f"schur_finish {k5} marginalize {k11} band_to_dense {k5b}, "
        f"bit-identical to the warm-up run {torch.equal(costs, warm[1])}")
    check(bool(torch.isfinite(costs_h).all()) and _finite(p),
          f"{label}GN: non-finite values")
    check(float(costs_h[-1]) < cost0, f"{label}GN: cost did not fall")
    check(ate1 < ate0, f"{label}GN: ATE did not fall")
    check(ok0 and ok1, f"{label}GN: reduced factorization failed")
    check(k1 == 2 * N_ITERS, f"{label}GN: {k1} reprojection launches, "
          f"expected {2 * N_ITERS} (one build + one trial per iteration)")
    check(k2 == N_ITERS, f"{label}GN: {k2} segsum launches, expected "
          f"{N_ITERS} (one per build)")
    check((ia, ib) == (N_ITERS, N_ITERS), f"{label}GN: imu_preint launches "
          f"({ia}, {ib}), expected one (a) per build, one (b) per trial")
    check((k5, k11) == (N_ITERS, 0), f"{label}GN: schur_finish, marginalize "
          f"launches ({k5}, {k11}), expected ({N_ITERS}, 0)")
    check(k5b == N_ITERS, f"{label}GN: {k5b} band_to_dense launches, expected "
          f"{N_ITERS} (one per build on the banded grid)")
    kf = N_POSES * N_ITERS / secs
    say(f"[{smi}] {label}GN solve_fixed({N_ITERS}): {secs * 1e3:.1f} ms, "
        f"{kf:.1f} kf/s; host syncs {syncs}: the plan's {n_plan_syncs} "
        f"once, then {(syncs - n_plan_syncs) / N_ITERS:.2f} per iteration "
        f"(counted reads {reads})")
    say(f"PHASE {label}gn ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, k5b=k5b, kf_s=kf, syncs=syncs, iters=N_ITERS,
                ate=ate1)


def phase_dogleg(p32, cfg, sim, smi, n_plan_syncs, label=""):
    """The default dogleg `solve` in f32 (of the flagship, or of the
    problem `label` names)."""
    import torch

    from ba_tpu_torch.solver import step

    cfg = dataclasses.replace(cfg, use_dogleg=True)
    ate0 = _ate(p32, sim)

    def run():
        out = step.solve(p32, cfg, max_iter=N_ITERS)
        torch.cuda.synchronize()
        return out

    (_, warm), syncs = _sync_count(run)               # warm-up
    _counters_zero()
    t0 = time.perf_counter()
    p, s = run()
    secs = time.perf_counter() - t0
    k1, k2, reads = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    k5b = _k5b_count()

    ate1 = _ate(p, sim)
    # host reads: one for use_imu, then per iteration one per inner trial
    # and one for the status; reprojection launches: one build per
    # iteration, one per trial, one for the error breakdown
    trials = reads - 1 - s.iterations
    say(f"{label}dogleg solve f32: {s.iterations} iterations ({trials} "
        f"trials), "
        f"{s.result}, cost {s.initial_cost:.6g} -> {s.final_cost:.6g}, "
        f"ATE {ate0:.6g} -> {ate1:.6g} m, kernel launches reprojection "
        f"{k1} segsum {k2} imu_preint (a) {ia} (b) {ib} schur_finish {k5} "
        f"marginalize {k11} band_to_dense {k5b}, same as the warm-up "
        f"run "
        f"{(s.iterations, s.final_cost) == (warm.iterations, warm.final_cost)}")
    check(s.is_good, f"{label}dogleg: result {s.result}")
    check(_finite(p) and torch.isfinite(torch.tensor(s.final_cost)),
          f"{label}dogleg: non-finite values")
    check(s.final_cost < s.initial_cost, f"{label}dogleg: cost did not fall")
    check(ate1 < ate0, f"{label}dogleg: ATE did not fall")
    check(k1 == s.iterations + trials + 1,
          f"{label}dogleg: {k1} reprojection launches, expected "
          f"{s.iterations + trials + 1}")
    check(k2 == s.iterations, f"{label}dogleg: {k2} segsum launches, "
          f"expected {s.iterations} (one per build)")
    # K2: (a) per build, (b) per trial, and one of each for the error
    # breakdown (its cost-only evaluation has no cached covariance)
    check((ia, ib) == (s.iterations + 1, trials + 1),
          f"{label}dogleg: imu_preint launches ({ia}, {ib}), expected "
          f"({s.iterations + 1}, {trials + 1})")
    check((k5, k11) == (s.iterations, 0), f"{label}dogleg: schur_finish, "
          f"marginalize launches ({k5}, {k11}), expected "
          f"({s.iterations}, 0): one K5 per build")
    check(k5b == s.iterations, f"{label}dogleg: {k5b} band_to_dense launches, "
          f"expected {s.iterations} (one per build)")
    kf = N_POSES * s.iterations / secs
    say(f"[{smi}] {label}dogleg solve: {secs * 1e3:.1f} ms, {kf:.1f} kf/s; "
        f"host "
        f"syncs {syncs}: the plan's {n_plan_syncs} once, then "
        f"{(syncs - n_plan_syncs) / s.iterations:.2f} per iteration "
        f"(counted reads {reads})")
    say(f"PHASE {label}dogleg ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, k5b=k5b, kf_s=kf, syncs=syncs, iters=s.iterations)


def _compare(pairs, what, tol):
    """Card tensors against CPU tensors: each rel err <= tol."""
    for name, a, b in pairs:
        _, rel = rel_err(a.cpu(), b)
        say(f"card vs CPU, {what}: {name} rel err {rel:.3e} (tol {tol:g})")
        check(rel <= tol, f"card vs CPU {what} {name}: {rel:.3g}")


def phase_general_small():
    """The general assembly path on the card against the CPU, f64, small:
    one build and one marginalization on the build's plan."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step, window

    sim = sv.simulate(n_poses=12, n_lms=48, seed=0)
    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    out = {}
    for dev in ("cuda", "cpu"):
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                   device=dev)
        p = prepare_landmarks(p, cfg)
        plan = asm.assembly_plan(p, cfg)
        check(plan.band_width == 0, "general_small: not the general path")
        _counters_zero()
        a = asm.assemble(p, cfg, imu_eval=step._imu_eval(p, cfg, True, True),
                         plan=plan)
        drop = torch.arange(p.poses.q.shape[0], device=dev) == 2
        m = window.marginalize(p, cfg, True, drop, plan)
        out[dev] = (a, m, _counters()[:2] + _marg_counters())
    (ga, gm, counts), (ca, cm, _) = out["cuda"], out["cpu"]
    _compare([(n, getattr(ga, n), getattr(ca, n))
              for n in ("S", "rhs_sc", "cost", "U", "W", "V")]
             + [("marginalize H", gm.H, cm.H), ("marginalize g", gm.g, cm.g)],
             "general path, 12 poses f64", TOL_SMALL)
    say(f"general_small kernel launches on the card: reprojection "
        f"{counts[0]} segsum {counts[1]} schur_finish {counts[2]} "
        f"marginalize {counts[3]}")
    check(counts == (2, 2, 2, 1), f"general_small: launches {counts}, "
          "expected one of kernel 1, segsum and K5 per build (assemble, "
          "marginalize) and one K11")
    say("PHASE general_small ok")


def phase_ring_small():
    """Four slides of `run_ring` on the card against the CPU, f64."""
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import fixedlag

    sim = sv.simulate(n_poses=16, n_lms=64, seed=2)
    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    out = {}
    for dev in ("cuda", "cpu"):
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=3,
                                   with_marg_prior=False, device=dev)
        sched = fixedlag.build_ring_schedule(prepare_landmarks(p, cfg), cfg,
                                             5, 4)
        _counters_zero()
        out[dev] = fixedlag.run_ring(sched, cfg, True, 2) + (
            _counters()[:2] + _marg_counters(),)
    (gc, go, counts), (cc, co, _) = out["cuda"], out["cpu"]
    _compare([(f"retired {k}", go[k], co[k]) for k in go]
             + [(f"final carry {n}", g, c)
                for n, g, c in zip("qtvbx", gc[:5], cc[:5])]
             + [("final prior H", gc[5].H, cc[5].H)],
             "ring, 4 slides f64", TOL_SMALL)
    want = (4 * K1_PER_SLIDE, 4 * SEG_PER_SLIDE, 4 * K5_PER_SLIDE,
            4 * K11_PER_SLIDE)
    check(counts == want, f"ring_small: launches {counts} over 4 slides, "
          f"expected {want}")
    say("PHASE ring_small ok")


def phase_stream(smi):
    """The serving path at full width, f32, through
    `StreamingRing.push(block=False)`; returns its numbers, and the
    schedule and config for the kernel phases at a slide's shapes."""
    import numpy as np
    import torch

    from ba_tpu_torch.apps.vins_stream import (add_keyframe, stream_feed,
                                               stream_problem, wait)
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.kernels.marginalize import Branches as K11Branches
    from ba_tpu_torch.solver import fixedlag
    from ba_tpu_torch.solver.streaming import RingCapacities, StreamingRing

    t0 = time.perf_counter()
    problem, cfg, sim = stream_problem(STREAM["poses"], STREAM["lms"])
    W = STREAM["window"]
    n_slides = STREAM["poses"] - W + 1
    sched = fixedlag.build_ring_schedule(problem, cfg, W, n_slides)
    caps = RingCapacities.from_schedule(sched)
    sizes = dict(L_w=caps.L_w, n_proj=caps.n_proj, n_imu=caps.n_imu,
                 imu_span=caps.imu_span, n_wb=caps.n_wb, slides=n_slides)
    live_lms = sched.inputs["lm_active"].sum(1).double()
    live_rows = sched.inputs["proj_valid"].sum(1).double()
    say(f"stream configuration {STREAM}: capacities {sizes}; per window "
        f"{float(live_lms.mean()):.1f} live landmarks (max "
        f"{int(live_lms.max())}), {float(live_rows.mean()):.1f} valid "
        f"projection rows (max {int(live_rows.max())}); problem and batch "
        f"schedule built in {time.perf_counter() - t0:.2f} s")
    check(sizes == STREAM_EXPECTED, f"stream sizes {sizes} != "
          f"{STREAM_EXPECTED}")

    feed = stream_feed(problem)
    dev = problem.poses.t.device
    ring = StreamingRing(cfg, W, problem.rig, problem.g_vec, caps,
                         use_imu=True, iters_per_slide=STREAM["iters"],
                         dtype=np.float32)
    outs, syncs = [], []
    _counters_zero()
    with K11Branches() as kb:
        t0 = time.perf_counter()
        for g in range(STREAM["poses"]):
            add_keyframe(ring, feed, g)
            if outs:
                out, n = _sync_count(lambda: ring.push(block=False))
                syncs.append(n)
            else:
                out = ring.push(block=False)
                if out is not None:
                    wait(dev)
                    t_first = time.perf_counter() - t0
                    t0 = time.perf_counter()
            if out is not None:
                outs.append(out)
        wait(dev)
        t_steady = time.perf_counter() - t0
    branches = kb.read()
    k1, k2, _ = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()

    n = len(outs)
    n_steady = n - 1
    costs = torch.stack([o["cost"] for o in outs]).double().cpu()
    t_est = torch.stack([o["t"] for o in outs]).double().cpu().numpy()
    ate = sv.ate(None, t_est, None, sim.t_wv[:n])
    kf_s = n_steady / t_steady
    ms_slide = 1e3 * t_steady / n_steady
    say(f"[{smi}] stream f32: {n} keyframes retired; first push (builds "
        f"and warm-up included) {t_first:.2f} s; steady state "
        f"{kf_s:.3f} keyframes/s, {ms_slide:.1f} ms per slide over "
        f"{n_steady} slides; host syncs per steady push min {min(syncs)} "
        f"max {max(syncs)} total {sum(syncs)}; kernel launches "
        f"reprojection {k1} ({k1 / n:.2f} per slide) segsum {k2} "
        f"({k2 / n:.2f} per slide) imu_preint (a) {ia} (b) {ib} "
        f"schur_finish {k5} marginalize {k11}")
    say(f"stream f32: K11's certificate settled {branches['certified']} "
        f"of {branches['marginalizations']} marginalizations (the Jacobi "
        f"clip ran on the rest, {branches['clipped']} of them clipping an "
        f"eigenvalue); every info ok {branches['ok']}")
    say(f"stream f32: retired-trajectory ATE {ate:.6g} m (bound "
        f"{2 * JAX_F64_ATE_M:g} m, twice the JAX f64 CPU ATE); last slide "
        f"cost {float(costs[-1]):.6g}; costs finite "
        f"{bool(torch.isfinite(costs).all())}")
    check(n == n_slides, f"stream: {n} keyframes retired, not {n_slides}")
    check(bool(torch.isfinite(costs).all()) and np.isfinite(t_est).all(),
          "stream: non-finite costs or states")
    check(ate <= 2 * JAX_F64_ATE_M, f"stream: ATE {ate:.6g} m > "
          f"{2 * JAX_F64_ATE_M:g} m")
    check((k1, k2) == (K1_PER_SLIDE * n, SEG_PER_SLIDE * n),
          f"stream: launches ({k1}, {k2}), expected "
          f"({K1_PER_SLIDE * n}, {SEG_PER_SLIDE * n})")
    check((ia, ib) == (IMU_A_PER_SLIDE * n, IMU_B_PER_SLIDE * n),
          f"stream: imu_preint launches ({ia}, {ib}), expected "
          f"({IMU_A_PER_SLIDE * n}, {IMU_B_PER_SLIDE * n})")
    check((k5, k11) == (K5_PER_SLIDE * n, K11_PER_SLIDE * n),
          f"stream: schur_finish, marginalize launches ({k5}, {k11}), "
          f"expected ({K5_PER_SLIDE * n}, {K11_PER_SLIDE * n})")
    check(max(syncs) == 0, f"stream: {max(syncs)} host syncs in a steady "
          f"push (K11 replaced the eigh that made one)")
    say("PHASE stream ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, slides=n, k11_branches=branches,
                kf_s=kf_s, ms_slide=ms_slide,
                syncs_per_push=sum(syncs) / len(syncs), ate=ate,
                last_cost=float(costs[-1])), sched, cfg


def stream_slide(sched, cfg):
    """(f64 problem, f32 problem) of the stream's first slide.  The f64
    copy renormalizes its quaternions: cast from f32 they are unit only to
    f32 roundoff, and kernel 1 and the plain version rotate with formulas
    that agree only on unit quaternions (a 5e-7 relative gap otherwise)."""
    import torch

    from ba_tpu_torch.core import lie
    from ba_tpu_torch.solver import fixedlag
    from ba_tpu_torch.utils.tree import tree_map

    p32 = fixedlag.slide_problem(sched.carry0,
                                 fixedlag.slide_inputs(sched.inputs, 0),
                                 sched.rig, sched.g_vec, sched.L_w)
    p64 = tree_map(lambda a: a.double() if a.dtype == torch.float32 else a,
                   p32)
    p64 = dataclasses.replace(
        p64,
        poses=dataclasses.replace(p64.poses,
                                  q=lie.quat_normalize(p64.poses.q)),
        rig=dataclasses.replace(p64.rig,
                                tvs_q=lie.quat_normalize(p64.rig.tvs_q)))
    return p64, p32


def phase_timing(p32, cfg, sums, smi, label="flagship"):
    """Per-kernel times at one main path's shapes, beside the launch
    floor, their bounds, their plain versions and the library
    yardstick."""
    import torch

    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.kernels import reprojection as k1
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver.assemble import _seg_sum_plain, assembly_plan

    one = torch.zeros((1,), device=p32.poses.t.device)
    floor_ms = graph_ms(lambda: one.add_(1), 50)
    say(f"[{smi}] launch floor (a one-element add, CUDA-graph replay): "
        f"{floor_ms:.4f} ms")

    pr, poses, lms, rig = p32.proj, p32.poses, p32.lms, p32.rig
    outs = k1.reprojection(p32, True)
    k1_bytes = nbytes(pr.z, pr.pose, pr.lm, pr.cam, pr.valid, poses.q,
                      poses.t, lms.x, lms.ref_pose, lms.ref_cam, rig.params,
                      rig.model, rig.tvs_q, rig.tvs_t, *outs)
    rows = int(pr.valid.sum())
    k1_flops = K1_FLOPS_PER_ROW * rows
    k1_bound = max(k1_bytes / HBM_BPS, k1_flops / F32_FLOPS) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BPS >= k1_flops / F32_FLOPS \
        else "operations"
    t = dict(
        ms=event_ms(lambda: k1.reprojection(p32, True), 200),
        device_ms=graph_ms(lambda: k1.reprojection(p32, True), 50),
        resid_ms=event_ms(lambda: k1.reprojection(p32, False), 200),
        resid_device_ms=graph_ms(lambda: k1.reprojection(p32, False), 50),
        plain_ms=event_ms(lambda: rp.evaluate_plain(p32, cfg, True), 10))
    say(f"[{smi}] kernel 1 reprojection, {label}, Nr={pr.z.shape[0]} "
        f"({rows} valid) f32: "
        f"{t['ms']:.4f} ms per call ({t['device_ms']:.4f} ms on the device, "
        f"{t['device_ms'] / floor_ms:.2f}x the launch floor "
        f"{floor_ms:.4f} ms, {k1_bound / t['device_ms']:.1%} of the bound; "
        f"residual only {t['resid_ms']:.4f} ms, {t['resid_device_ms']:.4f} "
        f"ms on the device), plain {t['plain_ms']:.3f} ms, bound "
        f"{k1_bound:.5f} ms ({k1_by}: {k1_bytes} B, {k1_flops} flop)")
    rec1 = dict(ms=t["ms"], device_ms=t["device_ms"],
                resid_device_ms=t["resid_device_ms"], floor_ms=floor_ms,
                plain_ms=t["plain_ms"], bound_ms=k1_bound, bound_by=k1_by,
                library_ms=None)
    if PARENT is not None:
        import importlib

        parent_package(PARENT)
        k1p = importlib.import_module(
            "ba_tpu_torch_parent.kernels.reprojection")
        rec1["parent_ms"] = event_ms(lambda: k1p.reprojection(p32, True),
                                     200)
        rec1["parent_device_ms"] = graph_ms(
            lambda: k1p.reprojection(p32, True), 50)
        say(f"[{smi}] kernel 1 reprojection, {label}: the parent's kernel "
            f"on the same inputs {rec1['parent_ms']:.4f} ms per call "
            f"({rec1['parent_device_ms']:.4f} ms on the device); this "
            f"tree's {t['ms']:.4f} ({t['device_ms']:.4f})")

    k2_bytes = k2_ops = 0
    for _, vals, _, ids, nseg in sums:
        k2_bytes += nbytes(vals, ids) + nseg * vals.shape[1] * \
            vals.element_size()
        k2_ops += int(((ids >= 0) & (ids < nseg)).sum()) * vals.shape[1]
    check(all(bool(((i >= 0) & (i < n)).all()) for *_, i, n in sums),
          f"{label} segment ids out of range (index_add_ yardstick)")
    groups = [(v, sp) for _, v, sp, _, _ in sums]

    def seven(fn):
        return lambda: [fn(v, i, n) for _, v, _, i, n in sums]

    def library(v, i, n):
        return torch.zeros((n, v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add_(0, i, v)

    k2_bound = max(k2_bytes / HBM_BPS, k2_ops / F32_FLOPS) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BPS >= k2_ops / F32_FLOPS \
        else "operations"
    t2 = dict(ms=event_ms(lambda: segsum.seg_sum_grouped(groups), 100),
              device_ms=graph_ms(lambda: segsum.seg_sum_grouped(groups), 20),
              plan_ms=event_ms(lambda: assembly_plan(p32, cfg), 10),
              plain_ms=event_ms(seven(_seg_sum_plain), 10),
              library_ms=event_ms(seven(library), 100),
              library_device_ms=graph_ms(seven(library), 20))
    shapes = ", ".join(f"{v.shape[0]}x{v.shape[1]}->{n}"
                       for _, v, _, _, n in sums)
    say(f"[{smi}] segsum, {label}, the seven sums of one build in "
        f"one launch ({shapes}) f32: {t2['ms']:.4f} ms per build "
        f"({t2['device_ms']:.4f} ms on the device, "
        f"{k2_bound / t2['device_ms']:.2%} of the bound); index_add_ "
        f"{t2['library_ms']:.4f} ms per build ({t2['library_device_ms']:.4f} "
        f"ms on the device); plain {t2['plain_ms']:.3f} ms; the plans' "
        f"one-off build {t2['plan_ms']:.4f} ms; bound {k2_bound:.5f} ms "
        f"({k2_by}: {k2_bytes} B, {k2_ops} adds); launch floor "
        f"{floor_ms:.4f} ms")
    rec2 = dict(ms=t2["ms"], device_ms=t2["device_ms"],
                plan_ms=t2["plan_ms"], plain_ms=t2["plain_ms"],
                bound_ms=k2_bound, bound_by=k2_by,
                library_ms=t2["library_ms"],
                library_device_ms=t2["library_device_ms"])
    say(f"PHASE timing ({label}) ok")
    return rec1, rec2


# ---------------------------------------------------------------------------
# The banded solvers


def _random_prior(p, scale, seed):
    """`p` with an active random dense marginalization prior (H PSD)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = p.marg.H.shape[0]
    A = rng.standard_normal((n, n)) * scale
    kw = dict(dtype=p.marg.H.dtype, device=p.marg.H.device)
    marg = dataclasses.replace(
        p.marg, H=torch.as_tensor(A @ A.T, **kw),
        g=torch.as_tensor(rng.standard_normal(n) * scale, **kw),
        lin_t=p.marg.lin_t + 0.01 * scale,
        active=torch.ones((), dtype=torch.bool, device=p.marg.H.device))
    return dataclasses.replace(p, marg=marg)


def phase_banded_small():
    """The banded solvers on the card against the CPU in f64, on
    simulate(80 poses, 200 landmarks) (band width 24, four chunks)."""
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import banded, cg, step
    from ba_tpu_torch.solver.assemble import band_width_of

    sim = sv.simulate(n_poses=80, n_lms=200, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                       use_banded_solver=True)
        raw, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                     with_marg_prior=False, device=dev)
        cfg = dataclasses.replace(cfg, band_width=band_width_of(raw))
        p = prepare_landmarks(raw, cfg)
        P, D = p.poses.q.shape[0], cfg.pose_dim
        bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                                   with_precond=False)
        _counters_zero()
        r = {}
        cfgs = (("cyclic reduction", cfg),
                ("scan", dataclasses.replace(cfg,
                                             banded_cyclic_reduction=False)))
        linalg = 0
        for name, c in cfgs:
            s, calls = _linalg_calls(
                lambda: banded.solve_reduced_banded(p, c, bs, P, D))
            linalg += calls
            r[f"{name} delta_p"], r[f"{name} delta_l"] = s.delta_p, s.delta_l
            r[f"{name} ok"] = s.ok
        k8 = _k8_counters()
        k8_want = {k: sum(_k8_want(c, P, 1)[k] for _, c in cfgs)
                   for k in K8_WRAPPERS}
        old = banded._GROUPED_SP_MIN
        banded._GROUPED_SP_MIN = 0
        try:
            r["grouped band_S"] = banded.band_S(p, cfg, bs, P, D)
            r["grouped delta_p"] = banded.solve_reduced_banded(
                p, cfg, bs, P, D).delta_p
        finally:
            banded._GROUPED_SP_MIN = old
        # schur_on_band with an active marginalization prior
        pm, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                    device=dev)
        pm = prepare_landmarks(_random_prior(pm, 0.05, 3), cfg)
        cfg_s = dataclasses.replace(cfg, use_banded_solver=False,
                                    schur_on_band=True)
        check(step._reduced_path(pm, cfg_s)[0] == "schur_on_band",
              "banded_small: not the schur_on_band path")
        built = step._build_and_solve(pm, cfg_s, True)
        r["schur_on_band delta_p"] = built.step.delta_p
        r["schur_on_band delta_l"] = built.step.delta_l
        r["schur_on_band ok"] = built.step.ok
        counts = _band_counters()
        pd, summ = step.solve(raw, dataclasses.replace(cfg, use_dogleg=True),
                              max_iter=10)
        r["dogleg poses.t"] = pd.poses.t
        r["dogleg lms.x_w"] = pd.lms.x_w
        out[dev] = (r, summ, counts, k8, k8_want, linalg)
    (g, gs, counts, k8, k8_want, linalg), (c, cs, *_) = (out["cuda"],
                                                          out["cpu"])
    import torch

    say(f"banded_small K8 launches on the card, cyclic reduction and scan "
        f"solves: {k8} (expected {k8_want}); torch.linalg factor or "
        f"triangular-solve calls {linalg}")
    check(k8 == k8_want, f"banded_small: K8 launches {k8}, expected "
          f"{k8_want}")
    check(linalg == 0, f"banded_small: {linalg} torch.linalg factor or "
          f"triangular-solve calls on the banded solver")

    _compare([(k, g[k], c[k]) for k in c]
             + [("dogleg final cost", torch.tensor(gs.final_cost),
                 torch.tensor(cs.final_cost))],
             "banded solvers, 80 poses f64", TOL_SMALL)
    check(all(bool(c[k]) for k in c if k.endswith(" ok")),
          "banded_small: a factorization failed")
    path = (gs.iterations, gs.result, gs.inner_iterations)
    say(f"banded_small dogleg: {gs.iterations} iterations, {gs.result}, "
        f"cost {gs.initial_cost:.6g} -> {gs.final_cost:.6g} (CPU "
        f"{cs.iterations}, {cs.result}); card launches before the dogleg: "
        f"band_schur {counts[0]} band_matvec {counts[1]}")
    check(path == (cs.iterations, cs.result, cs.inner_iterations),
          "banded_small: dogleg took another path on the card")
    check(gs.final_cost < gs.initial_cost, "banded_small: dogleg cost")
    check(counts[0] >= 2 and counts[1] >= 3 * K9_PER_BUILD,
          f"banded_small: kernels 7/9 launched {counts} times")
    say("PHASE banded_small ok")
    return dict(k8, k8=sum(k8.values()))


def long_problem():
    """(f32 problem, config, SimData) of the long trajectory, prepared."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver.assemble import band_width_of
    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                   use_banded_solver=True)
    sim = sv.simulate(n_poses=LONG["poses"], n_lms=LONG["lms"], seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               with_marg_prior=False)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    sizes = dict(P=p.poses.q.shape[0], L=p.lms.x.shape[0],
                 Nr=p.proj.z.shape[0], Nw=p.pidx.wb_pose.shape[0],
                 Ni=int(p.imu.valid.sum()), B=cfg.band_width,
                 n_sp=p.pidx.sp_i.shape[0])
    say(f"long problem {sizes} on {p.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(sizes == LONG_EXPECTED, f"long sizes {sizes} != {LONG_EXPECTED}")
    return prepare_landmarks(p, cfg), cfg, sim


def long_blocks(p, cfg):
    """(block system, plan) of one build of the long problem."""
    from ba_tpu_torch.solver import cg, step

    plan = step.solve_plan(p, cfg)
    bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               with_precond=False, plan=plan)
    return bs, plan


def xyz_band_case(device="cuda"):
    """(problem, config, block system) of a 48-pose f64 build with XYZ
    landmarks (lm_size 3) on the banded solver's config, no
    marginalization prior: kernel 7's lm_size 3 inputs."""
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.solver.assemble import band_width_of

    cfg = BAConfig(pose_dim=9, lm_size=3, use_dogleg=False,
                   use_banded_solver=True)
    sim = sv.simulate(n_poses=48, n_lms=160, seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               with_marg_prior=False, device=device)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
    p = prepare_landmarks(p, cfg)
    bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               with_precond=False)
    return p, cfg, bs


# kernel 7's partner and left rows staged at once when phase k7 forces
# the piecewise walk
K7_PIECES = (37, 101)


def phase_k7(p, cfg, bs, plan):
    """Kernel 7 against its plain version at full width, f32 and an f64
    copy, with and without padding W blocks, and with its staging forced
    into pieces (`K7_PIECES`), which must not change a bit; then on a
    48-pose build with XYZ landmarks (lm_size 3) the same ways; two
    launches bit-identical.  Returns the f32 max abs error."""
    import torch

    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.solver import banded

    P, L, B = p.poses.q.shape[0], p.lms.x.shape[0], cfg.band_width
    idx = p.pidx
    check(plan.band.grouped, "long: band_S is not on the grouped form")
    sp = plan.band.schur
    i_loc, kept = k7.slot_of(idx.wb_pose, idx.wb_lm, L, B)
    check(int(i_loc[kept].max()) == B - 1,
          "k7: no landmark reaches the last slot of the band")
    # padding W blocks (landmark id L), nonzero: both versions drop them
    pad, dev = 64, bs.wb.device
    wb_pose_p = torch.cat([idx.wb_pose, torch.arange(
        pad, dtype=torch.int32, device=dev) % P])
    wb_lm_p = torch.cat([idx.wb_lm, torch.full((pad,), L, dtype=torch.int32,
                                               device=dev)])
    Wb_p = torch.cat([bs.wb, torch.full((pad, 6, 1), 1e3, device=dev)])
    px, cfg_x, bs_x = xyz_band_case()
    Px, Bx = px.poses.q.shape[0], cfg_x.band_width
    ix = px.pidx
    cases = (("full width", P, B, idx.wb_pose, idx.wb_lm, bs.wb, bs.vinv,
              sp),
             ("padding rows", P, B, wb_pose_p, wb_lm_p, Wb_p, bs.vinv,
              k7.schur_plan(wb_pose_p, wb_lm_p, P, L, B)),
             ("lm_size 3, 48 poses", Px, Bx, ix.wb_pose, ix.wb_lm, bs_x.wb,
              bs_x.vinv, k7.schur_plan(ix.wb_pose, ix.wb_lm, Px,
                                       px.lms.x.shape[0], Bx)))
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        for what, P_, B_, wp, wl, Wb, vinv, sp_ in cases:
            Wb, vinv = Wb.to(dtype), vinv.to(dtype)
            a = k7.band_schur(Wb, vinv, sp_, P_)
            b = k7.band_schur(Wb, vinv, sp_, P_)
            c = k7.band_schur(Wb, vinv, sp_, P_, caps=K7_PIECES)
            want = banded.band_schur_plain(wp, wl, Wb, vinv, P_, B_)
            torch.cuda.synchronize()
            err, rel = rel_err(a, want)
            same, cut = bool(torch.equal(a, b)), bool(torch.equal(a, c))
            say(f"kernel 7 {dt} {what} (Nw={Wb.shape[0]}, P={P_}, B={B_}, "
                f"lm {Wb.shape[2]}): max abs err {err:.3e} rel {rel:.3e} "
                f"(tol {TOL_K7[dt]:g}); bit-identical relaunch {same}, "
                f"in pieces of {K7_PIECES} rows {cut}")
            check(rel <= TOL_K7[dt], f"kernel 7 {dt} {what}: rel {rel:.3g}")
            check(same, f"kernel 7 {dt} {what}: two launches differ")
            check(cut, f"kernel 7 {dt} {what}: the piecewise walk differs")
            if dt == "float32":
                worst = max(worst, err)
            del want
    say("PHASE k7 ok")
    return worst


def phase_k9(p, cfg, bs):
    """Kernel 9 against its plain version on the long build's scaled band
    (the matrix the PCG multiplies) and on its first 2,047 poses, f32 and
    an f64 copy.  Returns (f32 max abs error, the band, band_s, x)."""
    import numpy as np
    import torch

    from ba_tpu_torch.solver import banded

    P, D = p.poses.q.shape[0], cfg.pose_dim
    band = banded.band_S(p, cfg, bs, P, D)
    band_s, _ = banded.jacobi_scaled(band)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(P * D),
                        dtype=band_s.dtype, device=band_s.device)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        for n in (P, P - 1):
            bd, xv = band_s[:n].to(dtype), x[: n * D].to(dtype)
            a = banded.band_matvec(bd, xv)
            b = banded.band_matvec(bd, xv)
            want = banded.band_matvec_plain(bd.double(), xv.double())
            torch.cuda.synchronize()
            err, rel = rel_err(a, want)
            same = bool(torch.equal(a, b))
            say(f"kernel 9 {dt} P={n} B={bd.shape[1]} D={D}: max abs err "
                f"{err:.3e} rel {rel:.3e} (tol {TOL_K9[dt]:g}); "
                f"bit-identical relaunch {same}")
            check(rel <= TOL_K9[dt], f"kernel 9 {dt} P={n}: rel {rel:.3g}")
            check(same, f"kernel 9 {dt} P={n}: two launches differ")
            if dt == "float32":
                worst = max(worst, err)
    say("PHASE k9 ok")
    return worst, band, band_s, x


def _step_gap(a, b):
    """max |a - b| / max |b| of two steps."""
    return float((a - b).abs().max() / b.abs().max())


def step_gap_cpu():
    """(delta_p gap, delta_l gap) of the banded solver's first step
    against the dense solve's, f32 on the CPU at STEP_GAP_POSES poses of
    the long configuration's simulator."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import band_width_of
    from ba_tpu_torch.utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                   use_banded_solver=True)
    sim = sv.simulate(n_poses=STEP_GAP_POSES, n_lms=4 * STEP_GAP_POSES,
                      seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               with_marg_prior=False, device="cpu")
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    p = prepare_landmarks(p, cfg)
    a = step._build_and_solve(p, cfg, True).step
    b = step._build_and_solve(
        p, dataclasses.replace(cfg, use_banded_solver=False), True).step
    return _step_gap(a.delta_p, b.delta_p), _step_gap(a.delta_l, b.delta_l)


def phase_long(p, cfg, sim, smi):
    """GN solve_fixed(..., 10) of the long trajectory on the banded solver,
    then its first step against the dense solve's."""
    import torch

    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    n = LONG["iters"]
    # the factorization's f32 products must stay exact f32 (ba_tpu asks
    # for Precision.HIGHEST there); the package pins TF32 off at import
    exact = (not torch.backends.cuda.matmul.allow_tf32
             and torch.get_float32_matmul_precision() == "highest")
    say(f"long: f32 matmuls exact (TF32 off, precision highest) {exact}")
    check(exact, "long: TF32 is on for f32 matmuls")
    cost0 = float(evaluate_cost(p, cfg, step._imu_eval(p, cfg, True, False)))
    ate0 = _ate(p, sim)

    def plan():
        out = step.solve_plan(p, cfg)
        torch.cuda.synchronize()
        return out

    plan_first, plan_again = _sync_count(plan)[1], _sync_count(plan)[1]
    step.solve_fixed(p, cfg, True, 1)                      # warm-up
    torch.cuda.synchronize()

    oks = []
    orig = step.gn_iteration

    def recording(*a, **k):
        res = orig(*a, **k)
        oks.append(res.solver_ok)
        return res

    linalg = [0]

    def run():
        out, linalg[0] = _linalg_calls(lambda: step.solve_fixed(p, cfg, True,
                                                                n))
        torch.cuda.synchronize()
        return out

    step.gn_iteration = recording
    torch.cuda.reset_peak_memory_stats()
    _counters_zero()
    try:
        t0 = time.perf_counter()
        (q, costs, dns), syncs = _sync_count(run)
        secs = time.perf_counter() - t0
    finally:
        step.gn_iteration = orig
    k1, k2, reads = _counters()
    k7, k9 = _band_counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    k8, k5b = _k8_counters(), _k5b_count()
    k8_want = _k8_want(cfg, p.poses.q.shape[0], n)
    peak = torch.cuda.max_memory_allocated()
    costs_h = costs.double().cpu()
    ate1 = _ate(q, sim)
    all_ok = bool(torch.stack(oks).all())
    kf = LONG["poses"] * n / secs
    say(f"long GN solve_fixed({n}) f32: cost {cost0:.6g} -> "
        f"{float(costs_h[-1]):.6g}, ATE {ate0:.6g} -> {ate1:.6g} m, "
        f"solver_ok at every iteration {all_ok}, kernel launches "
        f"reprojection {k1} segsum {k2} band_schur {k7} band_matvec {k9} "
        f"imu_preint (a) {ia} (b) {ib}; K8 {k8} ({sum(k8.values()) / n:g} "
        f"per iteration), band_to_dense {k5b}; torch.linalg factor or "
        f"triangular-solve calls {linalg[0]}")
    say(f"[{smi}] long GN solve_fixed({n}): {secs * 1e3:.1f} ms, "
        f"{secs * 1e3 / n:.1f} ms per iteration, {kf:.1f} kf/s; peak device "
        f"memory {peak / 2**30:.3f} GiB; host syncs {syncs} (the plans' "
        f"{plan_again} once; {plan_first} at the process's first banded "
        f"plan), {(syncs - plan_again) / n:.2f} per iteration")
    check(bool(torch.isfinite(costs_h).all()) and _finite(q),
          "long: non-finite values")
    check(float(costs_h[-1]) < cost0, "long: cost did not fall")
    check(ate1 < ate0, "long: ATE did not fall")
    check(len(oks) == n and all_ok, "long: solver_ok failed")
    want = (2 * n, K2_PER_BANDED_BUILD * n, K7_PER_BUILD * n,
            K9_PER_BUILD * n)
    check((k1, k2, k7, k9) == want, f"long: launches {(k1, k2, k7, k9)}, "
          f"expected {want}")
    check((ia, ib) == (n, n), f"long: imu_preint launches ({ia}, {ib})")
    check((k5, k11) == (0, 0), f"long: schur_finish, marginalize launches "
          f"({k5}, {k11}) on the banded solver")
    check(k8 == k8_want, f"long: K8 launches {k8}, expected {k8_want}")
    check(k5b == 0, f"long: {k5b} band_to_dense launches on the banded "
          f"solver")
    check(linalg[0] == 0, f"long: {linalg[0]} torch.linalg factor or "
          f"triangular-solve calls in {n} iterations")
    check(syncs == plan_again, f"long: {syncs - plan_again} host syncs in "
          f"{n} iterations")

    # the first step against the dense solve of the same build
    gap_p, gap_l = step_gap_cpu()
    torch.cuda.reset_peak_memory_stats()
    a = step._build_and_solve(p, cfg, True)
    torch.cuda.synchronize()
    peak_b = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = step._build_and_solve(
        p, dataclasses.replace(cfg, use_banded_solver=False), True)
    torch.cuda.synchronize()
    dense_secs = time.perf_counter() - t0
    peak_d = torch.cuda.max_memory_allocated()
    got_p = _step_gap(a.step.delta_p, b.step.delta_p)
    got_l = _step_gap(a.step.delta_l, b.step.delta_l)
    post = [float(step._cost(step.apply_update(p, cfg, s.step.delta_p,
                                               s.step.delta_l),
                             cfg, True, s.proj_w, s.imu_c9))
            for s in (a, b)]
    say(f"long first step, banded against dense: delta_p gap {got_p:.3e} "
        f"(tol {STEP_GAP_FACTOR:g} x {gap_p:.3e}, the f32 CPU gap at "
        f"{STEP_GAP_POSES} poses), delta_l gap {got_l:.3e} (tol "
        f"{STEP_GAP_FACTOR:g} x {gap_l:.3e}); trial cost {post[0]:.6g} "
        f"banded, {post[1]:.6g} dense (from {cost0:.6g}); both ok "
        f"{bool(a.step.ok)}/{bool(b.step.ok)}")
    say(f"[{smi}] long build + solve: peak device memory banded "
        f"{peak_b / 2**30:.3f} GiB, dense {peak_d / 2**30:.3f} GiB (the dense "
        f"build {dense_secs * 1e3:.1f} ms)")
    check(bool(a.step.ok) and bool(b.step.ok), "long: a solve failed")
    check(got_p <= STEP_GAP_FACTOR * gap_p and got_l <= STEP_GAP_FACTOR
          * gap_l, "long: the banded step is off the dense one")
    say("PHASE long ok")
    return dict(k1=k1, k2=k2, k7=k7, k9=k9, imu=ia + ib, imu_a=ia, imu_b=ib,
                k5=k5, k11=k11, k8=k8, k5b=k5b,
                kf_s=kf, ms_iter=secs * 1e3 / n,
                peak_gib=peak / 2**30, peak_dense_gib=peak_d / 2**30,
                syncs=syncs - plan_again, gap_p=got_p, gap_l=got_l)


def _parent_kernels():
    """The parent tree's (kernel 7, kernel 9) modules (`--parent`), or
    None."""
    if PARENT is None:
        return None
    import importlib

    parent_package(PARENT)
    return tuple(importlib.import_module(f"ba_tpu_torch_parent.kernels.{m}")
                 for m in ("band_schur", "band_matvec"))


def k7_work(plan, L, lm):
    """(block pairs, flop) of kernel 7 on `plan`: every two kept W blocks
    of a landmark (its span is under B) make one 6 x 6 product of lm
    terms, each kept block one u = Wb V^-1."""
    import torch

    n_kept = int(plan.offsets[-1])
    n_l = torch.bincount(plan.lm[:n_kept].long(), minlength=L).double()
    pairs = int((n_l * (n_l + 1) / 2).sum())
    return pairs, 72 * lm * pairs + 6 * lm * (2 * lm - 1) * n_kept


def k9_blocks_read(P, B):
    """Band blocks kernel 9 reads: each tile's own rows and the blocks of
    the B - 1 rows before it that reach into it."""
    from ba_tpu_torch.kernels import band_matvec as k9

    chb, _ = k9.schedule(B)
    return sum(db - da for q0 in range(0, P, k9.TILE)
               for pc in k9.pieces(q0, P, B, chb) if pc is not None
               for _, da, db in [pc])


def phase_timing_band(p, cfg, bs, plan, band, band_s, x, k8_per_iter,
                      floor_ms, smi):
    """Kernels 7 and 9 timed at full width beside their bounds (bytes as
    the function needs them, the route's own printed beside), plain
    versions, (kernel 9) torch.mv on the densified band and, with
    `--parent`, the parent tree's kernels on the same inputs."""
    import torch

    from ba_tpu_torch.kernels import band_matvec as k9
    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.solver import banded
    from ba_tpu_torch.solver.assemble import band_to_dense

    P, L, B, D = (p.poses.q.shape[0], p.lms.x.shape[0], cfg.band_width,
                  cfg.pose_dim)
    sp = plan.band.schur
    Wb, vinv = bs.wb, bs.vinv
    idx = p.pidx
    es = Wb.element_size()
    parent = _parent_kernels()

    def k7_call():
        return k7.band_schur(Wb, vinv, sp, P)

    def dev(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    pairs, k7_flops = k7_work(sp, L, Wb.shape[2])
    out_bytes = P * B * 36 * es
    k7_bytes = nbytes(Wb, vinv, idx.wb_pose, idx.wb_lm) + out_bytes
    k7_route = nbytes(Wb, vinv, sp.perm, sp.offsets, sp.lm,
                      sp.tile_src) + out_bytes
    t7 = dict(ms=event_ms(k7_call, 50), device_ms=graph_ms(k7_call, 20),
              plain_ms=event_ms(lambda: banded.band_schur_plain(
                  idx.wb_pose, idx.wb_lm, Wb, vinv, P, B), 3))
    b7, by7 = _bound(k7_bytes, k7_flops)
    old7 = None
    if parent is not None:
        psp = parent[0].schur_plan(idx.wb_pose, idx.wb_lm, P, L, B)
        old7 = _timed(lambda: parent[0].band_schur(Wb, vinv, psp, P), 50, 20)
    vs7 = (f"; the parent's kernel {old7[0]:.4f} ms per call "
           f"({dev(old7[1])} on the device)" if old7
           else "; the parent's kernel not timed (no --parent)")
    say(f"[{smi}] kernel 7 band_schur, long build (Nw={Wb.shape[0]}, "
        f"{pairs} block pairs, P={P}, B={B}) f32: {t7['ms']:.4f} ms per call "
        f"({t7['device_ms']:.4f} ms on the device, "
        f"{b7 / t7['device_ms']:.1%} of the bound){vs7}; plain (the (L, B, "
        f"B, 6, 6) form) {t7['plain_ms']:.3f} ms; bound {b7:.5f} ms ({by7}: "
        f"{k7_bytes} B as the function needs them (Wb, V^-1, wb_pose, "
        f"wb_lm, the output), {k7_flops} flop; the route's {k7_route} B "
        f"with the plan's perm, offsets and landmark ids); no library call "
        f"computes it; launch floor {floor_ms:.4f} ms")
    rec7 = dict(ms=t7["ms"], device_ms=t7["device_ms"], floor_ms=floor_ms,
                plain_ms=t7["plain_ms"], bound_ms=b7, bound_by=by7,
                library_ms=None, bytes=k7_bytes, route_bytes=k7_route,
                flops=k7_flops, parent_ms=old7 and old7[0],
                parent_device_ms=old7 and old7[1])

    blocks = P * B - B * (B - 1) // 2                # upper blocks in range
    k9_flops = 2 * D * D * (2 * blocks - P)          # + the lower ones
    k9_bytes = nbytes(band_s, x) + x.numel() * x.element_size()
    k9_route = (k9_blocks_read(P, B) * D * D * es
                + 2 * x.numel() * x.element_size())
    S = band_to_dense(band_s)
    t9 = dict(ms=event_ms(lambda: k9.band_matvec(band_s, x), 200),
              device_ms=graph_ms(lambda: k9.band_matvec(band_s, x), 50),
              plain_ms=event_ms(lambda: banded.band_matvec_plain(band_s, x),
                                20),
              library_ms=event_ms(lambda: torch.mv(S, x), 50),
              library_device_ms=graph_ms(lambda: torch.mv(S, x), 20))
    del S
    b9, by9 = _bound(k9_bytes, k9_flops)
    old9 = None
    if parent is not None:
        old9 = _timed(lambda: parent[1].band_matvec(band_s, x), 200, 50)
    vs9 = (f"; the parent's kernel {old9[0]:.4f} ms per call "
           f"({dev(old9[1])} on the device)" if old9
           else "; the parent's kernel not timed (no --parent)")
    say(f"[{smi}] kernel 9 band_matvec, long band (P={P}, B={B}, D={D}) f32: "
        f"{t9['ms']:.4f} ms per call ({t9['device_ms']:.4f} ms on the "
        f"device, {b9 / t9['device_ms']:.1%} of the bound){vs9}; plain "
        f"{t9['plain_ms']:.4f} ms; torch.mv on the densified band "
        f"{t9['library_ms']:.4f} ms ({t9['library_device_ms']:.4f} ms on the "
        f"device); bound {b9:.5f} ms ({by9}: {k9_bytes} B, {k9_flops} flop; "
        f"the route reads {k9_route} B with each tile's halo blocks); "
        f"launch floor {floor_ms:.4f} ms")
    rec9 = dict(ms=t9["ms"], device_ms=t9["device_ms"], floor_ms=floor_ms,
                plain_ms=t9["plain_ms"], bound_ms=b9, bound_by=by9,
                library_ms=t9["library_ms"],
                library_device_ms=t9["library_device_ms"], bytes=k9_bytes,
                route_bytes=k9_route, parent_ms=old9 and old9[0],
                parent_device_ms=old9 and old9[1])
    rec8 = k8_timing(p, cfg, band, k8_per_iter, floor_ms, smi)
    say("PHASE timing (long) ok")
    return rec7, rec9, rec8


def _device_ops(fn, tries=5):
    """Device operations (kernels, memsets, copies) that one call of `fn`
    puts on the card, from torch.profiler: the most that `tries` captures
    of one call each saw, since a capture can lose a record but never adds
    one (one has been seen to miss the one kernel of a call in 1 of 8
    smoke runs on an H100, and three in a row in another); None when none
    saw any."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        try:
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            seen.append(sum(1 for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA))
        except RuntimeError as e:
            say(f"torch.profiler failed ({str(e)[:160]}); device operations "
                f"not counted")
    if len(set(seen)) > 1:
        say(f"device operations seen by {len(seen)} captures of one call: "
            f"{seen}")
    return max(seen, default=0) or None


def _graph_ops(fn):
    """Device operations (kernels, memsets, copies) that one call of `fn`
    puts on the card: the nodes of a CUDA graph that captures the call
    (cuGraphGetNodes).  Exact where torch.profiler loses records: late in
    this script, captures of a one-kernel call have seen its kernel in 1
    and 2 of 5."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    check(rc == 0, f"cuGraphGetNodes failed: CUDA error {rc}")
    return int(n.value)


def _timed(fn, calls, graph_calls):
    """(ms per call with the host, device ms by CUDA-graph replay or None
    when a call refuses capture)."""
    import torch

    ms = event_ms(fn, calls)
    try:
        dev = graph_ms(fn, graph_calls)
    except RuntimeError as e:
        torch.cuda.synchronize()
        say(f"CUDA-graph capture failed ({str(e)[:160]}); device time not "
            f"measured")
        dev = None
    return ms, dev


def _bound(nbytes_, flops):
    """(bound ms, what bounds it) at the H100's peaks."""
    t_b, t_f = nbytes_ / HBM_BPS, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# K8's kernels by stage, PR 8's names and this tree's (k8_level_split)
K8_STAGES = {"bcr_eliminate": "eliminate", "bcr_base": "eliminate",
             "bcr_chol_inv": "eliminate", "bcr_reduce": "products",
             "bcr_products": "products", "bcr_down": "down",
             "bcr_down_t": "down", "bcr_down_b": "down",
             "bcr_base_solve": "base", "bcr_up": "up", "bcr_up_y": "up",
             "bcr_up_x": "up"}


def _kernel_spans(fn, calls):
    """[(name, device ms)] of the K8 cyclic-reduction kernels that `calls`
    calls of fn launch, in launch order, from a profiler trace."""
    import re
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / "k8.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = []
    for e in sorted((e for e in events if e.get("cat") == "kernel"),
                    key=lambda e: e["ts"]):
        m = re.search(r"bcr_[a-z_]+", e.get("name", ""))
        if m and m.group(0) in K8_STAGES:
            spans.append((m.group(0), e["dur"] * 1e-3))
    return spans


def k8_level_split(factor, solve, lv, calls=3):
    """Device ms of one cyclic-reduction factor and one solve of lv levels
    by level and stage (mean over `calls` calls each, from profiler
    traces): the factor's `eliminate` (the level's Cholesky: PR 8's
    bcr_eliminate, this tree's bcr_chol_inv) and `products` (the rest of
    the level) per level, its base block; the solve's `down` and `up` per
    level and its base.  Works on PR 8's kernels and this tree's alike: a
    factor call is lv + 1 eliminate launches, each with the products after
    it; a solve call is (2 lv + 1) k launches, k a step's (2 for this
    tree's, 1 for PR 8's), down levels, the base, then up levels."""
    f = _kernel_spans(factor, calls)
    s = _kernel_spans(solve, calls)
    # factor: tokens [eliminate ms, products ms]; a call is lv tokens with
    # products and the base's without (a trace may hold a call's tail from
    # before it started)
    tok = []
    for name, ms in f:
        if K8_STAGES[name] == "eliminate":
            tok.append([ms, 0.0])
        elif tok:
            tok[-1][1] += ms
    fc = [tok[i - lv:i + 1] for i in range(lv, len(tok))
          if tok[i][1] == 0.0 and all(t[1] > 0.0 for t in tok[i - lv:i])]
    # solve: k launches a step (2 for this tree's, 1 for PR 8's): lv down
    # steps, the base, lv up steps, found where the stages match
    k = 2 if any(name in ("bcr_down_t", "bcr_up_y") for name, _ in s) else 1
    want = (["down"] * (2 * lv + 1) + ["up"] * (2 * lv + 1) if k == 2
            else ["down"] * lv + ["base"] + ["up"] * lv)
    ns, sc, i = len(want), [], 0
    while i + ns <= len(s):
        if [K8_STAGES[name] for name, _ in s[i:i + ns]] == want:
            sc.append([ms for _, ms in s[i:i + ns]])
            i += ns
        else:
            i += 1
    if not fc or not sc:
        raise RuntimeError(f"k8_level_split: {len(f)} factor and {len(s)} "
                           f"solve kernels for {calls} calls of {lv} levels")

    def mean(rows):
        return [sum(r[i] for r in rows) / len(rows)
                for i in range(len(rows[0]))]

    elim = mean([[e for e, _ in c] for c in fc])
    prod = mean([[q for _, q in c] for c in fc])
    down = mean([[sum(c[i * k:(i + 1) * k]) for i in range(lv)]
                 for c in sc])
    base = mean([[sum(c[lv * k:(lv + 1) * k])] for c in sc])[0]
    up = mean([[sum(c[(lv + 1 + i) * k:(lv + 2 + i) * k])
                for i in range(lv)][::-1] for c in sc])
    return dict(eliminate=elim[:lv], products=prod[:lv],
                base_eliminate=elim[lv], down=down, up=up, base_solve=base,
                factor_total=sum(elim) + sum(prod),
                solve_total=sum(down) + sum(up) + base,
                calls=(len(fc), len(sc)))


def k8_work(rs, n, es):
    """(factor flops, factor bytes, solve flops, solve bytes) of this
    tree's cyclic reduction over levels of rs = [r_0, ..., 1] chunks that
    are not padding: per level h = r // 2 eliminated, nv = r - h - 1 V
    blocks; the Cholesky and inverse 2 n^3 / 3 each eliminated chunk, W n^3
    (Li is lower), V n^3, V^T V and W^T W n^3 each (lower triangles), E'
    2 n^3; bytes each input read once and each output written once.  The
    solve reads Li's lower triangle, W and V of every level once, two
    flops an element each way."""
    ff = fb = sf = sb = 0
    tri = n * (n + 1) // 2
    for r in rs[:-1]:
        h, nv = r // 2, r - r // 2 - 1
        rn = r - h
        ff += h * (2 / 3 + 2) * n ** 3 + nv * 4 * n ** 3
        fb += (r + max(r - 1, 0) + 2 * h + nv + rn + nv) * n * n * es
        sb += (h * (tri + n * n) + nv * n * n) * es
        sf += 4 * (h * (tri + n * n) + nv * n * n)
    ff += 2 / 3 * n ** 3
    fb += 2 * n * n * es
    sb += tri * es
    sf += 4 * tri
    return ff, fb, sf, sb


def k8_timing(p, cfg, band, k8_per_iter, floor_ms, smi):
    """K8a, K8b and K8c (cyclic reduction) timed on the long build's band
    in f32, beside their bounds, the plain versions and the old route
    (`_bcr_factor` / `_bcr_solve` on torch.linalg): ms per call with the
    host and on the device (CUDA-graph replay); the work counted level by
    level over the chunks that are not padding, with PR 8's count beside;
    the device ms of each level's stages (`k8_level_split`); the device
    operations of one GN iteration's K8 work (1 layout, 1 factor, 5
    solves) both ways."""
    import torch

    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    P, D = p.poses.q.shape[0], cfg.pose_dim
    F_, P_w, chunk, n_c = banded.chunk_geometry(cfg, P, band.shape[1])
    n = chunk * D
    m = k8.next_pow2(n_c)
    eps = banded._eps(band.dtype)
    es = band.element_size()
    bs, sc, Dg, Eg = k8.chunk_layout(band, F_, chunk, m, eps)
    levels, _ = k8.bcr_factor(Dg, Eg, live=n_c)
    r = torch.ones((F_, P_w * D), dtype=band.dtype, device=band.device)

    def old_layout():
        band_s, scal = banded.jacobi_scaled(band)
        return band_s, scal, *banded.chunk_system(band_s, cfg, P, D)[:2]

    _, _, Dg_o, Eg_o = old_layout()
    levels_o, _ = banded._bcr_factor(Dg_o, Eg_o)
    levels_n, _ = k8.bcr_factor_plain(Dg, Eg, live=n_c)
    b_o = torch.ones((F_, n_c, n), dtype=band.dtype, device=band.device)

    def old_iteration():
        _, _, Dg_, Eg_ = old_layout()
        lv, _ = banded._bcr_factor(Dg_, Eg_)
        for _ in range(5):
            banded._bcr_solve(lv, b_o, n_c)

    def new_iteration():
        lv, _ = k8.bcr_factor(*k8.chunk_layout(band, F_, chunk, m, eps)[2:],
                              live=n_c)
        for _ in range(5):
            k8.bcr_solve(lv, r)

    # bytes: each input read once, each output written once
    a_bytes = nbytes(band, bs, sc, Dg, Eg)
    a_bound, a_by = _bound(a_bytes, 4 * band.numel())
    rs = k8.level_sizes(levels)
    f_flops, f_bytes, s_flops, s_bytes = (x * F_ for x in k8_work(rs, n, es))
    f_bound, f_by = _bound(f_bytes, f_flops)
    s_bound, s_by = _bound(s_bytes, s_flops)
    # PR 8's count: every level of m chunks, h = m / 2 Choleskys (n^3 / 3),
    # two triangular solves of n columns each way (4 n^3), three products
    # (6 n^3); it read and wrote 3 h blocks of factor, D and E
    hs = [m >> (k + 1) for k in range(len(rs) - 1)]
    f_old = F_ * (sum(h * (n ** 3 / 3 + 4 * n ** 3 + 6 * n ** 3)
                      for h in hs) + n ** 3 / 3)
    s_old = F_ * (sum(3 * h for h in hs) + 1) * n * n * es

    ta = _timed(lambda: k8.chunk_layout(band, F_, chunk, m, eps), 20, 5)
    ta_plain = event_ms(old_layout, 10)
    parent = None
    if PARENT is not None:
        import importlib

        parent_package(PARENT)
        pk8 = importlib.import_module("ba_tpu_torch_parent.kernels."
                                      "chunk_tridiag")
        tpar = _timed(lambda: pk8.chunk_layout(band, F_, chunk, m, eps), 20,
                      5)
        parent = dict(ms=tpar[0], device_ms=tpar[1])
    tf = _timed(lambda: k8.bcr_factor(Dg, Eg, live=n_c), 5, 2)
    tf_plain = event_ms(lambda: k8.bcr_factor_plain(Dg, Eg, live=n_c), 1)
    tf_old = _timed(lambda: banded._bcr_factor(Dg_o, Eg_o), 5, 2)
    ts = _timed(lambda: k8.bcr_solve(levels, r), 10, 5)
    ts_plain = event_ms(lambda: k8.bcr_solve_plain(levels_n, r), 1)
    ts_old = _timed(lambda: banded._bcr_solve(levels_o, b_o, n_c), 10, 5)
    split = k8_level_split(lambda: k8.bcr_factor(Dg, Eg, live=n_c),
                           lambda: k8.bcr_solve(levels, r), len(levels) - 1)
    ops_new, ops_old = _device_ops(new_iteration), _device_ops(old_iteration)

    def dev(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    def share(bound, t):
        return "" if t is None else f", {bound / t:.1%} of the bound"

    def row(xs):
        return " ".join(f"{x:.4f}" for x in xs)

    vs = (f"; the parent's kernel {parent['ms']:.4f} ms per call "
          f"({dev(parent['device_ms'])} on the device)" if parent
          else "; the parent's kernel not timed (no --parent)")
    say(f"[{smi}] K8a chunk_layout on the long band (P={P}, F={F_}, chunk "
        f"{chunk}, {n_c} -> {m} chunks of n={n}) f32: {ta[0]:.4f} ms per "
        f"call ({dev(ta[1])} on the device{share(a_bound, ta[1])}){vs}; "
        f"plain (jacobi_scaled + chunk_system, the old route) "
        f"{ta_plain:.4f} ms; bound {a_bound:.5f} ms ({a_by}: {a_bytes} B); "
        f"launch floor {floor_ms:.4f} ms")
    say(f"[{smi}] K8b bcr_factor ({len(levels) - 1} levels of {rs} chunks "
        f"that are not padding, {3 * (len(levels) - 1) + 1} launches) f32: "
        f"{tf[0]:.4f} ms per call ({dev(tf[1])} on the device"
        f"{share(f_bound, tf[1])}); plain (bcr_factor_plain) {tf_plain:.1f}"
        f" ms; old route (_bcr_factor on torch.linalg) {tf_old[0]:.4f} ms "
        f"({dev(tf_old[1])} on the device); bound {f_bound:.5f} ms ({f_by}:"
        f" {f_flops:.4g} flop, {f_bytes} B; PR 8's count {f_old:.4g} flop)")
    say(f"[{smi}] K8c bcr_solve ({4 * (len(levels) - 1) + 2} launches) f32: "
        f"{ts[0]:.4f} ms per call ({dev(ts[1])} on the device"
        f"{share(s_bound, ts[1])}); plain (bcr_solve_plain) "
        f"{ts_plain:.1f} ms; old route (_bcr_solve on torch.linalg) "
        f"{ts_old[0]:.4f} ms ({dev(ts_old[1])} on the device); bound "
        f"{s_bound:.5f} ms ({s_by}: {s_flops:.4g} flop, {s_bytes} B; PR 8's "
        f"count {s_old} B)")
    say(f"[{smi}] K8 device ms by level (profiler, mean of 3 calls), "
        f"levels 0..{len(levels) - 2}: factor eliminate {row(split['eliminate'])}"
        f", base {split['base_eliminate']:.4f}; factor products "
        f"{row(split['products'])}; solve down {row(split['down'])}, base "
        f"{split['base_solve']:.4f}, up {row(split['up'])}; sums factor "
        f"{split['factor_total']:.4f}, solve {split['solve_total']:.4f}")
    say(f"[{smi}] K8 work of one long GN iteration (1 layout, 1 factor, 5 "
        f"solves): {k8_per_iter:g} kernel launches counted on the main "
        f"path; device operations seen by the profiler: kernels "
        f"{ops_new}, old route {ops_old}")
    common = dict(floor_ms=floor_ms, device_ops_per_iteration=ops_new,
                  old_route_device_ops_per_iteration=ops_old)
    rec_a = dict(ms=ta[0], device_ms=ta[1], plain_ms=ta_plain,
                 bound_ms=a_bound, bound_by=a_by, library_ms=None,
                 parent=parent, **common)
    rec_f = dict(ms=tf[0], device_ms=tf[1], plain_ms=tf_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=tf_old[0],
                 library_device_ms=tf_old[1], flops=f_flops,
                 bytes=f_bytes, flops_pr8_count=f_old,
                 levels=split, **common)
    rec_s = dict(ms=ts[0], device_ms=ts[1], plain_ms=ts_plain,
                 bound_ms=s_bound, bound_by=s_by, library_ms=ts_old[0],
                 library_device_ms=ts_old[1], flops=s_flops, bytes=s_bytes,
                 bytes_pr8_count=s_old, **common)
    return rec_a, rec_f, rec_s


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def _chunk_residual(Dg, Eg, x, b):
    """Normwise backward error of x (F, m, n) for the chunk system (Dg,
    Eg) and b, in f64: max |S x - b| / (max |S| n max |x| + max |b|), with
    each diagonal block read from its lower triangle, as the factors read
    it."""
    import torch

    Dg, Eg, x, b = (t.double() for t in (Dg, Eg, x, b))
    Dg = torch.tril(Dg) + torch.tril(Dg, -1).mT
    Sx = torch.einsum("fkij,fkj->fki", Dg, x)
    Sx[:, :-1] += torch.einsum("fkij,fkj->fki", Eg[:, :-1], x[:, 1:])
    Sx[:, 1:] += torch.einsum("fkji,fkj->fki", Eg[:, :-1], x[:, :-1])
    scale = (max(float(Dg.abs().max()), float(Eg.abs().max())) * Dg.shape[-1]
             * float(x.abs().max()) + float(b.abs().max()))
    return float((Sx - b).abs().max()) / scale


def _k8_pairs(Dg, Eg, r, n_c):
    """K8b and K8c (cyclic reduction on Dg, Eg (F, 2^k, n, n), n_c real
    chunks, and the scan on those) for the rows r (F, L): {name: rel} of
    the kernels' factor (max over every level's Li, W, V and Li0) and solve
    against `bcr_factor_plain` / `bcr_solve_plain`, of the kernels' solve
    on the plain factor against the plain solve, of x = S^-1 b against
    the solver's plain `_bcr_solve`, and of the scan crossed both ways
    with `_factor` / `_solve_factored`; the factors' ok flags; whether two
    launches were bit-identical; the solutions (F, n_c, n) of the kernels
    and of the plain `_bcr_solve` and `_solve_factored`; the max abs errors
    of the factors and solves against their plain versions."""
    import torch
    import torch.nn.functional as F

    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    F_, n = Dg.shape[0], Dg.shape[-1]
    Ds, Es = Dg[:, :n_c], Eg[:, :n_c]
    L = r.shape[1]
    b3 = F.pad(r, (0, n_c * n - L)).reshape(F_, n_c, n)
    lv_k, ok_k = k8.bcr_factor(Dg, Eg, live=n_c)
    lv_k2, _ = k8.bcr_factor(Dg, Eg, live=n_c)
    x_k = k8.bcr_solve(lv_k, r)
    x_k2 = k8.bcr_solve(lv_k2, r)
    lv_n, ok_n = k8.bcr_factor_plain(Dg, Eg, live=n_c)
    x_n = k8.bcr_solve_plain(lv_n, r)
    x_nk = k8.bcr_solve(lv_n, r)
    lv_p, ok_p = banded._bcr_factor(Ds, Es)
    x_p = banded._bcr_solve(lv_p, b3, n_c)[:, :L]
    C_k, M_k, sok_k = k8.scan_factor(Ds, Es)
    C_k2, M_k2, _ = k8.scan_factor(Ds, Es)
    C_p, M_p, sok_p = banded._factor(Ds, Es)
    y_p = banded._solve_factored(C_p, M_p, b3)[:, :L]
    y_k = k8.scan_solve(C_k, M_k, r)
    y_k2 = k8.scan_solve(C_k2, M_k2, r)
    y_kp = banded._solve_factored(C_k, M_k, b3)[:, :L]
    y_pk = k8.scan_solve(C_p, M_p, r)
    torch.cuda.synchronize()

    def blocks(levels):
        return [t for lv in levels[:-1] for t in lv if t.numel()] + [
            levels[-1]]

    rel = {"bcr factor": max(rel_err(a, b)[1] for a, b in zip(
               blocks(lv_k), blocks(lv_n))),
           "bcr solve": rel_err(x_k, x_n)[1],
           "bcr plain factor + kernel solve": rel_err(x_nk, x_n)[1],
           "bcr x = S^-1 b": rel_err(x_k, x_p)[1],
           "scan factor": max(rel_err(C_k, C_p)[1], rel_err(M_k, M_p)[1]),
           "scan solve": rel_err(y_k, y_p)[1],
           "scan kernel factor + plain solve": rel_err(y_kp, y_p)[1],
           "scan plain factor + kernel solve": rel_err(y_pk, y_p)[1]}
    same = (all(torch.equal(a, b) for a, b in zip(blocks(lv_k),
                                                  blocks(lv_k2)))
            and torch.equal(x_k, x_k2)
            and torch.equal(C_k, C_k2) and torch.equal(M_k, M_k2)
            and torch.equal(y_k, y_k2))
    oks = [bool(o) for o in (ok_k, ok_n, ok_p, sok_k, sok_p)]

    def chunks(x):
        return F.pad(x, (0, n_c * n - L)).reshape(F_, n_c, n)

    sols = {k: chunks(v) for k, v in
            dict(x_k=x_k, x_p=x_p, y_k=y_k, y_p=y_p).items()}
    errs = dict(f=max(max(_max_abs(a, b) for a, b in zip(
        blocks(lv_k), blocks(lv_n))), _max_abs(C_k, C_p),
        _max_abs(M_k, M_p)),
        s=max(_max_abs(x_nk, x_n), _max_abs(y_pk, y_p)))
    return rel, oks, same, sols, b3, errs


def phase_k8(p, cfg, band):
    """K8 on the long build's band (P = 2,048, 86 -> 128 chunks of n =
    216) against its plain versions on the card, in f32 and f64: K8a
    bit-identical (cyclic reduction's padded layout and the scan's); K8b
    and K8c by cyclic reduction against `bcr_factor_plain` /
    `bcr_solve_plain` and x = S^-1 b against `_bcr_solve`, the scan
    crossed both ways, within TOL_K8_LONG_F64 / TOL_K8_LONG_F32, their
    backward error within K8_RES_FACTOR of the plain solve's, and on a
    damped copy within TOL_K8_DAMPED; two launches bit-identical.  Returns
    the f32 max abs
    errors of (K8a, K8b, K8c) against the plain versions."""
    import numpy as np
    import torch

    from ba_tpu_torch.solver import banded

    P, D = p.poses.q.shape[0], cfg.pose_dim
    F_, P_w, chunk, n_c = banded.chunk_geometry(cfg, P, band.shape[1])
    n = chunk * D
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (F_, P_w * D)), device=band.device)
    errs = dict(a=0.0, f=0.0, s=0.0)
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        bd, r = band.to(dtype), rhs.to(dtype)
        # K8a
        bs_p, sc_p = banded.jacobi_scaled(bd)
        Dg_p, Eg_p = banded.chunk_system(bs_p, cfg, P, D)[:2]
        for bcr in (True, False):
            out = banded.chunk_layout(bd, cfg, P, D, bcr)
            again = banded.chunk_layout(bd, cfg, P, D, bcr)
            torch.cuda.synchronize()
            same = [torch.equal(out[0], bs_p), torch.equal(out[1], sc_p),
                    torch.equal(out[2][:, :n_c], Dg_p),
                    torch.equal(out[3][:, :n_c], Eg_p)]
            m = out[2].shape[1]
            pad_ok = bool((out[2][:, n_c:] == torch.eye(
                n, dtype=dtype, device=bd.device)).all()) and not bool(
                out[3][:, n_c:].any())
            rel = all(torch.equal(a, b) for a, b in zip(out, again))
            say(f"K8a chunk_layout {dt} ({'cyclic reduction' if bcr else 'scan'}"
                f", {n_c} -> {m} chunks): equal to the plain layout "
                f"{all(same)} ({len(same)} outputs), identity pad chunks "
                f"{pad_ok}, bit-identical relaunch {rel}")
            check(all(same) and pad_ok and rel, f"K8a {dt}: differs")
        # K8b, K8c on the long system
        Dg, Eg = banded.chunk_layout(bd, cfg, P, D, True)[2:]
        rel, oks, same, sols, b3, e = _k8_pairs(Dg, Eg, r, n_c)
        say(f"K8b/K8c {dt} on the long band, rel: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel.items())
            + f"; ok flags {oks}; bit-identical relaunch {same}")
        check(all(oks) and same, f"K8 {dt}: a factor failed or relaunch "
              f"differs")
        if dt == "float64":
            lim = dict.fromkeys(rel, TOL_K8_LONG_F64)
        else:
            lim = {k: TOL_K8_LONG_F32["factor"] if k.endswith("factor")
                   else TOL_K8_LONG_F32["plain factor"] if "plain factor"
                   in k else TOL_K8_LONG_F32["solve"] for k in rel}
            errs.update(e)
        bad = {k: v for k, v in rel.items() if not v <= lim[k]}
        check(not bad, f"K8 {dt} on the long band: {bad} over {lim}")
        res = {k: _chunk_residual(Dg[:, :n_c], Eg[:, :n_c], x, b3)
               for k, x in sols.items()}
        say(f"K8 {dt} backward error on the long band: cyclic reduction "
            f"kernels {res['x_k']:.3e}, plain {res['x_p']:.3e}; scan kernels "
            f"{res['y_k']:.3e}, plain {res['y_p']:.3e} (tol "
            f"{K8_RES_FACTOR:g} x plain)")
        check(res["x_k"] <= K8_RES_FACTOR * res["x_p"]
              and res["y_k"] <= K8_RES_FACTOR * res["y_p"],
              f"K8 {dt}: backward error {res}")
        # K8b, K8c on the damped copy
        Dd = Dg.clone()
        Dd[:, :n_c] += K8_DAMP * torch.eye(n, dtype=dtype, device=bd.device)
        rel, oks, same = _k8_pairs(Dd, Eg, r, n_c)[:3]
        say(f"K8b/K8c {dt} on the long band + {K8_DAMP:g} I, rel: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f"; ok flags {oks}; bit-identical relaunch {same} (tol "
            f"{TOL_K8_DAMPED[dt]:g})")
        bad = {k: v for k, v in rel.items() if not v <= TOL_K8_DAMPED[dt]}
        check(all(oks) and same and not bad, f"K8 {dt} damped: {bad}, ok "
              f"{oks}, bit-identical {same}")
    say("PHASE k8 ok")
    return errs


def dense_build_band(p32, cfg, label):
    """The (P, B, D, D) band that one dense build on the banded grid
    densifies (K5b's input)."""
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step

    seen = _recording(asm, "band_to_dense", lambda: step._build_and_solve(
        p32, dataclasses.replace(cfg, use_dogleg=False), True))
    check(len(seen) == 1, f"{label} build densified {len(seen)} bands")
    return seen[0][0][0]


# K5b on bands that are not the main paths': P D not a multiple of 4 (the
# kernel's scalar stores), B > P, the other pose dimensions D = 6 and 15,
# P = 1 and a view whose data starts 4 bytes past a 16-byte boundary (the
# staging's scalar heads); random values with signed zeros
K5B_SHAPES = ((7, 3, 9, 0), (5, 8, 9, 0), (37, 5, 6, 0), (12, 3, 15, 0),
              (1, 2, 9, 0), (9, 4, 9, 1))


def k5b_odd_cases():
    """[(label, f32 band on the card)] of K5B_SHAPES."""
    import numpy as np
    import torch

    from ba_tpu_torch import resolve_device

    out = []
    for P, B, D, off in K5B_SHAPES:
        rng = np.random.default_rng(P * 100 + B * 10 + D)
        flat = rng.standard_normal(P * B * D * D + off)
        flat[::7] = -0.0
        flat[::11] = 0.0
        band = torch.as_tensor(flat, dtype=torch.float32,
                               device=resolve_device())
        band = band[off:].view(P, B, D, D)
        out.append((f"P={P} B={B} D={D}"
                    + (f" (view {4 * off} B past 16)" if off else ""), band))
    return out


def _k5b_parent():
    """The parent tree's K5b module (`--parent`), or None."""
    if PARENT is None:
        return None
    import importlib

    parent_package(PARENT)
    return importlib.import_module("ba_tpu_torch_parent.kernels."
                                   "band_to_dense")


def phase_k5b(cases, timed, floor_ms, smi):
    """K5b against its plain version on each (label, f32 band) of `cases`
    (a flagship build's, a GPS batch build's and K5B_SHAPES), f32 and an
    f64 copy: equal element for element, two launches bit-identical; then
    the bands labelled in `timed` timed beside their bound, the plain
    version and, with `--parent`, the parent's kernel on the same band (no
    single library call computes it).  Returns (f32 max abs error,
    {label: timing record})."""
    import torch

    from ba_tpu_torch.kernels import band_to_dense as k5b
    from ba_tpu_torch.solver import assemble as asm

    worst = 0.0
    for label, band in cases:
        P, B, D, _ = band.shape
        asym = not torch.equal(band[:, 0], band[:, 0].mT)
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            bd = band if dtype == band.dtype else band.to(dtype)
            a, b = k5b.band_to_dense(bd), k5b.band_to_dense(bd)
            want = asm.band_to_dense_plain(bd)
            torch.cuda.synchronize()
            err = _max_abs(a, want)
            say(f"K5b band_to_dense {label} {dt} (P={P}, B={B}, D={D}; "
                f"diagonal blocks not exactly symmetric {asym}): max abs "
                f"err {err:.3e} (tol 0); bit-identical relaunch "
                f"{torch.equal(a, b)}")
            check(torch.equal(a, want) and torch.equal(a, b),
                  f"K5b {label} {dt}: differs from its plain version or "
                  f"between launches")
            if dtype == torch.float32:
                worst = max(worst, err)
            del a, b, want
    parent = _k5b_parent()
    recs = {}
    for label, band in cases:
        if label not in timed:
            continue
        out = k5b.band_to_dense(band)
        nb = nbytes(band, out)
        del out
        bound, by = _bound(nb, 0)
        big = nb > 64e6
        calls, graph_calls = (20, 10) if big else (200, 50)
        ms, dev = _timed(lambda: k5b.band_to_dense(band), calls, graph_calls)
        check(dev is not None, f"K5b {label}: no device time")
        plain = event_ms(lambda: asm.band_to_dense_plain(band),
                         5 if big else 50)
        rec = dict(ms=ms, device_ms=dev, floor_ms=floor_ms, plain_ms=plain,
                   bound_ms=bound, bound_by=by, bytes=nb, library_ms=None,
                   parent_ms=None, parent_device_ms=None)
        line = ""
        if parent is not None:
            old = parent.band_to_dense
            check(torch.equal(old(band), k5b.band_to_dense(band)),
                  f"K5b {label}: the parent's kernel gives another matrix")
            pms, pdev = _timed(lambda: old(band), calls, graph_calls)
            rec.update(parent_ms=pms, parent_device_ms=pdev)
            line = (f"; the parent's kernel {pms:.4f} ms per call "
                    f"({pdev:.4f} ms on the device, {bound / pdev:.1%} of "
                    f"the bound)")
        say(f"[{smi}] K5b band_to_dense, {label} band f32 (P={band.shape[0]},"
            f" B={band.shape[1]}): {ms:.4f} ms per call ({dev:.4f} ms on "
            f"the device, {bound / dev:.1%} of the bound){line}; plain "
            f"(pad/reshape) {plain:.4f} ms; bound {bound:.5f} ms ({by}: "
            f"{nb} B); no library call computes it; launch floor "
            f"{floor_ms:.4f} ms")
        recs[label] = rec
    say("PHASE k5b ok")
    return worst, recs


# ---------------------------------------------------------------------------
# The GPS + IMU pose-graph smoother (ba_tpu_torch/apps/unary_binary_imu_test)


def phase_gps_small(tmp):
    """The smoother on the card against the CPU in f64: the batch solve of
    a GPS_SMALL["fixes"]-fix log and the stream of its first
    GPS_SMALL["stream_fixes"] fixes with W = GPS_SMALL["window"]."""
    import torch

    from ba_tpu_torch.apps import unary_binary_imu_test as app

    path = str(tmp / "gps_small.txt")
    app.generate_log(path, n_gps=GPS_SMALL["fixes"], noise_gps=GPS["noise"])
    imu, gps, gu, parser = app.parse_log(path)
    check(parser == "native", f"GPS: the {parser} parser ran, not the "
          f"native one")
    n, W = GPS_SMALL["stream_fixes"], GPS_SMALL["window"]
    res = {}
    for dev in ("cuda", "cpu"):
        p, cfg = app.build_problem_from_records(imu, gps, gu, device=dev)
        sol, summ = app.solve_batch(p, cfg)
        outs, _ = app.run_streaming(imu, gps[:n], gu[:n], W, device=dev)
        res[dev] = (sol, summ, outs)
    (gs, gsum, gouts), (cs, csum, couts) = res["cuda"], res["cpu"]
    pairs = [(f"batch poses.{f}", getattr(gs.poses, f), getattr(cs.poses, f))
             for f in ("q", "t", "v")]
    pairs.append(("batch final cost",
                  torch.tensor(gsum.final_cost, dtype=torch.float64),
                  torch.tensor(csum.final_cost, dtype=torch.float64)))
    check(len(gouts) == len(couts) == n - W + 1,
          f"GPS small stream: {len(gouts)} and {len(couts)} retired")
    _compare(pairs, f"GPS {GPS_SMALL['fixes']} fixes f64", TOL_SMALL)
    pairs = [(f"stream slide {k} {f}", torch.as_tensor(a[f]).double(),
              torch.as_tensor(b[f]).double())
             for k, (a, b) in enumerate(zip(gouts, couts))
             for f in ("q", "t", "cost")]
    _compare(pairs, f"GPS {n} fixes f64, W = {W}", TOL_SMALL)
    say(f"GPS small batch: {gsum.iterations} iterations, {gsum.result} "
        f"(CPU {csum.iterations}, {csum.result})")
    check((gsum.iterations, gsum.result) == (csum.iterations, csum.result),
          "GPS small batch: another iteration path on the card")
    say("PHASE gps_small ok")
    return app.build_problem_from_records(imu, gps, gu)


def _gps_log(tmp):
    """(imu rows, fixes, dead-reckoned guesses) of the GPS configuration's
    log, generated and parsed by the app (native parser)."""
    from ba_tpu_torch.apps import unary_binary_imu_test as app

    path = str(tmp / "gps.txt")
    t0 = time.perf_counter()
    app.generate_log(path, n_gps=GPS["fixes"], noise_gps=GPS["noise"])
    t1 = time.perf_counter()
    imu, gps, gu, parser = app.parse_log(path)
    say(f"GPS log: {len(imu)} IMU samples, {len(gps)} fixes, generated in "
        f"{t1 - t0:.2f} s, parsed by the {parser} parser in "
        f"{time.perf_counter() - t1:.2f} s")
    check(parser == "native", f"GPS: the {parser} parser ran")
    return imu, gps, gu


def phase_gps_batch(imu, gps, gu, smi):
    """The batch smoother at the GPS configuration: build (f64, then f32
    as the reference app runs it), `solve(max_iter=25, gn_damping=0.2)`
    twice (the first a warm-up that counts host syncs): cost falls, the
    track within a few GPS sigma of the fixes, exact launches of K1 (lm 0),
    K2, segsum, K5b and K5; kf/s, ms per iteration, host syncs per
    iteration.  Returns (record, f32 problem, config)."""
    import numpy as np
    import torch

    from ba_tpu_torch.apps import unary_binary_imu_test as app
    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    p64, cfg = app.build_problem_from_records(imu, gps, gu)
    t_build = time.perf_counter() - t0
    sizes = dict(P=int(p64.poses.t.shape[0]),
                 Ni=int(p64.imu.valid.sum()),
                 M=int(p64.imu.time.shape[1]), B=cfg.band_width,
                 Nr=int(p64.proj.valid.sum()))
    say(f"GPS batch configuration {GPS}: {sizes}, built in {t_build:.2f} s")
    check(sizes == GPS_EXPECTED, f"GPS sizes {sizes} != {GPS_EXPECTED}")
    p32 = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a,
                   p64)
    del p64

    def run():
        out = app.solve_batch(p32, cfg)
        torch.cuda.synchronize()
        return out

    (_, warm), syncs = _sync_count(run)              # warm-up
    _counters_zero()
    t0 = time.perf_counter()
    p, s = run()
    secs = time.perf_counter() - t0
    k1, k2, reads = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    k5b = _k5b_count()
    its = s.iterations
    # a GN iteration makes one trial; the host reads one vector of scalars
    # per iteration
    trials = its
    n = len(gps)
    t_opt = p.poses.t[:n].double().cpu().numpy()
    fixes = np.array([r[1:4] for r in gps])
    err = np.linalg.norm(t_opt - fixes, axis=1)
    say(f"GPS batch f32 solve(25, 0.2): {its} iterations, {s.result}, cost {s.initial_cost:.6g} -> "
        f"{s.final_cost:.6g}; track to fixes mean {err.mean():.4f} m, max "
        f"{err.max():.4f} m (GPS sigma {GPS['noise']} m); kernel launches "
        f"reprojection {k1} segsum {k2} imu_preint (a) {ia} (b) {ib} "
        f"schur_finish {k5} marginalize {k11} band_to_dense {k5b}; same as "
        f"the warm-up run "
        f"{(its, s.final_cost) == (warm.iterations, warm.final_cost)}")
    check(s.is_good, f"GPS batch: result {s.result}")
    check(np.isfinite(t_opt).all() and np.isfinite(s.final_cost),
          "GPS batch: non-finite values")
    check(s.final_cost < s.initial_cost, "GPS batch: cost did not fall")
    check(err.mean() <= 3 * GPS["noise"], f"GPS batch: the track is "
          f"{err.mean():.3g} m from the fixes on average")
    check(reads == its, f"GPS batch: {reads} host reads, expected {its}")
    check(k1 == its + trials + 1, f"GPS batch: {k1} reprojection "
          f"launches, expected {its + trials + 1} (one build per "
          f"iteration, one per trial, one for the error breakdown)")
    check(k2 == its, f"GPS batch: {k2} segsum launches, expected {its}")
    check((ia, ib) == (its + 1, trials + 1), f"GPS batch: imu_preint "
          f"launches ({ia}, {ib}), expected ({its + 1}, {trials + 1})")
    check((k5, k11, k5b) == (its, 0, its), f"GPS batch: schur_finish, "
          f"marginalize, band_to_dense launches ({k5}, {k11}, {k5b}), "
          f"expected ({its}, 0, {its})")
    kf = n * its / secs
    say(f"[{smi}] GPS batch f32: {secs * 1e3:.1f} ms, {kf:.1f} kf/s, "
        f"{secs * 1e3 / its:.2f} ms per iteration; host syncs {syncs} in "
        f"the warm-up solve ({syncs / its:.2f} per iteration; counted reads "
        f"{reads})")
    say("PHASE gps_batch ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, k5b=k5b, kf_s=kf, ms_iter=secs * 1e3 / its,
                syncs=syncs, iters=its, track_mean_m=float(err.mean()),
                track_max_m=float(err.max())), p32, cfg


def phase_gps_stream(imu, gps, gu, smi):
    """The fixed-lag smoother at the GPS configuration, f64, W =
    GPS["window"], reduced to the first GPS["stream_fixes"] fixes: every
    fix through the app's `run_streaming` (`push(block=False)`): retired
    poses per second after the first push, ms per push, host syncs per
    steady push (none), exact launches per slide, K11's branches; the
    retired track against the f64 batch of the same fixes (RMSE under
    GPS_STREAM_RMSE, tests/test_gps_app.py:88)."""
    import numpy as np
    import torch

    from ba_tpu_torch.apps import unary_binary_imu_test as app
    from ba_tpu_torch.kernels.marginalize import Branches as K11Branches
    from ba_tpu_torch.solver.streaming import StreamingRing

    n, W = GPS["stream_fixes"], GPS["window"]
    pb, cfg_b = app.build_problem_from_records(imu, gps[:n], gu[:n])
    sol, sb = app.solve_batch(pb, cfg_b)
    check(sb.is_good, f"GPS f64 batch of {n} fixes: {sb.result}")
    t_batch = sol.poses.t[:n].cpu().numpy()
    del pb, sol

    orig = StreamingRing.push
    syncs, mark = [], {}

    def push(ring, block=True):
        if "first" not in mark:
            return orig(ring, block)
        out, k = _sync_count(lambda: orig(ring, block))
        syncs.append(k)
        return out

    def on_push(g, out):
        if out is not None and "first" not in mark:
            torch.cuda.synchronize()
            mark["first"] = time.perf_counter() - mark["t0"]
            mark["t1"] = time.perf_counter()

    StreamingRing.push = push
    try:
        _counters_zero()
        with K11Branches() as kb:
            mark["t0"] = time.perf_counter()
            outs, ring = app.run_streaming(imu, gps[:n], gu[:n], W,
                                           on_push=on_push)
            torch.cuda.synchronize()
            t_steady = time.perf_counter() - mark["t1"]
        branches = kb.read()
    finally:
        StreamingRing.push = orig
    k1, k2, _ = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    k5b = _k5b_count()
    slides = len(outs)
    steady = slides - 1
    win = ring.current_window()
    traj = np.stack([o["t"] for o in outs]
                    + [win["t"][g % W] for g in range(slides, n)])
    rmse = float(np.sqrt(np.mean(np.sum((traj - t_batch) ** 2, axis=1))))
    costs = np.array([float(o["cost"]) for o in outs])
    it = GPS["iters"]
    # per slide: `it` GN builds and the marginalization's, `it` trials
    want = dict(k1=(2 * it + 1) * slides, k2=(it + 1) * slides,
                imu_a=(it + 1) * slides, imu_b=it * slides,
                k5=(it + 1) * slides, k11=slides, k5b=0)
    got = dict(k1=k1, k2=k2, imu_a=ia, imu_b=ib, k5=k5, k11=k11, k5b=k5b)
    say(f"[{smi}] GPS stream f64 (W={W}, {n} fixes): {slides} poses "
        f"retired; first push (warm-up included) {mark['first']:.2f} s; "
        f"steady state {steady / t_steady:.3f} poses retired/s, "
        f"{1e3 * t_steady / steady:.1f} ms per push over {steady} pushes; "
        f"host syncs per steady push min {min(syncs)} max {max(syncs)}; "
        f"kernel launches {got}")
    say(f"GPS stream f64: K11's certificate settled "
        f"{branches['certified']} of {branches['marginalizations']} "
        f"marginalizations, the Jacobi clip ran on the rest "
        f"({branches['clipped']} clipping an eigenvalue); every info ok "
        f"{branches['ok']}; retired track against the f64 batch RMSE "
        f"{rmse:.4f} m (bound {GPS_STREAM_RMSE} m); last cost "
        f"{costs[-1]:.6g}")
    check(slides == n - W + 1, f"GPS stream: {slides} retired")
    check(np.isfinite(costs).all() and np.isfinite(traj).all(),
          "GPS stream: non-finite costs or states")
    check(rmse < GPS_STREAM_RMSE, f"GPS stream: RMSE {rmse:.4g} m")
    check(got == want, f"GPS stream: launches {got}, expected {want}")
    check(branches["marginalizations"] == slides and branches["ok"],
          f"GPS stream: K11 {branches}")
    check(max(syncs) == 0, f"GPS stream: {max(syncs)} host syncs in a "
          f"steady push")
    say("PHASE gps_stream ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, k5b=k5b, slides=slides, k11_branches=branches,
                poses_s=steady / t_steady, ms_push=1e3 * t_steady / steady,
                syncs_per_push=sum(syncs) / len(syncs), rmse_m=rmse)


# ---------------------------------------------------------------------------
# The matrix-free PCG solver


def _new_counters():
    """(kernel 6, kernel 10, kernel 6's pack) launches since
    `_counters_zero`."""
    from ba_tpu_torch.kernels import fleet_schur, schur_matvec

    return (schur_matvec.schur_matvec.launches,
            fleet_schur.fleet_schur.launches,
            schur_matvec.schur_pack.launches)


def phase_cg_small():
    """The PCG solver on the card against the CPU in f64, on
    simulate(24 poses, 72 landmarks): one `solve_reduced_cg` step, one GN
    iteration with an active marginalization prior, one dogleg `solve`."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import cg, step

    sim = sv.simulate(n_poses=24, n_lms=72, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                       use_cg_solver=True)
        raw, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                     with_marg_prior=False, device=dev)
        p = prepare_landmarks(raw, cfg)
        P, D = p.poses.q.shape[0], cfg.pose_dim
        check(step._reduced_path(p, cfg)[0] == "cg",
              "cg_small: not the CG path")
        _counters_zero()
        bs, mH = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True,
                                                           True))
        s = cg.solve_reduced_cg(bs, mH, cfg, P, D)
        r = {"step delta_p": s.delta_p, "step delta_l": s.delta_l,
             "step ok": s.ok}
        pm, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                    device=dev)
        pm = prepare_landmarks(_random_prior(pm, 0.05, 3), cfg)
        g = step.gn_iteration(pm, cfg, True)
        r.update({"prior GN post_cost": g.post_cost,
                  "prior GN poses.t": g.problem.poses.t,
                  "prior GN lms.x": g.problem.lms.x,
                  "prior GN ok": g.solver_ok})
        k6, _, k6p = _new_counters()
        pd, summ = step.solve(raw, dataclasses.replace(cfg, use_dogleg=True),
                              max_iter=10)
        r["dogleg poses.t"] = pd.poses.t
        r["dogleg lms.x_w"] = pd.lms.x_w
        out[dev] = (r, summ, (k6, k6p))
    (g, gs, (k6, k6p)), (c, cs, _) = out["cuda"], out["cpu"]
    _compare([(k, g[k], c[k]) for k in c]
             + [("dogleg final cost", torch.tensor(gs.final_cost),
                 torch.tensor(cs.final_cost))],
             "PCG solver, 24 poses f64", TOL_SMALL)
    check(all(bool(c[k]) for k in c if k.endswith(" ok")),
          "cg_small: a solve failed")
    path = (gs.iterations, gs.result, gs.inner_iterations)
    say(f"cg_small dogleg: {gs.iterations} iterations, {gs.result}, cost "
        f"{gs.initial_cost:.6g} -> {gs.final_cost:.6g} (CPU {cs.iterations}, "
        f"{cs.result}); schur_matvec launches on the card before the dogleg "
        f"{k6}, schur_pack {k6p}")
    check(path == (cs.iterations, cs.result, cs.inner_iterations),
          "cg_small: dogleg took another path on the card")
    check(gs.final_cost < gs.initial_cost, "cg_small: dogleg cost")
    check(k6 > 0 and k6p == 2, f"cg_small: kernel 6 launched {k6} times, "
          f"its pack {k6p} (one per PCG build)")
    say("PHASE cg_small ok")


def cg_problem(lm_size=1):
    """(f32 problem, config, SimData) of the PCG configuration, prepared;
    lm_size 3 makes its landmarks XYZ points."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = BAConfig(pose_dim=9, lm_size=lm_size, use_dogleg=False,
                   use_cg_solver=True, cg_max_iterations=CG["max_it"],
                   cg_tolerance=CG["tol"])
    sim = sv.simulate(n_poses=CG["poses"], n_lms=CG["lms"], seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               with_marg_prior=False)
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    sizes = dict(P=p.poses.q.shape[0], L=p.lms.x.shape[0],
                 Nr=p.proj.z.shape[0], Nw=p.pidx.wb_pose.shape[0],
                 Ni=int(p.imu.valid.sum()))
    say(f"CG problem (lm_size {lm_size}) {sizes} on {p.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    # XYZ landmarks keep their reference observations as rows
    want = CG_EXPECTED if lm_size == 1 else dict(CG_EXPECTED, **CG_XYZ_ROWS)
    check(sizes == want, f"CG sizes {sizes} != {want}")
    return prepare_landmarks(p, cfg), cfg, sim


def cg_blocks(p, cfg):
    """The block system (with the preconditioner) of one CG build."""
    from ba_tpu_torch.solver import cg, step

    bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               plan=step.solve_plan(p, cfg))
    return bs


def phase_k6(p, cfg, bs, p3, cfg3, bs3):
    """Kernel 6 and its pack against their plain versions at the CG shapes,
    f32 and an f64 copy: the CG build; again with the rows of the first 8
    landmarks given to landmark 0 (the simulator's landmarks have at most
    23 rows, this one more than a warp's 32 lanes); the XYZ-landmark CG
    build (lm 3).  The pack equal element for element, the rows against
    `schur_matvec_sorted_plain` and, summed by pose, against the row-order
    `schur_matvec_plain`, two launches bit-identical; then the packed route
    whole (`cg.s_matvec` on the card: pack, kernel 6, segsum on the sorted
    plan) against the CPU path's S x (row order, plain sums) in f64.
    Returns (f32 max abs errors of the rows and of the pack, x)."""
    import numpy as np
    import torch

    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import cg

    P, D = p.poses.q.shape[0], cfg.pose_dim
    pj = bs.pj
    merged = torch.where(pj.lm < 8, 0, pj.lm)
    cases = (("CG build", bs, pj.lm, 1),
             ("8 landmarks merged", bs, merged, 1),
             ("XYZ-landmark CG build", bs3, bs3.pj.lm, 3))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(P * D),
                        dtype=torch.float32, device=bs.wb.device)
    worst = worst_pack = 0.0
    for what, b_, lm, lm_size in cases:
        q = b_.pj
        L = b_.vinv.shape[0]
        plan = k6.schur_plan(q.pose, q.ref, lm, L)
        longest = int(torch.bincount(lm.long()).max())
        tile_rows = int((plan.tiles[1:] - plan.tiles[:-1]).max())
        if what.startswith("8"):
            check(longest > 32, "k6: the merged landmark fits one warp")
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            args = [t.to(dtype) for t in (q.j_m, q.j_r, q.j_l)]
            vinv, xv = b_.vinv.to(dtype), x.to(dtype)
            pack = k6.schur_pack(*args, plan, lm_size)
            a = k6.schur_matvec(pack, plan, vinv, xv, D)
            b = k6.schur_matvec(pack, plan, vinv, xv, D)
            want_pack = k6.schur_pack_plain(*args, plan, lm_size).rows
            pack_ok = torch.equal(pack.rows, want_pack)
            want = k6.schur_matvec_sorted_plain(
                k6.schur_pack_plain(*[t.double() for t in args], plan,
                                    lm_size), plan, vinv.double(),
                xv.double(), D)
            rows = k6.schur_matvec_plain(*[t.double() for t in args],
                                         q.pose, q.ref, lm, vinv.double(),
                                         xv.double(), D)
            by_pose = torch.zeros((P, 6), dtype=torch.float64,
                                  device=x.device).index_add_(
                0, plan.out_pose, a.double().reshape(-1, 6))
            want_pose = torch.zeros_like(by_pose).index_add_(
                0, torch.cat([q.pose, q.ref]), rows)
            torch.cuda.synchronize()
            err, rel = rel_err(a, want)
            _, rel_p = rel_err(by_pose, want_pose)
            same = bool(torch.equal(a, b))
            say(f"kernel 6 {dt} {what} (Nr={q.j_m.shape[0]}, L={L}, "
                f"lm {lm_size}, longest landmark {longest} rows, "
                f"{plan.tiles.numel() - 1} tiles of at most {tile_rows} "
                f"rows): max abs err {err:.3e} rel {rel:.3e}, summed by pose "
                f"against the row order rel {rel_p:.3e} (tol "
                f"{TOL_K6[dt]:g}); pack equal {pack_ok}; bit-identical "
                f"relaunch {same}")
            check(rel <= TOL_K6[dt] and rel_p <= TOL_K6[dt],
                  f"kernel 6 {dt} {what}: rel {rel:.3g} / {rel_p:.3g}")
            check(pack_ok, f"kernel 6 {dt} {what}: the pack differs")
            check(same, f"kernel 6 {dt} {what}: two launches differ")
            if dt == "float32":
                worst = max(worst, err)
                worst_pack = max(worst_pack, _max_abs(pack.rows, want_pack))
    # the packed route whole, at both landmark sizes
    for what, pp, cc, b_ in (("CG build", p, cfg, bs),
                             ("XYZ-landmark CG build", p3, cfg3, bs3)):
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            b_d = _cast_blocks(b_, dtype)
            xv = x.to(dtype)
            lam = 1e-4 if dtype == torch.float32 else 1e-8
            got = cg.s_matvec(b_d, xv, P, D, 0, lam, None)
            # the CPU path of s_matvec: row order, the plain sums
            want = cg.s_matvec(_cast_blocks(b_, torch.float64, "cpu"),
                               xv.double().cpu(), P, D, 0, lam)
            torch.cuda.synchronize()
            _, rel = rel_err(got.cpu(), want)
            say(f"packed route {dt} {what}: S x (pack, kernel 6, segsum on "
                f"the sorted plan) against the CPU path's (row order) rel "
                f"{rel:.3e} (tol {TOL_K6[dt]:g})")
            check(rel <= TOL_K6[dt], f"packed route {dt} {what}: rel "
                  f"{rel:.3g}")
    say("PHASE k6 ok")
    return worst, worst_pack, x


def _cast_blocks(bs, dtype, device=None):
    """The block system `bs` (nested named tuples) with its floating
    tensors in `dtype`, and every tensor on `device` when given; kernel
    6's records laid out anew on the card (a record's width depends on the
    dtype), none off it."""
    import torch

    from ba_tpu_torch.kernels import schur_matvec as k6

    def cast(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device or v.device,
                        dtype=dtype if v.is_floating_point() else v.dtype)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[cast(f) for f in v])
        return v

    out = cast(bs)
    if out.pack is None:
        return out
    pj = out.pj
    return out._replace(pack=k6.schur_pack(
        pj.j_m, pj.j_r, pj.j_l, out.plan.schur, out.pack.lm, pj.j_c)
        if pj.j_m.is_cuda else None)


def cg_gap_cpu():
    """(delta_p gap, delta_l gap) of the PCG solver's first step against
    the dense solve's, f32 on the CPU at CG_GAP_POSES poses of the PCG
    configuration's simulator."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                   use_cg_solver=True, cg_max_iterations=CG["max_it"],
                   cg_tolerance=CG["tol"])
    sim = sv.simulate(n_poses=CG_GAP_POSES, n_lms=4 * CG_GAP_POSES, seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               with_marg_prior=False, device="cpu")
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    p = prepare_landmarks(p, cfg)
    a = step._build_and_solve(p, cfg, True).step
    b = step._build_and_solve(p, _dense_config(p, cfg), True).step
    return _step_gap(a.delta_p, b.delta_p), _step_gap(a.delta_l, b.delta_l)


def _dense_config(p, cfg):
    """The dense solve of the same build: the banded grid and one dense
    Cholesky."""
    from ba_tpu_torch.solver.assemble import band_width_of

    return dataclasses.replace(cfg, use_cg_solver=False,
                               band_width=band_width_of(p))


def phase_cg(p, cfg, sim, smi):
    """GN solve_fixed(..., 10) of the PCG configuration at full width, then
    its first step against the dense solve's."""
    import torch

    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    n = CG["iters"]
    cost0 = float(evaluate_cost(p, cfg, step._imu_eval(p, cfg, True, False)))
    ate0 = _ate(p, sim)

    def plan():
        out = step.solve_plan(p, cfg)
        torch.cuda.synchronize()
        return out

    plan_first, plan_again = _sync_count(plan)[1], _sync_count(plan)[1]
    step.solve_fixed(p, cfg, True, 1)                      # warm-up
    torch.cuda.synchronize()

    oks, pcgs = [], []
    orig_gn, orig_pcg = step.gn_iteration, cg.pcg_solve

    def gn_recording(*a, **k):
        res = orig_gn(*a, **k)
        oks.append(res.solver_ok)
        return res

    def pcg_recording(*a, **k):
        res = orig_pcg(*a, **k)
        pcgs.append(res)
        return res

    def run():
        out = step.solve_fixed(p, cfg, True, n)
        torch.cuda.synchronize()
        return out

    step.gn_iteration, cg.pcg_solve = gn_recording, pcg_recording
    torch.cuda.reset_peak_memory_stats()
    _counters_zero()
    try:
        t0 = time.perf_counter()
        (q, costs, dns), syncs = _sync_count(run)
        secs = time.perf_counter() - t0
    finally:
        step.gn_iteration, cg.pcg_solve = orig_gn, orig_pcg
    k1, k2, reads = _counters()
    k6, _, k6p = _new_counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    peak = torch.cuda.max_memory_allocated()
    costs_h = costs.double().cpu()
    ate1 = _ate(q, sim)
    all_ok = bool(torch.stack(oks).all())
    its = [int(r.iterations) for r in pcgs]
    matvecs = sum(r.matvecs for r in pcgs)
    pcg_reads = [r.reads for r in pcgs]
    kf = CG["poses"] * n / secs
    max_reads = -(-CG["max_it"] // cg.CG_CHECK_EVERY)
    say(f"CG GN solve_fixed({n}) f32: cost {cost0:.6g} -> "
        f"{float(costs_h[-1]):.6g}, ATE {ate0:.6g} -> {ate1:.6g} m, "
        f"solver_ok at every iteration {all_ok}; PCG iterations per build "
        f"{its} (cap {CG['max_it']}, tol {CG['tol']:g}); Schur products "
        f"launched {matvecs}; kernel launches reprojection {k1} segsum {k2} "
        f"schur_matvec {k6} schur_pack {k6p} imu_preint (a) {ia} (b) {ib}")
    say(f"[{smi}] CG GN solve_fixed({n}): {secs * 1e3:.1f} ms, "
        f"{secs * 1e3 / n:.1f} ms per iteration, {kf:.1f} kf/s; peak device "
        f"memory {peak / 2**30:.3f} GiB; host syncs {syncs} (the plans' "
        f"{plan_again}; {plan_first} at the process's first plan), per build "
        f"{pcg_reads} (at most {max_reads}: one read of the stop test every "
        f"{cg.CG_CHECK_EVERY} iterations)")
    check(bool(torch.isfinite(costs_h).all()) and _finite(q),
          "cg: non-finite values")
    check(float(costs_h[-1]) < cost0, "cg: cost did not fall")
    check(ate1 < ate0, "cg: ATE did not fall")
    check(len(oks) == n and all_ok, "cg: solver_ok failed")
    check(len(pcgs) == n, f"cg: {len(pcgs)} PCG solves in {n} iterations")
    want = (2 * n, K2_PER_CG_BUILD * n + matvecs, matvecs)
    check((k1, k2, k6) == want, f"cg: launches {(k1, k2, k6)}, expected "
          f"{want}")
    check((ia, ib) == (n, n), f"cg: imu_preint launches ({ia}, {ib})")
    check(k6p == n, f"cg: schur_pack launches {k6p}, one per build")
    check((k5, k11) == (0, 0), f"cg: schur_finish, marginalize launches "
          f"({k5}, {k11}) on the PCG solver")
    check(max(pcg_reads) <= max_reads, f"cg: {max(pcg_reads)} host reads in "
          "one PCG solve")
    check(syncs - plan_again == sum(pcg_reads) == reads,
          f"cg: {syncs - plan_again} host syncs, {reads} counted reads, "
          f"{sum(pcg_reads)} PCG stop tests")

    gap_p, gap_l = cg_gap_cpu()
    a = step._build_and_solve(p, cfg, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = step._build_and_solve(p, _dense_config(p, cfg), True)
    torch.cuda.synchronize()
    peak_d = torch.cuda.max_memory_allocated()
    got_p = _step_gap(a.step.delta_p, b.step.delta_p)
    got_l = _step_gap(a.step.delta_l, b.step.delta_l)
    post = [float(step._cost(step.apply_update(p, cfg, s.step.delta_p,
                                               s.step.delta_l),
                             cfg, True, s.proj_w, s.imu_c9))
            for s in (a, b)]
    say(f"CG first step, PCG against dense: delta_p gap {got_p:.3e} (tol "
        f"{CG_GAP_FACTOR:g} x {gap_p:.3e}, the f32 CPU gap at {CG_GAP_POSES} "
        f"poses), delta_l gap {got_l:.3e} (tol {CG_GAP_FACTOR:g} x "
        f"{gap_l:.3e}); trial cost {post[0]:.6g} PCG, {post[1]:.6g} dense "
        f"(from {cost0:.6g}); both ok {bool(a.step.ok)}/{bool(b.step.ok)}; "
        f"[{smi}] peak device memory of the dense build {peak_d / 2**30:.3f} "
        "GiB")
    check(bool(a.step.ok) and bool(b.step.ok), "cg: a solve failed")
    check(got_p <= CG_GAP_FACTOR * gap_p and got_l <= CG_GAP_FACTOR * gap_l,
          "cg: the PCG step is off the dense one")
    say("PHASE cg ok")
    return dict(k1=k1, k2=k2, k6=k6, k6_pack=k6p, imu=ia + ib, imu_a=ia,
                imu_b=ib,
                k5=k5, k11=k11, kf_s=kf, ms_iter=secs * 1e3 / n,
                peak_gib=peak / 2**30, cg_iters=its, syncs_per_build=pcg_reads,
                gap_p=got_p, gap_l=got_l)


# ---------------------------------------------------------------------------
# The fused vehicle fleet


def _fleet_windows(sim, n, seed0, dev="cuda", dtype=None, **build):
    import torch

    from ba_tpu_torch.core.problem import BAConfig
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    out = []
    for v in range(n):
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=seed0 + v,
                                   device=dev, **build)
        if dtype is not None:
            p = tree_map(lambda a: a.to(dtype)
                         if a.dtype == torch.float64 else a, p)
        out.append(p)
    return out


def _fuse(windows, F):
    from ba_tpu_torch.core.problem import (BAConfig, concat_problems,
                                           prepare_landmarks)
    from ba_tpu_torch.solver.assemble import band_width_of

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    fused = concat_problems(windows, cfg)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(fused),
                              use_banded_solver=True, fleet_size=F)
    return prepare_landmarks(fused, cfg), cfg


def phase_fleet_small():
    """Both fleet branches on the card against the CPU in f64: two windows
    of one scene (simulate(12, 30)) on the dense fleet solve, and windows of
    30 and 31 landmarks (an odd landmark count) on the banded solver with a
    fleet axis; one build's step and two GN iterations each."""
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import step

    sims = [sv.simulate(n_poses=12, n_lms=n, seed=0) for n in (30, 31)]
    out = {}
    for dev in ("cuda", "cpu"):
        r, paths = {}, {}
        for kind, ws in (
                ("dense", _fleet_windows(sims[0], 2, 1, dev)),
                ("banded", _fleet_windows(sims[0], 1, 1, dev)
                 + _fleet_windows(sims[1], 1, 2, dev))):
            p, cfg = _fuse(ws, 2)
            paths[kind] = step._reduced_path(p, cfg)[0]
            _counters_zero()
            built = step._build_and_solve(p, cfg, True)
            q, costs, _ = step.solve_fixed(p, cfg, True, 2)
            r.update({f"{kind} delta_p": built.step.delta_p,
                      f"{kind} delta_l": built.step.delta_l,
                      f"{kind} ok": built.step.ok, f"{kind} costs": costs,
                      f"{kind} poses.t": q.poses.t})
            paths[f"{kind} launches"] = _new_counters()[1]
        out[dev] = (r, paths)
    (g, paths), (c, cpaths) = out["cuda"], out["cpu"]
    say(f"fleet_small paths {paths['dense']} / {paths['banded']} (CPU "
        f"{cpaths['dense']} / {cpaths['banded']}); fleet_schur calls on "
        f"the card: dense {paths['dense launches']}, banded "
        f"{paths['banded launches']}")
    check((paths["dense"], paths["banded"]) == ("fleet_dense", "banded")
          == (cpaths["dense"], cpaths["banded"]),
          "fleet_small: not the two fleet branches")
    check(paths["dense launches"] == 3 and paths["banded launches"] == 0,
          "fleet_small: kernel 10 launches off")
    _compare([(k, g[k], c[k]) for k in c], "fleet, 2 x 12 poses f64",
             TOL_SMALL)
    check(all(bool(c[k]) and bool(g[k]) for k in c if k.endswith(" ok")),
          "fleet_small: a solve failed")
    say("PHASE fleet_small ok")


def fleet_problem():
    """(fused f32 problem, config, SimData, prepared f32 windows) of the
    fleet configuration."""
    import torch

    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv

    t0 = time.perf_counter()
    sim = sv.simulate(n_poses=FLEET["poses"], n_lms=FLEET["lms"], seed=0)
    windows = _fleet_windows(sim, FLEET["vehicles"], 1, dtype=torch.float32)
    p, cfg = _fuse(windows, FLEET["vehicles"])
    sizes = dict(P=p.poses.q.shape[0], L=p.lms.x.shape[0],
                 Nr=p.proj.z.shape[0], Nw=p.pidx.wb_pose.shape[0],
                 B=cfg.band_width, H=tuple(p.marg.H.shape))
    say(f"fleet problem {sizes} on {p.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(sizes == FLEET_EXPECTED, f"fleet sizes {sizes} != "
          f"{FLEET_EXPECTED}")
    return p, cfg, sim, [prepare_landmarks(w, cfg) for w in windows]


def fleet_blocks(p, cfg):
    """(block system, plan) of one build of the fused fleet."""
    from ba_tpu_torch.solver import cg, step

    plan = step.solve_plan(p, cfg)
    bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               with_precond=False, plan=plan)
    return bs, plan


def fleet_inputs(F, lm, P_w=24, L_w=40, D=9, span=2, pad=5, masked=True,
                 seed=0, device="cpu"):
    """(wb, vinv, wb_pose, wb_lm, band), random f64 inputs of kernel 10 for
    F windows: W blocks of landmarks each seen by the poses within `span`
    of its own (distant tile pairs share no landmark), `pad` padding
    blocks (landmark id L), the landmarks' SPD inverses, and each window's
    SPD U on a full-width band, with the masked dims (pose 3, dims 0-2) as
    identity rows and zero W rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P, L = F * P_w, F * L_w
    poses, lms = [], []
    for f in range(F):
        for l in range(L_w):
            c = l * P_w // L_w
            for p in range(max(0, c - span), min(P_w, c + span + 1)):
                poses.append(f * P_w + p)
                lms.append(f * L_w + l)
    poses += list(rng.integers(0, P, pad))
    lms += [L] * pad
    wb_pose = torch.tensor(poses, dtype=torch.int32)
    wb_lm = torch.tensor(lms, dtype=torch.int32)
    wb = torch.as_tensor(rng.standard_normal((len(poses), 6, lm)))
    A = rng.standard_normal((L, lm, lm))
    vinv = torch.as_tensor(A @ A.transpose(0, 2, 1) + np.eye(lm))
    n_w = P_w * D
    keep = np.ones(n_w, bool)
    if masked:
        keep[3 * D:3 * D + 3] = False
        wb[(wb_pose % P_w == 3) & (wb_lm < L), :3] = 0.0
    band = torch.zeros((P, P_w, D, D), dtype=torch.float64)
    for f in range(F):
        G = rng.standard_normal((n_w, n_w))
        U = G @ G.T + n_w * np.eye(n_w)
        U[~keep] = 0.0
        U[:, ~keep] = 0.0
        U[~keep, ~keep] = 1.0
        for p in range(P_w):
            for d in range(P_w - p):
                band[f * P_w + p, d] = torch.as_tensor(
                    U[p * D:(p + 1) * D, (p + d) * D:(p + d + 1) * D])
    return tuple(t.to(device) for t in (wb, vinv, wb_pose, wb_lm, band))


def _k10_work(table, F, D, lm):
    """(operations, the products' count) of kernel 10's Schur step on the
    plan `table` (P, L_w): for every lower element (i, j) of a window,
    2 lm multiply-adds per landmark rows i and j share, and 2 lm^2 per
    (row, landmark) for W V^-1; and 4 per element for the scaling."""
    import torch

    P, L_w = table.shape
    P_w, n_w = P // F, (P // F) * D
    has = (table >= 0).to(torch.float64).reshape(F, P_w, 1, L_w).expand(
        F, P_w, 6, L_w)
    Hw = torch.zeros((F, P_w, D, L_w), dtype=torch.float64,
                     device=table.device)
    Hw[:, :, :6] = has
    Hw = Hw.reshape(F, n_w, L_w)
    shared = torch.tril(Hw @ Hw.mT).sum()
    rows_lms = Hw.sum()
    ops = 2 * lm * float(shared) + 2 * lm * lm * float(rows_lms) \
        + 4 * F * n_w * (n_w + 1) / 2
    return ops, float(shared)


def phase_k10(p, cfg, bs, plan):
    """Kernel 10 against its plain version (`fleet_schur_plain`) at the
    fleet's shapes, f32 and an f64 copy, with padding W blocks; and with
    XYZ-sized landmarks (lm 3, random W blocks and inverses on the fleet's
    table); Ss exactly symmetric and equal to the plain version's on the
    lower triangle (the one the Cholesky reads: the plain version's upper
    triangle keeps the band's diagonal blocks' rounding asymmetry), two
    launches bit-identical.  Returns the f32 max abs errors (the fleet's
    own W blocks, lm 3)."""
    import torch

    from ba_tpu_torch.kernels import fleet_schur as k10
    from ba_tpu_torch.solver import banded

    P, L, D, F = (p.poses.q.shape[0], p.lms.x.shape[0], cfg.pose_dim,
                  cfg.fleet_size)
    idx = p.pidx
    pad, dev = 64, bs.wb.device
    wb_pose = torch.cat([idx.wb_pose, torch.arange(
        pad, dtype=torch.int32, device=dev) % P])
    wb_lm = torch.cat([idx.wb_lm, torch.full((pad,), L, dtype=torch.int32,
                                             device=dev)])
    table = k10.fleet_plan(wb_pose, wb_lm, P, L, F)
    band = banded.fleet_band(bs, cfg, P, D, plan.fleet)
    g = torch.Generator(device="cpu").manual_seed(10)
    W3 = torch.randn((wb_pose.shape[0], 6, 3), generator=g,
                     dtype=torch.float64)
    A = torch.randn((L, 3, 3), generator=g, dtype=torch.float64)
    V3 = 1e-3 * (A @ A.mT + torch.eye(3, dtype=torch.float64))
    cases = [("lm 1", torch.cat([bs.wb, torch.full((pad, 6, 1), 1e3,
                                                   device=dev)]), bs.vinv),
             ("lm 3", W3.to(dev), V3.to(dev))]
    worst = {}
    for lab, Wb_c, vinv_c in cases:
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            Wb, vinv, bd = Wb_c.to(dtype), vinv_c.to(dtype), band.to(dtype)
            eps = 1e-8 if dtype == torch.float64 else 1e-4
            x = k10.fleet_schur(Wb, vinv, table, bd, F, eps)
            y = k10.fleet_schur(Wb, vinv, table, bd, F, eps)
            want = k10.fleet_schur_plain(Wb.double(), vinv.double(),
                                         wb_pose, wb_lm, bd.double(), F, eps)
            torch.cuda.synchronize()
            sym = bool(torch.equal(x[0], x[0].mT))
            # the band's diagonal blocks carry the build's rounding
            # asymmetry, which the plain route's upper triangle keeps; the
            # kernel mirrors the lower one, which the Cholesky reads
            asym = float((want[0] - want[0].mT).abs().max())
            say(f"kernel 10 {lab} {dt}: plain Ss asymmetric by {asym:.3e}; "
                "compared on the lower triangle")
            for part, got, again, ref in (
                    ("Ss", torch.tril(x[0]), torch.tril(y[0]),
                     torch.tril(want[0])),
                    ("scal", x[1], y[1], want[1])):
                err, rel = rel_err(got, ref)
                same = bool(torch.equal(got, again))
                say(f"kernel 10 {lab} {dt} {part} {tuple(got.shape)} "
                    f"(Nw={Wb.shape[0]} with {pad} padding blocks): max abs "
                    f"err {err:.3e} rel {rel:.3e} (tol {TOL_K10[dt]:g}); "
                    f"bit-identical relaunch {same}"
                    + (f"; Ss exactly symmetric {sym}" if part == "Ss"
                       else ""))
                check(rel <= TOL_K10[dt], f"kernel 10 {lab} {dt} {part}: "
                      f"rel {rel:.3g}")
                check(same, f"kernel 10 {lab} {dt} {part}: two launches "
                      "differ")
                if dt == "float32":
                    worst[lab] = max(worst.get(lab, 0.0), err)
            check(sym, f"kernel 10 {lab} {dt}: Ss is not symmetric")
            del want, x, y
    say("PHASE k10 ok")
    return worst["lm 1"], worst["lm 3"]


def _window_state(fused, w, v, P_w, L_w):
    """Window `w` (prepared) holding window v's states of the fused
    problem."""
    sl, sll = slice(v * P_w, (v + 1) * P_w), slice(v * L_w, (v + 1) * L_w)
    poses = dataclasses.replace(w.poses, **{
        k: getattr(fused.poses, k)[sl] for k in ("q", "t", "v", "b")})
    lms = dataclasses.replace(w.lms, x=fused.lms.x[sll])
    return dataclasses.replace(w, poses=poses, lms=lms)


def _window_costs(fused, windows, cfg, sim):
    """[(cost, ATE)] of each window of the fused problem."""
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    P_w = FLEET["poses"]
    L_w = fused.lms.x.shape[0] // len(windows)
    out = []
    for v, w in enumerate(windows):
        wv = _window_state(fused, w, v, P_w, L_w)
        out.append((float(evaluate_cost(wv, cfg, step._imu_eval(
            wv, cfg, True, False))), _ate(wv, sim)))
    return out


def phase_fleet(p, cfg, sim, windows, smi):
    """GN solve_fixed(..., 25) of the fused fleet at full width on the
    dense fleet solve; one GN iteration against the chunked banded path."""
    import torch

    from ba_tpu_torch.solver import banded, step

    n = FLEET["iters"]
    check(step._reduced_path(p, cfg)[0] == "fleet_dense",
          "fleet: not the dense fleet solve")
    before = _window_costs(p, windows, cfg, sim)

    def plan():
        out = step.solve_plan(p, cfg)
        torch.cuda.synchronize()
        return out

    plan_first, plan_again = _sync_count(plan)[1], _sync_count(plan)[1]
    step.solve_fixed(p, cfg, True, 1)                      # warm-up
    torch.cuda.synchronize()
    oks, solves = [], []
    orig_gn, orig_fd = step.gn_iteration, banded.solve_reduced_fleet_dense

    def gn_recording(*a, **k):
        res = orig_gn(*a, **k)
        oks.append(res.solver_ok)
        return res

    def fd_recording(*a, **k):
        solves.append(1)
        return orig_fd(*a, **k)

    def run():
        out = step.solve_fixed(p, cfg, True, n)
        torch.cuda.synchronize()
        return out

    step.gn_iteration, banded.solve_reduced_fleet_dense = (gn_recording,
                                                           fd_recording)
    torch.cuda.reset_peak_memory_stats()
    _counters_zero()
    try:
        t0 = time.perf_counter()
        (q, costs, _), syncs = _sync_count(run)
        secs = time.perf_counter() - t0
    finally:
        step.gn_iteration, banded.solve_reduced_fleet_dense = (orig_gn,
                                                               orig_fd)
    k1, k2, reads = _counters()
    k10 = _new_counters()[1]
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    peak = torch.cuda.max_memory_allocated()
    costs_h = costs.double().cpu()
    after = _window_costs(q, windows, cfg, sim)
    all_ok = bool(torch.stack(oks).all())
    kf = FLEET["vehicles"] * FLEET["poses"] * n / secs
    say(f"fleet GN solve_fixed({n}) f32, {FLEET['vehicles']} windows: fused "
        f"cost {float(costs_h[0]):.6g} -> {float(costs_h[-1]):.6g}; per "
        "window (cost, ATE m) "
        + "; ".join(f"{b[0]:.6g} -> {a[0]:.6g}, {b[1]:.4g} -> {a[1]:.4g}"
                    for b, a in zip(before, after))
        + f"; solver_ok at every iteration {all_ok}; dense fleet solves "
        f"{len(solves)}; kernel launches reprojection {k1} segsum {k2} "
        f"fleet_schur {k10} imu_preint (a) {ia} (b) {ib}")
    say(f"[{smi}] fleet GN solve_fixed({n}): {secs * 1e3:.1f} ms, "
        f"{secs * 1e3 / n:.1f} ms per iteration, {kf:.1f} kf/s "
        f"({FLEET['vehicles']} x {FLEET['poses']} x {n} / wall); peak device "
        f"memory {peak / 2**30:.3f} GiB; host syncs {syncs} (the plans' "
        f"{plan_again}; {plan_first} at the process's first plan), "
        f"{(syncs - plan_again) / n:.2f} per iteration")
    check(bool(torch.isfinite(costs_h).all()) and _finite(q),
          "fleet: non-finite values")
    check(all(a[0] < b[0] and a[1] < b[1] for b, a in zip(before, after)),
          "fleet: a window's cost or ATE did not fall")
    check(len(oks) == n and all_ok, "fleet: solver_ok failed")
    check(len(solves) == n, f"fleet: {len(solves)} dense fleet solves")
    want = (2 * n, K2_PER_FLEET_BUILD * n, n)
    check((k1, k2, k10) == want, f"fleet: launches {(k1, k2, k10)}, "
          f"expected {want}")
    check((ia, ib) == (n, n), f"fleet: imu_preint launches ({ia}, {ib})")
    check((k5, k11) == (0, 0), f"fleet: schur_finish, marginalize launches "
          f"({k5}, {k11}) on the dense fleet solve (kernel 10)")
    check(syncs == plan_again, f"fleet: {syncs - plan_again} host syncs in "
          f"{n} iterations")

    # one iteration against the chunked banded path (tests/test_fleet.py)
    r4 = step.gn_iteration(p, cfg, True)
    cfg1 = dataclasses.replace(cfg, fleet_size=1)
    check(step._reduced_path(p, cfg1)[0] == "banded", "fleet: F=1 not banded")
    r1 = step.gn_iteration(p, cfg1, True)
    pre = abs(float(r4.pre_cost) - float(r1.pre_cost)) / float(r1.pre_cost)
    post = abs(float(r4.post_cost) - float(r1.post_cost)) / float(
        r1.post_cost)
    dt_ = float((r4.problem.poses.t - r1.problem.poses.t).abs().max())
    say(f"fleet one GN iteration, fleet_size {cfg.fleet_size} against 1 "
        f"(chunked banded): pre_cost rel {pre:.3e} (tol "
        f"{FLEET_VS_BANDED['pre_cost']:g}), post_cost "
        f"{float(r4.post_cost):.6g} / {float(r1.post_cost):.6g} rel "
        f"{post:.3e} (tol "
        f"{FLEET_VS_BANDED['post_cost']:g}), poses.t max abs diff {dt_:.3e} m "
        f"(tol {FLEET_VS_BANDED['poses_t']:g}); ok {bool(r4.solver_ok)}/"
        f"{bool(r1.solver_ok)}")
    check(bool(r4.solver_ok) and bool(r1.solver_ok), "fleet: a solve failed")
    check(pre <= FLEET_VS_BANDED["pre_cost"]
          and post <= FLEET_VS_BANDED["post_cost"]
          and dt_ <= FLEET_VS_BANDED["poses_t"],
          "fleet: fleet_size 4 and 1 disagree")
    say("PHASE fleet ok")
    return dict(k1=k1, k2=k2, k10=k10,
                imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5, k11=k11, kf_s=kf,
                ms_iter=secs * 1e3 / n, peak_gib=peak / 2**30,
                costs_after=[a[0] for a in after],
                ate_after=[a[1] for a in after])


def schur_product_parts(bs, x, P, D, lm_size):
    """{name: call} of one Schur product of `bs` (f32, on the card) and its
    parts: the whole `cg.s_matvec`, kernel 6, segsum's launch (kernel 6's
    rows with the unary and binary rows, and the IMU rows), and kernel 6's
    pack (once per build, in `cg.assemble_blocks`); with the build's pack
    and the segsum groups."""
    import torch

    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver import cg

    pj, plan = bs.pj, bs.plan.schur

    def pack_call():
        return k6.schur_pack(pj.j_m, pj.j_r, pj.j_l, plan, lm_size, pj.j_c)

    pack = bs.pack
    K = pack.K
    xm = torch.where(bs.col_mask, x, 0.0)
    flat = [(v.reshape(v.shape[0], -1).contiguous(), sp)
            for v, sp in cg._s_groups(bs, xm, P, D)[0]]
    xk = xm[P * D:] if K else None
    parts = {
        "whole product": lambda: cg.s_matvec(bs, x, P, D, K, 1e-4, None),
        "kernel 6": lambda: k6.schur_matvec(pack, plan, bs.vinv,
                                            xm[: P * D], D, xk=xk),
        "segsum": lambda: segsum.seg_sum_grouped(flat),
        "pack": pack_call}
    return parts, pack, flat


def phase_timing_cg_fleet(pc, cfg_c, bs_c, x_c, pf, cfg_f, bs_f, plan_f,
                          floor_ms, smi):
    """Kernels 6 and 10 timed at full width beside their bounds, plain
    versions and library yardsticks (torch.mv on the dense S of the same CG
    build; torch.bmm of the dense W operands, the product kernel 10
    replaces), kernel 10's device memory beside the plain route's, and the
    library parts of the dense fleet solve timed apart.  Kernel 6's pack
    (once per build) and the segsum launch of one Schur product (kernel 6's
    rows, the unary and binary rows and the IMU rows) are timed apart, and
    the whole product; with `--parent`, the parent tree's kernel 6 on the
    same build beside this tree's."""
    import torch

    from ba_tpu_torch.kernels import fleet_schur as k10
    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step

    # kernel 6: the pack once per build, then one launch per product
    P, D = pc.poses.q.shape[0], cfg_c.pose_dim
    pj, plan = bs_c.pj, bs_c.plan.schur
    L = bs_c.vinv.shape[0]
    Nr = pj.j_m.shape[0]
    x = x_c
    lm = cfg_c.lm_size
    parts, pack, flat = schur_product_parts(bs_c, x, P, D, lm)
    k6_call, seg_call = parts["kernel 6"], parts["segsum"]
    pack_call, product = parts["pack"], parts["whole product"]

    # bytes as the function needs them: J_m, J_r and j_l (24 + 2 lm values)
    # and the pose, ref and landmark ids (12 B) of each row, the tile table,
    # V^-1 (lm > 0) and x read once, the rows written once; the route reads
    # the records' pad and the ids' group field besides (`route_bytes`)
    out6 = k6_call()
    b6_bytes = (Nr * ((24 + 2 * lm) * x.element_size() + 12)
                + nbytes(plan.tiles, x, out6)
                + (nbytes(bs_c.vinv) if lm else 0))
    route_bytes = nbytes(pack.rows, plan.ids, plan.tiles, bs_c.vinv, x,
                         out6)
    # per row: u (24 multiply-adds), j_l^T u (2), w (2), 12 outputs of 2
    # multiply-adds; per landmark one product with V^-1
    b6_flops = Nr * 2 * (24 + 2 + 2 + 24) + L
    b6, by6 = _bound(b6_bytes, b6_flops)
    bp_bytes = nbytes(pj.j_m, pj.j_r, pj.j_l, plan.perm, pack.rows)
    bp, byp = _bound(bp_bytes, 0)
    # segsum's launch in the product, on the groups the product sums
    bs_bytes = sum(nbytes(v, sp.perm) + sp.nseg * v.shape[1]
                   * v.element_size() for v, sp in flat)
    bs_ops = sum(v.numel() for v, _ in flat)
    bseg, byseg = _bound(bs_bytes, bs_ops)
    sorted_plain = k6.schur_pack_plain(pj.j_m, pj.j_r, pj.j_l, plan, lm)
    cfg_d = _dense_config(pc, cfg_c)
    S = asm.assemble(pc, cfg_d, imu_eval=step._imu_eval(pc, cfg_d, True,
                                                        True)).S
    xs = torch.zeros(S.shape[0], dtype=x.dtype, device=x.device)
    xs[: x.numel()] = x
    t6 = dict(ms=event_ms(k6_call, 200), device_ms=graph_ms(k6_call, 50),
              plain_ms=event_ms(lambda: k6.schur_matvec_sorted_plain(
                  sorted_plain, plan, bs_c.vinv, x, D), 10),
              row_order_plain_ms=event_ms(lambda: k6.schur_matvec_plain(
                  pj.j_m, pj.j_r, pj.j_l, pj.pose, pj.ref, pj.lm, bs_c.vinv,
                  x, D), 20),
              library_ms=event_ms(lambda: torch.mv(S, xs), 50),
              library_device_ms=graph_ms(lambda: torch.mv(S, xs), 20))
    del S
    tp = dict(ms=event_ms(pack_call, 100), device_ms=graph_ms(pack_call, 20),
              plain_ms=event_ms(lambda: k6.schur_pack_plain(
                  pj.j_m, pj.j_r, pj.j_l, plan, lm), 20))
    ts = dict(ms=event_ms(seg_call, 200), device_ms=graph_ms(seg_call, 50))
    tw = dict(ms=event_ms(product, 100), device_ms=graph_ms(product, 20))
    parent = None
    if PARENT is not None:
        import importlib

        parent_package(PARENT)
        pk6 = importlib.import_module("ba_tpu_torch_parent.kernels."
                                      "schur_matvec")
        xm = torch.where(bs_c.col_mask, x, 0.0)[: P * D]

        def parent_call():   # the parent's kernel 6 on this tree's pack
            return pk6.schur_matvec(pk6.SchurPack(pack.rows, pack.lm), plan,
                                    bs_c.vinv, xm, D)

        parent = dict(ms=event_ms(parent_call, 200),
                      device_ms=graph_ms(parent_call, 50))

    def vs_parent(key):
        return (f"; the parent's kernel {parent[key]:.4f} ms" if parent
                else "; the parent's kernel not timed (no --parent)")

    say(f"[{smi}] kernel 6 schur_matvec, CG build (Nr={Nr}, L={L}, P={P}) "
        f"f32: {t6['ms']:.4f} ms per call{vs_parent('ms')}; "
        f"{t6['device_ms']:.4f} ms on the device{vs_parent('device_ms')}; "
        f"{b6 / t6['device_ms']:.1%} of the bound {b6:.5f} ms ({by6}: "
        f"{b6_bytes} B, {b6_flops} flop; the route reads and writes "
        f"{route_bytes} B with the records' pad and the ids' group field); "
        f"plain (sorted order) "
        f"{t6['plain_ms']:.4f} ms, row order {t6['row_order_plain_ms']:.4f} "
        f"ms; torch.mv on the dense S of the same build ({P * D}^2) "
        f"{t6['library_ms']:.4f} ms ({t6['library_device_ms']:.4f} ms on the "
        f"device); launch floor {floor_ms:.4f} ms")
    say(f"[{smi}] kernel 6's pack, once per build: {tp['ms']:.4f} ms per "
        f"call ({tp['device_ms']:.4f} ms on the device, "
        f"{bp / tp['device_ms']:.1%} of the bound {bp:.5f} ms, {byp}: "
        f"{bp_bytes} B); plain {tp['plain_ms']:.4f} ms")
    say(f"[{smi}] segsum in one Schur product ("
        + ", ".join(f"{v.shape[0]}x{v.shape[1]}->{sp.nseg}" for v, sp in flat)
        + f") f32: {ts['ms']:.4f} ms per call ({ts['device_ms']:.4f} ms on "
        f"the device, {bseg / ts['device_ms']:.1%} of the bound {bseg:.5f} "
        f"ms, {byseg}: {bs_bytes} B, {bs_ops} adds); the whole product "
        f"(cg.s_matvec) {tw['ms']:.4f} ms per call, {tw['device_ms']:.4f} ms "
        f"on the device")
    rec6 = dict(ms=t6["ms"], device_ms=t6["device_ms"], floor_ms=floor_ms,
                plain_ms=t6["plain_ms"],
                row_order_plain_ms=t6["row_order_plain_ms"], bound_ms=b6,
                bound_by=by6, bytes=b6_bytes, route_bytes=route_bytes,
                library_ms=t6["library_ms"],
                library_device_ms=t6["library_device_ms"], parent=parent,
                product=tw)
    rec6p = dict(ms=tp["ms"], device_ms=tp["device_ms"], floor_ms=floor_ms,
                 plain_ms=tp["plain_ms"], bound_ms=bp, bound_by=byp,
                 bytes=bp_bytes, library_ms=None)
    rec_seg = dict(ts, bound_ms=bseg, bound_by=byseg, bytes=bs_bytes)

    # kernel 10
    from ba_tpu_torch.solver import banded

    P, L, D, F = (pf.poses.q.shape[0], pf.lms.x.shape[0], cfg_f.pose_dim,
                  cfg_f.fleet_size)
    idx = pf.pidx
    table = plan_f.fleet.table
    band = banded.fleet_band(bs_f, cfg_f, P, D, plan_f.fleet)
    eps = 1e-4
    Wb, vinv = bs_f.wb, bs_f.vinv
    lm = vinv.shape[1]
    Ss, scal = k10.fleet_schur(Wb, vinv, table, band, F, eps)

    def k10_call():
        return k10.fleet_schur(Wb, vinv, table, band, F, eps)

    # the library yardstick: the batched product the kernel replaces, on
    # the dense operands of the plain route (built once, outside the
    # timing)
    W_T, WVi_T = k10.fleet_w_plain(Wb, vinv, idx.wb_pose, idx.wb_lm, F, P, D)

    def lib_call():
        return torch.bmm(WVi_T.mT, W_T)

    b10_bytes = nbytes(Wb, vinv, table, band, Ss, scal)
    b10_flops, shared = _k10_work(table, F, D, lm)
    b10, by10 = _bound(b10_bytes, b10_flops)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k10_call()
    torch.cuda.synchronize()
    peak_k = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    k10.fleet_schur_plain(Wb, vinv, idx.wb_pose, idx.wb_lm, band, F, eps)
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated() - base
    t10 = dict(ms=event_ms(k10_call, 100), device_ms=graph_ms(k10_call, 20),
               plain_ms=event_ms(lambda: k10.fleet_schur_plain(
                   Wb, vinv, idx.wb_pose, idx.wb_lm, band, F, eps), 10),
               library_ms=event_ms(lib_call, 50),
               library_device_ms=graph_ms(lib_call, 20))
    c_ex = torch.linalg.cholesky_ex(Ss)[0]
    rhs = torch.ones_like(scal)
    lib = dict(
        cholesky_ms=graph_ms(lambda: torch.linalg.cholesky_ex(Ss), 10),
        solves_ms=graph_ms(lambda: torch.linalg.solve_triangular(
            c_ex.mT, torch.linalg.solve_triangular(
                c_ex, rhs[..., None], upper=False), upper=True), 20))
    n_w = (P // F) * D
    lib["bmm_bound_ms"] = 2 * F * n_w * n_w * (L // F) * lm / F32_FLOPS * 1e3
    lib["cholesky_bound_ms"] = F * n_w ** 3 / 3 / F32_FLOPS * 1e3
    dense = 2 * F * n_w * n_w * (L // F) * lm
    say(f"[{smi}] kernel 10 fleet_schur, fused fleet (F={F}, n_w={n_w}, "
        f"L_w={L // F}, Nw={Wb.shape[0]}) f32: {t10['ms']:.4f} ms per call "
        f"({t10['device_ms']:.4f} ms on the device, two launches, "
        f"{b10 / t10['device_ms']:.1%} of the bound {b10:.5f} ms, {by10}: "
        f"{b10_bytes} B, {b10_flops:.4g} flop over {shared:.4g} shared "
        f"(row, row, landmark) triples, the dense product {dense:.4g}); "
        f"plain route (dense W operands, bmm, epilogue) "
        f"{t10['plain_ms']:.4f} ms; torch.bmm(WVi_T^T, W_T) on the dense "
        f"operands {t10['library_ms']:.4f} ms ({t10['library_device_ms']:.4f}"
        f" ms on the device, bound {lib['bmm_bound_ms']:.4f} ms of f32 "
        f"operations); device memory beyond the inputs: kernel "
        f"{peak_k / 2**20:.1f} MiB, plain route {peak_p / 2**20:.1f} MiB; "
        f"launch floor {floor_ms:.4f} ms")
    say(f"[{smi}] dense fleet solve's library parts on the device: "
        f"cholesky_ex {lib['cholesky_ms']:.4f} ms (bound "
        f"{lib['cholesky_bound_ms']:.4f} ms), two triangular solves "
        f"{lib['solves_ms']:.4f} ms")
    rec10 = dict(t10, floor_ms=floor_ms, bound_ms=b10, bound_by=by10,
                 bytes=b10_bytes, flops=b10_flops, peak_mib=peak_k / 2**20,
                 plain_peak_mib=peak_p / 2**20, library_parts=lib)
    say("PHASE timing (cg, fleet) ok")
    return rec6, rec6p, rec_seg, rec10


# ---------------------------------------------------------------------------
# K2 (imu_preint), self-calibration and the calibration service


def _imu_scale(p):
    """The size of the states a residual subtracts: max(1, max |t|,
    max |v|)."""
    return max(1.0, float(p.poses.t.double().abs().max()),
               float(p.poses.v.double().abs().max()))


def imu_option_cases(p64, cfg):
    """[(label, f64 problem, config)]: the flagship's spans under the
    evaluation's options: imu_rotation_only with conditioning edges and
    robust weights below 1; calculate_inertial_covariance_once with a set
    cache, and invalid spans."""
    import torch

    from ba_tpu_torch.core.residuals import imu

    im = p64.imu
    Ni = im.weight.shape[0]
    g = torch.Generator(device="cpu").manual_seed(3)
    weight = (0.2 + 0.8 * torch.rand(Ni, generator=g, dtype=torch.float64)
              ).to(im.weight.device)
    cond = torch.zeros(Ni, dtype=torch.bool, device=im.cond.device)
    cond[::5] = True
    rot = dataclasses.replace(p64, imu=dataclasses.replace(
        im, weight=weight, cond=cond))
    cfg_rot = dataclasses.replace(cfg, imu_rotation_only=True)
    c9 = imu.evaluate_plain(p64, cfg, True).c9
    valid = im.valid.clone()
    valid[1::4] = False
    once = dataclasses.replace(p64, imu=dataclasses.replace(
        im, c9=1.3 * c9, c9_set=torch.ones((), dtype=torch.bool,
                                            device=c9.device), valid=valid))
    cfg_once = dataclasses.replace(cfg,
                                   calculate_inertial_covariance_once=True)
    return [("rotation-only, conditioning edges, weights < 1", rot,
             cfg_rot),
            ("cached covariance, invalid spans", once, cfg_once)]


def _imu_allowance(q, cfg, want, dt):
    """{field: allowed |kernel - plain|, broadcast to the field's shape}
    at TOL_IMU: the Jacobians and C9 to their own max |plain|; the states
    y_t, y_v to the state scale; the whitened residual to the state scale
    carried through the plain whitening factor (each row's sum of |S|), and
    err_sq to what that residual bound allows (2 |r| d + d^2 per span)."""
    from ba_tpu_torch.core.residuals import imu

    tol = TOL_IMU[dt]
    scale = _imu_scale(q)
    S = imu._whiten_from_c9(cfg, want.c9, q.imu, want.r.dtype).double()
    rb = tol["r"] * scale * S.abs().sum(-1)                  # (Ni, R)
    rw = want.r.double().abs()
    out = dict(r=rb, y_t=tol["r"] * scale, y_v=tol["r"] * scale,
               err_sq=(2 * rw * rb + rb * rb).sum(-1))
    for name in ("j1", "j2", "c9"):
        out[name] = tol["j"] * max(1e-300,
                                   float(getattr(want, name).double().abs()
                                         .max()))
    return out


# spans of several of K2 (a)'s 16-step chunks: 100 and 200 IMU samples
# between keyframes (a 200 Hz IMU with keyframes 0.5 s and 1 s apart)
IMU_LONG_SPANS = (100, 200)


def long_span_problem(imu_per_span, device="cuda"):
    """(f64 problem, config): 12 keyframes at pose_dim 15 whose spans hold
    `imu_per_span` steps, the biases moved off zero."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig
    from ba_tpu_torch.io import simulate_vins as sv

    cfg = BAConfig(pose_dim=15)
    sim = sv.simulate(n_poses=12, n_lms=80, seed=21,
                      imu_per_span=imu_per_span)
    p = sv.build_problem(sim, cfg, perturb=0.01, seed=22, device=device)[0]
    b = p.poses.b + 0.01 * torch.arange(6, dtype=p.poses.b.dtype,
                                        device=p.poses.b.device)
    return dataclasses.replace(p, poses=dataclasses.replace(p.poses, b=b)), cfg


def phase_imu(p, cfg, label):
    """K2 against its plain version (`evaluate_plain`) on the spans of `p`,
    in f32 and on an f64 copy: with Jacobians ((a), the whitened r, j1, j2,
    err_sq and the C9 used), without them from a given C9 ((b)) and without
    one ((a), then (b)); bit-identical between launches.  Returns the f32
    max abs error over the fields."""
    import torch

    from ba_tpu_torch.core.residuals import imu
    from ba_tpu_torch.utils.tree import tree_map

    worst = 0.0
    for dt in ("float32", "float64"):
        dtype = getattr(torch, dt)
        q = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
        c9 = imu.evaluate_plain(q, cfg, True).c9
        for part, call, plain in (
                ("(a)", lambda: imu.evaluate(q, cfg, True),
                 lambda: imu.evaluate_plain(q, cfg, True)),
                ("(b) given C9", lambda: imu.evaluate(q, cfg, False, c9),
                 lambda: imu.evaluate_plain(q, cfg, False, c9)),
                ("(a)+(b) no C9", lambda: imu.evaluate(q, cfg, False),
                 lambda: imu.evaluate_plain(q, cfg, False))):
            got, again, want = call(), call(), plain()
            torch.cuda.synchronize()
            allow = _imu_allowance(q, cfg, want, dt)
            for name in ("r", "j1", "j2", "err_sq", "y_t", "y_v", "c9"):
                g, w = getattr(got, name), getattr(want, name)
                diff = (g.double() - w.double()).abs()
                err = float(diff.max()) if diff.numel() else 0.0
                lim = torch.as_tensor(allow[name], dtype=torch.float64,
                                      device=diff.device)
                ratio = float(torch.where(diff == 0, 0.0, diff / lim).max()
                              ) if diff.numel() else 0.0
                same = bool(torch.equal(g, getattr(again, name)))
                say(f"K2 imu_preint {part} {label} {dt} {name:6s} "
                    f"{tuple(w.shape)}: max abs err {err:.3e}, "
                    f"{ratio:.3g} of the allowance at TOL_IMU {dt}; "
                    f"bit-identical relaunch {same}")
                check(ratio <= 1.0, f"K2 {part} {label} {dt} {name}: "
                      f"{ratio:.3g} of its allowance")
                check(same, f"K2 {part} {label} {dt} {name}: two launches "
                      "differ")
                if dt == "float32":
                    worst = max(worst, err)
    say(f"PHASE k2 ({label}) ok")
    return worst


# floating-point operations of K2's whitening per span (by the formulas of
# csrc/imu_preint.cu): the blocked factor and its inverse of the 9 x 9
# C9 (~360), then S r, S j1, S j2: 2 R^2 + 4 R^2 D
K2_WHITEN_FLOPS = 360


def _k2_flops(Ni, steps, R, D, jacobians):
    whiten = K2_WHITEN_FLOPS + 2 * R * R + (4 * R * R * D if jacobians
                                             else 0)
    if jacobians:
        return (K2A_FLOPS_PER_STEP * steps
                + (K2A_FLOPS_PER_SPAN + whiten) * Ni)
    return K2B_FLOPS_PER_STEP * steps + (K2B_FLOPS_PER_SPAN + whiten) * Ni


def phase_timing_imu(p, cfg, floor_ms, smi, label="flagship"):
    """K2 (a) and (b) timed at one path's spans beside their bounds
    (the whitening's operations and bytes included) and the plain
    evaluation; no PyTorch call computes them.  Counts the device
    operations of one evaluation: one K2 launch, where the plain
    whitening after the kernel took a hundred and more."""
    from ba_tpu_torch.core.residuals import imu

    D = cfg.pose_dim
    R = 15 if cfg.bias_in_state else 9
    c9 = imu.evaluate(p, cfg, True).c9

    def a_call():
        return imu.evaluate(p, cfg, True)

    def b_call():
        return imu.evaluate(p, cfg, False, c9)

    e0 = a_call()

    def plain_whitening():
        # the parent's route after its K2 launch: the plain whitening and
        # packing of the unwhitened outputs (here of same-shaped ones)
        S = imu._whiten_from_c9(cfg, e0.c9, p.imu, e0.r.dtype)
        return imu._whiten_pack(p, cfg, e0.r, e0.j1, e0.j2, S, True,
                                e0.y_t, e0.y_v, e0.c9)

    im, poses = p.imu, p.poses
    Ni, M = im.time.shape
    steps = int(((im.time[:, 1:] - im.time[:, :-1]) > 0).sum())
    ins = nbytes(poses.q, poses.t, poses.v, poses.b, im.pose1, im.pose2,
                 im.w, im.a, im.time, p.g_vec, im.weight, im.valid, im.cond,
                 im.c9_set)
    if cfg.calculate_inertial_covariance_once and bool(im.c9_set):
        ins += nbytes(im.c9)
    a_out, b_out = a_call(), b_call()
    a_bytes = ins + nbytes(*a_out)
    b_bytes = ins + nbytes(c9) + nbytes(b_out.r, b_out.j1, b_out.j2,
                                         b_out.err_sq, b_out.y_t, b_out.y_v)
    a_flops = _k2_flops(Ni, steps, R, D, True)
    b_flops = _k2_flops(Ni, steps, R, D, False)
    ops_a, ops_b = _graph_ops(a_call), _graph_ops(b_call)
    ops_whiten = _graph_ops(plain_whitening)
    whiten_t = dict(ms=event_ms(plain_whitening, 20),
                    device_ms=graph_ms(plain_whitening, 10))
    say(f"K2 device operations per IMU evaluation ({label}): with "
        f"Jacobians {ops_a}, without from a given C9 {ops_b}; the parent's "
        f"route made one K2 launch and then the plain whitening and packing"
        f": {ops_whiten} more device operations, {whiten_t['ms']:.4f} ms "
        f"per evaluation ({whiten_t['device_ms']:.4f} ms on the device)")
    check(ops_a == 1 and ops_b == 1, f"K2: {ops_a} and {ops_b} device "
          "operations per evaluation, expected 1")
    out = {}
    for part, call, nb, nf, plain in (
            ("full", a_call, a_bytes, a_flops,
             lambda: imu.evaluate_plain(p, cfg, True)),
            ("residual", b_call, b_bytes, b_flops,
             lambda: imu.evaluate_plain(p, cfg, False, c9))):
        bound = max(nb / HBM_BPS, nf / F32_FLOPS) * 1e3
        by = "bytes" if nb / HBM_BPS >= nf / F32_FLOPS else "operations"
        out[part] = dict(ms=event_ms(call, 200), device_ms=graph_ms(call, 50),
                         plain_ms=event_ms(plain, 5), bound_ms=bound,
                         bound_by=by, bytes=nb, flops=nf)
    out["full"]["device_ops"] = ops_a
    out["residual"]["device_ops"] = ops_b
    out["full"]["plain_whitening"] = dict(whiten_t, device_ops=ops_whiten)
    a, b = out["full"], out["residual"]
    say(f"[{smi}] K2 imu_preint, {label} ({Ni} spans x {M} slots, {steps} "
        f"steps, D={D}) f32, whitened: (a) with Jacobians {a['ms']:.4f} ms "
        f"per call ({a['device_ms']:.4f} ms on the device, "
        f"{a['bound_ms'] / a['device_ms']:.1%} of the bound "
        f"{a['bound_ms']:.5f} ms, {a['bound_by']}: {a['bytes']} B, "
        f"{a['flops']} flop), plain evaluation {a['plain_ms']:.3f} ms; (b) "
        f"residual {b['ms']:.4f} ms per call ({b['device_ms']:.4f} ms on the "
        f"device, {b['bound_ms'] / b['device_ms']:.1%} of the bound "
        f"{b['bound_ms']:.5f} ms, {b['bound_by']}), plain {b['plain_ms']:.3f}"
        f" ms; launch floor {floor_ms:.4f} ms")
    say(f"PHASE timing k2 ({label}) ok")
    rec = dict(ms=a["ms"] + b["ms"], device_ms=a["device_ms"] + b["device_ms"],
               floor_ms=floor_ms, plain_ms=a["plain_ms"] + b["plain_ms"],
               bound_ms=a["bound_ms"] + b["bound_ms"],
               bound_by=a["bound_by"], library_ms=None,
               library_device_ms=None, parts=out)
    return rec


def _move_calibration(p, err=CALIB_ERR, rot=TVS_ROT, trans=TVS_T):
    """`p` with camera 0's intrinsics moved by `err` and its T_vs by the
    rotation `rot` and the translation `trans` (tests/test_selfcal.py)."""
    from ba_tpu_torch.core import lie

    params = p.rig.params.clone()
    params[0, :5] += params.new_tensor(err)
    dq = lie.so3_exp(params.new_tensor(rot))
    rig = dataclasses.replace(
        p.rig, params=params, tvs_q=lie.quat_mul(p.rig.tvs_q[0], dq)[None],
        tvs_t=p.rig.tvs_t + params.new_tensor([trans]))
    return dataclasses.replace(p, rig=rig)


def selfcal_problem():
    """(f64 problem, f32 problem, config, SimData) of the full-width
    self-calibration configuration, calibration moved, prepared."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = BAConfig(pose_dim=15, lm_size=1, calib_size=5, do_tvs=True,
                   use_dogleg=True)
    sim = sv.simulate(n_poses=N_POSES, n_lms=N_LMS, seed=0)
    p64, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1)
    p64 = _move_calibration(p64)
    p32 = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a,
                   p64)
    P, K = p32.poses.q.shape[0], cfg.calib_dim
    sizes = dict(P=P, K=K, N=P * cfg.pose_dim + K, Nr=p32.proj.z.shape[0],
                 Ni=int(p32.imu.valid.sum()), M=p32.imu.time.shape[1])
    say(f"selfcal problem {sizes} on {p32.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(sizes == SELFCAL_EXPECTED, f"selfcal sizes {sizes} != "
          f"{SELFCAL_EXPECTED}")
    return (prepare_landmarks(p64, cfg), prepare_landmarks(p32, cfg), cfg,
            sim)


def phase_k1_calib(cases):
    """Kernel 1's calibration columns (K = 11: FOV with inverse depth; XYZ
    landmarks, lm_size 3, with the linear camera and with a poly3 lens)
    against the plain version, f32 and f64, with and without Jacobians.
    `cases` is
    [(label, f32 problem, config)]; the f64 copies renormalize their
    quaternions (as `stream_slide` does: the closed form and the plain
    version's compositions agree only on unit quaternions).  Returns the
    f32 max abs error."""
    import torch

    from ba_tpu_torch.core import lie
    from ba_tpu_torch.utils.tree import tree_map

    worst = 0.0
    for label, p, cfg in cases:
        for dt in ("float64", "float32"):
            dtype = getattr(torch, dt)
            q = tree_map(lambda a: a.to(dtype) if a.is_floating_point()
                         else a, p)
            if dt == "float64":
                q = dataclasses.replace(
                    q, poses=dataclasses.replace(
                        q.poses, q=lie.quat_normalize(q.poses.q)),
                    rig=dataclasses.replace(
                        q.rig, tvs_q=lie.quat_normalize(q.rig.tvs_q)))
            worst = max(worst, k1_against_plain(q, cfg, label))
    say("PHASE k1_calib ok")
    return worst


def phase_selfcal_small():
    """Self-calibration on the card against the CPU in f64
    (<R,1,15,5,true> on simulate(10, 60, seed 13), calibration moved): a
    GN iteration, the dogleg `solve` and its calibration marginals.  The
    T_vs translation is held (staged, not yet active): the simulator turns
    about the vertical only, which leaves the translation along it
    unobservable and its step set by rounding, on the card as on the
    CPU."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import step

    sim = sv.simulate(n_poses=10, n_lms=60, seed=13)
    cfg = BAConfig(pose_dim=15, lm_size=1, calib_size=5, do_tvs=True,
                   use_dogleg=False, error_change_threshold=0.0,
                   param_change_threshold=1e-10, tvs_translation_staging=True,
                   tvs_translation_active=False,
                   calculate_calibration_marginals=True)
    out = {}
    for dev in ("cuda", "cpu"):
        raw, _, _ = sv.build_problem(sim, cfg, perturb=0.0, seed=14,
                                     device=dev)
        raw = _move_calibration(raw)
        g = step.gn_iteration(prepare_landmarks(raw, cfg), cfg, True)
        q, s = step.solve(raw, dataclasses.replace(cfg, use_dogleg=True),
                          max_iter=10, use_imu=True)
        out[dev] = ({"GN post_cost": g.post_cost,
                     "GN poses.t": g.problem.poses.t,
                     "GN rig.params": g.problem.rig.params,
                     "GN lms.x": g.problem.lms.x, "GN ok": g.solver_ok,
                     "dogleg rig.params": q.rig.params,
                     "dogleg tvs_q": q.rig.tvs_q, "dogleg poses.t": q.poses.t,
                     "dogleg lms.x_w": q.lms.x_w,
                     "dogleg final cost": torch.tensor(s.final_cost),
                     "marginals": torch.as_tensor(s.calibration_marginals)},
                    s)
    (g, gs), (c, cs) = out["cuda"], out["cpu"]
    _compare([(k, g[k], c[k]) for k in c], "selfcal, 10 poses f64",
             TOL_SMALL)
    say(f"selfcal_small dogleg: {gs.iterations} iterations, {gs.result}, "
        f"cost {gs.initial_cost:.6g} -> {gs.final_cost:.6g} (CPU "
        f"{cs.iterations}, {cs.result}); marginals "
        f"{tuple(gs.calibration_marginals.shape)}")
    check((gs.iterations, gs.result) == (cs.iterations, cs.result),
          "selfcal_small: the dogleg took another path on the card")
    check(bool(c["GN ok"]) and bool(g["GN ok"]), "selfcal_small: GN failed")
    check(gs.final_cost < gs.initial_cost, "selfcal_small: dogleg cost")
    say("PHASE selfcal_small ok")


def _calib_errors(p, sim):
    """(intrinsics, T_vs rotation, T_vs translation across / along the
    turn axis) errors against the simulator's truth."""
    import numpy as np
    import torch

    from ba_tpu_torch.core import lie

    params = p.rig.params[0, :5].double().cpu().numpy()
    q = p.rig.tvs_q[0].double().cpu()
    q_true = torch.as_tensor(sim.tvs_q, dtype=torch.float64)
    rot = float(torch.linalg.norm(lie.so3_log(lie.quat_mul(
        q, lie.quat_conj(q_true)))))
    dt = p.rig.tvs_t[0].double().cpu().numpy() - sim.tvs_t
    # the vehicle turns about its z axis only: the lever arm along it is
    # unobservable
    return (float(np.abs(params - sim.cam_params).max()), rot,
            float(np.abs(dt[:2]).max()), float(abs(dt[2])))


def phase_selfcal(p, cfg, sim, smi):
    """The full-width self-calibrating dogleg `solve` (max_iter 40) in
    f32."""
    import torch

    from ba_tpu_torch.kernels import imu_preint
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    cost0 = float(evaluate_cost(p, cfg, step._imu_eval(p, cfg, True, False)))
    err0 = _calib_errors(p, sim)
    step.solve(p, cfg, max_iter=1, use_imu=True)           # warm-up
    torch.cuda.synchronize()

    def run():
        out = step.solve(p, cfg, max_iter=SELFCAL["max_iter"], use_imu=True)
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats()
    _counters_zero()
    t0 = time.perf_counter()
    (q, s), syncs = _sync_count(run)
    secs = time.perf_counter() - t0
    k1, k2, reads = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    peak = torch.cuda.max_memory_allocated()
    err1 = _calib_errors(q, sim)
    its = s.iterations
    trials = reads - its                 # use_imu given: no read for it
    kf = N_POSES * its / secs
    finite = _finite(q) and bool(torch.isfinite(torch.tensor(
        [s.initial_cost, s.final_cost])).all()) and bool(
        torch.isfinite(q.rig.params).all() and torch.isfinite(q.rig.tvs_t).all())
    say(f"selfcal dogleg solve f32 (max_iter {SELFCAL['max_iter']}): "
        f"{its} iterations ({trials} trials), {s.result}, cost {cost0:.6g} "
        f"(first build {s.initial_cost:.6g}) -> {s.final_cost:.6g} "
        f"({s.final_cost / s.initial_cost:.3e} of the first build's); "
        f"intrinsics max error {err0[0]:.4g} -> {err1[0]:.4g} (the JAX "
        f"package's f64 test bound 5e-2 at 12 poses), T_vs rotation error "
        f"{err0[1]:.4g} -> {err1[1]:.4g} rad, T_vs translation error across "
        f"the turn axis {err0[2]:.4g} -> {err1[2]:.4g} m, along it (not "
        f"observable) {err0[3]:.4g} -> {err1[3]:.4g} m; kernel launches "
        f"reprojection {k1} segsum {k2} imu_preint (a) {ia} (b) {ib} "
        f"schur_finish {k5} marginalize {k11}")
    say(f"[{smi}] selfcal solve: {secs * 1e3:.1f} ms, {secs * 1e3 / its:.1f} "
        f"ms per iteration, {kf:.1f} kf/s ({N_POSES} x {its} / wall); peak "
        f"device memory {peak / 2**30:.3f} GiB; host syncs {syncs}, "
        f"{syncs / its:.2f} per iteration (counted reads {reads}: one status "
        f"per iteration, one per dogleg trial)")
    check(finite, "selfcal: non-finite values")
    check(s.final_cost <= 1e-4 * s.initial_cost,
          f"selfcal: final cost {s.final_cost:.6g} above 1e-4 of "
          f"{s.initial_cost:.6g}")
    check(err1[0] < err0[0], "selfcal: the intrinsics did not improve")
    check(k2 == its, f"selfcal: {k2} segsum launches in {its} builds")
    check(k1 == its + trials + 1, f"selfcal: {k1} reprojection launches, "
          f"expected {its + trials + 1}")
    check((ia, ib) == (its + 1, trials + 1), f"selfcal: imu_preint "
          f"launches ({ia}, {ib}), expected ({its + 1}, {trials + 1})")
    check((k5, k11) == (its, 0), f"selfcal: schur_finish, marginalize "
          f"launches ({k5}, {k11}), expected ({its}, 0): one K5 per build")
    say("PHASE selfcal ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, kf_s=kf, ms_iter=secs * 1e3 / its, iters=its,
                peak_gib=peak / 2**30,
                syncs_per_iter=syncs / its, calib_err=err1,
                cost_ratio=s.final_cost / s.initial_cost)


def vicalib_capture(seed=0):
    """A synthetic camera-IMU capture of a calibration target, made with
    numpy from `seed`: a 6 x 6 grid of tags (88 mm, 26.4 mm gaps, the
    layout of an AprilGrid) whose 144 corners lie on the plane z = 0; 300
    frames at 20 Hz of a vehicle (T_vs = I, linear camera TRUE_CAM) that
    sways 1 m in front of it while turning about all three axes; gyro and
    accelerometer at 200 Hz, 10 samples per frame interval.  Returns
    (target, frames [(q, t, obs, time)], imu [(w, a, time)])."""
    import numpy as np
    import torch

    from ba_tpu_torch.core import lie

    c = VICALIB
    pitch = c["tag"] + c["gap"]
    corners = []
    for i in range(c["tags"]):
        for j in range(c["tags"]):
            x0, y0 = j * pitch, i * pitch
            corners += [(x0, y0), (x0 + c["tag"], y0),
                        (x0 + c["tag"], y0 + c["tag"]), (x0, y0 + c["tag"])]
    target = np.array([[x, y, 0.0] for x, y in corners])
    target[:, :2] -= target[:, :2].mean(0)
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.1, 0.2, 3) * np.array([1.0, 1.0, 0.5])
    om = rng.uniform(0.5, 0.9, 3)
    ph = rng.uniform(0.0, 2 * np.pi, 3)
    rot_amp = np.array([0.2, 0.25, 0.15])
    rot_om = np.array([1.1, 0.8, 0.6])

    def pos(t):
        return (np.array([0.0, 0.0, -1.0])
                + amp * np.sin(om * t[:, None] + ph))

    def acc(t):
        return -amp * om**2 * np.sin(om * t[:, None] + ph)

    def quat(t):
        w = torch.as_tensor(rot_amp * np.sin(rot_om * t[:, None]))
        return lie.so3_exp(w)

    n_imu = (c["frames"] - 1) * c["imu_per_frame"] + 1
    t_imu = np.arange(n_imu) / c["imu_hz"]
    h = 1e-4
    q0, q1 = quat(t_imu - h / 2), quat(t_imu + h / 2)
    w = (lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q1)) / h).numpy()
    R = lie.quat_to_matrix(quat(t_imu)).numpy()
    g = np.array([0.0, 0.0, -lie.GRAVITY])
    a = np.einsum("nji,nj->ni", R, acc(t_imu) - g)        # R^T (a_w - g)
    imu = [(w[k], a[k], float(t_imu[k])) for k in range(n_imu)]

    t_f = t_imu[:: c["imu_per_frame"]]
    q_f, p_f = quat(t_f).numpy(), pos(t_f)
    R_f = lie.quat_to_matrix(quat(t_f)).numpy()
    frames = []
    for k in range(c["frames"]):
        pc = (target - p_f[k]) @ R_f[k]                   # R^T (x - p)
        check(bool((pc[:, 2] > 0.3).all()), "vicalib: a corner behind the "
              "camera")
        cam = np.array(TRUE_CAM)
        pix = cam[None, :2] * pc[:, :2] / pc[:, 2:] + cam[None, 2:]
        frames.append((q_f[k], p_f[k], list(enumerate(pix)), float(t_f[k])))
    return target, frames, imu


def vicalib_service(poly3=False):
    """(a `ViCalibrator` on the card holding the synthetic capture, the
    true lens): the linear camera TRUE_CAM, or with `poly3` the capture
    re-projected through TRUE_CAM with POLY3_K by the port's plain
    `camera.project`; started from a lens moved by VICALIB_MOVE (fx, fy,
    cx, cy, and poly3's k1), a moved T_vs rotation and moved pose
    guesses."""
    import numpy as np
    import torch

    from ba_tpu_torch.calib import ViCalibrator
    from ba_tpu_torch.core import camera, lie

    seed = VICALIB["seed"]
    target, frames, imu = vicalib_capture(seed)
    true = np.array(list(TRUE_CAM) + (POLY3_K if poly3 else []))
    model = camera.MODEL_POLY3 if poly3 else camera.MODEL_LINEAR
    if poly3:
        prm = torch.as_tensor(true)
        frames = [(q, t, list(enumerate(camera.project(
            prm, model, torch.as_tensor((target - t) @ _rotation(q)))
            .numpy())), tm) for q, t, _, tm in frames]
    start = true.copy()
    n = 5 if poly3 else 4
    start[:n] += VICALIB_MOVE[:n]
    rng = np.random.default_rng(seed + 1)
    cal = ViCalibrator(target)
    cal.add_camera(start, model)
    cal.tvs_q = lie.so3_exp(torch.tensor([0.06, -0.05, 0.04],
                                         dtype=torch.float64)).numpy()
    for (q, t, obs, tm) in frames:
        dq = lie.so3_exp(torch.as_tensor(rng.normal(size=3) * 0.01)).numpy()
        f = cal.add_frame(lie.quat_mul(torch.as_tensor(q),
                                       torch.as_tensor(dq)).numpy(),
                          t + rng.normal(size=3) * 0.01, tm)
        for pid, pix in obs:
            cal.add_observation(f, pid, pix)
    for (w, a, tm) in imu:
        cal.add_imu_measurements(w, a, tm)
    return cal, true


def vicalib_problems(poly3=False):
    """[(prepared f32 problem, config)] of the calibration service's first
    and last stages on the synthetic capture (`vicalib_service`): XYZ
    landmarks, K = 11, 9-dim then 15-dim states."""
    from ba_tpu_torch.calib import STAGE_BIASES, STAGE_ROTATION
    from ba_tpu_torch.core.problem import prepare_landmarks

    cal, _ = vicalib_service(poly3)
    out = []
    for stage in (STAGE_ROTATION, STAGE_BIASES):
        p, cfg, _, _ = cal._build(*cal._snapshot(), stage)
        out.append((prepare_landmarks(p, cfg), cfg))
    return out


def phase_vicalib(smi, poly3=False):
    """`ViCalibrator.solve_once` through its three stages on the synthetic
    capture (`vicalib_service`: the linear camera, or a poly3 lens), f32 on
    the card, from a moved lens, T_vs rotation and pose guesses: the mse
    falls below the start's and VICALIB's bound, the lens and the T_vs
    rotation improve."""
    import numpy as np
    import torch

    from ba_tpu_torch.calib import STAGE_BIASES
    from ba_tpu_torch.core import lie
    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    name = "vicalib poly3" if poly3 else "vicalib"
    t0 = time.perf_counter()
    cal, true = vicalib_service(poly3)
    rows = sum(len(f.obs) for f in cal.frames)
    # the start's mse as solve_once reports it: the cost of the first
    # stage's build over the projection rows
    p0, cfg0, use_imu, _ = cal._build(*cal._snapshot(), cal.stage)
    p0 = prepare_landmarks(p0, cfg0)
    mse0 = float(evaluate_cost(p0, cfg0, step._imu_eval(
        p0, cfg0, use_imu, False))) / rows
    del p0
    say(f"{name} capture: {len(cal.target)} target corners, "
        f"{len(cal.frames)} frames, {len(cal.imu)} IMU samples, {rows} "
        f"projection rows, start mse {mse0:.6g} px^2 "
        f"({time.perf_counter() - t0:.2f} s to make, add and build)")
    check(rows == VICALIB_EXPECTED["rows"], f"{name}: {rows} rows")

    def intr_err():
        return float(np.abs(np.asarray(cal.cam_params) - true).max())

    def rot_err():
        return float(torch.linalg.norm(lie.so3_log(torch.as_tensor(
            np.asarray(cal.tvs_q, np.float64)))))

    e0, r0 = intr_err(), rot_err()
    stages = []
    _counters_zero()
    for k in range(3):
        stage = cal.stage
        t0 = time.perf_counter()
        mse = cal.solve_once()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stages.append(dict(stage=stage, mse=mse, secs=secs))
        say(f"[{smi}] {name} solve_once {k}: stage {stage} -> "
            f"{cal.stage}, mse {mse:.6g} px^2, {secs:.2f} s; lens error "
            f"{intr_err():.4g} (from {e0:.4g}), T_vs rotation error "
            f"{rot_err():.4g} rad (from {r0:.4g})")
        check(np.isfinite(mse), f"{name}: mse {mse} at stage {stage}")
    k1, k2, _ = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    say(f"{name} kernel launches: reprojection {k1} segsum {k2} imu_preint "
        f"(a) {ia} (b) {ib} schur_finish {k5} marginalize {k11}")
    check([s["stage"] for s in stages] == [0, 1, 2]
          and cal.stage == STAGE_BIASES, f"{name}: the stages did not "
          f"advance ({[s['stage'] for s in stages]} -> {cal.stage})")
    check(intr_err() < e0 and rot_err() < r0,
          f"{name}: the calibration did not improve")
    check(stages[-1]["mse"] < min(mse0, VICALIB["mse_bound"]),
          f"{name}: final mse {stages[-1]['mse']:.3g} (start {mse0:.3g})")
    check(min(k1, k2, ia, ib) > 0, f"{name}: a kernel never launched")
    check((k5, k11) == (k2, 0), f"{name}: schur_finish, marginalize "
          f"launches ({k5}, {k11}), expected ({k2}, 0): one K5 per build")
    say(f"PHASE {name} ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, stages=stages, rows=rows)


# ---------------------------------------------------------------------------
# K5 (the dense Schur step), K11 (the marginalization prior) and the
# multi-stream server


def _marg_counters():
    """(K5, K11) launches since `_counters_zero`."""
    from ba_tpu_torch.kernels import marginalize, schur_finish

    return (schur_finish.schur_finish.launches,
            marginalize.marginalize_prior.launches)


def _recording(module, name, run):
    """Run `run()` with `module.name` wrapped to record its arguments;
    returns the list of (args, kwargs) of its calls."""
    seen = []
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        seen.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, rec)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return seen


def k5_cases(p32, cfg, s32, cfg_s, ps32, cfg_sc):
    """(label, args, kwargs) of K5 at the main paths' shapes: a flagship
    build, a stream slide's build and its marginalization (the leading
    pose rows), a self-calibration build (K = 11)."""
    import torch

    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step, window

    def build(p, c):
        return lambda: asm.assemble(p, c, imu_eval=step._imu_eval(p, c, True,
                                                                  True))

    drop = torch.arange(s32.poses.q.shape[0], device=s32.poses.t.device) == 0
    out = []
    for label, run in (("flagship", build(p32, cfg)),
                       ("stream slide", build(s32, cfg_s)),
                       ("stream slide marginalization",
                        lambda: window.marginalize(s32, cfg_s, True, drop)),
                       ("selfcal", build(ps32, cfg_sc))):
        (args, kwargs), = _recording(asm, "schur_step", run)
        if len(args) > 5:                # finish passes the mask by place
            args, kwargs = args[:5], dict(kwargs, cmask=args[5])
        out.append((label, args, kwargs))
    out.append(("banded W, partly empty tile pairs",
                banded_k5(128, 9, 497, 1), {}))
    out.append(("lm 3 at the slide's split", banded_k5(10, 9, 150, 3),
                dict(cmask=torch.arange(90, device="cuda") % 7 != 3)))
    return out


def banded_k5(P, D, L, lm, dtype=None, dense_rows=0, span=3, seed=0,
              device="cuda"):
    """(U, W, vinv, rhs_p, rhs_l) (f32 unless `dtype`) with a block-banded
    W: landmark l seen by `span` consecutive poses of D rows, so distant
    tile pairs share no landmark, and the `dense_rows` last rows nonzero
    for every landmark (a calibration block).  The card tests take their
    K5 inputs from here."""
    import numpy as np
    import torch

    from ba_tpu_torch.utils.linalg import block_diag_inv

    rng = np.random.default_rng(seed + P + L + lm)
    N = P * D + dense_rows
    U = rng.standard_normal((N, N))
    W = np.zeros((N, L * lm))
    for l in range(L):
        p0 = int(rng.integers(0, P - span + 1))
        W[p0 * D:(p0 + span) * D, l * lm:(l + 1) * lm] = \
            rng.standard_normal((span * D, lm))
    if dense_rows:
        W[P * D:] = rng.standard_normal((dense_rows, L * lm))
    Vb = rng.standard_normal((L, lm, lm))
    V = Vb @ np.swapaxes(Vb, 1, 2) + np.eye(lm)
    t = [torch.as_tensor(a, dtype=dtype or torch.float32, device=device)
         for a in (U + U.T, W, V, rng.standard_normal(N),
                   rng.standard_normal(L * lm))]
    return t[0], t[1], block_diag_inv(t[2]), t[3], t[4]


def _k5_work(W, n, lm, tile):
    """The work K5's inputs need with `tile`-row tiles of S (W (N, L lm)
    cut to n rows): (lower tile pairs, those with no common landmark,
    flops of the structurally nonzero products).  A landmark with r
    nonzero rows (some of its lm columns nonzero, rows < n) adds r (r + 1)
    / 2 symmetric entries of lm multiply-adds, its rows' W V^-1 (r lm^2)
    and their rhs terms (r lm)."""
    import torch

    L = W.shape[1] // lm
    nb = -(-n // tile)
    ntri = nb * (nb + 1) // 2
    nz = (W[:n].reshape(n, L, lm) != 0).any(2)
    empty = 0
    if L:
        tm = torch.stack([nz[i:i + tile].any(0) for i in range(0, n, tile)])
        common = (tm[:, None, :] & tm[None, :, :]).any(2)
        empty = int((~torch.tril(common)).sum()) - nb * (nb - 1) // 2
    r = nz.sum(0).double()
    flops = float((r * (r + 1) * lm + 2 * r * lm * lm + 2 * r * lm).sum())
    return ntri, empty, flops


def phase_k5(cases):
    """K5 against its plain version at each case's shapes in f32 and on an
    f64 copy, relative to max(1, max |S|), S exactly symmetric, two
    launches bit-identical.  K5 reads U's lower triangle: U is symmetric,
    an f32 build's to the roundoff of its sums only (~1e-9 of max |S|), so
    the f64 copy takes U's symmetric part."""
    import torch

    from ba_tpu_torch.kernels import schur_finish as k5

    worst = 0.0
    for label, args, kw in cases:
        for dt in (torch.float32, torch.float64):
            a = [t.to(dt) for t in args]
            if dt == torch.float64:
                a[0] = 0.5 * (a[0] + a[0].T)
            got = k5.schur_finish(*a, **kw)
            again = k5.schur_finish(*a, **kw)
            want = k5.schur_finish_plain(*a, **kw)
            torch.cuda.synchronize()
            scale = max(1.0, float(want[0].double().abs().max()))
            err = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got, want))
            same = all(torch.equal(g, h) for g, h in zip(got, again))
            sym = torch.equal(got[0], got[0].T)
            name = str(dt).split(".")[1]
            N, K = a[0].shape[0], a[1].shape[1]
            masked = kw.get("cmask") is not None
            n, lm = got[0].shape[0], a[2].shape[1]
            tile, cs = k5.schedule(n, a[2].shape[0], lm, a[1].device)
            ntri, empty, _ = _k5_work(a[1], n, lm, tile)
            walk = (f"walk split across a cluster of {cs}" if cs > 1
                    else "walk unsplit")
            say(f"K5 schur_finish, {label} (N={N}, L*lm={K}, n={n}, "
                f"mask {masked}; {tile}-row tiles, "
                f"{empty} of {ntri} tile pairs share no landmark, {walk}) "
                f"{name}: max abs err {err:.3e}, rel {err / scale:.3e} "
                f"(tol {TOL_K5[name]:g}), symmetric {sym}, bit-identical "
                f"{same}")
            check(err <= TOL_K5[name] * scale and same and sym,
                  f"K5 {label} {name}: rel err {err / scale:.3g}, "
                  f"bit-identical {same}, symmetric {sym}")
            if dt == torch.float32:
                worst = max(worst, err)
    say("PHASE k5 ok")
    return worst


def _random_departing(n, drop, seed, dtype):
    """(S, rhs, pd) of an indefinite symmetric system whose Schur
    complement keeps negative eigenvalues (the clip's work)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n + 5))
    v = rng.standard_normal((n, 3))
    S = (A @ A.T - 3.0 * v @ v.T) / n
    pd = np.zeros(n, bool)
    pd[list(drop)] = True
    return (torch.as_tensor(0.5 * (S + S.T), dtype=dtype, device="cuda"),
            torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device="cuda"),
            torch.as_tensor(pd, device="cuda"))


def window_problem():
    """apps/vins_window.py --poses 40 --window 10 (its first
    marginalization: 40 poses, n = 360): simulate(40, 120, seed 7),
    build_problem(perturb 0.02, seed 8), f32, band width from the
    problem."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver.assemble import band_width_of
    from ba_tpu_torch.utils.tree import tree_map

    sim = sv.simulate(n_poses=K11_WINDOW["poses"], n_lms=K11_WINDOW["lms"],
                      seed=7)
    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.02, seed=8)
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    return p, dataclasses.replace(cfg, band_width=band_width_of(p))


def certificate_case(family, n, dt, seed=0, device="cuda"):
    """(S, rhs, pd) of a K11 input family on `device` (the card tests and
    the CPU certificate walk take theirs from here): `gauge`, PSD of rank
    n - 4 (a singular kept block) with 9 departing and 6 masked dims;
    `psd`, full rank with masked dims; `neg_in` / `neg_out`, no departing
    dims and a PSD block beside one eigenvalue at -0.1 tau / -10 tau (tau
    = K11_TAU[dt] ||H||_F, exact in f32 too: the block and the eigenvalue
    are apart, a permutation mixes them); `indefinite`, no departing
    dims."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pd = np.zeros(n, bool)
    if family in ("gauge", "psd"):
        B = rng.standard_normal((n, n - 4 if family == "gauge" else n + 5))
        S = B @ B.T / n
        masked = rng.choice(np.arange(9, n), 6, replace=False)
        S[masked] = 0.0
        S[:, masked] = 0.0
        pd[:9] = True
    elif family in ("neg_in", "neg_out"):
        B = rng.standard_normal((n - 1, n + 4))
        S = np.zeros((n, n))
        S[:-1, :-1] = B @ B.T / n
        S = (0.5 * (S + S.T)).astype(
            np.float32 if dt == torch.float32 else np.float64)
        S = S.astype(np.float64)
        S[-1, -1] = (-0.1 if family == "neg_in" else -10.0) \
            * K11_TAU[str(dt).split(".")[1]] * float(np.linalg.norm(S))
        perm = rng.permutation(n)
        S = S[perm][:, perm]
    else:
        A = rng.standard_normal((n, n + 5))
        v = rng.standard_normal((n, 3))
        S = (A @ A.T - 3.0 * v @ v.T) / n
    S = 0.5 * (S + S.T)
    return (torch.as_tensor(S, dtype=dt, device=device),
            torch.as_tensor(rng.standard_normal(n), dtype=dt, device=device),
            torch.as_tensor(pd, device=device))


def k11_cases():
    """(label, make, expect) of K11: make(dtype) gives (S, rhs, pd, eps),
    expect {dtype name: certified} what the certificate must decide (a
    missing dtype is a finding, printed).  The serving stream's fourth
    slide's marginalization (n = 90; the first two slides retire the two
    anchored poses, which have no free dims), vins_window's first (n =
    360), an indefinite n = 90 system with negative eigenvalues to clip;
    the certificate's families: a PSD prior with a singular kept block
    and masked dims, one eigenvalue at -0.1 tau and at -10 tau, a PSD
    n = 360 prior (the factor's first columns in the workspace); and
    indefinite systems at n = 168 and 169 (A and V in shared memory in
    f32, then in the workspace) and 360."""
    import torch

    from ba_tpu_torch.apps.vins_stream import stream_problem
    from ba_tpu_torch.solver import fixedlag, window

    def cast(S, rhs, pd):
        return lambda dt: (S.to(dt), rhs.to(dt), pd,
                           1e-9 if dt == torch.float64 else 1e-5)

    def family(name, n, seed=0):
        return lambda dt: certificate_case(name, n, dt, seed) + (
            1e-9 if dt == torch.float64 else 1e-5,)

    p, cfg = stream_problem(STREAM["poses"], STREAM["lms"])[:2]
    sched = fixedlag.build_ring_schedule(p, cfg, STREAM["window"], 4)
    seen = _recording(window, "prior_step", lambda: fixedlag.run_ring(
        sched, cfg, True, STREAM["iters"]))
    out = [("stream slide", cast(*seen[-1][0][:3]), {})]
    pw, cfg_w = window_problem()
    drop = torch.arange(pw.poses.q.shape[0], device=pw.poses.t.device) == 2
    (args, _), = _recording(window, "prior_step",
                            lambda: window.marginalize(pw, cfg_w, True, drop))
    out.append(("vins_window", cast(*args[:3]), {}))
    out.append(("indefinite", cast(*_random_departing(90, range(9), 0,
                                                      torch.float32)),
                {"float32": 0, "float64": 0}))
    both = {"float32": 1, "float64": 1}
    neither = {"float32": 0, "float64": 0}
    out += [("gauge (PSD, singular kept block, masked dims)",
             family("gauge", 90), {"float64": 1}),
            ("eigenvalue -0.1 tau", family("neg_in", 90), both),
            ("eigenvalue -10 tau", family("neg_out", 90), neither),
            ("PSD n=360", family("psd", 360), {"float64": 1}),
            ("indefinite n=168", family("indefinite", 168), neither),
            ("indefinite n=169", family("indefinite", 169), neither),
            ("indefinite n=360", family("indefinite", 360), neither)]
    return out


def phase_k11(cases):
    """K11 against its plain version in f32 and f64, relative to
    ||H||_F; its info flag and branch (the certificate, or the Jacobi
    clip), which must be the expected one where the case says; the
    output's smallest eigenvalue; two launches bit-identical."""
    import torch

    from ba_tpu_torch.kernels import marginalize as k11

    worst = 0.0
    infos = {}
    for label, make, expect in cases:
        for dt in (torch.float32, torch.float64):
            S, rhs, pd, eps = make(dt)
            a = (S, rhs, pd)
            H, g, info = k11.marginalize_prior(*a, eps)
            H2, g2, info2 = k11.marginalize_prior(*a, eps)
            Hp, gp = k11.marginalize_prior_plain(*a, eps)
            torch.cuda.synchronize()
            name = str(dt).split(".")[1]
            norm = float(torch.linalg.matrix_norm(Hp.double()))
            err = max(float((H.double() - Hp.double()).abs().max()),
                      float((g.double() - gp.double()).abs().max()))
            gscale = max(1.0, float(gp.double().abs().max()))
            lo_in = float(torch.linalg.eigvalsh(Hp.double()).min())
            lo = float(torch.linalg.eigvalsh(H.double()).min())
            inf = dict(zip(k11.INFO, info.tolist()))
            active = int((H != 0).any(1).sum())
            same = torch.equal(H, H2) and torch.equal(g, g2) \
                and torch.equal(info, info2)
            branch = "certificate" if inf["certified"] else "Jacobi clip"
            say(f"K11 marginalize, {label} (n={S.shape[0]}, "
                f"{inf['departing']} departing dims, {active} active) "
                f"{name}: branch {branch}; max abs err "
                f"{err:.3e}, rel to ||H||_F {err / max(norm, 1e-300):.3e} "
                f"(tol {TOL_K11[name]:g}); info {inf}; smallest eigenvalue "
                f"{lo / max(norm, 1e-300):.3e} ||H|| (plain "
                f"{lo_in / max(norm, 1e-300):.3e}); symmetric "
                f"{torch.equal(H, H.T)}, bit-identical {same}")
            check(inf["ok"] == 1, f"K11 {label} {name}: info {inf}")
            check(err <= TOL_K11[name] * max(norm, gscale) and same
                  and torch.equal(H, H.T),
                  f"K11 {label} {name}: err {err:.3g}, bit-identical {same}")
            if name in expect:
                check(inf["certified"] == expect[name],
                      f"K11 {label} {name}: branch {branch}, expected "
                      f"certified {expect[name]}")
            if inf["certified"]:
                check(inf["sweeps"] == inf["rotations"] == inf["clipped"]
                      == 0, f"K11 {label} {name}: certified with {inf}")
            if dt == torch.float32:
                check(lo >= -K11_PSD_F32 * norm, f"K11 {label}: smallest "
                      f"eigenvalue {lo:.3g} below -{K11_PSD_F32:g} ||H||")
                worst = max(worst, err)
                infos[label] = dict(inf, active=active)
    check(infos["indefinite"]["clipped"] > 0,
          "K11: the indefinite case clipped nothing")
    say("PHASE k11 ok")
    return worst, infos


def _k5_ops(N, n, K, lm):
    """Floating-point operations of K5's function as a dense product: the
    symmetric product (n (n + 1) / 2 entries of K multiply-adds), W V^-1
    of the rows (2 n K lm) and the rhs (2 n K); printed beside the
    structurally nonzero count of `_k5_work`, which sets the bound."""
    return n * (n + 1) * K + 2 * n * K * lm + 2 * n * K


# K5 timed at the main paths' shapes; K11 at the slide's n = 90 and
# vins_window's n = 360 (whichever branch each takes), and on each branch
# at both sizes: the Jacobi clip (indefinite inputs) and the certificate
# (a PSD n = 360 prior)
K5_TIMED = ("flagship", "stream slide", "selfcal")
K11_TIMED = ("stream slide", "vins_window", "indefinite", "indefinite n=360",
             "PSD n=360")


def phase_timing_k5_k11(k5c, k11c, k11_info, floor_ms, smi):
    """K5 at the flagship's, a stream slide's and the self-calibration's
    shapes, and K11 at the K11_TIMED cases, timed as in phase 11 beside
    their bounds, plain versions and library yardsticks: torch.matmul of
    W V^-1 by W^T (K5), `eigh` and the clip product with its host sync
    (K11)."""
    import torch

    from ba_tpu_torch.kernels import marginalize as k11
    from ba_tpu_torch.kernels import schur_finish as k5

    rec5 = {}
    for label, args, kw in k5c:
        if label not in K5_TIMED:
            continue
        U, W, vinv, rhs_p, rhs_l = args[:5]
        N, K = U.shape[0], W.shape[1]
        lm = vinv.shape[1]
        out = k5.schur_finish(*args, **kw)
        n = out[0].shape[0]
        L = vinv.shape[0]
        WVi = torch.einsum("nlk,lkj->nlj", W.reshape(N, L, lm),
                           vinv).reshape(N, K)
        tile, cs = k5.schedule(n, L, lm, W.device)
        ntri, empty, ops = _k5_work(W, n, lm, tile)
        dense_ops = _k5_ops(N, n, K, lm)
        # what the function reads and writes: U's lower triangle and W's
        # rows within the n x n cut, V^-1, rhs_p's n and rhs_l, the mask,
        # S and rhs
        nb = (n * (n + 1) // 2 + n * K + n) * U.element_size() \
            + nbytes(vinv, rhs_l, kw.get("cmask"), *out)
        bound = max(nb / HBM_BPS, ops / F32_FLOPS) * 1e3
        by = "bytes" if nb / HBM_BPS >= ops / F32_FLOPS else "operations"
        t = dict(ms=event_ms(lambda: k5.schur_finish(*args, **kw), 50),
                 device_ms=graph_ms(lambda: k5.schur_finish(*args, **kw),
                                    20),
                 plain_ms=event_ms(
                     lambda: k5.schur_finish_plain(*args, **kw), 10),
                 library_ms=event_ms(lambda: torch.matmul(WVi, W.T), 50),
                 library_device_ms=graph_ms(lambda: torch.matmul(WVi, W.T),
                                            20))
        nz = float((W != 0).double().mean())
        say(f"[{smi}] K5 schur_finish, {label} (N={N}, L*lm={K}, W "
            f"{nz:.1%} nonzero; {tile}-row tiles, {empty} of {ntri} tile "
            f"pairs empty, cluster split {cs}) f32: {t['ms']:.4f} ms per "
            f"call ({t['device_ms']:.4f} ms on the device, "
            f"{bound / t['device_ms']:.1%} of the bound; launch floor "
            f"{floor_ms:.4f} ms), plain {t['plain_ms']:.3f} ms, "
            f"torch.matmul(W V^-1, W^T) {t['library_ms']:.4f} ms "
            f"({t['library_device_ms']:.4f} ms on the device); bound "
            f"{bound:.5f} ms ({by}: {nb} B, {ops:.4g} flop of structurally "
            f"nonzero products; dense {dense_ops:.4g} flop)")
        rec5[label] = dict(bound_ms=bound, bound_by=by, flops=ops,
                           dense_flops=dense_ops, bytes=nb, tile=tile,
                           cluster=cs, empty_tile_pairs=empty,
                           tile_pairs=ntri, **t)

    rec11 = {}
    for label, make, _ in k11c:
        if label not in K11_TIMED:
            continue
        S, rhs, pd, eps = make(torch.float32)
        n = S.shape[0]
        inf = k11_info[label]
        k, na = inf["departing"], inf["active"]
        # the departing block's inverse (2 k^3) and the Schur update of H
        # and g (2 n^2 k + 2 n k); the certificate's Cholesky on the active
        # block (na^3 / 3); the Jacobi rotations this input needed (12 na
        # each: A's rows and columns as a symmetric matrix, V's columns),
        # none on the certified branch
        ops = 2 * k ** 3 + 2 * n * n * k + 2 * n * k + na ** 3 / 3 \
            + 12 * na * inf["rotations"]
        H, g, info = k11.marginalize_prior(S, rhs, pd, eps)
        nb = nbytes(S, rhs, pd, H, g, info)
        bound = max(nb / HBM_BPS, ops / F32_FLOPS) * 1e3
        by = "bytes" if nb / HBM_BPS >= ops / F32_FLOPS else "operations"

        def library():
            Hs = 0.5 * (S + S.T)
            evals, evecs = torch.linalg.eigh(Hs)
            return (evecs * torch.clamp(evals, min=0.0)[None, :]) @ evecs.T

        t = dict(ms=event_ms(lambda: k11.marginalize_prior(S, rhs, pd, eps),
                             20),
                 device_ms=graph_ms(
                     lambda: k11.marginalize_prior(S, rhs, pd, eps), 5),
                 plain_ms=event_ms(
                     lambda: k11.marginalize_prior_plain(S, rhs, pd, eps), 10),
                 library_ms=event_ms(library, 10))
        branch = "certificate" if inf["certified"] else "Jacobi clip"
        say(f"[{smi}] K11 marginalize, {label} (n={n}, {k} departing dims, "
            f"{na} active; branch {branch}: {inf['sweeps']} sweeps, "
            f"{inf['rotations']} rotations, {inf['clipped']} clipped) f32: "
            f"{t['ms']:.4f} ms per call ({t['device_ms']:.4f} ms on the "
            f"device, {bound / t['device_ms']:.2%} of the bound), plain "
            f"(inv_ex, eigh) {t['plain_ms']:.3f} ms, eigh + clip "
            f"{t['library_ms']:.4f} ms (host sync included); bound "
            f"{bound:.5f} ms ({by}: {nb} B, {ops:.4g} flop)")
        rec11[label] = dict(bound_ms=bound, bound_by=by, flops=ops, bytes=nb,
                            branch=branch, **t)
    say("PHASE timing (K5, K11) ok")
    return rec5, rec11


def phase_stream_many(smi):
    """The multi-stream server at the serving configuration: M streams of
    simulate(128, 2,048, seed 7) (build seeds 8 + m), W = 10, 2 GN
    iterations, f32, capacities from the 128-keyframe schedule, each
    stream pushing its first STREAM_MANY["keyframes"] keyframes through
    `vins_stream.stream_many`: aggregate and per-stream keyframes retired
    per second, ms per round, host syncs per steady push, each stream's
    ATE; every stream bit-identical to the same stream pushed alone."""
    import numpy as np
    import torch

    from ba_tpu_torch.apps.vins_stream import stream_many, stream_problem
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.kernels.marginalize import Branches as K11Branches
    from ba_tpu_torch.solver import fixedlag
    from ba_tpu_torch.solver.streaming import RingCapacities, StreamingRing

    M, G = STREAM_MANY["streams"], STREAM_MANY["keyframes"]
    W = STREAM["window"]
    t0 = time.perf_counter()
    problems, sim = [], None
    for m in range(M):
        p, cfg, sim = stream_problem(STREAM["poses"], STREAM["lms"],
                                     seed=8 + m)
        problems.append(p)
    sched = fixedlag.build_ring_schedule(problems[0], cfg, W,
                                         STREAM["poses"] - W + 1)
    caps = RingCapacities.from_schedule(sched)
    say(f"stream_many: {M} streams, problems and capacities built in "
        f"{time.perf_counter() - t0:.2f} s")

    syncs = []
    orig = StreamingRing.push

    def push(ring, block=True):
        if ring._next_slide == 0:
            return orig(ring, block)
        out, n = _sync_count(lambda: orig(ring, block))
        syncs.append(n)
        return out

    StreamingRing.push = push
    try:
        _counters_zero()
        with K11Branches() as kb:
            outs, t_steady, n_steady = stream_many(problems, cfg, W,
                                                   STREAM["iters"], caps,
                                                   keyframes=G)
        branches = kb.read()
        k1, k2, _ = _counters()
        ia, ib = _imu_counters()
        k5, k11 = _marg_counters()
    finally:
        StreamingRing.push = orig
    alone = [stream_many([p], cfg, W, STREAM["iters"], caps,
                         keyframes=G)[0][0] for p in problems]
    n_slides = G - W + 1
    slides = M * n_slides
    kf_s = n_steady / t_steady
    ms_round = 1e3 * t_steady * M / n_steady
    ates, same = [], []
    for m in range(M):
        t_est = np.stack([o["t"] for o in outs[m]]).astype(np.float64)
        ates.append(sv.ate(None, t_est, None, sim.t_wv[:len(outs[m])]))
        same.append(len(outs[m]) == len(alone[m]) == n_slides and all(
            np.array_equal(o[key], a[key]) for o, a in zip(outs[m], alone[m])
            for key in ("cost", "q", "t", "v", "b")))
    costs = np.array([[o["cost"] for o in os_] for os_ in outs])
    say(f"[{smi}] stream_many f32: {M} streams x {G} keyframes, "
        f"{[len(o) for o in outs]} retired; steady state {kf_s:.3f} "
        f"keyframes retired/s aggregate ({kf_s / M:.3f} per stream), "
        f"{ms_round:.1f} ms per round of {M} slides "
        f"({ms_round / M:.1f} ms per slide) over {n_steady} steady slides; "
        f"host syncs per steady push min {min(syncs)} max {max(syncs)} total "
        f"{sum(syncs)}; kernel launches reprojection {k1} segsum {k2} "
        f"imu_preint (a) {ia} (b) {ib} schur_finish {k5} marginalize {k11}")
    say(f"stream_many f32: K11's certificate settled "
        f"{branches['certified']} of {branches['marginalizations']} "
        f"marginalizations ({branches['clipped']} clipped by the Jacobi "
        f"branch); every info ok {branches['ok']}")
    say(f"stream_many f32: ATE per stream " + ", ".join(
        f"{a:.6g}" for a in ates) + f" m (bound {2 * JAX_F64_ATE_M:g} m); "
        f"bit-identical to each stream pushed alone {same}; costs finite "
        f"{bool(np.isfinite(costs).all())}")
    check(all(len(o) == n_slides for o in outs),
          f"stream_many: retired {[len(o) for o in outs]}, not {n_slides}")
    check(all(same), f"stream_many: streams differ from alone: {same}")
    check(bool(np.isfinite(costs).all()), "stream_many: non-finite costs")
    check(max(ates) <= 2 * JAX_F64_ATE_M, f"stream_many: ATE {max(ates):.6g}")
    check(max(syncs) == 0, f"stream_many: {max(syncs)} host syncs in a push")
    want = (K1_PER_SLIDE * slides, SEG_PER_SLIDE * slides,
            IMU_A_PER_SLIDE * slides, IMU_B_PER_SLIDE * slides,
            K5_PER_SLIDE * slides, K11_PER_SLIDE * slides)
    check((k1, k2, ia, ib, k5, k11) == want, f"stream_many: launches "
          f"{(k1, k2, ia, ib, k5, k11)}, expected {want}")
    say("PHASE stream_many ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, kf_s=kf_s, ms_round=ms_round, slides=slides,
                k11_branches=branches,
                syncs_per_push=sum(syncs) / len(syncs), ates=ates,
                streams=M, keyframes=G)


# ---------------------------------------------------------------------------
# Self-calibration on the matrix-free PCG, the CSV VINS app, math_test


def cg_selfcal_case(n_poses, n_lms, K, device, dtype, seed=0, build_seed=1,
                    perturb=0.01, **cfg):
    """(prepared problem, config, SimData): simulate(n_poses, n_lms, seed)
    built without a marginalization prior under pose_dim 15 and the 11
    calibration columns (K = 11) or pose_dim 9 and the 5 intrinsics
    (K = 5), on the PCG solver, the calibration moved (T_vs only when it
    is calibrated); `cfg` overrides config fields."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.utils.tree import tree_map

    tvs = K == 11
    c = BAConfig(pose_dim=15 if tvs else 9, lm_size=1, calib_size=5,
                 do_tvs=tvs, use_dogleg=False, use_cg_solver=True, **cfg)
    sim = sv.simulate(n_poses=n_poses, n_lms=n_lms, seed=seed)
    p, _, _ = sv.build_problem(sim, c, perturb=perturb, seed=build_seed,
                               with_marg_prior=False, device=device)
    p = _move_calibration(p) if tvs else _move_calibration(
        p, rot=[0.0, 0.0, 0.0], trans=[0.0, 0.0, 0.0])
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    check(c.calib_dim == K, f"calibration block {c.calib_dim} != {K}")
    return prepare_landmarks(p, c), c, sim


def phase_cg_selfcal_small():
    """The self-calibrating PCG on the card against the CPU in f64
    (CG_SELFCAL_SMALL), at K = 11 and K = 5: one build's Schur-reduced
    rhs, calibration preconditioner and damping scale, one
    `solve_reduced_cg` step at tolerance 1e-12, one GN iteration, all at
    TOL_SMALL; kernel 6 and its pack with the calibration columns
    launched (the pack once per build)."""
    import torch

    from ba_tpu_torch.solver import cg, step

    sm = CG_SELFCAL_SMALL
    for K in (11, 5):
        out = {}
        for dev in ("cuda", "cpu"):
            p, cfg, _ = cg_selfcal_case(
                sm["poses"], sm["lms"], K, dev, torch.float64, seed=13,
                build_seed=14, cg_max_iterations=sm["max_it"],
                cg_tolerance=sm["tol"])
            check(step._reduced_path(p, cfg)[0] == "cg",
                  "cg_selfcal_small: not the CG path")
            P, D = p.poses.q.shape[0], cfg.pose_dim
            _counters_zero()
            bs, mH = cg.assemble_blocks(
                p, cfg, step._imu_eval(p, cfg, True, True),
                plan=step.solve_plan(p, cfg))
            s = cg.solve_reduced_cg(bs, mH, cfg, P, D, K)
            g = step.gn_iteration(p, cfg, True)
            k6, _, k6p = _new_counters()
            out[dev] = ({"rhs_sc": bs.rhs_sc, "minv_cal": bs.minv_cal,
                         "dscale": bs.dscale, "step delta_p": s.delta_p,
                         "step delta_l": s.delta_l, "step ok": s.ok,
                         "GN post_cost": g.post_cost,
                         "GN poses.t": g.problem.poses.t,
                         "GN rig.params": g.problem.rig.params,
                         "GN rig.tvs_t": g.problem.rig.tvs_t,
                         "GN lms.x": g.problem.lms.x, "GN ok": g.solver_ok},
                        (k6, k6p))
        (g, (k6, k6p)), (c, _) = out["cuda"], out["cpu"]
        _compare([(k, g[k], c[k]) for k in c],
                 f"self-calibrating PCG K={K}, {sm['poses']} poses f64",
                 TOL_SMALL)
        check(bool(c["step ok"]) and bool(g["GN ok"]),
              "cg_selfcal_small: a solve failed")
        say(f"cg_selfcal_small K={K}: schur_matvec launches on the card "
            f"{k6}, schur_pack {k6p}")
        check(k6 > 0 and k6p == 2, f"cg_selfcal_small: kernel 6 launched "
              f"{k6} times, its pack {k6p} (one per build)")
    say("PHASE cg_selfcal_small ok")


def cg_selfcal_problem():
    """(f32 problem, f64 problem, config, SimData) of the self-calibrating
    PCG at full width (CG_SELFCAL), prepared."""
    import torch

    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    p64, cfg, sim = cg_selfcal_case(CG["poses"], CG["lms"], 11, "cuda",
                                    torch.float64,
                                    cg_max_iterations=CG_SELFCAL["max_it"],
                                    cg_tolerance=CG_SELFCAL["tol"])
    p32 = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a,
                   p64)
    P, K = p32.poses.q.shape[0], cfg.calib_dim
    sizes = dict(P=P, K=K, N=P * cfg.pose_dim + K, Nr=p32.proj.z.shape[0],
                 Ni=int(p32.imu.valid.sum()))
    say(f"CG selfcal problem {sizes} on {p32.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(sizes == CG_SELFCAL_EXPECTED, f"CG selfcal sizes {sizes} != "
          f"{CG_SELFCAL_EXPECTED}")
    return p32, p64, cfg, sim


def _k6_calib_work(Nr, L, lm, K, itemsize):
    """(bytes, flop) kernel 6 with K calibration columns needs: J_m, J_r,
    j_l and J_c (24 + 2 lm + 2 K values) and the pose, ref and landmark
    ids (12 B) of each row read once (the tile table, V^-1, x and x_k
    counted by the caller), the rows written once; per row u (24 + 2 K
    multiply-adds), j_l^T u, w, the 12 outputs and the K calibration sums
    (2 multiply-adds each); per landmark one product with V^-1."""
    return (Nr * ((24 + 2 * lm + 2 * K) * itemsize + 12),
            Nr * 2 * (24 + 2 * K + 2 + 2 + 24 + 2 * K) + L)


def phase_k6_calib(p, cfg, bs):
    """Kernel 6 and its pack with the 11 calibration columns against their
    plain versions at the self-calibrating PCG's shapes, f32 and an f64
    copy: the pack equal element for element, the rows and the tiles'
    calibration partials against `schur_matvec_sorted_plain`, two launches
    bit-identical; then the packed route whole (`cg.s_matvec` on the card)
    against the CPU path's S x in f64.  Returns (f32 max abs errors of the
    rows and partials, and of the pack, x)."""
    import numpy as np
    import torch

    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import cg

    P, D, K = p.poses.q.shape[0], cfg.pose_dim, cfg.calib_dim
    pj, plan = bs.pj, bs.plan.schur
    L = bs.vinv.shape[0]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(P * D + K),
                        dtype=torch.float32, device=bs.wb.device)
    worst = worst_pack = 0.0
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        args = [t.to(dtype) for t in (pj.j_m, pj.j_r, pj.j_l, pj.j_c)]
        vinv, xv, xk = bs.vinv.to(dtype), x[: P * D].to(dtype), \
            x[P * D:].to(dtype)
        pack = k6.schur_pack(*args[:3], plan, 1, args[3])
        a, pa = k6.schur_matvec(pack, plan, vinv, xv, D, xk=xk)
        b, pb = k6.schur_matvec(pack, plan, vinv, xv, D, xk=xk)
        want_pack = k6.schur_pack_plain(*args[:3], plan, 1, args[3]).rows
        want, want_part = k6.schur_matvec_sorted_plain(
            k6.schur_pack_plain(*[t.double() for t in args[:3]], plan, 1,
                                args[3].double()),
            plan, vinv.double(), xv.double(), D, xk.double())
        torch.cuda.synchronize()
        err, rel = rel_err(a, want)
        err_p, rel_p = rel_err(pa, want_part)
        pack_ok = bool(torch.equal(pack.rows, want_pack))
        same = bool(torch.equal(a, b) and torch.equal(pa, pb))
        say(f"kernel 6 {dt} with K={K} calibration columns (Nr="
            f"{pj.j_m.shape[0]}, L={L}, record {pack.rows.shape[1]} values, "
            f"{plan.tiles.numel() - 1} tiles): rows max abs err {err:.3e} "
            f"rel {rel:.3e}, calibration partials max abs err {err_p:.3e} "
            f"rel {rel_p:.3e} (tol {TOL_K6[dt]:g}); pack equal {pack_ok}; "
            f"bit-identical relaunch {same}")
        check(rel <= TOL_K6[dt] and rel_p <= TOL_K6[dt],
              f"kernel 6 {dt} K={K}: rel {rel:.3g} / {rel_p:.3g}")
        check(pack_ok, f"kernel 6 {dt} K={K}: the pack differs")
        check(same, f"kernel 6 {dt} K={K}: two launches differ")
        if dt == "float32":
            worst = max(err, err_p)
            worst_pack = _max_abs(pack.rows, want_pack)
        b_d = _cast_blocks(bs, dtype)
        lam = 1e-4 if dtype == torch.float32 else 1e-8
        got = cg.s_matvec(b_d, x.to(dtype), P, D, K, lam, None)
        want_sx = cg.s_matvec(_cast_blocks(bs, torch.float64, "cpu"),
                              x.double().cpu(), P, D, K, lam)
        torch.cuda.synchronize()
        _, rel_s = rel_err(got.cpu(), want_sx)
        say(f"packed route {dt} K={K}: S x (pack, kernel 6, segsum with the "
            f"tiles' partials) against the CPU path's rel {rel_s:.3e} (tol "
            f"{TOL_K6[dt]:g})")
        check(rel_s <= TOL_K6[dt], f"packed route {dt} K={K}: rel "
              f"{rel_s:.3g}")
    say("PHASE k6_calib ok")
    return worst, worst_pack, x


def phase_cg_selfcal(p, p64, cfg, sim, smi):
    """GN solve_fixed(..., 10) of the self-calibrating PCG at full width in
    f32: the cost and the intrinsics and T_vs rotation errors fall,
    everything finite, solver_ok at every iteration, PCG iterations and
    host syncs per build (the stop-test reads only), exact launches;
    then a dense GN self-calibration of the same problem in f64 on the
    card and the calibration gap between the two (recorded)."""
    import torch

    from ba_tpu_torch.core import lie
    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    n, K = CG_SELFCAL["iters"], cfg.calib_dim
    cost0 = float(evaluate_cost(p, cfg, step._imu_eval(p, cfg, True, False)))
    err0 = _calib_errors(p, sim)

    def plan():
        out = step.solve_plan(p, cfg)
        torch.cuda.synchronize()
        return out

    _sync_count(plan)
    plan_again = _sync_count(plan)[1]
    step.solve_fixed(p, cfg, True, 1)                      # warm-up
    torch.cuda.synchronize()
    oks, pcgs = [], []
    orig_gn, orig_pcg = step.gn_iteration, cg.pcg_solve

    def gn_recording(*a, **k):
        res = orig_gn(*a, **k)
        oks.append(res.solver_ok)
        return res

    def pcg_recording(*a, **k):
        res = orig_pcg(*a, **k)
        pcgs.append(res)
        return res

    def run():
        out = step.solve_fixed(p, cfg, True, n)
        torch.cuda.synchronize()
        return out

    step.gn_iteration, cg.pcg_solve = gn_recording, pcg_recording
    torch.cuda.reset_peak_memory_stats()
    _counters_zero()
    try:
        t0 = time.perf_counter()
        (q, costs, _), syncs = _sync_count(run)
        secs = time.perf_counter() - t0
    finally:
        step.gn_iteration, cg.pcg_solve = orig_gn, orig_pcg
    k1, k2, reads = _counters()
    k6, _, k6p = _new_counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    peak = torch.cuda.max_memory_allocated()
    costs_h = costs.double().cpu()
    err1 = _calib_errors(q, sim)
    all_ok = bool(torch.stack(oks).all())
    its = [int(r.iterations) for r in pcgs]
    matvecs = sum(r.matvecs for r in pcgs)
    pcg_reads = [r.reads for r in pcgs]
    max_reads = -(-CG_SELFCAL["max_it"] // cg.CG_CHECK_EVERY)
    finite = bool(torch.isfinite(costs_h).all()) and _finite(q) and bool(
        torch.isfinite(q.rig.params).all() and torch.isfinite(
            q.rig.tvs_t).all())
    say(f"CG selfcal GN solve_fixed({n}) f32 (K={K}): cost {cost0:.6g} -> "
        f"{float(costs_h[-1]):.6g} (per iteration "
        + ", ".join(f"{c:.6g}" for c in costs_h.tolist())
        + f"); intrinsics max error {err0[0]:.4g} -> {err1[0]:.4g}, T_vs "
        f"rotation error {err0[1]:.4g} -> {err1[1]:.4g} rad, T_vs "
        f"translation error across the turn axis {err0[2]:.4g} -> "
        f"{err1[2]:.4g} m, along it (not observable) {err0[3]:.4g} -> "
        f"{err1[3]:.4g} m; solver_ok at every iteration {all_ok}; PCG "
        f"iterations per build {its} (cap {CG_SELFCAL['max_it']}, tol "
        f"{CG_SELFCAL['tol']:g}); Schur products launched {matvecs}; kernel "
        f"launches reprojection {k1} segsum {k2} schur_matvec {k6} "
        f"schur_pack {k6p} imu_preint (a) {ia} (b) {ib}")
    say(f"[{smi}] CG selfcal GN solve_fixed({n}): {secs * 1e3:.1f} ms, "
        f"{secs * 1e3 / n:.1f} ms per iteration, "
        f"{CG['poses'] * n / secs:.1f} kf/s; peak device memory "
        f"{peak / 2**30:.3f} GiB; host syncs {syncs} (the plans' "
        f"{plan_again}), per build {pcg_reads} (at most {max_reads}: the "
        f"stop test every {cg.CG_CHECK_EVERY} iterations)")
    check(finite, "cg_selfcal: non-finite values")
    check(float(costs_h[-1]) < cost0, "cg_selfcal: cost did not fall")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "cg_selfcal: the intrinsics or the T_vs rotation did not improve")
    check(len(oks) == n and all_ok, "cg_selfcal: solver_ok failed")
    check(len(pcgs) == n, f"cg_selfcal: {len(pcgs)} PCG solves in {n} "
          "iterations")
    want = (2 * n, K2_PER_CG_BUILD * n + matvecs, matvecs)
    check((k1, k2, k6) == want, f"cg_selfcal: launches {(k1, k2, k6)}, "
          f"expected {want}")
    check((ia, ib) == (n, n), f"cg_selfcal: imu_preint launches ({ia}, "
          f"{ib})")
    check(k6p == n, f"cg_selfcal: schur_pack launches {k6p}, one per build")
    check((k5, k11) == (0, 0), f"cg_selfcal: schur_finish, marginalize "
          f"launches ({k5}, {k11}) on the PCG solver")
    check(max(pcg_reads) <= max_reads, f"cg_selfcal: {max(pcg_reads)} host "
          "reads in one PCG solve")
    check(syncs - plan_again == sum(pcg_reads) == reads,
          f"cg_selfcal: {syncs - plan_again} host syncs, {reads} counted "
          f"reads, {sum(pcg_reads)} PCG stop tests")

    # the dense self-calibration of the same problem in f64 (general path,
    # one dense Cholesky of S a build)
    cfg_d = dataclasses.replace(cfg, use_cg_solver=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qd, costs_d, _ = step.solve_fixed(p64, cfg_d, True, n)
    torch.cuda.synchronize()
    secs_d = time.perf_counter() - t0
    peak_d = torch.cuda.max_memory_allocated()
    err_d = _calib_errors(qd, sim)
    gap = dict(
        intrinsics=float((q.rig.params[0, :5].double()
                          - qd.rig.params[0, :5]).abs().max()),
        tvs_rot=float(torch.linalg.norm(lie.so3_log(lie.quat_mul(
            q.rig.tvs_q[0].double(), lie.quat_conj(qd.rig.tvs_q[0]))))),
        tvs_t=float((q.rig.tvs_t[0].double() - qd.rig.tvs_t[0])[:2]
                    .abs().max()))
    say(f"[{smi}] dense GN self-calibration of the same problem, f64 on the "
        f"card, solve_fixed({n}): cost {cost0:.6g} -> "
        f"{float(costs_d[-1]):.6g}, intrinsics error {err_d[0]:.4g}, T_vs "
        f"rotation {err_d[1]:.4g} rad, translation across {err_d[2]:.4g} m, "
        f"along {err_d[3]:.4g} m; {secs_d * 1e3 / n:.1f} ms per iteration, "
        f"peak {peak_d / 2**30:.3f} GiB; the f32 PCG's calibration against "
        f"it: intrinsics {gap['intrinsics']:.4g}, T_vs rotation "
        f"{gap['tvs_rot']:.4g} rad, T_vs translation across the turn axis "
        f"{gap['tvs_t']:.4g} m (recorded, not bounded)")
    check(bool(torch.isfinite(costs_d).all()), "cg_selfcal: the dense f64 "
          "reference is not finite")
    say("PHASE cg_selfcal ok")
    return dict(k1=k1, k2=k2, k6=k6, k6_pack=k6p, imu=ia + ib, imu_a=ia,
                imu_b=ib, k5=k5, k11=k11, kf_s=CG["poses"] * n / secs,
                ms_iter=secs * 1e3 / n, peak_gib=peak / 2**30,
                cg_iters=its, syncs_per_build=pcg_reads,
                costs=costs_h.tolist(), calib_err0=err0, calib_err=err1,
                dense_f64=dict(calib_err=err_d, ms_iter=secs_d * 1e3 / n,
                               final_cost=float(costs_d[-1]), gap=gap))


def phase_timing_k6_calib(p, cfg, bs, x, floor_ms, smi):
    """Kernel 6 and its pack with the 11 calibration columns timed at the
    self-calibrating PCG's shapes beside their bounds (J_c counted), their
    plain versions and, for kernel 6, torch.mv on the dense S of the same
    build (15,371 rows in f32, formed here for the yardstick only)."""
    import torch

    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step

    P, D, K = p.poses.q.shape[0], cfg.pose_dim, cfg.calib_dim
    pj, plan = bs.pj, bs.plan.schur
    L, Nr = bs.vinv.shape[0], pj.j_m.shape[0]
    parts, pack, _ = schur_product_parts(bs, x, P, D, cfg.lm_size)
    k6_call, pack_call = parts["kernel 6"], parts["pack"]
    out6, part6 = k6_call()
    nb, nf = _k6_calib_work(Nr, L, 1, K, x.element_size())
    nb += nbytes(plan.tiles, x, bs.vinv, out6, part6)
    b6, by6 = _bound(nb, nf)
    route_bytes = nbytes(pack.rows, plan.ids, plan.tiles, bs.vinv, x, out6,
                         part6)
    bp_bytes = nbytes(pj.j_m, pj.j_r, pj.j_l, pj.j_c, plan.perm, pack.rows)
    bp, byp = _bound(bp_bytes, 0)
    sorted_plain = k6.schur_pack_plain(pj.j_m, pj.j_r, pj.j_l, plan, 1,
                                       pj.j_c)
    xm = torch.where(bs.col_mask, x, 0.0)
    cfg_d = dataclasses.replace(cfg, use_cg_solver=False)
    S = asm.assemble(p, cfg_d, imu_eval=step._imu_eval(p, cfg_d, True,
                                                       True)).S
    check(S.shape == (P * D + K,) * 2, f"dense S {tuple(S.shape)}")
    t6 = dict(ms=event_ms(k6_call, 200), device_ms=graph_ms(k6_call, 50),
              plain_ms=event_ms(lambda: k6.schur_matvec_sorted_plain(
                  sorted_plain, plan, bs.vinv, xm[: P * D], D, xm[P * D:]),
                  10),
              library_ms=event_ms(lambda: torch.mv(S, x), 20),
              library_device_ms=graph_ms(lambda: torch.mv(S, x), 10))
    s_mb = nbytes(S) / 1e6
    del S
    tp = dict(ms=event_ms(pack_call, 100), device_ms=graph_ms(pack_call, 20),
              plain_ms=event_ms(lambda: k6.schur_pack_plain(
                  pj.j_m, pj.j_r, pj.j_l, plan, 1, pj.j_c), 20))
    say(f"[{smi}] kernel 6 schur_matvec with K={K} calibration columns, CG "
        f"selfcal build (Nr={Nr}, L={L}, P={P}, D={D}) f32: {t6['ms']:.4f} "
        f"ms per call, {t6['device_ms']:.4f} ms on the device, "
        f"{b6 / t6['device_ms']:.1%} of the bound {b6:.5f} ms ({by6}: {nb} "
        f"B, {nf} flop; the route moves {route_bytes} B); plain (sorted "
        f"order) {t6['plain_ms']:.4f} ms; torch.mv on the dense S of the "
        f"same build ({P * D + K}^2, {s_mb:.0f} MB) {t6['library_ms']:.4f} "
        f"ms ({t6['library_device_ms']:.4f} ms on the device); launch floor "
        f"{floor_ms:.4f} ms")
    say(f"[{smi}] kernel 6's pack with K={K}, once per build: "
        f"{tp['ms']:.4f} ms per call ({tp['device_ms']:.4f} ms on the "
        f"device, {bp / tp['device_ms']:.1%} of the bound {bp:.5f} ms, "
        f"{byp}: {bp_bytes} B); plain {tp['plain_ms']:.4f} ms")
    say("PHASE timing (k6 calib) ok")
    rec6 = dict(t6, floor_ms=floor_ms, bound_ms=b6, bound_by=by6, bytes=nb,
                route_bytes=route_bytes)
    recp = dict(tp, floor_ms=floor_ms, bound_ms=bp, bound_by=byp,
                bytes=bp_bytes, library_ms=None)
    return rec6, recp


def phase_vins_csv(tmp, smi):
    """The CSV VINS app (apps/vins_csv.py) end to end on the card at
    VINS_CSV: its sequence written and read in the reference's CSV format,
    triangulated, the GN `solve` in f32 on the banded grid: the cost falls,
    the ATE within twice the JAX app's f64 ATE, exact launches of kernel 1,
    K2, segsum, K5b and K5; the trajectory file written."""
    import numpy as np
    import torch

    from ba_tpu_torch.apps import vins_csv as app
    from ba_tpu_torch.io import csvio
    from ba_tpu_torch.io import simulate_vins as sv

    v = VINS_CSV
    seq = tmp / "seq"
    t0 = time.perf_counter()
    csvio.write_csv(sv.simulate(n_poses=v["poses"], n_lms=v["lms"], seed=3),
                    str(seq))
    sim, n_tri, gt = app.read_sequence(str(seq))
    t_io = time.perf_counter() - t0
    app.run(sim, gt, v["perturb"], 1, "cuda")            # warm-up
    torch.cuda.synchronize()
    _counters_zero()
    res = app.run(sim, gt, v["perturb"], v["max_iter"], "cuda")
    k1, k2, reads = _counters()
    ia, ib = _imu_counters()
    k5, k11 = _marg_counters()
    k5b = _k5b_count()
    s = res.summary
    its = s.iterations
    app.write_trajectory(str(tmp / "trajectory_vins.csv"), res)
    rows = np.loadtxt(tmp / "trajectory_vins.csv", delimiter=",")
    say(f"vins_csv: {v['poses']} poses, {len(sim.obs)} observations, "
        f"{n_tri} landmarks triangulated (CSV write, read and triangulation "
        f"{t_io:.2f} s); f32 solve(max_iter {v['max_iter']}) on the card: "
        f"{its} iterations, {s.result}, cost {s.initial_cost:.6g} -> "
        f"{s.final_cost:.6g}; ATE {res.ate * 100:.4f} cm (limit "
        f"{2 * VINS_CSV_JAX_ATE * 100:.4f}: twice the JAX app's f64 "
        f"{VINS_CSV_JAX_ATE * 100:.3f}); kernel launches reprojection {k1} "
        f"segsum {k2} imu_preint (a) {ia} (b) {ib} schur_finish {k5} "
        f"band_to_dense {k5b} marginalize {k11}")
    say(f"[{smi}] vins_csv solve: {res.seconds * 1e3:.1f} ms, "
        f"{res.seconds * 1e3 / its:.2f} ms per iteration, "
        f"{v['poses'] * its / res.seconds:.1f} kf/s")
    check(np.isfinite(res.ate) and np.isfinite(s.final_cost),
          "vins_csv: non-finite values")
    check(s.final_cost < s.initial_cost, "vins_csv: cost did not fall")
    check(res.ate <= 2 * VINS_CSV_JAX_ATE, f"vins_csv: ATE {res.ate:.4g} m "
          f"above twice the JAX app's {VINS_CSV_JAX_ATE} m")
    check(rows.shape == (v["poses"], 8), f"vins_csv: trajectory file "
          f"{rows.shape}")
    check(reads == its, f"vins_csv: {reads} host reads, expected {its}")
    check(k1 == 2 * its + 1, f"vins_csv: {k1} reprojection launches, "
          f"expected {2 * its + 1} (one build and one trial per iteration, "
          f"one for the error breakdown)")
    check(k2 == its, f"vins_csv: {k2} segsum launches, expected {its}")
    check((ia, ib) == (its + 1, its + 1), f"vins_csv: imu_preint launches "
          f"({ia}, {ib}), expected ({its + 1}, {its + 1})")
    check((k5, k11, k5b) == (its, 0, its), f"vins_csv: schur_finish, "
          f"marginalize, band_to_dense launches ({k5}, {k11}, {k5b}), "
          f"expected ({its}, 0, {its})")
    say("PHASE vins_csv ok")
    return dict(k1=k1, k2=k2, imu=ia + ib, imu_a=ia, imu_b=ib, k5=k5,
                k11=k11, k5b=k5b, iters=its, ate_m=res.ate,
                ms_iter=res.seconds * 1e3 / its,
                kf_s=v["poses"] * its / res.seconds)


def phase_math_test():
    """apps/math_test.py --f32 on the card: the Lie Jacobians against
    finite differences, the FOV round trip, the assembly against the dense
    jacrev oracle, and a flagship GN iteration timed."""
    import contextlib
    import io

    from ba_tpu_torch.apps import math_test

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = math_test.main(["--f32"])
    for line in buf.getvalue().splitlines():
        say(f"math_test: {line}")
    check(rc == 0 and "ALL PASS" in buf.getvalue(),
          "math_test --f32 failed on the card")
    say("PHASE math_test ok")


# ---------------------------------------------------------------------------
# Kernel 1 for every camera model: poly3, equidistant, per-pose intrinsics
# and a rig of two models


def _rotation(q):
    """(3, 3) rotation matrix of a wxyz quaternion (numpy)."""
    import torch

    from ba_tpu_torch.core import lie

    return lie.quat_to_matrix(torch.as_tensor(q, dtype=torch.float64)).numpy()


def scene_cameras(sim, variant):
    """[(params (7,), model, T_vs translation)] of a camera scene's rig:
    the poly3 lens REF_POLY3; the flagship's fx, fy, cx, cy through the
    equidistant model; the flagship's FOV camera (per-pose intrinsics ride
    on it); or the FOV camera and the poly3 lens RIG_BASELINE m to its
    right."""
    import numpy as np

    from ba_tpu_torch.core import camera

    lens = list(sim.cam_params[:4])
    fov = np.array(list(sim.cam_params) + [0.0, 0.0])
    poly3 = np.array(REF_POLY3)
    right = sim.tvs_t + _rotation(sim.tvs_q) @ np.array([RIG_BASELINE, 0, 0])
    return {"poly3": [(poly3, camera.MODEL_POLY3, sim.tvs_t)],
            "equidistant": [(np.array(lens + [0.0] * 3),
                             camera.MODEL_EQUIDISTANT, sim.tvs_t)],
            "per_pose": [(fov, camera.MODEL_FOV, sim.tvs_t)],
            "rig": [(fov, camera.MODEL_FOV, sim.tvs_t),
                    (poly3, camera.MODEL_POLY3, right)]}[variant]


def per_pose_params(params, n):
    """(n, 7) per-pose intrinsics: fx, fy scaled by 1 + PER_POSE_STEP
    (i mod 8) at pose i."""
    import numpy as np

    pp = np.tile(params, (n, 1))
    pp[:, :2] *= (1.0 + PER_POSE_STEP * (np.arange(n) % 8))[:, None]
    return pp


def scene_observations(sim, cams, pose_params=None):
    """[(pose, landmark, camera, pixel)], pose-major then camera then
    landmark: the simulator's depth and distance limits (> 0.5 m ahead,
    < 12 m), the pixel from the port's plain `camera.project` inside
    IMG_WH, on the model's invertible branch (the unprojection of the pixel
    gives back the ray: poly3 folds back beyond r ~ 3.5).  `pose_params`
    (P, 7) replaces each camera's intrinsics by the pose's own."""
    import numpy as np
    import torch

    from ba_tpu_torch.core import camera

    P, L = len(sim.t_wv), len(sim.lms_w)
    R_wv = np.stack([_rotation(q) for q in sim.q_wv])
    R_vs = _rotation(sim.tvs_q)
    found = []
    for c, (params, model, tvs_t) in enumerate(cams):
        R_ws = R_wv @ R_vs
        t_ws = sim.t_wv + R_wv @ tvs_t
        p_s = np.einsum("pji,plj->pli", R_ws,
                        sim.lms_w[None] - t_ws[:, None])
        prm = np.ascontiguousarray(np.broadcast_to(
            params if pose_params is None else pose_params[:, None],
            (P, L, 7)))
        ray = torch.as_tensor(p_s)
        m = torch.tensor(model)
        pix = camera.project(torch.as_tensor(prm), m, ray)
        back = camera.unproject(torch.as_tensor(prm), m, pix)
        cos = (back * ray).sum(-1) / ray.norm(dim=-1)
        pix = pix.numpy()
        ok = ((p_s[..., 2] > 0.5) & (np.linalg.norm(p_s, axis=-1) < 12.0)
              & (pix[..., 0] >= 0) & (pix[..., 0] < IMG_WH[0])
              & (pix[..., 1] >= 0) & (pix[..., 1] < IMG_WH[1])
              & (cos.numpy() > 1 - 1e-9))
        found += [(int(i), int(j), c, pix[i, j])
                  for i, j in zip(*ok.nonzero())]
    found.sort(key=lambda o: (o[0], o[2], o[1]))
    return found


def camera_scene(sim, variant, device="cuda", perturb=0.01, seed=1,
                 pose_dim=9):
    """(f64 problem, config) of the flagship sequence re-measured through
    a camera variant (`scene_cameras`), built as
    `simulate_vins.build_problem` builds the flagship: poses from index 2
    perturbed, landmark depths perturbed along the ray from the reference
    pose (the first that sees it), the same random draws in the same
    order; the IMU spans.  A landmark of the rig is referenced to camera
    j mod 2 where that camera sees it at the reference pose, else to the
    other, so the other camera's row at the reference pose stays (a
    same-pose cross-camera row)."""
    import numpy as np
    import torch

    from ba_tpu_torch.core import lie
    from ba_tpu_torch.core.problem import BAConfig, ProblemBuilder
    from ba_tpu_torch.solver.assemble import band_width_of

    per_pose = variant == "per_pose"
    cfg = BAConfig(pose_dim=pose_dim, lm_size=1,
                   use_per_pose_cam_params=per_pose)
    cams = scene_cameras(sim, variant)
    P = len(sim.pose_times)
    pp = per_pose_params(cams[0][0], P) if per_pose else None
    obs = scene_observations(sim, cams, pp)
    rng = np.random.default_rng(seed)
    b = ProblemBuilder(cfg)
    cam_ids = [b.add_camera(prm, model, tvs_q=sim.tvs_q, tvs_t=tvs_t)
               for prm, model, tvs_t in cams]
    first_seen, seen = {}, set()
    for i, j, c, _ in obs:
        first_seen.setdefault(j, i)
        seen.add((i, j, c))
    pose_ids = []
    for i in range(P):
        active = i >= 2
        q, t, v = sim.q_wv[i].copy(), sim.t_wv[i].copy(), sim.v_w[i].copy()
        if active and perturb:
            dq = lie.so3_exp(torch.as_tensor(rng.normal(size=3) * perturb,
                                             dtype=torch.float64))
            q = lie.quat_mul(torch.as_tensor(q, dtype=torch.float64),
                             dq).numpy()
            t = t + rng.normal(size=3) * perturb
            v = v + rng.normal(size=3) * perturb
        pose_ids.append(b.add_pose(q, t, v=v, active=active,
                                   time=float(sim.pose_times[i]),
                                   cam_params=None if pp is None else pp[i]))
    lm_ids = {}
    for j, ref in first_seen.items():
        x_w = sim.lms_w[j].copy()
        if perturb:
            c0 = sim.t_wv[ref]
            x_w = c0 + (x_w - c0) * (1.0 + rng.normal() * perturb)
        rc = j % len(cams)
        if (ref, j, rc) not in seen:
            rc = 1 - rc
        lm_ids[j] = b.add_landmark(x_w, ref_pose=pose_ids[ref],
                                   ref_cam=cam_ids[rc])
    for i, j, c, z in obs:
        b.add_projection_residual(z, pose_ids[i], lm_ids[j], cam_ids[c])
    if pose_dim >= 9:
        for i in range(P - 1):
            w, a, ts = sim.imu_spans[i]
            b.add_imu_residual(pose_ids[i], pose_ids[i + 1], w, a, ts)
    p = b.build(device=device)
    return p, dataclasses.replace(cfg, band_width=band_width_of(p))


def camera_scenes():
    """{variant: (f64 problem, f32 problem, config, SimData)} of the four
    full-width camera scenes on the card, prepared."""
    import torch

    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.utils.tree import tree_map

    sim = sv.simulate(n_poses=N_POSES, n_lms=N_LMS, seed=0)
    out = {}
    for variant in CAMERA_SCENES:
        t0 = time.perf_counter()
        p64, cfg = camera_scene(sim, variant)
        p32 = tree_map(lambda a: a.float() if a.dtype == torch.float64
                       else a, p64)
        pr = p64.proj
        same = int(((pr.pose == p64.lms.ref_pose[pr.lm])
                    & (pr.cam != p64.lms.ref_cam[pr.lm])).sum())
        say(f"camera scene {variant}: P={p64.poses.q.shape[0]} "
            f"L={p64.lms.x.shape[0]} Nr={pr.z.shape[0]} rows in "
            f"{IMG_WH[0]}x{IMG_WH[1]}, cameras {p64.rig.model.tolist()}, "
            f"landmarks per reference camera "
            f"{torch.bincount(p64.lms.ref_cam).tolist()}, same-pose "
            f"cross-camera rows {same}, band width {cfg.band_width} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(pr.z.shape[0] > 10 * N_LMS // 16, f"camera scene {variant}: "
              f"too few rows")
        if variant == "rig":
            check(same > 0 and bool((torch.bincount(p64.lms.ref_cam)
                                     > 0).all()), "camera scene rig: no "
                  "same-pose cross-camera row or a camera references none")
        out[variant] = (prepare_landmarks(p64, cfg),
                        prepare_landmarks(p32, cfg), cfg, sim)
    return out


def k1_combos(p, cfg):
    """[(label, problem, config)] of K1's combinations on a camera scene:
    as built; with the 5 intrinsics and the 6 T_vs tangents of camera 0
    as calibration columns (its intrinsics moved by CALIB_ERR, so the
    reference rays come from the unprojection through moved intrinsics);
    with XYZ landmarks (lm_size 3)."""
    from ba_tpu_torch.core.problem import prepare_landmarks

    params = p.rig.params.clone()
    params[0, :5] += params.new_tensor(CALIB_ERR)
    moved = dataclasses.replace(p, rig=dataclasses.replace(p.rig,
                                                           params=params))
    cfg3 = dataclasses.replace(cfg, lm_size=3)
    return [("", p, cfg),
            (" K=11", moved, dataclasses.replace(cfg, calib_size=5,
                                                 do_tvs=True)),
            (" lm_size 3", prepare_landmarks(p, cfg3), cfg3)]


def phase_k1_cameras(scenes):
    """Kernel 1 against its plain version on each camera scene at every
    combination of `k1_combos`, f64 and f32, with and without Jacobians,
    at the scene's rows and at a ragged last block.  Returns {variant: f32
    max abs error}."""
    worst = {}
    for variant, (p64, p32, cfg, _) in scenes.items():
        worst[variant] = max(
            k1_against_plain(p, c, f"{variant}{label}")
            for (label, q64, c), (_, q32, _) in zip(k1_combos(p64, cfg),
                                                   k1_combos(p32, cfg))
            for p in (q64, q32, ragged(q64), ragged(q32)))
    say("PHASE k1_cameras ok")
    return worst


def k1_timing(p, cfg, floor_ms, label, smi):
    """Kernel 1 timed at one problem's shapes beside its bound (bytes and
    operations counted as for the flagship FOV row, the per-pose table and
    the calibration columns included where the variant has them) and its
    plain version."""
    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.kernels import reprojection as k1

    pr, poses, lms, rig = p.proj, p.poses, p.lms, p.rig
    per_pose = cfg.use_per_pose_cam_params

    def call():
        return k1.reprojection(p, True, cfg.lm_size, cfg.calib_size,
                               cfg.do_tvs, per_pose)

    nb = nbytes(pr.z, pr.pose, pr.lm, pr.cam, pr.valid, poses.q, poses.t,
                lms.x, lms.ref_pose, lms.ref_cam, rig.params, rig.model,
                rig.tvs_q, rig.tvs_t, *call())
    if per_pose:
        nb += nbytes(poses.cam_params)
    if cfg.calib_size:
        nb += nbytes(lms.z_ref, lms.has_z_ref)
    rows = int(pr.valid.sum())
    nf = rows * (K1_FLOPS_PER_ROW + cfg.calib_size * K1_CAL_FLOPS_INTRINSIC
                 + 6 * cfg.do_tvs * K1_CAL_FLOPS_TVS)
    bound, by = _bound(nb, nf)
    t = dict(ms=event_ms(call, 200), device_ms=graph_ms(call, 50),
             plain_ms=event_ms(lambda: rp.evaluate_plain(p, cfg, True), 5))
    say(f"[{smi}] kernel 1 reprojection, {label}, Nr={pr.z.shape[0]} "
        f"({rows} valid) f32: {t['ms']:.4f} ms per call "
        f"({t['device_ms']:.4f} ms on the device, "
        f"{bound / t['device_ms']:.1%} of the bound {bound:.5f} ms, {by}: "
        f"{nb} B, {nf} flop), plain {t['plain_ms']:.3f} ms; launch floor "
        f"{floor_ms:.4f} ms")
    if PARENT is not None and not per_pose and bool((rig.model <= 1).all()):
        import importlib

        parent_package(PARENT)
        k1p = importlib.import_module(
            "ba_tpu_torch_parent.kernels.reprojection")

        def parent_call():
            return k1p.reprojection(p, True, cfg.lm_size, cfg.calib_size,
                                    cfg.do_tvs)

        t["parent_device_ms"] = graph_ms(parent_call, 50)
        t["device_ms_after_parent"] = graph_ms(call, 50)
        say(f"[{smi}] kernel 1 reprojection, {label}: the parent's kernel "
            f"on the same inputs {t['parent_device_ms']:.5f} ms on the "
            f"device; this tree's {t['device_ms']:.5f} before it, "
            f"{t['device_ms_after_parent']:.5f} after")
    return dict(t, bound_ms=bound, bound_by=by, library_ms=None)


def phase_scene_f64(p64, cfg, sim, ate32, label):
    """GN solve_fixed(..., 25) of a camera scene in f64 on the card: its
    cost and ATE fall, and its ATE is at most the f32 GN's `ate32`.  The
    scene is then well posed for GN: f64 converges at least as near the
    truth as f32, so the f32 GN's fall is not a rounding accident (on an
    ill-conditioned lens f64 GN stalls where f32 happens to land)."""
    import torch

    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    cfg = dataclasses.replace(cfg, use_dogleg=False)
    cost0 = float(evaluate_cost(p64, cfg, step._imu_eval(p64, cfg, True,
                                                         False)))
    ate0 = _ate(p64, sim)
    t0 = time.perf_counter()
    p, costs, _ = step.solve_fixed(p64, cfg, True, N_ITERS)
    costs = costs.cpu()
    secs = time.perf_counter() - t0
    ate1 = _ate(p, sim)
    say(f"{label}GN solve_fixed({N_ITERS}) f64: cost {cost0:.6g} -> "
        f"{float(costs[-1]):.6g}, ATE {ate0:.6g} -> {ate1:.6g} m ({secs:.2f} "
        f"s); the f32 GN's ATE {ate32:.6g} m")
    check(bool(torch.isfinite(costs).all()) and _finite(p),
          f"{label}f64 GN: non-finite values")
    check(float(costs[-1]) < cost0, f"{label}f64 GN: cost did not fall")
    check(ate1 < ate0, f"{label}f64 GN: ATE did not fall")
    check(ate1 <= ate32, f"{label}f64 GN: ATE {ate1:.6g} m above the f32 "
          f"GN's {ate32:.6g}")
    return ate1


def reference_camera_scene(kind, device, n_poses=None, n_lms=None,
                           perturb=0.03, seed=None):
    """The scenes of ba_tpu's tests/test_camera_models.py
    (`_scene_with_model`: "poly3", "equidistant", "per_pose" (poly3 with
    per-pose focal lengths)) and tests/test_stereo.py (`make_stereo_scene`:
    "stereo", FOV cameras STEREO_BASELINE m apart), built from the same
    numpy draws with the port alone; defaults are those tests' BA sizes.
    Returns (problem, config, landmarks' true positions)."""
    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from ba_tpu_torch.core import camera, lie
    from ba_tpu_torch.core.problem import BAConfig, ProblemBuilder

    stereo = kind == "stereo"
    if n_poses is None:
        n_poses, n_lms, seed = (4, 24, 3) if stereo else (6, 30, 0)
    rng = np.random.default_rng(seed)
    cfg = BAConfig(pose_dim=6, lm_size=1, use_dogleg=False,
                   use_robust_norm_for_proj_residuals=False,
                   use_per_pose_cam_params=kind == "per_pose")
    b = ProblemBuilder(cfg)
    if stereo:
        cams = [(b.add_camera(STEREO_FOV, camera.MODEL_FOV), np.zeros(3)),
                (b.add_camera(STEREO_FOV, camera.MODEL_FOV,
                              tvs_t=(STEREO_BASELINE, 0.0, 0.0)),
                 np.array([STEREO_BASELINE, 0, 0]))]
        params = np.array(STEREO_FOV, float)
    else:
        params = np.array(REF_EQUI if kind == "equidistant" else REF_POLY3,
                          float)
        model = (camera.MODEL_EQUIDISTANT if kind == "equidistant"
                 else camera.MODEL_POLY3)
        cams = [(b.add_camera(params, model), np.zeros(3))]

    def proj(prm, pc):
        xn, yn = pc[..., 0] / pc[..., 2], pc[..., 1] / pc[..., 2]
        r2 = xn**2 + yn**2
        if stereo:
            fx, fy, cx, cy, w = prm
            r = np.sqrt(r2)
            f = (np.arctan(2 * r * np.tan(w / 2)) / (r * w) if r > 1e-9
                 else 2 * np.tan(w / 2) / w)
        elif kind == "equidistant":
            fx, fy, cx, cy = prm
            r = np.sqrt(r2)
            f = np.where(r < 1e-12, 1.0, np.arctan(r) / np.maximum(r, 1e-12))
        else:
            fx, fy, cx, cy, k1, k2, k3 = prm
            f = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        return np.stack([fx * f * xn + cx, fy * f * yn + cy], axis=-1)

    R_list, t_list, pose_ids, pose_params = [], [], [], []
    for i in range(n_poses):
        ang = 2 * np.pi * i / n_poses
        pos = np.array([5 * np.cos(ang), 5 * np.sin(ang), 0.0])
        z = -pos / np.linalg.norm(pos)
        x = np.cross(np.array([0.0, 0, 1]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_list.append(np.stack([x, y, z], axis=1))
        t_list.append(pos)
    if stereo:
        lms_w = rng.normal(size=(n_lms, 3)) * np.array([1.2, 1.2, 0.8])
    for i in range(n_poses):
        q = np.roll(Rotation.from_matrix(R_list[i]).as_quat(), 1)
        active = i >= (1 if stereo else 2)
        t = t_list[i]
        if active and perturb:
            dq = lie.so3_exp(torch.as_tensor(rng.normal(size=3) * perturb))
            q = lie.quat_mul(torch.as_tensor(q), dq).numpy()
            t = t_list[i] + rng.normal(size=3) * perturb * 5
        pp = params.copy()
        if kind == "per_pose":
            pp[:2] *= 1.0 + 0.02 * i
        pose_params.append(pp)
        pose_ids.append(b.add_pose(q, t, active=active, time=float(i),
                                   cam_params=pp if kind == "per_pose"
                                   else None))
    if not stereo:
        lms_w = rng.normal(size=(n_lms, 3)) * np.array([1.2, 1.2, 0.8])
    c0, lm_ids = t_list[0], []
    for j in range(n_lms):
        if stereo and not perturb:
            x_pert = lms_w[j]
        else:
            ray = lms_w[j] - c0
            x_pert = c0 + ray * (1.0 + (rng.normal() * perturb if perturb
                                        else 0.0))
        lm_ids.append(b.add_landmark(x_pert, ref_pose=0, ref_cam=0))
    for i in range(n_poses):
        for j in range(n_lms):
            for cam, dtv in cams:
                tws = t_list[i] + R_list[i] @ dtv
                pc = R_list[i].T @ (lms_w[j] - tws)
                z = proj(pose_params[i], pc)
                if not (0 <= z[0] < 640 and 0 <= z[1] < 480):
                    continue
                b.add_projection_residual(z, pose_ids[i], lm_ids[j], cam)
    return b.build(device=device), cfg, lms_w


def phase_camera_reference():
    """The scenes of ba_tpu's camera-model and stereo tests at their own
    sizes (`reference_camera_scene`), f64, `solve(max_iter=15)` (20 for
    stereo) on the card against the CPU: the same iterations and result
    code, final cost, poses and landmarks within TOL_SMALL."""
    import torch

    from ba_tpu_torch.solver import step

    for kind in ("poly3", "equidistant", "per_pose", "stereo"):
        out = {}
        for dev in ("cuda", "cpu"):
            p, cfg, _ = reference_camera_scene(kind, dev)
            out[dev] = step.solve(p, cfg, use_imu=False,
                                  max_iter=20 if kind == "stereo" else 15)
        (pg, sg), (pc, sc) = out["cuda"], out["cpu"]
        pairs = [("poses.q", pg.poses.q, pc.poses.q),
                 ("poses.t", pg.poses.t, pc.poses.t),
                 ("lms.x_w", pg.lms.x_w, pc.lms.x_w),
                 ("final cost", torch.tensor(sg.final_cost),
                  torch.tensor(sc.final_cost))]
        for name, a, b in pairs:
            _, rel = rel_err(a.cpu(), b)
            say(f"card vs CPU, {kind} reference scene f64: {name} rel err "
                f"{rel:.3e} (tol {TOL_SMALL:g})")
            check(rel <= TOL_SMALL, f"card vs CPU {kind} {name}: {rel:.3g}")
        say(f"card vs CPU {kind}: {sg.iterations} iterations, {sg.result}, "
            f"final cost {sg.final_cost:.3e} (CPU {sc.iterations}, "
            f"{sc.result})")
        check((sg.iterations, sg.result) == (sc.iterations, sc.result),
              f"{kind}: the card took another path than the CPU")
        check(sg.final_cost < 1e-4, f"{kind}: final cost {sg.final_cost}")
    say("PHASE camera_reference ok")


def main():
    import torch

    global PARENT

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--parent" in sys.argv[1:]:
        PARENT = sys.argv[sys.argv.index("--parent") + 1]
    import ba_tpu_torch

    check(Path(ba_tpu_torch.__file__).resolve().parents[1] == ROOT,
          f"ba_tpu_torch imported from {ba_tpu_torch.__file__}, not from "
          f"this checkout")
    smi = smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say(f"device {kind} x{count}; {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    phase_build()
    p64, p32, cfg, sim = flagship()
    err1 = phase_k1(p64, p32, cfg)
    err_imu = [phase_imu(p64, cfg, "flagship")]
    for label, q, cfg_q in imu_option_cases(p64, cfg):
        err_imu.append(phase_imu(q, cfg_q, label))
    for n in IMU_LONG_SPANS:
        err_imu.append(phase_imu(*long_span_problem(n),
                                 f"spans of {n + 1} slots"))
    del p64
    sums = capture_build_sums(p32, cfg)
    err2 = phase_segsum(sums)
    phase_small_reference()
    phase_general_small()
    phase_ring_small()
    n_plan_syncs = plan_syncs(p32, cfg, smi)
    gn = phase_gn(p32, cfg, sim, smi, n_plan_syncs)
    dl = phase_dogleg(p32, cfg, sim, smi, n_plan_syncs)
    st, sched, cfg_s = phase_stream(smi)
    sm = phase_stream_many(smi)
    s64, s32 = stream_slide(sched, cfg_s)
    err1s = phase_k1(s64, s32, cfg_s, "stream slide")
    err_imu.append(phase_imu(s64, cfg_s, "stream slide"))
    del s64
    sums_s = capture_build_sums(s32, cfg_s)
    err2s = phase_segsum(sums_s, "stream slide", extras=False)
    rec1, rec2 = phase_timing(p32, cfg, sums, smi)
    rec1s, rec2s = phase_timing(s32, cfg_s, sums_s, smi, "stream slide")
    rec_imu = phase_timing_imu(p32, cfg, rec1["floor_ms"], smi)
    del sums_s, sched
    band_flag = dense_build_band(p32, cfg, "flagship")

    bsm = phase_banded_small()
    pl, cfg_l, sim_l = long_problem()
    bs_l, plan_l = long_blocks(pl, cfg_l)
    err7 = phase_k7(pl, cfg_l, bs_l, plan_l)
    err9, band_l, band_s, x_l = phase_k9(pl, cfg_l, bs_l)
    err8 = phase_k8(pl, cfg_l, band_l)
    err_imu.append(phase_imu(pl, cfg_l, "long"))
    lg = phase_long(pl, cfg_l, sim_l, smi)
    k8_iter = sum(lg["k8"].values()) / LONG["iters"]
    rec7, rec9, (rec8a, rec8b, rec8c) = phase_timing_band(
        pl, cfg_l, bs_l, plan_l, band_l, band_s, x_l, k8_iter,
        rec1["floor_ms"], smi)
    del pl, bs_l, plan_l, band_l, band_s, x_l

    phase_cg_small()
    pc, cfg_c, sim_c = cg_problem()
    bs_c = cg_blocks(pc, cfg_c)
    p3, cfg_3, _ = cg_problem(3)
    bs_3 = cg_blocks(p3, cfg_3)
    err6, err6p, x_c = phase_k6(pc, cfg_c, bs_c, p3, cfg_3, bs_3)
    del p3, bs_3
    err_imu.append(phase_imu(pc, cfg_c, "cg"))
    cg = phase_cg(pc, cfg_c, sim_c, smi)
    phase_fleet_small()
    pf, cfg_f, sim_f, windows = fleet_problem()
    bs_f, plan_f = fleet_blocks(pf, cfg_f)
    err10 = phase_k10(pf, cfg_f, bs_f, plan_f)
    err_imu.append(phase_imu(pf, cfg_f, "fleet"))
    fl = phase_fleet(pf, cfg_f, sim_f, windows, smi)
    rec6, rec6p, rec2c, rec10 = phase_timing_cg_fleet(
        pc, cfg_c, bs_c, x_c, pf, cfg_f, bs_f, plan_f, rec1["floor_ms"], smi)
    del pc, bs_c, x_c, pf, bs_f, plan_f, windows

    t_new = time.perf_counter()
    ps64, ps32, cfg_sc, sim_sc = selfcal_problem()
    err_imu.append(phase_imu(ps64, cfg_sc, "selfcal"))
    del ps64
    (pv0, cfg_v0), (pv, cfg_v) = vicalib_problems()
    err_imu.append(phase_imu(pv0, cfg_v0, "vicalib stage 0"))
    err_imu.append(phase_imu(pv, cfg_v, "vicalib stage 2"))
    err1c = phase_k1_calib([("selfcal K=11 FOV", ps32, cfg_sc),
                            ("vicalib lm_size 3 linear K=11", pv, cfg_v)])
    del pv0, pv
    rec1c = k1_timing(ps32, cfg_sc, rec1["floor_ms"], "selfcal", smi)
    k5c = k5_cases(p32, cfg, s32, cfg_s, ps32, cfg_sc)
    err5 = phase_k5(k5c)
    k11c = k11_cases()
    err11, info11 = phase_k11(k11c)
    rec5, rec11 = phase_timing_k5_k11(k5c, k11c, info11, rec1["floor_ms"],
                                      smi)
    del k5c, k11c, s32
    phase_selfcal_small()
    sc = phase_selfcal(ps32, cfg_sc, sim_sc, smi)
    vc = phase_vicalib(smi)
    t_new = time.perf_counter() - t_new

    t_gps = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gps_") as tmp:
        tmp = Path(tmp)
        pg_small, cfg_gs = phase_gps_small(tmp)
        imu_g, gps_g, gu_g = _gps_log(tmp)
    err_imu.append(phase_imu(pg_small, cfg_gs, "gps spans"))
    del pg_small
    gb, pg32, cfg_g = phase_gps_batch(imu_g, gps_g, gu_g, smi)
    gs = phase_gps_stream(imu_g, gps_g, gu_g, smi)
    rec_imu_gps = phase_timing_imu(pg32, cfg_g, rec1["floor_ms"], smi,
                                   "gps batch")
    band_gps = dense_build_band(pg32, cfg_g, "GPS batch")
    err5b, rec5b = phase_k5b(
        [("flagship", band_flag), ("gps batch", band_gps)]
        + k5b_odd_cases(), ("flagship", "gps batch"), rec1["floor_ms"], smi)
    del pg32, band_gps, band_flag
    t_gps = time.perf_counter() - t_gps

    t_slice = time.perf_counter()
    phase_cg_selfcal_small()
    pcs, pcs64, cfg_cs, sim_cs = cg_selfcal_problem()
    bs_cs = cg_blocks(pcs, cfg_cs)
    err6c, err6cp, x_cs = phase_k6_calib(pcs, cfg_cs, bs_cs)
    csc = phase_cg_selfcal(pcs, pcs64, cfg_cs, sim_cs, smi)
    del pcs64
    rec6c, rec6cp = phase_timing_k6_calib(pcs, cfg_cs, bs_cs, x_cs,
                                          rec1["floor_ms"], smi)
    del pcs, bs_cs, x_cs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csv_") as tmp:
        vcsv = phase_vins_csv(Path(tmp), smi)
    phase_math_test()
    t_slice = time.perf_counter() - t_slice

    t_cam = time.perf_counter()
    cams = camera_scenes()
    err1m = phase_k1_cameras(cams)
    cs = {}
    for v, (pv64, pv, cfg_v, sim_v) in cams.items():
        g = phase_gn(pv, cfg_v, sim_v, smi, n_plan_syncs, f"{v} ")
        d = phase_dogleg(pv, cfg_v, sim_v, smi, n_plan_syncs, f"{v} ")
        phase_scene_f64(pv64, cfg_v, sim_v, g["ate"], f"{v} ")
        cs[v] = dict(k1=g["k1"] + d["k1"], k1_gn=g["k1"], k1_dogleg=d["k1"],
                     rows=pv.proj.z.shape[0],
                     gn_ms_iter=N_POSES / g["kf_s"] * 1e3,
                     dogleg_ms_iter=N_POSES / d["kf_s"] * 1e3)
    rec1m = {v: k1_timing(cams[v][1], cams[v][2], rec1["floor_ms"],
                          f"{v} scene", smi) for v in CAMERA_SCENES}
    del cams
    phase_camera_reference()
    pvp, cfg_vp = vicalib_problems(poly3=True)[-1]
    err1vp = phase_k1_calib([("vicalib poly3 lm_size 3 K=11", pvp, cfg_vp)])
    rec1vp = k1_timing(pvp, cfg_vp, rec1["floor_ms"], "vicalib poly3", smi)
    del pvp
    vp = phase_vicalib(smi, poly3=True)
    t_cam = time.perf_counter() - t_cam

    runs = dict(gn=gn, dogleg=dl, stream=st, stream_many=sm, long=lg, cg=cg,
                fleet=fl, selfcal=sc, vicalib=vc, gps_batch=gb,
                gps_stream=gs, cg_selfcal=csc, vins_csv=vcsv)

    def paths(key, names=tuple(runs)):
        out = {f"launches_{n}": runs[n][key] for n in names}
        return dict(launches=sum(out.values()), **out)

    k1_src = dict(route="cuda",
                  source="ba_tpu_torch/kernels/csrc/reprojection.cu",
                  replaces="80bbf6f^:ba_tpu/ops/reprojection_pallas.py:83")
    kernels = [
        dict(name="reprojection", route="cuda",
             source="ba_tpu_torch/kernels/csrc/reprojection.cu",
             replaces="80bbf6f^:ba_tpu/ops/reprojection_pallas.py:83",
             **paths("k1"), launches_per_slide=st["k1"] / st["slides"],
             max_abs_err=max(err1, err1s, err1c), **rec1,
             stream_slide=dict(max_abs_err=err1s, **rec1s),
             calib=dict(max_abs_err=err1c, **rec1c)),
        dict(name="imu_preint", route="cuda",
             source="ba_tpu_torch/kernels/csrc/imu_preint.cu",
             replaces="ba_tpu/core/residuals/imu.py:122",
             **paths("imu"),
             launches_parts=dict(full=paths("imu_a"),
                                 residual=paths("imu_b")),
             max_abs_err=max(err_imu), **rec_imu, gps_batch=rec_imu_gps),
        dict(name="segsum", route="cuda",
             source="ba_tpu_torch/kernels/csrc/segsum.cu",
             replaces="ba_tpu/solver/assemble.py:120",
             **paths("k2"), launches_per_slide=st["k2"] / st["slides"],
             max_abs_err=max(err2, err2s), **rec2,
             stream_slide=dict(max_abs_err=err2s, **rec2s),
             pcg_product=dict(launches=cg["k2"], **rec2c)),
        dict(name="band_schur", route="cuda",
             source="ba_tpu_torch/kernels/csrc/band_schur.cu",
             replaces="ba_tpu/solver/banded.py:96", launches=lg["k7"],
             launches_long=lg["k7"], max_abs_err=err7, **rec7),
        dict(name="band_matvec", route="cuda",
             source="ba_tpu_torch/kernels/csrc/band_matvec.cu",
             replaces="ba_tpu/solver/banded.py:229", launches=lg["k9"],
             launches_long=lg["k9"], max_abs_err=err9, **rec9),
        dict(name="schur_matvec", route="cuda",
             source="ba_tpu_torch/kernels/csrc/schur_matvec.cu",
             replaces="ba_tpu/solver/cg.py:160", launches=cg["k6"],
             launches_cg=cg["k6"], max_abs_err=err6, **rec6),
        dict(name="schur_pack", route="cuda",
             source="ba_tpu_torch/kernels/csrc/schur_matvec.cu",
             replaces="ba_tpu/solver/cg.py:160", launches=cg["k6_pack"],
             launches_cg=cg["k6_pack"], max_abs_err=err6p, **rec6p),
        dict(name="schur_matvec_calib", route="cuda",
             source="ba_tpu_torch/kernels/csrc/schur_matvec.cu",
             replaces="ba_tpu/solver/cg.py:160", launches=csc["k6"],
             launches_cg_selfcal=csc["k6"], calib_dim=11, max_abs_err=err6c,
             **rec6c),
        dict(name="schur_pack_calib", route="cuda",
             source="ba_tpu_torch/kernels/csrc/schur_matvec.cu",
             replaces="ba_tpu/solver/cg.py:160", launches=csc["k6_pack"],
             launches_cg_selfcal=csc["k6_pack"], calib_dim=11,
             max_abs_err=err6cp, **rec6cp),
        dict(name="fleet_schur", route="cuda",
             source="ba_tpu_torch/kernels/csrc/fleet_schur.cu",
             replaces="ba_tpu/solver/banded.py:498", launches=fl["k10"],
             launches_fleet=fl["k10"],
             max_abs_err=err10[0], max_abs_err_lm3=err10[1], **rec10),
        dict(name="schur_finish", route="cuda",
             source="ba_tpu_torch/kernels/csrc/schur_finish.cu",
             replaces="ba_tpu/solver/assemble.py:442", **paths("k5"),
             launches_per_slide=st["k5"] / st["slides"], max_abs_err=err5,
             **rec5["flagship"], stream_slide=rec5["stream slide"],
             selfcal=rec5["selfcal"]),
        dict(name="marginalize", route="cuda",
             source="ba_tpu_torch/kernels/csrc/marginalize.cu",
             replaces="ba_tpu/solver/window.py:66", **paths("k11"),
             launches_per_slide=st["k11"] / st["slides"], max_abs_err=err11,
             **rec11["stream slide"], vins_window=rec11["vins_window"],
             indefinite=rec11["indefinite"],
             indefinite_n360=rec11["indefinite n=360"],
             psd_n360=rec11["PSD n=360"], info=info11,
             certified=dict(stream=st["k11_branches"],
                            stream_many=sm["k11_branches"],
                            gps_stream=gs["k11_branches"])),
        dict(name="band_to_dense", route="cuda",
             source="ba_tpu_torch/kernels/csrc/band_to_dense.cu",
             replaces="ba_tpu/solver/assemble.py:159",
             **paths("k5b", ("gn", "dogleg", "gps_batch", "vins_csv")),
             max_abs_err=err5b, **rec5b["flagship"],
             gps_batch=rec5b["gps batch"]),
        dict(name="chunk_layout", route="cuda",
             source="ba_tpu_torch/kernels/csrc/chunk_layout.cu",
             replaces="ba_tpu/solver/banded.py:245",
             launches=lg["k8"]["chunk_layout"],
             launches_long=lg["k8"]["chunk_layout"],
             launches_banded_small=bsm["chunk_layout"],
             max_abs_err=err8["a"], **rec8a),
        dict(name="chunk_factor", route="cuda",
             source="ba_tpu_torch/kernels/csrc/chunk_factor.cu",
             replaces="ba_tpu/solver/banded.py:307",
             launches=lg["k8"]["bcr_factor"] + lg["k8"]["scan_factor"],
             launches_long=lg["k8"]["bcr_factor"] + lg["k8"]["scan_factor"],
             launches_banded_small=dict(
                 cyclic_reduction=bsm["bcr_factor"],
                 scan=bsm["scan_factor"]),
             max_abs_err=err8["f"], **rec8b),
        dict(name="chunk_solve", route="cuda",
             source="ba_tpu_torch/kernels/csrc/chunk_solve.cu",
             replaces="ba_tpu/solver/banded.py:369",
             launches=lg["k8"]["bcr_solve"] + lg["k8"]["scan_solve"],
             launches_long=lg["k8"]["bcr_solve"] + lg["k8"]["scan_solve"],
             launches_banded_small=dict(
                 cyclic_reduction=bsm["bcr_solve"],
                 scan=bsm["scan_solve"]),
             max_abs_err=err8["s"], **rec8c),
    ] + [
        dict(name=f"reprojection_{v}", **k1_src, launches=cs[v]["k1"],
             launches_gn=cs[v]["k1_gn"], launches_dogleg=cs[v]["k1_dogleg"],
             rows=cs[v]["rows"], max_abs_err=err1m[v], **rec1m[v])
        for v in CAMERA_SCENES
    ] + [
        dict(name="reprojection_calib_poly3", **k1_src, launches=vp["k1"],
             launches_vicalib_poly3=vp["k1"], calib_dim=11,
             max_abs_err=err1vp, **rec1vp),
    ]
    say(f"[{smi}] kf/s: GN solve_fixed({N_ITERS}) {gn['kf_s']:.1f}, "
        f"dogleg solve {dl['kf_s']:.1f} ({dl['iters']} iterations); "
        f"stream {st['kf_s']:.3f} keyframes retired/s "
        f"({st['ms_slide']:.1f} ms per slide, "
        f"{st['syncs_per_push']:.2f} host syncs per push); stream_many "
        f"{sm['streams']} x {sm['keyframes']} keyframes {sm['kf_s']:.3f} "
        f"keyframes retired/s aggregate ({sm['ms_round']:.1f} ms per round, "
        f"{sm['syncs_per_push']:.2f} host syncs per push); long GN "
        f"{lg['kf_s']:.1f} kf/s ({lg['ms_iter']:.1f} ms per iteration, "
        f"peak {lg['peak_gib']:.3f} GiB); CG GN {cg['kf_s']:.1f} kf/s "
        f"({cg['ms_iter']:.1f} ms per iteration, peak {cg['peak_gib']:.3f} "
        f"GiB); fleet GN {fl['kf_s']:.1f} kf/s ({fl['ms_iter']:.1f} ms per "
        f"iteration); K8 layout {rec8a['ms']:.3f} ms, factor "
        f"{rec8b['ms']:.3f} ms, solve {rec8c['ms']:.3f} ms; selfcal {sc['kf_s']:.1f} kf/s "
        f"({sc['ms_iter']:.1f} ms per iteration, {sc['iters']} iterations); "
        f"vicalib solve_once "
        + ", ".join(f"{x['secs']:.2f} s" for x in vc["stages"])
        + f"; GPS batch {gb['kf_s']:.1f} kf/s ({gb['ms_iter']:.1f} ms per "
        f"iteration), GPS stream {gs['poses_s']:.3f} poses retired/s "
        f"({gs['ms_push']:.1f} ms per push); K5b "
        f"{rec5b['flagship']['device_ms']:.4f} / "
        f"{rec5b['gps batch']['device_ms']:.4f} ms on the device (flagship "
        f"/ GPS band); CG selfcal GN {csc['ms_iter']:.1f} ms per iteration "
        f"(PCG iterations {csc['cg_iters']}); vins_csv ATE "
        f"{vcsv['ate_m'] * 100:.4f} cm ({vcsv['ms_iter']:.1f} ms per "
        f"iteration); selfcal and vicalib phases {t_new:.1f} s; GPS and "
        f"K5b phases {t_gps:.1f} s; CG selfcal, vins_csv and math_test "
        f"phases {t_slice:.1f} s; camera phases {t_cam:.1f} s ("
        + ", ".join(f"{v} GN {cs[v]['gn_ms_iter']:.1f} / dogleg "
                    f"{cs[v]['dogleg_ms_iter']:.1f} ms per iteration"
                    for v in CAMERA_SCENES)
        + f"; vicalib poly3 solve_once "
        + ", ".join(f"{x['secs']:.2f} s" for x in vp["stages"])
        + f"); total smoke "
        f"{time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
