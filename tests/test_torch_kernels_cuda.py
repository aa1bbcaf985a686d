"""Kernels 1, K2 (imu_preint), segsum, K5 (schur_finish), K5b
(band_to_dense), 6, 7, K8 (chunk_tridiag), 9, 10 and K11 (marginalize)
against their plain versions on the card.

These need an NVIDIA GPU with nvcc (marker `cuda`); elsewhere they skip.
Run them on the card with `python -m pytest tests/test_torch_kernels_cuda.py
-m cuda --noconftest` (the suite's conftest imports jax, which the card's
machine need not have).  Tolerances, relative to max(1, max |plain|): f64
1e-10 (the closed form vs autodiff differ only in roundoff), f32 1e-4 (a
few ulps of f32 through ~10^3 operations); the segment sum is compared to
an f64 sum of the same f32 values at 1e-5 and must be bit-identical between
launches.  Kernel 1 also runs at a row count that is not a multiple of its
32-row blocks; kernel 2 also runs as one grouped launch of seven sums of
flagship shapes, with one segment of 927 rows and one of 2,100.  On the
general assembly path a build's seven sums are one launch that equals the
plain walk of the same plans (f64, 1e-12: the same additions in the same
order, FMA contraction aside), and three f32 slides of the ring run
through both kernels with finite costs that fall.  Kernel 7 (grouped band
Schur correction, with padding W blocks, with its staging forced into
pieces, at lm_size 3 and at band widths above its first version's 48 KB
limit) and kernel 9 (band matvec, at a pose count that is not a multiple
of its 16-pose tiles, B = 1, B = P, D from 1 to 32 and a view off 16
bytes) match their plain versions to 1e-12 (f64) and 1e-5 (f32, the same
products summed in another order), bit-identical between launches (and
kernel 7 with its walk in pieces); a kernel that does not
build raises; three f32 GN iterations of the banded solver run through all
four kernels.  Kernel 6 (the projection rows of the matrix-free Schur
product, and its pack, at lm 0, 1 and 3, with landmarks merged into one of
more rows than a warp's lanes and into one of more rows than a tile's 256)
and kernel 10 (the fleet's scaled Schur system from its W blocks,
with padding W blocks; and random windows at lm 0, 1 and 3, F up to 4,
with masked dims) match their plain versions to 1e-12 (f64) and 1e-5
(f32), bit-identical between launches, Ss exactly symmetric; three f32 GN iterations run on the PCG
solver and on the dense fleet solve.  K2's whitened outputs match the plain
evaluation at pose_dim 9 and 15 within chip_smoke.py's TOL_IMU
allowances, bit-identical between launches, and one IMU evaluation is one
device operation; kernel 1 with the 11 calibration columns
(FOV) and with XYZ landmarks (linear camera) matches its plain version at
kernel 1's tolerances; three f32 GN iterations of a self-calibration scene
launch each kernel once per build and trial.  Kernel 6 and its pack with
a calibration block of K = 5, 6 and 11 columns (records with J_c; the
rows, and each tile's (K,) partial of J_c^T w) match their plain versions
to 1e-12 (f64) and 1e-5 (f32), bit-identical between launches, also with
a landmark longer than a warp; a K the kernel does not cover raises; the
self-calibrating PCG's Schur product on the card matches the CPU's (f64,
1e-12), and three f32 GN iterations of it launch kernel 6's pack once
per build.  K5 (the dense Schur step)
matches its plain version to 1e-10 (f64) and 1e-5 (f32) of max |S|, with
the column mask, cut to the leading rows, at lm 3 and without landmark
columns, S exactly symmetric, on block-banded W whose distant tile pairs
share no landmark (split across a cluster at N = 90, lm 1 and 3, and a
dense calibration block), and a refused launch raises; K11 (the
marginalization prior) to 1e-10 (f64) and 1e-4 (f32: Jacobi and `eigh`
round differently) of ||H||_F at n = 90 to 360, its info flag set, its
output PSD to 1e-6 ||H|| in f32, its PSD certificate settling exactly the
inputs with no eigenvalue below -tau (-0.1 tau in, -10 tau out); both
bit-identical between launches and raising when they do not build; three
steady f32 pushes of the streaming smoother make no host sync.  K5b (band
to dense, also at the GPS band, odd shapes, B > P, D = 6, 15, 40 and 130
and an unaligned view) and K8a (the chunk layout) equal their plain
versions element for element in f32 and f64; K8b and K8c (the chunked factor and solve, by
cyclic reduction with explicit triangular inverses and by the scan) match
their plain versions to 1e-12 (f64) and 1e-4 (f32, the levels' Schur
complements summed in another order), every level's Li, W and V, and x =
S^-1 b the solver's plain `_bcr_solve`, at F = 2 windows, n up to 216 and
padded chunk counts, bit-identical between launches; an indefinite block
clears `ok` on the device; `banded_pcg_solve` on the
card runs K8 and kernel 9 only, with no `torch.linalg` call and no host
read.  Kernel 1 at lm_size 0 (a pose graph) matches its plain version at
kernel 1's tolerances, and the GPS + IMU smoother's app runs its f32 batch
and its f64 stream on the card.  Kernel 1 on chip_smoke.py's camera scenes
(the poly3 and equidistant models, per-pose intrinsics, and a rig of an FOV
and a poly3 camera with landmarks referenced to either), each as built,
with the 11 calibration columns and with XYZ landmarks, matches its plain
version at kernel 1's tolerances, bit-identical between launches, and a
camera model id it does not know raises by name.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import banded_k5, certificate_case

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv

    cfg = BAConfig(pose_dim=9, lm_size=1)
    sim = sv.simulate(n_poses=24, n_lms=96, seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               pad_multiple=3, device="cuda")
    ref = p.lms.ref_pose[p.proj.lm]
    pose = p.proj.pose.clone()
    pose[::7] = ref[::7]                      # same-pose rows
    p = dataclasses.replace(p, proj=dataclasses.replace(p.proj, pose=pose))
    return prepare_landmarks(p, cfg), cfg


def _rel(a, b):
    assert a.shape == b.shape
    if b.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max()) / max(
        1.0, float(b.double().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_kernel_matches_plain(cuda_problem, dtype, tol,
                                           with_jacobians):
    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_problem
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    got = rp.evaluate(p, cfg, with_jacobians)
    want = rp.evaluate_plain(p, cfg, with_jacobians)
    torch.cuda.synchronize()
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_kernel_lm0_matches_plain(cuda_problem, dtype, tol,
                                               with_jacobians):
    """lm_size 0 (a pose graph): each row a world point's (the landmark
    state set to its world point), no landmark columns, same-pose rows
    keep their pose Jacobians; bit-identical relaunch."""
    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_problem
    cfg = dataclasses.replace(cfg, lm_size=0)
    p = dataclasses.replace(p, lms=dataclasses.replace(p.lms, x=p.lms.x_w))
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    got = rp.evaluate(p, cfg, with_jacobians)
    again = rp.evaluate(p, cfg, with_jacobians)
    want = rp.evaluate_plain(p, cfg, with_jacobians)
    torch.cuda.synchronize()
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= tol, name
        assert torch.equal(getattr(got, name), getattr(again, name)), name
    if with_jacobians:
        assert got.j_lm.shape == (p.proj.z.shape[0], 2, 0)
        same = (p.proj.pose == p.lms.ref_pose[p.proj.lm]) & p.proj.valid
        assert float(got.j_meas[same].abs().max()) > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segsum_kernel_matches_plain_and_is_deterministic(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver.assemble import _seg_sum_plain

    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.standard_normal((20000, 36)), dtype=dtype,
                           device="cuda")
    ids = torch.as_tensor(rng.integers(-5, 3077, 20000), device="cuda")
    a = segsum.seg_sum(vals, ids, 3072)
    b = segsum.seg_sum(vals, ids, 3072)
    want = _seg_sum_plain(vals.double(), ids, 3072)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert _rel(a, want) <= (1e-5 if dtype == torch.float32 else 1e-12)


def _cut_rows(p, n):
    """The problem with its first n projection rows."""
    proj = dataclasses.replace(p.proj, **{
        f.name: getattr(p.proj, f.name)[:n].contiguous()
        for f in dataclasses.fields(p.proj)})
    return dataclasses.replace(p, proj=proj)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_kernel_ragged_last_block(cuda_problem, dtype, tol,
                                               with_jacobians):
    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_problem
    nr = p.proj.z.shape[0]
    p = _cut_rows(p, nr - 1 if (nr - 1) % 32 else nr - 5)
    assert p.proj.z.shape[0] % 32
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    got = rp.evaluate(p, cfg, with_jacobians)
    want = rp.evaluate_plain(p, cfg, with_jacobians)
    torch.cuda.synchronize()
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= tol, name


def _skewed_ids(rng, n, nseg, long_rows, oob=False):
    """n ids over nseg segments, uniform but for one segment of
    `long_rows` rows; with `oob`, a tenth of the rows out of range."""
    ids = rng.integers(0, nseg, n)
    ids[rng.choice(n, long_rows, replace=False)] = nseg // 3
    if oob:
        bad = rng.choice(n, n // 10, replace=False)
        ids[bad[::2]] = -1
        ids[bad[1::2]] = nseg + 7
    return torch.as_tensor(ids, device="cuda")


# (rows, k, segments) of the seven sums of the flagship build
FLAGSHIP_SUMS = [(38789, 36, 3072), (19395, 6, 128), (508, 81, 3072),
                 (254, 9, 128), (9696, 1, 497), (9696, 1, 497),
                 (19392, 6, 10188)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segsum_grouped_launch_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver.assemble import _seg_sum_plain

    rng = np.random.default_rng(1)
    cases = []
    for n, k, nseg in FLAGSHIP_SUMS:
        ids = _skewed_ids(rng, n, nseg, min(927, n // 2))
        vals = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype,
                               device="cuda")
        cases.append((vals, ids, nseg))
    groups = [(v, segsum.build_plan(i, n)) for v, i, n in cases]
    before = segsum.seg_sum_grouped.launches
    a = segsum.seg_sum_grouped(groups)
    b = segsum.seg_sum_grouped(groups)
    assert segsum.seg_sum_grouped.launches == before + 2
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for (v, i, n), x, y in zip(cases, a, b):
        assert torch.equal(x, y)
        assert _rel(x, _seg_sum_plain(v.double(), i, n)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segsum_long_segment_and_out_of_range_ids(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver.assemble import _seg_sum_plain

    rng = np.random.default_rng(2)
    ids = _skewed_ids(rng, 30000, 700, 2100, oob=True)
    vals = torch.as_tensor(rng.standard_normal((30000, 9)), dtype=dtype,
                           device="cuda")
    a = segsum.seg_sum(vals, ids, 700)
    b = segsum.seg_sum(vals, ids, 700)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert _rel(a, _seg_sum_plain(vals.double(), ids, 700)) <= (
        1e-5 if dtype == torch.float32 else 1e-12)


def test_general_build_grouped_launch_matches_plan_walk(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = sv.simulate(n_poses=12, n_lms=48, seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               pad_multiple=3, device="cuda")
    p = prepare_landmarks(p, cfg)
    plan = asm.assembly_plan(p, cfg)
    assert plan.band_width == 0
    calls = []
    orig = asm.seg_sum_groups

    def record(groups):
        calls.append([(v.reshape(v.shape[0], -1).contiguous(), sp)
                      for v, sp in groups])
        return orig(groups)

    monkeypatch.setattr(asm, "seg_sum_groups", record)
    before = segsum.seg_sum_grouped.launches
    asm.assemble(p, cfg, imu_eval=step._imu_eval(p, cfg, True, True),
                 plan=plan)
    assert segsum.seg_sum_grouped.launches == before + 1
    (groups,) = calls
    assert len(groups) == 7
    got = segsum.seg_sum_grouped(groups)
    torch.cuda.synchronize()
    for (v, sp), g in zip(groups, got):
        assert _rel(g, segsum.plan_walk(v, sp)) <= 1e-12


def test_ring_three_slides_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.kernels import reprojection, segsum
    from ba_tpu_torch.solver import fixedlag
    from ba_tpu_torch.utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = sv.simulate(n_poses=16, n_lms=64, seed=2)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=3,
                               with_marg_prior=False, device="cuda")
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    sched = fixedlag.build_ring_schedule(prepare_landmarks(p, cfg), cfg, 5,
                                         3)
    k1, k2 = reprojection.reprojection.launches, \
        segsum.seg_sum_grouped.launches
    _, outs = fixedlag.run_ring(sched, cfg, True, 2)
    costs = outs["cost"].cpu()
    assert bool(torch.isfinite(costs).all())
    assert float(costs[-1]) < float(costs[0]), costs
    assert reprojection.reprojection.launches - k1 == 3 * 5
    assert segsum.seg_sum_grouped.launches - k2 == 3 * 3


@pytest.fixture(scope="module")
def cuda_band_problem():
    """A 48-pose f64 problem on the card with its block system (banded
    solver config, no marginalization prior)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.solver.assemble import band_width_of

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                   use_banded_solver=True)
    sim = sv.simulate(n_poses=48, n_lms=160, seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               with_marg_prior=False, device="cuda")
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
    p = prepare_landmarks(p, cfg)
    bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               with_precond=False)
    return p, cfg, bs


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_band_schur_kernel_matches_plain(cuda_band_problem, dtype, tol):
    """Kernel 7 against its plain version, with padding W blocks
    (landmark id L) that must be dropped; two launches bit-identical, and
    bit-identical with its staging forced into pieces and with its W rows
    gathered through the plan's order (no tile marked consecutive)."""
    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.solver import banded

    p, cfg, bs = cuda_band_problem
    P, B, L = p.poses.q.shape[0], cfg.band_width, p.lms.x.shape[0]
    idx = p.pidx
    pad = 7
    wb_pose = torch.cat([idx.wb_pose, torch.zeros(pad, dtype=torch.int32,
                                                  device="cuda")])
    wb_lm = torch.cat([idx.wb_lm, torch.full((pad,), L, dtype=torch.int32,
                                             device="cuda")])
    Wb = torch.cat([bs.wb, torch.ones((pad, 6, 1), dtype=bs.wb.dtype,
                                      device="cuda")]).to(dtype)
    vinv = bs.vinv.to(dtype)
    plan = k7.schur_plan(wb_pose, wb_lm, P, L, B)
    i_loc, kept = k7.slot_of(wb_pose, wb_lm, L, B)
    assert int(i_loc[kept].max()) == B - 1
    before = k7.band_schur.launches
    a = k7.band_schur(Wb, vinv, plan, P)
    b = k7.band_schur(Wb, vinv, plan, P)
    c = k7.band_schur(Wb, vinv, plan, P, caps=(5, 11))
    assert bool((plan.tile_src >= 0).all())
    gathered = plan._replace(tile_src=torch.full_like(plan.tile_src, -1))
    g = k7.band_schur(Wb, vinv, gathered, P)
    assert k7.band_schur.launches == before + 4
    want = banded.band_schur_plain(wb_pose, wb_lm, Wb.double(),
                                   vinv.double(), P, B)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, c)
    assert torch.equal(a, g)
    assert _rel(a, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_band_schur_kernel_xyz_landmarks(dtype, tol):
    """Kernel 7 at lm_size 3 (XYZ landmarks, a 48-pose build) against its
    plain version; bit-identical relaunch and piecewise walk."""
    from chip_smoke import xyz_band_case

    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.solver import banded

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, cfg, bs = xyz_band_case()
    P, B, L = p.poses.q.shape[0], cfg.band_width, p.lms.x.shape[0]
    idx = p.pidx
    assert bs.wb.shape[2] == 3
    plan = k7.schur_plan(idx.wb_pose, idx.wb_lm, P, L, B)
    Wb, vinv = bs.wb.to(dtype), bs.vinv.to(dtype)
    a = k7.band_schur(Wb, vinv, plan, P)
    b = k7.band_schur(Wb, vinv, plan, P)
    c = k7.band_schur(Wb, vinv, plan, P, caps=(7, 13))
    want = banded.band_schur_plain(idx.wb_pose, idx.wb_lm, Wb.double(),
                                   vinv.double(), P, B)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, c)
    assert _rel(a, want) <= tol


@pytest.mark.parametrize("dtype,tol,width", [(torch.float64, 1e-12, 960),
                                             (torch.float32, 1e-5, 1800)])
def test_band_schur_kernel_wide_band(cuda_band_problem, dtype, tol, width):
    """Kernel 7 at a band width above the first kernel's 48 KB shared
    memory limit ((B + 1) (6 itemsize + 4) bytes): its band equals the
    plain correction at the problem's own width, and is zero beyond it
    (no landmark spans more poses).  The plain version's (P, B^2 36)
    grid cannot be formed at this width."""
    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.solver import banded

    p, cfg, bs = cuda_band_problem
    P, B, L = p.poses.q.shape[0], cfg.band_width, p.lms.x.shape[0]
    assert (width + 1) * (6 * torch.tensor([], dtype=dtype).element_size()
                          + 4) > 48 * 1024
    idx = p.pidx
    Wb, vinv = bs.wb.to(dtype), bs.vinv.to(dtype)
    wide = k7.schur_plan(idx.wb_pose, idx.wb_lm, P, L, width)
    a = k7.band_schur(Wb, vinv, wide, P)
    b = k7.band_schur(Wb, vinv, wide, P)
    want = banded.band_schur_plain(idx.wb_pose, idx.wb_lm, Wb.double(),
                                   vinv.double(), P, B)
    torch.cuda.synchronize()
    assert a.shape == (P, width, 6, 6)
    assert torch.equal(a, b)
    assert _rel(a[:, :B], want) <= tol
    assert not bool(a[:, B:].any())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("P,B,D", [(1003, 24, 9), (2048, 24, 9), (37, 37, 6),
                                   (64, 1, 15), (300, 40, 9), (40, 40, 32),
                                   (200, 50, 1)])
def test_band_matvec_kernel_matches_plain(dtype, tol, P, B, D):
    """Kernel 9 against its plain version: a pose count that is not a
    multiple of its 16-pose tiles, B = 1, B = P, a band wider than a tile
    (rows in several pieces), D from 1 to 32; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import band_matvec as k9
    from ba_tpu_torch.solver import banded

    rng = np.random.default_rng(P + B)
    band = rng.standard_normal((P, B, D, D))
    band[:, 0] = band[:, 0] + np.swapaxes(band[:, 0], 1, 2)
    band = torch.as_tensor(band, dtype=dtype, device="cuda")
    x = torch.as_tensor(rng.standard_normal(P * D), dtype=dtype,
                        device="cuda")
    before = k9.band_matvec.launches
    a = banded.band_matvec(band, x)
    b = banded.band_matvec(band, x)
    assert k9.band_matvec.launches == before + 2
    want = banded.band_matvec_plain(band.double(), x.double())
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert _rel(a, want) <= tol


def test_band_matvec_kernel_view_off_16_bytes():
    """Kernel 9 on a band view that starts off a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.solver import banded

    rng = np.random.default_rng(3)
    full = torch.as_tensor(rng.standard_normal((41, 5, 3, 3)),
                           dtype=torch.float32, device="cuda")
    band = full[1:]             # 5 * 9 * 4 = 180 bytes in
    assert band.data_ptr() % 16
    x = torch.as_tensor(rng.standard_normal(40 * 3), dtype=torch.float32,
                        device="cuda")
    a = banded.band_matvec(band, x)
    want = banded.band_matvec_plain(band.double(), x.double())
    torch.cuda.synchronize()
    assert _rel(a, want) <= 1e-5


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """A kernel that does not build raises on CUDA tensors; no wrapper
    gives way to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.kernels import build
    from ba_tpu_torch.solver import banded

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    band = torch.ones((8, 2, 3, 3), device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        banded.band_matvec(band, torch.ones(24, device="cuda"))
    wb_pose = torch.arange(8, dtype=torch.int32, device="cuda")
    wb_lm = torch.zeros(8, dtype=torch.int32, device="cuda")
    plan = k7.schur_plan(wb_pose, wb_lm, 8, 1, 8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k7.band_schur(torch.ones((8, 6, 1), device="cuda"),
                      torch.ones((1, 1, 1), device="cuda"), plan, 8)


@pytest.mark.parametrize("grouped", [True, False])
def test_banded_gn_f32_on_the_card(cuda_band_problem, monkeypatch, grouped):
    """Three f32 GN iterations of the banded solver through kernels 1, 2,
    7 (grouped form forced) and 9: finite costs that fall, and the
    launches per build."""
    from ba_tpu_torch.kernels import band_matvec as k9
    from ba_tpu_torch.kernels import band_schur as k7
    from ba_tpu_torch.solver import banded, step
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg, _ = cuda_band_problem
    if grouped:
        monkeypatch.setattr(banded, "_GROUPED_SP_MIN", 0)
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    n7, n9 = k7.band_schur.launches, k9.band_matvec.launches
    _, costs, _ = step.solve_fixed(p, cfg, True, 3)
    costs = costs.cpu()
    assert bool(torch.isfinite(costs).all())
    assert float(costs[-1]) < float(costs[0]), costs
    assert k7.band_schur.launches - n7 == (3 if grouped else 0)
    assert k9.band_matvec.launches - n9 == 3 * 4


def _k6_system(cuda_band_problem, lm):
    """(problem, config, block system) of the 48-pose build with landmarks
    of lm columns (lm 0 keeps the lm 1 blocks: kernel 1 has no lm 0)."""
    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.solver import cg, step

    p, cfg, bs = cuda_band_problem
    if lm == 3:
        cfg = dataclasses.replace(cfg, lm_size=3)
        p = prepare_landmarks(p, cfg)
        bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True,
                                                          True),
                                   with_precond=False)
    return p, cfg, bs


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("lm,merged", [(1, 0), (1, 8), (1, 48), (3, 0),
                                       (3, 8), (0, 0)])
def test_schur_matvec_kernel_matches_plain(cuda_band_problem, dtype, tol,
                                           lm, merged):
    """Kernel 6 and its pack against their plain versions on the 48-pose
    build, at lm 1, 3 and 0, and with the rows of the first `merged`
    landmarks given to landmark 0 (8: more rows than a warp's lanes; 48: a
    tile of more than 256 rows, walked in chunks); the pack equal element
    for element, the rows within `tol`, two launches bit-identical; summed
    by pose, the rows equal the row-order route's (`schur_matvec_plain`)."""
    from ba_tpu_torch.kernels import schur_matvec as k6

    p, cfg, bs = _k6_system(cuda_band_problem, lm)
    P, D = p.poses.q.shape[0], cfg.pose_dim
    pj = bs.pj
    lmid = torch.where(pj.lm < merged, 0, pj.lm)
    plan = k6.schur_plan(pj.pose, pj.ref, lmid, bs.vinv.shape[0])
    longest = int(torch.bincount(lmid).max())
    assert longest > {0: 0, 8: 32, 48: k6.ROWS}[merged]
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(P * D),
                        dtype=dtype, device="cuda")
    args = [t.to(dtype) for t in (pj.j_m, pj.j_r, pj.j_l)]
    vinv = bs.vinv.to(dtype)
    n_pack, n_mv = k6.schur_pack.launches, k6.schur_matvec.launches
    pack = k6.schur_pack(*args, plan, lm)
    a = k6.schur_matvec(pack, plan, vinv, x, D)
    b = k6.schur_matvec(pack, plan, vinv, x, D)
    assert (k6.schur_pack.launches - n_pack,
            k6.schur_matvec.launches - n_mv) == (1, 2)
    want_pack = k6.schur_pack_plain(*args, plan, lm)
    want = k6.schur_matvec_sorted_plain(
        k6.schur_pack_plain(*[t.double() for t in args], plan, lm), plan,
        vinv.double(), x.double(), D)
    jl = args[2] if lm else torch.zeros_like(args[2])
    rows = k6.schur_matvec_plain(args[0].double(), args[1].double(),
                                 jl.double(), pj.pose, pj.ref, lmid,
                                 vinv.double(), x.double(), D)
    torch.cuda.synchronize()
    assert torch.equal(pack.rows, want_pack.rows)
    assert torch.equal(a, b)
    assert _rel(a, want) <= tol
    by_pose = torch.zeros((P, 6), dtype=torch.float64, device="cuda")
    by_pose.index_add_(0, plan.out_pose, a.double().reshape(-1, 6))
    want_pose = torch.zeros_like(by_pose).index_add_(
        0, torch.cat([pj.pose, pj.ref]), rows)
    assert _rel(by_pose, want_pose) <= tol


@pytest.fixture(scope="module")
def cuda_fleet():
    """A fused f64 fleet of two 24-pose windows on the card with its block
    system and dense fleet plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import (BAConfig, concat_problems,
                                           prepare_landmarks)
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.solver.assemble import band_width_of

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = sv.simulate(n_poses=24, n_lms=80, seed=0)
    ws = [sv.build_problem(sim, cfg, perturb=0.01, seed=s, device="cuda")[0]
          for s in (1, 2)]
    p = concat_problems(ws, cfg)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p),
                              use_banded_solver=True, fleet_size=2)
    p = prepare_landmarks(p, cfg)
    assert step._reduced_path(p, cfg)[0] == "fleet_dense"
    plan = step.solve_plan(p, cfg)
    bs, _ = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               with_precond=False, plan=plan)
    return p, cfg, bs, plan


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_fleet_schur_kernel_matches_plain(cuda_fleet, dtype, tol):
    """Kernel 10 on the fleet's W blocks, with padding W blocks (landmark
    id L) that the plan drops, against `fleet_schur_plain` on the lower
    triangle; Ss exactly symmetric, two launches bit-identical, one call
    counted each."""
    from ba_tpu_torch.kernels import fleet_schur as k10
    from ba_tpu_torch.solver import banded

    p, cfg, bs, plan = cuda_fleet
    P, L, D, F = p.poses.q.shape[0], p.lms.x.shape[0], cfg.pose_dim, 2
    idx = p.pidx
    pad = 5
    wb_pose = torch.cat([idx.wb_pose, torch.arange(
        pad, dtype=torch.int32, device="cuda")])
    wb_lm = torch.cat([idx.wb_lm, torch.full((pad,), L, dtype=torch.int32,
                                             device="cuda")])
    Wb = torch.cat([bs.wb, torch.ones((pad, 6, 1), dtype=bs.wb.dtype,
                                      device="cuda")]).to(dtype)
    vinv = bs.vinv.to(dtype)
    table = k10.fleet_plan(wb_pose, wb_lm, P, L, F)
    band = banded.fleet_band(bs, cfg, P, D, plan.fleet).to(dtype)
    eps = 1e-8 if dtype == torch.float64 else 1e-4
    before = k10.fleet_schur.launches
    x = k10.fleet_schur(Wb, vinv, table, band, F, eps)
    y = k10.fleet_schur(Wb, vinv, table, band, F, eps)
    assert k10.fleet_schur.launches == before + 2
    want = k10.fleet_schur_plain(Wb.double(), vinv.double(), wb_pose, wb_lm,
                                 band.double(), F, eps)
    torch.cuda.synchronize()
    assert torch.equal(x[0], x[0].mT)
    # on the lower triangle, which the Cholesky reads: the plain version's
    # upper one keeps the band's diagonal blocks' rounding asymmetry
    for g, h, w in zip((torch.tril(x[0]), x[1]), (torch.tril(y[0]), y[1]),
                       (torch.tril(want[0]), want[1])):
        assert torch.equal(g, h)
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("F,lm", [(1, 1), (2, 3), (4, 1), (4, 3), (2, 0)])
def test_fleet_schur_kernel_windows_lm_and_masked_dims(dtype, tol, F, lm):
    """Kernel 10 on random windows whose distant tile pairs share no
    landmark, with masked dims and padding blocks, at lm 0, 1 and 3 and
    F = 1, 2 and 4, against its plain version."""
    from chip_smoke import fleet_inputs

    from ba_tpu_torch.kernels import fleet_schur as k10

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wb, vinv, wb_pose, wb_lm, band = fleet_inputs(F, max(lm, 1),
                                                  device="cuda")
    if lm == 0:
        wb, vinv = wb[:, :, :0], vinv[:, :0, :0]
    P, L = band.shape[0], vinv.shape[0]
    table = k10.fleet_plan(wb_pose, wb_lm, P, L, F)
    x = k10.fleet_schur(wb.to(dtype).contiguous(),
                        vinv.to(dtype).contiguous(), table, band.to(dtype),
                        F, 1e-8)
    y = k10.fleet_schur(wb.to(dtype).contiguous(),
                        vinv.to(dtype).contiguous(), table, band.to(dtype),
                        F, 1e-8)
    want = k10.fleet_schur_plain(wb, vinv, wb_pose, wb_lm, band, F, 1e-8)
    torch.cuda.synchronize()
    assert torch.equal(x[0], x[0].mT)
    for g, h, w in zip(x, y, want):
        assert torch.equal(g, h)
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("path", ["cg", "fleet_dense"])
def test_cg_and_fleet_gn_f32_on_the_card(cuda_band_problem, cuda_fleet,
                                         path):
    """Three f32 GN iterations on the matrix-free PCG solver (kernels 1, 2,
    6) and on the dense fleet solve (kernels 1, 2, 10): finite costs that
    fall, and the launches per build."""
    from ba_tpu_torch.kernels import fleet_schur as k10
    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.utils.tree import tree_map

    if path == "cg":
        p, cfg, _ = cuda_band_problem
        cfg = dataclasses.replace(cfg, use_banded_solver=False,
                                  use_cg_solver=True, cg_tolerance=1e-5)
    else:
        p, cfg, _, _ = cuda_fleet
    assert step._reduced_path(p, cfg)[0] == path
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    matvecs = []
    orig = cg.pcg_solve

    def record(*a, **k):
        res = orig(*a, **k)
        matvecs.append(res.matvecs)
        return res

    n6, n10 = k6.schur_matvec.launches, k10.fleet_schur.launches
    n_pack = k6.schur_pack.launches
    cg.pcg_solve = record
    try:
        _, costs, _ = step.solve_fixed(p, cfg, True, 3)
    finally:
        cg.pcg_solve = orig
    costs = costs.cpu()
    assert bool(torch.isfinite(costs).all())
    assert float(costs[-1]) < float(costs[0]), costs
    assert k6.schur_matvec.launches - n6 == sum(matvecs)
    assert len(matvecs) == (3 if path == "cg" else 0)
    assert k6.schur_pack.launches - n_pack == len(matvecs)
    assert k10.fleet_schur.launches - n10 == (3 if path == "fleet_dense"
                                             else 0)


# ---------------------------------------------------------------------------
# K2 (imu_preint) and kernel 1's self-calibration and XYZ variants

@pytest.fixture(scope="module")
def cuda_selfcal():
    """A noiseless <R,1,15,5,true> scene on the card (FOV camera, moved
    intrinsics and T_vs), prepared, and its config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core import lie
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv

    cfg = BAConfig(pose_dim=15, lm_size=1, calib_size=5, do_tvs=True,
                   tvs_translation_staging=True, tvs_translation_active=False)
    sim = sv.simulate(n_poses=12, n_lms=80, seed=13)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=14,
                               device="cuda")
    params = p.rig.params.clone()
    params[0, :5] += torch.tensor([2.0, -2.0, 3.0, -2.0, 0.01],
                                  dtype=params.dtype, device="cuda")
    dq = lie.so3_exp(params.new_tensor([0.01, -0.008, 0.012]))
    rig = dataclasses.replace(
        p.rig, params=params, tvs_q=lie.quat_mul(p.rig.tvs_q[0], dq)[None],
        tvs_t=p.rig.tvs_t + params.new_tensor([[0.01, -0.02, 0.015]]))
    b = p.poses.b + 0.01 * torch.arange(6, dtype=params.dtype,
                                        device="cuda")
    p = dataclasses.replace(p, rig=rig,
                            poses=dataclasses.replace(p.poses, b=b))
    return prepare_landmarks(p, cfg), cfg


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pose_dim", [9, 15])
def test_imu_preint_kernels_match_plain(cuda_selfcal, dtype, pose_dim):
    """K2's whitened outputs against the plain evaluation, with Jacobians
    ((a)), without them from a given C9 ((b)) and without one ((a) then
    (b)), within chip_smoke.py's TOL_IMU allowances; bit-identical between
    launches."""
    p, cfg = cuda_selfcal
    cfg = dataclasses.replace(cfg, pose_dim=pose_dim)
    _check_imu_against_plain(p, cfg, dtype)


def _check_imu_against_plain(p, cfg, dtype):
    from chip_smoke import _imu_allowance

    from ba_tpu_torch.core.residuals import imu
    from ba_tpu_torch.utils.tree import tree_map

    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    dt = str(dtype).replace("torch.", "")
    c9 = imu.evaluate_plain(p, cfg, True).c9
    for args in ((True,), (False, c9), (False,)):
        got = imu.evaluate(p, cfg, *args)
        again = imu.evaluate(p, cfg, *args)
        want = imu.evaluate_plain(p, cfg, *args)
        torch.cuda.synchronize()
        allow = _imu_allowance(p, cfg, want, dt)
        for name in want._fields:
            g, w = getattr(got, name), getattr(want, name)
            assert torch.equal(g, getattr(again, name)), name
            lim = torch.as_tensor(allow[name], dtype=torch.float64,
                                  device=g.device)
            assert bool(((g.double() - w.double()).abs() <= lim).all()), \
                (args[0], name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("imu_per_span", [100, 200])
def test_imu_preint_long_spans_match_plain(dtype, imu_per_span):
    """K2 on spans of 101 and 201 slots, seven and thirteen of (a)'s
    16-step chunks, against the plain evaluation as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import long_span_problem

    p, cfg = long_span_problem(imu_per_span)
    assert p.imu.time.shape[1] == imu_per_span + 1
    _check_imu_against_plain(p, cfg, dtype)


@pytest.mark.parametrize("with_jacobians", [True, False])
def test_imu_evaluation_is_one_launch(cuda_selfcal, with_jacobians):
    """One IMU evaluation on the card is one device operation: K2, with
    the whitening in its epilogue."""
    from chip_smoke import _device_ops

    from ba_tpu_torch.core.residuals import imu
    from ba_tpu_torch.kernels import imu_preint

    p, cfg = cuda_selfcal
    c9 = imu.evaluate(p, cfg, True).c9
    args = (True,) if with_jacobians else (False, c9)
    n = (imu_preint.imu_full.launches, imu_preint.imu_residual.launches)
    imu.evaluate(p, cfg, *args)
    moved = (imu_preint.imu_full.launches - n[0],
             imu_preint.imu_residual.launches - n[1])
    assert moved == ((1, 0) if with_jacobians else (0, 1))
    assert _device_ops(lambda: imu.evaluate(p, cfg, *args)) == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", ["calib_fov", "xyz_linear"])
@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_calibration_and_xyz_match_plain(
        cuda_selfcal, dtype, tol, case, with_jacobians):
    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_selfcal
    if case == "xyz_linear":
        cfg = dataclasses.replace(cfg, lm_size=3)
        rig = dataclasses.replace(p.rig, model=torch.zeros_like(p.rig.model))
        p = prepare_landmarks(dataclasses.replace(p, rig=rig), cfg)
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    got = rp.evaluate(p, cfg, with_jacobians)
    want = rp.evaluate_plain(p, cfg, with_jacobians)
    torch.cuda.synchronize()
    if with_jacobians:
        assert got.j_cal.shape[-1] == 11
        assert got.j_lm.shape[-1] == cfg.lm_size
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= tol, name


# ---------------------------------------------------------------------------
# Kernel 1 for every camera model

@pytest.fixture(scope="module")
def cuda_cameras():
    """{variant: (prepared f64 problem, config)} of chip_smoke.py's camera
    scenes on simulate(24 poses, 96 landmarks) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import CAMERA_SCENES, camera_scene

    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv

    sim = sv.simulate(n_poses=24, n_lms=96, seed=0)
    out = {}
    for variant in CAMERA_SCENES:
        p, cfg = camera_scene(sim, variant, device="cuda")
        out[variant] = (prepare_landmarks(p, cfg), cfg)
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("variant", ["poly3", "equidistant", "per_pose",
                                     "rig"])
@pytest.mark.parametrize("combo", ["", " K=11", " lm_size 3"])
@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_camera_models_match_plain(cuda_cameras, dtype, tol,
                                                variant, combo,
                                                with_jacobians):
    """Kernel 1 on each camera scene as built, with the calibration
    columns of camera 0 (K = 11, its intrinsics moved) and with XYZ
    landmarks, against its plain version; one launch each, bit-identical
    between launches."""
    from chip_smoke import k1_combos

    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.kernels import reprojection
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_cameras[variant]
    (q, c), = [(q, c) for label, q, c in k1_combos(p, cfg) if label == combo]
    q = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, q)
    n = reprojection.reprojection.launches
    got = rp.evaluate(q, c, with_jacobians)
    assert reprojection.reprojection.launches == n + 1
    again = rp.evaluate(q, c, with_jacobians)
    want = rp.evaluate_plain(q, c, with_jacobians)
    torch.cuda.synchronize()
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(again, name)), name
        assert _rel(getattr(got, name), getattr(want, name)) <= tol, name


def test_reprojection_kernel_refuses_unknown_model(cuda_problem):
    from ba_tpu_torch.core.residuals import reprojection as rp

    p, cfg = cuda_problem
    rig = dataclasses.replace(p.rig, model=torch.full_like(p.rig.model, 4))
    with pytest.raises(NotImplementedError, match=r"\[4\]"):
        rp.evaluate(dataclasses.replace(p, rig=rig), cfg)


def test_selfcal_gn_f32_on_the_card(cuda_selfcal):
    from ba_tpu_torch.kernels import imu_preint, reprojection
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_selfcal
    p = tree_map(lambda a: a.float() if a.is_floating_point() else a, p)
    cfg = dataclasses.replace(cfg, use_dogleg=False)
    cost0 = float(step._cost(p, cfg, True))
    k1, ka, kb = (reprojection.reprojection.launches,
                  imu_preint.imu_full.launches,
                  imu_preint.imu_residual.launches)
    q, costs, _ = step.solve_fixed(p, cfg, True, 3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(costs).all())
    assert float(costs[-1]) < cost0
    assert reprojection.reprojection.launches - k1 == 6
    assert imu_preint.imu_full.launches - ka == 3
    assert imu_preint.imu_residual.launches - kb == 3


# kernel 6 with the calibration columns: K -> (calib_size, do_tvs)
K6_CALIB = {5: (5, False), 6: (0, True), 11: (5, True)}


def _k6_calib_system(cuda_selfcal, K, dtype=None, device="cuda"):
    """(problem, config, block system with kernel 6's plans) of the
    self-calibration scene with a calibration block of K columns (the
    T_vs translation free), on the CG path."""
    from ba_tpu_torch.solver import cg, step
    from ba_tpu_torch.utils.tree import tree_map

    p, cfg = cuda_selfcal
    calib_size, do_tvs = K6_CALIB[K]
    cfg = dataclasses.replace(cfg, calib_size=calib_size, do_tvs=do_tvs,
                              tvs_translation_staging=False,
                              use_cg_solver=True, use_dogleg=False)
    p = tree_map(lambda a: a.to(device=device, dtype=dtype or a.dtype)
                 if a.is_floating_point() else a.to(device), p)
    plan = cg.block_plan(p, cfg, schur=True)
    bs, H = cg.assemble_blocks(p, cfg, step._imu_eval(p, cfg, True, True),
                               plan=plan)
    return p, cfg, bs, H


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("K", sorted(K6_CALIB))
@pytest.mark.parametrize("merged", [0, 8])
def test_schur_matvec_kernel_calibration_columns(cuda_selfcal, dtype, tol,
                                                 K, merged):
    """Kernel 6 and its pack with K calibration columns against their
    plain versions: the pack equal element for element, the rows and the
    tiles' partials within `tol` of the sorted plain version, both
    bit-identical between launches; the rows summed by pose and the
    partials summed against the row-order route (`schur_matvec_plain`)."""
    from ba_tpu_torch.kernels import schur_matvec as k6

    p, cfg, bs, _ = _k6_calib_system(cuda_selfcal, K)
    assert cfg.calib_dim == K and bs.pj.j_c.shape[-1] == K
    P, D = p.poses.q.shape[0], cfg.pose_dim
    pj = bs.pj
    lmid = torch.where(pj.lm < merged, 0, pj.lm)
    plan = k6.schur_plan(pj.pose, pj.ref, lmid, bs.vinv.shape[0])
    if merged:
        assert int(torch.bincount(lmid).max()) > 32
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal(P * D), dtype=dtype,
                        device="cuda")
    xk = torch.as_tensor(rng.standard_normal(K), dtype=dtype, device="cuda")
    args = [t.to(dtype) for t in (pj.j_m, pj.j_r, pj.j_l, pj.j_c)]
    vinv = bs.vinv.to(dtype)
    n_pack, n_mv = k6.schur_pack.launches, k6.schur_matvec.launches
    pack = k6.schur_pack(*args[:3], plan, 1, args[3])
    a, pa = k6.schur_matvec(pack, plan, vinv, x, D, xk=xk)
    b, pb = k6.schur_matvec(pack, plan, vinv, x, D, xk=xk)
    assert (k6.schur_pack.launches - n_pack,
            k6.schur_matvec.launches - n_mv) == (1, 2)
    want_pack = k6.schur_pack_plain(*args[:3], plan, 1, args[3])
    want, want_part = k6.schur_matvec_sorted_plain(
        k6.schur_pack_plain(*[t.double() for t in args[:3]], plan, 1,
                            args[3].double()),
        plan, vinv.double(), x.double(), D, xk.double())
    rows, yk = k6.schur_matvec_plain(
        *[t.double() for t in args[:3]], pj.pose, pj.ref, lmid,
        vinv.double(), x.double(), D, args[3].double(), xk.double())
    torch.cuda.synchronize()
    assert pack.K == K and torch.equal(pack.rows, want_pack.rows)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert pa.shape == (plan.tiles.shape[0] - 1, K)
    assert _rel(a, want) <= tol and _rel(pa, want_part) <= tol
    by_pose = torch.zeros((P, 6), dtype=torch.float64, device="cuda")
    by_pose.index_add_(0, plan.out_pose, a.double().reshape(-1, 6))
    want_pose = torch.zeros_like(by_pose).index_add_(
        0, torch.cat([pj.pose, pj.ref]), rows)
    assert _rel(by_pose, want_pose) <= tol
    assert _rel(pa.double().sum(0), yk) <= tol


def test_schur_matvec_kernel_refuses_other_calibration_widths(
        cuda_selfcal):
    from ba_tpu_torch.kernels import schur_matvec as k6

    p, cfg, bs, _ = _k6_calib_system(cuda_selfcal, 11)
    pj, plan = bs.pj, bs.plan.schur
    with pytest.raises(NotImplementedError, match="calibration"):
        k6.schur_pack(pj.j_m, pj.j_r, pj.j_l, plan, 1, pj.j_c[..., :3])
    x = pj.j_m.new_zeros(p.poses.q.shape[0] * cfg.pose_dim)
    with pytest.raises(NotImplementedError, match="calibration"):
        k6.schur_matvec(k6.SchurPack(bs.pack.rows, 1, 3), plan, bs.vinv, x,
                        cfg.pose_dim, xk=pj.j_m.new_zeros(3))


@pytest.mark.parametrize("K", sorted(K6_CALIB))
def test_cg_selfcal_schur_product_card_against_cpu(cuda_selfcal, K):
    """The self-calibrating PCG's Schur product (pack, kernel 6, segsum
    with the tiles' partials) and one solve_reduced_cg step on the card
    against the same code on the CPU (row order, plain sums), f64."""
    from ba_tpu_torch.solver import cg

    p, cfg, bs, H = _k6_calib_system(cuda_selfcal, K, torch.float64)
    _, _, bc, Hc = _k6_calib_system(cuda_selfcal, K, torch.float64, "cpu")
    P, D = p.poses.q.shape[0], cfg.pose_dim
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        P * D + K))
    got = cg.s_matvec(bs, x.cuda(), P, D, K, 1e-8, H)
    want = cg.s_matvec(bc, x, P, D, K, 1e-8, Hc)
    assert _rel(got.cpu(), want) <= 1e-12
    for name in ("rhs_sc", "minv_cal", "dscale"):
        assert _rel(getattr(bs, name).cpu(), getattr(bc, name)) <= 1e-10
    cfg = dataclasses.replace(cfg, cg_tolerance=1e-10, cg_max_iterations=200)
    a = cg.solve_reduced_cg(bs, H, cfg, P, D, K)
    b = cg.solve_reduced_cg(bc, Hc, cfg, P, D, K)
    assert _rel(a.delta_p.cpu(), b.delta_p) <= 1e-8
    assert _rel(a.delta_l.cpu(), b.delta_l) <= 1e-8


def test_cg_selfcal_gn_f32_on_the_card(cuda_selfcal):
    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import cg, step

    p, cfg, _, _ = _k6_calib_system(cuda_selfcal, 11, torch.float32)
    cost0 = float(step._cost(p, cfg, True))
    matvecs = []
    orig = cg.pcg_solve

    def recording(*a, **k):
        res = orig(*a, **k)
        matvecs.append(res.matvecs)
        return res

    n6, n_pack = k6.schur_matvec.launches, k6.schur_pack.launches
    cg.pcg_solve = recording
    try:
        q, costs, _ = step.solve_fixed(p, cfg, True, 3)
        torch.cuda.synchronize()
    finally:
        cg.pcg_solve = orig
    assert bool(torch.isfinite(costs).all())
    assert float(costs[-1]) < cost0
    assert k6.schur_matvec.launches - n6 == sum(matvecs) > 0
    assert k6.schur_pack.launches - n_pack == len(matvecs) == 3


def _k5_inputs(p, cfg, dtype):
    """(U, W, vinv, rhs_p, rhs_l, cmask) of one general-path build of `p`
    before its Schur step, cast to `dtype`."""
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.utils.linalg import block_diag_inv

    plan = asm.assembly_plan(p, cfg)
    cmask = asm.col_mask(p, cfg)
    c, _ = asm.contribution(p, cfg, step._imu_eval(p, cfg, True, True),
                            cmask, plan)
    c = asm._add(c, asm.marg_contribution(p, cfg, cmask.to(c.U.dtype)))
    U, W, V, rhs_p, rhs_l = (t.to(dtype)
                             for t in (c.U, c.W, c.V, c.rhs_p, c.rhs_l))
    return U, W, block_diag_inv(V), rhs_p, rhs_l, cmask


def _random_k5(N, L, lm, dtype):
    rng = np.random.default_rng(N + L + lm)
    U = rng.standard_normal((N, N))
    W = rng.standard_normal((N, L * lm)) * (rng.random((N, L * lm)) < 0.1)
    Vb = rng.standard_normal((L, lm, lm))
    V = Vb @ np.swapaxes(Vb, 1, 2) + np.eye(lm)
    from ba_tpu_torch.utils.linalg import block_diag_inv

    t = [torch.as_tensor(a, dtype=dtype, device="cuda")
         for a in (U + U.T, W, V, rng.standard_normal(N),
                   rng.standard_normal(L * lm))]
    return t[0], t[1], block_diag_inv(t[2]), t[3], t[4]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_schur_finish_kernel_matches_plain(cuda_problem, dtype, tol):
    """K5 against its plain version relative to max |S|: a build's
    system with its column mask, the leading rows only (marginalize),
    XYZ landmarks (lm 3) and no landmark columns; S exactly symmetric,
    two launches bit-identical."""
    from ba_tpu_torch.kernels import schur_finish as k5

    p, cfg = cuda_problem
    U, W, vinv, rhs_p, rhs_l, cmask = _k5_inputs(p, cfg, dtype)
    N = U.shape[0]
    cases = [((U, W, vinv, rhs_p, rhs_l), dict(cmask=cmask)),
             ((U, W, vinv, rhs_p, rhs_l), dict(n=N - 9)),
             (_random_k5(200, 61, 3, dtype), dict(n=190)),
             ((U, W[:, :0], vinv[:0], rhs_p, rhs_l[:0]),
              dict(cmask=cmask))]
    for args, kw in cases:
        before = k5.schur_finish.launches
        got = k5.schur_finish(*args, **kw)
        again = k5.schur_finish(*args, **kw)
        want = k5.schur_finish_plain(*args, **kw)
        torch.cuda.synchronize()
        assert k5.schur_finish.launches == before + 2
        scale = max(1.0, float(want[0].abs().max()))
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            assert float((g.double() - w.double()).abs().max()) \
                <= tol * scale, kw
        assert torch.equal(got[0], got[0].T)


def _random_departing(n, drop, dtype, seed=0):
    """(S, rhs, pd): an indefinite symmetric system whose Schur complement
    keeps negative eigenvalues for the clip."""
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


def _ring_departing(dtype):
    """(S, rhs, pd) of the marginalization of a ring's first slide."""
    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import fixedlag, window
    from ba_tpu_torch.utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = sv.simulate(n_poses=16, n_lms=64, seed=2)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=3,
                               with_marg_prior=False, device="cuda")
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    sched = fixedlag.build_ring_schedule(prepare_landmarks(p, cfg), cfg,
                                         10, 1)
    slide = fixedlag.slide_problem(sched.carry0,
                                   fixedlag.slide_inputs(sched.inputs, 0),
                                   sched.rig, sched.g_vec, sched.L_w)
    seen = []
    orig = window.prior_step

    def record(S, rhs, pd, eps):
        seen.append((S, rhs, pd))
        return orig(S, rhs, pd, eps)

    window.prior_step = record
    try:
        window.marginalize(slide, cfg, True,
                           torch.arange(10, device="cuda") == 0)
    finally:
        window.prior_step = orig
    return seen[0]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_marginalize_kernel_matches_plain(dtype, tol):
    """K11 against its plain version relative to ||H||_F: a ring slide's
    departing system (n = 90), random indefinite ones with clipped
    eigenvalues at n = 90, 91 (odd), 150 (A and V outside shared memory in
    f64) and 360 (vins_window's n; outside in both), one and several
    departing poses; info says converged and finite, the prior is PSD to
    1e-6 ||H|| in f32, H exactly symmetric, relaunches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import marginalize as k11

    eps = 1e-9 if dtype == torch.float64 else 1e-5
    cases = [_ring_departing(dtype),
             _random_departing(90, range(9), dtype),
             _random_departing(91, list(range(9, 27)) + [90], dtype, 1),
             _random_departing(150, range(60, 75), dtype, 2),
             _random_departing(360, range(351, 360), dtype, 3)]
    for S, rhs, pd in cases:
        H, g, info = k11.marginalize_prior(S, rhs, pd, eps)
        H2, g2, info2 = k11.marginalize_prior(S, rhs, pd, eps)
        Hp, gp = k11.marginalize_prior_plain(S, rhs, pd, eps)
        torch.cuda.synchronize()
        n = S.shape[0]
        inf = dict(zip(k11.INFO, info.tolist()))
        assert inf["ok"] == 1 and inf["departing"] == int(pd.sum()), inf
        assert torch.equal(H, H2) and torch.equal(g, g2) \
            and torch.equal(info, info2)
        assert torch.equal(H, H.T)
        norm = float(torch.linalg.matrix_norm(Hp.double()))
        assert float((H.double() - Hp.double()).abs().max()) <= tol * norm, n
        assert float((g.double() - gp.double()).abs().max()) \
            <= tol * max(1.0, float(gp.double().abs().max())), n
        lo = float(torch.linalg.eigvalsh(H.double()).min())
        assert lo >= -(1e-12 if dtype == torch.float64 else 1e-6) * norm, n


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("P,L,lm,dense_rows,cut", [
    (10, 448, 1, 0, 0),      # the slide's shape: 32-row tiles, split
    (10, 150, 3, 0, 0),      # lm 3 at the slide's split
    (10, 448, 1, 0, 9),      # the marginalization's leading rows
    (40, 120, 1, 0, 0),      # n = 360: 32-row tiles, unsplit
    (128, 497, 1, 0, 0),     # the flagship's shape: 64-row tiles
    (128, 497, 1, 11, 0)])   # the self-calibration's dense rows
def test_schur_finish_kernel_skips_empty_tile_pairs(dtype, tol, P, L, lm,
                                                    dense_rows, cut):
    """K5 on block-banded W (many tile pairs with no common landmark)
    against its plain version relative to max |S|, split across a cluster
    (N = 90) and not, lm 1 and 3, in f32 and f64, with and without the
    column mask; S exactly symmetric, relaunches bit-identical, and U
    given as a transposed view (read through its strides) the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import schur_finish as k5

    args = banded_k5(P, 9, L, lm, dtype, dense_rows)
    N = args[0].shape[0]
    n = N - cut
    masks = (None, torch.arange(n, device="cuda") % 7 != 3)
    for cmask in masks:
        got = k5.schur_finish(*args, cmask=cmask, n=n)
        again = k5.schur_finish(*args, cmask=cmask, n=n)
        want = k5.schur_finish_plain(*args, cmask=cmask, n=n)
        torch.cuda.synchronize()
        scale = max(1.0, float(want[0].abs().max()))
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            assert float((g.double() - w.double()).abs().max()) \
                <= tol * scale, (N, L, lm)
        assert torch.equal(got[0], got[0].T)
        # U read through its strides: a transposed view gives the same bits
        Ut = args[0].T.contiguous().T
        assert not Ut.is_contiguous()
        viewed = k5.schur_finish(Ut, *args[1:], cmask=cmask, n=n)
        assert all(torch.equal(g, v) for g, v in zip(got, viewed))


@pytest.mark.parametrize("n,L,lm,tile,split", [
    (90, 448, 1, 32, True),        # the slide: 32-row tiles, split
    (90, 150, 3, 32, True),        # lm 3 at the slide's split
    (1152, 497, 1, 64, False)])    # the flagship: 64-row tiles fill the SMs
def test_schur_finish_schedule_splits_only_when_tiles_leave_sms_idle(
        n, L, lm, tile, split):
    """The schedule the launch takes, as csrc/schur_finish.cu reports it:
    the tile size and whether the walk is split across a cluster (of at
    most 8 blocks, one per tile alone when unsplit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import schur_finish as k5

    t, cs = k5.schedule(n, L, lm)
    assert t == tile and (cs > 1) == split and 1 <= cs <= 8


def test_schur_finish_refused_cluster_launch_raises(monkeypatch):
    """A launch the card refuses (here a stand-in returning
    cudaErrorInvalidClusterSize, 912) raises and is not counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import schur_finish as k5

    args = banded_k5(10, 9, 448, 1, torch.float32)
    monkeypatch.setattr(k5, "_fn", lambda dtype: (lambda *a: 912))
    before = k5.schur_finish.launches
    with pytest.raises(RuntimeError, match="CUDA error 912"):
        k5.schur_finish(*args)
    assert k5.schur_finish.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("family,n,certifies", [
    ("gauge", 90, {torch.float64: True}),
    ("psd", 90, {torch.float64: True, torch.float32: True}),
    ("neg_in", 90, {torch.float64: True, torch.float32: True}),
    ("neg_out", 90, {torch.float64: False, torch.float32: False}),
    ("psd", 360, {torch.float64: True}),     # the factor's first columns
                                             # in the workspace
    ("indefinite", 168, {torch.float64: False, torch.float32: False}),
    ("indefinite", 169, {torch.float64: False, torch.float32: False})])
def test_marginalize_kernel_certificate(dtype, tol, family, n, certifies):
    """K11's branch: the certificate settles a PSD prior (a singular kept
    block with masked dims in f64; one eigenvalue at -0.1 tau) with no
    sweep, and hands one at -10 tau or an indefinite prior to the Jacobi
    clip (A and V in shared memory at n = 168 in f32, in the workspace at
    169); against the plain version relative to ||H||_F, PSD to 1e-6
    ||H|| in f32, symmetric, relaunches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import marginalize as k11

    S, rhs, pd = certificate_case(family, n, dtype)
    eps = 1e-9 if dtype == torch.float64 else 1e-5
    H, g, info = k11.marginalize_prior(S, rhs, pd, eps)
    H2, g2, info2 = k11.marginalize_prior(S, rhs, pd, eps)
    Hp, gp = k11.marginalize_prior_plain(S, rhs, pd, eps)
    torch.cuda.synchronize()
    inf = dict(zip(k11.INFO, info.tolist()))
    assert inf["ok"] == 1 and inf["departing"] == int(pd.sum()), inf
    want = certifies.get(dtype)
    if want is not None:
        assert inf["certified"] == int(want), inf
    if inf["certified"]:
        assert inf["sweeps"] == inf["rotations"] == inf["clipped"] == 0
    else:
        assert inf["clipped"] > 0 and inf["sweeps"] > 0, inf
    assert torch.equal(H, H2) and torch.equal(g, g2) \
        and torch.equal(info, info2)
    assert torch.equal(H, H.T)
    norm = float(torch.linalg.matrix_norm(Hp.double()))
    assert float((H.double() - Hp.double()).abs().max()) <= tol * norm
    assert float((g.double() - gp.double()).abs().max()) \
        <= tol * max(1.0, float(gp.double().abs().max()))
    lo = float(torch.linalg.eigvalsh(H.double()).min())
    assert lo >= -(1e-12 if dtype == torch.float64 else 1e-6) * norm


def test_schur_finish_and_marginalize_build_failure_raises(monkeypatch,
                                                           tmp_path):
    """K5 and K11 raise on CUDA tensors when they do not build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import build
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import window

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    one = torch.ones((4, 4), device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        asm.schur_step(one, torch.ones((4, 2), device="cuda"),
                       torch.ones((2, 1, 1), device="cuda"),
                       torch.ones(4, device="cuda"),
                       torch.ones(2, device="cuda"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        window.prior_step(one, torch.ones(4, device="cuda"),
                          torch.arange(4, device="cuda") < 2, 1e-5)


def test_stream_three_slides_f32_make_no_host_sync():
    """Three steady f32 pushes of the streaming smoother read nothing back
    from the card (PyTorch's sync debug mode raises on a synchronizing
    call), each launching K5 three times (two GN builds and the
    marginalization) and K11 once, and their outputs are finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.apps.vins_stream import (add_keyframe, stream_feed,
                                               stream_problem)
    from ba_tpu_torch.kernels import marginalize as k11
    from ba_tpu_torch.kernels import schur_finish as k5
    from ba_tpu_torch.solver import fixedlag
    from ba_tpu_torch.solver.streaming import RingCapacities, StreamingRing

    problem, cfg, _ = stream_problem(16, 96)
    sched = fixedlag.build_ring_schedule(problem, cfg, 6, 11)
    ring = StreamingRing(cfg, 6, problem.rig, problem.g_vec,
                         RingCapacities.from_schedule(sched), use_imu=True,
                         iters_per_slide=2, dtype=np.float32)
    feed = stream_feed(problem)
    for g in range(7):                   # the first two slides warm up
        add_keyframe(ring, feed, g)
        ring.push(block=False)
    torch.cuda.synchronize()
    a, b = k5.schur_finish.launches, k11.marginalize_prior.launches
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in range(7, 10):
            add_keyframe(ring, feed, g)
            outs.append(ring.push(block=False))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert k5.schur_finish.launches - a == 3 * 3
    assert k11.marginalize_prior.launches - b == 3
    assert all(bool(torch.isfinite(o["t"]).all()) and
               bool(torch.isfinite(o["cost"])) for o in outs)


# ---- K5b (band to dense) and K8 (the chunked block-tridiagonal solver) ---


def _spd_windows(rng, F, P_w, B, D):
    """A band (F P_w, B, D, D) of F windows that do not couple, each the
    blocks of J^T J + 0.1 I over a banded J, diagonal blocks made
    non-symmetric by 1e-3."""
    out = []
    for _ in range(F):
        N = P_w * D
        J = np.zeros((N + B * D, N))
        for p in range(P_w):
            for d in range(min(B, P_w - p)):
                J[p * D:(p + 1) * D, (p + d) * D:(p + d + 1) * D] = \
                    rng.standard_normal((D, D))
        S = J.T @ J + 0.1 * np.eye(N)
        band = np.zeros((P_w, B, D, D))
        for p in range(P_w):
            for d in range(min(B, P_w - p)):
                band[p, d] = S[p * D:(p + 1) * D, (p + d) * D:(p + d + 1) * D]
        band[:, 0] += 1e-3 * rng.standard_normal((P_w, D, D))
        out.append(band)
    return np.concatenate(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("P,B,D", [(128, 24, 9), (37, 5, 6)])
def test_band_to_dense_kernel_matches_plain(dtype, P, B, D):
    """K5b equals its plain version element for element (the diagonal
    blocks are not symmetric, so their rounding order shows), with blocks
    past the last pose ignored; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import band_to_dense as k5b
    from ba_tpu_torch.solver import assemble as asm

    rng = np.random.default_rng(P)
    band = rng.standard_normal((P, B, D, D))
    band = torch.as_tensor(band, dtype=dtype, device="cuda")
    before = k5b.band_to_dense.launches
    a = asm.band_to_dense(band)
    b = asm.band_to_dense(band)
    assert k5b.band_to_dense.launches == before + 2
    want = asm.band_to_dense_plain(band)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("P,B,D,off", [(128, 24, 9, 0), (600, 2, 9, 0),
                                       (7, 3, 9, 0), (5, 8, 9, 0),
                                       (37, 5, 6, 0), (12, 3, 15, 0),
                                       (1, 2, 9, 0), (9, 4, 9, 1),
                                       (6, 3, 40, 0), (3, 2, 130, 0),
                                       (300, 40, 15, 0)],
                         ids=["flagship", "gps", "PD63", "B>P", "D6", "D15",
                              "P1", "view", "D40", "D130", "D15-wide"])
def test_band_to_dense_kernel_shapes(dtype, P, B, D, off):
    """K5b at the flagship's and the GPS batch's bands, P D not a multiple
    of 4 (scalar stores), B > P, D = 6 and 15, P = 1, a band whose data
    starts one element past a 16-byte boundary, two generic D (40 and
    130) and a D = 15 band whose stripe's blocks pass the staging budget
    in f64 (the three read in place, unstaged): equal to its plain version
    element for element, signed zeros in the band, two launches
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import band_to_dense as k5b
    from ba_tpu_torch.solver import assemble as asm

    rng = np.random.default_rng(P * 10 + D)
    flat = rng.standard_normal(P * B * D * D + off)
    flat[::7] = -0.0
    flat[::11] = 0.0
    band = torch.as_tensor(flat, dtype=dtype,
                           device="cuda")[off:].view(P, B, D, D)
    before = k5b.band_to_dense.launches
    a = k5b.band_to_dense(band)
    b = k5b.band_to_dense(band)
    assert k5b.band_to_dense.launches == before + 2
    want = asm.band_to_dense_plain(band)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bcr", [True, False], ids=["bcr", "scan"])
@pytest.mark.parametrize("F,P_w,B,D,chunk", [(2, 23, 4, 9, 5),
                                             (2, 23, 4, 9, 4),
                                             (1, 17, 3, 9, 4),
                                             (1, 30, 5, 6, 6)],
                         ids=["n45", "n36", "n36-B3", "D6"])
def test_chunk_layout_kernel_matches_plain(dtype, bcr, F, P_w, B, D, chunk):
    """K8a equals `jacobi_scaled` + `chunk_system` on the card bit for bit
    (F = 2 windows of 23 poses in chunks of 5: two identity poses per
    window; five chunks, padded to eight under cyclic reduction; chunks of
    4 poses, whose rows the kernel writes 16 bytes a store; a band row of
    B D^2 = 243 values, written one value a store; and D = 6, the generic
    instantiation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import BAConfig
    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    band = torch.as_tensor(_spd_windows(np.random.default_rng(1), F, P_w, B,
                                        D), dtype=dtype, device="cuda")
    cfg = BAConfig(pose_dim=D, lm_size=1, fleet_size=F, banded_chunk=chunk)
    bs_p, sc_p = banded.jacobi_scaled(band)
    Dg_p, Eg_p, *_, n_c = banded.chunk_system(bs_p, cfg, F * P_w, D)
    before = k8.chunk_layout.launches
    bs, sc, Dg, Eg = banded.chunk_layout(band, cfg, F * P_w, D, bcr)
    again = banded.chunk_layout(band, cfg, F * P_w, D, bcr)
    assert k8.chunk_layout.launches == before + 2
    torch.cuda.synchronize()
    m = k8.next_pow2(n_c) if bcr else n_c
    assert Dg.shape == (F, m, chunk * D, chunk * D)
    for got, want in ((bs, bs_p), (sc, sc_p), (Dg[:, :n_c], Dg_p),
                      (Eg[:, :n_c], Eg_p)):
        assert torch.equal(got, want)
    n = chunk * D
    assert torch.equal(Dg[:, n_c:], torch.eye(n, dtype=dtype, device="cuda")
                       .expand(F, m - n_c, n, n))
    assert not bool(Eg[:, n_c:].any())
    assert all(torch.equal(x, y) for x, y in zip(again, (bs, sc, Dg, Eg)))


def _chunk_system(dtype, F, m, chunk, D=9, B=4, seed=0):
    from ba_tpu_torch.core.problem import BAConfig
    from ba_tpu_torch.solver import banded

    band = torch.as_tensor(_spd_windows(np.random.default_rng(seed), F,
                                        m * chunk, B, D), device="cuda")
    cfg = BAConfig(pose_dim=D, lm_size=1, fleet_size=F, banded_chunk=chunk)
    bs, _ = banded.jacobi_scaled(band)
    Dg, Eg = banded.chunk_system(bs, cfg, F * m * chunk, D)[:2]
    b = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
        (F, m, chunk * D)), device="cuda")
    return Dg.to(dtype), Eg.to(dtype), b.to(dtype)


# K8b and K8c against the plain versions, relative to max(1, max |plain|):
# f64 the same factorization summed in another order; f32 through the
# levels' Schur complements of this scaled system, whose f32 factors differ
# by ~1e-6 (measured on a CPU rehearsal at n = 45), with 100x room
TOL_K8 = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("F,m,chunk", [(1, 8, 24), (2, 5, 5), (1, 4, 4),
                                       (1, 11, 24)],
                         ids=["m8-n216", "F2-m5-n45", "m4-n36", "m11-n216"])
def test_bcr_factor_and_solve_kernels_match_plain(dtype, F, m, chunk):
    """K8b's cyclic reduction and K8c's solve against `bcr_factor_plain`
    and `bcr_solve_plain` (every level's Li, W and V, the base Li0, the
    solve, and the kernel's solve on the plain factor) on K8a's padding to
    a power of two with `live` = m, and x = S^-1 b against the solver's
    plain `_bcr_solve`; exact launch counts, bit-identical relaunches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    tol = TOL_K8[dtype]
    Dg, Eg, b = _chunk_system(dtype, F, m, chunk)
    x_p = banded._bcr_solve(banded._bcr_factor(Dg, Eg)[0], b, m)
    # the kernel takes the chunks padded to a power of two, as K8a lays
    # them out
    n, m2 = Dg.shape[-1], k8.next_pow2(m)
    eye = torch.eye(n, dtype=dtype, device="cuda").expand(F, m2 - m, n, n)
    Dg2 = torch.cat([Dg, eye], dim=1)
    Eg2 = torch.cat([Eg, Eg.new_zeros((F, m2 - m, n, n))], dim=1)
    rows = b.reshape(F, m * n)
    lv_p, ok_p = k8.bcr_factor_plain(Dg2, Eg2, live=m)
    x_pn = k8.bcr_solve_plain(lv_p, rows)
    nf, ns = k8.bcr_factor.launches, k8.bcr_solve.launches
    lv_k, ok_k = k8.bcr_factor(Dg2, Eg2, live=m)
    x_k = k8.bcr_solve(lv_k, rows)
    lv_k2, _ = k8.bcr_factor(Dg2, Eg2, live=m)
    x_k2 = k8.bcr_solve(lv_k2, rows)
    levels = len(lv_k) - 1
    assert levels == m2.bit_length() - 1
    assert k8.bcr_factor.launches - nf == 2 * (3 * levels + 1)
    assert k8.bcr_solve.launches - ns == 2 * (4 * levels + 2)
    torch.cuda.synchronize()
    assert bool(ok_p) and bool(ok_k)
    for lk, lp, l2 in zip(lv_k[:-1], lv_p[:-1], lv_k2[:-1]):
        for got, want, again in zip(lk, lp, l2):
            assert got.shape == want.shape
            assert _rel(got, want) <= tol and torch.equal(got, again)
    assert _rel(lv_k[-1], lv_p[-1]) <= tol
    assert torch.equal(lv_k[-1], lv_k2[-1])
    assert torch.equal(x_k, x_k2)
    assert _rel(x_k, x_pn) <= tol
    assert _rel(k8.bcr_solve(lv_p, rows), x_pn) <= tol
    assert _rel(x_k, x_p) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("F,m,chunk", [(2, 3, 24), (1, 2, 5)],
                         ids=["F2-m3-n216", "m2-n45"])
def test_scan_factor_and_solve_kernels_match_plain(dtype, F, m, chunk):
    """K8b's scan and K8c's scan solve against `_factor` and
    `_solve_factored`, crossed both ways; bit-identical relaunches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    tol = TOL_K8[dtype]
    Dg, Eg, b = _chunk_system(dtype, F, m, chunk, seed=5)
    C_p, M_p, ok_p = banded._factor(Dg, Eg)
    x_p = banded._solve_factored(C_p, M_p, b)
    rows = b.reshape(F, -1)
    C, M, ok = k8.scan_factor(Dg, Eg)
    C2, M2, _ = k8.scan_factor(Dg, Eg)
    x = k8.scan_solve(C, M, rows)
    torch.cuda.synchronize()
    assert bool(ok_p) and bool(ok)
    assert torch.equal(C, C2) and torch.equal(M, M2)
    assert torch.equal(x, k8.scan_solve(C, M, rows))
    assert _rel(C, C_p) <= tol and _rel(M, M_p) <= tol
    assert _rel(x, x_p) <= tol
    assert _rel(banded._solve_factored(C, M, b), x_p) <= tol
    assert _rel(k8.scan_solve(C_p, M_p, rows), x_p) <= tol


@pytest.mark.parametrize("bcr", [True, False], ids=["bcr", "scan"])
def test_chunk_factor_kernel_flags_an_indefinite_block(bcr):
    """An indefinite chunk gives ok == False on the device, as the plain
    factor's `cholesky_ex` info does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    Dg, Eg, _ = _chunk_system(torch.float64, 1, 4, 5, seed=2)
    Dg[0, 1, 7, 7] = -50.0
    if bcr:
        assert not bool(k8.bcr_factor(Dg, Eg)[1])
        assert not bool(k8.bcr_factor_plain(Dg, Eg)[1])
        assert not bool(banded._bcr_factor(Dg, Eg)[1])
    else:
        assert not bool(k8.scan_factor(Dg, Eg)[2])
        assert not bool(banded._factor(Dg, Eg)[2])


@pytest.mark.parametrize("F,bcr", [(1, True), (1, False), (2, True)],
                         ids=["bcr", "scan", "F2-bcr"])
def test_banded_pcg_solve_on_the_card_runs_k8_only(monkeypatch, F, bcr):
    """`banded_pcg_solve` on CUDA tensors makes no `torch.linalg` call and
    no host read: one K8a launch, the factor's launches, and 5 solves
    (2 levels + 1 each way under cyclic reduction, 2 for the scan); its
    f64 step equals the CPU's plain path to 1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.core.problem import BAConfig
    from ba_tpu_torch.kernels import chunk_tridiag as k8
    from ba_tpu_torch.solver import banded

    P_w, B, D = 38, 4, 9
    band = torch.as_tensor(_spd_windows(np.random.default_rng(3), F, P_w,
                                        B, D))
    rhs = torch.as_tensor(np.random.default_rng(4).standard_normal(
        F * P_w * D))
    mask = torch.ones(F * P_w * D, dtype=torch.bool)
    cfg = BAConfig(pose_dim=D, lm_size=1, fleet_size=F, banded_chunk=8,
                   banded_cyclic_reduction=bcr)
    want, ok_w = banded.banded_pcg_solve(band, rhs, mask, cfg, F * P_w, D)
    for name in ("cholesky_ex", "cholesky", "solve_triangular"):
        monkeypatch.setattr(torch.linalg, name, None)
    counts = (k8.chunk_layout.launches, k8.bcr_factor.launches,
              k8.scan_factor.launches, k8.bcr_solve.launches,
              k8.scan_solve.launches)
    args = (band.cuda(), rhs.cuda(), mask.cuda(), cfg, F * P_w, D)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, ok = banded.banded_pcg_solve(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = tuple(a - b for a, b in zip(
        (k8.chunk_layout.launches, k8.bcr_factor.launches,
         k8.scan_factor.launches, k8.bcr_solve.launches,
         k8.scan_solve.launches), counts))
    # 5 chunks of 8 poses: 8 under cyclic reduction, 3 levels (3 launches
    # a level and the base in the factor, 4 a level and 2 in a solve)
    assert moved == ((1, 10, 0, 5 * 14, 0) if bcr else (1, 0, 1, 0, 5 * 2))
    assert bool(ok) and bool(ok_w)
    assert _rel(got.cpu(), want) <= 1e-10


def test_gps_smoother_on_the_card(tmp_path):
    """The GPS + IMU smoother's app on a 12-fix log: the f32 batch through
    K1 at lm_size 0, K2, segsum, K5b and K5 (cost falls, the track within
    a few GPS sigma of the fixes), and the f64 stream (W = 6) through K11
    on every slide, certified or clipped with its info flag set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ba_tpu_torch.apps import unary_binary_imu_test as app
    from ba_tpu_torch.kernels import (band_to_dense, marginalize,
                                      reprojection, schur_finish)
    from ba_tpu_torch.utils.tree import tree_map

    path = str(tmp_path / "log.txt")
    app.generate_log(path, n_gps=12, noise_gps=0.2)
    imu, gps, gu, parser = app.parse_log(path)
    p, cfg = app.build_problem_from_records(imu, gps, gu)
    p = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a, p)
    before = (reprojection.reprojection.launches,
              band_to_dense.band_to_dense.launches,
              schur_finish.schur_finish.launches)
    sol, summ = app.solve_batch(p, cfg)
    its = summ.iterations
    assert summ.is_good and summ.final_cost < summ.initial_cost
    assert (reprojection.reprojection.launches - before[0],
            band_to_dense.band_to_dense.launches - before[1],
            schur_finish.schur_finish.launches - before[2]) == (
                2 * its + 1, its, its)
    err = np.linalg.norm(sol.poses.t[:12].double().cpu().numpy()
                         - np.array([r[1:4] for r in gps]), axis=1)
    assert err.mean() < 1.5, err
    with marginalize.Branches() as br:
        outs, _ = app.run_streaming(imu, gps, gu, 6)
        got = br.read()
    assert len(outs) == 7 and got["marginalizations"] == 7 and got["ok"]
    assert all(np.isfinite(o["t"]).all() for o in outs)
