"""Kernels 1 and 2 against their plain versions on the card.

These need an NVIDIA GPU with nvcc (marker `cuda`); elsewhere they skip.
Run them on the card with `python -m pytest tests/test_torch_kernels_cuda.py
-m cuda --noconftest` (the suite's conftest imports jax, which the card's
machine need not have).  Tolerances, relative to max(1, max |plain|): f64
1e-10 (the closed form vs autodiff differ only in roundoff), f32 1e-4 (a
few ulps of f32 through ~10^3 operations); the segment sum is compared to
an f64 sum of the same f32 values at 1e-5 and must be bit-identical between
launches.  Kernel 1 also runs at a row count that is not a multiple of its
32-row blocks; kernel 2 also runs as one grouped launch of seven sums of
flagship shapes, with one segment of 927 rows and one of 2,100.
"""

import dataclasses

import numpy as np
import pytest
import torch

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
