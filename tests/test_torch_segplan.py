"""The segment plans of kernel 2 against ba_tpu.

A `SegPlan` (kernels/segsum.py) is the static index work of one segment
sum: a stable sort, CSR offsets and a work table of chunks of at most R
rows.  The CUDA kernel reads it; on the CPU `plan_walk` sums the same
chunks and adds them per segment in chunk order.  Here the walk is held
against `ba_tpu.solver.assemble.seg_sum_blocks` at 1e-12 (f64 values, the
same numbers in another order), the work table is checked to cover every
in-range row exactly once, and the assembly and the GN solve are held
against ba_tpu with a plan passed explicitly (1e-9 for one build, 1e-8 for
the five-iteration trace, as in test_torch_assemble/test_torch_solver).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.kernels import reprojection as tk1
from ba_tpu_torch.kernels import segsum
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import step as tstep

from test_torch_common import assert_rel, jax_problem, to_torch, torch_config

R = segsum.R


def _ids(case):
    """(ids, nseg): skewed ids with one segment of >= 3R rows, on a
    one-hot-sized and a scatter-sized segment count, with empty segments,
    and with out-of-range ids."""
    rng = np.random.default_rng(7)
    if case == "skewed_empty":
        nseg = 40
        ids = 2 * rng.integers(0, nseg // 2, 700)       # odd ones empty
        ids[rng.choice(700, 150, replace=False)] = 7
    elif case == "scatter":
        nseg = 600
        ids = rng.integers(0, nseg, 900)
        ids[rng.choice(900, 3 * R + 5, replace=False)] = 599
    else:
        nseg = 40
        ids = rng.integers(-4, nseg + 4, 700)
        ids[rng.choice(700, 4 * R, replace=False)] = 0
    return ids.astype(np.int32), nseg


CASES = ["skewed_empty", "scatter", "out_of_range"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 6, 36])
def test_plan_walk_matches_seg_sum_blocks(case, k):
    ids, nseg = _ids(case)
    assert np.bincount(ids[(ids >= 0) & (ids < nseg)]).max() >= 3 * R
    vals = np.random.default_rng(k).standard_normal((ids.shape[0], k))
    want = jasm.seg_sum_blocks(jnp.asarray(vals), jnp.asarray(ids), nseg)
    plan = segsum.build_plan(torch.as_tensor(ids), nseg)
    got = segsum.plan_walk(torch.as_tensor(vals), plan)
    assert_rel(got, want, 1e-12, f"plan walk {case} k={k}")


@pytest.mark.parametrize("case", CASES)
def test_every_in_range_row_lies_in_exactly_one_chunk(case):
    ids, nseg = _ids(case)
    n = ids.shape[0]
    plan = segsum.build_plan(torch.as_tensor(ids), nseg)
    perm = plan.perm.numpy()
    ch = plan.chunks.numpy()
    assert plan.chunks.dtype == torch.int32 and perm.dtype == np.int32
    assert ch.shape == (nseg + n // R, 4)
    used = ch[ch[:, 0] >= 0]
    assert (ch[len(used):, 0] == -1).all()      # unused rows trail
    seg, row0, rows, j = used.T
    assert (rows <= R).all() and (rows >= 0).all()
    covered = np.concatenate([perm[a:a + r] for a, r in zip(row0, rows)])
    inside = np.flatnonzero((ids >= 0) & (ids < nseg))
    np.testing.assert_array_equal(np.sort(covered), inside)
    for s, a, r in zip(seg, row0, rows):
        assert (ids[perm[a:a + r]] == s).all()
    # every segment has its chunks in order; a lone chunk is marked -1
    np.testing.assert_array_equal(np.unique(seg), np.arange(nseg))
    assert (np.diff(seg) >= 0).all()
    count = np.bincount(ids[inside], minlength=nseg)
    for s in range(nseg):
        js = j[seg == s]
        m = max(1, -(-count[s] // R))
        assert len(js) == m
        np.testing.assert_array_equal(js, np.arange(m) if m > 1 else [-1])


def test_empty_plans():
    vals = torch.zeros((0, 6), dtype=torch.float64)
    plan = segsum.build_plan(torch.zeros((0,), dtype=torch.int32), 5)
    assert plan.chunks.shape == (5, 4)
    assert torch.equal(segsum.plan_walk(vals, plan),
                       torch.zeros((5, 6), dtype=torch.float64))
    plan0 = segsum.build_plan(torch.arange(64), 0)
    assert plan0.chunks.shape == (0, 4)
    assert segsum.plan_walk(torch.ones((64, 3)), plan0).shape == (0, 3)


def _case(n_poses, pad_multiple, use_dogleg=False):
    jp, jcfg, _ = jax_problem(n_poses=n_poses, n_lms=4 * n_poses,
                              pad_multiple=pad_multiple)
    jcfg = dataclasses.replace(jcfg, use_dogleg=use_dogleg,
                               band_width=jasm.band_width_of(jp))
    jp = jprob.prepare_landmarks(jp, jcfg)
    tcfg = torch_config(jcfg)
    return jp, jcfg, tprob.prepare_landmarks(to_torch(jp), tcfg), tcfg


@pytest.mark.parametrize("n_poses,pad_multiple", [(12, 1), (24, 3)])
def test_banded_assembly_with_an_explicit_plan_matches(n_poses,
                                                       pad_multiple):
    jp, jcfg, tp, tcfg = _case(n_poses, pad_multiple)
    jie = jax.jit(jstep._imu_eval, static_argnums=(1, 2, 3))(
        jp, jcfg, True, True)
    tie = tstep._imu_eval(tp, tcfg, True, True)
    want = jax.jit(lambda p, ie: jasm.assemble(p, jcfg, imu_eval=ie))(
        jp, jie)
    plan = tasm.assembly_plan(tp, tcfg)
    got = tasm.assemble(tp, tcfg, imu_eval=tie, plan=plan)
    own = tasm.assemble(tp, tcfg, imu_eval=tie)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), 1e-9, name)
        assert torch.equal(getattr(got, name), getattr(own, name)), name


def test_seven_sums_of_a_build_match_the_plain_version():
    """`seg_sum_groups` on the CPU (the plan walk) against
    `_seg_sum_plain` on the ids each plan was built from."""
    _, _, tp, tcfg = _case(12, 3)
    plan = tasm.assembly_plan(tp, tcfg)
    ids = tasm.sum_ids(tp, tcfg)
    assert list(ids) == [f for f in plan._fields if f != "band_width"]
    rng = np.random.default_rng(3)
    groups, want = [], []
    for name, (i, nseg) in ids.items():
        vals = torch.as_tensor(rng.standard_normal((i.shape[0], 2, 3)))
        groups.append((vals, getattr(plan, name)))
        want.append(tasm._seg_sum_plain(vals.reshape(i.shape[0], -1), i,
                                        nseg).reshape(nseg, 2, 3))
    for g, w in zip(tasm.seg_sum_groups(groups), want):
        assert_rel(g, w.numpy(), 1e-12, "grouped sum")


def test_gn_iterations_on_one_plan_reproduce_the_trace():
    """Five GN iterations on one plan: ba_tpu's solve_fixed trace at
    1e-8, and the port's solve_fixed (which builds its own plan) bit for
    bit."""
    jp, jcfg, tp, tcfg = _case(12, 1)
    _, costs_j, dns_j = jstep.solve_fixed(jp, jcfg, True, 5)
    _, costs_f, dns_f = tstep.solve_fixed(tp, tcfg, True, 5)
    plan = tasm.assembly_plan(tp, tcfg)
    costs, dns, p = [], [], tp
    for _ in range(5):
        res = tstep.gn_iteration(p, tcfg, True, plan=plan)
        p = res.problem
        costs.append(res.post_cost)
        dns.append(res.delta_norm)
    assert_rel(torch.stack(costs), costs_j, 1e-8, "costs")
    assert_rel(torch.stack(dns), dns_j, 1e-8, "delta norms")
    assert torch.equal(torch.stack(costs), costs_f)
    assert torch.equal(torch.stack(dns), dns_f)


def test_dogleg_iteration_takes_a_plan():
    jp, jcfg, tp, tcfg = _case(12, 1, use_dogleg=True)
    trust = torch.full((), tcfg.trust_region_size, dtype=torch.float64)
    want = jstep.dogleg_iteration(jp, jcfg, True,
                                  jnp.asarray(jcfg.trust_region_size))
    got = tstep.dogleg_iteration(tp, tcfg, True, trust,
                                 plan=tasm.assembly_plan(tp, tcfg))
    for name in ("pre_cost", "post_cost", "delta_norm", "accepted",
                 "trust_radius", "inner_trials"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-9, name)


def test_assemble_rejects_a_plan_of_another_band_width():
    _, _, tp, tcfg = _case(12, 1)
    plan = tasm.assembly_plan(tp, tcfg)
    other = dataclasses.replace(tcfg, band_width=tcfg.band_width - 1)
    with pytest.raises(ValueError, match="band width"):
        tasm.assemble(tp, other, plan=plan)
    with pytest.raises(NotImplementedError, match="general assembly"):
        tasm.assembly_plan(tp, dataclasses.replace(tcfg, band_width=0))


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the dispatch takes the plain versions; the kernel
    wrappers themselves launch or raise, never fall back."""
    vals = torch.ones((8, 6), dtype=torch.float64)
    ids = torch.zeros((8,), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        segsum.seg_sum_grouped([(vals, segsum.build_plan(ids, 2))])
    with pytest.raises(ValueError, match="CUDA"):
        segsum.seg_sum(vals, ids, 2)
    _, _, tp, _ = _case(12, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tk1.reprojection(tp, True)
