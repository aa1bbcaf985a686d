"""The port's ring-buffer fixed-lag smoother against ba_tpu.

`build_ring_schedule` slices a trajectory into per-slide slot tables on
the host; the port's tables must equal ba_tpu's field by field, exactly
(the same numpy on the same problem).  `run_ring` then runs on ba_tpu's
own schedule, carried across with `ring_schedule_from_numpy`: the per-slide
costs and the retired keyframes' q/t/v/b agree with ba_tpu's `run_ring`
to 1e-8 relative (roundoff through two GN solves and one marginalization
per slide, compounded over the slides).  16 poses, W = 5, 2 iterations.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import fixedlag as jfl
from ba_tpu_torch.convert import ring_schedule_from_numpy
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.solver import fixedlag as tfl

from test_torch_common import assert_rel, to_torch, torch_config

W, ITERS = 5, 2


@functools.lru_cache(maxsize=None)
def ring_case(n_poses=16, n_lms=64, seed=2):
    """(JAX problem, JAX config, JAX schedule), prepared, no marg prior."""
    cfg = jprob.BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=n_poses, n_lms=n_lms, seed=seed)
    p, _, _ = jsv.build_problem(sim, cfg, perturb=0.01, seed=seed + 1,
                                with_marg_prior=False)
    p = jprob.prepare_landmarks(p, cfg)
    return p, cfg, jfl.build_ring_schedule(p, cfg, W, n_poses - W + 1)


@functools.lru_cache(maxsize=None)
def jax_ring_outputs():
    _, jcfg, sched = ring_case()
    carry, outs = jfl.run_ring(sched, jcfg, True, ITERS)
    return jax.tree_util.tree_map(np.asarray, (carry, outs))


def test_ring_schedule_tables_equal_ba_tpu():
    jp, jcfg, js = ring_case()
    ts = tfl.build_ring_schedule(to_torch(jp), torch_config(jcfg), W,
                                 js.n_slides)
    assert (ts.W, ts.L_w, ts.n_slides) == (js.W, js.L_w, js.n_slides)
    assert sorted(ts.inputs) == sorted(js.inputs)
    for key, want in js.inputs.items():
        if key == "pidx":
            for f in dataclasses.fields(want):
                assert_rel(getattr(ts.inputs[key], f.name),
                           getattr(want, f.name), 0.0, f"pidx.{f.name}")
        else:
            assert_rel(ts.inputs[key], want, 0.0, key)
            assert ts.inputs[key].dtype == torch.as_tensor(
                np.array(want)).dtype, key
    for i, (got, want) in enumerate(zip(ts.carry0[:5], js.carry0[:5])):
        assert_rel(got, want, 0.0, f"carry0[{i}]")
    for f in dataclasses.fields(js.carry0[5]):
        assert_rel(getattr(ts.carry0[5], f.name),
                   getattr(js.carry0[5], f.name), 0.0, f"marg0.{f.name}")


def test_run_ring_on_the_ba_tpu_schedule_matches():
    _, jcfg, js = ring_case()
    (jq, jt, jv, jb, jlx, jmarg), jouts = jax_ring_outputs()
    ts = ring_schedule_from_numpy(js, device="cpu")
    (q, t, v, b, lx, marg), outs = tfl.run_ring(ts, torch_config(jcfg),
                                                True, ITERS)
    assert outs["cost"].shape == (js.n_slides,)
    for key in ("cost", "q", "t", "v", "b"):
        assert_rel(outs[key], jouts[key], 1e-8, key)
    for name, got, want in (("q", q, jq), ("t", t, jt), ("v", v, jv),
                            ("lm_x", lx, jlx), ("marg.g", marg.g, jmarg.g)):
        assert_rel(got, want, 1e-8, f"final {name}")
    costs = outs["cost"].numpy()
    assert np.isfinite(costs).all() and costs[-1] < 1e-4, costs


@pytest.mark.parametrize("bad", ["marg_prior", "calibration"])
def test_ring_schedule_refuses_what_the_ring_cannot_carry(bad):
    jp, jcfg, _ = ring_case()
    tp, tcfg = to_torch(jp), torch_config(jcfg)
    if bad == "marg_prior":
        P = tp.poses.q.shape[0]
        marg = tprob.empty_marg_prior(P, tcfg.pose_dim, torch.float64,
                                      "cpu")
        tp = dataclasses.replace(tp, marg=dataclasses.replace(
            marg, active=torch.ones((), dtype=torch.bool)))
    else:
        tcfg = dataclasses.replace(tcfg, calib_size=5)
    with pytest.raises(AssertionError):
        tfl.build_ring_schedule(tp, tcfg, W)
