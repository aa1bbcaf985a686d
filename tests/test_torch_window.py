"""The port's sliding-window marginalization against ba_tpu.

`window.marginalize` builds the departing poses' system on the general
assembly path and Schur-complements them out with a masked inverse; the
prior's H and g agree with ba_tpu's to 1e-9 relative (the same sums in
another order, then an inverse and an eigendecomposition).  The prior is
PSD and zero on the departing dims, and `apply_marginalization` masks the
same states and residuals as ba_tpu, twice in a row (the second
marginalization folds the first prior in).  Cases: a 12-pose
visual-inertial problem, and a pose graph of unary and binary priors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import window as jwin
from ba_tpu_torch.solver import window as twin

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config)

TOL = 1e-9
IDQ = np.array([1.0, 0, 0, 0])


def _pose_graph():
    """A 7-pose chain: one unary prior, odometry and skip edges."""
    rng = np.random.default_rng(0)
    cfg = jprob.BAConfig(pose_dim=6, lm_size=0, use_dogleg=False,
                         enable_auto_regularization=False)
    b = jprob.ProblemBuilder(cfg)
    t_true = np.cumsum(rng.normal(size=(7, 3)), axis=0)
    for i in range(7):
        b.add_pose(IDQ, t_true[i] + rng.normal(size=3) * 0.3,
                   time=float(i))
    b.add_unary_constraint(0, IDQ, t_true[0], cov=np.eye(6) * 1e-6)
    for i, j in [(k, k + 1) for k in range(6)] + [(0, 3), (1, 4), (2, 5)]:
        meas = t_true[j] - t_true[i] + rng.normal(size=3) * 0.05
        b.add_binary_constraint(i, j, IDQ, meas,
                                cov=np.eye(6) * rng.uniform(0.01, 0.1))
    return b.build(), cfg, False


def _case(name):
    if name == "pose_graph":
        jp, jcfg, use_imu = _pose_graph()
    else:
        jp, jcfg, _ = jax_problem()
        use_imu = True
    jp = jprob.prepare_landmarks(jp, jcfg)
    tcfg = torch_config(jcfg)
    return jp, jcfg, to_torch(jp), tcfg, use_imu


def _drop(P, i):
    d = np.arange(P) == i
    return jnp.asarray(d), torch.as_tensor(d)


CASES = ["vins", "pose_graph"]


@pytest.mark.parametrize("case", CASES)
def test_marginalize_prior_matches_ba_tpu(case):
    jp, jcfg, tp, tcfg, use_imu = _case(case)
    jd, td = _drop(tp.poses.q.shape[0], 2)
    want = jwin.marginalize(jp, jcfg, use_imu, jd)
    got = twin.marginalize(tp, tcfg, use_imu, td)
    for f in dataclasses.fields(want):
        assert_rel(getattr(got, f.name), getattr(want, f.name), TOL, f.name)


@pytest.mark.parametrize("case", CASES)
def test_prior_psd_and_zero_on_dropped_dims(case):
    jp, jcfg, tp, tcfg, use_imu = _case(case)
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    _, td = _drop(P, 2)
    m = twin.marginalize(tp, tcfg, use_imu, td)
    H = m.H.numpy()
    ev = np.linalg.eigvalsh(H)
    assert ev.min() >= -1e-9 * max(1.0, ev.max()), ev.min()
    assert np.abs(H - H.T).max() <= 1e-12 * max(1.0, np.abs(H).max())
    # the eigenvalue clip mixes rows at roundoff, so the departing rows
    # are zero to 1e-12 of the prior's scale; g is masked exactly
    dims = td.repeat_interleave(D).numpy()
    scale = np.abs(H).max()
    assert scale > 0.0
    assert np.abs(H[dims]).max() <= 1e-12 * scale
    assert np.all(m.g.numpy()[dims] == 0.0)


@pytest.mark.parametrize("case", CASES)
def test_apply_marginalization_twice_masks_match(case):
    jp, jcfg, tp, tcfg, use_imu = _case(case)
    P = tp.poses.q.shape[0]
    for i in (2, 3):
        jd, td = _drop(P, i)
        jp = jwin.apply_marginalization(jp, jcfg, use_imu, jd)
        tp = twin.apply_marginalization(tp, tcfg, use_imu, td)
        for node, fields in (("poses", ("active",)), ("lms", ("active",)),
                             ("proj", ("valid",)), ("unary", ("valid",)),
                             ("binary", ("valid",)), ("imu", ("valid",))):
            for f in fields:
                assert_rel(getattr(getattr(tp, node), f),
                           getattr(getattr(jp, node), f), 0.0,
                           f"drop {i}: {node}.{f}")
        assert_rel(tp.marg.H, jp.marg.H, TOL, f"drop {i}: marg.H")
        assert_rel(tp.marg.g, jp.marg.g, TOL, f"drop {i}: marg.g")
        assert bool(tp.marg.active)
