"""The port's residual families against ba_tpu on identical problems.

Reprojection (the plain version that kernel 1 is held to), with and
without Jacobians, on a problem with padded (invalid) rows and same-pose
rows; the unary/binary priors on the padded one-row tables and on real
ones; the IMU family on both of its paths (the build with covariance
propagation, and the cost-only path with and without a cached c9).
Residuals and Jacobians agree to 1e-10 relative: the same f64 formulas,
with sums and products ordered differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.core.residuals import imu as jimu
from ba_tpu.core.residuals import prior as jprior
from ba_tpu.core.residuals import reprojection as jrep
from ba_tpu_torch.core.residuals import imu as timu
from ba_tpu_torch.core.residuals import prior as tprior
from ba_tpu_torch.core.residuals import reprojection as trep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config)

TOL = 1e-10

# jitted JAX reference: eager JAX runs the IMU scan op by op (seconds)
_j_imu = jax.jit(jimu.evaluate, static_argnames=("config", "with_jacobians"))


def _prepared(pad_multiple=3, same_pose_rows=True):
    """The (12, 48) problem padded by 3 (invalid projection rows, W-block
    and IMU padding), with every 7th projection row re-pointed at its
    landmark's reference pose (same-pose rows: zero pose Jacobians)."""
    jp, jcfg, _ = jax_problem(pad_multiple=pad_multiple)
    jp = jprob.prepare_landmarks(jp, jcfg)
    if same_pose_rows:
        ref = np.asarray(jp.lms.ref_pose)[np.asarray(jp.proj.lm)]
        pose = np.asarray(jp.proj.pose).copy()
        pose[::7] = ref[::7]
        jp = dataclasses.replace(jp, proj=dataclasses.replace(
            jp.proj, pose=jnp.asarray(pose)))
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_matches(with_jacobians):
    jp, jcfg, tp, tcfg = _prepared()
    assert not bool(tp.proj.valid.all())
    same = (tp.proj.pose == tp.lms.ref_pose[tp.proj.lm]) & tp.proj.valid
    assert int(same.sum()) > 0
    want = jrep.evaluate(jp, jcfg, with_jacobians=with_jacobians)
    got = trep.evaluate(tp, tcfg, with_jacobians=with_jacobians)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), TOL, name)
    if with_jacobians:
        assert float(got.j_meas[same].abs().max()) == 0.0
        assert float(got.j_ref[same].abs().max()) == 0.0


def _with_priors(jp):
    """Replace the padded one-row prior tables with real ones: unary
    priors near three poses with random information, and three binary
    edges."""
    rng = np.random.default_rng(5)
    q, t = np.asarray(jp.poses.q), np.asarray(jp.poses.t)
    up = np.array([3, 5, 8], np.int32)
    A = rng.standard_normal((3, 6, 6))
    unary = jprob.UnaryResiduals(
        pose=jnp.asarray(up), q=jnp.asarray(q[up]),
        t=jnp.asarray(t[up] + rng.normal(size=(3, 3)) * 0.05),
        cov_inv=jnp.asarray(np.linalg.inv(A @ np.swapaxes(A, 1, 2)
                                          + np.eye(6))),
        valid=jnp.ones(3, bool))
    b1 = np.array([2, 7, 9], np.int32)
    b2 = np.array([4, 6, 10], np.int32)
    binary = dataclasses.replace(
        jp.binary, pose1=jnp.asarray(b1), pose2=jnp.asarray(b2),
        q=jnp.asarray(np.tile([1.0, 0, 0, 0], (3, 1))),
        t=jnp.asarray(t[b2] - t[b1] + 0.02),
        cov_inv=jnp.asarray(np.tile(np.eye(6), (3, 1, 1))),
        valid=jnp.ones(3, bool), pair=jnp.zeros(3, jnp.int32),
        pair_swap=jnp.zeros(3, bool))
    return dataclasses.replace(jp, unary=unary, binary=binary)


@pytest.mark.parametrize("tables", ["padded", "real"])
@pytest.mark.parametrize("with_jacobians", [True, False])
def test_priors_match(tables, with_jacobians):
    jp, jcfg, tp, tcfg = _prepared(same_pose_rows=False)
    if tables == "real":
        jp = _with_priors(jp)
        tp = to_torch(jp)
    else:
        assert not bool(tp.unary.valid.any())
    for jf, tf in ((jprior.evaluate_unary, tprior.evaluate_unary),
                   (jprior.evaluate_binary, tprior.evaluate_binary)):
        want = jf(jp, jcfg, with_jacobians=with_jacobians)
        got = tf(tp, tcfg, with_jacobians=with_jacobians)
        for name in want._fields:
            assert_rel(getattr(got, name), getattr(want, name), TOL,
                       f"{jf.__name__}.{name}")


@pytest.mark.parametrize("path", ["build", "cost_c9_none", "cost_c9_cached"])
def test_imu_matches(path):
    jp, jcfg, tp, tcfg = _prepared(same_pose_rows=False)
    if path == "build":
        want = _j_imu(jp, jcfg, with_jacobians=True)
        got = timu.evaluate(tp, tcfg, with_jacobians=True)
    else:
        c9 = None
        if path == "cost_c9_cached":
            # a covariance from a build at a moved state, as a trial uses
            c9 = _j_imu(jp, jcfg, with_jacobians=True).c9 * 1.5
        want = _j_imu(jp, jcfg, with_jacobians=False, c9=c9)
        got = timu.evaluate(tp, tcfg, with_jacobians=False,
                            c9=None if c9 is None else
                            torch.as_tensor(np.asarray(c9)))
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), TOL, name)
