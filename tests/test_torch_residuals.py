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


def _qmul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


@pytest.mark.parametrize("theta", [0.0, 1e-9, 1e-5, 1e-2, 1.0,
                                   np.pi - 1e-4],
                         ids=["zero", "1e-9", "1e-5", "1e-2", "1", "near-pi"])
def test_prior_jacobians_across_angles(theta):
    """The port's written-out prior Jacobians against ba_tpu's
    `vmap(jacfwd)` where the rotation error log(q_a q_b^-1) has angle
    `theta`: zero, inside both Taylor branches (1e-9), between them, and
    at the short geodesic's far end; unary and binary rows, with
    Jacobians, f64, at TOL."""
    jp, jcfg, _, tcfg = _prepared(same_pose_rows=False)
    jp = _with_priors(jp)
    rng = np.random.default_rng(11)
    q = np.asarray(jp.poses.q)
    axis = rng.standard_normal((3, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    e = np.concatenate([np.full((3, 1), np.cos(theta / 2)),
                        np.sin(theta / 2) * axis], axis=1)
    up = np.asarray(jp.unary.pose)
    b1, b2 = np.asarray(jp.binary.pose1), np.asarray(jp.binary.pose2)
    # q_pose q_prior^-1 = e, and q1 q_meas q2^-1 = e
    uq = _qmul(_qconj(e), q[up])
    mq = _qmul(_qmul(_qconj(q[b1]), e), q[b2])
    jp = dataclasses.replace(
        jp, unary=dataclasses.replace(jp.unary, q=jnp.asarray(uq)),
        binary=dataclasses.replace(jp.binary, q=jnp.asarray(mq)))
    tp = to_torch(jp)
    for jf, tf in ((jprior.evaluate_unary, tprior.evaluate_unary),
                   (jprior.evaluate_binary, tprior.evaluate_binary)):
        want = jf(jp, jcfg, with_jacobians=True)
        got = tf(tp, tcfg, with_jacobians=True)
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


@pytest.mark.parametrize("with_jacobians", [True, False])
def test_reprojection_lm0_matches(with_jacobians):
    """lm_size 0 (a pose graph; K1 runs it on the card): the plain version
    against ba_tpu's `evaluate`, on the (12, 48) problem with each
    landmark's state its world point and every 7th row measured from its
    landmark's reference pose.  Both evaluate a row as a world point's,
    with no landmark columns (`j_lm` of width 0) and no same-pose
    zeroing: those rows keep their pose Jacobians."""
    jp, jcfg, _, _ = _prepared()
    jp = dataclasses.replace(jp, lms=dataclasses.replace(jp.lms,
                                                         x=jp.lms.x_w))
    jcfg = dataclasses.replace(jcfg, lm_size=0)
    tp, tcfg = to_torch(jp), torch_config(jcfg)
    same = (tp.proj.pose == tp.lms.ref_pose[tp.proj.lm]) & tp.proj.valid
    assert int(same.sum()) > 0
    want = jrep.evaluate(jp, jcfg, with_jacobians=with_jacobians)
    got = trep.evaluate(tp, tcfg, with_jacobians=with_jacobians)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), TOL, name)
    if with_jacobians:
        assert got.j_lm.shape == (tp.proj.z.shape[0], 2, 0)
        assert float(got.j_meas[same].abs().max()) > 0.0
        assert float(got.j_ref.abs().max()) == 0.0
