"""The port's core math against ba_tpu: lie, camera (all four models),
robust weights, and the small linear-algebra helpers.

Values agree to 1e-12 relative (the same f64 formulas, a few operations
ordered differently); the Jacobians through the Taylor guards to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from ba_tpu.core import camera as jcam
from ba_tpu.core import lie as jlie
from ba_tpu.core import robust as jrob
from ba_tpu.utils import linalg as jla
from ba_tpu_torch.core import camera as tcam
from ba_tpu_torch.core import lie as tlie
from ba_tpu_torch.core import robust as trob
from ba_tpu_torch.utils import linalg as tla

from test_torch_common import assert_rel

RNG = np.random.default_rng(7)


def _T(a):
    return torch.as_tensor(np.array(a))


def _unit_quats(n):
    q = RNG.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _tangents(n):
    """Rotation vectors at every scale, including inside the Taylor
    branches (|w| < 1e-6) and exactly zero."""
    w = RNG.standard_normal((n, 3))
    scale = np.logspace(-9, 0.4, n)[:, None]
    w = w * scale
    w[0] = 0.0
    return w


def test_quaternion_and_se3_maps_match():
    qa, qb = _unit_quats(64), _unit_quats(64)
    ta, tb = RNG.standard_normal((64, 3)), RNG.standard_normal((64, 3))
    v = RNG.standard_normal((64, 3))
    ph = np.concatenate([RNG.standard_normal((64, 3)),
                         RNG.uniform(0, 1, (64, 1))], axis=1)
    x6 = np.concatenate([RNG.standard_normal((64, 3)), _tangents(64)], 1)
    cases = [
        ("quat_mul", (qa, qb), jlie.quat_mul, tlie.quat_mul),
        ("quat_conj", (qa,), jlie.quat_conj, tlie.quat_conj),
        ("quat_rotate", (qa, v), jlie.quat_rotate, tlie.quat_rotate),
        ("quat_to_matrix", (qa,), jlie.quat_to_matrix, tlie.quat_to_matrix),
        ("matrix_to_quat", (np.asarray(jlie.quat_to_matrix(qa)),),
         jlie.matrix_to_quat, tlie.matrix_to_quat),
        ("so3_exp", (_tangents(64),), jlie.so3_exp, tlie.so3_exp),
        ("so3_log", (qa,), jlie.so3_log, tlie.so3_log),
        ("gravity_vector", (RNG.standard_normal((64, 2)),),
         jlie.gravity_vector, tlie.gravity_vector),
    ]
    for name, args, jf, tf in cases:
        assert_rel(tf(*map(_T, args)), jf(*map(jnp.asarray, args)), 1e-12,
                   name)
    se3 = [
        ("se3_compose", lambda L, a, b, c, d: L.se3_compose((a, b), (c, d))),
        ("se3_inverse", lambda L, a, b, c, d: L.se3_inverse((a, b))),
        ("se3_log_decoupled",
         lambda L, a, b, c, d: L.se3_log_decoupled((a, b), (c, d))),
    ]
    for name, f in se3:
        got = f(tlie, _T(qa), _T(ta), _T(qb), _T(tb))
        want = f(jlie, *map(jnp.asarray, (qa, ta, qb, tb)))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert_rel(g, w, 1e-12, name)
    got = tlie.se3_retract((_T(qa), _T(ta)), _T(x6))
    want = jlie.se3_retract((jnp.asarray(qa), jnp.asarray(ta)),
                            jnp.asarray(x6))
    for g, w in zip(got, want):
        assert_rel(g, w, 1e-12, "se3_retract")
    assert_rel(tlie.se3_transform_homog((_T(qa), _T(ta)), _T(ph)),
               jlie.se3_transform_homog((jnp.asarray(qa), jnp.asarray(ta)),
                                        jnp.asarray(ph)), 1e-12, "homog")


def test_exp_log_jacobians_through_taylor_guards():
    """jacfwd through the double-where guards: finite and equal to JAX's,
    at zero, inside the Taylor branch and outside it."""
    w = _tangents(32)
    # small rotations so the log's Taylor branch (|v| < 1e-6) is reached
    q = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    for jf, tf, x in ((jlie.so3_exp, tlie.so3_exp, w),
                      (jlie.so3_log, tlie.so3_log, q)):
        want = jax.vmap(jax.jacfwd(jf))(jnp.asarray(x))
        got = vmap(jacfwd(tf))(_T(x))
        assert bool(torch.isfinite(got).all())
        assert_rel(got, want, 1e-10, jf.__name__)


@pytest.mark.parametrize("model", [jcam.MODEL_LINEAR, jcam.MODEL_FOV,
                                   jcam.MODEL_POLY3, jcam.MODEL_EQUIDISTANT])
def test_camera_project_unproject_match(model):
    n = 64
    params = np.zeros((n, jcam.MAX_PARAMS))
    params[:, :4] = [300.0, 310.0, 320.0, 240.0]
    params[:, 4:] = ({jcam.MODEL_FOV: [0.9, 0, 0],
                      jcam.MODEL_POLY3: [-0.2, 0.05, -0.01]}
                     .get(model, [0.0, 0, 0]))
    ray = RNG.standard_normal((n, 3)) * [0.5, 0.5, 0.2] + [0, 0, 1.0]
    ray[0] = [0.0, 0.0, 1.0]            # r == 0: the small-r guards
    ray[1] = [0.3, 0.1, 0.0]            # z == 0: the z guard
    ray[2] = [0.3, 0.1, -1e-12]
    models = np.full(n, model, np.int32)
    args_j = (jnp.asarray(params), jnp.asarray(models))
    args_t = (_T(params), _T(models))
    assert_rel(tcam.project(*args_t, _T(ray)),
               jcam.project(*args_j, jnp.asarray(ray)), 1e-12, "project")
    pix = np.asarray(jcam.project(*args_j, jnp.asarray(ray)))[3:]
    assert_rel(tcam.unproject(args_t[0][3:], args_t[1][3:], _T(pix)),
               jcam.unproject(args_j[0][3:], args_j[1][3:], jnp.asarray(pix)),
               1e-12, "unproject")
    # Jacobian of the projection w.r.t. the ray, away from the z guard
    want = jax.vmap(jax.jacfwd(jcam.project, argnums=2))(
        *args_j, jnp.asarray(ray))[3:]
    got = vmap(jacfwd(tcam.project, argnums=2))(*args_t, _T(ray))[3:]
    assert_rel(got, want, 1e-10, "d project / d ray")


@pytest.mark.parametrize("case", ["ties", "empty_cond", "all_empty",
                                  "random"])
def test_masked_median_and_huber_weights_match(case):
    n = 40
    err = RNG.uniform(0, 10, n) ** 2
    valid = RNG.uniform(size=n) > 0.2
    cond = RNG.uniform(size=n) > 0.7
    if case == "ties":
        err = np.round(err / 10) * 10          # many equal values
    elif case == "empty_cond":
        cond[:] = False
    elif case == "all_empty":
        valid[:] = False
    args_j = tuple(map(jnp.asarray, (err, valid, cond)))
    args_t = tuple(map(_T, (err, valid, cond)))
    assert_rel(trob.masked_median(args_t[0], args_t[1]),
               jrob.masked_median(args_j[0], args_j[1]), 1e-14, "median")
    assert_rel(trob.masked_median(args_t[0], args_t[1] & args_t[2]),
               jrob.masked_median(args_j[0], args_j[1] & args_j[2]), 1e-14,
               "median cond")
    assert_rel(trob.huber_weights(*args_t, 1.5),
               jrob.huber_weights(*args_j, 1.5), 1e-12, "huber")


def _spd(n, k, rank=None):
    A = RNG.standard_normal((n, k, rank or k))
    return A @ np.swapaxes(A, 1, 2) + (1e-3 * np.eye(k) if rank is None
                                       else 0.0)


def test_linalg_helpers_match():
    for k in (3, 6, 9):
        A = _spd(16, k)
        for name in ("chol_blocked",):
            assert_rel(getattr(tla, name)(_T(A)),
                       getattr(jla, name)(jnp.asarray(A)), 1e-12, name)
        L = np.asarray(jla.chol_blocked(jnp.asarray(A)))
        assert_rel(tla.tri_inv_blocked(_T(L)),
                   jla.tri_inv_blocked(jnp.asarray(L)), 1e-10, "tri_inv")
        for from_cov in (False, True):
            assert_rel(tla.whiten_factor(_T(A), from_cov=from_cov),
                       jla.whiten_factor(jnp.asarray(A), from_cov=from_cov),
                       1e-10, f"whiten_factor {k} {from_cov}")
    # all-zero blocks (the padded prior rows): the same factor, NaNs in
    # the off-diagonal blocks included (the prior masks those rows)
    Z = np.zeros((2, 6, 6))
    assert_rel(tla.whiten_factor(_T(Z)), jla.whiten_factor(jnp.asarray(Z)),
               0.0, "whiten zero")
    A3 = _spd(16, 3)
    assert_rel(tla.inv3(_T(A3)), jla.inv3(jnp.asarray(A3)), 1e-10, "inv3")
    assert_rel(tla.chol3(_T(A3)), jla.chol3(jnp.asarray(A3)), 1e-12, "chol3")
    for k in (1, 3, 2):
        V = _spd(16, k)
        assert_rel(tla.block_diag_inv(_T(V)),
                   jla.block_diag_inv(jnp.asarray(V)), 1e-10,
                   f"block_diag_inv {k}")
