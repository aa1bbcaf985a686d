"""The port's poly3 and equidistant cameras and per-pose intrinsics
against ba_tpu: the nine tests of tests/test_camera_models.py, each on
both packages.

Each test builds the reference test's own numpy scene from its seed
(`_scene_with_model`, `_rays`) once through ba_tpu's ProblemBuilder and
once through the port's (f64, CPU: the plain versions of the kernels).
The two problems agree leaf for leaf to 1e-12; projections, unprojections,
residuals and Jacobians to 1e-10 relative; `solve` takes the same
iterations to the same result code, with its final cost, poses and
landmarks within 1e-8.  The reference test's own assertions then hold on
the port's results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import test_camera_models as ref
from ba_tpu.core import camera as jcam
from ba_tpu.core.problem import prepare_landmarks as jprepare
from ba_tpu.core.residuals import reprojection as jrep
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import camera as tcam
from ba_tpu_torch.core.problem import prepare_landmarks as tprepare
from ba_tpu_torch.core.residuals import reprojection as trep
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_eval_matches, assert_rel,
                               assert_solve_matches, assert_tree_rel,
                               both_scenes)

TOL = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _project_both(params, model, p):
    want = np.asarray(jcam.project(jnp.asarray(params), model,
                                   jnp.asarray(p)))
    got = tcam.project(_t(params), model, _t(p))
    assert_rel(got, want, TOL, "project")
    return got.numpy()


def test_poly3_matches_numpy_oracle():
    p = ref._rays()
    got = _project_both(ref.POLY3, tcam.MODEL_POLY3, p)
    np.testing.assert_allclose(got, ref.np_poly3_project(ref.POLY3, p),
                               atol=1e-9)


def test_equidistant_matches_numpy_oracle():
    p = ref._rays(seed=1)
    got = _project_both(ref.EQUI, tcam.MODEL_EQUIDISTANT, p)
    np.testing.assert_allclose(got, ref.np_equi_project(ref.EQUI, p),
                               atol=1e-9)


# name -> (params, model, the reference test's seed and tolerance)
ROUNDTRIP = {"poly3": (ref.POLY3, tcam.MODEL_POLY3, 2, 1e-6),
             "equidistant": (ref.EQUI, tcam.MODEL_EQUIDISTANT, 3, 1e-8)}


@pytest.mark.parametrize("name", sorted(ROUNDTRIP))
def test_unproject_roundtrip(name):
    """test_poly3_unproject_roundtrip and
    test_equidistant_unproject_roundtrip: the port's unprojection (poly3's
    by eight Newton steps) equals ba_tpu's, and projecting it back gives
    the pixel."""
    params, model, seed, atol = ROUNDTRIP[name]
    p = ref._rays(seed=seed)
    pix = _project_both(params, model, p)
    want = np.asarray(jcam.unproject(jnp.asarray(params), model,
                                     jnp.asarray(pix)))
    ray = tcam.unproject(_t(params), model, _t(pix))
    assert_rel(ray, want, TOL, f"{name} unproject")
    pix2 = tcam.project(_t(params), model, ray).numpy()
    np.testing.assert_allclose(pix2, pix, atol=atol)


def test_jacobians_finite_all_models():
    p = ref._rays(4)
    for params, model in ((ref.POLY3, tcam.MODEL_POLY3),
                          (np.concatenate([ref.EQUI, np.zeros(3)]),
                           tcam.MODEL_EQUIDISTANT)):
        want = jax.vmap(jax.jacfwd(
            lambda x, pa=jnp.asarray(params), m=model:
            jcam.project(pa, m, x)))(jnp.asarray(p))
        J = vmap(jacfwd(lambda x, pa=_t(params), m=model:
                        tcam.project(pa, m, x)))(_t(p))
        assert_rel(J, np.asarray(want), TOL, f"model {model} jacobian")
        assert bool(torch.isfinite(J).all())
        assert float(J.abs().max()) > 1.0


def _scenes(monkeypatch, *args, **kw):
    """(ba_tpu problem, config), (port problem, config) of the reference
    test's scene, the two problems equal leaf for leaf."""
    (jp, jcfg, _), (tp, tcfg, _) = both_scenes(
        monkeypatch, ref, ref._scene_with_model, *args, **kw)
    assert_tree_rel(tp, jp, 1e-12)
    return (jp, jcfg), (tp, tcfg)


# name -> (params, model, per-pose intrinsics)
BA = {"poly3": (ref.POLY3, tcam.MODEL_POLY3, False),
      "equidistant": (ref.EQUI, tcam.MODEL_EQUIDISTANT, False),
      "per_pose_cam_params": (ref.POLY3, tcam.MODEL_POLY3, True)}


@pytest.mark.parametrize("name", sorted(BA))
def test_ba_converges(monkeypatch, name):
    """test_poly3_ba_converges, test_equidistant_ba_converges and
    test_per_pose_cam_params_ba_converges: the first build's residuals
    and Jacobians, then `solve(max_iter=15)`, on both packages."""
    params, model, per_pose = BA[name]
    (jp, jcfg), (tp, tcfg) = _scenes(monkeypatch, params, model,
                                     perturb=0.03, per_pose=per_pose)
    assert_eval_matches(trep.evaluate(tprepare(tp, tcfg), tcfg, True),
                        jrep.evaluate(jprepare(jp, jcfg), jcfg, True))
    want = jstep.solve(jp, jcfg, max_iter=15, use_imu=False)
    got = tstep.solve(tp, tcfg, max_iter=15, use_imu=False)
    assert_solve_matches(got, want)
    assert got[1].final_cost < 1e-4, got[1]


def test_per_pose_cam_params_zero_at_truth(monkeypatch):
    """Residuals vanish at ground truth only if evaluation really uses
    each pose's own intrinsics; with the rig camera's they do not."""
    (jp, jcfg), (tp, tcfg) = _scenes(monkeypatch, ref.POLY3,
                                     tcam.MODEL_POLY3, perturb=0.0,
                                     per_pose=True)
    jp, tp = jprepare(jp, jcfg), tprepare(tp, tcfg)
    assert_tree_rel(tp.lms, jp.lms, TOL, "prepared lms")
    ev = trep.evaluate(tp, tcfg, with_jacobians=False)
    assert_eval_matches(ev, jrep.evaluate(jp, jcfg, with_jacobians=False))
    r = ev.r[tp.proj.valid]
    assert float(r.abs().max()) < 1e-6
    jcfg_rig = dataclasses.replace(jcfg, use_per_pose_cam_params=False)
    tcfg_rig = dataclasses.replace(tcfg, use_per_pose_cam_params=False)
    ev2 = trep.evaluate(tp, tcfg_rig, with_jacobians=False)
    assert_eval_matches(ev2, jrep.evaluate(jp, jcfg_rig,
                                           with_jacobians=False))
    assert float(ev2.r[tp.proj.valid].abs().max()) > 1.0
