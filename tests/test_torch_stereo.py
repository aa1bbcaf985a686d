"""The port on a two-camera rig against ba_tpu: the five tests of
tests/test_stereo.py, each on both packages.

The reference test's numpy scene (`make_stereo_scene`, FOV cameras 0.5 m
apart) is built from its seed once through ba_tpu's ProblemBuilder and
once through the port's (f64, CPU); the problems agree leaf for leaf to
1e-12, residuals and Jacobians to 1e-10 relative, and `solve` takes the
same iterations to the same result code with final cost, poses and
landmarks within 1e-8.  The reference's assertions then hold on the
port: the reference side transforms through the landmark's reference
camera, and same-pose cross-camera rows are kept and carry depth only.
"""

import numpy as np
import pytest

import test_stereo as ref
from ba_tpu.core.problem import prepare_landmarks as jprepare
from ba_tpu.core.residuals import reprojection as jrep
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core.problem import prepare_landmarks as tprepare
from ba_tpu_torch.core.residuals import reprojection as trep
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_eval_matches, assert_solve_matches,
                               assert_tree_rel, both_scenes)


def _scenes(monkeypatch, **kw):
    want, got = both_scenes(monkeypatch, ref, ref.make_stereo_scene, **kw)
    assert_tree_rel(got[0], want[0], 1e-12)
    assert got[2:4] == want[2:4]                # rows added, skipped
    return want, got


def test_same_pose_cross_camera_rows_kept(monkeypatch):
    _, (problem, _, n_added, n_skipped, _) = _scenes(monkeypatch, n_lms=12)
    assert n_skipped == 12
    pr = problem.proj
    same_pose = (pr.pose == 0) & pr.valid
    assert int(same_pose.sum()) == 12            # all 12 from camera 1
    assert bool((pr.cam[same_pose] == 1).all())


def _evaluated(monkeypatch):
    (jp, jcfg, *_), (tp, tcfg, *_) = _scenes(monkeypatch)
    jp, tp = jprepare(jp, jcfg), tprepare(tp, tcfg)
    ev = trep.evaluate(tp, tcfg, with_jacobians=True)
    assert_eval_matches(ev, jrep.evaluate(jp, jcfg, with_jacobians=True))
    return tp, ev


def test_residuals_zero_at_ground_truth(monkeypatch):
    tp, ev = _evaluated(monkeypatch)
    assert float(ev.r[tp.proj.valid].abs().max()) < 1e-6


def test_same_pose_rows_constrain_depth_only(monkeypatch):
    tp, ev = _evaluated(monkeypatch)
    pr = tp.proj
    same = (pr.pose == tp.lms.ref_pose[pr.lm]) & pr.valid
    assert bool(same.any())
    assert float(ev.j_meas[same].abs().max()) == 0.0
    assert float(ev.j_ref[same].abs().max()) == 0.0
    assert float(ev.j_lm[same].abs().max()) > 1.0


# name -> the reference test's (poses, landmarks, seed)
SOLVES = {"depth_recovery_two_poses": (2, 16, 2),
          "ba_converges": (4, 24, 3)}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_stereo_solve(monkeypatch, name):
    """test_stereo_depth_recovery_two_poses (the same-pose stereo rows are
    the depth signal) and test_stereo_ba_converges."""
    n_poses, n_lms, seed = SOLVES[name]
    (jp, jcfg, *_), (tp, tcfg, *_, lms_w) = _scenes(
        monkeypatch, n_poses=n_poses, n_lms=n_lms, perturb=0.03, seed=seed)
    want = jstep.solve(jp, jcfg, max_iter=20, use_imu=False)
    got = tstep.solve(tp, tcfg, max_iter=20, use_imu=False)
    assert_solve_matches(got, want)
    solved, summary = got
    assert summary.final_cost < 1e-5, summary
    x_w = solved.lms.x_w[:n_lms].numpy()
    np.testing.assert_allclose(x_w[:, :3] / x_w[:, 3:4], lms_w, atol=1e-3)
