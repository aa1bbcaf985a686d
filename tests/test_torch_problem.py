"""The port's simulator, builder and landmark conversion against ba_tpu.

Ints and bools must match exactly, floats to 1e-12 relative (the only
differences are the order of a few f64 operations in the pose
perturbation and the rotation-to-quaternion of the simulator).
"""

import dataclasses

import numpy as np
import pytest

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.io import simulate_vins as tsv

from test_torch_common import (assert_rel, assert_tree_rel, jax_problem,
                               to_torch, torch_config)


def test_simulator_matches():
    js = jsv.simulate(n_poses=12, n_lms=48, seed=0)
    ts = tsv.simulate(n_poses=12, n_lms=48, seed=0)
    for name in ("pose_times", "q_wv", "t_wv", "v_w", "lms_w", "cam_params",
                 "tvs_q", "tvs_t"):
        assert_rel(getattr(ts, name), getattr(js, name), 1e-12, name)
    assert [(i, j) for i, j, _ in ts.obs] == [(i, j) for i, j, _ in js.obs]
    assert_rel(np.stack([z for *_, z in ts.obs]),
               np.stack([z for *_, z in js.obs]), 1e-12, "obs")
    for (tw, ta, tt), (jw, ja, jt) in zip(ts.imu_spans, js.imu_spans):
        assert_rel(tw, jw, 1e-12, "w")
        assert_rel(ta, ja, 1e-12, "a")
        assert_rel(tt, jt, 1e-12, "t")


@pytest.mark.parametrize("pad_multiple,with_marg_prior",
                         [(1, True), (1, False), (4, True), (4, False),
                          (3, True)])
def test_build_problem_matches(pad_multiple, with_marg_prior):
    jp, jcfg, _ = jax_problem(pad_multiple=pad_multiple,
                              with_marg_prior=with_marg_prior)
    sim = tsv.simulate(n_poses=12, n_lms=48, seed=0)
    tp, _, _ = tsv.build_problem(sim, torch_config(jcfg), perturb=0.01,
                                 seed=1, pad_multiple=pad_multiple,
                                 with_marg_prior=with_marg_prior,
                                 device="cpu")
    assert_tree_rel(tp, jp, 1e-12)
    if pad_multiple > 1:
        assert not bool(tp.proj.valid.all())     # padded projection rows
    if pad_multiple == 3:
        # W-block padding rows carry the out-of-range landmark id L
        assert int((tp.pidx.wb_lm == tp.lms.x.shape[0]).sum()) > 0


def _fill(builder, mod):
    """The same hand-built scene through either package's ProblemBuilder:
    priors, a binary edge, a manual mask, an inactive pose."""
    rng = np.random.default_rng(3)
    builder.add_camera([300.0, 300.0, 320.0, 240.0, 0.9], mod.MODEL_FOV)
    for i in range(5):
        builder.add_pose([1.0, 0, 0, 0], [0.5 * i, 0.1 * i, 0.0],
                         active=i > 0, time=0.5 * i)
    for j in range(6):
        builder.add_landmark(rng.normal(size=3) + [0, 0, 5.0], ref_pose=j % 4)
    for j in range(6):
        for i in range(5):
            builder.add_projection_residual(rng.normal(size=2) * 5 + 300, i,
                                            j, 0, weight=1.0 + 0.1 * i)
    cov = np.diag(rng.uniform(0.5, 2.0, 6))
    builder.add_unary_constraint(1, [1.0, 0, 0, 0], [0.5, 0.1, 0], cov=cov)
    builder.add_binary_constraint(3, 1, [1.0, 0, 0, 0], [1.0, 0.2, 0])
    builder.regularize_pose(2, translation=False, gravity=True)
    return builder


def test_problem_builder_matches_with_priors():
    from ba_tpu.core import camera as jcam
    from ba_tpu_torch.core import camera as tcam

    jcfg = jprob.BAConfig(pose_dim=6)
    jp = _fill(jprob.ProblemBuilder(jcfg), jcam).build(pad_multiple=4)
    tp = _fill(tprob.ProblemBuilder(torch_config(jcfg)), tcam).build(
        pad_multiple=4, device="cpu")
    assert_tree_rel(tp, jp, 1e-12)


def test_prepare_and_finalize_landmarks_match():
    jp, jcfg, _ = jax_problem(pad_multiple=4)
    tcfg = torch_config(jcfg)
    jq = jprob.prepare_landmarks(jp, jcfg)
    tq = tprob.prepare_landmarks(to_torch(jp), tcfg)
    assert_rel(tq.lms.x, jq.lms.x, 1e-12, "x")
    # move the inverse depths so finalize has something to convert
    jq = dataclasses.replace(jq, lms=dataclasses.replace(
        jq.lms, x=jq.lms.x.at[:, 3].multiply(1.1)))
    tq = dataclasses.replace(tq, lms=dataclasses.replace(
        tq.lms, x=to_torch(jq).lms.x))
    assert_rel(tprob.finalize_landmarks(tq, tcfg).lms.x_w,
               jprob.finalize_landmarks(jq, jcfg).lms.x_w, 1e-12, "x_w")
