"""chip_smoke.py's camera scenes on the CPU, against ba_tpu.

`reference_camera_scene` rebuilds the scenes of ba_tpu's camera-model and
stereo tests with the port alone (the card holds them against the CPU):
each equals the reference test's own scene, built by ba_tpu, leaf for leaf
to 1e-12.  `camera_scene` re-measures the flagship sequence through each
camera variant (poly3, equidistant, per-pose intrinsics, a rig of an FOV
and a poly3 camera): at ground truth every residual vanishes, and on the
perturbed scene with the 11 calibration columns (camera 0's intrinsics
moved) ba_tpu's reprojection residual gives the port's residuals and
Jacobians to 1e-10 relative.  Small sizes (simulate(12 poses, 48
landmarks)).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import ba_tpu.core.problem as jprob
import test_camera_models as ref_models
import test_stereo as ref_stereo
from ba_tpu.core.residuals import reprojection as jrep
from ba_tpu_torch.core import camera as tcam
from ba_tpu_torch.core.problem import prepare_landmarks as tprepare
from ba_tpu_torch.core.residuals import reprojection as trep
from ba_tpu_torch.io import simulate_vins as tsv

from test_torch_common import (assert_eval_matches, assert_rel,
                               assert_tree_rel, jax_problem)

# kind -> the reference test's scene at the sizes chip_smoke.py solves
REFERENCE = {
    "poly3": lambda: ref_models._scene_with_model(
        ref_models.POLY3, tcam.MODEL_POLY3),
    "equidistant": lambda: ref_models._scene_with_model(
        ref_models.EQUI, tcam.MODEL_EQUIDISTANT),
    "per_pose": lambda: ref_models._scene_with_model(
        ref_models.POLY3, tcam.MODEL_POLY3, per_pose=True),
    "stereo": lambda: ref_stereo.make_stereo_scene(
        n_poses=4, n_lms=24, perturb=0.03, seed=3),
}


@pytest.mark.parametrize("kind", sorted(REFERENCE))
def test_reference_scene_is_the_tests_scene(kind):
    jp, jcfg, *rest = REFERENCE[kind]()
    tp, tcfg, lms_w = chip_smoke.reference_camera_scene(kind, "cpu")
    assert_tree_rel(tp, jp, 1e-12)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_rel(lms_w, rest[-1], 0.0, "lms_w")


def _to_jax(tp, template):
    """A ba_tpu problem holding the port problem's values (the structure
    of `template`, a ba_tpu problem)."""
    kw = {}
    for f in dataclasses.fields(template):
        t, w = getattr(tp, f.name), getattr(template, f.name)
        if dataclasses.is_dataclass(w):
            kw[f.name] = _to_jax(t, w)
        elif isinstance(t, torch.Tensor):
            kw[f.name] = jnp.asarray(t.numpy())
        else:
            kw[f.name] = t
    return dataclasses.replace(template, **kw)


@pytest.mark.parametrize("variant", chip_smoke.CAMERA_SCENES)
def test_camera_scene_matches_ba_tpu(variant):
    sim = tsv.simulate(n_poses=12, n_lms=48, seed=0)
    truth, cfg = chip_smoke.camera_scene(sim, variant, device="cpu",
                                         perturb=0.0)
    truth = tprepare(truth, cfg)
    r = trep.evaluate(truth, cfg, with_jacobians=False).r
    assert float(r[truth.proj.valid].abs().max()) < 1e-6
    if variant == "rig":
        pr = truth.proj
        assert bool(((pr.pose == truth.lms.ref_pose[pr.lm])
                     & (pr.cam != truth.lms.ref_cam[pr.lm])).any())
        assert set(truth.lms.ref_cam.tolist()) == {0, 1}
    # the calibration combination: every column of the row (the pose,
    # landmark and 11 calibration tangents), the reference ray from the
    # unprojection through moved intrinsics
    p, cfg = chip_smoke.camera_scene(sim, variant, device="cpu")
    (label, q, c), = [x for x in chip_smoke.k1_combos(tprepare(p, cfg), cfg)
                      if x[0] == " K=11"]
    jc = jprob.BAConfig(**{f.name: getattr(c, f.name)
                           for f in dataclasses.fields(c)})
    assert_eval_matches(trep.evaluate(q, c, True),
                        jrep.evaluate(_to_jax(q, jax_problem()[0]), jc, True),
                        what=f"{variant}{label}")
