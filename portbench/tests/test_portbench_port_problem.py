"""`scenes.port.problem` builds, in bulk, the same `Problem` the program's
per-observation `ProblemBuilder` builds from the same scene."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import program
from portbench.scenes import bal, euroc, port

from .conftest import tiny


def _builder_problem(sc, cfg, dtype):
    from ba_tpu_torch.core.problem import ProblemBuilder

    b = ProblemBuilder(cfg, dtype=np.float32 if dtype == torch.float32
                       else np.float64)
    b.set_gravity(sc.gravity.numpy())
    for c in range(sc.cam.shape[0]):
        b.add_camera(sc.cam[c].numpy(), int(sc.cam_model[c]),
                     tvs_q=sc.tvs_q[c].numpy(), tvs_t=sc.tvs_t[c].numpy())
    for p in range(sc.n_poses):
        b.add_pose(sc.q[p].numpy(), sc.t[p].numpy(), v=sc.v[p].numpy(),
                   b=sc.b[p].numpy(), active=bool(sc.active[p]),
                   time=float(sc.time[p]),
                   cam_params=sc.cam_params[p].numpy())
    for i in range(sc.n_lms):
        b.add_landmark(sc.x_w[i].numpy(), int(sc.ref_pose[i]),
                       int(sc.ref_cam[i]))
    if sc.inverse_depth:
        # the reference views, which the builder records as z_ref
        for i in range(sc.n_lms):
            b.add_projection_residual(sc.z_ref[i].numpy(),
                                      int(sc.ref_pose[i]), i,
                                      int(sc.ref_cam[i]))
    for n in range(sc.obs_z.shape[0]):
        b.add_projection_residual(sc.obs_z[n].numpy(), int(sc.obs_pose[n]),
                                  int(sc.obs_lm[n]), int(sc.obs_cam[n]))
    for s in range(sc.imu_pose1.shape[0]):
        b.add_imu_residual(int(sc.imu_pose1[s]), int(sc.imu_pose2[s]),
                           sc.imu_w[s].numpy(), sc.imu_a[s].numpy(),
                           sc.imu_time[s].numpy())
    return b.build(with_marg_prior=False, device="cpu")


def _leaves(x, prefix=""):
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, x


@pytest.mark.parametrize("name", ["bal-venice.gn-pcg", "euroc-mh01.fleet128"])
def test_bulk_problem_equals_builder(name):
    cl = tiny(name)
    mod = bal if cl.config["scene"] == "bal" else euroc
    sc = mod.generate(cl.config, cl.mix, 99, "cpu").rounded(torch.float32)
    sc = dataclasses.replace(sc, **{k: v.float() for k, v in
                                    sc.tensors().items()
                                    if v.is_floating_point()})
    cfg, _ = program.port_config(cl.config, cl.mix)
    got = port.problem(sc, cfg, torch.float32, "cpu")
    want = _builder_problem(sc, cfg, torch.float32)
    for (k, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype, k
        assert a.shape == b.shape, k
        assert torch.equal(a, b), k
