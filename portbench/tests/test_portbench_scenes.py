"""The scene generators: published counts, the front end's limits, and
the same scene from the same seed."""

from __future__ import annotations

import torch

from portbench import harness
from portbench.scenes import bal, euroc

from .conftest import tiny


def test_venice_exact_counts():
    cfg = harness.cell("bal-venice.gn-pcg").config
    assert (cfg["cameras"], cfg["points"], cfg["observations"]) == (
        1778, 993923, 5001946)
    k = bal.track_lengths(cfg["points"], cfg["observations"],
                          cfg["geometry"]["max_track"])
    assert k.shape == (993923,)
    assert int(k.sum()) == 5001946
    assert int(k.min()) >= 2 and int(k.max()) <= cfg["geometry"]["max_track"]


def test_venice_cameras_and_observations_at_full_camera_count():
    cl = harness.cell("bal-venice.gn-pcg")
    c = dict(cl.config, points=20000, observations=100651)
    sc = bal.generate(c, cl.mix, 7, "cpu")
    assert sc.n_poses == 1778 and sc.n_lms == 20000
    assert sc.obs_z.shape[0] == 100651
    counts = torch.bincount(sc.obs_lm, minlength=20000)
    assert int(counts.min()) >= 2
    # each point seen at most once by a camera
    key = sc.obs_pose * sc.n_lms + sc.obs_lm
    assert torch.unique(key).shape[0] == key.shape[0]


def test_euroc_front_end_limits():
    cfg = harness.cell("euroc-mh01.fleet128").config
    g = cfg["geometry"]
    n_kf = int(cfg["sequence"]["seconds"] * cfg["sequence"]["keyframe_hz"])
    assert n_kf == 1820
    starts, lens = euroc.track_schedule(n_kf, g["features"], g["track_min"],
                                        g["track_max"])
    assert int(lens.min()) >= 2 and int(lens.max()) <= 20
    live = torch.zeros(n_kf, dtype=torch.long)
    for s, ln in zip(starts.tolist(), lens.tolist()):
        live[s: s + ln] += 1
    assert int(live.max()) <= 150


def test_euroc_scene_rows_per_image():
    cl = tiny("euroc-mh01.fleet128")
    sc = euroc.generate(cl.config, cl.mix, 11, "cpu")
    feats = cl.config["geometry"]["features"]
    # cam0 rows plus the reference views, per keyframe
    cam0 = sc.obs_pose[sc.obs_cam == 0]
    per_kf = torch.bincount(torch.cat([cam0, sc.ref_pose]),
                            minlength=sc.n_poses)
    assert int(per_kf.max()) <= feats
    span = torch.zeros(sc.n_lms, dtype=torch.long).scatter_reduce(
        0, sc.obs_lm, sc.obs_pose, "amax", include_self=False) \
        - sc.ref_pose + 1
    assert int(span.min()) >= 2 and int(span.max()) <= 20
    assert sc.imu_w.shape[1] == 21          # 200 Hz over 10 Hz keyframes


def test_same_seed_same_scene():
    for name in ("bal-venice.gn-pcg", "euroc-mh01.fleet128"):
        cl = tiny(name)
        mod = bal if cl.config["scene"] == "bal" else euroc
        a = mod.generate(cl.config, cl.mix, 2 ** 33 + 5, "cpu")
        b = mod.generate(cl.config, cl.mix, 2 ** 33 + 5, "cpu")
        c = mod.generate(cl.config, cl.mix, 2 ** 33 + 6, "cpu")
        for k, v in a.tensors().items():
            assert torch.equal(v, b.tensors()[k]), (name, k)
        assert not torch.equal(a.obs_z, c.obs_z)
        # another seed, the same sizes
        assert a.obs_z.shape == c.obs_z.shape and a.n_lms == c.n_lms
