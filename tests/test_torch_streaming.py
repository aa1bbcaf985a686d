"""The port's online streaming smoother against its batch ring and ba_tpu.

`StreamingRing` takes one keyframe and its measurements at a time and
builds each slide's tables on the host.  Those tables equal the port's
batch schedule (`fixedlag.build_ring_schedule`) field by field, exactly,
and the landmarks it prepares on the device equal the batch's prepared
states.  Its retired trajectory equals the port's `run_ring` on the batch
schedule to 1e-10 relative (the same slide step on the same values; only
the packing differs) and ba_tpu's `StreamingRing` to 1e-8 (roundoff of
two solves and a marginalization per slide).  `push` returns None until W
keyframes are in, then one retired keyframe per keyframe.  10 poses,
W = 4, 2 iterations, f64 on the CPU.
"""

import dataclasses
import functools

import numpy as np
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import streaming as jst
from ba_tpu_torch.apps.vins_stream import add_keyframe, stream_feed
from ba_tpu_torch.solver import fixedlag as tfl
from ba_tpu_torch.solver import streaming as tst

from test_torch_common import assert_rel, to_torch, torch_config

W, ITERS, N_POSES = 4, 2, 10
PIDX = ("pair_a", "pair_b", "wb_pose", "wb_lm", "bpair_a", "bpair_b",
        "ipair_a", "ipair_b", "sp_i", "sp_j", "sp_valid")


@functools.lru_cache(maxsize=None)
def case():
    """(JAX problem, JAX config, port problem, port config, port batch
    schedule, capacities)."""
    cfg = jprob.BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=N_POSES, n_lms=40, seed=2)
    jp, _, _ = jsv.build_problem(sim, cfg, perturb=0.01, seed=3,
                                 with_marg_prior=False)
    jp = jprob.prepare_landmarks(jp, cfg)
    tp, tcfg = to_torch(jp), torch_config(cfg)
    sched = tfl.build_ring_schedule(tp, tcfg, W, N_POSES - W + 1)
    return jp, cfg, tp, tcfg, sched, tst.RingCapacities.from_schedule(sched)


def _feed(ring, problem):
    """Push every keyframe of `problem`; returns each push's result."""
    feed = stream_feed(problem)
    pushes = []
    for g in range(N_POSES):
        add_keyframe(ring, feed, g)
        pushes.append(ring.push())
    return pushes


@functools.lru_cache(maxsize=None)
def port_stream():
    """(ring, push results, {slide: tables}) of the port's StreamingRing."""
    _, _, tp, tcfg, _, caps = case()
    ring = tst.StreamingRing(tcfg, W, tp.rig, tp.g_vec, caps, use_imu=True,
                             iters_per_slide=ITERS, device="cpu")
    tables = {}
    build = ring._slide_tables
    ring._slide_tables = lambda k: tables.setdefault(k, build(k))
    return ring, _feed(ring, tp), tables


def test_streaming_slide_tables_equal_the_batch_schedule():
    _, _, tp, tcfg, sched, _ = case()
    _, _, tables = port_stream()
    assert sorted(tables) == list(range(sched.n_slides))
    inp = sched.inputs
    for k, d in tables.items():
        for key, val in d.items():
            if key in PIDX:
                want = getattr(inp["pidx"], key)[k]
            elif key in ("pose_cam_params", "lm_x_w", "drop_slot",
                         "new_lm_mask"):
                continue                 # layout-local, checked below
            else:
                want = inp[key][k]
            assert_rel(val, want.numpy(), 0.0, f"slide {k} {key}")
        assert int(d["drop_slot"][0]) == k % W
        # the device-side preparation of the incoming landmarks gives the
        # batch's prepared states
        t = {key: torch.as_tensor(d[key]) for key in
             ("lm_x_w", "new_q", "new_t", "lm_ref_cam", "lm_z_ref",
              "lm_has_z_ref", "lm_ref_pose")}
        rp = t["lm_ref_pose"].long()
        x = tst.prepare_rows(t["lm_x_w"], t["new_q"][rp], t["new_t"][rp],
                             tp.rig, t["lm_ref_cam"], t["lm_z_ref"],
                             t["lm_has_z_ref"], tcfg)
        eff = np.where(d["new_lm_mask"][:, None], x.numpy(), 0.0)
        if k == 0:
            # slide 0 loads through new_lm_mask, the batch through carry0
            assert_rel(d["new_lm_mask"], d["lm_active"], 0.0, "slide 0")
            assert_rel(eff, sched.carry0[4].numpy(), 1e-15, "carry0 lx")
        else:
            assert_rel(d["new_lm_mask"], inp["new_lm_mask"][k].numpy(),
                       0.0, f"slide {k} new_lm_mask")
            assert_rel(eff, inp["new_lm_x"][k].numpy(), 1e-15,
                       f"slide {k} new_lm_x")


def test_streaming_trajectory_matches_run_ring_and_ba_tpu():
    jp, jcfg, _, tcfg, sched, caps = case()
    _, pushes, _ = port_stream()
    outs = [o for o in pushes if o is not None]
    _, batch = tfl.run_ring(sched, tcfg, True, ITERS)
    jring = jst.StreamingRing(jcfg, W, jp.rig, jp.g_vec,
                              jst.RingCapacities(**dataclasses.asdict(caps)),
                              use_imu=True, iters_per_slide=ITERS)
    jouts = [o for o in _feed(jring, case()[2]) if o is not None]
    assert len(outs) == len(jouts) == sched.n_slides
    for k, (o, jo) in enumerate(zip(outs, jouts)):
        for key in ("cost", "q", "t", "v", "b"):
            assert_rel(o[key], batch[key][k].numpy(), 1e-10,
                       f"slide {k} {key} vs run_ring")
            assert_rel(o[key], np.asarray(jo[key]), 1e-8,
                       f"slide {k} {key} vs ba_tpu")
    assert outs[-1]["cost"] < 1e-4


def test_streaming_push_cadence_and_window_buffers():
    ring, pushes, _ = port_stream()
    assert all(o is None for o in pushes[:W - 1])
    assert [o["pose"] for o in pushes[W - 1:]] == list(
        range(N_POSES - W + 1))
    assert all(isinstance(o["t"], np.ndarray) and o["t"].shape == (3,)
               for o in pushes[W - 1:])
    # buffers hold the live window only
    assert len(ring._poses) <= W
    assert all(d["ref_pose"] > pushes[-1]["pose"]
               for d in ring._lms.values())
    win = ring.current_window()
    assert win["q"].shape == (W, 4)
