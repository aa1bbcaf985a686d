"""Ring-buffer fixed-lag smoother: O(window) slides, independent of
trajectory length.

Port of `ba_tpu/solver/fixedlag.py`.  The window lives in a ring of W pose
slots (slot = global_id % W) and L_w landmark slots (slot = lm_id % L_w;
alive landmark ids are a contiguous range, so the map is collision-free).
Each slide, on host-built per-slide tables:

  1. overwrites the retired slots with the incoming pose / landmarks
     (initial guesses from the dataset),
  2. builds the compact W-pose Problem from the carried slot states and the
     slide's residual and structure tables,
  3. runs `solve_fixed` (GN iterations) on the compact problem,
  4. marginalizes the retiring pose into the compact (W*D)^2 FEJ prior
     (`window.apply_marginalization`; its slot rows are zeroed, ready for
     reuse).

The slide's assembly plan is built once and serves the solve's builds and
the marginalization.  `run_ring` is a Python loop over the slides, reading
each slide's tables from the stacked tensors on the device, where ba_tpu
runs one `lax.scan`.

Restrictions (asserted): no calibration block, no per-pose cam params,
fresh problem (no pre-existing marginalization prior).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.problem import (BAConfig, BinaryResiduals, ImuResiduals,
                            LandmarkStates, PoseStates, Problem,
                            ProblemIndex, ProjResiduals, UnaryResiduals,
                            build_structure_index, empty_marg_prior)
from .assemble import assembly_plan


@dataclasses.dataclass
class RingSchedule:
    """Host-built per-slide tables, stacked along a leading n_slides axis
    on the problem's device, and the initial ring state."""

    W: int                       # pose slots (window length)
    L_w: int                     # landmark slots
    n_slides: int
    inputs: Dict[str, Any]       # stacked tables; "pidx" a ProblemIndex
    carry0: Tuple                # (q, t, v, b, lm_x, marg)
    rig: Any
    g_vec: Any


def _pad_rows(a, n, fill=0):
    a = np.asarray(a)
    if a.shape[0] >= n:
        return a[:n]
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _np(t):
    return t.detach().cpu().numpy()


def slot_index(d, W: int, L_w: int) -> ProblemIndex:
    """The structure index of one slide's tables `d` over slot ids: sets
    the per-row pair / W-block fields of `d` and returns the ProblemIndex
    tables as numpy arrays (unpadded)."""
    per_row, px = build_structure_index(
        d["proj_pose"], d["lm_ref_pose"][d["proj_lm"]], d["proj_lm"],
        d["proj_valid"], d["binary_pose1"], d["binary_pose2"],
        d["binary_valid"], d["imu_pose1"], d["imu_pose2"], d["imu_valid"],
        W, L_w, device="cpu")
    d["proj_pair"] = per_row["pair"]
    d["proj_pair_swap"] = per_row["pair_swap"]
    d["proj_wb_meas"] = per_row["wb_meas"]
    d["proj_wb_ref"] = per_row["wb_ref"]
    d["binary_pair"] = per_row["bpair"]
    d["binary_pair_swap"] = per_row["bswap"]
    d["imu_pair"] = per_row["ipair"]
    d["imu_pair_swap"] = per_row["iswap"]
    return ProblemIndex(**{f.name: getattr(px, f.name).numpy()
                           for f in dataclasses.fields(ProblemIndex)})


def build_ring_schedule(problem: Problem, config: BAConfig, W: int,
                        n_slides: int | None = None) -> RingSchedule:
    """Slice a full (already `prepare_landmarks`-ed) trajectory problem
    into per-slide compact window tables, on the problem's device.

    Slide k solves the window of global poses [k, k+W) and retires pose k;
    pose k+W and the landmarks anchored in the window enter at slide k+1.
    Host cost is O(n_slides * window-table size), a one-time offline build;
    `streaming.StreamingRing` builds the same tables one keyframe at a
    time."""
    assert config.calib_dim == 0, "ring window: no calibration block"
    assert not config.use_per_pose_cam_params
    assert problem.marg.H.shape[0] != problem.poses.q.shape[0] * \
        config.pose_dim or not bool(problem.marg.active), \
        "ring window needs a fresh problem (no marg prior)"

    dev = problem.poses.t.device
    po = problem.poses
    P_full = int(po.q.shape[0])
    if n_slides is None:
        n_slides = P_full - W
    assert 0 < n_slides <= P_full - W + 1

    ref_pose = _np(problem.lms.ref_pose)
    lm_active = _np(problem.lms.active)
    pr_pose = _np(problem.proj.pose)
    pr_lm = _np(problem.proj.lm)
    pr_valid = _np(problem.proj.valid)
    i1 = _np(problem.imu.pose1)
    i2 = _np(problem.imu.pose2)
    iv = _np(problem.imu.valid)
    u_pose = _np(problem.unary.pose)
    uv = _np(problem.unary.valid)
    b1 = _np(problem.binary.pose1)
    b2 = _np(problem.binary.pose2)
    bv = _np(problem.binary.valid)
    pn = {f: _np(getattr(po, f)) for f in ("q", "t", "v", "b", "time",
                                          "mask", "cam_params")}
    ln = {f: _np(getattr(problem.lms, f)) for f in ("ref_cam", "z_ref",
                                                   "has_z_ref", "x_w", "x")}
    prn = {f: _np(getattr(problem.proj, f)) for f in ("z", "cam", "weight",
                                                     "cond")}
    imn = {f: _np(getattr(problem.imu, f)) for f in ("w", "a", "time",
                                                    "meas_valid", "weight",
                                                    "cond")}
    un = {f: _np(getattr(problem.unary, f)) for f in ("q", "t", "cov_inv")}
    bn = {f: _np(getattr(problem.binary, f)) for f in ("q", "t", "cov_inv")}

    # pass 1: per-slide row sets and landmark sets
    slides = []
    for k in range(n_slides):
        def in_win(p):
            return (p >= k) & (p < k + W)
        alive = lm_active & in_win(ref_pose)
        lm_ids = np.where(alive)[0]
        rows_p = np.where(pr_valid & alive[pr_lm] & in_win(pr_pose))[0]
        rows_i = np.where(iv & in_win(i1) & in_win(i2))[0]
        rows_u = np.where(uv & in_win(u_pose))[0]
        rows_b = np.where(bv & in_win(b1) & in_win(b2))[0]
        slides.append((lm_ids, rows_p, rows_i, rows_u, rows_b))

    # L_w must make slot = id % L_w collision-free within every slide: any
    # L_w >= each slide's id span works, so take the max over slides of
    # max(count, span) in one pass
    L_w = max(
        max(len(lm_ids),
            int(lm_ids.max() - lm_ids.min() + 1) if len(lm_ids) else 0)
        for lm_ids, *_ in slides)
    L_w = max(L_w, 1)
    for lm_ids, *_ in slides:
        assert len(np.unique(lm_ids % L_w)) == len(lm_ids), \
            "landmark ids alive in one window must map 1:1 under mod L_w"
    Np = max(max(len(s[1]) for s in slides), 1)
    Ni = max(max(len(s[2]) for s in slides), 1)
    Nu = max(max(len(s[3]) for s in slides), 1)
    Nb = max(max(len(s[4]) for s in slides), 1)

    lm_x0 = ln["x"]                             # prepared initial states

    per_slide = []
    prev_lm = np.zeros(0, np.int64)
    for k in range(n_slides):
        lm_ids, rows_p, rows_i, rows_u, rows_b = slides[k]
        lm_slot_of = np.zeros(lm_x0.shape[0], np.int64)
        lm_slot_of[lm_ids] = lm_ids % L_w

        d: Dict[str, Any] = {}
        # ---- pose-slot aux (gather window rows into slots) ----
        win = np.arange(k, k + W)
        inv = np.zeros(W, np.int64)
        inv[win % W] = win                    # global id in each slot
        d["pose_time"] = pn["time"][inv]
        d["pose_mask"] = pn["mask"][inv]
        d["pose_cam_params"] = pn["cam_params"][inv]
        d["pose_active"] = np.ones(W, bool)
        # incoming pose: at k=0 the whole window loads via carry0; later
        # only global pose k+W-1 (slot (k-1) % W) is new
        new_mask = np.zeros(W, bool)
        if k > 0:
            new_mask[(k + W - 1) % W] = True
        d["new_pose_mask"] = new_mask
        for f in ("q", "t", "v", "b"):
            d[f"new_{f}"] = pn[f][inv]

        # ---- landmark slots ----
        lmg = np.zeros(L_w, np.int64)         # global lm id per slot
        lmg[lm_ids % L_w] = lm_ids
        lm_alive = np.zeros(L_w, bool)
        lm_alive[lm_ids % L_w] = True
        d["lm_ref_pose"] = np.where(
            lm_alive, ref_pose[lmg] % W, 0).astype(np.int32)
        d["lm_ref_cam"] = np.where(lm_alive, ln["ref_cam"][lmg],
                                   0).astype(np.int32)
        d["lm_active"] = lm_alive
        d["lm_z_ref"] = np.where(lm_alive[:, None], ln["z_ref"][lmg], 0.0)
        d["lm_has_z_ref"] = np.where(lm_alive, ln["has_z_ref"][lmg], False)
        d["lm_x_w"] = np.where(lm_alive[:, None], ln["x_w"][lmg], 0.0)
        new_lms = np.setdiff1d(lm_ids, prev_lm) if k else lm_ids
        nl_mask = np.zeros(L_w, bool)
        nl_mask[new_lms % L_w] = True
        if k == 0:
            nl_mask[:] = False                # k=0 loads via carry0
        d["new_lm_mask"] = nl_mask
        d["new_lm_x"] = np.where(nl_mask[:, None], lm_x0[lmg], 0.0)
        prev_lm = lm_ids

        # ---- residual tables (slot ids, padded) ----
        d["proj_z"] = _pad_rows(prn["z"][rows_p], Np)
        d["proj_pose"] = _pad_rows(pr_pose[rows_p] % W, Np).astype(np.int32)
        d["proj_lm"] = _pad_rows(lm_slot_of[pr_lm[rows_p]],
                                 Np).astype(np.int32)
        d["proj_cam"] = _pad_rows(prn["cam"][rows_p], Np).astype(np.int32)
        d["proj_weight"] = _pad_rows(prn["weight"][rows_p], Np)
        d["proj_valid"] = _pad_rows(np.ones(len(rows_p), bool), Np, False)
        d["proj_cond"] = _pad_rows(prn["cond"][rows_p], Np, False)

        d["imu_pose1"] = _pad_rows(i1[rows_i] % W, Ni).astype(np.int32)
        d["imu_pose2"] = _pad_rows(i2[rows_i] % W, Ni).astype(np.int32)
        d["imu_w"] = _pad_rows(imn["w"][rows_i], Ni)
        d["imu_a"] = _pad_rows(imn["a"][rows_i], Ni)
        d["imu_time"] = _pad_rows(imn["time"][rows_i], Ni)
        d["imu_meas_valid"] = _pad_rows(imn["meas_valid"][rows_i], Ni,
                                        False)
        d["imu_weight"] = _pad_rows(imn["weight"][rows_i], Ni, 1)
        d["imu_valid"] = _pad_rows(np.ones(len(rows_i), bool), Ni, False)
        d["imu_cond"] = _pad_rows(imn["cond"][rows_i], Ni, False)

        d["unary_pose"] = _pad_rows(u_pose[rows_u] % W, Nu).astype(np.int32)
        d["unary_q"] = _pad_rows(un["q"][rows_u], Nu)
        d["unary_q"][len(rows_u):, 0] = 1.0
        d["unary_t"] = _pad_rows(un["t"][rows_u], Nu)
        d["unary_cov_inv"] = _pad_rows(un["cov_inv"][rows_u], Nu)
        d["unary_valid"] = _pad_rows(np.ones(len(rows_u), bool), Nu, False)

        d["binary_pose1"] = _pad_rows(b1[rows_b] % W, Nb).astype(np.int32)
        d["binary_pose2"] = _pad_rows(b2[rows_b] % W, Nb).astype(np.int32)
        d["binary_q"] = _pad_rows(bn["q"][rows_b], Nb)
        d["binary_q"][len(rows_b):, 0] = 1.0
        d["binary_t"] = _pad_rows(bn["t"][rows_b], Nb)
        d["binary_cov_inv"] = _pad_rows(bn["cov_inv"][rows_b], Nb)
        d["binary_valid"] = _pad_rows(np.ones(len(rows_b), bool), Nb,
                                      False)

        d["pidx"] = slot_index(d, W, L_w)
        d["drop_slot"] = np.int32(k % W)
        per_slide.append(d)

    # pad the per-slide ProblemIndex tables to common shapes and stack all
    def table_max(name):
        return max(getattr(s["pidx"], name).shape[0] for s in per_slide)

    fill = {"sp_valid": False}
    lead = {"pair_b": "pair_a", "wb_lm": "wb_pose", "bpair_b": "bpair_a",
            "ipair_b": "ipair_a", "sp_j": "sp_i", "sp_valid": "sp_i"}
    fields = [f.name for f in dataclasses.fields(ProblemIndex)]
    tmax = {n: table_max(lead.get(n, n)) for n in fields}

    def stack(xs):
        return torch.as_tensor(np.stack(xs), device=dev)

    inputs = {key: stack([s[key] for s in per_slide])
              for key in per_slide[0] if key != "pidx"}
    inputs["pidx"] = ProblemIndex(**{
        n: stack([_pad_rows(getattr(s["pidx"], n), tmax[n],
                            fill.get(n, 0)) for s in per_slide])
        for n in fields})

    # initial carry: window [0, W) states + alive-lm slot states
    lm_ids0 = slides[0][0]
    lx0 = np.zeros((L_w,) + lm_x0.shape[1:], lm_x0.dtype)
    lx0[lm_ids0 % L_w] = lm_x0[lm_ids0]
    marg0 = empty_marg_prior(W, config.pose_dim, po.t.dtype, dev)
    carry0 = tuple(torch.as_tensor(pn[f][:W], device=dev)
                   for f in ("q", "t", "v", "b")) + (
        torch.as_tensor(lx0, device=dev), marg0)
    return RingSchedule(W=W, L_w=L_w, n_slides=n_slides, inputs=inputs,
                        carry0=carry0, rig=problem.rig, g_vec=problem.g_vec)


def slide_inputs(inputs, k: int):
    """Slide k's tables: views of the stacked tensors."""
    return {name: (ProblemIndex(**{f.name: getattr(v, f.name)[k]
                                   for f in dataclasses.fields(v)})
                   if name == "pidx" else v[k])
            for name, v in inputs.items()}


def run_ring(schedule: RingSchedule, config: BAConfig, use_imu: bool,
             iters_per_slide: int, gn_damping: float = 1.0):
    """Run the ring pipeline; returns (final_carry, outs) where outs is a
    dict of per-slide stacks: `cost` (last GN cost) and the retired
    keyframe's post-solve estimate `q`/`t`/`v`/`b`, i.e. the smoother's
    optimized trajectory for poses [0, n_slides).  Per-slide work is
    O(W), not O(P_total)."""
    carry = schedule.carry0
    outs = []
    for k in range(schedule.n_slides):
        carry, out = ring_slide_step(
            carry, slide_inputs(schedule.inputs, k), schedule.rig,
            schedule.g_vec, config, use_imu, iters_per_slide, schedule.W,
            schedule.L_w, gn_damping)
        outs.append(out)
    return carry, {key: torch.stack([o[key] for o in outs])
                   for key in outs[0]}


def slide_problem(carry, inp, rig, g_vec, L_w: int):
    """(compact W-pose Problem, carried prior) of one slide: the incoming
    pose and landmarks loaded into their slots of the carried states, and
    the slide's residual and structure tables."""
    q, t, v, b, lx, marg = carry
    nm = inp["new_pose_mask"][:, None]
    q = torch.where(nm, inp["new_q"], q)
    t = torch.where(nm, inp["new_t"], t)
    v = torch.where(nm, inp["new_v"], v)
    b = torch.where(nm, inp["new_b"], b)
    lx = torch.where(inp["new_lm_mask"][:, None], inp["new_lm_x"], lx)
    # refresh the prior's linearization rows for re-used slots (their H
    # rows are zero, so this only keeps the carried state coherent)
    marg = dataclasses.replace(
        marg,
        lin_q=torch.where(nm, inp["new_q"], marg.lin_q),
        lin_t=torch.where(nm, inp["new_t"], marg.lin_t),
        lin_v=torch.where(nm, inp["new_v"], marg.lin_v),
        lin_b=torch.where(nm, inp["new_b"], marg.lin_b))

    dev, dtype = t.device, t.dtype
    poses = PoseStates(q=q, t=t, v=v, b=b, time=inp["pose_time"],
                       active=inp["pose_active"], mask=inp["pose_mask"],
                       cam_params=inp["pose_cam_params"])
    lms = LandmarkStates(x=lx, x_w=inp["lm_x_w"],
                         ref_pose=inp["lm_ref_pose"],
                         ref_cam=inp["lm_ref_cam"],
                         active=inp["lm_active"],
                         reliable=torch.ones(L_w, dtype=torch.bool,
                                             device=dev),
                         z_ref=inp["lm_z_ref"],
                         has_z_ref=inp["lm_has_z_ref"])
    proj = ProjResiduals(z=inp["proj_z"], pose=inp["proj_pose"],
                         lm=inp["proj_lm"], cam=inp["proj_cam"],
                         weight=inp["proj_weight"], valid=inp["proj_valid"],
                         cond=inp["proj_cond"], pair=inp["proj_pair"],
                         pair_swap=inp["proj_pair_swap"],
                         wb_meas=inp["proj_wb_meas"],
                         wb_ref=inp["proj_wb_ref"])
    unary = UnaryResiduals(pose=inp["unary_pose"], q=inp["unary_q"],
                           t=inp["unary_t"], cov_inv=inp["unary_cov_inv"],
                           valid=inp["unary_valid"])
    binary = BinaryResiduals(pose1=inp["binary_pose1"],
                             pose2=inp["binary_pose2"], q=inp["binary_q"],
                             t=inp["binary_t"],
                             cov_inv=inp["binary_cov_inv"],
                             valid=inp["binary_valid"],
                             pair=inp["binary_pair"],
                             pair_swap=inp["binary_pair_swap"])
    imu = ImuResiduals(pose1=inp["imu_pose1"], pose2=inp["imu_pose2"],
                       w=inp["imu_w"], a=inp["imu_a"], time=inp["imu_time"],
                       meas_valid=inp["imu_meas_valid"],
                       weight=inp["imu_weight"], valid=inp["imu_valid"],
                       cond=inp["imu_cond"], pair=inp["imu_pair"],
                       pair_swap=inp["imu_pair_swap"],
                       c9=torch.zeros((inp["imu_pose1"].shape[0], 9, 9),
                                      dtype=dtype, device=dev),
                       c9_set=torch.zeros((), dtype=torch.bool, device=dev))
    return Problem(poses=poses, lms=lms, rig=rig, proj=proj, unary=unary,
                   binary=binary, imu=imu, g_vec=g_vec, marg=marg,
                   pidx=inp["pidx"])


def ring_slide_step(carry, inp, rig, g_vec, config: BAConfig,
                    use_imu: bool, iters_per_slide: int, W: int, L_w: int,
                    gn_damping: float = 1.0):
    """One slide of the ring pipeline: load incoming pose/landmarks into
    their slots, solve the compact W-pose window, marginalize the retiring
    pose, emit its post-solve estimate.  Shared by the batch loop
    (`run_ring`) and the online smoother (`streaming.StreamingRing`)."""
    from .step import solve_fixed
    from .window import apply_marginalization

    problem = slide_problem(carry, inp, rig, g_vec, L_w)
    plan = assembly_plan(problem, config)
    problem, costs, _ = solve_fixed(problem, config, use_imu,
                                    iters_per_slide, gn_damping, plan=plan)
    drop = torch.arange(W, device=costs.device) == inp["drop_slot"]
    # a banded solve's plan does not serve the general-path marginalization
    p2 = apply_marginalization(problem, config, use_imu, drop,
                               None if plan.band_width else plan)
    new_carry = (p2.poses.q, p2.poses.t, p2.poses.v, p2.poses.b,
                 p2.lms.x, p2.marg)
    # the retiring pose's post-solve estimate is the smoother's output for
    # that keyframe (an index tensor, not a Python int: no host read)
    s = inp["drop_slot"].reshape(1).long()
    out = dict(cost=costs[-1], q=p2.poses.q[s][0], t=p2.poses.t[s][0],
               v=p2.poses.v[s][0], b=p2.poses.b[s][0])
    return new_carry, out
