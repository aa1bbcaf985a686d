"""Problem container: structure-of-arrays, static shapes, masks.

Port of `ba_tpu/core/problem.py`.  Every residual row carries the integer
ids of the states it touches; inactive or padded entries are masked rather
than removed; gauge fixing is a per-dimension boolean mask.  The states are
plain dataclasses of tensors (the port's pytrees, see `utils/tree.py`);
`BAConfig` is a field-for-field copy of the reference's static
configuration.  The host tables and the builder are numpy, and the builder
emits tensors on the device it is given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import camera as cam_mod
from . import lie

# ---------------------------------------------------------------------------
# Static configuration (the reference's template parameters + Options)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BAConfig:
    """Static solver configuration (fields and defaults as `ba_tpu`'s).

    Only part of it is ported yet: see the NotImplementedError raises in
    solver/ for the options whose code paths are still to be ported.
    """

    pose_dim: int = 6          # 6 (SE3) | 9 (+vel) | 15 (+gyro/accel bias)
    lm_size: int = 1           # 0 (pose graph) | 1 (inverse depth) | 3 (XYZ)
    calib_size: int = 0        # 0 | 5 (camera intrinsics)
    do_tvs: bool = False       # optimize camera-from-vehicle extrinsics
    tvs_translation_staging: bool = False
    tvs_translation_active: bool = True
    use_per_pose_cam_params: bool = False

    # step control
    use_dogleg: bool = True
    trust_region_size: float = -1.0       # kTrustRegionAuto
    dogleg_max_inner_iterations: int = 100
    error_change_threshold: float = 0.01
    param_change_threshold: float = 1e-3

    # reduced-system solver
    use_cg_solver: bool = False
    cg_max_iterations: int = 100
    cg_tolerance: float = 1e-6

    # block half-bandwidth + 1 of the pose Hessian (banded-grid assembly
    # when > 0; set it with `solver.assemble.band_width_of(problem)`)
    band_width: int = 0
    use_banded_solver: bool = False
    banded_pcg_iterations: int = 0
    banded_cyclic_reduction: bool = True
    banded_chunk: int = 0
    fleet_size: int = 1
    schur_on_band: bool = False

    # robust norm
    use_robust_norm_for_proj_residuals: bool = True
    use_robust_norm_for_unary_residuals: bool = False
    use_robust_norm_for_inertial_residuals: bool = False
    outlier_threshold: float = 1.0

    # IMU noise model
    gyro_sigma: float = 1.3088444e-3
    accel_sigma: float = 1.6968e-2
    gyro_bias_sigma: float = 1.3088444e-4
    accel_bias_sigma: float = 1.6968e-3
    gravity: float = lie.GRAVITY

    regularize_biases_in_batch: bool = True
    enable_auto_regularization: bool = True
    calculate_inertial_covariance_once: bool = False
    imu_rotation_only: bool = False

    calculate_calibration_marginals: bool = False
    write_reduced_camera_matrix: str = ""

    @property
    def vel_in_state(self) -> bool:
        return self.pose_dim >= 9

    @property
    def bias_in_state(self) -> bool:
        return self.pose_dim >= 15

    @property
    def calib_dim(self) -> int:
        return self.calib_size + (6 if self.do_tvs else 0)

    @property
    def tvs_offset(self) -> int:
        return self.calib_size


# ---------------------------------------------------------------------------
# State containers (field names and order as in ba_tpu)
# ---------------------------------------------------------------------------


@dataclass
class PoseStates:
    q: torch.Tensor          # (P, 4) world-from-vehicle rotation, wxyz
    t: torch.Tensor          # (P, 3)
    v: torch.Tensor          # (P, 3) velocity in world
    b: torch.Tensor          # (P, 6) [gyro bias, accel bias]
    time: torch.Tensor       # (P,)
    active: torch.Tensor     # (P,) bool
    mask: torch.Tensor       # (P, 15) bool — per-dim optimize flag
    cam_params: torch.Tensor  # (P, MAX_PARAMS) per-pose intrinsics


@dataclass
class LandmarkStates:
    """`x` is (L, 4): lm_size 1 -> unit sensor ray + inverse depth x[3];
    lm_size 3 -> world xyz + 1.  `x_w` keeps the world point."""

    x: torch.Tensor          # (L, 4)
    x_w: torch.Tensor        # (L, 4)
    ref_pose: torch.Tensor   # (L,) int32
    ref_cam: torch.Tensor    # (L,) int32
    active: torch.Tensor     # (L,) bool
    reliable: torch.Tensor   # (L,) bool
    z_ref: torch.Tensor      # (L, 2) reference-view pixel
    has_z_ref: torch.Tensor  # (L,) bool


@dataclass
class Rig:
    params: torch.Tensor     # (C, MAX_PARAMS)
    model: torch.Tensor      # (C,) int32 — camera.MODEL_*
    tvs_q: torch.Tensor      # (C, 4)
    tvs_t: torch.Tensor      # (C, 3)


@dataclass
class ProjResiduals:
    z: torch.Tensor          # (Nr, 2)
    pose: torch.Tensor       # (Nr,) int32 measuring pose
    lm: torch.Tensor         # (Nr,) int32
    cam: torch.Tensor        # (Nr,) int32
    weight: torch.Tensor     # (Nr,)
    valid: torch.Tensor      # (Nr,) bool
    cond: torch.Tensor       # (Nr,) bool — conditioning edge
    pair: torch.Tensor       # (Nr,) int32
    pair_swap: torch.Tensor  # (Nr,) bool
    wb_meas: torch.Tensor    # (Nr,) int32 — row in ProblemIndex.wb_pose/lm
    wb_ref: torch.Tensor     # (Nr,) int32


@dataclass
class UnaryResiduals:
    pose: torch.Tensor       # (Nu,) int32
    q: torch.Tensor          # (Nu, 4)
    t: torch.Tensor          # (Nu, 3)
    cov_inv: torch.Tensor    # (Nu, 6, 6)
    valid: torch.Tensor      # (Nu,) bool


@dataclass
class BinaryResiduals:
    pose1: torch.Tensor      # (Nb,) int32
    pose2: torch.Tensor      # (Nb,) int32
    q: torch.Tensor          # (Nb, 4) measured T_12 rotation
    t: torch.Tensor          # (Nb, 3)
    cov_inv: torch.Tensor    # (Nb, 6, 6)
    valid: torch.Tensor      # (Nb,) bool
    pair: torch.Tensor       # (Nb,) int32
    pair_swap: torch.Tensor  # (Nb,) bool


@dataclass
class ImuResiduals:
    pose1: torch.Tensor      # (Ni,) int32
    pose2: torch.Tensor      # (Ni,) int32
    w: torch.Tensor          # (Ni, M, 3) gyro
    a: torch.Tensor          # (Ni, M, 3) accel
    time: torch.Tensor       # (Ni, M)
    meas_valid: torch.Tensor  # (Ni, M) bool
    weight: torch.Tensor     # (Ni,) persistent robust weight
    valid: torch.Tensor      # (Ni,) bool
    cond: torch.Tensor       # (Ni,) bool
    pair: torch.Tensor       # (Ni,) int32
    pair_swap: torch.Tensor  # (Ni,) bool
    c9: torch.Tensor         # (Ni, 9, 9) cached integration covariance
    c9_set: torch.Tensor     # () bool


@dataclass
class MargPrior:
    """Dense marginalization prior E = d^T H d + 2 g^T d, d = x (-) lin."""

    H: torch.Tensor          # (P*D, P*D), or (1, 1) when disabled
    g: torch.Tensor          # (P*D,)
    lin_q: torch.Tensor      # (P, 4)
    lin_t: torch.Tensor      # (P, 3)
    lin_v: torch.Tensor      # (P, 3)
    lin_b: torch.Tensor      # (P, 6)
    active: torch.Tensor     # () bool


def empty_marg_prior(P: int, pose_dim: int, dtype, device,
                     enabled: bool = True) -> MargPrior:
    """`enabled=False` allocates a degenerate (1,1) H; the assembly skips
    the prior when H's shape does not match the pose dims."""
    n = P * pose_dim if enabled else 1
    kw = dict(dtype=dtype, device=device)
    return MargPrior(H=torch.zeros((n, n), **kw), g=torch.zeros((n,), **kw),
                     lin_q=lie.quat_identity(**kw).repeat(P, 1),
                     lin_t=torch.zeros((P, 3), **kw),
                     lin_v=torch.zeros((P, 3), **kw),
                     lin_b=torch.zeros((P, 6), **kw),
                     active=torch.zeros((), dtype=torch.bool, device=device))


@dataclass
class ProblemIndex:
    """Host-precomputed sparsity tables (rows beyond the real count are
    padding).  W-block padding rows carry the out-of-range landmark id
    n_lms; consumers mask it explicitly."""

    pair_a: torch.Tensor     # (Npr,) int32
    pair_b: torch.Tensor
    wb_pose: torch.Tensor    # (Nw,) int32
    wb_lm: torch.Tensor      # (Nw,)
    bpair_a: torch.Tensor
    bpair_b: torch.Tensor
    ipair_a: torch.Tensor
    ipair_b: torch.Tensor
    sp_i: torch.Tensor       # (Nsp,) int32
    sp_j: torch.Tensor
    sp_valid: torch.Tensor   # (Nsp,) bool


def _pair_table_np(i_idx, j_idx, valid, n_states, pad_multiple=1):
    """Canonical (a<=b) unique-pair table + per-row pair id / swap flag.
    Invalid rows map to pair 0."""
    i_idx = np.asarray(i_idx, np.int64)
    j_idx = np.asarray(j_idx, np.int64)
    valid = np.asarray(valid, bool)
    a = np.minimum(i_idx, j_idx)
    b = np.maximum(i_idx, j_idx)
    swap = i_idx > j_idx
    m = max(int(n_states), 1)
    key = a * m + b
    pair = np.zeros(len(i_idx), np.int32)
    if valid.any():
        uniq, inv = np.unique(key[valid], return_inverse=True)
        pair[valid] = inv.astype(np.int32)
    else:
        uniq = np.zeros(0, np.int64)
    npr = _round_up(max(len(uniq), 1), pad_multiple)
    pa = np.zeros(npr, np.int32)
    pb = np.zeros(npr, np.int32)
    pa[: len(uniq)] = uniq // m
    pb[: len(uniq)] = uniq % m
    return pair, swap, pa, pb


def _wblock_table_np(pose_m, pose_r, lm, valid, n_lms, pad_multiple=1):
    """Unique (pose, landmark) W-block table + per-row block ids for the
    measuring-pose and reference-pose entries.  Padding rows carry the
    out-of-range landmark id n_lms."""
    pose_m = np.asarray(pose_m, np.int64)
    pose_r = np.asarray(pose_r, np.int64)
    lm = np.asarray(lm, np.int64)
    valid = np.asarray(valid, bool)
    m = max(int(n_lms), 1)
    key_m = pose_m * m + lm
    key_r = pose_r * m + lm
    n = len(lm)
    wb_m = np.zeros(n, np.int32)
    wb_r = np.zeros(n, np.int32)
    if valid.any():
        keys = np.concatenate([key_m[valid], key_r[valid]])
        uniq, inv = np.unique(keys, return_inverse=True)
        nv = int(valid.sum())
        wb_m[valid] = inv[:nv].astype(np.int32)
        wb_r[valid] = inv[nv:].astype(np.int32)
    else:
        uniq = np.zeros(0, np.int64)
    nw = _round_up(max(len(uniq), 1), pad_multiple)
    wp = np.zeros(nw, np.int32)
    wl = np.full(nw, m, np.int32)
    wp[: len(uniq)] = uniq // m
    wl[: len(uniq)] = uniq % m
    return wb_m, wb_r, wp, wl, len(uniq)


def _schur_pair_table_np(wp, wl, n_uniq, pad_multiple=1):
    """Per-landmark pairs of W-block rows (i, j), pose[i] <= pose[j],
    including i == j — the block sparsity of W V^-1 W^T."""
    wp = np.asarray(wp[:n_uniq], np.int64)
    wl = np.asarray(wl[:n_uniq], np.int64)
    if n_uniq == 0:
        npad = _round_up(1, pad_multiple)
        z = np.zeros(npad, np.int32)
        return z, z.copy(), np.zeros(npad, bool)
    order = np.lexsort((wp, wl))          # by landmark, then pose
    lm_s = wl[order]
    new_grp = np.r_[True, lm_s[1:] != lm_s[:-1]]
    starts = np.flatnonzero(new_grp)
    grp = np.cumsum(new_grp) - 1
    local = np.arange(n_uniq) - starts[grp]
    rep = local + 1
    total = int(rep.sum())
    end = np.cumsum(rep)
    within = np.arange(total) - np.repeat(end - rep, rep)
    sp_j_sorted = np.repeat(np.arange(n_uniq), rep)
    sp_i_sorted = np.repeat(np.arange(n_uniq) - local, rep) + within
    sp_i = order[sp_i_sorted].astype(np.int32)
    sp_j = order[sp_j_sorted].astype(np.int32)
    npad = _round_up(total, pad_multiple)
    valid = np.zeros(npad, bool)
    valid[:total] = True
    return (_pad(sp_i, npad).astype(np.int32),
            _pad(sp_j, npad).astype(np.int32), valid)


def build_structure_index(proj_pose, proj_ref_pose, proj_lm, proj_valid,
                          b1, b2, b_valid, i1, i2, i_valid, P, L,
                          pad_multiple=1, device="cuda"):
    """All host-side sparsity tables from packed numpy index arrays.

    Returns (per_row, tables): per_row (numpy) has 'pair'/'pair_swap'/
    'wb_meas'/'wb_ref' for projections and 'bpair'/'bswap'/'ipair'/'iswap'
    for the binary/IMU families; `tables` is a ProblemIndex on `device`.
    """
    pair, swap, pa, pb = _pair_table_np(proj_pose, proj_ref_pose,
                                        proj_valid, P, pad_multiple)
    wb_m, wb_r, wp, wl, n_wb = _wblock_table_np(proj_pose, proj_ref_pose,
                                                proj_lm, proj_valid, L,
                                                pad_multiple)
    sp_i, sp_j, sp_valid = _schur_pair_table_np(wp, wl, n_wb, pad_multiple)
    bpair, bswap, bpa, bpb = _pair_table_np(b1, b2, b_valid, P, pad_multiple)
    ipair, iswap, ipa, ipb = _pair_table_np(i1, i2, i_valid, P, pad_multiple)
    per_row = dict(pair=pair, pair_swap=swap, wb_meas=wb_m, wb_ref=wb_r,
                   bpair=bpair, bswap=bswap, ipair=ipair, iswap=iswap)
    dev = resolve_device(device)

    def conv(a):
        return torch.as_tensor(a, device=dev)

    tables = ProblemIndex(
        pair_a=conv(pa), pair_b=conv(pb),
        wb_pose=conv(wp), wb_lm=conv(wl),
        bpair_a=conv(bpa), bpair_b=conv(bpb),
        ipair_a=conv(ipa), ipair_b=conv(ipb),
        sp_i=conv(sp_i), sp_j=conv(sp_j),
        sp_valid=conv(sp_valid))
    return per_row, tables


@dataclass
class Problem:
    """The whole problem as one tree of static-shape tensors."""

    poses: PoseStates
    lms: LandmarkStates
    rig: Rig
    proj: ProjResiduals
    unary: UnaryResiduals
    binary: BinaryResiduals
    imu: ImuResiduals
    g_vec: torch.Tensor      # (3,) gravity in world
    marg: MargPrior
    pidx: ProblemIndex


def stack_problems(problems) -> Problem:
    """Stack same-shape problems along a new leading fleet axis (every
    leaf (B, ...)).  All problems must share padded shapes (same size
    bucket); the result feeds `solver.step.solve_fleet`."""
    from ..utils.tree import tree_map

    return tree_map(lambda *xs: torch.stack(xs), *problems)


def concat_problems(problems, config: BAConfig) -> Problem:
    """Fuse B independent windows into one block-diagonal problem (the
    fleet layout): poses, landmarks and cameras concatenated with offset
    ids, the sparsity tables re-enumerated with `build_structure_index`.
    Host work done once, like `ProblemBuilder.build`: the windows' leaves
    are read to numpy and the result is put on the first window's device.

    Windows must not carry an active marginalization prior (the fused
    prior would be O((B P D)^2)), and must share one gravity vector.  IMU
    tables of windows with fewer samples per span are padded by repeating
    the last timestamp (dt = 0).  A pose of window b sits at the sum of the
    earlier windows' pose counts, and so do its landmarks."""
    if not problems:
        raise ValueError("concat_problems needs at least one problem")
    dev = problems[0].poses.t.device

    def np_of(x):
        return x.detach().cpu().numpy()

    for p in problems:
        if bool(p.marg.active):
            raise ValueError("concat_problems: active marginalization "
                             "priors are per-window state; marginalize "
                             "before fusing")
    g0 = np_of(problems[0].g_vec)
    for p in problems[1:]:
        if not np.allclose(np_of(p.g_vec), g0):
            raise ValueError("concat_problems: gravity vectors differ")

    pose_off, lm_off, cam_off = [], [], []
    po = lo = co = 0
    for p in problems:
        pose_off.append(po)
        lm_off.append(lo)
        cam_off.append(co)
        po += p.poses.q.shape[0]
        lo += p.lms.x.shape[0]
        co += p.rig.params.shape[0]
    P, L = po, lo

    def cat(get, off_list=None):
        parts = []
        for i, p in enumerate(problems):
            a = np_of(get(p))
            parts.append(a + off_list[i] if off_list is not None else a)
        return np.concatenate(parts, axis=0)

    def T(a):
        return torch.as_tensor(np.array(a, order="C"), device=dev)

    def node(cls, get, offs=None, cast=None):
        """A state node of `cls` with every field concatenated; `offs` maps
        a field to its id offsets, cast to int32."""
        offs = offs or {}
        return cls(**{
            f.name: T(cat(lambda p, n=f.name: getattr(get(p), n),
                          offs.get(f.name)).astype(np.int32)
                      if f.name in offs else
                      cat(lambda p, n=f.name: getattr(get(p), n)))
            for f in dataclasses.fields(cls)})

    poses = node(PoseStates, lambda p: p.poses)
    lms = node(LandmarkStates, lambda p: p.lms,
               dict(ref_pose=pose_off, ref_cam=cam_off))
    rig = node(Rig, lambda p: p.rig)

    proj_pose = cat(lambda p: p.proj.pose, pose_off).astype(np.int64)
    proj_lm = cat(lambda p: p.proj.lm, lm_off).astype(np.int64)
    proj_valid = cat(lambda p: p.proj.valid)
    proj_ref = np_of(lms.ref_pose)[proj_lm]
    b1 = cat(lambda p: p.binary.pose1, pose_off).astype(np.int64)
    b2 = cat(lambda p: p.binary.pose2, pose_off).astype(np.int64)
    b_valid = cat(lambda p: p.binary.valid)
    i1 = cat(lambda p: p.imu.pose1, pose_off).astype(np.int64)
    i2 = cat(lambda p: p.imu.pose2, pose_off).astype(np.int64)
    i_valid = cat(lambda p: p.imu.valid)
    per_row, pidx = build_structure_index(
        proj_pose, proj_ref, proj_lm, proj_valid,
        b1, b2, b_valid, i1, i2, i_valid, P, L, device=dev)

    proj = ProjResiduals(
        z=T(cat(lambda p: p.proj.z)),
        pose=T(proj_pose.astype(np.int32)),
        lm=T(proj_lm.astype(np.int32)),
        cam=T(cat(lambda p: p.proj.cam, cam_off).astype(np.int32)),
        weight=T(cat(lambda p: p.proj.weight)),
        valid=T(proj_valid),
        cond=T(cat(lambda p: p.proj.cond)),
        pair=T(per_row["pair"]),
        pair_swap=T(per_row["pair_swap"]),
        wb_meas=T(per_row["wb_meas"]),
        wb_ref=T(per_row["wb_ref"]))
    unary = dataclasses.replace(
        node(UnaryResiduals, lambda p: p.unary),
        pose=T(cat(lambda p: p.unary.pose, pose_off).astype(np.int32)))
    binary = BinaryResiduals(
        pose1=T(b1.astype(np.int32)),
        pose2=T(b2.astype(np.int32)),
        q=T(cat(lambda p: p.binary.q)),
        t=T(cat(lambda p: p.binary.t)),
        cov_inv=T(cat(lambda p: p.binary.cov_inv)),
        valid=T(b_valid),
        pair=T(per_row["bpair"]),
        pair_swap=T(per_row["bswap"]))

    M = max(p.imu.w.shape[1] for p in problems)

    def cat_imu(get):
        parts = []
        for p in problems:
            a = np_of(get(p))
            if a.shape[1] < M:
                pad = [(0, 0), (0, M - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
                if a.dtype == np.bool_:
                    a = np.pad(a, pad, constant_values=False)
                elif a.ndim == 2:
                    # times: repeat the last timestamp so dt = 0 on padding
                    a = np.concatenate(
                        [a, np.repeat(a[:, -1:], M - a.shape[1], 1)], 1)
                else:
                    a = np.pad(a, pad)
            parts.append(a)
        return np.concatenate(parts, axis=0)

    imu = ImuResiduals(
        pose1=T(i1.astype(np.int32)),
        pose2=T(i2.astype(np.int32)),
        w=T(cat_imu(lambda p: p.imu.w)),
        a=T(cat_imu(lambda p: p.imu.a)),
        time=T(cat_imu(lambda p: p.imu.time)),
        meas_valid=T(cat_imu(lambda p: p.imu.meas_valid)),
        weight=T(cat(lambda p: p.imu.weight)),
        valid=T(i_valid),
        cond=T(cat(lambda p: p.imu.cond)),
        pair=T(per_row["ipair"]),
        pair_swap=T(per_row["iswap"]),
        c9=T(cat(lambda p: p.imu.c9)),
        c9_set=torch.zeros((), dtype=torch.bool, device=dev))

    marg = empty_marg_prior(P, config.pose_dim, poses.t.dtype, dev,
                            enabled=False)
    marg = dataclasses.replace(marg, lin_q=poses.q, lin_t=poses.t,
                               lin_v=poses.v, lin_b=poses.b)
    return Problem(poses=poses, lms=lms, rig=rig, proj=proj, unary=unary,
                   binary=binary, imu=imu,
                   g_vec=T(g0.astype(np_of(poses.t).dtype)), marg=marg,
                   pidx=pidx)


# ---------------------------------------------------------------------------
# Host-side builder (numpy; the Add* API of the reference)
# ---------------------------------------------------------------------------


def _pad(arr, n, fill=0.0):
    arr = np.asarray(arr)
    if arr.shape[0] == n:
        return arr
    pad_shape = (n - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], 0)


def _round_up(n, mult):
    return max(mult, ((n + mult - 1) // mult) * mult)


def _stack_or_empty(rows, key, width, dt):
    return np.stack([r[key] for r in rows]) if rows else \
        np.zeros((0,) + width, dt)


class ProblemBuilder:
    """Incremental host-side problem construction, then `.build()` to
    tensors on a device (padding to static shapes happens at build)."""

    def __init__(self, config: BAConfig, dtype=np.float64):
        self.config = config
        self.dtype = dtype
        self.cams: list[tuple[np.ndarray, int, np.ndarray, np.ndarray]] = []
        self.poses: list[dict] = []
        self.lms: list[dict] = []
        self.proj: list[dict] = []
        self.unary: list[dict] = []
        self.binary: list[dict] = []
        self.imu: list[dict] = []
        self.manual_masks: dict[int, dict] = {}
        self.gravity_vec: Optional[np.ndarray] = None

    def set_gravity(self, g_vec) -> None:
        """Explicit world gravity vector; default (0, 0, -config.gravity)."""
        self.gravity_vec = np.asarray(g_vec, self.dtype)

    # -- cameras ---------------------------------------------------------
    def add_camera(self, params, model=cam_mod.MODEL_LINEAR,
                   tvs_q=(1.0, 0, 0, 0), tvs_t=(0.0, 0, 0)) -> int:
        p = np.zeros(cam_mod.MAX_PARAMS, self.dtype)
        p[: len(params)] = params
        self.cams.append((p, int(model), np.asarray(tvs_q, self.dtype),
                          np.asarray(tvs_t, self.dtype)))
        return len(self.cams) - 1

    # -- states ----------------------------------------------------------
    def add_pose(self, q, t, v=(0.0, 0, 0), b=(0.0,) * 6, active=True,
                 time=0.0, cam_params=None) -> int:
        cp = np.zeros(cam_mod.MAX_PARAMS, self.dtype)
        if cam_params is not None:
            cp[: len(cam_params)] = cam_params
        self.poses.append(dict(q=np.asarray(q, self.dtype),
                               t=np.asarray(t, self.dtype),
                               v=np.asarray(v, self.dtype),
                               b=np.asarray(b, self.dtype),
                               active=bool(active), time=float(time),
                               cam_params=cp))
        return len(self.poses) - 1

    def regularize_pose(self, pose_id: int, translation: bool = True,
                        gravity: bool = False, bias: bool = False,
                        rotation: bool = False) -> None:
        """Manually fix pose dims (rotation means dims {3, 4, 5})."""
        self.manual_masks[int(pose_id)] = dict(
            translation=bool(translation), gravity=bool(gravity),
            bias=bool(bias), rotation=bool(rotation))

    def add_landmark(self, x_w, ref_pose: int, ref_cam: int = 0,
                     active=True) -> int:
        x_w = np.asarray(x_w, self.dtype)
        if x_w.shape == (3,):
            x_w = np.concatenate([x_w, np.ones(1, self.dtype)])
        self.lms.append(dict(x_w=x_w, ref_pose=int(ref_pose),
                             ref_cam=int(ref_cam), active=bool(active),
                             z_ref=None))
        return len(self.lms) - 1

    # -- residuals -------------------------------------------------------
    def add_projection_residual(self, z, meas_pose: int, lm: int,
                                cam: int = 0, weight=1.0):
        """Skips (and records as z_ref) the observation from the reference
        camera at the reference pose in inverse-depth mode."""
        if (self.config.lm_size == 1
                and meas_pose == self.lms[lm]["ref_pose"]
                and cam == self.lms[lm]["ref_cam"]):
            self.lms[lm]["z_ref"] = np.asarray(z, self.dtype)
            return
        cond = (not self.poses[self.lms[lm]["ref_pose"]]["active"]
                and self.poses[meas_pose]["active"])
        self.proj.append(dict(z=np.asarray(z, self.dtype), pose=meas_pose,
                              lm=lm, cam=cam, weight=float(weight),
                              cond=cond))

    def add_unary_constraint(self, pose: int, q, t, cov=None):
        cov_inv = (np.eye(6, dtype=self.dtype) if cov is None
                   else np.linalg.inv(np.asarray(cov, self.dtype)))
        self.unary.append(dict(pose=pose, q=np.asarray(q, self.dtype),
                               t=np.asarray(t, self.dtype), cov_inv=cov_inv))

    def add_binary_constraint(self, pose1: int, pose2: int, q, t, cov=None):
        cov_inv = (np.eye(6, dtype=self.dtype) if cov is None
                   else np.linalg.inv(np.asarray(cov, self.dtype)))
        self.binary.append(dict(pose1=pose1, pose2=pose2,
                                q=np.asarray(q, self.dtype),
                                t=np.asarray(t, self.dtype), cov_inv=cov_inv))

    def add_imu_residual(self, pose1: int, pose2: int, w, a, time):
        cond = (not self.poses[pose1]["active"]
                and self.poses[pose2]["active"])
        self.imu.append(dict(pose1=pose1, pose2=pose2,
                             w=np.asarray(w, self.dtype),
                             a=np.asarray(a, self.dtype),
                             time=np.asarray(time, self.dtype), cond=cond))

    # -- build -----------------------------------------------------------
    def build(self, pad_multiple: int = 1, with_marg_prior: bool = True,
              device="cuda") -> Problem:
        """Pad to static shapes and emit the Problem on `device` (CUDA by
        default; raises when CUDA is absent and `device` is not "cpu")."""
        dev = resolve_device(device)
        dt = self.dtype
        P = _round_up(len(self.poses), pad_multiple)
        L = _round_up(max(len(self.lms), 1), pad_multiple)
        Nr = _round_up(max(len(self.proj), 1), pad_multiple)
        Nu = _round_up(max(len(self.unary), 1), pad_multiple)
        Nb = _round_up(max(len(self.binary), 1), pad_multiple)
        Ni = _round_up(max(len(self.imu), 1), pad_multiple)
        M = max([m["w"].shape[0] for m in self.imu] + [1])

        def T(a):
            return torch.as_tensor(np.array(a, order="C"), device=dev)

        n_p = len(self.poses)
        q_p = _pad(_stack_or_empty(self.poses, "q", (4,), dt), P)
        q_p = q_p + np.concatenate([np.zeros((min(n_p, P), 4), dt),
                                    np.tile(np.array([1.0, 0, 0, 0], dt),
                                            (P - n_p, 1))])
        poses = PoseStates(
            q=T(q_p),
            t=T(_pad(_stack_or_empty(self.poses, "t", (3,), dt), P)),
            v=T(_pad(_stack_or_empty(self.poses, "v", (3,), dt), P)),
            b=T(_pad(_stack_or_empty(self.poses, "b", (6,), dt), P)),
            time=T(_pad(np.array([p["time"] for p in self.poses], dt), P)),
            active=T(_pad(np.array([p["active"] for p in self.poses], bool),
                          P, False)),
            mask=T(self._build_param_mask(P)),
            cam_params=T(_pad(_stack_or_empty(
                self.poses, "cam_params", (cam_mod.MAX_PARAMS,), dt), P)),
        )

        n_l = len(self.lms)
        lms = LandmarkStates(
            x=torch.zeros((L, 4), dtype=poses.t.dtype, device=dev),
            x_w=T(_pad(_stack_or_empty(self.lms, "x_w", (4,), dt), L)),
            ref_pose=T(_pad(np.array([l["ref_pose"] for l in self.lms],
                                     np.int32), L)),
            ref_cam=T(_pad(np.array([l["ref_cam"] for l in self.lms],
                                    np.int32), L)),
            active=T(_pad(np.array([l["active"] for l in self.lms], bool),
                          L, False)),
            reliable=T(_pad(np.ones(n_l, bool), L, False)),
            z_ref=T(_pad(np.stack(
                [l["z_ref"] if l["z_ref"] is not None else np.zeros(2, dt)
                 for l in self.lms]) if n_l else np.zeros((0, 2), dt), L)),
            has_z_ref=T(_pad(np.array(
                [l["z_ref"] is not None for l in self.lms], bool), L,
                False)),
        )

        cam_arrs = self.cams or [(np.zeros(cam_mod.MAX_PARAMS, dt), 0,
                                  np.array([1.0, 0, 0, 0], dt),
                                  np.zeros(3, dt))]
        rig = Rig(
            params=T(np.stack([c[0] for c in cam_arrs])),
            model=T(np.array([c[1] for c in cam_arrs], np.int32)),
            tvs_q=T(np.stack([c[2] for c in cam_arrs])),
            tvs_t=T(np.stack([c[3] for c in cam_arrs])),
        )

        n_r = len(self.proj)
        proj_pose = _pad(np.array([r["pose"] for r in self.proj], np.int32),
                         Nr)
        proj_lm = _pad(np.array([r["lm"] for r in self.proj], np.int32), Nr)
        proj_valid = _pad(np.ones(n_r, bool), Nr, False)
        lm_ref = np.array([l["ref_pose"] for l in self.lms] + [0], np.int32)
        proj_ref = lm_ref[proj_lm]
        b1_np = _pad(np.array([r["pose1"] for r in self.binary], np.int32),
                     Nb)
        b2_np = _pad(np.array([r["pose2"] for r in self.binary], np.int32),
                     Nb)
        b_valid = _pad(np.ones(len(self.binary), bool), Nb, False)
        i1_np = _pad(np.array([r["pose1"] for r in self.imu], np.int32), Ni)
        i2_np = _pad(np.array([r["pose2"] for r in self.imu], np.int32), Ni)
        i_valid = _pad(np.ones(len(self.imu), bool), Ni, False)
        per_row, pidx = build_structure_index(
            proj_pose, proj_ref, proj_lm, proj_valid,
            b1_np, b2_np, b_valid, i1_np, i2_np, i_valid,
            P, L, pad_multiple, device=dev)
        proj = ProjResiduals(
            z=T(_pad(_stack_or_empty(self.proj, "z", (2,), dt), Nr)),
            pose=T(proj_pose),
            lm=T(proj_lm),
            cam=T(_pad(np.array([r["cam"] for r in self.proj], np.int32),
                       Nr)),
            weight=T(_pad(np.array([r["weight"] for r in self.proj], dt),
                          Nr)),
            valid=T(proj_valid),
            cond=T(_pad(np.array([r["cond"] for r in self.proj], bool), Nr,
                        False)),
            pair=T(per_row["pair"]),
            pair_swap=T(per_row["pair_swap"]),
            wb_meas=T(per_row["wb_meas"]),
            wb_ref=T(per_row["wb_ref"]),
        )

        n_u = len(self.unary)
        id_q = np.tile(np.array([1.0, 0, 0, 0], dt), (Nu, 1))
        id_q[:n_u] = _stack_or_empty(self.unary, "q", (4,), dt)
        unary = UnaryResiduals(
            pose=T(_pad(np.array([r["pose"] for r in self.unary], np.int32),
                        Nu)),
            q=T(id_q),
            t=T(_pad(_stack_or_empty(self.unary, "t", (3,), dt), Nu)),
            cov_inv=T(_pad(_stack_or_empty(self.unary, "cov_inv", (6, 6),
                                           dt), Nu)),
            valid=T(_pad(np.ones(n_u, bool), Nu, False)),
        )

        n_b = len(self.binary)
        id_qb = np.tile(np.array([1.0, 0, 0, 0], dt), (Nb, 1))
        id_qb[:n_b] = _stack_or_empty(self.binary, "q", (4,), dt)
        binary = BinaryResiduals(
            pose1=T(b1_np),
            pose2=T(b2_np),
            q=T(id_qb),
            t=T(_pad(_stack_or_empty(self.binary, "t", (3,), dt), Nb)),
            cov_inv=T(_pad(_stack_or_empty(self.binary, "cov_inv", (6, 6),
                                           dt), Nb)),
            valid=T(b_valid),
            pair=T(per_row["bpair"]),
            pair_swap=T(per_row["bswap"]),
        )

        w_arr = np.zeros((Ni, M, 3), dt)
        a_arr = np.zeros((Ni, M, 3), dt)
        t_arr = np.zeros((Ni, M), dt)
        mv_arr = np.zeros((Ni, M), bool)
        for i, r in enumerate(self.imu):
            k = r["w"].shape[0]
            w_arr[i, :k] = r["w"]
            a_arr[i, :k] = r["a"]
            t_arr[i, :k] = r["time"]
            # pad trailing times with the last time so dt=0 on padded steps
            t_arr[i, k:] = r["time"][-1] if k else 0.0
            mv_arr[i, :k] = True
        imu = ImuResiduals(
            pose1=T(i1_np), pose2=T(i2_np),
            w=T(w_arr), a=T(a_arr), time=T(t_arr), meas_valid=T(mv_arr),
            weight=T(np.ones(Ni, dt)),
            valid=T(i_valid),
            cond=T(_pad(np.array([r["cond"] for r in self.imu], bool), Ni,
                        False)),
            pair=T(per_row["ipair"]),
            pair_swap=T(per_row["iswap"]),
            c9=T(np.zeros((Ni, 9, 9), dt)),
            c9_set=T(np.zeros((), bool)),
        )

        g = (np.asarray(self.gravity_vec, dt) if self.gravity_vec is not None
             else np.array([0.0, 0.0, -self.config.gravity], dt))
        marg = empty_marg_prior(P, self.config.pose_dim, poses.t.dtype, dev,
                                enabled=with_marg_prior)
        marg = dataclasses.replace(marg, lin_q=poses.q, lin_t=poses.t,
                                   lin_v=poses.v, lin_b=poses.b)
        return Problem(poses=poses, lms=lms, rig=rig, proj=proj, unary=unary,
                       binary=binary, imu=imu, g_vec=T(g), marg=marg,
                       pidx=pidx)

    # -- gauge fixing / regularization -----------------------------------
    def _build_param_mask(self, P):
        cfg = self.config
        n_p = len(self.poses)
        mask = np.zeros((P, 15), dtype=bool)
        for i, p in enumerate(self.poses):
            if not p["active"]:
                continue
            mask[i, :6] = True
            if cfg.vel_in_state:
                mask[i, 6:9] = True
            if cfg.bias_in_state:
                mask[i, 9:15] = True

        # poses with no inertial residuals: mask velocity/bias
        has_inertial = np.zeros(n_p, bool)
        for r in self.imu:
            has_inertial[r["pose1"]] = True
            has_inertial[r["pose2"]] = True
        for i in range(n_p):
            if not has_inertial[i]:
                mask[i, 6:15] = False

        # poses with no residuals at all: fully masked
        has_any = has_inertial.copy()
        for r in self.proj:
            has_any[r["pose"]] = True
            has_any[self.lms[r["lm"]]["ref_pose"]] = True
        for r in self.unary:
            has_any[r["pose"]] = True
        for r in self.binary:
            has_any[r["pose1"]] = True
            has_any[r["pose2"]] = True
        for i in range(n_p):
            if not has_any[i]:
                mask[i, :] = False

        for pid, sel in self.manual_masks.items():
            if not self.poses[pid]["active"]:
                continue
            if sel["translation"]:
                mask[pid, 0:3] = False
            if sel["rotation"]:
                mask[pid, 3:6] = False
            if sel["gravity"]:
                mask[pid, self._gravity_axis_dim(pid)] = False
            if sel["bias"] and cfg.bias_in_state:
                mask[pid, 9:15] = False

        # auto gauge fixing when every pose is active and there is no prior
        all_active = all(p["active"] for p in self.poses) and n_p > 0
        if (self.config.enable_auto_regularization and all_active
                and not self.unary and 0 not in self.manual_masks):
            root = 0
            mask[root, 0:3] = False
            if cfg.bias_in_state and cfg.regularize_biases_in_batch:
                mask[root, 9:15] = False
            if not cfg.vel_in_state:
                mask[root, 3:6] = False
            else:
                mask[root, self._gravity_axis_dim(root)] = False
        return mask

    def _gravity_axis_dim(self, pose_id: int) -> int:
        """Rotation dim most aligned with gravity."""
        q = self.poses[pose_id]["q"]
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]])
        g_body = R.T @ np.array([0.0, 0.0, -1.0])
        return 3 + int(np.argmax(np.abs(g_body)))


# ---------------------------------------------------------------------------
# Landmark world<->sensor conversion
# ---------------------------------------------------------------------------


def _t_ws(poses: PoseStates, rig: Rig, ref_pose, ref_cam):
    """World-from-sensor transform of each landmark's reference camera."""
    return lie.se3_compose((poses.q[ref_pose], poses.t[ref_pose]),
                           (rig.tvs_q[ref_cam], rig.tvs_t[ref_cam]))


def prepare_landmarks(problem: Problem, config: BAConfig) -> Problem:
    """x_w -> parameterization `x`.  Inverse-depth mode normalizes the ray to
    unit length so x[3] is the inverse depth; where the reference-view pixel
    is known the ray direction comes from unprojecting it."""
    lms = problem.lms
    if config.lm_size == 1:
        T_ws = _t_ws(problem.poses, problem.rig, lms.ref_pose, lms.ref_cam)
        x_s = lie.se3_transform_homog(lie.se3_inverse(T_ws), lms.x_w)
        norm = torch.clamp(torch.linalg.norm(x_s[..., :3], dim=-1,
                                             keepdim=True), min=1e-12)
        x_s = x_s / norm
        if config.use_per_pose_cam_params:
            params_l = problem.poses.cam_params[lms.ref_pose]
        else:
            params_l = problem.rig.params[lms.ref_cam]
        model_l = problem.rig.model[lms.ref_cam]
        ray = cam_mod.unproject(params_l, model_l, lms.z_ref)
        x_meas = torch.cat([ray, x_s[..., 3:4]], dim=-1)
        x = torch.where(lms.has_z_ref[:, None], x_meas, x_s)
    else:
        x = lms.x_w
    return dataclasses.replace(problem, lms=dataclasses.replace(lms, x=x))


def finalize_landmarks(problem: Problem, config: BAConfig) -> Problem:
    """Parameterization `x` -> world x_w."""
    lms = problem.lms
    if config.lm_size == 1:
        T_ws = _t_ws(problem.poses, problem.rig, lms.ref_pose, lms.ref_cam)
        x_w = lie.se3_transform_homog(T_ws, lms.x)
        w = x_w[..., 3:4]
        tiny = w.abs() < 1e-12
        safe = torch.where(tiny, torch.ones_like(w), w)
        x_w = torch.where(tiny, x_w, x_w / safe)
    else:
        x_w = lms.x
    return dataclasses.replace(problem, lms=dataclasses.replace(lms, x_w=x_w))
