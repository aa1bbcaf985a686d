"""Online streaming fixed-lag smoother: the serving shape of the ring.

Port of `ba_tpu/solver/streaming.py`.  `fixedlag.build_ring_schedule`
needs the whole trajectory up front; `StreamingRing` takes one keyframe and
its measurements at a time through the `add_*` API (the reference's
AddPose / AddProjectionResidual / AddImuResidual / AddUnaryConstraint) and
retires one keyframe per arriving keyframe, on the same per-slide
machinery:

  * the `add_*` path does no device work (numpy buffering of the live
    window only);
  * each slide builds its slot tables on the host in O(window), value for
    value the batch schedule's (tests/test_torch_streaming.py checks them
    field by field), and runs `fixedlag.ring_slide_step`;
  * the incoming landmarks are prepared on the device from the anchors'
    initial states (`prepare_rows`, the same elementwise math as
    `problem.prepare_landmarks`);
  * the ~55 slide tables travel as three flat buffers (float / int32 /
    bool), unpacked into views on the device;
  * `push(block=False)` never waits for the device: on CUDA the three
    buffers are copied to pinned host tensors and sent with asynchronous
    copies, so the host builds slide k+1's tables while the card still
    works on slide k.

Reference defects mirrored on purpose, so that the two packages stay
comparable (ROADMAP.md queue 3): slide k loads only the landmarks anchored
at its incoming keyframe (a landmark added later with an older in-window
anchor is never loaded into its slot); the `add_*` methods accept pose ids
that have already retired (their rows are kept and never read); and
`add_imu` gives every IMU row the weight 1.0.

Restrictions (as the ring's): no calibration block, no per-pose cam
params, landmarks anchored at in-window poses, and alive landmark ids
distinct mod L_w within every window (asserted).  A pose graph (lm_size 0,
the GPS smoother of `apps/unary_binary_imu_test.py`) runs with one
landmark slot and one projection row, both padding, and no landmark:
`prepare_rows` leaves the slot as it is and the assembly's landmark block
is the dummy 1-wide one.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import camera as cam_mod
from ..core import lie
from ..core.problem import BAConfig, ProblemIndex, Rig, empty_marg_prior
from ..utils import timing
from ..utils.tree import tree_map
from .fixedlag import RingSchedule, _pad_rows, ring_slide_step, slot_index


@dataclasses.dataclass(frozen=True)
class RingCapacities:
    """Static per-slide table shapes.  Exceeding a capacity at run time is
    an error; size them at the expected per-window maxima."""

    L_w: int              # landmark slots
    n_proj: int           # projection rows per slide
    n_imu: int = 1        # IMU residual rows per slide
    n_unary: int = 1
    n_binary: int = 1
    imu_span: int = 1     # measurements per IMU span (M)
    # ProblemIndex table rows
    n_pair: int = 1
    n_wb: int = 1
    n_bpair: int = 1
    n_ipair: int = 1
    n_sp: int = 1

    @classmethod
    def from_schedule(cls, s: RingSchedule) -> "RingCapacities":
        """Capacities matching a batch schedule's padded shapes."""
        i = s.inputs
        return cls(L_w=s.L_w,
                   n_proj=int(i["proj_z"].shape[1]),
                   n_imu=int(i["imu_pose1"].shape[1]),
                   n_unary=int(i["unary_pose"].shape[1]),
                   n_binary=int(i["binary_pose1"].shape[1]),
                   imu_span=int(i["imu_w"].shape[2]),
                   n_pair=int(i["pidx"].pair_a.shape[1]),
                   n_wb=int(i["pidx"].wb_pose.shape[1]),
                   n_bpair=int(i["pidx"].bpair_a.shape[1]),
                   n_ipair=int(i["pidx"].ipair_a.shape[1]),
                   n_sp=int(i["pidx"].sp_i.shape[1]))


def prepare_rows(x_w, q_ref, t_ref, rig: Rig, ref_cam, z_ref, has_z,
                 config: BAConfig):
    """Rowwise landmark-state preparation: the body of
    `problem.prepare_landmarks` applied to explicit per-row anchor
    states, so values equal the batch prepare's on the same inputs."""
    if config.lm_size != 1:
        return x_w
    T_ws = lie.se3_compose((q_ref, t_ref),
                           (rig.tvs_q[ref_cam], rig.tvs_t[ref_cam]))
    x_s = lie.se3_transform_homog(lie.se3_inverse(T_ws), x_w)
    norm = torch.clamp(torch.linalg.norm(x_s[..., :3], dim=-1,
                                         keepdim=True), min=1e-12)
    x_s = x_s / norm
    ray = cam_mod.unproject(rig.params[ref_cam], rig.model[ref_cam], z_ref)
    x_meas = torch.cat([ray, x_s[..., 3:4]], dim=-1)
    return torch.where(has_z[:, None], x_meas, x_s)


# the ProblemIndex tables that travel in the int32 buffer
_PIDX_I = ("pair_a", "pair_b", "wb_pose", "wb_lm", "bpair_a", "bpair_b",
           "ipair_a", "ipair_b", "sp_i", "sp_j")


def _make_layouts(W, C, caps: RingCapacities):
    """(float, int32, bool) layouts: (name, shape) per table, in buffer
    order, from the capacities."""
    L_w, Np, Ni = caps.L_w, caps.n_proj, caps.n_imu
    Nu, Nb, M = caps.n_unary, caps.n_binary, caps.imu_span
    fl = (("pose_time", (W,)), ("pose_cam_params", (W, C)),
          ("new_q", (W, 4)), ("new_t", (W, 3)), ("new_v", (W, 3)),
          ("new_b", (W, 6)), ("lm_z_ref", (L_w, 2)), ("lm_x_w", (L_w, 4)),
          ("proj_z", (Np, 2)), ("proj_weight", (Np,)),
          ("imu_w", (Ni, M, 3)), ("imu_a", (Ni, M, 3)),
          ("imu_time", (Ni, M)), ("imu_weight", (Ni,)),
          ("unary_q", (Nu, 4)), ("unary_t", (Nu, 3)),
          ("unary_cov_inv", (Nu, 6, 6)), ("binary_q", (Nb, 4)),
          ("binary_t", (Nb, 3)), ("binary_cov_inv", (Nb, 6, 6)))
    il = (("lm_ref_pose", (L_w,)), ("lm_ref_cam", (L_w,)),
          ("proj_pose", (Np,)), ("proj_lm", (Np,)), ("proj_cam", (Np,)),
          ("proj_pair", (Np,)), ("proj_wb_meas", (Np,)),
          ("proj_wb_ref", (Np,)), ("imu_pose1", (Ni,)),
          ("imu_pose2", (Ni,)), ("imu_pair", (Ni,)),
          ("unary_pose", (Nu,)), ("binary_pose1", (Nb,)),
          ("binary_pose2", (Nb,)), ("binary_pair", (Nb,)),
          ("pair_a", (caps.n_pair,)), ("pair_b", (caps.n_pair,)),
          ("wb_pose", (caps.n_wb,)), ("wb_lm", (caps.n_wb,)),
          ("bpair_a", (caps.n_bpair,)), ("bpair_b", (caps.n_bpair,)),
          ("ipair_a", (caps.n_ipair,)), ("ipair_b", (caps.n_ipair,)),
          ("sp_i", (caps.n_sp,)), ("sp_j", (caps.n_sp,)),
          ("drop_slot", (1,)))
    bl = (("pose_mask", (W, 15)), ("pose_active", (W,)),
          ("new_pose_mask", (W,)), ("lm_active", (L_w,)),
          ("lm_has_z_ref", (L_w,)), ("new_lm_mask", (L_w,)),
          ("proj_valid", (Np,)), ("proj_cond", (Np,)),
          ("proj_pair_swap", (Np,)), ("imu_meas_valid", (Ni, M)),
          ("imu_valid", (Ni,)), ("imu_cond", (Ni,)),
          ("imu_pair_swap", (Ni,)), ("unary_valid", (Nu,)),
          ("binary_valid", (Nb,)), ("binary_pair_swap", (Nb,)),
          ("sp_valid", (caps.n_sp,)))
    return fl, il, bl


def _pack(d, layout, dtype):
    return np.concatenate(
        [np.ascontiguousarray(d[name], dtype).ravel()
         for name, _ in layout])


def _unpack(buf, layout):
    """{name: view of `buf`} for a packed layout."""
    out = {}
    off = 0
    for name, shp in layout:
        n = int(np.prod(shp))
        out[name] = buf[off: off + n].reshape(shp)
        off += n
    return out


def _packed_slide_step(carry, fbuf, ibuf, bbuf, rig, g_vec, layouts,
                       config: BAConfig, use_imu: bool,
                       iters_per_slide: int, W: int, L_w: int,
                       gn_damping: float = 1.0):
    """Unpack the three flat device buffers into the slide tables, prepare
    the incoming landmarks, run `ring_slide_step`."""
    fl, il, bl = layouts
    d: Dict[str, Any] = {}
    d.update(_unpack(fbuf, fl))
    d.update(_unpack(ibuf, il))
    d.update(_unpack(bbuf.bool(), bl))
    d["pidx"] = ProblemIndex(
        **{k: d.pop(k) for k in _PIDX_I}, sp_valid=d.pop("sp_valid"))
    d["drop_slot"] = d.pop("drop_slot")[0]

    # the anchors' initial states are the new_q/new_t rows of their slots,
    # the values the batch `prepare_landmarks` used
    rp = d["lm_ref_pose"]
    x = prepare_rows(d["lm_x_w"], d["new_q"][rp], d["new_t"][rp], rig,
                     d["lm_ref_cam"], d["lm_z_ref"], d["lm_has_z_ref"],
                     config)
    d["new_lm_x"] = torch.where(d["new_lm_mask"][:, None], x, 0.0)
    return ring_slide_step(carry, d, rig, g_vec, config, use_imu,
                           iters_per_slide, W, L_w, gn_damping)


class StreamingRing:
    """Incremental fixed-lag smoother over a W-keyframe ring.

    Usage (one keyframe at a time):

        ring = StreamingRing(cfg, W=8, rig=rig, g_vec=g, caps=caps)
        for each keyframe:
            g = ring.add_pose(q, t, v, b, time)
            ring.add_imu(g - 1, g, w, a, times)        # span from previous
            ring.add_projection(z, g, lm_id)           # per observation
            out = ring.push()                          # None until warm
            if out is not None:
                ...out["q"], out["t"]...               # retired keyframe

    `push()` fires at most one slide: once W keyframes are buffered, every
    later keyframe retires the oldest one and returns its post-solve
    estimate.  `push(block=False)` returns device tensors without waiting
    for the device.  The ring's tensors live on `device` (CUDA unless
    device="cpu"; without CUDA that default raises) in the float type of
    `dtype`.
    """

    def __init__(self, config: BAConfig, W: int, rig: Rig, g_vec,
                 caps: RingCapacities, use_imu: bool = False,
                 iters_per_slide: int = 2, dtype=np.float64,
                 gn_damping: float = 1.0, device="cuda"):
        assert config.calib_dim == 0, "streaming ring: no calibration block"
        assert not config.use_per_pose_cam_params
        self.device = resolve_device(device)
        self.config = config
        self.W = W
        self.caps = caps
        self.use_imu = use_imu
        self.iters = iters_per_slide
        self.gn_damping = gn_damping
        self.dtype = np.dtype(dtype)
        tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype

        def place(t):
            t = torch.as_tensor(t, device=self.device)
            return (t.to(tdtype) if t.is_floating_point() else t).contiguous()

        self.rig = tree_map(place, rig)
        self.g_vec = place(g_vec)
        self._C = int(rig.params.shape[1])
        self._layouts = _make_layouts(W, self._C, caps)
        # pinned upload buffers, each held with the event recorded after
        # its copy until the copy has finished (`_upload`)
        self._inflight: collections.deque = collections.deque()

        # host buffers (live window only): measurements accumulate in
        # per-keyframe row lists and become columnar numpy chunks at first
        # use, so a slide's table build is W vectorized concatenations
        self._poses: Dict[int, Dict[str, Any]] = {}
        self._lms: Dict[int, Dict[str, Any]] = {}
        self._lm_by_ref: Dict[int, List[int]] = {}
        self._pend: Dict[str, Dict[int, List[Dict[str, Any]]]] = {
            "proj": {}, "imu": {}, "unary": {}, "binary": {}}
        self._chunks: Dict[str, Dict[int, Dict[str, Any]]] = {
            "proj": {}, "imu": {}, "unary": {}, "binary": {}}
        self._lm_chunks: Dict[int, Dict[str, Any]] = {}
        self._n_poses = 0
        self._next_lm = 0
        self._next_slide = 0
        self._carry = None

    # ---- Add* API ----

    def add_pose(self, q, t, v=None, b=None, time=0.0,
                 mask=None) -> int:
        """Buffer one keyframe (poses must arrive in id order).  Returns
        the global pose id."""
        g = self._n_poses
        self._n_poses += 1
        self._poses[g] = dict(
            q=np.asarray(q, self.dtype),
            t=np.asarray(t, self.dtype),
            v=np.zeros(3, self.dtype) if v is None
            else np.asarray(v, self.dtype),
            b=np.zeros(6, self.dtype) if b is None
            else np.asarray(b, self.dtype),
            time=float(time),
            mask=np.ones(15, bool) if mask is None
            else np.asarray(mask, bool))
        return g

    def add_landmark(self, x_w, ref_pose: int, ref_cam: int = 0,
                     z_ref=None) -> int:
        """Buffer one landmark anchored at (in-window) `ref_pose`.  Its
        parameterized state is prepared on the device at its slide, from
        the anchor pose's buffered guess."""
        lid = self._next_lm
        self._next_lm += 1
        x_w = np.asarray(x_w, self.dtype)
        if x_w.shape[0] == 3:
            x_w = np.concatenate([x_w, np.ones(1, self.dtype)])
        has_z = z_ref is not None
        self._lms[lid] = dict(
            x_w=x_w, ref_pose=ref_pose, ref_cam=ref_cam,
            z_ref=(np.asarray(z_ref, self.dtype) if has_z
                   else np.zeros(2, self.dtype)),
            has_z_ref=has_z)
        self._lm_by_ref.setdefault(ref_pose, []).append(lid)
        self._lm_chunks.pop(ref_pose, None)      # chunk now stale
        return lid

    def add_projection(self, z, pose: int, lm: int, cam: int = 0,
                       weight: float = 1.0, cond: bool = False) -> None:
        """In inverse-depth mode the observation from the landmark's
        reference pose and camera is not a residual (it would be
        identically zero): it is recorded as z_ref, and the landmark ray
        is prepared from it.  The landmark must already have been added."""
        assert lm < self._next_lm, \
            f"projection references landmark {lm} before add_landmark"
        z = np.asarray(z, self.dtype)
        d = self._lms.get(lm)
        if (self.config.lm_size == 1 and d is not None
                and pose == d["ref_pose"] and cam == d["ref_cam"]):
            d["z_ref"] = z
            d["has_z_ref"] = True
            self._lm_chunks.pop(d["ref_pose"], None)
            return
        self._pend["proj"].setdefault(pose, []).append(
            dict(z=z, pose=pose, lm=lm, cam=cam, weight=weight,
                 cond=cond))
        self._chunks["proj"].pop(pose, None)

    def add_imu(self, pose1: int, pose2: int, w, a, times,
                cond: bool = False) -> None:
        """IMU span between consecutive keyframes; padded to the
        `imu_span` capacity with invalid rows."""
        M = self.caps.imu_span
        w = np.asarray(w, self.dtype).reshape(-1, 3)
        n = w.shape[0]
        assert n <= M, f"IMU span {n} exceeds capacity {M}"
        self._pend["imu"].setdefault(pose1, []).append(dict(
            pose1=pose1, pose2=pose2,
            w=_pad_rows(w, M),
            a=_pad_rows(np.asarray(a, self.dtype).reshape(-1, 3), M),
            time=_pad_rows(np.asarray(times, self.dtype).reshape(-1), M),
            meas_valid=_pad_rows(np.ones(n, bool), M, False),
            weight=1.0, cond=cond))
        self._chunks["imu"].pop(pose1, None)

    def add_unary(self, pose: int, q, t, cov_inv) -> None:
        self._pend["unary"].setdefault(pose, []).append(
            dict(pose=pose, q=np.asarray(q, self.dtype),
                 t=np.asarray(t, self.dtype),
                 cov_inv=np.asarray(cov_inv, self.dtype)))
        self._chunks["unary"].pop(pose, None)

    def add_binary(self, pose1: int, pose2: int, q, t, cov_inv) -> None:
        self._pend["binary"].setdefault(pose1, []).append(
            dict(pose1=pose1, pose2=pose2,
                 q=np.asarray(q, self.dtype),
                 t=np.asarray(t, self.dtype),
                 cov_inv=np.asarray(cov_inv, self.dtype)))
        self._chunks["binary"].pop(pose1, None)

    # ---- the slide ----

    def push(self, block: bool = True) -> Optional[Dict[str, Any]]:
        """Fire the next slide if its window is complete.  Returns the
        retired keyframe's post-solve estimate (dict: pose, q, t, v, b,
        cost) or None while warming up.  With `block=True` the values come
        back as numpy arrays; with `block=False` they are device tensors,
        and the host goes on while the device works."""
        with timing.span("push", self.device):
            k = self._next_slide
            if self._n_poses < k + self.W:
                # slide k waits for pose k+W-1 (its full window)
                return None
            if self._carry is None:
                self._init_carry()
            d = self._slide_tables(k)
            fl, il, bl = self._layouts
            bufs = self._upload([_pack(d, fl, self.dtype),
                                 _pack(d, il, np.int32),
                                 _pack(d, bl, np.uint8)])
            self._carry, out = _packed_slide_step(
                self._carry, *bufs, self.rig, self.g_vec, self._layouts,
                self.config, self.use_imu, self.iters, self.W, self.caps.L_w,
                self.gn_damping)
            self._next_slide = k + 1
            self._retire(k)
            res: Dict[str, Any] = dict(out)
            if block:
                res = {key: val.cpu().numpy() for key, val in res.items()}
            res["pose"] = k
            return res

    def _upload(self, bufs):
        """The packed host buffers as tensors on the ring's device.  On
        CUDA each goes through a pinned host tensor and an asynchronous
        copy; the pinned tensors are held, with an event recorded after
        their copies, until that event has completed: a pinned buffer
        freed or rewritten while its copy is queued would send other
        bytes.  Rings that share one stream (`vins_stream.stream_many`)
        each hold their own buffers and events; nothing here waits."""
        if self.device.type != "cuda":
            return [torch.from_numpy(b).to(self.device) for b in bufs]
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        pinned = [torch.from_numpy(b).pin_memory() for b in bufs]
        out = [p.to(self.device, non_blocking=True) for p in pinned]
        done = torch.cuda.Event()
        done.record()
        self._inflight.append((done, pinned))
        return out

    def current_window(self):
        """Post-solve states of the poses currently in the window (slot
        order; slot = global_id % W), as numpy arrays."""
        if self._carry is None:
            return None
        q, t, v, b, lx, marg = self._carry
        return {name: x.cpu().numpy()
                for name, x in zip("qtvb", (q, t, v, b))}

    # ---- columnar chunk finalization (one conversion per keyframe) ----

    def _lm_chunk(self, g: int) -> Dict[str, Any]:
        """Columnar view of the landmarks anchored at keyframe g."""
        ch = self._lm_chunks.get(g)
        if ch is None:
            ids = np.array(self._lm_by_ref.get(g, ()), np.int64)
            lms = [self._lms[i] for i in ids]
            ch = dict(
                ids=ids,
                x_w=(np.stack([d["x_w"] for d in lms]) if lms
                     else np.zeros((0, 4), self.dtype)),
                ref_cam=np.array([d["ref_cam"] for d in lms], np.int64),
                z_ref=(np.stack([d["z_ref"] for d in lms]) if lms
                       else np.zeros((0, 2), self.dtype)),
                has_z=np.array([d["has_z_ref"] for d in lms], bool))
            self._lm_chunks[g] = ch
        return ch

    def _chunk(self, fam: str, g: int, build) -> Dict[str, Any]:
        ch = self._chunks[fam].get(g)
        if ch is None:
            ch = build(self._pend[fam].get(g, ()))
            self._chunks[fam][g] = ch
        return ch

    def _stack(self, rows, key, shape, dtype=None):
        dtype = self.dtype if dtype is None else dtype
        return (np.stack([r[key] for r in rows]) if rows
                else np.zeros((0,) + shape, dtype))

    def _proj_chunk(self, g: int) -> Dict[str, Any]:
        def build(rows):
            lm = np.array([r["lm"] for r in rows], np.int64)
            return dict(
                z=self._stack(rows, "z", (2,)),
                lm=lm,
                # the anchor pose of each row's landmark, for the per-slide
                # aliveness filter; -1 (always filtered) when the anchor
                # already left the window (the batch build drops those
                # rows too)
                lm_ref=np.array(
                    [self._lms[i]["ref_pose"] if i in self._lms else -1
                     for i in lm], np.int64),
                cam=np.array([r["cam"] for r in rows], np.int64),
                weight=np.array([r["weight"] for r in rows], self.dtype),
                cond=np.array([r["cond"] for r in rows], bool))
        return self._chunk("proj", g, build)

    def _imu_chunk(self, g: int) -> Dict[str, Any]:
        def build(rows):
            M = self.caps.imu_span
            return dict(
                pose1=np.array([r["pose1"] for r in rows], np.int64),
                pose2=np.array([r["pose2"] for r in rows], np.int64),
                w=self._stack(rows, "w", (M, 3)),
                a=self._stack(rows, "a", (M, 3)),
                time=self._stack(rows, "time", (M,)),
                meas_valid=self._stack(rows, "meas_valid", (M,), bool),
                weight=np.array([r["weight"] for r in rows], self.dtype),
                cond=np.array([r["cond"] for r in rows], bool))
        return self._chunk("imu", g, build)

    def _unary_chunk(self, g: int) -> Dict[str, Any]:
        def build(rows):
            return dict(
                pose=np.array([r["pose"] for r in rows], np.int64),
                q=self._stack(rows, "q", (4,)),
                t=self._stack(rows, "t", (3,)),
                cov_inv=self._stack(rows, "cov_inv", (6, 6)))
        return self._chunk("unary", g, build)

    def _binary_chunk(self, g: int) -> Dict[str, Any]:
        def build(rows):
            return dict(
                pose1=np.array([r["pose1"] for r in rows], np.int64),
                pose2=np.array([r["pose2"] for r in rows], np.int64),
                q=self._stack(rows, "q", (4,)),
                t=self._stack(rows, "t", (3,)),
                cov_inv=self._stack(rows, "cov_inv", (6, 6)))
        return self._chunk("binary", g, build)

    def _init_carry(self):
        """First-window carry.  Unlike the batch carry0, lx starts at zero:
        slide 0 loads all its landmarks through new_lm_mask."""
        W, L_w = self.W, self.caps.L_w

        def dev(x):
            return torch.as_tensor(x, device=self.device)

        states = tuple(dev(np.stack([self._poses[g][f] for g in range(W)]))
                       for f in "qtvb")
        marg0 = empty_marg_prior(W, self.config.pose_dim, states[1].dtype,
                                 self.device)
        self._carry = states + (dev(np.zeros((L_w, 4), self.dtype)), marg0)

    def _slide_tables(self, k: int) -> Dict[str, Any]:
        """Slide k's slot tables as numpy arrays: the streaming twin of the
        loop body of `fixedlag.build_ring_schedule`, value for value.  The
        only layout differences from the batch tables: `new_lm_x` is
        prepared on the device from `lm_x_w` and the anchor states, and
        slide 0 loads its landmarks through `new_lm_mask` instead of the
        carry."""
        W, L_w, caps, dt = self.W, self.caps.L_w, self.caps, self.dtype
        d: Dict[str, Any] = {}
        win = np.arange(k, k + W)
        inv = np.zeros(W, np.int64)
        inv[win % W] = win
        d["pose_time"] = np.array([self._poses[g]["time"] for g in inv], dt)
        d["pose_mask"] = np.stack([self._poses[g]["mask"] for g in inv])
        d["pose_cam_params"] = np.zeros((W, self._C), dt)
        d["pose_active"] = np.ones(W, bool)
        new_mask = np.zeros(W, bool)
        if k > 0:
            new_mask[(k + W - 1) % W] = True
        d["new_pose_mask"] = new_mask
        for f in "qtvb":
            d[f"new_{f}"] = np.stack([self._poses[g][f] for g in inv])

        # ---- landmark slots (scatter per-keyframe chunks) ----
        lm_chs = [self._lm_chunk(g) for g in win]
        lm_ids = np.concatenate([c["ids"] for c in lm_chs])
        assert len(lm_ids) <= L_w, \
            f"{len(lm_ids)} alive landmarks exceed L_w={L_w}"
        slots_l = lm_ids % L_w
        assert len(np.unique(slots_l)) == len(lm_ids), \
            "alive landmark ids must map 1:1 under mod L_w"
        lm_alive = np.zeros(L_w, bool)
        lm_alive[slots_l] = True
        rp = np.zeros(L_w, np.int64)
        rp[slots_l] = np.concatenate(
            [np.full(len(c["ids"]), g, np.int64)
             for g, c in zip(win, lm_chs)])
        d["lm_ref_pose"] = np.where(lm_alive, rp % W, 0).astype(np.int32)
        rc = np.zeros(L_w, np.int64)
        rc[slots_l] = np.concatenate([c["ref_cam"] for c in lm_chs])
        d["lm_ref_cam"] = rc.astype(np.int32)
        d["lm_active"] = lm_alive
        zr = np.zeros((L_w, 2), dt)
        zr[slots_l] = np.concatenate([c["z_ref"] for c in lm_chs])
        d["lm_z_ref"] = zr
        hz = np.zeros(L_w, bool)
        hz[slots_l] = np.concatenate([c["has_z"] for c in lm_chs])
        d["lm_has_z_ref"] = hz
        xw = np.zeros((L_w, 4), dt)
        xw[slots_l] = np.concatenate([c["x_w"] for c in lm_chs])
        d["lm_x_w"] = xw
        # newly alive = the landmarks anchored at the incoming pose (slide
        # 0: the whole first window).  This mirrors ba_tpu's defect: one
        # added later with an older in-window anchor is never loaded.
        nl_mask = np.zeros(L_w, bool)
        if k == 0:
            nl_mask[:] = lm_alive
        else:
            nl = self._lm_chunk(k + W - 1)["ids"]
            nl_mask[nl % L_w] = True
        d["new_lm_mask"] = nl_mask

        # ---- residual tables (chunk concat + vectorized filters) ----
        pcs = [self._proj_chunk(g) for g in win]
        keep = [c["lm_ref"] >= k for c in pcs]
        n_pr = int(sum(m.sum() for m in keep))
        assert n_pr <= caps.n_proj, \
            f"{n_pr} projection rows exceed capacity {caps.n_proj}"
        Np = caps.n_proj

        def cat_p(f):
            return np.concatenate([c[f][m] for c, m in zip(pcs, keep)])

        d["proj_z"] = _pad_rows(cat_p("z"), Np)
        pose_rows = np.concatenate(
            [np.full(int(m.sum()), g, np.int64) for g, m in zip(win, keep)])
        d["proj_pose"] = _pad_rows(pose_rows % W, Np).astype(np.int32)
        d["proj_lm"] = _pad_rows(cat_p("lm") % L_w, Np).astype(np.int32)
        d["proj_cam"] = _pad_rows(cat_p("cam"), Np).astype(np.int32)
        d["proj_weight"] = _pad_rows(cat_p("weight"), Np)
        d["proj_valid"] = _pad_rows(np.ones(n_pr, bool), Np, False)
        d["proj_cond"] = _pad_rows(cat_p("cond"), Np, False)

        def in_win(c):
            return ((c["pose1"] >= k) & (c["pose1"] < k + W)
                    & (c["pose2"] >= k) & (c["pose2"] < k + W))

        ics = [self._imu_chunk(g) for g in win]
        ikeep = [in_win(c) for c in ics]
        n_im = int(sum(m.sum() for m in ikeep))
        assert n_im <= caps.n_imu
        Ni = caps.n_imu

        def cat_i(f):
            return np.concatenate([c[f][m] for c, m in zip(ics, ikeep)])

        d["imu_pose1"] = _pad_rows(cat_i("pose1") % W, Ni).astype(np.int32)
        d["imu_pose2"] = _pad_rows(cat_i("pose2") % W, Ni).astype(np.int32)
        d["imu_w"] = _pad_rows(cat_i("w"), Ni)
        d["imu_a"] = _pad_rows(cat_i("a"), Ni)
        d["imu_time"] = _pad_rows(cat_i("time"), Ni)
        d["imu_meas_valid"] = _pad_rows(cat_i("meas_valid"), Ni, False)
        d["imu_weight"] = _pad_rows(cat_i("weight"), Ni, 1)
        d["imu_valid"] = _pad_rows(np.ones(n_im, bool), Ni, False)
        d["imu_cond"] = _pad_rows(cat_i("cond"), Ni, False)

        ucs = [self._unary_chunk(g) for g in win]
        n_un = int(sum(len(c["pose"]) for c in ucs))
        assert n_un <= caps.n_unary
        Nu = caps.n_unary

        def cat_u(f):
            return np.concatenate([c[f] for c in ucs])

        d["unary_pose"] = _pad_rows(cat_u("pose") % W, Nu).astype(np.int32)
        d["unary_q"] = _pad_rows(cat_u("q"), Nu)
        d["unary_q"][n_un:, 0] = 1.0
        d["unary_t"] = _pad_rows(cat_u("t"), Nu)
        d["unary_cov_inv"] = _pad_rows(cat_u("cov_inv"), Nu)
        d["unary_valid"] = _pad_rows(np.ones(n_un, bool), Nu, False)

        bcs = [self._binary_chunk(g) for g in win]
        bkeep = [in_win(c) for c in bcs]
        n_bi = int(sum(m.sum() for m in bkeep))
        assert n_bi <= caps.n_binary
        Nb = caps.n_binary

        def cat_b(f):
            return np.concatenate([c[f][m] for c, m in zip(bcs, bkeep)])

        d["binary_pose1"] = _pad_rows(cat_b("pose1") % W, Nb).astype(
            np.int32)
        d["binary_pose2"] = _pad_rows(cat_b("pose2") % W, Nb).astype(
            np.int32)
        d["binary_q"] = _pad_rows(cat_b("q"), Nb)
        d["binary_q"][n_bi:, 0] = 1.0
        d["binary_t"] = _pad_rows(cat_b("t"), Nb)
        d["binary_cov_inv"] = _pad_rows(cat_b("cov_inv"), Nb)
        d["binary_valid"] = _pad_rows(np.ones(n_bi, bool), Nb, False)

        # structure index over slot ids (the batch build's call)
        px = slot_index(d, W, L_w)
        for name, cap in (("pair_a", caps.n_pair), ("wb_pose", caps.n_wb),
                          ("bpair_a", caps.n_bpair),
                          ("ipair_a", caps.n_ipair), ("sp_i", caps.n_sp)):
            assert getattr(px, name).shape[0] <= cap, \
                f"pidx.{name} {getattr(px, name).shape[0]} > cap {cap}"
        caps_of = dict(pair_a=caps.n_pair, pair_b=caps.n_pair,
                       wb_pose=caps.n_wb, wb_lm=caps.n_wb,
                       bpair_a=caps.n_bpair, bpair_b=caps.n_bpair,
                       ipair_a=caps.n_ipair, ipair_b=caps.n_ipair,
                       sp_i=caps.n_sp, sp_j=caps.n_sp, sp_valid=caps.n_sp)
        for name, cap in caps_of.items():
            d[name] = _pad_rows(getattr(px, name), cap,
                                False if name == "sp_valid" else 0)
        d["drop_slot"] = np.array([k % W], np.int32)
        return d

    def _retire(self, k: int) -> None:
        """Prune buffers after slide k retired pose k (O(window))."""
        self._poses.pop(k, None)
        for lid in self._lm_by_ref.pop(k, ()):
            self._lms.pop(lid, None)
        self._lm_chunks.pop(k, None)
        for fam in ("proj", "imu", "unary", "binary"):
            self._pend[fam].pop(k, None)
            self._chunks[fam].pop(k, None)
