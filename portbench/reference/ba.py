"""Gauss-Newton bundle adjustment, plain and dense.

The objective of a configuration, written from its description:

  * projection rows r = z - project(camera of the measuring pose, point),
    with XYZ points (lm_size 3) or inverse-depth points on their reference
    camera's ray (lm_size 1: the ray from the reference pixel, the inverse
    distance optimized);
  * Huber weights on the squared pixel error, scale sqrt of the lower
    median of the population (rows whose reference pose is fixed and whose
    measuring pose is not form their own), c = 1.2107 * scale, weight c/e
    past c, frozen for the iteration's trial costs;
  * IMU spans (`imu.py`) whitened by their propagated covariance;
  * the optimized dims of a pose: the first `pose_dim` of [t, w, v, bg,
    ba] on an active pose, velocity and biases only with an IMU span;
  * the reduced camera system S = U - W (V + 1e-6 I)^-1 W^T, formed dense
    per window, damped by `damping` * diag(S); the pose step by the PCG the
    configuration states (block-Jacobi, stop at |r| <= tol |b| or the
    iteration cap) or exactly (Cholesky); the landmark step by
    back-substitution; the update x <- x (-) delta; a step kept when the
    trial cost does not rise.

`solve` returns the cost after each iteration, the step norms and the
final states.  Every block product goes through `Build.mm`, which in the
control (`tf32`) rounds both operands to TF32: cuBLAS runs these tiny
batched products on CUDA cores, where the TF32 switch alone changes
nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch.func import jvp, vmap

from . import geometry as geo
from . import imu as imu_ref

HUBER_C = 1.2107
V_FLOOR = 1e-6
CHUNK = 1 << 19          # rows per batched Jacobian evaluation
PAIR_CHUNK = 1 << 22     # W-block pairs per scatter


@dataclass(frozen=True)
class Semantics:
    pose_dim: int
    lm_size: int
    route: str                  # "cg" or "exact"
    iterations: int
    cg_max_iterations: int = 100
    cg_tolerance: float = 1e-6
    damping: float = 1e-4       # the configuration's precision: f32
    robust: bool = True
    outlier_threshold: float = 1.0
    windows: int = 1
    imu: Optional[imu_ref.ImuNoise] = None


def semantics(config: dict, mix: dict, windows: int) -> Semantics:
    """The semantics of a cell from its configuration's solver and its
    mix: the route the configuration states, the damping of its
    precision.  Gauss-Newton only: a mix that keeps the port's default
    dogleg is refused."""
    s = dict(config["solver"], **mix.get("solver", {}))
    if s.get("use_dogleg", True):
        raise NotImplementedError("reference: Gauss-Newton only; the mix "
                                  "must set use_dogleg false")
    route = "cg" if s.get("use_cg_solver") else "exact"
    damping = 1e-4 if s.get("dtype", "float32") == "float32" else 1e-8
    noise = imu_ref.ImuNoise.from_config(s) if s.get("imu") else None
    return Semantics(
        pose_dim=s["pose_dim"], lm_size=s["lm_size"], route=route,
        iterations=mix["iterations"],
        cg_max_iterations=s.get("cg_max_iterations", 100),
        cg_tolerance=s.get("cg_tolerance", 1e-6), damping=damping,
        robust=s.get("use_robust_norm_for_proj_residuals", True),
        outlier_threshold=s.get("outlier_threshold", 1.0), windows=windows,
        imu=noise)


@dataclass
class State:
    q: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    b: torch.Tensor
    lm: torch.Tensor          # (L, 3) points, or (L,) inverse distances


# ---------------------------------------------------------------------------
# projection rows
# ---------------------------------------------------------------------------

def initial_state(sc, sem: Semantics) -> tuple[State, Optional[torch.Tensor]]:
    """The start state and, for inverse depth, the fixed unit rays: the
    reference pixel unprojected where there is one, else the direction to
    the start point; the inverse distance from the start point."""
    if sem.lm_size == 3:
        return State(sc.q, sc.t, sc.v, sc.b, sc.x_w.clone()), None
    rp, rc = sc.ref_pose, sc.ref_cam
    p_s = geo.to_sensor(sc.q[rp], sc.t[rp], sc.tvs_q[rc], sc.tvs_t[rc],
                        sc.x_w)
    dist = p_s.norm(dim=-1)
    params = sc.cam_params[rp] if sc.per_pose_intrinsics else sc.cam[rc]
    ray = torch.where(sc.has_z_ref[:, None],
                      geo.unproject_poly3(params, sc.z_ref),
                      p_s / dist[:, None])
    return State(sc.q, sc.t, sc.v, sc.b, 1.0 / dist), ray


def _proj_fn(inverse_depth: bool):
    def r_xyz(d, z, qm, tm, tq, tt, prm, x):
        q, t = geo.retract(qm, tm, d[..., 0:6])
        p = geo.to_sensor(q, t, tq, tt, x + d[..., 6:9])
        return z - geo.project_poly3(prm, p)

    def r_inv(d, z, qm, tm, qr, tr, tqm, ttm, tqr, ttr, prm, ray, rho):
        q1, t1 = geo.retract(qm, tm, d[..., 0:6])
        q2, t2 = geo.retract(qr, tr, d[..., 6:12])
        w = rho[..., None] + d[..., 12:13]
        xw = geo.from_sensor(q2, t2, tqr, ttr, ray, w)
        p = geo.to_sensor(q1, t1, tqm, ttm, xw, w)
        return z - geo.project_poly3(prm, p)

    return r_inv if inverse_depth else r_xyz


def proj_rows(sc, st: State, ray, sem: Semantics, jac: bool):
    """(r (N, 2), J (N, 2, 6 + 6 + lm) or None): residuals and Jacobians
    wrt [measuring pose | reference pose (inverse depth) | landmark]."""
    inv = sem.lm_size == 1
    fn = _proj_fn(inv)
    N = sc.obs_z.shape[0]
    rs, js = [], []
    for s in range(0, N, CHUNK):
        sl = slice(s, s + CHUNK)
        pm, lm, cm = sc.obs_pose[sl], sc.obs_lm[sl], sc.obs_cam[sl]
        prm = sc.cam_params[pm] if sc.per_pose_intrinsics else sc.cam[cm]
        if inv:
            rp, rc = sc.ref_pose[lm], sc.ref_cam[lm]
            args = (sc.obs_z[sl], st.q[pm], st.t[pm], st.q[rp], st.t[rp],
                    sc.tvs_q[cm], sc.tvs_t[cm], sc.tvs_q[rc], sc.tvs_t[rc],
                    prm, ray[lm], st.lm[lm])
            nd = 13
        else:
            args = (sc.obs_z[sl], st.q[pm], st.t[pm], sc.tvs_q[cm],
                    sc.tvs_t[cm], prm, st.lm[lm])
            nd = 9
        d0 = args[0].new_zeros((args[0].shape[0], nd))
        rs.append(fn(d0, *args))
        if jac:
            # forward mode along each tangent axis, every row at once
            basis = torch.eye(nd, dtype=d0.dtype, device=d0.device)[
                :, None, :].expand(nd, d0.shape[0], nd)
            js.append(vmap(lambda u: jvp(lambda d: fn(d, *args), (d0,),
                                         (u,))[1], out_dims=2)(basis))
    r = torch.cat(rs)
    if not jac:
        return r, None
    J = torch.cat(js).to(r.dtype)
    if inv:
        same = (sc.obs_pose == sc.ref_pose[sc.obs_lm])[:, None, None]
        J = torch.cat([torch.where(same, 0.0, J[..., :12]), J[..., 12:]], -1)
    return r, J


def lower_median(x):
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(())
    return torch.kthvalue(x, (n - 1) // 2 + 1).values


def huber_weights(err_sq, cond, threshold):
    w = torch.ones_like(err_sq)
    e = torch.sqrt(torch.clamp(err_sq, min=1e-30))
    for pop in (cond, ~cond):
        sigma = torch.sqrt(lower_median(err_sq[pop]))
        if float(sigma) > 0:
            c = HUBER_C * sigma * threshold
            w = torch.where(pop & (e > c), c / e, w)
    return w


# ---------------------------------------------------------------------------
# the dense reduced system
# ---------------------------------------------------------------------------

class Build:
    """Weighted rows of one iteration and everything a step needs."""

    def __init__(self, sc, st, ray, sem: Semantics, col_mask, tf32=False):
        D, lmz, P = sem.pose_dim, sem.lm_size, sc.n_poses
        self.tf32 = tf32
        self.sc, self.sem, self.P, self.D = sc, sem, P, D
        cond = ~sc.active[sc.ref_pose[sc.obs_lm]] & sc.active[sc.obs_pose]
        self.clock = _Clock(sc.q.device)
        self.clock.lap(None)
        r, J = proj_rows(sc, st, None if ray is None else ray, sem, True)
        err = (r * r).sum(-1)
        self.w = (huber_weights(err, cond, sem.outlier_threshold)
                  if sem.robust else torch.ones_like(err))
        sw = torch.sqrt(self.w)
        cm = col_mask.reshape(P, D)[:, :6].to(r.dtype)
        jm = J[..., 0:6] * cm[sc.obs_pose][:, None] * sw[:, None, None]
        self.rows = [(sc.obs_pose, jm)]
        off = 6
        if lmz == 1:
            ref = sc.ref_pose[sc.obs_lm]
            jr = J[..., 6:12] * cm[ref][:, None] * sw[:, None, None]
            self.rows.append((ref, jr))
            off = 12
        self.jl = J[..., off:off + lmz] * sw[:, None, None]
        self.r = r * sw[:, None]
        self.cost = (self.w * err).sum()
        self.imu = None
        self.clock.lap("projection rows")
        if sem.imu is not None and sc.imu_pose1.shape[0]:
            self.imu = imu_ref.evaluate(sc, st, sem.imu, D, jac=True)
            cmD = col_mask.reshape(P, D).to(r.dtype)
            ev = self.imu
            self.imu_j = [(sc.imu_pose1, ev.j1 * cmD[sc.imu_pose1][:, None]),
                          (sc.imu_pose2, ev.j2 * cmD[sc.imu_pose2][:, None])]
            self.cost = self.cost + (ev.r * ev.r).sum()
        self.col_mask = col_mask
        self.clock.lap("imu")
        self._normal_equations()
        self.clock.lap("normal equations")

    def mm(self, a, b):
        """a @ b, with both operands rounded to TF32 in the control."""
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def _window_index(self, pose, width):
        """Flat (window, row) offsets of the first dim of each pose."""
        Pw = self.P // self.sem.windows
        return pose // Pw, (pose % Pw) * self.D

    def _scatter(self, S, pa, pb, blocks):
        """S[win(pa), rows of pa, cols of pb] += blocks (n, a, b)."""
        n_w = S.shape[-1]
        fa, ra = self._window_index(pa, blocks.shape[1])
        _, rb = self._window_index(pb, blocks.shape[2])
        ia = torch.arange(blocks.shape[1], device=S.device)
        ib = torch.arange(blocks.shape[2], device=S.device)
        idx = (fa[:, None, None] * n_w * n_w
               + (ra[:, None, None] + ia[None, :, None]) * n_w
               + rb[:, None, None] + ib[None, None, :])
        S.view(-1).index_add_(0, idx.reshape(-1), blocks.reshape(-1))

    def _normal_equations(self):
        sc, sem, P, D = self.sc, self.sem, self.P, self.D
        F, L, lmz = sem.windows, sc.n_lms, sem.lm_size
        n_w = (P // F) * D
        dt, dev = self.r.dtype, self.r.device
        S = torch.zeros((F, n_w, n_w), dtype=dt, device=dev)
        bp = torch.zeros((P, D), dtype=dt, device=dev)
        # pose-pose blocks and the pose gradient
        fam = [(self.rows, self.r)]
        if self.imu is not None:
            fam.append((self.imu_j, self.imu.r))
        for rows, r in fam:
            for pa, ja in rows:
                g = self.mm(ja.mT, r[..., None])[..., 0]
                bp.index_add_(0, pa, _pad_cols(g, D))
                for pb, jb in rows:
                    self._scatter(S, pa, pb, self.mm(ja.mT, jb))
        # landmark blocks
        V = torch.zeros((L, lmz, lmz), dtype=dt, device=dev)
        V.index_add_(0, sc.obs_lm, self.mm(self.jl.mT, self.jl))
        bl = torch.zeros((L, lmz), dtype=dt, device=dev)
        bl.index_add_(0, sc.obs_lm,
                      self.mm(self.jl.mT, self.r[..., None])[..., 0])
        eye = torch.eye(lmz, dtype=dt, device=dev)
        Vi = torch.linalg.inv(V + V_FLOOR * eye)
        # W blocks: one per (pose, landmark)
        keys, blocks = [], []
        for pa, ja in self.rows:
            keys.append(pa * L + sc.obs_lm)
            blocks.append(self.mm(ja.mT, self.jl))
        keys, blocks = torch.cat(keys), torch.cat(blocks)
        uk, inv = torch.unique(keys, return_inverse=True)
        Wb = torch.zeros((uk.shape[0], 6, lmz), dtype=dt, device=dev)
        Wb.index_add_(0, inv, blocks)
        wp, wl = uk // L, uk % L                  # sorted by pose, then lm
        order = torch.argsort(wl, stable=True)
        wp, wl, Wb = wp[order], wl[order], Wb[order]
        Y = self.mm(Wb, Vi[wl])                           # W V^-1, (nW, 6, lm)
        # S -= W V^-1 W^T over every pair of one landmark's blocks
        counts = torch.bincount(wl, minlength=L)
        starts = torch.cumsum(counts, 0) - counts
        g = counts[wl]
        first = starts[wl]
        n_pairs = g                               # pairs led by each block
        lead = torch.repeat_interleave(torch.arange(wl.shape[0], device=dev),
                                       n_pairs)
        ends = torch.cumsum(n_pairs, 0)
        within = torch.arange(lead.shape[0], device=dev) \
            - torch.repeat_interleave(ends - n_pairs, n_pairs)
        other = first[lead] + within
        for s in range(0, lead.shape[0], PAIR_CHUNK):
            a, b = lead[s: s + PAIR_CHUNK], other[s: s + PAIR_CHUNK]
            self._scatter(S, wp[a], wp[b], -self.mm(Y[a], Wb[b].mT))
        # reduced rhs
        z = self.mm(Vi, bl[..., None])[..., 0]
        wz = self.mm(Wb, z[wl][..., None])[..., 0]
        bp6 = torch.zeros((P, 6), dtype=dt, device=dev)
        bp6.index_add_(0, wp, wz)
        rhs = bp - torch.nn.functional.pad(bp6, (0, D - 6))
        m = self.col_mask.reshape(P, D)
        self.S, self.Vi, self.bl, self.bp = S, Vi, bl, bp
        self.Wb, self.wp, self.wl = Wb, wp, wl
        self.rhs = torch.where(m, rhs, 0.0).reshape(-1)

    # -- the pose step ----------------------------------------------------
    def _damped(self):
        """(A, mask): S + damping diag(S) on the optimized dims, the
        identity on the others, per window."""
        F, n_w = self.S.shape[0], self.S.shape[-1]
        m = self.col_mask.reshape(F, n_w)
        A = self.S * (m[:, :, None] & m[:, None, :])
        d = torch.diagonal(A, dim1=-2, dim2=-1)
        dn = torch.where(m, torch.clamp(d, min=1e-12), 1.0)
        A = A + torch.diag_embed(torch.where(m, self.sem.damping * dn, 1.0))
        return A, m, dn

    def pose_step(self):
        F, n_w = self.S.shape[0], self.S.shape[-1]
        A, m, dn = self._damped()
        b = self.rhs.reshape(F, n_w)
        if self.sem.route == "exact":
            s = torch.rsqrt(torch.diagonal(A, dim1=-2, dim2=-1))
            As = A * s[:, :, None] * s[:, None, :]
            L = torch.linalg.cholesky(As)
            x = torch.cholesky_solve((b * s)[..., None], L)[..., 0] * s
        else:
            x = self._pcg(A, b, m, dn)
        return torch.where(m, x, 0.0).reshape(-1)

    def _pcg(self, A, b, m, dn):
        """Block-Jacobi PCG from 0 on the damped system, one system over
        every window, stopped at |r|^2 <= (tol |b|)^2 or the cap."""
        F, n_w = b.shape
        D = self.D
        nb = n_w // D
        blk = A.reshape(F, nb, D, nb, D).diagonal(dim1=1, dim2=3)
        blk = blk.permute(0, 3, 1, 2)             # (F, nb, D, D)
        Minv = torch.linalg.inv(blk)

        def mv(x):
            return self.mm(A, x[..., None])[..., 0]

        def prec(r):
            return self.mm(Minv, r.reshape(F, nb, D, 1)).reshape(F, n_w)

        x = torch.zeros_like(b)
        r = b.clone()
        z = prec(r)
        p = z
        rz = (r * z).sum()
        tol2 = (self.sem.cg_tolerance ** 2) * (b * b).sum()
        self.pcg_iterations = 0
        for _ in range(self.sem.cg_max_iterations):
            if not bool((r * r).sum() > tol2):
                break
            Ap = mv(p)
            den = (p * Ap).sum()
            alpha = rz / den if float(den) > 0 else torch.zeros_like(den)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = (r * z).sum()
            beta = rz_new / (rz if float(rz) > 0 else torch.ones_like(rz))
            p = z + beta * p
            rz = rz_new
            self.pcg_iterations += 1
        return x

    def landmark_step(self, dp):
        """V^-1 (b_l - W^T dp)."""
        P, D, L = self.P, self.D, self.sc.n_lms
        d6 = dp.reshape(P, D)[:, :6]
        wt = self.mm(self.Wb.mT, d6[self.wp][..., None])[..., 0]
        acc = torch.zeros_like(self.bl)
        acc.index_add_(0, self.wl, wt)
        return self.mm(self.Vi, (self.bl - acc)[..., None])[..., 0]


def round_tf32(x):
    """x rounded to TF32 (float32 with 10 mantissa bits, to nearest even):
    what a tensor core reads of a float32 operand when TF32 is on."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _pad_cols(j, D):
    return torch.nn.functional.pad(j, (0, D - j.shape[-1]))


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def col_mask(sc, sem: Semantics) -> torch.Tensor:
    """(P * D,) optimized dims: an active pose with any residual; velocity
    and biases only with an IMU span."""
    P, D, dev = sc.n_poses, sem.pose_dim, sc.q.device
    has_imu = torch.zeros(P, dtype=torch.bool, device=dev)
    has_imu[sc.imu_pose1] = True
    has_imu[sc.imu_pose2] = True
    has_any = has_imu.clone()
    has_any[sc.obs_pose] = True
    has_any[sc.ref_pose[sc.obs_lm]] = True
    dims = torch.arange(D, device=dev)
    m = (sc.active & has_any)[:, None] & ((dims < 6)[None] | has_imu[:, None])
    return m.reshape(-1)


def apply(st: State, sem: Semantics, dp, dl, scale=1.0) -> State:
    P, D = st.q.shape[0], sem.pose_dim
    d = dp.reshape(P, D) * scale
    q, t = geo.retract(st.q, st.t, -d[:, :6])
    v = st.v - d[:, 6:9] if D >= 9 else st.v
    b = st.b - d[:, 9:15] if D >= 15 else st.b
    dl = dl * scale
    if sem.lm_size == 3:
        lm = st.lm - dl
    else:
        new = st.lm - dl[:, 0]
        lm = torch.where(new < 0, st.lm, new)
    return State(q, t, v, b, lm)


def trial_cost(sc, st, ray, sem, build: Build):
    r, _ = proj_rows(sc, st, ray, sem, False)
    c = (build.w * (r * r).sum(-1)).sum()
    if build.imu is not None:
        ev = imu_ref.evaluate(sc, st, sem.imu, sem.pose_dim, jac=False,
                              cov=build.imu.cov)
        c = c + (ev.r * ev.r).sum()
    return c


def solve(sc, sem: Semantics, dtype=torch.float64, tf32: bool = False):
    """The cell's solve from the scene's start in `dtype`; with `tf32`
    (the control: float32) every block product of the normal equations,
    the Schur complement, the PCG and the back-substitution takes its
    operands rounded to TF32, as tensor cores would.  Returns dict(costs,
    delta_norms, state, pcg iterations per build, phases)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        sc = dataclasses.replace(sc, **{
            k: v.to(dtype) for k, v in sc.tensors().items()
            if v.is_floating_point()})
        st, ray = initial_state(sc, sem)
        mask = col_mask(sc, sem)
        return _iterate(sc, st, ray, sem, mask, tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class _Clock:
    """Seconds by phase of the reference's solve (synchronized on a card),
    for `PERF.md`'s note of where the check's time goes."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.s = {}
        self.t = None

    def lap(self, name):
        import time
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self.t is not None and name:
            self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def _iterate(sc, st, ray, sem, mask, tf32=False):
    costs, dns, pcg = [], [], []
    clock = _Clock(sc.q.device)
    clock.lap(None)
    for it in range(sem.iterations):
        bd = Build(sc, st, ray, sem, mask, tf32)
        clock.lap(None)
        for k, v in bd.clock.s.items():
            clock.s[k] = clock.s.get(k, 0.0) + v
        dp = bd.pose_step()
        pcg.append(getattr(bd, "pcg_iterations", 0))
        dl = bd.landmark_step(dp)
        clock.lap("step")
        cand = apply(st, sem, dp, dl)
        post = trial_cost(sc, cand, ray, sem, bd)
        dn = torch.sqrt((dp * dp).sum() + (dl * dl).sum())
        if bool(post <= bd.cost):
            st = cand
        else:
            post, dn = bd.cost, torch.zeros_like(dn)
        costs.append(post)
        dns.append(dn)
        clock.lap("trial")
    return dict(costs=torch.stack(costs), delta_norms=torch.stack(dns),
                state=st, pcg_iterations=pcg, phases=clock.s)
