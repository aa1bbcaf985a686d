"""K2's schedule (kernels/csrc/imu_preint.cu) written in torch and held to
ba_tpu on the CPU in f64.

  * The integration as the kernel schedules it, chunk by chunk of 16
    steps: one primal RK4 scan that keeps the pre-step states, every
    step's [A | B] at once from its stored state, Q_k = (B_k R / dt_k)
    B_k^T with one division per element of B, then the chunk's triples
    reduced pairwise, later after earlier, an odd count's last element
    passing to the next round unchanged; each chunk's product goes onto a
    stack that merges equal sizes as a binary counter carries, and the
    stack merges from the top at the end.  (y, C10, Phi, Bsum) equal the
    port's `integrate_full` and ba_tpu's to 1e-12, on spans of 11 and 6
    slots, of 101 slots (seven chunks, the last partial), and on spans
    whose last steps are padding.
  * The kernel's whitening epilogue, span by span in its scalar order (the
    cached C9 where `calculate_inertial_covariance_once` has set it, C9 +
    eps9 I, the blocked 3 x 3 Cholesky and its triangular inverse, the
    rotation marginal, the bias block, the robust weight with conditioning
    edges exempt, the valid and rotation-only masks), applied to ba_tpu's
    own unwhitened r, j1, j2 and C9, equals ba_tpu's `evaluate` (its
    `_whiten_from_c9` and `_whiten_pack`) to 1e-12 at pose_dim 9 and 15,
    under `imu_rotation_only`, with conditioning edges, weights below 1,
    a cached covariance and invalid spans.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from ba_tpu.core.residuals import imu as jimu
from ba_tpu_torch.core.residuals import imu as timu

from test_torch_common import assert_rel, jax_problem, to_torch

TOL = 1e-12


# ---------------------------------------------------------------------------
# The integration's schedule


CH = 16        # steps per chunk (csrc/imu_preint.cu)


def _combine(x, y):
    """The later triple y after the earlier x."""
    (A1, B1, Q1), (A2, B2, Q2) = x, y
    return (A2 @ A1, A2 @ B1 + B2, (A2 @ Q1) @ A2.mT + Q2)


def _reduce_pairwise(elems):
    """Pairwise, later after earlier; an odd tail passes unchanged."""
    while len(elems) > 1:
        nxt = [_combine(elems[j], elems[j + 1])
               for j in range(0, len(elems) - 1, 2)]
        if len(elems) % 2:
            nxt.append(elems[-1])
        elems = nxt
    return elems[0]


def kernel_integrate(q1, t1, v1, b, w, a, times, g, r_imu):
    """(y_S, C10, Phi, Bsum) of every span, batched over spans, in the
    order csrc/imu_preint.cu computes them."""
    n, M = w.shape[:2]
    S = M - 1
    dts = times[:, 1:] - times[:, :-1]
    bg, ba = b[:, :3], b[:, 3:]
    # the primal scan: y_0 .. y_S
    step = vmap(timu._step10, in_dims=timu._STEP_DIMS)
    ys = [torch.cat([t1, q1, v1], dim=-1)]
    for k in range(S):
        yn = step(ys[-1], w[:, k], a[:, k], w[:, k + 1], a[:, k + 1],
                  dts[:, k], bg, ba, g)
        ys.append(torch.where((dts[:, k] > 0)[:, None], yn, ys[-1]))
    # every step's [A | B] at once, from its stored state
    eye = torch.eye(10, dtype=t1.dtype)
    jac = vmap(jacfwd(timu._step_z), in_dims=timu._STEP_DIMS)
    elems = []
    for k in range(S):
        z = torch.cat([ys[k], ys[k].new_zeros((n, 6))], dim=-1)
        J = jac(z, w[:, k], a[:, k], w[:, k + 1], a[:, k + 1], dts[:, k],
                bg, ba, g)
        on = (dts[:, k] > 0)[:, None, None]
        A = torch.where(on, J[..., :10], eye)
        B = torch.where(on, J[..., 10:], 0.0)
        # one division per element of B: (B r) / dt
        Bs = torch.where(on, B * r_imu / dts[:, k, None, None], 0.0)
        Q = torch.where(on, Bs @ B.mT, 0.0)
        elems.append((A, B, Q))
    if not elems:
        elems = [(eye.expand(n, 10, 10), t1.new_zeros((n, 10, 6)),
                  t1.new_zeros((n, 10, 10)))]
    # each chunk reduced pairwise, then onto the stack: after the c-th
    # chunk, one merge per trailing zero bit of c; the rest from the top
    stack = []
    for c, k0 in enumerate(range(0, len(elems), CH), start=1):
        stack.append(_reduce_pairwise(elems[k0:k0 + CH]))
        while c % 2 == 0:
            stack[-2:] = [_combine(stack[-2], stack[-1])]
            c //= 2
    while len(stack) > 1:
        stack[-2:] = [_combine(stack[-2], stack[-1])]
    Phi, Bsum, C = stack[0]
    return ys[-1], C, Phi, Bsum


def _span_inputs(jp):
    im, poses = jp.imu, jp.poses
    q1, t1 = poses.q[im.pose1], poses.t[im.pose1]
    v1, b1 = poses.v[im.pose1], poses.b[im.pose1]
    return (q1, t1, v1, b1, im.w, im.a, im.time, jp.g_vec)


@pytest.mark.parametrize("span", ["slots11", "slots6", "padded", "slots101",
                                  "padded101"])
def test_kernel_schedule_matches_integrate_full(span):
    imu_per_span = {"slots6": 5, "slots101": 100, "padded101": 100}.get(
        span, 10)
    jp, jcfg, _ = jax_problem(n_poses=8, n_lms=32)
    if imu_per_span != 10:
        from ba_tpu.io import simulate_vins as jsv

        sim = jsv.simulate(n_poses=8, n_lms=32, seed=0,
                           imu_per_span=imu_per_span)
        jp = jsv.build_problem(sim, jcfg, perturb=0.01, seed=1)[0]
    ins = [np.asarray(x) for x in _span_inputs(jp)]
    if span.startswith("padded"):
        # the last steps of every other span are padding (dt = 0): 3, or
        # 37 (two chunks and a part)
        npad = 3 if span == "padded" else 37
        times = ins[6].copy()
        times[::2, -npad:] = times[::2, -npad - 1:-npad]
        ins[6] = times
    M = ins[4].shape[1]
    assert M == imu_per_span + 1
    r_imu = np.array([jcfg.gyro_sigma**2] * 3 + [jcfg.accel_sigma**2] * 3)
    t_ins = [torch.as_tensor(x) for x in ins]
    got = kernel_integrate(*t_ins, torch.as_tensor(r_imu))
    port = timu.integrate_full(*t_ins, torch.as_tensor(r_imu))
    want = jax.jit(jax.vmap(jimu.integrate_full,
                            in_axes=(0,) * 7 + (None, None)))(
        *[jnp.asarray(x) for x in ins], jnp.asarray(r_imu))
    for name, g, p, w in zip(("y", "C10", "Phi", "Bsum"), got, port, want):
        assert_rel(g, np.asarray(w), TOL, f"{name} vs ba_tpu")
        assert_rel(g, p.numpy(), TOL, f"{name} vs integrate_full")


# ---------------------------------------------------------------------------
# The whitening epilogue


def chol3(A):
    """utils/linalg.py:chol3 entry by entry, as the kernel computes it."""
    def clamp0(x):
        return torch.clamp(x, min=0.0)

    l11 = torch.sqrt(clamp0(A[..., 0, 0]))
    d1 = torch.clamp(l11, min=1e-30)
    l21, l31 = A[..., 1, 0] / d1, A[..., 2, 0] / d1
    l22 = torch.sqrt(clamp0(A[..., 1, 1] - l21 * l21))
    d2 = torch.clamp(l22, min=1e-30)
    l32 = (A[..., 2, 1] - l31 * l21) / d2
    l33 = torch.sqrt(clamp0(A[..., 2, 2] - l31 * l31 - l32 * l32))
    L = A.new_zeros(A.shape)
    L[..., 0, 0], L[..., 1, 0], L[..., 1, 1] = l11, l21, l22
    L[..., 2, 0], L[..., 2, 1], L[..., 2, 2] = l31, l32, l33
    return L


def tri_inv3(L):
    i11, i22, i33 = 1.0 / L[..., 0, 0], 1.0 / L[..., 1, 1], 1.0 / L[..., 2, 2]
    W = L.new_zeros(L.shape)
    W[..., 0, 0], W[..., 1, 1], W[..., 2, 2] = i11, i22, i33
    W[..., 1, 0] = -L[..., 1, 0] * i11 * i22
    W[..., 2, 1] = -L[..., 2, 1] * i22 * i33
    W[..., 2, 0] = (L[..., 1, 0] * L[..., 2, 1]
                    - L[..., 2, 0] * L[..., 1, 1]) * i11 * i22 * i33
    return W


def whiten_from_cov(C, n):
    """chol(C)^-1 of (..., 3n, 3n) by the kernel's block loops."""
    blk = lambda M, i, j: M[..., 3 * i:3 * i + 3, 3 * j:3 * j + 3]  # noqa
    L, Ri, W = {}, {}, {}
    for i in range(n):
        for j in range(i + 1):
            A = blk(C, i, j).clone()
            for k in range(j):
                A = A - L[i, k] @ L[j, k].mT
            if i == j:
                L[i, i] = chol3(A)
                Ri[i] = tri_inv3(L[i, i])
            else:
                L[i, j] = A @ Ri[j].mT
    for i in range(n):
        W[i, i] = tri_inv3(L[i, i])
    for i in range(n):
        for j in range(i - 1, -1, -1):
            A = L[i, j] @ W[j, j]
            for k in range(j + 1, i):
                A = A + L[i, k] @ W[k, j]
            W[i, j] = (-W[i, i]) @ A
    S = C.new_zeros(C.shape)
    for (i, j), Wij in W.items():
        S[..., 3 * i:3 * i + 3, 3 * j:3 * j + 3] = Wij
    return S


def kernel_whiten(r, j1, j2, c9, im, cfg):
    """(r, j1, j2, err_sq, c9) of every span as the kernel's epilogue
    whitens the unwhitened r, j1, j2 (Ni, R, D) and C9."""
    Ni, R = r.shape
    dtype = r.dtype
    if cfg.calculate_inertial_covariance_once:
        c9 = torch.where(im.c9_set, im.c9, c9)
    eps9 = 1e-12 if dtype == torch.float64 else 1e-8
    Ce = c9 + eps9 * torch.eye(9, dtype=dtype)
    S = r.new_zeros((Ni, R, R))
    if cfg.imu_rotation_only:
        S[:, 3:6, 3:6] = whiten_from_cov(Ce[:, 3:6, 3:6].contiguous(), 1)
    else:
        S[:, :9, :9] = whiten_from_cov(Ce, 3)
    if R == 15:
        dt_total = torch.clamp(im.time.amax(-1) - im.time[:, 0], min=1e-12)
        rb = [cfg.gyro_bias_sigma**2] * 3 + [cfg.accel_bias_sigma**2] * 3
        for k in range(6):
            S[:, 9 + k, 9 + k] = 1.0 / torch.sqrt(rb[k] * dt_total)
    wgt = torch.where(im.cond, torch.ones_like(im.weight), im.weight)
    S = S * torch.sqrt(wgt)[:, None, None]
    keep = torch.ones(R, dtype=dtype)
    if cfg.imu_rotation_only:
        keep = ((torch.arange(R) >= 3) & (torch.arange(R) < 6)).to(dtype)
    valid = im.valid
    rw = torch.where(valid[:, None], (S @ r[..., None])[..., 0], 0.0) * keep
    j1w = (S @ torch.where(valid[:, None, None], j1, 0.0)) * keep[:, None]
    j2w = (S @ torch.where(valid[:, None, None], j2, 0.0)) * keep[:, None]
    return rw, j1w, j2w, (rw * rw).sum(-1), c9


def _case(kind):
    """(JAX problem, JAX config) of one whitening case."""
    jp, jcfg, _ = jax_problem(n_poses=10, n_lms=40,
                              pose_dim=15 if kind == "pose_dim15" else 9)
    rng = np.random.default_rng(5)
    Ni = jp.imu.weight.shape[0]
    im = jp.imu
    if kind == "rotation_only":
        jcfg = dataclasses.replace(jcfg, imu_rotation_only=True)
        im = dataclasses.replace(im, weight=jnp.asarray(
            rng.uniform(0.3, 1.0, Ni)))
    elif kind == "cond_edges":
        cond = np.zeros(Ni, bool)
        cond[::3] = True
        im = dataclasses.replace(im, cond=jnp.asarray(cond),
                                 weight=jnp.asarray(rng.uniform(0.2, 0.9,
                                                                Ni)))
    elif kind == "weights":
        im = dataclasses.replace(im, weight=jnp.asarray(
            rng.uniform(0.05, 1.0, Ni)))
    elif kind == "cov_once":
        jcfg = dataclasses.replace(jcfg,
                                   calculate_inertial_covariance_once=True)
        c9 = np.asarray(jax.jit(lambda p: jimu.evaluate(p, jcfg, True))(
            jp).c9)
        im = dataclasses.replace(im, c9=jnp.asarray(1.3 * c9),
                                 c9_set=jnp.ones((), bool))
    elif kind == "invalid":
        valid = np.asarray(im.valid).copy()
        valid[1::4] = False
        im = dataclasses.replace(im, valid=jnp.asarray(valid))
    return dataclasses.replace(jp, imu=im), jcfg


@pytest.mark.parametrize("kind", ["pose_dim9", "pose_dim15", "rotation_only",
                                  "cond_edges", "weights", "cov_once",
                                  "invalid"])
def test_kernel_whitening_matches_ba_tpu_evaluate(kind, monkeypatch):
    jp, jcfg = _case(kind)
    # a fresh function per jit: the traces must not be shared with the
    # patched one below
    want = jax.jit(lambda p: jimu.evaluate(p, jcfg, True))(jp)
    # ba_tpu's own unwhitened r, j1, j2 and C9: its evaluate with the
    # identity for the whitening factor, every span valid, all rows kept
    R = 15 if jcfg.bias_in_state else 9
    Ni = jp.imu.weight.shape[0]
    monkeypatch.setattr(jimu, "_whiten_from_c9", lambda problem, config, C9,
                        im, dtype: jnp.broadcast_to(jnp.eye(R, dtype=dtype),
                                                    (Ni, R, R)))
    raw_cfg = dataclasses.replace(jcfg, imu_rotation_only=False,
                                  calculate_inertial_covariance_once=False)
    raw_p = dataclasses.replace(jp, imu=dataclasses.replace(
        jp.imu, valid=jnp.ones_like(jp.imu.valid)))
    raw = jax.jit(lambda p: jimu.evaluate(p, raw_cfg, True))(raw_p)
    monkeypatch.undo()
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    im = to_torch(jp).imu
    got = kernel_whiten(t(raw.r), t(raw.j1), t(raw.j2), t(raw.c9), im, jcfg)
    if kind == "cov_once":
        assert bool(jnp.all(want.c9 == jp.imu.c9))
    if kind == "invalid":
        assert not bool(im.valid.all())
    for name, g in zip(("r", "j1", "j2", "err_sq", "c9"), got):
        assert_rel(g, np.asarray(getattr(want, name)), TOL, name)
