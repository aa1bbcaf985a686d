"""Kernel-level verification + micro-benchmarks CLI, on the port.

Port of `apps/math_test.py`, the analog of the reference's
`applications/math_test`: finite-difference checks of the Lie kernels,
the FOV camera's project/unproject round trip, and the assembled
reprojection GN system (U, W, rhs_p) against a dense oracle, the Jacobian
of a global-perturbation residual stack by `torch.func.jacrev` (its own
scene and oracle: the JAX app's come from its test files).

    python -m ba_tpu_torch.apps.math_test [--f32] [--device cpu]

The checks run on `--device` (cuda unless told otherwise; without CUDA
that default raises), in f64 unless `--f32`; the oracle runs on the CPU
in f64.  With `--f32` it also times a GN iteration of the flagship
(simulate(128 poses, 512 landmarks, seed 0)) on the device.  Prints ALL
PASS and exits 0, or the number of failures and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

FOV = np.array([198.969, 198.1284, 329.9368, 240.1017, 0.9640582])


def make_scene(n_poses=4, n_lms=6, seed=0, perturb=0.05, n_anchor=2):
    """(Problem on the CPU in f64, config): poses on a circle of radius 5
    looking at landmarks near the origin, the FOV camera, inverse-depth
    landmarks referenced to pose 0, pose_dim 6, robust weighting off (the
    oracle is the plain least-squares system)."""
    from ..core import camera as cam_mod
    from ..core import lie
    from ..core.problem import BAConfig, ProblemBuilder
    from ..io.simulate_vins import _quat_from_matrix, fov_project

    rng = np.random.default_rng(seed)
    cfg = BAConfig(pose_dim=6, lm_size=1, use_dogleg=False,
                   use_robust_norm_for_proj_residuals=False)
    b = ProblemBuilder(cfg)
    cam = b.add_camera(FOV, cam_mod.MODEL_FOV)
    R_list, t_list = [], []
    for i in range(n_poses):
        ang = 2 * np.pi * i / n_poses
        pos = np.array([5 * np.cos(ang), 5 * np.sin(ang), 0.0])
        z = -pos / np.linalg.norm(pos)          # look at the origin
        x = np.cross(np.array([0.0, 0, 1]), z)
        x /= np.linalg.norm(x)
        R_list.append(np.stack([x, np.cross(z, x), z], axis=1))
        t_list.append(pos)
    lms_w = rng.normal(size=(n_lms, 3)) * np.array([1.5, 1.5, 1.0])

    pose_ids = []
    for i in range(n_poses):
        active = i >= n_anchor
        q = torch.as_tensor(_quat_from_matrix(R_list[i]))
        if active:
            q = lie.quat_mul(q, lie.so3_exp(torch.as_tensor(
                rng.normal(size=3) * perturb)))
        t = t_list[i] + (rng.normal(size=3) * perturb * 5 if active
                         else 0.0)
        pose_ids.append(b.add_pose(q.numpy(), t, active=active,
                                   time=float(i)))
    c0 = t_list[0]
    lm_ids = [b.add_landmark(c0 + (lms_w[j] - c0)
                             * (1.0 + rng.normal() * perturb),
                             ref_pose=0, ref_cam=cam)
              for j in range(n_lms)]
    for i in range(n_poses):
        for j in range(n_lms):
            z = fov_project(FOV, R_list[i].T @ (lms_w[j] - t_list[i]))
            if 0 <= z[0] < 640 and 0 <= z[1] < 480:
                b.add_projection_residual(z, pose_ids[i], lm_ids[j], cam)
    return b.build(device="cpu"), cfg


def dense_oracle(problem, cfg):
    """(J, r, pose dims) of the weighted reprojection residuals under a
    global perturbation of every pose and landmark, J by jacrev; columns
    of masked dims zeroed, as the assembly masks them."""
    from torch.func import jacrev

    from ..core import lie
    from ..core.residuals import reprojection

    D, lmsz = cfg.pose_dim, cfg.lm_size
    P, L = problem.poses.q.shape[0], problem.lms.x.shape[0]
    sw = torch.sqrt(torch.where(problem.proj.valid, problem.proj.weight,
                                0.0))

    def residuals(delta):
        dp = delta[: P * D].reshape(P, D)
        dl = delta[P * D:].reshape(L, lmsz)
        q, t = lie.se3_retract((problem.poses.q, problem.poses.t),
                               dp[:, :6])
        x = problem.lms.x
        x = torch.cat([x[:, :3], x[:, 3:] + dl], 1) if lmsz == 1 \
            else torch.cat([x[:, :3] + dl, x[:, 3:]], 1)
        p2 = dataclasses.replace(
            problem, poses=dataclasses.replace(problem.poses, q=q, t=t),
            lms=dataclasses.replace(problem.lms, x=x))
        ev = reprojection.evaluate_plain(p2, cfg, with_jacobians=False)
        return (ev.r * sw[:, None]).reshape(-1)

    zero = torch.zeros(P * D + L * lmsz, dtype=torch.float64)
    J = jacrev(residuals)(zero)
    pm = (problem.poses.mask[:, :D] & problem.poses.active[:, None]) \
        .reshape(-1)
    lm_ok = problem.lms.active[:, None].repeat(1, lmsz).reshape(-1)
    J = J * torch.cat([pm, lm_ok]).to(J.dtype)[None, :]
    return J.numpy(), residuals(zero).numpy(), P * D


def _fd_jac(f, x, eps):
    cols = []
    for i in range(x.numel()):
        dx = torch.zeros_like(x)
        dx[i] = eps
        cols.append((f(x + dx) - f(x - dx)) / (2 * eps))
    return torch.stack(cols, -1)


def flagship(device, dtype):
    """The flagship problem of `bench.py`, built by the port, prepared."""
    from ..core.problem import BAConfig, prepare_landmarks
    from ..io import simulate_vins as sv
    from ..solver.assemble import band_width_of
    from ..utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1)
    sim = sv.simulate(n_poses=128, n_lms=512, seed=0)
    p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                               device=device)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
    p = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)
    return prepare_landmarks(p, cfg), cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="run the checks in f32 and time a flagship GN "
                         "iteration")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..core import camera, lie
    from ..core.problem import prepare_landmarks
    from ..solver import assemble as asm_mod
    from ..utils.timing import wait
    from ..utils.tree import tree_map

    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    f32 = args.f32
    tol = 1e-2 if f32 else 1e-6
    rng = np.random.default_rng(0)
    failures = 0

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def check(name, got, want, atol):
        nonlocal failures
        got = np.asarray(torch.as_tensor(got).double().cpu())
        want = np.asarray(torch.as_tensor(want).double().cpu())
        # the tolerance scales with the operand (f32 compares different
        # accumulation orders of ~1e6-magnitude entries)
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.max(np.abs(got - want)))
        ok = err <= atol * scale
        failures += 0 if ok else 1
        print(f"  [{'PASS' if ok else 'FAIL'}] {name:44s} "
              f"err={err:.3e} (scale {scale:.1e})")

    print(f"on {dev} ({dtype}):")
    fd_eps = 1e-3 if f32 else 1e-6
    print("Lie kernel Jacobians vs central finite differences:")
    w0 = T(rng.normal(size=3))

    def f_exp(w):
        return lie.so3_exp(w.expand(2, 3))[0]

    check("d so3_exp / dw", torch.func.jacfwd(f_exp)(w0),
          _fd_jac(f_exp, w0, fd_eps), tol)
    q0 = lie.so3_exp(T(rng.normal(size=3)))

    def f_log(d):
        return lie.so3_log(lie.quat_mul(q0.expand(2, 4),
                                        lie.so3_exp(d.expand(2, 3))))[0]

    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    check("d so3_log(q*exp(d)) / dd", torch.func.jacfwd(f_log)(zero3),
          _fd_jac(f_log, zero3, fd_eps), tol)

    print("Camera model round-trips:")
    params = T(FOV)
    fov = torch.tensor(camera.MODEL_FOV, device=dev)
    p3 = rng.normal(size=(64, 3))
    p3[:, 2] = np.abs(p3[:, 2]) + 0.5
    pix = camera.project(params, fov, T(p3))
    ray = camera.unproject(params, fov, pix)
    check("fov project/unproject roundtrip",
          camera.project(params, fov, ray), pix, 1e-1 if f32 else 1e-6)

    print("Assembly vs dense-autodiff oracle (reprojection GN system):")
    scene, cfg = make_scene()
    scene = prepare_landmarks(scene, cfg)
    p = tree_map(lambda a: a.to(device=dev, dtype=dtype)
                 if a.is_floating_point() else a.to(dev), scene)
    t0 = time.perf_counter()
    asm = asm_mod.assemble(p, cfg)
    wait(asm.S)
    t_asm = time.perf_counter() - t0
    J, r, np_dim = dense_oracle(scene, cfg)
    H = J.T @ J
    tol_o = 1e-2 if f32 else 1e-10
    check("U block", asm.U, H[:np_dim, :np_dim], tol_o)
    check("W block", asm.W, H[:np_dim, np_dim:], tol_o)
    check("rhs_p", asm.rhs_p, (J.T @ r)[:np_dim], tol_o)
    print(f"  assemble wall time: {t_asm:.3f} s")

    if f32:
        from ..solver.step import gn_iteration

        print("Block-op micro-benchmarks (steady state):")
        problem, fcfg = flagship(dev, dtype)
        out = gn_iteration(problem, fcfg, True)
        wait(out.post_cost)
        t0 = time.perf_counter()
        for _ in range(5):
            out = gn_iteration(problem, fcfg, True)
        wait(out.post_cost)
        print(f"  VI GN iteration (128 kf, 512 lms) on {dev}: "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")

    print(f"{'ALL PASS' if failures == 0 else f'{failures} FAILURES'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
