"""Kernel K2: IMU preintegration of every span, with and without Jacobians
(CUDA).

Replaces the TPU formulation of `ba_tpu/core/residuals/imu.py`:
`integrate_span` (:101), `integrate_full` (:122), the per-span function
`one` of `evaluate` (:278-297) and `_c9` (:329), whose plain PyTorch
versions are `core/residuals/imu.py:full_plain` and `residual_plain` (a
Python loop of batched RK4 steps, `vmap(jacfwd)` of one step and of the
residual map, and a tree reduce of the affine products).

Design (csrc/imu_preint.cu): (a) `imu_full` gives one warp to one span.
Lane j < 16 carries the tangent e_j of [state, biases] through each RK4
step as a dual number, so the warp gets the step's [A | B] in one pass;
Phi, Bsum and the Euler covariance then advance by 10 x 10 products in
shared memory.  The residual map's 19 tangents follow the same way, and the
warp writes r, the pose Jacobians j1, j2 in the evaluation's layout (the
15-dim bias blocks included), C9 = Jy C10 Jy^T and pose 1's t and v.  (b)
`imu_residual` integrates the state only, one thread per span, for trial
costs.  Both gather the pose tables by the spans' ids themselves and read
nothing back to the host.

Bound on an H100 (flagship, 127 spans x 11 slots, f32): ~0.5 MB of traffic
(0.15 us) and ~15 Mflop by the chain rule (0.22 us at 67 TFLOP/s); the
dependent chain of a span's steps sets the pace.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_FULL_ARGTYPES = [_P] * 10 + [_D, _D] + [_I] * 3 + [_P] * 6 + [_P]
_RES_ARGTYPES = [_P] * 10 + [_I] * 3 + [_P] * 3 + [_P]


def _fn(kind: str, dtype):
    lib = build.load("imu_preint")
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(lib, f"ba_imu_{kind}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = _FULL_ARGTYPES if kind == "full" else _RES_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _inputs(problem):
    """The kernel's input tensors, checked: the pose tables, the spans'
    ids and measurements, gravity."""
    poses, im = problem.poses, problem.imu
    floats = (poses.q, poses.t, poses.v, poses.b, im.w, im.a, im.time,
              problem.g_vec)
    ints = (im.pose1, im.pose2)
    dtype = poses.t.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"imu_preint kernel: unsupported dtype {dtype}")
    dev = poses.t.device
    for t in floats + ints:
        if not t.is_cuda or t.device != dev:
            raise ValueError("imu_preint kernel: every tensor must be on the "
                             "problem's CUDA device")
        if not t.is_contiguous():
            raise ValueError("imu_preint kernel: tensors must be contiguous")
    if any(t.dtype != dtype for t in floats):
        raise TypeError("imu_preint kernel: mixed float dtypes")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("imu_preint kernel: pose ids must be int32")
    P = poses.t.shape[0]
    Ni, M = im.time.shape
    shapes = ((poses.q, (P, 4)), (poses.v, (P, 3)), (poses.b, (P, 6)),
              (im.w, (Ni, M, 3)), (im.a, (Ni, M, 3)), (im.pose1, (Ni,)),
              (im.pose2, (Ni,)), (problem.g_vec, (3,)))
    for t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"imu_preint kernel: shape {tuple(t.shape)}, "
                             f"expected {want}")
    return floats, ints, Ni, M


def imu_full(problem, pose_dim: int, gyro_var: float, accel_var: float):
    """(a): (r (Ni, R), j1 (Ni, R, D), j2 (Ni, R, D), c9 (Ni, 9, 9),
    y_t, y_v (Ni, 3)) of every span, R = 15 with the bias rows
    (pose_dim 15) else 9, unwhitened; y_t, y_v are pose 1's t and v."""
    floats, ints, Ni, M = _inputs(problem)
    D = pose_dim
    R = 15 if D >= 15 else 9
    kw = dict(dtype=floats[0].dtype, device=floats[0].device)
    r = torch.empty((Ni, R), **kw)
    j1 = torch.empty((Ni, R, D), **kw)
    j2 = torch.empty((Ni, R, D), **kw)
    c9 = torch.empty((Ni, 9, 9), **kw)
    yt = torch.empty((Ni, 3), **kw)
    yv = torch.empty((Ni, 3), **kw)
    q, t, v, b, w, a, time, g = (x.data_ptr() for x in floats)
    stream = torch.cuda.current_stream(floats[0].device).cuda_stream
    rc = _fn("full", floats[0].dtype)(
        q, t, v, b, ints[0].data_ptr(), ints[1].data_ptr(), w, a, time, g,
        float(gyro_var), float(accel_var), Ni, M, D, r.data_ptr(),
        j1.data_ptr(), j2.data_ptr(), c9.data_ptr(), yt.data_ptr(),
        yv.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"imu_preint kernel (a) launch failed: CUDA "
                           f"error {rc}")
    imu_full.launches += 1
    return r, j1, j2, c9, yt, yv


imu_full.launches = 0


def imu_residual(problem, pose_dim: int):
    """(b): (r (Ni, R), y_t, y_v (Ni, 3)), the integrated t and v."""
    floats, ints, Ni, M = _inputs(problem)
    R = 15 if pose_dim >= 15 else 9
    kw = dict(dtype=floats[0].dtype, device=floats[0].device)
    r = torch.empty((Ni, R), **kw)
    yt = torch.empty((Ni, 3), **kw)
    yv = torch.empty((Ni, 3), **kw)
    q, t, v, b, w, a, time, g = (x.data_ptr() for x in floats)
    stream = torch.cuda.current_stream(floats[0].device).cuda_stream
    rc = _fn("residual", floats[0].dtype)(
        q, t, v, b, ints[0].data_ptr(), ints[1].data_ptr(), w, a, time, g,
        Ni, M, pose_dim, r.data_ptr(), yt.data_ptr(), yv.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"imu_preint kernel (b) launch failed: CUDA "
                           f"error {rc}")
    imu_residual.launches += 1
    return r, yt, yv


imu_residual.launches = 0
