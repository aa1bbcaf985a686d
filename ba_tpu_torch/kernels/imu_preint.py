"""Kernel K2: IMU preintegration of every span, whitened, one launch per
evaluation (CUDA).

Replaces the TPU formulation of `ba_tpu/core/residuals/imu.py`:
`integrate_span` (:101), `integrate_full` (:122), the per-span function
`one` of `evaluate` (:278-297), `_c9` (:329) and the whitening
`_whiten_from_c9` (:348) and `_whiten_pack` (:391).  The plain PyTorch
version is `core/residuals/imu.py:evaluate_plain` (`full_plain` or
`residual_plain`, then `_whiten_from_c9` and `_whiten_pack`: a Python loop
of batched RK4 steps, `vmap(jacfwd)` of one step and of the residual map, a
tree reduce of the affine products, the blocked 3 x 3 factor and its
inverse, some hundred launches on the card).

Design (csrc/imu_preint.cu): (a) `imu_full` gives one block to one span.
One thread runs the primal RK4 scan into shared memory; then every step's
[A | B] comes at once, one thread per (step, tangent) carrying the tangent
through the step as a dual number, beside the residual map's 19 tangents;
the triples (A, B, B R B^T / dt) are reduced pairwise in ba_tpu's order.
It walks a span in chunks of 16 steps whose products merge on a stack in
the same order, so its shared memory grows only with log2 of the span's
length; the epilogue forms J1s, J1b, C9, the whitening factor (the blocked
Cholesky and its inverse, the bias block, the robust weight) and writes
the whitened r, j1, j2, err_sq, y_t, y_v and C9.  (b) `imu_residual`
integrates the state only, one thread per span, and whitens the residual
with a given C9 (the trial cost).  Both gather the pose tables by the
spans' ids themselves and read nothing back to the host.

Bound on an H100 (flagship, 127 spans x 11 slots, f32): ~0.5 MB of traffic
(0.15 us) and ~15 Mflop by the chain rule (0.23 us at 67 TFLOP/s); the
span's primal scan is the chain that sets the pace.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_FULL_ARGTYPES = [_P, _D, _D, _P, _P, _I, _P, _P, _P, _D, _D, _I, _I, _I,
                  _I, _P, _P]
_RES_ARGTYPES = [_P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _P, _P]


def _fn(kind: str, dtype):
    lib = build.load("imu_preint")
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(lib, f"ba_imu_{kind}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = _FULL_ARGTYPES if kind == "full" else _RES_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _check(t, dtype, shape, dev, what):
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"imu_preint kernel: {what} must be on the "
                         "problem's CUDA device")
    if t.dtype != dtype:
        raise TypeError(f"imu_preint kernel: {what} is {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"imu_preint kernel: {what} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"imu_preint kernel: {what} must be contiguous")


def _inputs(problem):
    """The kernel's checked inputs: the pose tables, the spans' ids and
    measurements, gravity, and the whitening's weights and masks."""
    poses, im = problem.poses, problem.imu
    dtype = poses.t.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"imu_preint kernel: unsupported dtype {dtype}")
    dev = poses.t.device
    P = poses.t.shape[0]
    Ni, M = im.time.shape
    for t, dt, shape, what in (
            (poses.q, dtype, (P, 4), "pose q"),
            (poses.t, dtype, (P, 3), "pose t"),
            (poses.v, dtype, (P, 3), "pose v"),
            (poses.b, dtype, (P, 6), "pose b"),
            (im.pose1, torch.int32, (Ni,), "pose1"),
            (im.pose2, torch.int32, (Ni,), "pose2"),
            (im.w, dtype, (Ni, M, 3), "w"),
            (im.a, dtype, (Ni, M, 3), "a"),
            (im.time, dtype, (Ni, M), "time"),
            (problem.g_vec, dtype, (3,), "g"),
            (im.weight, dtype, (Ni,), "weight"),
            (im.valid, torch.bool, (Ni,), "valid"),
            (im.cond, torch.bool, (Ni,), "cond")):
        _check(t, dt, shape, dev, what)
    ins = _ptrs((poses.q, poses.t, poses.v, poses.b, im.pose1, im.pose2,
                 im.w, im.a, im.time, problem.g_vec))
    return ins, Ni, M, dtype, dev


def _outputs(Ni, R, D, dtype, dev):
    kw = dict(dtype=dtype, device=dev)
    return (torch.empty((Ni, R), **kw), torch.empty((Ni, R, D), **kw),
            torch.empty((Ni, R, D), **kw), torch.empty((Ni,), **kw),
            torch.empty((Ni, 9, 9), **kw), torch.empty((Ni, 3), **kw),
            torch.empty((Ni, 3), **kw))


def _whiten_args(problem, config):
    im = problem.imu
    return (im.weight.data_ptr(), im.valid.data_ptr(), im.cond.data_ptr(),
            float(config.gyro_bias_sigma**2),
            float(config.accel_bias_sigma**2),
            int(bool(config.imu_rotation_only)))


def imu_full(problem, config, cov_once=None):
    """(a): the fields of `ImuEval` with Jacobians, (r (Ni, R), j1, j2
    (Ni, R, D), err_sq (Ni,), y_t, y_v (Ni, 3), c9 (Ni, 9, 9)), whitened
    as `evaluate_plain` whitens them; R = 15 with the bias rows (pose_dim
    15) else 9; y_t, y_v are pose 1's t and v; c9 is the covariance used,
    the problem's cached one where `calculate_inertial_covariance_once`
    (or `cov_once`, when given) has set it."""
    ins, Ni, M, dtype, dev = _inputs(problem)
    im = problem.imu
    D = config.pose_dim
    R = 15 if D >= 15 else 9
    if cov_once is None:
        cov_once = config.calculate_inertial_covariance_once
    _check(im.c9, dtype, (Ni, 9, 9), dev, "c9 cache")
    _check(im.c9_set, torch.bool, (), dev, "c9_set")
    outs = _outputs(Ni, R, D, dtype, dev)
    r, j1, j2, err, c9, yt, yv = outs
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn("full", dtype)(
        ins, float(config.gyro_sigma**2), float(config.accel_sigma**2),
        im.c9.data_ptr(), im.c9_set.data_ptr(), int(bool(cov_once)),
        *_whiten_args(problem, config), Ni, M, D,
        _ptrs((r, j1, j2, err, c9, yt, yv)), stream)
    if rc != 0:
        raise RuntimeError(f"imu_preint kernel (a) launch failed: CUDA "
                           f"error {rc} (spans of {M} slots)")
    imu_full.launches += 1
    return r, j1, j2, err, yt, yv, c9


imu_full.launches = 0


def imu_residual(problem, config, c9):
    """(b): the fields of `ImuEval` without Jacobians, (r (Ni, R), zero j1,
    j2, err_sq, y_t, y_v (the integrated t and v), c9), r whitened with the
    given covariance c9 (Ni, 9, 9)."""
    ins, Ni, M, dtype, dev = _inputs(problem)
    D = config.pose_dim
    R = 15 if D >= 15 else 9
    _check(c9, dtype, (Ni, 9, 9), dev, "c9")
    r, j1, j2, err, _, yt, yv = _outputs(Ni, R, D, dtype, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn("residual", dtype)(
        ins, c9.data_ptr(), *_whiten_args(problem, config), Ni, M, D,
        _ptrs((r, j1, j2, err, c9, yt, yv)), stream)
    if rc != 0:
        raise RuntimeError(f"imu_preint kernel (b) launch failed: CUDA "
                           f"error {rc}")
    imu_residual.launches += 1
    return r, j1, j2, err, yt, yv, c9


imu_residual.launches = 0
