"""Kernel 1: reprojection residual + closed-form Jacobians (CUDA).

Replaces the TPU kernel `evaluate_pallas` -> `_kernel` ->
`proj_math.proj_forward` (`80bbf6f^:ba_tpu/ops/reprojection_pallas.py`,
`pallas_call` at :83; math at `80bbf6f^:ba_tpu/ops/proj_math.py:95`), whose
live counterpart in `ba_tpu` is the vmap(jacfwd) of
`core/residuals/reprojection.py:101-170`.

Design (csrc/reprojection.cu): a block takes 32 rows, one per lane, and
gathers their pose, landmark and camera entries from the index arrays
(those tables are a few KB and stay in L2, so the Pallas version's
43-feature transposed copy is not built).  With Jacobians, four warps
split each row's work by role (residual and inverse depth, translations,
meas rotation, ref rotation), each recomputing the shared transfer chain
and the FOV/linear projection with the exact `atan`; that shortens the
longest thread's chain and fills the card (303 blocks at the flagship).
With calibration columns (self-calibration, K = calib_size + 6 do_tvs),
four more warps take them by forward-mode duals through the whole
residual, the intrinsics' unprojection of the reference pixel included.
The block's outputs are staged in shared memory and written as contiguous
16-byte stores.  A compile-time flag drops the Jacobians (and all but one
warp) for trial costs.  Float and double.

Bound on an H100: it reads ~20 B of indices and z per row (the gathered
tables stay in L2) and writes 116 B (f32) per row, ~1.3 MB at Nr = 9,696 —
0.40 us at 3.35 TB/s; ~1,055 flops per row (with Jacobians) take 0.16 us
at 67 TFLOP/s f32.  Launch latency and the dependent chain of a row
dominate; the design keeps one launch per evaluation.

Scope: lm_size 1 (inverse depth), 3 (world points) and 0 (a pose graph:
a row is a world point's with no landmark columns, as in ba_tpu), the rig's
intrinsics of the linear and FOV models, optionally with the calibration
columns of camera 0 (calib_size 0 or 5, do_tvs).  Another model raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 16 + [_I] * 7 + [_P] * 6 + [_P]


def _fn(dtype):
    lib = build.load("reprojection")
    name = {torch.float32: "ba_reprojection_f32",
            torch.float64: "ba_reprojection_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_models(model):
    """Linear (0) and FOV (1) only.  The check reads the (static) model
    table from the device once and marks the tensor as checked."""
    if getattr(model, "_ba_models_checked", False):
        return
    bad = ((model != 0) & (model != 1)).any().item()
    if bad:
        raise NotImplementedError(
            "reprojection kernel covers the linear and FOV camera models "
            "(ROADMAP.md queue 1, the kernel variants)")
    model._ba_models_checked = True


def reprojection(problem, with_jacobians: bool, lm_size: int = 1,
                 calib_size: int = 0, do_tvs: bool = False):
    """(r, j_meas, j_ref, j_lm, j_cal, err_sq) of every projection row,
    from the CUDA kernel: j_lm (Nr, 2, lm_size), j_cal (Nr, 2, K) with
    K = calib_size + 6 do_tvs the calibration columns of camera 0.  The
    j_* are None without Jacobians."""
    pr, poses, lms, rig = problem.proj, problem.poses, problem.lms, \
        problem.rig
    dtype = pr.z.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"reprojection kernel: unsupported dtype {dtype}")
    if lm_size not in (0, 1, 3) or calib_size not in (0, 5):
        raise ValueError("reprojection kernel: lm_size 0, 1 or 3, "
                         "calib_size 0 or 5")
    floats = (pr.z, poses.q, poses.t, lms.x, lms.z_ref, rig.params,
              rig.tvs_q, rig.tvs_t)
    ints = (pr.pose, pr.lm, pr.cam, lms.ref_pose, lms.ref_cam, rig.model)
    for t in floats + ints + (pr.valid, lms.has_z_ref):
        if not t.is_cuda or t.device != pr.z.device:
            raise ValueError("reprojection kernel: every tensor must be "
                             "on the problem's CUDA device")
        if not t.is_contiguous():
            raise ValueError("reprojection kernel: tensors must be "
                             "contiguous")
    if any(t.dtype != dtype for t in floats):
        raise TypeError("reprojection kernel: mixed float dtypes")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("reprojection kernel: index tables must be int32")
    if pr.valid.dtype != torch.bool or lms.has_z_ref.dtype != torch.bool:
        raise TypeError("reprojection kernel: valid and has_z_ref must be "
                        "bool")
    if rig.params.shape[1] < 5:
        raise ValueError("reprojection kernel: params need >= 5 entries")
    _check_models(rig.model)

    Nr = pr.z.shape[0]
    K = calib_size + (6 if do_tvs else 0)
    kw = dict(dtype=dtype, device=pr.z.device)
    r = torch.empty((Nr, 2), **kw)
    err_sq = torch.empty((Nr,), **kw)
    if with_jacobians:
        j_meas = torch.empty((Nr, 2, 6), **kw)
        j_ref = torch.empty_like(j_meas)
        j_lm = torch.empty((Nr, 2, lm_size), **kw)
        j_cal = torch.empty((Nr, 2, K), **kw)
        outs = (j_meas, j_ref, j_lm, j_cal)
        jp = tuple(t.data_ptr() for t in outs)
    else:
        j_meas = j_ref = j_lm = j_cal = None
        outs = ()
        jp = (None,) * 4
    for t in (r, err_sq) + outs:
        if t.data_ptr() % 16:
            raise ValueError("reprojection kernel: outputs must be 16-byte "
                             "aligned")
    stream = torch.cuda.current_stream(pr.z.device).cuda_stream
    rc = _fn(dtype)(
        pr.z.data_ptr(), pr.pose.data_ptr(), pr.lm.data_ptr(),
        pr.cam.data_ptr(), pr.valid.data_ptr(),
        poses.q.data_ptr(), poses.t.data_ptr(), lms.x.data_ptr(),
        lms.ref_pose.data_ptr(), lms.ref_cam.data_ptr(),
        lms.z_ref.data_ptr(), lms.has_z_ref.data_ptr(),
        rig.params.data_ptr(), rig.model.data_ptr(), rig.tvs_q.data_ptr(),
        rig.tvs_t.data_ptr(),
        rig.params.shape[1], rig.params.shape[0], Nr, int(with_jacobians),
        lm_size, calib_size, K, r.data_ptr(), *jp, err_sq.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"reprojection kernel launch failed: CUDA error "
                           f"{rc}")
    reprojection.launches += 1
    return r, j_meas, j_ref, j_lm, j_cal, err_sq


reprojection.launches = 0
