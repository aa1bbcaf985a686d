"""Native host code (C++, bound with ctypes).

The port's own copies of the JAX package's `native/interpolation_buffer.cc`
(`InterpolationBuffer`: the time-indexed IMU store whose `get_range` pairs
an IMU span with a keyframe interval, boundary samples interpolated),
`native/log_parser.cc` (`parse_log`: one pass over an ODO/UTM/IMU log with
the wheel-odometry and gyro dead reckoning) and `native/problem_builder.cc`
(`NativeProblemBuilder`: the Add* problem-graph API of
`core.problem.ProblemBuilder` in C++, packed into the padded layout and
built into a `Problem` on a device).  Host code, not device kernels: the
smoother's app (`apps/unary_binary_imu_test.py`) keeps a pure-Python
parser beside the native one and says which one it used, and the Python
`ProblemBuilder` builds the same `Problem`.

The sources compile at first use with g++ into one shared library,
`_build/libba_native-<hash>.so` next to this file (the hash is of the
sources, so an edited source builds anew).  Several processes may build at
once (test workers, a second app): the build runs under an exclusive
`fcntl.flock` on `_build/.lock`, writes to a temporary name and
`os.replace`s it into place, so no process ever loads a half-written
library.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCES = ("interpolation_buffer.cc", "log_parser.cc", "problem_builder.cc")
SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"

_lib = None


def _lib_name() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((SRC_DIR / s).read_bytes())
    return f"libba_native-{h.hexdigest()[:12]}.so"


def build(build_dir=None) -> Path:
    """The path of the built library in `build_dir` (`BUILD_DIR` by
    default), compiling it first if it is not there.  Safe to call from
    several processes at once.  Raises `subprocess.CalledProcessError`
    (with g++'s output) when the compile fails and `FileNotFoundError`
    when there is no g++."""
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    out = out_dir / _lib_name()
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
                        str(tmp)] + [str(SRC_DIR / s) for s in SOURCES])
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   text=True)
                    os.replace(tmp, out)
                finally:
                    tmp.unlink(missing_ok=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load(build_dir=None) -> ctypes.CDLL:
    """The loaded library (built first if needed), its functions
    declared.  The default build directory's library is loaded once per
    process."""
    global _lib
    if build_dir is None and _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build(build_dir)))
    _declare(lib)
    if build_dir is None:
        _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def _declare(lib):
    d = ctypes.c_double
    dp = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp = ctypes.c_void_p
    i = ctypes.c_int

    lib.ib_create.restype = vp
    lib.ib_create.argtypes = [i]
    lib.ib_destroy.restype = None
    lib.ib_destroy.argtypes = [vp]
    lib.ib_size.restype = i
    lib.ib_size.argtypes = [vp]
    lib.ib_add.restype = i
    lib.ib_add.argtypes = [vp, d, dp]
    lib.ib_has.restype = i
    lib.ib_has.argtypes = [vp, d]
    lib.ib_get.restype = None
    lib.ib_get.argtypes = [vp, d, dp]
    lib.ib_range_size.restype = i
    lib.ib_range_size.argtypes = [vp, d, d]
    lib.ib_get_range.restype = None
    lib.ib_get_range.argtypes = [vp, d, d, dp, dp]

    lib.lp_parse.restype = vp
    lib.lp_parse.argtypes = [ctypes.c_char_p, i]
    lib.lp_counts.restype = None
    lib.lp_counts.argtypes = [vp, i64p]
    lib.lp_imu.restype = None
    lib.lp_imu.argtypes = [vp, dp]
    lib.lp_gps.restype = None
    lib.lp_gps.argtypes = [vp, dp]
    lib.lp_guesses.restype = None
    lib.lp_guesses.argtypes = [vp, dp, dp]
    lib.lp_destroy.restype = None
    lib.lp_destroy.argtypes = [vp]

    lib.pb_create.restype = vp
    lib.pb_create.argtypes = [i] * 6
    lib.pb_destroy.restype = None
    lib.pb_destroy.argtypes = [vp]
    lib.pb_add_camera.restype = i
    lib.pb_add_camera.argtypes = [vp, dp, i, i, dp, dp]
    lib.pb_add_pose.restype = i
    lib.pb_add_pose.argtypes = [vp, dp, dp, dp, dp, dp, i, d]
    lib.pb_add_landmark.restype = i
    lib.pb_add_landmark.argtypes = [vp, dp, i, i, i]
    lib.pb_add_projection.restype = i
    lib.pb_add_projection.argtypes = [vp, dp, i, i, i, d]
    for name, args in (
            ("pb_add_unary", [vp, i, dp, dp, dp]),
            ("pb_add_binary", [vp, i, i, dp, dp, dp]),
            ("pb_add_imu", [vp, i, i, i, dp, dp, dp]),
            ("pb_counts", [vp, i64p]),
            ("pb_build_mask", [vp, u8p]),
            ("pb_pack_poses", [vp, dp, dp, dp, dp, dp, i, dp, u8p]),
            ("pb_pack_landmarks", [vp, dp, i32p, i32p, u8p, dp, u8p]),
            ("pb_pack_cameras", [vp, dp, i32p, dp, dp, i]),
            ("pb_pack_proj", [vp, dp, i32p, i32p, i32p, dp, u8p, u8p]),
            ("pb_pack_unary", [vp, dp, dp, dp, i32p, u8p]),
            ("pb_pack_binary", [vp, dp, dp, dp, i32p, i32p, u8p]),
            ("pb_pack_imu", [vp, i, i32p, i32p, dp, dp, dp, u8p, u8p, u8p])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _arr(x, n=None):
    a = np.ascontiguousarray(np.asarray(x, np.float64)).reshape(-1)
    if n is not None and a.size < n:
        a = np.concatenate([a, np.zeros(n - a.size)])
    return a


class InterpolationBuffer:
    """Time-indexed measurement store with linear interpolation (the
    reference's InterpolationBufferT, include/ba/InterpolationBuffer.h).
    `close()` frees the native buffer; so does garbage collection."""

    def __init__(self, dim: int, build_dir=None):
        self._lib = load(build_dir)
        self._h = self._lib.ib_create(int(dim))
        self.dim = int(dim)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ib_destroy(self._h)
            self._h = None

    __del__ = close

    def __len__(self):
        return self._lib.ib_size(self._h)

    def add(self, time: float, value) -> None:
        v = _arr(value, self.dim)
        self._lib.ib_add(self._h, float(time), _dptr(v))

    def has(self, time: float) -> bool:
        return bool(self._lib.ib_has(self._h, float(time)))

    def get(self, time: float) -> np.ndarray:
        out = np.zeros(self.dim)
        self._lib.ib_get(self._h, float(time), _dptr(out))
        return out

    def get_range(self, t_start: float, t_end: float):
        """(times (n,), values (n, dim)) with interpolated boundary
        samples: pairs an IMU span with a keyframe interval (the
        reference's GetRange, InterpolationBuffer.h:184)."""
        n = self._lib.ib_range_size(self._h, float(t_start), float(t_end))
        times = np.zeros(n)
        values = np.zeros((n, self.dim))
        self._lib.ib_get_range(self._h, float(t_start), float(t_end),
                               _dptr(times), _dptr(values))
        return times, values


def parse_log(path, max_poses: int = 0, build_dir=None):
    """Native parse and dead reckoning of a GPS / IMU / odometry log (the
    reference's parse_file, update_incremental_pose and
    add_gyro_and_speed, applications/unary_binary_imu_test/main.cpp:40-280;
    the whitespace ODO/UTM/IMU format and the CSV alternate).

    Returns (imu_rows (N, 7) float64, gps list of (t, x, y, z) tuples,
    guesses list of (q (4,), t (3,)) arrays), the contract of the app's
    pure-Python `parse_log_py`.  Raises FileNotFoundError on an unreadable
    path."""
    lib = load(build_dir)
    h = lib.lp_parse(str(path).encode(), int(max_poses))
    if not h:
        raise FileNotFoundError(path)
    try:
        counts = np.zeros(2, np.int64)
        lib.lp_counts(h, counts.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)))
        n_imu, n_gps = map(int, counts)
        imu = np.zeros((n_imu, 7))
        gps = np.zeros((n_gps, 4))
        gq = np.zeros((n_gps, 4))
        gt = np.zeros((n_gps, 3))
        lib.lp_imu(h, _dptr(imu))
        lib.lp_gps(h, _dptr(gps))
        lib.lp_guesses(h, _dptr(gq), _dptr(gt))
    finally:
        lib.lp_destroy(h)
    return (imu, [tuple(r) for r in gps],
            [(gq[i], gt[i]) for i in range(n_gps)])


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeProblemBuilder:
    """C++-backed drop-in for `core.problem.ProblemBuilder` (the JAX
    package's `native.NativeProblemBuilder`): the same Add* calls, packed
    in C++ and built into the port's `Problem` on a device (CUDA by
    default).  `close()` frees the native builder; so does garbage
    collection."""

    def __init__(self, config, build_dir=None):
        self.config = config
        self._lib = load(build_dir)
        self._h = self._lib.pb_create(
            config.pose_dim, config.lm_size, config.calib_size,
            int(config.do_tvs), int(config.regularize_biases_in_batch),
            int(config.enable_auto_regularization))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.pb_destroy(self._h)
            self._h = None

    __del__ = close

    def add_camera(self, params, model=0, tvs_q=(1.0, 0, 0, 0),
                   tvs_t=(0.0, 0, 0)) -> int:
        from ..core import camera as cam_mod

        p = _arr(params, cam_mod.MAX_PARAMS)
        return self._lib.pb_add_camera(self._h, _dptr(p), len(p),
                                       int(model), _dptr(_arr(tvs_q)),
                                       _dptr(_arr(tvs_t)))

    def add_pose(self, q, t, v=(0.0, 0, 0), b=(0.0,) * 6, active=True,
                 time=0.0, cam_params=None) -> int:
        cp = _arr(cam_params if cam_params is not None else (), 8)
        return self._lib.pb_add_pose(self._h, _dptr(_arr(q)), _dptr(_arr(t)),
                                     _dptr(_arr(v)), _dptr(_arr(b)),
                                     _dptr(cp), int(active), float(time))

    def add_landmark(self, x_w, ref_pose, ref_cam=0, active=True) -> int:
        x = _arr(x_w)
        if x.size == 3:
            x = np.concatenate([x, [1.0]])
        return self._lib.pb_add_landmark(self._h, _dptr(x), int(ref_pose),
                                         int(ref_cam), int(active))

    def add_projection_residual(self, z, meas_pose, lm, cam=0, weight=1.0):
        self._lib.pb_add_projection(self._h, _dptr(_arr(z)), int(meas_pose),
                                    int(lm), int(cam), float(weight))

    def add_unary_constraint(self, pose, q, t, cov=None):
        ci = np.eye(6) if cov is None else np.linalg.inv(
            np.asarray(cov, np.float64))
        self._lib.pb_add_unary(self._h, int(pose), _dptr(_arr(q)),
                               _dptr(_arr(t)), _dptr(_arr(ci)))

    def add_binary_constraint(self, pose1, pose2, q, t, cov=None):
        ci = np.eye(6) if cov is None else np.linalg.inv(
            np.asarray(cov, np.float64))
        self._lib.pb_add_binary(self._h, int(pose1), int(pose2),
                                _dptr(_arr(q)), _dptr(_arr(t)),
                                _dptr(_arr(ci)))

    def add_imu_residual(self, pose1, pose2, w, a, time):
        w = np.ascontiguousarray(np.asarray(w, np.float64))
        a = np.ascontiguousarray(np.asarray(a, np.float64))
        t = np.ascontiguousarray(np.asarray(time, np.float64))
        self._lib.pb_add_imu(self._h, int(pose1), int(pose2), len(t),
                             _dptr(w), _dptr(a), _dptr(t))

    def build(self, pad_multiple: int = 1, with_marg_prior: bool = True,
              device="cuda"):
        """Pad to static shapes and emit the Problem on `device` (CUDA by
        default; raises when CUDA is absent and `device` is not "cpu")."""
        import dataclasses

        import torch

        from .. import resolve_device
        from ..core import camera as cam_mod
        from ..core.problem import (BinaryResiduals, ImuResiduals,
                                    LandmarkStates, PoseStates, Problem,
                                    ProjResiduals, Rig, UnaryResiduals,
                                    build_structure_index, empty_marg_prior)

        dev = resolve_device(device)
        lib, h = self._lib, self._h

        def rnd(n):
            return max(pad_multiple,
                       -(-max(n, 1) // pad_multiple) * pad_multiple)

        c = np.zeros(8, np.int64)
        lib.pb_counts(h, _ptr(c, ctypes.c_int64))
        n_p, n_l, n_c, n_r, n_u, n_b, n_i, M = map(int, c)
        P, L, C = rnd(n_p), rnd(n_l), max(n_c, 1)
        Nr, Nu, Nb, Ni = rnd(n_r), rnd(n_u), rnd(n_b), rnd(n_i)

        def z(shape, dt=np.float64):
            return np.zeros(shape, dt)

        def u8(a):
            return _ptr(a, ctypes.c_uint8)

        def i32(a):
            return _ptr(a, ctypes.c_int32)

        def T(a):
            return torch.as_tensor(a, device=dev)

        q, t, v, b = z((P, 4)), z((P, 3)), z((P, 3)), z((P, 6))
        q[:, 0] = 1.0
        pcp = z((P, cam_mod.MAX_PARAMS))
        time_, act = z(P), z(P, np.uint8)
        mask = z((P, 15), np.uint8)
        lib.pb_pack_poses(h, _dptr(q), _dptr(t), _dptr(v), _dptr(b),
                          _dptr(pcp), cam_mod.MAX_PARAMS, _dptr(time_),
                          u8(act))
        lib.pb_build_mask(h, u8(mask))
        poses = PoseStates(q=T(q), t=T(t), v=T(v), b=T(b), time=T(time_),
                           active=T(act.astype(bool)),
                           mask=T(mask.astype(bool)), cam_params=T(pcp))

        x_w, zr = z((L, 4)), z((L, 2))
        rp, rc = z(L, np.int32), z(L, np.int32)
        lact, hzr = z(L, np.uint8), z(L, np.uint8)
        lib.pb_pack_landmarks(h, _dptr(x_w), i32(rp), i32(rc), u8(lact),
                              _dptr(zr), u8(hzr))
        rel = np.zeros(L, bool)
        rel[:n_l] = True
        lms = LandmarkStates(x=T(z((L, 4))), x_w=T(x_w), ref_pose=T(rp),
                             ref_cam=T(rc), active=T(lact.astype(bool)),
                             reliable=T(rel), z_ref=T(zr),
                             has_z_ref=T(hzr.astype(bool)))

        cp = z((C, cam_mod.MAX_PARAMS))
        cm = z(C, np.int32)
        tq, tt = z((C, 4)), z((C, 3))
        tq[:, 0] = 1.0
        if n_c:
            lib.pb_pack_cameras(h, _dptr(cp), i32(cm), _dptr(tq), _dptr(tt),
                                cam_mod.MAX_PARAMS)
        rig = Rig(params=T(cp), model=T(cm), tvs_q=T(tq), tvs_t=T(tt))

        pz = z((Nr, 2))
        pp, pl, pc = z(Nr, np.int32), z(Nr, np.int32), z(Nr, np.int32)
        pw = z(Nr)
        pv, pcond = z(Nr, np.uint8), z(Nr, np.uint8)
        lib.pb_pack_proj(h, _dptr(pz), i32(pp), i32(pl), i32(pc), _dptr(pw),
                         u8(pv), u8(pcond))

        uq, ut, uc = z((Nu, 4)), z((Nu, 3)), z((Nu, 6, 6))
        up, uv = z(Nu, np.int32), z(Nu, np.uint8)
        uq[:, 0] = 1.0
        lib.pb_pack_unary(h, _dptr(uq), _dptr(ut), _dptr(uc), i32(up),
                          u8(uv))
        unary = UnaryResiduals(pose=T(up), q=T(uq), t=T(ut), cov_inv=T(uc),
                               valid=T(uv.astype(bool)))

        bq, bt, bc = z((Nb, 4)), z((Nb, 3)), z((Nb, 6, 6))
        b1, b2, bv = z(Nb, np.int32), z(Nb, np.int32), z(Nb, np.uint8)
        bq[:, 0] = 1.0
        lib.pb_pack_binary(h, _dptr(bq), _dptr(bt), _dptr(bc), i32(b1),
                           i32(b2), u8(bv))

        i1, i2 = z(Ni, np.int32), z(Ni, np.int32)
        iw, ia = z((Ni, M, 3)), z((Ni, M, 3))
        it = z((Ni, M))
        imv, iv, ic = z((Ni, M), np.uint8), z(Ni, np.uint8), z(Ni, np.uint8)
        lib.pb_pack_imu(h, M, i32(i1), i32(i2), _dptr(iw), _dptr(ia),
                        _dptr(it), u8(imv), u8(iv), u8(ic))

        # the host's sparsity tables, shared with the Python builder
        per_row, pidx = build_structure_index(
            pp, rp[pl], pl, pv.astype(bool), b1, b2, bv.astype(bool), i1, i2,
            iv.astype(bool), P, L, pad_multiple, device=dev)
        proj = ProjResiduals(z=T(pz), pose=T(pp), lm=T(pl), cam=T(pc),
                             weight=T(pw), valid=T(pv.astype(bool)),
                             cond=T(pcond.astype(bool)),
                             pair=T(per_row["pair"]),
                             pair_swap=T(per_row["pair_swap"]),
                             wb_meas=T(per_row["wb_meas"]),
                             wb_ref=T(per_row["wb_ref"]))
        binary = BinaryResiduals(pose1=T(b1), pose2=T(b2), q=T(bq), t=T(bt),
                                 cov_inv=T(bc), valid=T(bv.astype(bool)),
                                 pair=T(per_row["bpair"]),
                                 pair_swap=T(per_row["bswap"]))
        imu = ImuResiduals(pose1=T(i1), pose2=T(i2), w=T(iw), a=T(ia),
                           time=T(it), meas_valid=T(imv.astype(bool)),
                           weight=T(np.ones(Ni)), valid=T(iv.astype(bool)),
                           cond=T(ic.astype(bool)), pair=T(per_row["ipair"]),
                           pair_swap=T(per_row["iswap"]),
                           c9=T(z((Ni, 9, 9))), c9_set=T(np.zeros((), bool)))

        g = np.array([0.0, 0.0, -self.config.gravity])
        marg = empty_marg_prior(P, self.config.pose_dim, poses.t.dtype, dev,
                                enabled=with_marg_prior)
        marg = dataclasses.replace(marg, lin_q=poses.q, lin_t=poses.t,
                                   lin_v=poses.v, lin_b=poses.b)
        return Problem(poses=poses, lms=lms, rig=rig, proj=proj, unary=unary,
                       binary=binary, imu=imu, g_vec=T(g), marg=marg,
                       pidx=pidx)
