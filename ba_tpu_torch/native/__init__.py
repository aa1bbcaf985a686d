"""Native host code of the GPS + IMU smoother (C++, bound with ctypes).

The port's own copies of the JAX package's `native/interpolation_buffer.cc`
(`InterpolationBuffer`: the time-indexed IMU store whose `get_range` pairs
an IMU span with a keyframe interval, boundary samples interpolated) and
`native/log_parser.cc` (`parse_log`: one pass over an ODO/UTM/IMU log with
the wheel-odometry and gyro dead reckoning).  Host code, not device
kernels: the smoother's app (`apps/unary_binary_imu_test.py`) keeps a
pure-Python parser beside the native one and says which one it used.

Both sources compile at first use with g++ into one shared library,
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

SOURCES = ("interpolation_buffer.cc", "log_parser.cc")
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
    i64p = ctypes.POINTER(ctypes.c_int64)
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
