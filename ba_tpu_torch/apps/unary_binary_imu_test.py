"""GPS + IMU + wheel-odometry pose-graph smoother on the port.

Port of `apps/unary_binary_imu_test.py`, the analog of the reference's
`applications/unary_binary_imu_test` (arpg/ba, main.cpp): parse a text log
of wheel-odometry, GPS (UTM) and IMU records, build one pose per GPS fix
with a dead-reckoned initial guess (gyro orientation and wheel-speed
translation, main.cpp:67-84), attach loose GPS unary priors (covariance
diag [1000, 1000, 30000, inf, inf, inf], main.cpp:176-183) and an IMU
preintegration residual between consecutive poses (main.cpp:196-205), and
solve.  A pose graph: `lm_size` 0, `pose_dim` 9, no projection rows.

  * batch: `solve(max_iter=25, gn_damping=0.2, use_imu=True)`, the
    reference's invocation (main.cpp:283-288), in f32 on the banded grid;
  * `--stream W`: the online fixed-lag smoother through `StreamingRing`,
    one pose, its GPS prior and its IMU span in per fix, one retired pose
    out per fix once the window is warm, 6 GN iterations per slide, in f64
    (the priors' unconstrained rows put a ~1e15 condition number into the
    marginalization, which f32 cannot carry across slides).

Both run on `--device` (cuda unless told otherwise; without CUDA that
default raises).  The log is parsed by the native parser (`native/`) when
it builds here, else by the pure-Python `parse_log_py`; the app says which.

    python -m ba_tpu_torch.apps.unary_binary_imu_test log.txt --generate 60
    python -m ba_tpu_torch.apps.unary_binary_imu_test log.txt
    python -m ba_tpu_torch.apps.unary_binary_imu_test log.txt --stream 10

Input (the reference's whitespace format, main.cpp:246-280):
    ODO <time> <rr> <rl>                      wheel speeds (right, left)
    UTM <time> <utm_e> <utm_n> <altitude>     GPS fix
    IMU <time> <wx> <wy> <wz> <ax> <ay> <az>  gyro + accel sample
or the CSV alternate (auto-detected):
    imu,<time>,<wx>,<wy>,<wz>,<ax>,<ay>,<az>
    gps,<time>,<x>,<y>,<z>
"""

from __future__ import annotations

import argparse
import math
import sys
import time as _time
from pathlib import Path

import numpy as np
import torch

TRACKWIDTH = 1.5          # reference main.cpp:101
MAX_POSES = 10000         # reference main.cpp:259-263
DBL_MAX = 1e18            # "unconstrained" covariance entries
# the reference's GPS prior (main.cpp:176-183): loose translation, free
# rotation
GPS_COV = np.diag([1000.0, 1000.0, 30000.0, DBL_MAX, DBL_MAX, DBL_MAX])
GRAVITY = (0.0, 0.0, 9.8)  # reference main.cpp:229-231


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _quat_rotate(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x),
         1 - 2 * (x * x + y * y)]])
    return R @ v


def _aa(axis, angle):
    axis = np.asarray(axis, float)
    return np.concatenate([[math.cos(angle / 2)],
                           math.sin(angle / 2) * axis])


def _euler_zyx_quat(wz, wy, wx):
    """aaZ * aaY * aaX, as the reference composes gyro increments
    (main.cpp:76-80)."""
    return _quat_mul(_aa([0, 0, 1], wz), _quat_mul(_aa([0, 1, 0], wy),
                                                   _aa([1, 0, 0], wx)))


class DeadReckoner:
    """The reference app's incremental-pose state machine (main.cpp:40-139):
    wheel odometry drives `speed` and a differential-drive 2-D pose; IMU
    records integrate a gyro pose whose translation steps (0, speed*dt, 0).
    """

    def __init__(self):
        self.speed = 0.0
        self.inc_x = self.inc_y = self.inc_yaw = 0.0
        self.inc_timestamp = None
        self.gyro_q = np.array([1.0, 0, 0, 0])
        self.gyro_t = np.zeros(3)
        self.last_imu_t = None

    def odo(self, t, rr, rl):
        """update_incremental_pose (main.cpp:87-139)."""
        if self.inc_timestamp is None:
            self.inc_timestamp = t
            return
        self.speed = 0.5 * (rr + rl)
        dt = t - self.inc_timestamp
        TINY = 0.0001
        if abs(rr) > TINY or abs(rl) > TINY:
            if abs(rr - rl) < TINY:
                self.inc_x += math.cos(self.inc_yaw) * rr * dt
                self.inc_y += math.sin(self.inc_yaw) * rr * dt
            else:
                w = (rr - rl) / TRACKWIDTH
                R = TRACKWIDTH * 0.5 * (rr + rl) / (rr - rl)
                icc_x = self.inc_x - R * math.sin(self.inc_yaw)
                icc_y = self.inc_y + R * math.cos(self.inc_yaw)
                wdt = w * dt
                nx = (math.cos(wdt) * (self.inc_x - icc_x)
                      - math.sin(wdt) * (self.inc_y - icc_y) + icc_x)
                ny = (math.sin(wdt) * (self.inc_x - icc_x)
                      + math.cos(wdt) * (self.inc_y - icc_y) + icc_y)
                self.inc_x, self.inc_y = nx, ny
                self.inc_yaw += wdt
        self.inc_timestamp = t

    def imu(self, t, w):
        """add_gyro_and_speed (main.cpp:67-84): right-multiply the gyro
        increment SE3(q(w*dt), (0, speed*dt, 0))."""
        if self.last_imu_t is not None:
            dt = t - self.last_imu_t
            dq = _euler_zyx_quat(w[2] * dt, w[1] * dt, w[0] * dt)
            self.gyro_t = self.gyro_t + _quat_rotate(
                self.gyro_q, np.array([0.0, self.speed * dt, 0.0]))
            self.gyro_q = _quat_mul(self.gyro_q, dq)
            self.gyro_q /= np.linalg.norm(self.gyro_q)
        self.last_imu_t = t

    def take_gyro_update(self):
        """Consume incremental_gyro_update (reset at each GPS fix,
        main.cpp:209-215)."""
        q, t = self.gyro_q, self.gyro_t
        self.gyro_q = np.array([1.0, 0, 0, 0])
        self.gyro_t = np.zeros(3)
        self.inc_x = self.inc_y = self.inc_yaw = 0.0
        return q, t


def parse_log(path: str):
    """(imu_rows (N, 7), gps list of (t, x, y, z), guesses list of (q, t)
    dead-reckoned pose increments per fix, parser): the native parser
    (`native.parse_log`) when the library builds here, else `parse_log_py`
    (the same contract; `parser` says which ran)."""
    from .. import native

    if native.available():
        return (*native.parse_log(path, MAX_POSES), "native")
    return (*parse_log_py(path), "python")


def parse_log_py(path: str):
    """Pure-Python parse of either format: (imu_rows, gps, guesses)."""
    text = Path(path).read_text()
    dr = DeadReckoner()
    imu_rows, gps, guesses = [], [], []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if "," in line and line.split(",")[0] in ("imu", "gps"):
            f = line.split(",")
            if f[0] == "imu":
                t, wx, wy, wz, ax, ay, az = map(float, f[1:8])
                dr.imu(t, (wx, wy, wz))
                imu_rows.append((t, wx, wy, wz, ax, ay, az))
            else:
                t, x, y, z = map(float, f[1:5])
                gps.append((t, x, y, z))
                guesses.append(dr.take_gyro_update())
            continue
        f = line.split()
        tag = f[0]
        if tag.startswith("ODO"):
            dr.odo(float(f[1]), float(f[2]), float(f[3]))
        elif tag.startswith("UTM"):
            t, e, n, alt = map(float, f[1:5])
            if len(gps) < MAX_POSES:
                gps.append((t, e, n, alt))
                guesses.append(dr.take_gyro_update())
        elif tag.startswith("IMU"):
            t = float(f[1])
            w = tuple(map(float, f[2:5]))
            a = tuple(map(float, f[5:8]))
            dr.imu(t, w)
            imu_rows.append((t,) + w + a)
        else:
            print(f"Unknown symbol <{tag}>", file=sys.stderr)
    # UTM coordinates are re-based at the first fix (main.cpp:144-149)
    if gps and gps[0][1:] != (0.0, 0.0, 0.0):
        t0, e0, n0, u0 = gps[0]
        gps = [(t, e - e0, n - n0, z - u0) for (t, e, n, z) in gps]
    return np.array(imu_rows) if imu_rows else np.zeros((0, 7)), gps, guesses


def generate_log(path: str, n_gps: int = 30, imu_hz: float = 100.0,
                 gps_hz: float = 1.0, noise_gps: float = 0.5,
                 fmt: str = "ref"):
    """A synthetic planar drive: constant forward speed and yaw rate (a
    circle arc), exact IMU and ODO, GPS with noise from a fixed seed.
    Written in the reference whitespace format (fmt='ref', with ODO
    records) or the CSV alternate."""
    G = 9.8
    yaw_rate = 0.15
    speed = 2.0

    def pose_of(t):
        # unicycle: yaw = yaw_rate*t; forward axis = body +y (the reference
        # gyro-update convention, main.cpp:80)
        yaw = yaw_rate * t
        if abs(yaw_rate) > 1e-9:
            # integral of v = speed * (-sin(w t), cos(w t), 0)
            x = -speed / yaw_rate * (1 - math.cos(yaw))
            y = speed / yaw_rate * math.sin(yaw)
        else:
            x, y = 0.0, speed * t
        return np.array([x, y, 0.0]), yaw

    rng = np.random.default_rng(0)
    t_end = n_gps / gps_hz
    recs = []
    for t in np.arange(0.0, t_end + 1e-9, 1.0 / imu_hz):
        # body frame: z up, y forward; the accelerometer reads
        # a_body = R^T (a_world - g) with the app's gravity (0, 0, +9.8)
        # (main.cpp:229-231) and the integrator's v_dot = R a_body + g
        yaw = yaw_rate * t
        a_world = speed * yaw_rate * np.array(
            [-math.cos(yaw), -math.sin(yaw), 0.0])
        Rz = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                       [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
        a_body = Rz.T @ (a_world - np.array([0, 0, G]))
        if fmt == "ref":
            recs.append((t, "ODO %.6f %.6f %.6f" % (t, speed, speed)))
            recs.append((t, "IMU %.6f 0 0 %.9f %.9f %.9f %.9f"
                         % (t, yaw_rate, *a_body)))
        else:
            recs.append((t, "imu,%.6f,0,0,%.9f,%.9f,%.9f,%.9f"
                         % (t, yaw_rate, *a_body)))
    for i in range(n_gps):
        t = i / gps_hz
        p, _ = pose_of(t)
        p = p + rng.normal(size=3) * noise_gps * np.array([1, 1, 0])
        if fmt == "ref":
            # UTM easting/northing offsets (re-based by the parser)
            recs.append((t, "UTM %.6f %.6f %.6f %.6f"
                         % (t, p[0] + 500000.0, p[1] + 4000000.0, p[2])))
        else:
            recs.append((t, "gps,%.6f,%.6f,%.6f,%.6f" % (t, *p)))
    recs.sort(key=lambda r: r[0])
    Path(path).write_text("\n".join(r[1] for r in recs) + "\n")
    print(f"wrote {len(recs)} records to {path}")


def _imu_source(imu_arr):
    """(t0, t1) -> (times, w, a) of the IMU samples of an interval: the
    native `InterpolationBuffer.get_range` (interpolated boundary samples)
    when the library builds here, else the samples inside [t0, t1]."""
    from .. import native

    if not native.available():
        def span(t0, t1):
            seg = imu_arr[(imu_arr[:, 0] >= t0) & (imu_arr[:, 0] <= t1)]
            return seg[:, 0], seg[:, 1:4], seg[:, 4:7]
        return span
    buf = native.InterpolationBuffer(6)
    for row in imu_arr:
        buf.add(row[0], row[1:7])

    def span(t0, t1):
        ts, vals = buf.get_range(t0, t1)
        return ts, vals[:, :3], vals[:, 3:]
    return span


def _guesses(gps_rows, guesses):
    """The dead-reckoned pose of every fix: the first at the origin
    (main.cpp:162-166), each next one the previous estimate times the gyro
    update (main.cpp:168-172), whose translation comes from the wheel
    speed (main.cpp:67-84)."""
    q = np.array([1.0, 0, 0, 0])
    t_est = np.zeros(3)
    for i, (dq, dt_vec) in enumerate(guesses[:len(gps_rows)]):
        if i:
            t_est = t_est + _quat_rotate(q, dt_vec)
            q = _quat_mul(q, dq)
            q = q / np.linalg.norm(q)
        yield q, t_est


def config():
    """The smoother's configuration: a pose graph (lm_size 0) of 9-dim
    poses, GN steps (the reference's solve), no auto-regularization."""
    from ..core.problem import BAConfig

    return BAConfig(pose_dim=9, lm_size=0, use_dogleg=False,
                    trust_region_size=1e5, enable_auto_regularization=False)


def build_problem_from_records(imu_arr, gps_rows, guesses, device="cuda"):
    """The pose graph the reference builds in f_gps (main.cpp:141-219), in
    f64 on `device`: one pose per fix at its dead-reckoned guess, its GPS
    prior and an IMU residual from the previous fix.  Returns (problem,
    config) with the band width of the problem (consecutive poses only:
    the banded grid)."""
    import dataclasses

    from ..core.problem import ProblemBuilder
    from ..solver.assemble import band_width_of

    span = _imu_source(imu_arr)
    cfg = config()
    b = ProblemBuilder(cfg)
    b.set_gravity(GRAVITY)
    ids = []
    prev_t = None
    for (tt, x, y, z), (q, t_est) in zip(gps_rows,
                                         _guesses(gps_rows, guesses)):
        ids.append(b.add_pose(q, t_est, active=True, time=tt))
        # identity-rotation UTM prior, rotation rows unconstrained
        # (main.cpp:157-183)
        b.add_unary_constraint(ids[-1], [1.0, 0, 0, 0], [x, y, z],
                               cov=GPS_COV)
        if prev_t is not None:
            ts, w, a = span(prev_t, tt)
            if len(ts) == 0:
                raise ValueError("Could not find imu measurements between "
                                 f"{prev_t} and {tt}")
            b.add_imu_residual(ids[-2], ids[-1], w, a, ts)
        prev_t = tt
    problem = b.build(device=device)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(problem))
    return problem, cfg


def solve_batch(problem, cfg):
    """The reference's solve (main.cpp:283-288) on the problem's device
    and float type: (problem, summary)."""
    from ..solver import step

    return step.solve(problem, cfg, max_iter=25, gn_damping=0.2,
                      use_imu=True)


def stream_capacities(imu_arr, gps_rows, W):
    """The ring's table capacities for a window of W fixes: one unary row
    per pose, W - 1 IMU spans of at most the densest interval's samples
    plus the two interpolated boundary samples, no landmark (one padded
    landmark slot and projection row)."""
    from ..solver.streaming import RingCapacities

    tt = np.array([r[0] for r in gps_rows])
    spans = [int(((imu_arr[:, 0] >= a) & (imu_arr[:, 0] <= b)).sum())
             for a, b in zip(tt[:-1], tt[1:])]
    return RingCapacities(L_w=1, n_proj=1, n_imu=max(W - 1, 1),
                          n_unary=W, imu_span=max(spans + [1]) + 2,
                          n_ipair=max(W - 1, 1))


def run_streaming(imu_arr, gps_rows, guesses, W, out=None,
                  iters_per_slide=6, device="cuda", on_push=None):
    """The online fixed-lag smoother (the reference's f_gps pattern driven
    through `StreamingRing`) in f64 on `device`: per fix one pose, its GPS
    prior and the IMU span from the previous fix, then
    `push(block=False)`; one retired pose per fix once the window is warm.
    `on_push(g, out)` is called after each push (for timing).  Writes the
    retired trajectory, completed by the live window's estimates, to
    `out` when given.  Returns (retired outputs as numpy, the ring)."""
    from ..core import camera as cam_mod
    from ..core.problem import Rig
    from ..solver.streaming import StreamingRing

    if len(gps_rows) < W + 1:
        raise SystemExit(
            f"--stream {W} needs at least {W + 1} GPS fixes to retire a "
            f"keyframe; the log has {len(gps_rows)} (use the batch mode)")
    span = _imu_source(imu_arr)
    rig = Rig(params=np.zeros((1, cam_mod.MAX_PARAMS)),
              model=np.zeros((1,), np.int32),
              tvs_q=np.array([[1.0, 0, 0, 0]]), tvs_t=np.zeros((1, 3)))
    ring = StreamingRing(config(), W, rig, np.array(GRAVITY),
                         stream_capacities(imu_arr, gps_rows, W),
                         use_imu=True, iters_per_slide=iters_per_slide,
                         dtype=np.float64, gn_damping=1.0, device=device)
    # the ring's GPS prior takes the information matrix
    cov_inv = np.linalg.inv(GPS_COV)
    outs = []
    prev_t = None
    for (fix_t, x, y, z), (q, t_est) in zip(gps_rows,
                                            _guesses(gps_rows, guesses)):
        g = ring.add_pose(q, t_est, time=fix_t)
        ring.add_unary(g, [1.0, 0, 0, 0], [x, y, z], cov_inv)
        if prev_t is not None:
            ts, w_m, a_m = span(prev_t, fix_t)
            ring.add_imu(g - 1, g, w_m, a_m, ts)
        o = ring.push(block=False)
        if o is not None:
            outs.append(o)
        if on_push is not None:
            on_push(g, o)
        prev_t = fix_t
    outs = [{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in o.items()} for o in outs]
    if out is not None:
        win = ring.current_window()
        with open(out, "w") as fh:
            for o in outs:
                fh.write(",".join(f"{v:.6f}" for v in
                                  [gps_rows[o["pose"]][0]] + list(o["t"]))
                         + "\n")
            # the live window's current estimates complete the trajectory
            for g in range(len(outs), len(gps_rows)):
                fh.write(",".join(f"{v:.6f}" for v in
                                  [gps_rows[g][0]] + list(win["t"][g % W]))
                         + "\n")
    return outs, ring


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log", nargs="?", help="input log file")
    ap.add_argument("--generate", type=int, metavar="N_GPS",
                    help="write a synthetic reference-format log")
    ap.add_argument("--generate-csv", type=int, metavar="N_GPS",
                    help="write a synthetic CSV-format log")
    ap.add_argument("--stream", type=int, metavar="W",
                    help="online fixed-lag smoother with a window of W "
                         "fixes (the reference's f_gps pattern)")
    ap.add_argument("--out", default="trajectory.csv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.generate or args.generate_csv:
        generate_log(args.log or "synthetic_log.txt",
                     args.generate or args.generate_csv,
                     fmt="ref" if args.generate else "csv")
        return 0
    if not args.log:
        ap.error("log file required (or --generate)")

    from .. import resolve_device
    from ..kernels import marginalize as k11
    from ..utils.tree import tree_map

    dev = resolve_device(args.device)
    imu_arr, gps_rows, guesses, parser = parse_log(args.log)
    print(f"parsed {len(imu_arr)} imu samples, {len(gps_rows)} gps fixes "
          f"({parser} parser)")

    if args.stream:
        t0 = _time.perf_counter()
        with k11.Branches() as branches:
            outs, _ = run_streaming(imu_arr, gps_rows, guesses, args.stream,
                                    args.out, device=dev)
            br = branches.read()
        secs = _time.perf_counter() - t0
        n = len(outs)
        k11_line = (f"K11 certified {br['certified']} and clipped "
                    f"{br['clipped']} of {br['marginalizations']} "
                    f"marginalizations" if dev.type == "cuda" else
                    "marginalizations by the plain version (eigh clip)")
        print(f"streamed {len(gps_rows)} fixes on {dev}, retired {n} "
              f"({n / max(secs, 1e-9):.1f}/s, first push included); last "
              f"cost {float(outs[-1]['cost']):.4g}; {k11_line}")
        print(f"wrote optimized trajectory to {args.out}")
        return 0

    problem, cfg = build_problem_from_records(imu_arr, gps_rows, guesses,
                                              device=dev)
    # the batch runs in f32, as the reference app's does
    problem = tree_map(lambda a: a.float() if a.dtype == torch.float64
                       else a, problem)
    t0 = _time.perf_counter()
    problem, summary = solve_batch(problem, cfg)
    secs = _time.perf_counter() - t0
    print(f"solve on {dev} in {secs:.2f} s: {summary}")
    n = len(gps_rows)
    t_out = problem.poses.t[:n].cpu().numpy()
    times = problem.poses.time[:n].cpu().numpy()
    with open(args.out, "w") as fh:
        for i in range(n):
            fh.write(",".join(f"{v:.6f}" for v in
                              [float(times[i])] + list(t_out[i])) + "\n")
    print(f"wrote optimized trajectory to {args.out}")
    return 0 if summary.is_good else 1


if __name__ == "__main__":
    sys.exit(main())
