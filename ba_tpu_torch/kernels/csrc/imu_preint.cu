// Kernel K2: IMU preintegration of every span of a problem, one launch.
//
// Replaces the TPU formulation of ba_tpu/core/residuals/imu.py: the state
// scan of `integrate_span` (:101), `integrate_full` (:122: the state scan,
// vmap(jacfwd) of one RK4 step over all steps, a tree reduce of the affine
// products), and the per-span function `one` of `evaluate` (:278-297: the
// residual map and its Jacobians by jacfwd, J1s = Jy Phi J_y0, J1b = Jy Bsum,
// C9 = Jy C10 Jy^T).  On the TPU the scan's latency chain was broken up
// across steps; on the card a span's recursion is a chain of 10 x 10
// products too small for anything but one warp, and the port's plain
// version of it launched thousands of tiny kernels per evaluation.
//
// (a) imu_full, one warp per span.  Every lane repeats the primal RK4 step;
//     lane j < 16 carries the tangent e_j of z = [state(10), gyro bias(3),
//     accel bias(3)] through it as a dual number (dual_lie.cuh), so after a
//     step lane j holds column j of [A | B] = d(step)/dz, through the
//     quaternion normalization as jacfwd differentiates it.  Then
//     Phi <- A Phi, Bsum <- A Bsum + B and C <- A C A^T + B R B^T / dt run
//     in the warp's shared memory, the lanes splitting the 100 entries.
//     Steps with dt <= 0 (padding) are skipped: exact identities, as the
//     masked elements of the tree reduce.  The residual map's 19 tangents
//     (the integrated state y, 10; the tangent [dt, dw, dv] of pose 2, 9)
//     come the same way, lanes 0-18.  Per span it writes r (9, or 15 with
//     b1 - b2), j1 and j2 in the evaluation's (rdim, D) layout (the bias
//     blocks +-I), C9, and pose 1's t and v (ImuEval.y_t / y_v).
// (b) imu_residual, one thread per span: the state recursion alone and the
//     residual (the trial cost), with the integrated t and v.
//
// Both gather the pose tables by the spans' pose ids themselves.  The
// sequential products equal the tree reduce up to rounding.
//
// Bound on an H100, (a) at the flagship (127 spans of 11 slots, f32): it
// reads ~190 B of measurements per step and ~250 B of pose entries per span
// and writes ~1.5 KB per span: ~0.5 MB, 0.15 us at 3.35 TB/s.  The
// function needs ~11 kflop per step by the chain rule (the step Jacobian
// from the stages' sparse Jacobians ~3,300, the products ~7,200) and ~7.8
// kflop per span: ~15 Mflop, 0.22 us at 67 TFLOP/s f32.  The forward mode
// here does about twice that (16 dual tangents of ~1,000 flops a step) to
// keep one code path for the primal and its Jacobian.  A span's chain of
// dependent steps (10 here) and a warp's shared-memory round trips set the
// pace; the design keeps one launch per evaluation, in place of the plain
// version's thousands.

#include <cuda_runtime.h>

#include "dual_lie.cuh"

namespace {

using ba::Dual;

constexpr int WARPS = 4;   // spans per block in (a)
constexpr int NZ = 16;     // tangents of one RK4 step
constexpr int NRES = 19;   // tangents of the residual map
constexpr int TPB = 128;   // threads per block in (b)

// (d t, d q, d v) of y = (t, q, v); the bias-corrected measurements
// w + bg, a + ba come in as `wb`, `ab`
template <typename S, typename T>
__device__ __forceinline__ void state_deriv(const S* y, const S* wb,
                                            const S* ab, const T* g, S* k) {
  const S* q = y + 3;
  S wq[4] = {S(T(0)), wb[0], wb[1], wb[2]};
  S qd[4];
  ba::quat_mul(q, wq, qd);
  S ra[3];
  ba::quat_rotate(q, ab, ra);
  for (int i = 0; i < 3; ++i) k[i] = y[7 + i];
  for (int i = 0; i < 4; ++i) k[3 + i] = T(0.5) * qd[i];
  for (int i = 0; i < 3; ++i) k[7 + i] = ra[i] + g[i];
}

// One RK4 step of the flat state y10 = [t, q, v] across [t_k, t_k+1], the
// measurements lerped at the midpoint; bg, ba are the biases (duals in (a))
template <typename S, typename T>
__device__ __forceinline__ void rk4_step(S* y, const T* w0, const T* a0,
                                         const T* w1, const T* a1, T dt,
                                         const S* bg, const S* bav,
                                         const T* g) {
  T wh[3], ah[3];
  for (int i = 0; i < 3; ++i) {
    wh[i] = T(0.5) * (w0[i] + w1[i]);
    ah[i] = T(0.5) * (a0[i] + a1[i]);
  }
  S wb[3], ab[3], k1[10], k2[10], k3[10], k4[10], yt[10];
  const T h = T(0.5) * dt;
  for (int i = 0; i < 3; ++i) {
    wb[i] = S(w0[i]) + bg[i];
    ab[i] = S(a0[i]) + bav[i];
  }
  state_deriv(y, wb, ab, g, k1);
  for (int i = 0; i < 10; ++i) yt[i] = y[i] + h * k1[i];
  for (int i = 0; i < 3; ++i) {
    wb[i] = S(wh[i]) + bg[i];
    ab[i] = S(ah[i]) + bav[i];
  }
  state_deriv(yt, wb, ab, g, k2);
  for (int i = 0; i < 10; ++i) yt[i] = y[i] + h * k2[i];
  state_deriv(yt, wb, ab, g, k3);
  for (int i = 0; i < 10; ++i) yt[i] = y[i] + dt * k3[i];
  for (int i = 0; i < 3; ++i) {
    wb[i] = S(w1[i]) + bg[i];
    ab[i] = S(a1[i]) + bav[i];
  }
  state_deriv(yt, wb, ab, g, k4);
  const T s = dt / T(6);
  for (int i = 0; i < 10; ++i)
    y[i] = y[i] + s * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  ba::quat_normalize(y + 3);
}

// The pose and velocity residual of the integrated state y10 against
// pose 2 retracted by d2 = [dt, dw, dv]: [log(normalize(y_q), y_t; Q2, T2),
// y_v - (v2 + dv)]
template <typename S, typename T>
__device__ __forceinline__ void res_map(const S* y, const S* d2, const T* q2,
                                        const T* t2, const T* v2, S* r) {
  S q2s[4] = {S(q2[0]), S(q2[1]), S(q2[2]), S(q2[3])};
  S t2s[3] = {S(t2[0]), S(t2[1]), S(t2[2])};
  S Q2[4], T2[3], yq[4] = {y[3], y[4], y[5], y[6]};
  ba::se3_retract(q2s, t2s, d2, Q2, T2);
  ba::quat_normalize(yq);
  ba::se3_log_decoupled(yq, y, Q2, T2, r);
  for (int i = 0; i < 3; ++i) r[6 + i] = y[7 + i] - (S(v2[i]) + d2[6 + i]);
}

struct Span {
  int p1, p2;
};

template <typename T>
__device__ __forceinline__ void load_pose(const T* q, const T* t,
                                          const T* v, int p, T* y10) {
  for (int i = 0; i < 3; ++i) y10[i] = t[3 * p + i];
  for (int i = 0; i < 4; ++i) y10[3 + i] = q[4 * p + i];
  for (int i = 0; i < 3; ++i) y10[7 + i] = v[3 * p + i];
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) imu_full_kernel(
    const T* __restrict__ pose_q, const T* __restrict__ pose_t,
    const T* __restrict__ pose_v, const T* __restrict__ pose_b,
    const int* __restrict__ pose1, const int* __restrict__ pose2,
    const T* __restrict__ w, const T* __restrict__ a,
    const T* __restrict__ time, const T* __restrict__ g, T r_gyro, T r_acc,
    int ni, int m, int pose_dim, T* __restrict__ r_out,
    T* __restrict__ j1_out, T* __restrict__ j2_out, T* __restrict__ c9_out,
    T* __restrict__ yt_out, T* __restrict__ yv_out) {
  __shared__ T s_ab[WARPS][10 * NZ];   // [A | B] of the step, row-major
  __shared__ T s_phi[WARPS][100];
  __shared__ T s_bs[WARPS][60];
  __shared__ T s_c[WARPS][100];
  __shared__ T s_t1[WARPS][100];
  __shared__ T s_t2[WARPS][100];
  __shared__ T s_t3[WARPS][60];
  __shared__ T s_jr[WARPS][9 * NRES];  // [Jy | J2s], row-major

  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + wi;
  if (i >= ni) return;
  T* AB = s_ab[wi];
  T* Phi = s_phi[wi];
  T* Bs = s_bs[wi];
  T* C = s_c[wi];
  T* T1 = s_t1[wi];
  T* T2 = s_t2[wi];
  T* T3 = s_t3[wi];
  T* JR = s_jr[wi];

  const Span sp = {pose1[i], pose2[i]};
  T y[10], b[6];
  load_pose(pose_q, pose_t, pose_v, sp.p1, y);
  for (int k = 0; k < 6; ++k) b[k] = pose_b[6 * sp.p1 + k];
  const T q1[4] = {y[3], y[4], y[5], y[6]};
  const T t1[3] = {y[0], y[1], y[2]};
  const T v1[3] = {y[7], y[8], y[9]};
  const T rn[6] = {r_gyro, r_gyro, r_gyro, r_acc, r_acc, r_acc};
  for (int e = lane; e < 100; e += 32) {
    Phi[e] = (e / 10 == e % 10) ? T(1) : T(0);
    C[e] = T(0);
  }
  for (int e = lane; e < 60; e += 32) Bs[e] = T(0);
  __syncwarp();

  const T* wi_ = w + static_cast<long long>(i) * m * 3;
  const T* ai_ = a + static_cast<long long>(i) * m * 3;
  const T* ti_ = time + static_cast<long long>(i) * m;
  for (int k = 0; k + 1 < m; ++k) {
    const T dt = ti_[k + 1] - ti_[k];
    if (!(dt > T(0))) continue;            // padding: identity
    Dual<T> z[10], bg[3], bav[3];
    for (int c = 0; c < 10; ++c) z[c] = Dual<T>(y[c], lane == c ? T(1) : T(0));
    for (int c = 0; c < 3; ++c) {
      bg[c] = Dual<T>(b[c], lane == 10 + c ? T(1) : T(0));
      bav[c] = Dual<T>(b[3 + c], lane == 13 + c ? T(1) : T(0));
    }
    rk4_step(z, wi_ + 3 * k, ai_ + 3 * k, wi_ + 3 * (k + 1),
             ai_ + 3 * (k + 1), dt, bg, bav, g);
    if (lane < NZ)
      for (int r = 0; r < 10; ++r) AB[r * NZ + lane] = z[r].d;
    for (int c = 0; c < 10; ++c) y[c] = z[c].v;
    __syncwarp();
    // T1 = A C, T2 = A Phi, T3 = A Bsum + B
    for (int e = lane; e < 100; e += 32) {
      const int r = e / 10, c = e % 10;
      T s1 = T(0), s2 = T(0);
      for (int q = 0; q < 10; ++q) {
        s1 += AB[r * NZ + q] * C[q * 10 + c];
        s2 += AB[r * NZ + q] * Phi[q * 10 + c];
      }
      T1[e] = s1;
      T2[e] = s2;
    }
    for (int e = lane; e < 60; e += 32) {
      const int r = e / 6, c = e % 6;
      T s = T(0);
      for (int q = 0; q < 10; ++q) s += AB[r * NZ + q] * Bs[q * 6 + c];
      T3[e] = s + AB[r * NZ + 10 + c];
    }
    __syncwarp();
    // C = T1 A^T + B R B^T / dt; Phi = T2; Bsum = T3
    for (int e = lane; e < 100; e += 32) {
      const int r = e / 10, c = e % 10;
      T s = T(0), qd = T(0);
      for (int q = 0; q < 10; ++q) s += T1[r * 10 + q] * AB[c * NZ + q];
      for (int q = 0; q < 6; ++q)
        qd += AB[r * NZ + 10 + q] * rn[q] / dt * AB[c * NZ + 10 + q];
      C[e] = s + qd;
      Phi[e] = T2[e];
    }
    for (int e = lane; e < 60; e += 32) Bs[e] = T3[e];
    __syncwarp();
  }

  // the residual map and its 19 tangents
  const T* q2 = pose_q + 4 * sp.p2;
  const T* t2 = pose_t + 3 * sp.p2;
  const T* v2 = pose_v + 3 * sp.p2;
  Dual<T> yd[10], d2[9], rr[9];
  for (int c = 0; c < 10; ++c) yd[c] = Dual<T>(y[c], lane == c ? T(1) : T(0));
  for (int c = 0; c < 9; ++c) d2[c] = Dual<T>(T(0), lane == 10 + c ? T(1) : T(0));
  res_map(yd, d2, q2, t2, v2, rr);
  if (lane < NRES)
    for (int r = 0; r < 9; ++r) JR[r * NRES + lane] = rr[r].d;
  // J_y0 (10 x 9) = d(t1, q1, v1) / d[dt, dw, dv]: identities and the
  // rotation block 0.5 q1 x [0, e_c], kept in T3 (60) and T1's tail
  __syncwarp();
  // T1 = Phi J_y0 (10 x 9), T2[0:90] = Jy C (9 x 10)
  for (int e = lane; e < 90; e += 32) {
    const int r = e / 9, c = e % 9;
    T s;
    if (c < 3) {
      s = Phi[r * 10 + c];
    } else if (c < 6) {
      const int cc = c - 3;
      // column cc of 0.5 q1 x [0, e_cc] over rows 3..6 of the state
      const T x = q1[1], yy = q1[2], zz = q1[3], ww = q1[0];
      const T col[3][4] = {{-x, ww, zz, -yy}, {-yy, -zz, ww, x},
                           {-zz, yy, -x, ww}};
      s = T(0);
      for (int q = 0; q < 4; ++q)
        s += Phi[r * 10 + 3 + q] * (T(0.5) * col[cc][q]);
    } else {
      s = Phi[r * 10 + 7 + (c - 6)];
    }
    T1[e] = s;
    const int r2 = e / 10, c2 = e % 10;
    T u = T(0);
    for (int q = 0; q < 10; ++q) u += JR[r2 * NRES + q] * C[q * 10 + c2];
    T2[e] = u;
  }
  __syncwarp();

  const int D = pose_dim;
  const int rdim = D >= 15 ? 15 : 9;
  const long long base_r = static_cast<long long>(i) * rdim;
  const long long base_j = base_r * D;
  // J1s = Jy T1 (9 x 9), J1b = Jy Bsum (9 x 6), J2s, then the bias rows
  for (int e = lane; e < rdim * D; e += 32) {
    const int r = e / D, c = e % D;
    T v1e, v2e;
    if (r < 9 && c < 9) {
      T s = T(0);
      for (int q = 0; q < 10; ++q) s += JR[r * NRES + q] * T1[q * 9 + c];
      v1e = s;
      v2e = JR[r * NRES + 10 + c];
    } else if (r < 9) {
      T s = T(0);
      for (int q = 0; q < 10; ++q)
        s += JR[r * NRES + q] * Bs[q * 6 + (c - 9)];
      v1e = s;
      v2e = T(0);
    } else {
      const bool diag = c >= 9 && c - 9 == r - 9;
      v1e = diag ? T(1) : T(0);
      v2e = diag ? T(-1) : T(0);
    }
    j1_out[base_j + e] = v1e;
    j2_out[base_j + e] = v2e;
  }
  for (int e = lane; e < 81; e += 32) {
    const int r = e / 9, c = e % 9;
    T s = T(0);
    for (int q = 0; q < 10; ++q) s += T2[r * 10 + q] * JR[c * NRES + q];
    c9_out[static_cast<long long>(i) * 81 + e] = s;
  }
  if (lane < rdim) {
    T v;
    if (lane < 9) {
      v = rr[lane].v;
    } else {
      v = b[lane - 9] - pose_b[6 * sp.p2 + lane - 9];
    }
    r_out[base_r + lane] = v;
  }
  if (lane < 3) {
    yt_out[3LL * i + lane] = t1[lane];
    yv_out[3LL * i + lane] = v1[lane];
  }
}

template <typename T>
__global__ void __launch_bounds__(TPB) imu_residual_kernel(
    const T* __restrict__ pose_q, const T* __restrict__ pose_t,
    const T* __restrict__ pose_v, const T* __restrict__ pose_b,
    const int* __restrict__ pose1, const int* __restrict__ pose2,
    const T* __restrict__ w, const T* __restrict__ a,
    const T* __restrict__ time, const T* __restrict__ g, int ni, int m,
    int pose_dim, T* __restrict__ r_out, T* __restrict__ yt_out,
    T* __restrict__ yv_out) {
  const int i = blockIdx.x * TPB + threadIdx.x;
  if (i >= ni) return;
  const int p1 = pose1[i], p2 = pose2[i];
  T y[10], bg[3], bav[3];
  load_pose(pose_q, pose_t, pose_v, p1, y);
  for (int k = 0; k < 3; ++k) {
    bg[k] = pose_b[6 * p1 + k];
    bav[k] = pose_b[6 * p1 + 3 + k];
  }
  const T* wi_ = w + static_cast<long long>(i) * m * 3;
  const T* ai_ = a + static_cast<long long>(i) * m * 3;
  const T* ti_ = time + static_cast<long long>(i) * m;
  for (int k = 0; k + 1 < m; ++k) {
    const T dt = ti_[k + 1] - ti_[k];
    if (!(dt > T(0))) continue;
    rk4_step(y, wi_ + 3 * k, ai_ + 3 * k, wi_ + 3 * (k + 1),
             ai_ + 3 * (k + 1), dt, bg, bav, g);
  }
  const int rdim = pose_dim >= 15 ? 15 : 9;
  T* r = r_out + static_cast<long long>(i) * rdim;
  T rp[6];
  ba::se3_log_decoupled(y + 3, y, pose_q + 4 * p2, pose_t + 3 * p2, rp);
  for (int k = 0; k < 6; ++k) r[k] = rp[k];
  for (int k = 0; k < 3; ++k) r[6 + k] = y[7 + k] - pose_v[3 * p2 + k];
  for (int k = 9; k < rdim; ++k)
    r[k] = pose_b[6 * p1 + k - 9] - pose_b[6 * p2 + k - 9];
  for (int k = 0; k < 3; ++k) {
    yt_out[3LL * i + k] = y[k];
    yv_out[3LL * i + k] = y[7 + k];
  }
}

template <typename T>
int launch_full(const T* q, const T* t, const T* v, const T* b,
                const int* p1, const int* p2, const T* w, const T* a,
                const T* time, const T* g, T r_gyro, T r_acc, int ni, int m,
                int pose_dim, T* r, T* j1, T* j2, T* c9, T* yt, T* yv,
                void* stream) {
  if (ni > 0) {
    imu_full_kernel<T><<<(ni + WARPS - 1) / WARPS, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        q, t, v, b, p1, p2, w, a, time, g, r_gyro, r_acc, ni, m, pose_dim, r,
        j1, j2, c9, yt, yv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_residual(const T* q, const T* t, const T* v, const T* b,
                    const int* p1, const int* p2, const T* w, const T* a,
                    const T* time, const T* g, int ni, int m, int pose_dim,
                    T* r, T* yt, T* yv, void* stream) {
  if (ni > 0) {
    imu_residual_kernel<T><<<(ni + TPB - 1) / TPB, TPB, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        q, t, v, b, p1, p2, w, a, time, g, ni, m, pose_dim, r, yt, yv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_imu_full_f32(const float* q, const float* t, const float* v,
                    const float* b, const int* p1, const int* p2,
                    const float* w, const float* a, const float* time,
                    const float* g, double r_gyro, double r_acc, int ni,
                    int m, int pose_dim, float* r, float* j1, float* j2,
                    float* c9, float* yt, float* yv, void* stream) {
  return launch_full<float>(q, t, v, b, p1, p2, w, a, time, g,
                            static_cast<float>(r_gyro),
                            static_cast<float>(r_acc), ni, m, pose_dim, r, j1,
                            j2, c9, yt, yv, stream);
}

int ba_imu_full_f64(const double* q, const double* t, const double* v,
                    const double* b, const int* p1, const int* p2,
                    const double* w, const double* a, const double* time,
                    const double* g, double r_gyro, double r_acc, int ni,
                    int m, int pose_dim, double* r, double* j1, double* j2,
                    double* c9, double* yt, double* yv, void* stream) {
  return launch_full<double>(q, t, v, b, p1, p2, w, a, time, g, r_gyro,
                             r_acc, ni, m, pose_dim, r, j1, j2, c9, yt, yv,
                             stream);
}

int ba_imu_residual_f32(const float* q, const float* t, const float* v,
                        const float* b, const int* p1, const int* p2,
                        const float* w, const float* a, const float* time,
                        const float* g, int ni, int m, int pose_dim,
                        float* r, float* yt, float* yv, void* stream) {
  return launch_residual<float>(q, t, v, b, p1, p2, w, a, time, g, ni, m,
                                pose_dim, r, yt, yv, stream);
}

int ba_imu_residual_f64(const double* q, const double* t, const double* v,
                        const double* b, const int* p1, const int* p2,
                        const double* w, const double* a, const double* time,
                        const double* g, int ni, int m, int pose_dim,
                        double* r, double* yt, double* yv, void* stream) {
  return launch_residual<double>(q, t, v, b, p1, p2, w, a, time, g, ni, m,
                                 pose_dim, r, yt, yv, stream);
}

}  // extern "C"
