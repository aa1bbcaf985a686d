// Kernel K2: IMU preintegration of every span of a problem, whitened, one
// launch per evaluation.
//
// Replaces the TPU formulation of ba_tpu/core/residuals/imu.py: the state
// scan of `integrate_span` (:101), `integrate_full` (:122: the state scan,
// vmap(jacfwd) of one RK4 step over all steps, a pairwise tree reduce of
// the affine triples), the per-span function `one` of `evaluate` (:278-297:
// the residual map and its Jacobians by jacfwd, J1s = Jy Phi J_y0, J1b = Jy
// Bsum, C9 = Jy C10 Jy^T), and the whitening `_whiten_from_c9` (:348) and
// `_whiten_pack` (:391).
//
// (a) imu_full, one block per span, its threads over the span's steps,
//   which it walks in chunks of CH = 16 steps (steps 1-4 per chunk), so its
//   shared memory does not grow with the span but for a stack of log2 of
//   the chunk count:
//   1. the chunk's CH + 1 samples of w, a and time (and, once, both poses'
//      entries and gravity) are staged in shared memory in one coalesced
//      pass;
//   2. one thread runs the primal RK4 scan over the chunk from the state it
//      carries and stores the pre-step states: the only serial chain;
//   3. every step's [A | B] = d(step)/d[state, biases] at once: thread
//      (k, j) carries tangent e_j of z = [state(10), gyro bias(3), accel
//      bias(3)] through step k from y_k as a dual number (dual_lie.cuh), so
//      it holds column j; a bias column also writes B R / dt, one division
//      per element.  In the last chunk the residual map's 19 tangents (y_S,
//      10; the tangent [dt, dw, dv] of pose 2, 9) run in the same pass on
//      19 more threads.  Padded steps (dt <= 0) are the identity element
//      (I, 0, 0);
//   4. Q_k = (B_k R / dt_k) B_k^T, then the triples (A, B, Q) reduced
//      pairwise, later after earlier, in the order of ba_tpu's `combine`
//      (:180-200): (A2 A1, A2 B1 + B2, (A2 Q1) A2^T + Q2); an odd count's
//      last element passes to the next round unchanged (the product with
//      ba_tpu's identity padding is exact).  A chunk's product goes onto a
//      stack and merges with the products of equal size below it, as a
//      binary counter carries, and the stack merges from the top at the
//      end: the chunks are aligned blocks of a power of two, so the whole
//      is ba_tpu's tree over all the span's steps, in its order.  A span
//      of one chunk (the flagship's 10 steps) keeps no stack;
//   5. J1s = Jy (Phi J_y0), J1b = Jy Bsum, C9 = (Jy C) Jy^T, and r, j1, j2
//      in the evaluation's (R, D) layout (the 15-dim bias blocks +-I);
//   6. the whitening, as core/residuals/imu.py:_whiten_from_c9 and
//      _whiten_pack compute it: the cached C9 where
//      calculate_inertial_covariance_once has set it, C9 + eps9 I, the
//      blocked 3 x 3 Cholesky factor and its triangular inverse in
//      utils/linalg.py's order (of the 3 x 3 rotation marginal alone under
//      imu_rotation_only), the bias block 1 / sqrt(r_b max(dt_total,
//      1e-12)), sqrt of the robust weight (conditioning edges exempt), then
//      S r, S j1, S j2 with the valid mask and the rotation-only row mask,
//      and err_sq = |S r|^2.
//   It writes ImuEval's fields: the whitened r, j1, j2, err_sq, y_t / y_v
//   (pose 1's t and v) and the unwhitened C9 it used.
// (b) imu_residual, one thread per span (the trial cost), 32 spans per
//   block (fewer for long spans), their samples and C9 staged in shared
//   memory by the block (a span too long for 48 KB reads its samples in
//   place): the same primal recursion, the residual, and the
//   same whitening with the given C9; it writes the whitened r, err_sq,
//   zero Jacobians (coalesced, by the whole block) and the integrated t, v.
//
// Both gather the pose tables by the spans' pose ids themselves and read
// nothing back to the host.
//
// Bound on an H100, (a) at the flagship (127 spans of 11 slots, f32): it
// reads ~190 B of measurements per step and ~250 B of pose entries per span
// and writes ~1.5 KB per span: ~0.5 MB, 0.15 us at 3.35 TB/s; by the chain
// rule ~11 kflop per step and ~10 kflop per span with the whitening (~2.2
// kflop: the blocked factor and inverse ~400, S r, S j1, S j2 ~1,800):
// ~15 Mflop, 0.23 us at 67 TFLOP/s f32.  The primal scan of a span's steps
// is the chain that remains; one block per span puts ~127 blocks on the
// 132 SMs at the flagship.

#include <cuda_runtime.h>

#include "dual_lie.cuh"

namespace {

using ba::Dual;

constexpr int NZ = 16;        // tangents of one RK4 step
constexpr int NRES = 19;      // tangents of the residual map
constexpr int MAX_NT = 256;   // threads per block in (a)
constexpr int TPB = 32;       // threads (spans) per block in (b)
constexpr int CH = 16;        // steps per chunk in (a); a power of two
constexpr int REC = 260;      // one triple [A (10 x 10) | B (10 x 6) | Q]

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

// ---------------------------------------------------------------------------
// The whitening factor (core/residuals/imu.py:_whiten_from_c9 with
// utils/linalg.py's closed-form blocks)

// torch.clamp(x, min=lo): NaN kept
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// The helpers below are fully unrolled (compile-time indices), so their
// small arrays live in registers, not in local memory.

// chol3: the lower Cholesky factor of a 3 x 3 block (row-major), pivots
// floored at 1e-30
template <typename T>
__device__ __forceinline__ void chol3(const T (&A)[9], T (&L)[9]) {
  const T tiny = T(1e-30);
  const T l11 = ba::sqrt_(clamp_min(A[0], T(0)));
  const T d1 = clamp_min(l11, tiny);
  const T l21 = A[3] / d1;
  const T l31 = A[6] / d1;
  const T l22 = ba::sqrt_(clamp_min(A[4] - l21 * l21, T(0)));
  const T d2 = clamp_min(l22, tiny);
  const T l32 = (A[7] - l31 * l21) / d2;
  const T l33 = ba::sqrt_(clamp_min(A[8] - l31 * l31 - l32 * l32, T(0)));
  L[0] = l11; L[1] = T(0); L[2] = T(0);
  L[3] = l21; L[4] = l22; L[5] = T(0);
  L[6] = l31; L[7] = l32; L[8] = l33;
}

// tri_inv3: the inverse of a lower-triangular 3 x 3 block
template <typename T>
__device__ __forceinline__ void tri_inv3(const T (&L)[9], T (&W)[9]) {
  const T i11 = T(1) / L[0];
  const T i22 = T(1) / L[4];
  const T i33 = T(1) / L[8];
  const T w21 = -L[3] * i11 * i22;
  const T w32 = -L[7] * i22 * i33;
  const T w31 = (L[3] * L[7] - L[6] * L[4]) * i11 * i22 * i33;
  W[0] = i11; W[1] = T(0); W[2] = T(0);
  W[3] = w21; W[4] = i22; W[5] = T(0);
  W[6] = w31; W[7] = w32; W[8] = i33;
}

// out = a b (TB: a b^T), 3 x 3 row-major
template <bool TB, typename T>
__device__ __forceinline__ void mm3(const T (&a)[9], const T (&b)[9],
                                    T (&out)[9]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s += a[3 * r + k] * (TB ? b[3 * c + k] : b[3 * k + c]);
      out[3 * r + c] = s;
    }
}

// S = chol(C)^-1 (3N x 3N, row-major, lower) for C (3N x 3N, leading
// dimension ldc), N = 1 or 3: utils/linalg.py's chol_blocked, then
// tri_inv_blocked, block by block in their order
template <int N, typename T>
__device__ __forceinline__ void whiten_from_cov(const T* C, int ldc,
                                                T (&S)[9 * N * N]) {
  T L[N][N][9], Ri[N][9], W[N][N][9];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T A[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          A[3 * r + c] = C[(3 * i + r) * ldc + 3 * j + c];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        T P[9];
        mm3<true>(L[i][k], L[j][k], P);
#pragma unroll
        for (int e = 0; e < 9; ++e) A[e] = A[e] - P[e];
      }
      if (i == j) {
        chol3(A, L[i][i]);
        tri_inv3(L[i][i], Ri[i]);
      } else {
        mm3<true>(A, Ri[j], L[i][j]);
      }
    }
#pragma unroll
  for (int i = 0; i < N; ++i) tri_inv3(L[i][i], W[i][i]);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      T A[9], Wn[9];
      mm3<false>(L[i][j], W[j][j], A);
#pragma unroll
      for (int k = j + 1; k < i; ++k) {
        T P[9];
        mm3<false>(L[i][k], W[k][j], P);
#pragma unroll
        for (int e = 0; e < 9; ++e) A[e] = A[e] + P[e];
      }
#pragma unroll
      for (int e = 0; e < 9; ++e) Wn[e] = -W[i][i][e];
      mm3<false>(Wn, A, W[i][j]);
    }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          S[(3 * i + r) * 3 * N + 3 * j + c] =
              j <= i ? W[i][j][3 * r + c] : T(0);
}

// The whitening options of one evaluation
template <typename T>
struct Whiten {
  const T* weight;               // (Ni,) robust weights
  const unsigned char* valid;    // (Ni,)
  const unsigned char* cond;     // (Ni,) conditioning edges
  T rb_gyro, rb_acc;             // bias random-walk variances
  int rot_only;                  // imu_rotation_only
};

// torch.clamp(amax(time_row) - time_row[0], min=1e-12) of a span's m times
// (torch.amax keeps NaN)
template <typename T>
__device__ __forceinline__ T span_dt_total(const T* time_row, int m) {
  T tmax = time_row[0];
  for (int k = 1; k < m; ++k) {
    const T x = time_row[k];
    tmax = (x > tmax || x != x) ? x : tmax;
  }
  return clamp_min(tmax - time_row[0], T(1e-12));
}

// The whitening factor of span i from its C9 (row-major 9 x 9) and the
// span's dt_total (span_dt_total), as `_whiten_from_c9` forms it: S9 (9 x 9; the rotation
// marginal's factor in rows and columns 3..5 alone under
// imu_rotation_only), the bias block's diagonal sb (R = 15), each already
// times sw = sqrt of the robust weight
template <typename T>
__device__ __forceinline__ void whitening(const Whiten<T>& wo, int i,
                                          const T* c9, int R, T dt_total,
                                          T (&S9)[81], T (&sb)[6]) {
  const T eps9 = sizeof(T) == 8 ? T(1e-12) : T(1e-8);
  T Ce[81];
#pragma unroll
  for (int e = 0; e < 81; ++e)
    Ce[e] = c9[e] + (e / 9 == e % 9 ? eps9 : T(0));
  if (wo.rot_only) {
    T S3[9];
    whiten_from_cov<1>(Ce + 3 * 9 + 3, 9, S3);
#pragma unroll
    for (int e = 0; e < 81; ++e) {
      const int r = e / 9, c = e % 9;
      S9[e] = (r >= 3 && r < 6 && c >= 3 && c < 6)
                  ? S3[3 * (r - 3) + c - 3] : T(0);
    }
  } else {
    whiten_from_cov<3>(Ce, 9, S9);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) sb[k] = T(0);
  if (R == 15) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T rb = k < 3 ? wo.rb_gyro : wo.rb_acc;
      sb[k] = T(1) / ba::sqrt_(rb * dt_total);
    }
  }
  const T wgt = wo.cond[i] ? T(1) : wo.weight[i];
  const T sw = ba::sqrt_(wgt);
#pragma unroll
  for (int e = 0; e < 81; ++e) S9[e] = S9[e] * sw;
#pragma unroll
  for (int k = 0; k < 6; ++k) sb[k] = sb[k] * sw;
}

// the rows the evaluation keeps: all, or 3..5 under imu_rotation_only
__device__ __forceinline__ bool kept_row(int rot_only, int r) {
  return !rot_only || (r >= 3 && r < 6);
}

// ---------------------------------------------------------------------------
// (a)

template <typename T>
struct FullOut {
  T *r, *j1, *j2, *err, *c9, *yt, *yv;
};

// the number of chunks of a span of S steps (one, empty, when S = 0)
__host__ __device__ __forceinline__ int chunk_count(int S) {
  return S > 0 ? (S + CH - 1) / CH : 1;
}

// the stack's depth: floor(log2 nch) + 1 partial products at most (none
// for one chunk)
__host__ __device__ __forceinline__ int stack_depth(int nch) {
  int d = 0;
  if (nch > 1)
    for (int n = nch; n > 0; n >>= 1) ++d;
  return d;
}

// shared-memory layout of one span's block (in units of T): the staged
// samples, states and triples of one chunk of up to CH steps, the stack of
// partial products, and the epilogue; it grows with the span only through
// the stack, as log2 of the chunk count
struct Layout {
  int w, a, time, y, dt, rec, Bs, tmp, stk, JR, T1, T2, J1, J2, C9, Sw, r,
      rw, pose, total;
  __host__ __device__ Layout(int m) {
    const int S = m - 1;
    const int Sc = S < 1 ? 1 : (S < CH ? S : CH);
    const int np = (Sc + 1) / 2;
    int o = 0;
    w = o; o += 3 * (Sc + 1);
    a = o; o += 3 * (Sc + 1);
    time = o; o += Sc + 1;
    y = o; o += 10 * (Sc + 1);
    dt = o; o += Sc;
    rec = o; o += REC * Sc;
    Bs = o; o += 60 * Sc;
    tmp = o; o += REC * np;
    stk = o; o += REC * stack_depth(chunk_count(S));
    JR = o; o += 9 * NRES;
    T1 = o; o += 90;
    T2 = o; o += 90;
    J1 = o; o += 15 * 15;
    J2 = o; o += 15 * 15;
    C9 = o; o += 81;
    Sw = o; o += 15 * 15;
    r = o; o += 16;
    rw = o; o += 16;
    pose = o; o += 40;     // q1 t1 v1 b1 (16), q2 t2 v2 b2 (16), g (3)
    total = o;
  }
};

// x <- combine(x, y) = (A_y A_x, A_y B_x + B_y, (A_y Q_x) A_y^T + Q_y), the
// later element y after the earlier x, for np pairs at once: pair p's
// records [A | B | Q] at x0 + p * step and y0 + p * step; tmp holds np
// records.  Called by the whole block; ends synchronized.
template <typename T>
__device__ __forceinline__ void combine_pairs(T* x0, const T* y0, int step,
                                              int np, T* tmp, int tid,
                                              int nt) {
  for (int item = tid; item < np * REC; item += nt) {
    const int pj = item / REC, e = item - pj * REC;
    const T* x = x0 + pj * step;
    const T* A2 = y0 + pj * step;
    T s = T(0);
    if (e < 100) {
      const int r = e / 10, c = e - r * 10;
      for (int q = 0; q < 10; ++q) s += A2[10 * r + q] * x[10 * q + c];
    } else if (e < 160) {
      const int f = e - 100, r = f / 6, c = f - r * 6;
      for (int q = 0; q < 10; ++q) s += A2[10 * r + q] * x[100 + 6 * q + c];
      s = s + A2[e];
    } else {
      const int f = e - 160, r = f / 10, c = f - r * 10;
      for (int q = 0; q < 10; ++q) s += A2[10 * r + q] * x[160 + 10 * q + c];
    }
    tmp[REC * pj + e] = s;
  }
  __syncthreads();
  // the new Q, A and B of each pair (no conflict: Q reads y's A; A and B
  // are x's)
  for (int item = tid; item < np * REC; item += nt) {
    const int pj = item / REC, e = item - pj * REC;
    T* x = x0 + pj * step;
    const T* y = y0 + pj * step;
    const T* t = tmp + REC * pj;
    if (e < 100) {
      const int r = e / 10, c = e - r * 10;
      T s = T(0);
      for (int q = 0; q < 10; ++q) s += t[160 + 10 * r + q] * y[10 * c + q];
      x[160 + e] = s + y[160 + e];
    } else {
      x[e - 100] = t[e - 100];       // A (e < 200), then B
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(MAX_NT) imu_full_kernel(
    const T* __restrict__ pose_q, const T* __restrict__ pose_t,
    const T* __restrict__ pose_v, const T* __restrict__ pose_b,
    const int* __restrict__ pose1, const int* __restrict__ pose2,
    const T* __restrict__ w, const T* __restrict__ a,
    const T* __restrict__ time, const T* __restrict__ g, T r_gyro, T r_acc,
    const T* __restrict__ c9_cache, const unsigned char* __restrict__ c9_set,
    int cov_once, Whiten<T> wo, int m, int pose_dim, FullOut<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int S = m - 1;
  const int nch = chunk_count(S);
  const Layout lay(m);
  const int i = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p1 = pose1[i], p2 = pose2[i];
  T* sw_ = sm + lay.w;
  T* sa_ = sm + lay.a;
  T* st_ = sm + lay.time;
  T* ps = sm + lay.pose;
  T* sy = sm + lay.y;
  T* sdt = sm + lay.dt;
  T* rec = sm + lay.rec;
  T* sBs = sm + lay.Bs;
  T* tmp = sm + lay.tmp;
  T* stk = sm + lay.stk;
  T* JR = sm + lay.JR;
  T* sr = sm + lay.r;

  // 1. both poses' entries and gravity
  if (tid < 35) {
    const int e = tid;
    T v;
    if (e < 4) v = pose_q[4 * p1 + e];
    else if (e < 7) v = pose_t[3 * p1 + e - 4];
    else if (e < 10) v = pose_v[3 * p1 + e - 7];
    else if (e < 16) v = pose_b[6 * p1 + e - 10];
    else if (e < 20) v = pose_q[4 * p2 + e - 16];
    else if (e < 23) v = pose_t[3 * p2 + e - 20];
    else if (e < 26) v = pose_v[3 * p2 + e - 23];
    else if (e < 32) v = pose_b[6 * p2 + e - 26];
    else v = g[e - 32];
    ps[e] = v;
  }
  const T* q1 = ps;
  const T* t1 = ps + 4;
  const T* v1 = ps + 7;
  const T* b1 = ps + 10;
  const T* q2 = ps + 16;
  const T* t2 = ps + 20;
  const T* v2 = ps + 23;
  const T* b2 = ps + 26;
  const T* gs = ps + 32;

  // 2-4, chunk by chunk (steps c CH .. c CH + cnt - 1); thread 0 carries
  // the state and the running max of the times from chunk to chunk
  const T rn[6] = {r_gyro, r_gyro, r_gyro, r_acc, r_acc, r_acc};
  const long long base = static_cast<long long>(i) * m;
  T y[10], t0 = T(0), tmax = T(0);
  int depth = 0;
  for (int c = 0; c < nch; ++c) {
    const int k0 = c * CH;
    const int cnt = S - k0 < CH ? S - k0 : CH;
    const bool last = c == nch - 1;
    // the chunk's cnt + 1 slots of w, a and time
    for (int e = tid; e < 3 * (cnt + 1); e += nt) {
      sw_[e] = w[(base + k0) * 3 + e];
      sa_[e] = a[(base + k0) * 3 + e];
    }
    for (int e = tid; e <= cnt; e += nt) st_[e] = time[base + k0 + e];
    __syncthreads();

    // 2. the primal scan over the chunk: its pre-step states and the
    //    state after its last step
    if (tid == 0) {
      if (c == 0) {
        for (int q = 0; q < 3; ++q) y[q] = t1[q];
        for (int q = 0; q < 4; ++q) y[3 + q] = q1[q];
        for (int q = 0; q < 3; ++q) y[7 + q] = v1[q];
        t0 = st_[0];
        tmax = st_[0];
      }
      T bg[3], bav[3];
      for (int q = 0; q < 3; ++q) {
        bg[q] = b1[q];
        bav[q] = b1[3 + q];
      }
      for (int q = 0; q < 10; ++q) sy[q] = y[q];
      for (int k = 0; k < cnt; ++k) {
        const T x = st_[k + 1];
        tmax = (x > tmax || x != x) ? x : tmax;      // torch.amax keeps NaN
        const T dt = x - st_[k];
        sdt[k] = dt;
        if (dt > T(0))
          rk4_step(y, sw_ + 3 * k, sa_ + 3 * k, sw_ + 3 * (k + 1),
                   sa_ + 3 * (k + 1), dt, bg, bav, gs);
        for (int q = 0; q < 10; ++q) sy[10 * (k + 1) + q] = y[q];
      }
    }
    __syncthreads();

    // 3. every step's [A | B] (and B R / dt) into its record, and in the
    //    last chunk the residual map's tangents
    for (int item = tid; item < cnt * NZ + (last ? NRES : 0); item += nt) {
      if (item < cnt * NZ) {
        const int k = item / NZ, j = item - k * NZ;
        const T dt = sdt[k];
        T* Ak = rec + REC * k;
        T* Bk = Ak + 100;
        T* Bsk = sBs + 60 * k;
        if (dt > T(0)) {
          Dual<T> z[10], bg[3], bav[3];
          for (int q = 0; q < 10; ++q)
            z[q] = Dual<T>(sy[10 * k + q], j == q ? T(1) : T(0));
          for (int q = 0; q < 3; ++q) {
            bg[q] = Dual<T>(b1[q], j == 10 + q ? T(1) : T(0));
            bav[q] = Dual<T>(b1[3 + q], j == 13 + q ? T(1) : T(0));
          }
          rk4_step(z, sw_ + 3 * k, sa_ + 3 * k, sw_ + 3 * (k + 1),
                   sa_ + 3 * (k + 1), dt, bg, bav, gs);
          if (j < 10) {
            for (int r = 0; r < 10; ++r) Ak[10 * r + j] = z[r].d;
          } else {
            const int q = j - 10;
            for (int r = 0; r < 10; ++r) {
              Bk[6 * r + q] = z[r].d;
              Bsk[6 * r + q] = z[r].d * rn[q] / dt;
            }
          }
        } else if (j < 10) {
          for (int r = 0; r < 10; ++r) Ak[10 * r + j] = r == j ? T(1) : T(0);
        } else {
          const int q = j - 10;
          for (int r = 0; r < 10; ++r) {
            Bk[6 * r + q] = T(0);
            Bsk[6 * r + q] = T(0);
          }
        }
      } else {
        const int lane = item - cnt * NZ;
        const T* yS = sy + 10 * cnt;
        Dual<T> yd[10], d2[9], rr[9];
        for (int q = 0; q < 10; ++q)
          yd[q] = Dual<T>(yS[q], lane == q ? T(1) : T(0));
        for (int q = 0; q < 9; ++q)
          d2[q] = Dual<T>(T(0), lane == 10 + q ? T(1) : T(0));
        res_map(yd, d2, q2, t2, v2, rr);
        for (int r = 0; r < 9; ++r) JR[r * NRES + lane] = rr[r].d;
        if (lane == 0)
          for (int r = 0; r < 9; ++r) sr[r] = rr[r].v;
      }
    }
    if (cnt == 0)                       // no step: the identity element
      for (int e = tid; e < REC; e += nt)
        rec[e] = e < 100 ? ((e / 10 == e % 10) ? T(1) : T(0)) : T(0);
    __syncthreads();

    // 4. Q_k = (B_k R / dt_k) B_k^T (zero on padded steps), then the
    //    chunk's triples reduced pairwise into its first record
    for (int item = tid; item < cnt * 100; item += nt) {
      const int k = item / 100, e = item - k * 100;
      const int r = e / 10, q0 = e - r * 10;
      const T* Bsk = sBs + 60 * k;
      const T* Bk = rec + REC * k + 100;
      T s = T(0);
      for (int q = 0; q < 6; ++q) s += Bsk[6 * r + q] * Bk[6 * q0 + q];
      rec[REC * k + 160 + e] = sdt[k] > T(0) ? s : T(0);
    }
    __syncthreads();
    for (int n = cnt, stride = 1; n > 1; n = (n + 1) / 2, stride *= 2)
      combine_pairs(rec, rec + REC * stride, 2 * REC * stride, n / 2, tmp,
                    tid, nt);

    // the chunk's product onto the stack, merged with the partial products
    // of equal size below it: the chunks of CH (a power of two) steps are
    // aligned, so this is ba_tpu's pairwise tree over all the steps
    if (nch > 1) {
      for (int e = tid; e < REC; e += nt) stk[REC * depth + e] = rec[e];
      __syncthreads();
      ++depth;
      for (int n = c + 1; (n & 1) == 0; n >>= 1, --depth)
        combine_pairs(stk + REC * (depth - 2), stk + REC * (depth - 1), 0, 1,
                      tmp, tid, nt);
    }
  }
  // an unpaired partial product passes up unchanged until it meets one of
  // its size: merge the stack from the top
  for (; depth > 1; --depth)
    combine_pairs(stk + REC * (depth - 2), stk + REC * (depth - 1), 0, 1,
                  tmp, tid, nt);
  const T* fin = nch > 1 ? stk : rec;
  const T* Phi = fin;
  const T* Bsum = fin + 100;
  const T* C = fin + 160;

  // 5. T1 = Phi J_y0 (10 x 9), T2 = Jy C (9 x 10)
  T* T1 = sm + lay.T1;
  T* T2 = sm + lay.T2;
  for (int e = tid; e < 180; e += nt) {
    if (e < 90) {
      const int r = e / 9, c = e % 9;
      T s;
      if (c < 3) {
        s = Phi[r * 10 + c];
      } else if (c < 6) {
        // column c - 3 of 0.5 q1 x [0, e_c] over rows 3..6 of the state
        const int cc = c - 3;
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
    } else {
      const int f = e - 90, r = f / 10, c = f % 10;
      T u = T(0);
      for (int q = 0; q < 10; ++q) u += JR[r * NRES + q] * C[q * 10 + c];
      T2[f] = u;
    }
  }
  __syncthreads();

  // the unwhitened r, j1, j2 (R x D) and C9 (the cache where it is set)
  const int D = pose_dim;
  const int R = D >= 15 ? 15 : 9;
  T* J1 = sm + lay.J1;
  T* J2 = sm + lay.J2;
  T* C9 = sm + lay.C9;
  const bool use_cache = cov_once && *c9_set;
  for (int e = tid; e < R * D + 81 + R; e += nt) {
    if (e < R * D) {
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
          s += JR[r * NRES + q] * Bsum[q * 6 + (c - 9)];
        v1e = s;
        v2e = T(0);
      } else {
        const bool diag = c >= 9 && c - 9 == r - 9;
        v1e = diag ? T(1) : T(0);
        v2e = diag ? T(-1) : T(0);
      }
      J1[e] = v1e;
      J2[e] = v2e;
    } else if (e < R * D + 81) {
      const int f = e - R * D, r = f / 9, c = f % 9;
      T s = T(0);
      for (int q = 0; q < 10; ++q) s += T2[r * 10 + q] * JR[c * NRES + q];
      if (use_cache) s = c9_cache[static_cast<long long>(i) * 81 + f];
      C9[f] = s;
      out.c9[static_cast<long long>(i) * 81 + f] = s;
    } else {
      const int k = e - (R * D + 81);          // the bias rows of r
      if (k >= 9) sr[k] = b1[k - 9] - b2[k - 9];
    }
  }
  __syncthreads();

  // 6. the whitening factor, then S r, S j1, S j2 and err_sq
  T* Sw = sm + lay.Sw;
  if (tid == 0) {
    T S9[81], sb[6];
    whitening(wo, i, C9, R, clamp_min(tmax - t0, T(1e-12)), S9, sb);
#pragma unroll
    for (int r = 0; r < 15; ++r)
#pragma unroll
      for (int c = 0; c < 15; ++c)
        if (r < R && c < R)
          Sw[r * R + c] = (r < 9 && c < 9) ? S9[9 * r + c]
                          : (r == c ? sb[r - 9] : T(0));
  }
  __syncthreads();
  const bool valid = wo.valid[i];
  T* rw = sm + lay.rw;
  const long long base_r = static_cast<long long>(i) * R;
  const long long base_j = base_r * D;
  for (int e = tid; e < R + 2 * R * D; e += nt) {
    if (e < R) {
      T s = T(0);
      for (int q = 0; q < R; ++q) s += Sw[e * R + q] * sr[q];
      s = valid ? s : T(0);
      s = s * (kept_row(wo.rot_only, e) ? T(1) : T(0));
      rw[e] = s;
      out.r[base_r + e] = s;
    } else {
      const int f = e - R;
      const bool second = f >= R * D;
      const int g2 = second ? f - R * D : f;
      const int r = g2 / D, c = g2 - r * D;
      const T* J = second ? J2 : J1;
      T s = T(0);
      for (int q = 0; q < R; ++q)
        s += Sw[r * R + q] * (valid ? J[q * D + c] : T(0));
      s = s * (kept_row(wo.rot_only, r) ? T(1) : T(0));
      (second ? out.j2 : out.j1)[base_j + g2] = s;
    }
  }
  __syncthreads();
  if (tid == 0) {
    T s = T(0);
    for (int q = 0; q < R; ++q) s += rw[q] * rw[q];
    out.err[i] = s;
  }
  if (tid < 3) {
    out.yt[3LL * i + tid] = t1[tid];
    out.yv[3LL * i + tid] = v1[tid];
  }
}

// ---------------------------------------------------------------------------
// (b)

template <typename T>
__global__ void __launch_bounds__(TPB) imu_residual_kernel(
    const T* __restrict__ pose_q, const T* __restrict__ pose_t,
    const T* __restrict__ pose_v, const T* __restrict__ pose_b,
    const int* __restrict__ pose1, const int* __restrict__ pose2,
    const T* __restrict__ w, const T* __restrict__ a,
    const T* __restrict__ time, const T* __restrict__ g,
    const T* __restrict__ c9, Whiten<T> wo, int ni, int m, int pose_dim,
    int staged, FullOut<T> out) {
  // the block's spans' C9 (and, when `staged`, their w, a and time) staged
  // in shared memory and their zero Jacobians written, all coalesced; a
  // span too long to stage reads its samples in place
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc9 = reinterpret_cast<T*>(smem_raw);
  const int spb = blockDim.x;
  const int i0 = blockIdx.x * spb;
  const int nb = min(spb, ni - i0);
  T* sw_ = sc9 + spb * 81;
  T* sa_ = sw_ + spb * 3 * m;
  T* st_ = sa_ + spb * 3 * m;
  const int D = pose_dim;
  const int R = D >= 15 ? 15 : 9;
  for (int e = threadIdx.x; e < nb * 81; e += spb)
    sc9[e] = c9[static_cast<long long>(i0) * 81 + e];
  if (staged) {
    for (int e = threadIdx.x; e < nb * 3 * m; e += spb) {
      sw_[e] = w[static_cast<long long>(i0) * 3 * m + e];
      sa_[e] = a[static_cast<long long>(i0) * 3 * m + e];
    }
    for (int e = threadIdx.x; e < nb * m; e += spb)
      st_[e] = time[static_cast<long long>(i0) * m + e];
  }
  for (long long e = threadIdx.x; e < static_cast<long long>(nb) * R * D;
       e += spb) {
    out.j1[static_cast<long long>(i0) * R * D + e] = T(0);
    out.j2[static_cast<long long>(i0) * R * D + e] = T(0);
  }
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= ni) return;
  const int p1 = pose1[i], p2 = pose2[i];
  T y[10], bg[3], bav[3];
  for (int k = 0; k < 3; ++k) y[k] = pose_t[3 * p1 + k];
  for (int k = 0; k < 4; ++k) y[3 + k] = pose_q[4 * p1 + k];
  for (int k = 0; k < 3; ++k) y[7 + k] = pose_v[3 * p1 + k];
  for (int k = 0; k < 3; ++k) {
    bg[k] = pose_b[6 * p1 + k];
    bav[k] = pose_b[6 * p1 + 3 + k];
  }
  const T* wi_ = staged ? sw_ + threadIdx.x * 3 * m
                        : w + static_cast<long long>(i) * 3 * m;
  const T* ai_ = staged ? sa_ + threadIdx.x * 3 * m
                        : a + static_cast<long long>(i) * 3 * m;
  const T* ti_ = staged ? st_ + threadIdx.x * m
                        : time + static_cast<long long>(i) * m;
  for (int k = 0; k + 1 < m; ++k) {
    const T dt = ti_[k + 1] - ti_[k];
    if (!(dt > T(0))) continue;
    rk4_step(y, wi_ + 3 * k, ai_ + 3 * k, wi_ + 3 * (k + 1),
             ai_ + 3 * (k + 1), dt, bg, bav, g);
  }
  T r[15];
  ba::se3_log_decoupled(y + 3, y, pose_q + 4 * p2, pose_t + 3 * p2, r);
  for (int k = 0; k < 3; ++k) r[6 + k] = y[7 + k] - pose_v[3 * p2 + k];
  for (int k = 9; k < R; ++k)
    r[k] = pose_b[6 * p1 + k - 9] - pose_b[6 * p2 + k - 9];
  T S9[81], sb[6];
  whitening(wo, i, sc9 + 81 * threadIdx.x, R,
            R == 15 ? span_dt_total(ti_, m) : T(0), S9, sb);
  const bool valid = wo.valid[i];
  T err = T(0);
#pragma unroll
  for (int e = 0; e < 15; ++e) {
    if (e >= R) break;
    // row e of S r: S9's row, or the bias block's diagonal entry (the
    // other entries of the row are exact zeros)
    T s = T(0);
    if (e < 9) {
#pragma unroll
      for (int q = 0; q < 9; ++q) s += S9[9 * e + q] * r[q];
    } else {
      s = sb[e - 9] * r[e];
    }
    s = valid ? s : T(0);
    s = s * (kept_row(wo.rot_only, e) ? T(1) : T(0));
    out.r[static_cast<long long>(i) * R + e] = s;
    err += s * s;
  }
  out.err[i] = err;
  for (int k = 0; k < 3; ++k) {
    out.yt[3LL * i + k] = y[k];
    out.yv[3LL * i + k] = y[7 + k];
  }
}

// ---------------------------------------------------------------------------

template <typename T>
int launch_full(const void* const* in, double r_gyro, double r_acc,
                const void* c9_cache, const void* c9_set, int cov_once,
                const void* weight, const void* valid, const void* cond,
                double rb_gyro, double rb_acc, int rot_only, int ni, int m,
                int pose_dim, void* const* outp, void* stream) {
  if (m < 1 || pose_dim < 6) return static_cast<int>(cudaErrorInvalidValue);
  if (ni == 0) return static_cast<int>(cudaGetLastError());
  const int S = m - 1;
  const Layout lay(m);
  const size_t smem = static_cast<size_t>(lay.total) * sizeof(T);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(imu_full_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const int Sc = S < CH ? S : CH;
  int nt = ((Sc * NZ + NRES + 31) / 32) * 32;
  nt = nt > MAX_NT ? MAX_NT : nt;
  Whiten<T> wo = {static_cast<const T*>(weight),
                  static_cast<const unsigned char*>(valid),
                  static_cast<const unsigned char*>(cond),
                  static_cast<T>(rb_gyro), static_cast<T>(rb_acc), rot_only};
  FullOut<T> out = {static_cast<T*>(outp[0]), static_cast<T*>(outp[1]),
                    static_cast<T*>(outp[2]), static_cast<T*>(outp[3]),
                    static_cast<T*>(outp[4]), static_cast<T*>(outp[5]),
                    static_cast<T*>(outp[6])};
  imu_full_kernel<T><<<ni, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const int*>(in[4]), static_cast<const int*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const T*>(in[8]), static_cast<const T*>(in[9]),
      static_cast<T>(r_gyro), static_cast<T>(r_acc),
      static_cast<const T*>(c9_cache),
      static_cast<const unsigned char*>(c9_set), cov_once, wo, m, pose_dim,
      out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_residual(const void* const* in, const void* c9,
                    const void* weight, const void* valid, const void* cond,
                    double rb_gyro, double rb_acc, int rot_only, int ni,
                    int m, int pose_dim, void* const* outp, void* stream) {
  if (m < 1 || pose_dim < 6) return static_cast<int>(cudaErrorInvalidValue);
  if (ni == 0) return static_cast<int>(cudaGetLastError());
  Whiten<T> wo = {static_cast<const T*>(weight),
                  static_cast<const unsigned char*>(valid),
                  static_cast<const unsigned char*>(cond),
                  static_cast<T>(rb_gyro), static_cast<T>(rb_acc), rot_only};
  FullOut<T> out = {static_cast<T*>(outp[0]), static_cast<T*>(outp[1]),
                    static_cast<T*>(outp[2]), static_cast<T*>(outp[3]),
                    nullptr, static_cast<T*>(outp[5]),
                    static_cast<T*>(outp[6])};
  // spans per block: TPB, fewer when their samples would not fit 48 KB;
  // TPB spans with their samples read in place when one span's would not
  size_t per = static_cast<size_t>(81 + 7 * m) * sizeof(T);
  int spb = static_cast<int>((48 * 1024) / per);
  spb = spb > TPB ? TPB : spb;
  const int staged = spb >= 1;
  if (!staged) {
    per = 81 * sizeof(T);
    spb = TPB;
  }
  imu_residual_kernel<T><<<(ni + spb - 1) / spb, spb, spb * per,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const int*>(in[4]), static_cast<const int*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const T*>(in[8]), static_cast<const T*>(in[9]),
      static_cast<const T*>(c9), wo, ni, m, pose_dim, staged, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in: pose q, t, v, b, pose1, pose2, w, a, time, g (10 pointers);
// out: r, j1, j2, err_sq, c9, y_t, y_v (7 pointers; (b) writes no c9)
int ba_imu_full_f32(const void* const* in, double r_gyro, double r_acc,
                    const void* c9_cache, const void* c9_set, int cov_once,
                    const void* weight, const void* valid, const void* cond,
                    double rb_gyro, double rb_acc, int rot_only, int ni,
                    int m, int pose_dim, void* const* out, void* stream) {
  return launch_full<float>(in, r_gyro, r_acc, c9_cache, c9_set, cov_once,
                            weight, valid, cond, rb_gyro, rb_acc, rot_only,
                            ni, m, pose_dim, out, stream);
}

int ba_imu_full_f64(const void* const* in, double r_gyro, double r_acc,
                    const void* c9_cache, const void* c9_set, int cov_once,
                    const void* weight, const void* valid, const void* cond,
                    double rb_gyro, double rb_acc, int rot_only, int ni,
                    int m, int pose_dim, void* const* out, void* stream) {
  return launch_full<double>(in, r_gyro, r_acc, c9_cache, c9_set, cov_once,
                             weight, valid, cond, rb_gyro, rb_acc, rot_only,
                             ni, m, pose_dim, out, stream);
}

int ba_imu_residual_f32(const void* const* in, const void* c9,
                        const void* weight, const void* valid,
                        const void* cond, double rb_gyro, double rb_acc,
                        int rot_only, int ni, int m, int pose_dim,
                        void* const* out, void* stream) {
  return launch_residual<float>(in, c9, weight, valid, cond, rb_gyro, rb_acc,
                                rot_only, ni, m, pose_dim, out, stream);
}

int ba_imu_residual_f64(const void* const* in, const void* c9,
                        const void* weight, const void* valid,
                        const void* cond, double rb_gyro, double rb_acc,
                        int rot_only, int ni, int m, int pose_dim,
                        void* const* out, void* stream) {
  return launch_residual<double>(in, c9, weight, valid, cond, rb_gyro,
                                 rb_acc, rot_only, ni, m, pose_dim, out,
                                 stream);
}

}  // extern "C"
