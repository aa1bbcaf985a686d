// K11: the marginalization prior of the departing poses.
//
// Input: S (n, n) and rhs (n) of the departing system after its landmarks
// were eliminated (K5), pd (n) the departing dimensions, eps.  Output:
//
//   (a) X = (S_dd + eps I)^-1, k = |d| the departing dims,
//       H = keep (S - S_:d X S_:d^T) keep,  g = keep (rhs - S_:d X rhs_d),
//       keep = 1 - pd, then H <- (H + H^T) / 2;
//   (b) H <- V max(L, 0) V^T for H = V L V^T, the nearest PSD matrix.
//
// Replaces the TPU formulation ba_tpu/solver/window.py:marginalize
// (:102-127): the masked inverse of B = Pd S Pd + (I - Pd) + eps Pd, an
// n x n inverse whose d-block is used, and `eigh` for the PSD clip.  (a)
// is the same function: B is block diagonal after a permutation, the
// identity outside d and S_dd + eps I on d, so the d-block of B^-1 is
// exactly (S_dd + eps I)^-1, here inverted alone by Gauss-Jordan
// elimination with partial pivoting (LU's row pivoting, as `inv`).  (b) is
// unique whatever eigenvectors are chosen; written as H - sum over the
// negative eigenvalues of l v v^T, it leaves a PSD input unchanged.
//
// Design: one block of 1024 threads, no host read.  (a): the pivot
// search by one thread, the updates by all; S_:d X and S_:d staged in
// shared memory when they fit; the Schur terms of H only where both dims
// are connected to the departing ones (a row with no entry in the
// departing columns has an exactly zero Z row, so both terms of any pair
// it is in are exact zeros); the active dims, ||H||_F and finiteness
// gathered as H is written.  Then:
//
//   * The active dims.  A row of H that is exactly zero (a departing dim,
//     a kept pose that shares no residual with the departing ones) is its
//     own eigenvector with eigenvalue 0: (b) leaves it alone, and the rest
//     works on the na active dims only, gathered by a warp's ballots.
//   * A PSD certificate.  H_aa + tau I is factorized by a blocked
//     right-looking Cholesky in f64 (for the f32 input too: the work is
//     latency-bound).  If every pivot is positive, H has no eigenvalue
//     below -tau, up to the f64 factor's roundoff (~na 1e-16 ||H||), so
//     the clip would change H by at most sqrt(#neg) tau in Frobenius norm:
//     H is returned as it is (info certified = 1, no sweep).  tau = c
//     ||H||_F with c = 1e-8 in f32 and 1e-12 in f64, so that sqrt(#neg)
//     tau stays an order of magnitude under the tolerances the kernel is
//     held to: f32 output PSD to -1e-6 ||H||_F and within 1e-4 ||H||_F of
//     `eigh`'s clip, f64 within 1e-10 ||H||_F (for #neg up to ~100).  In
//     f32, c is at f32's own roundoff (~6e-8), so a PSD input whose
//     near-null eigenvalues are f32 noise still certifies.  The packed f64
//     triangle (1 MB at n = 360) lives on the L2-resident workspace; a
//     panel of 32 columns is copied to shared memory and factorized there
//     (one barrier per column), then the trailing triangle is updated once
//     per panel, 32 terms per element.  A cluster holding column panels in
//     distributed shared memory would split each column's barrier across
//     blocks; one block keeps the barrier cheap and the launch single.
//   * Only when the certificate fails, the clip by cyclic Jacobi on the
//     active block in round-robin (Brent-Luk) order: na/2 disjoint pairs
//     per round, na - 1 rounds per sweep.  A round is two barriers: one
//     thread per pair computes its rotation and the round's pair table
//     (the pair by one conditional subtraction, no division or modulo)
//     into shared memory, and a __syncthreads_or ends the round when no
//     pair rotates; then A <- J^T A J one 2 x 2 block per thread (pairs
//     t <= u: rows by t's rotation, columns by u's, written with its
//     mirror, so A stays exactly symmetric; a rotated pair's own block set
//     exactly: a_pq = 0, a_pp - t a_pq, a_qq + t a_pq), and V <- V J as
//     rows of V^T, a warp per pair.  A pair rotates when |a_pq| > delta =
//     eps_machine ||H||_F / n; a sweep starts only while some off-diagonal
//     element exceeds delta (read on the device), at most max_sweeps.  A
//     and V^T live in shared memory when 2 na^2 elements fit (na <= 168
//     in f32, 119 in f64), A alone when na^2 do (na <= 238 in f32, 168 in
//     f64), otherwise in the workspace.
//
// info = {converged and finite, sweeps, clipped eigenvalues, k, rotations,
// certified}; the solve never reads it.  Every sum runs in a fixed order,
// so two launches are bit-identical.
//
// Bound on an H100: operations.  The certificate's na^3 / 3 flops and a
// Jacobi rotation's ~12 na are a few MFLOP at n = 90, well under a
// microsecond at 67 TFLOP/s; one block runs it, so its time is the chain of
// barriers: na columns of the factor, and 1-2 per Jacobi round.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int JB = 4;          // a V pass's elements per lane in flight

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr float eps = 1.1920929e-7f;
  static constexpr double tau = 1e-8;    // certificate shift / ||H||_F
};
template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double tau = 1e-12;
};

// round r's pair t of the circle schedule over m (even) indices: slot 0
// holds index 0, slot i >= 1 holds 1 + (i - 1 + r) mod (m - 1), a sum
// below 2 (m - 1); pair t joins slots t and m - 1 - t
__device__ __forceinline__ void rr_pair(int m, int r, int t, int& p, int& q) {
  int a = 0, b = 0;
  if (t != 0) {
    a = t - 1 + r;
    a = 1 + (a >= m - 1 ? a - (m - 1) : a);
  }
  const int s = m - 1 - t;
  if (s != 0) {
    b = s - 1 + r;
    b = 1 + (b >= m - 1 ? b - (m - 1) : b);
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double tot = 0.0;
  for (int w = 0; w < WARPS; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

__device__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double m = red[0];
  for (int w = 1; w < WARPS; ++w) m = fmax(m, red[w]);
  __syncthreads();
  return m;
}

// warp 0 gathers the indices i < n with flag[i] != 0 into out, in order;
// returns the count in ctl[slot] (read after a barrier)
__device__ void gather(const int* flag, int n, int* out, int* ctl, int slot) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int f = i < n && flag[i];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (f) out[base + __popc(bal & ((1u << lane) - 1u))] = i;
    base += __popc(bal);
  }
  if (lane == 0) ctl[slot] = base;
}

__device__ __forceinline__ long long tri(long long r) {
  return r * (r + 1) / 2;
}

// rows (Ap, Aq) rotated by (c, s); a lane keeps JB elements' loads in
// flight (the workspace's latency), or one (shared memory)
template <int JB, typename T>
__device__ __forceinline__ void rot_rows(T* Ap, T* Aq, int na, T c, T s,
                                         int lane) {
  for (int j0 = lane; j0 < na; j0 += 32 * JB) {
    T x[JB], y[JB];
#pragma unroll
    for (int u = 0; u < JB; ++u) {
      const int j = j0 + 32 * u;
      x[u] = j < na ? Ap[j] : T(0);
      y[u] = j < na ? Aq[j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < JB; ++u) {
      const int j = j0 + 32 * u;
      if (j >= na) break;
      Ap[j] = c * x[u] - s * y[u];
      Aq[j] = s * x[u] + c * y[u];
    }
  }
}

// the shared memory after the (f64 panel | A, V^T) region: red (32 f64)
// w (n) cs sn dp dq (n/2 + 1 each) | idx act flag (n each) ctl (8) pp qq
// (n/2 + 1 each)
__host__ __device__ inline long long tail_bytes(int n, int size) {
  const long long half = (n + 1) / 2;
  return 32 * 8 + (n + 4 * half) * size + (3LL * n + 8 + 2 * half) * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    marginalize_kernel(const T* __restrict__ S, const T* __restrict__ rhs,
                       const unsigned char* __restrict__ pd, int n, T eps,
                       int max_sweeps, long long region,
                       T* __restrict__ work, T* __restrict__ H,
                       T* __restrict__ g, int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long nn = static_cast<long long>(n) * n;
  const int hn = (n + 1) / 2;
  double* red = reinterpret_cast<double*>(smem + region);
  T* w = reinterpret_cast<T*>(red + 32);
  T* cs = w + n;
  T* sn = cs + hn;
  T* dpv = sn + hn;
  T* dqv = dpv + hn;
  int* idx = reinterpret_cast<int*>(dqv + hn);
  int* act = idx + n;
  int* flag = act + n;
  int* ctl = flag + n;
  int* pp = ctl + 8;
  int* qq = pp + hn;

  // ---- (a) the departing dims' Schur complement --------------------------
  for (int i = tid; i < n; i += THREADS) flag[i] = pd[i] != 0;
  __syncthreads();
  gather(flag, n, idx, ctl, 0);
  __syncthreads();
  const int k = ctl[0], k2 = 2 * k;
  T* aug = work;                       // [S_dd + eps I | I], k x 2k
  T* Z = work + 2 * nn;                // S_:d X, n x k (or staged)
  for (int e = tid; e < k * k2; e += THREADS) {
    const int a = e / k2, c = e - a * k2;
    aug[e] = c < k ? S[static_cast<long long>(idx[a]) * n + idx[c]]
                         + (a == c ? eps : T(0))
                   : (c - k == a ? T(1) : T(0));
  }
  __syncthreads();
  for (int c = 0; c < k; ++c) {
    if (tid == 0) {
      int p = c;
      T best = fabs(aug[c * k2 + c]);
      for (int r = c + 1; r < k; ++r) {
        const T v = fabs(aug[r * k2 + c]);
        if (v > best) {
          best = v;
          p = r;
        }
      }
      ctl[1] = p;
    }
    __syncthreads();
    const int p = ctl[1];
    if (p != c)
      for (int e = tid; e < k2; e += THREADS) {
        const T x = aug[c * k2 + e];
        aug[c * k2 + e] = aug[p * k2 + e];
        aug[p * k2 + e] = x;
      }
    __syncthreads();
    for (int r = tid; r < k; r += THREADS) w[r] = aug[r * k2 + c];
    __syncthreads();
    const T piv = w[c];
    for (int e = tid; e < k2; e += THREADS) aug[c * k2 + e] /= piv;
    __syncthreads();
    for (int e = tid; e < k * k2; e += THREADS) {
      const int r = e / k2;
      if (r != c) aug[e] = fma(-w[r], aug[c * k2 + (e - r * k2)], aug[e]);
    }
    __syncthreads();
  }
  // X[a][b] = aug[a * k2 + k + b]
  // S_:d X (n x k) and S_:d, in shared memory when both fit (the region
  // is free until (b)), else Z in the workspace and S_:d read from S
  const long long nk = static_cast<long long>(n) * k;
  const bool staged = 2 * nk * static_cast<long long>(sizeof(T)) <= region;
  T* Sd = reinterpret_cast<T*>(smem) + nk;
  if (staged) {
    Z = reinterpret_cast<T*>(smem);
    for (long long e = tid; e < nk; e += THREADS) {
      const int i = static_cast<int>(e / k), b = static_cast<int>(e - i * k);
      Sd[e] = S[static_cast<long long>(i) * n + idx[b]];
    }
  }
  for (long long e = tid; e < nk; e += THREADS) {
    const int i = static_cast<int>(e / k), b = static_cast<int>(e - i * k);
    T s = T(0);
    for (int a = 0; a < k; ++a)
      s = fma(S[static_cast<long long>(i) * n + idx[a]], aug[a * k2 + k + b],
              s);
    Z[e] = s;
  }
  for (int a = tid; a < k; a += THREADS) {
    T s = T(0);
    for (int b = 0; b < k; ++b) s = fma(aug[a * k2 + k + b], rhs[idx[b]], s);
    w[a] = s;
  }
  // a row with no entry in the departing columns is not connected to
  // them: its Z row is exactly zero, and so are both Schur terms of any
  // pair it is in (act holds the flags until the active dims replace it)
  for (int i = tid; i < n; i += THREADS) {
    int c = 0;
    for (int a = 0; a < k; ++a)
      c |= S[static_cast<long long>(i) * n + idx[a]] != T(0);
    act[i] = c;
    flag[i] = 0;
  }
  __syncthreads();
  const int tx = lane, ty = warp;
  double part = 0.0;
  int bad = 0;
  for (int i = ty; i < n; i += WARPS) {
    const long long ri = static_cast<long long>(i) * n;
    for (int j = tx; j < n; j += 32) {
      if (pd[i] || pd[j]) {
        H[ri + j] = T(0);
        continue;
      }
      T hij = T(0), hji = T(0);
      if (act[i] && act[j]) {
        const T* Zi = Z + static_cast<long long>(i) * k;
        const T* Zj = Z + static_cast<long long>(j) * k;
        if (staged) {
          const T* Si = Sd + static_cast<long long>(i) * k;
          const T* Sj = Sd + static_cast<long long>(j) * k;
          for (int b = 0; b < k; ++b) {
            hij = fma(Zi[b], Sj[b], hij);
            hji = fma(Zj[b], Si[b], hji);
          }
        } else {
          for (int b = 0; b < k; ++b) {
            hij = fma(Zi[b], S[static_cast<long long>(j) * n + idx[b]], hij);
            hji = fma(Zj[b], S[ri + idx[b]], hji);
          }
        }
      }
      const T h = T(0.5) * ((S[ri + j] - hij)
                            + (S[static_cast<long long>(j) * n + i] - hji));
      H[ri + j] = h;
      // the active dims: rows with an entry not exactly zero (a benign
      // race: every writer writes 1); ||H||_F; finiteness
      if (h != T(0)) flag[i] = 1;
      part = fma(static_cast<double>(h), static_cast<double>(h), part);
      bad |= !isfinite(h);
    }
  }
  for (int i = tid; i < n; i += THREADS) {
    T s = T(0);
    for (int a = 0; a < k; ++a)
      s = fma(S[static_cast<long long>(i) * n + idx[a]], w[a], s);
    const T gi = pd[i] ? T(0) : rhs[i] - s;
    g[i] = gi;
    bad |= !isfinite(gi);
  }
  const double fro = sqrt(block_sum(part, red));
  gather(flag, n, act, ctl, 2);
  __syncthreads();
  const int na = ctl[2];

  // ---- (b1) the certificate: Cholesky of H_aa + tau I in f64 -------------
  // blocked: the packed lower triangle on the L2-resident workspace, panels
  // of pw columns factorized in shared memory (one barrier per column),
  // then one pass of the trailing triangle per panel
  const double tau = Limits<T>::tau * fro;
  double* Lw = reinterpret_cast<double*>(work);
  double* P = reinterpret_cast<double*>(smem);
  int pw = 32;
  while (pw > 1 && (static_cast<long long>(na) * (pw + 1) + pw) * 8 > region)
    --pw;
  const int ld = pw + 1;
  double* invd = P + static_cast<long long>(na) * ld;
  bool certified = (static_cast<long long>(na) * ld + pw) * 8 <= region;
  for (int i = ty; i < na; i += WARPS) {
    const long long ri = static_cast<long long>(act[i]) * n;
    for (int j = tx; j <= i; j += 32)
      Lw[tri(i) + j] = static_cast<double>(H[ri + act[j]])
                       + (i == j ? tau : 0.0);
  }
  __syncthreads();
  for (int k0 = 0; certified && k0 < na; k0 += pw) {
    const int m = na - k0, wd = min(pw, m);
    for (int r = ty; r < m; r += WARPS)
      for (int c = tx; c < wd && c <= r; c += 32)
        P[static_cast<long long>(r) * ld + c] = Lw[tri(k0 + r) + k0 + c];
    __syncthreads();
    for (int c = 0; c < wd; ++c) {
      const double d = P[static_cast<long long>(c) * ld + c];
      if (!(d > 0.0)) {                // every thread reads the same pivot
        certified = false;
        break;
      }
      const double inv = 1.0 / d;
      for (int r = c + 1 + ty; r < m; r += WARPS) {
        double* Pr = P + static_cast<long long>(r) * ld;
        const double lrc = Pr[c] * inv;
        for (int c2 = c + 1 + tx; c2 < wd && c2 <= r; c2 += 32)
          Pr[c2] = fma(-lrc, P[static_cast<long long>(c2) * ld + c], Pr[c2]);
      }
      if (tid == 0) invd[c] = inv;
      __syncthreads();
    }
    if (!certified) break;
    for (int i = k0 + wd + ty; i < na; i += WARPS) {
      const double* Pi = P + static_cast<long long>(i - k0) * ld;
      for (int j = k0 + wd + tx; j <= i; j += 32) {
        const double* Pj = P + static_cast<long long>(j - k0) * ld;
        double s = 0.0;
        for (int c = 0; c < wd; ++c) s = fma(Pi[c] * invd[c], Pj[c], s);
        Lw[tri(i) + j] -= s;
      }
    }
    __syncthreads();
  }

  // ---- (b2) otherwise the clip by cyclic Jacobi on the active block -------
  int sweeps = 0, rotations = 0, converged = 1, cnt = 0;
  if (!certified) {
    // A (symmetric, kept exactly so) and V^T: in shared memory when they
    // fit, A alone when it does, the rest in the workspace
    const long long nna = static_cast<long long>(na) * na;
    const long long tb = static_cast<long long>(sizeof(T));
    const bool vt_sh = 2 * nna * tb <= region;
    T* A = nna * tb <= region ? reinterpret_cast<T*>(smem) : work;
    T* Vt = vt_sh ? reinterpret_cast<T*>(smem) + nna : work + nna;
    __syncthreads();                   // the factor's reads are done
    for (int i = ty; i < na; i += WARPS) {
      const long long ri = static_cast<long long>(act[i]) * n;
      for (int j = tx; j < na; j += 32) {
        A[static_cast<long long>(i) * na + j] = H[ri + act[j]];
        Vt[static_cast<long long>(i) * na + j] = i == j ? T(1) : T(0);
      }
    }
    __syncthreads();
    const T delta = static_cast<T>(Limits<T>::eps * fro / n);
    const int half = (na + 1) / 2, m = 2 * half;
    converged = 0;
    for (;;) {
      double big = 0.0;
      for (int i = ty; i < na; i += WARPS)
        for (int j = tx; j < na; j += 32)
          if (j != i)
            big = fmax(big, static_cast<double>(
                                fabs(A[static_cast<long long>(i) * na + j])));
      big = block_max(big, red);
      if (!(big > static_cast<double>(delta))) {
        converged = big == big;        // false for a NaN
        break;
      }
      if (sweeps == max_sweeps) break;
      ++sweeps;
      for (int r = 0; r < m - 1; ++r) {
        // the round's pair table and rotations, one thread per pair
        int rot = 0;
        for (int t = tid; t < half; t += THREADS) {
          int p, q;
          rr_pair(m, r, t, p, q);
          T c = T(1), s = T(0), dp = T(0), dq = T(0);
          if (q < na) {
            const T apq = A[static_cast<long long>(p) * na + q];
            if (fabs(apq) > delta) {
              const T app = A[static_cast<long long>(p) * na + p];
              const T aqq = A[static_cast<long long>(q) * na + q];
              const T theta = (aqq - app) / (T(2) * apq);
              const T at = fabs(theta);
              const T tq = (theta >= T(0) ? T(1) : T(-1))
                           / (at + sqrt(fma(theta, theta, T(1))));
              c = T(1) / sqrt(fma(tq, tq, T(1)));
              s = tq * c;
              dp = app - tq * apq;
              dq = aqq + tq * apq;
            }
          }
          pp[t] = p;
          qq[t] = q;
          cs[t] = c;
          sn[t] = s;
          dpv[t] = dp;
          dqv[t] = dq;
          rot |= s != T(0);
        }
        if (!__syncthreads_or(rot)) continue;
        // A <- J^T A J one 2 x 2 block (pairs t <= u) per thread, written
        // with its mirror: rows by t's rotation, then columns by u's; a
        // rotated pair's own block set exactly
        for (int t = ty; t < half; t += WARPS) {
          const T ct = cs[t], st = sn[t];
          const int p = pp[t], q = qq[t];
          for (int u = t + tx; u < half; u += 32) {
            const T su = sn[u];
            if (st == T(0) && su == T(0)) continue;
            const int p2 = pp[u], q2 = qq[u];
            if (u == t) {
              if (q < na) {
                A[static_cast<long long>(p) * na + q] = T(0);
                A[static_cast<long long>(q) * na + p] = T(0);
                A[static_cast<long long>(p) * na + p] = dpv[t];
                A[static_cast<long long>(q) * na + q] = dqv[t];
              }
              continue;
            }
            const T cu = cs[u];
            const bool hq = q < na, hq2 = q2 < na;
            T* Ap = A + static_cast<long long>(p) * na;
            T* Aq = A + static_cast<long long>(q) * na;
            const T a = Ap[p2], b = hq2 ? Ap[q2] : T(0);
            const T d = hq ? Aq[p2] : T(0);
            const T e = hq && hq2 ? Aq[q2] : T(0);
            const T a1 = ct * a - st * d, b1 = ct * b - st * e;
            const T d1 = st * a + ct * d, e1 = st * b + ct * e;
            const T npp = cu * a1 - su * b1, npq = su * a1 + cu * b1;
            const T nqp = cu * d1 - su * e1, nqq = su * d1 + cu * e1;
            T* Ap2 = A + static_cast<long long>(p2) * na;
            T* Aq2 = A + static_cast<long long>(q2) * na;
            Ap[p2] = npp;
            Ap2[p] = npp;
            if (hq2) {
              Ap[q2] = npq;
              Aq2[p] = npq;
            }
            if (hq) {
              Aq[p2] = nqp;
              Ap2[q] = nqp;
            }
            if (hq && hq2) {
              Aq[q2] = nqq;
              Aq2[q] = nqq;
            }
          }
        }
        // V <- V J: rows p and q of V^T, a warp per pair
        for (int t = warp; t < half; t += WARPS) {
          const T s = sn[t];
          if (s == T(0)) continue;
          const T c = cs[t];
          T* Vp = Vt + static_cast<long long>(pp[t]) * na;
          T* Vq = Vt + static_cast<long long>(qq[t]) * na;
          if (vt_sh)
            rot_rows<1>(Vp, Vq, na, c, s, lane);
          else
            rot_rows<JB>(Vp, Vq, na, c, s, lane);
          if (lane == 0) ++rotations;
        }
        __syncthreads();
      }
    }

    // ---- H <- H - sum over negative eigenvalues of l v v^T --------------
    for (int i = tid; i < na; i += THREADS)
      flag[i] = A[static_cast<long long>(i) * na + i] < T(0);
    __syncthreads();
    gather(flag, na, idx, ctl, 3);
    __syncthreads();
    cnt = ctl[3];
    for (int i = ty; i < na; i += WARPS) {
      const long long ri = static_cast<long long>(act[i]) * n;
      for (int j = tx; j < na; j += 32) {
        T s = T(0);
        for (int u = 0; u < cnt; ++u) {
          const long long c = idx[u];
          s = fma(Vt[c * na + i] * Vt[c * na + j], A[c * na + c], s);
        }
        const T h = H[ri + act[j]] - s;
        H[ri + act[j]] = h;
        bad |= !isfinite(h);
      }
    }
  }

  bad = __syncthreads_or(bad);
  const double rot_total = block_sum(static_cast<double>(rotations), red);
  if (tid == 0) {
    info[0] = converged && !bad;
    info[1] = sweeps;
    info[2] = cnt;
    info[3] = k;
    info[4] = static_cast<int>(rot_total);
    info[5] = certified ? 1 : 0;
  }
}

template <typename T>
int launch(const void* S, const void* rhs, const void* pd, int n, double eps,
           int max_sweeps, void* work, void* H, void* g, void* info,
           void* stream) {
  if (n < 0 || max_sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // the region holds the certificate's f64 panel (n x 33 and the pivots'
  // reciprocals) or A and V: as much as the card gives a block, up to
  // what n needs
  const long long tail = tail_bytes(n, sizeof(T));
  const long long need_av = 2LL * n * n * static_cast<long long>(sizeof(T));
  const long long need_cert = (33LL * n + 32) * 8;
  long long region = (need_av > need_cert ? need_av : need_cert);
  region = (region + 15) / 16 * 16;
  if (tail + region > optin) region = (optin - tail) / 16 * 16;
  if (region < 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = tail + region;
  cudaFuncSetAttribute(marginalize_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  marginalize_kernel<T><<<1, THREADS, static_cast<size_t>(bytes),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(S), static_cast<const T*>(rhs),
      static_cast<const unsigned char*>(pd), n, static_cast<T>(eps),
      max_sweeps, region, static_cast<T*>(work),
      static_cast<T*>(H), static_cast<T*>(g), static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the workspace holds 3 n^2 elements: the k x 2k Gauss-Jordan block and
// S_:d X, then the certificate's f64 triangle, then A and V, the last two
// where they do not fit in shared memory
int ba_marginalize_f32(const void* S, const void* rhs, const void* pd, int n,
                       double eps, int max_sweeps, void* work, void* H,
                       void* g, void* info, void* stream) {
  return launch<float>(S, rhs, pd, n, eps, max_sweeps, work, H, g, info,
                       stream);
}

int ba_marginalize_f64(const void* S, const void* rhs, const void* pd, int n,
                       double eps, int max_sweeps, void* work, void* H,
                       void* g, void* info, void* stream) {
  return launch<double>(S, rhs, pd, n, eps, max_sweeps, work, H, g, info,
                        stream);
}

}  // extern "C"
