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
// Design: one block of 1024 threads, no host read.  (b) is the cyclic
// Jacobi method in round-robin (Brent-Luk) order: n/2 disjoint pairs per
// round, n - 1 rounds per sweep, so each round is a row pass and a column
// pass over A and V that no two threads share.  A pair rotates when
// |a_pq| > delta = eps_machine ||H||_F / n (its 2 x 2 block then set
// exactly: a_pq = 0, a_pp - t a_pq, a_qq + t a_pq); a sweep starts only
// while some off-diagonal element exceeds delta (the stop test, read on
// the device), at most max_sweeps.  A and V live in shared memory when
// 2 n^2 elements fit (n <= 168 in f32, n <= 119 in f64), otherwise in the
// L2-resident workspace.  info = {converged and finite, sweeps, clipped
// eigenvalues, k, rotations}; the solve never reads it.  Every sum runs in
// a fixed order, so two launches are bit-identical.
//
// Bound on an H100: operations.  A rotation costs ~12 n flops (the
// symmetric A and V); a sweep n (n - 1) / 2 rotations, ~6 n^3: at n = 90
// a few sweeps are a few MFLOP, well under a microsecond at 67 TFLOP/s.
// One block runs it, so its time is the rounds' latency (4 barriers each).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr float eps = 1.1920929e-7f;
};
template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
};

// pair t of round r of the circle schedule over m (even) indices: slot 0
// holds index 0, slot i >= 1 holds 1 + (i - 1 + r) mod (m - 1); pair t
// joins slots t and m - 1 - t
__device__ __forceinline__ void rr_pair(int m, int r, int t, int& p, int& q) {
  const int a = t == 0 ? 0 : 1 + (t - 1 + r) % (m - 1);
  const int s = m - 1 - t;
  const int b = s == 0 ? 0 : 1 + (s - 1 + r) % (m - 1);
  p = a < b ? a : b;
  q = a < b ? b : a;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T tot = T(0);
  for (int w = 0; w < THREADS / 32; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

template <typename T>
__device__ T block_max(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = red[0];
  for (int w = 1; w < THREADS / 32; ++w) m = fmax(m, red[w]);
  __syncthreads();
  return m;
}

// shared-memory layout: [A, V if in shared] cs sn dp dq (n/2 + 1 each)
// w (n) red (32) | idx (n) neg (n) ctl (8)
__host__ __device__ inline long long smem_bytes(int n, bool av, int size) {
  const long long half = (n + 1) / 2;
  const long long nt = (av ? 2LL * n * n : 0) + 4 * half + n + 32;
  return nt * size + (2LL * n + 8) * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    marginalize_kernel(const T* __restrict__ S, const T* __restrict__ rhs,
                       const unsigned char* __restrict__ pd, int n, T eps,
                       int max_sweeps, int av_shared, T* __restrict__ work,
                       T* __restrict__ H, T* __restrict__ g,
                       int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const int half = (n + 1) / 2, m = 2 * half;
  T* ts = reinterpret_cast<T*>(smem);
  T* A = av_shared ? ts : work;
  T* V = A + nn;
  T* tail = ts + (av_shared ? 2 * nn : 0);
  T* cs = tail;
  T* sn = cs + half;
  T* dp = sn + half;
  T* dq = dp + half;
  T* w = dq + half;
  T* red = w + n;
  int* idx = reinterpret_cast<int*>(red + 32);
  int* neg = idx + n;
  int* ctl = neg + n;

  // ---- (a) the departing dims' Schur complement --------------------------
  if (tid == 0) {
    int k = 0;
    for (int i = 0; i < n; ++i)
      if (pd[i]) idx[k++] = i;
    ctl[0] = k;
  }
  __syncthreads();
  const int k = ctl[0], k2 = 2 * k;
  T* aug = work;                       // [S_dd + eps I | I], k x 2k
  T* Z = work + 2 * nn;                // S_:d X, n x k
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
  for (long long e = tid; e < static_cast<long long>(n) * k; e += THREADS) {
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
  __syncthreads();
  for (long long e = tid; e < nn; e += THREADS) {
    const int i = static_cast<int>(e / n), j = static_cast<int>(e - i * n);
    if (pd[i] || pd[j]) {
      H[e] = T(0);
      continue;
    }
    T hij = T(0), hji = T(0);
    for (int b = 0; b < k; ++b) {
      hij = fma(Z[static_cast<long long>(i) * k + b],
                S[static_cast<long long>(j) * n + idx[b]], hij);
      hji = fma(Z[static_cast<long long>(j) * k + b],
                S[static_cast<long long>(i) * n + idx[b]], hji);
    }
    H[e] = T(0.5) * ((S[e] - hij) + (S[static_cast<long long>(j) * n + i]
                                     - hji));
  }
  for (int i = tid; i < n; i += THREADS) {
    T s = T(0);
    for (int a = 0; a < k; ++a)
      s = fma(S[static_cast<long long>(i) * n + idx[a]], w[a], s);
    g[i] = pd[i] ? T(0) : rhs[i] - s;
  }
  __syncthreads();

  // ---- (b) the PSD projection by cyclic Jacobi --------------------------
  T part = T(0);
  for (long long e = tid; e < nn; e += THREADS) {
    const T h = H[e];
    A[e] = h;
    const int i = static_cast<int>(e / n);
    V[e] = (e - static_cast<long long>(i) * n == i) ? T(1) : T(0);
    part = fma(h, h, part);
  }
  const T delta = Limits<T>::eps * sqrt(block_sum(part, red)) / T(n);
  int sweeps = 0, rotations = 0, converged = 0;
  for (;;) {
    T big = T(0);
    for (long long e = tid; e < nn; e += THREADS) {
      const int i = static_cast<int>(e / n);
      if (e - static_cast<long long>(i) * n != i) big = fmax(big, fabs(A[e]));
    }
    big = block_max(big, red);
    if (!(big > delta)) {
      converged = big == big;          // false for a NaN
      break;
    }
    if (sweeps == max_sweeps) break;
    ++sweeps;
    for (int r = 0; r < m - 1; ++r) {
      int rot = 0;
      for (int t = tid; t < half; t += THREADS) {
        int p, q;
        rr_pair(m, r, t, p, q);
        T c = T(1), s = T(0);
        if (q < n) {
          const T apq = A[p * n + q];
          if (fabs(apq) > delta) {
            const T app = A[p * n + p], aqq = A[q * n + q];
            const T theta = (aqq - app) / (T(2) * apq);
            const T at = fabs(theta);
            const T tq = (theta >= T(0) ? T(1) : T(-1))
                         / (at + sqrt(fma(theta, theta, T(1))));
            c = T(1) / sqrt(fma(tq, tq, T(1)));
            s = tq * c;
            dp[t] = app - tq * apq;
            dq[t] = aqq + tq * apq;
            rot = 1;
          }
        }
        cs[t] = c;
        sn[t] = s;
      }
      if (!__syncthreads_or(rot)) continue;
      // rows p and q of A
      for (int e = tid; e < half * n; e += THREADS) {
        const int t = e / n, j = e - t * n;
        const T s = sn[t];
        if (s == T(0)) continue;
        const T c = cs[t];
        int p, q;
        rr_pair(m, r, t, p, q);
        const T x = A[p * n + j], y = A[q * n + j];
        A[p * n + j] = c * x - s * y;
        A[q * n + j] = s * x + c * y;
      }
      __syncthreads();
      // columns p and q of A and V
      for (int e = tid; e < half * n; e += THREADS) {
        const int i = e / half, t = e - i * half;
        const T s = sn[t];
        if (s == T(0)) continue;
        const T c = cs[t];
        int p, q;
        rr_pair(m, r, t, p, q);
        T x = A[i * n + p], y = A[i * n + q];
        A[i * n + p] = c * x - s * y;
        A[i * n + q] = s * x + c * y;
        x = V[i * n + p];
        y = V[i * n + q];
        V[i * n + p] = c * x - s * y;
        V[i * n + q] = s * x + c * y;
      }
      __syncthreads();
      // each rotated pair's 2 x 2 block, exactly
      for (int t = tid; t < half; t += THREADS) {
        if (sn[t] == T(0)) continue;
        int p, q;
        rr_pair(m, r, t, p, q);
        A[p * n + q] = T(0);
        A[q * n + p] = T(0);
        A[p * n + p] = dp[t];
        A[q * n + q] = dq[t];
        ++rotations;
      }
      __syncthreads();
    }
  }

  // ---- H <- H - sum over negative eigenvalues of l v v^T ----------------
  if (tid == 0) {
    int cnt = 0;
    for (int i = 0; i < n; ++i)
      if (A[i * n + i] < T(0)) neg[cnt++] = i;
    ctl[2] = cnt;
  }
  __syncthreads();
  const int cnt = ctl[2];
  int bad = 0;
  for (long long e = tid; e < nn; e += THREADS) {
    const int i = static_cast<int>(e / n), j = static_cast<int>(e - i * n);
    T s = T(0);
    for (int u = 0; u < cnt; ++u) {
      const int c = neg[u];
      s = fma(V[i * n + c] * V[j * n + c], A[c * n + c], s);
    }
    const T h = H[e] - s;
    H[e] = h;
    bad |= !isfinite(h);
  }
  for (int i = tid; i < n; i += THREADS) bad |= !isfinite(g[i]);
  bad = __syncthreads_or(bad);
  const T rot_total = block_sum(static_cast<T>(rotations), red);
  if (tid == 0) {
    info[0] = converged && !bad;
    info[1] = sweeps;
    info[2] = cnt;
    info[3] = k;
    info[4] = static_cast<int>(rot_total);
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
  const bool av = smem_bytes(n, true, sizeof(T)) <= optin;
  const long long bytes = smem_bytes(n, av, sizeof(T));
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(marginalize_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  marginalize_kernel<T><<<1, THREADS, static_cast<size_t>(bytes),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(S), static_cast<const T*>(rhs),
      static_cast<const unsigned char*>(pd), n, static_cast<T>(eps),
      max_sweeps, av ? 1 : 0, static_cast<T*>(work), static_cast<T*>(H),
      static_cast<T*>(g), static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the workspace holds 3 n^2 elements: the k x 2k Gauss-Jordan block and
// S_:d X, then A and V when they do not fit in shared memory
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
