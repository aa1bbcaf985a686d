// Block-level dense routines of K8's sequential scan (chunk_factor.cu's
// scan_factor, chunk_solve.cu's scan_solve), and the shared-memory
// grants of every K8 kernel.  Every routine is called by all
// THREADS threads of one block and works on row-major matrices through
// generic pointers, with panels and tiles of TS rows passing through shared
// memory.  The kernels hold a matrix they update in shared memory when it
// fits (smem_if_fits: an f32 block at the long trajectory's n = 216 is
// 186,624 B) and in the L2-resident device workspace otherwise (in f64 it
// is 373,248 B), so any n works.
//
// Products are plain FMA in the working type (ba_tpu asks for
// Precision.HIGHEST there; no tensor core, so TF32 never enters).  Every
// sum runs in a fixed order, so two launches are bit-identical.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace chunk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 32;  // tile side, panel width

// element (i, j) of a matrix in device memory: p[i * ld + j], or p[j * ld +
// i] when trans
template <typename T>
struct Mat {
  const T* p;
  long long ld;
  bool trans;
};

template <typename T>
struct Tiles {
  T a[TS][TS + 1];
  T b[TS][TS + 1];
  T rd[TS];  // reciprocals of a panel's pivots
};

__device__ __forceinline__ bool bad(float v) { return !isfinite(v); }
__device__ __forceinline__ bool bad(double v) { return !isfinite(v); }

// s[y][x] = M(r0 + y, c0 + x) for y < rows, x < cols, 0 elsewhere; the
// loads run along M's contiguous dimension
template <typename T>
__device__ void load_tile(T (*s)[TS + 1], Mat<T> m, int r0, int c0, int rows,
                          int cols) {
  for (int e = threadIdx.x; e < TS * TS; e += THREADS) {
    const int u = e / TS, v = e - u * TS;  // v runs along memory
    const int y = m.trans ? v : u, x = m.trans ? u : v;
    T val = T(0);
    if (y < rows && x < cols)
      val = m.trans ? m.p[static_cast<long long>(c0 + x) * m.ld + r0 + y]
                    : m.p[static_cast<long long>(r0 + y) * m.ld + c0 + x];
    s[y][x] = val;
  }
}

constexpr int Q = TS / WARPS;  // outputs of a tile per thread

// acc[q] += sum_{t < kk} A(r0 + ty + WARPS q, t) B(t, c0 + tx) over an
// mr x nc matrix product (rows and columns past them read as zero), the
// tiles of A and B passing through shared memory; the sum runs over t in
// order (a tile's padding adds exact zeros)
template <typename T>
__device__ void tile_acc(T (&acc)[Q], Mat<T> A, Mat<T> B, int r0, int c0,
                         int mr, int nc, int kk, Tiles<T>& sm) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int t0 = 0; t0 < kk; t0 += TS) {
    const int tk = min(TS, kk - t0);
    load_tile(sm.a, A, r0, t0, mr - r0, tk);
    load_tile(sm.b, B, t0, c0, tk, nc - c0);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      const T bv = sm.b[t][tx];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        acc[q] = fma(sm.a[ty + WARPS * q][t], bv, acc[q]);
    }
    __syncthreads();
  }
}

// C(i, j) -= sum_{t < kk} A(i, t) B(t, j) for i < mr, j < nc (j <= i only
// when lower), one 32 x 32 tile of C at a time; the tile's sum runs over t
// in order, then is subtracted once
template <typename T>
__device__ void gemm_sub(T* C, long long ldc, int mr, int nc, Mat<T> A,
                         Mat<T> B, int kk, bool lower, Tiles<T>& sm) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tm = (mr + TS - 1) / TS, tn = (nc + TS - 1) / TS;
  for (int tile = 0; tile < tm * tn; ++tile) {
    const int ti = tile / tn, tj = tile - ti * tn;
    if (lower && tj > ti) continue;  // uniform over the block
    const int r0 = ti * TS, c0 = tj * TS;
    T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = T(0);
    tile_acc(acc, A, B, r0, c0, mr, nc, kk, sm);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = r0 + ty + WARPS * q, j = c0 + tx;
      if (i < mr && j < nc && (!lower || j <= i))
        C[static_cast<long long>(i) * ldc + j] -= acc[q];
    }
  }
  __syncthreads();
}

// Solve the panel's triangle L11 (nb x nb, in shared memory, zero past nb;
// its pivots' reciprocals in rd) for `count` vectors, one per thread held
// in registers: vector c has its element j at X[j * sj + c * sc].  trans
// false: v <- L11^-1 v; true: v <- L11^-T v.  Right-looking: once v_j is
// final every later entry takes its update, so the dependent chain is nb
// products, not nb^2 / 2; L11 is read through a volatile pointer, one
// entry per update, so the unrolled loops keep 32 values live and no more
template <bool trans, typename T>
__device__ void panel_solve(T (*L11)[TS + 1], const T* rd, int nb, T* X,
                            long long sj, long long sc, int count,
                            int* fail) {
  const volatile T* L = &L11[0][0];
  for (int c = threadIdx.x; c < count; c += THREADS) {
    T* x = X + c * sc;
    T v[TS];
#pragma unroll
    for (int j = 0; j < TS; ++j) v[j] = j < nb ? x[j * sj] : T(0);
#pragma unroll
    for (int u = 0; u < TS; ++u) {
      const int j = trans ? TS - 1 - u : u;
      v[j] *= j < nb ? rd[j] : T(0);
      if constexpr (!trans) {
#pragma unroll
        for (int k = j + 1; k < TS; ++k) v[k] -= L[k * (TS + 1) + j] * v[j];
      } else {
#pragma unroll
        for (int k = 0; k < j; ++k) v[k] -= L[j * (TS + 1) + k] * v[j];
      }
    }
    bool nonfinite = false;
#pragma unroll
    for (int j = 0; j < TS; ++j)
      if (j < nb) {
        x[j * sj] = v[j];
        nonfinite |= bad(v[j]);
      }
    if (fail != nullptr && nonfinite) *fail = 1;
  }
}

// rd[j] = 1 / L11[j][j] for j < nb (the caller synchronizes after)
template <typename T>
__device__ void pivots(T (*L11)[TS + 1], T* rd, int nb) {
  if (threadIdx.x < nb) rd[threadIdx.x] = T(1) / L11[threadIdx.x][threadIdx.x];
}

// The lower Cholesky factor of the nb x nb tile S (its lower triangle
// read), in place, by the block with one barrier a column: after it every
// thread reads the pivot and scales by its reciprocal the two column
// entries it needs, thread (warp w, lane l) updating row l at columns j +
// 1 + w + 8 q; warp 0 writes the scaled column one step later, when no
// thread reads it any more
template <typename T>
__device__ void diag_chol(T (*S)[TS + 1], int nb, int* fail) {
  const int i = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T prev_l = T(0), prev_s = T(0);
  for (int j = 0; j < nb; ++j) {
    __syncthreads();
    const T d = S[j][j];
    const T s = sqrt(d);
    const T rs = T(1) / s;
    if (warp == 0 && j > 0) {
      if (i >= j && i < nb) S[i][j - 1] = prev_l;
      if (i == 0) S[j - 1][j - 1] = prev_s;
    }
    T li = T(0);
    if (i > j && i < nb) {
      li = S[i][j] * rs;
      for (int k = j + 1 + warp; k <= i; k += WARPS)
        S[i][k] -= li * (S[k][j] * rs);
    }
    if (warp == 0) {
      if ((i == 0 && (!(d > T(0)) || bad(d))) || bad(li)) *fail = 1;
      prev_l = li;
      prev_s = s;
    }
  }
  __syncthreads();
  if (warp == 0 && i == 0 && nb > 0) S[nb - 1][nb - 1] = prev_s;
  __syncthreads();
}

// In-place lower Cholesky factor of the n x n A (its lower triangle read,
// its strict upper triangle zeroed), right-looking by panels of TS
// columns: the diagonal tile factorized in shared memory, the rows below
// it solved against it one row per thread, the trailing lower triangle
// updated tile by tile.  A non-positive or non-finite pivot, or a
// non-finite entry, sets *fail (no host read; the factor goes on).
template <typename T>
__device__ void chol(T* A, int n, Tiles<T>& sm, int* fail) {
  const int tid = threadIdx.x;
  for (int j0 = 0; j0 < n; j0 += TS) {
    const int nb = min(TS, n - j0);
    T* A11 = A + static_cast<long long>(j0) * n + j0;
    load_tile(sm.a, Mat<T>{A11, n, false}, 0, 0, nb, nb);
    __syncthreads();
    diag_chol(sm.a, nb, fail);
    pivots(sm.a, sm.rd, nb);
    for (int e = tid; e < nb * nb; e += THREADS) {
      const int i = e / nb, k = e - i * nb;
      if (k <= i) A11[static_cast<long long>(i) * n + k] = sm.a[i][k];
    }
    __syncthreads();
    // L21 = A21 L11^-T, one row per thread
    panel_solve<false>(sm.a, sm.rd, nb,
                       A + static_cast<long long>(j0 + nb) * n + j0, 1LL,
                       static_cast<long long>(n), n - j0 - nb, fail);
    __syncthreads();
    // A22 -= L21 L21^T, lower triangle
    const int r1 = j0 + nb;
    if (r1 < n) {
      const T* L21 = A + static_cast<long long>(r1) * n + j0;
      gemm_sub(A + static_cast<long long>(r1) * n + r1, n, n - r1, n - r1,
               Mat<T>{L21, n, false}, Mat<T>{L21, n, true}, nb, true, sm);
    }
  }
  for (long long e = tid; e < static_cast<long long>(n) * n; e += THREADS) {
    const long long i = e / n, k = e - i * n;
    if (k > i) A[e] = T(0);
  }
  __syncthreads();
}

// X <- L^-1 X (trans false) or L^-T X (trans true) for the n x n lower
// factor L and the n x ncols X (row stride ldx), by panels of TS rows:
// each panel's triangle solved one column per thread against the tile in
// shared memory, the rest of X updated by gemm_sub
template <bool trans, typename T>
__device__ void trsm(const T* L, int n, T* X, long long ldx, int ncols,
                     Tiles<T>& sm) {
  const int np = (n + TS - 1) / TS;
  for (int pi = 0; pi < np; ++pi) {
    const int j0 = (trans ? np - 1 - pi : pi) * TS;
    const int nb = min(TS, n - j0);
    load_tile(sm.a, Mat<T>{L + static_cast<long long>(j0) * n + j0, n,
                           false}, 0, 0, nb, nb);
    __syncthreads();
    pivots(sm.a, sm.rd, nb);
    __syncthreads();
    T* Xp = X + static_cast<long long>(j0) * ldx;
    panel_solve<trans>(sm.a, sm.rd, nb, Xp, ldx, 1LL, ncols,
                       static_cast<int*>(nullptr));
    __syncthreads();
    if (!trans && j0 + nb < n) {
      // rows below: X2 -= L21 X1
      gemm_sub(X + static_cast<long long>(j0 + nb) * ldx, ldx, n - j0 - nb,
               ncols, Mat<T>{L + static_cast<long long>(j0 + nb) * n + j0,
                             n, false},
               Mat<T>{Xp, ldx, false}, nb, false, sm);
    } else if (trans && j0 > 0) {
      // rows above: X0 -= L10^T X1, L10 = L[j0:j0+nb, 0:j0]
      gemm_sub(X, ldx, j0, ncols,
               Mat<T>{L + static_cast<long long>(j0) * n, n, true},
               Mat<T>{Xp, ldx, false}, nb, false, sm);
    }
  }
}

// x <- L^-1 x (trans false) or L^-T x (trans true) for a vector x (n) in
// shared memory, right-looking by panels of TS rows: warp 0 solves the
// panel's triangle (lane l holds row l; each solved entry is broadcast by a
// shuffle), then every thread takes one remaining row and subtracts the
// panel's part (32 independent loads in flight), while the next panel's
// triangle is loaded.  Two barriers per panel.
template <typename T>
__device__ void trsv_any(const T* L, int n, T* x, bool trans, Tiles<T>& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = (n + TS - 1) / TS;
  auto diag = [&](int pi) {
    const int j0 = pi * TS;
    load_tile(sm.a, Mat<T>{L + static_cast<long long>(j0) * n + j0, n,
                           false}, 0, 0, min(TS, n - j0), min(TS, n - j0));
  };
  diag(trans ? np - 1 : 0);
  __syncthreads();
  for (int step = 0; step < np; ++step) {
    const int pi = trans ? np - 1 - step : step;
    const int j0 = pi * TS, nb = min(TS, n - j0);
    if (warp == 0) {
      // each lane's reciprocal of its pivot first, so the chain of nb
      // steps holds no division
      T v = T(0), rinv = T(0);
      if (lane < nb) {
        v = x[j0 + lane];
        rinv = T(1) / sm.a[lane][lane];
      }
      if (!trans) {
        for (int t = 0; t < nb; ++t) {
          if (lane == t) v *= rinv;
          const T xt = __shfl_sync(0xffffffffu, v, t);
          if (lane > t && lane < nb) v -= sm.a[lane][t] * xt;
        }
      } else {
        for (int t = nb - 1; t >= 0; --t) {
          if (lane == t) v *= rinv;
          const T xt = __shfl_sync(0xffffffffu, v, t);
          if (lane < t) v -= sm.a[t][lane] * xt;
        }
      }
      if (lane < nb) x[j0 + lane] = v;
    }
    __syncthreads();
    if (step + 1 < np) diag(trans ? pi - 1 : pi + 1);
    const int lo = trans ? 0 : j0 + nb, hi = trans ? j0 : n;
    for (int i = lo + tid; i < hi; i += THREADS) {
      T s = T(0);
      if (!trans) {
        const T* row = L + static_cast<long long>(i) * n + j0;
#pragma unroll 8
        for (int t = 0; t < nb; ++t) s = fma(row[t], x[j0 + t], s);
      } else {
        const T* col = L + static_cast<long long>(j0) * n + i;
#pragma unroll 8
        for (int t = 0; t < nb; ++t)
          s = fma(col[static_cast<long long>(t) * n], x[j0 + t], s);
      }
      x[i] -= s;
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void trsv(const T* L, int n, T* x, Tiles<T>& sm) {
  trsv_any(L, n, x, false, sm);
}

template <typename T>
__device__ void trsv_t(const T* L, int n, T* x, Tiles<T>& sm) {
  trsv_any(L, n, x, true, sm);
}

// y = M x (trans false) or y = M^T x (trans true), x and y (n) in shared
// memory: one thread per output, its loads independent (along M's row, or
// across the threads along M's rows)
template <typename T>
__device__ void gemv(const T* M, int n, bool trans, const T* x, T* y) {
  for (int j = threadIdx.x; j < n; j += THREADS) {
    T s = T(0);
    if (trans) {
#pragma unroll 8
      for (int t = 0; t < n; ++t)
        s = fma(M[static_cast<long long>(t) * n + j], x[t], s);
    } else {
      const T* row = M + static_cast<long long>(j) * n;
#pragma unroll 8
      for (int t = 0; t < n; ++t) s = fma(row[t], x[t], s);
    }
    y[j] = s;
  }
  __syncthreads();
}

// Whether `kernel` may take `bytes` of dynamic shared memory beside
// `static_bytes` of static on the current device, granting them when it
// may.  The device's opt-in limit is looked up once per device, and a
// kernel's attribute is set only when a launch needs more than it was
// granted there before, so a steady run of launches makes neither call.
inline bool reserve_smem(const void* kernel, long long bytes,
                         long long static_bytes) {
  static std::mutex mu;
  static std::map<int, int> optin;
  static std::map<std::pair<const void*, int>, long long> granted;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  std::lock_guard<std::mutex> lock(mu);
  auto lim = optin.find(dev);
  if (lim == optin.end()) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    lim = optin.emplace(dev, v).first;
  }
  if (bytes + static_bytes > lim->second) return false;
  long long& g = granted[{kernel, dev}];
  if (g < bytes) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess)
      return false;
    g = bytes;
  }
  return true;
}

// `bytes` of dynamic shared memory beside the static tiles when they fit
// in a block, else 0: the caller then keeps that operand in device memory
template <typename T, typename K>
inline long long smem_if_fits(K kernel, long long bytes) {
  return reserve_smem(reinterpret_cast<const void*>(kernel), bytes,
                      sizeof(Tiles<T>))
             ? bytes
             : 0;
}

// `bytes` of dynamic shared memory the launch cannot do without: 0, or
// cudaErrorInvalidValue when they do not fit
template <typename K>
inline int allow_smem(K kernel, long long bytes) {
  return reserve_smem(reinterpret_cast<const void*>(kernel), bytes,
                      sizeof(Tiles<double>))
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace chunk
