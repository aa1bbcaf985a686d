// K8c: x = S^-1 b through the factor of K8b (chunk_factor.cu), the
// preconditioner of the banded solver's PCG (5 solves per build).
//
// Replaces the TPU formulations ba_tpu/solver/banded.py:_bcr_solve
// (:369-396) and _solve_factored (:399-420): per level two batched
// triangular solves and four batched block products, each an XLA launch.
//
// b and x are (F, L) rows of one window each: chunk k of window f is
// elements [k n, (k + 1) n) of row f, and an element at or past `valid` of
// its row reads as zero (b) or is not written (x), so the banded solver's
// pad of each window to whole chunks and its cut back need no launch.
//
// Cyclic reduction on K8b's levels (Li, W, V) (Li_k = chol(Dodd_k)^-1, W_k
// = Li_k A_k^T, V_k = Li_k B_k) is mat-vecs only, two launches per level
// each way and two for the base:
//   down: t_k = Li_k b_{2k+1} (bcr_down_t), then b'_k = (b_2k - V_{k-1}^T
//         t_{k-1}) - W_k^T t_k (bcr_down_b);
//   base: x_0 = Li0^T (Li0 b_0) (bcr_down_t, bcr_up_x);
//   up:   y_k = (t_k - W_k x_k) - V_k x_{k+1} (bcr_up_y), then x_{2k+1} =
//         Li_k^T y_k and x_{2k} = x_k (bcr_up_x).
// A level's chunks past the factor's (padding, see chunk_factor.cu) are
// never read or written.  Each launch splits a chunk's rows over blocks,
// so a level of one chunk still runs ~27 (row products) or 7 (column
// products) blocks at n = 216: a row product (Li b, W x, V x) is one warp
// per row, lanes reading 16 B each along it, then an xor butterfly; a
// column product (V^T t, W^T t, Li^T y) is 8 threads x 16 B across a row
// and 32 rows at a time, summed through shared memory.  A triangular
// product stops at the diagonal.  Every sum runs in a fixed order, so two
// launches are bit-identical.
//
// Bound on an H100: bytes, each level's Li (its lower triangle), W and V
// read once (39.5 MB at the long trajectory in f32, 0.0118 ms at 3.35
// TB/s, chip_smoke.py's k8_work); down and up each read W and V, and Li
// twice, and the inner levels are launch latency.
//
// The scan: one launch forward (y_i = C_i^-1 (b_i - M_i y_{i-1})) and one
// backward (x_i = C_i^-T (y_i - M_{i+1}^T x_{i+1})), one block per window
// stepping through the chunks with chunk_blas.cuh's panel solves; the
// factor being solved with is staged in shared memory when it fits (f32
// at n = 216: 186,624 B) and read from device memory otherwise (f64).
#include "chunk_blas.cuh"

namespace {

using chunk::THREADS;
using chunk::Tiles;

// v[i] = row[k n + i] for k n + i < valid, else 0
template <typename T>
__device__ void load_chunk(const T* row, int k, int n, long long valid,
                           T* v) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const long long e = static_cast<long long>(k) * n + i;
    v[i] = e < valid ? row[e] : T(0);
  }
}

template <typename T>
__device__ void store_chunk(T* row, int k, int n, long long valid,
                            const T* v) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const long long e = static_cast<long long>(k) * n + i;
    if (e < valid) row[e] = v[i];
  }
}

// The factor L (n x n) copied to `buf` in shared memory when the launch
// gave room for it (in_smem), else read in place
template <typename T>
__device__ const T* stage(const T* L, int n, T* buf, int in_smem) {
  if (!in_smem) return L;
  for (long long e = threadIdx.x; e < static_cast<long long>(n) * n;
       e += THREADS)
    buf[e] = L[e];
  __syncthreads();
  return buf;
}

constexpr int SV_THREADS = 256;
constexpr int RB = SV_THREADS / 32;     // rows of a row-product block

// v[0..VW) = p[0..VW), one 16-byte load when VW > 1
template <int VW, typename T>
__device__ __forceinline__ void vload(const T* p, T (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = *p;
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}

// sum_{t < len} row[t] v[t] by one warp: lane l takes the vectors l, l +
// 32, ... (a vector reaching past len reads the row's zeros above a
// triangle's diagonal, or v's entries below n), then an xor butterfly
template <int VW, typename T>
__device__ T warp_dot(const T* row, const T* v, int len) {
  T s = T(0);
  for (int t = (threadIdx.x & 31) * VW; t < len; t += 32 * VW) {
    T r[VW];
    vload<VW>(row + t, r);
#pragma unroll
    for (int q = 0; q < VW; ++q) s = fma(r[q], v[t + q], s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T>
__device__ T at(const T* row, int c, int n, long long valid, int i) {
  const long long e = static_cast<long long>(c) * n + i;
  return e < valid ? row[e] : T(0);
}

// t[f, k] = Li[f, k] b_{off + 2k} for k < h = gridDim.y, rows g RB.. of
// block g: one warp per row, the sum stopping at the diagonal
template <typename T, int VW>
__global__ void __launch_bounds__(SV_THREADS)
    bcr_down_t(const T* __restrict__ Li, const T* __restrict__ b,
               long long b_ld, long long b_valid, int off, int n,
               T* __restrict__ t) {
  extern __shared__ __align__(16) unsigned char dyn[];
  T* v = reinterpret_cast<T*>(dyn);
  const int k = blockIdx.y, f = blockIdx.z, h = gridDim.y;
  for (int i = threadIdx.x; i < n; i += SV_THREADS)
    v[i] = at(b + f * b_ld, off + 2 * k, n, b_valid, i);
  __syncthreads();
  const int i = blockIdx.x * RB + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long ck = static_cast<long long>(f) * h + k;
  const T s = warp_dot<VW>(Li + (ck * n + i) * n, v, i + 1);
  if ((threadIdx.x & 31) == 0) t[ck * n + i] = s;
}

// b'[f, k] = (b_2k - V_{k-1}^T t_{k-1}) - W_k^T t_k for k < rn =
// gridDim.y (the first product for 1 <= k <= nv, the second for k < h),
// columns 8 VW g.. of block g: thread (u, c) sums rows u, u + 32, ... of
// its VW columns, then the 32 partials are summed in order
template <typename T, int VW>
__global__ void __launch_bounds__(SV_THREADS)
    bcr_down_b(const T* __restrict__ W, const T* __restrict__ V,
               const T* __restrict__ t, const T* __restrict__ b,
               long long b_ld, long long b_valid, int h, int nv, int n,
               T* __restrict__ bn) {
  __shared__ T red[2][32][8 * VW];
  extern __shared__ __align__(16) unsigned char dyn[];
  T* tp = reinterpret_cast<T*>(dyn);
  T* tk = tp + n;
  const int k = blockIdx.y, f = blockIdx.z, rn = gridDim.y;
  const bool has_v = k >= 1 && k <= nv, has_w = k < h;
  const long long nn = static_cast<long long>(n) * n;
  for (int i = threadIdx.x; i < n; i += SV_THREADS) {
    tp[i] = has_v ? t[(static_cast<long long>(f) * h + k - 1) * n + i] : T(0);
    tk[i] = has_w ? t[(static_cast<long long>(f) * h + k) * n + i] : T(0);
  }
  __syncthreads();
  const int u = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int c = blockIdx.x * 8 * VW + cg * VW;
  T p1[VW] = {}, p2[VW] = {};
  if (c < n) {
    const T* Vp = V + (static_cast<long long>(f) * nv + k - 1) * nn + c;
    const T* Wk = W + (static_cast<long long>(f) * h + k) * nn + c;
    for (int r = u; r < n; r += 32) {
      T m[VW];
      if (has_v) {
        vload<VW>(Vp + static_cast<long long>(r) * n, m);
#pragma unroll
        for (int q = 0; q < VW; ++q) p1[q] = fma(m[q], tp[r], p1[q]);
      }
      if (has_w) {
        vload<VW>(Wk + static_cast<long long>(r) * n, m);
#pragma unroll
        for (int q = 0; q < VW; ++q) p2[q] = fma(m[q], tk[r], p2[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < VW; ++q) {
    red[0][u][cg * VW + q] = p1[q];
    red[1][u][cg * VW + q] = p2[q];
  }
  __syncthreads();
  const int i = blockIdx.x * 8 * VW + threadIdx.x;
  if (threadIdx.x < 8 * VW && i < n) {
    T s1 = T(0), s2 = T(0);
    for (int w = 0; w < 32; ++w) {
      s1 += red[0][w][threadIdx.x];
      s2 += red[1][w][threadIdx.x];
    }
    bn[(static_cast<long long>(f) * rn + k) * n + i] =
        (at(b + f * b_ld, 2 * k, n, b_valid, i) - s1) - s2;
  }
}

// y[f, k] = (t_k - W_k x_k) - V_k x_{k+1} for k < h = gridDim.y (the
// second product for k < nv); x (F, rn, n) the next level's solution
template <typename T, int VW>
__global__ void __launch_bounds__(SV_THREADS)
    bcr_up_y(const T* __restrict__ W, const T* __restrict__ V,
             const T* __restrict__ t, const T* __restrict__ x, int nv,
             int rn, int n, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dyn[];
  T* xa = reinterpret_cast<T*>(dyn);
  T* xb = xa + n;
  const int k = blockIdx.y, f = blockIdx.z, h = gridDim.y;
  const bool has_v = k < nv;
  const T* xw = x + static_cast<long long>(f) * rn * n;
  for (int i = threadIdx.x; i < n; i += SV_THREADS) {
    xa[i] = xw[static_cast<long long>(k) * n + i];
    xb[i] = has_v ? xw[static_cast<long long>(k + 1) * n + i] : T(0);
  }
  __syncthreads();
  const int i = blockIdx.x * RB + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long nn = static_cast<long long>(n) * n;
  const long long ck = static_cast<long long>(f) * h + k;
  const T s1 = warp_dot<VW>(W + ck * nn + static_cast<long long>(i) * n, xa,
                            n);
  const T s2 = has_v ? warp_dot<VW>(V + (static_cast<long long>(f) * nv + k)
                                        * nn + static_cast<long long>(i) * n,
                                    xb, n)
                     : T(0);
  if ((threadIdx.x & 31) == 0) y[ck * n + i] = (t[ck * n + i] - s1) - s2;
}

// x_{off + 2k} = Li_k^T y_k for k < h (the sum from the diagonal down),
// and x_{2k} = xk_k for k < rn, columns 8 VW g.. of block g; x rows of
// stride x_ld, valid x_valid (the base: off 0, h 1, rn 0)
template <typename T, int VW>
__global__ void __launch_bounds__(SV_THREADS)
    bcr_up_x(const T* __restrict__ Li, const T* __restrict__ y,
             const T* __restrict__ xk, int off, int h, int rn, int n,
             T* __restrict__ x, long long x_ld, long long x_valid) {
  __shared__ T red[32][8 * VW];
  extern __shared__ __align__(16) unsigned char dyn[];
  T* yv = reinterpret_cast<T*>(dyn);
  const int k = blockIdx.y, f = blockIdx.z;
  const int c0 = blockIdx.x * 8 * VW;
  T* row = x + f * x_ld;
  if (k < rn)
    for (int i = c0 + threadIdx.x; i < min(n, c0 + 8 * VW);
         i += SV_THREADS) {
      const long long e = 2LL * k * n + i;
      if (e < x_valid)
        row[e] = xk[(static_cast<long long>(f) * rn + k) * n + i];
    }
  if (k >= h) return;
  const long long ck = static_cast<long long>(f) * h + k;
  for (int i = threadIdx.x; i < n; i += SV_THREADS) yv[i] = y[ck * n + i];
  __syncthreads();
  const int u = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int c = c0 + cg * VW;
  T p[VW] = {};
  if (c < n) {
    const T* L = Li + ck * n * n + c;
    for (int r = c0 + u; r < n; r += 32) {
      T m[VW];
      vload<VW>(L + static_cast<long long>(r) * n, m);
#pragma unroll
      for (int q = 0; q < VW; ++q) p[q] = fma(m[q], yv[r], p[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < VW; ++q) red[u][cg * VW + q] = p[q];
  __syncthreads();
  const int i = c0 + threadIdx.x;
  if (threadIdx.x < 8 * VW && i < n) {
    T s = T(0);
    for (int w = 0; w < 32; ++w) s += red[w][threadIdx.x];
    const long long e = static_cast<long long>(off + 2 * k) * n + i;
    if (e < x_valid) row[e] = s;
  }
}

// C, M (F, m, n, n); b rows -> y (F, m, n)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    scan_forward(const T* __restrict__ C, const T* __restrict__ M,
                 const T* __restrict__ b, long long b_ld, long long b_valid,
                 int m, int n, T* __restrict__ y, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* yp = reinterpret_cast<T*>(dyn);
  T* t = yp + n;
  T* v = t + n;
  const int f = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  for (int i = threadIdx.x; i < n; i += THREADS) yp[i] = T(0);
  for (int c = 0; c < m; ++c) {
    const long long blk = (static_cast<long long>(f) * m + c) * nn;
    load_chunk(b + f * b_ld, c, n, b_valid, v);
    __syncthreads();
    chunk::gemv(M + blk, n, false, yp, t);                  // M_i y_{i-1}
    for (int i = threadIdx.x; i < n; i += THREADS) v[i] = v[i] - t[i];
    __syncthreads();
    chunk::trsv(stage(C + blk, n, v + n, in_smem), n, v, sm);
    T* yc = y + (static_cast<long long>(f) * m + c) * n;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      yc[i] = v[i];
      yp[i] = v[i];
    }
    __syncthreads();
  }
}

// y (F, m, n) -> x rows of stride x_ld, valid x_valid
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    scan_backward(const T* __restrict__ C, const T* __restrict__ M,
                  const T* __restrict__ y, int m, int n, T* __restrict__ x,
                  long long x_ld, long long x_valid, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* xn = reinterpret_cast<T*>(dyn);
  T* t = xn + n;
  T* v = t + n;
  const int f = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  for (int c = m - 1; c >= 0; --c) {
    const T* yc = y + (static_cast<long long>(f) * m + c) * n;
    for (int i = threadIdx.x; i < n; i += THREADS) v[i] = yc[i];
    __syncthreads();
    if (c + 1 < m) {
      chunk::gemv(M + (static_cast<long long>(f) * m + c + 1) * nn, n, true,
                  xn, t);                                   // M_{i+1}^T x
      for (int i = threadIdx.x; i < n; i += THREADS) v[i] = v[i] - t[i];
      __syncthreads();
    }
    chunk::trsv_t(stage(C + (static_cast<long long>(f) * m + c) * nn, n,
                        v + n, in_smem), n, v, sm);
    store_chunk(x + f * x_ld, c, n, x_valid, v);
    for (int i = threadIdx.x; i < n; i += THREADS) xn[i] = v[i];
    __syncthreads();
  }
}

// dynamic shared memory: `vectors` vectors of n, then the factor being
// solved with (n x n) when it fits; in_smem says whether it does
template <typename T, typename K>
int prepare(K kernel, int vectors, int n, long long& bytes, int& in_smem) {
  const long long vec = static_cast<long long>(vectors) * n * sizeof(T);
  bytes = chunk::smem_if_fits<T>(
      kernel, vec + static_cast<long long>(n) * n * sizeof(T));
  in_smem = bytes > 0;
  if (in_smem) return 0;
  bytes = vec;
  return chunk::allow_smem(kernel, bytes);
}

// 16-byte vectors when a row's length allows them
template <typename T>
bool wide(int n) {
  return n % static_cast<int>(16 / sizeof(T)) == 0;
}

template <typename T, int VW>
int down_t_as(const void* Li, const void* b, long long b_ld,
              long long b_valid, int off, int h, int F, int n, void* t,
              void* stream) {
  bcr_down_t<T, VW><<<dim3((n + RB - 1) / RB, h, F), SV_THREADS,
                      n * sizeof(T), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Li), static_cast<const T*>(b), b_ld, b_valid,
      off, n, static_cast<T*>(t));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_down_t(const void* Li, const void* b, long long b_ld,
                  long long b_valid, int off, int h, int F, int n, void* t,
                  void* stream) {
  if (F < 1 || h < 1 || n < 1 || off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide<T>(n) ? down_t_as<T, 16 / sizeof(T)>(Li, b, b_ld, b_valid, off,
                                                   h, F, n, t, stream)
                    : down_t_as<T, 1>(Li, b, b_ld, b_valid, off, h, F, n, t,
                                      stream);
}

template <typename T, int VW>
int down_b_as(const void* W, const void* V, const void* t, const void* b,
              long long b_ld, long long b_valid, int h, int nv, int rn,
              int F, int n, void* bn, void* stream) {
  bcr_down_b<T, VW><<<dim3((n + 8 * VW - 1) / (8 * VW), rn, F), SV_THREADS,
                      2 * n * sizeof(T),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const T*>(V),
      static_cast<const T*>(t), static_cast<const T*>(b), b_ld, b_valid, h,
      nv, n, static_cast<T*>(bn));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_down_b(const void* W, const void* V, const void* t, const void* b,
                  long long b_ld, long long b_valid, int h, int nv, int rn,
                  int F, int n, void* bn, void* stream) {
  if (F < 1 || h < 1 || nv < 0 || rn < 1 || rn > h + 1 || nv > rn - 1 ||
      n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide<T>(n) ? down_b_as<T, 16 / sizeof(T)>(W, V, t, b, b_ld, b_valid,
                                                   h, nv, rn, F, n, bn,
                                                   stream)
                    : down_b_as<T, 1>(W, V, t, b, b_ld, b_valid, h, nv, rn,
                                      F, n, bn, stream);
}

template <typename T, int VW>
int up_y_as(const void* W, const void* V, const void* t, const void* x,
            int h, int nv, int rn, int F, int n, void* y, void* stream) {
  bcr_up_y<T, VW><<<dim3((n + RB - 1) / RB, h, F), SV_THREADS,
                    2 * n * sizeof(T), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const T*>(V),
      static_cast<const T*>(t), static_cast<const T*>(x), nv, rn, n,
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up_y(const void* W, const void* V, const void* t, const void* x,
                int h, int nv, int rn, int F, int n, void* y, void* stream) {
  if (F < 1 || h < 1 || nv < 0 || rn < h || rn > h + 1 || nv > rn - 1 ||
      n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide<T>(n) ? up_y_as<T, 16 / sizeof(T)>(W, V, t, x, h, nv, rn, F, n,
                                                 y, stream)
                    : up_y_as<T, 1>(W, V, t, x, h, nv, rn, F, n, y, stream);
}

template <typename T, int VW>
int up_x_as(const void* Li, const void* y, const void* xk, int off, int h,
            int rn, int F, int n, void* x, long long x_ld, long long x_valid,
            void* stream) {
  bcr_up_x<T, VW><<<dim3((n + 8 * VW - 1) / (8 * VW), max(h, rn), F),
                    SV_THREADS, n * sizeof(T),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Li), static_cast<const T*>(y),
      static_cast<const T*>(xk), off, h, rn, n, static_cast<T*>(x), x_ld,
      x_valid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up_x(const void* Li, const void* y, const void* xk, int off,
                int h, int rn, int F, int n, void* x, long long x_ld,
                long long x_valid, void* stream) {
  if (F < 1 || h < 1 || rn < 0 || n < 1 || off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide<T>(n) ? up_x_as<T, 16 / sizeof(T)>(Li, y, xk, off, h, rn, F, n,
                                                 x, x_ld, x_valid, stream)
                    : up_x_as<T, 1>(Li, y, xk, off, h, rn, F, n, x, x_ld,
                                    x_valid, stream);
}

template <typename T>
int launch_scan(const void* C, const void* M, const void* b, long long b_ld,
                long long b_valid, int F, int m, int n, void* y, void* x,
                long long x_ld, long long x_valid, void* stream) {
  if (F < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long bytes = 0;
  int in_smem = 0;
  if (int rc = prepare<T>(scan_forward<T>, 3, n, bytes, in_smem)) return rc;
  if (int rc = prepare<T>(scan_backward<T>, 3, n, bytes, in_smem))
    return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  scan_forward<T><<<F, THREADS, static_cast<size_t>(bytes), st>>>(
      static_cast<const T*>(C), static_cast<const T*>(M),
      static_cast<const T*>(b), b_ld, b_valid, m, n, static_cast<T*>(y),
      in_smem);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  scan_backward<T><<<F, THREADS, static_cast<size_t>(bytes), st>>>(
      static_cast<const T*>(C), static_cast<const T*>(M),
      static_cast<const T*>(y), m, n, static_cast<T*>(x), x_ld, x_valid,
      in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// t (F, h, n) = Li (F, h, n, n) times the chunks off + 2k of the b rows
int ba_bcr_down_t_f32(const void* Li, const void* b, long long b_ld,
                      long long b_valid, int off, int h, int F, int n,
                      void* t, void* stream) {
  return launch_down_t<float>(Li, b, b_ld, b_valid, off, h, F, n, t, stream);
}
int ba_bcr_down_t_f64(const void* Li, const void* b, long long b_ld,
                      long long b_valid, int off, int h, int F, int n,
                      void* t, void* stream) {
  return launch_down_t<double>(Li, b, b_ld, b_valid, off, h, F, n, t,
                               stream);
}

// bn (F, rn, n) from W (F, h, n, n), V (F, nv, n, n), t (F, h, n), b rows
int ba_bcr_down_b_f32(const void* W, const void* V, const void* t,
                      const void* b, long long b_ld, long long b_valid, int h,
                      int nv, int rn, int F, int n, void* bn, void* stream) {
  return launch_down_b<float>(W, V, t, b, b_ld, b_valid, h, nv, rn, F, n, bn,
                              stream);
}
int ba_bcr_down_b_f64(const void* W, const void* V, const void* t,
                      const void* b, long long b_ld, long long b_valid, int h,
                      int nv, int rn, int F, int n, void* bn, void* stream) {
  return launch_down_b<double>(W, V, t, b, b_ld, b_valid, h, nv, rn, F, n,
                               bn, stream);
}

// y (F, h, n) from W, V, t and the next level's x (F, rn, n)
int ba_bcr_up_y_f32(const void* W, const void* V, const void* t,
                    const void* x, int h, int nv, int rn, int F, int n,
                    void* y, void* stream) {
  return launch_up_y<float>(W, V, t, x, h, nv, rn, F, n, y, stream);
}
int ba_bcr_up_y_f64(const void* W, const void* V, const void* t,
                    const void* x, int h, int nv, int rn, int F, int n,
                    void* y, void* stream) {
  return launch_up_y<double>(W, V, t, x, h, nv, rn, F, n, y, stream);
}

// x rows: chunks off + 2k = Li_k^T y_k (k < h), chunks 2k = xk_k (k < rn)
int ba_bcr_up_x_f32(const void* Li, const void* y, const void* xk, int off,
                    int h, int rn, int F, int n, void* x, long long x_ld,
                    long long x_valid, void* stream) {
  return launch_up_x<float>(Li, y, xk, off, h, rn, F, n, x, x_ld, x_valid,
                            stream);
}
int ba_bcr_up_x_f64(const void* Li, const void* y, const void* xk, int off,
                    int h, int rn, int F, int n, void* x, long long x_ld,
                    long long x_valid, void* stream) {
  return launch_up_x<double>(Li, y, xk, off, h, rn, F, n, x, x_ld, x_valid,
                             stream);
}

// two launches (forward, backward); y: (F, m, n) workspace
int ba_scan_solve_f32(const void* C, const void* M, const void* b,
                      long long b_ld, long long b_valid, int F, int m, int n,
                      void* y, void* x, long long x_ld, long long x_valid,
                      void* stream) {
  return launch_scan<float>(C, M, b, b_ld, b_valid, F, m, n, y, x, x_ld,
                            x_valid, stream);
}
int ba_scan_solve_f64(const void* C, const void* M, const void* b,
                      long long b_ld, long long b_valid, int F, int m, int n,
                      void* y, void* x, long long x_ld, long long x_valid,
                      void* stream) {
  return launch_scan<double>(C, M, b, b_ld, b_valid, F, m, n, y, x, x_ld,
                             x_valid, stream);
}

}  // extern "C"
