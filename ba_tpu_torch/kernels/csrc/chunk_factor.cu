// K8b: the factor of the chunked block-tridiagonal system of the banded
// solver.  The system (F windows of m chunks, n x n blocks) is
//
//   E_{i-1}^T x_{i-1} + D_i x_i + E_i x_{i+1} = b_i,
//
// D (F, m, n, n) the diagonal chunk blocks, E (F, m, n, n) the coupling of
// each chunk to the next (chunk_layout.cu writes both).
//
// Replaces the TPU formulations ba_tpu/solver/banded.py:_bcr_factor
// (:307-366) and _factor (:270-293), batched Choleskys, triangular solves
// and products that XLA launches one by one (and that the port's library
// route ran as a chain of cuSOLVER and cuBLAS calls).
//
// Cyclic reduction, two launches per level plus one for the base block:
//   (1) bcr_eliminate, one block per (window, eliminated chunk k): c =
//       chol(D_{2k+1}) into the level's factor;
//   (2) bcr_reduce, one block per (32-column strip j, kept chunk k,
//       window): the strip's columns of X = Dodd_k^-1 A_k^T, Z = Dodd_k^-1
//       B_k (A = E_{2k}, B = E_{2k+1}) and Z_{k-1} by blocked triangular
//       solves, then the strip of D'_k = (D_{2k} - B_{k-1}^T Z_{k-1}) - A_k
//       X_k (the first term shifted by one chunk, zero at k = 0) and of
//       E'_k = -(A_k Z_k); the strips' solves are independent, so a level
//       of h chunks runs h n / 32 blocks (Z_{k-1}'s strip is solved again
//       by its own block, 1.5 x the solves for no wait);
//   (3) bcr_base: the last block's Cholesky.
// The scan (scan_factor) steps one block per window through the chunks
// with the same routines: X = C_{i-1}^-1 E_{i-1}, M_i = X^T, C_i =
// chol(D_i - X^T X).
//
// The routines (chunk_blas.cuh) pass panels and tiles of 32 through shared
// memory; the block a kernel factorizes (eliminate, base, the scan's X)
// and the reduce's n x 96 strip live in shared memory when they fit (f32
// at n = 216: 186,624 B and 82,944 B) and in device memory otherwise (f64
// at n = 216: 373,248 B), so any n works.  A non-positive or non-finite
// pivot or a non-finite factor entry sets fail[0] on the device, with no
// host read.
//
// Bound on an H100: operations (13.2 GFLOP at the long trajectory, P =
// 2,048, chunks of 24 poses, n = 216, 86 -> 128 chunks: 0.197 ms at 67
// TFLOP/s f32).  What the simple design leaves for later: the levels'
// parallelism shrinks from 64 Choleskys to 1 (F = 1), so the inner levels
// and the base run one Cholesky alone on a 132-SM card, a chain of 7
// panels of 32 dependent columns: those levels are latency, not
// operations.  An explicit inverse of Dodd (one more product) would turn
// the solves of the factor and of every K8c solve into products; the
// Cholesky itself could be split over several blocks.
#include "chunk_blas.cuh"

namespace {

using chunk::Mat;
using chunk::THREADS;
using chunk::Tiles;
using chunk::TS;

// c = chol(Din), factorized in shared memory `work` when given, else in
// place in c
template <typename T>
__device__ void factor_block(const T* Din, int n, T* c, T* work,
                             Tiles<T>& sm, int* fail) {
  const long long nn = static_cast<long long>(n) * n;
  T* A = work != nullptr ? work : c;
  for (long long e = threadIdx.x; e < nn; e += THREADS) A[e] = Din[e];
  __syncthreads();
  chunk::chol(A, n, sm, fail);
  if (work != nullptr)
    for (long long e = threadIdx.x; e < nn; e += THREADS) c[e] = A[e];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    bcr_eliminate(const T* __restrict__ D, int m, int n, T* __restrict__ c,
                  int* __restrict__ fail, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int k = blockIdx.x, f = blockIdx.y, h = m / 2;
  const long long nn = static_cast<long long>(n) * n;
  const T* Dodd = D + (static_cast<long long>(f) * m + 2 * k + 1) * nn;
  T* ck = c + (static_cast<long long>(f) * h + k) * nn;
  factor_block(Dodd, n, ck, in_smem ? reinterpret_cast<T*>(dyn) : nullptr,
               sm, fail);
}

// One block per (column tile j, kept chunk k, window f): the tile's
// columns of X = Dodd_k^-1 A_k^T, Z = Dodd_k^-1 B_k and Z_{k-1} solved in
// the workspace W (n x 3 TS), then the column strip of D'_k and E'_k
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    bcr_reduce(const T* __restrict__ D, const T* __restrict__ E,
               const T* __restrict__ c, int m, int n, T* __restrict__ ws,
               T* __restrict__ Dn, T* __restrict__ En, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int tn = (n + TS - 1) / TS;
  const int tj = blockIdx.x, k = blockIdx.y, f = blockIdx.z, h = m / 2;
  const int c0 = tj * TS, nc = min(TS, n - c0);
  const long long nn = static_cast<long long>(n) * n;
  const T* Ew = E + static_cast<long long>(f) * m * nn;
  const T* A = Ew + 2LL * k * nn;                       // E_{2k}
  const T* Bk = A + nn;                                 // E_{2k+1}
  const T* Bp = k > 0 ? A - nn : A;                     // E_{2k-1}
  const T* cw = c + static_cast<long long>(f) * h * nn;
  constexpr int LD = 3 * TS;                            // [X | Z | Z_{k-1}]
  T* W = in_smem ? reinterpret_cast<T*>(dyn)
                 : ws + ((static_cast<long long>(f) * h + k) * tn + tj) * n * LD;
  for (long long e = threadIdx.x; e < static_cast<long long>(n) * LD;
       e += THREADS) {
    const int i = static_cast<int>(e / LD), q = static_cast<int>(e % LD);
    const int part = q / TS, j = c0 + q % TS;
    T v = T(0);
    if (j < n) {
      if (part == 0) v = A[static_cast<long long>(j) * n + i];
      else if (part == 1) v = Bk[static_cast<long long>(i) * n + j];
      else if (k > 0) v = Bp[static_cast<long long>(i) * n + j];
    }
    W[e] = v;
  }
  __syncthreads();
  chunk::trsm<false>(cw + k * nn, n, W, LD, 2 * TS, sm);
  chunk::trsm<true>(cw + k * nn, n, W, LD, 2 * TS, sm);
  if (k > 0) {
    chunk::trsm<false>(cw + (k - 1) * nn, n, W + 2 * TS, LD, TS, sm);
    chunk::trsm<true>(cw + (k - 1) * nn, n, W + 2 * TS, LD, TS, sm);
  }
  const T* De = D + (static_cast<long long>(f) * m + 2 * k) * nn;
  const long long out = (static_cast<long long>(f) * h + k) * nn;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r0 = 0; r0 < n; r0 += TS) {
    // the three products of the tile, each summed over t in order
    T t1[chunk::Q], t2[chunk::Q], t3[chunk::Q];
    for (int q = 0; q < chunk::Q; ++q) t1[q] = t2[q] = t3[q] = T(0);
    if (k > 0)                                          // B_{k-1}^T Z_{k-1}
      chunk::tile_acc(t1, Mat<T>{Bp, n, true}, Mat<T>{W + 2 * TS, LD, false},
                      r0, 0, n, nc, n, sm);
    chunk::tile_acc(t2, Mat<T>{A, n, false}, Mat<T>{W, LD, false}, r0, 0, n,
                    nc, n, sm);                          // A_k X_k
    if (En != nullptr)                                  // A_k Z_k
      chunk::tile_acc(t3, Mat<T>{A, n, false}, Mat<T>{W + TS, LD, false}, r0,
                      0, n, nc, n, sm);
    for (int q = 0; q < chunk::Q; ++q) {
      const int i = r0 + ty + chunk::WARPS * q, j = c0 + tx;
      if (i < n && j < n) {
        const long long e = static_cast<long long>(i) * n + j;
        Dn[out + e] = (De[e] - t1[q]) - t2[q];
        if (En != nullptr) En[out + e] = -t3[q];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    bcr_base(const T* __restrict__ D, int n, T* __restrict__ c,
             int* __restrict__ fail, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const long long nn = static_cast<long long>(n) * n;
  factor_block(D + blockIdx.x * nn, n, c + blockIdx.x * nn,
               in_smem ? reinterpret_cast<T*>(dyn) : nullptr, sm, fail);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    scan_factor(const T* __restrict__ D, const T* __restrict__ E, int m,
                int n, T* __restrict__ C, T* __restrict__ M,
                T* __restrict__ xw, int* __restrict__ fail, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int f = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  T* X = in_smem ? reinterpret_cast<T*>(dyn) : xw + f * nn;
  for (int i = 0; i < m; ++i) {
    const long long blk = (static_cast<long long>(f) * m + i) * nn;
    T* Ci = C + blk;
    T* Mi = M + blk;
    if (i == 0) {
      for (long long e = threadIdx.x; e < nn; e += THREADS) {
        Ci[e] = D[blk + e];
        Mi[e] = T(0);
      }
      __syncthreads();
    } else {
      // X = C_{i-1}^-1 E_{i-1}, M_i = X^T, C_i = D_i - X^T X (lower)
      for (long long e = threadIdx.x; e < nn; e += THREADS)
        X[e] = E[blk - nn + e];
      __syncthreads();
      chunk::trsm<false>(Ci - nn, n, X, n, n, sm);
      for (long long e = threadIdx.x; e < nn; e += THREADS) {
        const long long r = e / n, q = e - r * n;
        Mi[e] = X[q * n + r];
        Ci[e] = D[blk + e];
      }
      __syncthreads();
      chunk::gemm_sub(Ci, n, n, n, Mat<T>{X, n, true}, Mat<T>{X, n, false},
                      n, true, sm);
    }
    chunk::chol(Ci, n, sm, fail);
  }
}

template <typename T>
int launch_eliminate(const void* D, int F, int m, int n, void* c, void* fail,
                     void* stream) {
  if (F < 1 || m < 2 || m % 2 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = chunk::smem_if_fits<T>(
      bcr_eliminate<T>, static_cast<long long>(n) * n * sizeof(T));
  bcr_eliminate<T><<<dim3(m / 2, F), THREADS, static_cast<size_t>(bytes),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), m, n, static_cast<T*>(c),
      static_cast<int*>(fail), bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

// elements of bcr_reduce's device workspace at a level of m chunks: none
// when each block's n x 96 strip fits in shared memory
template <typename T>
long long reduce_workspace(int F, int m, int n) {
  const long long strip = static_cast<long long>(n) * 3 * TS;
  if (chunk::smem_if_fits<T>(bcr_reduce<T>, strip * sizeof(T)) > 0) return 0;
  return static_cast<long long>(F) * (m / 2) * ((n + TS - 1) / TS) * strip;
}

template <typename T>
int launch_reduce(const void* D, const void* E, const void* c, int F, int m,
                  int n, void* ws, void* Dn, void* En, void* stream) {
  if (F < 1 || m < 2 || m % 2 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tn = (n + TS - 1) / TS;
  const long long bytes = chunk::smem_if_fits<T>(
      bcr_reduce<T>, static_cast<long long>(n) * 3 * TS * sizeof(T));
  bcr_reduce<T><<<dim3(tn, m / 2, F), THREADS, static_cast<size_t>(bytes),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(E),
      static_cast<const T*>(c), m, n, static_cast<T*>(ws),
      static_cast<T*>(Dn), static_cast<T*>(En), bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_base(const void* D, int F, int n, void* c, void* fail,
                void* stream) {
  if (F < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = chunk::smem_if_fits<T>(
      bcr_base<T>, static_cast<long long>(n) * n * sizeof(T));
  bcr_base<T><<<F, THREADS, static_cast<size_t>(bytes),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), n, static_cast<T*>(c),
      static_cast<int*>(fail), bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scan(const void* D, const void* E, int F, int m, int n, void* C,
                void* M, void* xw, void* fail, void* stream) {
  if (F < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = chunk::smem_if_fits<T>(
      scan_factor<T>, static_cast<long long>(n) * n * sizeof(T));
  scan_factor<T><<<F, THREADS, static_cast<size_t>(bytes),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(E), m, n,
      static_cast<T*>(C), static_cast<T*>(M), static_cast<T*>(xw),
      static_cast<int*>(fail), bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c: (F, m/2, n, n), the Choleskys of the odd chunks
int ba_bcr_eliminate_f32(const void* D, int F, int m, int n, void* c,
                         void* fail, void* stream) {
  return launch_eliminate<float>(D, F, m, n, c, fail, stream);
}
int ba_bcr_eliminate_f64(const void* D, int F, int m, int n, void* c,
                         void* fail, void* stream) {
  return launch_eliminate<double>(D, F, m, n, c, fail, stream);
}

// the elements ba_bcr_reduce needs in ws at (F, m, n): 0 when the strips
// sit in shared memory (ws may then be null), else F (m/2) ceil(n/32) n 96
long long ba_bcr_reduce_workspace_f32(int F, int m, int n) {
  return reduce_workspace<float>(F, m, n);
}
long long ba_bcr_reduce_workspace_f64(int F, int m, int n) {
  return reduce_workspace<double>(F, m, n);
}

// ws: the workspace above; Dn: (F, m/2, n, n); En the same, or null on the
// last level
int ba_bcr_reduce_f32(const void* D, const void* E, const void* c, int F,
                      int m, int n, void* ws, void* Dn, void* En,
                      void* stream) {
  return launch_reduce<float>(D, E, c, F, m, n, ws, Dn, En, stream);
}
int ba_bcr_reduce_f64(const void* D, const void* E, const void* c, int F,
                      int m, int n, void* ws, void* Dn, void* En,
                      void* stream) {
  return launch_reduce<double>(D, E, c, F, m, n, ws, Dn, En, stream);
}

// D: (F, 1, n, n) -> c (F, n, n)
int ba_bcr_base_f32(const void* D, int F, int n, void* c, void* fail,
                    void* stream) {
  return launch_base<float>(D, F, n, c, fail, stream);
}
int ba_bcr_base_f64(const void* D, int F, int n, void* c, void* fail,
                    void* stream) {
  return launch_base<double>(D, F, n, c, fail, stream);
}

// C, M: (F, m, n, n); xw: (F, n, n) workspace
int ba_scan_factor_f32(const void* D, const void* E, int F, int m, int n,
                       void* C, void* M, void* xw, void* fail, void* stream) {
  return launch_scan<float>(D, E, F, m, n, C, M, xw, fail, stream);
}
int ba_scan_factor_f64(const void* D, const void* E, int F, int m, int n,
                       void* C, void* M, void* xw, void* fail, void* stream) {
  return launch_scan<double>(D, E, F, m, n, C, M, xw, fail, stream);
}

}  // extern "C"
