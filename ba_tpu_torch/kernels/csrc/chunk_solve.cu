// K8c: x = S^-1 b through the factor of K8b (chunk_factor.cu), the
// preconditioner of the banded solver's PCG (5 solves per build).
//
// Replaces the TPU formulations ba_tpu/solver/banded.py:_bcr_solve
// (:369-396) and _solve_factored (:399-420): per level two batched
// triangular solves and four batched block products, each an XLA launch
// (and, on the port's library route, a cuBLAS call).
//
// b and x are (F, L) rows of one window each: chunk k of window f is
// elements [k n, (k + 1) n) of row f, and an element at or past `valid` of
// its row reads as zero (b) or is not written (x), so the banded solver's
// pad of each window to whole chunks and its cut back need no launch.
//
// Cyclic reduction, one launch per level down, one for the base, one per
// level up:
//   down: one block per (kept chunk k, window): u_{k-1} and u_k = Dodd^-1
//         b_odd by two Cholesky solves each, then b'_k = (b_{2k} - B_{k-1}^T
//         u_{k-1}) - A_k u_k (the first term shifted by one chunk, zero at
//         k = 0); a block recomputes its left neighbour's u rather than
//         wait for it;
//   base: x_0 = (c0 c0^T)^-1 b_0 on the last level;
//   up:   one block per (eliminated chunk k, window): x_odd = Dodd^-1
//         ((b_{2k+1} - A_k^T x_k) - B_k x_{k+1}) and the interleave x_{2k} =
//         x_k, x_{2k+1} = x_odd.
// The scan: one launch forward (y_i = C_i^-1 (b_i - M_i y_{i-1})) and one
// backward (x_i = C_i^-T (y_i - M_{i+1}^T x_{i+1})), one block per window
// stepping through the chunks.  A Cholesky solve of a vector is by panels
// of 32 rows, right-looking: the panel's triangle in one warp with
// shuffles (each lane's pivot reciprocal taken first, so the chain holds
// no division), then the remaining rows' updates one per thread.  The
// factor being solved with is staged in shared memory when it fits (f32 at
// n = 216: 186,624 B) and read from device memory otherwise (f64).
//
// Bound on an H100: latency, then bytes.  A solve reads every level's
// factor and couplings once (71.3 MB at the long trajectory in f32,
// 0.0213 ms at 3.35 TB/s), but its levels are sequential and each block's
// triangular solves are a chain of 2 n / 32 dependent panels; the inner
// levels run one or a few blocks.  Left for later: an explicit inverse of
// each Dodd in the factor would make every solve here products only.
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

// level of m chunks: c (F, m/2, n, n), E (F, m, n, n); b rows of stride
// b_ld, valid b_valid; b' (F, m/2, n)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    bcr_down(const T* __restrict__ c, const T* __restrict__ E,
             const T* __restrict__ b, long long b_ld, long long b_valid, int m,
             int n, T* __restrict__ bn, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* u = reinterpret_cast<T*>(dyn);
  T* t = u + n;
  T* acc = t + n;
  T* Ls = acc + n;
  const int k = blockIdx.x, f = blockIdx.y, h = m / 2;
  const long long nn = static_cast<long long>(n) * n;
  const T* row = b + f * b_ld;
  const T* cw = c + static_cast<long long>(f) * h * nn;
  const T* Ew = E + static_cast<long long>(f) * m * nn;
  load_chunk(row, 2 * k, n, b_valid, acc);
  if (k > 0) {
    load_chunk(row, 2 * k - 1, n, b_valid, u);
    __syncthreads();
    chunk::cho_solve(stage(cw + (k - 1) * nn, n, Ls, in_smem), n, u, sm);
    chunk::gemv(Ew + (2LL * k - 1) * nn, n, true, u, t);   // B_{k-1}^T u
    for (int i = threadIdx.x; i < n; i += THREADS) acc[i] = acc[i] - t[i];
  }
  load_chunk(row, 2 * k + 1, n, b_valid, u);
  __syncthreads();
  chunk::cho_solve(stage(cw + k * nn, n, Ls, in_smem), n, u, sm);
  chunk::gemv(Ew + 2LL * k * nn, n, false, u, t);           // A_k u
  T* out = bn + (static_cast<long long>(f) * h + k) * n;
  for (int i = threadIdx.x; i < n; i += THREADS) out[i] = acc[i] - t[i];
}

// c0 (F, n, n); b (F, 1, n) -> x (F, 1, n)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    bcr_base_solve(const T* __restrict__ c0, const T* __restrict__ b, int n,
                   T* __restrict__ x, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* v = reinterpret_cast<T*>(dyn);
  const long long f = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += THREADS) v[i] = b[f * n + i];
  __syncthreads();
  chunk::cho_solve(stage(c0 + f * n * n, n, v + n, in_smem), n, v, sm);
  for (int i = threadIdx.x; i < n; i += THREADS) x[f * n + i] = v[i];
}

// level of m chunks: xk (F, m/2, n) the solved kept chunks -> x rows of
// stride x_ld, valid x_valid
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    bcr_up(const T* __restrict__ c, const T* __restrict__ E,
           const T* __restrict__ b, long long b_ld, long long b_valid,
           const T* __restrict__ xk, int m, int n, T* __restrict__ x,
           long long x_ld, long long x_valid, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* xe = reinterpret_cast<T*>(dyn);
  T* xr = xe + n;
  T* t = xr + n;
  T* v = t + n;
  const int k = blockIdx.x, f = blockIdx.y, h = m / 2;
  const long long nn = static_cast<long long>(n) * n;
  const T* Ew = E + static_cast<long long>(f) * m * nn;
  const T* xkw = xk + static_cast<long long>(f) * h * n;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    xe[i] = xkw[static_cast<long long>(k) * n + i];
    xr[i] = k + 1 < h ? xkw[static_cast<long long>(k + 1) * n + i] : T(0);
  }
  load_chunk(b + f * b_ld, 2 * k + 1, n, b_valid, v);
  __syncthreads();
  chunk::gemv(Ew + 2LL * k * nn, n, true, xe, t);           // A_k^T x_k
  for (int i = threadIdx.x; i < n; i += THREADS) v[i] = v[i] - t[i];
  __syncthreads();
  chunk::gemv(Ew + (2LL * k + 1) * nn, n, false, xr, t);    // B_k x_{k+1}
  for (int i = threadIdx.x; i < n; i += THREADS) v[i] = v[i] - t[i];
  __syncthreads();
  chunk::cho_solve(stage(c + (static_cast<long long>(f) * h + k) * nn, n,
                         v + n, in_smem), n, v, sm);
  T* row = x + f * x_ld;
  store_chunk(row, 2 * k, n, x_valid, xe);
  store_chunk(row, 2 * k + 1, n, x_valid, v);
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

template <typename T>
int launch_down(const void* c, const void* E, const void* b, long long b_ld,
                long long b_valid, int F, int m, int n, void* bn,
                void* stream) {
  if (F < 1 || m < 2 || m % 2 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long bytes = 0;
  int in_smem = 0;
  if (int rc = prepare<T>(bcr_down<T>, 3, n, bytes, in_smem)) return rc;
  bcr_down<T><<<dim3(m / 2, F), THREADS, static_cast<size_t>(bytes),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(E),
      static_cast<const T*>(b), b_ld, b_valid, m, n, static_cast<T*>(bn),
      in_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_base(const void* c0, const void* b, int F, int n, void* x,
                void* stream) {
  if (F < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long bytes = 0;
  int in_smem = 0;
  if (int rc = prepare<T>(bcr_base_solve<T>, 1, n, bytes, in_smem))
    return rc;
  bcr_base_solve<T><<<F, THREADS, static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c0), static_cast<const T*>(b), n,
      static_cast<T*>(x), in_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* c, const void* E, const void* b, long long b_ld,
              long long b_valid, const void* xk, int F, int m, int n, void* x,
              long long x_ld, long long x_valid, void* stream) {
  if (F < 1 || m < 2 || m % 2 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long bytes = 0;
  int in_smem = 0;
  if (int rc = prepare<T>(bcr_up<T>, 4, n, bytes, in_smem)) return rc;
  bcr_up<T><<<dim3(m / 2, F), THREADS, static_cast<size_t>(bytes),
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(E),
      static_cast<const T*>(b), b_ld, b_valid, static_cast<const T*>(xk), m,
      n, static_cast<T*>(x), x_ld, x_valid, in_smem);
  return static_cast<int>(cudaGetLastError());
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

int ba_bcr_down_f32(const void* c, const void* E, const void* b,
                    long long b_ld, long long b_valid, int F, int m, int n,
                    void* bn, void* stream) {
  return launch_down<float>(c, E, b, b_ld, b_valid, F, m, n, bn, stream);
}
int ba_bcr_down_f64(const void* c, const void* E, const void* b,
                    long long b_ld, long long b_valid, int F, int m, int n,
                    void* bn, void* stream) {
  return launch_down<double>(c, E, b, b_ld, b_valid, F, m, n, bn, stream);
}

int ba_bcr_base_solve_f32(const void* c0, const void* b, int F, int n,
                          void* x, void* stream) {
  return launch_base<float>(c0, b, F, n, x, stream);
}
int ba_bcr_base_solve_f64(const void* c0, const void* b, int F, int n,
                          void* x, void* stream) {
  return launch_base<double>(c0, b, F, n, x, stream);
}

int ba_bcr_up_f32(const void* c, const void* E, const void* b, long long b_ld,
                  long long b_valid, const void* xk, int F, int m, int n,
                  void* x, long long x_ld, long long x_valid, void* stream) {
  return launch_up<float>(c, E, b, b_ld, b_valid, xk, F, m, n, x, x_ld,
                          x_valid, stream);
}
int ba_bcr_up_f64(const void* c, const void* E, const void* b, long long b_ld,
                  long long b_valid, const void* xk, int F, int m, int n,
                  void* x, long long x_ld, long long x_valid, void* stream) {
  return launch_up<double>(c, E, b, b_ld, b_valid, xk, F, m, n, x, x_ld,
                           x_valid, stream);
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
