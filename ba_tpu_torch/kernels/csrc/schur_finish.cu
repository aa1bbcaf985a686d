// K5: the dense Schur step of the reduced camera system.
//
//   S   = U - W V^-1 W^T           (n x n, the leading n rows and columns)
//   rhs = rhs_p - W V^-1 rhs_l     (n)
//
// with U (N, N), W (N, K) dense, K = L * LM landmark columns, V^-1 the
// (L, LM, LM) block diagonal of the landmark Hessian's inverse, n <= N.
// An optional epilogue applies the column mask of the reduced system: a
// masked dimension gets 1e6 on its diagonal and a zero rhs.
//
// Replaces the TPU formulation ba_tpu/solver/assemble.py:finish (:442),
// which writes W V^-1 (N x K) to device memory and hands the N x N x K
// product to the matrix unit, and the same step of the marginalization
// (ba_tpu/solver/window.py:marginalize, :93-100), which keeps only the
// leading n rows and columns.
//
// Design: one block of 256 threads per 64 x 64 tile of the lower triangle
// of S, walking the landmark columns in steps of 16 / LM landmarks.  Each
// step stages the tile's rows of W into shared memory twice: for the row
// operand with V^-1 applied there (a scalar at LM 1, a 3 x 3 block at
// LM 3), for the column operand as it is; W V^-1 never reaches device
// memory.  A thread accumulates a 4 x 4 patch with plain FMA (no tensor
// cores: the package pins exact f32) in ascending column order, writes
// S[i, j] = U[i, j] - acc for j <= i and mirrors it to S[j, i], so S is
// exactly symmetric and every element has one writer.  The rhs is one
// more product with the same operand: after the tiles, one block per 64
// rows, a warp per row, its lanes over the landmarks and a fixed xor
// butterfly.  Two launches are bit-identical.  With K = 0 (no landmark
// columns) the column loop runs no step and S = U, rhs = rhs_p.
//
// Bound on an H100: operations.  At the flagship (N = 1,152, K = 497) the
// symmetric product takes ~0.66 GFLOP (~10 us at 67 TFLOP/s f32) against
// ~13 MB of U, W and S (~4 us at 3.35 TB/s).
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int BK = 16;        // landmark columns per step, at most
constexpr int THREADS = 256;  // 16 x 16, a 4 x 4 patch each
constexpr int PAD = TILE + 1;

template <typename T, int LM>
__device__ void tile_product(const T* __restrict__ U, long long ldu,
                             const T* __restrict__ W, int K,
                             const T* __restrict__ vinv,
                             const unsigned char* __restrict__ cmask, int n,
                             int bi, int bj, T* __restrict__ S) {
  constexpr int TL = BK / LM;        // landmarks per step
  __shared__ T As[BK][PAD];          // (W V^-1)^T of rows i0..i0+63
  __shared__ T Bs[BK][PAD];          // W^T of rows j0..j0+63
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int i0 = bi * TILE, j0 = bj * TILE;
  const int L = K / LM;
  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);

  for (int l0 = 0; l0 < L; l0 += TL) {
    for (int e = t; e < TILE * TL; e += THREADS) {
      const int r = e / TL, l = e - r * TL, gl = l0 + l;
      const int gi = i0 + r, gj = j0 + r;
      T wa[LM], wb[LM];
#pragma unroll
      for (int a = 0; a < LM; ++a) {
        wa[a] = (gi < n && gl < L)
                    ? W[static_cast<long long>(gi) * K + gl * LM + a] : T(0);
        wb[a] = (gj < n && gl < L)
                    ? W[static_cast<long long>(gj) * K + gl * LM + a] : T(0);
      }
#pragma unroll
      for (int b = 0; b < LM; ++b) {
        T s = T(0);
        if (gl < L) {
          const T* vb = vinv + static_cast<long long>(gl) * LM * LM + b;
#pragma unroll
          for (int a = 0; a < LM; ++a) s = fma(wa[a], vb[a * LM], s);
        }
        As[l * LM + b][r] = s;
        Bs[l * LM + b][r] = wb[b];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < TL * LM; ++c) {
      T av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[c][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[c][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = i0 + ty + 16 * a;
    if (gi >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gj = j0 + tx + 16 * b;
      if (gj > gi) continue;
      T v = U[gi * ldu + gj] - acc[a][b];
      if (gj == gi && cmask != nullptr && !cmask[gi]) v += T(1e6);
      S[static_cast<long long>(gi) * n + gj] = v;
      if (gj < gi) S[static_cast<long long>(gj) * n + gi] = v;
    }
  }
}

template <typename T, int LM>
__device__ void rhs_rows(const T* __restrict__ W, int K,
                         const T* __restrict__ vinv,
                         const T* __restrict__ rhs_p,
                         const T* __restrict__ rhs_l,
                         const unsigned char* __restrict__ cmask, int n,
                         int rb, T* __restrict__ rhs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = K / LM;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int gi = rb * TILE + r;
    if (gi >= n) break;                 // the whole warp leaves together
    const T* wrow = W + static_cast<long long>(gi) * K;
    T part = T(0);
    for (int l = lane; l < L; l += 32) {
      T wa[LM];
#pragma unroll
      for (int a = 0; a < LM; ++a) wa[a] = wrow[l * LM + a];
      const T* vb = vinv + static_cast<long long>(l) * LM * LM;
#pragma unroll
      for (int b = 0; b < LM; ++b) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < LM; ++a) s = fma(wa[a], vb[a * LM + b], s);
        part = fma(s, rhs_l[l * LM + b], part);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      T v = rhs_p[gi] - part;
      if (cmask != nullptr && !cmask[gi]) v = T(0);
      rhs[gi] = v;
    }
  }
}

template <typename T, int LM>
__global__ void __launch_bounds__(THREADS)
    schur_finish_kernel(const T* __restrict__ U, int ldu,
                        const T* __restrict__ W, int K,
                        const T* __restrict__ vinv,
                        const T* __restrict__ rhs_p,
                        const T* __restrict__ rhs_l,
                        const unsigned char* __restrict__ cmask, int n,
                        int ntri, T* __restrict__ S, T* __restrict__ rhs) {
  const int b = blockIdx.x;
  if (b < ntri) {
    // lower-triangle tile (bi, bj), bj <= bi, numbered row by row
    int bi = static_cast<int>((sqrt(8.0 * b + 1.0) - 1.0) * 0.5);
    while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
    while (bi * (bi + 1) / 2 > b) --bi;
    const int bj = b - bi * (bi + 1) / 2;
    tile_product<T, LM>(U, ldu, W, K, vinv, cmask, n, bi, bj, S);
  } else {
    rhs_rows<T, LM>(W, K, vinv, rhs_p, rhs_l, cmask, n, b - ntri, rhs);
  }
}

template <typename T>
int launch(const void* U, int ldu, const void* W, int K, int lm,
           const void* vinv, const void* rhs_p, const void* rhs_l,
           const void* cmask, int n, void* S, void* rhs, void* stream) {
  if (n < 0 || ldu < n || K < 0 || (lm != 1 && lm != 3) || K % lm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int nb = (n + TILE - 1) / TILE;
  const int ntri = nb * (nb + 1) / 2;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(cmask);
#define BA_K5_ARGS                                                          \
  static_cast<const T*>(U), ldu, static_cast<const T*>(W), K,               \
      static_cast<const T*>(vinv), static_cast<const T*>(rhs_p),            \
      static_cast<const T*>(rhs_l), m, n, ntri, static_cast<T*>(S),         \
      static_cast<T*>(rhs)
  if (lm == 1)
    schur_finish_kernel<T, 1><<<ntri + nb, THREADS, 0, st>>>(BA_K5_ARGS);
  else
    schur_finish_kernel<T, 3><<<ntri + nb, THREADS, 0, st>>>(BA_K5_ARGS);
#undef BA_K5_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_schur_finish_f32(const void* U, int ldu, const void* W, int K, int lm,
                        const void* vinv, const void* rhs_p,
                        const void* rhs_l, const void* cmask, int n, void* S,
                        void* rhs, void* stream) {
  return launch<float>(U, ldu, W, K, lm, vinv, rhs_p, rhs_l, cmask, n, S,
                       rhs, stream);
}

int ba_schur_finish_f64(const void* U, int ldu, const void* W, int K, int lm,
                        const void* vinv, const void* rhs_p,
                        const void* rhs_l, const void* cmask, int n, void* S,
                        void* rhs, void* stream) {
  return launch<double>(U, ldu, W, K, lm, vinv, rhs_p, rhs_l, cmask, n, S,
                        rhs, stream);
}

}  // extern "C"
