// K5b: the dense symmetric matrix of a block band.
//
// band (P, B, D, D) holds the upper blocks, band[p, d] = U[p, p + d]
// (blocks past the last pose are ignored); the output is the dense
// (P D, P D) matrix with band[a, b - a] above the block diagonal, its
// transposes below, and zero past the band.
//
// Replaces the TPU formulation ba_tpu/solver/assemble.py:band_to_dense
// (:159-184): the band strips placed on the block diagonals by a pad and
// flat-reshape trick, then `upper + upper^T - diagonal strips`.  A diagonal
// block rounds as the plain version does, (u + u^T) - u, not as u^T: an f32
// band's diagonal blocks are symmetric only to the roundoff of their sums,
// and the two orders differ there.  The additions use the _rn intrinsics so
// that nothing is contracted (u + 0 also turns a -0 into +0); the output
// equals the plain version's, element for element.
//
// Bound on an H100: bytes, the band read once and the dense matrix written
// once.  At the flagship (P = 128, B = 24, D = 9, f32) 6.3 MB, 1.9 us at
// 3.35 TB/s; on the GPS smoother's band (P = 600, B = 2) 117 MB, 35 us, of
// which more than 99 % are the zeros past the band.  So the design is the
// store path:
//
//   * one block of 256 threads per (block row a, column stripe): the host
//     cuts each row into enough stripes for at least two blocks per SM at
//     the flagship and stripes of at most 1,024 columns (each block writes
//     the D output rows of its stripe);
//   * the blocks of row a that meet the stripe (band[a, 0..B-1] and
//     band[a - d, d] for d = 1..B-1, at most 2B - 1) are staged in shared
//     memory first, a block per D^2 slot, read by consecutive threads from
//     consecutive addresses; a lower block is transposed on its
//     shared-memory read, so no load strides through device memory;
//   * every store is 16 bytes (4 floats or 2 doubles) when the row pitch
//     P D sizeof(T) is a multiple of 16, else a scalar; a store wholly
//     outside the band writes zeros and reads nothing;
//   * D is a compile-time constant for 6, 9 and 15 (the repo's pose
//     dimensions), so the block and column splits are multiplies, and
//     the stripe's blocks are staged when they fit in 96 KB; any other D,
//     and a stripe whose blocks do not fit, takes one generic
//     instantiation that reads the band in place through L1; index
//     arithmetic within a row is 32-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STRIPE = 1024;        // columns of a stripe at most
constexpr int MIN_STRIPE = 128;
constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks per SM
constexpr int SMEM_BUDGET = 96 * 1024;  // dynamic shared memory a block

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// offset (elements) of block column b's block in row a: band[a, b - a]
// above the diagonal, band[b, a - b] (to be transposed) below
__device__ __forceinline__ long long block_off(int a, int b, int B, int DD) {
  return b >= a ? (static_cast<long long>(a) * B + (b - a)) * DD
                : (static_cast<long long>(b) * B + (a - b)) * DD;
}

template <typename T, int DC, bool STAGE>
__global__ void __launch_bounds__(THREADS)
    band_to_dense_kernel(const T* __restrict__ band, int P, int B, int Drt,
                         int stripe, int vec, T* __restrict__ out) {
  using V = typename Vec<T>::type;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_band = reinterpret_cast<T*>(s_raw);
  const int D = DC ? DC : Drt;
  const int DD = D * D;
  const int N = P * D;
  const int a = blockIdx.x;
  const int c0 = blockIdx.y * stripe;
  const int c1 = min(N, c0 + stripe);
  // the block columns of row a's band that meet the stripe: [bl, bh]
  const int bl = max(max(0, a - B + 1), c0 / D);
  const int bh = min(min(P - 1, a + B - 1), (c1 - 1) / D);
  const int nb = max(0, bh - bl + 1);
  if (STAGE) {
    // slot k holds block column bl + k: band[a, bl + k - a] above the
    // diagonal, band[bl + k, a - bl - k] below (transposed on the read)
    for (int idx = threadIdx.x; idx < nb * DD; idx += THREADS) {
      const int k = idx / DD;
      s_band[idx] =
          __ldg(band + block_off(a, bl + k, B, DD) + (idx - k * DD));
    }
    __syncthreads();
  }
  const int lo = nb ? bl * D : c1;         // band columns [lo, hi)
  const int hi = nb ? (bh + 1) * D : c1;
  T* rows = out + static_cast<long long>(a) * D * N;
  const int per = vec ? VEC : 1;
  const int nv = (c1 - c0) / per;
  for (int w = threadIdx.x; w < D * nv; w += THREADS) {
    const int i = w / nv;
    const int c = c0 + (w - i * nv) * per;
    T e[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int cc = c + k;
      T x = T(0);
      if (k < per && cc >= lo && cc < hi) {
        const int b = cc / D;
        const int j = cc - b * D;
        const T* p = STAGE ? s_band + (b - bl) * DD
                           : band + block_off(a, b, B, DD);
        if (b > a) {
          x = add_rn(p[i * D + j], T(0));
        } else if (b < a) {
          x = add_rn(T(0), p[j * D + i]);
        } else {
          const T u = p[i * D + j];
          x = sub_rn(add_rn(u, p[j * D + i]), u);
        }
      }
      e[k] = x;
    }
    T* dst = rows + static_cast<long long>(i) * N + c;
    if (vec) {
      V val;
      T* pv = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int k = 0; k < VEC; ++k) pv[k] = e[k];
      *reinterpret_cast<V*>(dst) = val;
    } else {
      *dst = e[0];
    }
  }
}

template <typename T>
int smem_of(int stripe, int P, int B, int D) {
  long long k = (stripe - 1) / D + 2;
  if (k > 2LL * B - 1) k = 2LL * B - 1;
  if (k > P) k = P;
  return static_cast<int>(k * D * D * sizeof(T));
}

template <typename T>
int launch(const void* band_v, int P, int B, int D, void* out_v,
           void* stream) {
  if (P < 0 || B < 1 || D < 1 ||
      static_cast<long long>(P) * D > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  constexpr int VEC = 16 / sizeof(T);
  const T* band = static_cast<const T*>(band_v);
  T* out = static_cast<T*>(out_v);
  const int N = P * D;
  const int vec =
      N % VEC == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per = vec ? VEC : 1;
  const int s_occ = (TARGET_BLOCKS + P - 1) / P;
  const int s_size = (N + MAX_STRIPE - 1) / MAX_STRIPE;
  const int S = s_occ > s_size ? s_occ : s_size;
  int stripe = (N + S - 1) / S;
  if (stripe < MIN_STRIPE) stripe = MIN_STRIPE < N ? MIN_STRIPE : N;
  stripe = (stripe + per - 1) / per * per;
  const bool stage = (D == 6 || D == 9 || D == 15) &&
                     smem_of<T>(stripe, P, B, D) <= SMEM_BUDGET;
  const int smem = stage ? smem_of<T>(stripe, P, B, D) : 0;
  const dim3 grid(P, (N + stripe - 1) / stripe);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5B_LAUNCH(DC, ST)                                                   \
  do {                                                                       \
    if (smem > 48 * 1024) {                                                  \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          band_to_dense_kernel<T, DC, ST>,                                   \
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                \
      if (e != cudaSuccess) return static_cast<int>(e);                      \
    }                                                                        \
    band_to_dense_kernel<T, DC, ST><<<grid, THREADS, smem, s>>>(             \
        band, P, B, D, stripe, vec, out);                                    \
  } while (0)
  if (stage && D == 9)
    K5B_LAUNCH(9, true);
  else if (stage && D == 6)
    K5B_LAUNCH(6, true);
  else if (stage)
    K5B_LAUNCH(15, true);
  else
    K5B_LAUNCH(0, false);
#undef K5B_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_band_to_dense_f32(const void* band, int P, int B, int D, void* out,
                         void* stream) {
  return launch<float>(band, P, B, D, out, stream);
}

int ba_band_to_dense_f64(const void* band, int P, int B, int D, void* out,
                         void* stream) {
  return launch<double>(band, P, B, D, out, stream);
}

}  // extern "C"
