// K5b: the dense symmetric matrix of a block band.
//
// band (P, B, D, D) holds the upper blocks, band[p, d] = U[p, p + d]
// (blocks past the last pose are ignored); the output is the dense
// (P D, P D) matrix with band[a, b - a] above the block diagonal, its
// transposes below, and zero past the band.
//
// Replaces the TPU formulation ba_tpu/solver/assemble.py:band_to_dense
// (:159-184): the band strips placed on the block diagonals by a pad and
// flat-reshape trick, then `upper + upper^T - diagonal strips`.  Here each
// output element is written once by its own thread, with no atomics and
// no scatter.  A diagonal block rounds as the plain version does, (u + u^T)
// - u, not as u^T: an f32 band's diagonal blocks are symmetric only to the
// roundoff of their sums, and the two orders differ there.  The additions
// use the _rn intrinsics so that nothing is contracted; the output equals
// the plain version's, element for element.
//
// Bound on an H100: bytes.  At the flagship (P = 128, B = 24, D = 9, f32)
// it reads the 1.0 MB band and writes the 5.3 MB dense matrix, ~1.9 us at
// 3.35 TB/s.  Left for later: writing U straight into K5's tile loads
// (schur_finish.cu reads U's lower triangle once), so the dense U never
// reaches device memory.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    band_to_dense_kernel(const T* __restrict__ band, int P, int B, int D,
                         T* __restrict__ out) {
  const long long W = static_cast<long long>(P) * D;
  const long long total = W * W;
  const long long DD = static_cast<long long>(D) * D;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS)
                     + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = e / W, c = e - r * W;
    const int a = static_cast<int>(r / D), i = static_cast<int>(r - a * D);
    const int b = static_cast<int>(c / D), j = static_cast<int>(c - b * D);
    T v = T(0);
    if (b > a) {
      if (b - a < B)
        v = add_rn(band[(static_cast<long long>(a) * B + (b - a)) * DD
                        + i * D + j], T(0));
    } else if (b < a) {
      if (a - b < B)
        v = add_rn(T(0), band[(static_cast<long long>(b) * B + (a - b)) * DD
                              + j * D + i]);
    } else {
      const T* blk = band + static_cast<long long>(a) * B * DD;
      const T u = blk[i * D + j];
      v = sub_rn(add_rn(u, blk[j * D + i]), u);
    }
    out[e] = v;
  }
}

template <typename T>
int launch(const void* band, int P, int B, int D, void* out, void* stream) {
  if (P < 0 || B < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(P) * D * P * D;
  if (total > 0) {
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    band_to_dense_kernel<T><<<static_cast<int>(blocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(band), P, B, D, static_cast<T*>(out));
  }
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
