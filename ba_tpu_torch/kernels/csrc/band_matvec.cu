// Kernel 9: y = S x for the symmetric block band of the reduced camera system.
//
//   y_q = sum_{d<B, q+d<P} band[q, d] x_{q+d}
//       + sum_{1<=d<B, q-d>=0} band[q-d, d]^T x_{q-d}
//
// band (P, B, D, D) holds the upper blocks, band[p, d] = S[p, p + d].
//
// Replaces the TPU formulation ba_tpu/solver/banded.py:band_matvec
// (:229-242), which gathers a (P, B, D) copy of x for the upper part and a
// (P, B - 1, D, D) copy of the band for the lower part on every call, then
// contracts both with einsums.  Here the band is read in place.
//
// One warp per output pose q, eight poses per block.  The warp's lanes are
// (slot s, row i) pairs, s < 32 / D: lane (s, i) walks the 2B - 1 blocks
// k = s, s + slots, ... of pose q (upper blocks by row i, lower blocks by
// column i) and dots each with its D entries of x.  The slots are then
// added in slot order with shuffles: every y is a sum in a fixed order, so
// two launches are bit-identical, with no atomics.
//
// Bound on an H100: bytes.  At the full-width trajectory (P = 2048, B = 24,
// D = 9) the band is 15.9 MB in f32, ~4.7 us at 3.35 TB/s; its 15.6 MFLOP
// take 0.23 us at 67 TFLOP/s.  Each band block is read twice, by pose q as
// an upper block and by pose q + d as a lower one; the second read comes
// from the 50 MB L2 when the two warps run close together.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    band_matvec_kernel(const T* __restrict__ band, const T* __restrict__ x,
                       int P, int B, int D, T* __restrict__ y) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= P) return;  // the whole warp leaves together
  const int slots = 32 / D;
  const int s = lane / D, i = lane - s * D;
  const long long DD = static_cast<long long>(D) * D;
  T acc = T(0);
  if (s < slots) {
    const int nterm = 2 * B - 1;
    for (int k = s; k < nterm; k += slots) {
      if (k < B) {
        const int p = q + k;
        if (p < P) {
          const T* blk = band + (static_cast<long long>(q) * B + k) * DD + i * D;
          const T* xv = x + static_cast<long long>(p) * D;
          for (int j = 0; j < D; ++j) acc += blk[j] * xv[j];
        }
      } else {
        const int d = k - B + 1;
        const int p = q - d;
        if (p >= 0) {
          const T* blk = band + (static_cast<long long>(p) * B + d) * DD + i;
          const T* xv = x + static_cast<long long>(p) * D;
          for (int j = 0; j < D; ++j) acc += blk[j * D] * xv[j];
        }
      }
    }
  }
  T total = acc;
  for (int t = 1; t < slots; ++t)
    total += __shfl_sync(0xffffffffu, acc, t * D + i);
  if (s == 0) y[static_cast<long long>(q) * D + i] = total;
}

template <typename T>
int launch(const void* band, const void* x, int P, int B, int D, void* y,
           void* stream) {
  if (P < 0 || B < 1 || D < 1 || D > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    band_matvec_kernel<T><<<(P + WARPS - 1) / WARPS, WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(band), static_cast<const T*>(x), P, B, D,
        static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_band_matvec_f32(const void* band, const void* x, int P, int B, int D,
                       void* y, void* stream) {
  return launch<float>(band, x, P, B, D, y, stream);
}

int ba_band_matvec_f64(const void* band, const void* x, int P, int B, int D,
                       void* y, void* stream) {
  return launch<double>(band, x, P, B, D, y, stream);
}

}  // extern "C"
