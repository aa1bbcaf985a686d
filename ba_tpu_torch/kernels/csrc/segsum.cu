// Deterministic segmented block sum: out[s, :] = sum of vals[i, :] over the
// rows i of segment s, in a fixed order.
//
// Replaces the TPU formulation ba_tpu/solver/assemble.py:seg_sum_blocks
// (:120-156, a one-hot MXU matmul below 512 segments, a serialized scatter
// above).  The wrapper hands over a stable sort of the rows by segment id
// (`perm`) and CSR offsets; rows with out-of-range ids lie past
// offsets[nseg] and are never read.
//
// One warp per segment; lane j owns columns j, j+32, ... of the flattened
// block (up to 32*NC columns per pass, NC register accumulators each) and
// adds the segment's rows in sorted order.  A row's columns are contiguous,
// so each row is one coalesced read; the fixed order makes the output
// bit-identical from run to run (no atomics).
//
// Bound on an H100: bytes — every input row read once, every output written
// once, against 3.35 TB/s; the adds are negligible.

#include <cuda_runtime.h>

namespace {

constexpr int NC = 4;

template <typename T>
__global__ void segsum_kernel(const T* __restrict__ vals,
                              const long long* __restrict__ perm,
                              const long long* __restrict__ offsets, int nseg,
                              int k, T* __restrict__ out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nseg) return;
  const long long begin = offsets[warp];
  const long long end = offsets[warp + 1];
  for (int c0 = 0; c0 < k; c0 += 32 * NC) {
    T acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = T(0);
    for (long long i = begin; i < end; ++i) {
      const T* row = vals + perm[i] * static_cast<long long>(k);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = c0 + 32 * j + lane;
        if (c < k) acc[j] += row[c];
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = c0 + 32 * j + lane;
      if (c < k) out[warp * k + c] = acc[j];
    }
  }
}

template <typename T>
int launch(const T* vals, const long long* perm, const long long* offsets,
           int nseg, int k, T* out, void* stream) {
  if (nseg > 0 && k > 0) {
    const int threads = 256;                    // 8 segments per block
    const long long warps_per_block = threads / 32;
    const int blocks =
        static_cast<int>((nseg + warps_per_block - 1) / warps_per_block);
    segsum_kernel<T><<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        vals, perm, offsets, nseg, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_segsum_f32(const float* vals, const long long* perm,
                  const long long* offsets, int nseg, int k, float* out,
                  void* stream) {
  return launch<float>(vals, perm, offsets, nseg, k, out, stream);
}

int ba_segsum_f64(const double* vals, const long long* perm,
                  const long long* offsets, int nseg, int k, double* out,
                  void* stream) {
  return launch<double>(vals, perm, offsets, nseg, k, out, stream);
}

}  // extern "C"
