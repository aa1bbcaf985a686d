// Kernel 7: the grouped banded Schur correction, written onto the band grid.
//
//   corr[a, d, i, j] = sum over landmarks l seen from poses a and a + d of
//                      (Wb_{a,l} V_l^-1)[i] * Wb_{a+d,l}[j]
//
// for a < P, 0 <= d < B, i, j < 6, inverse-depth landmarks (V_l is 1x1).
//
// Replaces the TPU formulation ba_tpu/solver/banded.py:_band_schur_grouped
// (:96-133): it materializes every landmark's pair products in an
// (L, B, B, 6, 6) tensor (678 MB in f32 at P = 2048, B = 24), sums it per
// anchor pose with a segment sum and folds it onto the band with B shifted
// adds.  Here nothing but the (P, B, 6, 6) output is written.
//
// Tables, built once per solve on the device (kernels/band_schur.py,
// SchurPlan): `perm`/`offsets`, the W blocks of each pose in a fixed order
// (CSR, blocks that the grouped formulation drops are left out); `slot`, the
// block's local slot i_loc = pose - first observing pose of its landmark;
// `slot_row`, the W block of landmark l at local slot s (or -1), (L, B).
//
// One thread block per pose a.  It walks the W blocks of pose a in chunks of
// up to 32, in three stages separated by barriers: (1) each block's row and
// the rows of the same landmark's blocks at the slots i_loc + d, d < B -
// i_loc (the landmark at pose a + d); (2) their values, u = Wb_{a,l} V_l^-1
// (6 values) and the partners' 6 values each, loaded independently of one
// another into shared memory; (3) each thread adds the products of its
// output entries (d, i, j) over the chunk's blocks.  The stages keep the
// chain of dependent loads per element short (perm -> slot_row -> Wb); a
// first version that loaded each element through the whole chain at once
// took 0.170 ms on the device at full width.  Every output is a sum in the
// fixed CSR order, so two launches are bit-identical, with no atomics.
//
// Bound on an H100: bytes.  At the full-width trajectory (P = 2048, B = 24,
// Nw = 181,771 W blocks) it reads 4.4 MB of W blocks and writes 7.1 MB of
// output (f32), ~3.4 us at 3.35 TB/s; the ~2.1 M block pairs are 150 MFLOP,
// ~2.3 us at 67 TFLOP/s.  The partner lookups are gathers of 24-byte rows
// that stay in L2 (the W blocks are 4.4 MB).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NACC = 4;        // output entries per thread per tile
constexpr int MAX_CHUNK = 32;  // W blocks staged per pass

template <typename T>
__host__ __device__ constexpr int chunk_bytes(int B) {
  return 6 * (B + 1) * static_cast<int>(sizeof(T)) + (B + 1) * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    band_schur_kernel(const T* __restrict__ wb, const T* __restrict__ vinv,
                      const int* __restrict__ perm,
                      const int* __restrict__ offsets,
                      const int* __restrict__ lm, const int* __restrict__ slot,
                      const int* __restrict__ slot_row, int B, int chunk,
                      T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // [chunk][6]: Wb_{a,l} V_l^-1
  T* sp = su + chunk * 6;                  // [chunk][B][6]: partners
  int* s_q = reinterpret_cast<int*>(sp + chunk * B * 6);  // [chunk][B] rows
  int* s_row = s_q + chunk * B;                           // [chunk]
  const int a = blockIdx.x;
  const int start = offsets[a], end = offsets[a + 1];
  const int nout = B * 36;
  const int per_block = 6 * (B + 1);
  T* dst = out + static_cast<long long>(a) * nout;

  for (int o0 = 0; o0 < nout; o0 += THREADS * NACC) {
    T acc[NACC];
#pragma unroll
    for (int t = 0; t < NACC; ++t) acc[t] = T(0);
    for (int c0 = start; c0 < end; c0 += chunk) {
      const int n = min(chunk, end - c0);
      __syncthreads();  // the previous chunk's readers are done
      // (1) rows: the chunk's W blocks and their partners
      for (int e = threadIdx.x; e < n * B; e += THREADS) {
        const int k = e / B, d = e - k * B;
        const int row = perm[c0 + k];
        const int s = slot[row] + d;
        s_q[e] = s < B ? slot_row[static_cast<long long>(lm[row]) * B + s]
                       : -1;
        if (d == 0) s_row[k] = row;
      }
      __syncthreads();
      // (2) values, each load independent of the others
#pragma unroll 4
      for (int e = threadIdx.x; e < n * per_block; e += THREADS) {
        const int k = e / per_block;
        const int rem = e - k * per_block;
        if (rem < 6) {
          const int row = s_row[k];
          su[k * 6 + rem] =
              wb[static_cast<long long>(row) * 6 + rem] * vinv[lm[row]];
        } else {
          const int d = (rem - 6) / 6, j = rem - 6 - 6 * d;
          const int q = s_q[k * B + d];
          sp[(k * B + d) * 6 + j] =
              q >= 0 ? wb[static_cast<long long>(q) * 6 + j] : T(0);
        }
      }
      __syncthreads();
      // (3) the products
#pragma unroll
      for (int t = 0; t < NACC; ++t) {
        const int o = o0 + t * THREADS + threadIdx.x;
        if (o < nout) {
          const int d = o / 36, ij = o - 36 * d, i = ij / 6, j = ij - 6 * i;
          T s = acc[t];
          for (int k = 0; k < n; ++k)
            s += su[k * 6 + i] * sp[(k * B + d) * 6 + j];
          acc[t] = s;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NACC; ++t) {
      const int o = o0 + t * THREADS + threadIdx.x;
      if (o < nout) dst[o] = acc[t];
    }
  }
}

template <typename T>
int launch(const void* wb, const void* vinv, const void* perm,
           const void* offsets, const void* lm, const void* slot,
           const void* slot_row, int P, int B, void* out, void* stream) {
  if (P < 0 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  int chunk = (48 * 1024) / chunk_bytes<T>(B);
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > MAX_CHUNK) chunk = MAX_CHUNK;
  if (P > 0) {
    band_schur_kernel<T><<<P, THREADS, chunk * chunk_bytes<T>(B),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wb), static_cast<const T*>(vinv),
        static_cast<const int*>(perm), static_cast<const int*>(offsets),
        static_cast<const int*>(lm), static_cast<const int*>(slot),
        static_cast<const int*>(slot_row), B, chunk, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_band_schur_f32(const void* wb, const void* vinv, const void* perm,
                      const void* offsets, const void* lm, const void* slot,
                      const void* slot_row, int P, int B, void* out,
                      void* stream) {
  return launch<float>(wb, vinv, perm, offsets, lm, slot, slot_row, P, B, out,
                       stream);
}

int ba_band_schur_f64(const void* wb, const void* vinv, const void* perm,
                      const void* offsets, const void* lm, const void* slot,
                      const void* slot_row, int P, int B, void* out,
                      void* stream) {
  return launch<double>(wb, vinv, perm, offsets, lm, slot, slot_row, P, B,
                        out, stream);
}

}  // extern "C"
