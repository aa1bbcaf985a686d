// K8a: the chunk layout of the banded solver, in one launch.
//
// Input: the assembled band (P, B, D, D), band[p, d] = S[p, p + d], of F
// windows of P_w poses each (P = F P_w).  Output:
//
//   scal (P, D)          s = rsqrt(max(diag S, 1e-12)), the Jacobi scaling;
//   band_s (P, B, D, D)  band_s[p, d, i, j] = (band[p, d, i, j] s[p, i])
//                        s[min(p + d, P - 1), j], plus eps on the diagonal
//                        (kernel 9 multiplies by it in the PCG);
//   Dg, Eg (F, m, n, n)  per window the diagonal chunk blocks and the
//                        coupling of each chunk to the next, n = chunk D,
//                        the window padded with identity poses to n_c whole
//                        chunks and, when m > n_c (cyclic reduction, m a
//                        power of two), with identity chunks (Dg) and zero
//                        couplings (Eg).
//
// Replaces the TPU formulation of ba_tpu/solver/banded.py:banded_pcg_solve
// (:631-656: the scaling, eps and the pad of each window) and
// _chunk_windows (:245-267: the pad and flat-reshape placement of the
// scaled band into dense chunk windows, then upper + upper^T - diagonal),
// and the identity padding of _bcr_factor (:342-348).
//
// Design: one block of 256 threads per tile (window f, chunk c, row pose k
// of the chunk, a = c chunk + k; virtual pose pv = f P_w + a), 32-bit
// index math inside the tile, D a template parameter (9, and a generic
// instantiation).  A tile of a real chunk stages in shared memory, with
// coalesced loads of the raw band:
//   * the scales of poses pv - (B - 1) .. pv + (B - 1), clamped to the band
//     (each the rsqrt of one diagonal entry, once a tile);
//   * pose a's scaled band row band_s[pv, 0..B-1] (identity past P_w);
//   * the blocks band_s[pv - d, d], d = 1 .. min(B - 1, k), that the lower
//     triangle of the tile's Dg rows mirrors.
// It then writes pose a's band_s row and scal, and the D rows of Dg and of
// Eg that pose a owns, contiguous, 16 bytes a store when n is a multiple
// of 16 bytes.  A tile of a padding chunk (c >= n_c) only writes identity
// rows of Dg and zero rows of Eg, 16 bytes a store.
//
// Every output is the plain version's element for element
// (banded.jacobi_scaled + chunk_system): the two products, then eps,
// through the _rn intrinsics (no FMA contraction); a diagonal block of Dg
// as (u + u^T) - u; rsqrt from the CUDA math library, as torch.rsqrt's on
// the card.
//
// Bound on an H100: bytes.  At the long trajectory (P = 2,048, B = 24, D =
// 9, chunks of 24 poses, 86 real chunks padded to 128 of n = 216, f32) it
// reads the 15.9 MB band and writes band_s (15.9 MB) and Dg and Eg (47.8
// MB), ~24 us at 3.35 TB/s.  A band block is read twice (as a row and,
// from L2, mirrored), a diagonal entry by 2 B - 1 tiles.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
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

struct Geom {
  int P, B, D, F, Pw, chunk, nc, m, n;
};

template <typename T>
struct alignas(16) Unit {
  T v[16 / sizeof(T)];
};

// writes `count` values of `value(e)` to dst[0 .. count), 16 bytes a store
// when `vec` (dst 16-byte aligned, count a multiple of the unit)
template <typename T, typename F>
__device__ __forceinline__ void write_out(T* __restrict__ dst, int count,
                                          bool vec, F value) {
  constexpr int U = 16 / sizeof(T);
  if (vec) {
    Unit<T>* d = reinterpret_cast<Unit<T>*>(dst);
    for (int u = threadIdx.x; u < count / U; u += THREADS) {
      Unit<T> o;
#pragma unroll
      for (int h = 0; h < U; ++h) o.v[h] = value(u * U + h);
      d[u] = o;
    }
  } else {
    for (int e = threadIdx.x; e < count; e += THREADS) dst[e] = value(e);
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
    chunk_layout_kernel(const T* __restrict__ band, Geom g, T eps,
                        T* __restrict__ band_s, T* __restrict__ scal,
                        T* __restrict__ Dg, T* __restrict__ Eg) {
  const int D = DT > 0 ? DT : g.D;
  constexpr int U = 16 / sizeof(T);
  const int B = g.B, n = g.n, DD = D * D, BDD = B * DD;
  const int k = blockIdx.x % g.chunk;
  const int fc = blockIdx.x / g.chunk;          // f m + c
  const int c = fc % g.m, f = fc / g.m;
  const long long rows0 = (static_cast<long long>(fc) * n + k * D) * n;
  T* dg = Dg + rows0;
  T* eg = Eg + rows0;
  const int count = D * n;                      // the tile's D rows
  const bool vec_rows = n % U == 0;

  if (c >= g.nc) {                              // a padding chunk
    const int r0 = k * D;
    write_out(dg, count, vec_rows,
              [&](int e) { return e / n + r0 == e % n ? T(1) : T(0); });
    write_out(eg, count, vec_rows, [](int) { return T(0); });
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);       // (2 B - 1) x D scales
  T* row = sc + (2 * B - 1) * D;                // B x D x D: band_s[pv]
  T* below = row + BDD;                         // (B - 1) x D x D:
  //                                               band_s[pv - d, d]
  const int a = c * g.chunk + k;
  const bool real = a < g.Pw;
  const int pv = f * g.Pw + a;
  const int nb = k < B - 1 ? k : B - 1;         // mirrored blocks
  const int tid = threadIdx.x;
  const T lo = static_cast<T>(1e-12);

  // raw loads: the diagonal entries of the scales, pose a's band row and
  // the mirrored blocks
  for (int t = tid; t < (2 * B - 1) * D; t += THREADS) {
    const int q = t / D, i = t - q * D;
    int p = pv - (B - 1) + q;
    p = p < 0 ? 0 : (p > g.P - 1 ? g.P - 1 : p);
    const T d = band[static_cast<long long>(p) * BDD + i * D + i];
    sc[t] = rsqrt(d < lo ? lo : d);             // a NaN stays NaN
  }
  if (real) {
    const T* src = band + static_cast<long long>(pv) * BDD;
    for (int e = tid; e < BDD; e += THREADS) row[e] = src[e];
  }
  for (int t = tid; t < nb * DD; t += THREADS) {
    const int d = t / DD + 1;
    below[t] = a - d < g.Pw
                   ? band[(static_cast<long long>(pv - d) * B + d) * DD + t
                          - (d - 1) * DD]
                   : T(0);
  }
  __syncthreads();

  // scale in place: band_s[pv, d, i, j] = (band s[pv, i]) s[min(pv + d,
  // P - 1), j] (+ eps at d = 0); band_s[pv - d, d, jj, ii] = (band
  // s[pv - d, jj]) s[pv, ii]
  const T* s_at = sc + (B - 1) * D;             // the scales of pose pv
  for (int e = tid; e < BDD; e += THREADS) {
    const int d = e / DD, ij = e - d * DD;
    const int i = ij / D, j = ij - i * D;
    T r;
    if (real) {
      r = mul_rn(mul_rn(row[e], s_at[i]), s_at[d * D + j]);
      if (d == 0) r = add_rn(r, i == j ? eps : T(0));
    } else {
      r = d == 0 && i == j ? T(1) : T(0);
    }
    row[e] = r;
  }
  for (int t = tid; t < nb * DD; t += THREADS) {
    const int d = t / DD + 1, ij = t - (d - 1) * DD;
    const int jj = ij / D, ii = ij - jj * D;
    if (a - d < g.Pw)
      below[t] = mul_rn(mul_rn(below[t], s_at[-d * D + jj]), s_at[ii]);
  }
  __syncthreads();

  if (real) {
    write_out(band_s + static_cast<long long>(pv) * BDD, BDD,
              BDD % U == 0, [&](int e) { return row[e]; });
    if (tid < D) scal[static_cast<long long>(pv) * D + tid] = s_at[tid];
  }
  // Dg rows k D + i: pose a's band row above the diagonal block, the
  // mirrored blocks below it
  write_out(dg, count, vec_rows, [&](int e) {
    const int i = e / n, q = e - i * n;
    const int k2 = q / D, j = q - k2 * D;
    if (k2 > k) return k2 - k < B ? row[(k2 - k) * DD + i * D + j] : T(0);
    if (k2 < k)
      return k - k2 < B ? below[(k - k2 - 1) * DD + j * D + i] : T(0);
    const T u = row[i * D + j];
    return sub_rn(add_rn(u, row[j * D + i]), u);
  });
  // Eg rows k D + i: the coupling of pose a to the next chunk
  write_out(eg, count, vec_rows, [&](int e) {
    const int i = e / n, q = e - i * n;
    const int k2 = q / D, j = q - k2 * D;
    const int d = g.chunk + k2 - k;
    return d < B ? row[d * DD + i * D + j] : T(0);
  });
}

template <typename T, int DT>
int launch_d(const T* band, const Geom& g, T eps, T* band_s, T* scal, T* Dg,
             T* Eg, cudaStream_t stream) {
  const int smem = ((2 * g.B - 1) * g.D + (2 * g.B - 1) * g.D * g.D)
                   * static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        chunk_layout_kernel<T, DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int blocks = g.F * g.m * g.chunk;
  chunk_layout_kernel<T, DT><<<blocks, THREADS, smem, stream>>>(
      band, g, eps, band_s, scal, Dg, Eg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* band, int P, int B, int D, int F, int chunk, int m,
           double eps, void* band_s, void* scal, void* Dg, void* Eg,
           void* stream) {
  if (P < 1 || B < 1 || D < 1 || F < 1 || P % F || chunk < B - 1
      || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.P = P;
  g.B = B;
  g.D = D;
  g.F = F;
  g.Pw = P / F;
  g.chunk = chunk;
  g.nc = (g.Pw + chunk - 1) / chunk;
  g.m = m;
  g.n = chunk * D;
  // 32-bit index math inside a tile, the grid in one dimension
  if (m < g.nc || static_cast<long long>(F) * m * chunk >= (1LL << 31)
      || static_cast<long long>(g.n) * g.n >= (1LL << 31)
      || static_cast<long long>(B) * D * D >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* b = static_cast<const T*>(band);
  T* bs = static_cast<T*>(band_s);
  T* sc = static_cast<T*>(scal);
  T* dg = static_cast<T*>(Dg);
  T* eg = static_cast<T*>(Eg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 9)
    return launch_d<T, 9>(b, g, static_cast<T>(eps), bs, sc, dg, eg, st);
  return launch_d<T, 0>(b, g, static_cast<T>(eps), bs, sc, dg, eg, st);
}

}  // namespace

extern "C" {

// band (P, B, D, D) -> band_s (P, B, D, D), scal (P, D), Dg and Eg (F, m,
// chunk D, chunk D); every output 16-byte aligned
int ba_chunk_layout_f32(const void* band, int P, int B, int D, int F,
                        int chunk, int m, double eps, void* band_s,
                        void* scal, void* Dg, void* Eg, void* stream) {
  return launch<float>(band, P, B, D, F, chunk, m, eps, band_s, scal, Dg, Eg,
                       stream);
}

int ba_chunk_layout_f64(const void* band, int P, int B, int D, int F,
                        int chunk, int m, double eps, void* band_s,
                        void* scal, void* Dg, void* Eg, void* stream) {
  return launch<double>(band, P, B, D, F, chunk, m, eps, band_s, scal, Dg,
                        Eg, stream);
}

}  // extern "C"
