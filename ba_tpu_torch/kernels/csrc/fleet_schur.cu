// Kernel 10: the per-window Schur system of a fused fleet, the parts of the
// dense fleet solve that are neither a matrix product nor a factorization.
//
// A fused fleet (core/problem.py:concat_problems) holds F independent
// windows of P_w poses and L_w landmarks, window f owning poses
// [f P_w, (f+1) P_w) and landmarks [f L_w, (f+1) L_w).  Per window, with
// n_w = P_w D:
//
//   (a) fleet_w: the W operands, from the unique (pose, landmark) W blocks
//       Wb (Nw, 6, lm) of the build and the landmark inverses V^-1:
//         W_T  [f, l lm + a, p D + c] = Wb_{p,l}[c, a]           (c < 6)
//         WVi_T[f, l lm + a, p D + c] = sum_m V_l^-1[a, m] Wb_{p,l}[c, m]
//       and 0 everywhere else (c >= 6, or no block), both (F, L_w lm, n_w).
//   (b) fleet_epilogue: after C = WVi_T^T W_T (a batched product, cuBLAS),
//         S  = U_f - C,  with U_f window f's block of the families-only band
//              (P, B, D, D) densified on the fly (band[p, d] = U[p, p + d],
//              masked dims already identity),
//         d_i = S_ii,  scal_i = rsqrt(max(d_i, 1e-12)),
//         Ss_ij = S_ij scal_i scal_j + eps [i == j],
//       written as Ss (F, n_w, n_w) and scal (F, n_w), in one pass.
//
// Replaces the TPU formulation ba_tpu/solver/banded.py:
// solve_reduced_fleet_dense (:498-598): its strip scatter of ~2 Nr rows into
// a zeroed W_T (:550-565, profiled there at 6.4-9 ms), the einsum with V^-1,
// the vmapped band_to_dense and the scaling, each a pass through device
// memory.
//
// (a): `block_of` (F L_w P_w,) int32 gives the W block of (global landmark
// l, local pose p), or -1; it is built once per solve (kernels/
// fleet_schur.py, fleet_plan), and padding blocks (landmark id L) are left
// out of it.  One thread per output element: each element has exactly one
// writer and no atomics, the writes are coalesced along the pose axis, and
// the zeros are written in the same pass (no memset).
// (b): one thread per element of Ss; it reads C_ij, C_ii, C_jj and the three
// band entries of U_ij, U_ii, U_jj (the band and the diagonal stay in L2),
// so the scaling needs no second pass.
//
// Bound on an H100: bytes.  At the fleet of four flagship windows (F = 4,
// P_w = 128, D = 9, L_w = 497, f32): (a) writes 2 x 9.2 MB and reads the
// 1 MB W blocks and the 1 MB table, ~5.8 us at 3.35 TB/s; (b) reads C
// (21.2 MB) and the 4 MB band and writes Ss (21.2 MB), ~14 us.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fleet_w_kernel(const T* __restrict__ wb, const T* __restrict__ vinv,
                   const int* __restrict__ block_of, int L_w, int P_w, int D,
                   int lm, long long total, T* __restrict__ wt,
                   T* __restrict__ wvit) {
  const int n_w = P_w * D;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * THREADS) {
    const int col = static_cast<int>(e % n_w);
    const long long row = e / n_w;                  // (f L_w + l) lm + a
    const int a = static_cast<int>(row % lm);
    const long long lg = row / lm;                  // global landmark
    const int p = col / D, c = col - p * D;
    T w = T(0), wv = T(0);
    if (c < 6) {
      const int blk = block_of[lg * P_w + p];
      if (blk >= 0) {
        const T* b = wb + (static_cast<long long>(blk) * 6 + c) * lm;
        const T* vi = vinv + (lg * lm + a) * lm;
        w = b[a];
        for (int m = 0; m < lm; ++m) wv += vi[m] * b[m];
      }
    }
    wt[e] = w;
    wvit[e] = wv;
  }
}

// U_f[i, j] of window f from the band: block (p, q) is band[p, q - p] when
// q >= p, band[q, p - q]^T otherwise, and 0 past the band.
template <typename T>
__device__ __forceinline__ T band_entry(const T* __restrict__ band, int p0,
                                        int i, int j, int B, int D) {
  int p = i / D, a = i - p * D, q = j / D, b = j - q * D;
  if (q < p) {
    int t = p; p = q; q = t;
    t = a; a = b; b = t;
  }
  const int d = q - p;
  if (d >= B) return T(0);
  return band[((static_cast<long long>(p0 + p) * B + d) * D + a) * D + b];
}

// rsqrt(max(v, 1e-12)), NaN kept as torch.clamp keeps it
__device__ __forceinline__ float scale_of(float v) {
  return rsqrtf(v != v || v > 1e-12f ? v : 1e-12f);
}
__device__ __forceinline__ double scale_of(double v) {
  return rsqrt(v != v || v > 1e-12 ? v : 1e-12);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fleet_epilogue_kernel(const T* __restrict__ band, const T* __restrict__ C,
                          int P_w, int B, int D, T eps, long long total,
                          T* __restrict__ Ss, T* __restrict__ scal) {
  const int n_w = P_w * D;
  const long long nn = static_cast<long long>(n_w) * n_w;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * THREADS) {
    const int f = static_cast<int>(e / nn);
    const long long rem = e - f * nn;
    const int i = static_cast<int>(rem / n_w);
    const int j = static_cast<int>(rem - static_cast<long long>(i) * n_w);
    const int p0 = f * P_w;
    const T* Cf = C + f * nn;
    const T s = band_entry(band, p0, i, j, B, D) - Cf[rem];
    const T di = band_entry(band, p0, i, i, B, D) -
                 Cf[static_cast<long long>(i) * n_w + i];
    const T dj = band_entry(band, p0, j, j, B, D) -
                 Cf[static_cast<long long>(j) * n_w + j];
    const T si = scale_of(di);
    const T sj = scale_of(dj);
    T v = s * si * sj;
    if (i == j) {
      v += eps;
      scal[static_cast<long long>(f) * n_w + i] = si;
    }
    Ss[e] = v;
  }
}

int grid_of(long long total) {
  long long blocks = (total + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int launch_w(const void* wb, const void* vinv, const void* block_of, int F,
             int L_w, int P_w, int D, int lm, void* wt, void* wvit,
             void* stream) {
  if (F < 1 || L_w < 0 || P_w < 1 || D < 6 || lm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(F) * L_w * lm * P_w * D;
  if (total > 0) {
    fleet_w_kernel<T><<<grid_of(total), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wb), static_cast<const T*>(vinv),
        static_cast<const int*>(block_of), L_w, P_w, D, lm, total,
        static_cast<T*>(wt), static_cast<T*>(wvit));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_epilogue(const void* band, const void* C, int F, int P_w, int B,
                    int D, double eps, void* Ss, void* scal, void* stream) {
  if (F < 1 || P_w < 1 || B < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_w = static_cast<long long>(P_w) * D;
  const long long total = F * n_w * n_w;
  fleet_epilogue_kernel<T><<<grid_of(total), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(band), static_cast<const T*>(C), P_w, B, D,
      static_cast<T>(eps), total, static_cast<T*>(Ss), static_cast<T*>(scal));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_fleet_w_f32(const void* wb, const void* vinv, const void* block_of,
                   int F, int L_w, int P_w, int D, int lm, void* wt,
                   void* wvit, void* stream) {
  return launch_w<float>(wb, vinv, block_of, F, L_w, P_w, D, lm, wt, wvit,
                         stream);
}

int ba_fleet_w_f64(const void* wb, const void* vinv, const void* block_of,
                   int F, int L_w, int P_w, int D, int lm, void* wt,
                   void* wvit, void* stream) {
  return launch_w<double>(wb, vinv, block_of, F, L_w, P_w, D, lm, wt, wvit,
                          stream);
}

int ba_fleet_epilogue_f32(const void* band, const void* C, int F, int P_w,
                          int B, int D, double eps, void* Ss, void* scal,
                          void* stream) {
  return launch_epilogue<float>(band, C, F, P_w, B, D, eps, Ss, scal, stream);
}

int ba_fleet_epilogue_f64(const void* band, const void* C, int F, int P_w,
                          int B, int D, double eps, void* Ss, void* scal,
                          void* stream) {
  return launch_epilogue<double>(band, C, F, P_w, B, D, eps, Ss, scal,
                                 stream);
}

}  // extern "C"
