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
// and the identity padding of _bcr_factor (:342-348): a few dozen small
// launches and three copies of the band.  Every output element is computed
// by one thread from the raw band, in the plain version's order: the two
// products, then eps; a diagonal block of Dg as (u + u^T) - u.  The _rn
// intrinsics keep the compiler from contracting them into an FMA, and
// rsqrt is the CUDA math library's, as torch.rsqrt's on the card, so every
// output equals the plain version's element for element.
//
// Bound on an H100: bytes.  At the long trajectory (P = 2,048, B = 24, D =
// 9, chunks of 24 poses, 128 chunks of n = 216, f32) it reads the 15.9 MB
// band and writes band_s (15.9 MB) and Dg and Eg (47.8 MB), ~24 us at
// 3.35 TB/s.  Each output recomputes its two scales (two rsqrt), which is
// cheaper than a second pass.
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
__device__ __forceinline__ T scale(const T* band, const Geom& g, int p,
                                   int i) {
  const T d = band[(static_cast<long long>(p) * g.B * g.D + i) * g.D + i];
  const T lo = static_cast<T>(1e-12);
  return rsqrt(d < lo ? lo : d);  // a NaN stays NaN, as in torch.clamp
}

// band_s[p, d, i, j] of a pose of the band
template <typename T>
__device__ __forceinline__ T scaled(const T* band, const Geom& g, T eps,
                                    int p, int d, int i, int j) {
  const long long DD = static_cast<long long>(g.D) * g.D;
  const T v = band[(static_cast<long long>(p) * g.B + d) * DD + i * g.D + j];
  const int up = p + d < g.P ? p + d : g.P - 1;
  T r = mul_rn(mul_rn(v, scale(band, g, p, i)), scale(band, g, up, j));
  if (d == 0) r = add_rn(r, i == j ? eps : T(0));
  return r;
}

// band_s of window f, pose a of its padded poses (identity past P_w)
template <typename T>
__device__ __forceinline__ T windowed(const T* band, const Geom& g, T eps,
                                      int f, int a, int d, int i, int j) {
  if (a >= g.Pw) return d == 0 && i == j ? T(1) : T(0);
  return scaled(band, g, eps, f * g.Pw + a, d, i, j);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    chunk_layout_kernel(const T* __restrict__ band, Geom g, T eps,
                        T* __restrict__ band_s, T* __restrict__ scal,
                        T* __restrict__ Dg, T* __restrict__ Eg) {
  const long long n_scal = static_cast<long long>(g.P) * g.D;
  const long long n_band = n_scal * g.B * g.D;
  const long long nn = static_cast<long long>(g.n) * g.n;
  const long long n_win = static_cast<long long>(g.F) * g.m * nn;
  const long long total = n_scal + n_band + 2 * n_win;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS)
                     + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * THREADS) {
    if (e < n_scal) {
      const int p = static_cast<int>(e / g.D);
      scal[e] = scale(band, g, p, static_cast<int>(e - p * g.D));
      continue;
    }
    long long x = e - n_scal;
    if (x < n_band) {
      const int j = static_cast<int>(x % g.D);
      long long y = x / g.D;
      const int i = static_cast<int>(y % g.D);
      y /= g.D;
      const int d = static_cast<int>(y % g.B);
      const int p = static_cast<int>(y / g.B);
      band_s[x] = scaled(band, g, eps, p, d, i, j);
      continue;
    }
    x -= n_band;
    const bool diag = x < n_win;
    if (!diag) x -= n_win;
    const long long w = x / nn;  // f * m + c
    const long long rc = x - w * nn;
    const int f = static_cast<int>(w / g.m), c = static_cast<int>(w % g.m);
    const int r = static_cast<int>(rc / g.n), q = static_cast<int>(rc % g.n);
    const int k = r / g.D, i = r - k * g.D;
    const int k2 = q / g.D, j = q - k2 * g.D;
    const int a = c * g.chunk + k;  // pose of the row in its window
    T v = T(0);
    if (diag) {
      if (c >= g.nc) {
        v = r == q ? T(1) : T(0);
      } else if (k2 > k) {
        if (k2 - k < g.B) v = windowed(band, g, eps, f, a, k2 - k, i, j);
      } else if (k2 < k) {
        if (k - k2 < g.B)
          v = windowed(band, g, eps, f, c * g.chunk + k2, k - k2, j, i);
      } else {
        const T u = windowed(band, g, eps, f, a, 0, i, j);
        v = sub_rn(add_rn(u, windowed(band, g, eps, f, a, 0, j, i)), u);
      }
      Dg[x] = v;
    } else {
      const int d = g.chunk + k2 - k;
      if (c < g.nc && d < g.B) v = windowed(band, g, eps, f, a, d, i, j);
      Eg[x] = v;
    }
  }
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
  if (m < g.nc) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(P) * D * (1 + B * D)
                          + 2LL * F * m * g.n * g.n;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  chunk_layout_kernel<T><<<static_cast<int>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(band), g, static_cast<T>(eps),
      static_cast<T*>(band_s), static_cast<T*>(scal), static_cast<T*>(Dg),
      static_cast<T*>(Eg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// band (P, B, D, D) -> band_s (P, B, D, D), scal (P, D), Dg and Eg (F, m,
// chunk D, chunk D)
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
