// Kernel 10: the scaled per-window Schur system of a fused fleet, straight
// from the build's W blocks, with no dense operand.
//
// A fused fleet (core/problem.py:concat_problems) holds F independent
// windows of P_w poses and L_w landmarks, window f owning poses
// [f P_w, (f+1) P_w) and landmarks [f L_w, (f+1) L_w).  Per window, with
// n_w = P_w D:
//
//   S_f   = U_f - W_f V^-1 W_f^T     (n_w x n_w)
//   scal  = rsqrt(max(diag S_f, 1e-12))
//   Ss_f  = S_f scal_i scal_j + eps I
//
// with U_f window f's block of the families-only band (P, B, D, D) (band[p,
// d] = U[p, p + d], masked dims already identity rows), V^-1 the landmarks'
// (L, lm, lm) inverses, and W_f's rows p D + c (c < 6) of local pose p
// nonzero only in the columns of the landmarks that pose sees: W[p D + c,
// l lm + a] = Wb[blk, c, a] with blk = table[f P_w + p, l] (the W block of
// the pose and the window's landmark l, or -1; kernels/fleet_schur.py:
// fleet_plan builds it once per solve, padding blocks left out).
//
// Replaces the TPU formulation ba_tpu/solver/banded.py:
// solve_reduced_fleet_dense (:498-598): its strip scatter of the projection
// rows into a zeroed dense W_T (:550-565), the einsum with V^-1, the batched
// product on the matrix unit, the vmapped band_to_dense of U and the Jacobi
// scaling.  At the fleet (lm 1) the dense W_T is ~85 % zeros and the batched
// product ~5 GFLOP, mostly of zeros; here each tile of Ss walks only the
// landmarks its rows and columns share, as K5 (csrc/schur_finish.cu) does
// for one window, through the same listing and walk (csrc/tile_walk.cuh),
// and W V^-1 W^T never reaches device memory.
//
// Two launches:
//   1. prep: one warp per (window, 32-row range, 32-landmark word) writes
//      that word of the range's bitmask over the window's landmarks
//      (landmark l is set when some pose whose rows c < 6 meet the range
//      has a W block with l), coalesced along the table's landmark axis, a
//      warp ballot; and one warp per (window, pose) sums d_i = U_ii -
//      sum_l (W_i V_l^-1)_b W_ib for the pose's rows over its landmarks in
//      ascending order (its lanes load and form their landmarks' terms at
//      once into shared memory; lanes c < 6 then fold them in order), then
//      writes scal_i.
//   2. tiles: one block of 256 threads per 64 x 64 lower tile of each
//      window walks the landmarks set in both its row and its column masks,
//      in ascending order (listed by warp 0, 1024 at a time).  Each step
//      stages up to 16 / lm landmarks' columns of the tile's rows twice in
//      shared memory: the row operand with V^-1 applied there, the column
//      operand as it is.  A step reads each (pose, landmark) W block of the
//      tile's poses once, through the table (6 lm contiguous values), and
//      spreads it over the pose's rows; the next step's blocks load into
//      registers while this step's are multiplied.
//      A thread accumulates a (4 x 4) patch with plain FMA; the tile then
//      passes through shared memory so that Ss_ij = (U_ij - acc) scal_i
//      scal_j + eps [i = j] for j <= i (U read from the band) and its
//      mirror Ss_ji are both written row by row: Ss is exactly symmetric
//      and every element has one writer.
// Every element sums its landmarks in ascending order with the same
// operations as the prep pass's diagonal (a landmark outside a row's own
// set adds an exact zero, fma(0, x, acc) = acc for finite x), so the tile
// pass's S_ii equals the prep pass's d_i bit for bit, and two launches give
// identical results.  With lm 0 nothing is walked: S = U.
//
// Bound on an H100: bytes.  At the fleet of four flagship windows (F = 4,
// P_w = 128, D = 9, L_w = 497, lm 1, f32) it reads the 4 MB band, the
// ~1 MB W blocks, the 1 MB table and V^-1, and writes Ss (21.2 MB): ~27 MB,
// ~8 us at 3.35 TB/s, against ~0.1 GFLOP of products over shared landmarks.
#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

constexpr int RANGE = 32;      // rows per mask
constexpr int TILE = 64;       // rows and columns per tile
constexpr int RPT = TILE / RANGE;
constexpr int BK = 16;         // landmark columns per step, at most
constexpr int THREADS = 256;   // 16 x 16, a 4 x 4 patch each
constexpr int PT = TILE / 16;
constexpr int LIST = 1024;     // landmarks listed at a time (32 words)

struct Geo {
  int F, P_w, L_w, nl, D, B, nR, LW, ntri;
};

// U_f[i, j] of the window whose first pose is p0, from the band: block
// (p, q) is band[p, q - p] when q >= p, band[q, p - q]^T otherwise, and 0
// past the band
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

constexpr int PREP = 128;      // threads per prep block: 4 warps

template <typename T, int LM>
__global__ void __launch_bounds__(PREP)
    fleet_prep_kernel(const T* __restrict__ wb, const T* __restrict__ vinv,
                      const int* __restrict__ table,
                      const T* __restrict__ band, Geo g,
                      unsigned* __restrict__ mask, T* __restrict__ scal) {
  // a diagonal warp's landmarks: (W_c V^-1)_b and W_cb of its 32 lanes
  __shared__ T sh_s[PREP / 32][32][6 * LM];
  __shared__ T sh_w[PREP / 32][32][6 * LM];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * (PREP / 32) + warp;
  const int n_w = g.P_w * g.D;
  const int nmask = g.F * g.nR * g.LW;
  if (gw < nmask) {
    // one word of one range's bitmask over the window's landmarks
    const int w = gw % g.LW, fr = gw / g.LW;
    const int f = fr / g.nR, R = fr - f * g.nR;
    const int r0 = R * RANGE, r1 = min(n_w, r0 + RANGE) - 1;
    const int plo = r0 / g.D, phi = r1 / g.D;
    const int l = w * 32 + lane;
    int set = 0;
    if (l < g.nl) {
      for (int p = plo; p <= phi; ++p) {
        // pose p's W rows p D .. p D + 5 meet [r0, r1]
        if (p * g.D + 5 < r0) continue;
        set |= table[static_cast<long long>(f * g.P_w + p) * g.L_w + l]
               >= 0;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, set);
    if (lane == 0) mask[static_cast<long long>(fr) * g.LW + w] = bal;
    return;
  }
  const int pw = gw - nmask;
  if (pw >= g.F * g.P_w) return;
  // the pose's diagonal: each lane loads its landmark's W rows and forms
  // (W_c V^-1)_b, all in flight at once; then lanes c < 6 sum their rows
  // over the set landmarks in ascending order with the tile pass's
  // operations
  const int f = pw / g.P_w, p = pw - f * g.P_w;
  const long long trow = static_cast<long long>(pw) * g.L_w;
  T acc = T(0);
  for (int w = 0; w < g.LW; ++w) {
    const int l = w * 32 + lane;
    const int blk = l < g.nl ? table[trow + l] : -1;
    if (blk >= 0) {
      const long long lg = static_cast<long long>(f) * g.L_w + l;
      T v[LM * LM];
#pragma unroll
      for (int e = 0; e < LM * LM; ++e) v[e] = vinv[lg * LM * LM + e];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T wa[LM];
#pragma unroll
        for (int a = 0; a < LM; ++a)
          wa[a] = wb[(static_cast<long long>(blk) * 6 + c) * LM + a];
#pragma unroll
        for (int b = 0; b < LM; ++b) {
          T s = T(0);
#pragma unroll
          for (int a = 0; a < LM; ++a) s = fma(wa[a], v[a * LM + b], s);
          sh_s[warp][lane][c * LM + b] = s;
          sh_w[warp][lane][c * LM + b] = wa[b];
        }
      }
    }
    unsigned bal = __ballot_sync(0xffffffffu, blk >= 0);
    __syncwarp();
    if (lane < 6) {
      while (bal) {
        const int bit = __ffs(bal) - 1;
        bal &= bal - 1;
#pragma unroll
        for (int b = 0; b < LM; ++b)
          acc = fma(sh_s[warp][bit][lane * LM + b],
                    sh_w[warp][bit][lane * LM + b], acc);
      }
    }
    __syncwarp();
  }
  if (lane < g.D) {
    const int i = p * g.D + lane;
    const T d = band_entry(band, f * g.P_w, i, i, g.B, g.D)
                - (lane < 6 ? acc : T(0));
    scal[static_cast<long long>(f) * n_w + i] = scale_of(d);
  }
}

// lm 0: no landmark columns, d_i = U_ii
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fleet_prep_u_kernel(const T* __restrict__ band, Geo g,
                        T* __restrict__ scal) {
  const int n_w = g.P_w * g.D;
  const long long e = blockIdx.x * static_cast<long long>(THREADS)
                      + threadIdx.x;
  if (e >= static_cast<long long>(g.F) * n_w) return;
  const int f = static_cast<int>(e / n_w), i = static_cast<int>(e % n_w);
  scal[e] = scale_of(band_entry(band, f * g.P_w, i, i, g.B, g.D));
}

template <typename T, int LM>
__global__ void __launch_bounds__(THREADS)
    fleet_tile_kernel(const T* __restrict__ wb, const T* __restrict__ vinv,
                      const int* __restrict__ table,
                      const T* __restrict__ band, Geo g, T eps,
                      const unsigned* __restrict__ mask,
                      const T* __restrict__ scal, T* __restrict__ Ss) {
  constexpr int TL = LM > 0 ? BK / LM : 1;     // landmarks per step
  constexpr int PAD = TILE + 4;                // 16-byte rows
  // poses a tile's 64 rows can meet (D >= 6), and a step's items per thread
  constexpr int NPM = TILE / 6 + 2;
  constexpr int NE = (2 * NPM * TL + THREADS - 1) / THREADS;
  __shared__ __align__(16) T stage[2][2][BK][PAD];
  __shared__ int lst[LIST];
  __shared__ int ctl[1];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int lane = t & 31, warp = t >> 5;
  const int n_w = g.P_w * g.D;
  const int f = blockIdx.x / g.ntri;
  const int tile = blockIdx.x - f * g.ntri;
  int bi = static_cast<int>((sqrt(8.0 * tile + 1.0) - 1.0) * 0.5);
  while ((bi + 1) * (bi + 2) / 2 <= tile) ++bi;
  while (bi * (bi + 1) / 2 > tile) --bi;
  const int bj = tile - bi * (bi + 1) / 2;
  const int i0 = bi * TILE, j0 = bj * TILE;
  // a patch wholly past row n_w or above the diagonal is never written
  const bool busy = i0 + ty * PT < n_w && j0 + tx * PT < n_w
                    && !(bi == bj && tx > ty);

  T acc[PT][PT];
#pragma unroll
  for (int a = 0; a < PT; ++a)
#pragma unroll
    for (int b = 0; b < PT; ++b) acc[a][b] = T(0);

  if constexpr (LM > 0) {
    // a step's items: (side, pose of the tile's rows or columns, landmark
    // slot), each one W block (6 lm contiguous values) read through the
    // table once and spread over its pose's rows of the staged operand
    const int pi0 = i0 / g.D, pj0 = j0 / g.D;
    T wblk[NE][6 * LM], vv[NE][LM * LM];
    int gl[NE];
    auto load = [&](int s, int cnt) {
#pragma unroll
      for (int u = 0; u < NE; ++u) {
        const int e = t + u * THREADS;
        const int side = e / (NPM * TL), rem = e - side * (NPM * TL);
        const int pp = rem / TL, l = rem - pp * TL, li = s * TL + l;
        const int p = (side ? pj0 : pi0) + pp;
        const bool ok = e < 2 * NPM * TL && li < cnt && p < g.P_w;
        gl[u] = ok ? lst[li] : -1;
        const int blk = ok ? table[static_cast<long long>(f * g.P_w + p)
                                   * g.L_w + gl[u]] : -1;
#pragma unroll
        for (int k = 0; k < 6 * LM; ++k)
          wblk[u][k] = blk >= 0 ? wb[static_cast<long long>(blk) * 6 * LM
                                     + k] : T(0);
        const long long lg = static_cast<long long>(f) * g.L_w + gl[u];
#pragma unroll
        for (int e2 = 0; e2 < LM * LM; ++e2)
          vv[u][e2] = ok ? vinv[lg * LM * LM + e2] : T(0);
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int u = 0; u < NE; ++u) {
        const int e = t + u * THREADS;
        if (e >= 2 * NPM * TL) continue;
        const int side = e / (NPM * TL), rem = e - side * (NPM * TL);
        const int pp = rem / TL, l = rem - pp * TL;
        const int r0 = ((side ? pj0 : pi0) + pp) * g.D - (side ? j0 : i0);
        if (r0 >= TILE) continue;
        for (int c = 0; c < g.D; ++c) {
          const int r = r0 + c;
          if (r < 0 || r >= TILE) continue;
#pragma unroll
          for (int b = 0; b < LM; ++b) {
            T v = T(0);
            if (c < 6) {
              if (side == 0) {
                if (gl[u] >= 0) {
#pragma unroll
                  for (int a = 0; a < LM; ++a)
                    v = fma(wblk[u][c * LM + a], vv[u][a * LM + b], v);
                }
              } else {
                v = wblk[u][c * LM + b];
              }
            }
            stage[buf][side][l * LM + b][r] = v;
          }
        }
      }
    };
    const unsigned* mk = mask + static_cast<long long>(f) * g.nR * g.LW;
    for (int w0 = 0; w0 < g.LW; w0 += 32) {
      if (warp == 0)
        ba::tile::list_shared<RPT>(mk, g.nR, g.LW, bi, bj, w0, lane, lst,
                                   ctl);
      __syncthreads();
      // the listed landmarks, in order, staged a step ahead
      ba::tile::walk<TL * LM>(ctl[0], TL, busy, tx, ty, stage, acc, load,
                              store);
    }
  }

  // the tile through shared memory (the staging buffers, free after the
  // walk's last barrier), so both its writes and its mirror's are
  // coalesced: acc, then Ss = (U - acc) scal_i scal_j (+ eps)
  constexpr int TP = TILE + 1;
  static_assert(2 * 2 * BK * PAD >= TILE * TP, "the tile fits the staging");
  T* tl = &stage[0][0][0][0];
#pragma unroll
  for (int a = 0; a < PT; ++a)
#pragma unroll
    for (int b = 0; b < PT; ++b) tl[(ty * PT + a) * TP + tx * PT + b] = acc[a][b];
  __syncthreads();
  T* out = Ss + static_cast<long long>(f) * n_w * n_w;
  const T* sc = scal + static_cast<long long>(f) * n_w;
  const int p0 = f * g.P_w;
  for (int e = t; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e - r * TILE;
    const int gi = i0 + r, gj = j0 + c;
    if (gi >= n_w || gj > gi) continue;
    T v = (band_entry(band, p0, gi, gj, g.B, g.D) - tl[r * TP + c]) * sc[gi]
          * sc[gj];
    if (gj == gi) v += eps;
    out[static_cast<long long>(gi) * n_w + gj] = v;
    tl[r * TP + c] = v;
  }
  __syncthreads();
  // the mirror Ss_ji = Ss_ij, j < i, row by row of the upper triangle
  for (int e = t; e < TILE * TILE; e += THREADS) {
    const int c = e / TILE, r = e - c * TILE;
    const int gi = i0 + r, gj = j0 + c;
    if (gi >= n_w || gj >= gi) continue;
    out[static_cast<long long>(gj) * n_w + gi] = tl[r * TP + c];
  }
}

template <typename T, int LM>
int launch_lm(const void* wb, const void* vinv, const void* table,
              const void* band, const Geo& g, double eps, void* mask,
              void* scal, void* Ss, cudaStream_t st) {
  const int n_w = g.P_w * g.D;
  if constexpr (LM > 0) {
    const int warps = g.F * (g.nR * g.LW + g.P_w);
    const int per = PREP / 32;
    fleet_prep_kernel<T, LM><<<(warps + per - 1) / per, PREP, 0, st>>>(
        static_cast<const T*>(wb), static_cast<const T*>(vinv),
        static_cast<const int*>(table), static_cast<const T*>(band), g,
        static_cast<unsigned*>(mask), static_cast<T*>(scal));
  } else {
    const long long total = static_cast<long long>(g.F) * n_w;
    fleet_prep_u_kernel<T><<<static_cast<int>((total + THREADS - 1)
                                              / THREADS),
                             THREADS, 0, st>>>(
        static_cast<const T*>(band), g, static_cast<T*>(scal));
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  fleet_tile_kernel<T, LM><<<g.F * g.ntri, THREADS, 0, st>>>(
      static_cast<const T*>(wb), static_cast<const T*>(vinv),
      static_cast<const int*>(table), static_cast<const T*>(band), g,
      static_cast<T>(eps), static_cast<const unsigned*>(mask),
      static_cast<const T*>(scal), static_cast<T*>(Ss));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* wb, const void* vinv, const void* table,
           const void* band, int F, int P_w, int L_w, int D, int lm, int B,
           double eps, void* mask, void* scal, void* Ss, void* stream) {
  if (F < 1 || P_w < 1 || L_w < 0 || D < 6 || B < 1
      || (lm != 0 && lm != 1 && lm != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g;
  g.F = F;
  g.P_w = P_w;
  g.L_w = L_w;
  g.nl = lm > 0 ? L_w : 0;
  g.D = D;
  g.B = B;
  const int n_w = P_w * D;
  g.nR = (n_w + RANGE - 1) / RANGE;
  g.LW = (g.nl + 31) / 32;
  const int nb = (n_w + TILE - 1) / TILE;
  g.ntri = nb * (nb + 1) / 2;
  const auto st = static_cast<cudaStream_t>(stream);
  if (lm == 1)
    return launch_lm<T, 1>(wb, vinv, table, band, g, eps, mask, scal, Ss, st);
  if (lm == 3)
    return launch_lm<T, 3>(wb, vinv, table, band, g, eps, mask, scal, Ss, st);
  return launch_lm<T, 0>(wb, vinv, table, band, g, eps, mask, scal, Ss, st);
}

}  // namespace

extern "C" {

// table: (F P_w, L_w) int32; mask: F ceil(n_w / 32) ceil(L_w / 32) words of
// scratch (none with lm 0); Ss (F, n_w, n_w), scal (F, n_w)
int ba_fleet_schur_f32(const void* wb, const void* vinv, const void* table,
                       const void* band, int F, int P_w, int L_w, int D,
                       int lm, int B, double eps, void* mask, void* scal,
                       void* Ss, void* stream) {
  return launch<float>(wb, vinv, table, band, F, P_w, L_w, D, lm, B, eps,
                       mask, scal, Ss, stream);
}

int ba_fleet_schur_f64(const void* wb, const void* vinv, const void* table,
                       const void* band, int F, int P_w, int L_w, int D,
                       int lm, int B, double eps, void* mask, void* scal,
                       void* Ss, void* stream) {
  return launch<double>(wb, vinv, table, band, F, P_w, L_w, D, lm, B, eps,
                        mask, scal, Ss, stream);
}

}  // extern "C"
