// K8b: the factor of the chunked block-tridiagonal system of the banded
// solver.  The system (F windows of m chunks, n x n blocks) is
//
//   E_{i-1}^T x_{i-1} + D_i x_i + E_i x_{i+1} = b_i,
//
// D (F, m, n, n) the diagonal chunk blocks, E (F, m, n, n) the coupling of
// each chunk to the next (chunk_layout.cu writes both).
//
// Replaces the TPU formulations ba_tpu/solver/banded.py:_bcr_factor
// (:307-366) and _factor (:270-293), batched Choleskys, triangular solves
// and products that XLA launches one by one.
//
// Cyclic reduction with explicit triangular inverses, three launches per
// level plus one for the base block.  For each eliminated chunk k (Dodd_k
// = D_{2k+1}, A_k = E_{2k}, B_k = E_{2k+1}):
//   (1) bcr_chol_inv, one block per chunk: Li_k = chol(Dodd_k)^-1;
//   (2) bcr_products, one block per 32 x 32 output tile: W_k = Li_k A_k^T
//       and V_k = Li_k B_k;
//   (3) bcr_reduce, one block per 32 x 32 output tile: the lower tiles of
//       D'_k = (D_2k - V_{k-1}^T V_{k-1}) - W_k^T W_k and E'_k = -W_k^T V_k.
// A Dodd^-1 A^T = W^T W, B^T Dodd^-1 B = V^T V and A Dodd^-1 B = W^T V, so
// this is ba_tpu's recurrence in exact arithmetic, its Schur update in
// symmetric form; the level keeps (Li, W, V) and K8c's solve is mat-vecs
// only (chunk_solve.cu).  The base block's Li0 is (1) once more.
//
// Padding: chunks at or past `live` are identity with zero couplings
// (chunk_layout.cu's pad to a power of two), so a level of r chunks that
// are not such dead chunks (r = live + 1 at the top, ceil(r / 2) below)
// eliminates h = floor(r / 2) of them and keeps rn = r - h; only V_k and
// E'_k for k < rn - 1 are ever read, and nothing is computed for the dead
// chunks.
//
// bcr_chol_inv is the serial part: a Cholesky and a triangular inverse in
// one in-place sweep by panels of 32 columns over M (n x n), with the
// panel staged k-major in U (32 x n); both sit in shared memory when they
// fit (f32 at n = 216: 215,136 B, M with an odd row stride) and M in the
// output in device memory otherwise (f64 at n = 216).  512 threads in f32,
// 256 in f64.  For the panel J = [j0, j1), P = [0, j0) done, T = [j1, n)
// trailing:
//   warp 0 has swept the Schur complement's 32 x 32 diagonal tile into
//       Li_JJ (lane i holding row i in registers);
//   U over P = rows J of the inverse, Li_JJ Y_J; U over J = Li_JJ; U over
//       T = L_TJ^T, L_TJ = S_TJ Li_JJ^T (8 outputs a thread);
//   the trailing update by 4 x 4 register patches from U: M[T, c] -= L_TJ
//       U[:, c] over P and the lower triangle of T, M[T, J] = -L_TJ Li_JJ;
//       warp 0 takes the next panel's diagonal tile first and sweeps it
//       while the warps on the other three schedulers do the rest.
// bcr_products and bcr_reduce are tiles of 32 x 32 by 64 threads, 4 x 4
// outputs each, the operands' 32-deep slices double-buffered in shared
// memory by cp.async; a product over the lower triangle of Li stops at
// the tile's last row.  A non-positive or non-finite pivot or a
// non-finite entry of Li sets fail[0] on the device, with no host read.
//
// Bound on an H100: operations, 6.7 n^3 flop per eliminated chunk (n^3 / 3
// each for the Cholesky and the inverse, n^3 each for W and V, n^3 for each
// symmetric product, 2 n^3 for E') over the chunks that are not padding:
// at the long trajectory (P = 2,048, chunks of 24 poses, n = 216, 86
// chunks, levels of 87, 44, 22, 11, 6, 3, 2 chunks) 5.62 GFLOP, 0.084 ms
// at 67 TFLOP/s f32 (chip_smoke.py's k8_work).  What holds it back: the
// seven inner levels eliminate five chunks or fewer, so a level's time is
// one block's bcr_chol_inv (a chain of seven panels, each a 32-step sweep
// on one warp, then the panel products and the trailing update on the
// block), and the single tiles of the products; one block per chunk does
// not use the card there.  Every sum runs in a fixed order, so two
// launches are bit-identical; products are plain FMA (no tensor core, so
// TF32 never enters).
//
// The scan (scan_factor) steps one block per window through the chunks
// with chunk_blas.cuh's blocked routines: X = C_{i-1}^-1 E_{i-1}, M_i =
// X^T, C_i = chol(D_i - X^T X).
#include <cuda_pipeline.h>

#include "chunk_blas.cuh"

namespace {

using chunk::Mat;
using chunk::THREADS;
using chunk::Tiles;
using chunk::TS;

constexpr unsigned FULL = 0xffffffffu;
// bcr_chol_inv's block: 512 threads in f32 (up to 128 registers each),
// 256 in f64 (the rows of the diagonal sweep take twice the registers)
template <typename T>
__host__ __device__ constexpr int ci_threads() {
  return sizeof(T) == 4 ? 512 : 256;
}

// 1 / sqrt(d): in f32 the hardware estimate and one Newton step (within
// an ulp or two of the plain version's 1 / sqrt), in f64 1 / sqrt
__device__ __forceinline__ float rsqrt_fast(float d) {
  const float r = rsqrtf(d);
  return r * fmaf(-0.5f * d * r, r, 1.5f);
}
__device__ __forceinline__ double rsqrt_fast(double d) {
  return 1.0 / sqrt(d);
}

// v[0..4) = p[0..4), 16-byte loads (p 16-byte aligned)
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const double2 q0 = *reinterpret_cast<const double2*>(p);
    const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
    v[0] = q0.x;
    v[1] = q0.y;
    v[2] = q1.x;
    v[3] = q1.y;
  }
}

// p[0..4) = v[0..4), 16-byte stores (p 16-byte aligned)
template <typename T>
__device__ __forceinline__ void store4(T* p, T a, T b, T c, T d) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(a, b);
    *reinterpret_cast<double2*>(p + 2) = make_double2(c, d);
  }
}

// Warp 0: the 32 x 32 diagonal tile of M at (j0, j0) (its lower
// triangle, nb x nb, identity past nb) -> chol(tile)^-1, in place in M,
// in G and transposed in Gt.  Lane i holds row i in registers.  Step j
// takes the pivot's r = 1 / sqrt(d), puts the column below it (l_i = g_i[j]
// r, one value a lane) in wl, and updates every row below j: columns c < j
// by (l_i r) times row j as it stood (raw, which lane j stored in wraw the
// step before, the buffers alternating), columns c > j by l_i l_c, column
// j to -l_i r; the next pivot's lane then stores its row, final, raw.  Row
// j is u = raw r (the inverse's row) and is scaled by its lane once at the
// end.  Four steps are unrolled and the rows rotate by four registers after
// them (g[p] holds column (4 it + p) % 32), so indices stay static
template <typename T>
__device__ void diag_inverse(T* M, long long ldm, int j0, int nb,
                             T (*G)[TS + 1], T (*Gt)[TS + 4], T* wl,
                             T (*wraw)[TS], int* fail) {
  const int lane = threadIdx.x & 31;
  T g[TS];
#pragma unroll
  for (int k = 0; k < TS; ++k) {
    T v = k == lane ? T(1) : T(0);
    if (lane < nb && k < nb && k <= lane) v = M[(j0 + lane) * ldm + j0 + k];
    g[k] = v;
  }
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < TS / 4; ++m)
      store4(wraw[0] + 4 * m, g[4 * m], g[4 * m + 1], g[4 * m + 2],
             g[4 * m + 3]);
  __syncwarp();
  bool bad_pivot = false;
  T rs_own = T(1);
#pragma unroll 1
  for (int it = 0; it < TS / 4; ++it) {
    const int c0 = 4 * it;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = c0 + q;
      const T* raw = wraw[j & 1];
      const T d = __shfl_sync(FULL, g[q], j);
      bad_pivot |= j < nb && !(d > T(0) && !chunk::bad(d));
      const T rs = rsqrt_fast(d);
      const T wi = g[q] * rs;                  // l_i on the lanes below j
      if (lane == j) rs_own = rs;
      if (lane > j) wl[lane] = wi;
      __syncwarp();
      if (lane > j) {
        // columns c < j: raw row j times wi r; c > j: l_c; entries past
        // the diagonal take updates too: never read, written out as zeros
        const T wirs = wi * rs;
        T w[TS];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = r < q ? raw[c0 + r] : r > q ? wl[c0 + r] : T(0);
#pragma unroll
        for (int m = 1; m < TS / 4; ++m) {
          const int c = (c0 + 4 * m) & (TS - 1);
          load4((c < c0 ? raw : wl) + c,
                reinterpret_cast<T(&)[4]>(w[4 * m]));
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r != q) g[r] = fma(-(r < q ? wirs : wi), w[r], g[r]);
#pragma unroll
        for (int m = 1; m < TS / 4; ++m) {
          const T coef = c0 + 4 * m >= TS ? wirs : wi;
#pragma unroll
          for (int r = 4 * m; r < 4 * m + 4; ++r)
            g[r] = fma(-coef, w[r], g[r]);
        }
        g[q] = -(wi * rs);
        if (lane == j + 1) {
          T* nxt = wraw[(j + 1) & 1];
#pragma unroll
          for (int m = 0; m < TS / 4; ++m)
            store4(nxt + ((c0 + 4 * m) & (TS - 1)), g[4 * m], g[4 * m + 1],
                   g[4 * m + 2], g[4 * m + 3]);
        }
      }
      __syncwarp();
    }
    const T r0 = g[0], r1 = g[1], r2 = g[2], r3 = g[3];
#pragma unroll
    for (int p = 0; p < TS - 4; ++p) g[p] = g[p + 4];
    g[TS - 4] = r0;
    g[TS - 3] = r1;
    g[TS - 2] = r2;
    g[TS - 1] = r3;
  }
  if (lane == 0 && bad_pivot) *fail = 1;
#pragma unroll
  for (int k = 0; k < TS; ++k) {
    const T v = k < lane ? g[k] * rs_own : k == lane ? rs_own : T(0);
    G[lane][k] = v;
    Gt[k][lane] = v;
    if (lane < nb && k < nb) M[(j0 + lane) * ldm + j0 + k] = v;
  }
}

// the row stride of the staged panel U (16-byte rows)
__host__ __device__ inline int panel_ld(int n) { return (n + 3) & ~3; }

// One block per (eliminated chunk k, window f): Li[f, k] = chol(S)^-1 of
// the lower triangle of S = D[f, c0 + cstep k] (D holds m chunks per
// window); the strict upper triangle of Li is zero.  M (n x n, row stride
// ldm) is the working matrix, U (TS x panel_ld(n)) the panel staged
// k-major: U[t][c] = row j0 + t of the inverse over the columns P,
// Li_JJ[t][c - j0] over J, L_TJ[c][t] over T.  Each lies in shared memory
// when the launch gave room for it (m_smem, u_smem), else in Li's own
// block (M) and in the workspace ws (U)
template <typename T>
__global__ void __launch_bounds__(ci_threads<T>(), 1)
    bcr_chol_inv(const T* __restrict__ D, int m, int c0, int cstep, int n,
                 T* __restrict__ Li, T* __restrict__ ws,
                 int* __restrict__ fail, int m_smem, int u_smem) {
  constexpr int NT = ci_threads<T>(), NW = NT / 32;
  __shared__ T Ls[TS][TS + 1];
  __shared__ __align__(16) T Lt[TS][TS + 4];
  __shared__ __align__(16) T wl[TS];
  __shared__ __align__(16) T wraw[2][TS];
  extern __shared__ __align__(16) unsigned char dyn[];
  const int k = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long blk = static_cast<long long>(f) * gridDim.x + k;
  const long long nn = static_cast<long long>(n) * n;
  const T* S = D + (static_cast<long long>(f) * m + c0 +
                    static_cast<long long>(cstep) * k) * nn;
  T* out = Li + blk * nn;
  const int ldu = panel_ld(n);
  T* U = u_smem ? reinterpret_cast<T*>(dyn) : ws + blk * TS * ldu;
  const int ldm = m_smem ? (n | 1) : n;             // odd: no bank conflict
  T* M = m_smem ? reinterpret_cast<T*>(dyn) + (u_smem ? TS * ldu : 0) : out;
  // M = S (the sweep reads only the lower triangle, and the upper one is
  // written out as zeros), the copies all in flight at once
  for (int i = warp; i < n; i += NW)
    for (int c = lane; c < n; c += 32) {
      const T* src = S + static_cast<long long>(i) * n + c;
      if (m_smem) __pipeline_memcpy_async(M + i * ldm + c, src, sizeof(T));
      else M[i * ldm + c] = *src;
    }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (warp == 0) diag_inverse(M, ldm, 0, min(TS, n), Ls, Lt, wl, wraw, fail);
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += TS) {
    const int nb = min(TS, n - j0), j1 = j0 + nb;
    // U over J: Li_JJ
    for (int e = tid; e < TS * nb; e += NT) {
      const int t = e / nb, a = e - t * nb;
      U[t * ldu + j0 + a] = t < nb ? Ls[t][a] : T(0);
    }
    // U over P: rows J of the inverse, Li_JJ Y_J; U over T: L_TJ^T, L_TJ =
    // S_TJ Li_JJ^T (a trailing panel is whole: nb = 32); 8 outputs a
    // thread, column or row e, outputs 8 ab..
    const int ncol = j0 + n - j1;
    for (int it = tid; it < 4 * ncol; it += NT) {
      const int ab = it / ncol, e = it - ab * ncol, a0 = 8 * ab;
      const bool rowsj = e < j0;
      const int i = rowsj ? e : j1 + e - j0;
      T acc[8] = {};
#pragma unroll 4
      for (int t = 0; t < min(nb, a0 + 8); ++t) {
        const T y = rowsj ? M[(j0 + t) * ldm + i] : M[i * ldm + j0 + t];
        T l[8];
        load4(&Lt[t][a0], reinterpret_cast<T(&)[4]>(l[0]));
        load4(&Lt[t][a0 + 4], reinterpret_cast<T(&)[4]>(l[4]));
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (a0 + q >= t) acc[q] = fma(l[q], y, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (a0 + q < nb) U[(a0 + q) * ldu + i] = acc[q];
    }
    __syncthreads();
    // rows J of the inverse over P, final
    for (int e = tid; e < nb * j0; e += NT) {
      const int a = e / j0, c = e - a * j0;
      M[(j0 + a) * ldm + c] = U[a * ldu + c];
    }
    if (j1 >= n) break;
    // rows T over the columns [0, i]: M[i, c] -= sum_t L_TJ[i, t] U[t, c],
    // and M[i, c] = -sum_t L_TJ[i, t] Li_JJ[t, c - j0] over J; 4 x 4
    // patches from U, rows i0 = j1 + 4 rg.., columns cc = 4 cg..
    auto patch = [&](int rg, int cg) {
      const int i0 = j1 + 4 * rg, cc = 4 * cg;
      T acc[4][4] = {};
#pragma unroll 8
      for (int t = 0; t < TS; ++t) {
        T a[4], b[4];
        load4(U + t * ldu + i0, a);
        load4(U + t * ldu + cc, b);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[q][p] = fma(a[q], b[p], acc[q][p]);
      }
      const bool inj = cc >= j0 && cc < j1;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int i = i0 + q, c = cc + p;
          if (i < n && c <= i) {
            T& v = M[i * ldm + c];
            v = inj ? -acc[q][p] : v - acc[q][p];
          }
        }
    };
    // look-ahead: warp 0 updates the next panel's diagonal tile (row
    // groups rg < ntg, column groups from j4) and sweeps it while the
    // warps on the other three schedulers update the rest; row group rg
    // holds j4 + rg + 1 column groups, from first(rg) = rg (j4 + 1) + rg
    // (rg - 1) / 2
    const int j4 = j1 / 4, nrg = (n - j1 + 3) / 4, b2 = 2 * j4 + 1;
    const int j2 = min(n, j1 + TS), ntg = (j2 - j1 + 3) / 4;
    auto first = [j4](int rg) { return rg * (j4 + 1) + rg * (rg - 1) / 2; };
    if (warp == 0) {
      for (int e = lane; e < ntg * (ntg + 1) / 2; e += 32) {
        int rg = 0;
        while ((rg + 1) * (rg + 2) / 2 <= e) ++rg;
        patch(rg, j4 + e - rg * (rg + 1) / 2);
      }
      __syncwarp();
      diag_inverse(M, ldm, j1, j2 - j1, Ls, Lt, wl, wraw, fail);
    } else if (warp % 4 != 0) {
      // warps 4, 8, ... share warp 0's scheduler and leave it to the sweep
      const int wk = (warp - warp / 4 - 1) * 32 + lane, nwk = NT / 4 * 3;
      for (int e = wk; e < first(nrg); e += nwk) {
        int rg = static_cast<int>(
            (sqrtf(static_cast<float>(b2) * b2 + 8.0f * e) - b2) * 0.5f);
        while (rg > 0 && first(rg) > e) --rg;
        while (first(rg + 1) <= e) ++rg;
        const int cg = e - first(rg);
        if (rg < ntg && cg >= j4) continue;       // warp 0's
        patch(rg, cg);
      }
    }
    __syncthreads();
  }
  __syncthreads();
  bool nonfinite = false;
  for (int i = warp; i < n; i += NW)
#pragma unroll 8
    for (int c = lane; c < n; c += 32) {
      const T v = c <= i ? M[i * ldm + c] : T(0);
      if (m_smem || c > i) out[static_cast<long long>(i) * n + c] = v;
      nonfinite |= chunk::bad(v);
    }
  if (nonfinite) *fail = 1;
}

// ---- 32 x 32 output tiles of a product, 64 threads, 4 x 4 each --------

constexpr int MT = 32;            // tile side
constexpr int MK = 32;            // depth of a slice
constexpr int MM_THREADS = 64;
constexpr int LDS = MT + 4;       // row stride of a staged slice

template <typename T>
struct MMStage {
  __align__(16) T a[2][MK][LDS];
  __align__(16) T b[2][MK][LDS];
};

// an n x n operand: its element (t, x) at p[t n + x] (kmaj) or p[x n + t]
template <typename T>
struct Opnd {
  const T* p;
  bool kmaj;
};

// s[t][x] = element (t0 + t, x0 + x) for t0 + t < t_end and x0 + x < n,
// else 0; the copies are cp.async along the operand's contiguous
// dimension: 16 bytes each for a kmaj operand whose rows allow it, else
// one element each (x-major operands in runs of 8 along t for 4 rows, so
// the transposing stores hit 32 distinct banks)
template <typename T>
__device__ void load_slice(T (*s)[LDS], Opnd<T> o, int n, int t0, int x0,
                           int t_end) {
  constexpr int VW = 16 / sizeof(T);
  if (o.kmaj && n % VW == 0) {
    for (int e = threadIdx.x; e < MK * MT / VW; e += MM_THREADS) {
      const int t = e / (MT / VW), x = (e - t * (MT / VW)) * VW;
      const int gt = t0 + t, gx = x0 + x;
      T* dst = &s[t][x];
      if (gt < t_end && gx < n) {
        __pipeline_memcpy_async(dst, o.p + static_cast<long long>(gt) * n
                                         + gx, 16);
      } else {
#pragma unroll
        for (int q = 0; q < VW; ++q) dst[q] = T(0);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < MK * MT; e += MM_THREADS) {
    int t, x;
    if (o.kmaj) {
      t = e / MT;
      x = e - t * MT;
    } else {
      const int l = e & 31, w = e >> 5;
      t = (l & 7) + 8 * (w & 3);
      x = (l >> 3) + 4 * (w >> 2);
    }
    const int gt = t0 + t, gx = x0 + x;
    T* dst = &s[t][x];
    if (gt < t_end && gx < n) {
      const T* src = o.kmaj ? o.p + static_cast<long long>(gt) * n + gx
                            : o.p + static_cast<long long>(gx) * n + gt;
      __pipeline_memcpy_async(dst, src, sizeof(T));
    } else {
      *dst = T(0);
    }
  }
}

// acc[i][j] += sum_{t < t_end} A(r0 + 4 ty + i, t) B(t, c0 + 4 tx + j), A's
// element (r, t) being A.p's (t, r) and B's (t, c) being B.p's (t, c) in
// Opnd's sense; t in order, the next slice copied while this one is used
template <typename T>
__device__ void tile_mm(T (&acc)[4][4], Opnd<T> A, Opnd<T> B, int n, int r0,
                        int c0, int t_end, MMStage<T>& sm) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int ns = (t_end + MK - 1) / MK;
  load_slice(sm.a[0], A, n, 0, r0, t_end);
  load_slice(sm.b[0], B, n, 0, c0, t_end);
  __pipeline_commit();
  for (int s = 0; s < ns; ++s) {
    const int cur = s & 1;
    if (s + 1 < ns) {
      load_slice(sm.a[cur ^ 1], A, n, (s + 1) * MK, r0, t_end);
      load_slice(sm.b[cur ^ 1], B, n, (s + 1) * MK, c0, t_end);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < MK; ++t) {
      T a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = sm.a[cur][t][4 * ty + q];
        b[q] = sm.b[cur][t][4 * tx + q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// One block per (32 x 32 tile, product, window): product y < h is W_k = Li_k
// A_k^T (k = y), else V_k = Li_k B_k (k = y - h < nv); A_k = E[f, 2k], B_k
// = E[f, 2k + 1] (E holds mE chunks per window).  Li_k is lower, so a
// tile's sum stops at its last row
template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
    bcr_products(const T* __restrict__ E, int mE, const T* __restrict__ Li,
                 int h, int nv, int n, T* __restrict__ W,
                 T* __restrict__ V) {
  __shared__ MMStage<T> sm;
  const int tn = (n + MT - 1) / MT;
  const int ti = blockIdx.x / tn, tj = blockIdx.x - ti * tn;
  const int y = blockIdx.y, f = blockIdx.z;
  const bool isw = y < h;
  const int k = isw ? y : y - h;
  const long long nn = static_cast<long long>(n) * n;
  const T* L = Li + (static_cast<long long>(f) * h + k) * nn;
  const T* Ek = E + (static_cast<long long>(f) * mE + 2 * k + (isw ? 0 : 1))
                    * nn;
  T* out = isw ? W + (static_cast<long long>(f) * h + k) * nn
               : V + (static_cast<long long>(f) * nv + k) * nn;
  const int r0 = ti * MT, c0 = tj * MT;
  T acc[4][4] = {};
  tile_mm(acc, Opnd<T>{L, false}, Opnd<T>{Ek, !isw}, n, r0, c0,
          min(n, r0 + MT), sm);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
      if (r < n && c < n) out[static_cast<long long>(r) * n + c] = acc[i][j];
    }
}

// One block per (32 x 32 tile, kept chunk k, window): x < tn^2 the lower tiles of
// D'_k = (D[f, 2k] - V_{k-1}^T V_{k-1}) - W_k^T W_k (the first term for 1
// <= k <= nv, the second for k < h; D holds mD chunks per window), else
// the tiles of E'_k = -W_k^T V_k for k < nv.  Dn holds gridDim.y chunks
// per window, En nv
template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
    bcr_reduce(const T* __restrict__ D, int mD, const T* __restrict__ W,
               const T* __restrict__ V, int h, int nv, int n,
               T* __restrict__ Dn, T* __restrict__ En) {
  __shared__ MMStage<T> sm;
  const int tn = (n + MT - 1) / MT, tt = tn * tn;
  const bool ise = blockIdx.x >= tt;
  const int tile = ise ? blockIdx.x - tt : blockIdx.x;
  const int ti = tile / tn, tj = tile - ti * tn;
  const int k = blockIdx.y, f = blockIdx.z;
  if (ise ? k >= nv : ti < tj) return;
  const long long nn = static_cast<long long>(n) * n;
  const int r0 = ti * MT, c0 = tj * MT;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const T* Wk = W + (static_cast<long long>(f) * h + k) * nn;
  if (ise) {
    const T* Vk = V + (static_cast<long long>(f) * nv + k) * nn;
    T acc[4][4] = {};
    tile_mm(acc, Opnd<T>{Wk, true}, Opnd<T>{Vk, true}, n, r0, c0, n, sm);
    T* out = En + (static_cast<long long>(f) * nv + k) * nn;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
        if (r < n && c < n) out[static_cast<long long>(r) * n + c] = -acc[i][j];
      }
    return;
  }
  T a1[4][4] = {}, a2[4][4] = {};
  if (k >= 1 && k <= nv) {
    const T* Vp = V + (static_cast<long long>(f) * nv + k - 1) * nn;
    tile_mm(a1, Opnd<T>{Vp, true}, Opnd<T>{Vp, true}, n, r0, c0, n, sm);
  }
  if (k < h)
    tile_mm(a2, Opnd<T>{Wk, true}, Opnd<T>{Wk, true}, n, r0, c0, n, sm);
  const T* De = D + (static_cast<long long>(f) * mD + 2 * k) * nn;
  T* out = Dn + (static_cast<long long>(f) * gridDim.y + k) * nn;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
      if (r < n && c < n) {
        const long long e = static_cast<long long>(r) * n + c;
        out[e] = (De[e] - a1[i][j]) - a2[i][j];
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    scan_factor(const T* __restrict__ D, const T* __restrict__ E, int m,
                int n, T* __restrict__ C, T* __restrict__ M,
                T* __restrict__ xw, int* __restrict__ fail, int in_smem) {
  __shared__ Tiles<T> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int f = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  T* X = in_smem ? reinterpret_cast<T*>(dyn) : xw + f * nn;
  for (int i = 0; i < m; ++i) {
    const long long blk = (static_cast<long long>(f) * m + i) * nn;
    T* Ci = C + blk;
    T* Mi = M + blk;
    if (i == 0) {
      for (long long e = threadIdx.x; e < nn; e += THREADS) {
        Ci[e] = D[blk + e];
        Mi[e] = T(0);
      }
      __syncthreads();
    } else {
      // X = C_{i-1}^-1 E_{i-1}, M_i = X^T, C_i = D_i - X^T X (lower)
      for (long long e = threadIdx.x; e < nn; e += THREADS)
        X[e] = E[blk - nn + e];
      __syncthreads();
      chunk::trsm<false>(Ci - nn, n, X, n, n, sm);
      for (long long e = threadIdx.x; e < nn; e += THREADS) {
        const long long r = e / n, q = e - r * n;
        Mi[e] = X[q * n + r];
        Ci[e] = D[blk + e];
      }
      __syncthreads();
      chunk::gemm_sub(Ci, n, n, n, Mat<T>{X, n, true}, Mat<T>{X, n, false},
                      n, true, sm);
    }
    chunk::chol(Ci, n, sm, fail);
  }
}

// elements of bcr_chol_inv's workspace for h blocks of F windows
long long chol_inv_workspace(int F, int h, int n) {
  return static_cast<long long>(F) * h * TS * panel_ld(n);
}

template <typename T>
int launch_chol_inv(const void* D, int m, int c0, int cstep, int h, int F,
                    int n, void* Li, void* ws, void* fail, void* stream) {
  if (F < 1 || h < 1 || n < 1 || m < 1 || c0 < 0 || cstep < 0 ||
      c0 + static_cast<long long>(cstep) * (h - 1) >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  // U and M in shared memory when both fit, else U alone, else neither
  const long long ub = static_cast<long long>(TS) * panel_ld(n) * sizeof(T);
  const long long mb = static_cast<long long>(n) * (n | 1) * sizeof(T);
  const void* kernel = reinterpret_cast<const void*>(bcr_chol_inv<T>);
  const long long fixed = (TS * (TS + 1) + TS * (TS + 4) + 3 * TS) *
                          static_cast<long long>(sizeof(T)) + 64;
  long long bytes = chunk::reserve_smem(kernel, ub + mb, fixed) ? ub + mb
                                                                : 0;
  int m_smem = bytes > 0, u_smem = bytes > 0;
  if (!m_smem) {
    bytes = chunk::reserve_smem(kernel, ub, fixed) ? ub : 0;
    u_smem = bytes > 0;
  }
  bcr_chol_inv<T><<<dim3(h, F), ci_threads<T>(), static_cast<size_t>(bytes),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), m, c0, cstep, n, static_cast<T*>(Li),
      static_cast<T*>(ws), static_cast<int*>(fail), m_smem, u_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_products(const void* E, int mE, const void* Li, int h, int nv,
                    int F, int n, void* W, void* V, void* stream) {
  if (F < 1 || h < 1 || nv < 0 || nv > h || n < 1 || 2 * h - 2 >= mE ||
      (nv > 0 && 2 * nv - 1 >= mE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tn = (n + MT - 1) / MT;
  bcr_products<T><<<dim3(tn * tn, h + nv, F), MM_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(E), mE, static_cast<const T*>(Li), h, nv, n,
      static_cast<T*>(W), static_cast<T*>(V));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const void* D, int mD, const void* W, const void* V, int h,
                  int nv, int rn, int F, int n, void* Dn, void* En,
                  void* stream) {
  if (F < 1 || h < 0 || nv < 0 || nv > h || rn < 1 || rn > h + 1 ||
      nv > rn - 1 || n < 1 || 2 * (rn - 1) >= mD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tn = (n + MT - 1) / MT;
  bcr_reduce<T><<<dim3(2 * tn * tn, rn, F), MM_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), mD, static_cast<const T*>(W),
      static_cast<const T*>(V), h, nv, n, static_cast<T*>(Dn),
      static_cast<T*>(En));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scan(const void* D, const void* E, int F, int m, int n, void* C,
                void* M, void* xw, void* fail, void* stream) {
  if (F < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = chunk::smem_if_fits<T>(
      scan_factor<T>, static_cast<long long>(n) * n * sizeof(T));
  scan_factor<T><<<F, THREADS, static_cast<size_t>(bytes),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(E), m, n,
      static_cast<T*>(C), static_cast<T*>(M), static_cast<T*>(xw),
      static_cast<int*>(fail), bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Li (F, h, n, n): chol(D[f, c0 + cstep k])^-1 for k < h, D (F, m, n, n);
// ws: ba_bcr_chol_inv_workspace(F, h, n) elements
long long ba_bcr_chol_inv_workspace(int F, int h, int n) {
  return chol_inv_workspace(F, h, n);
}
int ba_bcr_chol_inv_f32(const void* D, int m, int c0, int cstep, int h,
                        int F, int n, void* Li, void* ws, void* fail,
                        void* stream) {
  return launch_chol_inv<float>(D, m, c0, cstep, h, F, n, Li, ws, fail,
                                stream);
}
int ba_bcr_chol_inv_f64(const void* D, int m, int c0, int cstep, int h,
                        int F, int n, void* Li, void* ws, void* fail,
                        void* stream) {
  return launch_chol_inv<double>(D, m, c0, cstep, h, F, n, Li, ws, fail,
                                 stream);
}

// W (F, h, n, n), V (F, nv, n, n) from E (F, mE, n, n) and Li (F, h, n, n)
int ba_bcr_products_f32(const void* E, int mE, const void* Li, int h, int nv,
                        int F, int n, void* W, void* V, void* stream) {
  return launch_products<float>(E, mE, Li, h, nv, F, n, W, V, stream);
}
int ba_bcr_products_f64(const void* E, int mE, const void* Li, int h, int nv,
                        int F, int n, void* W, void* V, void* stream) {
  return launch_products<double>(E, mE, Li, h, nv, F, n, W, V, stream);
}

// Dn (F, rn, n, n) (lower tiles), En (F, nv, n, n) or null when nv = 0
int ba_bcr_reduce_f32(const void* D, int mD, const void* W, const void* V,
                      int h, int nv, int rn, int F, int n, void* Dn,
                      void* En, void* stream) {
  return launch_reduce<float>(D, mD, W, V, h, nv, rn, F, n, Dn, En, stream);
}
int ba_bcr_reduce_f64(const void* D, int mD, const void* W, const void* V,
                      int h, int nv, int rn, int F, int n, void* Dn,
                      void* En, void* stream) {
  return launch_reduce<double>(D, mD, W, V, h, nv, rn, F, n, Dn, En, stream);
}

// C, M: (F, m, n, n); xw: (F, n, n) workspace
int ba_scan_factor_f32(const void* D, const void* E, int F, int m, int n,
                       void* C, void* M, void* xw, void* fail, void* stream) {
  return launch_scan<float>(D, E, F, m, n, C, M, xw, fail, stream);
}
int ba_scan_factor_f64(const void* D, const void* E, int F, int m, int n,
                       void* C, void* M, void* xw, void* fail, void* stream) {
  return launch_scan<double>(D, E, F, m, n, C, M, xw, fail, stream);
}

}  // extern "C"
