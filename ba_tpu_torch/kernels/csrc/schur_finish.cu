// K5: the Schur step of the reduced camera system.
//
//   S   = U - W V^-1 W^T           (n x n, the leading n rows and columns)
//   rhs = rhs_p - W V^-1 rhs_l     (n)
//
// with U (N, N), W (N, K) dense, K = L * LM landmark columns, V^-1 the
// (L, LM, LM) block diagonal of the landmark Hessian's inverse, n <= N.
// An optional epilogue applies the column mask of the reduced system: a
// masked dimension gets 1e6 on its diagonal and a zero rhs.
//
// Replaces the TPU formulation ba_tpu/solver/assemble.py:finish (:442),
// which writes W V^-1 (N x K) to device memory and hands the N x N x K
// product to the matrix unit, and the same step of the marginalization
// (ba_tpu/solver/window.py:marginalize, :93-100), which keeps only the
// leading n rows and columns.
//
// Design.  W is mostly structural zeros (a landmark is seen by a few
// consecutive poses: 7-38 % nonzero on the paths), so each tile of S
// walks only the landmarks it needs:
//
//   * masks + rhs (a first launch, when S has enough tiles to fill the
//     card): for each 32-row range of W a bitmask over landmarks ("some
//     row of the range is nonzero in the landmark's LM columns"), one
//     thread per (range, landmark) with all of its 32 rows' loads in
//     flight and a warp ballot per word; and the rhs, one warp per row,
//     its lanes over the landmarks (eight at a time in flight) and a fixed
//     xor butterfly.
//   * product: one block of 256 threads per TILE x TILE tile of the lower
//     triangle of S, the last tile rows first (they hold the calibration
//     block, dense across every landmark: the longest walks), walks the
//     landmarks set in both its row and its column masks in ascending
//     order (warp 0 lists them from the masks, 1024 at a time).  Each step
//     stages up to 16 / LM landmarks' columns of the tile's rows of W in
//     shared memory twice: for the row operand with V^-1 applied there (a
//     scalar at LM 1, a 3 x 3 block at LM 3), for the column operand as it
//     is, so W V^-1 never reaches device memory; the next step's W and
//     V^-1 are loaded into registers while this step's are multiplied
//     (double-buffered staging, one barrier per step).  A thread
//     accumulates a contiguous (TILE / 16)^2 patch with plain FMA (no
//     tensor cores: the package pins exact f32), reading each staged
//     column's patch as 16-byte vectors, and skips patches past row or
//     column n and above the diagonal; it writes S[i, j] = U[i, j] - acc
//     for j <= i (U read through its strides), mirrored to S[j, i], so S
//     is exactly symmetric and every element has one writer.  A tile pair
//     with no common landmark does no arithmetic and writes S = U.
//
// A landmark outside either mask contributes only exact zeros, fma(a, 0,
// acc) = acc (for finite operands), and every element sums its landmarks
// in ascending order whatever the tile or patch, so an unsplit walk gives
// the dense ordered walk's result bit for bit.  To fill the card when S
// has few tiles (the serving slide, n = 90: six 32 x 32 tiles), each
// tile's walk is split across the CS blocks of a thread-block cluster (CS
// = the SMs per tile, at most 8): block r owns the 32-landmark words w = r
// mod CS, finds which of its landmarks both tiles touch itself (no mask
// launch: the same launch computes the rhs in its last blocks), and the
// partial tiles are summed through distributed shared memory in rank
// order: no workspace, and deterministic.  TILE = 64 when the 64-row tiles
// alone fill the SMs (the flagship, self-calibration), otherwise 32.  Two
// launches are bit-identical.  With K = 0 (no landmark columns) nothing is
// walked: S = U, rhs = rhs_p.
//
// Bound on an H100: bytes once the zeros are skipped.  At the flagship
// (N = 1,152, K = 497, W 10.5 % nonzero) U's lower triangle, W and S are
// ~10.3 MB (~3 us at 3.35 TB/s) against ~8 MFLOP of structurally nonzero
// products; at the slide the launch floor.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RANGE = 32;      // rows per mask
constexpr int BK = 16;         // landmark columns per step, at most
constexpr int THREADS = 256;   // 16 x 16, a (TILE / 16)^2 patch each
constexpr int LIST = 1024;     // landmarks listed at a time (32 words)
constexpr int RHS_ROWS = THREADS / 32;   // rows per rhs block: a warp each
constexpr int MAX_CLUSTER = 8;

template <typename T, int LM>
__device__ void mask_rows(const T* __restrict__ W, int K, int n, int nlb,
                          int LW, int b, unsigned* __restrict__ mask) {
  const int L = K / LM;
  const int R = b / nlb, lb = b - R * nlb;
  const int l = lb * THREADS + threadIdx.x;
  int nz = 0;
  if (l < L) {
    // all the range's loads in flight at once, not one latency per row:
    // every load is made (a row past n reads row n - 1) and masked after
    const T* w0 = W + static_cast<long long>(R) * RANGE * K + l * LM;
    const int rows = min(RANGE, n - R * RANGE);
#pragma unroll
    for (int r = 0; r < RANGE; ++r)
#pragma unroll
      for (int a = 0; a < LM; ++a) {
        const T v = w0[static_cast<long long>(min(r, rows - 1)) * K + a];
        nz |= (r < rows) & (v != T(0));
      }
  }
  const unsigned bal = __ballot_sync(0xffffffffu, nz);
  const int word = (lb * THREADS >> 5) + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && word < LW)
    mask[static_cast<long long>(R) * LW + word] = bal;
}

template <typename T, int LM>
__device__ void rhs_rows(const T* __restrict__ W, int K,
                         const T* __restrict__ vinv,
                         const T* __restrict__ rhs_p,
                         const T* __restrict__ rhs_l,
                         const unsigned char* __restrict__ cmask, int n,
                         int rb, T* __restrict__ rhs) {
  constexpr int U = 8;                  // landmark rounds loaded at once
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = K / LM;
  for (int r = warp; r < RHS_ROWS; r += THREADS / 32) {
    const int gi = rb * RHS_ROWS + r;
    if (gi >= n) break;                 // the whole warp leaves together
    const T* wrow = W + static_cast<long long>(gi) * K;
    T part = T(0);
    for (int l0 = lane; l0 < L; l0 += 32 * U) {
      T wa[U][LM], vb[U][LM * LM], rl[U][LM];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int l = l0 + 32 * u;
        const bool ok = l < L;
#pragma unroll
        for (int a = 0; a < LM; ++a) {
          wa[u][a] = ok ? wrow[l * LM + a] : T(0);
          rl[u][a] = ok ? rhs_l[l * LM + a] : T(0);
        }
#pragma unroll
        for (int e = 0; e < LM * LM; ++e)
          vb[u][e] = ok ? vinv[static_cast<long long>(l) * LM * LM + e]
                        : T(0);
      }
      // the same operations in the same order as one landmark at a time
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (l0 + 32 * u >= L) break;
#pragma unroll
        for (int b = 0; b < LM; ++b) {
          T s = T(0);
#pragma unroll
          for (int a = 0; a < LM; ++a) s = fma(wa[u][a], vb[u][a * LM + b], s);
          part = fma(s, rl[u][b], part);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      T v = rhs_p[gi] - part;
      if (cmask != nullptr && !cmask[gi]) v = T(0);
      rhs[gi] = v;
    }
  }
}

template <typename T, int LM>
__global__ void __launch_bounds__(THREADS)
    schur_mask_kernel(const T* __restrict__ W, int K,
                      const T* __restrict__ vinv,
                      const T* __restrict__ rhs_p,
                      const T* __restrict__ rhs_l,
                      const unsigned char* __restrict__ cmask, int n,
                      int nlb, int LW, int nmask,
                      unsigned* __restrict__ mask, T* __restrict__ rhs) {
  const int b = blockIdx.x;
  if (b < nmask)
    mask_rows<T, LM>(W, K, n, nlb, LW, b, mask);
  else
    rhs_rows<T, LM>(W, K, vinv, rhs_p, rhs_l, cmask, n, b - nmask, rhs);
}

// a thread's patch of one staged column: PT contiguous values, read as
// 16-byte (or 8-byte) vectors
__device__ __forceinline__ void ld_patch(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void ld_patch(const float* p, float (&v)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void ld_patch(const double* p, double (&v)[4]) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}
__device__ __forceinline__ void ld_patch(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}

template <typename T, int LM, int TILE>
__global__ void __launch_bounds__(THREADS)
    schur_product_kernel(const T* __restrict__ U, int su0, int su1,
                         const T* __restrict__ W, int K,
                         const T* __restrict__ vinv,
                         const T* __restrict__ rhs_p,
                         const T* __restrict__ rhs_l,
                         const unsigned char* __restrict__ cmask, int n,
                         int ntri, int LW, const unsigned* __restrict__ mask,
                         int cs, T* __restrict__ S, T* __restrict__ rhs) {
  constexpr int TL = BK / LM;                  // landmarks per step
  constexpr int PAD = TILE + 4;                // 16-byte rows
  constexpr int PT = TILE / 16;                // patch side
  constexpr int NE = (TILE * TL + THREADS - 1) / THREADS;
  constexpr int RPT = TILE / RANGE;            // mask ranges per tile
  static_assert(2 * 2 * BK * PAD >= TILE * TILE, "partials fit staging");
  // [buffer][row operand (W V^-1)^T | column operand W^T][column][row]
  __shared__ __align__(16) T stage[2][2][BK][PAD];
  __shared__ int lst[LIST];
  __shared__ int ctl[2];
  if (static_cast<int>(blockIdx.x) >= ntri * cs) {
    // a split launch computes the rhs in its last clusters
    rhs_rows<T, LM>(W, K, vinv, rhs_p, rhs_l, cmask, n,
                    blockIdx.x - ntri * cs, rhs);
    return;
  }
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int lane = t & 31, warp = t >> 5;
  const int L = K / LM;
  // the last tile rows first: they hold the calibration block's rows,
  // dense across every landmark, whose walks are the longest
  const int rank = blockIdx.x % cs;
  const int tile = ntri - 1 - static_cast<int>(blockIdx.x) / cs;
  int bi = static_cast<int>((sqrt(8.0 * tile + 1.0) - 1.0) * 0.5);
  while ((bi + 1) * (bi + 2) / 2 <= tile) ++bi;
  while (bi * (bi + 1) / 2 > tile) --bi;
  const int bj = tile - bi * (bi + 1) / 2;
  const int i0 = bi * TILE, j0 = bj * TILE;
  const int nR = (n + RANGE - 1) / RANGE;
  // a patch wholly past row n, past column n or above the diagonal is
  // never written: its thread skips the products
  const bool busy = i0 + ty * PT < n && j0 + tx * PT < n
                    && !(bi == bj && tx > ty);

  T acc[PT][PT];
#pragma unroll
  for (int a = 0; a < PT; ++a)
#pragma unroll
    for (int b = 0; b < PT; ++b) acc[a][b] = T(0);

  T wa[NE][LM], wb[NE][LM], vv[NE][LM * LM];
  int gl[NE];
  auto load = [&](int s, int cnt) {
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = t + u * THREADS;
      const int r = e / TL, l = e - r * TL, li = s * TL + l;
      const bool ok = e < TILE * TL && li < cnt;
      gl[u] = ok ? lst[li] : -1;
      const int gi = i0 + r, gj = j0 + r;
#pragma unroll
      for (int a = 0; a < LM; ++a) {
        wa[u][a] = (ok && gi < n)
                       ? W[static_cast<long long>(gi) * K + gl[u] * LM + a]
                       : T(0);
        wb[u][a] = (ok && gj < n)
                       ? W[static_cast<long long>(gj) * K + gl[u] * LM + a]
                       : T(0);
      }
#pragma unroll
      for (int e2 = 0; e2 < LM * LM; ++e2)
        vv[u][e2] = ok ? vinv[static_cast<long long>(gl[u]) * LM * LM + e2]
                       : T(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = t + u * THREADS;
      if (e >= TILE * TL) continue;
      const int r = e / TL, l = e - r * TL;
#pragma unroll
      for (int b = 0; b < LM; ++b) {
        T s = T(0);
        if (gl[u] >= 0) {
#pragma unroll
          for (int a = 0; a < LM; ++a)
            s = fma(wa[u][a], vv[u][a * LM + b], s);
        }
        stage[buf][0][l * LM + b][r] = s;
        stage[buf][1][l * LM + b][r] = wb[u][b];
      }
    }
  };
  // the landmarks lst[0, cnt), in order, staged a step ahead; ends with a
  // barrier
  auto walk = [&](int cnt) {
    const int nsteps = (cnt + TL - 1) / TL;
    if (nsteps == 0) {
      __syncthreads();
      return;
    }
    load(0, cnt);
    store(0);
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
      const int buf = s & 1;
      if (s + 1 < nsteps) load(s + 1, cnt);
      if (busy) {
#pragma unroll
        for (int c = 0; c < TL * LM; ++c) {
          T av[PT], bv[PT];
          ld_patch(&stage[buf][0][c][ty * PT], av);
          ld_patch(&stage[buf][1][c][tx * PT], bv);
#pragma unroll
          for (int a = 0; a < PT; ++a)
#pragma unroll
            for (int b = 0; b < PT; ++b)
              acc[a][b] = fma(av[a], bv[b], acc[a][b]);
        }
      }
      if (s + 1 < nsteps) store(buf ^ 1);
      __syncthreads();
    }
  };

  if (cs == 1) {
    // the landmarks set in both tiles' masks, 1024 at a time, listed by
    // warp 0
    for (int w0 = 0; w0 < LW; w0 += 32) {
      if (warp == 0) {
        const int w = w0 + lane;
        unsigned cw = 0;
        if (w < LW) {
          unsigned mi = 0, mj = 0;
#pragma unroll
          for (int u = 0; u < RPT; ++u) {
            if (bi * RPT + u < nR)
              mi |= mask[static_cast<long long>(bi * RPT + u) * LW + w];
            if (bj * RPT + u < nR)
              mj |= mask[static_cast<long long>(bj * RPT + u) * LW + w];
          }
          cw = mi & mj;
        }
        const int c = __popc(cw);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        int at = incl - c;
        while (cw) {
          const int bit = __ffs(cw) - 1;
          cw &= cw - 1;
          lst[at++] = w * 32 + bit;
        }
        if (lane == 31) ctl[0] = incl;
      }
      __syncthreads();
      walk(ctl[0]);
    }
  } else {
    // a split walk finds its own landmarks: rank r owns the 32-landmark
    // words w = r + cs v (coalesced loads, shares balanced to a word), and
    // keeps those nonzero in some row of both tiles, in ascending order
    int* flag = reinterpret_cast<int*>(&stage[1][0][0][0]);
    const int nu = (LW - rank + cs - 1) / cs * 32;
    const int ri = min(TILE, n - i0) - 1, rj = min(TILE, n - j0) - 1;
    auto owned = [&](int u) { return (rank + cs * (u >> 5)) * 32 + (u & 31); };
    for (int u0 = 0; u0 < nu; u0 += LIST) {
      const int m = min(LIST, nu - u0);
      for (int uu = t; uu < m; uu += THREADS) {
        const int l = owned(u0 + uu);
        int fi = 0, fj = 0;
        if (l < L) {
          // every load made (rows past n read the last row), masked after
#pragma unroll
          for (int r = 0; r < TILE; ++r)
#pragma unroll
            for (int a = 0; a < LM; ++a) {
              const T vi = W[static_cast<long long>(i0 + min(r, ri)) * K
                             + l * LM + a];
              const T vj = W[static_cast<long long>(j0 + min(r, rj)) * K
                             + l * LM + a];
              fi |= (r <= ri) & (vi != T(0));
              fj |= (r <= rj) & (vj != T(0));
            }
        }
        flag[uu] = fi & fj;
      }
      __syncthreads();
      if (warp == 0) {
        int at = 0;
        for (int x0 = 0; x0 < m; x0 += 32) {
          const int f = x0 + lane < m && flag[x0 + lane];
          const unsigned bal = __ballot_sync(0xffffffffu, f);
          if (f)
            lst[at + __popc(bal & ((1u << lane) - 1u))] =
                owned(u0 + x0 + lane);
          at += __popc(bal);
        }
        if (lane == 0) ctl[0] = at;
      }
      __syncthreads();
      walk(ctl[0]);
    }
  }

  if (cs == 1) {
#pragma unroll
    for (int a = 0; a < PT; ++a) {
      const int gi = i0 + ty * PT + a;
      if (gi >= n) continue;
#pragma unroll
      for (int b = 0; b < PT; ++b) {
        const int gj = j0 + tx * PT + b;
        if (gj > gi) continue;
        T v = U[static_cast<long long>(gi) * su0
                + static_cast<long long>(gj) * su1] - acc[a][b];
        if (gj == gi && cmask != nullptr && !cmask[gi]) v += T(1e6);
        S[static_cast<long long>(gi) * n + gj] = v;
        if (gj < gi) S[static_cast<long long>(gj) * n + gi] = v;
      }
    }
    return;
  }

  // the cluster's partial tiles, summed in rank order through distributed
  // shared memory; each block finishes a 1/cs share of the tile's elements
  T* part = &stage[0][0][0][0];
#pragma unroll
  for (int a = 0; a < PT; ++a)
#pragma unroll
    for (int b = 0; b < PT; ++b)
      part[(ty * PT + a) * TILE + tx * PT + b] = acc[a][b];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank * THREADS + t; e < TILE * TILE; e += cs * THREADS) {
    const int r = e / TILE, c = e - r * TILE;
    const int gi = i0 + r, gj = j0 + c;
    if (gi >= n || gj > gi) continue;
    T sum = T(0);
    for (int q = 0; q < cs; ++q)
      sum += cluster.map_shared_rank(part, q)[e];
    T v = U[static_cast<long long>(gi) * su0
            + static_cast<long long>(gj) * su1] - sum;
    if (gj == gi && cmask != nullptr && !cmask[gi]) v += T(1e6);
    S[static_cast<long long>(gi) * n + gj] = v;
    if (gj < gi) S[static_cast<long long>(gj) * n + gi] = v;
  }
  cluster.sync();                       // no block leaves while read
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

// the schedule of n rows and L landmarks of size lm: 64-row tiles when
// they alone fill the SMs, else 32-row tiles; each tile's walk split
// across a cluster of cs blocks when the tiles leave SMs idle (cs = 1:
// unsplit), at most one block per landmark step
void schedule(int n, int L, int lm, int* tile, int* cs) {
  const int sms = sm_count();
  const int nb64 = (n + 63) / 64;
  *tile = nb64 * (nb64 + 1) / 2 >= sms ? 64 : 32;
  const int nb = (n + *tile - 1) / *tile;
  const int steps = (L + BK / lm - 1) / (BK / lm);
  int c = sms / (nb * (nb + 1) / 2);
  c = c > MAX_CLUSTER ? MAX_CLUSTER : c;
  c = c > steps ? steps : c;
  *cs = c > 1 ? c : 1;
}

// one block per lower tile of S after the mask pass, or a cluster of cs
// blocks per tile that find their own landmarks, plus the rhs blocks
template <typename T, int LM, int TILE>
int launch_lm(const T* u, int su0, int su1, const T* w, int K, const T* vi,
              const T* rhs_p, const T* rhs_l, const unsigned char* m, int n,
              int cs, unsigned* mk, T* s, T* rhs, cudaStream_t st) {
  const int L = K / LM;
  const int LW = (L + 31) / 32;
  const int nb = (n + TILE - 1) / TILE;
  const int ntri = nb * (nb + 1) / 2;
  if (cs == 1) {
    const int nR = (n + RANGE - 1) / RANGE;
    const int nlb = (L + THREADS - 1) / THREADS;
    const int nmask = nR * nlb;
    const int nrhs = (n + RHS_ROWS - 1) / RHS_ROWS;
    schur_mask_kernel<T, LM><<<nmask + nrhs, THREADS, 0, st>>>(
        w, K, vi, rhs_p, rhs_l, m, n, nlb, LW, nmask, mk, rhs);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    schur_product_kernel<T, LM, TILE><<<ntri, THREADS, 0, st>>>(
        u, su0, su1, w, K, vi, rhs_p, rhs_l, m, n, ntri, LW, mk, 1, s, rhs);
    return static_cast<int>(cudaGetLastError());
  }
  const int nrhs = (n + RHS_ROWS - 1) / RHS_ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntri * cs + (nrhs + cs - 1) / cs * cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, schur_product_kernel<T, LM, TILE>, u, su0, su1, w, K, vi, rhs_p,
      rhs_l, m, n, ntri, LW, static_cast<const unsigned*>(mk), cs, s, rhs);
  if (rc != cudaSuccess) {
    cudaGetLastError();                 // clear it; the caller raises
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* U, int su0, int su1, const void* W, int K, int lm,
           const void* vinv, const void* rhs_p, const void* rhs_l,
           const void* cmask, int n, void* S, void* rhs, void* mask,
           void* stream) {
  if (n < 0 || su0 < 1 || su1 < 1 || K < 0 || (lm != 1 && lm != 3)
      || K % lm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(cmask);
  const T* u = static_cast<const T*>(U);
  const T* w = static_cast<const T*>(W);
  const T* vi = static_cast<const T*>(vinv);
  const T* rp = static_cast<const T*>(rhs_p);
  const T* rl = static_cast<const T*>(rhs_l);
  auto* mk = static_cast<unsigned*>(mask);
  T* s = static_cast<T*>(S);
  T* r = static_cast<T*>(rhs);
  int tile = 0, cs = 0;
  schedule(n, K / lm, lm, &tile, &cs);
  const bool big = tile == 64;
  if (lm == 1)
    return big ? launch_lm<T, 1, 64>(u, su0, su1, w, K, vi, rp, rl, m, n,
                                     cs, mk, s, r, st)
               : launch_lm<T, 1, 32>(u, su0, su1, w, K, vi, rp, rl, m, n,
                                     cs, mk, s, r, st);
  return big ? launch_lm<T, 3, 64>(u, su0, su1, w, K, vi, rp, rl, m, n, cs,
                                   mk, s, r, st)
             : launch_lm<T, 3, 32>(u, su0, su1, w, K, vi, rp, rl, m, n, cs,
                                   mk, s, r, st);
}

}  // namespace

extern "C" {

// U is read as U[i * su0 + j * su1] (a transposed view needs no copy);
// mask: ceil(n / 32) * ceil(L / 32) words of scratch (L = K / lm)
int ba_schur_finish_f32(const void* U, int su0, int su1, const void* W,
                        int K, int lm, const void* vinv, const void* rhs_p,
                        const void* rhs_l, const void* cmask, int n, void* S,
                        void* rhs, void* mask, void* stream) {
  return launch<float>(U, su0, su1, W, K, lm, vinv, rhs_p, rhs_l, cmask, n,
                       S, rhs, mask, stream);
}

int ba_schur_finish_f64(const void* U, int su0, int su1, const void* W,
                        int K, int lm, const void* vinv, const void* rhs_p,
                        const void* rhs_l, const void* cmask, int n, void* S,
                        void* rhs, void* mask, void* stream) {
  return launch<double>(U, su0, su1, W, K, lm, vinv, rhs_p, rhs_l, cmask, n,
                        S, rhs, mask, stream);
}

// the schedule a launch on the current device takes for n rows and L
// landmarks of size lm: out = {tile rows, cluster blocks per tile}
int ba_schur_schedule(int n, int L, int lm, int* out) {
  if (n < 1 || L < 0 || (lm != 1 && lm != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  schedule(n, L, lm, &out[0], &out[1]);
  return 0;
}

}  // extern "C"
