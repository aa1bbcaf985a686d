// The walk over shared landmarks of a 64 x 64 (or 32 x 32) tile of a Schur
// product S -= (W V^-1) W^T, shared by K5 (schur_finish.cu) and kernel 10
// (fleet_schur.cu).
//
// A tile (bi, bj) of S walks the landmarks that some row of row tile bi and
// some row of column tile bj both see, in ascending order.  Each step
// stages TL landmarks' lm columns twice in shared memory, stage[buf][0]
// the row operand (W V^-1 over the tile's rows) and stage[buf][1] the
// column operand (W over the tile's columns), column by column with the
// tile's rows contiguous; a thread of the 16 x 16 block multiplies them
// into its PT x PT patch with plain FMA.  The next step's loads are in
// flight while this step is multiplied.  The kernels differ in how a step
// loads and stages its landmarks (the dense W rows for K5, the W blocks
// through the fleet's table for kernel 10), which they pass in.

#pragma once

namespace ba {
namespace tile {

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

// Warp 0 (lane = its lane): the landmarks of the 32 mask words [w0, w0 +
// 32) set in both the row tile's and the column tile's masks, in ascending
// order, into lst (up to 1024), and their count into *count.  mask holds
// one word per (32-row range, 32 landmarks), nR ranges of LW words; a tile
// spans RPT ranges from bi RPT (rows) and bj RPT (columns).
template <int RPT>
__device__ __forceinline__ void list_shared(const unsigned* __restrict__ mask,
                                            int nR, int LW, int bi, int bj,
                                            int w0, int lane, int* lst,
                                            int* count) {
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
  if (lane == 31) *count = incl;
}

// The listed landmarks [0, cnt) in order, TL per step of NC = TL lm staged
// columns: load(s, cnt) fetches step s into registers, store(buf) writes it
// to stage[buf]; a `busy` thread (one whose patch is written) multiplies
// each staged column into acc.  Called by the whole block; ends with a
// barrier.
template <int NC, int PT, typename T, int BK, int PAD, typename Load,
          typename Store>
__device__ __forceinline__ void walk(int cnt, int TL, bool busy, int tx,
                                     int ty, T (&stage)[2][2][BK][PAD],
                                     T (&acc)[PT][PT], Load&& load,
                                     Store&& store) {
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
      for (int c = 0; c < NC; ++c) {
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
}

}  // namespace tile
}  // namespace ba
