// Grouped deterministic segmented block sum: for each group g of one launch,
// out_g[s, :] = sum of vals_g[i, :] over the rows i with id s, in a fixed
// order.  One launch carries all seven sums of a banded build (ten with a
// calibration block).
//
// Replaces the TPU formulation ba_tpu/solver/assemble.py:seg_sum_blocks
// (:120-156, a one-hot MXU matmul below 512 segments, a serialized scatter
// above).
//
// Each group comes with a plan built once per problem (kernels/segsum.py,
// SegPlan): a stable sort of its rows by id (`perm`, out-of-range ids last
// and never read), CSR `offsets`, and a work table that cuts every segment
// into chunks of at most R rows, {segment, first row in perm, rows, index of
// the chunk in its segment or -1 when the segment has one chunk}.  Empty
// segments get one chunk of no rows, so every output row is written.
//
// One warp per chunk, 8 chunks per block, over the chunks of all groups:
// no warp walks more than R rows, however skewed the segments (the
// flagship's longest is 927 rows, its mean 15).  The warp reads its R row
// indices with one coalesced load; lanes map to (row slot, column) pairs,
// so narrow blocks (k = 1, 6, 9) keep most lanes busy, and wide ones
// (k = 36, 81) give each lane columns lane, lane + 32, ...  A segment of one
// chunk is written by its warp.  The chunks of a longer segment write
// partial sums; the last of them to finish (a fence and a per-segment
// counter) adds the partials in chunk order and resets the counter for the
// next launch.  Every sum is taken in an order fixed by the plan, so the
// output is bit-identical from launch to launch (no atomics on values).
//
// The group descriptors travel by value as one kernel parameter (well under
// the 4 KB limit), so a launch copies nothing to the device beforehand.
// Launches that share a plan must not overlap (its counters); the port runs
// on one stream.
//
// Bound on an H100: bytes — every input row read once, every output written
// once, against 3.35 TB/s; the adds are negligible.  At the flagship build
// (~9 MB) that is ~3 us, below one launch's latency chain (chunk record ->
// row indices -> rows -> store), which this design keeps to four loads.

#include <cuda_runtime.h>

namespace {

constexpr int R = 32;           // rows per chunk: kernels/segsum.py R
constexpr int WARPS = 8;        // chunks (warps) per block
constexpr int MAX_GROUPS = 12;  // kernels/segsum.py MAX_GROUPS
constexpr int NC = 4;           // column accumulators per lane for k > 32

template <typename T>
struct Group {
  const T* vals;       // (n, k)
  T* out;              // (nseg, k)
  T* partials;         // (nchunks, k) scratch
  const int* perm;     // (n,)
  const int* offsets;  // (nseg + 1,)
  const int4* chunks;  // (nchunks,)
  int* counters;       // (nseg,), zero between launches
  int k;
};

template <typename T>
struct Params {
  Group<T> g[MAX_GROUPS];
  int first[MAX_GROUPS + 1];    // first chunk of each group in the launch
  int ngroups;
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    segsum_grouped(const __grid_constant__ Params<T> p) {
  __shared__ int s_rows[WARPS][R];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= p.first[p.ngroups]) return;
  int gi = 0;
  while (c >= p.first[gi + 1]) ++gi;
  const Group<T>& g = p.g[gi];
  const int lc = c - p.first[gi];
  const int4 ch = g.chunks[lc];
  const int seg = ch.x, nrows = ch.z, j = ch.w, k = g.k;
  if (seg < 0) return;                      // past the plan's last chunk

  int* rows = s_rows[warp];
  if (lane < nrows) rows[lane] = g.perm[ch.y + lane];
  __syncwarp();
  T* dst = j < 0 ? g.out + static_cast<long long>(seg) * k
                 : g.partials + static_cast<long long>(lc) * k;

  if (k <= 32) {
    // lane = slot * k + col; slot s adds rows s, s + slots, ...
    const int slots = 32 / k;
    const int slot = lane / k, col = lane - slot * k;
    T acc = T(0);
    if (slot < slots) {
#pragma unroll 4
      for (int i = slot; i < nrows; i += slots)
        acc += g.vals[static_cast<long long>(rows[i]) * k + col];
    }
    T total = acc;
    for (int s = 1; s < slots; ++s)
      total += __shfl_sync(0xffffffffu, acc, s * k + col);
    if (slot == 0) dst[col] = total;
  } else {
    for (int c0 = 0; c0 < k; c0 += 32 * NC) {
      T acc[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = T(0);
#pragma unroll 4
      for (int i = 0; i < nrows; ++i) {
        const T* row = g.vals + static_cast<long long>(rows[i]) * k;
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int col = c0 + 32 * q + lane;
          if (col < k) acc[q] += row[col];
        }
      }
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int col = c0 + 32 * q + lane;
        if (col < k) dst[col] = acc[q];
      }
    }
  }
  if (j < 0) return;

  // a chunk of a longer segment: the last to finish combines the partials
  const int m = (g.offsets[seg + 1] - g.offsets[seg] + R - 1) / R;
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(g.counters + seg, 1) == m - 1;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  __threadfence();
  const T* part = g.partials + static_cast<long long>(lc - j) * k;
  for (int col = lane; col < k; col += 32) {
    T s = T(0);
#pragma unroll 4
    for (int q = 0; q < m; ++q)
      s += __ldcg(part + static_cast<long long>(q) * k + col);
    g.out[static_cast<long long>(seg) * k + col] = s;
  }
  if (lane == 0) g.counters[seg] = 0;
}

template <typename T>
int launch(int ngroups, void* const* vals, void* const* outs,
           void* const* partials, void* const* perm, void* const* offsets,
           void* const* chunks, void* const* counters, const int* k,
           const int* nchunks, void* stream) {
  if (ngroups < 1 || ngroups > MAX_GROUPS)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p = {};
  for (int g = 0; g < ngroups; ++g) {
    p.g[g].vals = static_cast<const T*>(vals[g]);
    p.g[g].out = static_cast<T*>(outs[g]);
    p.g[g].partials = static_cast<T*>(partials[g]);
    p.g[g].perm = static_cast<const int*>(perm[g]);
    p.g[g].offsets = static_cast<const int*>(offsets[g]);
    p.g[g].chunks = static_cast<const int4*>(chunks[g]);
    p.g[g].counters = static_cast<int*>(counters[g]);
    p.g[g].k = k[g];
    p.first[g + 1] = p.first[g] + nchunks[g];
  }
  p.ngroups = ngroups;
  const int total = p.first[ngroups];
  if (total > 0) {
    segsum_grouped<T><<<(total + WARPS - 1) / WARPS, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_segsum_grouped_f32(int ngroups, void* const* vals, void* const* outs,
                          void* const* partials, void* const* perm,
                          void* const* offsets, void* const* chunks,
                          void* const* counters, const int* k,
                          const int* nchunks, void* stream) {
  return launch<float>(ngroups, vals, outs, partials, perm, offsets, chunks,
                       counters, k, nchunks, stream);
}

int ba_segsum_grouped_f64(int ngroups, void* const* vals, void* const* outs,
                          void* const* partials, void* const* perm,
                          void* const* offsets, void* const* chunks,
                          void* const* counters, const int* k,
                          const int* nchunks, void* stream) {
  return launch<double>(ngroups, vals, outs, partials, perm, offsets, chunks,
                        counters, k, nchunks, stream);
}

}  // extern "C"
