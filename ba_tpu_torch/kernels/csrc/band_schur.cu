// Kernel 7: the grouped banded Schur correction, written onto the band grid.
//
//   corr[a, d] = sum over landmarks l seen from poses a and a + d of
//                (Wb_{a,l} V_l^-1) Wb_{a+d,l}^T          (6 x 6)
//
// for a < P, 0 <= d < B, landmarks of LM = 1 (inverse depth) or 3 (XYZ)
// columns: Wb (Nw, 6, LM), V^-1 (L, LM, LM).
//
// Replaces the TPU formulation ba_tpu/solver/banded.py:_band_schur_grouped
// (:96-133): it materializes every landmark's pair products in an
// (L, B, B, 6, 6) tensor (678 MB in f32 at P = 2048, B = 24), sums it per
// anchor pose with a segment sum and folds it onto the band with B shifted
// adds.  Here nothing but the (P, B, 6, 6) output is written.
//
// Bound on an H100: bytes.  At the full-width trajectory (P = 2048, B = 24,
// Nw = 181,771 W blocks, f32) the function reads 4.4 MB of W blocks and
// 1.5 MB of their pose and landmark ids and writes 7.1 MB of output, ~3.9
// us at 3.35 TB/s; its ~2.1 M block pairs are 150 MFLOP, ~2.3 us at 67
// TFLOP/s.  The tile runs re-read the W blocks 2.4 times (16-pose tiles,
// B - 1 poses past each), from L2.
//
// What held the first version back (0.122 ms there): one block per pose,
// finding each partner through a chain of dependent loads (perm -> slot ->
// landmark -> (L, B) slot table -> W block) and gathering its 24-byte row
// from L2 in a sector of its own, three barriers per 32 blocks, two shared
// loads per FMA, and a 48 KB cap on shared memory that refused wide bands.
//
// Design.  The plan (kernels/band_schur.py:schur_plan, once per solve)
// sorts the kept W blocks by (pose, landmark): pose a's blocks are
// perm[off[a]:off[a+1]], ascending in landmark, with their landmark ids in
// `lms`.  One block of threads owns TP consecutive poses [a0, a0 + TP), one
// warp each; the partners of their W blocks are the blocks of poses
// [a0, a0 + TP + B - 1), one contiguous run of the sorted order.  The block
// stages that run once in shared memory, its landmark ids and its W values
// by 16-byte cp.async copies of the run's hull in the W block table (the
// plan's tile_src says where the run starts when it is consecutive rows of
// the table, as core/problem.py's pose-major table is; else the rows are
// gathered through perm), then u = Wb V^-1 of the tile's own rows, which
// lead the run, one thread a row.  The partners of poses a and a + d are
// the landmarks both sorted lists hold: lane d of pose a's warp walks pose
// a's list (the same for the whole warp, a broadcast) and advances its own
// pointer through pose a + d's, and on a match adds u_r w_q^T (LM terms
// each) into the 36 accumulators of block (a, d) it holds in registers.
// The outputs go out through shared memory, a pose's B x 36 values as
// contiguous 16-byte stores.  A run that does not fit (a wide band, a pose
// with very many landmarks, f64, XYZ) is walked in pieces of cl left rows
// and cr partner rows, left pieces outside, each lane keeping its
// accumulators: never refused.
//
// What bounds it (0.030 ms at full width, f32, chip_smoke.py on the
// H100): the merge loop, with 16 warps an SM (36 accumulators a lane take
// 128 registers).  Each left row costs every lane of the warp a step of
// the merge and, on the ~11.4 of B = 24 lanes that match (2,123,334 pairs
// over 181,771 rows), 36 FMAs that the whole warp executes, with the partner
// rows gathered from shared memory a row per lane.  Staging the run in
// device memory (the first version), 8-pose tiles, 18 accumulators a lane,
// V^-1 loaded in the loop and outputs written lane by lane (144-byte
// strides) were slower in development.
//
// Every output is the sum over its matched landmarks in ascending landmark
// order, however the run is cut into pieces: a piece pair finds exactly
// the matches whose two rows it holds, and pieces ascend in (pose,
// landmark) order.  No atomics, so two launches (and the piecewise and
// whole walks) are bit-identical; the walk is
// tests/test_torch_banded.py:_kernel7_walk.  The plan assumes one W block
// per (pose, landmark), as the keyed table of
// core/problem.py:_wblock_table_np holds.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TP = 16;      // poses per block, one warp each
constexpr int THREADS = TP * 32;

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

__host__ __device__ inline long long round16(long long n) {
  return (n + 15) & ~15LL;
}
// bytes that hold n bytes copied through their 16-byte hull
__host__ __device__ inline long long hull(long long n) {
  return round16(n + 32);
}

// Shared memory: the left rows' u = Wb V^-1 (and, walked in pieces, their
// landmark ids), then the partner rows' W values and landmark ids through
// their hulls.  A tile's whole run takes nl u rows and nr partner rows; a
// piece pair cl and cr.
template <typename T, int LM>
struct Layout {
  static constexpr long long RB = 6 * LM * sizeof(T);   // bytes of a row
  __host__ __device__ static long long whole(long long nl, long long nr) {
    return round16(nl * RB) + hull(nr * RB) + hull(nr * 4);
  }
  __host__ __device__ static long long pieces(long long cl, long long cr) {
    return round16(cl * RB) + round16(cl * 4) + hull(cr * RB) + hull(cr * 4);
  }
};

// 16-byte cp.async copies of the bytes [src, src + n) through their
// 16-byte hull into dst (16-byte aligned); returns where src lands
__device__ __forceinline__ const unsigned char* copy_hull(
    unsigned char* dst, const void* src, long long n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = s & ~static_cast<uintptr_t>(15);
  const long long n16 = (static_cast<long long>(s - a) + n + 15) >> 4;
  for (long long c = threadIdx.x; c < n16; c += THREADS)
    __pipeline_memcpy_async(dst + 16 * c,
                            reinterpret_cast<const void*>(a + 16 * c), 16);
  return dst + (s - a);
}

template <typename T, int LM>
__global__ void __launch_bounds__(THREADS)
    band_schur_kernel(const T* __restrict__ wb, const T* __restrict__ vinv,
                      const int* __restrict__ perm,
                      const int* __restrict__ offsets,
                      const int* __restrict__ lms,
                      const int* __restrict__ tile_src, int P, int B,
                      long long smem, int cl, int cr, T* __restrict__ out) {
  constexpr int R = 6 * LM;  // values of a W block
  using V2 = typename Vec2<T>::type;
  using Ly = Layout<T, LM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int a0 = blockIdx.x * TP;
  const int a1 = min(P, a0 + TP), w1 = min(P, a0 + TP + B - 1);
  const int L0 = offsets[a0], L1 = offsets[a1], R1 = offsets[w1];
  const bool single = Ly::whole(L1 - L0, R1 - L0) <= smem;
  const int nlp = single ? 1 : max(1, (L1 - L0 + cl - 1) / cl);
  const int nrp = single ? 1 : max(1, (R1 - L0 + cr - 1) / cr);
  // the W blocks of the run are wb rows src, src + 1, ... (-1: gathered
  // through perm)
  const int src = tile_src[blockIdx.x];
  // regions: u of the left rows, (pieces) their ids, the partner rows
  T* s_u = reinterpret_cast<T*>(smem_raw);
  const int ucap = single ? L1 - L0 : cl;
  int* s_ll = reinterpret_cast<int*>(smem_raw + round16(ucap * Ly::RB));
  unsigned char* s_w = smem_raw + round16(ucap * Ly::RB) +
                       (single ? 0 : round16(4LL * cl));
  unsigned char* s_l = s_w + hull((single ? R1 - L0 : cr) * Ly::RB);

  const int lane = threadIdx.x & 31;
  const int a = a0 + (threadIdx.x >> 5);
  const bool pose_ok = a < P;
  const int la = pose_ok ? offsets[a] : 0, le_a = pose_ok ? offsets[a + 1] : 0;

  // sorted rows [r0, r1): W values and landmark ids into the partner
  // buffers, landing at *w and *l (row r0)
  auto stage = [&](int r0, int r1, const T*& w, const int*& l) {
    const int n = r1 - r0;
    l = reinterpret_cast<const int*>(
        copy_hull(s_l, lms + r0, static_cast<long long>(n) * 4));
    if (src >= 0) {
      w = reinterpret_cast<const T*>(copy_hull(
          s_w, wb + (static_cast<long long>(src) + r0 - L0) * R,
          static_cast<long long>(n) * Ly::RB));
    } else {
      constexpr int H = R / 2;
      V2* dst = reinterpret_cast<V2*>(s_w);
      for (int idx = threadIdx.x; idx < n * H; idx += THREADS) {
        const int k = idx / H, h = idx - k * H;
        dst[idx] = reinterpret_cast<const V2*>(
            wb + static_cast<long long>(perm[r0 + k]) * R)[h];
      }
      w = reinterpret_cast<const T*>(dst);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  };
  // u = Wb V^-1 of the staged rows [0, n) into s_u, one thread a row;
  // with `ids`, their landmark ids into s_ll
  auto left_u = [&](const T* w, const int* l, int n, bool ids) {
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const int lk = l[k];
      const T* V = vinv + static_cast<long long>(lk) * LM * LM;
      T v[LM * LM];
#pragma unroll
      for (int t = 0; t < LM * LM; ++t) v[t] = __ldg(V + t);
      const T* wr = w + static_cast<long long>(k) * R;
      T* ur = s_u + static_cast<long long>(k) * R;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int m = 0; m < LM; ++m) {
          T s = wr[i * LM] * v[m];
#pragma unroll
          for (int c = 1; c < LM; ++c) s = fma(wr[i * LM + c], v[c * LM + m], s);
          ur[i * LM + m] = s;
        }
      }
      if (ids) s_ll[k] = lk;
    }
    __syncthreads();
  };
  // the W values of staged row k of `base`
  auto load_row = [&](const T* base, int k, T* v) {
    const V2* q = reinterpret_cast<const V2*>(base + static_cast<long long>(k)
                                              * R);
#pragma unroll
    for (int h = 0; h < R / 2; ++h) {
      const V2 x = q[h];
      v[2 * h] = x.x;
      v[2 * h + 1] = x.y;
    }
  };

  const T* rw = nullptr;
  const int *ll = nullptr, *rl = nullptr;
  if (single) {
    stage(L0, R1, rw, rl);
    left_u(rw, rl, L1 - L0, false);
    ll = rl;  // the tile's own rows lead the run
  }
  const int nch = (B + 31) / 32;
  // one chunk of lanes and the whole run staged: the outputs go out
  // through the shared memory the run took
  const bool staged_out =
      single && nch == 1 && static_cast<long long>(TP) * B * 36 * sizeof(T)
                                <= smem;
  for (int c = 0; c < nch; ++c) {
    const int d = c * 32 + lane;
    const bool live = pose_ok && d < B && a + d < P;
    const int ra = live ? offsets[a + d] : 0;
    const int re_a = live ? offsets[a + d + 1] : 0;
    T acc[36];
#pragma unroll
    for (int t = 0; t < 36; ++t) acc[t] = T(0);
    for (int lp = 0; lp < nlp; ++lp) {
      const int lp0 = single ? L0 : L0 + lp * cl;
      const int lp1 = single ? L1 : min(L1, lp0 + cl);
      for (int rp = 0; rp < nrp; ++rp) {
        const int rp0 = single ? L0 : L0 + rp * cr;
        const int rp1 = single ? R1 : min(R1, rp0 + cr);
        if (!single) {
          __syncthreads();  // the previous pieces' readers are done
          const T* lw;
          const int* l0;
          stage(lp0, lp1, lw, l0);
          left_u(lw, l0, lp1 - lp0, true);
          ll = s_ll;
          stage(rp0, rp1, rw, rl);
        }
        if (!pose_ok) continue;  // the whole warp
        const int lb = max(la, lp0), le = min(le_a, lp1);
        int j = max(ra, rp0);
        const int je = min(re_a, rp1);
        // the landmark of partner row j, INT_MAX past the end
        int lj = j < je ? rl[j - rp0] : INT_MAX;
        for (int r = lb; r < le; ++r) {
          const int l = ll[r - lp0];
          T u[R];
          load_row(s_u, r - lp0, u);
          while (lj < l) {
            ++j;
            lj = j < je ? rl[j - rp0] : INT_MAX;
          }
          if (lj == l) {
            T w[R];
            load_row(rw, j - rp0, w);
#pragma unroll
            for (int i = 0; i < 6; ++i) {
#pragma unroll
              for (int jj = 0; jj < 6; ++jj) {
                T s = acc[i * 6 + jj];
#pragma unroll
                for (int m = 0; m < LM; ++m)
                  s = fma(u[i * LM + m], w[jj * LM + m], s);
                acc[i * 6 + jj] = s;
              }
            }
            ++j;
            lj = j < je ? rl[j - rp0] : INT_MAX;
          }
        }
      }
    }
    if (staged_out) {
      // through shared memory (the staged rows are done with), so that the
      // pose's B x 36 outputs go out as contiguous 16-byte stores
      __syncthreads();
      T* so = reinterpret_cast<T*>(smem_raw) +
              static_cast<long long>(threadIdx.x >> 5) * B * 36;
      if (pose_ok && d < B) {
#pragma unroll
        for (int h = 0; h < 18; ++h) {
          V2 v;
          v.x = acc[2 * h];
          v.y = acc[2 * h + 1];
          reinterpret_cast<V2*>(so + d * 36)[h] = v;
        }
      }
      __syncwarp();
      if (pose_ok) {
        const int n16 = B * 36 * static_cast<int>(sizeof(T)) / 16;
        const float4* s4 = reinterpret_cast<const float4*>(so);
        float4* d4 = reinterpret_cast<float4*>(out + static_cast<long long>(a)
                                               * B * 36);
        for (int t = lane; t < n16; t += 32) d4[t] = s4[t];
      }
    } else if (pose_ok && d < B) {
      V2* dst = reinterpret_cast<V2*>(out + (static_cast<long long>(a) * B +
                                             d) * 36);
#pragma unroll
      for (int h = 0; h < 18; ++h) {
        V2 v;
        v.x = acc[2 * h];
        v.y = acc[2 * h + 1];
        dst[h] = v;
      }
    }
  }
}

template <typename T, int LM>
int launch(const void* wb, const void* vinv, const void* perm,
           const void* offsets, const void* lms, const void* tile_src, int P,
           int B, int smem_kb, int cl, int cr, void* out, void* stream) {
  if (P < 0 || B < 1 || smem_kb < 1 || cl < 1 || cr < cl ||
      (reinterpret_cast<uintptr_t>(wb) & 15) ||
      (reinterpret_cast<uintptr_t>(lms) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  long long smem = 1024LL * smem_kb;
  const long long need = Layout<T, LM>::pieces(cl, cr);
  if (need > smem) smem = need;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        band_schur_kernel<T, LM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  band_schur_kernel<T, LM><<<(P + TP - 1) / TP, THREADS,
                             static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wb), static_cast<const T*>(vinv),
      static_cast<const int*>(perm), static_cast<const int*>(offsets),
      static_cast<const int*>(lms), static_cast<const int*>(tile_src), P, B,
      smem, cl, cr, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lm(int lm, const void* wb, const void* vinv, const void* perm,
              const void* offsets, const void* lms, const void* tile_src,
              int P, int B, int smem_kb, int cl, int cr, void* out,
              void* stream) {
  switch (lm) {
    case 1:
      return launch<T, 1>(wb, vinv, perm, offsets, lms, tile_src, P, B,
                          smem_kb, cl, cr, out, stream);
    case 3:
      return launch<T, 3>(wb, vinv, perm, offsets, lms, tile_src, P, B,
                          smem_kb, cl, cr, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int ba_band_schur_f32(int lm, const void* wb, const void* vinv,
                      const void* perm, const void* offsets, const void* lms,
                      const void* tile_src, int P, int B, int smem_kb, int cl,
                      int cr, void* out, void* stream) {
  return launch_lm<float>(lm, wb, vinv, perm, offsets, lms, tile_src, P, B,
                          smem_kb, cl, cr, out, stream);
}

int ba_band_schur_f64(int lm, const void* wb, const void* vinv,
                      const void* perm, const void* offsets, const void* lms,
                      const void* tile_src, int P, int B, int smem_kb, int cl,
                      int cr, void* out, void* stream) {
  return launch_lm<double>(lm, wb, vinv, perm, offsets, lms, tile_src, P, B,
                           smem_kb, cl, cr, out, stream);
}

}  // extern "C"
