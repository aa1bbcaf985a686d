// Kernel 6: the projection family's share of the matrix-free Schur product
// S x = (U - W V^-1 W^T) x, for landmarks of LM = 0, 1 or 3 columns and a
// calibration block of K = 0, 5, 6 or 11 columns (calib_size 0 or 5, with
// or without the 6 T_vs tangents).
//
// For every landmark l and each of its projection rows n:
//
//   u_n  = J_m[n] x[pose_n] + J_r[n] x[ref_n] + J_c[n] x_k   (2 values)
//   wt_l = sum_n j_l[n]^T u_n                           (W^T x, LM values)
//   z_l  = V_l^-1 wt_l
//   w_n  = u_n - j_l[n] z_l                             (w_n = u_n at LM 0)
//   out[n] = [J_m[n]^T w_n, J_r[n]^T w_n]               (6 + 6 values)
//   y_k  = sum_n J_c[n]^T w_n                           (K values)
//
// Replaces the TPU formulation ba_tpu/solver/cg.py:s_matvec (:160) with its
// applies _u_apply (:123), _wt_apply (:103) and _w_apply (:111): per-row
// einsums, a segment sum by landmark, a gather of z back to the rows, and
// segment sums by pose, each through device memory.
//
// Two kernels.  `pack` (once per build, solver/cg.py:assemble_blocks) copies
// the row blocks into the landmark-sorted order of the block plan's V
// segment plan, one 16-byte-aligned record per row: [J_m | J_r | j_l |
// J_c | pad], NV 16-byte units.  `schur_matvec` (once per PCG iteration) reads
// each record once, with 16-byte loads of contiguous rows into shared
// memory, and writes the 12 outputs of row i of that order to out[i], 16
// bytes at a time; segsum then sums the rows by pose on a plan of the
// sorted [pose_i, ref_i] ids (SchurPlan.out_pose), with the unary, binary
// and IMU rows.
//
// Work: one thread per row.  A group is a landmark's rows, or one row whose
// landmark id is out of range (z = 0).  Tile t (one block) takes the groups
// that start in rows [t H, (t + 1) H) of the sorted order (tiles[t] is the
// first group start at or past t H), so a group never crosses a block, and
// a tile holds at most H groups.  A tile of at most ROWS rows (every tile
// when no landmark is longer than ROWS - H + 1 = 33 rows; the simulator's
// have at most 23) keeps u_n in registers between the landmark reduction
// and the output: one read of each row.  A longer tile walks its rows in
// chunks of ROWS and reads them again, from L2, for the output.
//
// Landmark sums in a fixed order, no atomics: thread k of a chunk adds the
// chunk's rows of its k-th group to the group's running sum in row order,
// so every group sums its rows first to last from 0 and two launches are
// bit-identical.  The plain version in this order is
// kernels/schur_matvec.py:schur_matvec_sorted_plain.
//
// The calibration sum, no atomics either: x_k sits in shared memory; each
// thread adds J_c^T w_n of its rows (chunk after chunk) in a register,
// the block sums its threads by warp shuffles and then warp by warp, in a
// fixed order, and writes one (K,) partial per tile (zeros for a tile
// with no rows); segsum adds the tiles' partials in tile order (one more
// group of the product's launch, `BlockPlan.cal`).
//
// Bound on an H100: bytes.  At the PCG configuration (Nr = 85,823 rows,
// P = 1,024, D = 9, lm 1, f32) the function needs J_m, J_r and j_l (26
// values a row, 8.9 MB), the pose, ref and landmark ids (12 B a row, 1.0
// MB), V^-1, x and the tile table, and writes 12 values a row (4.1 MB):
// ~14.1 MB, ~4.2 us at 3.35 TB/s.  The route reads the records' 2 pad
// values and the int4 ids' group field besides (~15.2 MB in all).  The
// ~100 flop per row are 8.6 MFLOP, 0.13 us at 67 TFLOP/s.  The pack reads
// the row blocks (8.9 MB) and the order and writes the records once a
// build.  With the calibration block (K = 11, lm 1, f32) a row needs 22
// values more (J_c) and 4 K flop more: ~21.7 MB at 85,823 rows, ~6.5 us.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 256;   // rows per chunk, one a thread
constexpr int H = 224;      // a tile takes the groups that start in H rows

template <typename T, int LM, int K>
struct Layout {
  static constexpr int JC = 24 + 2 * LM;       // first value of J_c
  static constexpr int NJ = JC + 2 * K;        // J_m, J_r, j_l, J_c
  static constexpr int U = 16 / sizeof(T);     // values per 16-byte unit
  static constexpr int NV = (NJ + U - 1) / U;  // units per record
  static constexpr int SV = NV | 1;            // units per row in shared
  //                                              memory (odd: conflict-free)
  static constexpr int OV = 12 / U;            // units per output row
  static constexpr int LMS = LM > 0 ? LM : 1;
  static constexpr int KS = K > 0 ? K : 1;
};

template <typename T, int LM, int K>
__global__ void __launch_bounds__(ROWS)
    pack_kernel(const T* __restrict__ jm, const T* __restrict__ jr,
                const T* __restrict__ jl, const T* __restrict__ jc,
                const int* __restrict__ perm, int Nr, T* __restrict__ pack) {
  using Ly = Layout<T, LM, K>;
  const int e = blockIdx.x * ROWS + threadIdx.x;  // one unit of the records
  if (e >= Nr * Ly::NV) return;
  const int i = e / Ly::NV, v = e - i * Ly::NV;
  const long long n = perm[i];
  struct alignas(16) Unit {
    T v[Ly::U];
  } out;
#pragma unroll
  for (int q = 0; q < Ly::U; ++q) {
    const int c = v * Ly::U + q;
    out.v[q] = c < 12   ? jm[n * 12 + c]
               : c < 24 ? jr[n * 12 + c - 12]
               : c < Ly::JC ? jl[n * 2 * LM + c - 24]
               : c < Ly::NJ ? jc[n * 2 * K + c - Ly::JC]
                            : T(0);
  }
  reinterpret_cast<Unit*>(pack)[e] = out;
}

// the records of rows [c0, c0 + n) into shared memory, 16 bytes a thread
template <typename T, int LM, int K>
__device__ __forceinline__ void stage(const T* __restrict__ pack, int c0,
                                      int n, uint4* rows) {
  using Ly = Layout<T, LM, K>;
  const uint4* src = reinterpret_cast<const uint4*>(pack)
                     + static_cast<long long>(c0) * Ly::NV;
  for (int v = threadIdx.x; v < n * Ly::NV; v += ROWS) {
    const int r = v / Ly::NV;
    rows[r * Ly::SV + v - r * Ly::NV] = __ldg(src + v);
  }
}

template <typename T, int LM, int K>
struct Row {
  alignas(16) T v[Layout<T, LM, K>::NV * Layout<T, LM, K>::U];
};

template <typename T, int LM, int K>
__device__ __forceinline__ void load_row(const uint4* rows, int r,
                                         Row<T, LM, K>& row) {
  using Ly = Layout<T, LM, K>;
#pragma unroll
  for (int k = 0; k < Ly::NV; ++k)
    reinterpret_cast<uint4*>(row.v)[k] = rows[r * Ly::SV + k];
}

// u = J_m x[pose] + J_r x[ref] + J_c x_k (x_k in shared memory)
template <typename T, int LM, int K>
__device__ __forceinline__ void row_u(const Row<T, LM, K>& row,
                                      const T* __restrict__ x,
                                      const T* xk, int4 id, int D, T& u0,
                                      T& u1) {
  const T* xm = x + static_cast<long long>(id.x) * D;
  const T* xr = x + static_cast<long long>(id.y) * D;
  T a0 = T(0), a1 = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T xmk = __ldg(xm + k), xrk = __ldg(xr + k);
    a0 += row.v[k] * xmk + row.v[12 + k] * xrk;
    a1 += row.v[6 + k] * xmk + row.v[18 + k] * xrk;
  }
  if constexpr (K > 0) {
    constexpr int JC = Layout<T, LM, K>::JC;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a0 += row.v[JC + k] * xk[k];
      a1 += row.v[JC + K + k] * xk[k];
    }
  }
  u0 = a0;
  u1 = a1;
}

template <typename T, int LM, int K>
__global__ void __launch_bounds__(ROWS)
    schur_matvec_kernel(const T* __restrict__ pack,
                        const int4* __restrict__ ids,
                        const int* __restrict__ tiles,
                        const T* __restrict__ vinv, const T* __restrict__ x,
                        const T* __restrict__ xk_in, int D,
                        T* __restrict__ out, T* __restrict__ partial) {
  using Ly = Layout<T, LM, K>;
  constexpr int LMS = Ly::LMS;
  constexpr int KS = Ly::KS;
  extern __shared__ uint4 rows[];       // ROWS x SV units: the chunk's
  //                                       records, then its outputs
  __shared__ T part[ROWS * LMS];        // j_l^T u of each row of the chunk
  __shared__ T acc[H * LMS];            // the tile's group sums, then z
  __shared__ int grp[ROWS];             // group of each row of the chunk
  __shared__ int gstart[ROWS + 1];      // first row of the chunk's groups
  __shared__ int glm[H];                // landmark of the tile's groups
  __shared__ T xk[KS];                  // the calibration part of x
  __shared__ T red[(ROWS / 32) * KS];   // the warps' calibration sums

  const int tid = threadIdx.x;
  const int s = tiles[blockIdx.x], e = tiles[blockIdx.x + 1];
  if (s >= e) {
    if constexpr (K > 0) {
      if (tid < K) partial[blockIdx.x * K + tid] = T(0);
    }
    return;
  }
  // read after the first __syncthreads below, whichever pass comes first
  if constexpr (K > 0) {
    if (tid < K) xk[tid] = __ldg(xk_in + tid);
  }
  T cal[KS];                            // J_c^T w of this thread's rows
#pragma unroll
  for (int k = 0; k < KS; ++k) cal[k] = T(0);
  const bool one = e - s <= ROWS;       // the rows stay in shared memory
  int g0 = 0, ng = 0;
  if constexpr (LM > 0) {
    g0 = ids[s].z;
    for (int k = tid; k < H * LM; k += ROWS) acc[k] = T(0);
  }
  int4 id = make_int4(0, 0, 0, -1);
  T u0 = T(0), u1 = T(0);
  Row<T, LM, K> row;

  // u of every row; with landmark columns, the group sums of j_l^T u (at
  // LM 0 a long tile computes u in the output pass alone)
  for (int c0 = s; c0 < e && (LM > 0 || one); c0 += ROWS) {
    const int n = min(ROWS, e - c0);
    stage<T, LM, K>(pack, c0, n, rows);
    if (tid < n) id = ids[c0 + tid];
    __syncthreads();
    if (tid < n) {
      load_row<T, LM, K>(rows, tid, row);
      row_u<T, LM, K>(row, x, xk, id, D, u0, u1);
      if constexpr (LM > 0) {
#pragma unroll
        for (int j = 0; j < LMS; ++j)
          part[tid * LMS + j] =
              row.v[24 + j] * u0 + row.v[24 + LMS + j] * u1;
        grp[tid] = id.z;
      }
    }
    if constexpr (LM > 0) {
      __syncthreads();
      const int gf = grp[0];
      const int ngc = grp[n - 1] - gf + 1;
      if (tid < n && (tid == 0 || grp[tid - 1] != grp[tid])) {
        gstart[grp[tid] - gf] = tid;
        glm[grp[tid] - g0] = id.w;
      }
      if (tid == 0) gstart[ngc] = n;
      __syncthreads();
      if (tid < ngc) {
        T* a = acc + (gf - g0 + tid) * LMS;
        T sum[LMS];
#pragma unroll
        for (int j = 0; j < LMS; ++j) sum[j] = a[j];
        for (int r = gstart[tid]; r < gstart[tid + 1]; ++r) {
#pragma unroll
          for (int j = 0; j < LMS; ++j) sum[j] += part[r * LMS + j];
        }
#pragma unroll
        for (int j = 0; j < LMS; ++j) a[j] = sum[j];
      }
      ng = gf - g0 + ngc;
    }
    if (!one) __syncthreads();
  }

  // z = V^-1 wt of each group, in place of its sum (0 past the landmarks)
  if constexpr (LM > 0) {
    __syncthreads();
    if (tid < ng) {
      const int l = glm[tid];
      T* a = acc + tid * LMS;
      T z[LMS];
#pragma unroll
      for (int i = 0; i < LMS; ++i) {
        T zi = T(0);
        if (l >= 0) {
          const T* vi = vinv + (static_cast<long long>(l) * LMS + i) * LMS;
#pragma unroll
          for (int j = 0; j < LMS; ++j) zi += __ldg(vi + j) * a[j];
        }
        z[i] = zi;
      }
#pragma unroll
      for (int i = 0; i < LMS; ++i) a[i] = z[i];
    }
    __syncthreads();
  }

  // w = u - j_l z, then [J_m^T w, J_r^T w] through shared memory
  for (int c0 = s; c0 < e; c0 += ROWS) {
    const int n = min(ROWS, e - c0);
    if (!one) {
      stage<T, LM, K>(pack, c0, n, rows);
      if (tid < n) id = ids[c0 + tid];
      __syncthreads();
      if (tid < n) {
        load_row<T, LM, K>(rows, tid, row);
        row_u<T, LM, K>(row, x, xk, id, D, u0, u1);
      }
    }
    alignas(16) T o[12];
    if (tid < n) {
      T w0 = u0, w1 = u1;
      if constexpr (LM > 0) {
        const T* z = acc + (id.z - g0) * LMS;
        T d0 = T(0), d1 = T(0);
#pragma unroll
        for (int j = 0; j < LMS; ++j) {
          d0 += row.v[24 + j] * z[j];
          d1 += row.v[24 + LMS + j] * z[j];
        }
        w0 = u0 - d0;
        w1 = u1 - d1;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        o[k] = row.v[k] * w0 + row.v[6 + k] * w1;
        o[6 + k] = row.v[12 + k] * w0 + row.v[18 + k] * w1;
      }
      if constexpr (K > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          cal[k] += row.v[Ly::JC + k] * w0 + row.v[Ly::JC + K + k] * w1;
      }
    }
    __syncthreads();                    // every record read
    if (tid < n) {
#pragma unroll
      for (int k = 0; k < Ly::OV; ++k)
        rows[tid * Ly::SV + k] = reinterpret_cast<const uint4*>(o)[k];
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(out)
                 + static_cast<long long>(c0) * Ly::OV;
    for (int v = tid; v < n * Ly::OV; v += ROWS) {
      const int r = v / Ly::OV;
      dst[v] = rows[r * Ly::SV + v - r * Ly::OV];
    }
    if (!one) __syncthreads();
  }

  // the tile's calibration partial: threads summed by warp shuffles, then
  // the warps in order
  if constexpr (K > 0) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T v = cal[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp * K + k] = v;
    }
    __syncthreads();
    if (tid < K) {
      T sum = T(0);
#pragma unroll
      for (int w = 0; w < ROWS / 32; ++w) sum += red[w * K + tid];
      partial[blockIdx.x * K + tid] = sum;
    }
  }
}

template <typename T, int LM, int K>
int launch_pack(const void* jm, const void* jr, const void* jl,
                const void* jc, const void* perm, int Nr, void* pack,
                void* stream) {
  using Ly = Layout<T, LM, K>;
  if (Nr < 0 || static_cast<long long>(Nr) * Ly::NV >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = Nr * Ly::NV;
  if (units == 0) return 0;
  pack_kernel<T, LM, K><<<(units + ROWS - 1) / ROWS, ROWS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(jm), static_cast<const T*>(jr),
      static_cast<const T*>(jl), static_cast<const T*>(jc),
      static_cast<const int*>(perm), Nr, static_cast<T*>(pack));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LM, int K>
int launch(const void* pack, const void* ids, const void* tiles, int n_tiles,
           const void* vinv, const void* x, const void* xk, int D,
           void* out, void* partial, void* stream) {
  using Ly = Layout<T, LM, K>;
  if (n_tiles < 0 || D < 6) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const int smem = ROWS * Ly::SV * 16;
  // the kernel's static shared memory (part, acc, grp, gstart, glm, xk,
  // red, and up to 256 bytes of alignment): past 48 KB with the dynamic
  // part, the launch needs the attribute
  constexpr int stat = (ROWS + H) * Ly::LMS * int(sizeof(T))
                       + (2 * ROWS + 1 + H) * 4
                       + (1 + ROWS / 32) * Ly::KS * int(sizeof(T)) + 256;
  // the attribute is per device: set it on every launch (cheap)
  if (smem + stat > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        schur_matvec_kernel<T, LM, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  schur_matvec_kernel<T, LM, K><<<n_tiles, ROWS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pack), static_cast<const int4*>(ids),
      static_cast<const int*>(tiles), static_cast<const T*>(vinv),
      static_cast<const T*>(x), static_cast<const T*>(xk), D,
      static_cast<T*>(out), static_cast<T*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// the calibration widths kernel 1 covers: calib_size 0 or 5, with or
// without the 6 T_vs tangents
template <typename T, int LM>
int pack_k(int K, const void* jm, const void* jr, const void* jl,
           const void* jc, const void* perm, int Nr, void* pack,
           void* stream) {
  switch (K) {
    case 0: return launch_pack<T, LM, 0>(jm, jr, jl, jc, perm, Nr, pack,
                                         stream);
    case 5: return launch_pack<T, LM, 5>(jm, jr, jl, jc, perm, Nr, pack,
                                         stream);
    case 6: return launch_pack<T, LM, 6>(jm, jr, jl, jc, perm, Nr, pack,
                                         stream);
    case 11: return launch_pack<T, LM, 11>(jm, jr, jl, jc, perm, Nr, pack,
                                           stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int pack_lm(int lm, int K, const void* jm, const void* jr, const void* jl,
            const void* jc, const void* perm, int Nr, void* pack,
            void* stream) {
  switch (lm) {
    case 0: return pack_k<T, 0>(K, jm, jr, jl, jc, perm, Nr, pack, stream);
    case 1: return pack_k<T, 1>(K, jm, jr, jl, jc, perm, Nr, pack, stream);
    case 3: return pack_k<T, 3>(K, jm, jr, jl, jc, perm, Nr, pack, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int LM>
int matvec_k(int K, const void* pack, const void* ids, const void* tiles,
             int n_tiles, const void* vinv, const void* x, const void* xk,
             int D, void* out, void* partial, void* stream) {
  switch (K) {
    case 0:
      return launch<T, LM, 0>(pack, ids, tiles, n_tiles, vinv, x, xk, D,
                              out, partial, stream);
    case 5:
      return launch<T, LM, 5>(pack, ids, tiles, n_tiles, vinv, x, xk, D,
                              out, partial, stream);
    case 6:
      return launch<T, LM, 6>(pack, ids, tiles, n_tiles, vinv, x, xk, D,
                              out, partial, stream);
    case 11:
      return launch<T, LM, 11>(pack, ids, tiles, n_tiles, vinv, x, xk, D,
                               out, partial, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int matvec_lm(int lm, int K, const void* pack, const void* ids,
              const void* tiles, int n_tiles, const void* vinv,
              const void* x, const void* xk, int D, void* out,
              void* partial, void* stream) {
  switch (lm) {
    case 0:
      return matvec_k<T, 0>(K, pack, ids, tiles, n_tiles, vinv, x, xk, D,
                            out, partial, stream);
    case 1:
      return matvec_k<T, 1>(K, pack, ids, tiles, n_tiles, vinv, x, xk, D,
                            out, partial, stream);
    case 3:
      return matvec_k<T, 3>(K, pack, ids, tiles, n_tiles, vinv, x, xk, D,
                            out, partial, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// j_m, j_r (Nr, 2, 6), j_l (Nr, 2, lm), j_c (Nr, 2, K) in row order, perm
// (Nr,) int32 -> pack (Nr, record width) in the order of perm
int ba_schur_pack_f32(int lm, int K, const void* jm, const void* jr,
                      const void* jl, const void* jc, const void* perm,
                      int Nr, void* pack, void* stream) {
  return pack_lm<float>(lm, K, jm, jr, jl, jc, perm, Nr, pack, stream);
}

int ba_schur_pack_f64(int lm, int K, const void* jm, const void* jr,
                      const void* jl, const void* jc, const void* perm,
                      int Nr, void* pack, void* stream) {
  return pack_lm<double>(lm, K, jm, jr, jl, jc, perm, Nr, pack, stream);
}

// pack, ids (Nr, 4) int32, tiles (n_tiles + 1,) int32, vinv (L, lm, lm),
// x (P * D,), x_k (K,) -> out (Nr, 2, 6) in the order of the pack and,
// for K > 0, partial (n_tiles, K): each tile's sum of J_c^T w
int ba_schur_matvec_f32(int lm, int K, const void* pack, const void* ids,
                        const void* tiles, int n_tiles, const void* vinv,
                        const void* x, const void* xk, int D, void* out,
                        void* partial, void* stream) {
  return matvec_lm<float>(lm, K, pack, ids, tiles, n_tiles, vinv, x, xk, D,
                          out, partial, stream);
}

int ba_schur_matvec_f64(int lm, int K, const void* pack, const void* ids,
                        const void* tiles, int n_tiles, const void* vinv,
                        const void* x, const void* xk, int D, void* out,
                        void* partial, void* stream) {
  return matvec_lm<double>(lm, K, pack, ids, tiles, n_tiles, vinv, x, xk,
                           D, out, partial, stream);
}

}  // extern "C"
