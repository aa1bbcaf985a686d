// Kernel 6: the projection family's share of the matrix-free Schur product
// S x = (U - W V^-1 W^T) x, for landmarks of LM = 0, 1 or 3 columns.
//
// For every landmark l and each of its projection rows n:
//
//   u_n  = J_m[n] x[pose_n] + J_r[n] x[ref_n]          (2 values)
//   wt_l = sum_n j_l[n]^T u_n                           (W^T x, LM values)
//   z_l  = V_l^-1 wt_l
//   w_n  = u_n - j_l[n] z_l                             (w_n = u_n at LM 0)
//   out[n] = [J_m[n]^T w_n, J_r[n]^T w_n]               (6 + 6 values)
//
// Replaces the TPU formulation ba_tpu/solver/cg.py:s_matvec (:160) with its
// applies _u_apply (:123), _wt_apply (:103) and _w_apply (:111): per-row
// einsums, a segment sum by landmark, a gather of z back to the rows, and
// segment sums by pose, each through device memory.
//
// Two kernels.  `pack` (once per build, solver/cg.py:assemble_blocks) copies
// the row blocks into the landmark-sorted order of the block plan's V
// segment plan, one 16-byte-aligned record per row: [J_m | J_r | j_l |
// pad], NV 16-byte units.  `schur_matvec` (once per PCG iteration) reads
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
// Bound on an H100: bytes.  At the PCG configuration (Nr = 85,823 rows,
// P = 1,024, D = 9, lm 1, f32) the function needs J_m, J_r and j_l (26
// values a row, 8.9 MB), the pose, ref and landmark ids (12 B a row, 1.0
// MB), V^-1, x and the tile table, and writes 12 values a row (4.1 MB):
// ~14.1 MB, ~4.2 us at 3.35 TB/s.  The route reads the records' 2 pad
// values and the int4 ids' group field besides (~15.2 MB in all).  The
// ~100 flop per row are 8.6 MFLOP, 0.13 us at 67 TFLOP/s.  The pack reads
// the row blocks (8.9 MB) and the order and writes the records once a
// build.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 256;   // rows per chunk, one a thread
constexpr int H = 224;      // a tile takes the groups that start in H rows

template <typename T, int LM>
struct Layout {
  static constexpr int NJ = 24 + 2 * LM;       // J_m, J_r, j_l
  static constexpr int U = 16 / sizeof(T);     // values per 16-byte unit
  static constexpr int NV = (NJ + U - 1) / U;  // units per record
  static constexpr int SV = NV | 1;            // units per row in shared
  //                                              memory (odd: conflict-free)
  static constexpr int OV = 12 / U;            // units per output row
  static constexpr int LMS = LM > 0 ? LM : 1;
};

template <typename T, int LM>
__global__ void __launch_bounds__(ROWS)
    pack_kernel(const T* __restrict__ jm, const T* __restrict__ jr,
                const T* __restrict__ jl, const int* __restrict__ perm,
                int Nr, T* __restrict__ pack) {
  using Ly = Layout<T, LM>;
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
               : c < Ly::NJ ? jl[n * 2 * LM + c - 24]
                            : T(0);
  }
  reinterpret_cast<Unit*>(pack)[e] = out;
}

// the records of rows [c0, c0 + n) into shared memory, 16 bytes a thread
template <typename T, int LM>
__device__ __forceinline__ void stage(const T* __restrict__ pack, int c0,
                                      int n, uint4* rows) {
  using Ly = Layout<T, LM>;
  const uint4* src = reinterpret_cast<const uint4*>(pack)
                     + static_cast<long long>(c0) * Ly::NV;
  for (int v = threadIdx.x; v < n * Ly::NV; v += ROWS) {
    const int r = v / Ly::NV;
    rows[r * Ly::SV + v - r * Ly::NV] = __ldg(src + v);
  }
}

template <typename T, int LM>
struct Row {
  alignas(16) T v[Layout<T, LM>::NV * Layout<T, LM>::U];
};

template <typename T, int LM>
__device__ __forceinline__ void load_row(const uint4* rows, int r,
                                         Row<T, LM>& row) {
  using Ly = Layout<T, LM>;
#pragma unroll
  for (int k = 0; k < Ly::NV; ++k)
    reinterpret_cast<uint4*>(row.v)[k] = rows[r * Ly::SV + k];
}

// u = J_m x[pose] + J_r x[ref]
template <typename T, int LM>
__device__ __forceinline__ void row_u(const Row<T, LM>& row,
                                      const T* __restrict__ x, int4 id,
                                      int D, T& u0, T& u1) {
  const T* xm = x + static_cast<long long>(id.x) * D;
  const T* xr = x + static_cast<long long>(id.y) * D;
  T a0 = T(0), a1 = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T xmk = __ldg(xm + k), xrk = __ldg(xr + k);
    a0 += row.v[k] * xmk + row.v[12 + k] * xrk;
    a1 += row.v[6 + k] * xmk + row.v[18 + k] * xrk;
  }
  u0 = a0;
  u1 = a1;
}

template <typename T, int LM>
__global__ void __launch_bounds__(ROWS)
    schur_matvec_kernel(const T* __restrict__ pack,
                        const int4* __restrict__ ids,
                        const int* __restrict__ tiles,
                        const T* __restrict__ vinv, const T* __restrict__ x,
                        int D, T* __restrict__ out) {
  using Ly = Layout<T, LM>;
  constexpr int LMS = Ly::LMS;
  extern __shared__ uint4 rows[];       // ROWS x SV units: the chunk's
  //                                       records, then its outputs
  __shared__ T part[ROWS * LMS];        // j_l^T u of each row of the chunk
  __shared__ T acc[H * LMS];            // the tile's group sums, then z
  __shared__ int grp[ROWS];             // group of each row of the chunk
  __shared__ int gstart[ROWS + 1];      // first row of the chunk's groups
  __shared__ int glm[H];                // landmark of the tile's groups

  const int tid = threadIdx.x;
  const int s = tiles[blockIdx.x], e = tiles[blockIdx.x + 1];
  if (s >= e) return;
  const bool one = e - s <= ROWS;       // the rows stay in shared memory
  int g0 = 0, ng = 0;
  if constexpr (LM > 0) {
    g0 = ids[s].z;
    for (int k = tid; k < H * LM; k += ROWS) acc[k] = T(0);
  }
  int4 id = make_int4(0, 0, 0, -1);
  T u0 = T(0), u1 = T(0);
  Row<T, LM> row;

  // u of every row; with landmark columns, the group sums of j_l^T u (at
  // LM 0 a long tile computes u in the output pass alone)
  for (int c0 = s; c0 < e && (LM > 0 || one); c0 += ROWS) {
    const int n = min(ROWS, e - c0);
    stage<T, LM>(pack, c0, n, rows);
    if (tid < n) id = ids[c0 + tid];
    __syncthreads();
    if (tid < n) {
      load_row<T, LM>(rows, tid, row);
      row_u<T, LM>(row, x, id, D, u0, u1);
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
      stage<T, LM>(pack, c0, n, rows);
      if (tid < n) id = ids[c0 + tid];
      __syncthreads();
      if (tid < n) {
        load_row<T, LM>(rows, tid, row);
        row_u<T, LM>(row, x, id, D, u0, u1);
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
}

template <typename T, int LM>
int launch_pack(const void* jm, const void* jr, const void* jl,
                const void* perm, int Nr, void* pack, void* stream) {
  using Ly = Layout<T, LM>;
  if (Nr < 0 || static_cast<long long>(Nr) * Ly::NV >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = Nr * Ly::NV;
  if (units == 0) return 0;
  pack_kernel<T, LM><<<(units + ROWS - 1) / ROWS, ROWS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(jm), static_cast<const T*>(jr),
      static_cast<const T*>(jl), static_cast<const int*>(perm), Nr,
      static_cast<T*>(pack));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LM>
int launch(const void* pack, const void* ids, const void* tiles, int n_tiles,
           const void* vinv, const void* x, int D, void* out, void* stream) {
  using Ly = Layout<T, LM>;
  if (n_tiles < 0 || D < 6) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const int smem = ROWS * Ly::SV * 16;
  // the attribute is per device: set it on every launch (cheap)
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        schur_matvec_kernel<T, LM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  schur_matvec_kernel<T, LM><<<n_tiles, ROWS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pack), static_cast<const int4*>(ids),
      static_cast<const int*>(tiles), static_cast<const T*>(vinv),
      static_cast<const T*>(x), D, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pack_lm(int lm, const void* jm, const void* jr, const void* jl,
            const void* perm, int Nr, void* pack, void* stream) {
  switch (lm) {
    case 0: return launch_pack<T, 0>(jm, jr, jl, perm, Nr, pack, stream);
    case 1: return launch_pack<T, 1>(jm, jr, jl, perm, Nr, pack, stream);
    case 3: return launch_pack<T, 3>(jm, jr, jl, perm, Nr, pack, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int matvec_lm(int lm, const void* pack, const void* ids, const void* tiles,
              int n_tiles, const void* vinv, const void* x, int D, void* out,
              void* stream) {
  switch (lm) {
    case 0:
      return launch<T, 0>(pack, ids, tiles, n_tiles, vinv, x, D, out,
                          stream);
    case 1:
      return launch<T, 1>(pack, ids, tiles, n_tiles, vinv, x, D, out,
                          stream);
    case 3:
      return launch<T, 3>(pack, ids, tiles, n_tiles, vinv, x, D, out,
                          stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// j_m, j_r (Nr, 2, 6), j_l (Nr, 2, lm) in row order, perm (Nr,) int32 ->
// pack (Nr, record width) in the order of perm
int ba_schur_pack_f32(int lm, const void* jm, const void* jr, const void* jl,
                      const void* perm, int Nr, void* pack, void* stream) {
  return pack_lm<float>(lm, jm, jr, jl, perm, Nr, pack, stream);
}

int ba_schur_pack_f64(int lm, const void* jm, const void* jr, const void* jl,
                      const void* perm, int Nr, void* pack, void* stream) {
  return pack_lm<double>(lm, jm, jr, jl, perm, Nr, pack, stream);
}

// pack, ids (Nr, 4) int32, tiles (n_tiles + 1,) int32, vinv (L, lm, lm),
// x (P * D,) -> out (Nr, 2, 6) in the order of the pack
int ba_schur_matvec_f32(int lm, const void* pack, const void* ids,
                        const void* tiles, int n_tiles, const void* vinv,
                        const void* x, int D, void* out, void* stream) {
  return matvec_lm<float>(lm, pack, ids, tiles, n_tiles, vinv, x, D, out,
                          stream);
}

int ba_schur_matvec_f64(int lm, const void* pack, const void* ids,
                        const void* tiles, int n_tiles, const void* vinv,
                        const void* x, int D, void* out, void* stream) {
  return matvec_lm<double>(lm, pack, ids, tiles, n_tiles, vinv, x, D, out,
                           stream);
}

}  // extern "C"
