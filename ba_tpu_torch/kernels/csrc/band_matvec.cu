// Kernel 9: y = S x for the symmetric block band of the reduced camera system.
//
//   y_q = sum_{d<B, q+d<P} band[q, d] x_{q+d}
//       + sum_{1<=d<B, q-d>=0} band[q-d, d]^T x_{q-d}
//
// band (P, B, D, D) holds the upper blocks, band[p, d] = S[p, p + d].
//
// Replaces the TPU formulation ba_tpu/solver/banded.py:band_matvec
// (:229-242), which gathers a (P, B, D) copy of x for the upper part and a
// (P, B - 1, D, D) copy of the band for the lower part on every call, then
// contracts both with einsums.  Here the band is read in place.
//
// Bound on an H100: bytes.  At the full-width trajectory (P = 2048, B = 24,
// D = 9) the band is 15.9 MB in f32, ~4.7 us at 3.35 TB/s; its 15.6 MFLOP
// take 0.23 us at 67 TFLOP/s.
//
// What held the first version back (one warp per output pose, lanes on
// (block, row) pairs, 0.0141 ms at full width): every block was read twice,
// as pose q's upper block and as pose q + d's lower one, 7.8 KB of band
// apart, and each warp ran a serial chain of ~16 blocks x D dependent
// load-FMA steps.
//
// Design: one block of nw warps per tile of TILE output poses [q0, q1).
// Every band element is used twice from one read: block (p, d) gives the
// upper term band[p, d] x_{p+d} of pose p and the lower term
// band[p, d]^T x_p of pose p + d.  So the tile reads the rows it owns
// whole, and of the B - 1 rows before it (the halo) only the blocks that
// reach into the tile (d >= q0 - p): T B + B (B - 1) / 2 blocks, 1.72x the
// band at TILE = 16, B = 24, the halo from L2.  A row's blocks are one
// contiguous run, cut into pieces of at most chb blocks (kernels/
// band_matvec.py:schedule); piece n of the tile goes to warp n % nw.  Lane
// (g, i), g < G = 32 / D, takes blocks b = g, g + G, ... of its piece: the
// dot of row i with x_{p+d} into a running sum (an owned row), the dot of
// column i with x_p into the warp's accumulator of pose p + d (in the
// tile; one lane per entry); the G running sums of row i are then added in
// g order into the accumulator of pose p.  The loads go straight to device
// memory: a block's D x D values are one run of 32-byte sectors, which the
// lane group's first row or column loads bring into L1 and the rest hit
// there.  Versions that staged the pieces in shared memory with 16-byte
// cp.async copies (a ring of 2 to 4 per warp, or a thread-block cluster
// passing the lower terms between tiles in place of the halo) were slower
// on the H100 in development; this one, with 32 warps a block, takes
// 0.0078 ms (chip_smoke.py).
//
// At the end each y entry is the sum of the warps' accumulators in warp
// order.  Every sum is in a fixed order (pieces in order within a warp,
// warps in order), with no atomics, so two launches are bit-identical; the
// walk is tests/test_torch_banded.py:_kernel9_walk.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;       // output poses per block
constexpr int MAX_WARPS = 32;  // warps per block (nw)

struct Piece {
  int p, da, db;   // band row p, blocks d in [da, db)
};

// piece n of the tile [q0, q1): row pa + n / kp, its (n % kp)-th run of
// chb blocks; an owned row needs every block, a halo row those that reach
// into the tile.  Empty when the row needs fewer runs.
__device__ __forceinline__ bool piece_of(int n, int q0, int q1, int pa,
                                         int P, int B, int chb, int kp,
                                         Piece& pc) {
  pc.p = pa + n / kp;
  const int k = n - (n / kp) * kp;
  int dlo = 0, dhi = min(B, P - pc.p);
  if (pc.p < q0) {
    dlo = q0 - pc.p;
    dhi = min(dhi, q1 - pc.p);
  }
  pc.da = dlo + k * chb;
  pc.db = min(dhi, pc.da + chb);
  return pc.da < pc.db;
}

// DT is D when it is known at compile time (loops unrolled, x_p in
// registers), else 0
template <typename T, int DT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    band_matvec_kernel(const T* __restrict__ band, const T* __restrict__ x,
                       int P, int B, int D_, int chb, int nw,
                       T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = DT > 0 ? DT : D_;
  const int DD = D * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* acc_all = reinterpret_cast<T*>(smem_raw);   // [nw][TILE][D]
  T* acc = acc_all + warp * TILE * D;

  const int q0 = blockIdx.x * TILE, q1 = min(P, q0 + TILE);
  const int pa = max(0, q0 - B + 1);
  const int kp = (B + chb - 1) / chb;
  const int n_pieces = (q1 - pa) * kp;
  const int G = 32 / D;
  const int g = lane / D, i = lane - g * D;

  for (int t = lane; t < TILE * D; t += 32) acc[t] = T(0);
  __syncwarp();
  for (int n = warp; n < n_pieces; n += nw) {
    Piece pc;
    if (!piece_of(n, q0, q1, pa, P, B, chb, kp, pc)) continue;  // warp-wide
    const int p = pc.p, nb = pc.db - pc.da;
    const bool own = p >= q0;
    const T* xp_g = x + static_cast<long long>(p) * D;
    T xp[DT > 0 ? DT : 1];
    if (DT > 0) {
#pragma unroll
      for (int j = 0; j < (DT > 0 ? DT : 1); ++j) xp[j] = __ldg(xp_g + j);
    }
    T up = T(0);
    if (g < G) {
#pragma unroll 2
      for (int b = g; b < nb; b += G) {
        const int d = pc.da + b;
        const T* bl = band + (static_cast<long long>(p) * B + d) * DD;
        if (own) {
          const T* row = bl + i * D;
          const T* xv = x + static_cast<long long>(p + d) * D;
#pragma unroll
          for (int j = 0; j < D; ++j)
            up = fma(__ldg(row + j), __ldg(xv + j), up);
        }
        if (d >= 1 && p + d >= q0 && p + d < q1) {
          T s = T(0);
#pragma unroll
          for (int j = 0; j < D; ++j)
            s = fma(__ldg(bl + j * D + i),
                    DT > 0 ? xp[DT > 0 ? j : 0] : __ldg(xp_g + j), s);
          acc[(p + d - q0) * D + i] += s;
        }
      }
    }
    if (own) {   // warp-uniform
      T tot = up;
      for (int h = 1; h < G; ++h) {
        const T v = __shfl_sync(0xffffffffu, up, min(31, h * D + i));
        if (g == 0) tot += v;
      }
      if (g == 0) acc[(p - q0) * D + i] += tot;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int t = threadIdx.x; t < (q1 - q0) * D; t += nw * 32) {
    T s = acc_all[t];
    for (int w = 1; w < nw; ++w) s += acc_all[w * TILE * D + t];
    y[static_cast<long long>(q0) * D + t] = s;
  }
}

template <typename T, int DT>
int launch(const T* band, const T* x, int P, int B, int D, int chb, int nw,
           T* y, cudaStream_t stream) {
  const long long smem = static_cast<long long>(nw) * TILE * D * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        band_matvec_kernel<T, DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  band_matvec_kernel<T, DT><<<(P + TILE - 1) / TILE, nw * 32,
                              static_cast<size_t>(smem), stream>>>(
      band, x, P, B, D, chb, nw, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* band, const void* x, int P, int B, int D, int chb,
             int nw, void* y, void* stream) {
  if (P < 0 || B < 1 || D < 1 || D > 32 || chb < 1 || chb > B || nw < 1 ||
      nw > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const T* b = static_cast<const T*>(band);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {   // the pose dims of the solver's configurations
    case 6: return launch<T, 6>(b, xv, P, B, D, chb, nw, yv, st);
    case 9: return launch<T, 9>(b, xv, P, B, D, chb, nw, yv, st);
    case 15: return launch<T, 15>(b, xv, P, B, D, chb, nw, yv, st);
    default: return launch<T, 0>(b, xv, P, B, D, chb, nw, yv, st);
  }
}

}  // namespace

extern "C" {

int ba_band_matvec_f32(const void* band, const void* x, int P, int B, int D,
                       int chb, int nw, void* y, void* stream) {
  return launch_d<float>(band, x, P, B, D, chb, nw, y, stream);
}

int ba_band_matvec_f64(const void* band, const void* x, int P, int B, int D,
                       int chb, int nw, void* y, void* stream) {
  return launch_d<double>(band, x, P, B, D, chb, nw, y, stream);
}

}  // extern "C"
