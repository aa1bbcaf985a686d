// Kernel 6: the projection family's share of the matrix-free Schur product
// S x = (U - W V^-1 W^T) x, for inverse-depth landmarks (V_l is 1x1).
//
// For every landmark l and each of its projection rows n:
//
//   u_n  = J_m[n] x[pose_n] + J_r[n] x[ref_n]          (2 values)
//   wt_l = sum_n j_l[n]^T u_n                           (W^T x)
//   z_l  = V_l^-1 wt_l
//   w_n  = u_n - j_l[n] z_l
//   out[n]      = J_m[n]^T w_n                          (6 values, to pose_n)
//   out[Nr + n] = J_r[n]^T w_n                          (6 values, to ref_n)
//
// The rows come out in the order of the block plan's rhs ids ([pose rows,
// ref rows, ...]), so segsum sums them by pose with the unary, binary and
// IMU rows of U x in one grouped launch.  U x and -W V^-1 W^T x of the
// projection family are one pass; W^T x never goes to device memory.
//
// Replaces the TPU formulation ba_tpu/solver/cg.py:s_matvec (:160) with its
// applies _u_apply (:123), _wt_apply (:103) and _w_apply (:111): per-row
// einsums, a segment sum by landmark, a gather of z back to the rows, and
// segment sums by pose, each through device memory.
//
// Tables: the landmark CSR of the block plan (kernels/segsum.py SegPlan of
// the ids proj.lm, built once per solve): `perm` holds the rows stably
// sorted by landmark, landmark l owns perm[offsets[l]:offsets[l + 1]], and
// rows whose landmark id is out of range sit past offsets[L] (none on the
// main path; they get z = 0).
//
// One warp per landmark, 8 landmarks per block.  Pass 1: each lane takes the
// rows lane, lane + 32, ... of its landmark and accumulates j_l^T u in that
// order; an xor butterfly sums the lanes (every lane ends with the same
// bits, since each pairwise add is commutative).  Pass 2 recomputes u_n
// (the row blocks are L2-resident after pass 1) and writes both output rows.
// Every sum is in an order fixed by the plan, with no atomics, so two
// launches are bit-identical.
//
// Bound on an H100: bytes.  At the long CG configuration (Nr = 85,823 rows,
// P = 1,024, D = 9, f32) it reads the row blocks (J_m, J_r, j_l: 9.0 MB),
// the row ids (pose, ref and perm, int32: 1.0 MB) and x, and writes
// 2 Nr x 6 values (4.1 MB): ~14 MB, ~4.2 us at 3.35 TB/s.  The ~100 flop
// per row are 8.6 MFLOP, 0.13 us at 67 TFLOP/s.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Rows {
  const T* jm;            // (Nr, 2, 6)
  const T* jr;            // (Nr, 2, 6)
  const T* jl;            // (Nr, 2, 1)
  const int* pose;        // (Nr,)
  const int* ref;         // (Nr,)
  const T* x;             // (P * D,)
  int D;
};

// u_n = J_m[n] x[pose_n] + J_r[n] x[ref_n]
template <typename T>
__device__ __forceinline__ void row_u(const Rows<T>& r, int n, T& u0, T& u1) {
  const T* xm = r.x + static_cast<long long>(r.pose[n]) * r.D;
  const T* xr = r.x + static_cast<long long>(r.ref[n]) * r.D;
  const T* jm = r.jm + static_cast<long long>(n) * 12;
  const T* jr = r.jr + static_cast<long long>(n) * 12;
  T a0 = T(0), a1 = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T xmk = xm[k], xrk = xr[k];
    a0 += jm[k] * xmk + jr[k] * xrk;
    a1 += jm[6 + k] * xmk + jr[6 + k] * xrk;
  }
  u0 = a0;
  u1 = a1;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    schur_matvec_kernel(const Rows<T> r, const T* __restrict__ vinv,
                        const int* __restrict__ perm,
                        const int* __restrict__ offsets, int L, int Nr,
                        T* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * WARPS + warp;
  if (l > L) return;
  // l == L: the rows of out-of-range landmarks, with z = 0
  const int start = offsets[l];
  const int end = l < L ? offsets[l + 1] : Nr;

  // pass 1: wt_l = sum_n j_l[n]^T u_n
  T acc = T(0);
  for (int i = start + lane; i < end; i += 32) {
    const int n = perm[i];
    T u0, u1;
    row_u(r, n, u0, u1);
    acc += r.jl[2 * n] * u0 + r.jl[2 * n + 1] * u1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  const T z = l < L ? vinv[l] * acc : T(0);

  // pass 2: w_n = u_n - j_l[n] z, then J_m^T w_n and J_r^T w_n
  for (int i = start + lane; i < end; i += 32) {
    const int n = perm[i];
    T u0, u1;
    row_u(r, n, u0, u1);
    const T w0 = u0 - r.jl[2 * n] * z;
    const T w1 = u1 - r.jl[2 * n + 1] * z;
    const T* jm = r.jm + static_cast<long long>(n) * 12;
    const T* jr = r.jr + static_cast<long long>(n) * 12;
    T* om = out + static_cast<long long>(n) * 6;
    T* orf = out + (static_cast<long long>(Nr) + n) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      om[k] = jm[k] * w0 + jm[6 + k] * w1;
      orf[k] = jr[k] * w0 + jr[6 + k] * w1;
    }
  }
}

template <typename T>
int launch(const void* jm, const void* jr, const void* jl, const void* pose,
           const void* ref, const void* vinv, const void* x, const void* perm,
           const void* offsets, int L, int Nr, int D, void* out,
           void* stream) {
  if (L < 0 || Nr < 0 || D < 6) return static_cast<int>(cudaErrorInvalidValue);
  Rows<T> r;
  r.jm = static_cast<const T*>(jm);
  r.jr = static_cast<const T*>(jr);
  r.jl = static_cast<const T*>(jl);
  r.pose = static_cast<const int*>(pose);
  r.ref = static_cast<const int*>(ref);
  r.x = static_cast<const T*>(x);
  r.D = D;
  const int warps = L + 1;
  schur_matvec_kernel<T><<<(warps + WARPS - 1) / WARPS, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      r, static_cast<const T*>(vinv), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), L, Nr, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_schur_matvec_f32(const void* jm, const void* jr, const void* jl,
                        const void* pose, const void* ref, const void* vinv,
                        const void* x, const void* perm, const void* offsets,
                        int L, int Nr, int D, void* out, void* stream) {
  return launch<float>(jm, jr, jl, pose, ref, vinv, x, perm, offsets, L, Nr,
                       D, out, stream);
}

int ba_schur_matvec_f64(const void* jm, const void* jr, const void* jl,
                        const void* pose, const void* ref, const void* vinv,
                        const void* x, const void* perm, const void* offsets,
                        int L, int Nr, int D, void* out, void* stream) {
  return launch<double>(jm, jr, jl, pose, ref, vinv, x, perm, offsets, L, Nr,
                        D, out, stream);
}

}  // extern "C"
