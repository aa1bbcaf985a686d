// Reprojection residual + closed-form Jacobians, 32 rows per block.
//
// Replaces the TPU kernel evaluate_pallas -> _kernel -> proj_math.proj_forward
// (80bbf6f^:ba_tpu/ops/reprojection_pallas.py:68-105, math at
// 80bbf6f^:ba_tpu/ops/proj_math.py:95).  Per row:
//
//   r = z - project(T_vs_m^-1 T_wv_m^-1 T_wv_r T_vs_r x_s)
//
// with closed-form Jacobians w.r.t. the meas-pose and ref-pose tangents
// [dt, dw] (right-multiplied rotation q*exp(dw)) and the inverse depth.
// Same-pose rows get zero pose Jacobians; invalid rows write zeros.
//
// Differences from the Pallas kernel: the exact atan (not the polynomial),
// and the guards of ba_tpu/core/camera.py (|z| < 1e-9, r < 1e-9, |w| < 1e-9)
// with the derivatives autodiff gives through them.
//
// Bound on an H100: bytes.  Per row it reads z and four indices (~20 B; the
// pose/landmark/camera tables are a few KB and stay in L2) and writes
// 29 values (116 B in f32): ~1.3 MB at Nr = 9,696, 0.4 us at 3.35 TB/s.
// ~1,055 flops per row (with Jacobians) take 0.16 us at 67 TFLOP/s f32.
// At this size the launch and the longest thread's dependent chain set the
// pace, so the design shortens the chain and fills the card:
//
//   * a block holds 32 rows (one per lane) and, with Jacobians, 4 warps
//     that split each row's work by role: 0 the residual and the inverse-
//     depth column, 1 the 3 translation columns (meas and ref, which differ
//     in sign only), 2 the 3 meas-rotation columns, 3 the 3 ref-rotation
//     columns.  Each warp recomputes the shared transfer chain and the
//     projection (~255 flops) rather than waiting on another warp; a role
//     is uniform over a warp, so nothing diverges.  Nr = 9,696 gives 303
//     blocks, 2.3 per SM.  Without Jacobians a block is the one warp of
//     role 0;
//   * the outputs of a block are staged in shared memory and written as
//     contiguous runs with 16-byte stores, in place of each thread's
//     stride-12 and stride-2 stores;
//   * the per-camera constants (the FOV k = 2 tan(w/2), its guard and
//     k / w) are computed once per block into shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;    // rows per block: one per lane
constexpr int ROLES = 4;    // warps per block with Jacobians
constexpr int CAM = 8;      // per-camera constants: fx fy cx cy w fov k k/w

__device__ __forceinline__ float d_atan(float x) { return atanf(x); }
__device__ __forceinline__ double d_atan(double x) { return atan(x); }
__device__ __forceinline__ float d_tan(float x) { return tanf(x); }
__device__ __forceinline__ double d_tan(double x) { return tan(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// out = R(q) v, q = (w, x, y, z):  v + w t + q_v x t,  t = 2 q_v x v
template <typename T>
__device__ __forceinline__ void rot(const T* q, const T* v, T* out) {
  const T t0 = T(2) * (q[2] * v[2] - q[3] * v[1]);
  const T t1 = T(2) * (q[3] * v[0] - q[1] * v[2]);
  const T t2 = T(2) * (q[1] * v[1] - q[2] * v[0]);
  out[0] = v[0] + q[0] * t0 + (q[2] * t2 - q[3] * t1);
  out[1] = v[1] + q[0] * t1 + (q[3] * t0 - q[1] * t2);
  out[2] = v[2] + q[0] * t2 + (q[1] * t1 - q[2] * t0);
}

// out = R(q)^T v
template <typename T>
__device__ __forceinline__ void rot_t(const T* q, const T* v, T* out) {
  const T qc[4] = {q[0], -q[1], -q[2], -q[3]};
  rot(qc, v, out);
}

// R_v^T R_m^T v
template <typename T>
__device__ __forceinline__ void to_sensor(const T* q_m, const T* q_v,
                                          const T* v, T* out) {
  T tmp[3];
  rot_t(q_m, v, tmp);
  rot_t(q_v, tmp, out);
}

// n values from shared to global memory as 16-byte stores, all threads of
// the block; dst and src are 16-byte aligned
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ dst, const T* src,
                                          int n) {
  using V = typename Vec16<T>::type;
  constexpr int per = 16 / sizeof(T);
  const int nv = n / per;
  for (int v = threadIdx.x; v < nv; v += blockDim.x)
    reinterpret_cast<V*>(dst)[v] = reinterpret_cast<const V*>(src)[v];
  for (int e = nv * per + threadIdx.x; e < n; e += blockDim.x)
    dst[e] = src[e];
}

template <typename T, bool JAC>
__global__ void __launch_bounds__(ROWS * ROLES) reprojection_kernel(
    const T* __restrict__ z, const int* __restrict__ pose,
    const int* __restrict__ lm, const int* __restrict__ cam,
    const uint8_t* __restrict__ valid, const T* __restrict__ pose_q,
    const T* __restrict__ pose_t, const T* __restrict__ lm_x,
    const int* __restrict__ lm_ref_pose, const int* __restrict__ lm_ref_cam,
    const T* __restrict__ cam_params, const int* __restrict__ cam_model,
    const T* __restrict__ tvs_q, const T* __restrict__ tvs_t, int n_params,
    int ncam, int nr, T* __restrict__ r_out, T* __restrict__ jm_out,
    T* __restrict__ jr_out, T* __restrict__ jl_out,
    T* __restrict__ err_out) {
  __shared__ __align__(16) T s_r[2 * ROWS];
  __shared__ __align__(16) T s_err[ROWS];
  __shared__ __align__(16) T s_jm[JAC ? 12 * ROWS : 1];
  __shared__ __align__(16) T s_jr[JAC ? 12 * ROWS : 1];
  __shared__ __align__(16) T s_jl[JAC ? 2 * ROWS : 1];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* s_cam = reinterpret_cast<T*>(s_dyn);       // (ncam, CAM)

  const T SMALL = T(1e-9);
  for (int c = threadIdx.x; c < ncam; c += blockDim.x) {
    const T* prm = cam_params + static_cast<long long>(c) * n_params;
    const T w = prm[4];
    const bool fov = cam_model[c] == 1 && !(d_abs(w) < SMALL);
    const T k = fov ? T(2) * d_tan(T(0.5) * w) : T(0);
    T* sc = s_cam + CAM * c;
    sc[0] = prm[0];
    sc[1] = prm[1];
    sc[2] = prm[2];
    sc[3] = prm[3];
    sc[4] = w;
    sc[5] = fov ? T(1) : T(0);
    sc[6] = k;
    sc[7] = fov ? k / w : T(1);
  }
  __syncthreads();

  const int role = threadIdx.x >> 5;
  const int lr = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int i = row0 + lr;
  const int nrows = min(ROWS, nr - row0);

  if (i < nr) {
    if (!valid[i]) {
      if (role == 0) {
        s_r[2 * lr] = T(0);
        s_r[2 * lr + 1] = T(0);
        s_err[lr] = T(0);
        if (JAC) {
          s_jl[2 * lr] = T(0);
          s_jl[2 * lr + 1] = T(0);
        }
      } else if (JAC) {
        T* dst = role == 3 ? s_jr : s_jm;
        const int c0 = role == 2 || role == 3 ? 3 : 0;
        for (int c = c0; c < c0 + 3; ++c) {
          dst[12 * lr + c] = T(0);
          dst[12 * lr + 6 + c] = T(0);
          if (role == 1) {
            s_jr[12 * lr + c] = T(0);
            s_jr[12 * lr + 6 + c] = T(0);
          }
        }
      }
    } else {
      const int pm = pose[i];
      const int l = lm[i];
      const int cm = cam[i];
      const int pr = lm_ref_pose[l];
      const int cr = lm_ref_cam[l];

      T q_m[4], t_m[3], q_r[4], t_r[3], xs[3], q_v[4], t_v[3], q_vr[4],
          t_vr[3];
      for (int k = 0; k < 4; ++k) {
        q_m[k] = pose_q[4 * pm + k];
        q_r[k] = pose_q[4 * pr + k];
        q_v[k] = tvs_q[4 * cm + k];
        q_vr[k] = tvs_q[4 * cr + k];
      }
      for (int k = 0; k < 3; ++k) {
        t_m[k] = pose_t[3 * pm + k];
        t_r[k] = pose_t[3 * pr + k];
        xs[k] = lm_x[4 * l + k];
        t_v[k] = tvs_t[3 * cm + k];
        t_vr[k] = tvs_t[3 * cr + k];
      }
      const T rho = lm_x[4 * l + 3];
      const T* sc = s_cam + CAM * cm;
      const T fx = sc[0], fy = sc[1], cx = sc[2], cy = sc[3], wfov = sc[4];

      // --- transfer chain: ref side through the landmark's reference camera
      T w1[3], r2tv[3], r2w1[3], twsr[3], d[3], u[3], rvtu[3], rvtv[3], p[3];
      rot(q_vr, xs, w1);
      rot(q_r, t_vr, r2tv);
      rot(q_r, w1, r2w1);
      for (int k = 0; k < 3; ++k) twsr[k] = t_r[k] + r2tv[k];
      for (int k = 0; k < 3; ++k)
        d[k] = r2w1[k] + twsr[k] * rho - t_m[k] * rho;
      rot_t(q_m, d, u);
      rot_t(q_v, u, rvtu);
      rot_t(q_v, t_v, rvtv);
      for (int k = 0; k < 3; ++k) p[k] = rvtu[k] - rvtv[k] * rho;

      // --- projection with the guards of core/camera.py
      const bool small_z = d_abs(p[2]) < SMALL;
      const T pz = small_z ? (p[2] < T(0) ? -SMALL : SMALL) : p[2];
      const T iz = T(1) / pz;
      const T xn = p[0] * iz;
      const T yn = p[1] * iz;
      const T ru = d_sqrt(xn * xn + yn * yn);
      T F = T(1), dF_over_r = T(0);
      if (sc[5] != T(0)) {
        const T k = sc[6];
        if (ru < SMALL) {
          F = sc[7];
        } else {
          const T a = d_atan(ru * k);
          F = a / (ru * wfov);
          // dF/dr = [k r / (1 + (r k)^2) - atan(r k)] / (r^2 w)
          dF_over_r = (k * ru / (T(1) + ru * ru * k * k) - a) /
                      (ru * ru * wfov) / ru;
        }
      }
      if (role == 0) {
        const T r0 = z[2 * i] - (fx * F * xn + cx);
        const T r1 = z[2 * i + 1] - (fy * F * yn + cy);
        s_r[2 * lr] = r0;
        s_r[2 * lr + 1] = r1;
        s_err[lr] = r0 * r0 + r1 * r1;
      }
      if (JAC) {
        // dpix/d(xn,yn) = diag(fx,fy) (F I + dF/r [xn,yn][xn,yn]^T)
        const T a00 = fx * (F + dF_over_r * xn * xn);
        const T a01 = fx * (dF_over_r * xn * yn);
        const T a10 = fy * (dF_over_r * xn * yn);
        const T a11 = fy * (F + dF_over_r * yn * yn);
        // d(xn,yn)/dp; the guarded z is a constant, so no z derivative there
        const T g00 = a00 * iz, g01 = a01 * iz;
        const T g10 = a10 * iz, g11 = a11 * iz;
        const T g02 = small_z ? T(0) : -(a00 * xn + a01 * yn) * iz;
        const T g12 = small_z ? T(0) : -(a10 * xn + a11 * yn) * iz;

        // residual-sign Jacobian row pair of a sensor-frame direction dp
        auto dres = [&](const T* dp, T* j0, T* j1) {
          *j0 = -(g00 * dp[0] + g01 * dp[1] + g02 * dp[2]);
          *j1 = -(g10 * dp[0] + g11 * dp[1] + g12 * dp[2]);
        };
        const bool same = pm == pr;

        if (role == 0) {
          // inverse depth: dp/drho = Rv^T Rm^T (t_wsr - t_m) - Rv^T t_v
          T drho3[3] = {twsr[0] - t_m[0], twsr[1] - t_m[1], twsr[2] - t_m[2]};
          T drho[3];
          to_sensor(q_m, q_v, drho3, drho);
          T dl[3] = {drho[0] - rvtv[0], drho[1] - rvtv[1], drho[2] - rvtv[2]};
          dres(dl, &s_jl[2 * lr], &s_jl[2 * lr + 1]);
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            T e[3] = {T(0), T(0), T(0)};
            e[c] = T(1);
            T j0, j1;
            if (role == 1) {
              // translations: dp/dt_m = -rho Rv^T Rm^T e_c, dp/dt_r = -that
              T ec[3];
              to_sensor(q_m, q_v, e, ec);
              T dm[3] = {-rho * ec[0], -rho * ec[1], -rho * ec[2]};
              dres(dm, &j0, &j1);
              s_jm[12 * lr + c] = same ? T(0) : j0;
              s_jm[12 * lr + 6 + c] = same ? T(0) : j1;
              s_jr[12 * lr + c] = same ? T(0) : -j0;
              s_jr[12 * lr + 6 + c] = same ? T(0) : -j1;
            } else if (role == 2) {
              // meas rotation: dp/dw_m = Rv^T (u x e_c)
              T uxe[3] = {u[1] * e[2] - u[2] * e[1], u[2] * e[0] - u[0] * e[2],
                          u[0] * e[1] - u[1] * e[0]};
              T dw[3];
              rot_t(q_v, uxe, dw);
              dres(dw, &j0, &j1);
              s_jm[12 * lr + 3 + c] = same ? T(0) : j0;
              s_jm[12 * lr + 9 + c] = same ? T(0) : j1;
            } else {
              // ref rotation: v_c = w1 x e_c + rho (t_vr x e_c);
              // dp/dw_r = -Rv^T Rm^T Rr v_c
              T vc[3] = {w1[1] * e[2] - w1[2] * e[1] +
                             rho * (t_vr[1] * e[2] - t_vr[2] * e[1]),
                         w1[2] * e[0] - w1[0] * e[2] +
                             rho * (t_vr[2] * e[0] - t_vr[0] * e[2]),
                         w1[0] * e[1] - w1[1] * e[0] +
                             rho * (t_vr[0] * e[1] - t_vr[1] * e[0])};
              T rvc[3], d3[3];
              rot(q_r, vc, rvc);
              to_sensor(q_m, q_v, rvc, d3);
              T nd3[3] = {-d3[0], -d3[1], -d3[2]};
              dres(nd3, &j0, &j1);
              s_jr[12 * lr + 3 + c] = same ? T(0) : j0;
              s_jr[12 * lr + 9 + c] = same ? T(0) : j1;
            }
          }
        }
      }
    }
  }
  __syncthreads();

  store_run(r_out + 2LL * row0, s_r, 2 * nrows);
  store_run(err_out + row0, s_err, nrows);
  if (JAC) {
    store_run(jm_out + 12LL * row0, s_jm, 12 * nrows);
    store_run(jr_out + 12LL * row0, s_jr, 12 * nrows);
    store_run(jl_out + 2LL * row0, s_jl, 2 * nrows);
  }
}

template <typename T>
int launch(const T* z, const int* pose, const int* lm, const int* cam,
           const uint8_t* valid, const T* pose_q, const T* pose_t,
           const T* lm_x, const int* lm_ref_pose, const int* lm_ref_cam,
           const T* cam_params, const int* cam_model, const T* tvs_q,
           const T* tvs_t, int n_params, int ncam, int nr, int with_jac,
           T* r, T* jm, T* jr, T* jl, T* err, void* stream) {
  if (nr > 0) {
    const int blocks = (nr + ROWS - 1) / ROWS;
    const size_t smem = static_cast<size_t>(ncam) * CAM * sizeof(T);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (with_jac) {
      reprojection_kernel<T, true><<<blocks, ROWS * ROLES, smem, s>>>(
          z, pose, lm, cam, valid, pose_q, pose_t, lm_x, lm_ref_pose,
          lm_ref_cam, cam_params, cam_model, tvs_q, tvs_t, n_params, ncam,
          nr, r, jm, jr, jl, err);
    } else {
      reprojection_kernel<T, false><<<blocks, ROWS, smem, s>>>(
          z, pose, lm, cam, valid, pose_q, pose_t, lm_x, lm_ref_pose,
          lm_ref_cam, cam_params, cam_model, tvs_q, tvs_t, n_params, ncam,
          nr, r, jm, jr, jl, err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ba_reprojection_f32(const float* z, const int* pose, const int* lm,
                        const int* cam, const uint8_t* valid,
                        const float* pose_q, const float* pose_t,
                        const float* lm_x, const int* lm_ref_pose,
                        const int* lm_ref_cam, const float* cam_params,
                        const int* cam_model, const float* tvs_q,
                        const float* tvs_t, int n_params, int ncam, int nr,
                        int with_jac, float* r, float* jm, float* jr,
                        float* jl, float* err, void* stream) {
  return launch<float>(z, pose, lm, cam, valid, pose_q, pose_t, lm_x,
                       lm_ref_pose, lm_ref_cam, cam_params, cam_model, tvs_q,
                       tvs_t, n_params, ncam, nr, with_jac, r, jm, jr, jl,
                       err, stream);
}

int ba_reprojection_f64(const double* z, const int* pose, const int* lm,
                        const int* cam, const uint8_t* valid,
                        const double* pose_q, const double* pose_t,
                        const double* lm_x, const int* lm_ref_pose,
                        const int* lm_ref_cam, const double* cam_params,
                        const int* cam_model, const double* tvs_q,
                        const double* tvs_t, int n_params, int ncam, int nr,
                        int with_jac, double* r, double* jm, double* jr,
                        double* jl, double* err, void* stream) {
  return launch<double>(z, pose, lm, cam, valid, pose_q, pose_t, lm_x,
                        lm_ref_pose, lm_ref_cam, cam_params, cam_model,
                        tvs_q, tvs_t, n_params, ncam, nr, with_jac, r, jm, jr,
                        jl, err, stream);
}

}  // extern "C"
