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
// Same-pose rows get zero pose Jacobians; invalid rows write zeros.  With
// lm_size 3 the landmark is a world point x_w = [x, 1] (no reference pose:
// j_ref is zero, and j_lm holds the 3 point columns); lm_size 0 (a pose
// graph) evaluates a row the same way with no landmark columns, as
// ba_tpu's _residual_fn does (a fixed point; no same-pose zeroing).
//
// Self-calibration (K = calib_size + 6 do_tvs columns, ba_tpu's
// _residual_fn): the intrinsics [fx, fy, cx, cy, w] and the T_vs tangent of
// camera 0 move the projection of the measuring camera and, for lm_size 1,
// the reference camera's T_vs and the unprojection of the landmark's
// reference pixel (with calibration the ray is unproject(params_r, z_ref),
// not x[:3]).  Those columns come from forward-mode duals (dual_lie.cuh)
// through the whole residual, one column per lane of the calibration
// warps; they are written only when K > 0.
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
//     in sign only; with lm_size 3 also the point columns), 2 the 3
//     meas-rotation columns, 3 the 3 ref-rotation columns.  Each warp
//     recomputes the shared transfer chain and the projection (~255 flops)
//     rather than waiting on another warp; a role is uniform over a warp,
//     so nothing diverges.  Nr = 9,696 gives 303 blocks, 2.3 per SM.
//     Without Jacobians a block is the one warp of role 0.  With
//     calibration columns, CAL_WARPS more warps take the K columns;
//   * the outputs of a block are staged in shared memory and written as
//     contiguous runs with 16-byte stores, in place of each thread's
//     stride-12 and stride-2 stores;
//   * the per-camera constants (the FOV k = 2 tan(w/2), its guard and
//     k / w) are computed once per block into shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dual_lie.cuh"

namespace {

using ba::Dual;

constexpr int ROWS = 32;       // rows per block: one per lane
constexpr int ROLES = 4;       // warps per block with Jacobians
constexpr int CAL_WARPS = 4;   // warps of calibration columns (K > 0)
constexpr int MAX_CAL = 11;    // calibration columns: 5 intrinsics + 6 T_vs
constexpr int CAM = 8;         // per-camera constants: fx fy cx cy w fov k k/w

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

// One camera of a row: intrinsics, model, T_vs, and whether it is the
// calibrated camera 0
template <typename T>
struct Cam {
  T params[5];
  int model;
  T q[4], t[3];
  T opt;
};

template <typename T>
__device__ __forceinline__ Cam<T> load_cam(const T* cam_params,
                                           const int* cam_model,
                                           const T* tvs_q, const T* tvs_t,
                                           int n_params, int c) {
  Cam<T> k;
  for (int j = 0; j < 5; ++j)
    k.params[j] = cam_params[static_cast<long long>(c) * n_params + j];
  k.model = cam_model[c];
  for (int j = 0; j < 4; ++j) k.q[j] = tvs_q[4 * c + j];
  for (int j = 0; j < 3; ++j) k.t[j] = tvs_t[3 * c + j];
  k.opt = c == 0 ? T(1) : T(0);
  return k;
}

// d r / d(calibration column `col`) of one row: the residual of
// ba_tpu's _residual_fn with the tangent e_col on d_cal, in duals
template <typename T>
__device__ void calib_column(const T* z, const T* q_m, const T* t_m,
                             const T* q_r, const T* t_r, const T* x,
                             const Cam<T>& cm, const Cam<T>& cr,
                             const T* z_ref, bool has_z_ref, bool lm3,
                             int calib_size, int col, T* out) {
  using S = Dual<T>;
  S pm[5], pr[5], tq_m[4], tt_m[3], tq_r[4], tt_r[3];
  for (int j = 0; j < 5; ++j) {
    const bool on = j < calib_size && col == j;
    pm[j] = S(cm.params[j], on ? cm.opt : T(0));
    pr[j] = S(cr.params[j], on ? cr.opt : T(0));
  }
  {
    S qm[4], tm[3], qr[4], tr[3], dm[6], dr[6];
    for (int j = 0; j < 4; ++j) {
      qm[j] = S(cm.q[j]);
      qr[j] = S(cr.q[j]);
    }
    for (int j = 0; j < 3; ++j) {
      tm[j] = S(cm.t[j]);
      tr[j] = S(cr.t[j]);
    }
    for (int j = 0; j < 6; ++j) {
      const bool on = col == calib_size + j;
      dm[j] = S(T(0), on ? cm.opt : T(0));
      dr[j] = S(T(0), on ? cr.opt : T(0));
    }
    ba::se3_retract(qm, tm, dm, tq_m, tt_m);
    ba::se3_retract(qr, tr, dr, tq_r, tt_r);
  }
  S xw[4];
  if (lm3) {
    for (int j = 0; j < 3; ++j) xw[j] = S(x[j]);
    xw[3] = S(T(1));
  } else {
    S xs[4] = {S(x[0]), S(x[1]), S(x[2]), S(x[3])};
    if (calib_size && has_z_ref) {
      const S zr[2] = {S(z_ref[0]), S(z_ref[1])};
      ba::unproject(pr, cr.model, zr, xs);
    }
    S qrs[4], trs[3], qws[4], tws[3];
    for (int j = 0; j < 4; ++j) qrs[j] = S(q_r[j]);
    for (int j = 0; j < 3; ++j) trs[j] = S(t_r[j]);
    ba::se3_compose(qrs, trs, tq_r, tt_r, qws, tws);
    ba::se3_transform_homog(qws, tws, xs, xw);
    xw[3] = xs[3];
  }
  S qms[4], tms[3], qws[4], tws[3], qi[4], ti[3], ps[3], pix[2];
  for (int j = 0; j < 4; ++j) qms[j] = S(q_m[j]);
  for (int j = 0; j < 3; ++j) tms[j] = S(t_m[j]);
  ba::se3_compose(qms, tms, tq_m, tt_m, qws, tws);
  ba::se3_inverse(qws, tws, qi, ti);
  ba::se3_transform_homog(qi, ti, xw, ps);
  ba::project(pm, cm.model, ps, pix);
  out[0] = -pix[0].d;
  out[1] = -pix[1].d;
}

template <typename T, bool JAC>
__global__ void __launch_bounds__(ROWS*(ROLES + CAL_WARPS))
    reprojection_kernel(
        const T* __restrict__ z, const int* __restrict__ pose,
        const int* __restrict__ lm, const int* __restrict__ cam,
        const uint8_t* __restrict__ valid, const T* __restrict__ pose_q,
        const T* __restrict__ pose_t, const T* __restrict__ lm_x,
        const int* __restrict__ lm_ref_pose,
        const int* __restrict__ lm_ref_cam, const T* __restrict__ lm_z_ref,
        const uint8_t* __restrict__ lm_has_z_ref,
        const T* __restrict__ cam_params, const int* __restrict__ cam_model,
        const T* __restrict__ tvs_q, const T* __restrict__ tvs_t,
        int n_params, int ncam, int nr, int lm_size, int calib_size,
        int n_cal, T* __restrict__ r_out, T* __restrict__ jm_out,
        T* __restrict__ jr_out, T* __restrict__ jl_out,
        T* __restrict__ jc_out, T* __restrict__ err_out) {
  __shared__ __align__(16) T s_r[2 * ROWS];
  __shared__ __align__(16) T s_err[ROWS];
  __shared__ __align__(16) T s_jm[JAC ? 12 * ROWS : 1];
  __shared__ __align__(16) T s_jr[JAC ? 12 * ROWS : 1];
  __shared__ __align__(16) T s_jl[JAC ? 6 * ROWS : 1];
  __shared__ __align__(16) T s_jc[JAC ? 2 * MAX_CAL * ROWS : 1];
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

  // a world point x_w = [x, 1]: lm_size 3, or 0 (a pose graph's fixed
  // point, ba_tpu's _residual_fn, with no landmark columns)
  const bool lm3 = lm_size != 1;
  const int nl = lm_size;                       // j_lm columns
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
        if (JAC)
          for (int c = 0; c < 2 * nl; ++c) s_jl[2 * nl * lr + c] = T(0);
      } else if (JAC && role < ROLES) {
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
      } else if (JAC) {
        for (int c = role - ROLES; c < n_cal; c += CAL_WARPS) {
          s_jc[2 * n_cal * lr + c] = T(0);
          s_jc[2 * n_cal * lr + n_cal + c] = T(0);
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
      const bool has_z = !lm3 && lm_has_z_ref[l];
      const T* zr = lm_z_ref + 2 * l;
      if (calib_size && has_z) {
        // self-calibration: the ray is the unprojection of the reference
        // pixel through the current intrinsics of the reference camera
        T prm[5];
        for (int k = 0; k < 5; ++k)
          prm[k] = cam_params[static_cast<long long>(cr) * n_params + k];
        ba::unproject(prm, cam_model[cr], zr, xs);
      }
      const T rho = lm3 ? T(1) : lm_x[4 * l + 3];

      if (JAC && role >= ROLES) {
        const Cam<T> km = load_cam(cam_params, cam_model, tvs_q, tvs_t,
                                   n_params, cm);
        const Cam<T> kr = load_cam(cam_params, cam_model, tvs_q, tvs_t,
                                   n_params, cr);
        const T xl[4] = {lm_x[4 * l], lm_x[4 * l + 1], lm_x[4 * l + 2],
                         lm_x[4 * l + 3]};
        for (int c = role - ROLES; c < n_cal; c += CAL_WARPS) {
          T jc[2];
          calib_column(z + 2 * i, q_m, t_m, q_r, t_r, xl, km, kr, zr, has_z,
                       lm3, calib_size, c, jc);
          s_jc[2 * n_cal * lr + c] = jc[0];
          s_jc[2 * n_cal * lr + n_cal + c] = jc[1];
        }
      } else {
        const T* sc = s_cam + CAM * cm;
        const T fx = sc[0], fy = sc[1], cx = sc[2], cy = sc[3], wfov = sc[4];

        // --- transfer chain: ref side through the landmark's reference
        // camera (lm_size 3: the world point itself, rho = 1)
        T w1[3], r2tv[3], r2w1[3], twsr[3], d[3], u[3], rvtu[3], rvtv[3],
            p[3];
        if (lm3) {
          for (int k = 0; k < 3; ++k) {
            w1[k] = xs[k];
            r2w1[k] = xs[k];
            twsr[k] = T(0);
          }
        } else {
          rot(q_vr, xs, w1);
          rot(q_r, t_vr, r2tv);
          rot(q_r, w1, r2w1);
          for (int k = 0; k < 3; ++k) twsr[k] = t_r[k] + r2tv[k];
        }
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
          // d(xn,yn)/dp; the guarded z is a constant, so no z derivative
          const T g00 = a00 * iz, g01 = a01 * iz;
          const T g10 = a10 * iz, g11 = a11 * iz;
          const T g02 = small_z ? T(0) : -(a00 * xn + a01 * yn) * iz;
          const T g12 = small_z ? T(0) : -(a10 * xn + a11 * yn) * iz;

          // residual-sign Jacobian row pair of a sensor-frame direction dp
          auto dres = [&](const T* dp, T* j0, T* j1) {
            *j0 = -(g00 * dp[0] + g01 * dp[1] + g02 * dp[2]);
            *j1 = -(g10 * dp[0] + g11 * dp[1] + g12 * dp[2]);
          };
          const bool same = !lm3 && pm == pr;

          if (role == 0) {
            if (!lm3) {
              // inverse depth: dp/drho = Rv^T Rm^T (t_wsr - t_m) - Rv^T t_v
              T drho3[3] = {twsr[0] - t_m[0], twsr[1] - t_m[1],
                            twsr[2] - t_m[2]};
              T drho[3];
              to_sensor(q_m, q_v, drho3, drho);
              T dl[3] = {drho[0] - rvtv[0], drho[1] - rvtv[1],
                         drho[2] - rvtv[2]};
              dres(dl, &s_jl[2 * lr], &s_jl[2 * lr + 1]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              T e[3] = {T(0), T(0), T(0)};
              e[c] = T(1);
              T j0, j1;
              if (role == 1) {
                // translations: dp/dt_m = -rho Rv^T Rm^T e_c, dp/dt_r =
                // -that; lm_size 3: dp/dx_c = Rv^T Rm^T e_c
                T ec[3];
                to_sensor(q_m, q_v, e, ec);
                T dm[3] = {-rho * ec[0], -rho * ec[1], -rho * ec[2]};
                dres(dm, &j0, &j1);
                s_jm[12 * lr + c] = same ? T(0) : j0;
                s_jm[12 * lr + 6 + c] = same ? T(0) : j1;
                s_jr[12 * lr + c] = same || lm3 ? T(0) : -j0;
                s_jr[12 * lr + 6 + c] = same || lm3 ? T(0) : -j1;
                if (lm_size == 3) {
                  s_jl[6 * lr + c] = -j0;
                  s_jl[6 * lr + 3 + c] = -j1;
                }
              } else if (role == 2) {
                // meas rotation: dp/dw_m = Rv^T (u x e_c)
                T uxe[3] = {u[1] * e[2] - u[2] * e[1],
                            u[2] * e[0] - u[0] * e[2],
                            u[0] * e[1] - u[1] * e[0]};
                T dw[3];
                rot_t(q_v, uxe, dw);
                dres(dw, &j0, &j1);
                s_jm[12 * lr + 3 + c] = same ? T(0) : j0;
                s_jm[12 * lr + 9 + c] = same ? T(0) : j1;
              } else if (lm3) {
                s_jr[12 * lr + 3 + c] = T(0);
                s_jr[12 * lr + 9 + c] = T(0);
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
  }
  __syncthreads();

  store_run(r_out + 2LL * row0, s_r, 2 * nrows);
  store_run(err_out + row0, s_err, nrows);
  if (JAC) {
    store_run(jm_out + 12LL * row0, s_jm, 12 * nrows);
    store_run(jr_out + 12LL * row0, s_jr, 12 * nrows);
    store_run(jl_out + 2LL * nl * row0, s_jl, 2 * nl * nrows);
    if (n_cal) store_run(jc_out + 2LL * n_cal * row0, s_jc, 2 * n_cal * nrows);
  }
}

template <typename T>
int launch(const T* z, const int* pose, const int* lm, const int* cam,
           const uint8_t* valid, const T* pose_q, const T* pose_t,
           const T* lm_x, const int* lm_ref_pose, const int* lm_ref_cam,
           const T* lm_z_ref, const uint8_t* lm_has_z_ref,
           const T* cam_params, const int* cam_model, const T* tvs_q,
           const T* tvs_t, int n_params, int ncam, int nr, int with_jac,
           int lm_size, int calib_size, int n_cal, T* r, T* jm, T* jr,
           T* jl, T* jc, T* err, void* stream) {
  if ((lm_size != 0 && lm_size != 1 && lm_size != 3) || calib_size < 0 ||
      calib_size > 5 || n_cal < 0 || n_cal > MAX_CAL || n_params < 5)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nr > 0) {
    const int blocks = (nr + ROWS - 1) / ROWS;
    const size_t smem = static_cast<size_t>(ncam) * CAM * sizeof(T);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (with_jac) {
      const int warps = ROLES + (n_cal ? CAL_WARPS : 0);
      reprojection_kernel<T, true><<<blocks, ROWS * warps, smem, s>>>(
          z, pose, lm, cam, valid, pose_q, pose_t, lm_x, lm_ref_pose,
          lm_ref_cam, lm_z_ref, lm_has_z_ref, cam_params, cam_model, tvs_q,
          tvs_t, n_params, ncam, nr, lm_size, calib_size, n_cal, r, jm, jr,
          jl, jc, err);
    } else {
      reprojection_kernel<T, false><<<blocks, ROWS, smem, s>>>(
          z, pose, lm, cam, valid, pose_q, pose_t, lm_x, lm_ref_pose,
          lm_ref_cam, lm_z_ref, lm_has_z_ref, cam_params, cam_model, tvs_q,
          tvs_t, n_params, ncam, nr, lm_size, calib_size, 0, r, jm, jr, jl,
          jc, err);
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
                        const int* lm_ref_cam, const float* lm_z_ref,
                        const uint8_t* lm_has_z_ref, const float* cam_params,
                        const int* cam_model, const float* tvs_q,
                        const float* tvs_t, int n_params, int ncam, int nr,
                        int with_jac, int lm_size, int calib_size, int n_cal,
                        float* r, float* jm, float* jr, float* jl, float* jc,
                        float* err, void* stream) {
  return launch<float>(z, pose, lm, cam, valid, pose_q, pose_t, lm_x,
                       lm_ref_pose, lm_ref_cam, lm_z_ref, lm_has_z_ref,
                       cam_params, cam_model, tvs_q, tvs_t, n_params, ncam,
                       nr, with_jac, lm_size, calib_size, n_cal, r, jm, jr,
                       jl, jc, err, stream);
}

int ba_reprojection_f64(const double* z, const int* pose, const int* lm,
                        const int* cam, const uint8_t* valid,
                        const double* pose_q, const double* pose_t,
                        const double* lm_x, const int* lm_ref_pose,
                        const int* lm_ref_cam, const double* lm_z_ref,
                        const uint8_t* lm_has_z_ref, const double* cam_params,
                        const int* cam_model, const double* tvs_q,
                        const double* tvs_t, int n_params, int ncam, int nr,
                        int with_jac, int lm_size, int calib_size, int n_cal,
                        double* r, double* jm, double* jr, double* jl,
                        double* jc, double* err, void* stream) {
  return launch<double>(z, pose, lm, cam, valid, pose_q, pose_t, lm_x,
                        lm_ref_pose, lm_ref_cam, lm_z_ref, lm_has_z_ref,
                        cam_params, cam_model, tvs_q, tvs_t, n_params, ncam,
                        nr, with_jac, lm_size, calib_size, n_cal, r, jm, jr,
                        jl, jc, err, stream);
}

}  // extern "C"
