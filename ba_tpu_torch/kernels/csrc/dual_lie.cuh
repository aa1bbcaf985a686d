// Forward-mode dual numbers and the quaternion / SE(3) / camera maps of
// ba_tpu_torch/core/{lie,camera}.py, written once over a scalar type S that
// is either T (float, double) or Dual<T>.
//
// A Dual<T> carries one tangent: x = v + d e.  Every map below is the same
// sequence of operations as its PyTorch counterpart, with the same guards
// (a guard selects a branch by the primal value, as `torch.where` does, so
// the derivative is the selected branch's, as `torch.func.jacfwd` gives it).
// A kernel that seeds tangent j in one lane gets column j of the Jacobian in
// that lane: forward mode by hand, one lane per column.
//
// Included by kernels/csrc/imu_preint.cu (the RK4 step and the residual map
// of kernel K2) and kernels/csrc/reprojection.cu (kernel 1's calibration
// columns).

#pragma once

#include <math.h>

#define BA_HD __host__ __device__ __forceinline__

namespace ba {

template <typename T>
struct Dual {
  T v, d;
  BA_HD Dual() : v(T(0)), d(T(0)) {}
  BA_HD Dual(T v_, T d_ = T(0)) : v(v_), d(d_) {}
  friend BA_HD Dual operator+(Dual a, Dual b) {
    return Dual(a.v + b.v, a.d + b.d);
  }
  friend BA_HD Dual operator-(Dual a, Dual b) {
    return Dual(a.v - b.v, a.d - b.d);
  }
  friend BA_HD Dual operator*(Dual a, Dual b) {
    return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
  }
  friend BA_HD Dual operator/(Dual a, Dual b) {
    const T q = a.v / b.v;
    return Dual(q, (a.d - q * b.d) / b.v);
  }
  friend BA_HD Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
};

// the base type of S
template <typename S>
struct Base {
  using type = S;
};
template <typename T>
struct Base<Dual<T>> {
  using type = T;
};

template <typename T>
BA_HD T val(T x) {
  return x;
}
template <typename T>
BA_HD T val(Dual<T> x) {
  return x.v;
}

BA_HD float sqrt_(float x) { return sqrtf(x); }
BA_HD double sqrt_(double x) { return sqrt(x); }
BA_HD float sin_(float x) { return sinf(x); }
BA_HD double sin_(double x) { return sin(x); }
BA_HD float cos_(float x) { return cosf(x); }
BA_HD double cos_(double x) { return cos(x); }
BA_HD float tan_(float x) { return tanf(x); }
BA_HD double tan_(double x) { return tan(x); }
BA_HD float atan_(float x) { return atanf(x); }
BA_HD double atan_(double x) { return atan(x); }
BA_HD float atan2_(float y, float x) { return atan2f(y, x); }
BA_HD double atan2_(double y, double x) { return atan2(y, x); }
BA_HD float abs_(float x) { return fabsf(x); }
BA_HD double abs_(double x) { return fabs(x); }

template <typename T>
BA_HD Dual<T> sqrt_(Dual<T> x) {
  const T s = sqrt_(x.v);
  return Dual<T>(s, x.d / (T(2) * s));
}
template <typename T>
BA_HD Dual<T> sin_(Dual<T> x) {
  return Dual<T>(sin_(x.v), x.d * cos_(x.v));
}
template <typename T>
BA_HD Dual<T> cos_(Dual<T> x) {
  return Dual<T>(cos_(x.v), -x.d * sin_(x.v));
}
template <typename T>
BA_HD Dual<T> tan_(Dual<T> x) {
  const T t = tan_(x.v);
  return Dual<T>(t, x.d * (T(1) + t * t));
}
template <typename T>
BA_HD Dual<T> atan_(Dual<T> x) {
  return Dual<T>(atan_(x.v), x.d / (T(1) + x.v * x.v));
}
template <typename T>
BA_HD Dual<T> atan2_(Dual<T> y, Dual<T> x) {
  return Dual<T>(atan2_(y.v, x.v),
                 (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v));
}

// `torch.where(c, a, b)` on the primal
template <typename S>
BA_HD S sel(bool c, S a, S b) {
  return c ? a : b;
}

// ---------------------------------------------------------------------------
// Quaternions [w, x, y, z] and decoupled SE(3) (core/lie.py)

constexpr double LIE_SMALL = 1e-6;   // core/lie.py _SMALL
constexpr double CAM_SMALL = 1e-9;   // core/camera.py _SMALL

template <typename S>
BA_HD void cross(const S* a, const S* b, S* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
BA_HD void quat_mul(const S* a, const S* b, S* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <typename S>
BA_HD void quat_conj(const S* q, S* out) {
  out[0] = q[0];
  out[1] = -q[1];
  out[2] = -q[2];
  out[3] = -q[3];
}

template <typename S>
BA_HD void quat_normalize(S* q) {
  const S n = sqrt_(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

// R(q) v = v + w t + q_v x t, t = 2 q_v x v
template <typename S>
BA_HD void quat_rotate(const S* q, const S* v, S* out) {
  using T = typename Base<S>::type;
  S c[3], t[3], u[3];
  cross(q + 1, v, c);
  for (int k = 0; k < 3; ++k) t[k] = T(2) * c[k];
  cross(q + 1, t, u);
  for (int k = 0; k < 3; ++k) out[k] = v[k] + q[0] * t[k] + u[k];
}

template <typename S>
BA_HD void so3_exp(const S* w, S* q) {
  using T = typename Base<S>::type;
  const S th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = val(th2) < T(LIE_SMALL * LIE_SMALL);
  const S th = sqrt_(sel(small, S(T(1)), th2));
  const S half = T(0.5) * th;
  const S sinc_half =
      small ? S(T(0.5)) - th2 / T(48) : sin_(half) / th;
  q[0] = small ? S(T(1)) - th2 / T(8) : cos_(half);
  for (int k = 0; k < 3; ++k) q[k + 1] = sinc_half * w[k];
}

template <typename S>
BA_HD void so3_log(const S* q_in, S* out) {
  using T = typename Base<S>::type;
  const T sgn = val(q_in[0]) < T(0) ? T(-1) : T(1);
  S q[4];
  for (int k = 0; k < 4; ++k) q[k] = q_in[k] * sgn;
  const S n2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const bool small = val(n2) < T(LIE_SMALL * LIE_SMALL);
  const S n = sqrt_(sel(small, S(T(1)), n2));
  const S ws = abs_(val(q[0])) < T(1e-12) ? S(T(1)) : q[0];
  const S scale = small ? T(2) / ws - T(2) * n2 / (T(3) * (ws * ws * ws))
                        : T(2) * atan2_(n, q[0]) / n;
  for (int k = 0; k < 3; ++k) out[k] = scale * q[k + 1];
}

// (q, t) * exp([dt, dw]) = (q * exp(dw), t + dt)
template <typename S>
BA_HD void se3_retract(const S* q, const S* t, const S* x, S* qo, S* to) {
  S e[4];
  so3_exp(x + 3, e);
  quat_mul(q, e, qo);
  for (int k = 0; k < 3; ++k) to[k] = t[k] + x[k];
}

// T_a T_b
template <typename S>
BA_HD void se3_compose(const S* qa, const S* ta, const S* qb, const S* tb,
                       S* qo, S* to) {
  S r[3];
  quat_mul(qa, qb, qo);
  quat_rotate(qa, tb, r);
  for (int k = 0; k < 3; ++k) to[k] = ta[k] + r[k];
}

template <typename S>
BA_HD void se3_inverse(const S* q, const S* t, S* qo, S* to) {
  S r[3];
  quat_conj(q, qo);
  quat_rotate(qo, t, r);
  for (int k = 0; k < 3; ++k) to[k] = -r[k];
}

// [R xyz + t rho] of a homogeneous [xyz, rho]
template <typename S>
BA_HD void se3_transform_homog(const S* q, const S* t, const S* ph, S* out) {
  S r[3];
  quat_rotate(q, ph, r);
  for (int k = 0; k < 3; ++k) out[k] = r[k] + t[k] * ph[3];
}

// [a.t - b.t, so3_log(q_a q_b^-1)]
template <typename S>
BA_HD void se3_log_decoupled(const S* qa, const S* ta, const S* qb,
                             const S* tb, S* out) {
  S qc[4], qd[4];
  quat_conj(qb, qc);
  quat_mul(qa, qc, qd);
  for (int k = 0; k < 3; ++k) out[k] = ta[k] - tb[k];
  so3_log(qd, out + 3);
}

// ---------------------------------------------------------------------------
// Cameras (core/camera.py): linear (0), FOV (1), poly3 (2) and equidistant
// (3), each a radial factor on the normalized point; params [fx, fy, cx,
// cy, p4, p5, p6] (FOV: p4 = w; poly3: p4..p6 = k1, k2, k3)

constexpr int MODEL_LINEAR = 0;
constexpr int MODEL_FOV = 1;
constexpr int MODEL_POLY3 = 2;
constexpr int MODEL_EQUIDISTANT = 3;
constexpr int MAX_PARAMS = 7;        // core/camera.py MAX_PARAMS

template <typename S>
BA_HD S fov_factor(S w, S r_u) {
  using T = typename Base<S>::type;
  const S tan_half = tan_(T(0.5) * w);
  const bool small_r = val(r_u) < T(CAM_SMALL);
  const S r_safe = sel(small_r, S(T(1)), r_u);
  const bool small_w = abs_(val(w)) < T(CAM_SMALL);
  const S w_safe = sel(small_w, S(T(1)), w);
  const S mul = T(2) * tan_half;
  const S lin = atan_(r_safe * mul) / (r_safe * w_safe);
  const S lim = mul / w_safe;
  const S factor = sel(small_r, lim, lin);
  return sel(small_w, S(T(1)), factor);
}

// r_d / r_u = 1 + k1 r^2 + k2 r^4 + k3 r^6 (`_poly3_factor`)
template <typename S>
BA_HD S poly3_factor(const S* params, S r_u) {
  using T = typename Base<S>::type;
  const S r2 = r_u * r_u;
  return S(T(1)) + r2 * (params[4] + r2 * (params[5] + r2 * params[6]));
}

// r_d / r_u = atan(r) / r, 1 below the guard (`_equi_factor`)
template <typename S>
BA_HD S equi_factor(S r_u) {
  using T = typename Base<S>::type;
  const bool small = val(r_u) < T(CAM_SMALL);
  const S r_safe = sel(small, S(T(1)), r_u);
  return sel(small, S(T(1)), atan_(r_safe) / r_safe);
}

// r_u / r_d by exactly eight Newton steps on r_u (1 + k1 r_u^2 + ...) =
// r_d (`_poly3_inv_factor`), so the tangent runs through the same steps
// as jacfwd's
template <typename S>
BA_HD S poly3_inv_factor(const S* params, S r_d) {
  using T = typename Base<S>::type;
  const bool small = val(r_d) < T(CAM_SMALL);
  const S rd = sel(small, S(T(1)), r_d);
  const S k1 = params[4], k2 = params[5], k3 = params[6];
  S ru = rd;
  for (int it = 0; it < 8; ++it) {
    const S r2 = ru * ru;
    const S f = ru * (S(T(1)) + r2 * (k1 + r2 * (k2 + r2 * k3))) - rd;
    const S df = S(T(1)) + r2 * (T(3) * k1 +
                                 r2 * (T(5) * k2 + r2 * T(7) * k3));
    ru = ru - f / (abs_(val(df)) < T(CAM_SMALL) ? S(T(1)) : df);
  }
  return sel(small, S(T(1)), ru / rd);
}

// sqrt of a squared radius; at 0 the tangent is 0 (the guards that follow
// take a branch that does not depend on r there, except poly3's, whose
// reference tangent at exactly r = 0 is sqrt's 0 / 0)
template <typename S>
BA_HD S radius(S r2) {
  using T = typename Base<S>::type;
  return val(r2) > T(0) ? sqrt_(r2) : S(T(0));
}

// pixel of a sensor-frame ray
template <typename S>
BA_HD void project(const S* params, int model, const S* ray, S* pix) {
  using T = typename Base<S>::type;
  const S z = ray[2];
  const T zv = val(z);
  const T zero = zv == T(0) ? T(1) : T(0);
  const T sgn = zv > T(0) ? T(1) : (zv < T(0) ? T(-1) : T(0));
  const S z_safe = abs_(zv) < T(CAM_SMALL)
                       ? S(sgn * T(CAM_SMALL) + zero * T(CAM_SMALL))
                       : z;
  const S xn = ray[0] / z_safe;
  const S yn = ray[1] / z_safe;
  S factor = S(T(1));
  if (model == MODEL_FOV || model == MODEL_POLY3 ||
      model == MODEL_EQUIDISTANT) {
    const S r_u = radius(xn * xn + yn * yn);
    if (model == MODEL_FOV)
      factor = fov_factor(params[4], r_u);
    else if (model == MODEL_POLY3)
      factor = poly3_factor(params, r_u);
    else
      factor = equi_factor(r_u);
  }
  pix[0] = params[0] * factor * xn + params[2];
  pix[1] = params[1] * factor * yn + params[3];
}

// unit-norm sensor-frame ray of a pixel
template <typename S>
BA_HD void unproject(const S* params, int model, const S* pix, S* ray) {
  using T = typename Base<S>::type;
  const S xd = (pix[0] - params[2]) / params[0];
  const S yd = (pix[1] - params[3]) / params[1];
  S factor = S(T(1));
  if (model == MODEL_FOV) {
    const S r_d = radius(xd * xd + yd * yd);
    const S w = params[4];
    const S tan_half = tan_(T(0.5) * w);
    const bool small =
        val(r_d) < T(CAM_SMALL) || abs_(val(w)) < T(CAM_SMALL);
    const S r_safe = sel(small, S(T(1)), r_d);
    const S inv = tan_(r_safe * w) / (T(2) * tan_half * r_safe);
    factor = sel(small, S(T(1)), inv);
  } else if (model == MODEL_POLY3) {
    factor = poly3_inv_factor(params, radius(xd * xd + yd * yd));
  } else if (model == MODEL_EQUIDISTANT) {
    // r_u = tan(r_d), with its own r-guard (the FOV guard also fires at
    // w = 0)
    const S r_d = radius(xd * xd + yd * yd);
    const bool small = val(r_d) < T(CAM_SMALL);
    const S r_safe = sel(small, S(T(1)), r_d);
    factor = sel(small, S(T(1)), tan_(r_safe) / r_safe);
  }
  ray[0] = xd * factor;
  ray[1] = yd * factor;
  ray[2] = S(T(1));
  const S n = sqrt_(ray[0] * ray[0] + ray[1] * ray[1] + ray[2] * ray[2]);
  for (int k = 0; k < 3; ++k) ray[k] = ray[k] / n;
}

}  // namespace ba
