// Native host-side problem builder: the Add* problem-graph API.
//
// C++ counterpart of the reference's problem container / bookkeeping layer
// (arpg/ba, include/ba/BundleAdjuster.h:111-753 — AddPose, AddLandmark,
// AddProjectionResidual, AddUnaryConstraint, AddBinaryConstraint,
// AddImuResidual, conditioning-edge detection, param-mask /
// auto-regularization decisions, BundleAdjuster.cpp:1252-1330).  The
// compute path stays on the device; this class owns the *construction* hot
// loop — appending hundreds of thousands of residual rows and packing them
// into the padded structure-of-arrays layout the solver consumes — which
// would otherwise be Python-rate.
//
// Exposed through a C API consumed via ctypes (ba_tpu_torch/native/
// __init__.py, NativeProblemBuilder).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pose {
  double q[4], t[3], v[3], b[6], cam_params[8], time;
  bool active;
};

struct Landmark {
  double x_w[4], z_ref[2];
  int ref_pose, ref_cam;
  bool active, has_z_ref;
};

struct Camera {
  double params[8], tvs_q[4], tvs_t[3];
  int model;
};

struct Proj {
  double z[2], weight;
  int pose, lm, cam;
  bool cond;
};

struct Prior {
  double q[4], t[3], cov_inv[36];
  int pose1, pose2;  // pose2 unused for unary
};

struct ImuSpan {
  int pose1, pose2;
  bool cond;
  std::vector<double> w, a, times;  // n*3, n*3, n
};

struct Builder {
  int pose_dim, lm_size, calib_size;
  bool do_tvs, regularize_biases_in_batch, enable_auto_regularization;
  std::vector<Pose> poses;
  std::vector<Landmark> lms;
  std::vector<Camera> cams;
  std::vector<Proj> proj;
  std::vector<Prior> unary, binary;
  std::vector<ImuSpan> imu;
};

}  // namespace

extern "C" {

void* pb_create(int pose_dim, int lm_size, int calib_size, int do_tvs,
                int regularize_biases_in_batch,
                int enable_auto_regularization) {
  Builder* b = new Builder();
  b->pose_dim = pose_dim;
  b->lm_size = lm_size;
  b->calib_size = calib_size;
  b->do_tvs = do_tvs != 0;
  b->regularize_biases_in_batch = regularize_biases_in_batch != 0;
  b->enable_auto_regularization = enable_auto_regularization != 0;
  return b;
}

void pb_destroy(void* h) { delete static_cast<Builder*>(h); }

int pb_add_camera(void* h, const double* params, int n_params, int model,
                  const double* tvs_q, const double* tvs_t) {
  Builder* b = static_cast<Builder*>(h);
  Camera c{};
  std::memset(c.params, 0, sizeof(c.params));
  std::memcpy(c.params, params, sizeof(double) * n_params);
  std::memcpy(c.tvs_q, tvs_q, sizeof(double) * 4);
  std::memcpy(c.tvs_t, tvs_t, sizeof(double) * 3);
  c.model = model;
  b->cams.push_back(c);
  return static_cast<int>(b->cams.size()) - 1;
}

// cam_params: per-pose frozen intrinsics (reference AddPose, h:292-303);
// pass 8 doubles (zero-padded).
int pb_add_pose(void* h, const double* q, const double* t, const double* v,
                const double* bias, const double* cam_params, int active,
                double time) {
  Builder* b = static_cast<Builder*>(h);
  Pose p{};
  std::memcpy(p.q, q, sizeof(p.q));
  std::memcpy(p.t, t, sizeof(p.t));
  std::memcpy(p.v, v, sizeof(p.v));
  std::memcpy(p.b, bias, sizeof(p.b));
  std::memcpy(p.cam_params, cam_params, sizeof(p.cam_params));
  p.active = active != 0;
  p.time = time;
  b->poses.push_back(p);
  return static_cast<int>(b->poses.size()) - 1;
}

int pb_add_landmark(void* h, const double* x_w4, int ref_pose, int ref_cam,
                    int active) {
  Builder* b = static_cast<Builder*>(h);
  Landmark l{};
  std::memcpy(l.x_w, x_w4, sizeof(l.x_w));
  l.ref_pose = ref_pose;
  l.ref_cam = ref_cam;
  l.active = active != 0;
  l.has_z_ref = false;
  b->lms.push_back(l);
  return static_cast<int>(b->lms.size()) - 1;
}

// Returns 1 if the residual was added, 0 if skipped (reference-view
// observation in inverse-depth mode — records z_ref instead,
// BundleAdjuster.h:488-501).  Only the ref-camera observation at the ref
// pose is skipped (cam_id == lm.ref_cam_id, h:480-501); same-pose
// cross-camera (stereo) observations are kept.
int pb_add_projection(void* h, const double* z, int pose, int lm, int cam,
                      double weight) {
  Builder* b = static_cast<Builder*>(h);
  if (b->lm_size == 1 && pose == b->lms[lm].ref_pose &&
      cam == b->lms[lm].ref_cam) {
    std::memcpy(b->lms[lm].z_ref, z, sizeof(double) * 2);
    b->lms[lm].has_z_ref = true;
    return 0;
  }
  Proj r{};
  std::memcpy(r.z, z, sizeof(r.z));
  r.pose = pose;
  r.lm = lm;
  r.cam = cam;
  r.weight = weight;
  r.cond = !b->poses[b->lms[lm].ref_pose].active && b->poses[pose].active;
  b->proj.push_back(r);
  return 1;
}

void pb_add_unary(void* h, int pose, const double* q, const double* t,
                  const double* cov_inv) {
  Builder* b = static_cast<Builder*>(h);
  Prior r{};
  std::memcpy(r.q, q, sizeof(r.q));
  std::memcpy(r.t, t, sizeof(r.t));
  std::memcpy(r.cov_inv, cov_inv, sizeof(r.cov_inv));
  r.pose1 = pose;
  b->unary.push_back(r);
}

void pb_add_binary(void* h, int pose1, int pose2, const double* q,
                   const double* t, const double* cov_inv) {
  Builder* b = static_cast<Builder*>(h);
  Prior r{};
  std::memcpy(r.q, q, sizeof(r.q));
  std::memcpy(r.t, t, sizeof(r.t));
  std::memcpy(r.cov_inv, cov_inv, sizeof(r.cov_inv));
  r.pose1 = pose1;
  r.pose2 = pose2;
  b->binary.push_back(r);
}

void pb_add_imu(void* h, int pose1, int pose2, int n, const double* w,
                const double* a, const double* times) {
  Builder* b = static_cast<Builder*>(h);
  ImuSpan s;
  s.pose1 = pose1;
  s.pose2 = pose2;
  s.cond = !b->poses[pose1].active && b->poses[pose2].active;
  s.w.assign(w, w + 3 * n);
  s.a.assign(a, a + 3 * n);
  s.times.assign(times, times + n);
  b->imu.push_back(s);
}

// counts[0..7] = n_poses, n_lms, n_cams, n_proj, n_unary, n_binary, n_imu,
// max_imu_span
void pb_counts(void* h, int64_t* counts) {
  Builder* b = static_cast<Builder*>(h);
  counts[0] = b->poses.size();
  counts[1] = b->lms.size();
  counts[2] = b->cams.size();
  counts[3] = b->proj.size();
  counts[4] = b->unary.size();
  counts[5] = b->binary.size();
  counts[6] = b->imu.size();
  int64_t mx = 1;
  for (const auto& s : b->imu)
    mx = std::max<int64_t>(mx, static_cast<int64_t>(s.times.size()));
  counts[7] = mx;
}

// Param mask + regularization decisions (reference cpp:1252-1330).
// mask is (P, 15) uint8, caller-allocated and zeroed for padding rows.
void pb_build_mask(void* h, uint8_t* mask) {
  Builder* b = static_cast<Builder*>(h);
  const int P = static_cast<int>(b->poses.size());
  const bool vel = b->pose_dim >= 9;
  const bool bias = b->pose_dim >= 15;

  std::vector<bool> has_inertial(P, false), has_any(P, false);
  for (const auto& s : b->imu) {
    has_inertial[s.pose1] = has_inertial[s.pose2] = true;
    has_any[s.pose1] = has_any[s.pose2] = true;
  }
  // ref poses become constrained only through projection rows (matching
  // the Python builder — a landmark with zero residuals constrains nothing)
  for (const auto& r : b->proj) {
    has_any[r.pose] = true;
    has_any[b->lms[r.lm].ref_pose] = true;
  }
  for (const auto& r : b->unary) has_any[r.pose1] = true;
  for (const auto& r : b->binary) {
    has_any[r.pose1] = true;
    has_any[r.pose2] = true;
  }

  bool all_active = P > 0;
  for (const auto& p : b->poses) all_active = all_active && p.active;

  for (int i = 0; i < P; ++i) {
    uint8_t* m = mask + i * 15;
    std::memset(m, 0, 15);
    if (!b->poses[i].active || !has_any[i]) continue;
    for (int k = 0; k < 6; ++k) m[k] = 1;
    if (vel && has_inertial[i])
      for (int k = 6; k < 9; ++k) m[k] = 1;
    if (bias && has_inertial[i])
      for (int k = 9; k < 15; ++k) m[k] = 1;
  }

  // auto gauge fixing (cpp:1285-1330)
  if (b->enable_auto_regularization && all_active && b->unary.empty()) {
    uint8_t* m = mask;  // root pose
    m[0] = m[1] = m[2] = 0;
    if (bias && b->regularize_biases_in_batch)
      for (int k = 9; k < 15; ++k) m[k] = 0;
    if (!vel) {
      m[3] = m[4] = m[5] = 0;
    } else {
      // fix the rotation axis most aligned with gravity
      const double* q = b->poses[0].q;
      const double w = q[0], x = q[1], y = q[2], z = q[3];
      // R^T * (0,0,-1): third row of R negated
      const double gx = -(2 * (x * z - w * y));
      const double gy = -(2 * (y * z + w * x));
      const double gz = -(1 - 2 * (x * x + y * y));
      int axis = 0;
      double best = std::fabs(gx);
      if (std::fabs(gy) > best) { best = std::fabs(gy); axis = 1; }
      if (std::fabs(gz) > best) { axis = 2; }
      m[3 + axis] = 0;
    }
  }
}

// cam_params out buffer is (P, max_params) caller-zeroed.
void pb_pack_poses(void* h, double* q, double* t, double* v, double* bias,
                   double* cam_params, int max_params, double* time,
                   uint8_t* active) {
  Builder* b = static_cast<Builder*>(h);
  for (size_t i = 0; i < b->poses.size(); ++i) {
    const Pose& p = b->poses[i];
    std::memcpy(q + 4 * i, p.q, sizeof(p.q));
    std::memcpy(t + 3 * i, p.t, sizeof(p.t));
    std::memcpy(v + 3 * i, p.v, sizeof(p.v));
    std::memcpy(bias + 6 * i, p.b, sizeof(p.b));
    std::memcpy(cam_params + max_params * i, p.cam_params,
                sizeof(double) * max_params);
    time[i] = p.time;
    active[i] = p.active ? 1 : 0;
  }
}

void pb_pack_landmarks(void* h, double* x_w, int32_t* ref_pose,
                       int32_t* ref_cam, uint8_t* active, double* z_ref,
                       uint8_t* has_z_ref) {
  Builder* b = static_cast<Builder*>(h);
  for (size_t i = 0; i < b->lms.size(); ++i) {
    const Landmark& l = b->lms[i];
    std::memcpy(x_w + 4 * i, l.x_w, sizeof(l.x_w));
    ref_pose[i] = l.ref_pose;
    ref_cam[i] = l.ref_cam;
    active[i] = l.active ? 1 : 0;
    std::memcpy(z_ref + 2 * i, l.z_ref, sizeof(l.z_ref));
    has_z_ref[i] = l.has_z_ref ? 1 : 0;
  }
}

void pb_pack_cameras(void* h, double* params, int32_t* model, double* tvs_q,
                     double* tvs_t, int max_params) {
  Builder* b = static_cast<Builder*>(h);
  for (size_t i = 0; i < b->cams.size(); ++i) {
    const Camera& c = b->cams[i];
    std::memcpy(params + max_params * i, c.params,
                sizeof(double) * max_params);
    model[i] = c.model;
    std::memcpy(tvs_q + 4 * i, c.tvs_q, sizeof(c.tvs_q));
    std::memcpy(tvs_t + 3 * i, c.tvs_t, sizeof(c.tvs_t));
  }
}

void pb_pack_proj(void* h, double* z, int32_t* pose, int32_t* lm,
                  int32_t* cam, double* weight, uint8_t* valid,
                  uint8_t* cond) {
  Builder* b = static_cast<Builder*>(h);
  for (size_t i = 0; i < b->proj.size(); ++i) {
    const Proj& r = b->proj[i];
    std::memcpy(z + 2 * i, r.z, sizeof(r.z));
    pose[i] = r.pose;
    lm[i] = r.lm;
    cam[i] = r.cam;
    weight[i] = r.weight;
    valid[i] = 1;
    cond[i] = r.cond ? 1 : 0;
  }
}

static void PackPriors(const std::vector<Prior>& v, double* q, double* t,
                       double* cov_inv, int32_t* p1, int32_t* p2,
                       uint8_t* valid) {
  for (size_t i = 0; i < v.size(); ++i) {
    const Prior& r = v[i];
    std::memcpy(q + 4 * i, r.q, sizeof(r.q));
    std::memcpy(t + 3 * i, r.t, sizeof(r.t));
    std::memcpy(cov_inv + 36 * i, r.cov_inv, sizeof(r.cov_inv));
    p1[i] = r.pose1;
    if (p2) p2[i] = r.pose2;
    valid[i] = 1;
  }
}

void pb_pack_unary(void* h, double* q, double* t, double* cov_inv,
                   int32_t* pose, uint8_t* valid) {
  Builder* b = static_cast<Builder*>(h);
  PackPriors(b->unary, q, t, cov_inv, pose, nullptr, valid);
}

void pb_pack_binary(void* h, double* q, double* t, double* cov_inv,
                    int32_t* pose1, int32_t* pose2, uint8_t* valid) {
  Builder* b = static_cast<Builder*>(h);
  PackPriors(b->binary, q, t, cov_inv, pose1, pose2, valid);
}

// w/a: (Ni, M, 3); times/meas_valid: (Ni, M) — caller-zeroed, M from
// pb_counts.  Padded step times repeat the last sample time so dt == 0.
void pb_pack_imu(void* h, int M, int32_t* pose1, int32_t* pose2, double* w,
                 double* a, double* times, uint8_t* meas_valid,
                 uint8_t* valid, uint8_t* cond) {
  Builder* b = static_cast<Builder*>(h);
  for (size_t i = 0; i < b->imu.size(); ++i) {
    const ImuSpan& s = b->imu[i];
    const int n = static_cast<int>(s.times.size());
    pose1[i] = s.pose1;
    pose2[i] = s.pose2;
    std::memcpy(w + i * M * 3, s.w.data(), sizeof(double) * 3 * n);
    std::memcpy(a + i * M * 3, s.a.data(), sizeof(double) * 3 * n);
    std::memcpy(times + i * M, s.times.data(), sizeof(double) * n);
    const double t_last = n > 0 ? s.times[n - 1] : 0.0;
    for (int k = n; k < M; ++k) times[i * M + k] = t_last;
    for (int k = 0; k < n; ++k) meas_valid[i * M + k] = 1;
    valid[i] = 1;
    cond[i] = s.cond ? 1 : 0;
  }
}

}  // extern "C"
