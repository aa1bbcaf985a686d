// Native log parser + dead reckoner for the GPS+IMU+odometry app.
//
// The reference implements this host-side stage in C++
// (arpg/ba, applications/unary_binary_imu_test/main.cpp:
// parse_file 243-280 tokenizes ODO/UTM/IMU whitespace records;
// update_incremental_pose 87-139 integrates differential-drive wheel
// odometry; add_gyro_and_speed 67-84 right-multiplies gyro increments with
// speed*dt translation; f_gps 141-219 snapshots the dead-reckoned
// increment at each UTM fix).  This is the native twin: one pass
// over the file producing packed IMU rows, re-based GPS fixes, and the
// per-fix dead-reckoned pose-increment guesses; the port's
// apps/unary_binary_imu_test.py keeps a pure-Python parser with identical
// semantics (tests/test_torch_native.py cross-checks the two).
//
// Intentional divergence from the reference: when the UTM max_poses cap is
// reached, the reference breaks out of the parse loop entirely
// (main.cpp:259-263); here (and in the Python fallback, whose contract this
// file matches bit-for-bit) parsing continues — further UTM records are
// dropped but ODO/IMU records keep integrating.  The extra IMU rows are
// unused by the app (residual spans only reach the last kept fix).
//
// C ABI (ctypes-bound in ba_tpu_torch/native/__init__.py):
//   lp_parse(path, max_poses) -> handle (NULL on unreadable file)
//   lp_counts(h, int64 out[2])           n_imu, n_gps
//   lp_imu(h, double* rows)              (n_imu, 7)  t wx wy wz ax ay az
//   lp_gps(h, double* rows)              (n_gps, 4)  t x y z  (re-based)
//   lp_guesses(h, double* q, double* t)  (n_gps, 4), (n_gps, 3)
//   lp_destroy(h)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr double kTrackwidth = 1.5;   // reference main.cpp:101
constexpr double kTiny = 0.0001;

struct Quat {                         // w, x, y, z
  double w = 1, x = 0, y = 0, z = 0;
};

Quat qmul(const Quat& a, const Quat& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

void qrotate(const Quat& q, const double v[3], double out[3]) {
  const double w = q.w, x = q.x, y = q.y, z = q.z;
  out[0] = (1 - 2 * (y * y + z * z)) * v[0] + 2 * (x * y - w * z) * v[1] +
           2 * (x * z + w * y) * v[2];
  out[1] = 2 * (x * y + w * z) * v[0] + (1 - 2 * (x * x + z * z)) * v[1] +
           2 * (y * z - w * x) * v[2];
  out[2] = 2 * (x * z - w * y) * v[0] + 2 * (y * z + w * x) * v[1] +
           (1 - 2 * (x * x + y * y)) * v[2];
}

Quat axis_angle(int axis, double angle) {
  Quat q;
  q.w = std::cos(angle / 2);
  const double s = std::sin(angle / 2);
  if (axis == 0) q.x = s;
  if (axis == 1) q.y = s;
  if (axis == 2) q.z = s;
  return q;
}

// aaZ * aaY * aaX — the reference's gyro-increment composition
// (main.cpp:76-80).
Quat euler_zyx(double wz, double wy, double wx) {
  return qmul(axis_angle(2, wz), qmul(axis_angle(1, wy), axis_angle(0, wx)));
}

// The reference app's incremental-pose state machine (main.cpp:40-139).
struct DeadReckoner {
  double speed = 0;
  double inc_x = 0, inc_y = 0, inc_yaw = 0;
  double inc_timestamp = 0;
  bool has_inc_timestamp = false;
  Quat gyro_q;
  double gyro_t[3] = {0, 0, 0};
  double last_imu_t = 0;
  bool has_last_imu_t = false;

  void odo(double t, double rr, double rl) {
    if (!has_inc_timestamp) {
      has_inc_timestamp = true;
      inc_timestamp = t;
      return;
    }
    speed = 0.5 * (rr + rl);
    const double dt = t - inc_timestamp;
    if (std::fabs(rr) > kTiny || std::fabs(rl) > kTiny) {
      if (std::fabs(rr - rl) < kTiny) {
        inc_x += std::cos(inc_yaw) * rr * dt;
        inc_y += std::sin(inc_yaw) * rr * dt;
      } else {
        const double w = (rr - rl) / kTrackwidth;
        const double R = kTrackwidth * 0.5 * (rr + rl) / (rr - rl);
        const double icc_x = inc_x - R * std::sin(inc_yaw);
        const double icc_y = inc_y + R * std::cos(inc_yaw);
        const double wdt = w * dt;
        const double nx = std::cos(wdt) * (inc_x - icc_x) -
                          std::sin(wdt) * (inc_y - icc_y) + icc_x;
        const double ny = std::sin(wdt) * (inc_x - icc_x) +
                          std::cos(wdt) * (inc_y - icc_y) + icc_y;
        inc_x = nx;
        inc_y = ny;
        inc_yaw += wdt;
      }
    }
    inc_timestamp = t;
  }

  void imu(double t, const double w[3]) {
    if (has_last_imu_t) {
      const double dt = t - last_imu_t;
      const Quat dq = euler_zyx(w[2] * dt, w[1] * dt, w[0] * dt);
      const double step[3] = {0.0, speed * dt, 0.0};
      double ds[3];
      qrotate(gyro_q, step, ds);
      gyro_t[0] += ds[0];
      gyro_t[1] += ds[1];
      gyro_t[2] += ds[2];
      gyro_q = qmul(gyro_q, dq);
      const double n = std::sqrt(gyro_q.w * gyro_q.w + gyro_q.x * gyro_q.x +
                                 gyro_q.y * gyro_q.y + gyro_q.z * gyro_q.z);
      gyro_q.w /= n;
      gyro_q.x /= n;
      gyro_q.y /= n;
      gyro_q.z /= n;
    }
    last_imu_t = t;
    has_last_imu_t = true;
  }

  void take(double q_out[4], double t_out[3]) {
    q_out[0] = gyro_q.w;
    q_out[1] = gyro_q.x;
    q_out[2] = gyro_q.y;
    q_out[3] = gyro_q.z;
    std::memcpy(t_out, gyro_t, sizeof(gyro_t));
    gyro_q = Quat{};
    gyro_t[0] = gyro_t[1] = gyro_t[2] = 0;
    inc_x = inc_y = inc_yaw = 0;
  }
};

struct ParsedLog {
  std::vector<double> imu_rows;   // flat (n, 7)
  std::vector<double> gps_rows;   // flat (n, 4)
  std::vector<double> guess_q;    // flat (n, 4)
  std::vector<double> guess_t;    // flat (n, 3)
};

bool split_csv(const std::string& line, std::vector<double>* vals,
               std::string* tag) {
  const auto comma = line.find(',');
  if (comma == std::string::npos) return false;
  *tag = line.substr(0, comma);
  if (*tag != "imu" && *tag != "gps") return false;
  std::string rest = line.substr(comma + 1);
  for (auto& c : rest)
    if (c == ',') c = ' ';
  std::istringstream ss(rest);
  double v;
  while (ss >> v) vals->push_back(v);
  return true;
}

}  // namespace

extern "C" {

void* lp_parse(const char* path, int max_poses) {
  std::ifstream in(path);
  if (!in.good()) return nullptr;
  auto* out = new ParsedLog;
  DeadReckoner dr;
  std::string line;
  const int64_t cap = max_poses > 0 ? max_poses : INT64_MAX;
  while (std::getline(in, line)) {
    // trim
    const auto b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    const auto e = line.find_last_not_of(" \t\r\n");
    line = line.substr(b, e - b + 1);

    std::vector<double> f;
    std::string tag;
    if (split_csv(line, &f, &tag)) {        // CSV alternate (round-1 format)
      if (tag == "imu" && f.size() >= 7) {
        dr.imu(f[0], &f[1]);
        out->imu_rows.insert(out->imu_rows.end(), f.begin(), f.begin() + 7);
      } else if (tag == "gps" && f.size() >= 4) {
        out->gps_rows.insert(out->gps_rows.end(), f.begin(), f.begin() + 4);
        out->guess_q.resize(out->guess_q.size() + 4);
        out->guess_t.resize(out->guess_t.size() + 3);
        dr.take(&out->guess_q[out->guess_q.size() - 4],
                &out->guess_t[out->guess_t.size() - 3]);
      }
      continue;
    }

    std::istringstream ss(line);
    ss >> tag;
    double v;
    while (ss >> v) f.push_back(v);
    if (tag.rfind("ODO", 0) == 0 && f.size() >= 3) {
      dr.odo(f[0], f[1], f[2]);
    } else if (tag.rfind("UTM", 0) == 0 && f.size() >= 4) {
      if (static_cast<int64_t>(out->gps_rows.size()) / 4 < cap) {
        out->gps_rows.insert(out->gps_rows.end(), f.begin(), f.begin() + 4);
        out->guess_q.resize(out->guess_q.size() + 4);
        out->guess_t.resize(out->guess_t.size() + 3);
        dr.take(&out->guess_q[out->guess_q.size() - 4],
                &out->guess_t[out->guess_t.size() - 3]);
      }
    } else if (tag.rfind("IMU", 0) == 0 && f.size() >= 7) {
      dr.imu(f[0], &f[1]);
      out->imu_rows.insert(out->imu_rows.end(), f.begin(), f.begin() + 7);
    } else {
      std::fprintf(stderr, "Unknown symbol <%s>\n", tag.c_str());
    }
  }
  // UTM coordinates are re-based at the first fix (main.cpp:144-149)
  if (out->gps_rows.size() >= 4 &&
      (out->gps_rows[1] != 0 || out->gps_rows[2] != 0 ||
       out->gps_rows[3] != 0)) {
    const double e0 = out->gps_rows[1], n0 = out->gps_rows[2],
                 u0 = out->gps_rows[3];
    for (size_t i = 0; i < out->gps_rows.size(); i += 4) {
      out->gps_rows[i + 1] -= e0;
      out->gps_rows[i + 2] -= n0;
      out->gps_rows[i + 3] -= u0;
    }
  }
  return out;
}

void lp_counts(void* h, int64_t out[2]) {
  auto* p = static_cast<ParsedLog*>(h);
  out[0] = static_cast<int64_t>(p->imu_rows.size()) / 7;
  out[1] = static_cast<int64_t>(p->gps_rows.size()) / 4;
}

void lp_imu(void* h, double* rows) {
  auto* p = static_cast<ParsedLog*>(h);
  std::memcpy(rows, p->imu_rows.data(), p->imu_rows.size() * sizeof(double));
}

void lp_gps(void* h, double* rows) {
  auto* p = static_cast<ParsedLog*>(h);
  std::memcpy(rows, p->gps_rows.data(), p->gps_rows.size() * sizeof(double));
}

void lp_guesses(void* h, double* q, double* t) {
  auto* p = static_cast<ParsedLog*>(h);
  std::memcpy(q, p->guess_q.data(), p->guess_q.size() * sizeof(double));
  std::memcpy(t, p->guess_t.data(), p->guess_t.size() * sizeof(double));
}

void lp_destroy(void* h) { delete static_cast<ParsedLog*>(h); }

}  // extern "C"
