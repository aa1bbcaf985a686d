// Time-indexed measurement buffer with linear interpolation.
//
// Native reimplementation of the reference's InterpolationBufferT (arpg/ba,
// include/ba/InterpolationBuffer.h:64-214): AddElement with monotonic time
// append, GetElement with O(1) guessed lookup (index ~ (t - t0) / avg_dt)
// refined by local search, endpoint linear interpolation, and GetRange
// extraction with interpolated boundary samples.
//
// The element payload is a fixed-width double vector (e.g. 6 for IMU w+a),
// so one buffer class serves gyro/accel/pose streams alike.  Exposed through
// a C API consumed via ctypes (ba_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Buffer {
  int dim;
  double avg_dt;                 // running average sample interval
  std::vector<double> times;     // sorted (monotonic append enforced)
  std::vector<double> values;    // times.size() * dim
};

// O(1) guessed start index, then local search — the reference's
// average-rate guess (InterpolationBuffer.h:134-181).
int GuessIndex(const Buffer& b, double t) {
  const int n = static_cast<int>(b.times.size());
  if (n == 0) return 0;
  int idx = 0;
  if (b.avg_dt > 0) {
    idx = static_cast<int>((t - b.times.front()) / b.avg_dt);
    idx = std::max(0, std::min(n - 1, idx));
  }
  while (idx > 0 && b.times[idx] > t) --idx;
  while (idx < n - 1 && b.times[idx + 1] <= t) ++idx;
  return idx;
}

void Interpolate(const Buffer& b, double t, double* out) {
  const int n = static_cast<int>(b.times.size());
  if (n == 0) {
    std::memset(out, 0, sizeof(double) * b.dim);
    return;
  }
  if (t <= b.times.front()) {
    std::memcpy(out, b.values.data(), sizeof(double) * b.dim);
    return;
  }
  if (t >= b.times.back()) {
    std::memcpy(out, b.values.data() + (n - 1) * b.dim,
                sizeof(double) * b.dim);
    return;
  }
  const int i = GuessIndex(b, t);
  const double t0 = b.times[i], t1 = b.times[i + 1];
  const double a = (t1 > t0) ? (t - t0) / (t1 - t0) : 0.0;
  const double* v0 = b.values.data() + i * b.dim;
  const double* v1 = b.values.data() + (i + 1) * b.dim;
  for (int k = 0; k < b.dim; ++k) out[k] = (1.0 - a) * v0[k] + a * v1[k];
}

}  // namespace

extern "C" {

void* ib_create(int dim) {
  Buffer* b = new Buffer();
  b->dim = dim;
  b->avg_dt = 0.0;
  return b;
}

void ib_destroy(void* h) { delete static_cast<Buffer*>(h); }

int ib_size(void* h) {
  return static_cast<int>(static_cast<Buffer*>(h)->times.size());
}

// Returns 0 on success, -1 if time is not monotonically increasing (the
// element is inserted in sorted position in that case, like the reference's
// out-of-order tolerance).
int ib_add(void* h, double t, const double* value) {
  Buffer* b = static_cast<Buffer*>(h);
  const int n = static_cast<int>(b->times.size());
  if (n > 0) {
    const double dt = t - b->times.back();
    if (dt <= 0) {
      // out-of-order insert (rare path)
      auto it = std::lower_bound(b->times.begin(), b->times.end(), t);
      const int pos = static_cast<int>(it - b->times.begin());
      b->times.insert(it, t);
      b->values.insert(b->values.begin() + pos * b->dim, value,
                       value + b->dim);
      return -1;
    }
    b->avg_dt = (b->avg_dt * (n - 1) + dt) / n;
  }
  b->times.push_back(t);
  b->values.insert(b->values.end(), value, value + b->dim);
  return 0;
}

int ib_has(void* h, double t) {
  Buffer* b = static_cast<Buffer*>(h);
  return !b->times.empty() && t >= b->times.front() && t <= b->times.back();
}

void ib_get(void* h, double t, double* out) {
  Interpolate(*static_cast<Buffer*>(h), t, out);
}

// Number of samples GetRange would produce for (t_start, t_end), including
// the two interpolated boundary samples.
int ib_range_size(void* h, double t_start, double t_end) {
  Buffer* b = static_cast<Buffer*>(h);
  int count = 2;
  for (double t : b->times) {
    if (t > t_start && t < t_end) ++count;
  }
  return count;
}

// Fills times_out (n) and values_out (n*dim); n from ib_range_size.
void ib_get_range(void* h, double t_start, double t_end, double* times_out,
                  double* values_out) {
  Buffer* b = static_cast<Buffer*>(h);
  int k = 0;
  times_out[k] = t_start;
  Interpolate(*b, t_start, values_out);
  ++k;
  for (size_t i = 0; i < b->times.size(); ++i) {
    const double t = b->times[i];
    if (t > t_start && t < t_end) {
      times_out[k] = t;
      std::memcpy(values_out + k * b->dim, b->values.data() + i * b->dim,
                  sizeof(double) * b->dim);
      ++k;
    }
  }
  times_out[k] = t_end;
  Interpolate(*b, t_end, values_out + k * b->dim);
}

}  // extern "C"
