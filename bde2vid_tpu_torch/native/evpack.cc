// Host-side event kernels of the port: window packing and a CPU voxelizer
// (counterpart of bde2vid_tpu/native/evpack.cc, same code).
//
// pack_windows turns windows of one contiguous event stream into the padded
// (n_windows, capacity) buffers the device voxelizer consumes, in compact
// types (int16 coordinates, int8 polarity in {-1, 0, +1}, f32 timestamps
// rebased per window in f64): 9 bytes an event to copy to the card, which
// widens them there. Exposed through a plain C interface for ctypes.
//
// Semantics are those of bde2vid_tpu_torch/events/voxel.py and of the
// pipeline's per-window path: timestamps shifted to the window's first
// event; 0/1 polarities map to -1/+1; padding rows carry the last timestamp,
// coordinates 0 and polarity 0; temporal-bilinear voxel weights are
// max(0, 1 - |t_norm - b|).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Pack [n_windows] event windows from one contiguous event stream into
// padded batch buffers of shape (n_windows, capacity).
// xs/ys: int16, ts: float64 (absolute), ps: uint8 (0/1 polarity).
// windows: int64 (n_windows, 2) [start, end) indices into the stream.
// Outputs keep the compact types (int16 coords, int8 {-1,0,+1} polarity,
// f32 shifted timestamps); the device voxelizer widens them.
// Returns 0 on success, -1 if any window exceeds capacity.
int pack_windows(const int16_t* xs, const int16_t* ys, const double* ts,
                 const uint8_t* ps, const int64_t* windows, int64_t n_windows,
                 int64_t capacity, int16_t* out_xs, int16_t* out_ys,
                 float* out_ts, int8_t* out_ps, int32_t* out_n) {
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t i0 = windows[2 * w];
    const int64_t i1 = windows[2 * w + 1];
    const int64_t n = i1 - i0;
    if (n > capacity || n < 0) return -1;
    int16_t* oxs = out_xs + w * capacity;
    int16_t* oys = out_ys + w * capacity;
    float* ots = out_ts + w * capacity;
    int8_t* ops = out_ps + w * capacity;
    const double t0 = n > 0 ? ts[i0] : 0.0;
    for (int64_t i = 0; i < n; ++i) {
      oxs[i] = xs[i0 + i];
      oys[i] = ys[i0 + i];
      ots[i] = static_cast<float>(ts[i0 + i] - t0);
      ops[i] = ps[i0 + i] ? 1 : -1;
    }
    const float t_fill = n > 0 ? ots[n - 1] : 0.0f;
    for (int64_t i = n; i < capacity; ++i) {
      oxs[i] = 0;
      oys[i] = 0;
      ots[i] = t_fill;
      ops[i] = 0;
    }
    out_n[w] = static_cast<int32_t>(n);
  }
  return 0;
}

// Temporal-bilinear voxelization of one event window (already packed,
// int16/int8/float32) into a (num_bins, H, W) grid. Matches
// events_to_voxel (voxel.py) / the reference events_to_voxel_torch.
void voxelize(const int16_t* xs, const int16_t* ys, const float* ts,
              const int8_t* ps, int64_t n, int64_t num_bins, int64_t height,
              int64_t width, float* out /* zeroed (B, H, W) */) {
  if (n <= 0) return;
  const float t0 = ts[0];
  const float dt = ts[n - 1] - t0;
  const float inv = dt > 0.0f ? (num_bins - 1) / dt : 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const int16_t x = xs[i];
    const int16_t y = ys[i];
    if (x < 0 || x >= width || y < 0 || y >= height) continue;
    const float t_norm = (ts[i] - t0) * inv;
    const float p = static_cast<float>(ps[i]);
    const int64_t b0 = static_cast<int64_t>(t_norm);
    // at most two bins get weight from the tent kernel
    for (int64_t b = std::max<int64_t>(0, b0);
         b <= std::min<int64_t>(num_bins - 1, b0 + 1); ++b) {
      const float wgt = std::max(0.0f, 1.0f - std::fabs(t_norm - (float)b));
      if (wgt > 0.0f) out[(b * height + y) * width + x] += p * wgt;
    }
  }
}

// Batch voxelization: (n_windows, capacity) packed buffers ->
// (n_windows, B, H, W).
void voxelize_batch(const int16_t* xs, const int16_t* ys, const float* ts,
                    const int8_t* ps, const int32_t* ns, int64_t n_windows,
                    int64_t capacity, int64_t num_bins, int64_t height,
                    int64_t width, float* out) {
  const int64_t plane = num_bins * height * width;
  std::memset(out, 0, sizeof(float) * n_windows * plane);
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t n = ns[w];
    if (n < 3) continue;  // reference: <3 events -> zero voxel
    voxelize(xs + w * capacity, ys + w * capacity, ts + w * capacity,
             ps + w * capacity, n, num_bins, height, width, out + w * plane);
  }
}

}  // extern "C"
