// Native host-side preprocessing for the raw tactile data path.
//
// The dataset-build stage (raw blob -> contact extraction + depth
// binarization + resize) is the framework's host-CPU hot path; these
// routines implement it in C++ with the exact semantics of the numpy
// versions in tactilesr_torch/data/raw_process.py (which reproduce the
// reference's utility/raw_data_process.py).  This is the port's own copy of
// tactilesr_tpu/native/preprocess.cpp:
//
//  - resize_bilinear: torch align_corners=False half-pixel convention,
//  - binarize_depth: two sequential midpoint thresholds (second computed on
//    the already-modified array) + resize,
//  - extract_contact_seqs: peak-force scan (strict >), pre-peak threshold
//    keep, vertical flip of each 4x4 map, uniform linspace subsample.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).
// Build: tactilesr_torch/native/__init__.py (g++ -O3 -shared -fPIC into
// tactilesr_torch/native/_build/).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// dst[hd x wd] <- bilinear resample of src[hs x ws], half-pixel centers,
// two taps per axis, clamped at the borders (torch align_corners=False).
void tsr_resize_bilinear(const float* src, int hs, int ws, float* dst,
                         int hd, int wd) {
  std::vector<int> x0(wd), x1(wd);
  std::vector<float> wx1(wd);
  const double sx = static_cast<double>(ws) / wd;
  for (int j = 0; j < wd; ++j) {
    double s = (j + 0.5) * sx - 0.5;
    if (s < 0) s = 0;
    int i0 = static_cast<int>(s);
    if (i0 > ws - 1) i0 = ws - 1;
    int i1 = i0 + 1 < ws ? i0 + 1 : ws - 1;
    x0[j] = i0;
    x1[j] = i1;
    wx1[j] = static_cast<float>(s - i0);
  }
  const double sy = static_cast<double>(hs) / hd;
  for (int i = 0; i < hd; ++i) {
    double s = (i + 0.5) * sy - 0.5;
    if (s < 0) s = 0;
    int y0 = static_cast<int>(s);
    if (y0 > hs - 1) y0 = hs - 1;
    int y1 = y0 + 1 < hs ? y0 + 1 : hs - 1;
    const float wy1 = static_cast<float>(s - y0);
    const float wy0 = 1.0f - wy1;
    const float* r0 = src + static_cast<size_t>(y0) * ws;
    const float* r1 = src + static_cast<size_t>(y1) * ws;
    float* out = dst + static_cast<size_t>(i) * wd;
    for (int j = 0; j < wd; ++j) {
      const float top = r0[x0[j]] * (1.0f - wx1[j]) + r0[x1[j]] * wx1[j];
      const float bot = r1[x0[j]] * (1.0f - wx1[j]) + r1[x1[j]] * wx1[j];
      out[j] = wy0 * top + wy1 * bot;
    }
  }
}

// out[out_px x out_px] <- two-pass midpoint binarization of depth[h x w],
// then bilinear resize.
void tsr_binarize_depth(const float* depth, int h, int w, int out_px,
                        float* out) {
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<float> buf(depth, depth + n);

  float mn = buf[0], mx = buf[0];
  for (size_t k = 1; k < n; ++k) {
    if (buf[k] < mn) mn = buf[k];
    if (buf[k] > mx) mx = buf[k];
  }
  const float t1 = mn * 0.5f + mx * 0.5f;
  for (size_t k = 0; k < n; ++k)
    if (buf[k] > t1) buf[k] = 1.0f;

  mn = buf[0];
  mx = buf[0];
  for (size_t k = 1; k < n; ++k) {
    if (buf[k] < mn) mn = buf[k];
    if (buf[k] > mx) mx = buf[k];
  }
  const float t2 = mn * 0.5f + mx * 0.5f;
  for (size_t k = 0; k < n; ++k)
    if (!(buf[k] > t2)) buf[k] = 0.0f;

  if (h == out_px && w == out_px) {
    std::memcpy(out, buf.data(), n * sizeof(float));
  } else {
    tsr_resize_bilinear(buf.data(), h, w, out, out_px, out_px);
  }
}

// lrs: (seqs, 48) row-major taxel frames.  Writes up to seqs (3,4,4) maps
// into out (row-major, vertically flipped, [x,y,z] channel order) and
// returns the number written.  Semantics: find peak z-sum frame with a
// strict-> scan; keep frames BEFORE the peak whose z-sum exceeds
// threshold_scale * peak; uniformly subsample to sample_count (linspace,
// int16 truncation as in the numpy reference).
int tsr_extract_contact_seqs(const float* lrs, int seqs,
                             float threshold_scale, int sample_count,
                             float* out) {
  std::vector<float> zsum(seqs);
  for (int t = 0; t < seqs; ++t) {
    const float* f = lrs + static_cast<size_t>(t) * 48;
    float s = 0.0f;
    for (int k = 0; k < 16; ++k) s += f[k * 3 + 2];
    zsum[t] = s;
  }
  float peak = 0.0f;
  int peak_idx = 0;
  for (int t = 0; t < seqs; ++t) {
    if (zsum[t] > peak) {
      peak = zsum[t];
      peak_idx = t;
    }
  }

  std::vector<int> keep;
  keep.reserve(peak_idx);
  for (int t = 0; t < peak_idx; ++t)
    if (zsum[t] > peak * threshold_scale) keep.push_back(t);

  std::vector<int> pick;
  const int kept = static_cast<int>(keep.size());
  if (sample_count > 0 && kept > 0) {
    const int n = sample_count < kept ? sample_count : kept;
    pick.reserve(n);
    for (int s = 0; s < n; ++s) {
      // np.linspace(0, kept-1, n).astype(int16)
      const double v = (n == 1) ? 0.0
                                : static_cast<double>(s) * (kept - 1) / (n - 1);
      pick.push_back(static_cast<int16_t>(v));
    }
  } else {
    pick = keep.empty() ? std::vector<int>{}
                        : std::vector<int>(kept);
    for (int s = 0; s < kept; ++s) pick[s] = s;
  }

  int written = 0;
  for (int p : pick) {
    const float* f = lrs + static_cast<size_t>(keep[p]) * 48;
    float* dst = out + static_cast<size_t>(written) * 48;  // (3,4,4)
    for (int c = 0; c < 3; ++c) {
      for (int r = 0; r < 4; ++r) {
        const int flipped = 3 - r;  // np.flip(axis=0)
        for (int col = 0; col < 4; ++col) {
          const int taxel = flipped * 4 + col;
          dst[c * 16 + r * 4 + col] = f[taxel * 3 + c];
        }
      }
    }
    ++written;
  }
  return written;
}

}  // extern "C"
