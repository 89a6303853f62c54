// Host greedy NMS of the port: the frame-NMS tool's `host` backend
// (kernels/nms.py::nms_host). A copy of the JAX package's native library,
// the rebuild of the reference's vdetlib/utils/cython_nms.pyx (Fast R-CNN
// NMS, Cython -> C).
//
// Semantics contract (shared with the numpy greedy, kernels/nms.py::
// nms_host_plain): visit boxes by (score desc, original index asc); suppress
// when IoU with any kept box is strictly greater than `thresh`; areas use
// `w = x2 - x1 + offset`.
//
// Built with g++ at first use by kernels/build.py (plain C interface, ctypes).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// dets: n rows of (x1, y1, x2, y2, score), float32, C-contiguous.
// keep_out: caller-allocated buffer of n int32s; returns number kept.
// Kept indices are written in visit order (ranked by score).
int32_t vdet_nms(const float* dets, int32_t n, float thresh, float offset,
                 int32_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });

  std::vector<double> area(n);
  for (int32_t i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    area[i] = (double)(d[2] - d[0] + offset) * (double)(d[3] - d[1] + offset);
  }

  std::vector<uint8_t> suppressed(n, 0);
  int32_t n_keep = 0;
  for (int32_t oi = 0; oi < n; ++oi) {
    const int32_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* di = dets + i * 5;
    for (int32_t oj = oi + 1; oj < n; ++oj) {
      const int32_t j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      const double ix1 = std::max(di[0], dj[0]);
      const double iy1 = std::max(di[1], dj[1]);
      const double ix2 = std::min(di[2], dj[2]);
      const double iy2 = std::min(di[3], dj[3]);
      const double iw = std::max(ix2 - ix1 + offset, 0.0);
      const double ih = std::max(iy2 - iy1 + offset, 0.0);
      const double inter = iw * ih;
      const double uni = area[i] + area[j] - inter;
      const double iou = uni > 0.0 ? inter / uni : 0.0;
      if (iou > thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

}  // extern "C"
