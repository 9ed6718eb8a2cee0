// Native multi-threaded image preprocessing for the data pipeline.
//
// The port's copy of csrc/dataloader.cpp without its space-to-depth
// output: every view is written as [dst_h, dst_w, 3] float32, with the
// same arithmetic, so the two pools give equal values.
//
// The reference pipeline leans on mmcv/cv2/PIL C++ ops for per-view resize /
// crop / flip / pad / normalize (ref: mmdet3d_plugin/datasets/pipelines/
// transform_3d.py:456-676, loading.py).  This provides the equivalent hot
// loop as a standalone C++ kernel with a thread worker pool, invoked via
// ctypes (see mv2d_tpu_torch/data/pipeline.py): one call preprocesses all
// camera views of a sample in parallel.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ViewTask {
  const uint8_t* src;  // [src_h, src_w, 3]
  int src_h, src_w;
  float* dst;          // [dst_h, dst_w, 3] float32, normalized
  int dst_h, dst_w;
  // affine mapping dst pixel -> src pixel: sx = a*x + b, sy = c*y + d
  // (captures resize + crop); flip applied after resize+crop if flip != 0.
  float a, b, c, d;
  int flip;
  const float* mean;   // [3]
  const float* stdinv; // [3]
};

void process_view(const ViewTask& t) {
  for (int y = 0; y < t.dst_h; ++y) {
    float sy = t.c * static_cast<float>(y) + t.d;
    sy = sy < 0 ? 0 : sy;
    float maxy = static_cast<float>(t.src_h - 1);
    sy = sy > maxy ? maxy : sy;
    int y0 = static_cast<int>(sy);
    int y1 = y0 + 1 < t.src_h ? y0 + 1 : y0;
    float fy = sy - static_cast<float>(y0);
    float* drow = t.dst + static_cast<size_t>(y) * t.dst_w * 3;
    for (int x = 0; x < t.dst_w; ++x) {
      int xd = t.flip ? (t.dst_w - 1 - x) : x;
      float sx = t.a * static_cast<float>(x) + t.b;
      sx = sx < 0 ? 0 : sx;
      float maxx = static_cast<float>(t.src_w - 1);
      sx = sx > maxx ? maxx : sx;
      int x0 = static_cast<int>(sx);
      int x1 = x0 + 1 < t.src_w ? x0 + 1 : x0;
      float fx = sx - static_cast<float>(x0);
      const uint8_t* p00 = t.src + (static_cast<size_t>(y0) * t.src_w + x0) * 3;
      const uint8_t* p01 = t.src + (static_cast<size_t>(y0) * t.src_w + x1) * 3;
      const uint8_t* p10 = t.src + (static_cast<size_t>(y1) * t.src_w + x0) * 3;
      const uint8_t* p11 = t.src + (static_cast<size_t>(y1) * t.src_w + x1) * 3;
      float* dpx = drow + static_cast<size_t>(xd) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        float v0 = static_cast<float>(p00[ch]) * (1 - fx) + static_cast<float>(p01[ch]) * fx;
        float v1 = static_cast<float>(p10[ch]) * (1 - fx) + static_cast<float>(p11[ch]) * fx;
        float v = v0 * (1 - fy) + v1 * fy;
        dpx[ch] = (v - t.mean[ch]) * t.stdinv[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// Preprocess n_views images in parallel.
// srcs: array of n pointers to uint8 HWC images; src_hw: [n, 2];
// dst: [n, dst_h, dst_w, 3] float32 output; affine: [n, 4] (a, b, c, d);
// flips: [n]; mean/stdinv: [3].
void preprocess_views(int n_views, const uint8_t** srcs, const int* src_hw,
                      float* dst, int dst_h, int dst_w, const float* affine,
                      const int* flips, const float* mean,
                      const float* stdinv, int num_threads) {
  std::vector<ViewTask> tasks(n_views);
  for (int i = 0; i < n_views; ++i) {
    tasks[i] = ViewTask{srcs[i],
                        src_hw[i * 2],
                        src_hw[i * 2 + 1],
                        dst + static_cast<size_t>(i) * dst_h * dst_w * 3,
                        dst_h,
                        dst_w,
                        affine[i * 4],
                        affine[i * 4 + 1],
                        affine[i * 4 + 2],
                        affine[i * 4 + 3],
                        flips[i],
                        mean,
                        stdinv};
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_views) break;
      process_view(tasks[i]);
    }
  };
  int nt = num_threads > 0 ? num_threads : 4;
  nt = nt > n_views ? n_views : nt;
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}
}
