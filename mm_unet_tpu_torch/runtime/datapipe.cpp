// Native host-side data pipeline of the PyTorch port (a copy of
// mm_unet_tpu/runtime/datapipe.cpp; the same batches for the same inputs).
//
// A multithreaded batch-preparation engine doing the per-step host work —
// bilinear/nearest resize, flips, CutMix, colour jitter, blur, random patch
// and resized crop, ImageNet normalisation, label binarisation and NCHW
// batch assembly — on a std::thread pool, exposed to Python via a C ABI
// (ctypes; no pybind11).
//
// All buffers are float32, HWC for images, HW for labels. A deterministic
// per-sample RNG (splitmix64 seeded by (seed, epoch, index)) reproduces the
// same augmentation stream regardless of thread scheduling.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t s) : state(s) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  int64_t randint(int64_t n) { return (int64_t)(uniform() * n); }
};

// Bilinear resize HWC float32, align_corners=false (PIL-like box positions
// use half-pixel centres; close enough to PIL BILINEAR for training data).
void resize_bilinear(const float* src, int sh, int sw, int c, float* dst,
                     int dh, int dw) {
  const float sy = (float)sh / dh;
  const float sx = (float)sw / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(y0 + 1, sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(x0 + 1, sw - 1);
      const float* p00 = src + (y0c * sw + x0c) * c;
      const float* p01 = src + (y0c * sw + x1c) * c;
      const float* p10 = src + (y1c * sw + x0c) * c;
      const float* p11 = src + (y1c * sw + x1c) * c;
      float* out = dst + (y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] * (1 - wx) + p01[k] * wx;
        float bot = p10[k] * (1 - wx) + p11[k] * wx;
        out[k] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

void resize_nearest(const float* src, int sh, int sw, int c, float* dst,
                    int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    int sy = std::min((int)((y + 0.5f) * sh / dh), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int sx = std::min((int)((x + 0.5f) * sw / dw), sw - 1);
      std::memcpy(dst + (y * dw + x) * c, src + (sy * sw + sx) * c,
                  c * sizeof(float));
    }
  }
}

void flip_h(float* buf, int h, int w, int c) {
  std::vector<float> tmp(c);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w / 2; ++x) {
      float* a = buf + (y * w + x) * c;
      float* b = buf + (y * w + (w - 1 - x)) * c;
      std::memcpy(tmp.data(), a, c * sizeof(float));
      std::memcpy(a, b, c * sizeof(float));
      std::memcpy(b, tmp.data(), c * sizeof(float));
    }
}

void flip_v(float* buf, int h, int w, int c) {
  std::vector<float> tmp((size_t)w * c);
  size_t row = (size_t)w * c;
  for (int y = 0; y < h / 2; ++y) {
    float* a = buf + (size_t)y * row;
    float* b = buf + (size_t)(h - 1 - y) * row;
    std::memcpy(tmp.data(), a, row * sizeof(float));
    std::memcpy(a, b, row * sizeof(float));
    std::memcpy(b, tmp.data(), row * sizeof(float));
  }
}

// In-place colour jitter (brightness/contrast/saturation), the numpy
// transforms.py::color_jitter semantics: contrast pivots on the global mean,
// saturation on the per-pixel channel mean; clipped to [0, 1].
void color_jitter(float* img, int h, int w, float b, float c, float s) {
  size_t n = (size_t)h * w;
  double mean = 0.0;
  for (size_t p = 0; p < n * 3; ++p) {
    img[p] *= b;
    mean += img[p];
  }
  mean /= (double)(n * 3);
  for (size_t p = 0; p < n; ++p) {
    float* px = img + p * 3;
    for (int k = 0; k < 3; ++k) px[k] = (px[k] - (float)mean) * c + (float)mean;
    float gray = (px[0] + px[1] + px[2]) / 3.0f;
    for (int k = 0; k < 3; ++k) {
      float v = gray + (px[k] - gray) * s;
      px[k] = std::min(std::max(v, 0.0f), 1.0f);
    }
  }
}

// Separable gaussian blur, reflect boundary (scipy.ndimage.gaussian_filter
// defaults: mode='reflect', truncate=4.0).
void gaussian_blur(float* img, int h, int w, int c, float sigma,
                   std::vector<float>& tmp) {
  int radius = (int)(4.0f * sigma + 0.5f);
  if (radius < 1) radius = 1;
  std::vector<float> k(2 * radius + 1);
  float sum = 0.0f;
  for (int i = -radius; i <= radius; ++i) {
    k[i + radius] = std::exp(-0.5f * i * i / (sigma * sigma));
    sum += k[i + radius];
  }
  for (auto& v : k) v /= sum;
  auto reflect = [](int i, int n) {
    while (i < 0 || i >= n) {
      if (i < 0) i = -i - 1;
      if (i >= n) i = 2 * n - i - 1;
    }
    return i;
  };
  tmp.assign((size_t)h * w * c, 0.0f);
  for (int y = 0; y < h; ++y)  // horizontal
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int i = -radius; i <= radius; ++i)
          acc += k[i + radius] * img[((size_t)y * w + reflect(x + i, w)) * c + ch];
        tmp[((size_t)y * w + x) * c + ch] = acc;
      }
  for (int y = 0; y < h; ++y)  // vertical
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int i = -radius; i <= radius; ++i)
          acc += k[i + radius] * tmp[((size_t)reflect(y + i, h) * w + x) * c + ch];
        img[((size_t)y * w + x) * c + ch] = acc;
      }
}

// Crop (y0, x0, ch, cw) out of (h, w), writing into dst vectors.
void crop(const std::vector<float>& img, const std::vector<float>& lbl, int h,
          int w, int y0, int x0, int ch, int cw, std::vector<float>& oi,
          std::vector<float>& ol) {
  oi.resize((size_t)ch * cw * 3);
  ol.resize((size_t)ch * cw);
  for (int y = 0; y < ch; ++y) {
    std::memcpy(&oi[(size_t)y * cw * 3], &img[((size_t)(y0 + y) * w + x0) * 3],
                (size_t)cw * 3 * sizeof(float));
    std::memcpy(&ol[(size_t)y * cw], &lbl[(size_t)(y0 + y) * w + x0],
                (size_t)cw * sizeof(float));
  }
}

// Zero-pad to at least (th, tw), centred (transforms.py::center_padding).
void center_pad(std::vector<float>& img, std::vector<float>& lbl, int& h,
                int& w, int th, int tw) {
  if (h >= th && w >= tw) return;
  int nh = std::max(h, th), nw = std::max(w, tw);
  int oy = (nh - h) / 2, ox = (nw - w) / 2;
  std::vector<float> ni((size_t)nh * nw * 3, 0.0f), nl((size_t)nh * nw, 0.0f);
  for (int y = 0; y < h; ++y) {
    std::memcpy(&ni[((size_t)(y + oy) * nw + ox) * 3], &img[(size_t)y * w * 3],
                (size_t)w * 3 * sizeof(float));
    std::memcpy(&nl[(size_t)(y + oy) * nw + ox], &lbl[(size_t)y * w],
                (size_t)w * sizeof(float));
  }
  img.swap(ni);
  lbl.swap(nl);
  h = nh;
  w = nw;
}

}  // namespace

extern "C" {

// Prepare one training batch:
//   images[i], labels[i]: pointers to RAM-resident HWC/HW float32 source data
//   hs/ws: per-sample source dims; idxs: dataset indices chosen by the host
//   out_img: (B, 3, S, S) f32; out_lbl: (B, 1, S, S) f32
//   flags: bit0 = train augmentations (flips), bit1 = cutmix,
//          bit2 = color jitter (p=.5), bit3 = gaussian blur (p=.3),
//          bit4 = random resized crop (p=.5)
//   patch: if > 0, random patch crop of this size before the final resize
//          (the loader passes size == patch in that case)
// Deterministic per (seed, epoch, position). Parallel over batch samples.
void mmu_prepare_batch(const float** images, const float** labels,
                       const int* hs, const int* ws, const int64_t* idxs,
                       int batch, int size, const float* mean,
                       const float* std_, uint64_t seed, uint64_t epoch,
                       int flags, int patch, const int64_t* mix_idxs,
                       int n_total, float* out_img, float* out_lbl) {
  int n_threads = std::min((int)std::thread::hardware_concurrency(), batch);
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);

  auto work = [&]() {
    std::vector<float> img_rs((size_t)size * size * 3);
    std::vector<float> lbl_rs((size_t)size * size);
    std::vector<float> img_src, lbl_src, scratch, ci, cl;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) break;
      int64_t id = idxs[i];
      SplitMix64 rng(seed * 0x9E3779B97F4A7C15ull + epoch * 0x2545F4914F6CDD1Dull +
                     (uint64_t)id + (uint64_t)i * 0x100000001B3ull);
      int h = hs[i], w = ws[i];
      img_src.assign(images[i], images[i] + (size_t)h * w * 3);
      lbl_src.assign(labels[i], labels[i] + (size_t)h * w);

      if (flags & 1) {
        bool fh = rng.uniform() < 0.5;
        bool fv = rng.uniform() < 0.5;
        if (fh) { flip_h(img_src.data(), h, w, 3); flip_h(lbl_src.data(), h, w, 1); }
        if (fv) { flip_v(img_src.data(), h, w, 3); flip_v(lbl_src.data(), h, w, 1); }
        if ((flags & 2) && rng.uniform() < 0.5 && mix_idxs) {
          // CutMix with a same-size donor (VesselLoader.py:42-100)
          int64_t j = mix_idxs[i];
          if (j >= 0 && j < n_total) {
            double lam = rng.uniform();
            float cut = std::sqrt(1.0f - (float)lam);
            int ch = (int)(h * cut), cw = (int)(w * cut);
            int cy = (int)rng.randint(h), cx = (int)rng.randint(w);
            int y1 = std::max(cy - ch / 2, 0), y2 = std::min(cy + ch / 2, h);
            int x1 = std::max(cx - cw / 2, 0), x2 = std::min(cx + cw / 2, w);
            // donor pointers come through images[batch + i] convention
            const float* dimg = images[batch + i];
            const float* dlbl = labels[batch + i];
            for (int y = y1; y < y2; ++y) {
              std::memcpy(&img_src[((size_t)y * w + x1) * 3],
                          &dimg[((size_t)y * w + x1) * 3],
                          (size_t)(x2 - x1) * 3 * sizeof(float));
              std::memcpy(&lbl_src[(size_t)y * w + x1],
                          &dlbl[(size_t)y * w + x1],
                          (size_t)(x2 - x1) * sizeof(float));
            }
          }
        }
      }

      if (flags & 1) {
        if ((flags & 4) && rng.uniform() < 0.5) {  // colour jitter
          float b = 1.0f + (float)(rng.uniform() * 0.4 - 0.2);
          float c2 = 1.0f + (float)(rng.uniform() * 0.4 - 0.2);
          float s2 = 1.0f + (float)(rng.uniform() * 0.4 - 0.2);
          color_jitter(img_src.data(), h, w, b, c2, s2);
        }
        if ((flags & 8) && rng.uniform() < 0.3) {  // gaussian blur
          float sigma = 0.1f + (float)(rng.uniform() * 1.9);
          gaussian_blur(img_src.data(), h, w, 3, sigma, scratch);
        }
        if (patch > 0) {  // random patch crop (pad first if needed)
          center_pad(img_src, lbl_src, h, w, patch, patch);
          int y0 = (int)rng.randint(h - patch + 1);
          int x0 = (int)rng.randint(w - patch + 1);
          crop(img_src, lbl_src, h, w, y0, x0, patch, patch, ci, cl);
          img_src.swap(ci);
          lbl_src.swap(cl);
          h = w = patch;
        }
        if ((flags & 16) && rng.uniform() < 0.5) {  // random resized crop
          double area = (double)h * w * (0.5 + rng.uniform() * 0.5);
          double ratio = 0.75 + rng.uniform() * (1.333 - 0.75);
          int ch = std::min((int)std::lround(std::sqrt(area / ratio)), h);
          int cw = std::min((int)std::lround(std::sqrt(area * ratio)), w);
          int y0 = (int)rng.randint(h - ch + 1);
          int x0 = (int)rng.randint(w - cw + 1);
          crop(img_src, lbl_src, h, w, y0, x0, ch, cw, ci, cl);
          img_src.swap(ci);
          lbl_src.swap(cl);
          h = ch;
          w = cw;
        }
      }

      resize_bilinear(img_src.data(), h, w, 3, img_rs.data(), size, size);
      resize_nearest(lbl_src.data(), h, w, 1, lbl_rs.data(), size, size);

      // normalise + NCHW scatter
      float* oi = out_img + (size_t)i * 3 * size * size;
      for (int k = 0; k < 3; ++k) {
        float m = mean[k], s = std_[k];
        float* plane = oi + (size_t)k * size * size;
        for (int p = 0; p < size * size; ++p)
          plane[p] = (img_rs[(size_t)p * 3 + k] - m) / s;
      }
      float* ol = out_lbl + (size_t)i * size * size;
      for (int p = 0; p < size * size; ++p) ol[p] = lbl_rs[p] > 0.5f ? 1.0f : 0.0f;
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
}

// Standalone primitives (tested against the numpy implementations).
void mmu_resize_bilinear(const float* src, int sh, int sw, int c, float* dst,
                         int dh, int dw) {
  resize_bilinear(src, sh, sw, c, dst, dh, dw);
}

void mmu_resize_nearest(const float* src, int sh, int sw, int c, float* dst,
                        int dh, int dw) {
  resize_nearest(src, sh, sw, c, dst, dh, dw);
}

int mmu_version() { return 2; }

}  // extern "C"
