// Host-side helpers of mnc_tpu_torch (the port's own copy of the JAX
// package's mnc_native.cpp, the same algorithms), ≙ the reference's Cython
// host code (lib/nms/cpu_nms.pyx, lib/utils/cython_bbox.pyx, lib/nms/mv.pyx):
// box IoUs, greedy NMS, mask IoUs by 64-bit popcount (the mAP^r evaluator),
// COCO-style run-length encoding (serve's JSON masks) and host mask voting.
// Built by mnc_tpu_torch/native.py with g++ -O3 -march=native at first use
// and bound with ctypes; numpy twins of every function stay there.
//
// All functions use a plain C ABI over contiguous row-major buffers.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// Pairwise box IoU with the Caffe +1 width convention.
// boxes: (n,4) f32, query: (k,4) f32, out: (n,k) f32.
void bbox_overlaps(const float* boxes, int n, const float* query, int k,
                   float* out) {
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    const float area_b = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
    for (int j = 0; j < k; ++j) {
      const float* q = query + 4 * j;
      const float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.f;
      const float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.f;
      float v = 0.f;
      if (iw > 0.f && ih > 0.f) {
        const float area_q = (q[2] - q[0] + 1.f) * (q[3] - q[1] + 1.f);
        const float inter = iw * ih;
        v = inter / (area_b + area_q - inter);
      }
      out[i * k + j] = v;
    }
  }
}

// Greedy NMS over boxes sorted by descending score.
// boxes: (n,4) f32 sorted; keep: (n,) u8 out.  Returns number kept.
int cpu_nms(const float* boxes, int n, float thresh, uint8_t* keep) {
  int kept = 0;
  for (int i = 0; i < n; ++i) keep[i] = 1;
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    ++kept;
    const float* b = boxes + 4 * i;
    const float area_b = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      const float* q = boxes + 4 * j;
      const float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.f;
      const float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.f;
      if (iw > 0.f && ih > 0.f) {
        const float area_q = (q[2] - q[0] + 1.f) * (q[3] - q[1] + 1.f);
        const float inter = iw * ih;
        if (inter / (area_b + area_q - inter) > thresh) keep[j] = 0;
      }
    }
  }
  return kept;
}

// Mask IoU matrix between two stacks of binary masks on the same canvas.
// a: (n,h*w) u8, b: (m,h*w) u8, out: (n,m) f32.  64-bit popcount inner loop.
void mask_iou_matrix(const uint8_t* a, int n, const uint8_t* b, int m,
                     int hw, float* out) {
  // pack rows to 64-bit words once
  const int words = (hw + 63) / 64;
  uint64_t* pa = new uint64_t[(size_t)n * words]();
  uint64_t* pb = new uint64_t[(size_t)m * words]();
  auto pack = [&](const uint8_t* src, uint64_t* dst, int rows) {
    for (int r = 0; r < rows; ++r) {
      const uint8_t* s = src + (size_t)r * hw;
      uint64_t* d = dst + (size_t)r * words;
      for (int i = 0; i < hw; ++i)
        if (s[i]) d[i >> 6] |= (uint64_t)1 << (i & 63);
    }
  };
  pack(a, pa, n);
  pack(b, pb, m);
  int* ca = new int[n];
  int* cb = new int[m];
  for (int i = 0; i < n; ++i) {
    int c = 0;
    for (int w = 0; w < words; ++w) c += __builtin_popcountll(pa[(size_t)i * words + w]);
    ca[i] = c;
  }
  for (int j = 0; j < m; ++j) {
    int c = 0;
    for (int w = 0; w < words; ++w) c += __builtin_popcountll(pb[(size_t)j * words + w]);
    cb[j] = c;
  }
  for (int i = 0; i < n; ++i) {
    const uint64_t* ra = pa + (size_t)i * words;
    for (int j = 0; j < m; ++j) {
      const uint64_t* rb = pb + (size_t)j * words;
      int inter = 0;
      for (int w = 0; w < words; ++w)
        inter += __builtin_popcountll(ra[w] & rb[w]);
      const int uni = ca[i] + cb[j] - inter;
      out[(size_t)i * m + j] = uni > 0 ? (float)inter / (float)uni : 0.f;
    }
  }
  delete[] pa;
  delete[] pb;
  delete[] ca;
  delete[] cb;
}

// COCO-style run-length encoding of a binary mask (column-major like
// pycocotools).  counts out buffer must hold >= h*w+1 ints.  Returns count.
int rle_encode(const uint8_t* mask, int h, int w, int32_t* counts) {
  int n = 0;
  uint8_t prev = 0;
  int32_t run = 0;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      const uint8_t v = mask[(size_t)y * w + x] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        counts[n++] = run;
        run = 1;
        prev = v;
      }
    }
  }
  counts[n++] = run;
  return n;
}

// Inverse of rle_encode.
void rle_decode(const int32_t* counts, int n, int h, int w, uint8_t* mask) {
  uint8_t v = 0;
  size_t pos = 0;
  const size_t total = (size_t)h * w;
  for (int i = 0; i < n && pos < total; ++i) {
    for (int32_t r = 0; r < counts[i] && pos < total; ++r, ++pos) {
      const size_t x = pos / h, y = pos % h;
      mask[y * w + x] = v;
    }
    v = 1 - v;
  }
}

// Mask voting on the host (oracle / reference-parity check for the on-device
// version): for each kept box, average candidate masks (IoU>=thresh) from
// their own box frames into the kept frame, weighted by score.
// kept: (nk,4), cand: (nc,4), scores: (nc,), masks: (nc, ms, ms) f32.
// out: (nk, ms, ms) f32.
void mask_voting_cpu(const float* kept, int nk, const float* cand, int nc,
                     const float* scores, const float* masks, int ms,
                     float iou_thresh, float* out) {
  float* iou = new float[(size_t)nk * nc];
  bbox_overlaps(kept, nk, cand, nc, iou);
  for (int i = 0; i < nk; ++i) {
    const float* kb = kept + 4 * i;
    float* om = out + (size_t)i * ms * ms;
    std::memset(om, 0, sizeof(float) * ms * ms);
    float wsum = 0.f;
    for (int j = 0; j < nc; ++j) {
      if (iou[(size_t)i * nc + j] < iou_thresh || scores[j] <= 0.f) continue;
      const float* cb = cand + 4 * j;
      const float* cm = masks + (size_t)j * ms * ms;
      const float sw = scores[j];
      wsum += sw;
      const float kw = kb[2] - kb[0] + 1.f, kh = kb[3] - kb[1] + 1.f;
      const float cw = std::max(cb[2] - cb[0] + 1.f, 1.f);
      const float ch = std::max(cb[3] - cb[1] + 1.f, 1.f);
      for (int p = 0; p < ms; ++p) {
        const float imy = kb[1] + (p + 0.5f) / ms * kh;
        const float sy = (imy - cb[1]) / ch * ms - 0.5f;
        for (int q = 0; q < ms; ++q) {
          const float imx = kb[0] + (q + 0.5f) / ms * kw;
          const float sx = (imx - cb[0]) / cw * ms - 0.5f;
          // bilinear sample cm at (sy, sx), zero outside
          float acc = 0.f;
          const int y0 = (int)std::floor(sy), x0 = (int)std::floor(sx);
          for (int dy = 0; dy <= 1; ++dy)
            for (int dx = 0; dx <= 1; ++dx) {
              const int yy = y0 + dy, xx = x0 + dx;
              if (yy < 0 || yy >= ms || xx < 0 || xx >= ms) continue;
              const float wgt = (1.f - std::fabs(sy - yy)) * (1.f - std::fabs(sx - xx));
              acc += wgt * cm[yy * ms + xx];
            }
          om[p * ms + q] += sw * acc;
        }
      }
    }
    if (wsum > 0.f)
      for (int t = 0; t < ms * ms; ++t) om[t] /= wsum;
  }
  delete[] iou;
}

}  // extern "C"
