// si_host: native host-side runtime components of the PyTorch/CUDA port.
//
// The port's copy of the JAX package's host library (its functions but
// crc32, which no caller needs; the same arithmetic), built from this file by simpleinfer_tpu_torch/host.py
// with g++ into simpleinfer_tpu_torch/_build/. The device path is
// PyTorch and the kernels of csrc/*.cu; these are the HOST-side hot
// paths, native as the reference's runtime is C++ end to end:
//
// - store-zip reading: the .pnnx.bin weight archive parser
//   (pnnx src/pnnx/storezip.cpp — local-file-header walk, store-only
//   entries): the index of ir/storezip.py's reader for large archives.
// - letterbox preprocessing: resize-with-aspect + pad + BGR->RGB + /255
//   normalize (the reference's test_yolo.cpp:193-259, where it runs per
//   image on the host before every forward), as one fused bilinear pass
//   writing f32 NHWC.
// - greedy NMS over xyxy boxes.
//
// Exposed as a C ABI for ctypes (no PyTorch headers: a build takes
// about a second).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ------------------------------------------------------------- storezip
// Walk local file headers of a store-only zip held in memory; for each
// entry record name offset/length and data offset/size. Mirrors
// StoreZipReader::open (storezip.cpp) including data-descriptor-free
// store entries only.
struct SzEntry {
  uint64_t name_off, name_len, data_off, data_size;
};

static bool sz_parse(const uint8_t* buf, uint64_t n,
                     std::vector<SzEntry>* out) {
  uint64_t p = 0;
  auto rd16 = [&](uint64_t off) {
    uint16_t v;
    std::memcpy(&v, buf + off, 2);
    return v;
  };
  auto rd32 = [&](uint64_t off) {
    uint32_t v;
    std::memcpy(&v, buf + off, 4);
    return v;
  };
  while (p + 30 <= n) {
    uint32_t sig = rd32(p);
    if (sig != 0x04034b50u) break;  // central directory reached
    uint16_t flags = rd16(p + 6);
    uint16_t method = rd16(p + 8);
    uint32_t csize = rd32(p + 18);
    uint16_t nlen = rd16(p + 26);
    uint16_t xlen = rd16(p + 28);
    if (method != 0) return false;  // store-only
    // data-descriptor entries (bit 3: sizes live AFTER the data) and
    // zip64 sizes are handled by the Python walker — bail so the
    // caller falls back instead of recording a wrong data_size
    if ((flags & 0x8) != 0 || csize == 0xFFFFFFFFu) return false;
    SzEntry e;
    e.name_off = p + 30;
    e.name_len = nlen;
    e.data_off = p + 30 + nlen + xlen;
    e.data_size = csize;
    if (e.data_off + e.data_size > n) return false;
    out->push_back(e);
    p = e.data_off + e.data_size;
  }
  return !out->empty();
}

// Returns the number of entries (or -1); fills parallel arrays up to cap.
int64_t si_storezip_index(const uint8_t* buf, uint64_t n, uint64_t* name_off,
                          uint64_t* name_len, uint64_t* data_off,
                          uint64_t* data_size, int64_t cap) {
  std::vector<SzEntry> es;
  if (!sz_parse(buf, n, &es)) return -1;
  int64_t m = static_cast<int64_t>(es.size());
  for (int64_t i = 0; i < m && i < cap; i++) {
    name_off[i] = es[i].name_off;
    name_len[i] = es[i].name_len;
    data_off[i] = es[i].data_off;
    data_size[i] = es[i].data_size;
  }
  return m;
}

// ------------------------------------------------------- letterbox prep
// src: HWC uint8 (BGR when bgr_to_rgb). dst: [size,size,3] f32 NHWC row.
// One fused pass: bilinear resize to (nh,nw), channel swap, pad fill,
// 1/255 scale. align_corners=false sampling (cv::resize INTER_LINEAR).
void si_letterbox_u8(const uint8_t* src, int64_t h, int64_t w, float* dst,
                     int64_t size, float pad_value, int bgr_to_rgb,
                     int normalize) {
  double scale = static_cast<double>(size) / (h > w ? h : w);
  int64_t nh = static_cast<int64_t>(h * scale + 0.5);
  int64_t nw = static_cast<int64_t>(w * scale + 0.5);
  if (nh > size) nh = size;
  if (nw > size) nw = size;
  int64_t top = (size - nh) / 2, left = (size - nw) / 2;
  float norm = normalize ? (1.0f / 255.0f) : 1.0f;
  float fill = pad_value * norm;
  for (int64_t i = 0; i < size * size * 3; i++) dst[i] = fill;

  std::vector<int64_t> x0v(nw), x1v(nw);
  std::vector<float> wxv(nw);
  for (int64_t x = 0; x < nw; x++) {
    double sx = (x + 0.5) * static_cast<double>(w) / nw - 0.5;
    int64_t x0 = static_cast<int64_t>(sx >= 0 ? sx : -1);
    double fx = sx - x0;
    if (x0 < 0) { x0 = 0; fx = 0.0; }
    int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
    x0v[x] = x0; x1v[x] = x1; wxv[x] = static_cast<float>(fx);
  }
  for (int64_t y = 0; y < nh; y++) {
    double sy = (y + 0.5) * static_cast<double>(h) / nh - 0.5;
    int64_t y0 = static_cast<int64_t>(sy >= 0 ? sy : -1);
    double fy = sy - y0;
    if (y0 < 0) { y0 = 0; fy = 0.0; }
    int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = static_cast<float>(fy);
    const uint8_t* r0 = src + y0 * w * 3;
    const uint8_t* r1 = src + y1 * w * 3;
    float* out = dst + ((top + y) * size + left) * 3;
    for (int64_t x = 0; x < nw; x++) {
      const uint8_t* a = r0 + x0v[x] * 3;
      const uint8_t* b = r0 + x1v[x] * 3;
      const uint8_t* c = r1 + x0v[x] * 3;
      const uint8_t* d = r1 + x1v[x] * 3;
      float wx = wxv[x];
      for (int ch = 0; ch < 3; ch++) {
        int oc = bgr_to_rgb ? 2 - ch : ch;
        float v = (a[ch] * (1 - wy) * (1 - wx) + b[ch] * (1 - wy) * wx +
                   c[ch] * wy * (1 - wx) + d[ch] * wy * wx);
        out[x * 3 + oc] = v * norm;
      }
    }
  }
}

// batch variant: images may have different shapes; srcs[i] points at
// image i's HWC u8 bytes (no packing copy). dst is [n, size, size, 3] f32.
void si_letterbox_batch_u8(const uint8_t* const* srcs, const int64_t* hs,
                           const int64_t* ws, int64_t n, float* dst,
                           int64_t size, float pad_value, int bgr_to_rgb,
                           int normalize) {
  for (int64_t i = 0; i < n; i++) {
    si_letterbox_u8(srcs[i], hs[i], ws[i],
                    dst + i * size * size * 3, size, pad_value, bgr_to_rgb,
                    normalize);
  }
}

// -------------------------------------------------------------- NMS
// Greedy score-ordered non-maximum suppression over xyxy boxes — the
// serving-path postprocess hot loop (the reference runs the same
// algorithm per image on the host, test_yolo.cpp:29-111). Semantics
// match zoo.detect.nms exactly: stable sort by descending score,
// suppress IoU > thresh, stop at max_keep. Returns kept count; keep[]
// receives the ORIGINAL indices in score order.
int64_t si_nms(const float* boxes, const float* scores, int64_t n,
               float iou_thresh, int64_t max_keep, int64_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
  std::vector<float> area(n);
  for (int64_t i = 0; i < n; i++) {
    const float* b = boxes + i * 4;
    area[i] = (b[2] - b[0]) * (b[3] - b[1]);
  }
  std::vector<char> dead(n, 0);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n && kept < max_keep; oi++) {
    int64_t i = order[oi];
    if (dead[i]) continue;
    keep[kept++] = i;
    const float* bi = boxes + i * 4;
    for (int64_t oj = oi + 1; oj < n; oj++) {
      int64_t j = order[oj];
      if (dead[j]) continue;
      const float* bj = boxes + j * 4;
      float x1 = bi[0] > bj[0] ? bi[0] : bj[0];
      float y1 = bi[1] > bj[1] ? bi[1] : bj[1];
      float x2 = bi[2] < bj[2] ? bi[2] : bj[2];
      float y2 = bi[3] < bj[3] ? bi[3] : bj[3];
      float iw = x2 - x1 > 0 ? x2 - x1 : 0;
      float ih = y2 - y1 > 0 ? y2 - y1 : 0;
      float inter = iw * ih;
      float denom = area[i] + area[j] - inter;
      float iou = inter / (denom > 1e-9f ? denom : 1e-9f);
      if (iou > iou_thresh) dead[j] = 1;
    }
  }
  return kept;
}

}  // extern "C"
