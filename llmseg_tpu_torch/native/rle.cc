// Host-side COCO RLE codec (the pycocotools wire format), the port's copy
// of the JAX package's native codec.
//
// Column-major (Fortran) run-length encoding over binary masks, called from
// Python through ctypes (llmseg_tpu_torch/native/rle.py builds it with g++
// into llmseg_tpu_torch/_build/ at first use); the numpy path of
// llmseg_tpu_torch/ops/rle.py is the behavioural reference.

#include <cstdint>
#include <cstring>

extern "C" {

// mask: (h, w) uint8, C-order.  counts_out must hold >= h*w + 1 entries.
// Returns the number of runs written (first run counts zeros).
int64_t rle_mask_to_counts(const uint8_t* mask, int64_t h, int64_t w,
                           int64_t* counts_out) {
  int64_t n = 0;
  int64_t run = 0;
  uint8_t cur = 0;  // first run counts zeros
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* col = mask + x;  // stride w walks down a column in C-order
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = col[y * w] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        counts_out[n++] = run;
        run = 1;
        cur = v;
      }
    }
  }
  counts_out[n++] = run;
  return n;
}

// counts: n runs; out: (h, w) uint8 C-order buffer (h*w entries).
// Returns 0 on success, -1 if counts do not sum to h*w.
int rle_counts_to_mask(const int64_t* counts, int64_t n, int64_t h, int64_t w,
                       uint8_t* out) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += counts[i];
  if (total != h * w) return -1;
  int64_t pos = 0;  // column-major position
  uint8_t val = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < counts[i]; ++j, ++pos) {
      if (val) {
        int64_t y = pos % h;
        int64_t x = pos / h;
        out[y * w + x] = 1;
      }
    }
    val ^= 1;
  }
  return 0;
}

// Fused AMG-finish hot path: bit-packed mask -> compressed-RLE string +
// area + inclusive-edge bbox in ONE pass, no unpacked (h, w) buffer.
//
// packed: (h_pad, stride) uint8, rows bit-packed along width with
// numpy packbits default bitorder="big" (pixel x lives in byte x>>3,
// bit 7-(x&7)).  Only the top-left (h, w) crop is encoded, column-major
// (Fortran) like pycocotools.  str_out must hold >= 6*(h*w+1) + 1 chars
// (worst-case varint expansion); bbox_out holds 4 doubles
// [x_min, y_min, x_max - x_min, y_max - y_min] (zeros for empty masks).
// Returns the string length; *area_out gets the foreground pixel count.
int64_t rle_packed_encode(const uint8_t* packed, int64_t stride,
                          int64_t h, int64_t w,
                          char* str_out, int64_t* area_out,
                          double* bbox_out) {
  int64_t area = 0;
  int64_t x_min = -1, x_max = -1, y_min = -1, y_max = -1;
  // varint stream state: pycocotools rleToString emits counts[i] with
  // counts[i-2] subtracted for i > 2 (ops/rle.py counts_to_string)
  int64_t slen = 0;
  int64_t prev2[2] = {0, 0};  // counts[i-2], counts[i-1]
  int64_t n_runs = 0;
  auto emit = [&](int64_t count) {
    int64_t x = count;
    if (n_runs > 2) x -= prev2[0];
    prev2[0] = prev2[1];
    prev2[1] = count;
    ++n_runs;
    bool more = true;
    while (more) {
      int64_t ch = x & 0x1F;
      x >>= 5;  // arithmetic shift keeps sign for negative deltas
      more = !((x == 0 && !(ch & 0x10)) || (x == -1 && (ch & 0x10)));
      if (more) ch |= 0x20;
      str_out[slen++] = (char)(ch + 48);
    }
  };
  int64_t run = 0;
  uint8_t cur = 0;  // first run counts zeros
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* col = packed + (x >> 3);
    const uint8_t bit = (uint8_t)(7 - (x & 7));
    int64_t col_first = -1, col_last = -1;
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = (col[y * stride] >> bit) & 1;
      if (v) {
        ++area;
        if (col_first < 0) col_first = y;
        col_last = y;
      }
      if (v == cur) {
        ++run;
      } else {
        emit(run);
        run = 1;
        cur = v;
      }
    }
    if (col_first >= 0) {
      if (x_min < 0) x_min = x;
      x_max = x;
      if (y_min < 0 || col_first < y_min) y_min = col_first;
      if (col_last > y_max) y_max = col_last;
    }
  }
  emit(run);
  str_out[slen] = '\0';
  *area_out = area;
  if (x_min < 0) {
    bbox_out[0] = bbox_out[1] = bbox_out[2] = bbox_out[3] = 0.0;
  } else {
    bbox_out[0] = (double)x_min;
    bbox_out[1] = (double)y_min;
    bbox_out[2] = (double)(x_max - x_min);
    bbox_out[3] = (double)(y_max - y_min);
  }
  return slen;
}

// counts -> pycocotools varint string (rleToString).  str_out must hold
// >= 6*n + 1 chars.  Returns the string length.  Used by the on-device-RLE
// finish path (ops/device_rle.py), where the host receives run boundaries
// and only needs the varint encode.
int64_t rle_counts_to_string(const int64_t* counts, int64_t n,
                             char* str_out) {
  int64_t slen = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more) {
      int64_t ch = x & 0x1F;
      x >>= 5;  // arithmetic shift keeps sign for negative deltas
      more = !((x == 0 && !(ch & 0x10)) || (x == -1 && (ch & 0x10)));
      if (more) ch |= 0x20;
      str_out[slen++] = (char)(ch + 48);
    }
  }
  str_out[slen] = '\0';
  return slen;
}

// Batch IoU/IoP between one GT mask and K proposal masks, all (h, w) uint8.
// Replaces the reference's per-proposal Python loop (utils/utils.py:234-272)
// for the host-side label computation.  iop = intersection / proposal_area.
void mask_iou_iop(const uint8_t* gt, const uint8_t* props, int64_t k,
                  int64_t h, int64_t w, float* iou_out, float* iop_out) {
  int64_t hw = h * w;
  int64_t gt_area = 0;
  for (int64_t i = 0; i < hw; ++i) gt_area += gt[i] ? 1 : 0;
  for (int64_t p = 0; p < k; ++p) {
    const uint8_t* m = props + p * hw;
    int64_t inter = 0, parea = 0;
    for (int64_t i = 0; i < hw; ++i) {
      int64_t mv = m[i] ? 1 : 0;
      parea += mv;
      inter += (mv & (gt[i] ? 1 : 0));
    }
    int64_t uni = gt_area + parea - inter;
    iou_out[p] = uni > 0 ? (float)inter / (float)uni : 0.0f;
    iop_out[p] = parea > 0 ? (float)inter / (float)parea : 0.0f;
  }
}

}  // extern "C"
