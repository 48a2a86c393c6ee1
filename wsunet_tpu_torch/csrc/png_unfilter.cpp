// PNG scanline unfilter for wsunet_tpu_torch.io.png (host code, g++).
//
// The inflated IDAT stream of an 8-bit, non-interlaced PNG is h rows of
// one filter byte (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) and w * bpp
// filtered bytes.  ws_png_unfilter_batch undoes the filters of n such
// streams, each into its own h * w * bpp output, for 1, 2, 3 or 4 bytes a
// pixel.  Runs of Paeth rows take a wavefront over K rows at a time (row
// r at pixel i needs row r-1 only up to pixel i), which keeps K
// independent dependency chains in flight instead of one; the bytes each
// step consumes are those of the row-by-row order, so the result is the
// same bit for bit.
//
// Plain C interface, built with g++ -O3 -shared at first use and called
// through ctypes (which releases the GIL for the call).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth_step(int a, int b, int c, int x) {
  const int p = b - c;  // (a + b - c) - a
  const int q = a - c;  // (a + b - c) - b
  const int pa = std::abs(p);
  const int pb = std::abs(q);
  const int pc = std::abs(p + q);
  int pred = (pb <= pc) ? b : c;
  pred = (pa <= pb && pa <= pc) ? a : pred;
  return static_cast<uint8_t>(x + pred);
}

template <int BPP>
constexpr int wave_rows() { return BPP == 1 ? 8 : 4; }

// K consecutive Paeth rows starting at `base` (first data byte of the
// first row of the run; the row above is already unfiltered), w_px > K.
template <int BPP>
void paeth_wave(uint8_t* base, size_t rowbytes, int w_px) {
  constexpr int K = wave_rows<BPP>();
  uint8_t* row[K + 1];
  row[0] = base - rowbytes;
  for (int r = 0; r < K; ++r) row[r + 1] = base + static_cast<size_t>(r) * rowbytes;
  int a[K][BPP];
  auto step = [&](int r, int i) {
    uint8_t* cur = row[r + 1] + static_cast<size_t>(i) * BPP;
    const uint8_t* up = row[r] + static_cast<size_t>(i) * BPP;
    if (i == 0) {
      for (int ch = 0; ch < BPP; ++ch) {  // left = upper left = 0: pred = up
        a[r][ch] = static_cast<uint8_t>(cur[ch] + up[ch]);
        cur[ch] = static_cast<uint8_t>(a[r][ch]);
      }
    } else {
      for (int ch = 0; ch < BPP; ++ch) {
        a[r][ch] = paeth_step(a[r][ch], up[ch], up[ch - BPP], cur[ch]);
        cur[ch] = static_cast<uint8_t>(a[r][ch]);
      }
    }
  };
  for (int s = 0; s < K; ++s)  // leading triangle
    for (int r = 0; r <= s; ++r) step(r, s - r);
  for (int s = K; s < w_px; ++s)  // all K rows active
    for (int r = 0; r < K; ++r) step(r, s - r);
  for (int s = w_px; s < w_px + K - 1; ++s)  // trailing triangle
    for (int r = s - w_px + 1; r < K; ++r) step(r, s - r);
}

// One Paeth row against an unfiltered row above (prev may be null: then
// the predictor is the left byte).
template <int BPP>
void paeth_row(uint8_t* cur, const uint8_t* prev, size_t stride) {
  if (prev == nullptr) {
    for (size_t i = BPP; i < stride; ++i)
      cur[i] = static_cast<uint8_t>(cur[i] + cur[i - BPP]);
    return;
  }
  int a[BPP];
  for (int ch = 0; ch < BPP; ++ch) {
    a[ch] = static_cast<uint8_t>(cur[ch] + prev[ch]);
    cur[ch] = static_cast<uint8_t>(a[ch]);
  }
  for (size_t i = BPP; i < stride; i += BPP)
    for (int ch = 0; ch < BPP; ++ch) {
      a[ch] = paeth_step(a[ch], prev[i + ch], prev[i + ch - BPP], cur[i + ch]);
      cur[i + ch] = static_cast<uint8_t>(a[ch]);
    }
}

// Unfilter one stream in place (scan: h rows of 1 + w * BPP bytes);
// returns 0, or 1 for a filter byte above 4.
template <int BPP>
int unfilter(uint8_t* scan, int h, int w) {
  const size_t stride = static_cast<size_t>(w) * BPP;
  const size_t rowbytes = stride + 1;
  constexpr int K = wave_rows<BPP>();
  uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* rowp = scan + static_cast<size_t>(y) * rowbytes;
    uint8_t* cur = rowp + 1;
    const uint8_t filt = rowp[0];
    if (filt == 4 && prev != nullptr && w > K) {
      int run = 1;
      while (y + run < h && scan[static_cast<size_t>(y + run) * rowbytes] == 4) ++run;
      int done = 0;
      for (; run - done >= K; done += K)
        paeth_wave<BPP>(scan + static_cast<size_t>(y + done) * rowbytes + 1, rowbytes, w);
      for (; done < run; ++done) {
        uint8_t* rcur = scan + static_cast<size_t>(y + done) * rowbytes + 1;
        paeth_row<BPP>(rcur, rcur - rowbytes, stride);
      }
      y += run - 1;
      prev = scan + static_cast<size_t>(y) * rowbytes + 1;
      continue;
    }
    switch (filt) {
      case 0:
        break;
      case 1:
        for (size_t i = BPP; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(cur[i] + cur[i - BPP]);
        break;
      case 2:
        if (prev != nullptr)
          for (size_t i = 0; i < stride; ++i)
            cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
        break;
      case 3:
        if (prev != nullptr) {
          for (size_t i = 0; i < BPP; ++i)
            cur[i] = static_cast<uint8_t>(cur[i] + (prev[i] >> 1));
          for (size_t i = BPP; i < stride; ++i)
            cur[i] = static_cast<uint8_t>(cur[i] + ((cur[i - BPP] + prev[i]) >> 1));
        } else {
          for (size_t i = BPP; i < stride; ++i)
            cur[i] = static_cast<uint8_t>(cur[i] + (cur[i - BPP] >> 1));
        }
        break;
      case 4:
        paeth_row<BPP>(cur, prev, stride);
        break;
      default:
        return 1;
    }
    prev = cur;
  }
  return 0;
}

int unfilter_any(uint8_t* scan, int h, int w, int bpp) {
  switch (bpp) {
    case 1: return unfilter<1>(scan, h, w);
    case 2: return unfilter<2>(scan, h, w);
    case 3: return unfilter<3>(scan, h, w);
    case 4: return unfilter<4>(scan, h, w);
    default: return 2;
  }
}

}  // namespace

extern "C" {

// For each of the n streams: unfilter scans[k] (h[k] rows of
// 1 + w[k] * bpp[k] bytes; modified in place) and copy the pixel bytes,
// without the filter bytes, to outs[k] (h[k] * w[k] * bpp[k] bytes).
// status[k] is 0, 1 (a filter byte above 4) or 2 (bpp not 1-4).
// Returns the number of streams whose status is not 0.
int ws_png_unfilter_batch(int n, uint8_t* const* scans, uint8_t* const* outs,
                          const int32_t* h, const int32_t* w,
                          const int32_t* bpp, int32_t* status) {
  int failed = 0;
  for (int k = 0; k < n; ++k) {
    status[k] = unfilter_any(scans[k], h[k], w[k], bpp[k]);
    if (status[k] != 0) {
      ++failed;
      continue;
    }
    const size_t stride = static_cast<size_t>(w[k]) * bpp[k];
    for (int y = 0; y < h[k]; ++y)
      std::memcpy(outs[k] + static_cast<size_t>(y) * stride,
                  scans[k] + static_cast<size_t>(y) * (stride + 1) + 1, stride);
  }
  return failed;
}

}  // extern "C"
