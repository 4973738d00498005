// Host codecs of the port: the JPEG entropy decode and the PNG row
// unfilter, the two per-byte loops of mhmocap_tpu_torch/io.py.
//
// The JAX package reads its frames with PIL's C decoders on a thread
// pool; these are the port's counterparts. Each function is a step-for-
// step copy of its plain Python version in io.py (`_decode_scan`,
// `_png_unfilter`), which the tests hold it to bit for bit, error for
// error. Plain C interface, no Python API: the
// functions are called through ctypes.CDLL, which releases the GIL for
// the call, so frames decode in parallel on threads. Built with g++
// -O3 -shared -fPIC -std=c++17 by mhmocap_tpu_torch/native/__init__.py.

#include <cstdint>

namespace {

// natural (row-major) index of the k-th coefficient in zigzag order
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Return codes of mhmocap_jpeg_decode_scan; the Python wrapper raises
// what `_decode_scan` raises for each.
enum {
  kOk = 0,
  kBadCode = 1,        // "bad JPEG Huffman code"
  kAcRun = 2,          // "JPEG AC run past coefficient 63"
  kScanEnds = 3,       // "JPEG scan ends before its last MCU"
  kOverrun = 4,        // "JPEG entropy data overrun", also a read past
                       // the 4 bytes of zero padding
  kNoTable = 5,        // a table the scan names was never defined
                       // (info: 2 * component + 1 if AC)
  kNegativeShift = 6,  // a value of more bits than the 32-bit window
                       // holds (a corrupt table's symbol)
  kInt32 = 7,          // a coefficient outside int32 (info: the value)
  kZeroStep = 8,       // no MCU and no restart interval
  kNoCoefs = 9,        // a component without coefficient arrays
                       // (info: the component)
  kOutOfBounds = 10,   // a block outside the component's arrays
                       // (info: the index, the axis, the axis' size)
};

}  // namespace

extern "C" {

// Entropy-decode one scan into the components' coefficient arrays.
//
// data: the scan's restart segments, already unstuffed, each followed
//   by 4 zero bytes; segment s starts at seg_start[s] and holds
//   seg_len[s] bytes before its padding.
// ncomp components of the scan, in scan order: geom[4 c .. 4 c + 3] =
//   (h, v, rows, cols) of component c, whose (rows, cols, 64) int32
//   coefficients (natural order) are at coefs[c] (null if the component
//   has none); dc[c] and ac[c] are
//   its tables, each (2, 65536) int32: the symbol and the code length
//   of every 16-bit peek (length 0: no code), or null if undefined.
// interleaved: MCUs of h x v blocks of every component in turn, on a
//   grid_w x grid_h grid of MCUs; otherwise (one component) one block
//   an MCU, on a grid_w x grid_h grid of blocks.
// restart_interval: MCUs a segment, 0 for one segment.
// info: 3 values of an error (see the return codes).
int mhmocap_jpeg_decode_scan(const uint8_t* data, const int64_t* seg_start,
                             const int64_t* seg_len, int64_t nseg,
                             int32_t ncomp, const int32_t* geom,
                             int32_t* const* coefs, const int32_t* const* dc,
                             const int32_t* const* ac, int32_t interleaved,
                             int64_t grid_w, int64_t grid_h,
                             int64_t restart_interval, int64_t* info) {
  const int64_t total = grid_w * grid_h;
  const int64_t per = restart_interval ? restart_interval : total;
  if (per == 0) return kZeroStep;
  int64_t seg = 0;
  for (int64_t start = 0; start < total; start += per, ++seg) {
    if (seg >= nseg) return kScanEnds;
    const uint8_t* d = data + seg_start[seg];
    const int64_t len = seg_len[seg];
    const int64_t nbits = 8 * len;
    int64_t pos = 0;
    int64_t preds[256] = {0};
    const int64_t end = start + per < total ? start + per : total;
    for (int64_t m = start; m < end; ++m) {
      const int64_t my = m / grid_w, mx = m % grid_w;
      for (int32_t ci = 0; ci < ncomp; ++ci) {
        const int32_t h = interleaved ? geom[4 * ci] : 1;
        const int32_t v = interleaved ? geom[4 * ci + 1] : 1;
        const int64_t rows = geom[4 * ci + 2], cols = geom[4 * ci + 3];
        for (int32_t y = 0; y < v; ++y) {
          for (int32_t x = 0; x < h; ++x) {
            const int32_t* dt = dc[ci];
            const int32_t* at = ac[ci];
            if (dt == nullptr || at == nullptr) {
              info[0] = 2 * ci + (dt != nullptr);
              return kNoTable;
            }
            if (coefs[ci] == nullptr) {
              info[0] = ci;
              return kNoCoefs;
            }
            const int64_t r = my * v + y, q = mx * h + x;
            if (r >= rows || q >= cols) {
              info[0] = r >= rows ? r : q;
              info[1] = r >= rows ? 0 : 1;
              info[2] = r >= rows ? rows : cols;
              return kOutOfBounds;
            }
            int32_t* blk = coefs[ci] + (r * cols + q) * 64;
            // the 32-bit window at byte pos >> 3; Python's index error
            // past the padding is the overrun
            int64_t i = pos >> 3;
            if (i > len) return kOverrun;
            uint32_t w = (uint32_t)d[i] << 24 | (uint32_t)d[i + 1] << 16 |
                         (uint32_t)d[i + 2] << 8 | d[i + 3];
            uint32_t peek = (w >> (16 - (pos & 7))) & 0xFFFF;
            int32_t n = dt[65536 + peek];
            if (n == 0) return kBadCode;
            int32_t s = dt[peek];
            pos += n;
            int64_t diff = 0;
            if (s) {
              i = pos >> 3;
              if (i > len) return kOverrun;
              w = (uint32_t)d[i] << 24 | (uint32_t)d[i + 1] << 16 |
                  (uint32_t)d[i + 2] << 8 | d[i + 3];
              const int32_t shift = 32 - (int32_t)(pos & 7) - s;
              if (shift < 0) return kNegativeShift;
              diff = (int64_t)(((uint64_t)w >> shift) & ((1ULL << s) - 1));
              pos += s;
              if (diff < (int64_t)(1ULL << (s - 1)))
                diff -= (int64_t)((1ULL << s) - 1);
            }
            preds[ci] += diff;
            if (preds[ci] < INT32_MIN || preds[ci] > INT32_MAX) {
              info[0] = preds[ci];
              return kInt32;
            }
            blk[0] = (int32_t)preds[ci];
            int k = 1;
            while (k < 64) {
              i = pos >> 3;
              if (i > len) return kOverrun;
              w = (uint32_t)d[i] << 24 | (uint32_t)d[i + 1] << 16 |
                  (uint32_t)d[i + 2] << 8 | d[i + 3];
              peek = (w >> (16 - (pos & 7))) & 0xFFFF;
              n = at[65536 + peek];
              if (n == 0) return kBadCode;
              const int32_t rs = at[peek];
              pos += n;
              s = rs & 15;
              if (s == 0) {
                if (rs != 0xF0) break;
                k += 16;
                continue;
              }
              k += rs >> 4;
              if (k > 63) return kAcRun;
              i = pos >> 3;
              if (i > len) return kOverrun;
              w = (uint32_t)d[i] << 24 | (uint32_t)d[i + 1] << 16 |
                  (uint32_t)d[i + 2] << 8 | d[i + 3];
              // s <= 15 here, so the shift is at least 10
              int32_t val = (int32_t)((w >> (32 - (pos & 7) - s)) &
                                      ((1u << s) - 1));
              pos += s;
              if (val < (1 << (s - 1))) val -= (1 << s) - 1;
              blk[kZigzag[k]] = val;
              ++k;
            }
          }
        }
      }
    }
    if (pos > nbits + 8) return kOverrun;
  }
  return kOk;
}

// Undo the PNG row filters (0-4) of rows lines of 1 + rowbytes bytes
// each (the filter type, then the row) into out (rows x rowbytes); a
// byte's left neighbour is bpp bytes back, and the image has a zero
// border. Returns 0, or the largest filter type if one is above 4
// (checked before any row is written, as `_png_unfilter` does).
int mhmocap_png_unfilter(const uint8_t* raw, int64_t rows, int64_t rowbytes,
                         int64_t bpp, uint8_t* out) {
  int worst = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int f = raw[r * (rowbytes + 1)];
    if (f > worst) worst = f;
  }
  if (worst > 4) return worst;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* src = raw + r * (rowbytes + 1);
    const int f = src[0];
    ++src;
    uint8_t* cur = out + r * rowbytes;
    const uint8_t* up = r ? cur - rowbytes : nullptr;
    for (int64_t x = 0; x < rowbytes; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred = 0;
      switch (f) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: break;
      }
      cur[x] = (uint8_t)((src[x] + pred) & 0xFF);
    }
  }
  return 0;
}

}  // extern "C"
