// Host image codec of the port: the PNG row unfilter, and baseline JPEG
// decode and encode.  Plain C interface, bound with ctypes by
// myslam_torch/utils/imageio.py, which parses the file headers and the
// tables and hands this file the entropy-coded data.
//
// The JPEG decoder gives what libjpeg(-turbo) gives with its defaults:
// the integer "islow" IDCT (jidctint.c), fancy (triangle) upsampling of
// h2v1 / h1v2 / h2v2 chroma with the edge rows and columns replicated
// (jdsample.c, jdmainct.c), and the fixed-point YCbCr->RGB tables
// (jdcolor.c).  The encoder writes baseline 4:2:0 with libjpeg's
// fixed-point RGB->YCbCr and h2v2 downsampling; its DCT is a float one,
// so its files are valid baseline JPEG but not byte-equal to libjpeg's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum {
  kOk = 0,
  kBadFilter = -1,
  kBadHuffman = -2,
  kBadRestart = -3,
  kBadGeometry = -4,
  kOverflow = -5,
};

// -- PNG -------------------------------------------------------------------

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// -- JPEG decode -------------------------------------------------------------

struct Huffman {
  // Canonical decoding tables (ITU T.81 F.2.2.3) and a 9-bit lookahead.
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  int16_t look_len[512];
  uint8_t look_val[512];

  bool build(const uint8_t* bits, const uint8_t* values) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[l];
    if (total > 256) return false;
    std::memcpy(vals, values, total);
    int code = 0, k = 0;
    std::vector<int> codes(total), sizes(total);
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) {
        codes[k] = code++;
        sizes[k++] = l;
      }
      if (code > (1 << l)) return false;
      code <<= 1;
    }
    k = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valptr[l] = k;
        mincode[l] = codes[k];
        k += bits[l - 1];
        maxcode[l] = codes[k - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    for (int i = 0; i < 512; ++i) look_len[i] = 0;
    for (int i = 0; i < total; ++i) {
      if (sizes[i] > 9) continue;
      int shift = 9 - sizes[i];
      for (int j = 0; j < (1 << shift); ++j) {
        look_len[(codes[i] << shift) | j] = (int16_t)sizes[i];
        look_val[(codes[i] << shift) | j] = vals[i];
      }
    }
    return true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool marker = false;  // a marker was reached: feed zeros from here

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          uint8_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            marker = true;  // leave p at the marker
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return (int)(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  // Discard the buffered bits and step over the restart marker RSTn.
  bool restart(int expect) {
    acc = 0;
    nbits = 0;
    // Skip any fill bytes before the marker.
    while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] != 0x00 &&
                        p[1] != 0xFF)) {
      ++p;
    }
    if (p + 1 >= end || p[1] != 0xD0 + (expect & 7)) return false;
    p += 2;
    marker = false;
    return true;
  }
};

int decode_symbol(BitReader& br, const Huffman& h) {
  int look = br.peek(9);
  int len = h.look_len[look];
  if (len) {
    br.skip(len);
    return h.look_val[look];
  }
  int code = br.peek(16);
  for (int l = 10; l <= 16; ++l) {
    int c = code >> (16 - l);
    if (h.maxcode[l] >= 0 && c <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[h.valptr[l] + c - h.mincode[l]];
    }
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg's post-IDCT range limit: index (x & 1023) of x in [-512, 511]
// around the level shift (jdmaster.c prepare_range_limit_table).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                F2_562 = 20995, F3_072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (int)in[0] * qt[0] * 4;
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * 8192;
    int64_t tmp1 = (z2 - z3) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = 11;  // CONST_BITS - PASS1_BITS
    const int64_t h = (int64_t)1 << (s - 1);
    ws[0 * 8 + c] = (int)((tmp10 + tmp3 + h) >> s);
    ws[7 * 8 + c] = (int)((tmp10 - tmp3 + h) >> s);
    ws[1 * 8 + c] = (int)((tmp11 + tmp2 + h) >> s);
    ws[6 * 8 + c] = (int)((tmp11 - tmp2 + h) >> s);
    ws[2 * 8 + c] = (int)((tmp12 + tmp1 + h) >> s);
    ws[5 * 8 + c] = (int)((tmp12 - tmp1 + h) >> s);
    ws[3 * 8 + c] = (int)((tmp13 + tmp0 + h) >> s);
    ws[4 * 8 + c] = (int)((tmp13 - tmp0 + h) >> s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[(int)(((int64_t)w[0] + 16) >> 5) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192;
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = 18;  // CONST_BITS + PASS1_BITS + 3
    const int64_t h = (int64_t)1 << (s - 1);
    o[0] = kRange.t[(int)((tmp10 + tmp3 + h) >> s) & 1023];
    o[7] = kRange.t[(int)((tmp10 - tmp3 + h) >> s) & 1023];
    o[1] = kRange.t[(int)((tmp11 + tmp2 + h) >> s) & 1023];
    o[6] = kRange.t[(int)((tmp11 - tmp2 + h) >> s) & 1023];
    o[2] = kRange.t[(int)((tmp12 + tmp1 + h) >> s) & 1023];
    o[5] = kRange.t[(int)((tmp12 - tmp1 + h) >> s) & 1023];
    o[3] = kRange.t[(int)((tmp13 + tmp0 + h) >> s) & 1023];
    o[4] = kRange.t[(int)((tmp13 - tmp0 + h) >> s) & 1023];
  }
}

// One decoded component: its plane padded to whole blocks, and its real
// (downsampled) size.
struct Plane {
  int h, v;       // sampling factors
  int bw, bh;     // padded plane size (whole blocks)
  int dw, dh;     // real size: ceil(image * factor / max factor)
  std::vector<uint8_t> px;
  uint8_t at(int x, int y) const { return px[(size_t)y * bw + x]; }
};

// Upsample ``p`` to the image's (W, H) grid by libjpeg's rules:
// fullsize copy, fancy h2v1 / h1v2 / h2v2 (edge rows and columns
// replicated), else replication by integral factors.
void upsample(const Plane& p, int hmax, int vmax, int W, int H,
              std::vector<uint8_t>& out) {
  out.assign((size_t)W * H, 0);
  const int hf = hmax / p.h, vf = vmax / p.v;
  const int dw = p.dw, dh = p.dh;
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(&out[(size_t)y * W], &p.px[(size_t)y * p.bw], W);
    return;
  }
  std::vector<uint8_t> row((size_t)2 * dw + 2);
  if (hf == 2 && vf == 1 && dw > 2) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = &p.px[(size_t)y * p.bw];
      uint8_t* o = row.data();
      int v = in[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        v = in[c] * 3;
        *o++ = (uint8_t)((v + in[c - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + in[c + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *o++ = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
      std::memcpy(&out[(size_t)y * W], row.data(), W);
    }
    return;
  }
  if (hf == 1 && vf == 2) {
    for (int y = 0; y < H; ++y) {
      int r = y >> 1;
      int other = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* in0 = &p.px[(size_t)r * p.bw];
      const uint8_t* in1 = &p.px[(size_t)other * p.bw];
      for (int x = 0; x < W; ++x)
        out[(size_t)y * W + x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  if (hf == 2 && vf == 2 && dw > 2) {
    for (int y = 0; y < H; ++y) {
      int r = y >> 1;
      int other = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
      const uint8_t* in0 = &p.px[(size_t)r * p.bw];
      const uint8_t* in1 = &p.px[(size_t)other * p.bw];
      uint8_t* o = row.data();
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int c = 2; c < dw; ++c) {
        next_sum = in0[c] * 3 + in1[c];
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)y * W], row.data(), W);
    }
    return;
  }
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      out[(size_t)y * W + x] = p.at(x / hf, y / vf);
}

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16, nearest-integer tables.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

// -- JPEG encode -------------------------------------------------------------

struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) {
        code[vals[k]] = code_v++;
        size[vals[k++]] = (uint8_t)l;
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;
  void byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;
  }
  void put(uint32_t v, int len) {
    if (!len) return;
    acc = (acc << len) | (v & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      byte((uint8_t)(acc >> (nbits - 8)));
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);  // pad with one-bits
  }
};

// The orthonormal DCT-II basis: c(u) cos((2x + 1) u pi / 16).
struct Cosines {
  float c[8][8];
  Cosines() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (float)(std::cos((2 * x + 1) * u * M_PI / 16.0) *
                          (u == 0 ? std::sqrt(0.125) : 0.5));
  }
};
const Cosines kCos;

void fdct_quantize(const float* blk, const uint16_t* q, int16_t* coef) {
  const auto& cosines = kCos.c;
  float tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += cosines[u][x] * blk[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += cosines[v][y] * tmp[y * 8 + u];
      float r = std::round(s / q[v * 8 + u]);
      coef[v * 8 + u] = (int16_t)r;
    }
}

int bit_length(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* coef, int& pred,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = bit_length(diff);
  bw.put(dc.code[s], dc.size[s]);
  bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag[k]];
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    s = bit_length(v);
    int rs = (run << 4) | s;
    bw.put(ac.code[rs], ac.size[rs]);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(ac.code[0x00], ac.size[0x00]);
}

}  // namespace

extern "C" {

// PNG: undo the row filters of ``height`` rows of ``rowbytes`` bytes
// (each preceded by its filter byte in ``raw``) into ``out``; ``bpp`` is
// the bytes per complete pixel (at least 1).
int png_unfilter(const uint8_t* raw, int height, int rowbytes, int bpp,
                 uint8_t* out) {
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + (size_t)y * (rowbytes + 1);
    int f = in[0];
    ++in;
    uint8_t* cur = out + (size_t)y * rowbytes;
    const uint8_t* prev = y ? cur - rowbytes : zero.data();
    switch (f) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(in[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        return kBadFilter;
    }
  }
  return kOk;
}

// Baseline JPEG: decode one interleaved scan (or the single component's
// scan) of ``ncomp`` components (1: gray, 3: YCbCr or RGB) into ``out``
// (H x W x ncomp).  Per component: sampling factors ``hv`` (h, v), its
// quantization table in natural order ``qt``, and its DC / AC Huffman
// tables as (16 counts, 256 values).  ``restart``: the restart interval
// in MCUs (0: none).  ``ycc``: convert YCbCr to RGB.
int jpeg_decode(const uint8_t* data, int64_t size, int W, int H, int ncomp,
                const int* hv, const uint16_t* qt, const uint8_t* dc_bits,
                const uint8_t* dc_vals, const uint8_t* ac_bits,
                const uint8_t* ac_vals, int restart, int ycc, uint8_t* out) {
  if (ncomp != 1 && ncomp != 3) return kBadGeometry;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (hv[2 * c] < 1 || hv[2 * c] > 4 || hv[2 * c + 1] < 1 ||
        hv[2 * c + 1] > 4)
      return kBadGeometry;
    hmax = std::max(hmax, hv[2 * c]);
    vmax = std::max(vmax, hv[2 * c + 1]);
  }
  for (int c = 0; c < ncomp; ++c)
    if (ncomp > 1 && (hmax % hv[2 * c] || vmax % hv[2 * c + 1]))
      return kBadGeometry;
  std::vector<Huffman> dcs(ncomp), acs(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    if (!dcs[c].build(dc_bits + 16 * c, dc_vals + 256 * c) ||
        !acs[c].build(ac_bits + 16 * c, ac_vals + 256 * c))
      return kBadHuffman;
  }
  std::vector<Plane> planes(ncomp);
  int mcux, mcuy;
  if (ncomp == 1) {
    // A single component's scan is not interleaved: one block per MCU.
    mcux = (W + 7) / 8;
    mcuy = (H + 7) / 8;
    planes[0].h = planes[0].v = 1;
    hmax = vmax = 1;
    planes[0].bw = mcux * 8;
    planes[0].bh = mcuy * 8;
  } else {
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      planes[c].h = hv[2 * c];
      planes[c].v = hv[2 * c + 1];
      planes[c].bw = mcux * planes[c].h * 8;
      planes[c].bh = mcuy * planes[c].v * 8;
    }
  }
  for (int c = 0; c < ncomp; ++c) {
    Plane& p = planes[c];
    p.dw = (int)(((int64_t)W * p.h + hmax - 1) / hmax);
    p.dh = (int)(((int64_t)H * p.v + vmax - 1) / vmax);
    p.px.assign((size_t)p.bw * p.bh, 0);
  }
  BitReader br{data, data + size};
  std::vector<int> pred(ncomp, 0);
  int16_t coef[64];
  int16_t natural[64];
  int64_t mcus = (int64_t)mcux * mcuy;
  int next_rst = 0;
  for (int64_t m = 0; m < mcus; ++m) {
    if (restart && m > 0 && m % restart == 0) {
      if (!br.restart(next_rst++)) return kBadRestart;
      std::fill(pred.begin(), pred.end(), 0);
    }
    int mx = (int)(m % mcux), my = (int)(m / mcux);
    for (int c = 0; c < ncomp; ++c) {
      Plane& p = planes[c];
      int bh = ncomp == 1 ? 1 : p.h, bv = ncomp == 1 ? 1 : p.v;
      for (int by = 0; by < bv; ++by)
        for (int bx = 0; bx < bh; ++bx) {
          std::memset(coef, 0, sizeof(coef));
          int s = decode_symbol(br, dcs[c]);
          if (s < 0 || s > 11) return kBadHuffman;
          pred[c] += s ? extend(br.get(s), s) : 0;
          coef[0] = (int16_t)pred[c];
          for (int k = 1; k < 64;) {
            int rs = decode_symbol(br, acs[c]);
            if (rs < 0) return kBadHuffman;
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              if (k > 63) return kBadHuffman;
              coef[k] = (int16_t)extend(br.get(sz), sz);
              ++k;
            } else if (r == 15) {
              k += 16;
            } else {
              break;
            }
          }
          for (int k = 0; k < 64; ++k) natural[kZigzag[k]] = coef[k];
          int x0 = (mx * bh + bx) * 8, y0 = (my * bv + by) * 8;
          idct_islow(natural, qt + 64 * c, &p.px[(size_t)y0 * p.bw + x0],
                     p.bw);
        }
    }
  }
  if (ncomp == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + (size_t)y * W, &planes[0].px[(size_t)y * planes[0].bw],
                  W);
    return kOk;
  }
  std::vector<uint8_t> full[3];
  for (int c = 0; c < 3; ++c) upsample(planes[c], hmax, vmax, W, H, full[c]);
  const size_t n = (size_t)W * H;
  if (!ycc) {
    for (size_t i = 0; i < n; ++i)
      for (int c = 0; c < 3; ++c) out[3 * i + c] = full[c][i];
    return kOk;
  }
  const int *cr_r = kYcc.cr_r, *cb_b = kYcc.cb_b;
  const int64_t *cr_g = kYcc.cr_g, *cb_g = kYcc.cb_g;
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (size_t i = 0; i < n; ++i) {
    int y = full[0][i], cb = full[1][i], cr = full[2][i];
    out[3 * i + 0] = clamp(y + cr_r[cr]);
    out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp(y + cb_b[cb]);
  }
  return kOk;
}

// Baseline JPEG: the entropy-coded data of one interleaved 4:2:0 YCbCr
// scan of the RGB image ``rgb`` (H x W x 3), with the given quantization
// tables (natural order; luminance, chrominance) and Huffman tables
// (DC luminance, AC luminance, DC chrominance, AC chrominance as 16
// counts and up to 256 values each).  Writes at most ``cap`` bytes to
// ``out``; returns the count, or kOverflow.
int64_t jpeg_encode(const uint8_t* rgb, int W, int H, const uint16_t* qt,
                    const uint8_t* bits, const uint8_t* vals, uint8_t* out,
                    int64_t cap) {
  const int PW = (W + 15) / 16 * 16, PH = (H + 15) / 16 * 16;
  // jccolor.c rgb_ycc_convert, then the edges replicated to whole MCUs.
  std::vector<uint8_t> ych((size_t)PW * PH), cbh((size_t)PW * PH),
      crh((size_t)PW * PH);
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  const int64_t half = (int64_t)1 << 15, cbcr_off = (int64_t)128 << 16;
  for (int y = 0; y < PH; ++y) {
    int sy = std::min(y, H - 1);
    for (int x = 0; x < PW; ++x) {
      int sx = std::min(x, W - 1);
      const uint8_t* p = rgb + ((size_t)sy * W + sx) * 3;
      int64_t r = p[0], g = p[1], b = p[2];
      size_t i = (size_t)y * PW + x;
      ych[i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g +
                          fix(0.11400) * b + half) >> 16);
      cbh[i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g +
                          fix(0.50000) * b + cbcr_off + half - 1) >> 16);
      crh[i] = (uint8_t)((fix(0.50000) * r - fix(0.41869) * g -
                          fix(0.08131) * b + cbcr_off + half - 1) >> 16);
    }
  }
  // jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ... along each row.
  const int CW = PW / 2, CH = PH / 2;
  std::vector<uint8_t> cb((size_t)CW * CH), cr((size_t)CW * CH);
  for (int y = 0; y < CH; ++y) {
    int bias = 1;
    for (int x = 0; x < CW; ++x) {
      size_t a = (size_t)(2 * y) * PW + 2 * x, b = a + PW;
      cb[(size_t)y * CW + x] =
          (uint8_t)((cbh[a] + cbh[a + 1] + cbh[b] + cbh[b + 1] + bias) >> 2);
      cr[(size_t)y * CW + x] =
          (uint8_t)((crh[a] + crh[a + 1] + crh[b] + crh[b + 1] + bias) >> 2);
      bias ^= 3;
    }
  }
  HuffEnc huff[4];
  int off = 0;
  for (int t = 0; t < 4; ++t) {
    huff[t].build(bits + 16 * t, vals + off);
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[16 * t + l];
    off += total;
  }
  BitWriter bw{out, cap};
  int pred[3] = {0, 0, 0};
  float blk[64];
  int16_t coef[64];
  auto block = [&](const std::vector<uint8_t>& plane, int stride, int x0,
                   int y0, int comp) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        blk[y * 8 + x] = (float)plane[(size_t)(y0 + y) * stride + x0 + x] -
                         128.0f;
    fdct_quantize(blk, qt + 64 * (comp ? 1 : 0), coef);
    encode_block(bw, coef, pred[comp], huff[comp ? 2 : 0],
                 huff[comp ? 3 : 1]);
  };
  for (int my = 0; my < PH / 16; ++my)
    for (int mx = 0; mx < PW / 16; ++mx) {
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx)
          block(ych, PW, mx * 16 + bx * 8, my * 16 + by * 8, 0);
      block(cb, CW, mx * 8, my * 8, 1);
      block(cr, CW, mx * 8, my * 8, 2);
      if (bw.overflow) return kOverflow;
    }
  bw.flush();
  return bw.overflow ? (int64_t)kOverflow : bw.n;
}

}  // extern "C"
