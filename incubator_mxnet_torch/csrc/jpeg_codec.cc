// The port's JPEG codec: a baseline / extended-sequential Huffman decoder
// and a baseline encoder in plain host C++, so that neither PIL nor
// OpenCV is needed on the card's host.
//
// The decoder computes what libjpeg-turbo computes with its default
// settings (the library PIL and OpenCV decode through), so that its
// pixels equal theirs:
//   * the integer IDCT (jidctint.c `jpeg_idct_islow`) and, for decoding at
//     1/2, 1/4 and 1/8 of the size, the reduced IDCTs of jidctred.c, with
//     libjpeg's choice of each component's DCT size (chroma is scaled up
//     in the IDCT rather than upsampled where the ratios allow);
//   * fancy upsampling (jdsample.c: the triangle filters of h2v1, h1v2 and
//     h2v2, replication where libjpeg turns fancy upsampling off);
//   * the YCbCr -> RGB fixed-point tables of jdcolor.c (SCALEBITS 16) and
//     the IDCT range-limit table.
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
// 4-component (CMYK / YCCK) streams are refused with the feature's name.
//
// The encoder is libjpeg's baseline path at its defaults: RGB -> YCbCr
// (jccolor.c), 4:2:0 by h2v2 downsampling (jcsample.c), the integer forward
// DCT (jfdctint.c), the reciprocal quantizer of jcdctmgr.c, IJG's quality
// scaling of the Annex K tables and the Annex K Huffman tables.
//
// Plain C entry points at the end; loaded with ctypes.
#include "jpeg_codec.h"

#include <algorithm>
#include <cstdlib>
#include <cstring>

namespace mxhost {
namespace {

// zigzag index -> natural index, with 16 spare entries so that a corrupt
// run length cannot index past the block (libjpeg's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef int64_t JLONG;

inline JLONG Descale(JLONG x, int n) { return (x + (JLONG(1) << (n - 1))) >> n; }

// ---------------------------------------------------------------------------
// range limiting (jdmaster.c prepare_range_limit_table)
// ---------------------------------------------------------------------------

struct RangeLimit {
  uint8_t simple[5 * 256 + 128];   // simple[256 + x] = clamp(x)
  const uint8_t* idct;              // idct[x & 1023] for a centred x
  RangeLimit() {
    uint8_t* t = simple + 256;
    std::memset(simple, 0, 256);
    for (int i = 0; i < 256; ++i) t[i] = static_cast<uint8_t>(i);
    uint8_t* p = t + 128;           // post-IDCT table starts here
    for (int i = 128; i < 512; ++i) p[i] = 255;
    std::memset(p + 512, 0, 512 - 128);
    std::memcpy(p + 1024 - 128, t, 128);
    idct = p;
  }
};
const RangeLimit kRange;
const int kRangeMask = 1023;

inline uint8_t IdctOut(JLONG x) { return kRange.idct[static_cast<int>(x) & kRangeMask]; }

// ---------------------------------------------------------------------------
// inverse DCTs: jidctint.c (8x8) and jidctred.c (4x4, 2x2, 1x1)
// ---------------------------------------------------------------------------

const int CONST_BITS = 13, PASS1_BITS = 2;
const JLONG FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
            FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
            FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
            FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
            FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
            FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const JLONG FIX_0_211164243 = 1730, FIX_0_509795579 = 4176,
            FIX_0_601344887 = 4926, FIX_0_720959822 = 5906,
            FIX_0_850430095 = 6967, FIX_1_061594337 = 8697,
            FIX_1_272758580 = 10426, FIX_1_451774981 = 11893,
            FIX_2_172734803 = 17799, FIX_3_624509785 = 29692;

void IdctIslow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    JLONG z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    JLONG z1 = (z2 + z3) * FIX_0_541196100;
    JLONG tmp2 = z1 + z3 * (-FIX_1_847759065);
    JLONG tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    JLONG tmp0 = (z2 + z3) * (JLONG(1) << CONST_BITS);
    JLONG tmp1 = (z2 - z3) * (JLONG(1) << CONST_BITS);
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    JLONG z4 = tmp1 + tmp3;
    JLONG z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(Descale(tmp10 + tmp3, s));
    wp[56] = static_cast<int>(Descale(tmp10 - tmp3, s));
    wp[8] = static_cast<int>(Descale(tmp11 + tmp2, s));
    wp[48] = static_cast<int>(Descale(tmp11 - tmp2, s));
    wp[16] = static_cast<int>(Descale(tmp12 + tmp1, s));
    wp[40] = static_cast<int>(Descale(tmp12 - tmp1, s));
    wp[24] = static_cast<int>(Descale(tmp13 + tmp0, s));
    wp[32] = static_cast<int>(Descale(tmp13 - tmp0, s));
  }
  const int s = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = IdctOut(Descale(wp[0], PASS1_BITS + 3));
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    JLONG z2 = wp[2], z3 = wp[6];
    JLONG z1 = (z2 + z3) * FIX_0_541196100;
    JLONG tmp2 = z1 + z3 * (-FIX_1_847759065);
    JLONG tmp3 = z1 + z2 * FIX_0_765366865;
    JLONG tmp0 = (JLONG(wp[0]) + wp[4]) * (JLONG(1) << CONST_BITS);
    JLONG tmp1 = (JLONG(wp[0]) - wp[4]) * (JLONG(1) << CONST_BITS);
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    JLONG z4 = tmp1 + tmp3;
    JLONG z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = IdctOut(Descale(tmp10 + tmp3, s));
    op[7] = IdctOut(Descale(tmp10 - tmp3, s));
    op[1] = IdctOut(Descale(tmp11 + tmp2, s));
    op[6] = IdctOut(Descale(tmp11 - tmp2, s));
    op[2] = IdctOut(Descale(tmp12 + tmp1, s));
    op[5] = IdctOut(Descale(tmp12 - tmp1, s));
    op[3] = IdctOut(Descale(tmp13 + tmp0, s));
    op[4] = IdctOut(Descale(tmp13 - tmp0, s));
  }
}

void Idct4x4(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;          // the second pass does not read column 4
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      wp[0] = wp[8] = wp[16] = wp[24] = dc;
      continue;
    }
    JLONG tmp0 = JLONG(ip[0] * qp[0]) * (JLONG(1) << (CONST_BITS + 1));
    JLONG z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    JLONG tmp2 = z2 * FIX_1_847759065 + z3 * (-FIX_0_765366865);
    JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    JLONG z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    JLONG z4 = ip[8] * qp[8];
    tmp0 = z1 * (-FIX_0_211164243) + z2 * FIX_1_451774981 +
           z3 * (-FIX_2_172734803) + z4 * FIX_1_061594337;
    tmp2 = z1 * (-FIX_0_509795579) + z2 * (-FIX_0_601344887) +
           z3 * FIX_0_899976223 + z4 * FIX_2_562915447;
    const int s = CONST_BITS - PASS1_BITS + 1;
    wp[0] = static_cast<int>(Descale(tmp10 + tmp2, s));
    wp[24] = static_cast<int>(Descale(tmp10 - tmp2, s));
    wp[8] = static_cast<int>(Descale(tmp12 + tmp0, s));
    wp[16] = static_cast<int>(Descale(tmp12 - tmp0, s));
  }
  const int s = CONST_BITS + PASS1_BITS + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = IdctOut(Descale(wp[0], PASS1_BITS + 3));
      op[0] = op[1] = op[2] = op[3] = v;
      continue;
    }
    JLONG tmp0 = JLONG(wp[0]) * (JLONG(1) << (CONST_BITS + 1));
    JLONG tmp2 = JLONG(wp[2]) * FIX_1_847759065 + JLONG(wp[6]) * (-FIX_0_765366865);
    JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    JLONG z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * (-FIX_0_211164243) + z2 * FIX_1_451774981 +
           z3 * (-FIX_2_172734803) + z4 * FIX_1_061594337;
    tmp2 = z1 * (-FIX_0_509795579) + z2 * (-FIX_0_601344887) +
           z3 * FIX_0_899976223 + z4 * FIX_2_562915447;
    op[0] = IdctOut(Descale(tmp10 + tmp2, s));
    op[3] = IdctOut(Descale(tmp10 - tmp2, s));
    op[1] = IdctOut(Descale(tmp12 + tmp0, s));
    op[2] = IdctOut(Descale(tmp12 - tmp0, s));
  }
}

void Idct2x2(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[24] == 0 && ip[40] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      wp[0] = wp[8] = dc;
      continue;
    }
    JLONG tmp10 = JLONG(ip[0] * qp[0]) * (JLONG(1) << (CONST_BITS + 2));
    JLONG tmp0 = JLONG(ip[56] * qp[56]) * (-FIX_0_720959822);
    tmp0 += JLONG(ip[40] * qp[40]) * FIX_0_850430095;
    tmp0 += JLONG(ip[24] * qp[24]) * (-FIX_1_272758580);
    tmp0 += JLONG(ip[8] * qp[8]) * FIX_3_624509785;
    const int s = CONST_BITS - PASS1_BITS + 2;
    wp[0] = static_cast<int>(Descale(tmp10 + tmp0, s));
    wp[8] = static_cast<int>(Descale(tmp10 - tmp0, s));
  }
  const int s = CONST_BITS + PASS1_BITS + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[3] == 0 && wp[5] == 0 && wp[7] == 0) {
      op[0] = op[1] = IdctOut(Descale(wp[0], PASS1_BITS + 3));
      continue;
    }
    JLONG tmp10 = JLONG(wp[0]) * (JLONG(1) << (CONST_BITS + 2));
    JLONG tmp0 = JLONG(wp[7]) * (-FIX_0_720959822) + JLONG(wp[5]) * FIX_0_850430095 +
                 JLONG(wp[3]) * (-FIX_1_272758580) + JLONG(wp[1]) * FIX_3_624509785;
    op[0] = IdctOut(Descale(tmp10 + tmp0, s));
    op[1] = IdctOut(Descale(tmp10 - tmp0, s));
  }
}

void Idct1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  out[0] = IdctOut(Descale(in[0] * q[0], 3));
}

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c jpeg_make_d_derived_tbl, 9-bit lookahead)
// ---------------------------------------------------------------------------

const int kLookBits = 9;

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];   // (length << 8) | symbol; 0 = longer code

  bool Derive() {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) {
        if (p >= 256) return false;
        huffsize[p++] = l;
      }
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) return false;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l)
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
          look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    present = true;
    return true;
  }
};

// ---------------------------------------------------------------------------
// entropy-coded segment reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;      // bits in acc
  int real = 0;       // of which come from the stream (the rest are zeros
                      // fed after a marker, as libjpeg feeds them)
  bool marker = false;
  bool overrun = false;

  void Reset(const uint8_t* at) {
    p = at;
    acc = 0;
    nbits = real = 0;
    marker = false;
  }
  void Fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (!marker && p < end) {
        uint8_t c = *p;
        if (c == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
            real += 8;
          } else {
            marker = true;          // p stays on the marker's first 0xFF
            p = q - 1;
          }
        } else {
          b = c;
          ++p;
          real += 8;
        }
      } else {
        marker = true;
      }
      acc |= b << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t Peek(int n) {
    if (nbits < n) Fill();
    return static_cast<uint32_t>(acc >> (64 - n));
  }
  inline void Skip(int n) {
    acc <<= n;
    nbits -= n;
    real -= n;
    if (real < 0) overrun = true;
  }
  inline int Get(int n) {
    if (n == 0) return 0;
    uint32_t v = Peek(n);
    Skip(n);
    return static_cast<int>(v);
  }
  int Decode(const HuffTable& t) {
    uint32_t look = Peek(16);
    uint16_t e = t.look[look >> (16 - kLookBits)];
    if (e) {
      Skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(look >> (16 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(look >> (16 - l));
    }
    if (l > 16) return -1;
    Skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int Extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------

typedef void (*IdctFn)(const int16_t*, const uint16_t*, uint8_t*, int);

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;              // Huffman tables of the current scan
  int dc_pred = 0;
  int ssize = 8;                   // DCT_scaled_size
  int bw = 0, bh = 0;              // blocks allocated (MCU-padded)
  int plane_w = 0, plane_h = 0;
  int ds_w = 0, ds_h = 0;          // downsampled size (libjpeg's)
  std::vector<uint8_t> plane;
};

inline int DivUp(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  std::string Run(int denom, int out_c, std::vector<uint8_t>* px, int* oh,
                  int* ow, int* oc) {
    denom_ = denom;
    std::string err = Parse();
    if (!err.empty()) return err;
    if (!saw_scan_) return "corrupt JPEG data: no scan";
    return Output(out_c, px, oh, ow, oc);
  }

 private:
  const uint8_t* data_;
  size_t size_;
  int denom_ = 1;
  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  Component comp_[3];
  int ncomp_ = 0, height_ = 0, width_ = 0;
  int maxh_ = 1, maxv_ = 1, mcux_ = 0, mcuy_ = 0, min_ssize_ = 8;
  int restart_interval_ = 0;
  bool saw_frame_ = false, saw_scan_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;

  static int U16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  std::string Parse() {
    const uint8_t* p = data_;
    const uint8_t* end = data_ + size_;
    if (size_ < 4 || p[0] != 0xFF || p[1] != 0xD8) return "not a JPEG stream (no SOI)";
    p += 2;
    while (true) {
      // next marker: skip fill bytes (and, leniently, any garbage)
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return saw_scan_ ? "" : "corrupt JPEG data: premature end";
      int m = *p++;
      if (m == 0xD9) return "";                    // EOI
      if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (p + 2 > end) return "corrupt JPEG data: truncated marker";
      int len = U16(p);
      if (len < 2 || p + len > end) return "corrupt JPEG data: bad marker length";
      const uint8_t* seg = p + 2;
      int n = len - 2;
      p += len;
      std::string err;
      switch (m) {
        case 0xC0: case 0xC1:
          err = Frame(seg, n);
          break;
        case 0xC2: return "progressive JPEG is not supported";
        case 0xC3: return "lossless JPEG is not supported";
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          return "hierarchical (differential) JPEG is not supported";
        case 0xC9: case 0xCA: case 0xCB: case 0xCC:
          return "arithmetic-coded JPEG is not supported";
        case 0xC4:
          err = Dht(seg, n);
          break;
        case 0xDB:
          err = Dqt(seg, n);
          break;
        case 0xDD:
          if (n < 2) return "corrupt JPEG data: bad DRI";
          restart_interval_ = U16(seg);
          break;
        case 0xDA: {
          if (!saw_frame_) return "corrupt JPEG data: scan before frame";
          const uint8_t* after = nullptr;
          err = Scan(seg, n, p, end, &after);
          if (!err.empty()) return err;
          saw_scan_ = true;
          p = after;
          break;
        }
        case 0xE0:
          if (n >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xEE:
          if (n >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        default:
          break;                                   // APPn, COM, DNL...
      }
      if (!err.empty()) return err;
    }
  }

  std::string Dqt(const uint8_t* s, int n) {
    while (n > 0) {
      int pq = s[0] >> 4, tq = s[0] & 15;
      if (tq > 3) return "corrupt JPEG data: bad DQT table";
      int need = 1 + 64 * (pq ? 2 : 1);
      if (n < need) return "corrupt JPEG data: short DQT";
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] = pq ? static_cast<uint16_t>(U16(s + 1 + 2 * i))
                                  : s[1 + i];
      qt_present_[tq] = true;
      s += need;
      n -= need;
    }
    return "";
  }

  std::string Dht(const uint8_t* s, int n) {
    while (n > 0) {
      if (n < 17) return "corrupt JPEG data: short DHT";
      int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) return "corrupt JPEG data: bad DHT table";
      HuffTable& t = tc ? ac_[th] : dc_[th];
      int count = 0;
      t.bits[0] = 0;
      for (int i = 1; i <= 16; ++i) {
        t.bits[i] = s[i];
        count += s[i];
      }
      if (count > 256 || n < 17 + count) return "corrupt JPEG data: bad DHT";
      std::memcpy(t.vals, s + 17, count);
      if (!t.Derive()) return "corrupt JPEG data: bad Huffman table";
      s += 17 + count;
      n -= 17 + count;
    }
    return "";
  }

  std::string Frame(const uint8_t* s, int n) {
    if (saw_frame_) return "corrupt JPEG data: two frames";
    if (n < 6) return "corrupt JPEG data: short SOF";
    if (s[0] != 8) return std::to_string(s[0]) + "-bit JPEG is not supported";
    height_ = U16(s + 1);
    width_ = U16(s + 3);
    ncomp_ = s[5];
    if (height_ == 0 || width_ == 0) return "corrupt JPEG data: empty image (or DNL)";
    if (ncomp_ == 4) return "CMYK (4-component) JPEG is not supported";
    if (ncomp_ != 1 && ncomp_ != 3)
      return std::to_string(ncomp_) + "-component JPEG is not supported";
    if (n < 6 + 3 * ncomp_) return "corrupt JPEG data: short SOF";
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        return "JPEG sampling factors other than 1 and 2 are not supported";
      if (c.tq > 3) return "corrupt JPEG data: bad quantization table id";
    }
    saw_frame_ = true;
    maxh_ = maxv_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
      maxh_ = std::max(maxh_, comp_[i].h);
      maxv_ = std::max(maxv_, comp_[i].v);
    }
    if (ncomp_ == 1) comp_[0].h = comp_[0].v = maxh_ = maxv_ = 1;
    mcux_ = DivUp(width_, 8 * maxh_);
    mcuy_ = DivUp(height_, 8 * maxv_);
    // jdmaster.c: the smallest DCT size from the scale, then each
    // component's grown while it saves upsampling
    min_ssize_ = 8 / denom_;
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      int ss = min_ssize_;
      while (ss < 8 && (maxh_ * min_ssize_) % (c.h * ss * 2) == 0 &&
             (maxv_ * min_ssize_) % (c.v * ss * 2) == 0)
        ss *= 2;
      c.ssize = ss;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.plane_w = c.bw * ss;
      c.plane_h = c.bh * ss;
      c.ds_w = DivUp(int64_t(width_) * c.h * ss, int64_t(maxh_) * 8);
      c.ds_h = DivUp(int64_t(height_) * c.v * ss, int64_t(maxv_) * 8);
      c.plane.assign(static_cast<size_t>(c.plane_w) * c.plane_h, 0);
    }
    return "";
  }

  static IdctFn Idct(int ssize) {
    switch (ssize) {
      case 1: return Idct1x1;
      case 2: return Idct2x2;
      case 4: return Idct4x4;
      default: return IdctIslow;
    }
  }

  std::string Scan(const uint8_t* s, int n, const uint8_t* data,
                   const uint8_t* end, const uint8_t** after) {
    if (n < 1) return "corrupt JPEG data: short SOS";
    int ns = s[0];
    if (ns < 1 || ns > ncomp_ || n < 4 + 2 * ns) return "corrupt JPEG data: bad SOS";
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (int k = 0; k < ncomp_; ++k)
        if (comp_[k].id == id) c = &comp_[k];
      if (!c) return "corrupt JPEG data: scan names an unknown component";
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc_[c->td].present || !ac_[c->ta].present)
        return "corrupt JPEG data: missing Huffman table";
      if (!qt_present_[c->tq]) return "corrupt JPEG data: missing quantization table";
      c->dc_pred = 0;
      sc[i] = c;
    }
    const uint8_t* t = s + 1 + 2 * ns;
    if (t[0] != 0 || t[1] != 63 || t[2] != 0)
      return "progressive JPEG is not supported";

    BitReader br;
    br.end = end;
    br.Reset(data);
    int16_t coef[64];
    int64_t nmcu, mcus_x;
    if (ns == 1) {
      Component& c = *sc[0];
      mcus_x = DivUp(DivUp(int64_t(width_) * c.h, maxh_), 8);
      nmcu = mcus_x * DivUp(DivUp(int64_t(height_) * c.v, maxv_), 8);
    } else {
      mcus_x = mcux_;
      nmcu = int64_t(mcux_) * mcuy_;
    }
    int64_t todo = restart_interval_;
    for (int64_t m = 0; m < nmcu; ++m) {
      if (restart_interval_ && todo == 0) {
        // byte-align, then expect RSTn
        const uint8_t* q = br.p;
        while (q + 1 < end && !(q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7)) ++q;
        if (q + 1 >= end) return "corrupt JPEG data: missing restart marker";
        br.Reset(q + 2);
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        todo = restart_interval_;
      }
      int64_t my = m / mcus_x, mx = m % mcus_x;
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
        IdctFn idct = Idct(c.ssize);
        for (int v = 0; v < nv; ++v)
          for (int h = 0; h < nh; ++h) {
            if (!DecodeBlock(&br, dc_[c.td], ac_[c.ta], &c.dc_pred, coef))
              return "corrupt JPEG data: bad Huffman code";
            int64_t by = my * nv + v, bx = mx * nh + h;
            uint8_t* dst = c.plane.data() + by * c.ssize * c.plane_w + bx * c.ssize;
            idct(coef, qt_[c.tq], dst, c.plane_w);
          }
      }
      if (br.overrun) return "corrupt JPEG data: premature end of data segment";
      if (restart_interval_) --todo;
    }
    *after = br.p;
    return "";
  }

  static bool DecodeBlock(BitReader* br, const HuffTable& dc, const HuffTable& ac,
                          int* pred, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    int s = br->Decode(dc);
    if (s < 0 || s > 16) return false;
    if (s) *pred += Extend(br->Get(s), s);
    coef[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br->Decode(ac);
      if (rs < 0) return false;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(Extend(br->Get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }

  // -- upsampling (jdsample.c) and color conversion (jdcolor.c) ---------

  // One component brought to the output's resolution (out_w x out_h).
  void Upsample(const Component& c, int out_w, int out_h, std::vector<uint8_t>* o) {
    int h_in = c.h * c.ssize / min_ssize_, v_in = c.v * c.ssize / min_ssize_;
    int rh = maxh_ / h_in, rv = maxv_ / v_in;
    bool fancy = min_ssize_ > 1;
    const int W = c.ds_w, H = c.ds_h, S = c.plane_w;
    const uint8_t* pl = c.plane.data();
    o->assign(static_cast<size_t>(out_w) * out_h, 0);
    uint8_t* out = o->data();
    auto row = [&](int r) { return pl + static_cast<size_t>(std::min(std::max(r, 0), H - 1)) * S; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < out_h; ++y) std::memcpy(out + size_t(y) * out_w, row(y), out_w);
      return;
    }
    std::vector<int> tmp(2 * W + 2);
    if (rh == 2 && rv == 1 && fancy && W > 2) {
      for (int y = 0; y < out_h; ++y) {
        const uint8_t* in = row(y);
        uint8_t* op = out + size_t(y) * out_w;
        std::vector<uint8_t> line(2 * W);
        line[0] = in[0];
        line[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < W - 1; ++x) {
          int v = in[x] * 3;
          line[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          line[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        line[2 * W - 2] = static_cast<uint8_t>((in[W - 1] * 3 + in[W - 2] + 1) >> 2);
        line[2 * W - 1] = in[W - 1];
        std::memcpy(op, line.data(), out_w);
      }
      return;
    }
    if (rh == 1 && rv == 2 && fancy) {
      for (int y = 0; y < out_h; ++y) {
        int r = y >> 1;
        const uint8_t* near = row(r);
        const uint8_t* far = (y & 1) ? row(r + 1) : row(r - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* op = out + size_t(y) * out_w;
        for (int x = 0; x < out_w; ++x)
          op[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      }
      return;
    }
    if (rh == 2 && rv == 2 && fancy && W > 2) {
      std::vector<uint8_t> line(2 * W);
      for (int y = 0; y < out_h; ++y) {
        int r = y >> 1;
        const uint8_t* near = row(r);
        const uint8_t* far = (y & 1) ? row(r + 1) : row(r - 1);
        for (int x = 0; x < W; ++x) tmp[x] = near[x] * 3 + far[x];
        line[0] = static_cast<uint8_t>((tmp[0] * 4 + 8) >> 4);
        line[1] = static_cast<uint8_t>((tmp[0] * 3 + tmp[1] + 7) >> 4);
        for (int x = 1; x < W - 1; ++x) {
          line[2 * x] = static_cast<uint8_t>((tmp[x] * 3 + tmp[x - 1] + 8) >> 4);
          line[2 * x + 1] = static_cast<uint8_t>((tmp[x] * 3 + tmp[x + 1] + 7) >> 4);
        }
        line[2 * W - 2] = static_cast<uint8_t>((tmp[W - 1] * 3 + tmp[W - 2] + 8) >> 4);
        line[2 * W - 1] = static_cast<uint8_t>((tmp[W - 1] * 4 + 7) >> 4);
        std::memcpy(out + size_t(y) * out_w, line.data(), out_w);
      }
      return;
    }
    // replication (h2v1_upsample, h2v2_upsample, int_upsample)
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* in = pl + static_cast<size_t>(y / rv) * S;
      uint8_t* op = out + size_t(y) * out_w;
      for (int x = 0; x < out_w; ++x) op[x] = in[x / rh];
    }
  }

  std::string Output(int out_c, std::vector<uint8_t>* px, int* oh, int* ow, int* oc) {
    const int W = DivUp(width_, denom_), H = DivUp(height_, denom_);
    if (out_c == 0) out_c = ncomp_ == 1 ? 1 : 3;
    *oh = H;
    *ow = W;
    *oc = out_c;
    px->assign(static_cast<size_t>(W) * H * out_c, 0);
    uint8_t* out = px->data();
    if (ncomp_ == 1) {
      std::vector<uint8_t> y;
      Upsample(comp_[0], W, H, &y);
      for (size_t i = 0; i < y.size(); ++i)
        for (int k = 0; k < out_c; ++k) out[i * out_c + k] = y[i];
      return "";
    }
    std::vector<uint8_t> p0, p1, p2;
    Upsample(comp_[0], W, H, &p0);
    Upsample(comp_[1], W, H, &p1);
    Upsample(comp_[2], W, H, &p2);
    bool rgb;
    if (jfif_) rgb = false;
    else if (adobe_) rgb = adobe_transform_ == 0;
    else rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
    static int cr_r[256], cb_b[256];
    static JLONG cr_g[256], cb_g[256];
    static bool init = [] {
      const int SCALEBITS = 16;
      const JLONG ONE_HALF = JLONG(1) << (SCALEBITS - 1);
      auto fix = [](double x) { return JLONG(x * 65536.0 + 0.5); };
      for (int i = 0, x = -128; i < 256; ++i, ++x) {
        cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + ONE_HALF;
      }
      return true;
    }();
    (void)init;
    const uint8_t* lim = kRange.simple + 256;
    size_t n = static_cast<size_t>(W) * H;
    for (size_t i = 0; i < n; ++i) {
      int r, g, b;
      if (rgb) {
        r = p0[i];
        g = p1[i];
        b = p2[i];
      } else {
        int y = p0[i], cb = p1[i], cr = p2[i];
        r = lim[y + cr_r[cr]];
        g = lim[y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16)];
        b = lim[y + cb_b[cb]];
      }
      if (out_c == 3) {
        out[3 * i] = static_cast<uint8_t>(r);
        out[3 * i + 1] = static_cast<uint8_t>(g);
        out[3 * i + 2] = static_cast<uint8_t>(b);
      } else {   // PIL's convert("L")
        out[i] = static_cast<uint8_t>((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
      }
    }
    return "";
  }
};

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  const uint8_t* bits;     // bits[1..16]
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];
  void Derive() {
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code_ = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code_++;
      code_ <<= 1;
      ++si;
    }
    std::memset(size, 0, sizeof(size));
    for (int i = 0; i < p; ++i) {
      code[vals[i]] = static_cast<uint16_t>(huffcode[i]);
      size[vals[i]] = static_cast<uint8_t>(huffsize[i]);
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int n = 0;
  void Put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }
  void Flush() {
    if (n > 0) Put(0x7F, 7);   // pad with 1-bits
    n = 0;
    acc = 0;
  }
};

void FdctIslow(int* d) {   // jfdctint.c, in place on 64 centred samples
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    JLONG tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    JLONG tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    JLONG tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    JLONG tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << PASS1_BITS));
    JLONG z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = static_cast<int>(Descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS));
    p[6] = static_cast<int>(Descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS));
    z1 = tmp4 + tmp7;
    JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    JLONG z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(Descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
    p[5] = static_cast<int>(Descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
    p[3] = static_cast<int>(Descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
    p[1] = static_cast<int>(Descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    JLONG tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    JLONG tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    JLONG tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    JLONG tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(Descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = static_cast<int>(Descale(tmp10 - tmp11, PASS1_BITS));
    JLONG z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = static_cast<int>(Descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS));
    p[48] = static_cast<int>(Descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS));
    z1 = tmp4 + tmp7;
    JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    JLONG z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(Descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
    p[40] = static_cast<int>(Descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
    p[24] = static_cast<int>(Descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
    p[8] = static_cast<int>(Descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
  }
}

// jcdctmgr.c compute_reciprocal / quantize, with libjpeg-turbo's 16-bit
// DCT elements: round(x / divisor) through a reciprocal and a shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor MakeDivisor(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);     // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq & 0xFFFF, c & 0xFFFF, r};
}

inline int Quantize(int x, const Divisor& d) {
  bool neg = x < 0;
  uint32_t a = static_cast<uint32_t>((neg ? -x : x) + static_cast<int>(d.corr));
  int q = static_cast<int>(static_cast<uint16_t>((a * d.recip) >> d.shift));
  return neg ? -q : q;
}

struct EncComponent {
  int id, h, v, tq, tbl;
  int wib, hib;              // width / height in blocks (libjpeg's)
  int pw, ph;                // plane size (MCU-padded)
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

void EmitMarker(std::vector<uint8_t>* o, int m, const std::vector<uint8_t>& body) {
  o->push_back(0xFF);
  o->push_back(static_cast<uint8_t>(m));
  size_t len = body.size() + 2;
  o->push_back(static_cast<uint8_t>(len >> 8));
  o->push_back(static_cast<uint8_t>(len & 0xFF));
  o->insert(o->end(), body.begin(), body.end());
}

void EncodeBlock(BitWriter* bw, const int16_t* coef, int* pred, const EncTable& dc,
                 const EncTable& ac) {
  int diff = coef[0] - *pred;
  *pred = coef[0];
  int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
  int nb = 0;
  while (t) {
    ++nb;
    t >>= 1;
  }
  bw->Put(dc.code[nb], dc.size[nb]);
  if (nb) bw->Put(static_cast<uint32_t>(t2), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw->Put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    t = v < 0 ? -v : v;
    t2 = v < 0 ? v - 1 : v;
    nb = 0;
    while (t) {
      ++nb;
      t >>= 1;
    }
    int sym = (run << 4) + nb;
    bw->Put(ac.code[sym], ac.size[sym]);
    bw->Put(static_cast<uint32_t>(t2), nb);
    run = 0;
  }
  if (run > 0) bw->Put(ac.code[0], ac.size[0]);
}

}  // namespace

std::string JpegDecode(const uint8_t* data, size_t size, int scale_denom,
                       int out_channels, std::vector<uint8_t>* pixels,
                       int* height, int* width, int* channels) {
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 && scale_denom != 8)
    return "JPEG scale must be 1/1, 1/2, 1/4 or 1/8";
  if (out_channels != 0 && out_channels != 1 && out_channels != 3)
    return "JPEG output channels must be 0, 1 or 3";
  Decoder d(data, size);
  return d.Run(scale_denom, out_channels, pixels, height, width, channels);
}

std::string JpegEncode(const uint8_t* px, int H, int W, int C, int quality,
                       std::vector<uint8_t>* out) {
  if (H <= 0 || W <= 0 || H > 65535 || W > 65535) return "JPEG size must be 1..65535";
  if (C != 1 && C != 3) return "JPEG encodes 1 or 3 channels";
  quality = std::min(100, std::max(1, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint8_t qt[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((t ? kStdChromaQ : kStdLumaQ)[i] * long(scale) + 50L) / 100L;
      qt[t][i] = static_cast<uint8_t>(std::min(255L, std::max(1L, v)));
    }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = MakeDivisor(uint32_t(qt[t][i]) << 3);

  int nc = C;
  EncComponent comp[3];
  const int samp = nc == 3 ? 2 : 1;       // 4:2:0 for color, 1x1 for gray
  for (int i = 0; i < nc; ++i) {
    comp[i].id = i + 1;
    comp[i].h = comp[i].v = i == 0 ? samp : 1;
    comp[i].tq = comp[i].tbl = i == 0 ? 0 : 1;
  }
  const int maxh = samp, maxv = samp;
  const int mcux = DivUp(W, 8 * maxh), mcuy = DivUp(H, 8 * maxv);

  // color conversion (jccolor.c rgb_ycc_convert) at full resolution
  std::vector<uint8_t> full[3];
  size_t npx = static_cast<size_t>(W) * H;
  if (nc == 1) {
    full[0].assign(px, px + npx);
  } else {
    const JLONG ONE_HALF = JLONG(1) << 15, CBCR = JLONG(128) << 16;
    auto fix = [](double x) { return JLONG(x * 65536.0 + 0.5); };
    JLONG ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    JLONG rcb = -fix(0.16874), gcb = -fix(0.33126), half = fix(0.5);
    JLONG gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (int k = 0; k < 3; ++k) full[k].resize(npx);
    for (size_t i = 0; i < npx; ++i) {
      JLONG r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = static_cast<uint8_t>((ry * r + gy * g + by * b + ONE_HALF) >> 16);
      full[1][i] = static_cast<uint8_t>((rcb * r + gcb * g + half * b + CBCR + ONE_HALF - 1) >> 16);
      full[2][i] = static_cast<uint8_t>((half * r + gcr * g + bcr * b + CBCR + ONE_HALF - 1) >> 16);
    }
  }
  // h2v2 downsampling with libjpeg's edge replication (jcprepct.c,
  // jcsample.c)
  for (int i = 0; i < nc; ++i) {
    EncComponent& c = comp[i];
    int rh = maxh / c.h, rv = maxv / c.v;
    int dsw = DivUp(int64_t(W) * c.h, maxh), dsh = DivUp(int64_t(H) * c.v, maxv);
    c.wib = DivUp(dsw, 8);
    c.hib = DivUp(dsh, 8);
    c.pw = mcux * c.h * 8;
    c.ph = mcuy * c.v * 8;
    c.plane.assign(static_cast<size_t>(c.pw) * c.ph, 0);
    const uint8_t* src = full[i].data();
    auto at = [&](int y, int x) {
      return static_cast<int>(src[static_cast<size_t>(std::min(y, H - 1)) * W + std::min(x, W - 1)]);
    };
    int cols = c.wib * 8;
    int rows = dsh;     // computed rows; the rest replicate the last one
    for (int y = 0; y < rows; ++y) {
      uint8_t* o = c.plane.data() + static_cast<size_t>(y) * c.pw;
      if (rh == 1 && rv == 1) {
        for (int x = 0; x < cols; ++x) o[x] = static_cast<uint8_t>(at(y, x));
      } else {
        int bias = 1;
        for (int x = 0; x < cols; ++x) {
          o[x] = static_cast<uint8_t>((at(2 * y, 2 * x) + at(2 * y, 2 * x + 1) +
                                       at(2 * y + 1, 2 * x) + at(2 * y + 1, 2 * x + 1) +
                                       bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int y = rows; y < c.hib * 8; ++y)
      std::memcpy(c.plane.data() + static_cast<size_t>(y) * c.pw,
                  c.plane.data() + static_cast<size_t>(rows - 1) * c.pw, cols);
  }

  EncTable dct[2], act[2];
  dct[0] = EncTable{kDcLumaBits, kDcVals, 12, {}, {}};
  dct[1] = EncTable{kDcChromaBits, kDcVals, 12, {}, {}};
  act[0] = EncTable{kAcLumaBits, kAcLumaVals, 162, {}, {}};
  act[1] = EncTable{kAcChromaBits, kAcChromaVals, 162, {}, {}};
  for (int t = 0; t < 2; ++t) {
    dct[t].Derive();
    act[t].Derive();
  }

  out->clear();
  out->push_back(0xFF);
  out->push_back(0xD8);
  EmitMarker(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < (nc == 1 ? 1 : 2); ++t) {
    std::vector<uint8_t> b{static_cast<uint8_t>(t)};
    for (int i = 0; i < 64; ++i) b.push_back(qt[t][kNatural[i]]);
    EmitMarker(out, 0xDB, b);
  }
  {
    std::vector<uint8_t> b{8, static_cast<uint8_t>(H >> 8), static_cast<uint8_t>(H & 255),
                           static_cast<uint8_t>(W >> 8), static_cast<uint8_t>(W & 255),
                           static_cast<uint8_t>(nc)};
    for (int i = 0; i < nc; ++i) {
      b.push_back(static_cast<uint8_t>(comp[i].id));
      b.push_back(static_cast<uint8_t>((comp[i].h << 4) | comp[i].v));
      b.push_back(static_cast<uint8_t>(comp[i].tq));
    }
    EmitMarker(out, 0xC0, b);
  }
  for (int t = 0; t < (nc == 1 ? 1 : 2); ++t)
    for (int cls = 0; cls < 2; ++cls) {
      const EncTable& e = cls ? act[t] : dct[t];
      std::vector<uint8_t> b{static_cast<uint8_t>((cls << 4) | t)};
      for (int l = 1; l <= 16; ++l) b.push_back(e.bits[l]);
      b.insert(b.end(), e.vals, e.vals + e.nvals);
      EmitMarker(out, 0xC4, b);
    }
  {
    std::vector<uint8_t> b{static_cast<uint8_t>(nc)};
    for (int i = 0; i < nc; ++i) {
      b.push_back(static_cast<uint8_t>(comp[i].id));
      b.push_back(static_cast<uint8_t>((comp[i].tbl << 4) | comp[i].tbl));
    }
    b.push_back(0);
    b.push_back(63);
    b.push_back(0);
    EmitMarker(out, 0xDA, b);
  }
  BitWriter bw{out};
  int ws[64];
  int16_t coef[4][64];
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx)
      for (int i = 0; i < nc; ++i) {
        EncComponent& c = comp[i];
        int nh = nc == 1 ? 1 : c.h, nv = nc == 1 ? 1 : c.v;
        int blk = 0;
        for (int v = 0; v < nv; ++v)
          for (int h = 0; h < nh; ++h, ++blk) {
            int by = my * nv + v, bx = mx * nh + h;
            int16_t* cf = coef[blk];
            if (by >= c.hib) {               // a row of dummy blocks
              std::memset(cf, 0, sizeof(coef[0]));
              cf[0] = coef[v * nh - 1][0];
            } else if (bx >= c.wib) {        // dummy blocks at the right
              std::memset(cf, 0, sizeof(coef[0]));
              cf[0] = coef[blk - 1][0];
            } else {
              for (int r = 0; r < 8; ++r) {
                const uint8_t* row = c.plane.data() + static_cast<size_t>(by * 8 + r) * c.pw + bx * 8;
                for (int k = 0; k < 8; ++k) ws[8 * r + k] = row[k] - 128;
              }
              FdctIslow(ws);
              for (int k = 0; k < 64; ++k)
                cf[k] = static_cast<int16_t>(Quantize(static_cast<int16_t>(ws[k]), div[c.tq][k]));
            }
            EncodeBlock(&bw, cf, &c.dc_pred, dct[c.tbl], act[c.tbl]);
          }
      }
  bw.Flush();
  out->push_back(0xFF);
  out->push_back(0xD9);
  return "";
}

}  // namespace mxhost

extern "C" {

static void SetErr(const std::string& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

// *out is malloc'd (free with mxhost_free); 0, or -1 with `err`.
int mxjpeg_decode(const uint8_t* data, size_t size, int scale_denom,
                  int out_channels, uint8_t** out, int* h, int* w, int* c,
                  char* err, int errlen) {
  std::vector<uint8_t> px;
  std::string e = mxhost::JpegDecode(data, size, scale_denom, out_channels,
                                     &px, h, w, c);
  if (!e.empty()) {
    SetErr(e, err, errlen);
    return -1;
  }
  *out = static_cast<uint8_t*>(std::malloc(px.size()));
  std::memcpy(*out, px.data(), px.size());
  return 0;
}

int mxjpeg_encode(const uint8_t* px, int h, int w, int c, int quality,
                  uint8_t** out, size_t* n, char* err, int errlen) {
  std::vector<uint8_t> buf;
  std::string e = mxhost::JpegEncode(px, h, w, c, quality, &buf);
  if (!e.empty()) {
    SetErr(e, err, errlen);
    return -1;
  }
  *out = static_cast<uint8_t*>(std::malloc(buf.size()));
  std::memcpy(*out, buf.data(), buf.size());
  *n = buf.size();
  return 0;
}

void mxhost_free(void* p) { std::free(p); }

}  // extern "C"
