// Baseline, extended-sequential and progressive JPEG (ITU-T T.81,
// Huffman coding, 8-bit samples): the entropy decoders and encoder and
// the integer transforms around them, written to give the bytes and
// pixels of libjpeg-turbo's default paths, which Pillow and OpenCV use:
//
//   decode  jdhuff.c and jdphuff.c (entropy), jidctint.c jpeg_idct_islow with its
//           range-limit table, jdsample.c (fancy upsampling: h2v1, h1v2,
//           h2v2; int_upsample otherwise), jdcolor.c ycc_rgb_convert and
//           ycck_cmyk_convert, then Pillow's CMYK;I unpacker and its
//           Convert.c cmyk2rgb for four components;
//   encode  jccolor.c rgb_ycc_convert, jcsample.c h2v2_downsample with
//           jcprepct.c's edge replication, jfdctint.c jpeg_fdct_islow,
//           jcdctmgr.c quantize (16-bit reciprocals, as in the SIMD
//           build), jchuff.c with 0xFF00 stuffing and 1-bit padding.
//
// Integer arithmetic only, so every build (-march=native included)
// gives the same bytes.  Marker parsing, table checks and the file
// layout are in dspfun_tpu_torch/io/jpeg.py; this file sees tables and
// one scan's entropy-coded data at a time.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <new>
#include <vector>

namespace {

// zigzag index -> natural index, with the 16 extra entries libjpeg keeps
// so that a corrupt run past 63 lands on the last coefficient
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum {
  kOk = 0,
  kTruncated = -1,     // the data ended inside the scan
  kBadCode = -2,       // no Huffman code matches
  kPastMarker = -3,    // a code needed bits beyond the segment's end
  kBadRestart = -4,    // the next marker was not the expected RSTn
  kBadTable = -5,      // a Huffman table does not form a prefix code
  kNoMemory = -6,
  kSimdRange = -7,     // a block whose IDCT libjpeg-turbo's SIMD build holds otherwise
};

// ---- Huffman tables -------------------------------------------------------

struct DecodeTable {
  int32_t maxcode[17];   // largest code of each length, -1 if none
  int32_t valoffset[17];
  uint8_t look_len[256];  // codes of up to 8 bits, by their first byte
  uint8_t look_val[256];
  uint8_t val[256];
};

// bits: 16 counts, then the values (jdhuff.c jpeg_make_d_derived_tbl)
int make_decode_table(const uint8_t* spec, DecodeTable* t) {
  const uint8_t* bits = spec;
  const uint8_t* vals = spec + 16;
  int size[257];
  int n = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) {
      if (n >= 256) return kBadTable;
      size[n++] = l;
    }
  size[n] = 0;
  uint32_t code[256];
  uint32_t c = 0;
  int si = size[0], p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return kBadTable;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t->valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += bits[l - 1];
      t->maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  std::memcpy(t->val, vals, 256);
  std::memset(t->look_len, 0, sizeof t->look_len);
  std::memset(t->look_val, 0, sizeof t->look_val);
  p = 0;
  for (int l = 1; l <= 8; l++)
    for (int i = 0; i < bits[l - 1]; i++, p++) {
      int lo = static_cast<int>(code[p]) << (8 - l);
      for (int k = 0; k < (1 << (8 - l)); k++) {
        t->look_len[lo + k] = static_cast<uint8_t>(l);
        t->look_val[lo + k] = vals[p];
      }
    }
  return kOk;
}

struct EncodeTable {
  uint32_t code[256];
  uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl (the table is checked in Python)
void make_encode_table(const uint8_t* spec, EncodeTable* t) {
  const uint8_t* bits = spec;
  const uint8_t* vals = spec + 16;
  std::memset(t, 0, sizeof *t);
  uint32_t c = 0;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l - 1]; i++, p++) {
      t->code[vals[p]] = c++;
      t->size[vals[p]] = static_cast<uint8_t>(l);
    }
    c <<= 1;
  }
}

// ---- entropy decoding -----------------------------------------------------

// The bit reader of jdhuff.c: 0xFF00 is a data 0xFF, fill 0xFFs before a
// marker are skipped, and at a marker the reader supplies zeros.  Taking
// one of those zeros (not merely looking at it) is an error here.
struct BitReader {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint64_t buf = 0;   // bits, most significant first
  int bits = 0;
  int fake = 0;       // zero bits supplied past a marker, at the bottom of buf
  bool at_marker = false;
  int64_t marker_pos = 0;  // first 0xFF of the marker the reader stopped at
  bool eof = false;        // the data ended before any marker
  bool lenient = false;    // libjpeg's recovery: take the zeros, count a bad code as 0
  bool insufficient = false;  // a zero past the marker was taken (lenient only)

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = eof = true;
          marker_pos = n;
        } else if (d[pos] != 0xFF) {
          c = d[pos++];
        } else {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q >= n) {
            at_marker = eof = true;
            marker_pos = pos;
          } else if (d[q] == 0) {
            c = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;
            marker_pos = pos;
          }
        }
      }
      if (at_marker) fake += 8;
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek16() {
    if (bits < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  bool skip(int k) {
    buf <<= k;
    bits -= k;
    if (bits >= fake) return true;
    insufficient = lenient;
    return lenient;
  }
  int get(int k, int32_t* out) {
    if (bits < k) fill();
    *out = static_cast<int32_t>(buf >> (64 - k));
    if (!skip(k)) return eof ? kTruncated : kPastMarker;
    return kOk;
  }
  int decode(const DecodeTable& t, int* sym) {
    uint32_t look = peek16();
    int l = t.look_len[look >> 8];
    if (l) {
      *sym = t.look_val[look >> 8];
    } else {
      for (l = 9; l <= 16; l++) {
        int32_t code = static_cast<int32_t>(look >> (16 - l));
        if (code <= t.maxcode[l]) {
          *sym = t.val[(code + t.valoffset[l]) & 0xFF];
          break;
        }
      }
      if (l > 16) {
        if (!lenient) return kBadCode;
        *sym = 0;  // jdhuff.c jpeg_huff_decode: 17 bits taken, a zero faked
        if (bits < 17) fill();
        l = 17;
      }
    }
    if (!skip(l)) return eof ? kTruncated : kPastMarker;
    return kOk;
  }
  // drop the buffered bits and start again at byte p
  void restart(int64_t p) {
    pos = p;
    buf = 0;
    bits = fake = 0;
    at_marker = eof = false;
  }
  // where the data after the last bit taken ends: the marker the reader
  // stopped at, or the first byte it has not read
  int64_t end() const { return at_marker ? marker_pos : pos; }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v + static_cast<int32_t>(~0u << s) + 1 : v;
}

int decode_block(BitReader& br, const DecodeTable& dc, const DecodeTable& ac,
                 int32_t* pred, int16_t* blk) {
  int s, err;
  int32_t r = 0;
  if ((err = br.decode(dc, &s))) return err;
  if (s) {
    if ((err = br.get(s, &r))) return err;
    r = extend(r, s);
  }
  *pred = static_cast<int32_t>(static_cast<uint32_t>(*pred) + static_cast<uint32_t>(r));
  blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64; k++) {
    if ((err = br.decode(ac, &s))) return err;
    int run = s >> 4;
    s &= 15;
    if (s) {
      k += run;
      if ((err = br.get(s, &r))) return err;
      blk[kNatural[k]] = static_cast<int16_t>(extend(r, s));
    } else {
      if (run != 15) break;
      k += 15;
    }
  }
  return kOk;
}

// next marker at or after p (jdmarker.c next_marker): the index of its
// code byte, garbage, fill 0xFFs and 0xFF00 pairs skipped; -1 if none
int64_t next_marker(const uint8_t* d, int64_t n, int64_t p) {
  for (;;) {
    while (p < n && d[p] != 0xFF) p++;
    while (p < n && d[p] == 0xFF) p++;
    if (p >= n) return -1;
    if (d[p] != 0) return p;
    p++;
  }
}

// ---- progressive scans (jdphuff.c) ----------------------------------------
// Each decodes one block's part of a scan: the DC band's first pass
// (the difference of the value >> Al) and its refinements (one bit), an
// AC band's first pass (values << Al, end-of-band runs counted in
// *eobrun across blocks) and its refinements (a sign bit for each newly
// nonzero coefficient, a correction bit for each one already nonzero).

int dc_first(BitReader& br, const DecodeTable& dc, int al, int32_t* pred, int16_t* blk) {
  int s, err;
  int32_t r = 0;
  if ((err = br.decode(dc, &s))) return err;
  if (s) {
    if ((err = br.get(s, &r))) return err;
    r = extend(r, s);
  }
  *pred = static_cast<int32_t>(static_cast<uint32_t>(*pred) + static_cast<uint32_t>(r));
  blk[0] = static_cast<int16_t>(static_cast<uint32_t>(*pred) << al);
  return kOk;
}

int dc_refine(BitReader& br, int al, int16_t* blk) {
  int32_t bit;
  int err = br.get(1, &bit);
  if (!err && bit) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  return err;
}

int ac_first(BitReader& br, const DecodeTable& ac, int ss, int se, int al, uint32_t* eobrun,
             int16_t* blk) {
  if (*eobrun) {
    (*eobrun)--;
    return kOk;
  }
  int s, err;
  int32_t r;
  for (int k = ss; k <= se; k++) {
    if ((err = br.decode(ac, &s))) return err;
    int run = s >> 4;
    s &= 15;
    if (s) {
      k += run;
      if ((err = br.get(s, &r))) return err;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(r, s)) << al);
    } else if (run == 15) {
      k += 15;
    } else {
      *eobrun = 1u << run;
      if (run) {
        if ((err = br.get(run, &r))) return err;
        *eobrun += static_cast<uint32_t>(r);
      }
      (*eobrun)--;
      break;
    }
  }
  return kOk;
}

// a correction bit for the nonzero coefficient c: 1 adds 1 << Al to its
// magnitude, unless that bit is already set
inline int correct(BitReader& br, int p1, int16_t* c) {
  int32_t bit;
  int err = br.get(1, &bit);
  if (!err && bit && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c - p1);
  return err;
}

int ac_refine(BitReader& br, const DecodeTable& ac, int ss, int se, int al, uint32_t* eobrun,
              int16_t* blk) {
  const int p1 = 1 << al;
  int k = ss, s, err;
  int32_t bit;
  if (*eobrun == 0) {
    for (; k <= se; k++) {
      if ((err = br.decode(ac, &s))) return err;
      int r = s >> 4;
      s &= 15;
      if (s) {                      // a newly nonzero coefficient (size 1), its sign
        if ((err = br.get(1, &bit))) return err;
        s = bit ? p1 : -p1;
      } else if (r != 15) {         // EOBr: the rest of this band, and 2^r + bits - 1 more
        *eobrun = 1u << r;
        if (r) {
          if ((err = br.get(r, &bit))) return err;
          *eobrun += static_cast<uint32_t>(bit);
        }
        break;
      }
      // past r zero coefficients (and ZRL's 16), correcting the nonzero ones
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          if ((err = correct(br, p1, c))) return err;
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= se);
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (*eobrun > 0) {
    for (; k <= se; k++) {
      int16_t* c = blk + kNatural[k];
      if (*c != 0 && (err = correct(br, p1, c))) return err;
    }
    (*eobrun)--;
  }
  return kOk;
}

// The MCUs of one scan, restart markers between intervals: block(ci, c,
// blk) decodes component ci's next block, reset() clears the predictors
// (and end-of-band run) at each restart.  Once the reader has taken bits
// past the data (br.insufficient, lenient only), the MCUs after the one
// that took them are left as they are (jdhuff.c decode_mcu).
template <class Block, class Reset>
int scan_blocks(const uint8_t* data, int64_t len, BitReader& br, int ncomp,
                const int32_t* comps, int mcus_x, int mcus_y, int restart,
                int16_t* const* coefs, Block block, Reset reset) {
  int err = kOk;
  int64_t left = restart;
  int next_rst = 0;
  for (int my = 0; my < mcus_y && !err; my++) {
    for (int mx = 0; mx < mcus_x && !err; mx++) {
      if (restart && left == 0) {
        int64_t m = next_marker(data, len, br.end());
        if (m < 0) return kTruncated;
        if (data[m] != 0xD0 + next_rst) {
          br.restart(m);
          return kBadRestart;
        }
        br.restart(m + 1);
        next_rst = (next_rst + 1) & 7;
        left = restart;
        reset();
      }
      const bool skip_mcu = br.insufficient;
      for (int ci = 0; ci < ncomp && !err && !skip_mcu; ci++) {
        const int32_t* c = comps + 5 * ci;
        int h = c[0], v = c[1];
        int64_t stride = c[2];
        for (int by = 0; by < v && !err; by++)
          for (int bx = 0; bx < h && !err; bx++)
            err = block(ci, c, coefs[ci] + ((static_cast<int64_t>(my) * v + by) * stride +
                                             static_cast<int64_t>(mx) * h + bx) * 64);
      }
      left--;
    }
  }
  return err;
}

// ---- inverse DCT, upsampling, colour ---------------------------------------

constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// jdmaster.c prepare_range_limit_table, the post-IDCT half: x & 1023
// -> sample (wrapping as libjpeg's table wraps)
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};
const IdctLimit kIdctLimit;

inline uint8_t clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }

// 1 where v lies outside int16, where the SIMD build's 16-bit lanes wrap
// or saturate
inline int out16(int64_t v) { return static_cast<uint64_t>(v + 32768) > 65535u; }

// A block whose dequantised coefficients sum, in absolute value, to at most
// this keeps every product, sum and pass-1 output of idct_islow within 16
// bits and every output within the range-limit table's wrap: with islow's
// largest weight 11363 (of 2048 in pass 1, of 2^18 in pass 2), a pass-1
// output is at most 5.549 times its column's sum, plus 1, and an output at
// most 0.0434 times its row of those, plus 1 (506.8 at this sum).
constexpr int32_t kNarrowL1 = 2100;

// jidctint.c jpeg_idct_islow; q holds the quantisation table as the SIMD
// build's 16-bit ISLOW_MULT_TYPE.  Returns whether the block met a value
// that libjpeg-turbo's SIMD islow IDCT holds otherwise than its C version,
// which this follows: a dequantised coefficient, a sum of them or a
// pass-1 output past 16 bits, or an output past the wrap of the
// range-limit table (checked only past kNarrowL1).  Only damaged streams
// have such blocks.
bool idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int32_t dq[64];
  int ws[64];
  int32_t l1 = 0;
  for (int i = 0; i < 64; i++) {
    dq[i] = in[i] * q[i];
    int32_t a = dq[i] < 0 ? -dq[i] : dq[i];
    l1 += a < 8192 ? a : 8192;
  }
  const bool wide = l1 > kNarrowL1;
  int odd = 0;
  if (wide)
    for (int i = 0; i < 64; i++) odd |= out16(dq[i]);
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int32_t* dp = dq + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      for (int r = 0; r < 8; r++) wp[8 * r] = static_cast<int>(int64_t{dp[0]} * 4);
      continue;
    }
    int64_t z2 = dp[16];
    int64_t z3 = dp[48];
    if (wide)
      odd |= out16(z2 + z3) | out16(int64_t{dp[0]} + dp[32]) | out16(int64_t{dp[0]} - dp[32]);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dp[0];
    z3 = dp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dp[56];
    tmp1 = dp[40];
    tmp2 = dp[24];
    tmp3 = dp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    if (wide) odd |= out16(z1) | out16(z2) | out16(z3) | out16(z4) | out16(z3 + z4);
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  if (wide)
    for (int i = 0; i < 64; i++) odd |= out16(ws[i]);
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<int64_t>(r) * stride;
    constexpr int s = CONST_BITS + PASS1_BITS + 3;
    int64_t z2 = wp[2], z3 = wp[6];
    if (wide)
      odd |= out16(z2 + z3) | out16(int64_t{wp[0]} + wp[4]) | out16(int64_t{wp[0]} - wp[4]) |
             out16(int64_t{wp[7]} + wp[1]) | out16(int64_t{wp[5]} + wp[3]) |
             out16(int64_t{wp[7]} + wp[3]) | out16(int64_t{wp[5]} + wp[1]) |
             out16(int64_t{wp[7]} + wp[3] + wp[5] + wp[1]);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{wp[0]} + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t{wp[0]} - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int64_t d[8] = {descale(tmp10 + tmp3, s), descale(tmp11 + tmp2, s),
                          descale(tmp12 + tmp1, s), descale(tmp13 + tmp0, s),
                          descale(tmp13 - tmp0, s), descale(tmp12 - tmp1, s),
                          descale(tmp11 - tmp2, s), descale(tmp10 - tmp3, s)};
    for (int x = 0; x < 8; x++) op[x] = lim[d[x] & 1023];
    if (wide)  // the table wraps where the SIMD build saturates
      for (int64_t v : d) odd |= static_cast<uint64_t>(v + 512) > 1023u;
  }
  return odd != 0;
}

// One component's samples [ph, pw] (ph, pw: its downsampled height and
// width, the rest of its blocks cropped) brought to [H, W] as
// jdsample.c brings them: the fancy filters where libjpeg picks them,
// replication otherwise.  Neighbours past an edge are the edge sample,
// as jdmainct.c's context rows and the filters' end columns make them.
void upsample(const uint8_t* in, int64_t istride, int ph, int pw, int hexp, int vexp,
              uint8_t* out, int H, int W) {
  bool h2 = hexp == 2 && pw > 2;
  if (hexp == 1 && vexp == 1) {
    for (int y = 0; y < H; y++) std::memcpy(out + static_cast<int64_t>(y) * W, in + y * istride, W);
  } else if (h2 && vexp == 1) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; y++) {
      const uint8_t* ip = in + y * istride;
      uint8_t* op = out + static_cast<int64_t>(y) * W;
      for (int x = 0; x < W; x++) {
        int i = x >> 1;
        int nb = (x & 1) ? ip[i + 1 < pw ? i + 1 : i] : ip[i > 0 ? i - 1 : 0];
        op[x] = static_cast<uint8_t>((ip[i] * 3 + nb + 1 + (x & 1)) >> 2);
      }
    }
  } else if (hexp == 1 && vexp == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int i = y >> 1;
      int j = (y & 1) ? (i + 1 < ph ? i + 1 : i) : (i > 0 ? i - 1 : 0);
      const uint8_t* p0 = in + i * istride;
      const uint8_t* p1 = in + j * istride;
      uint8_t* op = out + static_cast<int64_t>(y) * W;
      int bias = 1 + (y & 1);
      for (int x = 0; x < W; x++) op[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
    }
  } else if (h2 && vexp == 2) {  // h2v2_fancy_upsample
    std::vector<int> colsum(pw);
    for (int y = 0; y < H; y++) {
      int i = y >> 1;
      int j = (y & 1) ? (i + 1 < ph ? i + 1 : i) : (i > 0 ? i - 1 : 0);
      const uint8_t* p0 = in + i * istride;
      const uint8_t* p1 = in + j * istride;
      for (int c = 0; c < pw; c++) colsum[c] = p0[c] * 3 + p1[c];
      uint8_t* op = out + static_cast<int64_t>(y) * W;
      for (int x = 0; x < W; x++) {
        int c = x >> 1;
        if (x & 1)
          op[x] = static_cast<uint8_t>((colsum[c] * 3 + colsum[c + 1 < pw ? c + 1 : c] + 7) >> 4);
        else
          op[x] = static_cast<uint8_t>((colsum[c] * 3 + colsum[c > 0 ? c - 1 : 0] + 8) >> 4);
      }
    }
  } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
    for (int y = 0; y < H; y++) {
      const uint8_t* ip = in + (y / vexp) * istride;
      uint8_t* op = out + static_cast<int64_t>(y) * W;
      for (int x = 0; x < W; x++) op[x] = ip[x / hexp];
    }
  }
}

// jdcolor.c's tables at SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + 32768) >> 16);
      cb_b[i] = static_cast<int>((116130 * x + 32768) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
  }
};
const YccTables kYcc;

// ---- forward path ------------------------------------------------------------

// jccolor.c rgb_ycc_convert's tables at SCALEBITS 16: R, G, B => Y (with
// ONE_HALF), R, G, B => Cb (with CBCR_OFFSET + ONE_HALF - 1), G, B => Cr
// (R => Cr is B => Cb's)
struct RgbYccTables {
  int32_t t[8][256];
  RgbYccTables() {
    for (int32_t i = 0; i < 256; i++) {
      t[0][i] = 19595 * i;
      t[1][i] = 38470 * i;
      t[2][i] = 7471 * i + 32768;
      t[3][i] = -11059 * i;
      t[4][i] = -21709 * i;
      t[5][i] = 32768 * i + (128 << 16) + 32768 - 1;
      t[6][i] = -27439 * i;
      t[7][i] = -5329 * i;
    }
  }
};
const RgbYccTables kRgbYcc;

// jfdctint.c jpeg_fdct_islow on samples - 128, in place
void fdct_islow(int* d) {
  for (int r = 0; r < 8; r++) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int16_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = static_cast<int16_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int s = CONST_BITS - PASS1_BITS;
    p[2] = static_cast<int16_t>(descale(z1 + tmp13 * FIX_0_765366865, s));
    p[6] = static_cast<int16_t>(descale(z1 + tmp12 * -FIX_1_847759065, s));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    p[7] = static_cast<int16_t>(descale(tmp4 + z1 + z3, s));
    p[5] = static_cast<int16_t>(descale(tmp5 + z2 + z4, s));
    p[3] = static_cast<int16_t>(descale(tmp6 + z2 + z3, s));
    p[1] = static_cast<int16_t>(descale(tmp7 + z1 + z4, s));
  }
  for (int c = 0; c < 8; c++) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int16_t>(descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = static_cast<int16_t>(descale(tmp10 - tmp11, PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int s = CONST_BITS + PASS1_BITS;
    p[16] = static_cast<int16_t>(descale(z1 + tmp13 * FIX_0_765366865, s));
    p[48] = static_cast<int16_t>(descale(z1 + tmp12 * -FIX_1_847759065, s));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    p[56] = static_cast<int16_t>(descale(tmp4 + z1 + z3, s));
    p[40] = static_cast<int16_t>(descale(tmp5 + z2 + z4, s));
    p[24] = static_cast<int16_t>(descale(tmp6 + z2 + z3, s));
    p[8] = static_cast<int16_t>(descale(tmp7 + z1 + z4, s));
  }
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM (the SIMD build)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jcdctmgr.c quantize
inline int16_t quantize(int v, const Divisor& dv) {
  if (v < 0) {
    uint32_t p = (static_cast<uint32_t>(-v) + dv.corr) * dv.recip;
    return static_cast<int16_t>(-static_cast<int>(static_cast<uint16_t>(p >> dv.shift)));
  }
  uint32_t p = (static_cast<uint32_t>(v) + dv.corr) * dv.recip;
  return static_cast<int16_t>(static_cast<uint16_t>(p >> dv.shift));
}

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t c = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(c);
      if (c == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);
  }
};

// jchuff.c encode_one_block
void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc, const EncodeTable& dc,
                  const EncodeTable& ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    bw.put(ac.code[i], ac.size[i]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// FDCT and quantisation of the 8x8 block at (x, y) of a plane
void forward_block(const uint8_t* plane, int64_t stride, int64_t x, int64_t y,
                   const Divisor* dv, int16_t* blk) {
  int d[64];
  for (int r = 0; r < 8; r++) {
    const uint8_t* p = plane + (y + r) * stride + x;
    for (int c = 0; c < 8; c++) d[8 * r + c] = p[c] - 128;
  }
  fdct_islow(d);
  for (int i = 0; i < 64; i++) blk[i] = quantize(static_cast<int16_t>(d[i]), dv[i]);
}

}  // namespace

extern "C" {

// Decode one scan's entropy-coded data, starting at data[pos].
//   comps: per component of the scan, 5 ints: h, v (blocks per MCU;
//          1, 1 for a one-component scan), the row stride of its
//          coefficient array in blocks, its DC table and AC table (0-3);
//   mcus_x, mcus_y: MCUs per row and rows of MCUs (for a one-component
//          scan, the component's blocks);
//   tables: 8 tables of 16 counts + 256 values, DC 0-3 then AC 0-3;
//   restart: MCUs per restart interval, 0 for none;
//   lenient: libjpeg's recovery from a scan that runs out of data or holds
//          a bad code (BitReader::lenient; a stream without restarts);
//   coefs: per component, int16 [rows][stride][64] in natural order.
// Returns 0 and *end (the first byte after the scan's data), or a
// negative code (see the enum above; *end = where decoding stopped).
int jpg_decode_scan(const uint8_t* data, int64_t len, int64_t pos, int ncomp,
                    const int32_t* comps, int mcus_x, int mcus_y, const uint8_t* tables,
                    int restart, int lenient, int16_t* const* coefs, int64_t* end) {
  DecodeTable* dts = new (std::nothrow) DecodeTable[8];
  if (!dts) return kNoMemory;
  int err = kOk;
  bool used[8] = {};
  for (int ci = 0; ci < ncomp; ci++) used[comps[5 * ci + 3] & 3] = used[4 + (comps[5 * ci + 4] & 3)] = true;
  for (int i = 0; i < 8 && !err; i++)
    if (used[i]) err = make_decode_table(tables + 272 * i, &dts[i]);
  BitReader br{data, len, pos};
  br.lenient = lenient != 0;
  int32_t pred[4] = {0, 0, 0, 0};
  if (!err)
    err = scan_blocks(
        data, len, br, ncomp, comps, mcus_x, mcus_y, restart, coefs,
        [&](int ci, const int32_t* c, int16_t* blk) {
          return decode_block(br, dts[c[3] & 3], dts[4 + (c[4] & 3)], &pred[ci], blk);
        },
        [&] { std::memset(pred, 0, sizeof pred); });
  *end = br.end();
  delete[] dts;
  return err;
}

// Decode one scan of a progressive file (SOF2) into the coefficients it
// refines: arguments as jpg_decode_scan's, and the scan's spectral
// selection ss..se (zigzag positions; 0..0 is the DC band, which may
// interleave components; an AC band holds one) and successive
// approximation ah, al (ah 0: the first pass, else a refinement of bit
// al).  A DC refinement needs no table, an AC band only its AC table.
int jpg_decode_progressive(const uint8_t* data, int64_t len, int64_t pos, int ncomp,
                           const int32_t* comps, int mcus_x, int mcus_y,
                           const uint8_t* tables, int restart, int ss, int se, int ah, int al,
                           int16_t* const* coefs, int64_t* end) {
  DecodeTable* dts = new (std::nothrow) DecodeTable[8];
  if (!dts) return kNoMemory;
  int err = kOk;
  const bool dc = ss == 0;
  bool used[8] = {};
  for (int ci = 0; ci < ncomp; ci++) {
    if (dc && ah == 0) used[comps[5 * ci + 3] & 3] = true;
    if (!dc) used[4 + (comps[5 * ci + 4] & 3)] = true;
  }
  for (int i = 0; i < 8 && !err; i++)
    if (used[i]) err = make_decode_table(tables + 272 * i, &dts[i]);
  BitReader br{data, len, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  uint32_t eobrun = 0;
  auto reset = [&] {
    std::memset(pred, 0, sizeof pred);
    eobrun = 0;
  };
  if (err) {
  } else if (dc && ah == 0) {
    err = scan_blocks(data, len, br, ncomp, comps, mcus_x, mcus_y, restart, coefs,
                      [&](int ci, const int32_t* c, int16_t* blk) {
                        return dc_first(br, dts[c[3] & 3], al, &pred[ci], blk);
                      }, reset);
  } else if (dc) {
    err = scan_blocks(data, len, br, ncomp, comps, mcus_x, mcus_y, restart, coefs,
                      [&](int, const int32_t*, int16_t* blk) { return dc_refine(br, al, blk); },
                      reset);
  } else {
    const DecodeTable& ac = dts[4 + (comps[4] & 3)];
    if (ah == 0)
      err = scan_blocks(data, len, br, ncomp, comps, mcus_x, mcus_y, restart, coefs,
                        [&](int, const int32_t*, int16_t* blk) {
                          return ac_first(br, ac, ss, se, al, &eobrun, blk);
                        }, reset);
    else
      err = scan_blocks(data, len, br, ncomp, comps, mcus_x, mcus_y, restart, coefs,
                        [&](int, const int32_t*, int16_t* blk) {
                          return ac_refine(br, ac, ss, se, al, &eobrun, blk);
                        }, reset);
  }
  *end = br.end();
  delete[] dts;
  return err;
}

// Samples of the decoded image from every component's coefficients.
//   comps: per component, 4 ints: h, v (sampling factors), the row
//          stride of its coefficient array in blocks, its rows of blocks;
//   qtables: per component, 64 quantisation values in natural order;
//   colorspace: 0 gray (one component), 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK
//               (four components);
//   out: uint8 [height][width][ncomp], or [height][width][3] for CMYK and
//        YCCK: libjpeg's CMYK output (YCCK's first three components
//        through ycc_rgb_convert's tables, then 255 - x; K as stored), each
//        sample inverted as Pillow's CMYK;I rawmode reads it, then RGB by
//        Pillow's cmyk2rgb: nk - MULDIV255(x, nk) with nk = 255 - K.
// Returns 0, or kSimdRange where a block's IDCT met a value that
// libjpeg-turbo's SIMD build, which Pillow runs, holds otherwise than its C
// version (idct_islow): the pixels would differ from Pillow's.
int jpg_reconstruct(int ncomp, const int32_t* comps, int width, int height,
                    const int16_t* const* coefs, const uint16_t* qtables, int colorspace,
                    uint8_t* out) {
  int hmax = 1, vmax = 1;
  for (int ci = 0; ci < ncomp; ci++) {
    if (comps[4 * ci] > hmax) hmax = comps[4 * ci];
    if (comps[4 * ci + 1] > vmax) vmax = comps[4 * ci + 1];
  }
  std::vector<std::vector<uint8_t>> full(ncomp);
  std::vector<uint8_t> plane;
  for (int ci = 0; ci < ncomp; ci++) {
    const int32_t* c = comps + 4 * ci;
    int h = c[0], v = c[1];
    int64_t bw = c[2], bh = c[3];
    int64_t stride = bw * 8;
    plane.assign(static_cast<size_t>(stride * bh * 8), 0);
    int16_t q[64];
    for (int i = 0; i < 64; i++) q[i] = static_cast<int16_t>(qtables[64 * ci + i]);
    bool odd = false;
    for (int64_t by = 0; by < bh; by++)
      for (int64_t bx = 0; bx < bw; bx++)
        odd |= idct_islow(coefs[ci] + (by * bw + bx) * 64, q,
                          plane.data() + by * 8 * stride + bx * 8, static_cast<int>(stride));
    if (odd) return kSimdRange;
    // jdmaster.c: the component's own size, rounded up
    int pw = static_cast<int>((static_cast<int64_t>(width) * h + hmax - 1) / hmax);
    int ph = static_cast<int>((static_cast<int64_t>(height) * v + vmax - 1) / vmax);
    full[ci].resize(static_cast<size_t>(width) * height);
    upsample(plane.data(), stride, ph, pw, hmax / h, vmax / v, full[ci].data(), height, width);
  }
  int64_t npx = static_cast<int64_t>(width) * height;
  if (colorspace == 1) {
    const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
    for (int64_t i = 0; i < npx; i++) {
      int yy = y[i];
      out[3 * i] = clamp255(yy + kYcc.cr_r[cr[i]]);
      out[3 * i + 1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb[i]] + kYcc.cr_g[cr[i]]) >> 16));
      out[3 * i + 2] = clamp255(yy + kYcc.cb_b[cb[i]]);
    }
  } else if (colorspace == 3 || colorspace == 4) {
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data(),
                  *c3 = full[3].data();
    for (int64_t i = 0; i < npx; i++) {
      int cmy[3] = {c0[i], c1[i], c2[i]};
      if (colorspace == 4) {
        int yy = c0[i];
        cmy[0] = 255 - clamp255(yy + kYcc.cr_r[c2[i]]);
        cmy[1] = 255 - clamp255(yy + static_cast<int>((kYcc.cb_g[c1[i]] + kYcc.cr_g[c2[i]]) >> 16));
        cmy[2] = 255 - clamp255(yy + kYcc.cb_b[c1[i]]);
      }
      int nk = c3[i];                   // 255 - (255 - K): Pillow's inverted K
      for (int k = 0; k < 3; k++) {
        int t = (255 - cmy[k]) * nk + 128;
        out[3 * i + k] = static_cast<uint8_t>(nk - (((t >> 8) + t) >> 8));
      }
    }
  } else {
    for (int ci = 0; ci < ncomp; ci++) {
      const uint8_t* p = full[ci].data();
      for (int64_t i = 0; i < npx; i++) out[ncomp * i + ci] = p[i];
    }
  }
  return kOk;
}

// Entropy-coded data of an RGB image [height][width][3] as libjpeg's
// defaults write it: YCbCr, Y at 2x2 and Cb, Cr at 1x1, one interleaved
// scan, no restarts.  qtables: luma then chroma, natural order;
// htables: DC0, AC0, DC1, AC1 (16 counts + 256 values each).  *out is
// malloc'd (free it with jpg_free).
int jpg_encode_rgb(const uint8_t* rgb, int height, int width, const uint16_t* qtables,
                   const uint8_t* htables, uint8_t** out, int64_t* out_len) {
  const int64_t W = width, H = height;
  const int64_t mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const int64_t ybw = (W + 7) / 8, ybh = (H + 7) / 8;  // luma blocks that hold the image
  // luma: [mcuy*16][ybw*8]; chroma: [mcuy*8][mcux*8]
  const int64_t yw = ybw * 8, yh = mcuy * 16, cw = mcux * 8, ch = mcuy * 8;
  std::vector<uint8_t> yp(static_cast<size_t>(yw * yh)), cbp(static_cast<size_t>(cw * ch)),
      crp(static_cast<size_t>(cw * ch));
  const auto& tab = kRgbYcc.t;
  // full-resolution chroma of two rows, widened to 2 * cw by
  // replicating the last column (jcsample.c expand_right_edge)
  std::vector<int32_t> cb2(static_cast<size_t>(2 * 2 * cw)), cr2(static_cast<size_t>(2 * 2 * cw));
  const int64_t crows = (H + 1) / 2;
  for (int64_t r = 0; r < 2 * crows; r++) {
    const uint8_t* src = rgb + std::min(r, H - 1) * W * 3;  // jcprepct.c: pad to 2 rows
    int64_t half = r & 1;
    int32_t* cbr = cb2.data() + half * 2 * cw;
    int32_t* crr = cr2.data() + half * 2 * cw;
    uint8_t* yr = r < H ? yp.data() + r * yw : nullptr;
    for (int64_t x = 0; x < W; x++) {
      int R = src[3 * x], G = src[3 * x + 1], B = src[3 * x + 2];
      if (yr) yr[x] = static_cast<uint8_t>((tab[0][R] + tab[1][G] + tab[2][B]) >> 16);
      cbr[x] = (tab[3][R] + tab[4][G] + tab[5][B]) >> 16;
      crr[x] = (tab[5][R] + tab[6][G] + tab[7][B]) >> 16;
    }
    for (int64_t x = W; x < 2 * cw; x++) {
      cbr[x] = cbr[W - 1];
      crr[x] = crr[W - 1];
    }
    if (yr)
      for (int64_t x = W; x < yw; x++) yr[x] = yr[W - 1];
    if (half) {  // jcsample.c h2v2_downsample, bias 1, 2, 1, 2, ... along the row
      uint8_t* cbo = cbp.data() + (r / 2) * cw;
      uint8_t* cro = crp.data() + (r / 2) * cw;
      for (int64_t x = 0; x < cw; x++) {
        int bias = 1 + (x & 1);
        cbo[x] = static_cast<uint8_t>((cb2[2 * x] + cb2[2 * x + 1] + cb2[2 * cw + 2 * x] +
                                       cb2[2 * cw + 2 * x + 1] + bias) >> 2);
        cro[x] = static_cast<uint8_t>((cr2[2 * x] + cr2[2 * x + 1] + cr2[2 * cw + 2 * x] +
                                       cr2[2 * cw + 2 * x + 1] + bias) >> 2);
      }
    }
  }
  // jcprepct.c: the last rows repeated to the bottom of the last iMCU row
  for (int64_t r = H; r < yh; r++) std::memcpy(yp.data() + r * yw, yp.data() + (H - 1) * yw, yw);
  for (int64_t r = crows; r < ch; r++) {
    std::memcpy(cbp.data() + r * cw, cbp.data() + (crows - 1) * cw, cw);
    std::memcpy(crp.data() + r * cw, crp.data() + (crows - 1) * cw, cw);
  }

  Divisor dv[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) dv[t][i] = reciprocal(static_cast<uint32_t>(qtables[64 * t + i]) << 3);
  EncodeTable et[4];
  for (int t = 0; t < 4; t++) make_encode_table(htables + 272 * t, &et[t]);

  BitWriter bw;
  bw.out.reserve(static_cast<size_t>(W * H / 4 + 1024));
  int last[3] = {0, 0, 0};
  int16_t blk[6][64];
  for (int64_t my = 0; my < mcuy; my++)
    for (int64_t mx = 0; mx < mcux; mx++) {
      // jccoefct.c compress_data: dummy blocks past the image's blocks
      // hold the previous block's DC and no AC
      for (int j = 0; j < 2; j++)
        for (int i = 0; i < 2; i++) {
          int16_t* b = blk[2 * j + i];
          int64_t bx = 2 * mx + i, by = 2 * my + j;
          if (by >= ybh) {
            std::memset(blk[2 * j], 0, 2 * 64 * sizeof(int16_t));
            blk[2 * j][0] = blk[2 * j + 1][0] = blk[2 * j - 1][0];
            break;
          }
          if (bx >= ybw) {
            std::memset(b, 0, 64 * sizeof(int16_t));
            b[0] = blk[2 * j + i - 1][0];
          } else {
            forward_block(yp.data(), yw, bx * 8, by * 8, dv[0], b);
          }
        }
      forward_block(cbp.data(), cw, mx * 8, my * 8, dv[1], blk[4]);
      forward_block(crp.data(), cw, mx * 8, my * 8, dv[1], blk[5]);
      for (int k = 0; k < 4; k++) encode_block(bw, blk[k], &last[0], et[0], et[1]);
      encode_block(bw, blk[4], &last[1], et[2], et[3]);
      encode_block(bw, blk[5], &last[2], et[2], et[3]);
    }
  bw.flush();
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(bw.out.size() ? bw.out.size() : 1));
  if (!buf) return kNoMemory;
  if (!bw.out.empty()) std::memcpy(buf, bw.out.data(), bw.out.size());
  *out = buf;
  *out_len = static_cast<int64_t>(bw.out.size());
  return kOk;
}

void jpg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
