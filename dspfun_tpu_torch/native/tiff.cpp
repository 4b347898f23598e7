// The strip decompressors of TIFF that need a loop over bits or bytes:
// LZW (compression 5) and PackBits (32773), written to give the bytes of
// libtiff's tif_lzw.c and tif_packbits.c, which Pillow and OpenCV use.
//
//   LZW       MSB-first codes of 9 to 12 bits, ClearCode 256 and EOI 257;
//             the width grows one code early (at 511, 1023 and 2047), and
//             the table holds 5119 entries (libtiff's CSIZE) before it is
//             corrupt; a strip must start with a ClearCode; a string that
//             does not fit is cut at the end of the strip; a code past the
//             table's next entry is corrupt.  libtiff's old LSB-first form
//             (LZWDecodeCompat, which libtiff takes for a whole image when
//             its first strip starts with a byte 0 and the next byte's low
//             bit set) reads its codes from the low bits up and grows the
//             width one code later (at 512, 1024 and 2048), otherwise the
//             same;
//   PackBits  a header byte n: 0..127 copies n + 1 bytes, -1..-127
//             repeats the next byte 1 - n times, -128 is a no-op; runs past
//             the end of the strip are cut.
//
// Each function fills at most n_out bytes and returns how many it wrote;
// fewer than n_out means the strip's data ended early ("Not enough data"
// in libtiff), which dspfun_tpu_torch/io/imgcodecs.py turns into an
// error.  Deflate is the standard library's zlib there, and the
// predictor is undone there with numpy.
//
// Besides, tif_lab_rgb converts CIELab samples to RGB as Pillow's
// convert("RGBA") does through LittleCMS: integer interpolation of a
// 16-bit table that imgcodecs.py samples in floating point.
#include <cstdint>
#include <vector>

namespace {

enum {
  kCorrupt = -1,   // a code the table does not hold, or a table overflow
};

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kTableSize = 4095 + 1024;   // libtiff's CSIZE

struct Entry {
  int32_t prev;     // the code of the string without its last byte, -1 for a literal
  int32_t length;
  uint8_t first;
  uint8_t last;
};

// the codes of the strip, MSB-first as libtiff's GetNextCode reads them
// or LSB-first as its GetNextCodeCompat does
struct CodeReader {
  const uint8_t* in;
  int64_t nbits_total;
  bool lsb;
  int64_t bitpos = 0;
  bool next(int nbits, int* code) {
    if (bitpos + nbits > nbits_total) return false;
    int64_t byte = bitpos >> 3;
    int64_t n = nbits_total >> 3;
    uint32_t b0 = in[byte], b1 = byte + 1 < n ? in[byte + 1] : 0, b2 = byte + 2 < n ? in[byte + 2] : 0;
    if (lsb) {
      uint32_t v = b0 | (b1 << 8) | (b2 << 16);
      *code = static_cast<int>((v >> (bitpos & 7)) & ((1u << nbits) - 1));
    } else {
      uint32_t v = (b0 << 16) | (b1 << 8) | b2;
      int shift = 24 - static_cast<int>(bitpos & 7) - nbits;
      *code = static_cast<int>((v >> shift) & ((1u << nbits) - 1));
    }
    bitpos += nbits;
    return true;
  }
};

}  // namespace

extern "C" {

// ``compat``: libtiff's LZWDecodeCompat (LSB-first codes, the width one
// code later) in place of LZWDecode
int64_t tif_lzw_decode(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out, int compat) {
  std::vector<Entry> table(kTableSize);
  for (int i = 0; i < 256; i++)
    table[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  CodeReader rd{in, n_in * 8, compat != 0};
  const int early = compat ? 1 : 2;
  int free_ent = kFirst, nbits = 9, old = -1, code = 0;
  int64_t op = 0;
  while (op < n_out) {
    if (!rd.next(nbits, &code) || code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      do {
        if (!rd.next(nbits, &code)) return op;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return kCorrupt;
      out[op++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0 || code > free_ent || free_ent >= kTableSize) return kCorrupt;
    const Entry& prev = table[old];
    table[free_ent] = {old, prev.length + 1, prev.first,
                       code < free_ent ? table[code].first : prev.first};
    if (++free_ent > (1 << nbits) - early && nbits < 12) nbits++;
    old = code;
    const Entry* e = &table[code];
    int64_t len = e->length;
    int64_t room = n_out - op;
    int c = code;
    while (len > room) {            // cut at the end of the strip: the head fits
      c = table[c].prev;
      len--;
    }
    for (int64_t k = len - 1; k >= 0; k--) {
      out[op + k] = table[c].last;
      c = table[c].prev;
    }
    op += len;
  }
  return op;
}

int64_t tif_packbits_decode(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out) {
  int64_t ip = 0, op = 0;
  while (ip < n_in && op < n_out) {
    int n = static_cast<int8_t>(in[ip++]);
    if (n < 0) {
      if (n == -128) continue;
      int64_t run = 1 - n;
      if (run > n_out - op) run = n_out - op;
      if (ip >= n_in) break;
      uint8_t b = in[ip++];
      for (int64_t k = 0; k < run; k++) out[op++] = b;
    } else {
      int64_t run = n + 1;
      if (run > n_out - op) run = n_out - op;
      if (n_in - ip < run) break;
      for (int64_t k = 0; k < run; k++) out[op++] = in[ip++];
    }
  }
  return op;
}

// LittleCMS's 8-bit read through its optimised 16-bit table (cmsintrp.c
// TetrahedralInterp16 on a 33-point grid, cmsxform.c's 8 <-> 16 bit
// conversions), as Pillow's convert("RGBA") of its LAB mode runs it:
//   lab    uint8 [n][3], as Pillow's LAB holds them (L, a + 128, b + 128);
//          each widened to 16 bits (x 257);
//   clut   uint16 [33][33][33][3], L slowest;
//   out    uint8 [n][stride]: R, G, B in the first three of each pixel
//          ((x * 65281 + 2^23) >> 24 of the 16-bit result).
void tif_lab_rgb(const uint8_t* lab, int64_t n, const uint16_t* clut, uint8_t* out,
                 int stride) {
  constexpr int kGrid = 33;
  constexpr int64_t kOpta2 = 3 * kGrid * kGrid, kOpta1 = 3 * kGrid, kOpta0 = 3;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = lab + 3 * i;
    int64_t f[3], r[3];
    for (int k = 0; k < 3; k++) {
      int64_t a = int64_t{p[k]} * 257 * (kGrid - 1);
      f[k] = a + (a + 0x7fff) / 0xffff;        // _cmsToFixedDomain
      r[k] = f[k] & 0xffff;
    }
    const uint16_t* lut =
        clut + kOpta2 * (f[0] >> 16) + kOpta1 * (f[1] >> 16) + kOpta0 * (f[2] >> 16);
    const int64_t x1 = p[0] == 255 ? 0 : kOpta2, y1 = p[1] == 255 ? 0 : kOpta1,
                  z1 = p[2] == 255 ? 0 : kOpta0;
    const int64_t rx = r[0], ry = r[1], rz = r[2];
    int64_t o1, o2, w1, w2, w3;                 // corners 1 and 2 and the weights in order
    if (rx >= ry) {
      if (ry >= rz) {
        o1 = x1, o2 = x1 + y1, w1 = rx, w2 = ry, w3 = rz;
      } else if (rz >= rx) {
        o1 = z1, o2 = x1 + z1, w1 = rz, w2 = rx, w3 = ry;
      } else {
        o1 = x1, o2 = x1 + z1, w1 = rx, w2 = rz, w3 = ry;
      }
    } else if (rx >= rz) {
      o1 = y1, o2 = x1 + y1, w1 = ry, w2 = rx, w3 = rz;
    } else if (ry >= rz) {
      o1 = y1, o2 = y1 + z1, w1 = ry, w2 = rz, w3 = rx;
    } else {
      o1 = z1, o2 = y1 + z1, w1 = rz, w2 = ry, w3 = rx;
    }
    const int64_t o3 = x1 + y1 + z1;
    for (int k = 0; k < 3; k++) {
      int64_t c0 = lut[k], c1 = lut[o1 + k], c2 = lut[o2 + k], c3 = lut[o3 + k];
      int64_t rest = (c1 - c0) * w1 + (c2 - c1) * w2 + (c3 - c2) * w3 + 0x8001;
      uint32_t v = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
      out[stride * i + k] = static_cast<uint8_t>((v * 65281u + 8388608u) >> 24);
    }
  }
}

}  // extern "C"
