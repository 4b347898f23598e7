// The block decoders of DirectDraw Surface textures (BC1 to BC7), written to
// give the pixels Pillow 12.1's "bcn" decoder (BcnDecode.c) gives:
//
//   BC1      two RGB565 endpoints widened by bit replication, 2/3 and 1/3
//            mixes where c0 > c1, else the mean and transparent black;
//   BC2      BC1's colour (always four colours) and 4-bit alpha;
//   BC3      BC1's colour (always four colours) and the 8-value alpha block;
//   BC4      one alpha block (gray);
//   BC5      two alpha blocks (red and green, blue 0), unsigned or signed;
//   BC6H     the 14 modes of the format's public definition (Microsoft's
//            "BC6H Format" page, the Khronos Data Format Specification),
//            unsigned or signed, each channel's 16-bit half float written
//            out as it is: io/dds.py makes the 8-bit samples of it in numpy,
//            so no compiler contracts that step into a fused multiply-add;
//   BC7      the 8 modes of the format's definition with their partition,
//            anchor and weight tables; a block of no mode is opaque black
//            (Pillow's reading).
//
// Each decoder writes the pixels of a w x h image from the blocks at
// data[pos:], left to right and top to bottom, cropping the blocks of the
// right and bottom edges; the caller checks the data holds every block.
// The header, the uncompressed layouts and the conversion to RGBA are
// dspfun_tpu_torch/io/dds.py.
#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

// the bits of a 16-byte block, least significant first
struct Bits {
  const uint8_t* p;
  int at = 0;
  explicit Bits(const uint8_t* src) : p(src) {}
  int get(int n) {
    int v = 0;
    for (int i = 0; i < n; i++, at++) v |= ((p[at >> 3] >> (at & 7)) & 1) << i;
    return v;
  }
};

uint16_t u16(const uint8_t* p) { return static_cast<uint16_t>(p[0] | p[1] << 8); }
uint32_t u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

Rgba rgb565(uint16_t v) {
  Rgba c;
  c.r = static_cast<uint8_t>((v & 0xf800) >> 8);
  c.r |= c.r >> 5;
  c.g = static_cast<uint8_t>((v & 0x07e0) >> 3);
  c.g |= c.g >> 6;
  c.b = static_cast<uint8_t>((v & 0x001f) << 3);
  c.b |= c.b >> 5;
  c.a = 255;
  return c;
}

// BC1's colour block; four colours whatever the endpoints' order where
// the block carries its own alpha (BC2, BC3)
void bc1_color(Rgba* out, const uint8_t* src, bool own_alpha) {
  uint16_t c0 = u16(src), c1 = u16(src + 2);
  uint32_t lut = u32(src + 4);
  Rgba p[4];
  p[0] = rgb565(c0);
  p[1] = rgb565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || own_alpha) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3), static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 255};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3), static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2), static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) out[n] = p[(lut >> (2 * n)) & 3];
}

// the 8-value block of BC3's alpha, BC4 and BC5: values into byte `o` of
// 16 pixels `stride` bytes apart; a signed block's endpoints are int8,
// its mixes floored, its values written plus 128
int floordiv(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a[8];
  a[0] = sign ? static_cast<int8_t>(src[0]) : src[0];
  a[1] = sign ? static_cast<int8_t>(src[1]) : src[1];
  if (a[0] > a[1]) {
    for (int k = 1; k < 7; k++) a[k + 1] = floordiv((7 - k) * a[0] + k * a[1], 7);
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = floordiv((5 - k) * a[0] + k * a[1], 5);
    a[6] = sign ? -128 : 0;
    a[7] = sign ? 127 : 255;
  }
  uint64_t lut = 0;
  for (int k = 0; k < 6; k++) lut |= static_cast<uint64_t>(src[2 + k]) << (8 * k);
  for (int n = 0; n < 16; n++) {
    int v = a[(lut >> (3 * n)) & 7];
    dst[stride * n + o] = static_cast<uint8_t>(sign ? v + 128 : v);
  }
}

// ---- BC7 ---------------------------------------------------------------

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0},
};

// the partitions of two subsets: bit i is pixel i's subset
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};

// the partitions of three subsets: each pixel's subset
const uint8_t kPartition3[64][16] = {
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2},
    {0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1},
    {0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2},
    {0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2},
    {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2},
    {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2},
    {0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2},
    {0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2},
    {0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2},
    {0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0},
    {0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2},
    {0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0},
    {0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2},
    {0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1},
    {0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2},
    {0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2},
    {0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0},
    {0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0},
    {0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2},
    {0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0},
    {0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1},
    {0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2},
    {0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1},
    {0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2},
    {0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2},
    {0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0},
    {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0},
    {0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0},
    {0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0},
    {0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1},
    {0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1},
    {0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1},
    {0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2},
    {0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1},
    {0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1},
    {0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1},
    {0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1},
    {0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2},
    {0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1},
    {0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2},
    {0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2},
    {0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2},
    {0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2},
    {0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2},
    {0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1},
    {0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2},
    {0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0},
};

const uint8_t kAnchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                              15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                              15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                              6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                               3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                               8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                               3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                               15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                               15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                               15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int ns, int partition, int pixel) {
  if (ns == 2) return (kPartition2[partition] >> pixel) & 1;
  if (ns == 3) return kPartition3[partition][pixel];
  return 0;
}

bool is_anchor(int ns, int partition, int pixel) {
  if (pixel == 0) return true;
  if (ns == 2) return pixel == kAnchor2[partition];
  if (ns == 3) return pixel == kAnchor3a[partition] || pixel == kAnchor3b[partition];
  return false;
}

int interp(int e0, int e1, int w) { return ((64 - w) * e0 + w * e1 + 32) >> 6; }

void bc7_block(Rgba* col, const uint8_t* src) {
  int mode = 0;
  while (mode < 8 && !((src[0] >> mode) & 1)) mode++;
  if (mode == 8) {
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  const Bc7Mode& m = kBc7Modes[mode];
  Bits bits(src);
  bits.get(mode + 1);
  int partition = bits.get(m.pb), rotation = bits.get(m.rb), isel = bits.get(m.isb);
  int ep[6][4];  // endpoints: subset s has 2s and 2s + 1
  int nep = 2 * m.ns;
  for (int c = 0; c < 3; c++)
    for (int e = 0; e < nep; e++) ep[e][c] = bits.get(m.cb);
  for (int e = 0; e < nep; e++) ep[e][3] = m.ab ? bits.get(m.ab) : 255;
  int cbits = m.cb, abits = m.ab;
  if (m.epb) {
    for (int e = 0; e < nep; e++) {
      int p = bits.get(1);
      for (int c = 0; c < 3; c++) ep[e][c] = ep[e][c] << 1 | p;
      if (m.ab) ep[e][3] = ep[e][3] << 1 | p;
    }
    cbits++;
    if (m.ab) abits++;
  } else if (m.spb) {
    for (int s = 0; s < m.ns; s++) {
      int p = bits.get(1);
      for (int e = 2 * s; e < 2 * s + 2; e++) {
        for (int c = 0; c < 3; c++) ep[e][c] = ep[e][c] << 1 | p;
        if (m.ab) ep[e][3] = ep[e][3] << 1 | p;
      }
    }
    cbits++;
    if (m.ab) abits++;
  }
  for (int e = 0; e < nep; e++) {
    for (int c = 0; c < 3; c++) {
      int v = ep[e][c] << (8 - cbits);
      ep[e][c] = v | v >> cbits;
    }
    if (m.ab) {
      int v = ep[e][3] << (8 - abits);
      ep[e][3] = v | v >> abits;
    }
  }
  int idx[16], idx2[16];
  for (int i = 0; i < 16; i++) idx[i] = bits.get(m.ib - is_anchor(m.ns, partition, i));
  if (m.ib2)
    for (int i = 0; i < 16; i++) idx2[i] = bits.get(m.ib2 - (i == 0));
  for (int i = 0; i < 16; i++) {
    int s = subset_of(m.ns, partition, i);
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    int cw, aw;
    if (!m.ib2) {
      cw = aw = weights(m.ib)[idx[i]];
    } else if (isel) {
      cw = weights(m.ib2)[idx2[i]];
      aw = weights(m.ib)[idx[i]];
    } else {
      cw = weights(m.ib)[idx[i]];
      aw = weights(m.ib2)[idx2[i]];
    }
    int v[4] = {interp(e0[0], e1[0], cw), interp(e0[1], e1[1], cw), interp(e0[2], e1[2], cw),
                interp(e0[3], e1[3], aw)};
    if (rotation) {
      int t = v[3];
      v[3] = v[rotation - 1];
      v[rotation - 1] = t;
    }
    col[i] = {static_cast<uint8_t>(v[0]), static_cast<uint8_t>(v[1]), static_cast<uint8_t>(v[2]),
              static_cast<uint8_t>(v[3])};
  }
}

// ---- BC6H --------------------------------------------------------------

// the fields of a mode's header bits: endpoint 0 (w), its second endpoint
// (x) and the second subset's two (y, z), each of r, g and b
enum Field { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ, NF };

struct Bc6Mode {
  int ns, transformed, epb, delta[3];
};

// in the order of the 2- and 5-bit mode numbers, as kBc6ModeOf maps them
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 10, {5, 5, 5}}, {2, 1, 7, {6, 6, 6}}, {2, 1, 11, {5, 4, 4}},
    {2, 1, 11, {4, 5, 4}}, {2, 1, 11, {4, 4, 5}}, {2, 1, 9, {5, 5, 5}},
    {2, 1, 8, {6, 5, 5}},  {2, 1, 8, {5, 6, 5}},  {2, 1, 8, {5, 5, 6}},
    {2, 0, 6, {6, 6, 6}},  {1, 0, 10, {10, 10, 10}}, {1, 1, 11, {9, 9, 9}},
    {1, 1, 12, {8, 8, 8}}, {1, 1, 16, {4, 4, 4}}};

// a run of a mode's header bits: field f's bits lo..hi, stored from lo up;
// a run written with hi < lo is stored from lo down to hi (the definition's
// reversed high bits of modes 13 and 14)
struct Run {
  int f, hi, lo;
};
#define R(f, hi, lo) {f, hi, lo}

// each mode's runs after its mode bits, in the order the definition's
// table stores them
const Run kRuns0[] = {R(GY, 4, 4), R(BY, 4, 4), R(BZ, 4, 4), R(RW, 9, 0), R(GW, 9, 0),
                      R(BW, 9, 0), R(RX, 4, 0), R(GZ, 4, 4), R(GY, 3, 0), R(GX, 4, 0),
                      R(BZ, 0, 0), R(GZ, 3, 0), R(BX, 4, 0), R(BZ, 1, 1), R(BY, 3, 0),
                      R(RY, 4, 0), R(BZ, 2, 2), R(RZ, 4, 0), R(BZ, 3, 3), {-1, 0, 0}};
const Run kRuns1[] = {R(GY, 5, 5), R(GZ, 4, 4), R(GZ, 5, 5), R(RW, 6, 0), R(BZ, 0, 0),
                      R(BZ, 1, 1), R(BY, 4, 4), R(GW, 6, 0), R(BY, 5, 5), R(BZ, 2, 2),
                      R(GY, 4, 4), R(BW, 6, 0), R(BZ, 3, 3), R(BZ, 5, 5), R(BZ, 4, 4),
                      R(RX, 5, 0), R(GY, 3, 0), R(GX, 5, 0), R(GZ, 3, 0), R(BX, 5, 0),
                      R(BY, 3, 0), R(RY, 5, 0), R(RZ, 5, 0), {-1, 0, 0}};
const Run kRuns2[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 4, 0), R(RW, 10, 10),
                      R(GY, 3, 0), R(GX, 3, 0), R(GW, 10, 10), R(BZ, 0, 0), R(GZ, 3, 0),
                      R(BX, 3, 0), R(BW, 10, 10), R(BZ, 1, 1), R(BY, 3, 0), R(RY, 4, 0),
                      R(BZ, 2, 2), R(RZ, 4, 0), R(BZ, 3, 3), {-1, 0, 0}};
const Run kRuns3[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 3, 0), R(RW, 10, 10),
                      R(GZ, 4, 4), R(GY, 3, 0), R(GX, 4, 0), R(GW, 10, 10), R(GZ, 3, 0),
                      R(BX, 3, 0), R(BW, 10, 10), R(BZ, 1, 1), R(BY, 3, 0), R(RY, 3, 0),
                      R(BZ, 0, 0), R(BZ, 2, 2), R(RZ, 3, 0), R(GY, 4, 4), R(BZ, 3, 3),
                      {-1, 0, 0}};
const Run kRuns4[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 3, 0), R(RW, 10, 10),
                      R(BY, 4, 4), R(GY, 3, 0), R(GX, 3, 0), R(GW, 10, 10), R(BZ, 0, 0),
                      R(GZ, 3, 0), R(BX, 4, 0), R(BW, 10, 10), R(BY, 3, 0), R(RY, 3, 0),
                      R(BZ, 1, 1), R(BZ, 2, 2), R(RZ, 3, 0), R(BZ, 4, 4), R(BZ, 3, 3),
                      {-1, 0, 0}};
const Run kRuns5[] = {R(RW, 8, 0), R(BY, 4, 4), R(GW, 8, 0), R(GY, 4, 4), R(BW, 8, 0),
                      R(BZ, 4, 4), R(RX, 4, 0), R(GZ, 4, 4), R(GY, 3, 0), R(GX, 4, 0),
                      R(BZ, 0, 0), R(GZ, 3, 0), R(BX, 4, 0), R(BZ, 1, 1), R(BY, 3, 0),
                      R(RY, 4, 0), R(BZ, 2, 2), R(RZ, 4, 0), R(BZ, 3, 3), {-1, 0, 0}};
const Run kRuns6[] = {R(RW, 7, 0), R(GZ, 4, 4), R(BY, 4, 4), R(GW, 7, 0), R(BZ, 2, 2),
                      R(GY, 4, 4), R(BW, 7, 0), R(BZ, 3, 3), R(BZ, 4, 4), R(RX, 5, 0),
                      R(GY, 3, 0), R(GX, 4, 0), R(BZ, 0, 0), R(GZ, 3, 0), R(BX, 4, 0),
                      R(BZ, 1, 1), R(BY, 3, 0), R(RY, 5, 0), R(RZ, 5, 0), {-1, 0, 0}};
const Run kRuns7[] = {R(RW, 7, 0), R(BZ, 0, 0), R(BY, 4, 4), R(GW, 7, 0), R(GY, 5, 5),
                      R(GY, 4, 4), R(BW, 7, 0), R(GZ, 5, 5), R(BZ, 4, 4), R(RX, 4, 0),
                      R(GZ, 4, 4), R(GY, 3, 0), R(GX, 5, 0), R(GZ, 3, 0), R(BX, 4, 0),
                      R(BZ, 1, 1), R(BY, 3, 0), R(RY, 4, 0), R(BZ, 2, 2), R(RZ, 4, 0),
                      R(BZ, 3, 3), {-1, 0, 0}};
const Run kRuns8[] = {R(RW, 7, 0), R(BZ, 1, 1), R(BY, 4, 4), R(GW, 7, 0), R(BY, 5, 5),
                      R(GY, 4, 4), R(BW, 7, 0), R(BZ, 5, 5), R(BZ, 4, 4), R(RX, 4, 0),
                      R(GZ, 4, 4), R(GY, 3, 0), R(GX, 4, 0), R(BZ, 0, 0), R(GZ, 3, 0),
                      R(BX, 5, 0), R(BY, 3, 0), R(RY, 4, 0), R(BZ, 2, 2), R(RZ, 4, 0),
                      R(BZ, 3, 3), {-1, 0, 0}};
const Run kRuns9[] = {R(RW, 5, 0), R(GZ, 4, 4), R(BZ, 0, 0), R(BZ, 1, 1), R(BY, 4, 4),
                      R(GW, 5, 0), R(GY, 5, 5), R(BY, 5, 5), R(BZ, 2, 2), R(GY, 4, 4),
                      R(BW, 5, 0), R(GZ, 5, 5), R(BZ, 3, 3), R(BZ, 5, 5), R(BZ, 4, 4),
                      R(RX, 5, 0), R(GY, 3, 0), R(GX, 5, 0), R(GZ, 3, 0), R(BX, 5, 0),
                      R(BY, 3, 0), R(RY, 5, 0), R(RZ, 5, 0), {-1, 0, 0}};
const Run kRuns10[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 9, 0), R(GX, 9, 0),
                       R(BX, 9, 0), {-1, 0, 0}};
const Run kRuns11[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 8, 0), R(RW, 10, 10),
                       R(GX, 8, 0), R(GW, 10, 10), R(BX, 8, 0), R(BW, 10, 10), {-1, 0, 0}};
const Run kRuns12[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 7, 0), R(RW, 10, 11),
                       R(GX, 7, 0), R(GW, 10, 11), R(BX, 7, 0), R(BW, 10, 11), {-1, 0, 0}};
const Run kRuns13[] = {R(RW, 9, 0), R(GW, 9, 0), R(BW, 9, 0), R(RX, 3, 0), R(RW, 10, 15),
                       R(GX, 3, 0), R(GW, 10, 15), R(BX, 3, 0), R(BW, 10, 15), {-1, 0, 0}};
#undef R

const Run* const kBc6Runs[14] = {kRuns0, kRuns1, kRuns2,  kRuns3,  kRuns4,  kRuns5,  kRuns6,
                                 kRuns7, kRuns8, kRuns9, kRuns10, kRuns11, kRuns12, kRuns13};

// the mode of a block's first 5 bits (2 where bit 1 is 0), -1 reserved
int bc6_mode(int m5) {
  if ((m5 & 2) == 0) return m5 & 1;
  switch (m5) {
    case 0x02: return 2;
    case 0x06: return 3;
    case 0x0a: return 4;
    case 0x0e: return 5;
    case 0x12: return 6;
    case 0x16: return 7;
    case 0x1a: return 8;
    case 0x1e: return 9;
    case 0x03: return 10;
    case 0x07: return 11;
    case 0x0b: return 12;
    case 0x0f: return 13;
    default: return -1;
  }
}

int sign_extend(int v, int bits) {
  int s = 1 << (bits - 1);
  v &= (1 << bits) - 1;
  return (v ^ s) - s;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v;
  bool neg = v < 0;
  if (neg) v = -v;
  int u;
  if (v == 0) u = 0;
  else if (v >= (1 << (bits - 1)) - 1) u = 0x7fff;
  else u = ((v << 15) + 0x4000) >> (bits - 1);
  return neg ? -u : u;
}

uint16_t bc6_finalize(int v, bool sign) {
  if (!sign) return static_cast<uint16_t>((v * 31) >> 6);
  if (v < 0) return static_cast<uint16_t>(0x8000 | (((-v) * 31) >> 5));
  return static_cast<uint16_t>((v * 31) >> 5);
}

void bc6_block(uint16_t* out, const uint8_t* src, bool sign) {
  Bits bits(src);
  int m5 = bits.get(2);
  if (m5 & 2) m5 |= bits.get(3) << 2;
  int mode = bc6_mode(m5);
  if (mode < 0) {
    memset(out, 0, 16 * 3 * sizeof(uint16_t));
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int f[NF] = {0};
  for (const Run* r = kBc6Runs[mode]; r->f >= 0; r++) {
    if (r->hi >= r->lo) {
      for (int b = r->lo; b <= r->hi; b++) f[r->f] |= bits.get(1) << b;
    } else {
      for (int b = r->lo; b >= r->hi; b--) f[r->f] |= bits.get(1) << b;
    }
  }
  int partition = m.ns == 2 ? bits.get(5) : 0;
  int ep[4][3];
  for (int c = 0; c < 3; c++) {
    ep[0][c] = f[RW + c];
    ep[1][c] = f[RX + c];
    ep[2][c] = f[RY + c];
    ep[3][c] = f[RZ + c];
  }
  int nep = 2 * m.ns;
  for (int c = 0; c < 3; c++) {
    if (sign) ep[0][c] = sign_extend(ep[0][c], m.epb);
    for (int e = 1; e < nep; e++) {
      if (m.transformed) {
        ep[e][c] = sign_extend(ep[e][c], m.delta[c]);
        ep[e][c] = (ep[0][c] + ep[e][c]) & ((1 << m.epb) - 1);
        // Pillow keeps the sum as it is but for its 16-bit type (not the
        // definition's sign extension at epb bits)
        if (sign) ep[e][c] = static_cast<int16_t>(ep[e][c]);
      } else if (sign) {
        ep[e][c] = sign_extend(ep[e][c], m.epb);
      }
    }
  }
  for (int e = 0; e < nep; e++)
    for (int c = 0; c < 3; c++) ep[e][c] = bc6_unquantize(ep[e][c], m.epb, sign);
  int ib = m.ns == 2 ? 3 : 4;
  const int* w = weights(ib);
  for (int i = 0; i < 16; i++) {
    int s = subset_of(m.ns, partition, i);
    int idx = bits.get(ib - is_anchor(m.ns, partition, i));
    for (int c = 0; c < 3; c++) {
      // Pillow's mix has no rounding term (the definition adds 32)
      int v = ((64 - w[idx]) * ep[2 * s][c] + w[idx] * ep[2 * s + 1][c]) >> 6;
      out[3 * i + c] = bc6_finalize(v, sign);
    }
  }
}

template <typename T, int C, typename F>
void each_block(const uint8_t* data, int64_t pos, int w, int h, int block_bytes, T* out, F fn) {
  T px[16 * C];
  for (int by = 0; by < h; by += 4) {
    for (int bx = 0; bx < w; bx += 4, pos += block_bytes) {
      fn(px, data + pos);
      for (int y = 0; y < 4 && by + y < h; y++)
        for (int x = 0; x < 4 && bx + x < w; x++)
          memcpy(out + (static_cast<int64_t>(by + y) * w + bx + x) * C, px + (4 * y + x) * C,
                 C * sizeof(T));
    }
  }
}

}  // namespace

extern "C" {

// n: 1 BC1, 2 BC2, 3 BC3 (RGBA out), 4 BC4 (gray), 5 BC5 (RGB; sign for
// BC5S), 7 BC7 (RGBA); uint8 samples.  Returns 0, or -1 for an unknown n.
int bcn_decode(const uint8_t* data, int64_t pos, int w, int h, int n, int sign, uint8_t* out) {
  switch (n) {
    case 1:
      each_block<uint8_t, 4>(data, pos, w, h, 8, out, [](uint8_t* px, const uint8_t* s) {
        bc1_color(reinterpret_cast<Rgba*>(px), s, false);
      });
      return 0;
    case 2:
      each_block<uint8_t, 4>(data, pos, w, h, 16, out, [](uint8_t* px, const uint8_t* s) {
        bc1_color(reinterpret_cast<Rgba*>(px), s + 8, true);
        for (int i = 0; i < 16; i++) {
          int a = (s[i / 2] >> (4 * (i & 1))) & 15;
          px[4 * i + 3] = static_cast<uint8_t>(a | a << 4);
        }
      });
      return 0;
    case 3:
      each_block<uint8_t, 4>(data, pos, w, h, 16, out, [](uint8_t* px, const uint8_t* s) {
        bc1_color(reinterpret_cast<Rgba*>(px), s + 8, true);
        bc3_alpha(px, s, 4, 3, false);
      });
      return 0;
    case 4:
      each_block<uint8_t, 1>(data, pos, w, h, 8, out, [](uint8_t* px, const uint8_t* s) {
        bc3_alpha(px, s, 1, 0, false);
      });
      return 0;
    case 5:
      each_block<uint8_t, 3>(data, pos, w, h, 16, out, [sign](uint8_t* px, const uint8_t* s) {
        for (int i = 0; i < 16; i++) px[3 * i] = px[3 * i + 1] = px[3 * i + 2] = sign ? 128 : 0;
        bc3_alpha(px, s, 3, 0, sign != 0);
        bc3_alpha(px, s + 8, 3, 1, sign != 0);
      });
      return 0;
    case 7:
      each_block<uint8_t, 4>(data, pos, w, h, 16, out, [](uint8_t* px, const uint8_t* s) {
        bc7_block(reinterpret_cast<Rgba*>(px), s);
      });
      return 0;
    default:
      return -1;
  }
}

// BC6H: the 16-bit half float of each channel, uint16 [h, w, 3].
void bc6h_decode(const uint8_t* data, int64_t pos, int w, int h, int sign, uint16_t* out) {
  each_block<uint16_t, 3>(data, pos, w, h, 16, out, [sign](uint16_t* px, const uint8_t* s) {
    bc6_block(px, s, sign != 0);
  });
}

}  // extern "C"
