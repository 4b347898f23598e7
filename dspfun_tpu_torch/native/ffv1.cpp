// Native FFV1 codec (RFC 9043): v1 + v3 encode; v0-v3 decode, both coders.
//
// FFV1 is the *default* output codec of every reference video tool
// (reference motion/motion.c:447, motion/rotate.c:128,
// motion/transcode.c:76, zoom/zoom.c:306, scan/scan.c:326 all pass
// AV_CODEC_ID_FFV1 to ffapi_open_output) — a lossless intra codec the
// reference gets from libavcodec.  This environment has no FFmpeg, so
// the framework carries its own implementation of the published
// bitstream (RFC 9043 "FFV1 Video Coding Format Versions 0, 1, and 3"),
// exposed through a plain C ABI for ctypes (dspfun_tpu/io/ffv1.py).
//
// Scope: version 1 encode (whole-frame range coder, every frame a
// keyframe, 3-input context model) and version 3 encode (out-of-band
// extradata with CRC, independent slices with size/CRC trailers,
// slice-parallel host encode, 8..16-bit YCbCr/gray and 8..16-bit RGB
// via the reversible color transform); decode covers versions 0-3 —
// in-band (v0/1) or extradata (v2/3) parameters, independent slices
// with CRC trailers, BOTH coders (range incl. custom state tables +
// Golomb-Rice with run mode), 8..16-bit YCbCr/gray with chroma
// subsampling and alpha, and 8..16-bit RGB via the reversible color
// transform.
//
// Interop is validated BOTH directions against a real libavcodec
// (OpenCV's bundled FFmpeg, tests/test_interop_cv2.py): our v1
// bitstream decodes bit-exactly there, and real-FFmpeg v3 files
// (golomb, RGB, sliced) decode bit-exactly here; an independent
// pure-Python decoder (tests/ffv1_pyref.py) and byte goldens pin the
// bitstream besides.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Range coder (RFC 9043 section 4.1).  The default state transition
// table is derived, not stored: starting from probability one half,
// each state's successor follows an exponential-decay adaptation with
// factor 0.05 in 32-bit fixed point, mirrored for the zero branch
// (RFC 9043 section 4.1.3's default table is the fixed point of this
// recurrence; 214748364 == trunc(0.05 * 2^32)).
// ---------------------------------------------------------------------

struct StateTables {
  uint8_t one[256];
  uint8_t zero[256];
  // combined transition (index = state*2 + bit): one load in the
  // branchless coder hot path instead of a predicted select between
  // the two tables
  uint8_t trans[512];

  void rebuild_trans() {
    for (int s = 0; s < 256; s++) {
      trans[2 * s] = zero[s];
      trans[2 * s + 1] = one[s];
    }
  }

  StateTables() {
    const int64_t kOne = int64_t(1) << 32;
    const int64_t kFactor = 214748364;  // trunc(0.05 * 2^32)
    const int kMaxP = 256 - 8;
    std::memset(one, 0, sizeof(one));
    std::memset(zero, 0, sizeof(zero));

    int last_p8 = 0;
    int64_t p = kOne / 2;
    for (int i = 0; i < 128; i++) {
      int p8 = int((256 * p + kOne / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= kMaxP) one[last_p8] = uint8_t(p8);
      p += ((kOne - p) * kFactor + kOne / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - kMaxP; i <= kMaxP; i++) {
      if (one[i]) continue;
      p = (int64_t(i) * kOne + 128) >> 8;
      p += ((kOne - p) * kFactor + kOne / 2) >> 32;
      int p8 = int((256 * p + kOne / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > kMaxP) p8 = kMaxP;
      one[i] = uint8_t(p8);
    }
    for (int i = 1; i < 256; i++) zero[i] = uint8_t(256 - one[256 - i]);
    rebuild_trans();
  }
};

const StateTables kStates;

struct RangeEncoder {
  uint8_t* buf;
  int64_t cap;
  int64_t pos = 0;
  bool overflow = false;
  uint32_t low = 0;
  uint32_t range = 0xFF00;
  int outstanding_count = 0;
  int outstanding_byte = -1;  // <0: none pending yet

  RangeEncoder(uint8_t* b, int64_t c) : buf(b), cap(c) {}

  void emit(uint8_t b) {
    if (pos < cap)
      buf[pos] = b;
    else
      overflow = true;
    pos++;
  }

  void renorm_once() {
    if (outstanding_byte < 0) {
      outstanding_byte = int(low >> 8);
    } else if (low <= 0xFF00) {
      emit(uint8_t(outstanding_byte));
      for (; outstanding_count; outstanding_count--) emit(0xFF);
      outstanding_byte = int(low >> 8);
    } else if (low >= 0x10000) {  // carry propagates into the pending byte
      emit(uint8_t(outstanding_byte + 1));
      for (; outstanding_count; outstanding_count--) emit(0x00);
      outstanding_byte = int((low >> 8) & 0xFF);
    } else {
      outstanding_count++;
    }
    low = (low & 0xFF) << 8;
    range <<= 8;
  }

  // one shift always restores range >= 0x100 (range >= 1 invariant),
  // so renorm is a single conditional step, not a loop
  void renorm() {
    if (range < 0x100) renorm_once();
  }

  // Branchless interval update: the coded bits are ~50/50 on noisy
  // content, so a data-dependent branch here mispredicts nearly every
  // sample bit — masking the select measured 1.55x on the encode
  // inner loop, byte-identical output.
  void put(uint8_t* state, bool bit) {
    uint32_t s = *state;
    uint32_t r1 = (range * s) >> 8;
    uint32_t m = uint32_t(-int32_t(bit));
    low += (range - r1) & m;
    range = r1 ^ ((r1 ^ (range - r1)) & ~m);  // bit ? r1 : range - r1
    *state = kStates.trans[(s << 1) | uint32_t(bit)];
    renorm();
  }

  // Flush: force the remaining low bits out, then the pending byte, so
  // a decoder reading this buffer (zero-filled past the end) resolves
  // every symbol written.
  int64_t terminate() {
    range = 0xFF;
    low += 0xFF;
    renorm();
    range = 0xFF;
    renorm();
    if (outstanding_byte >= 0) {
      emit(uint8_t(outstanding_byte));
      for (; outstanding_count; outstanding_count--) emit(0xFF);
    }
    emit(0);
    return overflow ? -1 : pos;
  }

  // Version-3 slice termination (libavcodec ff_rac_terminate(c, 1)
  // semantics): one zero bit against a fresh state 129, then the
  // renorm flush WITHOUT the trailing padding byte — the v3 decoder
  // sanity-checks the consumed length against the slice size and
  // marks the slice "damaged" (triggering last-frame concealment) on
  // any surplus, so the byte count must land exactly.
  int64_t terminate_v3() {
    uint8_t st = 129;
    put(&st, false);
    range = 0xFF;
    low += 0xFF;
    renorm();
    range = 0xFF;
    renorm();
    // the carry-pending byte stays unwritten (libavcodec leaves it in
    // coder state; the decoder's two-byte prefetch reads the slice
    // trailer there, and the flushed interval keeps every decoded
    // symbol unambiguous regardless of those bytes' values)
    return overflow ? -1 : pos;
  }
};

struct RangeDecoder {
  const uint8_t* buf;
  int64_t size;
  int64_t pos = 0;
  uint32_t low = 0;
  uint32_t range = 0xFF00;
  const StateTables* st;  // default, or a custom table (coder 2)

  RangeDecoder(const uint8_t* b, int64_t s,
               const StateTables* tables = &kStates)
      : buf(b), size(s), st(tables) {
    low = uint32_t(next()) << 8;
    low |= next();
  }

  uint8_t next() { return pos < size ? buf[pos++] : 0; }

  void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      low += next();
    }
  }

  bool get(uint8_t* state) {
    // branchless mirror of RangeEncoder::put (same 50/50
    // misprediction argument; st may be a custom coder-2 table)
    uint32_t s = *state;
    uint32_t r1 = (range * s) >> 8;
    uint32_t r0 = range - r1;
    uint32_t bit = uint32_t(low >= r0);
    uint32_t m = uint32_t(-int32_t(bit));
    low -= r0 & m;
    range = r1 ^ ((r1 ^ r0) & ~m);  // bit ? r1 : r0
    *state = st->trans[(s << 1) | bit];
    refill();
    return bit != 0;
  }
};

// ---------------------------------------------------------------------
// Adaptive binarization of signed integers (RFC 9043 section 4.1.5):
// per-context 32-state vector — state 0 the zero flag, 1..10 unary
// exponent, 11..21 sign, 22..31 mantissa bits (indices clamped).
// ---------------------------------------------------------------------

constexpr int kContextSize = 32;

inline int log2i(uint32_t v) {
  return 31 - __builtin_clz(v);
}

void put_symbol(RangeEncoder& c, uint8_t* state, int v, bool is_signed) {
  if (!v) {
    c.put(state, true);
    return;
  }
  const uint32_t a = uint32_t(v < 0 ? -int64_t(v) : v);
  const int e = log2i(a);
  c.put(state, false);
  for (int i = 0; i < e; i++) c.put(state + 1 + (i < 9 ? i : 9), true);
  c.put(state + 1 + (e < 9 ? e : 9), false);
  for (int i = e - 1; i >= 0; i--)
    c.put(state + 22 + (i < 9 ? i : 9), (a >> i) & 1);
  if (is_signed) c.put(state + 11 + (e < 10 ? e : 10), v < 0);
}

// Returns INT32_MIN on a corrupt (runaway-exponent) stream.
int get_symbol(RangeDecoder& c, uint8_t* state, bool is_signed) {
  if (c.get(state)) return 0;
  int e = 0;
  while (c.get(state + 1 + (e < 9 ? e : 9))) {
    if (++e > 31) return INT32_MIN;
  }
  uint32_t a = 1;
  for (int i = e - 1; i >= 0; i--)
    a = (a << 1) | uint32_t(c.get(state + 22 + (i < 9 ? i : 9)));
  if (is_signed && c.get(state + 11 + (e < 10 ? e : 10)))
    return -int(a);
  return int(a);
}

// ---------------------------------------------------------------------
// Context model (RFC 9043 section 3): quantized neighbour gradients.
// quant_table entries come premultiplied by the running context count
// so the context index is a plain sum of five lookups.
// ---------------------------------------------------------------------

struct QuantTables {
  int32_t t[5][256];
  int context_count = 0;  // distinct |context| values
  bool five_input = false;
};

// The framework's encoder quantizer: 11 symmetric buckets
// 0, ±[1,2], ±[3,4], ±[5,8], ±[9,16], ±[17,...] on the first three
// gradients (the classic small FFV1 context set), tables 3/4 zero.
int quant11(int d) {
  int a = d < 0 ? -d : d;
  int v = a == 0 ? 0 : a <= 2 ? 1 : a <= 4 ? 2 : a <= 8 ? 3 : a <= 16 ? 4 : 5;
  return d < 0 ? -v : v;
}

QuantTables encoder_quant_tables() {
  QuantTables q;
  std::memset(q.t, 0, sizeof(q.t));
  int scale = 1;
  for (int ti = 0; ti < 3; ti++) {
    for (int i = 1; i < 128; i++) q.t[ti][i] = scale * quant11(i);
    for (int i = 1; i < 128; i++) q.t[ti][256 - i] = -q.t[ti][i];
    q.t[ti][128] = -q.t[ti][127];
    scale *= 11;
  }
  q.context_count = (scale + 1) / 2;  // symmetric: sign folds
  q.five_input = false;
  return q;
}

// Serialized as run lengths between value changes over [1,128), one
// fresh 32-state context per table (RFC 9043 section 4.2.6).  The
// premultiplication cancels in the change detection, so the scale is
// irrelevant here.
void write_quant_table(RangeEncoder& c, const int32_t* qt, int scale) {
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  int last = 0;
  int i;
  for (i = 1; i < 128; i++) {
    if (qt[i] != qt[i - 1]) {
      put_symbol(c, state, i - last - 1, false);
      last = i;
    }
  }
  put_symbol(c, state, i - last - 1, false);
  (void)scale;
}

// Returns the number of distinct values (2v-1) or -1 on corruption.
int read_quant_table(RangeDecoder& c, int32_t* qt, int scale) {
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  std::memset(qt, 0, 256 * sizeof(*qt));
  int i = 0;  // runs cover [0, 128): "length - 1" coded per value segment
  int v = 0;
  for (; i < 128; v++) {
    int run = get_symbol(c, state, false);
    // unsigned compare: run + 1 would overflow signed int at the
    // INT32_MAX a crafted stream can encode
    if (run < 0 || uint32_t(run) + 1u > uint32_t(128 - i)) return -1;
    for (int len = run + 1; len--;) qt[i++] = scale * v;
  }
  for (int j = 1; j < 128; j++) qt[256 - j] = -qt[j];
  qt[128] = -qt[127];
  return 2 * v - 1;
}

// ---------------------------------------------------------------------
// Per-plane sample coding (RFC 9043 section 3.8).  A three-row ring of
// int32 samples with guard cells reproduces the border rules: the top
// rows read zero, the left border of each row is the sample above, the
// right border repeats the last column.
// ---------------------------------------------------------------------

struct PlaneContexts {
  std::vector<uint8_t> states;  // context_count * kContextSize
  void reset(int context_count) {
    states.assign(size_t(context_count) * kContextSize, 128);
  }
};

struct Ring {
  std::vector<int32_t> buf;
  int stride = 0;
  int32_t* row[3];  // row[0]=current, row[1]=above, row[2]=two above

  void init(int w) {
    stride = w + 6;
    buf.assign(size_t(stride) * 3, 0);
    for (int i = 0; i < 3; i++) row[i] = buf.data() + size_t(stride) * i + 3;
  }

  void rotate(int w) {
    int32_t* t = row[2];
    row[2] = row[1];
    row[1] = row[0];
    row[0] = t;
    row[0][-1] = row[1][0];      // left border: sample above
    row[1][w] = row[1][w - 1];   // right border of the row above
  }
};

inline int med3(int a, int b, int c) {
  // median of (a, b, c)
  if (a > b) { int t = a; a = b; b = t; }
  if (b > c) { b = c; }
  return a > b ? a : b;
}

inline int context_of(const QuantTables& q, const int32_t* cur,
                      const int32_t* above, const int32_t* above2, int x) {
  const int lt = above[x - 1], t = above[x], rt = above[x + 1], l = cur[x - 1];
  int ctx = q.t[0][(l - lt) & 0xFF] + q.t[1][(lt - t) & 0xFF] +
            q.t[2][(t - rt) & 0xFF];
  if (q.five_input)
    ctx += q.t[3][(cur[x - 2] - l) & 0xFF] + q.t[4][(above2[x] - t) & 0xFF];
  return ctx;
}

inline int predict(const int32_t* cur, const int32_t* above, int x) {
  const int l = cur[x - 1], t = above[x], lt = above[x - 1];
  return med3(l, l + t - lt, t);
}

inline int fold(int diff, int bits) {
  if (bits == 8) return int(int8_t(diff));
  diff &= (1 << bits) - 1;
  if (diff & (1 << (bits - 1))) diff -= 1 << bits;
  return diff;
}

bool rac_decode_line(RangeDecoder& c, const QuantTables& q, uint8_t* states,
                     int32_t* cur, const int32_t* above,
                     const int32_t* above2, int w, int bits);

void rac_encode_line(RangeEncoder& c, const QuantTables& q,
                     uint8_t* states, int32_t* cur, const int32_t* above,
                     const int32_t* above2, int w, int bits) {
  for (int x = 0; x < w; x++) {
    int ctx = context_of(q, cur, above, above2, x);
    int diff = cur[x] - predict(cur, above, x);
    if (ctx < 0) {
      ctx = -ctx;
      diff = -diff;
    }
    put_symbol(c, states + size_t(ctx) * kContextSize, fold(diff, bits),
               true);
  }
}

// RGB (colorspace 1): line-interleaved G,B,R[,A] with the forward
// reversible color transform, every plane coded at max(9, bits+1)
// coded bits (RFC 9043 section 3.7.2).  Region-capable: src points at
// each plane's slice-top row, xoff is the slice's column — so the v1
// whole-frame layout (xoff 0, full dims) and v3 slices share it.
template <typename Sample>
void encode_rgb_region(RangeEncoder& c, const QuantTables& q,
                       PlaneContexts* contexts, const Sample* const* src,
                       const int64_t* strides, int64_t xoff, int w, int h,
                       int bits, int transparency) {
  const int cbits = bits <= 8 ? 9 : bits + 1;
  const int offset = 1 << bits;
  const int np = 3 + (transparency ? 1 : 0);
  std::vector<Ring> rings(np);
  for (int p = 0; p < np; p++) rings[p].init(w);
  for (int y = 0; y < h; y++) {
    for (int p = 0; p < np; p++) rings[p].rotate(w);
    int32_t* gr = rings[0].row[0];
    int32_t* br = rings[1].row[0];
    int32_t* rr = rings[2].row[0];
    for (int x = 0; x < w; x++) {
      int g = int(src[0][y * strides[0] + xoff + x]);
      int b = int(src[1][y * strides[1] + xoff + x]);
      int r = int(src[2][y * strides[2] + xoff + x]);
      int u = b - g;
      int v = r - g;
      gr[x] = g + ((u + v) >> 2);
      br[x] = u + offset;
      rr[x] = v + offset;
      if (np == 4)
        rings[3].row[0][x] = int(src[3][y * strides[3] + xoff + x]);
    }
    for (int p = 0; p < np; p++) {
      int set = (p + 1) / 2;
      rac_encode_line(c, q, contexts[set].states.data(), rings[p].row[0],
                      rings[p].row[1], rings[p].row[2], w, cbits);
    }
  }
}

bool decode_rgb_v01(RangeDecoder& c, const QuantTables& q,
                    PlaneContexts* contexts, uint8_t* const* planes,
                    const int64_t* strides, int w, int h, int bits,
                    int transparency) {
  const int cbits = bits + 1;
  const int offset = 1 << bits;
  const int np = 3 + (transparency ? 1 : 0);
  std::vector<Ring> rings(np);
  for (int p = 0; p < np; p++) rings[p].init(w);
  for (int y = 0; y < h; y++) {
    for (int p = 0; p < np; p++) {
      rings[p].rotate(w);
      int set = (p + 1) / 2;
      if (!rac_decode_line(c, q, contexts[set].states.data(),
                           rings[p].row[0], rings[p].row[1],
                           rings[p].row[2], w, cbits))
        return false;
    }
    for (int x = 0; x < w; x++) {
      int g = rings[0].row[0][x];
      int b = rings[1].row[0][x] - offset;
      int r = rings[2].row[0][x] - offset;
      g -= (b + r) >> 2;
      b += g;
      r += g;
      planes[0][y * strides[0] + x] = uint8_t(g);
      planes[1][y * strides[1] + x] = uint8_t(b);
      planes[2][y * strides[2] + x] = uint8_t(r);
      if (np == 4)
        planes[3][y * strides[3] + x] = uint8_t(rings[3].row[0][x]);
    }
  }
  return true;
}

template <typename Sample>
void encode_plane(RangeEncoder& c, const QuantTables& q, PlaneContexts& pc,
                  const Sample* src, int64_t stride, int w, int h, int bits) {
  Ring ring;
  ring.init(w);
  // 16-bit samples code through WRAPPED signed-16 intermediates (the
  // format's reference implementation keeps them in int16 buffers, so
  // the median predictor orders wrapped values) — cross-validated
  // against real libavcodec, which diverged above 2^15 otherwise
  const bool wrap16 = bits == 16;
  for (int y = 0; y < h; y++) {
    ring.rotate(w);
    int32_t* cur = ring.row[0];
    for (int x = 0; x < w; x++)
      cur[x] = wrap16 ? int32_t(int16_t(src[y * stride + x]))
                      : int32_t(src[y * stride + x]);
    rac_encode_line(c, q, pc.states.data(), cur, ring.row[1], ring.row[2],
                    w, bits);
  }
}

template <typename Sample>
bool decode_plane(RangeDecoder& c, const QuantTables& q, PlaneContexts& pc,
                  Sample* dst, int64_t stride, int w, int h, int bits) {
  Ring ring;
  ring.init(w);
  const int mask = (1 << bits) - 1;
  const bool wrap16 = bits == 16;  // see encode_plane
  for (int y = 0; y < h; y++) {
    ring.rotate(w);
    int32_t* cur = ring.row[0];
    for (int x = 0; x < w; x++) {
      int ctx = context_of(q, cur, ring.row[1], ring.row[2], x);
      bool flip = ctx < 0;
      if (flip) ctx = -ctx;
      int diff = get_symbol(
          c, pc.states.data() + size_t(ctx) * kContextSize, true);
      if (diff == INT32_MIN) return false;
      if (flip) diff = -diff;
      int v = (predict(cur, ring.row[1], x) + diff) & mask;
      cur[x] = wrap16 ? int32_t(int16_t(v)) : v;
    }
    for (int x = 0; x < w; x++)
      dst[y * stride + x] = Sample(cur[x] & mask);
  }
  return true;
}

// ---------------------------------------------------------------------
// Frame layer (RFC 9043 section 4.2/4.3, versions 0/1: the parameter
// set rides at the start of every keyframe; no slices).
// ---------------------------------------------------------------------

struct Params {
  int32_t version = 1;
  int32_t coder = 1;  // 1 = range coder, default state table
  int32_t colorspace = 0;
  int32_t bits = 8;
  int32_t chroma_planes = 1;
  int32_t h_shift = 0;
  int32_t v_shift = 0;
  int32_t transparency = 0;
  int32_t width = 0;   // ABI convenience (not in the bitstream)
  int32_t height = 0;
};

int plane_count(const Params& p) {
  if (p.colorspace == 1) return 3 + (p.transparency ? 1 : 0);
  return 1 + (p.chroma_planes ? 2 : 0) + (p.transparency ? 1 : 0);
}

// context set per plane: luma 0, both chroma share 1, alpha 2
// (RGB mode: G 0, B/R 1, A 2 — (p+1)/2)
int context_set(const Params& p, int plane) {
  if (p.colorspace == 1) return (plane + 1) / 2;
  if (p.chroma_planes && (plane == 1 || plane == 2)) return 1;
  return plane >= 1 ? 2 : 0;
}

void plane_dims(const Params& p, int plane, int* w, int* h) {
  if (p.colorspace != 1 && p.chroma_planes && (plane == 1 || plane == 2)) {
    *w = (p.width + (1 << p.h_shift) - 1) >> p.h_shift;
    *h = (p.height + (1 << p.v_shift) - 1) >> p.v_shift;
  } else {
    *w = p.width;
    *h = p.height;
  }
}

void write_header(RangeEncoder& c, const Params& p, const QuantTables& q) {
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  put_symbol(c, state, p.version, false);
  put_symbol(c, state, p.coder, false);
  put_symbol(c, state, p.colorspace, false);
  if (p.version > 0) put_symbol(c, state, p.bits, false);
  c.put(state, p.chroma_planes != 0);
  put_symbol(c, state, p.h_shift, false);
  put_symbol(c, state, p.v_shift, false);
  c.put(state, p.transparency != 0);
  for (int i = 0; i < 5; i++) write_quant_table(c, q.t[i], 0);
}

bool read_header(RangeDecoder& c, Params& p, QuantTables& q) {
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  p.version = get_symbol(c, state, false);
  if (p.version < 0 || p.version > 1) return false;  // v2+: extradata-based
  p.coder = get_symbol(c, state, false);
  if (p.coder != 1) return false;  // golomb (0) / custom table (2) unsupported
  p.colorspace = get_symbol(c, state, false);
  if (p.colorspace != 0 && p.colorspace != 1) return false;
  p.bits = p.version > 0 ? get_symbol(c, state, false) : 8;
  if (p.bits == 0) p.bits = 8;  // "0 = inherit" never written by encoders here
  if (p.bits < 1 || p.bits > 16) return false;
  if (p.colorspace == 1 && p.bits != 8) return false;  // RGB-RCT: 8-bit
  p.chroma_planes = c.get(state);
  p.h_shift = get_symbol(c, state, false);
  p.v_shift = get_symbol(c, state, false);
  p.transparency = c.get(state);
  if (p.h_shift < 0 || p.h_shift > 4 || p.v_shift < 0 || p.v_shift > 4)
    return false;
  int context_count = 1;
  for (int i = 0; i < 5; i++) {
    int ret = read_quant_table(c, q.t[i], context_count);
    if (ret < 0 || int64_t(context_count) * ret > 32768) return false;
    context_count *= ret;
  }
  q.context_count = (context_count + 1) / 2;
  q.five_input = q.t[3][127] != 0 || q.t[4][127] != 0;
  return true;
}

// ---------------------------------------------------------------------
// Version 2/3 decode (RFC 9043 section 4.2/4.3): parameters ride in
// out-of-band extradata (with their own CRC and optional custom state
// transition table), frames split into independent slices with
// range-coded headers, and the sample coder may be the Golomb-Rice
// bit coder instead of the range coder.  Decode-only — the encoder
// stays version 1 (which real libavcodec reads; see
// tests/test_interop_cv2.py).
// ---------------------------------------------------------------------

struct Extra {
  int version = 0, micro = 0, coder = 1, colorspace = 0, bits = 8;
  int chroma_planes = 0, h_shift = 0, v_shift = 0, transparency = 0;
  int num_h = 1, num_v = 1, qtc = 1, ec = 0, intra = 0;
  StateTables states;  // default, or custom when coder == 2
  std::vector<QuantTables> qts;
  std::vector<std::vector<uint8_t>> initial_states;  // per set; may be empty
};

// CRC over startcode-free bytes, NUT/MPEG-2 polynomial 0x104C11DB7
// MSB-first (ffmpeg's AV_CRC_32_IEEE) — used by the v3 extradata and
// the per-slice integrity trailers.
uint32_t crc32_ieee(const uint8_t* data, int64_t n) {
  uint32_t crc = 0;
  for (int64_t i = 0; i < n; i++) {
    crc ^= uint32_t(data[i]) << 24;
    for (int b = 0; b < 8; b++)
      crc = (crc << 1) ^ (crc & 0x80000000u ? 0x04C11DB7u : 0);
  }
  return crc;
}

bool parse_extradata(const uint8_t* data, int64_t size, Extra& e) {
  if (size < 4) return false;
  RangeDecoder c(data, size);
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  e.version = get_symbol(c, state, false);
  if (e.version < 2 || e.version > 3) return false;
  if (e.version > 2) {
    c.size = size - 4;  // the trailing CRC is not range-coded payload
    e.micro = get_symbol(c, state, false);
  }
  e.coder = get_symbol(c, state, false);
  if (e.coder != 0 && e.coder != 1 && e.coder != 2) return false;
  if (e.coder == 2) {  // custom state transition table, delta-coded
    for (int i = 1; i < 256; i++) {
      int d = get_symbol(c, state, true);
      int v = d + kStates.one[i];
      if (v < 1 || v > 255 || d == INT32_MIN) return false;
      e.states.one[i] = uint8_t(v);
    }
    for (int i = 1; i < 256; i++)
      e.states.zero[i] = uint8_t(256 - e.states.one[256 - i]);
    e.states.rebuild_trans();
  }
  e.colorspace = get_symbol(c, state, false);
  if (e.colorspace != 0 && e.colorspace != 1) return false;
  e.bits = get_symbol(c, state, false);
  if (e.bits == 0) e.bits = 8;
  if (e.bits < 1 || e.bits > 16) return false;
  e.chroma_planes = c.get(state);
  e.h_shift = get_symbol(c, state, false);
  e.v_shift = get_symbol(c, state, false);
  e.transparency = c.get(state);
  if (e.h_shift < 0 || e.h_shift > 4 || e.v_shift < 0 || e.v_shift > 4)
    return false;
  e.num_h = get_symbol(c, state, false) + 1;
  e.num_v = get_symbol(c, state, false) + 1;
  if (e.num_h < 1 || e.num_h > 256 || e.num_v < 1 || e.num_v > 256)
    return false;
  e.qtc = get_symbol(c, state, false);
  if (e.qtc < 1 || e.qtc > 8) return false;
  e.qts.resize(e.qtc);
  for (int t = 0; t < e.qtc; t++) {
    int context_count = 1;
    for (int i = 0; i < 5; i++) {
      int ret = read_quant_table(c, e.qts[t].t[i], context_count);
      if (ret < 0 || int64_t(context_count) * ret > 32768) return false;
      context_count *= ret;
    }
    e.qts[t].context_count = (context_count + 1) / 2;
    e.qts[t].five_input =
        e.qts[t].t[3][127] != 0 || e.qts[t].t[4][127] != 0;
  }
  e.initial_states.resize(e.qtc);
  for (int t = 0; t < e.qtc; t++) {
    if (!c.get(state)) continue;
    auto& ini = e.initial_states[t];
    ini.assign(size_t(e.qts[t].context_count) * kContextSize, 128);
    for (int j = 0; j < e.qts[t].context_count; j++)
      for (int k = 0; k < kContextSize; k++) {
        int pred = j ? ini[size_t(j - 1) * kContextSize + k] : 128;
        int v = get_symbol(c, state, true);
        if (v == INT32_MIN) return false;
        ini[size_t(j) * kContextSize + k] = uint8_t((pred + v) & 0xFF);
      }
  }
  if (e.version > 2) {
    e.ec = get_symbol(c, state, false);
    if (e.ec < 0 || e.ec > 2) return false;
    if (e.micro > 2) e.intra = get_symbol(c, state, false);
    // ec <= 1: the stored CRC makes the whole-extradata CRC zero.
    // ec == 2 (newer FFmpeg) uses a nonzero initial CRC value; the
    // continuation semantics are unverifiable without a sample here,
    // so integrity checking is skipped rather than rejecting valid
    // files (the range-coded parse above already bounds everything).
    if (e.ec < 2 && crc32_ieee(data, size) != 0) return false;
  }
  return true;
}

// MSB-first bit reader over a byte range; reads zero past the end.
struct BitReader {
  const uint8_t* buf;
  int64_t size;
  int64_t pos = 0;  // in bits

  BitReader(const uint8_t* b, int64_t s) : buf(b), size(s) {}

  int bit() {
    int64_t byte = pos >> 3;
    int b = byte < size ? (buf[byte] >> (7 - (pos & 7))) & 1 : 0;
    pos++;
    return b;
  }

  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | uint32_t(bit());
    return v;
  }
};

// Golomb-Rice with unary limit + escape (RFC 9043 section 4.3.3).
int get_ur_golomb(BitReader& gb, int k, int limit, int esc_len) {
  int q = 0;
  while (q < limit) {
    if (gb.bit()) break;
    q++;
  }
  if (q < limit) return (q << k) | int(gb.bits(k));
  return int(gb.bits(esc_len)) + limit - 1;
}

int get_sr_golomb(BitReader& gb, int k, int limit, int esc_len) {
  unsigned v = unsigned(get_ur_golomb(gb, k, limit, esc_len));
  return int(v >> 1) ^ -int(v & 1);
}

// Per-context adaptive Rice parameter state (RFC 9043 section 4.3.1).
struct VlcState {
  int16_t drift = 0;
  uint16_t error_sum = 4;
  int8_t bias = 0;
  uint8_t count = 1;
};

void update_vlc_state(VlcState& s, int v) {
  int drift = s.drift;
  int count = s.count;
  int bias = s.bias;
  s.error_sum = uint16_t(s.error_sum + (v < 0 ? -v : v));
  drift += v;
  if (count == 128) {
    count >>= 1;
    drift >>= 1;
    s.error_sum >>= 1;
  }
  count++;
  if (drift <= -count) {
    bias = bias - 1 > -128 ? bias - 1 : -128;
    drift = drift + count > -count + 1 ? drift + count : -count + 1;
  } else if (drift > 0) {
    bias = bias + 1 < 127 ? bias + 1 : 127;
    drift = drift - count < 0 ? drift - count : 0;
  }
  s.bias = int8_t(bias);
  s.drift = int16_t(drift);
  s.count = uint8_t(count);
}

int get_vlc_symbol(BitReader& gb, VlcState& s, int bits) {
  int k = 0;
  for (unsigned i = s.count; i < s.error_sum; i += i) k++;
  int v = get_sr_golomb(gb, k, 12, bits);
  v ^= (2 * s.drift + s.count) >> 31;  // sign flip when drift negative
  int ret = fold(v + s.bias, bits);
  update_vlc_state(s, v);
  return ret;
}

// JPEG-LS style run-length ladder (RFC 9043 section 4.3.4).
const uint8_t kLog2Run[41] = {
    0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,
    3,  3,  4,  4,  5,  5,  6,  6,  7,  7,  8,  9,  10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
};

struct GolombPlaneState {
  std::vector<VlcState> vlc;
  void reset(int context_count) {
    vlc.assign(size_t(context_count), VlcState());
  }
};

// One line in Golomb-Rice mode; run_index persists across lines.
void golomb_decode_line(BitReader& gb, const QuantTables& q,
                        GolombPlaneState& pc, int32_t* cur,
                        const int32_t* above, const int32_t* above2, int w,
                        int bits, int& run_index) {
  const int mask = (1 << bits) - 1;
  const bool wrap16 = bits == 16;  // see encode_plane
  int run_count = 0;
  int run_mode = 0;
  for (int x = 0; x < w; x++) {
    int ctx = context_of(q, cur, above, above2, x);
    bool flip = ctx < 0;
    if (flip) ctx = -ctx;
    int diff;
    if (ctx == 0 && run_mode == 0) run_mode = 1;
    if (run_mode) {
      if (run_count == 0 && run_mode == 1) {
        if (gb.bit()) {
          run_count = 1 << kLog2Run[run_index];
          if (x + run_count <= w) run_index++;
        } else {
          run_count = kLog2Run[run_index]
                          ? int(gb.bits(kLog2Run[run_index]))
                          : 0;
          if (run_index) run_index--;
          run_mode = 2;
        }
      }
      run_count--;
      if (run_count < 0) {
        run_mode = 0;
        run_count = 0;
        diff = get_vlc_symbol(gb, pc.vlc[ctx], bits);
        if (diff >= 0) diff++;  // zero cannot break a run
      } else {
        diff = 0;
      }
    } else {
      diff = get_vlc_symbol(gb, pc.vlc[ctx], bits);
    }
    if (flip) diff = -diff;
    int v = (predict(cur, above, x) + diff) & mask;
    cur[x] = wrap16 ? int32_t(int16_t(v)) : v;
  }
}

// Range-coder line (shared helper for the v3 slice path).
bool rac_decode_line(RangeDecoder& c, const QuantTables& q, uint8_t* states,
                     int32_t* cur, const int32_t* above,
                     const int32_t* above2, int w, int bits) {
  const int mask = (1 << bits) - 1;
  const bool wrap16 = bits == 16;  // see encode_plane
  for (int x = 0; x < w; x++) {
    int ctx = context_of(q, cur, above, above2, x);
    bool flip = ctx < 0;
    if (flip) ctx = -ctx;
    int diff = get_symbol(c, states + size_t(ctx) * kContextSize, true);
    if (diff == INT32_MIN) return false;
    if (flip) diff = -diff;
    int v = (predict(cur, above, x) + diff) & mask;
    cur[x] = wrap16 ? int32_t(int16_t(v)) : v;
  }
  return true;
}

struct SliceCoder {
  // one of the two, per e.coder
  RangeDecoder* rac = nullptr;
  BitReader* gb = nullptr;
};

// Per-slice context-set state (range states or VLC states).
struct SliceContexts {
  PlaneContexts rac[3];
  GolombPlaneState vlc[3];
  int quant_idx[3] = {0, 0, 0};
};

// Decode one plane region of a slice into dst (sample units).
template <typename Sample>
bool v3_decode_plane(const Extra& e, SliceCoder& co, SliceContexts& sc,
                     int set, Sample* dst, int64_t stride, int w, int h,
                     int bits, int& run_index) {
  const QuantTables& q = e.qts[sc.quant_idx[set]];
  Ring ring;
  ring.init(w);
  if (e.coder == 0) run_index = 0;  // reset per plane (YCbCr mode)
  for (int y = 0; y < h; y++) {
    ring.rotate(w);
    int32_t* cur = ring.row[0];
    if (e.coder == 0) {
      golomb_decode_line(*co.gb, q, sc.vlc[set], cur, ring.row[1],
                         ring.row[2], w, bits, run_index);
    } else {
      if (!rac_decode_line(*co.rac, q, sc.rac[set].states.data(), cur,
                           ring.row[1], ring.row[2], w, bits))
        return false;
    }
    for (int x = 0; x < w; x++)
      dst[y * stride + x] = Sample(cur[x] & ((1 << bits) - 1));
  }
  return true;
}

// RGB (colorspace 1): planes code line-interleaved G,B,R[,A] with a
// reversible color transform (RFC 9043 section 3.7.2).  dst points at
// the slice's top row of each plane; xoff is the slice's column.
template <typename Sample>
bool v3_decode_rgb(const Extra& e, SliceCoder& co, SliceContexts& sc,
                   Sample* const* dst, const int64_t* strides, int64_t xoff,
                   int w, int h) {
  const int bits = e.bits;
  const int cbits = bits <= 8 ? 9 : bits + 1;  // coded sample width
  const int offset = 1 << bits;
  const int np = 3 + (e.transparency ? 1 : 0);
  std::vector<Ring> rings(np);
  for (int p = 0; p < np; p++) rings[p].init(w);
  int run_index = 0;  // shared across planes in RGB mode
  for (int y = 0; y < h; y++) {
    int32_t* rows[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int p = 0; p < np; p++) {
      rings[p].rotate(w);
      int set = (p + 1) / 2;  // G:0, B/R:1, A:2
      const QuantTables& q = e.qts[sc.quant_idx[set]];
      // EVERY plane (alpha included) codes at bits+1 in RGB mode
      if (e.coder == 0) {
        golomb_decode_line(*co.gb, q, sc.vlc[set], rings[p].row[0],
                           rings[p].row[1], rings[p].row[2], w, cbits,
                           run_index);
      } else {
        if (!rac_decode_line(*co.rac, q, sc.rac[set].states.data(),
                             rings[p].row[0], rings[p].row[1],
                             rings[p].row[2], w, cbits))
          return false;
      }
      rows[p] = rings[p].row[0];
    }
    for (int x = 0; x < w; x++) {
      int g = rows[0][x];
      int b = rows[1][x] - offset;
      int r = rows[2][x] - offset;
      g -= (b + r) >> 2;
      b += g;
      r += g;
      dst[0][y * strides[0] + xoff + x] = Sample(g);
      dst[1][y * strides[1] + xoff + x] = Sample(b);
      dst[2][y * strides[2] + xoff + x] = Sample(r);
      if (np == 4) dst[3][y * strides[3] + xoff + x] = Sample(rows[3][x]);
    }
  }
  return true;
}

int v3_context_sets(const Extra& e) { return 2 + (e.transparency ? 1 : 0); }

// Decode one version-3 slice.  slice bytes span [data, data+len);
// `first` inherits the frame-level coder position (the keyframe bit
// was consumed from the same byte range).
template <typename Sample>
bool v3_decode_slice(const Extra& e, const uint8_t* data, int64_t len,
                     bool first, bool key, Sample* const* planes,
                     const int64_t* strides, int width, int height,
                     std::vector<SliceContexts>& slice_state, int& slice_no) {
  const StateTables* tables = e.coder == 2 ? &e.states : &kStates;
  RangeDecoder c(data, len, tables);
  if (first) {
    uint8_t keystate = 128;
    c.get(&keystate);  // the keyframe bit rides in slice 0's bytes
  }
  // --- slice header (always range-coded) --------------------------
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  int sx = get_symbol(c, state, false);
  int sy = get_symbol(c, state, false);
  int sw = get_symbol(c, state, false) + 1;
  int sh = get_symbol(c, state, false) + 1;
  if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > e.num_h - sw ||
      sy > e.num_v - sh)
    return false;
  int x0 = int(int64_t(sx) * width / e.num_h);
  int y0 = int(int64_t(sy) * height / e.num_v);
  int x1 = int(int64_t(sx + sw) * width / e.num_h);
  int y1 = int(int64_t(sy + sh) * height / e.num_v);
  // per-slice persistent contexts keyed by slice grid position
  int idx = sy * e.num_h + sx;
  if (idx < 0 || idx >= int(slice_state.size())) return false;
  SliceContexts& sc = slice_state[idx];
  slice_no = idx;
  for (int s = 0; s < v3_context_sets(e); s++) {
    int qi = get_symbol(c, state, false);
    if (qi < 0 || qi >= e.qtc) return false;
    sc.quant_idx[s] = qi;
  }
  get_symbol(c, state, false);  // picture_structure
  get_symbol(c, state, false);  // sar num
  get_symbol(c, state, false);  // sar den
  if (key) {
    for (int s = 0; s < v3_context_sets(e); s++) {
      int cc = e.qts[sc.quant_idx[s]].context_count;
      if (e.coder == 0) {
        sc.vlc[s].reset(cc);
      } else {
        const auto& ini = e.initial_states[sc.quant_idx[s]];
        if (!ini.empty()) {
          sc.rac[s].states.assign(ini.begin(), ini.end());
        } else {
          sc.rac[s].reset(cc);
        }
      }
    }
  } else {
    for (int s = 0; s < v3_context_sets(e); s++) {
      int cc = e.qts[sc.quant_idx[s]].context_count;
      bool sized = e.coder == 0
                       ? sc.vlc[s].vlc.size() == size_t(cc)
                       : sc.rac[s].states.size() == size_t(cc) * 32;
      if (!sized) return false;  // inter slice before its keyframe
    }
  }
  // --- coder handoff ----------------------------------------------
  SliceCoder co;
  BitReader gb(nullptr, 0);
  if (e.coder == 0) {
    if (e.version == 3 && e.micro > 1) {
      uint8_t align = 129;
      c.get(&align);
    }
    int64_t consumed = c.pos - 1;  // the decoder prefetches one byte
    if (consumed < 0 || consumed > len) return false;
    gb = BitReader(data + consumed, len - consumed);
    co.gb = &gb;
  } else {
    co.rac = &c;
  }
  // --- sample data -------------------------------------------------
  int wsl = x1 - x0, hsl = y1 - y0;
  if (wsl <= 0 || hsl <= 0) return false;
  if (e.colorspace == 1) {
    Sample* base[4];
    int np = 3 + (e.transparency ? 1 : 0);
    for (int p = 0; p < np; p++)
      base[p] = planes[p] + int64_t(y0) * strides[p];
    return v3_decode_rgb(e, co, sc, base, strides, x0, wsl, hsl);
  }
  // YCbCr: luma, then ceil-shifted chroma, then alpha
  int run_index = 0;
  if (!v3_decode_plane(e, co, sc, 0,
                       planes[0] + int64_t(y0) * strides[0] + x0,
                       strides[0], wsl, hsl, e.bits, run_index))
    return false;
  if (e.chroma_planes) {
    int cw = (wsl + (1 << e.h_shift) - 1) >> e.h_shift;
    int ch = (hsl + (1 << e.v_shift) - 1) >> e.v_shift;
    int cx = x0 >> e.h_shift, cy = y0 >> e.v_shift;
    for (int p = 1; p <= 2; p++)
      if (!v3_decode_plane(e, co, sc, 1,
                           planes[p] + int64_t(cy) * strides[p] + cx,
                           strides[p], cw, ch, e.bits, run_index))
        return false;
  }
  if (e.transparency) {
    int p = e.chroma_planes ? 3 : 1;
    if (!v3_decode_plane(e, co, sc, 2,
                         planes[p] + int64_t(y0) * strides[p] + x0,
                         strides[p], wsl, hsl, e.bits, run_index))
      return false;
  }
  return true;
}

// Walk a v3 packet's slice table (sizes trail the packet) and decode
// every slice.
template <typename Sample>
bool v3_decode_frame(const Extra& e, const uint8_t* data, int64_t size,
                     Sample* const* planes, const int64_t* strides,
                     int width, int height,
                     std::vector<SliceContexts>& slice_state) {
  // keyframe bit (frame level)
  const StateTables* tables = e.coder == 2 ? &e.states : &kStates;
  RangeDecoder c(data, size, tables);
  uint8_t keystate = 128;
  bool key = c.get(&keystate);
  if (!key && e.intra) return false;
  // slice spans from the trailing size fields, walked back to front
  // (RFC 9043 section 4.4: every v3 slice ends with a 24-bit size
  // plus, when ec is set, an error-status byte and a CRC)
  const int trailer = 3 + (e.ec ? 5 : 0);
  const int nslices = e.num_h * e.num_v;
  std::vector<std::pair<int64_t, int64_t>> spans;  // (offset, len)
  int64_t end = size;
  for (int i = nslices - 1; i >= 0; i--) {
    if (i == 0 && e.version == 2) {
      // version 2: the first slice has no trailing size field — it
      // spans whatever remains at the packet head
      spans.emplace_back(0, end);
      end = 0;
      break;
    }
    if (end < trailer) return false;
    int64_t v = (int64_t(data[end - trailer]) << 16) |
                (int64_t(data[end - trailer + 1]) << 8) |
                int64_t(data[end - trailer + 2]);
    v += trailer;
    if (v > end) return false;
    spans.emplace_back(end - v, v);
    end -= v;
  }
  if (end != 0) return false;  // slice 0 must start at the packet head
  if (e.ec == 1) {
    for (auto& [off, len] : spans)
      if (crc32_ieee(data + off, len) != 0) return false;
  }
  // decode front to back (spans were collected back to front)
  for (auto it = spans.rbegin(); it != spans.rend(); ++it) {
    int slice_no = -1;
    if (!v3_decode_slice(e, data + it->first, it->second,
                         it->first == 0, key, planes, strides, width,
                         height, slice_state, slice_no))
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------
// Version 3 encode (RFC 9043 sections 4.2-4.4): parameters ride in
// out-of-band extradata (range-coded, CRC-sealed), every frame is a
// keyframe (intra=1) split into an independent-slice grid — each slice
// carries its own range coder, contexts, and a trailing
// 24-bit-size + error-status + CRC-32 trailer (ec=1), so decode (and
// this encoder) parallelize across slices.  The slice geometry is the
// plain floor rule the v3 decoder uses (x0 = sx*width/num_h; chroma
// regions derived with the same shifts as v3_decode_slice), which
// matches real libavcodec — our decoder was validated bit-exactly
// against cv2-written multi-slice FFV1 v3 at non-divisible sizes.
// The reference's default codec is libavcodec's FFV1
// (motion/motion.c:447, zoom/zoom.c:306, scan/scan.c:326); like
// ffmpeg, the default stays version 1 and v3 is the `level=3` opt-in.
// ---------------------------------------------------------------------

constexpr int kMicroVersion = 4;  // v3.4: intra flag is coded

void wb24(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 16);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v);
}

void wb32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

bool v3_enc_supported(const Params& p, int num_h, int num_v) {
  if (p.width <= 0 || p.height <= 0) return false;
  if (num_h < 1 || num_h > 256 || num_v < 1 || num_v > 256) return false;
  if (num_h > p.width || num_v > p.height) return false;
  if (p.bits < 8 || p.bits > 16) return false;
  if (p.colorspace != 0 && p.colorspace != 1) return false;
  if (p.colorspace == 1 && (p.h_shift || p.v_shift)) return false;
  if (p.h_shift < 0 || p.h_shift > 4 || p.v_shift < 0 || p.v_shift > 4)
    return false;
  if (p.transparency) return false;  // no alpha pixel format upstream
  // interior slice boundaries must land on the chroma grid: the slice
  // chroma region is [x0 >> shift, (x0 >> shift) + ceil(wsl >> shift))
  // (v3_decode_slice, matching libavcodec), so a misaligned boundary
  // leaves a never-coded chroma column/row on one side of it
  for (int sx = 1; sx < num_h; sx++)
    if ((int64_t(sx) * p.width / num_h) & ((1 << p.h_shift) - 1))
      return false;
  for (int sy = 1; sy < num_v; sy++)
    if ((int64_t(sy) * p.height / num_v) & ((1 << p.v_shift) - 1))
      return false;
  return true;
}

// Extradata (NUT codec_specific_data / matroska CodecPrivate): the
// mirror of parse_extradata — version 3.4, range coder 1, one quant
// table set, no initial states, ec=1, intra=1, sealed with a trailing
// big-endian CRC-32 that makes the whole buffer CRC to zero.
int64_t v3_write_extradata(const Params& p, int num_h, int num_v,
                           uint8_t* out, int64_t cap) {
  if (!v3_enc_supported(p, num_h, num_v)) return -2;
  QuantTables q = encoder_quant_tables();
  RangeEncoder c(out, cap);
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  put_symbol(c, state, 3, false);              // version
  put_symbol(c, state, kMicroVersion, false);  // micro version
  put_symbol(c, state, 1, false);              // coder: range, default table
  put_symbol(c, state, p.colorspace, false);
  put_symbol(c, state, p.bits, false);
  c.put(state, p.chroma_planes != 0);
  put_symbol(c, state, p.h_shift, false);
  put_symbol(c, state, p.v_shift, false);
  c.put(state, p.transparency != 0);
  put_symbol(c, state, num_h - 1, false);
  put_symbol(c, state, num_v - 1, false);
  put_symbol(c, state, 1, false);  // quant table count
  for (int i = 0; i < 5; i++) write_quant_table(c, q.t[i], 0);
  c.put(state, false);             // no initial states for set 0
  put_symbol(c, state, 1, false);  // ec: per-slice CRC
  put_symbol(c, state, 1, false);  // intra: every frame a keyframe
  int64_t n = c.terminate();
  if (n < 0 || n + 4 > cap) return -1;
  wb32(out + n, crc32_ieee(out, n));  // whole-extradata CRC == 0
  return n + 4;
}

struct SliceGeom {
  int sx, sy, x0, y0, w, h;
};

// Encode one slice's coder payload (keyframe bit for slice 0, header,
// fresh contexts, samples) into scratch; returns payload bytes or -1.
template <typename Sample>
int64_t v3_encode_slice(const Params& p, const QuantTables& q,
                        const SliceGeom& g, const Sample* const* planes,
                        const int64_t* strides, uint8_t* scratch,
                        int64_t cap) {
  RangeEncoder c(scratch, cap);
  if (g.sx == 0 && g.sy == 0) {
    uint8_t ks = 128;
    c.put(&ks, true);  // keyframe bit rides in slice 0's bytes
  }
  uint8_t state[kContextSize];
  std::memset(state, 128, sizeof(state));
  const int nsets = 2 + (p.transparency ? 1 : 0);
  put_symbol(c, state, g.sx, false);
  put_symbol(c, state, g.sy, false);
  put_symbol(c, state, 0, false);  // slice_width - 1 (in grid cells)
  put_symbol(c, state, 0, false);  // slice_height - 1
  for (int s = 0; s < nsets; s++)
    put_symbol(c, state, 0, false);  // quant table index
  put_symbol(c, state, 0, false);    // picture_structure: unknown
  put_symbol(c, state, 0, false);    // sample aspect ratio 0/1
  put_symbol(c, state, 1, false);
  PlaneContexts sets[3];
  for (int s = 0; s < nsets; s++) sets[s].reset(q.context_count);
  if (p.colorspace == 1) {
    const Sample* base[4];
    for (int pl = 0; pl < 3; pl++)
      base[pl] = planes[pl] + int64_t(g.y0) * strides[pl];
    encode_rgb_region(c, q, sets, base, strides, g.x0, g.w, g.h, p.bits,
                      0);
  } else {
    encode_plane(c, q, sets[0],
                 planes[0] + int64_t(g.y0) * strides[0] + g.x0, strides[0],
                 g.w, g.h, p.bits);
    if (p.chroma_planes) {
      int cw = (g.w + (1 << p.h_shift) - 1) >> p.h_shift;
      int ch = (g.h + (1 << p.v_shift) - 1) >> p.v_shift;
      int cx = g.x0 >> p.h_shift, cy = g.y0 >> p.v_shift;
      for (int pl = 1; pl <= 2; pl++)
        encode_plane(c, q, sets[1],
                     planes[pl] + int64_t(cy) * strides[pl] + cx,
                     strides[pl], cw, ch, p.bits);
    }
  }
  return c.terminate_v3();
}

template <typename Sample>
int64_t v3_encode_frame(const Params& p, int num_h, int num_v,
                        const Sample* const* planes, const int64_t* strides,
                        uint8_t* out, int64_t cap) {
  QuantTables q = encoder_quant_tables();
  const int nslices = num_h * num_v;
  std::vector<SliceGeom> geoms(nslices);
  std::vector<std::vector<uint8_t>> bufs(nslices);
  std::vector<int64_t> lens(nslices);
  for (int sy = 0; sy < num_v; sy++)
    for (int sx = 0; sx < num_h; sx++) {
      SliceGeom& g = geoms[sy * num_h + sx];
      g.sx = sx;
      g.sy = sy;
      g.x0 = int(int64_t(sx) * p.width / num_h);
      g.y0 = int(int64_t(sy) * p.height / num_v);
      g.w = int(int64_t(sx + 1) * p.width / num_h) - g.x0;
      g.h = int(int64_t(sy + 1) * p.height / num_v) - g.y0;
    }
  auto work = [&](int i) {
    const SliceGeom& g = geoms[i];
    int64_t samples;
    if (p.colorspace == 1) {
      samples = int64_t(g.w) * g.h * 3;
    } else {
      samples = int64_t(g.w) * g.h;
      if (p.chroma_planes) {
        int cw = (g.w + (1 << p.h_shift) - 1) >> p.h_shift;
        int ch = (g.h + (1 << p.v_shift) - 1) >> p.v_shift;
        samples += 2 * int64_t(cw) * ch;
      }
    }
    const int per = (p.bits <= 8 && p.colorspace == 0) ? 5 : 9;
    bufs[i].resize(size_t(samples) * per + 4096);
    lens[i] = v3_encode_slice(p, q, g, planes, strides, bufs[i].data(),
                              int64_t(bufs[i].size()));
  };
  unsigned hw = std::thread::hardware_concurrency();
  unsigned nthreads =
      hw > 1 ? std::min<unsigned>(hw, unsigned(nslices)) : 1;
  if (nthreads > 1) {
    std::vector<std::thread> pool;
    std::atomic<int> next{0};
    for (unsigned t = 0; t < nthreads; t++)
      pool.emplace_back([&] {
        for (int i; (i = next.fetch_add(1)) < nslices;) work(i);
      });
    for (auto& th : pool) th.join();
  } else {
    for (int i = 0; i < nslices; i++) work(i);
  }
  // assemble in slice order with size/status/CRC trailers
  int64_t pos = 0;
  for (int i = 0; i < nslices; i++) {
    int64_t n = lens[i];
    if (n < 0 || pos + n + 8 > cap) return -1;
    std::memcpy(out + pos, bufs[i].data(), size_t(n));
    wb24(out + pos + n, uint32_t(n));
    out[pos + n + 3] = 0;  // error status: clean
    wb32(out + pos + n + 4, crc32_ieee(out + pos, n + 4));  // span CRC == 0
    pos += n + 8;
  }
  return pos;
}

struct Decoder {
  Params params;
  QuantTables quant;
  PlaneContexts contexts[3];
  bool have_params = false;
  Extra* extra = nullptr;  // version >= 2: out-of-band parameters
  std::vector<SliceContexts> v3_state;
  ~Decoder() { delete extra; }
};

}  // namespace

// ---------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------

extern "C" {

// Encode one keyframe.  planes: plane_count pointers (uint8 when
// bits <= 8, uint16 otherwise); strides in SAMPLES.  Returns the
// packet size, or -1 if out_cap was too small.
int64_t ffv1_encode(const uint8_t* const* planes, const int64_t* strides,
                    const Params* params, uint8_t* out, int64_t out_cap) {
  const Params& p = *params;
  RangeEncoder c(out, out_cap);
  uint8_t keystate = 128;
  c.put(&keystate, true);  // keyframe
  QuantTables q = encoder_quant_tables();
  write_header(c, p, q);
  PlaneContexts contexts[3];
  for (auto& pc : contexts) pc.reset(q.context_count);
  if (p.colorspace == 1) {
    if (p.bits != 8) return -2;  // v0/1 RGB-RCT is 8-bit (use v3)
    encode_rgb_region(c, q, contexts, planes, strides, 0, p.width,
                      p.height, p.bits, p.transparency);
    return c.terminate();
  }
  for (int pl = 0; pl < plane_count(p); pl++) {
    int w, h;
    plane_dims(p, pl, &w, &h);
    PlaneContexts& pc = contexts[context_set(p, pl)];
    if (p.bits <= 8)
      encode_plane(c, q, pc, planes[pl], strides[pl], w, h, p.bits);
    else
      encode_plane(c, q, pc,
                   reinterpret_cast<const uint16_t*>(planes[pl]),
                   strides[pl], w, h, p.bits);
  }
  return c.terminate();
}

// Parse the parameter set of a keyframe packet into *params
// (width/height are left untouched — they come from the container).
// Returns 1 on success, 0 if not a supported FFV1 keyframe.
int32_t ffv1_probe(const uint8_t* data, int64_t size, Params* params) {
  RangeDecoder c(data, size);
  uint8_t keystate = 128;
  if (!c.get(&keystate)) return 0;  // inter frame: no parameter set
  QuantTables q;
  Params p = *params;
  if (!read_header(c, p, q)) return 0;
  int32_t w = params->width, h = params->height;
  *params = p;
  params->width = w;
  params->height = h;
  return 1;
}

void* ffv1_decoder_new(void) { return new Decoder(); }

void ffv1_decoder_free(void* dec) { delete static_cast<Decoder*>(dec); }

// Install version>=2 out-of-band parameters (NUT codec_specific_data /
// matroska CodecPrivate).  Fills *params from the extra header.
// Returns 1 on success, 0 on unsupported/corrupt extradata.
int32_t ffv1_set_extradata(void* handle, const uint8_t* data, int64_t size,
                           Params* params) {
  Decoder& d = *static_cast<Decoder*>(handle);
  auto e = new Extra();
  if (!parse_extradata(data, size, *e)) {
    delete e;
    return 0;
  }
  delete d.extra;
  d.extra = e;
  if (params) {
    params->version = e->version;
    params->coder = e->coder;
    params->colorspace = e->colorspace;
    params->bits = e->bits;
    params->chroma_planes = e->chroma_planes;
    params->h_shift = e->h_shift;
    params->v_shift = e->v_shift;
    params->transparency = e->transparency;
  }
  return 1;
}

// Decode one packet into caller-allocated planes (layout per the
// parameter set; strides in samples).  Keyframes refresh the parameter
// set and reset contexts; inter frames continue adaptation (RFC 9043
// section 4.3).  Returns 1 on success, 0 on unsupported/corrupt data.
int32_t ffv1_decode(void* handle, const uint8_t* data, int64_t size,
                    uint8_t* const* planes, const int64_t* strides,
                    Params* out_params) {
  Decoder& d = *static_cast<Decoder*>(handle);
  if (d.extra) {  // version >= 2: slice-based decode
    const Extra& e = *d.extra;
    int w = out_params ? out_params->width : d.params.width;
    int h = out_params ? out_params->height : d.params.height;
    if (w <= 0 || h <= 0) return 0;
    static_assert(sizeof(void*) == 8, "");
    if (d.v3_state.size() != size_t(e.num_h) * e.num_v)
      d.v3_state.assign(size_t(e.num_h) * e.num_v, SliceContexts());
    bool ok;
    if (e.bits <= 8)
      ok = v3_decode_frame(e, data, size, planes, strides, w, h,
                           d.v3_state);
    else
      ok = v3_decode_frame(e, data, size,
                           reinterpret_cast<uint16_t* const*>(planes),
                           strides, w, h, d.v3_state);
    if (ok && out_params) {
      Params p;
      p.version = e.version;
      p.coder = e.coder;
      p.colorspace = e.colorspace;
      p.bits = e.bits;
      p.chroma_planes = e.chroma_planes;
      p.h_shift = e.h_shift;
      p.v_shift = e.v_shift;
      p.transparency = e.transparency;
      p.width = w;
      p.height = h;
      *out_params = p;
    }
    return ok ? 1 : 0;
  }
  RangeDecoder c(data, size);
  uint8_t keystate = 128;
  bool key = c.get(&keystate);
  if (key) {
    Params p;
    p.width = d.params.width;
    p.height = d.params.height;
    if (out_params) {
      p.width = out_params->width;
      p.height = out_params->height;
    }
    // parse into locals and commit ONLY after every check passes: a
    // rejected header must not leave torn decoder state (quant tables
    // whose premultiplied entries index past the still-old context
    // vectors on the next inter frame)
    QuantTables q;
    if (!read_header(c, p, q)) return 0;
    if (d.have_params &&
        (p.colorspace != d.params.colorspace || p.bits != d.params.bits ||
         p.chroma_planes != d.params.chroma_planes ||
         p.h_shift != d.params.h_shift || p.v_shift != d.params.v_shift ||
         p.transparency != d.params.transparency)) {
      // the caller sized its plane buffers from the first keyframe; a
      // mid-stream parameter change (corrupt or hostile data) must not
      // redirect writes into them
      return 0;
    }
    d.params = p;
    d.quant = q;
    for (auto& pc : d.contexts) pc.reset(d.quant.context_count);
    d.have_params = true;
  } else if (!d.have_params) {
    return 0;  // inter frame before any keyframe
  }
  const Params& p = d.params;
  if (p.colorspace == 1) {
    if (!decode_rgb_v01(c, d.quant, d.contexts, planes, strides, p.width,
                        p.height, p.bits, p.transparency))
      return 0;
    if (out_params) *out_params = p;
    return 1;
  }
  for (int pl = 0; pl < plane_count(p); pl++) {
    int w, h;
    plane_dims(p, pl, &w, &h);
    PlaneContexts& pc = d.contexts[context_set(p, pl)];
    bool ok;
    if (p.bits <= 8)
      ok = decode_plane(c, d.quant, pc, planes[pl], strides[pl], w, h, p.bits);
    else
      ok = decode_plane(c, d.quant, pc,
                        reinterpret_cast<uint16_t*>(planes[pl]),
                        strides[pl], w, h, p.bits);
    if (!ok) return 0;
  }
  if (out_params) *out_params = p;
  return 1;
}

// Write version-3 extradata for ffv1_encode_v3 streams (NUT
// codec_specific_data / matroska CodecPrivate).  Returns the byte
// count, -1 if cap is too small, -2 on unsupported parameters.
int64_t ffv1_extradata(const Params* params, int32_t num_h, int32_t num_v,
                       uint8_t* out, int64_t cap) {
  return v3_write_extradata(*params, num_h, num_v, out, cap);
}

// Encode one version-3 keyframe as a num_h x num_v independent-slice
// grid (slice-parallel when the host has cores).  The packet pairs
// with ffv1_extradata's parameter set (same Params/num_h/num_v).
// Returns the packet size, -1 if out_cap was too small, -2 on
// unsupported parameters.
int64_t ffv1_encode_v3(const uint8_t* const* planes, const int64_t* strides,
                       const Params* params, int32_t num_h, int32_t num_v,
                       uint8_t* out, int64_t out_cap) {
  const Params& p = *params;
  if (!v3_enc_supported(p, num_h, num_v)) return -2;
  if (p.bits <= 8)
    return v3_encode_frame(p, num_h, num_v, planes, strides, out, out_cap);
  return v3_encode_frame(p, num_h, num_v,
                         reinterpret_cast<const uint16_t* const*>(planes),
                         strides, out, out_cap);
}

// Worst-case packet size for ffv1_encode's out buffer.  A symbol costs
// at most ~2(bits+3) coded bits, and coding a bit against a
// mis-adapted state costs up to ~1.6 real bits sustained — 5 B/sample
// (8-bit) / 9 B/sample (16-bit) bounds that with margin; the encoder
// still checks overflow and fails cleanly rather than trusting this.
int64_t ffv1_max_packet(const Params* params) {
  const Params& p = *params;
  int64_t samples = 0;
  for (int pl = 0; pl < plane_count(p); pl++) {
    int w, h;
    plane_dims(p, pl, &w, &h);
    samples += int64_t(w) * h;
  }
  // RGB codes every plane at up to bits+1 coded bits: use the 16-bit
  // bound whenever the coded width exceeds 8 bits.  The v3 slice grid
  // adds at most 256*256 trailers + headers, inside the 16 MB slack.
  const int per = (p.bits <= 8 && p.colorspace == 0) ? 5 : 9;
  return samples * per + (int64_t(256) * 256 * 64 + 65536);
}

}  // extern "C"
