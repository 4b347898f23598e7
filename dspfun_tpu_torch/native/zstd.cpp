// Zstandard (RFC 8878) decoded as libzstd 1.5 decodes it, for the
// Zstandard strips and tiles of TIFF (compression 50000) that
// dspfun_tpu_torch/io/imgcodecs.py reads.
//
// libtiff's ZSTDDecode (tif_zstd.c) hands a strip to ZSTD_decompressStream
// with the strip's size as the output buffer and stops when a call
// returns 0 (a frame decoded and flushed), the input is used up or the
// output is full; fewer bytes than the strip holds is its "Not enough
// data".  zst_strip_decode follows that one call of ZSTD_decompressStream
// (buffered output, no dictionary, windowLogMax 27):
//
//   * one frame a strip: a skippable frame, or a frame shorter than the
//     strip, leaves it short; what follows the frame is never read;
//   * a frame whose content size is in its header and fits the strip,
//     and whose blocks all lie in the input, is decoded whole
//     (ZSTD_decompress's checks, no window limit);
//   * any other frame block by block: a window past 2^27 + 1 bytes or a
//     block past the frame's largest is an error, a compressed block
//     is decoded only when all of it is in the input (a raw one as far as
//     the input goes), and once the strip is full the decoder goes on to
//     the next unit of the frame (a block header, a block, the checksum)
//     until one yields bytes that do not fit, the input ends, the frame
//     ends or an error is found;
//   * the content checksum (the low 32 bits of XXH64, seed 0) is checked
//     where the frame has one and the decoder reaches it.
//
// Literals: raw, RLE, Huffman-coded in 1 or 4 streams with a new table
// (FSE-coded or direct 4-bit weights, the last weight implied) or the
// previous one ("treeless").  libzstd reads a single stream with its
// single-symbol decoder and 4 streams with the one HUF_selectDecoder
// picks; the double-symbol decoder ends a stream whose last code leaves a
// second one in its lookup otherwise (HUF_decodeLastSymbolX2), which
// decides whether a damaged stream ends where it should.  Sequences: the
// predefined, RLE, FSE-compressed and repeat modes of the literal length,
// offset and match length tables, read from one backward bit stream; the
// repeat offsets (1, 4, 8 at a frame's start), with the literal length 0
// shift and offset value 3 meaning the first repeat offset less one.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error : int {
  kCorrupt = -1,      // corruption_detected (and literals_headerWrong, tableLog_tooLarge, ...)
  kPrefix = -2,       // prefix_unknown: no Zstandard or skippable magic number
  kUnsupported = -3,  // frameParameter_unsupported: a reserved bit set
  kWindow = -4,       // frameParameter_windowTooLarge
  kDictionary = -5,   // dictionary_wrong: a dictionary ID (libtiff loads none)
  kChecksum = -6,     // checksum_wrong
  kDstSize = -7,      // dstSize_tooSmall
  kSrcSize = -8,      // srcSize_wrong
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippable = 0x184D2A50u;
constexpr int64_t kBlockMax = 128 * 1024;
constexpr uint64_t kMaxWindow = (uint64_t{1} << 27) + 1;   // ZSTD_MAXWINDOWSIZE_DEFAULT

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }
inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t{p[1]} << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t{p[2]} << 16); }
inline uint32_t le32(const uint8_t* p) { return le16(p) | (le16(p + 2) << 16); }
inline uint64_t le64(const uint8_t* p) { return le32(p) | (uint64_t{le32(p + 4)} << 32); }

// ---- XXH64 ------------------------------------------------------------------

constexpr uint64_t kP1 = 11400714785074694791ull, kP2 = 14029467366897019727ull,
                   kP3 = 1609587929392839161ull, kP4 = 9650029242287828579ull,
                   kP5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t v) { return rotl(acc + v * kP2, 31) * kP1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * kP1 + kP4; }

uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = kP5;
  }
  h += static_cast<uint64_t>(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * kP1 + kP4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t{le32(p)} * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  return h ^ (h >> 32);
}

// ---- the backward bit stream (libzstd's BIT_DStream) ---------------------------
//
// The bits of a stream are read from its last byte's highest set bit (the
// marker) down; ``pos`` counts the bits left.  Reads past the stream's
// start give zeros (libzstd's past-the-start reads are checked by
// overflowed() before any value read so is used).
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0;
  int64_t pos = 0;

  void init(const uint8_t* src, int64_t len) {
    if (len < 1) fail(kSrcSize);
    if (src[len - 1] == 0) fail(kCorrupt);
    p = src;
    n = len;
    pos = 8 * (len - 1) + highbit(src[len - 1]);
  }
  uint64_t load(int64_t byte) const {
    if (byte + 8 <= n) {
      uint64_t v;
      std::memcpy(&v, p + byte, 8);
      return v;
    }
    uint64_t v = 0;
    for (int64_t k = n - 1; k >= byte; k--) v = (v << 8) | p[k];
    return v;
  }
  uint32_t peek(int nb) const {
    int64_t at = pos - nb;
    if (at >= 0) return static_cast<uint32_t>((load(at >> 3) >> (at & 7)) & ((uint64_t{1} << nb) - 1));
    if (pos <= 0) return 0;
    return static_cast<uint32_t>((load(0) & ((uint64_t{1} << pos) - 1)) << (-at));
  }
  uint32_t read(int nb) {
    if (nb == 0) return 0;
    uint32_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflowed() const { return pos < 0; }
  bool finished() const { return pos == 0; }
};

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint16_t state;    // the next state's base
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
};

// FSE_readNCount: the normalized counts of a table description of at most
// ``max_sv`` + 1 symbols read from ``src`` (libzstd's reads near the end
// of its buffer included); returns the bytes it takes.
int64_t read_ncount(const uint8_t* src, int64_t size, int max_sv, int max_log, int16_t* norm,
                    int* sv_out, int* log_out) {
  if (size < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, src, size > 0 ? size : 0);
    int64_t got = read_ncount(buf, 8, max_sv, max_log, norm, sv_out, log_out);
    if (got > size) fail(kCorrupt);
    return got;
  }
  const uint8_t* const istart = src;
  const uint8_t* const iend = src + size;
  const uint8_t* ip = src;
  const int max_sv1 = max_sv + 1;
  for (int k = 0; k <= max_sv; k++) norm[k] = 0;
  uint32_t stream = le32(ip);
  int nbits = (stream & 0xF) + 5;
  if (nbits > 15) fail(kCorrupt);
  stream >>= 4;
  int count_bits = 4;
  const int log = nbits;
  int remaining = (1 << nbits) + 1;
  int threshold = 1 << nbits;
  nbits++;
  int charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits -= static_cast<int>(8 * (iend - 4 - ip));
      count_bits &= 31;
      ip = iend - 4;
    }
    stream = le32(ip) >> count_bits;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= static_cast<int>(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        stream = le32(ip) >> count_bits;
        repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      stream >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += stream & 3;
      count_bits += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int mx = (2 * threshold - 1) - remaining;
      int count;
      if (static_cast<int>(stream & (threshold - 1)) < mx) {
        count = stream & (threshold - 1);
        count_bits += nbits - 1;
      } else {
        count = stream & (2 * threshold - 1);
        if (count >= threshold) count -= mx;
        count_bits += nbits;
      }
      count--;
      remaining -= count >= 0 ? count : -count;
      norm[charnum++] = static_cast<int16_t>(count);
      previous0 = count == 0;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbits = highbit(remaining) + 1;
        threshold = 1 << (nbits - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) fail(kCorrupt);
  if (charnum > max_sv1) fail(kCorrupt);
  if (count_bits > 32) fail(kCorrupt);
  if (log > max_log) fail(kCorrupt);
  *sv_out = charnum - 1;
  *log_out = log;
  ip += (count_bits + 7) >> 3;
  return ip - istart;
}

// FSE_buildDTable: symbols of count -1 at the top, the others spread.
void build_fse(FseTable& t, const int16_t* norm, int max_sv, int log) {
  const int size = 1 << log;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(max_sv + 1);
  int high = size - 1;
  for (int s = 0; s <= max_sv; s++) {
    if (norm[s] == -1) {
      t.e[high--].symbol = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int position = 0;
  for (int s = 0; s <= max_sv; s++) {
    for (int i = 0; i < norm[s]; i++) {
      t.e[position].symbol = static_cast<uint8_t>(s);
      do position = (position + step) & mask;
      while (position > high);
    }
  }
  for (int u = 0; u < size; u++) {
    const int s = t.e[u].symbol;
    const uint32_t ns = next[s]++;
    const int nb = log - highbit(ns);
    t.e[u].bits = static_cast<uint8_t>(nb);
    t.e[u].state = static_cast<uint16_t>((ns << nb) - size);
  }
}

// ---- Huffman ------------------------------------------------------------------

struct HufTable {
  int log = 0;                    // the longest code
  int target = 0;                 // the double-symbol table's log (HUF_readDTableX2)
  bool double_symbols = false;    // built by HUF_readDTableX2
  std::vector<uint16_t> e;        // symbol << 8 | code length, by the next ``log`` bits
};

// HUF_readStats then HUF_readDTableX1's canonical table; returns the
// bytes the description takes.
int64_t read_huffman(HufTable& t, const uint8_t* src, int64_t size) {
  if (size < 1) fail(kSrcSize);
  uint8_t w[256] = {0};
  int64_t isize = src[0];
  int n;
  if (isize >= 128) {
    n = static_cast<int>(isize - 127);
    isize = (n + 1) / 2;
    if (isize + 1 > size) fail(kSrcSize);
    if (n >= 256) fail(kCorrupt);
    for (int k = 0; k < n; k += 2) {
      w[k] = src[1 + k / 2] >> 4;
      w[k + 1] = src[1 + k / 2] & 15;
    }
  } else {
    if (isize + 1 > size) fail(kSrcSize);
    int16_t norm[256];
    int sv, log;
    const uint8_t* ip = src + 1;
    int64_t hdr = read_ncount(ip, isize, 255, 6, norm, &sv, &log);
    FseTable ft;
    build_fse(ft, norm, sv, log);
    BackBits bd;
    bd.init(ip + hdr, isize - hdr);
    uint32_t s1 = bd.read(log), s2 = bd.read(log);
    if (bd.overflowed()) fail(kCorrupt);
    n = 0;
    // two states in turn until the stream is overflowed, the other
    // state's symbol last (FSE_decompress_usingDTable_generic)
    for (;;) {
      if (n > 253) fail(kDstSize);
      w[n++] = ft.e[s1].symbol;
      s1 = ft.e[s1].state + bd.read(ft.e[s1].bits);
      if (bd.overflowed()) {
        w[n++] = ft.e[s2].symbol;
        break;
      }
      if (n > 253) fail(kDstSize);
      w[n++] = ft.e[s2].symbol;
      s2 = ft.e[s2].state + bd.read(ft.e[s2].bits);
      if (bd.overflowed()) {
        w[n++] = ft.e[s1].symbol;
        break;
      }
    }
  }
  int rank[13] = {0};
  uint32_t total = 0;
  for (int k = 0; k < n; k++) {
    if (w[k] > 12) fail(kCorrupt);
    rank[w[k]]++;
    total += (uint32_t{1} << w[k]) >> 1;
  }
  if (total == 0) fail(kCorrupt);
  const int log = highbit(total) + 1;
  if (log > 12) fail(kCorrupt);
  const uint32_t rest = (uint32_t{1} << log) - total;
  if ((uint32_t{1} << highbit(rest)) != rest) fail(kCorrupt);
  w[n] = static_cast<uint8_t>(highbit(rest) + 1);
  rank[w[n]]++;
  n++;
  if (rank[1] < 2 || (rank[1] & 1)) fail(kCorrupt);
  // canonical codes: the longest (weight 1) first, by symbol within a weight
  int start[14] = {0};
  for (int k = 1, at = 0; k <= log; k++) {
    start[k] = at;
    at += rank[k] << (k - 1);
  }
  t.log = log;
  t.target = log <= 11 ? 11 : 12;
  t.e.assign(size_t{1} << log, 0);
  for (int s = 0; s < n; s++) {
    if (!w[s]) continue;
    const int len = 1 << (w[s] - 1);
    const uint16_t v = static_cast<uint16_t>((s << 8) | (log + 1 - w[s]));
    for (int k = 0; k < len; k++) t.e[start[w[s]] + k] = v;
    start[w[s]] += len;
  }
  return isize + 1;
}

// HUF_selectDecoder: whether libzstd decodes 4 streams of ``dst`` symbols
// from ``src`` bytes with its double-symbol table
bool select_double(int64_t dst, int64_t src) {
  static const uint32_t kTime[16][2][2] = {
      {{0, 0}, {1, 1}},       {{0, 0}, {1, 1}},       {{150, 216}, {381, 119}},
      {{170, 205}, {514, 112}}, {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}}, {{359, 188}, {1167, 109}},
      {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}},
      {{1412, 185}, {1695, 202}}};
  const uint32_t q = src >= dst ? 15 : static_cast<uint32_t>(src * 16 / dst);
  const uint32_t d256 = static_cast<uint32_t>(dst >> 8);
  const uint32_t t0 = kTime[q][0][0] + kTime[q][0][1] * d256;
  uint32_t t1 = kTime[q][1][0] + kTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// One Huffman stream of ``count`` symbols into ``out``; an error unless
// it ends exactly at its first bit.  The double-symbol decoder pairs a
// code with the next where both fit its lookup (greedily, from the
// stream's start); a last code left alone that a second, zero-padded one
// would fit is read as a pair whose skip stops at the stream's first bit
// (HUF_decodeLastSymbolX2).
void huf_stream(const HufTable& t, const uint8_t* src, int64_t size, uint8_t* out, int64_t count) {
  BackBits bd;
  bd.init(src, size);
  const int log = t.log;
  bool starts = true;     // whether symbol k starts a pair of the double-symbol decoder
  int prev = 0;
  for (int64_t k = 0; k < count; k++) {
    const uint16_t v = t.e[bd.peek(log)];
    const int len = v & 0xFF;
    out[k] = static_cast<uint8_t>(v >> 8);
    if (k > 0) starts = !(starts && prev + len <= t.target);
    prev = len;
    if (k == count - 1 && t.double_symbols && starts && !bd.overflowed()) {
      BackBits rest = bd;
      rest.pos -= len;
      const int len2 = t.e[rest.peek(log)] & 0xFF;
      if (len + len2 <= t.target) {
        if (bd.pos > 0) bd.pos = bd.pos > len + len2 ? bd.pos - len - len2 : 0;
        if (!bd.finished()) fail(kCorrupt);
        return;
      }
    }
    bd.pos -= len;
  }
  if (!bd.finished()) fail(kCorrupt);
}

// libzstd's fast decoder of 4 streams (HUF_decompress4X1 and 4X2's
// _usingDTable_internal_fast, with their C or assembly loop), taken where
// the table's lookup is 11 bits, each stream holds 8 bytes or more and
// the fourth has symbols.  A stream reads on below its own first byte into
// the bytes before it (the streams before it, the jump table, then the
// literals' first 8 bytes again, rotated); all four are read 5 lookups at
// a time while every one has room, then each to its end.  The one check
// is that no stream read more than 8 bytes past its start in the 5-lookup
// loop: a stream that ends early or late is not an error.  Returns false
// where libzstd takes its checked decoder.
bool huf_fast4(const HufTable& t, const uint8_t* src, int64_t size, uint8_t* out, int64_t n) {
  if (t.log > 11) return false;
  const int64_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
  const int64_t l4 = size - 6 - l1 - l2 - l3;
  if (l1 < 8 || l2 < 8 || l3 < 8) return false;
  if (l4 < 0) fail(kCorrupt);
  const int64_t seg = (n + 3) / 4;
  if (l4 < 8 || 3 * seg >= n) return false;
  const uint64_t first = le64(src);
  auto window = [&](int64_t bits) -> uint32_t {     // the 11 bits below ``bits``
    if (bits <= 64) return static_cast<uint32_t>((first << ((64 - bits) & 63)) >> 53);
    const int64_t at = bits - 11, byte = at >> 3;
    uint64_t v = 0;
    if (byte + 8 <= size) {
      std::memcpy(&v, src + byte, 8);
    } else {
      for (int64_t k = size - 1; k >= byte; k--) v = (v << 8) | src[k];
    }
    return static_cast<uint32_t>((v >> (at & 7)) & 0x7FF);
  };
  const int shift = 11 - t.log;
  const bool pairs = t.double_symbols;
  // one lookup: its symbols into out[op...] (the first alone with ``one``),
  // the bits it takes into *used; returns how many symbols it gives
  auto lookup = [&](int64_t bits, int64_t op, int* used, bool one = false) -> int {
    const uint32_t w = window(bits);
    const uint16_t e1 = t.e[w >> shift];
    const int len1 = e1 & 0xFF;
    out[op] = static_cast<uint8_t>(e1 >> 8);
    if (pairs && !one) {
      const uint16_t e2 = t.e[((w << len1) & 0x7FF) >> shift];
      if (len1 + (e2 & 0xFF) <= 11) {
        out[op + 1] = static_cast<uint8_t>(e2 >> 8);
        *used = len1 + (e2 & 0xFF);
        return 2;
      }
    }
    *used = len1;
    return 1;
  };
  const int64_t start[4] = {6, 6 + l1, 6 + l1 + l2, 6 + l1 + l2 + l3};
  int64_t ip[4], op[4], oend[4];
  int consumed[4];
  for (int s = 0; s < 4; s++) {
    const int64_t end = s < 3 ? start[s + 1] : size;
    ip[s] = end - 8;
    consumed[s] = src[end - 1] ? 8 - highbit(src[end - 1]) : 0;
    op[s] = s * seg;
    oend[s] = (s + 1) * seg < n ? (s + 1) * seg : n;
  }
  for (;;) {
    int64_t iters = ip[0] / 7;
    for (int s = pairs ? 0 : 3; s < 4; s++) {
      const int64_t o = (oend[s] - op[s]) / (pairs ? 10 : 5);
      if (o < iters) iters = o;
    }
    const int64_t olimit = op[3] + iters * 5;
    if (op[3] == olimit) break;
    if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    do {
      for (int s = 0; s < 4; s++) {
        for (int j = 0; j < 5; j++) {
          int used;
          op[s] += lookup(8 * ip[s] + 64 - consumed[s], op[s], &used);
          consumed[s] += used;
        }
        ip[s] -= consumed[s] >> 3;
        consumed[s] &= 7;
      }
    } while (op[3] < olimit);
  }
  for (int s = 0; s < 4; s++) {
    if (op[s] > oend[s] || ip[s] < start[s] - 8) fail(kCorrupt);
    int64_t bits = 8 * ip[s] + 64 - consumed[s];
    while (op[s] < oend[s]) {
      int used;
      // a pair's lookup with one symbol's room gives its first (HUF_decodeLastSymbolX2)
      op[s] += lookup(bits, op[s], &used, op[s] == oend[s] - 1);
      bits -= used;
    }
  }
  return true;
}

// ---- sequences ------------------------------------------------------------------

struct Code {
  uint32_t base;
  uint8_t bits;
};

const Code kLL[36] = {{0, 0},     {1, 0},     {2, 0},     {3, 0},     {4, 0},    {5, 0},
                      {6, 0},     {7, 0},     {8, 0},     {9, 0},     {10, 0},   {11, 0},
                      {12, 0},    {13, 0},    {14, 0},    {15, 0},    {16, 1},   {18, 1},
                      {20, 1},    {22, 1},    {24, 2},    {28, 2},    {32, 3},   {40, 3},
                      {48, 4},    {64, 6},    {128, 7},   {256, 8},   {512, 9},  {1024, 10},
                      {2048, 11}, {4096, 12}, {8192, 13}, {16384, 14}, {32768, 15}, {65536, 16}};
const Code kML[53] = {
    {3, 0},     {4, 0},     {5, 0},      {6, 0},      {7, 0},      {8, 0},     {9, 0},
    {10, 0},    {11, 0},    {12, 0},     {13, 0},     {14, 0},     {15, 0},    {16, 0},
    {17, 0},    {18, 0},    {19, 0},     {20, 0},     {21, 0},     {22, 0},    {23, 0},
    {24, 0},    {25, 0},    {26, 0},     {27, 0},     {28, 0},     {29, 0},    {30, 0},
    {31, 0},    {32, 0},    {33, 0},     {34, 0},     {35, 1},     {37, 1},    {39, 1},
    {41, 1},    {43, 2},    {47, 2},     {51, 3},     {59, 3},     {67, 4},    {83, 4},
    {99, 5},    {131, 7},   {259, 8},    {515, 9},    {1027, 10},  {2051, 11}, {4099, 12},
    {8195, 13}, {16387, 14}, {32771, 15}, {65539, 16}};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ZSTD_buildSeqTable: one table of the sequences section (``max`` its
// largest symbol); returns the bytes its description takes.
int64_t seq_table(FseTable& t, int mode, const uint8_t* src, int64_t size, int max, int max_log,
                  const int16_t* def, int def_max, int def_log, bool have_previous) {
  switch (mode) {
    case 0:
      build_fse(t, def, def_max, def_log);
      return 0;
    case 1:
      if (size < 1) fail(kCorrupt);
      if (src[0] > max) fail(kCorrupt);
      t.log = 0;
      t.e.assign(1, FseEntry{0, src[0], 0});
      return 1;
    case 2: {
      int16_t norm[64];
      int sv, log;
      int64_t got;
      try {
        got = read_ncount(src, size, max, max_log, norm, &sv, &log);
      } catch (const Fail&) {
        fail(kCorrupt);
      }
      build_fse(t, norm, sv, log);
      return got;
    }
    default:
      if (!have_previous) fail(kCorrupt);
      return 0;
  }
}

// ---- a frame's decoder ------------------------------------------------------------

constexpr uint64_t kUnknown = ~uint64_t{0};   // ZSTD_CONTENTSIZE_UNKNOWN

struct Header {
  bool skippable = false;
  int64_t size = 0;            // the header's bytes
  uint64_t content = kUnknown;  // the frame content size (a skippable frame's: its length)
  uint64_t window = 0;
  int64_t block_max = 0;
  uint32_t dict = 0;
  bool checksum = false;
};

// ZSTD_getFrameHeader_advanced: 1 and the header, 0 when the input ends
// first (after checking the magic number in what there is)
bool frame_header(const uint8_t* ip, int64_t n, Header* h) {
  if (n < 5) {
    if (n > 0) {
      uint8_t buf[4];
      std::memcpy(buf, &kMagic, 4);
      std::memcpy(buf, ip, n < 4 ? n : 4);
      if (le32(buf) != kMagic) {
        uint32_t skip = kSkippable;
        std::memcpy(buf, &skip, 4);
        std::memcpy(buf, ip, n < 4 ? n : 4);
        if ((le32(buf) & 0xFFFFFFF0u) != kSkippable) fail(kPrefix);
      }
    }
    return false;
  }
  const uint32_t magic = le32(ip);
  if (magic != kMagic) {
    if ((magic & 0xFFFFFFF0u) != kSkippable) fail(kPrefix);
    if (n < 8) return false;
    h->skippable = true;
    h->size = 8;
    h->content = le32(ip + 4);
    return true;
  }
  const uint8_t fhd = ip[4];
  const int dict_size = (fhd & 3) == 3 ? 4 : (fhd & 3);
  const bool single = (fhd >> 5) & 1;
  const int fcs_id = fhd >> 6;
  const int fcs_size = fcs_id == 0 ? (single ? 1 : 0) : (1 << fcs_id);
  const int64_t size = 5 + !single + dict_size + fcs_size;
  if (n < size) return false;
  if (fhd & 0x08) fail(kUnsupported);
  int64_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wd = ip[pos++];
    const int wlog = (wd >> 3) + 10;
    if (wlog > 31) fail(kWindow);
    window = uint64_t{1} << wlog;
    window += (window >> 3) * (wd & 7);
  }
  uint32_t dict = 0;
  if (dict_size == 1) dict = ip[pos];
  if (dict_size == 2) dict = le16(ip + pos);
  if (dict_size == 4) dict = le32(ip + pos);
  pos += dict_size;
  uint64_t content = kUnknown;
  if (fcs_id == 0 && single) content = ip[pos];
  if (fcs_id == 1) content = le16(ip + pos) + 256;
  if (fcs_id == 2) content = le32(ip + pos);
  if (fcs_id == 3) content = le64(ip + pos);
  if (single) window = content;
  h->skippable = false;
  h->size = size;
  h->content = content;
  h->window = window;
  h->block_max = static_cast<int64_t>(window < uint64_t(kBlockMax) ? window : kBlockMax);
  h->dict = dict;
  h->checksum = (fhd >> 2) & 1;
  return true;
}

struct BlockHeader {
  bool last;
  int type;
  int64_t size;       // the bytes of its body (1 for RLE)
  int64_t rle_size;   // the bytes an RLE block makes
};

BlockHeader block_header(const uint8_t* p) {
  const uint32_t v = le24(p);
  BlockHeader b{static_cast<bool>(v & 1), static_cast<int>((v >> 1) & 3), v >> 3, v >> 3};
  if (b.type == 1) b.size = 1;
  if (b.type == 3) fail(kCorrupt);
  return b;
}

// ZSTD_findFrameCompressedSize: the bytes of the frame at ``ip`` when all
// of it lies in the input, else -1
int64_t frame_extent(const uint8_t* ip, int64_t n, const Header& h) {
  int64_t pos = h.size;
  for (;;) {
    if (n - pos < 3) return -1;
    BlockHeader b;
    try {
      b = block_header(ip + pos);
    } catch (const Fail&) {
      return -1;
    }
    if (3 + b.size > n - pos) return -1;
    pos += 3 + b.size;
    if (b.last) break;
  }
  if (h.checksum) {
    if (n - pos < 4) return -1;
    pos += 4;
  }
  return pos;
}

class FrameDecoder {
 public:
  FrameDecoder(const Header& h, std::vector<uint8_t>& out) : h_(h), out_(out) {}

  // one block's body, its bytes appended to the output; ``cap`` the room
  // there is for them (dstSize_tooSmall past it)
  void block(const BlockHeader& b, const uint8_t* src, int64_t size, int64_t cap) {
    if (b.type == 0) {
      if (size > cap) fail(kDstSize);
      out_.insert(out_.end(), src, src + size);
    } else if (b.type == 1) {
      if (b.rle_size > cap) fail(kDstSize);
      out_.insert(out_.end(), b.rle_size, src[0]);
    } else {
      compressed(src, size, cap);
    }
  }

 private:
  void compressed(const uint8_t* src, int64_t size, int64_t cap) {
    if (size > h_.block_max) fail(kSrcSize);
    if (size < 3) fail(kCorrupt);
    const int64_t limit = cap < h_.block_max ? cap : h_.block_max;
    const int64_t lit_bytes = literals(src, size, limit);
    sequences(src + lit_bytes, size - lit_bytes, cap);
  }

  // ZSTD_decodeLiteralsBlock: the literals into lit_, the section's bytes returned
  int64_t literals(const uint8_t* src, int64_t size, int64_t limit) {
    const int type = src[0] & 3;
    const int format = (src[0] >> 2) & 3;
    if (type < 2) {
      int64_t lh, n;
      if (format == 1) {
        lh = 2;
        n = le16(src) >> 4;
      } else if (format == 3) {
        lh = 3;
        if (size < (type == 0 ? 3 : 4)) fail(kCorrupt);
        n = le24(src) >> 4;
      } else {
        lh = 1;
        n = src[0] >> 3;
      }
      if (n > h_.block_max) fail(kCorrupt);
      if (n > limit) fail(kDstSize);
      if (type == 0) {
        if (lh + n > size) fail(kCorrupt);
        lit_.assign(src + lh, src + lh + n);
        return lh + n;
      }
      if (lh + 1 > size) fail(kCorrupt);
      lit_.assign(n, src[lh]);
      return lh + 1;
    }
    if (size < 5) fail(kCorrupt);
    const uint32_t lhc = le32(src);
    int64_t lh, n, csize;
    bool single = false;
    switch (format) {
      case 0:
      case 1:
        single = format == 0;
        lh = 3;
        n = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
        break;
      case 2:
        lh = 4;
        n = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
        break;
      default:
        lh = 5;
        n = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + (int64_t{src[4]} << 10);
        break;
    }
    if (n > h_.block_max) fail(kCorrupt);
    if (!single && n < 6) fail(kCorrupt);
    if (csize + lh > size) fail(kCorrupt);
    if (n > limit) fail(kDstSize);
    const uint8_t* p = src + lh;
    int64_t psize = csize;
    if (type == 3) {
      if (!have_huf_) fail(kCorrupt);
    } else {
      const int64_t tsize = read_huffman(huf_, p, psize);
      huf_.double_symbols = !single && select_double(n, csize);
      p += tsize;
      psize -= tsize;
      have_huf_ = true;
    }
    lit_.resize(n);
    if (single) {
      huf_stream(huf_, p, psize, lit_.data(), n);
    } else {
      if (psize < 10) fail(kCorrupt);
      if (!huf_fast4(huf_, p, psize, lit_.data(), n)) {
        const int64_t l1 = le16(p), l2 = le16(p + 2), l3 = le16(p + 4);
        const int64_t l4 = psize - 6 - l1 - l2 - l3;
        if (l4 < 0) fail(kCorrupt);
        const int64_t seg = (n + 3) / 4;
        if (3 * seg > n) fail(kCorrupt);
        const uint8_t* s = p + 6;
        huf_stream(huf_, s, l1, lit_.data(), seg);
        huf_stream(huf_, s + l1, l2, lit_.data() + seg, seg);
        huf_stream(huf_, s + l1 + l2, l3, lit_.data() + 2 * seg, seg);
        huf_stream(huf_, s + l1 + l2 + l3, l4, lit_.data() + 3 * seg, n - 3 * seg);
      }
    }
    return lh + csize;
  }

  // ZSTD_decodeSeqHeaders and ZSTD_decompressSequences
  void sequences(const uint8_t* src, int64_t size, int64_t cap) {
    if (size < 1) fail(kSrcSize);
    const uint8_t* ip = src;
    const uint8_t* const iend = src + size;
    int64_t nseq = *ip++;
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (ip + 2 > iend) fail(kSrcSize);
        nseq = le16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail(kSrcSize);
        nseq = ((nseq - 0x80) << 8) + *ip++;
      }
    }
    const int64_t base = static_cast<int64_t>(out_.size());
    if (nseq == 0) {
      if (ip != iend) fail(kCorrupt);
      if (static_cast<int64_t>(lit_.size()) > cap) fail(kDstSize);
      out_.insert(out_.end(), lit_.begin(), lit_.end());
      return;
    }
    if (ip + 1 > iend) fail(kSrcSize);
    if (*ip & 3) fail(kCorrupt);
    const int ll_mode = *ip >> 6, of_mode = (*ip >> 4) & 3, ml_mode = (*ip >> 2) & 3;
    ip++;
    ip += seq_table(ll_, ll_mode, ip, iend - ip, 35, 9, kLLNorm, 35, 6, have_seq_);
    ip += seq_table(of_, of_mode, ip, iend - ip, 31, 8, kOFNorm, 28, 5, have_seq_);
    ip += seq_table(ml_, ml_mode, ip, iend - ip, 52, 9, kMLNorm, 52, 6, have_seq_);
    have_seq_ = true;
    if (ip > iend) fail(kCorrupt);
    BackBits bd;
    try {
      bd.init(ip, iend - ip);
    } catch (const Fail&) {
      fail(kCorrupt);
    }
    uint32_t sll = bd.read(ll_.log), sof = bd.read(of_.log), sml = bd.read(ml_.log);
    const uint8_t* lit = lit_.data();
    const uint8_t* const lit_end = lit + lit_.size();
    const int64_t end = base + cap;
    for (int64_t k = 0; k < nseq; k++) {
      const FseEntry& le = ll_.e[sll];
      const FseEntry& oe = of_.e[sof];
      const FseEntry& me = ml_.e[sml];
      const int ofc = oe.symbol;
      uint64_t offset;
      if (ofc > 1) {
        offset = (uint64_t{1} << ofc) + bd.read(ofc) - 3;
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = offset;
      } else {
        const int ll0 = kLL[le.symbol].base == 0;
        if (ofc == 0) {
          offset = rep_[ll0];
          rep_[1] = rep_[!ll0];
          rep_[0] = offset;
        } else {
          const int idx = 1 + ll0 + static_cast<int>(bd.read(1));
          uint64_t v = idx == 3 ? rep_[0] - 1 : rep_[idx];
          v -= !v;
          if (idx != 1) rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = offset = v;
        }
      }
      const int64_t ml = kML[me.symbol].base + bd.read(kML[me.symbol].bits);
      const int64_t ll = kLL[le.symbol].base + bd.read(kLL[le.symbol].bits);
      if (k + 1 < nseq) {
        sll = le.state + bd.read(le.bits);
        sml = me.state + bd.read(me.bits);
        sof = oe.state + bd.read(oe.bits);
      }
      // ZSTD_execSequence
      const int64_t op = static_cast<int64_t>(out_.size());
      if (op + ll + ml > end) fail(kDstSize);
      if (ll > lit_end - lit) fail(kCorrupt);
      out_.insert(out_.end(), lit, lit + ll);
      lit += ll;
      const int64_t at = op + ll;
      if (offset > static_cast<uint64_t>(at)) fail(kCorrupt);
      out_.resize(at + ml);
      uint8_t* o = out_.data() + at;
      const uint8_t* m = o - offset;
      if (offset >= static_cast<uint64_t>(ml)) {
        std::memcpy(o, m, ml);
      } else {
        for (int64_t i = 0; i < ml; i++) o[i] = m[i];
      }
    }
    if (!bd.finished()) fail(kCorrupt);
    const int64_t last = lit_end - lit;
    if (static_cast<int64_t>(out_.size()) + last > end) fail(kDstSize);
    out_.insert(out_.end(), lit, lit_end);
  }

  const Header& h_;
  std::vector<uint8_t>& out_;
  std::vector<uint8_t> lit_;
  HufTable huf_;
  bool have_huf_ = false;
  FseTable ll_, of_, ml_;
  bool have_seq_ = false;
  uint64_t rep_[3] = {1, 4, 8};
};

// ZSTD_decompressFrame: the frame at ``ip`` (``n`` bytes, all of it) into
// ``out`` with room for ``room`` bytes; returns the bytes it took
int64_t whole_frame(const uint8_t* ip, int64_t n, const Header& h, std::vector<uint8_t>& out,
                    int64_t room) {
  if (h.dict) fail(kDictionary);
  const int64_t start = static_cast<int64_t>(out.size());
  FrameDecoder fd(h, out);
  int64_t pos = h.size;
  for (;;) {
    if (n - pos < 3) fail(kSrcSize);
    const BlockHeader b = block_header(ip + pos);
    pos += 3;
    if (b.size > n - pos) fail(kSrcSize);
    const int64_t made = static_cast<int64_t>(out.size()) - start;
    fd.block(b, ip + pos, b.size, room - made);
    pos += b.size;
    if (b.last) break;
  }
  const int64_t made = static_cast<int64_t>(out.size()) - start;
  if (h.content != kUnknown && static_cast<uint64_t>(made) != h.content) fail(kCorrupt);
  if (h.checksum) {
    if (n - pos < 4) fail(kChecksum);
    if (static_cast<uint32_t>(xxh64(out.data() + start, made)) != le32(ip + pos)) fail(kChecksum);
    pos += 4;
  }
  return pos;
}

// One ZSTD_decompressStream call from a new frame, into an output of
// ``room`` bytes: the bytes it hands out (at most ``room``).
int64_t stream_frame(const uint8_t* in, int64_t n, int64_t room, std::vector<uint8_t>& out) {
  Header h;
  if (!frame_header(in, n, &h)) return 0;
  if (h.skippable) return 0;
  if (h.content != kUnknown && h.content <= static_cast<uint64_t>(room)) {
    const int64_t extent = frame_extent(in, n, h);
    if (extent >= 0) {
      whole_frame(in, extent, h, out, room);
      return static_cast<int64_t>(out.size());
    }
  }
  if (h.dict) fail(kDictionary);
  const uint64_t window = h.window < 1024 ? 1024 : h.window;
  if (window > kMaxWindow) fail(kWindow);
  // a block's room: what the content size leaves, and never more than
  // block_max (libzstd refuses a block that makes more), so a damaged
  // block fails before it makes more than one block's bytes
  FrameDecoder fd(h, out);
  int64_t pos = h.size;
  for (;;) {
    if (n - pos < 3) break;
    const BlockHeader b = block_header(in + pos);
    if (b.size > h.block_max) fail(kCorrupt);
    pos += 3;
    const int64_t before = static_cast<int64_t>(out.size());
    int64_t cap = h.block_max;
    if (h.content != kUnknown && static_cast<int64_t>(h.content) - before < cap)
      cap = static_cast<int64_t>(h.content) - before;
    if (b.size > 0) {
      if (b.type == 0) {
        const int64_t piece = n - pos < b.size ? n - pos : b.size;
        if (piece == 0) break;
        fd.block(b, in + pos, piece, cap);
        pos += piece;
        if (piece < b.size) {
          // the rest of a raw block is past the input: the call ends
          // once what it holds is handed out
          break;
        }
      } else {
        if (n - pos < b.size) break;
        fd.block(b, in + pos, b.size, cap);
        pos += b.size;
      }
    }
    const int64_t made = static_cast<int64_t>(out.size()) - before;
    if (made > h.block_max) fail(kCorrupt);
    if (b.last && h.content != kUnknown && static_cast<uint64_t>(out.size()) != h.content)
      fail(kCorrupt);
    // ZSTD_decompressContinueStream then the flush: bytes that do not fit
    // end the call
    if (static_cast<int64_t>(out.size()) > room) break;
    // (a full strip goes on to the next unit: a block header, a block
    // that makes no bytes, the checksum)
    if (b.last) {
      if (h.checksum && n - pos >= 4 &&
          static_cast<uint32_t>(xxh64(out.data(), static_cast<int64_t>(out.size()))) !=
              le32(in + pos))
        fail(kChecksum);
      break;
    }
  }
  return static_cast<int64_t>(out.size()) < room ? static_cast<int64_t>(out.size()) : room;
}

}  // namespace

extern "C" {

// libtiff's ZSTDDecode of one strip or tile: fills at most ``n_out``
// bytes and returns how many (fewer is libtiff's "Not enough data"), or
// a negative error of the enum above.
int64_t zst_strip_decode(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out) {
  try {
    std::vector<uint8_t> buf;
    buf.reserve(static_cast<size_t>(n_out) + kBlockMax);
    const int64_t got = stream_frame(in, n_in, n_out, buf);
    std::memcpy(out, buf.data(), static_cast<size_t>(got));
    return got;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kCorrupt;
  }
}

}  // extern "C"
