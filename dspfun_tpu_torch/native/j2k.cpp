// The tile decoder of JPEG 2000 codestreams (ITU-T T.800), written to give the
// samples OpenJPEG 2.5 gives Pillow 12.1 (Jpeg2KDecode.c decodes tile by tile,
// whole tiles, every layer, no reduction):
//
//   tier-2   packets in the five progression orders and in the progressions
//            of POC markers (B.12, the position orders stepping through the
//            tile and the components' sub-sampling as OpenJPEG's pi.c does,
//            a packet met again skipped), SOP segments skipped where found
//            and EPH markers required, precincts, tag trees, code-block
//            inclusion, zero bit-planes, the pass counts, Lblock and the
//            codeword segments of the bypass and termall switches (B.10,
//            OpenJPEG's opj_t2_init_seg), tile parts joined by the caller;
//   tier-1   the MQ decoder (Annex C), raw bypass segments, the significance,
//            refinement and cleanup passes with run mode (Annex D) under
//            the reset, vertically causal and segmentation-symbol switches
//            (predictable termination needs nothing on decode), coefficients
//            kept at twice their magnitude with the midpoint of the last
//            decoded bit-plane, as OpenJPEG keeps them, then the max-shift
//            ROI's down-shift;
//   then     5/3: the coefficient halved, the integer lifting (F.3.8);
//            9/7: the coefficient times half the step size (E.1), OpenJPEG's
//            float32 lifting (K and 1.625732422 scaling, then delta, gamma,
//            beta, alpha) with whole-sample symmetric extension, rows before
//            columns at each level; the RCT or ICT where COD's MCT flag is
//            set (the first component's wavelet picks it); lrintf, the DC
//            level shift and the clamp to the precision.
//
// Every float step is one float32 multiply or add in OpenJPEG's order, so no
// step may be contracted into a fused multiply-add (the host build uses
// -march=native, where GCC would contract them).
//
// io/jpeg2000.py reads the JP2 boxes and the markers (COD/COC, QCD/QCC, RGN
// and POC per component and tile, in OpenJPEG's order), refuses PPM/PPT and
// HT code-blocks, and unpacks the samples into Pillow's modes (sub-sampled
// components in Pillow's own layout, from the packed tile-components here).
#pragma GCC optimize("fp-contract=off")
#include <algorithm>
#include <atomic>
#include <cmath>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

// what OpenJPEG decodes and this file does not carry
struct Refused {
  std::string msg;
};

// ---- the MQ decoder (Annex C) ----------------------------------------------

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CX_RL = 17, CX_UNI = 18, NCX = 19 };

struct Mq {
  const uint8_t* bp;
  uint32_t c = 0, a = 0;
  int ct = 0;
  uint8_t st[NCX];
  uint8_t mps[NCX];

  // every context back to its initial state (D.7: at the start of a
  // code-block, and after each pass under the reset switch)
  void reset() {
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[CX_UNI] = 46;
    st[CX_RL] = 3;
    st[0] = 4;
  }
  // data ends with two 0xFF bytes the caller appended (a marker the
  // decoder stops on, feeding 1-bits, as T.800's BYTEIN does at the end);
  // the contexts carry over from the segment before
  void init(const uint8_t* data) {
    bp = data;
    c = static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  // a raw (bypass) segment: its bits as they are, a 0 stuffed after 0xFF
  void raw_init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  inline int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
  inline void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  inline void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while ((a & 0x8000) == 0);
  }
  inline int decode(int cx) {
    const MqState& s = kMq[st[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        st[cx] = s.nlps;
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// ---- tier-1 (Annex D) --------------------------------------------------------

// per-sample state: significance, visited in this bit-plane's significance
// pass, refined before; the significance of the 8 neighbours and the sign
// of the 4 direct ones
enum : uint16_t {
  F_SIG = 1, F_VIS = 4, F_REF = 8,
  F_N = 1 << 4, F_S = 1 << 5, F_W = 1 << 6, F_E = 1 << 7,
  F_NW = 1 << 8, F_NE = 1 << 9, F_SW = 1 << 10, F_SE = 1 << 11,
  F_SGN_N = 1 << 12, F_SGN_S = 1 << 13, F_SGN_W = 1 << 14, F_SGN_E = 1 << 15,
  F_NBR = 0xFF0,
};

struct Tables {
  uint8_t zc[3][256];   // orientation (LL/LH, HL, HH) x neighbour bits -> context
  uint8_t sc[256];      // direct neighbours' significance and sign -> context | xor << 5
  Tables() {
    for (int i = 0; i < 256; i++) {
      int n = i & 1, s = (i >> 1) & 1, w = (i >> 2) & 1, e = (i >> 3) & 1;
      int d = ((i >> 4) & 1) + ((i >> 5) & 1) + ((i >> 6) & 1) + ((i >> 7) & 1);
      int h = w + e, v = n + s;
      for (int o = 0; o < 2; o++) {
        int hh = o == 0 ? h : v, vv = o == 0 ? v : h, cx;
        if (hh == 2) cx = 8;
        else if (hh == 1) cx = vv >= 1 ? 7 : d >= 1 ? 6 : 5;
        else if (vv == 2) cx = 4;
        else if (vv == 1) cx = 3;
        else cx = d >= 2 ? 2 : d == 1 ? 1 : 0;
        zc[o][i] = static_cast<uint8_t>(cx);
      }
      int hv = h + v, cx;
      if (d >= 3) cx = 8;
      else if (d == 2) cx = hv >= 1 ? 7 : 6;
      else if (d == 1) cx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
      else cx = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
      zc[2][i] = static_cast<uint8_t>(cx);
      // sign: bits 0-3 significance of N, S, W, E; bits 4-7 their signs
      auto chi = [&](int bit) { return (i >> bit & 1) ? ((i >> (bit + 4) & 1) ? -1 : 1) : 0; };
      int hc = std::max(-1, std::min(1, chi(2) + chi(3)));
      int vc = std::max(-1, std::min(1, chi(0) + chi(1)));
      int ctx, x = 0;
      if (hc == 0 && vc == 0) ctx = 9;
      else if (hc == 0) { ctx = 10; x = vc < 0; }
      else {
        ctx = hc * vc > 0 ? 13 : vc == 0 ? 12 : 11;
        x = hc < 0;
      }
      sc[i] = static_cast<uint8_t>(ctx | (x << 5));
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// the code-block style switches of COD/COC (Table A.19)
enum : int { S_LAZY = 1, S_RESET = 2, S_TERMALL = 4, S_VSC = 8, S_PTERM = 16, S_SEGSYM = 32 };

// a codeword segment (OpenJPEG's opj_tcd_seg_t): its bytes and passes so far
struct Seg {
  int len = 0, npasses = 0, maxpasses = 0;
  int newlen = 0, newpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0;
  int numlenbits = 0;
  int npasses = 0;
  int newpasses = 0;
  bool seen = false;              // included in an earlier layer
  int nsegs = 0;                  // segments that hold data (OpenJPEG's numsegs)
  std::vector<Seg> segs;          // those and the ones the last header opened
  std::vector<uint8_t> data;      // the segments' bytes, one after another
};

struct Band {
  int x0, y0, x1, y1;
  int bandno;                     // 0 LL, 1 HL, 2 LH, 3 HH
  int numbps;                     // Mb
  float step;                     // Delta_b (9/7)
  int xoff, yoff;                 // where its samples start in the tile-component
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

// decode one code-block's passes into out (stride in samples): integers
// (5/3) or floats (9/7) in the tile-component's buffer
struct T1 {
  std::vector<uint16_t> flags;
  std::vector<int32_t> data;
  std::vector<uint8_t> buf;
  bool vsc = false;

  void decode(const Cblk& cb, const Band& band, bool reversible, int style, int roishift,
              void* dst, int stride) {
    const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
    if (w <= 0 || h <= 0) return;
    const int fs = w + 2;
    flags.assign(static_cast<size_t>(fs) * (h + 2), 0);
    data.assign(static_cast<size_t>(w) * h, 0);
    vsc = (style & S_VSC) != 0;
    int bpno = roishift + cb.numbps;
    if (bpno >= 31) throw Error{"a code-block of 31 or more bit-planes"};
    Mq mq;
    mq.reset();
    const Tables& tb = tables();
    const uint8_t* zc = tb.zc[band.bandno == 1 ? 1 : band.bandno == 3 ? 2 : 0];
    int passtype = 2;
    size_t at = 0;
    // OpenJPEG's opj_t1_decode_cblk: each segment from its own start, raw
    // (the bypass switch, from the fifth bit-plane on) or MQ-coded
    for (int sg = 0; sg < cb.nsegs; sg++) {
      const Seg& seg = cb.segs[sg];
      const bool raw = bpno <= cb.numbps - 4 && passtype < 2 && (style & S_LAZY);
      buf.assign(cb.data.begin() + at, cb.data.begin() + at + seg.len);
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      at += seg.len;
      if (raw) mq.raw_init(buf.data());
      else mq.init(buf.data());
      for (int pass = 0; pass < seg.npasses && bpno >= 1; pass++) {
        if (passtype == 0) sigpass(mq, raw, zc, tb.sc, w, h, bpno);
        else if (passtype == 1) refpass(mq, raw, w, h, bpno);
        else clnpass(mq, zc, tb.sc, w, h, bpno, (style & S_SEGSYM) != 0);
        if ((style & S_RESET) && !raw) mq.reset();
        if (++passtype == 3) {
          passtype = 0;
          bpno--;
        }
      }
    }
    if (roishift) {   // max-shift ROI: magnitudes at or above 2^shift shifted down
      const int32_t thresh = roishift >= 31 ? 0 : int32_t(1) << roishift;
      for (int32_t& v : data) {
        if (roishift >= 31) {
          v = 0;
          continue;
        }
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
    if (reversible) {
      int32_t* out = static_cast<int32_t*>(dst);
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) out[static_cast<size_t>(y) * stride + x] = data[y * w + x] / 2;
    } else {
      float* out = static_cast<float*>(dst);
      const float s = 0.5f * band.step;
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
          out[static_cast<size_t>(y) * stride + x] = static_cast<float>(data[y * w + x]) * s;
    }
  }

  // a sample of row y turned significant: its neighbours learn it (under
  // the vertically causal switch the stripe above does not, D.7)
  inline void set_sig(uint16_t* f, int fs, bool neg, int y) {
    f[0] |= F_SIG;
    if (!(vsc && (y & 3) == 0)) {
      f[-fs] |= F_S | (neg ? F_SGN_S : 0);
      f[-fs - 1] |= F_SE;
      f[-fs + 1] |= F_SW;
    }
    f[fs] |= F_N | (neg ? F_SGN_N : 0);
    f[-1] |= F_E | (neg ? F_SGN_E : 0);
    f[1] |= F_W | (neg ? F_SGN_W : 0);
    f[fs - 1] |= F_NE;
    f[fs + 1] |= F_NW;
  }
  static inline int sc_index(uint16_t fl) { return ((fl >> 4) & 0xF) | ((fl >> 8) & 0xF0); }
  inline void sign(Mq& mq, const uint8_t* sc, uint16_t* f, int fs, int32_t* d, int32_t oph, int y) {
    int s = sc[sc_index(*f)];
    int bit = mq.decode(s & 0x1F) ^ (s >> 5);
    *d = bit ? -oph : oph;
    set_sig(f, fs, bit != 0, y);
  }

  void sigpass(Mq& mq, bool raw, const uint8_t* zc, const uint8_t* sc, int w, int h, int bpno) {
    const int fs = w + 2;
    const int32_t one = 1 << bpno, oph = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int x = 0; x < w; x++) {
        for (int y = y0; y < y1; y++) {
          uint16_t* f = &flags[static_cast<size_t>(y + 1) * fs + x + 1];
          if ((*f & (F_SIG | F_VIS)) || !(*f & F_NBR)) continue;
          if (raw) {
            if (mq.raw()) {
              const int neg = mq.raw();
              data[y * w + x] = neg ? -oph : oph;
              set_sig(f, fs, neg != 0, y);
            }
          } else if (mq.decode(zc[(*f >> 4) & 0xFF])) {
            sign(mq, sc, f, fs, &data[y * w + x], oph, y);
          }
          *f |= F_VIS;
        }
      }
    }
  }

  void refpass(Mq& mq, bool raw, int w, int h, int bpno) {
    const int fs = w + 2;
    const int32_t half = (1 << bpno) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int x = 0; x < w; x++) {
        for (int y = y0; y < y1; y++) {
          uint16_t* f = &flags[static_cast<size_t>(y + 1) * fs + x + 1];
          if ((*f & (F_SIG | F_VIS)) != F_SIG) continue;
          int bit = raw ? mq.raw() : mq.decode((*f & F_REF) ? 16 : (*f & F_NBR) ? 15 : 14);
          int32_t& d = data[y * w + x];
          d += (bit ^ (d < 0)) ? half : -half;
          *f |= F_REF;
        }
      }
    }
  }

  void clnpass(Mq& mq, const uint8_t* zc, const uint8_t* sc, int w, int h, int bpno, bool segsym) {
    const int fs = w + 2;
    const int32_t one = 1 << bpno, oph = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int x = 0; x < w; x++) {
        uint16_t* col = &flags[static_cast<size_t>(y0 + 1) * fs + x + 1];
        int y = y0;
        if (y1 - y0 == 4) {
          const uint16_t m = F_SIG | F_VIS | F_NBR;
          if (!((col[0] | col[fs] | col[2 * fs] | col[3 * fs]) & m)) {
            if (!mq.decode(CX_RL)) continue;
            int r = mq.decode(CX_UNI) << 1;
            r |= mq.decode(CX_UNI);
            y = y0 + r;
            sign(mq, sc, &col[r * fs], fs, &data[y * w + x], oph, y);
            y++;
          }
        }
        for (; y < y1; y++) {
          uint16_t* f = &col[(y - y0) * fs];
          if (!(*f & (F_SIG | F_VIS)) && mq.decode(zc[(*f >> 4) & 0xFF]))
            sign(mq, sc, f, fs, &data[y * w + x], oph, y);
        }
        for (int yy = y0; yy < y1; yy++) col[(yy - y0) * fs] &= static_cast<uint16_t>(~F_VIS);
      }
    }
    if (segsym)   // the segmentation symbol 1010, read and not checked, as OpenJPEG does
      for (int i = 0; i < 4; i++) mq.decode(CX_UNI);
  }
};

// ---- tier-2 (B.10) -------------------------------------------------------------

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  bool over = false;
  Bio(const uint8_t* p, const uint8_t* e) : start(p), bp(p), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
    else over = true;
  }
  int bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= static_cast<uint32_t>(bit()) << i;
    return v;
  }
  // false where a 0xFF byte ends the data (OpenJPEG's opj_bio_inalign)
  bool inalign() {
    if ((buf & 0xFF) == 0xFF) {
      const bool more = bp < end;
      bytein();
      if (!more) return false;
    }
    ct = 0;
    return true;
  }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> ws{w}, hs{h};
    while (ws.back() > 1 || hs.back() > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
    }
    std::vector<int> off(ws.size() + 1, 0);
    for (size_t l = 0; l < ws.size(); l++) off[l + 1] = off[l] + ws[l] * hs[l];
    nodes.resize(off.back());
    for (size_t l = 0; l < ws.size(); l++)
      for (int j = 0; j < hs[l]; j++)
        for (int i = 0; i < ws[l]; i++)
          nodes[off[l] + j * ws[l] + i].parent =
              l + 1 < ws.size() ? off[l + 1] + (j / 2) * ws[l + 1] + i / 2 : -1;
    reset();
  }
  void reset() {
    for (Node& n : nodes) {
      n.value = 999;
      n.low = 0;
    }
  }
  // OpenJPEG's opj_tgt_decode: 1 where the leaf's value is below threshold
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[32], sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& n = nodes[node];
      if (low > n.low) n.low = low;
      else low = n.low;
      while (low < threshold && low < n.value) {
        if (bio.bit()) n.value = low;
        else ++low;
      }
      n.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

struct PrecBand {
  int cw = 0, ch = 0;
  std::vector<int> cblks;         // indices into the tile's code-blocks, raster order
  TagTree incl, imsb;
};

struct Res {
  int x0, y0, x1, y1;
  int pdx, pdy, pw = 0, ph = 0;
  int nbands = 0;
  Band bands[3];
  std::vector<PrecBand> prec;     // [precinct * nbands + band]
};

struct Comp {
  int prec = 8, sgnd = 0;
  int dx = 1, dy = 1;             // XRsiz, YRsiz
};

struct CompParams {
  int numres, xcb, ycb, qmfbid, guard, style, roishift;
  int ppx[33], ppy[33];
  int expn[97], mant[97];
};
constexpr int kCompRec = 7 + 33 * 2 + 97 * 2;
constexpr int kTileHead = 11;

// a progression of a POC marker (or the one of COD): packets of layers
// [0, lay1), resolutions [res0, res1), components [comp0, comp1) in order prg
struct Poc {
  int res0, comp0, lay1, res1, comp1, prg;
};

struct TileComp {
  int x0, y0, x1, y1;
  CompParams p;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int width() const { return x1 - x0; }
  int height() const { return y1 - y0; }
};

struct Job {
  int cblk;
  int tile, comp, res, band;
};

inline int ceildivpow2(int64_t a, int b) { return static_cast<int>((a + (int64_t(1) << b) - 1) >> b); }
inline int floordivpow2(int64_t a, int b) { return static_cast<int>(a >> b); }
inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct Tile {
  int tx0, ty0, tx1, ty1;
  int prog, nlayers, mct, csty;
  std::vector<Poc> pocs;          // empty: COD's progression over everything
  const uint8_t* body;
  int64_t len;
  std::vector<TileComp> comps;
  std::vector<Cblk> cblks;

  std::vector<Comp> img;

  void setup(const std::vector<Comp>& image) {
    img = image;
    for (size_t c = 0; c < comps.size(); c++) {
      TileComp& tc = comps[c];
      tc.x0 = static_cast<int>(ceildiv(tx0, img[c].dx));
      tc.y0 = static_cast<int>(ceildiv(ty0, img[c].dy));
      tc.x1 = static_cast<int>(ceildiv(tx1, img[c].dx));
      tc.y1 = static_cast<int>(ceildiv(ty1, img[c].dy));
      const CompParams& p = tc.p;
      const int nl = p.numres - 1;
      tc.res.resize(p.numres);
      for (int r = 0; r < p.numres; r++) {
        Res& rs = tc.res[r];
        const int lev = nl - r;
        rs.x0 = ceildivpow2(tc.x0, lev);
        rs.y0 = ceildivpow2(tc.y0, lev);
        rs.x1 = ceildivpow2(tc.x1, lev);
        rs.y1 = ceildivpow2(tc.y1, lev);
        rs.pdx = p.ppx[r];
        rs.pdy = p.ppy[r];
        const int64_t px0 = static_cast<int64_t>(floordivpow2(rs.x0, rs.pdx)) << rs.pdx;
        const int64_t py0 = static_cast<int64_t>(floordivpow2(rs.y0, rs.pdy)) << rs.pdy;
        const int64_t px1 = static_cast<int64_t>(ceildivpow2(rs.x1, rs.pdx)) << rs.pdx;
        const int64_t py1 = static_cast<int64_t>(ceildivpow2(rs.y1, rs.pdy)) << rs.pdy;
        rs.pw = rs.x0 == rs.x1 ? 0 : static_cast<int>((px1 - px0) >> rs.pdx);
        rs.ph = rs.y0 == rs.y1 ? 0 : static_cast<int>((py1 - py0) >> rs.pdy);
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0;
          cbgy0 = py0;
          cbgw = rs.pdx;
          cbgh = rs.pdy;
          rs.nbands = 1;
        } else {
          cbgx0 = (px0 + 1) >> 1;
          cbgy0 = (py0 + 1) >> 1;
          cbgw = rs.pdx - 1;
          cbgh = rs.pdy - 1;
          rs.nbands = 3;
        }
        const int cbw = std::min(p.xcb, cbgw), cbh = std::min(p.ycb, cbgh);
        if (static_cast<int64_t>(rs.pw) * rs.ph > (1 << 26))
          throw Error{"too many precincts in a resolution"};
        rs.prec.assign(static_cast<size_t>(rs.pw) * rs.ph * rs.nbands, PrecBand());
        for (int b = 0; b < rs.nbands; b++) {
          Band& bd = rs.bands[b];
          if (r == 0) {
            bd.bandno = 0;
            bd.x0 = rs.x0;
            bd.y0 = rs.y0;
            bd.x1 = rs.x1;
            bd.y1 = rs.y1;
            bd.xoff = bd.yoff = 0;
          } else {
            bd.bandno = b + 1;
            const int xb = bd.bandno & 1, yb = bd.bandno >> 1;
            bd.x0 = ceildivpow2(tc.x0 - (static_cast<int64_t>(xb) << lev), lev + 1);
            bd.y0 = ceildivpow2(tc.y0 - (static_cast<int64_t>(yb) << lev), lev + 1);
            bd.x1 = ceildivpow2(tc.x1 - (static_cast<int64_t>(xb) << lev), lev + 1);
            bd.y1 = ceildivpow2(tc.y1 - (static_cast<int64_t>(yb) << lev), lev + 1);
            const Res& pr = tc.res[r - 1];
            bd.xoff = xb ? pr.x1 - pr.x0 : 0;
            bd.yoff = yb ? pr.y1 - pr.y0 : 0;
          }
          const int si = r == 0 ? 0 : 3 * (r - 1) + b + 1;
          bd.numbps = p.expn[si] + p.guard - 1;
          bd.step = static_cast<float>((1.0 + p.mant[si] / 2048.0) *
                                       std::pow(2.0, img[c].prec - p.expn[si]));
          if (bd.empty()) continue;
          for (int pj = 0; pj < rs.ph; pj++) {
            for (int pi = 0; pi < rs.pw; pi++) {
              PrecBand& pb = rs.prec[(static_cast<size_t>(pj) * rs.pw + pi) * rs.nbands + b];
              const int64_t gx0 = cbgx0 + (static_cast<int64_t>(pi) << cbgw);
              const int64_t gy0 = cbgy0 + (static_cast<int64_t>(pj) << cbgh);
              const int prx0 = static_cast<int>(std::max<int64_t>(gx0, bd.x0));
              const int pry0 = static_cast<int>(std::max<int64_t>(gy0, bd.y0));
              const int prx1 = static_cast<int>(std::min<int64_t>(gx0 + (int64_t(1) << cbgw), bd.x1));
              const int pry1 = static_cast<int>(std::min<int64_t>(gy0 + (int64_t(1) << cbgh), bd.y1));
              const int64_t bx0 = static_cast<int64_t>(floordivpow2(prx0, cbw)) << cbw;
              const int64_t by0 = static_cast<int64_t>(floordivpow2(pry0, cbh)) << cbh;
              const int64_t bx1 = static_cast<int64_t>(ceildivpow2(prx1, cbw)) << cbw;
              const int64_t by1 = static_cast<int64_t>(ceildivpow2(pry1, cbh)) << cbh;
              pb.cw = static_cast<int>(std::max<int64_t>(0, (bx1 - bx0) >> cbw));
              pb.ch = static_cast<int>(std::max<int64_t>(0, (by1 - by0) >> cbh));
              for (int j = 0; j < pb.ch; j++) {
                for (int i = 0; i < pb.cw; i++) {
                  Cblk cb;
                  const int64_t cx0 = bx0 + (static_cast<int64_t>(i) << cbw);
                  const int64_t cy0 = by0 + (static_cast<int64_t>(j) << cbh);
                  cb.x0 = static_cast<int>(std::max<int64_t>(cx0, prx0));
                  cb.y0 = static_cast<int>(std::max<int64_t>(cy0, pry0));
                  cb.x1 = static_cast<int>(std::min<int64_t>(cx0 + (int64_t(1) << cbw), prx1));
                  cb.y1 = static_cast<int>(std::min<int64_t>(cy0 + (int64_t(1) << cbh), pry1));
                  pb.cblks.push_back(static_cast<int>(cblks.size()));
                  cblks.push_back(std::move(cb));
                }
              }
              pb.incl.build(pb.cw, pb.ch);
              pb.imsb.build(pb.cw, pb.ch);
            }
          }
        }
      }
    }
  }

  struct Packet {
    int comp, res, prec, layer;
  };

  // the packets in the order of the progressions (OpenJPEG's pi.c): each
  // POC's in turn (layers from 0, resolutions and components within its
  // bounds), a packet already read under an earlier one skipped
  std::vector<Packet> packets() const {
    std::vector<Packet> out;
    const int nc = static_cast<int>(comps.size());
    int maxres = 0;
    for (const TileComp& tc : comps) maxres = std::max(maxres, tc.p.numres);
    std::vector<std::vector<uint8_t>> seen(nc);
    auto index = [&](int c, int r, int p) {
      size_t off = 0;
      for (int k = 0; k < r; k++) off += comps[c].res[k].prec.size() / comps[c].res[k].nbands;
      return off + p;
    };
    for (int c = 0; c < nc; c++) {
      size_t n = 0;
      for (const Res& rs : comps[c].res) n += rs.prec.size() / rs.nbands;
      seen[c].assign(n * nlayers, 0);
    }
    int l1 = 0;
    auto emit = [&](int c, int r, int p, int l) {
      uint8_t& s = seen[c][index(c, r, p) * nlayers + l];
      if (!s) {
        s = 1;
        out.push_back({c, r, p, l});
      }
    };
    auto emit_layers = [&](int c, int r, int p) {
      for (int l = 0; l < l1; l++) emit(c, r, p, l);
    };
    auto nprec = [&](int c, int r) {
      const Res& rs = comps[c].res[r];
      return rs.pw * rs.ph;
    };
    // the position orders: the precinct of (x, y) in (c, r), or -1
    auto precinct_at = [&](int c, int r, int64_t x, int64_t y) -> int {
      const TileComp& tc = comps[c];
      if (r >= tc.p.numres) return -1;
      const Res& rs = tc.res[r];
      const int lev = tc.p.numres - 1 - r;
      const int64_t cdx = img[c].dx, cdy = img[c].dy;
      if (lev >= 32 || (cdx << lev) > INT_MAX || (cdy << lev) > INT_MAX) return -1;
      const int64_t ddx = cdx << lev, ddy = cdy << lev;
      const int64_t trx0 = ceildiv(tx0, ddx), try0 = ceildiv(ty0, ddy);
      const int64_t trx1 = ceildiv(tx1, ddx), try1 = ceildiv(ty1, ddy);
      const int rpx = rs.pdx + lev, rpy = rs.pdy + lev;
      if (rpx >= 31 || rpy >= 31 || ((cdx << rpx) >> rpx) != cdx || ((cdy << rpy) >> rpy) != cdy)
        return -1;
      if (!((y % (cdy << rpy)) == 0 || (y == ty0 && ((try0 << lev) % (int64_t(1) << rpy)))))
        return -1;
      if (!((x % (cdx << rpx)) == 0 || (x == tx0 && ((trx0 << lev) % (int64_t(1) << rpx)))))
        return -1;
      if (rs.pw == 0 || rs.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      const int64_t prci = (ceildiv(x, ddx) >> rs.pdx) - (trx0 >> rs.pdx);
      const int64_t prcj = (ceildiv(y, ddy) >> rs.pdy) - (try0 >> rs.pdy);
      return static_cast<int>(prci + prcj * rs.pw);
    };
    auto steps = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
      dx = dy = 0;
      for (int c = c0; c < c1; c++)
        for (int r = 0; r < comps[c].p.numres; r++) {
          const int lev = comps[c].p.numres - 1 - r;
          const int ex = comps[c].res[r].pdx + lev, ey = comps[c].res[r].pdy + lev;
          if (ex < 32 && static_cast<uint64_t>(img[c].dx) <= UINT32_MAX / (uint64_t(1) << ex)) {
            const int64_t sx = int64_t(img[c].dx) << ex;
            dx = dx ? std::min(dx, sx) : sx;
          }
          if (ey < 32 && static_cast<uint64_t>(img[c].dy) <= UINT32_MAX / (uint64_t(1) << ey)) {
            const int64_t sy = int64_t(img[c].dy) << ey;
            dy = dy ? std::min(dy, sy) : sy;
          }
        }
    };
    auto next = [](int64_t v, int64_t step) { return v + (step - v % step); };
    std::vector<Poc> progs = pocs;
    if (progs.empty()) progs.push_back({0, 0, nlayers, maxres, nc, prog});
    for (const Poc& pc : progs) {
      l1 = std::min(pc.lay1, nlayers);
      const int r0 = pc.res0, r1 = std::min(pc.res1, maxres);
      const int c0 = pc.comp0, c1 = std::min(pc.comp1, nc);
      if (c0 >= nc) continue;   // OpenJPEG's iterator stops at once
      int64_t dx, dy;
      switch (pc.prg) {
        case 0:  // LRCP
          for (int l = 0; l < l1; l++)
            for (int r = r0; r < r1; r++)
              for (int c = c0; c < c1; c++)
                if (r < comps[c].p.numres)
                  for (int p = 0; p < nprec(c, r); p++) emit(c, r, p, l);
          break;
        case 1:  // RLCP
          for (int r = r0; r < r1; r++)
            for (int l = 0; l < l1; l++)
              for (int c = c0; c < c1; c++)
                if (r < comps[c].p.numres)
                  for (int p = 0; p < nprec(c, r); p++) emit(c, r, p, l);
          break;
        case 2:  // RPCL
          steps(0, nc, dx, dy);
          if (!dx || !dy) break;
          for (int r = r0; r < r1; r++)
            for (int64_t y = ty0; y < ty1; y = next(y, dy))
              for (int64_t x = tx0; x < tx1; x = next(x, dx))
                for (int c = c0; c < c1; c++) {
                  int p = precinct_at(c, r, x, y);
                  if (p >= 0) emit_layers(c, r, p);
                }
          break;
        case 3:  // PCRL
          steps(0, nc, dx, dy);
          if (!dx || !dy) break;
          for (int64_t y = ty0; y < ty1; y = next(y, dy))
            for (int64_t x = tx0; x < tx1; x = next(x, dx))
              for (int c = c0; c < c1; c++)
                for (int r = r0; r < std::min(r1, comps[c].p.numres); r++) {
                  int p = precinct_at(c, r, x, y);
                  if (p >= 0) emit_layers(c, r, p);
                }
          break;
        case 4:  // CPRL
          for (int c = c0; c < c1; c++) {
            steps(c, c + 1, dx, dy);
            if (!dx || !dy) break;
            for (int64_t y = ty0; y < ty1; y = next(y, dy))
              for (int64_t x = tx0; x < tx1; x = next(x, dx))
                for (int r = r0; r < std::min(r1, comps[c].p.numres); r++) {
                  int p = precinct_at(c, r, x, y);
                  if (p >= 0) emit_layers(c, r, p);
                }
          }
          break;
        default:  // an unknown Ppoc: OpenJPEG's iterator gives no packet
          if (pocs.empty()) throw Error{"an unknown progression order"};
      }
    }
    // OpenJPEG decodes a component only up to the highest resolution it
    // read a packet of, and hands Pillow the smaller plane: not carried
    std::vector<uint8_t> top(nc, 0);
    for (const Packet& pk : out)
      if (pk.res == comps[pk.comp].p.numres - 1) top[pk.comp] = 1;
    for (int c = 0; c < nc; c++)
      if (!top[c] && nprec(c, comps[c].p.numres - 1) > 0)
        throw Refused{"progressions that leave out a component's highest resolution"};
    return out;
  }

  static int numpasses(Bio& bio) {
    if (!bio.bit()) return 1;
    if (!bio.bit()) return 2;
    int n = static_cast<int>(bio.read(2));
    if (n != 3) return 3 + n;
    n = static_cast<int>(bio.read(5));
    if (n != 31) return 6 + n;
    return 37 + static_cast<int>(bio.read(7));
  }

  static int floorlog2(int v) {
    int l = 0;
    while (v > 1) {
      v >>= 1;
      l++;
    }
    return l;
  }

  // OpenJPEG's opj_t2_init_seg: how many passes segment k may hold
  static void init_seg(Cblk& cb, size_t k, int style, bool first) {
    if (cb.segs.size() <= k) cb.segs.resize(k + 1);
    Seg& sg = cb.segs[k];
    sg = Seg();
    if (style & S_TERMALL) sg.maxpasses = 1;
    else if (style & S_LAZY)
      sg.maxpasses = first ? 10 : (cb.segs[k - 1].maxpasses == 1 || cb.segs[k - 1].maxpasses == 10) ? 2 : 1;
    else sg.maxpasses = 109;
  }

  // read every packet of the tile, gathering each code-block's bytes by
  // codeword segment; an SOP segment before a packet and an EPH marker
  // after its header are skipped where found, and where they are missing
  // the packet is read on (OpenJPEG warns)
  void tier2() {
    const uint8_t* p = body;
    const uint8_t* end = body + len;
    for (const Packet& pk : packets()) {
      TileComp& tc = comps[pk.comp];
      Res& rs = tc.res[pk.res];
      const int style = tc.p.style;
      if ((csty & 2) && end - p >= 6 && p[0] == 0xFF && p[1] == 0x91) p += 6;
      Bio bio(p, end);
      const int present = bio.bit();
      if (present) {
        for (int b = 0; b < rs.nbands; b++) {
          if (rs.bands[b].empty()) continue;
          PrecBand& pb = rs.prec[static_cast<size_t>(pk.prec) * rs.nbands + b];
          if (pk.layer == 0) {
            pb.incl.reset();
            pb.imsb.reset();
          }
          for (size_t k = 0; k < pb.cblks.size(); k++) {
            Cblk& cb = cblks[pb.cblks[k]];
            int included = cb.seen ? bio.bit() : pb.incl.decode(bio, static_cast<int>(k), pk.layer + 1);
            if (!included) {
              cb.newpasses = 0;
              continue;
            }
            if (!cb.seen) {
              int i = 0;
              while (!pb.imsb.decode(bio, static_cast<int>(k), i)) {
                if (++i > 64 || bio.over) throw Error{"a bad zero bit-plane tag tree"};
              }
              cb.numbps = rs.bands[b].numbps + 1 - i;
              cb.numlenbits = 3;
              cb.seen = true;
            }
            cb.newpasses = numpasses(bio);
            while (bio.bit()) {
              if (++cb.numlenbits > 32) throw Error{"a bad Lblock increment"};
            }
            size_t sg = 0;
            if (!cb.nsegs) {
              init_seg(cb, 0, style, true);
            } else {
              sg = cb.nsegs - 1;
              if (cb.segs[sg].npasses == cb.segs[sg].maxpasses) init_seg(cb, ++sg, style, false);
            }
            for (int n = cb.newpasses; n > 0;) {
              Seg& seg = cb.segs[sg];
              seg.newpasses = std::min(seg.maxpasses - seg.npasses, n);
              const int bits = cb.numlenbits + floorlog2(seg.newpasses);
              if (bits > 32) throw Error{"a code-block length of more than 32 bits"};
              seg.newlen = static_cast<int>(bio.read(bits));
              n -= seg.newpasses;
              if (n > 0) init_seg(cb, ++sg, style, false);
            }
          }
        }
      }
      if (!bio.inalign()) throw Error{"a packet header runs past the tile's data"};
      p = bio.bp;
      if (csty & 4) {
        if (end - p < 2 || p[0] != 0xFF || p[1] != 0x92) throw Error{"an EPH marker missing"};
        p += 2;
      }
      if (!present) continue;
      for (int b = 0; b < rs.nbands; b++) {
        if (rs.bands[b].empty()) continue;
        PrecBand& pb = rs.prec[static_cast<size_t>(pk.prec) * rs.nbands + b];
        for (int ci : pb.cblks) {
          Cblk& cb = cblks[ci];
          if (!cb.newpasses) continue;
          size_t sg = 0;
          if (!cb.nsegs) {
            cb.nsegs = 1;
          } else {
            sg = cb.nsegs - 1;
            if (cb.segs[sg].npasses == cb.segs[sg].maxpasses) {
              sg++;
              cb.nsegs++;
            }
          }
          for (;;) {
            Seg& seg = cb.segs[sg];
            if (seg.newlen > end - p) throw Error{"a code-block's data runs past the tile's data"};
            cb.data.insert(cb.data.end(), p, p + seg.newlen);
            p += seg.newlen;
            seg.len += seg.newlen;
            seg.npasses += seg.newpasses;
            cb.npasses += seg.newpasses;
            cb.newpasses -= seg.newpasses;
            if (cb.newpasses <= 0) break;
            sg++;
            cb.nsegs++;
          }
          cb.newpasses = 0;
        }
      }
    }
  }

  void jobs(int t, std::vector<Job>& out) const {
    for (size_t c = 0; c < comps.size(); c++)
      for (size_t r = 0; r < comps[c].res.size(); r++) {
        const Res& rs = comps[c].res[r];
        for (size_t q = 0; q < rs.prec.size(); q++)
          for (int ci : rs.prec[q].cblks)
            out.push_back({ci, t, static_cast<int>(c), static_cast<int>(r),
                           static_cast<int>(q % rs.nbands)});
      }
  }
};

template <typename F>
void parallel(int n, int threads, F fn) {
  threads = std::max(1, std::min(threads, n));
  if (threads == 1) {
    for (int i = 0; i < n; i++) fn(i, 0);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  std::vector<std::string> errs(threads);
  for (int t = 0; t < threads; t++)
    pool.emplace_back([&, t] {
      try {
        for (int i; (i = next++) < n;) fn(i, t);
      } catch (const Error& e) {
        errs[t] = e.msg;
        next = n;
      }
    });
  for (std::thread& th : pool) th.join();
  for (const std::string& e : errs)
    if (!e.empty()) throw Error{e};
}


// ---- the inverse wavelet transforms (Annex F, OpenJPEG's arithmetic) ------------
//
// Each 1-D synthesis runs on an interleaved line of n samples whose first
// has parity cas, held in `lanes` independent lanes (sample j of lane k
// at w[j * lanes + k]): one lane for a row, a block of columns at once.

inline int mirror(int i, int n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * (n - 1) - i;
  return i;
}

void idwt53(int32_t* w, int n, int cas, int lanes) {
  if (n == 1) {
    if (cas)
      for (int k = 0; k < lanes; k++) w[k] /= 2;
    return;
  }
  if (n < 1) return;
  for (int j = cas; j < n; j += 2) {
    const int32_t *l = w + mirror(j - 1, n) * lanes, *r = w + mirror(j + 1, n) * lanes;
    int32_t* x = w + j * lanes;
    for (int k = 0; k < lanes; k++) x[k] -= (l[k] + r[k] + 2) >> 2;
  }
  for (int j = 1 - cas; j < n; j += 2) {
    const int32_t *l = w + mirror(j - 1, n) * lanes, *r = w + mirror(j + 1, n) * lanes;
    int32_t* x = w + j * lanes;
    for (int k = 0; k < lanes; k++) x[k] += (l[k] + r[k]) >> 1;
  }
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;  // OpenJPEG's two_invK
// the synthesis steps' factors: minus T.800's delta, gamma, beta and alpha
const float kDelta = -0.443506852f, kGamma = -0.882911075f;
const float kBeta = 0.052980118f, kAlpha = 1.586134342f;

inline void lift97(float* w, int n, int first, float c, int lanes) {
  for (int j = first; j < n; j += 2) {
    const float *l = w + mirror(j - 1, n) * lanes, *r = w + mirror(j + 1, n) * lanes;
    float* x = w + j * lanes;
    for (int k = 0; k < lanes; k++) x[k] = x[k] + ((l[k] + r[k]) * c);
  }
}

void idwt97(float* w, int n, int cas, int lanes) {
  const int sn = (n + 1 - cas) / 2, dn = n - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const int lo = cas, hi = 1 - cas;
  for (int j = 0; j < n; j++) {
    const float f = (j & 1) == lo ? kK : kTwoInvK;
    float* x = w + j * lanes;
    for (int k = 0; k < lanes; k++) x[k] = x[k] * f;
  }
  lift97(w, n, lo, kDelta, lanes);
  lift97(w, n, hi, kGamma, lanes);
  lift97(w, n, lo, kBeta, lanes);
  lift97(w, n, hi, kAlpha, lanes);
}

constexpr int kLanes = 16;

// a level of the 2-D synthesis: the deinterleaved rw x rh region (low
// part sn x sv first) made one resolution up, rows then columns
template <typename T, typename F>
void level(T* a, int stride, int rw, int rh, int sn, int sv, int casx, int casy, F line,
           int threads) {
  const int rows = std::max(1, threads);
  parallel(rows, threads, [&](int part, int) {
    std::vector<T> tmp(rw);
    for (int y = part * rh / rows; y < (part + 1) * rh / rows; y++) {
      T* row = a + static_cast<size_t>(y) * stride;
      for (int i = 0; i < sn; i++) tmp[2 * i + casx] = row[i];
      for (int i = 0; i < rw - sn; i++) tmp[2 * i + 1 - casx] = row[sn + i];
      line(tmp.data(), rw, casx, 1);
      std::copy(tmp.begin(), tmp.end(), row);
    }
  });
  const int blocks = (rw + kLanes - 1) / kLanes;
  parallel(blocks, threads, [&](int b, int) {
    const int x0 = b * kLanes, nl = std::min(kLanes, rw - x0);
    std::vector<T> tmp(static_cast<size_t>(rh) * nl);
    for (int i = 0; i < rh; i++) {
      const int j = i < sv ? 2 * i + casy : 2 * (i - sv) + 1 - casy;
      std::copy(a + static_cast<size_t>(i) * stride + x0,
                a + static_cast<size_t>(i) * stride + x0 + nl, tmp.begin() + static_cast<size_t>(j) * nl);
    }
    line(tmp.data(), rh, casy, nl);
    for (int i = 0; i < rh; i++)
      std::copy(tmp.begin() + static_cast<size_t>(i) * nl, tmp.begin() + static_cast<size_t>(i + 1) * nl,
                a + static_cast<size_t>(i) * stride + x0);
  });
}

void synthesize(TileComp& tc, bool reversible, int threads) {
  const int stride = tc.width();
  for (size_t r = 1; r < tc.res.size(); r++) {
    const Res &lo = tc.res[r - 1], &rs = tc.res[r];
    const int rw = rs.x1 - rs.x0, rh = rs.y1 - rs.y0;
    if (rw <= 0 || rh <= 0) continue;
    const int sn = lo.x1 - lo.x0, sv = lo.y1 - lo.y0;
    if (reversible)
      level(tc.idata.data(), stride, rw, rh, sn, sv, rs.x0 & 1, rs.y0 & 1, idwt53, threads);
    else
      level(tc.fdata.data(), stride, rw, rh, sn, sv, rs.x0 & 1, rs.y0 & 1, idwt97, threads);
  }
}

// the RCT or ICT of the first three components (OpenJPEG's
// opj_tcd_mct_decode): all three must be of one size; the first one's
// transform picks the RCT or the ICT, and a component of the other
// transform has its samples' bits taken as they lie, as OpenJPEG's shared
// int32 buffer takes them
void mct(Tile& tl) {
  TileComp* c3[3] = {&tl.comps[0], &tl.comps[1], &tl.comps[2]};
  const size_t n = static_cast<size_t>(c3[0]->width()) * c3[0]->height();
  for (int k = 1; k < 3; k++)
    if (c3[k]->p.numres != c3[0]->p.numres || static_cast<size_t>(c3[k]->width()) * c3[k]->height() != n)
      throw Error{"a component transform over components of different sizes"};
  const bool rev = c3[0]->p.qmfbid == 1;
  std::vector<int32_t> ibits[3];
  std::vector<float> fbits[3];
  int32_t* iv[3];
  float* fv[3];
  for (int k = 0; k < 3; k++) {
    TileComp& tc = *c3[k];
    if (rev && tc.p.qmfbid != 1) {
      ibits[k].resize(n);
      std::memcpy(ibits[k].data(), tc.fdata.data(), n * 4);
    } else if (!rev && tc.p.qmfbid == 1) {
      fbits[k].resize(n);
      std::memcpy(fbits[k].data(), tc.idata.data(), n * 4);
    }
    iv[k] = ibits[k].empty() ? tc.idata.data() : ibits[k].data();
    fv[k] = fbits[k].empty() ? tc.fdata.data() : fbits[k].data();
  }
  if (rev) {
    for (size_t k = 0; k < n; k++) {
      const int32_t y = iv[0][k], u = iv[1][k], v = iv[2][k];
      const int32_t g = y - ((u + v) >> 2);
      iv[0][k] = v + g;
      iv[1][k] = g;
      iv[2][k] = u + g;
    }
  } else {
    for (size_t k = 0; k < n; k++) {
      const float y = fv[0][k], u = fv[1][k], v = fv[2][k];
      const float r = y + (v * 1.402f);
      const float g = y - (u * 0.34413f) - (v * 0.71414f);
      const float b = y + (u * 1.772f);
      fv[0][k] = r;
      fv[1][k] = g;
      fv[2][k] = b;
    }
  }
  for (int k = 0; k < 3; k++) {
    if (!ibits[k].empty()) std::memcpy(c3[k]->fdata.data(), ibits[k].data(), n * 4);
    if (!fbits[k].empty()) std::memcpy(c3[k]->idata.data(), fbits[k].data(), n * 4);
  }
}

}  // namespace

extern "C" {

// Decode the tiles of a codestream into out.  hdr: ncomp, X0, Y0, W, H,
// ntiles, threads (0: the host's cores, at most 8), packed; the precision,
// signedness and XRsiz, YRsiz of each component; then per tile tx0, ty0,
// tx1, ty1 (on the reference grid), the offset and length of its joined
// tile-part bodies in body, the progression order, the layers, the MCT flag,
// COD's Scod and the number of POC progressions, 6 values each (RSpoc,
// CSpoc, LYEpoc, REpoc, CEpoc, Ppoc), and per component the levels + 1, the
// code-block exponents, the transform (1: 5/3), the guard bits, the
// code-block style, the ROI shift, 33 precinct width and 33 height
// exponents, 97 step exponents and 97 mantissas (a derived quantisation
// expanded by the caller).  out: int32 [ncomp][H][W] (the image area; every
// XRsiz and YRsiz 1), or, packed, each tile's components one after another,
// each at its tile-component's size, as OpenJPEG hands a tile to Pillow.
// Returns 0, or 1 with the reason in err (2: a file this decoder refuses).
int j2k_decode(const uint8_t* body, int64_t body_len, const int32_t* hdr, int32_t* out, char* err,
               int errlen) {
  try {
    const int nc = hdr[0], X0 = hdr[1], Y0 = hdr[2], W = hdr[3], H = hdr[4], nt = hdr[5];
    int threads = hdr[6];
    const bool packed = hdr[7] != 0;
    if (threads <= 0) threads = static_cast<int>(std::min(8u, std::max(1u, std::thread::hardware_concurrency())));
    std::vector<Comp> img(nc);
    const int32_t* q = hdr + 8;
    for (int c = 0; c < nc; c++) {
      img[c].prec = q[0];
      img[c].sgnd = q[1];
      img[c].dx = q[2];
      img[c].dy = q[3];
      q += 4;
    }
    std::vector<Tile> tiles(nt);
    for (int t = 0; t < nt; t++) {
      Tile& tl = tiles[t];
      tl.tx0 = q[0];
      tl.ty0 = q[1];
      tl.tx1 = q[2];
      tl.ty1 = q[3];
      if (q[4] < 0 || q[5] < 0 || static_cast<int64_t>(q[4]) + q[5] > body_len)
        throw Error{"a tile's data lies outside the codestream"};
      tl.body = body + q[4];
      tl.len = q[5];
      tl.prog = q[6];
      tl.nlayers = q[7];
      tl.mct = q[8];
      tl.csty = q[9];
      const int npocs = q[10];
      q += kTileHead;
      for (int k = 0; k < npocs; k++, q += 6) tl.pocs.push_back({q[0], q[1], q[2], q[3], q[4], q[5]});
      tl.comps.resize(nc);
      for (int c = 0; c < nc; c++) {
        CompParams& p = tl.comps[c].p;
        p.numres = q[0];
        p.xcb = q[1];
        p.ycb = q[2];
        p.qmfbid = q[3];
        p.guard = q[4];
        p.style = q[5];
        p.roishift = q[6];
        std::memcpy(p.ppx, q + 7, sizeof p.ppx);
        std::memcpy(p.ppy, q + 40, sizeof p.ppy);
        std::memcpy(p.expn, q + 73, sizeof p.expn);
        std::memcpy(p.mant, q + 170, sizeof p.mant);
        q += kCompRec;
      }
      tl.setup(img);
      tl.tier2();
    }
    // tier-1 of every code-block of every tile
    std::vector<Job> jobs;
    for (int t = 0; t < nt; t++) {
      for (TileComp& tc : tiles[t].comps) {
        const size_t n = static_cast<size_t>(tc.width()) * tc.height();
        if (tc.p.qmfbid == 1) tc.idata.assign(n, 0);
        else tc.fdata.assign(n, 0.0f);
      }
      tiles[t].jobs(t, jobs);
    }
    std::vector<T1> t1s(threads);
    parallel(static_cast<int>(jobs.size()), threads, [&](int i, int th) {
      const Job& j = jobs[i];
      Tile& tl = tiles[j.tile];
      TileComp& tc = tl.comps[j.comp];
      const Band& bd = tc.res[j.res].bands[j.band];
      Cblk& cb = tl.cblks[j.cblk];
      const int stride = tc.width();
      const size_t at = static_cast<size_t>(cb.y0 - bd.y0 + bd.yoff) * stride + (cb.x0 - bd.x0 + bd.xoff);
      const bool rev = tc.p.qmfbid == 1;
      void* dst = rev ? static_cast<void*>(tc.idata.data() + at) : static_cast<void*>(tc.fdata.data() + at);
      t1s[th].decode(cb, bd, rev, tc.p.style, tc.p.roishift, dst, stride);
      std::vector<uint8_t>().swap(cb.data);
    });
    // the inverse transforms, component transforms and level shifts
    const int inner = std::max(1, threads / (nt * nc));
    parallel(nt * nc, threads, [&](int i, int) {
      TileComp& tc = tiles[i / nc].comps[i % nc];
      synthesize(tc, tc.p.qmfbid == 1, inner);
    });
    std::vector<size_t> at(nt + 1, 0);     // each tile's offset in a packed out
    for (int t = 0; t < nt; t++) {
      at[t + 1] = at[t];
      for (const TileComp& tc : tiles[t].comps) at[t + 1] += static_cast<size_t>(tc.width()) * tc.height();
    }
    parallel(nt, threads, [&](int t, int) {
      Tile& tl = tiles[t];
      if (tl.mct && nc >= 3) mct(tl);
      size_t o = at[t];
      for (int c = 0; c < nc; c++) {
        const TileComp& tc = tl.comps[c];
        const int prec = img[c].prec;
        const int64_t lo = img[c].sgnd ? -(int64_t(1) << (prec - 1)) : 0;
        const int64_t hi = img[c].sgnd ? (int64_t(1) << (prec - 1)) - 1 : (int64_t(1) << prec) - 1;
        const int64_t shift = img[c].sgnd ? 0 : int64_t(1) << (prec - 1);
        const int tw = tc.width();
        for (int y = tc.y0; y < tc.y1; y++) {
          int32_t* row = packed ? out + o + static_cast<size_t>(y - tc.y0) * tw
                                : out + (static_cast<size_t>(c) * H + (y - Y0)) * W + (tl.tx0 - X0);
          const size_t src = static_cast<size_t>(y - tc.y0) * tw;
          for (int x = 0; x < tw; x++) {
            int64_t v;
            if (tc.p.qmfbid == 1) {
              v = tc.idata[src + x] + shift;
            } else {
              const float f = tc.fdata[src + x];
              if (f > static_cast<float>(INT_MAX)) v = hi;
              else if (f < static_cast<float>(INT_MIN)) v = lo;
              else v = static_cast<int64_t>(lrintf(f)) + shift;
            }
            row[x] = static_cast<int32_t>(std::min(hi, std::max(lo, v)));
          }
        }
        o += static_cast<size_t>(tw) * tc.height();
      }
    });
    return 0;
  } catch (const Refused& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
    return 2;
  } catch (const Error& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
    return 1;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "out of memory");
    return 1;
  }
}

}  // extern "C"
