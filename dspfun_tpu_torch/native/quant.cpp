// Colour quantisers of Pillow's libImaging, written to give its palettes
// and index maps bit for bit:
//
//   median cut (Quant.c, method 0, kmeans 0), which Pillow runs for
//     Image.quantize() and convert("P", palette=ADAPTIVE) of RGB images:
//     colours counted in a table that drops low bits of every channel
//     once it holds more than 65536 of them; boxes split by the largest
//     pixel count first (QuantHeap.c's binary heap, whose order decides
//     ties), along the channel of the largest range weighted 77/150/29,
//     at the count median, ties of the median's value to the upper box;
//     the leaves left first (upper values first) give the palette, each
//     the rounded mean of its full-precision pixels; every colour then
//     takes the nearest palette entry among those its own box's entry
//     can reach (the first of equals in the order of their distance to
//     that entry, its own entry before all);
//   fast octree (QuantOctree.c) with alpha, which Pillow runs for both
//     calls on RGBA images: a fine cube of 3/4/3/3 bits and a coarse
//     one of 2 bits per channel, the coarse buckets first and the
//     most-used fine buckets after them (both in a stable sort by count,
//     as glibc's qsort sorts), means in single precision as Pillow
//     computes them, and fully transparent pixels given the colour of
//     the first of them (Quant.c ImagingQuantize).
//
// Integer arithmetic wherever Pillow's is, and no -ffast-math, so every
// build (-march=native included) writes the same palettes.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum { kOk = 0, kBadArgs = -1, kNoMemory = -2 };

constexpr uint32_t kMaxHashEntries = 65536;

// ---- median cut -----------------------------------------------------------

struct Entry {
  uint8_t c[3];  // the colour at the table's scale
  uint32_t count;
};

struct Box {
  int lo, hi;  // its entries: order[lo:hi]
  uint32_t pixels;
  int volume = -1;
  int left = -1, right = -1;
  uint8_t mx[3], mn[3];
};

class MedianCut {
 public:
  MedianCut(std::vector<Entry>& entries) : e_(entries) {
    order_.resize(e_.size());
    for (size_t i = 0; i < order_.size(); i++) order_[i] = (int)i;
  }

  // Split until `colors` leaves or no box of volume > 1 is left; the
  // leaves' indices, left first.
  std::vector<int> run(uint32_t total, int colors) {
    boxes_.push_back(make_box(0, (int)order_.size(), total));
    heap_.assign(1, -1);
    heap_add(0);
    int n = colors;
    while (--n) {
      int b;
      do {
        if (!heap_remove(&b)) goto done;
      } while (volume(b) == 1);
      split(b);
      heap_add(boxes_[b].left);
      heap_add(boxes_[b].right);
    }
  done:
    std::vector<int> leaves;
    collect(0, &leaves);
    return leaves;
  }

  const Box& box(int b) const { return boxes_[b]; }
  int entry(int i) const { return order_[i]; }

 private:
  Box make_box(int lo, int hi, uint32_t pixels) {
    Box b;
    b.lo = lo;
    b.hi = hi;
    b.pixels = pixels;
    for (int a = 0; a < 3; a++) {
      b.mx[a] = 0;
      b.mn[a] = 255;
    }
    for (int i = lo; i < hi; i++) {
      const Entry& en = e_[order_[i]];
      for (int a = 0; a < 3; a++) {
        b.mx[a] = std::max(b.mx[a], en.c[a]);
        b.mn[a] = std::min(b.mn[a], en.c[a]);
      }
    }
    return b;
  }

  int volume(int bi) {
    Box& b = boxes_[bi];
    if (b.volume < 0)
      b.volume = b.hi == b.lo ? 0
                              : (b.mx[0] - b.mn[0] + 1) * (b.mx[1] - b.mn[1] + 1) *
                                    (b.mx[2] - b.mn[2] + 1);
    return b.volume;
  }

  // Quant.c split + splitlists: the axis of the largest weighted range
  // (the first of equals); the upper part takes every value down to the
  // one at which the count passes half the box's pixels, unless that
  // is the lowest value, which then goes alone to the lower part.
  void split(int bi) {
    Box b = boxes_[bi];
    const int f[3] = {(b.mx[0] - b.mn[0]) * 77, (b.mx[1] - b.mn[1]) * 150,
                      (b.mx[2] - b.mn[2]) * 29};
    int axis = 0, best = f[0];
    for (int i = 1; i < 3; i++)
      if (best < f[i]) {
        best = f[i];
        axis = i;
      }
    uint64_t hist[256] = {};
    for (int i = b.lo; i < b.hi; i++) hist[e_[order_[i]].c[axis]] += e_[order_[i]].count;
    uint32_t cum = 0;
    int cut = b.mn[axis];
    for (int v = b.mx[axis]; v >= b.mn[axis]; v--) {
      cum += (uint32_t)hist[v];
      if (hist[v] && (uint64_t)cum * 2 > b.pixels) {
        cut = v;
        break;
      }
    }
    if (cut == b.mn[axis]) cut = b.mn[axis] + 1;  // nothing left below: the lowest alone
    // entries with value >= cut go left, keeping their order
    auto mid = std::stable_partition(order_.begin() + b.lo, order_.begin() + b.hi,
                                     [&](int i) { return e_[i].c[axis] >= cut; });
    int m = (int)(mid - order_.begin());
    uint32_t left_pixels = 0;
    for (int i = b.lo; i < m; i++) left_pixels += e_[order_[i]].count;
    int l = (int)boxes_.size();
    boxes_.push_back(make_box(b.lo, m, left_pixels));
    boxes_.push_back(make_box(m, b.hi, b.pixels - left_pixels));
    boxes_[bi].left = l;
    boxes_[bi].right = l + 1;
  }

  void collect(int bi, std::vector<int>* leaves) const {
    const Box& b = boxes_[bi];
    if (b.left >= 0) {
      collect(b.left, leaves);
      collect(b.right, leaves);
    } else if (b.hi > b.lo) {
      leaves->push_back(bi);
    }
  }

  // QuantHeap.c: a max-heap on the pixel count, 1-based
  int cmp(int a, int b) const { return (int)boxes_[a].pixels - (int)boxes_[b].pixels; }

  void heap_add(int v) {
    heap_.push_back(-1);
    size_t k = heap_.size() - 1;
    while (k != 1) {
      if (cmp(v, heap_[k / 2]) <= 0) break;
      heap_[k] = heap_[k / 2];
      k >>= 1;
    }
    heap_[k] = v;
  }

  bool heap_remove(int* r) {
    size_t count = heap_.size() - 1;
    if (!count) return false;
    *r = heap_[1];
    int v = heap_[count];
    heap_.pop_back();
    count--;
    size_t k, l;
    for (k = 1; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(heap_[l], heap_[l + 1]) < 0) l++;
      if (cmp(v, heap_[l]) > 0) break;
      heap_[k] = heap_[l];
    }
    if (count) heap_[k] = v;
    return true;
  }

  std::vector<Entry>& e_;
  std::vector<int> order_;
  std::vector<Box> boxes_;
  std::vector<int> heap_;
};

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
  int d0 = (int)a[0] - (int)b[0], d1 = (int)a[1] - (int)b[1], d2 = (int)a[2] - (int)b[2];
  return (uint32_t)(d0 * d0 + d1 * d1 + d2 * d2);
}

// ---- fast octree ------------------------------------------------------------

struct Bucket {
  uint32_t count;
  uint64_t sum[4];
};

struct Cube {
  int bits[4];
  int offset[4];
  std::vector<Bucket> buckets;

  Cube(int r, int g, int b, int a) : bits{r, g, b, a} {
    offset[0] = g + b + a;
    offset[1] = b + a;
    offset[2] = a;
    offset[3] = 0;
    buckets.assign(size_t(1) << (r + g + b + a), Bucket{0, {0, 0, 0, 0}});
  }
  size_t pos(const unsigned* v) const {
    return (size_t)v[0] << offset[0] | (size_t)v[1] << offset[1] | (size_t)v[2] << offset[2] |
           (size_t)v[3] << offset[3];
  }
  Bucket& at(const uint8_t* px) {
    unsigned v[4];
    for (int i = 0; i < 4; i++) v[i] = px[i] >> (8 - bits[i]);
    return buckets[pos(v)];
  }
  size_t used() const {
    size_t n = 0;
    for (const Bucket& b : buckets) n += b.count > 0;
    return n;
  }
};

inline uint8_t clip8(int v) { return v <= 0 ? 0 : v < 256 ? (uint8_t)v : 255; }

// avg_color_from_color_bucket: a uint64 sum over a float count
void bucket_mean(const Bucket& b, uint8_t* out) {
  float count = (float)b.count;
  for (int i = 0; i < 4; i++) out[i] = count != 0 ? clip8((int)((float)b.sum[i] / count)) : 0;
}

// copy_color_cube: the same buckets at other bit depths, summed or repeated
Cube copy_cube(const Cube& src, int r, int g, int b, int a) {
  Cube dst(r, g, b, a);
  int src_reduce[4] = {}, dst_reduce[4] = {}, width[4];
  for (int i = 0; i < 4; i++) {
    if (src.bits[i] > dst.bits[i]) {
      dst_reduce[i] = src.bits[i] - dst.bits[i];
      width[i] = 1 << src.bits[i];
    } else {
      src_reduce[i] = dst.bits[i] - src.bits[i];
      width[i] = 1 << dst.bits[i];
    }
  }
  unsigned v[4], s[4], d[4];
  for (v[0] = 0; (int)v[0] < width[0]; v[0]++)
    for (v[1] = 0; (int)v[1] < width[1]; v[1]++)
      for (v[2] = 0; (int)v[2] < width[2]; v[2]++)
        for (v[3] = 0; (int)v[3] < width[3]; v[3]++) {
          for (int i = 0; i < 4; i++) {
            s[i] = v[i] >> src_reduce[i];
            d[i] = v[i] >> dst_reduce[i];
          }
          const Bucket& from = src.buckets[src.pos(s)];
          Bucket& to = dst.buckets[dst.pos(d)];
          to.count += from.count;
          for (int i = 0; i < 4; i++) to.sum[i] += from.sum[i];
        }
  return dst;
}

std::vector<Bucket> sorted_by_count(const Cube& cube) {
  std::vector<Bucket> out(cube.buckets);
  std::stable_sort(out.begin(), out.end(),
                   [](const Bucket& a, const Bucket& b) { return (int)(b.count - a.count) < 0; });
  return out;
}

void subtract(Cube& cube, const std::vector<Bucket>& buckets, size_t from, size_t n) {
  uint8_t px[4];
  for (size_t i = from; i < from + n; i++) {
    const Bucket& s = buckets[i];
    if (s.count == 0) continue;
    bucket_mean(s, px);
    Bucket& m = cube.at(px);
    m.count -= s.count;
    for (int k = 0; k < 4; k++) m.sum[k] -= s.sum[k];
  }
}

void add_lookup(Cube& cube, const std::vector<Bucket>& palette, long n, long offset) {
  uint8_t px[4];
  for (long i = offset + n - 1; i >= offset; i--) {
    bucket_mean(palette[i], px);
    cube.at(px).count = (uint32_t)i;
  }
}

}  // namespace

extern "C" {

// Median cut of `n` RGB pixels (3 bytes each) into at most `colors`
// (1..256) entries: idx[n] gets each pixel's entry, palette[3 * colors]
// the entries, *npal their number.
int quant_median_cut(const uint8_t* rgb, int64_t n, int colors, uint8_t* idx, uint8_t* palette,
                     int* npal) {
  if (n <= 0 || colors < 1 || colors > 256) return kBadArgs;
  // full-precision counts, and the distinct colours in order of appearance
  uint32_t* full = static_cast<uint32_t*>(std::calloc(size_t(1) << 24, sizeof(uint32_t)));
  if (!full) return kNoMemory;
  std::vector<uint32_t> distinct;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = rgb + 3 * i;
    uint32_t k = (uint32_t)p[0] << 16 | (uint32_t)p[1] << 8 | p[2];
    if (full[k]++ == 0) distinct.push_back(k);
  }
  // the table's scale: the fewest low bits dropped that leave <= 65536 colours
  int scale = 0;
  if (distinct.size() > kMaxHashEntries) {
    for (scale = 1; scale < 8; scale++) {
      int cb = 8 - scale;
      std::vector<uint8_t> seen(size_t(1) << (3 * cb), 0);
      size_t count = 0;
      for (uint32_t k : distinct) {
        uint32_t s = (k >> 16 >> scale) << (2 * cb) | ((k >> 8 & 255) >> scale) << cb |
                     ((k & 255) >> scale);
        count += !seen[s];
        seen[s] = 1;
      }
      if (count <= kMaxHashEntries) break;
    }
  }
  const int cb = 8 - scale;
  auto scaled = [&](uint32_t k) {
    return (k >> 16 >> scale) << (2 * cb) | ((k >> 8 & 255) >> scale) << cb |
           ((k & 255) >> scale);
  };
  // each scaled colour's entry, plus one (calloc: only the pages of the
  // colours present are touched)
  uint32_t* slot = static_cast<uint32_t*>(std::calloc(size_t(1) << (3 * cb), sizeof(uint32_t)));
  if (!slot) {
    std::free(full);
    return kNoMemory;
  }
  std::vector<Entry> entries;
  for (uint32_t k : distinct) {
    uint32_t s = scaled(k);
    if (!slot[s]) {
      slot[s] = (uint32_t)entries.size() + 1;
      entries.push_back(Entry{{(uint8_t)((k >> 16) >> scale), (uint8_t)(((k >> 8) & 255) >> scale),
                               (uint8_t)((k & 255) >> scale)},
                              0});
    }
    entries[slot[s] - 1].count += full[k];
  }

  MedianCut mc(entries);
  std::vector<int> leaves = mc.run((uint32_t)n, colors);
  const int np = (int)leaves.size();
  // each entry's box, then the boxes' means over full-precision pixels
  std::vector<int> box_of(entries.size());
  for (int li = 0; li < np; li++) {
    const Box& b = mc.box(leaves[li]);
    for (int i = b.lo; i < b.hi; i++) box_of[mc.entry(i)] = li;
  }
  std::vector<uint32_t> sums(3 * np, 0), counts(np, 0);
  for (uint32_t k : distinct) {
    int li = box_of[slot[scaled(k)] - 1];
    uint32_t c = full[k];
    sums[3 * li] += c * (k >> 16);
    sums[3 * li + 1] += c * ((k >> 8) & 255);
    sums[3 * li + 2] += c * (k & 255);
    counts[li] += c;
  }
  std::vector<uint8_t> pal(3 * np);
  for (int li = 0; li < np; li++)
    for (int a = 0; a < 3; a++)
      pal[3 * li + a] = (uint8_t)(int)(.5 + (double)sums[3 * li + a] / (double)counts[li]);
  // each entry's neighbours by distance (a stable sort, as glibc's qsort)
  std::vector<uint32_t> dist((size_t)np * np);
  for (int i = 0; i < np; i++)
    for (int j = 0; j <= i; j++)
      dist[(size_t)i * np + j] = dist[(size_t)j * np + i] = dist2(&pal[3 * i], &pal[3 * j]);
  std::vector<int> near((size_t)np * np);
  for (int i = 0; i < np; i++) {
    int* row = &near[(size_t)i * np];
    const uint32_t* d = &dist[(size_t)i * np];
    for (int j = 0; j < np; j++) row[j] = j;
    std::stable_sort(row, row + np, [d](int a, int b) { return d[a] < d[b]; });
  }
  // map_image_pixels_from_median_box, once per distinct colour
  for (uint32_t k : distinct) {
    const uint8_t px[3] = {(uint8_t)(k >> 16), (uint8_t)(k >> 8), (uint8_t)k};
    int own = box_of[slot[scaled(k)] - 1];
    uint32_t best = dist2(&pal[3 * own], px);
    uint32_t reach = best << 2;
    int match = own;
    const int* row = &near[(size_t)own * np];
    const uint32_t* d = &dist[(size_t)own * np];
    for (int j = 0; j < np; j++) {
      if (d[row[j]] > reach) break;
      uint32_t dd = dist2(&pal[3 * row[j]], px);
      if (dd < best) {
        best = dd;
        match = row[j];
      }
    }
    full[k] = (uint32_t)match;
  }
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = rgb + 3 * i;
    idx[i] = (uint8_t)full[(uint32_t)p[0] << 16 | (uint32_t)p[1] << 8 | p[2]];
  }
  std::free(full);
  std::free(slot);
  std::memcpy(palette, pal.data(), pal.size());
  *npal = np;
  return kOk;
}

// Fast octree of `n` RGBA pixels (4 bytes each) into `colors` (1..256)
// entries: idx[n], palette[4 * colors] (every entry, used or not).
int quant_octree_rgba(const uint8_t* rgba, int64_t n, int colors, uint8_t* idx,
                      uint8_t* palette) {
  if (n <= 0 || colors < 1 || colors > 256) return kBadArgs;
  try {
    std::vector<uint8_t> px(rgba, rgba + 4 * n);
    bool seen = false;
    uint8_t t[3] = {0, 0, 0};
    for (int64_t i = 0; i < n; i++) {
      uint8_t* p = &px[4 * i];
      if (p[3] != 0) continue;
      if (!seen) {
        seen = true;
        std::memcpy(t, p, 3);
      } else {
        std::memcpy(p, t, 3);
      }
    }
    const size_t want = (size_t)colors;
    Cube fine(3, 4, 3, 3);
    for (int64_t i = 0; i < n; i++) {
      Bucket& b = fine.at(&px[4 * i]);
      b.count += 1;
      for (int k = 0; k < 4; k++) b.sum[k] += px[4 * i + k];
    }
    Cube coarse = copy_cube(fine, 2, 2, 2, 2);
    size_t ncoarse = std::min(coarse.used(), want);
    size_t nfine = want - ncoarse;
    std::vector<Bucket> fine_sorted = sorted_by_count(fine);
    subtract(coarse, fine_sorted, 0, nfine);
    while (ncoarse > coarse.used()) {
      size_t done = nfine;
      ncoarse = coarse.used();
      nfine = want - ncoarse;
      subtract(coarse, fine_sorted, done, nfine - done);
    }
    std::vector<Bucket> coarse_sorted = sorted_by_count(coarse);
    std::vector<Bucket> pal(coarse_sorted.begin(), coarse_sorted.begin() + ncoarse);
    pal.insert(pal.end(), fine_sorted.begin(), fine_sorted.begin() + nfine);
    Cube coarse_lookup(2, 2, 2, 2);
    add_lookup(coarse_lookup, pal, (long)ncoarse, 0);
    Cube lookup = copy_cube(coarse_lookup, 3, 4, 3, 3);
    add_lookup(lookup, pal, (long)nfine, (long)ncoarse);
    for (int64_t i = 0; i < n; i++) idx[i] = (uint8_t)lookup.at(&px[4 * i]).count;
    for (size_t i = 0; i < want; i++) bucket_mean(pal[i], palette + 4 * i);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return kOk;
}

}  // extern "C"
