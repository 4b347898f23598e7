"""The scan method registry: 17 frequency-space scan orders (numpy copy
of ``dspfun_tpu/ops/scan_methods.py``; tests/test_torch_scan.py pins it to
the original).

Re-derivations of reference scan/scan_methods.c.  Every method
materialises host-side into a :class:`~dspfun_tpu_torch.ops.scan_order.ScanOrder`
(the reference streams closed-form methods index-by-index; here the
coordinate lists are precomputed metadata feeding batched device
contractions, so everything goes through the precomputed form — the
reference itself has the same canonicalisation in its `precomputed`
meta-method, scan_methods.c:412-435).

Methods (reference table scan_methods.c:453-567):
  single-element: horizontal, vertical, zigzag, random(seed)
  multi-element:  row, column, diagonal, mirror, box, ibox
  data-built:     radial(rounding), iradial(rounding),
                  magnitude(qfactor), evalxy(expr), evali(xexpr;yexpr)
  meta:           file(path), precomputed(method:opts)

Deviations from the reference (documented, deliberate):
* ``box`` emits no out-of-range x==i column coordinates when i >= width
  (the reference writes them unchecked, scan_methods.c:122-133, which
  indexes out of bounds for tall images).
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np

from dspfun_tpu_torch.core.expr import parse_expr
from dspfun_tpu_torch.ops.scan_order import ScanOrder, unserialize

__all__ = ["METHODS", "get_method", "find_method_prefix", "method_names", "method_options"]


def _round_fn(name: str | None) -> Callable[[np.ndarray], np.ndarray]:
    """tonearest/round, upward/ceil, downward/floor, default rint
    (reference scan_methods.c:287-297)."""
    if name:
        if name in ("tonearest", "round"):
            # C round(): halfway away from zero
            return lambda a: np.floor(np.abs(a) + 0.5) * np.sign(a)
        if name in ("upward", "ceil"):
            return np.ceil
        if name in ("downward", "floor"):
            return np.floor
    return np.rint


def _grid(width: int, height: int):
    y, x = np.mgrid[0:height, 0:width]
    return y.ravel(), x.ravel()


# --- single-element scans --------------------------------------------------


def _horizontal(width, height, channels, coeffs, args):
    i = np.arange(width * height, dtype=np.int64)
    return ScanOrder.from_flat(i, i // width, i % width)


def _vertical(width, height, channels, coeffs, args):
    i = np.arange(width * height, dtype=np.int64)
    return ScanOrder.from_flat(i, i % height, i // height)


def _inv_triangular(i: np.ndarray) -> np.ndarray:
    return (np.sqrt(i * 2.0 + 0.25) - 0.5).astype(np.int64)


def _zigzag(width, height, channels, coeffs, args):
    """Closed-form zigzag (reference scan_methods.c:77-115): diagonal d
    is traversed with y descending when d is even, ascending when odd,
    in three regions (upper triangle / middle band / lower triangle)."""
    w, h = width, height
    mn = min(w, h)
    min_t = mn * (mn + 1) // 2
    area = w * h
    i = np.arange(area, dtype=np.int64)
    y = np.zeros(area, dtype=np.int64)
    x = np.zeros(area, dtype=np.int64)

    m1 = i < min_t
    dx = _inv_triangular(i[m1])
    dy = i[m1] - dx * (dx + 1) // 2
    dy = np.where(dx % 2 == 0, dx - dy, dy)
    y[m1] = dy
    x[m1] = dx - dy

    m3 = (~m1) & (area - i <= min_t)
    ii = area - i[m3] - 1
    dx = _inv_triangular(ii)
    dy = ii - dx * (dx + 1) // 2
    dy = np.where(((w + h - 1) - dx - 1) % 2 == 0, dx - dy, dy)
    y[m3] = (h - 1) - dy
    x[m3] = (w - 1) - (dx - dy)

    m2 = ~(m1 | m3)
    im = i[m2]
    dxm = (im - min_t) // mn
    dym = mn - (im - (dxm * mn + min_t))
    dym = np.where((dxm + mn) % 2 == 0, mn - dym + 1, dym)
    if w < h:
        dym = mn - dym + 1
        y[m2] = dxm + dym
        x[m2] = w - dym
    else:
        y[m2] = h - dym
        x[m2] = dxm + dym

    return ScanOrder.from_flat(i, y, x)


def _glibc_rand_stream(seed: int, n: int) -> list[int]:
    """glibc's default rand(): TYPE_3 additive-feedback generator
    (stdlib/random_r.c — deg 31, sep 3; 31 LCG-seeded words, 10*31
    warm-up outputs discarded, r[i] = r[i-3] + r[i-31] mod 2^32,
    output >> 1).  Validated word-exact against gcc/glibc output
    (tests/test_scan_methods.py goldens)."""
    seed &= 0xFFFFFFFF
    if seed == 0:
        seed = 1
    r = [0] * (344 + n)
    word = seed if seed < 2**31 else seed - 2**32
    r[0] = word & 0xFFFFFFFF
    for i in range(1, 31):
        # Schrage's method on signed int32: 16807 * word mod (2^31 - 1)
        hi, lo = divmod(word, 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r[i] = word
    for i in range(31, 34):
        r[i] = r[i - 31]
    for i in range(34, 344 + n):
        r[i] = (r[i - 3] + r[i - 31]) % 2**32
    return [r[i] >> 1 for i in range(344, 344 + n)]


def _random(width, height, channels, coeffs, args):
    """Seeded runs reproduce the reference byte-exactly: glibc rand()
    feeding the reference's Fisher-Yates variant (loop stops at i > 1,
    scan_methods.c:210-228)."""
    seed = int(args) if args else int(time.time())
    len_ = width * height
    perm = np.arange(len_, dtype=np.int64)
    rnd = _glibc_rand_stream(seed, max(0, len_ - 2))
    for k, i in enumerate(range(len_ - 1, 1, -1)):
        j = rnd[k] % (i + 1)
        perm[j], perm[i] = perm[i], perm[j]
    i = np.arange(len_, dtype=np.int64)
    return ScanOrder.from_flat(i, perm // width, perm % width)


# --- multi-element scans ---------------------------------------------------


def _row(width, height, channels, coeffs, args):
    return ScanOrder.from_lists(
        [(np.full(width, yy, np.int32), np.arange(width, dtype=np.int32))
         for yy in range(height)]
    )


def _column(width, height, channels, coeffs, args):
    return ScanOrder.from_lists(
        [(np.arange(height, dtype=np.int32), np.full(height, xx, np.int32))
         for xx in range(width)]
    )


def _diagonal(width, height, channels, coeffs, args):
    """Anti-diagonal i, y descending from min(i, h-1) while x < w
    (reference scan_methods.c:160-165)."""
    per = []
    for i in range(width + height - 1):
        ys = np.arange(min(i, height - 1), -1, -1, dtype=np.int32)
        xs = i - ys
        keep = xs < width
        per.append((ys[keep], xs[keep].astype(np.int32)))
    return ScanOrder.from_lists(per)


def _mirror(width, height, channels, coeffs, args):
    """Index 0 is the main diagonal; index i>0 pairs the +i super- and
    -i sub-diagonal, each walked toward the origin
    (reference scan_methods.c:167-184)."""
    per = []
    d = np.arange(min(width, height), dtype=np.int32)
    per.append((d, d))
    for i in range(1, max(width, height)):
        ys: list[np.ndarray] = []
        xs: list[np.ndarray] = []
        if i < width:
            t = np.arange(min(height, width - i), 0, -1, dtype=np.int32)
            ys.append(t - 1)
            xs.append(t + i - 1)
        if i < height:
            t = np.arange(min(width, height - i), 0, -1, dtype=np.int32)
            ys.append(t + i - 1)
            xs.append(t - 1)
        per.append(
            (np.concatenate(ys) if ys else np.empty(0, np.int32),
             np.concatenate(xs) if xs else np.empty(0, np.int32))
        )
    return ScanOrder.from_lists(per)


def _box(width, height, channels, coeffs, args):
    """L-shaped shells: column x=i above, then row y=min(i,h-1)
    (reference scan_methods.c:122-133; out-of-range column coords for
    i >= width are dropped here rather than emitted unchecked)."""
    per = []
    for i in range(max(width, height)):
        ymax = min(i, height - 1)
        xmax = min(i, width - 1)
        ys: list[np.ndarray] = []
        xs: list[np.ndarray] = []
        if i < width and ymax > 0:
            ys.append(np.arange(ymax, dtype=np.int32))
            xs.append(np.full(ymax, i, np.int32))
        ys.append(np.full(xmax + 1, ymax, np.int32))
        xs.append(np.arange(xmax + 1, dtype=np.int32))
        per.append((np.concatenate(ys), np.concatenate(xs)))
    return ScanOrder.from_lists(per)


def _ibox(width, height, channels, coeffs, args):
    """Inverse box: row y=i rightward then column x=i downward; the
    corner (i,i) appears in both halves, as in the reference
    (scan_methods.c:135-144 — interval w+h-2i counts it twice)."""
    per = []
    for i in range(min(width, height)):
        ys = np.concatenate(
            [np.full(width - i, i, np.int32), np.arange(i, height, dtype=np.int32)]
        )
        xs = np.concatenate(
            [np.arange(i, width, dtype=np.int32), np.full(height - i, i, np.int32)]
        )
        per.append((ys, xs))
    return ScanOrder.from_lists(per)


# --- data-built scans ------------------------------------------------------


def _radial(width, height, channels, coeffs, args):
    """index = round(hypot(x, y)) (reference scan_methods.c:299-313)."""
    roundfn = _round_fn(args)
    y, x = _grid(width, height)
    idx = roundfn(np.hypot(x.astype(np.float64), y.astype(np.float64))).astype(np.int64)
    return ScanOrder.from_flat(idx, y, x)


def _iradial(width, height, channels, coeffs, args):
    """index counts inward from the far corner
    (reference scan_methods.c:315-331)."""
    roundfn = _round_fn(args)
    y, x = _grid(width, height)
    limit = int(roundfn(np.hypot(float(width - 1), float(height - 1)))) + 1
    idx = limit - roundfn(
        np.hypot((width - x - 1).astype(np.float64), (height - y - 1).astype(np.float64))
    ).astype(np.int64) - 1
    return ScanOrder.from_flat(idx, y, x, limit=limit)


def _magnitude(width, height, channels, coeffs, args):
    """Order by per-coordinate summed |coefficient| x uniform-range
    normalization, descending; equal (optionally quantized) values
    group into a shared index (reference scan_methods.c:240-285).

    ``coeffs`` is the [H, W, C] DCT coefficient array (already /4wh).
    """
    if coeffs is None:
        raise ValueError("magnitude scan requires coefficient data")
    qfactor = float(args) if args else 0.0
    c = np.asarray(coeffs, dtype=np.float64).reshape(height, width, -1)
    nch = c.shape[-1]
    mag = np.abs(c).sum(axis=-1)
    y, x = _grid(width, height)
    norm = np.where(x > 0, math.sqrt(2.0), 1.0) * np.where(y > 0, math.sqrt(2.0), 1.0)
    val = mag.ravel() * norm
    if qfactor:
        val = np.rint(val * qfactor / nch)
    order = np.argsort(-val, kind="stable")
    # grouping: first of a run of equal values keeps its own index, the
    # rest share the next (reference scan_methods.c:266-274)
    sv = val[order]
    # j[i] = number of value changes strictly before i (vectorised form
    # of the reference's running-jj loop; semantics verified identical)
    changes = np.concatenate([[True], sv[1:] != sv[:-1]])
    j = np.cumsum(changes) - changes
    return ScanOrder.from_flat(j.astype(np.int64), y[order], x[order])


def _evalxy(width, height, channels, coeffs, args):
    """index = rint(f(x, y)); nan/inf/negative results skip the
    coordinate (reference scan_methods.c:333-364)."""
    if not args:
        raise ValueError("evalxy requires an expression")
    expr = parse_expr(args, ("x", "y"))
    y, x = _grid(width, height)
    res = np.rint(
        np.asarray(
            expr({"x": x.astype(np.float64), "y": y.astype(np.float64)}, np),
            dtype=np.float64,
        )
    )
    res = np.broadcast_to(res, y.shape)
    keep = np.isfinite(res) & (res >= 0)
    if not keep.any():
        raise ValueError("evalxy expression produced no valid indexes")
    return ScanOrder.from_flat(res[keep].astype(np.int64), y[keep], x[keep])


def _evali(width, height, channels, coeffs, args):
    """x = f(i,...) ; y = f(i,...), each rint'd then wrapped mod
    width/height, nan/inf/negative -> 0 (reference scan_methods.c:186-201,
    366-391)."""
    if not args or ";" not in args:
        raise ValueError("evali requires 'xexpr; yexpr'")
    xsrc, ysrc = args.split(";", 1)
    names = ("i", "width", "height")
    xexpr = parse_expr(xsrc, names)
    yexpr = parse_expr(ysrc, names)
    i = np.arange(width * height, dtype=np.float64)
    env = {"i": i, "width": float(width), "height": float(height)}

    def coordize(res, mod):
        res = np.rint(np.broadcast_to(np.asarray(res, dtype=np.float64), i.shape))
        bad = ~np.isfinite(res) | (res < 0)
        safe = np.nan_to_num(res, nan=0.0, posinf=0.0, neginf=0.0)
        return np.where(bad, 0, safe.astype(np.int64) % mod)

    x = coordize(xexpr(env, np), width)
    y = coordize(yexpr(env, np), height)
    return ScanOrder.from_flat(np.arange(width * height, dtype=np.int64), y, x)


# --- meta scans ------------------------------------------------------------


def _file(width, height, channels, coeffs, args):
    """Load a serialized scan; coordinates must fit the image
    (reference scan_methods.c:393-410)."""
    if not args:
        raise ValueError("file method requires a filename")
    with open(args) as f:
        order = unserialize(f.read())
    if len(order.xs) and (
        order.xs.max() >= width or order.ys.max() >= height
        or order.xs.min() < 0 or order.ys.min() < 0
    ):
        raise ValueError("serialized scan coordinates outside the image")
    return order


def _precomputed(width, height, channels, coeffs, args):
    """Materialise another method (reference scan_methods.c:412-435).
    All methods are precomputed here, so this is pure CLI parity."""
    if not args:
        raise ValueError("precomputed requires 'method:options'")
    name, _, opts = args.partition(":")
    if name == "precomputed":
        raise ValueError("precomputed cannot wrap itself")
    # the reference resolves the inner method by EXACT name —
    # init_precomputed calls scan_method_find, not the CLI's
    # find-by-prefix (scan_methods.c:412-423) — so `precomputed:zig`
    # is an error while `-m zig` works; keep that, but fail with the
    # parser's error type, not a bare KeyError
    m = METHODS.get(name)
    if m is None:
        raise ValueError(f"unknown scan method {name!r} "
                         "(precomputed: takes a full method name)")
    return m.build(width, height, channels, coeffs, opts or None)


class Method:
    def __init__(self, name, fn, init_args=None):
        self.name = name
        self.fn = fn
        self.init_args = init_args

    def build(self, width, height, channels=3, coeffs=None, args=None) -> ScanOrder:
        return self.fn(width, height, channels, coeffs, args)


METHODS = {
    m.name: m
    for m in [
        Method("horizontal", _horizontal),
        Method("vertical", _vertical),
        Method("zigzag", _zigzag),
        Method("random", _random, "optional seed (int)"),
        Method("row", _row),
        Method("column", _column),
        Method("diagonal", _diagonal),
        Method("mirror", _mirror),
        Method("box", _box),
        Method("ibox", _ibox),
        Method("radial", _radial, "optional rounding mode (tonearest, upward, downward, system)"),
        Method("iradial", _iradial, "optional rounding mode (tonearest, upward, downward, system)"),
        Method("magnitude", _magnitude, "optional quantization factor (float)"),
        Method("evalxy", _evalxy, "expression satisfying index = f(x,y)"),
        Method("evali", _evali, "expressions satisfying x = f(i,width,height); y = f(i,width,height)"),
        Method("file", _file, "filename"),
        Method("precomputed", _precomputed, "method:method options"),
    ]
}


def get_method(name: str) -> Method:
    if name not in METHODS:
        raise KeyError(f"unknown scan method {name!r}")
    return METHODS[name]


def find_method_prefix(prefix: str) -> Method | None:
    """Shortest method name with the given prefix
    (reference scan_methods.c:581-591)."""
    best = None
    for name, m in METHODS.items():
        if name.startswith(prefix) and (best is None or len(name) < len(best.name)):
            best = m
    return best


def method_names() -> list[str]:
    return list(METHODS)


def method_options(name: str) -> str | None:
    return METHODS[name].init_args
