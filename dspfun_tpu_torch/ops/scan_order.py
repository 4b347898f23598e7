"""Scan orders: index -> coordinate-list structures + (de)serialization
(numpy copy of ``dspfun_tpu/ops/scan_order.py``; tests/test_torch_scan.py
pins it to the original).

A "scan" assigns every DCT coefficient coordinate of a WxH grid to a
scan index; progressive reconstruction adds coefficients index by
index.  The reference models this as a growable index->[(y,x)...]
structure (scan/scan_precomputed.{h,c}) plus a vtable of closed-form
methods (scan/scan_methods.c).  Here every method materialises into a
single flat CSR-style structure host-side — the coordinate lists are
tiny metadata next to the device compute, and a dense representation
is what the batched device reconstruction consumes directly.

Serialization formats are the reference's two self-describing text
formats (scan/scan_precomputed.c:51-153, documented
scan/README.md:111-151):

* ``index``: a WxH matrix of scan indexes, space-separated, row-major.
* ``coordinate``: one line per scan index, each "x,y" pairs.

A first line containing a comma (or blank) is a coordinate file,
otherwise an index file (scan_precomputed.c:111).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["ScanOrder", "serialize", "unserialize", "SERIALIZATION_FORMATS"]

SERIALIZATION_FORMATS = ("index", "coordinate")


@dataclasses.dataclass
class ScanOrder:
    """CSR form of index -> [(y, x), ...].

    ``starts`` has ``limit + 1`` entries; index i's coordinates are
    ``ys[starts[i]:starts[i+1]]`` / ``xs[...]``.
    """

    starts: np.ndarray  # int64 [limit+1]
    ys: np.ndarray      # int32 [total]
    xs: np.ndarray      # int32 [total]

    @property
    def limit(self) -> int:
        return len(self.starts) - 1

    @property
    def total(self) -> int:
        return int(self.starts[-1])

    def intervals(self) -> np.ndarray:
        return np.diff(self.starts)

    @property
    def max_interval(self) -> int:
        return int(self.intervals().max()) if self.limit else 0

    def coords(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = int(self.starts[i]), int(self.starts[i + 1])
        return self.ys[s:e], self.xs[s:e]

    def dimensions(self) -> tuple[int, int]:
        """(width, height) = max coordinate + 1 on each axis
        (reference scan_precomputed.c:10-22)."""
        if len(self.xs) == 0:
            return 1, 1
        return int(self.xs.max()) + 1, int(self.ys.max()) + 1

    def inverted(self) -> "ScanOrder":
        """Reverse the scan-index order (scan --invert walks
        j = limit-1-i, reference scan/scan.c:392,424)."""
        iv = self.intervals()[::-1]
        starts = np.concatenate([[0], np.cumsum(iv)])
        ys = np.empty_like(self.ys)
        xs = np.empty_like(self.xs)
        pos = 0
        for i in range(self.limit - 1, -1, -1):
            y, x = self.coords(i)
            ys[pos : pos + len(y)] = y
            xs[pos : pos + len(x)] = x
            pos += len(y)
        return ScanOrder(starts.astype(np.int64), ys, xs)

    @classmethod
    def from_lists(cls, per_index: list[tuple[np.ndarray, np.ndarray]]) -> "ScanOrder":
        iv = np.array([len(y) for y, _ in per_index], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(iv)])
        if per_index:
            ys = np.concatenate([np.asarray(y, dtype=np.int32) for y, _ in per_index])
            xs = np.concatenate([np.asarray(x, dtype=np.int32) for _, x in per_index])
        else:
            ys = np.empty(0, dtype=np.int32)
            xs = np.empty(0, dtype=np.int32)
        return cls(starts.astype(np.int64), ys, xs)

    @classmethod
    def from_flat(
        cls, index: np.ndarray, ys: np.ndarray, xs: np.ndarray, limit: int | None = None
    ) -> "ScanOrder":
        """Build from parallel (index, y, x) arrays, preserving the
        input order of coordinates within each index (the reference
        appends in insertion order, scan_precomputed.c:24-49)."""
        index = np.asarray(index, dtype=np.int64)
        if limit is None:
            limit = int(index.max()) + 1 if len(index) else 0
        order = np.argsort(index, kind="stable")
        counts = np.bincount(index, minlength=limit)
        starts = np.concatenate([[0], np.cumsum(counts)])
        return cls(
            starts.astype(np.int64),
            np.asarray(ys, dtype=np.int32)[order],
            np.asarray(xs, dtype=np.int32)[order],
        )


def serialize(order: ScanOrder, fmt: str = "coordinate") -> str:
    """Text form (reference scan_precomputed.c:122-153)."""
    if fmt == "coordinate":
        lines = []
        for i in range(order.limit):
            y, x = order.coords(i)
            lines.append("".join(f"{int(xx)},{int(yy)} " for yy, xx in zip(y, x)))
        return "\n".join(lines) + "\n"
    if fmt == "index":
        # pad = log10f(limit)+1 (scan_precomputed.c:136)
        pad = int(math.log10(order.limit)) + 1 if order.limit > 1 else 1
        width, height = order.dimensions()
        index = np.zeros((height, width), dtype=np.int64)
        for i in range(order.limit):
            y, x = order.coords(i)
            index[y, x] = i
        return "\n".join(
            "".join(f"{index[y, x]:>{pad}} " for x in range(width))
            for y in range(height)
        ) + "\n"
    raise ValueError(f"unknown serialization format {fmt!r}")


def unserialize(text: str) -> ScanOrder:
    """Parse either format; a first line containing ',' (or blank)
    selects coordinate, else index (reference scan_precomputed.c:106-120)."""
    lines = text.split("\n")
    # str.split leaves one final '' when the text ends with a newline;
    # that artifact is not a line (the reference's getline never yields
    # it).  Every OTHER blank line — including newline-terminated
    # trailing ones — is a genuinely empty scan index and must be kept
    # (dropping them shrank the scan's limit on round trips).
    if lines and lines[-1] == "":
        lines.pop()
    if not lines:
        raise ValueError("empty scan file")
    first = lines[0]
    if "," in first or first.strip() == "":
        per_index: list[tuple[list, list]] = []
        for line in lines:
            ys: list[int] = []
            xs: list[int] = []
            for token in line.split(" "):
                token = token.strip()
                if not token:
                    continue
                x_s, _, y_s = token.partition(",")
                if not _:
                    raise ValueError(f"bad coordinate token {token!r}")
                xs.append(int(x_s))
                ys.append(int(y_s))
            per_index.append((ys, xs))
        if not per_index:
            raise ValueError("empty scan file")
        return ScanOrder.from_lists(
            [(np.array(y, np.int32), np.array(x, np.int32)) for y, x in per_index]
        )
    idx_rows: list[list[int]] = []
    for line in lines:
        if line.strip() == "":
            continue  # blank lines skipped (scan_precomputed.c:81-82)
        idx_rows.append([int(t) for t in line.split()])
    if not idx_rows:
        raise ValueError("empty scan file")
    indexes = []
    ys = []
    xs = []
    for y, row in enumerate(idx_rows):
        for x, i in enumerate(row):
            indexes.append(i)
            ys.append(y)
            xs.append(x)
    return ScanOrder.from_flat(np.array(indexes), np.array(ys), np.array(xs))
