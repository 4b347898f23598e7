"""applybasis/genbasis/draw compute (PyTorch port of
``dspfun_tpu/models/basis_pipeline.py``).

The reference applies separable 2-D basis functions of 12 transform
families to images with O(K^2 N^2) scalar loops
(applybasis/applybasis.c:409-448) and renders basis-function grids
(genbasis.c:253-271).  The quadruple loop with partial summing is

  forward:  out[a,b,i,j,z] = sum_{s,t} Ah[a,i,s] P[i,s,j,t,z] Aw[b,j,t]
  inverse:  out[a,b,i,j,z] = sum_{s,t} Ch[a,s,i] P[a,s,b,t,z] Cw[b,t,j]

where (a,b) indexes the output tile grid, (i,j) the pixels within a
tile, and (s,t) the partial-sum window (applybasis -u).  The JAX package
writes it as one three-operand einsum; here it is two explicit
contractions on the device, first over ``s`` with ``Ah`` (``Ch``), then
over ``t`` with ``Aw`` (``Cw``), batched over a leading image axis, so
the order does not hang on ``torch.einsum``'s path search.

Differences from the JAX package:

* **Dtype rule.** JAX takes complex128 when the policy asks for ``f64``
  and x64 is on, or when no policy is given and x64 is on.  PyTorch has
  no x64 switch: this module takes complex128/float64 when the policy's
  intermediate is ``f64`` and complex64/float32 otherwise, so the
  tools' default (hilo) runs complex64, as the JAX package does on its
  accelerator (ROADMAP queue 3).
* ``render_grid`` writes every tile in one strided assignment instead of
  a Python loop over the tiles; the values are the same
  (tests/test_torch_basis.py holds it to the loop).

The host stages (axis matrices, ``gen_basis_grid``, ``realize``,
``rescale_values``, ``range_encode``, ``coeff_scale_factor``, the
``.coeff`` files) are float64 numpy copies, so the PNG bytes equal the
JAX tool's.  ``draw_canvas`` ends in ``dct3_nd`` on the device, which at
an ``i8`` policy reaches the int8 digit kernels (``ops/int8mm.py``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision, get_precision
from dspfun_tpu_torch.utils.profiling import stage

__all__ = [
    "apply_basis",
    "gen_basis_grid",
    "realize",
    "rescale_values",
    "range_encode",
    "render_grid",
    "coeff_scale_factor",
    "write_coeff_file",
    "read_coeff_file",
    "draw_canvas",
]

_COMPLEX_FAMILIES = ("dft", "idft")


def _axis_matrix_forward(fname, nterms, ncontent, psum, offset, length, ortho):
    """Ah[k, i, s] = f(k + offset, i*psum + s, length)."""
    f = basis_mod.basis_fn(fname)
    k = (np.arange(nterms) + offset)[:, None, None]
    n = (np.arange(ncontent)[:, None] * psum + np.arange(psum)[None, :])[None]
    return np.asarray(f(k, n, length, ortho), dtype=np.complex128)


def _axis_matrix_inverse(fname, ntiles, psum, ncontent, offset, length, ortho):
    """Ch[a, s, i] = f(i, (a + offset)*psum + s, length)."""
    f = basis_mod.basis_fn(fname)
    i = np.arange(ncontent)[None, None, :]
    n = ((np.arange(ntiles) + offset)[:, None] * psum + np.arange(psum)[None, :])[
        :, :, None
    ]
    return np.asarray(f(i, n, length, ortho), dtype=np.complex128)


def _contract(mh: torch.Tensor, p: torch.Tensor, mw: torch.Tensor,
              inverse: bool) -> torch.Tensor:
    """The two contractions of one batch [N, ...] on the operands'
    device, each a two-operand product (one batched GEMM): over ``s``
    with the H matrix, then over ``t`` with the W matrix.  Returns
    [N, T_h, T_w, C_h, C_w, 3]."""
    if inverse:
        t = torch.einsum("asi,nasbtz->naibtz", mh, p)
        return torch.einsum("naibtz,btj->nabijz", t, mw)
    t = torch.einsum("ais,nisjtz->naijtz", mh, p)
    return torch.einsum("naijtz,bjt->nabijz", t, mw)


def apply_basis(
    pixels: np.ndarray,
    function: str,
    terms: tuple[int, int] | None = None,
    partsum: tuple[int, int] = (1, 1),
    offset: tuple[int, int] = (0, 0),
    inverse: bool = False,
    orthogonal: bool = False,
    precision: Precision | None = None,
    device: torch.device | str = "cuda",
    times: dict | None = None,
) -> np.ndarray:
    """Apply a separable 2-D basis with partial summing.

    ``pixels`` is [H, W, 3] (real or complex), or a batch [N, H, W, 3]
    that runs as one pair of contractions and one copy to the host.
    Returns the complex partial sums, complex128, as
    [(N,) tiles_h, tiles_w, content_h, content_w, 3]
    (reference applybasis.c:409-448).  ``terms``/``offset``/``partsum``
    are (w, h) pairs as on the CLI.  ``times``, when given, collects the
    seconds of ``plan`` (host matrices), ``h2d``, ``compute`` (to the end
    of the device's work; on a card also ``compute_device`` between CUDA
    events) and ``d2h``.
    """
    p = precision or get_precision()
    dev = torch.device(device)
    px = np.asarray(pixels)
    batched = px.ndim == 4
    in_h, in_w = px.shape[1:3] if batched else px.shape[:2]
    tw, th = terms if terms else (in_w, in_h)
    pw, ph = partsum
    ow, oh = offset

    use_complex = function.lower() in _COMPLEX_FAMILIES or np.iscomplexobj(px)
    if p.intermediate == "f64":
        cdtype, rdtype = np.complex128, np.float64
    else:
        cdtype, rdtype = np.complex64, np.float32

    if not batched:
        px = px[None]
    nb = px.shape[0]
    with stage("plan", times):
        if inverse:
            t_h, t_w = th // ph, tw // pw
            c_h, c_w = in_h, in_w
            mh = _axis_matrix_inverse(function, t_h, ph, c_h, oh, in_h, orthogonal)
            mw = _axis_matrix_inverse(function, t_w, pw, c_w, ow, in_w, orthogonal)
            pr = px[:, : t_h * ph, : t_w * pw].reshape(nb, t_h, ph, t_w, pw, 3)
        else:
            t_h, t_w = th, tw
            c_h, c_w = in_h // ph, in_w // pw
            mh = _axis_matrix_forward(function, t_h, c_h, ph, oh, in_h, orthogonal)
            mw = _axis_matrix_forward(function, t_w, c_w, pw, ow, in_w, orthogonal)
            pr = px[:, : c_h * ph, : c_w * pw].reshape(nb, c_h, ph, c_w, pw, 3)
        ops = [np.ascontiguousarray(a, dtype=cdtype) if use_complex
               else np.ascontiguousarray(a.real, dtype=rdtype) for a in (mh, pr, mw)]

    with stage("h2d", times):
        ops = [torch.tensor(a, device=dev) for a in ops]
    on_card = dev.type == "cuda"
    with stage("compute", times):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        out = _contract(*ops, inverse)
        if on_card:
            end.record()
            end.synchronize()
    if on_card and times is not None:
        times["compute_device"] = start.elapsed_time(end) / 1e3
    del ops
    with stage("d2h", times):
        res = out.cpu().numpy().astype(np.complex128)
    del out
    return res if batched else res[0]


def gen_basis_grid(
    function: str,
    size: tuple[int, int],
    terms: tuple[int, int] | None = None,
    offset: tuple[int, int] = (0, 0),
    inverse: bool = False,
    natural: bool = False,
) -> np.ndarray:
    """Render the basis functions themselves as a complex grid
    [tiles_h, tiles_w, size_h, size_w] (reference genbasis.c:253-271).

    ``natural`` centers the DC via offset -= terms/2 (genbasis.c:245-246);
    ``inverse`` swaps the roles of basis index and sample (a transpose
    of each axis's matrix, genbasis.c:234-239).
    """
    sw, sh = size
    tw, th = terms if terms else (sw, sh)
    ow, oh = offset
    if natural:
        ow -= tw // 2
        oh -= th // 2

    f = basis_mod.basis_fn(function)
    # per-axis [tiles, content] matrices; bi carries the offset
    def axis(nt, nc, off, length):
        b = np.arange(nt) + off
        n = np.arange(nc)
        if inverse:
            # k = content index, n = tile index (genbasis.c:234-239)
            return np.asarray(f(n[None, :], b[:, None], length, False),
                              dtype=np.complex128)
        return np.asarray(f(b[:, None], n[None, :], length, False),
                          dtype=np.complex128)

    ah = axis(th, sh, oh, sh)
    aw = axis(tw, sw, ow, sw)
    return ah[:, None, :, None] * aw[None, :, None, :]


def realize(values: np.ndarray, plane: str) -> np.ndarray:
    """Complex -> real plane (reference applybasis.c:21-32)."""
    if plane == "real":
        return values.real
    if plane == "imaginary":
        return values.imag
    if plane == "magnitude":
        return np.abs(values)
    if plane == "phase":
        return np.angle(values + 1j * np.finfo(np.float64).eps) / np.pi
    raise ValueError(f"unknown plane {plane!r}")


def _rescale_one(c: np.ndarray, kind: str, scale: float) -> np.ndarray:
    if kind == "linear":
        return c / scale
    if kind == "log":
        return np.copysign(np.log1p(np.abs(c)) / np.log1p(scale), c)
    if kind == "gain":
        s = np.sqrt(scale)
        c = c / s
        return np.copysign(np.log1p(np.abs(c)) / np.log1p(s), c)
    if kind == "level":
        c = c / scale
        return np.copysign(np.log1p(np.abs(c)) / np.log1p(1.0), c)
    raise ValueError(f"unknown rescale type {kind!r}")


def rescale_values(
    c: np.ndarray,
    kinds: tuple[str, str | None],
    coeff_scale: float,
    in_size: tuple[int, int],
) -> np.ndarray:
    """One or two rescale stages with sqrt-interpolation between them as
    the summed-term count grows (reference applybasis.c:34-48,429-435)."""
    a = _rescale_one(c, kinds[0], coeff_scale)
    if kinds[1] is None:
        return a
    b = _rescale_one(c, kinds[1], coeff_scale)
    big_n = np.sqrt(in_size[0] * in_size[1]) - 1
    n = np.sqrt(coeff_scale) - 1
    return ((big_n - n) * a + n * b) / big_n


def range_encode(c: np.ndarray, kind: str) -> np.ndarray:
    """Negative-value display encodings (reference applybasis.c:50-75).
    ``shift2`` also encodes the *input* (pixels*2-1, applybasis.c:358)
    but its display half is the same (v+1)/2 map as ``shift``: the
    reference aliases the function pointer (applybasis.c:62), and the
    README's default inverse reconstructions depend on it."""
    if kind == "abs":
        return np.abs(c)
    if kind == "invert":
        return c + (c < 0)
    if kind in ("shift", "shift2"):
        return (c + 1) / 2
    if kind == "hue":
        neg = (c < 0).any(axis=-1, keepdims=True)
        a = np.abs(c)
        mixed = np.stack(
            [
                (-a[..., 0] + 2 * a[..., 1] + 2 * a[..., 2]) / 3,
                (2 * a[..., 0] - a[..., 1] + 2 * a[..., 2]) / 3,
                (2 * a[..., 0] + 2 * a[..., 1] - a[..., 2]) / 3,
            ],
            axis=-1,
        )
        return np.where(neg, mixed, c)
    raise ValueError(f"unknown range type {kind!r}")


def coeff_scale_factor(function: str, partsum: tuple[int, int], inrange: float) -> float:
    """Normalisation constant: dct1/dst1 have logical lengths N-1/N+1
    (reference applybasis.c:400-407)."""
    pw, ph = partsum
    fname = function.lower()
    if fname.startswith("dct1"):
        # deviation: the reference computes inrange*(pw-1)*(ph-1) which
        # is ZERO for the default -u 1x1 (applybasis.c:403 divides by
        # it -> inf output); clamp the degenerate case to 1
        return max(inrange * (pw - 1) * (ph - 1), 1)
    if fname.startswith("dst1"):
        return inrange * (pw + 1) * (ph + 1)
    return inrange * pw * ph


def render_grid(
    values: np.ndarray,
    scale: int = 1,
    padding: int = 1,
    bg: tuple[float, float, float, float] = (0, 0, 0, 1),
) -> np.ndarray:
    """Tile [T_h, T_w, C_h, C_w, 3] values into a padded RGBA frame
    (reference applybasis.c:392-398,409,437-442): each tile is point-
    upscaled by ``scale`` with ``padding`` background pixels between
    tiles and around the frame.

    Below the top and left padding the frame is a [T_h, pitch_h, T_w,
    pitch_w] grid of cells, each a tile followed by its padding, so every
    tile lands in one strided assignment of a view."""
    t_h, t_w, c_h, c_w = values.shape[:4]
    fh = c_h * t_h * scale + padding * t_h + padding
    fw = c_w * t_w * scale + padding * t_w + padding
    frame = np.empty((fh, fw, 4), dtype=np.float64)
    frame[:] = np.asarray(bg)
    cells = frame[padding:, padding:].reshape(t_h, c_h * scale + padding,
                                              t_w, c_w * scale + padding, 4)
    tiles = cells[:, : c_h * scale, :, : c_w * scale].reshape(
        t_h, c_h, scale, t_w, c_w, scale, 4)
    tiles[..., :3] = values.transpose(0, 2, 1, 3, 4)[:, :, None, :, :, None]
    tiles[..., 3] = 1.0
    return frame


# ---------------------------------------------------------------------------
# .coeff dump files (reference applybasis.c:319-338,379-390,443-447)
# ---------------------------------------------------------------------------


def write_coeff_file(path: str, values: np.ndarray) -> None:
    """Dims header (two little-endian uint64: w, h) + row-major complex
    values, 3 per element.  The reference stores complex long double;
    the JAX package and the port store complex128 little-endian.

    ``values`` is the [T_h, T_w, C_h, C_w, 3] complex output of
    :func:`apply_basis`; the dump is laid out as the reference writes
    it, iterating tiles then content (applybasis.c:443-447).
    """
    t_h, t_w, c_h, c_w = values.shape[:4]
    w, h = c_w * t_w, c_h * t_h
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", w, h))
        flat = np.ascontiguousarray(values, dtype=np.complex128)
        f.write(flat.tobytes())


def read_coeff_file(path: str) -> tuple[np.ndarray, tuple[int, int]]:
    """Returns (flat complex array [h, w, 3], (w, h)).

    The dump stream is in (k_h, k_w, n_h, n_w) loop order; for the
    standard full-sum dump (content dims 1x1) this is exactly a [h, w]
    raster of coefficients, which is how the reference reloads it
    (applybasis.c:319-338: read as a [h, w, 3] pixel array).
    """
    with open(path, "rb") as f:
        w, h = struct.unpack("<QQ", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.complex128)
    if len(data) < w * h * 3:
        raise ValueError(f"truncated coeff file {path!r}")
    return data[: w * h * 3].reshape(h, w, 3).copy(), (int(w), int(h))


# ---------------------------------------------------------------------------
# draw (reference applybasis/draw.c)
# ---------------------------------------------------------------------------


def draw_canvas(
    size: tuple[int, int],
    coefs: list[tuple[int, int, float | None]],
    precision: Precision | None = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Place DCT coefficients at (x, y) positions and invert.

    Unweighted coefficients share the energy left over from weighted
    ones ((1-energy)/n, draw.c:64-65); strengths are stored /4 with
    DC += 0.5 (draw.c:69-71), then one unnormalised 2-D DCT-III
    (REDFT01, draw.c:74-76) on ``device``.  Returns the [H, W] grayscale
    canvas as float64 numpy.
    """
    from dspfun_tpu_torch.core.transforms import dct3_nd  # noqa: PLC0415

    p = precision or get_precision()
    w, h = size
    energy = sum(c[2] for c in coefs if c[2] is not None)
    nfree = sum(1 for c in coefs if c[2] is None)
    grid = np.zeros((h, w), dtype=np.float64)
    for x, y, strength in coefs:
        if strength is None:
            strength = (1 - energy) / nfree
        grid[y, x] = strength / 4.0
    grid[0, 0] += 0.5
    g = torch.tensor(grid, dtype=p.coeff_dtype, device=torch.device(device))
    out = dct3_nd(g[:, :, None], (0, 1), p)
    return out[..., 0].cpu().numpy().astype(np.float64)
