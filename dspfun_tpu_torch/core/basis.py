"""Closed-form transform basis matrices, in float64 numpy.

Copies of ``dspfun_tpu/core/basis.py:dct2_matrix``, ``dct3_matrix``,
``clamp_scale``, ``zoom_scaled_basis`` and the 12 per-element basis
families of applybasis/genbasis (``BASIS_FAMILIES``, ``basis_fn``,
``basis_matrix``): the port cannot import the JAX package (its
``__init__`` imports JAX), so the functions it needs are copied and a
test pins each copy bit-equal to its original.

    REDFT10:  Y_k = 2 * sum_n x_n cos(pi (n+1/2) k / N)
    REDFT01:  Y_k = x_0 + 2 * sum_{n>=1} x_n cos(pi n (k+1/2) / N)
and REDFT01(REDFT10(x)) == 2N * x.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["dct2_matrix", "dct3_matrix", "clamp_scale", "scan_basis_matrix", "zoom_scaled_basis",
           "basis_fn", "basis_matrix", "BASIS_FAMILIES"]

_PI = math.pi
_SQRT2 = math.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """FFTW REDFT10 (DCT-II) matrix, M[k, j] = 2 cos(pi k (2j+1) / (2n)).

    Forward transform along an axis of length ``n`` is ``M @ x``.
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    m = 2.0 * np.cos(_PI * k * (2.0 * j + 1.0) / (2.0 * n))
    m.setflags(write=False)  # cached: in-place edits would corrupt it
    return m


@functools.lru_cache(maxsize=None)
def dct3_matrix(n: int) -> np.ndarray:
    """FFTW REDFT01 (DCT-III) matrix, M[k, j] = (j==0) ? 1 : 2 cos(pi j (2k+1) / (2n)).

    Satisfies dct3_matrix(n) @ dct2_matrix(n) == 2n * I.
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    m = 2.0 * np.cos(_PI * j * (2.0 * k + 1.0) / (2.0 * n))
    m[:, 0] = 1.0
    m.setflags(write=False)  # cached: in-place edits would corrupt it
    return m


def clamp_scale(n: int, num: float, den: float) -> tuple[float, float]:
    """Minimum logical size is one sample (reference zoom.c:37-40,
    277-284) — the single copy of the clamp rule (zoom_pipeline
    re-exports it)."""
    if n * num / den < 1:
        return 1.0, float(n)
    return num, den


def scan_basis_matrix(n: int) -> np.ndarray:
    """scan's pruned-IDCT basis (reference scan/scan.c:20-28).

    B[k, j] = 1 if j == 0 else 2 cos(pi j (k + 1/2) / n) — identical to
    :func:`dct3_matrix`; kept as an alias for parity with the reference.
    """
    return dct3_matrix(n)


def zoom_scaled_basis(
    scaling_type: str,
    scale_num: float,
    scale_den: float,
    offset: float,
    nvectors: int,
    sampling_len: int,
) -> tuple[np.ndarray, int]:
    """Continuous DCT-III basis at arbitrary real sample positions.

    Re-derivation of reference zoom/zoom.c:36-68 ``generate_scaled_basis``:
    for output sample b (0..nvectors-1) and frequency j (1..ncomponents-1)
        basis[b, j-1] = cos(pi (k_b + 1/2) j / N)
    where (k_b, N) depend on the boundary convention:
        native       : k = b + offset,                        N = L*num/den
        interpolated : k = (b + offset) * den/num,            N = L
        centered     : k = (b+offset)(L-1)den/(L*num - den),  N = L
    with L = sampling_len.  When downscaling, only
    ncomponents = min(L, round(L*num/den)) input frequencies participate
    (high frequencies are truncated, zoom.c:41).

    Returns ``(basis, ncomponents)`` with basis shape
    ``[nvectors, ncomponents-1]`` (the j=0 / DC column is handled by the
    caller with an implicit 1/2 weight, zoom.c:364,369).
    """
    scale_num, scale_den = clamp_scale(sampling_len, scale_num, scale_den)
    # C round(): half away from zero — Python's half-even round() kept
    # one fewer frequency when L*num/den lands exactly on x.5
    ncomponents = min(sampling_len,
                      math.floor(sampling_len * scale_num / scale_den + 0.5))
    b = np.arange(nvectors, dtype=np.float64)[:, None]
    j = np.arange(1, max(ncomponents, 1), dtype=np.float64)[None, :]
    if scaling_type == "native":
        k = b + offset
        big_n = sampling_len * scale_num / scale_den
    elif scaling_type == "interpolated":
        k = (b + offset) * scale_den / scale_num
        big_n = float(sampling_len)
    elif scaling_type == "centered":
        # scale exactly 1/L zeroes the denominator, but then
        # ncomponents == 1 and j is empty, so the basis is never
        # evaluated (the reference's n-loop doesn't run either) — the
        # placeholder only silences the 0-divide warning
        den0 = sampling_len * scale_num - scale_den
        k = (b + offset) * (sampling_len - 1) * scale_den / (den0 or 1.0)
        big_n = float(sampling_len)
    else:
        raise ValueError(f"unknown scaling type {scaling_type!r}")
    basis = np.cos(_PI * (k + 0.5) * j / big_n)
    return basis, int(ncomponents)


# ---------------------------------------------------------------------------
# applybasis/genbasis closed-form families (reference applybasis.c:77-140).
# k = frequency index, n = sample index, N = logical transform length.
# Each returns a complex128 array broadcast over k and n.
# ---------------------------------------------------------------------------


def _dft(k, n, N, ortho):
    return np.exp(-2j * _PI * k * n / N)


def _idft(k, n, N, ortho):
    return np.exp(2j * _PI * k * n / N)


def _dct1(k, n, N, ortho):
    # interior: cos(pi k n / (N-1)); boundary samples n==0 / n==N-1 get
    # 1/2 resp. (-1)^k / 2 (applybasis.c:83-88)
    interior = np.cos(_PI * (k * n) / (N - 1))
    last = np.power(-1.0, k) / 2.0
    first = 0.5
    c = np.where(n == 0, first, np.where(n == N - 1, last, interior))
    if ortho:
        c = c * _SQRT2
    return c.astype(np.complex128)


def _dct2(k, n, N, ortho):
    c = np.cos(_PI * (k * (2 * n + 1)) / (2 * N))
    if ortho:
        c = c * np.where(k != 0, _SQRT2, 1.0)
    return c.astype(np.complex128)


def _dct3(k, n, N, ortho):
    c = np.where(n != 0, np.cos(_PI * (n * (2 * k + 1)) / (2 * N)), 0.5)
    if ortho:
        c = c * np.where(n != 0, _SQRT2, 2.0)
    return c.astype(np.complex128)


def _dct4(k, n, N, ortho):
    c = np.cos(_PI * ((2 * k + 1) * (2 * n + 1)) / (4 * N))
    if ortho:
        c = c * _SQRT2
    return c.astype(np.complex128)


def _dst1(k, n, N, ortho):
    c = np.sin(_PI * ((k + 1) * (n + 1)) / (N + 1))
    if ortho:
        c = c * _SQRT2
    return c.astype(np.complex128)


def _dst2(k, n, N, ortho):
    c = np.sin(_PI * ((k + 1) * (2 * n + 1)) / (2 * N))
    if ortho:
        c = c * np.where(k != N - 1, _SQRT2, 1.0)
    return c.astype(np.complex128)


def _dst3(k, n, N, ortho):
    interior = np.sin(_PI * ((2 * k + 1) * (n + 1)) / (2 * N))
    last = np.power(-1.0, k) / 2.0
    c = np.where(n != N - 1, interior, last)
    if ortho:
        c = c * np.where(n != N - 1, _SQRT2, 2.0)
    return c.astype(np.complex128)


def _dst4(k, n, N, ortho):
    c = np.sin(_PI * ((2 * k + 1) * (2 * n + 1)) / (4 * N))
    if ortho:
        c = c * _SQRT2
    return c.astype(np.complex128)


def _wht(k, n, N, ortho):
    """Walsh-Hadamard, sequency (Walsh) order (applybasis.c:131-137).

    sign exponent = sum_i n_i * g_i(k) where g takes consecutive-bit
    sums of k (gray-code ordering of the natural-order Hadamard rows).
    """
    k = np.asarray(k, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    nbits = int(round(math.log2(int(N))))
    sig = (n & (k >> (nbits - 1))) & 1
    nn = n >> 1
    for m in range(nbits - 1, 0, -1):
        sig = sig + ((nn & ((k >> (m - 1)) + (k >> m))) & 1)
        nn = nn >> 1
    return np.power(-1.0, sig).astype(np.complex128)


def _dht(k, n, N, ortho):
    # Hartley cas kernel written as sqrt2 * cos(theta - pi/4) (applybasis.c:138-140)
    return (_SQRT2 * np.cos(2 * _PI * n * k / N - _PI / 4)).astype(np.complex128)


BASIS_FAMILIES = {
    "dft": _dft,
    "idft": _idft,
    "dct1": _dct1,
    "dct2": _dct2,
    "dct3": _dct3,
    "dct4": _dct4,
    "dst1": _dst1,
    "dst2": _dst2,
    "dst3": _dst3,
    "dst4": _dst4,
    "wht": _wht,
    "dht": _dht,
}


def basis_fn(name: str):
    """Look up a basis family by (case-insensitive) name.

    Matches the reference CLI parsing (applybasis.c:227-245): "dct"/"dst"
    without a digit mean variant 2; unknown digits fall back to 2.
    """
    key = name.lower()
    if key in BASIS_FAMILIES:
        return BASIS_FAMILIES[key]
    if key.startswith("dct") or key.startswith("dst"):
        head = key[:3]
        variant = key[3:4]
        if variant not in ("1", "3", "4"):
            variant = "2"
        return BASIS_FAMILIES[head + variant]
    raise ValueError(f"unknown basis family {name!r}")


def basis_matrix(name: str, K: int, N: int, *, length: int | None = None,
                 ortho: bool = False, offset: int = 0) -> np.ndarray:
    """Dense [K, N] complex basis matrix B[k, n] = f(k + offset, n, length).

    ``length`` defaults to N (the logical transform size used inside the
    kernel formulas — for genbasis this is always the --size dimension,
    genbasis.c:260).
    """
    f = basis_fn(name)
    L = N if length is None else length
    k = np.arange(K, dtype=np.int64)[:, None] + offset
    n = np.arange(N, dtype=np.int64)[None, :]
    return np.asarray(f(k, n, L, ortho), dtype=np.complex128)
