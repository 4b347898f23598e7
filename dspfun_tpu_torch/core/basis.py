"""FFTW-convention DCT basis matrices, in float64 numpy.

Copies of ``dspfun_tpu/core/basis.py:dct2_matrix``, ``dct3_matrix``,
``clamp_scale`` and ``zoom_scaled_basis``: the port cannot import the JAX
package (its ``__init__`` imports JAX), so the functions it needs are
copied and a test pins each copy bit-equal to its original.

    REDFT10:  Y_k = 2 * sum_n x_n cos(pi (n+1/2) k / N)
    REDFT01:  Y_k = x_0 + 2 * sum_{n>=1} x_n cos(pi n (k+1/2) / N)
and REDFT01(REDFT10(x)) == 2N * x.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["dct2_matrix", "dct3_matrix", "clamp_scale", "zoom_scaled_basis"]

_PI = math.pi


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
