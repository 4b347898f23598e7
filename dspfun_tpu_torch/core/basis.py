"""FFTW-convention DCT basis matrices, in float64 numpy.

Copies of ``dspfun_tpu/core/basis.py:dct2_matrix`` and ``dct3_matrix``:
the port cannot import the JAX package (its ``__init__`` imports JAX),
so the two builders it needs are copied and a test pins each copy
bit-equal to its original.

    REDFT10:  Y_k = 2 * sum_n x_n cos(pi (n+1/2) k / N)
    REDFT01:  Y_k = x_0 + 2 * sum_{n>=1} x_n cos(pi n (k+1/2) / N)
and REDFT01(REDFT10(x)) == 2N * x.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["dct2_matrix", "dct3_matrix"]

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
