"""Correctly-rounded float32 contraction by error-free digit splitting
(PyTorch port of ``dspfun_tpu/core/exact.py``; plain PyTorch, no kernel).

1. Both operands are scaled by powers of two into (-1, 1];
2. each is split into B-bit integer digits ``a = sum_i m_i 2^{-B(i+1)}``
   with every split step error-free;
3. every digit-pair product ``M_i @ X_j`` is exact: products of B-bit
   integers fit float32, and float32 accumulation is exact because
   ``2B + log2(K) <= 24`` (B is chosen per contraction length K);
4. the partial products combine largest-first with TwoSum compensation,
   so the only rounding in the contraction is the final float32 store.

The matrix digits are held as bfloat16 (integers up to 256 are exact
there) and cast to float32 before the matmul: PyTorch returns bf16 @ bf16
as bfloat16, which would round the exact sums.  The result is bit-equal
to the JAX package's on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dspfun_tpu_torch.ops.int8mm import exp2i, split_operand_digits

__all__ = ["digit_width", "budget_bits", "split_matrix_digits", "exact_contract"]


def digit_width(k: int) -> int:
    """Largest digit width B with 2B + ceil(log2 k) <= 24 (exact float32
    accumulation over a K-length contraction), capped at bf16's 8
    mantissa bits."""
    k = max(int(k), 2)
    return max(1, min(8, (24 - math.ceil(math.log2(k))) // 2))


def budget_bits(tol: float | None, k: int) -> int | None:
    """Digit-tail depth (bits below each slice max) that keeps the
    contraction truncation under ``tol`` relative to the per-slice
    operand magnitudes: worst case K * 2^-bits accumulates over the
    contraction, and +4 absorbs a chain of four contractions.  ``None``
    keeps the full f64-class tail."""
    if tol is None:
        return None
    return max(8, math.ceil(-math.log2(tol)) + math.ceil(math.log2(max(k, 2))) + 4)


def split_matrix_digits(m: np.ndarray, pmax: int | None = None,
                        tol: float | None = None):
    """Split a float64 [M, K] matrix into integer digit slices.

    Returns (digits bfloat16 tensor [D, M, K] on the CPU, holding
    integers, float32 scale) with ``m ~= scale * sum_i digits[i] *
    2**(-B*(i+1))`` and error below ``scale * 2**(-B*D)``;
    B = digit_width(K).  ``tol`` bounds the digit count to
    ``budget_bits(tol)`` bits; the default carries the full f64 mantissa.
    """
    m = np.asarray(m, dtype=np.float64)
    B = digit_width(m.shape[1])
    mx = float(np.max(np.abs(m)))
    e = math.frexp(mx)[1] if mx > 0 else 0  # m = mant * 2^e, |mant| < 1
    scale = float(2.0**e)
    r = m / scale
    bits = budget_bits(tol, m.shape[1])
    nd = -(-(bits if bits is not None else 53) // B)
    if pmax is not None:
        nd = min(nd, pmax + 1)
    digits = []
    for i in range(nd):
        sc = 2.0 ** (B * (i + 1))
        d = np.round(r * sc)
        r = r - d / sc
        digits.append(d)
    # |digit| <= 2^B <= 256: exact in float32 and in bfloat16
    stacked = torch.from_numpy(np.stack(digits).astype(np.float32))
    return stacked.to(torch.bfloat16), np.float32(scale)


_X_BITS = 36  # digit depth below each slice max (> float32's 24: elements
#               much smaller than their slice max keep relative accuracy
#               through chained transforms)


def exact_contract(
    x: torch.Tensor,
    digits_a: torch.Tensor,    # [DA, M, K] from split_matrix_digits
    scale_a,                   # matrix power-of-two scale
    axis: int,
    tol: float | None = None,
) -> torch.Tensor:
    """Contract the digit-split [M, K] matrix against ``axis`` of ``x``
    with one float32 rounding.  Returns float32, shaped like ``x`` with
    ``axis`` replaced by M.  ``tol`` sizes the operand digit count and
    the digit-pair cutoff to ``budget_bits(tol)``."""
    axis = axis % x.ndim
    da, m, k = digits_a.shape
    B = digit_width(k)
    bits = budget_bits(tol, k)
    xd, ex = split_operand_digits(x.to(torch.float32), axis, B,
                                  -(-(bits if bits is not None else _X_BITS) // B),
                                  torch.float32)
    dx = len(xd)
    # one matmul forms every digit-pair product: [DA*M, K] @ [K, DX*rest]
    prod_all = torch.tensordot(
        digits_a.reshape(da * m, k).to(torch.float32), torch.stack(xd),
        dims=([1], [axis + 1]))  # [DA*M, DX, rest...]
    prod_all = prod_all.reshape((da, m) + tuple(prod_all.shape[1:]))
    # keep digit pairs down to 2^(-B*(pmax+2)) ~ 2^-tail relative
    tail = bits if bits is not None else 60
    pmax = max(0, -(-tail // B) - 2)
    pairs = sorted(
        ((i, j) for i in range(da) for j in range(dx) if i + j <= pmax),
        key=lambda ij: ij[0] + ij[1],
    )
    s = err = None
    for i, j in pairs:
        t = prod_all[i, :, j] * float(2.0 ** (-B * (i + j + 2)))
        if s is None:
            s, err = t, torch.zeros_like(t)
        else:
            # TwoSum: z + (s - (z - b)) + (t - b) == s + t exactly
            z = s + t
            b = z - s
            err = err + ((s - (z - b)) + (t - b))
            s = z
    # per-slice power-of-two scales: ex has size 1 at ``axis``; moved to
    # the front it broadcasts over the M output axis
    sa = torch.as_tensor(scale_a, dtype=torch.float32, device=x.device)
    y = (s + err) * (sa * exp2i(ex.movedim(axis, 0)))
    return y.movedim(0, axis)
