"""ND separable spectral transforms as matrix contractions (PyTorch port
of ``dspfun_tpu/core/transforms.py``).

A plan (:class:`AxisPlan`) is the FFTW-plan analogue: the basis matrix of
one 1-D transform, materialised once per (size, kind, precision, device)
in the form its precision mode contracts with — hi/lo float32 parts
(``hilo``), bfloat16 digit planes (``exact``), int8 digit planes with
row scales (``i8``) or the plain matrix (``f32``/``f64``).

Also provides dspfun's "uniform range" normalisation grids:
sqrt(2)^(#nonzero indices) per coefficient (reference
include/speclib.c:79-92, spec/spec.c:70-74, motion/motion.c:643-647).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision, get_precision

__all__ = [
    "apply_matrix",
    "dct2",
    "dct3",
    "dct2_nd",
    "dct3_nd",
    "uniform_grid",
    "split_hilo",
    "AxisPlan",
    "plan_axis",
    "plan_matrix",
    "apply_plan",
    "apply_plan_nd",
]


def split_hilo(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a float64 matrix into hi + lo float32 parts (double-float)."""
    hi = m.astype(np.float32)
    lo = (m - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


class AxisPlan(NamedTuple):
    """A planned 1-D transform: tensors on one device.

    ``hi`` is the matrix (float32, or float64 in f64 mode); ``lo`` the
    double-float compensation term (hilo only); ``digits``/``scale`` the
    digit split (bfloat16 planes and a scalar scale in exact mode, int8
    planes [D, M, Kp] and row scales [M, 1] in i8 mode); ``rowsum`` the
    hi/lo pair of per-row sums [2, M] used by the rank-1 ``mean`` split
    ([1, M] float64 in f64 mode).
    """

    hi: torch.Tensor
    lo: torch.Tensor | None
    digits: torch.Tensor | None = None
    scale: torch.Tensor | None = None
    rowsum: torch.Tensor | None = None


def _to(a, device) -> torch.Tensor | None:
    """A contiguous copy on ``device`` (never a view of a cached host
    array; the kernels take contiguous operands only)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True).contiguous()
    return torch.tensor(np.asarray(a, order="C"), device=device)


def plan_matrix(m: np.ndarray, precision: Precision | None = None,
                device: torch.device | str = "cuda") -> AxisPlan:
    """Build an AxisPlan on ``device`` from an arbitrary float64 matrix."""
    p = precision or get_precision()
    m = np.asarray(m, dtype=np.float64)
    rs64 = m.sum(axis=1)
    rs_hi = rs64.astype(np.float32)
    rowsum = np.stack([rs_hi, (rs64 - rs_hi.astype(np.float64)).astype(np.float32)])
    if p.intermediate == "f64":
        return AxisPlan(_to(m, device), None, rowsum=_to(rs64[None, :], device))
    digits = scale = lo = None
    if p.intermediate == "i8":
        from dspfun_tpu_torch.ops.int8mm import (  # noqa: PLC0415
            I8_DEEP_TOL, i8_feasible, split_matrix_i8,
        )

        # tight (or unset) budgets carry a 4th digit plane: the deep
        # 10-product kernel (~2^-28 truncation)
        ndig = 4 if p.tol is None or p.tol <= I8_DEEP_TOL else 3
        if i8_feasible(m.shape[0], m.shape[1], ndig):
            digits, scale = split_matrix_i8(m, ndig)
    if p.intermediate == "exact" or (p.intermediate == "i8" and digits is None):
        # past the int8 kernel's exact-int32 bound the bf16-digit exact
        # mode is the same accuracy class without that limit
        from dspfun_tpu_torch.core.exact import split_matrix_digits  # noqa: PLC0415

        digits, scale = split_matrix_digits(m, tol=p.tol)
    if p.intermediate == "hilo":
        hi, lo = split_hilo(m)
    else:
        hi = m.astype(np.float32)
    return AxisPlan(_to(hi, device), _to(lo, device), _to(digits, device),
                    _to(scale, device), _to(rowsum, device))


@functools.lru_cache(maxsize=128)
def _plan_axis_cached(n: int, kind: str, intermediate: str,
                      tol: float | None, device: str) -> AxisPlan:
    m = basis_mod.dct2_matrix(n) if kind == "dct2" else basis_mod.dct3_matrix(n)
    return plan_matrix(m, Precision(intermediate=intermediate, tol=tol), device)


def plan_axis(n: int, kind: str, precision: Precision | None = None,
              device: torch.device | str = "cuda") -> AxisPlan:
    """Cached plan for an FFTW-convention DCT along an axis of length n,
    keyed on (n, kind, intermediate, tol, device)."""
    p = precision or get_precision()
    if kind not in ("dct2", "dct3"):
        raise ValueError(kind)
    return _plan_axis_cached(int(n), kind, p.intermediate, p.tol,
                             str(torch.device(device)))


def _vec_along(vec: torch.Tensor, axis: int, ndim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def apply_plan(
    x: torch.Tensor,
    plan: AxisPlan,
    axis: int,
    precision: Precision | None = None,
    split: str | None = None,
) -> torch.Tensor:
    """Contract a planned [M, K] matrix against ``axis`` of ``x``.

    ``split`` names the rank-1 component that dominates the operand's
    dynamic range; it engages on i8 plans and, when ``precision.tol`` is
    set, on f32/hilo plans.  The dominant component is applied
    analytically and the bulk contraction sees a balanced residual:

    * ``"mean"`` (forward DCTs): ``M@x == M@(x-mu) + mu*rowsum(M)``;
      rowsum(DCT-II) is exactly [2N, 0, ...].
    * ``"zero0"`` (inverse DCTs): ``M@x == M@x_0zeroed + x_0*M[:,0]``;
      DCT-III column 0 is exactly ones.

    On i8 plans the balanced residual keeps each slice's digit scaling
    tight around the signal instead of the DC.  Float32 contractions run
    in full float32 (no TF32, see core/precision.py); the JAX package's
    3-pass bf16 and single-pass lo-term matmuls, TPU precision levels,
    have no counterpart here and run in full float32 too.
    """
    p = precision or get_precision()
    axis = axis % x.ndim

    def tdot(mat: torch.Tensor, operand: torch.Tensor) -> torch.Tensor:
        y = torch.tensordot(mat, operand, dims=([1], [axis]))
        return y.movedim(0, axis)

    def rank1_split(xf):
        """(residual, pivot, correction hi/lo vectors) — exact algebra
        for any pivot (see the docstring)."""
        if split == "mean":
            piv = torch.mean(xf, dim=axis, keepdim=True)
            resid = xf - piv
            vec_hi = _vec_along(plan.rowsum[0], axis, x.ndim)
            vec_lo = _vec_along(plan.rowsum[1], axis, x.ndim)
        else:
            piv = torch.narrow(xf, axis, 0, 1)
            k_idx = _vec_along(torch.arange(xf.shape[axis], device=xf.device),
                               axis, x.ndim)
            resid = torch.where(k_idx == 0, torch.zeros((), dtype=xf.dtype,
                                                        device=xf.device), xf)
            vec_hi = _vec_along(plan.hi[:, 0], axis, x.ndim)
            vec_lo = (_vec_along(plan.lo[:, 0], axis, x.ndim)
                      if plan.lo is not None else None)
        return resid, piv, vec_hi, vec_lo

    is_i8 = plan.digits is not None and plan.digits.dtype == torch.int8
    if is_i8 and x.shape[axis] < 256:
        # tiny contractions (blockwise DCTs) gain nothing from the digit
        # kernel; a float32 matmul on the matrix is exact enough there
        y = tdot(plan.hi, x.to(torch.float32))
    elif is_i8:
        from dspfun_tpu_torch.ops.int8mm import i8_contract  # noqa: PLC0415

        xf = x.to(torch.float32)
        if split in ("mean", "zero0"):
            resid, piv, vec_hi, vec_lo = rank1_split(xf)
            y = i8_contract(resid, plan.digits, plan.scale, axis)
            y = y + piv * vec_hi
            if vec_lo is not None:
                y = y + piv * vec_lo
        else:
            y = i8_contract(xf, plan.digits, plan.scale, axis)
    elif plan.digits is not None:
        from dspfun_tpu_torch.core.exact import exact_contract  # noqa: PLC0415

        y = exact_contract(x.to(torch.float32), plan.digits, plan.scale,
                           axis, tol=p.tol)
    elif p.intermediate == "f64":
        y = tdot(plan.hi, x.to(torch.float64))
    elif (split in ("mean", "zero0") and p.tol is not None
          and p.intermediate in ("f32", "hilo")):
        resid, piv, vec_hi, vec_lo = rank1_split(x.to(torch.float32))
        y = tdot(plan.hi, resid)
        if plan.lo is not None:
            y = y + tdot(plan.lo, resid)
        y = y + piv * vec_hi
        if vec_lo is not None:
            y = y + piv * vec_lo
    elif p.intermediate == "hilo" and plan.lo is not None:
        xf = x.to(torch.float32)
        y = tdot(plan.hi, xf) + tdot(plan.lo, xf)
    else:
        y = tdot(plan.hi, x.to(plan.hi.dtype))
    return y.to(p.coeff_dtype)


def apply_plan_nd(
    x: torch.Tensor,
    plans: Sequence[AxisPlan],
    axes: Sequence[int],
    precision: Precision | None = None,
    split: str | None = None,
) -> torch.Tensor:
    for plan, ax in zip(plans, axes):
        x = apply_plan(x, plan, ax, precision, split=split)
    return x


def apply_matrix(
    x: torch.Tensor,
    m: np.ndarray,
    axis: int,
    precision: Precision | None = None,
) -> torch.Tensor:
    """Contract float64 matrix ``m`` [M, K] against axis ``axis`` of ``x``
    (plans it on ``x``'s device first)."""
    return apply_plan(x, plan_matrix(m, precision, x.device), axis, precision)


def dct2(x: torch.Tensor, axis: int, precision: Precision | None = None) -> torch.Tensor:
    """FFTW REDFT10 along one axis (unnormalised)."""
    return apply_matrix(x, basis_mod.dct2_matrix(x.shape[axis]), axis, precision)


def dct3(x: torch.Tensor, axis: int, precision: Precision | None = None) -> torch.Tensor:
    """FFTW REDFT01 along one axis (unnormalised)."""
    return apply_matrix(x, basis_mod.dct3_matrix(x.shape[axis]), axis, precision)


def dct2_nd(
    x: torch.Tensor, axes: Sequence[int], precision: Precision | None = None
) -> torch.Tensor:
    """Separable FFTW DCT-II over several axes (e.g. 2-D whole-image
    transform, reference spec/spec.c:63)."""
    for ax in axes:
        x = dct2(x, ax, precision)
    return x


def dct3_nd(
    x: torch.Tensor, axes: Sequence[int], precision: Precision | None = None
) -> torch.Tensor:
    """Separable FFTW DCT-III over several axes.  dct3_nd(dct2_nd(x))
    == x * prod(2*N_axis)."""
    for ax in axes:
        x = dct3(x, ax, precision)
    return x


@functools.lru_cache(maxsize=None)
def _uniform_grid_np(shape: tuple[int, ...]) -> np.ndarray:
    """sqrt(2)^(#nonzero indices) over an ND index grid (float64):
    unnormalised FFTW DCT coefficients to dspfun's "uniform range"
    convention (reference include/speclib.h:44-51, speclib.c:79-92)."""
    g = np.zeros(shape, dtype=np.float64)
    for ax, n in enumerate(shape):
        idx = [None] * len(shape)
        idx[ax] = slice(None)
        g = g + (np.arange(n) != 0)[tuple(idx)]
    out = np.sqrt(2.0) ** g
    out.setflags(write=False)  # cached: in-place edits would corrupt it
    return out


def uniform_grid(shape: Sequence[int]) -> np.ndarray:
    """Uniform-range multiplier grid for the given transform dims."""
    return _uniform_grid_np(tuple(int(s) for s in shape))
