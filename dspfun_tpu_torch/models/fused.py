"""Fused spectral pipelines: whole transform -> coefficient filter ->
inverse chains (PyTorch port of ``dspfun_tpu/models/fused.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan_nd, plan_axis, plan_matrix

__all__ = ["fused_filter_2d", "fused_filter_3d", "lowpass_mask",
           "filter_plans", "FilterPlans"]


class FilterPlans(NamedTuple):
    """Plans for a fused transform->filter->inverse chain.

    ``support`` holds per-axis kept-coefficient index tensors (int64, on
    the plans' device) when the filter mask's zero structure allowed
    pruning, else None per axis.  Pruned plans compute only the
    coefficients the mask can pass (the whole-chain generalisation of
    scan's pruned IDCT, reference scan/scan.c:20-41): the dropped terms
    would be multiplied by zero.
    """

    fwd: tuple
    inv: tuple
    support: tuple


def filter_plans(shape, precision: Precision | None = None,
                 mask: np.ndarray | None = None,
                 device: torch.device | str = "cuda") -> FilterPlans:
    """Forward and inverse AxisPlans, on ``device``, for an ND fused
    filter chain over the leading ``len(shape)`` axes.

    ``mask`` (host numpy, shaped like the coefficient grid over
    ``shape`` with optional trailing axes) enables support pruning:
    coefficient rows/columns that the mask zeroes on every slice are
    never computed.  The mask passed to the chain must have the same
    zero structure.
    """
    nd = len(shape)
    support: list[np.ndarray | None] = [None] * nd
    if mask is not None:
        m = np.asarray(mask)
        m = m.reshape(m.shape[:nd] + (-1,))  # collapse trailing axes
        nz = m.any(axis=-1)
        for ax, n in enumerate(shape):
            other = tuple(a for a in range(nd) if a != ax)
            keep = np.flatnonzero(nz.any(axis=other) if other else nz)
            if keep.size < n:
                support[ax] = keep
    fwd, inv = [], []
    for ax, n in enumerate(shape):
        keep = support[ax]
        if keep is None:
            fwd.append(plan_axis(n, "dct2", precision, device))
            inv.append(plan_axis(n, "dct3", precision, device))
        else:
            fwd.append(plan_matrix(basis_mod.dct2_matrix(n)[keep, :], precision, device))
            inv.append(plan_matrix(basis_mod.dct3_matrix(n)[:, keep], precision, device))
    sup = tuple(None if k is None else torch.tensor(k, device=device)
                for k in support)
    return FilterPlans(tuple(fwd), tuple(inv), sup)


def _unpack_plans(plans):
    """Accept both FilterPlans and a (fwd, inv) pair."""
    if isinstance(plans, FilterPlans) or len(plans) == 3:
        return plans[0], plans[1], plans[2]
    fwd, inv = plans
    return fwd, inv, (None,) * len(fwd)


def _compact_mask(mask: torch.Tensor, support) -> torch.Tensor:
    """Gather the mask down to the kept coefficient box (a no-op for
    dense plans)."""
    for ax, keep in enumerate(support):
        if keep is not None:
            mask = torch.index_select(mask, ax, keep.to(mask.device))
    return mask


def lowpass_mask(shape, cutoff: float = 0.25, boost: float = 1.0,
                 damp: float = 0.0) -> np.ndarray:
    """Brick-wall lowpass over an ND coefficient grid: ``boost`` inside
    the pass box [0, cutoff*n) on every axis, ``damp`` outside — the
    motion-style bandpass of reference motion/motion.c:683-719."""
    inside = np.ones(shape, dtype=bool)
    for ax, n in enumerate(shape):
        idx = [None] * len(shape)
        idx[ax] = slice(None)
        inside &= (np.arange(n) < max(1, int(n * cutoff)))[tuple(idx)]
    return np.where(inside, boost, damp)


def fused_filter_2d(
    x: torch.Tensor,
    mask: torch.Tensor,
    plans,
    precision: Precision | None = None,
) -> torch.Tensor:
    """IDCT(mask * DCT2(x)) / (4wh) over the leading two axes of [H, W, ...]
    (the bench configuration "fused 2D DCT+filter+IDCT").  ``plans``
    comes from :func:`filter_plans` on ``x``'s device."""
    p = precision or get_precision()
    h, w = x.shape[:2]
    fwd, inv, support = _unpack_plans(plans)
    if p.intermediate == "i8" and x.ndim == 3:
        # [C, H, W] layout: the i8 kernels contract the batched-middle and
        # the trailing axes directly, so the chain needs no transpose
        # between contractions (ops/int8mm.py)
        if mask.ndim not in (x.ndim - 1, x.ndim):
            raise ValueError(
                f"mask rank {mask.ndim} incompatible with input rank {x.ndim}")
        z = x.movedim(-1, 0)
        F = apply_plan_nd(z, fwd, (1, 2), p, split="mean")
        mc = _compact_mask(mask, support)
        if mc.ndim == x.ndim - 1:  # [H, W] mask: add the channel axis
            mc = mc[..., None]
        mc = mc.movedim(-1, 0)
        F = F * mc.to(F.dtype)
        y = apply_plan_nd(F, inv, (1, 2), p, split="zero0")
        return true_div(y.movedim(0, -1), 4.0 * w * h)
    # split hints engage the rank-1 DC split when p.tol is set (see
    # core/transforms.apply_plan); advisory otherwise
    F = apply_plan_nd(x, fwd, (0, 1), p, split="mean")
    F = F * _compact_mask(mask, support).to(F.dtype)
    y = apply_plan_nd(F, inv, (0, 1), p, split="zero0")
    return true_div(y, 4.0 * w * h)


def fused_filter_3d(
    cube: torch.Tensor,
    mask: torch.Tensor,
    plans,
    precision: Precision | None = None,
) -> torch.Tensor:
    """IDCT3(mask * DCT2_3d(cube)) / (8 t h w) over [T, H, W, ...] — the
    core of motion's frequency-space edit (motion/motion.c:641-753)."""
    p = precision or get_precision()
    t, h, w = cube.shape[:3]
    fwd, inv, support = _unpack_plans(plans)
    F = apply_plan_nd(cube, fwd, (0, 1, 2), p, split="mean")
    F = F * _compact_mask(mask, support).to(F.dtype)
    y = apply_plan_nd(F, inv, (0, 1, 2), p, split="zero0")
    return true_div(y, 8.0 * t * h * w)
