"""Sharded whole-image spec/ispec: the huge-image scaling path (PyTorch
port of ``dspfun_tpu/parallel/spec_sharded.py``).

The spec tools transform the entire image in one 2-D DCT (reference
spec/spec.c:63); a wall-sized image on one device is bound by its
memory and its rate.  Here the image rows are sharded over the mesh's
'space' axis, the separable transform runs Ulysses-style (DCT the
locally complete W axis, all_to_all to make H local, DCT H), and the
spec scalar chain (reference spec.c:66-139) runs elementwise over global
coefficient coordinates; the DC and range maxima are summed over the
ranks (``psum``, in rank order).

Single-device parity: the same plans apply per shard, with the same
rank-1 split hints as ``models/spec_pipeline._whole_dct`` (``mean``
forward, ``zero0`` inverse), and the chain mirrors
``models/spec_pipeline``'s operation for operation.  An int8 plan splits
each column of a contraction by its own exponents, so a shard's columns
split as they do in the whole image.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan, plan_axis, plan_matrix
from dspfun_tpu_torch.models.spec_pipeline import (
    SpecChainParams, _range_max, _whole_image_precision, compute_gain,
)
from dspfun_tpu_torch.parallel.mesh import Mesh, Sharding, all_to_all, psum

__all__ = ["image_sharding", "spectrum_sharding",
           "spec_forward_sharded", "spec_inverse_sharded"]


def image_sharding(mesh: Mesh) -> Sharding:
    """[H, W, C] pel layout: rows over 'space'."""
    return Sharding(mesh, ("space", None, None))


def spectrum_sharding(mesh: Mesh) -> Sharding:
    """[H, W, C] coefficient layout: columns over 'space' (after the
    forward all_to_all)."""
    return Sharding(mesh, (None, "space", None))


def _padded_plan(n0: int, n: int, kind: str, p: Precision, device):
    """Plan for an axis zero-padded from n0 to n: extra basis COLUMNS are
    zero (padded inputs contribute nothing) and extra ROWS are zero
    (padded outputs are zero and sliced off), the algebra of the unpadded
    transform with every shard size dividing the mesh."""
    if n == n0:
        return plan_axis(n0, kind, p, device)
    m = basis_mod.dct2_matrix(n0) if kind == "dct2" else basis_mod.dct3_matrix(n0)
    return plan_matrix(np.pad(m, ((0, n - n0), (0, n - n0))), p, device)


def _uniform_cols(h: int, xg: torch.Tensor) -> torch.Tensor:
    """sqrt(2)^(#nonzero index) over [H, W/s] in float64 (the column
    factors from the global column indices ``xg``): the values of
    ``core/transforms.uniform_grid`` at this shard's coordinates."""
    f64 = torch.float64
    r2 = torch.full((), math.sqrt(2.0), dtype=f64, device=xg.device)
    one = torch.ones((), dtype=f64, device=xg.device)
    gy = torch.where(torch.arange(h, device=xg.device) > 0, r2, one)
    gx = torch.where(xg > 0, r2, one)
    # sqrt(2)**2 and sqrt(2)*sqrt(2) are the same double
    return gy[:, None] * gx[None, :]


def _cols(mesh: Mesh, lw: int, device) -> torch.Tensor:
    """This rank's global column indices in the spectrum layout."""
    return mesh.axis_index("space") * lw + torch.arange(lw, device=device)


def _dct(x: torch.Tensor, plans, mesh: Mesh, p: Precision, forward: bool):
    """The sharded separable DCT: forward [H/s, W, C] -> [H, W/s, C]
    (W, swap, H), inverse the mirror.  The i8 mode runs channel-first so
    both contractions take the transpose-free kernel layouts, as the
    single-device ``_whole_dct`` does."""
    plan_h, plan_w = plans
    split = "mean" if forward else "zero0"
    chan = p.intermediate == "i8"
    z = x.movedim(-1, 0) if chan else x
    ah, aw = (1, 2) if chan else (0, 1)
    if forward:
        z = apply_plan(z, plan_w, aw, p, split=split)
        z = all_to_all(z, mesh, "space", aw, ah)
        z = apply_plan(z, plan_h, ah, p, split=split)
    else:
        z = apply_plan(z, plan_h, ah, p, split=split)
        z = all_to_all(z, mesh, "space", ah, aw)
        z = apply_plan(z, plan_w, aw, p, split=split)
    return z.movedim(0, -1) if chan else z


def spec_forward_sharded(
    x: torch.Tensor,                 # [H/s, W, C] this rank's rows
    params: SpecChainParams,
    mesh: Mesh,
    precision: Precision | None = None,
    true_shape: tuple[int, int] | None = None,
):
    """Sharded spec_forward on this rank's rows.  Returns (this rank's
    columns of the spectrum [H, W/s, C], dc [C] on every rank).

    The image may be zero-padded up to the mesh (rows AND columns); pass
    the true image dims via ``true_shape``: the chain computes gain and
    normalisation from them and the padded region comes back as values
    to slice off (its basis rows and columns are zero)."""
    h = x.shape[0] * mesh.shape["space"]
    w, c = x.shape[1], x.shape[2]
    p = _whole_image_precision(precision, (h, w))
    h0, w0 = true_shape if true_shape is not None else (h, w)
    gain = compute_gain(params, w0, h0)
    dev = x.device
    plans = (_padded_plan(h0, h, "dct2", p, dev), _padded_plan(w0, w, "dct2", p, dev))

    F = _dct(x, plans, mesh, p, True)                      # [H, W/s, C]
    xg = _cols(mesh, F.shape[1], dev)
    f = F * (_uniform_cols(h, xg) * (gain / (4.0 * w0 * h0))).to(F.dtype)[:, :, None]

    origin = ((torch.arange(h, device=dev) == 0)[:, None] & (xg == 0)[None, :])[..., None]
    dc_gained = psum(torch.where(origin, f, torch.zeros((), dtype=f.dtype, device=dev))
                     .sum(dim=(0, 1)), mesh, "space")
    dc = true_div(dc_gained, gain)
    maxv = _range_max(params, gain, dc_gained)

    if params.scaletype == "log":
        f = torch.sign(f) * torch.log1p(torch.abs(f)) / torch.log1p(maxv)
    else:
        f = f / maxv

    s = params.signtype
    if s == "abs":
        f = torch.abs(f)
    elif s == "shift":
        f = true_div((f / 2 + 0.5) * 254, 255)
    elif s == "saturate":
        sat = (f >= 0).to(f.dtype)
        f = torch.where(origin, f, sat)  # the DC texel keeps its value
    elif s != "retain":
        raise ValueError(params.signtype)
    return f, dc


def spec_inverse_sharded(
    f: torch.Tensor,                 # [H, W/s, C] this rank's columns
    params: SpecChainParams,
    mesh: Mesh,
    dc=None,
    preserve_dc: bool = False,
    precision: Precision | None = None,
    true_shape: tuple[int, int] | None = None,
):
    """Sharded spec_inverse on this rank's columns (the signmap stays a
    whole-image pre-pass the caller applies before sharding,
    ``models/spec_pipeline.signmap_restore``).  Returns this rank's rows
    of the image [H/s, W, C]."""
    h, c = f.shape[0], f.shape[2]
    w = f.shape[1] * mesh.shape["space"]
    p = _whole_image_precision(precision, (h, w))
    h0, w0 = true_shape if true_shape is not None else (h, w)
    gain = compute_gain(params, w0, h0)
    dev = f.device
    plans = (_padded_plan(h0, h, "dct3", p, dev), _padded_plan(w0, w, "dct3", p, dev))

    xg = _cols(mesh, f.shape[1], dev)
    origin = ((torch.arange(h, device=dev) == 0)[:, None] & (xg == 0)[None, :])[..., None]
    s = params.signtype
    if s == "shift":
        f = (true_div(f * 255, 254) - 0.5) * 2
    elif s == "saturate":
        f = torch.where(origin, f, f * 2 - 1)
    elif s not in ("abs", "retain"):
        raise ValueError(params.signtype)

    if params.rangetype == "one":
        maxv = torch.full((c,), gain, dtype=f.dtype, device=dev)
    else:
        if dc is None:
            raise ValueError("DC required for dc/dcs range types")
        dcg = torch.as_tensor(dc, dtype=f.dtype, device=dev) * gain
        maxv = torch.max(dcg).expand(c) if params.rangetype == "dc" else dcg

    if params.scaletype == "log":
        fm = f * torch.log1p(maxv)
        f = torch.sign(f) * torch.expm1(torch.abs(fm))
    else:
        f = f * maxv

    f = true_div(f, gain)
    f = f / _uniform_cols(h, xg).to(f.dtype)[:, :, None]
    if preserve_dc:
        if dc is None:
            raise ValueError("DC required for preserve_dc")
        f = torch.where(origin, torch.as_tensor(dc, dtype=f.dtype, device=dev), f)
    return _dct(f, plans, mesh, p, False)
