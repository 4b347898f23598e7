"""motion's whole-volume filter chain over the mesh's ranks (PyTorch port
of ``dspfun_tpu/parallel/motion_sharded.py``).

The reference's whole-clip mode (``-b WxHx0``, motion/README.md:65 "the
full dimensions of the input must fit into memory") runs one 3-D FFTW
transform over the entire clip.  Here the volume is sharded: frames over
``time`` and rows over ``space``; the separable 3-D DCT runs
Ulysses-style (see ``parallel/sharded.py``), and the full motion filter
chain (reference motion/motion.c:641-771) runs in the transformed layout
as elementwise work over global coefficient coordinates.

Chain parity notes against ``models.motion_pipeline.filter_blocks``:

* it requires block == scaled == the (truncated) source volume, so the
  active region covers the whole buffer, exactly the reference's
  whole-clip mode; the chain is filter_blocks' general chain, operation
  for operation (float64 windows cast once, divisions that round once);
* the top-N coefficient limit is computed globally with an exact
  distributed top-k: each shard contributes its local top-k candidates
  (any global winner is its shard's local winner), ordered by (value
  desc, z, y, x) with stable sorts; the candidates are all_gathered and
  the k-th of a (value desc, z, y, x) sort becomes the keep threshold;
* Floyd-Steinberg dithering gathers the rows over 'space' and diffuses
  whole local frames (each space member of a time shard repeats it) and
  keeps its own rows;
* the coded count travels as a [hi, lo] pair of base-2^15 int32 limbs,
  so a count past 2^31 survives the sum over the ranks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dspfun_tpu_torch.core.expr import TorchNamespace
from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan, plan_axis
from dspfun_tpu_torch.parallel.mesh import Mesh, Sharding, all_gather, all_to_all, psum

__all__ = [
    "volume_sharding",
    "volume_mesh_compatible",
    "motion_filter_volume_sharded",
    "coded_count",
]

_SQRT2 = math.sqrt(2.0)


def volume_sharding(mesh: Mesh) -> Sharding:
    """[T, H, W] pel-space layout: T over 'time', H over 'space'."""
    return Sharding(mesh, ("time", "space", None))


def volume_mesh_compatible(dims, mesh: Mesh) -> bool:
    """True when [T, H, W] = dims divides the mesh in both the pel layout
    (T%time, H%space) and the coefficient layout (H%time, W%space)."""
    t, h, w = dims
    nt, ns = mesh.shape["time"], mesh.shape["space"]
    return t % nt == 0 and h % ns == 0 and h % nt == 0 and w % ns == 0


def coded_count(c) -> int:
    """Combine the [hi, lo] limb pair the volume path returns."""
    hi, lo = (int(v) for v in np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c))
    return (hi << 15) + lo


def _renorm(zg, yg, xg, inverse: bool) -> torch.Tensor:
    """The uniform renorm factor 2*sqrt2 / ((x?1:sqrt2)(y?1:sqrt2)(z?1:sqrt2))
    (reference motion.c:643-647) in float64 over global coordinates, or
    its reciprocal: ``models/motion_pipeline._renorm_window``'s values."""
    f64 = torch.float64
    dev = xg.device
    one = torch.ones((), dtype=f64, device=dev)
    r2 = torch.full((), _SQRT2, dtype=f64, device=dev)
    ax = [torch.where(v > 0, one, r2) for v in (zg, yg, xg)]
    uf = torch.full((), 2.0 * _SQRT2, dtype=f64, device=dev) / (
        ax[2][None, None, :] * ax[1][None, :, None] * ax[0][:, None, None])
    return one / uf if inverse else uf


def motion_filter_volume_sharded(
    volume: torch.Tensor,         # [T/t, H/s, W] this rank's pels, 0..255
    mesh: Mesh,
    *,
    geom,                         # PlaneGeometry with block == scaled == truncated
    params,                       # MotionParams
    plane_index: int,
    nplanes: int,
    bz=0,
    precision: Precision | None = None,
):
    """Whole-clip single-block motion chain on this rank's shard.

    Stateful --eval forms are refused: they evaluate per coefficient in
    sequence on the host (reference motion.c:670-681), so no sharded
    evaluation order can match the reference.

    Returns (this rank's [T/t, H/s, W] output, the coded count as a
    [hi, lo] base-2^15 int32 limb pair on every rank: combine it with
    :func:`coded_count`).  Matches filter_blocks on a [1, T, H, W]
    batch elementwise (same plans, same chain order)."""
    g = geom
    p = params
    if p.expr is not None and p.expr.stateful:
        raise ValueError(
            "stateful av_expr forms (random/randomi/while/root/taylor/"
            "time) evaluate sequentially on the host and are not "
            "supported on the sharded path; run single-device")
    prec = precision or get_precision()
    nt, ns = mesh.shape["time"], mesh.shape["space"]
    t, h, w = volume.shape[0] * nt, volume.shape[1] * ns, volume.shape[2]
    if (g.block.d, g.block.h, g.block.w) != (t, h, w) or g.block != g.scaled:
        raise ValueError("volume path requires block == scaled == volume dims")
    if not volume_mesh_compatible((t, h, w), mesh):
        raise ValueError(f"volume {t}x{h}x{w} does not divide mesh {mesh.shape}")
    dev = volume.device
    plans = {f"{ax}{k[-1]}": plan_axis(n, k, prec, dev)
             for ax, n in (("t", t), ("h", h), ("w", w)) for k in ("dct2", "dct3")}
    svol = g.scaled.volume()
    scalefactor = svol / g.block.volume()     # == 1.0 here
    normalization = 1.0 / math.sqrt(svol * 8.0)
    norm2 = normalization * normalization

    def swap(x, axis, split, concat):
        return all_to_all(x, mesh, axis, split, concat)

    x = volume if torch.is_floating_point(volume) else volume.to(torch.float32)
    dtype = x.dtype
    # --- input decode (motion.c:618-638) ------------------------------
    if p.ispec == "shift":
        ic = 127.5 / math.log1p(svol * normalization * 255 * 8)
        tt = x - 127.5
        x = true_div(torch.sign(tt) * torch.expm1(torch.abs(true_div(tt, ic))), normalization)
    elif p.ispec == "flat":
        x = true_div((x - 127.5) * 2.0, norm2)
    elif p.ispec == "copy":
        x = true_div(x, norm2)
    elif p.linear:
        from dspfun_tpu_torch.io.color import srgb_decode  # noqa: PLC0415

        x = srgb_decode(true_div(x, 255.0), torch) * 255.0

    # --- forward 3-D DCT + uniform renorm (motion.c:641-647) ------------
    if not p.ispec:
        M = apply_plan(x, plans["w2"], 2, prec)
        M = swap(M, "space", 2, 1)                # -> [T/t, H, W/s]
        M = apply_plan(M, plans["h2"], 1, prec)
        M = swap(M, "time", 1, 0)                 # -> [T, H/t, W/s]
        M = apply_plan(M, plans["t2"], 0, prec)
    else:
        M = swap(swap(x, "space", 2, 1), "time", 1, 0)

    # global coefficient coordinates in the [T, H/t, W/s] layout
    lth, lws = M.shape[1], M.shape[2]
    zg = torch.arange(t, device=dev)
    yg = mesh.axis_index("time") * lth + torch.arange(lth, device=dev)
    xg = mesh.axis_index("space") * lws + torch.arange(lws, device=dev)
    z3, y3, x3 = zg[:, None, None], yg[None, :, None], xg[None, None, :]
    if not p.ispec:
        M = M * _renorm(zg, yg, xg, False).to(dtype)
    M = M.to(dtype)

    is_dc = (z3 == 0) & (y3 == 0) & (x3 == 0)
    zero = torch.zeros((), dtype=dtype, device=dev)
    dcstop = bool(g.bp_begin.d or g.bp_begin.h or g.bp_begin.w)
    keeps_dc = bool(p.preserve_dc) and bool(
        p.expr is not None or dcstop or p.boost != 1.0 or p.threshold_max)
    dc = None
    if p.spec == "abs" or (keeps_dc and p.preserve_dc == "dc"):
        # the DC coefficient, summed over the ranks only where the chain
        # reads it (as the JAX program keeps only the psums it uses)
        dc = psum(psum(torch.where(is_dc, M, zero).sum(), mesh, "space"), mesh, "time")

    # --- top-N coefficient limit (motion.c:652-668) ---------------------
    if p.coeff_limit:
        k = min(p.coeff_limit, t * h * w)
        a = torch.abs(M).reshape(-1)
        kl = min(k, a.shape[0])
        # flat order of the shard is (z, y, x) order: a stable descending
        # sort keeps the lowest coordinates first among equal magnitudes
        li = torch.sort(a, descending=True, stable=True).indices[:kl]
        shp = M.shape
        cz = torch.div(li, shp[1] * shp[2], rounding_mode="floor")
        cy = yg[torch.div(li, shp[2], rounding_mode="floor") % shp[1]]
        cx = xg[li % shp[2]]

        def gather(u):
            return all_gather(all_gather(u, mesh, "space"), mesh, "time")

        cv, cz, cy, cx = (gather(u) for u in (a[li], zg[cz], cy, cx))
        order = torch.argsort(cx, stable=True)
        for key in (cy, cz):
            order = order[torch.argsort(key[order], stable=True)]
        order = order[torch.argsort(cv[order], descending=True, stable=True)]
        kth = order[k - 1]
        vth, zth, yth, xth = cv[kth], cz[kth], cy[kth], cx[kth]
        aa = torch.abs(M)
        lex_le = (z3 < zth) | ((z3 == zth) & ((y3 < yth) | ((y3 == yth) & (x3 <= xth))))
        keep = (aa > vth) | ((aa == vth) & lex_le)
        M = torch.where(keep, M, zero)

    # --- expression (motion.c:670-681) ----------------------------------
    if p.expr is not None:
        env = {
            "c": M * (norm2 / 255.0),
            "x": x3.to(dtype), "y": y3.to(dtype), "z": z3.to(dtype),
            "i": torch.tensor(float(plane_index), dtype=dtype, device=dev),
            "width": float(g.block.w), "height": float(g.block.h),
            "depth": float(g.block.d), "components": float(nplanes),
            "bx": torch.zeros((), dtype=dtype, device=dev),
            "by": torch.zeros((), dtype=dtype, device=dev),
            "bz": torch.tensor(float(bz), dtype=dtype, device=dev),
            "bwidth": 1.0, "bheight": 1.0, "bdepth": 1.0,
        }
        xp = TorchNamespace(dev, dtype)
        res = xp.asarray(p.expr(env, xp)) * (255.0 / norm2)
        M = torch.broadcast_to(res.to(dtype), M.shape)

    # --- bandpass (motion.c:683-719) ------------------------------------
    from dspfun_tpu_torch.models.motion_pipeline import (  # noqa: PLC0415
        _bandpass_is_identity, bandpass_mult_grid,
    )

    if not _bandpass_is_identity(g, p.boost, p.damp):
        M = M * bandpass_mult_grid(z3, y3, x3, g, p.boost, p.damp).to(dtype)

    # --- threshold (motion.c:721-728) -----------------------------------
    if p.threshold_max:
        tmin = p.threshold_min * 255.0 / norm2
        tmax = p.threshold_max * 255.0 / norm2
        a = torch.abs(M)
        M = torch.where((a < tmin) | (a > tmax), zero, M)

    # --- preserve DC (motion.c:730-738) ---------------------------------
    if keeps_dc:
        if p.preserve_dc == "dc":
            M = torch.where(is_dc, dc.to(dtype), M)
        else:  # grey
            edge = p.damp if dcstop else p.boost
            M = torch.where(is_dc, M + (1.0 - edge) * 127.5 / (norm2 * scalefactor), M)

    # --- quantize (motion.c:740-744) ------------------------------------
    coded = torch.zeros((2,), dtype=torch.int32, device=dev)
    if p.quant:
        quantizer = p.quant * 8.0 * math.sqrt(svol)
        M = torch.round(true_div(M, quantizer)) * quantizer
        cnt = torch.sum(M != 0, dtype=torch.int64)
        limbs = torch.stack([cnt >> 15, cnt & 0x7FFF]).to(torch.int32)
        coded = psum(psum(limbs, mesh, "space"), mesh, "time")

    # --- inverse / spectrogram output (motion.c:746-771) ----------------
    if not p.spec:
        S = M * _renorm(zg, yg, xg, True).to(dtype)
        S = apply_plan(S, plans["t3"], 0, prec)
        S = swap(S, "time", 0, 1)                 # -> [T/t, H, W/s]
        S = apply_plan(S, plans["h3"], 1, prec)
        S = swap(S, "space", 1, 2)                # -> [T/t, H/s, W]
        S = apply_plan(S, plans["w3"], 2, prec)
    else:
        S = swap(swap(M, "time", 0, 1), "space", 1, 2)

    pel = S * (scalefactor * normalization)
    if p.spec == "abs":
        den = torch.log1p(torch.abs(dc * (scalefactor * normalization)))
        pel = torch.full((), 255.0, dtype=dtype, device=dev) / den * torch.log1p(torch.abs(pel))
    elif p.spec == "shift":
        cs = 127.5 / math.log1p(svol * normalization * 255 * 8)
        pel = cs * torch.sign(pel) * torch.log1p(torch.abs(pel)) + 127.5
    elif p.spec == "flat":
        pel = pel * normalization / 2.0 + 127.5
    else:  # copy or none
        pel = pel * normalization
        if p.spec is None and p.linear:
            from dspfun_tpu_torch.io.color import srgb_encode  # noqa: PLC0415

            pel = srgb_encode(true_div(pel, 255.0), torch) * 255.0

    if p.float_pixels or p.spec:
        out = pel
    elif p.dither:
        from dspfun_tpu_torch.models.motion_pipeline import _dither_blocks  # noqa: PLC0415

        full = all_gather(pel, mesh, "space", 1)
        lh = pel.shape[1]
        si = mesh.axis_index("space")
        out = _dither_blocks(full[None])[0][:, si * lh:(si + 1) * lh]
    else:
        out = torch.clamp(torch.floor(pel + 0.5), 0.0, 255.0)
    return out, coded
