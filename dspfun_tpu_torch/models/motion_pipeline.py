"""motion compute: 3-D blockwise frequency-space video editing (PyTorch
port of ``dspfun_tpu/models/motion_pipeline.py``).

The reference (motion/motion.c:591-811) loops block by block per plane:
forward 3-D FFTW DCT in a strided max(block, scaled) buffer, a scalar
filter chain (uniform-range renorm, top-N coefficient limit, expression
eval, brick-wall bandpass, threshold, preserve-DC, quantize), inverse
DCT at the scaled dims, and pel mapping with optional Floyd-Steinberg
dithering.

Here all blocks of a slab are processed in one call per plane: the
block grid is a batch axis, the 3-D DCTs are six batched planned
contractions, and the filter chain is elementwise tensor work between
them.  Region effects (uniform renorm, bandpass, active windows) are
precomputed masks over the [md, mh, mw] buffer, matching the
reference's strided-buffer semantics (block resize by zero-pad or
truncate, motion.c:566, and top-N competition from coefficients beyond
the scaled dims).

When the chain is two linear maps around a pointwise middle, it takes
one of three fast paths (``LAST_FAST_PATH``):

* ``cuda-kron`` / ``plain-kron``: V <= 1024, the fused Kronecker block
  filter (ops/block_filter.py) — its CUDA kernel on a card, its plain
  version (the JAX package's ``xla-kron`` arithmetic) on the CPU;
* ``i8-kron``: V > 1024 with support-pruned int8 Kronecker plans from
  :func:`maybe_kron_plans`, two int8 digit contractions;
* ``sep``: V > 1024 otherwise, the separable planned contractions.

The geometry, parameter and mask helpers are numpy copies of the JAX
package's, pinned to them by tests/test_torch_motion.py.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import numpy as np
import torch

from dspfun_tpu_torch.core.expr import TorchNamespace
from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan_nd, plan_axis

__all__ = [
    "Dims",
    "PlaneGeometry",
    "MotionParams",
    "plan_geometry",
    "make_plans",
    "maybe_kron_plans",
    "filter_blocks",
    "bandpass_mult_grid",
    "frames_to_blocks",
    "blocks_to_frames",
    "SPECTYPES",
    "ISPECTYPES",
    "PRESERVE_DCTYPES",
]

SPECTYPES = ("abs", "shift", "flat", "copy")
ISPECTYPES = ("shift", "flat", "copy")
PRESERVE_DCTYPES = ("dc", "grey")

_SQRT2 = math.sqrt(2.0)

# the fast path the most recent filter_blocks call took ("cuda-kron",
# "plain-kron", "i8-kron", "sep"), or None after a general-chain call
LAST_FAST_PATH: str | None = None
# wall seconds the stateful --eval expressions have spent on the host
# (the grid's round trip included); the motion CLI reads and resets it
EXPR_HOST_SECONDS = 0.0

_KRON_V_MAX = 1024  # the fused Kronecker kernel's bound (ops/block_filter.py)


@dataclasses.dataclass(frozen=True)
class Dims:
    w: int = 0
    h: int = 0
    d: int = 0

    def volume(self) -> int:
        return self.w * self.h * self.d


def _propagate(c: Dims, base: Dims, sub_w: int, sub_h: int) -> Dims:
    """0 = inherit from plane 0 with chroma shift (reference
    motion.c:61-68: ceiling-shifted)."""
    w = c.w or -((-base.w) >> sub_w)
    h = c.h or -((-base.h) >> sub_h)
    d = c.d or base.d
    return Dims(w, h, d)


def _fill(src: Dims, dst: Dims) -> Dims:
    return Dims(dst.w or src.w, dst.h or src.h, dst.d or src.d)


def _limit(src: Dims, dst: Dims) -> Dims:
    return Dims(min(src.w, dst.w), min(src.h, dst.h), min(src.d, dst.d))


@dataclasses.dataclass(frozen=True)
class PlaneGeometry:
    """Per-plane block geometry (reference motion.c:369-433,487-511)."""

    source: Dims
    block: Dims
    scaled: Dims
    bp_begin: Dims
    bp_end: Dims
    nblocks: Dims
    truncated: Dims
    newres: Dims
    active: Dims
    minbuf: Dims


def plan_geometry(
    source_w: int,
    source_h: int,
    source_d: int,
    nplanes: int,
    log2_chroma_w: int = 0,
    log2_chroma_h: int = 0,
    block: Dims = Dims(0, 0, 1),
    scaled: Dims = Dims(),
    bp_begin: Dims = Dims(),
    bp_end: Dims = Dims(),
    samesize_chroma: bool = False,
) -> list[PlaneGeometry]:
    """Propagate block/scaled/bandpass boxes to every plane with
    0-inherit semantics (reference motion.c:369-433)."""
    subs = [(0, 0)] + [(log2_chroma_w, log2_chroma_h)] * min(2, nplanes - 1) \
        + [(0, 0)] * max(0, nplanes - 3)
    src0 = Dims(source_w, source_h, source_d)
    sources = [_propagate(Dims(), src0, sw, sh) if i else src0
               for i, (sw, sh) in enumerate(subs)]
    # samesize-chroma: when the block fits the chroma plane, clear the
    # chroma subsample factors (and default an unset block to the
    # chroma plane dims, as the reference does — motion.c:337-353)
    if samesize_chroma and nplanes >= 3:
        if block.w <= sources[1].w:
            subs[1] = (0, subs[1][1])
            subs[2] = (0, subs[2][1])
            if not block.w:
                block = dataclasses.replace(block, w=sources[1].w)
        if block.h <= sources[1].h:
            subs[1] = (subs[1][0], 0)
            subs[2] = (subs[2][0], 0)
            if not block.h:
                block = dataclasses.replace(block, h=sources[1].h)

    planes = []
    for i in range(nplanes):
        sw, sh = subs[i]
        src = sources[i] if i < len(sources) else src0
        blk = Dims(
            (-((-block.w) >> sw)) if block.w else 0,
            (-((-block.h) >> sh)) if block.h else 0,
            block.d,
        )
        scl = Dims(
            (-((-scaled.w) >> sw)) if scaled.w else 0,
            (-((-scaled.h) >> sh)) if scaled.h else 0,
            scaled.d,
        )
        bpb = Dims(
            (-((-bp_begin.w) >> sw)) if bp_begin.w else 0,
            (-((-bp_begin.h) >> sh)) if bp_begin.h else 0,
            bp_begin.d,
        )
        bpe = Dims(
            (-((-bp_end.w) >> sw)) if bp_end.w else 0,
            (-((-bp_end.h) >> sh)) if bp_end.h else 0,
            bp_end.d,
        )
        blk = _limit(src, _fill(src, blk))
        scl = _fill(blk, scl)
        bpe = _limit(blk, _fill(blk, bpe))
        bpb = _limit(blk, bpb)
        nb = Dims(src.w // blk.w, src.h // blk.h, src.d // blk.d)
        trunc = Dims(nb.w * blk.w, nb.h * blk.h, nb.d * blk.d)
        newres = Dims(nb.w * scl.w, nb.h * scl.h, nb.d * scl.d)
        active = Dims(min(blk.w, scl.w), min(blk.h, scl.h), min(blk.d, scl.d))
        minbuf = Dims(max(blk.w, scl.w), max(blk.h, scl.h), max(blk.d, scl.d))
        planes.append(PlaneGeometry(src, blk, scl, bpb, bpe, nb, trunc,
                                    newres, active, minbuf))
    return planes


@dataclasses.dataclass(frozen=True)
class MotionParams:
    """The filter-chain parameter set (reference motion.c:170-287);
    ``expr`` is the parsed ``--eval`` expression (core/expr.py)."""

    spec: str | None = None          # abs | shift | flat | copy
    ispec: str | None = None         # shift | flat | copy
    preserve_dc: str | None = None   # dc | grey
    boost: float = 1.0
    damp: float = 0.0
    quant: float = 0.0
    threshold_min: float = 0.0
    threshold_max: float = 0.0
    coeff_limit: int = 0
    expr: object | None = None
    dither: bool = False
    linear: bool = False
    float_pixels: bool = True

    def _key(self):
        return (self.spec, self.ispec, self.preserve_dc, self.boost,
                self.damp, self.quant, self.threshold_min,
                self.threshold_max, self.coeff_limit,
                getattr(self.expr, "source", self.expr),
                self.dither, self.linear, self.float_pixels)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        # never via hash(): colliding-but-different params (boost=-1.0
        # vs -2.0 hash alike in CPython) must not share cached plans
        return isinstance(other, MotionParams) and self._key() == other._key()


def _uniform_factor(md, mh, mw) -> np.ndarray:
    """2*sqrt2 / ((x?1:sqrt2)(y?1:sqrt2)(z?1:sqrt2)) per coefficient
    (reference motion.c:643-647)."""
    z = np.where(np.arange(md) > 0, 1.0, _SQRT2)[:, None, None]
    y = np.where(np.arange(mh) > 0, 1.0, _SQRT2)[None, :, None]
    x = np.where(np.arange(mw) > 0, 1.0, _SQRT2)[None, None, :]
    return 2.0 * _SQRT2 / (x * y * z)


def _bandpass_mult(g: PlaneGeometry, boost: float, damp: float) -> np.ndarray:
    """Multiplier array from the reference's six sequential face loops
    plus the boost box (motion.c:683-719): the product of the six face
    multipliers, so overlapping faces (begin > end on an axis) damp
    twice, as in the reference.  The boost loop is not clipped to the
    active dims (motion.c:715-719); the damp faces are."""
    z = np.arange(g.minbuf.d)[:, None, None]
    y = np.arange(g.minbuf.h)[None, :, None]
    x = np.arange(g.minbuf.w)[None, None, :]
    ad, ah, aw = g.active.d, g.active.h, g.active.w
    bb, be = g.bp_begin, g.bp_end
    act2 = (y < ah) & (x < aw)
    mid_z = (z >= bb.d) & (z < be.d)
    mid_y = (y >= bb.h) & (y < be.h)
    faces = [
        (z < bb.d) & act2,                                   # front
        (z >= be.d) & (z < ad) & act2,                       # back
        mid_z & (y < bb.h) & (x < aw),                       # top
        mid_z & (y >= be.h) & (y < ah) & (x < aw),           # bottom
        mid_z & mid_y & (x < bb.w),                          # left
        mid_z & mid_y & (x >= be.w) & (x < aw),              # right
    ]
    mult = np.ones((g.minbuf.d, g.minbuf.h, g.minbuf.w))
    for f in faces:
        mult = mult * np.where(f, damp, 1.0)
    inside = mid_z & mid_y & (x >= bb.w) & (x < be.w)
    return mult * np.where(inside, boost, 1.0)


def bandpass_mult_grid(z, y, x, g: PlaneGeometry, boost: float, damp: float) -> torch.Tensor:
    """:func:`_bandpass_mult` as float64 torch ops over broadcastable
    coordinate tensors, on their device: the same values bit for bit
    (the face products in the same order, each one IEEE multiply), at
    any coordinates (the sharded volume path's global ones)."""
    f64 = torch.float64
    dev = x.device
    one = torch.ones((), dtype=f64, device=dev)
    dmp = torch.full((), damp, dtype=f64, device=dev)
    bst = torch.full((), boost, dtype=f64, device=dev)
    ad, ah, aw = g.active.d, g.active.h, g.active.w
    bb, be = g.bp_begin, g.bp_end
    act2 = (y < ah) & (x < aw)
    mid_z = (z >= bb.d) & (z < be.d)
    mid_y = (y >= bb.h) & (y < be.h)
    faces = [
        (z < bb.d) & act2,                                   # front
        (z >= be.d) & (z < ad) & act2,                       # back
        mid_z & (y < bb.h) & (x < aw),                       # top
        mid_z & (y >= be.h) & (y < ah) & (x < aw),           # bottom
        mid_z & mid_y & (x < bb.w),                          # left
        mid_z & mid_y & (x >= be.w) & (x < aw),              # right
    ]
    mult = torch.ones(torch.broadcast_shapes(z.shape, y.shape, x.shape), dtype=f64, device=dev)
    for f in faces:
        mult = mult * torch.where(f, dmp, one)
    inside = mid_z & mid_y & (x >= bb.w) & (x < be.w)
    return mult * torch.where(inside, bst, one)


def _bandpass_is_identity(g: PlaneGeometry, boost: float, damp: float) -> bool:
    """True when :func:`_bandpass_mult` is 1 everywhere: the boost is 1 and
    no damp face holds a coefficient (the default box, whole-block), so
    the multiply can be skipped without changing a bit."""
    bb, be = g.bp_begin, g.bp_end
    faces_empty = (not (bb.d or bb.h or bb.w) and be.d >= g.active.d
                   and be.h >= g.active.h and be.w >= g.active.w)
    return boost == 1.0 and (damp == 1.0 or faces_empty)


def _fast_eligible(g: PlaneGeometry, p: MotionParams) -> bool:
    """The fused fast-path gate: two linear maps around a pointwise
    middle (no codecs/expr/top-N/DC/dither/quant/linear, no block
    resize)."""
    return (p.expr is None and p.spec is None and p.ispec is None
            and not p.coeff_limit and not p.preserve_dc and not p.dither
            and not p.quant and not p.linear
            and g.block == g.scaled == g.minbuf)


def maybe_kron_plans(g: PlaneGeometry, params: MotionParams,
                     max_support_frac: float = 0.25,
                     allow_cpu: bool = False,
                     device: torch.device | str = "cuda"):
    """Support-pruned Kronecker-folded int8 plans on ``device`` for the
    fused fast path, or None when they cannot win.

    When the bandpass multiplier zeroes most coefficients (damp == 0
    lowpass/bandpass edits), only the pass-band rows of the folded
    [V, V] DCT matter: K2' is [S, V] and K3' [V, S] with S = |support|,
    exact algebra (the dropped rows are multiplied by zero).  The two
    contractions run the int8 digit kernels.  On the CPU they run the
    kernels' plain version, so plans are built there only with
    ``allow_cpu``.

    Unlike the JAX package, whose int8 tiles must fit the TPU's VMEM,
    the CUDA kernel bounds only K (``ops/int8mm.i8_feasible``), so large
    blocks (24^3) get plans here where the JAX planner returns None.
    """
    return _maybe_kron_cached(g, params, float(max_support_frac), bool(allow_cpu),
                              str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _maybe_kron_cached(g, params, max_support_frac, allow_cpu, device):
    from dspfun_tpu_torch.core.transforms import plan_matrix  # noqa: PLC0415
    from dspfun_tpu_torch.ops.blockdct import kron_dct_rows  # noqa: PLC0415
    from dspfun_tpu_torch.ops.int8mm import i8_feasible  # noqa: PLC0415

    p = params
    vol = g.minbuf.volume()
    if not _fast_eligible(g, p) or vol <= _KRON_V_MAX:
        return None
    # both folded contractions must fit the int8 kernel's exact-int32
    # bound ([S, V] contracts K=V, [V, S] contracts K=S; S <= V); test
    # K=V before anything is built: a whole clip never fits, and
    # otherwise plan_matrix would fall back to bf16 digits, which the
    # i8-kron branch cannot consume
    if not i8_feasible(1, vol):
        return None
    if not allow_cpu and torch.device(device).type == "cpu":
        return None
    dims3 = (g.block.d, g.block.h, g.block.w)
    uf, bpm = _fast_multipliers(g, p, device)
    support = torch.nonzero(bpm.reshape(-1) != 0.0).reshape(-1).cpu().numpy()
    if support.size > vol * max_support_frac:
        return None
    if not (i8_feasible(support.size, vol) and i8_feasible(vol, support.size)):
        return None
    prec = Precision(coeff="float32", intermediate="i8", tol=1e-5)
    # only the support rows (columns) of the [V, V] kron matrices: the
    # same entries as slicing the full matrix, without building it
    uf = uf.reshape(-1)[torch.as_tensor(support, device=uf.device)].cpu().numpy()
    bpm = bpm.reshape(-1)[torch.as_tensor(support, device=bpm.device)].cpu().numpy()
    k2 = kron_dct_rows(dims3, "dct2", support) * (uf * bpm)[:, None]
    k3 = (kron_dct_rows(dims3, "dct3", support, columns=True) / (8.0 * vol)) \
        * (1.0 / uf)[None, :]
    p2, p3 = plan_matrix(k2, prec, device), plan_matrix(k3, prec, device)
    if p2.digits.dtype != torch.int8 or p3.digits.dtype != torch.int8:
        raise AssertionError("i8-kron plans must carry int8 digits")  # the probe guards this
    return p2, p3


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` rounded once (PyTorch's scalar / tensor multiplies by
    the reciprocal)."""
    return torch.full((), c, dtype=t.dtype, device=t.device) / t


def _renorm_window(md, mh, mw, active: Dims, inverse: bool, device) -> torch.Tensor:
    """The uniform renorm factor ``uf`` of :func:`_uniform_factor` (``1.0 /
    uf`` when ``inverse``) inside the ``active`` box of the [md, mh, mw]
    buffer and 1.0 outside it, in float64, built on ``device`` from the
    three axes with the numpy form's float64 operations (each division
    rounds once): its values equal the JAX package's
    ``np.where(_region_mask(...), uf, 1.0)`` bit for bit, and no [md, mh,
    mw] array is made or copied on the host."""
    f64 = torch.float64
    ax = [torch.where(torch.arange(n, device=device) > 0,
                      torch.ones((), dtype=f64, device=device),
                      torch.full((), _SQRT2, dtype=f64, device=device)) for n in (md, mh, mw)]
    uf = torch.full((), 2.0 * _SQRT2, dtype=f64, device=device) / (
        ax[2][None, None, :] * ax[1][None, :, None] * ax[0][:, None, None])
    if inverse:
        uf = torch.ones((), dtype=f64, device=device) / uf
    inside = torch.zeros((md, mh, mw), dtype=torch.bool, device=device)
    inside[: active.d, : active.h, : active.w] = True
    return torch.where(inside, uf, torch.ones((), dtype=f64, device=device))


def _fast_multipliers(g: PlaneGeometry, p: MotionParams, device):
    """(``uf``, ``bpm``): :func:`_uniform_factor` of the block and
    :func:`_bandpass_mult` of ``g`` as [d, h, w] float64 tensors built on
    ``device`` from the three axes, bit-equal to the numpy forms (the fast
    path has block == minbuf == scaled, so the renorm window is ``uf``
    everywhere)."""
    md, mh, mw = g.minbuf.d, g.minbuf.h, g.minbuf.w
    uf = _renorm_window(md, mh, mw, g.minbuf, False, device)
    ax = [torch.arange(n, device=device) for n in (md, mh, mw)]
    bpm = bandpass_mult_grid(ax[0][:, None, None], ax[1][None, :, None], ax[2][None, None, :],
                             g, p.boost, p.damp)
    return uf, bpm


def _const(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def filter_blocks(
    blocks: torch.Tensor,       # [NB, bd, bh, bw] pel values in 0..255
    plans,                      # ((fwd_d, fwd_h, fwd_w), (inv_d, inv_h, inv_w)[, kron])
    block_coords,               # (bx[NB], by[NB]): the --eval environment
    bz,                         # block-depth index (scalar or [NB]): ditto
    geom: PlaneGeometry,
    params: MotionParams,
    plane_index: int,
    nplanes: int,
):
    """The full per-plane chain over all blocks of a slab, on ``blocks``'
    device (plans must lie there too).

    ``block_coords`` (bx[NB], by[NB]) and ``bz`` are the ``--eval``
    environment's block indices; ``block_coords=None`` numbers the blocks
    in raster order within each slab of the batch.

    Returns (out_blocks [NB, sd, sh, sw] pel 0..255, coded [NB] int32
    per-block coded-coefficient counts).
    """
    global LAST_FAST_PATH, EXPR_HOST_SECONDS
    g = geom
    p = params
    if not torch.is_floating_point(blocks):
        # integer container pels upload in their native dtype (4x less
        # host-to-device traffic for u8 sources); the cast runs on device
        blocks = blocks.to(torch.float32)
    dev = blocks.device
    nb = blocks.shape[0]
    md, mh, mw = g.minbuf.d, g.minbuf.h, g.minbuf.w
    sd, sh, sw = g.scaled.d, g.scaled.h, g.scaled.w
    dtype = blocks.dtype

    svol = g.scaled.volume()
    scalefactor = svol / g.block.volume()
    normalization = 1.0 / math.sqrt(svol * 8.0)
    norm2 = normalization * normalization

    vol = g.minbuf.volume()
    kron_plans = plans[2] if len(plans) >= 3 else None
    if _fast_eligible(g, p):
        dims3 = (g.block.d, g.block.h, g.block.w)
        tmin = p.threshold_min * 255.0 / norm2 if p.threshold_max else 0.0
        tmax = p.threshold_max * 255.0 / norm2 if p.threshold_max else 0.0
        flat = blocks.reshape(nb, -1)
        if vol <= _KRON_V_MAX:
            from dspfun_tpu_torch.ops.block_filter import fused_block_filter  # noqa: PLC0415

            LAST_FAST_PATH = "plain-kron" if dev.type == "cpu" else "cuda-kron"
            uf = _uniform_factor(*dims3).reshape(-1)
            bpm = _bandpass_mult(g, p.boost, p.damp).reshape(-1)
            out = fused_block_filter(flat, dims3, uf * bpm, threshold=(tmin, tmax),
                                     post_filter=1.0 / uf)
        elif kron_plans is not None:
            from dspfun_tpu_torch.ops.int8mm import i8_contract  # noqa: PLC0415

            LAST_FAST_PATH = "i8-kron"
            kp2, kp3 = kron_plans
            F = i8_contract(flat.to(torch.float32), kp2.digits, kp2.scale, 1)
            if p.threshold_max:
                a = torch.abs(F)
                F = torch.where((a < tmin) | (a > tmax), torch.zeros_like(F), F)
            out = i8_contract(F, kp3.digits, kp3.scale, 1)
        else:
            LAST_FAST_PATH = "sep"
            # the float64 constants are built on the device from the three
            # axes (a whole clip's would take seconds on one host core)
            uf, bpm = _fast_multipliers(g, p, dev)
            F = apply_plan_nd(blocks.to(torch.float32), plans[0], (1, 2, 3))
            F = F * (uf * bpm).to(torch.float32)
            if p.threshold_max:
                a = torch.abs(F)
                F = torch.where((a < tmin) | (a > tmax), torch.zeros_like(F), F)
            F = F * true_div(_rdiv(1.0, uf), 8.0 * vol).to(torch.float32)
            out = apply_plan_nd(F, plans[1], (1, 2, 3)).reshape(nb, -1)
        pel = out.reshape(nb, sd, sh, sw).to(dtype)
        zero_coded = torch.zeros((nb,), dtype=torch.int32, device=dev)
        if p.float_pixels:
            return pel, zero_coded
        return torch.clamp(torch.floor(pel + 0.5), 0.0, 255.0), zero_coded

    LAST_FAST_PATH = None
    fwd_plans, inv_plans = plans[0], plans[1]

    # --- input decode (motion.c:618-638) -------------------------------
    x = blocks
    if p.ispec == "shift":
        ic = 127.5 / math.log1p(svol * normalization * 255 * 8)
        t = x - 127.5
        x = true_div(torch.sign(t) * torch.expm1(torch.abs(true_div(t, ic))),
                     normalization)
    elif p.ispec == "flat":
        x = true_div((x - 127.5) * 2.0, norm2)
    elif p.ispec == "copy":
        x = true_div(x, norm2)
    elif p.linear:
        from dspfun_tpu_torch.io.color import srgb_decode  # noqa: PLC0415

        x = srgb_decode(true_div(x, 255.0), torch) * 255.0

    # --- forward transform + uniform renorm (motion.c:641-647) ---------
    if not p.ispec:
        x = apply_plan_nd(x, fwd_plans, (1, 2, 3))
        win = _renorm_window(md, mh, mw, g.active, False, dev)
        x = x * win[: x.shape[1], : x.shape[2], : x.shape[3]].to(dtype)

    # embed into the minbuf-sized buffer (zero-pad / work at full size)
    M = torch.zeros((nb, md, mh, mw), dtype=dtype, device=dev)
    M[:, : x.shape[1], : x.shape[2], : x.shape[3]] = x.to(dtype)

    dc = M[:, 0, 0, 0].clone()
    act = torch.zeros((md, mh, mw), dtype=torch.bool, device=dev)
    act[: g.active.d, : g.active.h, : g.active.w] = True

    # --- top-N coefficient limit (motion.c:652-668) --------------------
    if p.coeff_limit:
        k = min(p.coeff_limit, md * mh * mw)
        mag = torch.abs(M).reshape(nb, -1)
        # a stable descending sort keeps the lowest index first among
        # equal magnitudes, as lax.top_k does
        idx = torch.sort(mag, dim=1, descending=True, stable=True).indices[:, :k]
        keep = torch.zeros_like(mag, dtype=torch.bool)
        keep.scatter_(1, idx, True)
        M = torch.where(keep.reshape(M.shape), M, torch.zeros_like(M))

    # --- expression (motion.c:670-681) ---------------------------------
    if p.expr is not None:
        if block_coords is None:
            bidx = torch.arange(nb, device=dev) % (g.nblocks.w * g.nblocks.h)
            block_coords = (bidx % g.nblocks.w, bidx // g.nblocks.w)
        bxs, bys = (torch.as_tensor(b, device=dev).to(dtype) for b in block_coords)
        bzt = torch.as_tensor(0 if bz is None else bz, device=dev).to(dtype)
        grid = [torch.arange(n, dtype=dtype, device=dev) for n in (md, mh, mw)]
        # the coordinate grids stay unexpanded: every element takes the
        # value it takes on the [md, mh, mw] grid the JAX package builds
        env = {
            "c": M * (norm2 / 255.0),
            "x": grid[2][None, None, :],
            "y": grid[1][None, :, None],
            "z": grid[0][:, None, None],
            "i": torch.tensor(float(plane_index), dtype=dtype, device=dev),
            "width": float(g.block.w), "height": float(g.block.h),
            "depth": float(g.block.d), "components": float(nplanes),
            "bx": bxs[:, None, None, None],
            "by": bys[:, None, None, None],
            # scalar for the streaming slab loop; [NB] when slabs batch
            "bz": bzt[:, None, None, None] if bzt.ndim else bzt,
            "bwidth": float(g.nblocks.w), "bheight": float(g.nblocks.h),
            "bdepth": float(g.nblocks.d),
        }
        xp = TorchNamespace(dev, dtype)
        t0 = time.perf_counter()
        # a stateful expression takes the grid to the host in float64 and
        # evaluates it per coefficient in raster order, slots and
        # generators persisting in the parsed Expr (the reference's host
        # loop; the JAX package's ordered io_callback)
        res = xp.asarray(p.expr(env, xp)) * (255.0 / norm2)
        if p.expr.stateful:
            EXPR_HOST_SECONDS += time.perf_counter() - t0
        M = torch.where(act[None], res.to(dtype), M)

    # --- bandpass (motion.c:683-719) -----------------------------------
    if not _bandpass_is_identity(g, p.boost, p.damp):
        # built on the device from its three axes (a whole clip's
        # float64 multiplier on the host took seconds)
        ax = [torch.arange(n, device=dev) for n in (md, mh, mw)]
        M = M * bandpass_mult_grid(ax[0][:, None, None], ax[1][None, :, None],
                                   ax[2][None, None, :], g, p.boost, p.damp).to(dtype)

    # --- threshold (motion.c:721-728) ----------------------------------
    if p.threshold_max:
        tmin = p.threshold_min * 255.0 / norm2
        tmax = p.threshold_max * 255.0 / norm2
        a = torch.abs(M)
        M = torch.where(act[None] & ((a < tmin) | (a > tmax)), torch.zeros_like(M), M)

    # --- preserve DC (motion.c:730-738) --------------------------------
    if p.preserve_dc:
        dcstop = bool(g.bp_begin.d or g.bp_begin.h or g.bp_begin.w)
        if p.expr is not None or dcstop or p.boost != 1.0 or p.threshold_max:
            M = M.clone()
            if p.preserve_dc == "dc":
                M[:, 0, 0, 0] = dc
            else:  # grey
                edge = p.damp if dcstop else p.boost
                M[:, 0, 0, 0] += (1.0 - edge) * 127.5 / (norm2 * scalefactor)

    # --- quantize (motion.c:740-744) -----------------------------------
    coded = torch.zeros((nb,), dtype=torch.int32, device=dev)
    if p.quant:
        quantizer = p.quant * 8.0 * math.sqrt(svol)
        Mq = torch.round(true_div(M, quantizer)) * quantizer
        M = torch.where(act[None], Mq, M)
        coded = torch.sum((M != 0) & act[None], dim=(1, 2, 3), dtype=torch.int32)

    # --- inverse / spectrogram output (motion.c:746-771) ---------------
    if not p.spec:
        M = M * _renorm_window(md, mh, mw, g.active, True, dev).to(dtype)
        S = apply_plan_nd(M[:, :sd, :sh, :sw], inv_plans, (1, 2, 3))
    else:
        S = M[:, :sd, :sh, :sw]

    pel = S * (scalefactor * normalization)
    if p.spec == "abs":
        cval = _rdiv(255.0, torch.log1p(torch.abs(dc * (scalefactor * normalization))))
        pel = cval[:, None, None, None] * torch.log1p(torch.abs(pel))
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

    # --- output quantisation + dithering (motion.c:772-787) ------------
    if p.float_pixels or p.spec:
        out = pel
    elif p.dither:
        out = _dither_blocks(pel)
    else:
        # C lround after the 0/255 clamp (motion.c:776); pel >= 0 after
        # the clamp, so floor(x + 0.5) == lround
        out = torch.clamp(torch.floor(pel + 0.5), 0.0, 255.0)
    return out, coded


def _dither_blocks(pel: torch.Tensor) -> torch.Tensor:
    """2-D Floyd-Steinberg over each (block, z) slice (reference
    motion.c:778-787), in pel units.

    The JAX package's ``lax.scan`` over rows and columns written out:
    a Python loop over the h*w pels of a slice, each step one batch of
    elementwise ops over all (block, z) slices.  Serial per pel,
    parallel across slices; for 16x16 blocks that is 256 steps of a
    few small kernels each (no dedicated kernel yet, see ROADMAP).
    """
    nb, d, h, w = pel.shape
    sl = pel.reshape(nb * d, h, w)
    n = sl.shape[0]
    out = torch.empty_like(sl)
    err_next = torch.zeros((n, w), dtype=pel.dtype, device=pel.device)
    for r in range(h):
        row = sl[:, r] + err_next
        next_row = torch.zeros((n, w + 2), dtype=pel.dtype, device=pel.device)
        err_right = torch.zeros((n,), dtype=pel.dtype, device=pel.device)
        for c in range(w):
            v = row[:, c] + err_right
            # C lround after the 0/255 clamp (motion.c:776)
            q = torch.clamp(torch.floor(v + 0.5), 0.0, 255.0)
            dp = v - q
            next_row[:, c] += dp * 3 / 16
            next_row[:, c + 1] += dp * 5 / 16
            next_row[:, c + 2] += dp * 1 / 16
            err_right = dp * 7 / 16
            out[:, r, c] = q
        err_next = next_row[:, 1: w + 1]
    return out.reshape(nb, d, h, w)


def _permute(a, axes):
    return a.permute(*axes) if isinstance(a, torch.Tensor) else a.transpose(axes)


def frames_to_blocks(frames, g: PlaneGeometry):
    """[bd, H, W] plane frames (numpy or tensor) -> [nbh*nbw, bd, bh, bw]
    blocks (truncating ragged edges, reference motion.c:597-608)."""
    bd, bh, bw = g.block.d, g.block.h, g.block.w
    nbh, nbw = g.nblocks.h, g.nblocks.w
    a = frames[:bd, : nbh * bh, : nbw * bw]
    a = _permute(a.reshape(bd, nbh, bh, nbw, bw), (1, 3, 0, 2, 4))
    return a.reshape(nbh * nbw, bd, bh, bw)


def blocks_to_frames(blocks, g: PlaneGeometry):
    """[nbh*nbw, sd, sh, sw] (numpy or tensor) -> [sd, nbh*sh, nbw*sw]."""
    sd, sh, sw = g.scaled.d, g.scaled.h, g.scaled.w
    nbh, nbw = g.nblocks.h, g.nblocks.w
    a = _permute(blocks.reshape(nbh, nbw, sd, sh, sw), (2, 0, 3, 1, 4))
    return a.reshape(sd, nbh * sh, nbw * sw)


def make_plans(g: PlaneGeometry, precision: Precision | None = None,
               device: torch.device | str = "cuda"):
    """(forward, inverse) axis plans on ``device``: forward DCT-II at
    block dims, inverse DCT-III at scaled dims (reference
    motion.c:518-552)."""
    p = precision or get_precision()
    fwd = tuple(plan_axis(n, "dct2", p, device) for n in (g.block.d, g.block.h, g.block.w))
    inv = tuple(plan_axis(n, "dct3", p, device)
                for n in (g.scaled.d, g.scaled.h, g.scaled.w))
    return fwd, inv
