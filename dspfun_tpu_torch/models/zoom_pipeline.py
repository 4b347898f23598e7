"""zoom compute: continuous DCT-basis interpolation at arbitrary
scale/offset (PyTorch port of ``dspfun_tpu/models/zoom_pipeline.py``).

The reference (zoom/zoom.c:361-375) evaluates the inverse DCT of a
whole-image DCT-II spectrum at arbitrary real coordinates, one output
column at a time with scalar loops.  Here the separable synthesis is
exactly two dense matrix contractions

    out[j, i, z] = sum_v Yb[j, v] * sum_u C[v, u, z] * Xb[i, u] / (w*h)

where Xb/Yb are the continuous DCT-III basis matrices for the frame's
scale and offset with an implicit 1/2 weight on the DC column
(zoom.c:364,369).  Two routes build them:

* the **planned** route (:func:`zoom_frame`): the host builds both in
  float64 (O(view * ncomponents) cosines), plans them in the precision
  policy's form (int8 digits under ``i8``) and caches the plans; the
  basis is exact and the error is the contraction's alone;
* the **device** route (:func:`zoom_frame_device`): the basis is
  computed on the device in float32 from a handful of scalars per frame,
  for animations; :func:`device_basis_accurate` says when that is
  accurate enough.

Both take ``mesh=`` (inside a rank of ``parallel/mesh.py``): the output
rows shard over the mesh's 'space' axis, the spectrum is whole on every
rank, and each rank synthesises its own rows (the planned route from its
rows of the Y plan, the device route from its own rows of the Y basis),
with no collective but the one that gathers the frame.  Any view height
works: rows pad up to the axis (the continuous basis extends past the
view) and the extra rows are dropped after the gather.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan_nd, dct2_nd, plan_matrix
from dspfun_tpu_torch.ops.int8mm import ceil_to
from dspfun_tpu_torch.utils.hostcopy import upload_scalars

__all__ = [
    "forward_spectrum",
    "padded_zoom_basis",
    "zoom_plan",
    "zoom_frame",
    "zoom_frame_device",
    "device_basis_accurate",
    "clamp_scale",
    "showsamples_coords",
    "overlay_showsamples",
    "default_view",
    "resolve_position",
]


def forward_spectrum(image, precision: Precision | None = None,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """Image [H,W,C] (numpy, or a tensor that stays where it is) ->
    unnormalised whole-image DCT-II spectrum on ``device``
    (reference zoom/zoom.c:263-266)."""
    p = precision or get_precision()
    if isinstance(image, torch.Tensor):
        x = image.to(p.coeff_dtype)
    else:
        x = torch.from_numpy(np.asarray(image)).to(p.coeff_dtype).to(device)
    return dct2_nd(x, (0, 1), p)


# minimum-logical-size clamp (reference zoom.c:277-284): one shared
# implementation, canonical in core/basis.py next to the basis it gates
clamp_scale = basis_mod.clamp_scale


def padded_zoom_basis(
    scaling_type: str,
    scale_num: float,
    scale_den: float,
    offset: float,
    nvectors: int,
    sampling_len: int,
) -> np.ndarray:
    """[nvectors, sampling_len] synthesis matrix: column 0 is the 1/2 DC
    weight, columns 1..ncomponents-1 the continuous DCT-III basis,
    higher columns zero (truncated when downscaling, zoom.c:41)."""
    basis, ncomp = basis_mod.zoom_scaled_basis(
        scaling_type, scale_num, scale_den, offset, nvectors, sampling_len
    )
    m = np.zeros((nvectors, sampling_len), dtype=np.float64)
    m[:, 0] = 0.5
    if ncomp > 1:
        m[:, 1:ncomp] = basis[:, : ncomp - 1]
    return m


def _encode(out: torch.Tensor, encode_trc: bool) -> torch.Tensor:
    if not encode_trc:
        return out
    from dspfun_tpu_torch.io.color import srgb_encode  # noqa: PLC0415

    return srgb_encode(out, torch)


def _synthesize(spectrum, plan_y, plan_x, precision=None,
                encode_trc: bool = False):
    """Planned separable synthesis: ``plan_y``/``plan_x`` are AxisPlans
    of the continuous basis matrices (host float64 -> digit split, so
    accuracy is set by the contraction mode alone: the deep 4-digit i8
    kernel truncates at ~2^-28 — the path that holds BASELINE.md's <=1e-5
    post-OETF budget on 4K stills).  ``split="zero0"`` peels the
    dominant DC row/column analytically: basis column 0 is exactly 0.5
    in every scaling convention (zoom/zoom.c:364,369)."""
    h, w = spectrum.shape[:2]
    p = precision or get_precision()
    if p.intermediate == "i8" and spectrum.ndim == 3:
        # [C, H, W] layout: both i8 contractions run transpose-free
        # (batched-left then right kernel form — ops/int8mm.py); the
        # frame goes back to [H, W, C] as a view, never a copy
        z = spectrum.movedim(-1, 0)
        t = apply_plan_nd(z, (plan_y, plan_x), (1, 2), p, split="zero0")
        out = t.movedim(0, -1)
    else:
        out = apply_plan_nd(spectrum, (plan_y, plan_x), (0, 1), p,
                            split="zero0")
    return _encode(true_div(out, h * w), encode_trc)


@functools.lru_cache(maxsize=4)
def _zoom_plan_cached(scaling_type, xnum, xden, ynum, yden, vx, vy,
                      vw, vh, w, h, precision, device):
    xb = padded_zoom_basis(scaling_type, *clamp_scale(w, xnum, xden),
                           vx, vw, w)
    yb = padded_zoom_basis(scaling_type, *clamp_scale(h, ynum, yden),
                           vy, vh, h)
    return (plan_matrix(yb, precision, device),
            plan_matrix(xb, precision, device))


def _device_key(device) -> str:
    """One name per device for the plan cache: ``"cuda"`` and the tensor's
    own ``cuda:0`` must not build the same plan twice."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def zoom_plan(
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    w: int,
    h: int,
    precision: Precision | None = None,
    device: torch.device | str = "cuda",
):
    """(plan_y, plan_x) AxisPlans on ``device`` of the host-float64
    continuous basis for a fixed (scale, offset, view) — the FFTW-plan
    analogue for zoom stills and constant-parameter animations.  One
    cache of four entries, keyed on every argument, the precision and
    the device: a still's basis is built and digit-split once, then
    every dispatch is two planned contractions."""
    p = precision or get_precision()
    return _zoom_plan_cached(scaling_type, float(xscale[0]), float(xscale[1]),
                             float(yscale[0]), float(yscale[1]),
                             float(vx), float(vy), int(vw), int(vh),
                             int(w), int(h), p, _device_key(device))


_SCALING_IDS = {"interpolated": 0, "centered": 1, "native": 2}


def device_basis_accurate(vw, vh, vx, vy, xscale, yscale, w, h,
                          scaling_type: str = "interpolated") -> bool:
    """True when the float32 device basis stays ~1e-6-class accurate:

    1. the cosine argument product (k+0.5)*j stays below ~2^21 on both
       axes (float32 loses whole units in the product at 4K+ sizes), and
    2. the per-vector index k itself is (near-)exactly representable in
       float32 — the int32 phase fold starts from the float32-rounded k,
       so an inexact k (centered mode's rational factor, fractional
       scales) floors the basis at ~pi*|f32(k)-k| regardless of the fold.

    The check is a direct host-side measurement of max |f32(k)-k| over
    the view's basis vectors (O(vw+vh) numpy).  "native" scaling has
    its own criteria (integer num/den for the int32 fold, see the
    branch below).  Callers falling outside use the host float64
    basis path (:func:`zoom_frame`)."""
    def kmax(n, off, num, den):
        num, den = clamp_scale(n, num, den)
        return (abs(off) + max(vw, vh)) * (den / num) + 1.0

    if scaling_type == "native":
        # native's period is n*num/den, generally fractional, so the
        # folded-mode product bound below does not apply: the direct
        # float32 phase kk*j/N carries error relative to the FULL phase
        # magnitude.  The device path is accurate only via the integer
        # fold (_device_basis): num/den integers, b*j*den exact in
        # int32, 2*n*num exact in float32, and the scalar offset term
        # (the only float32-rounded piece) within the 3e-6 criterion.
        def ok(n, off, num, den, nvec):
            num, den = clamp_scale(n, num, den)
            if num != round(num) or den != round(den) or num < 1 or den < 1:
                return False
            if nvec * max(n - 1, 1) * den >= 2.0**31:
                return False
            if 2.0 * n * num > 2.0**24:
                return False
            return math.pi * 2.0 * (abs(off) + 1.5) * den / num * 2.0**-24 <= 3e-6

        return ok(w, vx, *xscale, vw) and ok(h, vy, *yscale, vh)

    bx = kmax(w, vx, *xscale) * max(w - 1, 1)
    by = kmax(h, vy, *yscale) * max(h - 1, 1)
    if max(bx, by) > float(1 << 21):
        return False

    def k_err(n, off, num, den, nvec):
        num, den = clamp_scale(n, num, den)
        b = np.arange(nvec, dtype=np.float64)
        if scaling_type == "centered":
            denom = n * num - den
            if denom == 0:
                return np.inf
            k = (b + off) * (n - 1) * den / denom
        else:
            k = (b + off) * (den / num)
        return float(np.max(np.abs(k.astype(np.float32).astype(np.float64) - k)))

    err = max(k_err(w, vx, *xscale, vw), k_err(h, vy, *yscale, vh))
    return math.pi * err <= 3e-6


def _device_basis(scaling_id: int, num, den, offset, nvectors, sampling_len,
                  dtype, b0=None):
    """Basis matrix computed on the device from 0-d tensors ``num``,
    ``den`` and ``offset`` — the device counterpart of
    :func:`padded_zoom_basis` (an animation changes a few scalars per
    frame and uploads nothing else).  ``scaling_id`` is a host int, so
    only its own branch is computed.  Every division is tensor by tensor
    (a true division: dividing by a host scalar rounds twice on CUDA).
    ``b0`` offsets the output-vector indices as exact integers, keeping
    them out of the float32 offset scalar.  The accuracy contract is
    delegated to :func:`device_basis_accurate` — outside its bounds
    (int32 fold overflow, non-representable k) the result degrades
    silently; callers must gate."""
    l = sampling_len
    dev = num.device
    one = torch.ones((), dtype=dtype, device=dev)
    # clamp_scale (zoom.c:37-40, 277-284)
    too_small = l * num / den < 1.0
    num = torch.where(too_small, one, num)
    den = torch.where(too_small, float(l) * one, den)
    # C round() (half away from zero): torch.round is half-even and
    # would keep one fewer frequency at exact-x.5 logical sizes (matches
    # basis.zoom_scaled_basis's floor(x+0.5))
    ncomp = torch.minimum(float(l) * one, torch.floor(l * num / den + 0.5))
    b_idx = torch.arange(nvectors, dtype=torch.int32, device=dev)
    if b0 is not None:
        b_idx = b_idx + b0
    b_idx = b_idx[:, None]
    b = b_idx.to(dtype)
    j_idx = torch.arange(l, dtype=torch.int32, device=dev)[None, :]
    j = j_idx.to(dtype)
    if scaling_id == 2:
        # "native" has a fractional period N = l*num/den, so a static-2l
        # fold does not apply — but for INTEGER num/den the phase
        # k*j*den/(l*num) folds exactly: b*j*den mod 2*l*num in int32 (b
        # integer, offset rides the float32 term).  The direct form
        # covers fractional scales; its error grows with the phase
        # magnitude, so device_basis_accurate() gates it out.
        kk = b + offset + 0.5
        numi = torch.clamp_min(torch.round(num), 1.0).to(torch.int32)
        deni = torch.clamp_min(torch.round(den), 1.0).to(torch.int32)
        is_int = (num == numi.to(dtype)) & (den == deni.to(dtype))
        # torch.remainder takes the divisor's sign, like jnp.mod
        mi_nat = torch.remainder(b_idx * j_idx * deni, 2 * l * numi)
        fo = offset + 0.5
        ph_nat_fold = (mi_nat.to(dtype) + fo * j * deni.to(dtype)) \
            / torch.clamp_min(float(l) * num, 1.0)
        ph_direct = kk * j / (l * num / den)
        ph = torch.where(is_int, ph_nat_fold, ph_direct)
    else:
        if scaling_id == 0:
            k = (b + offset) * (den / num)
        else:
            k = (b + offset) * (l - 1) * den / (l * num - den)
        # cos(pi*(k+0.5)*j/l): the naive float32 phase loses ~1.6e-4
        # absolute once (k+0.5)*j grows past ~2^13.  Fold the integer
        # part of the phase EXACTLY in int32 — ki*j mod 2l is exact for
        # ki*j < 2^31 — so only the fractional product (magnitude <= j,
        # which then divides by l) carries float32 rounding.  The fold
        # starts from the float32-rounded k, so its benefit is bounded
        # by k's representability (device_basis_accurate measures it).
        kk = k + 0.5
        ki = torch.floor(kk)
        kf = kk - ki
        # ki is negative for a negative offset: remainder, never fmod
        mi = torch.remainder(ki.to(torch.int32) * j_idx, 2 * l)
        ph = (mi.to(dtype) + kf * j) / (float(l) * one)
    m = torch.cos(math.pi * torch.remainder(ph, 2.0))
    m = torch.where(j == 0, 0.5 * one, m)
    return torch.where(j < ncomp, m, torch.zeros((), dtype=dtype, device=dev))


def _synth(spectrum, yb, xb, encode_trc, precision):
    """Separable synthesis tail of the device route.

    When the precision policy is ``i8`` with a tolerance set, the two
    contractions run as int8 digit matmuls with both operands split on
    the device at run time (ops/int8mm.i8_contract_rt: 3 digits, ~2^-20
    relative, far below display precision); full float32 matmuls
    otherwise (the reference computes zoom in long double; TF32 stays
    off, core/precision.py).  Both work on [C, H, W] and hand the frame
    back as an [H, W, C] view."""
    h, w = spectrum.shape[:2]
    p = precision
    z = spectrum.movedim(-1, 0)            # [c, h, w]
    if (p.intermediate == "i8" and p.tol is not None
            and min(h, w) >= 256):
        from dspfun_tpu_torch.ops.int8mm import i8_contract_rt  # noqa: PLC0415

        # zero0-style DC peel (see core/transforms.apply_plan): the DC
        # row/column dominate the spectrum's dynamic range and both
        # basis matrices have an exactly-0.5 column 0, so the dominant
        # terms are plain broadcast adds and the int8 digits only carry
        # the balanced residual
        row0 = z[:, 0:1, :]
        z0 = z.clone()
        z0[:, 0, :] = 0.0
        t = i8_contract_rt(z0, yb, 1) + 0.5 * row0
        col0 = t[:, :, 0:1].clone()
        t[:, :, 0] = 0.0
        o = i8_contract_rt(t, xb, 2) + 0.5 * col0
    else:
        o = torch.matmul(torch.matmul(yb, z), xb.T)
    return _encode(true_div(o.movedim(0, -1), h * w), encode_trc)


def zoom_frame_device(
    spectrum: torch.Tensor,
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    encode_trc: bool = False,
    precision: Precision | None = None,
    mesh=None,
) -> torch.Tensor:
    """Fully device-side zoom frame on ``spectrum``'s device: the basis
    matrices are generated there from six scalars that go up in one
    queued copy (no host basis generation, no stall).  ``encode_trc``
    applies the sRGB OETF on the device (the -g output stage, reference
    zoom.c:396-399).  With ``mesh`` each rank builds its own rows of the
    Y basis, their start an exact integer (the basis is affine in the
    row index plus the offset, and integer starts stay out of the
    float32 offset scalar), and the frame is gathered over 'space'."""
    p = precision or get_precision()
    h, w = spectrum.shape[:2]
    dtype = spectrum.dtype
    s = upload_scalars((xscale[0], xscale[1], yscale[0], yscale[1], vx, vy),
                       spectrum.device, dtype)
    sid = _SCALING_IDS[scaling_type]
    xb = _device_basis(sid, s[0], s[1], s[4], vw, w, dtype)
    if mesh is None:
        yb = _device_basis(sid, s[2], s[3], s[5], vh, h, dtype)
        return _synth(spectrum, yb, xb, encode_trc, p)
    vhl = ceil_to(vh, mesh.shape["space"]) // mesh.shape["space"]
    yb = _device_basis(sid, s[2], s[3], s[5], vhl, h, dtype,
                       b0=mesh.axis_index("space") * vhl)
    return _gather_rows(_synth(spectrum, yb, xb, encode_trc, p), mesh, vh)


def _gather_rows(out: torch.Tensor, mesh, vh: int) -> torch.Tensor:
    """The whole [vh, vw, C] frame from every rank's rows."""
    from dspfun_tpu_torch.parallel.mesh import all_gather  # noqa: PLC0415

    return all_gather(out, mesh, "space", 0)[:vh]


def zoom_frame(
    spectrum: torch.Tensor,
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    precision: Precision | None = None,
    encode_trc: bool = False,
    plans=None,
    mesh=None,
) -> torch.Tensor:
    """One output frame [vh, vw, C] of the continuous zoom via the
    planned host-float64 basis (the accuracy path: basis exact, error =
    contraction mode only; ~2^-28 digit truncation in deep-i8 mode), on
    ``spectrum``'s device.  Plans cache, so repeated frames at fixed
    (scale, offset, view) — stills and constant animations — cost just
    two contractions per dispatch.  ``plans`` is :func:`zoom_plan`'s
    result for the same arguments, for a caller that already holds it
    (with ``mesh``: for the view height padded up to the 'space' axis).
    With ``mesh`` each rank contracts with its own rows of the Y plan and
    the frame is gathered over 'space'."""
    p = precision or get_precision()
    h, w = spectrum.shape[:2]
    vhp = vh if mesh is None else ceil_to(vh, mesh.shape["space"])
    plan_y, plan_x = plans or zoom_plan(scaling_type, xscale, yscale, vx, vy,
                                        vw, vhp, w, h, p, spectrum.device)
    if mesh is None:
        return _synthesize(spectrum, plan_y, plan_x, p, encode_trc)
    from dspfun_tpu_torch.parallel.mesh import plan_row_spec  # noqa: PLC0415

    out = _synthesize(spectrum, plan_row_spec(plan_y, mesh), plan_x, p, encode_trc)
    return _gather_rows(out, mesh, vh)


def showsamples_coords(start: float, scale: float, limit: int) -> list[int]:
    """Marked sample positions along one axis: the reference's
    ``for(size_t y = scale - (size_t)off % (int)scale; y < vh; y += scale)``
    loop truncates to integer every step (zoom/zoom.c:379-390)."""
    out = []
    y = int(scale) - int(start) % int(scale)
    while y < limit:
        out.append(y)
        y = int(y + scale)
    return out


def overlay_showsamples(
    frame: np.ndarray,
    mode: str,
    xscale: float,
    yscale: float,
    vx: float,
    vy: float,
) -> np.ndarray:
    """Mark integer input-lattice positions in green when upscaling
    (reference zoom.c:377-391; the reference's row indexing uses a
    vh stride — a bug for non-square views — corrected here)."""
    if not (xscale > 1 and yscale > 1) or mode == "none":
        return frame
    vh, vw = frame.shape[:2]
    green = np.array([0.0, 1.0, 0.0])
    ys = showsamples_coords(vy, yscale, vh)
    xs = showsamples_coords(vx, xscale, vw)
    if mode == "point":
        for y in ys:
            frame[y, xs] = green
    elif mode == "grid":
        frame[ys, :] = green
        frame[:, xs] = green
    return frame


def default_view(w: int, h: int, xscale, yscale) -> tuple[int, int]:
    """Default view = full scaled size (reference zoom.c:286-289)."""
    vw = int(w * xscale[0] / xscale[1])
    vh = int(h * yscale[0] / yscale[1])
    return vw, vh


def resolve_position(
    vx: float, vy: float, vw: int, vh: int, w: int, h: int,
    xscale, yscale, centered: bool, input_coords: bool, pct_coords: bool,
) -> tuple[float, float]:
    """-p / -c / -P / -%% position semantics (reference zoom.c:292-303;
    the -%% path uses float division here, where the reference
    truncates, and scales vy by vh rather than vy — both reference
    bugs)."""
    xs = xscale[0] / xscale[1]
    ys = yscale[0] / yscale[1]
    if pct_coords:
        return vx * vw / 100.0, vy * vh / 100.0
    if input_coords:
        return vx * xs, vy * ys
    if centered:
        return (w * xs - vw) / 2.0, (h * ys - vh) / 2.0
    return vx, vy
