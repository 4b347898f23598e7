"""spec/ispec compute pipelines: invertible whole-image DCT spectrograms
(PyTorch port of ``dspfun_tpu/models/spec_pipeline.py``).

Re-derivations of the scalar chains in reference spec/spec.c:63-139 and
spec/ispec.c:84-167:

* forward DCT-II is FFTW REDFT10, coefficients in ±4wh (spec.c:64);
* DC = F[0,0]/(4wh) = image mean, exported per channel (spec.c:66-68);
* "uniform range": F * sqrt(2)^(#nonzero idx) / (4wh), putting every
  coefficient in ±1 (spec.c:70-78);
* gain: native = 127.5*sqrt(4wh), reference = 127.5*1024, custom
  (spec.c:81-90);
* range: one = gain, dc = max channel DC*gain, dcs = per-channel
  (spec.c:92-108);
* scale: log = copysign(log1p|f|, f)/log1p(max), linear = f/max
  (spec.c:110-122);
* sign: abs | shift ((f/2+.5)*254/255) | saturate (1 if f>=0, DC texel
  exempt) | retain (spec.c:124-139).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan, plan_axis, uniform_grid

__all__ = ["SpecChainParams", "spec_forward", "spec_inverse", "compute_gain",
           "signmap_restore"]


@dataclasses.dataclass(frozen=True)
class SpecChainParams:
    """The -t/-R/-T/-S/-G option tuple (reference spec/spec.h:56-79).

    Templates: abs=(log,abs,native,dc), shift=(log,shift,native,one),
    flat=(linear,shift,custom,one), sign=(linear,saturate,custom,one),
    copy=(linear,retain,custom,one) (spec.h:71-79).
    """

    scaletype: str = "log"      # log | linear
    signtype: str = "abs"       # abs | shift | saturate | retain
    gaintype: str = "native"    # native | reference | custom
    rangetype: str = "dc"       # one | dc | dcs
    gain: float = 1.0           # used when gaintype == custom

    @classmethod
    def template(cls, name: str, gain: float = 1.0) -> "SpecChainParams":
        t = {
            "abs": ("log", "abs", "native", "dc"),
            "shift": ("log", "shift", "native", "one"),
            "flat": ("linear", "shift", "custom", "one"),
            "sign": ("linear", "saturate", "custom", "one"),
            "copy": ("linear", "retain", "custom", "one"),
        }[name]
        return cls(*t, gain=gain)


def _whole_image_precision(precision: Precision | None, shape) -> Precision:
    """Whole-image transforms upgrade hilo -> exact at >=256 px: hilo
    bounds only the basis representation error, and per-pass rounding
    of long float32 contractions dominates there; the error-free digit
    contraction (core/exact.py) keeps the <=1e-5 target."""
    p = precision or get_precision()
    if p.intermediate == "hilo" and min(int(shape[0]), int(shape[1])) >= 256:
        p = dataclasses.replace(p, intermediate="exact")
    return p


def _whole_dct(x: torch.Tensor, kind: str, p: Precision) -> torch.Tensor:
    """Whole-image separable DCT over [H, W, C] on ``x``'s device, with
    the rank-1 DC-split hints (mean on forward, zero0 on inverse).  The
    i8 mode runs channel-first so both contractions take the
    transpose-free int8 kernel layouts."""
    h, w = x.shape[:2]
    split = "mean" if kind == "dct2" else "zero0"
    ph = plan_axis(h, kind, p, x.device)
    pw = plan_axis(w, kind, p, x.device)
    if p.intermediate == "i8" and x.ndim == 3:
        z = x.movedim(-1, 0)
        z = apply_plan(z, ph, 1, p, split=split)
        z = apply_plan(z, pw, 2, p, split=split)
        return z.movedim(0, -1)
    x = apply_plan(x, ph, 0, p, split=split)
    return apply_plan(x, pw, 1, p, split=split)


def compute_gain(params: SpecChainParams, w: int, h: int) -> float:
    """reference spec/spec.c:81-90."""
    if params.gaintype == "native":
        return 127.5 * math.sqrt(w * h * 4)
    if params.gaintype == "reference":
        return 127.5 * 1024.0
    return float(params.gain)


def _range_max(params: SpecChainParams, gain: float, dc_gained: torch.Tensor):
    """Per-channel scaling max (reference spec/spec.c:92-108);
    ``dc_gained`` is f[0,0,:] after gain (== DC * gain)."""
    if params.rangetype == "one":
        return torch.full_like(dc_gained, gain)
    if params.rangetype == "dc":
        return torch.max(dc_gained).expand_as(dc_gained)
    return dc_gained  # dcs


def _dc_texel(h: int, w: int, device) -> torch.Tensor:
    """[h, w, 1] boolean: True only at the DC texel."""
    m = torch.zeros((h, w, 1), dtype=torch.bool, device=device)
    m[0, 0, 0] = True
    return m


def spec_forward(
    x: torch.Tensor,
    params: SpecChainParams,
    precision: Precision | None = None,
):
    """Image [H, W, C] in [0,1] -> (spectrogram [H,W,C] in [0,1], DC [C]).

    DC is the per-channel image mean (what spec embeds as the "DC"
    property, reference spec/spec.c:66-68,145-148).
    """
    p = _whole_image_precision(precision, x.shape)
    h, w, d = x.shape
    gain = compute_gain(params, w, h)

    F = _whole_dct(x, "dct2", p)
    grid = uniform_grid((h, w))[:, :, None]
    # uniform range +-1, then gain (spec.c:70-90); constants folded in
    # float64 on the host before the one cast
    f = F * torch.tensor(grid * (gain / (4.0 * w * h)), dtype=F.dtype,
                         device=F.device)

    dc = true_div(f[0, 0, :], gain)  # == image mean
    maxv = _range_max(params, gain, f[0, 0, :])

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
        # the DC texel keeps its scaled value (spec.c:136: loop starts at d)
        f = torch.where(_dc_texel(h, w, f.device), f, sat)
    elif s != "retain":
        raise ValueError(params.signtype)
    return f, dc


def signmap_restore(f: torch.Tensor, signmap: torch.Tensor):
    """Sign restoration for ``abs`` spectrums from a ``spec -t sign`` map
    (reference ispec.c:87-98): bytes >= 128 mean positive, the DC texel
    keeps its own value, and the map's first texel carries DC.  Returns
    (signed f, dc)."""
    byte = torch.as_tensor(signmap, device=f.device) * 255.0
    dc = true_div(byte[0, 0, :], 255.0)
    not_dc = ~_dc_texel(f.shape[0], f.shape[1], f.device)
    f = torch.where(not_dc, torch.where(byte >= 128, torch.abs(f), -torch.abs(f)), f)
    return f, dc


def spec_inverse(
    f: torch.Tensor,
    params: SpecChainParams,
    dc: torch.Tensor | None = None,
    signmap: torch.Tensor | None = None,
    preserve_dc: bool = False,
    precision: Precision | None = None,
):
    """Spectrogram [H,W,C] -> image [H,W,C]; the inverse of
    :func:`spec_forward` (reference spec/ispec.c:84-167).

    ``dc`` is the decoded "DC" property (required for dc/dcs ranges or
    preserve_dc unless a signmap supplies it).  ``signmap`` is the pixel
    tensor of a ``spec -t sign`` image in [0,1]; its first texel
    provides DC and its sign bit restores coefficient signs.
    """
    p = _whole_image_precision(precision, f.shape)
    h, w, d = f.shape
    gain = compute_gain(params, w, h)

    s = params.signtype
    if s == "abs":
        if signmap is not None:
            f, dc = signmap_restore(f, signmap)
    elif s == "shift":
        f = (true_div(f * 255, 254) - 0.5) * 2
    elif s == "saturate":
        f = torch.where(~_dc_texel(h, w, f.device), f * 2 - 1, f)
    elif s != "retain":
        raise ValueError(params.signtype)

    if params.rangetype == "one":
        maxv = torch.full((d,), gain, dtype=f.dtype, device=f.device)
    else:
        if dc is None:
            raise ValueError("DC required for dc/dcs range types")
        dcg = torch.as_tensor(dc, dtype=f.dtype, device=f.device) * gain
        maxv = torch.max(dcg).expand(d) if params.rangetype == "dc" else dcg

    if params.scaletype == "log":
        fm = f * torch.log1p(maxv)
        f = torch.sign(f) * torch.expm1(torch.abs(fm))
    else:
        f = f * maxv

    f = true_div(f, gain)
    grid = uniform_grid((h, w))[:, :, None]
    f = f / torch.tensor(grid, dtype=f.dtype, device=f.device)

    if preserve_dc:
        if dc is None:
            raise ValueError("DC required for preserve_dc")
        f = f.clone()
        f[0, 0, :] = torch.as_tensor(dc, dtype=f.dtype, device=f.device)

    return _whole_dct(f, "dct3", p)
