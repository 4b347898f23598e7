"""Spectrogram scaling library ("speclib").

Re-derivation of reference include/speclib.{h,c}: an invertible pair of
scale (linear | log) x sign (abs | shift | saturate) mappings used to
render DCT coefficients into displayable [0,1] pixel values and back,
plus the option-string parser and presets shared by the spec-like
features of every tool.

The transfer functions (reference speclib.c:105-131):
    scale log      c -> copysign(log1p|c|, c)         (speclib.c:108-110)
    unscale (exp)  c -> copysign(expm1|c|, c)         (speclib.c:111-113)
    sign shift     c -> (c/2 + 1/2) * 254/255         (speclib.c:114-116)
    sign unshift   c -> (c * 255/254 - 1/2) * 2       (speclib.c:117-119)
    sign abs       c -> |c|                           (speclib.c:120-122)
    sign saturate  c -> 1 if c >= 0 else 0            (speclib.c:126-128)
    sign center    c -> c*2 - 1                       (speclib.c:129-131)

A scaler folds a gain and a pre-scaled max (speclib.c:133-166):
    scale(c)   = sign(scale(c * gain) / max)          (speclib.c:172-174)
    unscale(c) = unscale(unsign(c) * max) / gain      (speclib.c:176-178)
with max = scale(gain * max_input).

Presets (speclib.c:17-21): abs=(log,abs), shift=(log,shift),
flat=(linear,shift), signmap=(linear,saturate).

Copy of ``dspfun_tpu/ops/speclib.py`` with numpy as the default array
module ``xp`` (the original defaults to ``jax.numpy``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "SpecParams",
    "SpecScaler",
    "PRESETS",
    "parse_spec_params",
    "spec_normalization",
    "spec_copysign",
]

SCALE_TYPES = ("linear", "log")
SIGN_TYPES = ("abs", "shift", "saturate")

PRESETS = {
    "abs": ("log", "abs"),
    "shift": ("log", "shift"),
    "flat": ("linear", "shift"),
    "signmap": ("linear", "saturate"),
}


@dataclasses.dataclass
class SpecParams:
    scaletype: str = "log"
    signtype: str = "abs"


def parse_spec_params(
    options: str,
    key_val_sep: str = "=",
    pairs_sep: str = ":",
    params: SpecParams | None = None,
) -> SpecParams:
    """Parse a "k=v:k=v" spec option string (reference speclib.c:41-77).

    Keys: ``scale``, ``sign``, ``preset`` (a preset may also be given as
    a bare key).  Raises ValueError at the first invalid field.
    """
    p = params or SpecParams()
    for pair in options.split(pairs_sep):
        if not pair:
            continue
        if key_val_sep in pair:
            key, val = pair.split(key_val_sep, 1)
        else:
            key, val = pair, ""
        if key == "scale":
            if val not in SCALE_TYPES:
                raise ValueError(f"invalid scale type {val!r}")
            p.scaletype = val
        elif key == "sign":
            if val not in SIGN_TYPES:
                raise ValueError(f"invalid sign type {val!r}")
            p.signtype = val
        else:
            name = val if key == "preset" else key
            if name not in PRESETS:
                raise ValueError(f"invalid spec option {pair!r}")
            p.scaletype, p.signtype = PRESETS[name]
    return p


def spec_normalization(n_nonzero: int) -> float:
    """sqrt(2)^n — uniform-range factor for a coefficient with
    ``n_nonzero`` nonzero indices (reference speclib.c:79-92)."""
    return math.sqrt(2.0) ** n_nonzero


def spec_copysign(c, sign, xp=np):
    """Apply the sign recovered from a signtype_saturate spectrogram:
    positive where sign != 0, negative where sign == 0
    (reference speclib.c:94-96)."""
    return xp.where(sign != 0, xp.abs(c), -xp.abs(c))


def _scale_log(c, xp):
    return xp.where(c < 0, -xp.log1p(xp.abs(c)), xp.log1p(xp.abs(c)))


def _scale_exp(c, xp):
    return xp.where(c < 0, -xp.expm1(xp.abs(c)), xp.expm1(xp.abs(c)))


@dataclasses.dataclass
class SpecScaler:
    """Invertible coefficient <-> pixel scaler (reference speclib.c:133-178)."""

    params: SpecParams
    max_input: float
    gain: float

    @property
    def max(self) -> float:
        m = self.gain * self.max_input
        if self.params.scaletype == "log":
            return math.log1p(abs(m)) * (1 if m >= 0 else -1)
        return m

    def scale(self, c, xp=np):
        m = self.max
        c = c * self.gain
        if self.params.scaletype == "log":
            c = _scale_log(c, xp)
        c = c / m
        s = self.params.signtype
        if s == "abs":
            return xp.abs(c)
        if s == "shift":
            return (c / 2 + 0.5) * 254 / 255
        if s == "saturate":
            return xp.where(c >= 0, 1.0, 0.0).astype(c.dtype) if hasattr(c, "dtype") else (1.0 if c >= 0 else 0.0)
        raise ValueError(self.params.signtype)

    def unscale(self, c, xp=np):
        s = self.params.signtype
        if s == "abs":
            pass  # unsign is identity; caller may spec_copysign first
        elif s == "shift":
            c = (c * 255 / 254 - 0.5) * 2
        elif s == "saturate":
            c = c * 2 - 1
        else:
            raise ValueError(self.params.signtype)
        c = c * self.max
        if self.params.scaletype == "log":
            c = _scale_exp(c, xp)
        return c / self.gain
