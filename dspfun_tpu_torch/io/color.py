"""Colorspace transfer functions (copy of ``dspfun_tpu/io/color.py``).

The exact piecewise sRGB decode the reference inlines
(applybasis/applybasis.c:142-144, genbasis.c:95-97):

    srgbdec(x) = x/12.92                    if x <= 0.0404482362771082
                 ((x+0.055)/1.055)^2.4      otherwise

its inverse (the IEC 61966-2-1 OETF), and the BT.601/BT.709/BT.2020
RGB<->YCbCr matrices of the video layer.  The transfer functions take
numpy arrays (``xp=np``) or torch tensors (``xp=torch``); on tensors the
powers get a Newton polish, as the JAX package's device path does.
tests/test_torch_motion_cli.py pins the copy to its original.
"""

from __future__ import annotations

import numpy as np
import torch

from dspfun_tpu_torch.core.precision import true_div

__all__ = ["srgb_decode", "srgb_encode", "ycbcr_matrix", "ycbcr_inverse_matrix"]

_DEC_THRESH = 0.0404482362771082
_ENC_THRESH = _DEC_THRESH / 12.92


def _pow_5_12(x: torch.Tensor) -> torch.Tensor:
    """``x ** (5/12)`` (= 1/2.4) polished by one Newton step against
    ``y^12 = x^5`` (both sides exact-rational multiply chains): the
    residual (y^12 - x^5)/y^12 is ~12*err of the pow guess, so one step
    squares that error below the float32 ulp."""
    y = torch.pow(x, 5.0 / 12.0)
    x2 = x * x
    x5 = x2 * x2 * x
    y3 = y * y * y
    y6 = y3 * y3
    y12 = y6 * y6
    # rsqrt(0) = inf makes the correction inf*0 = nan on the x = 0
    # lanes, which the where masks
    r6 = torch.rsqrt(y12)
    return torch.where(x5 > 0, y - y * (y12 - x5) * (r6 * r6) * (1.0 / 12.0), y)


def _pow_12_5(x: torch.Tensor) -> torch.Tensor:
    """``x ** 2.4`` (= 12/5) as ``x^2 * (x^2)^(1/5)`` with a Newton-refined
    fifth root: the root's residual error propagates x1 into the product
    (a ^12 chain would amplify it x12)."""
    a = x * x
    r = torch.pow(a, 0.2)
    r4 = (r * r) ** 2
    r = torch.where(a > 0, r - (r4 * r - a) / (5.0 * r4 + 1e-38), r)
    return a * r


def srgb_decode(x, xp=np):
    """sRGB electrical -> linear light (EOTF)."""
    if xp is np:
        p = np.power((np.abs(x) + 0.055) / 1.055, 2.4)
        return np.where(x <= _DEC_THRESH, x / 12.92, p)
    p = _pow_12_5(true_div(torch.abs(x) + 0.055, 1.055))
    return torch.where(x <= _DEC_THRESH, true_div(x, 12.92), p)


def srgb_encode(x, xp=np):
    """Linear light -> sRGB electrical (OETF), inverse of srgb_decode."""
    if xp is np:
        p = np.power(np.maximum(x, 0.0), 1.0 / 2.4)
        return np.where(x <= _ENC_THRESH, x * 12.92, 1.055 * p - 0.055)
    p = _pow_5_12(torch.clamp_min(x, 0.0))
    return torch.where(x <= _ENC_THRESH, x * 12.92, 1.055 * p - 0.055)


def _ycbcr(kr: float, kb: float) -> np.ndarray:
    kg = 1.0 - kr - kb
    return np.array(
        [
            [kr, kg, kb],
            [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
            [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
        ],
        dtype=np.float64,
    )


_MATRICES = {
    "bt601": _ycbcr(0.299, 0.114),
    "bt709": _ycbcr(0.2126, 0.0722),
    "bt2020": _ycbcr(0.2627, 0.0593),
}


def ycbcr_matrix(name: str = "bt601") -> np.ndarray:
    """RGB -> (Y, Cb, Cr) matrix (Cb/Cr centered at 0)."""
    return _MATRICES[name]


def ycbcr_inverse_matrix(name: str = "bt601") -> np.ndarray:
    return np.linalg.inv(_MATRICES[name])
