"""Runtime precision policy (PyTorch port of ``dspfun_tpu/core/precision.py``).

The reference selects two float precisions at compile time — "coeff"
(storage) and "intermediate" (math) — via the COEFF_PRECISION /
INTERMEDIATE_PRECISION macros (reference include/precision.h:26-57).
Here, as in the JAX package, that is a runtime policy object:

* ``coeff``: dtype of stored tensors and transform outputs.
* ``intermediate``: how matrix contractions accumulate — ``f32``,
  ``hilo`` (hi + lo float32 basis split), ``exact`` (error-free digit
  contraction, core/exact.py), ``f64``, or ``i8`` (int8 Ozaki digit
  kernels, ops/int8mm.py).

Every float32 contraction of these modes must run in full float32.  On
Hopper a float32 matmul may otherwise run in TF32 (about three decimal
digits), the counterpart of the TPU's DEFAULT precision, which would
break every accuracy budget below; importing this module pins both
PyTorch switches off.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_VALID_INTERMEDIATE = ("f32", "hilo", "exact", "f64", "i8")

# the reference's single-letter precision flags (F/D/L,
# include/precision.h:26-35) mapped onto policies
_LETTER_COEFF = {"F": "float32", "D": "float32", "L": "float32", "B": "bfloat16"}
_LETTER_INTER = {"F": "f32", "D": "hilo", "L": "hilo"}

_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64, "float16": torch.float16}


def _as_dtype(d: Any) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    try:
        return _DTYPE_NAMES[str(d)]
    except KeyError:
        raise ValueError(f"unsupported coeff dtype {d!r}") from None


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy: storage dtype + contraction accumulation mode.

    ``tol`` is an optional accuracy budget (target max relative error of
    a transform chain); see the JAX package's ``Precision`` for what it
    relaxes in each mode.  ``tol=None`` keeps each mode's maximum
    accuracy.  ``coeff`` accepts a ``torch.dtype`` or its name.
    """

    coeff: Any = torch.float32
    intermediate: str = "hilo"
    tol: float | None = None

    def __post_init__(self):
        if self.intermediate not in _VALID_INTERMEDIATE:
            raise ValueError(
                f"intermediate must be one of {_VALID_INTERMEDIATE}, "
                f"got {self.intermediate!r}"
            )
        if self.tol is not None and not (0.0 < self.tol < 1.0):
            raise ValueError(f"tol must be in (0, 1), got {self.tol!r}")
        _as_dtype(self.coeff)

    @property
    def coeff_dtype(self) -> torch.dtype:
        return _as_dtype(self.coeff)

    @property
    def basis_dtype(self) -> torch.dtype:
        """Dtype basis matrices are materialised in."""
        return torch.float64 if self.intermediate == "f64" else torch.float32

    @classmethod
    def from_letters(cls, coeff: str = "D", intermediate: str = "L") -> "Precision":
        """Map the reference's F/D/L compile-time letters to a policy."""
        return cls(
            coeff=_LETTER_COEFF[coeff.upper()],
            intermediate=_LETTER_INTER.get(intermediate.upper(), "hilo"),
        )

    @classmethod
    def parse(cls, spec: str) -> "Precision":
        """Parse the ``[coeff:]intermediate[@tol]`` policy syntax (the
        DSPFUN_PRECISION language): "f32", "hilo", "bf16:f32", "f64:f64",
        "exact@1e-5", "i8@1e-5"."""
        if not spec:
            return cls()
        spec, _, tol_s = spec.partition("@")
        coeff, _, inter = spec.partition(":")
        if not inter:
            coeff, inter = "float32", coeff
        coeff = {"f32": "float32", "bf16": "bfloat16",
                 "f64": "float64"}.get(coeff, coeff)
        return cls(coeff=coeff, intermediate=inter,
                   tol=float(tol_s) if tol_s else None)


DSPFUN_PRECISION = "DSPFUN_PRECISION"

_default = Precision.parse(os.environ.get(DSPFUN_PRECISION, ""))
# whether the policy was chosen explicitly (env var or set_precision);
# per-tool defaults only apply when it was not
_explicit = bool(os.environ.get(DSPFUN_PRECISION))


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as IEEE division (and the JAX package) does.

    PyTorch's CUDA kernels divide by a host scalar as ``x * (1/d)``,
    which rounds twice and, unless ``d`` is a power of two, scales every
    element by the same error.  In spec's shift template that bias sums
    coherently through the inverse DCT: a 0.36 round-trip error at the
    DC corner of a 4K image, measured on an H100.  A divisor that lies
    on the device (filled there, so no host copy stalls the stream) takes
    the true-division kernel.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def get_precision() -> Precision:
    return _default


def set_precision(p: Precision) -> None:
    global _default, _explicit
    _default = p
    _explicit = True


def tool_default(tool: str, device: torch.device | str = "cuda") -> Precision:
    """Per-tool default policy (the JAX package's ``tool_default``):
    zoom takes the deep-i8 contraction where the int8 kernels run, that
    is when ``device``, the device the tool resolved, is a CUDA device;
    every other tool, and zoom on any other device, takes hilo."""
    if tool == "zoom" and torch.device(device).type == "cuda":
        return Precision(coeff="float32", intermediate="i8")
    return Precision()


def apply_tool_default(tool: str, device: torch.device | str = "cuda") -> None:
    """Install the per-tool default policy for a run on ``device`` unless
    the user already chose one (DSPFUN_PRECISION or set_precision)."""
    global _default
    if not _explicit:
        _default = tool_default(tool, device)
