"""int8 digit contraction with the float32 operand split inside the kernel
(PyTorch port of the Pallas kernels of ``benchmarks/calib_r3e.py`` and
``benchmarks/calib_r3f.py``).

The contraction of :mod:`dspfun_tpu_torch.ops.int8mm`, but the float32
operand x [K, R] arrives unsplit: the kernel takes each column's max over
all of K, the column exponent, and the int8 digits itself, instead of
separate elementwise passes before the contraction.  A arrives as int8
digit planes [G, M, lda] (``split_matrix_i8``'s layout, lda >= K).
Instances, by (``xdigits``, ``groups``, ``scale``):

* (1, 1, "fixed64"): ``A_0 @ rint(x * 64)`` (the probes ``dot_computed_int8``
  and ``dot_via_int32``); domain ``|x * 64| <= 127``;
* (1, 1, "exp"): ``(A_0 @ rint(x * 2^-e * 64)) * 2^e`` (``redmax_log2``);
* (3, 2, "exp") and (3, 3, "exp"): the 3-digit split of ``x * 2^-e`` at
  2^7, 2^14, 2^21 and the digit-pair groups ``g = i + j`` with weights
  2^(-7(g+2)), combined in float32 as g0, +g1[, +g2], times 2^e
  (``full_split`` with two groups, ``calib_r3f`` with three).

``e`` is the probes' column exponent ``ceil(log2(max|x|)) + 1`` computed
exactly from the bits (:func:`col_exponent`).  Domain of the exponent
instances: finite x whose column maxima are 0 or in [2^-126, 2^125); a
column outside it comes out NaN.

For CUDA tensors :func:`i8_split_contract` launches the hand-written
kernel ``csrc/int8split.cu``; for CPU tensors it runs
:func:`_i8_split_plain`, the same split in PyTorch with the groups
through exact float64 matmuls.  The two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from dspfun_tpu_torch.ops.int8mm import _W, B_I8, _i8_groups_plain, exp2i, round_digits

__all__ = ["INSTANCES", "TILES", "COMPILED_TILES", "DEFAULT_TILE", "LAUNCHES", "col_exponent",
           "split_columns", "i8_split_contract"]

# (xdigits, groups, scale) -> the instance's name, its key in LAUNCHES
INSTANCES = {
    (1, 1, "fixed64"): "fixed1",
    (1, 1, "exp"): "exp1",
    (3, 2, "exp"): "exp3g2",
    (3, 3, "exp"): "exp3g3",
}
# output tile (rows of A, columns of x) per thread block, by ``tile`` index:
# two consumer warpgroups of 64 rows, or one; every instance is compiled
# for both
TILES = ((128, 64), (64, 64))
COMPILED_TILES = {name: (0, 1) for name in INSTANCES.values()}
DEFAULT_TILE = 0

# kernel launches by instance name; counted where the CUDA kernel
# launches and nowhere else
LAUNCHES: Counter = Counter()

_E_MIN, _E_MAX = -125, 126   # column exponents whose scales 2^-e, 2^e are normal
_BN = 64                     # columns of x per thread block (the launch grid's y)


def col_exponent(mx: torch.Tensor) -> torch.Tensor:
    """The probes' ``ceil(log2(mx)) + 1`` for non-negative float32 ``mx``,
    exact from the bits: exponent field - 126, plus 1 when the mantissa is
    not zero; 0 for ``mx = 0``.  (The main path's ``int8mm.log2_ceil1`` is
    field - 125: the two agree unless ``mx`` is a power of two, where this
    one is smaller by one and a digit can reach 64.)  Float32 result."""
    bits = mx.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    return torch.where(bits == 0, torch.zeros_like(e), e).to(torch.float32)


def _col_scales(e: torch.Tensor):
    """(2^-e, 2^e), exact; NaN outside the domain, as the kernel."""
    ok = (e >= _E_MIN) & (e <= _E_MAX)
    nan = torch.full_like(e, float("nan"))
    return torch.where(ok, exp2i(-e), nan), torch.where(ok, exp2i(e), nan)


def split_columns(x: torch.Tensor, xdigits: int, scale: str):
    """The kernel's split of x [K, R] in PyTorch: (digit tensors, float32
    and integer-valued, and the column exponent [1, R] or None for the
    fixed scale).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    e, r = None, x
    if scale == "exp":
        e = col_exponent(torch.amax(torch.abs(x), dim=0, keepdim=True))
        r = x * _col_scales(e)[0]
    # one digit is round(r * 2^6), the probes' x * 64; three are int8mm's
    return round_digits(r, 6 if xdigits == 1 else B_I8, xdigits), e


def _kmax(groups: int, scale: str) -> int:
    """Largest K with provably exact int32 group sums: A digits are at
    most 64 in magnitude (``split_matrix_i8`` and the probes' ``a8``), x
    digits at most 64 with the column exponent and 127 on the fixed scale's
    domain, and the heaviest group sums ``groups`` dots."""
    per = 64 * (128 if scale == "fixed64" else 64)
    return ((1 << 31) - 1) // (groups * per)


def _check(a_planes: torch.Tensor, x: torch.Tensor, xdigits: int, groups: int,
           scale: str) -> str:
    """Shape, type and bound checks shared by both paths; the instance name."""
    name = INSTANCES.get((xdigits, groups, scale))
    if name is None:
        raise ValueError(f"i8 split: no instance (xdigits={xdigits}, groups={groups}, "
                         f"scale={scale!r}); expected one of {sorted(INSTANCES)}")
    if a_planes.dtype != torch.int8 or x.dtype != torch.float32:
        raise TypeError("i8 split: expected int8 A planes and float32 x, got "
                        f"{a_planes.dtype} and {x.dtype}")
    if a_planes.dim() != 3 or x.dim() != 2 or a_planes.shape[0] != groups:
        raise ValueError(f"i8 split: expected A [{groups}, M, lda] and x [K, R], got "
                         f"{tuple(a_planes.shape)} and {tuple(x.shape)}")
    k = x.shape[0]
    if k == 0 or k > a_planes.shape[2]:
        raise ValueError(f"i8 split: contraction length {k} must lie in "
                         f"[1, lda = {a_planes.shape[2]}]")
    if k > _kmax(groups, scale):
        raise ValueError(f"i8 split: contraction length {k} exceeds the exact-int32 "
                         f"bound {_kmax(groups, scale)} for {groups} groups")
    return name


def _i8_split_plain(a_planes: torch.Tensor, x: torch.Tensor, xdigits: int,
                    groups: int, scale: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same split, then
    ``int8mm._i8_groups_plain``'s float64 group matmuls (every digit
    product is an integer of at most 2^13 and every group sum stays below
    2^31, so float64 accumulation is exact in any order), each group cast
    to float32 as the kernel's int32 -> float32 conversion rounds,
    combined in the kernel's order."""
    digits, e = split_columns(x, xdigits, scale)
    acc = _i8_groups_plain(a_planes, torch.stack(digits)[:, None], "left",
                           [1.0] if xdigits == 1 else _W)[0]
    return acc if e is None else acc * _col_scales(e)[1]


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with the split kernel's C signature."""
    from dspfun_tpu_torch import _build  # noqa: PLC0415

    lib = _build.load_library()
    fn = lib.dspfun_i8split
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    lib.dspfun_cuda_error_string.restype = ctypes.c_char_p
    lib.dspfun_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _i8_split_cuda(a_planes: torch.Tensor, x: torch.Tensor, xdigits: int,
                   groups: int, scale: str, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Launch ``csrc/int8split.cu`` on the current stream; raises on any
    input the kernel does not take."""
    if not (a_planes.is_cuda and x.is_cuda and a_planes.device == x.device):
        raise ValueError("i8 split kernel: operands must lie on one CUDA device, got "
                         f"{a_planes.device} and {x.device}")
    name = _check(a_planes, x, xdigits, groups, scale)
    if not (a_planes.is_contiguous() and x.is_contiguous()):
        raise ValueError("i8 split kernel: operands must be contiguous")
    if tile not in COMPILED_TILES[name]:
        raise ValueError(f"i8 split kernel: {name} is compiled for tiles "
                         f"{COMPILED_TILES[name]}, not {tile}")
    _, m, lda = a_planes.shape
    k, r = x.shape
    if m >= 2**31 or -(-r // _BN) > 65535:
        raise ValueError(f"i8 split kernel: shape M={m} R={r} exceeds the launch grid")
    out = torch.empty((m, r), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # TMA reads 16-byte rows from 16-byte aligned bases: a copy pads A's
    # rows and x's with zeros (x is zero past K, so A's padding is never
    # summed, and the store masks the columns past R)
    if lda % 16 or a_planes.data_ptr() % 16:
        padded = a_planes.new_zeros((groups, m, -(-lda // 16) * 16))
        padded[:, :, :lda] = a_planes
        a_planes, lda = padded, padded.shape[2]
    ldx = r
    if r % 4 or x.data_ptr() % 16:
        padded = x.new_zeros((k, -(-r // 4) * 4))
        padded[:, :r] = x
        x, ldx = padded, padded.shape[1]
    e = torch.empty(r if scale == "exp" else 0, dtype=torch.int32, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dspfun_i8split(a_planes.data_ptr(), lda, x.data_ptr(), ldx, e.data_ptr(),
                                 out.data_ptr(), xdigits, groups, int(scale == "exp"),
                                 tile, m, r, k, stream)
    if err != 0:
        raise RuntimeError(f"i8 split kernel launch failed: CUDA error {err} "
                           f"({lib.dspfun_cuda_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return out


def i8_split_contract(a_planes: torch.Tensor, x: torch.Tensor, *, xdigits: int,
                      groups: int, scale: str, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Contract int8 A planes [groups, M, lda] against float32 x [K, R],
    splitting x inside the kernel: float32 [M, R] (A's row scales are not
    applied).  The plain version for CPU tensors; the CUDA kernel, at
    output tile ``TILES[tile]``, for everything else (which raises unless
    both operands lie on one CUDA device)."""
    if a_planes.device.type == "cpu" and x.device.type == "cpu":
        _check(a_planes, x, xdigits, groups, scale)
        return _i8_split_plain(a_planes, x, xdigits, groups, scale)
    return _i8_split_cuda(a_planes, x, xdigits, groups, scale, tile)
