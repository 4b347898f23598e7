"""int8 Ozaki digit contraction (PyTorch port of ``dspfun_tpu/ops/int8mm.py``).

Both operands are split into 7-bit signed integer digits (|digit| <=
64): the [M, K] matrix once on the host (:func:`split_matrix_i8`), the
float32 operand at run time with exact power-of-two slice scaling
(:func:`split_operand_digits`).  Every digit-pair product is then an
exact int8 x int8 -> int32 dot product, same-weight pairs sum exactly in
int32 (see :func:`_kmax`), and the only error is the digit truncation
(~2^-21 relative for 3 digits, ~2^-28 for 4).

The digit-pair products run in the hand-written CUDA kernel
``csrc/int8mm.cu`` (warpgroup int8 MMA on the tensor cores) for CUDA
tensors, and in :func:`_i8_groups_plain`, its plain PyTorch version, for
CPU tensors.  Two layouts avoid transposes in the chains: ``left``
contracts the middle axis of x [B, K, R] into [B, M, R]; ``right``
contracts the last axis of x [B, R, K] into [B, R, M].  A [C, H, W]
separable chain alternates the two.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch

__all__ = ["B_I8", "I8_DEEP_TOL", "LAUNCHES", "ceil_to", "split_matrix_i8",
           "split_operand_digits", "log2_ceil1", "exp2i", "scale_down",
           "i8_contract", "i8_contract_rt", "i8_feasible"]


def ceil_to(n: int, m: int) -> int:
    """``n`` rounded up to the next multiple of ``m``."""
    return -(-n // m) * m


B_I8 = 7          # digit width: |digit| <= 64 after half-range scaling
_NDIG = 3         # 3 digits cover ~22 bits below each row/slice max
_W = [float(2.0 ** (-B_I8 * (p + 2))) for p in range(4)]

# accuracy budgets at or below this engage the 4-digit deep kernel
# (10 digit-pair products, truncation ~2^-28); looser budgets keep the
# 3-digit kernel (6 products)
I8_DEEP_TOL = 2e-6

# the CUDA kernel's output tile: rows of A (two warpgroups of 64) by
# slices of x (csrc/int8mm.cu, BM and BN); one block per tile and batch
KERNEL_TILE = (128, 64)

# kernel launches by instantiation ("left3", "right3", "left4",
# "right4"); counted where the CUDA kernel launches and nowhere else
LAUNCHES: Counter = Counter()


def split_matrix_i8(m: np.ndarray, ndig: int = _NDIG):
    """Host split of a float64 [M, K] matrix into int8 digits.

    Returns (digits int8 [D, M, Kp], row_scale f32 [M, 1]) with K padded
    to a multiple of 128 with zero digits (the plan layout shared with
    the JAX package) and ``m ~= row_scale * sum_i digits[i] *
    2**(-B*(i+1))``; rows are scaled into (-1/2, 1/2] so every digit
    fits +-64.
    """
    m = np.asarray(m, dtype=np.float64)
    mm, k = m.shape
    mx = np.max(np.abs(m), axis=1, keepdims=True)
    e = np.where(mx > 0, np.ceil(np.log2(np.maximum(mx, 1e-300))) + 1.0, 0.0)
    r = m / 2.0**e
    digs = []
    for i in range(ndig):
        sc = 2.0 ** (B_I8 * (i + 1))
        d = np.round(r * sc)
        r = r - d / sc
        digs.append(d.astype(np.int8))
    digits = np.stack(digs)
    kp = ceil_to(k, 128)
    if kp != k:
        digits = np.pad(digits, ((0, 0), (0, 0), (0, kp - k)))
    return digits, (2.0**e).astype(np.float32)


def log2_ceil1(x: torch.Tensor) -> torch.Tensor:
    """Exact per-element e with 2^(e-2) <= |x| < 2^(e-1), read from the
    float32 exponent field: the scaling exponent that puts x * 2^-e
    strictly inside (-1/2, 1/2).  A ``log2`` approximation can be off by
    one near powers of two and overflow the 64-bound digit proof."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (((bits >> 23) & 0xFF) - 125).to(torch.float32)


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer-valued float32 ``e`` in [-126, 127], built
    from the biased exponent bits.  An approximate ``exp2`` makes
    scale/unscale pairs non-reciprocal (a ~1.2e-7 error on every element
    capped the JAX package's deep-i8 mode on the TPU).  ``e > 127``
    yields +inf, so an operand outside the digit domain is loudly
    non-finite; ``e < -126`` clamps (use :func:`scale_down`)."""
    bits = (torch.clamp(e, -126.0, 127.0).to(torch.int32) + 127) << 23
    v = bits.view(torch.float32)
    return torch.where(e > 127.0, torch.full_like(v, float("inf")), v)


def scale_down(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x * 2^-e`` by two exact power-of-two factors, covering the full
    :func:`log2_ceil1` range (e up to 129) without subnormal scales."""
    h1 = torch.floor(e * 0.5)
    return (x * exp2i(-h1)) * exp2i(-(e - h1))


def split_operand_digits(x: torch.Tensor, axis: int, bwidth: int, ndig: int,
                         dtype: torch.dtype):
    """Run-time digit split of a float32 operand with per-slice exact
    power-of-two scaling along ``axis`` (every digit provably fits
    ``+-2^(bwidth-1)``), then the round/subtract loop, each step
    error-free.  Serves the int8 path (``bwidth=7, int8``) and the exact
    digit path (core/exact.py).  Returns (digit tensors, log2-scale
    ``e`` with ``axis`` kept as size 1)."""
    mx = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    e = torch.where(mx > 0, log2_ceil1(mx), torch.zeros_like(mx))
    return [d.to(dtype) for d in round_digits(scale_down(x, e), bwidth, ndig)], e


def round_digits(r: torch.Tensor, bwidth: int, ndig: int) -> list[torch.Tensor]:
    """The round/subtract loop of a digit split of scaled ``r``: digit i
    is ``round(r_i * 2^(bwidth (i+1)))`` of the remainder r_i, each step
    error-free; float digits of ``r``'s dtype."""
    out = []
    for i in range(ndig):
        sc = float(2.0 ** (bwidth * (i + 1)))
        d = torch.round(r * sc)  # half to even, like jnp.round
        r = r - d * (1.0 / sc)
        out.append(d)
    return out


def _split_operand(x: torch.Tensor, axis: int, ndig: int = _NDIG):
    """int8 digit split of ``x`` along ``axis``: (digits int8 [ndig,
    *x.shape] contiguous, slice scale 2^e with ``axis`` kept)."""
    out, e = split_operand_digits(x, axis, B_I8, ndig, torch.int8)
    return torch.stack(out), exp2i(e)


def _kmax(ndig: int) -> int:
    """Largest K with provably exact int32 group accumulation: digit
    products are bounded by 64*64 = 2^12 and the kernel sums the
    same-weight pairs in int32 before the float32 cast — 3 dots in the
    3-digit kernel's heaviest group, 4 in the deep kernel's — so the
    bound is (2^31 - 1) / (group_dots * 2^12)."""
    group = 3 if ndig == 3 else 4
    return ((1 << 31) - 1) // (group << 12)


def i8_feasible(m: int, k: int, ndig: int = _NDIG) -> bool:
    """Planner probe: does a [m, k] digit contraction fit the kernel's
    exact-int32 bound?  The CUDA kernel loops over K in shared-memory
    stages, so there is no other limit on K (the JAX package also
    rejects shapes whose tiles overflow the TPU's VMEM)."""
    return k <= _kmax(ndig)


def _i8_groups_plain(a_digits: torch.Tensor, x_digits: torch.Tensor,
                     layout: str, weights=_W) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same digit-pair groups
    through float64 matmuls.  Every digit product is at most 2^12 and
    every group sum stays below 2^31 (``_kmax``), so float64
    accumulation is exact in any order, and the float32 cast of each
    exact group rounds as the kernel's int32 -> float32 conversion does.
    The groups combine in the kernel's order: g0, +g1, +g2[, +g3].  One
    group per A digit plane, each pair (i, g - i) whose x digit exists;
    group g weighs ``weights[g]``."""
    nd = a_digits.shape[0]
    k = x_digits.shape[2] if layout == "left" else x_digits.shape[3]
    a = a_digits[:, :, :k].to(torch.float64)
    x = x_digits.to(torch.float64)
    acc = None
    for g in range(nd):
        pairs = [i for i in range(g + 1) if g - i < x.shape[0]]
        if layout == "left":   # [M, K] @ [B, K, R] -> [B, M, R]
            s = sum(a[i] @ x[g - i] for i in pairs)
        else:                  # [B, R, K] @ [K, M] -> [B, R, M]
            s = sum(x[g - i] @ a[i].T for i in pairs)
        t = s.to(torch.float32) * weights[g]
        acc = t if acc is None else acc + t
    return acc


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from dspfun_tpu_torch import _build  # noqa: PLC0415

    lib = _build.load_library()
    lib.dspfun_i8mm.restype = ctypes.c_int
    lib.dspfun_i8mm.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.dspfun_cuda_error_string.restype = ctypes.c_char_p
    lib.dspfun_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _x_staging_pitch(layout: str, k: int, x_ptr: int) -> int | None:
    """The kernel reads x K-major through TMA, which wants 16-byte row
    strides and addresses.  None when x is read in place (the right
    layout with K a multiple of 16 at a 16-byte aligned address: every
    right contraction of the main paths); otherwise the row pitch of the
    K-major staging buffer [D, B, R, pitch] that the kernel's first pass
    writes, K rounded up to 16 with zero padding (the left layout, whose
    x is R-contiguous, and ragged right shapes)."""
    if layout == "right" and k % 16 == 0 and x_ptr % 16 == 0:
        return None
    return ceil_to(k, 16)


def _i8_groups_cuda(a_digits: torch.Tensor, x_digits: torch.Tensor,
                    layout: str) -> torch.Tensor:
    """Launch ``csrc/int8mm.cu`` on the current stream; raises on any
    input the kernel does not take."""
    if not (a_digits.is_cuda and x_digits.is_cuda
            and a_digits.device == x_digits.device):
        raise ValueError("i8 kernel: digits must lie on one CUDA device, got "
                         f"{a_digits.device} and {x_digits.device}")
    if a_digits.dtype != torch.int8 or x_digits.dtype != torch.int8:
        raise TypeError("i8 kernel: digits must be int8, got "
                        f"{a_digits.dtype} and {x_digits.dtype}")
    if not (a_digits.is_contiguous() and x_digits.is_contiguous()):
        raise ValueError("i8 kernel: digit tensors must be contiguous")
    if a_digits.dim() != 3 or x_digits.dim() != 4:
        raise ValueError("i8 kernel: expected A [D, M, Kp] and x [D, B, ., .]")
    nd, m, kp = a_digits.shape
    if nd not in (3, 4) or x_digits.shape[0] != nd:
        raise ValueError(f"i8 kernel: digit planes {nd} (A) and "
                         f"{x_digits.shape[0]} (x); expected 3 or 4 of each")
    _, b, d1, d2 = x_digits.shape
    k, r = (d1, d2) if layout == "left" else (d2, d1)
    if k > kp:
        raise ValueError(f"i8 kernel: contraction length {k} exceeds A's "
                         f"padded length {kp}")
    if k > _kmax(nd):
        raise ValueError(f"i8 kernel: contraction length {k} exceeds the "
                         f"exact-int32 bound {_kmax(nd)} for {nd} digits")
    if max(m, r) >= 2**31 or b > 65535 or m > 65535 * KERNEL_TILE[0]:
        raise ValueError(f"i8 kernel: shape B={b} M={m} R={r} exceeds the "
                         "launch grid")
    if a_digits.data_ptr() % 16 or kp % 16:
        raise ValueError("i8 kernel: A's digits must start 16-byte aligned with "
                         f"a padded length a multiple of 16, got length {kp}")
    shape = (b, m, r) if layout == "left" else (b, r, m)
    out = torch.empty(shape, dtype=torch.float32, device=x_digits.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    pitch = _x_staging_pitch(layout, k, x_digits.data_ptr())
    xs = None if pitch is None else torch.empty((nd, b, r, pitch), dtype=torch.int8,
                                                device=x_digits.device)
    lib = _kernel_lib()
    with torch.cuda.device(x_digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dspfun_i8mm(a_digits.data_ptr(), kp, x_digits.data_ptr(),
                              out.data_ptr(), nd, 0 if layout == "left" else 1,
                              b, m, r, k, stream,
                              None if xs is None else xs.data_ptr(),
                              k if pitch is None else pitch)
    if err != 0:
        raise RuntimeError(f"i8 kernel launch failed: CUDA error {err} "
                           f"({lib.dspfun_cuda_error_string(err).decode()})")
    LAUNCHES[f"{layout}{nd}"] += 1
    return out


def _i8_groups(a_digits: torch.Tensor, x_digits: torch.Tensor,
               layout: str) -> torch.Tensor:
    """The unscaled digit-pair combination: the plain version for CPU
    tensors, the CUDA kernel for everything else (which raises unless
    both operands lie on one CUDA device)."""
    if a_digits.device.type == "cpu" and x_digits.device.type == "cpu":
        return _i8_groups_plain(a_digits, x_digits, layout)
    return _i8_groups_cuda(a_digits, x_digits, layout)


def i8_contract(x: torch.Tensor, digits_a: torch.Tensor, scale_a,
                axis: int) -> torch.Tensor:
    """Contract the int8-digit [M, K] matrix (``digits_a`` [D, M, Kp] and
    row scales ``scale_a`` [M, 1] from :func:`split_matrix_i8`) against
    ``axis`` of ``x``.  Shaped like ``x`` with ``axis`` replaced by M.

    3 digit planes run the 6-product kernel (~2^-21 truncation); 4
    planes the deep 10-product kernel (~2^-28).  ``axis == 0`` and
    ``axis == ndim-1`` run without a transpose, a middle axis of a
    [C, H, W] tensor rides the kernel's batch dimension (unless the last
    axis has length 1: then the right form takes the squeezed tensor),
    and anything else takes one ``movedim``.
    """
    da, m, kp = digits_a.shape
    if da not in (_NDIG, _NDIG + 1):
        raise ValueError(f"expected {_NDIG} or {_NDIG + 1} digit planes, "
                         f"got {da}")
    sa = torch.as_tensor(scale_a, dtype=torch.float32, device=x.device)
    return _i8_dispatch(x, digits_a, sa, axis, m, kp)


def i8_contract_rt(x: torch.Tensor, a_f32: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """Like :func:`i8_contract` but the [M, K] matrix is a run-time
    float32 tensor, split into 3 digit planes on its device (per-row
    slice scaling)."""
    af = torch.as_tensor(a_f32, dtype=torch.float32, device=x.device)
    m, k = af.shape
    kp = ceil_to(k, 128)
    if kp != k:
        af = torch.nn.functional.pad(af, (0, kp - k))
    ad, ea = _split_operand(af, 1)
    return _i8_dispatch(x, ad, ea, axis, m, kp)


def _i8_dispatch(x, a_digits, scale_a, axis, m, kp):
    axis = axis % x.ndim
    nd = a_digits.shape[0]
    k = x.shape[axis]
    if k > _kmax(nd):
        raise ValueError(
            f"i8 contraction length {k} exceeds the exact-int32 "
            f"accumulation bound ({_kmax(nd)} for {nd} digit planes); "
            "split the axis or use exact/hilo")
    xf = x.to(torch.float32)
    sa = scale_a

    if x.ndim >= 3 and axis == x.ndim - 2 and x.shape[-1] == 1:
        # one column (draw's [H, W, 1] grid along W): the batched left
        # form would fill each 128x64 tile with one live column, about
        # 70x slower on an H100 at draw's 4K shape (chip_smoke.py phase
        # 11 times both).  The right form on the squeezed tensor splits
        # the same K-vectors under the same exponents: bit-equal.
        return _i8_dispatch(xf[..., 0], a_digits, scale_a, axis, m, kp)[..., None]
    if axis == x.ndim - 1 and x.ndim >= 2:
        # right form: [pre..., K] -> [pre..., M]
        pre = tuple(xf.shape[:-1])
        xd, ex = _split_operand(xf.reshape(1, -1, k), 2, nd)
        y = _i8_groups(a_digits, xd, "right")
        y = y[0] * ex[0] * sa[:, 0][None, :]
        return y.reshape(pre + (m,))
    if axis == 0:
        rest = tuple(xf.shape[1:])
        xd, ex = _split_operand(xf.reshape(1, k, -1), 1, nd)
        y = _i8_groups(a_digits, xd, "left")
        y = y[0] * ex[0] * sa
        return y.reshape((m,) + rest)
    if axis == 1 and x.ndim == 3:
        # batched left form over the leading dim (the [C, H, W] case)
        xd, ex = _split_operand(xf, 1, nd)
        y = _i8_groups(a_digits, xd, "left")
        return y * ex * sa[None]
    # general middle axis: one movedim to the front
    y = _i8_dispatch(xf.movedim(axis, 0), a_digits, scale_a, 0, m, kp)
    return y.movedim(0, axis)
