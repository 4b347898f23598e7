"""Fused Kronecker block filter (PyTorch port of
``dspfun_tpu/ops/pallas_kernels.py:fused_block_filter``).

Blocks flattened to [NB, V] rows (V = block volume) go through

    out = mid(X @ K2m^T) @ K3s^T

with ``K2m`` the Kronecker-folded [V, V] DCT-II with the per-coefficient
filter folded into its rows, ``K3s`` the folded DCT-III with the
1/(2^n V) normalisation and the post-filter folded into its columns,
and ``mid`` the threshold and quantisation of motion's filter chain
(reference motion/motion.c:721-744).

For CUDA tensors this runs the hand-written kernel
``csrc/block_filter.cu``: one read of X and one write of the output,
the coefficients never leave the chip, and both products run on the
tensor cores in split TF32 (each float32 operand a = hi + lo, the
product hi.hi + hi.lo + lo.hi) over a 2-CTA cluster; the matrices reach
it K-major and split (:func:`_kmajor_split`, made once with the folded
matrices on a CUDA device and cached with them).  For CPU tensors it
runs :func:`_block_filter_plain`, two float32 matmuls around the same
middle.  :func:`_split_tf32_products` is the split's arithmetic on the
CPU, and :func:`boundary_band` the estimated kernel-vs-plain error per
coefficient that decides which blocks a comparison leaves out (a
coefficient that close to a threshold or a quant half-step may fall
either way).
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import numpy as np
import torch

from dspfun_tpu_torch.ops.blockdct import kron_dct_matrix

__all__ = ["V_MAX", "LAUNCHES", "SPLIT_C", "band_c", "boundary_band", "fused_block_filter",
           "folded_filter_matrices"]

V_MAX = 1024  # the kernel keeps one row tile of [rows, V] coefficients on chip


# kernel launches under the key "block_filter"; counted where the CUDA
# kernel launches and nowhere else
LAUNCHES: Counter = Counter()


@functools.lru_cache(maxsize=32)
def _folded(dims: tuple[int, ...], filt: bytes, post: bytes | None, device: str):
    """(K2m^T, K3s^T, split): the matrices float32 on ``device``, folded in
    float64 exactly as the Pallas wrapper folds them
    (pallas_kernels.py:114-124), and on a CUDA device the kernel's
    operands (K2m hi, K2m lo, K3s hi, K3s lo) from :func:`_kmajor_split`
    (None on the CPU, where the plain version needs none)."""
    v = int(np.prod(dims))
    k2 = kron_dct_matrix(dims, "dct2")
    k3 = kron_dct_matrix(dims, "dct3") / (2.0 ** len(dims) * v)
    f = np.frombuffer(filt, dtype=np.float64)
    k2m_t = np.ascontiguousarray((k2 * f[:, None]).T, dtype=np.float32)
    if post is not None:
        k3 = k3 * np.frombuffer(post, dtype=np.float64)[None, :]
    k3s_t = np.ascontiguousarray(k3.T, dtype=np.float32)
    k2m_t, k3s_t = torch.from_numpy(k2m_t).to(device), torch.from_numpy(k3s_t).to(device)
    split = None if k2m_t.device.type == "cpu" else (*_kmajor_split(k2m_t),
                                                     *_kmajor_split(k3s_t))
    return k2m_t, k3s_t, split


def _folded_operands(dims, coeff_filter, post_filter, device):
    """:func:`_folded`'s (K2m^T, K3s^T, split) for these filters, cached per
    (dims, filter bytes, post-filter bytes, device)."""
    dims = tuple(int(d) for d in dims)
    v = int(np.prod(dims))
    filt = np.ascontiguousarray(coeff_filter, dtype=np.float64).reshape(v).tobytes()
    post = (None if post_filter is None else np.ascontiguousarray(
        post_filter, dtype=np.float64).reshape(v).tobytes())
    return _folded(dims, filt, post, str(torch.device(device)))


def folded_filter_matrices(dims, coeff_filter, post_filter=None,
                           device: torch.device | str = "cuda"):
    """(K2m^T, K3s^T) float32 [V, V] on ``device``, cached per (dims,
    filter bytes, post-filter bytes, device)."""
    return _folded_operands(dims, coeff_filter, post_filter, device)[:2]


def _middle(f: torch.Tensor, quant: float, tmin: float, tmax: float) -> torch.Tensor:
    if tmax:
        a = torch.abs(f)
        f = torch.where((a < tmin) | (a > tmax), torch.zeros_like(f), f)
    if quant:
        # float32(1/quant) from the host, as the Pallas body's 1.0/quant
        f = torch.round(f * (1.0 / quant)) * quant
    return f


# The split's error per coefficient, in units of 2^-21 sum_k |x_k| |K2m_kn|
# (csrc/block_filter.cu's error model): per product a.b the dropped lo.lo
# term and lo's rounding in hi.lo and lo.hi are each <= 2^-22 |a||b|.
SPLIT_C = 1.5


def band_c(v: int) -> float:
    """c of the kernel-vs-plain band c * 2^-21 * sum_k |x_k| |K2m_kn| at
    block volume ``v``, in units of 2^-21 times that sum.  An estimate,
    not a bound: it adds two worst-case bounds, the split's SPLIT_C and
    the kernel's truncating tensor-core updates (stages of 32 k chain at
    most 8 updates, each within 2^-23 of a partial no larger than the
    stage's sum of |terms|: 2 units over all stages, plus 1/8 unit for
    rounding the stage's two partials together and onto the
    accumulator), to two terms of the probabilistic model of rounding
    (errors independent, sqrt(n) / 8 units for n additions at 2^-24):
    the kernel's V / 32 stage additions, sqrt(V / 32) / 8, and the plain
    version's V float32 additions, sqrt(V) / 8.  Those two are worst-case
    V / 32 / 8 and V / 8 units, so a coefficient may in rare cases flip
    outside the band; that fails a comparison, it hides no wrong kernel.
    5.71 at V = 200, 6.95 at 512, 8.33 at 1024."""
    return SPLIT_C + 2.125 + math.sqrt(v / 32) / 8 + math.sqrt(v) / 8


def boundary_band(x: torch.Tensor, k2m_t: torch.Tensor) -> torch.Tensor:
    """Per coefficient [NB, V], how far the kernel's F = X K2m^T may be
    expected to lie from the plain version's:
    ``band_c(V) * 2^-21 * |x| @ |K2m^T|`` (an estimate, see band_c)."""
    return (band_c(x.shape[1]) * 2.0**-21) * (x.abs() @ k2m_t.abs())


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, round to nearest, ties
    away from zero) by bit masking, as cvt.rna.tf32.f32 rounds."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's split-TF32 product of float32 a [n, k] and b [k, m]:
    hi.hi + hi.lo + lo.hi with hi = tf32(.), lo = tf32(. - hi), in
    float64 (so without the kernel's float32 accumulation)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return ah @ bh + ah @ bl + al @ bh


def _block_filter_plain(x: torch.Tensor, k2m_t: torch.Tensor, k3s_t: torch.Tensor,
                        quant: float, tmin: float, tmax: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: two float32 matmuls (full
    float32, no TF32, see core/precision.py) around the same middle."""
    f = _middle(x @ k2m_t, quant, tmin, tmax)
    return f @ k3s_t


def _kmajor_split(m_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operand layout of a [V, V] matrix M^T: M K-major (row
    n, column k) split into TF32 hi and lo parts, each [V, ldx] with ldx
    = V rounded up to 4 (16-byte rows for TMA) and zeros past V."""
    v = m_t.shape[0]
    km = torch.nn.functional.pad(m_t.t(), (0, -v % 4))
    hi = _tf32_rna(km)
    return hi, _tf32_rna(km - hi)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with the block filter's C signature."""
    from dspfun_tpu_torch import _build  # noqa: PLC0415

    lib = _build.load_library()
    fn = lib.dspfun_block_filter
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    lib.dspfun_cuda_error_string.restype = ctypes.c_char_p
    lib.dspfun_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _block_filter_cuda(x: torch.Tensor, k2m_t: torch.Tensor, k3s_t: torch.Tensor,
                       quant: float, tmin: float, tmax: float,
                       split: tuple[torch.Tensor, ...] | None = None) -> torch.Tensor:
    """Launch ``csrc/block_filter.cu`` on the current stream; raises on
    any input the kernel does not take.  ``split`` is the matrices'
    operand layout as :func:`_folded` caches it; made here when not
    given."""
    ts = (x, k2m_t, k3s_t)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("block filter kernel: operands must lie on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("block filter kernel: operands must be float32, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("block filter kernel: operands must be contiguous")
    if x.dim() != 2:
        raise ValueError(f"block filter kernel: expected blocks [NB, V], got {tuple(x.shape)}")
    nb, v = x.shape
    if v > V_MAX:
        raise ValueError(f"block filter kernel: block volume {v} exceeds V_MAX = {V_MAX}")
    if k2m_t.shape != (v, v) or k3s_t.shape != (v, v):
        raise ValueError(f"block filter kernel: matrices {tuple(k2m_t.shape)} and "
                         f"{tuple(k3s_t.shape)}, expected ({v}, {v})")
    if nb >= 2**31:
        raise ValueError(f"block filter kernel: {nb} blocks exceed the launch grid")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # TMA reads 16-byte rows from 16-byte aligned bases
    ldx = v + -v % 4
    if ldx != v or x.data_ptr() % 16:
        padded = x.new_zeros((nb, ldx))
        padded[:, :v] = x
        x = padded
    if split is None:
        split = (*_kmajor_split(k2m_t), *_kmajor_split(k3s_t))
    k2h, k2l, k3h, k3l = split
    lib = _kernel_lib()
    q_inv = 1.0 / quant if quant else 0.0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dspfun_block_filter(x.data_ptr(), ldx, k2h.data_ptr(), k2l.data_ptr(),
                                      k3h.data_ptr(), k3l.data_ptr(), out.data_ptr(), nb, v,
                                      quant, q_inv, tmin, tmax, stream)
    if err != 0:
        raise RuntimeError(f"block filter kernel launch failed: CUDA error {err} "
                           f"({lib.dspfun_cuda_error_string(err).decode()})")
    LAUNCHES["block_filter"] += 1
    return out


def _block_filter(x, k2m_t, k3s_t, quant, tmin, tmax, split=None):
    """The plain version for CPU tensors, the CUDA kernel for everything
    else (which raises unless every operand lies on one CUDA device)."""
    if all(t.device.type == "cpu" for t in (x, k2m_t, k3s_t)):
        return _block_filter_plain(x, k2m_t, k3s_t, quant, tmin, tmax)
    return _block_filter_cuda(x, k2m_t, k3s_t, quant, tmin, tmax, split)


def fused_block_filter(
    blocks: torch.Tensor,
    dims: tuple[int, ...],
    coeff_filter: np.ndarray,
    quant: float = 0.0,
    threshold: tuple[float, float] = (0.0, 0.0),
    post_filter: np.ndarray | None = None,
) -> torch.Tensor:
    """Fused DCT -> (filter, threshold, quantise) -> IDCT over flat
    blocks [NB, V] of shape ``dims`` (V = prod(dims)), on ``blocks``'
    device.

    ``coeff_filter`` is the per-coefficient linear multiplier (folded
    into the forward matrix); ``quant``/``threshold`` act between the
    two products in the filtered-coefficient domain.  The threshold
    follows the reference's gating (motion.c:721): it is active only
    when ``threshold[1] != 0``.  ``post_filter`` is a per-coefficient
    multiplier applied after the middle (folded into the inverse
    matrix, e.g. motion's inverse uniform renorm).  The round-trip
    normalisation 1/(2^n V) is folded into the inverse matrix.
    """
    nb, v = blocks.shape
    if v != int(np.prod(dims)):
        raise ValueError(f"blocks of volume {v} do not match dims {tuple(dims)}")
    k2m_t, k3s_t, split = _folded_operands(dims, coeff_filter, post_filter,
                                           blocks.device)
    x = blocks.to(torch.float32).contiguous()
    return _block_filter(x, k2m_t, k3s_t, float(quant), float(threshold[0]),
                         float(threshold[1]), split=split)
