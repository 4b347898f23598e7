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
the coefficients never leave the chip.  For CPU tensors it runs
:func:`_block_filter_plain`, two float32 matmuls around the same middle.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch

from dspfun_tpu_torch.ops.blockdct import kron_dct_matrix

__all__ = ["V_MAX", "LAUNCHES", "fused_block_filter", "folded_filter_matrices"]

V_MAX = 1024  # the kernel keeps one row tile of [rows, V] coefficients on chip


# kernel launches under the key "block_filter"; counted where the CUDA
# kernel launches and nowhere else
LAUNCHES: Counter = Counter()


@functools.lru_cache(maxsize=32)
def _folded(dims: tuple[int, ...], filt: bytes, post: bytes | None, device: str):
    """(K2m^T, K3s^T) float32 on ``device``, folded in float64 exactly as
    the Pallas wrapper folds them (pallas_kernels.py:114-124)."""
    v = int(np.prod(dims))
    k2 = kron_dct_matrix(dims, "dct2")
    k3 = kron_dct_matrix(dims, "dct3") / (2.0 ** len(dims) * v)
    f = np.frombuffer(filt, dtype=np.float64)
    k2m_t = np.ascontiguousarray((k2 * f[:, None]).T, dtype=np.float32)
    if post is not None:
        k3 = k3 * np.frombuffer(post, dtype=np.float64)[None, :]
    k3s_t = np.ascontiguousarray(k3.T, dtype=np.float32)
    return torch.from_numpy(k2m_t).to(device), torch.from_numpy(k3s_t).to(device)


def folded_filter_matrices(dims, coeff_filter, post_filter=None,
                           device: torch.device | str = "cpu"):
    """(K2m^T, K3s^T) float32 [V, V] on ``device``, cached per (dims,
    filter bytes, post-filter bytes, device)."""
    dims = tuple(int(d) for d in dims)
    v = int(np.prod(dims))
    filt = np.ascontiguousarray(coeff_filter, dtype=np.float64).reshape(v).tobytes()
    post = (None if post_filter is None else np.ascontiguousarray(
        post_filter, dtype=np.float64).reshape(v).tobytes())
    return _folded(dims, filt, post, str(torch.device(device)))


def _middle(f: torch.Tensor, quant: float, tmin: float, tmax: float) -> torch.Tensor:
    if tmax:
        a = torch.abs(f)
        f = torch.where((a < tmin) | (a > tmax), torch.zeros_like(f), f)
    if quant:
        # float32(1/quant) from the host, as the Pallas body's 1.0/quant
        f = torch.round(f * (1.0 / quant)) * quant
    return f


def _block_filter_plain(x: torch.Tensor, k2m_t: torch.Tensor, k3s_t: torch.Tensor,
                        quant: float, tmin: float, tmax: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: two float32 matmuls (full
    float32, no TF32, see core/precision.py) around the same middle."""
    f = _middle(x @ k2m_t, quant, tmin, tmax)
    return f @ k3s_t


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with the block filter's C signature."""
    from dspfun_tpu_torch import _build  # noqa: PLC0415

    lib = _build.load_library()
    fn = lib.dspfun_block_filter
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.dspfun_cuda_error_string.restype = ctypes.c_char_p
    lib.dspfun_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _block_filter_cuda(x: torch.Tensor, k2m_t: torch.Tensor, k3s_t: torch.Tensor,
                       quant: float, tmin: float, tmax: float) -> torch.Tensor:
    """Launch ``csrc/block_filter.cu`` on the current stream; raises on
    any input the kernel does not take."""
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
    lib = _kernel_lib()
    q_inv = 1.0 / quant if quant else 0.0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dspfun_block_filter(x.data_ptr(), k2m_t.data_ptr(), k3s_t.data_ptr(),
                                      out.data_ptr(), nb, v, quant, q_inv, tmin, tmax,
                                      stream)
    if err != 0:
        raise RuntimeError(f"block filter kernel launch failed: CUDA error {err} "
                           f"({lib.dspfun_cuda_error_string(err).decode()})")
    LAUNCHES["block_filter"] += 1
    return out


def _block_filter(x, k2m_t, k3s_t, quant, tmin, tmax):
    """The plain version for CPU tensors, the CUDA kernel for everything
    else (which raises unless every operand lies on one CUDA device)."""
    if all(t.device.type == "cpu" for t in (x, k2m_t, k3s_t)):
        return _block_filter_plain(x, k2m_t, k3s_t, quant, tmin, tmax)
    return _block_filter_cuda(x, k2m_t, k3s_t, quant, tmin, tmax)


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
    k2m_t, k3s_t = folded_filter_matrices(dims, coeff_filter, post_filter,
                                          blocks.device)
    x = blocks.to(torch.float32).contiguous()
    return _block_filter(x, k2m_t, k3s_t, float(quant), float(threshold[0]),
                         float(threshold[1]))
