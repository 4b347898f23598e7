"""Kronecker-folded blockwise transforms (PyTorch port of
``dspfun_tpu/ops/blockdct.py``).

For a separable N-D DCT over a small block (volume V = bd*bh*bw), the
transform is the Kronecker product of the per-axis basis matrices: one
[V, V] matrix per block, batched over the block grid as [NB, V] @
[V, V].  When the coefficient chain is linear (bandpass boost/damp,
uniform renorm, any fixed mask), forward transform, filter and inverse
fold into ONE [V, V] operator:

    A = K_inv @ diag(filter) @ K_fwd / (2^n * V)

The [V, V] matrices are float64 numpy, built on the host; the copy of
``kron_dct_matrix`` is pinned bit-equal to the JAX package's by
tests/test_torch_blockdct.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.core.transforms import AxisPlan, apply_plan, plan_matrix

__all__ = [
    "kron_dct_matrix",
    "kron_dct_rows",
    "folded_operator",
    "apply_block_operator",
    "bdiag_axis_plan",
    "blocks_from_array",
    "blocks_to_array",
]


def _axis_matrix(kind: str):
    return basis_mod.dct2_matrix if kind == "dct2" else basis_mod.dct3_matrix


@functools.lru_cache(maxsize=32)
def _kron_cached(dims: tuple[int, ...], kind: str) -> np.ndarray:
    mk = _axis_matrix(kind)
    m = np.array([[1.0]])
    for n in dims:
        m = np.kron(m, mk(n))
    m.setflags(write=False)  # cached: in-place edits would corrupt it
    return m


def kron_dct_matrix(dims: tuple[int, ...], kind: str = "dct2") -> np.ndarray:
    """[V, V] separable DCT over a block of shape ``dims`` acting on the
    row-major flattened block (V = prod(dims))."""
    return _kron_cached(tuple(int(d) for d in dims), kind)


def kron_dct_rows(dims: tuple[int, ...], kind: str, rows: np.ndarray,
                  columns: bool = False) -> np.ndarray:
    """``kron_dct_matrix(dims, kind)[rows, :]`` (or ``[:, rows]`` with
    ``columns``) without building the [V, V] matrix.

    Each entry is the product of one entry per axis matrix, formed in
    the order ``np.kron`` forms it (((1 * a) * b) * c), so the result is
    bit-equal to slicing the full matrix.  A 24^3 block has V = 13824:
    the full float64 matrix is 1.5 GB, its 216 pass-band rows 24 MB.
    """
    dims = tuple(int(d) for d in dims)
    idx = np.unravel_index(np.asarray(rows, dtype=np.int64), dims)
    out = np.ones((len(idx[0]), 1))
    for n, i in zip(dims, idx):
        m = _axis_matrix(kind)(n)
        sel = m[:, i].T if columns else m[i, :]
        out = (out[:, :, None] * sel[:, None, :]).reshape(len(i), -1)
    return np.ascontiguousarray(out.T) if columns else out


def folded_operator(
    dims: tuple[int, ...],
    coeff_filter: np.ndarray,
    precision: Precision | None = None,
    device: torch.device | str = "cuda",
) -> AxisPlan:
    """One [V, V] operator = IDCT @ diag(filter) @ DCT / (2^n V), planned
    on ``device``.

    ``coeff_filter`` is the per-coefficient multiplier (block shape),
    e.g. a bandpass boost/damp mask.  The result applied to a flat
    block reproduces fused transform->filter->inverse exactly.
    """
    v = int(np.prod(dims))
    fwd = kron_dct_matrix(dims, "dct2")
    inv = kron_dct_matrix(dims, "dct3")
    f = np.asarray(coeff_filter, dtype=np.float64).reshape(v)
    a = (inv * f[None, :]) @ fwd / (2.0 ** len(dims) * v)
    return plan_matrix(a, precision, device)


def apply_block_operator(
    blocks: torch.Tensor, op: AxisPlan, precision: Precision | None = None
) -> torch.Tensor:
    """[NB, V] blocks through the folded [V, V] operator with the full
    precision-policy dispatch (f32/hilo/exact/i8/f64) of
    core.transforms.apply_plan."""
    return apply_plan(blocks, op, 1, precision)


def bdiag_axis_plan(
    size: int,
    block_matrix: np.ndarray,
    precision: Precision | None = None,
    device: torch.device | str = "cuda",
) -> AxisPlan:
    """Block-diagonal [size, size] plan ``I_{size//n} (x) block_matrix``
    on ``device``.

    Applies an independent per-block [n, n] transform along a
    full-length axis as ONE dense matmul: no block gather, no
    reshape/transpose, and a K=size contraction instead of K=n.  Fold
    any separable per-coefficient diagonal and scalar gains into
    ``block_matrix`` before calling.
    """
    m = np.asarray(block_matrix, dtype=np.float64)
    n = m.shape[0]
    if m.ndim != 2 or m.shape[1] != n:
        raise ValueError(f"block_matrix must be square, got {m.shape}")
    if size % n:
        raise ValueError(f"axis length {size} not a multiple of block {n}")
    return plan_matrix(np.kron(np.eye(size // n), m), precision, device)


def blocks_from_array(x: torch.Tensor, dims: tuple[int, int]) -> torch.Tensor:
    """[H, W, C] -> [nbh*nbw*C, bh*bw] flat blocks (row-major within
    block), truncating ragged edges."""
    bh, bw = dims
    h, w, c = x.shape
    nbh, nbw = h // bh, w // bw
    a = x[: nbh * bh, : nbw * bw]
    a = a.reshape(nbh, bh, nbw, bw, c).permute(0, 2, 4, 1, 3)
    return a.reshape(nbh * nbw * c, bh * bw)


def blocks_to_array(
    blocks: torch.Tensor, dims: tuple[int, int], h: int, w: int, c: int
) -> torch.Tensor:
    bh, bw = dims
    nbh, nbw = h // bh, w // bw
    a = blocks.reshape(nbh, nbw, c, bh, bw).permute(0, 3, 1, 4, 2)
    return a.reshape(nbh * bh, nbw * bw, c)
