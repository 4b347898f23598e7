"""dspfun_tpu_torch.ops.blockdct against dspfun_tpu.ops.blockdct.

The Kronecker matrices are float64 numpy in both packages and must be
bit-equal (the copy of ``kron_dct_matrix`` is pinned here).  The folded
and block-diagonal plans are built from them by the same numpy
arithmetic, so their float32 parts are bit-equal too; applied to the
same blocks, hilo contractions agree to 1e-5 of the output range
(float32 matmuls in another summation order).  The block gathers are
pure index shuffles: equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.core.precision import Precision as JP
from dspfun_tpu.ops import blockdct as jbd
from dspfun_tpu_torch.core.precision import Precision as TP
from dspfun_tpu_torch.ops import blockdct as tbd

DIMS = [(8,), (4, 4), (2, 8, 8), (16, 8, 8), (8, 5, 5), (3, 7)]


@pytest.mark.parametrize("kind", ["dct2", "dct3"])
@pytest.mark.parametrize("dims", DIMS)
def test_kron_dct_matrix_bit_equal(dims, kind):
    t = tbd.kron_dct_matrix(dims, kind)
    np.testing.assert_array_equal(t, jbd.kron_dct_matrix(dims, kind))
    assert not t.flags.writeable


@pytest.mark.parametrize("kind", ["dct2", "dct3"])
@pytest.mark.parametrize("dims", [(2, 8, 8), (8, 5, 5), (4, 6, 2)])
def test_kron_dct_rows_are_slices_of_the_full_matrix(dims, kind):
    full = jbd.kron_dct_matrix(dims, kind)
    rows = np.random.default_rng(0).choice(full.shape[0], 17, replace=False)
    np.testing.assert_array_equal(tbd.kron_dct_rows(dims, kind, rows), full[rows])
    cols = tbd.kron_dct_rows(dims, kind, rows, columns=True)
    np.testing.assert_array_equal(cols, full[:, rows])
    assert cols.flags.c_contiguous


@pytest.mark.parametrize("dims", [(2, 8, 8), (8, 5, 5), (16, 8)])
def test_folded_operator_matches_jax(dims):
    rng = np.random.default_rng(1)
    filt = rng.random(dims)
    pj = jbd.folded_operator(dims, filt, JP())
    pt = tbd.folded_operator(dims, filt, TP(), device="cpu")
    np.testing.assert_array_equal(pt.hi.numpy(), np.asarray(pj.hi))
    np.testing.assert_array_equal(pt.lo.numpy(), np.asarray(pj.lo))
    v = int(np.prod(dims))
    x = (rng.random((11, v)) * 255).astype(np.float32)
    yj = np.asarray(jbd.apply_block_operator(jnp.asarray(x), pj, JP()))
    yt = tbd.apply_block_operator(torch.from_numpy(x), pt, TP()).numpy()
    assert np.max(np.abs(yt - yj)) <= 1e-5 * 255


def test_bdiag_axis_plan_matches_jax():
    m = np.random.default_rng(2).standard_normal((8, 8))
    pj = jbd.bdiag_axis_plan(64, m, JP())
    pt = tbd.bdiag_axis_plan(64, m, TP(), device="cpu")
    np.testing.assert_array_equal(pt.hi.numpy(), np.asarray(pj.hi))
    np.testing.assert_array_equal(pt.lo.numpy(), np.asarray(pj.lo))
    with pytest.raises(ValueError, match="multiple"):
        tbd.bdiag_axis_plan(60, m, device="cpu")
    with pytest.raises(ValueError, match="square"):
        tbd.bdiag_axis_plan(64, m[:4], device="cpu")


@pytest.mark.parametrize("shape,dims", [((64, 48, 3), (8, 8)), ((37, 50, 2), (8, 16)),
                                        ((16, 16, 1), (16, 16))])
def test_blocks_from_to_array_match_jax(shape, dims):
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    bj = np.asarray(jbd.blocks_from_array(jnp.asarray(x), dims))
    bt = tbd.blocks_from_array(torch.from_numpy(x), dims)
    np.testing.assert_array_equal(bt.numpy(), bj)
    h, w = shape[0] // dims[0] * dims[0], shape[1] // dims[1] * dims[1]
    back_j = np.asarray(jbd.blocks_to_array(jnp.asarray(bj), dims, h, w, shape[2]))
    back_t = tbd.blocks_to_array(bt, dims, h, w, shape[2])
    np.testing.assert_array_equal(back_t.numpy(), back_j)
    np.testing.assert_array_equal(back_t.numpy(), x[:h, :w])
