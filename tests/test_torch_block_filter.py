"""dspfun_tpu_torch.ops.block_filter against dspfun_tpu.ops.pallas_kernels.

The JAX package runs its Pallas kernel in interpret mode on the CPU; the
port runs the kernel's plain version there (two float32 matmuls around
the same middle).  The folded matrices are built by the same float64
numpy arithmetic, so they are bit-equal; the outputs agree to 1e-2 pels
(0..255 inputs), the bound tests/test_pallas.py holds the Pallas kernel
to, because the float32 products sum in another order.  The CUDA kernel
is held to its plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from dspfun_tpu.ops import blockdct as jbd
from dspfun_tpu.ops import pallas_kernels as pk
from dspfun_tpu_torch.ops import block_filter as tbf

DIMS = [(2, 8, 8), (16, 8), (8, 5, 5), (8, 8, 8)]
MODES = {
    "linear": {},
    "quant": {"quant": 50.0},
    "threshold": {"threshold": (10.0, 1e5)},
    "post": {"post": True},
    "all": {"quant": 50.0, "threshold": (100.0, 3e4), "post": True},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dims", DIMS)
def test_plain_version_matches_jax_kernel(dims, mode):
    v = int(np.prod(dims))
    rng = np.random.default_rng(v)
    x = (rng.random((20, v)) * 255).astype(np.float32)
    filt = rng.random(dims) + 0.5
    kw = dict(MODES[mode])
    if kw.pop("post", False):
        kw["post_filter"] = rng.random(dims) + 0.5
    yj = np.asarray(pk.fused_block_filter(x, dims, filt, row_tile=8, interpret=True, **kw))
    before = sum(tbf.LAUNCHES.values())
    yt = tbf.fused_block_filter(torch.from_numpy(x), dims, filt, **kw)
    assert sum(tbf.LAUNCHES.values()) == before  # a CPU tensor runs the plain version
    assert yt.dtype == torch.float32 and yt.shape == (20, v)
    assert np.max(np.abs(yt.numpy() - yj)) <= 1e-2


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("dims", [(2, 8, 8), (8, 5, 5)])
def test_folded_matrices_bit_equal_to_the_pallas_fold(dims, post):
    """The fold of pallas_kernels.py:114-124, in float64, cast once."""
    v = int(np.prod(dims))
    rng = np.random.default_rng(1)
    filt = rng.random(dims)
    pf = rng.random(dims) if post else None
    k2 = jbd.kron_dct_matrix(dims, "dct2")
    k3 = jbd.kron_dct_matrix(dims, "dct3") / (2.0 ** len(dims) * v)
    k2m_t = np.ascontiguousarray((k2 * filt.reshape(v)[:, None]).T, dtype=np.float32)
    if post:
        k3 = k3 * pf.reshape(v)[None, :]
    k3s_t = np.ascontiguousarray(k3.T, dtype=np.float32)
    t2, t3 = tbf.folded_filter_matrices(dims, filt, pf)
    np.testing.assert_array_equal(t2.numpy(), k2m_t)
    np.testing.assert_array_equal(t3.numpy(), k3s_t)
    assert t2.is_contiguous() and t3.is_contiguous()


def test_quant_rounds_half_to_even():
    """The middle rounds F * float32(1/quant) half to even, as jnp.round."""
    f = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 7.0]])
    np.testing.assert_array_equal(tbf._middle(f, 1.0, 0.0, 0.0).numpy(),
                                  [[0.0, 2.0, 2.0, -0.0, -2.0, 7.0]])
    # the threshold engages only when its upper bound is set
    np.testing.assert_array_equal(tbf._middle(f, 0.0, 1.0, 0.0).numpy(), f.numpy())
    np.testing.assert_array_equal(tbf._middle(f, 0.0, 1.0, 5.0).numpy(),
                                  [[0.0, 1.5, 2.5, 0.0, -2.5, 0.0]])


def test_wrappers_refuse_what_they_cannot_take():
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="do not match"):
        tbf.fused_block_filter(x, (2, 8, 4), np.ones((2, 8, 4)))
    k = torch.zeros((128, 128))
    # the kernel wrapper takes CUDA tensors only; CPU tensors go to the
    # plain version through the dispatcher, never to the kernel
    with pytest.raises(ValueError, match="CUDA device"):
        tbf._block_filter_cuda(x, k, k, 0.0, 0.0, 0.0)
    assert tbf._block_filter(x, k, k, 0.0, 0.0, 0.0).shape == (4, 128)
