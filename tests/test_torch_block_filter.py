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
    t2, t3 = tbf.folded_filter_matrices(dims, filt, pf, device="cpu")
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


def test_tf32_rounding_is_nearest_ties_away():
    """_tf32_rna rounds float32 to 10 mantissa bits as cvt.rna.tf32.f32:
    to nearest, ties away from zero, the low 13 bits zero."""
    one = 1.0
    a = torch.tensor([one + 2.0**-11, -(one + 2.0**-11), one + 2.0**-11 - 2.0**-23,
                      one + 3 * 2.0**-11, 0.0, -0.0, 2.0**-130], dtype=torch.float32)
    hi = tbf._tf32_rna(a)
    np.testing.assert_array_equal(hi.numpy(), np.array(
        [one + 2.0**-10, -(one + 2.0**-10), one, one + 2.0**-9, 0.0, -0.0, 2.0**-130],
        dtype=np.float32))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096).astype(np.float32)) * 300
    hx = tbf._tf32_rna(x)
    assert not (hx.view(torch.int32) & 0x1FFF).any()
    assert bool(((x - hx).abs() <= 2.0**-11 * x.abs()).all())


@pytest.mark.parametrize("which", ["K2m", "K3s"])
@pytest.mark.parametrize("dims", [(4, 4, 4), (8, 5, 5)])
def test_split_tf32_products_within_the_stated_bound(dims, which):
    """The kernel's split-TF32 arithmetic (hi.hi + hi.lo + lo.hi, formed
    in float64 here) agrees with the float64 product of the same float32
    operands within SPLIT_C * 2^-21 * sum_k |x_k| |K_kn| per coefficient,
    the model that sets the band of tests/test_torch_cuda.py and
    chip_smoke.py.  TF32 alone (hi.hi) breaks that bound."""
    v = int(np.prod(dims))
    rng = np.random.default_rng(v)
    uf = rng.random(dims) + 0.5
    k2m_t, k3s_t = tbf.folded_filter_matrices(dims, uf * 1.25, 1.0 / uf, device="cpu")
    k = k2m_t if which == "K2m" else k3s_t
    x = torch.from_numpy((rng.random((30, v)) * 255).astype(np.float32))
    if which == "K3s":  # the second product's left operand: coefficients
        x = x @ k2m_t
    exact = x.double() @ k.double()
    bound = tbf.SPLIT_C * 2.0**-21 * (x.abs().double() @ k.abs().double())
    err = (tbf._split_tf32_products(x, k) - exact).abs()
    assert bool((err <= bound * (1 + 2.0**-9)).all())
    assert float(err.max()) > 0.0
    tf32_only = tbf._tf32_rna(x).double() @ tbf._tf32_rna(k).double()
    assert bool(((tf32_only - exact).abs() > bound).any())


def test_boundary_band_constant():
    """c of the kernel-vs-plain band: the split's 1.5, the kernel's
    accumulation 2.125 + sqrt(V / 32) / 8 and the plain version's
    sqrt(V) / 8."""
    assert tbf.band_c(200) == pytest.approx(5.705, abs=1e-3)
    assert tbf.band_c(512) == pytest.approx(6.953, abs=1e-3)
    assert tbf.band_c(1024) == pytest.approx(8.332, abs=1e-3)
    x = torch.ones((3, 8))
    k = torch.full((8, 8), -0.5)
    np.testing.assert_allclose(tbf.boundary_band(x, k).numpy(),
                               np.full((3, 8), tbf.band_c(8) * 2.0**-21 * 4.0), rtol=1e-6)


@pytest.mark.parametrize("v", [1, 200, 231])
def test_kmajor_split_layout(v):
    """The kernel's matrix operands: M = (M^T)^T K-major, split into TF32 hi
    and lo parts (low 13 bits zero) whose sum is M to 2^-22 relative, rows
    padded with zeros to a multiple of 4 floats.  The folded operands are
    cached per filter; on the CPU they carry no split, which only the
    kernel reads (tests/test_torch_cuda.py checks the card's)."""
    m_t = torch.from_numpy(np.random.default_rng(v).standard_normal((v, v)).astype(np.float32))
    hi, lo = tbf._kmajor_split(m_t)
    ldx = -(-v // 4) * 4
    assert hi.shape == lo.shape == (v, ldx) and hi.is_contiguous() and lo.is_contiguous()
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert not hi[:, v:].any() and not lo[:, v:].any()
    m = m_t.t().double()
    err = (hi[:, :v].double() + lo[:, :v].double() - m).abs()
    assert bool((err <= 2.0**-22 * m.abs()).all())
    dims = (1, 1, v)
    filt = np.random.default_rng(v + 1).random(dims)
    first = tbf._folded_operands(dims, filt, None, "cpu")
    assert first[2] is None
    again = tbf._folded_operands(dims, filt.copy(), None, torch.device("cpu"))
    assert again[0] is first[0] and again[1] is first[1]
    assert tbf.folded_filter_matrices(dims, filt, device="cpu")[0] is first[0]
