"""dspfun_tpu_torch.models.fused against dspfun_tpu.models.fused and a
scipy float64 oracle.

Both packages get the same plans (built by the JAX package, carried
across by ``convert``) and the same numpy inputs.  Tolerances, port vs
JAX:

* exact: the contractions are bit-equal, so only the elementwise steps
  could differ — 1e-6;
* deep i8 (4 digits, ~2^-28 truncation): 1e-6;
* i8@1e-5 (3 digits, ~2^-21 truncation): 5e-6.  The rank-1 ``mean``
  split takes the operand mean, whose float32 sum runs in another order
  in PyTorch than in XLA; one ulp of difference there moves every digit
  truncation, so the two chains agree only to the sum of their own
  truncation errors (each ~2.4e-6 against float64 at this size);
* hilo and f32: float32 matmuls in another summation order — 1e-5.

Against float64 every mode must hold the 1e-5 target (BASELINE.md).
"""

import numpy as np
import pytest
import scipy.fft
import torch

import jax.numpy as jnp

from dspfun_tpu.core.precision import Precision as JP
from dspfun_tpu.models import fused as jfused
from dspfun_tpu_torch.convert import filter_plans_from_jax
from dspfun_tpu_torch.core.precision import Precision as TP
from dspfun_tpu_torch.models import fused as tfused
from dspfun_tpu_torch.ops import int8mm as tmm

H, W = 256, 384
VS_JAX = {"i8@1e-5": 5e-6, "i8": 1e-6, "exact": 1e-6, "hilo": 1e-5, "f32": 1e-5}


def _oracle(x, mask):
    ref = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(0, 1))
    ref *= mask
    return scipy.fft.dctn(ref, type=3, axes=(0, 1)) / (4.0 * x.shape[1] * x.shape[0])


@pytest.fixture(scope="module")
def image():
    x = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    mask = tfused.lowpass_mask((H, W), cutoff=0.5, boost=1.25)[:, :, None].astype(np.float32)
    return x, mask, _oracle(x, mask)


def test_lowpass_mask_matches_jax():
    for shape, cutoff in (((H, W), 0.5), ((8, 16, 16), 0.25), ((5,), 0.01)):
        np.testing.assert_array_equal(tfused.lowpass_mask(shape, cutoff, 1.25, 0.1),
                                      jfused.lowpass_mask(shape, cutoff, 1.25, 0.1))


@pytest.mark.parametrize("spec", list(VS_JAX))
def test_fused_filter_2d_matches_jax(image, spec):
    x, mask, ref = image
    pj, pt = JP.parse(spec), TP.parse(spec)
    jplans = jfused.filter_plans((H, W), pj, mask=mask)
    tplans = tfused.filter_plans((H, W), pt, mask=mask, device="cpu")
    # plans built by the port equal the JAX package's, field by field
    carried = filter_plans_from_jax(jplans, device="cpu")
    for a, b in zip(tplans.fwd + tplans.inv, carried.fwd + carried.inv):
        for fa, fb in zip(a, b):
            assert (fa is None and fb is None) or torch.equal(fa, fb)
    assert [None if s is None else s.tolist() for s in tplans.support] == \
        [None if s is None else s.tolist() for s in jplans.support]
    yj = np.asarray(jfused.fused_filter_2d(jnp.asarray(x), jnp.asarray(mask), jplans, pj),
                    np.float64)
    before = sum(tmm.LAUNCHES.values())
    yt = tfused.fused_filter_2d(torch.from_numpy(x), torch.from_numpy(mask),
                                filter_plans_from_jax(jplans, device="cpu"), pt)
    assert sum(tmm.LAUNCHES.values()) == before  # CPU tensors: plain version
    assert yt.shape == x.shape and yt.dtype == torch.float32
    yt = yt.numpy().astype(np.float64)
    assert np.max(np.abs(yt - yj)) <= VS_JAX[spec]
    assert np.max(np.abs(yt - ref)) <= 1e-5
    assert np.max(np.abs(yj - ref)) <= 1e-5


def test_fused_filter_2d_mask_rank_and_rect():
    """A rank-2 [H, W] mask broadcasts over channels in the i8 branch
    (no transpose), and a rank mismatch raises like the JAX package."""
    h, w = 64, 96
    x = np.random.default_rng(7).random((h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[: h // 4, : w // 2] = 1.0
    p = TP(intermediate="i8")
    plans = tfused.filter_plans((h, w), p, mask=mask, device="cpu")
    y = tfused.fused_filter_2d(torch.from_numpy(x), torch.from_numpy(mask), plans, p)
    assert np.max(np.abs(y.numpy() - _oracle(x, mask[:, :, None]))) <= 1e-5
    with pytest.raises(ValueError, match="mask rank"):
        tfused.fused_filter_2d(torch.from_numpy(x), torch.from_numpy(mask[0]), plans, p)


def test_fused_filter_3d_matches_jax():
    """The graft entry's chain (a frame cube under a 3-D lowpass) at hilo."""
    t, h, w = 8, 24, 40
    cube = np.random.default_rng(0).random((t, h, w, 3)).astype(np.float32)
    mask = tfused.lowpass_mask((t, h, w), cutoff=0.5, boost=1.25)[..., None].astype(np.float32)
    pj, pt = JP(coeff="float32", intermediate="hilo"), TP(coeff="float32", intermediate="hilo")
    yj = np.asarray(jfused.fused_filter_3d(jnp.asarray(cube), jnp.asarray(mask),
                                           jfused.filter_plans((t, h, w), pj), pj))
    plans = tfused.filter_plans((t, h, w), pt, device="cpu")
    yt = tfused.fused_filter_3d(torch.from_numpy(cube), torch.from_numpy(mask), plans, pt)
    assert np.max(np.abs(yt.numpy() - yj)) <= 1e-5
    # pruned plans compute the same chain
    pruned = tfused.filter_plans((t, h, w), pt, mask=mask, device="cpu")
    assert all(s is not None for s in pruned.support)
    yp = tfused.fused_filter_3d(torch.from_numpy(cube), torch.from_numpy(mask), pruned, pt)
    assert np.max(np.abs(yp.numpy() - yj)) <= 1e-5
    # the legacy (fwd, inv) pair is accepted too
    y2 = tfused.fused_filter_3d(torch.from_numpy(cube), torch.from_numpy(mask),
                                (plans.fwd, plans.inv), pt)
    assert torch.equal(y2, yt)
