"""dspfun_tpu_torch.models.spec_pipeline against dspfun_tpu.models.spec_pipeline.

All five ``-t`` templates at 64x96 (hilo) and 256x256 (hilo, which
upgrades to exact at >= 256 px).  Tolerances, port vs JAX:

* spectrogram: 1e-6, except the log templates (abs, shift) at hilo:
  2e-5.  There the float32 matmuls sum in another order in PyTorch than
  in XLA (a few ulps of the ~4wh*mean DC class), and log1p of the
  near-zero coefficients passes that absolute error through almost
  undamped (d/df log1p(f)/log1p(max) ~ 1/log1p(max) at f ~ 0);
* the 16-bit quantised spectrogram (what spec writes): within 1 code;
* DC: 1e-7 (the image mean);
* inverse of the same spectrogram: 1e-6 of the output's range.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.core.precision import Precision as JP
from dspfun_tpu.models import spec_pipeline as jspec
from dspfun_tpu_torch.core.precision import Precision as TP
from dspfun_tpu_torch.models import spec_pipeline as tspec

TEMPLATES = ["abs", "shift", "flat", "sign", "copy"]


def _image(h, w, seed=5):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def _params(t):
    # flat/sign/copy take a custom gain (-G 1000); abs/shift are native
    return (jspec.SpecChainParams.template(t, 1000.0),
            tspec.SpecChainParams.template(t, 1000.0))


@pytest.mark.parametrize("size", [(64, 96), (256, 256)])
@pytest.mark.parametrize("t", TEMPLATES)
def test_spec_forward_inverse_match_jax(t, size):
    h, w = size
    x = _image(h, w)
    jp, tp = _params(t)
    assert tp == tspec.SpecChainParams(*[getattr(jp, f) for f in
                                         ("scaletype", "signtype", "gaintype",
                                          "rangetype", "gain")])
    fj, dj = jspec.spec_forward(jnp.asarray(x), jp, JP())
    fj, dj = np.array(fj), np.array(dj)  # writable copies for torch.from_numpy
    ft, dt = tspec.spec_forward(torch.from_numpy(x), tp, TP())
    ft, dt = ft.numpy(), dt.numpy()
    exact = min(h, w) >= 256
    tol = 2e-5 if (not exact and tp.scaletype == "log") else 1e-6
    assert ft.shape == x.shape and ft.dtype == np.float32
    assert np.max(np.abs(ft - fj)) <= tol
    assert np.max(np.abs(dt - dj)) <= 1e-7
    qj = np.round(np.clip(fj, 0, 1) * 65535)
    qt = np.round(np.clip(ft, 0, 1) * 65535)
    assert np.max(np.abs(qt - qj)) <= 1
    # the inverses of one spectrogram (JAX's), with DC where the range needs it
    dc = dj if tp.rangetype != "one" else None
    ij = np.asarray(jspec.spec_inverse(jnp.asarray(fj), jp, dc=dc, precision=JP()))
    it = tspec.spec_inverse(torch.from_numpy(fj), tp,
                            dc=None if dc is None else torch.from_numpy(dc),
                            precision=TP()).numpy()
    assert np.max(np.abs(it - ij)) <= 1e-6 * np.max(np.abs(ij))
    if t == "copy":  # linear, no offset: a float32-exact round trip
        assert np.max(np.abs(it - x)) <= 1e-5


def test_signmap_and_preserve_dc_match_jax():
    """ispec's sign restoration from a ``-t sign`` map, and preserve_dc."""
    x = _image(64, 96, seed=9)
    jp_abs, tp_abs = _params("abs")
    jp_sign, tp_sign = _params("sign")
    fa, dc = jspec.spec_forward(jnp.asarray(x), jp_abs, JP())
    sm, _ = jspec.spec_forward(jnp.asarray(x), jp_sign, JP())
    fa, dc, sm = np.array(fa), np.array(dc), np.array(sm)
    sm = np.round(sm * 255) / 255  # the map as read back from an 8-bit PNG
    ij = np.asarray(jspec.spec_inverse(jnp.asarray(fa), jp_abs, signmap=jnp.asarray(sm),
                                       precision=JP()))
    it = tspec.spec_inverse(torch.from_numpy(fa), tp_abs, signmap=torch.from_numpy(sm),
                            precision=TP()).numpy()
    assert np.max(np.abs(it - ij)) <= 1e-6 * np.max(np.abs(ij))
    fj, fdc = jspec.signmap_restore(jnp.asarray(fa), jnp.asarray(sm))
    ft, tdc = tspec.signmap_restore(torch.from_numpy(fa), torch.from_numpy(sm))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(tdc.numpy(), np.asarray(fdc))
    ij = np.asarray(jspec.spec_inverse(jnp.asarray(fa), jp_abs, dc=jnp.asarray(dc),
                                       preserve_dc=True, precision=JP()))
    it = tspec.spec_inverse(torch.from_numpy(fa), tp_abs, dc=torch.from_numpy(dc),
                            preserve_dc=True, precision=TP()).numpy()
    assert np.max(np.abs(it - ij)) <= 1e-6 * np.max(np.abs(ij))
    with pytest.raises(ValueError, match="DC required"):
        tspec.spec_inverse(torch.from_numpy(fa), tp_abs, precision=TP())


def test_spec_i8_policy_matches_jax():
    """DSPFUN_PRECISION=i8 runs spec's whole-image DCTs channel-first
    through the digit contraction (K = 256 reaches it); deep i8 holds
    ~1e-7 against the JAX package's interpret-mode kernels."""
    x = _image(256, 256, seed=2)
    jp, tp = _params("copy")
    fj, _ = jspec.spec_forward(jnp.asarray(x), jp, JP(intermediate="i8"))
    ft, _ = tspec.spec_forward(torch.from_numpy(x), tp, TP(intermediate="i8"))
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= 1e-6
    back = tspec.spec_inverse(ft, tp, precision=TP(intermediate="i8"))
    assert np.max(np.abs(back.numpy() - x)) <= 1e-5


def test_compute_gain_and_range_max():
    for t in TEMPLATES:
        jp, tp = _params(t)
        assert tspec.compute_gain(tp, 384, 256) == jspec.compute_gain(jp, 384, 256)
    dcg = np.asarray([3.0, 5.0, 4.0], np.float32)
    for rt in ("one", "dc", "dcs"):
        jp = jspec.SpecChainParams(rangetype=rt)
        tp = tspec.SpecChainParams(rangetype=rt)
        np.testing.assert_array_equal(
            tspec._range_max(tp, 7.0, torch.from_numpy(dcg)).numpy(),
            np.asarray(jspec._range_max(jp, 7.0, jnp.asarray(dcg))))
    with pytest.raises(ValueError):
        tspec.spec_forward(torch.zeros((4, 4, 1)),
                           tspec.SpecChainParams(signtype="bogus"), TP())
