"""The port's zoom path against the JAX package's, on the CPU.

Host functions (``zoom_scaled_basis``, ``clamp_scale``,
``padded_zoom_basis``, ``device_basis_accurate``, the showsamples and
view helpers) are held to **equality**.  ``_device_basis`` is held to
4 float32 ulps of the JAX package's (``cos`` differs by an ulp between
XLA's CPU and PyTorch) and, inside ``device_basis_accurate``'s bounds, to
3e-6 of the float64 ``padded_zoom_basis``.  ``_synthesize`` (on the JAX
package's own plans through ``convert.zoom_plans_from_jax``), ``_synth``
and the two frame functions agree within 2e-6 of the largest value in
linear light at f32/hilo; on int8 digits (contracted axes >= 256: Pallas
in interpret mode there, the plain version here) they are bit-equal.
"""

import numpy as np
import pytest
import scipy.fft
import torch

import jax.numpy as jnp

from dspfun_tpu.core import basis as jbasis
from dspfun_tpu.core import precision as jprec
from dspfun_tpu.models import zoom_pipeline as jz
from dspfun_tpu_torch.convert import zoom_plans_from_jax
from dspfun_tpu_torch.core import basis as tbasis
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.models import zoom_pipeline as tz
from dspfun_tpu_torch.ops import int8mm as tmm

TOL = 2e-6
ULP4 = 4 * 2.0**-23


@pytest.fixture
def policy():
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)

    def set_(spec):
        jprec.set_precision(jprec.Precision.parse(spec))
        tprec.set_precision(tprec.Precision.parse(spec))
        return jprec.get_precision(), tprec.get_precision()

    yield set_
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved
    tz._zoom_plan_cached.cache_clear()


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((h, w, 3)) / (1.0 + np.add.outer(np.arange(h), np.arange(w)))[..., None] ** 1.5
    x = scipy.fft.idctn(c, axes=(0, 1), norm="ortho")
    x -= x.min()
    return x / x.max()


BASIS_CASES = [(st, num, den, off, nv, n)
               for st in ("interpolated", "native", "centered")
               for num, den, off, nv, n in [(4.0, 1.0, 0.0, 40, 10), (3.0, 2.0, -2.5, 17, 12),
                                            (1.0, 3.0, 1.25, 5, 15), (1.0, 2.0, 0.0, 7, 15),
                                            (0.01, 1.0, 0.0, 3, 8), (1.0, 1.0, 7.0, 9, 9)]]


@pytest.mark.parametrize("st,num,den,off,nv,n", BASIS_CASES)
def test_zoom_scaled_basis_and_padded_basis_equal(st, num, den, off, nv, n):
    jb, jn = jbasis.zoom_scaled_basis(st, num, den, off, nv, n)
    tb, tn = tbasis.zoom_scaled_basis(st, num, den, off, nv, n)
    assert jn == tn
    np.testing.assert_array_equal(jb, tb)
    np.testing.assert_array_equal(jz.padded_zoom_basis(st, num, den, off, nv, n),
                                  tz.padded_zoom_basis(st, num, den, off, nv, n))
    assert tbasis.clamp_scale(n, num, den) == jbasis.clamp_scale(n, num, den)
    assert tz.clamp_scale is tbasis.clamp_scale
    with pytest.raises(ValueError):
        tbasis.zoom_scaled_basis("nonesuch", num, den, off, nv, n)


def test_host_helpers_equal():
    for st in ("interpolated", "native", "centered"):
        for args in [(64, 48, 0.0, 0.0, (4.0, 1.0), (4.0, 1.0), 16, 12),
                     (1920, 1080, 100.0, 50.0, (4.0, 1.0), (4.0, 1.0), 1920, 1080),
                     (320, 200, -3.0, 2.5, (3.0, 2.0), (3.0, 2.0), 200, 100),
                     (64, 64, 0.0, 0.0, (1.0, 3.0), (1.0, 3.0), 300, 300),
                     (512, 512, 12.0, 0.0, (2.0, 1.0), (2.0, 1.0), 256, 256),
                     (40, 40, 0.5, 0.0, (2.5, 1.0), (2.0, 1.0), 33, 33),
                     (8, 8, 0.0, 0.0, (1.0, 1.0), (1.0, 9.0), 9, 9)]:
            assert tz.device_basis_accurate(*args, st) == jz.device_basis_accurate(*args, st), (st, args)
    assert tz._SCALING_IDS == jz._SCALING_IDS
    for a in [(0.0, 4.0, 30), (13.7, 3.0, 50), (5.0, 2.5, 21)]:
        assert tz.showsamples_coords(*a) == jz.showsamples_coords(*a)
    rng = np.random.default_rng(0)
    for mode in ("none", "point", "grid"):
        f = rng.random((20, 30, 3))
        np.testing.assert_array_equal(tz.overlay_showsamples(f.copy(), mode, 3.0, 2.0, 4.0, 1.0),
                                      jz.overlay_showsamples(f.copy(), mode, 3.0, 2.0, 4.0, 1.0))
    assert tz.default_view(33, 21, (3.0, 2.0), (5.0, 4.0)) == jz.default_view(33, 21, (3.0, 2.0), (5.0, 4.0))
    for flags in [(False, False, False), (True, False, False), (False, True, False), (False, False, True)]:
        a = (10.0, 20.0, 64, 48, 100, 80, (2.0, 1.0), (3.0, 2.0)) + flags
        assert tz.resolve_position(*a) == jz.resolve_position(*a)


DEVICE_BASIS_CASES = [
    # scaling, num, den, offset, nvectors, sampling_len, inside the accuracy bounds
    ("interpolated", 4.0, 1.0, 0.0, 128, 64, True),
    ("interpolated", 4.0, 1.0, -12.0, 128, 64, True),     # negative ki: remainder, not fmod
    ("interpolated", 2.0, 1.0, 37.0, 300, 272, True),
    ("interpolated", 1.0, 2.0, 3.0, 40, 96, True),         # downscale: ncomp < l
    ("interpolated", 1.0, 3.0, 0.0, 9, 15, True),          # l*num/den = 5.0
    ("interpolated", 1.0, 2.0, 0.0, 9, 15, True),          # 7.5: floor(x + 0.5), not half-even
    ("interpolated", 3.0, 1.0, -3.5, 50, 40, False),       # k not representable
    ("centered", 2.0, 1.0, 5.0, 60, 33, False),
    ("centered", 4.0, 1.0, -7.0, 60, 64, False),
    ("native", 4.0, 1.0, 0.0, 128, 64, True),
    ("native", 3.0, 2.0, -5.0, 77, 48, True),              # integer num/den: the int32 fold
    ("native", 2.5, 1.0, 1.0, 40, 32, False),              # fractional: the direct phase
    ("interpolated", 0.001, 1.0, 0.0, 4, 16, True),        # clamped to one sample
]


@pytest.mark.parametrize("st,num,den,off,nv,l,accurate", DEVICE_BASIS_CASES)
def test_device_basis_against_jax_and_float64(st, num, den, off, nv, l, accurate):
    sid = tz._SCALING_IDS[st]
    jb = np.asarray(jz._device_basis(jnp.asarray(sid), jnp.float32(num), jnp.float32(den),
                                     jnp.float32(off), nv, l, jnp.float32))
    tb = tz._device_basis(sid, torch.tensor(num), torch.tensor(den), torch.tensor(off), nv, l,
                          torch.float32)
    assert tb.dtype == torch.float32 and tuple(tb.shape) == (nv, l)
    tb = tb.numpy()
    # the phase itself is float32 in both: where it rounds differently
    # the cosines differ by that ulp times pi, still within a few ulps
    assert np.max(np.abs(tb - jb)) <= (ULP4 if accurate else 2e-5), np.max(np.abs(tb - jb))
    ref = tz.padded_zoom_basis(st, num, den, off, nv, l)
    assert np.array_equal(tb == 0, ref == 0) or not accurate
    if accurate:
        assert np.max(np.abs(tb - ref)) <= 3e-6
    b0 = tz._device_basis(sid, torch.tensor(num), torch.tensor(den), torch.tensor(off), nv - 3, l,
                          torch.float32, b0=3).numpy()
    np.testing.assert_array_equal(b0, tb[3:])


def test_device_basis_uses_remainder_semantics():
    """``jnp.mod`` takes the divisor's sign; with ``fmod`` a negative
    offset would mirror the phase."""
    tb = tz._device_basis(0, torch.tensor(2.0), torch.tensor(1.0), torch.tensor(-9.0), 8, 16,
                          torch.float32).numpy()
    ref = tz.padded_zoom_basis("interpolated", 2.0, 1.0, -9.0, 8, 16)
    assert np.max(np.abs(tb - ref)) <= 3e-6


def _spectra(img, jp_, tp_):
    js = jz.forward_spectrum(img, jp_)
    ts = tz.forward_spectrum(img, tp_, "cpu")
    return js, ts


VIEW = ("interpolated", (3.0, 1.0), (2.0, 1.0), 6.0, 4.0, 50, 44)


@pytest.mark.parametrize("spec", ["f32", "hilo", "f32@1e-5"])
@pytest.mark.parametrize("st", ["interpolated", "centered", "native"])
def test_synthesize_on_jax_plans(spec, st, policy):
    jp_, tp_ = policy(spec)
    js, ts = _spectra(_image(24, 40), jp_, tp_)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jplans = jz.zoom_plan(st, *VIEW[1:], 40, 24, jp_)
    tplans = zoom_plans_from_jax(jplans, "cpu")
    own = tz.zoom_plan(st, *VIEW[1:], 40, 24, tp_, "cpu")
    for a, b in zip(tplans, own):
        assert torch.equal(a.hi, b.hi) and (a.lo is None) == (b.lo is None)
    for trc in (False, True):
        a = np.asarray(jz._synthesize(js, *jplans, jp_, trc))
        b = tz._synthesize(ts, *tplans, tp_, trc).numpy()
        assert a.shape == b.shape == (44, 50, 3)
        assert np.max(np.abs(a - b)) <= TOL * (12.92 if trc else 1.0) * max(1.0, np.max(np.abs(a)))


@pytest.mark.parametrize("spec,nd", [("i8", 4), ("i8@1e-5", 3)])
def test_synthesize_on_int8_plans_is_bit_equal(spec, nd, policy, monkeypatch):
    """272x320 source: both contractions reach the digit kernels.  The
    [C, H, W] chain takes the batched-left form, then the right form,
    and hands the frame back as a view (no transposed copy)."""
    jp_, tp_ = policy(spec)
    js, ts = _spectra(_image(272, 320, 2), jp_, tp_)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    view = ("interpolated", (2.0, 1.0), (2.0, 1.0), 10.0, 20.0, 96, 80)
    jplans = jz.zoom_plan(*view, 320, 272, jp_)
    tplans = zoom_plans_from_jax(jplans, "cpu")
    assert tplans[0].digits.shape[0] == nd and tplans[0].digits.dtype == torch.int8
    calls = []
    plain = tmm._i8_groups
    monkeypatch.setattr(tmm, "_i8_groups", lambda a, x, layout: calls.append(
        (layout, tuple(a.shape), tuple(x.shape))) or plain(a, x, layout))
    out = tz._synthesize(ts, *tplans, tp_, False)
    assert calls == [("left", (nd, 80, 384), (nd, 3, 272, 320)),
                     ("right", (nd, 96, 384), (nd, 1, 3 * 80, 320))]
    assert tuple(out.shape) == (80, 96, 3) and out.stride() == (96, 1, 80 * 96)
    # the digit chain itself, before the division: every bit equal
    from dspfun_tpu.core.transforms import apply_plan_nd as japply
    from dspfun_tpu_torch.core.transforms import apply_plan_nd as tapply

    jraw = np.asarray(japply(jnp.moveaxis(js, -1, 0), jplans, (1, 2), jp_, split="zero0"))
    traw = tapply(ts.movedim(-1, 0), tplans, (1, 2), tp_, split="zero0").numpy()
    np.testing.assert_array_equal(jraw, traw)
    # ``out / (h * w)``: XLA compiles the jitted division by a constant
    # as a product with its rounded reciprocal, the port divides once
    # (core/precision.true_div), so the frames differ by at most an ulp
    jout = np.asarray(jz._synthesize(js, *jplans, jp_, False))
    assert np.max(np.abs(jout - out.numpy()) / np.maximum(np.abs(jout), 2.0**-20)) <= 2.0**-23
    np.testing.assert_array_equal(out.numpy(), traw.transpose(1, 2, 0) / np.float32(272 * 320))
    a = np.asarray(jz._synthesize(js, *jplans, jp_, True))
    b = tz._synthesize(ts, *tplans, tp_, True).numpy()
    assert np.max(np.abs(a - b)) <= TOL * 12.92


@pytest.mark.parametrize("spec", ["f32", "hilo", "i8"])
def test_synth_float_branch(spec, policy):
    """Without a tolerance on an int8 policy, and on every other policy,
    ``_synth`` is two full float32 products."""
    jp_, tp_ = policy(spec)
    js, ts = _spectra(_image(24, 40, 1), jprec.Precision(), tprec.Precision())
    yb = tz.padded_zoom_basis("interpolated", 2.0, 1.0, 3.0, 44, 24).astype(np.float32)
    xb = tz.padded_zoom_basis("interpolated", 3.0, 1.0, 6.0, 50, 40).astype(np.float32)
    a = np.asarray(jz._synth(js, jnp.asarray(yb), jnp.asarray(xb), False, jp_))
    b = tz._synth(ts, torch.from_numpy(yb), torch.from_numpy(xb), False, tp_)
    assert tuple(b.shape) == (44, 50, 3)
    assert np.max(np.abs(a - b.numpy())) <= TOL * max(1.0, np.max(np.abs(a)))


def test_synth_int8_branch_is_bit_equal_and_splits_both_operands(policy, monkeypatch):
    """``i8@tol`` at >= 256: the first caller of ``i8_contract_rt``.  Both
    operands are split at run time; the basis's padded columns are zero
    digits; the batched-left form is the one taken."""
    jp_, tp_ = policy("i8@1e-5")
    js, ts = _spectra(_image(272, 320, 5), jp_, tp_)
    yb = tz.padded_zoom_basis("interpolated", 2.0, 1.0, 3.0, 70, 272).astype(np.float32)
    xb = tz.padded_zoom_basis("interpolated", 2.0, 1.0, 6.0, 90, 320).astype(np.float32)
    calls = []
    plain = tmm._i8_groups

    def spy(a, x, layout):
        calls.append((layout, tuple(a.shape), tuple(x.shape)))
        k = x.shape[2] if layout == "left" else x.shape[3]
        assert a.dtype == x.dtype == torch.int8 and not a[:, :, k:].any()
        return plain(a, x, layout)

    monkeypatch.setattr(tmm, "_i8_groups", spy)
    out = tz._synth(ts, torch.from_numpy(yb), torch.from_numpy(xb), False, tp_)
    assert calls == [("left", (3, 70, 384), (3, 3, 272, 320)),
                     ("right", (3, 90, 384), (3, 1, 3 * 70, 320))]
    jout = np.asarray(jz._synth(js, jnp.asarray(yb), jnp.asarray(xb), False, jp_))
    # equal digits and group sums; the closing division differs by at
    # most an ulp (a reciprocal product under jit, one division here)
    assert np.max(np.abs(jout - out.numpy()) / np.maximum(np.abs(jout), 2.0**-20)) <= 2.0**-23
    # below 256 the same policy takes the float products
    calls.clear()
    small = tz.forward_spectrum(_image(24, 40), tp_, "cpu")
    tz._synth(small, torch.from_numpy(yb[:, :24].copy()), torch.from_numpy(xb[:, :40].copy()), False, tp_)
    assert calls == []


@pytest.mark.parametrize("spec,hw", [("hilo", (24, 40)), ("f32", (24, 40)), ("i8@1e-5", (272, 320))])
@pytest.mark.parametrize("st", ["interpolated", "native"])
def test_frame_functions_match_jax(spec, hw, st, policy):
    jp_, tp_ = policy(spec)
    h, w = hw
    js, ts = _spectra(_image(h, w, 8), jp_, tp_)
    args = (st, (2.0, 1.0), (2.0, 1.0), 4.0, 8.0, 60, 40)
    assert tz.device_basis_accurate(60, 40, 4.0, 8.0, (2.0, 1.0), (2.0, 1.0), w, h, st)
    ref = np.asarray(jz.zoom_frame(js, *args, precision=jp_))
    got = tz.zoom_frame(ts, *args, precision=tp_).numpy()
    assert np.max(np.abs(ref - got)) <= TOL * max(1.0, np.max(np.abs(ref)))
    dref = np.asarray(jz.zoom_frame_device(js, *args))
    dgot = tz.zoom_frame_device(ts, *args).numpy()
    # the device bases differ by an ulp of cos between the packages;
    # through w + h terms that stays far below the 1e-5 gate
    assert np.max(np.abs(dref - dgot)) <= 5e-6
    # and the device route agrees with the float64-basis route (this
    # image's spectrum decays slowly: a float32 basis error of 5e-7 adds
    # up over its w + h terms)
    assert np.max(np.abs(dgot - got)) <= 3e-5
    enc = tz.zoom_frame_device(ts, *args, encode_trc=True).numpy()
    assert np.max(np.abs(enc - np.asarray(jz.zoom_frame_device(js, *args, encode_trc=True)))) <= 5e-6 * 12.92


def test_zoom_still_against_float64_synthesis(policy):
    """The port's own gate: a 2x still through the planned route within
    1e-5 (after the OETF) of a float64 synthesis from the float64 basis."""
    from dspfun_tpu_torch.io.color import srgb_encode

    _, tp_ = policy("hilo")
    img = _image(48, 64, 11)
    ts = tz.forward_spectrum(img, tp_, "cpu")
    got = tz.zoom_frame(ts, "interpolated", (2.0, 1.0), (2.0, 1.0), 0.0, 0.0, 128, 96,
                        precision=tp_, encode_trc=True).numpy()
    c = scipy.fft.dctn(img, type=2, axes=(0, 1))
    yb = tz.padded_zoom_basis("interpolated", 2.0, 1.0, 0.0, 96, 48)
    xb = tz.padded_zoom_basis("interpolated", 2.0, 1.0, 0.0, 128, 64)
    ref = srgb_encode(np.einsum("jv,vuc,iu->jic", yb, c, xb) / (48 * 64))
    assert np.max(np.abs(got - ref)) <= 1e-5
    # at integer positions of a 2x zoom the input comes back (odd samples)
    assert np.max(np.abs(srgb_encode(img) - ref[::2, ::2][:48, :64])) > 0  # half-sample shift
    assert np.isfinite(got).all()


def test_zoom_plan_cache_is_keyed_on_precision_and_device(policy):
    policy("hilo")
    args = ("interpolated", (2.0, 1.0), (2.0, 1.0), 0.0, 0.0, 16, 12, 8, 6)
    tz._zoom_plan_cached.cache_clear()
    hilo = tprec.get_precision()
    a = tz.zoom_plan(*args, hilo, "cpu")
    assert tz.zoom_plan(*args, tprec.Precision.parse("hilo"), torch.device("cpu")) is a
    assert tz._zoom_plan_cached.cache_info().hits == 1
    b = tz.zoom_plan(*args, tprec.Precision(intermediate="f32"), "cpu")
    assert b is not a and b[0].lo is None and a[0].lo is not None
    c = tz.zoom_plan(*args, hilo, "meta")
    assert c is not a and c[0].hi.device.type == "meta"
    d = tz.zoom_plan(*args, tprec.Precision(intermediate="hilo", tol=1e-5), "cpu")
    assert d is not a
    assert tz._zoom_plan_cached.cache_info().maxsize == 4
    # "cuda" and the tensor's own "cuda:0" are one key (the tool names the
    # first, ``zoom_frame`` the second: a miss builds a 4x plan twice)
    import unittest.mock as mock

    with mock.patch.object(torch.cuda, "current_device", lambda: 0):
        assert tz._device_key("cuda") == tz._device_key(torch.device("cuda", 0)) == "cuda:0"
    assert tz._device_key("cuda:1") == "cuda:1" and tz._device_key("cpu") == "cpu"
    assert tz.zoom_plan(*args, None, "cpu") is a            # the policy in force: hilo


def test_i8_contract_rt_pads_the_basis_with_zero_digits():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((20, 300)).astype(np.float32)
    x = rng.standard_normal((3, 300, 40)).astype(np.float32)
    seen = {}
    plain = tmm._i8_groups
    try:
        tmm._i8_groups = lambda ad, xd, layout: seen.update(ad=ad.clone()) or plain(ad, xd, layout)
        y = tmm.i8_contract_rt(torch.from_numpy(x), torch.from_numpy(a), 1)
    finally:
        tmm._i8_groups = plain
    assert tuple(seen["ad"].shape) == (3, 20, 384) and not seen["ad"][:, :, 300:].any()
    ref = np.einsum("mk,ckr->cmr", a.astype(np.float64), x.astype(np.float64))
    assert np.max(np.abs(y.numpy() - ref)) <= 2.0**-16 * np.max(np.abs(ref))
