"""The port's basis path (``core/basis.py`` families, ``tools/_colorspec.py``,
``models/basis_pipeline.py``) against the JAX package's, on the CPU.

Host functions are held to **equality**: the 12 basis families and
their ``dct``/``dst`` fallbacks, ``basis_matrix``, ``parse_color``,
``gen_basis_grid``, ``realize``, ``rescale_values``, ``range_encode``,
``coeff_scale_factor``, ``render_grid`` (a strided assignment here, a
loop over the tiles there) and the ``.coeff`` files, byte for byte.
``apply_basis`` at ``f64`` on both sides agrees within 1e-12 of the
largest |value| (the two packages sum the windows in their own orders);
the port at its default policy (complex64) against the JAX package with
x64 (complex128) within 1e-5 of it.  ``draw_canvas`` at hilo within 1e-6
of the largest value, and at ``i8@1e-5`` on a 256x320 canvas, where both
contractions reach the int8 digit kernels (Pallas in interpret mode
there, the plain version here), bit for bit.
"""

import numpy as np
import pytest
import torch

from dspfun_tpu.core import basis as jbasis
from dspfun_tpu.core import precision as jprec
from dspfun_tpu.models import basis_pipeline as jb
from dspfun_tpu.tools import _colorspec as jcolor
from dspfun_tpu_torch.core import basis as tbasis
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.models import basis_pipeline as tb
from dspfun_tpu_torch.ops import int8mm as tmm
from dspfun_tpu_torch.tools import _colorspec as tcolor

FAMILIES = sorted(jbasis.BASIS_FAMILIES)


@pytest.fixture
def policy():
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)

    def set_(spec):
        jprec.set_precision(jprec.Precision.parse(spec))
        tprec.set_precision(tprec.Precision.parse(spec))
        return jprec.get_precision(), tprec.get_precision()

    yield set_
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved


def _pixels(shape, seed, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 2 - 1
    if complex_:
        x = x + 1j * (rng.random(shape) * 2 - 1)
    return x


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("ortho", [False, True])
def test_basis_families_equal(name, ortho):
    assert sorted(tbasis.BASIS_FAMILIES) == FAMILIES
    for n_len in (8, 16, 13):
        if name == "wht" and n_len == 13:
            continue
        k = np.arange(n_len, dtype=np.int64)[:, None] + np.array([0, 3])[:, None, None]
        n = np.arange(n_len, dtype=np.int64)[None, :]
        a = jbasis.BASIS_FAMILIES[name](k, n, n_len, ortho)
        b = tbasis.BASIS_FAMILIES[name](k, n, n_len, ortho)
        assert a.dtype == b.dtype == np.complex128
        assert a.tobytes() == b.tobytes(), (name, n_len)


@pytest.mark.parametrize("spec", ["DFT", "idft", "DCT", "dst", "dct1", "DCT3", "dst4",
                                  "dct7", "dst0", "dctx", "WHT", "dht"])
def test_basis_fn_fallbacks_and_matrix_equal(spec):
    assert tbasis.basis_fn(spec).__name__ == jbasis.basis_fn(spec).__name__
    n = 16
    for kk, nn, length, ortho, off in [(n, n, None, False, 0), (6, n, None, True, 3),
                                       (n, 8, n, True, -2), (4, 8, 8, False, 5)]:
        a = jbasis.basis_matrix(spec, kk, nn, length=length, ortho=ortho, offset=off)
        b = tbasis.basis_matrix(spec, kk, nn, length=length, ortho=ortho, offset=off)
        assert a.shape == b.shape == (kk, nn) and a.tobytes() == b.tobytes()


def test_basis_fn_refuses_unknown_names():
    for bad in ("fft", "haar", ""):
        with pytest.raises(ValueError, match="unknown basis family"):
            tbasis.basis_fn(bad)
        with pytest.raises(ValueError, match="unknown basis family"):
            jbasis.basis_fn(bad)


COLORS = ["black", "White", " red ", "green", "lime", "none", "transparent", "grey",
          "#fff", "#0a0", "#204080", "#20408080", "rgb(1,2,3)", "rgba(10, 20, 30, 0.5)",
          "RGB(50%, 25%, 100%)", "rgba(0,0,0,0)", "rgb(255,128,0)"]
BAD_COLORS = ["#12", "#12345", "rgb(1,2)", "rgba(1,2,3,4,5)", "chartreuse", "rgb(a,b,c)", "#ggg"]


def test_parse_color_equal():
    for spec in COLORS:
        a, b = jcolor.parse_color(spec), tcolor.parse_color(spec)
        assert a == b and all(type(x) is type(y) for x, y in zip(a, b)), spec
    for spec in BAD_COLORS:
        with pytest.raises(ValueError) as je:
            jcolor.parse_color(spec)
        with pytest.raises(ValueError) as te:
            tcolor.parse_color(spec)
        assert str(je.value) == str(te.value)


# (function, shape, terms, partsum, offset, inverse, orthogonal, complex input)
APPLY_CASES = [
    ("dct2", (16, 16), None, (1, 1), (0, 0), False, False, True),
    ("dct2", (16, 16), None, (16, 16), (0, 0), False, True, True),
    ("dct3", (16, 16), None, (16, 16), (0, 0), True, True, True),
    ("dft", (24, 16), None, (4, 2), (0, 0), False, False, False),
    ("idft", (16, 24), (8, 8), (2, 4), (1, 2), True, False, True),
    ("wht", (16, 16), (8, 4), (4, 4), (2, 0), False, True, False),
    ("dst1", (12, 20), None, (4, 3), (0, 0), False, False, True),
    ("dht", (16, 16), (16, 8), (4, 4), (0, 1), True, True, False),
    ("dct4", (8, 32), None, (8, 8), (0, 0), False, False, False),
    ("dct1", (16, 16), (12, 12), (4, 4), (3, 3), True, True, True),
]


@pytest.mark.parametrize("case", APPLY_CASES, ids=lambda c: f"{c[0]}-{'inv' if c[5] else 'fwd'}")
def test_apply_basis_matches_jax(case, policy):
    fn, shape, terms, psum, off, inv, ortho, cplx = case
    x = _pixels(shape + (3,), sum(shape), cplx)
    kw = dict(terms=terms, partsum=psum, offset=off, inverse=inv, orthogonal=ortho)
    jp_, tp_ = policy("f64:f64")
    a = jb.apply_basis(x, fn, precision=jp_, **kw)
    b = tb.apply_basis(x, fn, precision=tp_, device="cpu", **kw)
    assert a.shape == b.shape and b.dtype == np.complex128
    scale = np.abs(a).max()
    assert np.max(np.abs(a - b)) <= 1e-12 * scale
    # the tools' defaults: x64 JAX (complex128) against the port's complex64
    jprec._default, jprec._explicit = jprec.Precision(), False
    tprec._default, tprec._explicit = tprec.Precision(), False
    a = jb.apply_basis(x, fn, **kw)
    c = tb.apply_basis(x, fn, device="cpu", **kw)
    assert c.dtype == np.complex128
    assert np.max(np.abs(a - c)) <= 1e-5 * scale
    assert np.max(np.abs(b - c)) > 0          # complex64 really ran


def test_apply_basis_batch_and_stage_times(policy):
    jp_, tp_ = policy("f64:f64")
    x = _pixels((3, 16, 24, 3), 5, True)
    kw = dict(partsum=(4, 4), orthogonal=True)
    times = {}
    b = tb.apply_basis(x, "dct2", precision=tp_, device="cpu", times=times, **kw)
    assert b.shape == (3, 16, 24, 4, 6, 3)
    assert {"plan", "h2d", "compute", "d2h"} <= set(times)
    a = jb.apply_basis(x, "dct2", precision=jp_, **kw)
    assert np.max(np.abs(a - b)) <= 1e-12 * np.abs(a).max()
    for i in range(3):
        one = tb.apply_basis(x[i], "dct2", precision=tp_, device="cpu", **kw)
        assert np.max(np.abs(one - b[i])) <= 1e-12 * np.abs(a).max()
    # real families on real input contract in real arithmetic
    r = tb.apply_basis(x.real, "dct2", precision=tp_, device="cpu", **kw)
    assert np.max(np.abs(r.imag)) == 0.0


@pytest.mark.parametrize("fn", ["dct2", "dft", "wht"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("natural", [False, True])
def test_gen_basis_grid_equal(fn, inverse, natural):
    for size, terms, off in [((8, 8), None, (0, 0)), ((16, 8), (4, 2), (1, 3))]:
        a = jb.gen_basis_grid(fn, size, terms=terms, offset=off, inverse=inverse, natural=natural)
        b = tb.gen_basis_grid(fn, size, terms=terms, offset=off, inverse=inverse, natural=natural)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_realize_rescale_range_and_scale_factor_equal():
    v = _pixels((3, 4, 5, 6, 3), 9, True) * 3.0
    for plane in ("real", "imaginary", "magnitude", "phase"):
        assert jb.realize(v, plane).tobytes() == tb.realize(v, plane).tobytes()
    with pytest.raises(ValueError):
        tb.realize(v, "nonesuch")
    r = v.real
    for kinds in [("linear", None), ("log", None), ("gain", None), ("level", None),
                  ("linear", "log"), ("gain", "level")]:
        for cs in (1.0, 16.0, 256.0):
            a = jb.rescale_values(r, kinds, cs, (32, 24))
            b = tb.rescale_values(r, kinds, cs, (32, 24))
            assert a.tobytes() == b.tobytes(), (kinds, cs)
    with pytest.raises(ValueError):
        tb.rescale_values(r, ("nonesuch", None), 1.0, (4, 4))
    for kind in ("abs", "invert", "shift", "shift2", "hue"):
        assert jb.range_encode(r, kind).tobytes() == tb.range_encode(r, kind).tobytes()
    with pytest.raises(ValueError):
        tb.range_encode(r, "nonesuch")
    for fn in ("dct1", "DCT1", "dst1", "dct2", "dft", "wht"):
        for ps, inr in [((1, 1), 1), ((4, 4), 1), ((16, 8), 64)]:
            assert jb.coeff_scale_factor(fn, ps, inr) == tb.coeff_scale_factor(fn, ps, inr)


@pytest.mark.parametrize("scale,padding,bg", [(1, 1, (0, 0, 0, 1)), (3, 0, (0.1, 0.2, 0.3, 0.5)),
                                              (2, 2, (1.0, 0.0, 0.0, 1.0)), (1, 0, (0, 0, 0, 0)),
                                              (4, 3, (0.0625, 0.1875, 0.0625, 1.0))])
def test_render_grid_equals_the_tile_loop(scale, padding, bg):
    """The strided assignment against the JAX package's loop over tiles,
    with point upscaling, no padding and a background with alpha."""
    rng = np.random.default_rng(scale * 10 + padding)
    for shape in [(3, 4, 5, 6, 3), (1, 1, 7, 2, 3), (5, 2, 1, 1, 3)]:
        v = rng.random(shape) * 2 - 0.5
        a = jb.render_grid(v, scale=scale, padding=padding, bg=bg)
        b = tb.render_grid(v, scale=scale, padding=padding, bg=bg)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_coeff_files_cross_read_with_equal_bytes(tmp_path):
    v = _pixels((4, 3, 2, 5, 3), 21, True)
    ja, ta = str(tmp_path / "j.coeff"), str(tmp_path / "t.coeff")
    jb.write_coeff_file(ja, v)
    tb.write_coeff_file(ta, v)
    assert open(ja, "rb").read() == open(ta, "rb").read()
    for path in (ja, ta):
        (a, da), (b, db) = jb.read_coeff_file(path), tb.read_coeff_file(path)
        assert da == db == (15, 8) and a.tobytes() == b.tobytes()
    # a truncated dump is refused by both
    bad = str(tmp_path / "bad.coeff")
    open(bad, "wb").write(open(ta, "rb").read()[:-16])
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="truncated"):
            mod.read_coeff_file(bad)


COEFS = [(3, 3, 0.4), (2, 5, 0.2), (4, 6, 0.2), (100, 7, None), (0, 200, None)]


def test_draw_canvas_hilo(policy):
    jp_, tp_ = policy("hilo")
    a = jb.draw_canvas((64, 48), COEFS[:3], jp_)
    b = tb.draw_canvas((64, 48), COEFS[:3], tp_, device="cpu")
    assert a.shape == b.shape == (48, 64) and b.dtype == np.float64
    assert np.max(np.abs(a - b)) <= 1e-6 * np.abs(a).max()


def test_draw_canvas_i8_is_bit_equal(policy, monkeypatch):
    """256x320 at i8@1e-5: both contractions of the DCT-III reach the
    digit kernels: left along H, then the right form on the squeezed
    [H, W] grid (the JAX package takes the batched left form with one
    column there; the digits and scales are the same)."""
    jp_, tp_ = policy("i8@1e-5")
    calls = []
    plain = tmm._i8_groups
    monkeypatch.setattr(tmm, "_i8_groups", lambda a, x, layout: calls.append(
        (layout, tuple(a.shape), tuple(x.shape))) or plain(a, x, layout))
    b = tb.draw_canvas((320, 256), COEFS, tp_, device="cpu")
    assert calls == [("left", (3, 256, 256), (3, 1, 256, 320)),
                     ("right", (3, 320, 384), (3, 1, 256, 320))]
    a = jb.draw_canvas((320, 256), COEFS, jp_)
    np.testing.assert_array_equal(a, b)
    # and within the policy's budget of a float64 DCT-III
    ref = tb.draw_canvas((320, 256), COEFS, tprec.Precision.parse("f64:f64"), device="cpu")
    assert np.max(np.abs(b - ref)) <= 1e-5 * np.abs(ref).max()


def test_apply_basis_and_draw_default_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tb.apply_basis(np.zeros((4, 4, 3)), "dct2")
    with pytest.raises((RuntimeError, AssertionError)):
        tb.draw_canvas((8, 8), [(1, 1, 0.5)])


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_scan_basis_matrix_is_pinned(n):
    np.testing.assert_array_equal(tbasis.scan_basis_matrix(n), jbasis.scan_basis_matrix(n))
