"""The port's scan path against the JAX package's, on the CPU.

Host copies (the 17 scan methods, both serialisation formats, the glibc
random stream, ``SpecScaler``, ``plan_scan``'s schedule arrays) are held
to **equality**.  ``_scan_chunk`` (dense and pruned branches) and
``scan_chunks`` take the JAX package's own plans through
``convert.scan_plan_from_jax`` and agree within 2e-6 of the largest
value at f32/hilo; on int8 plans (contracted axes >= 256, so the digit
kernels are reached: Pallas in interpret mode there, the plain version
here) they are bit-equal.  The running sums are also held to a float64
oracle (scipy), and the parity index to the oracle's wherever the
oracle's own rounding margin exceeds that bound.
"""

import dataclasses

import numpy as np
import pytest
import scipy.fft
import torch

import jax.numpy as jnp

from dspfun_tpu.core import precision as jprec
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.io.device_pack import make_packer as jmake_packer
from dspfun_tpu.models import scan_pipeline as jsp
from dspfun_tpu.ops import scan_methods as jsm
from dspfun_tpu.ops import scan_order as jso
from dspfun_tpu.ops import speclib as jspeclib
from dspfun_tpu_torch.convert import scan_plan_from_jax
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.io.device_pack import make_packer as tmake_packer
from dspfun_tpu_torch.models import scan_pipeline as tsp
from dspfun_tpu_torch.ops import scan_methods as tsm
from dspfun_tpu_torch.ops import scan_order as tso
from dspfun_tpu_torch.ops import speclib as tspeclib
from dspfun_tpu_torch.ops.int8mm import LAUNCHES

TOL = 2e-6


@pytest.fixture
def policy():
    """Set both packages' precision policy; restored afterwards."""
    saved = (jprec._default, jprec._explicit, tprec._default, tprec._explicit)

    def set_(spec):
        jprec.set_precision(jprec.Precision.parse(spec))
        tprec.set_precision(tprec.Precision.parse(spec))
        return jprec.get_precision(), tprec.get_precision()

    yield set_
    jprec._default, jprec._explicit, tprec._default, tprec._explicit = saved


def _image(h, w, seed=0, smooth=True):
    """A seeded RGB image in [0, 1]; smooth ones keep every partial
    reconstruction inside the unit range."""
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.random((h, w, 3))
    c = rng.standard_normal((h, w, 3)) / (1.0 + np.add.outer(np.arange(h), np.arange(w)))[..., None] ** 1.5
    x = scipy.fft.idctn(c, axes=(0, 1), norm="ortho")
    x -= x.min()
    return x / x.max()


def _orders_equal(a, b):
    return (np.array_equal(a.starts, b.starts) and np.array_equal(a.ys, b.ys)
            and np.array_equal(a.xs, b.xs) and a.ys.dtype == b.ys.dtype
            and a.starts.dtype == b.starts.dtype)


METHOD_CASES = [
    ("horizontal", None), ("vertical", None), ("zigzag", None), ("random", None),
    ("random", "1234"), ("row", None), ("column", None), ("diagonal", None),
    ("mirror", None), ("box", None), ("ibox", None), ("radial", None),
    ("radial", "upward"), ("iradial", "downward"), ("magnitude", None),
    ("magnitude", "0.01"), ("evalxy", "x+y*2"), ("evalxy", "random(0)*10"),
    ("evali", "mod(i,width);floor(i/width)"), ("precomputed", "zigzag:"),
    ("precomputed", "random:7"),
]


@pytest.mark.parametrize("w,h", [(13, 9), (8, 16)])
@pytest.mark.parametrize("name,opts", METHOD_CASES)
def test_scan_method_orders_and_serialisations_equal(name, opts, w, h):
    coeffs = np.random.default_rng(5).standard_normal((h, w, 3))
    jo = jsm.get_method(name).build(w, h, 3, coeffs, opts)
    to = tsm.get_method(name).build(w, h, 3, coeffs, opts)
    assert _orders_equal(jo, to)
    for fmt in jso.SERIALIZATION_FORMATS:
        text = tso.serialize(to, fmt)
        assert text == jso.serialize(jo, fmt)
        assert _orders_equal(tso.unserialize(text), jso.unserialize(text))
    assert _orders_equal(to.inverted(), jo.inverted())
    assert to.dimensions() == jo.dimensions() and to.max_interval == jo.max_interval


def test_method_registry_file_method_and_random_stream(tmp_path):
    assert tsm.method_names() == jsm.method_names() and len(tsm.method_names()) == 17
    assert tso.SERIALIZATION_FORMATS == jso.SERIALIZATION_FORMATS
    for name in tsm.method_names():
        assert tsm.method_options(name) == jsm.method_options(name)
        assert tsm.find_method_prefix(name[:3]).name == jsm.find_method_prefix(name[:3]).name
    assert tsm.find_method_prefix("nonesuch") is None
    for seed in (0, 1, 42, 2**31 - 1):
        assert tsm._glibc_rand_stream(seed, 50) == jsm._glibc_rand_stream(seed, 50)
    order = tsm.get_method("diagonal").build(7, 5)
    for fmt in tso.SERIALIZATION_FORMATS:
        path = tmp_path / f"scan.{fmt}"
        path.write_text(tso.serialize(order, fmt))
        assert _orders_equal(tsm.get_method("file").build(7, 5, 3, None, str(path)),
                             jsm.get_method("file").build(7, 5, 3, None, str(path)))


@pytest.mark.parametrize("preset", ["abs", "shift", "flat", "signmap"])
def test_spec_scaler_equals_on_numpy(preset):
    c = np.random.default_rng(2).standard_normal((6, 5, 3)) * 3.0
    jp = jspeclib.parse_spec_params(f"preset={preset}")
    tp = tspeclib.parse_spec_params(f"preset={preset}")
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    js = jspeclib.SpecScaler(params=jp, max_input=4.0, gain=127.5)
    ts = tspeclib.SpecScaler(params=tp, max_input=4.0, gain=127.5)
    assert ts.max == js.max
    scaled = ts.scale(c)                      # xp defaults to numpy here
    assert isinstance(scaled, np.ndarray)
    np.testing.assert_array_equal(scaled, js.scale(c, xp=np))
    np.testing.assert_array_equal(ts.unscale(scaled), js.unscale(scaled, xp=np))
    np.testing.assert_array_equal(tspeclib.spec_copysign(c, c > 0),
                                  jspeclib.spec_copysign(c, c > 0, xp=np))
    assert tspeclib.PRESETS == jspeclib.PRESETS
    assert tspeclib.spec_normalization(2) == jspeclib.spec_normalization(2)
    with pytest.raises(ValueError):
        tspeclib.parse_spec_params("scale=nonesuch")


@pytest.mark.parametrize("kw", [
    dict(step=1), dict(step=7), dict(step=5, offset=3), dict(step=3, invert=True),
    dict(step=4, nframes=6, offset=2, invert=True), dict(step=1000), dict(offset=10**6),
    dict(step=2, chunk=5),
])
@pytest.mark.parametrize("method", ["zigzag", "row", "box"])
def test_plan_scan_arrays_equal(method, kw, policy):
    policy("hilo")
    w, h = 12, 10
    jo = jsm.get_method(method).build(w, h)
    to = tsm.get_method(method).build(w, h)
    jp = jsp.plan_scan(jo, w, h, 3, **kw)
    tp = tsp.plan_scan(to, w, h, 3, device="cpu", **kw)
    for f in dataclasses.fields(tsp.ScanPlan):
        if f.name == "plans_inv":
            continue
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert tp.kmax == jp.kmax and tp.use_pruned is False
    for a, b in zip(jp.plans_inv, tp.plans_inv):
        np.testing.assert_array_equal(np.asarray(a.hi), b.hi.numpy())
        np.testing.assert_array_equal(np.asarray(a.lo), b.lo.numpy())


def test_plan_scan_crossover_rule_is_the_jax_packages(policy, monkeypatch):
    """The auto rule (both sides >= 1024, kmax * 32 <= the shorter side,
    not ``exact``), without building 1024-point plans."""
    for mod in (jsp, tsp):
        monkeypatch.setattr(mod, "plan_matrix", lambda *a, **k: None)
    row = np.arange(4, dtype=np.int32)

    def order(mod):
        return mod.ScanOrder.from_lists([(row * 0 + i, row) for i in range(16)])

    for spec, (w, h, step), want in [("hilo", (1024, 1024, 8), True), ("hilo", (1024, 1023, 1), False),
                                     ("hilo", (1024, 1024, 9), False), ("exact", (1024, 1024, 1), False),
                                     ("i8", (2048, 1024, 2), True)]:
        policy(spec)
        jp = jsp.plan_scan(order(jso), w, h, 3, step=step)
        tp = tsp.plan_scan(order(tso), w, h, 3, step=step, device="cpu")
        assert jp.use_pruned == tp.use_pruned == want, (spec, w, h, step)


def _chunk_both(img, spec, policy, use_pruned, step, chunk, start=0, **kw):
    """One ``_scan_chunk`` call in both packages on the JAX package's
    plan; returns (jax outputs, port outputs) as numpy."""
    jp_, tp_ = policy(spec)
    h, w = img.shape[:2]
    jc = jsp.forward_coeffs(img, jp_)
    order = jsm.get_method("zigzag").build(w, h, 3, np.asarray(jc, np.float64), None)
    jplan = jsp.plan_scan(order, w, h, 3, step=step, chunk=chunk, use_pruned=use_pruned,
                          precision=jp_)
    tplan = scan_plan_from_jax(jplan, "cpu")
    sl = slice(start, start + chunk)
    dc = np.asarray(jc[0, 0, :])
    nodc = np.asarray(jc).copy()
    nodc[0, 0, :] = 0
    carry = np.broadcast_to(dc, (h, w, 3)).astype(np.float32).copy()
    orig = img.astype(np.float32)
    common = dict(parity_scale=255.0, use_pruned=use_pruned, want_deltas=True,
                  measure_parity=True, **kw)
    jout = jsp._scan_chunk(jnp.asarray(carry), jnp.asarray(nodc), jnp.asarray(jplan.ys[sl]),
                           jnp.asarray(jplan.xs[sl]), jnp.asarray(jplan.valid[sl]),
                           jplan.plans_inv, jnp.asarray(orig), jnp.asarray(dc), **common)
    tout = tsp._scan_chunk(torch.from_numpy(carry), torch.from_numpy(nodc), tplan.ys[sl],
                           tplan.xs[sl], tplan.valid[sl], tplan.plans_inv,
                           torch.from_numpy(orig), torch.from_numpy(dc.copy()), **common)
    return ([None if a is None else np.asarray(a) for a in jout],
            [None if a is None else a.numpy() for a in tout])


@pytest.mark.parametrize("use_pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("spec", ["f32", "hilo"])
@pytest.mark.parametrize("kw", [dict(), dict(inter_mode="unit"),
                                dict(inter_mode="minmax", encode_trc=True)],
                         ids=["plain", "unit", "minmax-trc"])
def test_scan_chunk_matches_jax(spec, use_pruned, kw, policy):
    jout, tout = _chunk_both(_image(24, 40), spec, policy, use_pruned, step=9, chunk=8,
                             start=8, **kw)
    for name, a, b in zip(("carry", "sums", "deltas", "inter"), jout, tout):
        if a is None:
            assert b is None
            continue
        tol = TOL * (12.92 if kw.get("encode_trc") and name in ("sums", "inter") else 1.0)
        assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(a))), name
    np.testing.assert_array_equal(jout[4], tout[4])


@pytest.mark.parametrize("spec,inst", [("i8", "4"), ("i8@1e-5", "3")])
def test_scan_chunk_dense_on_int8_plans_is_bit_equal(spec, inst, policy):
    """272x320: both contracted axes reach the digit kernels (>= 256);
    the digits are exact in both packages, so every output is equal."""
    LAUNCHES.clear()
    jout, tout = _chunk_both(_image(272, 320, 3), spec, policy, False, step=4000, chunk=2)
    np.testing.assert_array_equal(jout[2], tout[2])       # deltas
    np.testing.assert_array_equal(jout[1], tout[1])       # running sums
    np.testing.assert_array_equal(jout[0], tout[0])
    np.testing.assert_array_equal(jout[4], tout[4])
    assert not LAUNCHES                                   # CPU tensors: the plain version


def test_scan_chunk_pruned_on_int8_plans_reads_hi(policy):
    jout, tout = _chunk_both(_image(272, 320, 3), "i8@1e-5", policy, True, step=6, chunk=2)
    assert np.max(np.abs(jout[1] - tout[1])) <= TOL


def test_dense_scatter_duplicates_agree(policy):
    """Padded entries all write to (f, 0, 0): they must all write 0 (the
    DC is zeroed in the source), or ``index_put_`` on a card, which keeps
    any one of the duplicates, would be nondeterministic."""
    _, tp_ = policy("f32")
    img = _image(16, 20)
    tc = tsp.forward_coeffs(img, tp_, "cpu")
    order = tsm.get_method("box").build(20, 16)          # ragged frames: much padding
    plan = tsp.plan_scan(order, 20, 16, 3, step=1, chunk=8, use_pruned=False, device="cpu")
    assert (~plan.valid).any() and (plan.ys[~plan.valid] == 0).all() and (plan.xs[~plan.valid] == 0).all()
    nodc = tc.clone()
    nodc[0, 0, :] = 0.0
    v = nodc[torch.from_numpy(plan.ys.astype(np.int64)), torch.from_numpy(plan.xs.astype(np.int64))]
    assert (v[torch.from_numpy(~plan.valid)] == 0).all()
    # for every frame, every (y, x) that is written twice gets equal values
    for f in range(plan.ys.shape[0]):
        key = plan.ys[f].astype(np.int64) * 20 + plan.xs[f]
        vals = (v[f] * torch.from_numpy(plan.valid[f])[:, None]).numpy()
        for k in np.unique(key):
            assert (vals[key == k] == vals[key == k][0]).all()
    # and the result does not depend on how much padding there is
    args = dict(parity_scale=0.0, use_pruned=False, want_deltas=True, measure_parity=False)
    carry = torch.zeros(16, 20, 3)
    ys, xs, valid = plan.ys[:8], plan.xs[:8], plan.valid[:8]
    a = tsp._scan_chunk(carry, nodc, ys, xs, valid, plan.plans_inv, None, tc[0, 0], **args)
    pad = lambda m: np.concatenate([m, np.zeros_like(m)], axis=1)  # noqa: E731
    b = tsp._scan_chunk(carry, nodc, pad(ys), pad(xs), pad(valid), plan.plans_inv, None,
                        tc[0, 0], **args)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def _oracle_sums(img, plan):
    """Float64 running reconstructions [nframes, H, W, C] of the same
    schedule (scipy DCT-II / 4wh, DCT-III synthesis)."""
    h, w = img.shape[:2]
    c = scipy.fft.dctn(img.astype(np.float64), type=2, axes=(0, 1)) / (4.0 * w * h)
    grid = np.zeros_like(c)
    grid[0, 0] = c[0, 0]
    grid[plan.fill_ys, plan.fill_xs] = c[plan.fill_ys, plan.fill_xs]
    out = []
    for f in range(plan.nframes):
        ys, xs = plan.ys[f][plan.valid[f]], plan.xs[f][plan.valid[f]]
        grid[ys, xs] = c[ys, xs]
        # FFTW REDFT01 = 2N * scipy's unnormalised type-3 inverse pairing
        out.append(scipy.fft.dctn(grid, type=3, axes=(0, 1)))
    return np.stack(out)


@pytest.mark.parametrize("spec", ["f32", "hilo"])
@pytest.mark.parametrize("method,kw", [("zigzag", dict(step=23)), ("zigzag", dict(step=40, offset=100)),
                                       ("row", dict(step=1, invert=True))])
def test_scan_chunks_sums_and_parity_against_float64_oracle(spec, method, kw, policy):
    """The whole generator on an 8-bit image: running sums within 1e-5
    of the float64 oracle, parity equal to the JAX package's, and equal
    to the oracle's wherever the oracle decides beyond that bound: some
    pel differs from the original and sits further than the bound from a
    rounding boundary (no parity), or every pel does (parity as the
    oracle has it)."""
    jp_, tp_ = policy(spec)
    h, w = 24, 40
    img = np.round(_image(h, w, 4) * 255.0) / 255.0
    tc = tsp.forward_coeffs(img, tp_, "cpu")
    order = tsm.get_method(method).build(w, h, 3, tc.numpy().astype(np.float64), None)
    plan = tsp.plan_scan(order, w, h, 3, chunk=8, device="cpu", **kw)
    ref = _oracle_sums(img, plan)
    got, parity = [], []
    for start, res in tsp.scan_chunks(plan, tc, orig=img.astype(np.float32), parity_depth=8):
        assert start == len(got)
        got.extend(res.sums)
        parity.extend(res.parity)
    got = np.stack(got)
    bound = 1e-5
    assert got.shape == ref.shape and np.max(np.abs(got - ref)) <= bound
    jplan = jsp.plan_scan(jsm.get_method(method).build(w, h, 3, tc.numpy().astype(np.float64), None),
                          w, h, 3, chunk=8, precision=jp_, **kw)
    jpar = np.concatenate([r.parity for _, r in jsp.scan_chunks(
        jplan, jnp.asarray(tc.numpy()), orig=img.astype(np.float32), parity_depth=8)])
    np.testing.assert_array_equal(np.asarray(parity), jpar)
    lround = lambda x: np.sign(x) * np.floor(np.abs(x) + 0.5)  # noqa: E731
    scaled = ref * 255.0
    clear = (np.abs(scaled - np.floor(scaled) - 0.5) > bound * 255.0).reshape(len(ref), -1)
    same = (lround(scaled) == lround(img[None] * 255.0)).reshape(len(ref), -1)
    ref_par = np.all(same, axis=1)
    safe = np.any(~same & clear, axis=1) | np.all(clear, axis=1)
    assert safe.sum() >= len(ref) // 2
    np.testing.assert_array_equal(np.asarray(parity)[safe], ref_par[safe])
    if "offset" not in kw:      # an offset run with step > 1 skips indices for good
        assert safe[-1] and ref_par[-1] and parity[-1]


def test_lround_is_half_away_from_zero():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.4999, 3.0])
    assert tsp._lround(x).tolist() == [1.0, 2.0, 3.0, -1.0, -2.0, -3.0, 0.0, 3.0]
    np.testing.assert_array_equal(tsp._lround(x).numpy(), np.asarray(jsp._lround(jnp.asarray(x.numpy()))))
    assert torch.round(x).tolist()[:3] == [0.0, 2.0, 2.0]


@pytest.mark.parametrize("fmt,rng_", [("yuv444p", "jpeg"), ("yuv420p", "mpeg"),
                                      ("gray16le", "jpeg"), ("gbrpf32le", "jpeg")])
def test_scan_chunks_generator_and_packer_match_jax(fmt, rng_, policy):
    """``scan_chunks`` end to end in both packages with a device packer:
    payload bytes within one level (exact .5 boundaries), parity equal,
    the lookahead yields every chunk in order."""
    jp_, tp_ = policy("hilo")
    h, w = 18, 22
    img = _image(h, w, 6)
    jc = jsp.forward_coeffs(img, jp_)
    tc = tsp.forward_coeffs(img, tp_, "cpu")
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    jplan = jsp.plan_scan(jsm.get_method("zigzag").build(w, h), w, h, 3, step=31, chunk=4,
                          precision=jp_)
    tplan = tsp.plan_scan(tsm.get_method("zigzag").build(w, h), w, h, 3, step=31, chunk=4,
                          device="cpu")
    jprops = jvideo.parse_color_props(f"pixel_format={fmt}:color_range={rng_}")
    tprops = tvideo.parse_color_props(f"pixel_format={fmt}:color_range={rng_}")
    jpk = jmake_packer(jvideo.PIXEL_FORMATS[fmt], jprops, h, w)
    tpk = tmake_packer(tvideo.PIXEL_FORMATS[fmt], tprops, h, w)
    times = {}
    jres = list(jsp.scan_chunks(jplan, jc, orig=img.astype(np.float32), packer=jpk, encode_trc=True))
    tres = list(tsp.scan_chunks(tplan, tc, orig=img.astype(np.float32), packer=tpk, encode_trc=True,
                                times=times))
    assert [s for s, _ in tres] == [s for s, _ in jres] == list(range(0, tplan.nframes, 4))
    assert times["dispatch"] > 0 and "chunk_device_ms" not in times
    dt = tvideo.PIXEL_FORMATS[fmt].dtype
    for (_, a), (_, b) in zip(jres, tres):
        assert b.sums is None and b.payload.dtype == np.uint8
        np.testing.assert_array_equal(a.parity, b.parity)
        ja = np.frombuffer(np.asarray(a.payload).tobytes(), dt).astype(np.float64)
        tb = np.frombuffer(b.payload.tobytes(), dt).astype(np.float64)
        assert ja.shape == tb.shape
        if dt.kind == "f":
            assert np.max(np.abs(ja - tb)) <= TOL * 12.92
        else:
            assert np.max(np.abs(ja - tb)) <= 1 and np.mean(ja != tb) < 0.005


def test_forward_coeffs_divides_once(policy):
    """``F / (4wh)`` is one rounding per element (core/precision.true_div),
    equal to the JAX package's on the same float32 transform."""
    jp_, tp_ = policy("f32")
    img = _image(17, 23, 9, smooth=False)
    np.testing.assert_array_equal(np.asarray(jsp.forward_coeffs(img, jp_)),
                                  tsp.forward_coeffs(img, tp_, "cpu").numpy())
    with pytest.raises((RuntimeError, AssertionError)):
        if torch.cuda.is_available():
            raise RuntimeError("card present: the default device works")
        tsp.forward_coeffs(img, tp_)          # no device named: the card, or an error
