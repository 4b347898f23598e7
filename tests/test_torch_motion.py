"""dspfun_tpu_torch.models.motion_pipeline against
dspfun_tpu.models.motion_pipeline.

Both packages get the same plans (built by the JAX package, carried
across by ``convert.motion_plans_from_jax``) and the same numpy blocks.
Tolerances, port vs JAX:

* geometry, masks, block gathers, plans and the i8-kron digit planes:
  equal (the same numpy arithmetic, or exact index shuffles);
* the general chain at the hilo default: 1e-3 pels (0..255).  Both run
  float32 contractions, in another summation order, and the spectrogram
  and sRGB steps pass that difference through log1p/expm1/pow;
* coded-coefficient counts (quant): equal.  The seeds below put no
  coefficient on a quantiser tie, where the two orders could round to
  different levels;
* rounded 8-bit output (``float_pixels=False``, with or without
  dither): within one level on at most 0.1 % of pels;
* the fast paths: plain-kron against XLA's kron and sep against XLA's
  separable formulation, 1e-3 pels; i8-kron (on the CPU with
  ``allow_cpu``, JAX in interpret mode) on the same digit plans, 1e-3.

One intended divergence: the port's int8 kernel has no VMEM bound, so
24^3 blocks get i8-kron plans where the JAX planner returns None; that
case is compared on outputs, against the JAX package's separable path,
to the 2e-2 the JAX package holds i8-kron to (tests/test_motion_pipeline.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.core.expr import parse_expr
from dspfun_tpu.models import motion_pipeline as jmp
from dspfun_tpu_torch.convert import motion_plans_from_jax
from dspfun_tpu_torch.models import motion_pipeline as tmp

JD, TD = jmp.Dims, tmp.Dims


def _tdims(d):
    return TD(*dataclasses.astuple(d))


def _geoms(w, h, d, nplanes=1, **kw):
    """The same plan_geometry call in both packages."""
    gj = jmp.plan_geometry(w, h, d, nplanes, **kw)
    tkw = {k: _tdims(v) if isinstance(v, JD) else v for k, v in kw.items()}
    gt = tmp.plan_geometry(w, h, d, nplanes, **tkw)
    return gj, gt


def _run(gj, gt, params, blocks, plans=None, tplans=None):
    """filter_blocks in both packages on one geometry, params and blocks;
    returns numpy (out, coded) pairs.

    The JAX package sets its LAST_FAST_PATH while tracing, so a jit cache
    hit leaves it stale: the fast-path cases here use frame sizes no other
    test uses (48x32, 72x48), which keeps their traces, and the JAX
    tests' own, fresh."""
    pj, pt = jmp.MotionParams(**params), tmp.MotionParams(**params)
    plans = plans or jmp.make_plans(gj)
    nb = blocks.shape[0]
    bc = (jnp.zeros(nb, jnp.int32), jnp.zeros(nb, jnp.int32))
    oj, cj = jmp.filter_blocks(jnp.asarray(blocks), plans, bc, jnp.asarray(0),
                               geom=gj, params=pj, plane_index=0, nplanes=1)
    ot, ct = tmp.filter_blocks(torch.from_numpy(blocks),
                               tplans or motion_plans_from_jax(plans, device="cpu"), None, 0,
                               gt, pt, 0, 1)
    assert ct.dtype == torch.int32 and ct.shape == (nb,)
    return (np.asarray(oj), np.asarray(cj)), (ot.numpy(), ct.numpy())


def _blocks(g, seed=0, frames=None):
    if frames is None:
        rng = np.random.default_rng(seed)
        frames = (rng.random((g.block.d, g.source.h, g.source.w)) * 255).astype(np.float32)
    return np.ascontiguousarray(jmp.frames_to_blocks(frames, g))


GEOMETRY_GRID = [
    (33, 17, 4, 3, 1, 1, dict(block=JD(16, 16, 2))),
    (64, 48, 16, 3, 1, 1, dict(block=JD(16, 16, 16), bp_end=JD(8, 8, 4))),
    (64, 48, 16, 3, 1, 0, dict(block=JD(8, 8, 8), scaled=JD(12, 6, 8))),
    (40, 30, 9, 3, 1, 1, dict(block=JD(0, 0, 3), samesize_chroma=True)),
    (40, 30, 9, 3, 1, 1, dict(block=JD(16, 0, 3), samesize_chroma=True)),
    (40, 30, 9, 4, 2, 1, dict(block=JD(8, 8, 3), bp_begin=JD(1, 2, 0),
                              bp_end=JD(6, 5, 2))),
    (32, 16, 8, 1, 0, 0, dict()),
    (17, 9, 5, 2, 0, 0, dict(block=JD(4, 4, 0), scaled=JD(0, 8, 2))),
]


@pytest.mark.parametrize("w,h,d,nplanes,cw,ch,kw", GEOMETRY_GRID)
def test_plan_geometry_matches_jax(w, h, d, nplanes, cw, ch, kw):
    gj, gt = _geoms(w, h, d, nplanes, log2_chroma_w=cw, log2_chroma_h=ch, **kw)
    assert [dataclasses.astuple(g) for g in gt] == [dataclasses.astuple(g) for g in gj]


@pytest.mark.parametrize("boost,damp", [(1.25, 0.0), (2.0, 0.5), (1.0, 0.3)])
@pytest.mark.parametrize("kw", [dict(bp_end=JD(4, 4, 2)),
                                dict(bp_begin=JD(6, 5, 3), bp_end=JD(2, 3, 1)),
                                dict(bp_begin=JD(1, 1, 0), bp_end=JD(8, 6, 4),
                                     scaled=JD(6, 10, 4))])
def test_masks_match_jax(boost, damp, kw):
    (gj,), (gt,) = _geoms(32, 32, 4, block=JD(8, 8, 4), **kw)
    np.testing.assert_array_equal(tmp._bandpass_mult(gt, boost, damp),
                                  jmp._bandpass_mult(gj, boost, damp))
    m = gt.minbuf
    ax = [torch.arange(n) for n in (m.d, m.h, m.w)]
    np.testing.assert_array_equal(
        tmp.bandpass_mult_grid(ax[0][:, None, None], ax[1][None, :, None], ax[2][None, None, :],
                               gt, boost, damp).numpy(),
        jmp._bandpass_mult(gj, boost, damp))
    np.testing.assert_array_equal(tmp._uniform_factor(m.d, m.h, m.w),
                                  jmp._uniform_factor(m.d, m.h, m.w))
    uf = jmp._uniform_factor(m.d, m.h, m.w)
    for inverse in (False, True):
        np.testing.assert_array_equal(
            tmp._renorm_window(m.d, m.h, m.w, gt.active, inverse, "cpu").numpy(),
            np.where(jmp._region_mask(m.d, m.h, m.w, gj.active), 1.0 / uf if inverse else uf, 1.0))


@pytest.mark.parametrize("kw", [dict(), dict(bp_end=JD(4, 4, 2)), dict(bp_begin=JD(1, 0, 0)),
                                dict(bp_end=JD(8, 8, 4)), dict(block=JD(8, 8, 4), scaled=JD(4, 8, 4))])
@pytest.mark.parametrize("boost,damp", [(1.0, 0.0), (1.0, 1.0), (1.25, 0.0), (1.0, 0.5)])
def test_bandpass_identity_shortcut_is_exact(kw, boost, damp):
    """The port skips the bandpass multiply exactly when the JAX package's
    multiplier is 1 everywhere."""
    (gj,), (gt,) = _geoms(16, 16, 8, **({"block": JD(8, 8, 4)} | kw))
    ones = bool(np.all(jmp._bandpass_mult(gj, boost, damp) == 1.0))
    assert tmp._bandpass_is_identity(gt, boost, damp) == ones


@pytest.mark.parametrize("mdims,active", [((4, 6, 8), (3, 4, 5)), ((1, 1, 1), (1, 1, 1)),
                                          ((3, 17, 9), (3, 17, 9)), ((8, 8, 8), (2, 8, 5))])
@pytest.mark.parametrize("inverse", [False, True])
def test_renorm_window_equals_the_numpy_form(mdims, active, inverse):
    """The uniform renorm window built on the device from its axes equals
    the [md, mh, mw] numpy array the JAX package builds, bit for bit."""
    d, h, w = active
    uf = jmp._uniform_factor(*mdims)
    want = np.where(jmp._region_mask(*mdims, JD(w, h, d)), 1.0 / uf if inverse else uf, 1.0)
    got = tmp._renorm_window(*mdims, TD(w, h, d), inverse, "cpu")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_motion_params_compare_by_value():
    a, b = tmp.MotionParams(boost=-1.0), tmp.MotionParams(boost=-2.0)
    assert hash(a) == hash(b) and a != b  # CPython hashes -1.0 and -2.0 alike
    assert tmp.MotionParams(quant=1.0) == tmp.MotionParams(quant=1.0)
    assert tmp._fast_eligible(_geoms(16, 16, 4, block=JD(8, 8, 4))[1][0],
                              tmp.MotionParams(boost=2.0, threshold_max=1.0))


def test_frames_blocks_round_trip_matches_jax():
    (gj,), (gt,) = _geoms(40, 24, 4, block=JD(16, 8, 4))
    frames = np.random.default_rng(1).random((4, 24, 40)).astype(np.float32)
    bj = jmp.frames_to_blocks(frames, gj)
    np.testing.assert_array_equal(tmp.frames_to_blocks(frames, gt), bj)
    bt = tmp.frames_to_blocks(torch.from_numpy(frames), gt)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(tmp.blocks_to_frames(bt, gt).numpy(),
                                  jmp.blocks_to_frames(bj, gj))
    np.testing.assert_array_equal(tmp.blocks_to_frames(bj, gt), frames[:, :, :32])


def test_make_plans_match_jax():
    from dspfun_tpu.core.precision import Precision as JP
    from dspfun_tpu_torch.core.precision import Precision as TP

    (gj,), (gt,) = _geoms(32, 32, 8, block=JD(16, 8, 8), scaled=JD(4, 12, 2))
    for pol in ("hilo", "f32"):
        pj = jmp.make_plans(gj, JP(intermediate=pol))
        pt = tmp.make_plans(gt, TP(intermediate=pol), device="cpu")
        for aj, at in zip(pj[0] + pj[1], pt[0] + pt[1]):
            np.testing.assert_array_equal(at.hi.numpy(), np.asarray(aj.hi))
            if aj.lo is not None:
                np.testing.assert_array_equal(at.lo.numpy(), np.asarray(aj.lo))


GENERAL = {
    "quant": dict(quant=0.05),
    "quant+threshold": dict(quant=0.01, threshold_min=0.01, threshold_max=0.5),
    "coeff_limit": dict(coeff_limit=7),
    "coeff_limit+quant": dict(coeff_limit=40, quant=0.02),
    "preserve_dc dc": dict(preserve_dc="dc", damp=0.0, bp_begin=JD(1, 1, 0)),
    "preserve_dc grey stop": dict(preserve_dc="grey", damp=0.5, bp_begin=JD(1, 1, 0)),
    "preserve_dc grey boost": dict(preserve_dc="grey", boost=1.5),
    "spec abs": dict(spec="abs"),
    "spec shift": dict(spec="shift"),
    "spec flat": dict(spec="flat"),
    "spec copy": dict(spec="copy"),
    "linear": dict(linear=True),
    "linear+bandpass": dict(linear=True, boost=1.25, damp=0.2, bp_end=JD(4, 4, 2)),
    "upscale": dict(scaled=JD(12, 10, 6)),
    "downscale": dict(scaled=JD(4, 6, 2), boost=1.25, damp=0.0, bp_end=JD(3, 3, 1)),
}


@pytest.mark.parametrize("case", list(GENERAL))
def test_general_chain_matches_jax(case):
    params = dict(GENERAL[case])
    geo = {k: params.pop(k) for k in ("bp_begin", "bp_end", "scaled") if k in params}
    (gj,), (gt,) = _geoms(24, 16, 4, block=JD(8, 8, 4), **geo)
    (oj, cj), (ot, ct) = _run(gj, gt, params, _blocks(gj, seed=len(case)))
    assert tmp.LAST_FAST_PATH is None
    assert ot.shape == oj.shape
    assert np.max(np.abs(ot - oj)) <= 1e-3
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("ispec", ["shift", "flat", "copy"])
def test_ispectrogram_matches_jax(ispec):
    """The spectrogram decode, fed the JAX package's own spectrogram of
    the same blocks (what a user round-trips)."""
    (gj,), (gt,) = _geoms(24, 16, 4, block=JD(8, 8, 4))
    blocks = _blocks(gj, seed=5)
    (spec_j, _), _ = _run(gj, gt, dict(spec=ispec), blocks)
    (oj, _), (ot, _) = _run(gj, gt, dict(ispec=ispec), np.array(spec_j))
    assert np.max(np.abs(ot - oj)) <= 1e-3
    assert np.max(np.abs(ot - blocks)) <= 0.2  # the round trip itself


@pytest.mark.parametrize("params", [dict(quant=2.0, dither=True),
                                    dict(quant=0.5, dither=True, coeff_limit=50),
                                    dict(quant=0.05),
                                    dict(boost=1.25, damp=0.0)])
def test_rounded_output_matches_jax(params):
    (gj,), (gt,) = _geoms(32, 32, 4, block=JD(16, 16, 4), bp_end=JD(8, 8, 2))
    (oj, cj), (ot, ct) = _run(gj, gt, dict(params, float_pixels=False), _blocks(gj, 7))
    assert np.all(ot == np.round(ot)) and ot.min() >= 0 and ot.max() <= 255
    diff = np.abs(ot - oj)
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3
    np.testing.assert_array_equal(ct, cj)


def test_dither_quantises_along_scan_order():
    """Floyd-Steinberg on a constant 0.4 slice: the diffused error makes
    the running mean follow the input (rounding alone gives all zeros)."""
    pel = torch.full((1, 1, 4, 8), 0.4)
    out = tmp._dither_blocks(pel)
    assert set(out.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(out.mean()) - 0.4) <= 0.1
    assert float(torch.clamp(torch.floor(pel + 0.5), 0, 255).sum()) == 0.0


FAST = {
    "plain-kron lowpass": (JD(8, 8, 4), dict(bp_end=JD(4, 4, 2)), dict(boost=1.25, damp=0.0)),
    "plain-kron threshold": (JD(8, 8, 4), {}, dict(threshold_min=0.01, threshold_max=0.5)),
    "plain-kron identity": (JD(4, 2, 2), {}, {}),
    "sep": (JD(16, 16, 8), dict(bp_end=JD(8, 8, 4)), dict(boost=1.25, damp=0.5)),
    "sep threshold": (JD(16, 16, 8), {}, dict(threshold_min=0.02, threshold_max=1.0)),
}


@pytest.mark.parametrize("case", list(FAST))
def test_fast_paths_match_jax(case):
    block, geo, params = FAST[case]
    (gj,), (gt,) = _geoms(48, 32, block.d, block=block, **geo)
    (oj, _), (ot, ct) = _run(gj, gt, params, _blocks(gj, 3))
    want = case.split()[0]
    assert tmp.LAST_FAST_PATH == want
    assert jmp.LAST_FAST_PATH == {"plain-kron": "xla-kron", "sep": "xla-sep"}[want]
    assert np.max(np.abs(ot - oj)) <= 1e-3
    assert not ct.any()


@pytest.mark.parametrize("params", [dict(boost=1.25, damp=0.0),
                                    dict(boost=1.25, damp=0.0, threshold_min=1e-4,
                                         threshold_max=0.5)])
def test_i8_kron_matches_jax(params):
    """Both packages on the JAX package's digit plans; the port's own
    plans carry the same digits."""
    (gj,), (gt,) = _geoms(48, 32, 8, block=JD(16, 16, 8), bp_end=JD(8, 8, 4))
    kj = jmp.maybe_kron_plans(gj, jmp.MotionParams(**params), allow_cpu=True)
    kt = tmp.maybe_kron_plans(gt, tmp.MotionParams(**params), allow_cpu=True, device="cpu")
    for pj, pt in zip(kj, kt):
        np.testing.assert_array_equal(pt.digits.numpy(), np.asarray(pj.digits))
        np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pj.scale))
        assert all(f.is_contiguous() for f in pt if f is not None)
    plans = (*jmp.make_plans(gj), kj)
    (oj, _), (ot, _) = _run(gj, gt, params, _blocks(gj, 11), plans=plans)
    assert jmp.LAST_FAST_PATH == tmp.LAST_FAST_PATH == "i8-kron"
    assert np.max(np.abs(ot - oj)) <= 1e-3


def test_maybe_kron_plans_gates():
    (g,) = tmp.plan_geometry(32, 32, 8, 1, block=TD(16, 16, 8), bp_end=TD(8, 8, 4))
    ok = tmp.MotionParams(boost=1.25, damp=0.0)
    assert tmp.maybe_kron_plans(g, ok, allow_cpu=True, device="cpu") is not None
    assert tmp.maybe_kron_plans(g, ok, device="cpu") is None          # CPU without allow_cpu
    assert tmp.maybe_kron_plans(g, tmp.MotionParams(boost=1.25, damp=0.5),
                                allow_cpu=True, device="cpu") is None  # dense support
    assert tmp.maybe_kron_plans(g, tmp.MotionParams(damp=0.0, quant=1.0),
                                allow_cpu=True, device="cpu") is None  # not fast-eligible
    (g2,) = tmp.plan_geometry(16, 16, 4, 1, block=TD(8, 8, 4), bp_end=TD(4, 4, 2))
    assert tmp.maybe_kron_plans(g2, ok, allow_cpu=True, device="cpu") is None  # the kron kernel's V


def test_24_cube_blocks_diverge_on_path_not_output():
    """24^3 blocks: JAX plans nothing (its int8 tiles exceed the TPU's
    VMEM) and runs xla-sep; the port runs i8-kron.  Outputs agree to the
    int8 3-digit accuracy, 2e-2 pels."""
    (gj,), (gt,) = _geoms(72, 48, 24, block=JD(24, 24, 24), bp_end=JD(6, 6, 6))
    params = dict(boost=1.25, damp=0.0)
    assert jmp.maybe_kron_plans(gj, jmp.MotionParams(**params), allow_cpu=True) is None
    kt = tmp.maybe_kron_plans(gt, tmp.MotionParams(**params), allow_cpu=True, device="cpu")
    assert kt is not None
    jplans = jmp.make_plans(gj)
    tplans = (*motion_plans_from_jax(jplans, device="cpu"), kt)
    (oj, _), (ot, _) = _run(gj, gt, params, _blocks(gj, 12), plans=jplans, tplans=tplans)
    assert jmp.LAST_FAST_PATH == "xla-sep" and tmp.LAST_FAST_PATH == "i8-kron"
    assert np.isfinite(ot).all()
    assert np.max(np.abs(ot - oj)) <= 2e-2


@pytest.mark.parametrize("src", ["c/2", "c * ((width-x)/width) * ((depth-z)/depth)",
                                 "c*(1+bx+2*by)*gte(bz,1)*eq(i,0)", "if(lt(x+y,3), 0, c*sqrt(z+1))"])
def test_filter_blocks_eval_matches_jax(src):
    """The expression stage (motion.c:670-681) on two slabs of 2x2
    blocks: the same environment (c scaled by norm2/255, the coordinate
    grids, i, bx, by and a per-block bz), to 1e-3 pels as the general
    chain."""
    from dspfun_tpu_torch.core.expr import parse_expr as tparse

    gj, gt = _geoms(16, 16, 4, block=JD(8, 8, 2), bp_end=JD(6, 6, 2))
    gj, gt = gj[0], gt[0]
    names = ("c", "x", "y", "z", "i", "width", "height", "depth", "components",
             "bx", "by", "bz", "bwidth", "bheight", "bdepth")
    blocks = np.concatenate([_blocks(gj, seed=s) for s in (5, 6)])
    nb = blocks.shape[0]
    plans = jmp.make_plans(gj)
    bidx = np.arange(nb) % 4
    bz = np.repeat([0, 1], 4).astype(np.int32)
    pj = jmp.MotionParams(boost=1.5, damp=0.5, expr=parse_expr(src, names))
    pt = tmp.MotionParams(boost=1.5, damp=0.5, expr=tparse(src, names))
    oj, _ = jmp.filter_blocks(jnp.asarray(blocks), plans,
                              (jnp.asarray(bidx % 2, jnp.int32), jnp.asarray(bidx // 2, jnp.int32)),
                              jnp.asarray(bz), geom=gj, params=pj, plane_index=0, nplanes=1)
    ot, _ = tmp.filter_blocks(torch.from_numpy(blocks), motion_plans_from_jax(plans, device="cpu"),
                              None, torch.from_numpy(bz), gt, pt, 0, 1)
    assert tmp.LAST_FAST_PATH is None
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-3)


def test_motion_plans_from_jax_keeps_the_structure():
    (gj,), _ = _geoms(32, 32, 8, block=JD(16, 16, 8), bp_end=JD(8, 8, 4))
    kron = jmp.maybe_kron_plans(gj, jmp.MotionParams(boost=1.25, damp=0.0), allow_cpu=True)
    plans = motion_plans_from_jax((*jmp.make_plans(gj), kron), device="cpu")
    assert [len(p) for p in plans] == [3, 3, 2]
    assert plans[2][0].digits.dtype == torch.int8
    assert motion_plans_from_jax((*jmp.make_plans(gj), None), device="cpu")[2] is None


@pytest.mark.parametrize("kw,boost,damp", [(dict(bp_end=JD(4, 4, 2)), 1.25, 0.0),
                                           (dict(bp_begin=JD(6, 5, 3), bp_end=JD(2, 3, 1)), 2.0,
                                            0.5),
                                           (dict(), 1.0, 0.3)])
def test_fast_path_multipliers_equal_the_numpy_form(kw, boost, damp):
    """The fast path's ``uf`` and ``bpm``, built on the device from the
    three axes, equal the numpy arrays bit for bit, and so do the two
    constants it multiplies by (float32 of ``uf * bpm`` and of
    ``(1 / uf) / (8 vol)``, one rounding each)."""
    (gt,) = _geoms(24, 16, 8, block=JD(24, 16, 8), **kw)[1]
    p = tmp.MotionParams(boost=boost, damp=damp)
    uf, bpm = tmp._fast_multipliers(gt, p, "cpu")
    m = gt.minbuf
    uf_np, bpm_np = tmp._uniform_factor(m.d, m.h, m.w), tmp._bandpass_mult(gt, boost, damp)
    np.testing.assert_array_equal(uf.numpy(), uf_np)
    np.testing.assert_array_equal(bpm.numpy(), bpm_np)
    vol = m.volume()
    np.testing.assert_array_equal((uf * bpm).to(torch.float32).numpy(),
                                  (uf_np * bpm_np).astype(np.float32))
    np.testing.assert_array_equal(
        tmp.true_div(tmp._rdiv(1.0, uf), 8.0 * vol).to(torch.float32).numpy(),
        ((1.0 / uf_np) / (8.0 * vol)).astype(np.float32))


def test_whole_clip_fast_path_builds_nothing_on_the_host(monkeypatch):
    """``-b 0x0x0`` (one block the size of the clip): no i8-kron plan can
    contract K = vol, so the planner returns before it builds anything,
    and the chain's multipliers come from the device; the numpy builders
    are called zero times.  The output equals the JAX package's separable
    path within the module's 1e-3 pels."""
    (gj,), (gt,) = _geoms(64, 48, 64, block=JD(0, 0, 0), bp_end=JD(16, 12, 16))
    assert gt.block == gt.minbuf and gt.minbuf.volume() > 174762  # > _kmax(3)
    params = tmp.MotionParams(boost=1.25, damp=0.0)
    calls = []
    for name in ("_bandpass_mult", "_uniform_factor"):
        real = getattr(tmp, name)
        monkeypatch.setattr(tmp, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    tmp._maybe_kron_cached.cache_clear()
    for allow_cpu in (False, True):
        assert tmp.maybe_kron_plans(gt, params, allow_cpu=allow_cpu, device="cpu") is None
    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, (1, 64, 48, 64)).astype(np.float32)
    (oj, _), (ot, _) = _run(gj, gt, dict(boost=1.25, damp=0.0), blocks)
    assert tmp.LAST_FAST_PATH == "sep" and calls == []
    np.testing.assert_allclose(ot, oj, atol=1e-3)
    tmp._maybe_kron_cached.cache_clear()
