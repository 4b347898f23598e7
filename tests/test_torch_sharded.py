"""The port's sharded functions on CPU ranks against the JAX package's on
its 8 forced CPU devices (``tests/conftest.py``), the same numpy inputs
from a seed through both, at small sizes.

The port runs on four gloo ranks (one pool for the module) at a (2, 2)
or (4, 1) mesh; the JAX package at the (4, 2) or (8, 1) mesh of its own
tests.  A sharded result does not depend on the mesh's shape (each rank
contracts whole columns and the float sums go in rank order), so each
is held to the JAX sharded function with the tolerance the JAX package's
own mesh tests hold its sharded function to its single-device one:

* ``parallel/sharded.py``: the fused 3-D chain (``tests/test_sharded.py``:
  2e-4) and its identity round trip (1e-4); motion's block batch over
  'space' (1e-3 pels, rtol 1e-4), ragged (coded counts equal);
* ``parallel/spec_sharded.py``: forward over the five templates (3e-5,
  DC 1e-6), round trips (5e-4), the sharded inverse of the single-device
  forward (1e-4), ``preserve_dc`` (1e-4);
* ``parallel/motion_sharded.py``: the volume chain over the parameter
  cases of ``tests/test_mesh_cli.py`` (2e-3 pels, coded counts equal),
  an expression, the ispec round trip (2e-4), dither (flips of one level
  on under 1 % of pels);
* ``models/scan_pipeline.py`` ``scan_chunks(mesh=)``: zigzag with parity,
  an odd height with parity, exact plans, minmax intermediates, i8 plans
  whose rows pad (1e-5; i8 1e-4; parity equal);
* ``models/zoom_pipeline.py``: ``zoom_frame(mesh=)`` at hilo and i8 at an
  odd view height (2e-5) and ``zoom_frame_device(mesh=)`` against
  ``zoom_frame_sharded`` (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_cases as cases
from dspfun_tpu.core.precision import Precision as JPrecision
from dspfun_tpu.models import fused as jfused
from dspfun_tpu.models import motion_pipeline as jmp
from dspfun_tpu.models import scan_pipeline as jsp
from dspfun_tpu.models import spec_pipeline as jspl
from dspfun_tpu.models import zoom_pipeline as jzp
from dspfun_tpu.ops import scan_methods as jsm
from dspfun_tpu.parallel import motion_sharded as jmsh
from dspfun_tpu.parallel import sharded as jsharded
from dspfun_tpu.parallel import spec_sharded as jss
from dspfun_tpu.parallel.mesh import make_mesh as jmake_mesh
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.models import motion_pipeline as mp
from dspfun_tpu_torch.models.spec_pipeline import SpecChainParams
from dspfun_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

PREC = Precision(coeff="float32", intermediate="f32")
JPREC = JPrecision(coeff="float32", intermediate="f32")


@pytest.fixture(scope="module")
def pool():
    with pm.RankPool(["cpu"] * 4) as p:
        yield p


@pytest.fixture(scope="module")
def jmesh42():
    return jmake_mesh(8, space=4, time=2)


@pytest.fixture(scope="module")
def jmesh8():
    return jmake_mesh(8, space=8, time=1)


# ---- parallel/sharded.py ----------------------------------------------------

@pytest.mark.parametrize("space,time", [(2, 2), (4, 1)])
def test_fused_filter_3d_sharded_matches_jax(pool, jmesh42, space, time):
    rng = np.random.default_rng(0)
    t, h, w, c = 8, 16, 24, 3
    cube = rng.random((t, h, w, c)).astype(np.float32)
    mask = jfused.lowpass_mask((t, h, w), cutoff=0.5, boost=1.25, damp=0.1)[..., None] \
        .astype(np.float32)
    cs, ms = jsharded.cube_sharding(jmesh42), jsharded.mask_sharding(jmesh42)
    ref = np.asarray(jsharded.fused_filter_3d_sharded(
        jax.device_put(cube, cs), jax.device_put(mask, ms), jmesh42, JPREC))
    got, _ = pool.run(cases.fused3d, pool.mesh(space=space, time=time), cube, mask, PREC)[0]
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


def test_fused_filter_3d_sharded_identity_round_trip(pool):
    rng = np.random.default_rng(1)
    cube = rng.random((4, 8, 16, 2)).astype(np.float32)
    got, _ = pool.run(cases.fused3d, pool.mesh(space=2, time=2), cube,
                      np.ones((4, 8, 16, 1), np.float32), PREC)[0]
    np.testing.assert_allclose(got, cube, atol=1e-4)


BLOCK_CASES = {
    # the shapes of tests/test_sharded.py: 16 blocks, then 6 blocks over
    # a space axis of 4 (the batch pads to 8 and the padding is dropped)
    "lowpass": ((32, 32, 2), (8, 8, 2), (4, 4, 1), dict(boost=1.5, damp=0.0, preserve_dc="dc")),
    "ragged": ((24, 16, 1), (8, 8, 1), None, dict(quant=2.0, preserve_dc="grey", boost=1.2)),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_shard_blocks_filter_matches_jax(pool, jmesh42, case):
    (w, h, d), (bw, bh, bd), bp_end, params = BLOCK_CASES[case]
    kw = {} if bp_end is None else {"bp_end": jmp.Dims(*bp_end)}
    jg = jmp.plan_geometry(w, h, d, 1, block=jmp.Dims(bw, bh, bd), **kw)[0]
    g = mp.plan_geometry(w, h, d, 1, block=mp.Dims(bw, bh, bd),
                         **({} if bp_end is None else {"bp_end": mp.Dims(*bp_end)}))[0]
    rng = np.random.default_rng(3)
    frames = (rng.random((d, h, w)) * 255).astype(np.float32)
    blocks = jmp.frames_to_blocks(frames, jg)
    nb = blocks.shape[0]
    bc = (np.arange(nb, dtype=np.int32) % jg.nblocks.w, np.arange(nb, dtype=np.int32) // jg.nblocks.w)
    ref, coded_ref = jsharded.shard_blocks_filter(
        jnp.asarray(blocks), jmp.make_plans(jg), bc, jnp.asarray(0), jmesh42, geom=jg,
        params=jmp.MotionParams(**params), plane_index=0, nplanes=1)
    out, coded, n = pool.run(cases.blocks, pool.mesh(space=4), frames, g,
                             mp.MotionParams(**params))[0]
    assert out.shape[0] == nb and n == {"all_gather": 2}
    np.testing.assert_array_equal(coded, np.asarray(coded_ref))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-3, rtol=1e-4)


# ---- parallel/spec_sharded.py -----------------------------------------------

@pytest.mark.parametrize("template", ["abs", "shift", "flat", "sign", "copy"])
def test_spec_forward_sharded_matches_jax(pool, jmesh8, template):
    rng = np.random.default_rng(0)
    img = rng.random((48, 40, 3)).astype(np.float32)
    jf, jdc = jss.spec_forward_sharded(
        jax.device_put(jnp.asarray(img), jss.image_sharding(jmesh8)),
        jspl.SpecChainParams.template(template, gain=1000.0), jmesh8, JPREC)
    f, dc, _ = pool.run(cases.spec_forward, pool.mesh(space=4), img,
                        SpecChainParams.template(template, gain=1000.0), PREC)[0]
    np.testing.assert_allclose(f, np.asarray(jf), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(dc, np.asarray(jdc), atol=1e-6)


@pytest.mark.parametrize("template", ["shift", "flat", "copy"])
def test_spec_round_trip_through_the_sharded_inverse(pool, jmesh8, template):
    rng = np.random.default_rng(1)
    img = rng.random((48, 40, 3)).astype(np.float32)
    params = SpecChainParams.template(template, gain=1000.0)
    mesh = pool.mesh(space=4)
    back = pool.run(cases.spec_round_trip, mesh, img, params, PREC)[0]
    np.testing.assert_allclose(back, img, atol=5e-4)
    # the sharded inverse of the single-device forward, against the JAX
    # package's sharded inverse of the same spectrum
    jparams = jspl.SpecChainParams.template(template, gain=1000.0)
    jf, jdc = jspl.spec_forward(jnp.asarray(img), jparams, JPREC)
    ref = jss.spec_inverse_sharded(jax.device_put(jf, jss.spectrum_sharding(jmesh8)), jparams,
                                   jmesh8, dc=jdc, precision=JPREC)
    got, _ = pool.run(cases.spec_inverse, mesh, np.asarray(jf), params, np.asarray(jdc), PREC)[0]
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


def test_spec_inverse_sharded_preserve_dc(pool, jmesh8):
    rng = np.random.default_rng(2)
    img = rng.random((16, 32, 3)).astype(np.float32)
    jparams = jspl.SpecChainParams.template("shift")
    jf, jdc = jspl.spec_forward(jnp.asarray(img), jparams, JPREC)
    ref = jss.spec_inverse_sharded(jax.device_put(jf, jss.spectrum_sharding(jmesh8)), jparams,
                                   jmesh8, dc=jdc, preserve_dc=True, precision=JPREC)
    got, _ = pool.run(cases.spec_inverse, pool.mesh(space=4), np.asarray(jf),
                      SpecChainParams.template("shift"), np.asarray(jdc), PREC, True)[0]
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


def test_spec_sharded_pads_an_indivisible_image(pool, jmesh8):
    """30x50 over space=4 (the port) and 8 (JAX): rows and columns pad
    with zero basis rows and columns; the true region agrees."""
    rng = np.random.default_rng(4)
    img = rng.random((30, 50, 3)).astype(np.float32)
    jparams = jspl.SpecChainParams.template("shift")
    xp = np.pad(img, ((0, 2), (0, 6), (0, 0)))
    jf, jdc = jss.spec_forward_sharded(jax.device_put(xp, jss.image_sharding(jmesh8)), jparams,
                                       jmesh8, JPREC, true_shape=(30, 50))
    xq = np.pad(img, ((0, 2), (0, 2), (0, 0)))
    f, dc, _ = pool.run(cases.spec_forward, pool.mesh(space=4), xq,
                        SpecChainParams.template("shift"), PREC, (30, 50))[0]
    np.testing.assert_allclose(f[:30, :50], np.asarray(jf)[:30, :50], atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(dc, np.asarray(jdc), atol=1e-6)


# ---- parallel/motion_sharded.py ---------------------------------------------

VOLUME_CASES = {
    "plain": {},
    "quant-dc": dict(quant=1.0, preserve_dc="dc", boost=1.3, damp=0.5),
    "threshold": dict(threshold_min=0.001, threshold_max=0.5),
    "top10": dict(coeff_limit=10),
    "top64-quant": dict(coeff_limit=64, quant=0.5),
    "spec-shift": dict(spec="shift"),
    "spec-abs": dict(spec="abs"),
    "linear": dict(linear=True),
    "int-pel": dict(float_pixels=False, boost=0.8),
    "expr": dict(expr="c*gte(x+y+z,2)"),
    "grey-bandpass": dict(preserve_dc="grey", boost=1.5, damp=0.25),
}


@pytest.fixture(scope="module")
def vol_frames():
    rng = np.random.default_rng(5)
    return (rng.random((4, 8, 16)) * 255).astype(np.float32)


def _geoms(bp=None):
    jkw = {} if bp is None else dict(bp_begin=jmp.Dims(*bp[0]), bp_end=jmp.Dims(*bp[1]))
    pkw = {} if bp is None else dict(bp_begin=mp.Dims(*bp[0]), bp_end=mp.Dims(*bp[1]))
    return (jmp.plan_geometry(16, 8, 4, 1, block=jmp.Dims(0, 0, 0), **jkw)[0],
            mp.plan_geometry(16, 8, 4, 1, block=mp.Dims(0, 0, 0), **pkw)[0])


def _jax_volume(jmesh, jg, frames, params):
    if params.get("expr"):
        from dspfun_tpu.core.expr import parse_expr
        from dspfun_tpu.tools import motion as jmotion

        params = dict(params, expr=parse_expr(params["expr"], jmotion.EXPR_NAMES))
    vol = jax.device_put(jnp.asarray(frames, jnp.float32), jmsh.volume_sharding(jmesh))
    out, coded = jmsh.motion_filter_volume_sharded(vol, jmesh, geom=jg,
                                                   params=jmp.MotionParams(**params),
                                                   plane_index=0, nplanes=1)
    return np.asarray(out), jmsh.coded_count(coded)


@pytest.mark.parametrize("case", list(VOLUME_CASES))
def test_volume_sharded_matches_jax(pool, jmesh42, vol_frames, case):
    params = VOLUME_CASES[case]
    bp = ((0, 0, 0), (4, 4, 2)) if case == "grey-bandpass" else None
    jg, g = _geoms(bp)
    ref, coded_ref = _jax_volume(jmesh42, jg, vol_frames, params)
    out, coded, _ = pool.run(cases.volume, pool.mesh(space=2, time=2), vol_frames, g, params)[0]
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=1e-6)
    assert coded == coded_ref


def test_volume_sharded_ispec_round_trip(pool, jmesh42, vol_frames):
    jg, g = _geoms()
    coeff_img, _ = jmp.filter_blocks(
        jnp.asarray(vol_frames[None], jnp.float32), jmp.make_plans(jg),
        (jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32)), jnp.asarray(0), geom=jg,
        params=jmp.MotionParams(spec="shift"), plane_index=0, nplanes=1)
    coeff = np.asarray(coeff_img)[0].astype(np.float32)
    ref, _ = _jax_volume(jmesh42, jg, coeff, dict(ispec="shift"))
    out, _, _ = pool.run(cases.volume, pool.mesh(space=4), coeff, g, dict(ispec="shift"))[0]
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-6)
    np.testing.assert_allclose(out, vol_frames, atol=2e-2)


def test_volume_sharded_dither(pool, jmesh42, vol_frames):
    """Floyd-Steinberg on whole local frames: float32 sums in another
    order may flip isolated pels by one level through the diffusion."""
    params = dict(boost=1.25, damp=0.2, dither=True, float_pixels=False)
    jg, g = _geoms()
    ref, _ = _jax_volume(jmesh42, jg, vol_frames, params)
    out, _, n = pool.run(cases.volume, pool.mesh(space=2, time=2), vol_frames, g, params)[0]
    d = np.abs(out - ref)
    assert d.max() <= 1.0 and (d > 0).mean() < 0.01
    assert n["all_gather"] == 1


def test_volume_sharded_refuses_a_stateful_expression(pool, vol_frames):
    _, g = _geoms()
    msg = pool.run(cases.volume_refused, pool.mesh(space=4), vol_frames, g,
                   "c*(1+0.1*random(0))")[0]
    assert msg is not None and "stateful av_expr" in msg


# ---- models/scan_pipeline.py ------------------------------------------------

def _jax_scan(jmesh, img, w, h, prec, plan_kw, run_kw):
    order = jsm.get_method("zigzag").build(w, h)
    coeffs = jsp.forward_coeffs(img, prec)
    plan = jsp.plan_scan(order, w, h, 3, precision=prec, **plan_kw)
    out = {"sums": [], "parity": [], "inter": []}
    orig = img if run_kw.pop("with_orig", False) else None
    for _, res in jsp.scan_chunks(plan, coeffs, orig=orig, mesh=jmesh, **run_kw):
        for k in out:
            v = getattr(res, k)
            if v is not None:
                out[k].append(v)
    return {k: np.concatenate(v) for k, v in out.items() if v}


SCAN_CASES = {  # (h, w, intermediate, plan kwargs, run kwargs, atol)
    "zigzag-parity": (32, 32, "f32", dict(step=8, nframes=16, chunk=8),
                      dict(parity_depth=8, inter_mode="unit", with_orig=True), 1e-5),
    "odd-height-parity": (21, 17, "f32", dict(step=40, nframes=9, chunk=4),
                          dict(parity_depth=8, with_orig=True), 1e-5),
    "exact": (32, 32, "exact", dict(step=16, nframes=8, chunk=4, use_pruned=False), {}, 1e-5),
    "minmax": (21, 16, "f32", dict(step=30, nframes=8, chunk=4), dict(inter_mode="minmax"), 1e-5),
    "i8-padded-rows": (258, 16, "i8", dict(step=64, nframes=3, chunk=2, use_pruned=False), {},
                       1e-4),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_chunks_sharded_matches_jax(pool, jmesh8, case):
    h, w, inter, plan_kw, run_kw, atol = SCAN_CASES[case]
    rng = np.random.default_rng(17)
    img = rng.random((h, w, 3))
    ref = _jax_scan(jmesh8, img, w, h, JPrecision(coeff="float32", intermediate=inter),
                    dict(plan_kw), dict(run_kw))
    got = pool.run(cases.scan, pool.mesh(space=4), img, ("zigzag", w, h), plan_kw,
                   Precision(coeff="float32", intermediate=inter), dict(run_kw))[0]
    assert set(got) == set(ref)
    for k in ref:
        if k == "parity":
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k].shape == ref[k].shape
            np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=atol, err_msg=k)


# ---- models/zoom_pipeline.py ------------------------------------------------

@pytest.mark.parametrize("inter,tol", [("hilo", None), ("i8", 8e-7)])
def test_zoom_frame_planned_sharded_matches_jax(pool, jmesh8, inter, tol):
    rng = np.random.default_rng(17)
    img = rng.random((15, 16, 3))
    jprec = JPrecision(coeff="float32", intermediate=inter, tol=tol)
    spec = jnp.asarray(jzp.forward_spectrum(img, jprec), jnp.float32)
    # 3x of 15 rows -> vh 45, which divides neither mesh: rows pad
    args = dict(scaling_type="interpolated", xscale=(3, 1), yscale=(3, 1), vx=0, vy=0,
                vw=48, vh=45, encode_trc=True)
    ref = np.asarray(jzp.zoom_frame(spec, precision=jprec, mesh=jmesh8, **args))
    got, n = pool.run(cases.zoom, pool.mesh(space=4), img,
                      Precision(coeff="float32", intermediate=inter, tol=tol), args, False)[0]
    assert got.shape == (45, 48, 3) and n == {"all_gather": 1}
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_zoom_frame_device_sharded_matches_jax(pool, jmesh8):
    rng = np.random.default_rng(5)
    img = rng.random((16, 24, 3))
    jprec = JPrecision(coeff="float32", intermediate="hilo")
    spec = jnp.asarray(jzp.forward_spectrum(img, jprec), jnp.float32)
    args = dict(scaling_type="interpolated", xscale=(2.5, 1), yscale=(2.5, 1), vx=3.0, vy=2.0,
                vw=40, vh=37)
    ref = np.asarray(jzp.zoom_frame_sharded(spec, mesh=jmesh8, **args))
    got, n = pool.run(cases.zoom, pool.mesh(space=4), img,
                      Precision(coeff="float32", intermediate="hilo"), args, True)[0]
    assert got.shape == (37, 40, 3) and n == {"all_gather": 1}
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
