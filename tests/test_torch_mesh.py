"""The port's device mesh (``dspfun_tpu_torch/parallel/mesh.py``) against
the JAX package's (``dspfun_tpu/parallel/mesh.py``).

* ``mesh_from_spec``: the grammar of ``tests/test_mesh_cli.py``'s cases,
  shape for shape against the JAX function over 8 devices (the port's
  mesh takes its devices as an argument: 8 CPU ranks here).
* The layouts: a rank's coordinates are the position of its device in the
  JAX mesh's device array, for ``make_mesh`` and for ``global_mesh``'s
  (time, space) order, and the shardings name the axes the JAX
  shardings name.
* The collectives, on four CPU ranks over gloo (one pool of ranks for
  the module): ``all_to_all`` gives every rank the block of the global
  array that ``jax.lax.all_to_all(..., tiled=True)`` gives its device in
  ``shard_map`` (equal arrays); ``psum``, ``all_gather``, ``pmin`` and
  ``pmax`` of the rank index over each axis.
* The collective counts of ``tests/test_collectives.py`` as counts of
  calls issued: each chain issues as many all_to_alls, all_gathers and
  all_reduces as the JAX package's lowered program holds (computed here
  from the JAX chain at a (4, 2) mesh), at two mesh shapes.
* ``plan_row_spec``: each rank's rows of every AxisPlan field, where the
  JAX PartitionSpec puts the 'space' axis.
* A rank that raises ends the pool with its traceback; nothing waits.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_cases as cases
from dspfun_tpu.core.precision import Precision as JPrecision
from dspfun_tpu.core.transforms import plan_axis as jplan_axis
from dspfun_tpu.models import motion_pipeline as jmp
from dspfun_tpu.models.spec_pipeline import SpecChainParams as JSpecChainParams
from dspfun_tpu.parallel import mesh as jmesh
from dspfun_tpu.parallel import motion_sharded as jmsh
from dspfun_tpu.parallel import multihost as jmultihost
from dspfun_tpu.parallel import sharded as jsharded
from dspfun_tpu.parallel import spec_sharded as jss
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.models import motion_pipeline as mp
from dspfun_tpu_torch.models.spec_pipeline import SpecChainParams
from dspfun_tpu_torch.parallel import mesh as pm
from dspfun_tpu_torch.parallel import motion_sharded as msh
from dspfun_tpu_torch.parallel import multihost
from dspfun_tpu_torch.parallel import sharded
from dspfun_tpu_torch.parallel import spec_sharded as ss

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

PREC = Precision(coeff="float32", intermediate="f32")
JPREC = JPrecision(coeff="float32", intermediate="f32")
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def pool():
    with pm.RankPool(["cpu"] * 4) as p:
        yield p


@pytest.mark.parametrize("spec", ["none", "1", "", "0", "auto", "space=4,time=2",
                                  "time=2,space=4", "4", "space=2", "time=4", "space=999",
                                  "rows=2", "9"])
def test_mesh_from_spec_matches_jax(spec):
    try:
        want = jmesh.mesh_from_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            pm.mesh_from_spec(spec, CPU8)
        return
    got = pm.mesh_from_spec(spec, CPU8)
    if want is None:
        assert got is None
    else:
        assert got.shape == dict(want.shape) and got.backend == "gloo"


def test_mesh_from_spec_reads_the_environment(monkeypatch):
    monkeypatch.setenv("DSPFUN_MESH", "space=2,time=2")
    assert pm.mesh_from_spec(None, CPU8).shape == {"space": 2, "time": 2}
    assert pm.mesh_from_spec("1", CPU8) is None
    monkeypatch.delenv("DSPFUN_MESH")
    assert pm.mesh_from_spec(None, CPU8) is None
    # one card: a second slot is refused, as the JAX package refuses
    # more slots than devices
    with pytest.raises(ValueError, match="only 1 visible"):
        pm.mesh_from_spec("2", ["cuda:0"])


def test_backend_is_chosen_from_the_devices():
    assert pm.default_backend(["cpu"] * 3) == "gloo"
    assert pm.default_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert pm.default_backend(["cuda:0", "cuda:0"]) == "gloo"     # ranks that share a card
    with pytest.raises(ValueError):
        pm.default_backend(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="space\\*time"):
        pm.make_mesh(8, space=3, time=2, devices=CPU8)
    m = pm.make_mesh(4, devices=["cuda:0"] * 4)
    assert m.shape == {"space": 4, "time": 1} and m.backend == "gloo"


@pytest.mark.parametrize("space,time", [(4, 2), (2, 4), (8, 1)])
def test_rank_coordinates_are_the_jax_device_layout(space, time):
    jm = jmesh.make_mesh(8, space=space, time=time)
    m = pm.make_mesh(8, space=space, time=time, devices=CPU8)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for si in range(space):
        for ti in range(time):
            assert m.coords(int(ids[si, ti])) == {"space": si, "time": ti}


def test_global_mesh_puts_time_across_processes():
    m = multihost.global_mesh(space=2, time=4, devices=CPU8, num_processes=2)
    assert m.names == ("time", "space") and m.shape == {"space": 2, "time": 4}
    assert [m.coords(r)["time"] for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    jm = jmultihost.global_mesh(space=2, time=4)
    assert jm.axis_names == m.names and dict(jm.shape) == m.shape
    with pytest.raises(ValueError, match="multiple of the process"):
        multihost.global_mesh(space=4, time=2, devices=CPU8, num_processes=4 * 2)
    with pytest.raises(ValueError, match="multiple of the process"):
        multihost.global_mesh(space=2, time=3, devices=["cpu"] * 6, num_processes=2)


def test_shardings_name_the_jax_axes():
    m = pm.make_mesh(4, space=2, time=2, devices=["cpu"] * 4)
    jm = jmesh.make_mesh(4, space=2, time=2)
    for port, jax_ in ((sharded.cube_sharding, jsharded.cube_sharding),
                       (sharded.mask_sharding, jsharded.mask_sharding),
                       (msh.volume_sharding, jmsh.volume_sharding),
                       (ss.image_sharding, jss.image_sharding),
                       (ss.spectrum_sharding, jss.spectrum_sharding)):
        assert port(m).spec == tuple(jax_(jm).spec) + (None,) * (len(port(m).spec)
                                                                  - len(jax_(jm).spec))


def _jax_all_to_all(full, in_spec, axis, split, concat, out_spec, space, time):
    jm = jmesh.make_mesh(space * time, space=space, time=time)
    fn = shard_map(lambda x: jax.lax.all_to_all(x, axis, split_axis=split, concat_axis=concat,
                                                tiled=True),
                   mesh=jm, in_specs=P(*in_spec), out_specs=P(*out_spec), check_vma=False)
    return np.asarray(fn(jnp.asarray(full)))


A2A = [  # (in spec, axis, split, concat, out spec): the chains' swaps
    (("time", "space", None), "space", 2, 1, ("time", None, "space")),
    (("time", None, "space"), "time", 1, 0, (None, "time", "space")),
    ((None, "time", "space"), "time", 0, 1, ("time", None, "space")),
    (("time", None, "space"), "space", 1, 2, ("time", "space", None)),
]


@pytest.mark.parametrize("space,time", [(2, 2), (4, 1)])
@pytest.mark.parametrize("case", range(len(A2A)))
def test_all_to_all_is_jax_tiled(pool, case, space, time):
    in_spec, axis, split, concat, out_spec = A2A[case]
    full = np.arange(4 * 8 * 12, dtype=np.float32).reshape(4, 8, 12)
    want = _jax_all_to_all(full, in_spec, axis, split, concat, out_spec, space, time)
    mesh = pool.mesh(space=space, time=time)
    for out, c, red in pool.run(cases.collectives, mesh, full, in_spec, axis, split, concat):
        want_local = pm.Sharding(mesh, out_spec)
        sl = []
        for ax, name in enumerate(out_spec):
            n = mesh.shape[name] if name else 1
            step = want.shape[ax] // n
            i = c[name] if name else 0
            sl.append(slice(i * step, (i + 1) * step))
        np.testing.assert_array_equal(out, want[tuple(sl)])
        assert want_local.spec == out_spec
        for name in ("space", "time"):
            n = mesh.shape[name]
            members = [r for r in range(4)
                       if all(mesh.coords(r)[k] == c[k] for k in c if k != name)]
            gathered, fsum, isum, mn, mx = red[name]
            assert gathered == [float(r) for r in members] and len(members) == n
            assert fsum == [float(sum(members))] and isum == [sum(members)]
            assert mn == [float(min(members))] and mx == [float(max(members))]


def _jax_counts(lowered):
    txt = lowered.as_text()
    return {op: txt.count(f"stablehlo.{op}") for op in ("all_to_all", "all_gather", "all_reduce")}


def _port_counts(n):
    return {op: n.get(op, 0) for op in ("all_to_all", "all_gather", "all_reduce")}


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX package's collective counts for each chain (its
    test_collectives.py lowering, at a (4, 2) mesh)."""
    jm = jmesh.make_mesh(8, space=4, time=2)
    out = {}
    cs, ms = jsharded.cube_sharding(jm), jsharded.mask_sharding(jm)
    step = jax.jit(lambda a, m: jsharded.fused_filter_3d_sharded(a, m, jm, JPREC),
                   in_shardings=(cs, ms), out_shardings=cs)
    out["fused3d"] = _jax_counts(step.lower(
        jax.device_put(np.zeros((8, 16, 16, 3), np.float32), cs),
        jax.device_put(np.ones((8, 16, 16, 1), np.float32), ms)))
    geom = jmp.plan_geometry(16, 8, 4, 1, block=jmp.Dims(0, 0, 0))[0]
    vol = jax.device_put(jnp.zeros((4, 8, 16), jnp.float32), jmsh.volume_sharding(jm))
    for name, params in VOLUME_PARAMS.items():
        fn = jmsh._volume_fn(jm, geom, jmp.MotionParams(**params), 0, 1, 0, JPREC, 4, 8, 16)
        out[name] = _jax_counts(fn.lower(vol))
    jm8 = jmesh.make_mesh(8, space=8, time=1)
    params = JSpecChainParams.template("flat", gain=1000.0)
    x = jax.device_put(jnp.zeros((32, 16, 3), jnp.float32), jss.image_sharding(jm8))
    out["spec_forward"] = _jax_counts(jax.jit(
        lambda v: jss.spec_forward_sharded(v, params, jm8, JPREC)).lower(x))
    f = jax.device_put(jnp.zeros((32, 16, 3), jnp.float32), jss.spectrum_sharding(jm8))
    out["spec_inverse"] = _jax_counts(jax.jit(
        lambda v: jss.spec_inverse_sharded(v, params, jm8, precision=JPREC)).lower(f))
    return out


VOLUME_PARAMS = {
    "volume_plain": dict(boost=1.2, damp=0.5, quant=1.0, preserve_dc="dc"),
    "volume_topn": dict(coeff_limit=8),
    "volume_dither": dict(dither=True, float_pixels=False),
}


@pytest.mark.parametrize("space,time", [(2, 2), (4, 1)])
def test_collective_counts_match_jax(pool, jax_counts, space, time):
    """The fused 3-D chain is 2 forward + 2 inverse axis swaps and
    gathers nothing; the volume chain adds scalar all_reduces (DC,
    coded count), the top-N's candidate gathers and the dither's row
    gather, as many as the JAX program; spec is one swap each way."""
    mesh = pool.mesh(space=space, time=time)
    rng = np.random.default_rng(0)
    cube = rng.random((8, 16, 16, 3)).astype(np.float32)
    got = {"fused3d": pool.run(cases.fused3d, mesh, cube,
                               np.ones((8, 16, 16, 1), np.float32), PREC)[0][1]}
    geom = mp.plan_geometry(16, 8, 4, 1, block=mp.Dims(0, 0, 0))[0]
    frames = (rng.random((4, 8, 16)) * 255).astype(np.float32)
    for name, params in VOLUME_PARAMS.items():
        got[name] = pool.run(cases.volume, mesh, frames, geom, params)[0][2]
    params = SpecChainParams.template("flat", gain=1000.0)
    img = rng.random((32, 16, 3)).astype(np.float32)
    got["spec_forward"] = pool.run(cases.spec_forward, mesh, img, params, PREC)[0][2]
    f, dc, _ = pool.run(cases.spec_forward, mesh, img, params, PREC)[0]
    got["spec_inverse"] = pool.run(cases.spec_inverse, mesh, f, params, dc, PREC)[0][1]
    assert {k: _port_counts(v) for k, v in got.items()} == jax_counts
    assert jax_counts["fused3d"]["all_to_all"] == 4 and jax_counts["fused3d"]["all_gather"] == 0
    assert jax_counts["spec_forward"]["all_to_all"] == jax_counts["spec_inverse"]["all_to_all"] == 1


@pytest.mark.parametrize("intermediate", ["hilo", "exact", "i8"])
def test_plan_row_spec_takes_the_jax_rows(pool, intermediate):
    n = 264 if intermediate == "i8" else 24
    jplan = jplan_axis(n, "dct3", JPrecision(coeff="float32", intermediate=intermediate))
    spec = jmesh.plan_row_spec(jplan)
    mesh = pool.mesh(space=4)
    for rank, fields in enumerate(pool.run(cases.plan_rows, mesh, n, intermediate)):
        full, local = fields
        rows = slice(rank * n // 4, (rank + 1) * n // 4)
        for name, a in full.items():
            if a is None:
                assert local[name] is None
                continue
            ps = getattr(spec, name)
            if ps == P() or a.ndim == 0:
                np.testing.assert_array_equal(local[name], a)   # replicated
                continue
            axis = list(ps).index("space")
            sl = [slice(None)] * a.ndim
            sl[axis] = rows
            np.testing.assert_array_equal(local[name], a[tuple(sl)], err_msg=name)


def test_a_failing_rank_ends_the_pool_without_a_hang():
    with pm.RankPool(["cpu"] * 3) as pool:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one fails here"):
            pool.run(cases.fail_on_rank_one, pool.mesh(space=3))
        assert time.monotonic() - t0 < pm.TIMEOUT_S / 2
        assert not pool._procs


def test_coded_count_limbs_past_int32(pool):
    """The volume path's coded count travels as [hi, lo] base-2^15 int32
    limbs, so a sum over the ranks past 2^31 survives (the JAX package's
    own case, then a sum over four ranks of 2^30 + rank each)."""
    big = 3 * (1 << 31) + 12345
    limbs = np.asarray([big >> 15, big & 0x7FFF], np.int64)
    assert msh.coded_count(limbs) == jmsh.coded_count(limbs) == big
    got = pool.run(cases.limb_sum, pool.mesh(space=2, time=2), 1 << 30)
    assert got == [4 * (1 << 30) + 0 + 1 + 2 + 3] * 4
