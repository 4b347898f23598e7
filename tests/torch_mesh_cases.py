"""Rank-side cases of the port's mesh tests.

Each function runs inside every rank of a
``dspfun_tpu_torch.parallel.mesh.RankPool`` as ``fn(mesh, *args)``: it
cuts its own shard from the full numpy input every rank was given, runs
the port's sharded function on it, counts the collectives the call
issued, gathers the result and returns numpy.  This module imports
neither JAX nor the JAX package (the ranks are plain torch processes);
the test modules compare what rank 0 returns with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dspfun_tpu_torch.core.expr import parse_expr
from dspfun_tpu_torch.models import motion_pipeline as mp
from dspfun_tpu_torch.parallel import mesh as pm
from dspfun_tpu_torch.parallel import motion_sharded as msh
from dspfun_tpu_torch.parallel import sharded
from dspfun_tpu_torch.parallel import spec_sharded as ss

MOTION_EXPR_NAMES = ("c", "x", "y", "z", "i", "width", "height", "depth",
                     "components", "bx", "by", "bz", "bwidth", "bheight", "bdepth")


def _t(a, mesh):
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)


def _counted(fn):
    pm.COUNTS.clear()
    out = fn()
    return out, {k: v for k, v in pm.COUNTS.items() if v}


def collectives(mesh, full, spec, axis, split, concat):
    """all_to_all on this rank's slice, then the float and integer psum
    and the all_gather of the rank index over each axis."""
    x = pm.Sharding(mesh, spec)(_t(full, mesh))
    out = pm.all_to_all(x, mesh, axis, split, concat)
    r = torch.tensor([float(mesh.rank)], device=mesh.device)
    return (out.cpu().numpy(), mesh.coords(),
            {a: (pm.all_gather(r, mesh, a).tolist(), pm.psum(r, mesh, a).tolist(),
                 pm.psum(r.to(torch.int64), mesh, a).tolist(),
                 pm.pmin(r, mesh, a).tolist(), pm.pmax(r, mesh, a).tolist())
             for a in ("space", "time")})


def fused3d(mesh, cube, mask, prec):
    cs, ms = sharded.cube_sharding(mesh), sharded.mask_sharding(mesh)
    out, n = _counted(lambda: sharded.fused_filter_3d_sharded(
        cs(_t(cube, mesh)), ms(_t(mask, mesh)), mesh, prec))
    return cs.gather(out).cpu().numpy(), n


def blocks(mesh, frames, geom, params, bz=0):
    blk = mp.frames_to_blocks(_t(frames, mesh), geom).contiguous()
    plans = mp.make_plans(geom, device=mesh.device)
    (out, coded), n = _counted(lambda: sharded.shard_blocks_filter(
        blk, plans, None, bz, mesh, geom=geom, params=params, plane_index=0, nplanes=1))
    return out.cpu().numpy(), coded.cpu().numpy(), n


def _motion_params(params: dict):
    params = dict(params)
    if params.get("expr") is not None:
        params["expr"] = parse_expr(params["expr"], MOTION_EXPR_NAMES)
    return mp.MotionParams(**params)


def volume(mesh, frames, geom, params: dict, bz=0):
    vs = msh.volume_sharding(mesh)
    (out, coded), n = _counted(lambda: msh.motion_filter_volume_sharded(
        vs(_t(frames, mesh)), mesh, geom=geom, params=_motion_params(params),
        plane_index=0, nplanes=1, bz=bz))
    return vs.gather(out).cpu().numpy(), msh.coded_count(coded), n


def volume_refused(mesh, frames, geom, expr: str):
    try:
        volume(mesh, frames, geom, {"expr": expr})
    except ValueError as e:
        return str(e)
    return None


def spec_forward(mesh, img, params, prec, true_shape=None):
    x = ss.image_sharding(mesh)(_t(img, mesh))
    (f, dc), n = _counted(lambda: ss.spec_forward_sharded(x, params, mesh, prec, true_shape))
    return ss.spectrum_sharding(mesh).gather(f).cpu().numpy(), dc.cpu().numpy(), n


def spec_inverse(mesh, f, params, dc, prec, preserve_dc=False, true_shape=None):
    x = ss.spectrum_sharding(mesh)(_t(f, mesh))
    y, n = _counted(lambda: ss.spec_inverse_sharded(
        x, params, mesh, dc=dc, preserve_dc=preserve_dc, precision=prec, true_shape=true_shape))
    return ss.image_sharding(mesh).gather(y).cpu().numpy(), n


def spec_round_trip(mesh, img, params, prec):
    f, dc, _ = spec_forward(mesh, img, params, prec)
    return spec_inverse(mesh, f, params, dc, prec)[0]


def scan(mesh, img, order_args, plan_kw, prec, run_kw):
    from dspfun_tpu_torch.models import scan_pipeline as sp  # noqa: PLC0415
    from dspfun_tpu_torch.ops import scan_methods as sm  # noqa: PLC0415

    method, w, h = order_args
    order = sm.get_method(method).build(w, h)
    coeffs = sp.forward_coeffs(img, prec, mesh.device)
    plan = sp.plan_scan(order, w, h, img.shape[2], precision=prec, device=mesh.device, **plan_kw)
    out = {"sums": [], "parity": [], "inter": []}
    orig = img if run_kw.pop("with_orig", False) else None
    for _, res in sp.scan_chunks(plan, coeffs, orig=orig, mesh=mesh, **run_kw):
        for k in out:
            v = getattr(res, k)
            if v is not None:
                out[k].append(v)
    return {k: np.concatenate(v) for k, v in out.items() if v}


def zoom(mesh, img, prec, args: dict, device_route: bool):
    from dspfun_tpu_torch.models import zoom_pipeline as zp  # noqa: PLC0415

    spec = zp.forward_spectrum(img, prec, mesh.device).to(torch.float32)
    fn = zp.zoom_frame_device if device_route else zp.zoom_frame
    out, n = _counted(lambda: fn(spec, precision=prec, mesh=mesh, **args))
    return out.cpu().numpy(), n


def fail_on_rank_one(mesh):
    """Rank 1 raises before the collective; the others wait in it."""
    if mesh.rank == 1:
        raise RuntimeError("rank one fails here")
    return pm.psum(torch.ones(1), mesh, "space").tolist()


def plan_rows(mesh, n, intermediate):
    """Every field of a DCT-III plan, whole and this rank's rows."""
    from dspfun_tpu_torch.core.precision import Precision  # noqa: PLC0415
    from dspfun_tpu_torch.core.transforms import plan_axis  # noqa: PLC0415

    plan = plan_axis(n, "dct3", Precision(coeff="float32", intermediate=intermediate),
                     mesh.device)
    local = pm.plan_row_spec(plan, mesh)

    def fields(p):
        return {k: None if v is None else v.cpu().to(torch.float64 if v.is_floating_point()
                                                      else v.dtype).numpy()
                for k, v in p._asdict().items()}

    return fields(plan), fields(local)


def limb_sum(mesh, base):
    """Each rank's count ``base + rank`` as [hi, lo] limbs, summed over
    the mesh as the volume path sums its coded counts."""
    cnt = torch.tensor(base + mesh.rank, dtype=torch.int64)
    limbs = torch.stack([cnt >> 15, cnt & 0x7FFF]).to(torch.int32)
    return msh.coded_count(pm.psum(pm.psum(limbs, mesh, "space"), mesh, "time"))


def multihost_fused3d(mesh, full, mask, prec):
    """The fused 3-D chain over a mesh that spans several processes:
    each process stages its own time-contiguous slab of ``full``."""
    from dspfun_tpu_torch.parallel import multihost  # noqa: PLC0415

    per_proc = mesh.size // mesh.procs
    proc = mesh.rank // per_proc
    tl = full.shape[0] // mesh.procs
    cube = multihost.stage_global_cube(full[proc * tl:(proc + 1) * tl], mesh)
    out = sharded.fused_filter_3d_sharded(
        cube, sharded.mask_sharding(mesh)(_t(mask, mesh)), mesh, prec)
    return sharded.cube_sharding(mesh).gather(out).cpu().numpy()


def fused3d_launched(mesh, cube, mask, prec):
    """:func:`fused3d` with this rank's int8 kernel launches."""
    from dspfun_tpu_torch.ops import int8mm  # noqa: PLC0415

    before = sum(int8mm.LAUNCHES.values())
    out, n = fused3d(mesh, cube, mask, prec)
    return out, n, sum(int8mm.LAUNCHES.values()) - before
