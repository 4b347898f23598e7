"""Sharded spectral transforms over the mesh's ranks (PyTorch port of
``dspfun_tpu/parallel/sharded.py``).

Frame cubes [T, H, W, C] are laid out over a (space, time)
:class:`~dspfun_tpu_torch.parallel.mesh.Mesh`: rows over ``space``
(block/data parallelism), the temporal axis over ``time``.  Each rank
holds its own shard and calls the functions here on it; they return the
rank's shard of the result.

A separable 3-D DCT under this layout runs Ulysses-style: transform the
locally complete axis, ``all_to_all`` to make the next axis local,
transform, repeat.  Each all_to_all moves exactly one axis's shards; the
elementwise filter runs in the fully transformed layout; the inverse
chain mirrors back.  Per-shard shapes of the forward half:

    [T/t, H/s, W, C]   DCT over W (local)
    --all_to_all over space: W splits, H gathers-->
    [T/t, H, W/s, C]   DCT over H (local)
    --all_to_all over time: H splits, T gathers-->
    [T, H/t, W/s, C]   DCT over T (local)  -> filter here
"""

from __future__ import annotations

import torch

from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import apply_plan, plan_axis
from dspfun_tpu_torch.parallel.mesh import Mesh, Sharding, all_gather, all_to_all

__all__ = [
    "fused_filter_3d_sharded",
    "dct3d_sharded_fn",
    "cube_sharding",
    "mask_sharding",
    "shard_blocks_filter",
]


def cube_sharding(mesh: Mesh) -> Sharding:
    """Input/output layout: T over 'time', H over 'space'.  Called on a
    full cube it gives this rank's slice."""
    return Sharding(mesh, ("time", "space", None, None))


def mask_sharding(mesh: Mesh) -> Sharding:
    """Coefficient-space filter layout: T local, H over 'time', W over
    'space' (the layout after the forward all_to_all chain)."""
    return Sharding(mesh, (None, "time", "space", None))


def dct3d_sharded_fn(t: int, h: int, w: int, mesh: Mesh,
                     precision: Precision | None = None,
                     device: torch.device | str = "cuda"):
    """Returns (fwd, inv) shard-local functions for the 3-D DCT chain of
    a [t, h, w, C] cube, with plans on ``device``.

    ``fwd`` maps a [T/t, H/s, W, C] shard to the [T, H/t, W/s, C]
    coefficient shard; ``inv`` is its exact inverse (including the
    1/(8 t h w) round-trip normalisation)."""
    p = precision or get_precision()
    plans = {f"{ax}{k[-1]}": plan_axis(n, k, p, device)
             for ax, n in (("t", t), ("h", h), ("w", w)) for k in ("dct2", "dct3")}

    def fwd(shard):
        x = apply_plan(shard, plans["w2"], 2, p)            # W local
        x = all_to_all(x, mesh, "space", 2, 1)              # -> [T/t, H, W/s, C]
        x = apply_plan(x, plans["h2"], 1, p)
        x = all_to_all(x, mesh, "time", 1, 0)               # -> [T, H/t, W/s, C]
        return apply_plan(x, plans["t2"], 0, p)

    def inv(coeff):
        x = apply_plan(coeff, plans["t3"], 0, p)
        x = all_to_all(x, mesh, "time", 0, 1)               # -> [T/t, H, W/s, C]
        x = apply_plan(x, plans["h3"], 1, p)
        x = all_to_all(x, mesh, "space", 1, 2)              # -> [T/t, H/s, W, C]
        x = apply_plan(x, plans["w3"], 2, p)
        return true_div(x, 8.0 * t * h * w)

    return fwd, inv


def fused_filter_3d_sharded(
    cube: torch.Tensor,
    mask: torch.Tensor,
    mesh: Mesh,
    precision: Precision | None = None,
) -> torch.Tensor:
    """IDCT3(mask * DCT2_3d(cube)) over a (space, time) mesh, on this
    rank's shards: ``cube`` [T/t, H/s, W, C] laid out per
    :func:`cube_sharding`, ``mask`` the [T, H/t, W/s, 1] coefficient
    filter laid out per :func:`mask_sharding`.  Returns this rank's
    [T/t, H/s, W, C] shard.  The distributed analogue of
    :func:`dspfun_tpu_torch.models.fused.fused_filter_3d`."""
    t = cube.shape[0] * mesh.shape["time"]
    h = cube.shape[1] * mesh.shape["space"]
    w = cube.shape[2]
    fwd, inv = dct3d_sharded_fn(t, h, w, mesh, precision, cube.device)
    coeff = fwd(cube)
    return inv(coeff * mask.to(coeff.dtype))


def shard_blocks_filter(
    blocks: torch.Tensor,
    plans,
    block_coords,
    bz,
    mesh: Mesh,
    *,
    geom,
    params,
    plane_index: int,
    nplanes: int,
):
    """motion's per-slab block batch distributed over the mesh's 'space'
    axis: pure data parallelism over the block grid (blocks are
    independent).  Every rank holds the whole [NB, ...] batch; each
    filters its contiguous share, and the results are gathered over
    'space', so every rank returns the whole (out [NB, ...], coded [NB]).
    Ranks that differ only in their 'time' index compute the same share.

    The batch is zero-padded up to a multiple of the space axis (zero
    blocks transform to zero and their per-block coded counts are
    sliced off, so padding never changes the result).  ``block_coords``
    None numbers the blocks in raster order, as ``filter_blocks`` does
    for one slab."""
    from dspfun_tpu_torch.models.motion_pipeline import filter_blocks  # noqa: PLC0415

    n_space = mesh.shape["space"]
    nb = blocks.shape[0]
    dev = blocks.device
    if block_coords is None:
        bidx = torch.arange(nb, device=dev) % (geom.nblocks.w * geom.nblocks.h)
        block_coords = (bidx % geom.nblocks.w, bidx // geom.nblocks.w)
    bx, by = (torch.as_tensor(b, device=dev) for b in block_coords)
    npad = (-nb) % n_space
    if npad:
        blocks = torch.cat([blocks, blocks.new_zeros((npad, *blocks.shape[1:]))])
        bx = torch.cat([bx, bx.new_zeros(npad)])
        by = torch.cat([by, by.new_zeros(npad)])
    per = (nb + npad) // n_space
    si = mesh.axis_index("space")
    sl = slice(si * per, (si + 1) * per)
    out, coded = filter_blocks(blocks[sl].contiguous(), plans, (bx[sl], by[sl]), bz,
                               geom=geom, params=params, plane_index=plane_index,
                               nplanes=nplanes)
    out = all_gather(out, mesh, "space", 0)
    coded = all_gather(coded, mesh, "space", 0)
    if npad:
        out, coded = out[:nb], coded[:nb]
    return out, coded
