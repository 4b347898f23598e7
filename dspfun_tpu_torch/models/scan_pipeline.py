"""Progressive frequency-scan reconstruction: the `scan` tool's compute
(PyTorch port of ``dspfun_tpu/models/scan_pipeline.py``).

The reference (scan/scan.c:421-527) reconstructs one frame at a time:
gather the next `step` scan indexes' coefficients, zero everything
else, run either a full FFTW IDCT or a pruned scalar synthesis over
just those coefficients, and accumulate into a running sum image.

Here frames are processed in fixed-size *chunks*.  For each chunk the
per-frame coordinate lists (host metadata from
:mod:`dspfun_tpu_torch.ops.scan_methods`) become padded [F, K] index
arrays, and the per-frame delta images are computed either

* **pruned**: gather the K active DCT-III basis columns per axis and
  synthesize with one batched matmul per chunk —
  ``delta[f] = By[:, ys_f] @ (v_f * Bx[:, xs_f])`` — an O(h*K*w)
  contraction replacing the reference's O(K*h*w) scalar loop
  (scan/scan.c:30-41); or
* **full**: scatter the coefficients into dense [F, h, w, c] grids and
  run the batched separable IDCT through the planned contractions
  (two per chunk; on int8 plans the digit kernels; scan/scan.c:359).

then ``cumsum`` over the frame axis turns deltas into the running
reconstruction for every frame of the chunk at once.  The DC term is
pre-added to the running sum exactly once (scan/scan.c:381-383) and
zeroed out of the coefficient source (scan/scan.c:444-445).

Parity measurement (scan/scan.c:508-526) runs on the device per frame.

With ``mesh`` (inside a rank of ``parallel/mesh.py``) the output rows
shard over the mesh's 'space' axis: the coefficient image is whole on
every rank, each rank reconstructs its own rows, and the frames are
gathered over 'space' before they leave the device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dspfun_tpu_torch.core import basis as basis_mod
from dspfun_tpu_torch.core.precision import Precision, get_precision, true_div
from dspfun_tpu_torch.core.transforms import AxisPlan, apply_plan_nd, dct2_nd, plan_matrix
from dspfun_tpu_torch.ops.int8mm import ceil_to
from dspfun_tpu_torch.ops.scan_order import ScanOrder
from dspfun_tpu_torch.utils.hostcopy import finish_copy, start_copy

__all__ = ["ScanPlan", "plan_scan", "ScanChunkResult", "scan_chunks", "forward_coeffs"]


def forward_coeffs(image, precision: Precision | None = None,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """Image [H,W,C] (numpy, or a tensor that stays where it is) ->
    DCT-II coefficients / 4wh on ``device``
    (reference scan/scan.c:292-298, "non-uniform range -1..1")."""
    p = precision or get_precision()
    if isinstance(image, torch.Tensor):
        x = image.to(p.coeff_dtype)
    else:
        x = torch.from_numpy(np.asarray(image)).to(p.coeff_dtype).to(device)
    h, w = x.shape[:2]
    return true_div(dct2_nd(x, (0, 1), p), 4.0 * w * h)


@dataclasses.dataclass
class ScanPlan:
    """Host-side frame schedule + device basis plans."""

    height: int
    width: int
    channels: int
    nframes: int
    step: int
    offset: int
    limit: int
    # padded per-frame coords [nframes_padded, K]
    ys: np.ndarray
    xs: np.ndarray
    valid: np.ndarray
    # coords filled before the first frame (offset prefill), flat
    fill_ys: np.ndarray
    fill_xs: np.ndarray
    use_pruned: bool
    chunk: int
    plans_inv: tuple  # (AxisPlan_h, AxisPlan_w) for dct3

    @property
    def kmax(self) -> int:
        return self.ys.shape[1]


def _frame_coords(order: ScanOrder, limit: int, step: int, invert: bool,
                  frame_i: int) -> tuple[np.ndarray, np.ndarray]:
    """Coordinates covered by output frame ``frame_i`` (scan indices
    s in [i*step, (i+1)*step) clipped to limit, inverted if requested
    — reference scan/scan.c:422-427), deduplicated (set semantics, as
    in the reference's dense-scatter path)."""
    ys: list[np.ndarray] = []
    xs: list[np.ndarray] = []
    for s in range(frame_i * step, min((frame_i + 1) * step, limit)):
        j = limit - s - 1 if invert else s
        y, x = order.coords(j)
        ys.append(y)
        xs.append(x)
    if not ys:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    y = np.concatenate(ys)
    x = np.concatenate(xs)
    # the key's stride is the frame's own x.max() + 1, as in the JAX
    # package: copied literally so the schedules stay equal
    _, idx = np.unique(y.astype(np.int64) * (x.max() + 1 if len(x) else 1) + x,
                       return_index=True)
    idx.sort()
    return y[idx], x[idx]


def plan_scan(
    order: ScanOrder,
    width: int,
    height: int,
    channels: int = 3,
    step: int = 1,
    nframes: int = 0,
    offset: int = 0,
    invert: bool = False,
    use_pruned: bool | None = None,
    chunk: int = 8,
    precision: Precision | None = None,
    device: torch.device | str = "cuda",
) -> ScanPlan:
    """Build the frame schedule (reference scan/scan.c:343-350,386-427).

    Reference quirk replicated deliberately: ``offset`` counts *scan
    indices* for the prefill (scan.c:389) but *frames* for the schedule
    (scan.c:421 iterates i in [offset, offset+nframes) with frame i
    covering s in [i*step, (i+1)*step)), so with step > 1 the indices
    [offset, offset*step) are in neither; and the default nframes
    (scan.c:347-348) does not subtract offset, so offset runs end with
    empty (duplicate) frames.  Both match the C tool's output exactly.
    """
    limit = order.limit
    if not nframes or nframes > limit // step:
        nframes = (limit + step - 1) // step
    if offset >= limit:
        offset = limit - 1

    frames = []
    for i in range(offset, offset + nframes):
        frames.append(_frame_coords(order, limit, step, invert, i))
    kmax = max((len(y) for y, _ in frames), default=1) or 1

    npad = ((nframes + chunk - 1) // chunk) * chunk
    ys = np.zeros((npad, kmax), dtype=np.int32)
    xs = np.zeros((npad, kmax), dtype=np.int32)
    valid = np.zeros((npad, kmax), dtype=bool)
    for f, (y, x) in enumerate(frames):
        ys[f, : len(y)] = y
        xs[f, : len(x)] = x
        valid[f, : len(y)] = True

    # prefill coords: scan indices 0..offset-1 (reference scan.c:389-417)
    fy: list[np.ndarray] = []
    fx: list[np.ndarray] = []
    for i in range(offset):
        j = limit - i - 1 if invert else i
        y, x = order.coords(j)
        fy.append(y)
        fx.append(x)
    fill_ys = np.concatenate(fy) if fy else np.empty(0, np.int32)
    fill_xs = np.concatenate(fx) if fx else np.empty(0, np.int32)

    p = precision or get_precision()
    if use_pruned is None:
        # crossover: pruned synthesis is O(h*K*w) FLOPs per frame vs
        # O((h+w)*h*w) dense, but it gathers K basis columns per frame.
        # The rule is the JAX package's, carried over as it stands so
        # that both packages take the same branch and their outputs
        # agree; it was calibrated on another device, and PERF.md has
        # dense against pruned on an H100.  (The reference's log2(w*h)
        # threshold, scan.c:349-350, reflects its scalar CPU loop.)  The
        # pruned gather reads plan.hi only, so exact-mode digit plans
        # stick to the dense path (which honours the error-free
        # contraction).
        use_pruned = (min(height, width) >= 1024
                      and kmax * 32 <= min(height, width)
                      and p.intermediate != "exact")

    plans_inv = (
        plan_matrix(basis_mod.dct3_matrix(height), p, device),
        plan_matrix(basis_mod.dct3_matrix(width), p, device),
    )
    return ScanPlan(
        height=height, width=width, channels=channels, nframes=nframes,
        step=step, offset=offset, limit=limit, ys=ys, xs=xs, valid=valid,
        fill_ys=fill_ys, fill_xs=fill_xs, use_pruned=bool(use_pruned),
        chunk=chunk, plans_inv=plans_inv,
    )


@dataclasses.dataclass
class ScanChunkResult:
    sums: np.ndarray | None    # [F, H, W, C] running reconstruction
    #                            (None in packed mode)
    deltas: np.ndarray | None  # [F, H, W, C] per-frame contribution
    parity: np.ndarray | None  # [F] bool
    inter: np.ndarray | None = None  # [F, H, W, C] display-ready
    #                                  intermediates pane (normalised and
    #                                  encoded on the device)
    payload: np.ndarray | None = None  # [F, S] packed container bytes
    #                                    (io/device_pack packer output)


def _lround(x: torch.Tensor) -> torch.Tensor:
    """C lround: halfway cases away from zero (torch.round is to-even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _index(a, device) -> torch.Tensor:
    """Host coordinates as an int64 index tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _scan_chunk(
    carry,          # [H, W, C] running sum
    coeffs_nodc,    # [H, W, C] DCT/4wh with DC zeroed
    ys, xs, valid,  # [F, K]
    plans_inv,      # (AxisPlan_h, AxisPlan_w)
    orig,           # [H, W, C] or None
    dc,             # [C] DC per channel (intermediates pane offset)
    parity_scale: float,   # (1<<depth)-1, or 0 for float compare
    use_pruned: bool,
    want_deltas: bool,
    measure_parity: bool,
    encode_trc: bool = False,
    inter_mode: str | None = None,   # None | "unit" | "minmax" | "raw"
    grid_h: int | None = None,
):
    """One chunk of frames: returns (carry, display sums [F,H,W,C],
    deltas or None, intermediates pane or None, parity [F] or None), all
    on ``carry``'s device.  ``carry`` may hold a shard's rows of a
    ``grid_h``-row image (the plan of H then holds those rows only);
    ``inter_mode="raw"`` returns the intermediates before normalisation
    and encoding (the row-sharded minmax reduces its extrema first)."""
    h, w, c = carry.shape
    dev = carry.device
    ys, xs = _index(ys, dev), _index(xs, dev)
    valid = torch.as_tensor(valid, device=dev)
    f = ys.shape[0]
    v = coeffs_nodc[ys, xs, :] * valid[..., None].to(coeffs_nodc.dtype)  # [F,K,C]

    plan_h, plan_w = plans_inv
    if use_pruned:
        # gather basis columns: By[:, ys] -> [F, H, K].  Full float32
        # products (core/precision.py pins TF32 off).
        by = plan_h.hi[:, ys].movedim(1, 0)
        bx = plan_w.hi[:, xs].movedim(1, 0)

        def synth(by_, bx_):
            t = v[:, :, None, :] * bx_.transpose(1, 2)[:, :, :, None]  # [F,K,W,C]
            return torch.bmm(by_, t.reshape(f, -1, w * c)).reshape(f, h, w, c)

        delta = synth(by, bx)
        if plan_h.lo is not None:
            by_lo = plan_h.lo[:, ys].movedim(1, 0)
            bx_lo = plan_w.lo[:, xs].movedim(1, 0)
            delta = delta + synth(by, bx_lo)
            delta = delta + synth(by_lo, bx)
        delta = delta.to(carry.dtype)
    else:
        # padded entries all write v = 0 to (f, 0, 0) and the DC there
        # is zeroed in coeffs_nodc, so duplicate writes agree (index_put_
        # picks any of them on CUDA)
        fidx = torch.arange(f, device=dev)[:, None].expand_as(ys)
        grid = torch.zeros((f, grid_h or h, w, c), dtype=coeffs_nodc.dtype, device=dev)
        grid[fidx, ys, xs, :] = v
        delta = apply_plan_nd(grid, plans_inv, (1, 2))

    sums = carry[None] + torch.cumsum(delta, dim=0)

    parity = None
    if measure_parity:
        if parity_scale > 0:
            eq = _lround(orig[None] * parity_scale) == _lround(sums * parity_scale)
        else:
            eq = orig[None].to(torch.float32) == sums.to(torch.float32)
        parity = torch.all(eq.reshape(f, -1), dim=1)

    # display-side work stays on the device (the host emission loop only
    # assembles panes and writes bytes — reference scan.c:461-491 does
    # this per pixel on the host)
    def _enc(x):
        if not encode_trc:
            return x
        from dspfun_tpu_torch.io.color import srgb_encode  # noqa: PLC0415

        return srgb_encode(x, torch)

    inter = None
    if inter_mode is not None:
        base = delta + dc[None, None, None, :]
        if inter_mode == "minmax":
            flat = base.reshape(f, -1, base.shape[-1])
            mn = torch.amin(flat, dim=1)
            mx = torch.amax(flat, dim=1)
            rng = torch.where(mx - mn == 0, torch.ones_like(mx), mx - mn)
            inter = (base - mn[:, None, None, :]) / rng[:, None, None, :]
        elif inter_mode == "raw":
            return sums[-1].clone(), _enc(sums), (delta if want_deltas else None), \
                base, parity
        elif inter_mode == "unit":  # fixed 0..1 window
            inter = base
        else:
            raise ValueError(f"inter_mode {inter_mode!r}: None, 'unit', 'minmax' or 'raw'")
        inter = _enc(inter)

    return sums[-1].clone(), _enc(sums), (delta if want_deltas else None), \
        inter, parity


def scan_chunks(
    plan: ScanPlan,
    coeffs: torch.Tensor,
    orig: np.ndarray | None = None,
    parity_depth: int = 8,
    want_deltas: bool = False,
    encode_trc: bool = False,
    inter_mode: str | None = None,
    packer=None,
    times: dict | None = None,
    mesh=None,
):
    """Generator over chunks of frames, on ``coeffs``'s device.

    Yields ``(frame_start, ScanChunkResult)``.  ``coeffs`` is the
    [H,W,C] output of :func:`forward_coeffs`.  ``encode_trc`` applies
    the sRGB OETF to the emitted panes on the device; ``inter_mode``
    ("unit" | "minmax") produces the display-ready intermediates pane
    there (``ScanChunkResult.inter``).  ``packer``
    (io/device_pack.make_packer) packs frames to container payload bytes
    on the device and the result carries ``payload`` instead of float
    ``sums``: 4-12x fewer bytes to the host for integer-format outputs.

    One chunk of lookahead: chunk n+1 is dispatched before chunk n is
    awaited, and every result goes to the host through a pinned buffer
    behind an event of its own (utils/hostcopy.py), so the device works
    on while the host writes.  ``times``, when given, collects
    ``dispatch`` (host seconds queueing), ``wait`` (host seconds blocked
    on copies) and, on a card, ``chunk_device_ms`` (a list, CUDA events
    around each chunk's compute and packing).

    With ``mesh`` (called in every rank of it), output rows shard over
    the mesh's 'space' axis, any height (the plan's rows zero-pad up to
    the axis) and any ``inter_mode`` (minmax reduces its extrema over the
    ranks): each rank reconstructs its own rows, and every result is
    gathered over 'space', its padding rows dropped, before it is packed
    or copied, so every rank yields the whole frames.
    """
    h, w, c = plan.height, plan.width, plan.channels
    dev = coeffs.device
    on_card = dev.type == "cuda"
    dc = coeffs[0, 0, :].clone()
    coeffs_nodc = coeffs.clone()
    coeffs_nodc[0, 0, :] = 0.0
    plans_inv = plan.plans_inv

    # running sum starts as the DC everywhere (scan/scan.c:381-383)
    carry = dc.to(coeffs.dtype).expand(h, w, c).contiguous()
    hl, r0 = h, 0
    if mesh is not None:
        from dspfun_tpu_torch.parallel.mesh import plan_row_spec  # noqa: PLC0415

        hp = ceil_to(h, mesh.shape["space"])
        hl = hp // mesh.shape["space"]
        r0 = mesh.axis_index("space") * hl
        plans_inv = (plan_row_spec(_pad_plan_rows(plans_inv[0], hp), mesh), plans_inv[1])
        carry = _rows(carry, r0, hl)
        if orig is not None:
            orig = _rows(torch.from_numpy(np.asarray(orig)), r0, hl).numpy()

    # offset prefill: one dense IDCT over the filled coefficients
    # (reference scan.c:389-417)
    if len(plan.fill_ys):
        fy, fx = _index(plan.fill_ys, dev), _index(plan.fill_xs, dev)
        grid = torch.zeros((h, w, c), dtype=coeffs.dtype, device=dev)
        grid[fy, fx, :] = coeffs_nodc[fy, fx, :]
        carry = carry + apply_plan_nd(grid[None], plans_inv, (1, 2))[0]

    measure_parity = orig is not None
    orig_dev = (torch.from_numpy(np.asarray(orig)).to(dev) if measure_parity
                else None)
    scale = float((1 << parity_depth) - 1) if parity_depth < 32 else 0.0

    def add(name, dt):
        if times is not None:
            times[name] = times.get(name, 0.0) + dt

    def dispatch(start):
        nonlocal carry
        end = start + plan.chunk
        t0 = time.perf_counter()
        events = None
        if on_card and times is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        carry, disp, deltas, inter, parity = _scan_chunk(
            carry, coeffs_nodc, plan.ys[start:end], plan.xs[start:end],
            plan.valid[start:end], plans_inv, orig_dev, dc,
            parity_scale=scale, use_pruned=plan.use_pruned,
            want_deltas=want_deltas, measure_parity=measure_parity,
            encode_trc=encode_trc,
            inter_mode="raw" if mesh is not None and inter_mode == "minmax" else inter_mode,
            grid_h=h if mesh is not None else None,
        )
        if mesh is not None:
            disp, deltas, inter, parity = _gather_rows(
                mesh, disp, deltas, inter, parity, h, r0, inter_mode, encode_trc)
        packed = None
        if packer is not None:
            packed = packer(disp)
            disp = None
        if events is not None:
            events[1].record()
        # start the device->host copies early so the next chunk's
        # compute overlaps this chunk's download
        bufs = tuple(start_copy(a) for a in (disp, deltas, inter, parity, packed))
        add("dispatch", time.perf_counter() - t0)
        return bufs, events

    def materialise(start, bufs, events):
        nvalid = min(plan.chunk, plan.nframes - start)
        t0 = time.perf_counter()
        disp, deltas, inter, parity, packed = (
            None if a is None else a[:nvalid] for a in map(finish_copy, bufs))
        add("wait", time.perf_counter() - t0)
        if events is not None:
            times.setdefault("chunk_device_ms", []).append(
                events[0].elapsed_time(events[1]))
        return start, ScanChunkResult(sums=disp, deltas=deltas, parity=parity,
                                      inter=inter, payload=packed)

    pending = None
    for start in range(0, plan.nframes, plan.chunk):
        nxt = (start, *dispatch(start))
        if pending is not None:
            yield materialise(*pending)
        pending = nxt
    if pending is not None:
        yield materialise(*pending)


def _rows(a: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of ``a``, zero past its end (a shard's rows of
    an image whose height pads up to the mesh)."""
    out = a.new_zeros((n, *a.shape[1:]))
    k = max(0, min(a.shape[0] - r0, n))
    out[:k] = a[r0:r0 + k]
    return out


def _pad_plan_rows(plan: AxisPlan, rows: int) -> AxisPlan:
    """Zero-pad an AxisPlan's OUTPUT rows to ``rows`` (row-sharded meshes
    need the output axis divisible by the space axis; zero rows
    synthesise zero output)."""
    def pad(a, axis):
        if a is None or a.ndim == 0 or a.shape[axis] >= rows:
            return a
        shape = list(a.shape)
        shape[axis] = rows - a.shape[axis]
        return torch.cat([a, a.new_zeros(shape)], dim=axis)

    return AxisPlan(
        hi=pad(plan.hi, 0),
        lo=pad(plan.lo, 0),
        digits=pad(plan.digits, 1),
        # i8 plans carry a per-row [M, 1] scale; the zero pad value is
        # irrelevant since padded digit rows are all-zero
        scale=pad(plan.scale, 0) if plan.scale is not None and plan.scale.ndim == 2
        else plan.scale,
        rowsum=pad(plan.rowsum, 1),
    )


def _gather_rows(mesh, disp, deltas, inter, parity, h, r0, inter_mode, encode_trc):
    """The row-sharded chunk's collectives: minmax intermediates take
    their per-frame extrema over every rank's valid rows (padding rows
    hold the DC, which must not reach the minimum), a frame's parity
    holds when every rank's rows match, and the frames are gathered over
    'space' with the padding rows dropped."""
    from dspfun_tpu_torch.parallel.mesh import all_gather, pmax, pmin, psum  # noqa: PLC0415

    if inter_mode == "minmax":
        f, hl, w, c = inter.shape
        valid = ((r0 + torch.arange(hl, device=inter.device)) < h)[None, :, None, None]
        valid = valid.expand(inter.shape).reshape(f, -1, c)
        flat = inter.reshape(f, -1, c)
        inf = torch.full((), float("inf"), dtype=inter.dtype, device=inter.device)
        mn = pmin(torch.amin(torch.where(valid, flat, inf), dim=1), mesh, "space")
        mx = pmax(torch.amax(torch.where(valid, flat, -inf), dim=1), mesh, "space")
        rng = torch.where(mx - mn == 0, torch.ones_like(mx), mx - mn)
        inter = (inter - mn[:, None, None, :]) / rng[:, None, None, :]
        if encode_trc:
            from dspfun_tpu_torch.io.color import srgb_encode  # noqa: PLC0415

            inter = srgb_encode(inter, torch)
    if parity is not None:
        parity = psum((~parity).to(torch.int32), mesh, "space") == 0
    full = [None if a is None else all_gather(a, mesh, "space", 1)[:, :h]
            for a in (disp, deltas, inter)]
    return (*full, parity)
