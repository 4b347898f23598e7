"""motion — apply 2- or 3-dimensional frequency-domain operations to a
video (PyTorch port of ``dspfun_tpu/tools/motion.py``).

CLI-compatible rebuild of reference motion/motion.c on the batched block
pipeline in ``dspfun_tpu_torch.models.motion_pipeline``.  Run it as

    python -m dspfun_tpu_torch.tools.motion [options] <infile> [outfile]

It keeps the JAX tool's getopt surface and defaults.  ``--device``
picks the torch device (default ``cuda``; without a card that is an
error, and ``--device cpu`` runs the plain versions).  It reads and
writes y4m, fvid, NUT (FFV1 by default for integer pels), Matroska and
image sequences natively, every other container through the ffmpeg
bridge (``--decopts``/``--encopts`` are its options), and plays to
``ffplay:`` (``io/video.py``).
``--eval`` evaluates its av_expr on the coefficients' device; a
stateful expression (random, while, root, taylor, time, or reads of
slots stored by an earlier coefficient) takes the grid to the host,
per coefficient in raster order, and runs one slab at a time.
``--resume-file`` records the slab index after each slab and a rerun
with the same flags appends from there.  ``--mesh`` (or ``DSPFUN_MESH``)
runs one rank per device of the mesh (``tools.launch``: every card with
``cuda``, over nccl; one CPU rank per core with ``cpu``, over gloo): a
plane that is one whole-clip block on a compatible mesh takes the
Ulysses-sharded volume chain (``parallel/motion_sharded.py``), any
other the block batch over 'space' (``parallel/sharded.py``).
``--coordinator host:port --nprocs N --proc-id I`` spreads the ranks over
N host processes (process 0 serves the rendezvous at that address; each
process starts one rank per local card, or its share of a CPU mesh).
The FFTW planning flags are accepted for CLI parity and do nothing.
"""

from __future__ import annotations

import getopt
import math
import sys
import time
from fractions import Fraction

import numpy as np
import torch

from dspfun_tpu_torch.core.expr import parse_expr
from dspfun_tpu_torch.core.precision import apply_tool_default, get_precision
from dspfun_tpu_torch.io import video
from dspfun_tpu_torch.models import motion_pipeline as mp
from dspfun_tpu_torch.parallel import motion_sharded as msh
from dspfun_tpu_torch.parallel import multihost
from dspfun_tpu_torch.parallel.mesh import cli_devices, current_mesh, mesh_from_spec
from dspfun_tpu_torch.parallel.sharded import shard_blocks_filter
from dspfun_tpu_torch.tools import cli_device, launch, open_rank_output, run_main
from dspfun_tpu_torch.utils.checkpoint import load_state, save_state

# device-plan cache across main() invocations, keyed on device,
# precision, geometry and params
_PLAN_CACHE: dict = {}

# per-stage wall seconds of the last run: read = container decode on the
# host; compute = host-to-device copy, block gather, filter_blocks and
# the device-to-host copy of the results (which waits for the device);
# write = host mux and encode; host_eval = the part of compute a stateful
# --eval spent on the host (0 otherwise)
LAST_STAGE_TIMES: dict = {}

SHORT = "b:s:p:B:D:c:q:r:dQh"
LONG = [
    "size=", "blocksize=", "offset=", "frames=", "framerate=", "keep-rate",
    "samesize-chroma", "spectrogram=", "ispectrogram=", "bandpass=", "boost=",
    "damp=", "quant=", "dither", "csp=", "format=", "codec=", "encopts=",
    "iformat=", "decopts=", "loglevel=", "preserve-dc=", "eval=",
    "fftw-planning-method=", "fftw-wisdom-file=", "fftw-threads=", "quiet",
    "help", "threshold=", "coeff-limit=", "linear", "resume-file=", "mesh=",
    "coordinator=", "nprocs=", "proc-id=", "slab-batch=", "device=",
]

# getopt has no optional-argument long options; bare forms of these are
# rewritten to "--opt=" before parsing (empty value selects the default)
_OPTIONAL_ARG = ("--spectrogram", "--ispectrogram", "--preserve-dc")

USAGE = """Usage: motion [options] <infile> [outfile]
[-s|--size WxHxD] [-b|--blocksize WxHxD] [-p|--bandpass X1xY1xZ1-X2xY2xZ2]
[-B|--boost float] [-D|--damp float]  [--spectrogram=type] [--ispectrogram=type] [-q|--quant quant] [--threshold] [--coeff-limit limit] [-d|--dither] [--preserve-dc=type] [--eval expression]
[-r|--framerate] [--keep-rate] [--samesize-chroma] [--frames lim] [--offset pos] [--csp|c colorspace options] [--iformat|--format fmt] [--codec codec] [--encopts|--decopts opts] [--loglevel int]
[--resume-file path] [--mesh auto|N|space=N[,time=M]] [--slab-batch N|auto] [--coordinator host:port --nprocs N --proc-id I] [--device cuda|cpu] [-Q|--quiet]"""

EXPR_NAMES = ("c", "x", "y", "z", "i", "width", "height", "depth",
              "components", "bx", "by", "bz", "bwidth", "bheight", "bdepth")


def _parse_dims(arg: str, current: mp.Dims = mp.Dims(0, 0, 0)) -> mp.Dims:
    """sscanf-style: unmatched trailing fields keep their prior values
    (so `-b 8x8` keeps the default depth 1, while `-b 8x8x0` explicitly
    requests whole-clip depth — reference motion.c:227,motion/README.md)."""
    vals = [current.w, current.h, current.d]
    for i, p in enumerate(arg.split("x")[:3]):
        if p != "":
            vals[i] = int(p)
    return mp.Dims(*vals)


def _parse_multi(arg: str, default: float) -> list[float]:
    """N[:N:N:N] per-plane values; missing entries repeat the last
    (reference motion.c:235-236)."""
    vals = [float(t) for t in arg.split(":") if t != ""]
    out = []
    for i in range(4):
        if i < len(vals):
            out.append(vals[i])
        else:
            out.append(out[-1] if out else default)
    return out


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("motion")
    argv = sys.argv[1:] if argv is None else argv
    argv = [a + "=" if a in _OPTIONAL_ARG else a for a in argv]
    try:
        flags, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    block = mp.Dims(0, 0, 1)
    scaled = mp.Dims()
    bp_begin = mp.Dims()
    bp_end = mp.Dims()
    boost = [1.0] * 4
    damp = [0.0] * 4
    quant = 0.0
    threshold_min = threshold_max = 0.0
    coeff_limit = 0
    spec = ispec = preserve_dc = None
    exprstr = resume_file = codec = encopts = decopts = None
    dither = linear = samerate = samesize = quiet = False
    offset = 0
    maxframes = 0
    out_rate = None
    csp = iformat = oformat = None
    slab_batch = "auto"
    device_arg = None
    mesh_spec = coordinator = None
    nprocs, proc_id = 1, 0
    for flag, arg in flags:
        if flag in ("-h", "--help"):
            print(USAGE)
            return 0
        elif flag in ("-b", "--blocksize"):
            block = _parse_dims(arg, block)
        elif flag in ("-s", "--size"):
            scaled = _parse_dims(arg)
        elif flag in ("-p", "--bandpass"):
            lo, _, hi = arg.partition("-")
            bp_begin = _parse_dims(lo)
            bp_end = _parse_dims(hi) if hi else mp.Dims()
        elif flag in ("-B", "--boost"):
            boost = _parse_multi(arg, 1.0)
        elif flag in ("-D", "--damp"):
            damp = _parse_multi(arg, 0.0)
        elif flag in ("-c", "--csp"):
            csp = arg
        elif flag in ("-r", "--framerate"):
            out_rate = video.parse_rate(arg)
        elif flag == "--offset":
            offset = int(arg)
        elif flag == "--frames":
            maxframes = int(arg)
        elif flag == "--keep-rate":
            samerate = True
        elif flag == "--samesize-chroma":
            samesize = True
        elif flag == "--spectrogram":
            spec = arg or "abs"
            if spec not in mp.SPECTYPES:
                print(f"invalid spectrogram type '{spec}', use one of: "
                      f"{' '.join(mp.SPECTYPES)}", file=sys.stderr)
                return 1
        elif flag == "--ispectrogram":
            ispec = arg or "shift"
            if ispec not in mp.ISPECTYPES:
                print(f"invalid ispectrogram type '{ispec}', use one of: "
                      f"{' '.join(mp.ISPECTYPES)}", file=sys.stderr)
                return 1
        elif flag == "--preserve-dc":
            preserve_dc = arg or "dc"
            if preserve_dc not in mp.PRESERVE_DCTYPES:
                print(f"invalid preserve-dc type '{preserve_dc}', use one "
                      f"of: {' '.join(mp.PRESERVE_DCTYPES)}", file=sys.stderr)
                return 1
        elif flag in ("-q", "--quant"):
            quant = float(arg)
        elif flag == "--threshold":
            lo, _, hi = arg.partition("-")
            threshold_min = float(lo or 0)
            threshold_max = float(hi or 0)
        elif flag == "--coeff-limit":
            coeff_limit = int(arg)
        elif flag in ("-d", "--dither"):
            dither = True
        elif flag == "--eval":
            exprstr = arg
        elif flag == "--resume-file":
            resume_file = arg
        elif flag == "--linear":
            linear = True
        elif flag == "--format":
            oformat = arg
        elif flag == "--iformat":
            iformat = arg
        elif flag == "--slab-batch":
            slab_batch = arg  # int | "auto"; 1 under a mesh
        elif flag == "--mesh":
            mesh_spec = arg
        elif flag == "--coordinator":
            coordinator = arg
        elif flag == "--nprocs":
            nprocs = int(arg)
        elif flag == "--proc-id":
            proc_id = int(arg)
        elif flag == "--device":
            device_arg = arg
        elif flag == "--codec":
            codec = arg  # passed to the ffmpeg bridge for real containers
        elif flag == "--encopts":
            encopts = arg
        elif flag == "--decopts":
            decopts = arg  # passed to the ffmpeg bridge demuxer
        elif flag in ("--loglevel", "--fftw-planning-method", "--fftw-threads",
                      "--fftw-wisdom-file"):
            pass  # CLI parity; PyTorch has no plans to tune or cache
        elif flag in ("-Q", "--quiet"):
            quiet = True

    if not args:
        print(USAGE, file=sys.stderr)
        return 1
    infile = args[0]
    outfile = args[1] if len(args) > 1 else None
    try:
        device = cli_device(device_arg)
    except (RuntimeError, ValueError) as e:
        print(f"Bad --device: {e}", file=sys.stderr)
        return 1

    expr = None
    if exprstr:
        try:
            expr = parse_expr(exprstr, EXPR_NAMES)
        except ValueError as e:
            print(f"Bad expression: {e}", file=sys.stderr)
            return 1

    # --mesh / DSPFUN_MESH: distribute the work over a (space, time) mesh
    # of ranks; --coordinator/--nprocs/--proc-id over several processes
    multi = nprocs > 1 or coordinator is not None
    mesh = current_mesh()
    if mesh is None:
        try:
            mesh, where = _resolve_mesh(mesh_spec, device, multi, coordinator, nprocs, proc_id)
        except ValueError as e:
            print(f"Bad --mesh: {e}", file=sys.stderr)
            return 1
        if expr is not None and expr.stateful and (mesh_spec or multi or mesh is not None):
            # random()/while()/root()/taylor()/time() evaluate per
            # coefficient in sequence on the host (reference
            # motion.c:670-681 is a host loop too): a sharded evaluation
            # order would diverge from the reference
            print("--eval with stateful av_expr forms (random/randomi/"
                  "while/root/taylor/time) is sequential; run without "
                  "--mesh/--coordinator", file=sys.stderr)
            return 1
        if mesh is not None:
            return launch("dspfun_tpu_torch.tools.motion", argv, mesh, infile, quiet, **where)
    else:
        device = mesh.device

    try:
        reader = video.open_input(infile, format=iformat, options=decopts)
    except (OSError, ValueError, RuntimeError) as e:
        print(f'Error opening "{infile}": {e}', file=sys.stderr)
        return 1

    # processing pixel format: --csp request > spec constraints > input
    proc_fmt = reader.pix_fmt
    try:
        csp_props = video.parse_color_props(csp)
    except ValueError as e:
        print(f"Bad --csp: {e}", file=sys.stderr)
        reader.close()
        return 1
    if csp_props.pix_fmt:
        proc_fmt = video.PIXEL_FORMATS[csp_props.pix_fmt]
    elif (spec or linear) and not (proc_fmt.is_rgb or proc_fmt.ncomp == 1):
        # spectrogram / linear processing wants RGB or gray
        # (reference motion.c:313-325)
        proc_fmt = video.PIXEL_FORMATS["gbrpf32le"]
    # --csp overrides every color property for processing/output, not
    # just pixel_format (reference ffapi.c:94-114 applied at open);
    # range/matrix changes convert through RGB like the reference's
    # swscale setup (ffapi.c:283-326)
    proc_props = reader.props.copy()
    csp_override = False
    for field in ("color_range", "color_primaries", "color_trc",
                  "color_space", "chroma_location"):
        want = getattr(csp_props, field)
        if want is not None:
            if want != getattr(reader.props, field):
                csp_override = True
            setattr(proc_props, field, want)
    convert = proc_fmt.name != reader.pix_fmt.name or csp_override
    float_pixels = proc_fmt.is_float

    if reader.frames is None and not maxframes:
        print("Input frame count unknown (unseekable pipe); specify "
              "--frames", file=sys.stderr)
        reader.close()
        return 1
    nframes_in = reader.frames or 0
    source_d = nframes_in or maxframes
    if maxframes:
        # clamp --frames/--offset against the known input length only
        if nframes_in and maxframes + offset > nframes_in:
            if maxframes > nframes_in:
                maxframes = nframes_in
            if offset >= nframes_in:
                offset = nframes_in - maxframes
            else:
                maxframes = nframes_in - offset
        source_d = maxframes
    elif source_d:
        if offset >= source_d:
            offset = source_d - 1
        source_d -= offset

    if not quiet:
        print(f"  source: {reader.width} x {reader.height} x {source_d}",
              file=sys.stderr)
    if not outfile:
        reader.close()
        return 0

    sx, sy = proc_fmt.chroma_shift
    geoms = mp.plan_geometry(
        reader.width, reader.height, source_d, proc_fmt.ncomp,
        log2_chroma_w=sx, log2_chroma_h=sy,
        block=block, scaled=scaled, bp_begin=bp_begin, bp_end=bp_end,
        samesize_chroma=samesize,
    )
    g0 = geoms[0]
    if not quiet and (reader.width % g0.block.w or reader.height % g0.block.h
                      or source_d % g0.block.d):
        print("Warning: Blocks not evenly divisible, truncating dimensions",
              file=sys.stderr)

    if out_rate is None:
        rate = reader.rate
        if not samerate:
            rate = rate * Fraction(g0.scaled.d, g0.block.d)
    else:
        rate = out_rate

    # checkpoint/resume: restart from the recorded slab index when the
    # state file was written by a run with this geometry and these edits
    start_slab = 0
    fingerprint = repr((geoms, boost, damp, quant, threshold_min,
                        threshold_max, coeff_limit, spec, ispec,
                        preserve_dc, exprstr, dither, linear,
                        proc_fmt.name))
    if resume_file:
        st = load_state(resume_file)
        if (st.get("newres") == [g0.newres.w, g0.newres.h, g0.newres.d]
                and st.get("fingerprint", fingerprint) == fingerprint):
            start_slab = int(st.get("slab", 0))
            if not quiet and start_slab:
                print(f"resuming at slab {start_slab}", file=sys.stderr)

    props = proc_props.copy()
    props.pix_fmt = proc_fmt.name
    if spec:
        props.color_range = "jpeg"
    try:
        writer = open_rank_output(mesh, lambda path, primary: video.open_output(
            path, g0.newres.w, g0.newres.h, rate, props, format=oformat,
            codec=codec, options=encopts, append=start_slab > 0 and primary), outfile)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"Output setup failed for '{outfile}': {e}", file=sys.stderr)
        reader.close()
        return 1

    if not quiet:
        for gi, g in enumerate(geoms):
            print(f"plane {gi}: block {g.block} scaled {g.scaled} "
                  f"nblocks {g.nblocks} newres {g.newres}", file=sys.stderr)

    # the container may negotiate a different pixel format than the
    # processing format (e.g. float RGB spectrograms into y4m ->
    # yuv444p, the reference's swscale output conversion,
    # ffapi.c:497-527); convert through RGB on write when they differ
    out_convert = writer.pix_fmt.name != proc_fmt.name

    if dither and (spec or float_pixels):
        print("Warning: dithering cannot be used with spectrogram or float "
              "output, disabling.", file=sys.stderr)
        dither = False

    if offset or start_slab:
        reader.seek_frame(offset + start_slab * g0.block.d)

    params = [
        mp.MotionParams(
            spec=spec, ispec=ispec, preserve_dc=preserve_dc,
            boost=boost[i], damp=damp[i], quant=quant,
            threshold_min=threshold_min, threshold_max=threshold_max,
            coeff_limit=coeff_limit, expr=expr, dither=dither,
            linear=linear, float_pixels=float_pixels,
        )
        for i in range(proc_fmt.ncomp)
    ]

    use_volume = [False] * proc_fmt.ncomp
    if mesh is not None:
        use_volume = [g.nblocks == mp.Dims(1, 1, 1) and g.block == g.scaled
                      and msh.volume_mesh_compatible((g.block.d, g.block.h, g.block.w), mesh)
                      for g in geoms]
        if mesh.procs > 1 and not all(use_volume):
            print("multi-process motion runs the whole-clip volume path "
                  "only: use -b 0x0x0 (or a geometry where every plane "
                  "is one whole-clip block) with a compatible mesh",
                  file=sys.stderr)
            writer.close()
            reader.close()
            return 1
        if not quiet:
            strategies = ", ".join(f"plane {i}: {'volume' if v else 'blocks'}"
                                   for i, v in enumerate(use_volume))
            print(f"mesh: space={mesh.shape['space']} "
                  f"time={mesh.shape['time']} ({strategies})", file=sys.stderr)

    # device-resident plans, cached across invocations in-process;
    # pruned int8 Kronecker plans ride along for fused fast-path
    # geometries with sparse bandpass supports (mp.maybe_kron_plans).
    # The active precision is part of the key: make_plans sizes its
    # digit splits from get_precision()
    pkey = (str(device), get_precision(), tuple(repr(g) for g in geoms),
            tuple(p._key() for p in params))
    plans = _PLAN_CACHE.get(pkey)
    if plans is None:
        # (a volume plane builds its own plans: it needs no Kronecker pair)
        plans = [(*mp.make_plans(g, device=device),
                  None if use_volume[i] else mp.maybe_kron_plans(g, params[i], device=device))
                 for i, g in enumerate(geoms)]
        while len(_PLAN_CACHE) >= 4:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[pkey] = plans

    def read_proc_planes():
        """One frame in processing format, stored pel units (8-bit:
        0..255 in the processing color range; float formats: x255)."""
        if convert:
            rgb = reader.read_frame_rgb()
            if rgb is None:
                return None
            planes = video.rgb_to_planes(rgb, proc_fmt, props)
            if float_pixels:
                return [p * 255.0 for p in planes]
            return [video.plane_to_pel(p, proc_fmt, i, props.color_range)
                    for i, p in enumerate(planes)]
        planes = reader.read_frame(raw=not float_pixels)
        if planes is None:
            return None
        if float_pixels:
            return [p * 255.0 for p in planes]
        return planes

    # --slab-batch: how many consecutive slabs' blocks run as one
    # filter_blocks call per plane (blocks are independent across
    # slabs; bz rides per block into the --eval environment).  auto = 1:
    # the JAX tool's auto = 2 was calibrated on a TPU
    slab_b = 1 if slab_batch == "auto" or mesh is not None else max(1, int(slab_batch))
    if slab_b > 1 and expr is not None and expr.stateful:
        # batched slabs would evaluate the host expression plane-major
        # across the batch and consume random()/st() state in another
        # order than the reference's per-slab loop
        if not quiet:
            print("note: --slab-batch ignored (stateful --eval keeps "
                  "the per-slab evaluation order)", file=sys.stderr)
        slab_b = 1

    stage_s = {"read": 0.0, "compute": 0.0, "write": 0.0}
    mp.EXPR_HOST_SECONDS = 0.0
    # per-plane coded counts stay on the device until the end of the run
    # (a fetch per plane per slab would synchronise the loop)
    coded_dev: list = []
    coded_vol: list = []    # the volume chain's [hi, lo] limb pairs
    written = start_slab * g0.scaled.d
    read_count = start_slab * g0.block.d
    padb = int(math.log10(max(source_d, 1))) + 1
    pads = int(math.log10(max(g0.newres.d, 1))) + 1

    def progress():
        if not quiet:
            print(f"\rread: {read_count:>{padb}} wrote: {written:>{pads}}",
                  end="", file=sys.stderr)

    def read_slab():
        """block.d frames in processing form, or None at EOF."""
        nonlocal read_count
        slab = []
        for _z in range(g0.block.d):
            planes = read_proc_planes()
            if planes is None:
                return None
            slab.append(planes)
            read_count += 1
            progress()
        return slab

    tdims = proc_fmt.plane_dims(g0.newres.w, g0.newres.h)
    # 8-bit raw output is quantised on the device (the writer's
    # clip(rint), bit for bit): a quarter of the bytes cross to the host
    quantise_u8 = (not (float_pixels or out_convert) and writer.pix_fmt.depth == 8
                   and writer.supports_payload())

    def compute_slabs(slabs, bz0):
        """Per-slab lists of output planes (host numpy) for S consecutive
        slabs from slab ``bz0``, one filter_blocks call per plane."""
        t0 = time.perf_counter()
        S = len(slabs)
        outs = [[] for _ in range(S)]
        for i, g in enumerate(geoms):
            per = []
            for slab in slabs:
                frames = np.stack([slab[z][i] for z in range(g.block.d)])
                if frames.dtype != np.uint8:
                    # 8-bit pels cross to the device as bytes and cast
                    # there; anything else as float32 (exact for 16-bit)
                    frames = frames.astype(np.float32)
                if use_volume[i]:
                    per.append(frames)
                    continue
                # the block gather is a strided copy: done on the device
                per.append(mp.frames_to_blocks(torch.from_numpy(frames).to(device), g))
            if use_volume[i]:
                out, c = _volume_plane(per[0], g, mesh, params[i], i, proc_fmt.ncomp, bz0)
                coded_vol.append(c)
                outs[0].append(_pad_plane(out, tdims, i, quantise_u8))
                continue
            nb = per[0].shape[0]
            big = torch.cat(per) if S > 1 else per[0].contiguous()
            bz = (torch.arange(bz0, bz0 + S, device=device).repeat_interleave(nb)
                  if S > 1 else bz0)
            if mesh is not None:
                out, c = shard_blocks_filter(big, plans[i], None, bz, mesh, geom=g,
                                             params=params[i], plane_index=i,
                                             nplanes=proc_fmt.ncomp)
            else:
                out, c = mp.filter_blocks(big, plans[i], None, bz,
                                          geom=g, params=params[i], plane_index=i,
                                          nplanes=proc_fmt.ncomp)
            coded_dev.append(c)
            for s in range(S):
                outs[s].append(_pad_plane(mp.blocks_to_frames(out[s * nb:(s + 1) * nb], g),
                                          tdims, i, quantise_u8))
        outs = [[p.cpu().numpy() for p in o] for o in outs]
        stage_s["compute"] += time.perf_counter() - t0
        return outs

    def write_slab(out_planes):
        nonlocal written
        t0 = time.perf_counter()
        for z in range(g0.scaled.d):
            frame = []
            for i, g in enumerate(geoms):
                p = out_planes[i][min(z, g.scaled.d - 1)]
                frame.append(p / 255.0 if float_pixels else p)
            if quantise_u8:
                # already clip(rint)-quantised to uint8 on the device
                writer.write_frame_payload(b"".join(f.tobytes() for f in frame))
            elif out_convert:
                unit = [f if float_pixels
                        else video.plane_from_pel(f, proc_fmt, i, props.color_range)
                        for i, f in enumerate(frame)]
                writer.write_frame_rgb(video.planes_to_rgb(
                    unit, proc_fmt, props, g0.newres.w, g0.newres.h))
            else:
                writer.write_frame(frame, raw=not float_pixels)
            written += 1
            progress()
        stage_s["write"] += time.perf_counter() - t0

    ret = 0
    try:
        bz = start_slab
        while bz < g0.nblocks.d:
            t0 = time.perf_counter()
            staged, eof = [], False
            for _s in range(min(slab_b, g0.nblocks.d - bz)):
                slab = read_slab()
                if slab is None:
                    eof = True
                    break
                staged.append(slab)
            stage_s["read"] += time.perf_counter() - t0
            if staged:
                for out_planes in compute_slabs(staged, bz):
                    write_slab(out_planes)
                    bz += 1
                    if resume_file and (mesh is None or mesh.rank == 0):
                        save_state(resume_file, {
                            "slab": bz,
                            "newres": [g0.newres.w, g0.newres.h, g0.newres.d],
                            "fingerprint": fingerprint,
                        })
            if eof:
                print("Error reading frame: end of stream", file=sys.stderr)
                ret = 1
                break
    finally:
        if not quiet:
            print(file=sys.stderr)
        writer.close()
        reader.close()
    coded = int(sum(int(c.sum()) for c in coded_dev))
    coded += sum(msh.coded_count(c) for c in coded_vol)
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(stage_s, host_eval=mp.EXPR_HOST_SECONDS)

    if quant and not quiet:
        total = sum(g.newres.volume() for g in geoms)
        print(f"coeffs: {coded} / {total} ({coded * 100.0 / total:2.0f}%)\n"
              f"zeroes: {total - coded} / {total} "
              f"({(total - coded) * 100.0 / total:2.0f}%)", file=sys.stderr)
    return ret


def _resolve_mesh(spec, device, multi, coordinator, nprocs, proc_id):
    """(mesh or None, where its ranks start) for the options: one host
    process, or ``nprocs`` of them, each starting one rank per local
    card (``cuda``) or its share of the mesh's CPU ranks (``cpu``)."""
    if not multi:
        return mesh_from_spec(spec, cli_devices(device)), {}
    if coordinator is None:
        raise ValueError("a run over several processes needs --coordinator host:port")
    if not 0 <= proc_id < nprocs:
        raise ValueError(f"--proc-id {proc_id} is not one of {nprocs} processes")
    space_n = time_n = None
    for part in (spec or "auto").split(","):
        part = part.strip().lower()
        if part in ("", "auto"):
            continue
        k, _, v = part.partition("=")
        if k == "space":
            space_n = int(v)
        elif k == "time":
            time_n = int(v)
        else:
            raise ValueError(f"multi-process mesh spec {part!r}")
    if torch.device(device).type == "cuda":
        local_devs = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        n = (space_n or 1) * (time_n or 1) if space_n and time_n else nprocs
        if n % nprocs:
            raise ValueError(f"{n} ranks do not divide {nprocs} processes")
        local_devs = ["cpu"] * (n // nprocs)
    local = len(local_devs)
    mesh = multihost.global_mesh(space_n, time_n, devices=local_devs * nprocs,
                                 num_processes=nprocs,
                                 backend="nccl" if local_devs[0].startswith("cuda") else "gloo")
    return mesh, {"local": local, "rank_offset": proc_id * local,
                  "init_method": f"tcp://{coordinator}"}


def _volume_plane(frames, g, mesh, params, i, nplanes, bz):
    """One plane of a whole-clip slab through the sharded volume chain:
    this rank's shard in (its process's time slab, then its own rows),
    the whole output plane (gathered over the mesh) and the coded
    count's limbs out."""
    vol = np.ascontiguousarray(frames[: g.block.d, : g.truncated.h, : g.truncated.w])
    if mesh.procs > 1:
        # a process stages only its own time-contiguous slab
        per_proc = mesh.size // mesh.procs
        tl = g.block.d // mesh.procs
        proc = mesh.rank // per_proc
        shard = multihost.stage_global_cube(vol[proc * tl:(proc + 1) * tl], mesh)
    else:
        shard = torch.from_numpy(np.ascontiguousarray(
            msh.volume_sharding(mesh)(vol))).to(mesh.device)
    out, c = msh.motion_filter_volume_sharded(shard, mesh, geom=g, params=params,
                                              plane_index=i, nplanes=nplanes, bz=bz)
    return msh.volume_sharding(mesh).gather(out), c


def _pad_plane(p, tdims, i, quantise_u8):
    """An output plane at the container's plane dims: indivisible block
    grids truncate a plane's processed region (the reference leaves the
    surplus rows of its frame buffer stale, motion.c:437-439); pad
    emitted planes with zeros.  8-bit raw output is quantised here, on
    the device."""
    tw, th = tdims[i] if i < len(tdims) else tdims[-1]
    ph, pw = p.shape[1], p.shape[2]
    if (ph, pw) != (th, tw):
        p = torch.nn.functional.pad(p, (0, max(tw - pw, 0), 0, max(th - ph, 0)))[:, :th, :tw]
    if quantise_u8:
        p = torch.clamp(torch.round(p), 0, 255).to(torch.uint8)
    return p


if __name__ == "__main__":
    run_main(main)
