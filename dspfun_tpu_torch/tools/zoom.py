"""zoom — interpolate images with a cosine basis at arbitrary
scales/offsets (PyTorch port of ``dspfun_tpu/tools/zoom.py``).

CLI-compatible rebuild of reference zoom/zoom.c on the synthesis in
``dspfun_tpu_torch.models.zoom_pipeline``.  Run it as

    python -m dspfun_tpu_torch.tools.zoom [options] <input> <output>

It keeps the JAX tool's getopt surface, usage and help texts, exit codes
and messages, with these differences:

* ``--device cuda|cpu`` picks the torch device (default ``cuda``; without
  a card that is exit 1 "Bad --device", and ``--device cpu`` runs the
  kernels' plain versions).  The default precision policy is deep ``i8``
  on a CUDA device and ``hilo`` on the CPU (core/precision.py);
* ``--mesh`` (or ``DSPFUN_MESH``) shards each frame's synthesis rows
  over the ranks of ``tools.launch`` (every card with ``cuda``, one CPU
  rank per core with ``cpu``); where the JAX tool prints ``mesh
  unavailable (...); running single-device`` or refuses a time axis and
  runs on one device, this one prints the same and exits 1;
* an image or image sequence in a compressed format the port cannot
  write here (no ``cv2``) exits 1 before the input is read; every
  container the JAX tool writes, ``ffplay:`` and the ffmpeg bridge's
  encoders (``--ff-encoder``, ``--ff-opts``) are taken as there.

``LAST_STAGE_TIMES`` holds the last run's seconds per stage: ``read``,
``forward`` (copy to the device and DCT), then summed over the frames
``expr`` (the animation expressions), ``plan`` (the host's float64 basis
and its digit split, on the planned route), ``dispatch`` (host seconds
queueing a frame), ``wait`` (blocked on a frame's copy) and ``write``
(overlay, quantisation, file).  With ``TIME_DEVICE`` set (or
``DSPFUN_TIMINGS=1``) on a card, ``forward`` waits for the device and
``synth_device`` and ``pack_device`` are the frames' CUDA-event seconds;
otherwise no event is recorded and nothing waits.  ``routes`` lists
the route each frame took (``planned`` or ``device``), ``frames`` counts
them, ``payload_bytes`` is one frame's size on its way to the host.
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
from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import images, video
from dspfun_tpu_torch.io.device_pack import make_packer
from dspfun_tpu_torch.models import zoom_pipeline as zp
from dspfun_tpu_torch.ops.int8mm import ceil_to
from dspfun_tpu_torch.parallel.mesh import current_mesh
from dspfun_tpu_torch.tools import cli_device, launch, open_rank_output, resolve_mesh
from dspfun_tpu_torch.utils.checkpoint import load_state, save_state
from dspfun_tpu_torch.utils.hostcopy import finish_copy, start_copy
from dspfun_tpu_torch.utils.profiling import stage, timings_enabled

SHORT = "hs:v:p:cgaPr:%n:qx:y:S:X:Y:"
LONG = ["help", "showsamples=", "basis=",
        "ff-opts=", "ff-format=", "ff-encoder=", "ff-loglevel=", "ff-rate=",
        "mesh=", "resume-file=", "device="]

LAST_STAGE_TIMES: dict = {}
TIME_DEVICE = False    # record CUDA events around each frame's synthesis and packing

USAGE = ("Usage: zoom [(-s <scale> | -r <res>) -p <pos> -v <size> --basis <type> "
         "--showsamples[=<type>] -c -g -P -% -n -x -y -S -X -Y] <input> <output>")

HELP = """Usage: zoom [options] <input> <output>

  -h, --help  This help text.
  -s <scale>  Rational or decimal scale factor. May be a single value or XxY to specify horizontal/vertical scaling factors.
  -r <res>    Logical resolution in the form WxH. May be fractional. Takes precedence over -s.
  -p <pos>    Floating point offset in image, in the form XxY (e.g. 100.0x100.0). Coordinates are in terms of the scaled output unless -P is set
  -v <size>   Output view size in WxH.
  -c          Anchor view to center of image
  -P          Position coordinates with -p are relative to the input rather than the scaled output
  -%          Position coordinates with -p are a percent value rather than a number of samples
  -g          Scale in linear RGB
  -q          Don't output progress

  --showsamples[=<type>]  Show where integer coordinates in the input are located in the scaled image when upscaling.
                          type: point (default), grid.

  --basis <type>  Set the boundaries of the interpolated basis functions. [default: interpolated]
                  type: interpolated, native, centered

animation options:
  -n <frames>  Number of output frames [default: 1]
  -x <expr>    Expression animating the x coordinate
  -y <expr>    Expression animating the y coordinate
  -S <expr>    Expression animating the overall scale factor
  -X <expr>    Expression animating the horizontal scale factor (if different from -S)
  -Y <expr>    Expression animating the vertical scale factor (if different from -S)

output options:
   --device <cuda|cpu>     where to compute [default: cuda]
   --mesh <auto|N|space=N>  shard frame synthesis rows over a device mesh
   --ff-format <format>    output container format
   --ff-encoder <enc>      ffv1 or rawvideo (NUT; FFV1 is the default for integer pels)
   --ff-rate <rate>        output framerate
   --ff-opts <optstring>   output color property string (k=v:...)
   --ff-loglevel <int>     accepted for CLI parity
"""


def _parse_scale(arg: str):
    """'N[/D][xN2[/D2]]' (reference zoom.c:153-166)."""
    def one(tok):
        if "/" in tok:
            n, d = tok.split("/", 1)
            return float(n), float(d)
        return float(tok), 1.0

    if "x" in arg:
        xs, ys = arg.split("x", 1)
        return one(xs), one(ys)
    s = one(arg)
    return s, s


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    vx = vy = 0.0
    vw = vh = 0
    centered = input_coords = pct_coords = gamma = quiet = False
    showsamples = "none"
    xscale = (1.0, 1.0)
    yscale = (1.0, 1.0)
    logical_width = logical_height = 0.0
    scaling_type = "interpolated"
    nframes = 1
    rate = Fraction(60, 1)
    oopt = ofmt = codec = None
    mesh_spec = None
    resume_file = None
    device_arg = None
    exprstrs: list[str | None] = [None] * 5

    for flag, arg in flags:
        if flag in ("-h", "--help"):
            print(HELP, file=sys.stderr)
            return 0
        elif flag == "-s":
            try:
                xscale, yscale = _parse_scale(arg)
            except ValueError:
                print(USAGE, file=sys.stderr)
                return 1
        elif flag == "-r":
            try:
                parts = arg.split("x")
                logical_width = float(parts[0])
                if len(parts) > 1:
                    logical_height = float(parts[1])
            except ValueError:
                print(USAGE, file=sys.stderr)
                return 1
        elif flag == "-v":
            try:
                vw, vh = (int(t) for t in arg.split("x"))
            except ValueError:
                print(USAGE, file=sys.stderr)
                return 1
        elif flag == "-p":
            try:
                vx, vy = (float(t) for t in arg.split("x"))
            except ValueError:
                print(USAGE, file=sys.stderr)
                return 1
        elif flag == "-c":
            centered = True
        elif flag == "-P":
            input_coords = True
        elif flag == "-%":
            pct_coords = True
        elif flag == "-g":
            gamma = True
        elif flag == "-n":
            try:
                nframes = int(arg)
            except ValueError:
                print(USAGE, file=sys.stderr)
                return 1
        elif flag == "-q":
            quiet = True
        elif flag == "-x":
            exprstrs[0] = arg
        elif flag == "-y":
            exprstrs[1] = arg
        elif flag == "-S":
            exprstrs[2] = arg
        elif flag == "-X":
            exprstrs[3] = arg
        elif flag == "-Y":
            exprstrs[4] = arg
        elif flag == "--showsamples":
            showsamples = arg or "point"
            if showsamples not in ("point", "grid"):
                print(USAGE, file=sys.stderr)
                return 1
        elif flag == "--basis":
            if arg not in ("interpolated", "native", "centered"):
                print(USAGE, file=sys.stderr)
                return 1
            scaling_type = arg
        elif flag == "--ff-opts":
            oopt = arg
        elif flag == "--ff-format":
            ofmt = arg
        elif flag == "--ff-rate":
            rate = video.parse_rate(arg)
        elif flag == "--mesh":
            mesh_spec = arg
        elif flag == "--resume-file":
            resume_file = arg
        elif flag == "--device":
            device_arg = arg
        elif flag == "--ff-encoder":
            codec = arg
        elif flag == "--ff-loglevel":
            pass  # CLI parity only

    quiet |= nframes == 1
    if len(args) < 2:
        print(USAGE, file=sys.stderr)
        return 1

    exprnames = ("i", "n", "x", "y", "xs", "ys", "w", "h", "vw", "vh")
    exprs = []
    for src in exprstrs:
        try:
            exprs.append(parse_expr(src, exprnames) if src else None)
        except ValueError as e:
            print(f"Bad expression {src!r}: {e}", file=sys.stderr)
            return 1
    xexpr, yexpr, scaleexpr, xscaleexpr, yscaleexpr = exprs

    try:
        video.check_output(args[1], ofmt, codec)
    except ValueError as e:
        print(f"Error opening output context: {e}", file=sys.stderr)
        return 1
    try:
        device = cli_device(device_arg)
    except (RuntimeError, ValueError) as e:
        print(f"Bad --device: {e}", file=sys.stderr)
        return 1
    # --mesh: shard the per-frame synthesis over output rows (pure data
    # parallelism over the mesh 'space' axis; the spectrum is whole on
    # every rank)
    try:
        mesh = resolve_mesh(mesh_spec, device, "zoom --mesh shards space only (time=1); "
                                               "running single-device")
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if mesh is not None:
        if current_mesh() is None:
            return launch("dspfun_tpu_torch.tools.zoom", argv, mesh, args[0], quiet)
        device = mesh.device
    apply_tool_default("zoom", device)
    time_device = device.type == "cuda" and (TIME_DEVICE or timings_enabled())

    times: dict = {}
    try:
        with stage("read", times):
            img = images.read_image(args[0], channels="RGB", linear=gamma)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    gamma = gamma or img.linear
    height, width = img.pixels.shape[:2]

    with stage("forward", times):
        spectrum = zp.forward_spectrum(img.pixels, None, device)
        if time_device:
            torch.cuda.synchronize(device)

    if logical_width:
        xscale = (logical_width, float(width))
    if logical_height:
        yscale = (logical_height, float(height))
    xscale = zp.clamp_scale(width, *xscale)
    yscale = zp.clamp_scale(height, *yscale)

    if not vw or not vh:
        dvw, dvh = zp.default_view(width, height, xscale, yscale)
        vw = vw or dvw
        vh = vh or dvh

    vx, vy = zp.resolve_position(
        vx, vy, vw, vh, width, height, xscale, yscale,
        centered, input_coords, pct_coords,
    )

    try:
        # codec-addressed keys (FFV1 level/slices, negotiate) split off
        # to the writer; the rest parse as color properties
        prop_str, codec_opts = video.split_codec_opts(oopt)
        props = video.parse_color_props(prop_str)
    except ValueError as e:
        print(f"Bad --ff-opts option: {e}", file=sys.stderr)
        return 1
    props.pix_fmt = props.pix_fmt or "gbrpf32le"
    props.color_range = props.color_range or "jpeg"
    if gamma or not img.linear:
        props.color_trc = props.color_trc or "iec61966-2-1"
        props.color_space = props.color_space or "rgb"
        props.color_primaries = props.color_primaries or "bt709"
    # checkpoint/resume: re-run the cheap host-side expression history
    # for completed frames and append from the recorded index
    start_frame = 0
    if resume_file:
        st = load_state(resume_file)
        # vx/vy are post-resolve (covering -p/-c/-P/-%), so a rerun
        # with a different camera position or -g restarts instead of
        # appending frames from a different path onto the old ones
        zoom_cfg = [vw, vh, nframes, scaling_type,
                    list(map(str, exprstrs)), list(xscale), list(yscale),
                    float(vx), float(vy), int(bool(gamma))]
        if st.get("cfg") == zoom_cfg:
            start_frame = min(int(st.get("frame", 0)), nframes)

    try:
        writer = open_rank_output(mesh, lambda path, primary: video.open_output(
            path, vw, vh, rate, props, format=ofmt, codec=codec,
            options=codec_opts or None, append=start_frame > 0 and primary), args[1])
    except Exception as e:  # noqa: BLE001
        print(f"Error opening output context: {e}", file=sys.stderr)
        return 1
    trc_encode = gamma and writer.props.color_trc == "iec61966-2-1"

    # pane-free frames pack to container payload bytes on the device
    # (io/device_pack): fewer bytes to the host and no host conversion
    packer = None
    if showsamples == "none" and writer.supports_payload():
        packer = make_packer(writer.pix_fmt, writer.props, vh, vw)

    def add(name, dt):
        times[name] = times.get(name, 0.0) + dt

    routes: list[str] = []
    device_events: list[tuple] = []

    def emit(dd, handle, xs, ys, cvx, cvy):
        t0 = time.perf_counter()
        buf = finish_copy(handle)
        t1 = time.perf_counter()
        add("wait", t1 - t0)
        if packer is not None:
            times["payload_bytes"] = buf[0].nbytes
            writer.write_frame_payload(buf[0].tobytes())
        else:
            times["payload_bytes"] = buf.nbytes
            frame = np.asarray(buf, dtype=np.float64)
            frame = zp.overlay_showsamples(frame, showsamples, xs, ys,
                                           cvx, cvy)
            writer.write_frame_rgb(frame)
        if resume_file and (mesh is None or mesh.rank == 0):
            save_state(resume_file, {"cfg": zoom_cfg, "frame": dd + 1})
        add("write", time.perf_counter() - t1)
        if not quiet:
            print(f"\r{dd}/{nframes}         ", end="", file=sys.stderr)

    # one-frame lookahead: frame d+1's compute is dispatched before
    # frame d is materialised on the host, so the device->host copy
    # overlaps the next frame's compute — each frame's copy goes into a
    # pinned buffer behind a CUDA event of its own (utils/hostcopy.py),
    # the same pattern as models/scan_pipeline.scan_chunks
    pending = None
    try:
        for d in range(nframes):
            t_expr = time.perf_counter()
            env = {
                "i": float(d), "n": float(nframes), "x": vx, "y": vy,
                "xs": xscale[0] / xscale[1], "ys": yscale[0] / yscale[1],
                "w": float(width), "h": float(height),
                "vw": float(vw), "vh": float(vh),
            }
            if scaleexpr:
                s = float(scaleexpr(env, math_env()))
                xscale = yscale = (s, 1.0)
            if xscaleexpr:
                xscale = (float(xscaleexpr(env, math_env())), 1.0)
            if yscaleexpr:
                yscale = (float(yscaleexpr(env, math_env())), 1.0)
            env["xs"] = xscale[0] / xscale[1]
            env["ys"] = yscale[0] / yscale[1]
            if xexpr:
                vx = float(xexpr(env, math_env()))
            if yexpr:
                vy = float(yexpr(env, math_env()))

            add("expr", time.perf_counter() - t_expr)

            if not all(map(math.isfinite, (vx, vy, env["xs"], env["ys"]))):
                print(f"Skipping non-finite expression result at frame {d}",
                      file=sys.stderr)
                continue

            if d < start_frame:  # resumed: expression state replayed only
                continue

            accurate = zp.device_basis_accurate(vw, vh, vx, vy, xscale,
                                                yscale, width, height,
                                                scaling_type)
            # static basis params (a still, or an animation whose
            # expressions are absent): the planned host-float64 basis
            # is both the accuracy path (basis exact; contraction-only
            # error) and the fast path (plans cache; each dispatch is
            # two planned contractions, no in-graph basis generation)
            static_basis = not any(
                (xexpr, yexpr, scaleexpr, xscaleexpr, yscaleexpr))
            planned = static_basis or not accurate
            routes.append("planned" if planned else "device")
            plans = None
            if planned:
                # the host's float64 basis and its plan: cached for a
                # still, built anew for every frame of a moving view
                t_plan = time.perf_counter()
                vhp = vh if mesh is None else ceil_to(vh, mesh.shape["space"])
                plans = zp.zoom_plan(scaling_type, xscale, yscale, vx, vy,
                                     vw, vhp, width, height, None,
                                     spectrum.device)
                add("plan", time.perf_counter() - t_plan)
            t_disp = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
                if time_device else None
            if ev:
                ev[0].record()
            if planned:
                # the planned host-float64-basis path (accuracy + speed
                # for fixed params)
                dev = zp.zoom_frame(spectrum, scaling_type, xscale, yscale,
                                    vx, vy, vw, vh, encode_trc=trc_encode,
                                    plans=plans, mesh=mesh)
            else:
                dev = zp.zoom_frame_device(spectrum, scaling_type, xscale,
                                           yscale, vx, vy, vw, vh,
                                           encode_trc=trc_encode, mesh=mesh)
            if ev:
                ev[1].record()
            buf = packer(dev[None]) if packer is not None else dev
            if ev:
                ev[2].record()
                device_events.append(ev)
            handle = start_copy(buf)
            del dev, buf
            add("dispatch", time.perf_counter() - t_disp)
            if pending is not None:
                emit(*pending)
            pending = (d, handle, env["xs"], env["ys"], vx, vy)
        if pending is not None:
            emit(*pending)
        if not quiet:
            print(f"\r{nframes}/{nframes}         ", file=sys.stderr)
    finally:
        writer.close()
    if device_events:
        torch.cuda.synchronize(device)
        times["synth_device"] = sum(e[0].elapsed_time(e[1]) for e in device_events) / 1e3
        times["pack_device"] = sum(e[1].elapsed_time(e[2]) for e in device_events) / 1e3
        if timings_enabled():
            for name in ("synth_device", "pack_device"):
                print(f"[dspfun] {name}: {times[name] * 1000:.1f} ms", file=sys.stderr)
    times["routes"] = routes
    times["frames"] = len(routes)
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return 0


def math_env():
    return np


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
