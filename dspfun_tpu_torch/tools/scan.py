"""scan — progressively reconstruct images using frequency-space scans
(PyTorch port of ``dspfun_tpu/tools/scan.py``).

CLI-compatible rebuild of reference scan/scan.c on the batched pipeline
in ``dspfun_tpu_torch.models.scan_pipeline``.  Run it as

    python -m dspfun_tpu_torch.tools.scan [options] <input> <output>

It keeps the JAX tool's getopt surface, usage text, exit codes and
messages, with these differences:

* ``--device cuda|cpu`` picks the torch device (default ``cuda``; without
  a card that is exit 1 "Bad --device", and ``--device cpu`` runs the
  kernels' plain versions);
* ``--mesh`` (or ``DSPFUN_MESH``) shards the reconstruction rows over
  the ranks of ``tools.launch`` (every card with ``cuda``, one CPU rank
  per core with ``cpu``); where the JAX tool prints ``mesh unavailable
  (...); running single-device`` or refuses a time axis and runs on one
  device, this one prints the same and exits 1;
* an image sequence in a compressed format the port cannot write here
  (no ``cv2``) exits 1 before the input is read; every container the
  JAX tool writes, ``ffplay:`` and the ffmpeg bridge's encoders
  (``--ff-encoder``, ``--ff-opts``) are taken as there.

``LAST_STAGE_TIMES`` holds the last run's seconds per stage: ``read``,
``forward`` (copy to the device, DCT, coefficients back), ``order`` (the
scan method on the host), ``plan``, then over all chunks ``dispatch``
(host seconds queueing device work), ``wait`` (blocked on results) and
``emit`` (panes, quantisation, file); ``chunk_device_ms`` lists each
chunk's device time on a card, and ``frames`` counts what was written.
"""

from __future__ import annotations

import getopt
import math
import sys
import time
from fractions import Fraction

import numpy as np

from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import images, video
from dspfun_tpu_torch.io.device_pack import make_packer
from dspfun_tpu_torch.models import scan_pipeline as sp
from dspfun_tpu_torch.ops import scan_methods as sm
from dspfun_tpu_torch.ops import scan_order as so
from dspfun_tpu_torch.ops.speclib import SpecParams, SpecScaler, parse_spec_params
from dspfun_tpu_torch.parallel.mesh import current_mesh
from dspfun_tpu_torch.tools import cli_device, launch, open_rank_output, resolve_mesh
from dspfun_tpu_torch.utils.checkpoint import load_state, save_state
from dspfun_tpu_torch.utils.profiling import stage

SHORT = "hHqm:o:vsiMS:In:O:gp:f:t:P"
LONG = [
    "help", "fullhelp", "quiet", "method=", "options=", "visualize",
    "spectrogram", "intermediates", "max-intermediates", "step=", "invert",
    "frames=", "offset=", "skip", "linear", "pruned-idct=",
    "serialization-file=", "serialization-format=", "measure-parity",
    "ff-opts=", "ff-format=", "ff-encoder=", "ff-loglevel=", "ff-rate=",
    "spec-gain=", "spec-opts=", "fftw-threads=", "mesh=", "resume-file=",
    "device=",
]

LAST_STAGE_TIMES: dict = {}

USAGE = """Usage: scan [options] <input> <output>
options:
   -h, --help                        this help text
   -H, --fullhelp                    print available scan methods, serialization formats, and spectrogram options
   -q, --quiet                       don't output scan progress
   -m, --method <name>               scan method
   -o, --options <optstring>         scan-specific options
   -v, --visualize                   show scan in frequency-space
   -s, --spectrogram                 show scan over image spectrogram (implies -v)
   -i, --intermediates               show transform intermediates for current index (stacks with -v/-s)
   -M, --max-intermediates           use full range for transform intermediates. may produce bright flashing in the output. (implies -i)
   -S, --step <int>                  number of scan iterations per frame of output
   -I, --invert                      invert scan order
   -n, --frames <int>                limit the number of frames of output
   -O, --offset <int>                offset into scan to start at
       --skip                        don't fill previous scan indexes when jumping to an offset with --offset
   -g, --linear                      operate in linear light
   -p, --pruned-idct <bool>          use built-in pruned idct instead of the dense batched IDCT [default: auto based on scan interval]
   -f, --serialization-file <path>   serialize scan to file
   -t, --serialization-format <fmt>  scan format to serialize (with -f)
   -P, --measure-parity              print the scan index at which the reconstructed image becomes identical to the original

output options:
   --device <cuda|cpu>     where to compute [default: cuda]
   --mesh <auto|N|space=N>  shard reconstruction rows over a device mesh
   --ff-format <format>    output container format (y4m, fvid, nut, matroska, image2)
   --ff-encoder <enc>      ffv1 or rawvideo (NUT; FFV1 is the default for integer pels)
   --ff-rate <rate>        output framerate
   --ff-opts <optstring>   output color property string (k=v:...)
   --ff-loglevel <int>     accepted for CLI parity

spec options:
   --spec-gain <float>      spectrogram log multiplier (with -s)
   --spec-opts <optstring>  spectrogram options string (k=v:...) (with -s)
"""


def fullhelp() -> None:
    print(USAGE, file=sys.stderr)
    width = max(len(n) for n in sm.method_names())
    print(f"{'scan methods':<{width + 3}} - options", file=sys.stderr)
    for name in sm.method_names():
        opts = sm.method_options(name)
        line = f"   {name:<{width}}"
        if opts:
            line += f" - {opts}"
        print(line, file=sys.stderr)
    print("\nserialization formats:", file=sys.stderr)
    for k in so.SERIALIZATION_FORMATS:
        print(f"   {k}", file=sys.stderr)
    print("\nspectrogram option string keys and values:", file=sys.stderr)
    print("   scale = linear, log\n   sign = abs, shift, saturate\n"
          "   preset = abs, shift, flat, signmap", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("scan")
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    method = "diag"
    scan_options = None
    serialized_scan = None
    serialization_format = "coordinate"
    nframes = 0
    offset = 0
    step = 1
    quiet = spec = visualize = intermediates = max_intermediates = False
    invert = linear = measure_parity = False
    fill_offset = True
    use_pruned: bool | None = None
    gain = 0.0
    sparams = SpecParams()
    rate = Fraction(20, 1)
    ofmt = None
    oopt = codec = None
    mesh_spec = None
    resume_file = None
    device_arg = None

    for flag, arg in flags:
        if flag in ("-h", "--help"):
            print(USAGE, file=sys.stderr)
            return 0
        elif flag in ("-H", "--fullhelp"):
            fullhelp()
            return 0
        elif flag in ("-q", "--quiet"):
            quiet = True
        elif flag in ("-m", "--method"):
            method = arg
        elif flag in ("-n", "--frames"):
            nframes = int(arg)
        elif flag in ("-s", "--spectrogram"):
            spec = visualize = True
        elif flag in ("-v", "--visualize"):
            visualize = True
        elif flag in ("-S", "--step"):
            step = int(arg)
        elif flag in ("-I", "--invert"):
            invert = True
        elif flag in ("-o", "--options"):
            scan_options = arg
        elif flag in ("-i", "--intermediates"):
            intermediates = True
        elif flag in ("-g", "--linear"):
            linear = True
        elif flag in ("-M", "--max-intermediates"):
            intermediates = max_intermediates = True
        elif flag in ("-p", "--pruned-idct"):
            low = arg.strip().lower()
            if low in ("true", "1", "yes"):
                use_pruned = True
            elif low in ("false", "0", "no"):
                use_pruned = False
            elif low == "auto":
                use_pruned = None
            else:
                print(f"invalid --pruned-idct value {arg!r} "
                      "(true|false|auto)", file=sys.stderr)
                return 1
        elif flag in ("-f", "--serialization-file"):
            serialized_scan = arg
        elif flag in ("-t", "--serialization-format"):
            if arg not in so.SERIALIZATION_FORMATS:
                print("Invalid serialization format. Options:", file=sys.stderr)
                for k in so.SERIALIZATION_FORMATS:
                    print(k, file=sys.stderr)
                return 1
            serialization_format = arg
        elif flag in ("-O", "--offset"):
            offset = int(arg)
        elif flag in ("-P", "--measure-parity"):
            measure_parity = True
        elif flag == "--skip":
            fill_offset = False
        elif flag == "--ff-opts":
            oopt = arg
        elif flag == "--ff-format":
            ofmt = arg
        elif flag == "--mesh":
            mesh_spec = arg
        elif flag == "--resume-file":
            resume_file = arg
        elif flag == "--device":
            device_arg = arg
        elif flag == "--ff-encoder":
            codec = arg
        elif flag in ("--ff-loglevel", "--fftw-threads"):
            pass  # CLI parity only
        elif flag == "--ff-rate":
            rate = video.parse_rate(arg)
        elif flag == "--spec-gain":
            gain = float(arg)
        elif flag == "--spec-opts":
            try:
                sparams = parse_spec_params(arg, params=sparams)
            except ValueError as e:
                print(f"Couldn't parse spec option: {e}", file=sys.stderr)
                return 1

    if not args:
        print(USAGE, file=sys.stderr)
        return 1

    m = sm.find_method_prefix(method)
    if m is None:
        print(f"Invalid method '{method}'. Choose one of:", file=sys.stderr)
        for name in sm.method_names():
            print(name, file=sys.stderr)
        return 0

    if len(args) > 1:
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
    # --mesh: shard reconstruction rows over the mesh 'space' axis
    # (collective-free but for the gather; coefficients whole on every
    # rank; any height, rows pad internally, and any intermediates mode)
    try:
        mesh = resolve_mesh(mesh_spec, device, "scan --mesh shards space only (time=1); "
                                               "running single-device")
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if mesh is not None:
        if current_mesh() is None:
            return launch("dspfun_tpu_torch.tools.scan", argv, mesh, args[0], quiet)
        device = mesh.device

    times: dict = {}
    try:
        with stage("read", times):
            img = images.read_image(args[0], channels="RGB", linear=linear)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    linear = linear or img.linear
    height, width = img.pixels.shape[:2]
    channels = 3
    original_depth = img.depth

    with stage("forward", times):
        coeffs = sp.forward_coeffs(img.pixels, None, device)
        coeffs_np = coeffs.cpu().numpy().astype(np.float64)

    try:
        with stage("order", times):
            order = m.build(width, height, channels, coeffs_np, scan_options)
    except Exception as e:  # noqa: BLE001
        print(f"Error initializing scan: {e}", file=sys.stderr)
        return 1

    if serialized_scan and (mesh is None or mesh.rank == 0):
        try:
            with open(serialized_scan, "w") as f:
                f.write(so.serialize(order, serialization_format))
        except OSError as e:
            print(f"Error opening {serialized_scan}: {e}", file=sys.stderr)
            return 1
    if len(args) <= 1:
        return 0

    # chunk size: fewer dispatches amortise per-dispatch latency, capped
    # so a chunk's [F, H, W, C] buffers stay ~256 MB (the JAX tool's
    # rule, kept so both tools cut the schedule alike)
    chunk = int(max(4, min(64, 16_000_000 // max(1, width * height * channels))))
    with stage("plan", times):
        plan = sp.plan_scan(
            order, width, height, channels, step=step, nframes=nframes,
            offset=offset, invert=invert, use_pruned=use_pruned, chunk=chunk,
            device=device,
        )
    if not fill_offset:
        plan.fill_ys = np.empty(0, np.int32)
        plan.fill_xs = np.empty(0, np.int32)

    # checkpoint/resume: completed frames move into the prefill set and
    # the schedule restarts from the recorded frame (append-mode writer)
    start_frame = 0
    if resume_file:
        st = load_state(resume_file)
        cfg = [width, height, step, offset, int(invert), plan.nframes,
               m.name, scan_options or "", int(fill_offset)]
        if st.get("cfg") == cfg:
            start_frame = min(int(st.get("frame", 0)), plan.nframes)
        if start_frame:
            done = plan.valid[:start_frame]
            plan.fill_ys = np.concatenate(
                [plan.fill_ys, plan.ys[:start_frame][done]])
            plan.fill_xs = np.concatenate(
                [plan.fill_xs, plan.xs[:start_frame][done]])
            plan.ys = plan.ys[start_frame:]
            plan.xs = plan.xs[start_frame:]
            plan.valid = plan.valid[start_frame:]
            plan.nframes -= start_frame
            npad = (-plan.ys.shape[0]) % plan.chunk
            if npad:
                kmax = plan.ys.shape[1]
                plan.ys = np.concatenate(
                    [plan.ys, np.zeros((npad, kmax), np.int32)])
                plan.xs = np.concatenate(
                    [plan.xs, np.zeros((npad, kmax), np.int32)])
                plan.valid = np.concatenate(
                    [plan.valid, np.zeros((npad, kmax), bool)])
            if not quiet:
                print(f"resuming at frame {start_frame}", file=sys.stderr)

    out_w = width * (2 if visualize else 1)
    out_h = height * (2 if intermediates else 1)
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
    if linear or not img.linear:
        props.color_trc = props.color_trc or "iec61966-2-1"
        props.color_space = props.color_space or "rgb"
        props.color_primaries = props.color_primaries or "bt709"
    try:
        writer = open_rank_output(mesh, lambda path, primary: video.open_output(
            path, out_w, out_h, rate, props, format=ofmt, codec=codec,
            options=codec_opts or None, append=start_frame > 0 and primary), args[1])
    except Exception as e:  # noqa: BLE001
        print(f"Error opening output context: {e}", file=sys.stderr)
        return 1

    trc_encode = linear and writer.props.color_trc == "iec61966-2-1"

    # spectrogram scaler for the viz pane (reference scan.c:365-375)
    scaler = None
    if spec:
        if not gain:
            gain = 127.5 * math.sqrt(width * height * 4)
        max_dc = float(coeffs_np[0, 0, :].max())
        scaler = SpecScaler(params=sparams, max_input=max_dc, gain=gain)

    # paint values for the viz pane are static per coordinate
    def paint_values(ys, xs):
        if scaler is None:
            return np.ones((len(ys), channels))
        norm = (np.where(np.asarray(xs) > 0, math.sqrt(2.0), 1.0)
                * np.where(np.asarray(ys) > 0, math.sqrt(2.0), 1.0))
        return np.asarray(
            scaler.scale(coeffs_np[ys, xs, :] * norm[:, None], xp=np)
        )

    canvas = np.zeros((out_h, out_w, channels), dtype=np.float32)
    if len(plan.fill_ys) and visualize:
        canvas[plan.fill_ys, plan.fill_xs + width] = paint_values(
            plan.fill_ys, plan.fill_xs
        )

    total_frames = start_frame + plan.nframes
    pad = int(math.log10(max(plan.nframes, 1))) + 1
    parity_index = total_frames
    frame_count = 0
    try:
        # pane-free runs pack frames to container payload bytes on the
        # device (io/device_pack): 4-12x fewer bytes to the host and no
        # host-side conversion
        packer = None
        if not visualize and not intermediates and writer.supports_payload():
            packer = make_packer(writer.pix_fmt, writer.props,
                                 height, width)

        # the reconstruction panes come back display-ready: sRGB
        # encoding and intermediates normalisation run on the device per
        # chunk (the host loop only assembles panes and writes bytes)
        for start, res in sp.scan_chunks(
            plan, coeffs,
            orig=img.pixels if measure_parity else None,
            parity_depth=original_depth,
            encode_trc=trc_encode,
            inter_mode=(("minmax" if max_intermediates else "unit")
                        if intermediates else None),
            packer=packer,
            times=times,
            mesh=mesh,
        ):
            t_emit = time.perf_counter()
            nf = (res.payload if res.sums is None else res.sums).shape[0]
            for k in range(nf):
                f = start + k
                if res.payload is not None:
                    writer.write_frame_payload(res.payload[k].tobytes())
                    frame_count += 1
                    if res.parity is not None and res.parity[k] \
                            and parity_index > start_frame + f:
                        parity_index = start_frame + f
                    if not quiet:
                        print(f"\r{frame_count:>{pad}} / {plan.nframes}",
                              end="", file=sys.stderr)
                    continue
                ys = plan.ys[f][plan.valid[f]]
                xs = plan.xs[f][plan.valid[f]]
                if visualize:
                    canvas[ys, xs + width] = paint_values(ys, xs)
                    if intermediates:
                        canvas[ys + height, xs + width] = canvas[ys, xs + width]
                canvas[:height, :width] = res.sums[k]
                if intermediates:
                    canvas[height:, :width] = res.inter[k]
                # float containers keep raw values; int formats clip at
                # quantisation (as ffapi_setpelf does for 8-bit)
                writer.write_frame_rgb(canvas)
                frame_count += 1
                if not quiet:
                    print(f"\r{frame_count:>{pad}} / {plan.nframes}",
                          end="", file=sys.stderr)
                if intermediates and visualize:
                    canvas[ys + height, xs + width] = 0.0
                if res.parity is not None and res.parity[k] \
                        and parity_index > start_frame + f:
                    parity_index = start_frame + f
            if resume_file and (mesh is None or mesh.rank == 0):
                save_state(resume_file, {
                    "cfg": [width, height, step, offset, int(invert),
                            start_frame + plan.nframes,
                            m.name, scan_options or "", int(fill_offset)],
                    "frame": start_frame + frame_count,
                })
            times["emit"] = times.get("emit", 0.0) + time.perf_counter() - t_emit
    finally:
        writer.close()
    times["frames"] = frame_count
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    if not quiet:
        print(file=sys.stderr)

    if measure_parity:
        if parity_index == total_frames:
            print("Didn't reach parity with the original image before the "
                  "end of the scan.", file=sys.stderr)
        else:
            print(f"Reached parity with the original image at scan index "
                  f"{parity_index}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
