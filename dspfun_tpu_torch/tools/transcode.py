"""transcode — simple transcoder / video-layer test utility (PyTorch port
of ``dspfun_tpu/tools/transcode.py``).

CLI-compatible rebuild of reference motion/transcode.c ("meant for
testing dspfun's FFmpeg API wrapper", motion/README.md:127): a
decode -> encode pass-through exercising the container layer.  Host
work only, as in the JAX package.

It keeps the JAX tool's getopt string, help text, exit codes and
messages, on the port's containers (see ``tools/rotate.py``): FFV1 is
the default encoder of NUT and Matroska outputs, ``-e rawvideo`` writes
raw NUT planes, and every other container and encoder goes through the
ffmpeg bridge, as in the JAX tool.

``LAST_STAGE_TIMES`` holds the last run's seconds: ``copy`` (read,
convert and write, frame by frame).
"""

from __future__ import annotations

import getopt
import sys

from dspfun_tpu_torch.io import video
from dspfun_tpu_torch.utils.profiling import stage

USAGE = "Usage: transcode [options] <input> <output>"

HELP = """Usage: transcode [options] <infile> <outfile>

  -h                  This help text.
  -s <start:nframes>  Starting frame number and total number of frames of input to use.
  -r <rational>       Output framerate. [default: input rate]
  -q                  Don't print progress.

  -o <optstring>  decoder options (accepted for CLI parity)
  -O <optstring>  encoder options (FFV1: level=3:slices=N:slicecrc=1, negotiate=1)
  -f <fmt>        input format name (e.g. for pipe input).
  -F <fmt>        output format name. [default: from output file extension]
  -c <optstring>  Option string specifying the pixel format and color properties to convert to for processing.
  -e <enc>        output encoder name. [default: FFV1 or selected by format]
  -l <int>        log level (accepted for CLI parity)
"""

LAST_STAGE_TIMES: dict = {}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, "o:O:f:F:c:e:l:r:s:qh")
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return 1

    rate = None
    frames = 0
    offset = 0
    quiet = False
    ifmt = ofmt = cprops = codec = encopts = None
    for flag, arg in flags:
        if flag == "-h":
            print(HELP)
            return 0
        elif flag == "-s":
            start, _, n = arg.partition(":")
            offset = int(start or 0)
            frames = int(n or 0)
        elif flag == "-r":
            rate = video.parse_rate(arg)
        elif flag == "-q":
            quiet = True
        elif flag == "-f":
            ifmt = arg
        elif flag == "-F":
            ofmt = arg
        elif flag == "-c":
            cprops = arg
        elif flag == "-e":
            codec = arg  # native ffv1/rawvideo, else the ffmpeg bridge
        elif flag == "-O":
            encopts = arg  # encoder options (FFV1 level/slices, bridge)
        # -o, -l: parity only

    if len(args) < 2:
        print(USAGE, file=sys.stderr)
        return 1

    try:
        reader = video.open_input(args[0], format=ifmt)
    except Exception as e:  # noqa: BLE001
        print(f"Error opening input context: {e}", file=sys.stderr)
        return 1

    try:
        props = video.parse_color_props(cprops)
    except ValueError as e:
        print(f"Bad -c option: {e}", file=sys.stderr)
        reader.close()
        return 1
    convert = bool(props.pix_fmt) and props.pix_fmt != reader.pix_fmt.name
    # a matrix change needs re-encoding through RGB; range changes are
    # handled by the normalized [0,1] pass-through itself (reference
    # applies the full --csp request via swscale, ffapi.c:283-326)
    if props.color_space and props.color_space != reader.props.color_space:
        convert = True
    if not props.pix_fmt:
        props.pix_fmt = reader.pix_fmt.name
    for field in ("color_range", "color_primaries", "color_trc",
                  "color_space", "chroma_location"):
        if getattr(props, field) is None:
            setattr(props, field, getattr(reader.props, field))

    nframes = reader.frames or 0
    if frames:
        nframes = frames
    else:
        nframes -= min(nframes, offset)
    reader.seek_frame(offset)

    try:
        writer = video.open_output(
            args[1], reader.width, reader.height, rate or reader.rate,
            props, format=ofmt, codec=codec, options=encopts,
        )
    except Exception as e:  # noqa: BLE001
        print(f"Error opening output context: {e}", file=sys.stderr)
        reader.close()
        return 1

    # the container may negotiate a different format than requested
    # (e.g. yuv420p -> fvid float, gbrpf32le -> y4m yuv444p): the raw
    # plane pass-through would then mislabel components/geometry
    if writer.pix_fmt.name != reader.pix_fmt.name:
        convert = True
    raw_copy = not convert and (
        writer.pix_fmt.is_float
        or writer.props.color_range == reader.props.color_range)

    ret = 0
    times: dict = {}
    try:
        with stage("copy", times):
            z = 0
            while nframes == 0 or z < nframes:
                if convert:
                    rgb = reader.read_frame_rgb()
                    if rgb is None:
                        frame_done = False
                    else:
                        writer.write_frame_rgb(rgb)
                        frame_done = True
                else:
                    # same-format same-range pass-through copies stored
                    # pels directly (byte-exact, incl. out-of-range mpeg
                    # values), like the reference's pel loop
                    # (transcode.c:107-121); a range-only mismatch keeps
                    # the dequantize->requantize path, which converts
                    planes = reader.read_frame(raw=raw_copy)
                    if planes is None:
                        frame_done = False
                    else:
                        writer.write_frame(planes, raw=raw_copy)
                        frame_done = True
                if not frame_done:
                    # stream ended before the expected count: reference
                    # reports the read error and fails (transcode.c:107,125)
                    if nframes:
                        if not quiet:
                            print(file=sys.stderr)
                        print("Error reading frame: end of stream",
                              file=sys.stderr)
                        ret = 1
                    break
                if not quiet:
                    print(f"\r{z}", end="", file=sys.stderr)
                z += 1
            if not quiet:
                print(file=sys.stderr)
    finally:
        writer.close()
        reader.close()
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return ret


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
