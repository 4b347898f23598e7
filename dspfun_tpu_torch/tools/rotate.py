"""rotate — rotate video by right angles on a 3-dimensional axis (PyTorch
port of ``dspfun_tpu/tools/rotate.py``).

CLI-compatible rebuild of reference motion/rotate.c: buffers the whole
clip, permutes/flips the (x, y, t) axes, rewrites.  Host work only, as
in the JAX package.

    90 deg ccw = +y-x+z     90 deg cw = -y+x+z     180 deg = -x-y+z

It keeps the JAX tool's getopt string, help text, exit codes and
messages, on the port's containers (``io/video.py``): y4m, fvid, NUT,
Matroska (FFV1 by default wherever it codes the pixel format; ``-e
rawvideo`` for raw NUT planes; ``-O`` the encoder's options) and image
sequences natively, and every other container and encoder (``-e``)
through the ffmpeg bridge, as the JAX tool does.

``LAST_STAGE_TIMES`` holds the last run's seconds per stage: ``read``
(the whole clip), ``rotate`` and ``write``.
"""

from __future__ import annotations

import getopt
import sys
from fractions import Fraction

import numpy as np

from dspfun_tpu_torch.io import video
from dspfun_tpu_torch.utils.profiling import stage

USAGE = "Usage: rotate [options] [-]xyz <infile> <outfile>"

HELP = """Usage: rotate [options] [-]xyz <infile> <outfile>

  [-]xyz  How to rearrange the input dimensions, with -/+ to indicate direction.
          e.g. "zyx" swaps the x and z axis while "x-yz" results in a vertical flip.

  -h                  This help text.
  -s <start:nframes>  Starting frame number and total number of frames of input to use.
  -r <rational>       Output framerate or "same" to match input duration. [default: input rate]
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


def parse_axis_map(spec: str) -> tuple[list[int], list[bool]]:
    """Parse "[-]x[-]y[-]z" into (map, invert) — ``map[i]`` is the
    source axis (0=x,1=y,2=z) placed at position i, ``invert[i]`` the
    sign parsed at position i (reference rotate.c:74-89; note the
    reference *applies* the flip as invert[map[i]])."""
    m = []
    inv = []
    pos = 0
    for _ in range(3):
        neg = False
        if pos < len(spec) and spec[pos] in "+-":
            neg = spec[pos] == "-"
            pos += 1
        if pos >= len(spec):
            break
        ax = ord(spec[pos]) - ord("x")
        pos += 1
        if ax < 0 or ax > 2:
            raise ValueError(f"bad axis in {spec!r}")
        m.append(ax)
        inv.append(neg)
    if len(m) != 3 or sorted(m) != [0, 1, 2]:
        raise ValueError(f"bad axis map {spec!r}")
    return m, inv


def rotate_volume(vol: np.ndarray, axmap: list[int], invert: list[bool]) -> np.ndarray:
    """Permute/flip a [T, H, W, ...] volume.

    Implements the reference's index map (rotate.c:159-172):
    out[a_{map0}, a_{map1}, a_{map2}] = in[flip(a_0), flip(a_1), flip(a_2)]
    where source axis j is reversed iff invert[map[j]].
    """
    # convert to x,y,z axis order: A[x, y, z]
    a = np.moveaxis(vol, (0, 1, 2), (2, 1, 0))
    for j in range(3):
        if invert[axmap[j]]:
            a = np.flip(a, axis=j)
    a = np.transpose(a, axes=axmap + list(range(3, a.ndim)))
    # back to [T', H', W', ...]
    return np.moveaxis(a, (0, 1, 2), (2, 1, 0))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, "o:O:f:F:c:e:l:r:s:hq")
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return 1

    rate = None
    samedur = False
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
            if arg == "same":
                samedur = True
            else:
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

    if len(args) < 3:
        print(USAGE, file=sys.stderr)
        return 1
    try:
        axmap, invert = parse_axis_map(args[0])
    except ValueError:
        print(USAGE, file=sys.stderr)
        return 1

    times: dict = {}
    try:
        reader = video.open_input(args[1], format=ifmt)
    except Exception as e:  # noqa: BLE001
        print(f"error opening input file {args[1]}: {e}", file=sys.stderr)
        return 1
    # rotation needs non-subsampled pixels (reference rotate.c:14-16);
    # subsampled input — or a --csp pixel-format/matrix override
    # (reference ffapi.c:94-114 applies the full request) — is
    # converted through RGB
    try:
        req_props = video.parse_color_props(cprops)
    except ValueError as e:
        print(f"Bad -c option: {e}", file=sys.stderr)
        return 1
    needs_rgb = reader.pix_fmt.chroma_shift != (0, 0)
    if req_props.pix_fmt and req_props.pix_fmt != reader.pix_fmt.name:
        needs_rgb = True
    if req_props.color_space and \
            req_props.color_space != reader.props.color_space:
        needs_rgb = True

    reader.seek_frame(offset)
    nframes = reader.frames or 0
    if nframes:
        nframes -= offset
    if frames and nframes:
        nframes = min(frames, nframes)
    elif frames:
        nframes = frames

    vol_frames = []
    z = 0
    with stage("read", times):
        while nframes == 0 or z < nframes:
            if needs_rgb:
                f = reader.read_frame_rgb()
                planes = None if f is None else [f[..., 0], f[..., 1], f[..., 2]]
            else:
                # buffer the whole clip at stored pel depth (u8/u16), like
                # the reference's direct pel copies (rotate.c:139-172):
                # 4x less RAM than float planes and byte-exact passthrough
                # (out-of-range mpeg pels survive)
                planes = reader.read_frame(raw=True)
            if planes is None:
                if nframes:
                    # reference fails the whole run when the clip is
                    # shorter than the frame budget (rotate.c:141-147)
                    if not quiet:
                        print(file=sys.stderr)
                    print("Error reading frame: end of stream", file=sys.stderr)
                    reader.close()
                    return 1
                break
            vol_frames.append(np.stack(planes, axis=-1))
            if not quiet:
                print(f"\r{z}", end="", file=sys.stderr)
            z += 1
    if not quiet:
        print(file=sys.stderr)
    reader.close()
    if not vol_frames:
        print("no input frames", file=sys.stderr)
        return 1

    with stage("rotate", times):
        vol = np.stack(vol_frames)  # [T, H, W, C]
        del vol_frames
        lens = [vol.shape[2], vol.shape[1], vol.shape[0]]  # x, y, z
        out_vol = rotate_volume(vol, axmap, invert)
    out_t, out_h, out_w = out_vol.shape[:3]

    if rate is None:
        r = reader.rate
        if samedur:
            # fps = len[map[2]]*r / len[2] (reference rotate.c:122-126)
            rate = Fraction(lens[axmap[2]] * r.numerator,
                            lens[2] * r.denominator)
        else:
            rate = r

    props = req_props.copy()
    if not props.pix_fmt:
        pf = reader.pix_fmt.name
        if needs_rgb:
            pf = "gbrpf32le" if reader.pix_fmt.is_float else "yuv444p"
        props.pix_fmt = pf
    for field in ("color_range", "color_primaries", "color_trc",
                  "color_space"):
        if getattr(props, field) is None:
            setattr(props, field, getattr(reader.props, field))

    try:
        writer = video.open_output(args[2], out_w, out_h, rate, props,
                                   format=ofmt, codec=codec, options=encopts)
    except Exception as e:  # noqa: BLE001
        print(f"error opening output file {args[2]}: {e}", file=sys.stderr)
        return 1
    # encode for the format the container actually negotiated (it may
    # differ from the request, e.g. float RGB -> y4m yuv444p)
    out_pf = writer.pix_fmt
    same_layout = (not needs_rgb
                   and writer.pix_fmt.name == reader.pix_fmt.name)
    # raw pel copy only when the range also matches; a range-only
    # mismatch requantises per plane (the conversion the reference's
    # color negotiation performs)
    passthrough_ok = same_layout and (
        writer.pix_fmt.is_float
        or writer.props.color_range == reader.props.color_range)
    try:
        with stage("write", times):
            for t in range(out_t):
                frame = out_vol[t]
                if needs_rgb:  # volume is RGB; encode for the target format
                    writer.write_frame(video.rgb_to_planes(frame, out_pf,
                                                           writer.props))
                elif passthrough_ok:
                    writer.write_frame([frame[..., c]
                                        for c in range(frame.shape[-1])],
                                       raw=True)
                elif same_layout:
                    # same layout, different range: per-plane requantisation
                    writer.write_frame(video.dequantize_planes(
                        [frame[..., c] for c in range(frame.shape[-1])],
                        reader.pix_fmt, reader.props.color_range))
                else:
                    # componentwise pass-through would mislabel planes for
                    # the negotiated format; convert through RGB
                    rgb = video.planes_to_rgb(
                        video.dequantize_planes(
                            [frame[..., c] for c in range(frame.shape[-1])],
                            reader.pix_fmt, reader.props.color_range),
                        reader.pix_fmt, reader.props, out_w, out_h)
                    writer.write_frame_rgb(rgb)
                if not quiet:
                    print(f"\r{t}", end="", file=sys.stderr)
            if not quiet:
                print(file=sys.stderr)
    finally:
        writer.close()
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return 0


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
