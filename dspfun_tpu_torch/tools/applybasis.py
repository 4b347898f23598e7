"""applybasis — apply basis functions for a variety of 2D transforms to
images (PyTorch port of ``dspfun_tpu/tools/applybasis.py``).

CLI-compatible rebuild of reference applybasis/applybasis.c on the
pipeline in ``dspfun_tpu_torch.models.basis_pipeline``.  Run it as

    python -m dspfun_tpu_torch.tools.applybasis [options] <infile> <outfile>

It keeps the JAX tool's getopt strings, help text, exit codes and
messages, with these differences:

* ``--device cuda|cpu`` picks the torch device (default ``cuda``; without
  a card that is exit 1 "Bad --device", and ``--device cpu`` runs the
  contractions on the host);
* images are read and written by the port's own codecs (PNG, PNM, BMP,
  TIFF, sixel; the compressed formats through cv2, and without it exit 1
  naming ROADMAP queue 1, item 8); the output and the device are checked
  before the input is read;
* the tools' default policy (hilo) contracts in complex64, as the JAX
  package does on its accelerator; ``DSPFUN_PRECISION=f64`` takes
  complex128 (models/basis_pipeline.py).

``LAST_STAGE_TIMES`` holds the last run's seconds per stage: ``read``
(file or ``.coeff`` dump), ``plan``, ``h2d``, ``compute`` (and on a card
``compute_device``, CUDA events), ``d2h`` (see ``apply_basis``),
``dump`` (the ``-d`` file), ``values`` (realize, rescale, range),
``render`` (the tile frame) and ``write`` (quantise, PNG encode, file).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import color as _color
from dspfun_tpu_torch.io import images
from dspfun_tpu_torch.models import basis_pipeline as bp
from dspfun_tpu_torch.tools import cli_device, parse_pair
from dspfun_tpu_torch.tools._colorspec import parse_color
from dspfun_tpu_torch.utils.profiling import stage

SHORT = "hd:f:IP:R:N:t:u:O:p:S:g"
LONG = ["help", "function=", "inverse", "plane=", "rescale=", "range=",
        "terms=", "sum=", "offset=", "padding=", "scale=", "linear", "bg=",
        "device="]

USAGE = "Usage: applybasis [options] <infile> <outfile>"

HELP = """Usage: applybasis [options] <infile> <outfile>

Options:
  -h, --help             This help text.
  -f, --function <type>  Type of basis to generate. [default: DFT]
                         Types: DFT, iDFT, DCT[1-4], DST[1-4], WHT, DHT.
  -I, --inverse          Transpose the output.
  -P, --plane <type>     How to represent complex values in the output image. [default: real]
                         Types: real, imaginary, magnitude, phase
  -u, --sum <NxM>        Sum this many terms after applying the basis functions. [default: 1x1 (no summing)]
  -t, --terms <WxH>      Number of basis functions to generate in each dimension. [default: equal to the input image dimensions]
  -O, --offset <XxY>     Offset the terms by this amount [default: 0x0]
  -p, --padding <p>      Amount of padding to add in between terms. [default: 1]
      --bg <color>       Background color for padding
  -S, --scale <int>      Integer point upscaling factor for basis functions. [default: 1]
  -g, --linear           Apply the basis functions in linear light and scale to sRGB for output.
  -R, --rescale <type>   How to scale summed values. [default: linear]
                         Types: linear, log, gain, level (two may be given, e.g. linear-log)
  -N, --range <type>     How to visualize negative values. [default: shift2]
                         Types: shift, shift2, abs, invert, hue
  -d <file.coeff>        Optional file to store transformed coefficients.
"""

DEVICE_HELP = "      --device <cuda|cpu>  Where to compute. [default: cuda]\n"

_PLANES = {"real", "imaginary", "magnitude", "phase"}
_RANGES = {"abs", "shift", "shift2", "invert", "hue"}
_RESCALES = ("linear", "log", "gain", "level")

LAST_STAGE_TIMES: dict = {}


def _parse_rescale(arg: str) -> tuple[str, str | None]:
    """Reference-style sequential prefix parse: two kinds concatenate
    with no separator ("linearlog" — applybasis.c:252-258 consumes
    token prefixes in a 2-iteration loop); '-'/',' separators are also
    tolerated as a readability extension."""
    s = arg
    kinds: list[str] = []
    for _ in range(2):
        s = s.lstrip("-,")
        # longest-prefix match so "linear" is not read as "line"+junk
        for name in sorted(_RESCALES, key=len, reverse=True):
            if s.startswith(name):
                kinds.append(name)
                s = s[len(name):]
                break
        else:
            break
    if not kinds:
        raise ValueError(f"unknown rescale {arg!r}")
    return kinds[0], (kinds[1] if len(kinds) > 1 else None)


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("applybasis")
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    outcoeffs = None
    function = "dft"
    inverse = False
    orthogonal = False
    linearlight = False
    plane = "real"
    rescale: tuple[str, str | None] = ("linear", None)
    rng = "shift2"
    terms = None
    partsum = (1, 1)
    offset = (0, 0)
    padding = 1
    scale = 1
    padcolor = (0.0, 0.0, 0.0, 1.0)
    device_arg = None

    try:
        for flag, arg in flags:
            if flag in ("-h", "--help"):
                print(HELP + DEVICE_HELP)
                return 0
            elif flag == "-d":
                outcoeffs = arg
                orthogonal = True
            elif flag in ("-f", "--function"):
                function = arg.lower()
            elif flag in ("-I", "--inverse"):
                inverse = True
            elif flag in ("-P", "--plane"):
                if arg in _PLANES:
                    plane = arg
            elif flag in ("-R", "--rescale"):
                rescale = _parse_rescale(arg)
            elif flag in ("-N", "--range"):
                if arg in _RANGES:
                    rng = arg
            elif flag in ("-t", "--terms"):
                terms = parse_pair(arg)
            elif flag in ("-u", "--sum"):
                partsum = parse_pair(arg)
            elif flag in ("-O", "--offset"):
                offset = parse_pair(arg)
            elif flag in ("-p", "--padding"):
                padding = int(arg)
            elif flag in ("-S", "--scale"):
                scale = int(arg)
            elif flag in ("-g", "--linear"):
                linearlight = True
            elif flag == "--bg":
                padcolor = parse_color(arg)
            elif flag == "--device":
                device_arg = arg
    except ValueError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    outfile = "sixel:-" if sys.stdout.isatty() else None
    if not args or len(args) > 2:
        print(USAGE, file=sys.stderr)
        return 1
    infile = args[0]
    if len(args) > 1:
        outfile = args[1]
    if not outfile:
        print(USAGE, file=sys.stderr)
        return 1
    try:
        images.check_target(outfile)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    try:
        device = cli_device(device_arg)
    except (RuntimeError, ValueError) as e:
        print(f"Bad --device: {e}", file=sys.stderr)
        return 1

    if linearlight:
        padcolor = tuple(_color.srgb_decode(np.array(padcolor[:3]))) + (padcolor[3],)

    times: dict = {}
    # .coeff input (reference applybasis.c:319-338)
    if infile.endswith(".coeff"):
        orthogonal = True
        try:
            with stage("read", times):
                pixels, (in_w, in_h) = bp.read_coeff_file(infile)
        except (OSError, ValueError) as e:
            print(f"Error reading {infile}: {e}", file=sys.stderr)
            return 1
        inrange = (in_w // partsum[0]) * (in_h // partsum[1])
    else:
        try:
            with stage("read", times):
                img = images.read_image(infile, channels="RGB", linear=linearlight)
        except Exception as e:  # noqa: BLE001
            print(e, file=sys.stderr)
            return 1
        pixels = img.pixels.astype(np.complex128)
        if rng == "shift2":
            pixels = pixels * 2 - 1  # (applybasis.c:358-360)
        in_h, in_w = pixels.shape[:2]
        inrange = 1

    if terms is None:
        terms = (in_w, in_h)

    values = bp.apply_basis(
        pixels, function, terms=terms, partsum=partsum, offset=offset,
        inverse=inverse, orthogonal=orthogonal, device=device, times=times,
    )

    if outcoeffs:
        try:
            with stage("dump", times):
                bp.write_coeff_file(outcoeffs, values)
        except OSError as e:
            print(f"Error writing {outcoeffs}: {e}", file=sys.stderr)
            return 1

    with stage("values", times):
        coeff_scale = bp.coeff_scale_factor(function, partsum, inrange)
        real_vals = bp.realize(values, plane)
        del values
        real_vals = bp.rescale_values(real_vals, rescale, coeff_scale, (in_w, in_h))
        real_vals = bp.range_encode(real_vals, rng)

    with stage("render", times):
        frame = bp.render_grid(real_vals, scale=scale, padding=padding, bg=padcolor)
    del real_vals
    try:
        with stage("write", times):
            images.write_image(outfile, frame, channels="RGBA",
                               to_srgb=linearlight)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return 0


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
