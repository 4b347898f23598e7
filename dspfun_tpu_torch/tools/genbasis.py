"""genbasis — generate basis functions for a variety of 2D transforms
(PyTorch port of ``dspfun_tpu/tools/genbasis.py``).

CLI-compatible rebuild of reference applybasis/genbasis.c.  The grid is
closed-form float64 host work in both packages (``gen_basis_grid``), so
the tool runs no device code and takes no ``--device``; it keeps the JAX
tool's getopt strings, help text, exit codes and messages.  A
compressed output format exits 1 naming ROADMAP queue 1, item 8, where
cv2 does not import, before anything is computed.
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import color as _color
from dspfun_tpu_torch.io import images
from dspfun_tpu_torch.models import basis_pipeline as bp
from dspfun_tpu_torch.tools import parse_pair
from dspfun_tpu_torch.tools._colorspec import parse_color

SHORT = "hf:InP:t:O:p:S:s:g"
LONG = ["help", "function=", "inverse", "plane=", "terms=", "offset=",
        "padding=", "scale=", "size=", "natural", "linear", "bg="]

USAGE = "Usage: genbasis --size <WxH> [options] <outfile>"

HELP = """Usage: genbasis --size <WxH> [options] <outfile>

Options:
  -h, --help             This help text.
  -f, --function <type>  Type of basis to generate. [default: DFT]
                         Types: DFT, iDFT, DCT[1-4], DST[1-4], WHT, DHT.
  -I, --inverse          Transpose the output.
  -n, --natural          Center the output around the DC. Commonly in DFT visualizations.
  -P, --plane <type>     How to represent complex values in the output image. [default: real]
                         Types: real, imaginary, magnitude, phase, complex
  -s, --size <WxH>       Size of the basis functions.
  -t, --terms <WxH>      Number of basis functions to generate in each dimension. [default: equal to --size]
  -O, --offset <XxY>     Offset the terms by this amount [default: 0x0]
  -p, --padding <p>      Amount of padding to add in between terms. [default: 1]
      --bg <color>       Background color for padding
  -S, --scale <int>      Integer point upscaling factor for basis functions. [default: 1]
  -g, --linear           Generate the basis functions in linear light and scale to sRGB for output.
"""


def genbasis_realize(values: np.ndarray, plane: str) -> np.ndarray:
    """Complex grid -> RGB display values in [0,1]
    (reference genbasis.c:21-49: each plane maps (v+1)/2; ``complex``
    packs Re into R and Im into B with G=0)."""
    if plane == "complex":
        r = (values.real + 1) / 2
        b = (values.imag + 1) / 2
        return np.stack([r, np.zeros_like(r), b], axis=-1)
    if plane == "real":
        v = (values.real + 1) / 2
    elif plane == "imaginary":
        v = (values.imag + 1) / 2
    elif plane == "magnitude":
        v = (np.abs(values) + 1) / 2
    elif plane == "phase":
        v = (np.angle(values + 1j * np.finfo(np.float64).eps) + np.pi) / np.pi / 2
    else:
        raise ValueError(f"unknown plane {plane!r}")
    return np.repeat(v[..., None], 3, axis=-1)


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("genbasis")
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    outfile = "sixel:-" if sys.stdout.isatty() else None
    function = "dft"
    inverse = natural = linear = False
    plane = "real"
    size = (0, 0)
    terms = None
    offset = (0, 0)
    padding = 1
    scale = 1
    padcolor = (1.0, 0.0, 0.0, 1.0)  # genbasis defaults to red (genbasis.c:137)
    padcolor_set = False

    try:
        for flag, arg in flags:
            if flag in ("-h", "--help"):
                print(HELP)
                return 0
            elif flag in ("-f", "--function"):
                function = arg.lower()
            elif flag in ("-I", "--inverse"):
                inverse = True
            elif flag in ("-n", "--natural"):
                natural = True
            elif flag in ("-P", "--plane"):
                if arg in ("real", "imaginary", "magnitude", "phase"):
                    plane = arg
                elif arg == "complex":
                    plane = "complex"
                    if not padcolor_set:
                        padcolor = (0.0625, 0.1875, 0.0625, 1.0)  # genbasis.c:185
            elif flag in ("-s", "--size"):
                size = parse_pair(arg)
            elif flag in ("-t", "--terms"):
                terms = parse_pair(arg)
            elif flag in ("-O", "--offset"):
                offset = parse_pair(arg)
            elif flag in ("-p", "--padding"):
                padding = int(arg)
            elif flag in ("-S", "--scale"):
                scale = int(arg)
            elif flag in ("-g", "--linear"):
                linear = True
            elif flag == "--bg":
                padcolor = parse_color(arg)
                padcolor_set = True
    except ValueError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    if len(args) > 1:
        print(USAGE, file=sys.stderr)
        return 1
    if args:
        outfile = args[0]
    if not outfile or not size[0] or not size[1]:
        print(USAGE, file=sys.stderr)
        return 1
    try:
        images.check_target(outfile)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1

    if linear:
        padcolor = tuple(_color.srgb_decode(np.array(padcolor[:3]))) + (padcolor[3],)

    grid = bp.gen_basis_grid(function, size, terms=terms, offset=offset,
                             inverse=inverse, natural=natural)
    rgb = genbasis_realize(grid, plane)
    frame = bp.render_grid(rgb, scale=scale, padding=padding, bg=padcolor)
    try:
        images.write_image(outfile, frame, channels="RGBA", to_srgb=linear)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
