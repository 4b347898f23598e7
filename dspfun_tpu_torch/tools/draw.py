"""draw — draw DCT coefficients directly on a canvas (PyTorch port of
``dspfun_tpu/tools/draw.py``).

CLI-compatible rebuild of reference applybasis/draw.c.  It keeps the JAX
tool's getopt string, help text, exit codes and messages, with these
differences:

* ``--device cuda|cpu`` picks the torch device of the DCT-III (default
  ``cuda``; without a card that is exit 1 "Bad --device");
* a compressed output format exits 1 naming ROADMAP queue 1, item 8,
  where cv2 does not import, before anything is computed.

At an ``i8`` policy (``DSPFUN_PRECISION=i8@1e-5``) and both sides of the
canvas >= 256, the DCT-III's two contractions run on the int8 digit
kernels (``ops/int8mm.py``).  ``LAST_STAGE_TIMES`` holds the last run's
seconds per stage: ``compute`` (the coefficient grid, the DCT-III and
the copy to the host) and ``write`` (quantise, PNG encode, file).
"""

from __future__ import annotations

import getopt
import sys

from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import images
from dspfun_tpu_torch.models.basis_pipeline import draw_canvas
from dspfun_tpu_torch.tools import cli_device, parse_pair
from dspfun_tpu_torch.utils.profiling import stage

USAGE = "Usage: draw -b <WxH> [-f <XxY:strength> ...] <outfile>"

HELP = """Usage: draw -b <WxH> [-f <XxY:strength> ...] <outfile>

    Options:
  -b <WxH>           Size of the output image.
  -f <XxY:strength>  Frequency component position and value. May repeat.
"""

DEVICE_HELP = "  --device <cuda|cpu>  Where to compute. [default: cuda]\n"

LAST_STAGE_TIMES: dict = {}


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("draw")
    argv = sys.argv[1:] if argv is None else argv
    try:
        flags, args = getopt.gnu_getopt(argv, "b:f:h", ["device="])
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1

    size = (512, 512)
    coefs: list[tuple[int, int, float | None]] = []
    device_arg = None
    try:
        for flag, arg in flags:
            if flag == "-h":
                print(HELP + DEVICE_HELP)
                return 0
            if flag == "-b":
                size = parse_pair(arg)
            elif flag == "-f":
                pos, _, strength = arg.partition(":")
                x, y = parse_pair(pos)
                coefs.append((x, y, float(strength) if strength else None))
            elif flag == "--device":
                device_arg = arg
    except ValueError as e:
        print(e, file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1
    for x, y, _ in coefs:
        if not (0 <= x < size[0] and 0 <= y < size[1]):
            print(f"coefficient ({x},{y}) outside the {size[0]}x{size[1]} "
                  "canvas", file=sys.stderr)
            return 1

    outfile = None
    if args:
        outfile = args[0]
    elif sys.stdout.isatty():
        outfile = "sixel:-"
    else:
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

    times: dict = {}
    with stage("compute", times):
        canvas = draw_canvas(size, coefs, device=device)
    try:
        with stage("write", times):
            images.write_image(outfile, canvas[..., None], channels="I")
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return 0


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
