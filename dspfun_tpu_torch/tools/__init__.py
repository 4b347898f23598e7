"""Command-line tools mirroring the reference binaries' flag surfaces
(PyTorch port of ``dspfun_tpu/tools``).

Each module exposes ``main(argv) -> int`` and is runnable via
``python -m dspfun_tpu_torch.tools.<name>`` or the ``dspfun-torch``
dispatcher (``tools/main.py``).  Every tool takes ``--device``: ``cuda``
unless the caller asks for ``cpu``, where the kernels' plain versions
run.
"""

import sys

import torch


def run_main(main) -> None:
    """CLI entry wrapper: profiling hook, flush, exit code.

    DSPFUN_PROFILE=<dir> captures a torch.profiler trace around the run;
    DSPFUN_TIMINGS=1 prints the total wall time.  The JAX package leaves
    through ``os._exit`` to skip its TPU plugin's teardown; PyTorch has
    no such fault, so this is ``sys.exit``.
    """
    from dspfun_tpu_torch.utils.profiling import maybe_profile, stage

    with maybe_profile(), stage("total"):
        code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    sys.exit(code)


def cli_device(arg: str | None) -> torch.device:
    """The device of a ``--device`` option: ``cuda`` when it was not
    given; a ``ValueError`` when that needs a card and there is none
    (nothing runs on the CPU unasked)."""
    dev = torch.device("cuda" if arg is None else arg)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("--device cuda: torch.cuda.is_available() is False")
    return dev


def parse_pair(arg: str, conv=int):
    """Parse the WxH pair syntax shared by applybasis/genbasis/draw."""
    w, _, h = arg.partition("x")
    if not w or not h:
        raise ValueError(f"expected WxH, got {arg!r}")
    return conv(w), conv(h)
