"""Command-line tools mirroring the reference binaries' flag surfaces
(PyTorch port of ``dspfun_tpu/tools``).

Each module exposes ``main(argv) -> int`` and is runnable via
``python -m dspfun_tpu_torch.tools.<name>`` or the ``dspfun-torch``
dispatcher (``tools/main.py``).  Every tool takes ``--device``: ``cuda``
unless the caller asks for ``cpu``, where the kernels' plain versions
run.
"""

import os
import sys

import torch

MESH_NOT_PORTED = "ROADMAP.md queue 1, item 18"


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


def mesh_refused(mesh_spec: str | None, flags: str = "--mesh") -> bool:
    """Whether the caller asked for a device mesh (the option, or a set
    ``DSPFUN_MESH``), which the port lacks: prints the refusal (exit 1)."""
    if mesh_spec is None and not os.environ.get("DSPFUN_MESH"):
        return False
    print(f"{flags} and DSPFUN_MESH: the device mesh is not ported to "
          f"dspfun_tpu_torch yet ({MESH_NOT_PORTED}); use dspfun_tpu.tools",
          file=sys.stderr)
    return True


def parse_pair(arg: str, conv=int):
    """Parse the WxH pair syntax shared by applybasis/genbasis/draw."""
    w, _, h = arg.partition("x")
    if not w or not h:
        raise ValueError(f"expected WxH, got {arg!r}")
    return conv(w), conv(h)
