"""Shared spec/ispec CLI option processing (reference spec/spec.h:81-155;
copy of ``dspfun_tpu/tools/_speccli.py``).

The option tables, ``spec_opt_proc``, ``SPEC_HELP`` and ``resolve_io``
are the JAX package's (tests/test_torch_spec_cli.py pins them).  New
here, shared by the port's spec and ispec: ``LONG`` and ``setup``, which
handle what differs from the JAX tools: ``--device cuda|cpu`` (default
``cuda``; exit 1 "Bad --device" without a card), ``-M``/``--mesh`` (or
``DSPFUN_MESH``) resolved before anything is read, over every card or
one CPU rank per core, and output targets the port cannot write refused
before anything is read.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from dspfun_tpu_torch.io import images
from dspfun_tpu_torch.models.spec_pipeline import SpecChainParams
from dspfun_tpu_torch.ops.int8mm import ceil_to
from dspfun_tpu_torch.parallel.mesh import current_mesh
from dspfun_tpu_torch.tools import cli_device, resolve_mesh
from dspfun_tpu_torch.utils.profiling import stage

SPECTYPES = ("abs", "shift", "flat", "sign", "copy")
SIGNTYPES = ("abs", "shift", "saturate", "retain")
RANGETYPES = ("one", "dc", "dcs")
SCALETYPES = ("linear", "log")
GAINTYPES = ("native", "reference", "custom")


@dataclasses.dataclass
class SpecOpts:
    gamma: bool = False
    csp: str = "RGB"
    input: str = "-"
    output: str = "-"
    params: SpecChainParams = dataclasses.field(default_factory=SpecChainParams)


def spec_opt_proc(opts: SpecOpts, flag: str, arg: str) -> bool:
    """Process one spec option; returns False on invalid input
    (reference spec/spec.h:112-155)."""
    p = opts.params
    if flag == "-g":
        opts.gamma = True
    elif flag == "-c":
        opts.csp = arg
    elif flag == "-t":
        if arg not in SPECTYPES:
            print(f"Invalid spectrogram type '{arg}', use one of: {' '.join(SPECTYPES)}", file=sys.stderr)
            return False
        opts.params = SpecChainParams.template(arg, gain=p.gain)
    elif flag == "-R":
        if arg not in RANGETYPES:
            print(f"Invalid range type '{arg}', use one of: {' '.join(RANGETYPES)}", file=sys.stderr)
            return False
        opts.params = dataclasses.replace(p, rangetype=arg)
    elif flag == "-T":
        if arg not in SCALETYPES:
            print(f"Invalid scale type '{arg}', use one of: {' '.join(SCALETYPES)}", file=sys.stderr)
            return False
        opts.params = dataclasses.replace(p, scaletype=arg)
    elif flag == "-S":
        if arg not in SIGNTYPES:
            print(f"Invalid sign type '{arg}', use one of: {' '.join(SIGNTYPES)}", file=sys.stderr)
            return False
        opts.params = dataclasses.replace(p, signtype=arg)
    elif flag == "-G":
        if arg in GAINTYPES:
            opts.params = dataclasses.replace(p, gaintype=arg)
        else:
            try:
                opts.params = dataclasses.replace(p, gaintype="custom", gain=float(arg))
            except ValueError:
                print(f"Invalid gain type '{arg}', use a numeric value or one of: {' '.join(GAINTYPES)}", file=sys.stderr)
                return False
    else:
        return False
    return True


SPEC_HELP = """spectrogram options:
  -g             Generate in linear light
  -c <channels>  Color channels to use. [default: RGB]
  -t <template>  Spectrogram template. [default: abs]
                 values: abs shift flat sign copy
  -R <range>     Range to scale coefficients to. [default: dc]
                 values: one dc dcs
  -T <scale>     How to scale coefficients. [default: log]
                 values: linear log
  -S <sign>      How to represent signed values. [default: abs]
                 values: abs shift saturate retain
  -G <gain>      Multiplier for scaling. [default: native]
                 values: native reference custom (float)"""


def resolve_io(args: list[str], opts: SpecOpts) -> bool:
    """Positional input/output with the reference's tty rules
    (spec/spec.c:32-42): stdin refused on a tty; stdout defaults to
    sixel on a tty."""
    if args:
        opts.input = args[0]
    elif sys.stdin.isatty():
        return False
    if len(args) > 1:
        opts.output = args[1]
    elif sys.stdout.isatty():
        opts.output = "sixel:-"
    return True


# long options of the port's spec and ispec, beside the JAX tools' short ones
LONG = ["device=", "mesh="]


def setup(opts: SpecOpts, mesh_spec: str | None, device_arg: str | None):
    """What the port's spec and ispec check before they read anything:
    the output target (``images.check_target``), the device and the mesh
    (-M N; the space axis only).  Returns (device, mesh or None), or None after
    printing why not (exit code 1).  Inside a rank the device is the
    rank's own."""
    try:
        images.check_target(opts.output)
    except ValueError as e:
        print(e, file=sys.stderr)
        return None
    try:
        device = cli_device(device_arg)
    except (RuntimeError, ValueError) as e:
        print(f"Bad --device: {e}", file=sys.stderr)
        return None
    try:
        mesh = resolve_mesh(mesh_spec, device,
                            "spec mesh uses the space axis only; pass -M N")
    except ValueError as e:
        print(e, file=sys.stderr)
        return None
    return (device if mesh is None or current_mesh() is None else mesh.device), mesh


def pad_to_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` [H, W, C] zero-padded so that rows AND columns divide the
    mesh's 'space' axis (the padded basis rows and columns are zero,
    parallel/spec_sharded.py), as the JAX tools pad before sharding."""
    ns = mesh.shape["space"]
    h0, w0 = x.shape[:2]
    return torch.nn.functional.pad(x, (0, 0, 0, ceil_to(w0, ns) - w0, 0, ceil_to(h0, ns) - h0))


def timed_compute(fn, times: dict, on_card: bool):
    """Run ``fn()`` as the "compute" stage: ``times["compute"]`` is the
    wall time until the device has finished, and on a card
    ``times["compute_device"]`` the time between two CUDA events around
    it (seconds both)."""
    if not on_card:
        with stage("compute", times):
            return fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with stage("compute", times):
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    times["compute_device"] = start.elapsed_time(end) / 1e3
    return out
