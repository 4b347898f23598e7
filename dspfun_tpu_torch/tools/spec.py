"""spec — generate invertible frequency spectrums for viewing and editing
(PyTorch port of ``dspfun_tpu/tools/spec.py``).

CLI-compatible rebuild of reference spec/spec.c on the pipeline in
``dspfun_tpu_torch.models.spec_pipeline``.  Run it as

    python -m dspfun_tpu_torch.tools.spec [options] <infile> <outfile>

It keeps the JAX tool's getopt string, usage and help texts, exit codes
and messages, with these differences:

* ``--device cuda|cpu`` picks the torch device (default ``cuda``; without
  a card that is exit 1 "Bad --device", and ``--device cpu`` runs the
  kernels' plain versions);
* ``-M``/``--mesh`` (or ``DSPFUN_MESH``) runs one rank per device of the
  mesh (``tools.launch``: every card with ``cuda``, one CPU rank per core
  with ``cpu``); where the JAX tool prints ``mesh unavailable (...);
  running single-device`` or refuses a time axis and runs on one device,
  this one prints the same and exits 1;
* images are read and written by the port's own codecs (PNG, PNM, BMP,
  TIFF, sixel; the compressed formats through cv2, and without it exit 1
  naming ROADMAP queue 1, item 8); the output is checked before the
  input is read;
* the JAX tool hands ``jax.jit`` float64 pixels, which it computes in
  float32: here the pixels are cast to float32 on the host, once, before
  the copy to the device, and DC comes back as the float64 of its
  float32 value, so the "DC" property holds the same 8 bytes a channel.

``LAST_STAGE_TIMES`` holds the last run's seconds per stage: ``read``
(file, PNG decode, channel export, the cast), ``h2d``, ``compute``
(wall, to the end of the device's work) and on a card
``compute_device`` (CUDA events), ``d2h``, ``write`` (quantise, PNG
encode, file).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import torch

from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import images
from dspfun_tpu_torch.models.spec_pipeline import spec_forward
from dspfun_tpu_torch.parallel.mesh import current_mesh
from dspfun_tpu_torch.tools import launch
from dspfun_tpu_torch.tools._speccli import (
    LONG, SPEC_HELP, SpecOpts, pad_to_mesh, resolve_io, setup, spec_opt_proc, timed_compute,
)
from dspfun_tpu_torch.utils.profiling import stage

USAGE = "Usage: spec -h -g -c csp -t (abs|shift|flat|sign|copy) -R (one|dc|dcs) -T (linear|log) -S (abs|shift|saturate|retain) -G (native|reference|custom(float)) -M mesh --device cuda|cpu <infile> <outfile>"

LAST_STAGE_TIMES: dict = {}


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("spec")
    argv = sys.argv[1:] if argv is None else argv
    opts = SpecOpts()
    mesh_spec = device_arg = None
    try:
        flags, args = getopt.getopt(argv, "hgc:t:s:T:S:G:R:M:", LONG)
    except getopt.GetoptError:
        print(USAGE, file=sys.stderr)
        return 1
    for flag, arg in flags:
        if flag == "-h":
            print("Usage: spec [options] <infile> <outfile>\noptions:\n  -h  This help text.\n  -M  Device mesh for huge images (auto|N|space=N).\n  --device  Where to compute: cuda (default) or cpu.\n")
            print(SPEC_HELP)
            return 0
        if flag in ("-M", "--mesh"):
            mesh_spec = arg
        elif flag == "--device":
            device_arg = arg
        elif not spec_opt_proc(opts, flag, arg):
            print(USAGE, file=sys.stderr)
            return 1
    if not resolve_io(args, opts):
        print(USAGE, file=sys.stderr)
        return 1
    res = setup(opts, mesh_spec, device_arg)
    if res is None:
        return 1
    device, mesh = res
    if mesh is not None and current_mesh() is None:
        return launch("dspfun_tpu_torch.tools.spec", argv, mesh, opts.input)

    times: dict = {}
    try:
        with stage("read", times):
            img = images.read_image(opts.input, channels=opts.csp, linear=opts.gamma)
            x = np.asarray(img.pixels, np.float32)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1

    with stage("h2d", times):
        xd = torch.from_numpy(x).to(device)
    if mesh is None:
        f, dc = timed_compute(lambda: spec_forward(xd, opts.params), times,
                              device.type == "cuda")
    else:
        f, dc = timed_compute(lambda: _forward_sharded(xd, opts.params, mesh), times,
                              device.type == "cuda")
    with stage("d2h", times):
        f = f.cpu().numpy()
        dc = np.asarray(dc.cpu().numpy(), dtype=np.float64)

    props = {"DC": images.encode_dc_property(dc)}
    # PNG spectra are written at 16 bits like the reference's MagickWand
    # Q16 default (spec/spec.c:141-155): the depth that makes
    # `spec -t flat | edit | ispec` editing workflows invertible
    depth = 16 if _png_target(opts.output) else 8
    try:
        with stage("write", times):
            if mesh is None or mesh.rank == 0:
                images.write_image(opts.output, f, channels=opts.csp,
                                   properties=props, depth=depth)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return 0


def _forward_sharded(x, params, mesh):
    """spec_forward over the mesh: this rank's rows of the padded image
    in, the whole spectrum (gathered, padding dropped) and DC out."""
    from dspfun_tpu_torch.parallel import spec_sharded as ss  # noqa: PLC0415

    h0, w0 = x.shape[:2]
    xs = ss.image_sharding(mesh)(pad_to_mesh(x, mesh))
    f, dc = ss.spec_forward_sharded(xs, params, mesh, true_shape=(h0, w0))
    return ss.spectrum_sharding(mesh).gather(f)[:h0, :w0], dc


def _png_target(spec: str | None) -> bool:
    """Whether an output specifier names a PNG (16 bits) or something
    else, sixel included (8), as the JAX tool decides."""
    if spec is None:
        return not sys.stdout.isatty()
    fmt, path = images._split_spec(spec)
    if fmt:
        return fmt == "png"
    if path == "-":
        return True
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else "png"
    return ext == "png"


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
