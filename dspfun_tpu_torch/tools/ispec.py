"""ispec — invert spectrums generated by spec (PyTorch port of
``dspfun_tpu/tools/ispec.py``).

CLI-compatible rebuild of reference spec/ispec.c.  Run it as

    python -m dspfun_tpu_torch.tools.ispec [options] <infile> <outfile>

It keeps the JAX tool's getopt string, usage and help texts, exit codes
and messages, with the differences ``tools/spec.py`` lists: ``--device``
(default ``cuda``), ``-M``/``--mesh``/``DSPFUN_MESH`` over the ranks of
``tools.launch`` (exit 1 where the JAX tool falls back), the image codecs,
and float32 pixels made on the host (the spectrum and the signmap).
``LAST_STAGE_TIMES`` has the keys of spec's.
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import torch

from dspfun_tpu_torch.core.precision import apply_tool_default
from dspfun_tpu_torch.io import images
from dspfun_tpu_torch.models.spec_pipeline import spec_inverse
from dspfun_tpu_torch.models.spec_pipeline import signmap_restore
from dspfun_tpu_torch.parallel.mesh import current_mesh
from dspfun_tpu_torch.tools import launch
from dspfun_tpu_torch.tools._speccli import (
    LONG, SPEC_HELP, SpecOpts, pad_to_mesh, resolve_io, setup, spec_opt_proc, timed_compute,
)
from dspfun_tpu_torch.tools.spec import _png_target
from dspfun_tpu_torch.utils.profiling import stage

USAGE = "Usage: ispec -h -p -m <signmap> -M mesh --device cuda|cpu [spec options] <infile> <outfile>"

LAST_STAGE_TIMES: dict = {}


def main(argv: list[str] | None = None) -> int:
    apply_tool_default("ispec")
    argv = sys.argv[1:] if argv is None else argv
    opts = SpecOpts()
    preserve_dc = False
    signmap_path = mesh_spec = device_arg = None
    try:
        flags, args = getopt.getopt(argv, "hgc:t:s:T:S:G:R:pm:M:", LONG)
    except getopt.GetoptError:
        print(USAGE, file=sys.stderr)
        return 1
    for flag, arg in flags:
        if flag in ("-M", "--mesh"):
            mesh_spec = arg
        elif flag == "--device":
            device_arg = arg
        elif flag == "-h":
            print(
                "Usage: ispec [options] <infile> <outfile>\noptions:\n"
                "  -h            This help text.\n"
                "  -p            Apply the DC coefficient from the original image if available.\n"
                "  -m <signmap>  Path to a file generated with `spec -t sign`\n"
                "  -M <mesh>     Device mesh for huge images (auto|N|space=N).\n"
                "  --device      Where to compute: cuda (default) or cpu.\n"
            )
            print(SPEC_HELP)
            return 0
        elif flag == "-p":
            preserve_dc = True
        elif flag == "-m":
            signmap_path = arg
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
        return launch("dspfun_tpu_torch.tools.ispec", argv, mesh, opts.input)

    times: dict = {}
    try:
        with stage("read", times):
            img = images.read_image(opts.input, channels=opts.csp)
            f = np.asarray(img.pixels, np.float32)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1

    d = len(opts.csp)
    signmap_usable = (signmap_path is not None
                      and opts.params.signtype == "abs")
    if signmap_path is not None and not signmap_usable:
        print("warning: -m signmap is only used with -S abs; ignoring",
              file=sys.stderr)
    dc = None
    if "DC" in img.properties:
        dc = images.decode_dc_property(img.properties["DC"], d)
    elif not signmap_usable and (
        preserve_dc or opts.params.rangetype in ("dc", "dcs")
    ):
        print("DC not found in header", file=sys.stderr)
        return 1

    signmap = None
    if signmap_usable:
        with stage("read signmap", times):
            sm = images.read_image(signmap_path, channels=opts.csp)
            signmap = np.asarray(sm.pixels, np.float32)

    with stage("h2d", times):
        fd = torch.from_numpy(f).to(device)
        if signmap is not None:
            signmap = torch.from_numpy(signmap).to(device)
    if mesh is None:
        y = timed_compute(
            lambda: spec_inverse(fd, params=opts.params, dc=dc, signmap=signmap,
                                 preserve_dc=preserve_dc),
            times, device.type == "cuda")
    else:
        y = timed_compute(
            lambda: _inverse_sharded(fd, opts.params, mesh, dc, signmap, preserve_dc),
            times, device.type == "cuda")
    with stage("d2h", times):
        y = y.cpu().numpy()

    try:
        # mirror the input spectrum's depth for PNG targets (the
        # reference writes at the wand's depth, ispec.c:170-182)
        depth = img.depth if _png_target(opts.output) else 8
        with stage("write", times):
            if mesh is None or mesh.rank == 0:
                images.write_image(opts.output, y, channels=opts.csp,
                                   to_srgb=opts.gamma, depth=depth)
    except Exception as e:  # noqa: BLE001
        print(e, file=sys.stderr)
        return 1
    LAST_STAGE_TIMES.clear()
    LAST_STAGE_TIMES.update(times)
    return 0


def _inverse_sharded(f, params, mesh, dc, signmap, preserve_dc):
    """spec_inverse over the mesh: the signmap's sign restoration is a
    whole-image pre-pass, then this rank's columns of the padded
    spectrum in and the whole image (gathered, padding dropped) out."""
    from dspfun_tpu_torch.parallel import spec_sharded as ss  # noqa: PLC0415

    if signmap is not None and params.signtype == "abs":
        f, dc = signmap_restore(f, signmap)
    h0, w0 = f.shape[:2]
    fs = ss.spectrum_sharding(mesh)(pad_to_mesh(f, mesh))
    y = ss.spec_inverse_sharded(fs, params, mesh, dc=dc, preserve_dc=preserve_dc,
                                true_shape=(h0, w0))
    return ss.image_sharding(mesh).gather(y)[:h0, :w0]


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
