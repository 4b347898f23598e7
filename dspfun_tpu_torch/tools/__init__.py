"""Command-line tools mirroring the reference binaries' flag surfaces
(PyTorch port of ``dspfun_tpu/tools``).

Each module exposes ``main(argv) -> int`` and is runnable via
``python -m dspfun_tpu_torch.tools.<name>`` or the ``dspfun-torch``
dispatcher (``tools/main.py``).  Every tool takes ``--device``: ``cuda``
unless the caller asks for ``cpu``, where the kernels' plain versions
run.  spec, ispec, scan, zoom and motion take a device mesh (``-M``/
``--mesh``, or ``DSPFUN_MESH``): :func:`launch` runs the tool's ``main``
once per rank, and rank 0 alone writes files and prints.
"""

import importlib
import io
import os
import shutil
import sys
import tempfile

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


def resolve_mesh(mesh_spec: str | None, device: torch.device | str = "cuda",
                 time_refusal: str | None = None):
    """The mesh a tool asked for (the option, else ``DSPFUN_MESH``) over
    the devices of ``device`` (every card; a CPU rank per core), or None.
    Inside a rank it is the launcher's mesh.  Raises ``ValueError`` with
    the JAX tools' message when the request cannot run: more slots than
    devices, or a time axis for a tool that shards space only (the
    message ``time_refusal``).  The JAX tools print these and run on one
    device; the port's exit 1, as for everything they refuse."""
    from dspfun_tpu_torch.parallel.mesh import cli_devices, current_mesh, mesh_from_spec  # noqa: PLC0415

    mesh = current_mesh()
    if mesh is not None:
        return mesh
    try:
        mesh = mesh_from_spec(mesh_spec, cli_devices(device))
    except ValueError as e:
        raise ValueError(f"mesh unavailable ({e}); running single-device") from None
    if mesh is not None and time_refusal and mesh.shape["time"] != 1:
        raise ValueError(time_refusal)
    return mesh


def reads_stdin(spec: str | None) -> bool:
    """Whether a tool's input specifier reads standard input: none given,
    ``-``, ``pipe:``/``pipe:0``, or an image ``fmt:-``."""
    if spec is None:
        return True
    from dspfun_tpu_torch.io.images import _split_spec  # noqa: PLC0415

    return _split_spec(spec)[1] in ("-", "pipe:", "pipe:0")


def launch(module: str, argv: list[str], mesh, input_spec: str | None,
           quiet: bool = False, **where) -> int:
    """Run ``module.main(argv)`` once per rank of ``mesh`` (processes
    started with ``torch.multiprocessing``'s ``spawn``) and return the
    first non-zero exit code, else 0.  Rank 0 prints and writes; the
    other ranks' prints go nowhere.  ``where`` places this process's
    ranks in a world of several processes (``local``, ``rank_offset``,
    ``init_method``; see ``parallel/mesh.run_ranks``).  Rank 0's
    ``LAST_STAGE_TIMES`` become the tool module's here.

    The ranks are started with no standard input, so when the tool's
    input (``input_spec``) is a pipe (:func:`reads_stdin`) this process
    reads it once into a temporary file, which becomes every rank's
    ``sys.stdin``: each rank reads the same bytes the tool would have
    read without a mesh."""
    from dspfun_tpu_torch.parallel.mesh import run_ranks  # noqa: PLC0415

    if not quiet:
        devs = ", ".join(sorted(set(mesh.devices)))
        print(f"ranks: {mesh.size} on {devs} over {mesh.backend}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    staged = None
    if reads_stdin(input_spec):
        fd, staged = tempfile.mkstemp(prefix="dspfun_stdin_")
        with os.fdopen(fd, "wb") as f:
            shutil.copyfileobj(sys.stdin.buffer, f, 1 << 20)
    try:
        res = run_ranks(mesh, _tool_rank, module, list(argv), staged, **where)
    except (RuntimeError, TimeoutError) as e:
        print(e, file=sys.stderr)
        return 1
    finally:
        if staged is not None:
            os.unlink(staged)
    times = res[0][1]
    mod = importlib.import_module(module)
    if times is not None and hasattr(mod, "LAST_STAGE_TIMES"):
        mod.LAST_STAGE_TIMES.clear()
        mod.LAST_STAGE_TIMES.update(times)
    return next((rc for rc, _ in res if rc), 0)


def _tool_rank(mesh, module: str, argv: list[str], stdin_path: str | None):
    """A rank of :func:`launch`: the tool's main, silent but on rank 0,
    reading ``stdin_path`` (the launcher's staged pipe) as stdin."""
    if mesh.rank != 0:
        sys.stdout = sys.stderr = open(os.devnull, "w")  # noqa: SIM115
    if stdin_path is not None:
        sys.stdin = io.TextIOWrapper(open(stdin_path, "rb"))  # noqa: SIM115
    mod = importlib.import_module(module)
    rc = mod.main(argv)
    sys.stdout.flush()
    sys.stderr.flush()
    return rc, (dict(mod.LAST_STAGE_TIMES) if hasattr(mod, "LAST_STAGE_TIMES") else None)


def open_rank_output(mesh, open_fn, spec: str):
    """The output a rank writes: ``open_fn(spec, True)`` without a mesh
    and on rank 0; on the other ranks ``open_fn`` on a path of the same
    kind in a temporary directory (so the container negotiates the same
    pixel format and properties), behind a writer that writes nothing
    and removes the directory on ``close``."""
    if mesh is None or mesh.rank == 0:
        return open_fn(spec, True)
    tmp = tempfile.mkdtemp(prefix="dspfun_rank_")
    name = "out.y4m" if spec in ("-", "pipe:", "pipe:1") else os.path.basename(spec)
    return _Discard(open_fn(os.path.join(tmp, name), False), tmp)


class _Discard:
    """A writer whose frames go nowhere (see :func:`open_rank_output`)."""

    def __init__(self, writer, tmp: str):
        self._writer, self._tmp = writer, tmp

    def __getattr__(self, name):
        return getattr(self._writer, name)

    def write_frame(self, *args, **kw):
        pass

    def write_frame_rgb(self, *args, **kw):
        pass

    def write_frame_payload(self, *args, **kw):
        pass

    def close(self):
        try:
            self._writer.close()
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)


def parse_pair(arg: str, conv=int):
    """Parse the WxH pair syntax shared by applybasis/genbasis/draw."""
    w, _, h = arg.partition("x")
    if not w or not h:
        raise ValueError(f"expected WxH, got {arg!r}")
    return conv(w), conv(h)
