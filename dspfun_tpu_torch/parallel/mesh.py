"""Device mesh over ``torch.distributed`` (PyTorch port of
``dspfun_tpu/parallel/mesh.py``).

The JAX package drives every device of a ``jax.sharding.Mesh`` from one
process (``shard_map``).  Here a **rank** is one process that owns one
device, and the ranks do the work the mesh slots do: each calls the
sharded functions on its own shard, and the collectives below move the
data between them.  dspfun's workloads shard over two named axes:

* ``space`` — the block grid (motion) or pixel rows (spec, zoom, scan):
  blocks are independent, so this is pure data parallelism;
* ``time`` — the frame axis of motion's 3-D cubes: a depth-sharded 3-D
  DCT makes the time axis local with an all-to-all axis swap
  (Ulysses-style) before its 1-D transform.

A :class:`Mesh` is plain data (axis names and sizes, one device per
rank, the backend), so a launcher can hand it to the ranks it spawns;
inside a rank it binds to a ``torch.distributed.device_mesh.DeviceMesh``
whose dims are the mesh's axes (rank = row-major index over the axes).
The backend is named, never guessed after a failure: ``nccl`` when
every rank owns a card of its own, ``gloo`` for CPU ranks and for ranks
that share one card (gloo then stages each collective through the host).

The collectives (:func:`all_to_all`, :func:`psum`, :func:`all_gather`)
have the semantics of ``jax.lax.all_to_all(..., tiled=True)``, ``psum``
and ``all_gather(..., tiled=True)``.  Each adds one to :data:`COUNTS`
(calls issued by this process, by op), the counterpart of the collective
ops ``tests/test_collectives.py`` counts in the JAX package's programs.
A float ``psum`` is an all-gather of the partials summed in rank order
on every rank, so its result does not depend on the backend's reduction
order; it counts as the ``all_reduce`` it implements.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from collections import Counter

import torch
import torch.distributed as dist

from dspfun_tpu_torch.core.transforms import AxisPlan

__all__ = ["Mesh", "make_mesh", "mesh_from_spec", "plan_row_spec",
           "Sharding", "all_to_all", "psum", "pmin", "pmax", "all_gather", "COUNTS",
           "RankPool", "run_ranks", "current_mesh", "cli_devices", "default_backend"]

# collective calls issued by this process, by op ("all_to_all",
# "all_gather", "all_reduce"), and the wall seconds they took
COUNTS: Counter = Counter()
SECONDS: Counter = Counter()
# wait for the device around each collective, so SECONDS holds the
# collectives' own time and not the queued work before them
SYNC_TIMING = False

# the seconds a rank waits in a collective or a rendezvous before it
# raises (gloo's own default is 30 minutes), and the seconds a pool's
# ranks may take to start and join
TIMEOUT_S = 60.0
START_TIMEOUT_S = 120.0


def default_backend(devices) -> str:
    """``nccl`` when every rank owns a card of its own, ``gloo`` when the
    ranks are CPU ranks or share a card; mixed devices are an error."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"}:
        idx = [d.index or 0 for d in devs]
        return "nccl" if len(set(idx)) == len(idx) else "gloo"
    raise ValueError(f"a mesh's ranks run on one kind of device, got {sorted(kinds)}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ranks: ``names``/``sizes`` in row-major order (rank
    = row-major index of the rank's coordinates), the device of each
    rank, the backend, and the number of host processes the ranks
    spread over (``procs``; ranks of one process are consecutive)."""

    names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[str, ...]
    backend: str
    procs: int = 1

    def __post_init__(self):
        if set(self.names) != {"space", "time"} or len(self.names) != 2:
            raise ValueError(f"mesh axes are space and time, got {self.names}")
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size}")
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {self.backend!r}: gloo or nccl")

    @property
    def shape(self) -> dict:
        """``{"space": s, "time": t}``, as a JAX mesh's ``shape``."""
        return {n: s for n, s in zip(self.names, self.sizes)}

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def coords(self, rank: int | None = None) -> dict:
        """The axis indices of ``rank`` (this process's rank if None)."""
        r = self.rank if rank is None else rank
        out = {}
        for name, s in reversed(list(zip(self.names, self.sizes))):
            out[name] = r % s
            r //= s
        return out

    # ---- inside a rank ------------------------------------------------
    @property
    def rank(self) -> int:
        return dist.get_rank()

    def axis_index(self, name: str) -> int:
        return self.coords()[name]

    @property
    def device(self) -> torch.device:
        return torch.device(self.devices[self.rank])

    def device_mesh(self):
        """The bound ``DeviceMesh`` (built once per rank; every rank of
        the world must take part in the first call)."""
        dm = _BOUND.get(self)
        if dm is None:
            from torch.distributed.device_mesh import DeviceMesh  # noqa: PLC0415

            if dist.get_world_size() != self.size:
                raise RuntimeError(f"mesh of {self.size} in a world of {dist.get_world_size()}")
            kind = "cuda" if self.backend == "nccl" else "cpu"
            dm = DeviceMesh(kind, torch.arange(self.size).reshape(self.sizes),
                            mesh_dim_names=self.names)
            _BOUND[self] = dm
        return dm

    def group(self, name: str):
        return self.device_mesh().get_group(name)


_BOUND: dict = {}
_CURRENT: Mesh | None = None


def current_mesh() -> Mesh | None:
    """The mesh this process is a rank of (set by the launcher), or None."""
    return _CURRENT


def cli_devices(device: torch.device | str = "cuda") -> list[str]:
    """The devices a mesh may take ranks from for a tool run on
    ``device``: every visible card for ``cuda`` (one rank each), one per
    CPU core for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"] * (os.cpu_count() or 1)


def make_mesh(
    n_devices: int | None = None,
    space: int | None = None,
    time: int | None = None,
    devices=None,
) -> Mesh:
    """A (space, time) mesh over the first ``n_devices`` of ``devices``
    (one rank each; the default is every visible card), over the backend
    the devices name (:func:`default_backend`).

    Defaults: all ranks on the space axis, time=1.  Axis sizes must
    multiply to n_devices.  A list that names one card several times
    puts several ranks on it (the tests' and the smoke run's meshes on
    one card, over gloo)."""
    devs = [str(torch.device(d)) for d in (devices if devices is not None
                                            else cli_devices("cuda"))]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"mesh needs {n} devices, only {len(devs)} visible")
    devs = devs[:n]
    if space is None and time is None:
        space, time = n, 1
    elif space is None:
        space = n // time
    elif time is None:
        time = n // space
    if space * time != n:
        raise ValueError(f"space*time ({space}*{time}) != n_devices ({n})")
    return Mesh(("space", "time"), (space, time), tuple(devs), default_backend(devs))


def _parse_mesh_spec(spec: str | None, ndev: int) -> tuple[int, int] | None:
    """The ``(space, time)`` a mesh request asks for, or None for a single
    device: the grammar of the JAX package's ``mesh_from_spec``
    (``none``/``1``/``0``, ``auto``, ``N``, ``space=N[,time=M]`` in either
    order; ``DSPFUN_MESH`` when ``spec`` is None), given ``ndev`` devices."""
    if spec is None:
        spec = os.environ.get("DSPFUN_MESH", "")
    spec = (spec or "").strip().lower()
    if spec in ("", "none", "1", "0"):
        return None
    if spec == "auto":
        return None if ndev <= 1 else (ndev, 1)
    space = time = None
    if "=" in spec:
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k, v = k.strip(), int(v)
            if k == "space":
                space = v
            elif k == "time":
                time = v
            else:
                raise ValueError(f"unknown mesh axis {k!r}")
    else:
        space, time = int(spec), 1
    n = (space or 1) * (time or 1)
    if n > ndev:
        raise ValueError(f"mesh needs {n} devices, only {ndev} visible")
    if n <= 1:
        return None
    return (space or n // (time or 1), time or n // (space or 1))


def mesh_from_spec(spec: str | None, devices=None) -> Mesh | None:
    """Parse a CLI/env mesh request into a Mesh over ``devices`` (default:
    every visible card), or None for a single device (see
    :func:`_parse_mesh_spec` for the grammar).  More slots than devices
    is a ``ValueError``."""
    devs = list(devices) if devices is not None else cli_devices("cuda")
    st = _parse_mesh_spec(spec, len(devs))
    if st is None:
        return None
    return make_mesh(st[0] * st[1], space=st[0], time=st[1], devices=devs)


def plan_row_spec(plan: AxisPlan, mesh: Mesh, axis_name: str = "space") -> AxisPlan:
    """This rank's OUTPUT rows of an AxisPlan (rows over ``axis_name``).

    Field-aware over every AxisPlan leaf, as the JAX package's
    PartitionSpec builder is (shared by the scan and zoom row-sharded
    paths): [M, K] matrix leaves (hi/lo) split on axis 0; digit leaves
    are [D, M, K] (rows on axis 1); rowsum is [2, M] (rows on axis 1);
    the exact mode's scalar scale replicates while the i8 mode's
    per-row [M, 1] scale splits on axis 0.  M must divide the axis."""
    n = mesh.shape[axis_name]
    m = plan.hi.shape[0]
    if m % n:
        raise ValueError(f"{m} plan rows do not divide the {axis_name} axis ({n})")
    lo = mesh.axis_index(axis_name) * (m // n)
    hi = lo + m // n

    def rows(a, axis):
        if a is None:
            return None
        return a.narrow(axis, lo, hi - lo).contiguous()

    scale = plan.scale
    if scale is not None and scale.ndim == 2:
        scale = rows(scale, 0)
    return AxisPlan(hi=rows(plan.hi, 0), lo=rows(plan.lo, 0),
                    digits=rows(plan.digits, 1), scale=scale,
                    rowsum=rows(plan.rowsum, 1))


# ---- collectives ----------------------------------------------------------

@contextlib.contextmanager
def _timed(op: str, x: torch.Tensor, count: bool = True):
    if count:
        COUNTS[op] += 1
    if SYNC_TIMING and x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    yield
    if SYNC_TIMING and x.is_cuda:
        torch.cuda.synchronize(x.device)
    SECONDS[op] += time.perf_counter() - t0


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective takes: gloo ranks that share a card move
    through the host (gloo's transport); nccl takes the card's tensor."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``split_axis`` cuts into as many blocks as the mesh axis has members,
    block j goes to member j, and the blocks received are concatenated
    along ``concat_axis`` in the order of the members that sent them.
    ``all_to_all_single`` splits dim 0 only, so the split axis moves to
    the front first and back after."""
    n = mesh.shape[axis]
    nd = x.ndim
    split_axis %= nd
    concat_axis %= nd
    with _timed("all_to_all", x):
        xs = x.movedim(split_axis, 0)
        s = xs.shape[0]
        if s % n:
            raise ValueError(f"axis {split_axis} of length {s} does not split {n} ways")
        send = _staged(mesh, xs.reshape(n, s // n, *xs.shape[1:]))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group(axis))
        recv = recv.to(x.device)
    # recv[i] is member i's block in the moved layout: restore the split
    # axis, then lay the n blocks out along the concat axis in member order
    out = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape).contiguous()


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, gather_axis: int = 0,
               count: bool = True) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=gather_axis, tiled=True)``: every
    member's ``x`` concatenated along ``gather_axis`` in member order.
    ``count=False`` leaves :data:`COUNTS` alone (a gather that is part
    of another collective)."""
    n = mesh.shape[axis]
    gather_axis %= x.ndim
    xs = x.movedim(gather_axis, 0)
    with _timed("all_gather", x, count):
        send = _staged(mesh, xs)
        recv = torch.empty((n * send.shape[0], *send.shape[1:]), dtype=send.dtype,
                           device=send.device)
        _GATHER(recv, send, group=mesh.group(axis))
        recv = recv.to(x.device)
    return recv.movedim(0, gather_axis).contiguous()


# torch 2.13 renames all_gather_into_tensor
_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``.  Integers reduce exactly through
    ``all_reduce``; floats gather every member's partial and add them in
    member order, the same sum on every rank and every backend."""
    if not torch.is_floating_point(x):
        with _timed("all_reduce", x):
            buf = _staged(mesh, x).clone()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axis))
            return buf.to(x.device)
    COUNTS["all_reduce"] += 1
    parts = all_gather(x.reshape(1, *x.shape), mesh, axis, 0, count=False)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _reduce(x: torch.Tensor, mesh: Mesh, axis: str, op) -> torch.Tensor:
    with _timed("all_reduce", x):
        buf = _staged(mesh, x).clone()
        dist.all_reduce(buf, op=op, group=mesh.group(axis))
        return buf.to(x.device)


def pmin(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.pmin`` (exact in any order)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.pmax`` (exact in any order)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout: ``spec[i]`` names the mesh axis tensor axis ``i`` splits
    over (None: whole on every rank), as a JAX ``PartitionSpec``.
    Calling it on a full tensor gives this rank's slice; :meth:`gather`
    assembles the full tensor from every rank's slice."""

    mesh: Mesh
    spec: tuple

    def __call__(self, full):
        x = full
        for ax, name in enumerate(self.spec):
            if name is None:
                continue
            n = self.mesh.shape[name]
            if x.shape[ax] % n:
                raise ValueError(f"axis {ax} of length {x.shape[ax]} does not divide {name} ({n})")
            step = x.shape[ax] // n
            sl = [slice(None)] * x.ndim
            i = self.mesh.axis_index(name)
            sl[ax] = slice(i * step, (i + 1) * step)
            x = x[tuple(sl)]
        return x

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        x = local
        for ax, name in enumerate(self.spec):
            if name is not None:
                x = all_gather(x, self.mesh, name, ax)
        return x


# ---- ranks ----------------------------------------------------------------

def _rank_loop(rank, world, mesh_devices, backend, init_method, timeout_s, single_host,
               tasks, results, rank_offset, local):
    """A rank's process: join the world (across host processes through
    ``multihost.initialize``), then run tasks until told to stop."""
    global _CURRENT
    grank = rank + rank_offset
    try:
        if single_host:
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dev = torch.device(mesh_devices[grank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, world)))
        if local == world:
            dist.init_process_group(backend, init_method=init_method, world_size=world,
                                    rank=grank, timeout=datetime.timedelta(seconds=timeout_s))
        else:
            from dspfun_tpu_torch.parallel import multihost  # noqa: PLC0415

            multihost.initialize(init_method.removeprefix("tcp://"), world // local,
                                 rank_offset // local, local_rank=rank, local_ranks=local,
                                 backend=backend, timeout_s=timeout_s)
    except BaseException:  # noqa: BLE001
        results.put((grank, "err", traceback.format_exc()))
        return
    results.put((grank, "ready", None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, mesh, args = task
            _CURRENT = mesh
            try:
                out = fn(mesh, *args)
            except BaseException:  # noqa: BLE001
                results.put((grank, "err", traceback.format_exc()))
                break
            finally:
                _CURRENT = None
            results.put((grank, "ok", out))
    finally:
        # no barrier: a rank that failed must not wait for the others
        with contextlib.suppress(Exception):
            dist.destroy_process_group()


class RankPool:
    """Processes of one world, started once (``torch.multiprocessing``,
    ``spawn``), that run functions together: :meth:`run` calls
    ``fn(mesh, *args)`` on every rank of this process and returns their
    results in rank order.  ``fn`` must be importable (a module-level
    function) and its arguments and results picklable (numpy, not
    tensors).

    ``devices`` is the device of every rank of the world; this process
    starts ranks ``rank_offset`` to ``rank_offset + local - 1`` of it
    (``local`` defaults to all).  The ranks rendezvous through a file in
    a fresh temporary directory, or at ``init_method`` (``tcp://host:port``
    for ranks spread over several processes, each of ``local`` ranks: then
    ``init_method`` is process 0's coordinator).  Every process group waits
    at most ``timeout_s`` in a collective; a rank that raises or dies ends
    the pool and :meth:`run` raises with its traceback."""

    def __init__(self, devices, backend: str | None = None, *, local: int | None = None,
                 rank_offset: int = 0, init_method: str | None = None,
                 timeout_s: float | None = None):
        import torch.multiprocessing as tmp  # noqa: PLC0415

        self.devices = tuple(str(torch.device(d)) for d in devices)
        self.backend = backend or default_backend(self.devices)
        self.world = len(self.devices)
        self.local = self.world if local is None else local
        self.rank_offset = rank_offset
        self._tmp = None
        if init_method is None:
            self._tmp = tempfile.mkdtemp(prefix="dspfun_ranks_")
            init_method = "file://" + os.path.join(self._tmp, "rendezvous")
        single_host = self.local == self.world or "localhost" in init_method \
            or "127.0.0.1" in init_method
        ctx = tmp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.local)]
        timeout_s = TIMEOUT_S if timeout_s is None else timeout_s
        self._procs = [
            ctx.Process(target=_rank_loop, daemon=True,
                        args=(r, self.world, self.devices, self.backend, init_method,
                              timeout_s, single_host, self._tasks[r], self._results,
                              rank_offset, self.local))
            for r in range(self.local)]
        for p in self._procs:
            p.start()
        try:
            self._collect("ready", START_TIMEOUT_S)
        except BaseException:
            self.close(force=True)
            raise

    def _collect(self, kind: str, timeout_s: float) -> list:
        got: dict = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < self.local:
            try:
                r, status, payload = self._results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if p.exitcode is not None and i not in got]
                if dead:
                    # a rank may have posted its error just before leaving
                    with contextlib.suppress(queue_mod.Empty):
                        r, status, payload = self._results.get(timeout=1.0)
                        if status == "err":
                            raise RuntimeError(f"rank {r} failed:\n{payload}") from None
                    raise RuntimeError(f"rank {dead[0] + self.rank_offset} died (exit code "
                                       f"{self._procs[dead[0]].exitcode})") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(self.local)) - set(got))} "
                                       f"gave no result within {timeout_s:.0f} s") from None
                continue
            if status == "err":
                raise RuntimeError(f"rank {r} failed:\n{payload}")
            if status != kind:
                raise RuntimeError(f"rank {r}: {status} where {kind} was expected")
            got[r - self.rank_offset] = payload
        return [got[i] for i in range(self.local)]

    def mesh(self, space: int | None = None, time: int | None = None,
             names=("space", "time"), procs: int = 1) -> Mesh:
        """A mesh over the whole world (row-major over ``names``)."""
        n = self.world
        if space is None and time is None:
            space, time = n, 1
        space = space or n // time
        time = time or n // space
        sizes = {"space": space, "time": time}
        return Mesh(tuple(names), tuple(sizes[k] for k in names), self.devices,
                    self.backend, procs)

    def run(self, fn, mesh: Mesh, *args, timeout_s: float = 600.0) -> list:
        if mesh.devices != self.devices or mesh.backend != self.backend:
            raise ValueError("the mesh is not over this pool's ranks")
        for q in self._tasks:
            q.put((fn, mesh, args))
        try:
            return self._collect("ok", timeout_s)
        except BaseException:
            self.close(force=True)
            raise

    def close(self, force: bool = False) -> None:
        """Stop the ranks: ask them to leave, or (``force``, after a
        failure, when the others may wait in a collective) end them."""
        for q in self._tasks:
            with contextlib.suppress(Exception):
                q.put(None)
        deadline = time.monotonic() + (0.0 if force else 10.0)
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(mesh: Mesh, fn, *args, local: int | None = None, rank_offset: int = 0,
              init_method: str | None = None) -> list:
    """Start the ranks of ``mesh`` (or this process's ``local`` of them,
    from ``rank_offset``), run ``fn(mesh, *args)`` once on each and
    return the results in rank order (a tool's whole run: no time limit
    but the collectives')."""
    with RankPool(mesh.devices, mesh.backend, local=local, rank_offset=rank_offset,
                  init_method=init_method) as pool:
        return pool.run(fn, mesh, *args, timeout_s=float("inf"))

