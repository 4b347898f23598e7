"""Runs over several host processes (PyTorch port of
``dspfun_tpu/parallel/multihost.py``).

One host process starts one rank per local device; the ranks of all
processes form one world, rendezvousing at process 0's coordinator
address (``tcp://host:port``), and global rank = process index * local
ranks + local rank.  The **time** axis is laid out across processes:
frame cubes stream host by host as time-contiguous slabs
(:func:`stage_global_cube`), so the process boundary falls on the slab
axis; space-axis collectives stay inside a host, time-axis all_to_alls
cross hosts.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from dspfun_tpu_torch.parallel.mesh import TIMEOUT_S, Mesh, default_backend

__all__ = ["initialize", "global_mesh", "stage_global_cube"]


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, local_rank: int = 0,
               local_ranks: int = 1, backend: str = "gloo",
               timeout_s: float | None = None) -> None:
    """Join the world of ``num_processes`` host processes of
    ``local_ranks`` ranks each as rank ``process_id * local_ranks +
    local_rank``, at ``tcp://coordinator`` (a no-op for one process of
    one rank and no coordinator)."""
    n = (num_processes or 1) * local_ranks
    if n == 1 and coordinator is None:
        return
    if coordinator is None:
        raise ValueError("a run over several processes needs --coordinator host:port")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=n,
        rank=(process_id or 0) * local_ranks + local_rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S if timeout_s is None else timeout_s))


def global_mesh(space: int | None = None, time: int | None = None, *,
                devices=None, num_processes: int = 1,
                backend: str | None = None) -> Mesh:
    """(space, time) mesh over every rank of every process, laid out
    (time, space): consecutive processes own consecutive time rows.
    ``devices`` is the device of each global rank (default: the world's
    ranks on their processes' cards, ``cuda:<rank % cards>``).  The time
    axis must be a multiple of the process count, so each host owns whole
    time slabs."""
    if devices is None:
        cards = torch.cuda.device_count()
        if not cards:
            raise ValueError("no CUDA card: name the ranks' devices")
        devices = [f"cuda:{r % cards}" for r in range(dist.get_world_size())]
    devs = tuple(str(torch.device(d)) for d in devices)
    n = len(devs)
    if space is None and time is None:
        space, time = 1, n
    elif space is None:
        space = n // time
    elif time is None:
        time = n // space
    if space * time != n:
        raise ValueError(f"space*time ({space}*{time}) != n_devices ({n})")
    if time % num_processes:
        raise ValueError(
            f"time axis ({time}) must be a multiple of the process "
            f"count ({num_processes}) so each host owns whole time slabs")
    return Mesh(("time", "space"), (time, space), devs,
                backend or default_backend(devs), num_processes)


def stage_global_cube(local_frames, mesh: Mesh) -> torch.Tensor:
    """This rank's [T/t, H/s, ...] shard of the global frame cube, cut
    from its process's time-contiguous slab ``local_frames`` (the first
    axis holds T / processes frames), on the rank's device."""
    per_proc = mesh.size // mesh.procs
    proc = mesh.rank // per_proc
    rows_t = mesh.shape["time"] // mesh.procs          # time rows per process
    c = mesh.coords()
    tl = local_frames.shape[0] // rows_t
    hl = local_frames.shape[1] // mesh.shape["space"]
    ti = c["time"] - proc * rows_t
    si = c["space"]
    x = local_frames[ti * tl:(ti + 1) * tl, si * hl:(si + 1) * hl]
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(mesh.device)
