"""Tracing and per-stage timing (PyTorch port of
``dspfun_tpu/utils/profiling.py``).

Every CLI run through ``tools.run_main`` accepts ``DSPFUN_PROFILE=<dir>``
to capture a ``torch.profiler`` trace of the host and, where there is a
card, the device (``<dir>/trace.json``, a Chrome trace for Perfetto or
``chrome://tracing``), and ``DSPFUN_TIMINGS=1`` to print per-stage wall
times to stderr.  Both are off unless the variable is set; a stage then
costs two clock reads.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

__all__ = ["maybe_profile", "stage", "timings_enabled"]


def timings_enabled() -> bool:
    return os.environ.get("DSPFUN_TIMINGS", "") not in ("", "0")


@contextlib.contextmanager
def maybe_profile():
    """Capture a host and device trace when DSPFUN_PROFILE=<dir> is set."""
    trace_dir = os.environ.get("DSPFUN_PROFILE")
    if not trace_dir:
        yield
        return
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    print(f"profile trace written to {trace_dir}", file=sys.stderr)


@contextlib.contextmanager
def stage(name: str, sink: dict | None = None):
    """Per-stage wall timing: the seconds go into ``sink[name]`` when a
    dict is given, and to stderr when DSPFUN_TIMINGS is set.  Device work
    counts only as far as the stage waits for it."""
    if sink is None and not timings_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = dt
        if timings_enabled():
            print(f"[dspfun] {name}: {dt * 1000:.1f} ms", file=sys.stderr)
