"""Counterparts of the JAX package's calibration scripts under
``benchmarks/``, on the port's kernels.

* :mod:`dspfun_tpu_torch.benchmarks.calib_r3e`: the four probes of the
  in-kernel digit split (``benchmarks/calib_r3e.py``);
* :mod:`dspfun_tpu_torch.benchmarks.calib_r3f`: the in-kernel split at the
  4K chain's widest contraction, swept over the kernel's tiles
  (``benchmarks/calib_r3f.py``).

Each runs as ``python -m dspfun_tpu_torch.benchmarks.<name>``; nothing
runs at import.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["cuda_ms", "device_arg"]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms: CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_arg(parser: argparse.ArgumentParser) -> None:
    """``--device``: ``cuda`` (the kernels) when a card is present, else
    ``cpu`` (their plain versions)."""
    parser.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu",
                        help="cuda runs the kernels, cpu their plain versions "
                             "(default: cuda when a card is present)")
