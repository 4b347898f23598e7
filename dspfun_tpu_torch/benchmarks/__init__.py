"""Counterparts of the JAX package's calibration scripts under
``benchmarks/``, on the port's kernels.

* :mod:`dspfun_tpu_torch.benchmarks.calib_r3e`: the four probes of the
  in-kernel digit split (``benchmarks/calib_r3e.py``);
* :mod:`dspfun_tpu_torch.benchmarks.calib_r3f`: the in-kernel split at the
  4K chain's widest contraction, swept over the kernel's tiles
  (``benchmarks/calib_r3f.py``);
* :mod:`dspfun_tpu_torch.benchmarks.jpeg_decode`: host decode times of
  the port's JPEG codec on ``chip_smoke.py``'s 4K JPEG files (no
  counterpart in the JAX package; it runs on the host's CPU).

Each runs as ``python -m dspfun_tpu_torch.benchmarks.<name>``; nothing
runs at import.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["cuda_ms", "device_arg", "parse_device"]


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
    """``--device``: ``cuda`` (the kernels, the default) or ``cpu`` (their
    plain versions)."""
    parser.add_argument("--device", default="cuda",
                        help="cuda runs the kernels, cpu their plain versions "
                             "(default: cuda)")


def parse_device(parser: argparse.ArgumentParser, name: str) -> torch.device:
    """The device ``--device`` names; a CUDA device without a card is a
    usage error (exit 2 with a message), never a fall-back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {name}: torch.cuda.is_available() is False "
                     "(pass --device cpu for the plain versions)")
    return dev
