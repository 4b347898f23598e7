"""The four probes of the in-kernel int8 digit split (counterpart of
``benchmarks/calib_r3e.py``), on ``ops/int8split.py``.

Each probe contracts ``a8`` int8 [64, 256] against ``xf`` float32
[256, 256] (numpy seed 0, as the JAX script draws them):

* ``dot_computed_int8``: ``a8 @ round(xf * 64)``;
* ``dot_via_int32``: the same (the JAX probe's int32 detour asked a
  question of the TPU compiler only);
* ``redmax_log2``: ``(a8 @ round(xf * 2^-e * 64)) * 2^e`` with the column
  exponent ``e = ceil(log2(max|xf|)) + 1``;
* ``full_split``: the 3-digit split, of which two groups are combined,
  ``(w0 (a8 X0) + w1 (a8 X1 + a8 X0)) * 2^e``: the probe reuses one A
  plane, so it runs with the planes (a8, a8).

Run::

    python -m dspfun_tpu_torch.benchmarks.calib_r3e [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dspfun_tpu_torch.benchmarks import device_arg, parse_device
from dspfun_tpu_torch.ops.int8split import i8_split_contract

__all__ = ["K", "R", "M", "PROBES", "probe_inputs", "run_probes", "main"]

K, R, M = 256, 256, 64

# probe -> (A planes: copies of a8, i8_split_contract's instance)
PROBES = {
    "dot_computed_int8": (1, dict(xdigits=1, groups=1, scale="fixed64")),
    "dot_via_int32": (1, dict(xdigits=1, groups=1, scale="fixed64")),
    "redmax_log2": (1, dict(xdigits=1, groups=1, scale="exp")),
    "full_split": (2, dict(xdigits=3, groups=2, scale="exp")),
}


def probe_inputs() -> tuple[np.ndarray, np.ndarray]:
    """(a8 int8 [M, K], xf float32 [K, R]) from numpy seed 0."""
    rng = np.random.default_rng(0)
    a8 = rng.integers(-64, 64, (M, K)).astype(np.int8)
    xf = rng.random((K, R)).astype(np.float32)
    return a8, xf


def run_probes(device="cuda", inputs=None) -> dict[str, torch.Tensor]:
    """Probe name -> float32 [M, R] on ``device`` (the kernel on a card,
    its plain version on the CPU), for ``inputs`` = (a8, xf) or the
    seeded :func:`probe_inputs`."""
    a8, xf = probe_inputs() if inputs is None else inputs
    a = torch.tensor(np.asarray(a8), device=device)
    x = torch.tensor(np.asarray(xf), device=device)
    return {name: i8_split_contract(torch.stack([a] * planes), x, **inst)
            for name, (planes, inst) in PROBES.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="calib_r3e", description=__doc__.split("\n\n")[0])
    device_arg(parser)
    args = parser.parse_args(argv)
    dev = parse_device(parser, args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print(f"device: {name}", flush=True)
    for probe, out in run_probes(dev).items():
        print(f"{probe}: OK  sum={float(out.sum()):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
