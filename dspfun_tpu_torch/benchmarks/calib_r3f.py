"""The in-kernel int8 digit split at the 4K chain's widest contraction
(counterpart of ``benchmarks/calib_r3f.py``), on ``ops/int8split.py``.

The contraction is the 4K fused chain's axis-1 forward DCT with the
bench mask's pruned rows: A = ``dct2_matrix(3840)[:960]`` split into three
int8 digit planes, x float32 [3840, 6480] = ``(random() - 0.3) * 4``
(numpy seed 0, as the JAX script draws it).  It runs three routes to the
same float32 [960, 6480] and reports each one's error against the float64
product ``mat @ x`` (taken on the same device), its time and its
effective int8 rate ``6 * 2 * M * K * R / t`` (six digit-pair products):

* ``fused``: ``csrc/int8split.cu``, x split inside the kernel, at each of
  the kernel's compiled output tiles (the JAX script swept the TPU's tile
  and VMEM limits; those have no counterpart here);
* ``split + int8mm``: the main path's route, the split as elementwise
  passes (``ops/int8mm._split_operand``) and then ``csrc/int8mm.cu``;
* ``plain``: the fused kernel's plain PyTorch version.

Times are CUDA-event medians on the card; on the CPU every route runs its
plain version and no time is taken.  Run::

    python -m dspfun_tpu_torch.benchmarks.calib_r3f [--device cuda] [--shape K,M,R]
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from dspfun_tpu_torch.benchmarks import cuda_ms, device_arg, parse_device
from dspfun_tpu_torch.core.basis import dct2_matrix
from dspfun_tpu_torch.ops import int8mm
from dspfun_tpu_torch.ops.int8split import (
    COMPILED_TILES, DEFAULT_TILE, TILES, _i8_split_plain, i8_split_contract,
)

__all__ = ["K", "M", "R", "inputs", "fused", "split_then_i8mm", "plain", "run", "main"]

K, M, R = 3840, 960, 2160 * 3


def inputs(k: int = K, m: int = M, r: int = R, device="cuda"):
    """(A digit planes int8 [3, m, kp], row scales float32 [m, 1], x
    float32 [k, r], the float64 matrix [m, k]) on ``device``."""
    rng = np.random.default_rng(0)
    mat = dct2_matrix(k)[:m].copy()   # dct2_matrix returns a cached, read-only array
    dig, rs = int8mm.split_matrix_i8(mat)
    x = (rng.random((k, r)).astype(np.float32) - 0.3) * 4
    return tuple(torch.from_numpy(v).to(device) for v in (dig, rs, x, mat))


def fused(a: torch.Tensor, x: torch.Tensor, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """x split inside the kernel: 3 digits, 3 groups, column exponents."""
    return i8_split_contract(a, x, xdigits=3, groups=3, scale="exp", tile=tile)


def split_then_i8mm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The split as elementwise passes, then the int8 digit kernel (left
    layout), then the column scales.  Its exponent rule (``log2_ceil1``)
    differs from the probes' only at columns whose max is a power of two."""
    xd, ex = int8mm._split_operand(x.reshape(1, *x.shape), 1)
    return int8mm._i8_groups(a, xd, "left")[0] * ex[0]


def plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _i8_split_plain(a, x, 3, 3, "exp")


def run(device="cuda", k: int = K, m: int = M, r: int = R) -> list[dict]:
    """One dict per route: ``route``, ``rel`` (max abs error of the
    row-scaled result against float64 over the largest |ref|), ``ms`` and
    ``tops`` (None off the card) and ``out``, the unscaled result."""
    device = torch.device(device)
    a, rs, x, mat = inputs(k, m, r, device)
    ref = mat @ x.to(torch.float64)
    on_card = device.type == "cuda"
    routes = ([(f"fused tile {TILES[t][0]}x{TILES[t][1]}", functools.partial(fused, tile=t))
               for t in COMPILED_TILES["exp3g3"]] if on_card else [("fused", fused)])
    routes += [("split + int8mm", split_then_i8mm), ("plain", plain)]
    rows = []
    for label, fn in routes:
        y = fn(a, x)
        rel = float((y.double() * rs - ref).abs().max() / ref.abs().max())
        ms = cuda_ms(lambda fn=fn: fn(a, x)) if on_card else None
        tops = 6 * 2 * m * k * r / ms / 1e9 if ms else None
        rows.append(dict(route=label, rel=rel, ms=ms, tops=tops, out=y))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="calib_r3f", description=__doc__.split("\n\n")[0])
    device_arg(parser)
    parser.add_argument("--shape", default=f"{K},{M},{R}",
                        help="K,M,R of the contraction (default: the 4K shape)")
    args = parser.parse_args(argv)
    k, m, r = (int(v) for v in args.shape.split(","))
    dev = parse_device(parser, args.device)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu (plain versions, not timed)"
    print(f"device: {name}; K={k} M={m} R={r}", flush=True)
    for row in run(dev, k, m, r):
        timing = (f"{row['ms']:.4f} ms  {row['tops']:.2f} eff-TOPS(int8)" if on_card
                  else "not timed")
        print(f"{row['route']}: rel={row['rel']:.2e} {timing}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
