"""Host decode times of the port's JPEG codec (``io/jpeg.py``,
``native/jpeg.cpp``) on the two 4K files of ``chip_smoke.py``'s phases
16a and 17a: the baseline JPEG ``encode_jpeg`` writes of
``_seeded_pixels((2160, 3840), 17)`` and ``tests/goldens/codec_prog_4k.jpg``
(progressive).  Each is decoded ``--repeats`` times after one warm-up
decode; the script prints the best and the median seconds of each, the
largest sum of a block's dequantised coefficients in absolute value
(``native/jpeg.cpp`` checks a block's IDCT range only past
``kNarrowL1``), and a last line of JSON with the same numbers.

Run from the root of a checkout::

    python -m dspfun_tpu_torch.benchmarks.jpeg_decode [--repeats N]

To time another checkout's codec (an older commit unpacked beside this
one) with this script, put that checkout first on the path and run the
file itself::

    PYTHONPATH=<checkout> python <this file> [--repeats N]

Two checkouts are compared only within one run on one host: the decode
runs on the host's CPU, whose speed varies from machine to machine.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

__all__ = ["decode_times", "main"]


def decode_times(repeats: int) -> dict:
    """{file: {"best_s", "median_s", "mb_per_s", "max_block_l1"}} of the
    two 4K decodes (MB/s of RGB output at the best time)."""
    import chip_smoke
    from dspfun_tpu_torch.io import jpeg

    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    rgb8 = chip_smoke._rgb8(chip_smoke._seeded_pixels((chip_smoke.H, chip_smoke.W), 17))
    with open(os.path.join(root, "tests", "goldens", "codec_prog_4k.jpg"), "rb") as f:
        files = {"baseline_4k": jpeg.encode_jpeg(rgb8), "codec_prog_4k.jpg": f.read()}
    out = {}
    for name, data in files.items():
        px, _ = jpeg.decode_jpeg(data)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jpeg.decode_jpeg(data)
            times.append(time.perf_counter() - t0)
        best = min(times)
        frame, coefs = jpeg.decode_coefficients(data)
        l1 = max(int(np.abs(k.reshape(-1, 64).astype(np.int64) * c.qtable.astype(np.int64))
                     .sum(1).max()) for c, k in zip(frame.components, coefs))
        out[name] = {"best_s": best, "median_s": float(np.median(times)),
                     "mb_per_s": px.size / 1e6 / best, "max_block_l1": l1}
        print(f"{name} {px.shape[1]}x{px.shape[0]}: {len(data)} bytes; decode best {best:.4f} s, "
              f"median {out[name]['median_s']:.4f} s ({out[name]['mb_per_s']:.1f} MB/s of RGB) "
              f"over {repeats}; largest block sum {l1}; codec "
              f"{os.path.dirname(os.path.abspath(jpeg.__file__))}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=9)
    args = ap.parse_args(argv)
    print(json.dumps(decode_times(args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
