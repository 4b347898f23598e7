#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dspfun_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. the card: CUDA must be available (nothing runs on the CPU); prints the
   card's name and power limit, and the float32 matmul settings (no TF32);
2. build: compiles ``dspfun_tpu_torch/csrc/*.cu`` with nvcc and prints the
   build time;
3. kernels: each int8 digit kernel (left/right layout, 3/4 digits) at the
   4K chain's four contraction shapes and one ragged shape, held bit-equal
   (``torch.equal``) to its plain PyTorch version on the same inputs, with
   both times (CUDA events, median of 10);
4. main path: ``filter_plans`` + ``fused_filter_2d`` on a 2160x3840x3 image
   at ``i8@1e-5`` (bench.py's configuration) and at deep ``i8``, each held
   to <= 1e-5 max abs error against a scipy float64 oracle and bit-equal
   to the same chain with the plain version forced, then
   ``spec_forward`` -> ``spec_inverse`` at the default policy (hilo,
   which is exact at this size: ``-t copy`` <= 1e-5 round trip, ``-t
   flat`` within its float32 floor) and ``-t flat`` at ``i8@1e-5``
   (kernel == plain).
   Kernel launches are counted over this phase alone: each chain must
   launch exactly 2 left and 2 right kernels, and every kernel must run;
5. timing: the 4K chain in MP/s with the kernels and with the plain
   version forced.

Prints one JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W, C = 2160, 3840, 3           # 4K RGB, bench.py's image
CHAIN_TOL = 1e-5                  # max abs error vs float64 (BASELINE.md)
SRC = "dspfun_tpu_torch/csrc/int8mm.cu"
REPLACES = {                      # the Pallas bodies each instantiation replaces
    "left3": "dspfun_tpu/ops/int8mm.py:165",
    "left4": "dspfun_tpu/ops/int8mm.py:180",
    "right3": "dspfun_tpu/ops/int8mm.py:199",
    "right4": "dspfun_tpu/ops/int8mm.py:213",
}
# (layout, M, K, B, R): the 4K i8 chain's contractions with the bench mask
# (cutoff 0.25 keeps 540 of 2160 rows and 960 of 3840 columns), then one
# ragged shape per layout with M, K and R off every tile multiple
KERNEL_SHAPES = [
    ("left", 540, 2160, 3, 3840, "forward H"),
    ("left", 2160, 540, 3, 960, "inverse H"),
    ("right", 960, 3840, 1, 3 * 540, "forward W"),
    ("right", 3840, 960, 1, 3 * 2160, "inverse W"),
    ("left", 77, 300, 2, 45, "ragged"),
    ("right", 77, 300, 2, 45, "ragged"),
]


def _time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
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


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA card and nothing runs on the CPU",
              file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scipy.fft

    from dspfun_tpu_torch import _build
    from dspfun_tpu_torch.core.precision import Precision
    from dspfun_tpu_torch.models.fused import (
        filter_plans, fused_filter_2d, lowpass_mask,
    )
    from dspfun_tpu_torch.models.spec_pipeline import (
        SpecChainParams, spec_forward, spec_inverse,
    )
    from dspfun_tpu_torch.ops import int8mm

    dev = torch.device("cuda", 0)
    print(f"card: {_card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    fp32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    print(f"float32 matmul settings: {json.dumps(fp32)}", flush=True)
    if fp32["cuda.matmul.allow_tf32"] or fp32["cudnn.allow_tf32"] \
            or fp32["float32_matmul_precision"] != "highest":
        raise RuntimeError("TF32 is enabled; float32 contractions would lose accuracy")

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})",
          flush=True)

    @contextlib.contextmanager
    def plain_groups():
        """Route the digit-pair groups through the plain version on the
        card (the comparison baseline); no kernel may launch inside."""
        saved, before = int8mm._i8_groups, sum(int8mm.LAUNCHES.values())
        int8mm._i8_groups = int8mm._i8_groups_plain
        try:
            yield
        finally:
            int8mm._i8_groups = saved
        if sum(int8mm.LAUNCHES.values()) != before:
            raise RuntimeError("a kernel launched while the plain version was forced")

    # ---- phase 3: each kernel against its plain version -----------------
    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {name: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
             for name in REPLACES}
    for nd in (3, 4):
        for layout, m, k, b, r, what in KERNEL_SHAPES:
            kp = int8mm.ceil_to(k, 128)
            a = torch.randint(-64, 65, (nd, m, kp), generator=gen, device=dev,
                              dtype=torch.int8)
            a[:, :, k:] = 0  # the plan's zero padding of K
            xshape = (nd, b, k, r) if layout == "left" else (nd, b, r, k)
            x = torch.randint(-64, 65, xshape, generator=gen, device=dev,
                              dtype=torch.int8)
            y = int8mm._i8_groups_cuda(a, x, layout)
            ref = int8mm._i8_groups_plain(a, x, layout)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            if not torch.equal(y, ref):
                raise RuntimeError(f"{layout}{nd} {what} M={m} K={k} B={b} R={r}: "
                                   f"kernel != plain (max abs diff {err})")
            ms = _time_ms(torch, lambda: int8mm._i8_groups_cuda(a, x, layout))
            plain_ms = _time_ms(torch, lambda: int8mm._i8_groups_plain(a, x, layout))
            name = f"{layout}{nd}"
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if what != "ragged":
                st["ms"] += ms
                st["plain_ms"] += plain_ms
            print(f"kernel {name} {what:9s} M={m} K={k} B={b} R={r}: equal, "
                  f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain", flush=True)
            del a, x, y, ref
    torch.cuda.empty_cache()

    # ---- phase 4: the main path, launches counted -----------------------
    rng = np.random.default_rng(0)
    x_np = rng.random((H, W, C)).astype(np.float32)
    mask_np = lowpass_mask((H, W), cutoff=0.25, boost=1.25, damp=0.0)[:, :, None]
    ref = scipy.fft.dctn(x_np.astype(np.float64), type=2, axes=(0, 1), workers=-1)
    ref *= mask_np
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1), workers=-1) / (4.0 * W * H)

    bench = Precision(coeff="float32", intermediate="i8", tol=1e-5)
    deep = Precision(coeff="float32", intermediate="i8")
    plans = {p: filter_plans((H, W), p, mask=mask_np, device=dev) for p in (bench, deep)}
    x = torch.from_numpy(x_np).to(dev)
    mask = torch.from_numpy(mask_np.astype(np.float32)).to(dev)
    flat = SpecChainParams.template("flat")
    copy = SpecChainParams.template("copy")

    def chain(p):
        return fused_filter_2d(x, mask, plans[p], p)

    def spec_round_trip(p, params=flat):
        f, _ = spec_forward(x, params, p)
        return spec_inverse(f, params, precision=p)

    def launched(fn, expect):
        before = dict(int8mm.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        got = {n: int8mm.LAUNCHES[n] - before.get(n, 0) for n in REPLACES}
        got = {n: v for n, v in got.items() if v}
        if got != expect:
            raise RuntimeError(f"kernel launches {got}, expected {expect}")
        return out

    int8mm.LAUNCHES.clear()
    y = {p: launched(lambda p=p: chain(p), {f"left{n}": 2, f"right{n}": 2})
         for p, n in ((bench, 3), (deep, 4))}
    back_exact = launched(lambda: spec_round_trip(Precision()), {})
    back_i8 = launched(lambda: spec_round_trip(bench), {"left3": 2, "right3": 2})
    launches = {n: int8mm.LAUNCHES[n] for n in REPLACES}
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")

    for p, label in ((bench, "i8@1e-5"), (deep, "i8")):
        err = float(np.max(np.abs(y[p].cpu().numpy().astype(np.float64) - ref)))
        with plain_groups():
            y_plain = chain(p)
        same = torch.equal(y[p], y_plain)
        print(f"4K fused chain {label}: max abs err vs f64 {err:.3e}, "
              f"kernel == plain: {same}", flush=True)
        if not (np.isfinite(err) and err <= CHAIN_TOL and same):
            raise RuntimeError(f"4K fused chain {label} failed")
        del y_plain

    # -t flat stores (f/2 + 0.5) * 254/255 in float32, which rounds every
    # coefficient to about 2^-24 absolute; the inverse sums h*w of those
    # independent errors, so the round trip floors near
    # c * sqrt(h*w) * 2^-24 in the JAX package too (c = 2.2 at 512x512 in
    # both packages, 3.0 at 1024x1152 on the CPU).  The gate takes c = 8;
    # a bias that sums coherently (the host-scalar division true_div
    # avoids) lands 1000x above it.  -t copy skips the offset and carries
    # the <= 1e-5 transform-accuracy gate.
    err = float((back_exact - x).abs().max())
    floor = 8.0 * np.sqrt(H * W) * 2.0**-24
    print(f"spec flat round trip (hilo -> exact): max abs err {err:.3e} "
          f"(float32 floor bound {floor:.3e})", flush=True)
    if not err <= floor:
        raise RuntimeError("spec flat round trip at the default policy failed")
    err = float((launched(lambda: spec_round_trip(Precision(), copy), {}) - x).abs().max())
    print(f"spec copy round trip (hilo -> exact): max abs err {err:.3e}", flush=True)
    if not err <= CHAIN_TOL:
        raise RuntimeError("spec copy round trip at the default policy failed")
    with plain_groups():
        back_plain = spec_round_trip(bench)
    err = float((back_i8 - x).abs().max())
    same = torch.equal(back_i8, back_plain)
    print(f"spec flat round trip i8@1e-5: max abs err {err:.3e}, "
          f"kernel == plain: {same}", flush=True)
    if not (err <= floor and same):
        raise RuntimeError("spec flat round trip at i8@1e-5 failed")
    del back_exact, back_i8, back_plain

    # ---- phase 5: chain throughput, kernel vs plain ---------------------
    for p, label in ((bench, "i8@1e-5"), (deep, "i8")):
        ms = _time_ms(torch, lambda p=p: chain(p))
        with plain_groups():
            plain_ms = _time_ms(torch, lambda p=p: chain(p))
        print(f"4K fused chain {label}: {H * W / ms / 1e3:.2f} MP/s kernel "
              f"({ms:.3f} ms), {H * W / plain_ms / 1e3:.2f} MP/s plain "
              f"({plain_ms:.3f} ms)", flush=True)

    kernels = [{"name": f"i8mm_{n}", "route": "cuda", "source": SRC,
                "replaces": REPLACES[n], "launches": launches[n],
                "max_abs_err": stats[n]["max_abs_err"],
                "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"]}
               for n in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
