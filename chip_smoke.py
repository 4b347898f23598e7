#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dspfun_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. the card: CUDA must be available (nothing runs on the CPU); prints the
   card's name and power limit, and the float32 matmul settings (no TF32);
2. build: compiles ``dspfun_tpu_torch/csrc/*.cu`` with nvcc (one process
   per source, in parallel) and prints the build time;
3. kernels: ptxas's registers and spills for each kernel of
   ``int8mm.cu`` and ``block_filter.cu`` (the build runs ``-Xptxas -v``)
   and, where ``cuobjdump`` is found, the tensor-core MMA instructions in
   each one's SASS (``IGMMA`` for the int8 kernels, ``HGMMA`` for the
   block filter's TF32 products; none is a failure);
   each int8 digit kernel (left/right layout, 3/4 digits) at the 4K
   chain's four contraction shapes and one ragged shape, the right
   3-digit kernel at motion's two i8-kron shapes, and (at the start of
   phase 8) the left and right 3-digit kernels at the spec CLI's two
   unpruned shapes, held bit-equal
   (``torch.equal``) to its plain PyTorch version on the same inputs,
   with both times (CUDA events, median of 10), its bound (operations at
   1,979 int8 TOP/s or bytes at 3.35 TB/s, the larger) and share of it,
   and its library yardstick: ``torch._int_mm``, one call per digit group
   on the K-concatenated digit planes, summed, whose int32 groups combined
   as the kernel combines must equal the plain version bit for bit
   ("refused" with the message where ``_int_mm`` refuses a shape); the
   fused block filter kernel (split TF32 on the tensor cores, a 2-CTA
   cluster per 64 rows) at motion's
   1080p chroma shape, a half-thresholded 1080p luma 8^3 shape and a
   ragged quant + threshold shape, held to 1e-2 (pels) against its plain
   version (blocks with a coefficient within the estimated kernel-vs-plain
   error ``block_filter.boundary_band`` of a threshold or quant boundary
   are excluded and counted) and, on the linear chroma shape, against a
   scipy float64 oracle beside the plain version's error, with its bound
   (the split's three TF32 products at 495 TFLOP/s), the float32 FMA
   bound of the unsplit products (67 TFLOP/s) printed beside it, and two float32
   ``torch.matmul`` calls as its library yardstick;
4. main path 1: ``filter_plans`` + ``fused_filter_2d`` on a 2160x3840x3 image
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
   version forced, then a torch.profiler window over five chains: device
   time per chain in the int8 kernel, its staging pass and the other
   kernels, and the device's idle share;
6. main path 2, motion: the motion CLI (``dspfun_tpu_torch.tools.motion``,
   ``-b 16x16x16 -p 0x0x0-8x8x4 -B 1.25``) on a seeded 1920x1080 yuv420p
   y4m clip of 48 frames (3 slabs).  Launches are counted over this run
   alone: 2 right 3-digit kernels (luma i8-kron) and 2 block filter
   kernels (chroma) per slab.  Every output pel must lie within one
   level of a scipy float64 blockwise DCT oracle.  Then the slab time per
   plane, the CLI's frames/s with the kernels and with both plain
   versions forced, and the per-slab luma time at slab batch 1, 2, 4;
7. main path 3, the calibration of the in-kernel digit split: ptxas's
   registers and spills and the ``IGMMA`` count of each instance of
   ``int8split.cu`` (none is a failure), then the four probes of
   ``dspfun_tpu_torch.benchmarks.calib_r3e`` and the tile sweep of
   ``calib_r3f`` at K=3840 M=960 R=6480 on that kernel.  Launches are
   counted over this phase alone: every instance must run, and the left
   3-digit int8 kernel through calib_r3f's split + int8mm route.  Each
   probe equals its plain version bit for bit; at the 4K shape every tile
   equals the plain version and the split-then-int8mm route bit for bit,
   and each route's error against a float64 product on the card is
   <= 1e-5 of the largest output.  Prints each route's time and
   eff-TOPS, the probes' kernel and plain times, and each instance's
   bound; the fused kernel's library yardstick is ``torch._int_mm`` on
   the digits split beforehand;
8. main path 4, ``spec`` then ``ispec`` through files: a seeded 3840x2160
   RGB image (noise on a smooth term) written by the port's
   ``write_image`` as a 16-bit PNG, then ``tools.spec.main`` and
   ``tools.ispec.main`` in process for ``-t flat`` and ``-t copy`` at the
   tools' default policy (no kernel may launch) and ``-t flat`` at
   ``i8@1e-5`` (launches counted over each call: one left and one right
   3-digit kernel per tool; both files byte-equal to the same run with
   the plain version forced).  Each spectrum file is held to a scipy
   float64 oracle of the reference's scalar chain quantised to 16 bits
   (within one level; prints the share off by one) and its ``DC``
   property to the channel means (1e-6).  ``-t flat`` must return the
   input within the noise its 16-bit spectrum leaves: every coefficient
   is stored to half a level of ``(f / 2 + 0.5) * 254 / 255``, the
   inverse sums w*h of those errors with unit weights, so the image
   comes back with sqrt(w*h) * 2 * 255/254 / sqrt(12) = 1669.3 levels rms
   of noise at this size (held to 5 % of that, the largest to 7 sigma =
   11685 levels).  ``-t copy`` stores no sign, a PNG holds no negative
   coefficient, and the writer's clip drops them (in the JAX package
   too): its output is held to a float64 inverse of the spectrum as the
   file holds it, within one level.  Prints each tool's seconds per stage
   (read, host to device, compute on the host's clock and between CUDA
   events, device to host, quantise + PNG encode + write), the peak
   device memory of the default-policy run, a float64 contraction rounded
   to float32 beside the ``exact`` contraction at spec's two shapes (time
   and distance in float32 ulps), and, for the PNG codec, a round trip of
   each of the five filters at both depths at a small size and the
   encode and decode seconds of a 3840x2160 8-bit RGB image per filter.

Prints one JSON line of per-kernel results (launches on the main paths,
max abs error, ms, plain_ms, bound_ms, bound_by, library_ms), then, as
the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np

from dspfun_tpu_torch.benchmarks import cuda_ms

H, W, C = 2160, 3840, 3           # 4K RGB, bench.py's image
CHAIN_TOL = 1e-5                  # max abs error vs float64 (BASELINE.md)
SRC = "dspfun_tpu_torch/csrc/int8mm.cu"
REPLACES = {                      # the Pallas bodies each instantiation replaces
    "left3": "dspfun_tpu/ops/int8mm.py:165",
    "left4": "dspfun_tpu/ops/int8mm.py:180",
    "right3": "dspfun_tpu/ops/int8mm.py:199",
    "right4": "dspfun_tpu/ops/int8mm.py:213",
}
# the card's peaks (NVIDIA's H100 SXM data sheet: dense rates at 700 W)
INT8_OPS = 1979e12                # int8 tensor-core operations/s
F32_FLOPS = 67e12                 # float32 outside the tensor cores
TF32_FLOPS = 495e12               # TF32 tensor-core operations/s
HBM_BYTES = 3.35e12               # device memory bytes/s
BF_SRC = "dspfun_tpu_torch/csrc/block_filter.cu"
BF_REPLACES = "dspfun_tpu/ops/pallas_kernels.py:51"
BF_TOL = 1e-2                     # pels; the JAX package's bound (tests/test_pallas.py:43)
I8S_SRC = "dspfun_tpu_torch/csrc/int8split.cu"
I8S_REPLACES = {                  # the split kernel's instances and the Pallas bodies they replace
    "fixed1": "benchmarks/calib_r3e.py:40, benchmarks/calib_r3e.py:46",
    "exp1": "benchmarks/calib_r3e.py:51",
    "exp3g2": "benchmarks/calib_r3e.py:59",
    "exp3g3": "benchmarks/calib_r3f.py:19",
}
CALIB_TOL = 1e-5                  # rel error vs float64 at the 4K shape (the chain's gate)
# motion at 1080p 4:2:0 (benchmarks/suite.py:444-456 at the frame size
# users process): 16x16x16 luma blocks run i8-kron, the 8x8x16 chroma
# blocks the fused block filter
MH, MW, MFRAMES = 1080, 1920, 48
MOTION_ARGS = ["-Q", "-b", "16x16x16", "-p", "0x0x0-8x8x4", "-B", "1.25"]
MOTION_NB = (MH // 16) * (MW // 16)   # 8040 blocks per slab and plane
# the luma i8-kron contractions: [S, V] then [V, S], S = 8*8*4 pass-band rows
MOTION_I8_SHAPES = [(256, 4096, MOTION_NB, "motion fwd"), (4096, 256, MOTION_NB, "motion inv")]
# the spec and ispec CLIs at i8@1e-5 (no mask, so nothing is pruned): the
# H contraction channel-first in the left layout, then W in the right one
SPEC_I8_SHAPES = [("left", H, H, C, W, "spec H"), ("right", W, W, 1, C * H, "spec W")]
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


# spec -t flat through a 16-bit file: levels rms of noise per sqrt(pixel)
# in the image that ispec returns (see phase 8 in the docstring)
FLAT_FILE_NOISE = 2.0 * 255.0 / 254.0 / np.sqrt(12.0)
SPEC_CLI_EXPECT = {"left3": 1, "right3": 1}     # launches per tool at i8@1e-5


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bound(ops: float, rate: float, nbytes: float) -> tuple[float, str]:
    """(the least time in ms the card could take, what bounds it): the
    larger of the operations over the peak rate and the bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _pairs(a_planes: int, x_digits: int) -> int:
    """Digit-pair products of the plain version's groups (one group per A plane)."""
    return sum(1 for g in range(a_planes) for i in range(g + 1) if g - i < x_digits)


def _i8_bound(a, x, layout: str) -> tuple[float, str]:
    nd, m, _ = a.shape
    _, b, d1, d2 = x.shape
    k, r = (d1, d2) if layout == "left" else (d2, d1)
    return _bound(2.0 * m * k * r * b * _pairs(nd, x.shape[0]), INT8_OPS,
                  a.numel() + x.numel() + 4 * b * m * r)


def _int_mm_library(torch, a, x, layout: str, weights, ref):
    """The library yardstick of an int8 digit contraction: ``torch._int_mm``
    (cuBLASLt int8 on the tensor cores, exact int32 out), one call per
    digit group on the K-concatenated planes [A_0 ... A_g] @ [x_g; ...;
    x_0], timed and summed over the groups.  The operands, and the zero
    padding ``_int_mm`` demands (more than 16 rows, K and the output
    columns multiples of 8), are built outside the timing.  Its int32
    groups combined as the kernel combines must equal ``ref``, the plain
    version, bit for bit.  Returns (ms or None, note); the port never
    calls ``_int_mm``."""
    nd, m, _ = a.shape
    _, b, d1, d2 = x.shape
    k, r = (d1, d2) if layout == "left" else (d2, d1)
    xk = (x.transpose(2, 3) if layout == "left" else x).reshape(x.shape[0], b * r, k)
    pad = torch.nn.functional.pad
    calls = []
    for g in range(nd):
        pairs = [i for i in range(g + 1) if g - i < x.shape[0]]
        lhs = torch.cat([a[i, :, :k] for i in pairs], 1)        # [M, K']
        rhs = torch.cat([xk[g - i] for i in pairs], 1)          # [B R, K']
        kpad = -lhs.shape[1] % 8
        if layout == "left":                                    # [M, K'] @ [K', B R]
            mat1 = pad(lhs, (0, kpad)).contiguous()
            mat2 = pad(rhs, (0, kpad, 0, -rhs.shape[0] % 8)).contiguous().t()
        else:                                                   # [B R, K'] @ [K', M]
            mat1 = pad(rhs, (0, kpad)).contiguous()
            mat2 = pad(lhs, (0, kpad, 0, -m % 8)).contiguous().t()
        calls.append((mat1, mat2))
    try:
        outs = [torch._int_mm(m1, m2) for m1, m2 in calls]
    except RuntimeError as e:
        return None, "refused: " + str(e).strip().splitlines()[0]
    y = None
    for g, o in enumerate(outs):
        t = o.float() * weights[g]
        y = t if y is None else y + t
    if layout == "left":
        y = y[:, : b * r].reshape(m, b, r).permute(1, 0, 2)
    else:
        y = y[:, :m].reshape(b, r, m)
    torch.cuda.synchronize()
    if not torch.equal(y, ref):
        raise RuntimeError(f"torch._int_mm's int32 groups combined as the kernel combines "
                           f"differ from the plain version ({layout}, M={m} K={k} B={b} R={r})")
    ms = sum(cuda_ms(lambda m1=m1, m2=m2: torch._int_mm(m1, m2)) for m1, m2 in calls)
    return ms, f"{len(calls)} torch._int_mm calls, int32 groups == plain"


def _ptxas_lines(log: str, source: str) -> list[str]:
    """ptxas's registers and spills for each kernel of ``source`` in the
    build log, one line per kernel, and its performance warnings."""
    part = log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0] if log else ""
    lines, fn = [], None
    for ln in part.splitlines():
        if "Function properties for" in ln:
            fn, spill = ln.split("Function properties for")[1].strip(), ""
        elif "spill" in ln and fn:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn:
            lines.append(f"{fn}: {ln.split('info    :')[1].strip()}; {spill}")
            fn = None
        elif "Performance" in ln or "warning" in ln.lower():
            lines.append(ln.strip())
    return lines


def _sass_mma_counts(path: str) -> dict | None:
    """Tensor-core MMA instructions (warpgroup MMA: ``GMMA`` in their SASS
    name, ``IGMMA`` for int8, ``HGMMA`` for TF32) per kernel of the built
    library, from ``cuobjdump --dump-sass``; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and "GMMA" in ln:
            counts[fn] += 1
    return counts


def _check_mma(mma: dict | None, kernel: str, expect: int) -> None:
    """Print the tensor-core MMA count of every instance of ``kernel`` and
    fail unless there are ``expect`` instances, each with one or more."""
    if mma is None:
        print(f"SASS: cuobjdump not found; {kernel}'s tensor-core MMA count not read",
              flush=True)
        return
    got = {fn: n for fn, n in mma.items() if kernel in fn}
    print(f"SASS tensor-core MMA instructions per {kernel}: {json.dumps(got)}", flush=True)
    if len(got) != expect or not all(got.values()):
        raise RuntimeError(f"a {kernel} instance has no tensor-core MMA in its SASS: {got}")


def _profile_chain(torch, fn, label: str, runs: int = 5) -> None:
    """torch.profiler over ``runs`` calls of ``fn`` after a warm-up: device
    time per call from the kernel events, split into the int8 MMA kernel,
    its staging pass and everything else (the digit split, scales and
    casts), the device's idle share of the window and the kernels per
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print(f"profile {label}: the profiler saw no device events", flush=True)
        return
    groups = {"i8mm_kernel": 0.0, "stage_x_kernel": 0.0, "other": 0.0}
    busy, reach = 0.0, spans[0][0]
    for start, end, name in spans:
        key = next((g for g in groups if g in name), "other")
        groups[key] += (end - start) / 1e3 / runs
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    window = spans[-1][1] - spans[0][0]
    print(f"profile {label} ({runs} calls): {wall_ms:.3f} ms host wall per call; device "
          f"per call: int8 MMA kernel {groups['i8mm_kernel']:.3f} ms, its staging pass "
          f"{groups['stage_x_kernel']:.3f} ms, other kernels {groups['other']:.3f} ms; "
          f"{len(spans) / runs:.0f} device events per call; device idle "
          f"{100 * (1 - busy / window):.1f} % of the window", flush=True)


def _uniform_factor(d: int, h: int, w: int) -> np.ndarray:
    """motion's uniform renorm 2*sqrt2 / (s_z s_y s_x), s = sqrt2 at index
    0 and 1 elsewhere (reference motion.c:643-647)."""
    s = [np.where(np.arange(n) > 0, 1.0, np.sqrt(2.0)) for n in (d, h, w)]
    return 2.0 * np.sqrt(2.0) / (s[0][:, None, None] * s[1][None, :, None]
                                 * s[2][None, None, :])


def _lowpass_box(dims, box, boost) -> np.ndarray:
    """``boost`` inside the [0, box) corner of a (d, h, w) block, 0 outside:
    motion's bandpass with begin 0 and damp 0."""
    m = np.zeros(dims)
    m[: box[0], : box[1], : box[2]] = boost
    return m


def _check_block_filter(torch, dev, block_filter, fft) -> dict:
    """Kernel #3 against its plain version at three shapes, and against
    scipy float64 on the linear chroma shape.  Returns its JSON stats."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ms_by_shape": {}}
    for label, nb, dims in (("chroma 1080p", MOTION_NB, (16, 8, 8)),
                            ("threshold 1080p luma 8^3", 32400, (8, 8, 8)),
                            ("ragged", 37, (8, 5, 5))):
        v = int(np.prod(dims))
        uf = _uniform_factor(*dims)
        filt = uf * _lowpass_box(dims, (4, 4, 4), 1.25) if label.startswith("chroma") else uf
        k2m_t, k3s_t, split = block_filter._folded_operands(dims, filt, 1.0 / uf, dev)
        x = torch.rand((nb, v), generator=gen, device=dev) * 255.0
        f = x @ k2m_t                       # the plain version's coefficients
        a = f.abs()
        sample = a[:4000].flatten()
        quant, tmin, tmax = 0.0, 0.0, 0.0
        if not label.startswith("chroma"):
            lo, hi = (0.45, 0.95) if label.startswith("threshold") else (0.2, 0.99)
            tmin, tmax = (float(torch.quantile(sample, q)) for q in (lo, hi))
        if label == "ragged":
            quant = float(torch.quantile(sample, 0.5)) / 4.0
        # a coefficient within the estimated kernel-vs-plain error of a
        # threshold or quant boundary may fall either way: its block is
        # left out of the comparison and counted
        band = block_filter.boundary_band(x, k2m_t)
        near = torch.zeros_like(a, dtype=torch.bool)
        if tmax:
            near |= ((a - tmin).abs() <= band) | ((a - tmax).abs() <= band)
            zeroed = float(((a < tmin) | (a > tmax)).float().mean())
        if quant:
            yq = block_filter._middle(f, 0.0, tmin, tmax).abs() * (1.0 / quant)
            half = torch.floor(yq) + 0.5
            near |= (yq - half).abs() <= band / quant
        keep = ~near.any(dim=1)
        del band
        args = (x, k2m_t, k3s_t, quant, tmin, tmax)
        y = block_filter._block_filter_cuda(*args, split)
        ref = block_filter._block_filter_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs()[keep].max())
        if not (np.isfinite(err) and err <= BF_TOL and bool(torch.isfinite(y).all())):
            raise RuntimeError(f"block filter {label}: max abs diff {err} vs plain "
                               f"(tolerance {BF_TOL})")
        msg = (f"kernel block_filter {label} NB={nb} V={v} dims={dims}: max abs diff vs "
               f"plain {err:.3e} over {int(keep.sum())} blocks "
               f"({nb - int(keep.sum())} excluded within band_c = "
               f"{block_filter.band_c(v):.2f} units of a boundary)")
        if tmax:
            msg += f", threshold zeroes {zeroed:.3f} of the coefficients"
        if quant:
            msg += f", quant {quant:.4g}"
        if label.startswith("chroma"):
            xb = x.double().cpu().numpy().reshape((nb,) + dims)
            axes = (1, 2, 3)
            ff = fft.dctn(xb, type=2, axes=axes, workers=-1) * filt * (1.0 / uf)
            oracle = fft.dctn(ff, type=3, axes=axes, workers=-1) / (8.0 * v)
            oracle = oracle.reshape(nb, v)
            oerr = float(np.max(np.abs(y.double().cpu().numpy() - oracle)))
            perr = float(np.max(np.abs(ref.double().cpu().numpy() - oracle)))
            msg += f"; vs float64 {oerr:.3e} (plain {perr:.3e})"
            out["f64_err"], out["plain_f64_err"] = oerr, perr
            if not oerr <= BF_TOL:
                raise RuntimeError(f"block filter {label}: {oerr} vs float64")
        ms = cuda_ms(lambda: block_filter._block_filter_cuda(*args, split))
        plain_ms = cuda_ms(lambda: block_filter._block_filter_plain(*args))
        # the split's three TF32 products of the two [NB, V] x [V, V]
        # products on the tensor cores; the unsplit products on the float32
        # FMA pipes beside it (the bound of the parent's kernel); the
        # library yardstick is the same two products in cuBLAS float32 with
        # the middle stage left out
        nbytes = 8.0 * nb * v + 8.0 * v * v
        bound_ms, bound_by = _bound(3 * 4.0 * nb * v * v, TF32_FLOPS, nbytes)
        fma_ms, _ = _bound(4.0 * nb * v * v, F32_FLOPS, nbytes)
        lib_ms = cuda_ms(lambda: (x @ k2m_t) @ k3s_t)
        print(f"{msg}; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms "
              f"({bound_by}, split TF32), {100 * bound_ms / ms:.1f} % of bound; float32 FMA "
              f"bound {fma_ms:.4f} ms; library {lib_ms:.4f} ms (two float32 torch.matmul), "
              f"kernel/library {ms / lib_ms:.3f}", flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms_by_shape"][label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "library_ms": lib_ms,
                                     "excluded": nb - int(keep.sum())}
        if label.startswith("chroma"):        # the motion path's shape
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
        del x, f, a, y, ref
    return out


def _write_clip(video, path: str) -> list:
    """A seeded MWxMH yuv420p y4m clip of MFRAMES frames (smooth moving
    content plus noise), written with the port's Y4MWriter.  Returns the
    planes as [MFRAMES, h, w] uint8 arrays."""
    rng = np.random.default_rng(0)
    pf = video.PIXEL_FORMATS["yuv420p"]
    dims = pf.plane_dims(MW, MH)
    planes = [np.empty((MFRAMES, h, w), np.uint8) for w, h in dims]
    writer = video.open_output(path, MW, MH, Fraction(25, 1),
                               video.ColorProps(pix_fmt="yuv420p"))
    with writer:
        for t in range(MFRAMES):
            frame = []
            for i, (w, h) in enumerate(dims):
                sx = np.sin(np.arange(w) / (23.0 + 4 * i) + t / 7.0)
                cy = np.cos(np.arange(h) / 17.0 - t / 11.0)
                p = 128.0 + 70.0 * cy[:, None] * sx[None, :] \
                    + 8.0 * rng.standard_normal((h, w), dtype=np.float32)
                planes[i][t] = np.clip(np.rint(p), 0, 255)
                frame.append(planes[i][t])
            writer.write_frame(frame, raw=True)
    return planes


def _read_y4m(path: str, nframes: int):
    """(header line, [nframes, h, w] uint8 planes) of a yuv420p y4m file."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        tags = {t[0]: t[1:] for t in header.split()[1:]}
        w, h = int(tags["W"]), int(tags["H"])
        dims = [(w, h), ((w + 1) // 2, (h + 1) // 2), ((w + 1) // 2, (h + 1) // 2)]
        planes = [np.empty((nframes, ph, pw), np.uint8) for pw, ph in dims]
        for t in range(nframes):
            if f.readline() != b"FRAME\n":
                raise RuntimeError(f"{path}: frame {t} missing")
            for p, (pw, ph) in zip(planes, dims):
                p[t] = np.frombuffer(f.read(pw * ph), np.uint8).reshape(ph, pw)
        if f.read(1):
            raise RuntimeError(f"{path}: trailing bytes after {nframes} frames")
    return header, planes


def _motion_oracle(frames: np.ndarray, block, box, out_hw, fft) -> np.ndarray:
    """motion's lowpass edit in float64: per (d, h, w) block, scipy DCT-II,
    ``box`` boosted by 1.25 and the rest zeroed, DCT-III / (8V), then
    floor(x + 0.5) clipped to 0..255; rows and columns the block grid
    truncates are zero, as the tool pads them."""
    bd, bh, bw = block
    n, h, w = frames.shape
    nbh, nbw = h // bh, w // bw
    a = frames[:, : nbh * bh, : nbw * bw].astype(np.float64)
    a = a.reshape(n // bd, bd, nbh, bh, nbw, bw)
    mult = _lowpass_box(block, box, 1.25)[None, :, None, :, None, :]
    f = fft.dctn(a, type=2, axes=(1, 3, 5), workers=-1) * mult
    y = fft.dctn(f, type=3, axes=(1, 3, 5), workers=-1) / (8.0 * bd * bh * bw)
    y = np.clip(np.floor(y + 0.5), 0, 255).reshape(n, nbh * bh, nbw * bw)
    rows, cols = min(nbh * bh, out_hw[0]), min(nbw * bw, out_hw[1])
    out = np.zeros((n,) + tuple(out_hw))
    out[:, :rows, :cols] = y[:, :rows, :cols]
    return out


def _motion_phase(torch, dev, plain_versions, int8mm, block_filter, fft) -> dict:
    """Main path 2: the motion CLI at 1080p 4:2:0; returns its launches."""
    from dspfun_tpu_torch.io import video
    from dspfun_tpu_torch.models import motion_pipeline as mp
    from dspfun_tpu_torch.tools import motion

    nslabs = MFRAMES // 16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_motion_") as tmp:
        clip, out, out_plain = (os.path.join(tmp, n) for n in
                                ("clip.y4m", "out.y4m", "plain.y4m"))
        src = _write_clip(video, clip)

        def run(dst, extra=()):
            t0 = time.perf_counter()
            rc = motion.main(MOTION_ARGS + list(extra) + [clip, dst])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"motion CLI exited {rc}")
            return wall, dict(motion.LAST_STAGE_TIMES)

        int8mm.LAUNCHES.clear()
        block_filter.LAUNCHES.clear()
        cold, _ = run(out)
        launches = {**int8mm.LAUNCHES, **block_filter.LAUNCHES}
        print(f"motion main-path launches: {json.dumps(launches)} ({nslabs} slabs, "
              f"{cold:.3f} s cold)", flush=True)
        expect = {"right3": 2 * nslabs, "block_filter": 2 * nslabs}
        if {n: c for n, c in launches.items() if c} != expect:
            raise RuntimeError(f"motion launches {launches}, expected {expect}")
        if mp.LAST_FAST_PATH != "cuda-kron":
            raise RuntimeError(f"motion chroma took {mp.LAST_FAST_PATH}, not cuda-kron")

        header, got = _read_y4m(out, MFRAMES)
        print(f"motion output header: {header}", flush=True)
        # the 16-row block grid keeps 1072 of the 1080 rows
        if got[0].shape[1:] != (MH // 16 * 16, MW):
            raise RuntimeError(f"motion output plane 0 is {got[0].shape[1:]}")
        total = off = 0
        for i, (frames, plane) in enumerate(zip(src, got)):
            block, box = ((16, 16, 16), (4, 8, 8)) if i == 0 else ((16, 8, 8), (4, 4, 4))
            oracle = _motion_oracle(frames, block, box, plane.shape[1:], fft)
            diff = np.abs(plane.astype(np.float64) - oracle)
            total += diff.size
            off += int((diff > 0).sum())
            print(f"motion plane {i} {plane.shape}: max |pel - f64 oracle| "
                  f"{diff.max():.0f}, off by one {np.mean(diff > 0):.6f}", flush=True)
            if diff.max() > 1:
                raise RuntimeError(f"motion plane {i}: a pel is {diff.max()} levels "
                                   "from the float64 oracle")
        print(f"motion output vs float64: every pel within one level, "
              f"{off / total:.6f} off by one", flush=True)

        with plain_versions():
            run(out_plain)                      # warm the plain path's allocations
        warm_s, warm_stages = run(out)
        b2_s, b2_stages = run(out_plain, ("--slab-batch", "2"))
        _, got_b2 = _read_y4m(out_plain, MFRAMES)
        if not all(np.array_equal(a, b) for a, b in zip(got, got_b2)):
            raise RuntimeError("motion --slab-batch 2 output differs from batch 1")
        with plain_versions():
            plain_s, plain_stages = run(out_plain)
        _, got_plain = _read_y4m(out_plain, MFRAMES)
        ndiff = sum(int((a != b).sum()) for a, b in zip(got, got_plain))
        print(f"motion CLI 1080p 4:2:0, {MFRAMES} frames: {MFRAMES / warm_s:.2f} frames/s "
              f"with the kernels ({warm_s:.3f} s; stages {json.dumps(warm_stages)}), "
              f"{MFRAMES / plain_s:.2f} frames/s plain ({plain_s:.3f} s; stages "
              f"{json.dumps(plain_stages)}); {ndiff} pels differ kernel vs plain; "
              f"--slab-batch 2 {MFRAMES / b2_s:.2f} frames/s ({b2_s:.3f} s, same output)",
              flush=True)

    # slab time per plane (filter_blocks alone, blocks already on the card)
    geoms = mp.plan_geometry(MW, MH, MFRAMES, 3, 1, 1, block=mp.Dims(16, 16, 16),
                             bp_end=mp.Dims(8, 8, 4))
    params = mp.MotionParams(boost=1.25, damp=0.0, float_pixels=False)
    for i in (0, 1):
        g = geoms[i]
        plans = (*mp.make_plans(g, device=dev), mp.maybe_kron_plans(g, params, device=dev))
        blocks = torch.from_numpy(np.ascontiguousarray(
            mp.frames_to_blocks(src[i][:16], g))).to(dev)

        def slab(b=blocks, g=g, plans=plans, i=i):
            return mp.filter_blocks(b, plans, None, None, g, params, i, 3)

        ms = cuda_ms(slab)
        path = mp.LAST_FAST_PATH
        with plain_versions():
            plain_ms = cuda_ms(slab)
        print(f"motion slab plane {i} ({path}, NB={blocks.shape[0]}): {ms:.4f} ms "
              f"kernel, {plain_ms:.4f} ms plain", flush=True)
        if i == 0:
            sweep = {}
            for bsz in (1, 2, 4):
                big = blocks.repeat(bsz, 1, 1, 1)
                sweep[bsz] = cuda_ms(lambda: slab(big)) / bsz
            print("motion luma slab batch sweep (ms per slab): "
                  + ", ".join(f"B={b} {t:.4f}" for b, t in sweep.items()), flush=True)
    return launches


def _calib_phase(torch, dev, mma) -> dict:
    """Main path 3: the calibration counterparts on the card; returns the
    split kernel's launches, the int8 digit kernels' launches (calib_r3f's
    split + int8mm route) and per-instance stats."""
    from dspfun_tpu_torch import _build
    from dspfun_tpu_torch.benchmarks import calib_r3e, calib_r3f
    from dspfun_tpu_torch.ops import int8mm, int8split

    for line in _ptxas_lines(_build.build_log(), "int8split.cu"):
        print(f"ptxas int8split.cu {line}", flush=True)
    _check_mma(mma, "i8split_kernel",
               sum(len(tiles) for tiles in int8split.COMPILED_TILES.values()))

    int8split.LAUNCHES.clear()
    before = dict(int8mm.LAUNCHES)
    probes = calib_r3e.run_probes(dev)
    rows = calib_r3f.run(dev)
    torch.cuda.synchronize()
    launches = {n: int8split.LAUNCHES[n] for n in I8S_REPLACES}
    i8mm_launches = {n: int8mm.LAUNCHES[n] - before.get(n, 0) for n in REPLACES}
    print(f"calibration main-path launches: {json.dumps(launches)}, "
          f"int8mm {json.dumps(i8mm_launches)}", flush=True)
    if not i8mm_launches["left3"]:
        raise RuntimeError(f"calib_r3f's split + int8mm route never launched left3: "
                           f"{i8mm_launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a split-kernel instance never launched: {launches}")

    stats = {}
    a8, xf = calib_r3e.probe_inputs()
    a, x = torch.tensor(a8, device=dev), torch.tensor(xf, device=dev)
    for probe, (planes, inst) in calib_r3e.PROBES.items():
        ap = torch.stack([a] * planes)
        ref = int8split._i8_split_plain(ap, x, **inst)
        torch.cuda.synchronize()
        if not torch.equal(probes[probe], ref):
            err = float((probes[probe] - ref).abs().max())
            raise RuntimeError(f"probe {probe}: kernel != plain (max abs diff {err})")
        ms = cuda_ms(lambda: int8split._i8_split_cuda(ap, x, **inst))
        plain_ms = cuda_ms(lambda: int8split._i8_split_plain(ap, x, **inst))
        name = int8split.INSTANCES[(inst["xdigits"], inst["groups"], inst["scale"])]
        m, k, r = calib_r3e.M, calib_r3e.K, calib_r3e.R
        bound_ms, bound_by = _bound(2.0 * m * k * r * _pairs(planes, inst["xdigits"]),
                                    INT8_OPS, ap.numel() + 4 * k * r + 4 * m * r)
        print(f"probe {probe} ({name}) M={m} K={k} R={r}: equal, {ms:.4f} ms kernel, "
              f"{plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.2f} % of bound; library none (a launch-bound probe)",
              flush=True)
        stats.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    by_route = {row["route"]: row for row in rows}
    plain, route1 = by_route["plain"]["out"], by_route["split + int8mm"]["out"]
    for row in rows:
        same = torch.equal(row["out"], plain) and torch.equal(row["out"], route1)
        print(f"calib_r3f K={calib_r3f.K} M={calib_r3f.M} R={calib_r3f.R} {row['route']}: "
              f"rel={row['rel']:.3e} {row['ms']:.4f} ms {row['tops']:.2f} eff-TOPS(int8), "
              f"== plain and == split + int8mm: {same}", flush=True)
        if not (same and row["rel"] <= CALIB_TOL):
            raise RuntimeError(f"calib_r3f {row['route']} failed (rel {row['rel']})")
    fused = [row for row in rows if row["route"].startswith("fused")]
    default = fused[int8split.COMPILED_TILES["exp3g3"].index(int8split.DEFAULT_TILE)]
    # kernel #5's yardstick: torch._int_mm on the digits split beforehand
    a, _, x, _ = calib_r3f.inputs(device=dev)
    xd, _ = int8mm._split_operand(x.reshape(1, *x.shape), 1)
    lib_ms, note = _int_mm_library(torch, a, xd, "left", int8mm._W,
                                   int8mm._i8_groups_plain(a, xd, "left"))
    m, k, r = calib_r3f.M, calib_r3f.K, calib_r3f.R
    bound_ms, bound_by = _bound(2.0 * m * k * r * _pairs(3, 3), INT8_OPS,
                                a.numel() + 4 * k * r + 4 * m * r)
    print(f"calib_r3f fused (default tile) {default['ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / default['ms']:.1f} % of bound; library "
          + (f"{lib_ms:.4f} ms ({note})" if lib_ms else note), flush=True)
    del a, x, xd
    stats["exp3g3"] = {"max_abs_err": 0.0, "ms": default["ms"],
                       "plain_ms": by_route["plain"]["ms"],
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                       "split_then_int8mm_ms": by_route["split + int8mm"]["ms"],
                       "sweep_ms": {row["route"]: row["ms"] for row in fused}}
    return {"launches": launches, "i8mm_launches": i8mm_launches, "stats": stats}


def _png_codec_checks(png, hw) -> None:
    """The PNG codec alone: every filter at both depths reads back equal
    at a small size; then, at ``hw`` in 8-bit RGB, the seconds to encode
    and to decode per filter (None = the filter chosen per row)."""
    rng = np.random.default_rng(2)
    y, x = np.mgrid[0:48, 0:64]
    for dtype, top in ((np.uint8, 255), (np.uint16, 65535)):
        a = np.stack([(0.5 + 0.4 * np.sin(x / (7.0 + i) + y / 11.0)) * top * 0.9
                      for i in range(3)], -1) + rng.integers(0, top // 40, (48, 64, 3))
        a = a.astype(dtype)
        for ftype in (None, 0, 1, 2, 3, 4):
            back, props, _ = png.decode_png(png.encode_png(a, {"k": "v"}, ftype))
            if not (np.array_equal(back, a) and back.dtype == dtype and props == {"k": "v"}):
                raise RuntimeError(f"PNG round trip failed: {dtype.__name__} filter {ftype}")
    print("png codec: filters None, 0-4 at 8 and 16 bits read back equal (64x48 RGB)",
          flush=True)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(0.5 + 0.4 * np.sin(x / (70.0 + i) + y / 110.0)) * 229.0
                  for i in range(3)], -1) + rng.integers(0, 6, (h, w, 3))
    a = a.astype(np.uint8)
    for ftype in (None, 0, 1, 2, 3, 4):
        t0 = time.perf_counter()
        data = png.encode_png(a, None, ftype)
        t1 = time.perf_counter()
        back = png.decode_png(data)[0]
        t2 = time.perf_counter()
        if not np.array_equal(back, a):
            raise RuntimeError(f"PNG round trip at {w}x{h} failed: filter {ftype}")
        print(f"png codec {w}x{h} 8-bit RGB filter {ftype}: encode {t1 - t0:.3f} s, "
              f"decode {t2 - t1:.3f} s (host), {len(data)} bytes", flush=True)


def _ulps(torch, a, b):
    """Distance between two float32 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _fp64_beside_exact(torch, dev, hw) -> None:
    """A float64 contraction rounded to float32 beside ``core/exact.py``'s
    digit contraction, at the two shapes spec's default policy runs."""
    from dspfun_tpu_torch.core.basis import dct2_matrix
    from dspfun_tpu_torch.core.precision import Precision
    from dspfun_tpu_torch.core.transforms import apply_plan, plan_axis

    exact = Precision(intermediate="exact")
    h, w = hw
    x = torch.rand((h, w, C), generator=torch.Generator(device=dev).manual_seed(8),
                   device=dev)
    for axis, n in ((0, h), (1, w)):
        plan = plan_axis(n, "dct2", exact, dev)
        m64 = torch.tensor(dct2_matrix(n), dtype=torch.float64, device=dev)

        def by_digits():
            return apply_plan(x, plan, axis, exact)

        def by_fp64():
            y = torch.tensordot(m64, x.double(), dims=([1], [axis]))
            return y.movedim(0, axis).float()

        ye, y64 = by_digits(), by_fp64()
        d = _ulps(torch, ye, y64)
        rel = float((ye - y64).abs().max() / ye.abs().max())
        print(f"fp64 beside exact, DCT-II along axis {axis} of [{h}, {w}, {C}] (K={n}): "
              f"exact {cuda_ms(by_digits):.3f} ms, fp64 rounded to float32 "
              f"{cuda_ms(by_fp64):.3f} ms; largest distance {int(d.max())} ulp, "
              f"{int((d > 0).sum())} of {d.numel()} outputs differ, "
              f"{int((d > 1).sum())} by more than 1 ulp; max abs diff "
              f"{rel:.3e} of the largest output", flush=True)
        del ye, y64, d, m64
    del x
    torch.cuda.empty_cache()


def _spec_cli_phase(torch, dev, plain_versions, int8mm, fft, hw=(H, W)) -> dict:
    """Main path 4: spec then ispec through 16-bit PNG files; returns the
    int8 kernels' launches over the i8@1e-5 run."""
    from dspfun_tpu_torch.core import precision as prec
    from dspfun_tpu_torch.io import images, png
    from dspfun_tpu_torch.tools import ispec, spec

    h, w = hw
    _png_codec_checks(png, hw)

    @contextlib.contextmanager
    def policy(name):
        """The tools' own default policy (None) or a named one."""
        saved = (prec._default, prec._explicit)
        if name is None:
            prec._explicit = False
        else:
            prec.set_precision(prec.Precision.parse(name))
        try:
            yield
        finally:
            prec._default, prec._explicit = saved

    def levels(path):
        arr, props, _ = png.decode_png(open(path, "rb").read())
        if arr.dtype != np.uint16 or arr.shape != (h, w, C):
            raise RuntimeError(f"{path}: {arr.dtype} {arr.shape}")
        return arr.astype(np.int64), props

    def tool(main, mod, args, expect):
        if expect:      # the counts start at 0 for a run that must launch
            int8mm.LAUNCHES.clear()
        before = dict(int8mm.LAUNCHES)
        t0 = time.perf_counter()
        rc = main(args)
        wall = time.perf_counter() - t0
        got = {n: c - before.get(n, 0) for n, c in int8mm.LAUNCHES.items()
               if c - before.get(n, 0)}
        if rc != 0:
            raise RuntimeError(f"{mod.__name__.rsplit('.', 1)[-1]} {args} exited {rc}")
        if got != expect:
            raise RuntimeError(f"{mod.__name__} launched {got}, expected {expect}")
        return wall, dict(mod.LAST_STAGE_TIMES), got

    def round_trip(tmp, tag, template, expect):
        s, b = (os.path.join(tmp, f"{n}_{template}_{tag.replace(' ', '_')}.png")
                for n in ("spec", "back"))
        runs = [tool(spec.main, spec, ["-t", template, src, s], expect),
                tool(ispec.main, ispec, ["-t", template, s, b], expect)]
        for name, (wall, stages, got) in zip(("spec", "ispec"), runs):
            stages = {k: round(v, 4) for k, v in stages.items()}
            print(f"{name} -t {template} ({tag}) {w}x{h}: {wall:.3f} s wall; stages (s) "
                  f"{json.dumps(stages)}; launches {json.dumps(got)}", flush=True)
        return s, b, [r[2] for r in runs]

    scale = [np.where(np.arange(n) > 0, np.sqrt(2.0), 1.0) for n in (h, w)]
    grid = scale[0][:, None, None] * scale[1][None, :, None]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spec_") as tmp:
        src = os.path.join(tmp, "in.png")
        rng = np.random.default_rng(7)
        y, x = np.mgrid[0:h, 0:w]
        pix = np.stack([0.5 + 0.2 * np.sin(x / (190.0 + 30 * i) + y / 130.0)
                        for i in range(C)], -1)
        pix += 0.2 * (rng.random((h, w, C)) - 0.5)            # within [0.2, 0.8]
        t0 = time.perf_counter()
        images.write_image(src, pix, depth=16)
        print(f"input {w}x{h} RGB 16-bit PNG: written in {time.perf_counter() - t0:.3f} s, "
              f"{os.path.getsize(src)} bytes", flush=True)
        del pix, x, y
        lv_in, _ = levels(src)
        # what the tools compute on: the float32 of the file's levels
        x32 = (lv_in / 65535.0).astype(np.float32).astype(np.float64)
        uniform = fft.dctn(x32, type=2, axes=(0, 1), workers=-1) * grid / (4.0 * w * h)
        means = x32.mean(axis=(0, 1))
        del x32

        def check_spectrum(path, template):
            """The file against the float64 chain of the reference
            (spec.c:63-139; flat and copy: linear scale, range one)."""
            lv, props = levels(path)
            f = (uniform / 2 + 0.5) * 254 / 255 if template == "flat" else uniform
            diff = np.abs(lv - np.rint(np.clip(f, 0, 1) * 65535).astype(np.int64))
            dc = images.decode_dc_property(props["DC"], C)
            dc_err = float(np.max(np.abs(dc - means)))
            print(f"spec -t {template} file vs float64 oracle: largest difference "
                  f"{int(diff.max())} level, {float((diff > 0).mean()):.6f} of the pels off "
                  f"by one; DC vs channel means {dc_err:.3e}", flush=True)
            if diff.max() > 1 or not dc_err <= 1e-6:
                raise RuntimeError(f"spec -t {template}: the file disagrees with the oracle")
            return lv

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with policy(None):
            s_flat, b_flat, _ = round_trip(tmp, "default", "flat", {})
            peak = torch.cuda.max_memory_allocated()
            s_copy, b_copy, _ = round_trip(tmp, "default", "copy", {})
        print(f"peak device memory over spec + ispec -t flat at the default policy "
              f"(hilo -> exact): {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB held before)", flush=True)

        check_spectrum(s_flat, "flat")
        back, _ = levels(b_flat)
        d = back - lv_in
        sigma = FLAT_FILE_NOISE * np.sqrt(h * w)
        rms, worst = float(np.sqrt(np.mean(d * d.astype(np.float64)))), int(np.abs(d).max())
        print(f"spec -> ispec -t flat through 16-bit files: back vs input {rms:.1f} levels "
              f"rms (the spectrum's quantisation leaves {sigma:.1f}), largest {worst} "
              f"(limit {7 * sigma:.0f})", flush=True)
        if abs(rms / sigma - 1) > 0.05 or worst > 7 * sigma:
            raise RuntimeError("spec -> ispec -t flat: outside the file format's noise")

        lv = check_spectrum(s_copy, "copy")
        coeff = lv / 65535.0 / grid * (4.0 * w * h)
        oracle = fft.dctn(coeff, type=3, axes=(0, 1), workers=-1) / (4.0 * w * h)
        back, _ = levels(b_copy)
        diff = np.abs(back - np.rint(np.clip(oracle, 0, 1) * 65535).astype(np.int64))
        print(f"ispec -t copy file vs a float64 inverse of the spectrum file "
              f"({float((lv == 0).mean()):.3f} of its coefficients clipped at 0): largest "
              f"difference {int(diff.max())} level, {float((diff > 0).mean()):.6f} off by one",
              flush=True)
        if diff.max() > 1:
            raise RuntimeError("ispec -t copy: the file disagrees with the oracle")
        del coeff, oracle, back, diff, lv, d

        with policy("i8@1e-5"):
            s_i8, b_i8, counts = round_trip(tmp, "i8@1e-5", "flat", SPEC_CLI_EXPECT)
            with plain_versions():
                s_pl, b_pl, _ = round_trip(tmp, "i8@1e-5 plain", "flat", {})
        same = [open(a, "rb").read() == open(b, "rb").read()
                for a, b in ((s_i8, s_pl), (b_i8, b_pl))]
        check_spectrum(s_i8, "flat")
        print(f"spec, ispec -t flat at i8@1e-5: files byte-equal kernel vs plain: {same}",
              flush=True)
        if not all(same):
            raise RuntimeError("spec/ispec at i8@1e-5: kernel and plain files differ")
    launches = {n: sum(c.get(n, 0) for c in counts) for n in REPLACES}
    print(f"spec CLI main-path launches: {json.dumps(launches)}", flush=True)
    _fp64_beside_exact(torch, dev, hw)
    return launches


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
    from dspfun_tpu_torch.ops import block_filter, int8mm

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
    def plain_versions():
        """Route both kernels through their plain versions on the card
        (the comparison baseline); no kernel may launch inside."""
        saved = (int8mm._i8_groups, block_filter._block_filter)
        before = sum(int8mm.LAUNCHES.values()) + sum(block_filter.LAUNCHES.values())
        int8mm._i8_groups = int8mm._i8_groups_plain
        block_filter._block_filter = (lambda *a, split=None:
                                      block_filter._block_filter_plain(*a))
        try:
            yield
        finally:
            int8mm._i8_groups, block_filter._block_filter = saved
        if sum(int8mm.LAUNCHES.values()) + sum(block_filter.LAUNCHES.values()) != before:
            raise RuntimeError("a kernel launched while the plain versions were forced")

    # ---- phase 3: each kernel against its plain version -----------------
    for src in ("int8mm.cu", "block_filter.cu"):
        for line in _ptxas_lines(_build.build_log(), src):
            print(f"ptxas {src} {line}", flush=True)
    mma = _sass_mma_counts(str(_build.library_path()))
    _check_mma(mma, "i8mm_kernel", len(REPLACES))
    _check_mma(mma, "block_filter_kernel", 1)

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {name: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "bound_ms": 0.0,
                    "bound_by": {}, "library_ms": 0.0, "by_shape": {}}
             for name in REPLACES}

    def check_i8mm(nd, layout, m, k, b, r, what):
        """One int8 kernel shape: bit-equal to the plain version, timed
        beside its bound, the plain version and torch._int_mm."""
        kp = int8mm.ceil_to(k, 128)
        a = torch.randint(-64, 65, (nd, m, kp), generator=gen, device=dev, dtype=torch.int8)
        a[:, :, k:] = 0  # the plan's zero padding of K
        xshape = (nd, b, k, r) if layout == "left" else (nd, b, r, k)
        x = torch.randint(-64, 65, xshape, generator=gen, device=dev, dtype=torch.int8)
        name = f"{layout}{nd}"
        y = int8mm._i8_groups_cuda(a, x, layout)
        ref = int8mm._i8_groups_plain(a, x, layout)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        if not torch.equal(y, ref):
            raise RuntimeError(f"{name} {what} M={m} K={k} B={b} R={r}: "
                               f"kernel != plain (max abs diff {err})")
        ms = cuda_ms(lambda: int8mm._i8_groups_cuda(a, x, layout))
        plain_ms = cuda_ms(lambda: int8mm._i8_groups_plain(a, x, layout))
        bound_ms, bound_by = _i8_bound(a, x, layout)
        lib_ms, note = _int_mm_library(torch, a, x, layout, int8mm._W, ref)
        lib = (f"library {lib_ms:.4f} ms ({note}), kernel/library {ms / lib_ms:.3f}"
               if lib_ms else f"library {note}")
        print(f"kernel {name} {what:10s} M={m} K={k} B={b} R={r}: equal, {ms:.4f} ms kernel, "
              f"{plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f} % of bound; {lib}", flush=True)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["by_shape"][what] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": lib_ms}
        return ms, plain_ms, bound_ms, bound_by, lib_ms

    def add(st, ms, plain_ms, bound_ms, bound_by, lib_ms):
        st["ms"] += ms
        st["plain_ms"] += plain_ms
        st["bound_ms"] += bound_ms
        st["bound_by"][bound_by] = st["bound_by"].get(bound_by, 0.0) + bound_ms
        st["library_ms"] = None if lib_ms is None or st["library_ms"] is None \
            else st["library_ms"] + lib_ms

    for nd in (3, 4):
        for layout, m, k, b, r, what in KERNEL_SHAPES:
            res = check_i8mm(nd, layout, m, k, b, r, what)
            if what != "ragged":
                add(stats[f"{layout}{nd}"], *res)
    motion_i8 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
                 "library_ms": 0.0}
    for m, k, r, what in MOTION_I8_SHAPES:
        add(motion_i8, *check_i8mm(3, "right", m, k, 1, r, what))
    for st in (*stats.values(), motion_i8):     # the kind that bounds most of the sum
        st["bound_by"] = max(st["bound_by"], key=st["bound_by"].get)
    torch.cuda.empty_cache()
    bf_stats = _check_block_filter(torch, dev, block_filter, scipy.fft)
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
        with plain_versions():
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
    with plain_versions():
        back_plain = spec_round_trip(bench)
    err = float((back_i8 - x).abs().max())
    same = torch.equal(back_i8, back_plain)
    print(f"spec flat round trip i8@1e-5: max abs err {err:.3e}, "
          f"kernel == plain: {same}", flush=True)
    if not (err <= floor and same):
        raise RuntimeError("spec flat round trip at i8@1e-5 failed")
    del back_exact, back_i8, back_plain

    # ---- phase 5: chain throughput, kernel vs plain, and where it goes ---
    for p, label in ((bench, "i8@1e-5"), (deep, "i8")):
        ms = cuda_ms(lambda p=p: chain(p))
        with plain_versions():
            plain_ms = cuda_ms(lambda p=p: chain(p))
        print(f"4K fused chain {label}: {H * W / ms / 1e3:.2f} MP/s kernel "
              f"({ms:.3f} ms), {H * W / plain_ms / 1e3:.2f} MP/s plain "
              f"({plain_ms:.3f} ms)", flush=True)
    _profile_chain(torch, lambda: chain(bench), "4K fused chain i8@1e-5")

    # ---- phase 6: main path 2, the motion CLI, launches counted --------
    motion_launches = _motion_phase(torch, dev, plain_versions, int8mm, block_filter,
                                     scipy.fft)

    # ---- phase 7: main path 3, the calibration of the in-kernel split ---
    calib = _calib_phase(torch, dev, mma)

    # ---- phase 8: main path 4, spec -> ispec through files --------------
    del x, mask, plans, y, x_np, ref, mask_np
    torch.cuda.empty_cache()
    # the 3-digit kernels against their plain versions at this path's shapes
    # (here, not in phase 3, so that the earlier paths run as they did)
    spec_i8 = {}
    for layout, m, k, b, r, what in SPEC_I8_SHAPES:
        spec_i8[f"{layout}3"] = dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
            check_i8mm(3, layout, m, k, b, r, what)))
    torch.cuda.empty_cache()
    spec_cli = _spec_cli_phase(torch, dev, plain_versions, int8mm, scipy.fft)

    kernels = [{"name": f"i8mm_{n}", "route": "cuda", "source": SRC,
                "replaces": REPLACES[n],
                "launches": (launches[n] + motion_launches.get(n, 0)
                             + calib["i8mm_launches"][n] + spec_cli[n]),
                "launches_by_path": {"4k_chain": launches[n],
                                     "motion": motion_launches.get(n, 0),
                                     "calibration": calib["i8mm_launches"][n],
                                     "spec_cli": spec_cli[n]},
                **{key: stats[n][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms", "by_shape")}}
               for n in REPLACES]
    kernels[list(REPLACES).index("right3")].update(
        {f"motion_{key}": val for key, val in motion_i8.items()})
    for n, st in spec_i8.items():
        kernels[list(REPLACES).index(n)].update(
            {f"spec_cli_{key}": val for key, val in st.items()})
    kernels.append({"name": "block_filter", "route": "cuda", "source": BF_SRC,
                    "replaces": BF_REPLACES,
                    "launches": motion_launches["block_filter"],
                    "launches_by_path": {"motion": motion_launches["block_filter"]},
                    **bf_stats})
    kernels += [{"name": f"i8split_{n}", "route": "cuda", "source": I8S_SRC,
                 "replaces": I8S_REPLACES[n], "launches": calib["launches"][n],
                 "launches_by_path": {"calibration": calib["launches"][n]},
                 **calib["stats"][n]} for n in I8S_REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
