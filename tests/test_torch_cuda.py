"""The port on a CUDA card: the hand-written kernels (int8 digit
contraction, fused Kronecker block filter, int8 contraction with the
in-kernel digit split) against their plain versions,
and the card's chains, motion's filter_blocks, apply_basis and the motion, spec, ispec,
scan, zoom and draw CLIs against the CPU's and a float64 oracle; motion's
``--eval`` (stateless and stateful) against the CPU's, and the host
libraries (libdspio, libffv1) built and run on the card's machine.

Every test here needs a card and skips without one.  The machine with the
card has no JAX, so this file imports none; run it there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the int8 kernels are bit-equal to their plain versions (integer
group sums are exact, the weights are powers of two); a contraction on
the card is bit-equal to the same one on the CPU (every step is exact or
a single IEEE rounding in the same order); chains hold 1e-5 against
float64.  The block filter (split TF32 on the tensor cores) and motion's
float32 paths agree with their plain versions to float32-level error,
not bit for bit; their tolerances are stated per test.
"""

import numpy as np
import pytest
import scipy.fft
import torch

from dspfun_tpu_torch.core.basis import dct2_matrix, dct3_matrix
from dspfun_tpu_torch.core.exact import exact_contract, split_matrix_digits
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.models import fused
from dspfun_tpu_torch.models import motion_pipeline as tmp
from dspfun_tpu_torch.models.spec_pipeline import (
    SpecChainParams, spec_forward, spec_inverse,
)
from dspfun_tpu_torch.ops import block_filter as tbf
from dspfun_tpu_torch.ops import int8mm as tmm
from dspfun_tpu_torch.ops import int8split as tsp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 kernel has no CPU mode")
    return torch.device("cuda")


def _digits(gen, shape, device):
    return torch.randint(-64, 65, shape, generator=gen, device=device, dtype=torch.int8)


@pytest.mark.parametrize("ndig", [3, 4])
@pytest.mark.parametrize("layout,m,k,b,r", [
    # the main paths' shapes at a reduced R: 4K fwd H, inv H, fwd W, inv W,
    # motion's luma pair
    ("left", 540, 2160, 3, 384), ("left", 2160, 540, 3, 96),
    ("right", 960, 3840, 1, 162), ("right", 3840, 960, 1, 648),
    ("right", 256, 4096, 1, 804), ("right", 4096, 256, 1, 804),
    # ragged: M, K and R off every tile multiple; K off 16 (8, 300), off
    # 32 (48, 80) and off 64 and 128 (96, 200); M < 64; R = 1 with B > 1
    ("left", 77, 300, 2, 45), ("right", 77, 300, 2, 45),
    ("left", 5, 1, 1, 3), ("right", 64, 32, 1, 64), ("right", 40, 8, 2, 70),
    ("left", 40, 48, 3, 1), ("right", 40, 48, 3, 1), ("right", 130, 80, 2, 129),
    ("left", 130, 96, 2, 129), ("right", 63, 200, 1, 65), ("left", 129, 200, 1, 65),
])
def test_kernel_bit_equal_to_plain(cuda, ndig, layout, m, k, b, r):
    """Every path of the wrapper and the kernel: x read in place (right
    layout, K a multiple of 16) or through the staging pass (left layout,
    ragged K), one or many k-stages, edge tiles in M and R.  A's padding
    past K holds digits, which the kernel must never add in."""
    g = torch.Generator(device=cuda).manual_seed(ndig * 1000 + m + k)
    kp = tmm.ceil_to(k, 128)
    a = _digits(g, (ndig, m, kp), cuda)
    x = _digits(g, (ndig, b, k, r) if layout == "left" else (ndig, b, r, k), cuda)
    before = tmm.LAUNCHES[f"{layout}{ndig}"]
    y = tmm._i8_groups(a, x, layout)
    assert tmm.LAUNCHES[f"{layout}{ndig}"] == before + 1
    ref = tmm._i8_groups_plain(a, x, layout)
    torch.cuda.synchronize()
    assert torch.equal(y, ref)


@pytest.mark.parametrize("ndig", [3, 4])
@pytest.mark.parametrize("layout", ["left", "right"])
def test_kernel_exact_at_the_int32_bound(cuda, ndig, layout):
    """The card twin of tests/test_torch_int8mm.py's plain-version test:
    every digit at +-64 and K = _kmax, so the heaviest group sum sits just
    under 2^31.  A saturating or wrapping accumulator, or a float combine
    of partial sums, would differ from the plain version here."""
    k = tmm._kmax(ndig)
    a = torch.full((ndig, 2, tmm.ceil_to(k, 128)), 64, dtype=torch.int8)
    a[:, 1, ::2] = -64
    a[:, :, k:] = 0
    x = torch.full((ndig, 1, k, 3), 64, dtype=torch.int8)
    x[:, :, 1::3, 2] = -64
    if layout == "right":
        x = x.transpose(2, 3).contiguous()
    ref = tmm._i8_groups_plain(a, x, layout)
    y = tmm._i8_groups(a.to(cuda), x.to(cuda), layout)
    torch.cuda.synchronize()
    # row 0 against slice 0: the heaviest group's ndig dots of K products 64 * 64
    assert 2**31 - ndig * 64 * 64 <= ndig * k * 64 * 64 < 2**31
    assert torch.equal(y.cpu(), ref)


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    a = torch.zeros((3, 8, 128), dtype=torch.int8, device=cuda)
    x = torch.zeros((3, 1, 128, 4), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tmm._i8_groups(a, x.transpose(2, 3), "right")
    with pytest.raises(TypeError, match="int8"):
        tmm._i8_groups(a, x.float(), "left")
    with pytest.raises(ValueError, match="padded length"):
        tmm._i8_groups(a, torch.zeros((3, 1, 129, 4), dtype=torch.int8, device=cuda),
                       "left")
    with pytest.raises(ValueError, match="CUDA device"):
        tmm._i8_groups(a.cpu(), x, "left")
    with pytest.raises(ValueError, match="digit planes"):
        tmm._i8_groups(a, x[:2].contiguous(), "left")
    shifted = torch.zeros(3 * 8 * 128 + 1, dtype=torch.int8, device=cuda)[1:].view(3, 8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tmm._i8_groups(shifted, x, "left")


@pytest.mark.parametrize("ndig", [3, 4])
@pytest.mark.parametrize("axis,shape", [(0, (300, 70)), (1, (3, 300, 70)),
                                        (2, (3, 50, 300)), (1, (2, 300, 5, 7))])
def test_i8_contract_card_equals_cpu(cuda, ndig, axis, shape):
    digits, scale = tmm.split_matrix_i8(dct2_matrix(shape[axis]), ndig)
    x = torch.from_numpy(np.random.default_rng(8).random(shape).astype(np.float32))
    d, s = torch.from_numpy(digits), torch.from_numpy(scale)
    y_cpu = tmm.i8_contract(x, d, s, axis)
    y_gpu = tmm.i8_contract(x.to(cuda), d.to(cuda), s.to(cuda), axis)
    assert torch.equal(y_gpu.cpu(), y_cpu)


@pytest.mark.parametrize("tol", [None, 1e-5])
def test_exact_contract_card_equals_cpu(cuda, tol):
    m = dct3_matrix(300)
    digits, scale = split_matrix_digits(m, tol=tol)
    x = torch.from_numpy(np.random.default_rng(3).random((7, 300, 3)).astype(np.float32))
    y_cpu = exact_contract(x, digits, scale, 1, tol=tol)
    y_gpu = exact_contract(x.to(cuda), digits.to(cuda), scale, 1, tol=tol)
    assert torch.equal(y_gpu.cpu(), y_cpu)


@pytest.mark.parametrize("spec", ["i8@1e-5", "i8", "exact", "hilo", "f32"])
def test_fused_filter_2d_on_card(cuda, spec):
    h, w = 256, 384
    x = np.random.default_rng(3).random((h, w, 3)).astype(np.float32)
    mask = fused.lowpass_mask((h, w), cutoff=0.5, boost=1.25)[:, :, None].astype(np.float32)
    ref = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(0, 1)) * mask
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1)) / (4.0 * w * h)
    p = Precision.parse(spec)
    plans = fused.filter_plans((h, w), p, mask=mask, device=cuda)
    before = sum(tmm.LAUNCHES.values())
    y = fused.fused_filter_2d(torch.from_numpy(x).to(cuda), torch.from_numpy(mask).to(cuda),
                              plans, p)
    torch.cuda.synchronize()
    # i8: the forward contractions (K = 256, 384) take the kernel; the
    # pruned inverse ones (K = 128, 192) take the small-K float32 matmul
    assert sum(tmm.LAUNCHES.values()) == before + (2 if p.intermediate == "i8" else 0)
    assert np.max(np.abs(y.cpu().numpy().astype(np.float64) - ref)) <= 1e-5


def test_spec_round_trip_on_card(cuda):
    x = np.random.default_rng(5).random((256, 384, 3)).astype(np.float32)
    params = SpecChainParams.template("copy", 1000.0)
    for p in (Precision(), Precision(intermediate="i8")):
        f, dc = spec_forward(torch.from_numpy(x).to(cuda), params, p)
        f_cpu, _ = spec_forward(torch.from_numpy(x), params, p)
        assert np.max(np.abs(f.cpu().numpy() - f_cpu.numpy())) <= 1e-6
        assert np.max(np.abs(dc.cpu().numpy() - x.mean(axis=(0, 1), dtype=np.float64))) <= 1e-6
        back = spec_inverse(f, params, precision=p)
        assert np.max(np.abs(back.cpu().numpy() - x)) <= 1e-5


# ---- the fused Kronecker block filter (csrc/block_filter.cu) and motion ----


def _uf(dims):
    s = [np.where(np.arange(n) > 0, 1.0, np.sqrt(2.0)) for n in dims]
    return 2.0 * np.sqrt(2.0) / (s[0][:, None, None] * s[1][None, :, None]
                                 * s[2][None, None, :])


# chip_smoke.py's three shapes, scaled down in NB: the 1080p chroma slab
# (bandpass), the half-thresholded 8^3 luma shape, the ragged quant shape;
# then a V off every tile multiple and a V of 1.  The blocks each case's
# band left out on an H100 80GB HBM3 at 700 W (the test prints them, run
# with -s): 0 of 804,
# 272 of 3240, 3 of 37, 11 of 70, 0 of 5; the limits are a quarter above
# those readings plus 2 blocks.  A bandpass case has no boundary.
_BF_MAX_EXCLUDED = {804: 2, 3240: 342, 37: 6, 70: 16, 5: 2}


@pytest.mark.parametrize("nb,dims,mode", [
    (804, (16, 8, 8), "bandpass"), (3240, (8, 8, 8), "threshold"),
    (37, (8, 5, 5), "quant"), (70, (3, 7, 11), "quant"), (5, (1, 1, 1), "bandpass"),
])
def test_block_filter_kernel_matches_plain(cuda, nb, dims, mode):
    """<= 1e-2 pels (the JAX package's bound, tests/test_pallas.py:43):
    the kernel's split-TF32 products against the plain version's float32
    ones.  Blocks with a coefficient within the estimated kernel-vs-plain
    error (``boundary_band``: band_c(V) * 2^-21 * |x| @ |K2m^T|) of a threshold or
    quant boundary are left out, no more than ``_BF_MAX_EXCLUDED``."""
    g = torch.Generator(device=cuda).manual_seed(nb)
    v = int(np.prod(dims))
    uf = _uf(dims)
    filt = uf.copy()
    if mode == "bandpass":
        filt[dims[0] // 4 + 1:] = 0.0
        filt *= 1.25
    k2m_t, k3s_t = tbf.folded_filter_matrices(dims, filt, 1.0 / uf, cuda)
    x = torch.rand((nb, v), generator=g, device=cuda) * 255.0
    f = x @ k2m_t
    a = f.abs()
    quant = tmin = tmax = 0.0
    if mode != "bandpass":
        tmin, tmax = (float(torch.quantile(a.flatten(), q)) for q in (0.4, 0.97))
    if mode == "quant":
        quant = float(torch.quantile(a.flatten(), 0.5)) / 4.0
    band = tbf.boundary_band(x, k2m_t)
    near = torch.zeros_like(a, dtype=torch.bool)
    if tmax:
        near |= ((a - tmin).abs() <= band) | ((a - tmax).abs() <= band)
    if quant:
        y = tbf._middle(f, 0.0, tmin, tmax).abs() * (1.0 / quant)
        half = torch.floor(y) + 0.5
        near |= (y - half).abs() <= band / quant
    keep = ~near.any(dim=1)
    before = tbf.LAUNCHES["block_filter"]
    out = tbf._block_filter(x, k2m_t, k3s_t, quant, tmin, tmax)
    assert tbf.LAUNCHES["block_filter"] == before + 1
    ref = tbf._block_filter_plain(x, k2m_t, k3s_t, quant, tmin, tmax)
    torch.cuda.synchronize()
    excluded = nb - int(keep.sum())
    print(f"block filter nb={nb} dims={dims} {mode}: {excluded} blocks excluded")
    assert excluded <= _BF_MAX_EXCLUDED[nb]
    assert float((out - ref).abs()[keep].max()) <= 1e-2


def test_block_filter_split_operands_cached_with_the_matrices(cuda):
    """On the card the folded operands carry the kernel's K-major hi/lo
    layouts of both matrices, made once: a second call returns the same
    tensors, and the kernel given them equals the kernel splitting the
    matrices itself."""
    dims = (8, 5, 5)
    filt = np.random.default_rng(5).random(dims) + 0.5
    k2m_t, k3s_t, split = tbf._folded_operands(dims, filt, None, cuda)
    assert split is not None and len(split) == 4
    for got, want in zip(split, (*tbf._kmajor_split(k2m_t), *tbf._kmajor_split(k3s_t))):
        assert got.is_cuda and torch.equal(got, want)
    again = tbf._folded_operands(dims, filt.copy(), None, cuda)
    assert all(a is b for a, b in zip(again[2], split))
    x = torch.rand((70, 200), generator=torch.Generator(device=cuda).manual_seed(1),
                   device=cuda) * 255.0
    y = tbf._block_filter_cuda(x, k2m_t, k3s_t, 0.0, 0.0, 0.0, split)
    assert torch.equal(y, tbf._block_filter_cuda(x, k2m_t, k3s_t, 0.0, 0.0, 0.0))


def test_block_filter_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    x = torch.zeros((4, 64), device=cuda)
    k = torch.zeros((64, 64), device=cuda)
    big = torch.zeros((1025, 1025), device=cuda)
    with pytest.raises(ValueError, match="V_MAX"):
        tbf._block_filter_cuda(torch.zeros((4, 1025), device=cuda), big, big, 0.0, 0.0, 0.0)
    with pytest.raises(TypeError, match="float32"):
        tbf._block_filter_cuda(x.double(), k, k, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        tbf._block_filter_cuda(torch.zeros((64, 4), device=cuda).T, k, k, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA device"):
        tbf._block_filter_cuda(x, k.cpu(), k, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="expected"):
        tbf._block_filter_cuda(x, k[:32], k, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("block,bp_end,params,path", [
    ((8, 8, 8), (4, 4, 4), dict(boost=1.25, damp=0.0), "cuda-kron"),
    ((8, 8, 8), (8, 8, 8), dict(threshold_min=0.01, threshold_max=0.5), "cuda-kron"),
    ((16, 16, 8), (8, 8, 4), dict(boost=1.25, damp=0.0), "i8-kron"),
    ((16, 16, 8), (8, 8, 4), dict(boost=1.25, damp=0.5), "sep"),
    ((8, 8, 4), (8, 8, 4), dict(quant=0.05, coeff_limit=40, preserve_dc="dc"), None),
    ((8, 8, 4), (8, 8, 4), dict(linear=True, damp=0.5), None),
])
def test_filter_blocks_card_equals_cpu(cuda, block, bp_end, params, path):
    """Every branch of filter_blocks on the card against the same call on
    the CPU (the kernels' plain versions there): 2e-3 pels — float32
    sums in another order (cuBLAS, the kernel, the CPU's BLAS); the
    i8-kron digit contractions are exact on both sides."""
    D = tmp.Dims
    g = tmp.plan_geometry(32, 32, block[2], 1, block=D(*block), bp_end=D(*bp_end))[0]
    p = tmp.MotionParams(**params)
    frames = (np.random.default_rng(4).random((block[2], 32, 32)) * 255).astype(np.float32)
    blocks = torch.from_numpy(np.ascontiguousarray(tmp.frames_to_blocks(frames, g)))
    outs = []
    for dev in ("cpu", cuda):
        plans = (*tmp.make_plans(g, device=dev),
                 tmp.maybe_kron_plans(g, p, allow_cpu=True, device=dev))
        out, coded = tmp.filter_blocks(blocks.to(dev), plans, None, None, g, p, 0, 1)
        expect = path if dev == cuda else {"cuda-kron": "plain-kron"}.get(path, path)
        assert tmp.LAST_FAST_PATH == expect
        outs.append((out.cpu().numpy(), coded.cpu().numpy()))
    torch.cuda.synchronize()
    assert np.max(np.abs(outs[0][0] - outs[1][0])) <= 2e-3
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_motion_cli_card_equals_cpu(cuda, tmp_path):
    """The motion CLI with --device cuda against --device cpu on a small
    4:2:0 clip: byte-equal headers, every pel within one level."""
    from fractions import Fraction

    from dspfun_tpu_torch.io import video
    from dspfun_tpu_torch.tools import motion

    rng = np.random.default_rng(5)
    clip = str(tmp_path / "clip.y4m")
    with video.open_output(clip, 64, 48, Fraction(25, 1),
                           video.ColorProps(pix_fmt="yuv420p")) as w:
        for _ in range(16):
            w.write_frame([rng.integers(0, 256, (h, wd)).astype(np.uint8)
                           for wd, h in video.PIXEL_FORMATS["yuv420p"].plane_dims(64, 48)],
                          raw=True)
    outs = []
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.y4m")
        assert motion.main(["-Q", "--device", dev, "-b", "16x16x16",
                            "-p", "0x0x0-8x8x4", "-B", "1.25", clip, out]) == 0
        outs.append(open(out, "rb").read())
    ha, hb = outs[0].index(b"\n"), outs[1].index(b"\n")
    assert outs[0][:ha] == outs[1][:hb]
    a = np.frombuffer(outs[0][ha:], np.uint8).astype(int)
    b = np.frombuffer(outs[1][hb:], np.uint8).astype(int)
    assert np.max(np.abs(a - b)) <= 1


def _eval_clip(tmp_path, w=64, h=48, n=8):
    from fractions import Fraction

    from dspfun_tpu_torch.io import video

    rng = np.random.default_rng(6)
    clip = str(tmp_path / "clip.y4m")
    with video.open_output(clip, w, h, Fraction(25, 1), video.ColorProps(pix_fmt="yuv420p")) as wr:
        for _ in range(n):
            wr.write_frame([rng.integers(0, 256, (ph, pw)).astype(np.uint8)
                            for pw, ph in video.PIXEL_FORMATS["yuv420p"].plane_dims(w, h)],
                           raw=True)
    return clip


def _decoded(path):
    from dspfun_tpu_torch.io import video

    with video.open_input(path) as r:
        out = []
        while (f := r.read_frame(raw=True)) is not None:
            out.append(np.concatenate([p.astype(int).ravel() for p in f]))
    return np.stack(out)


@pytest.mark.parametrize("args", [
    ["-b", "0x0x0", "--eval", "c * ((width-x)/width) * ((height-y)/height) * ((depth-z)/depth)"],
    ["-b", "8x8x2", "--slab-batch", "2", "--eval", "c*gte(bz,2)*(1+bx/bwidth)"],
    ["-b", "16x16x4", "--eval", "if(lt(x+y+z,4), c*gauss(x/4), c*squish(-i))"],
])
def test_motion_eval_card_equals_cpu(cuda, tmp_path, args):
    """--eval on the card against --device cpu into FFV1-in-NUT: the frames
    within one level (float32 transforms on two devices)."""
    from dspfun_tpu_torch.tools import motion

    clip = _eval_clip(tmp_path)
    outs = []
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.nut")
        assert motion.main(["-Q", "--device", dev] + args + [clip, out]) == 0
        outs.append(_decoded(out))
    assert outs[0].shape == outs[1].shape and np.max(np.abs(outs[0] - outs[1])) <= 1


def test_motion_stateful_eval_leaves_the_cpu_state(cuda, tmp_path, monkeypatch):
    """A stateful expression takes the grid to the host per slab and plane:
    the parse ends the card's run with the slots and generator state of
    the CPU's run, and the frames are within one level."""
    from dspfun_tpu_torch.tools import motion

    clip = _eval_clip(tmp_path, n=4)
    parsed = []
    real = motion.parse_expr
    monkeypatch.setattr(motion, "parse_expr", lambda *a: parsed.append(real(*a)) or parsed[-1])
    outs = []
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.y4m")
        assert motion.main(["-Q", "--device", dev, "-b", "8x8x2", "--slab-batch", "2",
                            "--eval", "c*(1+0.1*random(0))", clip, out]) == 0
        outs.append(_decoded(out))
    assert parsed[0]._slots and parsed[0]._slots == parsed[1]._slots
    assert parsed[0]._prng == parsed[1]._prng
    assert np.max(np.abs(outs[0] - outs[1])) <= 1
    assert motion.LAST_STAGE_TIMES["host_eval"] > 0


def test_host_libraries_load_on_the_card_machine(tmp_path):
    """libdspio and libffv1 build from the package's sources with g++ here
    too: a y4m read through the prefetching reader into FFV1-in-NUT and
    Matroska and back, lossless."""
    from fractions import Fraction

    from dspfun_tpu_torch import _hostbuild
    from dspfun_tpu_torch.io import ffv1, native, video

    native._load()
    ffv1._load()
    assert _hostbuild.library_path("dspio").is_file() and _hostbuild.library_path("ffv1").is_file()
    clip = _eval_clip(tmp_path, n=3)
    want = _decoded(clip)
    for ext in ("nut", "mkv"):
        r = video.open_input(clip)
        assert isinstance(r, video.NativeBackedReader)
        out = str(tmp_path / f"o.{ext}")
        w = video.open_output(out, r.width, r.height, Fraction(25), r.props)
        while (f := r.read_frame(raw=True)) is not None:
            w.write_frame(f, raw=True)
        w.close()
        r.close()
        assert w.codec == "ffv1"
        np.testing.assert_array_equal(_decoded(out), want)


def test_spec_and_ispec_clis_on_card(cuda, tmp_path, monkeypatch):
    """``spec`` then ``ispec`` through files at 512x384 with the policy set
    to ``i8@1e-5``: each tool launches the left and the right 3-digit
    kernel once, its files equal, byte for byte, the files of the same run
    with the plain version forced, and the spectrum agrees with
    ``--device cpu``'s within one 16-bit level."""
    from dspfun_tpu_torch.core import precision
    from dspfun_tpu_torch.io import images
    from dspfun_tpu_torch.tools import ispec, spec

    monkeypatch.setattr(precision, "_default", Precision.parse("i8@1e-5"))
    monkeypatch.setattr(precision, "_explicit", True)
    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:384, 0:512]
    pix = 0.5 + 0.3 * np.sin(x / 31.0 + y / 17.0)[..., None] + 0.1 * (rng.random((384, 512, 3)) - 0.5)
    src = str(tmp_path / "in.png")
    images.write_image(src, pix, depth=16)

    def run(tag, extra=()):
        s, b = str(tmp_path / f"s_{tag}.png"), str(tmp_path / f"b_{tag}.png")
        counts = []
        for main, a, o in ((spec.main, src, s), (ispec.main, s, b)):
            tmm.LAUNCHES.clear()
            assert main([*extra, "-t", "flat", a, o]) == 0
            counts.append({n: c for n, c in tmm.LAUNCHES.items() if c})
        return counts, open(s, "rb").read(), open(b, "rb").read()

    counts, s_kernel, b_kernel = run("kernel")
    assert counts == [{"left3": 1, "right3": 1}] * 2
    monkeypatch.setattr(tmm, "_i8_groups", tmm._i8_groups_plain)
    counts, s_plain, b_plain = run("plain")
    assert counts == [{}, {}]
    assert s_kernel == s_plain and b_kernel == b_plain
    run("cpu", ("--device", "cpu"))
    a, b = (images.read_image(str(tmp_path / f"s_{t}.png")) for t in ("kernel", "cpu"))
    assert a.properties.keys() == b.properties.keys() == {"DC"}
    assert np.max(np.abs(a.pixels - b.pixels)) <= 1.0 / 65535 + 1e-12


# ---- the in-kernel digit split (csrc/int8split.cu) ----


def _split_operands(gen, instance, m, k, r, device):
    """A planes [groups, m, lda] with lda = k rounded up to 128 (zero
    padding) and x [k, r] inside the instance's domain, with an all-zero
    column and a column whose max is a power of two."""
    xdigits, groups, scale = instance
    a = _digits(gen, (groups, m, tmm.ceil_to(k, 128)), device)
    a[:, :, k:] = 0
    if scale == "fixed64":
        x = torch.rand((k, r), generator=gen, device=device) * 1.95   # |x * 64| <= 127
    else:
        x = (torch.rand((k, r), generator=gen, device=device) - 0.3) * 4
        x[k // 2, min(1, r - 1)] = 4.0
    x[:, 0] = 0.0
    return a, x


@pytest.mark.parametrize("m,k,r", [(64, 256, 256), (77, 300, 45), (200, 1000, 300), (3, 5, 1),
                                   (5, 1, 7)])
@pytest.mark.parametrize("instance,tile", [
    ((1, 1, "fixed64"), 0), ((1, 1, "exp"), 0), ((3, 2, "exp"), 0),
    ((3, 3, "exp"), 0), ((3, 3, "exp"), 1), ((3, 2, "exp"), 1),
    ((1, 1, "fixed64"), 1), ((1, 1, "exp"), 1),
])
def test_i8split_kernel_bit_equal_to_plain(cuda, instance, tile, m, k, r):
    """Every compiled instance and tile at the probes' shape, a ragged
    shape (M, K and R off every tile multiple; R off 4 takes the wrapper's
    padded copy of x), a larger one, a tiny one and K = 1: bit-equal to the
    plain version, the zero column exactly 0.  A wrong digit order inside
    the swizzled words gives wrong sums here without faulting."""
    xdigits, groups, scale = instance
    g = torch.Generator(device=cuda).manual_seed(m * 31 + k + tile)
    a, x = _split_operands(g, instance, m, k, r, cuda)
    name = tsp.INSTANCES[instance]
    before = tsp.LAUNCHES[name]
    y = tsp.i8_split_contract(a, x, xdigits=xdigits, groups=groups, scale=scale, tile=tile)
    assert tsp.LAUNCHES[name] == before + 1
    ref = tsp._i8_split_plain(a, x, xdigits, groups, scale)
    torch.cuda.synchronize()
    assert torch.equal(y, ref)
    assert not y[:, 0].any()


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("instance", list(tsp.INSTANCES))
def test_i8split_kernel_exact_at_the_int32_bound(cuda, instance, tile):
    """K = _kmax with the heaviest digits the split can make: x = 127/64
    (digit 127) on the fixed scale, x = 1 (digit 32 after the column scale
    2^-1) for one digit, and x = 0.99212646484375 for three, which splits
    at 2^-1 into the digits (63, 64, -64); A's digits are +-64 with signs
    that make row 0's heaviest group add up to near 2^31.  A saturating or
    wrapping accumulator, or a float combine of partial sums, would differ
    from the plain version here.  R = 3 takes the padded copy of x."""
    xdigits, groups, scale = instance
    k = tsp._kmax(groups, scale)
    sign = torch.where(torch.arange(k) % 3 == 0, -1.0, 1.0)
    if scale == "fixed64":
        xv, adig = 127 / 64, [64]
    elif xdigits == 1:
        xv, adig = 1.0, [64]
    else:
        xv, adig = 0.99212646484375, ([64, 64] if groups == 2 else [-64, 64, 64])
    x = torch.stack([sign * xv, torch.full((k,), xv), -sign * xv], 1)
    a = torch.zeros((groups, 2, tmm.ceil_to(k, 128)), dtype=torch.int8)
    for i, d in enumerate(adig):
        a[i, 0, :k] = (sign * d).to(torch.int8)
        a[i, 1, :k:2], a[i, 1, 1:k:2] = 64, -64
    digits, _ = tsp.split_columns(x, xdigits, scale)
    heavy = sum(adig[i] * int(digits[g - i][1, 0]) for g in [groups - 1]
                for i in range(groups) if g - i < xdigits)
    assert abs(heavy) * k <= 2**31 - 1
    if scale == "fixed64" or xdigits == 3:
        assert abs(heavy) * k >= 0.99 * 2**31
    ref = tsp._i8_split_plain(a, x, xdigits, groups, scale)
    y = tsp.i8_split_contract(a.to(cuda), x.to(cuda), xdigits=xdigits, groups=groups,
                              scale=scale, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(y.cpu(), ref)


def test_i8split_probes_and_calib_r3f_on_card_equal_cpu(cuda):
    """The calibration counterparts on the card against the CPU."""
    from dspfun_tpu_torch.benchmarks import calib_r3e, calib_r3f

    card, cpu = calib_r3e.run_probes(cuda), calib_r3e.run_probes("cpu")
    for name in calib_r3e.PROBES:
        assert torch.equal(card[name].cpu(), cpu[name])
    a, _, x, _ = calib_r3f.inputs(1000, 200, 300, device="cpu")
    y = calib_r3f.fused(a.to(cuda), x.to(cuda))
    assert torch.equal(y.cpu(), calib_r3f.fused(a, x))
    assert torch.equal(y, calib_r3f.split_then_i8mm(a.to(cuda), x.to(cuda)))


def test_i8split_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    a = torch.zeros((3, 8, 128), dtype=torch.int8, device=cuda)
    x = torch.zeros((128, 4), device=cuda)
    kw = dict(xdigits=3, groups=3, scale="exp")
    with pytest.raises(ValueError, match="CUDA device"):
        tsp._i8_split_cuda(a.cpu(), x.cpu(), 3, 3, "exp")
    with pytest.raises(ValueError, match="CUDA device"):
        tsp.i8_split_contract(a.cpu(), x, **kw)
    with pytest.raises(TypeError, match="float32"):
        tsp.i8_split_contract(a, x.double(), **kw)
    with pytest.raises(TypeError, match="int8"):
        tsp.i8_split_contract(a.float(), x, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tsp.i8_split_contract(a, torch.zeros((4, 128), device=cuda).T, **kw)
    with pytest.raises(ValueError, match="compiled for tiles"):
        tsp.i8_split_contract(a[:1].contiguous(), x, xdigits=1, groups=1, scale="exp", tile=2)
    k = tsp._kmax(3, "exp") + 1
    with pytest.raises(ValueError, match="exact-int32"):
        tsp.i8_split_contract(torch.zeros((3, 1, k), dtype=torch.int8, device=cuda),
                              torch.zeros((k, 1), device=cuda), **kw)


# ---- scan and zoom on the card (paths 5 and 6) ----


@pytest.mark.parametrize("layout,m,k,b,r", [
    # zoom's 4x still of a 1080p image at a reduced R: the batched-left
    # form along H, then the right form along W; and the forward DCT's W
    # pass, which batches over the rows with R = 3
    ("left", 4320, 1080, 3, 192), ("right", 7680, 1920, 1, 324), ("left", 1920, 1920, 108, 3),
])
def test_four_digit_kernel_at_zooms_shapes(cuda, layout, m, k, b, r):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    a = _digits(g, (4, m, tmm.ceil_to(k, 128)), cuda)
    a[:, :, k:] = 0
    x = _digits(g, (4, b, k, r) if layout == "left" else (4, b, r, k), cuda)
    before = tmm.LAUNCHES[f"{layout}4"]
    y = tmm._i8_groups(a, x, layout)
    assert tmm.LAUNCHES[f"{layout}4"] == before + 1
    assert torch.equal(y, tmm._i8_groups_plain(a, x, layout))


@pytest.mark.parametrize("axis,shape,m", [(1, (3, 272, 320), 90), (2, (3, 70, 320), 200),
                                          (0, (300, 70), 33), (1, (2, 300, 5, 7), 20)])
def test_i8_contract_rt_kernel_equals_plain_and_cpu(cuda, axis, shape, m, monkeypatch):
    """The run-time split of both operands (zoom's device route): the
    kernel's result equals the plain version's on the card and the CPU's,
    bit for bit, and lands within 2^-16 of a float64 product."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((m, shape[axis])).astype(np.float32)
    x = ((rng.random(shape) - 0.4) * 3).astype(np.float32)
    tmm.LAUNCHES.clear()
    y = tmm.i8_contract_rt(torch.from_numpy(x).to(cuda), torch.from_numpy(a).to(cuda), axis)
    assert sum(tmm.LAUNCHES.values()) == 1 and tuple(y.shape) == shape[:axis] + (m,) + shape[axis + 1:]
    y_cpu = tmm.i8_contract_rt(torch.from_numpy(x), torch.from_numpy(a), axis)
    assert torch.equal(y.cpu(), y_cpu)
    monkeypatch.setattr(tmm, "_i8_groups", tmm._i8_groups_plain)
    y_plain = tmm.i8_contract_rt(torch.from_numpy(x).to(cuda), torch.from_numpy(a).to(cuda), axis)
    assert torch.equal(y, y_plain) and sum(tmm.LAUNCHES.values()) == 1
    ref = np.moveaxis(np.tensordot(a.astype(np.float64), x.astype(np.float64), ([1], [axis])), 0, axis)
    assert np.max(np.abs(y.cpu().numpy() - ref)) <= 2.0**-16 * np.max(np.abs(ref))


def _tool_png(tmp_path, h, w, seed):
    from dspfun_tpu_torch.io import images

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    pix = 0.5 + 0.25 * np.sin(x / 31.0 + y / 17.0)[..., None] + 0.06 * (rng.random((h, w, 3)) - 0.5)
    src = str(tmp_path / "in.png")
    images.write_image(src, pix)
    return src


def test_scan_cli_on_card(cuda, tmp_path, monkeypatch):
    """``scan`` at 272x320: the default policy launches nothing and agrees
    with ``--device cpu`` within one level; at ``i8@1e-5`` the left kernel
    launches twice in the forward DCT and twice per chunk, and the file
    equals the plain-forced run's, byte for byte."""
    from dspfun_tpu_torch.core import precision
    from dspfun_tpu_torch.tools import scan

    src = _tool_png(tmp_path, 272, 320, 1)
    args = ["-m", "zigzag", "-S", "700", "-q", "-P"]
    out = {t: str(tmp_path / f"{t}.y4m") for t in ("card", "cpu", "i8", "plain")}
    monkeypatch.setattr(precision, "_default", Precision())
    monkeypatch.setattr(precision, "_explicit", True)
    tmm.LAUNCHES.clear()
    assert scan.main(args + [src, out["card"]]) == 0 and not tmm.LAUNCHES
    assert "chunk_device_ms" in scan.LAST_STAGE_TIMES
    assert scan.main(["--device", "cpu"] + args + [src, out["cpu"]]) == 0
    a, b = (np.frombuffer(open(out[t], "rb").read(), np.uint8).astype(int) for t in ("card", "cpu"))
    assert a.shape == b.shape and np.abs(a - b).max() <= 1 and np.mean(a != b) < 0.005
    monkeypatch.setattr(precision, "_default", Precision.parse("i8@1e-5"))
    assert scan.main(args + [src, out["i8"]]) == 0
    nchunks = -(-scan.LAST_STAGE_TIMES["frames"] // 61)       # 16e6 // (272 * 320 * 3) frames a chunk
    assert dict(tmm.LAUNCHES) == {"left3": 2 + 2 * nchunks}
    monkeypatch.setattr(tmm, "_i8_groups", tmm._i8_groups_plain)
    assert scan.main(args + [src, out["plain"]]) == 0
    assert open(out["i8"], "rb").read() == open(out["plain"], "rb").read()


def test_zoom_cli_on_card(cuda, tmp_path, monkeypatch):
    """``zoom`` at 272x320: the tool's default on a card is deep ``i8``
    (left4 3, right4 1 for a still), byte-equal to the plain-forced run and
    within 1e-5 of ``--device cpu``'s ``hilo`` frame after the OETF; a pan
    on the device basis at ``i8@1e-5`` launches left3 and right3 once a
    frame through ``i8_contract_rt``."""
    from dspfun_tpu_torch.core import precision
    from dspfun_tpu_torch.io import video
    from dspfun_tpu_torch.tools import zoom

    src = _tool_png(tmp_path, 272, 320, 2)
    out = {t: str(tmp_path / f"{t}.fvid") for t in ("card", "cpu", "plain", "pan")}
    monkeypatch.setattr(precision, "_default", Precision())
    monkeypatch.setattr(precision, "_explicit", False)
    monkeypatch.setattr(zoom, "TIME_DEVICE", True)
    tmm.LAUNCHES.clear()
    assert zoom.main(["-s", "2", "-g", src, out["card"]]) == 0
    assert dict(tmm.LAUNCHES) == {"left4": 3, "right4": 1}
    assert precision.get_precision().intermediate == "i8" and precision.get_precision().tol is None
    assert zoom.LAST_STAGE_TIMES["routes"] == ["planned"] and "synth_device" in zoom.LAST_STAGE_TIMES
    assert zoom.main(["--device", "cpu", "-s", "2", "-g", src, out["cpu"]]) == 0
    a, b = (video.open_input(out[t]).read_frame_rgb() for t in ("card", "cpu"))
    assert a.shape == (544, 640, 3) and np.max(np.abs(a - b)) <= 1e-5
    plain = tmm._i8_groups_plain
    monkeypatch.setattr(tmm, "_i8_groups", plain)
    assert zoom.main(["-s", "2", "-g", src, out["plain"]]) == 0
    assert open(out["card"], "rb").read() == open(out["plain"], "rb").read()
    monkeypatch.undo()
    monkeypatch.setattr(precision, "_default", Precision.parse("i8@1e-5"))
    monkeypatch.setattr(precision, "_explicit", True)
    tmm.LAUNCHES.clear()
    assert zoom.main(["-s", "2", "-v", "320x272", "-n", "4", "-q", "-x", "8*i", src, out["pan"]]) == 0
    assert zoom.LAST_STAGE_TIMES["routes"] == ["device"] * 4
    assert dict(tmm.LAUNCHES) == {"left3": 2 + 4, "right3": 4}


@pytest.mark.parametrize("fn,inverse,psum,cplx", [("dct2", False, (4, 4), False), ("dft", False, (8, 2), True),
                                                  ("dct3", True, (4, 4), True), ("wht", True, (2, 8), False)])
@pytest.mark.parametrize("spec", ["hilo", "f64:f64"])
def test_apply_basis_card_equals_cpu(cuda, fn, inverse, psum, cplx, spec):
    """``apply_basis``'s two contractions on the card against the same on
    the CPU: complex64 (the default policy) within float32 rounding of
    the largest |value|, complex128 (``f64``) within 1e-12 of it."""
    from dspfun_tpu_torch.models import basis_pipeline as bp

    rng = np.random.default_rng(sum(psum))
    x = rng.random((32, 48, 3)) * 2 - 1
    if cplx:
        x = x + 1j * (rng.random((32, 48, 3)) * 2 - 1)
    p = Precision.parse(spec)
    kw = dict(partsum=psum, inverse=inverse, orthogonal=True, precision=p)
    times = {}
    a = bp.apply_basis(x, fn, device="cuda", times=times, **kw)
    b = bp.apply_basis(x, fn, device="cpu", **kw)
    assert a.shape == b.shape and a.dtype == np.complex128 and "compute_device" in times
    tol = 1e-12 if spec == "f64:f64" else 2e-6
    assert np.max(np.abs(a - b)) <= tol * np.abs(b).max()


def test_draw_cli_on_card(cuda, tmp_path, monkeypatch):
    """``draw`` at 320x256: no launch at the default policy and one
    level from ``--device cpu``; at ``i8@1e-5`` the DCT-III launches the
    left 3-digit kernel along H and the right one along W (the one-column
    grid takes the right form), and the file equals the plain-forced
    run's, byte for byte."""
    from dspfun_tpu_torch.core import precision
    from dspfun_tpu_torch.tools import draw

    args = ["-b", "320x256", "-f", "3x3:0.4", "-f", "2x5:0.2", "-f", "100x7"]
    out = {t: str(tmp_path / f"{t}.png") for t in ("card", "cpu", "i8", "plain")}
    monkeypatch.setattr(precision, "_default", Precision())
    monkeypatch.setattr(precision, "_explicit", True)
    tmm.LAUNCHES.clear()
    assert draw.main(args + [out["card"]]) == 0 and not tmm.LAUNCHES
    assert draw.main(["--device", "cpu"] + args + [out["cpu"]]) == 0
    from dspfun_tpu_torch.io import png

    a, b = (png.decode_png(open(out[t], "rb").read())[0].astype(int) for t in ("card", "cpu"))
    assert a.shape == b.shape == (256, 320, 3) and np.abs(a - b).max() <= 1
    monkeypatch.setattr(precision, "_default", Precision.parse("i8@1e-5"))
    assert draw.main(args + [out["i8"]]) == 0
    assert dict(tmm.LAUNCHES) == {"left3": 1, "right3": 1}
    monkeypatch.setattr(tmm, "_i8_groups", tmm._i8_groups_plain)
    assert draw.main(args + [out["plain"]]) == 0
    assert open(out["i8"], "rb").read() == open(out["plain"], "rb").read()


def test_two_ranks_of_the_sharded_3d_dct_on_one_card(cuda):
    """dct3d_sharded_fn on two ranks that share the card (gloo, staged
    through the host): the int8 kernels launch on each rank's shard, and
    the filtered cube equals the single-device chain on the card within
    float32 error."""
    import torch_mesh_cases as cases
    from dspfun_tpu_torch.parallel.mesh import RankPool

    rng = np.random.default_rng(0)
    t, h, w = 8, 256, 320
    cube = rng.random((t, h, w, 1)).astype(np.float32)
    mask = fused.lowpass_mask((t, h, w), cutoff=0.5, boost=1.25, damp=0.1)[..., None] \
        .astype(np.float32)
    p = Precision(coeff="float32", intermediate="i8", tol=1e-5)
    with RankPool(["cuda:0", "cuda:0"]) as pool:
        assert pool.backend == "gloo"
        res = pool.run(cases.fused3d_launched, pool.mesh(space=2), cube, mask, p)
    ref = fused.fused_filter_3d(torch.from_numpy(cube).to(cuda), torch.from_numpy(mask).to(cuda),
                                fused.filter_plans((t, h, w), p, device=cuda), p).cpu().numpy()
    for out, counts, launches in res:
        assert counts == {"all_to_all": 4} and launches >= 4
        np.testing.assert_allclose(out, ref, atol=1e-4)


# ---- path 11: the ffmpeg bridge, ffplay: and BMP on the card ----


def _bridge_clip(tmp_path, pix_fmt="yuv420p", w=64, h=48, n=16):
    """(y4m clip, the same frames behind the shim's FAKEMP4 header: y4m
    for 8 bits, raw planes for more) of a seeded clip."""
    from fractions import Fraction

    from dspfun_tpu_torch.io import video
    from torch_ffmpeg_shims import FAKE_HEADER

    pf = video.PIXEL_FORMATS[pix_fmt]
    rng = np.random.default_rng(8)
    clip = str(tmp_path / f"clip_{pix_fmt}.y4m")
    raw = bytearray(FAKE_HEADER)
    with video.open_output(clip, w, h, Fraction(25, 1), video.ColorProps(pix_fmt=pix_fmt)) as wr:
        for t in range(n):
            y, x = np.mgrid[0:h, 0:w]
            planes = [np.clip(128 + 60 * np.sin(x[:ph, :pw] / 7.0 + t / 5.0)
                              + rng.integers(-8, 9, (ph, pw)), 0, 255).astype(np.uint16)
                      << (pf.depth - 8) for pw, ph in pf.plane_dims(w, h)]
            planes = [p.astype(pf.dtype) for p in planes]
            wr.write_frame(planes, raw=True)
            raw += b"".join(p.tobytes() for p in planes)
    mp4 = str(tmp_path / f"in_{pix_fmt}.mp4")
    with open(mp4, "wb") as f:
        f.write(FAKE_HEADER + open(clip, "rb").read() if pf.depth == 8 else bytes(raw))
    return clip, mp4


@pytest.fixture
def shims(tmp_path, monkeypatch):
    """The shim binaries of tests/torch_ffmpeg_shims.py first on PATH for
    the test, their argv log in ``tmp_path`` (returned), the bridge's
    binary caches cleared before and after.  (Imported as a top-level
    module: pytest puts this directory on the path, and the card's machine
    may have another package named ``tests``.)"""
    from dspfun_tpu_torch.io import ffmpeg_bridge
    from torch_ffmpeg_shims import install_shims, shim_path

    monkeypatch.setenv("PATH", shim_path(install_shims(tmp_path / "bin")))
    log = str(tmp_path / "shim.log")
    monkeypatch.setenv("SHIM_LOG", log)
    for fn in (ffmpeg_bridge.have_ffmpeg, ffmpeg_bridge.have_ffprobe):
        fn.cache_clear()
    yield log
    for fn in (ffmpeg_bridge.have_ffmpeg, ffmpeg_bridge.have_ffprobe):
        fn.cache_clear()


def _probe(monkeypatch, tmp_path, pix_fmt, w=64, h=48, n=16):
    import json

    p = tmp_path / "probe.json"
    p.write_text(json.dumps({"streams": [{"codec_type": "video", "pix_fmt": pix_fmt,
                                          "nb_frames": str(n), "avg_frame_rate": "25/1",
                                          "width": w, "height": h, "color_range": "tv"}],
                             "format": {}}))
    monkeypatch.setenv("SHIM_PROBE", str(p))


MOTION_BRIDGE = ["-Q", "--device", "cuda", "-b", "16x16x16", "-p", "0x0x0-8x8x4", "-B", "1.25"]


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
def test_motion_through_the_bridge_on_card(cuda, shims, tmp_path, monkeypatch, pix_fmt):
    """motion from ``in.mp4`` to ``out.mp4`` through the ffmpeg bridge (the
    shim binaries) on the card: the same bytes as the card's y4m -> y4m
    run (the y4m transport at 8 bits, rawvideo both ways at 10 bits),
    the block filter and the right 3-digit kernel launched."""
    from dspfun_tpu_torch.tools import motion

    _probe(monkeypatch, tmp_path, pix_fmt)
    clip, mp4 = _bridge_clip(tmp_path, pix_fmt)
    ref, out = str(tmp_path / "ref.y4m"), str(tmp_path / "out.mp4")
    assert motion.main(MOTION_BRIDGE + [clip, ref]) == 0
    tmm.LAUNCHES.clear()
    tbf.LAUNCHES.clear()
    assert motion.main(MOTION_BRIDGE + [mp4, out]) == 0
    assert tmm.LAUNCHES.get("right3") and tbf.LAUNCHES.get("block_filter")
    got = open(out, "rb").read()
    if pix_fmt == "yuv420p":
        assert got == open(ref, "rb").read()
    else:
        with open(ref, "rb") as f:
            f.readline()
            assert got == b"".join(f.read().split(b"FRAME\n"))


def test_ffplay_sink_on_card(cuda, shims, tmp_path):
    """motion on the card into ``ffplay:``: the player gets the y4m stream
    and the color properties on its command line."""
    import json

    from dspfun_tpu_torch.tools import motion

    clip, _ = _bridge_clip(tmp_path)
    assert motion.main(MOTION_BRIDGE + ["--csp", "color_range=jpeg:color_trc=linear",
                                        clip, "ffplay:"]) == 0
    play = [json.loads(ln) for ln in open(shims)][-1]
    assert play[play.index("-video_size") + 1] == "64x48"
    assert play[play.index("-pixel_format") + 1] == "yuv420p"


def test_bmp_into_spec_at_i8_on_card(cuda, tmp_path, monkeypatch):
    """spec at ``i8@1e-5`` of a BMP and of the PNG of the same pixels on
    the card: the same spectrum, each run launching the left and the
    right 3-digit kernel once; ispec of it to BMP and back."""
    from dspfun_tpu_torch.core import precision
    from dspfun_tpu_torch.io import images
    from dspfun_tpu_torch.tools import ispec, spec

    monkeypatch.setattr(precision, "_default", Precision.parse("i8@1e-5"))
    monkeypatch.setattr(precision, "_explicit", True)
    rng = np.random.default_rng(9)
    pix = rng.random((272, 320, 3))
    for ext in ("png", "bmp"):
        images.write_image(str(tmp_path / f"in.{ext}"), pix)
    spectra = []
    for ext in ("png", "bmp"):
        tmm.LAUNCHES.clear()
        s = str(tmp_path / f"s_{ext}.png")
        assert spec.main(["-t", "flat", "-G", "1000", str(tmp_path / f"in.{ext}"), s]) == 0
        assert {n: c for n, c in tmm.LAUNCHES.items() if c} == {"left3": 1, "right3": 1}
        spectra.append(open(s, "rb").read())
    assert spectra[0] == spectra[1]
    b = str(tmp_path / "back.bmp")
    assert ispec.main(["-t", "flat", "-G", "1000", str(tmp_path / "s_bmp.png"), b]) == 0
    assert images.read_image(b).pixels.shape == (272, 320, 3)
