"""dspfun_tpu_torch.ops.int8mm against dspfun_tpu.ops.int8mm.

The same numpy inputs go through both packages.  JAX runs its Pallas
kernels in interpret mode on the CPU; the port runs the kernel's plain
version (_i8_groups_plain) there.  Digit splits and integer group sums
are exact in both, so the contractions agree bit for bit; the stated
tolerance, 2^-23 of the largest output, is one float32 ulp at the top
of the range.  The CUDA kernel is held to its plain version on the card
by tests/test_torch_cuda.py.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.core import basis as jbasis
from dspfun_tpu.ops import int8mm as jmm
from dspfun_tpu_torch import _build
from dspfun_tpu_torch.ops import int8mm as tmm


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulp_close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 2.0**-23 * np.max(np.abs(ref))


@pytest.mark.parametrize("shape,ndig", [((24, 200), 3), ((24, 200), 4),
                                        ((7, 128), 3), ((33, 1000), 4)])
def test_split_matrix_i8_bit_equal(shape, ndig):
    m = np.random.default_rng(0).standard_normal(shape) * 5.0
    dj, sj = jmm.split_matrix_i8(m, ndig)
    dt, st = tmm.split_matrix_i8(m, ndig)
    assert dt.dtype == np.int8 and dt.shape[2] % 128 == 0
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("ndig", [3, 4])
@pytest.mark.parametrize("axis,shape", [
    (0, (160, 70)),          # left form
    (1, (3, 160, 70)),       # batched left form ([C, H, W] case)
    (2, (3, 50, 160)),       # right form
    (1, (2, 160, 5, 7)),     # general middle axis (movedim)
])
def test_i8_contract_matches_jax(axis, shape, ndig):
    k = shape[axis]
    rng = np.random.default_rng(1)
    m = jbasis.dct2_matrix(k)
    x = ((rng.random(shape) - 0.3) * 4).astype(np.float32)
    digits, scale = jmm.split_matrix_i8(m, ndig)
    yj = np.asarray(jmm.i8_contract(jnp.asarray(x), jnp.asarray(digits),
                                    jnp.asarray(scale), axis))
    before = sum(tmm.LAUNCHES.values())
    yt = tmm.i8_contract(_t(x), _t(digits), _t(scale), axis)
    assert sum(tmm.LAUNCHES.values()) == before  # CPU: no kernel launch
    assert yt.dtype == torch.float32
    _ulp_close(yt.numpy(), yj)
    # and the digit scheme's own accuracy against float64
    ref = np.moveaxis(np.tensordot(m, x.astype(np.float64), axes=[[1], [axis]]),
                      0, axis)
    bound = 1e-6 if ndig == 3 else 1e-7
    assert np.max(np.abs(yt.numpy() - ref)) / np.max(np.abs(ref)) <= bound


@pytest.mark.parametrize("ndig", [3, 4])
@pytest.mark.parametrize("shape", [(300, 260, 1), (2, 40, 300, 1)])
def test_one_column_takes_the_right_form_and_matches_jax(shape, ndig, monkeypatch):
    """A middle axis whose last axis has length 1 (draw's [H, W, 1] grid
    along W) goes through the right form on the squeezed tensor; the JAX
    package (Pallas in interpret mode) takes the batched left form, and
    the two agree bit for bit."""
    axis = len(shape) - 2
    k = shape[axis]
    x = ((np.random.default_rng(7).random(shape) - 0.3) * 4).astype(np.float32)
    digits, scale = jmm.split_matrix_i8(jbasis.dct3_matrix(k), ndig)
    calls = []
    plain = tmm._i8_groups
    monkeypatch.setattr(tmm, "_i8_groups", lambda a, xd, layout: calls.append(
        (layout, tuple(xd.shape))) or plain(a, xd, layout))
    yt = tmm.i8_contract(_t(x), _t(digits), _t(scale), axis)
    rows = int(np.prod(shape[:axis]))
    assert calls == [("right", (ndig, 1, rows, k))]
    assert tuple(yt.shape) == shape
    yj = np.asarray(jmm.i8_contract(jnp.asarray(x), jnp.asarray(digits), jnp.asarray(scale), axis))
    np.testing.assert_array_equal(yt.numpy(), yj)


@pytest.mark.parametrize("axis,shape", [(0, (300, 7)), (2, (2, 3, 300))])
def test_i8_contract_rt_matches_jax(axis, shape):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((40, shape[axis])).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    yj = np.asarray(jmm.i8_contract_rt(jnp.asarray(x), jnp.asarray(a), axis))
    yt = tmm.i8_contract_rt(_t(x), _t(a), axis).numpy()
    _ulp_close(yt, yj)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("bwidth,ndig", [(7, 3), (7, 4), (6, 6)])
def test_split_operand_digits_bit_equal(axis, bwidth, ndig):
    rng = np.random.default_rng(axis + 10 * ndig)
    x = (rng.standard_normal((6, 9, 11)) * 10.0 ** rng.integers(-3, 4, (6, 9, 11))
         ).astype(np.float32)
    x[0] = 0.0  # zero slices along axes 1 and 2
    dj, ej = jmm.split_operand_digits_jnp(jnp.asarray(x), axis, bwidth, ndig,
                                          jnp.float32)
    dt, et = tmm.split_operand_digits(_t(x), axis, bwidth, ndig, torch.float32)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # every digit fits the signed bwidth-bit range
    assert max(float(d.abs().max()) for d in dt) <= 2 ** (bwidth - 1)


def test_exponent_helpers_bit_equal_at_extremes():
    """log2_ceil1/exp2i/scale_down read and build exponent fields; at the
    edges of the float32 range the port must agree with the JAX package
    and stay exact (no log2/exp2 approximations)."""
    x = np.asarray([1.5e38, 2.0**125, -3.0e38, 1.0, 2.0**-126, 3e-39, 0.0],
                   np.float32)
    ej = np.asarray(jmm.log2_ceil1(jnp.asarray(x)))
    et = tmm.log2_ceil1(_t(x)).numpy()
    np.testing.assert_array_equal(et, ej)
    e = np.arange(-140, 140, dtype=np.float32)
    np.testing.assert_array_equal(tmm.exp2i(_t(e)).numpy(),
                                  np.asarray(jmm.exp2i(jnp.asarray(e))))
    assert np.isinf(tmm.exp2i(torch.tensor(128.0)).item())
    emax = tmm.log2_ceil1(torch.tensor(np.abs(x).max()))
    assert float(emax) >= 128
    r = tmm.scale_down(_t(x), emax).numpy().astype(np.float64)
    ref = x.astype(np.float64) * 2.0 ** (-float(emax))
    # results that stay normal are exact and agree with JAX; XLA's CPU
    # flushes subnormal results to zero where PyTorch keeps them, and both
    # lie below the digit truncation depth
    normal = np.abs(ref) >= 2.0**-126
    np.testing.assert_array_equal(r[normal], ref[normal])
    assert np.all(np.abs(r[~normal]) <= 2.0**-126)
    rj = np.asarray(jmm.scale_down(jnp.asarray(x), jnp.asarray(float(emax), jnp.float32)))
    np.testing.assert_array_equal(r[normal], rj[normal])


def test_i8_zero_and_constant_slices():
    """Zero slices (mx = 0) and constant slices give finite results, like
    the JAX package's."""
    k = 128
    m = jbasis.dct2_matrix(k)
    digits, scale = tmm.split_matrix_i8(m)
    x = np.zeros((k, 4), np.float32)
    x[:, 1] = 3.0
    yt = tmm.i8_contract(_t(x), _t(digits), _t(scale), 0).numpy()
    yj = np.asarray(jmm.i8_contract(jnp.asarray(x), jnp.asarray(digits),
                                    jnp.asarray(scale), 0))
    assert np.all(np.isfinite(yt))
    np.testing.assert_array_equal(yt[:, 0], 0.0)
    np.testing.assert_array_equal(yt, yj)
    assert np.max(np.abs(yt - m @ x.astype(np.float64))) <= 1e-4


def test_i8_guards_raise_like_jax():
    """The exact-int32 bound raises the same ValueError from both entry
    points in both packages."""
    assert tmm._kmax(3) == jmm._kmax(3) == ((1 << 31) - 1) // (3 << 12)
    assert tmm._kmax(4) == jmm._kmax(4) == (1 << 17) - 1
    k = tmm._kmax(3) + 1
    digs, sc = tmm.split_matrix_i8(np.ones((8, k)))
    for contract in (
        lambda: tmm.i8_contract(torch.zeros((4, k)), _t(digs), _t(sc), 1),
        lambda: tmm.i8_contract_rt(torch.zeros((4, k)), torch.ones((8, k)), 1),
        lambda: jmm.i8_contract(jnp.zeros((4, k), jnp.float32),
                                jnp.asarray(digs), jnp.asarray(sc), 1),
    ):
        with pytest.raises(ValueError, match="exact-int32"):
            contract()
    with pytest.raises(ValueError, match="digit planes"):
        tmm.i8_contract(torch.zeros((4, 128)), torch.zeros((2, 8, 128), dtype=torch.int8),
                        torch.ones((8, 1)), 1)


def test_i8_feasible_has_no_vmem_limit():
    """The CUDA kernel loops over K, so only the exact-int32 bound limits
    it: the 8K-class deep contraction that the JAX package must send to
    the exact mode (TPU VMEM) stays on the int8 path in the port."""
    assert not jmm.i8_feasible(7680, 7680, 4)
    assert tmm.i8_feasible(7680, 7680, 4)
    assert tmm.i8_feasible(8, tmm._kmax(4), 4)
    assert not tmm.i8_feasible(8, tmm._kmax(4) + 1, 4)


@pytest.mark.parametrize("ndig", [3, 4])
def test_plain_groups_exact_at_the_int32_bound(ndig):
    """At K = _kmax and every digit at +-64, the heaviest group sum sits
    just under 2^31: the float64 plain version must equal exact integer
    arithmetic rounded once to float32."""
    k = tmm._kmax(ndig)
    a = np.full((ndig, 2, k), 64, np.int8)
    a[:, 1, ::2] = -64
    x = np.full((ndig, 1, k, 3), 64, np.int8)
    x[:, :, 1::3, 2] = -64
    y = tmm._i8_groups_plain(_t(a), _t(x), "left").numpy()
    a64, x64 = a.astype(np.int64), x.astype(np.int64)
    acc = None
    for g in range(ndig):
        s = sum(np.einsum("mk,bkr->bmr", a64[i], x64[g - i]) for i in range(g + 1))
        assert np.max(np.abs(s)) < 2**31
        t = s.astype(np.float32) * np.float32(tmm._W[g])
        acc = t if acc is None else acc + t
    np.testing.assert_array_equal(y, acc)
    # the right layout is the same contraction transposed
    yr = tmm._i8_groups_plain(_t(a), _t(np.ascontiguousarray(np.swapaxes(x, 2, 3))),
                              "right").numpy()
    np.testing.assert_array_equal(yr, np.swapaxes(acc, 1, 2))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    a = torch.zeros((3, 8, 128), dtype=torch.int8)
    x = torch.zeros((3, 1, 128, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA device"):
        tmm._i8_groups_cuda(a, x, "left")
    with pytest.raises(ValueError, match="CUDA device"):
        tmm._i8_groups(a.to("meta"), x.to("meta"), "left")


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build fails loudly, before writing any library."""
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()
    assert not list(tmp_path.glob("*.so"))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_library_path_follows_sources_and_headers(monkeypatch, tmp_path):
    """The library's name hashes every csrc/*.cu and csrc/*.cuh, so an
    edited shared header rebuilds instead of loading a stale library
    (checked on a copy of csrc; no nvcc needed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh"))
    monkeypatch.setattr(_build, "_CSRC", csrc)
    first = _build.library_path()
    assert _build.library_path() == first
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build.library_path()
    assert second != first
    src = next(csrc.glob("*.cu"))
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path() not in (first, second)


# (layout, M, K, B, R): chip_smoke.py's main-path and ragged shapes
KERNEL_PATH_SHAPES = [
    ("left", 540, 2160, 3, 3840), ("left", 2160, 540, 3, 960),
    ("right", 960, 3840, 1, 1620), ("right", 3840, 960, 1, 6480),
    ("right", 256, 4096, 1, 8040), ("right", 4096, 256, 1, 8040),
    ("left", 77, 300, 2, 45), ("right", 77, 300, 2, 45), ("left", 5, 1, 1, 3),
]


@pytest.mark.parametrize("layout,m,k,b,r", KERNEL_PATH_SHAPES)
def test_x_staging_rule_at_the_kernel_shapes(layout, m, k, b, r):
    """TMA reads x in place only where its rows are 16-byte strided: every
    right contraction of the main paths; the left layout and ragged K
    take the staging pass into a zero-padded K-major buffer."""
    pitch = tmm._x_staging_pitch(layout, k, 1 << 20)
    if layout == "right" and k % 16 == 0:
        assert pitch is None
        assert tmm._x_staging_pitch(layout, k, (1 << 20) + 8) == tmm.ceil_to(k, 16)
    else:
        assert pitch % 16 == 0 and k <= pitch < k + 16
    # A's padded length is a multiple of 128, so the kernel's 128-byte
    # k-stages never read past a row of A
    assert tmm.ceil_to(k, 128) % 128 == 0 and tmm.ceil_to(k, 128) >= tmm.ceil_to(k, 16)


@pytest.mark.parametrize("layout,m,k,b,r", KERNEL_PATH_SHAPES[:6])
def test_kernel_tiles_fill_the_card_at_the_main_path_shapes(layout, m, k, b, r):
    """The kernel's fixed 128 x 64 output tile gives every main-path
    contraction at least one wave of blocks on the H100's 132 SMs, so no
    shape needs a split of K across blocks."""
    tm, tr = tmm.KERNEL_TILE
    assert -(-m // tm) * -(-r // tr) * b >= 132


@pytest.mark.parametrize("ndig", [3, 4])
@pytest.mark.parametrize("layout,k", [("left", 300), ("right", 300), ("left", 1), ("right", 48)])
def test_padded_stages_equal_the_plain_version(ndig, layout, k):
    """The kernel's data flow on the CPU: x staged K-major at a pitch of
    K rounded to 16 with zero padding, A read over 128-byte stages to its
    padded length whatever that padding holds, the int32 group sums
    combined in the kernel's order.  Equal to the plain version bit for
    bit, which ignores A's padding."""
    rng = np.random.default_rng(ndig + k)
    m, b, r = 9, 2, 5
    kp = tmm.ceil_to(k, 128)
    a = rng.integers(-64, 65, (ndig, m, kp)).astype(np.int8)
    a[:, :, k:] = rng.integers(-128, 128, (ndig, m, kp - k))  # padding that is not zero
    xshape = (ndig, b, k, r) if layout == "left" else (ndig, b, r, k)
    x = rng.integers(-64, 65, xshape).astype(np.int8)
    pitch = tmm._x_staging_pitch(layout, k, 1 << 20) or k
    xk = np.zeros((ndig, b, r, kp), np.int64)    # TMA's zero fill past the pitch
    xk[..., :k] = np.swapaxes(x, 2, 3) if layout == "left" else x
    assert not xk[..., k:pitch].any()
    acc = None
    for g in range(ndig):
        s = np.zeros((b, m, r), np.int64)
        for k0 in range(0, kp, 128):                 # one shared-memory stage
            for i in range(g + 1):
                s += np.einsum("mk,brk->bmr", a[i, :, k0:k0 + 128].astype(np.int64),
                               xk[g - i, :, :, k0:k0 + 128])
        assert np.abs(s).max() < 2**31
        t = s.astype(np.float32) * np.float32(tmm._W[g])
        acc = t if acc is None else acc + t
    if layout == "right":
        acc = np.swapaxes(acc, 1, 2)
    np.testing.assert_array_equal(tmm._i8_groups_plain(_t(a), _t(x), layout).numpy(), acc)
