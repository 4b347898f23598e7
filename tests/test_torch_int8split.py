"""dspfun_tpu_torch.ops.int8split and the calibration counterparts
(dspfun_tpu_torch/benchmarks/calib_r3e.py, calib_r3f.py) against the JAX
scripts benchmarks/calib_r3e.py and benchmarks/calib_r3f.py.

The scripts' Pallas kernels run in interpret mode on the CPU: the test
patches ``jax.experimental.pallas.pallas_call`` to pass ``interpret=True``,
records each call's output by kernel name, and loads the scripts from
their files (calib_r3e runs its four probes as it loads).  The port runs
the kernel's plain version here.  Digit splits are exact and integer group
sums are exact in both, so the two agree bit for bit on the scripts' own
inputs and at columns whose max is an exact power of two.

Two limits of JAX's float32 CPU math bound where bit-equality can hold:
``jnp.exp2`` is exact only for small integer exponents (|e| <= 12 here),
so the columns stay in that range; and ``jnp.log2`` rounds a value a few
ulps above a power of two down onto the integer, so at a column max of
2^k (1 + 2^-23) JAX's exponent is one smaller than the exact one the port
takes from the bits.  There the port is held to the digit truncation
bound against float64 instead.  The CUDA kernel is held to the plain
version, bit for bit, on the card by tests/test_torch_cuda.py.
"""

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from dspfun_tpu.core import basis as jbasis
from dspfun_tpu.ops import int8mm as jmm
from dspfun_tpu_torch.benchmarks import calib_r3e, calib_r3f
from dspfun_tpu_torch.ops import int8mm as tmm
from dspfun_tpu_torch.ops import int8split as tsp

ROOT = Path(__file__).resolve().parent.parent
# port probe -> the JAX script's kernel function
JAX_KERNELS = {"dot_computed_int8": "k_dot_ref", "dot_via_int32": "k_dot_ref_i32",
               "redmax_log2": "k_redmax", "full_split": "k_full"}
# calib_r3f at a small shape: K, M, R
SK, SM, SR = 256, 128, 256


@contextlib.contextmanager
def _interpreted():
    """pallas_call in interpret mode; yields kernel name -> last output."""
    outputs = {}
    orig = pl.pallas_call

    def patched(kernel, *args, **kwargs):
        call = orig(kernel, *args, interpret=True, **kwargs)

        def run(*operands):
            out = call(*operands)
            if not isinstance(out, jax.core.Tracer):
                outputs[kernel.__name__] = np.asarray(out)
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", patched)
        yield outputs


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_r3e():
    """The JAX probe script, loaded (and so run) under interpret mode."""
    with _interpreted() as outputs:
        mod = _load("calib_r3e")
    assert set(outputs) == set(JAX_KERNELS.values())
    return mod, dict(outputs)


@pytest.fixture(scope="module")
def jax_r3f():
    return _load("calib_r3f")


def _jax_probe(mod, probe: str, xf: np.ndarray) -> np.ndarray:
    """One JAX probe on the script's a8 and another xf [K, R]."""
    with _interpreted() as outputs:
        mod.run(probe, getattr(mod, JAX_KERNELS[probe]), (mod.a8, jnp.asarray(xf)))
    return outputs[JAX_KERNELS[probe]]


def _jax_r3f(mod, a_digits: np.ndarray, x: np.ndarray, tm: int, tr: int) -> np.ndarray:
    with _interpreted():
        y = mod.make_call(tm, tr, 0)(*(jnp.asarray(p) for p in a_digits), jnp.asarray(x))
    return np.asarray(y)


def _r3f_inputs():
    """The JAX package's own digit planes of the pruned DCT matrix, and
    the port's seeded x, at the small shape."""
    mat = jbasis.dct2_matrix(SK)[:SM]
    dig, rs = jmm.split_matrix_i8(mat)
    _, _, x, _ = calib_r3f.inputs(SK, SM, SR, device="cpu")
    return mat, dig, rs, x.numpy()


def _special_columns(rng) -> np.ndarray:
    """x [K, R] in [-0.45, 0.45) with column maxima that are exact powers
    of two (2^-1 .. 2^3, either sign, e = 0 .. 4), one all-zero column,
    and the rest untouched."""
    x = ((rng.random((SK, SR)) - 0.5) * 0.9).astype(np.float32)
    for c, v in enumerate((0.5, 1.0, 2.0, 8.0, -2.0, -0.5, 4.0, 1.0)):
        x[(37 * c) % SK, c] = v
    x[:, 9] = 0.0
    return x


def test_probe_inputs_are_the_scripts(jax_r3e):
    mod, _ = jax_r3e
    a8, xf = calib_r3e.probe_inputs()
    assert (calib_r3e.M, calib_r3e.K, calib_r3e.R) == (mod.M, mod.K, mod.R)
    np.testing.assert_array_equal(a8, np.asarray(mod.a8))
    np.testing.assert_array_equal(xf, np.asarray(mod.xf))


@pytest.mark.parametrize("probe", list(JAX_KERNELS))
def test_probe_bit_equal_to_jax(jax_r3e, probe):
    _, outputs = jax_r3e
    before = sum(tsp.LAUNCHES.values())
    y = calib_r3e.run_probes("cpu")[probe]
    assert sum(tsp.LAUNCHES.values()) == before  # CPU: no kernel launch
    assert y.dtype == torch.float32 and tuple(y.shape) == (calib_r3e.M, calib_r3e.R)
    np.testing.assert_array_equal(y.numpy(), outputs[JAX_KERNELS[probe]])


@pytest.mark.parametrize("tm,tr", [(64, 128), (128, 256)])
def test_calib_r3f_bit_equal_to_jax(jax_r3f, tm, tr):
    mat, dig, rs, x = _r3f_inputs()
    yj = _jax_r3f(jax_r3f, dig, x, tm, tr)
    yt = calib_r3f.fused(torch.from_numpy(dig), torch.from_numpy(x))
    np.testing.assert_array_equal(yt.numpy(), yj)
    # and the scheme's own accuracy, as the JAX script measures it
    ref = mat @ x.astype(np.float64)
    assert np.max(np.abs(yt.numpy() * rs - ref)) / np.max(np.abs(ref)) <= 1e-5


def test_calib_r3f_inputs_match_the_jax_split():
    """The port's pinned split_matrix_i8 gives the JAX package's digits."""
    mat, dig, rs, x = _r3f_inputs()
    a, trs, tx, tmat = calib_r3f.inputs(SK, SM, SR, device="cpu")
    np.testing.assert_array_equal(a.numpy(), dig)
    np.testing.assert_array_equal(trs.numpy(), rs)
    np.testing.assert_array_equal(tmat.numpy(), mat)
    assert tx.dtype == torch.float32 and tuple(tx.shape) == (SK, SR)


@pytest.mark.parametrize("probe", ["redmax_log2", "full_split"])
def test_power_of_two_column_max_bit_equal_to_jax(jax_r3e, probe):
    mod, _ = jax_r3e
    x = _special_columns(np.random.default_rng(3))
    yj = _jax_probe(mod, probe, x)
    yt = calib_r3e.run_probes("cpu", (np.asarray(mod.a8), x))[probe].numpy()
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(yt[:, 9], 0.0)


def test_power_of_two_column_max_calib_r3f_bit_equal_to_jax(jax_r3f):
    mat, dig, _, _ = _r3f_inputs()
    x = _special_columns(np.random.default_rng(4))
    yj = _jax_r3f(jax_r3f, dig, x, 64, 128)
    yt = calib_r3f.fused(torch.from_numpy(dig), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(yt, yj)
    # at a power-of-two max the leading digit reaches 64, still inside int8
    digits, e = tsp.split_columns(torch.from_numpy(x), 3, "exp")
    assert float(digits[0].abs().max()) == 64.0
    assert e[0, :4].tolist() == [0.0, 1.0, 2.0, 4.0]


def test_ulp_above_power_of_two_within_truncation_bound(jax_r3f):
    """Column maxima 2^k (1 + 2^-23): at these k JAX's float32 log2 lands
    on k, and its exponent is one smaller than the exact rule's k + 2.
    The port follows the exact rule and holds the truncation bound vs
    float64."""
    ks = np.array([-8, -7, -6, 3, 4, 5, 6])
    mx = (2.0 ** ks * (1 + 2.0**-23)).astype(np.float32)
    np.testing.assert_array_equal(np.ceil(np.asarray(jnp.log2(jnp.asarray(mx)))), ks)
    np.testing.assert_array_equal(tsp.col_exponent(torch.from_numpy(mx)).numpy(), ks + 2)

    rng = np.random.default_rng(5)
    x = ((rng.random((SK, SR)) - 0.5) * 0.9).astype(np.float32)
    for c, v in enumerate(mx):
        x[:, c] *= v
        x[(53 * c) % SK, c] = v
    # redmax: |y - 64 a @ x| <= sum_k |a| * 2^(e - 1) (one rounding per digit)
    a8 = calib_r3e.probe_inputs()[0]
    y = calib_r3e.run_probes("cpu", (a8, x))["redmax_log2"].numpy().astype(np.float64)
    e = tsp.col_exponent(torch.from_numpy(np.abs(x).max(axis=0))).numpy()
    ref = 64.0 * (a8.astype(np.float64) @ x.astype(np.float64))
    bound = np.abs(a8).sum(axis=1, keepdims=True) * 2.0 ** (e[None, :] - 1)
    assert np.all(np.abs(y - ref) <= bound)
    # calib_r3f: per k, the dropped digit pairs and both operands' digit
    # truncation are below 2^-21 of rs * 2^e, and the float32 combine
    # rounds by less than that again: |y rs - mat @ x| <= 2 K 2^-21 rs 2^e
    mat, dig, rs, _ = _r3f_inputs()
    y = calib_r3f.fused(torch.from_numpy(dig), torch.from_numpy(x)).numpy()
    got = y.astype(np.float64) * rs
    ref = mat @ x.astype(np.float64)
    assert np.all(np.abs(got - ref) <= 2 * SK * 2.0**-21 * rs * 2.0 ** e[None, :])


def test_col_exponent_is_the_exact_rule():
    """ceil(log2(mx)) + 1 from the bits, against float64 over the domain,
    and against the JAX probes' float32 expression where float32 log2 is
    exact (powers of two 2^-12 .. 2^12 and values off them)."""
    rng = np.random.default_rng(6)
    mx = np.concatenate([2.0 ** np.arange(-126, 125), rng.random(200) * 2.0 ** rng.integers(-120, 120, 200),
                         2.0 ** np.arange(-100, 100, 7) * (1 + 2.0**-23)]).astype(np.float32)
    got = tsp.col_exponent(torch.from_numpy(mx)).numpy()
    want = np.ceil(np.log2(mx.astype(np.float64))) + 1
    np.testing.assert_array_equal(got, want)
    assert float(tsp.col_exponent(torch.zeros(1))) == 0.0
    small = np.concatenate([2.0 ** np.arange(-12, 13), rng.random(50) * 8]).astype(np.float32)
    js = jnp.asarray(small)
    jexp = np.asarray(jnp.where(js > 0, jnp.ceil(jnp.log2(js)) + 1.0, 0.0))
    np.testing.assert_array_equal(tsp.col_exponent(torch.from_numpy(small)).numpy(), jexp)


def test_kernel1_route_differs_only_at_power_of_two_maxima():
    """The fused split and the main path's split before kernel #1 agree
    bit for bit unless a column max is a power of two, where the main
    path's exponent (log2_ceil1) is one larger: that column differs, to
    the truncation bound."""
    mat, dig, rs, x = _r3f_inputs()
    a = torch.from_numpy(dig)
    y1 = calib_r3f.fused(a, torch.from_numpy(x))
    assert torch.equal(y1, calib_r3f.split_then_i8mm(a, torch.from_numpy(x)))
    xs = _special_columns(np.random.default_rng(7))
    y1 = calib_r3f.fused(a, torch.from_numpy(xs)).numpy()
    y2 = calib_r3f.split_then_i8mm(a, torch.from_numpy(xs)).numpy()
    differ = np.flatnonzero(np.any(y1 != y2, axis=0))
    assert set(differ.tolist()) <= set(range(8)) and len(differ) > 0
    # both within the truncation bound of the larger (main path) exponent
    ref = mat @ xs.astype(np.float64)
    e = tmm.log2_ceil1(torch.from_numpy(np.abs(xs).max(axis=0))).numpy()
    for y in (y1, y2):
        assert np.all(np.abs(y * rs - ref) <= 2 * SK * 2.0**-21 * rs * 2.0 ** e[None, :])


def test_guards():
    """The exact-int32 bound, the instance table and the types, shapes and
    devices the kernel takes; the CUDA wrapper never computes on the CPU."""
    assert tsp._kmax(3, "exp") == ((1 << 31) - 1) // (3 << 12) == 174762
    assert tsp._kmax(1, "fixed64") == ((1 << 31) - 1) // (64 * 128)
    a = torch.zeros((3, 4, 256), dtype=torch.int8)
    x = torch.zeros((256, 5))
    kw = dict(xdigits=3, groups=3, scale="exp")
    with pytest.raises(ValueError, match="no instance"):
        tsp.i8_split_contract(a, x, xdigits=3, groups=3, scale="fixed64")
    with pytest.raises(ValueError, match="expected A"):
        tsp.i8_split_contract(a[:2], x, **kw)
    with pytest.raises(TypeError, match="float32"):
        tsp.i8_split_contract(a, x.double(), **kw)
    with pytest.raises(ValueError, match="lda"):
        tsp.i8_split_contract(a, torch.zeros((257, 5)), **kw)
    k = tsp._kmax(3, "exp") + 1
    with pytest.raises(ValueError, match="exact-int32"):
        tsp.i8_split_contract(torch.zeros((3, 1, k), dtype=torch.int8),
                              torch.zeros((k, 1)), **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        tsp._i8_split_cuda(a, x, 3, 3, "exp")
    with pytest.raises(ValueError, match="CUDA device"):
        tsp.i8_split_contract(a.to("meta"), x.to("meta"), **kw)


def test_out_of_domain_column_is_nan():
    """A column max of inf or NaN, or at 2^125 and above, leaves the
    exponent's exact range: the column comes out NaN, never wrong digits."""
    x = np.random.default_rng(8).random((64, 4)).astype(np.float32)
    x[3, 1], x[5, 2], x[7, 3] = np.inf, np.nan, 2.0**126
    a = torch.ones((3, 2, 64), dtype=torch.int8)
    y = tsp.i8_split_contract(a, torch.from_numpy(x), xdigits=3, groups=3,
                              scale="exp").numpy()
    assert np.all(np.isfinite(y[:, 0])) and np.all(np.isnan(y[:, 1:]))


def test_calibration_mains_on_cpu(capsys):
    assert calib_r3e.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device: cpu")
    assert [ln.split(":")[0] for ln in lines[1:]] == list(calib_r3e.PROBES)
    assert all(": OK  sum=" in ln for ln in lines[1:])
    assert calib_r3f.main(["--device", "cpu", "--shape", f"{SK},{SM},{SR}"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[1:]] == ["fused", "split + int8mm", "plain"]
    assert all(float(ln.split("rel=")[1].split()[0]) <= 1e-5 for ln in lines[1:])


@pytest.mark.parametrize("main", [calib_r3e.main, calib_r3f.main])
def test_calibration_mains_default_to_the_card(main, capsys, monkeypatch):
    """Without --device the entry points ask for the card; without one
    they exit non-zero with a message and compute nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        main([])
    assert exit_info.value.code != 0
    captured = capsys.readouterr()
    assert "is_available() is False" in captured.err and "device:" not in captured.out
