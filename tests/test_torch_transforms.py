"""dspfun_tpu_torch.core (basis, precision, exact, transforms) against
dspfun_tpu.core.

Tolerances: the copied basis builders, the host digit splits and the
plans are bit-equal; the exact contraction is bit-equal (every product
and sum is exact, and the TwoSum combination runs in the same order);
single contractions in f32/hilo differ only by float32 summation order
(PyTorch's CPU matmul vs XLA's), bounded at 2^-20 of the output range.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.core import basis as jbasis
from dspfun_tpu.core import exact as jexact
from dspfun_tpu.core import precision as jprec
from dspfun_tpu.core import transforms as jtr
from dspfun_tpu_torch.convert import axis_plan_from_jax
from dspfun_tpu_torch.core import basis as tbasis
from dspfun_tpu_torch.core import exact as texact
from dspfun_tpu_torch.core import precision as tprec
from dspfun_tpu_torch.core import transforms as ttr
from dspfun_tpu_torch.ops import int8mm as tmm

MODES = ["f32", "hilo", "exact", "exact@1e-5", "i8", "i8@1e-5", "f64"]


def _np(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _plan_equal(pt, pj):
    for ft, fj in zip(pt, pj):
        if fj is None:
            assert ft is None
            continue
        np.testing.assert_array_equal(_np(ft), np.asarray(fj, np.float64)
                                      if ft.dtype == torch.bfloat16 else np.asarray(fj))


@pytest.mark.parametrize("n", [1, 8, 255, 256, 300, 1000])
def test_dct_matrices_bit_equal(n):
    np.testing.assert_array_equal(tbasis.dct2_matrix(n), jbasis.dct2_matrix(n))
    np.testing.assert_array_equal(tbasis.dct3_matrix(n), jbasis.dct3_matrix(n))


@pytest.mark.parametrize("spec", ["", "f32", "hilo", "bf16:f32", "f64:f64",
                                  "exact@1e-5", "i8@1e-5", "i8", "F", "D", "L"])
def test_precision_parse_matches_jax(spec):
    if spec in ("F", "D", "L"):
        pj, pt = jprec.Precision.from_letters(spec, spec), \
            tprec.Precision.from_letters(spec, spec)
    else:
        pj, pt = jprec.Precision.parse(spec), tprec.Precision.parse(spec)
    assert (pt.intermediate, pt.tol) == (pj.intermediate, pj.tol)
    assert str(pt.coeff_dtype).removeprefix("torch.") == str(pj.coeff_dtype)
    assert str(pt.basis_dtype).removeprefix("torch.") == str(pj.basis_dtype)


def test_precision_policy_and_fp32_pins():
    with pytest.raises(ValueError, match="intermediate"):
        tprec.Precision(intermediate="f16")
    with pytest.raises(ValueError, match="tol"):
        tprec.Precision(tol=2.0)
    with pytest.raises(ValueError, match="coeff"):
        tprec.Precision(coeff="int7")
    # float32 contractions never run in TF32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert tprec.tool_default("spec") == tprec.Precision()


def test_apply_tool_default_respects_explicit_choice(monkeypatch):
    monkeypatch.setattr(tprec, "_default", tprec.Precision())
    monkeypatch.setattr(tprec, "_explicit", False)
    tprec.apply_tool_default("spec")
    assert tprec.get_precision() == tprec.Precision()
    tprec.set_precision(tprec.Precision(intermediate="f32"))
    tprec.apply_tool_default("spec")
    assert tprec.get_precision().intermediate == "f32"


def test_true_div_rounds_once():
    x = torch.tensor([1.0, 3.0, 254.0, 1e-30], dtype=torch.float32)
    ref = (x.double() / 255.0).float()
    assert torch.equal(tprec.true_div(x, 255.0), ref)


@pytest.mark.parametrize("tol", [None, 1e-5])
@pytest.mark.parametrize("shape", [(24, 200), (300, 300)])
def test_split_matrix_digits_bit_equal(shape, tol):
    m = np.random.default_rng(2).standard_normal(shape)
    dj, sj = jexact.split_matrix_digits(m, tol=tol)
    dt, st = texact.split_matrix_digits(m, tol=tol)
    assert dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(dt.float().numpy(), np.asarray(dj, np.float32))
    assert st == sj
    assert texact.digit_width(shape[1]) == jexact.digit_width(shape[1])
    assert texact.budget_bits(tol, shape[1]) == jexact.budget_bits(tol, shape[1])


@pytest.mark.parametrize("tol", [None, 1e-5])
@pytest.mark.parametrize("axis,shape", [(0, (300, 20)), (1, (7, 300, 3)),
                                        (2, (3, 4, 300))])
def test_exact_contract_bit_equal(axis, shape, tol):
    k = shape[axis]
    m = jbasis.dct3_matrix(k)
    x = np.random.default_rng(3).random(shape).astype(np.float32) - 0.25
    dj, sj = jexact.split_matrix_digits(m, tol=tol)
    yj = np.asarray(jexact.exact_contract(jnp.asarray(x), jnp.asarray(dj), sj,
                                          axis, tol=tol))
    dt, st = texact.split_matrix_digits(m, tol=tol)
    yt = texact.exact_contract(torch.from_numpy(x), dt, st, axis, tol=tol)
    assert yt.dtype == torch.float32
    np.testing.assert_array_equal(yt.numpy(), yj)


@pytest.mark.parametrize("spec", MODES)
@pytest.mark.parametrize("kind,n", [("dct2", 64), ("dct3", 300)])
def test_plans_bit_equal(spec, kind, n):
    pj = jtr.plan_axis(n, kind, jprec.Precision.parse(spec))
    pt = ttr.plan_axis(n, kind, tprec.Precision.parse(spec), device="cpu")
    _plan_equal(pt, pj)
    # and the converter carries the JAX plan across unchanged
    _plan_equal(axis_plan_from_jax(pj, device="cpu"), pj)


def test_plan_cache_keyed_on_precision_and_device():
    a = ttr.plan_axis(256, "dct2", tprec.Precision(intermediate="i8"), device="cpu")
    b = ttr.plan_axis(256, "dct2", tprec.Precision(intermediate="i8", tol=1e-5), device="cpu")
    c = ttr.plan_axis(256, "dct2", tprec.Precision(intermediate="hilo"), device="cpu")
    assert a.digits.shape[0] == 4 and b.digits.shape[0] == 3
    assert c.digits is None and c.lo is not None
    assert ttr.plan_axis(256, "dct2", tprec.Precision(intermediate="i8"), device="cpu") is a
    assert ttr.plan_axis(256, "dct2", tprec.Precision(intermediate="i8"),
                         device="meta").hi.device.type == "meta"
    with pytest.raises(ValueError):
        ttr.plan_axis(8, "dst2", device="cpu")


def test_i8_plan_falls_back_to_exact_past_int32_bound():
    """Past the exact-int32 bound the i8 plan takes the bf16-digit exact
    mode (same accuracy class); the JAX package also falls back for
    TPU VMEM limits, which the CUDA kernel does not have."""
    k = tmm._kmax(4) + 1
    rng = np.random.default_rng(5)
    m = rng.random((3, k)) - 0.5
    p = tprec.Precision(intermediate="i8", tol=1e-6)
    plan = ttr.plan_matrix(m, p, device="cpu")
    assert plan.digits.dtype == torch.bfloat16
    x = rng.random((k, 2)).astype(np.float32)
    y = ttr.apply_plan(torch.from_numpy(x), plan, 0, p).numpy()
    ref = m @ x.astype(np.float64)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-6
    deep = ttr.plan_matrix(rng.random((64, 7680)), p, device="cpu")
    assert deep.digits.dtype == torch.int8 and deep.digits.shape[0] == 4


@pytest.mark.parametrize("spec", ["f32", "hilo", "exact", "i8", "f64",
                                  "f32@1e-5", "hilo@1e-6"])
@pytest.mark.parametrize("split", [None, "mean", "zero0"])
def test_apply_plan_matches_jax(spec, split):
    """One contraction, K = 300 (past the i8 small-K bypass), with each
    rank-1 split hint."""
    kind = "dct3" if split == "zero0" else "dct2"
    x = np.random.default_rng(6).random((300, 5, 3)).astype(np.float32) + 0.5
    pj, pt = jprec.Precision.parse(spec), tprec.Precision.parse(spec)
    plan = jtr.plan_axis(300, kind, pj)
    yj = np.asarray(jtr.apply_plan(jnp.asarray(x), plan, 0, pj, split=split),
                    np.float64)
    yt = ttr.apply_plan(torch.from_numpy(x), ttr.plan_axis(300, kind, pt, device="cpu"), 0, pt,
                        split=split)
    assert str(yt.dtype).removeprefix("torch.") == str(pj.coeff_dtype)
    yt = yt.numpy().astype(np.float64)
    scale = np.max(np.abs(yj))
    if pt.intermediate in ("exact", "f64") or (pt.intermediate == "i8" and split is None):
        np.testing.assert_array_equal(yt, yj)  # no order-dependent sum
    else:
        assert np.max(np.abs(yt - yj)) <= 2.0**-20 * scale


def test_apply_plan_small_k_bypass_and_helpers():
    """K < 256 on an i8 plan runs the float32 matmul (no kernel), like
    the JAX package; dct2/dct3/apply_matrix/apply_plan_nd and
    uniform_grid agree."""
    p = tprec.Precision(intermediate="i8")
    x = np.random.default_rng(7).random((16, 20)).astype(np.float32)
    before = sum(tmm.LAUNCHES.values())
    yt = ttr.dct2(torch.from_numpy(x), 1, p).numpy()
    yj = np.asarray(jtr.dct2(jnp.asarray(x), 1, jprec.Precision(intermediate="i8")))
    assert sum(tmm.LAUNCHES.values()) == before
    assert np.max(np.abs(yt - yj)) <= 2.0**-20 * np.max(np.abs(yj))
    ph = tprec.Precision()
    back = ttr.dct3(ttr.dct2(torch.from_numpy(x), 0, ph), 0, ph) / 32.0
    assert np.max(np.abs(back.numpy() - x)) <= 1e-6
    nd = ttr.apply_plan_nd(torch.from_numpy(x), [ttr.plan_axis(16, "dct2", ph, device="cpu"),
                                                 ttr.plan_axis(20, "dct2", ph, device="cpu")],
                           (0, 1), ph).numpy()
    ref = tbasis.dct2_matrix(16) @ x.astype(np.float64) @ tbasis.dct2_matrix(20).T
    assert np.max(np.abs(nd - ref)) <= 1e-6 * np.max(np.abs(ref))
    np.testing.assert_array_equal(ttr.uniform_grid((5, 7, 3)), jtr.uniform_grid((5, 7, 3)))
    np.testing.assert_array_equal(ttr.split_hilo(tbasis.dct2_matrix(9))[1],
                                  jtr.split_hilo(jbasis.dct2_matrix(9))[1])


def test_whole_image_precision_upgrade():
    from dspfun_tpu_torch.models.spec_pipeline import _whole_image_precision

    p = tprec.Precision()
    assert _whole_image_precision(p, (255, 4000)) == p
    assert _whole_image_precision(p, (256, 256)) == dataclasses.replace(
        p, intermediate="exact")
    i8 = tprec.Precision(intermediate="i8")
    assert _whole_image_precision(i8, (512, 512)) == i8
