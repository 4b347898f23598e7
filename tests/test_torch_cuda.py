"""The port on a CUDA card: the hand-written int8 kernel against its plain
version, and the card's chains against the CPU's and a float64 oracle.

Every test here needs a card and skips without one.  The machine with the
card has no JAX, so this file imports none; run it there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the kernel is bit-equal to its plain version (integer group
sums are exact, the weights are powers of two); a contraction on the card
is bit-equal to the same one on the CPU (every step is exact or a single
IEEE rounding in the same order); chains hold 1e-5 against float64.
"""

import numpy as np
import pytest
import scipy.fft
import torch

from dspfun_tpu_torch.core.basis import dct2_matrix, dct3_matrix
from dspfun_tpu_torch.core.exact import exact_contract, split_matrix_digits
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.models import fused
from dspfun_tpu_torch.models.spec_pipeline import (
    SpecChainParams, spec_forward, spec_inverse,
)
from dspfun_tpu_torch.ops import int8mm as tmm

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
    ("left", 540, 2160, 3, 384), ("right", 960, 3840, 1, 162),
    ("left", 77, 300, 2, 45), ("right", 77, 300, 2, 45),
    ("left", 5, 1, 1, 3), ("right", 64, 32, 1, 64),
])
def test_kernel_bit_equal_to_plain(cuda, ndig, layout, m, k, b, r):
    g = torch.Generator(device=cuda).manual_seed(ndig * 1000 + m)
    kp = tmm.ceil_to(k, 128)
    a = _digits(g, (ndig, m, kp), cuda)
    a[:, :, k:] = 0  # the plan's zero padding of K
    x = _digits(g, (ndig, b, k, r) if layout == "left" else (ndig, b, r, k), cuda)
    before = tmm.LAUNCHES[f"{layout}{ndig}"]
    y = tmm._i8_groups(a, x, layout)
    assert tmm.LAUNCHES[f"{layout}{ndig}"] == before + 1
    ref = tmm._i8_groups_plain(a, x, layout)
    torch.cuda.synchronize()
    assert torch.equal(y, ref)


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
