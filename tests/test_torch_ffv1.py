"""The port's FFV1 codec (``dspfun_tpu_torch/io/ffv1.py`` on its own
build of ``native/ffv1.cpp``) against the JAX package's.

* Every case of ``tests/test_ffv1.py`` runs on the port's modules
  (``tests/torch_port_cases.py``), the pure-Python RFC 9043 reference
  decoder ``tests/ffv1_pyref.py`` and the one that routes a file the
  native decoder rejects to the ffmpeg bridge included.
* The range coder is integer arithmetic: the port's encoder writes the
  JAX package's bytes for the same planes, at levels 1 and 3, and each
  decoder decodes the other's packets to equal planes.
"""

import numpy as np
import pytest

import tests.test_ffv1 as jffv1_tests
from dspfun_tpu.io import ffv1 as jffv1
from dspfun_tpu.io import video as jvideo
from dspfun_tpu_torch import _hostbuild
from dspfun_tpu_torch.io import ffv1 as tffv1
from dspfun_tpu_torch.io import video as tvideo
from tests import ffv1_pyref
from tests.torch_port_cases import port_cases, run_on_port

SKIP: dict = {}


@pytest.mark.parametrize("case", port_cases(jffv1_tests, SKIP))
def test_jax_ffv1_case_on_the_port(case, request):
    run_on_port(request, jffv1_tests, *case)


@pytest.mark.parametrize("name,size,options", [
    ("yuv420p", (33, 17), None), ("gray", (20, 12), None), ("yuv444p16le", (9, 7), None),
    ("gbrp", (16, 10), None), ("yuv422p10le", (24, 8), None), ("gbrp16le", (32, 16), None),
    ("yuv420p", (64, 48), "level=3:slices=4"), ("gray", (40, 30), "level=3"),
])
def test_encoder_bytes_equal_jax_and_decoders_agree(name, size, options):
    w, h = size
    tpf, jpf = tvideo.PIXEL_FORMATS[name], jvideo.PIXEL_FORMATS[name]
    rng = np.random.default_rng(7)
    frames = [[rng.integers(0, 1 << tpf.depth, (ph, pw)).astype(tpf.dtype)
               for pw, ph in tpf.plane_dims(w, h)] for _ in range(3)]
    tenc = tffv1.FFV1Encoder(tpf, w, h, options)
    jenc = jffv1.FFV1Encoder(jpf, w, h, options)
    assert tenc.extradata == jenc.extradata
    tdec = tffv1.FFV1Decoder(w, h, extradata=tenc.extradata or None)
    jdec = jffv1.FFV1Decoder(w, h, extradata=jenc.extradata or None)
    for planes in frames:
        pkt = tenc.encode(planes)
        assert pkt == jenc.encode(planes)
        got = tdec.decode(pkt)
        for a, b, c in zip(planes, got, jdec.decode(pkt)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)
    tdec.close()
    jdec.close()


def test_python_reference_decodes_the_port_encoder():
    """The RFC 9043 reference decoder in pure Python reads the port's
    version-1 keyframes back to the planes."""
    pf = tvideo.PIXEL_FORMATS["yuv420p"]
    rng = np.random.default_rng(8)
    planes = [rng.integers(0, 256, (ph, pw)).astype(np.uint8) for pw, ph in pf.plane_dims(12, 10)]
    pkt = tffv1.encode_frame(planes, tffv1.params_for_pix_fmt(pf), 12, 10)
    _, got = ffv1_pyref.decode_keyframe(pkt, 12, 10)
    for a, b in zip(planes, got):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_the_library_builds_from_the_package_copy():
    """libffv1 comes from dspfun_tpu_torch/native/ffv1.cpp into
    build/native/, named by its source and flags; the copy equals the
    JAX package's source."""
    root = _hostbuild.build_dir().parent.parent
    src = root / "dspfun_tpu_torch" / "native" / "ffv1.cpp"
    assert src.read_bytes() == (root / "native" / "ffv1.cpp").read_bytes()
    lib = _hostbuild.library_path("ffv1")
    tffv1._load()
    assert lib.is_file() and lib.parent == root / "build" / "native"
    assert "-ffast-math" not in _hostbuild.CXX_FLAGS
