"""The port's OpenCV input fallback (``dspfun_tpu_torch/io/cv2_bridge.py``)
against ``dspfun_tpu/io/cv2_bridge.py``: files a real libavformat wrote
(cv2.VideoWriter: MJPG in Matroska, mp4v in MP4, an FFV1 gray clip),
opened by both packages' ``open_input`` with no ffmpeg binary on PATH,
give the same reader (8-bit ``gbrp``, rate and count from cv2) and the
same frames, raw and normalised; the error paths give the same texts.
Skipped where cv2 is absent.
"""

from fractions import Fraction

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dspfun_tpu.io import cv2_bridge as jcv2  # noqa: E402
from dspfun_tpu.io import video as jvideo  # noqa: E402
from dspfun_tpu_torch.io import cv2_bridge as tcv2  # noqa: E402
from dspfun_tpu_torch.io import video as tvideo  # noqa: E402
from tests.torch_port_cases import hide_ffmpeg  # noqa: E402


def _write(path, fourcc, n=4, size=(24, 16), rate=25, color=True):
    rng = np.random.default_rng(len(fourcc) + n)
    wr = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), rate,
                         size, isColor=color)
    assert wr.isOpened()
    for _ in range(n):
        f = rng.integers(0, 256, (size[1], size[0], 3) if color else size[::-1], np.uint8)
        wr.write(f)
    wr.release()


@pytest.mark.parametrize("name,fourcc,rate", [("m.mkv", "MJPG", 25), ("v.mp4", "mp4v", 30),
                                              ("g.avi", "MJPG", 24)])
def test_both_packages_decode_the_same_frames(name, fourcc, rate, tmp_path, monkeypatch):
    hide_ffmpeg(monkeypatch)
    path = tmp_path / name
    _write(path, fourcc, rate=rate)
    assert tcv2.available() == jcv2.available() is True
    with tvideo.open_input(str(path)) as t, jvideo.open_input(str(path)) as j:
        assert (type(t).__name__, t.format) == (type(j).__name__, j.format) == ("_Cv2Reader",
                                                                                 "opencv")
        assert (t.width, t.height, t.rate, t.frames, t.pix_fmt.name) == \
            (j.width, j.height, j.rate, j.frames, j.pix_fmt.name)
        assert t.rate == Fraction(rate) and vars(t.props) == vars(j.props)
        n = 0
        while (a := t.read_frame(raw=n % 2 == 0)) is not None:
            b = j.read_frame(raw=n % 2 == 0)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            n += 1
        assert j.read_frame() is None and n == 4


def test_errors_match(tmp_path, monkeypatch):
    hide_ffmpeg(monkeypatch)
    bad = tmp_path / "x.mp4"
    bad.write_bytes(b"\0\0\0\x18ftypmp42 but nothing else")
    errs = []
    for mod, cv in ((jvideo, jcv2), (tvideo, tcv2)):
        with pytest.raises(ValueError) as e:
            cv.open_cv2_input(str(bad))
        errs.append(str(e.value))
        with pytest.raises(RuntimeError, match="requires an ffmpeg binary") as e:
            mod.open_input(str(bad))
        errs.append(str(e.value))
    assert errs[0] == errs[2] and errs[1] == errs[3]
