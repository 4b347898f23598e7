"""The port's fvid and image-sequence containers, ``append=``, the
``--ff-opts`` split and the device packer against the JAX package's.

Container bytes are held to **equality** (fvid and y4m streams, resumed
streams, PNG sequences decoded to pixels); the packer's payloads to the
JAX packer's and to the host writers' but for <= 1 level at exact .5
boundaries, as tests/test_device_pack.py allows.  Files read through
``NativeBackedReader`` by default, as in the JAX package.  The ffmpeg
bridge's containers and encoders and ``ffplay:`` open and fail as in the
JAX package, with ffmpeg hidden and under the shim binaries.
"""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from dspfun_tpu.io import images as jimages
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.io.device_pack import make_packer as jmake_packer
from dspfun_tpu_torch.io import images as timages
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.io.device_pack import make_packer as tmake_packer
from dspfun_tpu_torch.utils import checkpoint as tcheckpoint
from dspfun_tpu.utils import checkpoint as jcheckpoint
from tests.torch_port_cases import clear_ffmpeg_caches, hide_ffmpeg, use_shims


@pytest.mark.parametrize("opts", [None, "", "pixel_format=yuv420p", "level=3:pixel_format=gray",
                                  "slices=4,color_range=pc|negotiate=1", "colorspace=bt709:slicecrc=1:",
                                  "negotiate", " level = 1 :color_trc=linear"])
def test_split_codec_opts_equal(opts):
    assert tvideo.split_codec_opts(opts) == jvideo.split_codec_opts(opts)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3))


@pytest.mark.parametrize("req", [None, "gbrpf32le", "grayf32le", "yuv444pf32", "gray", "yuv420p", "gbrp"])
def test_fvid_stream_bytes_equal_and_read_back(req, tmp_path):
    """The same frames through both packages' ``open_output`` to .fvid:
    files equal; both readers return the same planes from either file."""
    frames = _frames(3, 9, 14)
    paths = []
    for mod, name in ((jvideo, "j.fvid"), (tvideo, "t.fvid")):
        props = mod.ColorProps(pix_fmt=req, color_range="jpeg", color_trc="iec61966-2-1",
                               sample_aspect="4:3")
        w = mod.open_output(str(tmp_path / name), 14, 9, Fraction(30000, 1001), props)
        assert w.format == "fvid" and w.supports_payload() and w.pix_fmt.is_float
        w.write_frame_rgb(frames[0])
        w.write_frame(mod.rgb_to_planes(frames[1], w.pix_fmt, w.props))
        w.write_frame_payload(b"".join(
            np.asarray(p, "<f4").tobytes() for p in mod.rgb_to_planes(frames[2], w.pix_fmt, w.props)))
        assert w.frame_index == 3
        w.close()
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    jr = jvideo.open_input(str(paths[1]), native=False)
    tr = tvideo.open_input(str(paths[0]), native=False)
    assert isinstance(tr, tvideo.FvidReader) and tr.format == "fvid" and tr.frames == jr.frames == 3
    assert (tr.width, tr.height, tr.rate, tr.pix_fmt.name) == (jr.width, jr.height, jr.rate, jr.pix_fmt.name)
    assert vars(tr.props) == vars(jr.props)
    for _ in range(3):
        for a, b in zip(jr.read_frame(), tr.read_frame()):
            np.testing.assert_array_equal(a, b)
    assert tr.read_frame() is None
    tr.close()
    jr.close()
    # a file reads through the host library by default, as in the JAX package
    with tvideo.open_input(str(paths[0])) as nr, jvideo.open_input(str(paths[1])) as njr:
        assert isinstance(nr, tvideo.NativeBackedReader) and nr.format == "fvid"
        assert type(njr).__name__ == "NativeBackedReader"
        for _ in range(3):
            for a, b in zip(njr.read_frame(), nr.read_frame()):
                np.testing.assert_array_equal(a, b)
    # fvid under a foreign extension opens by its magic bytes
    other = tmp_path / "clip.bin"
    other.write_bytes(paths[1].read_bytes())
    assert isinstance(tvideo.open_input(str(other), native=False), tvideo.FvidReader)
    assert tvideo.open_input(str(other)).format == "fvid"
    np.testing.assert_array_equal(tvideo.open_input(str(other)).read_frame_rgb(),
                                  jvideo.open_input(str(other), native=False).read_frame_rgb())


@pytest.mark.parametrize("ext,req", [("y4m", "yuv444p"), ("y4m", "yuv420p16le"), ("fvid", None)])
def test_append_continues_a_stream_like_jax(ext, req, tmp_path):
    frames = _frames(4, 8, 10, 1)
    out = []
    for mod, name in ((jvideo, f"j.{ext}"), (tvideo, f"t.{ext}")):
        path = str(tmp_path / name)
        for part, append in ((frames[:2], False), (frames[2:], True)):
            w = mod.open_output(path, 10, 8, Fraction(25, 1), mod.ColorProps(pix_fmt=req), append=append)
            for f in part:
                w.write_frame_rgb(f)
            w.close()
        out.append((tmp_path / name).read_bytes())
        # append to a file that is not there yet: a fresh stream with its header
        fresh = str(tmp_path / ("fresh_" + name))
        w = mod.open_output(fresh, 10, 8, Fraction(25, 1), mod.ColorProps(pix_fmt=req), append=True)
        w.write_frame_rgb(frames[0])
        w.close()
        out.append(open(fresh, "rb").read())
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0].count(b"FRAME\n") >= 4 and out[0].count(b"\n", 0, 200) >= 1
    r = tvideo.open_input(str(tmp_path / f"t.{ext}"))
    assert r.frames == 4


def test_image_sequence_writer_and_append(tmp_path):
    """``frame%03d.png`` and a single ``.png`` through ``ImageSeqWriter``
    on the port's PNG codec: the pixels the JAX package's writer stores;
    ``append`` goes on numbering after the last frame."""
    frames = _frames(3, 7, 9, 2) * 1.2 - 0.1          # out of range: clipped
    for mod, sub in ((jvideo, "j"), (tvideo, "t")):
        d = tmp_path / sub
        d.mkdir()
        w = mod.open_output(str(d / "f%03d.png"), 9, 7)
        assert w.format == "image2" and not w.supports_payload()
        w.write_frame_rgb(frames[0])
        w.write_frame([frames[1][..., 1], frames[1][..., 2], frames[1][..., 0]])
        w.close()
        w = mod.open_output(str(d / "f%03d.png"), 9, 7, append=True)
        assert w.frame_index == 2
        w.write_frame_rgb(frames[2])
        w.close()
        one = mod.open_output(str(d / "one.png"), 9, 7)
        one.write_frame_rgb(frames[0])
        with pytest.raises(RuntimeError, match="one"):
            one.write_frame_rgb(frames[1])
        assert mod.open_output(str(d / "one.png"), 9, 7, append=True).frame_index == 1
    for k in range(3):
        a = jimages.read_image(str(tmp_path / "j" / f"f{k:03d}.png"))
        b = timages.read_image(str(tmp_path / "t" / f"f{k:03d}.png"))
        np.testing.assert_array_equal(a.pixels, b.pixels)
        np.testing.assert_array_equal(
            b.pixels, np.rint(np.clip(frames[k], 0, 1) * 255) / 255)
    assert not (tmp_path / "t" / "f003.png").exists()


@pytest.mark.parametrize("spec,fmt,want", [
    ("o.y4m", None, "y4m"), ("o.fvid", None, "fvid"), ("f%04d.png", None, "image2"),
    ("o.png", None, "image2"), ("-", None, "y4m"), ("pipe:1", None, "y4m"), ("noext", None, "y4m"),
    ("o.bin", "fvid", "fvid"), ("o.bin", "yuv4mpegpipe", "y4m"), ("o.png", "image2", "image2"),
])
def test_output_format_follows_the_jax_sniffer(spec, fmt, want):
    j = jvideo._sniff_format(spec, fmt, for_output=True)
    assert tvideo.check_output(spec, fmt) == want == ("y4m" if j == "pipe" else j)


@pytest.mark.parametrize("spec,fmt", [("o.webm", None), ("-", "matroska"), ("o.mp4", None),
                                      ("ffplay:", None), ("ffplay:x", None), ("o.nut", "mp4"),
                                      ("o.y4m", "matroska"), ("f%02d.jpg", None), ("o.jpg", None)])
def test_unported_targets_are_refused(spec, fmt, tmp_path, monkeypatch):
    """The targets the port once refused (ROADMAP items 13 and 8) open as
    in the JAX package: with ffmpeg hidden, the same error or the same
    writer; under the shim binaries (file targets), the same ffmpeg or
    ffplay argv and the same bytes for one written frame."""
    def run(mod, d):
        target = spec if ":" in spec or spec == "-" else str(d / spec)
        try:
            w = mod.open_output(target, 8, 8, format=fmt,
                                props=mod.ColorProps(pix_fmt="yuv420p"))
        except (RuntimeError, ValueError) as e:
            return type(e).__name__, str(e).replace(str(d), "D")
        w.write_frame([np.full((8, 8), 0.25), np.full((4, 4), 0.5), np.full((4, 4), 0.5)])
        w.close()
        return type(w).__name__, sorted((p.name, p.read_bytes()) for p in d.iterdir()
                                        if p.name != "bin" and p.name != "shim.log")

    for shims in (False, True):
        if shims and (spec == "-" or spec.startswith("f%")):
            continue  # the shim would write a file named "-"; sequences need no binary
        got = {}
        for name, mod in (("jax", jvideo), ("torch", tvideo)):
            d = tmp_path / f"{name}{int(shims)}"
            d.mkdir()
            with monkeypatch.context() as mp:
                mp.chdir(d)
                log = use_shims(mp, str(d)) if shims else hide_ffmpeg(mp)
                res = run(mod, d)
                clear_ffmpeg_caches()
            argvs = sorted(open(log).read().replace(str(d), "D").splitlines()) \
                if shims and os.path.exists(log) else []
            got[name] = (res, argvs)
        assert got["torch"] == got["jax"]


def test_unported_inputs_are_refused(tmp_path, monkeypatch):
    """Inputs the port once refused (ROADMAP item 13): garbage NUT,
    Matroska and mp4 go to the bridge and fail as in the JAX package, with
    ffmpeg hidden (the same error texts) and under the shims."""
    (tmp_path / "a.nut").write_bytes(b"nut/multimedia container\0")
    (tmp_path / "a.mkv").write_bytes(b"\x1a\x45\xdf\xa3rest")
    (tmp_path / "a.mp4").write_bytes(b"\0\0\0\x18ftypmp42")
    for shims in (False, True):
        with monkeypatch.context() as mp:
            if shims:
                use_shims(mp, str(tmp_path / "sh"))
            else:
                hide_ffmpeg(mp)
            for name, fmt in [("a.nut", None), ("a.mkv", None), ("a.mp4", None),
                              ("a.nut", "y4m")]:
                got = []
                for mod in (jvideo, tvideo):
                    try:
                        with mod.open_input(str(tmp_path / name), fmt) as r:
                            got.append(("read", r.read_frame(raw=True) is None))
                    except (RuntimeError, ValueError) as e:
                        got.append((type(e).__name__, str(e)))
                assert got[0] == got[1], (shims, name, fmt)
            clear_ffmpeg_caches()


PACK_CASES = [("yuv444p", "mpeg"), ("yuv444p", "jpeg"), ("yuv420p", "mpeg"), ("yuv422p", "jpeg"),
              ("gray", "jpeg"), ("gray", "mpeg"), ("yuv444p16le", "mpeg"), ("yuv420p10le", "jpeg"),
              ("gray16le", "jpeg"), ("gbrpf32le", "jpeg"), ("grayf32le", "jpeg")]


@pytest.mark.parametrize("fmt,range_", PACK_CASES)
@pytest.mark.parametrize("space", [None, "bt709"])
def test_packer_payload_against_jax_and_host_writer(fmt, range_, space):
    h, w = 11, 15                                   # odd: the chroma planes pad by edge
    frames = _frames(3, h, w, 3).astype(np.float32)
    jprops = jvideo.ColorProps(pix_fmt=fmt, color_range=range_, color_space=space)
    tprops = tvideo.ColorProps(pix_fmt=fmt, color_range=range_, color_space=space)
    pf = tvideo.PIXEL_FORMATS[fmt]
    jp = jmake_packer(jvideo.PIXEL_FORMATS[fmt], jprops, h, w)
    tp = tmake_packer(pf, tprops, h, w)
    got = tp(torch.from_numpy(frames))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, pf.frame_bytes(w, h))
    want = np.asarray(jp(frames))
    for k in range(3):
        g = np.frombuffer(got[k].numpy().tobytes(), pf.dtype).astype(np.float64)
        j = np.frombuffer(want[k].tobytes(), pf.dtype).astype(np.float64)
        host = np.frombuffer(b"".join(
            tvideo._quantize_plane(p, pf, i, range_).tobytes()
            for i, p in enumerate(tvideo.rgb_to_planes(frames[k].astype(np.float64), pf, tprops))),
            pf.dtype).astype(np.float64)
        assert g.shape == j.shape == host.shape
        if pf.is_float:
            # float32 luma sums: XLA may fuse a product into its sum, two ulps at 1.0
            assert np.max(np.abs(g - j)) <= 2.0**-22 and np.max(np.abs(g - host)) <= 2.0**-22
        else:
            for ref in (j, host):
                assert np.max(np.abs(g - ref)) <= 1 and np.mean(g != ref) < 0.02


def test_packer_formats_without_a_packed_path():
    for fmt in ("yuv444pf32", "gbrp", "gbrp16le"):
        pf = tvideo.PIXEL_FORMATS[fmt]
        assert tmake_packer(pf, tvideo.ColorProps(pix_fmt=fmt), 8, 8) is None
        assert jmake_packer(jvideo.PIXEL_FORMATS[fmt], jvideo.ColorProps(pix_fmt=fmt), 8, 8) is None


def test_packed_payload_is_a_frame_of_the_stream(tmp_path):
    """A payload written with ``write_frame_payload`` reads back as the
    frame the host path would have written (one level)."""
    frames = _frames(2, 8, 12, 4).astype(np.float32)
    w = tvideo.open_output(str(tmp_path / "p.y4m"), 12, 8, Fraction(20, 1),
                           tvideo.ColorProps(pix_fmt="gbrpf32le", color_range="jpeg"))
    assert w.pix_fmt.name == "yuv444p"
    pk = tmake_packer(w.pix_fmt, w.props, 8, 12)
    payload = pk(torch.from_numpy(frames)).numpy()
    for k in range(2):
        w.write_frame_payload(payload[k].tobytes())
    w.close()
    h = tvideo.open_output(str(tmp_path / "h.y4m"), 12, 8, Fraction(20, 1),
                           tvideo.ColorProps(pix_fmt="gbrpf32le", color_range="jpeg"))
    for k in range(2):
        h.write_frame_rgb(frames[k].astype(np.float64))
    h.close()
    a, b = (tmp_path / "p.y4m").read_bytes(), (tmp_path / "h.y4m").read_bytes()
    assert len(a) == len(b) and a[:a.index(b"\n")] == b[:b.index(b"\n")]
    d = np.abs(np.frombuffer(a, np.uint8).astype(int) - np.frombuffer(b, np.uint8).astype(int))
    assert d.max() <= 1 and np.mean(d > 0) < 0.02


def test_checkpoint_state_files_are_the_jax_packages(tmp_path):
    p = str(tmp_path / "state.json")
    assert tcheckpoint.load_state(p) == {} == jcheckpoint.load_state(p)
    tcheckpoint.save_state(p, {"cfg": [1, "a", 2.5], "frame": 7})
    assert jcheckpoint.load_state(p) == tcheckpoint.load_state(p) == {"cfg": [1, "a", 2.5], "frame": 7}
    jcheckpoint.save_state(p, {"frame": 9})
    assert tcheckpoint.load_state(p) == {"frame": 9}
    (tmp_path / "bad.json").write_text("{not json")
    assert tcheckpoint.load_state(str(tmp_path / "bad.json")) == {}
    assert tcheckpoint.load_state("") == {}
