"""The port stands alone: it imports no JAX, no Pillow, no zstandard and
no dspfun_tpu (and cv2 only lazily, for the cv2 bridge and the compressed
images),
its entry points run on the card unless told otherwise, an installed
copy ships every file its kernel build reads, its dispatcher lists the
tools it has, and its chip smoke run refuses to run without a CUDA
card."""

import ast
import fnmatch
import io
import json
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from dspfun_tpu_torch.convert import filter_plans_from_jax
from dspfun_tpu_torch.core.precision import Precision
from dspfun_tpu_torch.models import fused

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dspfun_tpu_torch"


def _run(code_or_args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    return subprocess.run([sys.executable, *code_or_args], cwd=kw.get("cwd", ROOT),
                          env=env, capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "sys.modules['cv2'] = None; sys.modules['zstandard'] = None\n"
        "import importlib, pkgutil, dspfun_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dspfun_tpu_torch.__path__,"
        " 'dspfun_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 20
    assert {f"dspfun_tpu_torch.{m}" for m in (
        "ops.blockdct", "ops.block_filter", "io.color", "io.video",
        "models.motion_pipeline", "tools.motion", "ops.int8split",
        "benchmarks.calib_r3e", "benchmarks.calib_r3f", "io.png", "io.images",
        "utils.profiling", "tools._speccli", "tools.spec", "tools.ispec",
        "tools.main", "core.expr", "ops.scan_order", "ops.scan_methods", "ops.speclib",
        "utils.checkpoint", "utils.hostcopy", "io.device_pack", "models.scan_pipeline",
        "models.zoom_pipeline", "tools.scan", "tools.zoom", "models.basis_pipeline",
        "tools._colorspec", "tools.applybasis", "tools.genbasis", "tools.draw", "tools.rotate",
        "tools.transcode", "io.native", "io.ffv1", "io.nut", "io.mkv", "_hostbuild",
        "parallel", "parallel.mesh", "parallel.sharded", "parallel.spec_sharded",
        "parallel.motion_sharded", "parallel.multihost", "io.ffmpeg_bridge", "io.cv2_bridge",
        "io.sixel", "io.imgcodecs", "io.jpeg", "io.gif", "io.quant", "io.webp", "io.rawimg",
        "io.ico", "io.psd", "io.dds", "io.jpeg2000", "io.rasters", "io.icns", "io.blp",
        "io.containers", "io.documents")} <= names


def _blocked(tmp_path, names=("jax", "jaxlib", "dspfun_tpu", "PIL", "zstandard")):
    """A directory that, first on a process's path, makes each of
    ``names`` a package whose import raises (for the process and every
    interpreter it starts)."""
    blocked = tmp_path / "blocked"
    for name in names:
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    return blocked


def test_mesh_ranks_import_no_jax(tmp_path):
    """spec -M 2 and motion --mesh 2 on CPU ranks with jax, Pillow and the
    JAX package unimportable in the tool's process and in every rank it
    spawns (the ranks start fresh interpreters: the block is a package
    of that name on their path that raises)."""
    blocked = _blocked(tmp_path)
    code = (
        "import numpy as np\n"
        "from fractions import Fraction\n"
        "from dspfun_tpu_torch.io import images, video\n"
        "from dspfun_tpu_torch.tools import motion, spec\n"
        "if __name__ == '__main__':\n"
        f"    d = {str(tmp_path)!r}\n"
        "    rng = np.random.default_rng(0)\n"
        "    images.write_image(d + '/s.png', rng.random((12, 10, 3)))\n"
        "    print(spec.main(['--device', 'cpu', '-M', '2', d + '/s.png', d + '/f.png']))\n"
        "    w = video.open_output(d + '/c.y4m', 16, 8, Fraction(25), video.ColorProps(pix_fmt='gray'))\n"
        "    [w.write_frame([rng.integers(0, 256, (8, 16)).astype(np.uint8)], raw=True) for _ in range(2)]\n"
        "    w.close()\n"
        "    print(motion.main(['-Q', '--device', 'cpu', '-b', '8x8x1', '-B', '1.5', '--mesh', '2',\n"
        "                       d + '/c.y4m', d + '/o.y4m']))\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_MESH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0", "0"], res.stderr
    assert "ranks: 2 on cpu over gloo" in res.stderr
    assert (tmp_path / "f.png").exists() and (tmp_path / "o.y4m").exists()


def test_container_modules_need_no_jax_pillow_or_cv2_and_not_the_repos_native(tmp_path):
    """The container stack imports and runs with jax, Pillow, cv2 and the
    JAX package unimportable: a y4m through the host library's reader,
    FFV1 into NUT and Matroska and back, a JPEG through ``io/jpeg.py``,
    and Pillow's progressive JPEG and LZW and PackBits TIFF (written here,
    before the process starts) through ``read_image``, equal to Pillow's
    pixels.  The host libraries it loads are the port's own builds under
    build/native/, never a library of the repo's native/ directory."""
    from PIL import Image

    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    img.save(tmp_path / "p.jpg", progressive=True)
    img.save(tmp_path / "l.tif", compression="tiff_lzw", tiffinfo={317: 2})
    img.save(tmp_path / "b.tif", compression="packbits")
    want = [np.asarray(Image.open(tmp_path / n), np.float64) / 255
            for n in ("p.jpg", "l.tif", "b.tif")]
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from fractions import Fraction\n"
        "from dspfun_tpu_torch.io import video\n"
        f"d = {str(tmp_path)!r}\n"
        "rng = np.random.default_rng(0)\n"
        "w = video.open_output(d + '/c.y4m', 16, 12, Fraction(25), video.ColorProps(pix_fmt='yuv420p'))\n"
        "[w.write_frame_rgb(rng.random((12, 16, 3))) for _ in range(3)]\n"
        "w.close()\n"
        "for ext in ('nut', 'mkv'):\n"
        "    r = video.open_input(d + '/c.y4m')\n"
        "    w = video.open_output(d + '/c.' + ext, 16, 12, r.rate, r.props)\n"
        "    while (f := r.read_frame(raw=True)) is not None:\n"
        "        w.write_frame(f, raw=True)\n"
        "    w.close(); r.close()\n"
        "    print(type(r).__name__, w.codec, video.open_input(d + '/c.' + ext).frames)\n"
        "from dspfun_tpu_torch.io import jpeg\n"
        "a = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)\n"
        "print(jpeg.decode_jpeg(jpeg.encode_jpeg(a))[0].shape)\n"
        "from dspfun_tpu_torch.io import images\n"
        "for n in ('p.jpg', 'l.tif', 'b.tif'):\n"
        "    np.save(d + '/' + n + '.npy', images.read_image(d + '/' + n).pixels)\n"
        "print('\\n'.join(sorted({ln.split()[-1] for ln in open('/proc/self/maps')\n"
        "                         if ln.rstrip().endswith('.so')})))\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[:3] == ["NativeBackedReader ffv1 3"] * 2 + ["(12, 16, 3)"]
    libs = [Path(p) for p in lines[3:]]
    ours = [p for p in libs if p.parent == ROOT / "build" / "native"]
    assert sorted(p.name.split("_")[0] for p in ours) == ["libdspio", "libffv1", "libjpeg",
                                                          "libtiff"]
    assert not [p for p in libs if p.parent == ROOT / "native"]
    for n, ref in zip(("p.jpg", "l.tif", "b.tif"), want):
        np.testing.assert_array_equal(np.load(tmp_path / (n + ".npy")), ref)


def test_cold_build_of_the_tiff_library_while_ffmpeg_is_hidden(tmp_path, monkeypatch):
    """``native/tiff.cpp`` builds into an empty build/native/ while a test
    hides the ffmpeg binaries (g++ is still found), and its decoders run."""
    import shutil

    from dspfun_tpu_torch import _hostbuild
    from tests.torch_port_cases import hide_ffmpeg

    hide_ffmpeg(monkeypatch)
    assert shutil.which("ffmpeg") is None and shutil.which("g++") is not None
    monkeypatch.setattr(_hostbuild, "build_dir", lambda: tmp_path)
    _hostbuild.load_library.cache_clear()
    try:
        lib = _hostbuild.load_library("tiff")
        assert Path(lib._name).parent == tmp_path
        assert [p.name for p in tmp_path.iterdir()] == [_hostbuild.library_path("tiff").name]
        from dspfun_tpu_torch.io import imgcodecs

        assert imgcodecs._tiff_strip(32773, b"\xfd\x07\x01\x09", 5) == b"\x07" * 4 + b"\x09"
    finally:
        _hostbuild.load_library.cache_clear()


def test_jpeg_through_spec_ispec_and_motion_without_jax_pillow_or_cv2(tmp_path):
    """``spec`` then ``ispec`` on a JPEG, and ``motion`` on a ``%02d.jpg``
    sequence, with jax, Pillow, cv2 and the JAX package unimportable: the
    outputs (a spectrum, a JPEG; a y4m, a JPEG sequence) equal those of
    the same runs on PNG and PPM copies of the decoded pixels."""
    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    code = (
        "import sys, numpy as np\n"
        "from dspfun_tpu_torch.io import images\n"
        "from dspfun_tpu_torch.tools import ispec, motion, spec\n"
        f"d = {str(tmp_path)!r} + '/'\n"
        "rng = np.random.default_rng(0)\n"
        "y, x = np.mgrid[0:24, 0:40] / 24.0\n"
        "for k in range(4):\n"
        "    pix = np.stack([0.5 + 0.3 * np.sin(6 * x + k), 0.5 + 0.3 * np.cos(4 * y), 0.3 + 0 * x],"
        " -1) + 0.05 * rng.random((24, 40, 3))\n"
        "    images.write_image(d + f'in{k:02d}.jpg', pix)\n"
        "    images.write_image(d + f'in{k:02d}.ppm', images.read_image(d + f'in{k:02d}.jpg').pixels)\n"
        "images.write_image(d + 'in.png', images.read_image(d + 'in00.jpg').pixels)\n"
        "cpu = ['--device', 'cpu']\n"
        "same = lambda a, b: open(d + a, 'rb').read() == open(d + b, 'rb').read()\n"
        "rcs = [spec.main(cpu + ['-t', 'flat', d + 'in00.jpg', d + 's_j.png']),\n"
        "       spec.main(cpu + ['-t', 'flat', d + 'in.png', d + 's_p.png']),\n"
        "       ispec.main(cpu + ['-t', 'flat', d + 's_j.png', d + 'b_j.jpg']),\n"
        "       ispec.main(cpu + ['-t', 'flat', d + 's_p.png', d + 'b_p.jpg'])]\n"
        "args = cpu + ['-Q', '-b', '8x8x4', '-p', '0x0x0-4x4x2', '-B', '1.25']\n"
        "for src in ('jpg', 'ppm'):\n"
        "    rcs.append(motion.main(args + [d + 'in%02d.' + src, d + 'o_' + src + '.y4m']))\n"
        "    rcs.append(motion.main(args + [d + 'in%02d.' + src, d + 'o_' + src + '%02d.jpg']))\n"
        "print(rcs, same('s_j.png', 's_p.png'), same('b_j.jpg', 'b_p.jpg'),\n"
        "      same('o_jpg.y4m', 'o_ppm.y4m'), all(same(f'o_jpg{k:02d}.jpg', f'o_ppm{k:02d}.jpg')\n"
        "                                         for k in range(4)),\n"
        "      open(d + 'b_j.jpg', 'rb').read()[:2] == b'\\xff\\xd8',\n"
        "      'dspfun_tpu_torch.io.jpeg' in sys.modules)\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[0, 0, 0, 0, 0, 0, 0, 0] True True True True True True", \
        res.stdout + res.stderr


def test_gif_through_spec_ispec_and_motion_without_jax_pillow_or_cv2(tmp_path):
    """``spec`` then ``ispec`` on a GIF, and ``motion`` on a ``%02d.gif``
    sequence, with jax, Pillow, cv2 and the JAX package unimportable: the
    outputs (a spectrum, a GIF; a y4m, a GIF sequence) equal those of the
    same runs on PNG and PPM copies of the decoded pixels, and a sixel is
    written."""
    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    code = (
        "import sys, numpy as np\n"
        "from dspfun_tpu_torch.io import images\n"
        "from dspfun_tpu_torch.tools import ispec, motion, spec\n"
        f"d = {str(tmp_path)!r} + '/'\n"
        "rng = np.random.default_rng(0)\n"
        "y, x = np.mgrid[0:24, 0:40] / 24.0\n"
        "for k in range(4):\n"
        "    pix = np.stack([0.5 + 0.3 * np.sin(6 * x + k), 0.5 + 0.3 * np.cos(4 * y), 0.3 + 0 * x],"
        " -1) + 0.05 * rng.random((24, 40, 3))\n"
        "    images.write_image(d + f'in{k:02d}.gif', pix)\n"
        "    images.write_image(d + f'in{k:02d}.ppm', images.read_image(d + f'in{k:02d}.gif').pixels)\n"
        "images.write_image(d + 'in.png', images.read_image(d + 'in00.gif').pixels)\n"
        "cpu = ['--device', 'cpu']\n"
        "same = lambda a, b: open(d + a, 'rb').read() == open(d + b, 'rb').read()\n"
        "rcs = [spec.main(cpu + ['-t', 'flat', d + 'in00.gif', d + 's_g.png']),\n"
        "       spec.main(cpu + ['-t', 'flat', d + 'in.png', d + 's_p.png']),\n"
        "       ispec.main(cpu + ['-t', 'flat', d + 's_g.png', d + 'b_g.gif']),\n"
        "       ispec.main(cpu + ['-t', 'flat', d + 's_p.png', d + 'b_p.gif']),\n"
        "       ispec.main(cpu + ['-t', 'flat', d + 's_g.png', 'sixel:' + d + 'b.six'])]\n"
        "args = cpu + ['-Q', '-b', '8x8x4', '-p', '0x0x0-4x4x2', '-B', '1.25']\n"
        "for src in ('gif', 'ppm'):\n"
        "    rcs.append(motion.main(args + [d + 'in%02d.' + src, d + 'o_' + src + '.y4m']))\n"
        "    rcs.append(motion.main(args + [d + 'in%02d.' + src, d + 'o_' + src + '%02d.gif']))\n"
        "print(rcs, same('s_g.png', 's_p.png'), same('b_g.gif', 'b_p.gif'),\n"
        "      same('o_gif.y4m', 'o_ppm.y4m'), all(same(f'o_gif{k:02d}.gif', f'o_ppm{k:02d}.gif')\n"
        "                                         for k in range(4)),\n"
        "      open(d + 'b_g.gif', 'rb').read()[:6] == b'GIF87a',\n"
        "      open(d + 'b.six', 'rb').read()[:3] == b'\\x1bPq',\n"
        "      'dspfun_tpu_torch.io.gif' in sys.modules)\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == \
        "[0, 0, 0, 0, 0, 0, 0, 0, 0] True True True True True True True", res.stdout + res.stderr


def test_webp_through_spec_and_motion_without_jax_pillow_or_cv2(tmp_path):
    """``spec`` on a WebP and ``motion`` on a ``%02d.webp`` sequence (the
    96x128 goldens of ``tests/goldens/``: lossy, lossless RGBA, a palette,
    an animation), with jax, Pillow, cv2 and the JAX package unimportable:
    the outputs equal those of the same runs on PNG and PPM copies of the
    decoded pixels, and ``.webp`` output is refused naming item 8f."""
    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    gold = ROOT / "tests" / "goldens"
    names = ["webp_lossy.webp", "webp_lossless_alpha.webp", "webp_palette16.webp",
             "webp_anim.webp"]
    for k, name in enumerate(names):
        (tmp_path / f"in{k:02d}.webp").write_bytes((gold / name).read_bytes())
    code = (
        "import sys\n"
        "from dspfun_tpu_torch.io import images\n"
        "from dspfun_tpu_torch.tools import motion, spec\n"
        f"d = {str(tmp_path)!r} + '/'\n"
        "for k in range(4):\n"
        "    images.write_image(d + f'in{k:02d}.ppm', images.read_image(d + f'in{k:02d}.webp').pixels)\n"
        "images.write_image(d + 'in.png', images.read_image(d + 'in00.webp').pixels)\n"
        "cpu = ['--device', 'cpu']\n"
        "same = lambda a, b: open(d + a, 'rb').read() == open(d + b, 'rb').read()\n"
        "rcs = [spec.main(cpu + ['-t', 'flat', d + 'in00.webp', d + 's_w.png']),\n"
        "       spec.main(cpu + ['-t', 'flat', d + 'in.png', d + 's_p.png'])]\n"
        "args = cpu + ['-Q', '-b', '8x8x4', '-p', '0x0x0-4x4x2', '-B', '1.25']\n"
        "for src in ('webp', 'ppm'):\n"
        "    rcs.append(motion.main(args + [d + 'in%02d.' + src, d + 'o_' + src + '.y4m']))\n"
        "try:\n"
        "    images.write_image(d + 'out.webp', images.read_image(d + 'in.png').pixels)\n"
        "    refused = False\n"
        "except ValueError as e:\n"
        "    refused = 'queue 1, item 8f' in str(e)\n"
        "print(rcs, same('s_w.png', 's_p.png'), same('o_webp.y4m', 'o_ppm.y4m'), refused,\n"
        "      'dspfun_tpu_torch.io.webp' in sys.modules)\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[0, 0, 0, 0] True True True True", res.stdout + res.stderr


def test_other_formats_through_spec_and_motion_without_jax_pillow_or_cv2(tmp_path):
    """With jax, Pillow, cv2 and dspfun_tpu blocked: the TGA, PCX, SGI, QOI,
    IM, ICO and DIB goldens read through the port's own codecs; spec of an
    RLE TGA equals spec of the same pixels as PNG and motion on RLE TGA
    frames equals motion on their PPMs, on the CPU; ispec writes every new
    format, PDF, EPS and JPEG 2000 among them; the rest of item 8h (AVIF)
    is still refused before any write."""
    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    gold = ROOT / "tests" / "goldens"
    names = ["tga_rgba_rle_top.tga", "pcx_4plane.pcx", "sgi_rle_rgb.sgi", "qoi_rgba.qoi",
             "im_l16.im", "ico_bmp8.ico", "dib_p8.dib"]
    for name in names:
        (tmp_path / name).write_bytes((gold / name).read_bytes())
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "from dspfun_tpu_torch.io import images\n"
        "from dspfun_tpu_torch.tools import ispec, motion, spec\n"
        "import torch_codec_fixtures as fx\n"
        "d = %r + '/'\n"
        "depths = [images.read_image(d + n).depth for n in %r]\n"
        "rng = np.random.default_rng(0)\n"
        "for k in range(4):\n"
        "    lv = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)\n"
        "    lv[:, :20] = lv[:, :1]\n"
        "    open(d + f'in{k:02d}.tga', 'wb').write(fx.make_tga(lv[..., ::-1], 10, 24))\n"
        "    images.write_image(d + f'in{k:02d}.ppm', lv / 255.0)\n"
        "images.write_image(d + 'in.png', images.read_image(d + 'in00.tga').pixels)\n"
        "cpu = ['--device', 'cpu']\n"
        "same = lambda a, b: open(d + a, 'rb').read() == open(d + b, 'rb').read()\n"
        "rcs = [spec.main(cpu + ['-t', 'flat', d + 'in00.tga', d + 's_t.png']),\n"
        "       spec.main(cpu + ['-t', 'flat', d + 'in.png', d + 's_p.png'])]\n"
        "for ext in ('tga', 'pcx', 'sgi', 'qoi', 'im', 'ico', 'dib', 'mpo', 'pdf', 'eps',\n"
        "            'jpeg2000'):\n"
        "    rcs.append(ispec.main(cpu + ['-t', 'flat', d + 's_t.png', d + 'back.' + ext]))\n"
        "args = cpu + ['-Q', '-b', '8x8x4', '-p', '0x0x0-4x4x2', '-B', '1.25']\n"
        "for src in ('tga', 'ppm'):\n"
        "    rcs.append(motion.main(args + [d + 'in%%02d.' + src, d + 'o_' + src + '.y4m']))\n"
        "try:\n"
        "    images.write_image(d + 'out.avif', images.read_image(d + 'in.png').pixels)\n"
        "    refused = False\n"
        "except ValueError as e:\n"
        "    refused = 'queue 1, item 8h' in str(e)\n"
        "print(depths, set(rcs), same('s_t.png', 's_p.png'), same('o_tga.y4m', 'o_ppm.y4m'),\n"
        "      refused, 'dspfun_tpu_torch.io.rawimg' in sys.modules)\n"
    ) % (str(ROOT / "tests"), str(tmp_path), names)
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[8, 8, 8, 8, 16, 8, 8] {0} True True True True", \
        res.stdout + res.stderr


def test_g2_containers_and_g1_writes_without_jax_pillow_or_cv2(tmp_path):
    """With jax, Pillow, cv2 and dspfun_tpu blocked: every g2 golden (ICNS,
    BLP, FTEX, FLI, PCD, IPTC) reads through ``io/icns.py``, ``io/blp.py``
    and ``io/containers.py`` to the JAX package's pixels (read here, before
    the process starts), and the ICNS and SPIDER writes are the JAX
    package's bytes; XBM still fails as Pillow fails it."""
    from dspfun_tpu.io import images as jimages
    from tests import torch_codec_fixtures as fx

    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    files = fx.container_fixtures()
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        np.save(tmp_path / f"{name}.npy", jimages.read_image(str(tmp_path / name), "RGBA").pixels)
    pix = np.random.default_rng(5).random((21, 34, 3))
    np.save(tmp_path / "pix.npy", pix)
    for ext in ("icns", "spider"):
        jimages.write_image(str(tmp_path / f"j.{ext}"), pix)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dspfun_tpu_torch.io import images\n"
        "d = %r + '/'\n"
        "ok = [np.array_equal(images.read_image(d + n, 'RGBA').pixels, np.load(d + n + '.npy'))\n"
        "      for n in %r]\n"
        "pix = np.load(d + 'pix.npy')\n"
        "for ext in ('icns', 'spider'):\n"
        "    images.write_image(d + 't.' + ext, pix)\n"
        "    ok.append(open(d + 't.' + ext, 'rb').read() == open(d + 'j.' + ext, 'rb').read())\n"
        "try:\n"
        "    images.write_image(d + 't.xbm', pix)\n"
        "except OSError as e:\n"
        "    ok.append(str(e) == 'cannot write mode RGB as XBM')\n"
        "print(len(ok), all(ok), sorted(m for m in sys.modules if m.startswith(('PIL', 'cv2',\n"
        "                                                                  'jax', 'dspfun_tpu.'))))\n"
    ) % (str(tmp_path), sorted(files))
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"{len(files) + 3} True []", res.stdout + res.stderr


def test_zstd_and_lzma_tiff_through_spec_and_motion_without_jax_pillow_cv2_or_zstandard(
        tmp_path):
    """With jax, Pillow, cv2, zstandard and dspfun_tpu blocked: the
    Zstandard and LZMA goldens and an old LSB-first LZW file read through
    the port's own codecs; spec of a Zstandard TIFF equals spec of the same
    pixels as PNG, and motion on LZMA and Zstandard TIFF frames equals
    motion on their PPMs, on the CPU."""
    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    gold = ROOT / "tests" / "goldens"
    names = ["zstd_rgb_p2.tif", "zstd_f_p3.tif", "lzma_i16_p2.tif", "lzma_planar_p2.tif"]
    for name in names:
        (tmp_path / name).write_bytes((gold / name).read_bytes())
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "from dspfun_tpu_torch.io import images\n"
        "from dspfun_tpu_torch.tools import motion, spec\n"
        "import torch_codec_fixtures as fx\n"
        "d = %r + '/'\n"
        "depths = [images.read_image(d + n).depth for n in %r]\n"
        "old = fx.old_lzw_tiffs()['old LZW RGB predictor 2']\n"
        "open(d + 'old.tif', 'wb').write(old)\n"
        "depths.append(images.read_image(d + 'old.tif').depth)\n"
        "rng = np.random.default_rng(0)\n"
        "for k in range(4):\n"
        "    lv = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)\n"
        "    lv[:, :20] = lv[:, :1]\n"
        "    kw = dict(codec=fx.zstd_stored) if k %% 2 else dict(level=0)\n"
        "    open(d + f'in{k:02d}.tif', 'wb').write(fx.make_tiff(\n"
        "        lv, 'RGB', compression=50000 if k %% 2 else 34925, predictor=2, **kw))\n"
        "    images.write_image(d + f'in{k:02d}.ppm', lv / 255.0)\n"
        "images.write_image(d + 'in.png', images.read_image(d + 'zstd_rgb_p2.tif').pixels)\n"
        "cpu = ['--device', 'cpu']\n"
        "same = lambda a, b: open(d + a, 'rb').read() == open(d + b, 'rb').read()\n"
        "rcs = [spec.main(cpu + ['-t', 'flat', d + 'zstd_rgb_p2.tif', d + 's_z.png']),\n"
        "       spec.main(cpu + ['-t', 'flat', d + 'in.png', d + 's_p.png'])]\n"
        "args = cpu + ['-Q', '-b', '8x8x4', '-p', '0x0x0-4x4x2', '-B', '1.25']\n"
        "for src in ('tif', 'ppm'):\n"
        "    rcs.append(motion.main(args + [d + 'in%%02d.' + src, d + 'o_' + src + '.y4m']))\n"
        "print(depths, set(rcs), same('s_z.png', 's_p.png'), same('o_tif.y4m', 'o_ppm.y4m'),\n"
        "      'zstandard' in sys.modules and sys.modules['zstandard'] is not None)\n"
    ) % (str(ROOT / "tests"), str(tmp_path), names)
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[8, 8, 16, 8, 8] {0} True True False", res.stdout + res.stderr


def test_calibration_counterparts_run_without_jax():
    """``python -m dspfun_tpu_torch.benchmarks.calib_r3e`` and ``calib_r3f``
    (at a small shape) on the CPU with jax and the JAX package unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "from dspfun_tpu_torch.benchmarks import calib_r3e, calib_r3f\n"
        "calib_r3e.main(['--device', 'cpu'])\n"
        "calib_r3f.main(['--device', 'cpu', '--shape', '300,77,45'])\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert sum(": OK  sum=" in ln for ln in lines) == 4
    assert sum("rel=" in ln for ln in lines) == 3


def test_motion_cli_runs_without_jax(tmp_path):
    """``python -m dspfun_tpu_torch.tools.motion`` with jax and the JAX
    package unimportable: help, then a small y4m edit on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "import runpy, numpy as np\n"
        "from fractions import Fraction\n"
        "from dspfun_tpu_torch.io import video\n"
        f"clip, out = {str(tmp_path / 'c.y4m')!r}, {str(tmp_path / 'o.y4m')!r}\n"
        "w = video.open_output(clip, 32, 16, Fraction(25, 1), video.ColorProps(pix_fmt='gray'))\n"
        "[w.write_frame([np.full((16, 32), 100.0 + t)], raw=True) for t in range(4)]\n"
        "w.close()\n"
        "sys.argv = ['motion', '-Q', '--device', 'cpu', '-b', '8x8x4', '-B', '1.5', clip, out]\n"
        "try:\n"
        "    runpy.run_module('dspfun_tpu_torch.tools.motion', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "exit 0"
    hdr, _, payload = (tmp_path / "o.y4m").read_bytes().partition(b"\n")
    assert hdr.startswith(b"YUV4MPEG2 W32 H16") and payload.count(b"FRAME\n") == 4
    res = _run(["-m", "dspfun_tpu_torch.tools.motion", "-h"])
    assert res.returncode == 0 and "Usage: motion" in res.stdout


def test_spec_and_ispec_run_without_jax_and_pillow(tmp_path):
    """``python -m dspfun_tpu_torch.tools.main spec`` then ``ispec`` on the
    CPU with jax, Pillow and the JAX package unimportable: a PNG in, a
    16-bit spectrum with its DC property, and an image of the input's
    depth out."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "import runpy, numpy as np\n"
        "from dspfun_tpu_torch.io import images\n"
        f"src, s, b = ({str(tmp_path / 'i.png')!r}, {str(tmp_path / 's.png')!r},"
        f" {str(tmp_path / 'b.png')!r})\n"
        "images.write_image(src, np.random.default_rng(0).random((24, 32, 3)))\n"
        "for argv in (['spec', '--device', 'cpu', '-t', 'flat', src, s],\n"
        "             ['ispec', '--device', 'cpu', '-t', 'flat', s, b]):\n"
        "    sys.argv = ['dspfun-torch'] + argv\n"
        "    try:\n"
        "        runpy.run_module('dspfun_tpu_torch.tools.main', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        print('exit', e.code)\n"
        "spectrum, back = images.read_image(s), images.read_image(b)\n"
        "print(spectrum.depth, sorted(spectrum.properties), back.depth, back.pixels.shape)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:3] == ["exit 0", "exit 0", "16 ['DC'] 16 (24, 32, 3)"]


def test_scan_and_zoom_run_without_jax_and_pillow(tmp_path):
    """``python -m dspfun_tpu_torch.tools.main scan`` and ``zoom`` on the
    CPU with jax, Pillow and the JAX package unimportable: a PNG in; a
    y4m scan, an fvid pan with an animation expression and a 2x PNG out."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "import runpy, numpy as np\n"
        "from dspfun_tpu_torch.io import images, video\n"
        f"d = {str(tmp_path)!r}\n"
        "y, x = np.mgrid[0:24, 0:32] / 24.0\n"
        "images.write_image(d + '/i.png', np.stack([0.5 + 0.4 * np.sin(6 * x),"
        " 0.5 + 0.4 * np.cos(4 * y), x * 0 + 0.3], -1))\n"
        "for argv in (['scan', '--device', 'cpu', '-m', 'zigzag', '-S', '100', '-q', d + '/i.png', d + '/s.y4m'],\n"
        "             ['zoom', '--device', 'cpu', '-s', '2', d + '/i.png', d + '/z.png'],\n"
        "             ['zoom', '--device', 'cpu', '-s', '2', '-v', '32x24', '-n', '3', '-q', '-x', '4*i',"
        " d + '/i.png', d + '/p.fvid']):\n"
        "    sys.argv = ['dspfun-torch'] + argv\n"
        "    try:\n"
        "        runpy.run_module('dspfun_tpu_torch.tools.main', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        print('exit', e.code)\n"
        "print(video.open_input(d + '/s.y4m').frames, images.read_image(d + '/z.png').pixels.shape,"
        " video.open_input(d + '/p.fvid').frames)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:4] == ["exit 0", "exit 0", "exit 0", "8 (48, 64, 3) 3"]
    for tool in ("scan", "zoom"):
        res = _run(["-m", f"dspfun_tpu_torch.tools.{tool}", "-h"])
        assert res.returncode == 0 and f"Usage: {tool}" in res.stderr


def test_basis_rotate_and_transcode_run_without_jax_and_pillow(tmp_path):
    """``python -m dspfun_tpu_torch.tools.main`` for applybasis (with a
    ``.coeff`` dump and the inverse from it), genbasis, draw, rotate and
    transcode on the CPU with jax, Pillow and the JAX package
    unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "import runpy, numpy as np\n"
        "from fractions import Fraction\n"
        "from dspfun_tpu_torch.io import images, video\n"
        f"d = {str(tmp_path)!r}\n"
        "images.write_image(d + '/i.png', np.random.default_rng(0).random((16, 16, 3)))\n"
        "w = video.open_output(d + '/c.y4m', 8, 6, Fraction(25, 1), video.ColorProps(pix_fmt='yuv420p'))\n"
        "[w.write_frame([np.full((h, x), 100.0 + t) for x, h in"
        " video.PIXEL_FORMATS['yuv420p'].plane_dims(8, 6)], raw=True) for t in range(4)]\n"
        "w.close()\n"
        "for argv in (['applybasis', '--device', 'cpu', '-f', 'DCT2', '-u', '16x16', '-d', d + '/c.coeff',"
        " d + '/i.png', d + '/a.png'],\n"
        "             ['applybasis', '--device', 'cpu', '-f', 'DCT3', '-I', '-u', '16x16', d + '/c.coeff',"
        " d + '/b.png'],\n"
        "             ['genbasis', '-s', '4x4', d + '/g.png'],\n"
        "             ['draw', '--device', 'cpu', '-b', '24x16', '-f', '2x3:0.5', d + '/d.png'],\n"
        "             ['rotate', '-q', 'zyx', d + '/c.y4m', d + '/r.y4m'],\n"
        "             ['transcode', '-q', d + '/c.y4m', d + '/t.fvid']):\n"
        "    sys.argv = ['dspfun-torch'] + argv\n"
        "    try:\n"
        "        runpy.run_module('dspfun_tpu_torch.tools.main', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        print('exit', e.code)\n"
        "print([images.read_image(d + f'/{n}.png').pixels.shape[:2] for n in 'abgd'],"
        " video.open_input(d + '/r.y4m').frames, video.open_input(d + '/t.fvid').frames)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:7] == ["exit 0"] * 6 + [
        "[(33, 33), (18, 18), (21, 21), (16, 24)] 8 4"]
    for tool in ("applybasis", "genbasis", "draw", "rotate", "transcode"):
        res = _run(["-m", f"dspfun_tpu_torch.tools.{tool}", "-h"])
        assert res.returncode == 0 and f"Usage: {tool}" in res.stdout


def test_dispatcher_lists_the_ported_tools_and_refuses_the_rest(capsys, monkeypatch):
    """``dspfun-torch`` runs every tool of the JAX package's dispatcher;
    the refusal by ROADMAP item stays for a tool the port would lack."""
    from dspfun_tpu.tools import main as jmain
    from dspfun_tpu_torch.tools import main as tmain

    assert sorted(tmain.TOOLS) == sorted(jmain.TOOLS) == [
        "applybasis", "draw", "genbasis", "ispec", "motion", "rotate", "scan", "spec",
        "transcode", "zoom"]
    assert tmain.NOT_PORTED == {}
    tool_files = {p.stem for p in (PKG / "tools").glob("*.py")
                  if not p.stem.startswith("_") and p.stem != "main"}
    assert tool_files == set(tmain.TOOLS)
    monkeypatch.setattr(tmain, "NOT_PORTED", {"nonesuch": 99})
    assert tmain.main(["nonesuch", "-h"]) == 1
    err = capsys.readouterr().err
    assert "queue 1, item 99" in err and "nonesuch" in err
    monkeypatch.undo()
    assert tmain.main(["nonesuch"]) == 1
    assert "unknown tool" in capsys.readouterr().err
    assert tmain.main([]) == 1 and tmain.main(["-h"]) == 0
    listed = capsys.readouterr().err
    assert all(f"   {name}" in listed for name in tmain.TOOLS)
    assert tmain.main(["spec", "-h"]) == 0 and "Usage: spec" in capsys.readouterr().out
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["dspfun-torch"] == "dspfun_tpu_torch.tools.main:main"
    for name in tmain.TOOLS:
        assert scripts[f"dspfun-torch-{name}"] == f"dspfun_tpu_torch.tools.{name}:main"


def test_package_data_ships_what_the_build_reads():
    """Every file ``_build.py`` compiles or hashes (the sources and the
    headers they include) and every host-library source ``_hostbuild.py``
    compiles (the copies of native/dspio.cpp and native/ffv1.cpp, and the
    port's own native/bcn.cpp, fax.cpp, gif.cpp, j2k.cpp, jpeg.cpp, quant.cpp,
    rawimg.cpp, tiff.cpp, webp.cpp and zstd.cpp) matches
    a package-data pattern of pyproject.toml, and the patterns name
    nothing that is not there; .gitignore lists both build directories."""
    from dspfun_tpu_torch import _build, _hostbuild

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]
    patterns = conf["package-data"]["dspfun_tpu_torch"]
    host = [p.relative_to(PKG).as_posix() for p in _hostbuild.build_inputs()]
    assert host == ["native/bcn.cpp", "native/dspio.cpp", "native/fax.cpp", "native/ffv1.cpp",
                    "native/gif.cpp", "native/j2k.cpp", "native/jpeg.cpp", "native/quant.cpp",
                    "native/rawimg.cpp", "native/tiff.cpp", "native/webp.cpp", "native/zstd.cpp"]
    for rel in host:
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel
    patterns = [pat for pat in patterns if not fnmatch.fnmatch("native/x.cpp", pat)]
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/kernels/" in ignored and "build/native/" in ignored
    inputs = [p.relative_to(PKG).as_posix() for p in _build.build_inputs()]
    assert "csrc/hopper_common.cuh" in inputs and "csrc/int8mm.cu" in inputs
    assert set(inputs) == {p.relative_to(PKG).as_posix()
                           for p in (PKG / "csrc").iterdir() if p.is_file()}
    for rel in inputs:
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel
    for pat in patterns:
        assert any(fnmatch.fnmatch(rel, pat) for rel in inputs), pat
    # a source that includes a header the build does not hash would go stale
    for src in (PKG / "csrc").glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert "csrc/" + line.split('"')[1] in inputs, (src.name, line)


def test_no_jax_imports_in_the_source():
    """No jax, Pillow, zstandard or JAX package anywhere; cv2 only inside functions of
    ``io/cv2_bridge.py`` and ``io/images.py`` (the compressed formats)."""
    lazy_cv2 = {PKG / "io" / "cv2_bridge.py", PKG / "io" / "images.py"}
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        in_function = {id(n) for f in ast.walk(tree)
                       if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                       for n in ast.walk(f)}
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "dspfun_tpu", "PIL", "zstandard"), \
                    f"{path}: {n}"
                if root == "cv2":
                    assert path in lazy_cv2 and id(node) in in_function, f"{path}: {n}"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA: non-zero exit and no ok line, both in the checkout and
    as a lone copy of the script."""
    res = _run([str(ROOT / "chip_smoke.py")])
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = _run([str(lone)], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_filter_plans_move_between_devices():
    """Plans are tensors on an explicit device; the converter keeps
    support indices as int64 tensors."""
    mask = fused.lowpass_mask((64, 48), cutoff=0.5)
    plans = fused.filter_plans((64, 48), Precision(intermediate="i8"), mask=mask,
                               device="meta")
    assert all(p.hi.device.type == "meta" for p in plans.fwd + plans.inv)
    assert plans.support[0].dtype == torch.int64
    host = filter_plans_from_jax(
        (tuple(tuple(None if f is None else np.zeros((2, 2)) for f in p)
               for p in plans.fwd), (), (np.arange(3), None)), device="cpu")
    assert host.support[0].tolist() == [0, 1, 2] and host.support[1] is None


def test_entry_points_default_to_the_card():
    """Every public function of the port that takes ``device`` defaults to
    ``"cuda"`` (walked with inspect.signature, jax and the JAX package
    unimportable), so a caller who names no device never gets the plain
    versions on the CPU silently."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['dspfun_tpu'] = None; sys.modules['PIL'] = None\n"
        "import importlib, inspect, json, pkgutil, dspfun_tpu_torch\n"
        "found = {}\n"
        "for m in pkgutil.walk_packages(dspfun_tpu_torch.__path__, 'dspfun_tpu_torch.'):\n"
        "    mod = importlib.import_module(m.name)\n"
        "    for name, fn in inspect.getmembers(mod, inspect.isfunction):\n"
        "        if name.startswith('_') or fn.__module__ != m.name:\n"
        "            continue\n"
        "        par = inspect.signature(fn).parameters.get('device')\n"
        "        if par is not None:\n"
        "            found[m.name + '.' + name] = repr(par.default)\n"
        "print(json.dumps(found))\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    found = json.loads(res.stdout)
    assert {f"dspfun_tpu_torch.{f}" for f in (
        "core.transforms.plan_matrix", "core.transforms.plan_axis",
        "models.fused.filter_plans", "models.motion_pipeline.maybe_kron_plans",
        "models.motion_pipeline.make_plans", "ops.blockdct.folded_operator",
        "ops.blockdct.bdiag_axis_plan", "ops.block_filter.folded_filter_matrices",
        "benchmarks.calib_r3e.run_probes", "benchmarks.calib_r3f.inputs",
        "benchmarks.calib_r3f.run", "convert.axis_plan_from_jax",
        "convert.filter_plans_from_jax", "convert.motion_plans_from_jax",
        "convert.scan_plan_from_jax", "convert.zoom_plans_from_jax",
        "models.scan_pipeline.forward_coeffs", "models.scan_pipeline.plan_scan",
        "models.zoom_pipeline.forward_spectrum", "models.zoom_pipeline.zoom_plan",
        "utils.hostcopy.upload_scalars", "models.basis_pipeline.apply_basis",
        "models.basis_pipeline.draw_canvas")} <= set(found)
    assert {name: d for name, d in found.items() if d != "'cuda'"} == {}


def test_filter_plans_without_a_device_need_the_card():
    """``filter_plans`` with no device builds its plans on the card; without
    one it raises PyTorch's own error instead of returning CPU plans."""
    mask = fused.lowpass_mask((64, 48), cutoff=0.5)
    if torch.cuda.is_available():
        plans = fused.filter_plans((64, 48), Precision(intermediate="i8"), mask=mask)
        assert all(p.hi.device.type == "cuda" for p in plans.fwd + plans.inv)
        return
    with pytest.raises((RuntimeError, AssertionError)):
        fused.filter_plans((64, 48), Precision(intermediate="i8"), mask=mask)


def test_cmyk_tiff_and_jpeg_through_spec_ispec_and_motion_without_jax_pillow_or_cv2(tmp_path):
    """``spec`` then ``ispec`` on a CMYK TIFF (tiled, planar, deflate) and
    on a CMYK JPEG (YCCK), and ``motion`` on ``%02d.tif`` and ``%02d.jpg``
    sequences of them, with jax, Pillow, cv2 and the JAX package
    unimportable: the outputs (a spectrum, a PNG; a y4m) equal those of
    the same runs on PNG and PPM copies of the decoded pixels."""
    from PIL import Image

    from tests import torch_codec_fixtures as fx

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:24, 0:40]
    for k in range(4):
        base = 128 + 90 * np.sin(x[..., None] / 5.0 + y[..., None] / 7.0 + np.arange(4) + k)
        cmyk = np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8)
        (tmp_path / f"in{k:02d}.tif").write_bytes(
            fx.make_tiff(cmyk, "CMYK", compression=8, predictor=2, tile=(16, 16), planar=True))
        buf = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(buf, "JPEG")
        (tmp_path / f"jn{k:02d}.jpg").write_bytes(fx.set_adobe_transform(buf.getvalue(), 2))
    blocked = _blocked(tmp_path, ("jax", "jaxlib", "dspfun_tpu", "PIL", "cv2", "zstandard"))
    code = (
        "import sys\n"
        "from dspfun_tpu_torch.io import images\n"
        "from dspfun_tpu_torch.tools import ispec, motion, spec\n"
        f"d = {str(tmp_path)!r} + '/'\n"
        "for src in ('in', 'jn'):\n"
        "    ext = 'tif' if src == 'in' else 'jpg'\n"
        "    for k in range(4):\n"
        "        pix = images.read_image(d + f'{src}{k:02d}.{ext}').pixels\n"
        "        images.write_image(d + f'{src}{k:02d}.ppm', pix)\n"
        "    images.write_image(d + src + '.png', images.read_image(d + f'{src}00.{ext}').pixels)\n"
        "cpu = ['--device', 'cpu']\n"
        "same = lambda a, b: open(d + a, 'rb').read() == open(d + b, 'rb').read()\n"
        "rcs, eq = [], []\n"
        "args = cpu + ['-Q', '-b', '8x8x4', '-p', '0x0x0-4x4x2', '-B', '1.25']\n"
        "for src, ext in (('in', 'tif'), ('jn', 'jpg')):\n"
        "    rcs += [spec.main(cpu + ['-t', 'flat', d + f'{src}00.{ext}', d + f's_{src}.png']),\n"
        "            spec.main(cpu + ['-t', 'flat', d + f'{src}.png', d + f's_{src}_p.png']),\n"
        "            ispec.main(cpu + ['-t', 'flat', d + f's_{src}.png', d + f'b_{src}.png']),\n"
        "            ispec.main(cpu + ['-t', 'flat', d + f's_{src}_p.png', d + f'b_{src}_p.png'])]\n"
        "    for e in (ext, 'ppm'):\n"
        "        rcs.append(motion.main(args + [d + src + '%02d.' + e, d + f'o_{src}_{e}.y4m']))\n"
        "    eq += [same(f's_{src}.png', f's_{src}_p.png'), same(f'b_{src}.png', f'b_{src}_p.png'),\n"
        "           same(f'o_{src}_{ext}.y4m', f'o_{src}_ppm.y4m')]\n"
        "print(rcs, eq, 'dspfun_tpu_torch.io.imgcodecs' in sys.modules)\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocked), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    env.pop("DSPFUN_PRECISION", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0] " \
        "[True, True, True, True, True, True] True", res.stdout + res.stderr
