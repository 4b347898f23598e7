"""motion's ``--eval`` on the port: the expression's device half
(``core/expr.py:TorchNamespace``) and the motion CLI against the JAX
package's.

* Every function of ``_funcs`` and every special form the evaluator
  handles itself, through the torch namespace, against the JAX
  package's ``jnp`` path on the same float32 grids: to 1 float32 ulp
  beyond the JAX path's own distance from the float64 evaluation of the
  same inputs (XLA's float32 ``sinh`` is 4.9 ulps from it, ``tanh``
  3.4, ``asin`` 2.1), and to 2 ulps beyond it where the expression
  chains two rounded steps (``gauss`` and ``squish`` divide after an
  ``exp``; XLA may fuse ``c*x + 1`` into one rounding).
* The README's fade and ``c*gte(bz,2)`` under ``--slab-batch 2``: the
  port's frames within one level of the JAX tool's.
* A stateful ``random(0)``: the port's parse ends the run with the JAX
  parse's slots and generator state (the same draws in the same
  order), and the frames are within one level.
* "Bad expression" exits 1 in both tools.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspfun_tpu.core import expr as jexpr
from dspfun_tpu.io import video as jvideo
from dspfun_tpu.tools import motion as jmotion
from dspfun_tpu_torch.core import expr as texpr
from dspfun_tpu_torch.io import video as tvideo
from dspfun_tpu_torch.tools import motion as tmotion

FADE = "c * ((width-x)/width) * ((height-y)/height) * ((depth-z)/depth)"
SINGLE = set(texpr._funcs(np)) - {"gauss", "squish", "lerp", "mod"}


def _ulps(a, b):
    a, b = np.broadcast_arrays(np.asarray(a, np.float64), np.asarray(b, np.float64))
    fin = np.isfinite(a) & np.isfinite(b)
    a, b = np.where(fin, a, 0.0), np.where(fin, b, 0.0)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)
    return np.where(fin, np.abs(a - b) / sp, 0.0)


def _sources():
    out = []
    for name in sorted(texpr._funcs(np)):
        lo = texpr._ARITY[name][0]
        out.append(f"{name}({', '.join(['c', 'x', '-x'][:lo])})")
    return out + ["sgn(c)", "clip(c, -x, x)", "between(c, -x, x)", "if(gt(c, 0), c, x)",
                  "ifnot(gt(c, 0), c, x)", "st(0, c*x); ld(0) + 1", "c / x", "c ^ x",
                  "-lerp(2, 10, 0.25) + c", "c / 0"]


@pytest.mark.parametrize("src", _sources())
def test_torch_namespace_matches_the_jnp_path(src):
    rng = np.random.default_rng(0)
    c = (rng.standard_normal((3, 16, 24)) * 2).astype(np.float32)
    x = rng.uniform(0.1, 3.0, (1, 1, 24)).astype(np.float32)
    names = ("c", "x")
    j = np.asarray(jexpr.parse_expr(src, names)({"c": jnp.asarray(c), "x": jnp.asarray(x)}, jnp))
    xp = texpr.TorchNamespace("cpu", torch.float32)
    t = xp.asarray(texpr.parse_expr(src, names)(
        {"c": torch.from_numpy(c), "x": torch.from_numpy(x)}, xp)).numpy()
    ref = np.asarray(texpr.parse_expr(src, names)(
        {"c": c.astype(np.float64), "x": x.astype(np.float64)}, np))
    j, t, ref = np.broadcast_arrays(j, t, ref)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    inf = np.isinf(t)
    np.testing.assert_array_equal(t[inf], j[inf])
    steps = 1.0 if src.split("(")[0] in SINGLE else 2.0
    assert np.all(_ulps(t, j) <= steps + _ulps(j, ref)), src


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 64x48 yuv420p clip of 8 frames, written by the JAX package."""
    path = str(tmp_path_factory.mktemp("motion_eval") / "clip.y4m")
    rng = np.random.default_rng(1)
    pf = jvideo.PIXEL_FORMATS["yuv420p"]
    w = jvideo.open_output(path, 64, 48, Fraction(25, 1), jvideo.ColorProps(pix_fmt="yuv420p"))
    for t in range(8):
        w.write_frame([np.clip(128 + 50 * np.sin(np.arange(pw) / 5.0 + t)[None, :]
                               + rng.normal(0, 20, (ph, pw)), 0, 255)
                       for pw, ph in pf.plane_dims(64, 48)], raw=True)
    w.close()
    return path


def _frames(path):
    with tvideo.open_input(path) as r:
        out = []
        while (f := r.read_frame(raw=True)) is not None:
            out.append([p.astype(int) for p in f])
    return out


def _within_one_level(a_path, b_path, share=1e-2):
    a, b = _frames(a_path), _frames(b_path)
    assert len(a) == len(b) > 0
    diff = np.concatenate([np.abs(x - y).ravel() for fa, fb in zip(a, b) for x, y in zip(fa, fb)])
    assert diff.max() <= 1 and np.mean(diff > 0) <= share, (diff.max(), np.mean(diff > 0))


@pytest.mark.parametrize("args,ext", [
    (["-b", "0x0x0", "--eval", FADE], "y4m"),
    (["-b", "16x16x4", "--eval", FADE, "-B", "1.5"], "nut"),
    (["-b", "8x8x2", "--slab-batch", "2", "--eval", "c*gte(bz,2)"], "y4m"),
    (["-b", "8x8x2", "--eval", "c*(1+bx/bwidth)*(2-by/bheight)*lt(i,1+components)"], "nut"),
])
def test_cli_eval_matches_jax(clip, tmp_path, args, ext):
    outs = []
    for name, main, extra in (("jax", jmotion.main, []),
                              ("torch", tmotion.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.{ext}")
        assert main(["-Q"] + args + extra + [clip, out]) == 0
        outs.append(out)
    _within_one_level(*outs)


def test_stateful_eval_draws_what_the_jax_tool_draws(clip, tmp_path, monkeypatch):
    parsed = {}
    for name, mod in (("jax", jmotion), ("torch", tmotion)):
        real = mod.parse_expr

        def keep(src, names, real=real, name=name):
            parsed[name] = real(src, names)
            return parsed[name]

        monkeypatch.setattr(mod, "parse_expr", keep)
    outs = []
    for name, main, extra in (("jax", jmotion.main, []),
                              ("torch", tmotion.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.y4m")
        assert main(["-Q", "-b", "8x8x2", "--frames", "4", "--slab-batch", "2",
                     "--eval", "c*(1+0.1*random(0))"] + extra + [clip, out]) == 0
        outs.append(out)
    assert parsed["torch"].stateful and parsed["torch"]._slots
    assert parsed["torch"]._slots == parsed["jax"]._slots
    assert parsed["torch"]._prng == parsed["jax"]._prng
    _within_one_level(*outs)
    assert tmotion.LAST_STAGE_TIMES["host_eval"] > 0.0


@pytest.mark.parametrize("bad", ["c*(", "nonesuch(c)", "c+q", "sin(c, x)"])
def test_bad_expression_exits_1(clip, tmp_path, capsys, bad):
    for main, extra in ((jmotion.main, []), (tmotion.main, ["--device", "cpu"])):
        assert main(["-Q", "--eval", bad] + extra + [clip, str(tmp_path / "o.y4m")]) == 1
        assert "Bad expression" in capsys.readouterr().err
    assert not (tmp_path / "o.y4m").exists()
