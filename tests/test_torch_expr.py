"""The port's av_expr host interpreter (``dspfun_tpu_torch/core/expr.py``)
against the JAX package's, on numpy.

Every expression of the tables in tests/test_expr_oracle.py and every
``ev(...)``/``parse_expr(...)`` call of tests/test_expr.py goes through
both copies: values equal bit for bit (NaN == NaN), parse errors alike.
Two differences are deliberate and held to real av_expr (cv2's bundled
libavutil) where it is there: a sign folded into ``while`` is dropped,
and stateful state belongs to the parse.
"""

import ast
import importlib.util
import math
import random as pyrandom
from pathlib import Path

import numpy as np
import pytest

from dspfun_tpu.core import expr as jexpr
from dspfun_tpu_torch.core import expr as texpr

HERE = Path(__file__).resolve().parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}_tables", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ORACLE = _load("test_expr_oracle")
TABLE = (ORACLE.ELEMENTWISE + ORACLE.SUFFIXES + ORACLE.QUIRKS + ORACLE.GOOD_PARSES
         + [f"root({body}, {xmax})" for body, xmax in ORACLE.ROOTS])


def _same(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def _sign_folded_while(src: str) -> bool:
    """Whether a sign folds into a ``while`` call: the one place where
    the copies differ on purpose."""
    def walk(node):
        if not isinstance(node, tuple):
            return False
        if node[0] == "vneg" and node[1][0] == "call" and node[1][1] == "while":
            return True
        return any(walk(c) if isinstance(c, tuple) else
                   any(walk(x) for x in c) if isinstance(c, list) else False
                   for c in node[1:])
    try:
        return walk(texpr.parse_expr(src, ("x",)).ast)
    except ValueError:
        return False


def _both(src, names=(), env=None, times=2):
    """Parse and evaluate ``times`` in both copies (state persists
    between evaluations of one parse); returns the two value lists, or
    the exception types."""
    out = []
    for mod in (jexpr, texpr):
        try:
            e = mod.parse_expr(src, names)
            with np.errstate(all="ignore"):
                out.append([np.asarray(e(dict(env or {}), np), np.float64)
                            for _ in range(times)])
        except Exception as exc:  # noqa: BLE001
            out.append(type(exc))
    return out


@pytest.mark.parametrize("src", TABLE)
def test_oracle_table_case_equals_the_jax_copy(src, capsys):
    j, t = _both(src)
    assert not isinstance(j, type) and not isinstance(t, type), (src, j, t)
    assert all(_same(a, b) for a, b in zip(j, t)), (src, j, t)


@pytest.mark.parametrize("src", ORACLE.BAD_PARSES + ["2i"])
def test_parse_errors_alike(src):
    for mod in (jexpr, texpr):
        with pytest.raises(ValueError):
            mod.parse_expr(src, ())


def _scraped_cases():
    """(source, variable names, environment) of every ``ev("...", k=v)``
    and ``parse_expr("...", names)`` call in tests/test_expr.py whose
    arguments are literals."""
    tree = ast.parse((HERE / "test_expr.py").read_text())
    cases = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("ev", "parse_expr") and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        src = node.args[0].value
        try:
            if node.func.id == "ev":
                env = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
                names = tuple(env)
            else:
                names = tuple(ast.literal_eval(node.args[1])) if len(node.args) > 1 else ()
                env = {n: 0.75 + i for i, n in enumerate(names)}
        except (ValueError, TypeError):
            continue  # an argument computed at run time
        if "time(" in src:
            continue  # reads the clock
        cases.append((src, names, env))
    return sorted(set((s, n, tuple(sorted(e.items()))) for s, n, e in cases))


SCRAPED = _scraped_cases()


def test_the_scrape_found_the_cases():
    assert len(SCRAPED) >= 80
    assert any("while" in s for s, _, _ in SCRAPED) and any("random" in s for s, _, _ in SCRAPED)


@pytest.mark.parametrize("src,names,env", SCRAPED)
def test_case_of_test_expr_equals_the_jax_copy(src, names, env, capsys):
    if _sign_folded_while(src):
        pytest.skip("sign-folded while: held to av_expr in its own test")
    j, t = _both(src, names, dict(env))
    if isinstance(j, type) or isinstance(t, type):
        assert j is t, (src, j, t)
    else:
        assert all(_same(a, b) for a, b in zip(j, t)), (src, j, t)


def test_vectorised_grids_equal():
    y, x = np.mgrid[0:5, 0:7].astype(np.float64)
    for src in ("x+y*2", "if(gt(x,y), st(0,x), y) + ld(0)", "clip(x-3, -1, y)",
                "between(x, 1, y) + sgn(x-y)", "bitand(x*7, 13) + gcd(x, y)",
                "mod(x-3.5, y+1) + round(x/2) + hypot(x, y)", "lt(x,2)*sqrt(x-1)"):
        j, t = _both(src, ("x", "y"), {"x": x, "y": y}, times=1)
        assert _same(j[0], t[0]), src


def test_stateful_grid_is_raster_order_and_equal():
    g = np.zeros((3, 4))
    for src in ("st(0, ld(0)+1)", "random(0) + x", "randomi(1, 2, 5)"):
        j, t = _both(src, ("x",), {"x": g}, times=2)
        assert all(_same(a, b) for a, b in zip(j, t)), src
    out = texpr.parse_expr("st(0, ld(0)+1)", ("x",))({"x": g})
    assert out.ravel().tolist() == list(range(1, 13))


@pytest.mark.parametrize("seed,n,atoms,xs", [
    (20260819, 150, "_ATOMS", (-2.5, -1.0, 0.0, 0.3, 1.0, 7.25)),
    (555, 100, "_ATOMS_EXTREME", (-2.5, 0.0, 7.25, math.inf, -math.inf, math.nan,
                                  1e300, -0.0)),
])
def test_fuzz_programs_equal_the_jax_copy(seed, n, atoms, xs, capsys):
    """The oracle test's program generator, both copies side by side:
    sequential scalar evaluations (state persists) equal bit for bit."""
    r = pyrandom.Random(seed)
    checked = 0
    for _ in range(n):
        src = ORACLE._gen(r, r.randrange(2, 5), getattr(ORACLE, atoms))
        if _sign_folded_while(src):
            continue
        try:
            je = jexpr.parse_expr(src, ("x",))
        except ValueError:
            with pytest.raises(ValueError):
                texpr.parse_expr(src, ("x",))
            continue
        te = texpr.parse_expr(src, ("x",))
        assert te.stateful == je.stateful
        for x in xs:
            with np.errstate(all="ignore"):
                assert _same(je({"x": x}), te({"x": x})), (src, x)
        checked += 1
    assert checked >= n // 2


def _while_programs(n=60, seed=7):
    """Sign-folded ``while`` in the shapes eval.c folds a sign: unary
    minus, a subtraction's right term, a negative exponent."""
    r = pyrandom.Random(seed)
    out = []
    for _ in range(n):
        lim, inc = r.randrange(1, 6), r.choice(["1", "2", "0.5"])
        body = f"while(lt(ld(0),{lim}), st(0, ld(0)+{inc}))"
        shape = r.choice(["-{w}", "1 - {w}", "st(0,0); -{w}", "2 * -{w}", "2^-{w}",
                          "{a} - {w} + ld(0)", "-{w} - {w}"])
        out.append(shape.format(w=body, a=r.choice(["3", "x", "-1.5"])))
    return out


def test_sign_folded_while_keeps_av_exprs_value(capsys):
    """``-while(...)`` is av_expr's value, not its negation (the JAX
    copy negates it): held to libavutil where cv2 brings one, and to the
    unfolded expression everywhere."""
    e = texpr.parse_expr("-while(lt(ld(0),3), st(0, ld(0)+1))", ())
    assert float(e({})) == 3.0
    assert float(jexpr.parse_expr("-while(lt(ld(0),3), st(0, ld(0)+1))", ())({})) == -3.0
    assert float(texpr.parse_expr("1 - while(lt(ld(0),3), st(0, ld(0)+1))", ())({})) == 4.0
    assert math.isnan(float(texpr.parse_expr("-while(0, 1)", ())({})))
    for src in _while_programs():
        assert _sign_folded_while(src), src
        got = float(texpr.parse_expr(src, ("x",))({"x": 0.25}))
        if ORACLE._AV is not None:
            want = ORACLE.OracleExpr(src, ("x",))(x=0.25)
            assert got == want or (math.isnan(got) and math.isnan(want)), (src, got, want)


def test_state_belongs_to_the_parse():
    """Two parses of one stateful text share nothing: the second starts
    its generator and its slots afresh while the first goes on."""
    a = texpr.parse_expr("random(0)", ("x",))
    first = [float(a({"x": 0.0})) for _ in range(3)]
    b = texpr.parse_expr("random(0)", ("x",))
    assert float(b({"x": 0.0})) == first[0]
    assert float(a({"x": 0.0})) not in first
    c1 = texpr.parse_expr("st(0, ld(0)+1)", ())
    c2 = texpr.parse_expr("st(0, ld(0)+1)", ())
    assert [float(c1({})), float(c1({})), float(c2({}))] == [1.0, 2.0, 1.0]
    assert not hasattr(texpr, "_LIVE_EXPRS") and not hasattr(texpr, "host_eval_in_jit")
    c1.reset_state()
    assert float(c1({})) == 1.0
