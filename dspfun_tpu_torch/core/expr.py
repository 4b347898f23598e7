"""FFmpeg av_expr-compatible expression engine (copy of
``dspfun_tpu/core/expr.py`` with PyTorch in place of its JAX paths).

The reference uses FFmpeg's expression evaluator as its user-scripting
hook: zoom animation expressions (reference zoom/zoom.c:221-228,
320-345), motion ``--eval`` coefficient formulas (motion/motion.c:
463-469, 670-681), and scan's ``evalxy``/``evali`` methods
(scan/scan_methods.c:333-391).

All of those uses are *elementwise over coordinate grids* (or per-frame
scalars), so this engine parses once into an AST and evaluates it with
numpy on the host (scan precompute, zoom per-frame scalars) or, through
:class:`TorchNamespace`, as torch ops on the device that holds the grid
(motion's ``--eval``): one walker, two array namespaces.  A stateful
expression given the torch namespace takes its variables to the host in
float64, evaluates per element in raster order, and returns the result
to the device (the port's counterpart of the JAX package's ordered
``io_callback``, ``host_eval_in_jit``).

Grammar (the av_expr subset the dspfun docs exercise):
    expr   := term (('+'|'-') term)*
    term   := factor (('*'|'/') factor)*
    factor := primary ('^' primary)*        (right assoc, pow)
    primary:= ('+'|'-')* (number | const | var | func '(' args ')' | '(' expr ')')

Functions: sin cos tan asin acos atan atan2 sinh cosh tanh exp log pow
sqrt abs sgn floor ceil trunc round mod gcd max min hypot eq gte gt lte
lt not if ifnot isnan isinf bitand bitor between clip lerp squish gauss
st ld print, plus the stateful/iterative av_expr forms random randomi
while root taylor time.  Constants: PI, E, PHI.

Stateful forms evaluate on the host: with scalar variables they follow
ffmpeg eval.c exactly (lazy if/while, persistent var slots across
evaluations of the same parsed Expr — eval.c keeps them in
``AVExpr->var``); with grid variables the expression is evaluated per
element in raster order, matching the reference's per-coefficient
evaluation loops (motion/motion.c:670-681, scan/scan_methods.c:333-391).
The slots and generators belong to the parsed ``Expr`` object: a fresh
parse of the same text starts from fresh state, as a fresh AVExpr does
(the JAX package shares them through a registry keyed on the source
text; this copy has none).

Two deliberate differences from the JAX package's file: ``while`` is in
``_EVALUE_DROPPED`` (``-while(...)`` keeps av_expr's value; the original
negates it), and state is per parse.  tests/test_torch_expr.py pins
everything else to the original.

``random``/``randomi`` follow modern eval.c (FFmpeg >= 6.1): an sfc64
generator seeded from the var slot on first use per slot, the raw draw
stored back into the slot.  ``root`` reproduces eval.c's e_root probe
schedule (bit-reversed scan of 0..max, then decaying signed offsets
around the best bounds, bisection only once both bounds land >= 0).
Both are pinned BIT-EXACTLY against the real libavutil (cv2's bundled
FFmpeg) in tests/test_expr_oracle.py, as are the elementwise forms.
"""

from __future__ import annotations

import math
import re
import sys
import time as _time
from typing import Any, Callable, Mapping

__all__ = ["Expr", "TorchNamespace", "parse_expr"]

_U64 = (1 << 64) - 1
_VARS = 10  # ffmpeg eval.c VARS: st()/ld()/random() slot count
_DBL_MAX = sys.float_info.max
# time() is here because its value must be read at run time, once per
# element, never folded into a vectorised evaluation.
_STATEFUL = {"random", "randomi", "while", "root", "taylor", "time"}

# eval.c opcodes that ``return`` WITHOUT multiplying by e->value, so a
# folded sign (unary minus, or '-' folded by parse_subexpr) silently
# drops: ``-lerp(2,10,0.25)`` and even ``1 - lerp(2,10,0.25)`` ADD the
# lerp in real av_expr.  Set probed exhaustively against cv2's
# libavutil (tests/test_expr_oracle.py pins it per function).
# ``while`` belongs to the set too (eval.c's e_while returns its last
# body value unscaled); the JAX package's copy lacks it.
_EVALUE_DROPPED = {"squish", "gauss", "lerp", "taylor", "root", "print",
                   "random", "randomi", "while"}

# numbers go through av_strtod in av_expr: decimal/hex mantissa, then
# an optional SI prefix (k/M/G/... and the 'i' binary variants, e.g.
# 2Ki = 2048), then an optional 'B' (bytes: x8) — all oracle-pinned in
# tests/test_expr_oracle.py
_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
    r"(?:(?P<si>[yzafpnumcdhkKMGTPEZY])(?P<bin>i)?)?(?P<byt>B)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>[-+*/^(),;])"
    r")"
)

# av_strtod's SI table: decimal exponents; the 'i' form multiplies by
# pow(2, e/0.3) instead (k -> 2^10, M -> 2^20, ...)
_SI_EXP = {"y": -24, "z": -21, "a": -18, "f": -15, "p": -12, "n": -9,
           "u": -6, "m": -3, "c": -2, "d": -1, "h": 2, "k": 3, "K": 3,
           "M": 6, "G": 9, "T": 12, "P": 15, "E": 18, "Z": 21, "Y": 24}

_CONSTS = {"PI": math.pi, "E": math.e, "PHI": (1 + math.sqrt(5)) / 2}

# Argument-count range per function, matching the real av_expr parser
# (each row probed against cv2's libavutil: counts outside the range
# are parse errors there — tests/test_expr_oracle.py pins a sample).
# print parses up to 3 args but evaluates only the first two, exactly
# as the oracle does (its 3rd-arg st() never fires).
_ARITY = {
    **{f: (1, 1) for f in (
        "sin cos tan asin acos atan sinh cosh tanh exp log sqrt abs sgn "
        "floor ceil trunc round not isnan isinf squish gauss ld random "
        "time").split()},
    **{f: (2, 2) for f in (
        "atan2 pow mod gcd max min hypot eq gte gt lte lt bitand bitor "
        "st while root").split()},
    **{f: (3, 3) for f in "between clip lerp randomi".split()},
    "if": (2, 3), "ifnot": (2, 3), "taylor": (2, 3), "print": (1, 3),
}


def _strtod(m: "re.Match") -> float:
    """The av_strtod number semantics for a _TOKEN_RE num match: the
    suffix multiplies via C pow (NOT a literal rescale — av_strtod's
    5u is 5*pow(10,-6) = 4.999...e-06, one ulp off strtod("5e-6"))."""
    body = m.group("num")
    for g in ("byt", "bin", "si"):
        if m.group(g):
            body = body[:-len(m.group(g))]
    v = float(int(body, 16)) if body[:2].lower() == "0x" else float(body)
    if m.group("si"):
        e = _SI_EXP[m.group("si")]
        v *= 2.0 ** (e / 0.3) if m.group("bin") else 10.0 ** e
    if m.group("byt"):
        v *= 8.0
    return v


def _tokenize(s: str):
    pos = 0
    out = []
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"bad token in expression at: {s[pos:]!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", _strtod(m)))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        else:
            out.append(("op", m.group("op")))
    out.append(("end", None))
    return out


class _Parser:
    def __init__(self, tokens, var_names):
        self.toks = tokens
        self.i = 0
        self.var_names = set(var_names)

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op):
        t = self.next()
        if t != ("op", op):
            raise ValueError(f"expected {op!r}, got {t}")

    def parse(self):
        node = self.seq()
        if self.peek() != ("end", None):
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return node

    def seq(self):
        # av_expr parse_expr: ';'-separated expressions evaluate in
        # order and the last one's value is the result (the st()/ld()
        # idiom).  eval.c re-enters parse_expr for every parenthesis
        # and function argument, so ';' is legal there too — and a
        # trailing ';' is an error (both oracle-pinned).
        node = self.expr()
        while self.peek() == ("op", ";"):
            self.next()
            node = ("seq", node, self.expr())
        return node

    def expr(self):
        # eval.c parse_subexpr implements a-b as a + b·(value*=-1): the
        # minus folds into the right term's e->value multiplier, which
        # the e->value-dropping opcodes then ignore (``1 - lerp(...)``
        # really ADDS the lerp in real av_expr — oracle-pinned).
        node = self.term()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.next()[1]
            rhs = self.term()
            node = ("+", node, self._vneg(rhs) if op == "-" else rhs)
        return node

    def term(self):
        node = self.factor()
        while self.peek() in (("op", "*"), ("op", "/")):
            op = self.next()[1]
            node = (op, node, self.factor())
        return node

    def _sign1(self) -> bool:
        # eval.c parse_pow consumes at most ONE explicit sign per
        # factor (``- -lerp(...)`` is a parse error there); a second
        # sign is only legal when av_strtod absorbs it as part of a
        # numeric literal (``--5`` == 5) — see primary().
        if self.peek() in (("op", "+"), ("op", "-")):
            return self.next()[1] == "-"
        return False

    @staticmethod
    def _vneg(node):
        # eval.c folds '-' into the operand's ``e->value`` multiplier
        # (parse_factor's sign, parse_subexpr's ``e2->value *= -1``).
        # A handful of opcodes return WITHOUT applying e->value, so the
        # fold must stay visible to the evaluator — except for literals
        # (e_value returns e->value itself) and double folds (cancel).
        if node[0] == "num":
            return ("num", -node[1])
        if node[0] == "vneg":
            return node[1]
        return ("vneg", node)

    def factor(self):
        # ffmpeg eval.c parse_factor: unary sign binds looser than '^'
        # (-2^2 == -4) and '^' chains left-associatively, each exponent
        # carrying its own optional sign.
        neg = self._sign1()
        node = self.primary()
        while self.peek() == ("op", "^"):
            self.next()
            eneg = self._sign1()
            exp = self.primary()
            if eneg:
                exp = self._vneg(exp)
            node = ("^", node, exp)
        if neg:
            node = self._vneg(node)
        return node

    def primary(self):
        kind, val = self.next()
        if kind == "op" and val in "+-" and self.peek()[0] == "num":
            # av_strtod absorbs one sign as part of a numeric literal
            # (parse_primary calls it before anything else), so "--5"
            # parses as 5 while "- -lerp(...)" is an error
            n = self.next()[1]
            return ("num", -n if val == "-" else n)
        if kind == "op" and val == "(":
            node = self.seq()
            self.expect_op(")")
            return node
        if kind == "num":
            return ("num", val)
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.seq())
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.seq())
                self.expect_op(")")
                if val not in _ARITY:
                    raise ValueError(f"unknown function {val!r}")
                lo, hi = _ARITY[val]
                if not lo <= len(args) <= hi:
                    raise ValueError(
                        f"{val}() takes {lo}" + (f"..{hi}" if hi != lo else "")
                        + f" arguments, got {len(args)}")
                return ("call", val, args)
            if val in _CONSTS:
                return ("num", _CONSTS[val])
            low = val.lower()
            if low in ("inf", "infinity"):
                # strtod runs first in parse_primary, so inf/nan (any
                # case) are literals in real av_expr and shadow any
                # same-named variable
                return ("num", math.inf)
            if low == "nan":
                return ("num", math.nan)
            if val in self.var_names:
                return ("var", val)
            raise ValueError(f"unknown identifier {val!r}")
        raise ValueError(f"unexpected token {(kind, val)}")


class TorchNamespace:
    """What ``_funcs`` and ``Expr._eval_tree`` call on numpy, as torch
    ops on ``device``.

    Python scalars become 0-dim float64 tensors on ``device``: PyTorch
    promotes a 0-dim operand no further than a dimensioned one of its
    kind, as JAX does with weakly typed scalars, and a division by a
    tensor on the device rounds once, where a host scalar divisor would
    round twice (``core/precision.py:true_div``).  ``dtype`` is the dtype
    a stateful evaluation's host result returns in."""

    __name__ = "torch"

    def __init__(self, device, dtype):
        import torch  # noqa: PLC0415

        self.torch, self.device, self.dtype = torch, torch.device(device), dtype
        self.float64, self.int64 = torch.float64, torch.int64
        t = torch
        for name, fn in (("sin", t.sin), ("cos", t.cos), ("tan", t.tan),
                         ("arcsin", t.asin), ("arccos", t.acos), ("arctan", t.atan),
                         ("sinh", t.sinh), ("cosh", t.cosh), ("tanh", t.tanh),
                         ("exp", t.exp), ("log", t.log), ("sqrt", t.sqrt),
                         ("abs", t.abs), ("floor", t.floor), ("ceil", t.ceil),
                         ("trunc", t.trunc), ("sign", t.sign), ("isnan", t.isnan),
                         ("isinf", t.isinf), ("nan_to_num", t.nan_to_num),
                         ("logical_not", t.logical_not)):
            setattr(self, name, lambda x, fn=fn: fn(self.asarray(x)))
        for name, fn in (("arctan2", t.atan2), ("power", t.pow), ("divide", t.div),
                         ("hypot", t.hypot), ("gcd", t.gcd),
                         ("logical_and", t.logical_and)):
            setattr(self, name, lambda x, y, fn=fn: fn(self.asarray(x), self.asarray(y)))

    def asarray(self, x):
        if isinstance(x, self.torch.Tensor):
            return x if x.device == self.device else x.to(self.device)
        dtype = self.torch.bool if isinstance(x, bool) else self.float64
        return self.torch.tensor(x, dtype=dtype, device=self.device)

    def where(self, c, x, y):
        return self.torch.where(self.asarray(c), self.asarray(x), self.asarray(y))

    def cast(self, x, dtype: str):
        return self.asarray(x).to(getattr(self.torch, dtype))


def _funcs(xp) -> Mapping[str, Callable]:
    if isinstance(xp, TorchNamespace):
        cast = xp.cast
    else:
        def cast(v, dtype):
            return v.astype(dtype)

    def _i64(x):
        # C (int64_t)double cast as the oracle's x86-64 build performs
        # it (cvttsd2si): truncate toward zero; NaN and out-of-range
        # saturate to INT64_MIN.  eval.c converts implicitly at the
        # av_gcd()/&/| call sites, so matching real av_expr means
        # matching this cast (differential fuzz vs cv2's libavutil).
        t = xp.trunc(x)
        in_range = (t >= -9.223372036854775808e18) & (t < 9.223372036854775808e18)
        return cast(xp.where(in_range, xp.nan_to_num(t), -9.223372036854775808e18), "int64")

    def _gcd(a):
        # av_gcd (libavutil/mathematics.c): a==0 -> b, b==0 -> a with
        # the SIGN KEPT; otherwise the positive binary gcd.
        ia, ib = _i64(a[0]), _i64(a[1])
        g = xp.gcd(xp.abs(ia), xp.abs(ib))
        out = xp.where(ia == 0, ib, xp.where(ib == 0, ia, g))
        return cast(out, "float64")

    def _bitop(op):
        def f(a):
            # eval.c e_bitand/e_bitor: NaN in either operand -> NaN.
            # Tested per operand — isnan(a+b) would also fire on
            # inf + (-inf), where the oracle returns the saturated
            # INT64_MIN & INT64_MIN instead (probed: bitand(1/0,-1/0))
            v = cast(op(_i64(a[0]), _i64(a[1])), "float64")
            return xp.where(xp.isnan(a[0]) | xp.isnan(a[1]), math.nan, v)
        return f

    return {
        "sin": lambda a: xp.sin(a[0]),
        "cos": lambda a: xp.cos(a[0]),
        "tan": lambda a: xp.tan(a[0]),
        "asin": lambda a: xp.arcsin(a[0]),
        "acos": lambda a: xp.arccos(a[0]),
        "atan": lambda a: xp.arctan(a[0]),
        "atan2": lambda a: xp.arctan2(a[0], a[1]),
        "sinh": lambda a: xp.sinh(a[0]),
        "cosh": lambda a: xp.cosh(a[0]),
        "tanh": lambda a: xp.tanh(a[0]),
        "exp": lambda a: xp.exp(a[0]),
        "log": lambda a: xp.log(a[0]),
        "pow": lambda a: xp.power(a[0], a[1]),
        "sqrt": lambda a: xp.sqrt(a[0]),
        "abs": lambda a: xp.abs(a[0]),
        # sgn is special-cased in the evaluator: eval.c's
        # FFDIFFSIGN(eval_expr(..), 0) macro expands its argument TWICE
        # the real av_expr's floor/ceil/trunc normalise -0.0 to +0.0
        # (round keeps the sign) — oracle-probed, libm alone would not
        "floor": lambda a: xp.floor(a[0]) + 0.0,
        "ceil": lambda a: xp.ceil(a[0]) + 0.0,
        "trunc": lambda a: xp.trunc(a[0]) + 0.0,
        # C round(): half away from zero (numpy's round is half-even —
        # round(0.5) would be 0 instead of av_expr's 1).  Computed from
        # the EXACT fraction x - trunc(x) (exact for every double):
        # floor(|x|+0.5) rounds 0.49999999999999994 up because the +0.5
        # is inexact (oracle-probed DIFF).  trunc(±inf)=±inf makes the
        # fraction NaN there, so the >= test stays false and ±inf pass
        # through; NaN propagates via trunc.
        "round": lambda a: (lambda t: xp.where(
            xp.abs(a[0] - t) >= 0.5, t + xp.sign(a[0]), t))(xp.trunc(a[0])),
        # ffmpeg eval.c e_mod is floor-based: a - floor(a/b)*b (differs
        # from C fmod for negative operands); xp.divide so mod(x, 0)
        # yields nan instead of a python ZeroDivisionError
        "mod": lambda a: a[0] - xp.floor(xp.divide(a[0], a[1])) * a[1],
        "gcd": _gcd,
        # the oracle's compiled FFMIN/FFMAX lower to x86 minsd/maxsd:
        # a NaN FIRST operand yields the second, a NaN second operand
        # yields NaN — where(a<b, a, b) reproduces both (NOT IEEE
        # minimum/maximum, which propagate either NaN)
        "max": lambda a: xp.where(a[0] > a[1], a[0], a[1]),
        "min": lambda a: xp.where(a[0] < a[1], a[0], a[1]),
        "hypot": lambda a: xp.hypot(a[0], a[1]),
        "eq": lambda a: xp.where(a[0] == a[1], 1.0, 0.0),
        "gte": lambda a: xp.where(a[0] >= a[1], 1.0, 0.0),
        "gt": lambda a: xp.where(a[0] > a[1], 1.0, 0.0),
        "lte": lambda a: xp.where(a[0] <= a[1], 1.0, 0.0),
        "lt": lambda a: xp.where(a[0] < a[1], 1.0, 0.0),
        "not": lambda a: xp.where(a[0] == 0, 1.0, 0.0),
        "isnan": lambda a: xp.where(xp.isnan(a[0]), 1.0, 0.0),
        "isinf": lambda a: xp.where(xp.isinf(a[0]), 1.0, 0.0),
        "bitand": _bitop(lambda x, y: x & y),
        "bitor": _bitop(lambda x, y: x | y),
        # between/clip are special-cased in the evaluator (argument
        # re-evaluation and && short-circuit semantics of eval.c)
        "lerp": lambda a: a[0] + (a[1] - a[0]) * a[2],
        # xp.divide: a torch scalar divisor must round once (true_div)
        "squish": lambda a: xp.divide(1.0, 1.0 + xp.exp(4.0 * a[0])),
        "gauss": lambda a: xp.divide(xp.exp(-a[0] * a[0] / 2.0), math.sqrt(2.0 * math.pi)),
    }


def _contains_stateful(node) -> bool:
    if not isinstance(node, tuple):
        return False
    if node[0] == "call" and node[1] in _STATEFUL:
        return True
    for sub in node[1:]:
        if isinstance(sub, tuple) and _contains_stateful(sub):
            return True
        if isinstance(sub, list) and any(_contains_stateful(s) for s in sub):
            return True
    return False


def _reads_persistent_state(ast) -> bool:
    """True when some ld(k) may evaluate before an unconditional st(k)
    in the same evaluation — i.e. the expression reads var-slot state
    carried over from a PREVIOUS evaluation.  eval.c keeps var[] in the
    AVExpr across calls, so the reference's per-coefficient loops make
    ``st(0, ld(0)+1)`` a running counter across points (scan evalxy,
    motion --eval); such expressions must take the sequential host path
    — the vectorised path gives every element fresh slots.  The
    idiomatic store-then-load within one evaluation stays vectorised."""
    stored: set[int] = set()  # slots unconditionally stored so far
    found = False

    def walk(node, conditional: bool) -> None:
        nonlocal found
        if found or not isinstance(node, tuple):
            return
        tag = node[0]
        if tag == "call":
            name, args = node[1], node[2]
            if name == "st":
                walk(args[0], conditional)
                walk(args[1], conditional)
                if args[0][0] == "num" and not conditional:
                    stored.add(_slot_index(args[0][1]))
                return
            if name == "ld":
                walk(args[0], conditional)
                if args[0][0] != "num" or _slot_index(args[0][1]) not in stored:
                    found = True
                return
            if name in ("if", "ifnot", "while"):
                walk(args[0], conditional)  # condition always evaluates
                for a in args[1:]:
                    walk(a, True)  # branches/body may not
                return
            if name == "between":
                walk(args[0], conditional)
                walk(args[1], conditional)
                walk(args[2], True)  # skipped when d < min (C's &&)
                return
            for a in args:
                walk(a, conditional)
            return
        for sub in node[1:]:
            walk(sub, conditional)

    walk(ast, False)
    return found


def _slot_index(v) -> int:
    """av_clip(value, 0, VARS-1) with the double->int edge cases pinned
    (nan -> 0, +/-inf clamp)."""
    v = float(v)
    if v != v:
        return 0
    return int(min(max(v, 0.0), float(_VARS - 1)))


def _slot(iv) -> int:
    """Slot index from an evaluated index expression.  Grid-valued or
    traced indexes cannot address one st()/ld() slot on the vectorised
    path — eval.c stores to exactly one var per st()."""
    if getattr(iv, "ndim", 0):
        raise ValueError("st()/ld() slot index must be a scalar")
    try:
        return _slot_index(iv)
    except Exception as e:  # a non-scalar index
        raise ValueError(
            "st()/ld() slot index must be a concrete scalar on the"
            " vectorised path (literal or constant expression)") from e


# av_reverse: bit-reversed bytes — eval.c's e_root probe order over the
# 0..max interval (coarse-to-fine coverage without a uniform stride)
_FF_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _find_root(f: Callable[[float], float], xmax: float) -> float:
    """eval.c e_root, reproduced operation-for-operation (pinned
    BIT-exactly against real libavutil in tests/test_expr_oracle.py):

    probe i=-1..1023 — the first 256 probes walk ff_reverse[i]*max/255,
    the rest decay geometrically (max*0.9^(i-255)), negated on odd i,
    anchored at the best-so-far low (i&2) or high bound; track the best
    value<=0 (low) and value>=0 (high) probes; once BOTH bound
    *positions* are >= 0, bisect to convergence.  The result is the
    bound whose value is closest to zero — so with no sign change the
    sample nearest zero comes back, and with all-NaN samples the -1.0
    bound sentinels do (observed oracle behaviour)."""
    low = high = -1.0
    low_v, high_v = -_DBL_MAX, _DBL_MAX
    for i in range(-1, 1024):
        if i < 255:
            x = _FF_REVERSE[i & 255] * xmax / 255.0
        else:
            x = xmax * (0.9 ** (i - 255))
            if i & 1:
                x = -x
            x += low if i & 2 else high
        v = f(x)
        if v <= 0.0 and v > low_v:
            low, low_v = x, v
        if v >= 0.0 and v < high_v:
            high, high_v = x, v
        if low >= 0.0 and high >= 0.0:
            for _ in range(1000):
                mid = (low + high) * 0.5
                if mid == low or mid == high:
                    break
                v = f(mid)
                if v <= 0.0:
                    low = mid
                if v >= 0.0:
                    high = mid
                if v != v:
                    low = high = v
                    break
            break
    return low if -low_v < high_v else high


def _cast_u64(v: float) -> int:
    """C ``(uint64_t)double`` as x86-64 compilers emit it (the oracle's
    observed behaviour): values < 2^63 truncate via the signed convert
    (negatives wrap two's-complement, overflow saturates to INT64_MIN);
    larger values convert shifted by 2^63 and flip the top bit — so
    1e300 lands on 0."""
    if v != v:
        return 0
    if v < 2.0 ** 63:
        t = -(1 << 63) if v <= -(2.0 ** 63) else int(v)
        return t & _U64
    w = v - 2.0 ** 63
    t = -(1 << 63) if w >= 2.0 ** 63 else int(w)
    return (t ^ (1 << 63)) & _U64


def _sfc64_init(seed: int) -> list:
    """ff_sfc64_init(seed, seed, seed, 12 rounds) — modern eval.c seeds
    random()'s generator from the var slot on first use per slot."""
    s = [seed & _U64, seed & _U64, seed & _U64, 1]
    for _ in range(12):
        _sfc64_get(s)
    return s


def _sfc64_get(s: list) -> int:
    a, b, c, counter = s
    tmp = (a + b + counter) & _U64
    s[3] = (counter + 1) & _U64
    s[0] = b ^ (b >> 11)
    s[1] = (c + ((c << 3) & _U64)) & _U64
    s[2] = ((((c << 24) | (c >> 40)) & _U64) + tmp) & _U64
    return tmp


class Expr:
    """A parsed expression, evaluable over numpy arrays on the host.

    ``stateful`` is True when the AST contains an iterative/stateful
    av_expr form (random/randomi/while/root/taylor/time) OR reads var
    slots persisted from a previous evaluation (``st(0, ld(0)+1)`` is a
    running counter across coefficients in the reference's loops —
    see :func:`_reads_persistent_state`); those evaluate on the host
    — scalars directly, grids per element in raster order (the
    reference's per-coefficient loop, motion/motion.c:670-681) — with
    st()/ld()/random() slots persisting across evaluations of this
    parsed expression, as eval.c keeps them in ``AVExpr->var``.
    """

    def __init__(self, source: str, var_names: tuple[str, ...]):
        self.source = source
        self.var_names = tuple(var_names)
        self.ast = _Parser(_tokenize(source), self.var_names).parse()
        self.stateful = (_contains_stateful(self.ast)
                         or _reads_persistent_state(self.ast))
        # persistent slots for stateful evaluation only; the vectorised
        # path keeps per-call state
        self._slots: dict[int, float] = {}
        # per-slot sfc64 states (modern eval.c keeps FFSFC64 prng_state
        # alongside var[] in the AVExpr)
        self._prng: dict[int, list] = {}

    def reset_state(self) -> None:
        self._slots.clear()
        self._prng.clear()

    def __call__(self, variables: Mapping[str, Any], xp=None):
        """Evaluate over ``variables`` (scalars or broadcastable grids)
        with numpy (the default) or a :class:`TorchNamespace`.  A stateful
        expression evaluates per element in raster order on the host in
        float64; under the torch namespace its result returns to the
        device in ``xp.dtype``."""
        if xp is None:
            import numpy as xp  # noqa: PLC0415
        if not self.stateful:
            return self._eval_tree(variables, xp, {}, scalar=False)
        import numpy as np  # noqa: PLC0415

        if isinstance(xp, TorchNamespace):
            host = {k: (v.detach().to("cpu", xp.float64).numpy()
                        if isinstance(v, xp.torch.Tensor) else v)
                    for k, v in variables.items()}
            return xp.torch.from_numpy(np.asarray(self(host, np), np.float64)).to(
                xp.device, xp.dtype)
        if xp.__name__ != "numpy":
            raise ValueError(
                f"expression {self.source!r} uses a stateful av_expr form"
                " (random/while/root/taylor): it evaluates with numpy or"
                " through a TorchNamespace")
        arrs = {k: np.asarray(v, dtype=np.float64)
                for k, v in variables.items()}
        shape = (np.broadcast_shapes(*(a.shape for a in arrs.values()))
                 if arrs else ())
        with np.errstate(all="ignore"):
            if shape == ():
                return self._eval_tree(arrs, np, self._slots, scalar=True)
            grids = {k: np.broadcast_to(a, shape) for k, a in arrs.items()}
            out = np.empty(shape, np.float64)
            for idx in np.ndindex(shape):
                out[idx] = self._eval_tree(
                    {k: g[idx] for k, g in grids.items()},
                    np, self._slots, scalar=True)
            return out

    def _eval_tree(self, variables: Mapping[str, Any], xp,
                   slots: dict[int, Any], scalar: bool):
        funcs = _funcs(xp)
        # av_expr evaluates if()/ifnot() branches lazily, so an st()
        # inside an untaken branch must not fire.  Vectorised over
        # grids, both branches are computed but stores merge through
        # the active branch-condition masks, element-wise.
        mask_stack: list[Any] = []

        def _store(idx: int, v):
            if mask_stack:
                m = mask_stack[0]
                for mm in mask_stack[1:]:
                    m = xp.logical_and(m, mm)
                v = xp.where(m, v, slots.get(idx, 0.0))
            slots[idx] = v

        def ev(node):
            tag = node[0]
            if tag == "num":
                return node[1]
            if tag == "var":
                return variables[node[1]]
            if tag == "vneg":
                inner = node[1]
                v = ev(inner)
                if inner[0] == "call" and inner[1] in _EVALUE_DROPPED:
                    return v  # e->value ignored by this opcode
                return -v
            if tag == "seq":
                ev(node[1])  # evaluated for st() side effects
                return ev(node[2])
            if tag in ("+", "-", "*", "/", "^"):
                a, b = ev(node[1]), ev(node[2])
                if tag == "+":
                    return a + b
                if tag == "-":
                    return a - b
                if tag == "*":
                    return a * b
                if tag == "/":
                    # eval.c e_div: ``d2 ? d / d2 : d * INFINITY`` — a
                    # zero divisor of EITHER sign gives d * +inf (so
                    # -2/-0.0 is -inf, not IEEE's +inf), and 0/0 is NaN
                    bz = xp.asarray(b) == 0
                    return xp.where(bz, xp.asarray(a) * math.inf,
                                    xp.divide(a, xp.where(bz, 1.0, b)))
                return xp.power(a, b)
            if tag == "call":
                name, args = node[1], node[2]
                if name in ("if", "ifnot"):
                    c = ev(args[0])
                    if scalar:
                        # eval.c is lazy: only the taken branch runs
                        # (an st()/while in the other must not fire)
                        taken = (float(c) != 0.0) == (name == "if")
                        if taken:
                            return ev(args[1])
                        return ev(args[2]) if len(args) > 2 else 0.0
                    taken = xp.asarray(c != 0 if name == "if" else c == 0)
                    mask_stack.append(taken)
                    t = ev(args[1])
                    mask_stack.pop()
                    mask_stack.append(xp.logical_not(taken))
                    e = ev(args[2]) if len(args) > 2 else 0.0
                    mask_stack.pop()
                    return xp.where(taken, t, e)
                if name == "clip":
                    # eval.c e_clip evaluates the subject, then min,
                    # then max; a NaN in ANY of the three or inverted
                    # bounds returns NaN WITHOUT re-evaluation.
                    # Otherwise the subject evaluates a SECOND time
                    # (st() counters inside it advance twice) and the
                    # value is av_clipd = FFMIN(FFMAX(d,min),max) with
                    # the compiled minsd/maxsd NaN rule — a NaN
                    # re-evaluation clamps to min, it does not
                    # propagate.  All probed against the real av_expr
                    # with st-counter probes.
                    d1 = ev(args[0])
                    lo, hi = ev(args[1]), ev(args[2])
                    bad = (xp.isnan(d1) | xp.isnan(lo) | xp.isnan(hi)
                           | (lo > hi))
                    if scalar:
                        if bool(bad):
                            return math.nan
                        d = ev(args[0])
                        m = xp.where(d > lo, d, lo)
                        return xp.where(m < hi, m, hi)
                    good = xp.logical_not(xp.asarray(bad))
                    mask_stack.append(good)
                    d = ev(args[0])
                    mask_stack.pop()
                    m = xp.where(d > lo, d, lo)
                    return xp.where(bad, math.nan, xp.where(m < hi, m, hi))
                if name == "between":
                    # eval.c: d >= min && d <= max with C's && — the
                    # max argument only evaluates where the first test
                    # passes (its st() side effects are skipped too)
                    d = ev(args[0])
                    ge = d >= ev(args[1])
                    if scalar:
                        if not bool(ge):
                            return 0.0
                        return xp.where(d <= ev(args[2]), 1.0, 0.0)
                    ge = xp.asarray(ge)
                    mask_stack.append(ge)
                    hi = ev(args[2])
                    mask_stack.pop()
                    return xp.where(ge & (d <= hi), 1.0, 0.0)
                if name == "sgn":
                    # eval.c e_sgn is e->value * FFDIFFSIGN(eval_expr(
                    # p, e->param[0]), 0) — the macro ((x)>(y))-((x)<(y))
                    # expands its argument TWICE: side effects fire
                    # twice, the FIRST evaluation feeds '>' and the
                    # SECOND feeds '<' (st-counter probed: with an
                    # st(0, ld(0)+6) argument crossing zero the oracle
                    # returns 0 where single-eval sgn says 1; plain
                    # comparisons also make sgn(NaN) 0, not NaN)
                    d1 = ev(args[0])
                    d2 = ev(args[0])
                    return (xp.where(d1 > 0, 1.0, 0.0)
                            - xp.where(d2 < 0, 1.0, 0.0))
                if name == "st":
                    # eval.c: the slot index is itself an expression,
                    # av_clip'ed to 0..VARS-1.  The vectorised path
                    # needs one concrete slot per store, so a
                    # grid/traced index stays rejected there.
                    idx = _slot(ev(args[0]))  # index before value, as eval.c
                    v = ev(args[1])
                    _store(idx, v)
                    # modern eval.c: st() re-arms the slot's sfc64 so a
                    # subsequent random() re-seeds from the stored value
                    # (oracle-pinned: repeated "st(4,42); random(4)"
                    # evaluations each return the seed-42 first draw)
                    self._prng.pop(idx, None)
                    return v
                if name == "ld":
                    return slots.get(_slot(ev(args[0])), 0.0)
                if name == "print":
                    v = ev(args[0])
                    if len(args) > 1:
                        ev(args[1])  # log level: evaluated, stderr either way
                    import numpy as _np  # noqa: PLC0415

                    if isinstance(xp, TorchNamespace):
                        v = xp.asarray(v)
                        hv = v.detach().cpu().numpy()
                    else:
                        hv = v
                    msg = (f"{float(hv):f}" if _np.ndim(hv) == 0
                           else _np.array2string(_np.asarray(hv)))
                    print(msg, file=sys.stderr)
                    return v
                if name == "time":
                    for a in args:
                        ev(a)  # time(0): the argument is evaluated, unused
                    return _time.time()
                if name in _STATEFUL:
                    if not scalar:
                        raise ValueError(
                            f"{name}() is stateful and only evaluates on"
                            " the host scalar path")
                    if name in ("random", "randomi"):
                        # modern eval.c (FFmpeg >= 6.1) e_random: each
                        # slot owns an sfc64 generator, seeded from the
                        # var slot (C double->uint64 cast) on first use;
                        # the raw 64-bit draw is stored back into the
                        # slot.  Bit-exact vs real libavutil
                        # (tests/test_expr_oracle.py).
                        i = _slot_index(ev(args[0]))
                        s = self._prng.get(i)
                        if s is None:
                            s = _sfc64_init(_cast_u64(float(slots.get(i, 0.0))))
                            self._prng[i] = s
                        r = _sfc64_get(s)
                        slots[i] = float(r)
                        u = r * (1.0 / _U64)
                        if name == "random":
                            return u
                        lo = float(ev(args[1]))
                        hi = float(ev(args[2]))
                        return lo + (hi - lo) * u
                    if name == "while":
                        # returns NaN when the condition never held; a
                        # NaN condition loops, as in C (nan != 0)
                        d = float("nan")
                        while float(ev(args[0])) != 0.0:
                            d = float(ev(args[1]))
                        return d
                    if name == "root":
                        xmax = float(ev(args[1]))
                        saved = slots.get(0, 0.0)

                        def froot(t: float) -> float:
                            slots[0] = t
                            return float(ev(args[0]))

                        try:
                            return _find_root(froot, xmax)
                        finally:
                            slots[0] = saved
                    # taylor(expr, x[, id]): expr is the ld(id)-th
                    # derivative at 0; sum t_n * x^n / n! until the
                    # accumulator stops moving on a nonzero term
                    x = float(ev(args[1]))
                    sid = _slot_index(ev(args[2])) if len(args) > 2 else 0
                    saved = slots.get(sid, 0.0)
                    t, d = 1.0, 0.0
                    try:
                        for i in range(1000):
                            prev = d
                            slots[sid] = float(i)
                            v = float(ev(args[0]))
                            d = d + t * v
                            if d == prev and v != 0.0:
                                break
                            t *= x / (i + 1)
                    finally:
                        slots[sid] = saved
                    return d
                if name in funcs:
                    return funcs[name]([ev(a) for a in args])
                raise ValueError(f"unsupported function {name!r}")
            raise AssertionError(node)

        if xp.__name__ == "numpy":
            # ffmpeg-eval semantics propagate NaN/inf silently (scan
            # methods *rely* on NaN to mark skipped points); keep numpy
            # from warning
            import numpy as _np  # noqa: PLC0415

            with _np.errstate(invalid="ignore", divide="ignore",
                              over="ignore"):
                return ev(self.ast)
        return ev(self.ast)


def parse_expr(source: str, var_names) -> Expr:
    return Expr(source, tuple(var_names))
