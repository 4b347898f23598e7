"""Minimal ImageMagick-style color specification parser (copy of
``dspfun_tpu/tools/_colorspec.py``, pinned to it by
tests/test_torch_basis.py).

Covers the forms the reference documents for --bg
(applybasis.c:171, genbasis.c:123): named colors, #RGB / #RRGGBB /
#RRGGBBAA hex, and rgb()/rgba() with numeric or percent components.
"""

from __future__ import annotations

import re

_NAMED = {
    "black": (0, 0, 0, 1), "white": (1, 1, 1, 1), "red": (1, 0, 0, 1),
    "green": (0, 0.5, 0, 1), "lime": (0, 1, 0, 1), "blue": (0, 0, 1, 1),
    "yellow": (1, 1, 0, 1), "cyan": (0, 1, 1, 1), "magenta": (1, 0, 1, 1),
    "gray": (0.5, 0.5, 0.5, 1), "grey": (0.5, 0.5, 0.5, 1),
    "none": (0, 0, 0, 0), "transparent": (0, 0, 0, 0),
}

_FUNC_RE = re.compile(r"rgba?\(([^)]*)\)$", re.IGNORECASE)


def parse_color(spec: str) -> tuple[float, float, float, float]:
    """Returns (r, g, b, a) in [0, 1]; raises ValueError on bad input."""
    s = spec.strip().lower()
    if s in _NAMED:
        return _NAMED[s]
    if s.startswith("#"):
        hexpart = s[1:]
        if len(hexpart) == 3:
            r, g, b = (int(c, 16) / 15.0 for c in hexpart)
            return (r, g, b, 1.0)
        if len(hexpart) in (6, 8):
            vals = [int(hexpart[i : i + 2], 16) / 255.0
                    for i in range(0, len(hexpart), 2)]
            if len(vals) == 3:
                vals.append(1.0)
            return tuple(vals)  # type: ignore[return-value]
        raise ValueError(f"bad hex color {spec!r}")
    m = _FUNC_RE.match(s)
    if m:
        parts = [t.strip() for t in m.group(1).split(",")]
        vals = []
        for i, t in enumerate(parts):
            if t.endswith("%"):
                vals.append(float(t[:-1]) / 100.0)
            else:
                v = float(t)
                # rgb() numeric channel values are 0-255 (ImageMagick's
                # convention — uniformly, so rgb(1,2,3) is near-black,
                # not a mixed-scale bright red); alpha is 0-1
                vals.append(v / 255.0 if i < 3 else v)
        if len(vals) == 3:
            vals.append(1.0)
        if len(vals) != 4:
            raise ValueError(f"bad color {spec!r}")
        return tuple(vals)  # type: ignore[return-value]
    raise ValueError(f"unrecognised color {spec!r}")
