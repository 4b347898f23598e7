"""dspfun-torch — dispatcher for the tool CLIs the port has (PyTorch port
of ``dspfun_tpu/tools/main.py``).

``dspfun-torch <tool> [options]`` runs any of the JAX package's ten
tools: ``spec``, ``ispec``, ``motion``, ``scan``, ``zoom``, ``applybasis``,
``genbasis``, ``draw``, ``rotate`` and ``transcode``.  A tool of the JAX
package that the port lacks goes into ``NOT_PORTED`` with the ROADMAP
item that ports it, and is refused with exit code 1 (none is, now).
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {
    "spec": "dspfun_tpu_torch.tools.spec",
    "ispec": "dspfun_tpu_torch.tools.ispec",
    "motion": "dspfun_tpu_torch.tools.motion",
    "scan": "dspfun_tpu_torch.tools.scan",
    "zoom": "dspfun_tpu_torch.tools.zoom",
    "applybasis": "dspfun_tpu_torch.tools.applybasis",
    "genbasis": "dspfun_tpu_torch.tools.genbasis",
    "draw": "dspfun_tpu_torch.tools.draw",
    "rotate": "dspfun_tpu_torch.tools.rotate",
    "transcode": "dspfun_tpu_torch.tools.transcode",
}

# the JAX package's tools the port lacks, and the ROADMAP queue 1 item of each
NOT_PORTED: dict[str, int] = {}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: dspfun-torch <tool> [options]\n\ntools:", file=sys.stderr)
        for name in TOOLS:
            print(f"   {name}", file=sys.stderr)
        return 0 if argv else 1
    name = argv[0]
    if name in NOT_PORTED:
        print(f"{name} is not ported to dspfun_tpu_torch yet (ROADMAP.md queue 1, "
              f"item {NOT_PORTED[name]}); use dspfun_tpu.tools.{name}", file=sys.stderr)
        return 1
    if name not in TOOLS:
        print(f"unknown tool {name!r}; available: {' '.join(TOOLS)}",
              file=sys.stderr)
        return 1
    mod = importlib.import_module(TOOLS[name])
    return mod.main(argv[1:])


if __name__ == "__main__":
    from dspfun_tpu_torch.tools import run_main

    run_main(main)
