"""dspfun_tpu_torch — the PyTorch + CUDA port of ``dspfun_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``core/``, ``ops/``, ``models/``, ``io/``, ``tools/``) and public names, runs its device math
in PyTorch, and replaces each Pallas kernel with a kernel written by hand
for Hopper (``csrc/``, built at first use by ``_build``).  It imports
``torch`` and never JAX or ``dspfun_tpu``.

Ported so far: the whole-image DCT chain — precision policy, plans,
the exact and int8 digit contractions, the fused filter chains and the
spec/ispec compute pipelines — and motion: the blockwise 3-D chain with
the fused Kronecker block filter, y4m video I/O and the motion CLI
(``tools/motion.py``) — and the int8 contraction with the operand split
inside the kernel, with the calibration scripts that run it
(``benchmarks/``).
"""

__version__ = "0.1.0"

from dspfun_tpu_torch.core.precision import Precision, get_precision, set_precision

__all__ = ["Precision", "get_precision", "set_precision", "__version__"]
