"""PyTorch/CUDA port of the Squeezy reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and public functions so that the two can be run on the same inputs
and compared.  It imports torch, numpy and the standard library only, never
JAX and never ``repro``: the plain-Python modules it needs from the JAX
package are kept here as copies (``configs``, ``core.hotmem``,
``serving.request``, ``serving.tracegen`` and four ``cluster`` modules).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  On a CUDA tensor every kernel wrapper in
``repro_torch.kernels.ops`` launches a hand-written Hopper kernel (built
from ``kernels/csrc`` with ``nvcc`` at first use); on a CPU tensor it runs
the kernel's plain PyTorch version from ``kernels/ref.py``.
"""
