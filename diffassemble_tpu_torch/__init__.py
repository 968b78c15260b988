"""diffassemble_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

The JAX package (this package's name without ``_torch``) is the reference;
this package mirrors its module layout (``data``, ``ops``, ``nn``,
``models``, ``train``, ``utils``, ``cli``) so that each module's counterpart
is found under the same path. It imports torch and numpy only. The masked
graph attention, whose forward and two backward passes were the JAX
package's Pallas kernels, runs on three hand-written CUDA kernels
(``csrc/masked_attention_fwd.cu``, ``csrc/masked_attention_bwd.cu``) built
with ``nvcc`` at first use and bound through ``ctypes``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

__version__ = "0.1.0"

# the JAX package the port is held against
REFERENCE_PACKAGE = __name__.removesuffix("_torch")
