"""dnascent_tpu_torch — the PyTorch/CUDA port of dnascent_tpu.

The port runs ``detect``'s main path (CNN calls, fast eventalign, the
static-stdv pore model) on one device given explicitly: every entry point
takes a ``device``.  On a CUDA device the banded fill, backtrace chase,
Viterbi fill and Viterbi backtrace run as hand-written Hopper kernels
(``csrc/``); on the CPU the same wrappers run their plain PyTorch twins.

The port is self-contained: it carries its own copies of the host layer it
needs (config, io, native, sources, testing helpers) and imports neither
jax nor anything of the JAX package ``dnascent_tpu``.
"""

__version__ = "0.1.0"
