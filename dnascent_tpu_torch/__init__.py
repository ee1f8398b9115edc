"""dnascent_tpu_torch — the PyTorch/CUDA port of dnascent_tpu.

The port runs ``detect``'s main path (CNN calls, fast eventalign, the
static-stdv pore model) on one device given explicitly: every entry point
takes a ``device``.  On a CUDA device the banded fill, backtrace chase,
Viterbi fill and Viterbi backtrace run as hand-written Hopper kernels
(``csrc/``); on the CPU the same wrappers run their plain PyTorch twins.

The port reuses the JAX package's jax-free host modules (config, io, native,
reference ops, sources, testing) and never imports jax.  Importing any
``dnascent_tpu`` module runs ``dnascent_tpu/__init__.py``, which turns on the
jax compile cache unless ``DNASCENT_TPU_NO_CACHE`` is set, so it is set here
before the first such import.
"""

import os as _os

_os.environ.setdefault("DNASCENT_TPU_NO_CACHE", "1")

__version__ = "0.1.0"
