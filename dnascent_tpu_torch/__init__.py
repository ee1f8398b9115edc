"""dnascent_tpu_torch — the PyTorch/CUDA port of dnascent_tpu.

The port runs ``detect``'s main path (CNN calls, fast eventalign, the
static-stdv pore model; ``.detect`` or modbam ``.bam`` output) on one device
given explicitly: every entry point takes a ``device``.  On a CUDA device the
banded fills, backtrace chase, Viterbi fill and Viterbi backtrace and the
reference CNN's GRU encoder run as hand-written Hopper kernels (``csrc/``);
on the CPU the same wrappers run their plain PyTorch twins.  What follows
detect (``index``, ``forkSense``, ``seeBreaks``, ``tools/bedgraph``) runs on
the host, as in the JAX package, except ``seeBreaks --fast``, whose
bootstrap draws run on the caller's device.  ``detect --HMM`` (the forward
algorithm) and ``trainCNN --fit`` (autograd and AdamW through either CNN)
run in torch ops on the caller's device.

The port is self-contained: it carries its own copies of the host layer it
needs (config, io, native, sources, testing helpers) and imports neither
jax nor anything of the JAX package ``dnascent_tpu``.
"""

__version__ = "0.1.0"
