"""``dnascent_tpu_torch/graft_entry.py`` (the counterpart of
``__graft_entry__.py``) on the CPU against the JAX entry's shapes."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_graft_entry_matches_jax_entry():
    """``entry(device="cpu")`` gives the JAX ``entry()``'s inputs and a
    finite output of its shape; ``dryrun_multichip(2, device="cpu")``
    passes both of its checks; by default it runs on the card, and asking
    for more cards than are visible raises."""
    from dnascent_tpu_torch import graft_entry

    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    jge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jge)
    jfn, jargs = jge.entry()
    jshape = jax.eval_shape(jfn, *jargs).shape

    torch.set_num_threads(2)
    fn, args = graft_entry.entry(device="cpu")
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    out = fn(*args)
    assert tuple(out.shape) == jshape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)

    assert graft_entry.dryrun_multichip(2, device="cpu") is None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises((RuntimeError, ValueError)):
        graft_entry.dryrun_multichip(n + 1)  # the card by default
