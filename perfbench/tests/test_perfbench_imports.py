"""No module of the benchmark imports JAX, its relatives or the JAX
package, judged on each import's whole top-level name (the port's name
begins with the JAX package's); the reference imports nothing of the
port either."""

import ast
import os

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dnascent_tpu"}
BENCH = os.path.join(ROOT, "perfbench")


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_benchmark_imports_no_jax():
    bad = {(p, m) for p in _sources(BENCH) for m in _imports(p)
           if m in FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_port():
    bad = {(p, m) for p in _sources(os.path.join(BENCH, "reference"))
           for m in _imports(p)
           if m in FORBIDDEN | {"dnascent_tpu_torch", "perfbench"}}
    assert not bad


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import dnascent_tpu_torch.pipeline\n"
                 "from dnascent_tpu.ops import reference\n")
    assert list(_imports(str(p))) == ["dnascent_tpu_torch", "dnascent_tpu"]
