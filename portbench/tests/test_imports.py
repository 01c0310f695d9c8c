"""Nothing under portbench/ imports the JAX stack or the JAX package (top-level
module names compared whole: the port's name only begins with the JAX
package's), and the plain references import nothing of the port."""

import ast
import os

from portbench import harness

PORT = "anime_illust_image_searcher_tpu_torch"


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(harness.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    bad = {(p, m) for p in _sources() for m in _imports(p) if m in harness.FORBIDDEN_MODULES}
    assert not bad


def test_references_import_nothing_of_the_port():
    bad = {(p, m) for p in _sources("reference") for m in _imports(p) if m == PORT}
    assert not bad


def test_the_scan_tells_the_names_apart(tmp_path):
    p = tmp_path / "x.py"
    p.write_text(f"import {PORT}.models\nfrom jax import numpy\nimport flax.linen\n")
    assert set(_imports(str(p))) == {PORT, "jax", "flax"}
    assert PORT not in harness.FORBIDDEN_MODULES
