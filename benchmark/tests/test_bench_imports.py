"""Nothing under benchmark/ imports JAX or the JAX package; the reference
imports nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "foldseek_tpu"}


def modules_under(root):
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules_under(BENCH)))
def test_no_jax_import(path):
    # whole top-level names: foldseek_tpu_torch is not foldseek_tpu
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in modules_under(os.path.join(BENCH, "reference")):
        assert "foldseek_tpu_torch" not in set(top_level_imports(path)), path


def test_only_the_driver_imports_the_program():
    users = {os.path.relpath(p, BENCH) for p in modules_under(BENCH)
             if "foldseek_tpu_torch" in set(top_level_imports(p))
             and "/tests/" not in p}
    assert users == {os.path.join("drivers", "search.py")}


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness; "
            "import benchmark.drivers.search, benchmark.checks.mode1, "
            "benchmark.checks.mode3, benchmark.reference.expect; "
            "import foldseek_tpu_torch.search.pipeline, "
            "foldseek_tpu_torch.search.convertalis; "
            "print(harness.forbidden_modules())") % os.path.dirname(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=dict(
                             os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip() == "[]"
