"""No module of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` is not ``repro``), and
the reference, the work arithmetic and the inputs import nothing of the
program either. Each file is parsed with ``ast``, one case a file."""
import ast

import pytest

from conftest import ROOT

BENCH = ROOT / "portbench"
FILES = sorted(p.relative_to(ROOT).as_posix() for p in BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: imports nothing of the program under test
PLAIN = ("portbench/reference/", "portbench/work/", "portbench/inputs/")


def imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def bad_imports(path: str, source: str):
    tops = {m.split(".")[0] for m in imported(ast.parse(source))}
    bad = tops & FORBIDDEN
    if path.startswith(PLAIN):
        bad |= tops & {"repro_torch"}
    return sorted(bad)


def test_the_benchmark_has_its_files():
    assert "portbench/run.py" in FILES
    assert any(p.startswith("portbench/reference/") for p in FILES)


@pytest.mark.parametrize("path", FILES)
def test_no_jax_no_reference_package(path):
    assert bad_imports(path, (ROOT / path).read_text()) == []


@pytest.mark.parametrize("path, source, bad", [
    ("portbench/drivers/x.py", "import repro_torch.fl\nfrom repro_torch import fl\n", []),
    ("portbench/drivers/x.py", "def f():\n    import jax.numpy\n", ["jax"]),
    ("portbench/drivers/x.py", "from repro.core import fedavg\n", ["repro"]),
    ("portbench/drivers/x.py", "import importlib\nimportlib.import_module('flax.linen')\n",
     ["flax"]),
    ("portbench/reference/x.py", "from repro_torch.models import layers\n", ["repro_torch"]),
    ("portbench/work/x.py", "import repro_torch\n", ["repro_torch"]),
])
def test_the_scan_sees_a_forbidden_import(path, source, bad):
    assert bad_imports(path, source) == bad
