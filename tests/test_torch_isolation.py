"""The port's first rule: ``src/repro_torch``, ``chip_smoke.py``, the
port's tools (``tools/*.py``) and its examples (``examples_torch/*.py``)
import ``torch`` and never ``jax`` nor anything of the JAX package
``repro`` —
not at module level and not inside a function. Each file is parsed with
``ast`` (nothing is imported), one case per file."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                         *(ROOT / "tools").glob("*.py"),
                         *(ROOT / "examples_torch").glob("*.py")]) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_the_port_has_files():
    assert len(FILES) > 20 and "src/repro_torch/launch/serve.py" in FILES
    assert len([p for p in FILES if p.startswith("examples_torch/")]) == 6


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_check_sees_a_forbidden_import():
    tree = ast.parse("def f():\n    from repro.models import layers\n    import jax.numpy\n"
                     "import repro_torch\nimport importlib\nimportlib.import_module('repro.x')\n")
    mods = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert mods == ["repro.models", "jax.numpy", "repro.x"]
