"""What the benchmark's modules import, by top-level name compared whole."""

import ast
import sys
import types
from pathlib import Path

from portbench.run import forbidden_modules

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "gfnet_tpu"}


def imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts]


def test_nothing_on_the_chip_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imports(path) & JAX, path


def test_only_the_drivers_import_the_program():
    for path in sources():
        if "gfnet_tpu_torch" in imports(path):
            assert path.parent.name == "drivers", path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert not imports(path) & (JAX | {"gfnet_tpu_torch"}), path


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "gfnet_tpu_torch_fake", types.ModuleType("gfnet_tpu_torch_fake"))
    assert forbidden_modules() == [n for n in sorted(sys.modules) if n.split(".")[0] in JAX]
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert "flax.core" in forbidden_modules()
