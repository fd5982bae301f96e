"""Nothing under portbench/ imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
nothing reads the JAX package's harness folder, and the references import
nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent)]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_HARNESS = "bench" + "marks"  # the JAX package's harness folder


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not _top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_nothing_reads_the_jax_harness():
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".md"):
            text = path.read_text()
            assert f"{JAX_HARNESS}/" not in text and \
                f'"{JAX_HARNESS}"' not in text, path


def test_the_runtime_check_compares_whole_names():
    from portbench.harness import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.serve",
                              "reproducible", "jaxtyping"]) == []
    assert forbidden_modules(["repro.core", "jax", "jaxlib.xla_client",
                              "flax"]) == ["flax", "jax", "jaxlib", "repro"]
