"""What the benchmark may import: nothing of JAX, of the JAX package
``repro`` or of the old ``benchmarks`` (top-level names compared whole, so
``repro_torch`` passes), and the plain reference nothing of the port or of
the harness."""
import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent
FILES = sorted(HERE.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imports(path):
    """Every module name a file imports, dotted."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value)
    return names


def top_level_imports(path):
    return {n.split(".")[0] for n in imports(path)}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_no_reference_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in imports(path):
        assert name in {"__future__", "math", "typing", "torch"} \
            or name.startswith("perfbench.reference"), name


def test_prefix_of_the_port_is_not_the_jax_package():
    assert "repro_torch".split(".")[0] not in BANNED
