"""No module of the benchmark imports JAX or the JAX package, and the
reference (with the generator it reads) imports nothing of the port.
Top-level module names are compared whole: ``repro_torch`` begins with
``repro`` and is allowed where the port may be."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def top_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_imports(path) & BANNED


@pytest.mark.parametrize("name", ["reference.py", "modelgen.py",
                                  "roofline.py", "stats.py", "traffic.py"])
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_imports(HERE / name)
    assert top_imports(HERE / name) <= {"__future__", "json", "math",
                                         "pathlib", "statistics", "numpy",
                                         "torch"}


def test_the_top_level_name_is_compared_whole():
    assert "repro_torch".split(".")[0] not in BANNED
