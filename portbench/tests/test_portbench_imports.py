"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "simple_multimodal_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "simple_multimodal_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) - {"torch", "numpy", "math", "hashlib", "re"}


def test_the_check_compares_whole_names():
    import sys

    sys.path.insert(0, str(HERE))
    import run

    assert "simple_multimodal_tpu_torch" not in run.forbidden_modules()
    assert "simple_multimodal_tpu" in run.FORBIDDEN
