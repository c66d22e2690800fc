"""Nothing the benchmark runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program either. Module names are compared
by their top-level name, whole: `dau_convnet_tpu_torch` is not
`dau_convnet_tpu`."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "dau_convnet_tpu"}


def _sources(under: Path):
    return sorted(p for p in under.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts)


def _top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_the_walk_finds_the_benchmark():
    found = {p.relative_to(ROOT).as_posix() for p in _sources(ROOT)}
    assert {"run.py", "harness.py", "reference/dau.py", "loads/train.py",
            "metrics/setup_s.py"} <= found


@pytest.mark.parametrize("path", _sources(ROOT), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_top_names(path) & BANNED), path


@pytest.mark.parametrize("path", _sources(ROOT / "reference"),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    assert "dau_convnet_tpu_torch" not in _top_names(path)
    assert not (_top_names(path) & BANNED)


def test_names_are_compared_whole():
    assert "dau_convnet_tpu_torch".split(".")[0] not in BANNED
    tree = ast.parse("import dau_convnet_tpu_torch.models\nfrom dau_convnet_tpu.ops import x\n")
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    assert tops == {"dau_convnet_tpu_torch"} and not tops & BANNED
