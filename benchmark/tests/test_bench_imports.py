"""No module of the benchmark imports JAX or the JAX package, and no module
of the reference imports the program, each by its whole top-level name."""

import ast
from pathlib import Path

from benchmark.cell import ROOT

BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "paddle_lite_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_jax_anywhere():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not imported(p) & JAX, p


def test_reference_is_plain():
    for p in (BENCH / "reference").glob("*.py"):
        assert "paddle_lite_tpu_torch" not in imported(p), p
        assert not imported(p) & JAX, p


def test_check_counts_whole_names():
    from benchmark.run import FORBIDDEN

    assert "paddle_lite_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "paddle_lite_tpu" in FORBIDDEN
