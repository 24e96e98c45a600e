"""What the benchmark may import: no JAX, no JAX package; the reference
nothing of the port.  Top-level module names are compared whole: the port's
name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "srsran_projectvtlmo_tpu", "bench", "benchmarks",
             "chip_smoke"}
PORT = "srsran_projectvtlmo_tpu_torch"


def imported_top_levels(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_run_time_check_compares_whole_top_level_names(monkeypatch):
    """The harness's look at sys.modules once the window has closed: the
    port's name begins with the JAX package's and must not match it."""
    import sys
    import types

    from portbench import harness

    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, PORT + ".fake", types.ModuleType("fake"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "srsran_projectvtlmo_tpu.fake", types.ModuleType("fake"))
    assert "srsran_projectvtlmo_tpu" in harness.forbidden_modules()


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_top_levels(path)
    assert not any(isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "import_module"
                   for n in ast.walk(ast.parse(path.read_text())))
