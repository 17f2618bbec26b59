"""Nothing of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program: each module's imports are read
from its source and compared by whole top-level name.  A run also looks in
``sys.modules`` once its window has closed."""
import ast
import sys
from pathlib import Path

from perfbench import harness

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    """Top-level names of the absolute imports, and the perfbench modules
    the relative ones name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
    return names


def modules():
    return sorted(HERE.rglob("*.py"))


def test_every_module_is_read():
    found = {p.relative_to(HERE).as_posix() for p in modules()}
    assert {"run.py", "harness.py", "reference/dense_lm.py", "runners/prefill.py",
            "metrics/mfu.prefill.py"} <= found


def test_nothing_imports_jax_or_the_jax_package():
    bad = {p.relative_to(HERE).as_posix(): sorted(imported(p) & FORBIDDEN) for p in modules()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_references_import_nothing_of_the_program():
    for p in sorted((HERE / "reference").glob("*.py")):
        names = imported(p)
        assert "repro_torch" not in names, p
        assert names <= {"__future__", "contextlib", "math", "torch"}, (p, names)


def test_the_top_level_name_is_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro_torch import kernels\n")
    assert imported(probe) & FORBIDDEN == set()
    probe.write_text("import repro.core\n")
    assert imported(probe) & FORBIDDEN == {"repro"}


def test_a_run_finds_the_loaded_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax.core", object())
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    found = harness.forbidden_modules()
    assert "flax" in found and not any(f.startswith("repro_torch") for f in found)
