"""The PyTorch port stands alone: it imports neither jax nor the JAX package
``repro``, imports without triton or nvcc, and its entry points target CUDA
unless told otherwise — raising where there is no GPU, never carrying on
quietly on the CPU."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_runs_without_jax_or_repro():
    # a subprocess: tests/conftest.py imports repro.core in this process
    res = _run("""
        import sys
        import repro_torch
        from repro_torch.core import DataFrame, EvalMode, Session, get_dummies
        s = Session(mode=EvalMode.EAGER, default_row_parts=2, device="cpu")
        df = DataFrame({"k": ["a", "b", "a"], "v": [1, 2, 3]}, session=s)
        g = df.groupby("k").agg({"v": "sum"}).collect()
        assert g.col("v").to_pylist() == [4.0, 2.0], g.to_pydict()
        assert get_dummies(df, ["k"]).T.collect().shape == (3, 3)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        assert "triton" not in sys.modules
        from repro_torch.kernels import _build
        assert _build._LIB is None          # the CPU path built nothing
        print("ok")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


_IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(SRC)))
def test_source_imports_neither_jax_nor_repro(path):
    mods = _IMPORT.findall(path.read_text())
    assert not [m for m in mods if re.match(r"jax\b", m)], mods
    assert not [m for m in mods if re.match(r"repro\b(?!_torch)", m)], mods


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable here")
    res = _run("""
        from repro_torch.core import DataFrame, Frame, Session
        from repro_torch.data import taxi_like_frame, numeric_matrix_frame
        calls = [lambda: Session(), lambda: DataFrame({"a": [1, 2]}),
                 lambda: Frame.from_pydict({"a": [1]}), lambda: taxi_like_frame(10),
                 lambda: numeric_matrix_frame(4, 2)]
        for call in calls:
            try:
                call()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("ran without a GPU and without device='cpu'")
        print("ok")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_cuda_tensor_without_a_built_kernel_raises_not_falls_back(monkeypatch):
    from repro_torch.kernels import _build, segment_reduce as sr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel builds there")
    # a tensor that claims CUDA is refused by torch itself here; the wrapper's
    # own guard is the build: without nvcc it raises instead of running the
    # plain version
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert sr.counter.launches == 0
