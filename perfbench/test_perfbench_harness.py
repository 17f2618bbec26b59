"""Whole runs of each cell's traffic on the CPU at a cut size, the result
line's shape, and the command's refusals."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import generate, harness
from perfbench.conftest import cells

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**33 + 12345    # wider than 32 bits, as a checker's seeds may be


def check_line(out: dict, e2e: list):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    for name, m in out["metrics"].items():
        assert m["value"] > 0, name
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("name", cells())
def test_whole_run(name, tiny):
    bench = harness.benchmark()
    out = harness.run_cell(name, SEED, 0.3, False, require_card=False, bench=bench,
                           the_cell=tiny(name))
    check_line(out, harness.metrics_for(bench, name, False))


def test_same_seed_same_work(tiny):
    tr = tiny("yi-6b.prefill-long").traffic
    n = 4 * len(tr["seq_lens"])

    def lens(seed):
        return list(zip(range(n), generate.sequence_lengths(tr, seed)))
    assert lens(SEED) == lens(SEED)
    other = [s for _, s in lens(SEED + 1)]
    assert other != [s for _, s in lens(SEED)]
    for b in range(0, n, len(tr["seq_lens"])):     # each block: every length once
        assert sorted(other[b:b + len(tr["seq_lens"])]) == sorted(tr["seq_lens"])


def run_cli(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    r = run_cli(ROOT, "--workload", "yi-6b.prefill-long", "--seed", str(SEED), "--seconds", "1")
    assert r.returncode == 2 and r.stdout == ""


def test_benchmark_files_alone_are_refused(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = run_cli(tmp_path, "--workload", "yi-6b.prefill-long", "--seed", "1", "--seconds", "1")
    assert r.returncode == 1 and r.stdout == "" and "src/repro_torch" in r.stderr


def test_judge_needs_every_limit():
    assert harness.judge({"a": 1.0}, {"a": 1.0})[0]
    assert not harness.judge({"a": 1.0}, {"a": 0.5})[0]
    assert not harness.judge({"a": 1.0}, {})[0]
    assert not harness.judge({"a": 1.0}, None)[0]
    assert not harness.judge({}, {})[0]


def test_seeds_and_quantiles():
    assert harness.seed_ints(2**40, 3) != harness.seed_ints(2**40 + 1, 3)
    assert all(0 <= s < 2**63 for s in harness.seed_ints(-5, 4))
    assert harness.quantile([1, 2, 3, 4, 5], 0.9) == pytest.approx(4.6)
