"""Test settings of the benchmark's own CPU tests (``perfbench/test_*.py``):
the ``card`` marker, and cells cut to a size the CPU runs in seconds."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Limits for the cut cells, set from their CPU readings on seeds 1-12: the
# program's largest sound reading, and the control's smallest (the model at
# its reduced width: logit_err 0.0094 against 0.066; top_gap 0.0020, which
# the control does not separate).
TINY_LIMITS = {"logit_err": 0.03, "top_gap": 0.03}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided in the test)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cells() -> list[str]:
    from perfbench import harness
    return sorted(w["name"] for w in harness.benchmark()["workloads"])


def tiny_cell(name: str):
    """The cell ``name`` at a size the CPU runs in seconds: the model at the
    program's reduced ("smoke") width, short prompts."""
    from perfbench import harness
    c = harness.cell(harness.benchmark(), name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg.update(program_variant="smoke", hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
               vocab_size=256)
    cfg["program_departures"]["embedding_multiplier"] = 8.0    # sqrt(64)
    tr["seq_lens"] = [16, 32, 48, 64]
    return harness.Cell(c.name, c.chips, cfg, tr, dict(TINY_LIMITS))


@pytest.fixture
def tiny():
    return tiny_cell
