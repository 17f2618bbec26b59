"""``correct`` comes out false for the control and for a broken timed path:
whole runs on the CPU at a cut size, the look for a card skipped, with the
fault planted in the program underneath.

The control is the reference computed in the precision below the
configuration's (fp8 for the model's bf16), read on the same inputs; each
fault is one the cell can have: an answer altered where it is produced (a
prefill's logits), half the batch left out.  A prefill keeps no state from
one batch to the next, and no cell spans cards, so none can leave a state
unchanged or lose an exchange between cards."""
import pytest
import torch

from perfbench import harness
from perfbench.conftest import cells

SEED = 2**35 + 99


def run(name, tiny, control=False):
    return harness.run_cell(name, SEED, 0.3, False, require_card=False,
                            the_cell=tiny(name), control=control)


@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(name, tiny):
    out = run(name, tiny, control=True)
    assert out["correct"]
    limits = tiny(name).limits
    assert not harness.judge(out["control"], limits)[0], out["control"]


def test_prefill_half_the_batch(tiny, monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.prefill

    def half(params, tokens, cfg, memory=None):
        got = orig(params, tokens[: tokens.shape[0] // 2], cfg, memory)
        return torch.cat([got, got])
    monkeypatch.setattr(transformer, "prefill", half)
    assert not run("yi-6b.prefill-long", tiny)["correct"]


def test_prefill_answer_altered(tiny, monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.prefill

    def altered(params, tokens, cfg, memory=None):
        out = orig(params, tokens, cfg, memory).clone()
        out[-1, 5] += 1.0
        return out
    monkeypatch.setattr(transformer, "prefill", altered)
    assert not run("yi-6b.prefill-long", tiny)["correct"]
