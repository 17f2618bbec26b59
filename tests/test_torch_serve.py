"""Serving engine of the PyTorch port: the reference's engine cases
(tests/test_serve.py) run on the port, the port's engine against the
reference's on the same converted parameters, and the two reference
behaviours the port documents (ROADMAP, known divergences).

Smoke yi-6b (2 layers, d 64) and recurrentgemma-9b (5 layers) on the CPU.  Token streams of two bf16
implementations may part at a near-tie, so the engine comparison holds
each request's tokens equal up to the first one whose reference top-1 −
top-2 logit margin is below twice the model-level tolerance
(``test_torch_models.LOGIT_TOL``), and compares nothing of that request
after it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import build_model as r_build
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

LOGIT_TOL = 0.02          # as tests/test_torch_models.py
MARGIN = 2 * LOGIT_TOL
# a 15-token request next to two short ones, at max_seq 8: every slot's
# length passes max_seq (idle slots step too)
PROMPTS = [[1] + list(range(5, 19)), [1, 9], [1, 4, 4]]
MAX_SEQ, MAX_NEW = 8, 8


@pytest.fixture(scope="module")
def served():
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _both(arch):
    """The reference's smoke model and the port holding its parameters."""
    rm = r_build(r_smoke(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch), "cpu")
    tp = tm.load(params_from_arrays(jax.tree.map(np.asarray, rp), tm.cfg, "cpu"))
    return rm, rp, tm, tp


@pytest.fixture(scope="module")
def both():
    return _both("yi-6b")


@pytest.fixture(scope="module")
def both_recurrent():
    """Smoke recurrentgemma-9b: (rglru, rglru, local) x 1 + two rglru, a
    local window of 8."""
    return _both("recurrentgemma-9b")


# ---- the reference's engine cases, on the port -------------------------------
def test_engine_drains_more_requests_than_slots(served):
    cfg, model, params = served
    eng = ServeEngine(model, params, max_batch=2, max_seq=64)
    for r in range(5):
        eng.submit(Request(rid=r, prompt_ids=[1, 4 + r, 7], max_new_tokens=4))
    eng.run_until_done()
    assert eng.metrics["tokens_out"] <= 5 * 4
    assert eng.metrics["tokens_out"] > 0
    assert all(s is None for s in eng.slots)


def test_greedy_decode_deterministic(served):
    cfg, model, params = served

    def run_once():
        eng = ServeEngine(model, params, max_batch=2, max_seq=64)
        req = Request(rid=0, prompt_ids=[1, 9, 12, 5], max_new_tokens=6)
        eng.submit(req)
        eng.run_until_done()
        return req.out_ids

    assert run_once() == run_once()


def test_batching_does_not_change_output(served):
    """A request decoded alone == the same request decoded alongside others
    (slot isolation: lengths/caches must not leak across slots)."""
    cfg, model, params = served
    prompt = [1, 9, 12, 5]

    eng1 = ServeEngine(model, params, max_batch=4, max_seq=64)
    r_alone = Request(rid=0, prompt_ids=prompt, max_new_tokens=5)
    eng1.submit(r_alone)
    eng1.run_until_done()

    eng2 = ServeEngine(model, params, max_batch=4, max_seq=64)
    r_mixed = Request(rid=0, prompt_ids=prompt, max_new_tokens=5)
    eng2.submit(Request(rid=1, prompt_ids=[2, 3], max_new_tokens=5))
    eng2.submit(r_mixed)
    eng2.submit(Request(rid=2, prompt_ids=[8, 8, 8], max_new_tokens=5))
    eng2.run_until_done()

    assert r_alone.out_ids == r_mixed.out_ids


# ---- against the reference ---------------------------------------------------
def _serve_port(tm, tp, max_batch):
    eng = ServeEngine(tm, tp, max_batch=max_batch, max_seq=MAX_SEQ)
    reqs = [Request(rid=i, prompt_ids=p, max_new_tokens=MAX_NEW) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.out_ids for r in reqs], eng.cache["length"].tolist()


def _serve_ref(rm, rp, max_batch):
    """The reference engine's tokens, final lengths, and the top-1 − top-2
    logit margin behind each output token (read off its decode function)."""
    eng = REngine(rm, rp, max_batch=max_batch, max_seq=MAX_SEQ)
    reqs = [RRequest(rid=i, prompt_ids=p, max_new_tokens=MAX_NEW) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    seen = {}
    decode = eng._decode

    def recording(*args):
        out = decode(*args)
        seen["logits"], seen["slots"] = np.asarray(out[0]), list(eng.slots)
        return out

    eng._decode = recording
    margins = {r.rid: [] for r in reqs}
    while True:
        before = [len(r.out_ids) for r in reqs]
        if eng.step() == 0 and not eng._pending:
            break
        for r, n in zip(reqs, before):
            if len(r.out_ids) > n:
                slot = next(i for i, s in enumerate(seen["slots"]) if s is r)
                top = np.sort(seen["logits"][slot])[::-1]
                margins[r.rid].append(float(top[0] - top[1]))
    return [r.out_ids for r in reqs], np.asarray(eng.cache["length"]).tolist(), margins


@pytest.mark.parametrize("max_batch", [3, 4])
def test_engine_matches_reference(both, max_batch):
    """Same requests, same parameters: equal tokens up to each request's
    first near-tie, and the same lengths — past max_seq on both sides."""
    rm, rp, tm, tp = both
    ref_out, ref_len, margins = _serve_ref(rm, rp, max_batch)
    out, lengths = _serve_port(tm, tp, max_batch)
    compared = 0
    for rid, (a, b) in enumerate(zip(out, ref_out)):
        m = margins[rid]
        upto = next((j for j, x in enumerate(m) if x < MARGIN), len(m))
        assert a[:upto] == b[:upto], (rid, a, b, m)
        assert len(a) == len(b) == MAX_NEW
        compared += upto
    assert compared >= 5, margins
    assert lengths == ref_len
    assert min(lengths) > MAX_SEQ


@pytest.mark.parametrize("max_batch", [2, 3])
def test_recurrent_engine_matches_reference(both_recurrent, max_batch):
    """Smoke recurrentgemma-9b through both engines: RG-LRU states and the
    local layers' ring buffers (lengths pass the window of 8) carried across
    steps; at max_batch 2 the third request reuses a slot.  The reference's
    _reset_slot bug needs max_batch == its 1 scanned repeat, so it does not
    trigger here.  Equal tokens up to each request's first near-tie, and
    the same lengths."""
    rm, rp, tm, tp = both_recurrent
    assert rm.cfg.repeats_and_tail() == (1, 2)
    ref_out, ref_len, margins = _serve_ref(rm, rp, max_batch)
    out, lengths = _serve_port(tm, tp, max_batch)
    compared = 0
    for rid, (a, b) in enumerate(zip(out, ref_out)):
        m = margins[rid]
        upto = next((j for j, x in enumerate(m) if x < MARGIN), len(m))
        assert a[:upto] == b[:upto], (rid, a, b, m)
        if upto == len(m):          # no near-tie: the same stream, EOS included
            assert a == b
        compared += upto
    assert compared >= 5, margins
    assert lengths == ref_len


def test_reused_slot_starts_from_zero_state(both_recurrent):
    """A request admitted to a slot another request used first gets zero
    state in every layer (RG-LRU h and conv_buf, the ring buffers' K/V)
    and the tokens it gets alone in a fresh engine."""
    _, _, tm, tp = both_recurrent
    prompt = [1, 9, 12, 5]
    alone = ServeEngine(tm, tp, max_batch=1, max_seq=MAX_SEQ)
    first = Request(rid=0, prompt_ids=prompt, max_new_tokens=6)
    alone.submit(first)
    alone.run_until_done()

    eng = ServeEngine(tm, tp, max_batch=1, max_seq=MAX_SEQ)
    reset = eng._reset_slot
    states = []

    def recording(i):
        dirty = all(bool(t[i].any()) for c in eng.cache["layers"] for t in c.values())
        reset(i)
        states.append((dirty, [t[i].clone() for c in eng.cache["layers"] for t in c.values()]))

    eng._reset_slot = recording
    second = Request(rid=1, prompt_ids=prompt, max_new_tokens=6)
    eng.submit(Request(rid=0, prompt_ids=PROMPTS[0], max_new_tokens=6))
    eng.submit(second)
    eng.run_until_done()
    assert [dirty for dirty, _ in states] == [False, True]
    assert all(not t.any() for t in states[1][1])
    assert second.out_ids == first.out_ids


# ---- the reference's divergences, documented -----------------------------------
def test_lengths_past_max_seq_are_kept(both):
    """Idle slots step too, so lengths pass max_seq; the reference lets
    them (its one-hot write then writes nothing, its mask unmasks all
    slots).  The port keeps that: same final lengths, no fault."""
    rm, rp, tm, tp = both
    _, ref_len, _ = _serve_ref(rm, rp, 3)
    _, lengths = _serve_port(tm, tp, 3)
    assert lengths == ref_len
    assert all(n > MAX_SEQ for n in lengths)


def test_reset_slot_isolation_at_max_batch_equal_repeats(both):
    """At max_batch == the smoke config's 2 scanned repeats, the reference's
    _reset_slot matches the (repeats, B, ...) cache lanes by shape and zeroes
    layer i of every slot, so the long request's tokens change with
    max_batch; the port zeroes slot i in every layer, and they do not."""
    rm, rp, tm, tp = both
    assert rm.cfg.repeats_and_tail() == (2, 0)
    port = {mb: _serve_port(tm, tp, mb)[0][0] for mb in (2, 3)}
    assert port[2] == port[3]
    ref = {mb: _serve_ref(rm, rp, mb)[0][0] for mb in (2, 3)}
    assert ref[2] != ref[3]


# ---- entry points --------------------------------------------------------------
def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--max-batch", "2"])
    assert out["tokens_out"] == 12 and out["device"] == "cpu"
    assert '"tokens_out": 12' in capsys.readouterr().out


def test_launch_serve_recurrent_smoke_on_cpu(capsys):
    """recurrentgemma-9b through the launcher: RG-LRU and local layers."""
    from repro_torch.launch.serve import main
    out = main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--max-batch", "2"])
    assert 0 < out["tokens_out"] <= 12 and out["device"] == "cpu"
    assert '"tokens_out"' in capsys.readouterr().out


def test_serving_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable here")
    with pytest.raises(RuntimeError, match="no CUDA"):
        build_model(get_smoke_config("yi-6b"))
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="CUDA card"):
        main(["--arch", "yi-6b", "--device", "cpu"])


def test_serving_path_imports_neither_jax_nor_repro():
    """The serving slice, run end to end in a fresh process, loads no jax,
    no repro and no ml_dtypes (tests/conftest.py imports repro here)."""
    import os
    import pathlib
    import subprocess
    import sys
    import textwrap
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch.serve import main
        main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--requests", "2",
              "--max-new", "3"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
