"""Trinity-Mini (AFMoE, ``repro_torch/configs/trinity_mini.py``) on the port
against its plain reference, ``perfbench/reference/afmoe_lm.py`` (the file
that decides the benchmark cell's ``correct``), at the smoke size on seeded
random weights made as the benchmark makes them (``perfbench/weights_afmoe.py``).

The JAX package has no AFMoE, so the reference is the plain float32 one.
Tolerances:

- whole bf16 smoke model against the float32 reference: logits within
  ``LOGIT_TOL`` = 0.03 (the benchmark's cut cells' limit).  The program's
  largest reading over the seeds here is about 0.015; the reference
  computed from fp8 operands in the program's place reads a third of its
  routes outside the reference's admitted set at this size.  The reference
  is given the program's expert choices where its own scores nearly tie
  (``afmoe_lm.DELTA``), as the benchmark gives them;
- the dropless layer in float32 against a per-token loop over the chosen
  experts: rtol = atol = 1e-5 (the grouped products and the loop's
  products sum in other orders);
- the routing (which experts, their weights) exactly.
"""
import dataclasses

import pytest
import torch

from perfbench import weights_afmoe
from perfbench.harness import load_json, HERE
from perfbench.reference import afmoe_lm as ref
from perfbench.runners import prefill_afmoe
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import trace
from repro_torch.models import attention, build_model, layers, moe, transformer

LOGIT_TOL = 0.03
TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = [1, 2**33 + 5, 77]


def _smoke(seed: int):
    """(model, params, the configuration file's keys at the smoke size, the
    benchmark's weights) on the CPU."""
    cfg = dict(load_json(HERE / "configs" / "trinity-mini.json"), program_variant="smoke")
    cfg["program_departures"] = {"embedding_multiplier": 8.0}
    arch, cfg = prefill_afmoe.program_config(cfg)
    w = weights_afmoe.make(cfg, seed, torch.device("cpu"))
    m = build_model(arch, "cpu")
    return m, m.load(weights_afmoe.program_tree(w, cfg)), cfg, w


def _tokens(cfg, seed: int, b: int = 2, s: int = 40):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(3, cfg["vocab_size"], (b, s), generator=g, dtype=torch.int32)


def _reference(w, cfg, toks, routes, rows=None):
    """The reference's logits of each sequence of ``toks`` (B, S) at
    ``rows`` (every position by default), given the program's choices
    ``routes`` (a (B·S, k) a MoE layer), and whether it admitted them."""
    b, s = toks.shape
    rows = list(range(s)) if rows is None else rows
    out, ok = [], True
    for i in range(b):
        lg, _, admitted = ref.forward(w, cfg, toks[i], rows,
                                      routes=[r.view(b, s, -1)[i] for r in routes])
        out.append(lg)
        ok = ok and admitted
    return torch.stack(out), ok


def test_config_is_published_and_beside_the_ten():
    cfg = get_config("trinity-mini")
    assert "trinity-mini" in EXTRA_IDS and "trinity-mini" not in ARCH_IDS
    assert isinstance(cfg, ArchConfig)
    total, active = cfg.param_count()
    assert round(total / 1e9, 2) == 26.12 and round(active / 1e9, 2) == 3.47
    assert cfg.pattern == ("local", "local", "local", "attn") and cfg.window == 2048
    assert (cfg.n_dense_layers, cfg.d_ff_dense, cfg.d_ff, cfg.n_experts, cfg.top_k) == (
        2, 6144, 1024, 128, 8)
    smoke = get_smoke_config("trinity-mini")
    assert smoke.d_model == 64 and smoke.pattern == cfg.pattern and smoke.window < 64
    assert smoke.n_dense_layers >= 1 and smoke.n_experts >= 16 and smoke.top_k >= 4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_ten_run_their_defaults(arch):
    """The settings AFMoE adds are class attributes of ``ArchConfig``, at
    the values the ten configs have always run with: no leading dense
    layers, capacity dispatch, RoPE everywhere, no QK-norm, gate or
    sandwich norm, eps 1e-6; none is a field."""
    cfg = get_config(arch)
    assert (cfg.n_dense_layers, cfg.moe_dispatch, cfg.rope_global, cfg.qk_norm, cfg.attn_gate,
            cfg.sandwich_norm, cfg.norm_eps) == (0, "capacity", True, False, False, False, 1e-6)
    assert "norm_eps" not in {f.name for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("seed", SEEDS)
def test_forward_matches_reference(seed):
    m, p, cfg, w = _smoke(seed)
    toks = _tokens(cfg, seed)
    with moe.record_routes() as routes:
        got = m.forward(p, toks)
    want, admitted = _reference(w, cfg, toks, routes)
    assert admitted
    assert float((got - want).abs().max()) < LOGIT_TOL
    # the last position alone through the final norm and unembedding
    torch.testing.assert_close(m.prefill(p, toks), got[:, -1], **TOL)


def test_prefill_then_decode_matches_reference():
    """The serving path: the prompt teacher-forced through ``decode_step``
    (as ``ServeEngine`` prefills), then decoding on, the cache's ring
    buffers past their window on the sliding layers, K7's einsum stand-in
    on the full ones; every step's logits against the reference's full
    forward, given the program's choices step by step."""
    m, p, cfg, w = _smoke(5)
    toks = _tokens(cfg, 5, s=48)
    cache = m.cache_init(2, 48)
    steps, routes = [], []
    for i in range(toks.shape[1]):
        with moe.record_routes() as r:
            lg, cache = m.decode_step(p, toks[:, i], cache)
        steps.append(lg)
        routes.append(r)
    got = torch.stack(steps, 1)
    # (B, k) a step a layer → (B·S, k) a layer
    per_layer = [torch.stack([r[j] for r in routes], 1).reshape(-1, cfg["num_experts_per_tok"])
                 for j in range(len(routes[0]))]
    want, admitted = _reference(w, cfg, toks, per_layer)
    assert admitted
    assert float((got - want).abs().max()) < LOGIT_TOL


def _layer(e=16, d=24, f=12, seed=0, shared=True):
    g = torch.Generator().manual_seed(seed)
    p = moe.moe_init(g, d, f, e, torch.float32, n_shared=1 if shared else 0, expert_bias=True)
    p["expert_bias"] = torch.randn(e, generator=g) * 0.05
    return p


def _loop(p, x, top_k, scale):
    """Each token alone: its chosen experts in order, weighted."""
    xt = x.reshape(-1, x.shape[-1])
    chosen, w = moe.route(p, xt, top_k, scale)
    out = []
    for t in range(xt.shape[0]):
        y = sum(w[t, j] * layers.swiglu_ffn({k: p[k][e] for k in ("w_gate", "w_up", "w_down")},
                                            xt[t])
                for j, e in enumerate(chosen[t].tolist()))
        out.append(y + layers.swiglu_ffn(p["shared"], xt[t]))
    return torch.stack(out).reshape(x.shape)


@pytest.mark.parametrize("skew", [0.0, 50.0])
def test_dropless_matches_a_per_token_loop(skew):
    """Every route is computed, also when the bias sends every token to the
    same experts (``skew``: a capacity path would drop most routes)."""
    p = _layer()
    p["expert_bias"][:4] += skew
    x = torch.randn(3, 20, 24, generator=torch.Generator().manual_seed(1))
    got = moe.moe_dropless(p, x, top_k=4, route_scale=2.5)
    torch.testing.assert_close(got, _loop(p, x, 4, 2.5), **TOL)
    if skew:
        chosen, _ = moe.route(p, x.reshape(-1, 24), 4)
        assert (chosen.sort(-1).values == torch.arange(4)).all()


def test_expert_bias_selects_but_does_not_weigh():
    p = _layer(shared=False)
    xt = torch.randn(30, 24, generator=torch.Generator().manual_seed(2))
    scores = torch.sigmoid(xt @ p["router"])
    p["expert_bias"].zero_()
    plain, w_plain = moe.route(p, xt, 4, 2.0)
    p["expert_bias"][7] = 10.0                       # expert 7 chosen by every token
    biased, w = moe.route(p, xt, 4, 2.0)
    assert (biased == 7).any(-1).all() and not (plain == 7).any(-1).all()
    s = scores.gather(1, biased)
    assert torch.equal(w, s * (2.0 / s.sum(-1, keepdim=True)))
    torch.testing.assert_close(w_plain.sum(-1), torch.full((30,), 2.0))
    # ties go to the lower index, as the reference breaks them
    p["expert_bias"].zero_()
    p["router"].zero_()
    tied, _ = moe.route(p, xt, 4)
    assert (tied == torch.arange(4)).all()
    assert (ref.choose(torch.zeros(30, 16), 4, None)[0] == torch.arange(4)).all()


def test_full_layers_ignore_positions_and_sliding_layers_mask_the_window(monkeypatch):
    m, p, cfg, _ = _smoke(3)
    calls = []
    real = layers.rope
    monkeypatch.setattr(layers, "rope", lambda x, pos, *a: calls.append(1) or real(x, pos, *a))
    toks = _tokens(cfg, 3, b=1, s=40)
    m.forward(p, toks)
    assert len(calls) == 2 * 3                        # q and k of the three sliding layers
    arch, win = m.cfg, cfg["sliding_window"]
    x = transformer._embed(p, toks, arch)
    y = x.clone()
    y[:, 0] += 1.0

    def block(i, x):
        return transformer._block_apply(arch.pattern[i % 4], p["layers"][i], x, arch, None,
                                        "pallas", index=i)[0]
    # sliding layer 0 (dense MLP): a query at least a window past position 0 does not see it
    a, b = block(0, x), block(0, y)
    assert torch.equal(a[:, win:], b[:, win:]) and not torch.equal(a[:, :win], b[:, :win])
    # full layer 3: every later position sees position 0; with no positions, the last query's
    # attention does not change when the keys before it are permuted
    assert not torch.equal(block(3, x)[:, win:], block(3, y)[:, win:])
    perm = torch.cat([torch.randperm(39, generator=torch.Generator().manual_seed(0)),
                      torch.tensor([39])])
    h = transformer._norm_apply(arch, p["layers"][3]["ln1"], x.float())
    attn = {k: v if isinstance(v, dict) else v.float() for k, v in p["layers"][3]["attn"].items()}
    kw = dict(n_heads=arch.n_heads, n_kv=arch.n_kv, head_dim=arch.head_dim_, impl="pallas",
              use_rope=False, norm_eps=arch.norm_eps)
    last = attention.self_attention(attn, h, **kw)[:, -1]
    again = attention.self_attention(attn, h[:, perm], **kw)[:, -1]
    torch.testing.assert_close(last, again, rtol=1e-5, atol=1e-5)


def test_two_runs_are_bit_equal():
    m, p, cfg, _ = _smoke(9)
    toks = _tokens(cfg, 9)
    assert torch.equal(m.forward(p, toks), m.forward(p, toks))
    x = torch.randn(2, 33, 64, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    mlp = p["layers"][2]["mlp"]
    a = moe.moe_dropless(mlp, x, top_k=4, route_scale=2.826)
    assert torch.equal(a, moe.moe_dropless(mlp, x, top_k=4, route_scale=2.826))


def test_the_benchmark_reference_holds_a_wrong_choice_out(monkeypatch):
    """A program set that the reference's scores rule out (not a near-tie)
    fails ``logit_err``; the program's own sets pass."""
    m, p, cfg, w = _smoke(11)
    toks = _tokens(cfg, 11, b=1, s=24)
    with moe.record_routes() as routes:
        m.forward(p, toks)
    _, ok = _reference(w, cfg, toks, routes, rows=[23])
    assert ok
    seen, real = [], ref.choose
    monkeypatch.setattr(ref, "choose",
                        lambda sel, k, given: seen.append(sel) or real(sel, k, given))
    _reference(w, cfg, toks, routes, rows=[23])
    monkeypatch.setattr(ref, "choose", real)
    wrong = [r.clone() for r in routes]
    wrong[1][5] = torch.sort(seen[1][5]).indices[:cfg["num_experts_per_tok"]]   # the lowest
    _, ok = _reference(w, cfg, toks, wrong, rows=[23])
    assert not ok
    payload = {"weights": w, "config": cfg, "batches": [(toks, m.prefill(p, toks), wrong)]}
    assert ref.readings(payload, cfg, {})["logit_err"] == ref.RULED_OUT


@pytest.mark.trace
def test_moe_spans_and_their_args():
    """In the ring: a ``moe`` span a MoE layer with ``route``, ``experts``,
    ``combine`` and ``shared`` inside (the shared expert not in ``mlp``,
    which only the dense layer opens), ``attn_gate`` in every attention;
    with the tracer on, the expert rows' extremes in ``moe``'s args."""
    m, p, cfg, _ = _smoke(4)
    toks = _tokens(cfg, 4)
    tr = trace.Tracer(session_id="afmoe")
    trace.configure(tr)
    try:
        with moe.record_routes() as routes:
            m.prefill(p, toks)
    finally:
        trace.reset()
    spans = tr.snapshot()
    by_id = {s.id: s for s in spans}
    moes = sorted((s for s in spans if s.name == "moe"), key=lambda s: s.t0)
    n_moe = cfg["num_hidden_layers"] - cfg["num_dense_layers"]
    assert len(moes) == n_moe
    assert sorted(s.name for s in spans if s.parent == moes[0].id) == [
        "combine", "experts", "route", "shared"]
    assert sum(s.name == "mlp" for s in spans) == cfg["num_dense_layers"]
    assert sum(s.name == "attn_gate" for s in spans) == cfg["num_hidden_layers"]
    for s, r in zip(moes, routes):
        rows = torch.bincount(r.reshape(-1), minlength=cfg["num_experts"])
        assert s.args == {"index": s.args["index"], "tokens": 80, "routes": 80 * 4,
                          "experts": cfg["num_experts"], "rows_max": int(rows.max()),
                          "rows_min": int(rows.min()), "empty_experts": int((rows == 0).sum())}
        assert by_id[s.parent].name == "block"
    assert [s.args["index"] for s in moes] == list(range(cfg["num_dense_layers"],
                                                         cfg["num_hidden_layers"]))
