"""Model layer of the PyTorch port against the JAX package: layers, attention
(forward and decode) and whole smoke models, the recurrent and windowed
archs included.

Inputs come from numpy seeds; the reference runs on CPU JAX and the port on
the CPU (its kernel wrappers take their plain versions there).  Tolerances:
layers and attention in float32 at rtol = atol = 2e-3 (the reference's
decode-attention kernel tolerance); whole smoke models in bf16, the
reference's parameters converted bit-exact, logits within LOGIT_TOL = 0.02
max |Δ| — the reference's own decode-versus-forward check allows 0.75
(tests/test_arch_smoke.py).  Only smoke configs are built; full configs are
checked through ``cfg.param_count()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.models import attention as rattn
from repro.models import build_model as r_build
from repro.models import layers as rlayers
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, layers as tlayers, transformer
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import linear_scan as ls_mod

TOL = dict(rtol=2e-3, atol=2e-3)
LOGIT_TOL = 0.02


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---- layers -------------------------------------------------------------------
def test_rmsnorm_matches_reference(rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = tlayers.rmsnorm({"scale": _t(scale)}, _t(x)).numpy()
    exp = np.asarray(rlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, exp, **TOL)


def test_rope_matches_reference(rng):
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(tlayers.rope(_t(x), _t(pos)).numpy(),
                               np.asarray(rlayers.rope(jnp.asarray(x), jnp.asarray(pos))), **TOL)


def test_layernorm_matches_reference(rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    got = tlayers.layernorm({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    exp = np.asarray(rlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    np.testing.assert_allclose(got, exp, **TOL)


def test_gelu_mlp_matches_reference(rng):
    p = {k: rng.standard_normal(s).astype(np.float32) / 8
         for k, s in (("w_up", (64, 128)), ("b_up", (128,)), ("w_down", (128, 64)),
                      ("b_down", (64,)))}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    got = tlayers.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    exp = np.asarray(rlayers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    np.testing.assert_allclose(got, exp, **TOL)


def test_swiglu_matches_reference(rng):
    p = {k: rng.standard_normal(s).astype(np.float32) / 8
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    got = tlayers.swiglu({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    exp = np.asarray(rlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    np.testing.assert_allclose(got, exp, **TOL)


# ---- attention ------------------------------------------------------------------
def _attn_inputs(rng, b=3, d=64, h=4, kvh=2, hd=16, s=24, bias=True):
    p = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd), "wo": (h * hd, d)}
    p = {k: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32) for k, sh in p.items()}
    if bias:
        for k, w in (("bq", h), ("bk", kvh), ("bv", kvh)):
            p[k] = (0.1 * rng.standard_normal(w * hd)).astype(np.float32)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    ck = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    return p, x, ck, cv, dict(n_heads=h, n_kv=kvh, head_dim=hd)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
@pytest.mark.parametrize("port_impl", ["xla", "pallas"])
def test_decode_self_attention_matches_reference(rng, use_pallas_kernels, ref_impl, port_impl):
    """One decode step of one attention layer, f32: the port's einsum and
    kernel routes against the reference's einsum path and its Pallas kernel
    (interpret mode).  Lengths 0, 9 and S - 1 write inside the cache; the new
    caches are equal."""
    p, x, ck, cv, dims = _attn_inputs(rng)
    s = ck.shape[1]
    length = np.array([0, 9, s - 1], np.int32)
    rout, rcache = rattn.decode_self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(length), impl=ref_impl, **dims)
    cache = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    tout, tcache = tattn.decode_self_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), cache, _t(length), impl=port_impl, **dims)
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(rcache[name]), **TOL)


def test_cache_write_past_the_end_is_a_noop(rng):
    """A slot whose length has passed S (idle engine slots do) writes
    nothing, on both sides, and attends over all S slots."""
    p, x, ck, cv, dims = _attn_inputs(rng, bias=False)
    s = ck.shape[1]
    length = np.array([s, s + 3, 2], np.int32)
    rout, rcache = rattn.decode_self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(length), **dims)
    cache = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    tout, _ = tattn.decode_self_attention({k: _t(v) for k, v in p.items()}, _t(x), cache,
                                          _t(length), impl="pallas", **dims)
    for name, before in (("k", ck), ("v", cv)):
        np.testing.assert_array_equal(cache[name][:2].numpy(), before[:2])
        np.testing.assert_array_equal(np.asarray(rcache[name])[:2], before[:2])
        assert not np.array_equal(cache[name][2].numpy(), before[2])
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), **TOL)


def test_cache_init_matches_reference():
    r = rattn.cache_init(3, 10, 2, 16)
    t = tattn.cache_init(3, 10, 2, 16, "cpu")
    for name in ("k", "v"):
        assert tuple(t[name].shape) == r[name].shape and t[name].dtype == torch.bfloat16
        assert not t[name].any()


def test_chunked_attention_matches_reference(rng):
    """The query-chunked forward path at a small chunk, causal with GQA."""
    q = rng.standard_normal((2, 10, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    rk, rv = rattn._repeat_kv(jnp.asarray(k), 2), rattn._repeat_kv(jnp.asarray(v), 2)
    exp = np.asarray(rattn._chunked_attention(jnp.asarray(q), rk, rv, causal=True,
                                              window=None, chunk=4))
    tk, tv = tattn._repeat_kv(_t(k), 2), tattn._repeat_kv(_t(v), 2)
    got = tattn._chunked_attention(_t(q), tk, tv, causal=True, window=None, chunk=4).numpy()
    np.testing.assert_allclose(got, exp, **TOL)
    full = tattn.multihead_attention(_t(q), _t(k), _t(v), causal=True, impl="xla").numpy()
    np.testing.assert_allclose(got, full, **TOL)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_pallas_forward_attention_matches_reference(rng, use_pallas_kernels, ref_impl, window):
    """The forward's "pallas" path, K6's plain version on the un-repeated KV
    heads, against the reference's einsum path and its Pallas flash kernel
    (interpret mode, KV repeated to every head), causal with GQA, f32."""
    q = rng.standard_normal((2, 10, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    exp = np.asarray(rattn.multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=True, window=window, impl=ref_impl))
    got = tattn.multihead_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                                    impl="pallas").numpy()
    np.testing.assert_allclose(got, exp, **TOL)


# ---- whole smoke models -----------------------------------------------------------
SMOKE = {"yi-6b": {}, "qwen1.5-4b": {},
         # the other MLP and norm of this slice, on yi-6b's widths
         "yi-6b-gelu-layernorm": dict(mlp="gelu", norm="layernorm"),
         # rglru, rglru, local (window 8) x 1 + a tail of 2; local x 5 + attn
         "recurrentgemma-9b": {}, "gemma3-12b": {}}


@pytest.fixture(scope="module")
def smoke_models():
    """The reference's smoke yi-6b, qwen1.5-4b (QKV bias), yi-6b with a
    GELU MLP and LayerNorm, recurrentgemma-9b and gemma3-12b, with bf16
    parameters, and the port's models holding the same parameters."""
    out = {}
    for arch, change in SMOKE.items():
        base = arch.split("-gelu")[0]
        rm = r_build(dataclasses.replace(r_smoke(base), **change))
        rp = rm.init(jax.random.PRNGKey(0))
        tm = build_model(dataclasses.replace(get_smoke_config(base), **change), "cpu")
        tp = tm.load(params_from_arrays(_np_tree(rp), tm.cfg, "cpu"))
        out[arch] = (rm, rp, tm, tp)
    return out


@pytest.mark.parametrize("arch", list(SMOKE))
def test_decode_and_forward_match_reference(smoke_models, arch):
    """decode_step teacher-forced over 12 steps and forward on the same
    tokens, both packages, bf16: logits within LOGIT_TOL.  12 steps pass the
    smoke window of 8, so the local layers' ring buffers wrap."""
    rm, rp, tm, tp = smoke_models[arch]
    b, s = 2, 12
    toks = np.random.default_rng(3).integers(0, rm.cfg.vocab, (b, s)).astype(np.int32)
    rfull = np.asarray(rm.forward(rp, jnp.asarray(toks)))
    rcache, rdec = rm.cache_init(b, s + 4), []
    step = jax.jit(rm.decode_step)
    for i in range(s):
        logits, rcache = step(rp, jnp.asarray(toks[:, i]), rcache)
        rdec.append(np.asarray(logits))
    with torch.inference_mode():
        tfull = tm.forward(tp, _t(toks)).numpy()
        tcache, tdec = tm.cache_init(b, s + 4), []
        for i in range(s):
            logits, tcache = tm.decode_step(tp, _t(toks[:, i]), tcache)
            tdec.append(logits.numpy())
    rdec, tdec = np.stack(rdec, 1), np.stack(tdec, 1)
    # shown with pytest -s; PERF.md records these
    print(f"{arch}: max |logit diff| port vs reference: decode "
          f"{np.abs(tdec - rdec).max():.6g}, forward {np.abs(tfull - rfull).max():.6g}")
    assert tdec.dtype == np.float32 and tdec.shape == (b, s, rm.cfg.vocab)
    assert np.abs(tdec - rdec).max() < LOGIT_TOL, np.abs(tdec - rdec).max()
    assert np.abs(tfull - rfull).max() < LOGIT_TOL, np.abs(tfull - rfull).max()
    assert np.abs(tdec - tfull).max() < LOGIT_TOL
    assert tcache["length"].tolist() == [s] * b


@pytest.mark.parametrize("ref_kernels", [False, True])
@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-9b", "gemma3-12b"])
def test_forward_matches_reference_kernel_paths(smoke_models, monkeypatch, arch, ref_kernels):
    """The port's forward with attn_impl "pallas" and "auto" (K6 and K5's
    plain versions here) against the reference's forward with "pallas" on
    its plain ``ref`` functions and on its Pallas kernels in interpret mode
    (REPRO_USE_KERNELS=1), S = 12 past the smoke window of 8: logits
    within LOGIT_TOL."""
    if ref_kernels:
        monkeypatch.setenv("REPRO_USE_KERNELS", "1")
    rm, rp, tm, tp = smoke_models[arch]
    toks = np.random.default_rng(5).integers(0, rm.cfg.vocab, (2, 12)).astype(np.int32)
    rcfg = dataclasses.replace(rm.cfg, attn_impl="pallas")
    exp = np.asarray(r_build(rcfg).forward(rp, jnp.asarray(toks)))
    for impl in ("pallas", "auto"):
        with torch.inference_mode():
            got = transformer.forward(tp, _t(toks), dataclasses.replace(tm.cfg, attn_impl=impl))[0]
        assert np.abs(got.numpy() - exp).max() < LOGIT_TOL, (impl, np.abs(got.numpy() - exp).max())


def test_decode_routes_through_the_kernel_wrapper(smoke_models, monkeypatch):
    """attn_impl "auto" sends every layer's decode attention through
    kernels.ops.decode_attention; "xla" keeps the einsum path; the two agree."""
    _, _, tm, tp = smoke_models["yi-6b"]
    calls = []
    real = da_mod.decode_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr("repro_torch.kernels.ops._decode", counting)
    tok = torch.tensor([1, 5], dtype=torch.int32)
    outs = {}
    for impl in ("auto", "xla"):
        cfg = dataclasses.replace(tm.cfg, attn_impl=impl)
        calls.clear()
        with torch.inference_mode():
            cache = transformer.cache_init(cfg, 2, 8, "cpu")
            for _ in range(3):
                outs[impl], cache = transformer.decode_step(tp, tok, cache, cfg)
        assert len(calls) == (3 * cfg.n_layers if impl == "auto" else 0)
    torch.testing.assert_close(outs["auto"], outs["xla"], rtol=0, atol=LOGIT_TOL)


def test_params_convert_bit_exact(smoke_models):
    rm, rp, tm, tp = smoke_models["qwen1.5-4b"]
    emb = np.asarray(rp["embed"])
    assert emb.dtype.name == "bfloat16"
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(), emb.view(np.int16))
    wq1 = np.asarray(rp["blocks"][0]["attn"]["wq"][1])
    np.testing.assert_array_equal(tp["layers"][1]["attn"]["wq"].view(torch.int16).numpy(),
                                  wq1.view(np.int16))
    assert tp["layers"][0]["ln1"]["scale"].dtype == torch.float32


def test_params_convert_bit_exact_recurrent_layout(smoke_models):
    """recurrentgemma-9b's heterogeneous stack: one scanned repeat of
    (rglru, rglru, local) plus a tail of two rglru layers, in layer order,
    every leaf bit-exact (f32 Λ included)."""
    rm, rp, tm, tp = smoke_models["recurrentgemma-9b"]
    assert rm.cfg.repeats_and_tail() == (1, 2)
    kinds = [("rglru" if "rglru" in p else "attn") for p in tp["layers"]]
    assert kinds == ["rglru", "rglru", "attn", "rglru", "rglru"]
    ref_layers = [_index(rp["blocks"][pi], 0) for pi in range(3)] + list(rp["tail"])
    for ref, port in zip(ref_layers, tp["layers"]):
        leaves = jax.tree_util.tree_leaves_with_path(ref)
        assert len(leaves) == sum(1 for _ in _walk(port))
        for path, leaf in leaves:
            t = port
            for key in path:
                t = t[key.key]
            a = np.asarray(leaf)
            assert tuple(t.shape) == a.shape and str(t.dtype).endswith(str(a.dtype))
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)


def _index(tree, r):
    return jax.tree.map(lambda x: x[r], tree)


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v


@pytest.mark.parametrize("arch,k5,k6", [("recurrentgemma-9b", 4, 1), ("gemma3-12b", 0, 6),
                                        ("yi-6b", 0, 2)])
def test_forward_routes_through_the_kernel_wrappers(smoke_models, monkeypatch, arch, k5, k6):
    """attn_impl "auto" and "pallas" send every forward attention through
    kernels.ops.flash_attention (local layers with their window) and every
    RG-LRU recurrence through kernels.ops.linear_scan, one call a layer;
    "xla" and "chunked" keep attention on the einsum paths.  The four agree,
    and prefill is forward's last position."""
    _, _, tm, tp = smoke_models[arch]
    calls = {"flash": [], "scan": []}

    def counting(name, real):
        def fn(*a, **k):
            calls[name].append(k.get("window"))
            return real(*a, **k)
        return fn

    monkeypatch.setattr("repro_torch.kernels.ops._flash", counting("flash", fa_mod.flash_attention))
    monkeypatch.setattr("repro_torch.kernels.ops._linscan", counting("scan", ls_mod.linear_scan))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 13)).astype(np.int32))
    outs = {}
    for impl in ("auto", "pallas", "xla", "chunked"):
        cfg = dataclasses.replace(tm.cfg, attn_impl=impl)
        for v in calls.values():
            v.clear()
        with torch.inference_mode():
            outs[impl], _ = transformer.forward(tp, toks, cfg)
            assert len(calls["scan"]) == k5
            kernel = impl in ("auto", "pallas")
            assert len(calls["flash"]) == (k6 if kernel else 0)
            if kernel and arch != "yi-6b":
                assert calls["flash"].count(tm.cfg.window) == (k6 if k5 else k6 - 1)
            last = transformer.prefill(tp, toks, cfg)
        torch.testing.assert_close(last, outs[impl][:, -1], rtol=0, atol=1e-5)
    for impl in ("pallas", "xla", "chunked"):
        torch.testing.assert_close(outs[impl], outs["auto"], rtol=0, atol=LOGIT_TOL)


def test_model_holds_params_under_reference_names(smoke_models):
    _, rp, tm, _ = smoke_models["yi-6b"]
    names = dict(tm.named_parameters())
    for key in ("params.embed", "params.unembed", "params.final_norm.scale",
                "params.layers.0.attn.wq", "params.layers.1.mlp.w_gate",
                "params.layers.1.ln1.scale", "params.layers.0.ln2.scale"):
        assert key in names, key
    n = sum(p.numel() for p in tm.parameters())
    assert n == tm.param_count()[0] == sum(np.asarray(a).size for a in jax.tree.leaves(rp))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma3-12b"])
def test_port_init_builds_the_reference_tree(smoke_models, arch):
    """The port's own init gives the converted reference tree's keys,
    shapes and dtypes, layer by layer (rglru: Λ float32, the rest bf16)."""
    _, rp, tm, tp = smoke_models[arch]
    own = build_model(tm.cfg, "cpu").init(torch.Generator().manual_seed(0))

    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [sig(v) for v in tree]
        return tuple(tree.shape), tree.dtype

    assert sig(own) == sig(tp)
    n = sum(np.asarray(a).size for a in jax.tree.leaves(rp))
    assert sum(p.numel() for p in tm.parameters()) == n


def test_port_init_follows_reference_distributions():
    cfg = get_smoke_config("yi-6b")
    m = build_model(cfg, "cpu")
    p = m.init(torch.Generator().manual_seed(0))
    wq = p["layers"][0]["attn"]["wq"].float()
    assert p["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert abs(wq.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.02
    assert abs(p["embed"].float().std().item() - 0.02) < 0.002
    assert torch.equal(p["layers"][1]["ln2"]["scale"], torch.ones(cfg.d_model))
    again = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(p["embed"], again["embed"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_configs_copy_the_reference(arch):
    """The configs are a copy; the full yi-6b is 6.06e9 parameters (about
    12.1 GB in bf16), counted without allocating."""
    for port, ref in ((get_config(arch), r_get_config(arch)),
                      (get_smoke_config(arch), r_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    if arch == "yi-6b":
        total, _ = get_config(arch).param_count()
        assert round(total / 1e9, 2) == 6.06


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "granite-moe-3b-a800m", "whisper-base"])
def test_unported_configs_raise(arch):
    """Until the rest of the model zoo was ported (ROADMAP M10e) building
    these configs raised NotImplementedError naming it.  Now they build, and
    the port's own init gives the reference's tree (keys, shapes, dtypes:
    RWKV's float32 mixes, the experts' float32 router, the encoder).  The
    refusal they still carry is training with attn_impl="pallas": K6 has no
    backward, so loss_fn raises naming it, for every config alike."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    own = model.init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(r_build(r_smoke(arch)).init, jax.random.PRNGKey(0))
    want = params_from_arrays(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                              cfg, "cpu")

    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [sig(v) for v in tree]
        return tuple(tree.shape), tree.dtype

    assert sig(own) == sig(want)
    pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.cross_memory_len:
        batch["memory"] = torch.zeros((1, cfg.cross_memory_len, cfg.d_model),
                                      dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="K6"):
        pallas.loss_fn(own, batch)


def test_loss_fn_raises_naming_training(smoke_models):
    """loss_fn, which raised until training was ported, now gives the
    reference's loss on the yi-6b smoke model (bf16, same parameters and
    batch, half a row masked): within LOGIT_TOL."""
    rm, rp, tm, tp = smoke_models["yi-6b"]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, rm.cfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, rm.cfg.vocab, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.float32)
    mask[1, 6:] = 0
    want, wmet = rm.loss_fn(rp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                 "mask": jnp.asarray(mask)})
    got, met = tm.loss_fn(tp, {"tokens": _t(toks), "labels": _t(labels), "mask": _t(mask)})
    assert set(met) == set(wmet) == {"xent", "moe_aux"}
    assert abs(got.item() - float(want)) < LOGIT_TOL, (got.item(), float(want))
