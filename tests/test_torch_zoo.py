"""The rest of the model zoo in the PyTorch port against the JAX package:
RWKV6 (rwkv6-1.6b), cross-attention image layers (llama-3.2-vision-90b)
and the whisper encoder-decoder (whisper-base), at their smoke configs,
and the parts they are made of — ``cross_attention``, ``encode``, the
sinusoidal positions, remat's "dots" policy, the parameters' conversion —
plus the serving engine's memory feed.  The MoE configs are in
``tests/test_torch_moe.py``.

``tests/test_arch_smoke.py``'s cases run through both packages: a forward
and a train step (loss and gradients), a decode step, and decode against
the teacher-forced forward.  The reference's parameters are converted
bit-exact (``convert.params_from_arrays``); both sides run on the CPU.
Tolerances: logits and losses of the bf16 models within ``LOGIT_TOL`` =
0.02 max |Δ| (``tests/test_torch_models.py``); gradients within
``GRAD_REL`` = 0.06 relative norm (``tests/test_torch_train.py``); float32
layers at rtol = atol = 2e-3; the bf16 encoder output within two bf16 ulps
of its magnitude (both round the same float32 values, in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import attention as rattn
from repro.models import build_model as r_build
from repro.models import transformer as rtr
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, transformer
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.tree import leaves, leaves_with_paths, path_name

LOGIT_TOL = 0.02
GRAD_REL = 0.06
TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["rwkv6-1.6b", "llama-3.2-vision-90b", "whisper-base"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The reference's smoke model and bf16 parameters (PRNGKey 0), and the
    port's model holding them, per arch."""
    out = {}
    for arch in ARCHS:
        rm = r_build(r_smoke(arch))
        rp = rm.init(jax.random.PRNGKey(0))
        tm = build_model(get_smoke_config(arch), "cpu")
        out[arch] = (rm, rp, tm, tm.load(params_from_arrays(_np(rp), tm.cfg, "cpu")))
    return out


def _memory(cfg, b: int, seed: int):
    """(reference, port) bf16 memory (B, M, d), or (None, None)."""
    if not cfg.cross_memory_len:
        return None, None
    m = np.random.default_rng(seed).standard_normal((b, cfg.cross_memory_len, cfg.d_model))
    ref = jnp.asarray(m, jnp.float32).astype(jnp.bfloat16)
    return ref, torch.from_numpy(np.asarray(ref, np.float32)).bfloat16()


def _batch(cfg, b=4, s=16, seed=0):
    """tests/test_torch_train.py's batch (random labels, half a row
    masked), with a memory for the cross configs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[-1, s // 2:] = 0
    ref = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}
    port = {"tokens": _t(toks), "labels": _t(labels), "mask": _t(mask)}
    ref["memory"], port["memory"] = _memory(cfg, b, seed + 1)
    if ref["memory"] is None:
        del ref["memory"], port["memory"]
    return ref, port


def _encoded(rm, rp, tm, tp, rmem, tmem):
    """The memory decode attends to: encoded first for whisper, on each
    side."""
    if not rm.cfg.encoder_layers:
        return rmem, tmem
    with torch.inference_mode():
        return (rtr.encode(rp["encoder"], rmem, rm.cfg),
                transformer.encode(tp["encoder"], tmem, tm.cfg))


# ---- test_arch_smoke's cases through both packages ---------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step_match_reference(models, arch):
    """forward logits, loss_fn and every parameter's gradient (the
    reference's through jax.value_and_grad, mapped into the port's layout;
    whisper's encoder included), and the gradients are not all zero."""
    rm, rp, tm, tp = models[arch]
    rb, tb = _batch(rm.cfg)
    rfull = np.asarray(jax.jit(rm.forward)(rp, rb["tokens"], rb.get("memory")))
    with torch.inference_mode():
        tfull = tm.forward(tp, tb["tokens"], tb.get("memory")).numpy()
    assert tfull.shape == rfull.shape and np.isfinite(tfull).all()
    assert np.abs(tfull - rfull).max() < LOGIT_TOL, np.abs(tfull - rfull).max()

    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(rp, rb)
    gp = params_from_arrays(_np(rp), tm.cfg, "cpu")
    for p in leaves(gp):
        p.requires_grad_(True)
    loss, met = tm.loss_fn(gp, tb)
    grads = torch.autograd.grad(loss, leaves(gp))
    assert abs(loss.item() - float(rloss)) < LOGIT_TOL
    assert met["moe_aux"].item() == 0.0 == float(rmet["moe_aux"])
    want = params_from_arrays(_np(rgrads), tm.cfg, "cpu")
    worst = {}
    for (path, w), g in zip(leaves_with_paths(want), grads):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        w64, g64 = w.double(), g.double()
        worst[path_name(path)] = float((g64 - w64).norm() / max(float(w64.norm()), 1e-30))
    name = max(worst, key=worst.get)
    assert worst[name] < GRAD_REL, (name, worst[name])
    assert sum(float(g.float().abs().sum()) for g in grads) > 0
    if arch == "whisper-base":
        assert any(k.startswith("encoder/enc_layers") for k in worst)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step_matches_reference(models, arch):
    """Three greedy decode steps from one token, with the memory (encoded
    first for whisper): the same logits and tokens as the reference's, and
    every slot's length 3."""
    rm, rp, tm, tp = models[arch]
    rmem, tmem = _encoded(rm, rp, tm, tp, *_memory(rm.cfg, 2, 1))
    tok = np.random.default_rng(1).integers(0, rm.cfg.vocab, 2).astype(np.int32)
    rtok, ttok = jnp.asarray(tok), _t(tok)
    step = jax.jit(rm.decode_step)
    rcache = rm.cache_init(2, 32)
    with torch.inference_mode():
        tcache = tm.cache_init(2, 32)
        for _ in range(3):
            rlog, rcache = step(rp, rtok, rcache, rmem)
            tlog, tcache = tm.decode_step(tp, ttok, tcache, tmem)
            assert tlog.shape == (2, rm.cfg.vocab) and torch.isfinite(tlog).all()
            assert np.abs(tlog.numpy() - np.asarray(rlog)).max() < LOGIT_TOL
            rtok = jnp.argmax(rlog, axis=-1).astype(jnp.int32)
            ttok = tlog.argmax(-1).int()
    assert tcache["length"].tolist() == [3, 3] == np.asarray(rcache["length"]).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_matches_teacher_forced_forward(models, arch):
    """Decoding token by token reproduces the forward at every position
    (the reference's own check allows 0.75; both packages read ~1e-7 here),
    and the port's decode equals the reference's within LOGIT_TOL."""
    rm, rp, tm, tp = models[arch]
    b, s = 2, 8
    toks = np.random.default_rng(2).integers(0, rm.cfg.vocab, (b, s)).astype(np.int32)
    rmem, tmem = _memory(rm.cfg, b, 2)
    renc, tenc = _encoded(rm, rp, tm, tp, rmem, tmem)
    step = jax.jit(rm.decode_step)
    rcache, rdec = rm.cache_init(b, s + 4), []
    for i in range(s):
        logits, rcache = step(rp, jnp.asarray(toks[:, i]), rcache, renc)
        rdec.append(np.asarray(logits))
    with torch.inference_mode():
        tfull = tm.forward(tp, _t(toks), tmem).numpy()
        tcache, tdec = tm.cache_init(b, s + 4), []
        for i in range(s):
            logits, tcache = tm.decode_step(tp, _t(toks[:, i]), tcache, tenc)
            tdec.append(logits.numpy())
    tdec, rdec = np.stack(tdec, 1), np.stack(rdec, 1)
    assert np.abs(tdec - tfull).max() < LOGIT_TOL
    assert (tdec.argmax(-1) == tfull.argmax(-1)).mean() >= 0.9
    assert np.abs(tdec - rdec).max() < LOGIT_TOL


def test_every_config_builds():
    """All ten smoke configs build, init and run a forward on the CPU."""
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        m = build_model(cfg, "cpu")
        p = m.init(torch.Generator().manual_seed(0))
        mem = (torch.zeros((1, cfg.cross_memory_len, cfg.d_model), dtype=torch.bfloat16)
               if cfg.cross_memory_len else None)
        out = m.forward(p, torch.zeros((1, 3), dtype=torch.int32), mem)
        assert out.shape == (1, 3, cfg.vocab) and torch.isfinite(out).all(), arch


# ---- the parts ------------------------------------------------------------------
def _attn_params(rng, d=48, h=4, kvh=2, hd=12, bias=False):
    p = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd), "wo": (h * hd, d)}
    p = {k: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32) for k, sh in p.items()}
    if bias:      # the reference's cross_attention ignores them; so does the port's
        for k, w in (("bq", h), ("bk", kvh), ("bv", kvh)):
            p[k] = np.ones(w * hd, np.float32)
    return p, dict(n_heads=h, n_kv=kvh, head_dim=hd)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
@pytest.mark.parametrize("port_impl", ["xla", "chunked", "pallas"])
def test_cross_attention_matches_reference(rng, use_pallas_kernels, ref_impl, port_impl):
    """x (B,S,d) attending to memory (B,M,d), GQA, f32, M != S: the port's
    einsum paths and K6's plain version (non-causal, un-repeated KV heads)
    against the reference's einsum path and its Pallas kernel (interpret
    mode)."""
    p, dims = _attn_params(rng, bias=True)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    mem = rng.standard_normal((2, 19, 48)).astype(np.float32)
    want = rattn.cross_attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 jnp.asarray(mem), impl=ref_impl, **dims)
    got = tattn.cross_attention({k: _t(v) for k, v in p.items()}, _t(x), _t(mem),
                                impl=port_impl, **dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_cross_attention_goes_through_k7(rng, monkeypatch):
    """One token over the whole memory: "pallas" calls K7's wrapper once,
    with every length M, and equals the einsum path; "xla" calls nothing."""
    calls = []

    def counting(q, k, v, length, **kw):
        calls.append(length.tolist())
        return da_mod.decode_attention(q, k, v, length, **kw)

    monkeypatch.setattr("repro_torch.kernels.ops._decode", counting)
    p, dims = _attn_params(rng)
    p = {k: _t(v) for k, v in p.items()}
    x = _t(rng.standard_normal((3, 1, 48)).astype(np.float32))
    mem = _t(rng.standard_normal((3, 21, 48)).astype(np.float32))
    got = tattn.decode_cross_attention(p, x, mem, impl="pallas", **dims)
    assert calls == [[21, 21, 21]]
    want = tattn.decode_cross_attention(p, x, mem, impl="xla", **dims)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_encode_matches_reference(models):
    """whisper's encoder over bf16 frames: the reference's (its attn impl
    "xla" at 16 frames) and the port's with K6's plain version and with the
    einsum path."""
    rm, rp, tm, tp = models["whisper-base"]
    rmem, tmem = _memory(rm.cfg, 2, 5)
    want = np.asarray(rtr.encode(rp["encoder"], rmem, rm.cfg), np.float32)
    for impl in ("pallas", "xla"):
        with torch.inference_mode():
            got = transformer.encode(tp["encoder"], tmem, tm.cfg, impl).float().numpy()
        assert np.all(np.abs(got - want) <= 2 * 2.0 ** -8 * np.abs(want) + 1e-6), impl


@pytest.mark.parametrize("s,d", [(1, 2), (16, 64), (1500, 512), (448, 6)])
def test_sinusoid_np_bit_equal(s, d):
    """The forward's table: the reference's numpy computation, bit for bit;
    and decode's float32 rows at each slot's length, as the reference's
    decode computes them."""
    got = transformer._sinusoid_np(s, d)
    np.testing.assert_array_equal(got, rtr._sinusoid_np(s, d))
    assert got.dtype == np.float32 and got.shape == (s, d)
    length = np.array([0, 1, s - 1, 3 * s + 7], np.int32)
    half = d // 2
    i = jnp.arange(half, dtype=jnp.float32)
    ang = jnp.asarray(length)[:, None].astype(jnp.float32) / jnp.power(10000.0, 2 * i / d)
    want = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1))
    np.testing.assert_allclose(transformer._sinusoid_at(_t(length), d).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want[[0, 2]], got[[0, s - 1]], rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_remat_dots_gives_the_same_gradients(models, arch):
    """remat_policy "dots" (the matmuls without batch dimensions saved) and
    "nothing" (all recomputed), and no remat at all: the same loss and
    gradients bit for bit.  The backward under "dots" recomputes no
    ``aten.mm`` (as many as without remat, fewer than under "nothing") but
    does recompute the attention's batched products (``aten.bmm``)."""
    rm, rp, tm, _ = models[arch]
    _, tb = _batch(rm.cfg)
    out, mms = {}, {}
    for policy, remat in (("nothing", True), ("dots", True), ("nothing", False)):
        cfg = dataclasses.replace(tm.cfg, remat_policy=policy, remat=remat)
        m = build_model(cfg, "cpu")
        gp = params_from_arrays(_np(rp), cfg, "cpu")
        for p in leaves(gp):
            p.requires_grad_(True)
        loss, _ = m.loss_fn(gp, tb)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, leaves(gp))
        out[policy, remat] = (loss.detach(), grads)
        mms[policy, remat] = (count.mm, count.bmm)
    base = out["nothing", False]
    for key in (("nothing", True), ("dots", True)):
        assert torch.equal(out[key][0], base[0])
        assert all(torch.equal(a, b) for a, b in zip(out[key][1], base[1])), key
    (mm0, bmm0), (mm1, bmm1), (mm2, bmm2) = (mms["nothing", False], mms["dots", True],
                                             mms["nothing", True])
    assert mm0 == mm1 < mm2 and bmm0 < bmm1 == bmm2, mms


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts aten.mm and aten.bmm calls (forward recomputation
    included)."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        self.bmm += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def test_params_convert_bit_exact_zoo(models):
    """Every leaf bit-exact in the port's layout: whisper's encoder and
    cross / lnx entries, RWKV's float32 mixes, decay and bonus, and (below)
    the experts' stacked tensors and float32 router."""
    def check(ref_layer, port_layer):
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref_layer):
            t = port_layer
            for key in path:
                t = t[key.key if hasattr(key, "key") else key.idx]
            a = np.asarray(leaf)
            assert tuple(t.shape) == a.shape and str(t.dtype).endswith(str(a.dtype)), path
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)

    rm, rp, _, tp = models["whisper-base"]
    check(rp["encoder"], tp["encoder"])
    check(jax.tree.map(lambda x: x[1], rp["blocks"][0]), tp["layers"][1])
    assert set(tp["layers"][1]) == {"ln1", "ln2", "attn", "lnx", "cross", "mlp"}
    rm, rp, _, tp = models["rwkv6-1.6b"]
    check(jax.tree.map(lambda x: x[0], rp["blocks"][0]), tp["layers"][0])
    assert tp["layers"][0]["rwkv"]["mu"].dtype == torch.float32
    rm = r_build(r_smoke("granite-moe-3b-a800m"))
    rp = rm.init(jax.random.PRNGKey(0))
    tp = params_from_arrays(_np(rp), rm.cfg, "cpu")
    check(jax.tree.map(lambda x: x[1], rp["blocks"][0]), tp["layers"][1])
    assert tp["layers"][1]["mlp"]["w_down"].shape == (5, 64, 48)
    assert tp["layers"][1]["mlp"]["router"].dtype == torch.float32


def test_forward_routes_every_attention_through_k6(models, monkeypatch):
    """attn_impl "auto": whisper's two encoder layers non-causal, each
    decoder layer's self-attention causal and its cross-attention
    non-causal (Sk = M); llama-vision's four attn layers causal, its cross
    layer non-causal; "xla" calls nothing.  The two agree."""
    calls = []

    def counting(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return fa_mod.flash_attention(q, k, v, **kw)

    monkeypatch.setattr("repro_torch.kernels.ops._flash", counting)
    for arch, want in (("whisper-base", [(False, 16, 16)] * 2 + [(True, 9, 9), (False, 9, 16)] * 2),
                       ("llama-3.2-vision-90b", [(True, 9, 9)] * 4 + [(False, 9, 16)])):
        _, _, tm, tp = models[arch]
        toks = _t(np.arange(9, dtype=np.int32)[None] % tm.cfg.vocab)
        _, mem = _memory(tm.cfg, 1, 3)
        outs = {}
        for impl in ("auto", "xla"):
            calls.clear()
            with torch.inference_mode():
                outs[impl] = transformer.forward(tp, toks, dataclasses.replace(
                    tm.cfg, attn_impl=impl), mem)[0]
            assert calls == (want if impl == "auto" else []), (arch, impl, calls)
        torch.testing.assert_close(outs["auto"], outs["xla"], rtol=0, atol=LOGIT_TOL)


# ---- the serving engine -----------------------------------------------------------
# four requests on three slots: the fourth reuses a slot (at max_batch 2,
# the smoke configs' 2 scanned repeats, the reference's _reset_slot zeroes
# the wrong lanes: ROADMAP, known divergences)
PROMPTS = [[1, 7, 9, 11], [1, 5], [1, 20, 21], [1, 30]]
MARGIN = 2 * LOGIT_TOL


def _served_ref(rm, rp):
    """The reference engine's tokens and the top-1 − top-2 logit margin
    behind each (read off its decode function)."""
    eng = REngine(rm, rp, max_batch=3, max_seq=16)
    reqs = [RRequest(rid=i, prompt_ids=p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    seen, decode = {}, eng._decode

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
                slot = next(i for i, x in enumerate(seen["slots"]) if x is r)
                top = np.sort(seen["logits"][slot])[::-1]
                margins[r.rid].append(float(top[0] - top[1]))
    return [r.out_ids for r in reqs], margins


def _served_port(tm, tp, max_batch=3):
    eng = ServeEngine(tm, tp, max_batch=max_batch, max_seq=16)
    reqs = [Request(rid=i, prompt_ids=p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.out_ids for r in reqs], eng


@pytest.mark.parametrize("arch", ["whisper-base", "rwkv6-1.6b"])
def test_engine_matches_reference(models, arch):
    """Both engines on the same requests (the fourth reuses a slot: RWKV's
    state and channel-mix token are zeroed); whisper decodes against the
    engine's zero memory (max_batch, 16, d), as the reference's does.  The
    same tokens up to each request's first near-tie (a reference top-1 −
    top-2 margin under twice LOGIT_TOL), as tests/test_torch_serve.py
    compares engines; RWKV's stream does not depend on the slot it ran in."""
    rm, rp, tm, tp = models[arch]
    out, eng = _served_port(tm, tp)
    ref, margins = _served_ref(rm, rp)
    compared = 0
    for rid, (a, b) in enumerate(zip(out, ref)):
        upto = next((j for j, x in enumerate(margins[rid]) if x < MARGIN), len(b))
        assert a[:upto] == b[:upto], (rid, a, b, margins[rid])
        compared += upto
    assert compared >= 3, margins
    if arch == "whisper-base":
        assert eng._memory.shape == (3, 16, 64) and not eng._memory.any()
    else:
        assert eng._memory is None
        assert _served_port(tm, tp, max_batch=1)[0] == out
