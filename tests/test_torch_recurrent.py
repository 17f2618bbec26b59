"""Recurrent layers of the PyTorch port against the JAX package
(``repro/models/recurrent.py``).  RG-LRU: the causal convolution, the
recurrence coefficients, the whole block (the reference under both kernel
paths: its plain ``ref.linear_scan`` and the Pallas kernel in interpret
mode), and the decode step with its state.  RWKV6: the token-shift inputs,
the sequential block, the chunked block, the channel mix and the decode
step, each against its own reference counterpart.

Inputs come from numpy seeds; both sides run in float32 on the CPU, at
rtol = atol = 2e-3 (the reference's linear_scan tolerance).  RWKV6's decode
takes bf16 activations, as the model feeds it: its outputs, rounded to bf16
by the block's last matmul, at 2e-2 (a few bf16 ulps); its state, float32,
at 2e-3.  The chunked block against the sequential one at 1e-2: the chunked
form reorders the decay products (exp of within-chunk cumulative logs).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as rrec
from repro_torch import convert
from repro_torch.models import recurrent as trec

TOL = dict(rtol=2e-3, atol=2e-3)
D, DR, W = 32, 48, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(rng) -> dict:
    """An RG-LRU block's parameters in float32, the gates large enough that
    a_t spreads over (0, 1), so the recurrence carries state."""
    p = {"w_x": rng.standard_normal((D, DR)) / np.sqrt(D),
         "w_gate_branch": rng.standard_normal((D, DR)) / np.sqrt(D),
         "conv": rng.standard_normal((W, DR)) * 0.5,
         "w_input_gate": rng.standard_normal((DR, DR)) / np.sqrt(DR),
         "w_rec_gate": rng.standard_normal((DR, DR)) / np.sqrt(DR),
         "lam": np.linspace(-4.0, 1.0, DR),
         "w_out": rng.standard_normal((DR, D)) / np.sqrt(DR)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()})


def test_causal_conv1d_matches_reference(rng):
    x = rng.standard_normal((2, 11, DR)).astype(np.float32)
    w = rng.standard_normal((W, DR)).astype(np.float32)
    np.testing.assert_allclose(trec._causal_conv1d(_t(x), _t(w)).numpy(),
                               np.asarray(rrec._causal_conv1d(jnp.asarray(x), jnp.asarray(w))),
                               **TOL)


def test_causal_conv1d_bf16_rounds_once(rng):
    """bf16 in and out: the taps summed in float32, rounded once."""
    x = _t(rng.standard_normal((2, 7, DR)).astype(np.float32)).to(torch.bfloat16)
    w = _t(rng.standard_normal((W, DR)).astype(np.float32)).to(torch.bfloat16)
    got = trec._causal_conv1d(x, w)
    assert got.dtype == torch.bfloat16
    xp = torch.nn.functional.pad(x.float(), (0, 0, W - 1, 0))
    exact = sum(xp[:, i:i + 7] * w[i].float() for i in range(W))
    assert torch.equal(got, exact.to(torch.bfloat16))


def test_rglru_coeffs_match_reference(rng):
    rp, tp = _both(_params(rng))
    u = rng.standard_normal((2, 9, DR)).astype(np.float32)
    ra, rb = rrec._rglru_coeffs(rp, jnp.asarray(u))
    ta, tb = trec._rglru_coeffs(tp, _t(u))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ra), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(rb), **TOL)
    assert float(ta.max()) > 0.9      # some channels carry their state


@pytest.mark.parametrize("kernels", [False, True])
def test_rglru_block_matches_reference(rng, monkeypatch, kernels):
    """The block, its recurrence on ref.linear_scan or on the Pallas kernel
    (interpret mode) on the reference's side, on the port's linear_scan
    (plain version on the CPU) in one (B, S, dr) call."""
    if kernels:
        monkeypatch.setenv("REPRO_USE_KERNELS", "1")
    rp, tp = _both(_params(rng))
    x = rng.standard_normal((3, 70, D)).astype(np.float32)
    exp = np.asarray(rrec.rglru_block(rp, jnp.asarray(x)))
    np.testing.assert_allclose(trec.rglru_block(tp, _t(x)).numpy(), exp, **TOL)


def test_rglru_decode_matches_reference(rng):
    """Ten decode steps from the zero state: outputs and states against the
    reference's, the state written in place; the outputs equal the block's
    forward over the same tokens."""
    rp, tp = _both(_params(rng))
    x = rng.standard_normal((2, 10, D)).astype(np.float32)
    rstate = rrec.rglru_decode_init(2, DR)
    tstate = trec.rglru_decode_init(2, DR, "cpu")      # conv_buf bf16, as the reference's
    h_tensor = tstate["h"]
    outs = []
    for i in range(10):
        rout, rstate = rrec.rglru_decode(rp, jnp.asarray(x[:, i:i + 1]), rstate)
        tout, same = trec.rglru_decode(tp, _t(x[:, i:i + 1]), tstate)
        assert same is tstate and tstate["h"] is h_tensor
        np.testing.assert_allclose(tout.numpy(), np.asarray(rout), **TOL)
        for name in ("h", "conv_buf"):
            np.testing.assert_allclose(tstate[name].float().numpy(),
                                       np.asarray(rstate[name], np.float32), **TOL)
        outs.append(tout)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), trec.rglru_block(tp, _t(x)).numpy(),
                               **TOL)


def test_rglru_init_and_decode_state_match_reference():
    rp = rrec.rglru_block_init(jax.random.PRNGKey(0), D, DR)
    tp = trec.rglru_block_init(torch.Generator().manual_seed(0), D, DR)
    for k, v in rp.items():
        assert tuple(tp[k].shape) == v.shape and str(tp[k].dtype).endswith(str(v.dtype)), k
    np.testing.assert_array_equal(tp["lam"].numpy(), np.asarray(rp["lam"]))
    rs, ts = rrec.rglru_decode_init(3, DR), trec.rglru_decode_init(3, DR, "cpu")
    for k, v in rs.items():
        assert tuple(ts[k].shape) == v.shape and str(ts[k].dtype).endswith(str(v.dtype)), k
        assert not ts[k].any()


def test_rwkv_raises_naming_m10e():
    """Until RWKV6 was ported (ROADMAP M10e) this init raised
    NotImplementedError naming M10e.  Now it builds the reference's tree
    (keys, shapes, dtypes: the mixes, decay and bonus float32, the
    projections bf16), and the refusal it still carries is a width that is
    not a whole number of heads: the port raises ValueError at init, where
    the reference builds the tree and fails at its first forward, in a
    reshape."""
    rp = rrec.rwkv6_block_init(jax.random.PRNGKey(0), 64, 16)
    tp = trec.rwkv6_block_init(torch.Generator().manual_seed(0), 64, 16)
    assert _sig(tp) == _sig(rp)
    np.testing.assert_array_equal(tp["decay_base"].numpy(), np.asarray(rp["decay_base"]))
    with pytest.raises(ValueError, match="not a multiple of head_dim"):
        trec.rwkv6_block_init(torch.Generator(), 64, 48)
    bad = rrec.rwkv6_block_init(jax.random.PRNGKey(0), 64, 48)
    with pytest.raises(TypeError):
        rrec.rwkv6_block(bad, jnp.zeros((1, 3, 64), jnp.bfloat16), head_dim=48)


# ---- RWKV6 --------------------------------------------------------------------------
# parameters at D_RW = 48, 3 heads of 16: the decays' base the reference's
# init (w from about 0.2 to near 1, so the state carries; a faster decay
# overflows exp(-cumsum log w) over a chunk of 64, in either package), the
# bonus and mixes large enough to count
D_RW, HD, FF = 48, 16, 80


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


def _rwkv_params(rng, projections=np.float32) -> dict:
    """float32 parameters; the five projections in ``projections`` (bf16 as
    the model stores them, for decode's bf16 activations)."""
    p = {"mu": rng.random((5, D_RW)),
         **{n: rng.standard_normal((D_RW, D_RW)) / np.sqrt(D_RW)
            for n in ("w_r", "w_k", "w_v", "w_g", "w_o")},
         "decay_a": rng.standard_normal((D_RW, 32)) / np.sqrt(D_RW),
         "decay_b": rng.standard_normal((32, D_RW)) / np.sqrt(32),
         "decay_base": np.linspace(-6.0, -0.5, D_RW),
         "bonus": rng.standard_normal((D_RW // HD, HD)) * 0.5}
    p = {k: v.astype(projections if k in ("w_r", "w_k", "w_v", "w_g", "w_o") else np.float32)
         for k, v in p.items()}
    p["ln_out"] = {"scale": (1 + 0.1 * rng.standard_normal(D_RW)).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(D_RW)).astype(np.float32)}
    return p


def _cmix_params(rng) -> dict:
    p = {"mu": rng.random((2, D_RW)), "w_k": rng.standard_normal((D_RW, FF)) / np.sqrt(D_RW),
         "w_v": rng.standard_normal((FF, D_RW)) / np.sqrt(FF),
         "w_r": rng.standard_normal((D_RW, D_RW)) / np.sqrt(D_RW)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _tree_both(p):
    return jax.tree.map(jnp.asarray, p), convert._tree(p, "cpu")


def test_rwkv6_inputs_match_reference(rng):
    rp, tp = _tree_both(_rwkv_params(rng))
    x = rng.standard_normal((2, 9, D_RW)).astype(np.float32)
    xp = rng.standard_normal((2, 9, D_RW)).astype(np.float32)
    want = rrec._rwkv6_inputs(rp, jnp.asarray(x), jnp.asarray(xp))
    got = trec._rwkv6_inputs(tp, _t(x), _t(xp))
    for name, g, w in zip("rkvgw", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    assert 0.1 < float(got[4].min()) < 0.7 and 0.99 < float(got[4].max()) < 1


@pytest.mark.parametrize("s", [1, 13, 70])
def test_rwkv6_block_matches_reference(rng, s):
    """The sequential scan over time, float32."""
    rp, tp = _tree_both(_rwkv_params(rng))
    x = rng.standard_normal((2, s, D_RW)).astype(np.float32)
    want = jax.jit(functools.partial(rrec.rwkv6_block, head_dim=HD))(rp, jnp.asarray(x))
    np.testing.assert_allclose(trec.rwkv6_block(tp, _t(x), head_dim=HD).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("s,chunk", [(40, 16), (64, 64), (70, 64), (5, 8)])
def test_rwkv6_chunked_matches_reference(rng, s, chunk):
    """The chunked form against the reference's chunked form (padding when
    the chunk does not divide S), and, looser, against the sequential scan
    it reorders: the two are not bit-equal in either package."""
    rp, tp = _tree_both(_rwkv_params(rng))
    x = rng.standard_normal((2, s, D_RW)).astype(np.float32)
    fn = functools.partial(rrec.rwkv6_chunked, head_dim=HD, chunk=chunk)
    want = np.asarray(jax.jit(fn)(rp, jnp.asarray(x)))
    got = trec.rwkv6_chunked(tp, _t(x), head_dim=HD, chunk=chunk).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, trec.rwkv6_block(tp, _t(x), head_dim=HD).numpy(),
                               rtol=1e-2, atol=1e-2)


def test_rwkv_cmix_matches_reference(rng):
    """The channel mix with its own token shift, and with a given previous
    token (decode's)."""
    rp, tp = _tree_both(_cmix_params(rng))
    x = rng.standard_normal((2, 7, D_RW)).astype(np.float32)
    xp = rng.standard_normal((2, 1, D_RW)).astype(np.float32)
    np.testing.assert_allclose(trec.rwkv_cmix(tp, _t(x)).numpy(),
                               np.asarray(rrec.rwkv_cmix(rp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        trec.rwkv_cmix(tp, _t(x[:, :1]), x_prev=_t(xp)).numpy(),
        np.asarray(rrec.rwkv_cmix(rp, jnp.asarray(x[:, :1]), x_prev=jnp.asarray(xp))), **TOL)


def test_rwkv6_decode_matches_reference(rng):
    """Ten decode steps from the zero state, bf16 activations as the model
    feeds them: outputs and states against the reference's, the state
    written in place; the outputs follow the sequential forward over the
    same tokens."""
    import ml_dtypes
    rp, tp = _tree_both(_rwkv_params(rng, ml_dtypes.bfloat16))
    x = (rng.standard_normal((2, 10, D_RW))).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = _t(x).bfloat16()
    rstate = rrec.rwkv6_decode_init(2, D_RW, HD)
    tstate = trec.rwkv6_decode_init(2, D_RW, "cpu", HD)
    assert _sig(tstate) == _sig(rstate) and not any(t.any() for t in tstate.values())
    s_tensor = tstate["S"]
    step = jax.jit(functools.partial(rrec.rwkv6_decode, head_dim=HD))
    outs = []
    for i in range(10):
        rout, rstate = step(rp, xb[:, i:i + 1], rstate)
        tout, same = trec.rwkv6_decode(tp, tb[:, i:i + 1], tstate, head_dim=HD)
        assert same is tstate and tstate["S"] is s_tensor
        np.testing.assert_allclose(tout.float().numpy(), np.asarray(rout, np.float32),
                                   rtol=2e-2, atol=2e-2)
        for name in ("S", "x_prev"):
            np.testing.assert_allclose(tstate[name].float().numpy(),
                                       np.asarray(rstate[name], np.float32), **TOL)
        outs.append(tout)
    np.testing.assert_allclose(torch.cat(outs, 1).float().numpy(),
                               trec.rwkv6_block(tp, tb, head_dim=HD).float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_rwkv_cmix_init_builds_the_reference_tree():
    r = rrec.rwkv_cmix_init(jax.random.PRNGKey(0), 32, 48)
    t = trec.rwkv_cmix_init(torch.Generator().manual_seed(0), 32, 48)
    assert _sig(t) == _sig(r)
