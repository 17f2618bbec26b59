"""RG-LRU layer of the PyTorch port against the JAX package
(``repro/models/recurrent.py``): the causal convolution, the recurrence
coefficients, the whole block (the reference under both kernel paths: its
plain ``ref.linear_scan`` and the Pallas kernel in interpret mode), and the
decode step with its state.

Inputs come from numpy seeds; both sides run in float32 on the CPU, at
rtol = atol = 2e-3 (the reference's linear_scan tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as rrec
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
    with pytest.raises(NotImplementedError, match="M10e"):
        trec.rwkv6_block_init(torch.Generator(), 64)
