"""The MoE layer of the PyTorch port (``repro_torch/models/moe.py``) against
the JAX package's (``repro/models/moe.py``), and the two MoE smoke models
(granite-moe-3b-a800m, qwen3-moe-235b-a22b) through both packages.

Inputs come from numpy seeds.  Tolerances:

- the layer in float32: outputs, aux losses and gradients at rtol = atol =
  2e-3, as ``tests/test_torch_models.py`` holds layers;
- the routing itself (which expert, which slot, what is dropped) is exact:
  the tests with ties and with capacity overflow would fail on one route
  placed otherwise;
- whole bf16 smoke models: logits and losses within ``LOGIT_TOL`` = 0.02,
  gradients within ``GRAD_REL`` = 0.06 relative norm, as
  ``tests/test_torch_train.py`` holds them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import build_model as r_build
from repro.models import moe as rmoe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.train.tree import leaves, leaves_with_paths, path_name

TOL = dict(rtol=2e-3, atol=2e-3)
LOGIT_TOL = 0.02
GRAD_REL = 0.06
ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
D, F = 24, 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(rng, e: int, router_scale: float = 1.0) -> dict:
    p = {"router": rng.standard_normal((D, e)) * router_scale / np.sqrt(D),
         "w_gate": rng.standard_normal((e, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((e, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((e, F, D)) / np.sqrt(F)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(rng, params, x, **kw):
    rout, raux = jax.jit(functools.partial(rmoe.moe_apply, **kw))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tout, taux = tmoe.moe_apply({k: _t(v) for k, v in params.items()}, _t(x), **kw)
    return (np.asarray(rout), {k: float(v) for k, v in raux.items()},
            tout.numpy(), {k: v.item() for k, v in taux.items()})


# (B, S, E, top_k, capacity_factor, n_groups): the smoke configs' routing;
# capacity overflow (a factor of 0.5, and 0.3 where every group drops most
# routes); T = 14 and 15 over 16 groups (gcd 2 and 1); top-1; E = 40 top-8
CASES = [(2, 16, 5, 2, 1.25, 16), (2, 16, 8, 2, 1.25, 4), (2, 16, 5, 2, 0.5, 2),
         (3, 10, 6, 3, 0.3, 1), (2, 7, 5, 2, 1.25, 16), (3, 5, 4, 2, 1.0, 16),
         (2, 9, 6, 1, 1.25, 3), (1, 32, 40, 8, 1.25, 16)]


@pytest.mark.parametrize("b,s,e,k,cf,groups", CASES)
def test_moe_apply_matches_reference(rng, b, s, e, k, cf, groups):
    """Outputs and aux losses in float32; the router scaled up so that
    probabilities spread and capacity binds."""
    params = _params(rng, e, router_scale=4.0)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, n_groups=groups)
    rout, raux, tout, taux = _both(rng, params, x, **kw)
    np.testing.assert_allclose(tout, rout, **TOL)
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(taux[name], raux[name], **TOL)


def test_capacity_overflow_drops_routes_as_the_reference():
    """Every token prefers expert 0 first and expert 1 second: with
    capacity ceil(8 * 2 / 4 * 0.5) = 2 per expert, expert 0 keeps the first
    two tokens' first choices, expert 1 (choice-major: first choices place
    before second ones) the first two second choices; the rest are dropped
    and their tokens' output is 0, on both sides."""
    e, k = 4, 2
    params = _params(np.random.default_rng(1), e)
    params["router"] = np.zeros((D, e), np.float32)
    params["router"][0] = [3.0, 2.0, 0.0, -1.0]
    x = np.zeros((1, 8, D), np.float32)
    x[..., 0] = 1.0 + np.arange(8)[None, :] / 8
    x[..., 1:] = np.random.default_rng(2).standard_normal((1, 8, D - 1)) * 0.01
    rout, _, tout, _ = _both(None, params, x, n_experts=e, top_k=k, capacity_factor=0.5,
                             n_groups=1)
    np.testing.assert_allclose(tout, rout, **TOL)
    assert np.abs(tout[0, :2]).max() > 0
    assert not tout[0, 2:].any() and not rout[0, 2:].any()


def test_ties_route_to_the_lower_expert_index(rng):
    """A zero input makes every router logit equal: lax.top_k takes experts
    0 .. k-1 (the lower index wins a tie), and so must the port, whose
    torch.topk promises no order; an exact tie in some of the probabilities
    too (two equal router columns)."""
    vals, idx = tmoe._top_k(torch.full((3, 5, 6), 1 / 6), 3)
    assert idx.tolist() == [[[0, 1, 2]] * 5] * 3 and torch.equal(vals, torch.full((3, 5, 3), 1 / 6))
    e, k = 6, 3
    params = _params(rng, e)
    x = np.zeros((2, 8, D), np.float32)
    rout, raux, tout, taux = _both(rng, params, x, n_experts=e, top_k=k, n_groups=4)
    np.testing.assert_allclose(tout, rout, **TOL)
    np.testing.assert_allclose(taux["load_balance_loss"], raux["load_balance_loss"], **TOL)
    params["router"][:, 4] = params["router"][:, 1]
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    rout, _, tout, _ = _both(rng, params, x, n_experts=e, top_k=k, capacity_factor=0.5,
                             n_groups=2)
    np.testing.assert_allclose(tout, rout, **TOL)
    probs = torch.softmax(_t(x).reshape(-1, D) @ _t(params["router"]), -1)
    _, idx = tmoe._top_k(probs, k)
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), k)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


def test_gcd_groups_matches_reference():
    for t in (1, 2, 14, 15, 16, 24, 4096 * 4):
        for want in (1, 3, 16):
            assert tmoe._gcd_groups(t, want) == rmoe._gcd_groups(t, want)


def test_moe_gradients_match_reference(rng):
    """d(Σ out ⊙ c + aux) against jax.grad, for the input and every
    parameter, in float32, with routes dropped."""
    e, k = 5, 2
    params = _params(rng, e, router_scale=4.0)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    c = rng.standard_normal((2, 12, D)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=0.75, n_groups=4)

    def rloss(p, xx):
        out, aux = rmoe.moe_apply(p, xx, **kw)
        return jnp.sum(out * c) + aux["load_balance_loss"] + aux["router_z_loss"]

    rg = jax.jit(jax.grad(rloss, argnums=(0, 1)))(
        {k_: jnp.asarray(v) for k_, v in params.items()}, jnp.asarray(x))
    tp = {k_: _t(v).requires_grad_() for k_, v in params.items()}
    tx = _t(x).requires_grad_()
    out, aux = tmoe.moe_apply(tp, tx, **kw)
    loss = (out * _t(c)).sum() + aux["load_balance_loss"] + aux["router_z_loss"]
    grads = torch.autograd.grad(loss, [tp[n] for n in params] + [tx])
    for name, g in zip(list(params) + ["x"], grads):
        want = np.asarray(rg[1] if name == "x" else rg[0][name])
        np.testing.assert_allclose(g.numpy(), want, **TOL, err_msg=name)


def test_moe_init_builds_the_reference_tree():
    r = rmoe.moe_init(jax.random.PRNGKey(0), 32, 48, 5)
    t = tmoe.moe_init(torch.Generator().manual_seed(0), 32, 48, 5)
    assert set(r) == set(t)
    for k, v in r.items():
        assert tuple(t[k].shape) == v.shape and str(t[k].dtype).endswith(str(v.dtype)), k
    assert t["router"].dtype == torch.float32 and t["w_down"].dtype == torch.bfloat16
    assert abs(t["w_gate"].float().std().item() - 1 / np.sqrt(32)) < 0.02


# ---- the MoE smoke models ---------------------------------------------------------
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


def _batch(vocab, b=4, s=16, seed=0):
    """tests/test_torch_train.py's batch: random labels, half a row masked.
    (tests/test_arch_smoke.py's labels = tokens makes the bf16 gradients of
    these tied-embedding smoke models ill-conditioned: either package's
    reads 0.1 to 0.5 relative norm off the same graph in float32.)"""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[-1, s // 2:] = 0
    ref = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}
    port = {"tokens": _t(toks), "labels": _t(labels), "mask": _t(mask)}
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_load_balance_loss_present_and_matches_reference(models, arch):
    """tests/test_arch_smoke.py::test_moe_router_load_balance_loss_present
    through both packages: moe_aux > 0, and the port's equal to the
    reference's within LOGIT_TOL; the loss and its gradients too (every
    tensor within GRAD_REL relative norm; the experts' stacked tensors
    included)."""
    rm, rp, tm, _ = models[arch]
    rb, tb = _batch(rm.cfg.vocab)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(rp, rb)
    tp = params_from_arrays(_np(rp), tm.cfg, "cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    loss, met = tm.loss_fn(tp, tb)
    grads = torch.autograd.grad(loss, leaves(tp))
    assert met["moe_aux"].item() > 0 and float(rmet["moe_aux"]) > 0
    assert abs(met["moe_aux"].item() - float(rmet["moe_aux"])) < LOGIT_TOL
    assert abs(loss.item() - float(rloss)) < LOGIT_TOL
    want = params_from_arrays(_np(rgrads), tm.cfg, "cpu")
    worst = {}
    for (path, w), g in zip(leaves_with_paths(want), grads):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        w64, g64 = w.double(), g.detach().double()
        worst[path_name(path)] = float((g64 - w64).norm() / max(float(w64.norm()), 1e-30))
    name = max(worst, key=worst.get)
    assert "layers/#0/mlp/w_down" in worst
    assert worst[name] < GRAD_REL, (name, worst[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_smoke_forward_and_decode_match_reference(models, arch):
    """Forward logits and 12 teacher-forced decode steps, bf16, against the
    reference's within LOGIT_TOL.  Decode routes B tokens a step and the
    forward B x S, so their groups and capacities differ, in either package:
    decode is held to the reference's decode, not to the forward."""
    rm, rp, tm, tp = models[arch]
    b, s = 2, 12
    toks = np.random.default_rng(3).integers(0, rm.cfg.vocab, (b, s)).astype(np.int32)
    rfull = np.asarray(jax.jit(rm.forward)(rp, jnp.asarray(toks)))
    step = jax.jit(rm.decode_step)
    rcache, rdec = rm.cache_init(b, s + 4), []
    for i in range(s):
        logits, rcache = step(rp, jnp.asarray(toks[:, i]), rcache)
        rdec.append(np.asarray(logits))
    with torch.inference_mode():
        tfull = tm.forward(tp, _t(toks)).numpy()
        tcache, tdec = tm.cache_init(b, s + 4), []
        for i in range(s):
            logits, tcache = tm.decode_step(tp, _t(toks[:, i]), tcache)
            tdec.append(logits.numpy())
    assert np.abs(tfull - rfull).max() < LOGIT_TOL
    assert np.abs(np.stack(tdec, 1) - np.stack(rdec, 1)).max() < LOGIT_TOL
