"""Training in the PyTorch port (``repro_torch/train/``, ``Model.loss_fn``,
``layers.softmax_xent``, K5's gradient) against the JAX package's, on the
CPU, with the smoke configs.

Inputs come from numpy seeds and the reference's parameters, converted
bit-exact (``convert.params_from_arrays``).  Tolerances:

- ``softmax_xent``: rtol = atol = 2e-3 (float32 inputs).
- The loss of a bf16 smoke model: within ``LOGIT_TOL`` = 0.02, as the
  model tests hold logits; each gradient tensor within ``GRAD_REL`` = 0.06
  relative norm: both packages round the same bf16 graph in different
  orders, and the largest reading over granite-8b and recurrentgemma-9b
  smoke is 0.030.
- The optimizers, fed the reference's own gradients: parameters bit-equal
  after two steps, the state within ``STATE_RTOL`` = 1e-5 of its largest
  entry (readings up to 5.5e-7: float32 pow and mean orders).
- A whole train step (gradients and update): loss within ``LOGIT_TOL``,
  grad norm within ``GN_RTOL`` = 1e-2 (reading 3e-4), and the parameters'
  update taken as one vector within ``STEP_REL`` = 0.26 relative norm of
  the reference's, twice the largest reading (AdamW 0.111-0.129, Adafactor
  0.063-0.080): both normalize each gradient element (AdamW's first step is
  its sign), so an element whose gradient is near 0 may step either way in
  either package.
- K5's Function: equal (``torch.equal``) to autograd through
  ``linear_scan_plain``, and within rtol = atol = 2e-5 of ``jax.grad`` of
  ``ref.linear_scan``.
- Schedules: rtol 1e-6 (float32 cos of either library).
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.data import DataPipeline as RPipeline
from repro.data import PipelineConfig as RConfig
from repro.data import synthetic_corpus as r_corpus
from repro.kernels import ref as rref
from repro.models import build_model as r_build
from repro.models import layers as rlayers
from repro.train import adafactor as r_adafactor
from repro.train import adamw as r_adamw
from repro.train import optimizer as r_opt
from repro.train import schedule as r_sched
from repro.train.trainer import init_state as r_init_state
from repro.train.trainer import make_train_step as r_make_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import linear_scan as ls_mod
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, layers as tlayers
from repro_torch.train import CheckpointManager, adafactor, adamw
from repro_torch.train import optimizer as t_opt
from repro_torch.train import schedule as t_sched
from repro_torch.train.fault import (FailurePlan, StragglerPolicy, elastic_remesh,
                                     run_with_recovery)
from repro_torch.train.trainer import TrainConfig, Trainer, init_state, make_train_step
from repro_torch.train.tree import leaves, leaves_with_paths, path_name

LOGIT_TOL = 0.02
GRAD_REL = 0.06
STATE_RTOL = 1e-5
GN_RTOL = 1e-2
STEP_REL = 0.26
TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["granite-8b", "recurrentgemma-9b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double()
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _ref_flat(tree) -> dict:
    """The reference tree's leaves by checkpoint key (``#i`` for a list
    item), as numpy."""
    return {"/".join(str(k.key) if hasattr(k, "key") else f"#{k.idx}" for k in path):
            np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(vocab, b=4, s=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    if masked:
        mask[-1, s // 2:] = 0
    ref = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}
    port = {"tokens": _t(toks), "labels": _t(labels), "mask": _t(mask)}
    return ref, port


@pytest.fixture(scope="module")
def models():
    """The reference's smoke model and parameters (PRNGKey 0), and the
    port's model, per arch."""
    out = {}
    for arch in ARCHS:
        rm = r_build(r_smoke(arch))
        out[arch] = (rm, rm.init(jax.random.PRNGKey(0)), build_model(get_smoke_config(arch), "cpu"))
    return out


def _port_params(tm, rp, grad=True):
    tp = params_from_arrays(_np(rp), tm.cfg, "cpu")
    for p in leaves(tp):
        p.requires_grad_(grad)
    return tp


# ---- softmax_xent -------------------------------------------------------------
@pytest.mark.parametrize("masked,z_loss", [(False, 1e-4), (True, 1e-4), (True, 0.0)])
def test_softmax_xent_matches_reference(rng, masked, z_loss):
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32) if masked else None
    got = tlayers.softmax_xent(_t(logits), _t(labels), None if mask is None else _t(mask),
                               z_loss=z_loss)
    want = rlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask), z_loss=z_loss)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)


# ---- loss and gradients ----------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(models, arch):
    """loss_fn and every parameter's gradient, the reference's through
    jax.value_and_grad and mapped into the port's layout; the batch masks
    half a row."""
    rm, rp, tm = models[arch]
    rb, tb = _batch(rm.cfg.vocab, masked=True)
    (rloss, rmet), rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(rp, rb)
    tp = _port_params(tm, rp)
    loss, met = tm.loss_fn(tp, tb)
    grads = torch.autograd.grad(loss, leaves(tp))
    assert abs(loss.item() - float(rloss)) < LOGIT_TOL
    assert abs(met["xent"].item() - float(rmet["xent"])) < LOGIT_TOL
    assert met["moe_aux"].item() == 0.0 == float(rmet["moe_aux"])
    want = params_from_arrays(_np(rgrads), tm.cfg, "cpu")
    worst = {}
    for (path, w), g in zip(leaves_with_paths(want), grads):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        worst[path_name(path)] = _rel(g.float(), w.float().numpy())
    name = max(worst, key=worst.get)
    print(f"{arch}: loss {loss.item():.6f} vs {float(rloss):.6f}; worst gradient {name} "
          f"{worst[name]:.4g} relative norm")
    assert worst[name] < GRAD_REL, (name, worst[name])


def test_loss_fn_with_remat_off_gives_the_same_gradients(models):
    """cfg.remat only changes what is kept for the backward: the gradients
    are the same bit for bit."""
    rm, rp, tm = models["recurrentgemma-9b"]
    _, tb = _batch(rm.cfg.vocab)
    out = []
    for remat in (True, False):
        m = build_model(dataclasses.replace(tm.cfg, remat=remat), "cpu")
        tp = _port_params(m, rp)
        loss, _ = m.loss_fn(tp, tb)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves(tp))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_loss_fn_pallas_raises_naming_k6(models):
    rm, rp, tm = models["granite-8b"]
    m = build_model(dataclasses.replace(tm.cfg, attn_impl="pallas"), "cpu")
    _, tb = _batch(rm.cfg.vocab)
    with pytest.raises(RuntimeError, match="K6"):
        m.loss_fn(_port_params(m, rp), tb)


def test_inference_entry_points_record_nothing(models):
    """forward / prefill run K6's wrapper (attn_impl auto); with parameters
    that require grad they record nothing and do not raise."""
    rm, rp, tm = models["recurrentgemma-9b"]
    tp = _port_params(tm, rp)
    toks = _t(np.random.default_rng(4).integers(0, rm.cfg.vocab, (2, 12)).astype(np.int32))
    out = tm.forward(tp, toks)
    last = tm.prefill(tp, toks)
    assert not out.requires_grad and not last.requires_grad
    np.testing.assert_allclose(out[:, -1].numpy(), last.numpy(), rtol=1e-4, atol=1e-4)


# ---- optimizers ------------------------------------------------------------------
def _two_updates(opt, grads, params, period):
    state = opt.init(params, period=period)
    for _ in range(2):
        params, state = opt.update(grads, state, params, torch.tensor(1e-3), period=period)
    return params, state


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_updates_match_reference(models, arch, name):
    """Two updates from the reference's own gradients: the parameters
    bit-equal, the state within STATE_RTOL.  Adafactor's state is in the
    reference's stacked layout (trap 1: granite smoke's two layers stack,
    so each norm scale's second moment is factored over (2, 64))."""
    rm, rp, tm = models[arch]
    rb, _ = _batch(rm.cfg.vocab)
    _, rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(rp, rb)
    ropt, topt = {"adamw": (r_adamw(), adamw()), "adafactor": (r_adafactor(), adafactor())}[name]
    rparams, rstate = rp, ropt.init(rp)
    for _ in range(2):
        rparams, rstate = ropt.update(rgrads, rstate, rparams, jnp.float32(1e-3))
    period = len(tm.cfg.pattern)
    tparams, tstate = _two_updates(topt, params_from_arrays(_np(rgrads), tm.cfg, "cpu"),
                                   _port_params(tm, rp, grad=False), period)
    want = params_from_arrays(_np(rparams), tm.cfg, "cpu")
    for (path, w), g in zip(leaves_with_paths(want), leaves(tparams)):
        assert g.dtype == w.dtype and torch.equal(g, w), path_name(path)
    assert int(tstate["count"]) == int(rstate["count"]) == 2
    if name == "adamw":
        for key in ("m", "v"):
            wtree = params_from_arrays(_np(rstate[key]), tm.cfg, "cpu")
            for w, g in zip(leaves(wtree), leaves(tstate[key])):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                           atol=STATE_RTOL * float(w.abs().max()))
        return
    rflat = _ref_flat(rstate["v"])
    tflat = {path_name(p): v for p, v in leaves_with_paths(tstate["v"])}
    assert set(tflat) == set(rflat)
    for k, w in rflat.items():
        assert tflat[k].shape == w.shape, k
        np.testing.assert_allclose(tflat[k].numpy(), w, rtol=0,
                                   atol=STATE_RTOL * float(np.abs(w).max()), err_msg=k)
    assert set(tstate["v"]["embed"]) == {"vr", "vc"}
    if arch == "granite-8b":
        scale = tstate["v"]["blocks"][0]["ln1"]["scale"]
        assert set(scale) == {"vr", "vc"}
        assert tuple(scale["vr"].shape) == (2,) and tuple(scale["vc"].shape) == (64,)


def test_adafactor_per_layer_is_not_the_reference(models):
    """Trap 1 shown: Adafactor over the port's per-layer tensors (no
    stacking: period = n_layers) gives granite smoke's norm scales unfactored
    moments and other parameters than the reference's grouping does."""
    rm, rp, tm = models["granite-8b"]
    rb, _ = _batch(rm.cfg.vocab)
    _, rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(rp, rb)
    grads = params_from_arrays(_np(rgrads), tm.cfg, "cpu")
    grouped, _ = _two_updates(adafactor(), grads, _port_params(tm, rp, grad=False), 1)
    flat, state = _two_updates(adafactor(), grads, _port_params(tm, rp, grad=False),
                               tm.cfg.n_layers)
    assert set(state["v"]["blocks"][0]["ln1"]["scale"]) == {"v"}
    assert not torch.equal(grouped["layers"][0]["ln1"]["scale"],
                           flat["layers"][0]["ln1"]["scale"])


def test_clip_by_global_norm_matches_reference(models):
    rm, rp, tm = models["granite-8b"]
    rb, _ = _batch(rm.cfg.vocab)
    _, rgrads = jax.value_and_grad(rm.loss_fn, has_aux=True)(rp, rb)
    grads = params_from_arrays(_np(rgrads), tm.cfg, "cpu")
    gn = float(t_opt.global_norm(grads))
    for max_norm in (gn / 4, gn * 4):
        got = t_opt.clip_by_global_norm(grads, max_norm)
        want = params_from_arrays(_np(r_opt.clip_by_global_norm(rgrads, max_norm)), tm.cfg, "cpu")
        for g, w in zip(leaves(got), leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=2 ** -7, atol=1e-6)
    scaled = t_opt.global_norm(t_opt.clip_by_global_norm(grads, gn / 4))
    assert abs(float(scaled) - gn / 4) < 1e-2 * gn / 4


# ---- the train step ---------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(models, arch, name, microbatches):
    """One step of make_train_step, gradients and update, from the same
    parameters and batch of 8: loss, grad norm and the update against the
    reference's make_train_step with the same microbatch count."""
    rm, rp, tm = models[arch]
    rb, tb = _batch(rm.cfg.vocab, b=8)
    ropt, topt = {"adamw": (r_adamw(), adamw()), "adafactor": (r_adafactor(), adafactor())}[name]
    rstate = r_init_state(rm, jax.random.PRNGKey(0), ropt)
    rnew, rmet = r_make_step(rm, ropt, lambda s: 1e-3, microbatches=microbatches,
                             donate=False)(rstate, rb)
    tp = _port_params(tm, rp)
    before = [p.detach().clone() for p in leaves(tp)]
    state = {"params": tp, "opt": topt.init(tp, period=len(tm.cfg.pattern)),
             "step": torch.zeros((), dtype=torch.int32)}
    new, met = make_train_step(tm, topt, lambda s: 1e-3, microbatches=microbatches)(state, tb)
    assert int(new["step"]) == 1
    assert set(met) == {"loss", "xent", "moe_aux", "lr", "grad_norm"}
    assert abs(met["loss"].item() - float(rmet["loss"])) < LOGIT_TOL
    assert abs(met["grad_norm"].item() / float(rmet["grad_norm"]) - 1) < GN_RTOL
    want = params_from_arrays(_np(rnew["params"]), tm.cfg, "cpu")
    got_step = torch.cat([(p.detach().double() - b.double()).ravel()
                          for p, b in zip(leaves(new["params"]), before)])
    want_step = torch.cat([(w.double() - b.double()).ravel()
                           for w, b in zip(leaves(want), before)])
    rel = float((got_step - want_step).norm() / want_step.norm())
    print(f"{arch} {name} microbatches {microbatches}: loss {met['loss'].item():.6f} vs "
          f"{float(rmet['loss']):.6f}, update {rel:.4g} relative norm off the reference's")
    assert rel < STEP_REL


def test_microbatches_sum_in_float32(models):
    """Four microbatches against one batch of the same 8 rows, in the port:
    the loss is their mean, and gradients accumulate in float32 (trap 2)."""
    rm, rp, tm = models["granite-8b"]
    _, tb = _batch(rm.cfg.vocab, b=8)
    out = {}
    for mb in (1, 4):
        tp = _port_params(tm, rp)
        state = {"params": tp, "opt": adamw().init(tp), "step": torch.zeros((), dtype=torch.int32)}
        out[mb] = make_train_step(tm, adamw(), lambda s: 1e-3, microbatches=mb)(state, tb)
    assert abs(out[1][1]["loss"].item() - out[4][1]["loss"].item()) < 5e-2
    for a, b in zip(leaves(out[1][0]["params"]), leaves(out[4][0]["params"])):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   atol=2e-2)


def test_loss_decreases_with_adafactor(models):
    rm, rp, tm = models["recurrentgemma-9b"]
    _, tb = _batch(rm.cfg.vocab)
    state = init_state(tm, 0, adafactor())
    step = make_train_step(tm, adafactor(), t_sched.constant(1e-2))
    losses = []
    for _ in range(6):
        state, m = step(state, tb)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]


# ---- schedules --------------------------------------------------------------------
def test_warmup_cosine_matches_reference():
    got = t_sched.warmup_cosine(1e-3, 7, 60)
    want = r_sched.warmup_cosine(1e-3, 7, 60)
    for step in range(0, 63):
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(g.item(), float(want(step)), rtol=1e-6, atol=0)
    assert t_sched.constant(2e-3)(5).item() == float(r_sched.constant(2e-3)(5))


# ---- checkpoints and recovery ---------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(models):
    _, _, tm = models["granite-8b"]
    state = init_state(tm, 0, adamw())
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, state, extra={"cursor": step * 10}, blocking=True)
        assert mgr.latest_step() == 4
        kept = sorted(n for n in os.listdir(td) if n.startswith("step_"))
        assert kept == ["step_3", "step_4"]
        arrays = np.load(os.path.join(td, "step_4", "arrays.npz"))
        assert arrays["params/layers/#0/attn/wq"].dtype == np.float32   # bf16 widened
        template = init_state(tm, 1, adamw())
        restored, extra = mgr.restore(template)
        assert extra["cursor"] == 40
        for (path, a), b in zip(leaves_with_paths(state), leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach()), path_name(path)
            assert b.requires_grad == a.requires_grad


def test_checkpoint_atomicity_no_tmp_left(models):
    _, _, tm = models["granite-8b"]
    state = init_state(tm, 0, adafactor())
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(7, state, blocking=True)
        assert not any(n.endswith(".tmp") for n in os.listdir(td))
        assert os.path.exists(os.path.join(td, "step_7", "meta.json"))


def test_checkpoint_save_error_raised_on_wait(models):
    _, _, tm = models["granite-8b"]
    state = init_state(tm, 0, adamw())
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        os.makedirs(os.path.join(td, "step_3.tmp"))
        open(os.path.join(td, "step_3"), "w").close()   # a file where the commit renames
        mgr.save(3, state)
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()   # raised once


def test_recovery_resumes_at_the_exact_cursor(models):
    """A failure before batch 8 restores step 6 and its cursor: the restart
    trains batches 7, 8, ... again, and the final parameters equal those of
    a run that never failed."""
    _, _, tm = models["granite-8b"]
    corpus = r_corpus(400, seed=5, mean_len=30)
    pc = PipelineConfig(seq_len=16, global_batch=4, shard_docs=100)
    seen = []

    def run(td, plan):
        tc = TrainConfig(lr=1e-3, total_steps=10, checkpoint_dir=td,
                         checkpoint_every=3, log_every=100)
        trainer = Trainer(tm, tc)
        step_fn = trainer.train_step

        def recording(state, batch):
            seen.append(int(batch["tokens"][0, 0]))
            return step_fn(state, batch)
        trainer.train_step = recording
        return run_with_recovery(trainer, lambda: DataPipeline(corpus, tm.cfg.vocab, pc,
                                                               device="cpu").batches(),
                                 steps=10, failure_plan=plan), trainer

    with tempfile.TemporaryDirectory() as td:
        state, trainer = run(td, FailurePlan(fail_at_steps=(8,)))
        assert int(state["step"]) == 10
        assert CheckpointManager(td).restore(state)[1]["cursor"] == 10
    failed = list(seen)
    seen.clear()
    with tempfile.TemporaryDirectory() as td:
        clean, _ = run(td, None)
    firsts = seen
    assert len(firsts) == 10
    # 7 batches, then from the step-6 checkpoint batches 7..10
    assert failed == firsts[:7] + firsts[6:]
    for a, b in zip(leaves(state["params"]), leaves(clean["params"])):
        assert torch.equal(a.detach(), b.detach())


def test_straggler_policy_scales_with_jitter():
    pol = StragglerPolicy()
    steady = [1.0] * 32
    jittery = [1.0, 1.0, 1.0, 4.0] * 8
    assert pol.recommend_depth(steady) <= pol.recommend_depth(jittery)
    assert pol.min_depth <= pol.recommend_depth(jittery) <= pol.max_depth
    assert pol.recommend_depth([1.0, 2.0]) == pol.min_depth


def test_elastic_remesh_raises_naming_m11():
    """Kept under its id from before the launch layer (M11) was ported, when
    ``elastic_remesh`` raised naming M11.  It now builds the mesh: on the
    CPU (a one-rank gloo group, closed after) the (1, 1) ("data", "model")
    mesh the reference's ``elastic_remesh(4)`` builds from one CPU device,
    and without ``device="cpu"`` it targets CUDA, raising without a GPU."""
    from repro.train.fault import elastic_remesh as r_elastic_remesh
    from repro_torch.launch.mesh import close_local_group
    want = r_elastic_remesh(4)
    try:
        got = elastic_remesh(4, device="cpu")
        assert tuple(got.shape) == tuple(want.devices.shape) == (1, 1)
        assert got.mesh_dim_names == tuple(want.axis_names) == ("data", "model")
        assert got.device_type == "cpu"
    finally:
        close_local_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            elastic_remesh(4)


# ---- kernels under grad ----------------------------------------------------------------
@pytest.mark.parametrize("shape", [(16, 8), (300, 17), (2, 65, 33), (1, 1, 4)])
def test_linear_scan_function_gradient(rng, shape):
    """K5's autograd Function on the CPU (its plain forward and backward):
    equal to autograd through linear_scan_plain, and to jax.grad of the
    reference's ref.linear_scan (vmapped over a batch axis)."""
    a = (rng.random(shape) * 0.95).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    h = ls_mod.linear_scan(ta, tb)
    ga, gb = torch.autograd.grad((h * _t(w)).sum(), (ta, tb))
    pa, pb = _t(a).requires_grad_(), _t(b).requires_grad_()
    ha = ls_mod.linear_scan_plain(pa, pb)
    wa, wb = torch.autograd.grad((ha * _t(w)).sum(), (pa, pb))
    assert torch.equal(h, ha.detach()) and torch.equal(ga, wa) and torch.equal(gb, wb)
    scan = rref.linear_scan if a.ndim == 2 else jax.vmap(rref.linear_scan)
    ja, jb = jax.grad(lambda x, y: jnp.sum(scan(x, y) * w), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), rtol=2e-5, atol=2e-5)


def test_linear_scan_backward_plain_is_the_reversed_recurrence(rng):
    a = _t((rng.random((3, 40, 6)) * 0.9).astype(np.float32))
    g = _t(rng.standard_normal((3, 40, 6)).astype(np.float32))
    h = ls_mod.linear_scan_plain(a, _t(rng.standard_normal((3, 40, 6)).astype(np.float32)))
    ga, gb = ls_mod.linear_scan_backward_plain(a, g, h)
    dh = np.zeros((3, 6), np.float32)
    for t in range(39, -1, -1):
        nxt = a[:, t + 1].numpy() * dh if t < 39 else np.float32(0)
        dh = (g[:, t].numpy() + nxt).astype(np.float32)
        np.testing.assert_array_equal(gb[:, t].numpy(), dh)
        prev = h[:, t - 1].numpy() if t else np.zeros_like(dh)
        np.testing.assert_array_equal(ga[:, t].numpy(), dh * prev)


def test_linear_scan_cpu_counts_no_launch(rng):
    ls_mod.counter.reset()
    a = _t((rng.random((2, 9, 4)) * 0.9).astype(np.float32)).requires_grad_()
    torch.autograd.grad(ls_mod.linear_scan(a, a * 0 + 1).sum(), a)
    assert ls_mod.counter.launches == 0 and ls_mod.counter.routes == {}


def test_attention_kernels_raise_under_grad(rng):
    """K6 and K7 have no backward: their wrappers refuse an input that
    requires grad (on any device) rather than return an output autograd
    cannot see through; without grad, or under no_grad, they run."""
    q = _t(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 8, 1, 16)).astype(np.float32))
    with pytest.raises(RuntimeError, match="K6.*no backward"):
        fa_mod.flash_attention(q.clone().requires_grad_(), k, k)
    with torch.no_grad():
        fa_mod.flash_attention(q.clone().requires_grad_(), k, k)
    fa_mod.flash_attention(q, k, k)
    qd = _t(rng.standard_normal((1, 2, 16)).astype(np.float32))
    length = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="K7.*no backward"):
        da_mod.decode_attention(qd, k, k.clone().requires_grad_(), length)
    da_mod.decode_attention(qd, k, k, length)


# ---- entry points -------------------------------------------------------------------------
def test_trainer_fits_from_the_pipeline(models):
    _, _, tm = models["granite-8b"]
    corpus = r_corpus(300, seed=1, mean_len=30)
    pipe = DataPipeline(corpus, tm.cfg.vocab, PipelineConfig(seq_len=16, global_batch=4,
                                                             shard_docs=100), device="cpu")
    trainer = Trainer(tm, TrainConfig(lr=1e-3, warmup_steps=2, total_steps=4, log_every=1))
    state = trainer.fit(pipe.batches(), steps=4)
    assert int(state["step"]) == 4 and [r["step"] for r in trainer.history] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in trainer.history)
    assert tm.cfg.optimizer == "adamw" and set(state["opt"]) == {"m", "v", "count"}
    ref = RPipeline(corpus, tm.cfg.vocab, RConfig(seq_len=16, global_batch=4, shard_docs=100))
    assert pipe.stats().keys() == ref.stats().keys()


def test_launch_train_smoke_on_the_cpu(capsys):
    out = launch_train.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                             "--steps", "3", "--docs", "300", "--seq-len", "16",
                             "--batch", "4"])
    # log_every 10: step 1 is the one logged in 3 steps
    assert [r["step"] for r in out["history"]] == [1] and np.isfinite(out["history"][0]["loss"])
    assert '"history"' in capsys.readouterr().out


def test_launch_train_refuses_full_configs_on_the_cpu():
    with pytest.raises(SystemExit, match="CUDA"):
        launch_train.main(["--arch", "granite-8b", "--device", "cpu"])
