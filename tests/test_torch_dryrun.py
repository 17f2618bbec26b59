"""The abstract dry-run of the port (``repro_torch.launch.dryrun``) against
the reference's: every block kind (dense, MoE, RWKV, RG-LRU, encoder–decoder)
and shape kind (train, prefill, decode) at smoke size on a fake (2, 2)
mesh, reaching "analyzed" with the reference's argument bytes and model
FLOPs; and the dot FLOPs of a prefill on a (1, 1) mesh against
``analyze_hlo`` of the reference's compiled prefill.  Every world opened
here is closed by its test."""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.launch import sharding as r_sh
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import build_model as r_build
from repro.models import model as r_model
from repro.train import optimizer as r_opt
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_world


def _reference(name: str):
    """``repro.launch.<name>``: the reference's dry-run module sets XLA_FLAGS
    when imported (for a process of its own); the variable is put back."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


CELL_ARCHS = ("yi-6b", "granite-moe-3b-a800m", "rwkv6-1.6b", "recurrentgemma-9b",
              "whisper-base")
CELL_SHAPES = {"train": ShapeConfig("train_s", 8, 8, "train"),
               "prefill": ShapeConfig("prefill_s", 8, 4, "prefill"),
               "decode": ShapeConfig("decode_s", 16, 4, "decode")}


def _reference_groups(cfg, shape, mesh) -> dict:
    """The argument groups of the reference's ``_*_artifacts``, built as
    they build them (no lowering: the duck-typed mesh has no devices)."""
    params = r_model.params_specs(cfg)
    pspecs = r_sh.param_specs(cfg, params, mesh)
    batch = r_model.input_specs(cfg, shape)
    bspecs = r_sh.batch_specs(cfg, shape, mesh, batch)
    if shape.kind == "train":
        opt = jax.eval_shape(r_opt.get_optimizer(cfg.optimizer).init, params)
        state = {"params": params, "opt": opt, "step": jax.ShapeDtypeStruct((), jnp.int32)}
        specs = {"params": pspecs, "opt": r_sh.opt_state_specs(pspecs, params, opt),
                 "step": jax.sharding.PartitionSpec()}
        return {"state": (state, specs), "batch": (batch, bspecs)}
    groups = {"params": (params, pspecs), "batch": (batch, bspecs)}
    if shape.kind == "decode":
        cache = r_model.cache_specs(cfg, shape.global_batch, shape.seq_len)
        groups["cache"] = (cache, r_sh.cache_specs_tree(cfg, shape, mesh, cache))
    return groups


@pytest.mark.parametrize("kind", sorted(CELL_SHAPES))
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_dryrun_cell_analyzed(arch, kind):
    cfg, shape = get_smoke_config(arch), CELL_SHAPES[kind]
    with abstract_world(4):
        res = dryrun.analyze_cell(cfg, shape, _mesh((2, 2)))
    assert res["status"] == "analyzed"
    assert res["chips"] == 4
    ha, rl = res["hlo_analysis"], res["roofline"]
    assert ha["flops"] > 0 and ha["hbm_bytes_fused"] <= ha["hbm_bytes"]
    assert ha["collective_counts"]            # the batch is sharded: gradients / psums move
    assert res["memory_analysis"]["peak_live_bytes"] >= \
        res["memory_analysis"]["argument_size_in_bytes"] > 0
    if kind == "decode" and "attn" in cfg.pattern:
        assert ha["kernels"]["decode_attention"]["calls"] == cfg.pattern.count("attn") * (
            cfg.n_layers // len(cfg.pattern))
    if arch == "recurrentgemma-9b" and kind != "decode":
        assert ha["kernels"]["linear_scan"]["calls"] > 0

    r_dry = _reference("dryrun")
    rcfg = r_smoke(arch)
    assert rl["model_flops_global"] == r_dry._model_flops(rcfg, shape)
    want = r_dry._sharded_arg_bytes(_reference_groups(rcfg, shape, _FakeMesh(
        {"data": 2, "model": 2})), _FakeMesh({"data": 2, "model": 2}))
    assert res["arg_bytes_per_device"] == want


def test_prefill_dot_flops_match_the_reference_hlo():
    """yi-6b's smoke config with attn_impl "xla" on a (1, 1) mesh: the
    prefill's dot FLOPs against ``analyze_hlo`` of the reference's compiled
    prefill on one CPU device.  The reference's prefill unembeds every
    position and slices the last; the port's unembeds only the last (its
    (B, S, V) float32 logits are never made), so the S - 1 positions' 2·d·V
    FLOPs each are added to the port's count."""
    b, s = 2, 16
    rcfg = dataclasses.replace(r_smoke("yi-6b"), attn_impl="xla")
    rm = r_build(rcfg)
    rparams = jax.eval_shape(lambda: rm.init(jax.random.PRNGKey(0)))
    hlo = jax.jit(rm.prefill).lower(rparams, jax.ShapeDtypeStruct((b, s), jnp.int32))
    want = analyze_hlo(hlo.compile().as_text()).flops
    cfg = dataclasses.replace(get_smoke_config("yi-6b"), attn_impl="xla")
    with abstract_world(1):
        res = dryrun.analyze_cell(cfg, ShapeConfig("p", s, b, "prefill"), _mesh((1, 1)))
    got = res["hlo_analysis"]["flops"] + 2 * b * (s - 1) * cfg.d_model * cfg.vocab
    assert got == pytest.approx(want, rel=1e-2)
    assert res["hlo_analysis"]["kernels"] == {}      # "xla": no K6




def _cache_row_gathers(collectives: list, kvh: int, head_dim: int) -> float:
    """All-gather wire bytes whose result is cache rows, (B, rows > 1, KVH,
    Dh), from the accounting's ``collective_bytes_by_shape``."""
    return sum(c["bytes"] for c in collectives if c["kind"] == "all-gather" and any(
        len(x) == 4 and x[1] > 1 and x[2:] == [kvh, head_dim] for x in c["shapes"]))


def _decode_all_gathers(cfg, batch: int, monkeypatch, today: bool) -> tuple[float, float]:
    """(all-gather wire bytes of cache rows, all-gather wire bytes in all) a
    device in one decode step of ``cfg`` at ``batch`` x 16 cache rows on the
    fake (2, 2) mesh; ``today``: K7 with the sequence-sharded cache gathered
    (the route before the cross-device combine)."""
    from repro_torch.kernels import ops as kops
    with monkeypatch.context() as m:
        if today:
            m.setattr(kops, "_sequence_dims", lambda *a: [])
        with abstract_world(4):
            res = dryrun.analyze_cell(cfg, ShapeConfig("decode_s", 16, batch, "decode"),
                                      _mesh((2, 2)))
    assert res["status"] == "analyzed"
    ha = res["hlo_analysis"]
    return (_cache_row_gathers(ha["collective_bytes_by_shape"], cfg.n_kv, cfg.head_dim_),
            ha["wire_bytes_by_kind"]["all-gather"])


@pytest.mark.parametrize("batch", [4, 1])
def test_decode_cell_gathers_no_cache_rows(batch, monkeypatch):
    """yi-6b's decode cell at smoke size on the fake (2, 2) mesh, its cache's
    sequence sharded over "model" (batch 4) or over ("data", "model")
    (batch 1, which cannot be sharded): K7 runs on each device's rows and
    combines the partials across devices, so no all-gather moves cache rows
    and the step's all-gather bytes fall; K7's route before the combine
    gathered them in every layer."""
    cfg = get_smoke_config("yi-6b")
    rows, total = _decode_all_gathers(cfg, batch, monkeypatch, today=False)
    rows_today, total_today = _decode_all_gathers(cfg, batch, monkeypatch, today=True)
    assert rows_today > 0
    assert rows == 0, rows
    assert total < total_today, (total, total_today)


@pytest.mark.parametrize("q_data", ["Shard(0)", "Replicate()"])
def test_decode_attention_on_sequence_shards_moves_no_cache_rows(q_data):
    """K7 on DTensors on the fake (2, 2) mesh, the cache's batch over
    "data" and its sequence over "model", the query's batch sharded as the
    cache's or replicated over "data" (as a step's projection may leave
    it): the accounting shows no all-gather of cache rows, only the query's
    and the partials' (and the output's, for a replicated query)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.hlo_analysis import analyze
    b, s, h, kvh, d = 4, 16, 8, 2, 16
    with abstract_world(4):
        mesh = _mesh((2, 2))

        def meta(shape, placements):
            local = [n // 2 if any(p == Shard(i) for p in placements) else n
                     for i, n in enumerate(shape)]
            return DTensor.from_local(torch.empty(local, dtype=torch.bfloat16, device="meta"),
                                      mesh, placements, run_check=False, shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride())
        q = meta((b, h, d), [eval(q_data), Shard(1)])
        k, v = (meta((b, s, kvh, d), [Shard(0), Shard(1)]) for _ in range(2))
        n = torch.full((b,), s, dtype=torch.int32, device="meta")
        stats = analyze(lambda: kops.decode_attention(q, k, v, n))
    out = stats.output
    assert tuple(out.shape) == (b, h, d) and list(out.placements) == list(q.placements)
    collectives = stats.to_dict()["collective_bytes_by_shape"]
    assert any(c["kind"] == "all-gather" for c in collectives)
    assert _cache_row_gathers(collectives, kvh, d) == 0, collectives
    assert stats.kernels["decode_attention"]["calls"] == 1
