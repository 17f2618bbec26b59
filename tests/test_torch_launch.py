"""The port's launch layer against the reference's: the per-device
accounting (``repro_torch.launch.hlo_analysis``; the reference's six HLO
cases in eager form), collectives under DTensor on a fake mesh, the Fig. 6
pipeline cell of the dry-run, and ``hillclimb._parse_overrides``.  The
dry-run's model cells are in ``tests/test_torch_dryrun.py``.  Every world
opened here is closed by its test."""
import importlib
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS, Roofline, analyze
from repro_torch.launch.mesh import abstract_world


def _reference(name: str):
    """``repro.launch.<name>``: the reference's dry-run modules set XLA_FLAGS
    when imported (for a process of their own); the variable is put back."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


# ---- the reference's six cases (tests/test_hlo_analysis.py), eager ---------------------
def test_matmul_flops_match_flop_counter():
    m = k = n = 64
    a, b = torch.randn(m, k), torch.randn(k, n)
    s = analyze(lambda a, b: a @ b, a, b)
    with FlopCounterMode(display=False) as fc:
        a @ b
    assert s.flops == 2 * m * k * n == fc.get_total_flops()
    assert s.dot_count == 1


def test_loop_counts_every_iteration():
    def looped(x):
        for _ in range(12):
            x = (x @ x) * 0.99
        return x

    s = analyze(looped, torch.empty(128, 128, device="meta"))
    assert s.flops == 12 * 2 * 128 ** 3
    assert s.replicated_ops == 0


def test_nested_loops_multiply():
    def outer(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    s = analyze(outer, torch.empty(64, 64, device="meta"))
    assert s.flops == 15 * 2 * 64 ** 3


def test_einsum_batched_dot_flops():
    b, m, k, n = 4, 32, 64, 16
    s = analyze(lambda a, c: torch.einsum("bmk,bkn->bmn", a, c),
                torch.empty(b, m, k, device="meta"), torch.empty(b, k, n, device="meta"))
    assert s.flops == 2 * b * m * k * n


def test_roofline_terms_and_bottleneck():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12     # H100 SXM data sheet
    rl = Roofline(hlo_flops=PEAK_FLOPS, hlo_bytes=HBM_BW * 2, wire_bytes=0, chips=4,
                  model_flops=4 * PEAK_FLOPS * 0.5)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.bottleneck == "memory"
    assert rl.step_s == pytest.approx(2.0)
    assert rl.useful_flops_fraction == pytest.approx(0.5)
    assert rl.roofline_fraction == pytest.approx(0.25)


def test_fused_bytes_leq_raw_bytes():
    s = analyze(lambda a: torch.tanh(a) + torch.exp(a) * 2.0,
                torch.empty(256, 256, device="meta"))
    assert s.hbm_bytes_fused <= s.hbm_bytes
    assert s.hbm_bytes_fused == 0 < s.hbm_bytes       # elementwise only: all fused away
    assert s.peak_live_bytes >= 256 * 256 * 4


# ---- collectives under DTensor ---------------------------------------------------------
def test_megatron_pair_one_all_reduce():
    """Column- then row-parallel on a fake (1, 4) mesh: one all-reduce of
    the (16, 64) bf16 result, 2 x |out| bytes on the wire, and a quarter of
    the FLOPs a device."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import sharding as shlib
    with abstract_world(4):
        mesh = _mesh((1, 4))
        t = {"x": torch.empty(16, 64, device="meta", dtype=torch.bfloat16),
             "w1": torch.empty(64, 32, device="meta", dtype=torch.bfloat16),
             "w2": torch.empty(32, 64, device="meta", dtype=torch.bfloat16)}
        d = shlib.distribute(t, {"x": shlib.P("data", None), "w1": shlib.P(None, "model"),
                                 "w2": shlib.P("model", None)}, mesh)

        def pair(x, w1, w2):
            return ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])

        s = analyze(pair, d["x"], d["w1"], d["w2"])
    assert s.collective_counts == {"all-reduce": 1}
    assert s.wire_bytes == 2 * 16 * 64 * 2
    assert s.flops == 2 * (2 * 16 * 64 * 32) / 4


# ---- the Fig. 6 pipeline cell ---------------------------------------------------------------
def test_pipeline_cell_values_match_numpy():
    """On a real one-rank gloo mesh: the map, groupby(n), groupby(1) and
    window results equal numpy's."""
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import close_local_group, make_local_mesh
    rng = np.random.default_rng(0)
    rows, cols, groups = 64, 6, 8
    v = rng.standard_normal((rows, cols)).astype(np.float32)
    v[rng.random((rows, cols)) < 0.1] = np.nan
    c = rng.integers(0, 50, rows).astype(np.int32)
    try:
        mesh = make_local_mesh("cpu")
        d = shlib.distribute({"v": torch.from_numpy(v), "c": torch.from_numpy(c)},
                             {"v": shlib.P("data", "model"), "c": shlib.P("data")}, mesh)
        mapped, gb_n, gb_1, window = (t.full_tensor().numpy() for t in
                                      dryrun.pipeline_step(d["v"], d["c"], mesh, groups))
    finally:
        close_local_group()
    clean = np.where(np.isnan(v), 0.0, v)
    np.testing.assert_array_equal(mapped, clean)
    onehot = np.eye(groups, dtype=np.float32)[c % groups]
    np.testing.assert_allclose(gb_n, onehot.T @ clean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gb_1, clean.sum(0, keepdims=True), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(window, np.cumsum(clean, 0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pl", [Replicate(), Shard(0), Shard(1), Shard(2)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_dtensor_route_matches_plain(pl, dtype):
    """On a real one-rank gloo mesh: ``kernels.ops.rmsnorm`` on DTensors
    (the norm on each device's rows, through ``local_map``) equals the plain
    version on the whole tensors, with x's placement kept, and so do its
    gradients."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rms_norm import rmsnorm_plain
    from repro_torch.launch.mesh import close_local_group, make_local_mesh
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 6, 48)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(48)).astype(np.float32))
    try:
        mesh = make_local_mesh("cpu")
        dx = distribute_tensor(x, mesh, [pl, Replicate()]).requires_grad_(True)
        ds = distribute_tensor(scale, mesh, [Replicate(), Replicate()]).requires_grad_(True)
        out = kops.rmsnorm(dx, ds)
        assert list(out.placements) == [pl, Replicate()]
        got = out.full_tensor()
        grads = [g.full_tensor() for g in torch.autograd.grad(out.sum(), (dx, ds))]
    finally:
        close_local_group()
    xs, ss = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    want = rmsnorm_plain(xs, ss, 1e-6)
    assert torch.equal(got, want)
    assert all(torch.equal(g, w) for g, w in zip(grads, torch.autograd.grad(want.sum(), (xs, ss))))


@pytest.mark.parametrize("pl", [Replicate(), Shard(0), Shard(1), Shard(2), Shard(3)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_dtensor_route_matches_plain(pl, dtype):
    """On a real one-rank gloo mesh: ``kernels.ops.rope`` on DTensors (the
    rotation on each device's shards, through ``local_map``, the positions a
    plain tensor placed to match) equals the plain version on the whole
    tensors, with x's placement kept, and so does its gradient."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rope import rope_plain
    from repro_torch.launch.mesh import close_local_group, make_local_mesh
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 48)).astype(np.float32)).to(dtype)
    pos = torch.arange(6).expand(2, 6)
    try:
        mesh = make_local_mesh("cpu")
        dx = distribute_tensor(x, mesh, [pl, Replicate()]).requires_grad_(True)
        out = kops.rope(dx, pos)
        assert list(out.placements) == [pl, Replicate()]
        got = out.full_tensor()
        grad = torch.autograd.grad((out * out).sum(), (dx,))[0].full_tensor()
    finally:
        close_local_group()
    xs = x.clone().requires_grad_(True)
    want = rope_plain(xs, pos)
    assert torch.equal(got, want)
    assert torch.equal(grad, torch.autograd.grad((want * want).sum(), (xs,))[0])


def test_pipeline_cell_collectives_on_a_fake_mesh():
    """On a fake (2, 2) mesh: one all-reduce each for groupby(n) and
    groupby(1) and one all-gather of the shard totals, over the one DP dim;
    each all-reduce carries twice its (groups, cols / 2) or (1, cols / 2)
    shard, the all-gather 2 rows of cols / 2."""
    from repro_torch.launch import sharding as shlib
    rows, cols, groups = 64, 8, 4
    with abstract_world(4):
        mesh = _mesh((2, 2))
        d = shlib.distribute({"v": torch.empty((rows, cols), device="meta"),
                              "c": torch.empty((rows,), dtype=torch.int32, device="meta")},
                             {"v": shlib.P("data", "model"), "c": shlib.P("data")}, mesh)
        s = analyze(dryrun.pipeline_step, d["v"], d["c"], mesh, groups)
    assert s.collective_counts == {"all-reduce": 2, "all-gather": 1}
    half = cols // 2
    assert s.wire_bytes_by_kind["all-reduce"] == 2 * 4 * (groups * half + half)
    assert s.wire_bytes_by_kind["all-gather"] == 4 * 2 * half


def test_run_pipeline_cell_single_pod():
    res = dryrun.run_pipeline_cell(False, rows=1 << 12, cols=32)
    assert res["status"] == "analyzed" and res["chips"] == 256
    assert res["collectives"]["counts"] == {"all-reduce": 2, "all-gather": 1}


# ---- hillclimb ------------------------------------------------------------------------------
def test_parse_overrides_equal_the_reference():
    pairs = ["rwkv_chunked=True", "remat=False", "train_microbatches=4",
             "capacity_factor=1.5", "attn_impl=chunked", "window=0", "x=1e-3"]
    assert hillclimb._parse_overrides(pairs) == _reference("hillclimb")._parse_overrides(pairs)


# ---- the sharded model on a real four-rank world ------------------------------------------
GLOO_ARCHS = ("recurrentgemma-9b", "granite-moe-3b-a800m", "whisper-base")
GLOO_LOGIT_TOL = 0.1    # max |logit diff|: the row-parallel all-reduces and the sharded
#                         reductions sum bf16 partials in another order (readings 0.006-0.041
#                         over the ten smoke configs); a wrong shard mapping is off by O(1)


def _gloo_rank(rank: int, store_path: str, out_path: str) -> None:
    """One rank of a 2 x 2 gloo mesh on the CPU: each smoke model's forward
    and four decode steps, plain and as DTensors placed by the specs."""
    import json
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import sharding as shlib
    from repro_torch.models import build_model, transformer
    from repro_torch.models.sharding_ctx import activation_sharding
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        report = {}
        for arch in GLOO_ARCHS:
            cfg = get_smoke_config(arch)
            model = build_model(cfg, "cpu")
            params = model.init(torch.Generator().manual_seed(0))
            b, s = 4, 12
            toks = torch.randint(3, cfg.vocab, (b, s),
                                 generator=torch.Generator().manual_seed(1)).to(torch.int32)
            batch = {"tokens": toks}
            if cfg.cross_memory_len:
                batch["memory"] = torch.randn(b, cfg.cross_memory_len, cfg.d_model,
                                              generator=torch.Generator().manual_seed(2)
                                              ).to(torch.bfloat16)

            def run(p, batch, cache):
                out = [model.forward(p, batch["tokens"], batch.get("memory"))]
                mem = batch.get("memory")
                if cfg.encoder_layers:
                    with torch.no_grad():
                        mem = transformer.encode(p["encoder"], mem, cfg)
                for i in range(4):
                    logits, cache = model.decode_step(p, batch["tokens"][:, i], cache, mem)
                    out.append(logits)
                return out

            plain = run(params, batch, model.cache_init(b, 16))
            cache = model.cache_init(b, 16)
            dparams = shlib.distribute(params, shlib.param_specs(cfg, params, mesh), mesh)
            dcache = shlib.distribute(cache, shlib.cache_specs_tree(
                cfg, ShapeConfig("d", 16, b, "decode"), mesh, cache), mesh)
            dbatch = shlib.distribute(batch, shlib.batch_specs(
                cfg, ShapeConfig("p", s, b, "prefill"), mesh, batch), mesh)
            with activation_sharding(mesh, shlib.effective_dp(cfg, mesh)) as rec, \
                    implicit_replication():
                got = [t.full_tensor() for t in run(dparams, dbatch, dcache)]
            report[arch] = {"err": [float((a - g).abs().max()) for a, g in zip(plain, got)],
                            "replicated": rec.replicated}
        report["sp"] = _sp_decode(mesh)
        report["rope"] = _rope_on_shards(mesh)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


SP_ARCH = "yi-6b"
SP_STEPS = 11       # cache lengths 1 .. 11 over 16 rows: past the 4- and 8-row pieces' ends


def _sp_decode(mesh) -> dict:
    """yi-6b's smoke config decoding SP_STEPS tokens with its cache placed by
    cache_specs_tree on the 2 x 2 mesh: batch 4 (the sequence over "model",
    2 pieces of 8 rows) and batch 1 (the batch cannot be sharded: the
    sequence over ("data", "model"), 4 pieces of 4 rows); decode logits
    against the plain run, and the calls of K7's sequence-sharded route."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import sharding as shlib
    from repro_torch.models import build_model
    from repro_torch.models.sharding_ctx import activation_sharding
    cfg = get_smoke_config(SP_ARCH)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dparams = shlib.distribute(params, shlib.param_specs(cfg, params, mesh), mesh)
    calls = []
    route = kops._decode_on_sequence_shards

    def counted(*a, **kw):
        calls.append(a[4])
        return route(*a, **kw)
    kops._decode_on_sequence_shards = counted
    out = {}
    try:
        for b in (4, 1):
            toks = torch.randint(3, cfg.vocab, (b, SP_STEPS),
                                 generator=torch.Generator().manual_seed(b)).to(torch.int32)
            cache = model.cache_init(b, 16)
            plain = []
            for i in range(SP_STEPS):
                logits, cache = model.decode_step(params, toks[:, i], cache)
                plain.append(logits)
            cache = model.cache_init(b, 16)
            dcache = shlib.distribute(cache, shlib.cache_specs_tree(
                cfg, ShapeConfig("d", 16, b, "decode"), mesh, cache), mesh)
            got = []
            del calls[:]
            with activation_sharding(mesh, shlib.effective_dp(cfg, mesh)), \
                    implicit_replication():
                for i in range(SP_STEPS):
                    logits, dcache = model.decode_step(dparams, toks[:, i], dcache)
                    got.append(logits.full_tensor())
            out[str(b)] = {"err": [float((a - g).abs().max()) for a, g in zip(plain, got)],
                           "calls": len(calls), "seq_dims": sorted(set(map(tuple, calls))),
                           "layers": cfg.pattern.count("attn") * (cfg.n_layers // len(cfg.pattern))}
    finally:
        kops._decode_on_sequence_shards = route
    out["direct"] = _sp_direct(mesh)
    return out


def _sp_direct(mesh) -> dict:
    """K7 on DTensors straight: float32 caches with batch over "data" and
    sequence over "model", lengths 0 and across the 8-row pieces' ends, the
    query batch-sharded or replicated over "data"; max |diff| to the plain
    version on the whole tensors (rows of length >= 1), and whether the
    length-0 row is 0."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops as kops
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(4, 8, 16, generator=gen)
    k, v = (torch.randn(4, 16, 2, 16, generator=gen) for _ in range(2))
    n = torch.tensor([0, 3, 9, 17], dtype=torch.int32)
    want = da.decode_attention_plain(q, k, v, n)
    out = {}
    for name, qp in (("batch", [Shard(0), Shard(1)]), ("replicated", [Replicate(), Shard(1)])):
        kv = [distribute_tensor(t, mesh, [Shard(0), Shard(1)]) for t in (k, v)]
        got = kops.decode_attention(distribute_tensor(q, mesh, qp), *kv, n).full_tensor()
        out[name] = {"err": float((got[1:] - want[1:]).abs().max()), "zero": not got[0].any()}
    return out


# (x's placements, positions' kind, the output's placements): batch, sequence and
# head shards kept with the positions placed to match, a sharded head dim gathered
ROPE_PLACEMENTS = (
    ((Shard(0), Shard(1)), "arange", (Shard(0), Shard(1))),
    ((Shard(1), Shard(2)), "arange", (Shard(1), Shard(2))),
    ((Replicate(), Shard(3)), "arange", (Replicate(), Replicate())),
    ((Shard(0), Shard(2)), "ragged", (Shard(0), Shard(2))),
    ((Replicate(), Shard(2)), "sharded", (Replicate(), Shard(2))),
)


def _rope_on_shards(mesh) -> list:
    """``kernels.ops.rope`` on DTensors of ROPE_PLACEMENTS against
    ``rope_plain`` on the whole tensors: [(bit-equal, the output's placements
    as expected)] a case.  Positions: a prefill's arange(S).expand(B, S), a
    decode step's ragged (B, 1), or a (B, S) DTensor sharded over "data"."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rope import rope_plain
    gen = torch.Generator().manual_seed(4)
    out = []
    for placements, kind, want_pl in ROPE_PLACEMENTS:
        s = 1 if kind == "ragged" else 6
        x = torch.randn(4, s, 4, 8, generator=gen).to(torch.bfloat16)
        if kind == "ragged":
            pos = torch.randint(0, 100, (4,), generator=gen, dtype=torch.int32)[:, None]
        else:
            pos = torch.arange(s).expand(4, s)
        want = rope_plain(x, pos)
        if kind == "sharded":
            pos = distribute_tensor(pos.contiguous(), mesh, [Shard(0), Replicate()])
        got = kops.rope(distribute_tensor(x, mesh, list(placements)), pos)
        out.append((bool(torch.equal(got.full_tensor(), want)),
                    tuple(got.placements) == want_pl))
    return out


@pytest.fixture(scope="module")
def gloo_report(tmp_path_factory):
    """One spawn of the four gloo ranks for the tests below."""
    import json
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "report.json"
    mp.spawn(_gloo_rank, args=(str(tmp / "store"), str(out)), nprocs=4, join=True)
    return json.loads(out.read_text())


def test_sharded_models_match_plain_on_four_gloo_ranks(gloo_report):
    """The models' DTensor route with real values: recurrentgemma (K5, a
    local ring, one KV head split mid-head over "model"), granite-moe (MoE
    dispatch and combine on each device's groups) and whisper (the encoder,
    cross-attention) on a 2 x 2 mesh of four gloo processes, forward and
    decode logits against the plain run on one process."""
    report = gloo_report
    for arch in GLOO_ARCHS:
        assert max(report[arch]["err"]) <= GLOO_LOGIT_TOL, (arch, report[arch])
        assert report[arch]["replicated"] == {}, (arch, report[arch])


def test_sequence_sharded_decode_matches_plain_on_four_gloo_ranks(gloo_report):
    """Decode with the SP cache (its sequence over "model", or over
    ("data", "model") where the batch cannot be sharded): every attention
    layer of every step takes K7's partials route and the cross-device
    combine (no gather of the cache), and the logits equal the plain run's
    within GLOO_LOGIT_TOL; K7 called on DTensors straight, with the query
    batch-sharded or replicated over "data", equals its plain version."""
    for b, want_dims in (("4", [[1]]), ("1", [[0, 1]])):
        rep = gloo_report["sp"][b]
        assert max(rep["err"]) <= GLOO_LOGIT_TOL, (b, rep)
        assert rep["calls"] == SP_STEPS * rep["layers"], (b, rep)
        assert rep["seq_dims"] == want_dims, (b, rep)
    for name, rep in gloo_report["sp"]["direct"].items():
        assert rep["err"] <= 1e-5 and rep["zero"], (name, rep)


def test_rope_on_dtensors_matches_plain_on_four_gloo_ranks(gloo_report):
    """RoPE's DTensor route on the 2 x 2 mesh of four gloo processes: batch,
    sequence and head shards stay as x's are (the positions, plain, ragged or
    sharded otherwise, placed to match) and a sharded last dim is gathered;
    every output equals rope_plain on the whole tensors bit for bit."""
    assert gloo_report["rope"] == [[True, True]] * len(ROPE_PLACEMENTS)

