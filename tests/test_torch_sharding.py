"""The port's sharding policy (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``): the reference's six rule cases, and
for every config on both production meshes the whole spec trees — params,
AdamW and Adafactor state, batch and cache for every applicable (arch x
shape) — equal after the layer-layout mapping of
``convert.params_from_arrays``; then the placement on a DeviceMesh and the
activation-sharding context.  Pure metadata on duck-typed meshes, except
the placement cases, which open a fake 4-rank world and close it."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import ARCH_IDS, SHAPES, get_config as r_get_config
from repro.configs import shape_applicable
from repro.launch import sharding as r_sh
from repro.models import model as r_model
from repro.train import optimizer as r_opt
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_world
from repro_torch.models import model as t_model
from repro_torch.models import sharding_ctx
from repro_torch.train import optimizer as t_opt
from repro_torch.train.tree import leaves_with_paths


class _FakeMesh:
    """Duck-typed mesh: only .shape and .axis_names are consulted."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = _FakeMesh({"data": 16, "model": 16})
MESHES = {"single": MESH, "multi": _FakeMesh({"pod": 2, "data": 16, "model": 16})}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(port params on meta, reference params as ShapeDtypeStructs)."""
    return t_model.params_specs(get_config(arch)), r_model.params_specs(r_get_config(arch))


def _port_flat(specs, tree) -> dict:
    """path names -> spec tuple, over the leaves of ``tree``."""
    out = {}
    for path, _ in leaves_with_paths(tree):
        node = specs
        for k in path:
            node = node[k]
        out[tuple(f"#{p}" if isinstance(p, int) else str(p) for p in path)] = tuple(node)
    return out


def _ref_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, RP))[0]
    return {tuple(str(getattr(p, "key", f"#{getattr(p, 'idx', p)}")) for p in path): tuple(spec)
            for path, spec in flat}


def _layered(ref: dict, cfg) -> dict:
    """The reference's flat specs in the port's layer layout: stacked
    ``blocks`` (leading repeats dim, spec entry dropped) and ``tail`` become
    ``layers[i]`` in layer order, as ``convert.params_from_arrays`` maps
    the arrays; every other path is the same."""
    period = len(cfg.pattern)
    repeats, _ = cfg.repeats_and_tail()
    out = {}
    for path, spec in ref.items():
        if path[0] == "blocks":
            pos = int(path[1][1:])
            for r in range(repeats):
                out[("layers", f"#{r * period + pos}") + path[2:]] = spec[1:]
        elif path[0] == "tail":
            out[("layers", f"#{repeats * period + int(path[1][1:])}") + path[2:]] = spec
        else:
            out[path] = spec
    return out


def _flat_list(specs, shapes):
    flat = _port_flat(specs, shapes)
    out = []
    for path, leaf in leaves_with_paths(shapes):
        key = tuple(f"#{p}" if isinstance(p, int) else str(p) for p in path)
        out.append(("/".join(key), tuple(leaf.shape), flat[key]))
    return out


def _specs_for(arch):
    cfg = get_config(arch)
    shapes, _ = _shapes(arch)
    return cfg, shapes, shlib.param_specs(cfg, shapes, MESH)


# ---- the reference's six cases (tests/test_sharding.py) ------------------------------
def test_divisibility_everywhere():
    for arch in ("yi-6b", "qwen3-moe-235b-a22b", "whisper-base", "rwkv6-1.6b"):
        cfg, shapes, specs = _specs_for(arch)
        for name, shape, spec in _flat_list(specs, shapes):
            assert len(spec) <= len(shape), (name, shape, spec)
            for dim, entry in zip(shape, spec):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                size = 1
                for a in axes:
                    size *= MESH.shape[a]
                assert dim % size == 0, (arch, name, shape, spec)


def test_tp_pairing_dense():
    cfg, shapes, specs = _specs_for("yi-6b")
    flat = {n: (s, sp) for n, s, sp in _flat_list(specs, shapes)}
    wq = [v for k, v in flat.items() if k.endswith("attn/wq")][0]
    wo = [v for k, v in flat.items() if k.endswith("attn/wo")][0]
    assert wq[1][-1] == "model"       # column-parallel out
    assert wo[1][-2] == "model"       # row-parallel in
    assert len(wq[1]) == 2            # one dict a layer: no leading repeats entry


def test_moe_expert_parallel():
    cfg, shapes, specs = _specs_for("qwen3-moe-235b-a22b")
    flat = {n: (s, sp) for n, s, sp in _flat_list(specs, shapes)}
    wg = [v for k, v in flat.items() if k.endswith("mlp/w_gate")][0]
    assert wg[1][0] == "model"        # experts dim sharded (EP)


def test_fsdp_toggle_by_size():
    assert shlib.use_fsdp(get_config("qwen3-moe-235b-a22b"), MESH)
    assert shlib.use_fsdp(get_config("llama-3.2-vision-90b"), MESH)
    assert not shlib.use_fsdp(get_config("whisper-base"), MESH)
    assert not shlib.use_fsdp(get_config("rwkv6-1.6b"), MESH)


def test_opt_state_specs_follow_params():
    cfg = get_config("yi-6b")
    pshapes, _ = _shapes("yi-6b")
    pspecs = shlib.param_specs(cfg, pshapes, MESH)
    oshapes = t_opt.get_optimizer("adamw").init(pshapes)
    ospecs = shlib.opt_state_specs(pspecs, pshapes, oshapes, period=len(cfg.pattern))
    dm = _port_flat(ospecs["m"], oshapes["m"])
    dp = _port_flat(pspecs, pshapes)
    for n in dp:
        assert dm[n] == dp[n], n


def test_adafactor_factored_specs_drop_reduced_dim():
    cfg = get_config("gemma3-12b")   # adafactor arch
    pshapes, _ = _shapes("gemma3-12b")
    pspecs = shlib.param_specs(cfg, pshapes, MESH)
    oshapes = t_opt.get_optimizer("adafactor").init(pshapes, period=len(cfg.pattern))
    ospecs = shlib.opt_state_specs(pspecs, pshapes, oshapes, period=len(cfg.pattern))
    for name, shape, spec in _flat_list(ospecs, oshapes):
        assert len(spec) == len(shape), (name, shape, spec)


# ---- every config on both meshes against the reference --------------------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    cfg, rcfg = get_config(arch), r_get_config(arch)
    tp, rp = _shapes(arch)
    pspecs, rspecs = shlib.param_specs(cfg, tp, m), r_sh.param_specs(rcfg, rp, m)
    assert _port_flat(pspecs, tp) == _layered(_ref_flat(rspecs), cfg)

    # AdamW moments: the port's layer layout, so mapped like the params
    a_state = t_opt.get_optimizer("adamw").init(tp)
    r_astate = jax.eval_shape(r_opt.get_optimizer("adamw").init, rp)
    got = _port_flat(shlib.opt_state_specs(pspecs, tp, a_state, period=len(cfg.pattern)),
                     a_state)
    want = _ref_flat(r_sh.opt_state_specs(rspecs, rp, r_astate))
    for moment in ("m", "v"):
        sub = {k[1:]: v for k, v in want.items() if k[0] == moment}
        assert {k[1:]: v for k, v in got.items() if k[0] == moment} == _layered(sub, cfg)
    assert got[("count",)] == want[("count",)] == ()

    # Adafactor: the port keeps the reference's stacked layout, so equal as it is
    f_state = t_opt.get_optimizer("adafactor").init(tp, period=len(cfg.pattern))
    r_fstate = jax.eval_shape(r_opt.get_optimizer("adafactor").init, rp)
    assert _port_flat(shlib.opt_state_specs(pspecs, tp, f_state, period=len(cfg.pattern)),
                      f_state) == _ref_flat(r_sh.opt_state_specs(rspecs, rp, r_fstate))

    for shape in SHAPES.values():
        if not shape_applicable(cfg, shape)[0]:
            continue
        batch = t_model.input_specs(cfg, shape)
        r_batch = r_model.input_specs(rcfg, shape)
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in r_batch.items()}
        assert _port_flat(shlib.batch_specs(cfg, shape, m, batch), batch) == \
            _ref_flat(r_sh.batch_specs(rcfg, shape, m, r_batch))
        if shape.kind != "decode":
            continue
        # the local layers' ring holds min(s_max, window) slots in both
        # packages, so the cache maps like the params
        cache = t_model.cache_specs(cfg, shape.global_batch, shape.seq_len)
        r_cache = r_model.cache_specs(rcfg, shape.global_batch, shape.seq_len)
        assert _port_flat(shlib.cache_specs_tree(cfg, shape, m, cache), cache) == \
            _layered(_ref_flat(r_sh.cache_specs_tree(rcfg, shape, m, r_cache)), cfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_and_effective_dp_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    assert shlib.use_fsdp(get_config(arch), m) == r_sh.use_fsdp(r_get_config(arch), m)
    assert shlib.effective_dp(get_config(arch), m) == r_sh.effective_dp(r_get_config(arch), m)


def test_meta_specs_shapes_and_dtypes():
    """The meta trees carry the port's real shapes and dtypes, allocation-free,
    and the parameter count of the config."""
    cfg = get_config("qwen3-moe-235b-a22b")
    params, _ = _shapes("qwen3-moe-235b-a22b")
    leaves = [leaf for _, leaf in leaves_with_paths(params)]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()[0]
    assert params["layers"][0]["mlp"]["router"].dtype == torch.float32
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    cache = t_model.cache_specs(get_config("recurrentgemma-9b"), 1, SHAPES["long_500k"].seq_len)
    local = cache["layers"][2]["k"]                 # a local layer's ring
    assert local.is_meta and local.shape[1] == get_config("recurrentgemma-9b").window


# ---- placement on a DeviceMesh -----------------------------------------------------------
@pytest.fixture
def mesh22():
    from torch.distributed.device_mesh import init_device_mesh
    with abstract_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("spec,local", [
    (shlib.P(None, None), (8, 12)),
    (shlib.P("data", None), (4, 12)),
    (shlib.P(None, "model"), (8, 6)),
    (shlib.P("model", "data"), (4, 6)),
    (shlib.P(("data", "model"), None), (2, 12)),
])
def test_to_placements_local_shapes(mesh22, spec, local):
    from torch.distributed.tensor import Replicate, Shard
    pl = shlib.to_placements(spec, mesh22)
    assert len(pl) == 2 and all(isinstance(p, (Shard, Replicate)) for p in pl)
    t = shlib.distribute({"w": torch.empty((8, 12), device="meta")}, {"w": spec}, mesh22)["w"]
    assert tuple(t.shape) == (8, 12)
    assert tuple(t._local_tensor.shape) == local


def test_constrain_hidden_identity_without_context(mesh22):
    x = torch.randn(4, 3, 8)
    assert sharding_ctx.constrain_hidden(x) is x
    d = shlib.distribute({"x": torch.empty((4, 3, 8), device="meta")},
                         {"x": shlib.P(None, None, "model")}, mesh22)["x"]
    assert sharding_ctx.constrain_hidden(d) is d          # no context: untouched
    with sharding_ctx.activation_sharding(mesh22, ("data",)):
        assert sharding_ctx.constrain_hidden(x) is x      # a plain tensor: untouched


def test_constrain_hidden_pins_batch_to_dp(mesh22):
    from torch.distributed.tensor import Replicate, Shard
    d = shlib.distribute({"x": torch.empty((4, 3, 8), device="meta")},
                         {"x": shlib.P(None, None, "model")}, mesh22)["x"]
    with sharding_ctx.activation_sharding(mesh22, ("data",)):
        out = sharding_ctx.constrain_hidden(d)
        assert list(out.placements) == [Shard(0), Replicate()]
        assert tuple(out._local_tensor.shape) == (2, 3, 8)
        odd = shlib.distribute({"x": torch.empty((3, 3, 8), device="meta")},
                               {"x": shlib.P(None, None, "model")}, mesh22)["x"]
        assert sharding_ctx.constrain_hidden(odd) is odd   # B not divisible: untouched
