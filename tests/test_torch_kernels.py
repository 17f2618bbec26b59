"""Kernel layer of the PyTorch port against the JAX package.

The plain PyTorch versions (what a CPU tensor runs) are held against
``repro.kernels.ref`` over the shape sweep of ``tests/test_kernels.py`` and
against the Pallas kernels in interpret mode; ``segment_reduce_multi`` is
held against its reference.  Tolerances: transpose, one-hot and counts are
bit-equal; float reductions and cumsum / cumprod use rtol=atol=1e-4 as
tests/test_kernels.py does; cummax / cummin are bit-equal.  min/max are
compared on non-empty segments only: on a segment no row reaches, the Pallas
kernel gives ±FLT_MAX where the plain versions give ±inf.  For the same
reason no scanned column starts with ±inf (the Pallas scan starts its carry
at ±FLT_MAX, the plain version at ±inf).

The CUDA kernels themselves run only on a card: their tests are in
``tests/test_torch_cuda_kernels.py``, which imports no JAX so that the card's
machine can run it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.onehot_encode import onehot_encode as pallas_onehot
from repro.kernels.segment_reduce import segment_reduce as pallas_segred
from repro.kernels.block_transpose import block_transpose as pallas_transpose
from repro.kernels.window_scan import window_scan as pallas_winscan
from repro_torch.kernels import block_transpose as bt_mod
from repro_torch.kernels import onehot_encode as oh_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import window_scan as ws_mod

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nonempty(codes: np.ndarray, g: int) -> np.ndarray:
    return np.bincount(codes[codes >= 0], minlength=g)[:g] > 0


# ---- plain versions vs repro.kernels.ref ------------------------------------
@pytest.mark.parametrize("shape", [(8, 128), (100, 37), (257, 129), (5, 1000), (1, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_transpose_plain_matches_ref(rng, shape, dtype):
    x = (rng.standard_normal(shape) * 10).astype(dtype)
    np.testing.assert_array_equal(tref.transpose(_t(x)).numpy(),
                                  np.asarray(rref.transpose(jnp.asarray(x))))


@pytest.mark.parametrize("m,g", [(64, 4), (1000, 7), (5000, 129), (17, 1)])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
def test_segment_reduce_plain_matches_ref(rng, m, g, op):
    v = rng.standard_normal(m).astype(np.float32)
    c = rng.integers(-1, g, m).astype(np.int32)
    out = tref.segment_reduce(_t(v), _t(c), g, op).numpy()
    exp = np.asarray(rref.segment_reduce(jnp.asarray(v), jnp.asarray(c), g, op))
    if op in ("min", "max"):
        keep = _nonempty(c, g)
        out, exp = out[keep], exp[keep]
    if op == "count":
        np.testing.assert_array_equal(out, exp)
    else:
        np.testing.assert_allclose(out, exp, **TOL)


@pytest.mark.parametrize("cols", [1, 3, 7])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_plain_multicolumn(rng, cols, op):
    m, g = 777, 13
    v = rng.standard_normal((m, cols)).astype(np.float32)
    c = rng.integers(0, g, m).astype(np.int32)
    np.testing.assert_allclose(
        tref.segment_reduce(_t(v), _t(c), g, op).numpy(),
        np.asarray(rref.segment_reduce(jnp.asarray(v), jnp.asarray(c), g, op)), **TOL)


@pytest.mark.parametrize("m,g", [(32, 4), (500, 13), (1000, 300)])
def test_onehot_plain_matches_ref(rng, m, g):
    c = rng.integers(-1, g, m).astype(np.int32)
    np.testing.assert_array_equal(tref.onehot_encode(_t(c), g).numpy(),
                                  np.asarray(rref.onehot_encode(jnp.asarray(c), g)))


def test_segment_reduce_plain_nan_and_empty_segments():
    v = np.array([1.0, np.nan, 3.0, -2.0, 5.0], np.float32)
    c = np.array([0, 0, 1, 1, -1], np.int32)
    g = 4
    mn = tref.segment_reduce(_t(v), _t(c), g, "min").numpy()
    mx = tref.segment_reduce(_t(v), _t(c), g, "max").numpy()
    assert np.isnan(mn[0]) and np.isnan(mx[0])          # NaN propagates
    assert mn[1] == -2.0 and mx[1] == 3.0
    assert np.all(mn[2:] == np.inf) and np.all(mx[2:] == -np.inf)
    np.testing.assert_array_equal(tref.segment_reduce(_t(v), _t(c), g, "count").numpy(),
                                  [2, 2, 0, 0])
    ref_min = np.asarray(rref.segment_reduce(jnp.asarray(v), jnp.asarray(c), g, "min"))
    assert np.isnan(ref_min[0]) and ref_min[1] == -2.0


SCAN_OPS = ["cumsum", "cummax", "cummin"]


def _scan_input(rng, m, n):
    """Normal values with NaN, -0.0 and ±inf inside, never in row 0."""
    x = rng.standard_normal((m, n)).astype(np.float32)
    x[3::37, 0] = np.nan
    x[5::11, -1] = -0.0
    x[7::53, n // 2] = np.inf
    x[9::71, n // 2] = -np.inf
    return x


def _scan_match(op, got, exp):
    if op in ("cumsum", "cumprod"):
        np.testing.assert_allclose(got, exp, equal_nan=True, **TOL)
    else:
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("m,n", [(64, 1), (1000, 5), (2049, 3), (1, 1), (4097, 2),
                                 (33, 130)])
@pytest.mark.parametrize("op", SCAN_OPS)
def test_window_scan_plain_matches_ref(rng, m, n, op):
    x = _scan_input(rng, m, n)
    _scan_match(op, tops.window_scan(_t(x), op).numpy(),
                np.asarray(rops.window_scan(jnp.asarray(x), op)))
    _scan_match(op, tref.window_scan(_t(x), op).numpy(),
                np.asarray(rref.window_scan(jnp.asarray(x), op)))


def test_window_scan_plain_cumprod_matches_jnp(rng):
    """cumprod is jnp.cumprod in the reference engine; the port runs it
    through the same scan."""
    x = (1.0 + 0.01 * rng.standard_normal((3000, 3))).astype(np.float32)
    x[100, 1] = np.nan
    _scan_match("cumprod", tops.window_scan(_t(x), "cumprod").numpy(),
                np.asarray(jnp.cumprod(jnp.asarray(x), axis=0)))


def test_window_scan_reads_strided_columns(rng):
    x = rng.standard_normal((1000, 8)).astype(np.float32)
    t = _t(x)
    for op in SCAN_OPS + ["cumprod"]:
        assert torch.equal(ws_mod.window_scan(t[:, 3], op),
                           ws_mod.window_scan(t[:, 3].contiguous(), op))
        assert torch.equal(ws_mod.window_scan(t[:, 2:5], op),
                           ws_mod.window_scan(t[:, 2:5].contiguous(), op))


@pytest.mark.parametrize("m,n,chunks", [
    (1, 1, 1), (4095, 1, 1), (4096, 1, 1), (4097, 1, 2), (2_000_000, 1, 489),
    (2 ** 31 + 1, 1, 524289), (16_000_000, 1, 3907), (513, 3, 2), (16_777_259, 130, 32769)])
def test_window_scan_chunk_plan(m, n, chunks):
    """A work item is 4096 elements: 4096 rows of the column when N == 1,
    512 rows of a group of 8 columns otherwise."""
    rows = ws_mod.CHUNK_ROWS if n == 1 else ws_mod.CHUNK_ROWS // ws_mod.GROUP
    assert ws_mod.chunks(m, n) == chunks
    assert (chunks - 1) * rows < m <= chunks * rows


@pytest.mark.parametrize("m", [2_000_000, 3_000_000, 16_000_000])
def test_window_scan_association_order_keeps_sum_rtol(rng, m):
    """The kernel's fixed order, emulated in float32 on the CPU: within
    1e-5 * sum|v| (chip_smoke.py's SUM_RTOL) of a float64 prefix sum at
    every row, and the same bits on a second run.  Past 2,097,152 rows a
    thread's run of chunk totals is longer than one."""
    x = _t(rng.standard_normal(m).astype(np.float32))
    got = ws_mod.emulated_cumsum(x)
    assert torch.equal(got.view(torch.int32), ws_mod.emulated_cumsum(x).view(torch.int32))
    exact = torch.cumsum(x.double(), 0)
    ratio = float(((got.double() - exact).abs() / (1e-5 * torch.cumsum(x.double().abs(), 0))).max())
    print(f"emulated K4 cumsum at ({m},): {ratio:.4g} of the tolerance")
    assert ratio <= 1.0


@pytest.mark.parametrize("g", [1, 3, 4, 5, 7, 1000])
@pytest.mark.parametrize("rows", ["1", "3", "ragged, past 3 spans"])
def test_onehot_span_plan_covers_every_element_once(rows, g):
    """K3's split of the flat M * G output into 8192-element spans and
    float4 vectors, in the kernel's integer steps: every element stored
    once, at its own row and column, reading a staged code of its span.
    M is not a multiple of 4 past one span."""
    m = int(rows) if rows.isdigit() else 3 * oh_mod.SPAN // g + 3
    seen = np.zeros(m * g, dtype=np.int64)
    for e, row, col, slot, rows in oh_mod.span_plan(m, g):
        assert (row, col) == divmod(e, g) and 0 <= slot < rows <= oh_mod.SPAN + 4
        seen[e] += 1
    assert (seen == 1).all()


# ---- plain versions vs the Pallas kernels (interpret mode) ------------------
@pytest.mark.parametrize("m,n", [(64, 1), (1000, 5), (2049, 3)])
@pytest.mark.parametrize("op", SCAN_OPS)
def test_window_scan_plain_matches_pallas(rng, m, n, op):
    x = _scan_input(rng, m, n)
    _scan_match(op, tref.window_scan(_t(x), op).numpy(),
                np.asarray(pallas_winscan(jnp.asarray(x), op)))

# ---- plain versions vs the Pallas kernels (interpret mode) ------------------
@pytest.mark.parametrize("shape", [(100, 37), (9, 300)])
def test_transpose_plain_matches_pallas(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(tref.transpose(_t(x)).numpy(),
                                  np.asarray(pallas_transpose(jnp.asarray(x))))


@pytest.mark.parametrize("m,g,cols", [(700, 6, 1), (300, 129, 3)])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
def test_segment_reduce_plain_matches_pallas(rng, m, g, cols, op):
    v = rng.standard_normal((m, cols)).astype(np.float32)
    c = rng.integers(-1, g, m).astype(np.int32)
    out = tref.segment_reduce(_t(v), _t(c), g, op).numpy()
    exp = np.asarray(pallas_segred(jnp.asarray(v), jnp.asarray(c), g, op))
    if op in ("min", "max"):
        keep = _nonempty(c, g)
        out, exp = out[keep], exp[keep]
    np.testing.assert_allclose(out, exp, **TOL)


@pytest.mark.parametrize("m,g", [(50, 3), (600, 130)])
def test_onehot_plain_matches_pallas(rng, m, g):
    c = rng.integers(-1, g + 2, m).astype(np.int32)   # includes codes ≥ G
    np.testing.assert_array_equal(tref.onehot_encode(_t(c), g).numpy(),
                                  np.asarray(pallas_onehot(jnp.asarray(c), g)))


# ---- segment_reduce_multi -----------------------------------------------------
@pytest.mark.parametrize("presence", [False, True])
def test_segment_reduce_multi_matches_reference(rng, presence):
    m, g = 900, 7
    a = rng.standard_normal(m).astype(np.float32)
    b = rng.integers(-50, 50, m).astype(np.int32)
    va = rng.random(m) > 0.1
    codes = rng.integers(-1, g, m).astype(np.int32)
    vals = [a, a, a, b, a, b, b]
    valids = [va, va, va, None, va, None, None]
    bases = ["count", "sum", "sumsq", "sum", "min", "max", "count"]
    got = tops.segment_reduce_multi([_t(x) for x in vals],
                                    [None if x is None else _t(x) for x in valids],
                                    _t(codes), bases=bases, num_segments=g,
                                    presence=presence)
    exp = rops.segment_reduce_multi([jnp.asarray(x) for x in vals],
                                    [None if x is None else jnp.asarray(x) for x in valids],
                                    jnp.asarray(codes), bases=bases, num_segments=g,
                                    presence=presence)
    assert len(got) == len(exp) == len(bases) + presence
    keep = _nonempty(codes, g)
    for base, x, y in zip(bases + ["presence"], got, exp):
        x, y = x.numpy(), np.asarray(y)
        if base in ("min", "max"):
            x, y = x[keep], y[keep]
        if base in ("count", "presence"):
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, **TOL)


# ---- dispatch -----------------------------------------------------------------
def test_cpu_tensors_take_the_plain_path(rng):
    for mod in (sr_mod, bt_mod, oh_mod, ws_mod):
        mod.counter.reset()
    x = _t(rng.standard_normal((33, 5)).astype(np.float32))
    c = _t(rng.integers(0, 4, 33).astype(np.int32))
    torch.testing.assert_close(tops.transpose(x), x.t().contiguous(), rtol=0, atol=0)
    tops.segment_reduce(x, c, 4, "sum")
    tops.onehot_encode(c, 4)
    tops.window_scan(x, "cumsum")
    tops.transpose(x > 0)          # bool widens to int32 and narrows back
    assert tops.transpose(x > 0).dtype == torch.bool
    for mod in (sr_mod, bt_mod, oh_mod, ws_mod):
        assert mod.counter.launches == 0


def test_mixed_devices_raise():
    x = torch.zeros(4, dtype=torch.float32)
    c = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA"):
        sr_mod.segment_reduce(x, c, 2)
    with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA"):
        ws_mod.window_scan(torch.zeros(4, device="meta"))


# ---- the wrapper's launch plans -----------------------------------------------
def _reg_fits(c: int, g: int) -> bool:
    """The "reg" kernel's templates: G padded to 8, 16, 32 or 64 times C
    padded to 1, 2, 4 or 8, at most 64 accumulators a thread."""
    gp = next(p for p in (8, 16, 32, 64, 1 << 30) if g <= p)
    cp = next(p for p in (1, 2, 4, 8, 1 << 30) if c <= p)
    return gp * cp <= 64


@pytest.mark.parametrize("g", [1, 6, 4096, 65535, 65536])
@pytest.mark.parametrize("cols", [1, 8, 1536, 2000])
def test_segment_reduce_slabs_fit_one_launch_each(g, cols):
    """Every (C, G) takes one route, by shape alone.  Route "reg" is one
    launch whose accumulators fit its templates, over a plan that covers
    every row; route "table" splits wide values into column slabs, and every
    slab's launch keeps its warp tables in 48 KB of shared memory and its
    g-tiles within grid.y (65,535).  The table plan holds for every shape."""
    m = 1_000_000
    route = sr_mod.route(cols, g)
    assert route == ("reg" if _reg_fits(cols, g) else "table")
    if route == "reg":
        ctas, per = sr_mod.reg_plan(m)
        assert 1 <= ctas <= sr_mod.REG_CTAS and ctas * per >= m and per % 32 == 0
    width = sr_mod.slab_width(g)
    slabs = [(lo, min(width, cols - lo)) for lo in range(0, cols, width)]
    assert sum(w for _, w in slabs) == cols
    for _, w in slabs:
        chunks, rows, tile_g = sr_mod.plan(m, w, g)
        assert 1 <= tile_g <= g and 8 * tile_g * w * 4 <= 48 * 1024
        assert -(-g // tile_g) <= 65535 and chunks * rows >= m


@pytest.mark.parametrize("c,g,route", [
    (8, 6, "reg"), (8, 8, "reg"), (8, 9, "table"), (1, 64, "reg"), (1, 65, "table"),
    (3, 16, "reg"), (3, 17, "table"), (4, 16, "reg"), (9, 1, "table"), (2000, 6, "table"),
    (1600, 65536, "table"), (1, 65536, "table"), (5, 8, "reg"), (2, 32, "reg"),
    (3, 32, "table"), (7, 1, "reg")])
def test_segment_reduce_route(c, g, route):
    """"reg" where G padded to a power of two >= 8, times C padded to 1, 2, 4
    or 8, is at most 64 accumulators; "table" elsewhere (the wide slabs and
    G 65,536 among them).  The op does not enter."""
    assert sr_mod.route(c, g) == route == ("reg" if _reg_fits(c, g) else "table")


@pytest.mark.parametrize("m", [0, 1, 4, 5, 1000, 4097, 70_001, 1_048_577, 2_000_000, 16_000_000])
def test_segment_reduce_reg_plan_covers_every_row_once(m):
    """The "reg" plan, a function of M alone: at most REG_CTAS CTAs whose
    row runs [b * per, (b + 1) * per) tile [0, M); inside a run, the rows a
    lane reads, lo + 512 U k + 32 U w + 32 u + l, are every row of the run
    once, for each U the kernel takes."""
    ctas, per = sr_mod.reg_plan(m)
    assert 1 <= ctas <= sr_mod.REG_CTAS and per % 32 == 0
    assert ctas * per >= m and (ctas - 1) * per < max(m, 1)
    for c, op in ((1, "sum"), (2, "sum"), (4, "sum"), (8, "sum"), (8, "count")):
        u = sr_mod.reg_rows(c, op)
        steps = -(-per // (sr_mod.REG_THREADS * u))
        k, w, uu, lane = np.meshgrid(np.arange(steps), np.arange(sr_mod.REG_WARPS),
                                     np.arange(u), np.arange(32), indexing="ij")
        offs = (k * sr_mod.REG_THREADS * u + w * 32 * u + uu * 32 + lane).ravel()
        assert np.array_equal(np.sort(offs), np.arange(steps * sr_mod.REG_THREADS * u))
        assert steps * sr_mod.REG_THREADS * u >= per


# (M, G, C) on route reg: ragged M (past one CTA, past one step, under a
# warp), C 1 to 8 (3 and 5 through the scalar loads), G 1 to 64
_K1_SHAPES = [(1000, 6, 8), (70_001, 6, 8), (4097, 1, 1), (12_345, 6, 1), (5000, 64, 1),
              (3001, 16, 3), (5, 3, 2), (0, 4, 1), (1, 6, 8), (4097, 6, 8), (9999, 7, 5)]


@pytest.mark.parametrize("m,g,c", _K1_SHAPES)
def test_segment_reduce_emulated_sum_matches_plain_and_ref(rng, m, g, c):
    """The "reg" route's stated order in float32 on the CPU: within
    1e-5 * sum|v| (chip_smoke.py's SUM_RTOL) of the plain version's float64
    sum, within the kernel tests' TOL of repro.kernels.ref, NaN where a
    segment has one, and the same bits twice."""
    v = rng.standard_normal((m, c)).astype(np.float32)
    codes = rng.integers(-1, g, m).astype(np.int32)
    if m > 10:
        v[::97, 0] = np.nan
    got = sr_mod.emulated_sum(_t(v), _t(codes), g)
    assert torch.equal(got.view(torch.int32), sr_mod.emulated_sum(_t(v), _t(codes), g).view(torch.int32))
    plain = sr_mod.segment_reduce_plain(_t(v), _t(codes), g, "sum")
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    keep = codes >= 0
    absv = np.zeros((g, c))
    np.add.at(absv, codes[keep], np.nan_to_num(np.abs(v[keep].astype(np.float64))))
    err = np.abs(np.nan_to_num(got.numpy()) - np.nan_to_num(plain.numpy()))
    assert (err <= 1e-5 * absv).all()
    exp = np.asarray(rref.segment_reduce(jnp.asarray(v), jnp.asarray(codes), g, "sum"))
    np.testing.assert_allclose(got.numpy(), exp, equal_nan=True, **TOL)


def test_segment_reduce_emulated_sum_at_the_fig6_block(rng):
    """One Fig. 6 GROUPBY block, 2,000,000 x 8 at G 6: the stated order
    stays within 1e-5 * sum|v| of a float64 sum; a (M,) call is the C = 1
    case."""
    m, g, c = 2_000_000, 6, 8
    v = rng.random((m, c), dtype=np.float32)
    codes = rng.integers(0, g, m).astype(np.int32)
    got = sr_mod.emulated_sum(_t(v), _t(codes), g).double()
    exact = torch.zeros((g, c), dtype=torch.float64).index_add_(0, _t(codes).long(), _t(v).double())
    ratio = float(((got - exact).abs() / (1e-5 * exact)).max())
    print(f"emulated K1 sum at ({m} x {c}, G {g}): {ratio:.4g} of the tolerance")
    assert ratio <= 1.0
    one = sr_mod.emulated_sum(_t(v[:, 0]), _t(codes), g)
    assert one.shape == (g,) and torch.equal(one, sr_mod.emulated_sum(_t(v[:, :1]), _t(codes), g)[:, 0])
    with pytest.raises(ValueError, match="route table"):
        sr_mod.emulated_sum(_t(v[:10]), _t(codes[:10]), 65)


# ---- decode_attention (K7) ----------------------------------------------------
# f32 at rtol = atol = 2e-3, the tolerance of tests/test_kernels.py's
# test_decode_attention; the reference's four shapes (H, KVH, S, length, D)
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402

DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
DECODE_SHAPES = [(8, 2, 256, 100, 64), (16, 4, 333, 217, 64), (4, 4, 128, 128, 128),
                 (8, 1, 700, 1, 64)]


def _decode_inputs(rng, b, h, kvh, s, d):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("h,kvh,s,length,d", DECODE_SHAPES)
def test_decode_attention_plain_matches_ref(rng, h, kvh, s, length, d):
    q, k, v = (a[0] for a in _decode_inputs(rng, 1, h, kvh, s, d))
    exp = np.asarray(rref.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length))
    np.testing.assert_allclose(tref.decode_attention(_t(q), _t(k), _t(v), length).numpy(),
                               exp, **DECODE_TOL)
    np.testing.assert_allclose(tops.decode_attention(_t(q), _t(k), _t(v), length).numpy(),
                               exp, **DECODE_TOL)


@pytest.mark.parametrize("h,kvh,s,length,d", DECODE_SHAPES)
def test_decode_attention_plain_matches_pallas(rng, use_pallas_kernels, h, kvh, s, length, d):
    """The Pallas kernel in interpret mode, reached through the reference's
    ops dispatch as on the TPU."""
    q, k, v = (a[0] for a in _decode_inputs(rng, 1, h, kvh, s, d))
    assert rops.use_pallas()
    exp = np.asarray(rops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length))
    np.testing.assert_allclose(tref.decode_attention(_t(q), _t(k), _t(v), length).numpy(),
                               exp, **DECODE_TOL)


def test_decode_attention_plain_batched_lengths(rng):
    """Per-slot lengths 1, S, S + 5 (all S slots valid, as the reference's
    mask makes it) and one in between, in one batched call, against the
    reference slot by slot and against the Pallas kernel (S a multiple of
    its 128-row tile: see the next test)."""
    b, h, kvh, s, d = 4, 8, 2, 128, 64
    q, k, v = _decode_inputs(rng, b, h, kvh, s, d)
    lengths = np.array([1, s, s + 5, 37], np.int32)
    out = tref.decode_attention(_t(q), _t(k), _t(v), _t(lengths)).numpy()
    assert out.shape == (b, h, d) and out.dtype == np.float32
    for i, n in enumerate(lengths):
        args = (jnp.asarray(q[i]), jnp.asarray(k[i]), jnp.asarray(v[i]), int(n))
        np.testing.assert_allclose(out[i], np.asarray(rref.decode_attention(*args)), **DECODE_TOL)
        np.testing.assert_allclose(out[i], np.asarray(pallas_decode(*args)), **DECODE_TOL)
    # a length past S equals a length of S exactly
    np.testing.assert_array_equal(out[2], tref.decode_attention(_t(q[2]), _t(k[2]), _t(v[2]), s).numpy())


def test_decode_attention_length_past_unaligned_s_follows_ref(rng):
    """A length past S counts S slots, as ref.decode_attention does.  The
    Pallas kernel pads S up to its tile with zero rows and, given a length
    past S, counts the padding too (ROADMAP, known divergences); the port
    follows ref."""
    s = 96
    q, k, v = (a[0] for a in _decode_inputs(rng, 1, 8, 2, s, 64))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s + 5)
    got = tref.decode_attention(_t(q), _t(k), _t(v), s + 5).numpy()
    np.testing.assert_allclose(got, np.asarray(rref.decode_attention(*args)), **DECODE_TOL)
    assert np.abs(got - np.asarray(pallas_decode(*args))).max() > DECODE_TOL["atol"]


SPLIT_S = 40          # the cache cut into pieces of unequal rows
SPLIT_LENGTHS = [0, 1, 5, 6, 13, 17, 23, 34, 39, 40, 41]   # 0, piece ends +- 1, S, S + 1


@pytest.mark.parametrize("pieces", [1, 2, 3, 7])
def test_decode_attention_partials_combine_matches_whole_cache(rng, pieces):
    """K7's partials mode (plain) on each piece of a cache cut into 1, 2, 3
    and 7 pieces of unequal rows, each with the lengths cut to its rows, and
    the combine in piece order: equal to ref.decode_attention over the whole
    cache in float32 (1e-5) and to the port's whole-cache plain version at
    every length >= 1; length 0 gives 0 (the kernel's value, ROADMAP known
    divergences), and every piece with no valid row gives M -inf, L 0, O 0."""
    h, kvh, d = 8, 2, 32
    b = len(SPLIT_LENGTHS)
    q, k, v = _decode_inputs(rng, b, h, kvh, SPLIT_S, d)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32)
    cuts = [0] + sorted(rng.choice(np.arange(1, SPLIT_S), pieces - 1, replace=False).tolist()) \
        + [SPLIT_S]
    parts = []
    for a, c in zip(cuts, cuts[1:]):
        n = da_mod.piece_lengths(lengths, a, c - a)
        assert torch.equal(n, torch.clamp(lengths - a, 0, c - a).to(torch.int32))
        o, m, l = da_mod.decode_attention_partials(_t(q), _t(k[:, a:c]), _t(v[:, a:c]), n)
        assert o.dtype == m.dtype == l.dtype == torch.float32 and o.shape == (b, h, d)
        empty = n == 0
        assert torch.isneginf(m[empty]).all() and not l[empty].any() and not o[empty].any()
        assert torch.isfinite(m[~empty]).all() and (l[~empty] >= 1).all()
        parts.append((o, m, l))
    got = da_mod.combine_partials(parts, torch.float32)
    assert got.dtype == torch.float32 and not got[0].any()
    whole = tref.decode_attention(_t(q), _t(k), _t(v), lengths)
    np.testing.assert_allclose(got[1:].numpy(), whole[1:].numpy(), rtol=1e-5, atol=1e-5)
    for i, n in enumerate(SPLIT_LENGTHS[1:], start=1):
        exp = rref.decode_attention(jnp.asarray(q[i]), jnp.asarray(k[i]), jnp.asarray(v[i]), n)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)


def test_decode_attention_partials_combine_bf16_and_scale(rng):
    """bf16 operands and a given scale: the combine rounds once to bf16,
    within one bf16 rounding of the whole-cache plain version."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _decode_inputs(rng, 3, 8, 4, 64, 32))
    lengths = torch.tensor([1, 30, 64], dtype=torch.int32)
    parts = [da_mod.decode_attention_partials(q, k[:, a:a + 16], v[:, a:a + 16],
                                              da_mod.piece_lengths(lengths, a, 16), scale=0.3)
             for a in range(0, 64, 16)]
    got = da_mod.combine_partials(parts, torch.bfloat16)
    want = tref.decode_attention(q, k, v, lengths, scale=0.3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2 ** -7, atol=1e-5)


def _fmaf(x, y, z) -> np.float32:
    """fmaf: x * y + z over the rationals, rounded once to float32 (to
    nearest, ties to even)."""
    from fractions import Fraction
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    near = np.float32(float(exact))      # within one float32 step of the answer
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.array(c).view(np.int32)) & 1))


def _bits32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def test_fma32_rounds_once_as_fmaf(rng):
    """The combine's fold step equals fmaf bit for bit: on random products
    and accumulators of mixed signs and scales, and where rounding the
    float64 sum to float32 would round twice (1 + 2^-24 + 2^-60: float64
    drops 2^-60 and leaves a float32 tie that goes to 1, where fmaf gives
    1 + 2^-23)."""
    x = (rng.standard_normal(4000) * np.exp2(rng.integers(-30, 30, 4000))).astype(np.float32)
    y = rng.random(4000).astype(np.float32)
    z = (rng.standard_normal(4000) * np.exp2(rng.integers(-30, 30, 4000))).astype(np.float32)
    x[:3] = [np.float32(4097 * 2.0 ** -36), -np.float32(4097 * 2.0 ** -36), 5.0]
    y[:3] = [np.float32((2 ** 24 - 2 ** 12 + 1) * 2.0 ** -24)] * 2 + [0.0]
    z[:3] = [1.0, -1.0, 0.0]
    got = da_mod._fma32(_t(x).double() * _t(y).double(), _t(z).double()).numpy()
    want = np.array([_fmaf(*t) for t in zip(x, y, z)], dtype=np.float32)
    assert got[0] == np.float32(1 + 2.0 ** -23) and got[1] == -got[0]
    assert np.float32(float(np.float64(x[0]) * np.float64(y[0]) + 1.0)) == 1.0
    np.testing.assert_array_equal(_bits32(got), _bits32(want))


def test_decode_attention_partials_combine_folds_as_fmaf(rng):
    """combine_partials over 5 pieces equals, bit for bit, the tc kernel's
    fold written out element by element with fmaf over the rationals:
    acc = fmaf(O_r, a_r, acc), den = fmaf(L_r, a_r, den) in piece order,
    then acc / den in float32."""
    q, k, v = _decode_inputs(rng, 4, 4, 2, 50, 8)
    lengths = torch.tensor([3, 17, 40, 50], dtype=torch.int32)
    parts = [da_mod.decode_attention_partials(_t(q), _t(k[:, a:a + 10]), _t(v[:, a:a + 10]),
                                              da_mod.piece_lengths(lengths, a, 10))
             for a in range(0, 50, 10)]
    got = da_mod.combine_partials(parts, torch.float32).numpy()
    o, m, l = (np.stack([p[i].numpy() for p in parts]) for i in range(3))
    top = np.where(l > 0, m, -np.inf).max(axis=0)
    a = torch.where(_t(l) > 0, torch.exp2(_t(m) - _t(top)), 0.0).numpy()
    want = np.empty_like(got)
    for bi, hi in np.ndindex(*top.shape):
        den = np.float32(0)
        for r in range(len(parts)):
            den = _fmaf(l[r, bi, hi], a[r, bi, hi], den)
        for j in range(o.shape[-1]):
            acc = np.float32(0)
            for r in range(len(parts)):
                acc = _fmaf(o[r, bi, hi, j], a[r, bi, hi], acc)
            want[bi, hi, j] = acc / den
    np.testing.assert_array_equal(_bits32(got), _bits32(want))


def test_decode_attention_plain_bf16_keeps_dtype(rng):
    q, k, v = (_t(a).to(torch.bfloat16) for a in _decode_inputs(rng, 2, 8, 2, 50, 32))
    out = tref.decode_attention(q, k, v, torch.tensor([3, 50], dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 32)
    exp = rref.decode_attention(jnp.asarray(q[1].float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(k[1].float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(v[1].float().numpy()).astype(jnp.bfloat16), 50)
    np.testing.assert_allclose(out[1].float().numpy(), np.asarray(exp.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


def test_decode_attention_plain_length_zero_is_ref_mean_of_v(rng):
    """No valid slot: the plain version gives the mean of V, as
    repro.kernels.ref does (the kernels give 0; ROADMAP, known divergences).
    Decode never reaches it: its lengths are >= 1."""
    q, k, v = (a[0] for a in _decode_inputs(rng, 1, 4, 2, 16, 8))
    got = tref.decode_attention(_t(q), _t(k), _t(v), 0).numpy()
    exp = np.asarray(rref.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0))
    np.testing.assert_allclose(got, exp, **DECODE_TOL)
    np.testing.assert_allclose(got.reshape(2, 2, 8), np.broadcast_to(v.mean(0)[:, None], (2, 2, 8)),
                               **DECODE_TOL)


@pytest.mark.parametrize("s,n", [(1, 1), (127, 1), (128, 1), (129, 2), (1024, 8), (32768, 8),
                                 (333, 3), (1100, 8), (0, 1)])
def test_decode_attention_split_plan(s, n):
    """The tc kernel's cluster plan, a function of S alone (no slot's result
    depends on another's length): min(8, ceil(S / 128)) CTAs, keys a CTA a
    multiple of 64; CTA r's warp w owns the 16-key sub-tiles r * keys + 16
    (w + 4 j), which cover every key of [0, S) exactly once.  The fma
    kernel (float32) keeps ceil(S / 128) CTAs of 128 keys."""
    keys = da_mod.split_keys(s)
    assert da_mod.splits(s) == n and 1 <= n <= da_mod.MAX_SPLITS
    assert keys % 64 == 0 and n * keys >= s
    owned = np.zeros(n * keys, np.int64)
    for r in range(n):
        for w in range(4):
            for start in range(r * keys + 16 * w, (r + 1) * keys, 64):
                owned[start:start + 16] += 1
    assert (owned == 1).all()
    assert da_mod.fma_splits(s) == max(1, -(-s // 128))


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 40, "tc"), (torch.float32, 128, "fma"),
    (torch.float32, 40, "fma")])
def test_decode_attention_route(dtype, d, route):
    """The route is picked by dtype alone: bf16 on the tensor cores (where D
    is not a multiple of 16 the card refuses it: see
    tests/test_torch_cuda_kernels.py::test_cuda_decode_attention_bf16_refuses_odd_head_dim),
    float32 on fma."""
    assert da_mod.route(dtype) == route


K7_BF16_TOL = 4e-3   # chip_smoke.py's K7_BF16_TOL: about one bf16 ulp at |x| < 1


def test_decode_tc_split_p_keeps_the_bf16_limit(rng):
    """The numerics of the tc kernel at the serving shape's widths (8 slots,
    32 heads over 4, D 128, S 1024), emulated in float32: q and K as bf16,
    float32 scores, per (CTA, warp) of the split plan a partial (m, l, O)
    with P split into bf16 hi + lo for P . V; each CTA's warps folded in
    warp order with 2^(m_w - M), then the CTAs in split order with 2^(M_c -
    M*); within K7_BF16_TOL of decode_attention_plain, and closer to it
    than P rounded once."""
    b, h, kvh, s, d = 8, 32, 4, 1024, 128
    q, k, v = (_t(a).bfloat16() for a in _decode_inputs(rng, b, h, kvh, s, d))
    lengths = torch.tensor([1, 147, 293, 440, 586, 733, s, s + 9], dtype=torch.int32)
    want = da_mod.decode_attention_plain(q, k, v, lengths).float()
    g = h // kvh
    n, keys = da_mod.splits(s), da_mod.split_keys(s)
    scale = d ** -0.5 * 1.4426950408889634
    qg = q.float().reshape(b, kvh, g, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale          # (b, kvh, g, s)
    cta = torch.arange(s) // keys
    warp = (torch.arange(s) % keys // 16) % 4
    valid = torch.arange(s)[None, :] < lengths.clamp(max=s)[:, None]      # (b, s)

    def fold(parts):
        """(m, l, O) partials folded in order with 2^(m - M), M their max."""
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        return (mx, sum(lsum * torch.exp2(m - mx) for m, lsum, _ in parts),
                sum(a * torch.exp2(m - mx) for m, _, a in parts))

    def out(split: bool):
        res = torch.zeros(b, kvh, g, d)
        for bi in range(b):
            ctas = []
            for c in range(n):                   # CTAs in split order
                warps = []
                for w in range(4):               # a CTA's warps in warp order
                    sel = (cta == c) & (warp == w) & valid[bi]
                    if not sel.any():
                        continue
                    x = sc[bi][..., sel]
                    m = x.amax(-1, keepdim=True)
                    p = torch.exp2(x - m)
                    hi = p.bfloat16().float()
                    vs = v[bi][sel].float().transpose(0, 1)             # (kvh, keys, d)
                    acc = hi @ vs + ((p - hi).bfloat16().float() @ vs if split else 0)
                    warps.append((m, p.sum(-1, keepdim=True), acc))
                if warps:
                    ctas.append(fold(warps))
            _, den, num = fold(ctas)
            res[bi] = num / den
        return res.reshape(b, h, d).bfloat16().float()

    split, once = (float((out(x) - want).abs().max()) for x in (True, False))
    print(f"P split: max |err| {split:.4g}; P rounded once: {once:.4g} (limit {K7_BF16_TOL})")
    assert split <= K7_BF16_TOL and split <= once


def test_decode_attention_cpu_takes_the_plain_path(rng):
    da_mod.counter.reset()
    q, k, v = (_t(a) for a in _decode_inputs(rng, 2, 4, 2, 20, 16))
    lengths = torch.tensor([5, 20], dtype=torch.int32)
    torch.testing.assert_close(tops.decode_attention(q, k, v, lengths),
                               da_mod.decode_attention_plain(q, k, v, lengths), rtol=0, atol=0)
    assert da_mod.counter.launches == 0
    with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA"):
        da_mod.decode_attention(q, k, v, lengths.to("meta"))


# ---- linear_scan (K5) ---------------------------------------------------------
# rtol = atol = 2e-3, the tolerance of tests/test_kernels.py's
# test_linear_scan; the reference's three shapes (T, N), a in [0, 0.95)
from repro.kernels.linear_scan import linear_scan as pallas_linscan  # noqa: E402
from repro_torch.kernels import linear_scan as ls_mod  # noqa: E402

SCAN_TOL = dict(rtol=2e-3, atol=2e-3)
LINSCAN_SHAPES = [(16, 8), (300, 17), (1025, 64)]


def _linscan_inputs(rng, shape):
    return ((rng.random(shape) * 0.95).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("t,n", LINSCAN_SHAPES)
def test_linear_scan_plain_matches_ref(rng, t, n):
    a, b = _linscan_inputs(rng, (t, n))
    exp = np.asarray(rref.linear_scan(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tref.linear_scan(_t(a), _t(b)).numpy(), exp, **SCAN_TOL)
    np.testing.assert_allclose(tops.linear_scan(_t(a), _t(b)).numpy(), exp, **SCAN_TOL)


@pytest.mark.parametrize("t,n", LINSCAN_SHAPES)
def test_linear_scan_plain_matches_pallas(rng, use_pallas_kernels, t, n):
    """The Pallas kernel in interpret mode, through the reference's ops
    dispatch and directly."""
    a, b = _linscan_inputs(rng, (t, n))
    assert rops.use_pallas()
    got = tref.linear_scan(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(rops.linear_scan(jnp.asarray(a), jnp.asarray(b))),
                               **SCAN_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_linscan(jnp.asarray(a), jnp.asarray(b))),
                               **SCAN_TOL)


def test_linear_scan_plain_batched_is_per_row(rng):
    """The (B, T, N) call is the reference's (T, N) call row by row (what
    rglru_block's jax.vmap computes); T = 0 and T = 1 keep their shapes."""
    a, b = _linscan_inputs(rng, (3, 70, 5))
    got = tref.linear_scan(_t(a), _t(b))
    assert got.shape == (3, 70, 5) and got.dtype == torch.float32
    for i in range(3):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(rref.linear_scan(jnp.asarray(a[i]), jnp.asarray(b[i]))),
            **SCAN_TOL)
        assert torch.equal(got[i], tref.linear_scan(_t(a[i]), _t(b[i])))
    assert tref.linear_scan(_t(a[:, :0]), _t(b[:, :0])).shape == (3, 0, 5)
    assert torch.equal(tref.linear_scan(_t(a[:, :1]), _t(b[:, :1])), _t(b[:, :1]))


@pytest.mark.parametrize("t,c", [(1, 1), (63, 1), (64, 1), (65, 2), (4096, 64)])
def test_linear_scan_chunk_plan(t, c):
    """The kernel's copy ring cuts T steps into ceil(T / 64) time tiles: a
    function of T."""
    assert ls_mod.chunks(t) == c


@pytest.mark.parametrize("shape", LINSCAN_SHAPES + [(3, 70, 5)])
def test_linear_scan_plain_is_the_sequential_float32_loop(rng, shape):
    """linear_scan_plain, which the kernel is held to bit for bit on the
    card, is the sequential recurrence with two float32 roundings a step
    (h = a[t] * h, rounded, + b[t], rounded), bit for bit."""
    a, b = _linscan_inputs(rng, shape)
    a[..., 2::7, :] = 0.0                      # steps that restart h from b ...
    b[..., 2::7, :] *= 1e-38                   # ... at a subnormal value
    a[..., 5::7, :] = 0.0
    b[..., 5::7, :] = -0.0                     # ... at a signed zero
    want = np.empty_like(b)
    h = np.zeros(b.shape[:-2] + b.shape[-1:], dtype=np.float32)
    for t in range(b.shape[-2]):
        h = np.add(np.multiply(a[..., t, :], h), b[..., t, :])
        want[..., t, :] = h
    got = ls_mod.linear_scan_plain(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# (batch, N, a's and b's batch and time strides in floats, base addresses) →
# (grid, bytes a cp.async moves)
LINSCAN_PLANS = [
    ((2, 4096, (4096 * 4096, 4096) * 2, (0, 2 ** 26)), ((128, 2), 16)),  # the RG-LRU's
    ((3, 64, (25600, 128) * 2, (256, 512)), ((2, 3), 16)),     # views with a time stride
    ((2, 4096, (4096 * 4096, 4096) * 2, (4, 0)), ((128, 2), 4)),  # a base 4 bytes off
    ((1, 33, (4097 * 33, 33) * 2, (0, 0)), ((2, 1), 4)),       # a ragged slab, N odd
    ((3, 70, (129 * 70, 70) * 2, (0, 0)), ((3, 3), 4)),        # N = 2 mod 4
    ((2, 64, (64 * 65, 66) * 2, (0, 0)), ((2, 2), 4)),         # a time stride of 66
    ((65535, 8, (8, 8) * 2, (0, 0)), ((1, 65535), 16)),        # the most batch rows
]


@pytest.mark.parametrize("args,want", LINSCAN_PLANS)
def test_linear_scan_grid_and_copy_width(args, want):
    """One CTA a 32-channel slab of a batch row; 16-byte copies only where N,
    every stride and both bases allow them: functions of shape, strides and
    addresses alone."""
    batch, n, strides, addresses = args
    assert (ls_mod.grid(batch, n), ls_mod.copy_bytes(n, strides, addresses)) == want


def test_linear_scan_cpu_takes_the_plain_path(rng):
    ls_mod.counter.reset()
    a, b = (_t(x) for x in _linscan_inputs(rng, (2, 9, 4)))
    assert torch.equal(tops.linear_scan(a, b), ls_mod.linear_scan_plain(a, b))
    assert ls_mod.counter.launches == 0
    with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA"):
        ls_mod.linear_scan(a, b.to("meta"))
    with pytest.raises(ValueError, match="one shape"):
        ls_mod.linear_scan(a, b[:, :3])


# ---- flash_attention (K6) -------------------------------------------------------
# f32 at rtol = atol = 2e-3 and bf16 at 5e-2, the tolerances of
# tests/test_kernels.py's flash cases, at its shapes (H, Sq, Sk, D)
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402

FLASH_TOL = dict(rtol=2e-3, atol=2e-3)
FLASH_SHAPES = [(2, 128, 128, 64), (4, 200, 200, 64), (1, 64, 256, 128), (2, 333, 333, 80)]


def _flash_inputs(rng, h, sq, sk, d, kvh=None):
    kvh = kvh or h
    return (rng.standard_normal((h, sq, d)).astype(np.float32),
            rng.standard_normal((kvh, sk, d)).astype(np.float32),
            rng.standard_normal((kvh, sk, d)).astype(np.float32))


@pytest.mark.parametrize("h,sq,sk,d", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 32])
def test_flash_attention_plain_matches_ref(rng, h, sq, sk, d, window):
    q, k, v = _flash_inputs(rng, h, sq, sk, d)
    exp = np.asarray(rref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, window=window))
    for fn in (tref.flash_attention, tops.flash_attention):
        got = fn(_t(q), _t(k), _t(v), causal=True, window=window)
        assert got.shape == (h, sq, d)
        np.testing.assert_allclose(got.numpy(), exp, **FLASH_TOL)


@pytest.mark.parametrize("h,sq,sk,d", [(2, 128, 128, 64), (1, 64, 256, 128)])
@pytest.mark.parametrize("window", [None, 32])
def test_flash_attention_plain_matches_pallas(rng, use_pallas_kernels, h, sq, sk, d, window):
    """The Pallas kernel in interpret mode, through the reference's ops
    dispatch as on the TPU."""
    q, k, v = _flash_inputs(rng, h, sq, sk, d)
    assert rops.use_pallas()
    exp = np.asarray(rops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, window=window))
    np.testing.assert_allclose(tref.flash_attention(_t(q), _t(k), _t(v), window=window).numpy(),
                               exp, **FLASH_TOL)


def test_flash_attention_plain_bf16_matches_ref(rng):
    q, k, v = (_t(x).to(torch.bfloat16) for x in _flash_inputs(rng, 2, 128, 128, 64))
    got = tref.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    as_jnp = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)]
    exp = rref.flash_attention(*as_jnp, causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None), (False, 5)])
def test_flash_attention_plain_gqa_model_layout(rng, causal, window):
    """The model's call, q (B, Sq, H, D) with k, v (B, Sk, KVH, D), against
    the reference's per-sequence call with the KV heads repeated, as the
    reference's model does; Sq < Sk aligns the queries to the keys' end."""
    b, sq, sk, h, kvh, d = 2, 9, 13, 6, 2, 8
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    assert got.shape == (b, sq, h, d)
    for i in range(b):
        rep = [np.repeat(x[i].transpose(1, 0, 2), h // kvh, axis=0) for x in (k, v)]
        exp = rref.flash_attention(jnp.asarray(q[i].transpose(1, 0, 2)), *map(jnp.asarray, rep),
                                   causal=causal, window=window)
        np.testing.assert_allclose(got[i], np.asarray(exp).transpose(1, 0, 2), **FLASH_TOL)


def test_flash_attention_plain_unseen_rows_are_ref_mean_of_v(rng):
    """Sq > Sk places the first causal queries before every key: the plain
    version gives the mean of V there, as repro.kernels.ref does (the
    kernels give 0; ROADMAP, known divergences).  The forward has Sq = Sk."""
    q, k, v = _flash_inputs(rng, 2, 10, 4, 8)
    got = tref.flash_attention(_t(q), _t(k), _t(v)).numpy()
    exp = np.asarray(rref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, exp, **FLASH_TOL)
    np.testing.assert_allclose(got[:, :6], np.broadcast_to(v.mean(1)[:, None], (2, 6, 8)),
                               **FLASH_TOL)


def test_pallas_flash_unseen_rows_average_the_padded_keys(rng):
    """The reference's Pallas flash kernel masks with a finite -1e30, so its
    l == 0 guard (flash_attention.py:70) never fires: a row with no visible
    key gets p = 1 for every key of its tiles and returns the sum of V over
    the key axis padded to the 128-key tile, over 128 (ROADMAP, known
    divergences).  ref and the plain version give the mean of V; the CUDA
    kernel gives 0."""
    q, k, v = _flash_inputs(rng, 1, 10, 4, 8)
    got = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got[0, :6], np.broadcast_to(v[0].sum(0) / 128, (6, 8)),
                               **FLASH_TOL)
    assert np.abs(got[0, :6] - v[0].mean(0)).max() > 0.1


def test_flash_attention_cpu_takes_the_plain_path(rng):
    fa_mod.counter.reset()
    q, k, v = (_t(x) for x in _flash_inputs(rng, 2, 7, 7, 8))
    assert torch.equal(tops.flash_attention(q, k, v, window=3),
                       fa_mod.flash_attention_plain(q, k, v, window=3))
    assert fa_mod.counter.launches == 0
    with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA"):
        fa_mod.flash_attention(q, k, v.to("meta"))


# The tensor-core route (bf16) against the plain version: one bf16 ulp
# (2^-7 |x|) plus 1e-5, chip_smoke.py's K6_BF16_RTOL / K6_BF16_ATOL.  Both
# round one float32 result, so they may part by one ulp.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _bf16_ratio(got, want) -> float:
    """max |got - want| / (1e-5 + 2^-7 |want|): at most 1 within BF16_TOL."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs())).max())


def test_flash_tc_split_p_keeps_the_bf16_limit(rng):
    """The numerics of the tensor-core kernel's P . V, emulated in float32
    at a seeded causal (2, 1024, 4, 64) case: P split into bf16 hi + lo
    stays inside BF16_TOL of the plain version; P rounded once to bf16
    does not (a 2^-9 relative error on every term)."""
    b, s, h, d = 2, 1024, 4, 64
    q, k, v = (_t(rng.standard_normal((b, s, h, d)).astype(np.float32)).bfloat16()
               for _ in range(3))
    want = fa_mod.flash_attention_plain(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    scores = scores.masked_fill(~fa_mod._mask(s, s, True, None, "cpu"), float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    norm = p.sum(-1, keepdim=True)

    def out(*parts):
        acc = sum(torch.einsum("bhqk,bkhd->bhqd", part, v.float()) for part in parts)
        return (acc / norm).transpose(1, 2).bfloat16()

    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    split, once = _bf16_ratio(out(hi, lo), want), _bf16_ratio(out(hi), want)
    print(f"P split: {split:.4g} of the bf16 limit; P rounded once: {once:.4g}")
    assert split <= 1.0 < once


def test_flash_tma_operand_copies_only_what_tma_cannot_read():
    """TMA needs 16-byte aligned bases and strides: views of a fused
    projection pass as they are; an odd head dimension, or a view at an odd
    offset, becomes a contiguous copy with D zero-padded to a multiple of 16."""
    b, s, h, kvh, d = 2, 10, 4, 2, 64
    fused = torch.randn(b, s, (h + 2 * kvh) * d).bfloat16().view(b, s, h + 2 * kvh, d)
    for view in (fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]):
        assert fa_mod.tma_operand(view) is view
    odd = torch.randn(b, s, 3, 33).bfloat16()
    got = fa_mod.tma_operand(odd)
    assert got.shape == (b, s, 3, 48) and got.is_contiguous()
    assert torch.equal(got[..., :33], odd) and not got[..., 33:].any()
    shifted = torch.randn(s * 2 * d + 1).bfloat16()[1:].view(1, s, 2, d)
    assert shifted.data_ptr() % 16 != 0
    got = fa_mod.tma_operand(shifted)
    assert got.data_ptr() % 16 == 0 and got.shape == shifted.shape and torch.equal(got, shifted)
