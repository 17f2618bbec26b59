"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

These cases need a CUDA device and skip here with a reason.  The file
imports neither JAX nor the JAX package, and keeps its own ``rng`` fixture,
so that the card's machine (which has no JAX) runs it with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py``;
``chip_smoke.py`` does so after its kernel phase.  The plain versions are
held against the JAX package in ``tests/test_torch_kernels.py``.

Tolerances: transpose, one-hot, counts, min / max, cummax / cummin and
linear_scan and its backward bit-equal (the backward: to autograd through
linear_scan_plain, ``torch.equal``); float sums and cumsum rtol=atol=1e-4, as
tests/test_kernels.py has them; decode_attention (K7) float32 2e-3, bf16
4e-3; flash_attention (K6) float32 2e-3, bf16 one bf16 ulp (2^-7 |x|) plus
1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_transpose as bt_mod
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import linear_scan as ls_mod
from repro_torch.kernels import onehot_encode as oh_mod
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import window_scan as ws_mod

TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_OPS = ["cumsum", "cummax", "cummin"]
# (M, G, C) on route reg: ragged M (past one CTA, past one step, under a
# warp), C 1 to 8 (3 and 5 through the scalar loads), G 1 to 64
_K1_SHAPES = [(1000, 6, 8), (70_001, 6, 8), (4097, 1, 1), (12_345, 6, 1), (5000, 64, 1),
              (3001, 16, 3), (5, 3, 2), (0, 4, 1), (1, 6, 8), (4097, 6, 8), (9999, 7, 5)]
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
DECODE_SHAPES = [(8, 2, 256, 100, 64), (16, 4, 333, 217, 64), (4, 4, 128, 128, 128),
                 (8, 1, 700, 1, 64)]
K7_BF16_TOL = 4e-3   # chip_smoke.py's K7_BF16_TOL: about one bf16 ulp at |x| < 1
LINSCAN_SHAPES = [(16, 8), (300, 17), (1025, 64)]
FLASH_TOL = dict(rtol=2e-3, atol=2e-3)
FLASH_SHAPES = [(2, 128, 128, 64), (4, 200, 200, 64), (1, 64, 256, 128), (2, 333, 333, 80)]
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sm_90a kernels run only on the card "
                    "(python3 chip_smoke.py runs them there)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_input(rng, m, n):
    """Normal values with NaN, -0.0 and ±inf inside, never in row 0."""
    x = rng.standard_normal((m, n)).astype(np.float32)
    x[3::37, 0] = np.nan
    x[5::11, -1] = -0.0
    x[7::53, n // 2] = np.inf
    x[9::71, n // 2] = -np.inf
    return x


def _reg_fits(c: int, g: int) -> bool:
    """The "reg" kernel's templates: G padded to 8, 16, 32 or 64 times C
    padded to 1, 2, 4 or 8, at most 64 accumulators a thread."""
    gp = next(p for p in (8, 16, 32, 64, 1 << 30) if g <= p)
    cp = next(p for p in (1, 2, 4, 8, 1 << 30) if c <= p)
    return gp * cp <= 64


def _decode_inputs(rng, b, h, kvh, s, d):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, k, v


def _linscan_inputs(rng, shape):
    return ((rng.random(shape) * 0.95).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _flash_inputs(rng, h, sq, sk, d, kvh=None):
    kvh = kvh or h
    return (rng.standard_normal((h, sq, d)).astype(np.float32),
            rng.standard_normal((kvh, sk, d)).astype(np.float32),
            rng.standard_normal((kvh, sk, d)).astype(np.float32))


def _tc_checked(q, k, v, **kw):
    """The bf16 call on the card: one launch of the tensor-core route,
    rerun bit-identical, within BF16_TOL of the plain version."""
    fa_mod.counter.reset()
    out = fa_mod.flash_attention(q, k, v, **kw)
    assert fa_mod.counter.routes == {"tc": 1}
    assert torch.equal(out, fa_mod.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(out.float(), fa_mod.flash_attention_plain(q, k, v, **kw).float(),
                               **BF16_TOL)
    return out


def _bf16_on(cuda, *arrays):
    return tuple(_t(a).to(cuda, torch.bfloat16) for a in arrays)


@pytest.mark.parametrize("m,g,cols", [(1000, 6, 8), (4097, 1, 1), (3001, 65536, 1),
                                     (501, 6, 2000), (300, 65536, 1600)])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
def test_cuda_segment_reduce_matches_plain(rng, cuda, m, g, cols, op):
    v = _t(rng.standard_normal((m, cols)).astype(np.float32)).to(cuda)
    c = _t(rng.integers(-1, g, m).astype(np.int32)).to(cuda)
    out = sr_mod.segment_reduce(v, c, g, op)
    torch.testing.assert_close(out, sr_mod.segment_reduce(v, c, g, op), rtol=0, atol=0)
    exp = sr_mod.segment_reduce_plain(v, c, g, op)
    tol = dict(rtol=0, atol=0) if op != "sum" else TOL
    torch.testing.assert_close(out, exp, equal_nan=True, **tol)


@pytest.mark.parametrize("m,g,c", _K1_SHAPES + [(2_000_000, 6, 8), (2_000_000, 6, 1),
                                   (3_000_001, 6, 1)])
def test_cuda_segment_reduce_reg_sum_is_the_stated_order(rng, cuda, m, g, c):
    """The "reg" route's sum equals emulated_sum bit for bit, on every rerun."""
    v = rng.standard_normal((m, c)).astype(np.float32)
    codes = rng.integers(-1, g, m).astype(np.int32)
    sr_mod.counter.reset()
    got = sr_mod.segment_reduce(_t(v).to(cuda), _t(codes).to(cuda), g, "sum")
    assert sr_mod.counter.routes == {"reg": 1}
    want = sr_mod.emulated_sum(_t(v), _t(codes), g)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    for _ in range(3):
        again = sr_mod.segment_reduce(_t(v).to(cuda), _t(codes).to(cuda), g, "sum")
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))


def test_cuda_segment_reduce_reg_reads_unaligned_views(rng, cuda):
    """Values at an offset of one float take the scalar loads of route reg,
    codes at an odd offset too; the result is the aligned call's, bit for
    bit (the same rows in the same order)."""
    m, g, c = 10_001, 6, 8
    flat = _t(rng.standard_normal(m * c + 1).astype(np.float32)).to(cuda)
    codes = _t(rng.integers(-1, g, m + 1).astype(np.int32)).to(cuda)
    v = flat[1:].view(m, c)
    assert v.data_ptr() % 16 != 0
    got = sr_mod.segment_reduce(v, codes[1:], g, "sum")
    want = sr_mod.segment_reduce(v.clone(), codes[1:].clone(), g, "sum")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("g", [1, 6, 64])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
def test_cuda_segment_reduce_register_route(rng, cuda, c, g, op):
    """Route reg at C 1, 3, 8 and G 1, 6, 64 where its templates take the
    shape (route table elsewhere): one launch a call, reruns bit-identical,
    count / min / max exact against the plain version (NaN included), sum
    within TOL."""
    m = 100_003
    v = rng.standard_normal((m, c)).astype(np.float32)
    v[::1009, 0] = np.nan
    v = _t(v).to(cuda)
    codes = _t(rng.integers(-1, g + 2, m).astype(np.int32)).to(cuda)
    sr_mod.counter.reset()
    out = sr_mod.segment_reduce(v, codes, g, op)
    route = sr_mod.route(c, g)
    assert route == ("reg" if _reg_fits(c, g) else "table")
    if route == "reg":
        assert sr_mod.counter.routes == {"reg": 1}
    for _ in range(5):
        assert torch.equal(sr_mod.segment_reduce(v, codes, g, op).view(torch.int32),
                           out.view(torch.int32))
    exp = sr_mod.segment_reduce_plain(v, codes, g, op)
    tol = TOL if op == "sum" else dict(rtol=0, atol=0)
    torch.testing.assert_close(out, exp, equal_nan=True, **tol)


@pytest.mark.parametrize("shape", [(1, 1), (1, 77), (77, 1), (257, 129), (33, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_transpose_matches_plain(cuda, shape, dtype):
    x = (torch.randn(shape, device=cuda) * 100).to(dtype)
    assert torch.equal(bt_mod.block_transpose(x), bt_mod.block_transpose_plain(x))


@pytest.mark.parametrize("m,g", [(1, 1), (1000, 3), (513, 1000)])
def test_cuda_onehot_matches_plain(rng, cuda, m, g):
    c = _t(rng.integers(-1, g + 3, m).astype(np.int32)).to(cuda)
    assert torch.equal(oh_mod.onehot_encode(c, g), oh_mod.onehot_encode_plain(c, g))


@pytest.mark.parametrize("m,n", [(1, 1), (33, 3), (4097, 1), (70_001, 130), (2_000_000, 1)])
@pytest.mark.parametrize("op", SCAN_OPS + ["cumprod"])
def test_cuda_window_scan_matches_plain(rng, cuda, m, n, op):
    x = _scan_input(rng, m, n)
    if op == "cumprod":
        # ±1 with a rare 2 or 1/2: every product is exact in float32, in any order
        u = rng.random(x.shape)
        mag = np.where(u < 1e-4, 2.0, np.where(u > 1 - 1e-4, 0.5, 1.0))
        x = np.where(np.isfinite(x) & (x != 0), np.sign(x) * mag, x).astype(np.float32)
    x = _t(x).to(cuda)
    out = ws_mod.window_scan(x, op)
    assert torch.equal(out.view(torch.int32), ws_mod.window_scan(x, op).view(torch.int32))
    exp = ws_mod.window_scan_plain(x, op)
    if op in ("cummax", "cummin"):
        assert torch.equal(out.view(torch.int32), exp.view(torch.int32))
    else:
        tol = dict(rtol=0, atol=0) if op == "cumprod" else TOL
        torch.testing.assert_close(out, exp, equal_nan=True, **tol)


@pytest.mark.parametrize("m", [1, 4097, 2_000_000, 3_000_000, 16_000_000])
def test_cuda_window_scan_cumsum_is_the_stated_order(rng, cuda, m):
    """The kernel's cumsum equals, bit for bit, the float32 emulation of the
    association order its header states (adds only, so no contraction can
    part them).  16,000,000 rows pass the grid's shared memory: part of the
    column streams."""
    x = rng.standard_normal(m).astype(np.float32)
    got = ws_mod.window_scan(_t(x).to(cuda)).cpu()
    assert torch.equal(got.view(torch.int32), ws_mod.emulated_cumsum(_t(x)).view(torch.int32))


@pytest.mark.parametrize("m", [2_000_000, 16_000_000])
@pytest.mark.parametrize("op", SCAN_OPS + ["cumprod"])
def test_cuda_window_scan_50_reruns_bit_identical(rng, cuda, m, op):
    x = _t(rng.standard_normal(m).astype(np.float32)).to(cuda)
    if op == "cumprod":
        x = 1.0 + 1e-3 * x
    first = ws_mod.window_scan(x, op)
    for _ in range(50):
        assert torch.equal(first.view(torch.int32), ws_mod.window_scan(x, op).view(torch.int32))


@pytest.mark.parametrize("g", [1, 3, 4, 5, 7, 1000])
@pytest.mark.parametrize("m", [1, 3, 4097, 2_000_001])
def test_cuda_onehot_every_g_matches_plain(rng, cuda, m, g):
    """Codes -1 and >= G give zero rows; M not a multiple of 4; codes read
    through the 16-byte path and, at an odd offset, the scalar one."""
    if m * g > 2e8:
        m = 200_001
    c = _t(rng.integers(-1, g + 3, m + 1).astype(np.int32)).to(cuda)
    for codes in (c[:m], c[1:]):
        assert torch.equal(oh_mod.onehot_encode(codes, g), oh_mod.onehot_encode_plain(codes, g))


@pytest.mark.parametrize("h,kvh,s,length,d", DECODE_SHAPES)
def test_cuda_decode_attention_matches_plain(rng, cuda, h, kvh, s, length, d):
    q, k, v = (_t(a).to(cuda) for a in _decode_inputs(rng, 3, h, kvh, s, d))
    lengths = torch.tensor([length, s, s + 5], dtype=torch.int32, device=cuda)
    da_mod.counter.reset()
    out = da_mod.decode_attention(q, k, v, lengths)
    assert da_mod.counter.routes == {"fma": 1}
    assert torch.equal(out, da_mod.decode_attention(q, k, v, lengths))
    torch.testing.assert_close(out, da_mod.decode_attention_plain(q, k, v, lengths), **DECODE_TOL)
    single = da_mod.decode_attention(q[0], k[0], v[0], length)
    torch.testing.assert_close(single, out[0], rtol=0, atol=0)


def test_cuda_decode_attention_bf16_main_shape(rng, cuda):
    """yi-6b's serving shape, bf16, within about one bf16 ulp at |x| < 1
    (4e-3; the kernel reads 1.2e-4 to 2.4e-4 there on an H100); a zero
    length gives 0 (ROADMAP, known divergences)."""
    b, h, kvh, s, d = 8, 32, 4, 1024, 128
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _decode_inputs(rng, b, h, kvh, s, d))
    lengths = torch.tensor([1, 200, 511, 512, 513, 1000, s, s + 7], dtype=torch.int32, device=cuda)
    out = da_mod.decode_attention(q, k, v, lengths)
    assert out.dtype == torch.bfloat16
    for _ in range(10):
        assert torch.equal(out, da_mod.decode_attention(q, k, v, lengths))
    torch.testing.assert_close(out.float(), da_mod.decode_attention_plain(q, k, v, lengths).float(),
                               rtol=4e-3, atol=4e-3)
    zero = da_mod.decode_attention(q, k, v, torch.zeros(b, dtype=torch.int32, device=cuda))
    assert torch.equal(zero, torch.zeros_like(zero))


def test_cuda_decode_attention_refuses_mixed_dtypes(rng, cuda):
    """The kernel takes q and the caches in one element type."""
    q, k, v = (_t(a).to(cuda) for a in _decode_inputs(rng, 2, 8, 2, 64, 32))
    lengths = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        da_mod.decode_attention(q, k.bfloat16(), v.bfloat16(), lengths)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        da_mod.decode_attention(q.bfloat16(), k, v, lengths)


@pytest.mark.parametrize("b,h,kvh,s,d", [
    (8, 32, 4, 1024, 128), (3, 16, 4, 333, 64), (3, 8, 1, 700, 64), (2, 32, 1, 300, 128),
    (2, 64, 1, 200, 64), (2, 16, 8, 4096, 256), (4, 8, 8, 129, 16), (1, 8, 1, 32768, 128)])
def test_cuda_decode_attention_tc_matches_plain(rng, cuda, b, h, kvh, s, d):
    """The tensor-core route at G 1 to 64 (several m-tiles past 16), D 16 to
    256 and clusters of 1 to 8 CTAs, within K7_BF16_TOL; one launch a call
    on route tc; reruns bit-identical."""
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _decode_inputs(rng, b, h, kvh, s, d))
    lengths = torch.tensor(([1, s, s + 9] + [1 + 137 * i % s for i in range(b)])[:b],
                           dtype=torch.int32, device=cuda)
    da_mod.counter.reset()
    out = da_mod.decode_attention(q, k, v, lengths)
    assert da_mod.counter.routes == {"tc": 1}
    assert torch.equal(out, da_mod.decode_attention(q, k, v, lengths))
    torch.testing.assert_close(out.float(), da_mod.decode_attention_plain(q, k, v, lengths).float(),
                               rtol=K7_BF16_TOL, atol=K7_BF16_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("b,h,kvh,s,d", [(8, 32, 4, 1024, 128), (3, 16, 4, 333, 64),
                                         (2, 64, 1, 200, 64), (4, 8, 8, 129, 16)])
def test_cuda_decode_attention_partials_match_plain(rng, cuda, dtype, b, h, kvh, s, d):
    """K7's partials mode on both routes against its plain version: M (the
    log2-domain row max) within 1e-3, L within K7_BF16_TOL relative, O / L
    within K7_BF16_TOL, and M -inf, L 0, O 0 at length 0; one launch a call,
    counted on route "tc_partials" / "fma_partials"; reruns bit-identical."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (_t(a).to(cuda, dt) for a in _decode_inputs(rng, b, h, kvh, s, d))
    lengths = torch.tensor(([0, s, s + 9] + [1 + 137 * i % s for i in range(b)])[:b],
                           dtype=torch.int32, device=cuda)
    da_mod.counter.reset()
    o, m, l = da_mod.decode_attention_partials(q, k, v, lengths)
    assert da_mod.counter.routes == {da_mod.route(dt) + "_partials": 1}
    again = da_mod.decode_attention_partials(q, k, v, lengths)
    assert all(torch.equal(x, y) for x, y in zip((o, m, l), again))
    po, pm, pl = da_mod.decode_attention_partials_plain(q, k, v, lengths)
    assert torch.isneginf(m[0]).all() and not l[0].any() and not o[0].any()
    torch.testing.assert_close(m[1:], pm[1:], rtol=0, atol=1e-3)
    torch.testing.assert_close(l[1:], pl[1:], rtol=K7_BF16_TOL, atol=0)
    torch.testing.assert_close(o[1:] / l[1:, :, None], po[1:] / pl[1:, :, None],
                               rtol=K7_BF16_TOL, atol=K7_BF16_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("pieces", [2, 4, 8])
def test_cuda_decode_attention_split_matches_whole_cache(rng, cuda, dtype, pieces):
    """K7 at the serving shape (8 slots, 32 heads over 4, D 128, 1,024 rows)
    cut into 2, 4 and 8 pieces: the partials of each piece, its lengths cut
    to its rows, combined in piece order, against the whole-cache route
    within K7_BF16_TOL (0 at length 0 on both)."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, h, kvh, s, d = 8, 32, 4, 1024, 128
    q, k, v = (_t(a).to(cuda, dt) for a in _decode_inputs(rng, b, h, kvh, s, d))
    lengths = torch.tensor([0, 1, 127, 128, 129, 600, s, s + 7], dtype=torch.int32, device=cuda)
    rows = s // pieces
    da_mod.counter.reset()
    parts = [da_mod.decode_attention_partials(q, k[:, i * rows:(i + 1) * rows],
                                              v[:, i * rows:(i + 1) * rows],
                                              da_mod.piece_lengths(lengths, i * rows, rows))
             for i in range(pieces)]
    assert da_mod.counter.routes == {da_mod.route(dt) + "_partials": pieces}
    got = da_mod.combine_partials(parts, dt)
    want = da_mod.decode_attention(q, k, v, lengths)
    assert got.dtype == dt and not got[0].any() and not want[0].any()
    torch.testing.assert_close(got.float(), want.float(), rtol=K7_BF16_TOL, atol=K7_BF16_TOL)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_cuda_decode_attention_tc_groups_and_edge_lengths(rng, cuda, g):
    """Route tc at G 1, 2, 4, 8, 16 (4 KV heads, D 128, S 1024: a cluster of
    8 CTAs of 128 keys) with lengths 0, 1, 127, 128, 129, S and S + 7 (a
    warp's first, last and next sub-tile, a CTA's edge, the whole cache):
    within K7_BF16_TOL of the plain version, 0 at length 0, ten reruns
    bit-identical, one launch a call."""
    kvh, s, d = 4, 1024, 128
    lens = [0, 1, 127, 128, 129, s, s + 7]
    q, k, v = (_t(a).to(cuda, torch.bfloat16)
               for a in _decode_inputs(rng, len(lens), g * kvh, kvh, s, d))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    da_mod.counter.reset()
    out = da_mod.decode_attention(q, k, v, lengths)
    assert da_mod.counter.routes == {"tc": 1}
    for _ in range(10):
        assert torch.equal(out, da_mod.decode_attention(q, k, v, lengths))
    assert not out[0].any()
    torch.testing.assert_close(out[1:].float(),
                               da_mod.decode_attention_plain(q, k, v, lengths)[1:].float(),
                               rtol=K7_BF16_TOL, atol=K7_BF16_TOL)


def test_cuda_decode_attention_bf16_refuses_odd_head_dim(rng, cuda):
    """bf16 runs on the tensor cores, which take D in steps of 16."""
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _decode_inputs(rng, 2, 8, 2, 64, 40))
    lengths = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        da_mod.decode_attention(q, k, v, lengths)


@pytest.mark.parametrize("shape", LINSCAN_SHAPES + [(0, 5), (1, 5), (3, 129, 70), (2, 700, 4096)])
def test_cuda_linear_scan_matches_plain(rng, cuda, shape):
    a, b = (_t(x).to(cuda) for x in _linscan_inputs(rng, shape))
    out = ls_mod.linear_scan(a, b)
    assert out.shape == a.shape and torch.equal(out, ls_mod.linear_scan(a, b))
    assert torch.equal(out, ls_mod.linear_scan_plain(a, b))   # the same two roundings a step


def _scan_grads(fn, a, b, w):
    a, b = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    h = fn(a, b)
    return (h.detach(),) + torch.autograd.grad((h * w).sum(), (a, b))


@pytest.mark.parametrize("shape", LINSCAN_SHAPES + [(1, 5), (63, 128), (64, 33), (65, 70),
                                                    (3, 129, 70), (2, 130, 4096)])
def test_cuda_linear_scan_backward_matches_autograd_plain(rng, cuda, shape):
    """K5's reverse walk: grad_a and grad_b equal (torch.equal) to autograd
    through linear_scan_plain on the card, one "bwd" launch a backward;
    reruns bit-identical."""
    a, b = (_t(x).to(cuda) for x in _linscan_inputs(rng, shape))
    w = _t(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    ls_mod.counter.reset()
    got = _scan_grads(ls_mod.linear_scan, a, b, w)
    assert ls_mod.counter.routes == {"fwd": 1, "bwd": 1}
    want = _scan_grads(ls_mod.linear_scan_plain, a, b, w)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    again = _scan_grads(ls_mod.linear_scan, a, b, w)
    assert all(torch.equal(g, x) for g, x in zip(got, again))


def test_cuda_linear_scan_backward_reads_strided_views(rng, cuda):
    """a as a view with batch and time strides (16-byte copies) and at a
    4-byte offset (4-byte copies); the gradient of a sum (stride 0 over
    the channels) made contiguous by the wrapper."""
    big = _t((rng.random((6, 260, 2, 128)) * 0.95).astype(np.float32)).to(cuda)
    bb = _t(rng.standard_normal((6, 260, 2, 128)).astype(np.float32)).to(cuda)
    for sl in ((slice(None, None, 2), slice(None, None, 2), 0),
               (slice(None, None, 2), slice(None, None, 2), 1, slice(5, 75))):
        a, b = big[sl], bb[sl]
        for w in (torch.ones_like(a), _t(rng.standard_normal(a.shape).astype(np.float32)).to(cuda)):
            got = _scan_grads(ls_mod.linear_scan, a, b, w)
            want = _scan_grads(ls_mod.linear_scan_plain, a, b, w)
            assert all(torch.equal(g, x) for g, x in zip(got, want))
        a2, b2 = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
        ga, gb = torch.autograd.grad(ls_mod.linear_scan(a2, b2).sum(), (a2, b2))
        wa, wb = ls_mod.linear_scan_backward_plain(a, torch.ones_like(a),
                                                   ls_mod.linear_scan_plain(a, b))
        assert torch.equal(ga, wa) and torch.equal(gb, wb)


@pytest.mark.parametrize("h,sq,sk,d", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 32])
def test_cuda_flash_attention_matches_plain(rng, cuda, h, sq, sk, d, window):
    q, k, v = (_t(x).to(cuda) for x in _flash_inputs(rng, h, sq, sk, d))
    out = fa_mod.flash_attention(q, k, v, window=window)
    assert torch.equal(out, fa_mod.flash_attention(q, k, v, window=window))
    torch.testing.assert_close(out, fa_mod.flash_attention_plain(q, k, v, window=window),
                               **FLASH_TOL)


def test_cuda_flash_attention_gqa_bf16_and_unseen_rows(rng, cuda):
    """The model's GQA layout in bf16, within one bf16 ulp (2^-7 |x|) plus
    1e-5 of the plain version: both round one float32 result, as
    chip_smoke.py's limit has it; causal rows before every key give 0
    (ROADMAP, known divergences)."""
    b, sq, h, kvh, d = 2, 300, 8, 2, 128
    q = _t(rng.standard_normal((b, sq, h, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    k = _t(rng.standard_normal((b, sq, kvh, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    v = _t(rng.standard_normal((b, sq, kvh, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    for window in (None, 100):
        out = fa_mod.flash_attention(q, k, v, window=window)
        want = fa_mod.flash_attention_plain(q, k, v, window=window)
        torch.testing.assert_close(out.float(), want.float(), rtol=2.0 ** -7, atol=1e-5)
    short = fa_mod.flash_attention(q, k[:, :100], v[:, :100])
    assert torch.equal(short[:, :200], torch.zeros_like(short[:, :200]))
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        fa_mod.flash_attention(q, k.float(), v.float())


@pytest.mark.parametrize("h,sq,sk,d", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 32])
def test_cuda_flash_tc_bf16_matches_plain(rng, cuda, h, sq, sk, d, window):
    _tc_checked(*_bf16_on(cuda, *_flash_inputs(rng, h, sq, sk, d)), window=window)


@pytest.mark.parametrize("h,kvh,d", [(8, 2, 128), (16, 1, 256)])
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_flash_tc_gqa_and_mqa_model_layout(rng, cuda, h, kvh, d, window):
    b, s = 2, 300
    q, k, v = _bf16_on(cuda, *(rng.standard_normal(shape).astype(np.float32)
                               for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))))
    _tc_checked(q, k, v, window=window)


def test_cuda_flash_tc_views_of_a_fused_projection(rng, cuda):
    """q, k and v as strided views of one (B, S, (H + 2 KVH) D) tensor:
    TMA reads them in place."""
    b, s, h, kvh, d = 2, 200, 8, 2, 128
    (fused,) = _bf16_on(cuda, rng.standard_normal((b, s, (h + 2 * kvh) * d)).astype(np.float32))
    fused = fused.view(b, s, h + 2 * kvh, d)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]
    assert all(fa_mod.tma_operand(t) is t for t in (q, k, v))
    _tc_checked(q, k, v)


def test_cuda_flash_tc_odd_head_dim_through_the_padded_copy(rng, cuda):
    """D 33 cannot give TMA 16-byte strides: the wrapper's zero-padded copy
    goes to the same kernel, which reads 33 columns; likewise a view at an
    odd offset."""
    q, k, v = _bf16_on(cuda, *(rng.standard_normal((2, 150, 4, 33)).astype(np.float32)
                               for _ in range(3)))
    for window in (None, 40):
        _tc_checked(q, k, v, window=window)
    (flat,) = _bf16_on(cuda, rng.standard_normal(3 * 150 * 4 * 64 + 1).astype(np.float32))
    q, k, v = flat[1:].view(3, 150, 4, 64).unbind(0)
    _tc_checked(q[None], k[None], v[None])


@pytest.mark.parametrize("window", [63, 64, 65])
@pytest.mark.parametrize("sq", [256, 200])
def test_cuda_flash_tc_window_edges_at_the_tile(rng, cuda, window, sq):
    """Windows one short of, at and one past the 64-key tile; Sq = Sk and
    Sq < Sk (queries aligned to the keys' end)."""
    b, sk, h, kvh, d = 2, 256, 4, 2, 64
    q, k, v = _bf16_on(cuda, rng.standard_normal((b, sq, h, d)).astype(np.float32),
                       *(rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
                         for _ in range(2)))
    _tc_checked(q, k, v, window=window)


def test_cuda_flash_tc_rows_before_every_key_are_zero(rng, cuda):
    """Sq > Sk, causal: the first Sq - Sk rows see no key and give 0 (the
    plain version gives the mean of V; ROADMAP, known divergences); the
    rest hold BF16_TOL."""
    q, k, v = _bf16_on(cuda, rng.standard_normal((2, 300, 8, 64)).astype(np.float32),
                       *(rng.standard_normal((2, 100, 2, 64)).astype(np.float32)
                         for _ in range(2)))
    out = fa_mod.flash_attention(q, k, v)
    assert torch.equal(out[:, :200], torch.zeros_like(out[:, :200]))
    want = fa_mod.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out[:, 200:].float(), want[:, 200:].float(), **BF16_TOL)


def test_cuda_flash_tc_reruns_bit_identical(rng, cuda):
    q, k, v = _bf16_on(cuda, *(rng.standard_normal((2, 1024, h, 128)).astype(np.float32)
                               for h in (8, 1, 1)))
    out = fa_mod.flash_attention(q, k, v, window=300)
    for _ in range(10):
        assert torch.equal(out, fa_mod.flash_attention(q, k, v, window=300))


def test_cuda_flash_attention_f32_takes_the_fma_route(rng, cuda):
    q, k, v = (_t(x).to(cuda) for x in _flash_inputs(rng, 2, 128, 128, 64))
    fa_mod.counter.reset()
    fa_mod.flash_attention(q, k, v)
    fa_mod.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert fa_mod.counter.routes == {"fma": 1, "tc": 1} and fa_mod.counter.launches == 2


# ---- non-causal K6 and the decode-cross K7 (the encoder and cross layers) ------------
@pytest.mark.parametrize("sk", [1, 63, 65, 1500])
@pytest.mark.parametrize("sq", [1, 100, 1500])
def test_cuda_flash_non_causal_at_ragged_key_lengths(rng, cuda, sq, sk):
    """causal=False, the encoder's and the cross layers' call: Sk of 1, one
    short of and one past the 64-key tile, and whisper's 1,500 frames (not a
    multiple of 64), with Sq = Sk and Sq != Sk; bf16 on the tensor cores
    within BF16_TOL, f32 on the FMA kernel within FLASH_TOL; 8 heads over 8
    and over 2 KV heads, D 64."""
    for kvh in (8, 2):
        q = rng.standard_normal((2, sq, 8, 64)).astype(np.float32)
        k, v = (rng.standard_normal((2, sk, kvh, 64)).astype(np.float32) for _ in range(2))
        _tc_checked(*_bf16_on(cuda, q, k, v), causal=False)
        q32, k32, v32 = (_t(a).to(cuda) for a in (q, k, v))
        out = fa_mod.flash_attention(q32, k32, v32, causal=False)
        torch.testing.assert_close(out, fa_mod.flash_attention_plain(q32, k32, v32, causal=False),
                                   **FLASH_TOL)


@pytest.mark.parametrize("b,sq,h,kvh,m,d", [(2, 300, 8, 8, 1500, 64), (2, 300, 64, 8, 1600, 128)])
def test_cuda_flash_non_causal_cross_shapes(rng, cuda, b, sq, h, kvh, m, d):
    """The cross layers' forward shapes: whisper (8 heads, D 64, M 1,500)
    and llama-vision (64 heads over 8, D 128, M 1,600), bf16, ten reruns
    bit-identical."""
    q, k, v = _bf16_on(cuda, rng.standard_normal((b, sq, h, d)).astype(np.float32),
                       *(rng.standard_normal((b, m, kvh, d)).astype(np.float32)
                         for _ in range(2)))
    out = _tc_checked(q, k, v, causal=False)
    for _ in range(10):
        assert torch.equal(out, fa_mod.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("b,h,kvh,m,d", [(4, 8, 8, 1500, 64), (4, 64, 8, 1600, 128),
                                         (3, 8, 2, 65, 64)])
def test_cuda_decode_attention_cross_every_length_m(rng, cuda, b, h, kvh, m, d):
    """Decode's cross-attention: one token over the whole memory, every
    length M (whisper's 1,500 and llama-vision's 1,600 frames, and 65), on
    route tc within K7_BF16_TOL, one launch, reruns bit-identical; equal
    within BF16_TOL to K6 non-causal at Sq = 1, the function it stands
    for."""
    q, k, v = (_t(a).to(cuda, torch.bfloat16) for a in _decode_inputs(rng, b, h, kvh, m, d))
    lengths = torch.full((b,), m, dtype=torch.int32, device=cuda)
    da_mod.counter.reset()
    out = da_mod.decode_attention(q, k, v, lengths)
    assert da_mod.counter.routes == {"tc": 1}
    assert torch.equal(out, da_mod.decode_attention(q, k, v, lengths))
    torch.testing.assert_close(out.float(), da_mod.decode_attention_plain(q, k, v, lengths).float(),
                               rtol=K7_BF16_TOL, atol=K7_BF16_TOL)
    flash = fa_mod.flash_attention(q[:, None], k, v, causal=False)[:, 0]
    torch.testing.assert_close(out.float(), flash.float(), rtol=K7_BF16_TOL, atol=K7_BF16_TOL)
