"""The fused-EWMA kernel's order of composition, held on the CPU.

`csrc/fused_ewma.cu` runs on the card only.  Its rounding rests on an
order of composition that can be tested here: `mirror` below is a NumPy
float32 copy of it — each row cut into tiles of TILE_LEN candles; in a
tile each of TILE_THREADS threads composes its TILE_ITEMS element maps in
sequence, the threads' maps are scanned across the block as the kernel's
warp shuffles scan them, giving the tile's aggregate and each thread's
exclusive prefix; the carry into a tile is the composition of the row's
earlier aggregates in tile order as the kernel's warp forms it (each lane a
run of them in sequence, then a shuffle scan over the lanes), applied to
y = 0; the apply step runs the recursion from prefix·carry over the
thread's items.  Nothing in that order
depends on how many blocks the card runs or on which block owns which tile,
so the mirror has no grid.  It is held against the plain version
(`fused_ewma_plain`, the replay of `lax.associative_scan`) at the tolerance
of tests/test_pallas.py:23 — NaN masks exactly, rtol 2e-5, atol 1e-3 — over
a series shorter than a tile, a ragged T, a seed index past the first tile,
NaN and ±inf inputs, and several jobs with their own alphas and seeds; and
once against the JAX `_ewm` (jitted) and the Pallas kernel in interpret
mode.  The job list's plain version is a loop of `fused_ewma_plain`, bit for
bit.  Change the mirror whenever the kernel changes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.ops import indicators as jind  # noqa: E402
from ai_crypto_trader_tpu.ops.pallas_kernels import fused_ewma as jax_fused_ewma  # noqa: E402
from ai_crypto_trader_tpu_torch.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import compute_indicators  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import ewma as ewma_mod  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import indicators as ind_mod  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.ewma import (  # noqa: E402
    MAX_JOBS,
    TILE_ITEMS,
    TILE_LEN,
    TILE_THREADS,
    _coefficients,
    fused_ewma,
    fused_ewma_jobs,
    fused_ewma_plain,
    tile_count,
)

F = np.float32
WARPS = TILE_THREADS // 32


def compose(first, then):
    """(a1, b1) then (a2, b2) -> (a1·a2, a2·b1 + b2), each op rounded."""
    (a1, b1), (a2, b2) = first, then
    return a1 * a2, a2 * b1 + b2


def warp_inclusive_scan(a, b):
    """The kernel's shuffle scan over the last axis (32 lanes): at offset
    1, 2, 4, 8, 16 each lane at or past the offset composes the lane that
    far below it (as it was before the step) with itself."""
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        ua = np.concatenate([a[..., :off], a[..., :-off]], axis=-1)
        ub = np.concatenate([b[..., :off], b[..., :-off]], axis=-1)
        na, nb = compose((ua, ub), (a, b))
        a, b = np.where(lane >= off, na, a), np.where(lane >= off, nb, b)
    return a, b


def _exclusive(a, b):
    one, zero = np.ones_like(a[..., :1]), np.zeros_like(b[..., :1])
    return (np.concatenate([one, a[..., :-1]], axis=-1),
            np.concatenate([zero, b[..., :-1]], axis=-1))


def block_exclusive_scan(a, b):
    """block_exclusive_scan of the kernel over the last axis (the block's
    threads): (each thread's exclusive prefix, the block's total)."""
    shape = a.shape
    a, b = a.reshape(shape[:-1] + (WARPS, 32)), b.reshape(shape[:-1] + (WARPS, 32))
    ia, ib = warp_inclusive_scan(a, b)
    ea, eb = _exclusive(ia, ib)
    pad = shape[:-1] + (32 - WARPS,)
    wa = np.concatenate([ia[..., 31], np.ones(pad, F)], axis=-1)
    wb = np.concatenate([ib[..., 31], np.zeros(pad, F)], axis=-1)
    wia, wib = warp_inclusive_scan(wa, wb)
    wea, web = _exclusive(wia, wib)
    pa, pb = compose((wea[..., :WARPS, None], web[..., :WARPS, None]), (ea, eb))
    total = (wia[..., WARPS - 1], wib[..., WARPS - 1])
    return (pa.reshape(shape), pb.reshape(shape)), total


def tree_carry(ta, tb, c):
    """y entering tile c: the aggregates of tiles 0..c-1 composed as the
    kernel's warp composes them — lane l takes the run [l·per, (l+1)·per),
    per = ceil(c / 32), in sequence, the lanes are scanned — applied to 0."""
    per = -(-c // 32)
    idx = np.arange(32)[:, None] * per + np.arange(per)[None, :]
    acc = (np.ones(32, F), np.zeros(32, F))
    for q in range(per):
        valid = idx[:, q] < c
        j = np.minimum(idx[:, q], max(c - 1, 0))
        na, nb = compose(acc, (ta[j], tb[j]))
        acc = (np.where(valid, na, acc[0]), np.where(valid, nb, acc[1]))
    return warp_inclusive_scan(*acc)[1][31]


def mirror_row(x, alpha, decay, start):
    """One row, one alpha: the kernel's output [T] in float32."""
    T = len(x)
    C = -(-T // TILE_LEN)
    xs = np.zeros(C * TILE_LEN, F)
    xs[:T] = np.nan_to_num(x.astype(F))
    xs = xs.reshape(C, TILE_THREADS, TILE_ITEMS)
    t = np.arange(C * TILE_LEN).reshape(xs.shape)
    valid = t < T
    ea = np.where(t <= start, F(0), F(decay)).astype(F)
    eb = np.where(t < start, F(0), np.where(t == start, xs, F(alpha) * xs)).astype(F)
    acc = (np.ones((C, TILE_THREADS), F), np.zeros((C, TILE_THREADS), F))
    for i in range(TILE_ITEMS):
        na, nb = compose(acc, (ea[..., i], eb[..., i]))
        acc = (np.where(valid[..., i], na, acc[0]), np.where(valid[..., i], nb, acc[1]))
    (pa, pb), (ta, tb) = block_exclusive_scan(*acc)
    carry = np.array([tree_carry(ta, tb, c) for c in range(C)], F)
    y = pa * carry[:, None] + pb
    out = np.empty(xs.shape, F)
    for i in range(TILE_ITEMS):
        y = ea[..., i] * y + eb[..., i]
        out[..., i] = np.where(t[..., i] < start, F(np.nan), y)
    return out.reshape(-1)[:T]


def mirror(x, alphas, start):
    """The kernel's result for one job: x [B, T] -> [K, B, T]."""
    alpha, decay = _coefficients(alphas)
    x = np.asarray(x, F)
    return np.stack([np.stack([mirror_row(row, a, d, start) for row in x])
                     for a, d in zip(alpha, decay)])


def assert_ewma_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-3)


def _walk(rng, B, T, level=100.0):
    return (level + np.cumsum(rng.normal(0, 1, (B, T)), axis=1)).astype(F)


ALPHAS = [2.0 / 13.0, 2.0 / 27.0, 1.0 / 14.0]


@pytest.mark.parametrize("T,start", [
    (37, 0),                            # shorter than one thread's items
    (TILE_LEN - 100, 1),                # shorter than a tile
    (3 * TILE_LEN + 123, 0),            # ragged
    (2 * TILE_LEN + 777, 25),           # ragged, seeded later
    (3 * TILE_LEN, TILE_LEN + 904),     # seed past the first tile
    (TILE_LEN + 1, TILE_LEN),           # seed on the last tile's only candle
])
def test_mirror_matches_plain(rng, T, start):
    x = _walk(rng, 3, T)
    ref = fused_ewma_plain(torch.from_numpy(x), ALPHAS, start).numpy()
    assert_ewma_close(mirror(x, ALPHAS, start), ref)


@pytest.mark.parametrize("start", [0, 1, 3, TILE_LEN + 5])
def test_mirror_nan_and_inf_inputs(start):
    pattern = np.array([np.nan, 1.0, np.inf, 3.0, np.nan, -np.inf, 2.0, 4.0], F)
    x = np.tile(pattern, (2 * TILE_LEN + 40) // 8)[None]
    ref = fused_ewma_plain(torch.from_numpy(x), [0.25], start).numpy()
    assert_ewma_close(mirror(x, [0.25], start), ref)


def test_mirror_of_several_jobs_matches_plain(rng):
    """Jobs of one launch do not interact: each has its own T, alphas and
    seed, and the mirror of each equals the plain version of each."""
    jobs = [(_walk(rng, 1, 5000), [2 / 13, 2 / 27], 0),
            (np.abs(rng.normal(0, 2, (3, 5000))).astype(F), [1 / 14], 1),
            (_walk(rng, 2, 9001, 40_000.0), [0.2], 25),
            (_walk(rng, 1, 333), ALPHAS, 2)]
    assert len(jobs) == MAX_JOBS
    plain = fused_ewma_jobs(jobs, device="cpu")
    for (x, alphas, start), ref in zip(jobs, plain):
        assert_ewma_close(mirror(x, alphas, start), ref.numpy())


def test_mirror_macd_line_at_a_high_price():
    """MACD cancels two EMAs of the close.  At a 40,000 price each EMA holds
    the tolerance; their difference moves by a few ulps of the price, and
    is held as chip_smoke.py holds the kernel: |Δ| <= 1e-3 + 2e-5·S, S the
    EMA of |close| (the magnitude the recursion sums)."""
    close = generate_ohlcv(n=3 * TILE_LEN + 11, seed=3)["close"]
    close = (close * (40_000.0 / close[0])).astype(F)[None]
    got = mirror(close, [2 / 13, 2 / 27], 0)
    ref = fused_ewma_plain(torch.from_numpy(close), [2 / 13, 2 / 27], 0).numpy()
    assert_ewma_close(got, ref)
    scale = fused_ewma_plain(torch.from_numpy(np.abs(close)), [2 / 27], 0).numpy()[0]
    diff = np.abs((got[0] - got[1]) - (ref[0] - ref[1]))
    assert (diff <= 1e-3 + 2e-5 * scale).all()


def test_mirror_matches_jax_ewm_and_pallas_interpret(rng):
    x = _walk(rng, 8, 2 * TILE_LEN + 256)   # the Pallas kernel takes T % 256 == 0
    ewm = jax.jit(jind._ewm, static_argnums=(1, 2))
    for start in (0, 1, 25):
        got = mirror(x, ALPHAS, start)
        ref = np.stack([np.asarray(ewm(jnp.asarray(x), a, start)) for a in ALPHAS])
        assert_ewma_close(got, ref)
    pallas = jax_fused_ewma(jnp.asarray(x), ALPHAS, force_pallas=True, interpret=True)
    assert_ewma_close(mirror(x, ALPHAS, 0), pallas)


def test_block_scan_mirror_is_an_exclusive_scan(rng):
    """The scan's prefixes compose in thread order: with maps that commute
    exactly (a = 1, b small integers) they are plain prefix sums."""
    b = rng.integers(-50, 50, (3, TILE_THREADS)).astype(F)
    (pa, pb), (ta, tb) = block_exclusive_scan(np.ones_like(b), b)
    np.testing.assert_array_equal(pb, np.cumsum(b, axis=-1) - b)
    np.testing.assert_array_equal(tb, b.sum(-1))
    assert (pa == 1).all() and (ta == 1).all()


@pytest.mark.parametrize("c", [0, 1, 31, 32, 33, 128, 300])
def test_tree_carry_composes_every_earlier_tile_once(rng, c):
    """With maps that commute exactly (a = 1, b small integers) the carry
    into tile c is the sum of the c earlier b's: every aggregate composed
    once, none after the tile."""
    tb = rng.integers(-50, 50, 301).astype(F)
    assert tree_carry(np.ones_like(tb), tb, c) == tb[:c].sum()


def test_jobs_plain_is_a_loop_of_fused_ewma_plain(rng):
    jobs = [(_walk(rng, 1, 700), [2 / 13, 2 / 27], 0),
            (rng.normal(0, 1, (3, 700)).astype(F), [1 / 14], 1),
            (_walk(rng, 2, 123), [0.2], 25)]
    got = fused_ewma_jobs(jobs, device="cpu")
    for (x, alphas, start), g in zip(jobs, got):
        ref = fused_ewma_plain(torch.from_numpy(x), alphas, start)
        assert torch.equal(g.view(torch.int32), ref.view(torch.int32))


def test_jobs_keep_leading_shapes(rng):
    x3 = rng.normal(100, 1, (2, 3, 50)).astype(F)
    x1 = rng.normal(100, 1, 50).astype(F)
    a, b = fused_ewma_jobs([(x3, [0.1, 0.2], 0), (x1, [0.3], 4)], device="cpu")
    assert a.shape == (2, 2, 3, 50) and b.shape == (1, 50)
    ref = fused_ewma(x1, [0.3], 4, device="cpu")
    assert torch.equal(b.view(torch.int32), ref.view(torch.int32))


def test_tile_count():
    assert tile_count([(1, 525_600), (3, 525_600)]) == 4 * 129
    assert tile_count([(2, TILE_LEN), (1, TILE_LEN + 1), (5, 1)]) == 2 + 2 + 5


def test_compute_indicators_makes_two_ewma_launches(monkeypatch):
    """The table's EMA family is one job list of two jobs and one single
    job, both the kernel's launches on the card."""
    calls = []

    def jobs_spy(jobs, device=None):
        calls.append([(np.shape(x), list(a), s) for x, a, s in jobs])
        return fused_ewma_jobs(jobs, device=device)

    monkeypatch.setattr(ind_mod, "fused_ewma_jobs", jobs_spy)
    monkeypatch.setattr(ewma_mod, "fused_ewma_jobs", jobs_spy)
    d = generate_ohlcv(n=600, seed=3)
    compute_indicators(d, device="cpu")
    assert [[(s, len(a), st) for s, a, st in c] for c in calls] == [
        [((600,), 2, 0), ((3, 600), 1, 1)], [((600,), 1, 25)]]
