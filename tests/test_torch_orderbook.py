"""The port's order-book analytics against the JAX package's, on the CPU.

Seeded books (bids descending, asks ascending; 20 and 100 levels, a
batch of [4, 3] books, an empty side) through both packages: float32
reductions over levels may sum in another order, so values are held at
rtol 1e-5 (masks, counts, labels and the signal's label exactly).
`cluster_orders` runs on the JAX package's k-means draw.  `sim.calibrate`
reads its window through the same `_pressure` / `_impact`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu.ops import orderbook as ref
from ai_crypto_trader_tpu_torch.ops import orderbook as ob

RTOL = 1e-5
# the microprice's tilt from the mid, in bps, is a difference of two prices
# of the same magnitude: an ulp of either moves it by ~2^-23·1e4 bps, so it
# is held to 8 such ulps (the summed sizes it weighs may round differently)
ATOL = {"microprice_tilt_bps": 8 * 2.0 ** -23 * 1e4,
        # impact |avg fill − best| / best, the same cancellation: 8 ulps of 1
        "impact": 8 * 2.0 ** -23}


def _book(rng, n, mid=40_000.0, tick=0.5, walls=()):
    bid_sz = rng.lognormal(0.0, 0.6, n)
    ask_sz = rng.lognormal(0.0, 0.6, n)
    for side, lvl, mult in walls:
        (bid_sz if side == "bid" else ask_sz)[lvl] *= mult
    bids = np.stack([mid - tick / 2 - tick * np.arange(n), bid_sz], axis=1)
    asks = np.stack([mid + tick / 2 + tick * np.arange(n), ask_sz], axis=1)
    return bids.astype(np.float32), asks.astype(np.float32)


BOOKS = {
    "n20": dict(n=20, seed=0),
    "n100_walls": dict(n=100, seed=1, walls=(("bid", 3, 12.0), ("bid", 40, 9.0),
                                             ("ask", 7, 15.0))),
    "n100_ask_heavy": dict(n=100, seed=2, walls=(("ask", 2, 20.0), ("ask", 5, 20.0))),
}


def _case(name):
    kw = dict(BOOKS[name])
    rng = np.random.default_rng(kw.pop("seed"))
    return _book(rng, **kw)


def _close(got, want, label):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL.get(label, 0.0), err_msg=label)


@pytest.mark.parametrize("name", sorted(BOOKS))
def test_imbalance_pressure_gini_walls(name):
    bids, asks = _case(name)
    for k, v in ref.imbalance(jnp.asarray(bids), jnp.asarray(asks)).items():
        _close(ob.imbalance(bids, asks, device="cpu")[k], v, k)
    for k, v in ref.pressure_metrics(jnp.asarray(bids), jnp.asarray(asks)).items():
        _close(ob.pressure_metrics(bids, asks, device="cpu")[k], v, k)
    for side in (bids, asks):
        _close(ob.gini_concentration(side, device="cpu"), ref.gini_concentration(side), "gini")
        np.testing.assert_array_equal(ob.find_walls(side, device="cpu").numpy(),
                                      np.asarray(ref.find_walls(jnp.asarray(side))))
        np.testing.assert_array_equal(ob.find_walls(side, 2.0, device="cpu").numpy(),
                                      np.asarray(ref.find_walls(jnp.asarray(side), 2.0)))


@pytest.mark.parametrize("name", sorted(BOOKS))
def test_price_impact_over_a_size_ladder(name):
    bids, asks = _case(name)
    depth = float((asks[:, 0] * asks[:, 1]).sum())
    sizes = np.array(ref.DEFAULT_TRADE_SIZES + (0.3 * depth, 2.0 * depth), np.float32)
    for side in (bids, asks):
        got = ob.price_impact(side, sizes, device="cpu").numpy()
        want = np.asarray(ref.price_impact(jnp.asarray(side), jnp.asarray(sizes)))
        assert got.shape == want.shape == (len(sizes),)
        _close(got, want, "impact")


def test_batched_books_follow_the_jax_batch():
    rng = np.random.default_rng(5)
    pairs = [_book(rng, 32, mid=100.0 + 7 * i, tick=0.01) for i in range(12)]
    bids = np.stack([b for b, _ in pairs]).reshape(4, 3, 32, 2)
    asks = np.stack([a for _, a in pairs]).reshape(4, 3, 32, 2)
    sizes = np.array([50.0, 200.0, 1e4], np.float32)
    got = ob.price_impact(asks, sizes, device="cpu").numpy()
    want = np.asarray(ref.price_impact(jnp.asarray(asks), jnp.asarray(sizes)))
    assert got.shape == want.shape == (4, 3, 3)
    _close(got, want, "impact")
    np.testing.assert_array_equal(ob.find_walls(bids, 1.5, device="cpu").numpy(),
                                  np.asarray(ref.find_walls(jnp.asarray(bids), 1.5)))
    mine = ob.pressure_metrics(bids, asks, near_levels=3, device="cpu")
    theirs = ref.pressure_metrics(jnp.asarray(bids), jnp.asarray(asks), near_levels=3)
    for k, v in theirs.items():
        assert mine[k].shape == v.shape == (4, 3)
        _close(mine[k], v, k)
    # every book of the batch is the book alone
    for i in range(4):
        for j in range(3):
            np.testing.assert_array_equal(
                got[i, j], ob.price_impact(asks[i, j], sizes, device="cpu").numpy())


def test_an_empty_side_and_zero_sizes_stay_finite():
    bids, asks = _case("n20")
    asks = asks.copy()
    asks[:, 1] = 0.0
    for k, v in ref.imbalance(jnp.asarray(bids), jnp.asarray(asks)).items():
        _close(ob.imbalance(bids, asks, device="cpu")[k], v, k)
    _close(ob.gini_concentration(asks, device="cpu"), ref.gini_concentration(asks), "gini")
    got = ob.price_impact(asks, np.array([10.0], np.float32), device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.price_impact(
        jnp.asarray(asks), jnp.asarray([10.0], jnp.float32))))


@pytest.mark.parametrize("name", sorted(BOOKS))
def test_orderbook_signal_and_flags(name):
    bids, asks = _case(name)
    got, want = ob.orderbook_signal(bids, asks, device="cpu"), ref.orderbook_signal(bids, asks)
    assert got["signal"] == want["signal"] and got.keys() == want.keys()
    assert (got["bid_walls"], got["ask_walls"]) == (want["bid_walls"], want["ask_walls"])
    for k in ("score", "gini_bids", "gini_asks"):
        _close(got[k], want[k], k)
    for group in ("imbalance", "pressure"):
        assert got[group].keys() == want[group].keys()
        for k, v in want[group].items():
            _close(got[group][k], v, k)
    mid = float((bids[0, 0] + asks[0, 0]) / 2)
    assert ob.microstructure_flags(bids, mid, 0.01) == ref.microstructure_flags(bids, mid, 0.01)
    flat = bids.copy()
    flat[:, 1] = 1.0
    assert ob.microstructure_flags(flat, mid)["iceberg_suspected"] is True
    assert ob.microstructure_flags(flat, mid) == ref.microstructure_flags(flat, mid)


def test_signal_labels_buy_and_sell():
    rng = np.random.default_rng(9)
    bids, asks = _book(rng, 50, walls=(("bid", 1, 30.0), ("bid", 2, 30.0)))
    for b, a, label in ((bids, asks, "BUY"), (asks * [1, 1], bids * [1, 1], None)):
        got, want = ob.orderbook_signal(b, a, device="cpu"), ref.orderbook_signal(b, a)
        assert got["signal"] == want["signal"]
        if label:
            assert got["signal"] == label
    heavy_asks = asks.copy()
    heavy_asks[:5, 1] *= 40.0
    got, want = ob.orderbook_signal(bids * [1, 0.1], heavy_asks, device="cpu"), \
        ref.orderbook_signal(bids * [1, 0.1], heavy_asks)
    assert got["signal"] == want["signal"] == "SELL"


def _jax_index(n, seed):
    _, k0 = jax.random.split(jax.random.PRNGKey(seed))
    return int(jax.random.randint(k0, (), 0, n))


@pytest.mark.parametrize("name,k,seed", [("n20", 3, 0), ("n100_walls", 3, 1),
                                         ("n100_ask_heavy", 4, 2)])
def test_cluster_orders_on_the_jax_draw(name, k, seed):
    bids, asks = _case(name)
    for side in (bids, asks):
        want = ref.cluster_orders(side, k=k, seed=seed)
        got = ob.cluster_orders(side, k=k, key=_jax_index(len(side), seed), device="cpu")
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert len(got["clusters"]) == len(want["clusters"])
        for g, w in zip(got["clusters"], want["clusters"]):
            assert g["n_levels"] == w["n_levels"]
            np.testing.assert_allclose([g["center_price"], g["total_size"]],
                                       [w["center_price"], w["total_size"]], rtol=1e-6)
    # the seed's own generator draw: deterministic and well formed
    a = ob.cluster_orders(bids, k=k, seed=seed, device="cpu")
    b = ob.cluster_orders(bids, k=k, seed=seed, device="cpu")
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert sum(c["n_levels"] for c in a["clusters"]) == len(bids)


def test_calibrate_reads_its_window_through_the_orderbook_ops():
    from ai_crypto_trader_tpu_torch.sim import calibrate

    assert calibrate._pressure is ob._pressure and calibrate._impact is ob._impact
    rng = np.random.default_rng(4)
    frames = [_book(rng, 10, mid=100.0 + 0.01 * i, tick=0.01) for i in range(6)]
    records = [{"symbol": "X", "kind": "snapshot", "bids": b.tolist(), "asks": a.tolist()}
               for b, a in frames]
    _, report = calibrate.fit_flow_params(records, device="cpu")
    b = torch.tensor(np.stack([f[0] for f in frames]).astype(np.float64), dtype=torch.float32)
    a = torch.tensor(np.stack([f[1] for f in frames]).astype(np.float64), dtype=torch.float32)
    pres = ob.pressure_metrics(b, a, device="cpu")
    assert report["mean_near_pressure"] == float(np.mean(pres["near_pressure"].numpy()))
