"""The port's LOB agent, `lob_sweep` and calibration against the JAX
package, on the CPU.

    rollout_lob, lob_sweep ↔ sim.lob (on JAX's flow draws, handed over);
    the queue gate and queue priority; calibrate ↔ sim.calibrate.

Tolerances, from float32's unit roundoff u = 2^-24 (tests/test_torch_sim.py
derives the market's):
  * the market (the mid path, the book, the candles) differs from JAX's by
    ulps — each package's ``exp``, and `_sweep_side`'s and
    `_queue_update`'s sums over the levels in another order — and the
    grid roll may flip by a tick where its ratio sits within 4 ulps of a
    half tick.  Every flip is counted and bounded; after a scenario's first
    flip its book legitimately diverges, so it is compared up to there,
    and a scenario without a flip whole;
  * up to the first flip: each fill's step, tag and side equal, its price
    within the mid's bound at that step plus the spread factor's and the
    product's roundings, (4(t + 1) + 4)·u relative; its quantity and fee
    within (4(t + 1) + 8)·(2k + 1)·u for the k-th fill of the log (each
    earlier fill moves the quote, and so the next entry's size, by at most
    its own price error);
  * whole scenarios: counts equal; quote, equity and minimum equity within
    (4(T + 1) + 8)·(2n + 1)·u·quote0 absolute (n the scenario's fills),
    base and fees within the same factor of Σ|qty| and Σ fees, the
    drawdown within twice the money bound over quote0; the mean spread
    within T·u relative (the same per-step spreads summed in another
    order); the touch depth's mean and the traded volume within their
    per-step bound L·u·D (D the steady book's depth) plus T·u relative for
    the sum; with ``return_book`` the sizes within L·u·D and best bid and
    ask within the mid's bound plus 4u;
  * the calibration fit is float64 host math on the same records: the
    fitted FlowParams bit for bit, the report's float64 entries within
    1e-12 relative; the book analytics are float32 tensor programs against
    JAX's: near pressure within 8u, the microprice tilt within 1e4·8u bps
    and the impact curve within 16u, absolute (each a ratio of float32
    sums of a handful of positive terms).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ai_crypto_trader_tpu.parallel.partitioner import SingleDevicePartitioner as JaxSingle  # noqa: E402,E501
from ai_crypto_trader_tpu.sim import calibrate as jcal  # noqa: E402
from ai_crypto_trader_tpu.sim import engine as jengine  # noqa: E402
from ai_crypto_trader_tpu.sim import lob as jlob  # noqa: E402
from ai_crypto_trader_tpu.sim import scenarios as jsc  # noqa: E402
from ai_crypto_trader_tpu.testing import chaos  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel.partitioner import SingleDevicePartitioner  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import calibrate, lob  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import exchange as sx  # noqa: E402
from test_torch_sim import FLIP_TICKS, U, JaxMarketDraws, _steady_total, lob_flips  # noqa: E402

L = lob.DEFAULT_LEVELS
Q0 = 10_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STRAT = jengine.default_strategy(sl_pct=1.0, tp_pct=0.3)


def _pair(queue_frac, B, T, return_book, seed=1, key=5):
    sched, _ = jsc.mixed_schedules(None, B, T, seed=seed)
    k = jax.random.PRNGKey(key)
    ref = jlob.rollout_lob(k, sched, flow=jlob.flow_params(queue_frac=queue_frac),
                           strategy=STRAT, return_book=return_book)
    got = lob.rollout_lob(JaxMarketDraws(k), sched,
                          flow=lob.flow_params(queue_frac=queue_frac, device="cpu"),
                          strategy=convert.sim_strategy_from_jax(STRAT, device="cpu"),
                          return_book=return_book, device="cpu")
    return got, jax.tree.map(np.asarray, ref), sched


def _flips(got_candle, ref_candle):
    flips, dist, first = lob_flips({k: got_candle[k] for k in ("open", "close")},
                                   {k: ref_candle[k] for k in ("open", "close")})
    assert all(d <= FLIP_TICKS for d in dist), (flips.tolist(), dist)
    return flips, first


def assert_summary_follows(gs, rs, T, first, fills=None):
    """The summaries of the scenarios without a flip, within the module
    docstring's bounds; returns how many were compared."""
    D = _steady_total()
    whole = [b for b in range(len(first)) if first[b] == T]
    for b in whole:
        n = int(rs["n_fills"][b])
        for k in ("n_fills", "dropped_fills", "entries"):
            assert gs[k][b] == rs[k][b], (k, b)
        f = (4 * (T + 1) + 8) * (2 * n + 1) * U
        money = f * Q0
        for k in ("final_equity", "final_quote", "min_equity"):
            assert abs(float(gs[k][b]) - float(rs[k][b])) <= money, (k, b)
        if fills is not None:
            log = fills[b][:n].astype(np.float64)
            assert abs(float(gs["final_base"][b]) - float(rs["final_base"][b])) <= \
                f * np.abs(log[:, 3]).sum() + 1e-30, b
            assert abs(float(gs["fees"][b]) - float(rs["fees"][b])) <= f * log[:, 5].sum(), b
        assert abs(float(gs["max_drawdown"][b]) - float(rs["max_drawdown"][b])) <= 2 * money / Q0
        assert abs(float(gs["mean_spread"][b]) - float(rs["mean_spread"][b])) <= \
            T * U * float(rs["mean_spread"][b])
        for k in ("mean_top_depth", "traded_volume"):
            scale = T if k == "traded_volume" else 1
            assert abs(float(gs[k][b]) - float(rs[k][b])) <= \
                scale * L * U * D + T * U * float(rs[k][b]), (k, b)
    return len(whole)


def assert_fills_follow(got_fills, ref_fills, n_ref, first):
    """Every fill before its scenario's first flip, within the bounds."""
    compared = 0
    for b in range(len(first)):
        rf = ref_fills[b][:int(n_ref[b])]
        rf = rf[rf[:, 0] < first[b]]
        gf = got_fills[b][:len(rf)]
        np.testing.assert_array_equal(gf[:, :3], rf[:, :3], err_msg=f"scenario {b}")
        t = rf[:, 0].astype(np.float64)
        k = np.arange(len(rf))
        rel = lambda c: np.abs(gf[:, c].astype(np.float64) - rf[:, c]) / np.abs(rf[:, c])  # noqa: E731
        assert (rel(4) <= (4 * (t + 1) + 4) * U).all(), b
        for c in (3, 5):
            assert (rel(c) <= (4 * (t + 1) + 8) * (2 * k + 1) * U).all(), (b, c)
        compared += len(rf)
    return compared


@pytest.mark.parametrize("queue_frac,return_book", [(0.0, True), (1.0, False), (0.5, True)])
def test_rollout_lob_follows_jax(queue_frac, return_book):
    B, T = 8, 256
    got, ref, _ = _pair(queue_frac, B, T, return_book)
    gser, rser = got["series"], ref["series"]
    flips, first = _flips(gser["candle"], rser["candle"])
    print(f"rollout_lob queue_frac={queue_frac}: flips {flips.tolist()}")
    n = assert_fills_follow(got["fills"], ref["fills"], ref["summary"]["n_fills"], first)
    assert n >= 20, "too few fills compared"
    whole = assert_summary_follows(got["summary"], ref["summary"], T, first, ref["fills"])
    assert whole >= B // 2
    D = _steady_total()
    mid_bound = 4.0 * (np.arange(T) + 1) * U
    for b in range(B):
        f = first[b]
        np.testing.assert_array_equal(gser["spread"][b, :f], rser["spread"][b, :f])
        assert np.abs(gser["cap"][b, :f] - rser["cap"][b, :f]).max(initial=0) <= L * U * D
        if f == T:
            n_b = int(ref["summary"]["n_fills"][b])
            money = (4 * (T + 1) + 8) * (2 * n_b + 1) * U * Q0
            assert np.abs(gser["equity"][b] - rser["equity"][b]).max() <= money
    if return_book:
        for b in range(B):
            f = first[b]
            for k in ("bid_sz", "ask_sz"):
                assert np.abs(gser[k][b, :f] - rser[k][b, :f]).max(initial=0) <= L * U * D
            for k in ("best_bid", "best_ask"):
                rel = np.abs(gser[k][b, :f].astype(np.float64) - rser[k][b, :f]) / rser[k][b, :f]
                assert (rel <= mid_bound[:f] + 4 * U).all(), (k, b)
        assert gser["bid_sz"].shape == (B, T, L)
    else:
        assert "bid_sz" not in gser
    assert set(gser) == set(rser) and set(gser["candle"]) == set(rser["candle"])


def test_lob_sweep_follows_jax(monkeypatch):
    """One host read; stats as JAX's (events B·T·(4L + 2)); the summary
    within the bounds; the device series equal to `rollout_lob`'s on the
    same draws bit for bit."""
    B, T = 8, 128
    key = jax.random.PRNGKey(6)
    kw = dict(scenario="mixed", num_scenarios=B, steps=T, seed=3)
    ref = jlob.lob_sweep(key, strategy=STRAT, partitioner=JaxSingle(), **kw)
    reads = []
    real = lob.host_read
    monkeypatch.setattr(lob, "host_read", lambda rb: reads.append(1) or real(rb))
    strat = convert.sim_strategy_from_jax(STRAT, device="cpu")
    got = lob.lob_sweep(JaxMarketDraws(key), strategy=strat, device="cpu", **kw)
    assert len(reads) == 1
    assert got["labels"] == ref["labels"]
    assert {k: v for k, v in got["stats"].items() if k != "wall_s"} == \
        {k: v for k, v in ref["stats"].items() if k != "wall_s"}
    assert got["stats"]["events"] == B * T * (4 * L + 2)
    dev = {k: v.numpy() for k, v in got["device"].items()}
    rdev = {k: np.asarray(v) for k, v in ref["device"].items()}
    assert set(dev) == set(rdev) and all(v.shape == (B, T) for v in dev.values())
    _flips_, first = _flips({"open": np.concatenate([np.full((B, 1), np.float32(40_000.0)),
                                                     dev["close"][:, :-1]], 1),
                             "close": dev["close"]},
                            {"open": np.concatenate([np.full((B, 1), np.float32(40_000.0)),
                                                     rdev["close"][:, :-1]], 1),
                             "close": rdev["close"]})
    assert assert_summary_follows(got["summary"], jax.tree.map(np.asarray, ref["summary"]),
                                  T, first) >= B // 2
    sched, _ = jsc.mixed_schedules(None, B, T, seed=3)
    one = lob.rollout_lob(JaxMarketDraws(key), sched, strategy=strat, device="cpu")
    for k, v in one["summary"].items():
        np.testing.assert_array_equal(got["summary"][k], v, err_msg=k)
    np.testing.assert_array_equal(dev["equity_curve"], one["series"]["equity"])
    np.testing.assert_array_equal(dev["close"], one["series"]["candle"]["close"])


def test_lob_sweep_refuses_other_partitioners():
    from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, make_mesh

    g = torch.Generator().manual_seed(0)
    with pytest.raises(TypeError, match="not a partitioner"):
        lob.lob_sweep(g, num_scenarios=2, steps=8, partitioner=object(), device="cpu")
    for p in (None, SingleDevicePartitioner()):
        out = lob.lob_sweep(g, num_scenarios=2, steps=8, partitioner=p, device="cpu")
        assert out["stats"]["devices"] == 1 and np.isfinite(out["summary"]["final_equity"]).all()
    mesh = MeshPartitioner(make_mesh(2, devices=["cpu"] * 2))
    runs = [lob.lob_sweep(torch.Generator().manual_seed(1), num_scenarios=3, steps=8,
                          partitioner=p, device="cpu") for p in (None, mesh)]
    assert runs[1]["stats"]["devices"] == 2
    for k, v in runs[0]["summary"].items():
        np.testing.assert_array_equal(runs[1]["summary"][k], v, err_msg=k)


def test_gate_none_equals_all_true_and_a_false_gate_blocks():
    st = sx.init_state(1_000.0, K=2, L=16, device="cpu")
    act = sx.no_action(2, device="cpu")._replace(
        place=torch.tensor([[True, False]]),
        side=torch.full((1, 2), sx.BUY, dtype=torch.int32),
        kind=torch.full((1, 2), sx.LIMIT, dtype=torch.int32),
        qty=torch.tensor([[1.0, 0.0]]), limit_price=torch.tensor([[100.0, 0.0]]))
    candle = {"open": torch.tensor([100.0]), "high": torch.tensor([101.0]),
              "low": torch.tensor([99.0]), "close": torch.tensor([100.0])}
    z, f, inf = torch.zeros(1), torch.tensor(0.001), torch.tensor(float("inf"))
    st = sx.apply_action(st, candle, 0, act, f, z, z, z)
    a = sx.match_candle(st, candle, 1, inf, z, f)
    b = sx.match_candle(st, candle, 1, inf, z, f, gate=torch.ones((1, 2), dtype=torch.bool))
    for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)
    c = sx.match_candle(st, candle, 1, inf, z, f, gate=torch.tensor([[False, True]]))
    assert bool(c.book.active[0, 0]) and not bool(a.book.active[0, 0])


def test_queue_priority_delays_or_cuts_fills():
    """With ``queue_frac = 1`` a resting TP waits for the queue ahead of it
    to trade through: no more fills than at the front of the queue, on the
    same market (the candles bit for bit)."""
    sched = jsc.compile_schedules("calm", 4, 512, seed=11)
    kw = dict(strategy=convert.sim_strategy_from_jax(STRAT, device="cpu"), device="cpu")
    front = lob.rollout_lob(torch.Generator().manual_seed(1), sched,
                            flow=lob.flow_params(queue_frac=0.0, device="cpu"), **kw)
    back = lob.rollout_lob(torch.Generator().manual_seed(1), sched,
                           flow=lob.flow_params(queue_frac=1.0, device="cpu"), **kw)
    nf_f, nf_b = front["summary"]["n_fills"].sum(), back["summary"]["n_fills"].sum()
    assert nf_f > 0 and nf_b <= nf_f
    assert not np.array_equal(front["fills"], back["fills"]), "the queue changed nothing"
    np.testing.assert_array_equal(front["series"]["candle"]["close"],
                                  back["series"]["candle"]["close"])


def _records(T=256, key=11):
    sched = jsc.compile_schedules("calm", 1, T, seed=0)
    out = jlob.rollout_lob(jax.random.PRNGKey(key), sched, return_book=True)
    return jax.tree.map(np.asarray, out["series"])


@pytest.mark.parametrize("levels,stride", [(None, 2), (12, 1)])
def test_fit_flow_params_matches_jax(levels, stride):
    series = _records()
    recs = jcal.records_from_lob_series(series, tick=1e-4, stride=stride, levels=levels)
    assert calibrate.records_from_lob_series(series, tick=1e-4, stride=stride,
                                             levels=levels) == recs
    jflow, jrep = jcal.fit_flow_params(recs, queue_frac=0.25)
    tflow, trep = calibrate.fit_flow_params(recs, queue_frac=0.25, device="cpu")
    for k in jlob.FlowParams._fields:
        assert np.asarray(getattr(jflow, k)).view(np.int32) == \
            getattr(tflow, k).numpy().view(np.int32), k
    assert set(trep) == set(jrep)
    analytics = {"mean_near_pressure": 8 * U, "mean_microprice_tilt_bps": 1e4 * 8 * U,
                 "mean_impact_curve": 16 * U}
    for k, v in jrep.items():
        if isinstance(v, str):
            assert trep[k] == v
        elif k in analytics:
            np.testing.assert_allclose(trep[k], v, rtol=0, atol=analytics[k], err_msg=k)
        else:
            np.testing.assert_allclose(trep[k], v, rtol=1e-12, atol=0, err_msg=k)
    assert trep["mean_impact_curve"].shape == (3,)
    rep = calibrate.fit_report_only(recs, queue_frac=0.25, device="cpu")
    assert rep.keys() == trep.keys()
    flow = convert.flow_params_from_jax(jflow, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flow, tflow))


def test_fit_from_the_ports_own_book_runs_a_sweep():
    """The loop on the port alone: its LOB's book → depth records → fitted
    flow → a `lob_sweep` in that flow."""
    sched = jsc.compile_schedules("calm", 1, 300, seed=2)
    out = lob.rollout_lob(torch.Generator().manual_seed(3), sched,
                          flow=lob.flow_params(limit_rate=3.0, depth_decay=0.15,
                                               cancel_rate=0.1, vol=0.0, device="cpu"),
                          return_book=True, device="cpu")
    recs = calibrate.records_from_lob_series(out["series"], tick=1e-4)
    calibrate.validate_depth_records(recs)
    fitted, report = calibrate.fit_flow_params(recs, device="cpu")
    np.testing.assert_allclose(float(fitted.tick), 1e-4, rtol=0.05)
    np.testing.assert_allclose(float(fitted.spread0), 1.0, rtol=0.05)
    np.testing.assert_allclose(float(fitted.depth_decay), 0.15, rtol=0.25)
    assert report["frames"] == 300
    sw = lob.lob_sweep(torch.Generator().manual_seed(4), num_scenarios=4, steps=32, flow=fitted,
                       device="cpu")
    assert np.isfinite(sw["summary"]["final_equity"]).all()


def _diff_records():
    return [{"symbol": "BTCUSDC", "kind": "diff", "E": i, "U": i, "u": i,
             "bids": [[100.0, 0.0]], "asks": [[100.1, 2.0]]} for i in range(10)]


def _one_level():
    return [{"symbol": "BTCUSDC", "kind": "snapshot", "E": 0, "u": 0,
             "bids": [[100.0, 1.0]], "asks": [[101.0, 1.0]]}] * 3


def _four_levels():
    return [{"symbol": "BTCUSDC", "kind": "snapshot", "E": 0, "u": 0,
             "bids": [[100.0 - i, 1.0] for i in range(4)],
             "asks": [[101.0 + i, 1.0] for i in range(4)]}] * 3


@pytest.mark.parametrize("case", ["no_frames", "diff_records", "symbol_miss", "one_level"])
def test_fit_rejections_match_jax(case):
    recs, kw = {"no_frames": ([], {}), "diff_records": (_diff_records(), {}),
                "symbol_miss": (_four_levels(), {"symbol": "ETHUSDC"}),
                "one_level": (_one_level(), {})}[case]
    with pytest.raises(ValueError) as jerr:
        jcal.fit_flow_params(recs, **kw)
    with pytest.raises(ValueError) as terr:
        calibrate.fit_flow_params(recs, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("mode", ["nan_spread", "zero_depth", "crossed", "too_few"])
def test_poisoned_windows_are_refused_as_in_jax(mode):
    recs = (chaos.poisoned_depth_records(n=1, mode="crossed")[:0] if mode == "too_few"
            else chaos.poisoned_depth_records(mode=mode))
    with pytest.raises(jcal.CalibrationPoisoned) as jerr:
        jcal.validate_depth_records(recs)
    with pytest.raises(calibrate.CalibrationPoisoned) as terr:
        calibrate.validate_depth_records(recs)
    assert str(terr.value) == str(jerr.value)
    assert calibrate.validate_depth_records(_four_levels()) is None
