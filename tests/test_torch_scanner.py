"""The port's market scanner against the JAX package's, on the CPU.

    exchange klines → MarketScanner.scan: score_pairs over [P, T]
    (compute_indicators, signal features, the score) → one host read →
    the ranking; `cli scan`

Volatilities, quote volumes and changes follow the jitted JAX
`score_pairs` at rtol 1e-5, the signals and the eligibility exactly; the
strength carries min(|MACD|, 1)·20 and gets test_torch_tick.py's bound for
it (`_tolerance`, from JAX's own MACD), the score that bound over 100; the
ranking is equal.
"""

import contextlib
import io
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu import cli as jcli  # noqa: E402
from ai_crypto_trader_tpu import ops as jops  # noqa: E402
from ai_crypto_trader_tpu.data.ingest import from_dict as jfrom_dict  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import scanner as jscan  # noqa: E402
from ai_crypto_trader_tpu_torch import cli as tcli  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import from_dict as tfrom_dict  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import scanner as tscan  # noqa: E402
from test_torch_tick import _tolerance  # noqa: E402

P, LOOKBACK = 24, 128


def _universe(ex_mod, from_dict, pairs=P, lookback=LOOKBACK, seed=0):
    """`cli scan`'s paper universe: pairs with varied volatility and volume."""
    n_hist = lookback + 8
    series = {}
    for i in range(pairs):
        sym = f"A{i:03d}USDC"
        d = generate_ohlcv(n=n_hist, seed=seed + i, s0=100.0 * (1 + i),
                           base_vol=0.0004 * (1 + (i % 9)), base_volume=40.0 * (1 + (i % 13)))
        series[sym] = from_dict({k: v for k, v in d.items() if k != "regime"}, symbol=sym)
    ex = ex_mod.make_exchange("fake", series=series)
    ex.advance(steps=n_hist)
    return ex


def _batch(ex, lookback=LOOKBACK):
    cols = {k: [] for k in ("open", "high", "low", "close", "volume")}
    for sym in ex.list_symbols():
        arr = np.asarray(ex.get_klines(sym, limit=lookback), np.float64)[:, 1:6]
        for j, k in enumerate(cols):
            cols[k].append(arr[:, j].astype(np.float32))
    return {k: np.stack(v) for k, v in cols.items()}


@pytest.mark.parametrize("band", [(0.001, 0.05, 50_000.0), (0.003, 0.004, 1_000.0),
                                  (0.002, 0.002, 10.0)])
def test_score_pairs_follows_jax(band):
    vmin, vmax, mqv = band
    batch = _batch(_universe(jex, jfrom_dict))
    ref = jscan.score_pairs({k: jnp.asarray(v) for k, v in batch.items()},
                            min_quote_volume=mqv, min_volatility=vmin, max_volatility=vmax)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tscan.host_read(tscan.score_pairs(batch, min_quote_volume=mqv, min_volatility=vmin,
                                            max_volatility=vmax, device="cpu"))
    assert set(got) == set(ref)
    for k in ("signal", "eligible"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("volatility", "quote_volume", "change_pct"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0.0, err_msg=k)
    # the strength's MACD term: test_torch_tick.py's bound on JAX's MACD
    macd = np.asarray(jops.compute_indicators({k: jnp.asarray(v) for k, v in batch.items()})
                      ["macd"])[:, -1]
    rtol, atol = _tolerance("signal_strength", {"current_price": batch["close"][:, -1],
                                                "macd": macd})
    bad = np.abs(got["strength"] - ref["strength"]) > atol + rtol * np.abs(ref["strength"])
    assert not bad.any(), (got["strength"][bad], ref["strength"][bad])
    bad = np.abs(got["score"] - ref["score"]) > 1e-6 + 1e-5 * np.abs(ref["score"]) + atol / 100
    assert not bad.any(), (got["score"][bad], ref["score"][bad])
    if band[0] < band[1]:
        assert ref["eligible"].any() and not ref["eligible"].all()


def test_scan_ranks_like_jax():
    ranked = {}
    for pkg, (ex_mod, from_dict, scan_mod, kw) in {
            "jax": (jex, jfrom_dict, jscan, {}),
            "port": (tex, tfrom_dict, tscan, {"device": "cpu"})}.items():
        ex = _universe(ex_mod, from_dict)
        sc = scan_mod.MarketScanner(ex, lookback=LOOKBACK, top_k=8, **kw)
        ranked[pkg] = (sc.scan(), sc.top_symbols(["A001USDC", "A005USDC", "NOPE"]), sc.discover())
    assert [o["symbol"] for o in ranked["port"][0]] == [o["symbol"] for o in ranked["jax"][0]]
    assert ranked["port"][1:] == ranked["jax"][1:]
    for g, r in zip(ranked["port"][0], ranked["jax"][0]):
        assert g["signal"] == r["signal"]
        for k in ("volatility", "quote_volume", "change_pct"):
            assert g[k] == pytest.approx(r[k], rel=1e-5, abs=1e-6), k
        # the score's MACD term: at most 20·(1e-3 + 2e-6·close)/100 apart
        close = ex.get_ticker(g["symbol"])["price"]
        assert abs(g["score"] - r["score"]) <= 1e-6 + 1e-5 * abs(r["score"]) \
            + 0.2 * (1e-3 + 2e-6 * close), g["symbol"]
    assert len(ranked["port"][0]) >= 3


def test_scan_reads_the_host_once(monkeypatch):
    reads = []
    real = tscan.host_read
    monkeypatch.setattr(tscan, "host_read", lambda out: reads.append(1) or real(out))
    sc = tscan.MarketScanner(_universe(tex, tfrom_dict, pairs=6), lookback=LOOKBACK, device="cpu")
    assert sc.scan() is sc.last_scan
    assert len(reads) == 1
    empty = tscan.MarketScanner(tex.FakeExchange({}), device="cpu")
    assert empty.scan() == [] and empty.top_symbols() == []


def _cli(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args = module.build_parser().parse_args(argv)
        args.fn(args)
    return buf.getvalue().splitlines()


def test_cli_scan_prints_jax_ranking():
    argv = ["scan", "--pairs", "16", "--lookback", "96", "--top", "6", "--seed", "3"]
    got = _cli(tcli, argv + ["--device", "cpu"])
    ref = _cli(jcli, argv)
    assert got[0] == ref[0]                                   # the header
    assert [line.split()[0] for line in got[1:-1]] == [line.split()[0] for line in ref[1:-1]]
    g, r = json.loads(got[-1]), json.loads(ref[-1])
    assert g["discovered"] == r["discovered"] == 16
    assert [o["symbol"] for o in g["ranked"]] == [o["symbol"] for o in r["ranked"]]
    for a, b in zip(g["ranked"], r["ranked"]):
        assert a["signal"] == b["signal"]
        assert a["quote_volume"] == pytest.approx(b["quote_volume"], rel=1e-5)
