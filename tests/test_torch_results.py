"""The port's backtest results (backtest/results.py) and its `cli list`,
`analyze` and `report` against the JAX package's, on the CPU.

On the same results directory — runs of two symbols and two strategies, a
run without a Sharpe ratio, one without balances, a file that is not JSON
— `load_results`, `summary_report`, `comparison_table` and the HTML of
`render_report_html` equal JAX's, byte for byte, and so does the text the
three commands print (and the report's HTML).  The JAX CLI's commands run
through their parsed function, never its `main`.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from ai_crypto_trader_tpu import cli as jcli
from ai_crypto_trader_tpu.backtest import results as jr
from ai_crypto_trader_tpu_torch import cli as tcli
from ai_crypto_trader_tpu_torch.backtest import results as tr


def _runs(rng):
    runs = {}
    for i, (sym, strat) in enumerate([("BTCUSDC", "evolvable_default"), ("ETHUSDC", "sweep"),
                                      ("BTCUSDC", "sweep"), ("SOLUSDC", "evolvable_default")]):
        curve = 10_000.0 + np.cumsum(rng.normal(0.0, 25.0, 600))
        runs[f"torch_cuda_{sym}_1m_2026010{i}_000000.json"] = {
            "initial_balance": 10_000.0, "final_balance": float(curve[-1]),
            "total_trades": float(rng.integers(0, 40)), "win_rate": float(rng.uniform(0, 100)),
            "sharpe_ratio": float(rng.normal()), "max_drawdown_pct": float(rng.uniform(0, 20)),
            "total_return_pct": float((curve[-1] - 1e4) / 100.0), "symbol": sym,
            "strategy": strat, "equity_curve": [round(float(v), 2) for v in curve[::2]]}
    runs["z_no_sharpe.json"] = {"symbol": "BTCUSDC", "initial_balance": 10_000.0,
                                "final_balance": 9_000.0, "win_rate": None}
    runs["z_no_balances.json"] = {"symbol": "ETHUSDC", "sharpe_ratio": 3.5,
                                  "total_trades": 4}
    return runs


@pytest.fixture
def results_dir(tmp_path, rng):
    d = tmp_path / "backtesting" / "results"
    d.mkdir(parents=True)
    for name, r in _runs(rng).items():
        (d / name).write_text(json.dumps(r, indent=2))
    (d / "broken.json").write_text("{not json")
    (d / "notes.txt").write_text("ignored")
    return d


@pytest.mark.parametrize("symbol,strategy", [(None, None), ("BTCUSDC", None),
                                             (None, "sweep"), ("ETHUSDC", "sweep"),
                                             ("DOGEUSDC", None)])
def test_load_summary_compare_match(results_dir, symbol, strategy):
    ref = jr.load_results(str(results_dir), symbol=symbol, strategy=strategy)
    got = tr.load_results(str(results_dir), symbol=symbol, strategy=strategy)
    assert got == ref
    assert tr.summary_report(got) == jr.summary_report(ref)
    assert tr.comparison_table(got) == jr.comparison_table(ref)


@pytest.mark.parametrize("curves", [True, False])
def test_report_html_is_the_same_bytes(results_dir, tmp_path, curves):
    results = jr.load_results(str(results_dir))
    eq = results[0]["equity_curve"] if curves else None
    dd = None
    if curves:
        peak = np.maximum.accumulate(np.asarray(eq, float))
        dd = (peak - np.asarray(eq, float)) / peak * 100.0
    a, b = tmp_path / "jax.html", tmp_path / "torch.html"
    assert jr.render_report_html(results, str(a), equity_curve=eq, drawdown_curve=dd) == str(a)
    assert tr.render_report_html(results, str(b), equity_curve=eq, drawdown_curve=dd) == str(b)
    assert b.read_bytes() == a.read_bytes()
    assert (b"<svg" in b.read_bytes()) == curves


def _text(cli, argv):
    args = cli.build_parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        args.fn(args)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [["list"], ["analyze", "--file", "RESULT"],
                                  ["report", "--out", "OUT"],
                                  ["report", "--symbol", "ETHUSDC", "--out", "OUT"],
                                  ["report", "--symbol", "DOGEUSDC", "--out", "OUT"]])
def test_cli_list_analyze_report_print_the_same(results_dir, tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    if argv[0] == "list":
        (results_dir / "broken.json").unlink()      # `list` reads every file, as JAX's does
    first = sorted(p for p in os.listdir(results_dir) if p.startswith("torch_"))[0]
    outs, pages = [], []
    for tag, cli in (("jax", jcli), ("torch", tcli)):
        a = [str(results_dir / first) if x == "RESULT" else f"{tag}.html" if x == "OUT" else x
             for x in argv]
        outs.append(_text(cli, a).replace(f"{tag}.html", "OUT"))
        pages.append((tmp_path / f"{tag}.html").read_bytes()
                     if (tmp_path / f"{tag}.html").exists() else None)
    assert outs[1] == outs[0] and outs[0]
    assert pages[1] == pages[0]
    if argv[0] == "report" and "DOGEUSDC" not in argv:
        assert pages[0] and json.loads(outs[0][:outs[0].rindex("}") + 1])["n_runs"] >= 2


def test_cli_list_without_results(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert _text(tcli, ["list"]) == _text(jcli, ["list"])
    assert _text(tcli, ["report"]) == _text(jcli, ["report"]) == '{\n  "n_runs": 0\n}\n'
