"""Backtest result analysis: load/filter, reports, comparisons, plots.

The port's own copy of `ai_crypto_trader_tpu/backtest/results.py:22-111`
(ResultAnalyzer, `backtesting/result_analyzer.py`): load + filter saved
JSON results (:23-71), the multi-run summary report (:226-328), the metric
comparison (:330-415) and the equity/drawdown report (:73-224), rendered
as the dashboard's dependency-free inline-SVG HTML
(`shell.dashboard._svg_line`, `_table`).  Host-only: it reads the JSON
files that `cli backtest` writes.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ai_crypto_trader_tpu_torch.shell.dashboard import _svg_line, _table


def load_results(results_dir: str = "backtesting/results",
                 symbol: str | None = None,
                 strategy: str | None = None) -> list[dict]:
    """(:23-71)"""
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        try:
            with open(path) as f:
                r = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        r["_file"] = os.path.basename(path)
        if symbol and r.get("symbol") != symbol:
            continue
        if strategy and r.get("strategy") != strategy:
            continue
        out.append(r)
    return out


def summary_report(results: list[dict]) -> dict:
    """Multi-run aggregation (:226-328)."""
    if not results:
        return {"n_runs": 0}

    def col(key):
        return np.asarray([r.get(key, 0.0) or 0.0 for r in results], float)
    # rank/average sharpe only over runs that actually carry one (same rule
    # as profitable_runs below: missing metrics must not coerce to 0)
    scored = [(i, float(r["sharpe_ratio"])) for i, r in enumerate(results)
              if isinstance(r.get("sharpe_ratio"), (int, float))]
    if scored:
        best_i = max(scored, key=lambda t: t[1])[0]
        mean_sharpe = float(np.mean([s for _, s in scored]))
        best_sharpe = float(dict(scored)[best_i])
    else:
        best_i, mean_sharpe, best_sharpe = 0, 0.0, 0.0
    # profitability judged only on runs that actually carry both balances —
    # a missing initial_balance must not coerce to 0 and count as a win
    with_balances = [r for r in results
                     if "initial_balance" in r and "final_balance" in r]
    profitable = (sum(r["final_balance"] > r["initial_balance"]
                      for r in with_balances) if with_balances else None)
    return {
        "n_runs": len(results),
        "symbols": sorted({r.get("symbol", "?") for r in results}),
        "mean_sharpe": mean_sharpe,
        "best_sharpe": best_sharpe,
        "best_run": results[best_i].get("_file", f"run_{best_i}"),
        "mean_win_rate": float(col("win_rate").mean()),
        "mean_return_pct": float(col("total_return_pct").mean()),
        "total_trades": int(col("total_trades").sum()),
        "profitable_runs": profitable,
    }


def comparison_table(results: list[dict],
                     metrics=("sharpe_ratio", "win_rate", "total_return_pct",
                              "max_drawdown_pct", "total_trades")) -> dict:
    """Metric comparison across runs (:330-415)."""
    rows = {r.get("_file", f"run_{i}"): {m: r.get(m) for m in metrics}
            for i, r in enumerate(results)}
    ranked = sorted(rows, key=lambda k: -(rows[k].get("sharpe_ratio") or 0.0))
    return {"rows": rows, "ranked": ranked}


def render_report_html(results: list[dict], path: str,
                       equity_curve=None, drawdown_curve=None) -> str:
    """Equity/drawdown plots + summary + comparison as one HTML artifact
    (:73-224 equivalents)."""
    sections = []
    if equity_curve is not None:
        sections.append(_svg_line(equity_curve, label="equity", color="#2a7"))
    if drawdown_curve is not None:
        sections.append(_svg_line(drawdown_curve, label="drawdown %", color="#d55"))
    summary = summary_report(results)
    sections.append(_table({k: v for k, v in summary.items()
                            if not isinstance(v, list)}, "Summary"))
    cmp_ = comparison_table(results)
    for name in cmp_["ranked"][:10]:
        sections.append(_table(cmp_["rows"][name], name))
    html = ("<!doctype html><html><head><meta charset='utf-8'>"
            "<style>body{background:#0a0a0a;color:#ddd;font-family:system-ui}"
            ".card{background:#161616;border-radius:6px;padding:12px;margin:8px;"
            "display:inline-block;vertical-align:top}"
            "td{padding:2px 10px;border-bottom:1px solid #222}"
            "h3{margin:0 0 8px 0;font-size:14px;color:#8ac}</style></head><body>"
            "<h2>Backtest report</h2>" + "\n".join(sections) + "</body></html>")
    with open(path, "w") as f:
        f.write(html)
    return path
