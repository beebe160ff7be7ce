"""Dashboard: self-contained HTML snapshot of the whole system state.

Capability parity with `dashboard.py` (2 315 LoC Plotly Dash UI: price
chart, portfolio, signals feed, VaR, risk metrics, strategy state,
explanations) re-designed as a dependency-free static artifact: one call
renders bus state + backtest/MC results into a single HTML file with inline
SVG charts — servable by anything, regeneratable on a timer by the
launcher, and diffable in tests.  The live data plane is the bus KV, same
as the reference's Redis keys.

The port's own copy of `ai_crypto_trader_tpu/shell/dashboard.py`, host
NumPy: the same bus state and arguments render the same HTML, byte for
byte (its title included).
"""

from __future__ import annotations

import html
import json
import time

import numpy as np


def _svg_line(values, width=640, height=160, color="#2a7", label=""):
    v = np.asarray(values, dtype=float)
    if v.size < 2 or not np.isfinite(v).any():
        return "<svg/>"
    v = np.nan_to_num(v, nan=float(np.nanmean(v)))
    lo, hi = float(v.min()), float(v.max())
    rng = hi - lo or 1.0
    xs = np.linspace(4, width - 4, v.size)
    ys = height - 4 - (v - lo) / rng * (height - 8)
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    return (f'<svg width="{width}" height="{height}" '
            f'style="background:#111;border-radius:6px">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>'
            f'<text x="8" y="16" fill="#999" font-size="11">{html.escape(label)}'
            f' [{lo:.2f} … {hi:.2f}]</text></svg>')


def _svg_heatmap(matrix, labels, cell=34, pad=70):
    """Correlation heatmap (the reference's dashboard.py:1712 panel):
    blue −1 … dark 0 … green +1, labels on both axes."""
    m = np.asarray(matrix, dtype=float)
    n = m.shape[0]
    if n == 0 or m.shape != (n, n):
        return "<svg/>"
    w = h = pad + n * cell + 4
    cells = []
    for i in range(n):
        for j in range(n):
            v = float(np.clip(np.nan_to_num(m[i, j]), -1.0, 1.0))
            if v >= 0:
                color = f"rgb({int(20 + 20 * v)},{int(40 + 150 * v)},{int(40 + 60 * v)})"
            else:
                color = f"rgb({int(40 - 20 * v)},{int(60 + 20 * v)},{int(60 - 150 * v)})"
            x, y = pad + j * cell, pad + i * cell
            cells.append(
                f'<rect x="{x}" y="{y}" width="{cell - 1}" height="{cell - 1}"'
                f' fill="{color}"><title>{html.escape(str(labels[i]))} / '
                f'{html.escape(str(labels[j]))}: {v:+.2f}</title></rect>'
                f'<text x="{x + cell / 2:.0f}" y="{y + cell / 2 + 3:.0f}" '
                f'fill="#ddd" font-size="9" text-anchor="middle">{v:+.2f}</text>')
    texts = []
    for i, lab in enumerate(labels):
        lab = html.escape(str(lab).replace("USDC", ""))
        texts.append(f'<text x="{pad - 6}" y="{pad + i * cell + cell / 2 + 3:.0f}"'
                     f' fill="#999" font-size="10" text-anchor="end">{lab}</text>')
        texts.append(f'<text x="{pad + i * cell + cell / 2:.0f}" y="{pad - 8}"'
                     f' fill="#999" font-size="10" text-anchor="middle" '
                     f'transform="rotate(-45 {pad + i * cell + cell / 2:.0f} '
                     f'{pad - 8})">{lab}</text>')
    return (f'<svg width="{w}" height="{h}" '
            f'style="background:#111;border-radius:6px">'
            + "".join(texts) + "".join(cells) + "</svg>")


def _np_ewm(v: np.ndarray, alpha: float, start: int = 0) -> np.ndarray:
    """Host-numpy ewm(alpha, adjust=False) seeded at `start` — the same
    recurrence as ops/indicators._ewm, so overlays agree with the published
    columns (no device round-trip from a serving thread)."""
    out = np.empty_like(v)
    out[:start] = v[:start]
    acc = v[start] if start < v.size else 0.0
    for i in range(start, v.size):
        acc = alpha * v[i] + (1 - alpha) * acc
        out[i] = acc
    return out


def chart_overlays(closes) -> dict:
    """Display-only indicator overlays for the candlestick panel (the
    reference pulls bb_upper/middle/lower + RSI/MACD per candle from Redis,
    `dashboard.py:536-640`; here they're derived from the close series at
    render time — tiny numpy, no device round-trip from a serving thread).

    RSI uses Wilder smoothing (alpha=1/14 seeded at t=1), matching
    ops/indicators.rsi — an EMA-smoothed display RSI visibly disagreed
    with the same page's published `rsi` columns (VERDICT r4 weak#7)."""
    c = np.asarray(closes, dtype=float)
    if c.size < 3:
        return {}
    n = min(20, c.size)
    kernel = np.ones(n) / n
    sma = np.convolve(c, kernel, mode="full")[:c.size]
    sma[:n - 1] = c[:n - 1]                    # warmup: track price
    dev = np.array([c[max(0, i - n + 1):i + 1].std() for i in range(c.size)])
    delta = np.diff(c, prepend=c[0])
    up = _np_ewm(np.maximum(delta, 0.0), 1.0 / 14.0, start=1)
    dn = _np_ewm(np.maximum(-delta, 0.0), 1.0 / 14.0, start=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rsi = np.where(dn == 0.0, np.where(up == 0.0, 50.0, 100.0),
                       100.0 - 100.0 / (1.0 + up / np.where(dn == 0.0, 1.0, dn)))
    macd = (_np_ewm(c, 2.0 / 13.0) - _np_ewm(c, 2.0 / 27.0))
    return {"bb_upper": sma + 2 * dev, "bb_middle": sma,
            "bb_lower": sma - 2 * dev, "rsi": rsi, "macd": macd}


def _svg_candlestick(klines, overlays: dict | None = None,
                     trades: list | None = None, width=920, height=300,
                     label="") -> str:
    """Candlestick chart with indicator overlays, trade markers, and a
    volume strip (the reference's main price panel, `dashboard.py:509-740`:
    go.Candlestick + BB traces + volume subplot; markers mirror its trade
    annotations). `klines` rows are the bus format [ts,o,h,l,c,vol,...]."""
    rows = list(klines or [])
    if len(rows) < 2:
        return "<svg/>"
    ts = np.asarray([r[0] for r in rows], dtype=float)
    o = np.asarray([r[1] for r in rows], dtype=float)
    h = np.asarray([r[2] for r in rows], dtype=float)
    l = np.asarray([r[3] for r in rows], dtype=float)
    c = np.asarray([r[4] for r in rows], dtype=float)
    vol = np.asarray([r[5] for r in rows], dtype=float) if len(rows[0]) > 5 \
        else np.zeros_like(c)
    n = len(rows)
    vol_h = 40
    price_h = height - vol_h - 8
    lo = float(np.nanmin([l.min()] + [np.nanmin(s) for k, s in (overlays or {}).items()
                                      if k.startswith("bb") and len(s) == n]))
    hi = float(np.nanmax([h.max()] + [np.nanmax(s) for k, s in (overlays or {}).items()
                                      if k.startswith("bb") and len(s) == n]))
    rng = hi - lo or 1.0

    def y(p):
        return 4 + (hi - p) / rng * (price_h - 8)

    step = (width - 8) / n
    cw = max(step * 0.6, 1.0)
    parts = []
    vmax = vol.max() or 1.0
    for i in range(n):
        x = 4 + i * step + step / 2
        up = c[i] >= o[i]
        color = "#2d5" if up else "#e55"
        parts.append(f'<line x1="{x:.1f}" y1="{y(h[i]):.1f}" x2="{x:.1f}" '
                     f'y2="{y(l[i]):.1f}" stroke="{color}" stroke-width="1"/>')
        top, bot = (c[i], o[i]) if up else (o[i], c[i])
        parts.append(
            f'<rect x="{x - cw / 2:.1f}" y="{y(top):.1f}" width="{cw:.1f}" '
            f'height="{max(y(bot) - y(top), 1.0):.1f}" fill="{color}"/>')
        vh = vol[i] / vmax * (vol_h - 4)
        parts.append(f'<rect x="{x - cw / 2:.1f}" y="{height - vh:.1f}" '
                     f'width="{cw:.1f}" height="{vh:.1f}" fill="#345" '
                     f'opacity="0.8"/>')
    overlay_colors = {"bb_upper": "#9cf", "bb_middle": "#ccc",
                      "bb_lower": "#9cf", "sma_20": "#fc6", "sma_50": "#c6f"}
    for name, series in (overlays or {}).items():
        s = np.asarray(series, dtype=float)
        if name in ("rsi", "macd") or len(s) != n:
            continue
        pts = " ".join(f"{4 + i * step + step / 2:.1f},{y(v):.1f}"
                       for i, v in enumerate(s) if np.isfinite(v))
        parts.append(f'<polyline fill="none" stroke='
                     f'"{overlay_colors.get(name, "#888")}" stroke-width="1" '
                     f'opacity="0.8" points="{pts}"/>')
    # trade markers: ▲ entry below the low, ▼ exit above the high
    # (time-matched into the visible window; clipped to the edge otherwise)
    for t in trades or []:
        for key, price_key, glyph, color in (
                ("opened_at", "entry_price", "▲", "#2d5"),
                ("closed_at", "exit_price", "▼", "#e55")):
            when = t.get(key)
            price = t.get(price_key)
            if when is None or price is None:
                continue
            # side='right' so a trade time exactly on a candle open lands
            # on THAT candle, not the one before
            i = int(np.clip(
                np.searchsorted(ts, float(when) * 1000.0, side="right") - 1,
                0, n - 1))
            x = 4 + i * step + step / 2
            yy = y(float(price))
            parts.append(
                f'<text x="{x:.1f}" y="{yy:.1f}" fill="{color}" '
                f'font-size="12" text-anchor="middle">{glyph}'
                f'<title>{html.escape(t.get("symbol", ""))} '
                f'{html.escape(key.split("_")[0])} @ {float(price):,.2f}'
                f'{" pnl " + format(t.get("pnl"), ",.2f") if key == "closed_at" and t.get("pnl") is not None else ""}'
                f'</title></text>')
    parts.append(f'<text x="8" y="16" fill="#999" font-size="11">'
                 f'{html.escape(label)} [{lo:.2f} … {hi:.2f}]</text>')
    return (f'<svg width="{width}" height="{height}" '
            f'style="background:#111;border-radius:6px">'
            + "".join(parts) + "</svg>")


def _svg_allocation(values: dict, width=420, height=26) -> str:
    """Portfolio allocation as a stacked horizontal bar + weights table
    (the reference's allocation panel, `dashboard.py:1131` family)."""
    vals = {k: float(v) for k, v in values.items() if v and v > 0}
    total = sum(vals.values())
    if total <= 0:
        return ""
    palette = ["#4af", "#2a7", "#fa4", "#e66", "#c6f", "#9cf", "#fc6"]
    x = 0.0
    segs = []
    rows = {}
    for i, (asset, v) in enumerate(sorted(vals.items(), key=lambda t: -t[1])):
        w = v / total * width
        color = palette[i % len(palette)]
        segs.append(f'<rect x="{x:.1f}" y="0" width="{w:.1f}" '
                    f'height="{height}" fill="{color}">'
                    f'<title>{html.escape(asset)}: {v:,.2f} '
                    f'({v / total:.1%})</title></rect>')
        rows[f"<span style='color:{color}'>■</span> {html.escape(asset)}"] = \
            f"{v:,.2f} ({v / total:.1%})"
        x += w
    bar = (f'<svg width="{width}" height="{height}" '
           f'style="border-radius:4px">' + "".join(segs) + "</svg>")
    body = "".join(f"<tr><td>{k}</td><td style='text-align:right'>"
                   f"{html.escape(v)}</td></tr>" for k, v in rows.items())
    return (f"<div class='card'><h3>Portfolio allocation</h3>{bar}"
            f"<table>{body}</table></div>")


def _model_comparison_html(versions: list, width=420) -> str:
    """Model-version comparison panel (the reference's AI-model performance
    chart + registry comparison, `dashboard.py:1174-1260`,
    `model_registry_service.py:355`): per-version bar of the ranking metric
    + status table."""
    rows = []
    for e in versions:
        perf = e.get("performance") or {}
        sharpe = perf.get("sharpe_ratio")
        rows.append((e.get("version", "?"), e.get("kind", "?"),
                     e.get("status", "?"),
                     float(sharpe) if sharpe is not None else None))
    if not rows:
        return ""
    rows = rows[-10:]                  # scale bars over the DISPLAYED rows
    scored = [r for r in rows if r[3] is not None]
    best = max((r[3] for r in scored), default=0.0)
    worst = min((r[3] for r in scored), default=0.0)
    rng = (best - worst) or 1.0
    parts = []
    for v, kind, status, sharpe in rows:
        if sharpe is None:
            bar = "<td style='color:#666'>unscored</td>"
        else:
            w = max((sharpe - worst) / rng * 160, 2)
            color = "#2a7" if sharpe == best else "#47a"
            bar = (f"<td><svg width='170' height='12'>"
                   f"<rect width='{w:.0f}' height='12' fill='{color}'/>"
                   f"</svg> {sharpe:.3f}</td>")
        parts.append(f"<tr><td>{html.escape(str(v))}</td>"
                     f"<td>{html.escape(str(kind))}</td>"
                     f"<td>{html.escape(str(status))}</td>{bar}</tr>")
    return ("<div class='card'><h3>Model versions</h3>"
            "<table><tr><th>version</th><th>kind</th><th>status</th>"
            "<th>sharpe</th></tr>" + "".join(parts) + "</table></div>")


def _explanations_html(explanations: list) -> str:
    """Explanation drill-down (the reference's AI-explanation modal,
    dashboard.py:1937): a <details> disclosure per signal with the factor
    table inside — click to drill in."""
    items = []
    for e in explanations[-8:][::-1]:
        head = (f"{e.get('symbol', '?')} {e.get('decision', '?')} "
                f"(conf {float(e.get('confidence') or 0.0):.2f})")
        factors = e.get("factors") or e.get("factor_weights") or {}

        def cell(v):
            if isinstance(v, dict):               # explain_signal factor row
                return (f"{v.get('value', 0):,.2f} ({v.get('reading', '')}) "
                        f"× {v.get('weight', 0):.2f}")
            return _fmt(v)

        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td style='text-align:right'>{html.escape(cell(v))}</td></tr>"
            for k, v in (factors.items() if isinstance(factors, dict)
                         else enumerate(factors)))
        summary = html.escape(str(e.get("narrative", ""))[:300])
        items.append(
            f"<details><summary>{html.escape(head)}</summary>"
            f"<p style='color:#999;font-size:12px'>{summary}</p>"
            f"<table>{rows}</table></details>")
    if not items:
        return ""
    return ("<div class='card'><h3>AI explanations</h3>"
            + "".join(items) + "</div>")


def _news_html(aggregate: dict | None, recent: list | None) -> str:
    """News panel (the reference's news feed + sentiment summary,
    `dashboard.py:91-99` news channel subscription and its rendered feed):
    impact-weighted aggregate header plus the recent-headline list with
    per-article direction/impact."""
    parts = []
    colors = {"bullish": "#2d5", "bearish": "#e55", "neutral": "#999"}
    if aggregate:
        direction = str(aggregate.get("direction", "neutral"))
        topics = ", ".join(aggregate.get("top_topics") or []) or "—"
        parts.append(
            f"<p><span style='color:{colors.get(direction, '#999')}'>"
            f"{html.escape(direction)}</span> · sentiment "
            f"{float(aggregate.get('sentiment') or 0.0):+.2f} · impact "
            f"{float(aggregate.get('market_impact') or 0.0):.2f} · "
            f"{int(aggregate.get('n_articles') or 0)} articles · topics: "
            f"{html.escape(topics)}</p>")
    for a in (recent or [])[-8:][::-1]:
        direction = str(a.get("direction", "neutral"))
        parts.append(
            f"<p style='margin:3px 0;font-size:12px'>"
            f"<span style='color:{colors.get(direction, '#999')}'>●</span> "
            f"{html.escape(str(a.get('title', ''))[:120])} "
            f"<span style='color:#777'>impact "
            f"{float(a.get('market_impact') or 0.0):.2f}</span></p>")
    if not parts:
        return ""
    return "<div class='card'><h3>News</h3>" + "".join(parts) + "</div>"


def _patterns_html(signal: dict | None, report: dict | None) -> str:
    """Pattern-signal panel (the reference subscribes `pattern_signals` and
    renders the recognition feed, `dashboard.py:91-99` + pattern panels):
    the symbol's latest actionable signal plus the combined report's
    per-symbol feed and summary counts."""
    parts = []
    colors = {"buy": "#2d5", "sell": "#e55", "neutral": "#999"}
    if signal and signal.get("signal", "neutral") != "neutral":
        sig = str(signal.get("signal"))
        parts.append(
            f"<p><span style='color:{colors.get(sig, '#999')}'>"
            f"{html.escape(sig.upper())}</span> "
            f"{html.escape(str(signal.get('pattern', '?')))} "
            f"({html.escape(str(signal.get('signal_strength', '')))}, "
            f"strength {float(signal.get('strength') or 0.0):.2f}, "
            f"completion {float(signal.get('completion') or 0.0):.0f}%)</p>")
        confirmation = signal.get("confirmation")
        if confirmation:
            parts.append(f"<p style='color:#777;font-size:12px'>confirm: "
                         f"{html.escape(str(confirmation))}</p>")
    if report:
        summary = report.get("summary") or {}
        if summary:
            parts.append(
                f"<p style='font-size:12px'>bullish "
                f"{summary.get('bullish_patterns', 0)} · bearish "
                f"{summary.get('bearish_patterns', 0)} · neutral "
                f"{summary.get('neutral_patterns', 0)}</p>")
        rows = {}
        for sym, s in (report.get("signals") or {}).items():
            rows[sym] = (f"{s.get('signal', '?')} {s.get('pattern', '')} "
                         f"({float(s.get('strength') or 0.0):.2f})")
        if rows:
            body = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td style='text-align:right'>{html.escape(v)}</td></tr>"
                for k, v in rows.items())
            parts.append(f"<table>{body}</table>")
    if not parts:
        return ""
    return ("<div class='card'><h3>Pattern signals</h3>"
            + "".join(parts) + "</div>")


def _traces_html(traces: list) -> str:
    """Recent-traces card (the observability counterpart of the reference's
    unchecked Jaeger TODO): one <details> disclosure per trace with the
    span tree inside — stage, service, duration, compile/execute split
    where the span recorded one (model/backtest dispatches)."""
    items = []
    for t in traces[:8]:
        head = (f"{t.get('root', '?')} · {t.get('n_spans', 0)} spans · "
                f"{float(t.get('duration_s') or 0.0) * 1000:.1f} ms · "
                f"{str(t.get('trace_id', ''))[:8]}")
        rows = []
        spans = sorted(t.get("spans") or [], key=lambda s: s.get("start", 0))
        for s in spans:
            dur = ((s.get("end") or 0) - (s.get("start") or 0)) * 1000
            attrs = s.get("attributes") or {}
            extra = ""
            if "compile_s" in attrs:
                extra = (f" (compile {float(attrs['compile_s']) * 1000:.1f} ms"
                         f" / execute {float(attrs.get('execute_s') or 0.0) * 1000:.1f} ms)")
            elif attrs.get("symbol"):
                extra = f" [{attrs['symbol']}]"
            marker = "└ " if s.get("parent_id") else ""
            rows.append(
                f"<tr><td>{html.escape(marker + str(s.get('name', '?')))}</td>"
                f"<td>{html.escape(str(s.get('service') or ''))}</td>"
                f"<td style='text-align:right'>{dur:.2f} ms"
                f"{html.escape(extra)}</td></tr>")
        items.append(
            f"<details><summary>{html.escape(head)}</summary>"
            f"<table><tr><th>span</th><th>service</th><th>duration</th></tr>"
            + "".join(rows) + "</table></details>")
    if not items:
        return ""
    return ("<div class='card'><h3>Recent traces</h3>"
            + "".join(items) + "</div>")


def _table(rows: dict, title: str) -> str:
    body = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td style='text-align:right'>{html.escape(_fmt(v))}</td></tr>"
        for k, v in rows.items())
    return (f"<div class='card'><h3>{html.escape(title)}</h3>"
            f"<table>{body}</table></div>")


def _fmt(v):
    if isinstance(v, float):
        return f"{v:,.4f}" if abs(v) < 100 else f"{v:,.2f}"
    return str(v)


def render_dashboard(bus=None, *, price_series=None, equity_curve=None,
                     metrics: dict | None = None, mc_stats: dict | None = None,
                     signals: list | None = None, alerts: list | None = None,
                     regime: dict | None = None, refresh_s: float | None = None,
                     klines=None, trades: list | None = None,
                     allocation: dict | None = None,
                     model_versions: list | None = None,
                     symbol: str | None = None,
                     symbol_links: list | None = None,
                     traces: list | None = None,
                     decisions: list | None = None,
                     now_fn=time.time) -> str:
    """Return the dashboard HTML. Every section is optional — sections
    render from whatever state exists (like the reference's per-callback
    panels tolerating missing Redis keys). `refresh_s` adds a meta-refresh
    so a served page polls like the reference's 5 s Dash interval.

    `klines` (bus rows) renders the reference's main panel — candlestick
    with BB overlays, RSI/MACD subpanels, volume strip, and trade markers
    from `trades` records (`dashboard.py:509-740`); `allocation` the
    portfolio-allocation card; `model_versions` the registry comparison."""
    sections = []
    if symbol_links:
        links = " · ".join(
            f'<a style="color:#8ac" href="/?symbol={html.escape(s)}">'
            f'{html.escape(s)}</a>' for s in symbol_links)
        sections.append(f"<p>{links} &nbsp; <span style='color:#777'>"
                        "(window via ?window=N candles)</span></p>")
    if klines:
        closes = [row[4] for row in klines]
        ov = chart_overlays(closes)
        sections.append(_svg_candlestick(
            klines, ov, trades, label=symbol or "price"))
        if "rsi" in ov:
            sections.append(_svg_line(ov["rsi"], height=80, label="RSI 14",
                                      color="#fc6"))
        if "macd" in ov:
            sections.append(_svg_line(ov["macd"], height=80, label="MACD",
                                      color="#c6f"))
    elif price_series is not None:
        sections.append(_svg_line(price_series, label="price", color="#4af"))
    if allocation:
        sections.append(_svg_allocation(allocation))
    if model_versions:
        sections.append(_model_comparison_html(model_versions))
    if equity_curve is not None:
        sections.append(_svg_line(equity_curve, label="equity", color="#2a7"))
    if metrics:
        sections.append(_table(metrics, "Backtest / portfolio metrics"))
    if mc_stats:
        sections.append(_table(mc_stats, "Monte-Carlo risk"))
    if regime:
        sections.append(_table(regime, "Market regime"))
    if bus is not None:
        params = bus.get("strategy_params")
        if params:
            sections.append(_table(params, "Live strategy parameters"))
        structure = bus.get("strategy_structure")
        if structure and isinstance(structure.get("rules"), dict):
            # adopted rule-graph structure (GeneratorService hot swap) +
            # its live evaluation from the monitor's market_data columns;
            # non-numeric weights render as-is (a bad payload must degrade,
            # never take down the whole page)
            rows = {f"rule: {name}": (f"{weight:+.2f}"
                                      if isinstance(weight, (int, float))
                                      else str(weight))
                    for name, weight in sorted(structure["rules"].items(),
                                               key=lambda kv: str(kv[0]))}
            rows["thresholds"] = (f"buy ≥ {structure.get('buy_threshold', 0)}"
                                  f" / sell ≤ -{structure.get('sell_threshold', 0)}")
            rows["exits"] = (f"SL {structure.get('stop_loss', 0)}% / "
                             f"TP {structure.get('take_profit', 0)}%")
            if structure.get("version"):
                rows["version"] = structure["version"]
            md = bus.get(f"market_data_{symbol}") if symbol else None
            # only pair the live blend with the structure it was computed
            # against — right after a hot swap the monitor's last poll
            # still reflects the PREVIOUS structure. Version must be
            # truthy: registry-less adoptions carry version None on BOTH
            # sides, which would false-match across a swap.
            if (md and isinstance(md.get("structure_blend"), (int, float))
                    and structure.get("version")
                    and md.get("structure_version") == structure.get("version")):
                rows["live blend"] = (f"{md['structure_blend']:+.4f} → "
                                      f"{md.get('structure_signal', '?')}")
            sections.append(_table(rows, "Adopted strategy structure"))
        trades = bus.get("active_trades")
        if trades:
            sections.append(_table({s: f"entry {t.get('entry_price', 0):,.2f}"
                                    for s, t in trades.items()}, "Active trades"))
        # --- reference dashboard.py parity panels ---
        pv = bus.get("portfolio_value_history")
        if pv and len(pv) >= 2:                   # portfolio value chart
            sections.append(_svg_line([p["value"] for p in pv],
                                      label="portfolio value", color="#fa4"))
        live_regime = bus.get("market_regime")
        if (not regime and live_regime            # regime panel (skip when a
                and isinstance(live_regime, dict)):  # snapshot was passed in)
            sections.append(_table(
                {k: v for k, v in live_regime.items()
                 if isinstance(v, (int, float, str))}, "Market regime"))
        risk = bus.get("risk_metrics")
        if risk:
            sections.append(_table(risk, "Portfolio risk"))
        var_hist = bus.get("var_history")
        if var_hist and len(var_hist) >= 2:       # dashboard.py:1485
            sections.append(_svg_line([p["var_95"] for p in var_hist],
                                      label="VaR 95% history", color="#e66"))
        corr = bus.get("correlation_matrix")
        if corr and corr.get("symbols"):          # dashboard.py:1712
            sections.append(
                "<div class='card'><h3>Asset correlation</h3>"
                + _svg_heatmap(corr["matrix"], corr["symbols"]) + "</div>")
        expl = bus.get("explanations")
        if expl:                                  # dashboard.py:1937
            sections.append(_explanations_html(expl))
        # --- social / news / pattern feeds (reference dashboard.py:91-99
        # subscribes social_updates, news and pattern_signals channels) ---
        if symbol:
            sh = bus.get(f"social_history_{symbol}")
            if sh and len(sh) >= 2:               # sentiment time series
                sections.append(_svg_line(
                    [row[1] for row in sh], height=80,
                    label=f"social sentiment {symbol}", color="#4af"))
            soc = bus.get(f"social_metrics_{symbol}")
            if soc:                               # latest source breakdown
                sections.append(_table(
                    {k: v for k, v in soc.items()
                     if isinstance(v, (int, float, str, bool))},
                    "Social metrics"))
            news_panel = _news_html(bus.get(f"news_analysis_{symbol}"),
                                    bus.get(f"news_recent_{symbol}"))
            if news_panel:
                sections.append(news_panel)
        pattern_panel = _patterns_html(
            bus.get(f"pattern_signals_{symbol}") if symbol else None,
            bus.get("pattern_analysis_report"))
        if pattern_panel:
            sections.append(pattern_panel)
        # --- trading-quality observatory (obs/) ---
        attribution = bus.get("pnl_attribution")
        if attribution and attribution.get("family"):
            rows = {src: f"pnl {v['pnl']:+,.2f} · {v['trades']} trades · "
                         f"win {v['win_rate']:.0%}"
                    for src, v in sorted(
                        attribution["family"].items(),
                        key=lambda kv: -kv[1]["pnl"])}
            sections.append(_table(rows, "PnL attribution (signal family)"))
        scorecard = bus.get("model_scorecard")
        if scorecard:
            rows = {group: (f"dir {sc['directional_accuracy']:.0%} · hit "
                            f"{sc['hit_rate']:.0%} · brier {sc['brier']:.3f}"
                            f" · n={sc['n']}")
                    for group, sc in sorted(scorecard.items())}
            sections.append(_table(rows, "Model scorecard (live outcomes)"))
    if signals:
        rows = {f"{s.get('symbol')} @ {s.get('timestamp', 0):.0f}":
                f"{s.get('decision')} ({s.get('confidence', 0):.2f})"
                for s in signals[-10:]}
        sections.append(_table(rows, "Recent signals"))
    if decisions:
        from ai_crypto_trader_tpu_torch.obs.flightrec import format_why

        rows = "".join(f"<div style='font-family:monospace;font-size:12px'>"
                       f"{html.escape(line)}</div>"
                       for line in format_why(decisions))
        sections.append(f"<div class='card'><h3>Recent decisions "
                        f"(flight recorder)</h3>{rows}</div>")
    if traces:
        trace_panel = _traces_html(traces)
        if trace_panel:
            sections.append(trace_panel)
    if alerts:
        rows = {a["name"]: f"{a['severity']} — {a['description']}" for a in alerts}
        sections.append(_table(rows, "Active alerts"))

    body = "\n".join(sections) or "<p>no data yet</p>"
    refresh = (f'<meta http-equiv="refresh" content="{refresh_s:g}">'
               if refresh_s else "")
    return f"""<!doctype html><html><head><meta charset="utf-8">{refresh}
<title>ai_crypto_trader_tpu</title><style>
body{{background:#0a0a0a;color:#ddd;font-family:system-ui;margin:24px}}
.card{{background:#161616;border-radius:6px;padding:12px;margin:10px 0;
display:inline-block;vertical-align:top;min-width:280px;margin-right:10px}}
table{{border-collapse:collapse;font-size:13px}}
td{{padding:2px 10px;border-bottom:1px solid #222}}
h3{{margin:0 0 8px 0;font-size:14px;color:#8ac}}
</style></head><body>
<h2>ai_crypto_trader_tpu dashboard</h2>
<p style="color:#777">generated {time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime(now_fn()))} UTC</p>
{body}
</body></html>"""


def write_dashboard(path: str, **kw) -> str:
    html_text = render_dashboard(**kw)
    with open(path, "w") as f:
        f.write(html_text)
    return path


def dump_state_json(bus, path: str) -> str:
    """Machine-readable state dump (the Redis-keys equivalent surface)."""
    state = {k: bus.get(k) for k in bus.keys("*")
             if isinstance(bus.get(k), (int, float, str, list, dict))}
    with open(path, "w") as f:
        json.dump(state, f, indent=2, default=str)
    return path
