"""Realized-PnL attribution: which signal source actually makes money.

Folds the executor's journal-durable closure records by their entry
provenance — the dominant combination FAMILY at entry (one of the 15
`ops/combinations` families the monitor now stamps on every update), the
adopted STRATEGY structure version, and the analysis MODEL version —
into per-source realized PnL, win rate and trade counts, exported as
gauges and rendered as the dashboard's "PnL attribution" card.

"Which of the 15 combination families makes money" becomes a queryable
series instead of archaeology over trade logs.  Closure records carry
their ``source`` dict through the write-ahead journal, so attribution
survives restarts exactly as far as the books do.

The port's own copy of `ai_crypto_trader_tpu/obs/attribution.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# source kinds folded out of each closure record
KINDS = ("family", "structure", "model", "reason")


@dataclass
class PnLAttribution:
    metrics: object = None
    # (kind, source) -> {"pnl", "trades", "wins"}
    by_source: dict = field(default_factory=dict)
    folded: int = 0

    def _sources(self, rec: dict) -> list[tuple[str, str]]:
        src = rec.get("source") or {}
        return [
            ("family", str(src.get("family") or "unattributed")),
            ("structure", str(src.get("structure_version") or "none")),
            ("model", str(src.get("model_version") or "unknown")),
            ("reason", str(rec.get("reason") or "unknown")),
        ]

    def fold_record(self, rec: dict) -> None:
        pnl = float(rec.get("pnl") or 0.0)
        win = pnl > 0.0
        for kind, source in self._sources(rec):
            slot = self.by_source.setdefault(
                (kind, source), {"pnl": 0.0, "trades": 0, "wins": 0})
            slot["pnl"] += pnl
            slot["trades"] += 1
            slot["wins"] += int(win)
            if self.metrics is not None:
                self.metrics.inc("source_trades_total",
                                 kind=kind, source=source)
        self.folded += 1

    def fold_new(self, closed_trades: list, cursor: int) -> int:
        """Fold records from ``cursor`` onward; returns the new cursor.
        The caller owns the cursor so replayed journal closures (restart)
        and live closures ride the same path."""
        for rec in closed_trades[cursor:]:
            self.fold_record(rec)
        return len(closed_trades)

    def export(self) -> None:
        m = self.metrics
        if m is None:
            return
        for (kind, source), slot in self.by_source.items():
            m.set_gauge("source_realized_pnl", slot["pnl"],
                        kind=kind, source=source)
            m.set_gauge("source_win_rate",
                        slot["wins"] / slot["trades"] if slot["trades"] else 0.0,
                        kind=kind, source=source)

    def summary(self, kind: str | None = None) -> dict:
        """{kind: {source: {pnl, trades, win_rate}}} — the dashboard card
        / ``/state.json`` payload."""
        out: dict = {}
        for (k, source), slot in sorted(self.by_source.items()):
            if kind is not None and k != kind:
                continue
            out.setdefault(k, {})[source] = {
                "pnl": round(slot["pnl"], 6),
                "trades": slot["trades"],
                "win_rate": (round(slot["wins"] / slot["trades"], 4)
                             if slot["trades"] else 0.0),
            }
        return out
