"""Seeded kline frames of a symbol universe: the market data of the
trading cells.

A frozen copy of the venue side of the port's load generator, so that a
later change to the program cannot change the benchmark's traffic:
`testing/loadgen._synthetic_series` (one seeded series, each symbol a
scaled copy), `shell/exchange.FakeExchange.get_klines` with
`resample_klines` (3m/5m/15m bars resampled from the 1m series on fixed
boundaries), `testing/chaos.kline_frames_for` (the current candle of every
symbol and frame, closed once its last 1m candle is in) and
`shell/stream.kline_frame` (the Binance kline frame).
`portbench/tests/test_portbench_trading.py` holds it against the program's
frames for one seed, as they stood when they were copied.
"""

from __future__ import annotations

import json

import numpy as np

from portbench.traffic.ohlcv import generate_ohlcv

FIELDS = ("open", "high", "low", "close", "volume")


def interval_minutes(interval: str) -> int:
    return int(interval[:-1]) * {"m": 1, "h": 60, "d": 1440}[interval[-1]]


def resample_klines(rows: list, factor: int) -> list:
    """Aggregate 1m rows into bars of ``factor`` minutes; the trailing bar
    may be partial (the venue's bar in progress)."""
    out = []
    for i in range(0, len(rows), factor):
        chunk = rows[i: i + factor]
        out.append([chunk[0][0], chunk[0][1],
                    max(r[2] for r in chunk), min(r[3] for r in chunk),
                    chunk[-1][4], sum(r[5] for r in chunk)]
                   + list(chunk[-1][6:]))
    return out


def kline_frame(symbol: str, interval: str, row: list, *, closed: bool) -> str:
    """A Binance kline frame of one row ``[open_time, o, h, l, c, v, ...]``."""
    k = {"t": int(row[0]), "s": symbol, "i": interval,
         "o": str(row[1]), "h": str(row[2]), "l": str(row[3]),
         "c": str(row[4]), "v": str(row[5]), "x": bool(closed)}
    return json.dumps({"e": "kline", "E": int(row[0]), "s": symbol, "k": k})


class Tape:
    """``n`` 1-minute candles of ``symbols`` symbols from ``seed`` and a
    cursor: the venue's clock.  Serves `get_klines` (the REST surface the
    program seeds its candle books from) and each tick's frames."""

    def __init__(self, symbols: int, n: int, seed: int):
        d = generate_ohlcv(n, int(seed) + 11)
        self.n = int(n)
        self.symbols = [f"L{i:03d}USDC" for i in range(symbols)]
        self.series = {}
        for i, sym in enumerate(self.symbols):
            scale = np.float64(1.0 + 0.03 * i)
            s = {k: d[k] * scale for k in ("open", "high", "low", "close")}
            s["volume"] = d["volume"] * (1.0 + 0.01 * i)
            s["timestamp"] = np.arange(n, dtype=np.int64) * 60_000
            self.series[sym] = s
        self.cursor = 0

    def advance(self, steps: int = 1) -> None:
        self.cursor = min(self.cursor + steps, self.n - 1)

    def get_klines(self, symbol: str, interval: str = "1m", limit: int = 100) -> list:
        factor = interval_minutes(interval)
        s = self.series[symbol]
        end = self.cursor + 1
        start = max(end - limit * factor, 0)
        start -= start % factor
        rows = [[int(s["timestamp"][i]), float(s["open"][i]), float(s["high"][i]),
                 float(s["low"][i]), float(s["close"][i]), float(s["volume"][i]),
                 0, 0.0, 0, 0.0, 0.0, 0] for i in range(start, end)]
        if factor > 1:
            rows = resample_klines(rows, factor)
        return rows[-limit:]

    def frames(self, intervals) -> list:
        """The current candle's frame of every symbol and interval."""
        out = []
        for sym in self.symbols:
            t_1m = int(self.get_klines(sym, "1m", 1)[-1][0])
            for iv in intervals:
                row = self.get_klines(sym, iv, 2)[-1]
                step = interval_minutes(iv) * 60_000
                out.append(kline_frame(sym, iv, row, closed=(t_1m - int(row[0])) == step - 60_000))
        return out

    def window(self, symbol: str, length: int) -> dict:
        """The last ``length`` 1m candles up to the cursor, as the float32
        values the frames carry."""
        s = self.series[symbol]
        lo = self.cursor + 1 - length
        return {k: np.asarray(s[k][lo: self.cursor + 1], np.float32) for k in FIELDS}
