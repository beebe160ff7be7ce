"""OHLCV ingest: CSV / dict → dense float32 arrays.

The port's own copy of the part of `ai_crypto_trader_tpu/data/ingest.py`
(lines 26-108) that `cli backtest` needs: the `OHLCV` column bundle,
`from_dict` and `load_csv`.  The CSV layout is the reference's cache layout
(``backtesting/data/market/<symbol>/<symbol>_<interval>.csv``).  Host-side
ingest stays NumPy; tensors are made where the compute path starts
(`ops.compute_indicators`).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Mapping

import numpy as np

FIELDS = ("open", "high", "low", "close", "volume")


@dataclass
class OHLCV:
    """A column-oriented candle series. ``timestamp`` is epoch-ms int64."""

    timestamp: np.ndarray
    open: np.ndarray
    high: np.ndarray
    low: np.ndarray
    close: np.ndarray
    volume: np.ndarray
    symbol: str = ""
    interval: str = "1m"

    def __len__(self):
        return int(self.close.shape[0])

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in FIELDS}

    def slice(self, start: int, stop: int) -> "OHLCV":
        return OHLCV(
            timestamp=self.timestamp[start:stop],
            **{f: getattr(self, f)[start:stop] for f in FIELDS},
            symbol=self.symbol,
            interval=self.interval,
        )


def from_dict(d: Mapping[str, np.ndarray], symbol: str = "", interval: str = "1m") -> OHLCV:
    n = len(d["close"])
    ts = d.get("timestamp", np.arange(n, dtype=np.int64) * 60_000)
    return OHLCV(timestamp=np.asarray(ts, dtype=np.int64),
                 **{f: np.asarray(d[f], np.float32) for f in FIELDS},
                 symbol=symbol, interval=interval)


def load_csv(path: str, symbol: str = "", interval: str = "1m") -> OHLCV:
    rows = []
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        idx = {name: header.index(name) for name in ("timestamp",) + FIELDS}
        for row in r:
            rows.append([row[idx["timestamp"]]] + [row[idx[k]] for k in FIELDS])
    arr = np.asarray(rows, dtype=np.float64)
    return OHLCV(
        timestamp=arr[:, 0].astype(np.int64),
        open=arr[:, 1].astype(np.float32),
        high=arr[:, 2].astype(np.float32),
        low=arr[:, 3].astype(np.float32),
        close=arr[:, 4].astype(np.float32),
        volume=arr[:, 5].astype(np.float32),
        symbol=symbol,
        interval=interval,
    )
