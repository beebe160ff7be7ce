"""OHLCV ingest: exchange klines / CSV / dict → dense float32 arrays.

The port's own copy of `ai_crypto_trader_tpu/data/ingest.py` (lines
26-139): the `OHLCV` column bundle, `klines_to_arrays`, `from_dict`,
`save_csv`/`load_csv`, and the social-metrics CSVs with their `SocialDaily`
bundle (the JAX package keeps that one in `data/fetchers.py`; the port's
fetchers import it from here).  The CSV layout is the reference's cache layout
(``backtesting/data/market/<symbol>/<symbol>_<interval>.csv`` and
``backtesting/data/social/<symbol>/<symbol>_daily.csv``).  Host-side ingest
stays NumPy; tensors are made where the compute path starts
(`ops.compute_indicators`, `ops.tick_engine.TickEngine`).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Mapping, Sequence

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


def klines_to_arrays(klines: Sequence[Sequence], symbol: str = "", interval: str = "1m") -> OHLCV:
    """Convert Binance-format klines (12-column rows) to an OHLCV bundle."""
    arr = np.asarray([row[:6] for row in klines], dtype=np.float64)
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


def from_dict(d: Mapping[str, np.ndarray], symbol: str = "", interval: str = "1m") -> OHLCV:
    n = len(d["close"])
    ts = d.get("timestamp", np.arange(n, dtype=np.int64) * 60_000)
    return OHLCV(timestamp=np.asarray(ts, dtype=np.int64),
                 **{f: np.asarray(d[f], np.float32) for f in FIELDS},
                 symbol=symbol, interval=interval)


def save_csv(data: OHLCV, root: str) -> str:
    path = os.path.join(root, "market", data.symbol or "UNKNOWN")
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"{data.symbol}_{data.interval}.csv")
    with open(fname, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("timestamp",) + FIELDS)
        for i in range(len(data)):
            w.writerow([int(data.timestamp[i])] + [float(getattr(data, k)[i]) for k in FIELDS])
    return fname


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


@dataclass
class SocialDaily:
    """Daily social metrics columns (epoch-s timestamps)."""

    timestamp: np.ndarray                 # int64 epoch-seconds, ascending
    columns: dict = field(default_factory=dict)   # name -> f32[n]

    def __len__(self):
        return int(self.timestamp.shape[0])


def save_social_csv(daily: SocialDaily, symbol: str, root: str) -> str:
    """Persist a SocialDaily series in the reference's cache layout."""
    path = os.path.join(root, "social", symbol or "UNKNOWN")
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"{symbol}_daily.csv")
    names = sorted(daily.columns)
    with open(fname, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["timestamp"] + names)
        for i in range(len(daily)):
            w.writerow([int(daily.timestamp[i])]
                       + [float(daily.columns[k][i]) for k in names])
    return fname


def load_social_csv(path: str) -> SocialDaily:
    """Load a SocialDaily series saved by save_social_csv."""
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        rows = [row for row in r]
    if not rows:
        return SocialDaily(np.zeros(0, np.int64))
    arr = np.asarray(rows, dtype=np.float64)
    cols = {name: arr[:, j + 1].astype(np.float32)
            for j, name in enumerate(header[1:])}
    return SocialDaily(arr[:, 0].astype(np.int64), cols)
