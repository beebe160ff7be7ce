"""Market-wide opportunity scanner: discover and rank tradable pairs.

Port of `ai_crypto_trader_tpu/shell/scanner.py` (capability parity with
`CryptoScanner.scan_market`, `binance_ml_strategy.py:293-468`).  Discovery
stays host-side (one `list_symbols` + one klines fetch per pair through the
injectable adapter); ALL the per-pair math is one pass over a dense
``[n_pairs, T]`` tensor on ``device`` — `ops.compute_indicators` over every
pair at once (two launches of the fused-EWMA kernel on the card), the
signal features and the score — and one host read.

Ranking (the reference's criteria, made explicit): volatility in a tradable
band, quote volume above a floor, and the technical signal strength of the
last candle as the opportunity score tiebreaker.  The thresholds are
float32, as in the jitted JAX function, which takes them as arguments:
divisions by them are true divisions, divisions by constants reciprocal
multiplies (`device.div_const`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch import ops
from ai_crypto_trader_tpu_torch.backtest import compute_signal_features, reference_signal
from ai_crypto_trader_tpu_torch.device import div_const, resolve_device, upload
from ai_crypto_trader_tpu_torch.shell.exchange import ExchangeInterface

FIELDS = ("score", "volatility", "quote_volume", "strength", "signal",
          "change_pct", "eligible")


def score_pairs(ohlcv: dict, min_quote_volume: float = 50_000.0,
                min_volatility: float = 0.001, max_volatility: float = 0.05,
                device=None) -> dict:
    """One device pass over [P, T] OHLCV: per-pair volatility, quote volume,
    last-candle signal/strength, and a composite opportunity score, as
    tensors [P] on ``device`` (None: the CUDA card).

    Score = strength/100 (signal quality) + volatility-band bonus + volume
    factor, zeroed for pairs failing the hard filters — the vectorized
    re-expression of scan_market's filter+rank."""
    dev = resolve_device(device)
    ohlcv = {k: upload(v, dev, torch.float32) for k, v in ohlcv.items()}
    mqv, vmin, vmax = upload(np.array(
        [min_quote_volume, min_volatility, max_volatility], np.float32), dev)
    ind = ops.compute_indicators(ohlcv, device=dev)
    feats = compute_signal_features(ind)
    signal, strength = reference_signal(feats)

    vol = feats.volatility[..., -1]                    # ATR/close, last candle
    close = ohlcv["close"]
    quote_vol = div_const(torch.sum(ohlcv["volume"] * close, -1), close.shape[-1])
    strength_last = strength[..., -1]
    signal_last = signal[..., -1]
    ret_24h = (close[..., -1] / close[..., 0] - 1.0) * 100.0

    in_band = (vol >= vmin) & (vol <= vmax)
    liquid = quote_vol >= mqv
    volume_factor = torch.clamp_max(quote_vol / (10.0 * mqv), 1.0)
    # center-of-band volatility scores highest
    band_mid = (vmin + vmax) * 0.5
    # max() guards a degenerate min==max band: the division would emit NaN
    # that survives the eligibility zeroing below
    band_half = torch.clamp_min((vmax - vmin) * 0.5, 1e-9)
    vol_score = 1.0 - torch.abs(vol - band_mid) / band_half

    score = div_const(strength_last, 100.0) + vol_score + volume_factor
    score = torch.where(in_band & liquid, score, 0.0)
    return {
        "score": score,
        "volatility": vol,
        "quote_volume": quote_vol,
        "strength": strength_last,
        "signal": signal_last,
        "change_pct": ret_24h,
        "eligible": in_band & liquid,
    }


def host_read(out: dict) -> dict:
    """`score_pairs`' outputs in ONE device→host copy (every field packed
    into float32, which carries the signal and the eligibility exactly), as
    NumPy arrays with the JAX function's dtypes.  A module-level seam, so a
    caller can wrap it to count reads."""
    packed = torch.stack([out[k].to(torch.float32) for k in FIELDS]).cpu().numpy()
    host = dict(zip(FIELDS, packed))
    host["signal"] = host["signal"].astype(np.int32)
    host["eligible"] = host["eligible"].astype(bool)
    return host


@dataclass
class MarketScanner:
    """Host-side discovery + device-side ranking.

    The symbol universe stops being a config constant: `scan()` discovers
    all pairs for the quote asset, scores them in one pass on ``device``
    (None: the CUDA card), and returns the top-k as opportunity dicts the
    monitor/launcher can adopt as their trading universe."""

    exchange: ExchangeInterface
    quote: str = "USDC"
    interval: str = "1m"
    lookback: int = 256
    min_quote_volume: float = 50_000.0
    min_volatility: float = 0.001
    max_volatility: float = 0.05
    top_k: int = 10
    last_scan: list = field(default_factory=list)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def discover(self) -> list[str]:
        return self.exchange.list_symbols(quote=self.quote)

    def scan(self, symbols: list[str] | None = None) -> list[dict]:
        symbols = symbols if symbols is not None else self.discover()
        if not symbols:
            self.last_scan = []
            return []

        cols = {k: [] for k in ("open", "high", "low", "close", "volume")}
        kept = []
        for sym in symbols:
            # one klines call per pair is the whole per-pair I/O budget
            # (the reference's scan_market makes several calls per pair)
            try:
                rows = self.exchange.get_klines(sym, interval=self.interval,
                                                limit=self.lookback)
            except Exception:
                continue
            if len(rows) < 2:
                continue
            arr = np.asarray(rows, np.float64)[:, 1:6].astype(np.float32)
            if len(arr) < self.lookback:      # left-pad flat (no fake moves)
                pad = np.repeat(arr[:1], self.lookback - len(arr), axis=0)
                arr = np.concatenate([pad, arr])
            for j, k in enumerate(("open", "high", "low", "close", "volume")):
                cols[k].append(arr[:, j])
            kept.append(sym)
        if not kept:
            self.last_scan = []
            return []

        batch = {k: np.stack(v) for k, v in cols.items()}
        out = host_read(score_pairs(batch, min_quote_volume=self.min_quote_volume,
                                    min_volatility=self.min_volatility,
                                    max_volatility=self.max_volatility,
                                    device=self.device))
        order = np.argsort(-out["score"])
        ranked = []
        for i in order[: self.top_k]:
            if not out["eligible"][i]:
                continue
            ranked.append({
                "symbol": kept[i],
                "score": float(out["score"][i]),
                "volatility": float(out["volatility"][i]),
                "quote_volume": float(out["quote_volume"][i]),
                "strength": float(out["strength"][i]),
                "signal": int(out["signal"][i]),
                "change_pct": float(out["change_pct"][i]),
            })
        self.last_scan = ranked
        return ranked

    def top_symbols(self, symbols: list[str] | None = None) -> list[str]:
        """The discovered trading universe — what the launcher/monitor use
        instead of a configured symbol list."""
        return [o["symbol"] for o in self.scan(symbols)]
