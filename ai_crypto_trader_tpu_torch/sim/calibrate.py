"""Calibrate the order-flow book's parameters from captured depth frames.

Port of `ai_crypto_trader_tpu/sim/calibrate.py`: fits the `sim.lob.
FlowParams` the simulator consumes from snapshot depth records (a depth
capture's ring or journal entries), so the stress sweep trades against
microstructure measured from a venue instead of guessed constants.

The fit inverts the flow model level by level (venue level index ↔ model
grid level; real books have price gaps, the model a dense tick grid):

  * **tick / spread0**  the median adjacent-level price gap and the mean
    touch spread;
  * **depth_decay / steady depth**  a log-linear fit of the mean per-level
    size profile (both sides averaged);
  * **cancel_rate**  −slope of the per-level size deltas regressed on the
    standing size (``Δsz = arrivals − frac·sz``; levels ≥ 2, where trades
    don't bite), clipped to [1e-4, 0.5] — the simulator's cancel draw
    ``clip(2c·u, 0, 1)`` is mean-c only up to 0.5;
  * **limit_rate**  gross arrivals from the same identity, over the fitted
    profile's mass;
  * **market_rate / market_size**  touch depletion beyond the cancel share;
  * **drift / vol / mid0**  from the mid-price series.

The fit is host NumPy in float64, as the JAX package's; the FlowParams it
returns are float32 tensors on ``device``.  The report's book analytics
(near-book pressure, microprice tilt, the impact curve over the whole
window) are batched float32 tensor programs over the [F] frames, on
``device``, through `ops.orderbook` (its `pressure_metrics` and
`price_impact` math).
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.ops.orderbook import _impact, _pressure
from ai_crypto_trader_tpu_torch.sim.lob import FlowParams, flow_params


class CalibrationPoisoned(ValueError):
    """A capture window that must NOT reach the fit: too few snapshots,
    NaN/Inf prices or sizes, a non-positive spread, or a side with zero
    standing depth."""


def validate_depth_records(records, symbol: str | None = None, min_records: int = 2) -> None:
    """Reject a poisoned calibration window before it reaches the fit:
    raises :class:`CalibrationPoisoned`; returns None on a clean window.
    Only snapshot records (the fit's input) of ``symbol`` (any if None)
    count."""
    books = [r for r in records
             if r.get("kind") == "snapshot" and r.get("bids") and r.get("asks")
             and (symbol is None or r.get("symbol") == symbol)]
    if len(books) < max(int(min_records), 1):
        raise CalibrationPoisoned(
            f"calibration window has {len(books)} usable snapshot records "
            f"(need >= {min_records})")
    for i, rec in enumerate(books):
        bids = np.asarray(rec["bids"], np.float64)
        asks = np.asarray(rec["asks"], np.float64)
        if not (np.isfinite(bids).all() and np.isfinite(asks).all()):
            raise CalibrationPoisoned(f"snapshot {i} carries NaN/Inf levels (poisoned capture)")
        if (bids[:, 1] <= 0).all() or (asks[:, 1] <= 0).all():
            raise CalibrationPoisoned(f"snapshot {i} has a zero-depth side (starved book)")
        spread = float(asks[0, 0] - bids[0, 0])
        if spread <= 0:
            raise CalibrationPoisoned(
                f"snapshot {i} spread {spread} <= 0 (crossed/degenerate book)")


def frames_to_arrays(records, levels: int | None = None, symbol: str | None = None) -> dict:
    """Stack snapshot depth records into float64 arrays ``{"bids": [F, N,
    2], "asks": [F, N, 2], "mid": [F], "symbol": str}``.  Diff records are
    level CHANGES, not books, and are skipped.  Frames are filtered to
    ``symbol`` (default: the capture's most common symbol; a requested
    symbol with no frames raises) and cut to the smallest common level
    count (or ``levels``)."""
    books = [r for r in records
             if r.get("bids") and r.get("asks") and r.get("kind", "snapshot") == "snapshot"]
    if not books:
        raise ValueError(
            "no depth frames with both book sides to fit from (diff-kind records are "
            "level deltas, not books — capture @depth20 snapshots for calibration)")
    if symbol is None:
        symbols = [r.get("symbol", "") for r in books]
        symbol = max(set(symbols), key=symbols.count)
        books = [r for r in books if r.get("symbol", "") == symbol] or books
    else:
        books = [r for r in books if r.get("symbol", "") == symbol]
        if not books:
            raise ValueError(f"no depth frames for symbol {symbol!r} in the capture")
    n = min(min(len(r["bids"]), len(r["asks"])) for r in books)
    if levels is not None:
        n = min(n, int(levels))
    if n < 2:
        raise ValueError("need at least 2 levels per side to fit a profile")
    bids = np.asarray([r["bids"][:n] for r in books], np.float64)
    asks = np.asarray([r["asks"][:n] for r in books], np.float64)
    mid = (bids[:, 0, 0] + asks[:, 0, 0]) / 2.0
    return {"bids": bids, "asks": asks, "mid": mid, "symbol": symbol}


def _log_linear(profile: np.ndarray) -> tuple[float, float]:
    """Fit ``profile[i] ≈ scale·exp(−decay·i)``: (scale, decay)."""
    i = np.arange(len(profile), dtype=np.float64)
    y = np.log(np.maximum(profile, 1e-12))
    slope, intercept = np.polyfit(i, y, 1)
    return float(np.exp(intercept)), float(max(-slope, 1e-4))


def fit_flow_params(records, levels: int | None = None, symbol: str | None = None,
                    queue_frac: float = 0.0, device=None) -> tuple[FlowParams, dict]:
    """`FlowParams` on ``device`` fitted from captured depth records, and a
    report (the measured profiles and the book analytics); the estimators
    are the module docstring's.  ``queue_frac`` is not observable from
    depth frames alone and passes through."""
    dev = resolve_device(device)
    arr = frames_to_arrays(records, levels=levels, symbol=symbol)
    bids, asks, mid = arr["bids"], arr["asks"], arr["mid"]
    F, N = bids.shape[0], bids.shape[1]

    # price geometry
    gaps = np.concatenate([np.abs(np.diff(bids[:, :, 0], axis=1)),
                           np.abs(np.diff(asks[:, :, 0], axis=1))], axis=1)
    tick = float(np.median(gaps / mid[:, None]))
    rel_spread = float(np.mean((asks[:, 0, 0] - bids[:, 0, 0]) / mid))
    spread0 = max(rel_spread / (2.0 * tick), 0.5)

    # standing depth profile
    mean_depth = (bids[:, :, 1].mean(axis=0) + asks[:, :, 1].mean(axis=0)) / 2.0
    steady0, depth_decay = _log_linear(mean_depth)

    # gross flow rates from the identity Δsz = arrivals − cancel_frac·sz
    d_bid = np.diff(bids[:, :, 1], axis=0)
    d_ask = np.diff(asks[:, :, 1], axis=0)
    deltas = np.concatenate([d_bid, d_ask], axis=0)       # [2(F-1), N]
    standing = np.concatenate([bids[:-1, :, 1], asks[:-1, :, 1]], axis=0)
    inflow = np.maximum(deltas, 0.0)
    outflow = np.maximum(-deltas, 0.0)
    profile = np.exp(-depth_decay * np.arange(N))
    clean = range(2, N) if N >= 4 else range(N)
    slopes = []
    for d_side, s_side in ((d_bid, bids[:-1, :, 1]), (d_ask, asks[:-1, :, 1])):
        for i in clean:
            var = s_side[:, i].var()
            if var > 1e-12:
                slopes.append(np.cov(d_side[:, i], s_side[:, i])[0, 1] / var)
    cancel_rate = float(-np.mean(slopes)) if slopes else 0.05
    cancel_rate = min(max(cancel_rate, 1e-4), 0.5)
    gross_arr = np.maximum(deltas.mean(axis=0) + cancel_rate * standing.mean(axis=0), 0.0)
    limit_rate = float(gross_arr.sum() / profile.sum())

    # market orders: touch depletion beyond the cancel share
    excess = np.maximum(outflow[:, 0] - cancel_rate * standing[:, 0], 0.0)
    hit = excess > 0.05 * max(float(standing[:, 0].mean()), 1e-12)
    market_rate = float(np.clip(hit.mean(), 0.01, 0.95))
    market_size = float(excess[hit].mean()) if hit.any() else float(mean_depth[0] * 0.1)

    # mid dynamics
    rets = np.diff(np.log(np.maximum(mid, 1e-12)))
    drift = float(rets.mean()) if len(rets) else 0.0
    vol = float(rets.std()) if len(rets) else 0.0

    fitted = flow_params(
        limit_rate=limit_rate, depth_decay=depth_decay, cancel_rate=cancel_rate,
        market_rate=market_rate, market_size=market_size, tick=tick, spread0=spread0,
        queue_frac=queue_frac, mid0=float(mid.mean()), drift=drift, vol=vol, device=dev)
    report = {
        "symbol": arr["symbol"], "frames": F, "levels": N,
        "mean_depth_profile": mean_depth,
        "fitted_steady_depth": steady0,
        "model_steady_depth": limit_rate * profile / cancel_rate,
        "mean_rel_spread": rel_spread,
        "arrival_rate_per_level": gross_arr,
        "net_inflow_per_level": inflow.mean(axis=0),
        "net_outflow_per_level": outflow.mean(axis=0),
    }
    report.update(_book_analytics(bids, asks, dev))
    return fitted, report


def fit_report_only(records, **kw) -> dict:
    return fit_flow_params(records, **kw)[1]


def _book_analytics(bids: np.ndarray, asks: np.ndarray, device) -> dict:
    """The whole window's microstructure readout as batched float32 programs
    over the [F] frames on ``device``: mean near-book pressure, mean
    microprice tilt, and the mean impact curve at 5 %, 25 % and 50 % of the
    mean bid-side notional."""
    b = torch.as_tensor(bids, dtype=torch.float32).to(device)
    a = torch.as_tensor(asks, dtype=torch.float32).to(device)
    pres = _pressure(b, a)
    notional = float(np.mean(bids[:, 0, 0] * bids[:, :, 1].sum(axis=1)))
    sizes = torch.tensor([notional * f for f in (0.05, 0.25, 0.5)], dtype=torch.float32,
                         device=device)
    impact = _impact(a, sizes).cpu().numpy()
    return {
        "mean_near_pressure": float(np.mean(pres["near_pressure"].cpu().numpy())),
        "mean_microprice_tilt_bps": float(np.mean(pres["microprice_tilt_bps"].cpu().numpy())),
        "mean_impact_curve": impact.mean(axis=0),
    }


def records_from_lob_series(series: dict, tick: float, scenario: int = 0,
                            levels: int | None = None, stride: int = 1,
                            symbol: str = "SIMUSDC") -> list:
    """Depth records (the capture's snapshot shape) from a
    `lob.rollout_lob(return_book=True)` result's ``series``: [B, T, L]
    ``bid_sz`` / ``ask_sz`` and [B, T] ``best_bid`` / ``best_ask``, level
    prices rebuilt from the grid (level i one relative ``tick`` further
    from the touch) — the recorded-fixture generator of calibration tests."""
    bid_sz = np.asarray(series["bid_sz"][scenario], np.float64)
    ask_sz = np.asarray(series["ask_sz"][scenario], np.float64)
    best_bid = np.asarray(series["best_bid"][scenario], np.float64)
    best_ask = np.asarray(series["best_ask"][scenario], np.float64)
    T, L = bid_sz.shape
    n = L if levels is None else min(levels, L)
    mid = (best_bid + best_ask) / 2.0
    lv = np.arange(n)
    records = []
    for t in range(0, T, max(int(stride), 1)):
        gap = mid[t] * tick
        records.append({
            "symbol": symbol, "kind": "snapshot", "E": t, "U": t, "u": t,
            "bids": [[float(best_bid[t] - i * gap), float(s)] for i, s in zip(lv, bid_sz[t, :n])],
            "asks": [[float(best_ask[t] + i * gap), float(s)] for i, s in zip(lv, ask_sz[t, :n])],
        })
    return records
