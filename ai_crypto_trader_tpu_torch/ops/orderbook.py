"""Order-book analytics as tensor programs.

Port of `ai_crypto_trader_tpu/ops/orderbook.py` (the reference's
OrderBookAnalyzer):

  * bid/ask imbalance and depth metrics;
  * the price impact of market orders for a ladder of quote-value sizes,
    walking the book as cumulative-sum searches, all sizes at once;
  * support/resistance walls — levels holding a multiple of the mean size;
  * order clustering — k-means over (price, size) on `regime.cluster`;
  * near-book pressure and the microprice;
  * microstructure: Gini concentration, spoofing / iceberg heuristics;
  * the composite order-book signal.

Books are [N, 2] (price, size), bids descending, asks ascending.
`price_impact`, `find_walls` and `pressure_metrics` also take leading
batch dims ([..., N, 2]): every reduction is over the trailing level axis,
so a capture window of books is one program (`sim.calibrate` reads its
window's analytics through `_pressure` and `_impact`, the same code).

Entry points take ``device=None`` (the CUDA card; ``device="cpu"`` asks for
the CPU) and move their inputs there as float32.  `orderbook_signal` reads
every number it reports in one copy to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, to_device

DEFAULT_TRADE_SIZES = (10_000.0, 50_000.0, 100_000.0, 500_000.0, 1_000_000.0)


def _f32(x, device) -> torch.Tensor:
    return to_device(x, resolve_device(device), torch.float32)


def imbalance(bids, asks, device=None) -> dict:
    """Volume imbalance, depth, value, mid, spread (0-d tensors)."""
    bids, asks = _f32(bids, device), _f32(asks, device)
    bid_vol = bids[..., 1].sum(dim=-1)
    ask_vol = asks[..., 1].sum(dim=-1)
    total = bid_vol + ask_vol
    best_bid, best_ask = bids[..., 0, 0], asks[..., 0, 0]
    mid = (best_bid + best_ask) / 2.0
    spread = best_ask - best_bid
    return {
        "imbalance": (bid_vol - ask_vol) / torch.where(total == 0, 1.0, total),
        "bid_volume": bid_vol, "ask_volume": ask_vol,
        "bid_value": (bids[..., 0] * bids[..., 1]).sum(dim=-1),
        "ask_value": (asks[..., 0] * asks[..., 1]).sum(dim=-1),
        "mid_price": mid, "spread": spread,
        "spread_bps": spread / mid * 10_000.0,
    }


def _impact(levels: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """[..., n_sizes] relative impact of market orders of each quote-value
    size walking one side of each book [..., N, 2]: the quote-value-weighted
    average fill price against the best price (a size beyond the book's
    depth gets the whole book's)."""
    price = levels[..., 0]
    values = price * levels[..., 1]
    cum = torch.cumsum(values, dim=-1)
    prev = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=-1).unsqueeze(-2)
    take = torch.minimum(torch.clamp_min(sizes[:, None] - prev, 0.0),
                         values.unsqueeze(-2))                # [..., S, N]
    filled = take.sum(dim=-1)
    avg = (take * price.unsqueeze(-2)).sum(dim=-1) / torch.where(filled == 0, 1.0, filled)
    best = price[..., :1]
    return torch.abs(avg - best) / best


def price_impact(levels, trade_sizes, device=None) -> torch.Tensor:
    """Impact (fraction of the best price) of market orders of each
    quote-value size: [N, 2] → [n_sizes], or [..., N, 2] → [..., n_sizes]."""
    levels = _f32(levels, device)
    return _impact(levels, to_device(trade_sizes, levels.device, torch.float32))


def find_walls(levels, multiple: float = 3.0, device=None) -> torch.Tensor:
    """Wall mask: levels holding ≥ ``multiple`` × the book's mean size
    (per trailing book)."""
    levels = _f32(levels, device)
    mean_size = levels[..., 1].mean(dim=-1, keepdim=True)
    return levels[..., 1] >= multiple * mean_size


def _pressure(bids: torch.Tensor, asks: torch.Tensor, near_levels: int = 5) -> dict:
    """Near-book pressure over books [..., N, 2]: the top levels' volume
    imbalance, the microprice and its tilt from the mid in bps."""
    nb = bids[..., :near_levels, 1].sum(dim=-1)
    na = asks[..., :near_levels, 1].sum(dim=-1)
    total = nb + na
    denom = torch.where(total == 0, 1.0, total)
    best_bid, best_ask = bids[..., 0, 0], asks[..., 0, 0]
    micro = (best_bid * na + best_ask * nb) / denom
    mid = (best_bid + best_ask) / 2.0
    return {"near_pressure": (nb - na) / denom,
            "microprice": micro,
            "microprice_tilt_bps": (micro - mid) / mid * 10_000.0}


def pressure_metrics(bids, asks, near_levels: int = 5, device=None) -> dict:
    """Near-book pressure, microprice and its tilt (batched over leading
    dims)."""
    return _pressure(_f32(bids, device), _f32(asks, device), near_levels)


def gini_concentration(levels, device=None) -> torch.Tensor:
    """Gini coefficient of size concentration across levels."""
    sizes = torch.sort(_f32(levels, device)[:, 1]).values
    n = sizes.shape[0]
    i = torch.arange(1, n + 1, device=sizes.device, dtype=torch.int32)
    total = sizes.sum()
    return torch.where(total > 0, (2.0 * (i * sizes).sum() / (n * total)) - (n + 1.0) / n,
                       0.0)


def microstructure_flags(levels: np.ndarray, mid: float, far_threshold_pct: float = 1.0,
                         spoof_volume_frac: float = 0.4,
                         iceberg_uniform_tol: float = 0.02) -> dict:
    """Spoofing / iceberg heuristics (host NumPy): spoofing — a large volume
    fraction parked far from mid; iceberg — suspiciously uniform sizes."""
    levels = np.asarray(levels)
    dist_pct = np.abs(levels[:, 0] - mid) / mid * 100.0
    far = dist_pct > far_threshold_pct
    far_frac = levels[far, 1].sum() / max(levels[:, 1].sum(), 1e-12)
    sizes = levels[:, 1]
    cv = sizes.std() / max(sizes.mean(), 1e-12)
    return {
        "spoofing_suspected": bool(far_frac > spoof_volume_frac),
        "far_volume_fraction": float(far_frac),
        "iceberg_suspected": bool(cv < iceberg_uniform_tol and len(sizes) >= 5),
        "size_cv": float(cv),
    }


def cluster_orders(levels, k: int = 3, seed: int = 0, key=None, device=None) -> dict:
    """k-means clusters over the standardised (price, size) of the levels.
    The first centroid's draw comes from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, or ``key`` (a generator or an integer index)."""
    from ai_crypto_trader_tpu_torch.regime.cluster import (
        kmeans_fit, kmeans_predict, standardize_fit)

    x = _f32(levels, device)
    z = standardize_fit(x, device=x.device).transform(x)
    if key is None:
        key = torch.Generator(x.device).manual_seed(seed)
    labels = kmeans_predict(kmeans_fit(key, z, k, iters=25, device=x.device), z).cpu().numpy()
    lv = np.asarray(levels)
    out = []
    for c in range(k):
        m = labels == c
        if m.sum():
            out.append({"center_price": float(lv[m, 0].mean()),
                        "total_size": float(lv[m, 1].sum()),
                        "n_levels": int(m.sum())})
    return {"clusters": sorted(out, key=lambda c: -c["total_size"]), "labels": labels}


def orderbook_signal(bids, asks, device=None) -> dict:
    """Composite signal: imbalance + near pressure + wall asymmetry vote.
    Every number is computed on ``device`` and read in one copy."""
    b, a = _f32(bids, device), _f32(asks, device)
    dev = b.device
    imb, pres = imbalance(b, a, device=dev), _pressure(b, a)
    walls = {"bid_walls": find_walls(b, device=dev).sum(),
             "ask_walls": find_walls(a, device=dev).sum()}
    gini = {"gini_bids": gini_concentration(b, device=dev),
            "gini_asks": gini_concentration(a, device=dev)}
    parts = {**{f"i.{k}": v for k, v in imb.items()}, **{f"p.{k}": v for k, v in pres.items()},
             **walls, **gini}
    host = dict(zip(parts, torch.stack([v.float() for v in parts.values()]).cpu().tolist()))
    imb = {k: host[f"i.{k}"] for k in imb}
    pres = {k: host[f"p.{k}"] for k in pres}
    bid_walls, ask_walls = int(host["bid_walls"]), int(host["ask_walls"])
    score = (imb["imbalance"] * 0.5 + pres["near_pressure"] * 0.3
             + np.sign(bid_walls - ask_walls) * 0.2)
    return {
        "signal": "BUY" if score > 0.2 else "SELL" if score < -0.2 else "NEUTRAL",
        "score": float(score),
        "imbalance": imb, "pressure": pres,
        "bid_walls": bid_walls, "ask_walls": ask_walls,
        "gini_bids": host["gini_bids"], "gini_asks": host["gini_asks"],
    }
