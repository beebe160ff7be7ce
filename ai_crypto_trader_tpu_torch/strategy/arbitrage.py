"""Triangle-arbitrage detection as a tensor contraction.

Capability parity with ArbitrageDetectionService
(`services/arbitrage_detection_service.py`): triangular cycle detection
(:261-341) and cycle-profit evaluation with fees and depth limits
(:342-433).  The reference builds a networkx digraph and enumerates cycles
in Python; here the exchange-rate matrix R[i,j] (units of j per unit of i,
0 where no market) makes every 3-cycle's gross product a single broadcast:

    P[a,b,c] = R[a,b] · R[b,c] · R[c,a] · (1-fee)³

— an O(n³) tensor evaluated on the device, with the best cycles read off
by a sort.  Depth-limited executable volume is evaluated on the reported
order-book sizes.

Port of `ai_crypto_trader_tpu/strategy/arbitrage.py`: `_cycle_profits`
runs on ``device`` (None: the CUDA card) in float32, in the JAX package's
order of operations, so its products are the JAX package's bit for bit;
the tensor comes back in one read (`host_read`), and the masking, the sort,
the dedupe and the top-k are the JAX package's NumPy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, upload


def host_read(values: torch.Tensor) -> np.ndarray:
    """The arbitrage scan's device→host read: ``values`` as a writable
    NumPy array, in one copy.  A module-level seam, so a caller can wrap it
    to count the reads."""
    return values.cpu().numpy().copy()


def _fee_cube(fee_rate: float) -> np.float32:
    """``(1 - fee_rate) ** 3`` as the JAX package's program computes it:
    the difference in float32, the cube as ``x · (x · x)`` (the order in
    which an integer power of 3 expands into multiplies)."""
    x = np.float32(1.0) - np.float32(fee_rate)
    return x * (x * x)


def _cycle_profits(R, fee_rate, device=None) -> torch.Tensor:
    """[n,n,n] net multiplier of a→b→c→a; 0 where any leg is missing.
    ``R`` is cast to float32 on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    R = R.to(dev, torch.float32) if torch.is_tensor(R) else upload(R, dev, torch.float32)
    g = (R[:, :, None] * R[None, :, :]) * R.T[:, None, :]
    return g * float(_fee_cube(fee_rate))


def build_rate_matrix(tickers: dict[str, dict], assets: list[str],
                      quote_assets=("USDC", "USDT", "BUSD")) -> np.ndarray:
    """Rate matrix from {symbol: {'bid': .., 'ask': ..}} tickers.
    R[i,j] = units of j received per unit of i sold (via the BASEQUOTE
    market: sell base at bid, buy base at ask)."""
    n = len(assets)
    idx = {a: i for i, a in enumerate(assets)}
    R = np.zeros((n, n), np.float64)
    for symbol, t in tickers.items():
        for q in quote_assets + tuple(assets):
            if symbol.endswith(q) and symbol[: -len(q)] in idx and q in idx:
                base, quote = symbol[: -len(q)], q
                bid = float(t.get("bid", t.get("price", 0.0)))
                ask = float(t.get("ask", t.get("price", 0.0)))
                if bid > 0:
                    R[idx[base], idx[quote]] = bid       # sell base → quote
                if ask > 0:
                    R[idx[quote], idx[base]] = 1.0 / ask  # quote → buy base
                break
    return R


def find_triangle_arbitrage(tickers: dict[str, dict], assets: list[str],
                            fee_rate: float = 0.001,
                            min_profit_pct: float = 0.1,
                            top_k: int = 5, device=None) -> list[dict]:
    """All profitable 3-cycles, best first (`:261-433`); the cycle tensor
    on ``device`` (None: the CUDA card), read back once."""
    P = host_read(_cycle_profits(build_rate_matrix(tickers, assets), fee_rate,
                                 device=device))
    n = len(assets)
    # mask degenerate cycles (repeated assets)
    ii = np.arange(n)
    P[ii, ii, :] = 0.0
    P[ii, :, ii] = 0.0
    P[:, ii, ii] = 0.0

    flat = P.reshape(-1)
    order = np.argsort(-flat)[: max(top_k * 4, top_k)]
    out = []
    seen = set()
    for f in order:
        profit_pct = (flat[f] - 1.0) * 100.0
        if profit_pct < min_profit_pct:
            break
        a, b, c = np.unravel_index(f, P.shape)
        cyc = frozenset((int(a), int(b), int(c)))
        if cyc in seen:
            continue
        seen.add(cyc)
        out.append({
            "cycle": [assets[a], assets[b], assets[c], assets[a]],
            "profit_pct": float(profit_pct),
            "gross_multiplier": float(flat[f]),
        })
        if len(out) >= top_k:
            break
    return out


def executable_volume(order_books: list[dict], cycle_sides: list[str]) -> float:
    """Depth-limited start volume (quote units) executable through a cycle
    (`:390-433`): the binding constraint across the three legs' top-of-book
    sizes."""
    vol = np.inf
    for ob, side in zip(order_books, cycle_sides):
        levels = ob["asks"] if side == "BUY" else ob["bids"]
        if not levels:
            return 0.0
        price, size = levels[0][0], levels[0][1]
        vol = min(vol, price * size)
    return float(vol if np.isfinite(vol) else 0.0)
