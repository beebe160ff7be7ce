"""Trading-pair symbol helpers shared by every layer that splits
``BTCUSDC``-style pairs (exchange fills, portfolio marking, fetch ticker
derivation — previously three divergent inline copies).

The port's own copy of `ai_crypto_trader_tpu/utils/symbols.py`.
"""

from __future__ import annotations

QUOTE_ASSETS = ("USDC", "USDT", "BUSD")


def split_symbol(symbol: str, default_quote: str = "USDC") -> tuple[str, str]:
    """``"BTCUSDC" -> ("BTC", "USDC")``; unknown quote suffix yields the
    whole symbol as base with the default quote."""
    for quote in QUOTE_ASSETS:
        if symbol.endswith(quote):
            return symbol[: -len(quote)], quote
    return symbol, default_quote


def base_asset(symbol: str) -> str:
    return split_symbol(symbol)[0]


def quote_asset(symbol: str) -> str:
    return split_symbol(symbol)[1]


def mark_holdings(balances: dict, symbols: list, get_market_data) -> dict:
    """asset → marked value: quote balances at par, each base holding at
    the latest price of the FIRST configured symbol trading it (dedup by
    base — BTCUSDC and BTCUSDT both trading BTC must not double-count the
    one BTC balance). Shared by the launcher's portfolio_value_usd gauge
    and the dashboard's allocation panel."""
    values = {a: v for a, v in balances.items()
              if a in QUOTE_ASSETS and v > 0}
    seen = set()
    for symbol in symbols:
        base = base_asset(symbol)
        if base in seen:
            continue
        md = get_market_data(symbol)
        qty = balances.get(base, 0.0)
        if md and qty > 0:
            values[base] = qty * md["current_price"]
            seen.add(base)
    return values
