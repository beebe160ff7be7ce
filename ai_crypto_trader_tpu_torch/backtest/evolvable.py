"""The evolvable strategy: all 18 GA parameters drive a real backtest.

Port of `ai_crypto_trader_tpu/backtest/evolvable.py`:

  periods → indicators with tensor periods (ops/dynamic.py)
  thresholds → the vote rule (TradingSignal's scoring shape with evolved
               cut-offs)
  stop_loss / take_profit / atr_multiplier → the replay's per-candle exits
  social thresholds → votes from (optional) social metric series

so fitness is a real backtest.  Where the JAX package vmaps over genomes,
the population here is the leading dimension of a StrategyParams whose
leaves are [pop] (or scalars for one genome); every genome's signal,
strength, volatility and SL/TP become a row [pop, T], and
`engine.run_backtest` replays the rows — through the replay kernel K1's
rows form on the card, through the engine's plain loop on the CPU.

Period tables: every evolved period is a small integer range, so
`build_indicator_tables` computes each integer period's row once per
market window ([n_periods, T]; the EMA family in the fused-EWMA kernel K2,
five launches for the 141 EWMA rows), and the population's eval gathers
rows by genome period.  ``tables=None`` keeps the direct per-genome path,
the parity oracle.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.backtest import signals as sig
from ai_crypto_trader_tpu_torch.backtest.engine import BacktestInputs, run_backtest
from ai_crypto_trader_tpu_torch.backtest.strategy import PARAM_RANGES, StrategyParams
from ai_crypto_trader_tpu_torch.device import div_const, resolve_device, to_device
from ai_crypto_trader_tpu_torch.ops import dynamic as dyn
from ai_crypto_trader_tpu_torch.ops.indicators import nanfill

# Static loop bounds from the parameter ranges (PARAM_RANGES highs).
WMAX_BB = int(PARAM_RANGES["bollinger_period"][1])      # 30
WMAX_VOL = int(PARAM_RANGES["volume_ma_period"][1])     # 30

# Integer period grids (inclusive).  One EMA grid serves ema_short,
# ema_long, macd_fast and macd_slow (the MACD line is a difference of two
# EMA rows).
_EMA_LO = int(min(PARAM_RANGES["ema_short"][0], PARAM_RANGES["macd_fast"][0]))
_EMA_HI = int(max(PARAM_RANGES["ema_long"][1], PARAM_RANGES["macd_slow"][1]))
_RSI_LO, _RSI_HI = (int(v) for v in PARAM_RANGES["rsi_period"][:2])
_ATR_LO, _ATR_HI = (int(v) for v in PARAM_RANGES["atr_period"][:2])
_BB_LO, _BB_HI = (int(v) for v in PARAM_RANGES["bollinger_period"][:2])
_VOL_LO, _VOL_HI = (int(v) for v in PARAM_RANGES["volume_ma_period"][:2])

_OHLCV = ("close", "high", "low", "volume")


class SocialInputs(NamedTuple):
    """Optional per-candle social metrics (sentiment 0-100, volume,
    engagement) — the axes the social thresholds gate on."""

    sentiment: torch.Tensor
    volume: torch.Tensor
    engagement: torch.Tensor


class IndicatorTables(NamedTuple):
    """Per-integer-period indicator rows over one market window.

    Every leaf is [n_periods, T] except ``atr_median`` ([n_periods], the
    per-period median of ATR/close).  The ``_fill`` tables hold nanfill-ed
    rows; ``ema_raw`` keeps the warmup NaNs for the MACD line."""

    ema_raw: torch.Tensor     # spans _EMA_LO.._EMA_HI, warmup NaN
    ema_fill: torch.Tensor    # nanfill(ema_raw) — the trend EMAs
    rsi_fill: torch.Tensor    # periods _RSI_LO.._RSI_HI
    atr_fill: torch.Tensor    # periods _ATR_LO.._ATR_HI
    atr_median: torch.Tensor  # median(nanfill(atr)/close) per atr period
    bb_mid: torch.Tensor      # bollinger middle band per period (raw)
    bb_sd: torch.Tensor       # bollinger rolling std per period (raw)
    vol_ma_fill: torch.Tensor  # volume MA per period


def _arrays(ohlcv: dict, dev) -> dict:
    return {k: to_device(ohlcv[k], dev, torch.float32) for k in _OHLCV}


def _grid(lo: int, hi: int, dev) -> torch.Tensor:
    """The integer periods lo..hi as a float32 column [n, 1]."""
    return torch.arange(lo, hi + 1, dtype=torch.float32, device=dev)[:, None]


def median(x) -> torch.Tensor:
    """`jnp.median` over the last axis: the two middle values of the sorted
    row averaged as (low + high) · 0.5 in float32 (one value for an odd
    count), NaN where the row holds a NaN."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    mid = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(-1), math.nan, mid)


def build_indicator_tables(ohlcv: dict, device=None) -> IndicatorTables:
    """Every integer-period indicator row for one window, on ``device``
    (default: the CUDA card).  The EMA family's 141 rows (96 EMA spans on
    close; 26 Wilder periods on the gains and losses, two series; 19 on
    the true range) are 19 jobs of at most 8 alphas in 5 launches of the
    fused-EWMA kernel; their periods are ``range``s, so the alphas are made
    on the host and the build reads nothing back from the device."""
    dev = resolve_device(device)
    a = _arrays(ohlcv, dev)
    close, high, low, volume = (a[k] for k in _OHLCV)
    ema_raw = dyn.ema_dyn(close, range(_EMA_LO, _EMA_HI + 1))
    atr_fill = nanfill(dyn.atr_dyn(high, low, close, range(_ATR_LO, _ATR_HI + 1)))
    bb = _grid(_BB_LO, _BB_HI, dev)
    return IndicatorTables(
        ema_raw=ema_raw,
        ema_fill=nanfill(ema_raw),
        rsi_fill=nanfill(dyn.rsi_dyn(close, range(_RSI_LO, _RSI_HI + 1))),
        atr_fill=atr_fill,
        # the median of what the signal path calls `volatility`
        atr_median=median(atr_fill / close),
        bb_mid=dyn.rolling_mean_dyn(close, bb, WMAX_BB),
        bb_sd=dyn.rolling_std_dyn(close, bb, WMAX_BB),
        vol_ma_fill=nanfill(dyn.rolling_mean_dyn(volume, _grid(_VOL_LO, _VOL_HI, dev),
                                                 WMAX_VOL)),
    )


def _row(table: torch.Tensor, period, lo: int, hi: int) -> torch.Tensor:
    """Gather each genome's row: [..., T] for periods [...].  The clip
    guards a just-out-of-range float; `torch.round` rounds half to even, as
    `jnp.round` does."""
    idx = torch.clamp(torch.round(period).to(torch.int64) - lo, 0, hi - lo)
    return table[idx]


def _columns(p: StrategyParams) -> StrategyParams:
    """Each leaf [...] as [..., 1], to broadcast against rows [..., T]."""
    return StrategyParams(*(v[..., None] for v in p))


def _filled_indicators(a: dict, p: StrategyParams, tables: IndicatorTables | None):
    """(rsi, macd_line, bb_pos, ema_s, ema_l, atr, vol_ma), all nanfill-ed,
    each [..., T] for params [...] — gathered from the period tables when
    given, else computed per genome (the parity oracle)."""
    close, high, low, volume = (a[k] for k in _OHLCV)
    pc = _columns(p)
    if tables is None:
        macd_raw, _, _ = dyn.macd_dyn(close, pc.macd_fast, pc.macd_slow, pc.macd_signal)
        _, _, _, _, bb_raw = dyn.bollinger_dyn(close, pc.bollinger_period,
                                               pc.bollinger_std, WMAX_BB)
        return (nanfill(dyn.rsi_dyn(close, pc.rsi_period)), nanfill(macd_raw),
                nanfill(bb_raw),
                nanfill(dyn.ema_dyn(close, pc.ema_short)),
                nanfill(dyn.ema_dyn(close, pc.ema_long)),
                nanfill(dyn.atr_dyn(high, low, close, pc.atr_period)),
                nanfill(dyn.rolling_mean_dyn(volume, pc.volume_ma_period, WMAX_VOL)))

    # MACD line = fast EMA row − slow EMA row on the raw table.  Its NaNs
    # are the leading run t < slow-1, so nanfill reduces to a back-fill
    # with the first valid value diff[slow-1].
    diff = (_row(tables.ema_raw, p.macd_fast, _EMA_LO, _EMA_HI)
            - _row(tables.ema_raw, p.macd_slow, _EMA_LO, _EMA_HI))
    T = close.shape[-1]
    first_valid = torch.clamp(torch.round(pc.macd_slow).to(torch.int64) - 1, 0, T - 1)
    t_idx = torch.arange(T, device=close.device)
    macd_line = torch.nan_to_num(torch.where(
        t_idx < first_valid, torch.gather(diff, -1, first_valid.expand(diff.shape[:-1] + (1,))),
        diff))
    # Bollinger %B from the (mid, sd) rows, then the genome's own nanfill
    # (sd == 0 windows put NaNs at data-dependent places).
    mid = _row(tables.bb_mid, p.bollinger_period, _BB_LO, _BB_HI)
    sd = _row(tables.bb_sd, p.bollinger_period, _BB_LO, _BB_HI)
    hi_band, lo_band = mid + pc.bollinger_std * sd, mid - pc.bollinger_std * sd
    rng = hi_band - lo_band
    bb_pos = nanfill((close - lo_band) / torch.where(rng == 0.0, math.nan, rng))
    return (_row(tables.rsi_fill, p.rsi_period, _RSI_LO, _RSI_HI),
            macd_line, bb_pos,
            _row(tables.ema_fill, p.ema_short, _EMA_LO, _EMA_HI),
            _row(tables.ema_fill, p.ema_long, _EMA_LO, _EMA_HI),
            _row(tables.atr_fill, p.atr_period, _ATR_LO, _ATR_HI),
            _row(tables.vol_ma_fill, p.volume_ma_period, _VOL_LO, _VOL_HI))


def _vote_signal(pc: StrategyParams, close, volume, rsi, macd_line, bb_pos,
                 ema_s, ema_l, atr, vol_ma, social: SocialInputs | None = None):
    """The vote rule as elementwise ops, shape-polymorphic: params ``pc``
    as columns [..., 1] against rows [..., T].  Returns (signal, strength,
    volatility)."""
    volatility = atr / close
    uptrend = ema_s > ema_l
    downtrend = ema_s < ema_l
    trend_strength = torch.abs((ema_s - ema_l) / ema_l * 100.0)

    # --- votes: the TradingSignal scoring shape with evolved thresholds ---
    votes = torch.where(rsi < pc.rsi_oversold, 3.0,
                        torch.where(rsi < pc.rsi_oversold + 10.0, 2.0, 0.0))
    votes = votes + torch.where(macd_line > 0.0, 2.0, 0.0)
    votes = votes + torch.where(bb_pos < 0.2, 3.0, torch.where(bb_pos < 0.4, 2.0, 0.0))
    votes = votes + torch.where(uptrend & (trend_strength > 1.0), 3.0,
                                torch.where(uptrend, 2.0, 0.0))
    votes = votes + torch.where(volume > vol_ma, 2.0, 0.0)
    total = 5.0

    if social is not None:
        s_vote = ((social.sentiment > pc.social_sentiment_threshold).to(torch.float32)
                  + (social.volume > pc.social_volume_threshold).to(torch.float32)
                  + (social.engagement > pc.social_engagement_threshold).to(torch.float32))
        votes = votes + torch.where(s_vote >= 2.0, 3.0, torch.where(s_vote >= 1.0, 1.0, 0.0))
        total += 1.0

    overbought = (rsi > pc.rsi_overbought) | (bb_pos > 0.8)
    ratio = div_const(votes, 3.0 * total)
    signal = torch.where(overbought, sig.SELL,
                         torch.where(ratio >= 0.6, sig.BUY,
                                     torch.where(ratio <= 0.15, sig.SELL, sig.NEUTRAL)))
    signal = signal.to(torch.int32)

    # --- strength: TradingSignal._calculate_strength's weighting ---
    is_buy = signal == sig.BUY
    rsi_str = torch.where(
        is_buy,
        div_const(pc.rsi_oversold + 10.0 - torch.minimum(rsi, pc.rsi_oversold + 10.0), 15.0),
        div_const(torch.maximum(rsi, pc.rsi_overbought) - pc.rsi_overbought, 15.0))
    macd_str = torch.clamp_max(torch.abs(macd_line), 1.0)
    bb_str = torch.where(is_buy, div_const(torch.clamp_min(0.4 - bb_pos, 0.0), 0.4),
                         div_const(torch.clamp_min(bb_pos - 0.6, 0.0), 0.4))
    trend_str = torch.clamp_max(div_const(trend_strength, 5.0), 1.0)
    aligned = (is_buy & uptrend) | ((signal == sig.SELL) & downtrend)
    strength = (rsi_str * 30.0 + macd_str * 20.0 + bb_str * 20.0
                + torch.where(aligned, trend_str * 15.0, 0.0)
                + torch.where(volume > vol_ma, 15.0, 0.0))
    strength = torch.where(signal == sig.NEUTRAL, 0.0, torch.clamp(strength, 0.0, 100.0))
    return signal, strength, volatility


def _to(x, dev):
    return None if x is None else type(x)(*(to_device(v, dev, torch.float32) for v in x))


def evolvable_signal(ohlcv: dict, p: StrategyParams,
                     social: SocialInputs | None = None,
                     tables: IndicatorTables | None = None, device=None):
    """Per-candle (signal ∈ {-1,0,1} int32, strength ∈ [0,100], volatility),
    each [..., T] for params [...] (a population's leading axes); pass
    ``tables`` to gather indicator rows instead of recomputing them."""
    dev = resolve_device(device)
    a, p = _arrays(ohlcv, dev), _to(p, dev)
    rsi, macd_line, bb_pos, ema_s, ema_l, atr, vol_ma = \
        _filled_indicators(a, p, _to(tables, dev))
    return _vote_signal(_columns(p), a["close"], a["volume"], rsi, macd_line, bb_pos,
                        ema_s, ema_l, atr, vol_ma, _to(social, dev))


def evolvable_inputs(ohlcv: dict, p: StrategyParams,
                     social: SocialInputs | None = None,
                     tables: IndicatorTables | None = None, device=None) -> BacktestInputs:
    """The replay's inputs for params [...]: close, volume and confidence
    shared [T]; signal (= decision), strength, volatility and the
    ATR-adaptive SL/TP as rows [..., T].  Both exits scale with the
    current ATR against the series median (tables: the per-period median),
    bounded to 0.5-2.0; atr_multiplier = 2 at median volatility is
    neutral."""
    dev = resolve_device(device)
    a, p = _arrays(ohlcv, dev), _to(p, dev)
    signal, strength, volatility = evolvable_signal(a, p, social, tables, device=dev)
    close = a["close"]
    avg_volume = torch.mean(a["volume"]) * torch.mean(close)
    T = close.shape[-1]
    pc = _columns(p)
    if tables is None:
        vol_ref = torch.clamp_min(median(volatility), 1e-8)[..., None]
    else:
        vol_ref = torch.clamp_min(
            _row(_to(tables, dev).atr_median, p.atr_period, _ATR_LO, _ATR_HI), 1e-8)[..., None]
    factor = torch.clamp(pc.atr_multiplier * volatility / (2.0 * vol_ref), 0.5, 2.0)
    return BacktestInputs(
        close=close, signal=signal, strength=strength, volatility=volatility,
        volume=avg_volume.reshape(1).expand(T).contiguous(),
        confidence=torch.ones((T,), dtype=torch.float32, device=dev),
        decision=signal, sl_pct=pc.stop_loss * factor, tp_pct=pc.take_profit * factor)


def evolvable_backtest(ohlcv: dict, p: StrategyParams,
                       initial_balance: float = 10_000.0,
                       min_signal_strength: float = 50.0, warmup: int = 10,
                       social: SocialInputs | None = None,
                       tables: IndicatorTables | None = None, device=None):
    """Indicators → signal → replay with the params' SL/TP, for params
    [...] (stats [...]): the GA's fitness backtest.  ``social`` adds the
    social vote axis; ``tables`` (build_indicator_tables) swaps the
    per-genome indicators for period-row gathers."""
    dev = resolve_device(device)
    inputs = evolvable_inputs(ohlcv, p, social, tables, device=dev)
    return run_backtest(inputs, _to(p, dev), initial_balance=initial_balance,
                        min_signal_strength=min_signal_strength,
                        use_param_sl_tp=True, warmup=warmup, device=dev)


def evolvable_fused_backtest(ohlcv: dict, p: StrategyParams, tables: IndicatorTables,
                             initial_balance: float = 10_000.0,
                             min_signal_strength: float = 50.0, warmup: int = 10,
                             device=None):
    """The GA's fitness backtest from the period tables (no social axis).

    The JAX package folds the vote rule into its replay scan, so nothing
    [pop, T]-sized lies between the gathers and the replay.  Here the
    gathered rows go through `_vote_signal` over [pop, T] and the per-genome
    rows into the replay kernel's rows form on the card (the engine's plain
    loop on the CPU): the same stats.  Folding the vote rule into K1's
    pre-pass, so that no [pop, T] stream is materialised, is later
    performance work."""
    return evolvable_backtest(ohlcv, p, initial_balance=initial_balance,
                              min_signal_strength=min_signal_strength, warmup=warmup,
                              tables=tables, device=device)


def population_backtest(ohlcv: dict, population: StrategyParams,
                        initial_balance: float = 10_000.0,
                        min_signal_strength: float = 50.0, warmup: int = 10,
                        social: SocialInputs | None = None,
                        tables: IndicatorTables | None = None, device=None):
    """The pipeline over a population StrategyParams [pop] (the leading
    dimension, where the JAX package vmaps): stats [pop]."""
    return evolvable_backtest(ohlcv, population, initial_balance=initial_balance,
                              min_signal_strength=min_signal_strength, warmup=warmup,
                              social=social, tables=tables, device=device)
