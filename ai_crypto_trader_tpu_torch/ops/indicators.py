"""Technical indicators over the trailing time axis, in PyTorch.

Port of `ai_crypto_trader_tpu/ops/indicators.py`: every function that
module's package exports, `INDICATOR_NAMES` and `compute_indicators`, with
the same NaN semantics (pandas ``min_periods=window``: positions before the
first full window are NaN until `nanfill`).  Functions take float32 tensors
[..., T] and run on the tensor's device.

  * Windowed reductions are exact window reductions after left-padding
    window-1 init values, never a difference of running sums: a year of
    bench candles climbs to 2.8e11 and its running sum to 1.2e16, where the
    difference of two float32 sums keeps no digit.  Sums add the window's
    elements one by one from the oldest, as `lax.reduce_window` does;
    max/min reduce an ``unfold`` view.
  * The EMA family (EMA, MACD, Wilder RSI, Wilder ATR) goes through
    `ops.ewma.fused_ewma` — the CUDA kernel on the card.
    `compute_indicators` batches it into two launches per call.
  * ``ffill``/``bfill``/``nanfill`` are a cummax over last-valid indices and
    one gather.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ai_crypto_trader_tpu_torch.device import const_over, div_const, resolve_device, to_device
from ai_crypto_trader_tpu_torch.ops.ewma import associative_scan, fused_ewma, fused_ewma_jobs


def _iota(x):
    return torch.arange(x.shape[-1], device=x.device)


def _mask_warmup(y, window):
    """NaN-out the first window-1 positions (pandas min_periods semantics)."""
    return torch.where(_iota(y) < window - 1, math.nan, y)


def _roll(x, shift):
    """`jnp.roll` along the last axis (wraps, as the JAX code relies on)."""
    return torch.roll(x, shift, dims=-1)


# ---------------------------------------------------------------------------
# Windowed reductions
# ---------------------------------------------------------------------------

def _pad_left(x, window, value):
    return F.pad(x, (window - 1, 0), value=value)


def rolling_sum(x, window: int):
    T = x.shape[-1]
    xp = _pad_left(x, window, 0.0)
    acc = torch.zeros_like(x)
    for j in range(window):
        acc = acc + xp[..., j:j + T]
    return _mask_warmup(acc, window)


def rolling_mean(x, window: int):
    return div_const(rolling_sum(x, window), float(window))


def rolling_max(x, window: int):
    xp = _pad_left(x, window, -math.inf)
    return _mask_warmup(xp.unfold(-1, window, 1).amax(-1), window)


def rolling_min(x, window: int):
    xp = _pad_left(x, window, math.inf)
    return _mask_warmup(xp.unfold(-1, window, 1).amin(-1), window)


def rolling_std(x, window: int, ddof: int = 0):
    """Rolling population std (ddof=0, matching `ta` BollingerBands),
    centred on the series mean before squaring (variance is
    shift-invariant; long float32 price series need it).  The mean is
    summed in float64; m2 - m·m is formed in float64 and rounded once, as
    the JAX program's fused multiply-add rounds it."""
    c = torch.nanmean(x.double(), dim=-1, keepdim=True).float()
    xc = x - c
    m = rolling_mean(xc, window)
    m2 = rolling_mean(xc * xc, window)
    var = (m2.double() - m.double() * m.double()).float()
    var = torch.maximum(var, torch.zeros_like(m)) * (window / (window - ddof))
    return torch.sqrt(var)


sma = rolling_mean


# ---------------------------------------------------------------------------
# The EMA family
# ---------------------------------------------------------------------------

def first_order_recursion(a, b):
    """Solve y[t] = a[t]·y[t-1] + b[t] (y[-1]=0) by composing the affine
    maps (a, b) in `lax.associative_scan`'s order."""
    return associative_scan(a, b)[1]


def _ewm(x, alpha: float, start: int):
    """pandas `ewm(alpha, adjust=False).mean()` beginning at index `start`
    (seeded with x[start]; earlier positions NaN), through fused_ewma."""
    return fused_ewma(x, [alpha], start, device=x.device)[0]


def ema(x, window: int, start: int | None = None, min_periods: int | None = None):
    """`ta` EMAIndicator: ewm(span=window, adjust=False, min_periods=window)."""
    alpha = 2.0 / (window + 1.0)
    start = 0 if start is None else start
    y = _ewm(x, alpha, start)
    mp = window if min_periods is None else min_periods
    return _mask_warmup(y, mp + start)


def macd(close, fast: int = 12, slow: int = 26, signal: int = 9):
    """MACD line / signal / histogram, `ta` defaults."""
    line = ema(close, fast, min_periods=1) - ema(close, slow, min_periods=1)
    line = _mask_warmup(line, slow)
    # pandas ewm on the signal skips the slow-1 leading NaNs of the line.
    sig = ema(line, signal, start=slow - 1, min_periods=signal)
    return line, sig, line - sig


def _rsi_moves(close):
    """Gains and losses of diff(close).  diff[0] wraps to the last candle,
    as `jnp.roll` does; the seed index 1 hides it."""
    diff = close - _roll(close, 1)
    zero = torch.zeros_like(diff)
    return torch.maximum(diff, zero), torch.maximum(-diff, zero)


def _rsi_from(ag, al, window):
    r = torch.where(al == 0.0, torch.where(ag == 0.0, 50.0, 100.0),
                    100.0 - const_over(100.0, 1.0 + ag / torch.where(al == 0.0, 1.0, al)))
    return _mask_warmup(r, window + 1)


def rsi(close, window: int = 14):
    """Wilder RSI, `ta` RSIIndicator semantics: Wilder smoothing =
    ewm(alpha=1/window) seeded at t=1; RSI = 100 - 100/(1 + g/l)."""
    up, dn = _rsi_moves(close)
    g = fused_ewma(torch.stack([up, dn]), [1.0 / window], 1, device=close.device)[0]
    return _rsi_from(g[0], g[1], window)


def true_range(high, low, close):
    t = _iota(close)
    prev_close = torch.where(t == 0, math.nan, _roll(close, 1))
    tr = torch.maximum(high - low,
                       torch.maximum(torch.abs(high - prev_close),
                                     torch.abs(low - prev_close)))
    return torch.where(t == 0, math.nan, tr)


def atr(high, low, close, window: int = 14):
    """Wilder ATR = ewm(alpha=1/window) of true range, seeded at t=1."""
    y = _ewm(true_range(high, low, close), 1.0 / window, 1)
    return _mask_warmup(y, window + 1)


# ---------------------------------------------------------------------------
# Oscillators / bands / volume
# ---------------------------------------------------------------------------

def _nan_where_zero(x):
    return torch.where(x == 0.0, math.nan, x)


def stochastic(high, low, close, window: int = 14, smooth: int = 3):
    """Stochastic %K / %D (`ta` defaults)."""
    hh = rolling_max(high, window)
    ll = rolling_min(low, window)
    k = 100.0 * (close - ll) / _nan_where_zero(hh - ll)
    d = rolling_mean(k, smooth)
    return k, _mask_warmup(d, window + smooth - 1)


def williams_r(high, low, close, window: int = 14):
    hh = rolling_max(high, window)
    ll = rolling_min(low, window)
    return -100.0 * (hh - close) / _nan_where_zero(hh - ll)


class Bollinger(NamedTuple):
    high: torch.Tensor
    mid: torch.Tensor
    low: torch.Tensor
    width: torch.Tensor
    position: torch.Tensor


def bollinger(close, window: int = 20, num_std: float = 2.0) -> Bollinger:
    """Bollinger bands + width + %B (zero-range %B → NaN)."""
    mid = rolling_mean(close, window)
    sd = rolling_std(close, window)
    hi = mid + num_std * sd
    lo = mid - num_std * sd
    width = (hi - lo) / mid
    pos = (close - lo) / _nan_where_zero(hi - lo)
    return Bollinger(hi, mid, lo, width, pos)


def vwap(high, low, close, volume, window: int = 14):
    """Rolling VWAP over the typical price."""
    tp = div_const(high + low + close, 3.0)
    num = rolling_sum(tp * volume, window)
    den = rolling_sum(volume, window)
    return num / _nan_where_zero(den)


def ichimoku(high, low, conv: int = 9, base: int = 26, span_b: int = 52):
    """Ichimoku senkou A/B, unshifted."""
    conv_line = div_const(rolling_max(high, conv) + rolling_min(low, conv), 2.0)
    base_line = div_const(rolling_max(high, base) + rolling_min(low, base), 2.0)
    a = div_const(conv_line + base_line, 2.0)
    b = div_const(rolling_max(high, span_b) + rolling_min(low, span_b), 2.0)
    return a, b


def obv(close, volume):
    """On-balance volume."""
    t = _iota(close)
    sign = torch.where(t == 0, 0.0, torch.sign(close - _roll(close, 1)))
    return torch.cumsum(sign * volume, dim=-1)


def roc(close, window: int = 12):
    """Rate of change, percent."""
    prev = _roll(close, window)
    return torch.where(_iota(close) < window, math.nan,
                       100.0 * (close - prev) / prev)


# ---------------------------------------------------------------------------
# NaN fill (TechnicalAnalyzer._handle_nan_values parity)
# ---------------------------------------------------------------------------

def ffill(x):
    """Forward-fill NaNs: cummax over last-valid indices + one gather.
    Positions before the first valid value stay NaN."""
    t = _iota(x).expand_as(x)
    idx = torch.cummax(torch.where(torch.isnan(x), -1, t), dim=-1).values
    y = torch.gather(torch.nan_to_num(x), -1, idx.clamp_min(0))
    return torch.where(idx < 0, math.nan, y)


def bfill(x):
    return torch.flip(ffill(torch.flip(x, dims=(-1,))), dims=(-1,))


def nanfill(x):
    """ffill → bfill → 0 (TechnicalAnalyzer._handle_nan_values)."""
    return torch.nan_to_num(bfill(ffill(x)))


# ---------------------------------------------------------------------------
# The full per-candle indicator table
# ---------------------------------------------------------------------------

INDICATOR_NAMES = (
    "sma_20", "sma_50", "sma_200", "ema_12", "ema_26",
    "macd", "macd_signal", "macd_diff",
    "ichimoku_a", "ichimoku_b",
    "rsi", "stoch_k", "stoch_d", "williams_r",
    "bb_high", "bb_mid", "bb_low", "bb_width", "bb_position",
    "atr", "vwap",
)


def compute_indicators(ohlcv: dict, fill: bool = True, device=None) -> dict:
    """Every indicator column of the reference's TechnicalAnalyzer, for
    every candle, as `ai_crypto_trader_tpu.ops.compute_indicators` computes
    them.  Input: dict of open/high/low/close/volume arrays [..., T] (NumPy
    or tensors).  Output: dict of the 21 indicator tensors plus the
    passthrough inputs, on ``device`` (default: the CUDA card).

    The EMA family is two kernel launches.  The first runs two jobs: close
    with the EMA-12 and EMA-26 alphas (which also give MACD's two lines —
    the same `_ewm` under other masks), and RSI's gains and losses and the
    true range stacked as three series with Wilder's alpha, seeded at 1.
    The second, which needs the first's MACD line, runs that line with the
    signal alpha, seeded at slow-1 = 25."""
    dev = resolve_device(device)
    out = {k: to_device(v, dev) for k, v in ohlcv.items()}
    out = {k: v.float() if v.is_floating_point() else v for k, v in out.items()}
    high, low, close, volume = (out[k] for k in ("high", "low", "close", "volume"))

    out["sma_20"] = sma(close, 20)
    out["sma_50"] = sma(close, 50)
    out["sma_200"] = sma(close, 200)

    up, dn = _rsi_moves(close)
    ema_close, wilder = fused_ewma_jobs(
        [(close, [2.0 / 13.0, 2.0 / 27.0], 0),
         (torch.stack([up, dn, true_range(high, low, close)]), [1.0 / 14.0], 1)],
        device=dev)
    e12, e26 = ema_close
    ag, al, tr = wilder[0]
    out["ema_12"] = _mask_warmup(e12, 12)
    out["ema_26"] = _mask_warmup(e26, 26)
    line = _mask_warmup(_mask_warmup(e12, 1) - _mask_warmup(e26, 1), 26)
    sig = _mask_warmup(fused_ewma(line, [2.0 / 10.0], 25, device=dev)[0], 9 + 25)
    out["macd"], out["macd_signal"], out["macd_diff"] = line, sig, line - sig

    a, b = ichimoku(high, low)
    out["ichimoku_a"], out["ichimoku_b"] = a, b

    out["rsi"] = _rsi_from(ag, al, 14)

    k, d = stochastic(high, low, close)
    out["stoch_k"], out["stoch_d"] = k, d
    out["williams_r"] = williams_r(high, low, close)
    bb = bollinger(close)
    out["bb_high"], out["bb_mid"], out["bb_low"] = bb.high, bb.mid, bb.low
    out["bb_width"], out["bb_position"] = bb.width, bb.position
    out["atr"] = _mask_warmup(tr, 14 + 1)
    out["vwap"] = vwap(high, low, close, volume)

    if fill:
        out = {k: (nanfill(v) if v.is_floating_point() else v)
               for k, v in out.items()}
    return out
