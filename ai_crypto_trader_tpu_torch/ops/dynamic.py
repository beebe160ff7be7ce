"""Indicators whose periods are tensors.

Port of `ai_crypto_trader_tpu/ops/dynamic.py:33-128`.  There a period is a
traced scalar and `jax.vmap` runs a whole population (or a whole period
grid) in one program.  Here a period is a tensor that broadcasts against
the series [..., T]: a scalar gives one row, a column [n, 1] over a [T]
series gives n rows [n, T] — one call computes a whole period grid, or
every genome's row.

  * Hard-window reductions (sum/mean/max/min/std) add ``wmax`` lagged
    copies of the series, masked to each row's window, in the order
    i = 0 .. wmax-1 of the JAX loop (`jnp.roll` wraps, so does `_roll`).
  * The EMA family (EMA, Wilder RSI, Wilder ATR) goes through
    `ops.ewma.fused_ewma_jobs` — the CUDA kernel K2 on the card, its plain
    version on the CPU.  A column of periods over one series is one family
    of alphas, packed into jobs of at most ``ewma.MAX_K`` alphas and
    launches of at most ``ewma.MAX_JOBS`` jobs; one period runs over any
    batch of series.  K2 takes the alphas as launch arguments: a ``range``
    of integer periods (the period tables' grids) makes them on the host,
    a tensor period on the card is read back.
  * A period divides as a tensor (a true division, as XLA keeps a division
    by a traced value); a constant over a tensor goes through
    `device.const_over`.

Warmup positions (t < window - 1, or t < window for RSI/ATR) are NaN.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import const_over
from ai_crypto_trader_tpu_torch.ops.ewma import MAX_JOBS, MAX_K, fused_ewma_jobs
from ai_crypto_trader_tpu_torch.ops.indicators import (
    _roll,
    first_order_recursion,
    true_range,
)


def _iota(x):
    return torch.arange(x.shape[-1], device=x.device)


def _mask_warmup_dyn(y, window):
    return torch.where(_iota(y) < window - 1, math.nan, y)


def _rolling_reduce_dyn(x, window, wmax: int, op, neutral):
    """Reduce over the trailing ``window`` (a tensor, ≤ wmax) positions."""
    t = _iota(x)
    acc = torch.full_like(x, neutral)
    for i in range(wmax):
        valid = (i < window) & (t >= i)
        acc = op(acc, torch.where(valid, _roll(x, i), neutral))
    return _mask_warmup_dyn(acc, window)


def rolling_sum_dyn(x, window, wmax: int):
    return _rolling_reduce_dyn(torch.nan_to_num(x), window, wmax, torch.add, 0.0)


def rolling_mean_dyn(x, window, wmax: int):
    return rolling_sum_dyn(x, window, wmax) / window


def rolling_max_dyn(x, window, wmax: int):
    return _rolling_reduce_dyn(x, window, wmax, torch.maximum, -math.inf)


def rolling_min_dyn(x, window, wmax: int):
    return _rolling_reduce_dyn(x, window, wmax, torch.minimum, math.inf)


def rolling_std_dyn(x, window, wmax: int):
    """Rolling population std, centred on the row's mean.  The mean is
    summed in float64, and m2 - m·m is formed in float64 and rounded once,
    as the compiled JAX program's fused multiply-add rounds it (the port's
    static `rolling_std` does the same)."""
    c = torch.nanmean(x.double(), dim=-1, keepdim=True).float()
    xc = x - c
    m = rolling_mean_dyn(xc, window, wmax)
    m2 = rolling_mean_dyn(xc * xc, window, wmax)
    var = (m2.double() - m.double() * m.double()).float()
    return torch.sqrt(torch.clamp_min(var, 0.0))


# ---------------------------------------------------------------------------
# The EMA family through the fused-EWMA kernel
# ---------------------------------------------------------------------------

def family_launches(x, alphas, start: int):
    """The launches that compute `_ewm(x, a, start)` for every alpha of
    ``alphas`` over one series batch x [..., T]: jobs (x, ≤ MAX_K alphas,
    start), grouped ≤ MAX_JOBS a launch."""
    jobs = [(x, alphas[i:i + MAX_K], start) for i in range(0, len(alphas), MAX_K)]
    return [jobs[i:i + MAX_JOBS] for i in range(0, len(jobs), MAX_JOBS)]


def ewma_family(x, alphas, start: int):
    """[n, ..., T]: the pandas ``ewm(alpha, adjust=False)`` of x [..., T]
    seeded at ``start``, for each of the n float32 ``alphas`` (a list of
    Python floats), in ceil(n / (MAX_K·MAX_JOBS)) kernel launches on CUDA."""
    out = []
    for jobs in family_launches(x, alphas, start):
        out += fused_ewma_jobs(jobs, device=x.device)
    return torch.cat(out, dim=0)


def _periods(x, window):
    """``window`` as a tensor for the masks, and its float32 periods on the
    host when it is a ``range`` of integer periods — a period grid, a
    column [n, 1] on x's device — else None."""
    if isinstance(window, range):
        col = torch.arange(window.start, window.stop, dtype=torch.float32,
                           device=x.device)[:, None]
        return col, np.arange(window.start, window.stop, dtype=np.float32)
    return window, None


def _alphas(x, c: float, window, offset: float, host):
    """The float32 alphas c / (window + offset) of one EMA family over x, as
    Python floats (K2 takes them as launch arguments): one alpha over any
    batch of series x [..., T], or a column [n, 1] of them over one series
    x [T].  From host periods NumPy's float32 division makes them with no
    device sync; a tensor period on the card is read back."""
    alpha = (np.float32(c) / (host + np.float32(offset)) if host is not None
             else const_over(c, window + offset))
    alphas = alpha.reshape(-1).tolist()
    if len(alphas) > 1 and x.ndim > 1:
        raise ValueError("a column of periods runs over one series [T], "
                         f"got a batch of series {tuple(x.shape)}")
    return alphas


def _ewm_dyn(x, window, c: float, offset: float, start: int):
    """`_ewm` with alpha = c / (window + offset): ([..., T], the broadcast
    of x and the window; the window as a tensor)."""
    window, host = _periods(x, window)
    out = ewma_family(x, _alphas(x, c, window, offset, host), start)
    return out.reshape(torch.broadcast_shapes(x.shape, window.shape)), window


def ema_dyn(x, window):
    """EMA with a tensor span (pandas ewm(span=w, adjust=False)), or a
    ``range`` of integer spans: the grid's rows [n, T]."""
    y, window = _ewm_dyn(x, window, 2.0, 1.0, 0)
    return _mask_warmup_dyn(y, window)


def macd_dyn(close, fast, slow, signal):
    """MACD with tensor periods.  The signal line seeds where the slow EMA
    becomes valid, mirroring pandas NaN-skipping (ops.indicators.macd)."""
    line = ema_dyn(close, fast) - ema_dyn(close, slow)
    line_filled = torch.where(torch.isnan(line), 0.0, line)
    t = _iota(close)
    start = (slow - 1).to(torch.float32)
    alpha = const_over(2.0, signal + 1.0)
    a = torch.where(t <= start, 0.0, 1.0 - alpha)
    b = torch.where(t == start, line_filled,
                    torch.where(t < start, 0.0, alpha * line_filled))
    sig = first_order_recursion(*torch.broadcast_tensors(a, b))
    sig = torch.where(t < start + signal - 1, math.nan, sig)
    line = _mask_warmup_dyn(line, slow)
    return line, sig, line - sig


def rsi_dyn(close, window):
    """Wilder RSI with a tensor period (ops.indicators.rsi with α = 1/w),
    or a ``range`` of them; the gains and losses are one family of two
    series."""
    window, host = _periods(close, window)
    diff = close - _roll(close, 1)
    up = torch.clamp_min(diff, 0.0)
    dn = torch.clamp_min(-diff, 0.0)
    g = ewma_family(torch.stack([up, dn]), _alphas(close, 1.0, window, 0.0, host), 1)
    shape = torch.broadcast_shapes(close.shape, window.shape)
    ag, al = g[:, 0].reshape(shape), g[:, 1].reshape(shape)
    r = torch.where(al == 0.0, torch.where(ag == 0.0, 50.0, 100.0),
                    100.0 - const_over(100.0, 1.0 + ag / torch.where(al == 0.0, 1.0, al)))
    return torch.where(_iota(close) < window, math.nan, r)


def atr_dyn(high, low, close, window):
    """Wilder ATR with a tensor period, or a ``range`` of them."""
    tr = true_range(high, low, close)
    y, window = _ewm_dyn(tr, window, 1.0, 0.0, 1)
    return torch.where(_iota(close) < window, math.nan, y)


def bollinger_dyn(close, window, num_std, wmax: int):
    mid = rolling_mean_dyn(close, window, wmax)
    sd = rolling_std_dyn(close, window, wmax)
    hi, lo = mid + num_std * sd, mid - num_std * sd
    rng = hi - lo
    pos = (close - lo) / torch.where(rng == 0.0, math.nan, rng)
    width = rng / mid
    return hi, mid, lo, width, pos
