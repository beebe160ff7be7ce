"""Scenario path generators: whole candle batches as tensor programs.

Port of `ai_crypto_trader_tpu/sim/paths.py`.  Two generators, both closed
form over the candle axis (the regime chain a running max, the price a
cumulative sum), both taking a shock schedule so every scenario row carries
its own pathology:

  * `gbm_candles` — `data.generate_ohlcv`'s dynamics (the same 3-regime
    Markov chain and drift/vol multipliers) over a [B, T] batch, with the
    schedule's ``logret_shift`` / ``vol_mult`` folded into the log-returns;
  * `bootstrap_candles` — historical log-returns resampled per (scenario,
    candle), the schedule applied the same way.

Both return a dict of [B, T] float32 tensors (open/high/low/close/volume,
and int32 regime), shaped as a batched `generate_ohlcv`.

Random draws.  The ``_traced`` forms take their draws as a NamedTuple
(`GbmDraws`, `BootstrapDraws`) — the JAX forms draw them from a key inside
— so a test can hand over the JAX package's own.  The public forms take a
``torch.Generator`` (on the device) or a provider with a ``gbm(B, T)`` /
``bootstrap(B, T, n_returns)`` method.  Rounding: the JAX program sums the
log-returns as `lax.associative_scan`'s tree and takes XLA's ``exp``; here
they are ``torch.cumsum`` and PyTorch's ``exp``, so prices agree within a
few float32 ulps per candle of the sum, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.data.synthetic import REGIME_DRIFT_MULT, REGIME_VOL_MULT
from ai_crypto_trader_tpu_torch.device import resolve_device, upload


class PathParams(NamedTuple):
    """GBM dynamics knobs (float32 0-d tensors) — defaults mirror
    `generate_ohlcv`'s."""

    s0: torch.Tensor
    base_drift: torch.Tensor
    base_vol: torch.Tensor
    regime_switch_p: torch.Tensor
    base_volume: torch.Tensor


def path_params(s0: float = 40_000.0, base_drift: float = 0.00002,
                base_vol: float = 0.0015, regime_switch_p: float = 0.002,
                base_volume: float = 25.0, device=None) -> PathParams:
    dev = resolve_device(device)
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    return PathParams(s0=f(s0), base_drift=f(base_drift), base_vol=f(base_vol),
                      regime_switch_p=f(regime_switch_p), base_volume=f(base_volume))


class GbmDraws(NamedTuple):
    """`gbm_candles`' draws, [B, T] unless stated."""

    switch_u: torch.Tensor   # float32 uniforms: a regime switch where < p
    choices: torch.Tensor    # int64 regime chosen at a switch, in [0, 3)
    z: torch.Tensor          # float32 standard normals of the log-returns
    wick_z: torch.Tensor     # float32 [2, B, T] standard normals of the wicks
    vol_z: torch.Tensor      # float32 standard normals of the volume


class BootstrapDraws(NamedTuple):
    idx: torch.Tensor        # int64 [B, T] indices into the returns
    wick_z: torch.Tensor     # float32 [2, B, T]
    vol_z: torch.Tensor      # float32 [B, T]


def gbm_draws(generator: torch.Generator, B: int, T: int) -> GbmDraws:
    g, dev = generator, generator.device
    return GbmDraws(torch.rand((B, T), generator=g, device=dev),
                    torch.randint(0, 3, (B, T), generator=g, device=dev),
                    torch.randn((B, T), generator=g, device=dev),
                    torch.randn((2, B, T), generator=g, device=dev),
                    torch.randn((B, T), generator=g, device=dev))


def bootstrap_draws(generator: torch.Generator, B: int, T: int, n_returns: int) -> BootstrapDraws:
    g, dev = generator, generator.device
    return BootstrapDraws(torch.randint(0, n_returns, (B, T), generator=g, device=dev),
                          torch.randn((2, B, T), generator=g, device=dev),
                          torch.randn((B, T), generator=g, device=dev))


def regime_chain(switches: torch.Tensor, choices: torch.Tensor) -> torch.Tensor:
    """The regime at candle i is the choice at the last switch ≤ i (0
    before any switch): a running max over switch indices and a gather,
    over any leading axes.  int32."""
    T = switches.shape[-1]
    t_idx = torch.arange(T, device=switches.device).expand(switches.shape)
    idx = torch.cummax(torch.where(switches, t_idx, -1), dim=-1).values
    filled = torch.gather(choices.long(), -1, torch.clamp_min(idx, 0))
    return torch.where(idx >= 0, filled, 0).to(torch.int32)


def _assemble(wick_z, vol_z, open_, close, wick_scale, vol_scale, base_volume):
    """OHLC wicks and volume from the price anchors; ``low`` floored at 20 %
    of the body's lower edge."""
    wick = torch.abs(wick_z)
    body_hi = torch.maximum(open_, close)
    body_lo = torch.minimum(open_, close)
    high = body_hi + wick[0] * wick_scale
    low = torch.maximum(body_lo - wick[1] * wick_scale, body_lo * 0.2)
    volume = base_volume * torch.exp(0.35 * vol_z) * vol_scale
    return high, low, volume


def _candle_dict(open_, high, low, close, volume, regime):
    return {"open": open_, "high": high, "low": low, "close": close, "volume": volume,
            "regime": regime}


_REGIME_TABLES: dict = {}


def _regime_tables(device):
    """(drift, vol) multipliers per regime on ``device``, uploaded once per
    device (a copy inside every call would wait on the card)."""
    key = str(device)
    if key not in _REGIME_TABLES:
        _REGIME_TABLES[key] = tuple(upload(m.astype(np.float32), device)
                                    for m in (REGIME_DRIFT_MULT, REGIME_VOL_MULT))
    return _REGIME_TABLES[key]


def gbm_candles_traced(draws: GbmDraws, logret_shift, vol_mult, p: PathParams) -> dict:
    """The GBM generator on given draws ([B, T] schedule channels)."""
    dev = logret_shift.device
    B = logret_shift.shape[0]
    regime = regime_chain(draws.switch_u < p.regime_switch_p, draws.choices)
    drift_table, vol_table = _regime_tables(dev)
    drift_mult = drift_table[regime.long()]
    vm = vol_table[regime.long()]
    vol = p.base_vol * vm * vol_mult
    rets = p.base_drift * drift_mult + vol * draws.z + logret_shift
    close = p.s0 * torch.exp(torch.cumsum(rets, dim=-1))
    open_ = torch.cat([p.s0.expand(B, 1), close[:, :-1]], dim=-1)
    high, low, volume = _assemble(draws.wick_z, draws.vol_z, open_, close,
                                  wick_scale=vol * close, vol_scale=vm,
                                  base_volume=p.base_volume)
    return _candle_dict(open_, high, low, close, volume, regime)


def _schedule(schedule, dev):
    return (upload(schedule.logret_shift, dev, torch.float32),
            upload(schedule.vol_mult, dev, torch.float32))


def gbm_candles(key, schedule, params: PathParams | None = None, device=None) -> dict:
    """[B, T] regime-switching GBM candles under a ShockSchedule (or any
    object with ``logret_shift`` / ``vol_mult`` arrays), on ``device``."""
    dev = resolve_device(device)
    p = params or path_params(device=dev)
    shift, vm = _schedule(schedule, dev)
    B, T = shift.shape
    d = key.gbm(B, T) if hasattr(key, "gbm") else gbm_draws(key, B, T)
    return gbm_candles_traced(GbmDraws(*(x.to(dev) for x in d)), shift, vm, p)


def bootstrap_candles_traced(draws: BootstrapDraws, returns, logret_shift, vol_mult,
                             p: PathParams) -> dict:
    """The bootstrap generator on given draws."""
    B, T = logret_shift.shape
    log_inc = returns[draws.idx] * vol_mult + logret_shift
    close = p.s0 * torch.exp(torch.cumsum(log_inc, dim=-1))
    open_ = torch.cat([p.s0.expand(B, 1), close[:, :-1]], dim=-1)
    high, low, volume = _assemble(draws.wick_z, draws.vol_z, open_, close,
                                  wick_scale=torch.abs(log_inc) * close,
                                  vol_scale=torch.clamp_min(vol_mult, 1.0),
                                  base_volume=p.base_volume)
    regime = torch.zeros((B, T), dtype=torch.int32, device=close.device)
    return _candle_dict(open_, high, low, close, volume, regime)


def bootstrap_candles(key, returns, schedule, params: PathParams | None = None,
                      device=None) -> dict:
    """[B, T] bootstrapped-historical candles under a ShockSchedule."""
    dev = resolve_device(device)
    p = params or path_params(device=dev)
    rets = upload(returns, dev, torch.float32)
    shift, vm = _schedule(schedule, dev)
    B, T = shift.shape
    n = rets.shape[-1]
    d = key.bootstrap(B, T, n) if hasattr(key, "bootstrap") else bootstrap_draws(key, B, T, n)
    return bootstrap_candles_traced(BootstrapDraws(*(x.to(dev) for x in d)), rets, shift, vm, p)
