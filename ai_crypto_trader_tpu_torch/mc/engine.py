"""Monte-Carlo risk engine: GBM and bootstrap path simulation.

Port of `ai_crypto_trader_tpu/mc/engine.py`.  A GBM path is
``exp(cumsum(log-increments))``, so the whole [paths × days] tensor is a
few elementwise ops, one cumsum and one exp; the bootstrap is one gather.
The statistics (percentiles, VaR / CVaR on percent changes, probability
of profit, per-path max drawdown through a running maximum, `torch.cummax`)
run on the same device.  Scenarios scale drift and volatility
(`config.MonteCarloParams`); the stress mode overlays a `sim.scenarios`
shock schedule on every path.  `portfolio_stats` is the reference's
correlation-ignoring weighted sum; `simulate_portfolio_correlated` draws
correlated shocks through a Cholesky factor.

Random draws come from the ``generator`` the caller passes (a
`torch.Generator` on the device).  Every simulator also takes its draws
injected (``z``, or the bootstrap's ``idx``), so the JAX package's own
`jax.random` draws can be fed to both packages.

Quantiles follow `jnp.quantile`'s arithmetic (`quantile` below): linear
interpolation with float32 weights, ``median`` the midpoint of the two
middle values (`torch.median` returns the lower one).  The JAX functions
take their knobs (confidence, dt) as float32 values; the port does that
scalar arithmetic in NumPy float32 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.config import MonteCarloParams
from ai_crypto_trader_tpu_torch.device import div_true, resolve_device, to_device

PERCENTILES = np.asarray([1.0, 5.0, 10.0, 25.0, 50.0, 75.0, 90.0, 95.0, 99.0])
PERIODS_PER_YEAR = 252.0

_F = np.float32


def quantile(x, q, dim: int = -1, method: str = "linear"):
    """``jnp.quantile(x, q, axis=dim)`` for host scalars ``q`` (a float or
    a sequence; float32 as JAX takes them): sort, then the two neighbours
    of ``q·(n − 1)`` weighted in float32 (``"linear"``) or their midpoint
    (``"midpoint"``).  A row with a NaN gives NaN.  The ranks are host
    integers, so nothing is read back from the device."""
    a = torch.sort(x, dim=dim).values
    n = a.shape[dim]
    qs = np.atleast_1d(np.asarray(q, _F))
    outs = []
    for qv in qs:
        pos = _F(qv) * _F(n - 1)
        low, high = _F(np.floor(pos)), _F(np.ceil(pos))
        hw = _F(pos - low)
        lw = _F(_F(1.0) - hw)
        lo = int(np.clip(low, 0, n - 1))
        hi = int(np.clip(high, 0, n - 1))
        lv, hv = a.select(dim, lo), a.select(dim, hi)
        if method == "linear":
            outs.append(lv * float(lw) + hv * float(hw))
        elif method == "midpoint":
            outs.append((lv + hv) * 0.5)
        else:
            raise ValueError(f"unsupported quantile method {method!r}")
    out = torch.stack(outs) if np.ndim(q) else outs[0]
    has_nan = torch.isnan(x).any(dim)
    return torch.where(has_nan, torch.nan, out)


def median(x, dim: int = -1):
    """``jnp.median``: the midpoint of the two middle values."""
    return quantile(x, 0.5, dim=dim, method="midpoint")


def _percentile_q(p):
    """``jnp.percentile``'s q/100, in float32."""
    return np.asarray(p, _F) / _F(100.0)


def estimate_mu_sigma(returns, periods_per_year: float = PERIODS_PER_YEAR,
                      device=None):
    """Annualized drift and volatility of a per-period return series
    (``std`` with ddof = 1, as pandas)."""
    dev = resolve_device(device)
    r = to_device(returns, dev, torch.float32)
    n = r.shape[-1]
    mu = torch.mean(r, dim=-1) * periods_per_year
    sd = torch.std(r, dim=-1, correction=1) if n > 1 else torch.zeros_like(mu)
    return mu, sd * float(np.sqrt(_F(periods_per_year)))


def simulate_gbm(generator, initial_price, mu, sigma, days: int, num_sims: int,
                 dt: float = 1.0 / PERIODS_PER_YEAR,
                 shock_shift=None, shock_vol=None, *, z=None, device=None):
    """GBM paths [num_sims, days], ``paths[:, 0] == initial_price``:
    S_t = S_0 · exp(Σ ((μ − σ²/2)·dt + σ·√dt·Z)).  ``z`` [num_sims,
    days − 1] replaces the draw from ``generator``.  ``shock_shift`` /
    ``shock_vol`` ([num_sims, days − 1], `sim.scenarios.mc_schedule`) are
    the stress channels: an additive log-return and a vol multiplier."""
    dev = resolve_device(device)
    mu = to_device(mu, dev, torch.float32)
    sigma = to_device(sigma, dev, torch.float32)
    z = (torch.randn((num_sims, days - 1), generator=generator, device=dev) if z is None
         else to_device(z, dev, torch.float32))
    if shock_vol is not None:
        z = z * to_device(shock_vol, dev, torch.float32)
    inc = (mu - 0.5 * sigma**2) * float(_F(dt)) + sigma * float(np.sqrt(_F(dt))) * z
    if shock_shift is not None:
        inc = inc + to_device(shock_shift, dev, torch.float32)
    log_path = torch.cat([torch.zeros((num_sims, 1), device=dev),
                          torch.cumsum(inc, dim=-1)], dim=-1)
    return initial_price * torch.exp(log_path)


def simulate_bootstrap(generator, initial_price, returns, days: int, num_sims: int,
                       log_returns: bool = True, shock_shift=None, shock_vol=None,
                       *, idx=None, device=None):
    """Historical bootstrap: past returns resampled with replacement, one
    gather and a cumsum.  ``idx`` [num_sims, days − 1] replaces the draw
    from ``generator``; stress channels as in `simulate_gbm`."""
    dev = resolve_device(device)
    returns = to_device(returns, dev, torch.float32)
    idx = (torch.randint(0, returns.shape[-1], (num_sims, days - 1),
                         generator=generator, device=dev) if idx is None
           else to_device(idx, dev, torch.int64))
    sampled = returns[idx]
    log_inc = sampled if log_returns else torch.log1p(sampled)
    if shock_vol is not None:
        log_inc = log_inc * to_device(shock_vol, dev, torch.float32)
    if shock_shift is not None:
        log_inc = log_inc + to_device(shock_shift, dev, torch.float32)
    log_path = torch.cat([torch.zeros((num_sims, 1), device=dev),
                          torch.cumsum(log_inc, dim=-1)], dim=-1)
    return initial_price * torch.exp(log_path)


def path_statistics(paths, initial_price, confidence: float = 0.95, device=None):
    """The reference's result statistics: percentiles of the final price,
    VaR / CVaR on percent changes (signed; the reference reports |·|),
    probability of profit, and the per-path max drawdown's mean, median
    and max."""
    dev = resolve_device(device)
    paths = to_device(paths, dev, torch.float32)
    final = paths[:, -1]
    pct = (div_true(final, initial_price) - 1.0) * 100.0

    pctl_prices = quantile(final, _percentile_q(PERCENTILES))
    var_pctl = _F(100.0) * (_F(1.0) - _F(confidence))
    var = quantile(pct, _percentile_q(var_pctl))
    tail = pct <= var
    cvar = torch.sum(torch.where(tail, pct, 0.0)) / torch.clamp_min(torch.sum(tail), 1)
    prob_profit = torch.mean((final > initial_price).to(torch.float32))

    running_max = torch.cummax(paths, dim=-1).values
    drawdown = (running_max - paths) / running_max
    max_dd = torch.amax(drawdown, dim=-1)

    return {
        "final_prices": final,
        "pct_changes": pct,
        "percentile_prices": pctl_prices,
        "expected_price": torch.mean(final),
        "expected_pct_change": torch.mean(pct),
        "var": var,
        "cvar": cvar,
        "prob_profit": prob_profit,
        "prob_loss": 1.0 - prob_profit,
        "max_drawdown_mean": torch.mean(max_dd),
        "max_drawdown_median": median(max_dd),
        "max_drawdown_max": torch.amax(max_dd),
    }


def run_simulation(generator, initial_price, returns, *, days: int = 30,
                   num_sims: int = 1_000, scenario: str = "base",
                   scenarios: dict | None = None, method: str = "gbm",
                   confidence: float = 0.95, stress=None,
                   stress_seed: int = 0, z=None, idx=None, device=None) -> dict:
    """One asset's simulation: estimate μ, σ → the scenario's multipliers
    → paths → statistics.

    ``scenarios`` maps name → (drift factor, volatility factor), the
    reference's five by default.  ``stress`` (a `sim.scenarios` preset
    name such as "flash_crash", or a ScenarioSpec) overlays a randomized
    shock schedule on every path; None runs the unstressed paths.  ``z``
    (GBM) or ``idx`` (bootstrap) inject the draws."""
    dev = resolve_device(device)
    scenarios = scenarios or dict(MonteCarloParams().scenarios)
    drift_f, vol_f = scenarios[scenario]
    returns = to_device(returns, dev, torch.float32)
    mu, sigma = estimate_mu_sigma(returns, device=dev)
    mu, sigma = mu * drift_f, sigma * vol_f
    shift = vol_mult = None
    if stress is not None:
        from ai_crypto_trader_tpu_torch.sim.scenarios import mc_schedule

        shift, vol_mult = mc_schedule(stress, num_sims, days - 1, seed=stress_seed)
    if method == "gbm":
        paths = simulate_gbm(generator, initial_price, mu, sigma, days, num_sims,
                             shock_shift=shift, shock_vol=vol_mult, z=z, device=dev)
    elif method in ("bootstrap", "historical"):
        paths = simulate_bootstrap(generator, initial_price, returns, days, num_sims,
                                   shock_shift=shift, shock_vol=vol_mult, idx=idx,
                                   device=dev)
    else:
        raise ValueError(f"unknown simulation method {method!r}")
    stats = path_statistics(paths, initial_price, confidence, device=dev)
    stats.update({"mu": mu, "sigma": sigma, "scenario": scenario,
                  "drift_factor": drift_f, "volatility_factor": vol_f,
                  "stress": (stress if isinstance(stress, (str, type(None)))
                             else getattr(stress, "name", str(stress))),
                  "paths": paths})
    return stats


def portfolio_stats(weights, expected_returns, vars_, cvars, device=None):
    """The reference's portfolio aggregation: correlation-ignoring weighted
    sums.  All inputs [n_assets] decimals."""
    dev = resolve_device(device)
    w, er, v, cv = (to_device(x, dev, torch.float32)
                    for x in (weights, expected_returns, vars_, cvars))
    return {
        "expected_return": torch.sum(w * er),
        "var": torch.sum(w * v),
        "cvar": torch.sum(w * cv),
    }


def simulate_portfolio_correlated(generator, initial_prices, mus, cov, weights,
                                  days: int, num_sims: int,
                                  dt: float = 1.0 / PERIODS_PER_YEAR, *, z=None,
                                  device=None):
    """Joint GBM with correlated shocks through the Cholesky factor of the
    annualized return covariance; the portfolio's value per path is
    Σ wᵢ·Sᵢ/Sᵢ₀.  ``z`` [num_sims, days − 1, n_assets] replaces the draw.
    Returns the portfolio's relative-value paths [num_sims, days]."""
    dev = resolve_device(device)
    initial_prices, mus, cov, weights = (to_device(x, dev, torch.float32)
                                         for x in (initial_prices, mus, cov, weights))
    n_assets = initial_prices.shape[0]
    chol = torch.linalg.cholesky(cov + 1e-12 * torch.eye(n_assets, device=dev))
    z = (torch.randn((num_sims, days - 1, n_assets), generator=generator, device=dev)
         if z is None else to_device(z, dev, torch.float32))
    shocks = torch.einsum("sdk,ak->sda", z, chol) * float(np.sqrt(_F(dt)))
    sig2 = torch.diagonal(cov)
    inc = (mus - 0.5 * sig2) * float(_F(dt)) + shocks
    log_paths = torch.cat([torch.zeros((num_sims, 1, n_assets), device=dev),
                           torch.cumsum(inc, dim=1)], dim=1)
    rel = torch.exp(log_paths)                          # S_t / S_0 per asset
    return torch.einsum("sda,a->sd", rel, weights)      # portfolio relative value
