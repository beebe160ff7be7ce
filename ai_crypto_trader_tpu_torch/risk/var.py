"""Portfolio risk analytics: VaR / CVaR / correlation / sizing.

Port of `ai_crypto_trader_tpu/risk/var.py` (the reference's
PortfolioRiskService): historical and parametric VaR and CVaR, the asset
correlation matrix, correlation-aware portfolio VaR, equal-risk position
sizes, stress VaR / CVaR through the Monte-Carlo engine, and a
diversification analysis.  Return matrices are [n_assets, T]; positive
numbers are losses.

`parametric_var` and `diversification_analysis` use ``std`` with ddof = 0,
as `jnp.std`.  The normal quantile for a confidence is the JAX package's
three-point `jnp.interp`, which torch lacks: `interp3` is the same
arithmetic in NumPy float32 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import (
    const_over,
    div_const,
    resolve_device,
    to_device,
)
from ai_crypto_trader_tpu_torch.mc.engine import quantile, run_simulation

_F = np.float32
_Z_CONF = np.asarray([0.90, 0.95, 0.99], _F)
_Z_VALUE = np.asarray([1.2816, 1.6449, 2.3263], _F)


def interp3(x: float) -> float:
    """``jnp.interp(x, [0.90, 0.95, 0.99], [1.2816, 1.6449, 2.3263])`` in
    float32: the normal quantile z for a confidence, clamped to the end
    values outside [0.90, 0.99]."""
    xp, fp, x = _Z_CONF, _Z_VALUE, _F(x)
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    df = _F(fp[i] - fp[i - 1])
    dx = _F(xp[i] - xp[i - 1])
    delta = _F(x - xp[i - 1])
    f = _F(fp[i - 1] + _F(_F(delta / dx) * df))
    if x < xp[0]:
        f = fp[0]
    if x > xp[-1]:
        f = fp[-1]
    return float(f)


def _returns(returns, dev):
    return to_device(returns, dev, torch.float32)


def historical_var(returns, confidence: float = 0.95, device=None):
    """Empirical VaR: the (1 − c) quantile of the returns, reported as a
    positive loss.  returns: [..., T]."""
    r = _returns(returns, resolve_device(device))
    q = quantile(r, _F(1.0) - _F(confidence), dim=-1)
    return torch.clamp_min(-q, 0.0)


def parametric_var(returns, confidence: float = 0.95, device=None):
    """Gaussian VaR: −(μ − z·σ), z the normal quantile (1.645 at 95 %)."""
    r = _returns(returns, resolve_device(device))
    mu = torch.mean(r, dim=-1)
    sd = torch.std(r, dim=-1, correction=0)
    return torch.clamp_min(-(mu - interp3(confidence) * sd), 0.0)


def cvar(returns, confidence: float = 0.95, device=None):
    """Expected shortfall beyond the historical VaR."""
    dev = resolve_device(device)
    r = _returns(returns, dev)
    var = historical_var(r, confidence, device=dev)
    tail = r <= -var[..., None]
    tail_sum = torch.sum(torch.where(tail, r, 0.0), dim=-1)
    tail_n = torch.clamp_min(torch.sum(tail, dim=-1), 1)
    return torch.clamp_min(-(tail_sum / tail_n), 0.0)


def _cov(r):
    x = r - torch.mean(r, dim=-1, keepdim=True)
    return div_const(x @ x.T, float(r.shape[-1]))


def correlation_matrix(returns, device=None):
    """[n, n] Pearson correlations from [n, T] returns."""
    cov = _cov(_returns(returns, resolve_device(device)))
    sd = torch.sqrt(torch.diagonal(cov))
    denom = torch.outer(sd, sd)
    return cov / torch.where(denom == 0.0, 1.0, denom)


def portfolio_var(weights, returns, confidence: float = 0.95, device=None):
    """Correlation-aware portfolio VaR: σ_p = √(wᵀ Σ w), VaR = z·σ_p − μ_p."""
    dev = resolve_device(device)
    r = _returns(returns, dev)
    w = to_device(weights, dev, torch.float32)
    cov = _cov(r)
    mu_p = torch.sum(w * torch.mean(r, dim=-1))
    sigma_p = torch.sqrt(torch.clamp_min(w @ cov @ w, 0.0))
    return torch.clamp_min(interp3(confidence) * sigma_p - mu_p, 0.0)


def equal_risk_position_sizes(volatilities, total_capital: float = 1.0,
                              max_allocation: float = 0.25, device=None):
    """Inverse-volatility sizing with a per-asset allocation cap: the
    excess over the cap is redistributed over the uncapped assets in a
    fixed 4 projection steps, then capped once more."""
    dev = resolve_device(device)
    v = to_device(volatilities, dev, torch.float32)
    inv = const_over(1.0, torch.clamp_min(v, 1e-8))
    w = inv / torch.sum(inv)
    cap = float(_F(max_allocation))
    for _ in range(4):
        over = torch.clamp_min(w - cap, 0.0)
        w = torch.clamp_max(w, cap)
        free = w < cap
        freeable = torch.where(free, w, 0.0)
        denom = torch.sum(freeable)
        w = w + torch.where(free, freeable / torch.where(denom == 0, 1.0, denom),
                            0.0) * torch.sum(over)
    w = torch.clamp_max(w, cap)
    return w * float(_F(total_capital))


def stress_var_cvar(generator, initial_price, returns, *,
                    stress: str = "flash_crash", days: int = 30,
                    num_sims: int = 4096, confidence: float = 0.95,
                    method: str = "gbm", stress_seed: int = 0, z=None, idx=None,
                    device=None) -> dict:
    """Stress VaR / CVaR: the Monte-Carlo engine twice on the same draws,
    once plain and once with a `sim.scenarios` preset overlaid per path,
    both tails reported so the uplift reads directly.  ``*_pct`` values
    are positive losses in percent of the initial price.  The draws come
    from ``generator`` once (or ``z`` / ``idx`` injected) and serve both
    runs, as the JAX function's one key does."""
    dev = resolve_device(device)
    returns = _returns(returns, dev)
    if method == "gbm" and z is None:
        z = torch.randn((num_sims, days - 1), generator=generator, device=dev)
    if method != "gbm" and idx is None:
        idx = torch.randint(0, returns.shape[-1], (num_sims, days - 1),
                            generator=generator, device=dev)
    kw = dict(days=days, num_sims=num_sims, confidence=confidence,
              method=method, z=z, idx=idx, device=dev)
    base = run_simulation(generator, initial_price, returns, **kw)
    stressed = run_simulation(generator, initial_price, returns, stress=stress,
                              stress_seed=stress_seed, **kw)

    def loss(stats, k):
        return float(torch.clamp_min(-stats[k], 0.0))

    # the uplift is on the SIGNED percentile shifts, so a bullish base tail
    # clamped to 0 cannot hide a real deterioration
    base_var, stress_var = float(base["var"]), float(stressed["var"])
    return {
        "stress": stressed["stress"],
        "confidence": confidence,
        "num_sims": num_sims,
        "days": days,
        "var_pct": loss(base, "var"),
        "cvar_pct": loss(base, "cvar"),
        "var_signed_pct": base_var,
        "stress_var_signed_pct": stress_var,
        "stress_var_pct": loss(stressed, "var"),
        "stress_cvar_pct": loss(stressed, "cvar"),
        "var_uplift_pct": base_var - stress_var,
        "stress_max_drawdown_mean": float(stressed["max_drawdown_mean"]),
        "stress_prob_loss": float(stressed["prob_loss"]),
    }


def diversification_analysis(weights, returns, device=None):
    """Concentration and correlation diagnostics: Herfindahl index,
    effective number of assets, average pairwise correlation,
    diversification ratio."""
    dev = resolve_device(device)
    w = to_device(weights, dev, torch.float32)
    r = _returns(returns, dev)
    corr = correlation_matrix(r, device=dev)
    n = w.shape[0]
    hhi = torch.sum(w**2)
    off = corr - torch.eye(n, device=dev) * corr
    avg_corr = div_const(torch.sum(off), float(max(n * (n - 1), 1)))
    sd = torch.std(r, dim=-1, correction=0)
    sigma_p = torch.sqrt(torch.clamp_min(w @ _cov(r) @ w, 1e-12))
    div_ratio = torch.sum(w * sd) / sigma_p
    return {
        "herfindahl": hhi,
        "effective_assets": const_over(1.0, torch.clamp_min(hhi, 1e-9)),
        "avg_pairwise_correlation": avg_corr,
        "diversification_ratio": div_ratio,
    }
