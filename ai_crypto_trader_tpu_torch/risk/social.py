"""Social-sentiment risk adjustment.

Port of `ai_crypto_trader_tpu/risk/social.py` (the reference's
SocialRiskAdjuster): a source-weighted sentiment score over twitter /
reddit / news / overall, with an exponential time decay (6-hour half-life);
sentiment → position-size / stop-loss / take-profit / correlation-limit
factors, each capped at ±max_adjustment_percent; below min_data_quality
everything is neutral.

`SocialSnapshot` is timestamped sentiment observations; it is not
`data.ingest.SocialDaily` (daily social metrics on disk), a different
record.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.config import SocialRiskParams
from ai_crypto_trader_tpu_torch.device import div_true, resolve_device, to_device

DEFAULT_SOURCE_WEIGHTS = (0.35, 0.30, 0.25, 0.10)  # twitter/reddit/news/overall


class SocialSnapshot(NamedTuple):
    """Timestamped sentiment observations: sentiments[i, s] ∈ [0, 1] for
    observation i from source s; age_hours[i] = now − t_i."""

    sentiments: torch.Tensor    # [N, n_sources]
    age_hours: torch.Tensor     # [N]
    data_quality: torch.Tensor  # scalar ∈ [0, 1]


def _on(snap: SocialSnapshot, dev) -> SocialSnapshot:
    return SocialSnapshot(*(to_device(x, dev, torch.float32) for x in snap))


def weighted_sentiment(snap: SocialSnapshot,
                       source_weights=DEFAULT_SOURCE_WEIGHTS,
                       half_life_hours: float = 6.0, device=None):
    """Time-decayed, source-weighted sentiment ∈ [0, 1]."""
    dev = resolve_device(device)
    snap = _on(snap, dev)
    w_src = to_device(source_weights, dev, torch.float32)
    w_src = w_src / torch.sum(w_src)
    decay = torch.exp2(div_true(-snap.age_hours, half_life_hours))   # [N]
    per_obs = snap.sentiments @ w_src                                # [N]
    denom = torch.clamp_min(torch.sum(decay), 1e-9)
    return torch.sum(per_obs * decay) / denom


def social_risk_adjustment(snap: SocialSnapshot,
                           params: SocialRiskParams | None = None, device=None):
    """Sentiment → multiplicative adjustment factors.  Bullish sentiment
    (≥ bullish_threshold) sizes up and widens the take-profit; bearish (≤
    bearish_threshold) sizes down and tightens stops; every factor is
    clamped to 1 ± max_adjustment_percent, and a failing data-quality gate
    returns exact neutrality."""
    dev = resolve_device(device)
    snap = _on(snap, dev)
    p = params or SocialRiskParams()
    # column order of SocialSnapshot: twitter, reddit, news, overall
    w = tuple(p.sentiment_weights.get(k, d) for k, d in zip(
        ("twitter_sentiment", "reddit_sentiment", "news_sentiment",
         "overall_sentiment"), DEFAULT_SOURCE_WEIGHTS))
    s = weighted_sentiment(snap, source_weights=w,
                           half_life_hours=p.sentiment_half_life_hours, device=dev)

    # signed intensity ∈ [-1, 1]: 0 at the neutral band's centre, ±1 at
    # the extremes
    center = (p.bullish_threshold + p.bearish_threshold) / 2.0
    span = (p.bullish_threshold - p.bearish_threshold) / 2.0
    intensity = torch.clamp(div_true(s - center, span), -1.0, 1.0)
    in_band = (s < p.bullish_threshold) & (s > p.bearish_threshold)
    intensity = torch.where(in_band, 0.0, intensity)

    cap = p.max_adjustment_percent

    def factor(impact):
        return torch.clamp(1.0 + intensity * impact, 1.0 - cap, 1.0 + cap)

    quality_ok = snap.data_quality >= p.min_data_quality
    enabled = quality_ok & bool(p.enabled)

    def gated(f):
        return torch.where(enabled, f, 1.0)

    return {
        "sentiment": s,
        "intensity": torch.where(enabled, intensity, 0.0),
        "position_size_factor": gated(factor(p.position_size_impact)),
        # bearish → tighter stop (smaller stop distance), bullish → roomier
        "stop_loss_factor": gated(factor(p.stop_loss_impact)),
        "take_profit_factor": gated(factor(p.take_profit_impact)),
        "correlation_limit_factor": gated(factor(-p.correlation_impact)),
        "data_quality_ok": quality_ok,
    }
