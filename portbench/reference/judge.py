"""The comparison that decides a sweep cell's ``correct``.

One checked request is judged in two stages, each against the plain
reference and each by numbers with limits of their own:

  C. the replay: the reference's walk over the streams the program was
     handed, for a sample of strategies drawn from the seed plus the one
     with the most trades, with the stops recomputed from the seed
     (`replay_count_err`: the largest gap of a count; `replay_err`: the
     largest relative gap of a balance, profit, loss, drawdown or return
     moment);
  D. the metrics: the reference's suite computed from the program's stats
     of every strategy against the program's metrics (`metrics_err`: the
     worst metric's largest gap over its largest magnitude).

The streams themselves are the reference's (`reference_streams`): the
benchmark makes them and hands the same to both sides.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import indicators as ref_ind
from portbench.reference import metrics as ref_metrics
from portbench.reference import replay as ref_replay
from portbench.reference import signals as ref_sig

STREAMS = ("close", "signal", "strength", "volatility", "volume", "confidence", "decision")


def _scaled_gap(p, r):
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    scale = float(np.max(np.abs(r))) if r.size else 0.0
    gap = np.abs(p - r)
    gap = np.where(np.isnan(p) & np.isnan(r), 0.0, np.where(np.isnan(gap), np.inf, gap))
    return float(np.max(gap)) / max(scale, 1e-30) if gap.size else 0.0


def replay_numbers(streams: dict, stops: np.ndarray, targets: np.ndarray,
                   stats: dict, rows) -> dict:
    """Stage C over the strategies ``rows``.  ``stops``/``targets``: the
    percent stops of every strategy, recomputed from the seed; ``stats``:
    the program's stats, arrays over strategies."""
    gate = ref_sig.entry_gate(streams["signal"], streams["strength"],
                              streams["confidence"], streams["decision"])
    count_gap = value_gap = 0.0
    for b in rows:
        ref = ref_replay.walk(streams["close"], gate, streams["volatility"], streams["volume"],
                              stops[b], targets[b])
        for k in ref_replay.FIELDS_I:
            count_gap = max(count_gap, abs(float(stats[k][b]) - float(ref[k])))
        for k in ref_replay.FIELDS_F:
            p, r = float(stats[k][b]), float(ref[k])
            gap = abs(p - r) / max(abs(r), 1e-30) if p != r else 0.0
            value_gap = max(value_gap, gap if np.isfinite(gap) else np.inf)
    return {"replay_count_err": count_gap, "replay_err": value_gap}


def metric_numbers(stats: dict, metrics: dict) -> dict:
    """Stage D: the reference's suite from the program's stats."""
    ints = set(ref_replay.FIELDS_I)
    s = {k: np.asarray(v, np.int64 if k in ints else np.float64) for k, v in stats.items()}
    ref = ref_metrics.metric_suite(s)
    return {"metrics_err": max(_scaled_gap(metrics[k], ref[k]) for k in ref)}


def reference_streams(raw: dict) -> tuple[dict, dict]:
    """(streams, table): the replay's streams made by the reference from raw
    candles, from its float64 table with the signal rule in float32,
    confidence 1 and the decision = the signal."""
    table = ref_ind.indicator_table(*(np.asarray(raw[k], np.float64)
                                      for k in ("high", "low", "close", "volume")))
    table = {k: np.asarray(v, np.float32) for k, v in table.items()}
    table.update({k: np.asarray(raw[k], np.float32) for k in ("close", "volume")})
    streams = ref_sig.signal_inputs(table)
    T = raw["close"].shape[-1]
    streams.update(confidence=np.ones(T, np.float32), decision=streams["signal"])
    return {k: np.asarray(v, np.int32 if k in ("signal", "decision") else np.float32)
            for k, v in streams.items()}, table


def stops_from_uniforms(u: np.ndarray):
    """The strategies' stop-loss and take-profit (percent), from the [B, 18]
    uniforms that draw them: dimensions 16 and 17 of the evolution brain's
    parameter space, ranges [1, 5] and [1, 10], in float32."""
    f = np.float32
    u = np.asarray(u, f)
    return f(1.0) + u[:, 16] * f(4.0), f(1.0) + u[:, 17] * f(9.0)
