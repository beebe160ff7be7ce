"""A run with its timed path broken underneath has to come out not
correct: the harness's look for a card skipped, the rest of a run driven on
the CPU at a small size, with one fault planted in the port's entries as
the benchmark calls them.  A one-card cell has no exchange between cards to
leave out."""

import importlib
import time

import pytest
import torch

from portbench import run
from portbench.tests.cells import CELLS, kind_of, small


def _unchanged(real):
    """A sweep that returns its state unchanged: the stats of no candle."""
    def fault(inputs, params, **kw):
        s = real(inputs, params, **kw)
        z = lambda v, fill: torch.full_like(v, fill)  # noqa: E731
        return s._replace(final_balance=s.initial_balance.clone(),
                          **{k: z(getattr(s, k), 0) for k in (
                              "total_trades", "winning_trades", "losing_trades", "total_profit",
                              "total_loss", "max_drawdown", "max_drawdown_pct", "sum_r", "sum_r2",
                              "sum_neg_r2", "max_win_streak", "max_loss_streak")},
                          n_r=z(s.n_r, 1))
    return fault


def _half(real):
    """Half of the strategies left out, the mean of the rest in its place."""
    def fault(inputs, params, **kw):
        h = params.stop_loss.shape[0] // 2
        s = real(inputs, params._replace(**{f: getattr(params, f)[:h] for f in params._fields}), **kw)
        fill = lambda v: torch.cat([v, v.double().mean().to(v.dtype).expand(v.shape[0])])  # noqa: E731
        return type(s)(*(fill(v) for v in s))
    return fault


def _altered_metric(real):
    """One answer altered where it is produced: a strategy's final balance
    in the metrics."""
    def fault(stats, **kw):
        m = real(stats, **kw)
        m["final_balance"] = m["final_balance"].clone()
        m["final_balance"][0] *= 1.01
        return m
    return fault


def _decide_unchanged(real):
    """A decide that returns the tenants' state unchanged."""
    def fault(state, params, feats, **kw):
        out, _, fleet = real(state, params, feats, **kw)
        return out, state, fleet
    return fault


def _decide_half(real):
    """Half of the tenants left out, the mean of the rest's sizes and
    equity, and its first tenant's gates, in their place."""
    def fault(state, params, feats, **kw):
        out, new, fleet = real(state, params, feats, **kw)
        h = out["gate"].shape[0] // 2
        out = dict(out)
        for k in ("size", "equity"):
            v = out[k].clone()
            v[h:] = v[:h].double().mean(0).to(v.dtype)
            out[k] = v
        gate = out["gate"].clone()
        gate[h:] = gate[0]
        out["gate"] = gate
        return out, new, fleet
    return fault


def _decide_altered(real):
    """One answer altered where it is produced: a tenant's gate."""
    def fault(state, params, feats, **kw):
        out, new, fleet = real(state, params, feats, **kw)
        out = dict(out)
        out["gate"] = out["gate"].clone()
        out["gate"][0, 0] = 6 if int(out["gate"][0, 0]) != 6 else 3
        return out, new, fleet
    return fault


def _tick_altered(real):
    """One answer altered where it is produced: a symbol's signal strength
    in the tick program's features."""
    def fault(*args, **kw):
        out = real(*args, **kw)
        out["signal_strength"] = out["signal_strength"].clone()
        out["signal_strength"][0, 0] += 10.0
        return out
    return fault


SWEEP = "ai_crypto_trader_tpu_torch.backtest"
TENANT = "ai_crypto_trader_tpu_torch.ops.tenant_engine"
FAULTS = {
    "sweep": {"unchanged_state": (SWEEP, "sweep", _unchanged),
              "half_batch": (SWEEP, "sweep", _half),
              "altered_metric": (SWEEP, "compute_metrics", _altered_metric)},
    "trading": {"unchanged_state": (TENANT, "_decide_program", _decide_unchanged),
                "half_batch": (TENANT, "_decide_program", _decide_half),
                "altered_decision": (TENANT, "_decide_program", _decide_altered),
                "altered_feature": ("ai_crypto_trader_tpu_torch.ops.tick_engine", "_tick_program",
                                    _tick_altered)},
}


def _run(spec, seed=2**31 + 4242):
    return run.execute(spec, seed, 0.05, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_an_unbroken_small_run_is_correct(cell):
    out = _run(small(cell))
    assert out["correct"], out["checks"]
    assert out["window"]["attempted"] >= 1 and out["window"]["failed"] == 0


@pytest.mark.parametrize(("cell", "fault"),
                         [(c, f) for c in CELLS for f in sorted(FAULTS[kind_of(c)])])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    module_name, attr, make = FAULTS[kind_of(cell)][fault]
    module = importlib.import_module(module_name)
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    out = _run(small(cell, permissive=True))
    if fault == "unchanged_state" and kind_of(cell) == "trading":
        assert out["notes"]["executed"] > 0, "no decision opened a position"
    assert not out["correct"], out["checks"]
