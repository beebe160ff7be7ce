"""Fleet observatory: lane telemetry aggregated on the device for the
tenant engine's decide.

The port of `ai_crypto_trader_tpu/obs/fleetscope.py`.  Every decide of
`ops.tenant_engine.TenantEngine` can compute, in the same program and
through the same one host read, a summary of the whole fleet whose size
does not grow with the tenant count:

  * a **gate histogram** over the [N, S] gate-id table (one bin per gate
    of `obs.flightrec.GATES` plus `executable` / `no_decision`), padded
    and deactivated tenants excluded;
  * **verdict counts**: decisions, executable, starved lanes (active
    tenants whose whole symbol row produced no decision);
  * **dispersion quantiles** (p5 / p50 / p95, nearest rank) of the lanes'
    rolling PnL and balance, and the largest max drawdown;
  * the **best / worst K lanes** by rolling PnL.

`device_aggregates` is the torch reduction the decide runs on its own
device; `host_aggregates` is its NumPy twin; `FleetScope` is the host
half (rolling windows, gauges, alert inputs, the status block), copied.
Quarantined lanes stay in the histogram and are masked out of every value
aggregate, so a poisoned lane's NaN cannot reach the fleet's quantiles.

The ranks follow `lax.top_k`, which lists the lowest index first among
equal values (masked lanes are ±inf ties): a stable descending sort and
its first K.  `torch.topk` promises no order among ties.

Activation is module-global: the disabled hot path is one
``active() is None`` check.
"""

from __future__ import annotations

import contextlib
import zlib
from collections import deque

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.obs.flightrec import GATES

#: best/worst lane count in the device rank table (clamped to the padded
#: tenant axis)
TOP_K = 8
#: fleet dispersion quantiles (percent), nearest rank
QUANTILES = (5, 50, 95)
_QUANT_FRACS = tuple(q / 100.0 for q in QUANTILES)
QUANTILE_LABELS = tuple(f"p{q}" for q in QUANTILES)

#: default crc32 lane-sampling rate for full decision provenance
DEFAULT_SAMPLE_RATE = 0.05
#: veto share past which one gate counts as dominating the fleet's mix
DEFAULT_GATE_DOMINANCE = 0.95
#: PnL p95−p5 spread (quote units) past which dispersion alerts
DEFAULT_PNL_SPREAD_BUDGET = 500.0
#: engine-mirror vs venue-truth relative balance divergence budget
DEFAULT_BALANCE_DRIFT_BUDGET = 0.01

_ACTIVE: "FleetScope | None" = None


def bin_names() -> tuple:
    """Histogram bin vocabulary, in bin order: ``no_decision`` (gate id
    −2), ``executable`` (−1), then `GATES` (ids 0…)."""
    return ("no_decision", "executable") + tuple(GATES)


def _ranked(vals, k: int):
    """The first ``k`` of ``vals`` sorted in descending order, ties in
    index order (`lax.top_k`'s order), and their indices."""
    v, i = torch.sort(vals, descending=True, stable=True)
    return v[:k], i[:k]


def device_aggregates(*, gate, pnl, balance, max_drawdown, active,
                      quarantined=None, k: int | None = None) -> dict:
    """The fleet reduction, in torch on the device of ``gate``, with no
    host read: the tenant engine packs its result into the decide's one
    read.

    ``gate`` is the [N, S] int8 gate-id table; ``pnl`` / ``balance`` /
    ``max_drawdown`` / ``active`` / ``quarantined`` are [N] over the
    padded tenant axis.  Returns tensors with the JAX package's dtypes
    (int32 counts and lane ids, float32 values)."""
    dev = gate.device
    n_gates = len(GATES)
    act = active.to(torch.bool)
    n_act = act.to(torch.int32).sum().to(torch.int32)
    if quarantined is None:
        healthy = act
        n_quar = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        q = quarantined.to(torch.bool)
        healthy = act & ~q
        n_quar = (act & q).to(torch.int32).sum().to(torch.int32)
    n_healthy = healthy.to(torch.int32).sum().to(torch.int32)
    # histogram over gate ids −2 … n_gates−1, active tenants only
    ids = torch.arange(-2, n_gates, dtype=gate.dtype, device=dev)
    hist = ((gate[None, :, :] == ids[:, None, None])
            & act[None, :, None]).sum(dim=(1, 2)).to(torch.int32)
    decisions = hist[2:].sum() + hist[1]      # everything but no_decision
    executable = hist[1]
    starved = (act & (gate == -2).all(dim=1)).to(torch.int32).sum().to(torch.int32)
    m = torch.clamp_min(n_healthy - 1, 0).to(torch.float32)

    def quantiles(vals):
        # nearest rank over the healthy rows: masked rows sort to +inf; the
        # rank is round(frac · (n_healthy − 1)) in float32, half to even
        v = torch.sort(torch.where(healthy, vals, torch.inf)).values
        idx = torch.stack([torch.round(m * f) for f in _QUANT_FRACS])
        idx = torch.clamp(idx.to(torch.int32), 0, v.shape[0] - 1).to(torch.int64)
        return torch.where(n_healthy > 0, v[idx], torch.nan)

    k_eff = min(int(k if k is not None else TOP_K), int(pnl.shape[0]))
    best_pnl, best_lane = _ranked(torch.where(healthy, pnl, -torch.inf), k_eff)
    worst_neg, worst_lane = _ranked(torch.where(healthy, -pnl, -torch.inf), k_eff)
    dd = torch.where(healthy, max_drawdown, -torch.inf)
    return {
        "gate_hist": hist,
        "decisions": decisions.to(torch.int32),
        "executable": executable.to(torch.int32),
        "starved": starved,
        "active": n_act,
        "quarantined": n_quar,
        "pnl_q": quantiles(pnl),
        "balance_q": quantiles(balance),
        "max_drawdown_max": torch.where(n_healthy > 0, dd.max(), torch.nan),
        "best_pnl": best_pnl,
        "best_lane": best_lane.to(torch.int32),
        "worst_pnl": -worst_neg,
        "worst_lane": worst_lane.to(torch.int32),
    }


def host_aggregates(*, gate, pnl, balance, max_drawdown, active,
                    quarantined=None, k: int | None = None) -> dict:
    """NumPy twin of :func:`device_aggregates`, the oracle the tests and
    chip_smoke.py recompute from the host-read decision table: the same
    nearest-rank formula and masking (quarantined lanes counted in the
    histogram, excluded from values), an independent implementation."""
    gate = np.asarray(gate)
    act = np.asarray(active, bool)
    n_gates = len(GATES)
    n_act = int(act.sum())
    if quarantined is None:
        healthy = act
        n_quar = 0
    else:
        q = np.asarray(quarantined, bool)
        healthy = act & ~q
        n_quar = int((act & q).sum())
    n_healthy = int(healthy.sum())
    ids = np.arange(-2, n_gates)
    hist = np.array([int(((gate == g) & act[:, None]).sum()) for g in ids],
                    np.int32)
    starved = int((act & (gate == -2).all(axis=1)).sum())

    def quantiles(vals):
        v = np.sort(np.where(healthy, np.asarray(vals, np.float64),
                             np.inf))
        idx = np.clip(np.round(np.asarray(_QUANT_FRACS)
                               * max(n_healthy - 1, 0)).astype(np.int64),
                      0, v.shape[0] - 1)
        return (v[idx] if n_healthy > 0
                else np.full(len(_QUANT_FRACS), np.nan))

    k_eff = min(int(k if k is not None else TOP_K), int(len(pnl)))
    pnl = np.asarray(pnl, np.float64)
    # ±inf masking mirrors the device exactly: tail ranks beyond the
    # healthy count read ∓inf, never a masked lane's stale real PnL
    best_vals = np.where(healthy, pnl, -np.inf)
    worst_vals = np.where(healthy, pnl, np.inf)
    best = np.argsort(-best_vals, kind="stable")[:k_eff]
    worst = np.argsort(worst_vals, kind="stable")[:k_eff]
    return {
        "gate_hist": hist,
        "decisions": int(hist[1:].sum()),
        "executable": int(hist[1]),
        "starved": starved,
        "active": n_act,
        "quarantined": n_quar,
        "pnl_q": quantiles(pnl),
        "balance_q": quantiles(balance),
        "max_drawdown_max": (float(np.max(np.asarray(max_drawdown)[healthy]))
                             if n_healthy else float("nan")),
        "best_pnl": best_vals[best],
        "best_lane": best.astype(np.int32),
        "worst_pnl": worst_vals[worst],
        "worst_lane": worst.astype(np.int32),
    }


def lane_sampled(lane: int, rate: float = DEFAULT_SAMPLE_RATE) -> bool:
    """crc32-stable lane sampling: deterministic across runs, processes
    and hosts (no RNG state, no seed to drift), uniform-ish over lane
    ids.  A lane keeps (or loses) its full provenance for life — the
    property that makes `cli why --lane N` answerable after a restart."""
    return zlib.crc32(b"fleet-lane-%d" % int(lane)) % 10_000 \
        < int(rate * 10_000)


class FleetScope:
    """Host half of the fleet observatory: bounded-cardinality export,
    rolling alert windows, the /state.json ``fleet`` block and the lane
    sample.

    Feed it once per decide with :meth:`observe_decide` (the tenant
    engine does this behind the module-global one-check); everything it
    publishes is O(gates + quantiles + K) series regardless of how many
    tenants the device evaluated."""

    def __init__(self, metrics=None, *, top_k: int = TOP_K,
                 sample_rate: float = DEFAULT_SAMPLE_RATE,
                 window: int = 64, min_decides: int = 8,
                 min_vetoes: int = 32,
                 gate_dominance_threshold: float = DEFAULT_GATE_DOMINANCE,
                 pnl_spread_budget: float = DEFAULT_PNL_SPREAD_BUDGET,
                 balance_drift_budget: float = DEFAULT_BALANCE_DRIFT_BUDGET):
        self.metrics = metrics
        self.top_k = int(top_k)
        self.sample_rate = float(sample_rate)
        self.window = int(window)
        self.min_decides = int(min_decides)
        self.min_vetoes = int(min_vetoes)
        self.gate_dominance_threshold = float(gate_dominance_threshold)
        self.pnl_spread_budget = float(pnl_spread_budget)
        self.balance_drift_budget = float(balance_drift_budget)
        self.decides = 0
        self.tenants = 0
        self.last: dict = {}                 # newest decide's summary
        self._hist_window: deque = deque(maxlen=self.window)
        self._starved_window: deque = deque(maxlen=self.window)
        self._drift_window: deque = deque(maxlen=self.window)
        self._sample_cache: tuple | None = None   # (n, lanes)
        self._rank_hwm: dict = {}            # extreme -> max rank exported

    # -- lane sampling -------------------------------------------------------
    def sampled(self, lane: int) -> bool:
        return lane_sampled(lane, self.sample_rate)

    def sample_lanes(self, n_tenants: int) -> list[int]:
        """The deterministic provenance sample for an N-tenant fleet."""
        if self._sample_cache and self._sample_cache[0] == n_tenants:
            return self._sample_cache[1]
        lanes = [i for i in range(int(n_tenants)) if self.sampled(i)]
        self._sample_cache = (int(n_tenants), lanes)
        return lanes

    # -- per-decide fold -----------------------------------------------------
    def veto_counts(self, fleet: dict) -> dict:
        """{gate_name: count} from the DEVICE gate histogram — the
        replacement for the host-side [N, S] table scan
        (`TenantEngine.veto_counts`): one dict of at most len(GATES)
        entries per tick, zero per-lane host work."""
        hist = np.asarray(fleet["gate_hist"], np.int64)
        names = bin_names()
        return {names[i]: int(hist[i]) for i in range(2, len(names))
                if hist[i] > 0}

    def observe_decide(self, fleet: dict, *, tenants: int,
                       balance_drift: float = 0.0,
                       balance_resyncs: int = 0,
                       quarantined: int | None = None,
                       heals: int = 0) -> None:
        """Fold one decide's device aggregates into the rolling windows
        and export the gauges.  ``balance_drift`` is the worst relative
        engine-mirror vs venue-truth divergence the rim re-anchored
        since the previous decide (0.0 = mirrors agreed);
        ``quarantined`` / ``heals`` are the engine's host-mirror
        containment counters (quarantined defaults to the device count
        when the caller doesn't override)."""
        hist = np.asarray(fleet["gate_hist"], np.int64)
        self.decides += 1
        self.tenants = int(tenants)
        self._hist_window.append(hist)
        decisions = int(fleet["decisions"])
        # a decide with no decisions at all (warming universe / outage)
        # must not mark every lane starved — the starvation signal is
        # "the fleet decided, this lane didn't"
        self._starved_window.append(int(fleet["starved"])
                                    if decisions > 0 else 0)
        self._drift_window.append(max(float(balance_drift), 0.0))
        n_act = int(fleet["active"])
        k = min(self.top_k, n_act)
        self.last = {
            "tenants": self.tenants,
            "active_lanes": n_act,
            "decisions": decisions,
            "executable": int(fleet["executable"]),
            # this decide's RAW count; the alerting value is the
            # windowed min (`starved_lanes()`) — distinct keys so the
            # status() merge can never shadow the gated signal
            "starved_last_decide": int(fleet["starved"]),
            "pnl": dict(zip(QUANTILE_LABELS,
                            [round(float(v), 6)
                             for v in np.asarray(fleet["pnl_q"])])),
            "balance": dict(zip(QUANTILE_LABELS,
                                [round(float(v), 6)
                                 for v in np.asarray(fleet["balance_q"])])),
            "max_drawdown_max": round(float(fleet["max_drawdown_max"]), 6),
            "best": [{"lane": int(l), "pnl": round(float(p), 6)}
                     for l, p in zip(np.asarray(fleet["best_lane"])[:k],
                                     np.asarray(fleet["best_pnl"])[:k])],
            "worst": [{"lane": int(l), "pnl": round(float(p), 6)}
                      for l, p in zip(np.asarray(fleet["worst_lane"])[:k],
                                      np.asarray(fleet["worst_pnl"])[:k])],
            "balance_resyncs": int(balance_resyncs),
            "quarantined_lanes": int(quarantined
                                     if quarantined is not None
                                     else fleet.get("quarantined", 0)),
            "heals_total": int(heals),
        }
        self.export()

    # -- rolling views -------------------------------------------------------
    def gate_mix(self) -> dict:
        """{bin_name: windowed count} over the histogram window —
        includes the `executable` / `no_decision` outcomes."""
        if not self._hist_window:
            return {}
        total = np.sum(np.stack(self._hist_window), axis=0)
        return {name: int(c) for name, c in zip(bin_names(), total) if c}

    def gate_dominance(self) -> tuple[str | None, float]:
        """(dominant veto gate, its share of the windowed VETO mix).
        Share is 0.0 until the window holds ``min_vetoes`` vetoes — one
        cold tick of nan_gate must never page (the burn-alert
        discipline)."""
        if not self._hist_window:
            return None, 0.0
        total = np.sum(np.stack(self._hist_window), axis=0)
        vetoes = total[2:]                    # gate bins only
        n_vetoes = int(vetoes.sum())
        if n_vetoes < self.min_vetoes:
            return None, 0.0
        top = int(np.argmax(vetoes))
        return bin_names()[2 + top], float(vetoes[top]) / n_vetoes

    def starved_lanes(self) -> int:
        """Windowed MIN of the per-decide starved-lane count (min-sample
        gated): a nonzero value means some lanes produced no decision in
        EVERY decide of the window — sustained starvation, not one
        throttled tick."""
        if len(self._starved_window) < self.min_decides:
            return 0
        return int(min(self._starved_window))

    def pnl_spread(self) -> float:
        pnl = self.last.get("pnl") or {}
        lo, hi = pnl.get(QUANTILE_LABELS[0]), pnl.get(QUANTILE_LABELS[-1])
        if lo is None or hi is None or not np.isfinite([lo, hi]).all():
            return 0.0
        return float(hi - lo)

    def balance_drift_max(self) -> float:
        return float(max(self._drift_window, default=0.0))

    # -- export surfaces -----------------------------------------------------
    def export(self) -> None:
        """Publish the fleet gauges: O(gates + quantiles + K) series for
        any N (the bounded-cardinality contract the tests pin at
        N=1000)."""
        m = self.metrics
        if m is None or not self.last:
            return
        last = self.last
        m.inc("fleet_decides_total")
        m.inc("fleet_decisions_total", last["decisions"])
        m.set_gauge("fleet_tenants", last["tenants"])
        m.set_gauge("fleet_active_lanes", last["active_lanes"])
        m.set_gauge("fleet_executable", last["executable"])
        m.set_gauge("fleet_starved_lanes", self.starved_lanes())
        m.set_gauge("fleet_quarantined_lanes",
                    last.get("quarantined_lanes", 0))
        m.set_gauge("fleet_heals_total", last.get("heals_total", 0))
        dom_gate, dom = self.gate_dominance()
        m.set_gauge("fleet_gate_dominance", dom)
        m.set_gauge("fleet_pnl_spread", self.pnl_spread())
        m.set_gauge("fleet_balance_drift_max", self.balance_drift_max())
        if np.isfinite(last["max_drawdown_max"]):
            m.set_gauge("fleet_max_drawdown", last["max_drawdown_max"])
        mix = self.gate_mix()
        total = sum(mix.values()) or 1
        for name in bin_names():
            # EVERY bin exported every time (0 when absent): a gate that
            # leaves the window must not freeze its last nonzero share
            # in Prometheus — the series set is bounded by the vocabulary
            m.set_gauge("fleet_gate_share", mix.get(name, 0) / total,
                        gate=name)
        for label in QUANTILE_LABELS:
            v = last["pnl"].get(label)
            if v is not None and np.isfinite(v):
                m.set_gauge("fleet_pnl_quantile", v, q=label)
            v = last["balance"].get(label)
            if v is not None and np.isfinite(v):
                m.set_gauge("fleet_balance_quantile", v, q=label)
        for extreme, rows in (("best", last["best"]),
                              ("worst", last["worst"])):
            for rank, row in enumerate(rows):
                m.set_gauge("fleet_lane_pnl", row["pnl"],
                            extreme=extreme, rank=rank)
                m.set_gauge("fleet_lane_id", row["lane"],
                            extreme=extreme, rank=rank)
            # a shrunk fleet must not leave the old fleet's tail ranks
            # frozen: ranks beyond the current table read as empty
            # (lane −1, pnl 0) up to the high-water rank ever exported
            hwm = self._rank_hwm.get(extreme, 0)
            for rank in range(len(rows), hwm):
                m.set_gauge("fleet_lane_pnl", 0.0,
                            extreme=extreme, rank=rank)
                m.set_gauge("fleet_lane_id", -1,
                            extreme=extreme, rank=rank)
            self._rank_hwm[extreme] = max(hwm, len(rows))

    def alert_state(self) -> dict:
        """Inputs for the in-process FleetGateDominance /
        FleetPnLDispersionHigh / FleetLaneStarved / FleetBalanceDrift
        rules (utils/alerts.py default_rules) — thresholds ride along so
        the rules evaluate THIS scope's configuration, not a second
        hardcoded constant (the saturation/loop-lag pattern)."""
        gate, dominance = self.gate_dominance()
        return {
            "fleet_gate_dominance": dominance,
            "fleet_dominant_gate": gate,
            "fleet_gate_dominance_threshold": self.gate_dominance_threshold,
            "fleet_pnl_spread": self.pnl_spread(),
            "fleet_pnl_spread_budget": self.pnl_spread_budget,
            "fleet_starved_lanes": self.starved_lanes(),
            "fleet_balance_drift": self.balance_drift_max(),
            "fleet_balance_drift_budget": self.balance_drift_budget,
            "fleet_quarantined_lanes": int(
                self.last.get("quarantined_lanes", 0)),
            "fleet_heals_total": int(self.last.get("heals_total", 0)),
        }

    def status(self) -> dict:
        """The `fleet` block on /state.json (and `cli fleet`'s source):
        rank tables, gate mix, dispersion, starvation and drift — all
        O(gates + quantiles + K) JSON.  The sampled-lane list is CAPPED
        (the full sample is O(rate × N) — embedding it would break the
        bound this block promises); `sampled_lane_count` carries the
        true size and `FleetScope.sample_lanes()` the full list."""
        gate, dominance = self.gate_dominance()
        sampled = self.sample_lanes(self.tenants)
        return {
            "decides": self.decides,
            "tenants": self.tenants,
            "sample_rate": self.sample_rate,
            "sampled_lanes": sampled[:32],
            "sampled_lane_count": len(sampled),
            "gate_mix": self.gate_mix(),
            "dominant_gate": gate,
            "gate_dominance": round(dominance, 4),
            "pnl_spread": round(self.pnl_spread(), 6),
            "starved_lanes": self.starved_lanes(),
            "balance_drift_max": round(self.balance_drift_max(), 8),
            **{k: v for k, v in self.last.items()},
        }


# -- module-level hot-path API (single-check disabled path) ------------------

def configure(fs: "FleetScope | None") -> "FleetScope | None":
    """Install ``fs`` as the process-wide active fleet observatory
    (``None`` disables — the tenant engine's next dispatch drops the
    fleet block, a declared-cold recompile)."""
    global _ACTIVE
    _ACTIVE = fs
    return fs


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> "FleetScope | None":
    return _ACTIVE


@contextlib.contextmanager
def use(fs: "FleetScope | None"):
    """Scoped activation (tests / load harness): restores the previous
    instance on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = fs
    try:
        yield fs
    finally:
        _ACTIVE = prev
