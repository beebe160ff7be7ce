"""Scenario-spec layer: named stress presets → dense shock schedules.

The port's copy of `ai_crypto_trader_tpu/sim/scenarios.py`, NumPy only; its
code is byte for byte the JAX package's (tests/test_torch_risk.py checks
it), so both packages draw the same schedules for a (preset, seed).

A stress scenario is data: every market pathology (flash crashes,
liquidity holes, spread blowouts, vol regime shifts, exchange outage or
latency windows) compiles to six per-candle channels shaped [B, T], one
row per scenario, one column per candle.  Event timing and magnitude are
drawn per row from seeded ranges, so a 4096-row schedule is 4096
different flash crashes.  The Monte-Carlo engine's stress mode reads two
of the channels through `mc_schedule` (`mc.engine.run_simulation(stress=
...)`).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np


class ShockSchedule(NamedTuple):
    """Per-candle shock channels, all float32 [B, T].

    logret_shift    additive log-return injected into the path generator
                    (crash = a burst of negative shift, then recovery)
    vol_mult        multiplies the path's instantaneous volatility
    liquidity_mult  multiplies the per-candle base-unit fill cap (a
                    liquidity hole drives it toward 0 → partial fills)
    spread          full relative bid-ask spread: market BUYs pay
                    close·(1+spread/2), SELLs receive close·(1−spread/2)
    halt            1.0 = venue unreachable: no placements, no cancels,
                    no matching this candle (exchange outage)
    latency         1.0 = market orders placed this candle defer and fill
                    at the NEXT candle's open (stale-quote execution)
    """

    logret_shift: np.ndarray
    vol_mult: np.ndarray
    liquidity_mult: np.ndarray
    spread: np.ndarray
    halt: np.ndarray
    latency: np.ndarray

    @property
    def num_scenarios(self) -> int:
        return int(self.logret_shift.shape[0])

    @property
    def steps(self) -> int:
        return int(self.logret_shift.shape[-1])


@dataclass(frozen=True)
class Shock:
    """One randomized stress event.

    ``kind``       crash | vol | liquidity | spread | halt | latency
    ``start``      (lo, hi) window start as a fraction of T
    ``length``     (lo, hi) window length in candles
    ``magnitude``  (lo, hi); meaning is kind-specific — crash: total log
                   drop; vol: multiplier; liquidity: fraction of depth
                   REMOVED; spread: full relative spread; halt/latency:
                   unused
    ``recovery``   crash only: fraction of the drop retraced afterwards
    ``recovery_length``  crash only: (lo, hi) candles the retrace takes
    """

    kind: str
    start: tuple = (0.2, 0.8)
    length: tuple = (1, 10)
    magnitude: tuple = (0.0, 0.0)
    recovery: float = 0.5
    recovery_length: tuple = (5, 30)


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    shocks: tuple = ()


PRESETS: dict[str, ScenarioSpec] = {
    "calm": ScenarioSpec("calm"),
    "flash_crash": ScenarioSpec("flash_crash", (
        Shock("crash", start=(0.2, 0.8), length=(1, 3),
              magnitude=(0.08, 0.35)),
    )),
    "liquidity_hole": ScenarioSpec("liquidity_hole", (
        Shock("liquidity", start=(0.2, 0.8), length=(10, 60),
              magnitude=(0.9, 0.999)),
    )),
    "spread_blowout": ScenarioSpec("spread_blowout", (
        Shock("spread", start=(0.2, 0.8), length=(5, 40),
              magnitude=(0.002, 0.02)),
    )),
    "exchange_outage": ScenarioSpec("exchange_outage", (
        Shock("halt", start=(0.2, 0.8), length=(3, 20)),
    )),
    "latency_storm": ScenarioSpec("latency_storm", (
        Shock("latency", start=(0.1, 0.7), length=(5, 50)),
    )),
    "vol_regime_shift": ScenarioSpec("vol_regime_shift", (
        Shock("vol", start=(0.1, 0.6), length=(50, 200),
              magnitude=(2.0, 5.0)),
    )),
    # Everything at once: the crash tears through a thin, wide, flaky book.
    "black_swan": ScenarioSpec("black_swan", (
        Shock("crash", start=(0.3, 0.6), length=(1, 3),
              magnitude=(0.15, 0.40), recovery=0.3),
        Shock("liquidity", start=(0.3, 0.6), length=(20, 80),
              magnitude=(0.95, 0.999)),
        Shock("spread", start=(0.3, 0.6), length=(20, 80),
              magnitude=(0.005, 0.03)),
        Shock("halt", start=(0.3, 0.6), length=(2, 8)),
    )),
}


def preset_names() -> list[str]:
    return sorted(PRESETS)


def preset(name: str) -> ScenarioSpec:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown scenario preset {name!r}; "
                       f"known: {preset_names()}") from None


def _empty(B: int, T: int) -> ShockSchedule:
    f = lambda v: np.full((B, T), v, np.float32)  # noqa: E731
    return ShockSchedule(logret_shift=f(0.0), vol_mult=f(1.0),
                         liquidity_mult=f(1.0), spread=f(0.0),
                         halt=f(0.0), latency=f(0.0))


def _apply_shock(sched: ShockSchedule, b: int, T: int, shock: Shock,
                 rng: np.random.Generator) -> None:
    lo, hi = shock.start
    t0 = int(rng.uniform(lo, hi) * T)
    ln = int(rng.integers(shock.length[0], shock.length[1] + 1))
    t1 = min(t0 + ln, T)
    if t1 <= t0:
        return
    mag = float(rng.uniform(*shock.magnitude)) if shock.magnitude[1] else 0.0
    if shock.kind == "crash":
        sched.logret_shift[b, t0:t1] -= mag / (t1 - t0)
        rec = int(rng.integers(shock.recovery_length[0],
                               shock.recovery_length[1] + 1))
        r0, r1 = t1, min(t1 + rec, T)
        if r1 > r0:
            sched.logret_shift[b, r0:r1] += mag * shock.recovery / (r1 - r0)
        sched.vol_mult[b, t0:r1 if r1 > r0 else t1] *= 3.0
    elif shock.kind == "vol":
        sched.vol_mult[b, t0:t1] *= mag
    elif shock.kind == "liquidity":
        sched.liquidity_mult[b, t0:t1] *= (1.0 - mag)
    elif shock.kind == "spread":
        sched.spread[b, t0:t1] = np.maximum(sched.spread[b, t0:t1], mag)
    elif shock.kind == "halt":
        sched.halt[b, t0:t1] = 1.0
    elif shock.kind == "latency":
        sched.latency[b, t0:t1] = 1.0
    else:
        raise ValueError(f"unknown shock kind {shock.kind!r}")


def compile_schedules(spec: ScenarioSpec | str, num_scenarios: int,
                      steps: int, seed: int = 0) -> ShockSchedule:
    """Compile ONE preset into [num_scenarios, steps] schedule arrays,
    each row an independently randomized instance of the spec's shocks."""
    if isinstance(spec, str):
        spec = preset(spec)
    # crc32, not hash(): str hashing is salted per process, and schedules
    # must be reproducible across runs for the same (spec, seed)
    rng = np.random.default_rng((seed, zlib.crc32(spec.name.encode())))
    sched = _empty(num_scenarios, steps)
    for b in range(num_scenarios):
        for shock in spec.shocks:
            _apply_shock(sched, b, steps, shock, rng)
    return sched


def mixed_schedules(names: Sequence[str] | None, num_scenarios: int,
                    steps: int, seed: int = 0):
    """Round-robin a list of presets across the scenario batch (default:
    every preset).  Returns (ShockSchedule, labels) — ``labels[b]`` names
    the preset scenario row b was drawn from."""
    names = list(names) if names else preset_names()
    per = {n: compile_schedules(n, (num_scenarios + len(names) - 1)
                                // len(names), steps, seed=seed)
           for n in names}
    labels = [names[b % len(names)] for b in range(num_scenarios)]
    counters = {n: 0 for n in names}
    rows = []
    for name in labels:
        rows.append(counters[name])
        counters[name] += 1
    picked = [per[name] for name in labels]
    sched = ShockSchedule(*(
        np.stack([getattr(p, field)[r] for p, r in zip(picked, rows)])
        for field in ShockSchedule._fields))
    return sched, labels


def mc_schedule(stress: ScenarioSpec | str, num_sims: int, steps: int,
                seed: int = 0):
    """The two channels Monte-Carlo stress mode consumes
    (`mc/engine.run_simulation(stress=...)`): (logret_shift, vol_mult),
    both float32 [num_sims, steps]."""
    sched = compile_schedules(stress, num_sims, steps, seed=seed)
    return sched.logret_shift, sched.vol_mult
