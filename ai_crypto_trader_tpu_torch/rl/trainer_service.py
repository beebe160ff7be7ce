"""Continuous PBT training service: the fleet that never stops training.

Port of `ai_crypto_trader_tpu/rl/trainer_service.py`.  A cadence service
(``await run_once()`` each tick) around `rl.population.train_pbt`:

  * **one generation a tick** — `train_pbt(generations=1, init_pop=,
    start_generation=)` with the absolute generation counter; the fleet
    goes on drawing from its own provider (`rl.draws`), so G ticks of one
    generation are one `train_pbt(generations=G)` call, bit for bit;
  * **crash-safe lineage** — every ``checkpoint_every`` generations the
    whole fleet (parameters, targets, Adam moments, replay rings, env
    states, ε, learn counters, hypers, quarantine bits, cooldowns) and the
    three draw streams' generator states land in a
    `utils.journal.SnapshotJournal` as `pack_array` records (a CRC per
    array, a CRC per line, compaction bounding the file).  The tensors
    reach the host in ONE copy of their bytes (`ops.tick_engine.
    stage_bytes`, read through `rl.population.host_read`).  A run killed
    mid-generation resumes from the newest intact checkpoint and gives the
    history and fleet of a run that never died, bit for bit: the
    generator states make the draws continue where they stopped (the JAX
    package gets this from its key being a function of the absolute
    generation);
  * **winner flow** — each checkpoint's (or each ``adopt_every``-th)
    generation's best healthy member goes through `adopt_winner`'s
    scorecard gate; the verdict is journaled beside the checkpoints and
    recorded on the scorecard's adoption trail;
  * **recalibration with last-good fallback** — every
    ``recalibrate_every`` generations the order-flow `FlowParams` are
    re-fitted from fresh depth records (`sim.calibrate.fit_flow_params`);
    an empty, poisoned or corrupt window keeps the last-good parameters
    and counts a failure, and the swap is shape-checked
    (`rl.env.assert_transfer_compatible`).

The payload's layout is the port's: its arrays are the port's fleet
tensors (int64 indices where the JAX package holds int32) and it carries
``draw_states`` (the three streams' generator states) where the JAX
package's arrays carry PRNG keys, so each package refuses the other's
checkpoint (`convert.pop_state_from_jax` carries a JAX fleet across).  The
journal format itself is shared.

Entry points take ``device=None`` — the CUDA card, ``RuntimeError``
without one — or ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, upload
from ai_crypto_trader_tpu_torch.models.train_loop import AdamState
from ai_crypto_trader_tpu_torch.ops.tick_engine import stage_bytes
from ai_crypto_trader_tpu_torch.rl import population
from ai_crypto_trader_tpu_torch.rl.dqn import DQNConfig, DQNState, Hypers, Replay, tensor_leaves
from ai_crypto_trader_tpu_torch.rl.draws import GeneratorDraws
from ai_crypto_trader_tpu_torch.rl.env import EnvState
from ai_crypto_trader_tpu_torch.rl.population import (
    PBTConfig, PopState, adopt_winner, pbt_env_params, pop_init, train_pbt)
from ai_crypto_trader_tpu_torch.utils.journal import (
    SnapshotJournal, load_snapshot, pack_array, replay, unpack_array)

#: WAL record kind of trainer checkpoints (`load_snapshot(kind=...)`)
PBT_CHECKPOINT_KIND = "pbt_lineage"

#: checkpoint payload format version
CHECKPOINT_FORMAT = 1


def _cfg_identity(cfg: DQNConfig) -> dict:
    """The DQNConfig fields that shape the training-state arrays (hypers
    are state, not identity)."""
    return {"state_size": int(cfg.state_size),
            "num_envs": int(cfg.num_envs),
            "rollout_len": int(cfg.rollout_len),
            "hidden": [int(h) for h in cfg.hidden],
            "n_actions": int(cfg.n_actions),
            "replay_capacity": int(cfg.replay_capacity),
            "batch_size": int(cfg.batch_size)}


def pop_leaves(pop: PopState) -> dict:
    """Every tensor of the fleet by a dotted name, in the checkpoint's
    order."""
    out = dict(tensor_leaves(pop.members))
    out.update({f"hypers.{k}": v for k, v in pop.hypers._asdict().items()})
    out.update(quarantined=pop.quarantined, cooldown=pop.cooldown)
    return out


def pop_from_leaves(t: dict, draws) -> PopState:
    """Inverse of `pop_leaves`: the fleet from its named tensors, drawing
    from ``draws``."""
    def group(prefix):
        return {k[len(prefix):]: v for k, v in t.items() if k.startswith(prefix)}

    members = DQNState(
        params=group("params."), target_params=group("target_params."),
        opt_state=AdamState(t["opt_state.count"], group("opt_state.mu."),
                            group("opt_state.nu."), {}),
        replay=Replay(**group("replay.")), env_states=EnvState(**group("env_states.")),
        obs=t["obs"], epsilon=t["epsilon"], learn_steps=t["learn_steps"], draws=draws)
    return PopState(members=members, hypers=Hypers(**group("hypers.")),
                    quarantined=t["quarantined"], cooldown=t["cooldown"])


def checkpoint_payload(pop: PopState, *, generation: int, cfg: DQNConfig,
                       pcfg: PBTConfig, seed: int | None = None,
                       history: list | None = None, adoptions: list | None = None,
                       recalibration: dict | None = None, flow=None) -> dict:
    """The whole fleet as one journal-ready snapshot payload: every tensor
    of the fleet (and the flow's fields) in ONE device→host copy through
    `rl.population.host_read`, each as a `pack_array` record (raw bytes,
    dtype, shape, CRC), and the provider's three generator states under
    ``draw_states``.  The provider must be a `GeneratorDraws`."""
    draws = pop.members.draws
    if not isinstance(draws, GeneratorDraws):
        raise TypeError(f"a checkpoint carries generator states; the fleet draws from a "
                        f"{type(draws).__name__}")
    leaves = pop_leaves(pop)
    staged = dict(leaves)
    if flow is not None:
        staged.update({f"flow.{k}": v for k, v in flow._asdict().items()})
    host = population.host_read(stage_bytes(staged))
    payload = {
        "format": CHECKPOINT_FORMAT,
        "generation": int(generation),
        "population": int(pcfg.population),
        "seed": None if seed is None else int(seed),
        "cfg": _cfg_identity(cfg),
        "arrays": [pack_array(host[name]) for name in leaves],
        "draw_states": {k: pack_array(v.numpy()) for k, v in draws.get_state().items()},
        "history": list(history or []),
        "adoptions": list(adoptions or []),
        "recalibration": recalibration,
    }
    if flow is not None:
        payload["flow"] = {k: float(host[f"flow.{k}"]) for k in flow._fields}
    return payload


def restore_checkpoint(payload: dict, cfg: DQNConfig, pcfg: PBTConfig,
                       env_params) -> PopState:
    """The fleet, on ``env_params``' device, from a checkpoint payload, its
    provider continuing the saved draw streams.  Refuses a wrong format, a
    payload without generator states (a JAX package checkpoint: convert
    it with `convert.pop_state_from_jax`), a population or config drift, a
    leaf-count drift, and a per-leaf shape or dtype drift; a CRC mismatch
    raises from `unpack_array` before any of that is built."""
    if int(payload.get("format", -1)) != CHECKPOINT_FORMAT:
        raise ValueError(f"checkpoint format {payload.get('format')!r} != "
                         f"{CHECKPOINT_FORMAT} — refusing to guess a layout")
    if "draw_states" not in payload:
        raise ValueError("checkpoint carries no generator states (a JAX package "
                         "checkpoint carries PRNG keys): carry it across with "
                         "convert.pop_state_from_jax")
    saved_p = int(payload.get("population", -1))
    if saved_p != int(pcfg.population):
        raise ValueError(
            f"checkpoint population {saved_p} != configured population "
            f"{pcfg.population}: refusing to load a drifted fleet "
            f"(resume with population={saved_p} or start fresh)")
    saved_cfg = payload.get("cfg") or {}
    want_cfg = _cfg_identity(cfg)
    if saved_cfg != want_cfg:
        drift = {k: (saved_cfg.get(k), want_cfg[k]) for k in want_cfg
                 if saved_cfg.get(k) != want_cfg[k]}
        raise ValueError(f"checkpoint training-config drift {drift} (saved, configured): "
                         f"the snapshot arrays would not fit this fleet")
    arrays = [unpack_array(a) for a in payload["arrays"]]            # CRC per array
    states = {k: torch.from_numpy(unpack_array(v)) for k, v in payload["draw_states"].items()}
    dev = env_params.close.device
    template = pop_leaves(pop_init(torch.Generator(dev).manual_seed(0), env_params, cfg, pcfg))
    if len(arrays) != len(template):
        raise ValueError(f"checkpoint carries {len(arrays)} arrays, fleet needs "
                         f"{len(template)}: state-layout drift")
    for i, (got, (name, want)) in enumerate(zip(arrays, template.items())):
        want_dtype = torch.empty((), dtype=want.dtype).numpy().dtype
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want_dtype:
            raise ValueError(f"checkpoint array {i} ({name}) is {got.shape}/{got.dtype}, "
                             f"fleet needs {tuple(want.shape)}/{want_dtype}: state-shape drift")
    try:
        draws = GeneratorDraws.from_state(states, dev)
    except (KeyError, RuntimeError) as exc:
        raise ValueError(f"checkpoint generator states do not fit a {dev.type} "
                         f"generator: {exc}") from None
    tensors = {name: upload(a, dev) for name, a in zip(template, arrays)}
    return pop_from_leaves(tensors, draws)


def load_checkpoint(path: str) -> tuple[dict | None, dict]:
    """Newest intact trainer checkpoint from ``path`` (torn-tail tolerant:
    a kill mid-append falls back to the previous record).  Returns
    ``(payload | None, replay stats)``."""
    return load_snapshot(path, kind=PBT_CHECKPOINT_KIND)


def _depth_records_from_journal(path: str) -> list:
    """The intact ``depth`` records of a depth-capture journal (torn tails
    and corrupt lines skipped, as `utils.journal.replay` does)."""
    records, _stats = replay(path)
    return [r["data"] for r in records if r.get("kind") == "depth"]


@dataclass
class PBTTrainerService:
    """The continuously training fleet as a cadence service: each eligible
    tick runs ONE PBT generation, then the durability, adoption and
    recalibration rim around it (all host-side, between the generation's
    device work).  ``device=None`` is the CUDA card."""

    cfg: DQNConfig
    pcfg: PBTConfig
    env_params: object = None          # EnvParams; built lazily when None
    seed: int = 0
    partitioner: object = None
    interval_s: float = 0.0            # 0 = one generation per tick
    max_generations: int | None = None
    # durability
    checkpoint_path: str | None = None
    checkpoint_every: int = 1
    compact_every: int = 8
    # adoption
    registry: object = None
    scorecard: object = None
    adopt_every: int = 1
    # recalibration
    depth_source: object = None        # DepthCapture | callable | journal path
    recalibrate_every: int = 0         # generations between re-fits; 0 = off
    calibration_symbol: str | None = None
    env_builder: object = None         # callable(flow) -> EnvParams
    env_kwargs: dict = field(default_factory=dict)
    # plumbing
    now_fn: object = time.time
    metrics: object = None
    name: str = "trainer"
    stall_after_s: float | None = None  # default: max(3·interval, 60 s)
    device: object = None

    # -- mutable service state ----------------------------------------------
    generation: int = 0
    history: list = field(default_factory=list)
    adoptions: list = field(default_factory=list)
    flow: object = None                # last-good FlowParams
    last_recalibration: dict | None = None
    recalibration_failures: int = 0
    quarantine_trips: int = 0
    member_heals: int = 0
    resumed_at: int | None = None      # provenance: generation resumed from
    last_generation_at: float | None = None
    last_checkpoint_at: float | None = None
    last_checkpoint_generation: int | None = None
    _pop: object = None
    _journal: object = None
    _last: float = -1e18

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- lifecycle -----------------------------------------------------------
    def _build_env(self, flow):
        if self.env_builder is not None:
            out = self.env_builder(flow)
        else:
            kw = dict(self.env_kwargs)
            if self.env_params is not None:
                # a re-fit regenerates values into the live env's shapes
                shape = self.env_params.close.shape
                if len(shape) == 2:
                    kw.setdefault("num_scenarios", int(shape[0]))
                kw.setdefault("steps", int(shape[-1]))
                kw.setdefault("episode_len", int(self.env_params.episode_len))
            out = pbt_env_params(torch.Generator(self.device).manual_seed(self.seed),
                                 flow=flow, device=self.device, **kw)
        return out[0] if isinstance(out, tuple) else out

    def _ensure_journal(self):
        if self._journal is None and self.checkpoint_path is not None:
            self._journal = SnapshotJournal(self.checkpoint_path,
                                            compact_every=self.compact_every,
                                            now_fn=self.now_fn, kind=PBT_CHECKPOINT_KIND)
        return self._journal

    def _bootstrap(self) -> dict:
        """First run: resume from the newest intact checkpoint when one
        exists (its last-good flow included), else a fresh fleet."""
        payload = None
        if self.checkpoint_path is not None and os.path.exists(self.checkpoint_path):
            payload, _stats = load_checkpoint(self.checkpoint_path)
        if payload is None:
            if self.env_params is None:
                self.env_params = self._build_env(self.flow)
            self._pop = pop_init(torch.Generator(self.device).manual_seed(self.seed),
                                 self.env_params, self.cfg, self.pcfg)
            return {"resumed": False, "generation": self.generation}
        from ai_crypto_trader_tpu_torch.sim.lob import flow_params

        if payload.get("flow"):
            self.flow = flow_params(**payload["flow"], device=self.device)
        if self.env_params is None:
            self.env_params = self._build_env(self.flow)
        self._pop = restore_checkpoint(payload, self.cfg, self.pcfg, self.env_params)
        self.generation = int(payload["generation"])
        self.history = list(payload.get("history") or [])
        self.adoptions = list(payload.get("adoptions") or [])
        self.last_recalibration = payload.get("recalibration")
        self.resumed_at = self.generation
        self.last_checkpoint_generation = self.generation
        return {"resumed": True, "generation": self.generation}

    # -- the rim -------------------------------------------------------------
    def _depth_records(self) -> list:
        src = self.depth_source
        if src is None:
            raise ValueError("no depth source configured")
        if callable(src):
            return list(src())
        if isinstance(src, str):
            return _depth_records_from_journal(src)
        window = getattr(src, "calibration_window", None)
        if window is not None:
            return window(symbol=self.calibration_symbol)
        return list(src.records())

    def _recalibrate(self) -> dict:
        """Re-fit FlowParams from the freshest capture window; any failure
        (empty window, poisoned records, fit error, shape drift) keeps the
        last-good parameters and counts."""
        from ai_crypto_trader_tpu_torch.rl.env import assert_transfer_compatible
        from ai_crypto_trader_tpu_torch.sim import calibrate

        now = self.now_fn()
        try:
            records = self._depth_records()
            calibrate.validate_depth_records(records, symbol=self.calibration_symbol)
            flow, report = calibrate.fit_flow_params(records, symbol=self.calibration_symbol,
                                                     device=self.device)
            new_env = self._build_env(flow)
            assert_transfer_compatible(self.env_params, new_env)
        except Exception as exc:        # noqa: BLE001 — last-good fallback
            self.recalibration_failures += 1
            if self.metrics is not None:
                self.metrics.inc("pbt_recalibration_failures_total")
            self.last_recalibration = {"at": now, "generation": self.generation, "ok": False,
                                       "reason": f"{type(exc).__name__}: {exc}"}
            return self.last_recalibration
        self.flow = flow
        self.env_params = new_env
        if self.metrics is not None:
            self.metrics.set_gauge("pbt_last_recalibration_timestamp", now)
        self.last_recalibration = {
            "at": now, "generation": self.generation, "ok": True,
            "records": int(np.asarray(report.get("frames", 0)).item())
            if isinstance(report, dict) else None}
        return self.last_recalibration

    def checkpoint(self) -> int | None:
        """Durably snapshot the fleet now (also the ``checkpoint_every``
        cadence's target).  Returns the WAL sequence number."""
        journal = self._ensure_journal()
        if journal is None or self._pop is None:
            return None
        seq = journal.write(checkpoint_payload(
            self._pop, generation=self.generation, cfg=self.cfg, pcfg=self.pcfg,
            seed=self.seed, history=self.history, adoptions=self.adoptions,
            recalibration=self.last_recalibration, flow=self.flow))
        self.last_checkpoint_at = self.now_fn()
        self.last_checkpoint_generation = self.generation
        return seq

    def _adopt(self, result) -> dict | None:
        if self.registry is None:
            return None
        verdict = adopt_winner(result, self.registry, self.scorecard)
        rec = dict(verdict, generation=self.generation)
        self.adoptions.append(rec)
        if self.scorecard is not None:
            self.scorecard.record_adoption(rec)
        journal = self._ensure_journal()
        if journal is not None:
            # the verdict rides the checkpoints' WAL
            journal.journal.append("pbt_adoption", rec, flush=True)
        return rec

    # -- the service tick ----------------------------------------------------
    async def run_once(self) -> dict:
        now = self.now_fn()
        if now - self._last < self.interval_s:
            return {"ran": False}
        if self.max_generations is not None and self.generation >= self.max_generations:
            return {"ran": False, "reason": "complete"}
        self._last = now
        out: dict = {"ran": True}
        if self._pop is None:
            out["bootstrap"] = self._bootstrap()
        if self.recalibrate_every and self.depth_source is not None \
                and self.generation > 0 and self.generation % self.recalibrate_every == 0:
            out["recalibration"] = self._recalibrate()

        prev_trips, prev_heals = self.quarantine_trips, self.member_heals
        res = train_pbt(None, self.env_params, self.cfg, self.pcfg._replace(generations=1),
                        partitioner=self.partitioner, init_pop=self._pop,
                        start_generation=self.generation)
        self._pop = res.state
        row = res.history[0]
        self.history.append(row)
        self.generation += 1
        self.last_generation_at = self.now_fn()
        self.quarantine_trips += row["n_tripped"]
        self.member_heals += row["n_healed"]
        out["generation"] = row["generation"]
        out["best_fitness"] = row["best_fitness"]
        out["n_quarantined"] = row["n_quarantined"]

        if self.checkpoint_every and self.generation % self.checkpoint_every == 0:
            # adopt before the checkpoint, so its verdict trail holds this winner
            verdict = self._adopt(res)
            if verdict is not None:
                out["adoption"] = verdict
            out["checkpoint_seq"] = self.checkpoint()
        elif self.adopt_every and self.generation % self.adopt_every == 0:
            verdict = self._adopt(res)
            if verdict is not None:
                out["adoption"] = verdict
        self._export_gauges(row, trips=self.quarantine_trips - prev_trips,
                            heals=self.member_heals - prev_heals)
        return out

    # -- observability -------------------------------------------------------
    def _export_gauges(self, row: dict, trips: int = 0, heals: int = 0):
        m = self.metrics
        if m is None:
            return
        now = self.now_fn()
        m.set_gauge("pbt_generation", float(self.generation))
        m.set_gauge("pbt_generation_interval_seconds", float(max(self.interval_s, 1e-9)))
        m.set_gauge("pbt_last_generation_timestamp", float(now))
        m.set_gauge("pbt_quarantined_members", float(row["n_quarantined"]))
        if np.isfinite(row["best_fitness"]):
            m.set_gauge("pbt_best_fitness", float(row["best_fitness"]))
            m.set_gauge("pbt_mean_fitness", float(row["mean_fitness"]))
        if self.last_checkpoint_at is not None:
            m.set_gauge("pbt_checkpoint_age_s", float(now - self.last_checkpoint_at))
        m.inc("pbt_generations_total")
        if trips:
            m.inc("pbt_quarantine_trips_total", trips)
        if heals:
            m.inc("pbt_member_heals_total", heals)

    def _stall_threshold(self) -> float:
        if self.stall_after_s is not None:
            return float(self.stall_after_s)
        return max(3.0 * float(self.interval_s), 60.0)

    def alert_state(self) -> dict:
        """Inputs of the `TrainingFleetStalled` / `MemberQuarantined`
        rules."""
        out = {"pbt_quarantined_members": int(self.history[-1]["n_quarantined"])
               if self.history else 0,
               "pbt_stall_after_s": self._stall_threshold()}
        if self.last_generation_at is not None:
            out["pbt_generation_age_s"] = self.now_fn() - self.last_generation_at
        return out

    def status(self) -> dict:
        """The ``training`` status block: where the fleet is, who is
        quarantined, how stale the newest checkpoint and calibration are."""
        now = self.now_fn()
        last = self.history[-1] if self.history else None
        out = {
            "generation": self.generation,
            "population": int(self.pcfg.population),
            "best_fitness": last["best_fitness"] if last else None,
            "mean_fitness": last["mean_fitness"] if last else None,
            "quarantined_members": last["n_quarantined"] if last else 0,
            "quarantine_trips": self.quarantine_trips,
            "member_heals": self.member_heals,
            "recalibration_failures": self.recalibration_failures,
            "last_recalibration": self.last_recalibration,
            "resumed_at": self.resumed_at,
            "adoptions": self.adoptions[-4:],
        }
        if self.last_generation_at is not None:
            out["generation_age_s"] = round(now - self.last_generation_at, 3)
        if self.last_checkpoint_at is not None:
            out["checkpoint_age_s"] = round(now - self.last_checkpoint_at, 3)
            out["checkpoint_generation"] = self.last_checkpoint_generation
            out["checkpoint_path"] = self.checkpoint_path
        return out

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None
