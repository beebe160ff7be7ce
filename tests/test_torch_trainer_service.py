"""The port's continuous PBT trainer service against the JAX package's.

Tiny everywhere (4 LOB scenarios × 64 steps, 8-member fleets of 8-unit
nets, on the CPU): the contracts are structural.

  * the checkpoint codec: a JSON round trip restores the whole fleet and
    its draw streams bit for bit, in one host read; format, population,
    config, leaf-count, leaf-shape/dtype and bit-rot drift refuse, and so
    does a JAX package checkpoint (PRNG keys, not generator states) — which
    `convert.pop_state_from_jax` carries across instead;
  * resume parity: a service killed after a torn checkpoint append resumes
    from the newest intact record and gives the history and fleet of an
    unbroken run bit for bit; G ticks of one generation are one
    `train_pbt(generations=G)` call; one read a generation;
  * `adopt_winner` and the scorecard's gate give the JAX package's verdict
    and registry entry on the same fitness;
  * the service's fields, status and alert inputs carry the JAX package's
    keys; recalibration falls back to the last good flow on a poisoned or
    corrupt window;
  * `cli rl --checkpoint / --resume / --registry`.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu_torch import convert
from ai_crypto_trader_tpu_torch.obs import Scorecard
from ai_crypto_trader_tpu_torch.rl import (
    DQNConfig, PBTConfig, PBTResult, PBTTrainerService, adopt_winner, checkpoint_payload,
    load_checkpoint, obs_size, pbt_env_params, pop_init, restore_checkpoint, train_pbt)
from ai_crypto_trader_tpu_torch.rl import population
from ai_crypto_trader_tpu_torch.rl.dqn import Hypers
from ai_crypto_trader_tpu_torch.rl.trainer_service import pop_leaves
from ai_crypto_trader_tpu_torch.strategy import ModelRegistry
from ai_crypto_trader_tpu_torch.utils.journal import SnapshotJournal, WriteAheadJournal

PCFG = PBTConfig(population=8, generations=3, iters_per_generation=2, eval_steps=4)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def env():
    return pbt_env_params(gen(7), num_scenarios=4, steps=64, episode_len=32, device="cpu")[0]


@pytest.fixture(scope="module")
def cfg(env):
    return DQNConfig(state_size=obs_size(env), num_envs=2, rollout_len=2, hidden=(8,),
                     replay_capacity=64, batch_size=8, learn_steps_per_iter=1,
                     target_sync_every=3)


def same_fleet(a, b):
    la, lb = pop_leaves(a), pop_leaves(b)
    assert la.keys() == lb.keys()
    return all(la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]) for k in la)


def same_draws(a, b):
    sa, sb = a.members.draws.get_state(), b.members.draws.get_state()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def _service(env, cfg, **kw):
    kw.setdefault("now_fn", lambda: 1000.0)
    return PBTTrainerService(cfg=cfg, pcfg=PCFG._replace(generations=1), env_params=env,
                             seed=0, device="cpu", **kw)


def _tick(svc):
    return asyncio.run(svc.run_once())


def _good_records(n=6, seed=0):
    """A healthy synthetic capture window `fit_flow_params` accepts."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        recs.append({"symbol": "BTCUSDC", "kind": "snapshot", "E": 1_700_000_000_000 + i * 1000,
                     "U": i * 10, "u": i * 10 + 9,
                     "bids": [[100.0 - 0.5 * j, 2.0 + rng.uniform(0, 0.5)] for j in range(4)],
                     "asks": [[100.5 + 0.5 * j, 2.0 + rng.uniform(0, 0.5)] for j in range(4)]})
    return recs


class Metrics:
    """The metrics seam the service uses: ``inc`` and ``set_gauge``."""

    def __init__(self):
        self.counters, self.gauges = {}, {}

    def inc(self, name, value=1.0, **labels):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name, value, **labels):
        self.gauges[name] = value


# -- the checkpoint codec --------------------------------------------------------

class TestCheckpointCodec:
    def test_json_roundtrip_restores_fleet_and_draws_in_one_read(self, env, cfg, monkeypatch):
        res = train_pbt(gen(0), env, cfg, PCFG._replace(generations=1))
        reads = []
        real = population.host_read
        monkeypatch.setattr(population, "host_read", lambda rb: reads.append(1) or real(rb))
        payload = json.loads(json.dumps(checkpoint_payload(
            res.state, generation=1, cfg=cfg, pcfg=PCFG, seed=0, history=res.history)))
        assert len(reads) == 1
        pop = restore_checkpoint(payload, cfg, PCFG, env)
        assert same_fleet(pop, res.state) and same_draws(pop, res.state)
        # the restored fleet trains on as the original does
        a = train_pbt(None, env, cfg, PCFG._replace(generations=1), init_pop=pop,
                      start_generation=1)
        b = train_pbt(None, env, cfg, PCFG._replace(generations=1), init_pop=res.state,
                      start_generation=1)
        assert same_fleet(a.state, b.state) and a.history == b.history

    def test_every_drift_is_refused(self, env, cfg):
        pop = pop_init(gen(0), env, cfg, PCFG)
        payload = checkpoint_payload(pop, generation=0, cfg=cfg, pcfg=PCFG)
        cases = {
            "format": (dict(payload, format=99), PCFG, cfg, "format"),
            "population": (payload, PCFG._replace(population=4), cfg, "population"),
            "config": (payload, PCFG, cfg._replace(hidden=(16,)), "drift"),
            "leaf count": (dict(payload, arrays=payload["arrays"][:-1]), PCFG, cfg, "arrays"),
            "leaf dtype": (dict(payload, arrays=[payload["arrays"][0]] + payload["arrays"][:-1]),
                           PCFG, cfg, "shape drift"),
            "no draws": ({k: v for k, v in payload.items() if k != "draw_states"}, PCFG, cfg,
                         "generator states"),
        }
        for name, (p, pcfg, c, match) in cases.items():
            with pytest.raises(ValueError, match=match):
                restore_checkpoint(p, c, pcfg, env)
        rotten = json.loads(json.dumps(payload))
        rotten["arrays"][3]["crc"] ^= 1
        with pytest.raises(ValueError, match="crc"):
            restore_checkpoint(rotten, cfg, PCFG, env)

    def test_torn_tail_falls_back_to_the_previous_checkpoint(self, env, cfg, tmp_path):
        from ai_crypto_trader_tpu.testing import chaos

        path = str(tmp_path / "pbt.journal")
        sj = SnapshotJournal(path, kind="pbt_lineage")
        pop = pop_init(gen(0), env, cfg, PCFG)
        for g in (1, 2):
            sj.write(checkpoint_payload(pop, generation=g, cfg=cfg, pcfg=PCFG))
        sj.close()
        chaos.torn_tail(path, keep_bytes=37)
        payload, stats = load_checkpoint(path)
        assert payload["generation"] == 1 and stats["torn_tail"]

    def test_the_jax_checkpoint_is_refused_and_carried_across_by_convert(self, tmp_path):
        """Each package refuses the other's payload; `pop_state_from_jax`
        carries the JAX fleet's arrays across (keys skipped)."""
        import jax

        from ai_crypto_trader_tpu.rl import DQNConfig as JaxDQNConfig
        from ai_crypto_trader_tpu.rl import obs_size as jax_obs_size
        from ai_crypto_trader_tpu.rl import pbt_env_params as jax_env_params
        from ai_crypto_trader_tpu.rl import trainer_service as jax_svc
        from ai_crypto_trader_tpu.rl.population import PBTConfig as JaxPBTConfig
        from ai_crypto_trader_tpu.rl.population import pop_init as jax_pop_init

        jenv, _ = jax_env_params(jax.random.PRNGKey(7), num_scenarios=2, steps=64,
                                 episode_len=32)
        jcfg = JaxDQNConfig(state_size=jax_obs_size(jenv), num_envs=2, rollout_len=2,
                            hidden=(8,), replay_capacity=16, batch_size=4)
        jpcfg = JaxPBTConfig(population=4)
        jpop = jax_pop_init(jax.random.PRNGKey(0), jenv, jcfg, jpcfg)
        jpayload = json.loads(json.dumps(jax_svc.checkpoint_payload(
            jpop, generation=3, cfg=jcfg, pcfg=jpcfg)))

        penv = convert.env_params_from_numpy(jenv, device="cpu")
        pcfg_ = PBTConfig(population=4)
        cfg_ = DQNConfig(**jcfg._asdict())
        with pytest.raises(ValueError, match="generator states"):
            restore_checkpoint(jpayload, cfg_, pcfg_, penv)
        mine = checkpoint_payload(pop_init(gen(0), penv, cfg_, pcfg_), generation=3,
                                  cfg=cfg_, pcfg=pcfg_)
        with pytest.raises(ValueError, match="arrays"):
            jax_svc.restore_checkpoint(json.loads(json.dumps(mine)), jcfg, jpcfg, jenv)

        from ai_crypto_trader_tpu_torch.rl.draws import GeneratorDraws

        draws = GeneratorDraws(gen(5))
        for src in (jpayload, jpop):
            pop = convert.pop_state_from_jax(src, cfg_, pcfg_, penv, draws, device="cpu")
            got = pop_leaves(pop)
            want = convert.dqn_state_from_jax(jpop.members, draws, device="cpu")
            for k, v in pop_leaves(pop._replace(members=want)).items():
                assert torch.equal(got[k], v), k
            for f in Hypers._fields:
                np.testing.assert_array_equal(getattr(pop.hypers, f).numpy(),
                                              np.asarray(getattr(jpop.hypers, f)))
            assert pop.members.draws is draws
            # the converted fleet trains, and checkpoints as a port fleet
            train_pbt(None, penv, cfg_, pcfg_._replace(generations=1, iters_per_generation=1,
                                                        eval_steps=2), init_pop=pop)
        with pytest.raises(ValueError, match="population"):
            convert.pop_state_from_jax(jpayload, cfg_, PBTConfig(population=8), penv, draws,
                                       device="cpu")


# -- the service -------------------------------------------------------------------

class TestServiceParity:
    def test_ticks_equal_one_train_pbt_call_with_one_read_a_generation(self, env, cfg,
                                                                        monkeypatch):
        reads = []
        real = population.host_read
        monkeypatch.setattr(population, "host_read", lambda rb: reads.append(1) or real(rb))
        svc = _service(env, cfg)
        rows = [_tick(svc) for _ in range(3)]
        assert [r["generation"] for r in rows] == [0, 1, 2] and len(reads) == 3
        straight = train_pbt(gen(0), env, cfg, PCFG._replace(generations=3))
        assert same_fleet(svc._pop, straight.state) and same_draws(svc._pop, straight.state)
        assert svc.history == straight.history

    def test_killed_after_a_torn_append_resumes_bit_identical(self, env, cfg, tmp_path,
                                                              monkeypatch):
        from ai_crypto_trader_tpu.testing import chaos

        path = str(tmp_path / "pbt.journal")
        reads = []
        real = population.host_read
        monkeypatch.setattr(population, "host_read", lambda rb: reads.append(1) or real(rb))
        a = _service(env, cfg, checkpoint_path=path, checkpoint_every=1)
        _tick(a)
        _tick(a)
        assert a.generation == 2 and len(reads) == 4     # a generation's and a checkpoint's
        a.close()
        chaos.torn_tail(path, keep_bytes=37)             # the generation-2 append dies

        b = _service(env, cfg, checkpoint_path=path, checkpoint_every=1)
        out = _tick(b)                                   # trains generation 1 again
        assert out["bootstrap"] == {"resumed": True, "generation": 1}
        assert b.resumed_at == 1
        _tick(b)
        _tick(b)
        assert b.generation == 4
        straight = train_pbt(gen(0), env, cfg, PCFG._replace(generations=4))
        assert same_fleet(b._pop, straight.state) and same_draws(b._pop, straight.state)
        assert b.history == straight.history
        b.close()

    def test_cadence_and_max_generations(self, env, cfg):
        clock = {"t": 1000.0}
        svc = _service(env, cfg, interval_s=60.0, max_generations=2, now_fn=lambda: clock["t"])
        assert _tick(svc)["ran"] is True
        assert _tick(svc)["ran"] is False
        clock["t"] += 60.0
        assert _tick(svc)["ran"] is True
        clock["t"] += 60.0
        assert _tick(svc) == {"ran": False, "reason": "complete"}

    def test_fields_status_and_alert_inputs_carry_the_jax_keys(self, env, cfg):
        from ai_crypto_trader_tpu.rl import trainer_service as jax_svc
        from ai_crypto_trader_tpu.rl.dqn import DQNConfig as JaxDQNConfig
        from ai_crypto_trader_tpu.rl.population import PBTConfig as JaxPBTConfig

        mine = {f.name for f in dataclasses.fields(PBTTrainerService)}
        theirs = {f.name for f in dataclasses.fields(jax_svc.PBTTrainerService)}
        assert mine == theirs | {"device"}
        assert jax_svc.PBT_CHECKPOINT_KIND == "pbt_lineage" == \
            __import__("ai_crypto_trader_tpu_torch.rl", fromlist=["x"]).PBT_CHECKPOINT_KIND

        clock = {"t": 1000.0}
        m = Metrics()
        svc = _service(env, cfg, metrics=m, interval_s=30.0, now_fn=lambda: clock["t"])
        pop = pop_init(gen(0), env, cfg, PCFG)
        params = dict(pop.members.params)
        params["Dense_0.kernel"] = params["Dense_0.kernel"].clone()
        params["Dense_0.kernel"][5, 0, 0] = float("nan")
        svc._pop = pop._replace(members=pop.members._replace(params=params))
        _tick(svc)
        svc.last_checkpoint_at, svc.last_checkpoint_generation = 990.0, 1
        ref = jax_svc.PBTTrainerService(cfg=JaxDQNConfig(), pcfg=JaxPBTConfig(),
                                        now_fn=lambda: clock["t"], interval_s=30.0)
        ref.history = [dict(svc.history[0])]
        ref.last_generation_at, ref.last_checkpoint_at = svc.last_generation_at, 990.0
        ref.last_checkpoint_generation, ref.quarantine_trips = 1, svc.quarantine_trips
        assert svc.status().keys() == ref.status().keys()
        assert svc.alert_state() == ref.alert_state()
        status = svc.status()
        assert (status["generation"], status["population"]) == (1, 8)
        assert status["quarantined_members"] == 1 and status["quarantine_trips"] == 1
        assert svc.alert_state()["pbt_quarantined_members"] == 1
        assert {"pbt_generation", "pbt_quarantined_members", "pbt_last_generation_timestamp",
                "pbt_best_fitness"} <= set(m.gauges)
        assert m.counters["pbt_quarantine_trips_total"] == 1.0
        clock["t"] += svc._stall_threshold() + 1.0
        assert svc.alert_state()["pbt_generation_age_s"] > svc._stall_threshold()

    def test_recalibration_keeps_the_last_good_flow(self, env, cfg, tmp_path):
        from ai_crypto_trader_tpu.testing import chaos

        feed = {"recs": _good_records()}
        m = Metrics()
        svc = _service(env, cfg, depth_source=lambda: feed["recs"], recalibrate_every=2,
                       metrics=m)
        for _ in range(3):                       # re-fits at generation 2
            _tick(svc)
        assert svc.last_recalibration["ok"] is True and svc.recalibration_failures == 0
        good_flow, good_env = svc.flow, svc.env_params
        assert good_env.close.shape == env.close.shape
        feed["recs"] = chaos.poisoned_depth_records(mode="nan_spread")
        _tick(svc)
        r = _tick(svc)["recalibration"]          # generation 4: the poisoned window
        assert r["ok"] is False and "CalibrationPoisoned" in r["reason"]
        assert svc.flow is good_flow and svc.env_params is good_env
        assert m.counters["pbt_recalibration_failures_total"] == 1.0

        # a depth journal as the source: intact, then every line corrupt
        path = str(tmp_path / "depth.journal")
        j = WriteAheadJournal(path)
        for rec in _good_records(seed=1):
            j.append("depth", rec)
        j.close()
        svc.depth_source = path
        assert svc._recalibrate()["ok"] is True and svc.flow is not good_flow
        with open(path) as f:
            recs = [json.loads(ln) for ln in f.read().splitlines()]
        with open(path, "w") as f:
            f.writelines(json.dumps(dict(r, crc=r["crc"] ^ 1)) + "\n" for r in recs)
        last = svc.flow
        assert svc._recalibrate()["ok"] is False and svc.flow is last
        assert svc.recalibration_failures == 2

    def test_flow_survives_a_resume(self, env, cfg, tmp_path):
        path = str(tmp_path / "pbt.journal")
        a = _service(env, cfg, checkpoint_path=path, depth_source=_good_records,
                     recalibrate_every=1)
        _tick(a)
        _tick(a)                                  # re-fits at generation 1, checkpoints
        a.close()
        b = _service(env, cfg, checkpoint_path=path)
        _tick(b)
        assert b.flow is not None
        for k in a.flow._fields:
            assert torch.equal(getattr(a.flow, k), getattr(b.flow, k)), k


# -- adoption ------------------------------------------------------------------------

def _results(fitness, hypers):
    """The same fleet outcome as a JAX and a port `PBTResult`."""
    from ai_crypto_trader_tpu.rl.dqn import DQNConfig as JaxDQNConfig
    from ai_crypto_trader_tpu.rl.dqn import Hypers as JaxHypers
    from ai_crypto_trader_tpu.rl.population import PBTConfig as JaxPBTConfig
    from ai_crypto_trader_tpu.rl.population import PBTResult as JaxPBTResult

    P = len(fitness)
    best = int(np.argmax(fitness))
    jstate = type("S", (), {"hypers": JaxHypers(**hypers)})()
    jres = JaxPBTResult(state=jstate, fitness=fitness, best_member=best, history=[],
                        cfg=JaxDQNConfig(state_size=14), pcfg=JaxPBTConfig(population=P))
    row = {"hypers": {k: np.asarray(v).tolist() for k, v in hypers.items()}}
    pres = PBTResult(state=None, fitness=fitness, best_member=best, history=[row],
                     cfg=DQNConfig(state_size=14), pcfg=PBTConfig(population=P))
    return jres, pres


class SeqIds:
    """Version ids in sequence, the same in both registries (the verdict's
    reason names the incumbent's id)."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return f"{self.n:08d}-0000"


def test_adopt_winner_gives_the_jax_verdict_on_the_same_fitness(tmp_path, monkeypatch):
    from ai_crypto_trader_tpu.obs.scorecard import Scorecard as JaxScorecard
    from ai_crypto_trader_tpu.rl.population import adopt_winner as jax_adopt
    from ai_crypto_trader_tpu.strategy import registry as jax_registry
    from ai_crypto_trader_tpu.strategy.registry import ModelRegistry as JaxRegistry
    from ai_crypto_trader_tpu_torch.strategy import registry as port_registry

    monkeypatch.setattr(jax_registry, "uuid", SeqIds())
    monkeypatch.setattr(port_registry, "uuid", SeqIds())

    rng = np.random.default_rng(0)
    P = 6
    hypers = {"learning_rate": rng.uniform(1e-4, 1e-2, P).astype(np.float32),
              "gamma": rng.uniform(0.9, 0.99, P).astype(np.float32),
              "epsilon_decay": rng.uniform(0.99, 0.999, P).astype(np.float32),
              "epsilon_min": rng.uniform(0.01, 0.1, P).astype(np.float32),
              "target_sync_every": rng.integers(2, 100, P).astype(np.int32)}
    regs = {"jax": JaxRegistry(path=str(tmp_path / "jax.json")),
            "port": ModelRegistry(path=str(tmp_path / "port.json"))}
    cards = {"jax": JaxScorecard(now_fn=lambda: 5.0), "port": Scorecard(now_fn=lambda: 5.0)}
    adopt = {"jax": jax_adopt, "port": adopt_winner}
    # better than nothing → active; worse → shadow; better again → active
    for fit in (1.02, 0.97, 1.05):
        fitness = (rng.uniform(0.9, 0.95, P)).astype(np.float32)
        fitness[3] = fit
        jres, pres = _results(fitness, hypers)
        got = {}
        for name, res in (("jax", jres), ("port", pres)):
            v = adopt[name](res, regs[name], cards[name])
            cards[name].record_adoption(v)
            entry = regs[name].entries[v["version"]]
            got[name] = ({k: v[k] for k in ("adopted", "reason", "fitness")},
                         {k: entry[k] for k in ("kind", "payload", "metadata", "status",
                                                "performance")})
        assert got["port"] == got["jax"]
    assert [a["adopted"] for a in cards["port"].adoptions] == [True, False, True]
    assert cards["port"].status()["adoptions"] == list(cards["port"].adoptions)
    # the registry file is the JAX package's format
    assert len(JaxRegistry(path=str(tmp_path / "port.json")).entries) == 3


def test_adopt_winner_checkpoints_the_winner(env, cfg, tmp_path):
    from ai_crypto_trader_tpu_torch.utils import load_checkpoint as load_params

    res = train_pbt(gen(0), env, cfg, PCFG._replace(generations=1))
    reg = ModelRegistry(path=str(tmp_path / "reg.json"))
    out = adopt_winner(res, reg, Scorecard(), checkpoint_path=str(tmp_path / "winner"))
    assert out["adopted"] and reg.entries[out["version"]]["status"] == "active"
    params, meta = load_params(str(tmp_path / "winner"), device="cpu")
    assert meta == {"kind": "rl_policy", "fitness": out["fitness"]}
    for k, v in params.items():
        assert torch.equal(v, res.state.members.params[k][res.best_member]), k


# -- cli rl --------------------------------------------------------------------------

CLI = ["rl", "--device", "cpu", "--population", "4", "--generations", "1", "--iters", "1",
       "--envs", "2", "--rollout", "2", "--scenarios", "2", "--steps", "96",
       "--episode-len", "16"]


def test_cli_rl_checkpoint_resume_and_registry(tmp_path, capsys):
    from ai_crypto_trader_tpu_torch import cli

    path, reg = str(tmp_path / "cli.journal"), str(tmp_path / "reg.json")
    cli.main(CLI + ["--checkpoint", path, "--checkpoint-every", "1"])
    first = capsys.readouterr().out
    cli.main(CLI + ["--checkpoint", path, "--resume", path, "--registry", reg])
    out = capsys.readouterr().out
    assert f"resumed@gen=1 from {path} (1 prior generations)" in out
    rows = [ln.split() for ln in out.splitlines() if ln.split()[:1] in (["0"], ["1"])
            and len(ln.split()) == 7]
    assert [r[:2] for r in rows] == [["0", "ckpt"], ["1", "live"]]
    first_row = next(ln for ln in first.splitlines() if ln.split()[:2] == ["0", "live"])
    assert rows[0][2:] == first_row.split()[2:]
    assert "registered " in out and "fitness=" in out
    assert len(ModelRegistry(path=reg).entries) == 1
    payload, _ = load_checkpoint(path)
    assert payload["generation"] == 2 and len(payload["history"]) == 2
    with pytest.raises(SystemExit, match="no intact checkpoint"):
        cli.main(CLI + ["--resume", str(tmp_path / "missing.journal")])
