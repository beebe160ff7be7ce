"""The port's PBT fleet and `cli rl` against the JAX package, on the CPU.

    pop_init ↔ rl.population.pop_init (and `convert.dqn_state_from_jax`);
    the P = 1 oracle (train_pbt ≡ train_iterations, bit for bit);  one
    generation at P = 4 ↔ the JAX generation program;  the exchange ↔
    `_exchange_program` on the same fitness and draws (healthy, frozen and
    heal-ready members);  train_pbt's history ↔ the JAX run's;  one host
    read a generation;  the partitioner seam;  `cli rl`'s parser and a run.

The draws are the JAX key schedule's (`test_torch_rl.JaxDraws`).
Tolerances as in tests/test_torch_rl.py: parameters and moments atol 1e-6,
rtol 1e-5; fitness (a mean of final balances) atol 1e-6; loss and reward
metrics rtol 1e-5; lineage, hypers, quarantine bits and cooldowns equal.
An exchange's ranking could flip where two members' fitness lie within
the fitness tolerance: the history comparison then stops and reports it
(none happens at these seeds, and none is looked for).
"""

import io
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu import cli as jcli  # noqa: E402
from ai_crypto_trader_tpu.rl import dqn as jdqn  # noqa: E402
from ai_crypto_trader_tpu.rl import population as jpop  # noqa: E402
from ai_crypto_trader_tpu_torch import cli, convert  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import (  # noqa: E402
    MeshPartitioner, SingleDevicePartitioner, get_partitioner, make_mesh)
from ai_crypto_trader_tpu_torch.rl import dqn, population  # noqa: E402
from test_torch_rl import (  # noqa: E402
    METRIC_RTOL, JaxDraws, _np, assert_state_follows, jax_leaves)

FIT_ATOL = 1e-6
CFG = dict(num_envs=4, rollout_len=4, hidden=(8,), replay_capacity=64, batch_size=8,
           learn_steps_per_iter=1, target_sync_every=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    """JAX's LOB markets ([4, 256], book columns, half-spread cost) and the
    same tables in the port."""
    jp, _ = jpop.pbt_env_params(jax.random.PRNGKey(2), num_scenarios=4, steps=256,
                                episode_len=48)
    return jp, convert.env_params_from_numpy(jp, device="cpu")


def _cfgs(jp, **over):
    kw = dict(CFG, state_size=int(jp.obs_table.shape[-1]) + 2, **over)
    return jdqn.DQNConfig(**kw), dqn.DQNConfig(**kw)


def _pcfgs(**kw):
    kw = dict(dict(population=4, generations=2, iters_per_generation=2, eval_steps=8), **kw)
    return jpop.PBTConfig(**kw), population.PBTConfig(**kw)


def _jax_pop_draws(key, tcfg, P):
    return JaxDraws(jax.random.split(key, P), tcfg, True, root=key)


def _copy(tree):
    return jax.tree.map(jnp.array, tree)


def test_pop_init_follows_jax(envs):
    jp, tp = envs
    jcfg, tcfg = _cfgs(jp)
    jpc, tpc = _pcfgs()
    key = jax.random.PRNGKey(0)
    jpop_ = jpop.pop_init(key, jp, jcfg, jpc)
    tpop = population.pop_init(_jax_pop_draws(key, tcfg, 4), tp, tcfg, tpc)
    assert_state_follows(tpop.members, jax_leaves(jpop_.members), "pop_init")
    for name in population.Hypers._fields:
        np.testing.assert_array_equal(_np(getattr(tpop.hypers, name)),
                                      np.asarray(getattr(jpop_.hypers, name)))
    assert not tpop.quarantined.any() and not tpop.cooldown.any()
    carried = convert.dqn_state_from_jax(jpop_.members, None, device="cpu")
    for k, v in dqn.tensor_leaves(carried).items():
        np.testing.assert_array_equal(_np(v).astype(np.float64),
                                      jax_leaves(jpop_.members)[k].astype(np.float64), err_msg=k)


def test_p1_oracle_bit_for_bit(envs):
    """At P = 1, 2 generations of 3 iterations equal `train_iterations(6)`
    from the same draws in every DQNState leaf, bit for bit (the
    evaluation and the exchange draw from streams of their own)."""
    _, tp = envs
    _, tcfg = _cfgs(envs[0])
    pcfg = population.PBTConfig(population=1, generations=2, iters_per_generation=3,
                                eval_steps=8)
    res = population.train_pbt(torch.Generator().manual_seed(5), tp, tcfg, pcfg)
    single = dqn.dqn_init(torch.Generator().manual_seed(5), tp, tcfg)
    single, _ = dqn.train_iterations(tp, single, tcfg, n_iters=6)
    got = dqn.tensor_leaves(dqn._drop(res.state.members))
    for k, v in dqn.tensor_leaves(single).items():
        assert torch.equal(got[k], v), k
    assert [h["lineage"] for h in res.history] == [[0], [0]]


def test_generation_follows_jax(envs):
    """One generation program at P = 4 on the same draws: every member's
    state, the fitness and the metrics."""
    jp, tp = envs
    jcfg, tcfg = _cfgs(jp)
    jpc, tpc = _pcfgs()
    key = jax.random.PRNGKey(1)
    jpop_ = jpop.pop_init(key, jp, jcfg, jpc)
    tpop = population.pop_init(_jax_pop_draws(key, tcfg, 4), tp, tcfg, tpc)
    program = jpop._pbt_program(jcfg, jpop._program_pcfg(jpc), jpop._SINGLE)
    jout, jfit, jmet = program(_copy(jpop_), jp)
    tout, tfit, tmet = population._generation(tpop, tp, tcfg, tpc)
    assert_state_follows(tout.members, jax_leaves(jout.members), "generation")
    np.testing.assert_allclose(tfit.numpy(), np.asarray(jfit), atol=FIT_ATOL, rtol=0)
    for name in ("loss", "mean_reward"):
        np.testing.assert_allclose(tmet[name].numpy(), np.asarray(jmet[name]),
                                   rtol=METRIC_RTOL, atol=1e-9)
    np.testing.assert_array_equal(tmet["epsilon"].numpy(), np.asarray(jmet["epsilon"]))
    np.testing.assert_array_equal(tmet["tripped_new"].numpy(), np.asarray(jmet["tripped_new"]))
    np.testing.assert_array_equal(tout.quarantined.numpy(), np.asarray(jout.quarantined))


@pytest.mark.parametrize("case", ["healthy", "frozen_and_heal_ready"])
def test_exchange_follows_jax(envs, case):
    """`_exchange` against `_exchange_program` on the same fitness and
    draws at P = 8: lineage, hypers, quarantine and cooldown equal, every
    member's state gathered as JAX gathers it, and the clones' draws forked
    as JAX forks their keys."""
    jp, tp = envs
    jcfg, tcfg = _cfgs(jp)
    jpc, tpc = _pcfgs(population=8, generations=1)
    key = jax.random.PRNGKey(3)
    jpop_ = jpop.pop_init(key, jp, jcfg, jpc)
    hypers = jpop_.hypers._replace(
        learning_rate=jnp.asarray(np.geomspace(1e-4, 5e-2, 8), jnp.float32),
        target_sync_every=jnp.asarray([2, 3, 50, 100, 999, 7, 11, 500], jnp.int32),
        epsilon_decay=jnp.asarray(np.linspace(0.95, 0.99995, 8), jnp.float32))
    fitness = jnp.asarray(np.random.default_rng(0).permutation(8) * 0.01 + 0.95, jnp.float32)
    q = np.zeros(8, bool)
    cd = np.zeros(8, np.int32)
    if case != "healthy":
        q[[2, 5]] = True
        cd[2], cd[5] = 1, 0          # 2 is frozen, 5 is ready to heal
    ex = jpop._exchange_program(jcfg, jpop._program_pcfg(jpc))
    g = 4
    jm, jh, jq, jc, jlin = ex(_copy(jpop_.members), _copy(hypers), jnp.asarray(q),
                              jnp.asarray(cd), fitness, jax.random.fold_in(key, g + 1))
    draws = JaxDraws(jpop_.members.key, tcfg, True, root=key)
    members = convert.dqn_state_from_jax(jpop_.members, draws, device="cpu")
    th = population.Hypers(*(torch.from_numpy(np.array(x)) for x in hypers))
    tm, thy, tq, tc, tlin = population._exchange(
        members, th, torch.from_numpy(q), torch.from_numpy(cd),
        torch.from_numpy(np.array(fitness)), g, tpc)
    np.testing.assert_array_equal(tlin.numpy(), np.asarray(jlin))
    assert (tlin.numpy() != np.arange(8)).sum() == 2
    for name in population.Hypers._fields:
        np.testing.assert_array_equal(_np(getattr(thy, name)), np.asarray(getattr(jh, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    ref = jax_leaves(jm)
    for k, v in dqn.tensor_leaves(tm).items():
        np.testing.assert_array_equal(_np(v).astype(np.float64), ref[k].astype(np.float64),
                                      err_msg=k)
    np.testing.assert_array_equal(np.asarray(draws.keys), np.asarray(jm.key))
    if case != "healthy":
        assert bool(tq[2]) and int(tc[2]) == 0       # frozen: cooldown ticked
        assert int(tlin[5]) != 5 and not bool(tq[5])  # healed by the forced exploit
        donors = {int(d) for i, d in enumerate(tlin.tolist()) if d != i}
        assert not donors & {2, 5}                    # the quarantined never donate


def _assert_rows_follow(rows, jrows):
    for r, j in zip(rows, jrows, strict=True):
        fit, jfit = np.array(r["fitness"]), np.array(j["fitness"])
        np.testing.assert_allclose(fit, jfit, atol=FIT_ATOL, rtol=0)
        if r["lineage"] != j["lineage"]:
            order = np.sort(jfit)
            gap = np.diff(order).min()
            assert gap <= 2 * FIT_ATOL, (r["generation"], r["lineage"], j["lineage"])
            pytest.fail(f"generation {r['generation']}: a fitness near-tie ({gap:.3g}) "
                        "reordered the exchange; the comparison stops there")
        for k in ("generation", "n_exploited", "quarantined", "n_quarantined", "n_tripped",
                  "n_healed", "hypers"):
            assert r[k] == j[k], (r["generation"], k)
        for k in ("best_fitness", "mean_fitness"):
            np.testing.assert_allclose(r[k], j[k], atol=FIT_ATOL, rtol=0)
        for k in ("loss", "mean_reward"):
            np.testing.assert_allclose(r[k], j[k], rtol=METRIC_RTOL, atol=1e-9)


def test_train_pbt_follows_jax_with_one_read_a_generation(envs, monkeypatch):
    """P = 4, G = 2 on JAX's draws: the history rows as the JAX run's, the
    best member, and exactly one host read a generation."""
    jp, tp = envs
    jcfg, tcfg = _cfgs(jp)
    jpc, tpc = _pcfgs()
    key = jax.random.PRNGKey(6)
    jres = jpop.train_pbt(key, jp, jcfg, jpc)
    reads, real = [], population.host_read
    monkeypatch.setattr(population, "host_read", lambda rb: reads.append(1) or real(rb))
    seen = []
    res = population.train_pbt(_jax_pop_draws(key, tcfg, 4), tp, tcfg, tpc,
                               on_generation=lambda g, pop, row: seen.append(g))
    assert len(reads) == tpc.generations and seen == [0, 1]
    _assert_rows_follow(res.history, jres.history)
    assert res.best_member == jres.best_member
    assert_state_follows(res.state.members, jax_leaves(jres.state.members), "final fleet")
    best = population.best_params(res)
    assert best["Dense_0.kernel"].shape == (tcfg.state_size, 8)


def test_containment_quarantines_masks_and_heals(envs):
    """A NaN written into one member's parameters: the next generation
    trips it (quarantined, cooldown 1), it is neither donor nor clone while
    frozen, and the exchange after the cooldown clones a survivor over it
    (healed)."""
    _, tp = envs
    _, tcfg = _cfgs(envs[0])
    pcfg = population.PBTConfig(population=8, generations=1, iters_per_generation=1,
                                eval_steps=4)
    pop = population.pop_init(torch.Generator().manual_seed(0), tp, tcfg, pcfg)
    params = dict(pop.members.params)
    params["Dense_0.kernel"] = params["Dense_0.kernel"].clone()
    params["Dense_0.kernel"][3, 0, 0] = float("nan")
    pop = pop._replace(members=pop.members._replace(params=params))
    rows = []
    for g in range(3):
        res = population.train_pbt(None, tp, tcfg, pcfg, init_pop=pop, start_generation=g)
        pop, row = res.state, res.history[0]
        rows.append(row)
    assert rows[0]["quarantined"][3] and rows[0]["n_tripped"] == 1
    assert rows[0]["lineage"][3] == 3 and 3 not in rows[0]["lineage"][:3] + rows[0]["lineage"][4:]
    assert rows[1]["lineage"][3] != 3 and not rows[1]["quarantined"][3]
    assert rows[1]["n_healed"] == 1 and rows[1]["n_quarantined"] == 0
    assert np.isfinite(rows[1]["best_fitness"])
    assert all(torch.isfinite(v).all() for v in pop.members.params.values())


def test_partitioner_seam():
    p = get_partitioner()
    assert p == SingleDevicePartitioner() and p.device_count == 1 and p.pad_for(7) == 0
    tree = {"a": torch.ones(3)}
    assert p.shard_population(tree) is tree
    fn = lambda x: x  # noqa: E731
    assert p.population_eval(fn, donate_pop=True) is fn
    # named, the seam records the program's layout card (utils.meshprof)
    named = p.population_eval(fn, name="pbt_generation", donate_pop=True)
    assert named(tree) is tree

    class Mesh:
        device_count = 4

    with pytest.raises(TypeError, match="not a partitioner"):
        population.train_pbt(None, None, None, population.PBTConfig(), partitioner=Mesh())
    with pytest.raises(TypeError, match="Mesh"):
        get_partitioner(mesh=object())
    mesh = make_mesh(4, devices=["cpu"] * 4)
    assert get_partitioner(mesh) == MeshPartitioner(mesh) and get_partitioner(mesh).pad_for(7) == 1


def _flags(parser, command):
    sub = next(a for a in parser._actions if a.dest == "command")
    sp = sub.choices[command]
    return {a.dest: (a.default, a.type, a.choices) for a in sp._actions if a.dest != "help"}


def test_cli_rl_parser_matches_jax():
    jflags = _flags(jcli.build_parser(), "rl")
    flags = _flags(cli.build_parser(), "rl")
    assert flags.pop("device") == ("cuda", None, ("cuda", "cpu"))
    assert flags == jflags


def test_cli_rl_runs_on_the_cpu_and_refuses_what_is_not_ported(tmp_path):
    out = io.StringIO()
    small = ["rl", "--device", "cpu", "--population", "4", "--generations", "2",
             "--iters", "1", "--envs", "4", "--rollout", "4", "--scenarios", "4",
             "--steps", "128", "--episode-len", "32"]
    with contextlib.redirect_stdout(out):
        cli.main(small)
    lines = out.getvalue().splitlines()
    assert lines[0] == "population=4 devices=1 dynamics=lob scenarios=4"
    head = lines.index(f"{'gen':>3} {'src':>4} {'best':>9} {'mean':>9} {'exploited':>9} "
                       f"{'quar':>4} {'loss':>9}")
    gens = [ln.split() for ln in lines[head + 1:head + 3]]
    assert [g[0] for g in gens] == ["0", "1"] and all(g[1] == "live" for g in gens)
    fleet = lines[lines.index(f"{'member':>6} {'fitness':>9} {'from':>5} {'lr':>9} "
                              f"{'gamma':>7} {'eps_decay':>10} {'eps_min':>8} "
                              f"{'sync':>5}") + 1:]
    assert len(fleet) == 4 and sum("*" in ln for ln in fleet) == 1
    # --registry, --checkpoint and --resume are ported (the trainer service's
    # codec); what the JAX CLI refuses, a journal with no intact checkpoint,
    # the port refuses too
    journal, registry = tmp_path / "pbt.journal", tmp_path / "registry.json"
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(small + ["--checkpoint", str(journal), "--registry", str(registry)])
    assert journal.stat().st_size > 0 and registry.stat().st_size > 0
    with pytest.raises(SystemExit, match="no intact checkpoint"):
        cli.main(["rl", "--device", "cpu", "--resume", str(tmp_path / "missing.journal")])
