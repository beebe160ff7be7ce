"""The port's MeshPartitioner through every population seam, on the CPU.

The port's mesh here is virtual: eight shards of the one CPU device
(`make_mesh(8, devices=["cpu"] * 8)`), the JAX tests' 8 virtual CPU
devices (`mesh8`, tests/conftest.py).  Members are independent, so on the
mesh every seam must equal the port's single device bit for bit (draws
made for the whole population before the split), and JAX's ``mesh8``
result at the tolerance of that seam's single-device parity test:

    sweep           ↔ `backtest.sweep` on mesh8: tests/test_torch_backtest.py's
                      `assert_stats_equal` (rtol 1e-5, atol 1e-6, counts exact);
    run_ga          ↔ JAX's single-device `run_ga` (JAX's own mesh GA is not
                      bit-equal to its single device: ROADMAP Queue 3), as
                      tests/test_torch_ga.py: best genome exact, history rtol 1e-5;
    TenantEngine    ↔ bit for bit (tests/test_torch_tenant.py);
    lob_sweep       ↔ tests/test_torch_sim_lob.py's summary bounds;
    train_pbt       ↔ tests/test_torch_population.py's rows and state tolerances;
    evaluate_structures ↔ tests/test_torch_generator.py's Sharpe tolerance;
    HPO             ↔ the trial sequence of tests/test_torch_train.py, with
                      the trials farmed round-robin and counted.
"""

import io
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu import backtest as jbt  # noqa: E402
from ai_crypto_trader_tpu import cli as jcli  # noqa: E402
from ai_crypto_trader_tpu.backtest import default_params as jax_default_params  # noqa: E402
from ai_crypto_trader_tpu.config import TradingParams as JTradingParams  # noqa: E402
from ai_crypto_trader_tpu.evolve import ga as jga  # noqa: E402
from ai_crypto_trader_tpu.obs import fleetscope as jfleetscope  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath  # noqa: E402
from ai_crypto_trader_tpu.ops import tenant_engine as jte  # noqa: E402
from ai_crypto_trader_tpu.parallel import partitioner as jpartitioner  # noqa: E402
from ai_crypto_trader_tpu.rl import population as jpop  # noqa: E402
from ai_crypto_trader_tpu.sim import lob as jlob  # noqa: E402
from ai_crypto_trader_tpu.strategy import generator as J  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof as jdevprof  # noqa: E402
from ai_crypto_trader_tpu.utils import meshprof as jmeshprof  # noqa: E402
from ai_crypto_trader_tpu_torch import backtest as tbt  # noqa: E402
from ai_crypto_trader_tpu_torch import cli, convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import default_params  # noqa: E402
from ai_crypto_trader_tpu_torch.config import GAParams, TradingParams  # noqa: E402
from ai_crypto_trader_tpu_torch.evolve import ga as tga  # noqa: E402
from ai_crypto_trader_tpu_torch.models import hpo  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import fleetscope  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import (  # noqa: E402
    MeshPartitioner, SingleDevicePartitioner, get_partitioner, make_mesh)
from ai_crypto_trader_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from ai_crypto_trader_tpu_torch.rl import dqn, population  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import lob  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import generator as P  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import meshprof  # noqa: E402
from test_torch_backtest import assert_stats_equal, make_inputs, to_port  # noqa: E402
from test_torch_ga import JaxDraws as GaJaxDraws  # noqa: E402
from test_torch_ga import _jax_cfg  # noqa: E402
from test_torch_generator import SHARPE_ATOL, SHARPE_RTOL, _port, _structures  # noqa: E402
from test_torch_population import (  # noqa: E402
    _assert_rows_follow, _cfgs, _jax_pop_draws, _pcfgs)
from test_torch_rl import assert_state_follows, jax_leaves  # noqa: E402
from test_torch_sim import JaxMarketDraws  # noqa: E402
from test_torch_sim_lob import STRAT, _flips, assert_summary_follows  # noqa: E402
from test_torch_tenant import (  # noqa: E402
    PERMISSIVE, SYMS, _assert_engines_agree, _feat_stream, _same)
from test_torch_train import _fake_train, _features  # noqa: E402


@pytest.fixture(autouse=True)
def _observatories_off():
    with tickpath.use(None), jdevprof.use(None), jmeshprof.use(None), \
            jfleetscope.use(None), fleetscope.use(None), meshprof.use(None):
        yield


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh(data_parallel=8, devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def part8(tmesh8):
    return MeshPartitioner(tmesh8)


@pytest.fixture(scope="module")
def jpart8(mesh8):
    return jpartitioner.MeshPartitioner(mesh8)


def _fn(tree):
    return {"sq": tree["x"] ** 2, "sum": torch.sum(tree["x"], dim=-1)}


# -- the seam itself ---------------------------------------------------------------

def test_pad_10_to_16_and_its_layout_card_equal_jax(part8, jpart8):
    """10 members over 8 shards pad to 16 by repeating the last one, slice
    back to 10, equal the single device bit for bit; the layout card (pad
    fraction 0.375, 2 members a device, the all-gather's bytes) is JAX's."""
    x = {"x": torch.arange(40.0).reshape(10, 4)}
    mp, jmp = meshprof.MeshProf(), jmeshprof.MeshProf()
    with meshprof.use(mp):
        got = part8.population_eval(_fn, name="toy")(x)
    with jmeshprof.use(jmp):
        ref = jpart8.population_eval(
            lambda t: {"sq": t["x"] ** 2, "sum": jnp.sum(t["x"], axis=-1)},
            name="toy")({"x": jnp.asarray(x["x"].numpy())})
    single = SingleDevicePartitioner().population_eval(_fn)(x)
    for k in single:
        assert got[k].shape == single[k].shape and torch.equal(got[k], single[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    card, jcard = mp.layouts["toy"].to_dict(), jmp.layouts["toy"].to_dict()
    assert card["pad_fraction"] == jcard["pad_fraction"] == 0.375
    for k in ("population", "pad", "devices", "padded", "members_per_device",
              "collective_bytes"):
        assert card[k] == jcard[k], k
    assert part8.pad_for(10) == jpart8.pad_for(10) == 6


def test_one_device_mesh_is_bit_equal_to_single():
    x = {"x": torch.arange(24.0).reshape(6, 4)}
    mesh1 = make_mesh(data_parallel=1, devices=["cpu"])
    single = SingleDevicePartitioner().population_eval(_fn)(x)
    onedev = MeshPartitioner(mesh1).population_eval(_fn)(x)
    for k in single:
        assert torch.equal(single[k], onedev[k])
    assert isinstance(get_partitioner(mesh1), SingleDevicePartitioner)


def test_replicated_args_get_partitioner_and_shard_population(tmesh8, part8):
    x = {"x": torch.arange(16.0).reshape(8, 2)}
    got = part8.population_eval(lambda t, extra: t["x"] * extra["scale"])(
        x, {"scale": torch.tensor(3.0)})
    assert torch.equal(got, x["x"] * 3.0)
    part = get_partitioner(tmesh8)
    assert isinstance(part, MeshPartitioner) and part == part8 and hash(part) == hash(part8)
    assert part.device_count == 8 and len(part.trial_devices()) == 8
    out = part.shard_population({"g": torch.ones((16, 3))})
    assert len(out["g"]) == 8 and all(s.shape == (2, 3) for s in out["g"])
    assert torch.equal(out["g"].gather(), torch.ones((16, 3)))
    with pytest.raises(ValueError, match="pad first"):
        part.shard_population({"g": torch.ones((10, 3))})
    desc = part.describe()
    assert desc["kind"] == "MeshPartitioner" and desc["devices"] == 8
    assert desc["axis"] == "data" and desc["mesh_shape"] == {"data": 8, "model": 1}
    assert desc["device_names"] == ["cpu"] * 8 and desc["platform"] == "cpu"


def test_shards_run_in_mesh_order_and_know_their_rows(part8):
    seen = []

    def fn(t):
        sh = tmesh.current_shard()
        seen.append((sh.index, sh.lo, sh.hi, sh.population))
        return t["x"]

    out = part8.population_eval(fn)({"x": torch.arange(10.0)})
    assert torch.equal(out, torch.arange(10.0))
    assert seen == [(i, 2 * i, 2 * i + 2, 10) for i in range(8)]
    assert tmesh.current_shard() is None


def test_foreign_partitioners_raise_and_a_mesh_is_required():
    from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner

    for foreign in (object(), jpartitioner.SingleDevicePartitioner()):
        with pytest.raises(TypeError, match="not a partitioner"):
            resolve_partitioner(foreign)
    with pytest.raises(TypeError, match="Mesh"):
        get_partitioner(mesh=object())


# -- the seams on the mesh ---------------------------------------------------------

@pytest.mark.parametrize("B", [16, 10])
def test_sweep_on_the_mesh(part8, jpart8, B):
    """K1's seam: the port's mesh bit for bit against its single device
    (stats and curve), and JAX's mesh8 sweep at assert_stats_equal's
    tolerance; a ragged population (10) pads inside."""
    _, inp = make_inputs(700)
    params = jbt.sample_params(jax.random.PRNGKey(0), B)
    t_inp, t_params = to_port(inp, params)
    single = tbt.sweep(t_inp, t_params, device="cpu")
    got = tbt.sweep(t_inp, t_params, partitioner=part8, device="cpu")
    for f in single._fields:
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    _, curve = tbt.sweep(t_inp, t_params, partitioner=part8, return_curve=True, device="cpu")
    _, curve1 = tbt.sweep(t_inp, t_params, return_curve=True, device="cpu")
    assert torch.equal(curve, curve1)
    assert_stats_equal(jbt.sweep(inp, params, partitioner=jpart8), got)


@pytest.mark.parametrize("pop", [8, 6])
def test_run_ga_on_the_mesh(part8, pop, monkeypatch):
    """The GA's draws are made for the whole population before each split:
    the mesh run equals the single device's bit for bit, with one host read,
    and JAX's single-device `run_ga` on the same draws (best genome exact,
    history rtol 1e-5; a ragged population against the single device)."""
    candles = _candles()
    cfg = GAParams(population_size=pop, generations=2, elite_size=2)
    key = jax.random.PRNGKey(4)
    fit = tga.backtest_fitness(candles, device="cpu")
    reads, real = [], tga.host_read
    monkeypatch.setattr(tga, "host_read", lambda t: reads.append(1) or real(t))
    b1, h1 = tga.run_ga(GaJaxDraws(key), fit, cfg, seed_params=default_params(device="cpu"),
                        device="cpu")
    bm, hm = tga.run_ga(GaJaxDraws(key), fit, cfg, seed_params=default_params(device="cpu"),
                        partitioner=part8, device="cpu")
    assert reads == [1, 1] and hm == h1
    assert all(torch.equal(a, b) for a, b in zip(bm, b1))
    if pop % 8:
        return          # ragged: held against the single device above, which follows JAX
    jfit = jga.backtest_fitness({k: jnp.asarray(v) for k, v in candles.items()})
    b_ref, h_ref = jga.run_ga(key, jfit, _jax_cfg(cfg), seed_params=jax_default_params())
    for f in b_ref._fields:
        assert float(getattr(bm, f)) == float(getattr(b_ref, f)), f
    for hg, hr in zip(hm, h_ref, strict=True):
        for k in ("best_fitness", "mean_fitness", "diversity"):
            np.testing.assert_allclose(hg[k], hr[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _candles():
    from ai_crypto_trader_tpu.data import generate_ohlcv

    return {k: v[:512] for k, v in generate_ohlcv(n=512, seed=3).items() if k != "regime"}


@pytest.mark.parametrize("n,pad_pow2", [(16, True), (10, False)])
def test_tenant_engine_on_the_mesh(part8, jpart8, n, pad_pow2):
    """The tenant axis over the mesh (a ragged 10 pads to 16 inside), the
    features replicated, fleet aggregates on the gathered lanes: bit for
    bit against the port's single device and JAX's mesh8 engine."""
    trading = dict(PERMISSIVE)
    jeng = jte.TenantEngine(SYMS, n, trading=JTradingParams(**trading), partitioner=jpart8,
                            pad_pow2=pad_pow2)
    teng = TenantEngine(SYMS, n, trading=TradingParams(**trading), partitioner=part8,
                        pad_pow2=pad_pow2, device="cpu")
    one = TenantEngine(SYMS, n, trading=TradingParams(**trading), pad_pow2=pad_pow2,
                       device="cpu")
    for e in (jeng, teng, one):
        e.set_tenant(3, balance=500.0)
        e._state_np["qty"][5, 0] = np.nan       # a poisoned lane, quarantined
        e._need_seed = True
    fj, ft, f1 = (s(top_k=4) for s in (jfleetscope.FleetScope, fleetscope.FleetScope,
                                       fleetscope.FleetScope))
    for feats in _feat_stream(teng.S, ticks=3):
        with jfleetscope.use(fj):
            jout = jeng.decide(feats)
        with fleetscope.use(f1):
            out1 = one.decide(feats)
        with fleetscope.use(ft):
            tout = teng.decide(feats)
        _same(tout, out1, "single")
        _same(teng._state_np, one._state_np, "single state")
        _same(teng.last_fleet, one.last_fleet, "single fleet")
        assert teng.last_stats["devices"] == 8 == jeng.last_stats["devices"]
        # the JAX engine re-seeds a ragged mesh every decide; the port needs not
        teng.full_seeds = jeng.full_seeds
        _assert_engines_agree(jeng, teng, jout, tout, "mesh8")
        _same(teng.last_fleet, {a: np.asarray(v) for a, v in jeng.last_fleet.items()}, "fleet")


def test_lob_sweep_on_the_mesh(part8, jpart8, monkeypatch):
    """Scenarios over the mesh with their schedules and the draws made for
    all B before the split: bit for bit against the single device (summary
    and series), one host read, and within JAX's mesh8 summary bounds."""
    B, T = 8, 64
    key = jax.random.PRNGKey(6)
    kw = dict(scenario="mixed", num_scenarios=B, steps=T, seed=3)
    strat = convert.sim_strategy_from_jax(STRAT, device="cpu")
    one = lob.lob_sweep(JaxMarketDraws(key), strategy=strat, device="cpu", **kw)
    reads, real = [], lob.host_read
    monkeypatch.setattr(lob, "host_read", lambda rb: reads.append(1) or real(rb))
    got = lob.lob_sweep(JaxMarketDraws(key), strategy=strat, partitioner=part8, device="cpu",
                        **kw)
    assert reads == [1] and got["stats"]["devices"] == 8
    for k, v in one["summary"].items():
        np.testing.assert_array_equal(got["summary"][k], v, err_msg=k)
    for k, v in one["device"].items():
        assert torch.equal(got["device"][k], v), k
    ref = jlob.lob_sweep(key, strategy=STRAT, partitioner=jpart8, **kw)
    assert {k: v for k, v in got["stats"].items() if k != "wall_s"} == \
        {k: v for k, v in ref["stats"].items() if k != "wall_s"}
    close, rclose = got["device"]["close"].numpy(), np.asarray(ref["device"]["close"])
    start = np.full((B, 1), np.float32(40_000.0))
    _, first = _flips({"open": np.concatenate([start, close[:, :-1]], 1), "close": close},
                      {"open": np.concatenate([start, rclose[:, :-1]], 1), "close": rclose})
    assert assert_summary_follows(got["summary"], jax.tree.map(np.asarray, ref["summary"]),
                                  T, first) >= B // 2
    ragged = lob.lob_sweep(JaxMarketDraws(key), strategy=strat, partitioner=part8,
                           device="cpu", **dict(kw, num_scenarios=6))
    single6 = lob.lob_sweep(JaxMarketDraws(key), strategy=strat, device="cpu",
                            **dict(kw, num_scenarios=6))
    for k, v in single6["summary"].items():
        np.testing.assert_array_equal(ragged["summary"][k], v, err_msg=k)


@pytest.fixture(scope="module")
def envs():
    jp, _ = jpop.pbt_env_params(jax.random.PRNGKey(2), num_scenarios=4, steps=256,
                                episode_len=48)
    return jp, convert.env_params_from_numpy(jp, device="cpu")


def test_train_pbt_on_the_mesh(part8, jpart8, envs, monkeypatch):
    """P = 8 members over the mesh, every draw made for the fleet and
    sliced (`rl.draws.FleetDraws`): bit for bit against the single device
    on a torch.Generator and on JAX's draws, one host read a generation,
    and JAX's mesh8 run within tests/test_torch_population.py's bounds."""
    jp, tp = envs
    jcfg, tcfg = _cfgs(jp)
    jpc, tpc = _pcfgs(population=8)
    r1 = population.train_pbt(torch.Generator().manual_seed(5), tp, tcfg, tpc)
    rm = population.train_pbt(torch.Generator().manual_seed(5), tp, tcfg, tpc,
                              partitioner=part8)
    assert rm.history == r1.history and np.array_equal(rm.fitness, r1.fitness)
    l1, lm = (dqn.tensor_leaves(dqn._drop(r.state.members)) for r in (r1, rm))
    assert all(torch.equal(lm[k], l1[k]) for k in l1)
    key = jax.random.PRNGKey(6)
    reads, real = [], population.host_read
    monkeypatch.setattr(population, "host_read", lambda rb: reads.append(1) or real(rb))
    got = population.train_pbt(_jax_pop_draws(key, tcfg, 8), tp, tcfg, tpc, partitioner=part8)
    assert len(reads) == tpc.generations
    one = population.train_pbt(_jax_pop_draws(key, tcfg, 8), tp, tcfg, tpc)
    assert got.history == one.history
    ref = jpop.train_pbt(key, jp, jcfg, jpc, partitioner=jpart8)
    _assert_rows_follow(got.history, ref.history)
    assert got.best_member == ref.best_member
    assert_state_follows(got.state.members, jax_leaves(ref.state.members), "mesh8 fleet")


def test_evaluate_structures_on_the_mesh(part8, jpart8, monkeypatch):
    """The candidate pool over the mesh (9 candidates pad to 16): bit for
    bit against the single device with one host read; JAX's mesh8 scores
    equal its single device's, and the port's follow them within
    tests/test_torch_generator.py's Sharpe tolerance where the port's
    single device does."""
    from ai_crypto_trader_tpu.data import generate_ohlcv

    arrays = {k: np.asarray(v) for k, v in generate_ohlcv(n=4_000, seed=11).items()
              if k != "regime"}
    jax_folds = [J.fold_features({k: v[i * 1_400:(i + 1) * 1_400] for k, v in arrays.items()})
                 for i in range(2)]
    structures = _structures() + [J.default_seed()]
    folds_np = [{k: np.asarray(v) for k, v in f.items()} for f in jax_folds]
    ported = [_port(s) for s in structures]
    single = P.evaluate_structures(folds_np, ported, device="cpu")
    reads, real = [], P.host_read
    monkeypatch.setattr(P, "host_read", lambda t: reads.append(1) or real(t))
    got = P.evaluate_structures(folds_np, ported, partitioner=part8, device="cpu")
    assert reads == [1]
    np.testing.assert_array_equal(got, single)
    ref = J.evaluate_structures(jax_folds, structures, partitioner=jpart8)
    np.testing.assert_array_equal(ref, J.evaluate_structures(jax_folds, structures))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    close = np.isclose(single, ref, rtol=SHARPE_RTOL, atol=SHARPE_ATOL) | np.isinf(ref)
    assert close.sum() >= len(structures) - 2
    np.testing.assert_allclose(got[close], ref[close], rtol=SHARPE_RTOL, atol=SHARPE_ATOL)


def test_hpo_farms_trials_round_robin(part8, jpart8, monkeypatch):
    """Trials round-robin over the mesh's devices, counted by meshprof:
    the JAX trial sequence and JAX's count of farmed trials."""
    from ai_crypto_trader_tpu.models import hpo as jhpo

    monkeypatch.setattr(jhpo, "train_model", _fake_train)
    placed = []

    def fake(*a, device=None, **kw):
        placed.append(device)
        return _fake_train(*a, **kw)

    monkeypatch.setattr(hpo, "train_model", fake)
    kw = dict(n_trials=9, n_startup=3, rung_epochs=(1, 2), seed=5)
    jmp, mp = jmeshprof.MeshProf(), meshprof.MeshProf()
    with jmeshprof.use(jmp):
        ref = jhpo.optimize_hyperparameters(jax.random.PRNGKey(0), _features(), **kw,
                                            partitioner=jpart8)
    with meshprof.use(mp):
        got = hpo.optimize_hyperparameters(torch.Generator(), _features(), partitioner=part8,
                                           device="cpu", **kw)
    assert got == ref
    assert sum(mp.trial_assignments.values()) == sum(jmp.trial_assignments.values()) == 9 + 3
    assert placed == [torch.device("cpu")] * 12


def test_hpo_trials_share_the_callers_stream_on_every_device(monkeypatch):
    """Every trial draws from a generator of its own on the caller's
    generator's device, seeded by the caller's stream in trial order before
    the rung's farm splits (the JAX package's ``fold_in(key, i)``), whatever
    device the mesh puts it on: the caller's stream advances as one device
    advances it, however the trials are farmed."""
    seen = []

    def fake(*a, device=None, **kw):
        seen.append((a[0], device))
        return _fake_train(*a, **kw)

    monkeypatch.setattr(hpo, "train_model", fake)
    g = torch.Generator().manual_seed(3)
    part = MeshPartitioner(make_mesh(2, devices=["cpu", "meta"]))
    hpo.optimize_hyperparameters(g, _features(), n_trials=4, rung_epochs=(1, 1),
                                 partitioner=part)
    replay = torch.Generator().manual_seed(3)
    seeds = [int(s) for n in (4, 2)            # rung 0's 4 trials, then its 2 finalists
             for s in torch.randint(0, 2 ** 62, (n,), generator=replay)]
    assert [gen.initial_seed() for gen, _ in seen] == seeds
    assert all(gen is not g and gen.device == g.device for gen, _ in seen)
    assert torch.equal(g.get_state(), replay.get_state())
    assert [d.type for _, d in seen][:4] == ["cpu", "meta", "cpu", "meta"]


def test_hpo_farm_on_the_mesh_takes_the_single_devices_draws(part8):
    """A real farm on 8 shards: the single device's trials and losses, and
    the generator left in the single device's state."""
    kw = dict(n_trials=3, rung_epochs=(1, 1), seq_len=12, survivor_fraction=0.5)
    g1, g8 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    one = hpo.optimize_hyperparameters(g1, _features(100), device="cpu", **kw)
    got = hpo.optimize_hyperparameters(g8, _features(100), partitioner=part8, **kw)
    assert got == one
    assert torch.equal(g8.get_state(), g1.get_state())


def test_draws_move_to_the_device_that_uses_them():
    """A trial on another device than the generator's: the dropout mask and
    the epoch's permutation are drawn on the generator's device and moved
    to the data's (the meta device stands in for a second card)."""
    from ai_crypto_trader_tpu_torch.models import layers, train_loop

    g = torch.Generator().manual_seed(5)
    out = layers.dropout(torch.ones(4, 6, device="meta"), 0.5, g)
    assert out.device.type == "meta" and out.shape == (4, 6)
    perm = train_loop.permutation(torch.Generator().manual_seed(5), 7, torch.device("meta"))
    assert perm.device.type == "meta" and perm.shape == (7,)
    g_cpu = torch.Generator().manual_seed(5)
    assert torch.equal(train_loop.permutation(g_cpu, 7, torch.device("cpu")),
                       torch.randperm(7, generator=torch.Generator().manual_seed(5)))


def test_full_stack_cadence_takes_the_mesh(part8):
    from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell import FakeExchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
    from ai_crypto_trader_tpu_torch.shell.stack import build_full_stack

    d = {k: v for k, v in generate_ohlcv(n=300, seed=1).items() if k != "regime"}
    system = TradingSystem(FakeExchange({"BTCUSDC": from_dict(d, symbol="BTCUSDC")}),
                           ["BTCUSDC"], device="cpu")
    try:
        services = build_full_stack(system, grid_symbol="BTCUSDC", dca_symbol="BTCUSDC",
                                    cadences={"partitioner": part8,
                                              "patterns": {"checkpoint": None,
                                                           "train_on_start": False}})
        evolver = next(s.evolver for s in services if hasattr(s, "evolver"))
        generator = next(s for s in services if type(s).__name__ == "GeneratorService")
        assert evolver.partitioner is part8 and generator.partitioner is part8
        with pytest.raises(TypeError, match="not a partitioner"):
            build_full_stack(system, cadences={"partitioner": object()})
    finally:
        system.shutdown()


def test_cli_mesh_prints_a_mesh_layout_as_jax(part8, monkeypatch):
    """`cli mesh --pop 10` on a mesh of 8: the pad arithmetic line as JAX's
    on mesh8, and the partitioner block with the mesh's layout."""
    from ai_crypto_trader_tpu_torch import parallel

    monkeypatch.setattr(parallel, "get_partitioner", lambda mesh=None: part8)

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue()

    def jax_main(argv):
        args = jcli.build_parser().parse_args(argv)
        args.fn(args)

    got = run(cli.main, ["mesh", "--pop", "10"])
    ref = run(jax_main, ["mesh", "--pop", "10"])
    assert got.strip().splitlines()[-1] == ref.strip().splitlines()[-1]
    assert "pad 6 → 16 lanes (2/device), pad_fraction 0.3750 — MeshPaddingWasteHigh" in got
    assert '"kind": "MeshPartitioner"' in got and '"mesh_shape"' in got
