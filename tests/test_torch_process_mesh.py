"""The port's process mesh on the CPU: ranks of a gloo group in subprocesses.

A module fixture starts the group twice over gloo on the CPU, at world
sizes 2 and 3, each rank a subprocess that runs this file as a script:
it brings the group up with `parallel.initialize_distributed`, takes
`get_partitioner()` (the process mesh, with no argument) and runs every
population seam, `time_shard` and the ring at small sizes on inputs the
test saved, then writes its outputs with ``torch.save``.  Populations of
10 (the sweep, the GA, `lob_sweep`, the PBT fleet, the structure pool)
and 16 (the tenant engine) give a pad at world size 3 and none at 2.  The
JAX draws of the GA, `lob_sweep` and the PBT fleet are recorded once, in
the single device's run, and every other run replays them (`_Replay`).

Every rank's outputs must be identical, and equal the port's single
device and its one-controller mesh of the same width bit for bit
(`time_shard`: the one-controller mesh; the ring within its tolerances).
Against the JAX package each seam is held at the tolerance
tests/test_torch_mesh_partitioner.py:1-20 states for it: the sweep at
`assert_stats_equal`'s, the GA's best genome exactly and its history at
rtol 1e-5, the tenant engine bit for bit, `lob_sweep` within its summary
bounds, the PBT generation within tests/test_torch_population.py's bounds,
`evaluate_structures` at the Sharpe tolerance, the HPO farm's trial
sequence exactly; `time_shard` and the ring at chip_smoke.py's
tolerances (MESH_TS_*, MESH_LC_*) against JAX's unsplit EMA and dense
attention.  The ring runs at T = 72 (64 does not split over 3 ranks).
"""

import contextlib
import copy
import io
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
POP = 10
RANK_TIMEOUT_S = 300
T_SWEEP, T_GA, T_TS, T_RING = 2_048, 512, 1_200, 72
EMA_WINDOWS, MEAN_WINDOWS = (12, 26, 200), (5, 20, 50)
# chip_smoke.py's MESH_TS_* (tests/test_time_shard.py's EMA and rolling-mean tolerances)
TS_RTOL, TS_ATOL, MEAN_ATOL = 2e-5, 1e-4, 1e-3
LC_TOL, LC_GRAD_RTOL, LC_GRAD_ATOL = 2e-4, 5e-3, 5e-4    # and its MESH_LC_*
GA_KW = dict(population_size=10, generations=2, elite_size=2)
HPO_KW = dict(n_trials=4, rung_epochs=(1, 1), seq_len=12, survivor_fraction=0.5)
HPO_FAKE_KW = dict(n_trials=9, n_startup=3, rung_epochs=(1, 2), seed=5)
LOB_KW = dict(scenario="mixed", num_scenarios=10, steps=64, seed=3)


# -- recorded draws ---------------------------------------------------------------------

class _Recorder:
    """A draw provider whose calls are kept, in order, with their results."""

    def __init__(self, base):
        self._base, self.calls = base, []

    def __getattr__(self, name):
        attr = getattr(self._base, name)
        if not callable(attr):
            return attr

        def call(*args, **kw):
            out = attr(*args, **kw)
            self.calls.append((name, out))
            return out

        return call


class _Replay:
    """A `_Recorder`'s draws handed out again in the recorded order (a
    copy each): every run asks for the same draws in the same order, the
    whole population's before each split."""

    def __init__(self, calls):
        self._calls = list(calls)
        self._names = {name for name, _ in calls}

    def __getattr__(self, name):
        if name not in self._names:
            raise AttributeError(name)

        def call(*args, **kw):
            recorded, out = self._calls.pop(0)
            assert recorded == name, (recorded, name)
            return copy.deepcopy(out)

        return call


# -- the seams, run alike by a rank and by the test's references ------------------

def _sweep(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch import backtest as tbt

    return tbt.sweep(inp["sweep_inputs"], inp["sweep_params"], partitioner=part,
                     device="cpu")._asdict()


def _ga(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch.backtest import default_params
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import ga

    fit = ga.backtest_fitness(inp["candles"], device="cpu")
    best, history = ga.run_ga(draws or _Replay(inp["draws"]["ga"]), fit, GAParams(**GA_KW),
                              seed_params=default_params(device="cpu"), partitioner=part,
                              device="cpu")
    return {"best": tuple(best), "history": history}


def _tenant(part, inp, draws=None):
    from test_torch_tenant import PERMISSIVE, SYMS, _feat_stream

    from ai_crypto_trader_tpu_torch.config import TradingParams
    from ai_crypto_trader_tpu_torch.obs import fleetscope
    from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine

    eng = TenantEngine(SYMS, 16, trading=TradingParams(**PERMISSIVE), partitioner=part,
                       pad_pow2=False, device="cpu")
    eng.set_tenant(3, balance=500.0)
    eng._state_np["qty"][5, 0] = np.nan           # a poisoned lane, quarantined
    eng._need_seed = True
    ticks, scope = [], fleetscope.FleetScope(top_k=4)
    for feats in _feat_stream(eng.S, ticks=3):
        with fleetscope.use(scope):
            out = eng.decide(feats)
        ticks.append({"out": out, "state": dict(eng._state_np), "fleet": eng.last_fleet,
                      "devices": eng.last_stats["devices"]})
    return ticks


def _lob(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch.sim import lob

    got = lob.lob_sweep(draws or _Replay(inp["draws"]["lob"]), strategy=inp["lob_strategy"],
                        partitioner=part, device="cpu", **LOB_KW)
    return {"summary": got["summary"], "device": got["device"],
            "stats": {k: v for k, v in got["stats"].items() if k != "wall_s"}}


def _pbt(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch.rl import dqn, population

    tcfg, tpc = inp["pbt_cfgs"]
    r = population.train_pbt(draws or _Replay(inp["draws"]["pbt"]), inp["pbt_env"], tcfg, tpc,
                             partitioner=part)
    return {"history": r.history, "fitness": r.fitness, "best_member": r.best_member,
            "members": dqn.tensor_leaves(r.state.members)}


def _structures(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch.strategy import generator as P

    return P.evaluate_structures(inp["folds"], inp["structures"], partitioner=part,
                                 device="cpu")


def _hpo(part, inp, draws=None):
    from test_torch_train import _fake_train

    from ai_crypto_trader_tpu_torch.models import hpo
    from ai_crypto_trader_tpu_torch.utils import meshprof

    mp = meshprof.MeshProf()
    with meshprof.use(mp):
        real = hpo.optimize_hyperparameters(torch.Generator().manual_seed(4), inp["features"],
                                            partitioner=part, device="cpu", **HPO_KW)
    train, hpo.train_model = hpo.train_model, _fake_train
    try:
        fake = hpo.optimize_hyperparameters(torch.Generator(), inp["fake_features"],
                                            partitioner=part, device="cpu", **HPO_FAKE_KW)
    finally:
        hpo.train_model = train
    return {"real": real, "fake": fake, "farmed_here": sum(mp.trial_assignments.values())}


def _time_shard(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch.parallel.time_shard import (
        sharded_ema, sharded_rolling_mean)

    x, mesh = inp["series"], part.mesh
    return {**{f"ema_{w}": sharded_ema(x, w, mesh).gather() for w in EMA_WINDOWS},
            **{f"mean_{w}": sharded_rolling_mean(x, w, mesh).gather() for w in MEAN_WINDOWS}}


def _ring(part, inp, draws=None):
    from ai_crypto_trader_tpu_torch.models import LongContextTransformer, long_context_loss
    from ai_crypto_trader_tpu_torch.parallel.ring_attention import ring_self_attention

    q, k, v = (t.clone().requires_grad_(True) for t in inp["qkv"])
    out = ring_self_attention(q, k, v, part.mesh, causal=True)
    grads = torch.autograd.grad((out * inp["weight"]).sum(), [q, k, v])
    model = LongContextTransformer(4, mesh=part.mesh, device="cpu",
                                   generator=torch.Generator().manual_seed(29))
    params = dict(model.named_parameters())
    loss = long_context_loss(model, params, inp["lc_x"], inp["lc_y"])
    lc_grads = torch.autograd.grad(loss, list(params.values()))
    return {"out": out.detach(), "grads": [g.detach() for g in grads],
            "lc_loss": loss.detach(), "lc_grads": [g.detach() for g in lc_grads]}


SEAMS = {"sweep": _sweep, "ga": _ga, "tenant": _tenant, "lob": _lob, "pbt": _pbt,
         "structures": _structures, "hpo": _hpo, "time_shard": _time_shard, "ring": _ring}


# -- one rank -------------------------------------------------------------------------

def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank: the group up over gloo on the CPU, every seam through
    `get_partitioner()`, its outputs, the CLI's layout and the refusals
    written to ``workdir/rank{rank}.pt``."""
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from ai_crypto_trader_tpu_torch import cli
    from ai_crypto_trader_tpu_torch.parallel import (
        MeshPartitioner, get_partitioner, initialize_distributed)
    from ai_crypto_trader_tpu_torch.parallel import mesh as tmesh

    before = type(get_partitioner()).__name__      # no group yet: the single device
    backend = initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    part = get_partitioner()
    assert isinstance(part, MeshPartitioner) and part.mesh.spans_processes
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    res = {"before": before, "backend": backend, "devices": part.device_count,
           "describe": part.describe()}
    res["seconds"] = {}
    for name, fn in SEAMS.items():
        t0 = time.perf_counter()
        res[name] = fn(part, inp)
        res["seconds"][name] = time.perf_counter() - t0
    res["hpo_farmed"] = res["hpo"].pop("farmed_here")        # this rank's trials alone
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["mesh", "--pop", "10"])
        cli.main(["status"])
    res["cli"] = buf.getvalue()
    from ai_crypto_trader_tpu_torch.utils import meshprof

    mp = meshprof.MeshProf()
    with meshprof.use(mp):
        part.population_eval(lambda t: {"sq": t * t}, name="toy")(torch.ones(10, 4))
    res["layout"] = mp.layouts["toy"].to_dict()
    try:                                           # a rank with another population
        part.population_eval(lambda t: t * 2.0)(torch.zeros(10 + rank))
        res["refused"] = None
    except ValueError as e:
        res["refused"] = str(e)
    res["transport"] = tmesh.TRANSPORT.counts()
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    return env


def _start_group(argv_of, world: int, attempts: int = 3) -> list:
    """Start ``world`` rank subprocesses (``argv_of(rank, port)``) on a
    free port, each bounded by RANK_TIMEOUT_S; on a port clash, again on
    another.  Returns the finished processes' (returncode, stdout,
    stderr)."""
    for _ in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(argv_of(r, port), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
                 for r in range(world)]
        done = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, err = p.communicate()
            done.append((p.returncode, out, err))
        if not any("address already in use" in e.lower() for _, _, e in done):
            return done
    return done


# -- the inputs and the groups ----------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    yield _make_inputs(_REFS)
    # the JAX references hold arrays on the virtual devices: free them with
    # the module, or a later file's live-array walk in this process sees them
    _REFS.clear()


def _make_inputs(refs):
    """Every seam's inputs, made once by the port from numpy and torch
    seeds, the same values as JAX arrays for the JAX references, and the
    JAX draws of the GA, `lob_sweep` and the PBT fleet recorded in the
    single device's run (which is kept in ``refs`` as that seam's
    reference)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_torch_ga import JaxDraws
    from test_torch_generator import _port, _structures as jax_structures
    from test_torch_population import _cfgs, _jax_pop_draws, _pcfgs
    from test_torch_sim import JaxMarketDraws
    from test_torch_sim_lob import STRAT
    from test_torch_train import _features

    from ai_crypto_trader_tpu.backtest import engine as jengine
    from ai_crypto_trader_tpu.backtest import strategy as jstrategy
    from ai_crypto_trader_tpu.rl import env as jenv
    from ai_crypto_trader_tpu.strategy import generator as J
    from ai_crypto_trader_tpu_torch import convert
    from ai_crypto_trader_tpu_torch.backtest import prepare_inputs, sample_params
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.parallel import SingleDevicePartitioner
    from ai_crypto_trader_tpu_torch.rl import population
    from ai_crypto_trader_tpu_torch.strategy import generator as P

    def ohlcv(n, seed):
        return {k: v for k, v in generate_ohlcv(n=n, seed=seed).items() if k != "regime"}

    def as_jax(cls, tree):
        return cls(**{f: jnp.asarray(np.asarray(getattr(tree, f))) for f in cls._fields})

    sweep_inputs = prepare_inputs(compute_indicators(ohlcv(T_SWEEP, 3), device="cpu"),
                                  device="cpu")
    sweep_params = sample_params(torch.Generator().manual_seed(1), POP, device="cpu")
    arrays = ohlcv(4_000, 11)
    folds = [{k: np.asarray(v) for k, v in P.fold_features(
        {k: v[i * 1_400:(i + 1) * 1_400] for k, v in arrays.items()}, device="cpu").items()}
        for i in range(2)]
    structures = jax_structures() + [J.default_seed()]
    tp, _ = population.pbt_env_params(torch.Generator().manual_seed(2), num_scenarios=4,
                                      steps=256, episode_len=48, device="cpu")
    jp = jenv.EnvParams(close=jnp.asarray(tp.close.numpy()),
                        obs_table=jnp.asarray(tp.obs_table.numpy()),
                        episode_len=tp.episode_len, fee_rate=jnp.asarray(tp.fee_rate.numpy()),
                        trade_cost=jnp.asarray(np.asarray(tp.trade_cost)))
    jcfg, tcfg = _cfgs(jp)
    jpc, tpc = _pcfgs(population=POP, generations=1)
    rng = np.random.default_rng(7)
    lc_y = torch.from_numpy((rng.normal(size=(T_RING, 1)) * 1e-3).astype(np.float32))
    lc_y[:4], lc_y[-1] = float("nan"), float("nan")
    port = {
        "sweep_inputs": sweep_inputs, "sweep_params": sweep_params,
        "candles": ohlcv(T_GA, 3), "folds": folds, "structures": [_port(s) for s in structures],
        "lob_strategy": convert.sim_strategy_from_jax(STRAT, device="cpu"),
        "pbt_env": tp, "pbt_cfgs": (tcfg, tpc),
        "features": _features(100), "fake_features": _features(),
        "series": torch.from_numpy(np.asarray(arrays["close"][:T_TS], np.float32)),
        "qkv": [torch.from_numpy(rng.normal(size=(T_RING, 2, 8)).astype(np.float32))
                for _ in range(3)],
        "weight": torch.from_numpy(rng.normal(size=(T_RING, 2, 8)).astype(np.float32)),
        "lc_x": torch.from_numpy(rng.normal(size=(T_RING, 4)).astype(np.float32)),
        "lc_y": lc_y, "draws": {},
    }
    for name, base in (("ga", JaxDraws(jax.random.PRNGKey(4))),
                       ("lob", JaxMarketDraws(jax.random.PRNGKey(6))),
                       ("pbt", _jax_pop_draws(jax.random.PRNGKey(6), tcfg, POP))):
        rec = _Recorder(base)
        refs[(name, None)] = SEAMS[name](SingleDevicePartitioner(), port, rec)
        port["draws"][name] = rec.calls
    jaxside = {"inputs": as_jax(jengine.BacktestInputs, sweep_inputs),
               "params": as_jax(jstrategy.StrategyParams, sweep_params),
               "folds": folds, "structures": structures, "pbt": (jp, jcfg, jpc)}
    return port, jaxside


@pytest.fixture(scope="module")
def groups(inputs):
    """{world: [rank outputs]}: both groups run at once, every rank a
    subprocess of this file bounded by RANK_TIMEOUT_S."""
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {w: os.path.join(tmp, f"world{w}") for w in WORLDS}
        for d in dirs.values():
            os.makedirs(d)
            torch.save(inputs[0], os.path.join(d, "inputs.pt"))
        me = os.path.abspath(__file__)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(WORLDS)) as pool:
            futures = {w: pool.submit(_start_group, lambda r, port, w=w: [
                sys.executable, me, str(r), str(w), str(port), dirs[w]], w) for w in WORLDS}
            done = {w: f.result() for w, f in futures.items()}
        out = {}
        for w, ranks in done.items():
            for r, (rc, _, err) in enumerate(ranks):
                assert rc == 0, f"world {w} rank {r} exited {rc}:\n{err[-3000:]}"
            out[w] = [torch.load(os.path.join(dirs[w], f"rank{r}.pt"), weights_only=False)
                      for r in range(w)]
        return out


_REFS: dict = {}


def _ref(name, world, inputs, refs=_REFS):
    """The seam on the port's single device (world None) or on its
    one-controller mesh of ``world`` CPU shards, computed once (kept in
    ``refs``)."""
    from ai_crypto_trader_tpu_torch.parallel import (
        MeshPartitioner, SingleDevicePartitioner, make_mesh)

    key = (name, world)
    if key not in refs:
        part = (SingleDevicePartitioner() if world is None
                else MeshPartitioner(make_mesh(world, devices=["cpu"] * world)))
        refs[key] = SEAMS[name](part, inputs[0])
    return refs[key]


def _leaves(tree, path=""):
    """(path, leaf) pairs of a tree of dicts, lists, tuples and leaves."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _same_bits(a, b, what):
    """Two trees equal bit for bit: tensors and arrays by dtype, shape and
    bytes (NaN where NaN), everything else by ``==``."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        if torch.is_tensor(x) or isinstance(x, np.ndarray):
            x = x.detach().numpy() if torch.is_tensor(x) else x
            y = y.detach().numpy() if torch.is_tensor(y) else np.asarray(y)
            x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (what, p, x.dtype, y.dtype)
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), (what, p)
        elif isinstance(x, float) and np.isnan(x):
            assert isinstance(y, float) and np.isnan(y), (what, p)
        else:
            assert x == y, (what, p, x, y)


def _ranks(groups, world, name):
    """Seam ``name``'s outputs of every rank of the group, held identical;
    returns rank 0's."""
    ranks = groups[world]
    for r, res in enumerate(ranks[1:], 1):
        _same_bits(res[name], ranks[0][name], f"{name}: rank {r} against rank 0")
    return ranks[0][name]


# -- the group itself -------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_the_group_is_the_default_mesh(groups, world):
    """After `initialize_distributed` (gloo for the CPU) `get_partitioner()`
    is the process mesh over every rank, where before it was the single
    device; its layout and a program's layout card name the ranks, the
    backend and the gather's bytes, and nothing was staged on the CPU."""
    for r, res in enumerate(groups[world]):
        assert res["before"] == "SingleDevicePartitioner"
        assert res["backend"] == "gloo" and res["devices"] == world
        d = res["describe"]
        assert (d["kind"], d["ranks"], d["rank"], d["backend"]) == \
            ("MeshPartitioner", world, r, "gloo")
        assert (d["local_shards"], d["local_device_names"]) == (1, ["cpu"])
        assert d["device_names"] == ["cpu"] * world and d["platform"] == "cpu"
        t = res["transport"]
        assert t["collectives"] > 0 and t["bytes"] > 0 and t["staging_copies"] == 0
        pad = (-10) % world
        assert res["layout"] == {
            "program": "toy", "population": 10, "pad": pad, "padded": 10 + pad,
            "devices": world, "pad_fraction": round(pad / (10 + pad), 6),
            "members_per_device": (10 + pad) / world,
            "collective_bytes": (10 + pad) * 4 * 4 * (world - 1), "ranks": world,
            "local_shards": 1, "backend": "gloo"}


@pytest.mark.parametrize("world", WORLDS)
def test_cli_mesh_and_status_print_the_process_mesh(groups, world):
    pad = (-10) % world
    for res in groups[world]:
        assert f'"ranks": {world}' in res["cli"] and '"backend": "gloo"' in res["cli"]
        assert f"population 10 on {world} device(s): pad {pad} → {10 + pad} lanes" in res["cli"]
        assert '"live": false' in res["cli"]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_holding_other_populations_raise(groups, world):
    for res in groups[world]:
        assert res["refused"] is not None and "different populations" in res["refused"]


# -- the seams ----------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sweep(groups, inputs, world):
    from test_torch_backtest import assert_stats_equal

    from ai_crypto_trader_tpu import backtest as jbt
    from ai_crypto_trader_tpu_torch.backtest import BacktestStats

    got = _ranks(groups, world, "sweep")
    _same_bits(got, _ref("sweep", None, inputs), "sweep: the single device")
    _same_bits(got, _ref("sweep", world, inputs), "sweep: the one-controller mesh")
    if ("sweep", "jax") not in _REFS:
        _REFS[("sweep", "jax")] = jbt.sweep(inputs[1]["inputs"], inputs[1]["params"])
    assert_stats_equal(_REFS[("sweep", "jax")], BacktestStats(**got))


@pytest.mark.parametrize("world", WORLDS)
def test_run_ga(groups, inputs, world):
    import jax
    import jax.numpy as jnp
    from test_torch_ga import _jax_cfg

    from ai_crypto_trader_tpu.backtest import default_params as jax_default_params
    from ai_crypto_trader_tpu.evolve import ga as jga
    from ai_crypto_trader_tpu_torch.config import GAParams

    got = _ranks(groups, world, "ga")
    _same_bits(got, _ref("ga", None, inputs), "ga: the single device")
    _same_bits(got, _ref("ga", world, inputs), "ga: the one-controller mesh")
    if ("ga", "jax") not in _REFS:
        jfit = jga.backtest_fitness({k: jnp.asarray(v) for k, v in inputs[0]["candles"].items()})
        _REFS[("ga", "jax")] = jga.run_ga(jax.random.PRNGKey(4), jfit,
                                          _jax_cfg(GAParams(**GA_KW)),
                                          seed_params=jax_default_params())
    b_ref, h_ref = _REFS[("ga", "jax")]
    for f, v in zip(b_ref._fields, got["best"]):
        assert float(v) == float(getattr(b_ref, f)), f
    for hg, hr in zip(got["history"], h_ref, strict=True):
        for k in ("best_fitness", "mean_fitness", "diversity"):
            np.testing.assert_allclose(hg[k], hr[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_tenant_engine(groups, inputs, world):
    from test_torch_tenant import PERMISSIVE, SYMS, _feat_stream, _same

    from ai_crypto_trader_tpu.config import TradingParams as JTradingParams
    from ai_crypto_trader_tpu.obs import fleetscope as jfleetscope
    from ai_crypto_trader_tpu.ops import tenant_engine as jte

    got = _ranks(groups, world, "tenant")
    one = _ref("tenant", None, inputs)
    for tick in one:
        tick["devices"] = world
    _same_bits(got, one, "tenant: the single device")
    _same_bits(got, _ref("tenant", world, inputs), "tenant: the one-controller mesh")
    jeng = jte.TenantEngine(SYMS, 16, trading=JTradingParams(**PERMISSIVE), pad_pow2=False)
    jeng.set_tenant(3, balance=500.0)
    jeng._state_np["qty"][5, 0] = np.nan
    jeng._need_seed = True
    scope = jfleetscope.FleetScope(top_k=4)
    for t, feats in enumerate(_feat_stream(jeng.S, ticks=3)):
        with jfleetscope.use(scope):
            jout = jeng.decide(feats)
        _same(got[t]["out"], jout, f"tick {t} out")
        _same(got[t]["state"], jeng._state_np, f"tick {t} state")
        _same(got[t]["fleet"], {a: np.asarray(v) for a, v in jeng.last_fleet.items()},
              f"tick {t} fleet")


@pytest.mark.parametrize("world", WORLDS)
def test_lob_sweep(groups, inputs, world):
    import jax
    from test_torch_sim_lob import STRAT, _flips, assert_summary_follows

    from ai_crypto_trader_tpu.sim import lob as jlob

    got = _ranks(groups, world, "lob")
    one = _ref("lob", None, inputs)
    _same_bits({k: got[k] for k in ("summary", "device")},
               {k: one[k] for k in ("summary", "device")}, "lob: the single device")
    _same_bits(got, _ref("lob", world, inputs), "lob: the one-controller mesh")
    assert got["stats"]["devices"] == world
    if ("lob", "jax") not in _REFS:
        _REFS[("lob", "jax")] = jlob.lob_sweep(jax.random.PRNGKey(6), strategy=STRAT, **LOB_KW)
    ref = _REFS[("lob", "jax")]
    B, T = LOB_KW["num_scenarios"], LOB_KW["steps"]
    close, rclose = got["device"]["close"].numpy(), np.asarray(ref["device"]["close"])
    start = np.full((B, 1), np.float32(40_000.0))
    _, first = _flips({"open": np.concatenate([start, close[:, :-1]], 1), "close": close},
                      {"open": np.concatenate([start, rclose[:, :-1]], 1), "close": rclose})
    assert assert_summary_follows(got["summary"], jax.tree.map(np.asarray, ref["summary"]),
                                  T, first) >= B // 2


@pytest.mark.parametrize("world", WORLDS)
def test_train_pbt_generation(groups, inputs, world):
    import jax
    from test_torch_population import _assert_rows_follow
    from test_torch_rl import jax_leaves

    from ai_crypto_trader_tpu.rl import population as jpop

    got = _ranks(groups, world, "pbt")
    _same_bits(got, _ref("pbt", None, inputs), "pbt: the single device")
    _same_bits(got, _ref("pbt", world, inputs), "pbt: the one-controller mesh")
    jp, jcfg, jpc = inputs[1]["pbt"]
    if ("pbt", "jax") not in _REFS:
        _REFS[("pbt", "jax")] = jpop.train_pbt(jax.random.PRNGKey(6), jp, jcfg, jpc)
    ref = _REFS[("pbt", "jax")]
    _assert_rows_follow(got["history"], ref.history)
    assert got["best_member"] == ref.best_member
    _state_follows(got["members"], jax_leaves(ref.state.members))


def _state_follows(got, ref):
    """tests/test_torch_rl.py's `assert_state_follows` on leaves already
    named."""
    from test_torch_rl import EXACT, PARAM_ATOL, PARAM_RTOL

    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if k.startswith(EXACT):
            np.testing.assert_array_equal(g.astype(r.dtype), r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_evaluate_structures(groups, inputs, world):
    from test_torch_generator import SHARPE_ATOL, SHARPE_RTOL

    from ai_crypto_trader_tpu.strategy import generator as J

    got = _ranks(groups, world, "structures")
    single = _ref("structures", None, inputs)
    _same_bits(got, single, "structures: the single device")
    _same_bits(got, _ref("structures", world, inputs), "structures: the one-controller mesh")
    if ("structures", "jax") not in _REFS:
        _REFS[("structures", "jax")] = J.evaluate_structures(inputs[1]["folds"],
                                                             inputs[1]["structures"])
    ref = _REFS[("structures", "jax")]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    close = np.isclose(single, ref, rtol=SHARPE_RTOL, atol=SHARPE_ATOL) | np.isinf(ref)
    assert close.sum() >= len(got) - 2
    np.testing.assert_allclose(got[close], ref[close], rtol=SHARPE_RTOL, atol=SHARPE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_hpo_farm(groups, inputs, world, monkeypatch):
    """Trial i on rank i mod world: the single device's trials and losses
    bit for bit; with the training faked, JAX's trial sequence (TPE
    included, its proposals waiting for every rank's losses so far)."""
    import jax
    from test_torch_train import _fake_train

    from ai_crypto_trader_tpu.models import hpo as jhpo

    got = _ranks(groups, world, "hpo")
    one = _ref("hpo", None, inputs)
    assert got["real"] == one["real"] and got["fake"] == one["fake"]
    assert got["real"] == _ref("hpo", world, inputs)["real"]
    # every rank farmed its own trials: 4 + 2 real, 9 + 3 faked
    farmed = [res["hpo_farmed"] for res in groups[world]]
    assert farmed == [len(range(r, 4, world)) + len(range(r, 2, world)) for r in range(world)]
    monkeypatch.setattr(jhpo, "train_model", _fake_train)
    ref = jhpo.optimize_hyperparameters(jax.random.PRNGKey(0), inputs[0]["fake_features"],
                                        **HPO_FAKE_KW)
    assert got["fake"] == ref


@pytest.mark.parametrize("world", WORLDS)
def test_time_shard(groups, inputs, world):
    """`sharded_ema` bit for bit against the one-controller mesh and within
    chip_smoke.py's tolerance of JAX's unsplit `ema`; `sharded_rolling_mean`
    bit for bit against the single device's `rolling_mean`."""
    import jax
    import jax.numpy as jnp

    from ai_crypto_trader_tpu.ops import indicators as jind
    from ai_crypto_trader_tpu_torch.ops import indicators as ind

    got = _ranks(groups, world, "time_shard")
    _same_bits(got, _ref("time_shard", world, inputs), "time_shard: the one-controller mesh")
    x = inputs[0]["series"]
    for w in EMA_WINDOWS:
        want = np.asarray(jax.jit(jind.ema, static_argnums=1)(jnp.asarray(x.numpy()), w))
        g = got[f"ema_{w}"].numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(g[ok], want[ok], rtol=TS_RTOL, atol=TS_ATOL)
    for w in MEAN_WINDOWS:
        _same_bits(got[f"mean_{w}"], ind.rolling_mean(x, w), f"rolling_mean({w})")
        want = np.asarray(jax.jit(jind.rolling_mean, static_argnums=1)(jnp.asarray(x.numpy()),
                                                                      w))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[f"mean_{w}"].numpy()[ok], want[ok], rtol=TS_RTOL,
                                   atol=MEAN_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_and_its_gradient(groups, inputs, world):
    """The ring over the ranks (K/V rotating by send/recv, the gradient
    rotating back) against the one-controller ring and the dense attention
    of the port and of JAX, forward and gradient; the long-context model
    (two ring layers) against the one-controller ring's."""
    import jax
    import jax.numpy as jnp

    from ai_crypto_trader_tpu.parallel.ring_attention import reference_attention as jref

    got = _ranks(groups, world, "ring")
    ctl = _ref("ring", world, inputs)
    q, k, v = (t.numpy() for t in inputs[0]["qkv"])
    w = inputs[0]["weight"].numpy()
    dense = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    dgrads = jax.grad(lambda q, k, v: jnp.sum(jref(q, k, v, causal=True) * w),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for ref in (ctl["out"].numpy(), np.asarray(dense)):
        np.testing.assert_allclose(got["out"].numpy(), ref, rtol=LC_TOL, atol=LC_TOL)
    for g, c, d in zip(got["grads"], ctl["grads"], dgrads):
        for ref in (c.numpy(), np.asarray(d)):
            np.testing.assert_allclose(g.numpy(), ref, rtol=LC_GRAD_RTOL, atol=LC_GRAD_ATOL)
    np.testing.assert_allclose(got["lc_loss"].numpy(), ctl["lc_loss"].numpy(), rtol=LC_TOL)
    for g, c in zip(got["lc_grads"], ctl["lc_grads"], strict=True):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=LC_GRAD_RTOL, atol=LC_GRAD_ATOL)


# -- bring-up and refusals -------------------------------------------------------------

_SHARED_CARD = r"""
import sys, torch
torch.cuda.is_available = lambda: True        # two ranks, one (pretended) card
torch.cuda.device_count = lambda: 1
torch.cuda.set_device = lambda d: None
from ai_crypto_trader_tpu_torch.parallel import initialize_distributed
from ai_crypto_trader_tpu_torch.parallel.mesh import process_group
rank, port = int(sys.argv[1]), sys.argv[2]
backend = initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda")
info = process_group()
print(backend, info.local_rank, info.local_world, ",".join(info.devices), info.group is None)
"""


def test_ranks_that_share_one_card_take_gloo():
    """Two ranks on one host with one card: NCCL refuses two ranks on one
    device, so `initialize_distributed` picks gloo, both on cuda:0."""
    done = _start_group(lambda r, port: [sys.executable, "-c", _SHARED_CARD, str(r),
                                         str(port)], 2)
    for r, (rc, out, err) in enumerate(done):
        assert rc == 0, err[-2000:]
        assert out.split() == ["gloo", str(r), "2", "cuda:0,cuda:0", "True"]


_FAKE_NVCC = r"""#!/usr/bin/env python3
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
marks = os.path.join(os.path.dirname(out), "marks")
os.makedirs(marks, exist_ok=True)
open(os.path.join(marks, str(os.getpid())), "w").close()
t0 = time.time()                   # both builds under way before either writes
while len(os.listdir(marks)) < 2 and time.time() - t0 < 60:
    time.sleep(0.01)
with open(out, "wb") as f:
    for i in range(64):            # the library written piece by piece
        f.write(bytes([i]) * 4096)
        f.flush()
        time.sleep(0.005)
"""

_BUILD = r"""
import sys
from pathlib import Path
from ai_crypto_trader_tpu_torch.ops import _cuda
_cuda.SOURCE_DIR, nvcc = Path(sys.argv[1]), sys.argv[2]
_cuda.nvcc_path = lambda: nvcc
_cuda.set_build_dir(sys.argv[3])
print(_cuda.build(["probe"])["probe"]["cached"], _cuda.library_path("probe"))
"""


def test_two_ranks_building_one_library_at_once_leave_it_whole(tmp_path, monkeypatch):
    """Two processes build the same library into one directory at once
    (the ranks of a group sharing a checkout): each compiles to a file of
    its own and renames it into place, so the library is whole whenever it
    is there (read here while they build) and no partial file is left."""
    from ai_crypto_trader_tpu_torch.ops import _cuda

    src = tmp_path / "src"
    src.mkdir()
    (src / "probe.cu").write_text("// a source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    out = tmp_path / "kernels"
    monkeypatch.setattr(_cuda, "SOURCE_DIR", src)
    monkeypatch.setattr(_cuda, "BUILD_DIR", out)
    lib, whole = _cuda.library_path("probe"), b"".join(bytes([i]) * 4096 for i in range(64))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(src), str(nvcc), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=ROOT) for _ in range(2)]
    seen, deadline = [], time.monotonic() + RANK_TIMEOUT_S
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if lib.exists():
            seen.append(lib.read_bytes() == whole)
        time.sleep(0.001)
    done = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in done]
    assert [o.split() for o, _ in done] == [["False", str(lib)]] * 2      # both built
    assert all(seen) and sorted(os.listdir(out)) == sorted(["marks", lib.name])
    assert lib.read_bytes() == whole


def test_plan_gives_each_rank_its_card_and_backend():
    from ai_crypto_trader_tpu_torch.parallel.mesh import _plan

    dev = torch.device
    assert _plan(["a", "a"], 1, False, 0) == (1, 2, dev("cpu"), "gloo")
    assert _plan(["a", "a"], 1, True, 1) == (1, 2, dev("cuda", 0), "gloo")
    assert _plan(["a", "a"], 1, True, 2) == (1, 2, dev("cuda", 1), "nccl")
    assert _plan(["a", "b", "a"], 2, True, 2) == (1, 2, dev("cuda", 1), "nccl")
    assert _plan(["a", "a", "a"], 2, True, 2) == (2, 3, dev("cuda", 0), "gloo")
    # several cards a rank: the home card is the first of the rank's block
    assert _plan(["a", "a"], 1, True, 4) == (1, 2, dev("cuda", 2), "nccl")
    assert _plan(["a"], 0, True, 8) == (0, 1, dev("cuda", 0), "nccl")
    with pytest.raises(ValueError, match="3 CUDA cards do not split evenly among the 2"):
        _plan(["a", "a"], 1, True, 3)


@pytest.mark.parametrize("local_rank", [0, 1])
def test_a_rank_with_several_local_cards_takes_its_block(monkeypatch, local_rank):
    """The default plan (no group needed: the group's record is patched):
    4 cards among a host's 2 ranks give each rank a contiguous block of 2,
    numbered rank-major, and `default_mesh()` builds it with no collective
    (every exchange raises); 3 cards among 2 raise; ranks that share a
    card keep one shard a rank over gloo; an explicit list is exchanged."""
    import torch.distributed as dist

    from ai_crypto_trader_tpu_torch.parallel import mesh as tmesh

    def no_collective(*args, **kwargs):
        raise AssertionError("the default mesh ran a collective")

    assert [tmesh.local_cards(r, 2, 4) for r in range(2)] == \
        [[torch.device("cuda", 2 * r + j) for j in range(2)] for r in range(2)]
    with pytest.raises(ValueError, match="3 CUDA cards do not split evenly among the 2"):
        tmesh.local_cards(local_rank, 2, 3)
    info = tmesh.ProcessGroupInfo(
        rank=local_rank, world=2, local_rank=local_rank, local_world=2, backend="nccl",
        device=torch.device("cuda", 2 * local_rank),
        rank_devices=(("cuda:0", "cuda:1"), ("cuda:2", "cuda:3")), cards=4,
        group=None, world_group=None, token=-1 - local_rank)
    group = {"info": info}
    monkeypatch.setattr(tmesh, "process_group", lambda: group["info"])
    monkeypatch.setattr(tmesh, "all_gather_object", no_collective)
    monkeypatch.setattr(dist, "all_gather_object", no_collective)
    tmesh.default_mesh.cache_clear()
    mesh = tmesh.default_mesh()
    tmesh.default_mesh.cache_clear()
    mine = [torch.device("cuda", 2 * local_rank + j) for j in range(2)]
    assert mesh.spans_processes and mesh.world == 2 and mesh.local_count == 2
    assert mesh == tmesh.process_mesh() and info.devices == ("cuda:0", "cuda:2")
    assert mesh.local_devices == mine and mesh.local_device == info.device
    assert mesh.shape == {"data": 4, "model": 1} and mesh.first_shard == 2 * local_rank
    assert [str(d) for d in mesh.axis_devices()] == [f"cuda:{i}" for i in range(4)]
    assert mesh.own_shards() == list(zip(range(2 * local_rank, 2 * local_rank + 2), mine))
    assert mesh != tmesh.make_mesh(4, devices=[f"cuda:{i}" for i in range(4)])
    with pytest.raises(ValueError, match="list cuda"):      # NCCL runs on the home card
        tmesh.process_mesh(local_devices=["cuda:3", "cuda:2"])
    monkeypatch.setattr(tmesh, "all_gather_object", lambda obj, info: [
        [f"cuda:{2 * r + j}" for j in range(len(obj))] if r != info.rank else obj
        for r in range(info.world)])
    named = tmesh.process_mesh(local_devices=[info.device])
    assert named.local_count == 1 and named.shape["data"] == 2
    group["info"] = info._replace(cards=1, backend="gloo", device=torch.device("cuda", 0),
                                  rank_devices=(("cuda:0",), ("cuda:0",)))
    shared = tmesh.process_mesh()
    assert shared.local_count == 1 and shared.local_devices == [torch.device("cuda", 0)]
    assert shared.backend == "gloo" and shared.shape["data"] == 2

if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
