"""The port's trading env and DQN against the JAX package, on the CPU.

    make_env_params ↔ rl.env.make_env_params (1-D, [S, T] with extra
    features and a [S, T] trade cost);  env_reset / env_step ↔ the JAX
    functions on the same draws;  QNetwork ↔ flax;  the DQN's Adam ↔
    optax.scale_by_adam plus −lr;  train_iterations, train_dqn and
    evaluate_policy ↔ the JAX functions given the JAX key schedule's draws
    (`JaxDraws`, which later test files import).

Tolerances, and why:
  * the env table, resets and steps: bit for bit (the same float32
    operations in the same order);
  * Q values: atol 1e-6 (the products sum in other orders than XLA's);
  * actions, replay contents, ε, learn steps: equal, but for a near-tie of
    the greedy action — two Q values within 1e-5 of their scale, where the
    products' last bits choose.  The comparison stops at the first and
    reports it; none happens at these seeds, and none is looked for;
  * parameters, target parameters and Adam moments: atol 1e-6, rtol 1e-5
    (each gradient sums its batch in another order; Adam scales g by
    1/|g|);
  * metrics: rtol 1e-5 (means reduced in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.ops import compute_indicators as jax_indicators  # noqa: E402
from ai_crypto_trader_tpu.rl import dqn as jdqn  # noqa: E402
from ai_crypto_trader_tpu.rl import env as jenv  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.models import train_loop  # noqa: E402
from ai_crypto_trader_tpu_torch.rl import dqn, env  # noqa: E402
from ai_crypto_trader_tpu_torch.rl.draws import RolloutDraws  # noqa: E402

Q_ATOL = 1e-6
TIE_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5
METRIC_RTOL = 1e-5
CFG = dict(num_envs=4, rollout_len=4, hidden=(8,), replay_capacity=64, batch_size=8,
           learn_steps_per_iter=2, target_sync_every=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ind(n=400, seed=0):
    d = {k: v for k, v in generate_ohlcv(n=n, seed=seed).items() if k != "regime"}
    return {k: np.asarray(v) for k, v in jax_indicators(d).items()}


def _scenario_ind(S=3, n=300):
    rows = [_ind(n, seed=10 + s) for s in range(S)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _both_envs(ind, **kw):
    return (jenv.make_env_params({k: jnp.asarray(v) for k, v in ind.items()}, **kw),
            env.make_env_params(ind, device="cpu", **kw))


# -- the JAX key schedule's draws ------------------------------------------------

def _reset_draw(key, S, hi, scenario):
    if scenario:
        k_scen, key = jax.random.split(key)
        scen = jax.random.randint(k_scen, (), 0, S)
    else:
        scen = jnp.asarray(0, jnp.int32)
    return scen, jax.random.randint(key, (), 0, jnp.maximum(hi, 1))


def _resets(key, N, S, hi, scenario):
    return jax.vmap(lambda k: _reset_draw(k, S, hi, scenario))(jax.random.split(key, N))


def _rollout(key, R, N, A, S, hi, scenario):
    def step(key, _):
        key, k_act, k_step = jax.random.split(key, 3)
        k_eps, k_rand = jax.random.split(k_act)
        u = jax.random.uniform(k_eps, (N,))
        a = jax.random.randint(k_rand, (N,), 0, A)
        scen, start = _resets(k_step, N, S, hi, scenario)
        return key, (u, a, scen, start)
    return jax.lax.scan(step, key, None, length=R)


def _learn_idx(key, L, B, size):
    def step(key, _):
        key, k = jax.random.split(key)
        return key, jax.random.randint(k, (B,), 0, jnp.maximum(size, 1))
    return jax.lax.scan(step, key, None, length=L)


_J_ROLLOUT = jax.jit(jax.vmap(_rollout, in_axes=(0,) + (None,) * 6),
                     static_argnums=(1, 2, 3, 4, 5, 6))
_J_LEARN = jax.jit(jax.vmap(_learn_idx, in_axes=(0, None, None, 0)), static_argnums=(1, 2))
_J_RESETS = jax.jit(jax.vmap(_resets, in_axes=(0,) + (None,) * 4), static_argnums=(1, 2, 3, 4))


class JaxDraws:
    """A draw provider holding the JAX package's member keys [P, 2] and
    replaying its key schedule: `dqn_init`'s ``k_net, k_env, key =
    split(key, 3)``, each rollout step's ``key, k_act, k_step = split(key,
    3)``, each learn step's ``key, k_learn = split(key)``; the greedy
    evaluation from ``fold_in(key, 0x5EED)``; the exchange from
    ``fold_in(root, g + 1)`` and a clone's key ``fold_in(key[lineage],
    lineage)``.  ``keys`` is a single key (the single agent) or a
    population's ``split(key, P)``; ``root`` is the key the exchange folds
    from; ``scenario`` tells whether the env's tables are [S, T]."""

    def __init__(self, keys, cfg, scenario: bool, root=None):
        keys = jnp.asarray(keys)
        self.keys = keys[None] if keys.ndim == 1 else keys
        self.cfg, self.scenario, self.root = cfg, scenario, root

    def init_params(self, build, P):
        assert P == self.keys.shape[0]
        out, rest = [], []
        for k in self.keys:
            k_net, k_env, key = jax.random.split(k, 3)
            net = jdqn.QNetwork(self.cfg.hidden, self.cfg.n_actions)
            p = net.init(k_net, jnp.zeros((1, self.cfg.state_size)))
            out.append(convert.q_params_from_flax(p, device="cpu"))
            rest.append((k_env, key))
        self._env_keys = jnp.stack([e for e, _ in rest])
        self.keys = jnp.stack([k for _, k in rest])
        return out

    def resets(self, P, N, bounds):
        scen, start = _J_RESETS(self._env_keys, N, bounds[0], bounds[1], self.scenario)
        return torch.from_numpy(np.array(scen)), torch.from_numpy(np.array(start))

    def rollout(self, R, P, N, n_actions, bounds):
        self.keys, (u, a, scen, start) = _J_ROLLOUT(self.keys, R, N, n_actions, bounds[0],
                                                    bounds[1], self.scenario)
        t = lambda x: torch.from_numpy(np.array(x)).transpose(0, 1).contiguous()  # noqa: E731
        return RolloutDraws(t(u), t(a).long(), t(scen).long(), t(start).long())

    def replay_indices(self, L, batch, size):
        self.keys, idx = _J_LEARN(self.keys, L, batch, jnp.asarray(size.numpy(), jnp.int32))
        return torch.from_numpy(np.array(idx)).transpose(0, 1).long()

    def eval_resets(self, P, N, bounds):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, 0x5EED))(self.keys)
        scen, start = _J_RESETS(keys, N, bounds[0], bounds[1], self.scenario)
        return torch.from_numpy(np.array(scen)), torch.from_numpy(np.array(start))

    def exchange(self, generation, P, n):
        key = jax.random.fold_in(self.root, generation + 1)
        k_donor, k_jit = jax.random.split(key)
        pick = jax.random.randint(k_donor, (n,), 0, n)
        coins = jnp.stack([jax.random.bernoulli(k, 0.5, (P,))
                           for k in jax.random.split(k_jit, 5)])
        return torch.from_numpy(np.array(pick)).long(), torch.from_numpy(np.array(coins))

    def fork(self, lineage):
        lin = jnp.asarray(lineage.numpy(), jnp.int32)
        keys = self.keys[lin]
        forked = jax.vmap(jax.random.fold_in)(keys, lin)
        cloned = lin != jnp.arange(lin.shape[0])
        self.keys = jnp.where(cloned[:, None], forked, keys)


class JaxEvalDraws:
    """`evaluate_policy`'s draws: its resets from ``split(key, N)``."""

    def __init__(self, key, scenario):
        self.key, self.scenario = key, scenario

    def eval_resets(self, P, N, bounds):
        scen, start = _J_RESETS(self.key[None], N, bounds[0], bounds[1], self.scenario)
        return torch.from_numpy(np.array(scen)), torch.from_numpy(np.array(start))


# -- comparisons -------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_leaves(state) -> dict:
    """A JAX DQNState's arrays under the port's `dqn.tensor_leaves` names."""
    out = {}
    for group in ("params", "target_params"):
        for layer, leaves in getattr(state, group)["params"].items():
            for name, v in leaves.items():
                out[f"{group}.{layer}.{name}"] = np.asarray(v)
    adam = state.opt_state
    out["opt_state.count"] = np.asarray(adam.count)
    for m in ("mu", "nu"):
        for layer, leaves in getattr(adam, m)["params"].items():
            for name, v in leaves.items():
                out[f"opt_state.{m}.{layer}.{name}"] = np.asarray(v)
    out.update({f"replay.{k}": np.asarray(v) for k, v in state.replay._asdict().items()})
    out.update({f"env_states.{k}": np.asarray(v) for k, v in state.env_states._asdict().items()})
    out.update(obs=np.asarray(state.obs), epsilon=np.asarray(state.epsilon),
               learn_steps=np.asarray(state.learn_steps))
    return out


EXACT = ("replay.actions", "replay.dones", "replay.ptr", "replay.size", "opt_state.count",
         "env_states.", "learn_steps", "epsilon", "replay.rewards", "replay.obs",
         "replay.next_obs", "obs")


def assert_state_follows(got, ref, label):
    """The port's state ``got`` against the JAX state's leaves ``ref``:
    EXACT names bit for bit (as values), the float parameters and moments
    within PARAM_ATOL / PARAM_RTOL."""
    got = {k: _np(v) for k, v in dqn.tensor_leaves(got).items()}
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, (label, k, g.shape, r.shape)
        if k.startswith(EXACT):
            np.testing.assert_array_equal(g.astype(r.dtype), r, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(g, r, atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{label} {k}")


def first_action_difference(params, obs, got_a, ref_a):
    """Where the greedy actions ``got_a`` and ``ref_a`` first differ: None,
    or (index, Q gap over scale) — a near-tie if within TIE_RTOL."""
    diff = np.flatnonzero(np.asarray(got_a).reshape(-1) != np.asarray(ref_a).reshape(-1))
    if diff.size == 0:
        return None
    q = _np(dqn.q_values(params, obs)).reshape(-1, 3)
    i = int(diff[0])
    g, r = int(np.asarray(got_a).reshape(-1)[i]), int(np.asarray(ref_a).reshape(-1)[i])
    gap = abs(q[i, g] - q[i, r]) / max(np.abs(q[i]).max(), 1e-30)
    return i, gap


# -- env ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["single", "scenarios_extra_cost"])
def test_make_env_params_bit_equal(case):
    if case == "single":
        ind, kw = _ind(), dict(episode_len=64, fee_rate=0.001)
    else:
        ind = _scenario_ind()
        rng = np.random.default_rng(1)
        kw = dict(episode_len=48, fee_rate=0.0005,
                  extra_features=rng.normal(size=ind["close"].shape + (2,)).astype(np.float32),
                  trade_cost=rng.uniform(0, 1e-3, ind["close"].shape).astype(np.float32))
    jp, tp = _both_envs(ind, **kw)
    np.testing.assert_array_equal(tp.close.numpy(), np.asarray(jp.close))
    np.testing.assert_array_equal(tp.obs_table.numpy(), np.asarray(jp.obs_table))
    assert tp.episode_len == jp.episode_len
    assert float(tp.fee_rate) == float(jp.fee_rate)
    if case != "single":
        np.testing.assert_array_equal(tp.trade_cost.numpy(), np.asarray(jp.trade_cost))
    assert env.obs_size(tp) == jenv.obs_size(jp)
    env.assert_transfer_compatible(tp, tp)
    with pytest.raises(ValueError):
        env.assert_transfer_compatible(tp, tp._replace(episode_len=tp.episode_len + 1))


@pytest.mark.parametrize("scenario", [False, True])
def test_env_reset_and_step_bit_equal(scenario):
    """64 steps of random actions with fees on (and a [S, T] trade cost on
    the scenario env), from resets on the same draws; done envs keep
    stepping, past the end of the table (both clamp the index)."""
    if scenario:
        ind = _scenario_ind()
        cost = np.random.default_rng(2).uniform(0, 1e-3, ind["close"].shape).astype(np.float32)
        jp, tp = _both_envs(ind, episode_len=32, fee_rate=0.001, trade_cost=cost)
    else:
        jp, tp = _both_envs(_ind(), episode_len=32, fee_rate=0.001)
    N = 16
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    js, jo = jax.vmap(lambda k: jenv.env_reset(jp, k))(keys)
    S, hi = env.reset_bounds(tp)
    scen, start = _J_RESETS(jax.random.PRNGKey(5)[None], N, S, hi, scenario)
    ts, to = env.env_reset(tp, torch.from_numpy(np.array(scen[0])),
                           torch.from_numpy(np.array(start[0])))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    actions = np.random.default_rng(3).integers(0, 3, (64, N))
    step = jax.jit(jax.vmap(jenv.env_step, in_axes=(None, 0, 0)))
    for i in range(64):
        js, jo, jr, jd = step(jp, js, jnp.asarray(actions[i]))
        ts, to, tr, td = env.env_step(tp, ts, torch.from_numpy(actions[i]))
        for name in env.EnvState._fields:
            np.testing.assert_array_equal(_np(getattr(ts, name)).astype(np.float64),
                                          np.asarray(getattr(js, name)).astype(np.float64),
                                          err_msg=f"step {i} {name}")
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=f"step {i} obs")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=f"step {i} reward")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"step {i} done")


# -- the network and the optimizer --------------------------------------------------

def test_qnetwork_follows_flax():
    net = jdqn.QNetwork((24, 24), 3)
    p = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)))
    x = np.random.default_rng(0).normal(size=(32, 12)).astype(np.float32)
    ref = np.asarray(net.apply(p, jnp.asarray(x)))
    params = convert.q_params_from_flax(p, device="cpu")
    np.testing.assert_allclose(dqn.q_values(params, torch.from_numpy(x)).numpy(), ref,
                               atol=Q_ATOL, rtol=0)
    stacked = {k: v.unsqueeze(0).repeat(2, *([1] * v.dim())) for k, v in params.items()}
    got = dqn.q_values(stacked, torch.from_numpy(np.stack([x, x])))
    np.testing.assert_allclose(got.numpy(), np.stack([ref, ref]), atol=Q_ATOL, rtol=0)
    module = dqn.QNetwork(12, (24, 24), 3, torch.Generator().manual_seed(0))
    own = module.q_params()
    np.testing.assert_allclose(module(torch.from_numpy(x)).detach().numpy(),
                               dqn.q_values(own, torch.from_numpy(x)).numpy(), atol=Q_ATOL)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}


def test_dqn_adam_is_scale_by_adam_bit_for_bit():
    """`adam_direction` with PLAIN_C1/PLAIN_C2 and ``p + (−lr)·u`` is
    optax.scale_by_adam() then ``−lr·u`` and apply_updates, bit for bit over
    5 updates (per-member lr and count, P = 2); the injected constants give
    another first moment."""
    rng = np.random.default_rng(0)
    P, lr = 2, np.array([1e-3, 3e-2], np.float32)
    p0 = rng.normal(size=(P, 7, 5)).astype(np.float32)
    tx = optax.scale_by_adam()
    jp = [{"a": jnp.asarray(p0[i])} for i in range(P)]
    js = [tx.init(q) for q in jp]
    tp = {"a": torch.from_numpy(p0.copy())}
    count = torch.zeros(P, dtype=torch.int32)
    mu, nu = {"a": torch.zeros(P, 7, 5)}, {"a": torch.zeros(P, 7, 5)}
    for step in range(5):
        g = (rng.normal(size=(P, 7, 5)) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
        for i in range(P):
            u, js[i] = tx.update({"a": jnp.asarray(g[i])}, js[i], jp[i])
            u = jax.tree.map(lambda x: -jnp.asarray(lr[i]) * x, u)
            jp[i] = optax.apply_updates(jp[i], u)
        count, mu, nu, u = train_loop.adam_direction({"a": torch.from_numpy(g)}, count, mu, nu,
                                                     train_loop.PLAIN_C1, train_loop.PLAIN_C2)
        tp = {"a": tp["a"] + (-torch.from_numpy(lr)).reshape(P, 1, 1) * u["a"]}
        for i in range(P):
            np.testing.assert_array_equal(tp["a"][i].numpy(), np.asarray(jp[i]["a"]))
            np.testing.assert_array_equal(mu["a"][i].numpy(), np.asarray(js[i].mu["a"]))
            np.testing.assert_array_equal(nu["a"][i].numpy(), np.asarray(js[i].nu["a"]))
    injected = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    g = jnp.asarray([1.0, 3.0, 7.0], jnp.float32)
    _, st = injected.update(g, injected.init(g), g)
    _, plain = optax.scale_by_adam().update(g, optax.scale_by_adam().init(g), g)
    assert np.array_equal(np.asarray(plain.mu), np.float32(train_loop.PLAIN_C1) * np.asarray(g))
    assert np.array_equal(np.asarray(st.inner_state[0].mu),
                          np.float32(train_loop.C1) * np.asarray(g))
    assert not np.array_equal(np.asarray(st.inner_state[0].mu), np.asarray(plain.mu))


# -- the DQN given JAX's draws --------------------------------------------------------

def _dqn_case(scenario=False, key=7, **over):
    if scenario:
        ind = _scenario_ind()
        cost = np.random.default_rng(4).uniform(0, 1e-3, ind["close"].shape).astype(np.float32)
        jp, tp = _both_envs(ind, episode_len=24, fee_rate=0.001, trade_cost=cost)
    else:
        jp, tp = _both_envs(_ind(), episode_len=24, fee_rate=0.001)
    cfg_kw = dict(CFG, **over)
    jcfg = jdqn.DQNConfig(**cfg_kw)
    tcfg = dqn.DQNConfig(**cfg_kw)
    k = jax.random.PRNGKey(key)
    return jp, tp, jcfg, tcfg, k


@pytest.mark.parametrize("scenario", [False, True])
def test_train_iterations_follows_jax(scenario):
    """3 iterations from dqn_init on the same key's draws: every leaf of the
    state after each iteration as stated in the module docstring, the
    actions the replay holds equal (near-ties reported), metrics at
    METRIC_RTOL; then `train_iterations(n_iters=3)` from the same init."""
    jp, tp, jcfg, tcfg, key = _dqn_case(scenario)
    js = jdqn.dqn_init(key, jp, jcfg)
    draws = JaxDraws(key, tcfg, scenario)
    ts = dqn.dqn_init(draws, tp, tcfg)
    assert_state_follows(ts, jax_leaves(js), "init")
    t0 = ts
    jms = []
    for it in range(3):
        js, jm = jdqn.train_iteration(jp, js, jcfg)
        params_before = ts.params
        ts, tm = dqn.train_iteration(tp, ts, tcfg)
        ref = jax_leaves(js)
        tie = first_action_difference(params_before, ts.replay.obs,
                                      _np(ts.replay.actions), ref["replay.actions"])
        assert tie is None or tie[1] <= TIE_RTOL, f"iteration {it}: action differs, {tie}"
        if tie is not None:
            pytest.fail(f"iteration {it}: a near-tie at {tie}; the comparison stops there")
        assert_state_follows(ts, ref, f"iteration {it}")
        for name in dqn.METRICS:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=METRIC_RTOL,
                                       atol=1e-9, err_msg=f"iteration {it} {name}")
        jms.append(jm)
    again = dqn.dqn_init(JaxDraws(key, tcfg, scenario), tp, tcfg)
    assert_state_follows(again, jax_leaves(jdqn.dqn_init(key, jp, jcfg)), "init again")
    ts3, m3 = dqn.train_iterations(tp, again, tcfg, n_iters=3)
    for a, b in zip(dqn.tensor_leaves(ts3).values(), dqn.tensor_leaves(ts).values()):
        np.testing.assert_array_equal(_np(a), _np(b))
    for name in dqn.METRICS:
        np.testing.assert_allclose(m3[name].numpy(), [float(m[name]) for m in jms],
                                   rtol=METRIC_RTOL, atol=1e-9)
    # the state handed in is not changed
    assert_state_follows(t0, jax_leaves(jdqn.dqn_init(key, jp, jcfg)), "init kept")


def test_train_dqn_chunks_and_history_follow_jax(monkeypatch):
    """7 iterations at log_every 3: the JAX chunk rule (3, 3, 1), one host
    read a chunk, and the history rows (iterations 0, 3, 6) within
    METRIC_RTOL of the JAX run's."""
    jp, tp, jcfg, tcfg, key = _dqn_case()
    _, jhist = jdqn.train_dqn(key, jp, jcfg, iterations=7, log_every=3)
    reads, real = [], dqn.host_read
    monkeypatch.setattr(dqn, "host_read", lambda m: reads.append(
        next(iter(m.values())).shape[0]) or real(m))
    _, hist = dqn.train_dqn(JaxDraws(key, tcfg, False), tp, tcfg, iterations=7, log_every=3)
    assert reads == [3, 3, 1]
    assert [h["iter"] for h in hist] == [h["iter"] for h in jhist] == [0, 3, 6]
    for h, jh in zip(hist, jhist):
        for name in dqn.METRICS:
            np.testing.assert_allclose(h[name], jh[name], rtol=METRIC_RTOL, atol=1e-9)
    assert dqn._chunk(12, 0, None) == 12 and dqn._chunk(17, 0, None) == 16
    assert dqn._chunk(100, 10, None) == 10 and dqn._chunk(5, 0, 2) == 2


def test_evaluate_policy_follows_jax():
    jp, tp, jcfg, tcfg, key = _dqn_case(num_envs=8)
    js = jdqn.dqn_init(key, jp, jcfg)
    draws = JaxDraws(key, tcfg, False)
    ts = dqn.dqn_init(draws, tp, tcfg)
    ek = jax.random.PRNGKey(11)
    ref = jdqn.evaluate_policy(jp, js.params, jcfg, ek, n_steps=40)
    got = dqn.evaluate_policy(tp, ts.params, tcfg, JaxEvalDraws(ek, False), n_steps=40)
    np.testing.assert_allclose(float(got["mean_balance"]), float(ref["mean_balance"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["reward_trace"].numpy(), np.asarray(ref["reward_trace"]),
                               atol=1e-6, rtol=0)


def test_generator_draws_train_and_read_once(monkeypatch):
    """The default provider: a generator-seeded run is reproducible, its
    replay indices lie in the filled part of the ring, and `train_dqn`
    reads once a chunk."""
    _, tp, _, tcfg, _ = _dqn_case()
    reads, real = [], dqn.host_read
    monkeypatch.setattr(dqn, "host_read", lambda m: reads.append(1) or real(m))
    a, ha = dqn.train_dqn(torch.Generator().manual_seed(3), tp, tcfg, iterations=4)
    b, hb = dqn.train_dqn(torch.Generator().manual_seed(3), tp, tcfg, iterations=4)
    assert len(reads) == 2 and ha == hb
    for x, y in zip(dqn.tensor_leaves(a).values(), dqn.tensor_leaves(b).values()):
        assert torch.equal(x, y)
    draws = a.draws
    idx = draws.replay_indices(50, 8, torch.tensor([0, 5, 64], dtype=torch.int32))
    assert idx.shape == (50, 3, 8)
    assert (idx[:, 0] == 0).all() and (idx[:, 1] < 5).all() and (idx[:, 2] < 64).all()
    assert (idx >= 0).all()


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        env.make_env_params(_ind(300))
    with pytest.raises(RuntimeError, match="CUDA"):
        dqn.hypers_from_config(dqn.DQNConfig())
