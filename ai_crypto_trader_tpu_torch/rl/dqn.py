"""DQN on the card: a fleet of agents, each with its parallel envs and its
replay ring, stepped as stacked tensors.

Port of `ai_crypto_trader_tpu/rl/dqn.py`.  The reference agent's BUY/HOLD/
SELL Q-network (hidden 24, 24), ε-greedy `act`, replay ring of 10,000 with
batch-64 Q-learning and a target network synced every 100 learn steps.

One implementation with a leading member axis.  `_fleet_iteration` steps
a fleet of P agents whose every tensor leads with [P]: parameters [P, in,
out] through batched products, replay rings [P, cap, ...], env states [P,
N], `Hypers` fields [P].  The single agent (`dqn_init`, `train_iteration`,
`train_iterations`, `train_dqn`) is a fleet of one: its `DQNState` has the
JAX package's shapes, and each call lifts it to P = 1 (views) and drops the
axis again.  A learn step takes one gradient of the sum of the members'
mean losses: the members share no tensor, so each member's gradient is its
own.  The updates rebind the state's tensors (nothing is updated in place):
the state passed in stays valid, where the JAX program donates it.

One iteration: R = ``rollout_len`` steps of the N envs (ε-greedy actions
from the iteration's parameters, finished episodes reset), the R·N
transitions written into the ring at ``(ptr + arange(R·N)) % cap``, then
``learn_steps_per_iter`` updates, each followed by the target sync where
``learn_steps % target_sync_every == 0``.  Where R·N exceeds the capacity
the written indices repeat and which write lands is undefined, in both
packages; every configuration shipped here has R·N ≤ capacity.

The optimizer is plain ``optax.scale_by_adam()`` (`train_loop.
adam_direction` with `PLAIN_C1`/`PLAIN_C2`: its Python-float constants,
not the injected form's float32 ones) and the learning rate is applied
outside it, per member: ``p + (−lr)·u``.

Draws come from the state's provider (`rl.draws`): a ``torch.Generator``
passed as the key becomes `GeneratorDraws`.  Nothing inside an iteration
reads the host.  `train_iterations` returns its metrics stacked to
[n_iters] on the card; `train_dqn` reads them once a chunk (`host_read`,
a module-level seam that tests count).
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.models.layers import Dense
from ai_crypto_trader_tpu_torch.models.train_loop import (
    PLAIN_C1, PLAIN_C2, AdamState, adam_direction)
from ai_crypto_trader_tpu_torch.ops.tick_engine import read_packed, stage
from ai_crypto_trader_tpu_torch.rl.draws import RolloutDraws, as_draws
from ai_crypto_trader_tpu_torch.utils import devprof
from ai_crypto_trader_tpu_torch.rl.env import (
    OBS_SIZE, EnvParams, EnvState, env_reset, env_step, reset_bounds)


class QNetwork(nn.Module):
    """MLP Q(s,·) — Dense(24, 24, |A|) like the reference Keras model, on
    the port's flax-style `Dense` (flax's names ``Dense_0`` … and
    initialisers)."""

    def __init__(self, state_size: int = OBS_SIZE, hidden: tuple = (24, 24),
                 n_actions: int = 3, generator: torch.Generator | None = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        dims = (state_size,) + tuple(hidden) + (n_actions,)
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            setattr(self, f"Dense_{i}", Dense(dims[i], dims[i + 1], generator))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x

    def q_params(self) -> dict:
        """The network as the DQN's parameter dict: ``Dense_i.kernel`` [in,
        out] (flax's layout) and ``Dense_i.bias`` [out], detached."""
        out = {}
        for i in range(self.n_layers):
            layer = getattr(self, f"Dense_{i}")
            out[f"Dense_{i}.kernel"] = layer.weight.detach().T.contiguous()
            out[f"Dense_{i}.bias"] = layer.bias.detach().clone()
        return out


def q_values(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Q(x, ·) from a parameter dict: ``x @ kernel + bias`` per layer, ReLU
    between (flax's Dense: the product rounded, then the bias added).
    Parameters [P, in, out] / [P, out] with x [P, N, in], or unstacked
    [in, out] / [out] with x [N, in]."""
    n = len(params) // 2
    for i in range(n):
        x = torch.matmul(x, params[f"Dense_{i}.kernel"]) + \
            params[f"Dense_{i}.bias"].unsqueeze(-2)
        if i < n - 1:
            x = torch.relu(x)
    return x


class DQNConfig(NamedTuple):
    state_size: int = OBS_SIZE
    n_actions: int = 3
    hidden: tuple = (24, 24)
    gamma: float = 0.95
    epsilon: float = 1.0
    epsilon_min: float = 0.01
    epsilon_decay: float = 0.995
    learning_rate: float = 1e-3
    replay_capacity: int = 10_000
    batch_size: int = 64
    target_sync_every: int = 100
    num_envs: int = 64
    rollout_len: int = 8
    learn_steps_per_iter: int = 4


class Replay(NamedTuple):
    obs: torch.Tensor        # [cap, obs] float32
    actions: torch.Tensor    # [cap] int64
    rewards: torch.Tensor    # [cap] float32
    next_obs: torch.Tensor   # [cap, obs] float32
    dones: torch.Tensor      # [cap] bool
    ptr: torch.Tensor        # int32 write cursor
    size: torch.Tensor       # int32 filled count


class DQNState(NamedTuple):
    """The agent (or, stacked [P, ...], the fleet): every leaf a tensor but
    ``draws``, the provider its random draws come from (the JAX state's
    key)."""

    params: dict
    target_params: dict
    opt_state: AdamState      # count int32, mu and nu like params
    replay: Replay
    env_states: EnvState      # [num_envs]
    obs: torch.Tensor         # [num_envs, obs]
    epsilon: torch.Tensor     # float32
    learn_steps: torch.Tensor  # int32
    draws: Any


class Hypers(NamedTuple):
    """The PBT-searchable hyperparameters as tensor content (0-d for the
    single agent, [P] for a fleet), so that an exchange rewrites values and
    nothing else."""

    learning_rate: torch.Tensor     # float32
    gamma: torch.Tensor             # float32 discount
    epsilon_decay: torch.Tensor     # float32 per-env-step multiplier
    epsilon_min: torch.Tensor       # float32 exploration floor
    target_sync_every: torch.Tensor  # int32 learn steps between target syncs


def hypers_from_config(cfg: DQNConfig, device=None) -> Hypers:
    """The config's hyperparameters as 0-d tensors (filled on the device: a
    copy from the host would wait for the card)."""
    dev = resolve_device(device)
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    return Hypers(learning_rate=f(cfg.learning_rate), gamma=f(cfg.gamma),
                  epsilon_decay=f(cfg.epsilon_decay), epsilon_min=f(cfg.epsilon_min),
                  target_sync_every=torch.full((), cfg.target_sync_every, dtype=torch.int32,
                                               device=dev))


# -- the state's member axis ----------------------------------------------------

def map_state(fn, state: DQNState) -> DQNState:
    """``fn`` applied to every tensor of ``state`` (the provider is kept)."""
    m = lambda d: {k: fn(v) for k, v in d.items()}  # noqa: E731
    return DQNState(
        params=m(state.params), target_params=m(state.target_params),
        opt_state=AdamState(fn(state.opt_state.count), m(state.opt_state.mu),
                            m(state.opt_state.nu), state.opt_state.hyperparams),
        replay=Replay(*map(fn, state.replay)), env_states=EnvState(*map(fn, state.env_states)),
        obs=fn(state.obs), epsilon=fn(state.epsilon), learn_steps=fn(state.learn_steps),
        draws=state.draws)


def _lift(state: DQNState) -> DQNState:
    return map_state(lambda x: x.unsqueeze(0), state)


def _drop(state: DQNState) -> DQNState:
    return map_state(lambda x: x[0], state)


def _lift_hypers(hy: Hypers) -> Hypers:
    return Hypers(*(x.reshape(1) for x in hy))


def tensor_leaves(state: DQNState) -> dict:
    """Every tensor of ``state`` by a dotted name (for comparisons)."""
    out = {}
    for group in ("params", "target_params"):
        out.update({f"{group}.{k}": v for k, v in getattr(state, group).items()})
    out["opt_state.count"] = state.opt_state.count
    out.update({f"opt_state.mu.{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"opt_state.nu.{k}": v for k, v in state.opt_state.nu.items()})
    out.update({f"replay.{k}": v for k, v in state.replay._asdict().items()})
    out.update({f"env_states.{k}": v for k, v in state.env_states._asdict().items()})
    out.update(obs=state.obs, epsilon=state.epsilon, learn_steps=state.learn_steps)
    return out


# -- init -----------------------------------------------------------------------

def _fleet_init(draws, env_params: EnvParams, cfg: DQNConfig, P: int) -> DQNState:
    """P fresh agents, stacked: member i's parameters are the provider's
    i-th initialisation; its envs reset at the provider's draws."""
    dev = env_params.close.device
    build = lambda g: QNetwork(cfg.state_size, cfg.hidden, cfg.n_actions, g).q_params()  # noqa: E731
    members = draws.init_params(build, P)
    params = {k: torch.stack([m[k] for m in members]).to(dev) for k in members[0]}
    cap, F = cfg.replay_capacity, cfg.state_size
    replay = Replay(obs=torch.zeros((P, cap, F), device=dev),
                    actions=torch.zeros((P, cap), dtype=torch.int64, device=dev),
                    rewards=torch.zeros((P, cap), device=dev),
                    next_obs=torch.zeros((P, cap, F), device=dev),
                    dones=torch.zeros((P, cap), dtype=torch.bool, device=dev),
                    ptr=torch.zeros(P, dtype=torch.int32, device=dev),
                    size=torch.zeros(P, dtype=torch.int32, device=dev))
    scen, start = draws.resets(P, cfg.num_envs, reset_bounds(env_params))
    env_states, obs = env_reset(env_params, scen.to(dev), start.to(dev))
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return DQNState(params=params, target_params={k: v.clone() for k, v in params.items()},
                    opt_state=AdamState(torch.zeros(P, dtype=torch.int32, device=dev), zeros,
                                        {k: v.clone() for k, v in zeros.items()}, {}),
                    replay=replay, env_states=env_states, obs=obs,
                    epsilon=torch.full((P,), cfg.epsilon, dtype=torch.float32, device=dev),
                    learn_steps=torch.zeros(P, dtype=torch.int32, device=dev), draws=draws)


def dqn_init(key, env_params: EnvParams, cfg: DQNConfig) -> DQNState:
    """A fresh agent on ``env_params``' device.  ``key``: a
    ``torch.Generator`` (on that device) or a draw provider (`rl.draws`)."""
    return _drop(_fleet_init(as_draws(key), env_params, cfg, 1))


# -- containment ------------------------------------------------------------------

def poisoned_members(state: DQNState, fitness=None) -> torch.Tensor:
    """[P] bool over a fleet: True where any float tensor of member i's
    parameters or optimizer moments — or its fitness, when given — holds a
    NaN or an Inf."""
    leaves = (list(state.params.values()) + list(state.opt_state.mu.values())
              + list(state.opt_state.nu.values()))
    P = leaves[0].shape[0]
    bad = (torch.zeros(P, dtype=torch.bool, device=leaves[0].device) if fitness is None
           else ~torch.isfinite(fitness))
    for leaf in leaves:
        bad = bad | ~torch.isfinite(leaf).reshape(P, -1).all(dim=1)
    return bad


# -- the iteration ----------------------------------------------------------------

def act(explore_u, random_a, params: dict, obs, epsilon) -> torch.Tensor:
    """ε-greedy actions: the random action where ``explore_u < epsilon``,
    else the greedy one (the first of equal Q values).  ``epsilon`` must
    broadcast against ``explore_u`` ([P, 1] for a fleet's [P, N])."""
    greedy = torch.argmax(q_values(params, obs), dim=-1)
    return torch.where(explore_u < epsilon, random_a, greedy)


def _replay_add(rep: Replay, obs, actions, rewards, next_obs, dones) -> Replay:
    """Write each member's [n] transitions at ``(ptr + arange(n)) % cap``
    (leaves [P, n, ...])."""
    P, n = actions.shape
    cap = rep.obs.shape[1]
    dev = actions.device
    idx = (rep.ptr.long().unsqueeze(1) + torch.arange(n, device=dev)) % cap
    pi = torch.arange(P, device=dev).unsqueeze(1)
    put = lambda buf, val: buf.index_put((pi, idx), val)  # noqa: E731
    return Replay(obs=put(rep.obs, obs), actions=put(rep.actions, actions),
                  rewards=put(rep.rewards, rewards), next_obs=put(rep.next_obs, next_obs),
                  dones=put(rep.dones, dones),
                  ptr=((rep.ptr + n) % cap).to(torch.int32),
                  size=torch.clamp_max(rep.size + n, cap).to(torch.int32))


def _per_member(t, like):
    """A [P] tensor shaped [P, 1, ...] to broadcast against ``like``."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _learn(params, target_params, opt: AdamState, rep: Replay, idx, hy: Hypers):
    """One Q-learning update of every member on its sampled batch ``idx``
    [P, batch]: (params', opt', loss [P])."""
    pi = torch.arange(idx.shape[0], device=idx.device).unsqueeze(1)
    obs, next_obs = rep.obs[pi, idx], rep.next_obs[pi, idx]
    actions, rewards, dones = rep.actions[pi, idx], rep.rewards[pi, idx], rep.dones[pi, idx]
    with torch.no_grad():
        q_next = q_values(target_params, next_obs)
        target = rewards + hy.gamma.unsqueeze(1) * q_next.max(dim=-1).values * (
            1.0 - dones.float())
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    q = q_values(leaves, obs)
    q_sel = torch.gather(q, -1, actions.unsqueeze(-1)).squeeze(-1)
    loss = ((q_sel - target) ** 2).mean(dim=-1)
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    count, mu, nu, u = adam_direction(dict(zip(leaves, grads)), opt.count, opt.mu, opt.nu,
                                      PLAIN_C1, PLAIN_C2)
    with torch.no_grad():
        neg_lr = -hy.learning_rate
        new = {k: params[k] + _per_member(neg_lr, u[k]) * u[k] for k in params}
    return new, AdamState(count, mu, nu, opt.hyperparams), loss.detach()


def _fleet_iteration(env_params: EnvParams, state: DQNState, cfg: DQNConfig, hy: Hypers):
    """One iteration of every member of a stacked fleet: (state', metrics
    {name: [P]})."""
    draws = state.draws
    R, N, P = cfg.rollout_len, cfg.num_envs, state.epsilon.shape[0]
    dev = state.epsilon.device
    d = RolloutDraws(*(x.to(dev) for x in draws.rollout(
        R, P, N, cfg.n_actions, reset_bounds(env_params))))
    env_states, obs, eps = state.env_states, state.obs, state.epsilon
    traj = {"obs": [], "actions": [], "rewards": [], "next_obs": [], "dones": []}
    with torch.no_grad():
        for r in range(R):
            actions = act(d.explore_u[r], d.random_a[r], state.params, obs, eps.unsqueeze(1))
            env2, obs2, rewards, dones = env_step(env_params, env_states, actions)
            reset, reset_obs = env_reset(env_params, d.scen[r], d.start[r])
            env_states = EnvState(*(torch.where(dones, b, a) for a, b in zip(env2, reset)))
            for name, v in zip(traj, (obs, actions, rewards, obs2, dones)):
                traj[name].append(v)
            obs = torch.where(dones.unsqueeze(-1), reset_obs, obs2)
            eps = torch.maximum(eps * hy.epsilon_decay, hy.epsilon_min)
        # [P, R, N, ...] → [P, R·N, ...], rollout step outer
        flat = {k: torch.stack(v, dim=1).flatten(1, 2) for k, v in traj.items()}
        replay = _replay_add(state.replay, flat["obs"], flat["actions"], flat["rewards"],
                             flat["next_obs"], flat["dones"])

    params, opt = state.params, state.opt_state
    target, learn_steps = state.target_params, state.learn_steps
    L = cfg.learn_steps_per_iter
    idx = draws.replay_indices(L, cfg.batch_size, replay.size).to(dev)
    losses = []
    for i in range(L):
        params, opt, loss = _learn(params, target, opt, replay, idx[i], hy)
        losses.append(loss)
        learn_steps = learn_steps + 1
        sync = (learn_steps % hy.target_sync_every) == 0
        target = {k: torch.where(_per_member(sync, v), params[k], v)
                  for k, v in target.items()}

    new_state = DQNState(params=params, target_params=target, opt_state=opt, replay=replay,
                         env_states=env_states, obs=obs, epsilon=eps,
                         learn_steps=learn_steps.to(torch.int32), draws=draws)
    metrics = {"loss": (torch.stack(losses).mean(dim=0) if L
                        else torch.full((P,), float("nan"), device=eps.device)),
               "epsilon": eps, "mean_reward": flat["rewards"].mean(dim=1),
               "mean_balance": env_states.balance.mean(dim=1)}
    return new_state, metrics


METRICS = ("loss", "epsilon", "mean_reward", "mean_balance")


def train_iteration(env_params: EnvParams, state: DQNState, cfg: DQNConfig):
    """One iteration of the single agent: (state', metrics {name: 0-d})."""
    st, m = _fleet_iteration(env_params, _lift(state), cfg,
                             _lift_hypers(hypers_from_config(cfg, env_params.close.device)))
    return _drop(st), {k: v[0] for k, v in m.items()}


def train_iterations(env_params: EnvParams, state: DQNState, cfg: DQNConfig,
                     n_iters: int = 1):
    """``n_iters`` iterations of the single agent with no host read:
    (state', metrics {name: [n_iters]} on the card).

    With `utils.devprof` active the first call takes the
    ``dqn_train_iterations`` cost card, and every call feeds the
    ``train_step`` SLO window (the call's dispatch wall per iteration).
    Nothing is updated in place, so there is no donation to verify."""
    dp = devprof.active()
    if dp is None:
        return _train_iterations(env_params, state, cfg, n_iters)
    t0 = time.perf_counter()
    with devprof.carding("dqn_train_iterations", (env_params, state),
                         note=devprof.NOTE_NO_DONATION) as card:
        out = card.result(_train_iterations(env_params, state, cfg, n_iters))
    dp.observe_latency("train_step", (time.perf_counter() - t0) / max(n_iters, 1))
    return out


def _train_iterations(env_params: EnvParams, state: DQNState, cfg: DQNConfig,
                      n_iters: int):
    hy = _lift_hypers(hypers_from_config(cfg, env_params.close.device))
    st, rows = _lift(state), []
    for _ in range(n_iters):
        st, m = _fleet_iteration(env_params, st, cfg, hy)
        rows.append(m)
    return _drop(st), {k: torch.stack([m[k][0] for m in rows]) for k in METRICS}


def host_read(metrics: dict) -> dict:
    """THE per-chunk device→host read of `train_dqn`: the chunk's metrics
    {name: [k]}, packed into one float32 tensor and copied once → {name:
    float32 NumPy [k]}.  A module-level seam, so tests can count reads."""
    k = next(iter(metrics.values())).shape[0]
    packed = torch.cat([metrics[n].float().reshape(-1) for n in METRICS])
    return read_packed(stage(packed, [(n, (k,), np.float32) for n in METRICS]))


def _chunk(iterations: int, log_every: int, iters_per_sync: int | None) -> int:
    """The JAX package's chunk rule: the largest divisor of ``iterations``
    not above ``log_every`` (or 16), unless that degenerates below half the
    cap — then the cap, with a ragged last chunk."""
    if iters_per_sync is not None:
        return iters_per_sync
    cap = max(min(log_every if log_every else 16, iterations), 1)
    divisor = max(k for k in range(1, cap + 1) if iterations % k == 0)
    return divisor if divisor * 2 >= cap else cap


def train_dqn(key, env_params: EnvParams, cfg: DQNConfig, iterations: int = 100,
              log_every: int = 0, iters_per_sync: int | None = None):
    """The host loop: (final DQNState, history).  Iterations run in chunks of
    `train_iterations` with one `host_read` a chunk; the history keeps every
    ``log_every``-th iteration and the last, as the JAX function's."""
    state = dqn_init(key, env_params, cfg)
    per = _chunk(iterations, log_every, iters_per_sync)
    history, it0 = [], 0
    while it0 < iterations:
        k = min(max(per, 1), iterations - it0)
        state, m = train_iterations(env_params, state, cfg, n_iters=k)
        host = host_read(m)
        for j in range(k):
            it = it0 + j
            if it == iterations - 1 or (log_every and it % log_every == 0):
                history.append({name: float(v[j]) for name, v in host.items()} | {"iter": it})
        it0 += k
    return state, history


@torch.no_grad()
def _greedy_rollout(env_params: EnvParams, params: dict, scen, start, n_steps: int):
    """Greedy (ε = 0) rollout of a fleet's [P, N] fresh episodes, no resets:
    (final states, per-step mean reward [n_steps, P])."""
    states, obs = env_reset(env_params, scen, start)
    trace = []
    for _ in range(n_steps):
        actions = torch.argmax(q_values(params, obs), dim=-1)
        states, obs, rewards, _ = env_step(env_params, states, actions)
        trace.append(rewards.mean(dim=-1))
    return states, (torch.stack(trace) if trace
                    else torch.zeros((0, scen.shape[0]), device=scen.device))


def evaluate_policy(env_params: EnvParams, params: dict, cfg: DQNConfig, key,
                    n_steps: int = 256) -> dict:
    """Greedy-policy rollout over ``cfg.num_envs`` fresh episodes (the
    provider's evaluation resets): {"mean_balance": 0-d, "reward_trace":
    [n_steps]} on the card."""
    draws = as_draws(key)
    dev = env_params.close.device
    scen, start = draws.eval_resets(1, cfg.num_envs, reset_bounds(env_params))
    lifted = {k: v.unsqueeze(0) for k, v in params.items()}
    states, trace = _greedy_rollout(env_params, lifted, scen.to(dev), start.to(dev), n_steps)
    return {"mean_balance": states.balance[0].mean(), "reward_trace": trace[:, 0]}
