"""Carry the JAX package's state across to the port, and results back.

Two kinds of state come over:

  * the backtest's and the GA's arrays — the strategy population (or the
    GA's genome matrix), the candle inputs and the GA's period tables —
    as NumPy arrays (``np.asarray`` of the JAX leaves, in dicts or
    NamedTuples), which become the port's NamedTuples of tensors on a
    device with the dtypes the JAX package uses (float32, and int32 for
    the signal and decision streams).  `stats_to_numpy` goes back;
  * the weights of the model zoo and of the chart-pattern classifier: a
    flax parameter tree becomes the port's module of that architecture
    (`model_from_flax`), a JAX ``TrainResult`` the port's
    (`train_result_from_flax`), a pattern classifier's tree a
    `PatternRecognizer` (`recognizer_from_flax`).  Leaves are matched by
    flax scope name — the port's modules carry flax's names, whose
    auto-numbering follows construction order, not data flow — and each
    leaf's shape is checked against the shape that name must have before
    its layout is turned into torch's.  Every flax leaf is used exactly
    once, or the conversion raises;
  * the long-context transformer's weights: a flax tree of
    `LongContextTransformer` becomes the port's module of the same widths
    (`long_context_from_flax`, the same names-to-modules map);
  * the RL trainer's state: a flax QNetwork tree becomes the DQN's
    parameter dict (`q_params_from_flax`), a JAX ``EnvParams`` the port's
    (`env_params_from_numpy`), and a JAX ``DQNState`` — one agent's, or a
    fleet's with every leaf stacked [P, ...] — the port's
    (`dqn_state_from_jax`: parameters, target, Adam's count and moments,
    the replay ring, env states, observations, ε and learn steps; the key
    stays behind, as the port's draws come from a provider), and a JAX PBT
    fleet — a ``PopState`` or a trainer checkpoint's payload — the port's
    `PopState` (`pop_state_from_jax`, its PRNG-key leaves skipped);
  * the regime models: a JAX ``Standardizer``, ``PCA``, ``KMeans``,
    ``GMM`` or ``HMM`` becomes the port's (`standardizer_from_jax`,
    `pca_from_jax`, `kmeans_from_jax`, `gmm_from_jax`, `hmm_from_jax`), so
    the port's predictions, posteriors and Viterbi run on JAX-fitted
    models;
  * the simulator's knobs (it has no learned weights): a JAX
    ``SimStrategy``, ``FillParams`` or ``FlowParams`` becomes the port's of
    float32 tensors (`sim_strategy_from_jax`, `fill_params_from_jax`,
    `flow_params_from_jax`), so both packages roll out with the same
    knobs; a stacked StrategyParams population for
    `backtest_under_stress` comes over through `params_from_numpy`.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.engine import BacktestInputs, BacktestStats
from ai_crypto_trader_tpu_torch.backtest.evolvable import IndicatorTables
from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.models.fused_lstm import FusedLSTM
from ai_crypto_trader_tpu_torch.models.long_context import LongContextTransformer
from ai_crypto_trader_tpu_torch.models.layers import (
    Conv, Dense, GRUCell, LayerNorm, MultiHeadDotProductAttention)
from ai_crypto_trader_tpu_torch.models.train import Scaler, TrainResult
from ai_crypto_trader_tpu_torch.models.zoo import build_model
from ai_crypto_trader_tpu_torch.models.train_loop import AdamState
from ai_crypto_trader_tpu_torch.patterns.model import PatternRecognizer, _build
from ai_crypto_trader_tpu_torch.regime.cluster import GMM, PCA, KMeans, Standardizer
from ai_crypto_trader_tpu_torch.regime.hmm import HMM
from ai_crypto_trader_tpu_torch.rl.dqn import DQNState, Hypers, Replay
from ai_crypto_trader_tpu_torch.rl.env import EnvParams, EnvState
from ai_crypto_trader_tpu_torch.sim.engine import FillParams, SimStrategy
from ai_crypto_trader_tpu_torch.sim.lob import FlowParams

_INT_FIELDS = frozenset({"signal", "decision", "total_trades", "winning_trades",
                         "losing_trades", "n_r", "max_win_streak",
                         "max_loss_streak"})


def _fields(tree, names):
    get = tree.get if isinstance(tree, dict) else (lambda k: getattr(tree, k))
    return {k: np.asarray(get(k)) for k in names}


def _tensor(name, value, dev):
    dtype = torch.int32 if name in _INT_FIELDS else torch.float32
    return to_device(value, dev, dtype)


def params_from_numpy(params, device=None) -> StrategyParams:
    """StrategyParams (or a dict with its field names) of arrays → the
    port's StrategyParams of float32 tensors on ``device``."""
    dev = resolve_device(device)
    return StrategyParams(**{k: _tensor(k, v, dev) for k, v in
                             _fields(params, StrategyParams._fields).items()})


def inputs_from_numpy(inputs, device=None) -> BacktestInputs:
    """BacktestInputs (or a dict with its field names) of arrays → the
    port's BacktestInputs on ``device``."""
    dev = resolve_device(device)
    return BacktestInputs(**{k: _tensor(k, v, dev) for k, v in
                             _fields(inputs, BacktestInputs._fields).items()})


def tables_from_numpy(tables, device=None) -> IndicatorTables:
    """IndicatorTables (or a dict with its field names) of arrays, as the
    JAX package's `build_indicator_tables` returns them → the port's
    IndicatorTables of float32 tensors on ``device``."""
    dev = resolve_device(device)
    return IndicatorTables(**{k: to_device(v, dev, torch.float32) for k, v in
                              _fields(tables, IndicatorTables._fields).items()})


def genomes_from_numpy(genomes, device=None) -> torch.Tensor:
    """A GA genome matrix [pop, n_params] (the JAX package's
    `stack_params` of a population) → a float32 tensor on ``device``."""
    return to_device(np.asarray(genomes), resolve_device(device), torch.float32)


def stats_to_numpy(stats: BacktestStats) -> dict:
    """BacktestStats of tensors → {field: np.ndarray}."""
    return {k: getattr(stats, k).detach().cpu().numpy()
            for k in BacktestStats._fields}


def _knobs(kind, tree, device):
    dev = resolve_device(device)
    return kind(**{k: to_device(v, dev, torch.float32)
                   for k, v in _fields(tree, kind._fields).items()})


def sim_strategy_from_jax(strategy, device=None) -> SimStrategy:
    """A JAX ``sim.engine.SimStrategy`` (or a dict of its fields) → the
    port's, float32 tensors on ``device``."""
    return _knobs(SimStrategy, strategy, device)


def fill_params_from_jax(fill_params, device=None) -> FillParams:
    """A JAX ``sim.engine.FillParams`` → the port's on ``device``."""
    return _knobs(FillParams, fill_params, device)


def flow_params_from_jax(flow, device=None) -> FlowParams:
    """A JAX ``sim.lob.FlowParams`` (a fitted one from `sim.calibrate`
    too) → the port's on ``device``."""
    return _knobs(FlowParams, flow, device)


# -- weights: flax parameter trees → the port's modules ----------------------

def _flatten(tree, prefix: str = "") -> dict:
    """A flax parameter tree (nested mappings; the ``"params"`` collection
    of an ``init`` output unwrapped) → {"scope/.../leaf": array}."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def _flax_sources(model: torch.nn.Module) -> dict:
    """{port parameter: (flax leaf paths, the shape each must have, the
    function of those leaves that gives the torch tensor)} for every
    parameter of ``model``."""
    out, composite = {}, []
    for name, mod in model.named_modules():
        if any(name.startswith(c + ".") for c in composite):
            continue                       # a part of an attention layer or a GRU cell
        pre, p = (name + "." if name else ""), name.replace(".", "/")
        if isinstance(mod, MultiHeadDotProductAttention):
            composite.append(name)
            heads = mod.num_heads
            for part in ("query", "key", "value"):
                o, i = getattr(mod, part).weight.shape
                out[f"{pre}{part}.weight"] = ([f"{p}/{part}/kernel"], [(i, heads, o // heads)],
                                              lambda k: k.reshape(k.shape[0], -1).T)
                out[f"{pre}{part}.bias"] = ([f"{p}/{part}/bias"], [(heads, o // heads)],
                                            lambda b: b.reshape(-1))
            o, i = mod.out.weight.shape
            out[f"{pre}out.weight"] = ([f"{p}/out/kernel"], [(heads, i // heads, o)],
                                       lambda k: k.reshape(-1, k.shape[-1]).T)
            out[f"{pre}out.bias"] = ([f"{p}/out/bias"], [(o,)], lambda b: b)
        elif isinstance(mod, GRUCell):
            composite.append(name)
            H, F = mod.bhn.shape[0], mod.wi.weight.shape[1]
            out[f"{pre}wi.weight"] = ([f"{p}/{g}/kernel" for g in ("ir", "iz", "in")], [(F, H)] * 3,
                                      lambda *ks: np.concatenate(ks, axis=1).T)
            out[f"{pre}wi.bias"] = ([f"{p}/{g}/bias" for g in ("ir", "iz", "in")], [(H,)] * 3,
                                    lambda *bs: np.concatenate(bs))
            out[f"{pre}wh"] = ([f"{p}/{g}/kernel" for g in ("hr", "hz", "hn")], [(H, H)] * 3,
                               lambda *ks: np.concatenate(ks, axis=1))
            out[f"{pre}bhn"] = ([f"{p}/hn/bias"], [(H,)], lambda b: b)
        elif isinstance(mod, Dense):
            o, i = mod.weight.shape
            out[f"{pre}weight"] = ([f"{p}/kernel"], [(i, o)], lambda k: k.T)
            out[f"{pre}bias"] = ([f"{p}/bias"], [(o,)], lambda b: b)
        elif isinstance(mod, Conv):
            o, i, k = mod.weight.shape
            out[f"{pre}weight"] = ([f"{p}/kernel"], [(k, i, o)], lambda w: w.transpose(2, 1, 0))
            out[f"{pre}bias"] = ([f"{p}/bias"], [(o,)], lambda b: b)
        elif isinstance(mod, LayerNorm):
            (d,) = mod.scale.shape
            out[f"{pre}scale"] = ([f"{p}/scale"], [(d,)], lambda s: s)
            out[f"{pre}bias"] = ([f"{p}/bias"], [(d,)], lambda b: b)
        elif isinstance(mod, FusedLSTM):
            out[f"{pre}wh"] = ([f"{p}/wh"], [tuple(mod.wh.shape)], lambda w: w)
    return out


def state_from_flax(model: torch.nn.Module, params) -> dict:
    """``model``'s state dict from a flax parameter tree of its
    architecture: float32 CPU tensors.  Raises if a leaf is missing, has
    another shape than its name requires, or is left over."""
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(params).items()}
    sources = _flax_sources(model)
    names = {n for n, _ in model.named_parameters()}
    if set(sources) != names:
        raise ValueError(f"no flax source for {sorted(names - set(sources))}")
    used, state = Counter(), {}
    for pname, (paths, shapes, to_torch) in sources.items():
        leaves = []
        for path, shape in zip(paths, shapes):
            if path not in flat:
                raise KeyError(f"the flax tree has no leaf {path!r} (for {pname})")
            if flat[path].shape != tuple(shape):
                raise ValueError(f"flax leaf {path!r} is {flat[path].shape}; "
                                 f"{pname} needs {tuple(shape)}")
            used[path] += 1
            leaves.append(flat[path])
        state[pname] = torch.from_numpy(np.array(to_torch(*leaves), order="C"))
    left = sorted(set(flat) - set(used))
    twice = sorted(p for p, n in used.items() if n > 1)
    if left or twice:
        raise ValueError(f"flax leaves left over {left}, used twice {twice}")
    return state


def model_from_flax(model_type: str, params, model_kwargs: dict | None = None, *,
                    features: int = 5, device=None) -> torch.nn.Module:
    """A flax parameter tree of the zoo's architecture ``model_type`` (as
    ``build_model(model_type, **model_kwargs).init`` gives it, leaves
    anything NumPy takes) over ``features`` input columns → the port's
    module of that architecture holding those weights, on ``device``."""
    dev = resolve_device(device)
    model = build_model(model_type, **(model_kwargs or {}), features=features, device="cpu")
    model.load_state_dict(state_from_flax(model, params))
    return model.to(dev)


def long_context_from_flax(params, *, features: int, d_model: int = 64, num_heads: int = 4,
                           num_blocks: int = 2, ff_dim: int = 128, mesh=None,
                           device=None) -> LongContextTransformer:
    """A flax parameter tree of the JAX package's `LongContextTransformer`
    (as its ``init`` gives it, leaves anything NumPy takes) over
    ``features`` input columns → the port's `LongContextTransformer` of the
    same widths holding those weights, on ``device``; with ``mesh`` (a
    `parallel.mesh.Mesh`) its attention is the ring over it."""
    dev = resolve_device(device)
    model = LongContextTransformer(features, d_model, num_heads, num_blocks, ff_dim, mesh,
                                   device="cpu")
    model.load_state_dict(state_from_flax(model, params))
    return model.to(dev)


def _params_of(model: torch.nn.Module) -> dict:
    return {k: v.detach() for k, v in model.named_parameters()}


def train_result_from_flax(result, device=None) -> TrainResult:
    """A JAX ``TrainResult`` (its ``params``, the ``scaler``'s min and max,
    ``model_type``, ``model_kwargs``, ``history``, ``best_val_loss``,
    ``epochs_run`` and ``target_col``) → the port's TrainResult on
    ``device``; the input width is the scaler's."""
    dev = resolve_device(device)
    smin, smax = (np.asarray(v, np.float32) for v in (result.scaler.min, result.scaler.max))
    kwargs = dict(result.model_kwargs)
    model = model_from_flax(result.model_type, result.params, kwargs,
                            features=smin.shape[-1], device=dev)
    return TrainResult(params=_params_of(model), model_type=result.model_type,
                       scaler=Scaler(to_device(smin, dev), to_device(smax, dev)),
                       model_kwargs=kwargs, history=list(result.history),
                       best_val_loss=float(result.best_val_loss),
                       epochs_run=int(result.epochs_run), target_col=int(result.target_col))


def recognizer_from_flax(model_type: str, params, *, seq_len: int = 60,
                         trained: bool = True, device=None) -> PatternRecognizer:
    """A flax parameter tree of the pattern classifier ``model_type``
    ("cnn", "lstm" or "cnn_lstm"; windows of ``seq_len`` candles) → the
    port's PatternRecognizer with those weights on ``device``."""
    dev = resolve_device(device)
    model = _build(model_type, device="cpu", seq_len=seq_len)
    model.load_state_dict(state_from_flax(model, params))
    return PatternRecognizer(model_type=model_type, params=_params_of(model.to(dev)),
                             trained=trained)


def q_params_from_flax(params, device=None) -> dict:
    """A flax `QNetwork` tree (``{"params": {"Dense_i": {"kernel",
    "bias"}}}``, leaves optionally stacked [P, ...]) → the DQN's parameter
    dict (``Dense_i.kernel`` [(P,) in, out], ``Dense_i.bias`` [(P,) out])
    on ``device``.  Raises on a layer that is missing or left over."""
    dev = resolve_device(device)
    tree = params["params"] if "params" in params else params
    names = [f"Dense_{i}" for i in range(len(tree))]
    if sorted(tree) != sorted(names):
        raise ValueError(f"not a QNetwork tree: layers {sorted(tree)}")
    out = {}
    for name in names:
        if set(tree[name]) != {"kernel", "bias"}:
            raise ValueError(f"{name} holds {sorted(tree[name])}, not kernel and bias")
        out[f"{name}.kernel"] = to_device(np.asarray(tree[name]["kernel"]), dev, torch.float32)
        out[f"{name}.bias"] = to_device(np.asarray(tree[name]["bias"]), dev, torch.float32)
    return out


def env_params_from_numpy(p, device=None) -> EnvParams:
    """A JAX ``EnvParams`` → the port's on ``device`` (close, obs table,
    fee rate and a trade-cost table as float32; a scalar cost of 0.0 stays
    0.0)."""
    dev = resolve_device(device)
    cost = np.asarray(p.trade_cost, np.float32)
    return EnvParams(close=to_device(np.asarray(p.close), dev, torch.float32),
                     obs_table=to_device(np.asarray(p.obs_table), dev, torch.float32),
                     episode_len=int(p.episode_len),
                     fee_rate=to_device(np.asarray(p.fee_rate, np.float32), dev),
                     trade_cost=to_device(cost, dev) if cost.ndim else float(cost))


def _adam_moments(tree, dev) -> dict:
    return q_params_from_flax(tree, device=dev)


def dqn_state_from_jax(state, draws, device=None) -> DQNState:
    """A JAX ``DQNState`` (one agent's, or a fleet's stacked [P, ...]) → the
    port's on ``device``, drawing from ``draws`` from here on.  Integer
    leaves become int64 (indices) or int32 (counters) as the port holds
    them."""
    dev = resolve_device(device)
    t = lambda v, dtype=None: to_device(np.asarray(v), dev, dtype)  # noqa: E731
    adam = state.opt_state
    r, e = state.replay, state.env_states
    return DQNState(
        params=q_params_from_flax(state.params, device=dev),
        target_params=q_params_from_flax(state.target_params, device=dev),
        opt_state=AdamState(t(adam.count, torch.int32), _adam_moments(adam.mu, dev),
                            _adam_moments(adam.nu, dev), {}),
        replay=Replay(obs=t(r.obs, torch.float32), actions=t(r.actions, torch.int64),
                      rewards=t(r.rewards, torch.float32),
                      next_obs=t(r.next_obs, torch.float32), dones=t(r.dones, torch.bool),
                      ptr=t(r.ptr, torch.int32), size=t(r.size, torch.int32)),
        env_states=EnvState(t=t(e.t, torch.int64), start=t(e.start, torch.int64),
                            in_pos=t(e.in_pos, torch.bool), entry=t(e.entry, torch.float32),
                            balance=t(e.balance, torch.float32), scen=t(e.scen, torch.int64)),
        obs=t(state.obs, torch.float32), epsilon=t(state.epsilon, torch.float32),
        learn_steps=t(state.learn_steps, torch.int32), draws=draws)


# -- the PBT fleet ------------------------------------------------------------

def _jax_pop_leaf_names(n_layers: int) -> list:
    """The leaf paths of a JAX ``PopState`` in ``jax.tree.leaves`` order
    (dict keys sorted, NamedTuple fields in order)."""
    layers = sorted(f"Dense_{i}" for i in range(n_layers))
    tree = [f"{layer}/{leaf}" for layer in layers for leaf in ("bias", "kernel")]
    names = [f"params/{t}" for t in tree] + [f"target_params/{t}" for t in tree]
    names += ["opt_state/count"] + [f"opt_state/mu/{t}" for t in tree] + \
        [f"opt_state/nu/{t}" for t in tree]
    names += [f"replay/{f}" for f in Replay._fields]
    names += [f"env_states/{f}" for f in EnvState._fields]
    names += ["obs", "epsilon", "learn_steps", "key"]
    return [f"members/{n}" for n in names] + [f"hypers/{f}" for f in Hypers._fields] + \
        ["quarantined", "cooldown"]


def _jax_members(leaves: dict, n_layers: int):
    """A JAX ``DQNState``-shaped view of named member leaves, as
    `dqn_state_from_jax` reads one."""
    from types import SimpleNamespace as NS

    def tree(prefix):
        return {"params": {f"Dense_{i}": {k: leaves[f"{prefix}/Dense_{i}/{k}"]
                                          for k in ("kernel", "bias")}
                           for i in range(n_layers)}}

    return NS(params=tree("members/params"), target_params=tree("members/target_params"),
              opt_state=NS(count=leaves["members/opt_state/count"],
                           mu=tree("members/opt_state/mu"), nu=tree("members/opt_state/nu")),
              replay=NS(**{f: leaves[f"members/replay/{f}"] for f in Replay._fields}),
              env_states=NS(**{f: leaves[f"members/env_states/{f}"]
                               for f in EnvState._fields}),
              obs=leaves["members/obs"], epsilon=leaves["members/epsilon"],
              learn_steps=leaves["members/learn_steps"])


def pop_state_from_jax(payload_or_popstate, cfg, pcfg, env_params, draws, device=None):
    """A JAX PBT fleet → the port's `PopState` on ``device``, drawing from
    ``draws`` (a provider; the fleet's PRNG keys are skipped).  Takes a JAX
    ``PopState`` (NumPy or JAX leaves) or a JAX trainer checkpoint's
    payload (its ``arrays``, `pack_array` records in ``jax.tree.leaves``
    order).  Refuses a population, config or leaf-count drift and any leaf
    whose shape is not the port fleet's for ``cfg`` / ``pcfg`` on
    ``env_params``."""
    from ai_crypto_trader_tpu_torch.rl.population import PopState, pop_init
    from ai_crypto_trader_tpu_torch.rl.trainer_service import _cfg_identity, pop_leaves
    from ai_crypto_trader_tpu_torch.utils.journal import unpack_array

    dev = resolve_device(device)
    n_layers = len(cfg.hidden) + 1
    names = _jax_pop_leaf_names(n_layers)
    if isinstance(payload_or_popstate, dict):
        payload = payload_or_popstate
        if int(payload.get("population", -1)) != int(pcfg.population):
            raise ValueError(f"checkpoint population {payload.get('population')} != "
                             f"{pcfg.population}")
        if (payload.get("cfg") or {}) != _cfg_identity(cfg):
            raise ValueError(f"checkpoint config {payload.get('cfg')} does not fit {cfg}")
        arrays = [unpack_array(a) for a in payload["arrays"]]
        if len(arrays) != len(names):
            raise ValueError(f"checkpoint carries {len(arrays)} arrays, a JAX fleet of "
                             f"{n_layers} layers has {len(names)}")
        leaves = dict(zip(names, arrays))
        members = _jax_members(leaves, n_layers)
        hypers = {f: leaves[f"hypers/{f}"] for f in Hypers._fields}
        quarantined, cooldown = leaves["quarantined"], leaves["cooldown"]
    else:
        pop = payload_or_popstate
        members, quarantined, cooldown = pop.members, pop.quarantined, pop.cooldown
        hypers = {f: getattr(pop.hypers, f) for f in Hypers._fields}
    t = lambda v, dtype: to_device(np.asarray(v), dev, dtype)  # noqa: E731
    out = PopState(
        members=dqn_state_from_jax(members, draws, device=dev),
        hypers=Hypers(**{f: t(v, torch.int32 if f == "target_sync_every" else torch.float32)
                         for f, v in hypers.items()}),
        quarantined=t(quarantined, torch.bool), cooldown=t(cooldown, torch.int32))
    template = pop_leaves(pop_init(torch.Generator(env_params.close.device).manual_seed(0),
                                   env_params, cfg, pcfg))
    for name, got in pop_leaves(out).items():
        if tuple(got.shape) != tuple(template[name].shape):
            raise ValueError(f"{name} is {tuple(got.shape)}, the fleet needs "
                             f"{tuple(template[name].shape)}")
    return out


# -- the regime models --------------------------------------------------------

def _f32(value, dev):
    return to_device(np.asarray(value), dev, torch.float32)


def standardizer_from_jax(std, device=None) -> Standardizer:
    dev = resolve_device(device)
    return Standardizer(_f32(std.mean, dev), _f32(std.std, dev))


def pca_from_jax(pca, device=None) -> PCA:
    dev = resolve_device(device)
    return PCA(components=_f32(pca.components, dev), mean=_f32(pca.mean, dev))


def kmeans_from_jax(km, device=None) -> KMeans:
    return KMeans(_f32(km.centroids, resolve_device(device)))


def gmm_from_jax(gmm, device=None) -> GMM:
    dev = resolve_device(device)
    return GMM(weights=_f32(gmm.weights, dev), means=_f32(gmm.means, dev),
               vars=_f32(gmm.vars, dev))


def hmm_from_jax(hmm, device=None) -> HMM:
    dev = resolve_device(device)
    return HMM(log_pi=_f32(hmm.log_pi, dev), log_A=_f32(hmm.log_A, dev),
               means=_f32(hmm.means, dev), vars=_f32(hmm.vars, dev))
