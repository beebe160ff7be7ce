"""The vectorized trading environment over precomputed market tables.

Port of `ai_crypto_trader_tpu/rl/env.py`.  A pure functional environment:
the state is a tuple of tensors of any batch shape (the DQN steps a fleet's
[P, N] environments at once), the market is a table of features per candle,
optionally with a leading scenario axis ([S, T], built by
`sim.engine.scenario_env_params`), and a reset draws a (scenario, offset)
pair per episode.

Actions: BUY = 0, HOLD = 1, SELL = 2; long-only, one position; the reward
is the step's change of mark-to-market equity as a fraction of the balance,
less the fees of an open or a close.  Observation (``OBS_SIZE`` = 10 on the
default table): [rsi/100, stoch_k/100, macd (clipped), williams_r/-100,
bb_position, volatility, 1-step return, 5-step return, in_position,
unrealized pnl %], plus any extra market columns the table carries.

Random draws.  `env_reset` takes its draws as arguments — the scenario rows
and the start offsets, each of the batch's shape — where the JAX function
draws them from a key inside: the DQN's draws come from a provider
(`rl.draws`), so a test can hand over the JAX package's own.
`reset_bounds` gives the ranges they are drawn from.

Indexing.  A state stepped past the end of its table (the greedy
evaluation does not reset a finished episode) reads the last candle: the
candle index is clamped, as a JAX gather clamps it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.device import div_true, resolve_device, to_device

BUY, HOLD, SELL = 0, 1, 2
OBS_SIZE = 10


class EnvParams(NamedTuple):
    close: torch.Tensor      # [T], or [S, T] for a scenario-diverse env
    obs_table: torch.Tensor  # [(S,) T, F] market features
    episode_len: int
    fee_rate: torch.Tensor   # float32 0-d: taker fee fraction per side
    # per-side execution cost on top of the fee: 0.0 (frictionless), or a
    # float32 [T] / [S, T] table (the LOB path's half-spread)
    trade_cost: torch.Tensor | float = 0.0


class EnvState(NamedTuple):
    t: torch.Tensor          # int64 absolute candle index
    start: torch.Tensor      # int64
    in_pos: torch.Tensor     # bool
    entry: torch.Tensor      # float32
    balance: torch.Tensor    # float32 equity in quote units (starts at 1.0)
    scen: torch.Tensor       # int64 scenario row (0 on a single-path env)


def obs_size(p: EnvParams) -> int:
    """This env's observation width: the table's market columns plus the two
    position features.  Size DQN networks with this, not ``OBS_SIZE``."""
    return int(p.obs_table.shape[-1]) + 2


def assert_transfer_compatible(old: EnvParams, new: EnvParams) -> None:
    """Raise unless ``new`` has ``old``'s episode length and the same leaf
    shapes and dtypes (a recalibration changes values, never shapes)."""
    if int(old.episode_len) != int(new.episode_len):
        raise ValueError(
            f"env episode_len changed {old.episode_len} -> "
            f"{new.episode_len}: a recalibrated env must be shape-stable")
    o_l = [old.close, old.obs_table, old.fee_rate, old.trade_cost]
    n_l = [new.close, new.obs_table, new.fee_rate, new.trade_cost]
    for a, b in zip(o_l, n_l):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"env leaf changed {tuple(a.shape)}/{a.dtype} -> "
                f"{tuple(b.shape)}/{b.dtype}: a recalibration is a transfer, "
                f"never a recompile")


def make_env_params(ind: dict, episode_len: int = 256, fee_rate: float = 0.0,
                    extra_features=None, trade_cost=None, device=None) -> EnvParams:
    """The feature table from a `compute_indicators` dict (arrays [(S,) T],
    NumPy or tensors), on ``device`` (default: the CUDA card).
    ``extra_features`` [(S,) T, E] appends E market columns;
    ``trade_cost`` (scalar or [(S,) T]) is the per-side execution cost on
    top of ``fee_rate`` (None: 0.0)."""
    dev = resolve_device(device)
    col = lambda k: to_device(ind[k], dev, torch.float32)  # noqa: E731
    close = col("close")
    prev1 = torch.cat([close[..., :1], close[..., :-1]], dim=-1)
    ret1 = (close - prev1) / close
    prev5 = torch.roll(close, 5, dims=-1)
    ret5 = (close - prev5) / prev5
    ret5[..., :5] = 0.0
    # the JAX function runs op by op (it is not jitted), so each division by
    # a constant is a true division there (`div_true`: on the card too)
    obs = torch.stack([
        div_true(col("rsi"), 100.0),
        div_true(col("stoch_k"), 100.0),
        torch.clamp(col("macd") / close * 100.0, -1.0, 1.0),
        div_true(col("williams_r"), -100.0),
        col("bb_position"),
        col("atr") / close,
        torch.clamp(ret1 * 100.0, -1.0, 1.0),
        torch.clamp(ret5 * 100.0, -1.0, 1.0),
    ], dim=-1)
    if extra_features is not None:
        obs = torch.cat([obs, to_device(extra_features, dev, torch.float32)], dim=-1)
    return EnvParams(close=close, obs_table=obs.contiguous(), episode_len=int(episode_len),
                     fee_rate=torch.full((), fee_rate, dtype=torch.float32, device=dev),
                     trade_cost=(0.0 if trade_cost is None
                                 else to_device(trade_cost, dev, torch.float32)))


def reset_bounds(p: EnvParams) -> tuple[int, int]:
    """(scenario rows, start offsets) a reset draws from: scen uniform in
    [0, S) (S = 1 on a single-path env), start uniform in [0, max(T −
    episode_len − 1, 1))."""
    T = int(p.close.shape[-1])
    S = int(p.close.shape[0]) if p.close.dim() == 2 else 1
    return S, max(T - int(p.episode_len) - 1, 1)


def _at(table, p: EnvParams, s: EnvState, t):
    """``table``'s ([(S,) T, ...]) entries at candle ``t`` of each state's
    scenario row, the index clamped to the table."""
    t = torch.clamp(t, 0, p.close.shape[-1] - 1)
    return table[s.scen, t] if p.close.dim() == 2 else table[t]


def _observe(p: EnvParams, s: EnvState) -> torch.Tensor:
    price, market = _at(p.close, p, s, s.t), _at(p.obs_table, p, s, s.t)
    unreal = torch.where(s.in_pos, (price - s.entry) / s.entry, 0.0)
    return torch.cat([market, torch.stack([s.in_pos.float(), unreal * 100.0], dim=-1)],
                     dim=-1)


def env_reset(p: EnvParams, scen, start) -> tuple[EnvState, torch.Tensor]:
    """Fresh episodes at the drawn scenario rows ``scen`` and start offsets
    ``start`` (int tensors of the batch's shape; ``scen`` is ignored on a
    single-path env): (state, observation [..., F])."""
    start = start.long()
    scen = scen.long() if p.close.dim() == 2 else torch.zeros_like(start)
    s = EnvState(t=start, start=start, in_pos=torch.zeros_like(start, dtype=torch.bool),
                 entry=torch.zeros(start.shape, dtype=torch.float32, device=start.device),
                 balance=torch.ones(start.shape, dtype=torch.float32, device=start.device),
                 scen=scen)
    return s, _observe(p, s)


def env_step(p: EnvParams, s: EnvState, action):
    """(state, action) → (state', obs', reward, done), elementwise over the
    batch."""
    T = p.close.shape[-1]
    price = _at(p.close, p, s, s.t)
    next_t = s.t + 1
    next_price = _at(p.close, p, s, next_t)

    open_now = (action == BUY) & ~s.in_pos
    close_now = (action == SELL) & s.in_pos
    entry = torch.where(open_now, price, s.entry)
    in_pos = (s.in_pos | open_now) & ~close_now

    # mark-to-market equity delta over the candle t → t+1; fees on open/close
    exposure = in_pos.float()
    price_ret = (next_price - price) / price
    cost = p.trade_cost
    if torch.is_tensor(cost) and cost.dim():
        tt = torch.clamp(s.t, 0, T - 1)
        cost = cost[s.scen, tt] if cost.dim() == 2 else cost[tt]
    fees = (open_now.float() + close_now.float()) * (p.fee_rate + cost)
    reward = exposure * price_ret - fees
    balance = s.balance * (1.0 + reward)
    done = ((next_t - s.start) >= p.episode_len) | (next_t >= T - 1)

    s2 = EnvState(t=next_t, start=s.start, in_pos=in_pos, entry=entry, balance=balance,
                  scen=s.scen)
    return s2, _observe(p, s2), reward, done
