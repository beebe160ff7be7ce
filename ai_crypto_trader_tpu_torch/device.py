"""Where the port runs.

Every public entry point of the port — `compute_indicators`, `fused_ewma`,
`prepare_inputs`, `default_params`, `sample_params`, `run_backtest`,
`sweep`, `compute_metrics`, `build_indicator_tables`,
`population_backtest` and the other `backtest.evolvable` pipelines,
`backtest_fitness`, `run_ga`, `TickEngine`, `stack_symbol_inputs`,
`shared_capital_backtest`, `portfolio_backtest`, `TenantEngine`, the
Monte-Carlo engine's functions (`run_simulation`, `simulate_gbm`,
`simulate_bootstrap`, `path_statistics`, `estimate_mu_sigma`,
`portfolio_stats`, `simulate_portfolio_correlated`), the risk layer's
(`historical_var`, `parametric_var`, `cvar`, `correlation_matrix`,
`portfolio_var`, `equal_risk_position_sizes`, `stress_var_cvar`,
`diversification_analysis`, `adaptive_stop_loss`, `trailing_stop_init`,
`trailing_stop_update`, `weighted_sentiment`, `social_risk_adjustment`),
the model zoo's and the pattern classifier's (`build_model`, `fit_scaler`,
`predict_prices`, `predict_prices_batched`, `detect_patterns`, the
classifiers' `_build`), their training (`train_model`, `EpochTrainer`,
`optimize_hyperparameters`, `feature_importance`, `PredictionService`,
`generate_dataset`, `train_pattern_model`, `load_checkpoint`), the RL
trainer's and its markets' (`make_env_params`, `hypers_from_config`,
`path_params`, `gbm_candles`, `bootstrap_candles`, `flow_params`,
`lob_candles`, `scenario_env_params`, `pbt_env_params`), the simulator's
(`exchange.init_state`, `exchange.no_action`, `default_strategy`,
`fill_params`, `rollout_candles`, `sim.engine.sweep`,
`backtest_under_stress`, `rollout_lob`, `lob_sweep`, `fit_flow_params`),
the strategy layer's (`fold_features`, `evaluate_structures`,
`StrategyGenerator`, `GeneratorService`, `cross_validate`,
`compare_strategies`, `StrategyEvolver`), the long-context transformer
(`LongContextTransformer`), the social analyzer's (`normalize_metrics`,
`fit_anomaly_model`, `detect_anomalies`, `lead_lag_correlation`,
`sentiment_accuracy`, `adaptive_source_weights`), the live signal path's
(`MarketMonitor`, `TradeExecutor`, `MarketScanner`, `score_pairs`, `cli
scan`), the trading system's (`TradingSystem`, `device_liveness`, `cli
trade`, `cli why`), the full roster's (`shell.stack.build_full_stack` on
its system's device, `EvolverService`, `SocialMonitorService`,
`SocialDataProvider.social_inputs`, `find_triangle_arbitrage`), and the
`convert` functions —
takes ``device=None``, which means the CUDA card, and moves its inputs
there.  The CPU is used only when the caller asks for it with
``device="cpu"`` (the tests do; there every kernel wrapper takes its plain
PyTorch version).  A request for the card on a machine without one raises:
nothing carries on quietly on the CPU.  The building blocks under them
(single indicators, the indicators with tensor periods, the signal and
vote rules, `volume_profile`, the indicator combinations, `replay_step`,
the GA's `_evolve_core`, `fleetscope.device_aggregates`, `mc.quantile`,
the models' layers, `dropout`, `lstm_scan`, `Adam` and
`patterns.preprocess_window`; the env's `env_reset` / `env_step`, the
DQN's and the fleet's functions after `dqn_init` / `pop_init`, `q_values`,
`flow_step` and the `_traced` generators, the exchange's steps
`settle_pending`, `match_candle`, `apply_action` and `equity`, the
structure search's `blend_signals`, `reference_attention` and
`long_context_loss`) compute on
the device of the tensors they are given — ``dqn_init`` and ``pop_init``
on the env's.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise ``RuntimeError`` if CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ai_crypto_trader_tpu_torch runs on a CUDA card by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(value, device, dtype=None):
    """``value`` (a tensor or anything NumPy takes) as a tensor on
    ``device``, cast to ``dtype`` if given.  NumPy input is copied: arrays
    handed over from JAX are read-only."""
    t = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    return t.to(device=device, dtype=dtype or t.dtype)


def upload(value, device, dtype=None):
    """``value`` (a tensor or anything NumPy takes) as a tensor on
    ``device``, cast to ``dtype`` if given.  A host array goes to the card
    from pinned memory with a non-blocking copy, so the upload makes the
    host wait for nothing (`to_device` copies from pageable memory, which
    synchronizes)."""
    t = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    dtype = dtype or t.dtype
    if device.type == "cuda" and t.device.type == "cpu":
        return t.to(dtype).pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


# Division by a constant.  The JAX package's compiled programs divide by a
# constant as a multiply by its float32 reciprocal (XLA's algebraic
# simplifier rewrites it so); PyTorch divides truly on the CPU and multiplies
# by the reciprocal on CUDA.  `div_const` takes the JAX package's rounding on
# both devices.  A constant over a tensor stays a true division in XLA, but
# PyTorch computes `python_float / tensor` as `reciprocal(tensor) * c`:
# `const_over` keeps the true division.

def div_const(x, c: float):
    """``x / c`` for a constant ``c``, as the multiply by ``1/c``."""
    return x * (1.0 / c)


def const_over(c: float, x):
    """``c / x`` for a constant ``c``, as a true division."""
    return torch.full_like(x, c) / x


def div_true(x, c: float):
    """``x / c`` for a value ``c`` that the JAX package's programs take as
    an argument (not a constant), so XLA divides truly: a true division on
    both devices (a 0-d tensor on ``x``'s device is not the CPU scalar that
    CUDA would multiply by its reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def minus_product(c, a, b):
    """``c − a·b`` rounded once, as the fused multiply-add XLA forms on the
    CPU for this pattern.  The float32 product is exact in float64, so the
    result differs from one rounding only where the float64 difference
    lands exactly halfway between two float32 values.  ``b`` and ``c`` may
    be tensors or float32-exact Python floats.  The same bits on every
    device."""
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (c - a.double() * b).to(torch.float32)


def plus_product(c, a, b):
    """``c + a·b`` rounded once, as the fused multiply-add XLA forms on the
    CPU for this pattern (`minus_product`'s sibling, the same argument)."""
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (c + a.double() * b).to(torch.float32)


# The matmul-precision knob's vocabulary: the port's copy of the JAX
# package's `models/train_loop._PRECISIONS` (user-facing name → canonical
# name; None is the backend default).
PRECISIONS = {
    None: None,
    "f32": "float32", "float32": "float32", "highest": "highest",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "tf32": "tensorfloat32", "tensorfloat32": "tensorfloat32",
}


def canonical_precision(precision: str | None) -> str | None:
    """The canonical name of a precision knob value; ``ValueError`` for an
    unknown one."""
    try:
        return PRECISIONS[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; one of "
            f"{sorted(k for k in PRECISIONS if k)}") from None
