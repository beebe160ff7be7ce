"""Carry the JAX package's state across to the port, and results back.

This system has no weights: its "parameters" are the strategy population
(or the GA's genome matrix), the candle inputs and the GA's period tables.
They come over as NumPy arrays — ``np.asarray`` of the JAX leaves, in
dicts or NamedTuples — and become the port's NamedTuples of tensors on a
device, with the dtypes the JAX package uses (float32, and int32 for the
signal and decision streams).  `stats_to_numpy` goes back.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.engine import BacktestInputs, BacktestStats
from ai_crypto_trader_tpu_torch.backtest.evolvable import IndicatorTables
from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
from ai_crypto_trader_tpu_torch.device import resolve_device, to_device

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
