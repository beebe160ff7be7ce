"""The population replay backtest as one CUDA kernel.

Replaces the TPU kernel `ai_crypto_trader_tpu/ops/pallas_backtest.py`
`sweep_pallas` (pl.pallas_call at :259; body from `_make_kernel`, :87-196)
with `csrc/replay_sweep.cu`: `engine.sweep`'s stats for a population in
``use_param_sl_tp`` mode (no reference quirks, no sell exits, no curve).
Its plain version is the engine's loop (`sweep_plain`).  `sweep_kernel`
is the launcher and takes CUDA tensors only; `backtest.sweep` is the
wrapper that picks it on the card and the plain loop on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ai_crypto_trader_tpu_torch.backtest.engine import (
    BacktestInputs,
    BacktestStats,
    _on,
    replay,
)
from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.ops import _cuda

_P = ctypes.c_void_p
_SIGNATURES = {
    "replay_sweep_launch": (ctypes.c_int, [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,   # nine candle streams
        _P, _P,                               # stop_loss, take_profit
        _P, _P,                               # out_f, out_i
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, _P]),
}
# rows of the kernel's outputs
_F_ROWS = ("final_balance", "total_profit", "total_loss", "max_drawdown",
           "max_drawdown_pct", "sum_r", "sum_r2", "sum_neg_r2")
_I_ROWS = ("total_trades", "winning_trades", "losing_trades", "n_r",
           "max_win_streak", "max_loss_streak")
_INT_STREAMS = ("signal", "decision")


def sweep_plain(inputs: BacktestInputs, params: StrategyParams,
                initial_balance: float = 10_000.0,
                ai_confidence_threshold: float = 0.7,
                min_signal_strength: float = 70.0,
                warmup: int = 10) -> BacktestStats:
    """The plain PyTorch version: the engine's loop, on the inputs' device."""
    return replay(inputs, params, initial_balance=initial_balance,
                  ai_confidence_threshold=ai_confidence_threshold,
                  min_signal_strength=min_signal_strength, warmup=warmup,
                  use_param_sl_tp=True)


def _stream(inputs: BacktestInputs, name: str, T: int):
    x = getattr(inputs, name)
    dtype = torch.int32 if name in _INT_STREAMS else torch.float32
    if x.shape != (T,):
        raise ValueError(f"sweep kernel: inputs.{name} must have shape ({T},), "
                         f"got {tuple(x.shape)}")
    return x.to(dtype).contiguous()


def sweep_kernel(inputs: BacktestInputs, params: StrategyParams,
                 initial_balance: float = 10_000.0,
                 ai_confidence_threshold: float = 0.7,
                 min_signal_strength: float = 70.0,
                 warmup: int = 10, device=None) -> BacktestStats:
    """`engine.sweep` stats for stacked params [B] over [T] candles, from
    the kernel on the card.  Raises on any other device: the CPU's plain
    loop is `backtest.sweep`'s to choose."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"sweep_kernel runs on a CUDA device, not {dev}; "
                         "backtest.sweep runs the plain loop on the CPU")
    inputs, params = _on(inputs, dev), _on(params, dev)
    lib = _cuda.library("replay_sweep", _SIGNATURES)
    T = int(inputs.close.shape[-1])
    streams = [_stream(inputs, name, T) for name in BacktestInputs._fields]
    stop_loss = params.stop_loss.to(torch.float32).contiguous()
    take_profit = params.take_profit.to(torch.float32).contiguous()
    if stop_loss.ndim != 1 or take_profit.shape != stop_loss.shape:
        raise ValueError("sweep kernel: params.stop_loss / take_profit must be "
                         "one-dimensional [B] and of one shape")
    B = int(stop_loss.shape[0])
    out_f = torch.empty((len(_F_ROWS), B), dtype=torch.float32, device=dev)
    out_i = torch.empty((len(_I_ROWS), B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.replay_sweep_launch(
            *(x.data_ptr() for x in streams),
            stop_loss.data_ptr(), take_profit.data_ptr(),
            out_f.data_ptr(), out_i.data_ptr(),
            B, T, int(warmup), float(initial_balance),
            float(ai_confidence_threshold), float(min_signal_strength),
            _cuda.stream_handle(dev))
    _cuda.check(lib, "replay_sweep", rc)
    sweep_kernel.launches += 1
    rows = dict(zip(_F_ROWS, out_f.unbind(0)))
    rows.update(zip(_I_ROWS, out_i.unbind(0)))
    rows["initial_balance"] = torch.full((B,), initial_balance,
                                         dtype=torch.float32, device=dev)
    return BacktestStats(**rows)


sweep_kernel.launches = 0
