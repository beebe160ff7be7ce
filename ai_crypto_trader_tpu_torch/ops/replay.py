"""The population replay backtest as a CUDA event walk.

Replaces the TPU kernel `ai_crypto_trader_tpu/ops/pallas_backtest.py`
`sweep_pallas` (pl.pallas_call at :259; body from `_make_kernel`, :87-196)
with `csrc/replay_sweep.cu`: `engine.sweep`'s stats for a population in
``use_param_sl_tp`` mode (no reference quirks, no sell exits), and with
``return_curve`` its [B, T] equity curve.  The kernel is two launches: a
pre-pass that writes the entry gate of every candle into a bitmask, and a
walk, one warp per strategy, that jumps from event to event.  Its plain
version is the engine's loop (`sweep_plain`); `gate_mask_plain` is the
pre-pass's.  `sweep_kernel` is the launcher and takes CUDA tensors only;
`backtest.sweep` and `backtest.run_backtest` pick it on the card and the
plain loop on the CPU.

Each stream but ``close`` and ``volume`` may be one [T] row shared by every
strategy or [B, T], a row per strategy (the rows form: the GA's fitness,
where every genome has its own signals and exits, as the JAX package's
`population_backtest` vmaps `run_backtest` over per-genome inputs).  When a
gate stream (confidence, strength, signal, decision) is rows, the pre-pass
writes a mask row per strategy.
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
    "replay_gate_launch": (ctypes.c_int, [
        _P, _P, _P, _P,                       # confidence, strength, signal, decision
        _P,                                   # mask
        ctypes.c_longlong, ctypes.c_int,      # T, mask rows
        *[ctypes.c_longlong] * 4,             # the four streams' row strides
        ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]),
    "replay_walk_launch": (ctypes.c_int, [
        _P, _P, _P, _P, _P,                   # close, volatility, volume, sl/tp overrides
        _P,                                   # mask
        _P, _P,                               # stop_loss, take_profit
        _P, _P, _P,                           # out_f, out_i, curve (or None)
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        *[ctypes.c_longlong] * 4,             # row strides: mask, volatility, sl, tp
        _P]),
}
# rows of the kernel's outputs
_F_ROWS = ("final_balance", "total_profit", "total_loss", "max_drawdown",
           "max_drawdown_pct", "sum_r", "sum_r2", "sum_neg_r2")
_I_ROWS = ("total_trades", "winning_trades", "losing_trades", "n_r",
           "max_win_streak", "max_loss_streak")
_INT_STREAMS = ("signal", "decision")
_SHARED_STREAMS = ("close", "volume")
_GATE_STREAMS = ("confidence", "strength", "signal", "decision")


def sweep_plain(inputs: BacktestInputs, params: StrategyParams,
                initial_balance: float = 10_000.0,
                ai_confidence_threshold: float = 0.7,
                min_signal_strength: float = 70.0,
                warmup: int = 10, return_curve: bool = False):
    """The plain PyTorch version: the engine's loop, on the inputs' device."""
    return replay(inputs, params, initial_balance=initial_balance,
                  ai_confidence_threshold=ai_confidence_threshold,
                  min_signal_strength=min_signal_strength, warmup=warmup,
                  use_param_sl_tp=True, return_curve=return_curve)


def gate_mask_plain(inputs: BacktestInputs, ai_confidence_threshold: float = 0.7,
                    min_signal_strength: float = 70.0,
                    warmup: int = 10) -> torch.Tensor:
    """The pre-pass's plain version: replay_step's entry gate of every
    candle (out of a position) as int32 words, bit t % 32 of word t // 32:
    [ceil(T/32)] when the gate streams are [T], [B, ceil(T/32)] when any of
    them is [B, T].  For tests and chip_smoke.py; the walk reads the
    kernel's."""
    T = int(inputs.close.shape[-1])
    t = torch.arange(T, device=inputs.close.device)
    gate = ((t >= warmup)
            & (inputs.confidence >= ai_confidence_threshold)
            & (inputs.strength >= min_signal_strength)
            & (inputs.signal == inputs.decision) & (inputs.decision == 1))
    lead = tuple(gate.shape[:-1])
    bits = torch.zeros(lead + (-(-T // 32) * 32,), dtype=torch.int64, device=t.device)
    bits[..., :T] = gate.to(torch.int64)
    words = (bits.view(lead + (-1, 32)) << torch.arange(32, device=t.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _stream(inputs: BacktestInputs, name: str, T: int, B: int):
    x = getattr(inputs, name)
    dtype = torch.int32 if name in _INT_STREAMS else torch.float32
    shapes = [(T,)] if name in _SHARED_STREAMS else [(T,), (B, T)]
    if tuple(x.shape) not in shapes:
        raise ValueError(f"sweep kernel: inputs.{name} must have shape "
                         f"{' or '.join(map(str, shapes))}, got {tuple(x.shape)}")
    x = x.to(dtype).contiguous()
    # the walk reads close 16 bytes at a time
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _row_stride(x) -> int:
    """0 for a stream shared by every strategy, T for [B, T] rows."""
    return int(x.shape[-1]) if x.ndim == 2 else 0


def launch_gate(lib, s: dict, T: int, warmup: int, thr: float, min_strength: float,
                dev) -> torch.Tensor:
    """The pre-pass on `kernel_operands`' streams: the gate mask as int32
    words, [ceil(T/32)] for shared gate streams, else [B, ceil(T/32)]."""
    rows = max(int(s[k].shape[0]) if s[k].ndim == 2 else 0 for k in _GATE_STREAMS)
    mask = torch.empty(((rows,) if rows else ()) + (-(-T // 32),),
                       dtype=torch.int32, device=dev)
    rc = lib.replay_gate_launch(
        *(s[k].data_ptr() for k in _GATE_STREAMS), mask.data_ptr(), T, max(rows, 1),
        *(_row_stride(s[k]) for k in _GATE_STREAMS), int(warmup), float(thr),
        float(min_strength), _cuda.stream_handle(dev))
    _cuda.check(lib, "replay_sweep", rc)
    return mask


def launch_walk(lib, s: dict, mask, stop_loss, take_profit, T: int, warmup: int,
                initial_balance: float, return_curve: bool, dev):
    """The walk over a gate mask: (out_f [8, B], out_i [6, B], curve [B, T]
    or None).  `sweep_kernel` runs the pre-pass and the walk; chip_smoke.py
    also times each alone."""
    B = int(stop_loss.shape[0])
    if mask.ndim == 2 and mask.shape[0] != B:
        raise ValueError(f"sweep kernel: a mask of {mask.shape[0]} rows for {B} strategies")
    out_f = torch.empty((len(_F_ROWS), B), dtype=torch.float32, device=dev)
    out_i = torch.empty((len(_I_ROWS), B), dtype=torch.int32, device=dev)
    curve = (torch.empty((B, T), dtype=torch.float32, device=dev)
             if return_curve else None)
    rc = lib.replay_walk_launch(
        *(s[k].data_ptr() for k in ("close", "volatility", "volume", "sl_pct", "tp_pct")),
        mask.data_ptr(), stop_loss.data_ptr(), take_profit.data_ptr(),
        out_f.data_ptr(), out_i.data_ptr(), None if curve is None else curve.data_ptr(),
        B, T, int(warmup), float(initial_balance), _row_stride(mask),
        *(_row_stride(s[k]) for k in ("volatility", "sl_pct", "tp_pct")),
        _cuda.stream_handle(dev))
    _cuda.check(lib, "replay_sweep", rc)
    return out_f, out_i, curve


def kernel_operands(inputs: BacktestInputs, params: StrategyParams, dev):
    """The launches' operands, checked: (library, streams by name — each
    [T], or [B, T] rows but close and volume —, stop_loss [B], take_profit
    [B], T)."""
    inputs, params = _on(inputs, dev), _on(params, dev)
    T = int(inputs.close.shape[-1])
    stop_loss = params.stop_loss.to(torch.float32).contiguous()
    take_profit = params.take_profit.to(torch.float32).contiguous()
    if stop_loss.ndim != 1 or take_profit.shape != stop_loss.shape:
        raise ValueError("sweep kernel: params.stop_loss / take_profit must be "
                         "one-dimensional [B] and of one shape")
    B = int(stop_loss.shape[0])
    streams = {name: _stream(inputs, name, T, B) for name in BacktestInputs._fields}
    return _cuda.library("replay_sweep", _SIGNATURES), streams, stop_loss, take_profit, T


def sweep_kernel(inputs: BacktestInputs, params: StrategyParams,
                 initial_balance: float = 10_000.0,
                 ai_confidence_threshold: float = 0.7,
                 min_signal_strength: float = 70.0,
                 warmup: int = 10, return_curve: bool = False, device=None):
    """`engine.sweep` stats for stacked params [B] over [T] candles (each
    stream [T] or, but close and volume, [B, T] rows), from the kernel on
    the card, and with ``return_curve`` the [B, T] curve as
    ``(stats, curve)``.  Raises on any other device: the CPU's plain loop
    is `backtest.sweep`'s to choose."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"sweep_kernel runs on a CUDA device, not {dev}; "
                         "backtest.sweep runs the plain loop on the CPU")
    lib, s, stop_loss, take_profit, T = kernel_operands(inputs, params, dev)
    with torch.cuda.device(dev):
        mask = launch_gate(lib, s, T, warmup, ai_confidence_threshold,
                            min_signal_strength, dev)
        out_f, out_i, curve = launch_walk(lib, s, mask, stop_loss, take_profit, T,
                                           warmup, initial_balance, return_curve, dev)
    sweep_kernel.launches += 1
    rows = dict(zip(_F_ROWS, out_f.unbind(0)))
    rows.update(zip(_I_ROWS, out_i.unbind(0)))
    rows["initial_balance"] = torch.full((int(stop_loss.shape[0]),), initial_balance,
                                         dtype=torch.float32, device=dev)
    stats = BacktestStats(**rows)
    return (stats, curve) if return_curve else stats


sweep_kernel.launches = 0
