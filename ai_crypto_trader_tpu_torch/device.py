"""Where the port runs.

Every public entry point of the port — `compute_indicators`, `fused_ewma`,
`prepare_inputs`, `default_params`, `sample_params`, `run_backtest`,
`sweep`, `compute_metrics`, `build_indicator_tables`,
`population_backtest` and the other `backtest.evolvable` pipelines,
`backtest_fitness`, `run_ga`, and the `convert` functions —
takes ``device=None``, which means the CUDA card, and moves its inputs
there.  The CPU is used only when the caller asks for it with
``device="cpu"`` (the tests do; there every kernel wrapper takes its plain
PyTorch version).  A request for the card on a machine without one raises:
nothing carries on quietly on the CPU.  The building blocks under them
(single indicators, the indicators with tensor periods, the signal and
vote rules, `replay_step`, the GA's `_evolve_core`) compute on the device
of the tensors they are given.
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
