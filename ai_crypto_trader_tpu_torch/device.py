"""Where the port runs.

Every public entry point of the port — `compute_indicators`, `fused_ewma`,
`prepare_inputs`, `default_params`, `sample_params`, `run_backtest`,
`sweep`, `compute_metrics`, `build_indicator_tables`,
`population_backtest` and the other `backtest.evolvable` pipelines,
`backtest_fitness`, `run_ga`, `TickEngine`, `stack_symbol_inputs`,
`shared_capital_backtest`, `portfolio_backtest`, and the `convert`
functions —
takes ``device=None``, which means the CUDA card, and moves its inputs
there.  The CPU is used only when the caller asks for it with
``device="cpu"`` (the tests do; there every kernel wrapper takes its plain
PyTorch version).  A request for the card on a machine without one raises:
nothing carries on quietly on the CPU.  The building blocks under them
(single indicators, the indicators with tensor periods, the signal and
vote rules, `volume_profile`, the indicator combinations, `replay_step`,
the GA's `_evolve_core`) compute on the device of the tensors they are
given.
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
