"""PyTorch/CUDA port of ai_crypto_trader_tpu's population backtest and GA.

The chains, module for module after the JAX package:

    data.generate_ohlcv → ops.compute_indicators → backtest.prepare_inputs
        → backtest.sweep → backtest.compute_metrics
    data.generate_ohlcv → evolve.backtest_fitness (backtest.evolvable's
        period tables over ops.dynamic) → evolve.run_ga

Plain tensor code is PyTorch; the two Pallas kernels of the JAX package on
these paths are CUDA C++ kernels for Hopper (``csrc/``), built with nvcc on
first use and loaded with ctypes (``ops/_cuda.py``).  Entry points run on the
CUDA card unless called with ``device="cpu"`` (``device.resolve_device``).
Arithmetic is float32 throughout; TF32 is switched off here, once, although
no matmul or convolution lies on this path.
"""

import torch

from ai_crypto_trader_tpu_torch.device import resolve_device  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
