"""The PyTorch/CUDA port as a package: what it imports, where it runs, and
the data it shares with the JAX package.

The port imports torch and numpy only — never jax nor any module of
ai_crypto_trader_tpu (the `_torch` package itself aside) — and runs on the
CUDA card unless called with device="cpu".  These tests run on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu_torch import convert, resolve_device
from ai_crypto_trader_tpu_torch.backtest import (
    BacktestInputs, StrategyParams, compute_metrics, default_params,
    portfolio_backtest, prepare_inputs, run_backtest, sample_params,
    shared_capital_backtest, stack_symbol_inputs, sweep,
)
from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv, load_csv
from ai_crypto_trader_tpu_torch.ops import TickEngine, compute_indicators, fused_ewma
from ai_crypto_trader_tpu_torch.ops import _cuda
from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
from ai_crypto_trader_tpu_torch.backtest.evolvable import (
    build_indicator_tables, evolvable_fused_backtest, population_backtest,
)
from ai_crypto_trader_tpu_torch.config import GAParams
from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_PROBE = r"""
import importlib, pkgutil, re, sys
import ai_crypto_trader_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or re.match(r"ai_crypto_trader_tpu(?!_torch)(\.|$)", m))
print(len(names), bad)
expected = {"config", "ops.dynamic", "backtest.evolvable", "evolve", "evolve.ga",
            "evolve.selection", "cli", "obs", "obs.drift", "ops.volume_profile",
            "ops.combinations", "ops.tick_engine", "backtest.portfolio", "data.ingest"}
missing = sorted(e for e in expected if pkg.__name__ + "." + e not in names)
print(missing)
sys.exit(1 if bad or missing or len(names) < 28 else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    return {k: v for k, v in generate_ohlcv(n=300, seed=3).items() if k != "regime"}


_ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "compute_indicators": lambda: compute_indicators(_small()),
    "fused_ewma": lambda: fused_ewma(np.ones((1, 64), np.float32), [0.1]),
    "sample_params": lambda: sample_params(torch.Generator().manual_seed(0), 4),
    "default_params": lambda: default_params(),
    "prepare_inputs": lambda: prepare_inputs(
        compute_indicators(_small(), device="cpu")),
    "sweep": lambda: sweep(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu"),
        default_params((2,), device="cpu")),
    "sweep_kernel": lambda: sweep_kernel(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu"),
        default_params((2,), device="cpu")),
    "run_backtest": lambda: run_backtest(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")),
    "params_from_numpy": lambda: convert.params_from_numpy(
        {f: np.ones(2, np.float32) for f in StrategyParams._fields}),
    "inputs_from_numpy": lambda: convert.inputs_from_numpy(
        {f: np.ones(4, np.float32) for f in BacktestInputs._fields}),
    "build_indicator_tables": lambda: build_indicator_tables(_small()),
    "population_backtest": lambda: population_backtest(
        _small(), default_params((2,), device="cpu")),
    "evolvable_fused_backtest": lambda: evolvable_fused_backtest(
        _small(), default_params((2,), device="cpu"),
        build_indicator_tables(_small(), device="cpu")),
    "backtest_fitness": lambda: backtest_fitness(_small()),
    "run_ga": lambda: run_ga(torch.Generator().manual_seed(0),
                             backtest_fitness(_small(), device="cpu"),
                             GAParams(population_size=4, generations=1)),
    "tables_from_numpy": lambda: convert.tables_from_numpy(
        {f: np.ones((2, 4), np.float32) for f in
         ("ema_raw", "ema_fill", "rsi_fill", "atr_fill", "atr_median", "bb_mid", "bb_sd",
          "vol_ma_fill")}),
    "genomes_from_numpy": lambda: convert.genomes_from_numpy(np.ones((4, 18), np.float32)),
    "TickEngine": lambda: TickEngine(["BTCUSDC"], ["1m"], window=64),
    "stack_symbol_inputs": lambda: stack_symbol_inputs({"BTCUSDC": _small()}),
    "portfolio_backtest": lambda: portfolio_backtest(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")),
    "shared_capital_backtest": lambda: shared_capital_backtest(
        stack_symbol_inputs({"BTCUSDC": _small()}, device="cpu")[0]),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_default_device_is_cuda_and_raises_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[entry]()


def test_compute_metrics_default_device_raises(no_cuda):
    inp = prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")
    stats = sweep(inp, default_params((2,), device="cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_metrics(stats)
    assert set(compute_metrics(stats, device="cpu")) >= {"sharpe_ratio", "win_rate"}


def test_cpu_is_used_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    out = fused_ewma(np.ones((2, 16), np.float32), [0.5], device="cpu")
    assert out.device.type == "cpu" and out.shape == (1, 2, 16)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.nvcc_path()


def test_library_names_follow_the_source_hash():
    paths = {name: _cuda.library_path(name) for name in _cuda.SOURCES}
    assert set(paths) == {"fused_ewma", "replay_sweep"}
    for name, path in paths.items():
        assert path.parent.name == ".torch_kernels"
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_cuda.SOURCE_DIR / f"{name}.cu").is_file()
    assert "--fmad=false" in _cuda.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


@pytest.mark.parametrize("n,seed", [(1000, 0), (2048, 7), (525, [1, 2, 3])])
def test_generate_ohlcv_bit_identical_to_the_jax_package(n, seed):
    from ai_crypto_trader_tpu.data import synthetic as ref

    a, b = generate_ohlcv(n=n, seed=seed), ref.generate_ohlcv(n=n, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_csv_ingest_reads_the_jax_package_cache(tmp_path):
    from ai_crypto_trader_tpu.data import ingest as ref

    d = {k: v for k, v in generate_ohlcv(n=50, seed=1).items() if k != "regime"}
    path = ref.save_csv(ref.from_dict(d, symbol="BTCUSDC"), str(tmp_path))
    got, want = load_csv(path, symbol="BTCUSDC"), ref.load_csv(path, symbol="BTCUSDC")
    for f in ("timestamp", "open", "high", "low", "close", "volume"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    mine = from_dict(d, symbol="X")
    assert len(mine) == 50 and mine.slice(10, 20).close.shape == (10,)
    np.testing.assert_array_equal(mine.timestamp, ref.from_dict(d).timestamp)


def test_cli_backtest_on_the_cpu(tmp_path, monkeypatch, capsys):
    import json

    from ai_crypto_trader_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.main(["backtest", "--days", "1", "--sweep", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[:out.rindex("}") + 1])
    assert summary["total_trades"] >= 0 and summary["candles_per_sec"] > 0
    (saved,) = (tmp_path / "backtesting" / "results").iterdir()
    result = json.loads(saved.read_text())
    assert result["sweep_size"] == 8 and result["device"] == "cpu"
    assert np.isfinite(result["sharpe_ratio"])
