"""The port's backtest modules against the JAX package's, on the CPU.

  * Signals on the JAX indicator table (which isolates the signal logic
    from EMA rounding): signal and decision equal, strength at rtol 1e-5.
  * `sweep` on JAX's BacktestInputs and JAX's `sample_params` draws
    (brought over with `convert`) against JAX `engine.sweep` — the oracle
    `sweep_pallas` is pinned to, in the cases of
    tests/test_pallas_backtest.py:41-86, at `assert_stats_equal`'s
    tolerance (rtol 1e-5, atol 1e-6) with trade counts equal exactly.  On
    the CPU `sweep` is the plain loop the replay kernel is held to on the
    card.
  * `run_backtest` in each of its modes, and `compute_metrics`.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu import backtest as jbt  # noqa: E402
from ai_crypto_trader_tpu import ops as jops  # noqa: E402
from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch import backtest as tbt  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import strategy as tstrategy  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel  # noqa: E402

CHUNK_T, BLOCK_B = 1024, 128   # the Pallas kernel's tiles (ops/pallas_backtest.py)


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def make_inputs(T, seed=3):
    d = generate_ohlcv(n=T, seed=seed)
    ind = jops.compute_indicators({k: jnp.asarray(v) for k, v in d.items()
                                   if k != "regime"})
    return ind, jbt.prepare_inputs(ind)


def to_port(inp, params):
    return (convert.inputs_from_numpy(_numpy(inp), device="cpu"),
            convert.params_from_numpy(_numpy(params), device="cpu"))


def assert_stats_equal(ref, got):
    got = convert.stats_to_numpy(got)
    for f in ref._fields:
        r = np.asarray(getattr(ref, f))
        if r.dtype.kind == "i":
            assert got[f].dtype == np.int32, f
            np.testing.assert_array_equal(got[f], r, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], r, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("T", [1500, 2100])
def test_signals_on_the_jax_table(T):
    ind, ref = make_inputs(T)
    got = tbt.prepare_inputs({k: np.asarray(v) for k, v in ind.items()}, device="cpu")
    for f in ("signal", "decision"):
        assert getattr(got, f).dtype == torch.int32
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    for f in ("close", "strength", "volatility", "volume", "confidence"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, err_msg=f)
    for f in ("sl_pct", "tp_pct"):
        assert np.isnan(getattr(got, f).numpy()).all()
    assert (got.signal == 1).any() and (got.signal == -1).any()


def test_signal_features_frozen_last_candle():
    ind, _ = make_inputs(900)
    tind = {k: torch.from_numpy(np.array(v)) for k, v in ind.items()}
    got = tbt.compute_signal_features(tind, per_candle_trend=False)
    ref = jbt.compute_signal_features(ind, per_candle_trend=False)
    for f in ref._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, err_msg=f)
    sig, strength = tbt.reference_signal(got)
    rsig, rstrength = jbt.reference_signal(ref)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(rsig))
    np.testing.assert_allclose(strength.numpy(), np.asarray(rstrength), rtol=1e-5)


def test_position_size_ladder():
    rng = np.random.default_rng(5)
    bal = rng.uniform(50, 50_000, 400).astype(np.float32)
    vol = rng.choice([0.005, 0.01, 0.015, 0.02, 0.03], 400).astype(np.float32)
    volume = rng.uniform(0, 100_000, 400).astype(np.float32)
    got = tbt.position_size(*(torch.from_numpy(a) for a in (bal, vol, volume)))
    ref = jbt.position_size(jnp.asarray(bal), jnp.asarray(vol), jnp.asarray(volume))
    for f in ref._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("T,B", [
    (CHUNK_T, BLOCK_B),            # exact tiles of the Pallas kernel
    (1500, 130),                   # both axes ragged
    (2 * CHUNK_T + 7, 64),         # ragged time, small population
])
def test_sweep_matches_engine(T, B):
    _, inp = make_inputs(T)
    params = jbt.sample_params(jax.random.PRNGKey(0), B)
    ref = jbt.sweep(inp, params)
    got = tbt.sweep(*to_port(inp, params), device="cpu")
    assert_stats_equal(ref, got)
    assert int(np.sum(np.asarray(ref.total_trades))) > 0
    assert got.initial_balance.shape == (B,)


def test_sweep_with_sl_tp_overrides():
    _, inp = make_inputs(900)
    mask = np.random.default_rng(1).random(900) < 0.33
    inp = inp._replace(sl_pct=jnp.where(mask, 1.5, jnp.nan),
                       tp_pct=jnp.where(mask, 3.0, jnp.nan))
    params = jbt.sample_params(jax.random.PRNGKey(2), 32)
    assert_stats_equal(jbt.sweep(inp, params), tbt.sweep(*to_port(inp, params), device="cpu"))


def test_sweep_confidence_gating():
    _, inp = make_inputs(800)
    conf = jnp.where(jnp.arange(800) % 3 == 0, 0.9, 0.2)
    inp = inp._replace(confidence=conf)
    params = jbt.sample_params(jax.random.PRNGKey(3), 16)
    ref = jbt.sweep(inp, params)
    tin, tpar = to_port(inp, params)
    got = tbt.sweep(tin, tpar, device="cpu")
    assert_stats_equal(ref, got)
    ungated = tbt.sweep(tin._replace(confidence=torch.ones(800)), tpar, device="cpu")
    assert (got.total_trades != ungated.total_trades).any()


def test_sweep_return_curve_and_kernel_wrapper_on_cpu():
    _, inp = make_inputs(700)
    params = jbt.sample_params(jax.random.PRNGKey(4), 8)
    ref_stats, ref_curve = jbt.sweep(inp, params, return_curve=True)
    tin, tpar = to_port(inp, params)
    got_stats, got_curve = tbt.sweep(tin, tpar, return_curve=True, device="cpu")
    assert_stats_equal(ref_stats, got_stats)
    np.testing.assert_allclose(got_curve.numpy(), np.asarray(ref_curve), rtol=1e-5)
    # on the CPU `sweep` is the kernel's plain version; the launcher itself
    # refuses anything but a CUDA device and counts no launch
    before = sweep_kernel.launches
    assert_stats_equal(ref_stats, tbt.sweep(tin, tpar, device="cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        sweep_kernel(tin, tpar, device="cpu")
    assert sweep_kernel.launches == before


@pytest.mark.parametrize("mode", [
    {"reference_quirks": True},
    {"reference_quirks": False},
    {"sell_exits": True, "use_param_sl_tp": True},
    {"return_curve": True, "use_param_sl_tp": True},
])
def test_run_backtest_modes(mode):
    _, inp = make_inputs(1500)
    jp = jbt.default_params()
    ref = jbt.run_backtest(inp, jp, **mode)
    tin, tpar = to_port(inp, jp)
    got = tbt.run_backtest(tin, tpar, device="cpu", **mode)
    if mode.get("return_curve"):
        (ref, ref_curve), (got, got_curve) = ref, got
        assert got_curve.shape == (1500,)
        np.testing.assert_allclose(got_curve.numpy(), np.asarray(ref_curve), rtol=1e-5)
    assert_stats_equal(ref, got)
    assert int(got.total_trades) > 0


def test_compute_metrics_matches_jax():
    _, inp = make_inputs(1500)
    params = jbt.sample_params(jax.random.PRNGKey(0), 64)
    stats = jbt.sweep(inp, params)
    ref = jbt.compute_metrics(stats)
    tstats = tbt.BacktestStats(**{k: torch.from_numpy(np.array(v))
                                  for k, v in stats._asdict().items()})
    got = tbt.compute_metrics(tstats, device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_strategy_params():
    ref = jbt.default_params()
    got = tbt.default_params(device="cpu")
    for f in ref._fields:
        assert float(getattr(got, f)) == float(getattr(ref, f)), f
    assert tbt.default_params((3,), device="cpu").stop_loss.shape == (3,)
    p = tbt.sample_params(torch.Generator().manual_seed(0), 500, device="cpu")
    q = tbt.sample_params(torch.Generator().manual_seed(0), 500, device="cpu")
    for f, (lo, hi, is_int) in tbt.PARAM_RANGES.items():
        v = getattr(p, f)
        assert v.dtype == torch.float32 and v.shape == (500,)
        assert float(v.min()) >= lo and float(v.max()) <= hi, f
        assert torch.equal(v, getattr(q, f))
        if is_int:
            assert torch.equal(v, torch.round(v)), f
    wild = tstrategy.unstack_params(tstrategy.stack_params(p) * 3.0 - 50.0)
    clamped = tbt.clamp_params(wild)
    jclamped = jbt.clamp_params(jbt.strategy.unstack_params(
        jnp.asarray(tstrategy.stack_params(wild).numpy())))
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(clamped, f).numpy(),
                                      np.asarray(getattr(jclamped, f)), err_msg=f)


def test_convert_round_trip():
    _, inp = make_inputs(300)
    params = jbt.sample_params(jax.random.PRNGKey(9), 5)
    tin, tpar = to_port(inp, params)
    assert tin.signal.dtype == torch.int32 and tin.close.dtype == torch.float32
    for f in inp._fields:
        np.testing.assert_array_equal(getattr(tin, f).numpy(), np.asarray(getattr(inp, f)))
    for f in params._fields:
        np.testing.assert_array_equal(getattr(tpar, f).numpy(), np.asarray(getattr(params, f)))
    stats = convert.stats_to_numpy(tbt.sweep(tin, tpar, device="cpu"))
    assert stats["total_trades"].dtype == np.int32 and stats["sum_r"].dtype == np.float32
