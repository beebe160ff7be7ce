"""Sequence parallelism: the port's time-split scans against JAX's, on the CPU.

tests/test_time_shard.py's cases and tolerances: the candle axis split
over a virtual mesh of 8 CPU shards (the JAX side on its `mesh8`) must give
the numbers of the unsplit kernels — the port's `ops.indicators.ema` (the
fused EWMA's plain version here) and `rolling_mean`, and JAX's.  The
rolling mean sums the same windows in the same order as the unsplit one,
so it is also held bit for bit against the port's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.ops import indicators as jind  # noqa: E402
from ai_crypto_trader_tpu.parallel import time_shard as jts  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import indicators as ind  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import make_mesh  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel.mesh import Shards  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel.time_shard import (  # noqa: E402
    sharded_ema, sharded_first_order_recursion, sharded_rolling_mean)

T = 4096
# the JAX functions jitted: run op by op they take tens of seconds a call here
_J_EMA = jax.jit(jind.ema, static_argnums=1)
_J_ROLLING_MEAN = jax.jit(jind.rolling_mean, static_argnums=1)
_J_RECURSION = jax.jit(jind.first_order_recursion)
_J_SHARDED_EMA = jax.jit(jts.sharded_ema, static_argnums=(1, 2))
_J_SHARDED_ROLLING_MEAN = jax.jit(jts.sharded_rolling_mean, static_argnums=(1, 2))
_J_SHARDED_RECURSION = jax.jit(jts.sharded_first_order_recursion, static_argnums=2)


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(42)
    return (100.0 * np.cumprod(1 + rng.normal(0, 0.002, T))).astype(np.float32)


class TestFirstOrderRecursion:
    def test_matches_unsharded(self, tmesh8, mesh8):
        rng = np.random.default_rng(7)
        a = rng.uniform(0.8, 0.99, T).astype(np.float32)
        b = rng.normal(0, 1, T).astype(np.float32)
        got = sharded_first_order_recursion(torch.tensor(a), torch.tensor(b), tmesh8).gather()
        want = np.asarray(_J_RECURSION(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
        jgot = np.asarray(_J_SHARDED_RECURSION(jnp.asarray(a), jnp.asarray(b), mesh8))
        np.testing.assert_allclose(got.numpy(), jgot, rtol=2e-5, atol=1e-5)
        port = ind.first_order_recursion(torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=2e-5, atol=1e-5)

    def test_result_is_time_sharded(self, tmesh8, series):
        got = sharded_first_order_recursion(torch.full((T,), 0.9), torch.tensor(series) * 0.1,
                                            tmesh8)
        assert isinstance(got, Shards) and len(got) == 8
        assert all(s.shape == (T // 8,) for s in got)


class TestShardedEma:
    @pytest.mark.parametrize("window", [12, 26, 200])
    def test_matches_ops_ema(self, tmesh8, mesh8, series, window):
        got = sharded_ema(torch.tensor(series), window, tmesh8).gather().numpy()
        for want in (np.asarray(_J_EMA(jnp.asarray(series), window)),
                     ind.ema(torch.tensor(series), window).numpy(),
                     np.asarray(_J_SHARDED_EMA(jnp.asarray(series), window, mesh8))):
            # identical warmup NaNs, matching values after
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            m = ~np.isnan(want)
            np.testing.assert_allclose(got[m], want[m], rtol=2e-5, atol=1e-4)

    def test_block_boundaries_seamless(self, tmesh8, series):
        """The positions straddling shard boundaries are where a wrong carry
        would show: check them explicitly."""
        window = 20
        want = np.asarray(_J_EMA(jnp.asarray(series), window))
        got = sharded_ema(torch.tensor(series), window, tmesh8).gather().numpy()
        blk = T // 8
        for edge in range(blk, T, blk):
            np.testing.assert_allclose(got[edge - 1:edge + 2], want[edge - 1:edge + 2],
                                       rtol=2e-5, atol=1e-4)


class TestShardedRollingMean:
    @pytest.mark.parametrize("window", [5, 20, 50])
    def test_matches_ops_rolling_mean(self, tmesh8, mesh8, series, window):
        got = sharded_rolling_mean(torch.tensor(series), window, tmesh8).gather().numpy()
        for want in (np.asarray(_J_ROLLING_MEAN(jnp.asarray(series), window)),
                     np.asarray(_J_SHARDED_ROLLING_MEAN(jnp.asarray(series), window, mesh8))):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            m = ~np.isnan(want)
            np.testing.assert_allclose(got[m], want[m], rtol=2e-5, atol=1e-3)
        np.testing.assert_array_equal(got, ind.rolling_mean(torch.tensor(series), window).numpy())

    def test_window_too_large_for_block_raises(self, tmesh8):
        with pytest.raises(ValueError, match="halo"):
            sharded_rolling_mean(torch.zeros(64), 10, tmesh8)      # 8-candle blocks

    def test_indivisible_series_raises(self, tmesh8):
        with pytest.raises(ValueError, match="divisible"):
            sharded_rolling_mean(torch.zeros(100), 5, tmesh8)

    def test_window_one_identity(self, tmesh8, series):
        got = sharded_rolling_mean(torch.tensor(series), 1, tmesh8).gather().numpy()
        np.testing.assert_allclose(got, series, rtol=1e-6)

    def test_halo_spans_boundary(self, tmesh8):
        """A spike in the last candle of block 0 must appear in block 1's
        first window means — proof the halo travelled."""
        x = torch.zeros(T)
        blk = T // 8
        x[blk - 1] = 100.0
        got = sharded_rolling_mean(x, 5, tmesh8).gather().numpy()
        np.testing.assert_allclose(got[blk], 20.0, rtol=1e-6)       # 100/5
        np.testing.assert_allclose(got[blk + 3], 20.0, rtol=1e-6)
        assert got[blk + 4] == 0.0                                  # spike out
