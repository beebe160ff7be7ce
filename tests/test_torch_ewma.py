"""The port's fused EWMA (ops/ewma.py) against the JAX package, on the CPU.

On a CPU tensor `fused_ewma` runs its plain version, the replay of
`lax.associative_scan`'s combine tree; the CUDA kernel it stands for is
held against that plain version on the card by chip_smoke.py.  References:
the JAX Pallas kernel in interpret mode (start 0, the shapes of
tests/test_pallas.py) and the JAX `_ewm` at the seed indices the indicator
table uses.  Tolerance: NaN masks exactly, values at rtol 2e-5, atol 1e-3
(tests/test_pallas.py:23 — a sequential recursion rounds differently from
a scan).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.ops import indicators as jind  # noqa: E402
from ai_crypto_trader_tpu.ops.pallas_kernels import T_TILE  # noqa: E402
from ai_crypto_trader_tpu.ops.pallas_kernels import fused_ewma as jax_fused_ewma  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.ewma import (  # noqa: E402
    associative_scan,
    fused_ewma,
    fused_ewma_plain,
)

ALPHAS = [2.0 / 13.0, 2.0 / 27.0, 1.0 / 14.0]


def assert_ewma_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-3)


@pytest.fixture
def series(rng):
    return rng.normal(100, 5, (8, 2 * T_TILE)).astype(np.float32)


def test_matches_pallas_kernel_interpret(series):
    ref = jax_fused_ewma(jnp.asarray(series), ALPHAS, force_pallas=True,
                         interpret=True)
    got = fused_ewma(series, ALPHAS, device="cpu")
    assert got.shape == (3, 8, 2 * T_TILE)
    assert_ewma_close(got.numpy(), ref)


def test_1d_input_matches_pallas_kernel_interpret(series):
    ref = jax_fused_ewma(jnp.asarray(series[0]), [0.2], force_pallas=True,
                         interpret=True)
    got = fused_ewma(series[0], [0.2], device="cpu")
    assert got.shape == (1, 2 * T_TILE)
    assert_ewma_close(got.numpy(), ref)


def test_seeded_with_first_value(series):
    out = fused_ewma(series, [0.1], device="cpu").numpy()
    np.testing.assert_array_equal(out[0, :, 0], series[:, 0])


def _macd_line(close):
    return np.asarray(jind.macd(jnp.asarray(close))[0])


@pytest.mark.parametrize("start", [0, 1, 25])
@pytest.mark.parametrize("kind", ["close", "true_range", "macd_line"])
def test_matches_jax_ewm(kind, start):
    d = generate_ohlcv(n=1500, seed=3)
    x = {"close": d["close"],
         "true_range": np.asarray(jind.true_range(*(jnp.asarray(d[k]) for k in
                                                    ("high", "low", "close")))),
         "macd_line": _macd_line(d["close"])}[kind]
    refs = [jind._ewm(jnp.asarray(x), a, start) for a in ALPHAS]
    got = fused_ewma(x, ALPHAS, start, device="cpu")
    assert_ewma_close(got.numpy(), np.stack([np.asarray(r) for r in refs]))


@pytest.mark.parametrize("start", [0, 1, 25])
def test_batched_series_match_row_by_row(start):
    d = generate_ohlcv(n=900, seed=[3, 4, 5])
    got = fused_ewma(d["close"], ALPHAS[:2], start, device="cpu").numpy()
    assert got.shape == (2, 3, 900)
    for b in range(3):
        one = fused_ewma(d["close"][b], ALPHAS[:2], start, device="cpu").numpy()
        np.testing.assert_array_equal(got[:, b], one)
    assert np.isnan(got[..., :start]).all() and not np.isnan(got[..., start:]).any()


@pytest.mark.parametrize("n", [1, 2, 7, 256, 1001])
def test_scan_is_lax_associative_scan(rng, n):
    """The plain version's tree is `lax.associative_scan`'s, combine for
    combine: the result equals JAX's first_order_recursion exactly."""
    a = rng.uniform(0.5, 1.0, (2, n)).astype(np.float32)
    b = rng.normal(0, 10, (2, n)).astype(np.float32)
    got = associative_scan(torch.from_numpy(a), torch.from_numpy(b))[1].numpy()
    ref = np.asarray(jind.first_order_recursion(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, ref)


def test_nan_and_inf_inputs_follow_ewm():
    x = np.array([np.nan, 1.0, np.inf, 3.0, np.nan, -np.inf, 2.0, 4.0] * 8,
                 np.float32)
    for start in (0, 1, 3):
        ref = np.asarray(jind._ewm(jnp.asarray(x), 0.25, start))
        got = fused_ewma_plain(torch.from_numpy(x)[None], [0.25], start)[0, 0].numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-3)
