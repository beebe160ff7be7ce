"""The port's chart-pattern classifier against the JAX package, on the CPU.

    OHLCV [T, 5] → windows (seq_len 60, stride 5) → preprocess → CNN /
    LSTM / CNN-LSTM on flax-initialised weights → softmax → averaged, top 3,
    verdict

The classifiers sum in other orders than XLA's, so probabilities are held
at atol 1e-5; the top 3, the verdict and the completion must be equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.patterns import model as jpm  # noqa: E402
from ai_crypto_trader_tpu.patterns import synthetic as jsyn  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.patterns import model as tpm  # noqa: E402
from ai_crypto_trader_tpu_torch.patterns import (  # noqa: E402
    PATTERN_CLASSES, PATTERN_IMPLICATIONS, detect_patterns, preprocess_window)

ATOL = 1e-5          # probabilities, port against flax
CLASSIFIERS = ("cnn", "lstm", "cnn_lstm")


def _ohlcv(T=256, seed=0, zero_volume=False):
    rng = np.random.default_rng(seed)
    close = 100.0 * np.exp(np.cumsum(rng.normal(0.0, 0.01, T)))
    open_ = np.concatenate([[close[0]], close[:-1]])
    high = np.maximum(open_, close) * (1.0 + rng.uniform(0, 0.005, T))
    low = np.minimum(open_, close) * (1.0 - rng.uniform(0, 0.005, T))
    vol = np.zeros(T) if zero_volume else rng.uniform(10.0, 1000.0, T)
    return np.stack([open_, high, low, close, vol], axis=1).astype(np.float32)


def _pair(model_type, key=3):
    params = jpm._build(model_type).init(jax.random.PRNGKey(key), jnp.zeros((1, 60, 5)), False)
    jrec = jpm.PatternRecognizer(model_type=model_type, params=params)
    trec = convert.recognizer_from_flax(model_type, jax.tree.map(np.asarray, params),
                                        device="cpu")
    return jrec, trec


def test_vocabulary_is_the_jax_package_vocabulary():
    assert PATTERN_CLASSES == jsyn.PATTERN_CLASSES
    assert tpm.N_CLASSES == jsyn.N_CLASSES
    assert PATTERN_IMPLICATIONS == jpm.PATTERN_IMPLICATIONS


@pytest.mark.parametrize("zero_volume", [False, True])
def test_preprocess_window_follows_jax(zero_volume):
    w = _ohlcv(60, 1, zero_volume)
    got = preprocess_window(torch.from_numpy(w)).numpy()
    ref = np.asarray(jpm.preprocess_window(jnp.asarray(w)))
    np.testing.assert_array_equal(got, ref)
    if zero_volume:
        assert np.all(got[:, 4] == 0.0)
    batch = np.stack([w, _ohlcv(60, 2)])                  # leading window axis
    np.testing.assert_array_equal(preprocess_window(torch.from_numpy(batch)).numpy()[0], got)


@pytest.mark.parametrize("model_type", CLASSIFIERS)
def test_window_probs_follow_jax(model_type):
    jrec, trec = _pair(model_type)
    x = _ohlcv(256, 4)
    ref = np.asarray(jpm._window_probs(jrec.params, model_type, jnp.asarray(x), 60, 5))
    got = tpm._window_probs(trec.params, model_type, torch.from_numpy(x), 60, 5).numpy()
    assert got.shape == ref.shape == (40, len(PATTERN_CLASSES))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    windows = jnp.stack([jpm.preprocess_window(jnp.asarray(x[s:s + 60])) for s in (0, 5)])
    with torch.no_grad():
        logits = trec.logits(torch.from_numpy(np.array(windows))).numpy()
    np.testing.assert_allclose(logits, np.asarray(jrec.logits(windows)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("model_type", CLASSIFIERS)
@pytest.mark.parametrize("threshold", [0.5, 0.0])
def test_detect_patterns_follows_jax(model_type, threshold):
    """The verdict at the default threshold (a random-init classifier's
    near-uniform softmax detects nothing) and at 0 (the top pattern is
    primary unless it is no_pattern): same top 3, verdict, primary and
    completion."""
    jrec, trec = _pair(model_type, key=5)
    x = _ohlcv(256, 6)
    ref = jpm.detect_patterns(jrec, x, confidence_threshold=threshold)
    got = detect_patterns(trec, x, confidence_threshold=threshold, device="cpu")
    assert set(got) == set(ref)
    names = lambda out: [t["pattern"] for t in out["top_patterns"]]  # noqa: E731
    assert names(got) == names(ref)
    np.testing.assert_allclose([t["probability"] for t in got["top_patterns"]],
                               [t["probability"] for t in ref["top_patterns"]], rtol=0, atol=ATOL)
    np.testing.assert_allclose(list(got["all_probabilities"].values()),
                               list(ref["all_probabilities"].values()), rtol=0, atol=ATOL)
    assert got["detected"] == ref["detected"]
    for k in ("primary_pattern", "completion", "implications"):
        assert got.get(k) == ref.get(k), k
    if "confidence" in ref:
        assert got["confidence"] == pytest.approx(ref["confidence"], abs=ATOL)
    if threshold == 0.0:
        assert got["detected"] or got["top_patterns"][0]["pattern"] == "no_pattern"


def test_insufficient_data():
    _, trec = _pair("cnn")
    short = _ohlcv(59, 7)
    assert detect_patterns(trec, short, device="cpu") == \
        jpm.detect_patterns(jpm.PatternRecognizer(), short) == \
        {"detected": False, "reason": "insufficient_data"}


@pytest.mark.parametrize("primary", [0, 3])
def test_pattern_completion_is_the_jax_heuristic(primary):
    probs = np.random.default_rng(primary).uniform(size=(40, len(PATTERN_CLASSES)))
    assert tpm.pattern_completion(probs, primary) == jpm.pattern_completion(probs, primary)
    assert tpm.pattern_completion(np.zeros((0, 15)), primary) == 0.0


def test_recognizer_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.recognizer_from_flax("cnn", jax.tree.map(
            np.asarray, jpm._build("cnn").init(jax.random.PRNGKey(0), jnp.zeros((1, 60, 5)))))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpm._build("lstm")
