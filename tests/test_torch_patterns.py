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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (torch's idle threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
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


# -- the synthetic generators and training --------------------------------------

class _JaxPatternDraws:
    """The JAX generators' draws for one key, handed over: `_path`'s
    ``k_amp, k_noise, k_lvl = split(key, 3)``, `_no_pattern`'s ``k1, k2 =
    split(key)`` and `to_ohlcv`'s ``k_o, k_w, k_v = split(key, 3)``."""

    def __init__(self, key):
        self.key = key

    @staticmethod
    def _t(a):
        return torch.from_numpy(np.array(a))[None]

    def path(self, n, T):
        k_amp, k_noise, k_lvl = jax.random.split(self.key, 3)
        return (self._t(jax.random.uniform(k_amp)), self._t(jax.random.uniform(k_lvl)),
                self._t(jax.random.normal(k_noise, (T,))))

    def walk(self, n, T):
        k1, k2 = jax.random.split(self.key)
        return self._t(jax.random.normal(k1, (T,))), self._t(jax.random.normal(k2, (T,)))

    def ohlcv(self, n, T):
        k_o, k_w, k_v = jax.random.split(self.key, 3)
        return (self._t(jax.random.normal(k_o, (T,))), self._t(jax.random.normal(k_w, (2, T))),
                self._t(jax.random.normal(k_v, (T,))))


@pytest.mark.parametrize("label", range(len(PATTERN_CLASSES)))
def test_generators_follow_jax_on_handed_over_draws(label):
    """Each class's close path and its OHLCV dressing, on the JAX draws.
    Paths near 100 are held at atol 2e-5 (under 3 ulps there: XLA's and
    torch's sin, exp and cumsum round differently); the OHLCV window of the
    same close path bit for bit."""
    from ai_crypto_trader_tpu_torch.patterns import generate_pattern
    from ai_crypto_trader_tpu_torch.patterns.synthetic import to_ohlcv

    k1, k2 = jax.random.split(jax.random.PRNGKey(20 + label))
    ref = np.asarray(jsyn.generate_pattern(k1, label, 60))
    got = generate_pattern(_JaxPatternDraws(k1), label, 60)
    assert got.shape == (1, 60)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=0, atol=2e-5)
    window = to_ohlcv(_JaxPatternDraws(k2), torch.from_numpy(ref.copy())[None])
    np.testing.assert_array_equal(window[0].numpy(),
                                  np.asarray(jsyn.to_ohlcv(k2, jnp.asarray(ref))))


def test_dataset_shapes_and_labels():
    from ai_crypto_trader_tpu_torch.patterns import generate_dataset

    X, y = generate_dataset(torch.Generator().manual_seed(7), n_per_class=4, T=60, device="cpu")
    assert X.shape == (4 * 15, 60, 5) and y.shape == (60,) and y.dtype == torch.int64
    assert torch.equal(y, torch.arange(15).repeat_interleave(4))
    assert torch.isfinite(X).all()
    np.testing.assert_allclose(X[:, -1, 3].numpy(), 1.0, rtol=1e-6)    # ÷ the last close
    assert float(X[..., 4].amax()) == 1.0                              # volume ÷ its max


@pytest.fixture(scope="module")
def trained_cnn():
    return tpm.train_pattern_model(torch.Generator().manual_seed(7), "cnn", n_per_class=24,
                                   epochs=6, device="cpu")


def test_training_lowers_the_loss_with_one_read_an_epoch(monkeypatch):
    from ai_crypto_trader_tpu_torch.models import train_loop

    reads = []
    real = train_loop.host_read
    monkeypatch.setattr(train_loop, "host_read", lambda rb: reads.append(1) or real(rb))
    rec = tpm.train_pattern_model(torch.Generator().manual_seed(7), "cnn", n_per_class=24,
                                  epochs=6, device="cpu")
    losses = [h["loss"] for h in rec.history]
    assert len(reads) == len(losses) == 6
    assert losses[-1] < losses[0] * 0.7


def test_trained_classifier_recognises_held_out_patterns(trained_cnn):
    from ai_crypto_trader_tpu_torch.patterns import generate_dataset

    X, y = generate_dataset(torch.Generator().manual_seed(99), n_per_class=8, device="cpu")
    with torch.no_grad():
        acc = float((trained_cnn.logits(X).argmax(-1) == y).float().mean())
    assert acc > 0.5, f"held-out accuracy {acc:.2f}"
    out = detect_patterns(trained_cnn, X[0].numpy() * 100.0, confidence_threshold=0.2,
                          device="cpu")
    assert len(out["top_patterns"]) == 3


@pytest.mark.parametrize("model_type", ["lstm", "cnn_lstm"])
def test_other_classifiers_train(model_type):
    rec = tpm.train_pattern_model(torch.Generator().manual_seed(7), model_type, n_per_class=8,
                                  epochs=2, device="cpu")
    assert len(rec.history) == 2 and np.isfinite(rec.history[-1]["loss"])
    assert set(rec.params) == {n for n, _ in tpm._build(model_type, device="cpu")
                               .named_parameters()}
