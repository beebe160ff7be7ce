"""The port's model zoo and its serving path against the JAX package, on
the CPU.

    flax init → convert.model_from_flax → forward, for all nine
    architectures; scaler, windows, predict_prices and
    predict_prices_batched on converted TrainResults

The same NumPy inputs go through the flax module and the port's module
holding the same (converted) weights.  The recurrent scans, convolutions,
attention and layer norms sum in other orders than XLA's, so outputs are
held at atol 1e-5 (they agree to ~1e-7 at these sizes).  A price is a
scaled output times the target column's range plus its min, so prices are
held at rtol 1e-5 or that atol carried through the range, whichever is
larger.  The scaler and the windows are the same arithmetic and are held
exactly.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.models import train as jtrain  # noqa: E402
from ai_crypto_trader_tpu.models import zoo as jzoo  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.models import (  # noqa: E402
    MODEL_REGISTRY, TrainResult, build_model, fit_scaler, make_windows, predict_prices)
from ai_crypto_trader_tpu_torch.models import train  # noqa: E402
from ai_crypto_trader_tpu_torch.models.fused_lstm import lstm_scan  # noqa: E402
from ai_crypto_trader_tpu_torch.models.layers import orthogonal  # noqa: E402
from ai_crypto_trader_tpu_torch.models.zoo import (  # noqa: E402
    RecurrentEncoder, sinusoidal_positions)

ATOL = 1e-5          # model outputs, port against flax (and card against CPU)
PRICE_RTOL = 1e-5    # denormalized prices (see _assert_price)
UNITS, SEQ, F, BATCH = 16, 24, 5, 3


def _flax(model, key, x_shape):
    params = model.init(jax.random.PRNGKey(key), jnp.zeros(x_shape), False)
    return params, jax.tree.map(np.asarray, params)


@functools.cache
def _zoo_params(model_type, units=UNITS, seq_len=SEQ):
    """A flax model of the zoo and its initialised parameters (JAX and
    NumPy leaves), shared by the tests that read them."""
    jm = jzoo.build_model(model_type, units=units)
    return (jm, *_flax(jm, 1, (1, seq_len, F)))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("model_type", MODEL_REGISTRY)
def test_forward_matches_flax(model_type):
    jm, params, np_params = _zoo_params(model_type)
    x = _x((BATCH, SEQ, F))
    ref = jm.apply(params, jnp.asarray(x), False)
    model = convert.model_from_flax(model_type, np_params, {"units": UNITS}, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(ref) == ({"mean", "log_sigma"} if model_type == "probabilistic"
                                    else {"mean"})
    for k in ref:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=ATOL,
                                   err_msg=f"{model_type}.{k}")


@pytest.mark.parametrize("cell,bidirectional", [("gru", True), ("lstm", True), ("gru", False)])
def test_recurrent_encoder_directions_match_flax(cell, bidirectional):
    """The bidirectional GRU flips the batch-major time axis (1), the LSTM
    the time-major one (0); flax numbers a layer's cells forward then
    reverse."""
    jenc = jzoo.RecurrentEncoder(UNITS, 2, 0.2, cell, bidirectional)
    params, np_params = _flax(jenc, 3, (1, SEQ, F))
    x = _x((BATCH, SEQ, F), 1)
    ref = np.asarray(jenc.apply(params, jnp.asarray(x), False))
    enc = RecurrentEncoder(F, UNITS, 2, 0.2, cell, bidirectional,
                           generator=torch.Generator().manual_seed(0))
    enc.load_state_dict(convert.state_from_flax(enc, np_params))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (BATCH, SEQ, UNITS * (2 if bidirectional else 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_lstm_scan_matches_the_jax_layer():
    from ai_crypto_trader_tpu.models.fused_lstm import lstm_scan as jscan

    rng = np.random.default_rng(4)
    zx = rng.normal(size=(SEQ, BATCH, 4 * UNITS)).astype(np.float32)
    wh = np.asarray(orthogonal(UNITS, 4 * UNITS, torch.Generator().manual_seed(2)))
    ref = np.asarray(jax.jit(jscan)(jnp.asarray(zx), jnp.asarray(wh)))
    got = lstm_scan(torch.from_numpy(zx), torch.from_numpy(wh)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_full_width_lstm_batched_predict_matches_jax():
    """The service's width: 256 LSTM-64 models over 60-candle windows of
    5 columns, each lane its own weights and scaler, through both
    packages' batched prediction."""
    lanes, seq_len = 256, 60
    rng = np.random.default_rng(8)
    base = jzoo.build_model("lstm").init(jax.random.PRNGKey(7), jnp.zeros((1, seq_len, F)), False)
    stacked = jax.tree.map(        # each lane's weights: flax's draw, perturbed lane by lane
        lambda a: a * (1.0 + 0.2 * rng.normal(size=(lanes, *a.shape))).astype(np.float32), base)
    feats = np.cumsum(rng.normal(1.0, 0.2, (lanes, seq_len + 10, F)), axis=1).astype(np.float32)
    jresults, tresults = [], []
    for i in range(lanes):
        p = jax.tree.map(lambda a: a[i], stacked)
        jr = jtrain.TrainResult(params=p, model_type="lstm",
                                scaler=jtrain.fit_scaler(feats[i]),
                                model_kwargs={"units": 64}, best_val_loss=0.001 * i,
                                target_col=3)
        jresults.append(jr)
        tresults.append(convert.train_result_from_flax(jr, device="cpu"))
    fn = jtrain._batched_predict_fn("lstm", (("units", 64),))
    jmean = np.asarray(fn(stacked, jnp.stack([r.scaler.min for r in jresults]),
                          jnp.stack([r.scaler.max for r in jresults]),
                          jnp.asarray(feats[:, -seq_len:]))["mean"])[:, 0]
    reads = []
    real = train.host_read
    train.host_read = lambda rb: reads.append(real(rb)) or reads[-1]
    try:
        got = train.predict_prices_batched(tresults, list(feats), seq_len=seq_len, device="cpu")
    finally:
        train.host_read = real
    assert len(reads) == 1
    np.testing.assert_allclose(reads[0]["mean"][:, 0], jmean, rtol=0, atol=ATOL)
    ref = jtrain.predict_prices_batched(jresults, list(feats), seq_len=seq_len)
    for g, r, jr in zip(got, ref, jresults):
        _assert_price(g["predicted_price"], r["predicted_price"], jr.scaler, 3)
        assert g["confidence"] == r["confidence"]


def _assert_price(got, ref, scaler, target_col):
    rng = float(scaler.max[target_col] - scaler.min[target_col]) or 1.0
    np.testing.assert_allclose(got, ref, rtol=PRICE_RTOL, atol=ATOL * rng)


def _flat_sources(model):
    paths, shapes = [], []
    for ps, ss, _ in convert._flax_sources(model).values():
        paths += ps
        shapes += [tuple(s) for s in ss]
    return paths, shapes


def _pattern_pair(model_type):
    from ai_crypto_trader_tpu.patterns import model as jpm
    from ai_crypto_trader_tpu_torch.patterns import model as tpm

    return jpm._build(model_type), tpm._build(model_type, device="cpu")


@pytest.mark.parametrize("arch", list(MODEL_REGISTRY) + ["pattern_cnn", "pattern_lstm",
                                                         "pattern_cnn_lstm"])
def test_converter_uses_every_flax_leaf_once(arch):
    """Every leaf of the flax tree is the source of exactly one use, by
    name, at the shape the port's module needs — and the flax tree's own
    shapes are those shapes."""
    if arch.startswith("pattern_"):
        jm, model = _pattern_pair(arch[len("pattern_"):])
        _, np_params = _flax(jm, 5, (1, 60, 5))
    else:
        _, _, np_params = _zoo_params(arch)
        model = build_model(arch, units=UNITS, device="cpu")
    flat = convert._flatten(np_params)
    paths, shapes = _flat_sources(model)
    assert sorted(paths) == sorted(flat)                   # each leaf once
    assert {p: s for p, s in zip(paths, shapes)} == {p: v.shape for p, v in flat.items()}
    state = convert.state_from_flax(model, np_params)
    assert set(state) == {n for n, _ in model.named_parameters()}


def _attention_tree():
    return {k: dict(v) for k, v in _zoo_params("attention")[2]["params"].items()}


@pytest.mark.parametrize("fault", ["swapped_auto_names", "extra_leaf", "missing_leaf"])
def test_converter_refuses_a_tree_that_does_not_fit(fault):
    """A tree mapped by position or with a leaf too many or too few is
    refused: the attention model's Dense_0 is its [u/2, 1] head and
    Dense_1 its [u, u/2] layer, and swapping them fails the shape check."""
    tree = _attention_tree()
    if fault == "swapped_auto_names":
        tree["Dense_0"], tree["Dense_1"] = tree["Dense_1"], tree["Dense_0"]
        err = ValueError
    elif fault == "extra_leaf":
        tree["Dense_2"] = {"kernel": np.zeros((UNITS, 1), np.float32)}
        err = ValueError
    else:
        del tree["LayerNorm_0"]["scale"]
        err = KeyError
    with pytest.raises(err):
        convert.model_from_flax("attention", {"params": tree}, {"units": UNITS}, device="cpu")


@pytest.mark.parametrize("model_type", MODEL_REGISTRY)
def test_initialisers_follow_flax(model_type):
    """The port draws every parameter with flax's shape (checked leaf for
    leaf by the converter) and distribution: zero biases, unit LayerNorm scales, orthogonal recurrent kernels, and
    lecun-normal kernels whose sample variance lies within sampling error
    of flax's draw and of 1 / fan-in."""
    _, _, np_params = _zoo_params(model_type)
    model = build_model(model_type, units=UNITS, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    flax_state = convert.state_from_flax(model, np_params)      # raises on any shape
    for name, p in model.named_parameters():
        mine, theirs = p.detach().double(), flax_state[name].double()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias" or name.endswith("bhn"):
            assert torch.all(mine == 0) and torch.all(theirs == 0), name
        elif leaf == "scale":
            assert torch.all(mine == 1) and torch.all(theirs == 1), name
        elif leaf == "wh":
            H = mine.shape[0]
            for w in (mine, theirs):
                blocks = [w] if w.shape[1] == 4 * H else list(w.split(H, dim=1))
                for b in blocks:
                    gram = b @ b.T if b.shape[1] > b.shape[0] else b.T @ b
                    torch.testing.assert_close(gram, torch.eye(H, dtype=gram.dtype),
                                               atol=1e-5, rtol=0, msg=name)
        else:
            fan_in = mine[0].numel()                 # [out, in] or [out, in, k]
            target, n = 1.0 / fan_in, mine.numel()
            # Var of a sample variance of a normal truncated at ±2σ is
            # ~(κ − 1)σ⁴/n with kurtosis κ ≈ 2.36; bound at 6 of its sd
            sd = target * np.sqrt(1.36 / n)
            assert abs(mine.var(unbiased=False) - target) < 6 * sd, name
            gap = abs(mine.var(unbiased=False) - theirs.var(unbiased=False))
            assert gap < 6 * sd * 2 ** 0.5, name
            assert mine.abs().max() <= 2.0 * np.sqrt(target) / 0.87962566103423978 + 1e-6, name


def test_sinusoidal_positions_are_the_jax_table():
    np.testing.assert_array_equal(sinusoidal_positions(60, 64),
                                  np.asarray(jzoo.sinusoidal_positions(60, 64)))


def _features(T=90, seed=0, const_col=None):
    rng = np.random.default_rng(seed)
    f = (np.cumsum(rng.normal(0.5, 1.0, (T, F)), axis=0) + 100.0).astype(np.float32)
    if const_col is not None:
        f[:, const_col] = 42.0
    return f


def test_windows_and_scaler_are_the_jax_arithmetic():
    f = _features(const_col=2)
    for horizons, tc in (((1,), 0), ((1, 3, 5), 3)):
        X, y = make_windows(f, 24, horizons, tc)
        JX, Jy = jtrain.make_windows(f, 24, horizons, tc)
        assert X.dtype == JX.dtype and y.dtype == Jy.dtype
        np.testing.assert_array_equal(X, JX)
        np.testing.assert_array_equal(y, Jy)
    with pytest.raises(ValueError, match="too short"):
        make_windows(f[:20], 24)
    mine = fit_scaler(f.astype(np.float64), device="cpu")
    theirs = jtrain.fit_scaler(f.astype(np.float64))
    for a, b in zip(mine, theirs):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = f[-24:] * np.float32(1.01)
    np.testing.assert_array_equal(mine.transform(torch.from_numpy(x)).numpy(),
                                  np.asarray(theirs.transform(jnp.asarray(x))))
    for col in range(F):                         # column 2 has range 0
        v = np.float32(0.37)
        np.testing.assert_array_equal(
            mine.inverse(torch.tensor(v), col).numpy(),
            np.asarray(theirs.inverse(jnp.asarray(v), col)))


def _jax_results(model_type, lanes, seed):
    jm = jzoo.build_model(model_type, units=UNITS)
    out, feats = [], []
    for lane in range(lanes):
        params = jm.init(jax.random.PRNGKey(seed + lane), jnp.zeros((1, SEQ, F)), False)
        f = _features(SEQ + 30, seed + lane, const_col=2 if lane == 1 else None)
        out.append(jtrain.TrainResult(
            params=params, model_type=model_type, scaler=jtrain.fit_scaler(f),
            model_kwargs={"units": UNITS}, best_val_loss=0.003 * (lane + 1),
            target_col=(0, 2, 3)[lane % 3]))
        feats.append(f)
    return out, feats


@pytest.mark.parametrize("model_type", ["lstm", "probabilistic"])
def test_predict_prices_follow_jax(model_type):
    """Mixed target columns, one of them constant (range 0), and the
    probabilistic head's std: the port's single and batched predictions
    give the JAX package's prices and confidences, and a lane of the batch
    equals the single prediction."""
    jresults, feats = _jax_results(model_type, 3, 20)
    tresults = [convert.train_result_from_flax(r, device="cpu") for r in jresults]
    batched = train.predict_prices_batched(tresults, feats, seq_len=SEQ, device="cpu")
    jbatched = jtrain.predict_prices_batched(jresults, feats, seq_len=SEQ)
    for tr, jr, f, b, jb in zip(tresults, jresults, feats, batched, jbatched):
        single = predict_prices(tr, f, seq_len=SEQ, device="cpu")
        jsingle = jtrain.predict_prices(jr, f, seq_len=SEQ)
        assert set(single) == set(jsingle) and set(b) == set(jb)
        for got, ref in ((single, jsingle), (b, jb)):
            assert np.shape(got["predicted_price"]) == np.shape(ref["predicted_price"])
            _assert_price(got["predicted_price"], ref["predicted_price"], jr.scaler,
                          jr.target_col)
            assert got["confidence"] == ref["confidence"]
            if "predicted_std" in ref:
                _assert_price(got["predicted_std"], ref["predicted_std"], jr.scaler,
                              jr.target_col)
        # a lane of the batch is the single prediction (JAX's batched price is
        # 0-d, its single one [1]; over a range-0 column the single std is 0)
        _assert_price(b["predicted_price"], single["predicted_price"][0], jr.scaler,
                      jr.target_col)
    # the constant column's lane: range 0, so the price is the scaled output + 42
    assert jresults[1].target_col == 2
    _assert_price(batched[1]["predicted_price"], jbatched[1]["predicted_price"],
                  jresults[1].scaler, 2)


def test_batched_predict_keeps_the_stack_and_reads_once():
    """The stacked parameters stay put while the same results come back
    (the windows alone change); a replaced result restacks.  Each call is
    one host read."""
    jresults, feats = _jax_results("gru", 3, 40)
    tresults = [convert.train_result_from_flax(r, device="cpu") for r in jresults]
    reads = []
    real = train.host_read
    train.host_read = lambda rb: reads.append(1) or real(rb)
    try:
        first = train.predict_prices_batched(tresults, feats, seq_len=SEQ, device="cpu")
        prog = train._BATCHED_PREDICT_FNS[("gru", (("units", UNITS),), F, "cpu")]
        held = prog._stacked
        shifted = [f * np.float32(1.001) for f in feats]
        train.predict_prices_batched(tresults, shifted, seq_len=SEQ, device="cpu")
        assert prog._stacked is held
        swapped = list(tresults)
        swapped[0] = convert.train_result_from_flax(jresults[2], device="cpu")
        again = train.predict_prices_batched(swapped, feats, seq_len=SEQ, device="cpu")
        assert prog._stacked is not held
    finally:
        train.host_read = real
    assert len(reads) == 3
    ref = jtrain.predict_prices(jresults[2], feats[0], seq_len=SEQ)
    _assert_price(again[0]["predicted_price"], ref["predicted_price"], jresults[2].scaler,
                  jresults[2].target_col)
    np.testing.assert_array_equal(again[1]["predicted_price"], first[1]["predicted_price"])


@pytest.mark.parametrize("change", ["weight_in_place", "weight_replaced", "scaler_in_place"])
def test_batched_predict_restacks_a_lane_changed_since(change):
    """A lane whose weights or scaler changed since the last call — in
    place, as an optimizer's step changes them, or put anew under their
    name — is restacked: the batch predicts from the current tensors, as
    the JAX package, which stacks on every call, does."""
    jresults, feats = _jax_results("gru", 3, 40)
    tresults = [convert.train_result_from_flax(r, device="cpu") for r in jresults]
    first = train.predict_prices_batched(tresults, feats, seq_len=SEQ, device="cpu")
    prog = train._BATCHED_PREDICT_FNS[("gru", (("units", UNITS),), F, "cpu")]
    held = prog._stacked
    lane = tresults[2]
    head_bias = [k for k, v in lane.params.items() if k.endswith("bias") and v.shape == (1,)]
    assert len(head_bias) == 1
    if change == "weight_in_place":
        lane.params[head_bias[0]].add_(0.25)
    elif change == "weight_replaced":
        lane.params[head_bias[0]] = lane.params[head_bias[0]] + 0.25
    else:
        lane.scaler.max.mul_(1.5)
    again = train.predict_prices_batched(tresults, feats, seq_len=SEQ, device="cpu")
    assert prog._stacked is not held
    single = predict_prices(lane, feats[2], seq_len=SEQ, device="cpu")
    _assert_price(again[2]["predicted_price"], single["predicted_price"][0], lane.scaler,
                  lane.target_col)
    assert not np.allclose(again[2]["predicted_price"], first[2]["predicted_price"])
    for i in (0, 1):                     # the unchanged lanes predict as before
        np.testing.assert_array_equal(again[i]["predicted_price"], first[i]["predicted_price"])


def test_train_result_module_and_fields():
    jresults, feats = _jax_results("multitask", 1, 60)
    tr = convert.train_result_from_flax(jresults[0], device="cpu")
    assert (tr.model_type, tr.model_kwargs, tr.target_col, tr.features) == \
        ("multitask", {"units": UNITS}, jresults[0].target_col, F)
    assert tr.best_val_loss == jresults[0].best_val_loss
    x = _x((2, SEQ, F), 9)
    with torch.no_grad():
        got = tr.model()(torch.from_numpy(x))["mean"].numpy()
    ref = jzoo.build_model("multitask", units=UNITS).apply(jresults[0].params, jnp.asarray(x))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, np.asarray(ref["mean"]), rtol=0, atol=ATOL)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_DEFAULT_DEVICE = {
    "build_model": lambda: build_model("lstm", units=8),
    "fit_scaler": lambda: fit_scaler(_features()),
    "predict_prices": lambda: predict_prices(
        TrainResult(build_model("lstm", units=8, device="cpu").state_dict(), "lstm",
                    fit_scaler(_features(), device="cpu"), {"units": 8}), _features()),
    "model_from_flax": lambda: convert.model_from_flax("attention", _attention_tree(),
                                                       {"units": UNITS}),
    "train_result_from_flax": lambda: convert.train_result_from_flax(
        _jax_results("lstm", 1, 0)[0][0]),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE))
def test_default_device_is_cuda_and_raises_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _DEFAULT_DEVICE[entry]()

