"""The port's training of the model zoo against the JAX package, on the CPU.

    LSTMScan (the hand-written backward) ↔ jax.grad of the custom VJP;
    train_loop.Adam ↔ optax.inject_hyperparams(optax.adam);
    EpochTrainer ↔ the JAX EpochTrainer, every architecture;
    train_model ↔ the JAX train_model through a draw provider that hands
    over the JAX key schedule's draws; feature_importance; HPO's trial
    sequence; dropout on handed-over keep masks; checkpoints.

Sizes are small (units 16, T 24, F 5).  Tolerances, and why:
  * gradients of the LSTM layer: atol 1e-5 on O(1) values — the bulk
    cofactors and the products sum in other orders than XLA's fused
    program (~1e-6 seen);
  * Adam on given gradients: rtol 1e-6 on the parameters (kept at the
    updates' scale, so p + u's own rounding stays below that) and the
    moments — the same float32 operations, but XLA contracts some
    multiply-adds into one rounding;
  * a training run: losses at rtol 1e-5 and parameters at atol 1e-5 after
    a few epochs (~1e-7 to 2e-6 seen) — each step's gradient carries the
    forward's ~1e-7 differences, and Adam's first steps (u ≈ g / |g|)
    weigh a small gradient's error as much as a large one's;
  * the attention key bias: the softmax ignores a constant shift of every
    query's logits, so that bias's gradient is rounding noise in both
    packages, and Adam scales noise up to about ±lr a step.  It is held to
    lr × steps; every other parameter to the atol above.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ai_crypto_trader_tpu.models import train as jtrain  # noqa: E402
from ai_crypto_trader_tpu.models import train_loop as jtl  # noqa: E402
from ai_crypto_trader_tpu.models import zoo as jzoo  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.models import (  # noqa: E402
    MODEL_REGISTRY, TrainResult, build_model, fit_scaler, hpo, importance, layers, train,
    train_loop)
from ai_crypto_trader_tpu_torch.models.fused_lstm import LSTMScan, _scan, lstm_scan  # noqa: E402
from ai_crypto_trader_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)

UNITS, SEQ, F = 16, 24, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (torch's idle threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
GRAD_ATOL = 1e-5
ADAM_RTOL = 1e-6
RUN_RTOL = RUN_ATOL = 1e-5


def _features(n=160, f=F, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = 100 + 10 * np.sin(t / 20) + rng.normal(0, 0.5, n)
    cols = [base] + [rng.normal(0, 1, n) for _ in range(f - 1)]
    return np.stack(cols, axis=1).astype(np.float32)


def _kwargs(model_type, dropout=0.0, units=UNITS):
    horizons = (1, 3, 5) if model_type == "multitask" else (1,)
    return dict(units=units, dropout=dropout, horizons=horizons)


def _assert_params(got: dict, ref: dict, lr: float, steps: int, label: str):
    for k, v in got.items():
        diff = float((v.detach() - ref[k]).abs().max())
        bound = lr * steps if k.endswith("key.bias") else RUN_ATOL
        assert diff <= bound, f"{label} {k}: {diff:.3g} > {bound:.3g}"


# -- the LSTM's hand-written backward ----------------------------------------

def test_lstm_function_forward_and_gradients():
    """LSTMScan's forward is the plain loop bit for bit; its dzx and dwh
    follow jax.grad through the JAX layer's custom VJP and torch autograd
    through the plain loop."""
    from ai_crypto_trader_tpu.models.fused_lstm import lstm_scan as jscan

    rng = np.random.default_rng(0)
    zx = rng.normal(size=(SEQ, 3, 4 * UNITS)).astype(np.float32)
    wh = (rng.normal(size=(UNITS, 4 * UNITS)) * 0.3).astype(np.float32)
    w = rng.normal(size=(SEQ, 3, UNITS)).astype(np.float32)
    loss = lambda z, h: jnp.sum(jscan(z, h) * w)  # noqa: E731
    jdz, jdw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(zx), jnp.asarray(wh))

    tz, tw = torch.from_numpy(zx).requires_grad_(), torch.from_numpy(wh).requires_grad_()
    hs = lstm_scan(tz, tw)
    assert hs.grad_fn is not None and "LSTMScan" in type(hs.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(hs, _scan(tz, tw, keep=False))
    dz, dw = torch.autograd.grad((hs * torch.from_numpy(w)).sum(), (tz, tw))
    np.testing.assert_allclose(dz.numpy(), np.asarray(jdz), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0, atol=GRAD_ATOL)
    pz, pw = torch.autograd.grad((_scan(tz, tw, keep=False) * torch.from_numpy(w)).sum(),
                                 (tz, tw))
    torch.testing.assert_close(dz, pz, rtol=0, atol=GRAD_ATOL)
    torch.testing.assert_close(dw, pw, rtol=0, atol=GRAD_ATOL)
    # the input's gradient alone (as feature importance takes it)
    (dz_only,) = torch.autograd.grad(LSTMScan.apply(tz, tw.detach()).mul(
        torch.from_numpy(w)).sum(), tz)
    torch.testing.assert_close(dz_only, dz, rtol=0, atol=0)


def test_inference_is_the_plain_loop_with_autograd_on():
    """A forward with parameters that need gradients (the Function's path)
    gives the bits of the no-grad forward (the serving path)."""
    model = build_model("bidirectional", units=UNITS, dropout=0.0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, SEQ, F)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)["mean"]
    got = model(x)["mean"]
    assert got.requires_grad and torch.equal(got.detach(), ref)


# -- Adam ----------------------------------------------------------------------

def test_adam_follows_optax_with_the_lr_changed_midway():
    rng = np.random.default_rng(3)
    # parameters at the updates' scale, so p + u's rounding is far below u's
    p0 = {"a": (rng.normal(size=(4, 3)) * 1e-2).astype(np.float32),
          "b": (rng.normal(size=(5,)) * 1e-2).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, v in p0.items()} for _ in range(10)]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    mine = train_loop.Adam(1e-2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = mine.init(tp)
    for step, g in enumerate(grads):
        if step == 5:
            js.hyperparams["learning_rate"] = jnp.asarray(3e-3)
            ts.hyperparams["learning_rate"].fill_(3e-3)
        updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        ts = mine.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=ADAM_RTOL,
                                       atol=0, err_msg=f"step {step} {k}")
    assert int(ts.count) == int(js.count) == 10
    inner = js.inner_state[0]
    for k in p0:
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(inner.mu[k]), rtol=ADAM_RTOL)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(inner.nu[k]), rtol=ADAM_RTOL)


def test_matmul_precision_restores_the_flags():
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    for p in ("tf32", "bf16", "f32", None):
        with pytest.raises(KeyError):
            with train_loop.matmul_precision(p):
                if p in ("tf32", "bf16"):
                    assert torch.get_float32_matmul_precision() in ("high", "medium")
                raise KeyError("leave the context by an error")
        assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(ValueError):
        train_loop.matmul_precision("f16").__enter__()


# -- the epoch trainer, every architecture ------------------------------------

def _epoch_case(model_type, n=48, batch=16, epochs=2, lr=1e-3):
    """Both packages' EpochTrainer from the same flax init over the same
    data and handed-over permutations: ([2] metrics per epoch, params) for
    each."""
    kw = _kwargs(model_type)
    rng = np.random.default_rng(11)
    X = rng.normal(size=(n, SEQ, F)).astype(np.float32)
    y = rng.normal(size=(n, len(kw["horizons"]))).astype(np.float32)
    Xv = rng.normal(size=(16, SEQ, F)).astype(np.float32)
    yv = rng.normal(size=(16, len(kw["horizons"]))).astype(np.float32)
    jm = jzoo.build_model(model_type, **kw)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jnp.zeros((1, SEQ, F)), False))

    tx = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    jtrainer = jtl.EpochTrainer(
        lambda p, xb, yb, r: jtrain._loss_fn(jm.apply(p, xb, True, rngs={"dropout": r}), yb,
                                             model_type), tx,
        eval_loss_fn=lambda p, xb, yb: jtrain._loss_fn(jm.apply(p, xb, False), yb, model_type))
    jp = jax.tree.map(jnp.asarray, init)
    js = tx.init(jp)
    keys = [jax.random.PRNGKey(100 + e) for e in range(epochs)]
    jmetrics = []
    for k in keys:
        jp, js, m = jtrainer.epoch(jp, js, jnp.asarray(X), jnp.asarray(y), k, k,
                                   jnp.asarray(Xv), jnp.asarray(yv), batch_size=batch)
        jmetrics.append(np.asarray(m))

    model = convert.model_from_flax(model_type, init, kw, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    tmpl = train._template(model_type, tuple(sorted(kw.items())), F)
    from torch.func import functional_call
    ttx = train_loop.Adam(lr)
    trainer = train_loop.EpochTrainer(
        lambda p, xb, yb, g: train._loss_fn(functional_call(tmpl, p, (xb, True),
                                                            {"generator": g}), yb, model_type),
        ttx, eval_loss_fn=lambda p, xb, yb: train._loss_fn(
            functional_call(tmpl, p, (xb, False)), yb, model_type), device="cpu")
    ts = ttx.init(params)
    tmetrics = []
    for k in keys:
        perm = np.asarray(jax.random.permutation(k, n))
        params, ts, m = trainer.epoch(params, ts, torch.from_numpy(X), torch.from_numpy(y),
                                      perm, None, torch.from_numpy(Xv), torch.from_numpy(yv),
                                      batch_size=batch)
        tmetrics.append(train_loop.host_read(m))
    steps = epochs * (n // batch)
    return jmetrics, convert.state_from_flax(model, jp), tmetrics, params, lr, steps


@pytest.mark.parametrize("model_type", MODEL_REGISTRY)
def test_epoch_trainer_follows_jax(model_type):
    jmetrics, jstate, tmetrics, params, lr, steps = _epoch_case(model_type)
    np.testing.assert_allclose(np.stack(tmetrics), np.stack(jmetrics), rtol=RUN_RTOL, atol=0)
    _assert_params(params, jstate, lr, steps, model_type)


# -- train_model through handed-over draws -------------------------------------

class JaxKeyDraws:
    """A draw provider holding the JAX train_model's draws for ``key``:
    ``k_init, k_drop, key = split(key, 3)``; the flax init from k_init;
    per epoch ``key, k_shuf, k_ep = split(key, 3)`` and
    ``jax.random.permutation(k_shuf, n)``."""

    generator = None          # runs at dropout 0 draw no keep mask

    def __init__(self, key, model_type, kwargs, seq_len, n_features):
        k_init, _, self.key = jax.random.split(key, 3)
        jm = jzoo.build_model(model_type, **kwargs)
        self.flax = jax.tree.map(np.asarray, jm.init(k_init, jnp.zeros((2, seq_len, n_features)),
                                                     False))
        self.perms = []

    def init_params(self, build):
        model = build(generator=torch.Generator())
        return convert.state_from_flax(model, self.flax)

    def permutation(self, epoch, n):
        while len(self.perms) <= epoch:
            self.key, k_shuf, _ = jax.random.split(self.key, 3)
            self.perms.append(np.asarray(jax.random.permutation(k_shuf, n)))
        return self.perms[epoch]


# model_type and train_model keywords.  At lr 2e-2 the plateau cuts the LR
# at epoch 3 and the run stops early, at 4 of 8 epochs.
_RUNS = {
    "lstm_plateau_and_early_stop": ("lstm", dict(epochs=8, learning_rate=2e-2,
                                                  reduce_lr_patience=1,
                                                  early_stopping_patience=2)),
    "multitask": ("multitask", dict(epochs=3)),
    "probabilistic": ("probabilistic", dict(epochs=3, reduce_lr_patience=1)),
}


def _both_runs(case, **extra):
    model_type, kw = _RUNS[case]
    kw = dict(seq_len=12, units=UNITS, dropout=0.0, batch_size=16, **kw, **extra)
    f = _features()
    key = jax.random.PRNGKey(4)
    ref = jtrain.train_model(key, f, model_type, **kw)
    draws = JaxKeyDraws(key, model_type, _kwargs(model_type), 12, F)
    return ref, draws, f, kw


@pytest.mark.parametrize("case", sorted(_RUNS))
def test_train_model_follows_jax(case):
    """The same scaler, split and history (losses within RUN_RTOL), lr
    schedule, epochs run and best val loss as the JAX train_model given
    the same key, its draws handed over."""
    ref, draws, f, kw = _both_runs(case)
    model_type = _RUNS[case][0]
    got = train.train_model(draws, f, model_type, device="cpu", **kw)
    np.testing.assert_array_equal(got.scaler.min.numpy(), np.asarray(ref.scaler.min))
    np.testing.assert_array_equal(got.scaler.max.numpy(), np.asarray(ref.scaler.max))
    assert got.epochs_run == ref.epochs_run and len(got.history) == len(ref.history)
    for g, r in zip(got.history, ref.history):
        assert (g["epoch"], g["lr"]) == (r["epoch"], r["lr"])
        np.testing.assert_allclose([g["loss"], g["val_loss"]], [r["loss"], r["val_loss"]],
                                   rtol=RUN_RTOL, atol=0)
    np.testing.assert_allclose(got.best_val_loss, ref.best_val_loss, rtol=RUN_RTOL)
    assert (got.model_type, got.target_col) == (model_type, ref.target_col)
    assert got.model_kwargs == ref.model_kwargs
    _assert_params(got.params, convert.state_from_flax(got.model(), ref.params), 0.0, 0, case)
    if case.startswith("lstm_plateau"):
        lrs = [h["lr"] for h in got.history]
        assert lrs[-1] < lrs[0] and got.epochs_run < kw["epochs"], (lrs, got.epochs_run)


def test_per_batch_loop_follows_the_epoch_trainer():
    """compiled_epoch=False (a host read a batch) gives the same trajectory."""
    ref, draws, f, kw = _both_runs("lstm_plateau_and_early_stop")
    a = train.train_model(draws, f, "lstm", device="cpu", **kw)
    b = train.train_model(draws, f, "lstm", device="cpu", compiled_epoch=False, **kw)
    assert a.epochs_run == b.epochs_run
    for x, y in zip(a.history, b.history):
        assert x["lr"] == y["lr"]
        np.testing.assert_allclose([x["loss"], x["val_loss"]], [y["loss"], y["val_loss"]],
                                   rtol=1e-6, atol=0)


def test_one_host_read_an_epoch(monkeypatch):
    reads = []
    real = train_loop.host_read
    monkeypatch.setattr(train_loop, "host_read", lambda rb: reads.append(1) or real(rb))
    r = train.train_model(torch.Generator().manual_seed(0), _features(120), "lstm",
                          seq_len=8, units=8, epochs=3, batch_size=32,
                          early_stopping_patience=10, device="cpu")
    assert len(reads) == r.epochs_run == 3
    assert all(np.isfinite([h["loss"], h["val_loss"]]).all() for h in r.history)


@pytest.mark.parametrize("precision", ["bf16", "tf32"])
def test_precision_knob_trains_and_leaves_the_flags(precision):
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    r = train.train_model(torch.Generator().manual_seed(0), _features(120), "lstm", seq_len=8,
                          units=8, epochs=2, batch_size=32, precision=precision,
                          device="cpu")
    assert np.isfinite([[h["loss"], h["val_loss"]] for h in r.history]).all()
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32) == before


def test_generator_runs_repeat_and_train_with_dropout():
    """A torch.Generator drives every draw: the same seed gives the same
    run (dropout 0.2 included), another seed another run."""
    f = _features(120)
    run = lambda seed: train.train_model(  # noqa: E731
        torch.Generator().manual_seed(seed), f, "attention", seq_len=8, units=8, epochs=2,
        batch_size=16, device="cpu")
    a, b, c = run(1), run(1), run(2)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert [h["loss"] for h in a.history] != [h["loss"] for h in c.history]
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_predicting_after_training_in_place_restacks():
    """TrainResult.params trained further in place (their version counters
    move) are what the next batched predict uses."""
    f = [_features(80, seed=s) for s in range(3)]
    results = [train.train_model(torch.Generator().manual_seed(s), f[s], "lstm", seq_len=12,
                                 units=8, epochs=1, batch_size=16, target_col=0,
                                 device="cpu") for s in range(3)]
    first = train.predict_prices_batched(results, f, seq_len=12, device="cpu")
    lane = results[1]
    tmpl = train._template("lstm", train._kwargs_key(lane), F)
    from torch.func import functional_call
    tx = train_loop.Adam(5e-2)
    trainer = train_loop.EpochTrainer(
        lambda p, xb, yb, g: train._loss_fn(functional_call(tmpl, p, (xb, True),
                                                            {"generator": g}), yb, "lstm"), tx,
        device="cpu")
    X = torch.from_numpy(np.random.default_rng(5).normal(size=(32, 12, F)).astype(np.float32))
    before = {k: v.clone() for k, v in lane.params.items()}
    g = torch.Generator().manual_seed(0)
    trainer.epoch(lane.params, tx.init(lane.params), X, torch.ones(32, 1), g, g, batch_size=16)
    assert not all(torch.equal(before[k], lane.params[k]) for k in before)
    again = train.predict_prices_batched(results, f, seq_len=12, device="cpu")
    single = train.predict_prices(lane, f[1], seq_len=12, device="cpu")
    np.testing.assert_allclose(again[1]["predicted_price"], single["predicted_price"],
                               rtol=1e-6)
    assert not np.allclose(again[1]["predicted_price"], first[1]["predicted_price"])
    for i in (0, 2):
        np.testing.assert_array_equal(again[i]["predicted_price"], first[i]["predicted_price"])


# -- dropout -------------------------------------------------------------------

class _HandedMask:
    """Stands in for `layers.keep_mask`: hands over JAX keep masks and
    records the shapes asked for."""

    def __init__(self, masks):
        self.masks, self.shapes = list(masks), []

    def __call__(self, shape, rate, generator):
        self.shapes.append(tuple(shape))
        return torch.from_numpy(np.array(self.masks.pop(0)))


@pytest.mark.parametrize("rate,shape", [(0.3, None), (0.5, (4, 1, 8))])
def test_dropout_is_flax_on_a_handed_over_mask(monkeypatch, rate, shape):
    import flax.linen as fnn

    x = np.random.default_rng(6).normal(size=(4, 6, 8)).astype(np.float32)
    k = jax.random.PRNGKey(9)
    bdims = () if shape is None else (1,)
    ref = fnn.Dropout(rate, broadcast_dims=bdims).apply({}, jnp.asarray(x), deterministic=False,
                                                        rng=k)
    mask = jax.random.bernoulli(k, 1.0 - rate, x.shape if shape is None else shape)
    handed = _HandedMask([mask])
    monkeypatch.setattr(layers, "keep_mask", handed)
    got = layers.dropout(torch.from_numpy(x), rate, torch.Generator(), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert handed.shapes == [x.shape if shape is None else shape]


def test_attention_dropout_is_flax_with_one_mask_for_every_row_and_head(monkeypatch):
    import flax.linen as fnn

    B, T, D, heads, rate = 3, 7, 16, 4, 0.25
    x = np.random.default_rng(7).normal(size=(B, T, D)).astype(np.float32)
    jmha = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=D, dropout_rate=rate)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x), deterministic=True)
    k = jax.random.PRNGKey(3)
    ref = jmha.apply(params, jnp.asarray(x), jnp.asarray(x), deterministic=False, dropout_rng=k)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.MultiHeadDotProductAttention_0 = layers.MultiHeadDotProductAttention(
                D, heads, D, torch.Generator(), dropout_rate=rate)

    holder = Holder()
    holder.load_state_dict(convert.state_from_flax(
        holder, {"MultiHeadDotProductAttention_0": jax.tree.map(np.asarray,
                                                                params["params"])}))
    handed = _HandedMask([jax.random.bernoulli(k, 1.0 - rate, (1, 1, T, T))])
    monkeypatch.setattr(layers, "keep_mask", handed)
    with torch.no_grad():
        got = holder.MultiHeadDotProductAttention_0(torch.from_numpy(x), True,
                                                    generator=torch.Generator())
    assert handed.shapes == [(1, 1, T, T)]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    with torch.no_grad():       # eval mode draws nothing
        holder.MultiHeadDotProductAttention_0(torch.from_numpy(x))
    assert len(handed.shapes) == 1


@pytest.mark.parametrize("model_type", MODEL_REGISTRY)
def test_train_mode_draws_only_from_its_generator(model_type):
    model = build_model(model_type, units=8, dropout=0.3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(4, 12, F)).astype(np.float32))
    state = torch.get_rng_state()
    with torch.no_grad():
        def run(seed):
            return model(x, True, generator=torch.Generator().manual_seed(seed))["mean"]

        a, b, c = run(1), run(1), run(2)
        with pytest.raises(ValueError, match="Generator"):
            model(x, True)
        assert torch.equal(model(x)["mean"], model(x, False, generator=None)["mean"])
    assert torch.equal(torch.get_rng_state(), state)        # the global generator untouched
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_classifiers_drop_only_with_a_generator():
    from ai_crypto_trader_tpu_torch.patterns.model import _build

    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 60, 5)).astype(np.float32))
    for mt in ("cnn", "lstm", "cnn_lstm"):
        model = _build(mt, device="cpu")
        with torch.no_grad():
            with pytest.raises(ValueError, match="Generator"):
                model(x, True)
            a = model(x, True, generator=torch.Generator().manual_seed(4))
            b = model(x, True, generator=torch.Generator().manual_seed(4))
            assert torch.equal(a, b) and not torch.equal(a, model(x))


# -- feature importance ----------------------------------------------------------

@pytest.mark.parametrize("model_type", ["lstm", "transformer"])
def test_feature_importance_follows_jax(model_type):
    from ai_crypto_trader_tpu.models.importance import feature_importance as jfi

    kw = dict(units=UNITS)
    jm = jzoo.build_model(model_type, **kw)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, SEQ, F)), False)
    X = np.random.default_rng(3).normal(size=(6, SEQ, F)).astype(np.float32)
    names = ["open", "high", "low", "close", "volume"]
    ref = jfi(params, model_type, jnp.asarray(X), steps=8, feature_names=names, model_kwargs=kw)
    model = convert.model_from_flax(model_type, jax.tree.map(np.asarray, params), kw,
                                    device="cpu")
    got = importance.feature_importance({k: v.detach() for k, v in model.named_parameters()},
                                        model_type, X, steps=8, feature_names=names,
                                        model_kwargs=kw, device="cpu")
    np.testing.assert_allclose([got["importances"][n] for n in names],
                               [ref["importances"][n] for n in names], rtol=0, atol=1e-5)
    assert abs(sum(got["importances"].values()) - 1.0) < 1e-5
    assert got["ranked"][0] == ref["ranked"][0]


# -- HPO -------------------------------------------------------------------------

class _FakeResult:
    def __init__(self, trial):
        self.best_val_loss = (float(np.log(trial["learning_rate"])) + 6.0) ** 2 * 0.01 \
            + (trial["dropout"] - 0.3) ** 2 + trial["units"] * 1e-4 \
            + trial["batch_size"] * 1e-5 + len(str(trial["model_type"])) * 1e-3


def _fake_train(*args, **kw):
    mt = args[2] if len(args) > 2 else kw["model_type"]
    return _FakeResult({"model_type": mt, **{k: kw[k] for k in
                                             ("units", "dropout", "learning_rate",
                                              "batch_size")}})


def test_hpo_trial_sequence_follows_jax(monkeypatch):
    """The same default_rng(seed) draws, TPE included, give the JAX trial
    sequence for equal val losses (injected as a function of the trial)."""
    from ai_crypto_trader_tpu.models import hpo as jhpo

    monkeypatch.setattr(jhpo, "train_model", _fake_train)
    monkeypatch.setattr(hpo, "train_model", _fake_train)
    kw = dict(n_trials=9, n_startup=3, rung_epochs=(1, 2), seed=5)
    ref = jhpo.optimize_hyperparameters(jax.random.PRNGKey(0), _features(), **kw)
    got = hpo.optimize_hyperparameters(torch.Generator(), _features(), device="cpu", **kw)
    assert got == ref
    assert len(got["trials"]) == 9 and got["best_params"] in [t["trial"] for t in got["trials"]]


def test_two_trial_hpo_runs_and_a_partitioner_raises():
    out = hpo.optimize_hyperparameters(torch.Generator().manual_seed(0), _features(100),
                                       n_trials=2, rung_epochs=(1, 1), seq_len=12,
                                       device="cpu")
    assert len(out["trials"]) == 2 and np.isfinite(out["best_val_loss"])
    assert out["best_params"]["model_type"] in hpo.SEARCH_SPACE["model_type"]
    with pytest.raises(TypeError, match="not a partitioner"):
        hpo.optimize_hyperparameters(torch.Generator(), _features(100), n_trials=1,
                                     partitioner=object(), device="cpu")
    from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, make_mesh

    farmed = hpo.optimize_hyperparameters(
        torch.Generator().manual_seed(0), _features(100), n_trials=2, rung_epochs=(1, 1),
        seq_len=12, partitioner=MeshPartitioner(make_mesh(2, devices=["cpu"] * 2)))
    assert farmed == out


# -- checkpoints -----------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    model = build_model("attention", units=8, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    path = str(tmp_path / "nn.ckpt")
    assert save_checkpoint(path, params, {"symbol": "BTCUSDC", "best_val_loss": 0.5}) == path
    params2 = {k: v + 1.0 for k, v in params.items()}
    save_checkpoint(path, params2, {"round": 2})            # replaced atomically
    got, meta = load_checkpoint(path, device="cpu")
    assert meta == {"round": 2} and list(got) == list(params2)
    assert all(torch.equal(got[k], params2[k]) for k in params2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["nn.ckpt"]
    r = TrainResult(got, "attention", fit_scaler(_features(40), device="cpu"), {"units": 8})
    with torch.no_grad():
        r.model()(torch.zeros(1, 12, F))
