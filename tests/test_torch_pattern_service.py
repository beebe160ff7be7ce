"""The port's chart-pattern service against the JAX package's, on the CPU.

A classifier trained by the JAX package (a few epochs on its synthetic
generators) is carried over by `convert.recognizer_from_flax`; both
services then run the same rounds over the same klines on one JAX
`EventBus` each: the analyses (verdict, primary pattern, completion and
implications equal, confidence within 1e-5 — the classifiers' parity
tolerance), the published signals and the combined report must agree.
The classifier's output layer is adjusted the same way in both trees (see
the fixture), so that patterns lead and the publishing branch runs.
`pattern_trading_signals` is held on a grid of analyses."""

import asyncio
import itertools

import jax
import numpy as np
import pytest

from ai_crypto_trader_tpu.patterns import model as jpm
from ai_crypto_trader_tpu.patterns import service as jsvc
from ai_crypto_trader_tpu.patterns.synthetic import PATTERN_CLASSES
from ai_crypto_trader_tpu.shell.bus import EventBus
from ai_crypto_trader_tpu_torch import convert
from ai_crypto_trader_tpu_torch.patterns import service as psvc

ATOL = 1e-5
SYMBOLS = ("AAAUSDC", "BBBUSDC", "CCCUSDC", "DDDUSDC", "EEEUSDC", "FFFUSDC", "GGGUSDC",
           "HHHUSDC")


def _klines(n, seed):
    rng = np.random.default_rng(seed)
    close = 100 * np.cumprod(1 + rng.normal(0, 0.006, n))
    return [[i, close[i] * 0.999, close[i] * 1.003, close[i] * 0.996, close[i],
             float(rng.uniform(100.0, 2000.0))] for i in range(n)]


@pytest.fixture(scope="module")
def recognizers():
    rec = jpm.train_pattern_model(jax.random.PRNGKey(0), "cnn", n_per_class=8, epochs=2)
    params = jax.tree.map(np.array, rec.params)
    # a barely trained classifier scores random klines near uniformly: its
    # output layer is sharpened ×40, the no-pattern logit lowered by 10 and
    # the two head-and-shoulders logits raised by 5, so that patterns lead
    # and some signal is strong enough to publish
    heads = [leaf for leaf in jax.tree.leaves(params) if leaf.shape[-1] == len(PATTERN_CLASSES)]
    assert [h.ndim for h in heads] == [1, 2]
    for h in heads:
        h *= 40.0
    bias = heads[0]
    bias[PATTERN_CLASSES.index("no_pattern")] -= 10.0
    for name in ("head_and_shoulders", "inverse_head_and_shoulders"):
        bias[PATTERN_CLASSES.index(name)] += 5.0
    jrec = jpm.PatternRecognizer("cnn", params=params)
    prec = convert.recognizer_from_flax("cnn", params, device="cpu")
    return jrec, prec


def _services(recognizers, **kw):
    jrec, prec = recognizers
    out = {}
    for name, mod, rec in (("jax", jsvc, jrec), ("port", psvc, prec)):
        bus = EventBus()
        for i, s in enumerate(SYMBOLS):
            bus.set(f"historical_data_{s}_5m", _klines(120 + 8 * i, seed=i))
        bus.set("historical_data_ZZZUSDC_1m", _klines(90, seed=42))
        clock = {"t": 1_000_000.0}
        extra = {"device": "cpu"} if name == "port" else {}
        out[name] = (mod.ChartPatternService(bus, rec, list(SYMBOLS) + ["ZZZUSDC", "NONE"],
                                             now_fn=lambda c=clock: c["t"], **kw, **extra),
                     bus, clock)
    return out


def _same_analysis(a, b):
    assert a.keys() == b.keys()
    assert a["detected"] == b["detected"]
    for k in ("primary_pattern", "completion", "implications"):
        assert a.get(k) == b.get(k), k
    if "confidence" in a:
        assert abs(a["confidence"] - b["confidence"]) <= ATOL
    for k, p in a["all_probabilities"].items():
        assert abs(p - b["all_probabilities"][k]) <= ATOL, k


@pytest.mark.parametrize("threshold", [0.2, 0.5])
def test_rounds_publish_the_jax_signals(recognizers, threshold):
    svcs = _services(recognizers, confidence_threshold=threshold)
    outs = {k: asyncio.run(s.run_once()) for k, (s, _, _) in svcs.items()}
    assert outs["port"] == outs["jax"]
    (ps, pbus, pclock), (js, jbus, jclock) = svcs["port"], svcs["jax"]
    assert ps.pattern_data.keys() == js.pattern_data.keys() == set(SYMBOLS) | {"ZZZUSDC"}
    for s in ps.pattern_data:
        _same_analysis(pbus.get(f"pattern_analysis_{s}"), jbus.get(f"pattern_analysis_{s}"))
        a, b = pbus.get(f"pattern_signals_{s}"), jbus.get(f"pattern_signals_{s}")
        assert (a is None) == (b is None), s
        if a is not None:
            assert {k: v for k, v in a.items() if k != "strength"} == \
                {k: v for k, v in b.items() if k != "strength"}
            # rounded to 2 decimals: a confidence within ATOL may round
            # across an edge, and by no more than one step
            assert abs(a["strength"] - b["strength"]) <= 0.01
    assert pbus.published_counts.get("pattern_signals") == \
        jbus.published_counts.get("pattern_signals")
    rp, rj = pbus.get("pattern_analysis_report"), jbus.get("pattern_analysis_report")
    assert rp["summary"].keys() == rj["summary"].keys()
    for k in ("bullish_patterns", "bearish_patterns", "neutral_patterns"):
        assert rp["summary"][k] == rj["summary"][k]
    assert rp["summary"]["strongest_signal"]["symbol"] == \
        rj["summary"]["strongest_signal"]["symbol"]
    # the interval gate: nothing runs again before update_interval_s
    pclock["t"] += 299.0
    jclock["t"] += 299.0
    assert asyncio.run(ps.run_once()) == asyncio.run(js.run_once()) == \
        {"published": 0, "reported": False}
    if threshold == 0.2:
        assert outs["port"]["published"] > 0


def test_untrained_recognizer_marks_its_artifacts(recognizers):
    _, prec = recognizers
    bus = EventBus()
    bus.set("historical_data_AAAUSDC_5m", _klines(120, seed=0))
    rec = type(prec)(prec.model_type, prec.params, trained=False)
    svc = psvc.ChartPatternService(bus, rec, ["AAAUSDC"], confidence_threshold=0.2,
                                   device="cpu")
    asyncio.run(svc.run_once())
    assert bus.get("pattern_analysis_AAAUSDC")["model_status"] == "untrained"


def test_pattern_trading_signals_on_a_grid():
    for conf, comp, bias, pattern in itertools.product(
            (0.3, 0.5, 0.55, 0.8, 1.0), (0.4, 0.5, 0.74, 0.75, 0.9, 0.95, 60.0, 95.0),
            ("bullish", "bearish", "neutral"), ("double_bottom", "head_shoulders")):
        a = {"detected": True, "primary_pattern": pattern, "confidence": conf,
             "completion": comp, "implications": {"bias": bias, "confirmation": "c",
                                                  "invalidation": "i"}}
        for thr in (0.5, 0.2):
            assert psvc.pattern_trading_signals(a, thr) == jsvc.pattern_trading_signals(a, thr)
    for a in ({}, {"detected": False}, None):
        assert psvc.pattern_trading_signals(a) == jsvc.pattern_trading_signals(a)
