"""The port's LLM adapter (shell/llm.py) and `data.fetchers.Response`
against the JAX package's,
on the CPU.  Host code throughout, so everything is held exactly: the same
prompts go to the backend, the same parsed outputs come back (the model
version, a random UUID, aside), and `OpenAIBackend` sends the same request
over a fake transport.  Nothing touches the network.
"""

import asyncio
import dataclasses
import json

import pytest

from ai_crypto_trader_tpu import config as jconfig
from ai_crypto_trader_tpu.data.fetchers import Response as JaxResponse
from ai_crypto_trader_tpu.shell import llm as J
from ai_crypto_trader_tpu_torch import config as pconfig
from ai_crypto_trader_tpu_torch.data.fetchers import Response
from ai_crypto_trader_tpu_torch.shell import llm as P

_MARKET = {"symbol": "BTCUSDC", "current_price": 42_000.5, "avg_volume": 1.5e6,
           "rsi": 28.4, "stoch_k": 12.0, "macd": -3.2, "williams_r": -88.0,
           "bb_position": 0.1, "trend": "down", "trend_strength": 0.42,
           "price_change_1m": -0.1, "price_change_5m": 0.4, "signal": "BUY",
           "signal_strength": 83.0}
_RISK = {"symbol": "ETHUSDC", "available_capital": 2_500.0, "volatility": 0.031,
         "current_price": 2_100.0, "trend_strength": 0.2}
_SYMBOLS = [{"symbol": f"S{i}", "current_price": 10.0 + i, "rsi": 40.0 + i,
             "trend": "up", "price_change_5m": (-1.0) ** i * i * 0.3} for i in range(6)]


class _Recording:
    """A backend that records prompts and answers with the deterministic
    policy (sync) or raises."""

    def __init__(self, mod, fail=False):
        self.inner, self.fail, self.prompts = mod.TechnicalPolicyBackend(), fail, []

    def complete(self, prompt):
        self.prompts.append(prompt)
        if self.fail:
            raise RuntimeError("backend down")
        return self.inner.complete(prompt)


def _strip(out):
    return {k: v for k, v in out.items() if k != "model_version"}


@pytest.mark.parametrize("explainable", [True, False])
@pytest.mark.parametrize("fail", [False, True])
def test_llm_trader_prompts_and_outputs_equal(explainable, fail):
    outs = {}
    for key, mod, cfg in (("jax", J, jconfig), ("port", P, pconfig)):
        backend = _Recording(mod, fail)
        trader = mod.LLMTrader(backend=backend,
                               params=cfg.LLMParams(explainable=explainable))
        got = [asyncio.run(trader.analyze_trade_opportunity(dict(_MARKET))),
               asyncio.run(trader.analyze_trade_opportunity({"symbol": "X"})),
               asyncio.run(trader.analyze_risk_setup(dict(_RISK))),
               asyncio.run(trader.analyze_market_conditions(list(_SYMBOLS)))]
        outs[key] = ([_strip(o) for o in got], backend.prompts,
                     dict(trader.performance_metrics),
                     trader.should_take_trade(got[0]),
                     trader.adjust_position_size(
                         got[2], {"position_size": 500.0, "stop_loss_pct": 1.0,
                                  "take_profit_pct": 9.0}))
    assert outs["port"] == outs["jax"]
    if not fail:
        assert outs["port"][0][0]["decision"] == "BUY"


def test_bad_template_degrades_to_the_raw_context():
    prompts = {}
    for key, mod, cfg in (("jax", J, jconfig), ("port", P, pconfig)):
        backend = _Recording(mod)
        trader = mod.LLMTrader(backend=backend, params=cfg.LLMParams(
            explainable=False, analysis_prompt="{no_such_field}", risk_prompt="{0}"))
        asyncio.run(trader.analyze_trade_opportunity(dict(_MARKET)))
        asyncio.run(trader.analyze_risk_setup(dict(_RISK)))
        prompts[key] = backend.prompts
    assert prompts["port"] == prompts["jax"]
    assert prompts["port"][0].startswith("Analyze this trading opportunity")


class _Transport:
    def __init__(self, replies, response):
        self.replies, self.requests, self.response = list(replies), [], response

    async def __call__(self, url, payload, headers):
        self.requests.append((url, payload, headers))
        status, body = self.replies.pop(0)
        return self.response(status, json.dumps(body))


def _chat(content):
    return {"choices": [{"message": {"role": "assistant", "content": json.dumps(content)}}]}


@pytest.mark.parametrize("status", [200, 429])
def test_openai_backend_over_a_fake_transport(status):
    seen = {}
    for key, mod, cfg, resp in (("jax", J, jconfig, JaxResponse), ("port", P, pconfig, Response)):
        t = _Transport([(status, _chat({"decision": "SELL", "confidence": 0.8}))], resp)
        backend = mod.OpenAIBackend(params=cfg.LLMParams(base_url="http://localhost:1/v1",
                                                         model="local", temperature=0.1),
                                    transport=t, api_key="sk-test")
        trader = mod.LLMTrader(backend=backend)
        out = asyncio.run(trader.analyze_trade_opportunity(dict(_MARKET)))
        seen[key] = (_strip(out), t.requests)
    assert seen["port"] == seen["jax"]
    url, payload, headers = seen["port"][1][0]
    assert url == "http://localhost:1/v1/chat/completions"
    assert headers == {"Authorization": "Bearer sk-test"}
    assert payload["response_format"] == {"type": "json_object"}
    assert seen["port"][0]["decision"] == ("SELL" if status == 200 else "ERROR")


def test_openai_backend_without_a_key_raises(monkeypatch):
    monkeypatch.delenv("_ABSENT_KEY_ENV_", raising=False)
    backend = P.OpenAIBackend(params=pconfig.LLMParams(api_key_env="_ABSENT_KEY_ENV_"),
                              transport=_Transport([], Response))
    with pytest.raises(RuntimeError, match="_ABSENT_KEY_ENV_"):
        asyncio.run(backend.complete("x"))


def test_response_parses_its_body_once():
    body = json.dumps({"a": 1})
    assert dataclasses.asdict(Response(200, body)) == dataclasses.asdict(JaxResponse(200, body))
    r = Response(200, body)
    assert r.json() == {"a": 1} and r.json() is r.json()
