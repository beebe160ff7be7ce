"""LLM trade-analysis adapter — the host-side AI gate.

The port's own copy of `ai_crypto_trader_tpu/shell/llm.py` (pure Python:
no tensor is computed here).  Capability parity with AITrader
(`services/ai_trader.py`): JSON-structured trade analysis (:36-189),
risk/position-sizing analysis (:191-234), market-wide analysis (:236-342),
`should_take_trade` = confidence ≥ 0.7 and decision BUY (:368-387),
`adjust_position_size` averaging AI + technical sizes and taking the
conservative SL/TP (:389-418), model-version UUIDs (:25-27), rolling
model-performance metrics attached to every analysis (:150-165), and the
explanation / factor_weights defaults the explainability service expects
(:120-141).

Prompts are config, not code: `LLMParams` (config.py) carries the model /
temperature / max_tokens and the five prompt templates.  A template whose
placeholder is missing from the context falls back to the raw-JSON context
block (the reference wraps `.format` in try/except, `ai_trader.py:81-85`),
so a bad template can never take down the gate.

Backends are pluggable; `complete` may be sync or async:

  * TechnicalPolicyBackend — deterministic, derived from the signal the
    prompt's context carries; the zero-egress configuration, and the one
    the strategy evolver and the structure search use by default;
  * OpenAIBackend — a chat-completions JSON-mode client over an injectable
    POST transport (stdlib urllib by default; tests inject fakes).

Every prompt this module builds ends with a ``MARKET_DATA:`` JSON tail —
the machine-readable context.  The deterministic backend parses it; for a
real LLM it simply restates the context verbatim after the prose.
"""

from __future__ import annotations

import inspect
import json
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Protocol

from ai_crypto_trader_tpu_torch.config import LLMParams
from ai_crypto_trader_tpu_torch.data.fetchers import Response


class LLMBackend(Protocol):
    def complete(self, prompt: str) -> "str | Awaitable[str]": ...


# (url, json_body, headers) -> Response; the POST analog of the GET
# `Transport` seam in data/fetchers.py — same Response type, same
# injectability for tests.
PostTransport = Callable[[str, dict, dict], Awaitable[Response]]


class UrllibPostTransport:
    """Real-network JSON POST (stdlib only; exercised by users, not tests —
    this environment has no egress)."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s

    async def __call__(self, url: str, payload: dict,
                       headers: dict) -> Response:
        import asyncio
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **headers},
            method="POST")

        def post():
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    return Response(r.status, r.read().decode())
            except urllib.error.HTTPError as e:
                return Response(e.code, e.read().decode(errors="replace"))

        return await asyncio.to_thread(post)


@dataclass
class OpenAIBackend:
    """Chat-completions JSON-mode client (`ai_trader.py:93-104` request
    shape: system+user messages, temperature, max_tokens,
    response_format=json_object).  The API key is read from the env var
    named by `params.api_key_env` unless injected — never stored in
    config."""

    params: LLMParams = field(default_factory=LLMParams)
    transport: PostTransport = field(default_factory=UrllibPostTransport)
    api_key: str | None = None
    system_prompt: str = (
        "You are an experienced cryptocurrency trader focused on technical "
        "analysis, risk management, and providing transparent explanations "
        "of your trading decisions.")

    async def complete(self, prompt: str) -> str:
        key = self.api_key or os.environ.get(self.params.api_key_env, "")
        if not key:
            raise RuntimeError(f"{self.params.api_key_env} not set")
        r = await self.transport(
            f"{self.params.base_url}/chat/completions",
            {"model": self.params.model,
             "messages": [
                 {"role": "system", "content": self.system_prompt},
                 {"role": "user", "content": prompt}],
             "temperature": self.params.temperature,
             "max_tokens": self.params.max_tokens,
             "response_format": {"type": "json_object"}},
            {"Authorization": f"Bearer {key}"})
        if r.status != 200:
            raise RuntimeError(f"LLM HTTP {r.status}: {r.body[:200]}")
        return r.json()["choices"][0]["message"]["content"]


@dataclass
class TechnicalPolicyBackend:
    """Deterministic stand-in scoring the same features the prompts cite.

    Dispatches on the MARKET_DATA context shape: a list → market-wide read,
    `available_capital` → risk sizing, anything else → trade decision."""

    confidence_scale: float = 0.9

    def complete(self, prompt: str) -> str:
        ctx = json.loads(prompt.split("MARKET_DATA:", 1)[1])
        if isinstance(ctx, list):
            return self._market(ctx)
        if "available_capital" in ctx:
            return self._risk(ctx)
        return self._trade(ctx)

    def _trade(self, ctx: dict) -> str:
        rsi = float(ctx.get("rsi", 50.0))
        strength = float(ctx.get("signal_strength", 0.0))
        signal = ctx.get("signal", "NEUTRAL")
        confidence = min(strength / 100.0, 1.0) * self.confidence_scale
        decision = signal if signal in ("BUY", "SELL") else "HOLD"
        reasoning = (f"rule-based: signal={signal} strength={strength:.0f} "
                     f"rsi={rsi:.1f}")
        return json.dumps({
            "decision": decision, "confidence": round(confidence, 3),
            "reasoning": reasoning, "risk_level": "MEDIUM",
            "key_indicators": [k for k in ("rsi", "macd", "bb_position")
                               if k in ctx],
        })

    def _risk(self, ctx: dict) -> str:
        capital = float(ctx.get("available_capital", 0.0))
        vol = float(ctx.get("volatility", 0.01))
        sl = 2.0 if vol > 0.02 else 1.5
        return json.dumps({
            "position_size": capital * (0.25 if vol > 0.02 else 0.35),
            "stop_loss_pct": sl, "take_profit_pct": sl * 2.0,
            "reasoning": "volatility ladder"})

    def _market(self, ctx: list) -> str:
        chg = [(s.get("symbol", "?"), float(s.get("price_change_5m", 0.0)))
               for s in ctx]
        frac = (sum(1 for _, c in chg if c > 0) / len(chg)) if chg else 0.5
        sentiment = ("BULLISH" if frac > 0.6 else
                     "BEARISH" if frac < 0.4 else "NEUTRAL")
        top = [s for s, c in sorted(chg, key=lambda t: -t[1])[:3] if c > 0]
        return json.dumps({
            "market_sentiment": sentiment, "breadth": round(frac, 3),
            "top_opportunities": top, "risks": [],
            "reasoning": f"advancer breadth {frac:.2f}"})


def _analysis_fields(md: dict) -> dict:
    """Placeholder values for the analysis templates, with the reference's
    defaults for optional context (`ai_trader.py:59-80`: social counts 0,
    sentiment 0.5, news/market-context placeholder strings)."""
    return dict(
        symbol=md.get("symbol", "?"),
        price=float(md.get("current_price", md.get("price", 0.0)) or 0.0),
        volume=float(md.get("avg_volume", md.get("volume", 0.0)) or 0.0),
        rsi=float(md.get("rsi", 50.0)),
        stoch=float(md.get("stoch_k", md.get("stoch", 50.0))),
        macd=float(md.get("macd", 0.0)),
        williams_r=float(md.get("williams_r", -50.0)),
        bb_position=float(md.get("bb_position", 0.5)),
        trend=md.get("trend", "NEUTRAL"),
        trend_strength=float(md.get("trend_strength", 0.0)),
        price_change_1m=float(md.get("price_change_1m", 0.0)),
        price_change_3m=float(md.get("price_change_3m", 0.0)),
        price_change_5m=float(md.get("price_change_5m", 0.0)),
        price_change_15m=float(md.get("price_change_15m", 0.0)),
        combined_summary=md.get("combined_summary", "n/a"),
        social_volume=md.get("social_volume", 0),
        social_engagement=md.get("social_engagement", 0),
        social_contributors=md.get("social_contributors", 0),
        social_sentiment=md.get("social_sentiment", 0.5),
        recent_news=md.get("recent_news", "No recent news available"),
        market_context=md.get("market_context", "Market context unavailable"),
    )


@dataclass
class LLMTrader:
    """ai_trader.AITrader equivalent."""

    backend: LLMBackend = field(default_factory=TechnicalPolicyBackend)
    params: LLMParams = field(default_factory=LLMParams)
    confidence_threshold: float = 0.7
    model_version: str = field(default_factory=lambda: str(uuid.uuid4()))
    performance_metrics: dict = field(default_factory=lambda: {
        "total_trades": 0, "successful_trades": 0, "failed_trades": 0,
        "average_confidence": 0.0, "cumulative_confidence": 0.0})

    async def complete(self, prompt: str) -> str:
        """Await-agnostic backend dispatch (sync deterministic backend or
        async network client through one seam)."""
        out = self.backend.complete(prompt)
        if inspect.isawaitable(out):
            out = await out
        return out

    def _format(self, template: str, fields: dict, context: Any,
                fallback_lead: str) -> str:
        """Reference `.format` degradation (`ai_trader.py:81-85`): a
        template referencing an unknown placeholder falls back to the raw
        JSON context block instead of killing the analysis."""
        tail = "\nMARKET_DATA:" + json.dumps(context)
        try:
            return template.format(**fields) + tail
        except (KeyError, IndexError, ValueError):
            return fallback_lead + tail

    async def analyze_trade_opportunity(self, market_data: dict) -> dict:
        """`ai_trader.py:36-189`: per-symbol decision with explainability."""
        p = self.params
        template = (p.explainable_analysis_prompt if p.explainable
                    else p.analysis_prompt)
        prompt = self._format(
            template, _analysis_fields(market_data), market_data,
            "Analyze this trading opportunity and answer in JSON with "
            "decision/confidence/reasoning/key_indicators.")
        try:
            out = self._safe_json(await self.complete(prompt))
        except Exception as e:                      # noqa: BLE001
            # `ai_trader.py:169-189`: analysis errors degrade to an ERROR
            # decision (confidence 0 ⇒ never tradeable), never an exception
            out = {"decision": "ERROR", "confidence": 0.0,
                   "reasoning": f"Error during analysis: {e}"}
        out.setdefault("decision", "HOLD")
        out.setdefault("confidence", 0.0)
        out["model_version"] = self.model_version
        # explainability defaults (`ai_trader.py:120-141`)
        out.setdefault("explanation", {
            "summary": out.get("reasoning", "No explanation provided"),
            "technical_factors": "Technical analysis factors not specified",
            "social_factors": "Social analysis factors not specified",
            "key_indicators": [],
            "risk_assessment": "Risk not explicitly assessed"})
        out.setdefault("factor_weights", {
            "technical_indicators": {}, "price_action": {},
            "social_metrics": {}, "market_context": 0.0})
        # rolling model performance (`ai_trader.py:150-165`)
        m = self.performance_metrics
        m["total_trades"] += 1
        conf = float(out["confidence"])
        m["cumulative_confidence"] += conf
        m["average_confidence"] = m["cumulative_confidence"] / m["total_trades"]
        ok = out["decision"] != "ERROR" and conf > 0
        m["successful_trades" if ok else "failed_trades"] += 1
        out["model_performance"] = {
            "success_rate": m["successful_trades"] / m["total_trades"],
            "avg_confidence": m["average_confidence"],
            "total_trades": m["total_trades"]}
        return out

    async def analyze_risk_setup(self, risk_setup: dict) -> dict:
        """`ai_trader.py:191-234`: position-size / SL / TP proposal."""
        capital = float(risk_setup.get("available_capital", 0.0))
        vol = float(risk_setup.get("volatility", 0.01))
        fields = dict(
            symbol=risk_setup.get("symbol", "?"), capital=capital,
            volatility=vol,
            price=float(risk_setup.get("current_price",
                                       risk_setup.get("price", 0.0)) or 0.0),
            trend_strength=float(risk_setup.get("trend_strength", 0.0)))
        prompt = self._format(
            self.params.risk_prompt, fields, risk_setup,
            "Propose position sizing as JSON with position_size/"
            "stop_loss_pct/take_profit_pct.")
        try:
            out = self._safe_json(await self.complete(prompt))
        except Exception:                           # noqa: BLE001
            out = {}                                # → deterministic ladder
        # deterministic fallback mirrors a volatility ladder
        out.setdefault("position_size", capital * (0.25 if vol > 0.02 else 0.35))
        out.setdefault("stop_loss_pct", 2.0 if vol > 0.02 else 1.5)
        out.setdefault("take_profit_pct", out["stop_loss_pct"] * 2.0)
        return out

    async def analyze_market_conditions(self, symbols_data: list[dict]) -> dict:
        """`ai_trader.py:236-342`: market-wide regime read — per-symbol
        summary block, market prompt, breadth computed host-side as the
        deterministic floor under any backend."""
        ups = sum(1 for s in symbols_data
                  if float(s.get("price_change_5m", 0.0)) > 0)
        frac = ups / max(len(symbols_data), 1)
        summary = "\n".join(
            f"{s.get('symbol', '?')}: price ${float(s.get('current_price', 0.0) or 0.0):.8f}, "
            f"RSI {float(s.get('rsi', 50.0)):.2f}, trend {s.get('trend', 'NEUTRAL')}, "
            f"5m {float(s.get('price_change_5m', 0.0)):.2f}%"
            for s in symbols_data)
        p = self.params
        template = (p.explainable_market_prompt if p.explainable
                    else p.market_prompt)
        prompt = self._format(
            template, {"market_data": summary}, symbols_data,
            "Assess overall market conditions; reply in JSON with "
            "market_sentiment/top_opportunities/risks/reasoning.")
        try:
            out = self._safe_json(await self.complete(prompt))
        except Exception:                           # noqa: BLE001
            out = {}
        out.setdefault("market_sentiment",
                       "BULLISH" if frac > 0.6 else
                       "BEARISH" if frac < 0.4 else "NEUTRAL")
        out["breadth"] = round(frac, 3)
        out["model_version"] = self.model_version
        return out

    def should_take_trade(self, analysis: dict) -> bool:
        """`ai_trader.py:368-387`."""
        return (analysis.get("decision") == "BUY"
                and float(analysis.get("confidence", 0.0)) >= self.confidence_threshold)

    def adjust_position_size(self, risk_analysis: dict,
                             technical_position: dict) -> dict:
        """`ai_trader.py:389-418`: average sizes, conservative SL/TP."""
        size = (float(risk_analysis["position_size"])
                + float(technical_position["position_size"])) / 2.0
        sl = min(float(risk_analysis["stop_loss_pct"]),
                 float(technical_position["stop_loss_pct"]))
        tp = min(float(risk_analysis["take_profit_pct"]),
                 float(technical_position["take_profit_pct"]))
        return {**technical_position, "position_size": size,
                "stop_loss_pct": sl, "take_profit_pct": tp}

    @staticmethod
    def _safe_json(text: str) -> dict:
        try:
            out = json.loads(text)
            return out if isinstance(out, dict) else {}
        except (json.JSONDecodeError, TypeError):
            return {}
