"""The host shell of the port: so far the LLM adapter (`shell.llm`).  The
bus, the exchange adapters, the monitor, analyzer, executor and launcher
are not ported yet (ROADMAP item 16)."""

from ai_crypto_trader_tpu_torch.shell.llm import (  # noqa: F401
    LLMTrader,
    OpenAIBackend,
    TechnicalPolicyBackend,
    UrllibPostTransport,
)
