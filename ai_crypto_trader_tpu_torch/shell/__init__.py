"""The host shell of the port: the event bus, the exchange adapters, the
LLM adapter, and the monitor → analyzer → executor services of the live
signal path (with the market scanner in `shell.scanner`), the dashboard
(`shell.dashboard`), the trading system that wires them into one
process (`shell.launcher.TradingSystem`), its service roster
(`shell.stack`) and the streamed market path (`shell.stream`)."""

from ai_crypto_trader_tpu_torch.shell.bus import EventBus  # noqa: F401
from ai_crypto_trader_tpu_torch.shell.exchange import (  # noqa: F401
    ExchangeInterface,
    ExchangeUnavailable,
    FakeExchange,
    ResilientExchange,
    make_exchange,
)
from ai_crypto_trader_tpu_torch.shell.llm import (  # noqa: F401
    LLMTrader,
    OpenAIBackend,
    TechnicalPolicyBackend,
    UrllibPostTransport,
)
from ai_crypto_trader_tpu_torch.shell.monitor import MarketMonitor  # noqa: F401
from ai_crypto_trader_tpu_torch.shell.analyzer import SignalAnalyzer  # noqa: F401
from ai_crypto_trader_tpu_torch.shell.executor import TradeExecutor  # noqa: F401
