"""The port's live dashboard server (`shell.dashboard_server`) against the
JAX package's, on the CPU.

Both servers run over a trading system of their package (2 symbols, the
1m/5m frames' 64-candle window) with the device-runtime and mesh
observatories on, after the same ticks on twin paper exchanges: every
route answers 200 with content, ``/state.json`` carries the same blocks
with the same keys and the same ``status``, and the port's block of the
kernel-build cache (``aot_cache``) and its ``build`` provenance name the
torch runtime.  ``/profile`` writes a Chrome trace under the one-session
guard: a second capture while one runs gets 409.  Servers bind port 0
(tests run in parallel).
"""

import asyncio
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.data import ingest as jingest  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.shell import dashboard_server as jserver  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import launcher as jlauncher  # noqa: E402
from ai_crypto_trader_tpu.shell import llm as jllm  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof as jdevprof  # noqa: E402
from ai_crypto_trader_tpu.utils import health as jhealth  # noqa: E402
from ai_crypto_trader_tpu.utils import meshprof as jmeshprof  # noqa: E402
from ai_crypto_trader_tpu_torch.data import ingest as tingest  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import dashboard_server as tserver  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import launcher as tlauncher  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import llm as tllm  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import devprof as tdevprof  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import health as thealth  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import meshprof as tmeshprof  # noqa: E402

SYMBOLS, TICKS = ["AAAUSDC", "BBBUSDC"], 3
PKGS = {"jax": dict(ingest=jingest, ex=jex, launcher=jlauncher, llm=jllm, health=jhealth,
                    server=jserver, kw={}),
        "port": dict(ingest=tingest, ex=tex, launcher=tlauncher, llm=tllm, health=thealth,
                     server=tserver, kw={"device": "cpu"})}
ROUTES = ["/", "/?symbol=BBBUSDC&window=16", "/state.json", "/traces?limit=5",
          "/decisions?limit=5", "/metrics", "/health"]


def _system(pkg, tmp, **kw):
    p = PKGS[pkg]
    clock = [1_000.0]
    series = {}
    for k, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=1_400, seed=11 + k)
        series[s] = p["ingest"].OHLCV(
            timestamp=np.arange(1_400, dtype=np.int64) * 60_000, open=d["open"],
            high=d["high"], low=d["low"], close=d["close"], volume=d["volume"], symbol=s)
    ex = p["ex"].make_exchange("fake", series=series)
    ex.advance(steps=1_380)
    system = p["launcher"].TradingSystem(ex, list(SYMBOLS), now_fn=lambda: clock[0],
                                         tick_budget_s=1e9, enable_devprof=True,
                                         enable_meshprof=True, enable_tracing=True,
                                         **p["kw"], **kw)
    system.monitor.kline_limit = 64
    system.loop_lag = p["health"].EventLoopLagProbe(clock=lambda: 0.0)
    system.analyzer.trader = p["llm"].LLMTrader(model_version="v")
    ids = iter(range(1, 10_000))
    system.flightrec._id_fn = lambda: f"d{next(ids):05d}"

    async def go():
        for _ in range(TICKS):
            ex.advance()
            clock[0] += 60.0
            await system.tick()

    asyncio.run(go())
    return system


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as resp:
        return resp.status, resp.read()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' systems behind their servers, after the same ticks."""
    tmp = tmp_path_factory.mktemp("served")
    out = {}
    try:
        with jdevprof.use(None), jmeshprof.use(None), jtickpath.use(None):
            for pkg in ("jax", "port"):
                kw = {"aot_cache_dir": str(tmp / "cache")} if pkg == "port" else {}
                system = _system(pkg, tmp, **kw)
                server = PKGS[pkg]["server"].DashboardServer(
                    system, port=0, profile_dir=str(tmp / f"{pkg}-profiles")).start()
                out[pkg] = {"system": system, "server": server,
                            "routes": {r: _get(server.port, r) for r in ROUTES}}
                # the port's state is read while its observatories are live
                if pkg == "jax":
                    for mod in (jdevprof, jmeshprof, jtickpath):
                        mod.disable()
            yield out
    finally:
        for v in out.values():
            v["server"].stop()
            v["system"].shutdown()
        assert tdevprof.active() is None and tmeshprof.active() is None


@pytest.mark.parametrize("route", ROUTES)
def test_every_route_answers_with_content(served, route):
    for pkg in ("jax", "port"):
        code, body = served[pkg]["routes"][route]
        assert code == 200 and body, (pkg, route)


def test_state_json_has_the_jax_blocks_and_status(served):
    got = json.loads(served["port"]["routes"]["/state.json"][1])
    ref = json.loads(served["jax"]["routes"]["/state.json"][1])
    assert set(got) - {"aot_cache"} == set(ref)
    assert got["status"] == ref["status"]
    for block in ("devprof", "mesh", "capacity", "tickpath", "coldstart", "flightrec",
                  "scorecard"):
        assert set(got[block]) == set(ref[block]), block
    assert set(got["devprof"]["cost_cards"]) == set(ref["devprof"]["cost_cards"])
    assert got["mesh"]["partitioner"]["kind"] == "SingleDevicePartitioner"
    assert got["mesh"]["recompiles"]["windows"] == ref["mesh"]["recompiles"]["windows"]
    assert got["devprof"]["slos"]["tick"]["count"] == ref["devprof"]["slos"]["tick"]["count"]


def test_state_json_names_the_torch_runtime_and_the_cache(served):
    got = json.loads(served["port"]["routes"]["/state.json"][1])
    assert got["build"]["torch_version"] == torch.__version__
    assert got["build"]["cuda_version"] == torch.version.cuda
    assert got["build"]["device_kind"] == "cpu" and got["build"]["backend"] == "cpu"
    cache = got["aot_cache"]
    assert cache["enabled"] and cache["lock"] == "held" and cache["error"] is None
    assert cache["built"] == [] and cache["cache_hits"] == 0     # a CPU system builds none


def test_health_and_metrics_match_jax(served):
    got = json.loads(served["port"]["routes"]["/health"][1])
    ref = json.loads(served["jax"]["routes"]["/health"][1])
    assert got == ref
    names = {line.split("{")[0].split(" ")[0]
             for line in served["port"]["routes"]["/metrics"][1].decode().splitlines()
             if line and not line.startswith("#")}
    assert {"crypto_trader_tpu_latency_p50_seconds", "crypto_trader_tpu_mesh_devices",
            "crypto_trader_tpu_program_output_bytes"} <= names


def test_profile_writes_a_trace_under_the_one_session_guard(served):
    server = served["port"]["server"]
    code, body = _get(server.port, "/profile?seconds=0.05")
    out = json.loads(body)
    assert code == 200 and out["trace"].endswith("trace.json")
    with open(out["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert os.path.dirname(out["trace"]) == out["artifact"]
    # a capture while one runs is refused
    assert server._profile_lock.acquire(blocking=False)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(server.port, "/profile?seconds=0.05")
        assert exc.value.code == 409
    finally:
        server._profile_lock.release()
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server.port, "/nowhere")
    assert exc.value.code == 404


def test_profile_from_a_handler_thread_while_ticking(served, tmp_path):
    """A capture started on a handler thread while the loop ticks on
    another: the trace holds the ticks' host spans."""
    system = served["port"]["system"]
    server = tserver.DashboardServer(system, port=0, profile_dir=str(tmp_path)).start()
    result = {}
    try:
        th = threading.Thread(target=lambda: result.update(
            json.loads(_get(server.port, "/profile?seconds=1.0")[1])))
        th.start()
        ex = system.exchange

        async def go():
            # tick until the capture is over, so some ticks fall inside it
            for _ in range(15):
                ex.advance()
                await system.tick()
                if not th.is_alive():
                    break

        asyncio.run(go())
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        server.stop()
    with open(result["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
