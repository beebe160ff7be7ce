"""Live dashboard HTTP server.

Port of `ai_crypto_trader_tpu/shell/dashboard_server.py`: the same routes,
views and ``/state.json`` blocks over the port's `TradingSystem`; the
profiler capture is `utils.profiling.trace` (``torch.profiler`` with the
CUDA activity on a CUDA host) and its artifact a Chrome trace.

Parity with the reference's continuously-refreshing Dash UI on :8050
(`dashboard.py:442-2266`, redis_listener :89-133, ~25 polling callbacks,
5 s refresh): a stdlib ThreadingHTTPServer that re-renders the dashboard
from live bus state on EVERY request — the polling pull model the Dash
callbacks implement, without taking on the Dash dependency. Endpoints:

  /            HTML dashboard (meta-refresh = the Dash interval component)
  /state.json  machine-readable bus state (the Redis-keys surface the
               reference's callbacks read)
  /metrics     Prometheus text exposition (reference: aiohttp /metrics,
               `services/utils/metrics.py:189-221`)
  /health      heartbeat/liveness JSON (reference: per-service TCP health
               listeners, e.g. `services/monte_carlo_service.py:825-845`)
  /profile     on-demand device profiler capture: ?seconds=N runs
               `utils.profiling.trace` for N wall seconds WHILE the system
               keeps ticking on its own thread and returns the artifact
               directory and its Chrome trace (single-capture guard: a
               second concurrent request gets 409)

The server runs in a daemon thread; `port=0` binds an ephemeral port
(tests). Reads of live bus dicts from the serving thread are safe under
the GIL (same consistency model as the reference's Redis polling — a
render may see a mid-tick snapshot, never a torn value).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ai_crypto_trader_tpu_torch.shell.dashboard import render_dashboard

# /profile bounds: a zero-length capture produces an empty artifact, an
# unbounded one wedges the handler thread (and the profiler) for hours
MIN_PROFILE_S = 0.05
MAX_PROFILE_S = 60.0


class DashboardServer:
    """Serve a TradingSystem's live state over HTTP."""

    def __init__(self, system, port: int = 8050, refresh_s: float = 5.0,
                 profile_dir: str = "profiles"):
        self.system = system
        self.refresh_s = refresh_s
        self.profile_dir = profile_dir
        self._profile_lock = threading.Lock()   # single-capture guard
        self._profile_seq = 0                   # unique artifact names
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet: no stderr per request
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                path = parts.path
                q = parse_qs(parts.query)
                try:
                    if path == "/":
                        # ?symbol=X&window=N — the reference's symbol
                        # dropdown + historical window selection as query
                        # params (`dashboard.py` dcc.Dropdown / time range)
                        symbol = q.get("symbol", [None])[0]
                        try:
                            window = int(q.get("window", [0])[0])
                            window = window if window > 0 else None
                        except ValueError:
                            window = None
                        self._send(outer.render_html(
                            symbol=symbol, window=window).encode(),
                                   "text/html; charset=utf-8")
                    elif path == "/state.json":
                        self._send(json.dumps(outer.state(),
                                              default=str).encode(),
                                   "application/json")
                    elif path == "/traces":
                        # recent traces from the tracer's ring (empty list
                        # when tracing is disabled): the JSON twin of the
                        # span JSONL export, grouped by trace_id
                        try:
                            # floor at 0: a negative value would invert the
                            # ring slice and return everything BUT the
                            # newest traces
                            limit = max(int(q.get("limit", [20])[0]), 0)
                        except ValueError:
                            limit = 20
                        self._send(json.dumps(outer.traces(limit),
                                              default=str).encode(),
                                   "application/json")
                    elif path == "/decisions":
                        # decision-provenance query (obs/flightrec.py):
                        # ?symbol=X&trace_id=Y&lane=N&limit=M over the
                        # recorder's ring — signal→order→fill→PnL per
                        # decision; `lane` filters a vmapped tenant
                        # lane's sampled provenance (obs/fleetscope.py)
                        try:
                            limit = max(int(q.get("limit", [50])[0]), 0)
                        except ValueError:
                            limit = 50
                        try:
                            lane = (int(q["lane"][0]) if "lane" in q
                                    else None)
                        except ValueError:
                            lane = None
                        self._send(json.dumps(outer.decisions(
                            symbol=q.get("symbol", [None])[0],
                            trace_id=q.get("trace_id", [None])[0],
                            lane=lane,
                            limit=limit), default=str).encode(),
                                   "application/json")
                    elif path == "/profile":
                        try:
                            seconds = float(q.get("seconds", ["1"])[0])
                        except ValueError:
                            seconds = 1.0
                        if not math.isfinite(seconds):
                            seconds = 1.0   # nan/inf survive min/max clamps
                        seconds = min(max(seconds, MIN_PROFILE_S),
                                      MAX_PROFILE_S)
                        out = outer.profile(seconds)
                        if out is None:
                            self._send(json.dumps(
                                {"error": "capture already in progress"}
                            ).encode(), "application/json", 409)
                        else:
                            self._send(json.dumps(out).encode(),
                                       "application/json")
                    elif path == "/metrics":
                        self._send(outer.system.metrics.exposition().encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/health":
                        self._send(json.dumps(outer.health()).encode(),
                                   "application/json")
                    else:
                        self._send(b"not found", "text/plain", 404)
                except Exception as exc:               # noqa: BLE001
                    self._send(f"render error: {exc}".encode(),
                               "text/plain", 500)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # --- view assembly ------------------------------------------------------
    def render_html(self, symbol: str | None = None,
                    window: int | None = None) -> str:
        # Handler threads read ONLY launcher/bus state (GIL-safe snapshot
        # reads) — never the exchange: that would burn trading rate-limit
        # tokens and perturb virtual clocks from a foreign thread.
        system = self.system
        sym = (symbol if symbol in system.symbols else
               (system.symbols[0] if system.symbols else None))
        klines = (system.bus.get(f"historical_data_{sym}_1m") or []) if sym else []
        if window:
            klines = klines[-window:]
        signals = [system.bus.get(f"latest_signal_{s}")
                   for s in system.symbols]
        status = system.status_cached()
        # allocation: the same marking rule as the launcher's portfolio
        # gauge (shared helper — dedup by base, no hardcoded quote)
        from ai_crypto_trader_tpu_torch.utils.symbols import mark_holdings

        allocation = mark_holdings(
            dict(status["balances"]), system.symbols,
            lambda s: system.bus.get(f"market_data_{s}"))
        # trade markers: closed + open trades from the executor's books
        # (atomic list() snapshots — the asyncio loop mutates these dicts
        # while handler threads render)
        trades = [t for t in list(system.executor.closed_trades)
                  if t.get("symbol") == sym]
        for s, t in list(system.executor.active_trades.items()):
            if s == sym:
                trades.append({"symbol": s, "entry_price": t.entry_price,
                               "opened_at": t.opened_at})
        registry = getattr(system, "registry", None)
        versions = (list(registry.entries.values())
                    if registry is not None else None)
        traces = self.traces(limit=8)
        return render_dashboard(
            decisions=self.decisions(symbol=sym, limit=8) or None,
            traces=traces or None,
            bus=system.bus,
            klines=klines,
            trades=trades,
            symbol=sym,
            symbol_links=(system.symbols
                          if len(system.symbols) > 1 else None),
            allocation=allocation,
            model_versions=versions,
            metrics={"portfolio_value_usd": status.get(
                         "portfolio_value_usd",
                         status["balances"].get("USDC", 0.0)),
                     "closed_trades": status["closed_trades"],
                     "total_pnl": status["total_pnl"],
                     "open_positions": len(status["active_trades"])},
            signals=[s for s in signals if s],
            alerts=list(system.alerts.active.values()),
            refresh_s=self.refresh_s,
            now_fn=system.now_fn)

    def traces(self, limit: int = 20) -> list:
        tracer = getattr(self.system, "tracer", None)
        return tracer.traces(limit=limit) if tracer is not None else []

    def decisions(self, symbol: str | None = None,
                  trace_id: str | None = None, limit: int = 50,
                  lane: int | None = None) -> list:
        fr = getattr(self.system, "flightrec", None)
        if fr is None:
            return []
        return fr.query(symbol=symbol, trace_id=trace_id, limit=limit,
                        lane=lane)

    def profile(self, seconds: float) -> dict | None:
        """On-demand capture: `utils.profiling.trace` for ``seconds`` of
        wall clock while the system keeps ticking on its own loop.
        Returns None when a capture is already running (the guard: torch
        supports one active profiler session per process)."""
        if not self._profile_lock.acquire(blocking=False):
            return None
        try:
            from ai_crypto_trader_tpu_torch.utils import profiling

            self._profile_seq += 1
            artifact = os.path.join(
                self.profile_dir,
                time.strftime("trace_%Y%m%d_%H%M%S")
                + f"_{self._profile_seq:03d}")
            os.makedirs(artifact, exist_ok=True)
            t0 = time.perf_counter()
            with profiling.trace(artifact):
                time.sleep(seconds)
            trace = os.path.join(artifact, profiling.TRACE_FILE)
            return {"artifact": artifact, "trace": trace,
                    "seconds": round(time.perf_counter() - t0, 3),
                    "requested_s": seconds,
                    # work the capture saw on the card (0: none ran in it)
                    "cuda_events": len(profiling.cuda_events(trace))}
        finally:
            self._profile_lock.release()

    def state(self) -> dict:
        system = self.system
        bus_state = {k: system.bus.get(k) for k in system.bus.keys("*")
                     if isinstance(system.bus.get(k),
                                   (int, float, str, list, dict))}
        out = {"status": system.status_cached(), "bus": bus_state}
        devprof = getattr(system, "devprof", None)
        if devprof is not None:
            # cost cards / SLO summaries / donation results / watermarks
            out["devprof"] = devprof.status()
        flightrec = getattr(system, "flightrec", None)
        if flightrec is not None:
            out["flightrec"] = flightrec.status()
        # mesh runtime (utils/meshprof.py + parallel/partitioner.py): the
        # active partitioner layout is surfaced even when the observatory
        # is off — operators must be able to see mesh shape / device
        # kinds without a REPL (ISSUE 12 satellite) — and the sentinel /
        # layout-card state rides along when meshprof is enabled.
        mesh_block = {}
        try:
            from ai_crypto_trader_tpu_torch.parallel import get_partitioner

            mesh_block["partitioner"] = get_partitioner().describe()
        except Exception:                      # noqa: BLE001 — backend
            pass                               # unavailable: sentinel-only
        meshprof = getattr(system, "meshprof", None)
        if meshprof is not None:
            mesh_block.update(meshprof.status())
        if mesh_block:
            out["mesh"] = mesh_block
        saturation = getattr(system, "saturation", None)
        if saturation is not None:
            # load & capacity observatory (utils/saturation.py): stage
            # duty cycles, bus utilization/watermarks, scatter occupancy,
            # host-readback share, event-loop lag
            out["capacity"] = saturation.status()
        fleet = getattr(system, "fleetscope", None)
        if fleet is not None:
            # fleet observatory (obs/fleetscope.py): device-aggregated
            # lane telemetry — gate mix, dispersion quantiles, top-k
            # rank table, starvation/drift — O(gates + quantiles + K)
            # JSON regardless of tenant count (`cli fleet --url` reads
            # this block)
            out["fleet"] = fleet.status()
        tickpath = getattr(system, "tickpath", None)
        if tickpath is not None:
            # decision critical-path observatory (obs/tickpath.py): per-tick
            # phase waterfall, overlap headroom, event→decision age, and the
            # per-program cold-start ledger (`cli latency --url` reads these
            # two blocks)
            out["tickpath"] = tickpath.status()
            out["coldstart"] = tickpath.coldstart_status()
        aot = getattr(system, "aot_cache", None)
        if aot is not None:
            # persistent kernel-build cache (utils/aotcache.py): whether
            # this restart found its libraries built (warm), where the
            # provenance-keyed directory points, and why the cache is
            # off when it's off
            out["aot_cache"] = aot.status()
        build = getattr(system, "build_info", None)
        if build is not None:
            # process provenance: start time, torch and CUDA versions,
            # backend, device kind — pins *what* produced every number
            # above (`cli status`)
            out["build"] = dict(build)
        scorecard = getattr(system, "scorecard", None)
        if scorecard is not None:
            sc = scorecard.status()
            out["scorecard"] = {k: v for k, v in sc.items() if k != "groups"} \
                | {"groups": {k: dict(v) for k, v in sc["groups"].items()}}
        # continuous PBT training service (rl/trainer_service.py): where
        # the fleet is, who is quarantined, checkpoint/recalibration age
        # (`cli status --url` renders this block)
        for svc in getattr(system, "extra_services", []) or []:
            if getattr(svc, "name", "") == "trainer" \
                    and hasattr(svc, "status"):
                out["training"] = svc.status()
                break
        return out

    def health(self) -> dict:
        return {"healthy": all(self.system.heartbeats.health().values())
                if self.system.heartbeats.health() else True,
                "services": self.system.heartbeats.health()}

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> "DashboardServer":
        # /profile captures run on handler threads: the profiler's CUDA
        # tracing must be initialised on this (the importing) thread first
        from ai_crypto_trader_tpu_torch.utils import profiling

        profiling.prepare()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dashboard", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            # shutdown() handshakes with serve_forever's loop — calling it
            # on a server that was never start()ed blocks forever on the
            # __is_shut_down event nothing will ever set
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
