"""The port's operator commands against the JAX package's, on the CPU.

``status``, ``latency``, ``mesh`` and ``fleet`` with ``--url`` read a live
server's ``/state.json``: both packages' commands read ONE state (a port
system's blocks after a few ticks with its observatories on, a vmapped
fleet's block, and a JAX-shaped ``build`` block) from one local server and
must print the same text.  The port's ``latency`` names the torch runtime
of a port-shaped ``build`` block.  ``mc`` on JAX's own draws (injected)
prints JAX's table within rtol 1e-5; ``registry`` and ``dashboard`` print
what JAX's print, and the dashboards' HTML is the same bytes; ``mesh`` and
``status`` without ``--url`` describe the host as JAX's single-device seam
does.  ``profile`` writes a loadable Chrome trace beside its devprof
status.  JAX's commands run through their parsed function, never its
``main`` (which switches XLA's persistent compile cache on in this
process).
"""

import asyncio
import contextlib
import io
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from ai_crypto_trader_tpu import cli as jcli  # noqa: E402
from ai_crypto_trader_tpu.parallel import partitioner as jpartitioner  # noqa: E402
from ai_crypto_trader_tpu_torch import cli as tcli  # noqa: E402
from ai_crypto_trader_tpu_torch import mc as tmc  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import devprof as tdevprof  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import meshprof as tmeshprof  # noqa: E402

RTOL = 1e-5


def run(pkg, argv):
    """stdout of one subcommand, run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if pkg == "port":
            tcli.main(argv)
        else:
            args = jcli.build_parser().parse_args(argv)
            args.fn(args)
    return buf.getvalue()


class _StateServer:
    """Serves one fixed /state.json on an ephemeral port."""

    def __init__(self, state):
        body = json.dumps(state, default=str).encode()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200 if self.path == "/state.json" else 404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _port_state():
    """A port system's /state.json after 3 ticks with devprof, meshprof and
    tickpath on, and a vmapped fleet's block."""
    from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell import FakeExchange
    from ai_crypto_trader_tpu_torch.shell.dashboard_server import DashboardServer
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
    from ai_crypto_trader_tpu_torch.testing.loadgen import LoadConfig, run_load

    d = {k: v for k, v in generate_ohlcv(n=900, seed=6).items() if k != "regime"}
    ex = FakeExchange({"BTCUSDC": from_dict(d, symbol="BTCUSDC")})
    ex.advance(steps=860)
    clock = [60_000.0]
    system = TradingSystem(ex, ["BTCUSDC"], device="cpu", now_fn=lambda: clock[0],
                           enable_devprof=True, enable_meshprof=True, tick_budget_s=1e9)
    system.monitor.kline_limit = 64
    try:
        async def go():
            for _ in range(3):
                ex.advance()
                clock[0] += 60.0
                await system.tick()

        asyncio.run(go())
        server = DashboardServer(system, port=0)
        state = json.loads(json.dumps(server.state(), default=str))
        server.stop()
    finally:
        system.shutdown()
    rep = run_load(LoadConfig(tenants=4, symbols=2, ticks=2, mode="vmapped", min_samples=2,
                              device="cpu"))
    state["fleet"] = json.loads(json.dumps(rep["fleet"], default=str))
    return state


@pytest.fixture(scope="module")
def served_state():
    state = _port_state()
    jax_build = {"process_start": state["build"]["process_start"], "jax_version": "x",
                 "backend": "cpu", "device_kind": "cpu"}
    servers = {"jax_build": _StateServer({**state, "build": jax_build}),
               "port_build": _StateServer(state)}
    yield state, servers
    for s in servers.values():
        s.stop()


@pytest.mark.parametrize("command", ["status", "latency", "mesh", "fleet"])
def test_url_commands_print_what_jax_prints(served_state, command):
    _, servers = served_state
    url = servers["jax_build"].url
    got = run("port", [command, "--url", url])
    assert got == run("jax", [command, "--url", url])
    assert got.strip()


def test_url_commands_read_the_blocks(served_state):
    state, servers = served_state
    url = servers["port_build"].url
    status = json.loads(run("port", ["status", "--url", url]))
    assert status["live"] is True and status["build"]["torch_version"] == torch.__version__
    assert status["mesh"]["recompiles"]["windows"]["tick_engine"] == 3
    assert status["slo_burn_rates"] == state["devprof"]["burn_rates"]
    latency = run("port", ["latency", "--url", url])
    assert f"build: torch {torch.__version__} (CUDA {torch.version.cuda}) on cpu" in latency
    assert "tick_engine" in latency
    assert json.loads(run("port", ["mesh", "--url", url])) == state["mesh"]
    assert f"fleet: {state['fleet']['tenants']} tenants" in run("port", ["fleet", "--url", url])


def test_local_mesh_and_status_describe_the_host_as_jax(monkeypatch):
    """Without --url: the single-device seam on this host, as JAX's
    describes it (the test process's JAX has virtual CPU devices, so its
    default partitioner is pinned to its single-device seam here)."""
    monkeypatch.setattr(jpartitioner, "_default_partitioner",
                        lambda n: jpartitioner.SingleDevicePartitioner())
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])
    for argv in (["mesh", "--pop", "10"], ["mesh", "--pop", "256"], ["status"]):
        assert run("port", argv) == run("jax", argv), argv


def _numbers_close(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _numbers_close(got[k], v)
        else:
            assert math.isclose(got[k], v, rel_tol=RTOL, abs_tol=1e-6), (k, got[k], v)


def test_mc_prints_jax_table_on_jax_draws(monkeypatch):
    """`mc` draws its paths from a torch.Generator; given JAX's draws (the
    same normal draws JAX's `run_simulation` makes from its key) the port
    prints JAX's table within rtol 1e-5."""
    paths, days, seed = 256, 5, 3
    real = tmc.run_simulation
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (paths, days - 1)))

    def on_jax_draws(generator, *a, **kw):
        return real(None, *a, z=z, **kw)

    monkeypatch.setattr(tmc, "run_simulation", on_jax_draws)
    argv = ["mc", "--paths", str(paths), "--days", str(days), "--seed", str(seed)]
    got = json.loads(run("port", [*argv, "--device", "cpu"]))
    ref = json.loads(run("jax", argv))
    _numbers_close(got, ref)


def test_registry_and_dashboard_print_what_jax_prints(tmp_path, monkeypatch):
    from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

    path = str(tmp_path / "registry.json")
    reg = ModelRegistry(path=path)
    v = reg.register("strategy_params", {"stop_loss": 2.0}, metadata={"source": "test"})
    reg.update_performance(v, {"sharpe_ratio": 1.25})
    for argv in (["registry", "--path", path], ["registry", "--path", path, "--best"],
                 ["registry", "--path", str(tmp_path / "none.json")]):
        assert run("port", argv) == run("jax", argv), argv
    monkeypatch.chdir(tmp_path)
    outs = {pkg: run(pkg, ["dashboard", "--days", "1", "--out", f"{pkg}.html"])
            for pkg in ("jax", "port")}
    assert outs["port"].replace("port.html", "X") == outs["jax"].replace("jax.html", "X")
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


def test_profile_writes_a_trace_and_the_devprof_status(tmp_path):
    out = json.loads(run("port", ["profile", "--device", "cpu", "--ticks", "2", "--out",
                                  str(tmp_path / "p")]))
    assert out["artifact"] == str(tmp_path / "p") and out["ticks"] == 2
    with open(out["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    assert "tick_engine" in out["devprof"]["cost_cards"]
    assert out["devprof"]["slos"]["tick"]["count"] == 2
    assert tdevprof.active() is None and tmeshprof.active() is None
    assert os.path.isdir(out["artifact"])
