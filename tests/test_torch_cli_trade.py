"""`python -m ai_crypto_trader_tpu_torch.cli trade --paper` and `why`
against the JAX package's `cmd_trade` and `cmd_why`, on the CPU.

The same arguments give the same printed status, the same journal bytes
and the same decision chains (the flight recorder's feature floats within
the tick engine's bounds, tests/test_torch_tick.py); a second run on the
same journal recovers the same books.  Both commands build their system
inside, so the two readings of the wall clock that feed alerts (the
event-loop lag probe and the stage duty cycles) are pinned for both
packages: a first JAX tick that compiles would otherwise fire
`EventLoopLagHigh` in one run and not the other.  `uuid.uuid4` (the
model version, decision and span ids) counts from 1 in each run.
"""

import contextlib
import io
import itertools
import json
import uuid

import pytest
import torch
# A devprof card's first dispatch imports these (the flop counter, and
# torch._dynamo behind torch's dispatch modes), and importing them draws
# uuid4 values (torch.distributed's state keys): imported here, they
# cannot shift the counted ids of a run with --devprof.
import torch._dynamo  # noqa: F401
import torch.utils.flop_counter  # noqa: F401

pytest.importorskip("jax")

from ai_crypto_trader_tpu import cli as jcli  # noqa: E402
from ai_crypto_trader_tpu.obs import flightrec as jfr  # noqa: E402
from ai_crypto_trader_tpu.shell import launcher as jlauncher  # noqa: E402
from ai_crypto_trader_tpu.utils import health as jhealth  # noqa: E402
from ai_crypto_trader_tpu.utils import saturation as jsat  # noqa: E402
from ai_crypto_trader_tpu_torch import cli as tcli  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import flightrec as tfr  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import launcher as tlauncher  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import health as thealth  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import saturation as tsat  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402

TICKS = 20


def pin_wall_clock(mp):
    for launcher, health, sat in ((jlauncher, jhealth, jsat), (tlauncher, thealth, tsat)):
        mp.setattr(launcher, "EventLoopLagProbe",
                   lambda h=health: h.EventLoopLagProbe(clock=lambda: 0.0))
        mp.setattr(launcher, "SaturationMonitor",
                   lambda metrics=None, tick_budget_s=1.0, s=sat: s.SaturationMonitor(
                       metrics=metrics, tick_budget_s=1e9))


@pytest.fixture(autouse=True)
def frozen_wall_clock(monkeypatch):
    pin_wall_clock(monkeypatch)


def run(pkg, argv):
    """stdout of one subcommand, run in this process (JAX's through its
    parser and command function: its `main` also turns on XLA's persistent
    compile cache)."""
    buf = io.StringIO()
    counter = itertools.count(1)
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter) << 64))
        if pkg == "port":
            tcli.main(argv)
        else:
            args = jcli.build_parser().parse_args(argv)
            args.fn(args)
    return buf.getvalue()


def status_of(out):
    """The status JSON a trade run prints last (indented, so over many
    lines), and the one-line recovery report before it, if any."""
    start = out.rindex("\n{\n") + 1 if "\n{\n" in out else out.index("{\n")
    recovered = [json.loads(line) for line in out[:start].splitlines()
                 if line.startswith('{"recovered"')]
    return json.loads(out[start:]), recovered


def trade_argv(tmp_path, pkg, *extra):
    return ["trade", "--paper", "--ticks", str(TICKS), "--journal",
            str(tmp_path / f"{pkg}.journal"), "--flightrec", str(tmp_path / f"{pkg}.jsonl"),
            *extra]


def _feature_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for k, rv in r.items():
            if k == "features":
                for f, v in rv.items():
                    if isinstance(v, float):
                        tol = 1e-3 + 2e-6 * abs(rv.get("current_price", 0.0)) + 2e-3
                        assert abs(g[k][f] - v) <= tol + 1e-5 * abs(v), (f, g[k][f], v)
                    else:
                        assert g[k][f] == v
            else:
                assert g[k] == rv, k


@pytest.fixture(scope="module")
def first_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    outs = {}
    for pkg in ("jax", "port"):
        extra = ("--device", "cpu") if pkg == "port" else ()
        with pytest.MonkeyPatch.context() as mp:
            pin_wall_clock(mp)
            outs[pkg] = run(pkg, trade_argv(tmp, pkg, *extra))
    return outs, tmp


def test_trade_paper_status_equals_jax(first_runs):
    outs, _ = first_runs
    got, rec = status_of(outs["port"])
    ref, rec_j = status_of(outs["jax"])
    assert got == ref and rec == rec_j == []
    assert got["channels"]["market_updates"] == TICKS
    assert ttickpath.active() is None and ttracing.active() is None     # shut down


def test_trade_paper_journal_is_byte_equal(first_runs):
    _, tmp = first_runs
    with open(tmp / "port.journal", "rb") as a, open(tmp / "jax.journal", "rb") as b:
        port = a.read()
        assert port == b.read()
    assert b"entry_intent" in port


def test_trade_paper_decisions_equal_jax(first_runs):
    _, tmp = first_runs
    got, gstats = tfr.load_decisions(str(tmp / "port.jsonl"))
    ref, rstats = jfr.load_decisions(str(tmp / "jax.jsonl"))
    assert gstats == rstats
    _feature_close(got, ref)
    assert any(r["status"] in ("executed", "closed") for r in got)


def test_why_prints_jax_lines(first_runs):
    _, tmp = first_runs
    port_file = str(tmp / "port.jsonl")
    got = run("port", ["why", "BTCUSDC", "--file", port_file, "--device", "cpu"])
    ref = run("jax", ["why", "BTCUSDC", "--file", port_file])
    assert got == ref and "EXECUTED" in got
    # the lines are format_why's over the newest ten records
    records, _ = tfr.load_decisions(port_file)
    assert got.splitlines() == tfr.format_why(
        list(reversed([r for r in records if r["symbol"] == "BTCUSDC"][-10:])))
    for argv in (["--last", "3"], ["--lane", "1"]):
        assert run("port", ["why", "BTCUSDC", "--file", port_file, "--device", "cpu", *argv]) \
            == run("jax", ["why", "BTCUSDC", "--file", port_file, *argv])


def test_resumed_trade_recovers_as_jax(first_runs, tmp_path):
    _, tmp = first_runs
    outs = {}
    for pkg in ("jax", "port"):
        for suffix in (".journal", ".jsonl"):
            (tmp_path / f"{pkg}{suffix}").write_bytes((tmp / f"{pkg}{suffix}").read_bytes())
        extra = ("--device", "cpu") if pkg == "port" else ()
        outs[pkg] = status_of(run(pkg, trade_argv(tmp_path, pkg, *extra)))
    assert outs["port"] == outs["jax"]
    status, recovered = outs["port"]
    assert recovered and recovered[0]["recovered"]["replayed_records"] > 0
    with open(tmp_path / "port.journal", "rb") as a, open(tmp_path / "jax.journal", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flag", [["--serve", "0"], ["--devprof"],
                                  ["--meshprof"], ["--aot-cache", "cache"]])
def test_flags_work_and_change_no_trade(flag, first_runs, tmp_path, monkeypatch):
    """`trade --serve/--devprof/--meshprof/--aot-cache` run, do what they
    say, and print the status the same run prints without them, with the
    same journal bytes."""
    outs, tmp = first_runs
    if flag[0] == "--aot-cache":
        flag = ["--aot-cache", str(tmp_path / "cache")]
    seen = []
    real_shutdown = tlauncher.TradingSystem.shutdown

    def shutdown(system):
        seen.append({"devprof": system.devprof and system.devprof.status(),
                     "meshprof": system.meshprof and system.meshprof.status()})
        real_shutdown(system)

    monkeypatch.setattr(tlauncher.TradingSystem, "shutdown", shutdown)
    out = run("port", trade_argv(tmp_path, "port", "--device", "cpu", *flag))
    assert status_of(out) == status_of(outs["port"])
    with open(tmp_path / "port.journal", "rb") as a, open(tmp / "port.journal", "rb") as b:
        assert a.read() == b.read()
    if flag[0] == "--serve":
        assert "dashboard: http://127.0.0.1:" in out
    elif flag[0] == "--devprof":
        assert seen[0]["devprof"]["cost_cards"]["tick_engine"]["donation_ok"] is True
        assert seen[0]["devprof"]["slos"]["tick"]["count"] == TICKS
    elif flag[0] == "--meshprof":
        assert seen[0]["meshprof"]["recompiles"]["windows"]["tick_engine"] == TICKS
    else:
        line = next(ln for ln in out.splitlines() if ln.startswith('{"aot_cache"'))
        cache = json.loads(line)["aot_cache"]
        assert cache["enabled"] and cache["dir"].startswith(str(tmp_path / "cache"))


FULL_STACK_TICKS = 10
ROSTER_LINE = "full stack: social, news, patterns, regime, nn, evolver, generator, grid, dca"


def _seed_pattern_checkpoints(tmp_path):
    """The JAX package's pattern classifier at its random initialisation,
    saved where each CLI looks for it (models/pattern_cnn in its cwd): in
    the JAX package's format for the JAX CLI and, converted, in the port's
    for the port's.  Both CLIs then load the same weights instead of
    training at startup."""
    import jax
    import jax.numpy as jnp

    from ai_crypto_trader_tpu.patterns.model import _build
    from ai_crypto_trader_tpu.utils.checkpoint import save_checkpoint as jsave
    from ai_crypto_trader_tpu_torch.convert import recognizer_from_flax
    from ai_crypto_trader_tpu_torch.utils.checkpoint import save_checkpoint as tsave

    tree = _build("cnn").init(jax.random.PRNGKey(0), jnp.zeros((2, 60, 5), jnp.float32), False)
    meta = {"model_type": "cnn", "seq_len": 60}
    jsave(str(tmp_path / "jax" / "models" / "pattern_cnn"), tree, metadata=meta)
    rec = recognizer_from_flax("cnn", tree, device="cpu")
    tsave(str(tmp_path / "port" / "models" / "pattern_cnn"), rec.params, metadata=meta)


def test_full_stack_trade_equals_jax(tmp_path, monkeypatch):
    """`trade --paper --full-stack` no longer exits 2: in a cwd of its own
    each CLI registers the nine services (the same roster line), runs the
    ticks, versions into --registry and prints the JAX CLI's status."""
    _seed_pattern_checkpoints(tmp_path)
    outs = {}
    for pkg in ("jax", "port"):
        monkeypatch.chdir(tmp_path / pkg)
        extra = ("--device", "cpu") if pkg == "port" else ()
        outs[pkg] = run(pkg, ["trade", "--paper", "--full-stack", "--ticks",
                              str(FULL_STACK_TICKS), "--registry", "reg.json", *extra])
    lines = {pkg: [ln for ln in out.splitlines() if ln.startswith("full stack:")]
             for pkg, out in outs.items()}
    assert lines["port"] == lines["jax"] == [ROSTER_LINE]
    got, rec = status_of(outs["port"])
    ref, rec_j = status_of(outs["jax"])
    assert got == ref and rec == rec_j == []
    assert got["channels"]["market_updates"] == FULL_STACK_TICKS
    for ch in ("social_updates", "news_updates", "regime_updates", "dca_purchases",
               "neural_network_predictions", "strategy_update"):
        assert got["channels"].get(ch, 0) >= 1, ch
    assert (tmp_path / "port" / "reg.json").is_file()
    assert ttickpath.active() is None and ttracing.active() is None     # shut down


def test_trade_without_paper_and_why_without_a_file(tmp_path):
    assert run("port", ["trade", "--device", "cpu"]) == run("jax", ["trade"])
    missing = str(tmp_path / "none.jsonl")
    assert run("port", ["why", "ETHUSDC", "--file", missing, "--device", "cpu"]) == \
        run("jax", ["why", "ETHUSDC", "--file", missing])


def test_trade_writes_the_dashboard_and_spans(tmp_path):
    out = run("port", ["trade", "--paper", "--ticks", "3", "--device", "cpu", "--dashboard",
                       str(tmp_path / "dash.html"), "--trace-jsonl",
                       str(tmp_path / "spans.jsonl")])
    status, _ = status_of(out)
    assert status["channels"]["market_updates"] == 3
    assert "<html" in (tmp_path / "dash.html").read_text().lower()
    assert "tick" in {s.name for s in ttracing.read_jsonl(str(tmp_path / "spans.jsonl"))}
    assert ttracing.active() is None


@pytest.mark.parametrize("argv", [["trade", "--paper", "--ticks", "1"],
                                  ["why", "BTCUSDC"]])
def test_cuda_by_default_raises_without_a_card(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError):
        tcli.main(argv)
