"""The port's mesh runtime observatory (`utils.meshprof`) against the JAX
package's, on the CPU.

The layout cards' arithmetic, the memory-imbalance fold, the recompile
and transfer counters and the alert inputs are host code: held exactly
on the same injected counts, errors, layouts and samples, and the alert
rules fire the same on them.  The port's sentinels watch the card: a
"compile" is a kernel-library build (`KernelBuildMonitor`), injected here
through the monitor's listener since there is no nvcc; the sync guard
arms torch's sync debug mode, which a CPU build of torch cannot set, so
its gate and mode changes are held on a recording stand-in of
``torch.cuda.set_sync_debug_mode``.  The partitioner seam describes the
host as JAX's does, and a GA run records the same ``ga_scan`` layout card.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.parallel.partitioner import SingleDevicePartitioner as JSingle  # noqa: E402,E501
from ai_crypto_trader_tpu.utils import alerts as jalerts  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof as jdevprof  # noqa: E402
from ai_crypto_trader_tpu.utils import meshprof as jmeshprof  # noqa: E402
from ai_crypto_trader_tpu.utils.metrics import MetricsRegistry as JMetrics  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import get_partitioner  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import alerts as talerts  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import meshprof as tmeshprof  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402
from ai_crypto_trader_tpu_torch.utils.metrics import MetricsRegistry as TMetrics  # noqa: E402

PKGS = {"jax": (jmeshprof, JMetrics, jalerts), "port": (tmeshprof, TMetrics, talerts)}


@pytest.fixture(autouse=True)
def _observatories_off():
    with jmeshprof.use(None), jdevprof.use(None), tmeshprof.use(None):
        yield


# (program, population, pad, devices, output leaves [(shape, dtype name)])
LAYOUTS = [("ga_scan", 256, 0, 1, [((256,), "float32")]),
           ("population_sweep", 10, 6, 8, [((16,), "float32"), ((16, 4), "int32"),
                                           ((3,), "float32")]),
           ("lob_sweep", 1000, 0, 4, [((1000, 8), "float32")]),
           ("pbt_generation", 6, 2, 4, [((8, 2), "float32"), ((), "float32")])]


def _tree(pkg, leaves):
    if pkg == "jax":
        return [jnp.zeros(shape, dtype) for shape, dtype in leaves]
    return [torch.zeros(shape, dtype=getattr(torch, dtype)) for shape, dtype in leaves]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[x[0] for x in LAYOUTS])
def test_layout_card_arithmetic_equals_jax(layout):
    program, pop, pad, devices, leaves = layout
    out = {}
    for pkg, (mod, metrics, _) in PKGS.items():
        mp = mod.MeshProf(metrics=metrics(now_fn=lambda: 0.0))
        card = mp.record_layout(program, population=pop, pad=pad, devices=devices,
                                out_tree=_tree(pkg, leaves))
        out[pkg] = (card.to_dict(), card.padded, card.members_per_device, mp.alert_state(),
                    mp.metrics.exposition())
    assert out["port"] == out["jax"]


def test_memory_imbalance_fold_equals_jax():
    samples = [{"cuda:0": {"bytes": 100}},
               {"cuda:0": {"bytes": 300}, "cuda:1": {"bytes": 100}, "cuda:2": {"bytes": 0}},
               {}, {"cuda:0": {"bytes": 50}, "cuda:1": {"bytes": 50}}]
    for s in samples:
        got = tmeshprof.MeshProf().observe_memory(s)
        ref = jmeshprof.MeshProf().observe_memory(s)
        assert got == ref
    one_card = tmeshprof.MeshProf()
    assert one_card.observe_memory({"cuda:0": {"bytes": 4096}}) == 1.0
    assert one_card.last_device_count == 1


# one sequence of watch windows: (program, builds in the window, cold, aborted)
WINDOWS = [("tick_engine", 2, True, False), ("tick_engine", 0, False, False),
           ("tick_engine", 1, False, False), ("ga_scan", 1, True, False),
           ("ga_scan", 1, False, True), ("ga_scan", 3, False, False),
           ("train_epoch.lstm", 1, False, False), ("train_epoch.lstm", 1, False, False),
           ("not_hot", 0, False, False), ("not_hot", 2, False, False)]


def test_recompile_counting_equals_jax_on_injected_counts():
    out = {}
    for pkg, (mod, metrics, _) in PKGS.items():
        s = mod.RecompileSentinel(metrics=metrics(now_fn=lambda: 0.0))
        for name, n, cold, aborted in WINDOWS:
            s.record_window(name, n, cold=cold, aborted=aborted)
        out[pkg] = (s.status(), s.steady_total(), s.metrics.exposition())
    assert out["port"] == out["jax"]
    assert out["port"][0]["alerted"] == ["tick_engine", "ga_scan", "train_epoch.lstm"]


JAX_TRANSFER_ERRORS = [
    "Disallowed device-to-host transfer: shape=(4,), dtype=float32",
    "transfer guard: device_to_host transfers are disallowed here",
    "XlaRuntimeError: INVALID_ARGUMENT: Disallowed host-to-device transfer",
    "some other failure",
    "ValueError: shape mismatch",
]
TORCH_SYNC_ERROR = "called a synchronizing CUDA operation"


def test_transfer_counting_equals_jax_on_injected_errors():
    for msg in JAX_TRANSFER_ERRORS:
        exc = RuntimeError(msg)
        assert tmeshprof.is_transfer_violation(exc) == jmeshprof.is_transfer_violation(exc)
    assert tmeshprof.is_transfer_violation(RuntimeError(TORCH_SYNC_ERROR))
    assert not tmeshprof.is_transfer_violation(None)
    out = {}
    for pkg, (mod, metrics, _) in PKGS.items():
        t = mod.TransferSentinel(metrics=metrics(now_fn=lambda: 0.0))
        for i, msg in enumerate(JAX_TRANSFER_ERRORS):
            exc = RuntimeError(msg)
            if mod.is_transfer_violation(exc):
                t.record(("tick_engine", "ga_scan")[i % 2], exc)
        st = t.status()
        out[pkg] = ({k: st[k] for k in ("violations", "last_error")}, t.total(),
                    t.metrics.exposition())
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("state", [
    {"steady_recompile_programs": ["tick_engine"]},
    {"guarded_transfer_programs": ["ga_scan"]},
    {"mesh_pad_fraction_max": 0.375, "mesh_pad_waste_threshold": 0.25},
    {"mesh_memory_imbalance": 3.0, "mesh_imbalance_threshold": 2.0, "mesh_devices": 4},
    {"mesh_memory_imbalance": 1.0, "mesh_imbalance_threshold": 2.0, "mesh_devices": 1},
])
def test_mesh_alert_rules_fire_as_jax(state):
    fired = {pkg: sorted(f["name"] for f in al.AlertManager(now_fn=lambda: 0.0).evaluate(state))
             for pkg, (_, _, al) in PKGS.items()}
    assert fired["port"] == fired["jax"]


def test_watch_attributes_kernel_builds_to_the_window():
    """A library nvcc builds inside a watch window is that program's
    compile; after the warm-up window it is a steady-state recompile.  A
    library found built is a cache hit, not a compile."""
    mon = ttracing.KernelBuildMonitor.install()
    with tmeshprof.use(tmeshprof.MeshProf()) as mp:
        with tmeshprof.watch("tick_engine", cold=True):
            mon._on_build("fused_ewma", 3.0, False)
        with tmeshprof.watch("tick_engine"):
            mon._on_build("fused_ewma", 0.0, True)
        with tmeshprof.watch("tick_engine"):
            mon._on_build("replay_sweep", 2.0, False)
        st = mp.status()["recompiles"]
    assert st == {"windows": {"tick_engine": 3}, "compiles": {"tick_engine": 2},
                  "steady_recompiles": {"tick_engine": 1}, "alerted": ["tick_engine"]}
    assert tmeshprof.watch("tick_engine") is tmeshprof._NOOP_CTX     # off: no window


@pytest.fixture
def armed(monkeypatch):
    """The sync guard on a recording stand-in of torch's sync debug mode."""
    modes = []
    monkeypatch.setattr(tmeshprof, "_can_arm", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def test_sync_guard_arms_the_window_and_counts_a_violation(armed):
    with tmeshprof.use(tmeshprof.MeshProf()) as mp:
        with tmeshprof.watch("tick_engine"):
            with tmeshprof.allow_transfers():          # the sanctioned read
                pass
        assert armed == ["error", "default", "error", "default"]
        with pytest.raises(RuntimeError):
            with tmeshprof.watch("tick_engine"):
                raise RuntimeError(TORCH_SYNC_ERROR)   # what an .item() raises
        assert mp.transfers.violations == {"tick_engine": 1}
        armed.clear()
        with tmeshprof.watch("tick_engine"):          # disarmed after the first
            pass
        assert armed == []
        st = mp.status()["transfers"]
        assert st["armed_windows"] == 2 and st["unarmed_windows"] == 0
        assert mp.alert_state()["guarded_transfer_programs"] == ["tick_engine"]


def test_sync_gate_serializes_threads(armed):
    """Another thread's sanctioned read waits for an armed window to close
    (it never disarms it); a window opened while another thread holds the
    gate runs unarmed and is counted."""
    order = []
    with tmeshprof.use(tmeshprof.MeshProf()) as mp:
        def reader():
            with tmeshprof.allow_transfers():
                order.append("read")

        with tmeshprof.watch("tick_engine"):
            th = threading.Thread(target=reader)
            th.start()
            time.sleep(0.2)
            order.append("window")
        th.join(timeout=10)
        assert order == ["window", "read"]
        assert armed == ["error", "default"]

        held, release = threading.Event(), threading.Event()

        def holder():
            with tmeshprof.sync_gate():
                held.set()
                release.wait(10)

        th = threading.Thread(target=holder)
        th.start()
        held.wait(10)
        with tmeshprof.watch("ga_scan"):
            pass
        release.set()
        th.join(timeout=10)
        st = mp.status()["transfers"]
        assert st["unarmed_windows"] == 1 and st["armed_windows"] == 1


def test_offloaded_work_never_arms_and_never_blocks_the_loop(armed):
    """Offloaded model work runs in `sync_gate`: its own window and the
    loop's windows run unarmed while it is in flight, and the loop's
    sanctioned reads go on without waiting for it."""
    from ai_crypto_trader_tpu_torch.models.service import PredictionService
    from ai_crypto_trader_tpu_torch.shell import executor

    svc = PredictionService(None, ["BTCUSDC"], device="cpu")
    started, release, order = threading.Event(), threading.Event(), []

    def compute(now, hpo_req):               # a worker-thread epoch
        with tmeshprof.watch("train_epoch.lstm"):
            started.set()
            release.wait(10)
            order.append("epoch")
        return {}

    svc._compute = compute
    with tmeshprof.use(tmeshprof.MeshProf()) as mp:
        th = threading.Thread(target=svc._compute_offloaded, args=(0.0, None))
        th.start()
        started.wait(10)
        assert executor.host_read(torch.ones(2)) == [1.0, 1.0]
        order.append("read")
        with tmeshprof.watch("tick_engine"):
            pass
        release.set()
        th.join(timeout=10)
        assert order == ["read", "epoch"]
        assert armed == []                      # the mode never changed
        st = mp.status()["transfers"]
        assert st["armed_windows"] == 0 and st["unarmed_windows"] == 2
        with tmeshprof.watch("tick_engine"):    # arms again once it is done
            pass
        assert armed == ["error", "default"]


def test_another_threads_read_never_runs_under_an_armed_window(armed, monkeypatch):
    """The system's and the executor's `host_read` are sanctioned reads: on
    a thread other than the armed window's they wait for it to close, so
    their sync never meets the "error" mode."""
    from ai_crypto_trader_tpu_torch.shell import executor, launcher

    seen, order = [], []
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: seen.append(armed[-1] if armed else "default") or [])
    with tmeshprof.use(tmeshprof.MeshProf()):
        for read in (launcher.host_read, executor.host_read):
            order.clear()
            th = threading.Thread(target=lambda: (read(torch.ones(1)), order.append("read")))
            with tmeshprof.watch("tick_engine"):
                th.start()
                time.sleep(0.2)
                order.append("window")
            th.join(timeout=10)
            assert order == ["window", "read"]
    assert seen == ["default", "default"]


def test_partitioner_describes_the_host_as_jax():
    """The single-device seam, as JAX's describes the same host (the test
    process's JAX has virtual CPU devices, so its default is a mesh)."""
    assert get_partitioner().describe() == JSingle().describe()
    assert get_partitioner().trial_devices() == JSingle().trial_devices() == []


def test_population_eval_records_the_layout_card():
    part = get_partitioner()
    fn = part.population_eval(lambda pop, k: pop * k, name="pbt_generation")
    with tmeshprof.use(tmeshprof.MeshProf()) as mp:
        out = fn(torch.ones(6, 2), 2.0)
    assert torch.equal(out, torch.full((6, 2), 2.0))
    assert mp.layouts["pbt_generation"].to_dict() == {
        "program": "pbt_generation", "population": 6, "pad": 0, "padded": 6, "devices": 1,
        "pad_fraction": 0.0, "members_per_device": 6.0, "collective_bytes": 0}
    assert part.population_eval(len) is len                  # unnamed: the function


def test_ga_layout_card_equals_jax():
    """`run_ga` through the partitioner seam records the JAX package's
    ``ga_scan`` layout card (population, pad 0, one device)."""
    import jax

    from ai_crypto_trader_tpu.config import GAParams as JGAParams
    from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu.evolve import backtest_fitness as jfitness
    from ai_crypto_trader_tpu.evolve import run_ga as jrun_ga
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga

    d = {k: v for k, v in generate_ohlcv(n=64, seed=2).items() if k != "regime"}
    with jmeshprof.use(jmeshprof.MeshProf()) as jmp:
        jrun_ga(jax.random.PRNGKey(0), jfitness(d), JGAParams(population_size=6, generations=1))
    with tmeshprof.use(tmeshprof.MeshProf()) as tmp:
        run_ga(torch.Generator().manual_seed(0), backtest_fitness(d, device="cpu"),
               GAParams(population_size=6, generations=1), device="cpu")
    assert tmp.layouts["ga_scan"].to_dict() == jmp.layouts["ga_scan"].to_dict()
    assert tmp.status()["recompiles"]["windows"]["ga_scan"] == 1
    assert np.isfinite(tmp.pad_fraction_max())
