"""The cells the tests drive, every workload of BENCHMARK.json, and the
small sizes at which a test on the CPU runs them."""

import json

from portbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = sorted(w["name"] for w in BENCH["workloads"])


def spec_of(cell: str) -> dict:
    """The run spec of ``cell``."""
    return run.spec_of(BENCH, next(w for w in BENCH["workloads"] if w["name"] == cell))


def kind_of(cell: str) -> str:
    return spec_of(cell)["config"]["kind"]


def small(cell: str, permissive: bool = False) -> dict:
    """``cell``'s spec cut to a size the CPU runs in seconds.  A trading
    cell's ``permissive`` tenants take every BUY, so that its decisions
    open positions and carry state within a few ticks."""
    spec = spec_of(cell)
    if kind_of(cell) == "sweep":
        spec["config"]["candles"], spec["traffic"]["strategies"] = 1500, 8
        spec["traffic"]["warmup_requests"] = 1
    else:
        spec["config"]["symbols"], spec["config"]["window"] = 8, 64
        spec["traffic"].update(tenants=8, warmup_ticks=2, control_ticks=6, check_ticks=4)
        if permissive:
            spec["config"]["tenant"].update(confidence_threshold=[0.0, 0.05],
                                            min_signal_strength=[0.0, 5.0])
    return spec
