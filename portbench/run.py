"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration (``portbench/configs/<config>.json``, whose ``kind``
names ``portbench/kinds/<kind>.py``) and its traffic mix
(``portbench/traffic/<mix>.json``); a per-layer metric is read by
``portbench/metrics/<metric>.py``.  A run sets up (imports, the kernels
from ``.torch_kernels/``, data, warm requests of the cell's shapes),
measures for ``--seconds``, judges a sample of what the window produced
against the plain reference (`portbench.reference`), and prints one JSON
line last: the end-to-end metrics with ``--trace 0``, the per-layer
metrics and the profiler's reading with ``--trace 1``.  Each number the
judgement compared is printed beside its limit, as the last lines of
standard error and under ``checks``, the line's last key.

Exit codes: 0 with a result; 3 without a CUDA card (or fewer than the cell
asks for); 4 when the JAX package, JAX or the old benchmark is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ai_crypto_trader_tpu", "bench")
PROFILE_STRETCH_S = 8.0


def set_cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its own kernels into ``.torch_kernels/`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".triton_cache")


def load_cell(name: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return spec_of(bench, cell)


def spec_of(bench: dict, cell: dict) -> dict:
    """A cell's configuration, traffic and metrics, found by name."""
    name = cell["name"]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {"cell": cell,
            "config": json.loads((ROOT / entry["file"]).read_text()),
            "traffic": json.loads((PKG / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def load_reader(metric: str):
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class RunRecord:
    """What a per-layer reader reads: the device milliseconds of each
    layer's calls, the host times of each tick (a trading cell's), the
    cell's shapes and the profiler's reading."""

    def __init__(self, device_ms: dict, host_ms: list, shapes: dict, trace: dict | None):
        self.device_ms, self.host_ms, self.shapes, self.trace = device_ms, host_ms, shapes, trace


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(spec: dict, seed: int, seconds: float, trace: bool, device: str,
            t0: float) -> dict:
    """Set up, measure, judge.  Returns the pieces of the result line."""
    import torch

    from portbench.trace import Tracer

    kind = importlib.import_module(f"portbench.kinds.{spec['config']['kind']}")
    cell = kind.Cell(spec["config"], spec["traffic"], seed, device)
    on_card = torch.device(device).type == "cuda"
    tracer = (Tracer(PROFILE_STRETCH_S, max(seconds - PROFILE_STRETCH_S - 1.0, 0.0))
              if trace and on_card else None)
    if tracer is not None:
        tracer.warm()
    cell.prepare()
    setup_s = time.perf_counter() - t0 - cell.reference_s
    cell.spans.enabled = trace
    window = kind.run_window(cell, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    device_ms = cell.spans.device_ms() if trace else {}
    records = cell.release()
    t_judge = time.perf_counter()
    per_request, notes = cell.judge(records)
    notes["judge_s"] = time.perf_counter() - t_judge
    notes["reference_s"] = cell.reference_s
    limits = spec["config"]["limits"]
    names = sorted({k for r in per_request for k in r} | set(limits))
    worst = {k: max((r[k] for r in per_request if k in r), default=float("inf"))
             for k in names}
    # a number over its limit, NaN, or one that no check produced fails
    wrong = sum(any(not v <= limits.get(k, -1.0) for k, v in r.items()) for r in per_request)
    correct = bool(per_request) and wrong == 0 and all(worst[k] <= limits[k] for k in limits)
    return {"setup_s": setup_s, "window": window, "peak": peak, "device_ms": device_ms,
            "host_ms": getattr(cell, "host_ms", []),
            "shapes": cell.shapes(), "trace": tracer.summary if tracer else None,
            "checks": {k: {"value": worst[k], "limit": limits.get(k)} for k in names},
            "correct": correct, "wrong": wrong, "notes": notes}


def result_line(spec: dict, out: dict, trace: bool, chips: int) -> dict:
    import torch

    w = out["window"]
    if trace:
        record = RunRecord(out["device_ms"], out["host_ms"], out["shapes"], out["trace"])
        metrics = {}
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(w["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out["peak"])}
    line = {"correct": out["correct"], "attempted": w["attempted"],
            "failed": w["failed"] + out["wrong"], "metrics": metrics, "device": device}
    if trace:
        t = out["trace"] or {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    spec = load_cell(args.workload)
    chips = int(spec["cell"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    out = execute(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 4
    line = result_line(spec, out, bool(args.trace), chips)
    w = out["window"]
    ms = sorted(w["request_ms"]) or [0.0]
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "window_s": w["window_s"], "card": power_limit(),
                      "request_ms_quartiles": [ms[len(ms) // 4], ms[len(ms) // 2],
                                               ms[3 * len(ms) // 4], ms[-1]],
                      "wall_s": time.perf_counter() - T0,
                      "notes": out["notes"]}), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
