#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card, and check it.

    python3 chip_smoke.py

Runs from the root of a checkout of this repository and needs one NVIDIA
card (written for an H100, sm_90a), nvcc and PyTorch built for CUDA.  It
imports nothing of JAX or of the JAX package.  Phases, one JSON line each:

  0. device   — the card, and nvidia-smi's name and power limit;
  1. build    — both kernels compiled from ``ai_crypto_trader_tpu_torch/
                csrc/`` into ``.torch_kernels/`` (one nvcc per source, run
                together), with cuobjdump's register and shared-memory
                report of each library;
  2. ewma     — the fused-EWMA kernel against its plain PyTorch version on
                the card, at the three shapes compute_indicators gives it on
                a year of 1-minute candles, and at a ragged shape;
  2b. flips   — the year's indicator table built twice on the card, its EMA
                family once from the kernel and once from the plain version
                (the JAX package's rounding), and every signal, strength-gate
                and sizer-bucket difference that follows counted and held to
                a threshold it sits on;
  3. replay   — the replay-sweep kernel (K1) against the engine's eager
                plain loop on the card, stats and equity curve, through both
                of its variants (stats alone, and with the curve): 4096
                strategies over the first 8192 candles of the main path's
                inputs, B=130 × T=1500, T=900 with SL/TP overrides and
                confidence gating, SL/TP so small that every position closes
                on the next candle and so large that only the end of the
                test closes one, SL/TP hit with equality, and a ragged T of
                32·1024 + 7 with warmup 2000; `run_backtest`'s param-SL/TP
                mode at B=1 × T=8192 with its curve; and the graph-replayed
                plain loop (below) bit for bit against the eager one;
  4. main     — the population backtest at the bench's full size (T =
                525,600 candles, B = 4096 strategies) through the port's
                entry points, with launch counts, stage times and a check
                that every metric is finite and trades happen; then the
                kernel's stats from that run against the plain loop on the
                same inputs and strategies, at full size, and the curve of
                the first 256 strategies over all T against the plain
                loop's; K1's pre-pass and walk timed alone, the walk of the
                strategy with the most trades alone, and the pre-pass's gate
                mask against its plain version;
  5. kernels  — one line with each kernel's launches, error, times and
                bound, at the main path's shapes.

Any failed check raises, so the script exits non-zero and never prints its
last line, ``{"ok": true, "device": {...}}``.  Times are CUDA-event times
on the card; the bound of a kernel is the larger of its bytes over 3.35 TB/s
and its operations over 67 TFLOP/s (the H100 SXM's HBM rate and float32
rate outside the tensor cores, at the full 700 W power limit).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

T_FULL = 525_600          # one year of 1-minute candles (bench.py:2051)
B_FULL = 4096             # strategies on one chip (bench.py:2054)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# operations the replay needs (counted from csrc/replay_sweep.cu): the entry
# gate once per candle; the SL/TP test (sub, div, mul, two compares) on each
# in-position candle and strategy; per close the bookkeeping and its equity
# point, per entry the sizer.  The bound of a replay that steps every candle
# and strategy (REPLAY_OPS_STEP each) is printed beside it.
REPLAY_OPS_GATE, REPLAY_OPS_EXIT = 6, 5
REPLAY_OPS_CLOSE, REPLAY_OPS_ENTRY, REPLAY_OPS_BOOK = 6, 16, 10
REPLAY_OPS_STEP = 12
CURVE_B = 256             # strategies whose full-T curve is checked
# per element and output of the EWMA: the element map (select, multiply)
# and the recursion (multiply, add) and the NaN mask
EWMA_OPS = 5


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs, after one warm
    run.  The stream first spins for ~50 ms (``torch.cuda._sleep``), so the
    host has enqueued the runs before the card reaches the start event: a
    short kernel is timed on the card alone, not at the host's enqueue rate.
    (Work whose enqueue outlasts the spin, as the plain loop's, is timed
    with the host's gaps in it.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi[0] if smi else None,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def refused_launch_raises():
    """A launch the C entry refuses (K = 0 series maps) must raise in the
    wrapper's check, not pass silently."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import _cuda, ewma

    lib = _cuda.library("fused_ewma", ewma._SIGNATURES)
    x = torch.zeros((1, 16), device="cuda")
    rc = lib.fused_ewma_launch(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                               x.data_ptr(), None, None, 0, 1, 16, 0,
                               _cuda.stream_handle(x.device))
    try:
        _cuda.check(lib, "fused_ewma", rc)
    except RuntimeError as e:
        return str(e)
    fail("a refused kernel launch did not raise")


def resource_usage(path):
    """cuobjdump's registers and shared memory per kernel of a library (a
    diagnostic: the build does not depend on it)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-resource-usage", str(path)],
                         capture_output=True, text=True, timeout=60)
    kernels, name = [], None
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function"):
            name = line[len("Function"):].strip(" :")
        elif "REG:" in line:
            kernels.append({"function": name, "usage": line})
    return {"rc": out.returncode, "kernels": kernels}


def registers(report, library, fragment):
    """REG of the first kernel of ``library`` whose name holds ``fragment``."""
    for k in report[library]["resources"]["kernels"]:
        if fragment in (k["function"] or ""):
            return int(k["usage"].split("REG:")[1].split()[0])
    return None


def phase_build():
    from ai_crypto_trader_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    report = _cuda.build()
    libraries = {k: {**v, "resources": resource_usage(_cuda.library_path(k))}
                 for k, v in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libraries, "refused_launch": refused_launch_raises()})
    return libraries


def ewma_check(x, alphas, start, label):
    """Kernel vs plain on one input.  Values must satisfy
    |kernel - plain| <= 1e-3 + 2e-5 * S, S = the plain EWMA of |x|: the
    magnitude the recursion sums, which is |plain| for a series of one sign
    (the tolerance of tests/test_pallas.py:23).  For a signed series the
    output can pass through zero while its rounding stays that of S."""
    import torch

    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma, fused_ewma_plain

    got = fused_ewma(x, alphas, start, device="cuda")
    ref = fused_ewma_plain(x, alphas, start)
    scale = fused_ewma_plain(torch.abs(x), alphas, start)
    torch.cuda.synchronize()
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(nan_g, nan_r):
        fail(f"ewma {label}: NaN masks differ")
    diff = torch.where(nan_r, 0.0, torch.abs(got - ref))
    sc = torch.where(nan_r, 0.0, scale)
    bad = diff > 1e-3 + 2e-5 * sc
    if bool(bad.any()):
        fail(f"ewma {label}: {int(bad.sum())} values outside 1e-3 + 2e-5*S")
    strict_bad = diff > 1e-3 + 2e-5 * torch.where(nan_r, 0.0, torch.abs(ref))
    rel = diff / torch.clamp_min(sc, 1e-30)
    return {"shape": list(x.shape), "K": len(alphas), "start": start,
            "max_abs_err": float(diff.max()), "max_rel_err": float(rel.max()),
            "outside_rtol_of_value": int(strict_bad.sum())}


def phase_ewma(d):
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.ops import indicators as ind
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma, fused_ewma_plain

    close = torch.as_tensor(d["close"], device="cuda")
    high = torch.as_tensor(d["high"], device="cuda")
    low = torch.as_tensor(d["low"], device="cuda")
    e12, e26 = fused_ewma_plain(close[None], [2 / 13, 2 / 27], 0)[:, 0]
    line = ind._mask_warmup(e12 - e26, 26)
    up, dn = ind._rsi_moves(close)
    tr = ind.true_range(high, low, close)
    # the three launches of compute_indicators, on its own inputs
    main = [("close", close[None], [2 / 13, 2 / 27], 0),
            ("rsi_atr", torch.stack([up, dn, tr]), [1 / 14], 1),
            ("macd_signal", line[None], [0.2], 25)]
    checks, ms, plain_ms, bytes_ms, ops_ms = [], 0.0, 0.0, 0.0, 0.0
    for label, x, alphas, start in main:
        checks.append({"case": label, **ewma_check(x, alphas, start, label)})
        ms += cuda_ms(lambda: fused_ewma(x, alphas, start, device="cuda"), 20)
        plain_ms += cuda_ms(lambda: fused_ewma_plain(x, alphas, start), 3)
        B, T = x.shape
        bytes_ms += 1e3 * (4 * B * T + 4 * len(alphas) * B * T) / HBM_BYTES_PER_S
        ops_ms += 1e3 * EWMA_OPS * len(alphas) * B * T / F32_OPS_PER_S
    rng = np.random.default_rng(1234)
    ragged = torch.as_tensor(rng.normal(100, 5, (5, 1000)).astype(np.float32), device="cuda")
    for start in (0, 1, 25):
        checks.append({"case": f"ragged_start{start}",
                       **ewma_check(ragged, [2 / 13, 2 / 27, 1 / 14], start, "ragged")})
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    emit({"phase": "ewma", "checks": checks, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by})
    return {"max_abs_err": max(c["max_abs_err"] for c in checks[:3]),
            "max_rel_err": max(c["max_rel_err"] for c in checks[:3]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def replay_bound_ms(stats, B, T, warmup=10):
    """Least time for the replay at B × T on this run's data: the stream
    bytes read once and the stats written once, or the operations the data
    needed — the gate once per candle, the SL/TP test on every in-position
    candle (B·(T − warmup) − Σ(n_r − 1) that survive, and one per close),
    and each close and entry.  Also the bound of a replay that steps every
    candle and strategy: (ms, by, stepped_ms)."""
    trades = int(stats.total_trades.sum())
    books = int((stats.n_r - 1).sum())
    survived = B * (T - warmup) - books
    ops = (REPLAY_OPS_GATE * T + REPLAY_OPS_EXIT * (survived + trades)
           + (REPLAY_OPS_CLOSE + REPLAY_OPS_BOOK + REPLAY_OPS_ENTRY) * trades)
    stepped_ops = (REPLAY_OPS_STEP * B * T + (REPLAY_OPS_CLOSE + REPLAY_OPS_ENTRY) * trades
               + REPLAY_OPS_BOOK * books)
    n_bytes = 9 * 4 * T + 2 * 4 * B + 14 * 4 * B
    ms, by = max((n_bytes / HBM_BYTES_PER_S, "bytes"), (ops / F32_OPS_PER_S, "operations"))
    stepped_ms = max(n_bytes / HBM_BYTES_PER_S, stepped_ops / F32_OPS_PER_S)
    return 1e3 * ms, by, 1e3 * stepped_ms


def sweep_plain_graphed(inputs, params, steps=32, initial_balance=10_000.0,
                        ai_confidence_threshold=0.7, min_signal_strength=70.0,
                        warmup=10, curve_b=0):
    """`sweep_plain` — the engine's loop of `replay_step` in use_param_sl_tp
    mode — with ``steps`` candles of it captured in one CUDA graph and the
    graph replayed over T (the last T mod ``steps`` candles run eagerly).
    The ops and their order are the eager loop's, and so are the bits
    (phase 3 checks it); the card just stops waiting on the host, which
    issues the eager loop one op at a time and would take a quarter of an
    hour over 525,600 candles.  With ``curve_b`` the graph also writes the
    equity of the first ``curve_b`` strategies: (stats, curve [curve_b, T])."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import engine

    dev = inputs.close.device
    T, B = int(inputs.close.shape[-1]), int(params.stop_loss.shape[0])
    step = engine.replay_step(
        params, warmup=warmup, ai_confidence_threshold=ai_confidence_threshold,
        min_signal_strength=min_signal_strength, reference_quirks=False,
        use_param_sl_tp=True, return_curve=True, sell_exits=False)
    state = engine._init_state(initial_balance, (B,), dev)
    curve = torch.empty((curve_b, T), dtype=torch.float32, device=dev)
    t0 = torch.zeros((), dtype=torch.long, device=dev)
    offsets = torch.arange(steps, device=dev)

    def chunk():
        idx = t0 + offsets
        cols = [x.index_select(0, idx) for x in inputs]
        s, equity = state, []
        for k in range(steps):
            s, eq = step(s, (idx[k],) + tuple(c[k] for c in cols))
            equity.append(eq[:curve_b])
        if curve_b:
            curve.index_copy_(1, idx, torch.stack(equity, 1))
        for dst, src in zip(state, s):
            dst.copy_(src)
        t0.add_(steps)

    side = torch.cuda.Stream(dev)               # warm-up off the capture
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        chunk()
    torch.cuda.current_stream(dev).wait_stream(side)
    for dst, src in zip(state, engine._init_state(initial_balance, (B,), dev)):
        dst.copy_(src)
    t0.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chunk()
    n = T // steps
    for _ in range(n):
        graph.replay()
    s = state
    for t in range(n * steps, T):
        s, eq = step(s, (t,) + tuple(x[t] for x in inputs))
        curve[:, t] = eq[:curve_b]
    stats = engine.finalize_stats(s, inputs.close[-1], initial_balance)
    return (stats, curve) if curve_b else stats


def same_bits(g, r):
    """float32 tensors equal bit for bit."""
    import torch

    return g.shape == r.shape and torch.equal(g.contiguous().view(torch.int32),
                                              r.contiguous().view(torch.int32))


def compare_stats(got, ref, label, curve=None, ref_curve=None):
    """Every stat bit-identical (counts equal, floats equal bit for bit), and
    the curves too where given, and trades > 0."""
    import torch

    worst = 0.0
    for f in ref._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if r.dtype == torch.int32:
            if not torch.equal(g, r):
                fail(f"replay {label}: {f} differs in {int((g != r).sum())} strategies")
        else:
            worst = max(worst, float(torch.abs(g - r).max()))
            if not same_bits(g, r):
                fail(f"replay {label}: {f} not bit-identical (max abs err {worst})")
    out = {"case": label, "B": int(ref.total_trades.numel()),
           "trades": int(ref.total_trades.sum()), "max_abs_err": worst}
    if ref_curve is not None:
        if not same_bits(curve, ref_curve):
            fail(f"replay {label}: the curve is not bit-identical (max abs err "
                 f"{float(torch.abs(curve - ref_curve).max())})")
        out["curve_max_abs_err"] = float(torch.abs(curve - ref_curve).max())
    if out["trades"] <= 0:
        fail(f"replay {label}: no trades — the parity would be vacuous")
    return out


def timed(fn):
    """``fn()`` once between two CUDA events: (its result, ms)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def replay_check(inputs, params, label, **kw):
    """The kernel, both variants, against the engine's eager plain loop on
    the card, stats and curve; the plain loop's time rides along."""
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel, sweep_plain

    got = sweep_kernel(inputs, params, device="cuda", **kw)
    got_c, curve = sweep_kernel(inputs, params, device="cuda", return_curve=True, **kw)
    (ref, ref_curve), plain_ms = timed(
        lambda: sweep_plain(inputs, params, return_curve=True, **kw))
    compare_stats(got_c, ref, label + "/curve_variant", curve, ref_curve)
    check = {**compare_stats(got, ref, label), "T": int(inputs.close.shape[-1]),
             "curve_max_abs_err": 0.0}
    return check, (ref, ref_curve), plain_ms


def phase_flips(d, params):
    """K2's rounding where the backtest reads it.  The kernel composes a
    chunk's affine maps in another order than `fused_ewma_plain`, which
    replays the JAX package's scan tree bit for bit.  MACD (two EMAs that
    nearly cancel) and RSI feed the signal's votes and its strength, and
    ATR the sizer's volatility buckets.  The year's table is built twice on
    the card, its EMA family once through the kernel and once through the
    plain version.  Every candle whose signal, strength gate (>= 70) or
    sizer bucket differs must sit within 1e-4 of a threshold on its input's
    scale — |macd| <= 1e-4·close (the vote is macd > 0, and the strength
    term min(|macd|, 1)·20 moves only below 1, which is below 1e-4 of any
    price here), RSI within 1e-2 of 35 or 45, strength within 1e-2 of 70,
    volatility within a relative 1e-4 of 0.01 or 0.02 — and each kind must
    be rare: at most one candle in 1,000.  The sweep over both inputs then
    counts the strategies that the differences change (reported only)."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        compute_signal_features, prepare_inputs, sweep)
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops import indicators as ind_mod
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma_plain

    def ewma_plain(x, alphas, start=0, device=None):
        lead, T = x.shape[:-1], x.shape[-1]
        out = fused_ewma_plain(x.reshape(-1, T), alphas, start)
        return out.reshape((out.shape[0],) + tuple(lead) + (T,))

    tab_k = compute_indicators(d, device="cuda")
    kernel_ewma, ind_mod.fused_ewma = ind_mod.fused_ewma, ewma_plain
    try:
        tab_p = compute_indicators(d, device="cuda")
    finally:
        ind_mod.fused_ewma = kernel_ewma
    inp_k, inp_p = (prepare_inputs(t, device="cuda") for t in (tab_k, tab_p))
    f = compute_signal_features(tab_p)
    T = int(f.close.shape[-1])

    near_macd = torch.abs(f.macd) <= 1e-4 * f.close
    near_rsi = torch.minimum(torch.abs(f.rsi - 35.0), torch.abs(f.rsi - 45.0)) <= 1e-2
    near_str = torch.abs(inp_p.strength - 70.0) <= 1e-2
    vol_p, vol_k = inp_p.volatility, inp_k.volatility
    near_vol = torch.minimum(torch.abs(vol_p - 0.01) / 0.01,
                             torch.abs(vol_p - 0.02) / 0.02) <= 1e-4
    sig_flip = inp_k.signal != inp_p.signal
    kinds = {
        "signal": (sig_flip, near_macd | near_rsi),
        "decision": (inp_k.decision != inp_p.decision, near_macd | near_rsi),
        "strength_gate": (~sig_flip & ((inp_k.strength >= 70.0) != (inp_p.strength >= 70.0)),
                          near_macd | near_rsi | near_str),
        "sizer_bucket": (((vol_k > 0.02) != (vol_p > 0.02)) | ((vol_k > 0.01) != (vol_p > 0.01)),
                         near_vol),
    }
    entry = lambda i: (i.signal == i.decision) & (i.decision == 1) & (i.strength >= 70.0)  # noqa: E731
    report = {"phase": "ewma_flips", "T": T, "limit_per_kind": T // 1000,
              "entry_gate_differs": int((entry(inp_k) != entry(inp_p)).sum())}
    for kind, (diff, near) in kinds.items():
        where = torch.nonzero(diff).flatten()
        report[kind] = {
            "count": int(where.numel()), "far_from_threshold": int((diff & ~near).sum()),
            "examples": [{"t": int(t), "close": float(f.close[t]), "macd": float(f.macd[t]),
                          "rsi": float(f.rsi[t]), "strength": [float(inp_p.strength[t]),
                                                                float(inp_k.strength[t])],
                          "volatility": float(vol_p[t])} for t in where[:3]]}
    st_k, st_p = (sweep(i, params, device="cuda") for i in (inp_k, inp_p))
    report["strategies_changed"] = int(((st_k.total_trades != st_p.total_trades)
                                        | (st_k.final_balance != st_p.final_balance)).sum())
    report["strategies"] = int(params.stop_loss.shape[0])
    emit(report)
    for kind in kinds:
        if report[kind]["far_from_threshold"]:
            fail(f"ewma flips: {report[kind]['far_from_threshold']} {kind} differences "
                 "sit farther than 1e-4 from any threshold")
        if report[kind]["count"] > T // 1000:
            fail(f"ewma flips: {report[kind]['count']} {kind} differences, over T/1000")
    return report


def exact_tie(inp, e1=500, keep_from=2000):
    """Entries only at two candles (and from ``keep_from`` on, as the
    signals have them): at e1 a TP override equal to the float32 pnl% of a
    later candle x1, computed on the card with replay_step's operands, and
    SL out of reach; at e2 = x1 + 50 an SL override equal to minus the pnl%
    of a later candle x2.  Both exits are hit with equality.  Returns the
    inputs and (x1, x2)."""
    import torch

    close = inp.close
    c = close.cpu().numpy()

    def extreme(e, sign, nth):   # the nth new strict extreme after e
        best, found = sign * c[e], 0
        for t in range(e + 1, len(c)):
            if sign * c[t] > best:
                best, found = sign * c[t], found + 1
                if found == nth:
                    return t
        fail("exact tie: no such candle")

    x1 = extreme(e1, 1, 6)
    e2 = x1 + 50
    x2 = extreme(e2, -1, 4)
    if x2 >= keep_from:
        fail("exact tie: the second exit runs into the free entries")
    pnl = lambda e, t: (close[t] - close[e]) / close[e] * 100.0  # noqa: E731
    t = torch.arange(close.shape[0], device=close.device)
    hot = (t == e1) | (t == e2)
    sig = torch.where(hot, 1, torch.where(t >= keep_from, inp.signal, 0)).to(torch.int32)
    sl = torch.full_like(close, float("nan"))
    tp = torch.full_like(close, float("nan"))
    tp[e1], sl[e1] = pnl(e1, x1), 1e6
    sl[e2], tp[e2] = -pnl(e2, x2), 1e6
    return inp._replace(signal=sig, decision=sig, strength=torch.where(hot, 100.0, inp.strength),
                        sl_pct=sl, tp_pct=tp), (x1, x2)


def phase_replay(main_inputs, params, d_small):
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        default_params, prepare_inputs, run_backtest, sample_params)
    from ai_crypto_trader_tpu_torch.backtest.engine import replay
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    inputs_of = lambda n: prepare_inputs(  # noqa: E731
        compute_indicators(d_small(n), device="cuda"), device="cuda")
    T_HEAD = 8192
    head = type(main_inputs)(*(x[:T_HEAD] for x in main_inputs))
    c, (ref_head, ref_curve), head_plain_ms = replay_check(head, params, "main_head")
    checks = [c]
    (graphed, graphed_curve), head_graphed_ms = timed(
        lambda: sweep_plain_graphed(head, params, curve_b=CURVE_B))
    for f in ref_head._fields:
        if not torch.equal(getattr(graphed, f), getattr(ref_head, f)):
            fail(f"the graph-replayed plain loop differs from the eager one in {f}")
    if not same_bits(graphed_curve, ref_curve[:CURVE_B]):
        fail("the graph-replayed plain loop's curve differs from the eager one's")
    head_ms = cuda_ms(lambda: sweep_kernel(head, params, device="cuda"), 10)

    checks.append(replay_check(inputs_of(1500), sample_params(gen(), 130, device="cuda"),
                               "B130_T1500")[0])

    inp = inputs_of(900)
    rng = np.random.default_rng(1)
    mask = torch.as_tensor(rng.random(900) < 0.33, device="cuda")
    conf = torch.where(torch.arange(900, device="cuda") % 3 == 0, 0.9, 0.2)
    inp = inp._replace(sl_pct=torch.where(mask, 1.5, torch.nan),
                       tp_pct=torch.where(mask, 3.0, torch.nan), confidence=conf)
    checks.append(replay_check(inp, sample_params(gen(), 32, device="cuda"),
                               "T900_overrides_gated")[0])

    inp = inputs_of(3000)
    p32 = sample_params(gen(), 32, device="cuda")
    for label, v in (("tiny_sl_tp_1e-4", 1e-4), ("huge_sl_tp_1e6", 1e6)):
        full = torch.full((32,), v, dtype=torch.float32, device="cuda")
        c, (ref, _), _ = replay_check(inp, p32._replace(stop_loss=full, take_profit=full), label)
        if v > 1 and not bool((ref.total_trades == 1).all()):
            fail("huge SL/TP: a position closed before the end of the test")
        if v < 1 and int(ref.total_trades.min()) <= 100:
            fail("tiny SL/TP: positions did not close on the next candle")
        checks.append(c)
    tie, exits = exact_tie(inp)
    c, (_, curve), _ = replay_check(tie, p32, "exact_tie")
    for x in exits:
        if not bool((curve[:, x] != curve[:, x - 1]).all()):
            fail(f"exact tie: not every strategy closed at candle {x}")
    checks.append({**c, "tie_exits": list(exits)})

    T_R = 32 * 1024 + 7
    checks.append(replay_check(inputs_of(T_R), sample_params(gen(), 256, device="cuda"),
                               f"ragged_T{T_R}_warmup2000", warmup=2000)[0])

    # run_backtest's param-SL/TP mode: one strategy through the kernel
    dp = default_params(device="cuda")
    before = sweep_kernel.launches
    got, curve = run_backtest(head, dp, use_param_sl_tp=True, return_curve=True, device="cuda")
    if sweep_kernel.launches != before + 1:
        fail("run_backtest(use_param_sl_tp=True) did not launch the replay kernel")
    if got.total_trades.shape != () or curve.shape != (T_HEAD,):
        fail(f"run_backtest shapes changed: {tuple(got.total_trades.shape)}, "
             f"{tuple(curve.shape)}")
    (ref, ref_c), _ = timed(lambda: replay(head, dp, use_param_sl_tp=True, return_curve=True))
    checks.append({**compare_stats(got, ref, "run_backtest_B1_T8192", curve, ref_c),
                   "T": T_HEAD})
    emit({"phase": "replay", "checks": checks, "graphed_plain_bit_identical": True,
          "head": {"B": B_FULL, "T": T_HEAD, "ms": head_ms, "plain_ms": head_plain_ms,
                   "graphed_plain_ms": head_graphed_ms}})
    return checks


def run_main_path(d):
    """compute_indicators → prepare_inputs → sample_params → sweep →
    compute_metrics on the card, each stage between CUDA events."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        compute_metrics, prepare_inputs, sample_params, sweep)
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    names = ("indicators", "prepare_inputs", "sample_params", "sweep", "metrics")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    ind = compute_indicators(d, device="cuda")
    ev[1].record()
    inp = prepare_inputs(ind, device="cuda")
    ev[2].record()
    params = sample_params(torch.Generator().manual_seed(0), B_FULL, device="cuda")
    ev[3].record()
    stats = sweep(inp, params, device="cuda")
    ev[4].record()
    metrics = compute_metrics(stats, device="cuda")
    ev[5].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stage_ms = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    return inp, params, stats, metrics, stage_ms, wall


def phase_main(d):
    import torch

    from ai_crypto_trader_tpu_torch.backtest import BacktestStats, sweep
    from ai_crypto_trader_tpu_torch.ops import replay
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    run_main_path(d)                                   # warm run
    fused_ewma.launches = 0
    sweep_kernel.launches = 0
    inp, params, stats, metrics, stage_ms, wall = run_main_path(d)
    launches = {"fused_ewma": fused_ewma.launches,
                "replay_sweep": sweep_kernel.launches}
    if launches["fused_ewma"] < 3 or launches["replay_sweep"] < 1:
        fail(f"the main path did not go through both kernels: {launches}")
    for k, v in metrics.items():
        if v.shape not in ((), (B_FULL,)) or not bool(torch.isfinite(v).all()):
            fail(f"metric {k} is not finite of shape [{B_FULL}]")
    trades = int(stats.total_trades.sum())
    if trades <= 0:
        fail("the full-size sweep made no trades")
    # the kernel's launch on the main path, held against the plain loop on
    # the same inputs and strategies; the plain loop also writes the curve
    # of the first CURVE_B strategies, held against the curve variant's
    (plain, plain_curve), plain_ms = timed(
        lambda: sweep_plain_graphed(inp, params, curve_b=CURVE_B))
    full = compare_stats(stats, plain, "main_full")
    full["T"] = T_FULL
    head = params._replace(**{f: getattr(params, f)[:CURVE_B] for f in params._fields})
    got, curve = sweep(inp, head, return_curve=True, device="cuda")
    curve_check = compare_stats(got, BacktestStats(*(v[:CURVE_B] for v in plain)),
                                f"main_full_curve_B{CURVE_B}", curve, plain_curve)
    curve_check["T"] = T_FULL
    del curve, plain_curve
    ms = cuda_ms(lambda: sweep_kernel(inp, params, device="cuda"), 10)
    curve_ms = cuda_ms(lambda: sweep_kernel(inp, head, return_curve=True, device="cuda"), 3)
    # the pre-pass against its plain version, and each launch timed alone
    dev = inp.close.device
    lib, s, sl, tp, T = replay.kernel_operands(inp, params, dev)
    mask = replay.launch_gate(lib, s, T, 10, 0.7, 70.0, dev)
    if not torch.equal(mask, replay.gate_mask_plain(inp)):
        fail("the pre-pass's gate mask differs from its plain version")
    gate_ms = cuda_ms(lambda: replay.launch_gate(lib, s, T, 10, 0.7, 70.0, dev), 20)
    walk_ms = cuda_ms(lambda: replay.launch_walk(lib, s, mask, sl, tp, T, 10, 10_000.0,
                                                 False, dev), 10)
    # the walk of the strategy with the most trades, alone: its serial chain
    # of events is the least time the whole walk can take
    h = int(torch.argmax(stats.total_trades))
    heaviest = {"index": h, "trades": int(stats.total_trades[h]), "walk_ms": cuda_ms(
        lambda: replay.launch_walk(lib, s, mask, sl[h:h + 1], tp[h:h + 1], T, 10,
                                   10_000.0, False, dev), 10)}
    gate_bits = (mask.to(torch.int64)[:, None] >> torch.arange(32, device=dev)) & 1
    best = int(torch.argmax(metrics["sharpe_ratio"]))
    emit({"phase": "main", "T": T_FULL, "B": B_FULL, "launches": launches,
          "stage_ms": stage_ms, "wall_s": wall,
          "candles_per_sec": T_FULL * B_FULL / (stage_ms["sweep"] / 1e3),
          "end_to_end_candles_per_sec": T_FULL * B_FULL / wall,
          "total_trades": trades,
          "buy_signals": int((inp.signal == 1).sum()),
          "gate_candles": int(gate_bits.sum()),
          "full_check": full, "curve_check": curve_check, "kernel_ms": ms,
          "prepass_ms": gate_ms, "walk_ms": walk_ms, "curve_ms": curve_ms,
          "heaviest_strategy": heaviest, "plain_ms": plain_ms,
          "best": {k: float(v[best]) for k, v in metrics.items()
                   if k in ("sharpe_ratio", "final_balance", "total_trades",
                            "win_rate", "max_drawdown_pct")}})
    return launches, stats, [full, curve_check], {
        "ms": ms, "plain_ms": plain_ms, "prepass_ms": gate_ms, "walk_ms": walk_ms,
        "curve_ms": curve_ms, "heaviest": heaviest}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import ai_crypto_trader_tpu_torch  # noqa: F401 — the checkout's port

    info = phase_device()
    from ai_crypto_trader_tpu_torch.backtest import prepare_inputs, sample_params
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    libraries = phase_build()
    d = {k: v for k, v in generate_ohlcv(n=T_FULL, seed=3).items() if k != "regime"}

    def d_small(n):
        return {k: v for k, v in generate_ohlcv(n=n, seed=3).items() if k != "regime"}

    params = sample_params(torch.Generator().manual_seed(0), B_FULL, device="cuda")
    ewma = phase_ewma(d)
    phase_flips(d, params)
    main_inputs = prepare_inputs(compute_indicators(d, device="cuda"), device="cuda")
    checks = phase_replay(main_inputs, params, d_small)
    launches, stats, full, k1 = phase_main(d)
    bound_ms, bound_by, stepped_bound_ms = replay_bound_ms(stats, B_FULL, T_FULL)
    checks += full
    kernels = [
        {"name": "fused_ewma", "route": "cuda",
         "source": "ai_crypto_trader_tpu_torch/csrc/fused_ewma.cu",
         "replaces": "ai_crypto_trader_tpu/ops/pallas_kernels.py:88",
         "launches": launches["fused_ewma"],
         "max_abs_err": ewma["max_abs_err"], "max_rel_err": ewma["max_rel_err"],
         "ms": ewma["ms"], "plain_ms": ewma["plain_ms"],
         "bound_ms": ewma["bound_ms"], "bound_by": ewma["bound_by"], "library_ms": None,
         "shape": "the three launches of compute_indicators at T=525600, summed"},
        {"name": "replay_sweep", "route": "cuda",
         "source": "ai_crypto_trader_tpu_torch/csrc/replay_sweep.cu",
         "replaces": "ai_crypto_trader_tpu/ops/pallas_backtest.py:259",
         "launches": launches["replay_sweep"],
         "max_abs_err": max(max(c["max_abs_err"], c.get("curve_max_abs_err", 0.0))
                            for c in checks),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
         "prepass_ms": k1["prepass_ms"], "walk_ms": k1["walk_ms"],
         "curve_ms": k1["curve_ms"], "curve_shape": f"B={CURVE_B} x T={T_FULL}",
         "walk_ms_heaviest_alone": k1["heaviest"]["walk_ms"],
         "heaviest_trades": k1["heaviest"]["trades"],
         "bound_ms_stepping_every_candle": stepped_bound_ms,
         "registers": {"walk": registers(libraries, "replay_sweep", "replay_walk_kernelILb0E"),
                       "walk_curve": registers(libraries, "replay_sweep",
                                               "replay_walk_kernelILb1E"),
                       "gate": registers(libraries, "replay_sweep", "replay_gate_kernel")},
         "shape": f"B={B_FULL} x T={T_FULL}",
         "plain": "the engine's loop, 32 candles a CUDA graph"},
    ]
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
