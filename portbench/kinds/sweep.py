"""The sweep cells: a researcher's population backtest over one symbol's
year of candles.

A closed loop with one client.  Set-up makes the symbol's replay streams
with the plain reference (its float64 indicator table, the signal rule in
float32) from candles drawn from the configuration's symbol seed, and
hands them to the port as its inputs.  Each request draws ``strategies``
fresh strategies from its seed (the port's `sample_params` on a card
generator) and replays them over those streams: `sweep` -> `compute_metrics`,
ending in one host read: the best strategy by Sharpe and its metrics, as
`cli backtest --sweep` reports them.

Judged afterwards by `portbench.reference.judge` on a reservoir sample of
the requests, drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import spans
from portbench.kinds import seed_of
from portbench.reference import judge
from portbench.reference import metrics as ref_metrics
from portbench.reference import replay as ref_replay
from portbench.reference import signals as ref_sig
from portbench.reference.numerics import BF16
from portbench.traffic.ohlcv import generate_ohlcv

METRIC_KEYS = (
    "final_balance", "total_trades", "winning_trades", "losing_trades", "win_rate",
    "profit_factor", "total_profit", "total_loss", "max_drawdown", "max_drawdown_pct",
    "sharpe_ratio", "sortino_ratio", "calmar_ratio", "total_return_pct",
    "annualized_return_pct", "expectancy", "avg_win", "avg_loss", "recovery_factor",
    "max_win_streak", "max_loss_streak")
STATS_KEYS = (
    "initial_balance", "final_balance", "total_trades", "winning_trades", "losing_trades",
    "total_profit", "total_loss", "max_drawdown", "max_drawdown_pct", "sum_r", "sum_r2",
    "sum_neg_r2", "n_r", "max_win_streak", "max_loss_streak")



class Cell:
    """One run of a sweep cell on ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        from ai_crypto_trader_tpu_torch.backtest import compute_metrics, sample_params, sweep

        self.torch, self.device = torch, torch.device(device)
        self.port = dict(sample_params=sample_params, sweep=sweep,
                         compute_metrics=compute_metrics)
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.T = int(config["candles"])
        self.B = int(traffic["strategies"])
        self.raw = generate_ohlcv(self.T, config["symbol_seed"], **config["generator"])
        self.inputs = None
        self.reference_s = 0.0
        self.spans = spans.Spans(self.device)
        self.kept: list = []          # the reservoir: (index, request record)
        self._draw = np.random.default_rng(seed_of(seed, 2))

    # -- the timed path ------------------------------------------------------
    def prepare(self) -> None:
        """Set-up: the streams, and warm requests over this cell's shapes.
        The reference's seconds in it are ``reference_s``, which the run
        leaves out of its set-up time."""
        t = time.perf_counter()
        streams, _ = judge.reference_streams(self.raw)
        self.reference_s = time.perf_counter() - t
        self.inputs = self._port_inputs(streams)
        for k in range(int(self.traffic["warmup_requests"])):
            self.request(-1 - k, keep=False)
        self.torch.cuda.synchronize() if self.device.type == "cuda" else None

    def _port_inputs(self, streams: dict):
        """The port's `BacktestInputs` holding the reference's streams."""
        from ai_crypto_trader_tpu_torch.backtest import BacktestInputs

        on = lambda x: self.torch.from_numpy(np.ascontiguousarray(x)).to(self.device)  # noqa: E731
        nan = np.full(self.T, np.nan, np.float32)
        return BacktestInputs(*(on(streams[k]) for k in judge.STREAMS), sl_pct=on(nan),
                              tp_pct=on(nan))

    def request(self, i: int, keep: bool = True) -> bool:
        """Request ``i``; returns whether its metrics read back finite."""
        torch, port, sp = self.torch, self.port, self.spans
        inp = self.inputs
        request_seed = seed_of(self.seed, 3, i) if i >= 0 else seed_of(self.seed, 5, -i)
        with sp.label("sample"):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(request_seed)
            params = port["sample_params"](gen, self.B, device=self.device)
        with sp.layer("replay"):
            stats = port["sweep"](inp, params, device=self.device)
        with sp.label("metrics"):
            metrics = port["compute_metrics"](stats, device=self.device)
        with sp.label("read"):
            # what `cli backtest --sweep` reports: the best strategy by
            # Sharpe and its metrics, here in one read
            best = torch.argmax(metrics["sharpe_ratio"])
            host = torch.stack([metrics[k].to(torch.float32)[best] for k in METRIC_KEYS]
                               + [best.to(torch.float32)]).cpu().numpy()
        ok = bool(np.isfinite(host).all())
        if keep:
            self._reservoir(i, dict(stats=stats, metrics=metrics, seed=request_seed))
        return ok

    def _reservoir(self, i: int, record: dict) -> None:
        k = int(self.traffic["check_requests"])
        if len(self.kept) < k:
            self.kept.append((i, record))
        else:
            j = int(self._draw.integers(0, i + 1))
            if j < k:
                self.kept[j] = (i, record)

    def candles(self) -> int:
        return self.B * self.T

    def shapes(self) -> dict:
        return {"T": self.T, "B": self.B}

    # -- after the window ----------------------------------------------------
    def release(self) -> list:
        """The kept requests' outputs as host arrays; frees the card."""
        torch = self.torch
        streams = {k: getattr(self.inputs, k).cpu().numpy() for k in judge.STREAMS}
        out = [dict(index=i, seed=rec["seed"], streams=streams,
                    stats={k: getattr(rec["stats"], k).cpu().numpy() for k in STATS_KEYS},
                    metrics={k: rec["metrics"][k].cpu().numpy() for k in METRIC_KEYS})
               for i, rec in sorted(self.kept, key=lambda x: x[0])]
        self.kept, self.inputs = [], None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return out

    def uniforms(self, request_seed: int) -> np.ndarray:
        """The [B, 18] uniforms a request's strategies are drawn from, drawn
        again from its seed on the same device."""
        torch = self.torch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(request_seed)
        return torch.rand((self.B, 18), generator=gen, device=self.device).cpu().numpy()

    def judge(self, records: list) -> tuple[list, dict]:
        """The check's numbers for each kept request, and notes for
        standard error."""
        per_request, notes = [], {}
        rng = np.random.default_rng(seed_of(self.seed, 4))
        n_rows = int(self.traffic["check_strategies"])
        for rec in records:
            got = {}
            stops, targets = judge.stops_from_uniforms(self.uniforms(rec["seed"]))
            heaviest = int(np.argmax(rec["stats"]["total_trades"]))
            rows = sorted(set(rng.choice(self.B, size=min(n_rows, self.B), replace=False).tolist())
                          | {heaviest})
            got.update(judge.replay_numbers(rec["streams"], stops, targets, rec["stats"], rows))
            got.update(judge.metric_numbers(rec["stats"], rec["metrics"]))
            per_request.append(got)
            notes[f"request_{rec['index']}"] = dict(
                rows=len(rows), heaviest_trades=int(rec["stats"]["total_trades"][heaviest]))
        return per_request, notes


def run_window(cell: Cell, seconds: float, tracer=None) -> dict:
    """The measured window: requests back to back until ``seconds`` have
    passed; the rate is over all completed requests and all the time."""
    torch = cell.torch
    attempted = failed = 0
    done_candles = 0
    request_ms = []
    t_start = now = time.perf_counter()
    while now - t_start < seconds:
        if tracer is not None:
            tracer.tick(now - t_start)
        ok = cell.request(attempted)
        attempted += 1
        if ok:
            done_candles += cell.candles()
        else:
            failed += 1
        t = time.perf_counter()
        request_ms.append((t - now) * 1e3)
        now = t
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    if tracer is not None:
        tracer.close()
    return {"attempted": attempted, "failed": failed, "window_s": elapsed,
            "request_ms": request_ms,
            "end_to_end": {"candles_per_s": done_candles / elapsed}}


def control_numbers(cell: Cell) -> dict:
    """The judgement's numbers for request 0 of ``cell`` (not set up:
    nothing of the program runs) with the reference in bfloat16 in the
    program's place: its walk of the sampled strategies over the cell's
    streams, and their metrics."""
    streams, _ = judge.reference_streams(cell.raw)
    stops, targets = judge.stops_from_uniforms(cell.uniforms(seed_of(cell.seed, 3, 0)))
    rng = np.random.default_rng(seed_of(cell.seed, 4))
    n = min(int(cell.traffic["check_strategies"]), cell.B)
    rows = sorted(rng.choice(cell.B, size=n, replace=False).tolist())
    gate = ref_sig.entry_gate(streams["signal"], streams["strength"])
    stats = {k: np.full(cell.B, np.nan) for k in ref_replay.FIELDS_F + ref_replay.FIELDS_I}
    for b in rows:
        walked = ref_replay.walk(streams["close"], gate, streams["volatility"], streams["volume"],
                                 stops[b], targets[b], fmt="bf16")
        for k, v in walked.items():
            stats[k][b] = float(v)
    numbers = judge.replay_numbers(streams, stops, targets, stats, rows)

    sub = {k: v[rows] for k, v in stats.items()}
    sub["initial_balance"] = np.full(len(rows), ref_replay.INITIAL_BALANCE)
    ints = set(ref_replay.FIELDS_I)
    low = {k: (v.astype(np.int64) if k in ints else BF16(v)) for k, v in sub.items()}
    control = {k: np.asarray(v, np.float64) for k, v in ref_metrics.metric_suite(low).items()}
    numbers.update(judge.metric_numbers(sub, control))
    return numbers
