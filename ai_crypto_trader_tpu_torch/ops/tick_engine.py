"""Fused live-tick engine: one device program per poll for the whole universe.

Port of `ai_crypto_trader_tpu/ops/tick_engine.py`.  Each poll of the
monitor turns the candle windows of every (symbol, frame) lane into the
last-candle feature table the analyzer and executor read:

  * a **device-resident ring buffer** [S, F, T + 1, 5] of OHLCV rows,
    preallocated and updated in place.  Per tick the host uploads only the
    new or changed rows through a scatter list of fixed capacity; window
    order lives in a per-(s, f) base pointer, so a window that advanced by
    k candles costs k row writes.  Slot T of each lane is a spare that
    takes the unused entries of the scatter list and is never read (the
    JAX program drops them with ``mode="drop"``, which has no torch
    counterpart; a boolean mask would read back to the host);
  * **the tick program** (`_tick_program`): scatter the rows, gather the
    time-ordered windows, then indicators (two launches of the fused-EWMA
    kernel on the card) → signal features → reference signal → volume
    profile → the 15 combination families (one more launch, for
    ``rsi(close, 7)``) → confluence → drift histograms and PSI, for every
    lane at once.  Warm-up is a ``valid`` mask: cold lanes read NaN (0 for
    the int fields), so the shapes never change;
  * **one** `host_read`: every output leaf is packed into one float32
    tensor on the device, copied once into pinned host memory, and
    unpacked into NumPy with the JAX package's dtypes and shapes (the two
    int32 fields are small, so float32 carries them exactly).

Nothing else in `step()` synchronizes with the card: the scatter list, the
base pointers and the valid mask go up from pinned staging buffers with
``non_blocking=True``, and no value is read back before the one read.

``pipelined=True`` is the double-buffered path: two rings alternate, each
poll's row writes fan into both buffers' pending maps, and `step()`
dispatches tick T, enqueues its read-back copy, records an event and
returns tick T−1's output (None on the first tick) — so the read-back of
T overlaps the host's work until the next poll.  Each ring has its own
pinned staging and output buffers, so no host buffer is written while a
copy from or into it is in flight.  A failed dispatch or drain drops
everything in flight and re-seeds both rings from the host mirror.

Symbol count pads up to a power of two (at least 8) and frame count up to
4, as in the JAX package, so nearby universe sizes share shapes; padded
lanes are invalid.

While `obs.tickpath` is active the step feeds its phases as the JAX step
does: ``scatter_build``, ``dispatch``, ``device_compute``, ``host_read``,
the overlap headroom and (pipelined) the reclaimed overlap, and its first
dispatch opens the cold-start window.  ``device_compute`` is the program's
span on the card between two CUDA events recorded around it, read after
the step's one host read has waited for the copy behind them — no second
synchronizing call (on the CPU, where the program runs inside the
dispatch, it is 0).  The overlap headroom is the host's wait in that read.
With `utils.devprof` active the first dispatch takes the ``tick_engine``
cost card and the ring's donation check (the ring is updated in place: it
must still be the same storage after the dispatch; in pipelined mode each
ring's first dispatch is checked).  With `utils.meshprof` active the
dispatch through the one host read runs in a ``tick_engine`` watch window
(kernel builds attributed, synchronizing calls refused and counted); the
read itself is the sanctioned one (`host_read`), timed into the
``host_read`` SLO.  With `utils.tracing` active the step opens
``tick.stage`` (the scatter list built and its uploads started; attributes
``rows``, ``bytes``), ``tick.dispatch`` (the program's enqueue;
``k2_launches``, the fused-EWMA launches it made, and ``device_ms`` from
the same two timing events) and ``tick.read`` (the one read; ``wait_s``,
its wait on the card); in pipelined mode ``tick.read`` is the drain's.
Off, each is one module-global check.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.signals import (
    compute_signal_features,
    reference_signal,
)
from ai_crypto_trader_tpu_torch.device import canonical_precision, div_const, resolve_device
from ai_crypto_trader_tpu_torch.obs import tickpath
from ai_crypto_trader_tpu_torch.obs.drift import DRIFT_FEATURES, N_BINS, PSI_EPS
from ai_crypto_trader_tpu_torch.ops import ewma
from ai_crypto_trader_tpu_torch.ops.combinations import (
    combination_signal,
    combined_indicators,
)
from ai_crypto_trader_tpu_torch.ops.indicators import compute_indicators
from ai_crypto_trader_tpu_torch.ops.volume_profile import volume_profile
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof, tracing

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int8: np.int8, torch.bool: np.bool_}


class Readback:
    """One tick's packed output on its way to the host: the host buffer
    its copy lands in, the event recorded after that copy (None on the
    CPU, where the copy is done when enqueued), and the layout that unpacks
    it.  ``wait_s`` is what `host_read` spent waiting on the event.
    ``span`` is None or two timing events around the program, recorded
    before ``event``: once `host_read` has waited, `device_s` reads the
    program's time on the card without another sync."""

    def __init__(self, host, event, layout):
        self.host, self.event, self.layout = host, event, layout
        self.wait_s = 0.0
        self.span = None

    def device_s(self) -> float:
        """The program's span on the card in seconds (0 without events)."""
        if self.span is None:
            return 0.0
        return self.span[0].elapsed_time(self.span[1]) / 1e3


def host_read(readback: Readback) -> dict:
    """THE per-poll device→host sync: wait for the tick's one copy into
    pinned memory, then unpack it into a dict of NumPy arrays (a nested
    ``combo`` dict among them) with the JAX package's dtypes and shapes.

    A module-level seam, so tests can wrap it with a counting double and
    assert one read per poll.  The read is timed into the ``host_read``
    SLO window (utils/devprof.py) and is the sanctioned sync of a meshprof
    watch window."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():   # THE sanctioned device→host sync
        out = read_packed(readback)
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


def stage(packed: torch.Tensor, layout) -> Readback:
    """``packed`` (a float32 tensor) on its way to the host: on the card one
    non-blocking copy into a fresh pinned buffer with an event recorded
    after it; on the CPU the tensor itself."""
    if packed.device.type != "cuda":
        return Readback(packed, None, layout)
    host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Readback(host, event, layout)


def stage_bytes(tensors: dict) -> Readback:
    """``tensors`` ({name: tensor}, any dtypes, all on one device) on their
    way to the host as ONE copy of their raw bytes, concatenated: `stage`
    for values that float32 does not carry exactly (a checkpoint's
    parameters, int64 indices, generator states).  `read_packed` gives
    each back bit for bit with its dtype and shape."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors.values()])
    layout = [(name, tuple(t.shape), torch.empty((), dtype=t.dtype).numpy().dtype)
              for name, t in tensors.items()]
    if flat.device.type != "cuda":
        return Readback(flat, None, layout)
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Readback(host, event, layout)


def read_packed(readback: Readback) -> dict:
    """Wait for ``readback``'s copy and unpack it: the body of the tick
    engine's and the tenant engine's `host_read` seams.  A leaf named
    ``group/leaf`` lands in ``out[group][leaf]``; every value float32
    carries must be exact in it (small integers, booleans).  A byte pack
    (`stage_bytes`) unpacks to each leaf's own dtype, bit for bit."""
    t0 = time.perf_counter()
    if readback.event is not None:
        readback.event.synchronize()
    readback.wait_s = time.perf_counter() - t0
    flat = readback.host.numpy()
    raw = flat.dtype == np.uint8
    out, i = {}, 0
    for name, shape, dtype in readback.layout:
        n = math.prod(shape)
        if raw:
            n *= np.dtype(dtype).itemsize
            value = np.frombuffer(flat[i:i + n].tobytes(), dtype).reshape(shape).copy()
        else:
            value = flat[i:i + n].reshape(shape).astype(dtype)   # a copy
        i += n
        group, _, leaf = name.rpartition("/")
        (out.setdefault(group, {}) if group else out)[leaf] = value
    return out


def _pad_symbols(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _pad_frames(n: int) -> int:
    return max(n, 4)


def _drift_hist(x, lo, hi):
    """[..., T] feature series → [..., N_BINS] window histogram
    probabilities against the fixed edges (obs/drift.py spec).  NaNs
    (warm-up lanes) land in bin 0; those lanes are masked invalid."""
    T = x.shape[-1]
    idx = torch.clamp(div_const(x - lo, hi - lo) * N_BINS, 0, N_BINS - 1)
    idx = torch.nan_to_num(idx).to(torch.int32)
    onehot = idx[..., None] == torch.arange(N_BINS, dtype=torch.int32, device=x.device)
    return div_const(onehot.sum(-2).to(torch.float32), float(T))


def _tick_program(ring, base, rows, flat_ix, valid, drift_ref) -> dict:
    """Scatter the row updates into ``ring`` (in place), then compute the
    whole last-candle feature table for every (symbol, frame) lane.

    ring      [S, F, T + 1, 5]  the candle ring; slot T is the spare
    base      [S, F] int64      window index i lives at ring slot (base + i) % T
    rows      [W, 5]            new/changed candle rows (W = fixed capacity)
    flat_ix   [W] int64         row index of each write in ring.view(-1, 5);
                                unused entries point at lane (0, 0)'s slot T
    valid     [S, F] bool       warm lanes; cold lanes read NaN (int fields 0)
    drift_ref [S, F, K, N_BINS] per-feature reference histograms
    """
    S, F, T1, _ = ring.shape
    T = T1 - 1
    dev = ring.device
    ring.view(-1, 5).index_copy_(0, flat_ix, rows)
    idx = torch.remainder(base[:, :, None] + torch.arange(T, device=dev), T)
    win = ring[:, :, :T].gather(2, idx[..., None].expand(S, F, T, 5))
    ohlcv = dict(zip(("open", "high", "low", "close", "volume"),
                     win.permute(3, 0, 1, 2).contiguous().unbind(0)))

    ind = compute_indicators(ohlcv, device=dev)
    feats = compute_signal_features(ind)
    signal, strength = reference_signal(feats)
    vp = volume_profile(ohlcv["high"], ohlcv["low"], ohlcv["close"], ohlcv["volume"])
    combos = combined_indicators(ind)
    confluence = combination_signal(combos)
    close = ohlcv["close"]

    # drift: per-feature window histograms + PSI against drift_ref
    drift_series = {
        "rsi": ind["rsi"],
        "stoch_k": ind["stoch_k"],
        "bb_position": ind["bb_position"],
        "macd_norm": torch.where(close != 0.0, ind["macd"] / close, 0.0),
        "volatility": feats.volatility,
    }
    live_hist = torch.stack([_drift_hist(drift_series[name], lo, hi)
                             for name, lo, hi in DRIFT_FEATURES], dim=-2)
    p = live_hist + PSI_EPS
    q = drift_ref + PSI_EPS
    drift_psi = ((p - q) * torch.log(p / q)).sum(-1)

    def chg(n):
        # windows shorter than n → 0.0, as the host-side chg()
        if T <= n:
            return torch.zeros(close.shape[:-1], dtype=close.dtype, device=dev)
        prev = close[..., -1 - n]
        return (close[..., -1] - prev) / prev * 100.0

    fm = lambda x: torch.where(valid, x, math.nan)                   # noqa: E731
    im = lambda x: torch.where(valid, x, 0).to(torch.int32)          # noqa: E731
    return {
        "current_price": fm(close[..., -1]),
        "rsi": fm(ind["rsi"][..., -1]),
        "stoch_k": fm(ind["stoch_k"][..., -1]),
        "macd": fm(ind["macd"][..., -1]),
        "williams_r": fm(ind["williams_r"][..., -1]),
        "bb_position": fm(ind["bb_position"][..., -1]),
        "atr": fm(ind["atr"][..., -1]),
        "volatility": fm(feats.volatility[..., -1]),
        "trend": im(feats.trend[..., -1]),
        "trend_strength": fm(feats.trend_strength[..., -1]),
        "avg_volume": fm(feats.volume[..., -1]),
        "signal": im(signal[..., -1]),
        "signal_strength": fm(strength[..., -1]),
        "chg_1": fm(chg(1)), "chg_3": fm(chg(3)),
        "chg_5": fm(chg(5)), "chg_15": fm(chg(15)),
        "poc_price": fm(vp["poc_price"]),
        "value_area_low": fm(vp["value_area_low"]),
        "value_area_high": fm(vp["value_area_high"]),
        "confluence": fm(confluence[..., -1]),
        "combo": {k: fm(v[..., -1]) for k, v in combos.items()},
        # popped by step() into last_drift, never part of the feature table
        "drift_psi": torch.where(valid[..., None], drift_psi, math.nan),
        "drift_hist": live_hist,
    }


def _pack(out: dict):
    """The output dict as one float32 tensor, and the layout that unpacks
    it: [(name, shape, numpy dtype)], ``combo/<family>`` for the nested
    leaves."""
    leaves = [(k, v) for k, v in out.items() if k != "combo"]
    leaves += [("combo/" + k, v) for k, v in out["combo"].items()]
    flat = torch.cat([v.reshape(-1).to(torch.float32) for _, v in leaves])
    return flat, [(k, tuple(v.shape), _NP_DTYPES[v.dtype]) for k, v in leaves]


class TickEngine:
    """The host side of the tick program: kline diffing, the ring
    mirrors, and the one-program / one-read step.

    ``ingest(symbol, interval, klines)`` queues the delta between the new
    window and the ring (typically 1-2 rows: the freshly closed candle and
    the updated in-progress bar).  A lane whose delta exceeds ``max_new``
    rows (cold start, reconnect gap, venue correction storm) is re-seeded:
    the whole ring uploads once.  ``step()`` then runs the program over
    every lane and reads the host once.

    ``pipelined=True`` switches to the double-buffered path (module
    docstring): ``step()`` returns tick T−1's output, ``flush()`` drains
    the last one.

    ``precision`` takes the JAX package's matmul-precision vocabulary
    (`device.PRECISIONS`; an unknown name raises ``ValueError``).  The tick
    program has no matrix product, so no value changes with it.

    ``device=None`` means the CUDA card (``RuntimeError`` without one);
    ``device="cpu"`` runs the program with the kernels' plain versions.
    """

    def __init__(self, symbols, intervals, window: int = 256,
                 max_new: int = 8, pipelined: bool = False,
                 precision: str | None = None, device=None):
        self.symbols = list(symbols)
        self.intervals = tuple(intervals)
        self.window = int(window)
        self.max_new = int(max_new)
        self.pipelined = bool(pipelined)
        canonical_precision(precision)         # validate eagerly, fail loud
        self.precision = precision
        self.device = resolve_device(device)
        self.sym_index = {s: i for i, s in enumerate(self.symbols)}
        self.iv_index = {iv: i for i, iv in enumerate(self.intervals)}
        S = _pad_symbols(len(self.symbols))
        F = _pad_frames(len(self.intervals))
        T = self.window
        # time-ordered window mirror + timestamps (diffing) and the
        # ring-layout mirror (reseed source; always current)
        self._win = np.zeros((S, F, T, 5), np.float32)
        self._ts = np.zeros((S, F, T), np.int64)
        self._ring_np = np.zeros((S, F, T, 5), np.float32)
        self._base = np.zeros((S, F), np.int32)
        self._count = np.zeros((S, F), np.int32)
        # drift reference histograms (obs/drift.py): uniform until a
        # training-time reference is installed (set_drift_reference) or the
        # first full window is captured per lane; uploaded when one changes
        K, B = len(DRIFT_FEATURES), N_BINS
        self._drift_ref_np = np.full((S, F, K, B), 1.0 / B, np.float32)
        self._drift_ref_set = np.zeros((S, F), bool)
        self._drift_ref = None                 # device copy
        self.drift_ref_uploads = 0
        self.last_drift: dict = {}
        # queued writes this poll, keyed (s, f, pos): a second ingest of the
        # same slot between steps overwrites rather than duplicates, so the
        # scatter list never holds one slot twice
        self._pending: dict = {}
        self._need_seed = True
        # per-lane stream-sync flag: True iff every row offered to this lane
        # since its last full-window ingest() was applied
        self._synced = np.zeros((S, F), bool)
        # device rings (serial: index 0 only), their pending maps (pipelined),
        # pinned staging and output buffers per ring, the shared device
        # copies of the scatter list, base pointers and valid mask
        self._bufs: list = [None, None]
        self._buf_pending: list[dict] = [{}, {}]
        self._staging: list = [None, None]
        self._out_host: list = [None, None]
        self._dev_in = None
        self._donation_checked = [False, False]
        self._cur = 0
        self._inflight: dict | None = None
        self.dispatch_count = 0
        self.full_seeds = 0
        self.last_valid = np.zeros((S, F), bool)
        self.last_stats: dict = {}
        self.last_out: dict | None = None   # newest host output dict
        # newest venue event time (ms) per symbol
        self.last_event_ms: dict[str, float] = {}

    # -- ingest ---------------------------------------------------------------
    def _seed_slot(self, s: int, f: int, ts: np.ndarray, arr: np.ndarray):
        self._win[s, f] = arr
        self._ts[s, f] = ts
        self._base[s, f] = 0
        self._ring_np[s, f] = arr
        self._count[s, f] = self.window
        self._need_seed = True
        self.full_seeds += 1
        # queued incremental writes for this slot are superseded
        self._pending = {k: v for k, v in self._pending.items()
                         if not (k[0] == s and k[1] == f)}

    def note_event_ms(self, symbol: str, event_ms: float) -> None:
        """Record a fresher venue event time for ``symbol`` (monotone max)."""
        if event_ms > self.last_event_ms.get(symbol, 0.0):
            self.last_event_ms[symbol] = float(event_ms)

    # -- drift reference ------------------------------------------------------
    def set_drift_reference(self, symbol: str, interval: str,
                            probs: np.ndarray) -> None:
        """Install training-time reference stats ([K, N_BINS] probabilities,
        obs/drift.reference_histogram) for one (symbol, interval) lane: one
        upload per change."""
        s = self.sym_index[symbol]
        f = self.iv_index[interval]
        self._drift_ref_np[s, f] = np.asarray(probs, np.float32)
        self._drift_ref_set[s, f] = True
        self._upload_drift_ref()
        self.drift_ref_uploads += 1

    def ingest_row(self, symbol: str, interval: str, row: list) -> bool:
        """Streamed-row upload seam: apply ONE candle row to a warm lane.

        Returns True when applied (in-progress-bar replacement, or an
        append that advances the ring by exactly one candle).  False means
        the caller must seed or backfill the lane through the full-window
        ``ingest``: lane still warming, timestamp gap, or an out-of-order
        row — a streamed row never tears the ring."""
        s = self.sym_index.get(symbol)
        f = self.iv_index.get(interval)
        if s is None or f is None:
            return False
        self.note_event_ms(symbol, float(row[0]))
        T = self.window
        if self._count[s, f] < T:
            return False                       # warming: needs a full seed
        ts = int(row[0])
        arr = np.asarray(row[1:6], np.float32)
        tail = self._ts[s, f]
        if ts == int(tail[-1]):                # in-progress bar update
            if np.array_equal(self._win[s, f, -1], arr):
                return True                    # exact duplicate: no write
            self._win[s, f, -1] = arr
            pos = (int(self._base[s, f]) + T - 1) % T
        elif ts > int(tail[-1]):
            step = int(tail[-1] - tail[-2]) if T >= 2 else 0
            if step <= 0 or ts != int(tail[-1]) + step:
                self._synced[s, f] = False     # gap/misalignment: re-seed
                return False
            self._ts[s, f] = np.roll(tail, -1)
            self._ts[s, f, -1] = ts
            self._win[s, f] = np.roll(self._win[s, f], -1, axis=0)
            self._win[s, f, -1] = arr
            base = (int(self._base[s, f]) + 1) % T
            self._base[s, f] = base
            pos = (base + T - 1) % T
        else:
            self._synced[s, f] = False         # older than the window tail
            return False
        self._ring_np[s, f, pos] = arr
        self._pending[(s, f, pos)] = arr       # latest write wins
        return True

    def ingest(self, symbol: str, interval: str, klines: list) -> None:
        """Diff one (symbol, frame) kline window against the ring and queue
        only the new/changed rows for the next step()."""
        s = self.sym_index[symbol]
        f = self.iv_index[interval]
        if klines:
            self.note_event_ms(symbol, float(klines[-1][0]))
        T = self.window
        rows = klines[-T:]
        if len(rows) < T:
            self._count[s, f] = len(rows)      # warming: lane stays invalid
            self._synced[s, f] = False
            return
        arr = np.asarray([r[1:6] for r in rows], np.float32)
        ts = np.asarray([int(r[0]) for r in rows], np.int64)
        if self._count[s, f] < T:
            self._seed_slot(s, f, ts, arr)     # warming → full transition
            self._synced[s, f] = True
            return
        old_ts = self._ts[s, f]
        j = int(np.searchsorted(old_ts, ts[0]))
        if j >= T or old_ts[j] != ts[0] \
                or not np.array_equal(old_ts[j:], ts[:T - j]):
            self._seed_slot(s, f, ts, arr)     # gap/misalignment: re-seed
            self._synced[s, f] = True
            return
        k = j                                  # window advanced by k candles
        changed = np.flatnonzero(
            (arr[:T - k] != self._win[s, f, k:]).any(axis=1))
        writes = list(changed) + list(range(T - k, T))
        if len(writes) > self.max_new:
            self._seed_slot(s, f, ts, arr)
            self._synced[s, f] = True
            return
        base = (int(self._base[s, f]) + k) % T
        self._base[s, f] = base
        for i in writes:
            pos = (base + i) % T
            self._ring_np[s, f, pos] = arr[i]
            self._pending[(s, f, pos)] = arr[i]   # latest write wins
        self._win[s, f] = arr
        self._ts[s, f] = ts
        self._synced[s, f] = True

    @property
    def queued_rows(self) -> int:
        """Row writes queued for the next step."""
        return len(self._pending)

    def lane_synced(self, symbol: str, interval: str) -> bool:
        """True iff this lane's window already reflects every row offered
        since its last full ingest — a full-window re-ingest of the same
        source would be a zero-change diff."""
        s = self.sym_index.get(symbol)
        f = self.iv_index.get(interval)
        if s is None or f is None:
            return False
        return bool(self._synced[s, f]) \
            and int(self._count[s, f]) >= self.window

    # -- device buffers -------------------------------------------------------
    def _upload(self, dst, arr: np.ndarray) -> None:
        """Copy a host array into ``dst`` without a sync: on the card from
        a fresh pinned copy (the host allocator keeps it until the copy
        is done)."""
        src = torch.from_numpy(arr)
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _upload_drift_ref(self) -> None:
        if self._drift_ref is None:
            self._drift_ref = torch.empty(self._drift_ref_np.shape, dtype=torch.float32,
                                          device=self.device)
        self._upload(self._drift_ref, self._drift_ref_np)

    def _seed_ring(self, i: int) -> None:
        """Ring ``i`` (allocated on first use) from the host mirror."""
        S, F, T = self._ring_np.shape[:3]
        if self._bufs[i] is None:
            self._bufs[i] = torch.zeros((S, F, T + 1, 5), dtype=torch.float32,
                                        device=self.device)
        self._upload(self._bufs[i][:, :, :T], self._ring_np)

    def _scatter_capacity(self) -> int:
        """Scatter-list capacity W.  A pipelined ring dispatches every other
        tick, so it accumulates up to two polls of row writes."""
        S, F = self._ring_np.shape[:2]
        return S * F * self.max_new * (2 if self.pipelined else 1)

    def _stage(self, i: int, pending: dict, W: int) -> int:
        """Fill ring ``i``'s staging with the scatter list of ``pending``,
        the base pointers and the valid mask, and start their uploads.
        Returns the scatter list's bytes."""
        S, F, T = self._ring_np.shape[:3]
        pin = self.device.type == "cuda"
        if self._staging[i] is None:
            make = lambda shape, dtype: torch.empty(shape, dtype=dtype, pin_memory=pin)  # noqa: E731
            self._staging[i] = (make((W, 5), torch.float32), make((W,), torch.int64),
                                make((S, F), torch.int64), make((S, F), torch.bool))
        if self._dev_in is None:
            self._dev_in = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                                 for t in self._staging[i])
        rows, flat, base, valid = (t.numpy() for t in self._staging[i])
        n = len(pending)
        rows[n:] = 0.0
        flat[n:] = T                           # lane (0, 0)'s spare slot T
        if n:
            key = np.asarray(list(pending), np.int64)
            rows[:n] = np.stack(list(pending.values()))
            flat[:n] = (key[:, 0] * F + key[:, 1]) * (T + 1) + key[:, 2]
        base[:] = self._base
        valid[:] = self._count >= T
        for dst, src in zip(self._dev_in, self._staging[i]):
            dst.copy_(src, non_blocking=True)
        return rows.nbytes + flat.nbytes

    def _dispatch(self, i: int, timed: bool = False) -> Readback:
        """The tick program on ring ``i``, its output packed and its copy to
        ring ``i``'s host buffer enqueued.  ``timed`` (on the card) records
        two timing events around the program (`Readback.span`)."""
        rows, flat, base, valid = self._dev_in
        span = None
        if timed and self.device.type == "cuda":
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
        args = (self._bufs[i], base, rows, flat, valid, self._drift_ref)
        with devprof.carding("tick_engine", args, inplace=args[:1]) as card:
            out = card.result(_tick_program(*args))
        packed, layout = _pack(out)
        if self.device.type != "cuda":
            return Readback(packed, None, layout)
        if span is not None:
            span[1].record()
        if self._out_host[i] is None or self._out_host[i].shape != packed.shape:
            self._out_host[i] = torch.empty(packed.shape, dtype=torch.float32,
                                            pin_memory=True)
        self._out_host[i].copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        readback = Readback(self._out_host[i], event, layout)
        readback.span = span
        return readback

    def _traced_dispatch(self, i: int, timed: bool) -> Readback:
        """`_dispatch` under the ``tick.dispatch`` span."""
        with tracing.span("tick.dispatch", service="tick") as sp:
            launches = ewma.fused_ewma.launches
            readback = self._dispatch(i, timed=timed)
            sp.set_attribute("k2_launches", ewma.fused_ewma.launches - launches)
            if readback.span is not None:
                sp.on_device(*readback.span)
        return readback

    @staticmethod
    def _traced_read(readback: Readback) -> dict:
        """`host_read` under the ``tick.read`` span."""
        with tracing.span("tick.read", service="tick") as sp:
            host = host_read(readback)
            sp.set_attribute("wait_s", readback.wait_s)
        return host

    # -- step -----------------------------------------------------------------
    def step(self) -> dict | None:
        """One program over every (symbol, frame) lane.

        Serial mode (default): dispatch + ONE host read, returning THIS
        tick's output dict.  Pipelined mode: dispatch tick T against the
        current ring, flip rings, then drain and return tick T−1's output —
        None on the first tick.  Per-step accounting lands in
        ``last_stats`` either way."""
        if self.pipelined:
            return self._step_pipelined()
        return self._step_serial()

    def _step_serial(self) -> dict:
        t_step0 = time.perf_counter()
        S, F, T = self._ring_np.shape[:3]
        W = self._scatter_capacity()
        with tracing.span("tick.stage", service="tick") as sp:
            if len(self._pending) > W:         # paranoia: spilled capacity
                self._need_seed = True
            seeded = self._bufs[0] is None or self._need_seed
            upload_bytes = 0
            if seeded:
                self._seed_ring(0)             # a transfer
                upload_bytes += self._ring_np.nbytes
                self._pending.clear()          # already inside the seed
            n_writes = len(self._pending)
            scatter_bytes = self._stage(0, self._pending, W)
            self._pending.clear()
            if not seeded:
                upload_bytes += scatter_bytes
            valid = self._count >= T
            if self._drift_ref is None:
                self._upload_drift_ref()
            sp.set_attribute("rows", n_writes)
            sp.set_attribute("bytes", upload_bytes)
        tp = tickpath.active()
        # the program's two timing events: read after the one host read
        timed = tp is not None or tracing.active() is not None
        # the ring's donation check on the first carded dispatch
        donation = (devprof.donated(inplace=self._bufs[:1])
                    if not devprof.has_card("tick_engine") else None)
        cold = self.dispatch_count == 0
        try:
            with tickpath.coldstart("tick_engine", cold=cold), \
                    meshprof.watch("tick_engine", cold=cold):
                t_d0 = time.perf_counter()
                readback = self._traced_dispatch(0, timed)
                t_d1 = time.perf_counter()
                if donation is not None:
                    devprof.verify_donation("tick_engine", donation,
                                            after=self._bufs[:1])
                self.dispatch_count += 1
                self._need_seed = False
                self.last_valid = valid
                t_hr = time.perf_counter()
                host = self._traced_read(readback)
                host_read_s = time.perf_counter() - t_hr
        except Exception:
            # a mid-step abort leaves the ring in an unknown state; the host
            # mirror is authoritative, so the next step re-seeds (from fresh
            # staging: a copy from the old one may still be pending)
            self._need_seed = True
            self._staging[0] = None
            raise
        self._pop_drift(host, valid, self._drift_ref_set.copy())
        self.last_out = host
        self.last_stats = {
            "dispatches": 1, "upload_rows": int(n_writes),
            "upload_bytes": int(upload_bytes), "full_seed": bool(seeded),
            "lanes": int(S * F), "valid_lanes": int(valid.sum()),
            "scatter_capacity": int(W), "host_read_s": host_read_s,
            "step_s": time.perf_counter() - t_step0,
        }
        if tp is not None:
            scatter_build_s = t_d0 - t_step0
            dispatch_s = t_d1 - t_d0
            device_compute_s = readback.device_s()   # after the read: no sync
            overlap_headroom_s = readback.wait_s
            self.last_stats.update({
                "scatter_build_s": scatter_build_s,
                "dispatch_s": dispatch_s,
                "device_compute_s": device_compute_s,
                "overlap_headroom_s": overlap_headroom_s,
            })
            tp.observe_phase("scatter_build", scatter_build_s)
            tp.observe_phase("dispatch", dispatch_s)
            tp.observe_phase("device_compute", device_compute_s)
            tp.observe_phase("host_read", host_read_s)
            tp.observe_overlap(overlap_headroom_s)
        return host

    def _pop_drift(self, host: dict, valid: np.ndarray,
                   ref_was_set: np.ndarray) -> None:
        """Pop the drift outputs off a drained read into ``last_drift`` and
        capture first-full-window references (one upload).  ``ref_was_set``
        is the reference state as of the dispatch that produced ``host``."""
        drift_hist = host.pop("drift_hist")
        drift_psi = host.pop("drift_psi")
        newly = valid & ~self._drift_ref_set
        if newly.any():
            self._drift_ref_np[newly] = drift_hist[newly]
            self._drift_ref_set |= valid
            self._upload_drift_ref()
            self.drift_ref_uploads += 1
        self.last_drift = {"psi": drift_psi, "hist": drift_hist,
                           "ref_set": ref_was_set}

    # -- pipelined step (double-buffered ring, async read) --------------------
    def _abort_pipeline(self) -> None:
        """Drop everything in flight and re-seed both rings from the host
        mirror on the next step (the in-flight output is discarded, never
        re-drained).  The staging buffers are dropped too: a copy from them
        may still be pending, and the pinned allocator keeps them until it
        is done."""
        self._inflight = None
        self._bufs = [None, None]
        self._staging = [None, None]
        self._out_host = [None, None]
        self._buf_pending[0].clear()
        self._buf_pending[1].clear()
        self._need_seed = True

    def _step_pipelined(self) -> dict | None:
        t_step0 = time.perf_counter()
        S, F, T = self._ring_np.shape[:3]
        W = self._scatter_capacity()
        cur = self._cur
        with tracing.span("tick.stage", service="tick") as sp:
            # fan this poll's writes into BOTH rings' pending maps (latest
            # write wins per ring slot, so merging across ticks is safe)
            if self._pending:
                self._buf_pending[0].update(self._pending)
                self._buf_pending[1].update(self._pending)
                self._pending.clear()
            if len(self._buf_pending[cur]) > W:    # paranoia: spilled capacity
                self._need_seed = True
            seeded = self._bufs[cur] is None or self._need_seed
            upload_bytes = 0
            if seeded:
                # re-seed BOTH rings: their accumulated deltas are in the seed
                self._seed_ring(0)
                self._seed_ring(1)
                upload_bytes += 2 * self._ring_np.nbytes
                self._buf_pending[0].clear()
                self._buf_pending[1].clear()
            pending = self._buf_pending[cur]
            n_writes = len(pending)
            scatter_bytes = self._stage(cur, pending, W)
            pending.clear()                    # consumed by this dispatch
            if not seeded:
                upload_bytes += scatter_bytes
            valid = self._count >= T
            if self._drift_ref is None:
                self._upload_drift_ref()
            sp.set_attribute("rows", n_writes)
            sp.set_attribute("bytes", upload_bytes)
        tp = tickpath.active()
        timed = tp is not None or tracing.active() is not None
        # each ring's donation check on its first dispatch under devprof
        donation = (devprof.donated(inplace=self._bufs[cur:cur + 1])
                    if not self._donation_checked[cur] else None)
        cold = self.dispatch_count == 0
        t_d0 = time.perf_counter()
        try:
            with tickpath.coldstart("tick_engine", cold=cold), \
                    meshprof.watch("tick_engine", cold=cold):
                readback = self._traced_dispatch(cur, timed)
                if donation is not None:
                    devprof.verify_donation("tick_engine", donation,
                                            after=self._bufs[cur:cur + 1])
                    self._donation_checked[cur] = True
        except Exception:
            self._abort_pipeline()
            raise
        t_d1 = time.perf_counter()
        self.dispatch_count += 1
        self._need_seed = False
        self._cur = 1 - cur
        if tp is not None:
            tp.observe_phase("scatter_build", t_d0 - t_step0)
            tp.observe_phase("dispatch", t_d1 - t_d0)
        prev, self._inflight = self._inflight, {
            "readback": readback, "valid": valid, "seeded": bool(seeded),
            "n_writes": int(n_writes), "upload_bytes": int(upload_bytes),
            "lanes": int(S * F), "scatter_capacity": int(W),
            "scatter_build_s": t_d0 - t_step0, "dispatch_s": t_d1 - t_d0,
            # reference state as of THIS dispatch (see _pop_drift)
            "ref_set": self._drift_ref_set.copy(),
            "t_disp_ret": t_d1,
        }
        if prev is None:
            # pipeline fill: nothing to drain yet
            self.last_stats = {
                "dispatches": 1, "upload_rows": int(n_writes),
                "upload_bytes": int(upload_bytes), "full_seed": bool(seeded),
                "lanes": int(S * F), "valid_lanes": int(valid.sum()),
                "scatter_capacity": int(W), "host_read_s": 0.0,
                "step_s": time.perf_counter() - t_step0, "inflight": True,
            }
            return None
        return self._drain(prev)

    def _drain(self, inflight: dict) -> dict:
        """Collect one in-flight dispatch's read: the async half of the
        pipelined step.  The wait inside `host_read` is the residual device
        time — what the host did since that dispatch returned overlapped
        it.  With timing events (tickpath on) ``device_compute_s`` is the
        program's span on the card, read after the wait."""
        t_drain0 = time.perf_counter()
        try:
            host = self._traced_read(inflight["readback"])
        except Exception:
            # a failed drain must not wedge the rings: drop the in-flight
            # outputs (this one AND the dispatch just issued) and re-seed
            self._abort_pipeline()
            raise
        host_read_s = time.perf_counter() - t_drain0
        readback = inflight["readback"]
        wait_s = readback.wait_s
        device_compute_s = wait_s if readback.span is None else readback.device_s()
        reclaimed_s = max(t_drain0 - inflight["t_disp_ret"], 0.0)
        valid = inflight["valid"]
        self._pop_drift(host, valid, inflight["ref_set"])
        self.last_valid = valid
        self.last_out = host
        self.last_stats = {
            "dispatches": 1, "upload_rows": inflight["n_writes"],
            "upload_bytes": inflight["upload_bytes"],
            "full_seed": inflight["seeded"], "lanes": inflight["lanes"],
            "valid_lanes": int(valid.sum()),
            "scatter_capacity": inflight["scatter_capacity"],
            "scatter_build_s": inflight["scatter_build_s"],
            "dispatch_s": inflight["dispatch_s"],
            "device_compute_s": device_compute_s,
            "overlap_headroom_s": wait_s,
            "overlap_reclaimed_s": reclaimed_s,
            "host_read_s": host_read_s,
            "step_s": time.perf_counter() - t_drain0,
        }
        tp = tickpath.active()
        if tp is not None:
            tp.observe_phase("device_compute", device_compute_s)
            tp.observe_phase("host_read", host_read_s)
            tp.observe_overlap(wait_s)
            tp.observe_reclaimed(reclaimed_s)
        return host

    def flush(self) -> dict | None:
        """Drain the in-flight dispatch, if any: the teardown and parity
        seam.  Returns the drained output, or None when nothing was in
        flight."""
        inflight, self._inflight = self._inflight, None
        if inflight is None:
            return None
        return self._drain(inflight)
