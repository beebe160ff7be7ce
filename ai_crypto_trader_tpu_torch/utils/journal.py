"""Append-only, checksummed JSONL write-ahead journal, and the array
packing of snapshots.

The port's own copy of `ai_crypto_trader_tpu/utils/journal.py` (pure
Python and NumPy).  The file format is the JAX package's, byte for byte,
so a journal that either package writes replays in the other:

  * every record is one JSON line ``{"seq", "t", "kind", "data", "crc"}``
    where ``crc`` is the CRC-32 of the canonical encoding of the other
    fields — a torn or bit-rotted line is detected, not trusted;
  * appends are buffered and fsync'd in batches (``fsync_every``);
    records that must be durable before the next side effect pass
    ``flush=True``;
  * replay is torn-tail tolerant: a truncated/corrupt FINAL line is the
    signature of a crash mid-append and is dropped silently; a corrupt
    line in the middle of the file is skipped and counted
    (``corrupt_records``);
  * ``compact(snapshot)`` rewrites the file as a single ``snapshot``
    record (atomic via temp-file + ``os.replace``), bounding replay time;
  * `SnapshotJournal` / `load_snapshot`: periodic full-state snapshots in
    that record format ("newest complete snapshot wins"), bounded by
    compaction — the PBT trainer's checkpoints (`rl.trainer_service`);
  * `pack_array` / `unpack_array`: a NumPy array as a JSON-able record
    with a CRC-32 over its raw bytes.
"""

from __future__ import annotations

import base64
import json
import os
import time
import zlib
from typing import Any, Callable

import numpy as np


def _crc(seq: int, kind: str, data: Any) -> int:
    payload = json.dumps([seq, kind, data], sort_keys=True,
                         separators=(",", ":"), default=str)
    return zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF


# --- array packing (fleet snapshots) ----------------------------------------

def pack_array(a) -> dict:
    """Pack a numpy array into a JSON-able record with its OWN checksum
    over the raw bytes — the record-level CRC covers the JSON text, this
    one covers the decoded buffer, so a bad base64 round-trip (or an
    encoding bug) is caught at unpack, not traded on.  Used by the fleet
    snapshot (`TenantEngine.snapshot`: [N]/[N,S] lane mirrors as WAL
    snapshot payloads) and the PBT trainer's checkpoints."""
    a = np.ascontiguousarray(a)
    raw = a.tobytes()
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(raw).decode("ascii"),
        "crc": zlib.crc32(raw) & 0xFFFFFFFF,
    }


def unpack_array(obj: dict):
    """Inverse of :func:`pack_array`; raises ``ValueError`` on checksum
    or shape mismatch — a corrupt array never silently becomes state."""
    raw = base64.b64decode(obj["data"])
    if (zlib.crc32(raw) & 0xFFFFFFFF) != int(obj["crc"]):
        raise ValueError("packed array crc mismatch")
    a = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
    a = a.reshape([int(d) for d in obj["shape"]])
    # frombuffer views are read-only; mirrors must stay mutable
    return np.array(a)


class JournalCorrupt(RuntimeError):
    """Raised only on structural impossibilities (e.g. the file is a
    directory) — ordinary torn/corrupt records never raise."""


def replay(path: str) -> tuple[list[dict], dict]:
    """Read every verifiable record from ``path``.

    Returns ``(records, stats)`` where stats counts what was seen:
    ``{"total_lines", "replayed", "corrupt_records", "torn_tail"}``.
    Missing file → ``([], zeroed stats)`` — a fresh start is not an error.
    """
    stats = {"total_lines": 0, "replayed": 0, "corrupt_records": 0,
             "torn_tail": False}
    if not os.path.exists(path):
        return [], stats
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    # a file not ending in \n has a torn final fragment by construction
    records: list[dict] = []
    n = len(lines)
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        stats["total_lines"] += 1
        is_last = i >= n - 2          # final content line (file ends "…\n")
        try:
            rec = json.loads(line.decode("utf-8"))
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
            if _crc(rec["seq"], rec["kind"], rec["data"]) != rec["crc"]:
                raise ValueError("crc mismatch")
        except Exception:                            # noqa: BLE001
            if is_last:
                # torn tail: the crash happened mid-append; everything
                # before this line is intact and trustworthy
                stats["torn_tail"] = True
            else:
                stats["corrupt_records"] += 1
            continue
        records.append(rec)
        stats["replayed"] += 1
    return records, stats


class WriteAheadJournal:
    """One journal file. Not thread-safe (the system is single-loop)."""

    def __init__(self, path: str, fsync_every: int = 8,
                 now_fn: Callable[[], float] = time.time):
        self.path = path
        self.fsync_every = max(int(fsync_every), 1)
        self.now_fn = now_fn
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        existing, self.replay_stats = replay(path)
        self.seq = max((r["seq"] for r in existing), default=0)
        # kept for recovery: recover_from_journal() reuses this instead of
        # re-reading the file when nothing has been appended since open
        self.initial_records = existing
        if self.replay_stats["torn_tail"]:
            # drop the torn fragment so the next append starts on a clean
            # line boundary (appending after a partial line would corrupt
            # the NEXT record too)
            self._truncate_to_clean_tail()
        self._f = open(path, "a", encoding="utf-8")
        # Records buffer HERE (not in the file object) until flush: the
        # batch that a crash loses is exactly this list, which makes the
        # chaos harness's simulated kill bit-accurate and deterministic.
        self._buf: list[str] = []
        self._closed = False

    def _truncate_to_clean_tail(self) -> None:
        with open(self.path, "rb") as f:
            raw = f.read()
        cut = raw.rfind(b"\n")
        keep = raw[: cut + 1] if cut >= 0 else b""
        with open(self.path, "wb") as f:
            f.write(keep)
            f.flush()
            os.fsync(f.fileno())

    # --- writing -----------------------------------------------------------
    def append(self, kind: str, data: Any, flush: bool = False) -> int:
        """Append one record; returns its sequence number.  ``flush=True``
        forces write-through + fsync before returning — the WAL property
        for records that must survive a crash occurring immediately after
        (order intents)."""
        self.seq += 1
        rec = {"seq": self.seq, "t": self.now_fn(), "kind": kind,
               "data": data, "crc": _crc(self.seq, kind, data)}
        self._buf.append(json.dumps(rec, default=str) + "\n")
        if flush or len(self._buf) >= self.fsync_every:
            self.flush()
        return self.seq

    def flush(self) -> None:
        if self._closed:
            return
        if self._buf:
            self._f.write("".join(self._buf))
            self._buf.clear()
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._f.close()
            self._closed = True

    # --- snapshot + compaction --------------------------------------------
    def compact(self, snapshot: Any) -> None:
        """Atomically replace the journal with one ``snapshot`` record
        (sequence numbering continues, so later records still order after
        it).  Called after recovery and periodically by the executor so
        replay cost stays bounded by live state size, not history."""
        self.flush()
        self.initial_records = None        # stale once history is rewritten
        self.seq += 1
        rec = {"seq": self.seq, "t": self.now_fn(), "kind": "snapshot",
               "data": snapshot, "crc": _crc(self.seq, "snapshot", snapshot)}
        tmp = self.path + ".compact"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")

    # --- test/chaos seam ---------------------------------------------------
    def simulate_crash(self, torn_tail_bytes: int = 0) -> None:
        """Die without flushing: buffered records are lost (what the OS
        sees when the process is killed between fsync batches).  With
        ``torn_tail_bytes`` > 0, additionally write that many bytes of the
        FIRST buffered record before dying — the torn-tail signature of a
        crash mid-``write(2)`` that replay must tolerate."""
        if torn_tail_bytes > 0 and self._buf:
            self._f.write(self._buf[0][:torn_tail_bytes])
            self._f.flush()
        self._buf.clear()
        self._f.close()
        self._closed = True


# --- fleet state snapshots ---------------------------------------------------

#: record kind for fleet-state snapshots in the WAL
FLEET_SNAPSHOT_KIND = "fleet_state"


class SnapshotJournal:
    """Periodic full-state snapshots in the WAL record format, bounded by
    compaction.

    The executor's journal is an EVENT log (order intents replay); the
    vmapped fleet's `[N]` lane mirror is a STATE blob — replaying events
    per lane would cost O(history), and the mirror already rides the one
    per-decide `host_read`, so the durable form is "newest complete
    snapshot wins".  Each ``write(payload)`` appends one flushed
    ``fleet_state`` record (torn tails and bit rot are caught by the
    line CRC + per-array CRCs) and every ``compact_every`` writes the
    file compacts down to the single newest record — the journal stays
    O(one snapshot), never O(uptime).
    """

    def __init__(self, path: str, compact_every: int = 8,
                 now_fn: Callable[[], float] = time.time,
                 kind: str = FLEET_SNAPSHOT_KIND):
        # ``kind`` names the snapshot stream: the tenant fleet writes
        # `fleet_state`, the PBT trainer writes `pbt_lineage` — distinct
        # kinds keep `load_snapshot(path, kind=...)` from resurrecting
        # the wrong state family out of a misrouted path
        self.journal = WriteAheadJournal(path, now_fn=now_fn)
        self.compact_every = max(int(compact_every), 1)
        self.kind = str(kind)
        self.writes = 0

    @property
    def path(self) -> str:
        return self.journal.path

    def write(self, payload: Any) -> int:
        """Durably record one snapshot (flushed + fsync'd before
        returning — a snapshot that might be torn is worthless) and
        compact when due.  Returns the record's sequence number."""
        seq = self.journal.append(self.kind, payload, flush=True)
        self.writes += 1
        if self.writes % self.compact_every == 0:
            self.journal.compact(payload)
        return seq

    def close(self) -> None:
        self.journal.close()


def load_snapshot(path: str,
                  kind: str = FLEET_SNAPSHOT_KIND) -> tuple[Any, dict]:
    """Newest complete snapshot record from ``path`` (torn-tail
    tolerant: a crash mid-snapshot-append falls back to the previous
    intact one).  Accepts both live ``fleet_state`` records and the
    post-compaction ``snapshot`` record.  Returns ``(payload | None,
    replay stats)``."""
    records, stats = replay(path)
    for rec in reversed(records):
        if rec.get("kind") in (kind, "snapshot"):
            return rec["data"], stats
    return None, stats
