"""Structured JSON-lines logging — the aggregation-ready log story.

The reference scatters per-service rotating text logs under ``logs/`` and
ships a logstash pipeline that greps the service name back out of the
message line (`monitoring/logstash.conf`; `services/monte_carlo_service.py:
24-39`).  Here every record is born structured: one JSON object per line
with ``ts`` (epoch seconds), ``level``, ``service``, ``msg`` and arbitrary
extra fields — so the shipped pipeline (monitoring/logstash.conf) needs no
grok gymnastics, and any collector (logstash, vector, fluent-bit, plain
jq) can consume the files directly.

Size-based rotation matches the reference budget (10 MB × 5 files).

The port's own copy of `ai_crypto_trader_tpu/utils/structlog.py`, host
code, over the port's `utils.tracing` (the trace and span ids a record
carries): the same calls on the same clock write the same lines.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from ai_crypto_trader_tpu_torch.utils import tracing

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _default(value):
    """json.dumps fallback: str(), then repr() if even str() raises."""
    try:
        return str(value)
    except Exception:
        return object.__repr__(value)


def _safe_dumps(record: dict) -> str:
    """Serialize a record without ever raising mid-hot-path: non-JSON
    values fall back to str()/repr(), and pathological records (circular
    refs, str() that raises) degrade field-by-field rather than dropping
    the whole line."""
    try:
        return json.dumps(record, default=_default)
    except Exception:
        safe = {}
        for k, v in record.items():
            try:
                json.dumps(v, default=_default)
                safe[k] = v
            except Exception:
                safe[k] = object.__repr__(v)
        return json.dumps(safe, default=_default)


@dataclass
class StructuredLogger:
    service: str
    path: str | None = None            # None → stderr only
    max_bytes: int = 10 * 1024 * 1024
    backup_count: int = 5
    min_level: str = "info"
    now_fn: any = time.time
    echo: bool = False                 # also print to stderr
    _fh: any = field(default=None, repr=False)

    def _open(self):
        if self._fh is None and self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def _rotate_if_needed(self):
        if not self.path:
            return
        try:
            if os.path.getsize(self.path) < self.max_bytes:
                return
        except OSError:
            return
        if self._fh:
            self._fh.close()
            self._fh = None
        for i in range(self.backup_count - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        os.replace(self.path, f"{self.path}.1")

    def log(self, level: str, msg: str, service: str | None = None, **fields):
        if LEVELS.get(level, 20) < LEVELS.get(self.min_level, 20):
            return
        record = {"ts": self.now_fn(), "level": level,
                  "service": service or self.service, "msg": msg, **fields}
        # trace correlation: a log emitted inside a span carries its ids
        if "trace_id" not in record:
            sp = tracing.current()
            if sp is not None:
                record["trace_id"] = sp.trace_id
                record["span_id"] = sp.span_id
        line = _safe_dumps(record)
        if self.path:
            self._rotate_if_needed()
            fh = self._open()
            fh.write(line + "\n")
            fh.flush()
        if self.echo or not self.path:
            import sys

            print(line, file=sys.stderr)

    def debug(self, msg, **f):
        self.log("debug", msg, **f)

    def info(self, msg, **f):
        self.log("info", msg, **f)

    def warning(self, msg, **f):
        self.log("warning", msg, **f)

    def error(self, msg, **f):
        self.log("error", msg, **f)

    def child(self, service: str) -> "_ChildLogger":
        """Same sink (one handle, one rotation), different service tag."""
        return _ChildLogger(self, service)


@dataclass
class _ChildLogger:
    parent: StructuredLogger
    service: str

    def log(self, level: str, msg: str, **fields):
        self.parent.log(level, msg, service=self.service, **fields)

    def debug(self, msg, **f):
        self.log("debug", msg, **f)

    def info(self, msg, **f):
        self.log("info", msg, **f)

    def warning(self, msg, **f):
        self.log("warning", msg, **f)

    def error(self, msg, **f):
        self.log("error", msg, **f)

    def child(self, service: str) -> "_ChildLogger":
        return _ChildLogger(self.parent, service)
