"""Model/strategy version registry.

The port's own copy of `ai_crypto_trader_tpu/strategy/registry.py` (pure
Python and NumPy): register versions, update performance, query the best,
the status lifecycle and comparison — JSON-file persistence (the same file
either package reads), with near-duplicate suppression by a scale-free
per-field similarity.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

STATUSES = ("registered", "active", "shadow", "retired")


@dataclass
class ModelRegistry:
    path: str | None = None          # JSON persistence file
    similarity_threshold: float = 0.9
    now_fn: any = time.time
    entries: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                self.entries = json.load(f)

    def _persist(self):
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(self.entries, f, indent=2)

    @staticmethod
    def _similarity(a: dict, b: dict) -> float:
        """Mean per-field relative closeness over shared numeric fields (the
        dedup test of `strategy_evolution_service.py:1295-1400`).

        Scale-free: each field contributes 1 - |a-b| / max(|a|,|b|), so a
        5 000-scale threshold can't drown a 5-scale period (cosine over raw
        values scores ~77 % of unrelated all-positive param sets above 0.9)."""
        keys = sorted(set(a) & set(b))
        if not keys:
            return 0.0
        sims = []
        for k in keys:
            try:
                va, vb = float(a[k]), float(b[k])
            except (TypeError, ValueError):
                # non-numeric payload fields (structure rule dicts, names):
                # exact match counts as identical, anything else distinct
                sims.append(1.0 if a[k] == b[k] else 0.0)
                continue
            scale = max(abs(va), abs(vb), 1e-12)
            sims.append(1.0 - min(abs(va - vb) / scale, 1.0))
        return float(np.mean(sims))

    def register(self, kind: str, payload: dict, metadata: dict | None = None,
                 *, similarity_threshold: float | None = None) -> str:
        """Returns the version id; near-duplicates return the existing id
        instead of creating noise versions.

        ``similarity_threshold`` overrides the instance default for this
        call: adopted structure-search improvements pass 1.0 (exact-dup
        only) because a small-delta improvement that cleared its adoption
        gate must get its OWN version — at 0.9 its performance would be
        attached to the older near-identical payload."""
        thr = (self.similarity_threshold if similarity_threshold is None
               else similarity_threshold)
        for vid, e in self.entries.items():
            if (e["kind"] == kind
                    and self._similarity(e["payload"], payload) >= thr):
                return vid
        vid = str(uuid.uuid4())[:8]
        self.entries[vid] = {
            "version": vid, "kind": kind, "payload": payload,
            "metadata": metadata or {}, "status": "registered",
            "created_at": self.now_fn(), "performance": {},
        }
        self._persist()
        return vid

    def update_performance(self, version: str, metrics: dict):
        """Replace a version's performance metrics."""
        if version in self.entries:
            self.entries[version]["performance"] = dict(metrics)
            self._persist()

    def set_status(self, version: str, status: str):
        """Lifecycle: registered → active/shadow → retired."""
        if status not in STATUSES:
            raise ValueError(f"unknown status {status!r}")
        if version in self.entries:
            self.entries[version]["status"] = status
            self._persist()

    def best(self, kind: str, metric: str = "sharpe_ratio") -> dict | None:
        """The non-retired entry of ``kind`` with the highest ``metric``."""
        candidates = [e for e in self.entries.values()
                      if e["kind"] == kind and e["status"] != "retired"
                      and metric in e.get("performance", {})]
        if not candidates:
            return None
        return max(candidates, key=lambda e: e["performance"][metric])

    def compare(self, versions: list[str], metric: str = "sharpe_ratio") -> dict:
        """``metric`` of each version, and the best of them."""
        rows = {v: self.entries[v]["performance"].get(metric)
                for v in versions if v in self.entries}
        valid = {v: m for v, m in rows.items() if m is not None}
        return {"metric": metric, "values": rows,
                "best": max(valid, key=valid.get) if valid else None}
