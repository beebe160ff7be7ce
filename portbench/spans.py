"""The benchmark's own spans around the port's calls, on in a traced run.

`Spans.layer(name)` times a call into one of the port's layers between two
CUDA events (device milliseconds, read once the window has closed) and
labels it ``portbench.<name>`` for the profiler; `Spans.label(name)` only
labels.  Off (``enabled = False``, every untraced run) both are empty
contexts, so an untraced run records nothing and waits for nothing.
"""

from __future__ import annotations

import contextlib


class Spans:
    def __init__(self, device):
        self.device = device
        self.enabled = False
        self._events: dict = {}

    @contextlib.contextmanager
    def label(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        with torch.profiler.record_function(f"portbench.{name}"):
            yield

    @contextlib.contextmanager
    def layer(self, name: str):
        if not self.enabled or self.device.type != "cuda":
            with self.label(name):
                yield
            return
        import torch

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with self.label(name):
            start.record()
            yield
            end.record()
        self._events.setdefault(name, []).append((start, end))

    def device_ms(self) -> dict:
        """{layer: [ms of each call]} (synchronises once)."""
        import torch

        if self._events:
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._events.items()}
