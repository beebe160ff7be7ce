"""The response type of the network data-source fetchers.

The port's own copy of `ai_crypto_trader_tpu/data/fetchers.py:38-47`: a
transport's reply (status, body, and the body parsed as JSON on first
use).  `shell.llm`'s POST transports return it.  The fetchers themselves
(paginated klines, the social and news sources over an injectable
transport) are not ported yet (ROADMAP item 3).
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass
class Response:
    status: int
    body: str = ""
    _json: object = None

    def json(self):
        if self._json is None:
            self._json = json.loads(self.body)
        return self._json
