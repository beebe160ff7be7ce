"""Checksummed array packing for fleet snapshots.

The port's copy of `ai_crypto_trader_tpu/utils/journal.py:45-75`: the same
record format (dtype, shape, base64 bytes, CRC-32 of the raw bytes), so a
snapshot written by either package restores in the other.  The rest of
the journal (the write-ahead log) is not ported yet.
"""

from __future__ import annotations

import base64
import zlib

import numpy as np


def pack_array(a) -> dict:
    """A NumPy array as a JSON-able record with its own checksum over the
    raw bytes, so a bad base64 round trip is caught at unpack."""
    a = np.ascontiguousarray(a)
    raw = a.tobytes()
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(raw).decode("ascii"),
        "crc": zlib.crc32(raw) & 0xFFFFFFFF,
    }


def unpack_array(obj: dict):
    """Inverse of :func:`pack_array`; ``ValueError`` on a checksum or shape
    mismatch.  Returns a writable copy."""
    raw = base64.b64decode(obj["data"])
    if (zlib.crc32(raw) & 0xFFFFFFFF) != int(obj["crc"]):
        raise ValueError("packed array crc mismatch")
    a = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
    a = a.reshape([int(d) for d in obj["shape"]])
    return np.array(a)
