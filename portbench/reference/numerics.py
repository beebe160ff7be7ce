"""Number formats for the plain reference and for its control.

The reference computes in float64 (the indicator table, the metrics) or in
float32 where the configuration's own rounding decides a trade (the signal
rule and the replay walk).  Its control is the same code one precision
lower, in bfloat16: `BF16` is a NumPy array whose every elementwise result
is rounded to the nearest bfloat16 (kept in float32 storage), and
`round_bf16` rounds one value or array.  Adding, subtracting, multiplying
and dividing two bfloat16 values in float32 and rounding once gives the
bfloat16 result, since float32 holds more than twice bfloat16's digits.
"""

from __future__ import annotations

import numpy as np


def round_bf16(x):
    """``x`` rounded to the nearest bfloat16 (ties to even), as float32."""
    a = np.asarray(x, dtype=np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = rounded.astype(np.uint32).view(np.float32)
    out = np.where(np.isnan(a), a, out)
    return out if out.ndim else np.float32(out)


def _plain(x):
    return x.view(np.ndarray) if isinstance(x, BF16) else x


def _wrap(out):
    if isinstance(out, tuple):
        return tuple(_wrap(o) for o in out)
    if isinstance(out, (np.ndarray, np.floating)) and np.asarray(out).dtype.kind == "f":
        return np.asarray(round_bf16(out)).view(BF16)
    return out


class BF16(np.ndarray):
    """A float32 array that rounds to bfloat16 after every operation."""

    def __new__(cls, values):
        return np.asarray(round_bf16(values), dtype=np.float32).view(cls)

    def __array_ufunc__(self, ufunc, method, *inputs, **kw):
        if "out" in kw:
            raise TypeError("BF16 does not take out=")
        return _wrap(getattr(ufunc, method)(*(_plain(x) for x in inputs), **kw))

    def __array_function__(self, func, types, args, kw):
        def strip(v):
            if isinstance(v, (list, tuple)):
                return type(v)(strip(x) for x in v)
            return _plain(v)
        return _wrap(func(*strip(args), **{k: strip(v) for k, v in kw.items()}))

