"""The EMA family: K first-order recursions over a batch of series.

Replaces the TPU kernel `ai_crypto_trader_tpu/ops/pallas_kernels.py`
`fused_ewma_pallas` (pl.pallas_call at :88; kernel `_ewma_kernel` :47-74;
wrapper `fused_ewma` :102) with the CUDA kernel `csrc/fused_ewma.cu`.

``fused_ewma(x, alphas, start)`` equals
``stack([_ewm(x, a, start) for a in alphas])`` of
`ai_crypto_trader_tpu/ops/indicators.py:110-122`: pandas
``ewm(alpha, adjust=False)`` seeded with x[start], NaN before ``start``,
NaNs in x read as 0.  At ``start=0`` it is the JAX package's ``fused_ewma``.

On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
runs ``fused_ewma_plain``, which replays `lax.associative_scan`'s
odd/even recursion over the affine maps (a, b) with the combine of
``first_order_recursion`` (indicators.py:94-107).  Replaying that exact
tree matters: MACD is the difference of two EMAs of a price, and a scan
that rounds in another order moves it by more than any sensible tolerance
where the two EMAs nearly cancel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.ops import _cuda

_SIGNATURES = {
    "fused_ewma_chunk_len": (ctypes.c_int, []),
    "fused_ewma_max_k": (ctypes.c_int, []),
    "fused_ewma_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
}


def _coefficients(alphas):
    """(alpha, 1 - alpha) as float32, 1 - alpha rounded once from double —
    what `_ewm` gets for a Python-float alpha, and for a float32 alpha the
    same value float32 subtraction gives."""
    vals = [float(a) for a in (alphas.tolist() if torch.is_tensor(alphas)
                               else np.asarray(alphas, np.float64).ravel())]
    return ([float(np.float32(a)) for a in vals],
            [float(np.float32(1.0 - a)) for a in vals])


def _combine(first, then):
    a1, b1 = first
    a2, b2 = then
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    n = even.shape[-1] + odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (n,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def associative_scan(a, b):
    """Inclusive scan of the affine maps (a, b) along the last axis, in
    exactly the order `lax.associative_scan` combines them: pairs reduced,
    the half-length scan recursed, the even positions fixed up, the two
    halves interleaved.  Depth O(log T)."""
    n = a.shape[-1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[..., 0:-1:2], b[..., 0:-1:2]),
                      (a[..., 1::2], b[..., 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[..., :-1], ob[..., :-1]),
                          (a[..., 2::2], b[..., 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[..., 2::2], b[..., 2::2]))
    ea = torch.cat([a[..., :1], ea], dim=-1)
    eb = torch.cat([b[..., :1], eb], dim=-1)
    return _interleave(ea, oa), _interleave(eb, ob)


def fused_ewma_plain(x, alphas, start: int = 0):
    """The plain PyTorch version: x [B, T] → [K, B, T] on x's device."""
    alpha, decay = _coefficients(alphas)
    T = x.shape[-1]
    t = torch.arange(T, device=x.device)
    xs = torch.where(t < start, 0.0, torch.nan_to_num(x))
    k_shape = (len(alpha),) + (1,) * x.ndim
    al = torch.tensor(alpha, dtype=torch.float32, device=x.device).reshape(k_shape)
    dc = torch.tensor(decay, dtype=torch.float32, device=x.device).reshape(k_shape)
    a = torch.where(t <= start, 0.0, dc.expand((len(alpha),) + x.shape))
    b = torch.where(t == start, xs, al * xs)
    b = torch.where(t < start, 0.0, b)
    _, y = associative_scan(a, b)
    return torch.where(t < start, math.nan, y)


def _launch(x, alphas, start: int):
    lib = _cuda.library("fused_ewma", _SIGNATURES)
    alpha, decay = _coefficients(alphas)
    K = len(alpha)
    B, T = x.shape
    if K > lib.fused_ewma_max_k():
        raise ValueError(f"fused_ewma kernel takes at most "
                         f"{lib.fused_ewma_max_k()} alphas, got {K}")
    if B > 65535:
        raise ValueError(f"fused_ewma kernel takes at most 65535 series, got {B}")
    C = -(-T // lib.fused_ewma_chunk_len())
    out = torch.empty((K, B, T), dtype=torch.float32, device=x.device)
    agg = torch.empty((K * B * C * 2,), dtype=torch.float32, device=x.device)
    carry = torch.empty((K * B * C,), dtype=torch.float32, device=x.device)
    alpha_c = (ctypes.c_float * K)(*alpha)
    decay_c = (ctypes.c_float * K)(*decay)
    with torch.cuda.device(x.device):
        rc = lib.fused_ewma_launch(
            x.data_ptr(), out.data_ptr(), agg.data_ptr(), carry.data_ptr(),
            ctypes.cast(alpha_c, ctypes.c_void_p),
            ctypes.cast(decay_c, ctypes.c_void_p),
            K, B, T, int(start), _cuda.stream_handle(x.device))
    _cuda.check(lib, "fused_ewma", rc)
    fused_ewma.launches += 1
    return out


def fused_ewma(x, alphas, start: int = 0, device=None):
    """Batch EMA family: x [..., T], alphas length K → [K, ..., T].

    On CUDA the hand-written kernel runs (``fused_ewma.launches`` counts its
    launches); on the CPU the plain version."""
    dev = resolve_device(device)
    x = to_device(x, dev, torch.float32)
    lead, T = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, T).contiguous()
    if x2.is_cuda:
        out = _launch(x2, alphas, start)
    else:
        out = fused_ewma_plain(x2, alphas, start)
    return out.reshape((out.shape[0],) + tuple(lead) + (T,))


fused_ewma.launches = 0
