"""The EMA family: K first-order recursions over a batch of series.

Replaces the TPU kernel `ai_crypto_trader_tpu/ops/pallas_kernels.py`
`fused_ewma_pallas` (pl.pallas_call at :88; kernel `_ewma_kernel` :47-74;
wrapper `fused_ewma` :102) with the CUDA kernel `csrc/fused_ewma.cu`.

``fused_ewma(x, alphas, start)`` equals
``stack([_ewm(x, a, start) for a in alphas])`` of
`ai_crypto_trader_tpu/ops/indicators.py:110-122`: pandas
``ewm(alpha, adjust=False)`` seeded with x[start], NaN before ``start``,
NaNs in x read as 0.  At ``start=0`` it is the JAX package's ``fused_ewma``.
``fused_ewma_jobs([(x, alphas, start), ...])`` computes several such
families, each with its own alphas and seed index, in one kernel launch.

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
from ai_crypto_trader_tpu_torch.utils import devprof

# The kernel's tiling (csrc/fused_ewma.cu: kThreads, kItems, kMaxK,
# kMaxJobs); the wrapper checks the library agrees, and the CPU tests mirror
# the kernel's order of composition with them.
TILE_THREADS, TILE_ITEMS = 256, 16
TILE_LEN = TILE_THREADS * TILE_ITEMS
MAX_K, MAX_JOBS = 8, 4
# float32 operations an output element takes (the coefficient products and
# the recursion's multiply and add, and the NaN mask): a launch's cost on a
# devprof card, as PERF.md's bound column reckons it
EWMA_OPS = 5

_SIGNATURES = {
    "fused_ewma_tile_len": (ctypes.c_int, []),
    "fused_ewma_max_k": (ctypes.c_int, []),
    "fused_ewma_max_jobs": (ctypes.c_int, []),
    "fused_ewma_plan": (ctypes.c_int, [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
    "fused_ewma_launch": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 10),
    "fused_ewma_barrier_launch": (ctypes.c_int,
                                  [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
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


def tile_count(shapes) -> int:
    """Tiles of a launch over jobs of ``shapes`` ([(B, T), ...]): every row
    is cut into tiles of TILE_LEN candles."""
    return sum(B * -(-T // TILE_LEN) for B, T in shapes)


def launch_plan(n_tiles: int, kmax: int, device=None) -> dict:
    """The kernel's grid for ``n_tiles`` whose largest K is ``kmax``, on the
    card: blocks, tiles of x a block keeps in shared memory, whether every
    block keeps every tile it owns (else x is read again for the rest), and
    a block's dynamic shared memory."""
    lib = _cuda.library("fused_ewma", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        rc = lib.fused_ewma_plan(int(n_tiles), int(kmax), ctypes.cast(out, ctypes.c_void_p))
    _cuda.check(lib, "fused_ewma", rc)
    return {"blocks": out[0], "slots": out[1], "resident": bool(out[2]),
            "dynamic_smem_bytes": out[3]}


def barrier_launch(n_tiles: int, kmax: int) -> None:
    """On the current card, a cooperative launch of the grid ``launch_plan``
    gives, with its shared memory, that only crosses the grid barrier: the
    fixed cost under every kernel launch, for timing.  It computes nothing
    and is not counted in ``fused_ewma.launches``."""
    lib = _cuda.library("fused_ewma", _SIGNATURES)
    rc = lib.fused_ewma_barrier_launch(int(n_tiles), int(kmax), _cuda.stream_handle(None))
    _cuda.check(lib, "fused_ewma", rc)


def _launch(jobs):
    """One launch of the kernel over ``jobs`` [(x [B, T] contiguous CUDA
    float32, alphas, start), ...]: the list of outputs [K, B, T]."""
    lib = _cuda.library("fused_ewma", _SIGNATURES)
    if (lib.fused_ewma_tile_len(), lib.fused_ewma_max_k(),
            lib.fused_ewma_max_jobs()) != (TILE_LEN, MAX_K, MAX_JOBS):
        raise RuntimeError("csrc/fused_ewma.cu and ops/ewma.py disagree on "
                           "the tiling")
    n = len(jobs)
    if not 1 <= n <= MAX_JOBS:
        raise ValueError(f"fused_ewma kernel takes 1 to {MAX_JOBS} jobs a "
                         f"launch, got {n}")
    dev = jobs[0][0].device
    xs, outs = (ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()
    Ts = (ctypes.c_longlong * n)()
    Bs, Ks, starts = ((ctypes.c_int * n)() for _ in range(3))
    alpha_c, decay_c = ((ctypes.c_float * (n * MAX_K))() for _ in range(2))
    results = []
    for j, (x, alphas, start) in enumerate(jobs):
        if x.device != dev:
            raise ValueError("fused_ewma jobs of one launch must share a device")
        alpha, decay = _coefficients(alphas)
        if len(alpha) > MAX_K:
            raise ValueError(f"fused_ewma kernel takes at most {MAX_K} "
                             f"alphas, got {len(alpha)}")
        B, T = x.shape
        out = torch.empty((len(alpha), B, T), dtype=torch.float32, device=dev)
        results.append(out)
        xs[j], outs[j] = x.data_ptr(), out.data_ptr()
        Ts[j], Bs[j], Ks[j], starts[j] = T, B, len(alpha), int(start)
        for k, (a, d) in enumerate(zip(alpha, decay)):
            alpha_c[j * MAX_K + k], decay_c[j * MAX_K + k] = a, d
    agg = torch.empty((tile_count([x.shape for x, _, _ in jobs]) * MAX_K * 2,),
                      dtype=torch.float32, device=dev)
    ptr = lambda arr: ctypes.cast(arr, ctypes.c_void_p)  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.fused_ewma_launch(
            n, ptr(xs), ptr(outs), ptr(Ts), ptr(Bs), ptr(Ks), ptr(starts),
            ptr(alpha_c), ptr(decay_c), agg.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check(lib, "fused_ewma", rc)
    fused_ewma.launches += 1
    if devprof.cards_open():
        inputs = {x.data_ptr(): x.numel() for x, _, _ in jobs}
        outputs = sum(o.numel() for o in results)
        devprof.kernel_cost("fused_ewma", EWMA_OPS * outputs,
                            4 * (sum(inputs.values()) + outputs))
    return results


def fused_ewma_jobs(jobs, device=None):
    """Several independent EMA families in one kernel launch.

    ``jobs`` is a sequence of ``(x [..., T], alphas, start)``, each with its
    own T, K ≤ 8 alphas and seed index; returns the list of their
    ``fused_ewma`` results [K, ..., T].  On CUDA one launch takes at most
    ``MAX_JOBS`` jobs (``fused_ewma.launches`` counts it once); on the CPU
    each job runs the plain version, so the result is a loop of
    ``fused_ewma_plain`` bit for bit."""
    dev = resolve_device(device)
    flat, leads = [], []
    for x, alphas, start in jobs:
        x = to_device(x, dev, torch.float32)
        leads.append(tuple(x.shape[:-1]))
        flat.append((x.reshape(-1, x.shape[-1]).contiguous(), alphas, int(start)))
    if flat and flat[0][0].is_cuda:
        outs = _launch(flat)
    else:
        outs = [fused_ewma_plain(x, alphas, start) for x, alphas, start in flat]
    return [o.reshape((o.shape[0],) + lead + (o.shape[-1],))
            for o, lead in zip(outs, leads)]


def fused_ewma(x, alphas, start: int = 0, device=None):
    """Batch EMA family: x [..., T], alphas length K → [K, ..., T] — the
    one-job case of ``fused_ewma_jobs``.

    On CUDA the hand-written kernel runs (``fused_ewma.launches`` counts its
    launches); on the CPU the plain version."""
    return fused_ewma_jobs([(x, alphas, start)], device=device)[0]


fused_ewma.launches = 0
