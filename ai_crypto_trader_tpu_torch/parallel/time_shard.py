"""Sequence parallelism: the candle axis split over a mesh.

Port of `ai_crypto_trader_tpu/parallel/time_shard.py:37-120`.  The series
is cut into one block a device along the mesh's data axis
(`parallel.mesh.split_leading`), and the result stays split: each function
returns `parallel.mesh.Shards`, block i on device i; ``.gather()`` joins
them on one device.

  * `sharded_first_order_recursion` — ``y[t] = a[t]·y[t-1] + b[t]``
    blockwise: every block runs the port's associative scan
    (`ops.indicators.first_order_recursion`, in `lax.associative_scan`'s
    order), the blocks' affine aggregates ``(A_i, B_i) = (∏a, local
    final)`` are gathered onto the first device (the all-gather), the
    incoming carry of each block is the composition of its predecessors',
    sent back to its block, and a rank-1 fix-up ``y += carry · cumprod(a)``
    makes the result exact;
  * `sharded_ema` — `ops.indicators.ema`'s semantics (pandas ``ewm(span,
    adjust=False, min_periods=window)``) on the split series;
  * `sharded_rolling_mean` — a halo move: each block receives its
    predecessor's last ``window − 1`` candles (block 0 a NaN halo, the
    warm-up), so every mean sums the same window, in the same order, as
    `ops.indicators.rolling_mean` does unsplit.

On a process mesh (`parallel.mesh.ProcessMesh`) each rank holds the whole
series, keeps its own block, and the result is that block alone
(``.gather()`` all-gathers the series onto every rank): the aggregates are
all-gathered and every rank composes its own carry from its predecessors'
in `_carries`' order (bit for bit the one-controller result), and the
halo comes from rank i − 1 by point-to-point send/recv.
"""

from __future__ import annotations

import math

import torch

from ai_crypto_trader_tpu_torch.ops.indicators import first_order_recursion, rolling_mean
from ai_crypto_trader_tpu_torch.parallel.mesh import Shards, all_gather, exchange


def _blocks(x, mesh, axis):
    """(blocks this process holds, the index of its first, the count of
    all): every block on one controller, its own on a process mesh."""
    n = mesh.shape[axis]
    if x.shape[-1] % n:
        raise ValueError(f"series of {x.shape[-1]} candles not divisible by the "
                         f"{n}-way '{axis}' mesh axis")
    first = mesh.rank if mesh.spans_processes else 0
    return mesh.split(x, -1, axis), first, n


def _carries(As, Bs):
    """The incoming carry of every block: the composition of its
    predecessors' aggregates applied to y = 0, on the first block's
    device (a scan over n scalars)."""
    dev = As[0].device
    c = torch.zeros((), dtype=As[0].dtype, device=dev)
    out = []
    for A, B in zip(As, Bs):
        out.append(c)
        c = A.to(dev, non_blocking=True) * c + B.to(dev, non_blocking=True)
    return out


def sharded_first_order_recursion(a, b, mesh, axis: str = "data") -> Shards:
    """Exact ``y[t] = a[t]·y[t-1] + b[t]`` over a series split on ``axis``
    (its length divisible by the axis).  ``a``, ``b``: [T] tensors.
    Returns the blocks of y, each on its device."""
    axis = axis or mesh.axis_names[0]
    (a_blk, first, _), (b_blk, _, _) = _blocks(a, mesh, axis), _blocks(b, mesh, axis)
    prefix = [torch.cumprod(x, dim=-1) for x in a_blk]
    local = [first_order_recursion(x, y) for x, y in zip(a_blk, b_blk)]
    if mesh.spans_processes:
        # every block's (A_i, B_i), then this rank's carry from its predecessors'
        agg = all_gather(torch.stack([prefix[0][-1], local[0][-1]])[None], mesh.info)
        carries = [_carries(list(agg[: first + 1, 0]), list(agg[: first + 1, 1]))[first]]
    else:
        carries = _carries([p[-1] for p in prefix], [y[-1] for y in local])
    return Shards((y + c.to(y.device, non_blocking=True) * p
                   for y, c, p in zip(local, carries, prefix)), mesh=a_blk.mesh)


def sharded_ema(x, window: int, mesh, axis: str = "data") -> Shards:
    """`ops.indicators.ema` (pandas ewm adjust=False, min_periods=window)
    on a split series: the recurrence's global (a, b) coefficients through
    `sharded_first_order_recursion`, then the first window − 1 positions
    NaN."""
    alpha = 2.0 / (window + 1.0)
    t = torch.arange(x.shape[-1], device=x.device)
    xs = torch.nan_to_num(x)
    a = torch.where(t == 0, 0.0, 1.0 - alpha).to(x.dtype)
    b = torch.where(t == 0, xs, alpha * xs)
    ys = sharded_first_order_recursion(a, b, mesh, axis)
    blk = x.shape[-1] // mesh.shape[axis or mesh.axis_names[0]]
    first = mesh.rank if mesh.spans_processes else 0
    return Shards((torch.where(torch.arange(i * blk, (i + 1) * blk, device=y.device)
                               < window - 1, math.nan, y)
                   for i, y in enumerate(ys, first)), mesh=ys.mesh)


def sharded_rolling_mean(x, window: int, mesh, axis: str = "data") -> Shards:
    """`ops.indicators.rolling_mean` on a split series by a halo move: block
    i gets block i − 1's last ``window − 1`` candles (block 0 NaN), and
    its means are `rolling_mean` of halo + block past the halo.  The halo
    is one block deep: ``window − 1`` must not exceed a block
    (``ValueError``)."""
    axis = axis or mesh.axis_names[0]
    blocks, first, n = _blocks(x, mesh, axis)
    if window == 1:
        return blocks
    blk = x.shape[-1] // n
    if window - 1 > blk:
        raise ValueError(
            f"window {window} needs a halo of {window - 1} candles but the "
            f"per-device block is only {blk}; use fewer shards or the unsharded kernel")
    if mesh.spans_processes and n > 1:
        # the tail goes to rank i + 1, the halo comes from rank i − 1
        me, tail = first, blocks[0][-(window - 1):]
        received = exchange(tail, mesh.info, me + 1 if me < n - 1 else None,
                            me - 1 if me > 0 else None)
        halos = [received]
    else:
        halos = [None] + [b[-(window - 1):] for b in blocks[:-1]]
    out = []
    for i, (block, halo) in enumerate(zip(blocks, halos), first):
        if i == 0:
            halo = torch.full((window - 1,), math.nan, dtype=block.dtype, device=block.device)
        else:
            halo = halo.to(block.device, non_blocking=True)
        out.append(rolling_mean(torch.cat([halo, block]), window)[window - 1:])
    return Shards(out, mesh=blocks.mesh)
