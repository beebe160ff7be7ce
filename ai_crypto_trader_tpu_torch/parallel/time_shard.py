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
series, keeps the blocks of its L local shards (global blocks rank·L to
rank·L + L − 1), and the result is those blocks alone (``.gather()``
all-gathers the series onto every rank): the aggregates of every block
are all-gathered and every rank composes its blocks' carries from their
predecessors' in `_carries`' order (bit for bit the one-controller
result); a halo moves within the rank as on one controller, and across
the rank boundary (the rank's first block from rank − 1's last) by
point-to-point send/recv.
"""

from __future__ import annotations

import math

import torch

from ai_crypto_trader_tpu_torch.ops.indicators import first_order_recursion, rolling_mean
from ai_crypto_trader_tpu_torch.parallel.mesh import Shards, all_gather, exchange


def _blocks(x, mesh, axis):
    """(blocks this process holds, the index of its first, the count of
    all): every block on one controller, its L local shards' on a process
    mesh."""
    n = mesh.shape[axis]
    if x.shape[-1] % n:
        raise ValueError(f"series of {x.shape[-1]} candles not divisible by the "
                         f"{n}-way '{axis}' mesh axis")
    return mesh.split(x, -1, axis), mesh.own_shards(axis)[0][0], n


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
        # every block's (A_i, B_i), then this rank's carries from their predecessors'
        home = mesh.local_device
        mine = torch.stack([torch.stack([p[-1], y[-1]]).to(home, non_blocking=True)
                            for p, y in zip(prefix, local)])
        agg = all_gather(mine, mesh.info)
        last = first + len(local)
        carries = _carries(list(agg[:last, 0]), list(agg[:last, 1]))[first:]
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
    axis = axis or mesh.axis_names[0]
    blk = x.shape[-1] // mesh.shape[axis]
    first = mesh.own_shards(axis)[0][0]
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
    halos = [None] + [b[-(window - 1):] for b in blocks[:-1]]
    if mesh.spans_processes and mesh.world > 1:
        # the last block's tail goes to rank + 1, the first block's halo
        # comes from rank − 1
        r, last = mesh.rank, first + len(blocks) - 1
        tail = blocks[-1][-(window - 1):].to(mesh.local_device, non_blocking=True)
        halos[0] = exchange(tail, mesh.info, r + 1 if last < n - 1 else None,
                            r - 1 if first > 0 else None)
    out = []
    for i, (block, halo) in enumerate(zip(blocks, halos), first):
        if i == 0:
            halo = torch.full((window - 1,), math.nan, dtype=block.dtype, device=block.device)
        else:
            halo = halo.to(block.device, non_blocking=True)
        out.append(rolling_mean(torch.cat([halo, block]), window)[window - 1:])
    return Shards(out, mesh=blocks.mesh)
