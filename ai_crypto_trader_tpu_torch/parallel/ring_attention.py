"""Ring attention: exact self-attention over a sequence split across a mesh.

Port of `ai_crypto_trader_tpu/parallel/ring_attention.py`.  The sequence
axis is cut into one block a device along the mesh axis; each device
holds its Q block and an online-softmax accumulator (running max,
normalizer and unnormalized output, in float32), and the K/V blocks
rotate around the ring: after each fold every shard hands its current K/V
block to the next device (a tensor move, ``.to(device,
non_blocking=True)``), n − 1 rotations in all, the last block folded
without a final move.  Causal masking skips the blocks that lie wholly in
a shard's future (source block > its own).  No device ever holds more
than one [H, T/n, T/n] block of scores; autograd follows the moves, so the
ring's gradient is the dense one.

On a process mesh (`parallel.mesh.ProcessMesh`) the shards are the ranks:
each rank holds the whole q, k and v (computed alike on every rank), takes
its own rows of the three stacked (`_Scatter`, whose backward all-gathers
the gradient's rows), and the K/V block rotates as one tensor with
point-to-point send/recv — to rank i + 1, from rank i − 1 — in `_Rotate`,
whose backward rotates the gradient the other way.  The output blocks are
all-gathered onto every rank (`_Gather`, whose backward takes this rank's
rows of the gradient: every rank computes the same loss).  The last K/V
block is tied to the output (`_Tie`, a zero gradient), so every rank runs
every rotation's backward, in the same order, whatever causal masking
skipped.

`reference_attention` (:134-143) is the dense oracle that
`models.long_context` runs without a mesh.  Both are explicit products,
not a fused attention library call, so the card rounds as the CPU does
(with TF32 off, as the package sets it).
"""

from __future__ import annotations

import torch

from ai_crypto_trader_tpu_torch.device import div_const
from ai_crypto_trader_tpu_torch.parallel.mesh import all_gather, rotate, split_leading

NEG_BIG = -1e30   # a finite stand-in for -inf: never a NaN under exp or subtraction


def _block_update(o, m, l, q, k, v, kmask, scale: float):
    """Fold one K/V block into the (o, m, l) online-softmax accumulator.
    o: [Tq, H, D] float32 unnormalized output; m, l: [H, Tq] running max
    and normalizer; kmask: [Tq, Tk] bool (True where the key is
    attendable), or None where every key is."""
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale     # [H, Tq, Tk]
    if kmask is not None:
        s = torch.where(kmask[None], s, NEG_BIG)
    m_new = torch.maximum(m, s.amax(dim=-1))                           # [H, Tq]
    p = torch.exp(s - m_new[..., None])                                # [H, Tq, Tk]
    if kmask is not None:
        # a wholly masked row's exp(0) = 1 lanes are zeroed here
        p = p * kmask[None]
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr.T[..., None] + torch.einsum("hqk,khd->qhd", p, v.float())
    return o, m_new, l


def ring_self_attention(q, k, v, mesh, *, axis: str = "data", causal: bool = True):
    """Exact (optionally causal) multi-head self-attention over [T, H, D]
    queries, keys and values, the sequence split over ``mesh``'s ``axis``.

    ``T`` must divide over the axis (``ValueError``).  Returns the [T, H, D]
    output gathered on ``q``'s device, in ``q``'s dtype.  One device is
    flash-style attention over one block."""
    T, H, D = q.shape
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by the "
                         f"{n}-way '{axis}' mesh axis")
    Tb = T // n
    scale = 1.0 / (D ** 0.5)
    if mesh.spans_processes:
        return _process_ring(q, k, v, mesh.info, Tb, scale, causal)
    qs, k_cur, v_cur = (split_leading(x, devs) for x in (q, k, v))
    acc = [(torch.zeros((Tb, H, D), dtype=torch.float32, device=d),
            torch.full((H, Tb), NEG_BIG, dtype=torch.float32, device=d),
            torch.zeros((H, Tb), dtype=torch.float32, device=d)) for d in devs]
    diag = torch.ones((Tb, Tb), dtype=torch.bool).tril()
    masks = {d: diag.to(d) for d in dict.fromkeys(devs)}
    for s in range(n):
        for me, d in enumerate(devs):
            src = (me - s) % n                 # the shard this K/V block came from
            if causal and src > me:
                continue                       # wholly in this shard's future
            kmask = masks[d] if causal and src == me else None
            acc[me] = _block_update(*acc[me], qs[me], k_cur[me], v_cur[me], kmask, scale)
        if s < n - 1:
            # hand every block to the next shard (n − 1 rotations)
            k_cur = [k_cur[(me - 1) % n].to(d, non_blocking=True) for me, d in enumerate(devs)]
            v_cur = [v_cur[(me - 1) % n].to(d, non_blocking=True) for me, d in enumerate(devs)]
    out = [o / torch.clamp_min(l, 1e-30).T[..., None] for o, _, l in acc]
    return torch.cat([x.to(q.device, non_blocking=True) for x in out]).to(q.dtype)


class _Scatter(torch.autograd.Function):
    """This rank's rows of a tensor every rank holds alike, along ``dim``;
    the backward all-gathers the rows' gradients into the whole's."""

    @staticmethod
    def forward(ctx, x, info, dim):
        ctx.info, ctx.dim = info, dim
        blk = x.shape[dim] // info.world
        return x.narrow(dim, info.rank * blk, blk).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.info, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every rank's block joined along ``dim`` on every rank; the backward
    takes this rank's rows of the gradient (each rank computes the same
    loss from the whole)."""

    @staticmethod
    def forward(ctx, x, info, dim):
        ctx.info, ctx.dim, ctx.blk = info, dim, x.shape[dim]
        return all_gather(x, info, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.info.rank * ctx.blk, ctx.blk), None, None


class _Rotate(torch.autograd.Function):
    """The ring's step: the block to rank i + 1, rank i − 1's received;
    the backward hands the gradient back the other way."""

    @staticmethod
    def forward(ctx, x, info):
        ctx.info = info
        return rotate(x, info, 1)

    @staticmethod
    def backward(ctx, g):
        return rotate(g.contiguous(), ctx.info, -1), None


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``block`` given a zero gradient: the last
    K/V block then has a gradient on every rank, so every rank runs every
    rotation's backward, whatever causal masking skipped."""

    @staticmethod
    def forward(ctx, out, block):
        ctx.shape, ctx.dtype, ctx.device = block.shape, block.dtype, block.device
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device)


def _process_ring(q, k, v, info, Tb: int, scale: float, causal: bool):
    """`ring_self_attention` over the ranks of a process mesh: this rank's
    Q block, the K/V block rotating between the ranks (n − 1 rotations,
    the order and masking of the one-controller ring), the output blocks
    gathered onto every rank."""
    n, me = info.world, info.rank
    qkv = _Scatter.apply(torch.stack([q, k, v]), info, 1)      # [3, Tb, H, D]
    qb, kv = qkv[0], qkv[1:]
    H, D = q.shape[1], q.shape[2]
    acc = (torch.zeros((Tb, H, D), dtype=torch.float32, device=q.device),
           torch.full((H, Tb), NEG_BIG, dtype=torch.float32, device=q.device),
           torch.zeros((H, Tb), dtype=torch.float32, device=q.device))
    diag = torch.ones((Tb, Tb), dtype=torch.bool, device=q.device).tril()
    for s in range(n):
        src = (me - s) % n                 # the rank this K/V block came from
        if not (causal and src > me):
            acc = _block_update(*acc, qb, kv[0], kv[1],
                                diag if causal and src == me else None, scale)
        if s < n - 1:
            kv = _Rotate.apply(kv, info)
    o, _, l = acc
    out = _Tie.apply(o / torch.clamp_min(l, 1e-30).T[..., None], kv)
    return _Gather.apply(out, info, 0).to(q.dtype)


def reference_attention(q, k, v, *, causal: bool = True):
    """Dense attention over [T, H, D] queries, keys and values
    (materializes [H, T, T]): scores in float32 divided by √D, masked with
    NEG_BIG above the diagonal when ``causal``, a float32 softmax, and the
    output cast back to ``q``'s dtype."""
    T, H, D = q.shape
    s = div_const(torch.einsum("qhd,khd->hqk", q.float(), k.float()), D ** 0.5)
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)
