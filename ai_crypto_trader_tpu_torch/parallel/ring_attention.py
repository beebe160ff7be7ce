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

On a process mesh (`parallel.mesh.ProcessMesh`) each rank runs its L
local shards (global shards rank·L to rank·L + L − 1): it holds the whole
q, k and v (computed alike on every rank) and takes its rows of the three
stacked (`_Scatter`, whose backward all-gathers the gradient's rows).  A
rotation (`_Rotate`, one autograd node over the rank's L K/V blocks)
moves each local block to the next local shard's device, and at the rank
boundary sends the last to rank + 1 and takes rank − 1's as block 0, by
point-to-point send/recv on the home device; the backward hands the
gradients back the other way.  The output blocks are all-gathered onto
every rank (`_Gather`, whose backward takes this rank's rows of the
gradient: every rank computes the same loss).  Each rotation takes the
previous one's blocks whole, and the last blocks are tied to the output
(`_Tie`, a zero gradient), so every rank runs every rotation's backward,
in the same order, whatever causal masking skipped on its local shards.
On one controller the rotation is the same node with no exchange: the
last block goes to shard 0.

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
    n = mesh.shape[axis]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by the "
                         f"{n}-way '{axis}' mesh axis")
    Tb = T // n
    scale = 1.0 / (D ** 0.5)
    own = mesh.own_shards(axis)
    local = [d for _, d in own]
    info = mesh.info if mesh.spans_processes else None
    home = q.device if info is None else mesh.local_device
    qkv = torch.stack([q, k, v]).to(home)
    if info is not None:
        qkv = _Scatter.apply(qkv, info, 1)                 # this rank's L·Tb rows
    blocks = split_leading(qkv, local, dim=1)              # [3, Tb, H, D] a local shard
    qs, kv = [b[0] for b in blocks], tuple(b[1:] for b in blocks)
    acc = [(torch.zeros((Tb, H, D), dtype=torch.float32, device=d),
            torch.full((H, Tb), NEG_BIG, dtype=torch.float32, device=d),
            torch.zeros((H, Tb), dtype=torch.float32, device=d)) for d in local]
    diag = torch.ones((Tb, Tb), dtype=torch.bool).tril()
    masks = {d: diag.to(d) for d in dict.fromkeys(local)}
    for s in range(n):
        for j, (me, d) in enumerate(own):
            src = (me - s) % n                 # the shard this K/V block came from
            if causal and src > me:
                continue                       # wholly in this shard's future
            kmask = masks[d] if causal and src == me else None
            acc[j] = _block_update(*acc[j], qs[j], kv[j][0], kv[j][1], kmask, scale)
        if s < n - 1:
            kv = _Rotate.apply(info, local, *kv)   # n − 1 rotations
    out = torch.cat([(o / torch.clamp_min(l, 1e-30).T[..., None]).to(home, non_blocking=True)
                     for o, _, l in acc])
    if info is not None:
        out = _Gather.apply(_Tie.apply(out, *kv), info, 0)
    return out.to(q.device, q.dtype)


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


def _hand_on(x, info, shift: int):
    """The block that leaves this rank's last local shard (``shift`` 1) or
    its first (−1): handed to rank + ``shift`` and rank − ``shift``'s
    received; itself on one controller (``info`` None)."""
    return x if info is None else rotate(x.contiguous(), info, shift)


class _Rotate(torch.autograd.Function):
    """The ring's step over a rank's L local K/V blocks, block j on
    ``devices[j]``: block j to local shard j + 1, the last handed on
    (`_hand_on`, on the first device) as block 0; the backward hands the
    gradients back the other way."""

    @staticmethod
    def forward(ctx, info, devices, *blocks):
        ctx.info, ctx.devices = info, devices
        first = _hand_on(blocks[-1].to(devices[0], non_blocking=True), info, 1)
        return (first,) + tuple(b.to(d, non_blocking=True)
                                for b, d in zip(blocks[:-1], devices[1:]))

    @staticmethod
    def backward(ctx, *grads):
        info, devices = ctx.info, ctx.devices
        last = _hand_on(grads[0], info, -1).to(devices[-1], non_blocking=True)
        return (None, None) + tuple(g.to(d, non_blocking=True)
                                    for g, d in zip(grads[1:], devices[:-1])) + (last,)


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``blocks`` given a zero gradient: the last
    K/V blocks then have a gradient on every rank, so every rank runs
    every rotation's backward, whatever causal masking skipped."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.like = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.like)


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
