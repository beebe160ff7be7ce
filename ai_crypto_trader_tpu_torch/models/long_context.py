"""Long-context transformer: a price model over the FULL candle history.

Port of `ai_crypto_trader_tpu/models/long_context.py:37-113`.  Causal
self-attention over an arbitrarily long candle sequence: one [T, F] series
in (seq-to-seq, the batch axis IS the time axis), a next-step return
prediction out at every position, so one forward pass scores the whole
history.

Without a mesh the attention is `parallel.ring_attention.reference_attention`:
dense, O(H·T²) memory — the [H, T, T] scores of the default 4 heads are
~4.3 GB at T = 16,384 in float32, and autograd keeps a softmax of that
size per block for the backward.  Given a ``mesh`` (`parallel.mesh.Mesh`)
it is `parallel.ring_attention.ring_self_attention`: the sequence split
over the mesh's data axis, K/V blocks rotating between the shards, never
more than one [H, T/n, T/n] block of scores at a time; the projections
stay on the model's device, and gradients flow through the ring.  Any
other ``mesh`` raises ``TypeError``.

The modules carry flax's scope names (``Dense_0`` the input projection,
``LongContextBlock_i`` with ``RingSelfAttention_0``'s ``qkv`` and ``out``,
``Dense_1`` the [d/2, 1] head, built before ``Dense_2``), so
`convert.long_context_from_flax` carries a flax tree across.  The layers
are `models.layers`' (flax's Dense initialisers, LayerNorm with epsilon
1e-6) and the GELU is the tanh form, as flax's ``nn.gelu``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.models.layers import Dense, LayerNorm
from ai_crypto_trader_tpu_torch.models.zoo import _positions_on
from ai_crypto_trader_tpu_torch.parallel.mesh import Mesh
from ai_crypto_trader_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_self_attention)


def _mesh_or_none(mesh):
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"{type(mesh).__name__} is not a parallel.mesh.Mesh; pass one, "
                        "or mesh=None for dense attention")
    return mesh


class RingSelfAttention(nn.Module):
    """Causal multi-head self-attention over [T, d_model]: the ``qkv``
    projection, dense attention (or the ring over ``mesh``), the ``out``
    projection."""

    def __init__(self, d_model: int, num_heads: int, mesh=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.mesh = _mesh_or_none(mesh)
        self.num_heads = num_heads
        self.qkv = Dense(d_model, 3 * d_model, generator)
        self.out = Dense(d_model, d_model, generator)

    def forward(self, x):                        # x: [T, d_model]
        T, d = x.shape
        q, k, v = (a.reshape(T, self.num_heads, d // self.num_heads)
                   for a in torch.split(self.qkv(x), d, dim=-1))
        if self.mesh is None:
            o = reference_attention(q, k, v, causal=True)
        else:
            o = ring_self_attention(q, k, v, self.mesh, causal=True)
        return self.out(o.reshape(T, d))


class LongContextBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_dim: int, mesh=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.RingSelfAttention_0 = RingSelfAttention(d_model, num_heads, mesh,
                                                     generator=generator)
        self.LayerNorm_0 = LayerNorm(d_model, generator)
        self.Dense_0 = Dense(d_model, ff_dim, generator)
        self.Dense_1 = Dense(ff_dim, d_model, generator)
        self.LayerNorm_1 = LayerNorm(d_model, generator)

    def forward(self, x):
        x = self.LayerNorm_0(x + self.RingSelfAttention_0(x))
        f = self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))
        return self.LayerNorm_1(x + f)


class LongContextTransformer(nn.Module):
    """Causal seq-to-seq forecaster: [T, features] → {"mean": [T, 1]}, the
    next-step return prediction at every position.  Its parameters are
    drawn from ``generator`` (default: a CPU generator seeded with 0) and
    live on ``device`` (default: the CUDA card)."""

    def __init__(self, features: int, d_model: int = 64, num_heads: int = 4,
                 num_blocks: int = 2, ff_dim: int = 128, mesh=None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        mesh = _mesh_or_none(mesh)
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.d_model, self.mesh = d_model, mesh
        self.Dense_0 = Dense(features, d_model, g)
        self.blocks = [f"LongContextBlock_{i}" for i in range(num_blocks)]
        for name in self.blocks:
            self.add_module(name, LongContextBlock(d_model, num_heads, ff_dim, mesh,
                                                   generator=g))
        self.Dense_1 = Dense(d_model // 2, 1, g)             # the head, built first
        self.Dense_2 = Dense(d_model, d_model // 2, g)
        self.to(dev)

    def forward(self, x, train: bool = False):   # noqa: ARG002 (zoo API)
        h = self.Dense_0(x) + _positions_on(x.shape[0], self.d_model, x.device)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return {"mean": self.Dense_1(F.gelu(self.Dense_2(h), approximate="tanh"))}


def long_context_loss(model: LongContextTransformer, params, x, y):
    """Per-position MSE against next-step targets ``y`` [T, 1]; positions
    with NaN targets (warmup / final step) are masked out.  ``params``: a
    dict of the model's parameters by name (`torch.func.functional_call`),
    or None for the model's own.  The gradient is autograd's, through the
    ring when the model has a mesh."""
    out = model(x) if params is None else torch.func.functional_call(model, params, (x,))
    ok = ~torch.isnan(y)
    err = torch.where(ok, out["mean"] - torch.nan_to_num(y), 0.0)
    return (err ** 2).sum() / torch.clamp_min(ok.sum(), 1)
