"""Dense causal attention, the single-card form of ring attention.

The port's counterpart of `ai_crypto_trader_tpu/parallel/ring_attention.py`
for one card: `NEG_BIG` and `reference_attention` (:134-143), the dense
oracle that `models.long_context` runs without a mesh.  The ring itself —
the sequence sharded over devices, K/V blocks rotating between them — has
no use on one H100 and is not ported (ROADMAP item 15).
"""

from __future__ import annotations

import torch

from ai_crypto_trader_tpu_torch.device import div_const

NEG_BIG = -1e30


def reference_attention(q, k, v, *, causal: bool = True):
    """Dense attention over [T, H, D] queries, keys and values
    (materializes [H, T, T]): scores in float32 divided by √D, masked with
    NEG_BIG above the diagonal when ``causal``, a float32 softmax, and the
    output cast back to ``q``'s dtype.  Explicit products, not a fused
    attention library call, so the card rounds as the CPU does (with TF32
    off, as the package sets it)."""
    T, H, D = q.shape
    s = div_const(torch.einsum("qhd,khd->hqk", q.float(), k.float()), D ** 0.5)
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)
