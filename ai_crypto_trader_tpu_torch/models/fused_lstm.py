"""The fused LSTM layer, forward: the input projection of every step as one
product before the loop, then one recurrent product and one gate block a
step.

Port of `ai_crypto_trader_tpu/models/fused_lstm.py` (its forward, `_fwd`
and `FusedLSTM`).  Gate order is (i, f, g, o).  All four gates go through
ONE ``tanh`` of the [B, 4H] pre-activation scaled by (½, ½, 1, ½): sigmoid
is σ(x) = ½·tanh(x/2) + ½, so ``torch.sigmoid`` is never called, and the
cell and hidden updates are written as the JAX step writes them.
Everything is time-major ([T, B, ...]).

Scaling by ½ or 1 is exact in binary floating point, so
``(zx + h @ wh) · scale`` has the bits of ``zx · scale + h @ (wh · scale)``
(whatever order the product sums in); the port scales ``zx`` and ``wh``
once before the loop, which saves one operation a step.

The hand-written backward pass of the JAX package (a ``jax.custom_vjp``)
belongs to training and is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ai_crypto_trader_tpu_torch.models.layers import Dense, orthogonal


def _gate_scale(like: torch.Tensor, units: int) -> torch.Tensor:
    """[4H] pre-tanh scale per gate block (i, f, g, o): ½, ½, 1, ½."""
    scale = torch.full((4, units), 0.5, dtype=like.dtype, device=like.device)
    scale[2] = 1.0
    return scale.reshape(4 * units)


def lstm_scan(zx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The recurrent part of an LSTM layer over pre-projected inputs:
    zx [T, B, 4H] (input projections + bias), wh [H, 4H] → hs [T, B, H],
    from a zero carry."""
    T, B, H4 = zx.shape
    H = H4 // 4
    scale = _gate_scale(zx, H)
    zs, ws = zx * scale, wh * scale
    c = h = zx.new_zeros(B, H)
    hs = []
    for t in range(T):
        a = torch.tanh(zs[t] + h @ ws)
        s = a * 0.5 + 0.5                      # σ of the i, f and o blocks
        c = s[:, H:2 * H] * c + s[:, :H] * a[:, 2 * H:3 * H]
        h = s[:, 3 * H:] * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


class FusedLSTM(nn.Module):
    """One LSTM layer over a time-major sequence: [T, B, F] → [T, B, H].

    Parameters: ``wx`` (`Dense` F → 4H, the input projection of all four
    gates, lecun-normal) and ``wh`` [H, 4H] (the recurrent kernel,
    orthogonal), as flax's ``FusedLSTM`` draws them."""

    def __init__(self, in_features: int, units: int, generator: torch.Generator):
        super().__init__()
        self.wx = Dense(in_features, 4 * units, generator)
        self.wh = nn.Parameter(orthogonal(units, 4 * units, generator))

    def forward(self, x):
        T, B, F = x.shape
        zx = self.wx(x.reshape(T * B, F)).reshape(T, B, -1)
        return lstm_scan(zx, self.wh)
