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

The backward pass is the JAX package's hand-written one (its
``jax.custom_vjp``, `_bwd_vjp`) as a ``torch.autograd.Function``: the
forward keeps the post-tanh gate activations ``a_s`` [T, B, 4H], the cell
states and the hidden states; the backward forms the gate cofactors in
bulk (``mq``: one [T, B, 4H] tensor that folds tanh', σ' and the squared
gate scale; ``k1``: o·(1 − tanh² c)), runs one reverse loop of an add, two
multiplies, a concatenation and the recurrent product per step, and takes
the recurrent kernel's gradient as ONE product over all T·B rows.  The
gate gradient ``dg`` is taken with respect to the UNSCALED pre-activation
(``mq`` carries the scale twice), so the carry and ``dwh`` use the saved,
unscaled ``wh``.  `lstm_scan` goes through the Function only while
autograd records an input that needs a gradient; otherwise (serving, its
``vmap``) it runs the plain loop.
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


def _scan(zx: torch.Tensor, wh: torch.Tensor, keep: bool):
    """The forward loop: hs [T, B, H], and when ``keep`` also the gate
    activations a_s [T, B, 4H] and cell states c_s [T, B, H]."""
    T, B, H4 = zx.shape
    H = H4 // 4
    scale = _gate_scale(zx, H)
    zs, ws = zx * scale, wh * scale
    c = h = zx.new_zeros(B, H)
    hs, a_s, c_s = [], [], []
    for t in range(T):
        a = torch.tanh(zs[t] + h @ ws)
        s = a * 0.5 + 0.5                      # σ of the i, f and o blocks
        c = s[:, H:2 * H] * c + s[:, :H] * a[:, 2 * H:3 * H]
        h = s[:, 3 * H:] * torch.tanh(c)
        hs.append(h)
        if keep:
            a_s.append(a)
            c_s.append(c)
    if keep:
        return torch.stack(hs), torch.stack(a_s), torch.stack(c_s)
    return torch.stack(hs)


class LSTMScan(torch.autograd.Function):
    """`lstm_scan` with the JAX package's hand-written backward
    (`fused_lstm.py:79-119`): gradients of zx [T, B, 4H] and wh [H, 4H]."""

    @staticmethod
    def forward(ctx, zx, wh):
        hs, a_s, c_s = _scan(zx, wh, keep=True)
        ctx.save_for_backward(a_s, c_s, hs, wh)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        a_s, c_s, hs, wh = ctx.saved_tensors
        T, B, H4 = a_s.shape
        H = H4 // 4
        whT = wh.T
        i_s = 0.5 * a_s[..., :H] + 0.5
        f_s = 0.5 * a_s[..., H:2 * H] + 0.5
        tc_s = torch.tanh(c_s)
        k1 = (0.5 * a_s[..., 3 * H:] + 0.5) * (1.0 - tc_s * tc_s)
        c_prev = torch.cat([c_s.new_zeros(1, B, H), c_s[:-1]])
        scale = _gate_scale(a_s, H)
        # (1 − a²)·scale²: one scale is tanh's argument scaling, the other dσ = ½·dtanh
        mq = (torch.cat([a_s[..., 2 * H:3 * H], c_prev, i_s, tc_s], dim=-1)
              * (1.0 - a_s * a_s) * (scale * scale))
        dc = dh_carry = dhs.new_zeros(B, H)
        dgs = [None] * T
        for t in range(T - 1, -1, -1):
            dh = dhs[t] + dh_carry
            dc = dc + dh * k1[t]
            dg = torch.cat([dc, dc, dc, dh], dim=-1) * mq[t]
            dgs[t] = dg
            dc, dh_carry = dc * f_s[t], dg @ whT
        dgs = torch.stack(dgs)
        dwh = None
        if ctx.needs_input_grad[1]:
            # the recurrent kernel's gradient as one product over all T·B rows
            h_prev = torch.cat([hs.new_zeros(1, B, H), hs[:-1]])
            dwh = h_prev.reshape(-1, H).T @ dgs.reshape(-1, H4)
        return dgs, dwh


def lstm_scan(zx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The recurrent part of an LSTM layer over pre-projected inputs:
    zx [T, B, 4H] (input projections + bias), wh [H, 4H] → hs [T, B, H],
    from a zero carry.  Through `LSTMScan` while autograd records an input
    that needs a gradient, else the plain loop (the same bits)."""
    if torch.is_grad_enabled() and (zx.requires_grad or wh.requires_grad):
        return LSTMScan.apply(zx, wh)
    return _scan(zx, wh, keep=False)


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
