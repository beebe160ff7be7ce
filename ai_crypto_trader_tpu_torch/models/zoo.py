"""The price-prediction model zoo: nine architectures as PyTorch modules.

Port of `ai_crypto_trader_tpu/models/zoo.py` (flax/linen).  Every model
maps ``x`` [B, T, F] to ``{"mean": [B, H]}`` (H = number of horizons, 1
for single-task), plus ``"log_sigma"`` for the probabilistic head, through
``forward(x, train=False, *, generator=None)``.  Dropout is applied only
when ``train`` is true, as flax's ``deterministic=not train``, with flax's
arithmetic (`layers.dropout`); its keep masks are drawn from
``generator``, and train mode at a dropout rate above 0 without one
raises.

Submodules carry the names of their flax scopes (``encoder``,
``RecurrentEncoder_0``, ``rnn_b_1``, ``GRUCell_0``, ``Dense_1``, ...), and
flax names auto-named layers in the order they are constructed, not the
order data flows through them: in ``nn.Dense(1)(nn.relu(nn.Dense(u //
2)(h)))`` the output layer is ``Dense_0``.  The forwards below follow
those names (`convert.model_from_flax` maps flax trees by them).

Unlike flax, a module here is built at a known input width (``features``)
and draws its parameters when built, from an explicit
``torch.Generator`` (flax's initialisers in distribution:
`models.layers`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.models.fused_lstm import FusedLSTM
from ai_crypto_trader_tpu_torch.models.layers import (
    Conv,
    Dense,
    GRUCell,
    LayerNorm,
    MultiHeadDotProductAttention,
    default_generator,
    dropout,
    gru_scan,
    max_pool2,
)


def sinusoidal_positions(seq_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal positional table [seq_len, d_model], built in float64
    NumPy and cast to float32, as the JAX package builds it."""
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10_000.0, (2 * (i // 2)) / d_model)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


_POSITIONS: dict = {}


def _positions_on(seq_len: int, d_model: int, device) -> torch.Tensor:
    """`sinusoidal_positions` on ``device``, made once per (shape, device);
    on the card it goes up from pinned memory, without a synchronizing
    copy."""
    key = (seq_len, d_model, str(device))
    table = _POSITIONS.get(key)
    if table is None:
        host = torch.from_numpy(sinusoidal_positions(seq_len, d_model))
        if torch.device(device).type == "cuda":
            host = host.pin_memory()
        table = _POSITIONS[key] = host.to(device, non_blocking=True)
    return table


def _dropout(x, rate, train, generator):
    return dropout(x, rate, generator) if train else x


class RecurrentEncoder(nn.Module):
    """Stacked LSTM/GRU encoder with inter-layer dropout, [B, T, F] →
    [B, T, H] (2H when bidirectional).

    The LSTM layers (``rnn_{l}``, reverse ``rnn_b_{l}``) run time-major,
    the reverse one over the time-flipped sequence; the GRU layers
    (``GRUCell_{k}``, forward then reverse cell per layer, as flax numbers
    them) run batch-major."""

    def __init__(self, features: int, units: int = 64, num_layers: int = 2,
                 dropout: float = 0.2, cell: str = "lstm", bidirectional: bool = False,
                 *, generator: torch.Generator):
        super().__init__()
        if cell not in ("lstm", "gru"):
            raise ValueError(f"unknown cell {cell!r}")
        self.cell, self.num_layers, self.dropout = cell, num_layers, dropout
        self.bidirectional = bidirectional
        width = features
        for layer in range(num_layers):
            directions = ("", "_b") if bidirectional else ("",)
            for d, suffix in enumerate(directions):
                if cell == "lstm":
                    self.add_module(f"rnn{suffix}_{layer}", FusedLSTM(width, units, generator))
                else:
                    self.add_module(f"GRUCell_{layer * len(directions) + d}",
                                    GRUCell(width, units, generator))
            width = units * len(directions)

    def forward(self, x, train: bool = False, *, generator=None):
        if self.cell == "lstm":
            h = x.transpose(0, 1)                                  # [T, B, F]
            for layer in range(self.num_layers):
                fwd = getattr(self, f"rnn_{layer}")(h)
                if self.bidirectional:
                    bwd = torch.flip(getattr(self, f"rnn_b_{layer}")(torch.flip(h, [0])), [0])
                    h = torch.cat([fwd, bwd], dim=-1)
                else:
                    h = fwd
                h = _dropout(h, self.dropout, train, generator)
            return h.transpose(0, 1)
        k = 2 if self.bidirectional else 1
        for layer in range(self.num_layers):
            fwd = gru_scan(getattr(self, f"GRUCell_{layer * k}"), x)
            if self.bidirectional:
                bwd = torch.flip(gru_scan(getattr(self, f"GRUCell_{layer * k + 1}"),
                                          torch.flip(x, [1])), [1])
                x = torch.cat([fwd, bwd], dim=-1)
            else:
                x = fwd
            x = _dropout(x, self.dropout, train, generator)
        return x


class SingleHead(nn.Module):
    """encoder → last hidden state → Dense(u/2) → relu → Dense(1)."""

    def __init__(self, encoder: RecurrentEncoder, units: int = 64, dropout: float = 0.2,
                 *, generator: torch.Generator):
        super().__init__()
        self.encoder, self.dropout = encoder, dropout
        width = units * (2 if encoder.bidirectional else 1)
        self.Dense_0 = Dense(width, units // 2, generator)
        self.Dense_1 = Dense(units // 2, 1, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        h = self.encoder(x, train, generator=generator)[:, -1, :]
        h = _dropout(F.relu(self.Dense_0(h)), self.dropout, train, generator)
        return {"mean": self.Dense_1(h)}


class CNNLSTM(nn.Module):
    """Conv(k=3) → relu → max-pool → Conv(k=3) → relu → LSTM → Dense(1)."""

    def __init__(self, features: int, units: int = 64, dropout: float = 0.2,
                 *, generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.Conv_0 = Conv(features, units, 3, generator)
        self.Conv_1 = Conv(units, units, 3, generator)
        self.FusedLSTM_0 = FusedLSTM(units, units, generator)
        self.Dense_0 = Dense(units, 1, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        c = max_pool2(F.relu(self.Conv_0(x.transpose(1, 2))))     # [B, C, T/2]
        c = F.relu(self.Conv_1(c))
        h = self.FusedLSTM_0(c.permute(2, 0, 1))[-1]               # last hidden state
        return {"mean": self.Dense_0(_dropout(h, self.dropout, train, generator))}


class AttentionModel(nn.Module):
    """One-layer LSTM encoder + multi-head self-attention, residual
    LayerNorm, mean over time, Dense(u/2) → relu → Dense(1)."""

    def __init__(self, features: int, units: int = 64, num_heads: int = 4,
                 dropout: float = 0.2, *, generator: torch.Generator):
        super().__init__()
        self.RecurrentEncoder_0 = RecurrentEncoder(features, units, 1, dropout,
                                                   generator=generator)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            units, num_heads, units, generator, dropout_rate=dropout)
        self.LayerNorm_0 = LayerNorm(units, generator)
        self.Dense_0 = Dense(units // 2, 1, generator)       # the head, built first
        self.Dense_1 = Dense(units, units // 2, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        h = self.RecurrentEncoder_0(x, train, generator=generator)
        h = self.LayerNorm_0(h + self.MultiHeadDotProductAttention_0(h, train,
                                                                     generator=generator))
        h = h.mean(dim=1)
        return {"mean": self.Dense_0(F.relu(self.Dense_1(h)))}


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_dim: int, dropout: float,
                 *, generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, num_heads, d_model, generator, dropout_rate=dropout)
        self.LayerNorm_0 = LayerNorm(d_model, generator)
        self.Dense_0 = Dense(d_model, ff_dim, generator)
        self.Dense_1 = Dense(ff_dim, d_model, generator)
        self.LayerNorm_1 = LayerNorm(d_model, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        x = self.LayerNorm_0(x + self.MultiHeadDotProductAttention_0(x, train,
                                                                     generator=generator))
        f = self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))
        return self.LayerNorm_1(x + _dropout(f, self.dropout, train, generator))


class TransformerModel(nn.Module):
    """Input projection + sinusoidal positions + transformer blocks, mean
    over time, Dense(d/2) → relu → Dense(1)."""

    def __init__(self, features: int, d_model: int = 64, num_heads: int = 4,
                 num_blocks: int = 2, ff_dim: int = 128, dropout: float = 0.2,
                 *, generator: torch.Generator):
        super().__init__()
        self.d_model = d_model
        self.Dense_0 = Dense(features, d_model, generator)
        self.blocks = [f"TransformerBlock_{i}" for i in range(num_blocks)]
        for name in self.blocks:
            self.add_module(name, TransformerBlock(d_model, num_heads, ff_dim, dropout,
                                                   generator=generator))
        self.Dense_1 = Dense(d_model // 2, 1, generator)     # the head, built first
        self.Dense_2 = Dense(d_model, d_model // 2, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        h = self.Dense_0(x) + _positions_on(x.shape[1], self.d_model, x.device)
        for name in self.blocks:
            h = getattr(self, name)(h, train, generator=generator)
        h = h.mean(dim=1)
        return {"mean": self.Dense_1(F.relu(self.Dense_2(h)))}


class MultitaskModel(nn.Module):
    """Shared two-layer LSTM encoder + one Dense(32) → relu → Dense(1) head
    per horizon (``Dense_{i}`` feeds ``head_h{horizon}``)."""

    def __init__(self, features: int, units: int = 64, dropout: float = 0.2,
                 horizons: Sequence[int] = (1, 3, 5), *, generator: torch.Generator):
        super().__init__()
        self.horizons = tuple(horizons)
        self.RecurrentEncoder_0 = RecurrentEncoder(features, units, 2, dropout,
                                                   generator=generator)
        for i, hz in enumerate(self.horizons):
            self.add_module(f"Dense_{i}", Dense(units, 32, generator))
            self.add_module(f"head_h{hz}", Dense(32, 1, generator))

    def forward(self, x, train: bool = False, *, generator=None):
        h = self.RecurrentEncoder_0(x, train, generator=generator)[:, -1, :]
        outs = [getattr(self, f"head_h{hz}")(F.relu(getattr(self, f"Dense_{i}")(h)))
                for i, hz in enumerate(self.horizons)]
        return {"mean": torch.cat(outs, dim=-1)}


class ProbabilisticModel(nn.Module):
    """Normal(μ, σ) head: μ and log σ (clipped to [−7, 3]) from Dense(1)s."""

    def __init__(self, features: int, units: int = 64, dropout: float = 0.2,
                 *, generator: torch.Generator):
        super().__init__()
        self.RecurrentEncoder_0 = RecurrentEncoder(features, units, 2, dropout,
                                                   generator=generator)
        self.Dense_0 = Dense(units, units // 2, generator)
        self.Dense_1 = Dense(units // 2, 1, generator)
        self.Dense_2 = Dense(units // 2, 1, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        h = self.RecurrentEncoder_0(x, train, generator=generator)[:, -1, :]
        h = F.relu(self.Dense_0(h))
        return {"mean": self.Dense_1(h),
                "log_sigma": torch.clamp(self.Dense_2(h), -7.0, 3.0)}


class EnsembleModel(nn.Module):
    """LSTM + GRU + convolution branches, concatenated, Dense(u) → relu →
    Dense(1)."""

    def __init__(self, features: int, units: int = 64, dropout: float = 0.2,
                 *, generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.RecurrentEncoder_0 = RecurrentEncoder(features, units, 1, dropout, "lstm",
                                                   generator=generator)
        self.RecurrentEncoder_1 = RecurrentEncoder(features, units, 1, dropout, "gru",
                                                   generator=generator)
        self.Conv_0 = Conv(features, units, 3, generator)
        self.Dense_0 = Dense(3 * units, units, generator)
        self.Dense_1 = Dense(units, 1, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        lstm = self.RecurrentEncoder_0(x, train, generator=generator)[:, -1]
        gru = self.RecurrentEncoder_1(x, train, generator=generator)[:, -1]
        c = F.relu(self.Conv_0(x.transpose(1, 2))).mean(dim=-1)
        h = F.relu(self.Dense_0(torch.cat([lstm, gru, c], dim=-1)))
        return {"mean": self.Dense_1(_dropout(h, self.dropout, train, generator))}


def build_model(model_type: str, units: int = 64, dropout: float = 0.2,
                num_layers: int = 2, horizons: Sequence[int] = (1, 3, 5), *,
                features: int = 5, generator: torch.Generator | None = None,
                device=None) -> nn.Module:
    """The architecture ``model_type`` (one of `MODEL_REGISTRY`) over
    ``features`` input columns, its parameters drawn from ``generator`` (a
    CPU generator seeded with 0 if None) and moved to ``device`` (None: the
    CUDA card)."""
    dev = resolve_device(device)
    g = default_generator(generator)
    mt = model_type.lower()
    if mt in ("lstm", "gru", "bidirectional"):
        enc = RecurrentEncoder(features, units, num_layers, dropout,
                               "gru" if mt == "gru" else "lstm",
                               bidirectional=mt == "bidirectional", generator=g)
        model = SingleHead(enc, units, dropout, generator=g)
    elif mt == "cnn_lstm":
        model = CNNLSTM(features, units, dropout, generator=g)
    elif mt == "attention":
        model = AttentionModel(features, units, dropout=dropout, generator=g)
    elif mt == "transformer":
        model = TransformerModel(features, d_model=units, dropout=dropout, generator=g)
    elif mt == "multitask":
        model = MultitaskModel(features, units, dropout, horizons, generator=g)
    elif mt == "probabilistic":
        model = ProbabilisticModel(features, units, dropout, generator=g)
    elif mt == "ensemble":
        model = EnsembleModel(features, units, dropout, generator=g)
    else:
        raise ValueError(f"unknown model type {model_type!r}")
    return model.to(dev)


MODEL_REGISTRY = ("lstm", "gru", "bidirectional", "cnn_lstm", "attention",
                  "transformer", "multitask", "probabilistic", "ensemble")
