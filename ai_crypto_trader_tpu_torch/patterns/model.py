"""Chart-pattern classifier: CNN / LSTM / CNN-LSTM over OHLCV windows.

Port of `ai_crypto_trader_tpu/patterns/model.py`: 15-class softmax
classifiers, the preprocess (OHLC ÷ last close, volume ÷ max), every
overlapping window (seq_len 60, stride 5) scored in one batched forward
pass and one host read, the softmax averaged over windows, the top 3, a
primary pattern only above the confidence threshold, the completion
heuristic and each pattern's trading implications; and
`train_pattern_model`, which trains a classifier on the synthetic
generators (`patterns.synthetic`, where `PATTERN_CLASSES` lives) with
integer-label cross-entropy through `models.train_loop.EpochTrainer`, one
host read an epoch.

Submodules carry the names of their flax scopes, and a recognizer's
``params`` are the named parameters of its classifier's module ({name:
tensor}), called through ``torch.func.functional_call`` on a template per
(model type, window length).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.nn import functional as F

from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.models import train_loop
from ai_crypto_trader_tpu_torch.models.fused_lstm import FusedLSTM
from ai_crypto_trader_tpu_torch.models.layers import (
    Conv, Dense, default_generator, dropout, max_pool2, meta_template)
from ai_crypto_trader_tpu_torch.models.train_loop import Adam, EpochTrainer
from ai_crypto_trader_tpu_torch.patterns.synthetic import (  # noqa: F401 — re-exported
    N_CLASSES, PATTERN_CLASSES, generate_dataset)

OHLCV = 5


def _center(x):
    """Per-window channel standardization over time (the population
    standard deviation, plus 1e-6)."""
    mean = x.mean(dim=1, keepdim=True)
    std = x.std(dim=1, keepdim=True, unbiased=False)
    return (x - mean) / (std + 1e-6)


def _dropout(x, train, generator):
    return dropout(x, 0.3, generator) if train else x


class PatternCNN(nn.Module):
    """Two Conv(k=5) → relu → max-pool stages, flattened time-major,
    Dense(128) → relu → Dense(15).  The flattened width depends on the
    window length."""

    def __init__(self, generator: torch.Generator, seq_len: int = 60):
        super().__init__()
        self.Conv_0 = Conv(OHLCV, 32, 5, generator)
        self.Conv_1 = Conv(32, 64, 5, generator)
        self.Dense_0 = Dense(seq_len // 2 // 2 * 64, 128, generator)
        self.Dense_1 = Dense(128, N_CLASSES, generator)

    def forward(self, x, train: bool = False, *, generator=None):   # [B, T, 5]
        c = _center(x).transpose(1, 2)
        for conv in (self.Conv_0, self.Conv_1):
            c = max_pool2(F.relu(conv(c)))
        flat = c.transpose(1, 2).reshape(c.shape[0], -1)  # [B, T', C] row-major, as flax
        return self.Dense_1(_dropout(F.relu(self.Dense_0(flat)), train, generator))


class PatternLSTM(nn.Module):
    """LSTM-64 → last hidden state → Dense(64) → relu → Dense(15)."""

    def __init__(self, generator: torch.Generator, seq_len: int = 60):
        super().__init__()
        self.FusedLSTM_0 = FusedLSTM(OHLCV, 64, generator)
        self.Dense_0 = Dense(64, 64, generator)
        self.Dense_1 = Dense(64, N_CLASSES, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        h = self.FusedLSTM_0(_center(x).transpose(0, 1))[-1]
        return self.Dense_1(_dropout(F.relu(self.Dense_0(h)), train, generator))


class PatternCNNLSTM(nn.Module):
    """Conv(k=5) → relu → max-pool → LSTM-64 → last hidden → Dense(15)."""

    def __init__(self, generator: torch.Generator, seq_len: int = 60):
        super().__init__()
        self.Conv_0 = Conv(OHLCV, 32, 5, generator)
        self.FusedLSTM_0 = FusedLSTM(32, 64, generator)
        self.Dense_0 = Dense(64, N_CLASSES, generator)

    def forward(self, x, train: bool = False, *, generator=None):
        c = max_pool2(F.relu(self.Conv_0(_center(x).transpose(1, 2))))
        h = self.FusedLSTM_0(c.permute(2, 0, 1))[-1]
        return self.Dense_0(_dropout(h, train, generator))


_CLASSIFIERS = {"cnn": PatternCNN, "lstm": PatternLSTM, "cnn_lstm": PatternCNNLSTM}


def _build(model_type: str, generator: torch.Generator | None = None, device=None,
           seq_len: int = 60) -> nn.Module:
    """The classifier ``model_type`` for windows of ``seq_len`` candles,
    its parameters drawn from ``generator`` (a CPU generator seeded with 0
    if None) and moved to ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    return _CLASSIFIERS[model_type](default_generator(generator), seq_len).to(dev)


# Per-pattern trading implications, confirmation & invalidation rules.
PATTERN_IMPLICATIONS = {
    "head_and_shoulders": {"bias": "bearish", "action": "consider_exit",
                           "confirmation": "neckline break on volume",
                           "invalidation": "close above right shoulder"},
    "inverse_head_and_shoulders": {"bias": "bullish", "action": "consider_entry",
                                   "confirmation": "neckline break on volume",
                                   "invalidation": "close below right shoulder"},
    "double_top": {"bias": "bearish", "action": "consider_exit",
                   "confirmation": "break below valley",
                   "invalidation": "close above tops"},
    "double_bottom": {"bias": "bullish", "action": "consider_entry",
                      "confirmation": "break above peak",
                      "invalidation": "close below bottoms"},
    "ascending_triangle": {"bias": "bullish", "action": "watch_breakout",
                           "confirmation": "break above resistance",
                           "invalidation": "break below rising support"},
    "descending_triangle": {"bias": "bearish", "action": "watch_breakdown",
                            "confirmation": "break below support",
                            "invalidation": "break above falling resistance"},
    "symmetric_triangle": {"bias": "neutral", "action": "watch_breakout",
                           "confirmation": "directional break on volume",
                           "invalidation": "failed break / chop"},
    "rectangle": {"bias": "neutral", "action": "range_trade",
                  "confirmation": "range boundary break",
                  "invalidation": "mid-range churn"},
    "flag_bull": {"bias": "bullish", "action": "consider_entry",
                  "confirmation": "break above flag channel",
                  "invalidation": "break below channel low"},
    "flag_bear": {"bias": "bearish", "action": "consider_exit",
                  "confirmation": "break below flag channel",
                  "invalidation": "break above channel high"},
    "pennant": {"bias": "continuation", "action": "watch_breakout",
                "confirmation": "break in pole direction",
                "invalidation": "break against pole"},
    "cup_and_handle": {"bias": "bullish", "action": "consider_entry",
                       "confirmation": "break above handle high",
                       "invalidation": "close below cup midpoint"},
    "rising_wedge": {"bias": "bearish", "action": "consider_exit",
                     "confirmation": "break below wedge support",
                     "invalidation": "break above wedge"},
    "falling_wedge": {"bias": "bullish", "action": "consider_entry",
                      "confirmation": "break above wedge resistance",
                      "invalidation": "break below wedge"},
    "no_pattern": {"bias": "neutral", "action": "none",
                   "confirmation": "", "invalidation": ""},
}


def preprocess_window(ohlcv_window: torch.Tensor) -> torch.Tensor:
    """[..., T, 5] raw OHLCV → normalized: OHLC ÷ the last close, volume ÷
    its max (÷ 1 where the max is 0)."""
    ohlc = ohlcv_window[..., :4] / ohlcv_window[..., -1:, 3:4]
    vmax = ohlcv_window[..., 4].amax(dim=-1, keepdim=True)
    vol = (ohlcv_window[..., 4] / torch.where(vmax == 0, 1.0, vmax))[..., None]
    return torch.cat([ohlc, vol], dim=-1)


def _template(model_type: str, seq_len: int) -> nn.Module:
    return meta_template(("pattern", model_type, seq_len),
                         lambda: _build(model_type, device="cpu", seq_len=seq_len))


@dataclass
class PatternRecognizer:
    model_type: str = "cnn"
    params: Any = None               # {parameter name: tensor} of the classifier's module
    history: list = field(default_factory=list)
    # False marks a random-init recognizer: services tag what it publishes
    # "untrained" so downstream consumers can gate
    trained: bool = True

    def logits(self, x, train: bool = False, *, generator=None):
        return functional_call(_template(self.model_type, x.shape[1]), self.params, (x, train),
                               {"generator": generator})


def train_pattern_model(generator: torch.Generator, model_type: str = "cnn", *,
                        n_per_class: int = 64, epochs: int = 10, batch_size: int = 64,
                        learning_rate: float = 1e-3, T: int = 60,
                        precision: str | None = None, verbose: bool = False,
                        device=None) -> PatternRecognizer:
    """Train the classifier ``model_type`` on the synthetic generators:
    ``n_per_class`` windows of ``T`` candles per class, Adam, integer-label
    cross-entropy, each epoch through `EpochTrainer` with one host read.
    Every draw (the dataset, the initial parameters, the permutations,
    dropout) comes from ``generator``, a ``torch.Generator`` on ``device``
    (None: the CUDA card)."""
    dev = resolve_device(device)
    X, y = generate_dataset(generator, n_per_class, T, device=dev)
    model = _template(model_type, T)
    params = {k: v.detach() for k, v in
              _build(model_type, generator, device=dev, seq_len=T).named_parameters()}
    tx = Adam(learning_rate)
    opt_state = tx.init(params)

    def loss_fn(p, xb, yb, gen):
        return F.cross_entropy(functional_call(model, p, (xb, True), {"generator": gen}), yb)

    trainer = EpochTrainer(loss_fn, tx, precision=precision, card="train_epoch.pattern_cnn",
                           device=dev)
    rec = PatternRecognizer(model_type=model_type)
    for epoch in range(epochs):
        params, opt_state, metrics = trainer.epoch(params, opt_state, X, y, generator,
                                                   generator, batch_size=batch_size)
        ep_loss = float(train_loop.host_read(metrics)[0])      # one sync an epoch
        rec.history.append({"epoch": epoch, "loss": ep_loss})
        if verbose:
            print(f"pattern {model_type} epoch {epoch}: {ep_loss:.4f}")
    rec.params = {k: v.detach() for k, v in params.items()}
    return rec


@torch.no_grad()
def _window_probs(params, model_type: str, ohlcv: torch.Tensor, seq_len: int, stride: int):
    """Every overlapping window of ``ohlcv`` [T, 5] scored in one batched
    forward pass: [n_windows, 15] softmax probabilities on its device."""
    windows = ohlcv.unfold(0, seq_len, stride).transpose(1, 2)    # [n_win, seq_len, 5]
    logits = functional_call(_template(model_type, seq_len), params,
                             (preprocess_window(windows),))
    return torch.softmax(logits, dim=-1)


def pattern_completion(probs_per_window: np.ndarray, primary: int) -> float:
    """Heuristic completion: how far through the window sequence the
    pattern's probability peaked."""
    p = probs_per_window[:, primary]
    if p.size == 0 or p.max() <= 0:
        return 0.0
    return float((np.argmax(p) + 1) / p.size)


def detect_patterns(rec: PatternRecognizer, ohlcv: np.ndarray, *,
                    seq_len: int = 60, stride: int = 5,
                    confidence_threshold: float = 0.5, device=None) -> dict:
    """Averaged softmax over overlapping windows → top 3; a primary pattern
    needs a probability above the threshold.

    ohlcv: [T, 5] raw (open, high, low, close, volume).  The recognizer's
    parameters should already be on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    if np.shape(ohlcv)[0] < seq_len:
        return {"detected": False, "reason": "insufficient_data"}
    params = {k: v.to(dev) for k, v in rec.params.items()}
    probs = _window_probs(params, rec.model_type, to_device(ohlcv, dev, torch.float32),
                          seq_len, stride).cpu().numpy()
    avg = probs.mean(axis=0)
    top3_idx = np.argsort(-avg)[:3]
    top3 = [{"pattern": PATTERN_CLASSES[i], "probability": float(avg[i])}
            for i in top3_idx]
    primary = int(top3_idx[0])
    detected = (avg[primary] > confidence_threshold
                and PATTERN_CLASSES[primary] != "no_pattern")
    out = {
        "detected": bool(detected),
        "top_patterns": top3,
        "all_probabilities": {PATTERN_CLASSES[i]: float(avg[i])
                              for i in range(len(avg))},
    }
    if detected:
        name = PATTERN_CLASSES[primary]
        out.update({
            "primary_pattern": name,
            "confidence": float(avg[primary]),
            "completion": pattern_completion(probs, primary),
            "implications": PATTERN_IMPLICATIONS[name],
        })
    return out
