"""Prediction with the model zoo: MinMax scaling, sliding windows, one
model's prediction and a batched prediction over many models of one
architecture.

Port of the serving half of `ai_crypto_trader_tpu/models/train.py`
(`Scaler`, `fit_scaler`, `make_windows`, `TrainResult`, `predict_prices`,
`predict_prices_batched`).  A result's ``params`` are the named parameters
of its architecture's module ({name: tensor}); the module itself is a
template per architecture, called with those parameters through
``torch.func.functional_call``.

`predict_prices_batched` keeps the JAX contract: the parameters of N
models that share one architecture stacked along a leading lane axis, one
program over every lane (``torch.func.vmap`` of the template) with the
MinMax transform in it, and ONE host read.  On the card the windows go up
from pinned memory without a synchronizing copy, and the outputs and the
scalers' min/max are packed into one float32 tensor, copied once into
pinned memory with an event recorded; the module-level `host_read` waits on
it.  The stacked parameters and scalers stay on the device between calls
while the results' tensors are the same and unchanged, so a steady
cadence uploads only the windows.  Denormalizing is the JAX package's
arithmetic in the same place: eager tensor ops in `predict_prices`, NumPy
on the host in the batched form.

Training (`train_model`) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
from torch.func import functional_call, vmap

from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.models.layers import meta_template
from ai_crypto_trader_tpu_torch.models.zoo import build_model
from ai_crypto_trader_tpu_torch.ops.tick_engine import Readback, read_packed


class Scaler(NamedTuple):
    """MinMax scaler state: per-feature min and max, float32 tensors."""

    min: torch.Tensor
    max: torch.Tensor

    def transform(self, x):
        rng = self.max - self.min
        return (x - self.min) / torch.where(rng == 0.0, 1.0, rng)

    def inverse(self, x, feature: int = 0):
        rng = self.max - self.min
        return x * torch.where(rng[feature] == 0.0, 1.0, rng[feature]) + self.min[feature]


def fit_scaler(features: np.ndarray, device=None) -> Scaler:
    """The per-column min and max of ``features`` [T, F], as float32
    tensors on ``device``."""
    dev = resolve_device(device)
    f = np.asarray(features)
    return Scaler(to_device(f.min(axis=0), dev, torch.float32),
                  to_device(f.max(axis=0), dev, torch.float32))


def make_windows(features: np.ndarray, seq_len: int = 60,
                 horizons: Sequence[int] = (1,), target_col: int = 0):
    """[T, F] → (X [N, seq_len, F], y [N, H]); the target is column
    ``target_col`` at t + h."""
    T = features.shape[0]
    hmax = max(horizons)
    n = T - seq_len - hmax + 1
    if n <= 0:
        raise ValueError(f"series too short: T={T} seq_len={seq_len} hmax={hmax}")
    idx = np.arange(n)[:, None] + np.arange(seq_len)[None, :]
    X = features[idx]
    y = np.stack([features[np.arange(n) + seq_len + h - 1, target_col]
                  for h in horizons], axis=-1)
    return X.astype(np.float32), y.astype(np.float32)


@dataclass
class TrainResult:
    params: Any                      # {parameter name: tensor} of the architecture's module
    model_type: str
    scaler: Scaler
    model_kwargs: dict = field(default_factory=dict)
    history: list = field(default_factory=list)
    best_val_loss: float = float("inf")
    epochs_run: int = 0
    target_col: int = 0              # feature column the model predicts

    @property
    def features(self) -> int:
        return int(self.scaler.min.shape[-1])

    def model(self) -> torch.nn.Module:
        """The architecture's module holding these parameters, on their
        device."""
        dev = next(iter(self.params.values())).device
        model = build_model(self.model_type, **self.model_kwargs,
                            features=self.features, device=dev)
        model.load_state_dict(self.params)
        return model


def _template(model_type: str, kwargs_key: tuple, features: int) -> torch.nn.Module:
    """The architecture's template: (model_type, kwargs, input width)."""
    return meta_template(("zoo", model_type, kwargs_key, features), lambda: build_model(
        model_type, **dict(kwargs_key), features=features, device="cpu"))


def _kwargs_key(result) -> tuple:
    return tuple(sorted(result.model_kwargs.items()))


@torch.no_grad()
def predict_prices(result: TrainResult, features: np.ndarray, seq_len: int = 60,
                   target_col: int | None = None, device=None) -> dict:
    """Predict the next price from the trailing window, denormalize, and
    take the confidence from the validation loss.

    ``target_col`` defaults to the column the model was trained to
    predict.  The window is sliced before it is scaled (the scaler is
    elementwise)."""
    dev = resolve_device(device)
    if target_col is None:
        target_col = result.target_col
    model = _template(result.model_type, _kwargs_key(result), result.features)
    params = {k: v.to(dev) for k, v in result.params.items()}
    scaler = Scaler(result.scaler.min.to(dev), result.scaler.max.to(dev))
    window_feats = np.asarray(features)[-seq_len:]
    scaled = scaler.transform(to_device(window_feats, dev, torch.float32))
    out = functional_call(model, params, (scaled[None],))
    mean_scaled = out["mean"][0]
    price = scaler.inverse(mean_scaled, target_col).cpu().numpy()
    confidence = float(1.0 / (1.0 + result.best_val_loss * 100.0))
    res = {"predicted_price": price, "confidence": confidence}
    if "log_sigma" in out:
        sigma_scaled = np.exp(out["log_sigma"][0].cpu().numpy())
        rng = (scaler.max[target_col] - scaler.min[target_col]).cpu().numpy()
        res["predicted_std"] = sigma_scaled * rng
    return res


def host_read(readback: Readback) -> dict:
    """THE device→host sync of a batched prediction: wait for its one copy
    into pinned memory and unpack it ({"mean", "log_sigma"?, "smin",
    "smax"} as float32 NumPy arrays).  A module-level seam, so callers can
    count reads."""
    return read_packed(readback)


class _BatchedProgram:
    """One architecture's batched prediction on one device: the vmapped
    template, and the parameters and scalers of the results it was last
    given, stacked along the lane axis."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        def one(params, smin, smax, window):
            rng = smax - smin
            scaled = (window - smin) / torch.where(rng == 0.0, 1.0, rng)
            return functional_call(model, params, (scaled[None],))

        self.fn = vmap(one)
        self.device = device
        self._held: list = []        # every tensor of the last stack, lane by lane
        self._versions: list = []    # and the version counter each had then
        self._stacked = None

    def stacked(self, results: Sequence[TrainResult]):
        """(params, smin, smax) stacked on the device.  Restacked when a
        lane's tensor is another object or was changed in place since the
        last stack (its version counter moved), so updated weights are
        always the ones predicted from.  A change made through ``.data``
        or in inference mode moves no version counter and is not seen."""
        names = list(results[0].params)
        held = [t for r in results
                for t in (*(r.params[k] for k in names), r.scaler.min, r.scaler.max)]
        versions = [None if t.is_inference() else t._version for t in held]
        if (versions != self._versions or len(held) != len(self._held)
                or any(a is not b for a, b in zip(held, self._held))):
            params = {k: self._upload(torch.stack([r.params[k] for r in results]))
                      for k in names}
            smin = self._upload(torch.stack([r.scaler.min for r in results]))
            smax = self._upload(torch.stack([r.scaler.max for r in results]))
            self._held, self._versions = held, versions
            self._stacked = (params, smin, smax)
        return self._stacked

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)


# One batched program per architecture (model_type, kwargs, input width)
# and device, shared by every model instance of that architecture.
_BATCHED_PREDICT_FNS: dict = {}


def _batched_program(model_type: str, kwargs_key: tuple, features: int,
                     device: torch.device) -> _BatchedProgram:
    key = (model_type, kwargs_key, features, str(device))
    prog = _BATCHED_PREDICT_FNS.get(key)
    if prog is None:
        prog = _BATCHED_PREDICT_FNS[key] = _BatchedProgram(
            _template(model_type, kwargs_key, features), device)
    return prog


@torch.no_grad()
def predict_prices_batched(results: Sequence[TrainResult], features_list,
                           seq_len: int = 60, device=None) -> list[dict]:
    """`predict_prices` for N models sharing ONE architecture, as one
    program over a leading lane axis and one host read.  All ``results``
    must share (model_type, model_kwargs, input width); the caller groups
    by architecture.  Per-lane scaling and denormalization are the math of
    `predict_prices`, so the outputs are interchangeable."""
    dev = resolve_device(device)
    r0 = results[0]
    prog = _batched_program(r0.model_type, _kwargs_key(r0), r0.features, dev)
    params, smin, smax = prog.stacked(results)
    windows = torch.from_numpy(np.stack(
        [np.asarray(f, np.float32)[-seq_len:] for f in features_list]))
    if dev.type == "cuda":
        windows = windows.pin_memory()
    out = prog.fn(params, smin, smax, windows.to(dev, non_blocking=True))
    leaves = [(k, out[k]) for k in ("mean", "log_sigma") if k in out]     # [L, 1, H]
    leaves += [("smin", smin), ("smax", smax)]
    packed = torch.cat([v.reshape(-1) for _, v in leaves])
    layout = [(k, tuple(v.shape), np.float32) for k, v in leaves]
    if dev.type == "cuda":
        host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        readback = Readback(host, event, layout)
    else:
        readback = Readback(packed, None, layout)
    got = host_read(readback)                       # one pull, all lanes
    mins, maxs = got["smin"], got["smax"]
    preds = []
    for lane, r in enumerate(results):
        tc = r.target_col
        rng_t = maxs[lane, tc] - mins[lane, tc]
        rng_t = rng_t if rng_t != 0.0 else np.float32(1.0)
        mean_scaled = got["mean"][lane, 0]
        res = {"predicted_price": np.asarray(mean_scaled * rng_t + mins[lane, tc]),
               "confidence": float(1.0 / (1.0 + r.best_val_loss * 100.0))}
        if "log_sigma" in got:
            res["predicted_std"] = np.exp(np.asarray(got["log_sigma"][lane, 0])) * rng_t
        preds.append(res)
    return preds
