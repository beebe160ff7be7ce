"""Feature importance for the model zoo: integrated gradients.

Port of `ai_crypto_trader_tpu/models/importance.py`: the attribution of
each input to the summed ``mean`` output, integrated along the straight
path from a baseline (the windows' mean) in ``steps`` points, averaged
over windows and time per feature and normalized to sum 1.

The JAX package takes one gradient per path point (``vmap`` over the
points).  The zoo's rows never interact at inference, so the gradient of
the sum over every (point, window) row is each row's own gradient: here
the ``steps`` interpolants go into the batch axis and ONE
``torch.autograd.grad`` of the summed output gives them all.  The fused
LSTM's hand-written backward (`fused_lstm.LSTMScan`) carries it through
the recurrent layers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.models.train import _template


def feature_importance(params: dict, model_type: str, X, baseline=None, steps: int = 32,
                       feature_names=None, model_kwargs: dict | None = None,
                       device=None) -> dict:
    """Integrated gradients with respect to the inputs, per feature.

    ``params``: the architecture's {name: tensor}; X: [N, T, F] windows.
    Returns each feature's mean |attribution| normalized to sum 1
    (``importances``, largest first) and the names in that order
    (``ranked``).  Runs on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    X = to_device(X, dev, torch.float32)
    N, T, F = X.shape
    model = _template(model_type, tuple(sorted((model_kwargs or {}).items())), F)
    params = {k: v.detach().to(dev) for k, v in params.items()}
    if baseline is None:
        baseline = X.mean(dim=0, keepdim=True)
    else:
        baseline = to_device(baseline, dev, torch.float32)
    alphas = torch.linspace(0.0, 1.0, steps, device=dev).reshape(steps, 1, 1, 1)
    path = (baseline + alphas * (X - baseline)).reshape(steps * N, T, F).requires_grad_()
    with torch.enable_grad():
        out = functional_call(model, params, (path, False))["mean"].sum()
        (grads,) = torch.autograd.grad(out, path)
    attr = (X - baseline) * grads.reshape(steps, N, T, F).mean(dim=0)        # [N, T, F]
    per_feature = attr.abs().mean(dim=(0, 1))
    total = per_feature.sum()
    weights = (per_feature / torch.where(total == 0, 1.0, total)).cpu().numpy()
    names = feature_names or [f"f{i}" for i in range(weights.shape[0])]
    order = np.argsort(-weights)
    return {"importances": {names[i]: float(weights[i]) for i in order},
            "ranked": [names[i] for i in order]}
