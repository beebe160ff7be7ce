"""The epoch trainer: one epoch's minibatches on the device, one host read.

Port of `ai_crypto_trader_tpu/models/train_loop.py`.  Every training path
of the port (the model zoo's `train_model`, HPO trials, the chart-pattern
classifier) runs its epochs through `EpochTrainer`:

  * the dataset lives on the device as one [N, ...] tensor; an epoch takes
    the first nb·bs entries of a permutation drawn on the device and
    gathers them on the device into [nb, bs, ...] batches;
  * each batch is one forward, one ``torch.autograd.grad`` and one update
    of the port's `Adam`, all in place on the device; dropout draws from an
    explicit ``torch.Generator``;
  * the train loss is summed on the device in batch order, the validation
    loss is computed in the same call, and both come back as ONE [2]
    float32 copy into pinned memory with an event recorded
    (`host_read`, the only device→host sync of an epoch).  The plateau and
    early-stopping logic stays on the host, after that read.

Nothing inside an epoch reads the host: no ``.item()``, ``float()``,
boolean-mask indexing or ``nonzero``.  The JAX package compiles the epoch
into one program with its parameters donated; here the parameters are
updated in place (their version counters move, which `predict_prices_
batched` watches), so a caller that keeps the best parameters holds a
`snapshot_params` copy.

`Adam` is optax's ``inject_hyperparams(adam)`` in optax's order of
operations, with the learning rate a float32 0-d tensor on the device in
``state.hyperparams["learning_rate"]``: the host-side plateau changes it in
place, with no sync and nothing rebuilt.  No library optimizer is used:
``torch.optim.Adam`` rounds in another order.

`matmul_precision` takes the JAX package's precision vocabulary
(`device.PRECISIONS`): ``"f32"``/``None`` keep float32 matmuls (TF32 off,
as the package sets it at import), ``"tf32"`` allows TF32 and ``"bf16"``
bfloat16 inside the context; on exit the matmul precision and both TF32
flags are restored.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import (
    canonical_precision, div_const, resolve_device, to_device)
from ai_crypto_trader_tpu_torch.ops.tick_engine import Readback, read_packed, stage
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof

# canonical precision name → torch.set_float32_matmul_precision's
_TORCH_PRECISION = {"float32": "highest", "highest": "highest",
                    "tensorfloat32": "high", "bfloat16": "medium"}


@contextlib.contextmanager
def matmul_precision(precision: str | None):
    """float32 matmuls at ``precision`` inside the context (None: as set)."""
    p = canonical_precision(precision)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        if p is not None:
            torch.set_float32_matmul_precision(_TORCH_PRECISION[p])
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]


def host_read(readback: Readback) -> np.ndarray:
    """THE per-epoch device→host sync: wait for the epoch's one copy of its
    metrics into pinned memory → float32 NumPy [2] ([train_loss, val_loss]).
    A module-level seam, so tests can count reads.  Timed into the
    ``host_read`` SLO window: this is the only sync of an epoch, so a
    device-queue stall surfaces here first."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():   # THE sanctioned device→host sync
        out = read_packed(readback)["metrics"]
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


def snapshot_params(params: dict) -> dict:
    """A detached device copy of every tensor of ``params`` ({name:
    tensor}): the best-params snapshot, which later in-place updates do not
    touch."""
    return {k: v.detach().clone() for k, v in params.items()}


class AdamState(NamedTuple):
    count: torch.Tensor              # int32 0-d: updates made
    mu: dict                         # first moments, {name: tensor}
    nu: dict                         # second moments
    hyperparams: dict                # {"learning_rate": float32 0-d tensor}


# optax.adam's defaults, as float32 values: inject_hyperparams holds every
# hyperparameter as a float32 array, so 1 − b1 and 1 − b2 are float32
# differences (eps_root is 0 and drops out: nu is never negative)
B1, B2, EPS = (float(np.float32(v)) for v in (0.9, 0.999, 1e-8))
C1, C2 = (float(np.float32(1.0) - np.float32(v)) for v in (0.9, 0.999))
# plain ``optax.scale_by_adam()`` (the DQN's form) takes its defaults as
# Python floats: 1 − b1 and 1 − b2 are Python differences, each rounded once
# to float32 (1 − b1 = 0.1f, where the injected form has 0.100000024)
PLAIN_C1, PLAIN_C2 = (float(np.float32(1.0 - v)) for v in (0.9, 0.999))


@torch.no_grad()
def adam_direction(grads: dict, count, mu: dict, nu: dict, c1: float = C1, c2: float = C2):
    """One Adam step's moments and direction in optax's order of operations:
    ``mu = c1·g + b1·mu``, ``nu = c2·g² + b2·nu``, ``count += 1``, ``u =
    (mu / (1 − b1^count)) / (sqrt(nu / (1 − b2^count)) + eps)``.  ``count``
    is an int32 tensor: 0-d, or [P] for a stack of P optimizers whose
    moments lead with the member axis.  Returns (count, mu, nu, u)."""
    count = count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, B1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, B2), t)
    new_mu, new_nu, u = {}, {}, {}
    for k, g in grads.items():
        lead = (1,) * (g.dim() - t.dim())
        b1c, b2c = bc1.reshape(bc1.shape + lead), bc2.reshape(bc2.shape + lead)
        new_mu[k] = c1 * g + B1 * mu[k]
        new_nu[k] = c2 * (g * g) + B2 * nu[k]
        u[k] = (new_mu[k] / b1c) / (correct_sqrt(new_nu[k] / b2c) + EPS)
    return count, new_mu, new_nu, u


def correct_sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt(x)`` rounded correctly, as XLA's: through float64,
    whose root of a float32 value rounds to the float32 one.  PyTorch's
    CPU ``sqrt`` of float32 misses by an ulp on ~0.7 % of inputs."""
    return torch.sqrt(x.double()).float()


class Adam:
    """optax ``inject_hyperparams(adam)(learning_rate)``: per update,
    `adam_direction` with the injected constants, then ``p += (−lr)·u`` —
    in place on the parameters."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: dict) -> AdamState:
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v, memory_format=torch.contiguous_format)  # noqa: E731
                         for k, v in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros(),
                         {"learning_rate": torch.full((), self.learning_rate,
                                                      dtype=torch.float32, device=dev)})

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> AdamState:
        """Apply one update to ``params`` in place; the new state."""
        count, mu, nu, u = adam_direction(grads, state.count, state.mu, state.nu)
        neg_lr = -state.hyperparams["learning_rate"]
        for k, uk in u.items():
            params[k].add_(neg_lr * uk)
        return AdamState(count, mu, nu, state.hyperparams)


def permutation(draw, n: int, device) -> torch.Tensor:
    """A permutation of range(n) on ``device``: drawn with ``torch.randperm``
    from ``draw`` when it is a ``torch.Generator`` (on its device, then
    moved), else ``draw`` itself (a permutation handed over) as int64 on
    ``device``."""
    if isinstance(draw, torch.Generator):
        return torch.randperm(n, generator=draw, device=draw.device).to(device)
    return to_device(draw, device, torch.int64)


class EpochTrainer:
    """`train_loss_fn` + `tx` over whole epochs on the device.

    train_loss_fn(params, xb, yb, generator) -> scalar loss (``generator``:
        the dropout generator)
    eval_loss_fn(params, X_val, y_val) -> scalar loss (optional; run in
        the same call, without autograd)

    The epochs run on ``device`` (None: the CUDA card).  `epoch(...)`
    returns (params, opt_state, metrics): the parameters
    (updated in place), the optimizer state, and the staged [2] float32
    metrics [mean train loss, val loss] (val repeats the train loss without
    an eval function).  Read them with `host_read(metrics)`, once an epoch.
    """

    def __init__(self, train_loss_fn: Callable, tx: Adam, *,
                 eval_loss_fn: Callable | None = None, precision: str | None = None,
                 card: str = "train_epoch", device=None):
        self.train_loss_fn, self.eval_loss_fn, self.tx = train_loss_fn, eval_loss_fn, tx
        self.precision = canonical_precision(precision)
        # devprof cost-card name: cards are one-shot PER NAME, so callers
        # that train several architectures pass e.g. "train_epoch.lstm"
        self.card = card
        # (X, y, val, batch) shapes already trained once: the recompile
        # sentinel's cold-run ledger
        self._watched_shapes: set = set()
        self.device = resolve_device(device)

    def epoch(self, params: dict, opt_state: AdamState, X, y, perm_draw, drop_gen,
              X_val=None, y_val=None, *, batch_size: int):
        """One epoch on the trainer's device (the data and parameters
        should already be there): ``perm_draw`` is a ``torch.Generator`` or
        a permutation of range(len(X)) (`permutation`), ``drop_gen`` the
        dropout generator (None when the model drops nothing).

        With `utils.devprof` active the first epoch takes the ``self.card``
        cost card and checks that the parameters were updated in place
        (the same storages after it), and every epoch feeds the
        ``train_step`` SLO window (the epoch's dispatch wall per batch);
        with `utils.meshprof` active each epoch is a ``self.card`` watch
        window (a never-seen shape is cold)."""
        dp = devprof.active()
        if dp is None and meshprof.active() is None:
            return self._epoch(params, opt_state, X, y, perm_draw, drop_gen, X_val, y_val,
                               batch_size=batch_size)
        donation = (devprof.donated(inplace=params)
                    if not devprof.has_card(self.card) else None)
        shape_key = (tuple(X.shape), tuple(y.shape),
                     tuple(X_val.shape) if X_val is not None else None, batch_size)
        cold = shape_key not in self._watched_shapes
        self._watched_shapes.add(shape_key)
        t0 = time.perf_counter()
        with meshprof.watch(self.card, cold=cold):
            with devprof.carding(self.card, (params, opt_state, X, y, X_val, y_val),
                                 inplace=params, device=self.device) as card:
                out = card.result(self._epoch(params, opt_state, X, y, perm_draw, drop_gen,
                                              X_val, y_val, batch_size=batch_size))
        if dp is not None:
            n = X.shape[0]
            dp.observe_latency("train_step",
                               (time.perf_counter() - t0) / max(n // min(batch_size, n), 1))
            if donation is not None:
                devprof.verify_donation(self.card, donation, after=out[0])
        return out

    def _epoch(self, params: dict, opt_state: AdamState, X, y, perm_draw, drop_gen,
               X_val, y_val, *, batch_size: int):
        X, y = X.to(self.device), y.to(self.device)
        if X_val is not None:
            X_val, y_val = X_val.to(self.device), y_val.to(self.device)
        n = X.shape[0]
        bs = min(batch_size, n)
        nb = max(n // bs, 1)
        idx = permutation(perm_draw, n, X.device)[: nb * bs].reshape(nb, bs)
        Xb, yb = X[idx], y[idx]                      # [nb, bs, ...], gathered on the device
        names = list(params)
        leaves = [params[k].requires_grad_() for k in names]
        with matmul_precision(self.precision):
            loss_sum = X.new_zeros((), dtype=torch.float32)
            for i in range(nb):
                loss = self.train_loss_fn(params, Xb[i], yb[i], drop_gen)
                grads = torch.autograd.grad(loss, leaves)
                opt_state = self.tx.update(dict(zip(names, grads)), opt_state, params)
                loss_sum = loss_sum + loss.detach()
            train = div_const(loss_sum, nb)
            if self.eval_loss_fn is None:
                val = train
            else:
                with torch.no_grad():
                    val = self.eval_loss_fn(params, X_val, y_val)
            metrics = torch.stack([train, val.to(torch.float32)])
        return params, opt_state, stage(metrics, [("metrics", (2,), np.float32)])
