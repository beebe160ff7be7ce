"""flax.linen's layers as the model zoo and the pattern classifier use them.

Each layer computes what its flax counterpart computes, in the same order
of operations where the order sets the rounding, and draws its parameters
as flax's initialisers do, in distribution (from an explicit
``torch.Generator``):

  * `Dense` — flax ``nn.Dense``: ``x @ kernel + bias``; lecun-normal kernel
    (a normal truncated to ±2 standard deviations, variance 1 / fan-in),
    zero bias.  The weight is stored in torch's [out, in] layout;
  * `Conv` — flax ``nn.Conv(features, (k,), padding="SAME")`` for odd k,
    over [B, C, T] (torch's layout; flax's is [B, T, C]); lecun-normal with
    fan-in k · C_in;
  * `LayerNorm` — flax ``nn.LayerNorm()``: epsilon 1e-6 and the fast
    variance, mean(x²) − mean(x)² clamped at 0; ``(x − mean) ·
    (rsqrt(var + ε) · scale) + bias``;
  * `MultiHeadDotProductAttention` — flax's, called as ``(x, x)``: the
    query divided by √head_dim before the logits, a float32 softmax, in
    train mode attention dropout on the softmax weights (one [1, 1, T, T]
    keep mask shared by every batch row and head, flax's
    ``broadcast_dropout``); query/key/value/out as `Dense` layers over the
    flattened (heads, head_dim) axis;
  * `GRUCell` — flax ``nn.GRUCell`` over a batch-major sequence (`gru_scan`):
    r, z = σ(x W_i + b_i + h W_h), n = tanh(x W_in + b_in + r ⊙ (h W_hn +
    b_hn)), h' = (1 − z) ⊙ n + z ⊙ h; orthogonal recurrent kernels without
    a bias but for ``hn``.

`dropout` is flax ``nn.Dropout``'s arithmetic.  Its keep mask comes from an
explicit ``torch.Generator`` (torch's global generator is never drawn
from), so a training run is reproduced by reseeding its generator.

No library-fused recurrent or attention layer is used: each rounds
differently from the flax layer it would replace.  The `convert` module
carries flax parameter trees across into these layouts.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ai_crypto_trader_tpu_torch.device import div_true

# The standard deviation of a standard normal truncated to [-2, 2]: flax's
# variance-scaling initialiser divides by it so the truncated draw keeps
# the variance it asks for.
_TRUNCATED_STD = 0.87962566103423978
LAYER_NORM_EPSILON = 1e-6


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2] (inverse-CDF sampling), on
    the generator's device."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, device=generator.device).uniform_(lo, hi, generator=generator)
    return torch.erfinv(u) * math.sqrt(2.0)


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal()``: truncated normal with variance 1 / fan_in."""
    return truncated_normal(shape, generator) * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)


def orthogonal(n_rows: int, n_cols: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal()`` for an [n_rows, n_cols] kernel: the Q of a
    normal matrix's QR, signs fixed by R's diagonal, with orthonormal rows
    when the kernel is wider than tall."""
    wide = n_rows < n_cols
    a = torch.empty((n_cols, n_rows) if wide else (n_rows, n_cols),
                    device=generator.device).normal_(generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q.T.contiguous() if wide else q


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    """``generator``, or a CPU generator seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def keep_mask(shape, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Dropout's keep mask over ``shape``: ``uniform < 1 − rate`` (flax's
    ``random.bernoulli(rng, 1 − rate, shape)``), drawn from ``generator`` on
    its device.  Raises without a generator."""
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in train mode needs a torch.Generator")
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return u < 1.0 - rate


def dropout(x, rate: float, generator: torch.Generator | None, shape=None):
    """flax ``nn.Dropout(rate)`` in train mode: ``where(keep, x / keep_prob,
    0)`` with the keep mask over ``shape`` (default ``x.shape``; a shape
    with ones broadcasts the mask) from ``generator``, moved to ``x``'s
    device.  Rate 0 returns ``x``, rate 1 zeros, as flax does."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = keep_mask(x.shape if shape is None else shape, rate, generator).to(x.device)
    return torch.where(keep, div_true(x, 1.0 - rate), 0.0)


# Modules on the meta device, one per architecture: they hold no weights,
# and `torch.func.functional_call` swaps each call's parameters in.
_TEMPLATES: dict = {}


def meta_template(key: tuple, build) -> nn.Module:
    """The meta-device copy of ``build()`` (a module built on the CPU),
    made once for each ``key``."""
    model = _TEMPLATES.get(key)
    if model is None:
        model = _TEMPLATES[key] = build().to("meta")
    return model


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, weight stored [out, in]."""

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal(
            (out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features, device=generator.device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """flax ``nn.Conv(out, (k,), padding="SAME")`` for an odd k, over
    [B, C_in, T] → [B, C_out, T]."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 generator: torch.Generator):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"SAME padding is symmetric only for an odd kernel, not {kernel_size}")
        self.weight = nn.Parameter(lecun_normal(
            (out_features, in_features, kernel_size), kernel_size * in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features, device=generator.device))

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, padding=self.weight.shape[-1] // 2)


def max_pool2(x):
    """flax ``nn.max_pool(x, (2,), strides=(2,))`` (VALID) over [B, C, T]:
    T → ⌊T/2⌋."""
    return F.max_pool1d(x, 2, 2)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis."""

    def __init__(self, features: int, generator: torch.Generator):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=generator.device))
        self.bias = nn.Parameter(torch.zeros(features, device=generator.device))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPSILON) * self.scale
        return (x - mean) * mul + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features,
    dropout_rate)`` self-attention over [B, T, in] (out features = in)."""

    def __init__(self, in_features: int, num_heads: int, qkv_features: int,
                 generator: torch.Generator, dropout_rate: float = 0.0):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"{qkv_features} features do not split into {num_heads} heads")
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        self.query = Dense(in_features, qkv_features, generator)
        self.key = Dense(in_features, qkv_features, generator)
        self.value = Dense(in_features, qkv_features, generator)
        self.out = Dense(qkv_features, in_features, generator)

    def forward(self, x, train: bool = False, *, generator: torch.Generator | None = None):
        B, T, _ = x.shape
        heads = lambda t: t.view(B, T, self.num_heads, -1)  # noqa: E731
        depth = self.query.weight.shape[0] // self.num_heads
        q = heads(self.query(x)) / math.sqrt(depth)
        k, v = heads(self.key(x)), heads(self.value(x))
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if train and self.dropout_rate > 0.0:
            # flax: weights × (keep / keep_prob), one mask for every row and head
            keep = keep_mask((1, 1, T, T), self.dropout_rate, generator)
            w = w * div_true(keep.to(w.device, w.dtype), 1.0 - self.dropout_rate)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(a.reshape(B, T, -1))


class GRUCell(nn.Module):
    """flax ``nn.GRUCell(features)``.  ``wi`` holds the input kernels of the
    ir, iz and in gates side by side (with their biases), ``wh`` [H, 3H]
    the recurrent kernels hr, hz, hn, and ``bhn`` the bias of hn."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator):
        super().__init__()
        self.wi = Dense(in_features, 3 * features, generator)
        self.wh = nn.Parameter(torch.cat(
            [orthogonal(features, features, generator) for _ in range(3)], dim=1))
        self.bhn = nn.Parameter(torch.zeros(features, device=generator.device))


def gru_scan(cell: GRUCell, x):
    """A GRU over a batch-major sequence [B, T, F] → [B, T, H] from a zero
    carry (flax ``nn.RNN(GRUCell)``).  The input projections of every step
    are one product, taken before the loop."""
    B, T, _ = x.shape
    H = cell.bhn.shape[0]
    xi = cell.wi(x)
    h = x.new_zeros(B, H)
    hs = []
    for t in range(T):
        gh = h @ cell.wh
        xt = xi[:, t]
        rz = torch.sigmoid(xt[:, :2 * H] + gh[:, :2 * H])
        n = torch.tanh(xt[:, 2 * H:] + rz[:, :H] * (gh[:, 2 * H:] + cell.bhn))
        z = rz[:, H:]
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)
