"""Synthetic chart-pattern generators: the pattern classifier's training
data.

Port of `ai_crypto_trader_tpu/patterns/synthetic.py`: 14 pattern families
and ``no_pattern``, each a [T] close path ``base + amp · shape(t) +
noise`` over t = linspace(0, 1, T) (``no_pattern`` a random walk), and
`to_ohlcv`, which dresses a close path into the classifier's normalized
[T, 5] OHLCV window (OHLC ÷ the last close, volume ÷ its max).

The shape functions are deterministic tensor code written in the JAX
package's order of operations (its compiled division by a constant is a
multiply by the reciprocal, `device.div_const`).  The draws (each path's
amplitude and noise level, its noise, and the OHLC spread, open noise and
volume) come from a
draw provider with ``path(n, T)``, ``walk(n, T)`` and ``ohlcv(n, T)``
(`GeneratorDraws`, on a ``torch.Generator``'s device; the tests fill one
with JAX's draws), so every generator works on a batch of n paths at once.
"""

from __future__ import annotations

import math

import torch

from ai_crypto_trader_tpu_torch.device import div_const, resolve_device

PATTERN_CLASSES = (
    "head_and_shoulders", "inverse_head_and_shoulders",
    "double_top", "double_bottom",
    "ascending_triangle", "descending_triangle", "symmetric_triangle",
    "rectangle", "flag_bull", "flag_bear",
    "pennant", "cup_and_handle", "rising_wedge", "falling_wedge",
    "no_pattern",
)
N_CLASSES = len(PATTERN_CLASSES)
PI = math.pi


class GeneratorDraws:
    """The generators' draws from one ``torch.Generator``, on its device:

    * ``path(n, T)`` → (u_amp [n], u_level [n], z_noise [n, T]): uniforms
      for the amplitude and the noise level, standard normal noise;
    * ``walk(n, T)`` → (z_steps [n, T], z_noise [n, T]) for ``no_pattern``;
    * ``ohlcv(n, T)`` → (z_open [n, T], z_spread [n, 2, T], z_volume
      [n, T]) for `to_ohlcv`."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _u(self, *shape):
        return torch.rand(shape, generator=self.generator, device=self.generator.device)

    def _z(self, *shape):
        return torch.randn(shape, generator=self.generator, device=self.generator.device)

    def path(self, n: int, T: int):
        return self._u(n), self._u(n), self._z(n, T)

    def walk(self, n: int, T: int):
        return self._z(n, T), self._z(n, T)

    def ohlcv(self, n: int, T: int):
        return self._z(n, T), self._z(n, 2, T), self._z(n, T)


def _draws(draws):
    return GeneratorDraws(draws) if isinstance(draws, torch.Generator) else draws


def _bump(t, center, width, height):
    """Smooth gaussian bump."""
    return height * torch.exp(-0.5 * div_const(t - center, width) ** 2)


def _head_shoulders(t, sign):
    return sign * (_bump(t, 0.2, 0.07, 0.6) + _bump(t, 0.5, 0.08, 1.0)
                   + _bump(t, 0.8, 0.07, 0.6))


def _double(t, sign):
    return sign * (_bump(t, 0.3, 0.08, 1.0) + _bump(t, 0.7, 0.08, 1.0))


def _triangle(t, kind):
    osc = torch.sin(t * 6 * PI)
    if kind == "ascending":             # flat top, rising lows
        return torch.where(osc > 0, osc * 0.2, osc) * (1.0 - t) * 0.5 + t * 0.5
    if kind == "descending":
        return torch.where(osc < 0, osc * 0.2, osc) * (1.0 - t) * 0.5 - t * 0.5
    return osc * (1.0 - t) * 0.5        # symmetric: shrinking envelope


def _rectangle(t):
    return 0.5 * torch.sin(t * 8 * PI)


def _flag(t, sign):
    """Sharp pole then a counter-trend consolidation channel."""
    pole = torch.clamp(div_const(t, 0.3), 0.0, 1.0) * sign
    channel = torch.where(t > 0.3, -sign * (t - 0.3) * 0.3
                          + 0.08 * torch.sin((t - 0.3) * 20 * PI), 0.0)
    return pole + channel


def _pennant(t):
    pole = torch.clamp(div_const(t, 0.3), 0.0, 1.0)
    flagpart = torch.where(t > 0.3, torch.sin((t - 0.3) * 16 * PI)
                           * torch.clamp_min(1.0 - div_const(t - 0.3, 0.7), 0.0) * 0.25, 0.0)
    return pole + flagpart


def _cup_handle(t):
    cup = -_bump(t, 0.4, 0.2, 1.0)
    handle = -_bump(t, 0.85, 0.05, 0.3)
    return cup + handle


def _wedge(t, rising):
    sign = 1.0 if rising else -1.0
    drift = sign * t * 0.8
    osc = torch.sin(t * 8 * PI) * (0.5 - 0.4 * t)   # converging envelope
    return drift + osc


_SHAPES = {
    "head_and_shoulders": lambda t: _head_shoulders(t, 1.0),
    "inverse_head_and_shoulders": lambda t: _head_shoulders(t, -1.0),
    "double_top": lambda t: _double(t, 1.0),
    "double_bottom": lambda t: _double(t, -1.0),
    "ascending_triangle": lambda t: _triangle(t, "ascending"),
    "descending_triangle": lambda t: _triangle(t, "descending"),
    "symmetric_triangle": lambda t: _triangle(t, "symmetric"),
    "rectangle": _rectangle,
    "flag_bull": lambda t: _flag(t, 1.0),
    "flag_bear": lambda t: _flag(t, -1.0),
    "pennant": _pennant,
    "cup_and_handle": _cup_handle,
    "rising_wedge": lambda t: _wedge(t, True),
    "falling_wedge": lambda t: _wedge(t, False),
}


def generate_pattern(draws, label: int, T: int = 60, base: float = 100.0, n: int = 1):
    """n synthetic close paths [n, T] of class index ``label``, with draws
    from ``draws`` (a ``torch.Generator`` or a draw provider), on its
    device."""
    d = _draws(draws)
    if PATTERN_CLASSES[label] == "no_pattern":
        steps, noise = d.walk(n, T)
        return base + torch.cumsum(steps * 0.5, dim=-1) + noise * 0.3
    u_amp, u_level, noise = d.path(n, T)
    # jnp.linspace(0, 1, T)'s float32 values: i · (1 / (T − 1))
    t = div_const(torch.arange(T, dtype=torch.float32, device=noise.device), T - 1)
    amp = 8.0 + 6.0 * u_amp
    level = (0.3 + 0.7 * u_level) * 0.35
    return (base + amp[:, None] * _SHAPES[PATTERN_CLASSES[label]](t)
            + noise * level[:, None])


def to_ohlcv(draws, close):
    """Close paths [n, T] → normalized OHLCV windows [n, T, 5]: OHLC ÷ the
    last close, volume ÷ its max."""
    z_open, z_spread, z_volume = _draws(draws).ohlcv(*close.shape)
    spread = torch.abs(z_spread) * 0.3
    open_ = torch.cat([close[:, :1], close[:, :-1]], dim=-1) + z_open * 0.1
    high = torch.maximum(open_, close) + spread[:, 0]
    low = torch.minimum(open_, close) - spread[:, 1]
    volume = torch.abs(z_volume) + 0.5
    last = close[:, -1:, None]
    ohlc = torch.stack([open_, high, low, close], dim=-1) / last
    vol = (volume / volume.amax(dim=-1, keepdim=True))[..., None]
    return torch.cat([ohlc, vol], dim=-1)


def generate_dataset(generator, n_per_class: int = 64, T: int = 60, device=None):
    """X [(N·C), T, 5] windows and y [N·C] int64 labels, class by class, on
    ``device`` (None: the CUDA card); draws from ``generator`` (a
    ``torch.Generator`` on that device, or a draw provider)."""
    dev = resolve_device(device)
    xs, ys = [], []
    for label in range(N_CLASSES):
        close = generate_pattern(generator, label, T, n=n_per_class)
        xs.append(to_ohlcv(generator, close).to(dev))
        ys.append(torch.full((n_per_class,), label, dtype=torch.int64, device=dev))
    return torch.cat(xs), torch.cat(ys)
