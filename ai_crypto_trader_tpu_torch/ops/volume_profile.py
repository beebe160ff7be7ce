"""Volume-profile analytics, in PyTorch.

Port of `ai_crypto_trader_tpu/ops/volume_profile.py:25-82`: the typical
price of each candle books its volume into a fixed price grid of
``n_bins`` bins between the window's lowest and highest typical price;
from that histogram come the point of control (POC, the fullest bin), the
value area (the band grown greedily around the POC until it holds 70 % of
the volume) and the high/low-volume nodes.  Inputs are tensors [..., T];
every leading index is its own profile, computed on the tensors' device.

Two choices keep the result the same bits run after run on the card, where
the POC (an argmax) and each growth step (``v_lo >= v_hi``) flip on one
ulp of a bin:

  * the histogram is a fixed-order sum — a one-hot [..., T, n_bins] mask
    times the volume, summed over T — not a scatter-add, whose float
    atomics add in an order that changes from run to run;
  * the growth scan is a fixed loop of ``n_bins`` steps over the whole
    batch, indexing with ``gather`` (no value is read back to the host).

Divisions by a constant are reciprocal multiplies (`device.div_const`), as
the JAX package's compiled program computes them.
"""

from __future__ import annotations

import torch

from ai_crypto_trader_tpu_torch.device import div_const


def volume_profile(high, low, close, volume, n_bins: int = 50,
                   value_area_frac: float = 0.70) -> dict:
    """Per trailing-axis series: ``bin_centers`` and ``histogram`` [...,
    n_bins], ``poc_price``, ``value_area_low``/``high``, ``hvn_mask`` /
    ``lvn_mask`` [..., n_bins] and ``total_volume``."""
    batch, T = tuple(high.shape[:-1]), high.shape[-1]
    h, lo_, c, v = (x.reshape(-1, T) for x in (high, low, close, volume))
    dev = h.device
    tp = div_const(h + lo_ + c, 3.0)
    lo = tp.amin(-1, keepdim=True)
    hi = tp.amax(-1, keepdim=True)
    width = torch.where(hi - lo == 0.0, 1.0, hi - lo)
    idx = ((tp - lo) / width * n_bins).to(torch.int32).clamp(0, n_bins - 1)
    bins = torch.arange(n_bins, dtype=torch.int32, device=dev)
    hist = torch.where(idx[..., None] == bins, v[..., None], 0.0).sum(-2)
    # lo + f·width rounded once (in float64, where f·width is exact), as the
    # JAX package's compiled program forms it with a fused multiply-add
    f = div_const(bins.to(torch.float32) + 0.5, float(n_bins))
    centers = (lo.double() + f.double() * width.double()).float()

    poc = torch.argmax(hist, dim=-1, keepdim=True)
    total = hist.sum(-1, keepdim=True)
    target = value_area_frac * total

    # value area: grow a window around the POC greedily, a fixed n_bins steps
    lo_i, hi_i = poc, poc
    acc = hist.gather(-1, poc)
    for _ in range(n_bins):
        can_lo, can_hi = lo_i > 0, hi_i < n_bins - 1
        nb = hist.gather(-1, torch.cat([(lo_i - 1).clamp_min(0),
                                        (hi_i + 1).clamp_max(n_bins - 1)], -1))
        v_lo = torch.where(can_lo, nb[:, :1], -1.0)
        v_hi = torch.where(can_hi, nb[:, 1:], -1.0)
        take_lo = (v_lo >= v_hi) & can_lo
        grow = ~(acc >= target)
        lo_i = torch.where(grow & take_lo, lo_i - 1, lo_i)
        hi_i = torch.where(grow & ~take_lo & can_hi, hi_i + 1, hi_i)
        acc = acc + torch.where(grow, torch.where(take_lo, v_lo,
                                                  torch.where(can_hi, v_hi, 0.0)), 0.0)

    mean_vol = div_const(total, float(n_bins))
    out = {
        "bin_centers": centers,
        "histogram": hist,
        "poc_price": centers.gather(-1, poc)[:, 0],
        "value_area_low": centers.gather(-1, lo_i)[:, 0],
        "value_area_high": centers.gather(-1, hi_i)[:, 0],
        "hvn_mask": hist > 1.5 * mean_vol,     # high-volume nodes
        "lvn_mask": hist < 0.5 * mean_vol,     # low-volume nodes
        "total_volume": total[:, 0],
    }
    return {k: x.reshape(batch + tuple(x.shape[1:])) for k, x in out.items()}
