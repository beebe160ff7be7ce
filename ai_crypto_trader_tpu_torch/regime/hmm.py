"""Gaussian HMM in log space: forward-backward, Baum-Welch and Viterbi.

Port of `ai_crypto_trader_tpu/regime/hmm.py` (the reference's
``hmmlearn.GaussianHMM`` with diagonal Gaussian emissions).  The forward
and backward recursions accumulate with logsumexp over time, Baum-Welch is
a fixed count of E/M iterations from a k-means start, and Viterbi is a
max-product pass with an argmax backtrack.

The recursions are sequential over T, as the JAX package's `lax.scan`s
are: here a Python loop of a few tensor ops per step on the data's device,
so a fit is ~T steps × 2 directions × ``iters`` iterations of dispatches.
Nothing reads the host (the backtrack indexes on the device too).  It is
the plain version; a CUDA graph of the recursion or a kernel per direction
is the speed item in ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.regime.cluster import _kmeans_init, _moments, _on


class HMM(NamedTuple):
    log_pi: torch.Tensor     # [K] initial log probabilities
    log_A: torch.Tensor      # [K, K] transition log probabilities (row = from)
    means: torch.Tensor      # [K, F]
    vars: torch.Tensor       # [K, F]


def _emission_logp(hmm: HMM, x):
    """[T, K] log N(x_t | mean_k, var_k)."""
    diff = x[:, None, :] - hmm.means[None]
    return -0.5 * (diff * diff / hmm.vars[None]
                   + torch.log(2 * math.pi * hmm.vars[None])).sum(dim=-1)


def _forward(hmm: HMM, logb):
    """(log_alpha [T, K], log-likelihood)."""
    la = hmm.log_pi + logb[0]
    out = [la]
    for t in range(1, logb.shape[0]):
        la = logb[t] + torch.logsumexp(la[:, None] + hmm.log_A, dim=0)
        out.append(la)
    log_alpha = torch.stack(out)
    return log_alpha, torch.logsumexp(log_alpha[-1], dim=0)


def _backward(hmm: HMM, logb):
    """log_beta [T, K]."""
    lb = torch.zeros_like(logb[0])
    out = [lb]
    for t in range(logb.shape[0] - 1, 0, -1):
        lb = torch.logsumexp(hmm.log_A + (logb[t] + lb)[None, :], dim=1)
        out.append(lb)
    return torch.stack(out[::-1])


def hmm_posteriors(hmm: HMM, x):
    """γ_t(k) = P(z_t = k | x_1..T) [T, K] and the sequence log-likelihood."""
    x = _on(x, hmm.means.device)
    logb = _emission_logp(hmm, x)
    log_alpha, ll = _forward(hmm, logb)
    gamma = torch.softmax(log_alpha + _backward(hmm, logb), dim=1)
    return gamma, ll


def hmm_fit(key, x, k: int, iters: int = 30, var_floor: float = 1e-4, device=None) -> HMM:
    """Baum-Welch (``iters`` iterations, none skipped) from a k-means start
    of the emissions; ``key`` as `cluster.kmeans_fit` takes it."""
    x = _on(x, device)
    _, means, var = _kmeans_init(key, x, k, var_floor)
    eye = torch.eye(k, device=x.device)
    hmm = HMM(log_pi=torch.log(torch.full((k,), 1.0 / k, device=x.device)),
              log_A=torch.log(eye * 0.9 + (1 - eye) * (0.1 / (k - 1))),
              means=means, vars=var)
    for _ in range(iters):
        logb = _emission_logp(hmm, x)
        log_alpha, _ = _forward(hmm, logb)
        log_beta = _backward(hmm, logb)
        gamma = torch.softmax(log_alpha + log_beta, dim=1)                    # [T, K]
        # ξ_t(i, j) ∝ α_t(i) A_ij b_j(t+1) β_{t+1}(j)
        lx = (log_alpha[:-1, :, None] + hmm.log_A[None]
              + (logb[1:] + log_beta[1:])[:, None, :])                       # [T-1, K, K]
        xi = torch.softmax(lx.reshape(lx.shape[0], -1), dim=1).reshape(lx.shape)
        trans = xi.sum(dim=0)
        new_A = torch.log(trans / torch.clamp_min(trans.sum(dim=1, keepdim=True), 1e-12)
                          + 1e-12)
        nk = torch.clamp_min(gamma.sum(dim=0), 1e-6)
        means, var = _moments(gamma, x, nk, var_floor)
        hmm = HMM(torch.log(gamma[0] + 1e-12), new_A, means, var)
    return hmm


def hmm_viterbi(hmm: HMM, x):
    """The most likely state path [T] (int64, on the model's device)."""
    x = _on(x, hmm.means.device)
    logb = _emission_logp(hmm, x)
    delta = hmm.log_pi + logb[0]
    args = []
    for t in range(1, logb.shape[0]):
        scores = delta[:, None] + hmm.log_A                                   # [K, K]
        best, arg = torch.max(scores, dim=0)
        delta = best + logb[t]
        args.append(arg)
    state = torch.argmax(delta).reshape(1)
    path = [state]
    for arg in reversed(args):
        state = arg.index_select(0, state)
        path.append(state)
    return torch.cat(path[::-1])
