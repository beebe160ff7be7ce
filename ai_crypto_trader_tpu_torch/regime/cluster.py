"""Clustering primitives on the card: standardize, PCA, k-means, GMM.

Port of `ai_crypto_trader_tpu/regime/cluster.py` (the reference's sklearn
pipeline: StandardScaler, PCA when > 5 features, KMeans, GaussianMixture).
Lloyd and EM iterations are loops of a fixed count over tensors on the
data's device, branch-free; distance matrices are matmuls.  Nothing inside a
fit reads the host.

  * PCA's components come from ``torch.linalg.svd`` (LAPACK on the CPU,
    cuSOLVER on the card), which may flip a component's sign against the
    JAX package's.  Distances, k-means, the diagonal GMM and the HMM are
    invariant to such a flip, so labels and probabilities are not; a
    projection agrees up to each column's sign.
  * k-means' only random draw is the first centroid's index.  ``key`` is a
    ``torch.Generator`` (the index drawn from it, on its device) or an
    integer index (a test hands over the JAX package's draw).  The seeding
    is the JAX package's greedy farthest point, its not-yet-seeded
    centroids at the origin taking part in the distances as there.
  * ``torch.argmin`` / ``argmax`` return the first index of a tie, as XLA's
    do.

Fits take ``device=None`` (the CUDA card; ``device="cpu"`` asks for the
CPU) and move their inputs there; predictions run on the model's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ai_crypto_trader_tpu_torch.device import div_const, resolve_device, to_device


def _on(x, device) -> torch.Tensor:
    return to_device(x, resolve_device(device), torch.float32)


class Standardizer(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor

    def transform(self, x):
        return (x - self.mean) / self.std


def standardize_fit(x, device=None) -> Standardizer:
    """Per-column mean and population std (a zero std becomes 1)."""
    x = _on(x, device)
    mean = x.mean(dim=0)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=0))
    return Standardizer(mean, torch.where(std == 0.0, 1.0, std))


class PCA(NamedTuple):
    components: torch.Tensor   # [F, K]
    mean: torch.Tensor

    def transform(self, x):
        return (x - self.mean) @ self.components


def pca_fit(x, n_components: int, device=None) -> PCA:
    x = _on(x, device)
    mean = x.mean(dim=0)
    _, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    return PCA(components=vt[:n_components].T.contiguous(), mean=mean)


# ---------------------------------------------------------------------------
# k-means (Lloyd) with greedy farthest-point seeding
# ---------------------------------------------------------------------------

class KMeans(NamedTuple):
    centroids: torch.Tensor    # [K, F]


def _sq_dists(x, c):
    """[N, K] squared distances as a matmul."""
    return ((x * x).sum(dim=1)[:, None] - (2.0 * x) @ c.T
            + (c * c).sum(dim=1)[None, :])


def _row(x, i):
    """``x[i]`` for an index tensor ``i`` of one element, without reading
    it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _first_index(key, n: int, device) -> torch.Tensor:
    """The first centroid's index: drawn from ``key`` (a generator) or
    ``key`` itself (an integer)."""
    if isinstance(key, torch.Generator):
        return torch.randint(0, n, (1,), generator=key, device=key.device).to(device)
    return torch.tensor([int(key)], device=device)


def kmeans_fit(key, x, k: int, iters: int = 100, device=None) -> KMeans:
    x = _on(x, device)
    n = x.shape[0]
    cents = torch.zeros((k, x.shape[1]), device=x.device)
    cents[0] = _row(x, _first_index(key, n, x.device))
    for i in range(1, k):
        cents[i] = _row(x, torch.argmax(_sq_dists(x, cents).amin(dim=1)))
    for _ in range(iters):
        onehot = F.one_hot(torch.argmin(_sq_dists(x, cents), dim=1), k).to(x.dtype)  # [N, K]
        counts = onehot.sum(dim=0)[:, None]
        sums = onehot.T @ x                                                         # [K, F]
        cents = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), cents)
    return KMeans(cents)


def kmeans_predict(model: KMeans, x):
    x = to_device(x, model.centroids.device, torch.float32)
    return torch.argmin(_sq_dists(x, model.centroids), dim=1)


# ---------------------------------------------------------------------------
# Diagonal-covariance GMM via EM
# ---------------------------------------------------------------------------

class GMM(NamedTuple):
    weights: torch.Tensor   # [K]
    means: torch.Tensor     # [K, F]
    vars: torch.Tensor      # [K, F] diagonal


def _gmm_log_prob(gmm: GMM, x):
    """[N, K] per-component log densities + log weights."""
    diff = x[:, None, :] - gmm.means[None]                       # [N, K, F]
    lp = -0.5 * (diff * diff / gmm.vars[None]
                 + torch.log(2 * math.pi * gmm.vars[None])).sum(dim=-1)
    return lp + torch.log(gmm.weights)[None]


def _moments(w, x, counts, var_floor):
    """Weighted means and floored diagonal variances: ``w`` [N, K]."""
    means = (w.T @ x) / counts[:, None]
    var = torch.clamp_min((w.T @ (x * x)) / counts[:, None] - means ** 2, var_floor)
    return means, var


def _kmeans_init(key, x, k, var_floor):
    """(counts, means, vars) of a 20-iteration k-means' clusters: the GMM's
    and the HMM's initial emissions."""
    assign = kmeans_predict(kmeans_fit(key, x, k, iters=20, device=x.device), x)
    onehot = F.one_hot(assign, k).to(x.dtype)
    counts = torch.clamp_min(onehot.sum(dim=0), 1.0)
    return (counts, *_moments(onehot, x, counts, var_floor))


def gmm_fit(key, x, k: int, iters: int = 50, var_floor: float = 1e-4, device=None) -> GMM:
    x = _on(x, device)
    n = x.shape[0]
    counts, means, var = _kmeans_init(key, x, k, var_floor)
    gmm = GMM(weights=div_const(counts, n), means=means, vars=var)
    for _ in range(iters):
        resp = torch.softmax(_gmm_log_prob(gmm, x), dim=1)               # E-step [N, K]
        nk = torch.clamp_min(resp.sum(dim=0), 1e-6)                      # M-step
        means, var = _moments(resp, x, nk, var_floor)
        gmm = GMM(weights=div_const(nk, n), means=means, vars=var)
    return gmm


def gmm_predict_proba(gmm: GMM, x):
    x = to_device(x, gmm.means.device, torch.float32)
    return torch.softmax(_gmm_log_prob(gmm, x), dim=1)
