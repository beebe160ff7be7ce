"""Hyperparameter optimization: TPE sampling + successive halving.

Port of `ai_crypto_trader_tpu/models/hpo.py`.  The sampler and the
scheduler are the JAX package's NumPy code, copied: a Tree-structured
Parzen Estimator over the search space (after ``n_startup`` random
trials, candidates maximizing the good/bad likelihood ratio), and
successive halving (every trial a short budget, the best fraction the
full one).  Its draws come from ``np.random.default_rng(seed)`` in the
same order, so for equal validation losses the trial sequence is the JAX
one.  Each trial trains through the port's `train_model`.

Trials farm over a partitioner's ``trial_devices()`` round-robin
(``partitioner=``, as in the JAX package): trial i of the first rung, and
survivor i of the second, runs on device i mod n, counted by
`utils.meshprof.record_trial`.  Without a partitioner, or with the
single-device seam, every trial runs on ``device``.  On a process mesh
(`parallel.mesh.ProcessMesh`, each rank driving L local shards, G in all)
trial i runs on global shard i mod G: on rank (i mod G) // L, on its
local device (i mod G) mod L; every rank proposes every trial, and the
ranks exchange their losses (`parallel.mesh.all_gather_object`) at the
end of each rung and before each TPE proposal, so every rank proposes the
same trials and returns the same result.

Each trial draws from a generator of its own, seeded by a draw of the
caller's generator (the JAX package's ``fold_in(key, i)``): a rung's seeds
are drawn in trial order before the rung's farm splits, so a trial's
draws do not depend on where the other trials run, and a rank that skips
the others' trials still advances the caller's stream as one device
does.  A trial's draws are made on the generator's device and moved to
the trial's (the initial parameters by `build_model`, the permutations by
`train_loop`, the dropout masks by `layers.dropout`).  A draw provider in
place of a ``torch.Generator`` is shared by the trials in turn, and only
one process can do that (a process mesh raises ``TypeError``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.models.train import train_model
from ai_crypto_trader_tpu_torch.parallel.mesh import all_gather_object
from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner
from ai_crypto_trader_tpu_torch.utils import meshprof

SEARCH_SPACE = {
    # neural_network_service.py:604-640 (Optuna suggest_* calls)
    "model_type": ("lstm", "gru", "cnn_lstm", "attention", "transformer"),
    "units": (32, 64, 128),
    "dropout": (0.1, 0.5),
    "learning_rate": (1e-4, 1e-2),
    "batch_size": (16, 32, 64),
}


def _sample_trial(rng: np.random.Generator) -> dict:
    lo, hi = SEARCH_SPACE["dropout"]
    llo, lhi = np.log(SEARCH_SPACE["learning_rate"][0]), np.log(SEARCH_SPACE["learning_rate"][1])
    return {
        "model_type": rng.choice(SEARCH_SPACE["model_type"]),
        "units": int(rng.choice(SEARCH_SPACE["units"])),
        "dropout": float(rng.uniform(lo, hi)),
        "learning_rate": float(np.exp(rng.uniform(llo, lhi))),
        "batch_size": int(rng.choice(SEARCH_SPACE["batch_size"])),
    }


# --- TPE (Parzen-estimator) sampler ----------------------------------------

_CATEGORICAL = ("model_type", "units", "batch_size")
_CONTINUOUS = ("dropout", "learning_rate")       # learning_rate in log space


def _cont_value(trial: dict, dim: str) -> float:
    v = trial[dim]
    return float(np.log(v)) if dim == "learning_rate" else float(v)


def _parzen_logpdf(x: float, obs: np.ndarray, lo: float, hi: float) -> float:
    """Log density of a Gaussian Parzen mixture over the observations, with
    a uniform prior component (keeps unexplored regions reachable)."""
    span = hi - lo
    bw = max(float(np.std(obs)) if len(obs) > 1 else span, span * 0.1)
    comp = -0.5 * ((x - obs) / bw) ** 2 - np.log(bw * np.sqrt(2 * np.pi))
    comp = np.concatenate([comp, [-np.log(span)]])   # uniform prior member
    m = comp.max()
    return float(m + np.log(np.exp(comp - m).sum()) - np.log(len(comp)))


def _cat_logpmf(v, obs: list, choices: tuple) -> float:
    counts = {c: 1.0 for c in choices}               # add-one smoothing
    for o in obs:
        counts[o] += 1.0
    total = sum(counts.values())
    return float(np.log(counts[v] / total))


def suggest_tpe(history: list, rng: np.random.Generator, *,
                gamma: float = 0.25, n_candidates: int = 24) -> dict:
    """Propose the next trial by the TPE criterion.

    ``history``: [{"trial": dict, "val_loss": float}, …] from completed
    trials. Splits it into the best ceil(γ·n) ("good") and the rest
    ("bad"), draws candidates from the good distribution (perturbed good
    points / their categorical frequencies), and returns the candidate
    maximizing Σ_dims [log l(x) − log g(x)].

    An empty history has no good/bad split — fall back to a prior sample
    (optimize_hyperparameters never hits this via n_startup ≥ 1, but the
    public function must not assume its caller)."""
    if not history:
        return _sample_trial(rng)
    ranked = sorted(history, key=lambda r: r["val_loss"])
    n_good = max(int(np.ceil(len(ranked) * gamma)), 1)
    good = [r["trial"] for r in ranked[:n_good]]
    bad = [r["trial"] for r in ranked[n_good:]] or good

    bounds = {
        "dropout": SEARCH_SPACE["dropout"],
        "learning_rate": tuple(np.log(SEARCH_SPACE["learning_rate"])),
    }
    good_obs = {d: np.asarray([_cont_value(t, d) for t in good])
                for d in _CONTINUOUS}
    bad_obs = {d: np.asarray([_cont_value(t, d) for t in bad])
               for d in _CONTINUOUS}

    best_c, best_score = None, -np.inf
    for _ in range(n_candidates):
        cand = _sample_trial(rng)
        # bias candidate generation toward the good set: with p=0.75 draw
        # each dim from a good-point neighborhood instead of the prior
        for d in _CONTINUOUS:
            if rng.random() < 0.75:
                lo, hi = bounds[d]
                span = hi - lo
                bw = max(float(np.std(good_obs[d])) if len(good_obs[d]) > 1
                         else span * 0.25, span * 0.1)
                x = float(np.clip(rng.normal(rng.choice(good_obs[d]), bw),
                                  lo, hi))
                cand[d] = float(np.exp(x)) if d == "learning_rate" else x
        for d in _CATEGORICAL:
            if rng.random() < 0.75:
                cand[d] = good[int(rng.integers(len(good)))][d]

        score = 0.0
        for d in _CONTINUOUS:
            x = _cont_value(cand, d)
            lo, hi = bounds[d]
            score += (_parzen_logpdf(x, good_obs[d], lo, hi)
                      - _parzen_logpdf(x, bad_obs[d], lo, hi))
        for d in _CATEGORICAL:
            score += (_cat_logpmf(cand[d], [t[d] for t in good],
                                  SEARCH_SPACE[d])
                      - _cat_logpmf(cand[d], [t[d] for t in bad],
                                    SEARCH_SPACE[d]))
        if score > best_score:
            best_c, best_score = cand, score
    return best_c


def optimize_hyperparameters(
    generator,
    features: np.ndarray,
    *,
    n_trials: int = 20,
    rung_epochs: Sequence[int] = (5, 20),
    survivor_fraction: float = 0.3,
    seq_len: int = 60,
    seed: int = 0,
    sampler: str = "tpe",
    n_startup: int = 5,
    target_col: int = 0,
    precision: str | None = None,
    partitioner=None,
    device=None,
) -> dict:
    """Returns {"best_params": ..., "best_val_loss": ..., "trials": [...]}.

    ``sampler="tpe"`` (default): the first ``n_startup`` rung-0 trials are
    random, the rest proposed by the Parzen-estimator ratio over the
    results so far; ``"random"`` disables the surrogate.  Every trial runs
    `train_model` on ``device`` (None: the CUDA card) with its draws from
    a generator of its own seeded from ``generator`` (a ``torch.Generator``;
    a draw provider is shared by the trials in turn); ``precision`` goes to
    both rungs.  ``partitioner`` (None, a single-device seam or a
    `parallel.MeshPartitioner`) farms the trials over its
    ``trial_devices()``, or over its ranks on a process mesh (module
    docstring)."""
    part = resolve_partitioner(partitioner)
    devices = part.trial_devices()          # [] on one device; a process mesh: this rank's
    dev = resolve_device(device) if not devices else None
    mesh = part.mesh if part.device_count > 1 else None
    info = mesh.info if mesh is not None and mesh.spans_processes else None
    ranks, me = (info.world, info.rank) if info is not None else (1, 0)
    if info is not None and not isinstance(generator, torch.Generator):
        raise TypeError("a trial farm over the ranks of a process mesh needs a "
                        "torch.Generator: a draw provider's stream cannot be split "
                        "between processes")
    rng = np.random.default_rng(seed)
    results = []
    done = {}                  # index in results -> val loss this rank computed

    def settle():
        """Every trial's loss into its record: on a process mesh the ranks
        exchange what each computed (every rank calls it at the same
        points)."""
        got = dict(done)
        done.clear()
        if info is not None:
            got = {i: loss for theirs in all_gather_object(got, info)
                   for i, loss in theirs.items()}
        for i, loss in got.items():
            results[i]["val_loss"] = loss

    def farmed_to(slot: int):
        """The device that runs trial ``slot`` of a rung, or None where
        another rank runs it."""
        if not devices:
            return dev
        j = trial_slot(slot, len(devices), ranks, me)
        return None if j is None else devices[j]

    def run_trial(on, t: dict, draws, epochs: int, patience: int) -> float:
        if devices:
            # per-device trial accounting (utils/meshprof.py)
            meshprof.record_trial(on)
        return train_model(
            draws, features, t["model_type"], seq_len=seq_len,
            units=t["units"], dropout=t["dropout"],
            learning_rate=t["learning_rate"], batch_size=t["batch_size"],
            epochs=epochs, early_stopping_patience=patience,
            target_col=target_col, precision=precision, device=on).best_val_loss

    # Rung 0: short budget for everyone; TPE proposes from accumulated
    # rung-0 results once the warm-up is done.
    draws = _trial_draws(generator, n_trials)
    for i in range(n_trials):
        if sampler == "tpe" and i >= n_startup:
            settle()
            t = suggest_tpe(results, rng)
        else:
            t = _sample_trial(rng)
        results.append({"trial": t, "val_loss": None, "rung": 0})
        on = farmed_to(i)
        if on is not None:
            done[i] = run_trial(on, t, draws[i], rung_epochs[0], patience=rung_epochs[0])
    settle()

    # Survivors graduate to the full budget; the winner is chosen among
    # full-budget runs only (losses across unequal budgets and fresh inits
    # are not comparable).
    order = np.argsort([r["val_loss"] for r in results])
    n_sur = max(int(np.ceil(n_trials * survivor_fraction)), 1)
    draws = _trial_draws(generator, n_sur)
    finalists = []
    for slot, i in enumerate(order[:n_sur]):
        rec = {"trial": results[i]["trial"], "val_loss": None, "rung": 1}
        results[i] = rec
        finalists.append(rec)
        on = farmed_to(slot)
        if on is not None:
            done[int(i)] = run_trial(on, rec["trial"], draws[slot], rung_epochs[-1],
                                     patience=10)
    settle()

    best = min(finalists, key=lambda r: r["val_loss"])
    return {"best_params": best["trial"], "best_val_loss": best["val_loss"],
            "trials": results}


def trial_slot(i: int, local: int, ranks: int = 1, rank: int = 0) -> int | None:
    """Where trial ``i`` of a rung runs on a farm of ``ranks`` ranks of
    ``local`` devices each: the index among ``rank``'s devices, or None
    where another rank runs it.  Trial i goes to global shard i mod
    (ranks · local), numbered rank-major."""
    g = i % (local * ranks)
    return g % local if g // local == rank else None


def _trial_draws(generator, n: int) -> list:
    """The draws of ``n`` trials: a ``torch.Generator`` of each one's on
    ``generator``'s device, seeded by ``n`` draws of it made here, in trial
    order; a draw provider shared in turn."""
    if not isinstance(generator, torch.Generator):
        return [generator] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator, device=generator.device)
    return [torch.Generator(generator.device).manual_seed(int(s)) for s in seeds.tolist()]
