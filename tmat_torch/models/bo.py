"""Gaussian-process Bayesian optimization for hyperparameter search.

A copy of ``tmat_tpu/models/bo.py`` (numpy only): the same seed proposes
the same trials.

Reference target: keras-tuner's ``BayesianOptimizationOracle`` as used by the
reference's invasion-depth HP search
(fl_tissue_model_tools/models.py:174-395 +
notebooks/invasion_depth_training/invasion_depth_hp_search.ipynb cells
26-29): a GP surrogate with a Matern-5/2 kernel over unit-cube-encoded
hyperparameters, expected-improvement acquisition, and
``num_initial_points`` random trials before the surrogate takes over.

Pure NumPy (no sklearn/GPy dependency): the GP is exact (Cholesky), the
kernel hyperparameters (length-scale, signal, noise) are fitted by
log-marginal-likelihood grid search — at HP-search scale (tens of
observations, <10 dims) this is exact enough and costs microseconds next
to a training trial. The acquisition is maximized over a random candidate
sweep plus local perturbations of the incumbent, mirroring keras-tuner's
sampling-based acquisition optimization.

It is the default method of ``models/hp_search.py``, as in the JAX
package (its comparison with the quasi-random searcher:
``benchmarks/hp_search_benchmark.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HPSpace:
    """Encode the invasion-depth HP space to/from the unit cube.

    Continuous dims are log-uniform (the reference samples LRs/betas with
    ``sampling="log"``); the categorical layer choice is ordinal-encoded
    (keras-tuner's cumulative-probability vectorization of a Choice).
    """

    def __init__(self, space: Dict):
        self.log_dims: List[Tuple[str, float, float]] = [
            ("adam_beta_1", *space["adam_beta_1_range"]),
            ("adam_beta_2", *space["adam_beta_2_range"]),
            ("frozen_lr", *space["frozen_lr_range"]),
            ("fine_tune_lr", *space["fine_tune_lr_range"]),
        ]
        self.choices: Sequence[str] = list(space["last_layer_options"])
        self.dim = len(self.log_dims) + 1

    def sample(self, rng: np.random.RandomState) -> np.ndarray:
        return rng.rand(self.dim)

    def decode(self, u: np.ndarray) -> Dict:
        hp = {}
        for (name, lo, hi), x in zip(self.log_dims, u):
            llo, lhi = math.log(lo), math.log(hi)
            hp[name] = float(math.exp(llo + (lhi - llo) * float(np.clip(x, 0, 1))))
        idx = min(
            int(float(np.clip(u[-1], 0, 1)) * len(self.choices)),
            len(self.choices) - 1,
        )
        hp["last_resnet_layer"] = self.choices[idx]
        return hp

    def encode(self, hp: Dict) -> np.ndarray:
        u = np.empty(self.dim)
        for i, (name, lo, hi) in enumerate(self.log_dims):
            llo, lhi = math.log(lo), math.log(hi)
            u[i] = (math.log(hp[name]) - llo) / (lhi - llo)
        idx = self.choices.index(hp["last_resnet_layer"])
        u[-1] = (idx + 0.5) / len(self.choices)
        return np.clip(u, 0.0, 1.0)


def _matern52(X1: np.ndarray, X2: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(
        np.maximum(
            ((X1[:, None, :] - X2[None, :, :]) ** 2).sum(-1), 0.0
        )
    ) / ls
    s5d = math.sqrt(5.0) * d
    return (1.0 + s5d + (5.0 / 3.0) * d * d) * np.exp(-s5d)


class GP:
    """Exact GP regression with Matern-5/2 kernel, grid-fitted params."""

    def __init__(self, X: np.ndarray, y: np.ndarray):
        self.X = np.asarray(X, float)
        y = np.asarray(y, float)
        self.y_mean, self.y_std = float(y.mean()), float(y.std()) or 1.0
        self.y = (y - self.y_mean) / self.y_std

        best = (-np.inf, None)
        n = len(self.X)
        for ls in (0.1, 0.2, 0.5, 1.0, 2.0):
            for noise in (1e-4, 1e-2, 1e-1):
                K = _matern52(self.X, self.X, ls) + noise * np.eye(n)
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, self.y))
                lml = (
                    -0.5 * float(self.y @ alpha)
                    - float(np.log(np.diag(L)).sum())
                    - 0.5 * n * math.log(2 * math.pi)
                )
                if lml > best[0]:
                    best = (lml, (ls, noise, L, alpha))
        if best[1] is None:  # degenerate: fall back to a wide prior
            ls, noise = 1.0, 1e-1
            K = _matern52(self.X, self.X, ls) + noise * np.eye(n)
            L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, self.y))
            best = (0.0, (ls, noise, L, alpha))
        self.ls, self.noise, self.L, self.alpha = best[1]

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = _matern52(np.asarray(Xs, float), self.X, self.ls)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float, xi: float = 0.0
) -> np.ndarray:
    """EI for MINIMIZATION at the incumbent ``best``."""
    imp = best - xi - mu
    z = imp / np.maximum(sigma, 1e-12)
    return imp * _norm_cdf(z) + sigma * _norm_pdf(z)


class BayesianOptimizer:
    """Propose-observe loop: random until num_initial_points, then GP+EI."""

    def __init__(
        self,
        space: Dict,
        num_initial_points: int,
        rng: Optional[np.random.RandomState] = None,
        n_candidates: int = 2000,
    ):
        self.space = HPSpace(space)
        self.num_initial_points = max(1, int(num_initial_points))
        self.rng = rng or np.random.RandomState(0)
        self.n_candidates = n_candidates
        self.X: List[np.ndarray] = []
        self.y: List[float] = []

    def propose(self) -> Dict:
        if len(self.X) < self.num_initial_points:
            u = self.space.sample(self.rng)
            return self.space.decode(u)
        finite = [
            (x, v) for x, v in zip(self.X, self.y) if np.isfinite(v)
        ]
        if len(finite) < 2:
            return self.space.decode(self.space.sample(self.rng))
        Xf = np.stack([x for x, _ in finite])
        yf = np.array([v for _, v in finite])
        gp = GP(Xf, yf)

        cands = self.rng.rand(self.n_candidates, self.space.dim)
        # local candidates around the incumbent (exploitation pool)
        inc = Xf[int(np.argmin(yf))]
        local = np.clip(
            inc[None, :]
            + self.rng.normal(0, 0.1, size=(self.n_candidates // 4, self.space.dim)),
            0.0,
            1.0,
        )
        cands = np.vstack([cands, local])
        mu, sigma = gp.predict(cands)
        ei = expected_improvement(mu, sigma, float(yf.min()))
        return self.space.decode(cands[int(np.argmax(ei))])

    def observe(self, hp: Dict, loss: float) -> None:
        self.X.append(self.space.encode(hp))
        # failed trials (nan/inf) are kept as masked observations so the
        # proposer does not re-suggest them verbatim
        self.y.append(float(loss) if np.isfinite(loss) else np.inf)


def minimize(
    objective: Callable[[Dict], float],
    space: Dict,
    trials: int,
    num_initial_points: Optional[int] = None,
    seed: int = 0,
    callback: Optional[Callable[[int, Dict, float], None]] = None,
) -> Tuple[Dict, float]:
    """Run the full BO loop; returns (best_hp, best_loss)."""
    opt = BayesianOptimizer(
        space,
        num_initial_points or max(trials // 2, 1),
        rng=np.random.RandomState(seed),
    )
    best_hp, best_loss = None, np.inf
    for t in range(trials):
        hp = opt.propose()
        loss = objective(hp)
        opt.observe(hp, loss)
        if callback:
            callback(t, hp, loss)
        if loss < best_loss:
            best_hp, best_loss = hp, loss
    return best_hp, best_loss
