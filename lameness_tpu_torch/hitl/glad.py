"""GLAD: Labels, Abilities, Difficulties (Whitehill et al. 2009) (port of
``lameness_tpu/hitl/glad.py``, copied line for line: host numpy).

Behavioral rebuild of ``services/rater-reliability/app/main.py:179-288``:
sigmoid(alpha_j · beta_i) correctness model, E-step log-odds label
posterior, the reference's simplified M-step (accuracy→log-odds abilities,
consensus-strength difficulties), convergence on max label change < tol.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class GLAD:
    def __init__(self, max_iter: int = 100, tol: float = 1e-4):
        self.max_iter = max_iter
        self.tol = tol
        self.alpha: np.ndarray | None = None
        self.beta: np.ndarray | None = None
        self.labels: Dict[str, int] = {}

    def fit(self, annotations: Dict[str, Dict[str, int]]
            ) -> Tuple[Dict[str, int], Dict[str, float], Dict[str, float]]:
        if not annotations:
            return {}, {}, {}
        items = list(annotations.keys())
        raters: list = []
        for anns in annotations.values():
            for r in anns:
                if r not in raters:
                    raters.append(r)
        n_items, n_raters = len(items), len(raters)
        r_idx = {r: j for j, r in enumerate(raters)}

        obs = np.full((n_items, n_raters), -1, np.int64)
        for i, item in enumerate(items):
            for r, lab in annotations[item].items():
                obs[i, r_idx[r]] = lab
        has = obs >= 0

        self.alpha = np.ones(n_raters)
        self.beta = np.ones(n_items)
        z = np.array([float(np.mean([v for v in row[row >= 0]]) > 0.5)
                      if (row >= 0).any() else 0.0 for row in obs])

        for _ in range(self.max_iter):
            # E-step: log-odds of label 1 per item
            pc = 1.0 / (1.0 + np.exp(-np.outer(self.beta, self.alpha)))  # (I, J)
            ll1 = np.log(pc + 1e-10) - np.log(1 - pc + 1e-10)
            contrib = np.where(obs == 1, ll1, -ll1)
            contrib = np.where(has, contrib, 0.0)
            z_new = 1.0 / (1.0 + np.exp(-contrib.sum(axis=1)))

            # M-step (reference's simplified updates, main.py:250-273)
            expected = z_new > 0.5
            correct = (has & (obs == expected[:, None].astype(np.int64))
                       ).sum(axis=0)
            total = has.sum(axis=0)
            acc = np.where(total > 0, correct / np.maximum(total, 1), np.nan)
            upd = total > 0
            self.alpha[upd] = (np.log(acc[upd] + 0.01)
                               - np.log(1 - acc[upd] + 0.01))
            mean_votes = np.where(
                has.any(axis=1),
                np.where(has, obs, 0).sum(axis=1) / np.maximum(
                    has.sum(axis=1), 1), 0.5)
            agreement = np.abs(mean_votes - 0.5) * 2
            self.beta = np.where(has.any(axis=1), agreement + 0.5, self.beta)

            if np.abs(z_new - z).max() < self.tol:
                z = z_new
                break
            z = z_new

        labels = {item: int(z[i] > 0.5) for i, item in enumerate(items)}
        abilities = {r: float(1.0 / (1.0 + np.exp(-self.alpha[r_idx[r]])))
                     for r in raters}
        difficulties = {item: float(1.0 / self.beta[i])
                        for i, item in enumerate(items)}
        self.labels = labels
        return labels, abilities, difficulties
