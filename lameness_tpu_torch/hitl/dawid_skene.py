"""Dawid-Skene latent-truth EM (Dawid & Skene 1979) (port of
``lameness_tpu/hitl/dawid_skene.py``, copied line for line: host numpy).

Behavioral rebuild of ``services/rater-reliability/app/main.py:48-176``:
majority-vote init, E-step posterior over true labels from per-rater
confusion matrices, M-step re-estimating class priors + confusions,
convergence on max parameter change < tol.  Vectorised over the
(item, rater) incidence arrays instead of the reference's Python loops;
numerics (1e-10 floors, 0.8-diagonal init, row normalisation) preserved.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class DawidSkene:
    def __init__(self, num_classes: int = 2, max_iter: int = 100,
                 tol: float = 1e-4):
        self.num_classes = num_classes
        self.max_iter = max_iter
        self.tol = tol
        self.pi: np.ndarray | None = None
        self.theta: Dict[str, np.ndarray] = {}
        self.labels: Dict[str, int] = {}
        self.label_probs: Dict[str, float] = {}

    def fit(self, annotations: Dict[str, Dict[str, int]]
            ) -> Tuple[Dict[str, int], Dict[str, np.ndarray]]:
        if not annotations:
            return {}, {}
        items = list(annotations.keys())
        raters: List[str] = []
        for anns in annotations.values():
            for r in anns:
                if r not in raters:
                    raters.append(r)
        n_items, n_raters, c = len(items), len(raters), self.num_classes
        r_idx = {r: j for j, r in enumerate(raters)}

        # incidence arrays: obs[i, j] = label or -1
        obs = np.full((n_items, n_raters), -1, np.int64)
        for i, item in enumerate(items):
            for r, lab in annotations[item].items():
                obs[i, r_idx[r]] = lab
        has = obs >= 0                                   # (I, J)

        self.pi = np.ones(c) / c
        cm0 = np.eye(c) * 0.8 + np.ones((c, c)) * 0.1
        cm0 = cm0 / cm0.sum(axis=1, keepdims=True)
        theta = np.tile(cm0[None], (n_raters, 1, 1))     # (J, c, c)

        q = np.zeros((n_items, c))
        for _ in range(self.max_iter):
            # E-step: log P(label=k | obs) ∝ log pi_k + Σ log theta_j[k, obs]
            log_theta = np.log(theta + 1e-10)            # (J, c, c)
            obs_safe = np.where(has, obs, 0)
            per = log_theta[np.arange(n_raters)[None, :], :,
                            obs_safe]                    # (I, J, c)
            per = np.where(has[:, :, None], per, 0.0)
            logq = np.log(self.pi + 1e-10)[None, :] + per.sum(axis=1)
            logq -= logq.max(axis=1, keepdims=True)
            q = np.exp(logq)
            q /= q.sum(axis=1, keepdims=True)

            # M-step
            new_pi = q.sum(axis=0) / n_items
            new_theta = np.zeros_like(theta)
            for lab in range(c):
                sel = has & (obs == lab)                 # (I, J)
                # theta[j, k, lab] = sum_i q[i, k] * [obs[i, j] == lab]
                new_theta[:, :, lab] = (q[:, None, :] * sel[:, :, None]
                                        ).sum(axis=0)
            # normalize rows; empty rows -> uniform-safe (divide by 1)
            row = new_theta.sum(axis=2, keepdims=True)
            row = np.where(row == 0, 1.0, row)
            new_theta = new_theta / row

            pi_change = np.abs(new_pi - self.pi).max()
            th_change = np.abs(new_theta - theta).max()
            self.pi, theta = new_pi, new_theta
            if pi_change < self.tol and th_change < self.tol:
                break

        self.theta = {r: theta[r_idx[r]] for r in raters}
        self.labels = {item: int(q[i].argmax()) for i, item in enumerate(items)}
        self.label_probs = {item: float(q[i].max())
                            for i, item in enumerate(items)}
        return self.labels, self.theta

    def get_rater_ability(self, rater_id: str) -> float:
        """Mean diagonal of the rater's confusion matrix (main.py:172-176)."""
        if rater_id not in self.theta:
            return 0.5
        return float(np.diag(self.theta[rater_id]).mean())
