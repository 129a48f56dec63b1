"""Elo ratings, David's scores, hierarchy steepness, inter-rater agreement
(port of ``lameness_tpu/hitl/elo.py``, copied line for line: host numpy).

Behavioral rebuild of the reference's Elo machinery
(``admin-interface/backend/app/routers/elo_ranking.py:37-313``):
logistic-400 expected score, dynamic K = 32·(σ/350)·games·degree·rater
floored at 10, 0.98 uncertainty decay floored at 50; normalised David's
scores DS = w + w₂ − l − l₂ with degree-weighted win proportions;
steepness as |regression slope of DS vs rank| / (1/(n−1)); pairwise
agreement proxy for ICC.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

INITIAL_ELO = 1500.0
INITIAL_UNCERTAINTY = 350.0
K_FACTOR_BASE = 32.0
MIN_K_FACTOR = 10.0


def expected_score(rating_a: float, rating_b: float) -> float:
    return 1.0 / (1.0 + 10 ** ((rating_b - rating_a) / 400))


def dynamic_k_factor(uncertainty: float, games_played: int, degree: int = 1,
                     rater_weight: float = 1.0) -> float:
    k = K_FACTOR_BASE * (uncertainty / INITIAL_UNCERTAINTY)
    k *= max(0.5, 1.0 - games_played / 100)
    k *= 0.5 + degree * 0.33
    k *= rater_weight
    return max(MIN_K_FACTOR, k)


def update_ratings(rating_a: float, rating_b: float, uncertainty_a: float,
                   uncertainty_b: float, games_a: int, games_b: int,
                   winner: int, degree: int = 1, rater_weight: float = 1.0
                   ) -> Tuple[float, float, float, float]:
    """winner: 0 = tie, 1 = A (more lame), 2 = B."""
    ea = expected_score(rating_a, rating_b)
    eb = 1.0 - ea
    if winner == 1:
        aa, ab = 1.0, 0.0
    elif winner == 2:
        aa, ab = 0.0, 1.0
    else:
        aa = ab = 0.5
    ka = dynamic_k_factor(uncertainty_a, games_a, degree, rater_weight)
    kb = dynamic_k_factor(uncertainty_b, games_b, degree, rater_weight)
    new_a = rating_a + ka * (aa - ea)
    new_b = rating_b + kb * (ab - eb)
    return (new_a, new_b,
            max(50.0, uncertainty_a * 0.98), max(50.0, uncertainty_b * 0.98))


def davids_scores(comparisons: List[Dict]) -> Dict[str, float]:
    """Normalised David's scores over degree/rater-weighted win proportions
    (elo_ranking.py:138-218)."""
    video_ids: List[str] = []
    for c in comparisons:
        for v in (c["video_id_1"], c["video_id_2"]):
            if v not in video_ids:
                video_ids.append(v)
    video_list = sorted(video_ids)
    n = len(video_list)
    if n == 0:
        return {}
    idx = {v: i for i, v in enumerate(video_list)}
    wins = np.zeros((n, n))
    total = np.zeros((n, n))
    for c in comparisons:
        i, j = idx[c["video_id_1"]], idx[c["video_id_2"]]
        w = c.get("rater_weight", 1.0) * (1 + c.get("degree", 1) * 0.5)
        if c["winner"] == 1:
            wins[i, j] += w
        elif c["winner"] == 2:
            wins[j, i] += w
        else:
            wins[i, j] += w * 0.5
            wins[j, i] += w * 0.5
        total[i, j] += w
        total[j, i] += w
    p = np.where(total > 0, wins / np.maximum(total, 1e-12), 0.0)
    np.fill_diagonal(p, 0.0)
    w_vec = p.sum(axis=1)
    l_vec = p.sum(axis=0)
    w2 = p @ w_vec
    l2 = p.T @ l_vec
    ds_vals = w_vec + w2 - l_vec - l2
    lo, hi = ds_vals.min(), ds_vals.max()
    if hi > lo:
        ds_vals = (ds_vals - lo) / (hi - lo)
    return {video_list[i]: float(ds_vals[i]) for i in range(n)}


def steepness(normalized_scores: Dict[str, float]) -> Tuple[float, float]:
    """|slope of DS vs rank| / |max slope 1/(n-1)|, with its standard error
    (elo_ranking.py:221-269)."""
    if len(normalized_scores) < 3:
        return 0.0, 0.0
    scores = sorted(normalized_scores.values(), reverse=True)
    n = len(scores)
    ranks = np.arange(1, n + 1, dtype=float)
    s = np.asarray(scores)
    mr, ms = ranks.mean(), s.mean()
    denom = ((ranks - mr) ** 2).sum()
    if denom == 0:
        return 0.0, 0.0
    slope = ((ranks - mr) * (s - ms)).sum() / denom
    y_pred = ms + slope * (ranks - mr)
    ss_res = ((s - y_pred) ** 2).sum()
    se = math.sqrt(ss_res / (n - 2)) / math.sqrt(denom) if n > 2 else 0.0
    max_slope = -1.0 / (n - 1)
    st = min(1.0, abs(slope / max_slope))
    return st, se


def inter_rater_agreement(comparisons: List[Dict]) -> float:
    """Pairwise agreement on repeated pairs; ties count 0.5 against a win
    (elo_ranking.py:272-313)."""
    pair_ratings = defaultdict(list)
    for c in comparisons:
        key = tuple(sorted([c["video_id_1"], c["video_id_2"]]))
        pair_ratings[key].append(c["winner"])
    agreements = []
    for ratings in pair_ratings.values():
        if len(ratings) > 1:
            n = len(ratings)
            agree = 0.0
            pairs = 0
            for i in range(n):
                for j in range(i + 1, n):
                    pairs += 1
                    if ratings[i] == ratings[j]:
                        agree += 1
                    elif ratings[i] == 0 or ratings[j] == 0:
                        agree += 0.5
            if pairs:
                agreements.append(agree / pairs)
    return float(np.mean(agreements)) if agreements else 0.0


def active_next_pair(ratings: Dict[str, float], uncertainties: Dict[str, float],
                     rng: np.random.Generator,
                     explore_prob: float = 0.3) -> Tuple[str, str]:
    """Active pair sampling: 70% pick the pair minimising
    |ΔElo| − 0.5·(σ_a + σ_b), 30% uniformly random (elo_ranking.py:501-611)."""
    ids = list(ratings)
    if len(ids) < 2:
        raise ValueError("need at least two rated videos")
    if rng.random() < explore_prob:
        a, b = rng.choice(len(ids), size=2, replace=False)
        return ids[int(a)], ids[int(b)]
    best = None
    best_val = math.inf
    for i in range(len(ids)):
        for j in range(i + 1, len(ids)):
            diff = abs(ratings[ids[i]] - ratings[ids[j]])
            unc = uncertainties.get(ids[i], INITIAL_UNCERTAINTY) + \
                uncertainties.get(ids[j], INITIAL_UNCERTAINTY)
            val = diff - 0.5 * unc
            if val < best_val:
                best_val = val
                best = (ids[i], ids[j])
    return best
