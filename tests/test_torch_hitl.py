"""The port's human-in-the-loop modules (``lameness_tpu_torch/hitl``)
against the JAX package's on the same seeded annotations and comparisons:
Dawid-Skene, GLAD, every ``elo.py`` function, and
``RaterReliabilityService`` (stats, tiers, weighted consensus, the bus
handler and the three JSON files it persists).  Floats within 1e-12."""
import dataclasses
import json

import numpy as np
import pytest

from lameness_tpu.core.config import Subjects as JSubjects
from lameness_tpu.hitl import dawid_skene as jds
from lameness_tpu.hitl import elo as jelo
from lameness_tpu.hitl import glad as jglad
from lameness_tpu.hitl import reliability as jrel
from lameness_tpu.io.bus import MessageBus as JBus
from lameness_tpu_torch.core.config import Subjects as TSubjects
from lameness_tpu_torch.hitl import dawid_skene as tds
from lameness_tpu_torch.hitl import elo as telo
from lameness_tpu_torch.hitl import glad as tglad
from lameness_tpu_torch.hitl import reliability as trel
from lameness_tpu_torch.io.bus import MessageBus as TBus

TOL = 1e-12


def assert_close(a, b, tol=TOL, path=""):
    """Recursive equality: floats within ``tol``, everything else equal."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=0, atol=tol, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) and \
            not isinstance(a, bool):
        assert abs(float(a) - float(b)) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def annotations(seed, n_items=40, raters=6, missing=0.2):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0.5, 0.97, raters)
    truth = rng.random(n_items) < 0.5
    out = {}
    for i in range(n_items):
        out[f"v{i}"] = {}
        for r in range(raters):
            if rng.random() < missing:
                continue
            ok = rng.random() < acc[r]
            out[f"v{i}"][f"r{r}"] = int(truth[i] if ok else not truth[i])
    return {k: v for k, v in out.items() if v}


def comparisons(seed, n=60, videos=8, raters=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = rng.choice(videos, 2, replace=False)
        out.append({"video_id_1": f"v{a}", "video_id_2": f"v{b}",
                    "winner": int(rng.integers(0, 3)),
                    "degree": int(rng.integers(0, 4)),
                    "rater_id": f"r{int(rng.integers(raters))}",
                    "rater_weight": float(rng.choice([0.5, 1.0, 1.5]))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dawid_skene_matches_jax(seed):
    anns = annotations(seed)
    j, t = jds.DawidSkene(), tds.DawidSkene()
    assert_close(t.fit(anns), j.fit(anns))
    for r in {r for a in anns.values() for r in a} | {"nobody"}:
        assert_close(t.get_rater_ability(r), j.get_rater_ability(r))
    assert tds.DawidSkene().fit({}) == ({}, {})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_glad_matches_jax(seed):
    anns = annotations(seed)
    assert_close(tglad.GLAD().fit(anns), jglad.GLAD().fit(anns))


def test_elo_functions_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        ra, rb = rng.uniform(1000, 2000, 2)
        ua, ub = rng.uniform(40, 400, 2)
        ga, gb = (int(v) for v in rng.integers(0, 150, 2))
        deg, win = int(rng.integers(0, 4)), int(rng.integers(0, 3))
        w = float(rng.choice([0.5, 1.0, 1.5]))
        assert_close(telo.expected_score(ra, rb), jelo.expected_score(ra, rb))
        assert_close(telo.dynamic_k_factor(ua, ga, deg, w),
                     jelo.dynamic_k_factor(ua, ga, deg, w))
        assert_close(telo.update_ratings(ra, rb, ua, ub, ga, gb, win, deg, w),
                     jelo.update_ratings(ra, rb, ua, ub, ga, gb, win, deg, w))
    for seed in range(4):
        comps = comparisons(seed)
        ds = telo.davids_scores(comps)
        assert_close(ds, jelo.davids_scores(comps))
        assert_close(telo.steepness(ds), jelo.steepness(ds))
        assert_close(telo.inter_rater_agreement(comps),
                     jelo.inter_rater_agreement(comps))
        ratings = {f"v{i}": float(r) for i, r in
                   enumerate(np.random.default_rng(seed).uniform(
                       1300, 1700, 8))}
        unc = {k: 350.0 - 20 * i for i, k in enumerate(ratings)}
        gj, gt = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(20):
            assert telo.active_next_pair(ratings, unc, gt) == \
                jelo.active_next_pair(ratings, unc, gj)
    assert telo.steepness({"a": 1.0}) == jelo.steepness({"a": 1.0})
    assert telo.davids_scores([]) == jelo.davids_scores([])
    with pytest.raises(ValueError):
        telo.active_next_pair({"a": 1500.0}, {}, np.random.default_rng(0))


def test_tiers_match_jax():
    for acc in np.linspace(0, 1, 101):
        assert trel.determine_tier(acc) == jrel.determine_tier(acc)


def test_reliability_service_matches_jax(tmp_path):
    """The same gold tasks and comparisons through the bus handler on both
    sides: the same messages, stats, consensus, and files on disk."""
    got = {"jax": [], "port": []}
    jbus, tbus = JBus(), TBus()
    jbus.subscribe_sync("rater.reliability.updated", got["jax"].append)
    tbus.subscribe_sync("rater.reliability.updated", got["port"].append)
    js = jrel.RaterReliabilityService(tmp_path / "jax", bus=jbus,
                                      subjects=JSubjects())
    ts = trel.RaterReliabilityService(tmp_path / "port", bus=tbus,
                                      subjects=TSubjects())
    for vid, lab in (("v0", 1), ("v1", 0), ("v2", 1), ("v5", 0)):
        js.add_gold_task(vid, lab)
        ts.add_gold_task(vid, lab)
    for c in comparisons(7, n=40):
        js.handle_comparison_submitted(c)
        ts.handle_comparison_submitted(c)
    assert_close(got["port"], got["jax"])
    assert len(got["port"]) == 40
    assert_close(ts.get_all_rater_stats(), js.get_all_rater_stats())
    for vid in list(js.annotations) + ["nobody"]:
        assert_close(ts.compute_weighted_consensus(vid),
                     js.compute_weighted_consensus(vid))
    assert_close(ts.get_consensus_for_all_videos(),
                 js.get_consensus_for_all_videos())
    for name in ("gold_tasks.json", "annotations.json", "rater_stats.json"):
        assert_close(json.loads((tmp_path / "port" / name).read_text()),
                     json.loads((tmp_path / "jax" / name).read_text()))
    # persistence: a new service reads the three files back
    again = trel.RaterReliabilityService(tmp_path / "port")
    assert again.gold_tasks == ts.gold_tasks
    assert again.annotations == ts.annotations
    assert_close(again.get_all_rater_stats(), ts.get_all_rater_stats())
