"""Rater reliability service: tiers, weighted consensus, persistence (port of
``lameness_tpu/hitl/reliability.py``, copied line for line: host numpy).

Behavioral rebuild of ``services/rater-reliability/app/main.py:291-603``:
gold-task accuracy → gold/silver/bronze tiers (0.85/0.70) with weights
1.5/1.0/0.5 scaled by Dawid-Skene ability; agreement rate vs the per-item
majority of other raters; weighted lame/sound consensus with confidence
|p − 0.5|·2; JSON persistence in the reference's three-file layout
(``data/rater_reliability/{gold_tasks,annotations,rater_stats}.json``);
pairwise submissions recorded as relative labels (winner = more lame).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from .dawid_skene import DawidSkene
from .glad import GLAD

TIER_THRESHOLDS = {"gold": 0.85, "silver": 0.70, "bronze": 0.0}
TIER_WEIGHTS = {"gold": 1.5, "silver": 1.0, "bronze": 0.5}


@dataclass
class RaterStats:
    rater_id: str
    total_comparisons: int
    gold_task_accuracy: float
    estimated_ability: float
    tier: str
    weight: float
    confusion_matrix: List[List[float]]
    agreement_rate: float


@dataclass
class ConsensusResult:
    video_id: str
    estimated_label: int
    probability: float
    confidence: float
    num_raters: int
    weighted_votes: Dict[str, float]
    rater_contributions: List[Dict[str, Any]]


def determine_tier(gold_accuracy: float) -> str:
    if gold_accuracy >= TIER_THRESHOLDS["gold"]:
        return "gold"
    if gold_accuracy >= TIER_THRESHOLDS["silver"]:
        return "silver"
    return "bronze"


_DEFAULT_STATS = dict(total_comparisons=1, gold_task_accuracy=0.5,
                      estimated_ability=0.5, tier="bronze", weight=0.5,
                      confusion_matrix=[[0.5, 0.5], [0.5, 0.5]],
                      agreement_rate=0.5)


class RaterReliabilityService:
    def __init__(self, data_dir: Path, bus=None, subjects=None):
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.bus = bus
        self.subjects = subjects
        self.dawid_skene = DawidSkene(num_classes=2)
        self.glad = GLAD()
        self.rater_stats: Dict[str, RaterStats] = {}
        self.gold_tasks: Dict[str, int] = {}
        self.annotations: Dict[str, Dict[str, int]] = {}
        self._load()

    # -- persistence (reference three-file layout) --------------------------
    def _load(self):
        for name, attr in (("gold_tasks", "gold_tasks"),
                           ("annotations", "annotations")):
            p = self.data_dir / f"{name}.json"
            if p.exists():
                setattr(self, attr, json.load(open(p)))
        p = self.data_dir / "rater_stats.json"
        if p.exists():
            self.rater_stats = {k: RaterStats(**v)
                                for k, v in json.load(open(p)).items()}

    def _save(self):
        from ..io import schemas
        schemas.write_result(self.data_dir / "gold_tasks.json",
                             self.gold_tasks)
        schemas.write_result(self.data_dir / "annotations.json",
                             self.annotations)
        schemas.write_result(
            self.data_dir / "rater_stats.json",
            {k: asdict(v) for k, v in self.rater_stats.items()})

    # -- data entry ----------------------------------------------------------
    def add_gold_task(self, video_id: str, true_label: int):
        self.gold_tasks[video_id] = true_label
        self._save()

    def record_annotation(self, video_id: str, rater_id: str, label: int):
        self.annotations.setdefault(video_id, {})[rater_id] = label
        self._save()

    # -- stats ---------------------------------------------------------------
    def compute_gold_task_accuracy(self, rater_id: str) -> float:
        correct = total = 0
        for vid, true_label in self.gold_tasks.items():
            lab = self.annotations.get(vid, {}).get(rater_id)
            if lab is not None:
                correct += int(lab == true_label)
                total += 1
        return correct / total if total else 0.5

    def update_rater_stats(self):
        all_raters = {r for anns in self.annotations.values() for r in anns}
        confusions = {}
        if self.annotations:
            _, confusions = self.dawid_skene.fit(self.annotations)
        for rater_id in all_raters:
            total = sum(1 for anns in self.annotations.values()
                        if rater_id in anns)
            gold_acc = self.compute_gold_task_accuracy(rater_id)
            tier = determine_tier(gold_acc)
            if rater_id in confusions:
                ability = self.dawid_skene.get_rater_ability(rater_id)
                cm = confusions[rater_id].tolist()
            else:
                ability = 0.5 + (gold_acc - 0.5) * 0.5
                cm = [[0.5, 0.5], [0.5, 0.5]]
            agreements = opportunities = 0
            for anns in self.annotations.values():
                if rater_id in anns:
                    others = [l for r, l in anns.items() if r != rater_id]
                    if others:
                        majority = max(set(others), key=others.count)
                        agreements += int(anns[rater_id] == majority)
                        opportunities += 1
            agreement = agreements / opportunities if opportunities else 0.5
            self.rater_stats[rater_id] = RaterStats(
                rater_id=rater_id, total_comparisons=total,
                gold_task_accuracy=gold_acc, estimated_ability=ability,
                tier=tier, weight=TIER_WEIGHTS[tier] * ability,
                confusion_matrix=cm, agreement_rate=agreement)
        self._save()

    def compute_weighted_consensus(self, video_id: str,
                                   refresh_stats: bool = True
                                   ) -> Optional[ConsensusResult]:
        anns = self.annotations.get(video_id)
        if not anns:
            return None
        if refresh_stats:
            self.update_rater_stats()
        votes = {"lame": 0.0, "sound": 0.0}
        contributions = []
        for rater_id, label in anns.items():
            stats = self.rater_stats.get(
                rater_id, RaterStats(rater_id=rater_id, **_DEFAULT_STATS))
            votes["lame" if label == 1 else "sound"] += stats.weight
            contributions.append({"rater_id": rater_id, "label": label,
                                  "weight": stats.weight, "tier": stats.tier})
        total = votes["lame"] + votes["sound"]
        prob = votes["lame"] / total if total else 0.5
        return ConsensusResult(
            video_id=video_id, estimated_label=int(prob > 0.5),
            probability=prob, confidence=abs(prob - 0.5) * 2,
            num_raters=len(anns), weighted_votes=votes,
            rater_contributions=contributions)

    # -- bus handler ---------------------------------------------------------
    def handle_comparison_submitted(self, data: dict):
        """``hitl.comparison.submitted`` → relative labels (winner = more
        lame), stats refresh, ``rater.reliability.updated`` publication."""
        v1, v2 = data.get("video_id_1"), data.get("video_id_2")
        rater = data.get("rater_id", "anonymous")
        winner = data.get("winner")
        if winner == 1:
            self.record_annotation(v1, rater, 1)
            self.record_annotation(v2, rater, 0)
        elif winner == 2:
            self.record_annotation(v1, rater, 0)
            self.record_annotation(v2, rater, 1)
        self.update_rater_stats()
        if self.bus is not None and rater in self.rater_stats:
            s = self.rater_stats[rater]
            subject = (self.subjects.rater_reliability_updated
                       if self.subjects else "rater.reliability.updated")
            self.bus.publish_sync(subject, {
                "rater_id": rater, "tier": s.tier, "weight": s.weight,
                "gold_accuracy": s.gold_task_accuracy,
                "total_comparisons": s.total_comparisons})

    def get_all_rater_stats(self) -> List[Dict]:
        return [asdict(s) for s in self.rater_stats.values()]

    def get_consensus_for_all_videos(self) -> List[Dict]:
        # one stats refresh (Dawid-Skene EM) for the whole sweep — the
        # per-video default would re-run the EM V times
        self.update_rater_stats()
        out = []
        for vid in self.annotations:
            c = self.compute_weighted_consensus(vid, refresh_stats=False)
            if c:
                out.append(asdict(c))
        return out
