"""Fusion: the gated multi-pipeline lameness score and the cow aggregation
(port of ``lameness_tpu/fuse/fusion.py``, copied line for line: host
Python and numpy).

- pipeline weights ml .15 / tcn .12 / transformer .12 / gnn .08 /
  graph_transformer .18 / human .35 (fusion:102-109);
- gating rules -> human / automated / hybrid / uncertain (fusion:457-499);
- uncertainty-adjusted weighted-average fusion, or the stacking
  meta-model ``models/fusion/stacking_model.pkl`` when one loads
  (fusion:501-607);
- cow-level aggregation, confidence x recency weighted, severity bands
  0.3 / 0.5 / 0.7 (fusion:226-314).
"""
from __future__ import annotations

import json
import pickle
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..io import schemas

PIPELINE_WEIGHTS = {
    "ml": 0.15, "tcn": 0.12, "transformer": 0.12, "gnn": 0.08,
    "graph_transformer": 0.18, "human": 0.35,
}
HIGH_CONFIDENCE_THRESHOLD = 0.85
LOW_CONFIDENCE_THRESHOLD = 0.55
AUTO_KEYS = ("ml", "tcn", "transformer", "gnn", "graph_transformer")


def severity_level(score: float) -> str:
    if score < 0.3:
        return "healthy"
    if score < 0.5:
        return "mild"
    if score < 0.7:
        return "moderate"
    return "severe"


def apply_gating_rules(predictions: Dict[str, Any]) -> Tuple[str, str]:
    """fusion:457-499."""
    human = predictions.get("human", {})
    human_conf = human.get("confidence", 0)
    human_raters = human.get("num_raters", 0)
    auto = [predictions[k].get("probability", 0.5)
            for k in AUTO_KEYS if k in predictions]
    if not auto:
        if human_raters > 0:
            return "human", ("No automated predictions available; "
                             "using human consensus")
        return "uncertain", "Insufficient data from all sources"
    auto_std = float(np.std(auto))
    auto_agreement = 1.0 - auto_std
    if human_conf >= HIGH_CONFIDENCE_THRESHOLD and human_raters >= 3:
        return "human", (f"High human consensus confidence ({human_conf:.2f}) "
                         f"with {human_raters} raters")
    if auto_agreement >= 0.9 and all(abs(p - 0.5) > 0.3 for p in auto):
        return "automated", (f"Strong model agreement ({auto_agreement:.2f}) "
                             "with high confidence")
    if auto_std > 0.25:
        return "uncertain", (f"Model disagreement (std={auto_std:.2f}); "
                             "more human labels recommended")
    return "hybrid", "Moderate confidence; combining human and automated predictions"


def fuse_predictions(predictions: Dict[str, Any],
                     stacking_model=None) -> Dict[str, Any]:
    """fusion:501-607."""
    decision_mode, gate_explanation = apply_gating_rules(predictions)
    probs: Dict[str, float] = {}
    uncertainties: Dict[str, float] = {}
    for key in (*AUTO_KEYS, "human"):
        if key in predictions:
            probs[key] = predictions[key].get("probability", 0.5)
            uncertainties[key] = predictions[key].get(
                "uncertainty", 1.0 - predictions[key].get("confidence", 0.5))

    if decision_mode == "human" and "human" in probs:
        fusion_prob = probs["human"]
        confidence = predictions["human"].get("confidence", 0.5)
    elif decision_mode == "automated":
        if stacking_model is not None:
            feats = [probs.get(k, 0.5) for k in AUTO_KEYS]
            try:
                fusion_prob = float(
                    stacking_model.predict_proba([feats])[0, 1])
            except Exception:
                fusion_prob = float(np.mean(list(probs.values())))
        else:
            weighted = total = 0.0
            for key in AUTO_KEYS:
                if key in probs:
                    w = PIPELINE_WEIGHTS.get(key, 0.1)
                    w *= 1.0 - uncertainties.get(key, 0.5) * 0.5
                    weighted += probs[key] * w
                    total += w
            fusion_prob = weighted / total if total > 0 else 0.5
        auto_probs = [v for k, v in probs.items() if k != "human"]
        confidence = 1.0 - float(np.std(auto_probs)) if auto_probs else 0.5
    elif decision_mode == "hybrid":
        weighted = total = 0.0
        for key, p in probs.items():
            w = PIPELINE_WEIGHTS.get(key, 0.1)
            w *= 1.0 - uncertainties.get(key, 0.5) * 0.5
            weighted += p * w
            total += w
        fusion_prob = weighted / total if total > 0 else 0.5
        confidence = 1.0 - float(np.std(list(probs.values())))
    else:
        fusion_prob, confidence = 0.5, 0.0

    all_probs = list(probs.values())
    model_agreement = 1.0 - float(np.std(all_probs)) if all_probs else 0.0
    all_preds = [int(p > 0.5) for p in all_probs]
    unanimous = len(set(all_preds)) == 1 if all_preds else False
    if confidence < 0.3 or decision_mode == "uncertain":
        recommendation = "Request more human labels for this video"
    elif fusion_prob > 0.7:
        recommendation = ("High lameness probability - consider veterinary "
                          "examination")
    elif fusion_prob < 0.3:
        recommendation = "Low lameness probability - monitor routine"
    else:
        recommendation = "Moderate lameness indication - continue observation"

    return {
        "final_probability": float(fusion_prob),
        "final_prediction": int(fusion_prob > 0.5),
        "confidence": float(confidence),
        "decision_mode": decision_mode,
        "gate_explanation": gate_explanation,
        "model_agreement": float(model_agreement),
        "unanimous": unanimous,
        "recommendation": recommendation,
        "pipeline_contributions": {
            key: {"probability": float(probs[key]),
                  "uncertainty": float(uncertainties.get(key, 0.5)),
                  "prediction": int(probs[key] > 0.5),
                  "weight": PIPELINE_WEIGHTS.get(key, 0.1)}
            for key in (*AUTO_KEYS, "human") if key in probs
        },
        "pipelines_used": list(probs.keys()),
        "tleap_features": predictions.get("tleap", {}),
        "yolo_features": predictions.get("yolo", {}),
    }


class FusionService:
    """File-contract-preserving fusion driver over the shared data dirs."""

    def __init__(self, dirs, bus=None, subjects=None,
                 record_sink: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.dirs = dirs
        self.results_dir = dirs.results_for("fusion")
        self.cow_results_dir = dirs.results / "cow_predictions"
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.cow_results_dir.mkdir(parents=True, exist_ok=True)
        self.bus = bus
        self.subjects = subjects
        self.record_sink = record_sink
        self.cow_id_mapping: Dict[str, str] = {}
        self.stacking_model = None
        stacking_file = dirs.models / "fusion" / "stacking_model.pkl"
        if stacking_file.exists():
            # a model pickled where its library (sklearn) is installed does
            # not load without it: fuse by the weights then, as JAX does
            try:
                with open(stacking_file, "rb") as fh:
                    self.stacking_model = pickle.load(fh)
            except Exception:
                pass

    # -- cow id mapping from tracking results (fusion:185-218) --------------
    def load_cow_id_mapping(self) -> Dict[str, str]:
        mapping: Dict[str, str] = {}
        tracking_dir = self.dirs.results_for("tracking")
        if tracking_dir.exists():
            for f in tracking_dir.glob("*_tracking.json"):
                try:
                    data = json.load(open(f))
                except Exception:
                    continue
                vid = data.get("video_id")
                for reid in data.get("reid_results", []):
                    if reid.get("cow_id"):
                        mapping[vid] = reid["cow_id"]
                        break
        self.cow_id_mapping = mapping
        return mapping

    def get_cow_for_video(self, video_id: str) -> Optional[str]:
        if not self.cow_id_mapping:
            self.load_cow_id_mapping()
        return self.cow_id_mapping.get(video_id)

    def get_videos_for_cow(self, cow_id: str) -> List[str]:
        if not self.cow_id_mapping:
            self.load_cow_id_mapping()
        return [v for v, c in self.cow_id_mapping.items() if c == cow_id]

    # -- collection (fusion:368-455) -----------------------------------------
    def collect_pipeline_predictions(self, video_id: str) -> Dict[str, Any]:
        predictions: Dict[str, Any] = {}

        def read(pipeline: str) -> Optional[Dict[str, Any]]:
            f = self.dirs.results_for(pipeline) / f"{video_id}_{pipeline}.json"
            if f.exists():
                try:
                    return json.load(open(f))
                except Exception:
                    return None
            return None

        ml = read("ml")
        if ml and "predictions" in ml:
            predictions["ml"] = {
                "probability": ml["predictions"].get("ensemble", {}).get(
                    "probability", 0.5),
                "uncertainty": 0.1,
                "model_predictions": ml["predictions"],
            }
        tcn = read("tcn")
        if tcn:
            predictions["tcn"] = {
                "probability": tcn.get("severity_score", 0.5),
                "uncertainty": tcn.get("uncertainty", 0.1)}
        tr = read("transformer")
        if tr:
            predictions["transformer"] = {
                "probability": tr.get("severity_score", 0.5),
                "uncertainty": tr.get("uncertainty", 0.1),
                "temporal_saliency": tr.get("temporal_saliency", [])}
        gnn = read("gnn")
        if gnn:
            predictions["gnn"] = {
                "probability": gnn.get("severity_score", 0.5),
                "uncertainty": gnn.get("uncertainty", 0.1),
                "neighbor_influence": gnn.get("neighbor_influence", [])}
        gt = read("graph_transformer")
        if gt:
            predictions["graph_transformer"] = {
                "probability": gt.get("graph_prediction", 0.5),
                "uncertainty": gt.get("uncertainty", 0.1),
                "node_prediction": gt.get("node_prediction", 0.5),
                "attention_info": gt.get("attention_info", {})}
        human_file = (self.dirs.rater_reliability / "consensus"
                      / f"{video_id}.json")
        if human_file.exists():
            try:
                h = json.load(open(human_file))
                predictions["human"] = {
                    "probability": h.get("probability", 0.5),
                    "confidence": h.get("confidence", 0.5),
                    "num_raters": h.get("num_raters", 0)}
            except Exception:
                pass
        yolo = read("yolo")
        if yolo and "features" in yolo:
            predictions["yolo"] = yolo["features"]
        tleap = read("tleap")
        if tleap:
            predictions["tleap"] = tleap.get("locomotion_features", {})
        return predictions

    # -- cow aggregation (fusion:226-314) ------------------------------------
    def aggregate_cow_predictions(self, cow_id: str) -> Dict[str, Any]:
        videos = self.get_videos_for_cow(cow_id)
        empty = {"cow_id": cow_id, "aggregated_score": 0.5, "confidence": 0.0,
                 "num_videos": 0, "prediction": 0, "severity_level": "unknown"}
        if not videos:
            return empty
        scores, confidences, timestamps = [], [], []
        for vid in videos:
            f = self.results_dir / f"{vid}_fusion.json"
            if f.exists():
                try:
                    data = json.load(open(f))
                    fr = data.get("fusion_result", {})
                    scores.append(fr.get("final_probability", 0.5))
                    confidences.append(fr.get("confidence", 0.5))
                    timestamps.append(f.stat().st_mtime)
                except Exception:
                    continue
        if not scores:
            empty["num_videos"] = len(videos)
            return empty
        scores_a = np.asarray(scores)
        conf_a = np.asarray(confidences)
        ts = np.asarray(timestamps)
        if len(ts) > 1 and ts.max() > ts.min():
            recency = (ts - ts.min()) / (ts.max() - ts.min())
        else:
            recency = np.ones_like(ts)
        weights = conf_a * (0.5 + 0.5 * recency)
        weights = weights / weights.sum() if weights.sum() > 0 \
            else np.ones_like(weights) / len(weights)
        agg = float(np.sum(scores_a * weights))
        return {
            "cow_id": cow_id,
            "aggregated_score": agg,
            "confidence": float(np.mean(conf_a)),
            "num_videos": len(scores),
            "total_videos": len(videos),
            "prediction": int(agg > 0.5),
            "severity_level": severity_level(agg),
            "video_ids": videos,
        }

    # -- main entry (fusion:609-716) -----------------------------------------
    def process_video(self, video_id: str,
                      timestamp: str = "") -> Optional[Dict[str, Any]]:
        cow_id = self.get_cow_for_video(video_id)
        predictions = self.collect_pipeline_predictions(video_id)
        if not predictions:
            return None
        fusion_result = fuse_predictions(predictions, self.stacking_model)
        fusion_result["cow_id"] = cow_id
        cow_prediction = None
        if cow_id:
            schemas.write_result(
                self.results_dir / f"{video_id}_fusion.json",
                schemas.fusion_result_file(video_id, cow_id, fusion_result,
                                           None, predictions, timestamp))
            cow_prediction = self.aggregate_cow_predictions(cow_id)
            schemas.write_result(
                self.cow_results_dir / f"{cow_id}_prediction.json",
                schemas.cow_prediction_file(
                    cow_id, cow_prediction,
                    latest_video=video_id,
                    last_updated=datetime.now(timezone.utc).isoformat()))
            if self.record_sink is not None:
                self.record_sink({
                    "video_id": video_id, "cow_id": cow_id,
                    "fusion_result": fusion_result,
                    "predictions": predictions})
        results = schemas.fusion_result_file(video_id, cow_id, fusion_result,
                                             cow_prediction, predictions,
                                             timestamp)
        schemas.write_result(self.results_dir / f"{video_id}_fusion.json",
                             results)
        if self.bus is not None:
            subj_done = (self.subjects.analysis_complete if self.subjects
                         else "analysis.complete")
            self.bus.publish_sync(subj_done, {
                "video_id": video_id, "cow_id": cow_id,
                "fusion_result": fusion_result,
                "results_path": str(self.results_dir
                                    / f"{video_id}_fusion.json")})
            if cow_id and cow_prediction:
                subj_cow = (self.subjects.cow_prediction_updated if self.subjects
                            else "cow.prediction.updated")
                self.bus.publish_sync(subj_cow, {
                    "cow_id": cow_id, "prediction": cow_prediction})
        return results
