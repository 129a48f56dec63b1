"""Annotated-video renderer: skeleton + detections + info overlay (port of
``lameness_tpu/serve/annotation.py``).

Behavioral rebuild of ``services/annotation-renderer/app/main.py``: the
corrected Roboflow skeleton chains/edges (main.py:67-95), robust keypoint
reindexing by id/name with synonym normalisation (108-223),
walking-direction detection (252), per-body-part edge colouring, YOLO box
drawing, and the info overlay — producing the ``{video_id}_annotated.mp4``
the admin UI streams (mp4v, by the port's own encoder: ``video/decode.py``).

The JAX module draws with OpenCV, which the machine with the card lacks.
Here every primitive is ``serve/raster.py``'s: the same pixels as
OpenCV's, computed as blend lists on the host and applied to the frames on
the renderer's device (the card unless ``device="cpu"``), which is also
where the processed video is decoded and the annotated one encoded.  The
draw functions take and return an (H, W, 3) uint8 RGB tensor (JAX's take
BGR arrays); the colours below are JAX's BGR triples.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..video.decode import RGB_BATCH, VideoReader, write_video
from ..video.yuv import i420_to_rgb
from . import raster

NUM_KP = 20
KEYPOINT_NAMES = [
    "left_ear_base", "neck", "withers", "mid_back", "right_hind_hip",
    "right_hind_mid_leg", "right_hind_fetlock", "left_hind_shoulder",
    "left_hind_mid_leg", "left_hind_fetlock", "right_front_shoulder",
    "right_front_mid_leg", "right_front_lower_leg", "left_front_shoulder",
    "left_front_mid_leg", "left_front_lower_leg", "right_front_hoof",
    "left_front_hoof", "right_hind_hoof", "left_hind_hoof",
]
_NAME_TO_ID = {n: i for i, n in enumerate(KEYPOINT_NAMES)}
# old animal-pose synonyms (heuristic pose emits these)
_SYNONYMS = {
    "left_ear": 0, "right_ear": 0, "nose": 0, "left_eye": 0, "right_eye": 0,
    "throat": 1, "tailbase": 3,
    "left_front_elbow": 13, "right_front_elbow": 10,
    "left_back_elbow": 7, "right_back_elbow": 4,
    "left_front_knee": 14, "right_front_knee": 11,
    "left_back_knee": 8, "right_back_knee": 5,
    "left_front_paw": 17, "right_front_paw": 16,
    "left_back_paw": 19, "right_back_paw": 18,
}

# corrected chains/edges (annotation-renderer:67-95)
EDGES_BODY = [(0, 1), (1, 2), (2, 3), (2, 10), (2, 13), (3, 7), (3, 4)]
EDGES_FRONT_L = [(13, 14), (14, 15), (15, 17)]
EDGES_FRONT_R = [(10, 11), (11, 12), (12, 16)]
EDGES_HIND_L = [(7, 8), (8, 9), (9, 19)]
EDGES_HIND_R = [(4, 5), (5, 6), (6, 18)]
ALL_EDGES = EDGES_BODY + EDGES_FRONT_L + EDGES_FRONT_R + EDGES_HIND_L \
    + EDGES_HIND_R
SKELETON_COLORS = {
    "head": (0, 255, 255), "spine": (0, 255, 0), "front_left": (255, 0, 0),
    "front_right": (0, 165, 255), "hind_left": (255, 0, 255),
    "hind_right": (255, 255, 0),
}
WHITE, BLACK = (255, 255, 255), (0, 0, 0)
# one draw: (blends, BGR colour)
Draw = Tuple[raster.Ops, Tuple[int, int, int]]


def _norm_name(s: str) -> str:
    return s.strip().lower().replace(" ", "_").replace("-", "_")


def reindex_keypoints(raw: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Mixed id/name keypoints -> fixed 20-slot list (renderer:156-223)."""
    out: List[Optional[Dict[str, Any]]] = [None] * NUM_KP
    for kp in raw:
        idx = None
        if "id" in kp and isinstance(kp["id"], int) and 0 <= kp["id"] < NUM_KP:
            idx = kp["id"]
        elif "name" in kp:
            name = _norm_name(str(kp["name"]))
            idx = _NAME_TO_ID.get(name, _SYNONYMS.get(name))
        if idx is None:
            continue
        cand = {"x": float(kp.get("x", 0)), "y": float(kp.get("y", 0)),
                "confidence": float(kp.get("confidence", 0))}
        if out[idx] is None or cand["confidence"] > out[idx]["confidence"]:
            out[idx] = cand
    return [kp or {"x": 0.0, "y": 0.0, "confidence": 0.0} for kp in out]


def detect_walking_direction(keypoints: List[Dict]) -> str:
    """head (withers/neck) left of hips -> right_to_left (renderer:252-271)."""
    head_x = [keypoints[i]["x"] for i in (0, 1, 2)
              if keypoints[i]["confidence"] > 0.2]
    hip_x = [keypoints[i]["x"] for i in (4, 7, 3)
             if keypoints[i]["confidence"] > 0.2]
    if not head_x or not hip_x:
        return "unknown"
    return "left_to_right" if np.mean(head_x) > np.mean(hip_x) \
        else "right_to_left"


def _edge_color(edge: Tuple[int, int]) -> Tuple[int, int, int]:
    if edge in EDGES_FRONT_L:
        return SKELETON_COLORS["front_left"]
    if edge in EDGES_FRONT_R:
        return SKELETON_COLORS["front_right"]
    if edge in EDGES_HIND_L:
        return SKELETON_COLORS["hind_left"]
    if edge in EDGES_HIND_R:
        return SKELETON_COLORS["hind_right"]
    if edge in ((0, 1),):
        return SKELETON_COLORS["head"]
    return SKELETON_COLORS["spine"]


# -- the draws, as blend lists (host) ----------------------------------------
def skeleton_draws(w: int, h: int, keypoints: List[Dict],
                   conf_threshold: float = 0.25, radius: int = 4,
                   thickness: int = 2) -> List[Draw]:
    """``draw_skeleton``'s draws in OpenCV's order: the edges
    (anti-aliased lines), then each keypoint's filled white disc and black
    ring."""
    kps = reindex_keypoints(keypoints)
    out: List[Draw] = []
    for i, j in ALL_EDGES:
        if kps[i]["confidence"] > conf_threshold and \
                kps[j]["confidence"] > conf_threshold:
            p1 = (int(kps[i]["x"]), int(kps[i]["y"]))
            p2 = (int(kps[j]["x"]), int(kps[j]["y"]))
            out.append((raster.thick_line_aa(w, h, p1, p2, thickness),
                        _edge_color((i, j))))
    for kp in kps:
        if kp["confidence"] > conf_threshold:
            c = (int(kp["x"]), int(kp["y"]))
            out.append((raster.circle_aa(w, h, c, radius, True), WHITE))
            out.append((raster.circle_aa(w, h, c, radius, False), BLACK))
    return out


def detection_draws(w: int, h: int, detections: List[Dict],
                    color=(0, 200, 0)) -> List[Draw]:
    """``draw_detections``'s draws: each box (thickness 2) and its label."""
    out: List[Draw] = []
    for det in detections:
        b = det.get("bbox")
        if not b:
            continue
        out.append((raster.rectangle(w, h, (int(b[0]), int(b[1])),
                                     (int(b[2]), int(b[3])), 2), color))
        label = f"{det.get('class', 'cow')} {det.get('confidence', 0):.2f}"
        out.append((raster.text(w, h, label,
                                (int(b[0]), max(12, int(b[1]) - 5))), color))
    return out


def overlay_box(lines: List[str]) -> Tuple[int, int, int, int]:
    """The info overlay's dark box (x1, y1, x2, y2), corners included."""
    pad, lh = 8, 20
    hh = pad * 2 + lh * len(lines)
    ww = max((len(l) for l in lines), default=0) * 9 + pad * 2
    return 5, 5, 5 + ww, 5 + hh


def overlay_text_draws(w: int, h: int, lines: List[str]) -> List[Draw]:
    pad, lh = 8, 20
    return [(raster.text(w, h, line, (5 + pad, 5 + pad + lh * (i + 1) - 6)),
             WHITE) for i, line in enumerate(lines)]


# -- the pixels (the frames' device) -----------------------------------------
def _rgb(bgr: Sequence[int]) -> Tuple[int, int, int]:
    return (int(bgr[2]), int(bgr[1]), int(bgr[0]))


def _apply(frames: torch.Tensor, draws: Sequence[Tuple[int, Draw]]) -> None:
    raster.apply(frames, [(fi, ops, _rgb(c)) for fi, (ops, c) in draws])


def blend_overlays(frames: torch.Tensor,
                   boxes: Sequence[Tuple[int, int, int, int]]) -> None:
    """In place: each frame's box darkened as ``cv2.addWeighted(overlay,
    0.55, frame, 0.45, 0)`` with ``overlay`` the frame with the box filled
    black.  Outside the boxes that blend gives each pixel back unchanged
    (``fma(v, 0.55, v * 0.45)`` rounds to ``v`` for every uint8), so only
    the boxes' bounding region is computed."""
    n, h, w, _ = frames.shape
    x2 = min(max(b[2] for b in boxes), w - 1)
    y2 = min(max(b[3] for b in boxes), h - 1)
    if x2 < 0 or y2 < 0:
        return
    region = frames[:, :y2 + 1, :x2 + 1]
    overlay = region.clone()
    raster.apply(overlay, [(fi, raster.rectangle(x2 + 1, y2 + 1, b[:2],
                                                 b[2:], -1), BLACK)
                           for fi, b in enumerate(boxes)])
    region.copy_(raster.add_weighted(overlay, 0.55, region, 0.45))


def draw_skeleton(frame: torch.Tensor, keypoints: List[Dict],
                  conf_threshold: float = 0.25, radius: int = 4,
                  thickness: int = 2) -> torch.Tensor:
    h, w = frame.shape[:2]
    _apply(frame[None], [(0, d) for d in skeleton_draws(
        w, h, keypoints, conf_threshold, radius, thickness)])
    return frame


def draw_detections(frame: torch.Tensor, detections: List[Dict],
                    color=(0, 200, 0)) -> torch.Tensor:
    h, w = frame.shape[:2]
    _apply(frame[None], [(0, d) for d in detection_draws(
        w, h, detections, color)])
    return frame


def draw_info_overlay(frame: torch.Tensor, lines: List[str]) -> torch.Tensor:
    h, w = frame.shape[:2]
    blend_overlays(frame[None], [overlay_box(lines)])
    _apply(frame[None], [(0, d) for d in overlay_text_draws(w, h, lines)])
    return frame


class AnnotationRenderer:
    def __init__(self, dirs, device=None):
        """``device``: where frames are decoded, drawn on and encoded (the
        card by default; resolved at each render)."""
        self.dirs = dirs
        self.device = device
        self.out_dir = dirs.root and Path(dirs.root) / "annotated"
        Path(self.out_dir).mkdir(parents=True, exist_ok=True)
        self.status: Dict[str, Dict[str, Any]] = {}

    def render(self, video_id: str,
               video_path: Optional[Path] = None) -> Optional[Path]:
        """Overlay skeletons (tleap), boxes (yolo) and an info banner on the
        processed video (renderer:626-860)."""
        if video_path is None:
            candidates = (list(self.dirs.processed.glob(
                f"{video_id}_cropped.mp4"))
                + list(self.dirs.videos.glob(f"{video_id}.*")))
            if not candidates:
                self.status[video_id] = {"status": "failed",
                                         "error": "video not found"}
                return None
            video_path = candidates[0]
        self.status[video_id] = {"status": "rendering"}
        yolo = self._read("yolo", video_id) or {}
        tleap = self._read("tleap", video_id) or {}
        fusion = self._read("fusion", video_id) or {}

        dets_by_frame: Dict[int, List[Dict]] = {}
        for entry in yolo.get("detections", []):
            dets_by_frame[entry["frame"]] = entry.get("detections", [])
        pose_by_frame: Dict[int, Dict] = {}
        for seq in tleap.get("pose_sequences", []):
            pose_by_frame[seq["frame"]] = seq

        prob = fusion.get("fusion_result", {}).get("final_probability")
        device = resolve_device(self.device)
        chunks: List[torch.Tensor] = []
        direction = "unknown"
        # the draws of each detection and pose entry (nearby frames reuse
        # the same entry)
        det_draws: Dict[int, List[Draw]] = {}
        pose_draws: Dict[int, Tuple[List[Draw], str]] = {}
        with VideoReader(video_path, device=device) as vr:
            fps = vr.info["fps"]
            h, w = vr.info["height"], vr.info["width"]
            for start, i420 in vr.i420_chunks(RGB_BATCH):
                frames = i420_to_rgb(torch.from_numpy(i420).to(device))
                pre: List[Tuple[int, Draw]] = []
                post: List[Tuple[int, Draw]] = []
                boxes = []
                for fi in range(len(frames)):
                    idx = start + fi
                    near_det = self._nearest(dets_by_frame, idx, 15)
                    if near_det is not None:
                        if near_det not in det_draws:
                            det_draws[near_det] = detection_draws(
                                w, h, dets_by_frame[near_det])
                        pre += [(fi, d) for d in det_draws[near_det]]
                    near_pose = self._nearest(pose_by_frame, idx, 15)
                    if near_pose is not None:
                        if near_pose not in pose_draws:
                            kps = pose_by_frame[near_pose].get("keypoints",
                                                               [])
                            pose_draws[near_pose] = (
                                skeleton_draws(w, h, kps),
                                detect_walking_direction(
                                    reindex_keypoints(kps)))
                        draws, d = pose_draws[near_pose]
                        pre += [(fi, x) for x in draws]
                        if d != "unknown":
                            direction = d
                    lines = [f"video: {video_id[:13]}", f"frame: {idx}",
                             f"direction: {direction}"]
                    if prob is not None:
                        lines.append(f"lameness: {prob:.1%}")
                    boxes.append(overlay_box(lines))
                    post += [(fi, d) for d in overlay_text_draws(w, h, lines)]
                _apply(frames, pre)
                blend_overlays(frames, boxes)
                _apply(frames, post)
                chunks.append(frames)
        out_path = write_video(Path(self.out_dir)
                               / f"{video_id}_annotated.mp4",
                               torch.cat(chunks) if chunks else [], fps)
        n = sum(len(c) for c in chunks)
        self.status[video_id] = {"status": "completed",
                                 "output": str(out_path), "frames": n}
        return out_path

    @staticmethod
    def _nearest(d: Dict[int, Any], idx: int, tol: int) -> Optional[int]:
        if not d:
            return None
        best = min(d, key=lambda k: abs(k - idx))
        return best if abs(best - idx) <= tol else None

    def _read(self, pipeline: str, video_id: str) -> Optional[Dict]:
        f = self.dirs.results_for(pipeline) / f"{video_id}_{pipeline}.json"
        if f.exists():
            try:
                return json.load(open(f))
            except Exception:
                return None
        return None
