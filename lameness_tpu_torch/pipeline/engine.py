"""The clip engine on the card (port of ``lameness_tpu/pipeline/engine.py``).

  frames ─ letterbox ─→ YOLO detect (DFL + batched NMS)
        ├─ primary-box select (largest valid cow, full-frame fallback)
        ├─ SAM: 1024² pad → ViT encoder → box-prompted mask decoder
        ├─ DINO: 224² resize-crop → ViT-B/14 → mean-pooled embeddings
        └─ heuristic pose → locomotion features → 44-d sequences →
           TCN + GaitTransformer with batched MC-dropout

Four stages run one after another on device tensors (``run_staged``);
``process_clip_batch`` packs host frames, moves them to the device and reads
the output dict back as numpy.  Frames travel as RGB.  Stage sampling
follows the reference: detect/SAM 2 FPS, DINO 1 FPS, pose 5 FPS.

Not in this port yet (see ROADMAP.md): I420 and split ingest, the rect
SAM canvas, chunked SAM encoding, trained pose, the mesh, the monolith and
pair modes, the packed readback buffer and torch checkpoint loading.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..models import dino as dino_mod
from ..models import pose as pose_mod
from ..models import sequence_features as seqf
from ..models.gait_transformer import GaitTransformer
from ..models.sam import Sam, build_sam
from ..models.tcn import TCN
from ..models.yolo import YoloV8, detect
from ..ops import preprocess as prep
from ..ops.boxes import clip_boxes


@dataclasses.dataclass
class EngineSpec:
    """Static geometry of one clip batch."""
    clip_frames: int = 125           # canonical 5 s @ 25 fps
    frame_height: int = 720
    frame_width: int = 1280
    fps: int = 25
    yolo_size: int = 640
    pose_size: int = 640
    dino_size: int = 224
    sam_size: int = 1024
    max_det: int = 8
    use_sam_model: bool = True       # False => bbox-rectangle mask fallback
    sam_mask_size: int = 256         # decoder low-res mask side
    dtype: torch.dtype = torch.float32

    @property
    def det_idx(self):               # 2 FPS
        return np.arange(0, self.clip_frames, max(1, self.fps // 2))

    @property
    def dino_idx(self):              # 1 FPS
        return np.arange(0, self.clip_frames, max(1, self.fps))

    @property
    def pose_idx(self):              # 5 FPS
        return np.arange(0, self.clip_frames, max(1, self.fps // 5))

    # only frames some stage reads travel to the device (33 of 125)
    @property
    def packed_idx(self):
        return np.unique(np.concatenate([self.det_idx, self.dino_idx,
                                         self.pose_idx]))

    @property
    def n_packed(self) -> int:
        return int(len(self.packed_idx))

    @property
    def det_pos(self):
        return np.searchsorted(self.packed_idx, self.det_idx)

    @property
    def dino_pos(self):
        return np.searchsorted(self.packed_idx, self.dino_idx)

    def pack_frames(self, frames, out=None):
        """(B, T, H, W, 3) with T == clip_frames -> (B, P, H, W, 3); a
        passthrough if already packed.  With ``out`` (a numpy array of the
        packed shape) the frames are gathered into it."""
        t = frames.shape[1]
        if t not in (self.n_packed, self.clip_frames):
            raise ValueError(f"expected {self.clip_frames} (full) or "
                             f"{self.n_packed} (packed) frames, got {t}")
        if out is None:
            return frames if t == self.n_packed else frames[:, self.packed_idx]
        if t == self.n_packed:
            np.copyto(out, frames)
        else:
            # mode="clip": with mode="raise" numpy buffers ``out`` (a
            # second copy); the indices are in range
            np.take(frames, self.packed_idx, axis=1, out=out, mode="clip")
        return out


def unpad_mask_logits(masks: torch.Tensor, mh: int, mw: int,
                      out_size: int) -> torch.Tensor:
    """(N, Hm, Wm) low-res logits over the padded canvas -> (N, out, out)
    over the frame: slice the content region [:mh, :mw] and rescale."""
    if masks.shape[-2:] == (out_size, out_size) \
            and (mh, mw) == (out_size, out_size):
        return masks
    sub = masks[:, :mh, :mw, None]
    return prep.resize_nhwc(sub, (out_size, out_size))[..., 0]


def build_models(spec: EngineSpec, config: Config, device) -> Dict[str, Any]:
    """The default sub-models at (spec, config) geometry, uninitialised."""
    models = {
        "yolo": YoloV8("n", num_classes=config.yolo.num_classes,
                       device=device),
        "dino": dino_mod.DinoV2(device=device),     # ViT-B/14, dinov2-base
        "tcn": TCN(input_dim=44, device=device),
        "gait": GaitTransformer(input_dim=44, device=device),
    }
    if spec.use_sam_model:
        models["sam"] = build_sam(config.sam.variant, img_size=spec.sam_size,
                                  device=device)
    return models


class LamenessEngine:
    """Owns the sub-models and runs the four stages on ``device``.

    ``device=None`` means the CUDA device (and raises without one); only an
    explicit ``"cpu"`` runs the plain PyTorch path on the CPU.  Weights are
    seeded from ``generator`` (``weights.init_params``) unless
    ``init_models=False``; ``load_state_dicts`` installs others (e.g. from
    ``weights.from_jax_params``).  On the card the bf16 policy applies when
    ``config.compute.dtype == "bfloat16"``."""

    def __init__(self, config: Optional[Config] = None,
                 spec: Optional[EngineSpec] = None, device=None,
                 generator: Optional[torch.Generator] = None,
                 init_models: bool = True):
        self.config = config or Config()
        self.spec = spec or EngineSpec()
        self.device = resolve_device(device)
        self.precision: Dict[str, str] = {}
        self.yolo = self.dino = self.sam = self.tcn = self.gait = None
        if not init_models:
            return
        from ..weights import init_params
        for name, model in build_models(self.spec, self.config,
                                        self.device).items():
            setattr(self, name, model)
        generator = generator or torch.Generator().manual_seed(0)
        self.load_state_dicts(init_params(self.spec, self.config, generator))
        if self.device.type == "cuda" \
                and self.config.compute.dtype == "bfloat16":
            from .precision import apply_engine_policy
            self.precision = apply_engine_policy(self)

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping]) -> None:
        """Install {sub-model name: state dict} (strict key match)."""
        for name, sd in state_dicts.items():
            model = getattr(self, name)
            model.load_state_dict(sd, strict=True)
            model.eval()

    # -- stage 1: detection --------------------------------------------------
    def _primary_boxes(self, boxes, scores, classes, valid, h: float,
                       w: float):
        """Largest-area valid cow box per frame (tleap:295-304); with no cow,
        the largest non-cow detection above 0.5; else the full-frame
        0.1-margin fallback.  boxes: (N, K, 4)."""
        cow = self.config.yolo.cow_class_id
        areas = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * \
            (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
        minus1 = torch.full_like(areas, -1.0)
        cow_areas = torch.where(valid & (classes == cow), areas, minus1)
        any_areas = torch.where(valid & (scores > 0.5), areas, minus1)
        has_cow = cow_areas.max(dim=-1).values > 0
        has_any = any_areas.max(dim=-1).values > 0
        pick = torch.where(has_cow[:, None], cow_areas, any_areas)
        best = torch.argmax(pick, dim=-1)
        rows = torch.arange(boxes.shape[0], device=boxes.device)
        pb, ps = boxes[rows, best], scores[rows, best]
        has = has_cow | has_any
        fallback = torch.tensor([0.1 * w, 0.1 * h, 0.9 * w, 0.9 * h],
                                dtype=pb.dtype, device=pb.device)
        pb = torch.where(has[:, None], pb, fallback)
        ps = torch.where(has, ps, torch.full_like(ps, 0.5))
        return pb, ps, has

    def _det_frames(self, frames):
        s = self.spec
        return frames[:, s.det_pos], s.frame_height, s.frame_width

    def _detect_stage(self, frames):
        """frames (B, P, H, W, 3) packed uint8 -> boxes and primaries in
        frame coordinates."""
        s = self.spec
        det_frames, h, w = self._det_frames(frames)
        b, td = det_frames.shape[:2]
        canvases, ratio, pad = prep.letterbox(
            det_frames.reshape(b * td, h, w, 3), s.yolo_size)
        levels = self.yolo(canvases.to(s.dtype))["levels"]
        det = detect(levels,
                     conf_threshold=self.config.yolo.confidence_threshold,
                     max_det=s.max_det)
        boxes = clip_boxes(prep.unletterbox_boxes(det["boxes"], ratio, pad),
                           float(h), float(w))
        primary, primary_score, primary_valid = self._primary_boxes(
            boxes, det["scores"], det["classes"], det["valid"], float(h),
            float(w))
        return {
            "det_boxes": boxes.reshape(b, td, s.max_det, 4),
            "det_scores": det["scores"].reshape(b, td, s.max_det),
            "det_classes": det["classes"].reshape(b, td, s.max_det),
            "det_valid": det["valid"].reshape(b, td, s.max_det),
            "primary_boxes": primary.reshape(b, td, 4),
            "primary_scores": primary_score.reshape(b, td),
            "primary_valid": primary_valid.reshape(b, td),
        }

    # -- stage 2: segmentation ----------------------------------------------
    def _sam_stage(self, frames, primary_bt):
        """primary_bt: (B, Td, 4) in frame coordinates."""
        s = self.spec
        det_frames, h, w = self._det_frames(frames)
        b, td = det_frames.shape[:2]
        flat = det_frames.reshape(b * td, h, w, 3)
        primary = primary_bt.reshape(b * td, 4)
        if self.sam is not None:
            ratio = s.sam_size / max(h, w)
            sam_in, _ = prep.pad_to_rect(flat, (s.sam_size, s.sam_size),
                                         s.sam_size)
            sam_in = prep.normalize(sam_in).to(s.dtype)
            # content extent in low-res-mask pixels (mask = canvas / 4)
            mh = int(round((s.sam_size // 4) * (h * ratio) / s.sam_size))
            mw = int(round((s.sam_size // 4) * (w * ratio) / s.sam_size))
            # landscape frames bottom-pad the square canvas: the pad token
            # rows are image-independent (SamVisionEncoder content_rows).
            # LAMENESS_SAM_PADSPLIT=0 turns the split off, read at each
            # call as the JAX engine reads it at each trace
            crows = 0
            if w > h and os.environ.get("LAMENESS_SAM_PADSPLIT") != "0":
                crows = -(-int(round(h * ratio)) // 16)
            emb = self.sam.encode(sam_in, crows)
            masks, iou_pred = self.sam.decode_boxes(emb, primary * ratio)
            masks = unpad_mask_logits(masks[:, 0], mh, mw, s.sam_mask_size)
            iou_pred = iou_pred[:, 0]
        else:
            # reference fallback: rectangle mask from the box (sam3:94-100)
            m = s.sam_mask_size
            grid = torch.arange(m, dtype=torch.float32, device=flat.device)
            gy, gx = grid[:, None], grid[None, :]
            x1 = (primary[:, 0] * (m / w))[:, None, None]
            y1 = (primary[:, 1] * (m / h))[:, None, None]
            x2 = (primary[:, 2] * (m / w))[:, None, None]
            y2 = (primary[:, 3] * (m / h))[:, None, None]
            inside = (gx >= x1) & (gx < x2) & (gy >= y1) & (gy < y2)
            masks = torch.where(inside, 10.0, -10.0)
            iou_pred = torch.ones((b * td,), device=flat.device)
        mask_bits = masks > 0.0
        return {
            "masks": mask_bits.reshape(b, td, *mask_bits.shape[-2:]),
            "mask_iou_pred": iou_pred.reshape(b, td),
            "mask_area_frac": mask_bits.float().mean(dim=(-2, -1)
                                                     ).reshape(b, td),
        }

    # -- stage 3: embeddings -------------------------------------------------
    def _dino_stage(self, frames):
        s = self.spec
        dino_frames = frames[:, s.dino_pos]
        b, tdn = dino_frames.shape[:2]
        dino_in = dino_mod.preprocess_frames(dino_frames.reshape(
            b * tdn, s.frame_height, s.frame_width, 3)).to(s.dtype)
        out = self.dino(dino_in)
        return {"embeddings": out["pooled"].reshape(b, tdn, -1)}

    # -- stage 4: pose + sequence heads --------------------------------------
    def _heads_stage(self, primary_bt, score_bt,
                     generator: torch.Generator):
        """primary_bt: (B, Td, 4) detection-frame boxes; heads run at 5 FPS.
        MC-dropout is one batched forward of ``mc_samples`` replicas with
        masks drawn from ``generator``."""
        s = self.spec
        b = primary_bt.shape[0]
        pose_idx = s.pose_idx
        tp = len(pose_idx)
        nearest = np.abs(pose_idx[:, None] - s.det_idx[None, :]).argmin(1)
        nearest = torch.as_tensor(nearest, device=primary_bt.device)
        pose_boxes = primary_bt[:, nearest]                    # (B, Tp, 4)
        pose_scores = score_bt[:, nearest]
        pose_valid = torch.ones((b, tp), dtype=torch.bool,
                                device=primary_bt.device)
        kpts = pose_mod.heuristic_keypoints_device(pose_boxes)
        loco = pose_mod.locomotion_features_device(
            kpts[..., :2], kpts[..., 2], pose_valid)
        feats, low_conf = seqf.extract_from_arrays(
            kpts[..., :2], kpts[..., 2], pose_boxes, pose_scores, pose_valid)
        before = (seqf.TARGET_LEN - tp) // 2
        after = seqf.TARGET_LEN - tp - before
        feats_p = torch.nn.functional.pad(feats, (0, 0, before, after))
        mask_p = torch.nn.functional.pad(low_conf, (before, after),
                                         value=True)

        n_mc = self.config.tcn.mc_samples
        x_mc = feats_p.repeat(n_mc, 1, 1)                      # (n·B, T, F)
        m_mc = mask_p.repeat(n_mc, 1)
        tcn_preds = self.tcn(x_mc, generator=generator).view(n_mc, b)
        gait_preds = self.gait(x_mc, m_mc, generator=generator
                               )["probability"].view(n_mc, b)
        gait_det = self.gait(feats_p, mask_p)
        return {
            "keypoints": kpts,
            "pose_boxes": pose_boxes,
            "locomotion": loco,
            "seq_features": feats_p,
            "seq_mask": mask_p,
            "tcn_probability": tcn_preds.mean(dim=0),
            "tcn_uncertainty": tcn_preds.std(dim=0),
            "gait_probability": gait_preds.mean(dim=0),
            "gait_uncertainty": gait_preds.std(dim=0),
            "gait_saliency": gait_det["saliency"],
        }

    # -- public API ----------------------------------------------------------
    def to_device(self, frames) -> torch.Tensor:
        """Host (B, T|P, H, W, 3) uint8 RGB -> packed device tensor.  On the
        card the packed frames are gathered straight into a pinned host
        buffer (PyTorch's caching host allocator reuses it across calls),
        whose copy to the device runs asynchronously on the current
        stream."""
        frames = np.asarray(frames)
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(
                self.spec.pack_frames(frames)))
        host = torch.empty((frames.shape[0], self.spec.n_packed)
                           + frames.shape[2:], dtype=torch.uint8,
                           pin_memory=True)
        self.spec.pack_frames(frames, out=host.numpy())
        return host.to(self.device, non_blocking=True)

    def _check_packed(self, frames_dev: torch.Tensor) -> None:
        if frames_dev.shape[1] != self.spec.n_packed:
            raise ValueError(
                f"expected packed frames (P={self.spec.n_packed}), got "
                f"T={frames_dev.shape[1]}; use spec.pack_frames() or "
                f"process_clip_batch")

    @torch.no_grad()
    def run_staged(self, frames_dev: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """The four stages on packed device frames; outputs stay on the
        device."""
        self._check_packed(frames_dev)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = dict(self._detect_stage(frames_dev))
        out.update(self._sam_stage(frames_dev, out["primary_boxes"]))
        out.update(self._dino_stage(frames_dev))
        out.update(self._heads_stage(out["primary_boxes"],
                                     out["primary_scores"], generator))
        return out

    def process_clip_batch(self, frames,
                           generator: Optional[torch.Generator] = None,
                           readback: bool = True) -> Dict[str, Any]:
        """frames: (B, T, H, W, 3) uint8 RGB with T == clip_frames (packed
        here) or n_packed, or an already packed device tensor.  Returns the
        JAX engine's output dict as numpy (bf16 leaves read back as f32), or
        with ``readback=False`` the device tensors."""
        if isinstance(frames, torch.Tensor) and frames.device == self.device:
            frames_dev = frames
        else:
            frames_dev = self.to_device(frames)
        out = self.run_staged(frames_dev, generator)
        if not readback:
            return out
        return _to_numpy(out)

    def warmup(self, batch: int = 1) -> Dict[str, float]:
        """Run each stage once on zero frames (kernel builds, library
        autotuning, allocator growth).  Returns seconds per stage."""
        s = self.spec
        frames = torch.zeros((batch, s.n_packed, s.frame_height,
                              s.frame_width, 3), dtype=torch.uint8,
                             device=self.device)
        boxes = torch.tensor([1.0, 1.0, 10.0, 10.0],
                             device=self.device).expand(
                                 batch, len(s.det_idx), 4).contiguous()
        scores = torch.full((batch, len(s.det_idx)), 0.5, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        stages = {"detect": lambda: self._detect_stage(frames),
                  "sam": lambda: self._sam_stage(frames, boxes),
                  "dino": lambda: self._dino_stage(frames),
                  "heads": lambda: self._heads_stage(boxes, scores, gen)}
        timings = {}
        with torch.no_grad():
            for name, fn in stages.items():
                t0 = time.perf_counter()
                fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings[name] = round(time.perf_counter() - t0, 3)
        return timings


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def make_test_engine(frame_height: int = 90, frame_width: int = 160,
                     device=None, with_sam: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> LamenessEngine:
    """Small-geometry engine for tests: the JAX ``make_test_engine``
    geometry (15 frames at 160x90, 64² YOLO, a 64-wide 2-layer DINO, no
    SAM), or with ``with_sam`` a 128² SAM (dim 64, depth 2, 4 heads,
    global layer 1).  f32 (no precision policy); weights seeded from
    ``generator`` (seed 0 by default)."""
    spec = EngineSpec(clip_frames=15, frame_height=frame_height,
                      frame_width=frame_width, fps=5, yolo_size=64,
                      pose_size=64, dino_size=56, use_sam_model=with_sam,
                      sam_size=128 if with_sam else 1024, sam_mask_size=64)
    cfg = Config()
    eng = LamenessEngine(config=cfg, spec=spec, device=device,
                         init_models=False)
    dev = eng.device
    eng.yolo = YoloV8("n", num_classes=cfg.yolo.num_classes, device=dev)
    eng.dino = dino_mod.DinoV2(hidden_size=64, num_layers=2, num_heads=4,
                               patch_size=14, pos_grid=4, ls_init=1.0,
                               device=dev)
    eng.sam = Sam(img_size=128, encoder_dim=64, encoder_depth=2,
                  encoder_heads=4, global_attn_indexes=(1,),
                  device=dev) if with_sam else None
    eng.tcn = TCN(input_dim=44, device=dev)
    eng.gait = GaitTransformer(input_dim=44, device=dev)
    from ..weights import seeded_state_dict
    generator = generator or torch.Generator().manual_seed(0)
    eng.load_state_dicts({
        name: seeded_state_dict(getattr(eng, name), generator)
        for name in ("yolo", "dino", "sam", "tcn", "gait")
        if getattr(eng, name) is not None})
    return eng
