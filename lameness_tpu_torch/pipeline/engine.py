"""The clip engine on the card (port of ``lameness_tpu/pipeline/engine.py``).

  frames ─ letterbox ─→ YOLO detect (DFL + batched NMS)
        ├─ primary-box select (largest valid cow, full-frame fallback)
        ├─ SAM: 1024² pad (or the pad-free rect canvas) → ViT encoder →
        │   box-prompted mask decoder
        ├─ DINO: 224² resize-crop → ViT-B/14 → mean-pooled embeddings
        └─ heuristic or trained pose → locomotion features → 44-d
           sequences → TCN + GaitTransformer with batched MC-dropout

Four stages run one after another on device tensors (``run_staged``).
``to_device`` packs host frames and moves them to the device:
- only the rows some stage reads travel (33 of 125, or 15 with
  ``pose_pixels=False``: the heuristic pose reads boxes, never pixels);
- split ingest (``lo_height``/``lo_width``) sends the DINO and pose rows
  at a reduced geometry, as a ``{"hi", "lo"}`` dict;
- the transfer is RGB, or I420 planes rebuilt on the device
  (``LAMENESS_YUV_INGEST=1``, ``video/yuv.py``).
``process_clip_batch`` runs the stages and reads the outputs back in one
copy (``pack_output``/``unpack_output``); device tensors on the engine's
device pass through.  Stage sampling follows the reference: detect/SAM
2 FPS, DINO 1 FPS, pose 5 FPS.  ``load_torch_weights`` installs the
reference's torch checkpoints (HF DINOv2, HF or segment-anything SAM at the
checkpoint's variant, ultralytics YOLO and the trained pose model);
``install_pose_params`` switches the heads stage to trained pose with a
per-frame heuristic fallback.

The mesh (``shard_inference``, ``parallel/mesh.py``): each position of the
data axis runs the four stages on its own clips, with its own replica of
the weights (a replica on the engine's device shares its modules); a model
axis over 1 also splits DINO's blocks over the model positions of each data
row (``models/dino.py`` ``forward_tp``).  ``to_device`` then pads the batch
to a multiple of the data axis and gives each data shard its own clips: the
RGB rows, or its block of the batch-major I420 rows (``pack_i420_rows``).
Every shard's stages and packed output are queued before any readback, and
the padding is trimmed on return.  MC dropout follows JAX's rule over the
data axis: every shard draws the whole padded batch's uniforms from the
caller's generator state and keeps its clips' rows (``RowDraws``), so a
sharded call gives what the unsharded engine gives at the same batch.

The modes (``process_clip_batch(mode=)``): ``staged`` runs the four stages
one after another; ``pair`` runs [detect + dino] then [sam + heads]
(``_front_stage``, ``_back_stage``); ``monolith`` the four as one step
(``_fused_step``).  On the CPU they run eagerly and are one computation.
On the card ``monolith`` is one captured CUDA graph and ``pair`` two
(``_Captured``): captured at the first call for their key (mode, input
shapes and dtypes, the installed weights, the kernel switches) after an
eager run on the capture stream, replayed afterwards from static input
buffers, the MC-dropout generator registered with the graph.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import constant, resolve_device
from ..models import dino as dino_mod
from ..models import pose as pose_mod
from ..models import sam as sam_mod
from ..models import sequence_features as seqf
from ..models.gait_transformer import GaitTransformer
from ..models.sam import Sam, build_sam
from ..models.tcn import TCN
from ..models.yolo import YoloV8, convert_ultralytics_state_dict, detect
from ..ops import preprocess as prep
from ..ops._cuda import KERNELS
from ..ops.boxes import clip_boxes, pairwise_iou
from ..video.yuv import (flat_views, i420_flat_to_rgb_device,
                          i420_rows_to_rgb_device, pack_i420_flat,
                          pack_i420_rows, rgb_to_i420)

ENGINE_MODES = ("staged", "pair", "monolith")
# read at each call by the stages (the kernel selections, SAM's pad-row
# split): a captured graph holds what they chose, so they are in its key
_CALL_SWITCHES = ("LAMENESS_WIN_KERNEL", "LAMENESS_GLB_KERNEL",
                  "LAMENESS_SAM_PADSPLIT")


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
    # split ingest: det/SAM frames travel at frame_* (the coordinate space
    # of every box), DINO/pose frames at lo_* -- neither reads more than
    # about 640 px of width (DINO a 224² crop, pose a 640 letterbox)
    lo_height: Optional[int] = None
    lo_width: Optional[int] = None
    # SAM on the pad-free (h·ratio, sam_size) canvas instead of the padded
    # square: 2304 encoder tokens for 16:9 frames instead of 4096.  Not bit
    # for bit the square canvas (pad tokens join its attention), so off by
    # default, as in the JAX package
    sam_rect: bool = False
    # the heuristic pose reads boxes, never pose-frame pixels: False drops
    # the pose-only rows from the packed (33 -> 15) and lo arrays, with the
    # same outputs
    pose_pixels: bool = True
    # encode the B·Td SAM frames in sequential sub-batches of this many
    # (peak activation memory follows the chunk); 0 = one call
    sam_encode_chunk: int = 0

    @property
    def det_idx(self):               # 2 FPS
        return np.arange(0, self.clip_frames, max(1, self.fps // 2))

    @property
    def dino_idx(self):              # 1 FPS
        return np.arange(0, self.clip_frames, max(1, self.fps))

    @property
    def pose_idx(self):              # 5 FPS
        return np.arange(0, self.clip_frames, max(1, self.fps // 5))

    # only frames some stage reads travel to the device
    @property
    def packed_idx(self):
        subsets = [self.det_idx, self.dino_idx]
        if self.pose_pixels:
            subsets.append(self.pose_idx)
        return np.unique(np.concatenate(subsets))

    @property
    def n_packed(self) -> int:
        return int(len(self.packed_idx))

    @property
    def det_pos(self):
        return np.searchsorted(self.packed_idx, self.det_idx)

    @property
    def dino_pos(self):
        return np.searchsorted(self.packed_idx, self.dino_idx)

    @property
    def pose_pos(self):
        if not self.pose_pixels:
            raise AssertionError(
                "pose frames are not packed (pose_pixels=False)")
        return np.searchsorted(self.packed_idx, self.pose_idx)

    # -- split ingest --------------------------------------------------------
    @property
    def split(self) -> bool:
        return self.lo_height is not None

    @property
    def hi_idx(self):                # det ∪ SAM frames (SAM reuses det)
        return self.det_idx

    @property
    def lo_idx(self):                # dino ∪ pose frames
        if not self.pose_pixels:
            return self.dino_idx
        return np.unique(np.concatenate([self.dino_idx, self.pose_idx]))

    @property
    def dino_pos_lo(self):
        return np.searchsorted(self.lo_idx, self.dino_idx)

    @property
    def pose_pos_lo(self):
        if not self.pose_pixels:
            raise AssertionError(
                "pose frames are not in the lo array (pose_pixels=False)")
        return np.searchsorted(self.lo_idx, self.pose_idx)

    def split_shapes(self, batch: int) -> Dict[str, tuple]:
        """The shapes of ``split_pack_host``'s arrays for ``batch`` clips."""
        return {"hi": (batch, len(self.hi_idx), self.frame_height,
                       self.frame_width, 3),
                "lo": (batch, len(self.lo_idx), self.lo_height,
                       self.lo_width, 3)}

    def split_pack_host(self, frames, out=None) -> Dict[str, np.ndarray]:
        """(B, T|P, H, W, 3) uint8 RGB at any source resolution ->
        {"hi": (B, Th, frame_h, frame_w, 3), "lo": (B, Tl, lo_h, lo_w, 3)};
        T is clip_frames (full clips) or n_packed (rows in packed_idx
        order).  Rows already at the target size are gathered as they are,
        the rest resized bilinearly on the CPU (within 1 of cv2's
        INTER_LINEAR, which the JAX package uses).  With ``out`` (numpy
        arrays of ``split_shapes``) the rows are written into it."""
        if not self.split:
            raise AssertionError("split_pack_host needs lo_height/lo_width")
        frames = np.asarray(frames)
        t = frames.shape[1]
        if t == self.clip_frames:
            hi_rows, lo_rows = self.hi_idx, self.lo_idx
        elif t == self.n_packed:
            hi_rows = np.searchsorted(self.packed_idx, self.hi_idx)
            lo_rows = np.searchsorted(self.packed_idx, self.lo_idx)
        else:
            raise ValueError(f"expected {self.clip_frames} (full) or "
                             f"{self.n_packed} (packed) frames, got {t}")
        out = out or {}
        return {"hi": _rows_at(frames, hi_rows, self.frame_height,
                               self.frame_width, out.get("hi")),
                "lo": _rows_at(frames, lo_rows, self.lo_height,
                               self.lo_width, out.get("lo"))}

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


def _rows_at(frames: np.ndarray, rows, h: int, w: int,
             out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host (B, T, H, W, 3) uint8, rows ``rows`` of axis 1 at (h, w), into
    ``out`` if given: gathered when the size already matches, else resized
    bilinearly on half-pixel centres without antialiasing, in uint8 on the
    CPU, as cv2.INTER_LINEAR (within 1)."""
    b, _, fh, fw, c = frames.shape
    shape = (b, len(rows), h, w, c)
    if out is None:
        out = np.empty(shape, np.uint8)
    if (fh, fw) == (h, w):
        # mode="clip": with mode="raise" numpy buffers ``out`` (a second
        # copy); the rows are in range
        return np.take(frames, rows, axis=1, out=out, mode="clip")
    x = torch.from_numpy(np.ascontiguousarray(frames[:, rows]))
    y = torch.nn.functional.interpolate(
        x.view((-1,) + x.shape[2:]).permute(0, 3, 1, 2), size=(h, w),
        mode="bilinear", align_corners=False, antialias=False)
    np.copyto(out, y.permute(0, 2, 3, 1).numpy().reshape(shape))
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

    ``device=None`` means the current CUDA device (and raises without one);
    only an explicit ``"cpu"`` runs the plain PyTorch path on the CPU.
    Weights are seeded from ``generator`` (``weights.init_params``) unless
    ``init_models=False``; ``load_state_dicts`` installs others (e.g. from
    ``weights.from_jax_params``), ``load_torch_weights`` the reference's
    checkpoints.  On the card the bf16 policy applies when
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
        self.pose_model: Optional[YoloV8] = None   # built when pose installs
        self.loaded_weights = {k: False for k in
                               ("yolo", "dino", "sam", "pose", "tcn", "gait")}
        self._mesh = None          # shard_inference
        self._replicas: List["LamenessEngine"] = []
        self._dino_tp = None       # (DINO's shard tree, data row) of a replica
        self._data_pos = None      # (data position, data axis) of a replica
        # the captured modes by key; the weights' epoch, shared with the
        # engines of with_spec and the replicas, moves at every install
        self._graphs: Dict[tuple, "_Captured"] = {}
        self._epoch = [0]
        self._capture_stream = None
        # the config's memory governor reaches the spec also when the
        # caller installs the models (init_models=False)
        if self.config.sam.encode_chunk and not self.spec.sam_encode_chunk:
            self.spec.sam_encode_chunk = self.config.sam.encode_chunk
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

    def with_spec(self, spec: EngineSpec) -> "LamenessEngine":
        """A second engine over the same modules and weights (nothing is
        copied) with another frame geometry or mode.  The model input sizes
        must match; the compute dtype, precision policy, trained pose model
        and loaded-weights record carry over (the record is shared)."""
        s = self.spec
        if (spec.yolo_size, spec.pose_size, spec.dino_size,
                spec.sam_size) != (s.yolo_size, s.pose_size, s.dino_size,
                                   s.sam_size):
            raise AssertionError(
                "with_spec shares the modules: model input sizes must match")
        if self.loaded_weights.get("pose") and not spec.pose_pixels:
            raise ValueError(
                "with_spec: a trained pose model is installed but the new "
                "spec has pose_pixels=False (no pose frames on the wire)")
        eng = LamenessEngine(config=self.config,
                             spec=dataclasses.replace(spec, dtype=s.dtype),
                             device=self.device, init_models=False)
        eng.yolo, eng.dino, eng.sam = self.yolo, self.dino, self.sam
        eng.tcn, eng.gait = self.tcn, self.gait
        eng.pose_model = self.pose_model
        eng.loaded_weights = self.loaded_weights
        eng.precision = self.precision
        eng._epoch = self._epoch
        return eng

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping]) -> None:
        """Install {sub-model name: state dict} (strict key match)."""
        for name, sd in state_dicts.items():
            model = getattr(self, name)
            model.load_state_dict(sd, strict=True)
            model.eval()
        self.drop_graphs()
        self._reshard()

    # -- the reference's torch checkpoints -----------------------------------
    def load_torch_weights(self, name: str, state_dict) -> None:
        """Convert and install a torch checkpoint: ``dino`` (HF
        Dinov2Model), ``sam`` (HF SamModel or segment-anything; a checkpoint
        of another encoder width rebuilds SAM at its variant, as the
        reference selects the variant by checkpoint, sam3:51-72), ``yolo``
        and ``pose`` (ultralytics; ``pose`` is the 20-keypoint cow model of
        tleap:122-137).  Each converter gives the JAX package's flax tree,
        which ``weights.from_jax_params`` turns into the state dict."""
        if name == "dino":
            tree = dino_mod.convert_hf_state_dict(state_dict)
        elif name == "sam":
            if sam_mod.detect_sam_layout(state_dict) == "sa":
                state_dict = sam_mod.sa_to_hf_state_dict(state_dict)
            tree = sam_mod.convert_hf_state_dict(state_dict)
        elif name == "yolo":
            tree = convert_ultralytics_state_dict(state_dict)
        elif name == "pose":
            self.install_pose_params(
                convert_ultralytics_state_dict(state_dict, has_pose=True))
            return
        else:
            raise ValueError(f"no torch checkpoint format for {name!r}")
        self.install_jax_params(name, tree)

    def install_pose_params(self, tree) -> None:
        """Install trained pose weights (a flax-layout tree, as
        ``convert_ultralytics_state_dict(..., has_pose=True)`` gives) and
        switch the heads stage to trained inference with a per-frame
        heuristic fallback (tleap:142-197's hybrid)."""
        self.install_jax_params("pose", tree)

    def install_jax_params(self, name: str, tree) -> None:
        """A flax-layout tree (numpy leaves, as the JAX package's params
        and converters give) into sub-model ``name``."""
        from ..weights import from_jax_params
        self.install_state_dict(name, from_jax_params({name: tree})[name])

    def install_state_dict(self, name: str, sd) -> None:
        """A state dict into sub-model ``name`` (strict key match).  ``pose``
        builds the trained pose model (the spec must carry pose frames); a
        SAM state dict of another encoder width rebuilds SAM at its variant.
        A module built after the bf16 policy (a rebuilt SAM, a new pose
        model) is recast; one that already follows it keeps its dtypes
        (``load_state_dict`` copies into them)."""
        module = self.pose_model if name == "pose" else getattr(self, name)
        if name == "pose":
            if not self.spec.pose_pixels:
                raise ValueError(
                    "this engine's spec has pose_pixels=False (heuristic-pose "
                    "wire trim: no pose frames are transferred) — rebuild "
                    "with EngineSpec(pose_pixels=True) to run a trained pose "
                    "model")
            if module is None:
                module = YoloV8("n", num_classes=1,
                                num_keypoints=pose_mod.NUM_KEYPOINTS,
                                device=self.device)
        elif name == "sam" and module is not None:
            dim = sd["vision_encoder.pos_embed"].shape[-1]
            if dim != module.encoder_dim:
                module = build_sam(sam_mod.infer_variant(dim),
                                   img_size=self.spec.sam_size,
                                   device=self.device)
        if module is not None:
            # checked first: a strict load that fails on a key or shape has
            # already copied the others
            have = module.state_dict()
            bad = set(have) ^ set(sd) or {
                k for k, v in sd.items() if v.shape != have[k].shape}
            if bad:
                raise ValueError(f"{name}: state dict does not fit the "
                                 f"module ({sorted(bad)[:4]} ...)")
            module.load_state_dict(sd, strict=True)
            module.eval()
            if self.spec.dtype == torch.bfloat16:
                from .precision import recast_installed
                self.precision[name] = recast_installed(name, module)
            if name == "pose":
                self.pose_model = module
            else:
                setattr(self, name, module)
        self.loaded_weights[name] = True
        self.drop_graphs()
        self._reshard()

    def _reshard(self) -> None:
        """New weights reach a mesh's replicas and DINO's shards."""
        if self._mesh is not None:
            self.shard_inference(self._mesh)

    def drop_graphs(self) -> None:
        """Free this engine's captured graphs and move the weights' epoch,
        so that the engines sharing these modules (``with_spec``, the
        replicas) capture theirs anew: a graph holds the addresses of the
        tensors it read, and a replay after new tensors were installed
        would compute with the old ones.  Every install path calls it."""
        self._graphs.clear()
        self._epoch[0] += 1
        for eng in self._replicas:
            eng._graphs.clear()

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
        fallback = constant([0.1 * w, 0.1 * h, 0.9 * w, 0.9 * h], pb.dtype,
                            pb.device)
        pb = torch.where(has[:, None], pb, fallback)
        ps = torch.where(has, ps, torch.full_like(ps, 0.5))
        return pb, ps, has

    # -- stage frame accessors (one packed tensor, or the split dict) -------
    # (the row indices are device constants: a numpy index is copied to the
    # card with a stream synchronisation at each call)
    def _det_frames(self, frames):
        """The det/SAM rows and their geometry (always frame_*)."""
        s = self.spec
        if isinstance(frames, dict):
            return frames["hi"], s.frame_height, s.frame_width
        return (frames[:, constant(s.det_pos, torch.long, frames.device)],
                s.frame_height, s.frame_width)

    def _dino_frames(self, frames):
        s = self.spec
        if isinstance(frames, dict):
            lo = frames["lo"]
            return (lo[:, constant(s.dino_pos_lo, torch.long, lo.device)],
                    s.lo_height, s.lo_width)
        return (frames[:, constant(s.dino_pos, torch.long, frames.device)],
                s.frame_height, s.frame_width)

    def _pose_frames(self, frames):
        s = self.spec
        if isinstance(frames, dict):
            lo = frames["lo"]
            return (lo[:, constant(s.pose_pos_lo, torch.long, lo.device)],
                    s.lo_height, s.lo_width)
        return (frames[:, constant(s.pose_pos, torch.long, frames.device)],
                s.frame_height, s.frame_width)

    def _detect_stage(self, frames):
        """frames (B, P, H, W, 3) packed uint8 (or the split dict) -> boxes
        and primaries in frame coordinates."""
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
            if s.sam_rect:
                # the content rounded up to the patch grid (16 px)
                ch = -(-int(round(h * ratio)) // 16) * 16
                cw = -(-int(round(w * ratio)) // 16) * 16
            else:
                ch = cw = s.sam_size
            sam_in, _ = prep.pad_to_rect(flat, (ch, cw), s.sam_size)
            sam_in = prep.normalize(sam_in).to(s.dtype)
            # content extent in low-res-mask pixels (mask = canvas / 4)
            mh = int(round((ch // 4) * (h * ratio) / ch))
            mw = int(round((cw // 4) * (w * ratio) / cw))
            # landscape frames bottom-pad the square canvas: the pad token
            # rows are image-independent (SamVisionEncoder content_rows).
            # LAMENESS_SAM_PADSPLIT=0 turns the split off, read at each
            # call as the JAX engine reads it at each trace
            crows = 0
            if (not s.sam_rect and w > h
                    and os.environ.get("LAMENESS_SAM_PADSPLIT") != "0"):
                crows = -(-int(round(h * ratio)) // 16)
            chunk, n_img = s.sam_encode_chunk, sam_in.shape[0]
            if 0 < chunk < n_img:
                emb = torch.cat([self.sam.encode(sam_in[i:i + chunk], crows)
                                 for i in range(0, n_img, chunk)])
            else:
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
        dino_frames, h, w = self._dino_frames(frames)
        b, tdn = dino_frames.shape[:2]
        dino_in = dino_mod.preprocess_frames(dino_frames.reshape(
            b * tdn, h, w, 3)).to(s.dtype)
        if self._dino_tp is None:
            out = self.dino(dino_in)
        else:
            shards, row = self._dino_tp
            out = dino_mod.forward_tp(
                self.dino, lambda key, m: shards[key].shards[row, m], dino_in,
                list(shards["cls_token"].mesh.devices[row]))
        return {"embeddings": out["pooled"].reshape(b, tdn, -1)}

    # -- trained pose (tleap:122-197's hybrid) -------------------------------
    def _trained_pose(self, frames, pose_boxes):
        """The trained 20-keypoint model at 5 FPS, with the heuristic
        standing in on each frame where no detection overlaps the primary
        box (IoU > 0.1).  Returns (kpts_old (B, Tp, 20, 3) in H_NAMES order
        for locomotion, kpts_model (B, Tp, 20, 3) in KEYPOINT_NAMES order,
        zero on misses, and the hit mask (B, Tp))."""
        s = self.spec
        b, tp = pose_boxes.shape[:2]
        pose_frames, ph, pw = self._pose_frames(frames)
        canvases, ratio, pad = prep.letterbox(
            pose_frames.reshape(b * tp, ph, pw, 3), s.pose_size)
        levels = self.pose_model(canvases.to(s.dtype))["levels"]
        det = detect(levels,
                     conf_threshold=self.config.yolo.confidence_threshold,
                     max_det=4)
        boxes = prep.unletterbox_boxes(det["boxes"], ratio, pad)
        kxy = (det["keypoints"][..., :2] - pad[:, None, None, :]) \
            / ratio[:, None, None, None]
        kconf = det["keypoints"][..., 2:]
        # split ingest: the lo frames' coordinates scaled to the frame_*
        # space (same aspect ratio, one factor)
        if pw != s.frame_width:
            sc = s.frame_width / pw
            boxes = boxes * sc
            kxy = kxy * sc
        prim = pose_boxes.reshape(b * tp, 4)
        iou = pairwise_iou(prim[:, None, :], boxes)[:, 0]     # (N, K)
        iou = torch.where(det["valid"], iou, torch.full_like(iou, -1.0))
        best = torch.argmax(iou, dim=-1)
        rows = torch.arange(b * tp, device=iou.device)
        hit = iou[rows, best] > 0.1
        kpts_model = torch.cat([kxy[rows, best], kconf[rows, best]], dim=-1)
        kpts_old = torch.where(
            hit[:, None, None], pose_mod.map_roboflow_to_old_device(
                kpts_model), pose_mod.heuristic_keypoints_device(prim))
        # misses carry no keypoints of a padding slot: locomotion reads the
        # heuristic rows, the model-order rows are zero
        kpts_model = torch.where(hit[:, None, None], kpts_model,
                                 torch.zeros_like(kpts_model))
        return (kpts_old.reshape(b, tp, -1, 3),
                kpts_model.reshape(b, tp, -1, 3), hit.reshape(b, tp))

    # -- stage 4: pose + sequence heads --------------------------------------
    def _heads_stage(self, primary_bt, score_bt,
                     generator: torch.Generator, frames=None):
        """primary_bt: (B, Td, 4) detection-frame boxes; heads run at 5 FPS.
        With trained pose installed, the pose model reads ``frames`` (the
        packed tensor or split dict) and the outputs gain
        ``keypoints_model`` and ``pose_trained_mask``.  MC-dropout is one
        batched forward of ``mc_samples`` replicas with masks drawn from
        ``generator``."""
        s = self.spec
        b = primary_bt.shape[0]
        pose_idx = s.pose_idx
        tp = len(pose_idx)
        nearest = np.abs(pose_idx[:, None] - s.det_idx[None, :]).argmin(1)
        nearest = constant(nearest, torch.long, primary_bt.device)
        pose_boxes = primary_bt[:, nearest]                    # (B, Tp, 4)
        pose_scores = score_bt[:, nearest]
        pose_valid = torch.ones((b, tp), dtype=torch.bool,
                                device=primary_bt.device)
        extra = {}
        if self.loaded_weights.get("pose") and self.pose_model is not None:
            if frames is None:
                raise ValueError("trained pose reads the pose frames: pass "
                                 "frames to _heads_stage")
            kpts, kpts_model, trained = self._trained_pose(frames,
                                                           pose_boxes)
            extra = {"keypoints_model": kpts_model,
                     "pose_trained_mask": trained}
        else:
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
        draws = self._draws(generator, b, n_mc)
        tcn_preds = self.tcn(x_mc, generator=draws).view(n_mc, b)
        gait_preds = self.gait(x_mc, m_mc, generator=draws
                               )["probability"].view(n_mc, b)
        gait_det = self.gait(feats_p, mask_p)
        return {
            **extra,
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

    def _draws(self, generator, b: int, n_mc: int):
        """The heads' dropout draws.  A replica of data position d of dp
        draws what the unsharded engine draws at the whole batch of dp·b
        clips and keeps its clips' rows of each of the n_mc replicas
        (JAX's rule: a draw is a function of the key and the global
        shape); otherwise ``generator`` itself."""
        if generator is None or self._data_pos is None \
                or self._data_pos[1] == 1:
            return generator
        from .train import RowDraws
        d, dp = self._data_pos
        return RowDraws(generator, dp * b, d * b, (d + 1) * b, groups=n_mc)

    # -- paired programs (mode="pair") and the monolith ----------------------
    def _front_stage(self, frames):
        """detect + dino: independent of each other, one program of the
        pair."""
        out = dict(self._detect_stage(frames))
        out.update(self._dino_stage(frames))
        return out

    def _back_stage(self, frames, primary_bt, score_bt, generator):
        """sam + heads: both read the primaries."""
        out = dict(self._sam_stage(frames, primary_bt))
        out.update(self._heads_stage(primary_bt, score_bt, generator, frames))
        return out

    def _fused_step(self, frames, generator):
        """The four stages as one step (mode="monolith")."""
        out = dict(self._detect_stage(frames))
        out.update(self._sam_stage(frames, out["primary_boxes"]))
        out.update(self._dino_stage(frames))
        out.update(self._heads_stage(out["primary_boxes"],
                                     out["primary_scores"], generator,
                                     frames))
        return out

    # -- public API ----------------------------------------------------------
    @staticmethod
    def default_transfer() -> str:
        """'yuv420' when ``LAMENESS_YUV_INGEST=1``, else 'rgb' (the JAX
        package's choice off the TPU), read at each call."""
        return "yuv420" if os.environ.get("LAMENESS_YUV_INGEST") == "1" \
            else "rgb"

    def _put(self, nbytes: int, fill) -> torch.Tensor:
        """A flat uint8 tensor of ``nbytes`` on the device, written on the
        host by ``fill(numpy buffer)``.  On the card the buffer is pinned
        (PyTorch's caching host allocator reuses it across calls) and its
        copy to the device runs asynchronously on the current stream."""
        if self.device.type != "cuda":
            host = np.empty(nbytes, np.uint8)
            fill(host)
            return torch.from_numpy(host)
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        fill(host.numpy())
        return host.to(self.device, non_blocking=True)

    def to_device(self, frames, transfer: Optional[str] = None):
        """Host frames -> device RGB ready for ``run_staged``: a packed
        (B, P, H, W, 3) tensor, or with split ingest the {"hi", "lo"} dict.

        frames: (B, T|P, H, W, 3) uint8 RGB, or for split ingest the dict
        of ``spec.split_pack_host``.  ``transfer`` ('rgb' or 'yuv420';
        None: ``default_transfer()``) is what crosses to the device: the
        RGB rows, gathered straight into the pinned buffer (the split dict
        in one buffer and one copy), or the I420 planes of the whole batch
        as one flat buffer that the device turns back into RGB.  With a
        mesh installed, the sharded frames (``_to_device_sharded``)."""
        transfer = transfer or self.default_transfer()
        if transfer not in ("rgb", "yuv420"):
            raise ValueError(f"transfer must be 'rgb' or 'yuv420', got "
                             f"{transfer!r}")
        s = self.spec
        if isinstance(frames, dict):
            self._check_packed(frames)
        if self._mesh is not None:
            return self._to_device_sharded(frames, transfer)
        if transfer == "yuv420":
            if not s.split:
                i420 = rgb_to_i420(s.pack_frames(np.asarray(frames)))
            else:
                tree = frames if isinstance(frames, dict) \
                    else s.split_pack_host(frames)
                i420 = {k: rgb_to_i420(v) for k, v in tree.items()}
            flat, layout = pack_i420_flat(i420)
            dev = self._put(flat.size, lambda buf: np.copyto(buf, flat))
            return i420_flat_to_rgb_device(dev, layout)
        if not s.split:
            frames = np.asarray(frames)
            layout = (("", (frames.shape[0], s.n_packed) + frames.shape[2:]),)

            def fill(views):
                s.pack_frames(frames, out=views)
        else:
            # hi and lo share one pinned buffer and one copy
            batch = len(frames["hi"] if isinstance(frames, dict) else frames)
            layout = tuple(sorted(s.split_shapes(batch).items()))

            def fill(views):
                if isinstance(frames, dict):
                    for k, view in views.items():
                        np.copyto(view, frames[k])
                else:
                    s.split_pack_host(frames, out=views)
        nbytes = sum(int(np.prod(shape)) for _, shape in layout)
        return flat_views(self._put(nbytes, lambda buf: fill(
            flat_views(buf, layout))), layout)

    def _check_packed(self, frames_dev) -> None:
        s = self.spec
        if isinstance(frames_dev, dict):
            if (frames_dev["hi"].shape[1] != len(s.hi_idx)
                    or frames_dev["lo"].shape[1] != len(s.lo_idx)):
                raise ValueError(
                    f"split frames need hi T={len(s.hi_idx)} / lo "
                    f"T={len(s.lo_idx)}, got {frames_dev['hi'].shape[1]}/"
                    f"{frames_dev['lo'].shape[1]}")
            return
        if frames_dev.shape[1] != s.n_packed:
            raise ValueError(
                f"expected packed frames (P={s.n_packed}), got "
                f"T={frames_dev.shape[1]}; use spec.pack_frames() or "
                f"process_clip_batch")

    @torch.no_grad()
    def run_staged(self, frames_dev,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """The four stages on packed device frames (or the split dict);
        outputs stay on the device."""
        self._check_packed(frames_dev)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = dict(self._detect_stage(frames_dev))
        out.update(self._sam_stage(frames_dev, out["primary_boxes"]))
        out.update(self._dino_stage(frames_dev))
        out.update(self._heads_stage(out["primary_boxes"],
                                     out["primary_scores"], generator,
                                     frames_dev))
        return out

    def pack_output(self, out):
        """The output tree -> (one flat uint8 device tensor, meta), for one
        copy to the host (``unpack_output``).  bool leaves travel as 0/1
        bytes, bf16 leaves as f32 (numpy has no bf16), the rest as their
        raw bytes.  A list of trees (one per data shard of a mesh) -> (the
        list of their flat tensors, each on its shard's device, meta)."""
        if isinstance(out, list):
            packed = [self.pack_output(o) for o in out]
            return ([flat for flat, _ in packed],
                    _ShardsMeta([meta for _, meta in packed]))
        paths, layout, parts = [], [], []
        for path, x in _flat_items(out):
            if x.dtype == torch.bool:
                x, dtype = x.to(torch.uint8), np.dtype(bool)
            else:
                if x.dtype == torch.bfloat16:
                    x = x.float()
                dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
            paths.append(path)
            layout.append((tuple(x.shape), dtype))
            parts.append(x.contiguous().view(-1).view(torch.uint8))
        return torch.cat(parts), (paths, layout)

    @staticmethod
    def unpack_output(buf: np.ndarray, meta) -> Dict[str, Any]:
        """The inverse of ``pack_output`` on the host: one uint8 buffer ->
        the nested numpy output dict, shapes and dtypes restored (a mesh's
        list of buffers -> their trees concatenated along the batch)."""
        if isinstance(meta, _ShardsMeta):
            return _concat_batch([LamenessEngine.unpack_output(b, m)
                                  for b, m in zip(buf, meta.metas)])
        paths, layout = meta
        buf = np.asarray(buf)
        out: Dict[str, Any] = {}
        off = 0
        for path, (shape, dtype) in zip(paths, layout):
            n = int(np.prod(shape, dtype=np.int64))
            nbytes = n * dtype.itemsize
            # a copy is aligned for its dtype whatever the offset
            arr = buf[off:off + nbytes].copy().view(dtype).reshape(shape)
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = arr
            off += nbytes
        return out

    def _fetch(self, flat: torch.Tensor) -> np.ndarray:
        """One copy of a flat device buffer to the host (pinned memory)."""
        if flat.device.type != "cuda":
            return flat.numpy()
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        return host.numpy()

    def process_clip_batch(self, frames,
                           generator: Optional[torch.Generator] = None,
                           mode: str = "staged",
                           transfer: Optional[str] = None,
                           readback: bool = True) -> Dict[str, Any]:
        """frames: (B, T, H, W, 3) uint8 RGB with T == clip_frames (packed
        here) or n_packed, the split dict (host or device), or an already
        packed device tensor; ``transfer`` as in ``to_device``.  ``mode``:
        'staged', 'pair' or 'monolith' (the module docstring), each with
        the same outputs.  Returns the JAX engine's output dict as numpy
        (bf16 leaves read back as f32) through one device-to-host copy, or
        with ``readback=False`` the device tensors (under a captured mode,
        copies of the graph's outputs, which the next replay overwrites).
        With a mesh installed, see ``_process_sharded``."""
        if mode not in ENGINE_MODES:
            raise ValueError(f"mode must be one of {ENGINE_MODES}, got "
                             f"{mode!r}")
        if self._mesh is not None:
            return self._process_sharded(frames, generator, mode, transfer,
                                         readback)
        leaves = frames.values() if isinstance(frames, dict) else [frames]
        # type and index, not device equality: an unindexed "cuda" does not
        # equal the "cuda:0" of a tensor on it
        if all(isinstance(x, torch.Tensor)
               and x.device.type == self.device.type
               and x.device.index == self.device.index for x in leaves):
            frames_dev = frames
        else:
            frames_dev = self.to_device(frames, transfer)
        out, flat, meta = self._run(frames_dev, generator, mode, readback)
        if not readback:
            return out
        return self.unpack_output(self._fetch(flat), meta)

    @torch.no_grad()
    def _run(self, frames_dev, generator, mode: str, readback: bool):
        """(outputs, flat, meta) of ``mode`` on device frames; ``flat`` and
        ``meta`` (``pack_output``'s) only with ``readback``.  On the card
        pair and monolith replay their captured graphs (``_graphed``):
        with ``readback`` the graph's own outputs and packed buffer, which
        the caller reads before the next replay, else copies."""
        self._check_packed(frames_dev)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if mode != "staged" and self.device.type == "cuda":
            cap = self._graphed(mode, frames_dev, generator)
            if readback:
                return cap.out, cap.flat, cap.meta
            return _clone_tree(cap.out), None, None
        if mode == "pair":
            out = self._front_stage(frames_dev)
            out.update(self._back_stage(frames_dev, out["primary_boxes"],
                                        out["primary_scores"], generator))
        elif mode == "monolith":
            out = self._fused_step(frames_dev, generator)
        else:
            out = self.run_staged(frames_dev, generator)
        if not readback:
            return out, None, None
        return (out,) + self.pack_output(out)

    def run_paired(self, frames_dev, generator: Optional[torch.Generator]
                   = None) -> Dict[str, Any]:
        """[detect + dino] -> [sam + heads] on packed device frames (or the
        split dict): ``run_staged``'s outputs bit for bit, from two
        programs (on the card two CUDA graphs, their outputs copied)."""
        return self._run(frames_dev, generator, "pair", False)[0]

    # -- the captured modes (the card) ---------------------------------------
    def _graph_key(self, mode: str, frames_dev) -> tuple:
        """What a captured graph holds fixed: the weights' epoch (first),
        the mode, the inputs' shapes and dtypes, the modules and the
        (frozen) config read at capture, the switches the stages read at
        each call, and the TF32 settings the libraries read at each
        call."""
        items = sorted(frames_dev.items()) if isinstance(frames_dev, dict) \
            else [("", frames_dev)]
        return (self._epoch[0], mode,
                tuple((k, tuple(v.shape), v.dtype) for k, v in items),
                tuple(id(getattr(self, n)) for n in
                      ("yolo", "dino", "sam", "tcn", "gait", "pose_model")),
                id(self.config),
                None if self._dino_tp is None else id(self._dino_tp[0]),
                tuple(os.environ.get(k) for k in _CALL_SWITCHES),
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    def _graphed(self, mode: str, frames_dev, generator) -> "_Captured":
        """Replay ``mode``'s graphs for these frames and this generator,
        capturing them first at a new key (a capture that fails raises:
        nothing falls back to running eagerly).  Graphs of an older
        weights' epoch are freed."""
        key = self._graph_key(mode, frames_dev)
        cap = self._graphs.get(key)
        if cap is None:
            for old in [k for k in self._graphs if k[0] != key[0]]:
                del self._graphs[old]
            cap = _Captured(self, mode, frames_dev, generator)
            self._graphs[key] = cap
        cap.replay(frames_dev, generator)
        return cap

    def warmup(self, batch: int = 1, mode: str = "staged"
               ) -> Dict[str, float]:
        """Run the stages once on zero frames (kernel builds, library
        autotuning, allocator growth); on the card ``pair`` and
        ``monolith`` also capture their graphs, so that later calls at this
        batch only replay them.  Returns seconds by JAX's keys: per stage
        ('detect', 'sam', 'dino', 'heads') for staged and monolith (whose
        capture follows), per program ('front', 'back': its eager run and
        capture) for pair.  With a mesh installed, each data shard's
        replica warms at the batch rounded up to the data axis, its share
        of it (the seconds summed over the shards)."""
        if mode not in ENGINE_MODES:
            raise ValueError(f"mode must be one of {ENGINE_MODES}, got "
                             f"{mode!r}")
        if self._mesh is not None:
            per = -(-batch // len(self._replicas))
            timings: Dict[str, float] = {}
            for eng in self._replicas:
                for name, sec in eng.warmup(per, mode).items():
                    timings[name] = round(timings.get(name, 0.0) + sec, 3)
            return timings
        s = self.spec

        def zeros(t, h, w):
            return torch.zeros((batch, t, h, w, 3), dtype=torch.uint8,
                               device=self.device)
        if s.split:
            frames = {"hi": zeros(len(s.hi_idx), s.frame_height,
                                  s.frame_width),
                      "lo": zeros(len(s.lo_idx), s.lo_height, s.lo_width)}
        else:
            frames = zeros(s.n_packed, s.frame_height, s.frame_width)
        gen = torch.Generator(device=self.device).manual_seed(0)
        if mode == "pair":
            if self.device.type == "cuda":
                return dict(self._graphed("pair", frames, gen).seconds)
            front = {}
            stages = {"front": lambda: front.update(
                          self._front_stage(frames)),
                      "back": lambda: self._back_stage(
                          frames, front["primary_boxes"],
                          front["primary_scores"], gen)}
        else:
            boxes = torch.tensor([1.0, 1.0, 10.0, 10.0],
                                 device=self.device).expand(
                                     batch, len(s.det_idx), 4).contiguous()
            scores = torch.full((batch, len(s.det_idx)), 0.5,
                                device=self.device)
            stages = {"detect": lambda: self._detect_stage(frames),
                      "sam": lambda: self._sam_stage(frames, boxes),
                      "dino": lambda: self._dino_stage(frames),
                      "heads": lambda: self._heads_stage(boxes, scores, gen,
                                                         frames)}
        timings = {}
        with torch.no_grad():
            for name, fn in stages.items():
                t0 = time.perf_counter()
                fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings[name] = round(time.perf_counter() - t0, 3)
        if mode == "monolith" and self.device.type == "cuda":
            self._graphed("monolith", frames, gen)
        return timings

    def fused_fn(self):
        """(core, example_args) for compile checking, as JAX's entry:
        ``core(frames, generator)`` is the detection + heads core (SAM and
        DINO are checked through their own stages), the example a
        (1, n_packed, H, W, 3) uint8 zero tensor on the engine's device and
        a generator seeded 0."""
        s = self.spec

        @torch.no_grad()
        def core(frames, generator):
            out = dict(self._detect_stage(frames))
            out.update(self._heads_stage(out["primary_boxes"],
                                         out["primary_scores"], generator,
                                         frames))
            return out
        example = (torch.zeros((1, s.n_packed, s.frame_height,
                                s.frame_width, 3), dtype=torch.uint8,
                               device=self.device),
                   torch.Generator(device=self.device).manual_seed(0))
        return core, example

    # -- the mesh ------------------------------------------------------------
    def shard_inference(self, mesh) -> None:
        """Inference over a (data, model) mesh (``parallel/mesh.py``).
        Each data position gets a replica of the engine on its device (the
        engine's own device shares the modules: nothing is copied) and runs
        the engine's mode on its own clips, its MC dropout its rows of the
        whole batch's draw (``_draws``).  A model axis over 1 also
        splits DINO's blocks over each data row's model positions
        (``shard_params_tp``: query/key/value and fc1 by rows at head
        boundaries, out and fc2 by columns), the row-parallel partial sums
        added on the row's data device: equal to the replicated layout
        within float reassociation of that sum (JAX pins atol=1e-4), not
        bit for bit.  Install it after the precision policy, so the
        replicas and shards carry the policy's dtypes."""
        from ..parallel.mesh import MODEL_AXIS, shard_params_tp
        if mesh.devices.ndim != 2:
            raise ValueError("shard_inference needs a (data, model) mesh")
        self.drop_graphs()
        self._mesh = mesh
        self._replicas = [self._replica(dev) for dev in mesh.devices[:, 0]]
        for d, eng in enumerate(self._replicas):
            eng._data_pos = (d, len(self._replicas))
        if mesh.shape.get(MODEL_AXIS, 1) > 1:
            shards = shard_params_tp(
                mesh, {"dino": self.dino.state_dict()})["dino"]
            for row, eng in enumerate(self._replicas):
                eng._dino_tp = (shards, row)

    def _replica(self, device) -> "LamenessEngine":
        """An engine on ``device`` over this engine's spec and weights: the
        same modules on the same device, copies moved there otherwise."""
        eng = LamenessEngine(config=self.config, spec=self.spec,
                             device=device, init_models=False)
        for name in ("yolo", "dino", "sam", "tcn", "gait", "pose_model"):
            module = getattr(self, name)
            if module is not None and eng.device != self.device:
                module = copy.deepcopy(module).to(eng.device)
            setattr(eng, name, module)
        eng.loaded_weights = self.loaded_weights
        eng.precision = self.precision
        eng._epoch = self._epoch
        return eng

    def _to_device_sharded(self, frames, transfer: str):
        """Host frames -> the batch padded with zero clips to a multiple of
        the data axis and split over it: each data shard's clips are put on
        its own device alone, as ``Sharded`` tensors over the data devices
        (a dict of them for split ingest).  RGB: each shard's rows gathered
        into its pinned buffer (``to_device`` of its replica); I420: the
        padded batch as batch-major rows (``pack_i420_rows``), each shard
        its block of rows, rebuilt on its device
        (``i420_rows_to_rgb_device``)."""
        from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, P,
                                     Sharded, pad_batch_to_multiple)
        s = self.spec
        dp = len(self._replicas)
        b = len(frames["hi"] if isinstance(frames, dict) else frames)
        per = -(-b // dp)

        def packed(part):
            if s.split:
                return part if isinstance(part, dict) \
                    else s.split_pack_host(part)
            return s.pack_frames(np.asarray(part))

        shards = []
        if transfer == "yuv420":
            tree, _ = pad_batch_to_multiple(packed(frames), dp)
            i420 = {k: rgb_to_i420(v) for k, v in tree.items()} \
                if isinstance(tree, dict) else rgb_to_i420(tree)
            rows, layout = pack_i420_rows(i420)
            for d, eng in enumerate(self._replicas):
                block = rows[d * per:(d + 1) * per]
                dev = eng._put(block.size, lambda buf, x=block: np.copyto(
                    buf, x.reshape(-1))).view(block.shape)
                shards.append(i420_rows_to_rgb_device(dev, layout))
        else:
            for d, eng in enumerate(self._replicas):
                lo, hi = min(b, d * per), min(b, (d + 1) * per)
                part = {k: v[lo:hi] for k, v in frames.items()} \
                    if isinstance(frames, dict) else frames[lo:hi]
                if hi - lo < per:
                    part = _pad_rows(packed(part), per)
                shards.append(eng.to_device(part, "rgb"))
        data = Mesh(self._mesh.devices[:, :1], (DATA_AXIS, MODEL_AXIS))

        def holder(parts):
            grid = np.empty((dp, 1), object)
            for d, t in enumerate(parts):
                grid[d, 0] = t
            return Sharded(data, P(DATA_AXIS), (dp * per,) + parts[0].shape[1:],
                           grid)
        if isinstance(shards[0], dict):
            return {k: holder([sh[k] for sh in shards]) for k in shards[0]}
        return holder(shards)

    def _shard_generators(self, generator) -> List[torch.Generator]:
        """One MC-dropout generator per data shard, each at the state the
        unsharded call would start from: seeded 0 (the unsharded default)
        for None, else a copy of ``generator``'s state.  Each shard draws
        the whole batch's uniforms from it and keeps its rows (``_draws``),
        so every shard consumes as much as the unsharded call does."""
        gens = []
        for eng in self._replicas:
            g = torch.Generator(device=eng.device)
            if generator is None:
                g.manual_seed(0)
            else:
                g.set_state(generator.get_state())
            gens.append(g)
        return gens

    @torch.no_grad()
    def run_sharded(self, frames_dev, generator=None,
                    mode: str = "staged") -> List[Dict]:
        """``mode`` on every data shard (``to_device``'s sharded frames),
        each on its replica, all queued before any is read back: one output
        tree per shard, on its device.  The shards' MC dropout is the
        unsharded engine's at the same batch (``_shard_generators``), and
        ``generator`` is left where the unsharded call would leave it."""
        from ..parallel.mesh import Sharded
        first = next(iter(frames_dev.values())) \
            if isinstance(frames_dev, dict) else frames_dev
        if not isinstance(first, Sharded):
            raise TypeError("run_sharded takes to_device's sharded frames")
        gens = self._shard_generators(generator)
        outs = []
        for d, eng in enumerate(self._replicas):
            part = {k: v.shards[d, 0] for k, v in frames_dev.items()} \
                if isinstance(frames_dev, dict) else frames_dev.shards[d, 0]
            outs.append(eng._run(part, gens[d], mode, False)[0])
        if generator is not None:
            generator.set_state(gens[-1].get_state())
        return outs

    def _process_sharded(self, frames, generator, mode, transfer, readback):
        """``process_clip_batch`` over the mesh: host frames are padded and
        split (``to_device``), ``to_device``'s sharded frames pass through.
        ``generator``: see ``_shard_generators``; ``mode``: each replica
        runs it on its shard (under pair and monolith, the shards' outputs
        are copies of their graphs', packed as the staged ones).  Every
        shard's stages and packed output are queued before the first
        readback; the padding is trimmed from host frames' results.  With
        ``readback=False``, the list of the shards' device output trees
        (padding included)."""
        from ..parallel.mesh import Sharded
        leaves = frames.values() if isinstance(frames, dict) else [frames]
        orig_b = None
        if all(isinstance(x, Sharded) for x in leaves):
            frames_dev = frames
        else:
            orig_b = len(next(iter(leaves)))
            frames_dev = self.to_device(frames, transfer)
        outs = self.run_sharded(frames_dev, generator, mode)
        if not readback:
            return outs
        flats, meta = self.pack_output(outs)
        out = self.unpack_output([eng._fetch(f) for eng, f in
                                  zip(self._replicas, flats)], meta)
        if orig_b is not None:
            out = _trim_batch(out, orig_b)
        return out

    def process_clip_batch_sharded(self, frames,
                                   generator: Optional[torch.Generator] = None,
                                   transfer: Optional[str] = None
                                   ) -> Dict[str, Any]:
        """``process_clip_batch`` over the installed mesh (the same path it
        takes once ``shard_inference`` is installed), kept as the explicit
        API of the JAX package."""
        if self._mesh is None:
            raise RuntimeError("call shard_inference(mesh) first")
        return self.process_clip_batch(frames, generator, transfer=transfer)


def _flat_items(tree, prefix=()):
    """(key path, leaf) of a nested dict, depth first in key order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_items(val, prefix + (key,))
        else:
            yield prefix + (key,), val


class _ShardsMeta(NamedTuple):
    """``pack_output``'s meta of a mesh's outputs: one meta per shard."""
    metas: list


def _clone_tree(tree):
    """A nested dict of tensors copied (on their device)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


class _Captured:
    """One mode's CUDA graphs at one key of ``LamenessEngine._graphed``:
    ``monolith`` one graph of the four stages, ``pair`` two (front, then
    back, in one memory pool, replayed in that order); the last ends with
    ``pack_output``, so a replay leaves the outputs and their packed buffer
    in static tensors.

    Built in three steps on the engine's capture stream: an eager run of
    the mode (kernel builds, library handles and workspaces, the engine's
    device constants: nothing may be made for the first time, or copied
    from the host, inside a capture), then the capture, which launches
    nothing.  The kernel wrappers count in Python: the launches a capture
    recorded are taken off their counts and added again at each replay.
    Inputs are static buffers: the frames (each call copies its own in)
    and a generator of the graph's own, registered with the graphs that
    draw (``register_generator_state``), which takes the caller's state
    before a replay and gives back its state after it, advanced as an
    eager run would advance it."""

    def __init__(self, eng: "LamenessEngine", mode: str, frames_dev,
                 generator: torch.Generator):
        dev = eng.device
        self.mode = mode
        self.static_in = _clone_tree(frames_dev)
        self.gen = torch.Generator(device=dev)
        self.gen.set_state(generator.get_state())
        if eng._capture_stream is None:
            eng._capture_stream = torch.cuda.Stream(device=dev)
        stream = eng._capture_stream
        parts = ("front", "back") if mode == "pair" else ("monolith",)
        self.seconds: Dict[str, float] = {}
        front: Dict[str, Any] = {}

        def run(part):
            if part == "front":
                front.clear()
                front.update(eng._front_stage(self.static_in))
                return None
            if part == "back":
                out = dict(front)
                out.update(eng._back_stage(
                    self.static_in, front["primary_boxes"],
                    front["primary_scores"], self.gen))
                return out
            return eng._fused_step(self.static_in, self.gen)

        stream.wait_stream(torch.cuda.current_stream(dev))
        eager = {}
        with torch.no_grad(), torch.cuda.stream(stream):
            for part in parts:
                t0 = time.perf_counter()
                run(part)
                stream.synchronize()
                eager[part] = time.perf_counter() - t0
        before = {name: k.launches for name, k in KERNELS.items()}
        self.graphs: List[torch.cuda.CUDAGraph] = []
        pool = None
        try:
            for part in parts:
                t0 = time.perf_counter()
                graph = torch.cuda.CUDAGraph()
                if part != "front":
                    graph.register_generator_state(self.gen)
                with torch.no_grad(), torch.cuda.graph(
                        graph, pool=pool, stream=stream,
                        capture_error_mode="thread_local"):
                    out = run(part)
                    if out is not None:
                        self.out = out
                        self.flat, self.meta = eng.pack_output(out)
                pool = graph.pool()
                self.graphs.append(graph)
                self.seconds[part] = round(
                    eager[part] + time.perf_counter() - t0, 3)
        finally:
            self.launches = {name: k.launches - before[name]
                             for name, k in KERNELS.items()
                             if k.launches != before[name]}
            for name, k in KERNELS.items():
                k.launches = before[name]
        torch.cuda.current_stream(dev).wait_stream(stream)

    def replay(self, frames_dev, generator: torch.Generator) -> None:
        if isinstance(frames_dev, dict):
            for k, v in frames_dev.items():
                self.static_in[k].copy_(v)
        else:
            self.static_in.copy_(frames_dev)
        self.gen.set_state(generator.get_state())
        for graph in self.graphs:
            graph.replay()
        generator.set_state(self.gen.get_state())
        for name, n in self.launches.items():
            KERNELS[name].launches += n


def _concat_batch(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    first = trees[0]
    return {k: _concat_batch([t[k] for t in trees]) if isinstance(v, dict)
            else np.concatenate([t[k] for t in trees]) for k, v in
            first.items()}


def _pad_rows(tree, n: int):
    """Host arrays (or a dict of them) padded with zero clips to ``n``."""
    def pad(x):
        return np.pad(x, [(0, n - len(x))] + [(0, 0)] * (x.ndim - 1))
    return {k: pad(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else pad(tree)


def _trim_batch(tree: Dict[str, Any], b: int) -> Dict[str, Any]:
    return {k: _trim_batch(v, b) if isinstance(v, dict) else v[:b]
            for k, v in tree.items()}


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
