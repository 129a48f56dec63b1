"""The serving driver on the card (port of ``lameness_tpu/serve/driver.py``).

``process_video_file`` is the whole upload -> analysis chain for one video,
in the JAX driver's order:
- ``ingest`` copies the upload into ``data/videos`` (``video.uploaded``);
- the curator (``video/curation.py`` ``ClipCurator``) selects the best 5 s
  walking window, writes the canonical clip (a side output) and the
  quality report, and keeps the raw upload's decoded frames;
- ``preprocess`` crops the raw upload from that frame cache: the median
  box of the first 10 detections curation found, plus 50 px
  (``video.preprocessed``), written as ``<id>_cropped.y4m``;
- ``run_feature_stages`` runs the engine on the crop and writes the six
  stage result files; then ``run_tracking``, the graph heads, ``run_ml``
  and fusion.
The curator is built at first use: with the engine's YOLO weights loaded
it detects with the engine's YOLO in chunks (``BatchedYoloDetector``),
else with the motion fallback (MOG2 on the device); it moves to YOLO when
the weights arrive later.

``process_stream`` takes (video_id, path) jobs, decodes them on a thread
pool, runs the engine over batches of clips and writes each clip's six
result files (yolo, sam3, dinov3, tleap, tcn, transformer) and bus
messages, as the JAX driver does:
- the producer thread decodes (``_load_engine_frames``) and stacks a
  batch, padded to ``pad_to`` by repeating the last clip;
- the consumer (the calling thread) does all device work: batch N+1's
  transfer, its stages and its packed output are queued while batch N
  runs, then N is read back.  The transfer runs on a copy-in stream and the
  readback on a copy-out stream (``core/streams.py``): on CUDA a copy on
  the compute stream would wait for the kernels queued around it;
- the writer thread turns each read-back batch into result files.

Decoding: ``reader`` is a callable ``path -> reader`` with ``info``
({"width", "height", "fps", "total_frames"}) and ``read_selected(indices)
-> {index: (H, W, 3) uint8 RGB frame}``; by default the port's
``video/decode.py`` ``VideoReader`` on the driver's device (``.y4m``, or
other containers through the ``ffmpeg`` binary).  The port has no
OpenCV: frames are resized to the engine's geometry by its bilinear resize
(cv2's INTER_LINEAR within 1; a frame already at that size is used as it
is, as cv2 leaves it), and ``_mask_features`` measures masks with
``serve/contours.py``.

After the engine, ``run_tracking`` (host ByteTrack, or the device tracker,
and Re-ID of each track's window of frame embeddings), the graph heads
(``_ensure_graph_runner().process_video``, on ``device``), ``run_ml`` and
``fusion.process_video``.  The mesh branch of ``process_stream`` is not
ported.
"""
from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.config import Config
from ..core.device import resolve_device
from ..core.streams import Overlap
from ..fuse.fusion import FusionService
from ..io import schemas
from ..io.bus import MessageBus
from ..io.vecstore import VectorStore, make_store
from ..ml.ensemble import GBDTEnsemble
from ..ml.features import extract_features
from ..models import pose as pose_mod
from ..pipeline.engine import _rows_at
from ..track.bytetrack import ByteTracker, Detection
from ..track.device_tracker import track_detection_frames
from ..track.reid import CowReIDMatcher
from ..utils.logging import get_logger
from ..utils.timing import TIMERS
from ..video.curation import BatchedYoloDetector, ClipCurator
from ..video.decode import VideoReader, write_video
from .contours import first_moments, largest_external_contour, \
    resize_nearest
from .graph_runner import GraphHeadRunner

LOG = get_logger("driver")
# threads a clip's mask features are measured on
MASK_WORKERS = min(4, os.cpu_count() or 1)


class PipelineDriver:
    def __init__(self, config: Optional[Config] = None, engine=None,
                 bus: Optional[MessageBus] = None,
                 store: Optional[VectorStore] = None,
                 reader: Optional[Callable] = None,
                 curator: Optional[ClipCurator] = None, device=None):
        """``device``: where the graph heads, the device tracker, curation
        and decoding run when there is no engine (with one, the engine's
        device).  ``reader``: the engine's decoder (default
        ``VideoReader`` on ``device``)."""
        self.config = config or Config()
        self.dirs = self.config.dirs.ensure()
        self.bus = bus or MessageBus(
            journal_path=self.dirs.root and
            Path(self.dirs.root) / "bus_journal.jsonl")
        self.engine = engine
        if store is None:
            store = make_store(
                url=self.config.reid.vector_url,
                persist_path=Path(self.dirs.root) / "vector_store.json",
                device=engine.device if engine is not None else device)
        self.store = store
        self.store.create_collection(
            self.config.reid.collection_embeddings,
            self.config.reid.embedding_dim)
        self.reid = CowReIDMatcher(self.store,
                                   self.config.reid.embedding_dim)
        self.ensemble = GBDTEnsemble(self.dirs.models / "ml")
        self.fusion = FusionService(self.dirs, bus=self.bus,
                                    subjects=self.config.subjects)
        self.trackers: Dict[str, ByteTracker] = {}
        self.graph_runner = None        # built lazily (the two graph heads)
        self._device = device
        self.reader = reader or (lambda path: VideoReader(
            path, device=self.device))
        # built at first use (the ``curator`` property), and again when YOLO
        # weights loaded after the driver was made reach the engine
        self._curator_injected = curator is not None
        self._curator_on_yolo = False
        self._curator = curator

    @property
    def device(self):
        if self.engine is not None:
            return self.engine.device
        return resolve_device(self._device)

    def _ensure_graph_runner(self):
        if self.graph_runner is None:
            self.graph_runner = GraphHeadRunner(self.config, bus=self.bus,
                                                device=self.device)
        return self.graph_runner

    def _engine_has_yolo(self) -> bool:
        return self.engine is not None and bool(
            getattr(self.engine, "loaded_weights", {}).get("yolo"))

    def _build_curator(self) -> ClipCurator:
        """The engine's YOLO as the chunked curation detector when its
        weights are loaded; otherwise the weight-free motion fallback (the
        reference's degradation, clip-curation:103-131)."""
        detector = None
        if self._engine_has_yolo():
            detector = BatchedYoloDetector(
                self.engine.yolo, cow_class_id=self.config.yolo.cow_class_id,
                size=self.engine.spec.yolo_size)
        self._curator_on_yolo = detector is not None
        return ClipCurator(self.dirs, detector=detector, bus=self.bus,
                           subjects=self.config.subjects, device=self.device)

    @property
    def curator(self) -> ClipCurator:
        if self._curator is None or (
                not self._curator_injected and not self._curator_on_yolo
                and self._engine_has_yolo()):
            if self._curator is not None:
                LOG.info("curator.upgrade", detail="yolo weights arrived; "
                         "curation moves to the batched device detector")
            self._curator = self._build_curator()
        return self._curator

    @curator.setter
    def curator(self, value: ClipCurator) -> None:
        self._curator_injected = True
        self._curator = value

    @property
    def detector(self):
        """The curation detector (``curator.detector``)."""
        return self.curator.detector

    # ------------------------------------------------------------ ingest ---
    def ingest(self, video_path: Path,
               video_id: Optional[str] = None) -> str:
        """Chunked copy into data/videos + ``video.uploaded``
        (video-ingestion/app/main.py:87-154)."""
        video_id = video_id or str(uuid.uuid4())
        dest = self.dirs.videos / f"{video_id}{Path(video_path).suffix}"
        with open(video_path, "rb") as src, open(dest, "wb") as dst:
            while chunk := src.read(1024 * 1024):
                dst.write(chunk)
        self.bus.publish_sync(self.config.subjects.video_uploaded, {
            "video_id": video_id, "filename": Path(video_path).name,
            "path": str(dest),
            "uploaded_at": datetime.now(timezone.utc).isoformat()})
        return video_id

    # -------------------------------------------------------- preprocess ---
    def preprocess(self, video_id: str,
                   detector=None) -> Optional[Dict[str, Any]]:
        """Median-bbox crop of the first 10 detected frames + 50 px pad
        (video-preprocessing/app/main.py:39-149)."""
        with TIMERS.time("preprocess"):
            return self._preprocess(video_id, detector)

    def _preprocess(self, video_id: str,
                    detector=None) -> Optional[Dict[str, Any]]:
        matches = list(self.dirs.videos.glob(f"{video_id}.*"))
        if not matches:
            return None
        src = matches[0]
        # curation just ran the detector over every frame of this raw
        # upload: its first 10 detections, not the detector again (when it
        # found fewer than 10 there are no more to find)
        bboxes = []
        memo = getattr(self.curator, "last_detections", None)
        use_memo = (detector is None and memo
                    and memo.get("video_id") == video_id)
        if use_memo:
            bboxes = [d["detection"]["bbox"] for d in memo["detections"]
                      if d["detection"] is not None][:10]
        detector = detector or self.curator.detector
        # curation's track pass kept this upload's decoded frames: crop
        # from memory instead of decoding again (popping frees them)
        cache = self.curator.take_frame_cache(src)
        if cache is not None:
            info = cache["info"]
            frames = cache["frames"]
            if not use_memo:
                for frame in frames:
                    if len(bboxes) >= 10:
                        break
                    det = detector(np.ascontiguousarray(frame[..., ::-1]))
                    if det is not None:
                        bboxes.append(det["bbox"])
        else:
            with VideoReader(src, device=self.device) as vr:
                info = vr.info
                frames = []
                for idx, frame in vr.frames(interval=1, rgb=True):
                    frames.append(frame)
                    if not use_memo and len(bboxes) < 10:
                        det = detector(np.ascontiguousarray(
                            frame[..., ::-1]))
                        if det is not None:
                            bboxes.append(det["bbox"])
        h, w = info["height"], info["width"]
        if bboxes:
            med = np.median(np.asarray(bboxes), axis=0)
            x1 = max(0, int(med[0]) - 50)
            y1 = max(0, int(med[1]) - 50)
            x2 = min(w, int(med[2]) + 50)
            y2 = min(h, int(med[3]) + 50)
            # I420 needs even dimensions
            x2 -= (x2 - x1) % 2
            y2 -= (y2 - y1) % 2
        else:
            x1, y1, x2, y2 = 0, 0, w, h
        cropped = [f[y1:y2, x1:x2] for f in frames]
        out_path = write_video(self.dirs.processed / f"{video_id}_cropped",
                               cropped, info["fps"], device=self.device)
        payload = {
            "video_id": video_id, "processed_path": str(out_path),
            "crop_box": [x1, y1, x2, y2], "fps": info["fps"],
        }
        self.bus.publish_sync(self.config.subjects.video_preprocessed, payload)
        return payload

    # ------------------------------------------------ fused device stages ---
    def _load_engine_frames(self, video_path: Path):
        """Decode + resize to the engine's static geometry; returns
        (frames (1, P, H, W, 3) PACKED, scale (sx, sy), native info).

        Only the frames the stage subsets consume (det ∪ dino ∪ pose, 33
        of 125 for a canonical clip) are read and resized."""
        s = self.engine.spec
        union = [int(i) for i in np.asarray(s.packed_idx)]
        with contextlib.ExitStack() as stack:
            vr = self.reader(Path(video_path))
            if hasattr(vr, "__enter__"):
                vr = stack.enter_context(vr)
            info = vr.info
            frames_map = vr.read_selected(union)
        if not frames_map:
            return None, None, info
        sx = info["width"] / s.frame_width
        sy = info["height"] / s.frame_height

        def resize(f, size):
            w, h = size
            return _rows_at(f[None, None], [0], h, w)[0, 0]
        if s.split:
            # split-resolution ingest: det/SAM rows at hi geometry,
            # dino/pose rows at lo — each decoded frame is resized once
            # per set it belongs to; coords stay in hi space
            out = {"hi": np.zeros((len(s.hi_idx), s.frame_height,
                                   s.frame_width, 3), np.uint8),
                   "lo": np.zeros((len(s.lo_idx), s.lo_height,
                                   s.lo_width, 3), np.uint8)}
            rows = {"hi": {int(i): pi for pi, i in enumerate(s.hi_idx)},
                    "lo": {int(i): pi for pi, i in enumerate(s.lo_idx)}}
            geom = {"hi": (s.frame_width, s.frame_height),
                    "lo": (s.lo_width, s.lo_height)}
            last = {"hi": None, "lo": None}
            for idx in union:
                f = frames_map.get(idx)
                for key in ("hi", "lo"):
                    pi = rows[key].get(idx)
                    if pi is None:
                        continue
                    if f is not None:
                        last[key] = resize(f, geom[key])
                    if last[key] is not None:
                        out[key][pi] = last[key]
            return {k: v[None] for k, v in out.items()}, (sx, sy), info
        out = np.zeros((s.n_packed, s.frame_height, s.frame_width, 3),
                       np.uint8)
        last = None
        for pi, idx in enumerate(union):
            f = frames_map.get(idx)
            if f is not None:
                last = resize(f, (s.frame_width, s.frame_height))
            if last is not None:
                # missing tail frames repeat the last decoded one
                out[pi] = last
        return out[None], (sx, sy), info

    def run_feature_stages(self, video_id: str,
                           processed_path: Path) -> Optional[Dict[str, Any]]:
        """Run the engine once, then write the yolo/sam3/dinov3/tleap/
        tcn/transformer result files and publish their subjects."""
        assert self.engine is not None, "driver needs an engine"
        with TIMERS.time("decode"):
            frames, scale, info = self._load_engine_frames(processed_path)
        if frames is None:
            return None
        t0 = time.perf_counter()
        with TIMERS.time("engine"):
            out = self.engine.process_clip_batch(frames)
        LOG.info("engine.complete", video_id=video_id,
                 seconds=round(time.perf_counter() - t0, 3))
        return self._write_stage_results(video_id, out, 0, scale, info)

    def run_feature_stages_batch(self, jobs, pad_to: Optional[int] = None):
        """Throughput path: N clips -> ONE engine call -> N result sets.
        jobs: list of (video_id, processed_path).  Thin wrapper over
        process_stream (one batch, no lookahead decode)."""
        jobs = list(jobs)
        return self.process_stream(jobs, batch_size=max(1, len(jobs)),
                                   pad_to=pad_to)

    def process_stream(self, jobs, batch_size: int = 1,
                       pad_to: Optional[int] = None,
                       decode_workers: Optional[int] = None,
                       on_decode_failure=None):
        """Throughput path with decode/compute overlap.

        jobs: iterable of (video_id, processed_path).  Returns per-video
        result dicts in completion order.  ``pad_to`` pads every engine
        call (including a trailing partial batch) to one batch size by
        repeating the last clip.  ``decode_workers`` (default
        ``LAMENESS_DECODE_WORKERS`` or min(4, cpu_count)) decode in a
        thread pool, in job order, with at most workers + 2 clips in
        flight.  ``on_decode_failure(video_id, error)`` is called for a
        clip that gives no frames; it gets no result file.  The first error
        of the writer thread is raised after the stream has drained."""
        jobs = list(jobs)
        q: "queue.Queue" = queue.Queue(maxsize=2)
        wq: "queue.Queue" = queue.Queue(maxsize=2)
        if decode_workers is None:
            decode_workers = int(os.environ.get(
                "LAMENESS_DECODE_WORKERS", min(4, os.cpu_count() or 1)))
        decode_workers = max(1, decode_workers)

        def load(job):
            video_id, path = job
            try:
                with TIMERS.time("decode"):
                    frames, scale, info = self._load_engine_frames(
                        Path(path))
            except Exception as e:
                LOG.error("stream.decode_failed", exc=e, video_id=video_id)
                frames, err = None, e   # `e` is unbound past this clause
            else:
                err = ValueError("no decodable frames")
            if frames is None:
                # a skipped clip must surface: it writes no result file
                if on_decode_failure is not None:
                    try:
                        on_decode_failure(video_id, err)
                    except Exception:
                        pass
                return video_id, None, None, None
            return video_id, frames, scale, info

        def producer():
            # the None sentinel must reach the consumer even if a decode
            # raises: a dead producer would leave it waiting forever
            try:
                batch = []

                def flush(batch):
                    frames_list = [b[1] for b in batch]
                    if pad_to is not None:
                        while len(frames_list) < pad_to:
                            frames_list.append(frames_list[-1])
                    if isinstance(frames_list[0], dict):
                        stacked = {k: np.stack([f[k] for f in frames_list])
                                   for k in frames_list[0]}
                    else:
                        stacked = np.stack(frames_list)
                    # host work only: the transfer is the consumer's
                    q.put((stacked, [(vid, scale, info)
                                     for vid, _, scale, info in batch]))

                with ThreadPoolExecutor(max_workers=decode_workers) as pool:
                    it = iter(jobs)
                    futs = deque()
                    for job in jobs[:decode_workers + 2]:
                        futs.append(pool.submit(load, job))
                        next(it)
                    while futs:
                        video_id, frames, scale, info = \
                            futs.popleft().result()
                        nxt = next(it, None)
                        if nxt is not None:
                            futs.append(pool.submit(load, nxt))
                        if frames is None:
                            continue
                        f0 = {k: v[0] for k, v in frames.items()} \
                            if isinstance(frames, dict) else frames[0]
                        batch.append((video_id, f0, scale, info))
                        if len(batch) >= batch_size:
                            flush(batch)
                            batch = []
                if batch:
                    flush(batch)
            finally:
                q.put(None)

        results = []
        werr = []

        def writer():
            # host only: takes read-back numpy trees
            while True:
                item = wq.get()
                if item is None:
                    break
                out, metas = item
                try:
                    for bi, (video_id, scale, info) in enumerate(metas):
                        results.append(self._write_stage_results(
                            video_id, out, bi, scale, info))
                except Exception as e:        # keep draining; re-raised below
                    if not werr:
                        werr.append(e)
                    LOG.error("stream.write_failed", exc=e,
                              video_ids=[m[0] for m in metas])

        t = threading.Thread(target=producer, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        t.start()
        wt.start()
        lanes = Overlap(self.engine.device)

        def _readback(fetched):
            wait, meta = fetched
            with TIMERS.time("readback"):
                (flat,) = wait()
                return self.engine.unpack_output(flat, meta)

        pending = None                    # ((wait, meta), metas)
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                stacked, metas = item
                # batch N+1's copy runs while batch N computes
                with TIMERS.time("transfer"):
                    fd = lanes.put(lambda: self.engine.to_device(stacked))
                with TIMERS.time("engine_stream"):
                    out_dev = self.engine.process_clip_batch(
                        fd, readback=False)
                    # the packed output's copy back is queued before any
                    # later batch's stages, and waited for alone
                    flat, meta = self.engine.pack_output(out_dev)
                    fetched = (lanes.fetch([flat]), meta)
                if pending is not None:
                    wq.put((_readback(pending[0]), pending[1]))
                pending = (fetched, metas)
            if pending is not None:
                wq.put((_readback(pending[0]), pending[1]))
        finally:
            wq.put(None)
            wt.join()
        t.join()
        if werr:
            raise werr[0]
        return results

    def _write_stage_results(self, video_id, out, bi, scale, info):
        with TIMERS.time("write_results"):
            return self._write_stage_results_inner(video_id, out, bi,
                                                   scale, info)

    def _write_stage_results_inner(self, video_id, out, bi, scale, info):
        sx, sy = scale
        s = self.engine.spec
        fps = info["fps"] or s.fps
        total_frames = int(info["total_frames"])
        subj = self.config.subjects
        # messages wait until every result file is written: on the
        # in-process bus a publish runs downstream handlers at once
        deferred = []

        # ---- yolo result (yolo-pipeline/app/main.py:112-199) -------------
        det_entries = []
        all_boxes, all_confs = [], []
        n_real = min(total_frames, s.clip_frames)
        for ti, fr in enumerate(np.asarray(s.det_idx)):
            if fr >= n_real:
                break
            dets = []
            for k in range(s.max_det):
                if not out["det_valid"][bi, ti, k]:
                    continue
                b = out["det_boxes"][bi, ti, k] * [sx, sy, sx, sy]
                dets.append(schemas.yolo_detection_entry(
                    int(fr), b, float(out["det_scores"][bi, ti, k]),
                    f"class_{int(out['det_classes'][bi, ti, k])}"
                    if int(out["det_classes"][bi, ti, k]) != 19 else "cow",
                    int(out["det_classes"][bi, ti, k])))
                all_boxes.append(b)
                all_confs.append(float(out["det_scores"][bi, ti, k]))
            if dets:
                det_entries.append(schemas.yolo_frame_entry(int(fr), fps, dets))
        feats = schemas.yolo_features(
            np.asarray(all_boxes) if all_boxes else np.zeros((0, 4)),
            np.asarray(all_confs), len(det_entries), total_frames)
        yolo_result = schemas.yolo_result(det_entries, feats, total_frames, fps)
        ypath = schemas.write_result(
            self.dirs.results_for("yolo") / f"{video_id}_yolo.json",
            yolo_result)
        deferred.append((subj.pipeline_yolo, schemas.yolo_message(
            video_id, str(ypath), yolo_result)))

        # ---- sam3 result (sam3-pipeline/app/main.py:186-272) --------------
        # the masks' features on a few threads (numpy and scipy release the
        # GIL), then in frame order as the JAX driver builds them
        frames = [(ti, fr) for ti, fr in enumerate(np.asarray(s.det_idx))
                  if fr < n_real]
        measured = [ti for ti, _ in frames if out["primary_valid"][bi, ti]]
        with ThreadPoolExecutor(max_workers=MASK_WORKERS) as pool:
            shapes = dict(zip(measured, pool.map(
                lambda ti: self._mask_features(
                    np.asarray(out["masks"][bi, ti], np.uint8), info),
                measured)))
        segs, frame_feats = [], []
        for ti, fr in frames:
            has_det = ti in shapes
            if has_det:
                ff = shapes[ti]
                ff["frame"] = int(fr)
                ff["time"] = fr / fps if fps > 0 else 0
                frame_feats.append(ff)
                segs.append(schemas.sam3_segmentation_entry(
                    int(fr), fps, True, ff))
            else:
                segs.append(schemas.sam3_segmentation_entry(
                    int(fr), fps, False))
        agg = schemas.sam3_aggregated(frame_feats)
        sam_result = schemas.sam3_result(segs, agg, total_frames, fps)
        spath = schemas.write_result(
            self.dirs.results_for("sam3") / f"{video_id}_sam3.json",
            sam_result)
        deferred.append((subj.pipeline_sam3, schemas.sam3_message(
            video_id, str(spath), sam_result)))

        # ---- dinov3 result (dinov3-pipeline/app/main.py:188-275) ----------
        emb_entries = []
        for ti, fr in enumerate(np.asarray(s.dino_idx)):
            if fr >= n_real:
                break
            emb_entries.append(schemas.dinov3_embedding_entry(
                int(fr), fps, out["embeddings"][bi, ti]))
        if emb_entries:
            avg_emb = np.mean([e["embedding"] for e in emb_entries], axis=0)
            similar = self._search_similar(avg_emb, video_id)
            labels = [c["label"] for c in similar if c["label"] is not None]
            if labels:
                neighbor_evidence = sum(1 for l in labels if l == 1) / len(labels)
            else:
                neighbor_evidence = 0.5
            self.store.upsert(self.config.reid.collection_embeddings,
                              video_id, avg_emb,
                              payload={"video_id": video_id, "label": None,
                                       "metadata": {}})
            canonical = [emb_entries[0], emb_entries[len(emb_entries) // 2],
                         emb_entries[-1]]
            dino_result = schemas.dinov3_result(
                video_id, avg_emb, len(emb_entries), similar,
                neighbor_evidence, canonical)
            dpath = schemas.write_result(
                self.dirs.results_for("dinov3") / f"{video_id}_dinov3.json",
                dino_result)
            deferred.append((subj.pipeline_dinov3, schemas.dinov3_message(
                video_id, str(dpath), dino_result)))

        # ---- tleap result (tleap-pipeline/app/main.py:438-530) ------------
        # trained mode writes the model's Roboflow names in the JSON (like
        # the reference); locomotion always computes from the old-name
        # mapping so its features resolve in both modes
        trained = bool(self.engine.loaded_weights.get("pose"))
        json_kp = out.get("keypoints_model") if trained else out["keypoints"]
        json_names = pose_mod.KEYPOINT_NAMES if trained else pose_mod.H_NAMES

        def _seqs(kp_arr, names):
            seqs = []
            for ti, fr in enumerate(np.asarray(s.pose_idx)):
                if fr >= n_real:
                    break
                kps = []
                for k in range(20):
                    kp = kp_arr[bi, ti, k]
                    kps.append({"name": names[k],
                                "x": float(kp[0] * sx), "y": float(kp[1] * sy),
                                "confidence": float(kp[2])})
                pb = out["pose_boxes"][bi, ti] * [sx, sy, sx, sy]
                seqs.append({
                    "frame": int(fr), "time": fr / fps if fps > 0 else 0,
                    "bbox": [float(v) for v in pb], "keypoints": kps,
                    "detection_confidence": float(
                        out["primary_scores"][bi,
                                              min(ti, len(s.det_idx) - 1)]),
                })
            return seqs

        pose_seqs = _seqs(json_kp, json_names)
        loco = pose_mod.compute_locomotion_features(
            _seqs(out["keypoints"], pose_mod.H_NAMES) if trained
            else pose_seqs)
        tleap_result = schemas.tleap_result(
            video_id, total_frames, fps, pose_seqs, loco,
            "trained" if trained else "heuristic",
            pose_mod.KEYPOINT_NAMES,
            [list(c) for c in pose_mod.COW_SKELETON],
            {k: list(v) for k, v in pose_mod.SKELETON_COLORS.items()})
        tpath = schemas.write_result(
            self.dirs.results_for("tleap") / f"{video_id}_tleap.json",
            tleap_result)
        deferred.append((subj.pipeline_tleap, schemas.tleap_message(
            video_id, str(tpath), tleap_result)))

        # ---- tcn + transformer results (tcn:330-393, transformer:394-464) -
        tcn_result = schemas.tcn_result(
            video_id, float(out["tcn_probability"][bi]),
            float(out["tcn_uncertainty"][bi]),
            int(out["seq_features"].shape[1]), 44,
            self.engine.tcn.receptive_field)
        schemas.write_result(
            self.dirs.results_for("tcn") / f"{video_id}_tcn.json", tcn_result)
        deferred.append((subj.pipeline_tcn, {
            "video_id": video_id, "pipeline": "tcn",
            "severity_score": tcn_result["severity_score"],
            "uncertainty": tcn_result["uncertainty"]}))

        masked = int(np.asarray(out["seq_mask"][bi]).sum())
        tr_result = schemas.transformer_result(
            video_id, float(out["gait_probability"][bi]),
            float(out["gait_uncertainty"][bi]),
            int(out["seq_features"].shape[1]), 44, masked,
            np.asarray(out["gait_saliency"][bi]),
            self.engine.gait.d_model, self.engine.gait.num_layers,
            self.engine.gait.heads)
        schemas.write_result(
            self.dirs.results_for("transformer")
            / f"{video_id}_transformer.json", tr_result)
        deferred.append((subj.pipeline_transformer, {
            "video_id": video_id, "pipeline": "transformer",
            "severity_score": tr_result["severity_score"],
            "uncertainty": tr_result["uncertainty"]}))
        for subject, msg in deferred:
            self.bus.publish_sync(subject, msg)
        return out

    def _mask_features(self, mask: np.ndarray, info: Dict) -> Dict[str, Any]:
        """Shape features of a mask at the clip's native size (sam3:102-145):
        area and centroid from the pixels (cv2.moments), circularity,
        perimeter and aspect from the largest outer contour
        (``serve/contours.py``, cv2's conventions)."""
        h_n, w_n = int(info["height"]), int(info["width"])
        mask_full = resize_nearest(np.asarray(mask, np.uint8) * 255 > 127,
                                   w_n, h_n)
        mask_area = float(mask_full.sum())
        total = mask_full.size
        contour = largest_external_contour(mask_full)
        if contour is not None:
            area, perimeter, (_, _, bw, bh) = contour
            circ = (4 * np.pi * area) / (perimeter ** 2) \
                if perimeter > 0 else 0
            aspect = bw / bh if bh > 0 else 0
        else:
            perimeter, circ, aspect = 0.0, 0, 0
        m00, m10, m01 = first_moments(mask_full)
        if m00 != 0:
            cx, cy = m10 / m00, m01 / m00
        else:
            cx, cy = w_n / 2, h_n / 2
        return {"mask_area": mask_area,
                "area_ratio": mask_area / total if total else 0,
                "circularity": float(circ), "aspect_ratio": float(aspect),
                "centroid_x": float(cx), "centroid_y": float(cy),
                "perimeter": float(perimeter)}

    def _search_similar(self, emb: np.ndarray, exclude: str
                        ) -> List[Dict[str, Any]]:
        hits = self.store.search(self.config.reid.collection_embeddings, emb,
                                 top_k=self.config.dino.top_k_similar + 1)
        out = []
        for h in hits:
            if h.id == exclude:
                continue
            out.append({"video_id": h.payload.get("video_id", h.id),
                        "score": h.score,
                        "label": h.payload.get("label"),
                        "metadata": h.payload.get("metadata", {})})
        return out[:self.config.dino.top_k_similar]

    # ---------------------------------------------------------- tracking ---
    def run_tracking(self, video_id: str,
                     backend: str = "host") -> Optional[Dict[str, Any]]:
        """ByteTrack over the yolo result + Re-ID via the video embedding
        (tracking-service/app/main.py:114-430).

        ``backend="device"`` runs the association on ``device`` through the
        fixed-slot tracker (track/device_tracker.py); the host path stays
        the reference-exact default.
        """
        yolo_file = self.dirs.results_for("yolo") / f"{video_id}_yolo.json"
        if not yolo_file.exists():
            return None
        with TIMERS.time("tracking"):
            with open(yolo_file) as f:
                yolo_data = json.load(f)
            if backend == "device":
                all_tracks, summaries, stats = track_detection_frames(
                    yolo_data.get("detections", []), device=self.device)
                result = schemas.tracking_result(video_id, summaries,
                                                 all_tracks, stats)
            else:
                tracker = self.trackers.setdefault(video_id, ByteTracker(
                    high_thresh=0.6, low_thresh=0.1, match_thresh=0.8))
                all_tracks = []
                for frame_entry in yolo_data.get("detections", []):
                    dets = [Detection(np.asarray(d["bbox"], float),
                                      d["confidence"], d.get("class_id", 0))
                            for d in frame_entry.get("detections", [])]
                    tracks = tracker.update(dets,
                                            frame_idx=frame_entry["frame"])
                    for t in tracks:
                        all_tracks.append({
                            "frame": frame_entry["frame"],
                            "track_id": t.track_id,
                            "bbox": np.asarray(t.bbox).tolist(),
                            "confidence": t.confidence,
                            "state": t.state.name})
                summaries = []
                for t in tracker.tracks:
                    if t.hits >= 3:
                        summaries.append({
                            "track_id": t.track_id,
                            "start_frame":
                                t.frame_history[0] if t.frame_history else 0,
                            "end_frame":
                                t.frame_history[-1] if t.frame_history else 0,
                            "total_frames": len(t.frame_history),
                            "avg_confidence": float(np.mean(
                                [t.confidence]
                                * max(1, len(t.bbox_history)))),
                        })
                result = schemas.tracking_result(
                    video_id, summaries, all_tracks,
                    tracker.get_statistics())
            result["reid_results"] = self._reid_tracks(video_id, summaries)
        path = schemas.write_result(
            self.dirs.results_for("tracking") / f"{video_id}_tracking.json",
            result)
        self.bus.publish_sync(self.config.subjects.tracking_complete, {
            "video_id": video_id, "results_path": str(path),
            "total_tracks": result["total_tracks"]})
        return result

    def _reid_tracks(self, video_id: str, summaries) -> List[Dict[str, Any]]:
        """Re-ID of each track by the mean of the frame embeddings inside
        its frame window (the video's average when the window holds none),
        an upgrade over the reference's one whole-video embedding for every
        track (quirk §2.9.7, tracking:333-335)."""
        dino_file = self.dirs.results_for("dinov3") / f"{video_id}_dinov3.json"
        reid_results: List[Dict[str, Any]] = []
        if not (dino_file.exists() and summaries):
            return reid_results
        with open(dino_file) as f:
            dino_data = json.load(f)
        frame_embs = [(e["frame"], np.asarray(e["embedding"], float))
                      for e in dino_data.get("canonical_frames", [])
                      if "embedding" in e]
        emb = dino_data.get("embedding")
        if emb is None and frame_embs:
            emb = np.mean([e for _, e in frame_embs], axis=0)
        if emb is None:
            return reid_results
        for t in summaries:
            window = [e for fr, e in frame_embs
                      if t["start_frame"] <= fr <= t["end_frame"]]
            track_emb = np.mean(window, axis=0) if window \
                else np.asarray(emb, float)
            m = self.reid.match_or_create(
                track_emb, video_id, t["track_id"],
                metadata={"start_frame": t["start_frame"],
                          "end_frame": t["end_frame"]})
            reid_results.append(schemas.reid_entry(
                t["track_id"], m.cow_id, m.identity_id, m.similarity,
                1.0 if m.confidence == "high" else 0.5, m.is_new_identity))
            self.bus.publish_sync(
                self.config.subjects.tracking_reid_match, {
                    "video_id": video_id,
                    "track_id": t["track_id"], "cow_id": m.cow_id,
                    "is_new": m.is_new_identity,
                    "similarity": m.similarity,
                    "confidence": t["avg_confidence"],
                    "start_frame": t["start_frame"],
                    "end_frame": t["end_frame"]})
        return reid_results

    # ------------------------------------------------------------- ml -----
    def run_ml(self, video_id: str) -> Dict[str, Any]:
        """Tabular ensemble over pipeline results (ml-pipeline:116-350)."""
        results = {}
        for p in ("yolo", "sam3", "dinov3", "tleap"):
            f = self.dirs.results_for(p) / f"{video_id}_{p}.json"
            if f.exists():
                with open(f) as fh:
                    results[p] = json.load(fh)
            else:
                results[p] = None
        feats, names = extract_features(results)
        predictions = self.ensemble.predict(feats)
        ml_result = schemas.ml_result(
            video_id, feats, names, predictions,
            {k: v is not None for k, v in results.items()})
        path = schemas.write_result(
            self.dirs.results_for("ml") / f"{video_id}_ml.json", ml_result)
        self.bus.publish_sync(self.config.subjects.pipeline_ml,
                              schemas.ml_message(video_id, str(path),
                                                 ml_result))
        return ml_result

    # ----------------------------------------------------------- full run --
    def process_video_file(self, video_path: Path,
                           video_id: Optional[str] = None,
                           curate: bool = True,
                           graph_heads: bool = True) -> Dict[str, Any]:
        """The complete upload -> analysis.complete chain, one call."""
        video_id = self.ingest(video_path, video_id)
        if curate:
            raw = next(iter(self.dirs.videos.glob(f"{video_id}.*")))
            with TIMERS.time("curation"):
                self.curator.curate_video(raw, video_id)
        pre = self.preprocess(video_id)
        self.run_feature_stages(video_id, Path(pre["processed_path"]))
        self.run_tracking(video_id)
        if graph_heads:
            with TIMERS.time("graph_heads"):
                self._ensure_graph_runner().process_video(video_id)
        with TIMERS.time("ml"):
            self.run_ml(video_id)
        with TIMERS.time("fusion"):
            fusion = self.fusion.process_video(
                video_id, timestamp=datetime.now(timezone.utc).isoformat())
        return {"video_id": video_id, "fusion": fusion}
