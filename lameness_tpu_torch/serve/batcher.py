"""Clip batching for the serving app: N queued videos -> ONE engine call
(port of ``lameness_tpu/serve/batcher.py``, copied).

The reference processes one video per NATS message per GPU service; the
engine's throughput path (``driver.process_stream``) stacks clips on the
batch axis — background decode of batch n+1 overlapping the engine on
batch n, the transfers and readbacks on the card's side streams — and
amortises launches.  This collector groups ``video.preprocessed`` arrivals
within a short window (or until ``max_batch``) and runs them as one padded
batch, falling through to singles under light load.
"""
from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import List, Tuple

from ..utils.logging import get_logger

_LOG = get_logger("batcher")


class ClipBatcher:
    def __init__(self, app, max_batch: int = 4, window_s: float = 0.25):
        self.app = app
        self.max_batch = max_batch
        self.window_s = window_s
        self.batches_run = 0
        self.clips_run = 0
        self._q: "queue.Queue" = queue.Queue()
        self._stopping = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="clip-batcher")
        self._thread.start()

    def submit(self, video_id: str, path: Path) -> None:
        self._q.put((video_id, path))

    def stop(self) -> None:
        self._stopping = True
        self._q.put(None)
        self._thread.join(timeout=60)

    def pending(self) -> int:
        return self._q.qsize()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            jobs: List[Tuple[str, Path]] = [item]
            deadline = time.time() + self.window_s
            # collect at least one batch within the window, then DRAIN
            # whatever else queued up — the streaming path overlaps the
            # next batch's decode with the current batch's engine run,
            # so handing it the whole backlog beats batch-at-a-time
            while len(jobs) < self.max_batch:
                try:
                    nxt = self._q.get(
                        timeout=max(0.0, deadline - time.time()))
                except queue.Empty:
                    break
                if nxt is None:
                    self._process(jobs)
                    return
                jobs.append(nxt)
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._process(jobs)
                    return
                jobs.append(nxt)
            self._process(jobs)

    def _process(self, jobs: List[Tuple[str, Path]]) -> None:
        app = self.app
        with app._processing:
            app._heartbeat("fused-engine", active_jobs=len(jobs))
            try:
                # decode/compute-overlapped stream, every engine call
                # padded to the ONE max_batch shape the warmup ran
                app.driver.process_stream(
                    jobs, batch_size=self.max_batch, pad_to=self.max_batch,
                    # a clip that fails decode produces no result file and
                    # would otherwise sit at 'processing' forever
                    on_decode_failure=lambda vid, e: app.db_mark_job(
                        vid, "failed", error=f"decode failed: {e!r}"[:500]))
                self.batches_run += (len(jobs) + self.max_batch - 1) \
                    // self.max_batch
                self.clips_run += len(jobs)
                _LOG.info("batch.complete", clips=len(jobs))
                app._heartbeat("fused-engine", active_jobs=0,
                               success_count=len(jobs))
            except Exception as e:
                _LOG.error("batch.failed", exc=e, clips=len(jobs))
                app._heartbeat("fused-engine", active_jobs=0,
                               error_count=len(jobs),
                               last_error=repr(e)[:300])
                for vid, _ in jobs:
                    app.db_mark_job(vid, "failed", error=repr(e)[:500])
