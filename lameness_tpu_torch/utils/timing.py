"""Stage timing (port of ``lameness_tpu/utils/timing.py``).

Every pipeline stage records wall time into a process-wide registry; the
stage names are the JAX package's (``decode``, ``transfer``,
``engine_stream``, ``readback``, ``write_results``, ...).  ``device_trace``
takes the place of the JAX module's ``jax.profiler`` trace: a
torch.profiler trace of a block (the host, and the card's kernels and
copies) written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


class StageTimers:
    """Thread-safe rolling stage timings (last N samples per stage)."""

    def __init__(self, window: int = 200):
        self._samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def time(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._samples[stage].append(dt)

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._samples[stage].append(seconds)

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            for stage, samples in self._samples.items():
                if not samples:
                    continue
                a = np.asarray(samples)
                out[stage] = {
                    "count": int(len(a)),
                    "mean_s": float(a.mean()),
                    "p50_s": float(np.median(a)),
                    "p95_s": float(np.percentile(a, 95)),
                    "last_s": float(a[-1]),
                }
        return out

    def dump(self, path: Path) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


# process-wide registry the driver shares
TIMERS = StageTimers()


@contextlib.contextmanager
def device_trace(log_dir: Path, device=None) -> Iterator[Optional[Path]]:
    """torch.profiler trace of the block, written into ``log_dir`` as a
    Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's profile
    plugin); yields the file's path, which exists once the block is left.

    It records the host's ops and, on the card (``device`` None is the
    current CUDA device; pass ``"cpu"`` for the host alone), the kernels
    and copies, each under its kernel's name.  Without a profiler (a torch
    built without it) the block runs untraced and the path is None.  A
    CUDA activity that was asked for and cannot be recorded raises."""
    try:
        from torch.profiler import ProfilerActivity, profile, \
            supported_activities
    except ImportError:
        yield None
        return
    from ..core.device import resolve_device
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "device_trace: this torch cannot record CUDA activity "
                "(no CUPTI); pass device='cpu' for a host trace")
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with profile(activities=activities) as prof:
        yield path
        if ProfilerActivity.CUDA in activities:
            import torch
            torch.cuda.synchronize()    # the block's kernels end in the trace
    prof.export_chrome_trace(str(path))
